"""The Parquet codecs and encodings beyond the defaults in the port's
Parquet codec (spark_rapids_tpu_torch/io/parquet_format.py): files that
pyarrow writes with ZSTD, LZ4 and LZ4_RAW, INT96 and nanosecond
timestamps, DELTA_BINARY_PACKED, DELTA_LENGTH_BYTE_ARRAY,
DELTA_BYTE_ARRAY and BYTE_STREAM_SPLIT, in data pages v1 and v2, read by
the reference (``TpuSession.read_parquet``, pyarrow underneath) and the
port (``TorchSession(device="cpu").read_parquet``); the port's ZSTD and
LZ4 files read back through pyarrow; BROTLI and LZO raise naming
themselves and why.

Comparator: ``scale_test.tables_differ`` (bitwise, in order)."""

import decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from scale_test import tables_differ
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.io.arrow_convert import (
    arrow_schema_to_spark,
    decode_to_schema,
)
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import native as N
from spark_rapids_tpu_torch.errors import ColumnarProcessingError
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.io import parquet_format as PF
from spark_rapids_tpu_torch.session import TorchSession


def _as_reference(t) -> JHostTable:
    names, types, arrays = t.to_arrays()
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(ty), d, v)
        for ty, (d, v) in zip(types, arrays)])


def _table(n: int, seed: int) -> pa.Table:
    rng = np.random.default_rng(seed)

    def mask():
        return rng.random(n) < 0.1
    keys = np.sort(rng.integers(0, 10**6, n))
    return pa.table({
        "i32": pa.array(rng.integers(-2**31, 2**31, n).astype(np.int32),
                        mask=mask()),
        "i64": pa.array(np.cumsum(rng.integers(-5, 100, n)).astype(np.int64)),
        # deltas that wrap int64: the min delta is far below zero
        "wrap": pa.array(np.where(rng.random(n) < 0.5, 2**62, -2**62)
                         + rng.integers(0, 9, n)),
        "f": pa.array(rng.random(n).astype(np.float32), mask=mask()),
        "d": pa.array(rng.standard_normal(n)),
        "s": pa.array([f"prefix_{k:07d}_{'z' * (k % 5)}" for k in keys]),
        "u": pa.array([None if i % 6 == 0 else "ü" * (i % 4) + str(i)
                       for i in range(n)]),
        "dec": pa.array([decimal.Decimal(int(v)).scaleb(-3) for v in
                         rng.integers(-10**15, 10**15, n)],
                        pa.decimal128(20, 3), mask=mask()),
        "ts": pa.array(rng.integers(-10**15, 10**15, n) * 1000,
                       pa.timestamp("ns"), mask=mask()),
    })


DELTAS = {"i32": "DELTA_BINARY_PACKED", "i64": "DELTA_BINARY_PACKED",
          "wrap": "DELTA_BINARY_PACKED", "f": "BYTE_STREAM_SPLIT",
          "d": "BYTE_STREAM_SPLIT", "s": "DELTA_BYTE_ARRAY",
          "u": "DELTA_LENGTH_BYTE_ARRAY", "dec": "DELTA_BYTE_ARRAY",
          "ts": "DELTA_BINARY_PACKED"}


@pytest.fixture(scope="module")
def sessions():
    return TpuSession(), TorchSession(device="cpu")


def _both(sessions, path):
    ref, port = sessions
    want = ref.read_parquet(path).collect_table()
    got = port.read_parquet(path).collect_table()
    assert tables_differ(_as_reference(got), want) is None


@pytest.mark.parametrize("compression", ["zstd", "lz4", "lz4_raw"])
@pytest.mark.parametrize("page_version", ["1.0", "2.0"])
@pytest.mark.parametrize("encoded", ["dictionary", "delta"])
def test_reads_what_pyarrow_writes(tmp_path, sessions, compression,
                                   page_version, encoded):
    p = str(tmp_path / "t.parquet")
    kw = ({"use_dictionary": False, "column_encoding": DELTAS}
          if encoded == "delta" else {})
    pq.write_table(_table(3000, 1), p, compression=compression,
                   data_page_version=page_version, data_page_size=4096,
                   row_group_size=1200, **kw)
    md = pq.ParquetFile(p).metadata
    assert md.num_row_groups == 3
    if encoded == "delta":
        encs = {md.schema.column(i).name: md.row_group(0).column(i).encodings
                for i in range(md.num_columns)}
        for name, enc in DELTAS.items():
            assert enc in encs[name], (name, encs[name])
    _both(sessions, p)


def test_int96_and_nanosecond_timestamps(tmp_path, sessions):
    t = _table(2000, 2)
    p = str(tmp_path / "int96.parquet")
    pq.write_table(t, p, use_deprecated_int96_timestamps=True)
    assert pq.ParquetFile(p).schema.column(8).physical_type == "INT96"
    _both(sessions, p)
    p = str(tmp_path / "nanos.parquet")
    pq.write_table(t, p, version="2.6", coerce_timestamps=None)
    assert "nanoseconds" in str(pq.ParquetFile(p).schema.column(8)
                                .logical_type)
    _both(sessions, p)
    p = str(tmp_path / "bss.parquet")
    pq.write_table(t.select(["ts", "i32", "dec"]), p, use_dictionary=False,
                   column_encoding={"ts": "BYTE_STREAM_SPLIT",
                                    "i32": "BYTE_STREAM_SPLIT",
                                    "dec": "BYTE_STREAM_SPLIT"})
    _both(sessions, p)
    # a sub-microsecond remainder: the reference's safe cast raises, as
    # the port does, in both INT96 and NANOS
    odd = pa.table({"t": pa.array([0, 1_000_001], pa.timestamp("ns"))})
    for kw in ({"use_deprecated_int96_timestamps": True},
               {"version": "2.6", "coerce_timestamps": None}):
        p = str(tmp_path / "odd.parquet")
        pq.write_table(odd, p, **kw)
        with pytest.raises(Exception):
            sessions[0].read_parquet(p).collect_table()
        with pytest.raises(ColumnarProcessingError, match="nanosecond"):
            sessions[1].read_parquet(p).collect_table()


def test_port_writes_zstd_and_lz4(tmp_path, sessions):
    src = _table(2500, 3)
    want = decode_to_schema(src, arrow_schema_to_spark(src.schema))
    table = host_table_from_arrays(
        want.names, [c.dtype.simple_string() for c in want.columns],
        [(c.data, c.validity) for c in want.columns])
    # the codec id pyarrow writes for "lz4"
    probe = str(tmp_path / "probe.parquet")
    pq.write_table(pa.table({"x": [1, 2]}), probe, compression="lz4")
    lz4_id = PF.read_footer(probe).row_groups[0].chunks["x"].codec
    for compression, codec_id in (("zstd", PF.ZSTD), ("lz4", lz4_id)):
        p = str(tmp_path / f"w_{compression}.parquet")
        PF.write_table(table, p, compression=compression,
                       row_group_rows=1000)
        assert PF.read_footer(p).row_groups[0].chunks["i32"].codec == \
            codec_id
        back = pq.read_table(p)
        got = decode_to_schema(back, arrow_schema_to_spark(src.schema))
        assert tables_differ(got, want) is None
        _both(sessions, p)


def test_legacy_lz4_pages_as_arrow_reads_them():
    """Parquet's LZ4 (codec 5): Hadoop-framed blocks (big-endian
    decompressed and compressed lengths), else one raw block."""
    raw = pa.Codec("lz4_raw")
    a, b = b"abcabcabcabc" * 500, bytes(range(256)) * 40
    framed = b""
    for part in (a, b):
        block = raw.compress(part, asbytes=True)
        framed += len(part).to_bytes(4, "big") + \
            len(block).to_bytes(4, "big") + block
    got = PF._decompress(PF.LZ4, framed, len(a) + len(b))
    assert bytes(got) == a + b
    plain = raw.compress(a, asbytes=True)
    assert bytes(PF._decompress(PF.LZ4, plain, len(a))) == a
    with pytest.raises(ColumnarProcessingError):
        PF._decompress(PF.LZ4, plain[:-3], len(a))


def test_brotli_and_lzo_raise_naming_themselves(tmp_path):
    p = str(tmp_path / "b.parquet")
    pq.write_table(_table(100, 4), p, compression="brotli")
    with pytest.raises(NotImplementedError, match="BROTLI.*RFC 7932"):
        TorchSession(device="cpu").read_parquet(p).collect_table()
    t = host_table_from_arrays(["x"], ["bigint"],
                               [(np.arange(3), np.ones(3, bool))])
    with pytest.raises(NotImplementedError, match="LZO.*pyarrow writes"):
        PF.write_table(t, str(tmp_path / "l.parquet"), compression="lzo")
    with pytest.raises(NotImplementedError, match="BROTLI"):
        PF.write_table(t, str(tmp_path / "l.parquet"), compression="brotli")
    with pytest.raises(NotImplementedError, match="LZO"):
        PF._decompress(PF.LZO, b"", 0)


def test_delta_decoders_reject_corrupt_pages():
    with pytest.raises(ColumnarProcessingError):
        N.delta_binary_decode(b"\x80\x01\x04\x0a\x02\x05", 10)
    with pytest.raises(ColumnarProcessingError):
        N.delta_byte_array(np.array([3], np.int64), np.zeros(2, np.uint8),
                           np.array([0, 2], np.int64))
