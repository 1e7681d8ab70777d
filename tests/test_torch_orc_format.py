"""The port's ORC codec (spark_rapids_tpu_torch/io/orc_format.py over
native/orc_host.cpp, zstd_host.cpp and lz4_host.cpp) against the
reference's ORC IO (pyarrow underneath): every type of the reference's
mapping, every codec (NONE, ZLIB, SNAPPY, LZ4, ZSTD), file versions 0.11
(RLE v1, DIRECT and DICTIONARY strings) and 0.12 (RLE v2, DIRECT_V2 and
DICTIONARY_V2 strings), each RLE v2 sub-encoding forced by its data,
nulls, several stripes, an empty file and projection. The reference's
``TpuSession.read_orc`` and the port's ``TorchSession(device="cpu")
.read_orc`` read the same files, which pyarrow writes; in the other
direction the port writes and the reference reads. What the reference
rejects raises in the port too.

Comparator: ``scale_test.tables_differ`` (bitwise, in order)."""

import datetime
import decimal

import numpy as np
import pyarrow as pa
import pyarrow.orc as po
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
from spark_rapids_tpu_torch.io import orc_format as OF
from spark_rapids_tpu_torch.session import TorchSession


def _as_reference(t) -> JHostTable:
    names, types, arrays = t.to_arrays()
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(ty), d, v)
        for ty, (d, v) in zip(types, arrays)])


def _as_port(t: JHostTable):
    return host_table_from_arrays(
        t.names, [c.dtype.simple_string() for c in t.columns],
        [(c.data, c.validity) for c in t.columns])


def _every_type(n: int, seed: int) -> pa.Table:
    """Every type of the mapping, about 10% null, with runs, repeats,
    outliers and sorted stretches for the run-length encoders."""
    rng = np.random.default_rng(seed)

    def mask():
        return rng.random(n) < 0.1
    words = [f"w{k}" for k in range(23)] + ["", "é", "日本"]
    ts = rng.integers(-2 * 10**15, 2 * 10**15, n)
    return pa.table({
        "b": pa.array(rng.random(n) < 0.3, mask=mask()),
        "i8": pa.array(rng.integers(-128, 128, n).astype(np.int8),
                       mask=mask()),
        "i16": pa.array(np.repeat(rng.integers(-3000, 3000, n // 4 + 1),
                                  4)[:n].astype(np.int16)),
        "i32": pa.array(rng.integers(-2**31, 2**31, n).astype(np.int32),
                        mask=mask()),
        "i64": pa.array(np.cumsum(rng.integers(0, 7, n)) * 10**9),
        "f": pa.array(rng.standard_normal(n).astype(np.float32),
                      mask=mask()),
        "d": pa.array(np.where(rng.random(n) < 0.01, np.nan,
                               rng.standard_normal(n))),
        "s": pa.array([words[i] for i in rng.integers(0, len(words), n)],
                      mask=mask()),
        "ls": pa.array([f"{i:06d}-{'x' * (i % 9)}" for i in range(n)],
                       pa.large_string()),
        "day": pa.array(rng.integers(-30000, 40000, n).astype(np.int32),
                        pa.date32(), mask=mask()),
        "ts": pa.array(ts, pa.timestamp("us", tz="UTC"), mask=mask()),
        "tsn": pa.array(ts[::-1], pa.timestamp("us")),
        "dec": pa.array([decimal.Decimal(int(v)).scaleb(-2) for v in
                         rng.integers(-10**13, 10**13, n)],
                        pa.decimal128(15, 2), mask=mask()),
        "d38": pa.array([decimal.Decimal(int(v) * 10**22 + 3).scaleb(-6)
                         for v in rng.integers(-10**12, 10**12, n)],
                        pa.decimal128(38, 6)),
    })


@pytest.fixture(scope="module")
def sessions():
    return TpuSession(), TorchSession(device="cpu")


def _both(sessions, paths, **kw):
    ref, port = sessions
    want = ref.read_orc(*paths, **kw).collect_table()
    got = port.read_orc(*paths, **kw).collect_table()
    if "columns" in kw:
        # the reference's ORC batch keeps the file's column order under a
        # projection (its schema lists the requested order); the port's
        # keeps the requested order, as both packages' Parquet scans do
        assert list(got.names) == list(kw["columns"])
        want = JHostTable(got.names, [want.columns[want.names.index(n)]
                                      for n in got.names])
    assert tables_differ(_as_reference(got), want) is None
    return got


@pytest.mark.parametrize("compression", ["uncompressed", "zlib", "snappy",
                                         "lz4", "zstd"])
@pytest.mark.parametrize("version,dictionary", [
    ("0.12", 0.0), ("0.12", 1.0), ("0.11", 0.0), ("0.11", 1.0)])
def test_reads_what_pyarrow_writes(tmp_path, sessions, compression, version,
                                   dictionary):
    p = str(tmp_path / "t.orc")
    po.write_table(_every_type(6000, 3), p, compression=compression,
                   file_version=version,
                   dictionary_key_size_threshold=dictionary,
                   stripe_size=1024, compression_block_size=64 * 1024)
    assert po.ORCFile(p).nstripes > 1
    meta = OF.read_tail(p)
    encodings = {OF._Stripe(open(p, "rb"), meta, meta.stripes[0])
                 .encoding(c.id)[0] for c in meta.columns
                 if c.kind == OF.STRING}
    want = ({OF.DICTIONARY_V2} if dictionary else {OF.DIRECT_V2}) \
        if version == "0.12" else \
        ({OF.DICTIONARY} if dictionary else {OF.DIRECT})
    assert encodings == want
    _both(sessions, [p])


def test_projection_and_reader_modes(tmp_path, sessions):
    paths = []
    for k in range(2):
        p = str(tmp_path / f"p{k}.orc")
        po.write_table(_every_type(6000, k), p, compression="zstd",
                       stripe_size=1024)
        paths.append(p)
    for mode in ("PERFILE", "COALESCING", "MULTITHREADED"):
        _both(sessions, paths, reader_type=mode)
        _both(sessions, paths, reader_type=mode,
                    columns=["dec", "s", "tsn"])


def test_empty_file_and_all_null_columns(tmp_path, sessions):
    t = _every_type(50, 9)
    p = str(tmp_path / "empty.orc")
    po.write_table(t.slice(0, 0), p)
    got = _both(sessions, [p])
    assert got.num_rows == 0
    nulls = pa.table({c: pa.nulls(40, t.schema.field(c).type)
                      for c in t.column_names})
    p = str(tmp_path / "nulls.orc")
    po.write_table(nulls, p, compression="zstd")
    _both(sessions, [p])


def _first_headers(path: str, column: str):
    """The sub-encoding (header >> 6) of the first run of ``column``'s DATA
    stream in each stripe."""
    meta = OF.read_tail(path)
    col = meta.column(column)
    out = []
    with open(path, "rb") as f:
        for sm in meta.stripes:
            st = OF._Stripe(f, meta, sm)
            data = bytes(st.stream(col.id, OF.DATA))
            out.append(data[0] >> 6)
    return out


def test_rle_v2_sub_encodings_forced_by_their_data(tmp_path, sessions):
    rng = np.random.default_rng(4)
    n = 2000
    small = rng.integers(0, 60, n)
    small[rng.integers(0, n, 12)] = rng.integers(2**40, 2**48, 12)
    shapes = {
        "short_repeat": np.repeat(rng.integers(-50, 50, n // 5), 5),
        "direct": rng.integers(-2**62, 2**62, n),
        "patched": small,
        "delta": np.arange(n) * 7 - 5000,
        "run": np.full(n, -123456789),
        "wide": rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64),
    }
    t = pa.table({k: pa.array(v.astype(np.int64)) for k, v in shapes.items()})
    p = str(tmp_path / "rle.orc")
    po.write_table(t, p)
    seen = {k: _first_headers(p, k)[0] for k in shapes}
    assert seen["short_repeat"] == 0 and seen["direct"] == 1
    assert seen["patched"] == 2 and seen["delta"] == 3
    _both(sessions, [p])
    # the port's own encoder round-trips every shape
    for k, v in shapes.items():
        v = v.astype(np.int64)
        for signed in (True, False):
            vals = v if signed else np.abs(v)
            enc = N.orc_int_rle_encode(vals, signed)
            assert np.array_equal(N.orc_int_rle_decode(enc, n, 2, signed),
                                  vals), (k, signed)


def test_port_writes_what_the_reference_reads(tmp_path, sessions):
    ref, port = sessions
    src = _every_type(1200, 5)
    want = decode_to_schema(src, arrow_schema_to_spark(src.schema))
    table = _as_port(want)
    for compression in ("zstd", "zlib", "snappy", "lz4", "none"):
        p = str(tmp_path / f"w_{compression}.orc")
        OF.write_table(table, p, compression=compression, stripe_rows=500)
        f = po.ORCFile(p)
        assert f.nstripes == 3
        assert f.compression == {"none": "UNCOMPRESSED"}.get(
            compression, compression.upper())
        assert tables_differ(ref.read_orc(p).collect_table(), want) is None
        assert tables_differ(_as_reference(port.read_orc(p).collect_table()),
                             want) is None
    # TIMESTAMP is written as TIMESTAMP_INSTANT, BYTE/SHORT as tinyint and
    # smallint, as pyarrow writes the reference's tables
    schema = po.ORCFile(p).schema
    assert schema.field("ts").type == pa.timestamp("ns", tz="UTC")
    assert schema.field("i8").type == pa.int8()
    assert schema.field("i16").type == pa.int16()
    assert schema.field("dec").type == pa.decimal128(15, 2)


def test_what_the_reference_rejects_raises(tmp_path, sessions):
    ref, port = sessions
    p = str(tmp_path / "nested.orc")
    po.write_table(pa.table({"x": pa.array([{"a": 1}, {"a": 2}])}), p)
    with pytest.raises(NotImplementedError, match="item 9"):
        port.read_orc(p).collect_table()
    p = str(tmp_path / "bin.orc")
    po.write_table(pa.table({"x": pa.array([b"a", b"b"])}), p)
    with pytest.raises(NotImplementedError, match="BINARY"):
        port.read_orc(p).collect_table()
    # a nanosecond remainder: the reference's safe cast raises, so does
    # the port
    p = str(tmp_path / "ns.orc")
    po.write_table(pa.table({"t": pa.array([1, 1500], pa.timestamp("ns"))}),
                   p)
    with pytest.raises(Exception):
        ref.read_orc(p).collect_table()
    with pytest.raises(ColumnarProcessingError, match="nanoseconds"):
        port.read_orc(p).collect_table()
    # timestamps before 1970 with nanos: ORC's one-second adjustment
    t = pa.table({"t": pa.array([
        datetime.datetime(1969, 12, 31, 23, 59, 58, 500000),
        datetime.datetime(1960, 5, 6, 7, 8, 9, 999999),
        datetime.datetime(1970, 1, 1), None], pa.timestamp("us"))})
    p = str(tmp_path / "old.orc")
    po.write_table(t, p)
    _both(sessions, [p])


def test_corrupt_files_raise(tmp_path):
    p = str(tmp_path / "c.orc")
    po.write_table(_every_type(300, 2), p, compression="zstd")
    raw = open(p, "rb").read()
    for cut in (10, len(raw) // 2, len(raw) - 5):
        q = str(tmp_path / f"cut{cut}.orc")
        open(q, "wb").write(raw[:cut])
        with pytest.raises((ColumnarProcessingError, NotImplementedError)):
            OF.read_table(q)
    bad = bytearray(raw)
    for at in range(3, len(raw) // 2, 97):
        bad[at] ^= 0x5A
    q = str(tmp_path / "flip.orc")
    open(q, "wb").write(bytes(bad))
    with pytest.raises(ColumnarProcessingError):
        OF.read_table(q)


def test_timestamp_zones():
    """TIMESTAMP_INSTANT reads whatever the writer's zone; a TIMESTAMP
    written in a zone other than UTC raises naming it (the port reads no
    zone rules for ORC), where ORC C++ would shift it to the reader's."""
    secs = np.array([0, -1, 86_400], dtype=np.int64)
    nanos = np.array([0, 5 << 3 | 2, 123_000 << 3], dtype=np.int64)
    got = OF._timestamps(secs, nanos, OF.TIMESTAMP_INSTANT,
                         "America/New_York", "p")
    base = OF.ORC_EPOCH * 1_000_000
    assert got.tolist() == [base, base - 1_000_000 + 5,
                            base + 86_400_000_000 + 123]
    assert np.array_equal(OF._timestamps(secs, nanos, OF.TIMESTAMP, "GMT",
                                         "p"), got)
    with pytest.raises(NotImplementedError, match="America/New_York"):
        OF._timestamps(secs, nanos, OF.TIMESTAMP, "America/New_York", "p")


def test_decimal_scales_other_than_the_types_are_rescaled():
    """A DECIMAL value whose SECONDARY scale differs from the column's is
    brought to the column's scale (ORC C++: multiplied up, or divided
    toward zero)."""
    from spark_rapids_tpu_torch import types as T
    vals = np.array([123, -123, 5, 2**70], dtype=object)
    lo = np.array([int(v) & (2**64 - 1) for v in vals], dtype=np.uint64)
    hi = np.array([int(v) >> 64 for v in vals], dtype=np.int64)
    scales = np.array([1, 3, 2, 2], dtype=np.int64)
    got = OF._decimals(lo, hi, scales, T.DecimalType(38, 2))
    assert got.tolist() == [1230, -12, 5, 2**70]
    got = OF._decimals(lo[:3], hi[:3], scales[:3], T.DecimalType(10, 2))
    assert got.dtype == np.int64 and got.tolist() == [1230, -12, 5]


def test_brotli_and_lzo_raise_naming_themselves(tmp_path):
    for kind, why in ((OF.BROTLI, "RFC 7932"), (OF.LZO, "pyarrow writes")):
        with pytest.raises(NotImplementedError,
                           match=f"{OF.COMPRESSION_NAMES[kind]}.*{why}"):
            OF.decompress(kind, b"\x05\x00\x00abcde", OF.BLOCK_SIZE)
    t = host_table_from_arrays(["x"], ["bigint"],
                               [(np.arange(3), np.ones(3, bool))])
    with pytest.raises(NotImplementedError, match="brotli"):
        OF.write_table(t, str(tmp_path / "b.orc"), compression="brotli")
