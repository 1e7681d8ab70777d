"""The port's own Parquet codec (spark_rapids_tpu_torch/io/parquet_format.py
and the host library's native/parquet_host.cpp) against pyarrow, which the
reference decodes through.

- Files the reference writes (``spark_rapids_tpu.io.parquet.write_parquet``)
  and files written with pyarrow directly, in every layout the codec
  covers (several row groups; SNAPPY, GZIP and none; version-1 and
  version-2 pages; a dictionary that falls back to PLAIN mid-chunk), read
  through the port's reader equal the reference's pyarrow read.
- Files the port writes read back under pyarrow equal to their source.
- Every type the port carries, with nulls in every column: BOOLEAN, BYTE,
  SHORT, INT, LONG, FLOAT, DOUBLE (NaN and -0.0), STRING (empty and
  non-ASCII), DATE, TIMESTAMP, decimal(15,2), decimal(30,2) and
  decimal(38,10).
- What the codec does not cover raises NotImplementedError naming itself.

Comparator: ``scale_test.tables_differ`` (bitwise, in order) throughout;
the port's tables convert to the reference's HostTable first.
"""

import datetime
import decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from scale_test import tables_differ
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.io.arrow_convert import arrow_to_host_table
from spark_rapids_tpu.io.parquet import write_parquet as jwrite_parquet
from spark_rapids_tpu_torch import native as N
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.columnar.column import encode_sorted_dict
from spark_rapids_tpu_torch.io import parquet_format as PF
from spark_rapids_tpu_torch.session import TorchSession

TYPES = [("b", "boolean"), ("y", "tinyint"), ("sh", "smallint"),
         ("i", "int"), ("l", "bigint"), ("f", "float"), ("d", "double"),
         ("s", "string"), ("dt", "date"), ("ts", "timestamp"),
         ("d15", "decimal(15,2)"), ("d30", "decimal(30,2)"),
         ("d38", "decimal(38,10)")]


def _as_reference(t) -> JHostTable:
    names, types, arrays = t.to_arrays()
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(ty), d, v)
        for ty, (d, v) in zip(types, arrays)])


def _every_type(n: int, seed: int) -> HostTable:
    """Every type the port carries, nulls in every column, seeded."""
    rng = np.random.default_rng(seed)
    words = np.array(["", "a", "héllo", "日本語", "zz top", "x" * 40,
                      "Customer#000000001"], dtype=object)
    d = rng.random(n)
    d[rng.random(n) < 0.05] = np.nan
    d[rng.random(n) < 0.05] = -0.0
    big = np.empty(n, dtype=object)
    big[:] = [int(a) * 10**15 + int(b) for a, b in zip(
        rng.integers(-10**13, 10**13, n), rng.integers(0, 10**15, n))]
    huge = np.empty(n, dtype=object)
    huge[:] = [int(a) * 10**19 + int(b) for a, b in zip(
        rng.integers(-10**18, 10**18, n), rng.integers(0, 10**18, n))]
    data = {
        "b": rng.random(n) < 0.5,
        "y": rng.integers(-128, 128, n).astype(np.int8),
        "sh": rng.integers(-2**15, 2**15, n).astype(np.int16),
        "i": rng.integers(-2**31, 2**31, n).astype(np.int32),
        "l": rng.integers(-2**63, 2**63 - 1, n),
        "f": rng.standard_normal(n).astype(np.float32),
        "d": d,
        "s": words[rng.integers(0, len(words), n)],
        "dt": rng.integers(-40000, 40000, n).astype(np.int32),
        "ts": rng.integers(-2**55, 2**55, n),
        "d15": rng.integers(-10**15 + 1, 10**15, n),
        "d30": big,
        "d38": huge,
    }
    cols = []
    for name, ty in TYPES:
        valid = rng.random(n) > 0.15
        vals = data[name]
        if name == "s":
            vals = np.where(valid, vals, None)
        cols.append(HostColumn(T.parse_type(ty), vals, valid))
    return HostTable([nm for nm, _ in TYPES], cols)


def _pyarrow_table(t: HostTable) -> pa.Table:
    """The same rows as an Arrow table, built directly with pyarrow."""
    arrays = {}
    for name, c in zip(t.names, t.columns):
        mask = ~c.validity
        dt = c.dtype
        if isinstance(dt, T.StringType):
            arrays[name] = pa.array(list(np.where(c.validity, c.data, None)),
                                    pa.string())
        elif isinstance(dt, T.DateType):
            arrays[name] = pa.array(c.data, pa.int32(), mask=mask).cast(
                pa.date32())
        elif isinstance(dt, T.TimestampType):
            arrays[name] = pa.array(c.data, pa.int64(), mask=mask).cast(
                pa.timestamp("us", tz="UTC"))
        elif isinstance(dt, T.DecimalType):
            ctx = decimal.Context(prec=60)
            arrays[name] = pa.array(
                [decimal.Decimal(int(v)).scaleb(-dt.scale, context=ctx)
                 if ok else None for v, ok in zip(c.data, c.validity)],
                pa.decimal128(dt.precision, dt.scale))
        else:
            arrays[name] = pa.array(c.data, mask=mask)
    return pa.table(arrays)


@pytest.fixture(scope="module")
def table():
    return _every_type(3000, seed=5)


def _port_read(path) -> JHostTable:
    return _as_reference(PF.read_table(path))


def _pyarrow_read(path) -> JHostTable:
    return arrow_to_host_table(pq.read_table(path))


@pytest.mark.parametrize("codec", ["snappy", "gzip", "none"])
def test_reference_written_files(tmp_path, table, codec):
    files = jwrite_parquet(_as_reference(table), str(tmp_path / "r"),
                           compression=codec, row_group_rows=700)
    md = pq.ParquetFile(files[0]).metadata
    assert md.num_row_groups == 5
    assert md.row_group(0).column(0).compression == \
        {"none": "UNCOMPRESSED"}.get(codec, codec.upper())
    got = _port_read(files[0])
    assert tables_differ(got, _pyarrow_read(files[0])) is None
    assert tables_differ(got, _as_reference(table)) is None


LAYOUTS = {
    "v1 pages": dict(data_page_version="1.0"),
    "v2 pages": dict(data_page_version="2.0"),
    "v2 pages, gzip": dict(data_page_version="2.0", compression="gzip"),
    "row groups": dict(row_group_size=400, data_page_size=2048),
    "dictionary fallback": dict(dictionary_pagesize_limit=64,
                                row_group_size=1500),
    "no dictionary": dict(use_dictionary=False, compression="none"),
    "format 1.0": dict(version="1.0"),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pyarrow_layouts(tmp_path, table, layout):
    path = str(tmp_path / "p.parquet")
    pq.write_table(_pyarrow_table(table), path, **LAYOUTS[layout])
    if layout == "dictionary fallback":
        # the string chunk starts dictionary-encoded and falls back
        enc = pq.ParquetFile(path).metadata.row_group(0).column(7).encodings
        assert "RLE_DICTIONARY" in enc and "PLAIN" in enc
    got = _port_read(path)
    assert tables_differ(got, _pyarrow_read(path)) is None
    assert tables_differ(got, _as_reference(table)) is None


@pytest.mark.parametrize("codec", ["snappy", "gzip", "none"])
def test_port_written_files_read_by_pyarrow(tmp_path, table, codec):
    path = str(tmp_path / "w.parquet")
    PF.write_table(table, path, compression=codec, row_group_rows=1000,
                   page_bytes=4096)
    md = pq.ParquetFile(path).metadata
    assert md.num_row_groups == 3
    chunk = md.row_group(0).column(7)
    assert chunk.statistics.null_count == int(
        (~table.columns[7].validity[:1000]).sum())
    assert tables_differ(_pyarrow_read(path), _as_reference(table)) is None
    # the schema pyarrow sees is the reference's Arrow schema
    assert pq.read_schema(path).types == _pyarrow_table(table).schema.types


def test_port_statistics_match_pyarrow(tmp_path, table):
    """min, max and null count of every chunk the port writes, as pyarrow
    computes them over the same rows."""
    path = str(tmp_path / "s.parquet")
    PF.write_table(table, path, row_group_rows=1500)
    ref = str(tmp_path / "r.parquet")
    pq.write_table(_pyarrow_table(table), ref, row_group_size=1500)
    a, b = pq.ParquetFile(path).metadata, pq.ParquetFile(ref).metadata
    for rg in range(2):
        for ci, (name, _) in enumerate(TYPES):
            sa = a.row_group(rg).column(ci).statistics
            sb = b.row_group(rg).column(ci).statistics
            assert sa.null_count == sb.null_count, name
            if name == "d":
                continue  # pyarrow keeps NaN out of min/max as well
            assert (sa.min, sa.max) == (sb.min, sb.max), name


def test_sessions_read_the_same_rows(tmp_path, table):
    """The port's scan through TorchSession on the CPU and the reference's
    TpuSession.read_parquet over one reference-written file."""
    from spark_rapids_tpu.session import TpuSession
    files = jwrite_parquet(_as_reference(table), str(tmp_path / "x"),
                           row_group_rows=1000)
    got = TorchSession(device="cpu").read_parquet(*files).collect_table()
    want = TpuSession().read_parquet(*files).collect_table()
    assert tables_differ(_as_reference(got), want) is None


def test_string_codes_equal_the_encoder(tmp_path, table):
    """A decoded string column's seeded (codes, dictionary) is what
    encode_sorted_dict gives for its rows (nulls read as ""), and its
    values are the dictionary's own objects."""
    path = str(tmp_path / "f.parquet")
    pq.write_table(_pyarrow_table(table), path, row_group_size=500,
                   dictionary_pagesize_limit=64)
    col = PF.read_table(path, ["s"]).columns[0]
    codes, dictionary = col._cache["encode"]
    want_codes, want_dict = encode_sorted_dict(
        np.where(col.validity, col.data, ""))
    assert list(dictionary) == list(want_dict)
    assert np.array_equal(codes, want_codes)
    k = int(np.flatnonzero(col.validity)[0])
    assert col.data[k] is dictionary[codes[k]]


@pytest.mark.parametrize("data", [
    b"", b"a", bytes(range(256)) * 300, b"spark" * 20000,
    np.random.default_rng(1).bytes(200000)],
    ids=["empty", "one byte", "cycle", "repetitive", "incompressible"])
def test_snappy_roundtrip(data):
    codec = pa.Codec("snappy")
    packed = N.snappy_compress(data)
    assert N.snappy_decompress(packed).tobytes() == data
    assert codec.decompress(packed, decompressed_size=len(data)) \
        .to_pybytes() == data
    if data:
        assert N.snappy_decompress(
            codec.compress(data).to_pybytes()).tobytes() == data
    if data.startswith(b"spark"):
        assert len(packed) < len(data) // 20


@pytest.mark.parametrize("bit_width", [0, 1, 3, 8, 13, 32])
def test_rle_hybrid_roundtrip(bit_width):
    rng = np.random.default_rng(bit_width)
    hi = 2 ** min(bit_width, 31)
    v = rng.integers(0, hi, 5000).astype(np.int64)
    v[1000:3000] = v[1000]          # a long run
    v[4000:4007] = v[4000]          # a run too short for RLE
    v = v.astype(np.int32)
    enc = N.rle_encode(v, bit_width)
    got, used = N.rle_decode(enc, bit_width, len(v))
    assert used == len(enc)
    assert np.array_equal(got, v)


def _raises(path, match):
    with pytest.raises(NotImplementedError, match=match):
        PF.read_table(path)


def test_unsupported_raise_naming_themselves(tmp_path):
    t = pa.table({"x": pa.array([1, 2, 3], pa.int64()),
                  "ts": pa.array([1, 2, 3], pa.timestamp("us"))})
    p = str(tmp_path / "zstd.parquet")
    pq.write_table(t, p, compression="zstd")
    _raises(p, "ZSTD")
    p = str(tmp_path / "int96.parquet")
    pq.write_table(t, p, use_deprecated_int96_timestamps=True)
    _raises(p, "INT96")
    p = str(tmp_path / "delta.parquet")
    pq.write_table(t, p, use_dictionary=False,
                   column_encoding={"x": "DELTA_BINARY_PACKED"})
    _raises(p, "DELTA_BINARY_PACKED")
    p = str(tmp_path / "list.parquet")
    pq.write_table(pa.table({"xs": pa.array([[1, 2], [3]])}), p)
    _raises(p, "nested or repeated column 'xs'")
    p = str(tmp_path / "nanos.parquet")
    pq.write_table(pa.table({"n": pa.array([1], pa.timestamp("ns"))}), p,
                   coerce_timestamps=None, version="2.6")
    _raises(p, "NANOS")
    with pytest.raises(NotImplementedError, match="brotli"):
        PF.write_table(HostTable(["x"], [HostColumn(
            T.LONG, np.arange(3))]), str(tmp_path / "b.parquet"),
            compression="brotli")


def test_timestamp_millis_and_legacy_annotations(tmp_path):
    """TIMESTAMP(MILLIS) scales to micros; legacy converted types (no
    logical type, format 1.0) map as pyarrow maps them."""
    t = pa.table({
        "ms": pa.array([0, 1234, None, -5], pa.timestamp("ms")),
        "i8": pa.array([1, None, -3, 4], pa.int8()),
        "dec": pa.array([decimal.Decimal("1.25"), None,
                         decimal.Decimal("-7.50"), decimal.Decimal("0")],
                        pa.decimal128(5, 2)),
        "day": pa.array([datetime.date(2020, 2, 29), None,
                         datetime.date(1900, 1, 1),
                         datetime.date(1970, 1, 1)]),
    })
    for version in ("1.0", "2.6"):
        p = str(tmp_path / f"m{version}.parquet")
        pq.write_table(t, p, version=version)
        got = _port_read(p)
        assert tables_differ(got, _pyarrow_read(p)) is None
        assert got.columns[0].data[1] == 1234 * 1000


def test_decimals_on_int32_and_int64(tmp_path):
    """DECIMAL annotating INT32 and INT64 (pyarrow's
    store_decimal_as_integer), read as pyarrow reads them."""
    t = pa.table({
        "d9": pa.array([decimal.Decimal("1.25"), None,
                        decimal.Decimal("-3.10")], pa.decimal128(9, 2)),
        "d18": pa.array([decimal.Decimal("123456789012.25"),
                         decimal.Decimal("-1"), None],
                        pa.decimal128(18, 2))})
    p = str(tmp_path / "di.parquet")
    pq.write_table(t, p, store_decimal_as_integer=True)
    assert pq.ParquetFile(p).metadata.row_group(0).column(0) \
        .physical_type == "INT32"
    assert tables_differ(_port_read(p), _pyarrow_read(p)) is None


def _byte_array_chunk(values, valid):
    """One uncompressed version-1 page of PLAIN BYTE_ARRAY values (an
    OPTIONAL column), as raw chunk bytes and its ColumnChunk fields."""
    import struct
    levels = N.rle_encode(valid.astype(np.int32), 1)
    kept = [v for v, ok in zip(values, valid) if ok]
    offsets = np.zeros(len(kept) + 1, dtype=np.int64)
    np.cumsum([len(v) for v in kept], out=offsets[1:])
    body = (struct.pack("<I", len(levels)) + levels + N.byte_array_pack(
        np.frombuffer(b"".join(kept), dtype=np.uint8), offsets))
    i32, struct_t = 5, 12  # the compact protocol's field types
    head = PF.thrift_bytes([
        (1, i32, PF.DATA_PAGE), (2, i32, len(body)), (3, i32, len(body)),
        (5, struct_t, [(1, i32, len(values)), (2, i32, PF.PLAIN),
                       (3, i32, PF.RLE), (4, i32, PF.RLE)])])
    raw = head + body
    return raw, {3: {1: PF.BYTE_ARRAY, 4: PF.UNCOMPRESSED,
                     5: len(values), 7: len(raw), 9: 0}}


@pytest.mark.parametrize("precision", [9, 30])
def test_decimal_on_byte_array(precision):
    """DECIMAL annotating BYTE_ARRAY (variable-length big-endian two's
    complement, minimal bytes), against Python's int.from_bytes."""
    rng = np.random.default_rng(precision)
    ints = [int(x) * 10**(precision - 9) for x in
            rng.integers(-10**9 + 1, 10**9, 200)] + [0, -1, 1, -128, 127]
    blobs = [v.to_bytes(max(1, (v.bit_length() + 8) // 8), "big",
                        signed=True) for v in ints]
    blobs[-5] = b""  # an empty value reads as 0
    valid = rng.random(len(ints)) > 0.2
    raw, cc = _byte_array_chunk(blobs, valid)
    leaf = PF.Leaf({1: PF.BYTE_ARRAY, 3: PF.OPTIONAL, 4: b"x",
                    6: PF.CT_DECIMAL, 7: 2, 8: precision})
    col = PF.decode_column([raw], [PF.ChunkMeta(cc)], leaf)
    assert col.dtype == T.DecimalType(precision, 2)
    assert np.array_equal(col.validity, valid)
    want = [int.from_bytes(b, "big", signed=True) for b in blobs]
    got = [int(v) for v in col.data]
    assert [g for g, ok in zip(got, valid) if ok] == \
        [w for w, ok in zip(want, valid) if ok]
