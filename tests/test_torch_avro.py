"""The port's Avro scan (spark_rapids_tpu_torch/io/avro.py) against the
reference's, the cases of tests/test_avro.py: the container decode under
the null, deflate and zstandard codecs, timestamp-millis scaling, the
header, a corrupt sync marker, unsupported types, the engine scan in
every reader mode with partition columns and pruning, and a filter and
aggregate over the scan; plus the codecs the port rejects.

Comparators: ``scale_test.tables_differ`` (bitwise, in order) for
decoded files and scans; ``scale_test.tables_close`` (rtol 1e-9,
order-insensitive) for the aggregate's f64 sum."""

import sys

import numpy as np
import pytest

from scale_test import tables_close, tables_differ
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.io import avro as javro
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.errors import ColumnarProcessingError
from spark_rapids_tpu_torch.io.avro import decode_file, read_header
from spark_rapids_tpu_torch.session import TorchSession
from tests.avro_util import write_avro

SCHEMA = {
    "type": "record", "name": "t", "fields": [
        {"name": "i", "type": "int"},
        {"name": "l", "type": ["null", "long"]},
        {"name": "d", "type": "double"},
        {"name": "f", "type": "float"},
        {"name": "b", "type": "boolean"},
        {"name": "s", "type": ["null", "string"]},
        {"name": "dt", "type": {"type": "int", "logicalType": "date"}},
        {"name": "ts", "type": {"type": "long",
                                "logicalType": "timestamp-micros"}},
    ]}


def _as_reference(t) -> JHostTable:
    names, types, arrays = t.to_arrays()
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(ty), d, v)
        for ty, (d, v) in zip(types, arrays)])


def _rows(n, seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for k in range(n):
        rows.append({
            "i": int(rng.integers(-1000, 1000)),
            "l": None if k % 7 == 0 else int(rng.integers(-10**12, 10**12)),
            "d": float(rng.standard_normal()),
            "f": float(np.float32(rng.standard_normal())),
            "b": bool(k % 3 == 0),
            "s": None if k % 5 == 0 else f"row-{k}-{rng.integers(0, 99)}",
            "dt": int(rng.integers(0, 20000)),
            "ts": int(rng.integers(0, 10**15)),
        })
    return rows


@pytest.mark.parametrize("codec", ["null", "deflate", "zstandard"])
def test_decode_matches_reference(tmp_path, codec):
    rows = _rows(500, seed=1)
    path = str(tmp_path / "a.avro")
    write_avro(path, SCHEMA, rows, codec=codec, rows_per_block=128)
    buf = open(path, "rb").read()
    got = decode_file(buf)
    assert got.num_rows == 500
    assert list(got.names) == ["i", "l", "d", "f", "b", "s", "dt", "ts"]
    assert tables_differ(_as_reference(got), javro.decode_file(buf)) is None
    col = dict(zip(got.names, got.columns))
    for k in (0, 1, 5, 7, 499):
        assert col["i"].data[k] == rows[k]["i"]
        assert col["l"].validity[k] == (rows[k]["l"] is not None)
        assert col["s"].validity[k] == (rows[k]["s"] is not None)
        assert col["ts"].data[k] == rows[k]["ts"]


def test_zstandard_without_its_module_raises_naming_it(tmp_path,
                                                       monkeypatch):
    path = str(tmp_path / "z.avro")
    write_avro(path, SCHEMA, _rows(20), codec="zstandard")
    monkeypatch.setitem(sys.modules, "zstandard", None)
    with pytest.raises(ColumnarProcessingError, match="zstandard"):
        decode_file(open(path, "rb").read())


def test_snappy_codec_rejected(tmp_path):
    path = str(tmp_path / "s.avro")
    write_avro(path, SCHEMA, _rows(3))
    buf = open(path, "rb").read().replace(b"\x08null", b"\x0csnappy", 1)
    assert read_header(buf).codec == "snappy"
    with pytest.raises(ColumnarProcessingError, match="snappy"):
        decode_file(buf)


def test_timestamp_millis_scaled(tmp_path):
    schema = {"type": "record", "name": "t", "fields": [
        {"name": "ts", "type": {"type": "long",
                                "logicalType": "timestamp-millis"}}]}
    path = str(tmp_path / "m.avro")
    write_avro(path, schema, [{"ts": 1234}])
    table = decode_file(open(path, "rb").read())
    assert table.columns[0].data[0] == 1234 * 1000  # micros internally


def test_header_parse(tmp_path):
    path = str(tmp_path / "h.avro")
    write_avro(path, SCHEMA, _rows(3), codec="deflate")
    info = read_header(open(path, "rb").read())
    assert info.codec == "deflate"
    assert [f["name"] for f in info.schema_json["fields"]][0] == "i"


def test_corrupt_sync_rejected(tmp_path):
    path = str(tmp_path / "c.avro")
    write_avro(path, SCHEMA, _rows(10))
    buf = bytearray(open(path, "rb").read())
    buf[-1] ^= 0xFF  # the final sync marker
    with pytest.raises(ColumnarProcessingError, match="sync"):
        decode_file(bytes(buf))


def test_unsupported_types_rejected(tmp_path):
    import json

    from tests.avro_util import _zigzag
    schema = {"type": "record", "name": "t", "fields": [
        {"name": "x", "type": "bytes"}]}
    path = str(tmp_path / "u.avro")
    with open(path, "wb") as fh:
        fh.write(b"Obj\x01" + _zigzag(1))
        v = json.dumps(schema).encode()
        kb = b"avro.schema"
        fh.write(_zigzag(len(kb)) + kb + _zigzag(len(v)) + v)
        fh.write(_zigzag(0) + b"0123456789abcdef")
    with pytest.raises(ColumnarProcessingError, match="unsupported avro"):
        decode_file(open(path, "rb").read())


@pytest.mark.parametrize("mode", ["PERFILE", "COALESCING", "MULTITHREADED"])
def test_engine_scan_modes_and_pruning(tmp_path, mode):
    rows = _rows(600, seed=2)
    for part in range(3):
        sub = tmp_path / f"p={part}"
        sub.mkdir()
        write_avro(str(sub / "part.avro"), SCHEMA,
                   rows[part * 200:(part + 1) * 200], codec="deflate")
    port = TorchSession(device="cpu")
    got = port.read_avro(str(tmp_path), reader_type=mode).collect_table()
    want = TpuSession().read_avro(str(tmp_path),
                                  reader_type=mode).collect_table()
    assert got.num_rows == 600
    assert tables_differ(_as_reference(got), want) is None
    # the partition column comes back, and pruning narrows the scan
    t = port.read_avro(str(tmp_path), columns=["i", "p"]).collect_table()
    assert list(t.names) == ["i", "p"]
    assert sorted(set(t.columns[1].data.tolist())) == [0, 1, 2]
    via_spi = port.read.format("avro").load(str(tmp_path)).collect_table()
    assert tables_differ(_as_reference(via_spi), want) is None


def test_engine_filter_aggregate_over_avro(tmp_path):
    from spark_rapids_tpu import functions as JF
    from spark_rapids_tpu.ops.expr import col as jcol
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.ops.expr import col

    write_avro(str(tmp_path / "x.avro"), SCHEMA, _rows(1000, seed=3))
    got = (TorchSession(device="cpu").read_avro(str(tmp_path / "x.avro"))
           .filter(col("i") > 0).group_by("b")
           .agg(F.count("i").alias("c"), F.sum("d").alias("sd"))
           .collect_table())
    want = (TpuSession().read_avro(str(tmp_path / "x.avro"))
            .filter(jcol("i") > 0).group_by("b")
            .agg(JF.count("i").alias("c"), JF.sum("d").alias("sd"))
            .collect_table())
    assert tables_close(_as_reference(got), want, rtol=1e-9) is None
