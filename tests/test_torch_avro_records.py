"""The port's generic Avro record decoder (spark_rapids_tpu_torch/io/avro.py
``decode_records``) against the reference's on the same container files
(tests/avro_util.write_avro): nested records, arrays, maps, unions with
null, logical types, the null and deflate codecs, several blocks, and
Iceberg's manifest and manifest-list schemas. Compared with ``==`` on the
decoded Python values."""

import io
import json

import numpy as np
import pytest

from spark_rapids_tpu.io.avro import decode_records as jdecode
from spark_rapids_tpu_torch.errors import ColumnarProcessingError
from spark_rapids_tpu_torch.io.avro import decode_records as tdecode
from tests.avro_util import _zigzag, write_avro
from tests.iceberg_util import MANIFEST_ENTRY_SCHEMA, MANIFEST_LIST_SCHEMA

NESTED = {
    "type": "record", "name": "outer", "fields": [
        {"name": "id", "type": "long"},
        {"name": "name", "type": ["null", "string"]},
        {"name": "score", "type": "double"},
        {"name": "ratio", "type": "float"},
        {"name": "ok", "type": "boolean"},
        {"name": "tags", "type": {"type": "array", "items": "string"}},
        {"name": "props", "type": {"type": "map", "values": "long"}},
        {"name": "inner", "type": {
            "type": "record", "name": "inner_t", "fields": [
                {"name": "a", "type": "int"},
                {"name": "b", "type": ["null", {"type": "array",
                                                "items": "int"}]}]}},
        {"name": "day", "type": {"type": "int", "logicalType": "date"}},
    ]}


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append({
            "id": int(rng.integers(-10**12, 10**12)),
            "name": None if i % 4 == 0 else f"n{i}",
            "score": float(rng.standard_normal()),
            "ratio": float(np.float32(rng.standard_normal())),
            "ok": bool(i % 3),
            "tags": [f"t{j}" for j in range(int(rng.integers(0, 4)))],
            "props": {f"p{j}": int(rng.integers(0, 99))
                      for j in range(int(rng.integers(0, 3)))},
            "inner": {"a": int(rng.integers(-5, 5)),
                      "b": None if i % 5 == 0 else
                      [int(x) for x in rng.integers(0, 9, 3)]},
            "day": int(rng.integers(0, 20000))})
    return out


@pytest.mark.parametrize("codec", ["null", "deflate"])
@pytest.mark.parametrize("n,per_block", [(1, 1000), (250, 64), (0, 10)],
                         ids=["one", "blocks", "empty"])
def test_nested_records_equal_the_reference(tmp_path, codec, n, per_block):
    rows = _rows(n, seed=n)
    p = str(tmp_path / "r.avro")
    write_avro(p, NESTED, rows, codec=codec, rows_per_block=per_block)
    buf = open(p, "rb").read()
    got = tdecode(buf)
    assert got == jdecode(buf)
    assert len(got) == n
    if n:
        assert got[0]["tags"] == rows[0]["tags"]
        assert got[0]["inner"] == rows[0]["inner"]


def test_iceberg_manifests_equal_the_reference(tmp_path):
    entries = [{"status": s, "sequence_number": None if s == 2 else 3,
                "data_file": {"content": c, "file_path": f"/t/data/{i}.pq",
                              "file_format": "PARQUET", "record_count": i,
                              "file_size_in_bytes": 100 + i,
                              "equality_ids": [1, 4] if c == 2 else None}}
               for i, (s, c) in enumerate([(1, 0), (1, 1), (2, 0), (1, 2)])]
    for schema, rows in ((MANIFEST_ENTRY_SCHEMA, entries),
                         (MANIFEST_LIST_SCHEMA, [
                             {"manifest_path": "/t/m.avro",
                              "manifest_length": 7, "content": 0}])):
        p = str(tmp_path / "m.avro")
        write_avro(p, schema, rows)
        buf = open(p, "rb").read()
        assert tdecode(buf) == jdecode(buf) == rows


def _container(schema: dict, body: bytes, count: int) -> bytes:
    out = io.BytesIO()
    out.write(b"Obj\x01")
    meta = {"avro.schema": json.dumps(schema).encode(),
            "avro.codec": b"null"}
    out.write(_zigzag(len(meta)))
    for k, v in meta.items():
        out.write(_zigzag(len(k)) + k.encode())
        out.write(_zigzag(len(v)) + v)
    out.write(_zigzag(0))
    sync = b"S" * 16
    out.write(sync)
    out.write(_zigzag(count) + _zigzag(len(body)) + body + sync)
    return out.getvalue()


def test_enum_fixed_multi_branch_union_and_blocked_array():
    """The branches write_avro does not write: an enum, two fixed, a union
    of three branches, and an array in a negative-count block (with its
    byte size), encoded by hand."""
    schema = {"type": "record", "name": "e", "fields": [
        {"name": "color", "type": {"type": "enum", "name": "c",
                                   "symbols": ["RED", "GREEN", "BLUE"]}},
        {"name": "fx", "type": {"type": "fixed", "name": "f4", "size": 4}},
        {"name": "u", "type": ["null", "long", "string"]},
        {"name": "again", "type": {"type": "fixed", "name": "f4b",
                                   "size": 4}},
        {"name": "xs", "type": {"type": "array", "items": "long"}}]}
    body = b""
    for color, fx, u, xs in ((2, b"abcd", ("long", -7), [1, 2, 3]),
                             (0, b"wxyz", ("string", "hi"), []),
                             (1, b"\x00\x01\x02\x03", None, [9])):
        body += _zigzag(color) + fx
        if u is None:
            body += _zigzag(0)
        elif u[0] == "long":
            body += _zigzag(1) + _zigzag(u[1])
        else:
            body += _zigzag(2) + _zigzag(len(u[1])) + u[1].encode()
        body += fx[::-1]
        if xs:
            items = b"".join(_zigzag(x) for x in xs)
            body += _zigzag(-len(xs)) + _zigzag(len(items)) + items
        body += _zigzag(0)
    buf = _container(schema, body, 3)
    got = tdecode(buf)
    assert got == jdecode(buf)
    assert [r["color"] for r in got] == ["BLUE", "RED", "GREEN"]
    assert got[0]["u"] == -7 and got[1]["u"] == "hi" and got[2]["u"] is None
    assert got[0]["xs"] == [1, 2, 3] and got[1]["again"] == b"zyxw"


def test_corrupt_sync_and_unknown_type_raise():
    schema = {"type": "record", "name": "r",
              "fields": [{"name": "a", "type": "long"}]}
    buf = bytearray(_container(schema, _zigzag(5), 1))
    buf[-1] ^= 0xFF
    with pytest.raises(ColumnarProcessingError, match="sync"):
        tdecode(bytes(buf))
    bad = {"type": "record", "name": "r",
           "fields": [{"name": "a", "type": "decimal128"}]}
    with pytest.raises(ColumnarProcessingError, match="unknown avro type"):
        tdecode(_container(bad, b"", 0))
