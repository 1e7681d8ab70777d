"""The port's Hive text scan and writer (spark_rapids_tpu_torch/io/
hive_text.py, the CSV scan with Hive's defaults over the port's text
codec) against the reference's: the Hive cases of
tests/test_write_hive_filecache.py (the round trip, the null marker, a
custom SerDe, escape.delim over strings and rendered numbers, a
partitioned table), the writer's bytes over every flat type, and the
committed write through ``DataFrame.write_hive_text``.

Each case runs on both packages over the same files: the reference on
``TpuSession``, the port on ``TorchSession(device="cpu")``. Comparator:
``scale_test.tables_differ`` (bitwise, in order) unless a case names
``scale_test.tables_differ_unordered`` (a partitioned table reads back
directory by directory)."""

import glob
import os

import numpy as np
import pytest

from scale_test import tables_differ, tables_differ_unordered
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.io.hive_text import write_hive_text as jwrite
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.io.hive_text import write_hive_text
from spark_rapids_tpu_torch.session import TorchSession
from tests.data_gen import IntGen, StringGen, gen_table, table_gen


def _as_reference(t) -> JHostTable:
    names, types, arrays = t.to_arrays()
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(ty), d, v)
        for ty, (d, v) in zip(types, arrays)])


def _as_port(t) -> HostTable:
    return HostTable(list(t.names), [
        HostColumn(T.parse_type(c.dtype.simple_string()), c.data, c.validity)
        for c in t.columns])


@pytest.fixture(scope="module")
def ref():
    return TpuSession()


@pytest.fixture(scope="module")
def port():
    return TorchSession(device="cpu")


def _schema(pairs, types):
    return [(n, types.parse_type(t)) for n, t in pairs]


def _same(ref, port, build, cmp=tables_differ):
    want = build(ref, JT).collect_table()
    got = _as_reference(build(port, T).collect_table())
    assert list(got.names) == list(want.names)
    assert [str(c.dtype) for c in got.columns] == \
        [str(c.dtype) for c in want.columns]
    assert cmp(got, want) is None
    return got


def _files(d):
    return sorted(glob.glob(os.path.join(str(d), "**", "*.txt"),
                            recursive=True))


def _same_bytes(jt, tmp_path, **kw):
    """Both writers over one table: the same files, byte for byte."""
    jwrite(jt, str(tmp_path / "j"), **kw)
    write_hive_text(_as_port(jt), str(tmp_path / "t"), **kw)
    jf, tf = _files(tmp_path / "j"), _files(tmp_path / "t")
    assert [os.path.relpath(f, str(tmp_path / "j")) for f in jf] == \
        [os.path.relpath(f, str(tmp_path / "t")) for f in tf]
    for a, b in zip(jf, tf):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a
    return str(tmp_path / "j"), str(tmp_path / "t")


def test_hive_text_roundtrip(ref, port, tmp_path):
    jt = gen_table({"k": StringGen(cardinality=4, nullable=False),
                    "v": IntGen(nullable=False)}, 200, 4)
    for d in _same_bytes(jt, tmp_path):
        got = _same(ref, port, lambda s, t: s.read_hive_text(
            *_files(d), schema=_schema([("k", "string"), ("v", "int")], t)))
        assert tables_differ(got, jt) is None


def test_hive_text_null_marker(ref, port, tmp_path):
    p = str(tmp_path / "n.txt")
    with open(p, "w") as f:
        f.write("a\x015\n\\N\x017\nb\x01\\N\n\x01\n")
    _same(ref, port, lambda s, t: s.read_hive_text(
        p, schema=_schema([("s", "string"), ("i", "string")], t)))
    with open(p, "w") as f:
        f.write("a\x015\n\\N\x017\nb\x01\\N\n")
    got = _same(ref, port, lambda s, t: s.read_hive_text(
        p, schema=_schema([("s", "string"), ("i", "int")], t)))
    assert got.columns[0].validity.tolist() == [True, False, True]


def test_hive_text_boolean_and_custom_serde(ref, port, tmp_path):
    jt = JHostTable(["b", "n"], [
        JHostColumn(JT.BOOLEAN, np.array([True, False, False]),
                    np.array([True, True, False])),
        JHostColumn(JT.LONG, np.array([1, 0, 3]),
                    np.array([True, False, True]))])
    for d in _same_bytes(jt, tmp_path, delimiter="|", null_value="NULLY"):
        with open(_files(d)[0]) as f:
            assert f.read().splitlines() == ["true|1", "false|NULLY",
                                             "NULLY|3"]
        _same(ref, port, lambda s, t: s.read_hive_text(
            d, schema=_schema([("b", "boolean"), ("n", "bigint")], t),
            delimiter="|", null_value="NULLY"))


def test_hive_text_escape_delim_roundtrip(ref, port, tmp_path):
    """escape.delim: a delimiter, the escape and a newline inside a value
    are escaped on write and read back as data."""
    jt = JHostTable(["s", "x"], [
        JHostColumn(JT.STRING, np.array(["a|b", "nl\nin", None, "t~e",
                                         "é~|\n"], dtype=object),
                    np.array([True, True, False, True, True])),
        JHostColumn(JT.LONG, np.arange(1, 6))])
    for d in _same_bytes(jt, tmp_path, delimiter="|", escape="~"):
        with open(_files(d)[0]) as f:
            assert "a~|b|1" in f.read()
        got = _same(ref, port, lambda s, t: s.read_hive_text(
            d, schema=_schema([("s", "string"), ("x", "bigint")], t),
            delimiter="|", escape="~"))
        assert got.num_rows == 5


def test_hive_text_escape_applies_to_rendered_numerics(ref, port, tmp_path):
    jt = JHostTable(["a", "b", "f"], [
        JHostColumn(JT.LONG, np.array([-5, 7])),
        JHostColumn(JT.LONG, np.array([1, 2])),
        JHostColumn(JT.DOUBLE, np.array([-1.5e-7, 2.0]))])
    for d in _same_bytes(jt, tmp_path, delimiter="-", escape="~"):
        _same(ref, port, lambda s, t: s.read_hive_text(
            d, schema=_schema([("a", "bigint"), ("b", "bigint"),
                               ("f", "double")], t),
            delimiter="-", escape="~"))


def test_hive_text_partitioned_table(ref, port, tmp_path):
    jt = JHostTable(["v", "p"], [
        JHostColumn(JT.LONG, np.arange(6)),
        JHostColumn(JT.STRING, np.array(list("xyxyxy"), dtype=object))])
    for d in _same_bytes(jt, tmp_path, partition_by=["p"]):
        assert glob.glob(os.path.join(d, "p=x", "*.txt"))
        got = _same(ref, port, lambda s, t: s.read_hive_text(
            d, schema=_schema([("v", "bigint")], t)).sort("v"))
        assert got.columns[1].data.tolist() == list("xyxyxy")


def test_writer_bytes_over_every_flat_type(ref, port, tmp_path):
    """Every flat type rendered as ``_hive_cell`` renders it: str() of the
    reference's Python values (repr floats, unscaled decimals, naive
    timestamps)."""
    jt = table_gen({"y": JT.BYTE, "h": JT.SHORT, "i": JT.INT, "l": JT.LONG,
                    "f": JT.FLOAT, "d": JT.DOUBLE, "b": JT.BOOLEAN,
                    "s": JT.STRING, "dt": JT.DATE, "ts": JT.TIMESTAMP},
                   300, seed=5)
    _same_bytes(jt, tmp_path)
    names = [("y", "tinyint"), ("h", "smallint"), ("i", "int"),
             ("l", "bigint"), ("b", "boolean"), ("dt", "date")]
    _same(ref, port, lambda s, t: s.read_hive_text(
        str(tmp_path / "t"), columns=[n for n, _ in names],
        schema=_schema([("y", "tinyint"), ("h", "smallint"), ("i", "int"),
                        ("l", "bigint"), ("f", "float"), ("d", "double"),
                        ("b", "boolean"), ("s", "string"), ("dt", "date"),
                        ("ts", "string")], t)),
        cmp=tables_differ_unordered)


def test_committed_write_through_the_dataframe(port, tmp_path):
    from spark_rapids_tpu_torch.plan import from_host_table
    t = HostTable(["k", "v"], [
        HostColumn(T.STRING, np.array(["a", "b", "a"], dtype=object)),
        HostColumn(T.LONG, np.array([1, 2, 3]))])
    out = str(tmp_path / "w")
    stats = from_host_table(t, port).write_hive_text(out, partition_by=["k"])
    assert int(stats.columns[1].data[0]) == 3
    assert os.path.exists(os.path.join(out, "_SUCCESS"))
    back = port.read_hive_text(out, schema=[("v", T.LONG)]).sort("v")
    assert back.collect() == [(1, "a"), (2, "b"), (3, "a")]
