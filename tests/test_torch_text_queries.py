"""The text slice as a whole on the CPU, against the reference: TPC-H q1
over lineitem from CSV files (with ``schema=``, and without, where Arrow's
inference reads the integral l_quantity as LONG), corpus queries at
``scale_test_specs(0.02)`` from CSV and JSON files the port writes, through
the DSL and through ``CREATE TEMP VIEW ... USING csv``, and a committed
write of each text format that ends in an injected fault and leaves no
visible file, then commits on its retry.

The reference reads the same files through a session whose
``read_parquet`` reads the text format instead (``scale_test.py``'s corpus
reads Parquet). Comparators, per query as tests/test_torch_io_queries.py
names them: ``scale_test.tables_close`` (rtol 1e-9) for the f64 sums,
``scale_test.tables_differ_unordered`` for the windows without ORDER BY
(two files are two batches), ``scale_test.tables_differ`` (bitwise, in
order) otherwise."""

import os

import numpy as np
import pytest
import torch

from scale_test import build_queries as jbuild_queries
from scale_test import build_sql_queries as jbuild_sql_queries
from scale_test import tables_close, tables_differ, tables_differ_unordered
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.runtime import speculation as jspec
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.errors import KernelCrashError
from spark_rapids_tpu_torch.io.committer import TEMP_DIR, read_manifest
from spark_rapids_tpu_torch.models import corpus as tcorpus
from spark_rapids_tpu_torch.models import tpch as ttpch
from spark_rapids_tpu_torch.plan import from_host_table
from spark_rapids_tpu_torch.plan import nodes as P
from spark_rapids_tpu_torch.runtime import speculation as tspec
from spark_rapids_tpu_torch.session import TorchSession

SF = 0.02
F64_SUMS = ("q1", "q2", "q3", "q4", "q9", "q10", "q12", "q14", "q15",
            "q17", "q19")
UNORDERED = ("q6", "q21")
SOME = ("q1", "q3", "q6", "q8", "q13", "q18", "q20")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _clear_blocklists():
    jspec._BLOCKLIST.clear()
    tspec.clear_blocklist()
    yield
    jspec._BLOCKLIST.clear()
    tspec.clear_blocklist()


def _as_reference(t) -> JHostTable:
    names, types, arrays = t.to_arrays()
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(ty), d, v)
        for ty, (d, v) in zip(types, arrays)])


def _compare(name, got, want):
    if name in F64_SUMS:
        return tables_close(got, want, rtol=1e-9)
    if name in UNORDERED:
        return tables_differ_unordered(got, want)
    return tables_differ(got, want)


class _TextReads:
    """A reference session whose ``read_parquet`` reads a corpus table's
    CSV or JSON files as the port's ``read_corpus_table`` does."""

    def __init__(self, s, fmt, schemas):
        self._s, self._fmt, self._schemas = s, fmt, schemas

    def read_parquet(self, path):
        from spark_rapids_tpu.ops.decimal import MakeDecimal
        from spark_rapids_tpu.ops.expr import col
        schema = [(n, JT.parse_type(dt.simple_string()))
                  for n, dt in self._schemas[path]]
        if self._fmt == "csv":
            return self._s.read_csv(path, schema=schema)
        df = self._s.read_json(path, schema=[
            (n, JT.TIMESTAMP if isinstance(dt, JT.DateType) else
             JT.LONG if isinstance(dt, JT.DecimalType) else dt)
            for n, dt in schema])
        return df.select(*[
            col(n).cast(JT.DATE).alias(n) if isinstance(dt, JT.DateType)
            else MakeDecimal(col(n), dt.precision, dt.scale).alias(n)
            if isinstance(dt, JT.DecimalType) else col(n)
            for n, dt in schema])

    def __getattr__(self, name):
        return getattr(self._s, name)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(port tables, {fmt: their directories}), written once."""
    tables = tcorpus.corpus_tables(SF, 0)
    base = str(tmp_path_factory.mktemp("textcorpus"))
    return tables, {fmt: tcorpus.write_corpus_files(
        tables, os.path.join(base, fmt), 2, fmt=fmt)
        for fmt in ("csv", "json")}


@pytest.mark.parametrize("form", ["csv dsl", "csv sql using", "json dsl"])
@pytest.mark.parametrize("name", SOME)
def test_corpus_from_text_files_matches_reference(corpus, name, form):
    tables, paths = corpus
    fmt = form.split()[0]
    schemas = {paths[fmt][n]: t.schema() for n, t in tables.items()}
    ref = _TextReads(TpuSession(), fmt, schemas)
    port = TorchSession(device="cpu")
    if form == "csv sql using":
        want = jbuild_sql_queries(ref, None, paths=paths[fmt])[name]()
        got = tcorpus.build_sql_queries(port, tables, paths=paths[fmt],
                                        fmt=fmt)[name]()
    else:
        want = jbuild_queries(ref, None, paths=paths[fmt])[name]()
        got = tcorpus.build_queries(port, tables, paths=paths[fmt],
                                    fmt=fmt)[name]()
    got = _as_reference(got.collect_table())
    assert got.num_rows > 0
    assert _compare(name, got, want.collect_table()) is None


@pytest.mark.parametrize("fmt", ["csv", "json"])
def test_text_files_hold_the_tables_row_for_row(corpus, fmt):
    """Every table read back from its two files equals its source, in
    every reader mode (tables_differ)."""
    tables, paths = corpus
    for mode in ("PERFILE", "COALESCING", "MULTITHREADED"):
        s = TorchSession({f"spark.rapids.sql.format.{fmt}.reader.type":
                          mode}, device="cpu")
        for name, t in tables.items():
            df = tcorpus.read_corpus_table(s, fmt, paths[fmt][name],
                                           t.schema())
            assert tables_differ(_as_reference(df.collect_table()),
                                 _as_reference(t)) is None, (name, mode)


@pytest.mark.parametrize("schema", [True, False],
                         ids=["schema", "inferred"])
def test_q1_over_lineitem_from_csv(tmp_path, schema):
    """TPC-H q1 from two CSV files. Without a schema Arrow's inference
    reads l_quantity (integral doubles, written as "17") as LONG, so its
    sum is a LONG in both packages (hazard 1)."""
    from spark_rapids_tpu.models import tpch as jtpch
    from spark_rapids_tpu_torch.io.csv import write_csv
    t = ttpch.lineitem_table(3000, seed=5)
    for k in range(2):
        write_csv(t.slice(k * 1500, 1500), str(tmp_path / f"c{k:03d}"))
    jschema = [(n, JT.parse_type(dt.simple_string())) for n, dt in
               t.schema()]
    ref = TpuSession()
    jdf = ref.read_csv(str(tmp_path), **({"schema": jschema} if schema
                                         else {}))
    # the reference's q1_dataframe takes a HostTable: its scan's table
    want = jtpch.q1_dataframe(ref, jdf.collect_table()).collect_table()
    port = TorchSession(device="cpu")
    df = port.read_csv(str(tmp_path), **(
        {"schema": t.schema()} if schema else {}))
    got = ttpch.q1_dataframe(port, df).collect_table()
    assert [str(c.dtype) for c in got.columns][2] == (
        "double" if schema else "bigint")
    assert tables_close(_as_reference(got), want, rtol=1e-9) is None


@pytest.mark.parametrize("fmt", ["csv", "json", "hive_text"])
def test_faulted_text_write_leaves_nothing_visible(tmp_path, fmt):
    """A committed write that dies in a file's write leaves no visible
    file and no marker; the same plan's retry commits, and the files read
    back as the table (tables_differ_unordered: one file a key)."""
    from spark_rapids_tpu_torch.runtime.faults import FAULTS
    t = _kv_table()
    FAULTS.disarm()
    s = TorchSession({"spark.rapids.test.faults": "io.write.file:crash:1"},
                     device="cpu")
    out = str(tmp_path / fmt)
    node = P.WriteFiles(from_host_table(t, s).plan, fmt, out, ["k"], {})
    with pytest.raises(KernelCrashError):
        s.execute(node)
    assert _visible(out) == [] and read_manifest(out) is None
    assert not os.path.exists(os.path.join(out, TEMP_DIR))
    s.execute(node)
    FAULTS.disarm()
    assert read_manifest(out)["numRows"] == t.num_rows
    read = {"csv": lambda: s.read_csv(out, schema=[("v", T.LONG)]),
            "json": lambda: s.read_json(out, schema=[("v", T.LONG)]),
            "hive_text": lambda: s.read_hive_text(out,
                                                  schema=[("v", T.LONG)])}
    back = read[fmt]().select("k", "v").collect_table()
    assert tables_differ_unordered(_as_reference(back),
                                   _as_reference(t)) is None


def _kv_table():
    from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
    return HostTable(["k", "v"], [
        HostColumn(T.STRING, np.array([f"k{i % 3}" for i in range(30)],
                                      dtype=object)),
        HostColumn(T.LONG, np.arange(30, dtype=np.int64))])


def _visible(path):
    out = []
    for _root, dirs, files in os.walk(path):
        dirs[:] = [d for d in dirs if not d.startswith(("_", "."))]
        out.extend(f for f in files if not f.startswith(("_", ".")))
    return sorted(out)
