"""The port's nested Parquet columns (io/parquet_format.py's
NestedColumn, list_layout and nested writer; the scans of io/parquet.py)
against pyarrow.

The reference decodes Parquet through pyarrow and raises on any nested
Arrow type (``spark_rapids_tpu/io/arrow_convert.py:48``), pinned below;
so each read is held against pyarrow's own read of the same file, row for
row (comparator: ``==`` on the Python rows, the form
``HostColumn.to_pylist`` gives; maps as pyarrow's (key, value) lists
turned into dicts). Files come from pyarrow (the 3-level LIST, MAP,
STRUCT, a list of structs), from a hand-built legacy 2-level LIST and
from the port's writer (read back by pyarrow); every case holds null and
empty lists, null elements, null structs and null fields, through the
three reader modes."""

import datetime

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu_torch import types as TT
from spark_rapids_tpu_torch.columnar import nested as CN
from spark_rapids_tpu_torch.io import parquet_format as PF
from spark_rapids_tpu_torch.session import TorchSession

MODES = ("PERFILE", "COALESCING", "MULTITHREADED")


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    ids, arrs, maps, structs, dates = [], [], [], [], []
    for i in range(n):
        u = rng.random()
        ids.append(i)
        arrs.append(None if u < 0.1 else [] if u < 0.2 else [
            None if rng.random() < 0.15 else float(rng.normal())
            for _ in range(int(rng.integers(1, 6)))])
        maps.append(None if u > 0.9 else {
            int(k): (None if rng.random() < 0.2 else float(k) / 3)
            for k in rng.choice(50, int(rng.integers(0, 4)), replace=False)})
        structs.append(None if rng.random() < 0.1 else {
            "x": None if rng.random() < 0.2 else int(rng.integers(-9, 9)),
            "y": None if rng.random() < 0.2 else bool(rng.random() > .5)})
        dates.append(None if u < 0.05 else [
            int(rng.integers(0, 20000)) for _ in range(int(u * 4))])
    return pa.table({
        "id": pa.array(ids, pa.int64()),
        "a": pa.array(arrs, pa.list_(pa.float64())),
        "m": pa.array([None if m is None else list(m.items()) for m in maps],
                      pa.map_(pa.int32(), pa.float64())),
        "s": pa.array(structs, pa.struct([("x", pa.int64()),
                                          ("y", pa.bool_())])),
        "d": pa.array([None if d is None else [
            datetime.date(1970, 1, 1) + datetime.timedelta(days=x)
            for x in d] for d in dates], pa.list_(pa.date32())),
    })


def _pyarrow_rows(table: pa.Table, names):
    out = []
    for name in names:
        col = table.column(name).to_pylist()
        if pa.types.is_map(table.schema.field(name).type):
            col = [None if m is None else dict(m) for m in col]
        elif pa.types.is_struct(table.schema.field(name).type):
            col = [None if s is None else tuple(s.values()) for s in col]
        out.append(col)
    return out


def _port_rows(t, names):
    return [t.columns[t.names.index(n)].to_pylist() for n in names]


@pytest.fixture(scope="module")
def pyarrow_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pq_nested")
    paths = []
    for i, comp in enumerate(("snappy", "zstd")):
        p = str(d / f"part-{i}.parquet")
        pq.write_table(_rows(400, i), p, compression=comp,
                       row_group_size=150, data_page_version="2.0"
                       if i else "1.0")
        paths.append(p)
    return str(d), paths


def test_the_reference_reader_raises_on_nested_types(pyarrow_files):
    from spark_rapids_tpu.errors import ColumnarProcessingError
    from spark_rapids_tpu.session import TpuSession
    with pytest.raises(ColumnarProcessingError, match="unsupported Arrow"):
        TpuSession().read_parquet(pyarrow_files[1][0]).collect_table()


def test_schema_of_pyarrow_nested_columns(pyarrow_files):
    meta = PF.read_footer(pyarrow_files[1][0])
    assert meta.schema() == [
        ("id", TT.LONG), ("a", TT.ArrayType(TT.DOUBLE)),
        ("m", TT.MapType(TT.INT, TT.DOUBLE)),
        ("s", TT.StructType([("x", TT.LONG), ("y", TT.BOOLEAN)])),
        ("d", TT.ArrayType(TT.DATE))]


@pytest.mark.parametrize("mode", MODES)
def test_read_equals_pyarrow_in_every_mode(mode, pyarrow_files):
    d, paths = pyarrow_files
    s = TorchSession({"spark.rapids.sql.format.parquet.reader.type": mode},
                     device="cpu")
    got = s.read_parquet(d).collect_table()
    names = ["id", "a", "m", "s", "d"]
    want = pq.read_table(paths[0])
    want = pa.concat_tables([want, pq.read_table(paths[1])])
    rows = _port_rows(got, names)
    # dates: pyarrow gives datetime.date, the port's to_pylist too
    assert rows == _pyarrow_rows(want, names)


@pytest.mark.parametrize("mode", MODES)
def test_explode_of_a_file_column(mode, pyarrow_files):
    from spark_rapids_tpu_torch import functions as F
    d, paths = pyarrow_files
    s = TorchSession({"spark.rapids.sql.format.parquet.reader.type": mode},
                     device="cpu")
    got = s.read_parquet(d).select(
        "id", F.posexplode_outer("a").alias("x")).collect_table()
    want = []
    for p in paths:
        t = pq.read_table(p)
        for i, arr in zip(t.column("id").to_pylist(),
                          t.column("a").to_pylist()):
            if arr:
                want += [(i, j, v) for j, v in enumerate(arr)]
    want_outer = [(i, None, None) for p in paths for i, arr in zip(
        pq.read_table(p).column("id").to_pylist(),
        pq.read_table(p).column("a").to_pylist()) if not arr]
    rows = list(zip(*[c.to_pylist() for c in got.columns]))
    assert sorted(rows, key=repr) == sorted(want + want_outer, key=repr)


def _two_level_file(path, rows):
    """A legacy 2-level LIST (``optional group a (LIST) { repeated int64
    array; }``), written with the codec's own pieces."""
    import struct as st
    ht = CN.from_objects(TT.ArrayType(TT.LONG), np.array(rows, dtype=object),
                         np.array([r is not None for r in rows]))
    col = PF.HostColumn(TT.ArrayType(TT.LONG), ht,
                        np.array([r is not None for r in rows]))
    rep, deff, slot_d, slot_v = PF._nested_levels(col)[0]
    deff = np.minimum(deff, 2)  # the element is REQUIRED: max level 2
    with open(path, "wb") as f:
        f.write(PF.MAGIC)
        cc, _, _ = PF._write_nested_chunk(
            f, ["a", "array"], TT.LONG, PF.INT64, 1, 2,
            (rep, deff, slot_d, deff == 2), PF.UNCOMPRESSED, 1 << 20)
        elements = [
            [(4, PF._BINARY, "schema"), (5, PF._I32, 1)],
            [(3, PF._I32, PF.OPTIONAL), (4, PF._BINARY, "a"),
             (5, PF._I32, 1), (6, PF._I32, 3)],
            [(1, PF._I32, PF.INT64), (3, PF._I32, PF.REPEATED),
             (4, PF._BINARY, "array")]]
        footer = PF.thrift_bytes([
            (1, PF._I32, 1), (2, PF._LIST, (PF._STRUCT, elements)),
            (3, PF._I64, len(rows)),
            (4, PF._LIST, (PF._STRUCT, [[
                (1, PF._LIST, (PF._STRUCT, [cc])), (2, PF._I64, 0),
                (3, PF._I64, len(rows))]]))])
        f.write(footer)
        f.write(st.pack("<I", len(footer)))
        f.write(PF.MAGIC)


def test_legacy_two_level_list(tmp_path):
    rows = [[1, 2], None, [], [3], [4, 5, 6], None]
    p = str(tmp_path / "two.parquet")
    _two_level_file(p, rows)
    assert pq.read_table(p).column("a").to_pylist() == rows
    meta = PF.read_footer(p)
    assert meta.schema() == [("a", TT.ArrayType(TT.LONG))]
    assert PF.read_columns(p, meta, ["a"]).columns[0].to_pylist() == rows


def test_a_bare_repeated_field(tmp_path):
    """A repeated primitive with no LIST group: a list of required
    elements, never null (an empty row has no value)."""
    import struct as st
    rows = [[1, 2], [], [3]]
    p = str(tmp_path / "bare.parquet")
    ht = CN.from_objects(TT.ArrayType(TT.INT), np.array(rows, dtype=object),
                         np.ones(3, bool))
    col = PF.HostColumn(TT.ArrayType(TT.INT), ht, np.ones(3, bool))
    rep, deff, slot_d, _ = PF._nested_levels(col)[0]
    deff = np.where(deff >= 2, 1, 0).astype(np.int32)
    with open(p, "wb") as f:
        f.write(PF.MAGIC)
        cc, _, _ = PF._write_nested_chunk(
            f, ["r"], TT.INT, PF.INT32, 1, 1, (rep, deff, slot_d, deff == 1),
            PF.UNCOMPRESSED, 1 << 20)
        elements = [[(4, PF._BINARY, "schema"), (5, PF._I32, 1)],
                    [(1, PF._I32, PF.INT32), (3, PF._I32, PF.REPEATED),
                     (4, PF._BINARY, "r")]]
        footer = PF.thrift_bytes([
            (1, PF._I32, 1), (2, PF._LIST, (PF._STRUCT, elements)),
            (3, PF._I64, 3),
            (4, PF._LIST, (PF._STRUCT, [[
                (1, PF._LIST, (PF._STRUCT, [cc])), (2, PF._I64, 0),
                (3, PF._I64, 3)]]))])
        f.write(footer)
        f.write(st.pack("<I", len(footer)))
        f.write(PF.MAGIC)
    assert pq.read_table(p).column("r").to_pylist() == rows
    got = PF.read_table(p).columns[0]
    assert got.to_pylist() == rows and got.validity.all()


def test_a_list_of_structs_decodes_at_every_level_and_raises_9c(tmp_path):
    """A list of structs has no device layout: reading it raises naming
    [9-ext] (an extension the reference lacks); its leaves' levels still decode to pyarrow's offsets, struct
    validity and field values (null list, empty list, null struct, null
    field)."""
    rows = [[{"x": 1, "y": 2.0}], None, [], [None, {"x": None, "y": 3.5}],
            [{"x": 4, "y": None}, {"x": 5, "y": 6.0}, None]]
    t = pa.table({"ls": pa.array(rows, pa.list_(pa.struct(
        [("x", pa.int64()), ("y", pa.float64())])))})
    p = str(tmp_path / "ls.parquet")
    pq.write_table(t, p)
    meta = PF.read_footer(p)
    with pytest.raises(NotImplementedError, match=r"\[9-ext\]"):
        PF.read_columns(p, meta, ["ls"])
    rg = meta.row_groups[0]
    with open(p, "rb") as f:
        got = {}
        for key in ("ls.list.element.x", "ls.list.element.y"):
            cm = rg.chunks[key]
            f.seek(cm.start)
            raw = f.read(cm.length)
            leaf = PF.Leaf({4: key.rsplit(".", 1)[1].encode(),
                            1: PF.INT64 if key.endswith("x") else PF.DOUBLE,
                            3: PF.OPTIONAL})
            leaf.max_def, leaf.max_rep = 4, 1
            levels = []
            slots = PF.decode_column([raw], [cm], leaf, levels)
            rl = np.concatenate([a for a, _ in levels])
            dl = np.concatenate([b for _, b in levels])
            got[key] = (slots, rl, dl)
    slots, rl, dl = got["ls.list.element.x"]
    row_valid, offsets, elem_def = PF.list_layout(rl, dl, 1, 2)
    assert row_valid.tolist() == [r is not None for r in rows]
    assert np.diff(offsets).tolist() == [len(r or []) for r in rows]
    flat = [e for r in rows if r for e in r]
    assert (elem_def >= 3).tolist() == [e is not None for e in flat]
    for key, f in (("ls.list.element.x", "x"), ("ls.list.element.y", "y")):
        slots, rl, dl = got[key]
        at = dl >= 2
        vals = slots.to_pylist()
        vals = [v for v, ok in zip(vals, at) if ok]
        assert vals == [None if e is None else e[f] for e in flat]


def _port_written(tmp_path, compression):
    from spark_rapids_tpu_torch.columnar import HostTable
    from tests.torch_nested import port_column
    t = _rows(300, 5)
    names = ["id", "a", "m", "s", "d"]
    rows = _pyarrow_rows(t, names)
    types = [TT.LONG, TT.ArrayType(TT.DOUBLE), TT.MapType(TT.INT, TT.DOUBLE),
             TT.StructType([("x", TT.LONG), ("y", TT.BOOLEAN)]),
             TT.ArrayType(TT.DATE)]
    import datetime as dt
    conv = [[None if x is None else [(v - dt.date(1970, 1, 1)).days
                                      for v in x] for x in rows[4]]]
    cols = [port_column(v, ty) for v, ty in
            zip(rows[:4] + conv, types)]
    host = HostTable(names, cols)
    p = str(tmp_path / f"w-{compression}.parquet")
    PF.write_table(host, p, compression, row_group_rows=128, page_bytes=256)
    return host, p, t, names


@pytest.mark.parametrize("compression", ["snappy", "none", "zstd"])
def test_pyarrow_reads_what_the_port_writes(compression, tmp_path):
    host, p, t, names = _port_written(tmp_path, compression)
    back = pq.read_table(p)
    assert _pyarrow_rows(back, names) == _pyarrow_rows(t, names)
    again = PF.read_table(p)
    assert _port_rows(again, names) == _port_rows(host, names)


def test_a_nested_write_of_strings_raises_9c(tmp_path):
    from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
    col = HostColumn(TT.StructType([("x", TT.LONG)]),
                     CN.StructData([(np.zeros(1, np.int64),
                                     np.ones(1, bool))]), np.ones(1, bool))
    col.dtype = TT.StructType([("x", TT.STRING)])
    with pytest.raises(NotImplementedError, match=r"\[9-ext\]"):
        PF.write_table(HostTable(["s"], [col]), str(tmp_path / "x.parquet"))


@pytest.mark.parametrize("mode", MODES)
def test_session_round_trip_of_collect_results(mode, tmp_path):
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.ops.expr import col
    from spark_rapids_tpu_torch.plan import from_host_table
    from tests.torch_nested import port_column
    from spark_rapids_tpu_torch.columnar import HostTable
    rng = np.random.default_rng(9)
    n = 1500
    h = HostTable(["k", "q", "p"], [
        port_column(rng.integers(0, 200, n).tolist(), TT.LONG),
        port_column([None if rng.random() < .1 else int(x)
                     for x in rng.integers(1, 50, n)], TT.LONG),
        port_column(rng.random(n).tolist(), TT.DOUBLE)])
    s = TorchSession({"spark.rapids.sql.format.parquet.reader.type": mode},
                     device="cpu")
    g = from_host_table(h, s).group_by("k").agg(
        F.collect_list("q").alias("ql"), F.collect_set("q").alias("qs"),
        F.percentile("p", 0.5).alias("med")).select(
        "k", "ql", "qs", "med",
        F.named_struct("a", col("k"), "b", col("med")).alias("st"),
        F.create_map(col("k"), col("med")).alias("m"))
    want = g.collect_table()
    d = str(tmp_path / "out")
    g.write_parquet(d)
    got = s.read_parquet(d).collect_table()
    assert [c.to_pylist() for c in got.columns] == \
        [c.to_pylist() for c in want.columns]
    back = pq.read_table(d)
    assert back.column("ql").to_pylist() == want.columns[1].to_pylist()


def test_a_partitioned_write_of_nested_columns(tmp_path):
    """Rows split by a flat partition column carry their arrays, structs
    and maps (each partition's rows taken from the flat buffers)."""
    from spark_rapids_tpu_torch.columnar import HostTable
    from spark_rapids_tpu_torch.io.parquet import write_parquet
    from tests.torch_nested import port_column
    rows = [[1, 2], None, [], [3], [4, None]]
    host = HostTable(["p", "a", "m"], [
        port_column([0, 1, 0, 1, 0], TT.INT),
        port_column(rows, TT.ArrayType(TT.LONG)),
        port_column([{1: 1.0}, None, {}, {2: None}, {3: 3.0}],
                    TT.MapType(TT.INT, TT.DOUBLE))])
    d = str(tmp_path / "parts")
    write_parquet(host, d, partition_by=["p"])
    got = TorchSession(device="cpu").read_parquet(d).collect_table()
    by = {}
    cols = {n: c.to_pylist() for n, c in zip(got.names, got.columns)}
    for p, a, m in zip(cols["p"], cols["a"], cols["m"]):
        by.setdefault(p, []).append((a, m))
    assert sorted(by[0], key=repr) == sorted(
        [([1, 2], {1: 1.0}), ([], {}), ([4, None], {3: 3.0})], key=repr)
    assert sorted(by[1], key=repr) == sorted([(None, None), ([3], {2: None})],
                                             key=repr)
