"""Shared helpers of the nested-type tests of the port
(tests/test_torch_nested_columns.py, test_torch_collections.py,
test_torch_higher_order.py, test_torch_generate.py,
test_torch_parquet_nested.py): one table built from the same Python rows
in both packages, each package's session and DSL, and the port's results
as reference HostTables for ``scale_test``'s comparators."""

import types

import numpy as np

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.ops.expr import col as jcol
from spark_rapids_tpu.ops.expr import lit as jlit
from spark_rapids_tpu.plan import from_host_table as jfrom
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch import types as TT
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.ops.expr import col as tcol
from spark_rapids_tpu_torch.ops.expr import lit as tlit
from spark_rapids_tpu_torch.plan import from_host_table as tfrom

from spark_rapids_tpu.ops.window import Window as JW  # noqa: E402
from spark_rapids_tpu_torch.ops.window import Window as TW  # noqa: E402

REF = types.SimpleNamespace(F=JF, col=jcol, lit=jlit, T=JT, frm=jfrom, W=JW)
PORT = types.SimpleNamespace(F=TF, col=tcol, lit=tlit, T=TT, frm=tfrom,
                             W=TW)


def ref_type(dt):
    """The reference's DataType of a port DataType."""
    if isinstance(dt, TT.ArrayType):
        return JT.ArrayType(ref_type(dt.element_type))
    if isinstance(dt, TT.MapType):
        return JT.MapType(key_type=ref_type(dt.key_type),
                          value_type=ref_type(dt.value_type))
    if isinstance(dt, TT.StructType):
        return JT.StructType([JT.StructField(f.name, ref_type(f.data_type))
                              for f in dt.fields])
    if isinstance(dt, TT.DecimalType):
        return JT.DecimalType(dt.precision, dt.scale)
    return JT.parse_type(dt.simple_string())


def port_column(values, dt) -> HostColumn:
    """A port HostColumn of Python values (None = null)."""
    n = len(values)
    valid = np.array([v is not None for v in values], dtype=bool)
    if isinstance(dt, (TT.ArrayType, TT.StructType, TT.MapType)):
        objs = np.empty(n, dtype=object)
        objs[:] = list(values)
        return HostColumn(dt, objs, valid)
    if isinstance(dt, TT.StringType):
        data = np.empty(n, dtype=object)
        data[:] = list(values)
        return HostColumn(dt, data, valid)
    data = np.zeros(n, dtype=dt.np_dtype)
    data[valid] = [v for v in values if v is not None]
    return HostColumn(dt, data, valid)


def tables(columns):
    """(reference HostTable, port HostTable) of ``columns``: a list of
    (name, port DataType, Python values)."""
    names = [n for n, _, _ in columns]
    jt = JHostTable(names, [JHostColumn.from_pylist(list(v), ref_type(dt))
                            for _, dt, v in columns])
    tt = HostTable(names, [port_column(list(v), dt) for _, dt, v in columns])
    return jt, tt


def as_reference(t: HostTable) -> JHostTable:
    """A port result as a reference HostTable (nested columns as the
    reference's object arrays of lists, tuples and dicts)."""
    cols = []
    for c in t.columns:
        data = np.asarray(c.data) if isinstance(
            c.dtype, (TT.ArrayType, TT.StructType, TT.MapType)) else c.data
        cols.append(JHostColumn(ref_type(c.dtype), data,
                                np.asarray(c.validity, dtype=bool)))
    return JHostTable(list(t.names), cols)


def run_both(build, jt, tt, js, ts, nb: int = 1):
    """``build(api, df)`` over each package's DataFrame of its table (in
    ``nb`` batches): (reference result, port result as a reference
    HostTable)."""
    want = build(REF, jfrom(jt, js, nb)).collect_table()
    got = build(PORT, tfrom(tt, ts, nb)).collect_table()
    return want, as_reference(got)


def _leaf_parts(dt, vals):
    """Exact parts of the valid leaf values ``vals`` of type ``dt``: the
    strings, the unscaled decimals as Python ints, else the bytes of the
    values in the type's storage (NaN payloads and -0.0 kept)."""
    if isinstance(dt, (TT.StringType, TT.DecimalType)) and (
            isinstance(dt, TT.StringType) or TT.is_dec128(dt)):
        return [("values", [v if isinstance(v, str) else int(v)
                            for v in vals])]
    arr = np.asarray([v.item() if hasattr(v, "item") else v for v in vals],
                     dtype=dt.np_dtype)
    return [("bits", arr.tobytes())]


def flat_parts(dt, rows, valid, where="") -> list:
    """A column's exact parts, as (label, value) pairs: its validity,
    and, over its valid rows, an array's lengths (the offsets), its
    elements' validity and parts, a map's lengths, keys and values, a
    struct's fields, or a leaf's values bit for bit."""
    valid = [bool(v) for v in valid]
    out = [(where + "validity", valid)]
    vrows = [r for r, v in zip(rows, valid) if v]
    if isinstance(dt, TT.ArrayType):
        elems = [e for r in vrows for e in r]
        out.append((where + "lengths", [len(r) for r in vrows]))
        out += flat_parts(dt.element_type, elems,
                          [e is not None for e in elems], where + "element ")
    elif isinstance(dt, TT.MapType):
        items = [kv for r in vrows for kv in (
            r.items() if isinstance(r, dict) else r)]
        out.append((where + "lengths", [len(r) for r in vrows]))
        out += flat_parts(dt.key_type, [k for k, _ in items],
                          [True] * len(items), where + "key ")
        vals = [v for _, v in items]
        out += flat_parts(dt.value_type, vals, [v is not None for v in vals],
                          where + "value ")
    elif isinstance(dt, TT.StructType):
        for i, f in enumerate(dt.fields):
            vals = [r.get(f.name) if isinstance(r, dict) else r[i]
                    for r in vrows]
            out += flat_parts(f.data_type, vals,
                              [v is not None for v in vals],
                              f"{where}field {f.name} ")
    else:
        out += [(where + k, v) for k, v in _leaf_parts(dt, vrows)]
    return out


def _rows(c):
    return np.asarray(c.data) if isinstance(
        c.dtype, (TT.ArrayType, TT.StructType, TT.MapType)) else c.data


def _row_key(t, i):
    """A sort key of row i: its values with floats as their bits."""
    def canon(v):
        if isinstance(v, (float, np.floating)):
            return ("f", np.float64(v).view(np.int64).item())
        if isinstance(v, (list, tuple)):
            return ("l", tuple(canon(x) for x in v))
        if isinstance(v, dict):
            return ("d", tuple(sorted((repr(canon(k)), canon(x))
                                      for k, x in v.items())))
        if hasattr(v, "item"):
            return canon(v.item())
        return ("v", repr(v))
    return repr(tuple(canon(_rows(c)[i]) if c.validity[i] else None
                      for c in t.columns))


def _reordered(t, ordered: bool, dtypes):
    """(rows, validity) per column of ``t``, in row order or sorted by
    ``_row_key``."""
    n = t.num_rows
    order = list(range(n)) if ordered else sorted(
        range(n), key=lambda i: _row_key(t, i))
    out = []
    for c in t.columns:
        rows = _rows(c)
        out.append(([rows[i] for i in order],
                    [bool(c.validity[i]) for i in order]))
    return out


def nested_differ(want, got, ordered: bool = True):
    """None when the port's result ``got`` (a port HostTable, or one
    ``as_reference`` made) equals the reference's ``want`` exactly: the
    same names, and per column the same validity, offsets, element
    validity and element bits (NaN payloads and -0.0 exact); with
    ``ordered`` False the rows are compared as a multiset, each side
    sorted by its values' bits. Else a message naming the first
    difference."""
    if list(want.names) != list(got.names):
        return f"names {list(got.names)} != {list(want.names)}"
    if want.num_rows != got.num_rows:
        return f"rows {got.num_rows} != {want.num_rows}"
    dtypes = []
    for c in got.columns:
        dt = c.dtype
        if not isinstance(dt, TT.DataType):
            dt = port_type(dt)
        dtypes.append(dt)
    wcols = _reordered(want, ordered, dtypes)
    gcols = _reordered(got, ordered, dtypes)
    for name, dt, (wr, wv), (gr, gv) in zip(want.names, dtypes, wcols,
                                            gcols):
        wp = flat_parts(dt, wr, wv)
        gp = flat_parts(dt, gr, gv)
        for (label, a), (_, b) in zip(wp, gp):
            if a != b:
                return f"column {name}: {label} differ"
    return None


def port_type(dt):
    """The port's DataType of a reference DataType."""
    if isinstance(dt, JT.ArrayType):
        return TT.ArrayType(port_type(dt.element_type))
    if isinstance(dt, JT.MapType):
        return TT.MapType(key_type=port_type(dt.key_type),
                          value_type=port_type(dt.value_type))
    if isinstance(dt, JT.StructType):
        return TT.StructType([TT.StructField(f.name, port_type(f.data_type))
                              for f in dt.fields])
    if isinstance(dt, JT.DecimalType):
        return TT.DecimalType(dt.precision, dt.scale)
    return TT.parse_type(dt.simple_string())


def run_both_exact(build, jt, tt, js, ts, nb: int = 1,
                   ordered: bool = True):
    """``run_both``'s results held to ``nested_differ``; returns the port's
    result (as a reference HostTable)."""
    want, got = run_both(build, jt, tt, js, ts, nb)
    diff = nested_differ(want, got, ordered)
    assert diff is None, diff
    return got
