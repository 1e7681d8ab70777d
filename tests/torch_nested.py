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

REF = types.SimpleNamespace(F=JF, col=jcol, lit=jlit, T=JT, frm=jfrom)
PORT = types.SimpleNamespace(F=TF, col=tcol, lit=tlit, T=TT, frm=tfrom)


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
