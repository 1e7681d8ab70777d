"""The port's UDF compiler (spark_rapids_tpu_torch/udf.py) against the
JAX package's over the same rows: a counterpart of each test in
``tests/test_udf_compiler.py``. A UDF whose body compiles becomes this
package's expressions and runs on the device (``TorchSession(device=
"cpu")`` here: the kernels' plain versions); one that does not compile is
a row-wise ``PythonUDF`` that only the CPU route evaluates, tagged there
and reported. Inputs: the reference's ``tests/data_gen.py`` generators,
seeded. Comparator: ``scale_test.tables_differ`` (bitwise, in order:
every case is a projection over one batch), the reference's result on
``TpuSession``."""

import warnings

import numpy as np
import pytest

from scale_test import tables_differ
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.ops.expr import col as jcol
from spark_rapids_tpu.plan import from_host_table as jfrom
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch import types as TT
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.obs.events import collect_fallbacks
from spark_rapids_tpu_torch.ops.expr import col as tcol
from spark_rapids_tpu_torch.plan import from_host_table as tfrom
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.udf import UdfCompileError
from tests.data_gen import DoubleGen, IntGen, StringGen, gen_table


def _tables(n=400, seed=3):
    gens = {"x": IntGen(min_val=-100, max_val=100),
            "y": IntGen(min_val=1, max_val=50),
            "d": DoubleGen(corner_prob=0.0),
            "s": StringGen(cardinality=8)}
    jt = gen_table(gens, n, seed)
    tt = HostTable(list(jt.names), [
        HostColumn(TT.parse_type(c.dtype.simple_string()), c.data,
                   c.validity) for c in jt.columns])
    return jt, tt


def _as_reference(t):
    from spark_rapids_tpu.columnar import HostColumn as JHostColumn
    from spark_rapids_tpu.columnar import HostTable as JHostTable
    return JHostTable(list(t.names), [
        JHostColumn(JT.parse_type(c.dtype.simple_string()), c.data,
                    c.validity) for c in t.columns])


def _both(build_ref, build_port, n=400):
    """(port result as a reference table, reference result, port
    session) of each package's query over the same generated rows."""
    jt, tt = _tables(n)
    ts = TorchSession(device="cpu")
    want = build_ref(jfrom(jt, TpuSession())).collect_table()
    got = build_port(tfrom(tt, ts)).collect_table()
    return _as_reference(got), want, ts


def _quiet(f, *cols):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return f(*cols)


def test_arithmetic_udf_compiles_and_runs_on_device():
    def fn(x, y):
        return x * 2 + y - 1
    jf, tf = JF.udf(fn), TF.udf(fn)
    assert tf.compiled
    got, want, ts = _both(
        lambda d: d.select("x", jf(jcol("x"), jcol("y")).alias("u")),
        lambda d: d.select("x", tf(tcol("x"), tcol("y")).alias("u")))
    assert tables_differ(got, want) is None
    assert collect_fallbacks(ts.last_meta) == []


def test_udf_matches_rowwise_python():
    fn = lambda x, y: (x % y) + abs(x) if x > 0 else y * 3  # noqa: E731
    tf = TF.udf(fn)
    assert tf.compiled
    jt, tt = _tables()
    out = tfrom(tt, TorchSession(device="cpu")).select(
        "x", "y", tf(tcol("x"), tcol("y")).alias("u")).collect()
    for x, y, u in out:
        # a null input follows SQL (a null condition takes the else
        # branch), not Python: the reference's documented divergence
        if x is not None and y is not None:
            assert u == fn(x, y), (x, y, u)


def test_conditional_and_comparison_chain():
    fn = lambda x: 1 if 0 < x <= 50 else 0  # noqa: E731
    jf, tf = JF.udf(fn), TF.udf(fn)
    assert tf.compiled
    got, want, _ = _both(lambda d: d.select(jf(jcol("x")).alias("u")),
                         lambda d: d.select(tf(tcol("x")).alias("u")))
    assert tables_differ(got, want) is None


def test_string_method_udf():
    fn = lambda s: s.upper().strip()  # noqa: E731
    jf, tf = JF.udf(fn), TF.udf(fn)
    assert tf.compiled
    got, want, _ = _both(lambda d: d.select(jf(jcol("s")).alias("u")),
                         lambda d: d.select(tf(tcol("s")).alias("u")))
    assert tables_differ(got, want) is None


def test_def_function_compiles():
    def my_udf(a, b):
        return (a + b) * 2 - abs(a - b)

    assert TF.udf(my_udf).compiled
    got, want, _ = _both(
        lambda d: d.select(JF.udf(my_udf)(jcol("x"), jcol("y")).alias("u")),
        lambda d: d.select(TF.udf(my_udf)(tcol("x"), tcol("y")).alias("u")))
    assert tables_differ(got, want) is None


def test_min_max_rejected_for_null_semantics():
    """min()/max() would compile to null-skipping Least/Greatest while the
    row-wise path propagates nulls: the compiler refuses, and the
    row-wise UDF runs on the CPU route, reported."""
    fn = lambda a, b: min(a, b)  # noqa: E731
    tf = TF.udf(fn, return_type=TT.LONG)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        expr = tf(tcol("x"), tcol("y"))
    assert any("row-wise" in str(x.message) for x in w)
    jf = JF.udf(fn, return_type=JT.LONG)
    got, want, ts = _both(
        lambda d: d.select("x", "y", _quiet(jf, jcol("x"), jcol("y"))
                           .alias("u")),
        lambda d: d.select("x", "y", expr.alias("u")))
    assert tables_differ(got, want) is None
    assert collect_fallbacks(ts.last_meta) == [{"op": "Project", "reasons": [
        "expression PythonUDF configuration is not supported on GPU"]}]


def test_uncompilable_falls_back_with_warning():
    def loopy(x):
        t = 0
        for i in range(3):
            t += x
        return t

    tf = TF.udf(loopy, return_type=TT.LONG)
    assert not tf.compiled
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        expr = tf(tcol("x"))
    assert any("row-wise" in str(x.message) for x in w)
    jf = JF.udf(loopy, return_type=JT.LONG)
    got, want, _ = _both(
        lambda d: d.select("x", _quiet(jf, jcol("x")).alias("u")),
        lambda d: d.select("x", expr.alias("u")))
    assert tables_differ(got, want) is None


def test_uncompilable_without_return_type_raises():
    def loopy(x):
        t = 0
        for i in range(2):
            t += x
        return t

    with pytest.raises(UdfCompileError):
        TF.udf(loopy)(tcol("x"))


def test_closure_falls_back():
    k = 7
    tf = TF.udf(lambda x: x + k, return_type=TT.LONG)
    jf = JF.udf(lambda x: x + k, return_type=JT.LONG)
    got, want, _ = _both(
        lambda d: d.select("x", _quiet(jf, jcol("x")).alias("u")),
        lambda d: d.select("x", _quiet(tf, tcol("x")).alias("u")))
    assert tables_differ(got, want) is None


def test_columnar_device_udf():
    """A columnar UDF over the argument tensors runs on the device, inside
    the projection; the CPU route (its kill switch off) gives the same
    bits over host tensors."""
    import torch

    def clamped_product(args, valids):
        (x, y), (xv, yv) = args, valids
        return torch.clamp(x * y, -10.0, 10.0), xv & yv

    rng = np.random.default_rng(0)
    t = HostTable(["a", "b"], [HostColumn(TT.DOUBLE, rng.standard_normal(
        500) * 5) for _ in range(2)])
    a, b = (c.data for c in t.columns)

    def q(s):
        return tfrom(t, s).select(TF.columnar_udf(
            clamped_product, TT.DOUBLE, "a", "b").alias("c")).collect_table()
    dev = TorchSession(device="cpu")
    got = q(dev)
    assert collect_fallbacks(dev.last_meta) == []
    host = TorchSession({"spark.rapids.sql.expression.ColumnarDeviceUDF":
                         "false"}, device="cpu")
    again = q(host)
    assert collect_fallbacks(host.last_meta)[0]["op"] == "Project"
    want = np.clip(a * b, -10.0, 10.0)
    assert got.columns[0].data.tobytes() == want.tobytes()
    assert again.columns[0].data.tobytes() == want.tobytes()


def test_columnar_udf_string_return_rejected():
    with pytest.raises(UdfCompileError, match="fixed-width"):
        TF.columnar_udf(lambda a, v: (a[0], v[0]), TT.STRING, "a")


def test_columnar_udf_string_input_rejected():
    t = HostTable(["s"], [HostColumn(TT.STRING, np.array(["a", "b"],
                                                         dtype=object))])
    df = tfrom(t, TorchSession(device="cpu"))
    with pytest.raises(UdfCompileError, match="string arguments"):
        df.select(TF.columnar_udf(lambda a, v: (a[0], v[0]), TT.DOUBLE,
                                  "s").alias("x"))


def test_columnar_udf_key_stable_across_lambda_recreation():
    """Recreated lambdas with identical code share one key (the plan
    fingerprint's and the executable cache's)."""
    def make():
        return TF.columnar_udf(lambda a, v: (a[0] + 1.0, v[0]), TT.DOUBLE,
                               "x")

    assert make().key() == make().key()


def test_session_function_in_sql():
    """A compiled UDF registered as a session function resolves in SQL
    and equals the reference's; a row-wise one runs on the CPU route."""
    fn = lambda x, y: x * 2 + y  # noqa: E731
    jt, tt = _tables()
    ts, js = TorchSession(device="cpu"), TpuSession()
    tfrom(tt, ts).create_or_replace_temp_view("t")
    jfrom(jt, js).create_or_replace_temp_view("t")
    ts.catalog.register_function("f", TF.udf(fn))
    js.catalog.register_function("f", JF.udf(fn))
    text = "SELECT x, f(x, y) AS u FROM t"
    got = ts.sql(text).collect_table()
    assert tables_differ(_as_reference(got), js.sql(text).collect_table()) \
        is None
    assert collect_fallbacks(ts.last_meta) == []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ts.catalog.register_function(
            "g", lambda e: TF.udf(lambda v: {1: 10}.get(v, 0),
                                  TT.INT)(e))
        out = ts.sql("SELECT x, g(x) AS u FROM t").collect()
    assert [r[1] for r in out] == [(10 if x == 1 else 0) if x is not None
                                   else None for x, _ in out]
    assert collect_fallbacks(ts.last_meta)[0]["op"] == "Project"


def test_pandas_udfs_raise_naming_pandas():
    """The reference's pandas UDFs (and its Hive UDFs, pandas UDFs too)
    need pandas and pyarrow: not ported."""
    from spark_rapids_tpu_torch.sql import registry
    with pytest.raises(NotImplementedError, match="pandas"):
        TF.pandas_udf(TT.LONG)
    with pytest.raises(NotImplementedError, match="pandas"):
        registry.register_hive_udf("h", str.upper, "string")
