"""The port's 64-bit segment MIN/MAX (ops/segsum.py::segment_minmax_64 and
the fused_minmax kernel's plain version) against the JAX package's
segment_minmax_64 on the same numpy inputs, run as tests/test_kernels.py
runs it: its Pallas kernel in interpret mode under a forced
KernelsConfig(enabled=("segreduce",)), and its HLO form.

Comparator: bit identity (raw bytes, so NaN payloads and signed zeros
count). Every case of one dtype lies in its own segments of one input,
so each reference program compiles once.

Two stated differences, each pinned by its own test:
- NaN: the reference's DEFAULT CPU aggregate route (plain segment_min)
  gives NaN for min({1.0, NaN}); its split route, segment_minmax_64, gives
  1.0, Spark's rule. The port follows segment_minmax_64 everywhere.
- Subnormals: XLA's CPU backend flushes subnormal doubles to zero, so the
  reference returns +-0.0 where the exact extreme is subnormal; the port
  returns the subnormal itself."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu import kernels as jkernels
from spark_rapids_tpu.kernels import KernelsConfig
from spark_rapids_tpu.ops import segsum as jsegsum
from spark_rapids_tpu_torch import kernels as K
from spark_rapids_tpu_torch.kernels import segreduce as tseg
from spark_rapids_tpu_torch.ops import segsum as tsegsum

pytestmark = pytest.mark.kernels

NSEG = 16


@pytest.fixture(autouse=True)
def _clean_kernel_state():
    jkernels.reset()
    yield
    jkernels.reset()


def _reference(route, is_min, vals, valid, gid, nseg=NSEG):
    """The JAX package's segment_minmax_64 with its Pallas kernel forced on
    (``route == "pallas"``) or every kernel off (``"hlo"``)."""
    names = ("segreduce",) if route == "pallas" else ()
    tok = jkernels.KERNELS_ENABLED.set(KernelsConfig(enabled=names))
    try:
        out = jsegsum.segment_minmax_64(
            is_min, jnp.asarray(vals), jnp.asarray(valid),
            jnp.asarray(gid, jnp.int32), nseg)
        return np.asarray(out)
    finally:
        jkernels.KERNELS_ENABLED.reset(tok)


def _port(is_min, vals, valid, gid, nseg=NSEG):
    return tsegsum.segment_minmax_64(
        is_min, torch.from_numpy(vals), torch.from_numpy(valid),
        torch.from_numpy(gid.astype(np.int32)), nseg).numpy()


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _case_i64(rng, n=256):
    """Segments: 0-9 random (INT64 extremes in 0 and 1), 10 all-null, 11
    one valid row, 12 the INT64 edges, 13 and 14 empty, 15 ties."""
    x = rng.integers(-(2 ** 62), 2 ** 62, n).astype(np.int64)
    gid = rng.integers(0, 10, n)
    valid = rng.random(n) > 0.2
    x[:6] = [2 ** 63 - 1, -(2 ** 63), 0, -1, 1, -(2 ** 31)]
    gid[:2], valid[:6] = [0, 1], True
    gid[10:20], valid[10:20] = 10, False
    gid[20:24], valid[20:24] = 11, [False, True, False, False]
    x[30:36] = [2 ** 63 - 1, -(2 ** 63), 0, -1, 2 ** 32, -(2 ** 32)]
    gid[30:36], valid[30:36] = 12, True
    x[40:48] = 7
    gid[40:48], valid[40:48] = 15, True
    return x, valid, gid


def _case_f64(rng, n=256, big=False):
    """Segments: 0-5 random (edge values spread over them), 6 all-NaN (two
    payloads, both signs), 7 NaN beside numbers, 8 (-0.0, 0.0), 9 (0.0,
    -0.0), 10 all-null, 11 +inf only, 12 -inf and NaN, 13 empty, 14 NaN
    beside nulls, 15 one row. ``big`` adds 1e300 and -1e300, which send
    the reference down its exact (``lossy``) route."""
    x = rng.standard_normal(n) * 1e18
    gid = rng.integers(0, 6, n)
    valid = rng.random(n) > 0.2
    edges = [np.nan, -0.0, 0.0, np.inf, -np.inf, 3.5, -2.25]
    if big:
        edges += [1e300, -1e300]
    x[:len(edges)] = edges
    valid[:len(edges)] = True
    nan2 = np.array([0x7FF8000000000001, 0xFFF8000000000000],
                    dtype=np.uint64).view(np.float64)
    for s, vals in ((6, [np.nan, nan2[0], nan2[1]]),
                    (7, [1.0, np.nan, -5.0, nan2[1]]),
                    (8, [-0.0, 0.0]), (9, [0.0, -0.0]),
                    (11, [np.inf, np.inf]), (12, [-np.inf, np.nan]),
                    (15, [42.0])):
        pos = 20 + 6 * s
        x[pos:pos + len(vals)] = vals
        gid[pos:pos + len(vals)] = s
        valid[pos:pos + len(vals)] = True
    gid[200:204], valid[200:204] = 10, False
    x[210:214], gid[210:214] = [np.nan, 1.0, 2.0, np.nan], 14
    valid[210:214] = [True, False, False, True]
    return x, valid, gid


def _cases():
    rng = np.random.default_rng(5)
    return {"i64": _case_i64(rng), "f64": _case_f64(rng),
            "f64 lossy": _case_f64(rng, big=True)}


CASES = _cases()


@pytest.mark.parametrize("route", ["pallas", "hlo"])
@pytest.mark.parametrize("is_min", [True, False], ids=["min", "max"])
@pytest.mark.parametrize("case", list(CASES))
def test_segment_minmax_bit_identical_to_reference(case, is_min, route):
    vals, valid, gid = CASES[case]
    ref = _reference(route, is_min, vals, valid, gid)
    got = _port(is_min, vals, valid, gid)
    assert _bits_equal(got, ref), (got, ref)


@pytest.mark.parametrize("is_min", [True, False], ids=["min", "max"])
def test_float_edges_follow_sparks_order(is_min):
    """What the bits above mean: NaN greatest, the canonical NaN out,
    ordered signed zeros, identities in empty segments."""
    vals, valid, gid = CASES["f64"]
    got = _port(is_min, vals, valid, gid)
    bits = got.view(np.uint64)
    assert bits[6] == 0x7FF8000000000000  # all-NaN: canonical NaN
    if is_min:
        assert got[7] == -5.0 and got[12] == -np.inf
        assert bits[8] == bits[9] == 0x8000000000000000  # -0.0
        assert got[13] == np.inf and got[10] == np.inf  # empty, all-null
    else:
        assert bits[7] == bits[12] == 0x7FF8000000000000
        assert bits[8] == bits[9] == 0  # +0.0
        assert got[13] == -np.inf and got[10] == -np.inf
    assert bits[14] == 0x7FF8000000000000 and got[15] == 42.0
    assert got[11] == np.inf


def test_int64_identities_and_extremes():
    vals, valid, gid = CASES["i64"]
    lo = _port(True, vals, valid, gid)
    hi = _port(False, vals, valid, gid)
    assert lo[12] == -(2 ** 63) and hi[12] == 2 ** 63 - 1
    for s in (10, 13, 14):  # all-null and empty: the identities
        assert lo[s] == 2 ** 63 - 1 and hi[s] == -(2 ** 63)
    assert lo[15] == hi[15] == 7


def test_nan_rule_deviation_from_the_reference_default_route():
    """A group holding {1.0, NaN}: the reference's default CPU aggregate
    route (splitF64 off: plain segment_min) gives NaN for min; its split
    route gives 1.0, Spark's rule; the port gives 1.0 on every device.
    max is NaN on every route. A FLOAT column: the reference reduces f32
    by plain segment_min on both routes (NaN); the port widens it to f64
    for the same kernel and gives Spark's 1.0."""
    from spark_rapids_tpu import functions as JF
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.columnar import HostColumn as JHostColumn
    from spark_rapids_tpu.columnar import HostTable as JHostTable
    from spark_rapids_tpu.plan import from_host_table as jfrom
    from spark_rapids_tpu.session import TpuSession
    from spark_rapids_tpu_torch import functions as TF
    from spark_rapids_tpu_torch import types as TT
    from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
    from spark_rapids_tpu_torch.plan import from_host_table as tfrom
    from spark_rapids_tpu_torch.session import TorchSession

    k = np.array([0, 0, 1, 1], dtype=np.int64)
    v = np.array([1.0, np.nan, 2.0, 3.0])
    f = v.astype(np.float32)
    jt = JHostTable(["k", "v", "f"], [JHostColumn(JT.LONG, k),
                                      JHostColumn(JT.DOUBLE, v),
                                      JHostColumn(JT.FLOAT, f)])
    tt = HostTable(["k", "v", "f"], [HostColumn(TT.LONG, k),
                                     HostColumn(TT.DOUBLE, v),
                                     HostColumn(TT.FLOAT, f)])

    def ref(conf):
        return jfrom(jt, TpuSession(conf)).group_by("k").agg(
            JF.min("v").alias("lo"), JF.max("v").alias("hi"),
            JF.min("f").alias("flo"), JF.max("f").alias("fhi")).collect()

    got = tfrom(tt, TorchSession(device="cpu")).group_by("k").agg(
        TF.min("v").alias("lo"), TF.max("v").alias("hi"),
        TF.min("f").alias("flo"), TF.max("f").alias("fhi")).collect()
    default = ref(None)
    split = ref({"spark.rapids.tpu.sum.splitF64": "true"})
    assert np.isnan(default[0][1]) and default[1] == (1, 2.0, 3.0, 2.0, 3.0)
    assert split[0][1] == 1.0 and np.isnan(split[0][2])
    assert got[0][1] == 1.0 and np.isnan(got[0][2]) and got[1] == split[1]
    for route in (default, split):
        assert np.isnan(route[0][3]) and np.isnan(route[0][4])
    assert got[0][3] == 1.0 and np.isnan(got[0][4])


@pytest.mark.parametrize("is_min", [True, False], ids=["min", "max"])
def test_subnormal_deviation(is_min):
    """XLA's CPU backend flushes subnormal doubles to zero (sign kept): the
    reference returns +-0.0 where the port returns the exact subnormal.
    Away from subnormals the two agree (the tests above)."""
    vals = np.array([2.0, 5e-324, 1e-310, 3.0, -5e-324, -1.0])
    gid = np.array([0, 0, 1, 1, 2, 2])
    valid = np.ones(6, bool)
    got = _port(is_min, vals, valid, gid, nseg=3)
    ref = _reference("hlo", is_min, vals, valid, gid, nseg=3)
    want = (np.array([5e-324, 1e-310, -1.0]) if is_min
            else np.array([2.0, 3.0, -5e-324]))
    assert _bits_equal(got, want)
    flushed = np.where(np.abs(got) < np.finfo(np.float64).tiny,
                       np.copysign(0.0, got), got)
    assert _bits_equal(ref, flushed)


def test_key_map_orders_doubles_as_spark_does():
    """The plain version's key map: sorting by key sorts by value, with
    -0.0 before 0.0 and every NaN (any payload, either sign) last and
    equal."""
    rng = np.random.default_rng(9)
    x = np.concatenate([rng.standard_normal(500) * 10.0 ** rng.integers(
        -300, 300, 500), [0.0, -0.0, np.inf, -np.inf, 5e-324, -5e-324,
                          np.nan, -np.nan]])
    keys = tseg._f64_keys(torch.from_numpy(x)).numpy()
    order = np.argsort(keys, kind="stable")
    fin = x[order][~np.isnan(x[order])]
    assert (np.diff(fin) >= 0).all()
    assert np.isnan(x[order][-2:]).all() and keys[-1] == keys[-2]
    z = np.nonzero(x == 0)[0]
    neg = z[np.signbit(x[z])][0]
    pos = z[~np.signbit(x[z])][0]
    assert keys[neg] < keys[pos]


@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing(dtype):
    rng = np.random.default_rng(3)
    n, nseg = 4096, 1 << 12
    vals = torch.from_numpy((rng.standard_normal(n) * 1e6).astype(dtype))
    valid = torch.from_numpy(rng.random(n) > 0.1)
    # out-of-range gids (the sort path's parked dead rows) add nothing
    gid = torch.from_numpy(rng.integers(-2, nseg + 2, n).astype(np.int32))
    K.reset_launch_counts()
    for is_min in (True, False):
        a = tseg.fused_minmax(is_min, vals, valid, gid, nseg)
        b = tseg.fused_minmax_plain(is_min, vals, valid, gid, nseg)
        assert _bits_equal(a.numpy(), b.numpy())
        ok = valid.numpy() & (gid.numpy() >= 0) & (gid.numpy() < nseg)
        want = np.full(nseg, np.inf if is_min else -np.inf)
        red = np.minimum if is_min else np.maximum
        red.at(want, gid.numpy()[ok], vals.numpy()[ok].astype(np.float64))
        seen = np.zeros(nseg, bool)
        seen[gid.numpy()[ok]] = True
        assert (a.numpy()[seen].astype(np.float64) == want[seen]).all()
    assert K.launch_counts()["fused_minmax"] == 0


def test_wrapper_checks_its_inputs():
    n = 128
    v = torch.zeros(n, dtype=torch.float64)
    ok = torch.ones(n, dtype=torch.bool)
    g = torch.zeros(n, dtype=torch.int32)
    with pytest.raises(TypeError):
        tseg.fused_minmax(True, v.to(torch.float32), ok, g, 8)
    with pytest.raises(TypeError):
        tseg.fused_minmax(True, v, ok, g.to(torch.int64), 8)
    with pytest.raises(ValueError):
        tseg.fused_minmax(True, v, ok[:5], g, 8)
    with pytest.raises(ValueError):
        tseg.fused_minmax(True, v, ok, g, 0)
    with pytest.raises(TypeError):
        tsegsum.segment_minmax_64(True, v.to(torch.int32), ok, g, 8)
    meta = torch.device("meta")
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        tseg.fused_minmax(True, v.to(meta), ok.to(meta), g.to(meta), 8)


# ---------------------------------------------------------------------------
# MIN/MAX of every type through the aggregate, on each of its layouts
# ---------------------------------------------------------------------------

#: the aggregate's layouts: the no-sort key-domain path, the sort-segment
#: path (no dictionary or domain groups allowed) and the global aggregate
LAYOUTS = {"no-sort": None,
           "sort-segment": {"spark.rapids.tpu.agg.maxDictGroups": "0"},
           "global": None}


def _typed_values(type_name, n, rng):
    """(data, validity) of ``n`` seeded values of ``type_name``, a tenth
    null. FLOAT holds no NaN and no zero (the NaN rule is pinned above;
    the reference's f32 reduction orders +-0.0 by row)."""
    valid = rng.random(n) > 0.1
    if type_name == "tinyint":
        return rng.integers(-128, 128, n).astype(np.int8), valid
    if type_name == "smallint":
        return rng.integers(-2 ** 15, 2 ** 15, n).astype(np.int16), valid
    if type_name == "boolean":
        return rng.random(n) > 0.7, valid
    if type_name == "float":
        x = (rng.standard_normal(n) * 1e3).astype(np.float32)
        x[x == 0] = 1.5
        x[:2] = [np.inf, -np.inf]
        return x, valid
    if type_name == "timestamp":
        return rng.integers(-2 ** 50, 2 ** 50, n).astype(np.int64), valid
    if type_name == "decimal(15,2)":
        return rng.integers(-10 ** 15 + 1, 10 ** 15, n), valid
    if type_name == "decimal(38,6)":
        hi = rng.integers(-10 ** 18, 10 ** 18, n)
        lo = rng.integers(0, 10 ** 18, n)
        vals = np.array([int(h) * 10 ** 19 + int(v) for h, v in zip(hi, lo)],
                        dtype=object)
        # ties on the high limb with different low limbs, and signs that
        # straddle zero within one high-limb value
        vals[:6] = [2 ** 64 + 5, 2 ** 64 + 3, -(2 ** 64) - 5, -(2 ** 64) - 3,
                    7, -7]
        return vals, valid
    words = np.array(["", "a", "ab", "b", "zz", "Ab", "\u00e9t\u00e9",
                      "m"], dtype=object)
    return words[rng.integers(0, len(words), n)], valid


MINMAX_TYPES = ["tinyint", "smallint", "boolean", "float", "timestamp",
                "decimal(15,2)", "decimal(38,6)", "string"]


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("type_name", MINMAX_TYPES)
def test_minmax_of_every_type_matches_the_reference(type_name, layout):
    """MIN and MAX of BYTE, SHORT, BOOLEAN, FLOAT, TIMESTAMP, DECIMAL64,
    DECIMAL128 (two launches: the high limbs, then the tied rows' low
    limbs unsigned) and strings (sorted-dictionary codes), with nulls, an
    all-null group and a group of one row, against the reference on the
    same layout. Comparator: ``tables_differ_unordered`` (a bitwise row
    multiset)."""
    from scale_test import tables_differ_unordered
    from spark_rapids_tpu import functions as JF
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.columnar import HostColumn as JHostColumn
    from spark_rapids_tpu.columnar import HostTable as JHostTable
    from spark_rapids_tpu.plan import from_host_table as jfrom
    from spark_rapids_tpu.session import TpuSession
    from spark_rapids_tpu_torch import functions as TF
    from spark_rapids_tpu_torch.interop import host_table_from_arrays
    from spark_rapids_tpu_torch.plan import from_host_table as tfrom
    from spark_rapids_tpu_torch.session import TorchSession

    rng = np.random.default_rng(MINMAX_TYPES.index(type_name))
    n = 300
    k = rng.integers(0, 9, n).astype(np.int64)
    v, valid = _typed_values(type_name, n, rng)
    valid[k == 7] = False  # an all-null group
    k[-1], valid[-1] = 11, True  # a group of one row
    arrays = [(k, np.ones(n, bool)), (v, valid)]
    names, types = ["k", "v"], ["bigint", type_name]
    conf = LAYOUTS[layout]

    def run(frm, F, session, table):
        df = frm(table, session)
        aggs = [F.min("v").alias("lo"), F.max("v").alias("hi")]
        if layout == "global":
            return df.agg(*aggs).collect_table()
        return df.group_by("k").agg(*aggs).collect_table()

    ref = run(jfrom, JF, TpuSession(conf), JHostTable(names, [
        JHostColumn(JT.parse_type(t), d, vv)
        for t, (d, vv) in zip(types, arrays)]))
    got = run(tfrom, TF, TorchSession(conf, device="cpu"),
              host_table_from_arrays(names, types, arrays))
    got = JHostTable(got.names, [JHostColumn(JT.parse_type(
        c.dtype.simple_string()), c.data, c.validity) for c in got.columns])
    assert tables_differ_unordered(got, ref) is None, \
        tables_differ_unordered(got, ref)


def test_minmax_over_an_unsorted_dictionary_raises():
    """MIN/MAX compare dictionary codes, so a string over an unsorted
    dictionary (no ported operator makes one yet) raises instead of
    answering by code order."""
    from spark_rapids_tpu_torch import types as TT
    from spark_rapids_tpu_torch.columnar import DeviceColumn, DeviceTable
    from spark_rapids_tpu_torch.execs.aggregate import TpuHashAggregateExec
    from spark_rapids_tpu_torch.execs.base import TpuExec
    from spark_rapids_tpu_torch.ops import aggregates as tagg
    from spark_rapids_tpu_torch.ops.expr import BoundReference

    codes = torch.tensor([0, 1, 2, 1], dtype=torch.int32)
    col = DeviceColumn(TT.STRING, codes, torch.ones(4, dtype=torch.bool),
                       dictionary=np.array(["b", "a", "c"], dtype=object),
                       dict_sorted=False)

    class _One(TpuExec):
        def output_schema(self):
            return [("s", TT.STRING)]

        def execute(self):
            yield DeviceTable(["s"], [col], 4, 4, torch.device("cpu"))

    ref = BoundReference(0, TT.STRING)
    for fn in (tagg.Min(ref), tagg.Max(ref)):
        ex = TpuHashAggregateExec(_One(), [], [("m", fn)], [])
        with pytest.raises(NotImplementedError, match="unsorted dictionary"):
            list(ex.execute())
    # FIRST needs no order: it runs
    ex = TpuHashAggregateExec(_One(), [], [("f", tagg.First(ref))], [])
    out = next(ex.execute()).to_host()
    assert out.columns[0].to_pylist() == ["b"]
