"""The port's primitive dispatch points against the JAX package's own, at
the reference's CPU defaults (split sums off, Pallas kernels off), on the
same numpy inputs.

Tolerances: compact_pairs and lex_sort are bit-identical.
batched_segment_sum_f64 agrees within rtol 1e-12 of each sum's absolute
mass: the reference adds rows in order (jax.ops.segment_sum), the port
adds 1024-row block partials."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu.ops import ordering as jord
from spark_rapids_tpu.ops import scatter32 as jscatter
from spark_rapids_tpu.ops import segsum as jsegsum
from spark_rapids_tpu_torch.ops import ordering as tord
from spark_rapids_tpu_torch.ops import scatter32 as tscatter
from spark_rapids_tpu_torch.ops import segsum as tsegsum


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    return t.numpy()


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


@pytest.mark.parametrize("capacity,nseg,m", [(4096, 16, 7), (128, 32, 2),
                                             (2048, 8, 1), (1024, 1, 3)])
def test_batched_segment_sum_f64_vs_reference(capacity, nseg, m):
    rng = np.random.default_rng(41)
    gid = rng.integers(0, nseg, capacity).astype(np.int32)
    cols = [rng.standard_normal(capacity) * 10.0 ** rng.integers(0, 6)
            for _ in range(m)]
    for c in cols:
        c[rng.random(capacity) < 0.3] = 0.0  # invalid slots are zeroed
    ref = np.asarray(jsegsum.batched_segment_sum_f64(
        [jnp.asarray(c) for c in cols], jnp.asarray(gid), nseg, capacity,
        use_split=False))
    got = tsegsum.batched_segment_sum_f64(
        [torch.from_numpy(c) for c in cols], torch.from_numpy(gid), nseg,
        capacity).numpy()
    assert got.shape == ref.shape == (nseg, m) and got.dtype == np.float64
    mass = np.zeros((nseg, m))
    for j, c in enumerate(cols):
        np.add.at(mass[:, j], gid, np.abs(c))
    assert (np.abs(got - ref) <= 1e-12 * mass).all()


def test_batched_segment_sum_over_32_segments_is_not_ported():
    """Over 32 segments the sums are one index_add_ (the reference's CPU
    segment_sum), which adds rows in order on the CPU: bit-identical to
    the reference (the name dates from the slice that refused this)."""
    rng = np.random.default_rng(43)
    capacity, nseg = 4096, 3000
    gid = rng.integers(0, nseg, capacity).astype(np.int32)
    cols = [rng.standard_normal(capacity) * 1e6 for _ in range(3)]
    ref = np.asarray(jsegsum.batched_segment_sum_f64(
        [jnp.asarray(c) for c in cols], jnp.asarray(gid), nseg, capacity,
        use_split=False))
    got = tsegsum.batched_segment_sum_f64(
        [torch.from_numpy(c) for c in cols], torch.from_numpy(gid), nseg,
        capacity).numpy()
    assert _bits_equal(got, ref)


@pytest.mark.parametrize("mask", ["random", "all_kept", "all_dropped"])
def test_compact_pairs_vs_reference(mask):
    rng = np.random.default_rng(42)
    n = 512
    f64 = rng.standard_normal(n)
    f64[:4] = [np.nan, -0.0, np.inf, -np.inf]
    datas = [f64, rng.integers(-(2 ** 62), 2 ** 62, n).astype(np.int64),
             rng.integers(0, 5, n).astype(np.int32), rng.random(n) > 0.5]
    valids = [rng.random(n) > 0.1 for _ in datas]
    keep = {"random": rng.random(n) > 0.4, "all_kept": np.ones(n, bool),
            "all_dropped": np.zeros(n, bool)}[mask]
    ref, ref_n = jscatter.compact_pairs(
        [jnp.asarray(d) for d in datas], [jnp.asarray(v) for v in valids],
        jnp.asarray(keep), n)
    got, got_n = tscatter.compact_pairs(
        [torch.from_numpy(d) for d in datas],
        [torch.from_numpy(v) for v in valids], torch.from_numpy(keep), n)
    assert got_n.dtype == torch.int32 and int(got_n) == int(ref_n)
    for (rd, rv), (gd, gv) in zip(ref, got):
        assert _bits_equal(rd, _np(gd)) and _bits_equal(rv, _np(gv))


@pytest.mark.parametrize("n", [16, 256])
def test_lex_sort_vs_reference(n):
    """Operands built by each package's own comparable_operands /
    descending_operands from the same keys: i64 and f64 (NaN, -0.0, +-inf,
    ties) ascending and descending, bool, int32 with ties."""
    rng = np.random.default_rng(43)
    f64 = rng.choice([np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5, -2.25], n)
    i64 = rng.choice([2 ** 63 - 1, -(2 ** 63), 0, -1, 2 ** 40], n)
    boo = rng.random(n) > 0.5
    dup = rng.integers(0, 3, n).astype(np.int32)

    def operands(mod, conv):
        return ([conv(dup)] + mod.comparable_operands(conv(boo))
                + mod.comparable_operands(conv(i64))
                + mod.descending_operands(mod.comparable_operands(conv(f64)))
                + mod.comparable_operands(conv(f64)))

    jops = operands(jord, jnp.asarray)
    tops = operands(tord, torch.from_numpy)
    assert len(jops) == len(tops)
    for a, b in zip(jops, tops):
        assert _bits_equal(a, _np(b))
    ref = jord.lex_sort(jops, jnp.arange(n, dtype=jnp.int32))
    got = tord.lex_sort(tops, torch.arange(n, dtype=torch.int32))
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert _bits_equal(r, _np(g))
