"""The plain versions of the port's three kernels against the JAX package's
Pallas kernels themselves, run in interpret mode on the CPU backend as
tests/test_kernels.py runs them, on the same numpy inputs.

Tolerances: compaction and sort are bit-identical. Partial sums agree
within rtol 1e-12 (f64) and 1e-6 (f32): the Pallas kernel contracts a
one-hot on the matrix unit, the plain version adds rows in order.

One stated difference: a NaN or inf input times a 0 in the one-hot puts
NaN into EVERY segment of its block in the Pallas kernel, while the port's
kernel (like the engine's own CPU sum, jax.ops.segment_sum) keeps it in
its own segment. Non-finite inputs are therefore checked against the JAX
package's block-wise segment_sum."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spark_rapids_tpu.kernels import compact as jcompact
from spark_rapids_tpu.kernels import segreduce as jseg
from spark_rapids_tpu.kernels import sort as jsort
from spark_rapids_tpu.ops import ordering as jord
from spark_rapids_tpu_torch import kernels as K
from spark_rapids_tpu_torch.kernels import compact as tcompact
from spark_rapids_tpu_torch.kernels import segreduce as tseg
from spark_rapids_tpu_torch.kernels import sort as tsort

pytestmark = pytest.mark.kernels


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    return t.numpy()


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# segreduce.onehot_partials
# ---------------------------------------------------------------------------

def _partials_case(kind, rng):
    nb, block = 4, 128
    n = nb * block
    if kind == "q1":  # q1's 16 padded segments, 7 f64 columns
        nseg, c = 16, 7
        gid = rng.integers(0, 12, n)
        x = np.abs(rng.standard_normal((n, c))) * 1e5
    elif kind == "nseg1":
        nseg, c = 1, 3
        gid = np.zeros(n, np.int64)
        x = rng.standard_normal((n, c))
    elif kind == "nseg32":
        nseg, c = 32, 9  # two column chunks in the CUDA kernel
        gid = rng.integers(0, 32, n)
        x = rng.standard_normal((n, c)) * 1e3
    elif kind == "edges":  # -0.0, ties (one hot segment), huge magnitudes
        nseg, c = 8, 4
        gid = np.where(rng.random(n) < 0.7, 5, rng.integers(0, 8, n))
        x = rng.standard_normal((n, c)) * 1e200
        x[:, 1] = -0.0
        x[:, 2] = np.where(rng.random(n) < 0.5, 1e300, -1e300)
        x[::3, 3] = 0.0
    else:
        raise ValueError(kind)
    return x, gid.astype(np.int32), nseg, nb, block


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["q1", "nseg1", "nseg32", "edges"])
def test_onehot_partials_plain_vs_pallas(kind, dtype):
    rng = np.random.default_rng(11)
    x, gid, nseg, nb, block = _partials_case(kind, rng)
    if dtype == np.float32 and kind == "edges":
        x = np.clip(x, -1e30, 1e30)
    x = x.astype(dtype)
    ref = np.asarray(jseg.onehot_partials(jnp.asarray(x), jnp.asarray(gid),
                                          nseg, nb, block))
    got = tseg.onehot_partials_plain(torch.from_numpy(x),
                                     torch.from_numpy(gid), nseg, nb, block)
    assert got.dtype == torch.from_numpy(x).dtype
    assert tuple(got.shape) == ref.shape == (nb, nseg, x.shape[1])
    rtol = 1e-12 if dtype == np.float64 else 1e-6
    # rtol on the absolute mass of each partial: cancelling sums compare
    # against the size of what was added, not the tiny remainder
    mass = np.zeros_like(ref, dtype=np.float64)
    blk = np.arange(nb * block) // block
    np.add.at(mass, (blk, gid), np.abs(x.astype(np.float64)))
    err = np.abs(got.numpy().astype(np.float64) - ref.astype(np.float64))
    assert (err <= rtol * mass).all(), float((err / np.maximum(mass, 1e-300)).max())


def test_onehot_partials_nonfinite_against_blockwise_segment_sum():
    rng = np.random.default_rng(12)
    nb, block, nseg = 2, 128, 8
    n = nb * block
    x = rng.standard_normal((n, 3))
    x[3, 0], x[200, 1], x[7, 2], x[8, 2] = np.nan, np.inf, np.inf, -np.inf
    gid = rng.integers(0, nseg, n).astype(np.int32)
    ids = (np.arange(n) // block) * nseg + gid
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(x), jnp.asarray(ids),
                                         num_segments=nb * nseg))
    ref = ref.reshape(nb, nseg, 3)
    got = tseg.onehot_partials_plain(torch.from_numpy(x),
                                     torch.from_numpy(gid), nseg, nb,
                                     block).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0, equal_nan=True)
    # the NaN stays in its own segment
    assert np.isnan(got[0, gid[3], 0]) and np.isfinite(
        np.delete(got[0, :, 0], gid[3])).all()


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    rng = np.random.default_rng(13)
    x, gid, nseg, nb, block = _partials_case("q1", rng)
    K.reset_launch_counts()
    a = tseg.onehot_partials(torch.from_numpy(x), torch.from_numpy(gid),
                             nseg, nb, block)
    b = tseg.onehot_partials_plain(torch.from_numpy(x),
                                   torch.from_numpy(gid), nseg, nb, block)
    assert torch.equal(a, b)
    assert K.launch_counts() == {"onehot_partials": 0, "fused_minmax": 0,
                                 "gather_compact": 0,
                                 "sort_with_payload": 0, "probe_rowids": 0}


# ---------------------------------------------------------------------------
# compact.gather_compact
# ---------------------------------------------------------------------------

def _columns(n, rng):
    i64 = rng.integers(-(2 ** 62), 2 ** 62, n).astype(np.int64)
    i64[:4] = [2 ** 63 - 1, -(2 ** 63), 0, -1]
    f64 = rng.standard_normal(n) * 1e18
    f64[:6] = [np.nan, -0.0, 0.0, np.inf, -np.inf, 5e-324]
    return [rng.integers(0, 3, n).astype(np.int32),   # dictionary codes
            f64, i64, rng.random(n) > 0.5]


@pytest.mark.parametrize("mask", ["random", "all_kept", "all_dropped",
                                  "q1_groups"])
def test_gather_compact_plain_vs_pallas(mask):
    rng = np.random.default_rng(21)
    n = 16 if mask == "q1_groups" else 256
    datas = _columns(n, rng)
    valids = [rng.random(n) > 0.2 for _ in datas]
    keep = {"random": rng.random(n) > 0.5, "all_kept": np.ones(n, bool),
            "all_dropped": np.zeros(n, bool),
            "q1_groups": np.isin(np.arange(n), [0, 1, 4, 5, 8, 9])}[mask]
    pos = (np.cumsum(keep.astype(np.int32)) - 1).astype(np.int32)
    new_n = np.int32(keep.sum())
    ref = jcompact.gather_compact(
        [jnp.asarray(d) for d in datas], [jnp.asarray(v) for v in valids],
        jnp.asarray(keep), jnp.asarray(pos), jnp.asarray(new_n), n)
    got = tcompact.gather_compact_plain(
        [torch.from_numpy(d) for d in datas],
        [torch.from_numpy(v) for v in valids], torch.from_numpy(keep),
        torch.from_numpy(pos), torch.tensor(new_n, dtype=torch.int32), n)
    for (rd, rv), (gd, gv) in zip(ref, got):
        assert _bits_equal(rd, _np(gd))
        assert _bits_equal(rv, _np(gv))


# ---------------------------------------------------------------------------
# sort.sort_with_payload
# ---------------------------------------------------------------------------

def _sort_operands(n, rng, kind):
    if kind == "q1":
        # live flag + 2 x (null flag, dictionary code), ties everywhere
        live = (np.arange(n) >= 6).astype(np.int32)
        return [live, np.zeros(n, np.int32),
                rng.integers(0, 3, n).astype(np.int32),
                (rng.random(n) < 0.1).astype(np.int32),
                rng.integers(0, 2, n).astype(np.int32)]
    edge = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, np.nan])
    f64 = rng.standard_normal(n)
    f64[:min(n, 6)] = edge[:min(n, 6)]
    f64[6:12] = f64[:len(f64[6:12])]  # ties across the edge values
    words = [np.array(o) for o in jord.comparable_operands(
        jnp.asarray(f64))]
    desc = [np.array(o) for o in jord.descending_operands(
        jord.comparable_operands(jnp.asarray(f64)))]
    return ([rng.integers(0, 3, n).astype(np.int32)] + words
            + [rng.integers(-2, 2, n).astype(np.int32)] + desc)


@pytest.mark.parametrize("n,kind", [(2, "edges"), (16, "q1"),
                                    (64, "edges")])
def test_sort_with_payload_plain_vs_pallas(n, kind):
    rng = np.random.default_rng(31)
    ops = _sort_operands(n, rng, kind)
    payload = np.arange(n, dtype=np.int32)
    ref = jsort.sort_with_payload([jnp.asarray(o) for o in ops],
                                  jnp.asarray(payload))
    got = tsort.sort_with_payload_plain(
        [torch.from_numpy(o) for o in ops], torch.from_numpy(payload))
    assert len(ref) == len(got) == len(ops) + 1
    for r, g in zip(ref, got):
        assert _bits_equal(r, _np(g))


def test_sort_rejects_non_power_of_two():
    with pytest.raises(ValueError, match="power of two"):
        tsort.sort_with_payload([torch.zeros(384, dtype=torch.int32)],
                                torch.arange(384, dtype=torch.int32))
