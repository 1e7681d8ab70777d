"""The plans of the port's two segmented-reduction kernels, carried out with
torch ops at small sizes, against the JAX package on the same numpy inputs.

* ``onehot_partials`` (``csrc/segreduce.cu``): each block's rows ranked by
  gid in 32-row chunks (``__match_any_sync`` ranks and per-chunk counts),
  an exclusive scan of the counts in (segment, chunk) order, each column
  staged in that order, and each segment's range summed by one warp (lane
  l adds every 32nd value from l in order, then a halving shuffle tree).
  Comparator: within rtol 1e-12 (f64) of each partial's absolute mass
  against the reference's Pallas ``onehot_partials`` in interpret mode;
  f32 within the bound of two summation orders over a block,
  2 * (block - 1) * 2^-24 of the mass. NaN and +-inf stay in their own
  segment (the port's stated difference from the Pallas kernel, checked
  against the reference's block-wise ``segment_sum``), and the bits repeat.
* ``fused_minmax`` (``csrc/minmax.cu``): unsigned order-preserving keys,
  the memset identities (all-ones for MIN, zero for MAX), runs of 8 rows
  a thread folded in registers, the non-last runs flushed with a read
  before the atomic, the threads' last runs through a warp-segmented scan
  and a pending result per lane across grid-stride steps, then the
  finishing map. Comparator: bit identity (raw bytes) against the
  reference's ``segment_minmax_64`` (its split route, the Pallas kernel in
  interpret mode) and against the port's plain version.

Torch on the CPU has no unsigned 64-bit compare, so the plan compares keys
by their two 32-bit limbs and applies an atomic MIN/MAX of unsigned keys
as a signed ``scatter_reduce_`` of key ^ 2^63 (the same order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spark_rapids_tpu import kernels as jkernels
from spark_rapids_tpu.kernels import KernelsConfig
from spark_rapids_tpu.kernels import segreduce as jseg
from spark_rapids_tpu.ops import segsum as jsegsum
from spark_rapids_tpu_torch.kernels import segreduce as tseg

pytestmark = pytest.mark.kernels

# ---------------------------------------------------------------------------
# onehot_partials: rank, stage, sum
# ---------------------------------------------------------------------------

#: csrc/segreduce.cu: rows a CTA takes at most, rows of a chunk, segments
MAX_BLOCK, CHUNK, MAX_SEGMENTS = 1024, 32, 32


def _partials_ranks(gid: torch.Tensor, nseg: int, nb: int, block: int):
    """(g, pos, scan): each block's gids padded to MAX_BLOCK (-1 where the
    row adds nothing), every used row's place in the staged order, and the
    exclusive scan of the (segment, chunk) counts with the total last."""
    g = torch.full((nb, MAX_BLOCK), -1, dtype=torch.int64)
    g[:, :block] = gid.to(torch.int64).reshape(nb, block)
    g = torch.where((g >= 0) & (g < nseg), g, torch.full_like(g, -1))
    chunks = g.reshape(nb, MAX_BLOCK // CHUNK, CHUNK)
    same = chunks[..., :, None] == chunks[..., None, :]
    earlier = torch.ones(CHUNK, CHUNK, dtype=torch.bool).tril(-1)
    rank = (same & earlier).sum(-1)  # popc(peers & lanemask_lt)
    seg = torch.arange(MAX_SEGMENTS)
    cnt = (chunks[:, None, :, :] == seg[None, :, None, None]).sum(-1)
    flat = cnt.reshape(nb, -1)  # (segment, chunk) order
    scan = torch.cat([torch.zeros(nb, 1, dtype=torch.int64),
                      flat.cumsum(1)], 1)
    k = torch.arange(MAX_BLOCK // CHUNK)[None, :, None].expand_as(chunks)
    at = (chunks.clamp(min=0) * (MAX_BLOCK // CHUNK) + k).reshape(nb, -1)
    pos = torch.gather(scan, 1, at) + rank.reshape(nb, -1)
    return g, torch.where(g >= 0, pos, torch.full_like(pos, -1)), scan


def _partials_plan(x: torch.Tensor, gid: torch.Tensor, nseg: int, nb: int,
                   block: int) -> torch.Tensor:
    c = int(x.shape[1])
    g, pos, scan = _partials_ranks(gid, nseg, nb, block)
    out = torch.zeros(nb, nseg, c, dtype=x.dtype)
    for b in range(nb):
        staged = torch.zeros(MAX_BLOCK, c, dtype=x.dtype)
        used = g[b] >= 0
        rows = torch.arange(MAX_BLOCK)[used] + b * block
        staged[pos[b][used]] = x[rows]
        for s in range(nseg):
            a = int(scan[b, s * CHUNK])
            e = int(scan[b, (s + 1) * CHUNK])
            vals = staged[a:e]
            steps = -(-(e - a) // 32)
            padded = torch.zeros(steps * 32, c, dtype=x.dtype)
            padded[:e - a] = vals
            acc = torch.zeros(32, c, dtype=x.dtype)
            for m in range(steps):  # lane l: every 32nd value from l
                acc = acc + padded[m * 32:(m + 1) * 32]
            for off in (16, 8, 4, 2, 1):  # lane 0 of __shfl_down_sync
                acc = acc[:off] + acc[off:2 * off]
            out[b, s] = acc[0]
    return out


def _partials_case(kind, rng):
    if kind == "q1":  # q1's 16 padded segments, 7 f64 columns
        nb, block, nseg, c = 2, 1024, 16, 7
        gid = np.where(rng.random(nb * block) < 0.9,
                       rng.integers(0, 6, nb * block), 11)
        x = np.abs(rng.standard_normal((nb * block, c))) * 1e5
    elif kind == "nseg1":
        nb, block, nseg, c = 3, 256, 1, 3
        gid = np.zeros(nb * block, np.int64)
        x = rng.standard_normal((nb * block, c))
    elif kind == "nseg32, 9 columns":
        nb, block, nseg, c = 2, 1024, 32, 9
        gid = rng.integers(0, 32, nb * block)
        x = rng.standard_normal((nb * block, c)) * 1e3
    elif kind == "short block, gids out of range":
        nb, block, nseg, c = 3, 96, 8, 2
        gid = rng.integers(-2, 10, nb * block)
        x = rng.standard_normal((nb * block, c))
    elif kind == "edges":  # -0.0, ties (one hot segment), huge magnitudes
        nb, block, nseg, c = 2, 512, 8, 4
        gid = np.where(rng.random(nb * block) < 0.7, 5,
                       rng.integers(0, 8, nb * block))
        x = rng.standard_normal((nb * block, c)) * 1e200
        x[:, 1] = -0.0
        x[:, 2] = np.where(rng.random(nb * block) < 0.5, 1e300, -1e300)
        x[::3, 3] = 0.0
    else:
        raise ValueError(kind)
    return x, gid.astype(np.int32), nseg, nb, block


PARTIAL_KINDS = ["q1", "nseg1", "nseg32, 9 columns",
                 "short block, gids out of range", "edges"]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", PARTIAL_KINDS)
def test_partials_plan_vs_pallas(kind, dtype):
    rng = np.random.default_rng(21)
    x, gid, nseg, nb, block = _partials_case(kind, rng)
    if dtype == np.float32 and kind == "edges":
        x = np.clip(x, -1e30, 1e30)
    x = x.astype(dtype)
    ref = np.asarray(jseg.onehot_partials(jnp.asarray(x), jnp.asarray(gid),
                                          nseg, nb, block))
    got = _partials_plan(torch.from_numpy(x), torch.from_numpy(gid), nseg,
                         nb, block).numpy()
    assert got.shape == ref.shape == (nb, nseg, x.shape[1])
    rtol = 1e-12 if dtype == np.float64 else 2 * (block - 1) * 2.0 ** -24
    mass = np.zeros(ref.shape, dtype=np.float64)
    blk = np.arange(nb * block) // block
    ok = (gid >= 0) & (gid < nseg)
    np.add.at(mass, (blk[ok], gid[ok]), np.abs(x[ok].astype(np.float64)))
    err = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    assert (err <= rtol * mass).all(), float(
        (err / np.maximum(mass, 1e-300)).max())


@pytest.mark.parametrize("kind", PARTIAL_KINDS)
def test_partials_ranks_are_a_stable_sort_by_gid(kind):
    """Every used row's place is its place in a stable sort of the block by
    gid, and each segment's range holds exactly its rows."""
    rng = np.random.default_rng(22)
    _, gid, nseg, nb, block = _partials_case(kind, rng)
    g, pos, scan = _partials_ranks(torch.from_numpy(gid), nseg, nb, block)
    for b in range(nb):
        used = torch.nonzero(g[b] >= 0).flatten()
        order = used[torch.sort(g[b][used], stable=True).indices]
        want = torch.empty_like(pos[b])
        want[order] = torch.arange(order.numel())
        assert torch.equal(pos[b][used], want[used])
        for s in range(nseg):
            a, e = int(scan[b, s * CHUNK]), int(scan[b, (s + 1) * CHUNK])
            assert (g[b][order[a:e]] == s).all()
            assert e - a == int((g[b] == s).sum())


def test_partials_plan_keeps_nonfinite_in_their_segment_and_repeats():
    rng = np.random.default_rng(23)
    nb, block, nseg = 2, 1024, 8
    n = nb * block
    x = rng.standard_normal((n, 3))
    x[3, 0], x[1200, 1], x[7, 2], x[8, 2] = np.nan, np.inf, np.inf, -np.inf
    x[9, 1] = -np.inf
    gid = rng.integers(0, nseg, n).astype(np.int32)
    ids = (np.arange(n) // block) * nseg + gid
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(x), jnp.asarray(ids),
                                         num_segments=nb * nseg))
    ref = ref.reshape(nb, nseg, 3)
    got = _partials_plan(torch.from_numpy(x), torch.from_numpy(gid), nseg,
                         nb, block).numpy()
    again = _partials_plan(torch.from_numpy(x), torch.from_numpy(gid), nseg,
                           nb, block).numpy()
    assert got.tobytes() == again.tobytes()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0, equal_nan=True)
    assert np.isnan(got[0, gid[3], 0]) and np.isfinite(
        np.delete(got[0, :, 0], gid[3])).all()
    assert got[1, gid[1200], 1] == np.inf
    if gid[7] != gid[8]:
        assert got[0, gid[7], 2] == np.inf and got[0, gid[8], 2] == -np.inf


# ---------------------------------------------------------------------------
# fused_minmax: keys, runs, identities, finishing map
# ---------------------------------------------------------------------------

#: csrc/minmax.cu: rows a thread takes at once, threads a CTA
RUN, THREADS = 8, 256
SIGN = -(1 << 63)
MAG = (1 << 63) - 1
INF_BITS, NEG_INF_BITS = 0x7FF0_0000_0000_0000, 0xFFF0_0000_0000_0000 - (1 << 64)
NAN_KEY = 0xFFF8_0000_0000_0000 - (1 << 64)  # the canonical NaN's key


def _keys(values: torch.Tensor) -> torch.Tensor:
    """The unsigned keys' bits (int64 holding the 64 bits)."""
    if values.dtype == torch.int64:
        return values ^ SIGN
    b = values.view(torch.int64)
    keys = torch.where(b < 0, ~b, b ^ SIGN)
    return torch.where((b & MAG) > INF_BITS,
                       torch.full_like(b, NAN_KEY), keys)


def _finish(u: torch.Tensor, is_min: bool, f64: bool) -> torch.Tensor:
    if not f64:
        return u ^ SIGN
    bits = torch.where(u < 0, u ^ SIGN, ~u)  # top bit set: u ^ 2^63
    if is_min:
        bits = torch.where(u == -1, torch.full_like(u, INF_BITS), bits)
    else:
        bits = torch.where(u == 0, torch.full_like(u, NEG_INF_BITS), bits)
    return bits.view(torch.float64)


def _ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b as unsigned 64-bit numbers, by their 32-bit limbs."""
    ah, bh = (a >> 32) & 0xFFFF_FFFF, (b >> 32) & 0xFFFF_FFFF
    al, bl = a & 0xFFFF_FFFF, b & 0xFFFF_FFFF
    return (ah < bh) | ((ah == bh) & (al < bl))


def _pick(a, b, is_min):
    better = _ult(b, a) if is_min else _ult(a, b)
    return torch.where(better, b, a)


def _atomic(out, g, k, is_min):
    """atomicMin/atomicMax of unsigned keys at out[g], with the read that
    skips a key which cannot improve what it read."""
    use = g >= 0
    g, k = g[use], k[use]
    cur = out[g]
    improves = _ult(k, cur) if is_min else _ult(cur, k)
    g, k = g[improves], k[improves]
    signed = out ^ SIGN
    signed.scatter_reduce_(0, g, k ^ SIGN, "amin" if is_min else "amax",
                           include_self=True)
    out.copy_(signed ^ SIGN)


def _minmax_plan(is_min, values, valid, gid, nseg, max_blocks=132 * 8):
    f64 = values.dtype == torch.float64
    n = int(values.shape[0])
    out = torch.full((nseg,), -1 if is_min else 0, dtype=torch.int64)
    grid = max(1, min(max_blocks, -(-n // (THREADS * RUN))))
    nthreads = grid * THREADS
    keys = _keys(values)
    g_all = gid.to(torch.int64)
    g_all = torch.where(valid & (g_all >= 0) & (g_all < nseg), g_all,
                        torch.full_like(g_all, -1))
    pend_g = torch.full((nthreads,), -1, dtype=torch.int64)
    pend = torch.zeros(nthreads, dtype=torch.int64)
    lane = torch.arange(nthreads) % 32
    stride = nthreads * RUN
    for base in range(0, max(n, 1), stride):
        rows = base + torch.arange(nthreads * RUN)
        inside = rows < n
        g = torch.where(inside, g_all[rows.clamp(max=max(n - 1, 0))]
                        if n else torch.full_like(rows, -1),
                        torch.full_like(rows, -1)).reshape(nthreads, RUN)
        k = torch.where(inside, keys[rows.clamp(max=max(n - 1, 0))]
                        if n else torch.zeros_like(rows),
                        torch.zeros_like(rows)).reshape(nthreads, RUN)
        last_g = torch.full((nthreads,), -1, dtype=torch.int64)
        last = torch.zeros(nthreads, dtype=torch.int64)
        for i in range(RUN):  # fold forward
            used = g[:, i] >= 0
            same = used & (g[:, i] == last_g)
            k[:, i] = torch.where(same, _pick(k[:, i], last, is_min), k[:, i])
            last_g = torch.where(used, g[:, i], last_g)
            last = torch.where(used, k[:, i], last)
        next_g = torch.full((nthreads,), -1, dtype=torch.int64)
        flush = torch.zeros_like(g, dtype=torch.bool)
        for i in range(RUN - 1, -1, -1):  # ends of runs but the last
            used = g[:, i] >= 0
            flush[:, i] = used & (next_g >= 0) & (next_g != g[:, i])
            next_g = torch.where(used, g[:, i], next_g)
        _atomic(out, torch.where(flush, g, torch.full_like(g, -1)).flatten(),
                k.flatten(), is_min)
        lg, lk = last_g.reshape(-1, 32), last.reshape(-1, 32)
        for off in (1, 2, 4, 8, 16):  # __shfl_up_sync, all lanes at once
            go = torch.cat([torch.full_like(lg[:, :off], -2), lg[:, :-off]], 1)
            ko = torch.cat([lk[:, :off], lk[:, :-off]], 1)
            lk = torch.where(go == lg, _pick(lk, ko, is_min), lk)
        g_next = torch.cat([lg[:, 1:], torch.full_like(lg[:, :1], -2)], 1)
        last_g, last = lg.flatten(), lk.flatten()
        g_next = g_next.flatten()
        ends = (last_g >= 0) & ((lane == 31) | (g_next != last_g))
        merge = ends & (last_g == pend_g)
        pend = torch.where(merge, _pick(pend, last, is_min), pend)
        moved = ends & ~merge
        _atomic(out, torch.where(moved, pend_g, torch.full_like(pend_g, -1)),
                pend, is_min)
        pend_g = torch.where(moved, last_g, pend_g)
        pend = torch.where(moved, last, pend)
    _atomic(out, pend_g, pend, is_min)
    return _finish(out, is_min, f64)


def _reference(is_min, vals, valid, gid, nseg):
    """The JAX package's segment_minmax_64 with its Pallas kernel forced
    on (interpret mode on the CPU)."""
    tok = jkernels.KERNELS_ENABLED.set(KernelsConfig(enabled=("segreduce",)))
    try:
        out = jsegsum.segment_minmax_64(
            is_min, jnp.asarray(vals), jnp.asarray(valid),
            jnp.asarray(gid, jnp.int32), nseg)
        return np.asarray(out)
    finally:
        jkernels.KERNELS_ENABLED.reset(tok)


@pytest.fixture(autouse=True)
def _clean_kernel_state():
    jkernels.reset()
    yield
    jkernels.reset()


NSEG = 24
NAN2 = np.array([0x7FF8000000000001, 0xFFF8000000000000],
                dtype=np.uint64).view(np.float64)


def _minmax_case(n, dtype, rng):
    """n rows: gids in runs of 1-40 rows (so runs of 8 rows a thread cross
    segment boundaries and hold several runs), about 80% valid, some rows
    out of range; from row 0 (where n allows) the edge segments: 18
    all-NaN, 19 all-null, 20 (-0.0, 0.0), 21 (0.0, -0.0), 22 a part-valid
    run holding NaN (for int64: the INT64 extremes), 23 one valid row."""
    lengths = rng.integers(1, 41, n)
    gid = np.repeat(rng.integers(0, 18, n), lengths)[:n]
    gid[rng.random(n) < 0.02] = rng.choice([-1, NSEG + 5, NSEG + 9])
    valid = rng.random(n) < 0.8
    if dtype == np.int64:
        x = rng.integers(-(2 ** 62), 2 ** 62, n).astype(np.int64)
        x[rng.random(n) < 0.05] = 2 ** 63 - 1
        x[rng.random(n) < 0.05] = -(2 ** 63)
    else:
        x = rng.standard_normal(n) * 1e18
        u = rng.random(n)
        x[u < 0.03] = np.nan
        x[(u >= 0.03) & (u < 0.06)] = -0.0
        x[(u >= 0.06) & (u < 0.09)] = 0.0
        x[(u >= 0.09) & (u < 0.1)] = np.inf
        x[(u >= 0.1) & (u < 0.11)] = -np.inf
    edges = []
    if dtype == np.float64:
        edges += [(18, [np.nan, NAN2[0], NAN2[1]], [1, 1, 1]),
                  (20, [-0.0, 0.0], [1, 1]), (21, [0.0, -0.0], [1, 1]),
                  (22, [1.0, np.nan, -5.0, NAN2[1], 7.0], [0, 1, 1, 0, 1])]
    else:
        edges += [(22, [2 ** 63 - 1, -(2 ** 63), 0, -1, 5], [1, 1, 0, 1, 1])]
    edges += [(19, [1, 2, 3], [0, 0, 0]), (23, [42], [1])]
    at = 0
    for s, vals, ok in edges:
        m = len(vals)
        if at + m > n:
            break
        x[at:at + m] = np.array(vals, dtype=dtype)
        gid[at:at + m] = s
        valid[at:at + m] = np.array(ok, bool)
        at += m
    return x, valid, gid.astype(np.int32)


@pytest.mark.parametrize("n", [1, 3, 17, 4097])
@pytest.mark.parametrize("dtype", [np.int64, np.float64])
@pytest.mark.parametrize("is_min", [True, False], ids=["min", "max"])
def test_minmax_plan_bit_identical_to_reference(n, dtype, is_min):
    rng = np.random.default_rng(31 + n)
    x, valid, gid = _minmax_case(n, dtype, rng)
    ref = _reference(is_min, x, valid, gid, NSEG)
    got = _minmax_plan(is_min, torch.from_numpy(x), torch.from_numpy(valid),
                       torch.from_numpy(gid), NSEG).numpy()
    assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes(), (
        got, ref)


@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_minmax_plan_edge_segments(dtype):
    """What the bits mean at the edge segments: canonical NaN, -0.0 < 0.0,
    the identities of an all-null or empty segment."""
    rng = np.random.default_rng(33)
    x, valid, gid = _minmax_case(512, dtype, rng)
    args = (torch.from_numpy(x), torch.from_numpy(valid),
            torch.from_numpy(gid), NSEG + 2)
    lo = _minmax_plan(True, *args).numpy()
    hi = _minmax_plan(False, *args).numpy()
    if dtype == np.float64:
        assert lo.view(np.uint64)[18] == hi.view(np.uint64)[18] == \
            0x7FF8000000000000
        assert lo.view(np.uint64)[20] == lo.view(np.uint64)[21] == \
            0x8000000000000000
        assert hi.view(np.uint64)[20] == hi.view(np.uint64)[21] == 0
        assert lo[22] == -5.0 and hi.view(np.uint64)[22] == \
            0x7FF8000000000000
        for s in (19, NSEG, NSEG + 1):
            assert lo[s] == np.inf and hi[s] == -np.inf
    else:
        assert lo[22] == -(2 ** 63) and hi[22] == 2 ** 63 - 1
        for s in (19, NSEG, NSEG + 1):
            assert lo[s] == 2 ** 63 - 1 and hi[s] == -(2 ** 63)
    assert lo[23] == hi[23] == 42


@pytest.mark.parametrize("max_blocks", [1, 3])
@pytest.mark.parametrize("layout", ["sorted", "one segment", "random"])
def test_minmax_plan_across_grid_steps_matches_the_plain_version(
        layout, max_blocks):
    """A grid smaller than the rows: each lane carries its pending result
    across grid-stride steps (a global aggregate, sorted gids)."""
    rng = np.random.default_rng(34)
    n, nseg = 3 * THREADS * RUN + 77, 5000
    if layout == "sorted":
        gid = np.sort(rng.integers(0, nseg, n))
    elif layout == "one segment":
        gid = np.zeros(n, np.int64)
    else:
        gid = rng.integers(0, nseg, n)
    x = torch.from_numpy(rng.standard_normal(n) * 1e6)
    x[rng.random(n) < 0.01] = float("nan")
    valid = torch.from_numpy(rng.random(n) < 0.5)
    g = torch.from_numpy(gid.astype(np.int32))
    for is_min in (True, False):
        got = _minmax_plan(is_min, x, valid, g, nseg, max_blocks=max_blocks)
        want = tseg.fused_minmax_plain(is_min, x, valid, g, nseg)
        assert got.view(torch.int64).equal(want.view(torch.int64))
