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
        nseg, c = 32, 9  # nine columns: nine staging passes in the CUDA kernel
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
                                 "sort_with_payload": 0, "probe_rowids": 0,
                                 "dec128_divide": 0}


def test_record_clones_each_launch_only_while_calls_is_a_list():
    """``kernels.record`` (which every wrapper calls after a launch) keeps
    nothing while ``kernels.calls`` is None, and otherwise appends the
    launch with every tensor cloned, nested lists and tuples kept."""
    x = torch.arange(4, dtype=torch.float64)
    assert K.calls is None
    K.record("onehot_partials", (x, [x, 3]), (x, x))
    K.calls = []
    try:
        K.record("onehot_partials", (x, [x, 3]), (x, x))
        calls = K.calls
    finally:
        K.calls = None
    [(name, (a, (b, n)), (c, d))] = calls
    x += 1
    assert name == "onehot_partials" and n == 3
    assert isinstance(calls[0][1][1], list) and isinstance(calls[0][2], tuple)
    for t in (a, b, c, d):
        assert torch.equal(t, torch.arange(4, dtype=torch.float64))


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


def _reference_compact(datas, valids, keep):
    """The reference's Pallas gather_compact (interpret mode) with the
    positions and count its caller computes."""
    n = keep.shape[0]
    pos = (np.cumsum(keep.astype(np.int32)) - 1).astype(np.int32)
    new_n = np.int32(keep.sum())
    ref = jcompact.gather_compact(
        [jnp.asarray(d) for d in datas], [jnp.asarray(v) for v in valids],
        jnp.asarray(keep), jnp.asarray(pos), jnp.asarray(new_n), n)
    return ref, new_n


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
    ref, new_n = _reference_compact(datas, valids, keep)
    got, got_n = tcompact.gather_compact_plain(
        [torch.from_numpy(d) for d in datas],
        [torch.from_numpy(v) for v in valids], torch.from_numpy(keep), n)
    assert got_n.dtype == torch.int32 and int(got_n) == int(new_n)
    for (rd, rv), (gd, gv) in zip(ref, got):
        assert _bits_equal(rd, _np(gd))
        assert _bits_equal(rv, _np(gv))


# The one-pass kernel (csrc/compact.cu), carried out with torch ops: the
# same tiles, warp layout, ballot ranks, look-back, head/tail positions and
# stream groups. The CUDA kernel itself runs only on the card
# (chip_smoke.py holds it against gather_compact_plain there).

_WARPS = 8
_ITEMS = tcompact.TILE_ROWS // (_WARPS * 32)
_PREFIX = 1 << 31


def _tile_ranks(keep_tile: torch.Tensor):
    """Per row of one tile (tile order) the kernel's rank: kept rows before
    it in the tile, from each warp's 32-lane ballots (warp w, item j, lane
    l holds row 512 w + 32 j + l), the warp's running count over its items
    and the counts of the warps before it. Returns (ranks, tile count)."""
    rows = torch.zeros(tcompact.TILE_ROWS, dtype=torch.bool)
    rows[:keep_tile.shape[0]] = keep_tile
    k = rows.view(_WARPS, _ITEMS, 32).to(torch.int64)
    lanes = torch.arange(32)
    # the ballot's bits, and popc(m & lanemask_lt) per lane
    ballot = (k << lanes).sum(-1)
    lt = (1 << lanes) - 1
    below = torch.stack([torch.tensor([bin(int(m) & int(b)).count("1")
                                       for b in lt])
                         for m in ballot.flatten()]).view(_WARPS, _ITEMS, 32)
    popc = k.sum(-1)
    item_excl = torch.cumsum(popc, 1) - popc
    warp_counts = popc.sum(1)
    warp_excl = torch.cumsum(warp_counts, 0) - warp_counts
    rank = below + item_excl[:, :, None] + warp_excl[:, None, None]
    return rank.flatten()[:keep_tile.shape[0]], int(warp_counts.sum())


def _look_back(counts, rng):
    """Each tile's exclusive offset as the kernel's warp 0 finds it:
    tiles publish their count (an aggregate) and later their inclusive
    prefix; a tile reads the 32 words before it at once and adds counts
    back to the nearest prefix. A random number of the nearest
    predecessors still show only their aggregate (the others have
    finished), as when tiles run at once."""
    offsets = []
    for tile in range(len(counts)):
        lag = int(rng.integers(0, 70))
        # (inclusive prefix, flag) of a finished tile, (count, no flag)
        # of one that has only published its aggregate
        words = [(offsets[p] + counts[p], True) if p < tile - lag
                 else (counts[p], False) for p in range(tile)]
        excl, j = 0, tile - 1
        while tile > 0:
            window = [words[j - lane] if j - lane >= 0 else (0, True)
                      for lane in range(32)]
            prefix = [w[1] for w in window]
            nearest = prefix.index(True) if any(prefix) else 31
            excl += sum(w[0] for w in window[:nearest + 1])
            if any(prefix):
                break
            j -= 32
        offsets.append(excl)
    return offsets


def _stream_groups(first_n, tiles, resident_ctas=132 * 3):
    """csrc/compact.cu's CTAs per tile (groups) and streams per group:
    enough CTAs to fill the card's resident ones when tiles are few, each
    group with at least one stream."""
    groups = min(-(-resident_ctas // tiles), first_n)
    per = -(-first_n // groups) if groups > 1 else max(first_n, 1)
    return (-(-first_n // per) if first_n else 1), per


def _one_pass_compact(datas, valids, keep, capacity, max_streams, rng,
                      resident_ctas):
    """The kernel's plan with torch ops: per tile the ballot ranks, the
    look-back offset, kept rows to [offset, offset + kept) and zeros to
    [capacity - dropped_incl, capacity - dropped_excl); the first
    ``max_streams`` streams written by the tiles' CTAs, one group of
    streams each (every CTA of a tile ranks it and looks back on its
    own), the rest gathered through the gather map the first launch
    writes. Returns (outputs, new_n, every slot's writer count)."""
    tile_rows = tcompact.TILE_ROWS
    tiles = max(1, -(-capacity // tile_rows))
    streams = list(datas) + list(valids)
    first = streams[:max_streams]
    groups, per = _stream_groups(len(first), tiles, resident_ctas)
    assert groups * per >= len(first) > (groups - 1) * per or not first
    outs = [torch.empty_like(s) for s in streams]
    written = torch.zeros(capacity, dtype=torch.int64)
    sel = torch.empty(capacity, dtype=torch.int64)
    for g in range(groups):
        ranks, counts = [], []
        for t in range(tiles):
            r, c = _tile_ranks(keep[t * tile_rows:(t + 1) * tile_rows])
            ranks.append(r)
            counts.append(c)
        offsets = _look_back(counts, rng)
        for t in range(tiles):
            base = t * tile_rows
            k = keep[base:base + tile_rows]
            pos = torch.arange(k.shape[0])
            head = offsets[t]
            dropped_incl = base - head + (k.shape[0] - counts[t])
            tail = capacity - dropped_incl
            at = torch.where(k, head + ranks[t], tail + (pos - ranks[t]))
            if g == 0:  # the publishing CTA writes the gather map
                written.index_add_(0, at, torch.ones_like(at))
                sel[at[k]] = base + pos[k]
            for s, o in zip(first[g * per:(g + 1) * per],
                            outs[g * per:(g + 1) * per]):
                o[at] = torch.where(k, s[base:base + tile_rows],
                                    torch.zeros((), dtype=s.dtype))
    new_n = offsets[-1] + counts[-1]
    live = torch.arange(capacity) < new_n
    for s, o in zip(streams[max_streams:], outs[max_streams:]):
        g = s[torch.where(live, sel, 0)]
        o.copy_(torch.where(live, g, torch.zeros((), dtype=s.dtype)))
    n = len(datas)
    return list(zip(outs[:n], outs[n:])), new_n, written


_K = tcompact.MAX_STREAMS


@pytest.mark.parametrize("capacity,mask,ncols,max_streams,resident_ctas", [
    (1, "random", 4, _K, 396),
    (3, "random", 4, _K, 396),
    (4097, "random", 4, _K, 396),
    (tcompact.TILE_ROWS, "random", 4, _K, 396),  # one tile
    (9000, "all_kept", 4, _K, 1),                # one CTA a tile
    (9000, "all_dropped", 4, _K, 2),
    (300, "random", 33, _K, 396),                # 66 streams > K
    (12289, "sparse", 4, 3, 396),                # 8 streams, K = 3
    (16, "q1_groups", 10, _K, 396),
])
def test_one_pass_compaction_plan_vs_pallas(capacity, mask, ncols,
                                            max_streams, resident_ctas):
    """The one-pass plan carried out with torch ops, bit for bit against
    the reference's Pallas gather_compact in interpret mode and against
    gather_compact_plain; heads and tails cover [0, capacity) once. The
    card's resident CTAs (132 SMs x 3) set how many CTAs share a tile;
    fewer give one CTA a tile."""
    rng = np.random.default_rng(capacity + ncols)
    # _columns' edge values need 6 rows: shorter capacities take a prefix
    datas = [c[:capacity] for _ in range(-(-ncols // 4))
             for c in _columns(max(capacity, 6), rng)][:ncols]
    valids = [rng.random(capacity) > 0.2 for _ in datas]
    keep = {"random": rng.random(capacity) > 0.5,
            "sparse": rng.random(capacity) > 0.97,
            "all_kept": np.ones(capacity, bool),
            "all_dropped": np.zeros(capacity, bool),
            "q1_groups": np.isin(np.arange(capacity), [0, 1, 4, 5, 8, 9])
            }[mask]
    ref, ref_n = _reference_compact(datas, valids, keep)
    tdatas = [torch.from_numpy(d) for d in datas]
    tvalids = [torch.from_numpy(v) for v in valids]
    tkeep = torch.from_numpy(keep)
    got, new_n, written = _one_pass_compact(tdatas, tvalids, tkeep, capacity,
                                            max_streams, rng, resident_ctas)
    plain, plain_n = tcompact.gather_compact_plain(tdatas, tvalids, tkeep,
                                                   capacity)
    assert torch.equal(written, torch.ones(capacity, dtype=torch.int64))
    assert new_n == int(ref_n) == int(plain_n)
    assert len(got) == len(ref) == len(plain) == ncols
    for (rd, rv), (gd, gv), (pd, pv) in zip(ref, got, plain):
        assert _bits_equal(rd, _np(gd)) and _bits_equal(rv, _np(gv))
        assert _bits_equal(_np(pd), _np(gd)) and _bits_equal(_np(pv),
                                                             _np(gv))


def test_look_back_finds_exclusive_offsets():
    """Over 200 tiles of random counts (up to a whole tile) and random
    lags, the look-back's offset is the exclusive sum of the counts."""
    rng = np.random.default_rng(5)
    counts = [int(c) for c in rng.integers(0, tcompact.TILE_ROWS + 1, 200)]
    want = np.cumsum([0] + counts[:-1]).tolist()
    assert _look_back(counts, rng) == want


def test_gather_compact_on_cpu_is_the_plain_version():
    """On CPU tensors the wrapper returns the plain version's outputs and
    count and launches nothing."""
    rng = np.random.default_rng(22)
    n = 100
    datas = [torch.from_numpy(c) for c in _columns(n, rng)]
    valids = [torch.from_numpy(rng.random(n) > 0.3) for _ in datas]
    keep = torch.from_numpy(rng.random(n) > 0.4)
    K.reset_launch_counts()
    got, got_n = tcompact.gather_compact(datas, valids, keep, n)
    want, want_n = tcompact.gather_compact_plain(datas, valids, keep, n)
    assert torch.equal(got_n, want_n)
    for (gd, gv), (wd, wv) in zip(got, want):
        assert _bits_equal(_np(gd), _np(wd)) and torch.equal(gv, wv)
    assert K.launch_counts()["gather_compact"] == 0


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


@pytest.mark.parametrize("n", [1, 3, 384])
def test_sort_takes_any_length(n):
    """The wrapper has no power-of-two envelope: a length that is not a
    power of two sorts (CPU tensors: the plain version) and equals
    lax.sort(operands + [payload], num_keys=m) bit for bit."""
    rng = np.random.default_rng(37 + n)
    ops = [rng.integers(0, 3, n).astype(np.int32),
           rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32),
           rng.integers(-2, 2, n).astype(np.int32)]
    payload = np.arange(n, dtype=np.int32)
    ref = jax.lax.sort([jnp.asarray(o) for o in ops] + [jnp.asarray(payload)],
                       num_keys=len(ops))
    tops = [torch.from_numpy(ops[0]),
            torch.from_numpy(ops[1].view(np.int32)).view(torch.uint32),
            torch.from_numpy(ops[2])]
    got = tsort.sort_with_payload(tops, torch.from_numpy(payload))
    assert len(ref) == len(got) == len(ops) + 1
    for r, g in zip(ref, got):
        assert _bits_equal(r, _np(g))
