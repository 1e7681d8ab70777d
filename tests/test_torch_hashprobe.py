"""The port's hash-table build and probe (spark_rapids_tpu_torch/kernels/
hashprobe.py) against the JAX package's, whose probe runs as its Pallas
kernel in interpret mode on the CPU backend (tests/test_kernels.py's
``_forced`` pattern), on the same numpy inputs.

Every comparison here is bit-identical (``_bits_equal``: dtype, shape and
bytes): the slots, the table, the probe's rowids and the fail flag are
integer functions of the keys. The reference keeps the table's keys as
(hi int32, lo uint32) limbs; the port keeps the int64 key, whose two words
are those limbs.

The CUDA probe (csrc/hashprobe.cu) runs only on the card; its walk, which
stops at the first empty slot and reads an occupied slot's key as
``build_keys[rowid]``, is carried out here with torch ops
(``_early_exit_probe``) and held against the reference's Pallas probe and
``probe_rowids_plain``, the full walk."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu import kernels
from spark_rapids_tpu.kernels import KernelsConfig
from spark_rapids_tpu.kernels import hashprobe as jhash
from spark_rapids_tpu.ops.limbs import split_i64_hi_lo
from spark_rapids_tpu_torch.kernels import hashprobe as thash

pytestmark = pytest.mark.kernels

EDGE_KEYS = [-(2 ** 63), 2 ** 63 - 1, 0, -1, -(2 ** 31), 1, 2 ** 32,
             2 ** 32 - 1, -(2 ** 32), 0x9E3779B1 << 8]


class _forced:
    """Force the reference's kernel enablement for direct primitive calls
    (a copy of tests/test_kernels.py's helper)."""

    def __init__(self, *names, **kw):
        self.cfg = KernelsConfig(enabled=names, **kw)

    def __enter__(self):
        self.tok = kernels.KERNELS_ENABLED.set(self.cfg)

    def __exit__(self, *exc):
        kernels.KERNELS_ENABLED.reset(self.tok)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread: the suite runs in several worker
    processes at once, and torch's default of one thread per core would
    crowd the other workers' timed tests."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _clean_kernel_state():
    kernels.reset()
    yield
    kernels.reset()


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _limbs(keys: np.ndarray):
    hi, lo = split_i64_hi_lo(jnp.asarray(keys))
    return hi, lo


def _port_limbs(t: torch.Tensor):
    """The port's int64 table keys as the reference's (hi i32, lo u32)."""
    k = t.numpy()
    return (k >> 32).astype(np.int32), (k & 0xFFFFFFFF).astype(np.uint32)


def test_slot_matches_reference_on_edge_keys():
    """Comparator: _bits_equal of the int32 slots, every attempt, two
    table sizes (the port computes in int64 with 32-bit masks)."""
    rng = np.random.default_rng(0)
    keys = np.concatenate([np.array(EDGE_KEYS, np.int64),
                           rng.integers(-(2 ** 63), 2 ** 63 - 1, 500,
                                        dtype=np.int64)])
    hi, lo = _limbs(keys)
    for H in (1 << 4, 1 << 22):
        for a in range(thash.MAX_ATTEMPTS):
            ref = np.asarray(jhash._slot(hi, lo, a, H - 1))
            got = thash._slot(torch.from_numpy(keys), a, H - 1)
            assert _bits_equal(got.to(torch.int32).numpy(), ref), (H, a)


def _build_case(kind, rng, cap=2048):
    if kind == "unique":
        keys = rng.choice(2 ** 40, cap, replace=False).astype(np.int64)
    elif kind == "edges":
        keys = rng.choice(2 ** 62, cap, replace=False).astype(np.int64)
        keys[:len(EDGE_KEYS)] = EDGE_KEYS
    else:  # "dup": a repeated key
        keys = rng.choice(2 ** 40, cap, replace=False).astype(np.int64)
        keys[5] = keys[700]
    valid = rng.random(cap) > 0.1
    return keys, valid


@pytest.mark.parametrize("kind", ["unique", "edges", "dup"])
@pytest.mark.parametrize("attempts,H", [(1, 4096), (4, 4096), (8, 4096),
                                        (2, 1024)])
def test_build_table_matches_reference(kind, attempts, H):
    """Comparator: _bits_equal of (table_row, table_hi, table_lo,
    fail_build); the H=1024 case leaves rows homeless (fail set)."""
    rng = np.random.default_rng(attempts * 31 + H)
    keys, valid = _build_case(kind, rng)
    hi, lo = _limbs(keys)
    r_row, r_hi, r_lo, r_fail = jhash.build_table(hi, lo, jnp.asarray(valid),
                                                  H, attempts)
    t_row, t_key, t_fail = thash.build_table(torch.from_numpy(keys),
                                             torch.from_numpy(valid), H,
                                             attempts)
    g_hi, g_lo = _port_limbs(t_key)
    assert _bits_equal(t_row.numpy(), r_row)
    assert _bits_equal(g_hi, r_hi) and _bits_equal(g_lo, r_lo)
    assert bool(t_fail) == bool(r_fail)
    if H == 1024:
        assert bool(t_fail)


def _probe_case(kind, rng, cap_l=4096, cap_r=2048):
    rkeys = rng.choice(2 ** 40, cap_r, replace=False).astype(np.int64) \
        * 0x9E3779B1 % (2 ** 40)
    rkeys[:len(EDGE_KEYS)] = EDGE_KEYS
    lkeys = np.concatenate([
        rkeys[rng.integers(0, cap_r, cap_l // 2)],
        rng.integers(-(2 ** 62), 2 ** 62, cap_l - cap_l // 2),
    ]).astype(np.int64)
    lkeys[:len(EDGE_KEYS)] = EDGE_KEYS
    rng.shuffle(lkeys)
    lv = rng.random(cap_l) > 0.1  # null probe keys
    rv = rng.random(cap_r) > 0.05  # null build keys
    live_l = rng.random(cap_l) > 0.2  # a masked probe batch
    live_r = np.arange(cap_r) < cap_r - 100  # a prefix build table
    H = 4096
    if kind == "dup":
        rkeys[9] = rkeys[1000]
        rv[9] = rv[1000] = live_r[9] = live_r[1000] = True
    elif kind == "homeless":
        H = 1024  # 2048 build rows cannot all place
    return lkeys, lv, rkeys, rv, live_l, live_r, H


@pytest.mark.parametrize("kind", ["plain", "dup", "homeless"])
@pytest.mark.parametrize("attempts", [1, 4, 8])
def test_probe_ranges_matches_reference(kind, attempts):
    """Comparator: _bits_equal of all six outputs (lo, counts, total,
    matched, rs_perm, fail) against the reference with its Pallas probe in
    interpret mode, at cap_l 4096, cap_r 2048, H 4096 (1024 homeless)."""
    rng = np.random.default_rng(attempts + 10 * len(kind))
    lkeys, lv, rkeys, rv, live_l, live_r, H = _probe_case(kind, rng)
    with _forced("hashprobe"):
        ref = jhash.probe_ranges(
            (jnp.asarray(lkeys), jnp.asarray(lv)),
            (jnp.asarray(rkeys), jnp.asarray(rv)),
            jnp.asarray(live_l), jnp.asarray(live_r), H, attempts)
    got = thash.probe_ranges(
        (torch.from_numpy(lkeys), torch.from_numpy(lv)),
        (torch.from_numpy(rkeys), torch.from_numpy(rv)),
        torch.from_numpy(live_l), torch.from_numpy(live_r), H, attempts)
    names = ("lo", "counts", "total", "matched", "rs_perm", "fail")
    for name, r, g in zip(names, ref, got):
        assert _bits_equal(g.numpy(), np.asarray(r)), name
    fail = bool(got[-1])
    if kind != "plain":
        assert fail
    if kind == "plain" and not fail:
        # every valid live probe row whose key is a valid live build key
        # matches that build row
        build = {int(k): i for i, k in enumerate(rkeys)
                 if rv[i] and live_r[i]}
        want = np.array([build.get(int(k), -1) if lv[i] and live_l[i]
                         else -1 for i, k in enumerate(lkeys)])
        lo, counts = got[0].numpy(), got[1].numpy()
        assert (np.where(counts > 0, lo, -1) == want).all()


def test_probe_rowids_plain_on_cpu_counts_no_launch():
    """On CPU tensors the wrapper runs the plain version and leaves the
    launch counter alone; attempts outside [1, 8] raise before any work
    (the reference routes them to the sorted probe instead)."""
    keys = torch.arange(16, dtype=torch.int64)
    valid = torch.ones(16, dtype=torch.bool)
    trow, tkey, fail = thash.build_table(keys, valid, 64, 4)
    before = thash.probe_rowids.launches
    got = thash.probe_rowids(keys, valid, trow, keys, 4)
    assert not bool(fail)
    assert torch.equal(got, torch.arange(16, dtype=torch.int32))
    assert thash.probe_rowids.launches == before
    for bad in (0, 9):
        with pytest.raises(ValueError, match="attempts"):
            thash.probe_ranges((keys, valid), (keys, valid), valid, valid,
                               64, bad)


# ---------------------------------------------------------------------------
# the CUDA probe's walk, carried out with torch ops
# ---------------------------------------------------------------------------

def _early_exit_probe(keys, valid, table_row, build_keys, attempts):
    """csrc/hashprobe.cu's walk: per attempt a rowid load; an empty slot
    (-1) ends the walk with -1; an occupied slot's key is
    ``build_keys[rowid]`` and a hit ends it with the rowid. Returns
    (rowids int32, slots visited per row)."""
    mask = int(table_row.shape[0]) - 1
    res = torch.full(keys.shape, -1, dtype=torch.int32)
    walking = valid.clone()
    visited = torch.zeros(keys.shape, dtype=torch.int64)
    for a in range(attempts):
        r = table_row[thash._slot(keys, a, mask)]
        visited += walking.to(torch.int64)
        slot_key = build_keys[r.clamp(min=0)]
        stop = walking & ((r < 0) | (slot_key == keys))
        res = torch.where(stop, r, res)
        walking = walking & ~stop
    return res, visited


def _load_case(load, attempts, rng, H=4096, cap_l=4096):
    """``H`` build rows, ``load * H`` of them valid (sparse unique keys
    with the edge keys among them), and probe keys: half drawn from the
    build keys (valid and invalid rows alike), the rest random, the edge
    keys, 10% null."""
    rkeys = (rng.choice(2 ** 40, H, replace=False).astype(np.int64)
             * 0x9E3779B1) % (2 ** 40)
    rkeys[:len(EDGE_KEYS)] = EDGE_KEYS
    rv = np.zeros(H, bool)
    rv[rng.choice(H, int(load * H), replace=False)] = True
    lkeys = np.concatenate([rkeys[rng.integers(0, H, cap_l // 2)],
                            rng.integers(-(2 ** 62), 2 ** 62,
                                         cap_l - cap_l // 2)]).astype(np.int64)
    lkeys[:len(EDGE_KEYS)] = EDGE_KEYS
    rng.shuffle(lkeys)
    lv = rng.random(cap_l) > 0.1
    return lkeys, lv, rkeys, rv


def _three_probes(lkeys, lv, rkeys, rv, H, attempts):
    """(early exit on the port's table, the reference's Pallas probe on
    its own table, probe_rowids_plain on the port's table, slots visited,
    the port's table_row)."""
    hi, lo = _limbs(rkeys)
    r_row, r_hi, r_lo, _ = jhash.build_table(hi, lo, jnp.asarray(rv), H,
                                             attempts)
    t_row, _, _ = thash.build_table(torch.from_numpy(rkeys),
                                    torch.from_numpy(rv), H, attempts)
    assert _bits_equal(t_row.numpy(), r_row)
    p_hi, p_lo = _limbs(lkeys)
    with _forced("hashprobe"):
        ref = np.asarray(jhash.probe_rowids(p_hi, p_lo, jnp.asarray(lv),
                                            r_row, r_hi, r_lo, attempts))
    tk, tv, tr = (torch.from_numpy(lkeys), torch.from_numpy(lv),
                  torch.from_numpy(rkeys))
    early, visited = _early_exit_probe(tk, tv, t_row, tr, attempts)
    plain = thash.probe_rowids_plain(tk, tv, t_row, tr, attempts)
    return early, ref, plain, visited, t_row


@pytest.mark.parametrize("load", [0.05, 0.3, 0.6, 0.9])
@pytest.mark.parametrize("attempts", [1, 4, 8])
def test_early_exit_probe_matches_reference(attempts, load):
    """Comparator: _bits_equal of the rowids of the early-exit walk, the
    reference's Pallas probe (interpret mode) and probe_rowids_plain, on
    tables built by both packages' build_table (H 4096, loads 0.05-0.9;
    the high loads leave rows homeless). No walk visits more than
    ``attempts`` slots, and at load 0.05 a row visits about one."""
    rng = np.random.default_rng(int(load * 100) + attempts)
    lkeys, lv, rkeys, rv = _load_case(load, attempts, rng)
    early, ref, plain, visited, _ = _three_probes(lkeys, lv, rkeys, rv,
                                                  4096, attempts)
    assert _bits_equal(early.numpy(), ref)
    assert _bits_equal(plain.numpy(), ref)
    assert int(visited.max()) <= attempts
    if load == 0.05:
        assert float(visited[torch.from_numpy(lv)].float().mean()) < 1.1


@pytest.mark.parametrize("case", ["homeless", "dup", "edges"])
def test_early_exit_probe_fail_cases(case):
    """Comparator: _bits_equal against the Pallas probe and the plain
    version, for the probe and the self-probe: rows left homeless (H 64,
    1 attempt: fail set), a duplicated build key (the self-probe still
    resolves one of the pair to the other), INT64_MIN/MAX, 0, -1 and null
    probe keys (8 attempts)."""
    rng = np.random.default_rng(len(case))
    H, attempts = (64, 1) if case == "homeless" else (4096, 8 if
                                                      case == "edges" else 4)
    lkeys, lv, rkeys, rv = _load_case(0.4, attempts, rng)
    rkeys, rv = rkeys[:2048].copy(), rv[:2048].copy()
    e = len(EDGE_KEYS)
    lkeys[:e] = lkeys[e:2 * e] = EDGE_KEYS
    lv[:e] = True
    lv[e:2 * e] = False  # null probe keys
    rv[:e] = True
    if case == "dup":
        rkeys[100] = rkeys[1500]
        rv[100] = rv[1500] = True
    early, ref, plain, _, t_row = _three_probes(lkeys, lv, rkeys, rv, H,
                                                attempts)
    assert _bits_equal(early.numpy(), ref) and _bits_equal(plain.numpy(), ref)
    self_early, self_ref, self_plain, _, _ = _three_probes(
        rkeys, rv, rkeys, rv, H, attempts)
    assert _bits_equal(self_early.numpy(), self_ref)
    assert _bits_equal(self_plain.numpy(), self_ref)
    rowid = np.arange(rkeys.shape[0])
    dup = rv & (self_ref >= 0) & (self_ref != rowid)
    if case == "dup":
        assert dup.any() and set(np.nonzero(dup)[0]) <= {100, 1500}
    else:
        assert not dup.any()
    if case == "homeless":
        assert int((t_row >= 0).sum()) < int(rv.sum())  # rows left out
    if case == "edges":
        # each edge probe key finds its build row (rows 0..e-1 on both
        # sides); the null ones find nothing
        assert (early.numpy()[:e] == np.arange(e)).all()
        assert (early.numpy()[e:2 * e] == -1).all()


@pytest.mark.parametrize("load", [0.05, 0.5, 0.9])
@pytest.mark.parametrize("attempts", [2, 4, 8])
def test_build_leaves_no_empty_slot_before_a_placed_row(attempts, load):
    """The invariant the early exit rests on: for every row the build
    placed at attempt k, its slots at attempts 0..k-1 are occupied in the
    final table (both packages' tables, which are equal)."""
    rng = np.random.default_rng(attempts * 7 + int(load * 10))
    _, _, rkeys, rv = _load_case(load, attempts, rng)
    H = 4096
    t_row, _, _ = thash.build_table(torch.from_numpy(rkeys),
                                    torch.from_numpy(rv), H, attempts)
    hi, lo = _limbs(rkeys)
    r_row = np.asarray(jhash.build_table(hi, lo, jnp.asarray(rv), H,
                                         attempts)[0])
    assert _bits_equal(t_row.numpy(), r_row)
    occupied = t_row >= 0
    slot = torch.nonzero(occupied).squeeze(1)
    keys = torch.from_numpy(rkeys)[t_row[slot].to(torch.int64)]
    slots = torch.stack([thash._slot(keys, a, H - 1)
                         for a in range(attempts)])
    # each placed row's attempt k: the first attempt whose slot is its own
    k = (slots == slot).to(torch.int64).argmax(0)
    assert bool((slots[k, torch.arange(slot.shape[0])] == slot).all())
    earlier = torch.arange(attempts)[:, None] < k[None, :]
    assert bool(occupied[slots][earlier].all())
    assert int(k.max()) > 0 or attempts == 1 or load < 0.1
