"""The radix sort's host-side plan (``kernels/sort.py::radix_plan``)
against the JAX package's sort, on the CPU.

The CUDA kernel cannot run here, but what it is told to do can: each
test surveys the operands' flipped words with torch ops, packs the
varying bits by the plan, sorts stably by the planned digits with
``torch.sort`` (least significant first, a later word packed through the
permutation so far, as ``csrc/sort.cu`` does) and carries every array
through the permutation. The result is held bit for bit (comparator:
bit-identical) against the reference's ``sort_with_payload`` in Pallas
interpret mode, as tests/test_torch_kernels.py runs it, where the length
is a power of two, against ``jax.lax.sort(operands + [payload],
num_keys=m)`` where it is not, and against the port's
``sort_with_payload_plain``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spark_rapids_tpu.kernels import sort as jsort
from spark_rapids_tpu.ops import ordering as jord
from spark_rapids_tpu_torch.kernels import sort as tsort

pytestmark = pytest.mark.kernels

_FLIP = {torch.int32: 0x80000000, torch.uint32: 0}


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    return t.numpy()


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32)).view(torch.uint32)
    return torch.from_numpy(a)


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _flipped(op: torch.Tensor) -> torch.Tensor:
    """The operand's flipped words as int64 in [0, 2^32)."""
    words = op.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return words ^ _FLIP[op.dtype]


def _survey(ops):
    """(OR words, AND words) of the flipped words, bit by bit."""
    ors, ands = [], []
    for op in ops:
        f = _flipped(op)
        bit = [((f >> b) & 1) for b in range(32)]
        ors.append(sum(1 << b for b in range(32) if bool(bit[b].any())))
        ands.append(sum(1 << b for b in range(32) if bool(bit[b].all())))
    return ors, ands


def _pack_word(plan, ops, rows, word):
    """Word ``word`` of each row's packed key as (low 32 bits, high 32
    bits), int64 tensors (torch has no shift into an int64 sign bit)."""
    lo = torch.zeros(rows.shape[0], dtype=torch.int64)
    hi = torch.zeros_like(lo)
    for k, src, length, w, dst in plan.segments:
        if w != word:
            continue
        v = (_flipped(ops[k])[rows] >> src) & ((1 << length) - 1)
        if dst < 32:
            lo |= (v << dst) & 0xFFFFFFFF
            if dst + length > 32:
                hi |= v >> (32 - dst)
        else:
            hi |= v << (dst - 32)
    return lo, hi


def _radix_sort(ops, payload):
    """The kernel's plan carried out with torch ops: (result, plan)."""
    plan = tsort.radix_plan(*_survey(ops))
    n = payload.shape[0]
    perm = torch.arange(n, dtype=torch.int64)
    for word in range(plan.words):
        lo, hi = _pack_word(plan, ops, perm, word)
        for w, shift, width in plan.passes:
            if w != word:
                continue
            half = lo if shift < 32 else hi
            digit = (half >> (shift % 32)) & ((1 << width) - 1)
            order = torch.sort(digit, stable=True).indices
            perm, lo, hi = perm[order], lo[order], hi[order]
    arrs = list(ops) + [payload]
    return [tsort._take(a, perm) for a in arrs], plan


def _reference(ops_np, payload_np):
    """The JAX package's sort: the Pallas kernel (interpret mode) at a
    power-of-two length, lax.sort otherwise."""
    jops = [jnp.asarray(o) for o in ops_np]
    n = payload_np.shape[0]
    if n >= 2 and n & (n - 1) == 0:
        return jsort.sort_with_payload(jops, jnp.asarray(payload_np))
    return jax.lax.sort(jops + [jnp.asarray(payload_np)],
                        num_keys=len(ops_np))


def _check(ops_np, payload_np=None):
    n = ops_np[0].shape[0]
    if payload_np is None:
        payload_np = np.arange(n, dtype=np.int32)
    ops = [_torch(o) for o in ops_np]
    payload = torch.from_numpy(payload_np)
    got, plan = _radix_sort(ops, payload)
    ref = _reference(ops_np, payload_np)
    plain = tsort.sort_with_payload_plain(ops, payload)
    assert len(got) == len(ref) == len(plain) == len(ops_np) + 1
    for g, r, p in zip(got, ref, plain):
        assert _bits_equal(r, _np(g))
        assert _bits_equal(_np(p), _np(g))
    return plan


def _f64_words(f64, descending=False):
    ops = jord.comparable_operands(jnp.asarray(f64))
    if descending:
        ops = jord.descending_operands(ops)
    return [np.array(o) for o in ops]


def _f64_edges(n, rng):
    edge = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, np.nan, 1.5, -2.25])
    f64 = rng.standard_normal(n) * 1e3
    f64[:8] = edge
    f64[8:n // 2] = rng.choice(edge, n // 2 - 8)  # ties among the edges
    return f64


def test_all_rows_equal_has_no_varying_bit():
    ops = [np.full(256, 7, np.int32), np.full(256, 2 ** 31 + 5, np.uint32)]
    plan = _check(ops)
    assert (plan.bits, plan.words, plan.segments, plan.passes) == (0, 0, (),
                                                                   ())


def test_one_bit_flags():
    rng = np.random.default_rng(1)
    dead = (np.arange(128) >= 100).astype(np.int32)
    null = (rng.random(128) < 0.2).astype(np.int32)
    plan = _check([dead, null])
    assert plan.bits == 2 and plan.passes == ((0, 0, 2),)
    # dead (operand 0) is the most significant bit
    assert plan.segments == ((1, 0, 1, 0, 0), (0, 0, 1, 0, 1))


def test_non_contiguous_varying_bits():
    rng = np.random.default_rng(2)
    vals = np.array([0, 0x100, 0x10001, 0x40000100, -0x7FFFFF00],
                    np.int64).astype(np.int32)
    key = rng.choice(vals, 256)
    plan = _check([key, rng.integers(0, 4, 256).astype(np.int32)])
    runs = [s for s in plan.segments if s[0] == 0]
    assert len(runs) > 1  # the key's varying bits are not one run
    assert plan.bits == sum(s[2] for s in plan.segments)
    assert plan.bits == 2 + bin(int(np.bitwise_or.reduce(
        key.view(np.uint32) ^ np.uint32(0x80000000)) ^ np.bitwise_and.reduce(
        key.view(np.uint32) ^ np.uint32(0x80000000)))).count("1")


def test_exactly_64_bits_is_one_word():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2 ** 32, 256, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, 256, dtype=np.uint64).astype(np.uint32)
    a[:2], b[:2] = [0, 0xFFFFFFFF], [0, 0xFFFFFFFF]
    a[2:6] = a[6:10]  # ties on the first operand
    plan = _check([a, b])
    assert plan.bits == 64 and plan.words == 1 and len(plan.passes) == 8


@pytest.mark.parametrize("descending", [False, True])
def test_f64_words_over_64_bits(descending):
    """f64 keys as (uint32 hi, uint32 lo) sortable words with NaN, +-0.0
    and +-inf, behind an int32 key with ties: B > 64, the multiword
    path."""
    rng = np.random.default_rng(4)
    f64 = _f64_edges(256, rng)
    ops = ([rng.integers(-2, 2, 256).astype(np.int32)]
           + _f64_words(f64, descending))
    plan = _check(ops)
    assert plan.bits > 64 and plan.words == 2
    assert [w for w, _, _ in plan.passes] == sorted(
        w for w, _, _ in plan.passes)
    # a run that crosses bit 64 is split between the words
    assert sum(s[2] for s in plan.segments if s[3] == 0) == 64


def test_f64_ascending_and_descending_together():
    rng = np.random.default_rng(5)
    f64 = _f64_edges(64, rng)
    ops = ([rng.integers(0, 3, 64).astype(np.int32)] + _f64_words(f64)
           + _f64_words(f64, descending=True))
    plan = _check(ops)
    assert plan.words >= 2


@pytest.mark.parametrize("n", [3, 384, 1000])
def test_int32_and_uint32_mixed_at_any_length(n):
    rng = np.random.default_rng(6 + n)
    ops = [rng.integers(-3, 3, n).astype(np.int32),
           rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32),
           rng.integers(-(2 ** 31), 2 ** 31, n).astype(np.int32),
           (rng.integers(0, 5, n) * 0x01000000).astype(np.uint32)]
    ops[1][: n // 2] = ops[1][n // 2: 2 * (n // 2)]  # ties on operand 1
    _check(ops)


def test_payload_is_carried_not_compared():
    """Any payload comes back permuted by the stable order of the keys."""
    rng = np.random.default_rng(7)
    key = rng.integers(0, 3, 128).astype(np.int32)
    payload = rng.permutation(128).astype(np.int32)
    got, _ = _radix_sort([torch.from_numpy(key)], torch.from_numpy(payload))
    order = np.argsort(key, kind="stable")
    assert _bits_equal(_np(got[1]), payload[order])


def test_plan_segments_encode_as_the_kernel_reads_them():
    plan = tsort.radix_plan([0xFFFFFFFF, 0x0000F0F1], [0, 1])
    enc = tsort.encode_segments(plan)
    for (k, src, ln, w, dst), e in zip(plan.segments, enc):
        assert (e & 31, (e >> 5) & 31, ((e >> 10) & 31) + 1, (e >> 15) & 15,
                (e >> 19) & 63) == (k, src, ln, w, dst)
    assert plan.bits == 8 + 32 and plan.words == 1
