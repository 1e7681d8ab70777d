"""Drive the PyTorch port (spark_rapids_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--rows N] [--sf SF] [--seed S] [--profile DIR]

Phases, in order; any failure exits non-zero:

1. the card: ``nvidia-smi`` name and power limit, torch version, compute
   capability (must be 9.0, an H100);
2. build the CUDA kernels from ``spark_rapids_tpu_torch/kernels/csrc``;
3. each kernel against its plain torch version on the card, at the shapes
   q1, q3 and the corpus's q2 and q8 give it, at one large shape and on
   edge inputs, with times (CUDA events, warm median) beside the least
   time the card could take and one PyTorch library call computing the
   same function;
4. TPC-H q1 end to end through ``TorchSession`` at ``--rows`` lineitem rows
   (default 6,001,215 = TPC-H SF 1), checked against a numpy oracle, with
   every kernel's launch counter read around the query (phases 4-6 also log
   each sort's rows, operands, varying bits B and digit passes, and the
   sort's host syncs);
5. TPC-H q3 end to end at the same lineitem rows, in two data forms: the
   dense keys of models/tpch.py (direct-address joins) and the same tables
   with their keys mapped to a sparse 40-bit range (hash-probe joins,
   after a replay), the latter with 4 (the default) and with 8 hash-probe
   attempts; cold and warm times, replays, peak memory and every kernel's
   launches in one warm run, each result against a numpy oracle;
6. the golden corpus's q2 and q8 through ``TorchSession`` at
   ``scale_test_specs(--sf)`` (default 10: 2,500,000 orders under an
   Exponential o_custkey skew over 250,000 customers, 10,000,000 lineitem
   rows), seed ``--seed`` (default 7), beside q8's inner group-by (dense
   keys, and o_custkey mapped by ``sparse_keys``: the sort-segment path),
   a MIN/MAX group-by of orders and a global MIN/MAX over lineitem; cold
   and warm times, replays, peak memory and every kernel's launches in one
   warm run, each result against a numpy oracle (MIN, MAX and counts
   exact, q2's sum rtol 1e-9);
7. the summary lines: one ``{"kernels": [...]}`` JSON line, the card line,
   and last ``{"ok": true, "device": {...}}``.

It needs one CUDA card and exits non-zero without one. ``--profile DIR``
also writes a torch.profiler table and trace of one warm run of q1, of
each q3 form and of each phase-6 query.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth, FP64 (non-tensor) rate; the
#: INT32 rate is half the 67 TFLOP/s FP32 rate (64 INT32 lanes per SM
#: against 128 FP32 lanes)
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
INT32_OPS_PER_S = 33.5e12

#: every tensor of the script lives on the card
DEV = torch.device("cuda")

TPU_KERNELS = {
    "onehot_partials": "spark_rapids_tpu/kernels/segreduce.py:145",
    "fused_minmax": "spark_rapids_tpu/kernels/segreduce.py:108",
    "gather_compact": "spark_rapids_tpu/kernels/compact.py:112",
    "sort_with_payload": "spark_rapids_tpu/kernels/sort.py:84",
    "probe_rowids": "spark_rapids_tpu/kernels/hashprobe.py:139",
}
SOURCES = {
    "onehot_partials": "spark_rapids_tpu_torch/kernels/csrc/segreduce.cu",
    "fused_minmax": "spark_rapids_tpu_torch/kernels/csrc/minmax.cu",
    "gather_compact": "spark_rapids_tpu_torch/kernels/csrc/compact.cu",
    "sort_with_payload": "spark_rapids_tpu_torch/kernels/csrc/sort.cu",
    "probe_rowids": "spark_rapids_tpu_torch/kernels/csrc/hashprobe.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 15, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` on the card (CUDA events, warm)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float, ops_rate: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bits(t: torch.Tensor) -> torch.Tensor:
    """An integer view with the same bits, for exact comparison."""
    view = {torch.float64: torch.int64, torch.float32: torch.int32,
            torch.uint32: torch.int32}.get(t.dtype)
    return t.view(view) if view is not None else t


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and \
        torch.equal(bits(a), bits(b))


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def q1_like_partials_input(capacity: int, nrows: int, gen: torch.Generator):
    """The aggregate's f64 stack as q1 builds it: 7 value columns (4 SUM,
    3 AVG; column-major), zero where the filter or the padding drops a
    row, and the gid over 4 x 3 key slots (flag/status codes, null slot
    last) padded to 16; padding rows land in the (null, null) slot 11."""
    dev = DEV
    live = torch.arange(capacity, device=dev) < nrows
    flag = torch.randint(0, 3, (capacity,), generator=gen, device=dev)
    status = torch.randint(0, 2, (capacity,), generator=gen, device=dev)
    gid = torch.where(live, flag * 3 + status, torch.full_like(flag, 11))
    keep = live & (torch.rand(capacity, generator=gen, device=dev) < 0.986)
    qty = torch.randint(1, 51, (capacity,), generator=gen,
                        device=dev).to(torch.float64)
    price = torch.round(torch.rand(capacity, generator=gen, device=dev,
                                   dtype=torch.float64) * 1e7) / 100.0
    disc = torch.randint(0, 11, (capacity,), generator=gen,
                         device=dev).to(torch.float64) / 100.0
    tax = torch.randint(0, 9, (capacity,), generator=gen,
                        device=dev).to(torch.float64) / 100.0
    dp = price * (1.0 - disc)
    cols = [qty, price, dp, dp * (1.0 + tax), qty, price, disc]
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    # column-major (capacity, 7), as ops/segsum.py hands it to the kernel
    x = torch.stack([torch.where(keep, c, zero) for c in cols], 0).t()
    return x, gid.to(torch.int32).contiguous()


def partials_error(got, ref, x, gid, nseg, nb, block):
    """(max abs error, max error relative to each partial's absolute
    mass) with NaN positions required to agree."""
    from spark_rapids_tpu_torch.kernels.segreduce import onehot_partials_plain
    mass = onehot_partials_plain(x.abs().to(torch.float64), gid, nseg, nb,
                                 block)
    g, r = got.to(torch.float64), ref.to(torch.float64)
    if not torch.equal(torch.isnan(g), torch.isnan(r)):
        fail("onehot_partials: NaN positions differ from the plain version")
    fin = ~torch.isnan(g) & ~torch.isinf(g) & ~torch.isinf(r)
    if not torch.equal(g[~fin & ~torch.isnan(g)], r[~fin & ~torch.isnan(g)]):
        fail("onehot_partials: infinite partials differ")
    err = (g - r).abs().where(fin, torch.zeros_like(g))
    rel = (err / mass.clamp(min=1e-300)).where(fin, torch.zeros_like(g))
    return float(err.max()), float(rel.max())


def check_segreduce(capacity: int, nrows: int, gen) -> dict:
    from spark_rapids_tpu_torch.kernels.segreduce import (
        onehot_partials,
        onehot_partials_plain,
    )
    dev = DEV
    block = 1024
    nb = capacity // block

    def run_case(name, x, gid, nseg, rtol):
        k_nb = x.shape[0] // block
        a = onehot_partials(x, gid, nseg, k_nb, block)
        b = onehot_partials(x, gid, nseg, k_nb, block)
        torch.cuda.synchronize()
        if not same_bits(a, b):
            fail(f"onehot_partials {name}: two runs differ in their bits")
        ref = onehot_partials_plain(x, gid, nseg, k_nb, block)
        abs_err, rel = partials_error(a, ref, x, gid, nseg, k_nb, block)
        ok = rel <= rtol
        log(f"  segreduce {name}: max_abs_err={abs_err:.3e} "
            f"max_err/mass={rel:.3e} (tol rtol {rtol:.3g} of each partial's "
            f"absolute mass) bit-identical-rerun=True {'OK' if ok else 'FAIL'}")
        if not ok:
            fail(f"onehot_partials {name} disagrees with its plain version")
        return abs_err

    x, gid = q1_like_partials_input(capacity, nrows, gen)
    q1_err = run_case(f"q1 ({capacity}x7 f64, nseg 16)", x, gid, 16, 1e-12)
    small = 1 << 20
    # f32: two summation orders over a 1024-row block each err by at most
    # (block - 1) * 2^-24 of the absolute mass (recursive summation)
    run_case("f32 (2^20x7, nseg 16)", x[:small].to(torch.float32).contiguous(),
             gid[:small].contiguous(), 16, 2 * (block - 1) * 2.0 ** -24)
    # edges: NaN, +-inf, -0.0, ties (all rows in one segment), nseg 1 / 32
    e = torch.randn((small, 5), generator=gen, device=dev,
                    dtype=torch.float64) * 1e6
    e[:, 1] = -0.0
    e[5, 0], e[70000, 2], e[9, 3], e[10, 3] = (float("nan"), float("inf"),
                                               float("inf"), float("-inf"))
    g32 = torch.randint(0, 32, (small,), generator=gen, device=dev,
                        dtype=torch.int32)
    run_case("edges nseg 32 (row-major x)", e, g32, 32, 1e-12)
    run_case("edges nseg 1", e, torch.zeros_like(g32), 1, 1e-12)
    run_case("ties (one segment of 8)", e, torch.full_like(g32, 3), 8, 1e-12)

    ids = (torch.arange(capacity, device=dev) // block) * 16 + gid.to(torch.int64)
    lib_out = torch.zeros(nb * 16, 7, dtype=torch.float64, device=dev)
    ms = time_ms(lambda: onehot_partials(x, gid, 16, nb, block))
    x_rows = x.contiguous()  # the same values row-major
    rows_ms = time_ms(lambda: onehot_partials(x_rows, gid, 16, nb, block))
    plain_ms = time_ms(lambda: onehot_partials_plain(x, gid, 16, nb, block))
    lib_ms = time_ms(lambda: lib_out.zero_().index_add_(0, ids, x))
    nbytes = capacity * (7 * 8 + 4) + nb * 16 * 7 * 8
    bnd, by = bound_ms(nbytes, capacity * 7, FP64_OPS_PER_S)
    log(f"  segreduce time at q1 shape: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, index_add_ {lib_ms:.4f} ms, bound {bnd:.4f} ms "
        f"({by}), {nbytes / ms / 1e6:.1f} GB/s; on row-major x "
        f"{rows_ms:.4f} ms")
    return {"name": "onehot_partials", "max_abs_err": q1_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib_ms}


def compact_inputs(capacity, nkeep_frac, dtypes, gen):
    dev = DEV
    datas = []
    for dt in dtypes:
        if dt == torch.float64:
            d = torch.randn(capacity, generator=gen, device=dev,
                            dtype=torch.float64) * 1e6
            d[:4] = torch.tensor([float("nan"), -0.0, float("inf"),
                                  float("-inf")], dtype=torch.float64)
        elif dt == torch.int64:
            d = torch.randint(-(2 ** 62), 2 ** 62, (capacity,), generator=gen,
                              device=dev, dtype=torch.int64)
        else:
            d = torch.randint(0, 3, (capacity,), generator=gen, device=dev,
                              dtype=torch.int32)
        datas.append(d)
    valids = [torch.rand(capacity, generator=gen, device=dev) < 0.97
              for _ in dtypes]
    keep = torch.rand(capacity, generator=gen, device=dev) < nkeep_frac
    return datas, valids, keep


def compact_args(keep):
    keep_i = keep.to(torch.int32)
    return (torch.cumsum(keep_i, 0, dtype=torch.int32) - 1,
            keep_i.sum(dtype=torch.int32))


def check_compact(gen) -> dict:
    from spark_rapids_tpu_torch.kernels.compact import (
        gather_compact,
        gather_compact_plain,
    )

    def run_case(name, datas, valids, keep, capacity):
        pos, new_n = compact_args(keep)
        got = gather_compact(datas, valids, keep, pos, new_n, capacity)
        ref = gather_compact_plain(datas, valids, keep, pos, new_n, capacity)
        torch.cuda.synchronize()
        ok = all(same_bits(gd, rd) and same_bits(gv, rv)
                 for (gd, gv), (rd, rv) in zip(got, ref))
        log(f"  compact {name}: kept {int(new_n)}/{capacity} exact="
            f"{ok} (tol: bit-identical) {'OK' if ok else 'FAIL'}")
        if not ok:
            fail(f"gather_compact {name} disagrees with its plain version")
        return pos, new_n

    # q1's group packing: 16 slots, 6 groups, 2 i32 codes + 7 f64 + 1 i64
    q1_types = [torch.int32] * 2 + [torch.float64] * 7 + [torch.int64]
    datas, valids, _ = compact_inputs(16, 1.0, q1_types, gen)
    keep = torch.zeros(16, dtype=torch.bool, device=DEV)
    keep[[0, 1, 3, 4, 6, 7]] = True
    pos, new_n = run_case("q1 (16 slots, 10 columns)", datas, valids, keep, 16)
    q1 = (datas, valids, keep, pos, new_n)
    for name, frac in (("all kept", 1.0), ("all dropped", 0.0),
                       ("half kept", 0.5)):
        d, v, k = compact_inputs(4096, frac, q1_types, gen)
        run_case(f"{name} (4096 rows)", d, v, k, 4096)
    big = 1 << 23
    bd, bv, bk = compact_inputs(big, 0.98, [torch.float64] * 7, gen)
    bpos, bnew = run_case("large (2^23 rows x 7 f64, 98% kept)", bd, bv, bk,
                          big)

    def timings(d, v, k, p, nn, cap):
        ms = time_ms(lambda: gather_compact(d, v, k, p, nn, cap))
        plain = time_ms(lambda: gather_compact_plain(d, v, k, p, nn, cap))
        lib = time_ms(lambda: [t[k] for t in list(d) + list(v)])
        row_bytes = sum(t.element_size() for t in list(d) + list(v))
        # every stream, keep and pos read once; every stream written once
        nbytes = cap * (row_bytes + 1 + 4) + cap * row_bytes
        bnd, by = bound_ms(nbytes, 0, INT32_OPS_PER_S)
        return ms, plain, lib, bnd, by, nbytes

    ms, plain, lib, bnd, by, nbytes = timings(*q1, 16)
    log(f"  compact time at q1 shape: kernel {ms:.4f} ms, plain {plain:.4f} "
        f"ms, mask indexing {lib:.4f} ms, bound {bnd:.6f} ms ({by})")
    lms, lplain, llib, lbnd, lby, lbytes = timings(bd, bv, bk, bpos, bnew, big)
    log(f"  compact time at large shape: kernel {lms:.4f} ms, plain "
        f"{lplain:.4f} ms, mask indexing {llib:.4f} ms, bound {lbnd:.4f} ms "
        f"({lby}), {lbytes / lms / 1e6:.1f} GB/s")
    return {"name": "gather_compact", "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib}


def sort_operands(n, nops, hi, gen):
    return [torch.randint(0, hi, (n,), generator=gen, device=DEV,
                          dtype=torch.int32) for _ in range(nops)]


def packed_key(ops, widths):
    """One int64 key with the order of the operand tuples: each operand's
    low ``widths[i]`` bits (its flipped word for a uint32 view), first
    operand most significant."""
    key = torch.zeros_like(ops[0], dtype=torch.int64)
    for o, w in zip(ops, widths):
        v = o.view(torch.int32).to(torch.int64) & ((1 << w) - 1)
        key = (key << w) | v
    return key


def sparse_q8_inner_operands(gen, rows=2_500_000, domain=250_000,
                             capacity=1 << 22):
    """The sort-segment aggregate's operands at sparse q8 inner's shape:
    [dead, null, hi, lo] of ``sparse_keys(o_custkey)``, o_custkey under
    the Exponential skew, 2,500,000 orders in a 2^22 bucket (the padding
    rows dead and null, their key zeroed)."""
    from spark_rapids_tpu_torch.ops.ordering import comparable_operands
    live = torch.arange(capacity, device=DEV) < rows
    key = sparse_keys(exponential_keys(capacity, domain, gen))
    dead = (~live).to(torch.int32)
    return [dead, dead.clone()] + comparable_operands(
        torch.where(live, key, torch.zeros_like(key)))


def check_sort(gen) -> dict:
    from spark_rapids_tpu_torch.kernels.sort import (
        radix_plan,
        sort_with_payload,
        sort_with_payload_plain,
        survey_words,
    )
    from spark_rapids_tpu_torch.ops.ordering import (
        comparable_operands,
        descending_operands,
    )

    def run_case(name, ops, quiet=False):
        n = ops[0].shape[0]
        payload = torch.arange(n, dtype=torch.int32, device=DEV)
        sort_with_payload.trace = []
        got = sort_with_payload(ops, payload)
        (_, m, survey), = sort_with_payload.trace
        sort_with_payload.trace = None
        ref = sort_with_payload_plain(ops, payload)
        torch.cuda.synchronize()
        ok = all(same_bits(g, r) for g, r in zip(got, ref))
        if not quiet or not ok:
            plan = radix_plan(*survey_words(survey.tolist(), m))
            log(f"  sort {name}: B={plan.bits} passes={len(plan.passes)} "
                f"exact={ok} (tol: bit-identical) {'OK' if ok else 'FAIL'}")
        if not ok:
            fail(f"sort_with_payload {name} disagrees with its plain version")

    # q1's ORDER BY: 16 rows, live flag + 2 x (null flag, dictionary code)
    live = (torch.arange(16, device=DEV) >= 6).to(torch.int32)
    q1_ops = [live, torch.zeros(16, dtype=torch.int32, device=DEV),
              torch.randint(0, 3, (16,), generator=gen, device=DEV,
                            dtype=torch.int32),
              torch.zeros(16, dtype=torch.int32, device=DEV),
              torch.randint(0, 2, (16,), generator=gen, device=DEV,
                            dtype=torch.int32)]
    run_case("q1 (16 rows, 5 int32 operands)", q1_ops)

    # edges: f64 sortable words (uint32) with NaN, -0.0, +-inf and ties,
    # ascending and descending, beside int32 ties: B > 64 (multiword), in
    # one CTA and on the planned path
    def f64_edges(n):
        f = torch.randn(n, generator=gen, device=DEV, dtype=torch.float64)
        f[:6] = torch.tensor([float("nan"), -0.0, 0.0, float("inf"),
                              float("-inf"), float("nan")],
                             dtype=torch.float64)
        f[6:n // 2] = f[:6].repeat(n // 12 + 1)[:n // 2 - 6]
        words = comparable_operands(f)
        return ([sort_operands(n, 1, 3, gen)[0]] + words
                + descending_operands(words))

    run_case("edges (4096 rows, uint32 f64 words asc+desc, int32 ties)",
             f64_edges(4096))
    run_case("edges (2^20 rows, uint32 f64 words asc+desc, int32 ties)",
             f64_edges(1 << 20))
    # every power of two from 2 to 2^24 (one CTA up to 4096 rows)
    for p in range(1, 25):
        run_case(f"n=2^{p}", sort_operands(1 << p, 2, 7, gen), quiet=True)
    log("  sort n=2^1..2^24 (2 int32 operands of 7 values): exact=True (tol: "
        "bit-identical) OK")
    for n in (3, 384, 1_000_003):
        run_case(f"n={n} (2 int32 operands of 7 values, 1 uint32)",
                 sort_operands(n, 2, 7, gen)
                 + [torch.randint(-(2 ** 31), 2 ** 31 - 1, (n,),
                                  generator=gen, device=DEV,
                                  dtype=torch.int32).view(torch.uint32)])
    for n in (16, 1 << 20):
        run_case(f"B=0 ({n} equal rows, 3 operands)",
                 [torch.full((n,), v, dtype=torch.int32, device=DEV)
                  for v in (-5, 0, 2 ** 31 - 1)])
    big = 1 << 20
    big_ops = sort_operands(big, 5, 1 << 12, gen)
    run_case("large (2^20 rows, 5 int32 operands of 12 bits)", big_ops)
    sq8_ops = sparse_q8_inner_operands(gen)
    run_case("sparse q8 inner (2^22 rows, [dead, null, hi, lo] of "
             "sparse_keys(o_custkey))", sq8_ops)

    def timings(name, ops, widths):
        n = ops[0].shape[0]
        payload = torch.arange(n, dtype=torch.int32, device=DEV)
        ms = time_ms(lambda: sort_with_payload(ops, payload))
        plain = time_ms(lambda: sort_with_payload_plain(ops, payload))
        key = packed_key(ops, widths)
        lib = time_ms(lambda: torch.sort(key, stable=True))
        narr = len(ops) + 1
        nbytes = 2 * narr * n * 4
        ops_needed = n * math.log2(n) * narr
        bnd, by = bound_ms(nbytes, ops_needed, INT32_OPS_PER_S)
        log(f"  sort time at {name}: kernel {ms:.4f} ms, plain {plain:.4f} "
            f"ms, torch.sort(packed int64, stable=True) {lib:.4f} ms, bound "
            f"{bnd:.6f} ms ({by})")
        return ms, plain, lib, bnd, by

    ms, plain, lib, bnd, by = timings("q1 shape", q1_ops, [1, 1, 2, 1, 1])
    timings("large shape (2^20 x 5)", big_ops, [12] * 5)
    timings("sparse q8 inner shape (2^22 x 4)", sq8_ops, [1, 1, 8, 32])
    return {"name": "sort_with_payload", "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib}


def sort_trace_start() -> int:
    """Record every sort from here on; returns the host syncs so far."""
    from spark_rapids_tpu_torch.kernels.sort import sort_with_payload
    sort_with_payload.trace = []
    return sort_with_payload.host_syncs


def sort_trace_end(what: str, syncs_before: int) -> None:
    """Log each sort since sort_trace_start: rows, operands, varying bits
    B and digit passes, and the survey read-backs (host syncs)."""
    from spark_rapids_tpu_torch.kernels.sort import (
        radix_plan,
        sort_with_payload,
        survey_words,
    )
    trace, sort_with_payload.trace = sort_with_payload.trace, None
    sorts = []
    for n, m, survey in trace:
        plan = radix_plan(*survey_words(survey.tolist(), m))
        sorts.append(f"(n={n}, operands={m}, B={plan.bits}, "
                     f"passes={len(plan.passes)})")
    log(f"  {what}: sorts {', '.join(sorts) or 'none'}; sort host syncs "
        f"{sort_with_payload.host_syncs - syncs_before}")


def sparse_keys(k: torch.Tensor) -> torch.Tensor:
    """The sparse key form of q3: k -> (k * 0x9E3779B1) mod 2^40, a
    bijection on [0, 2^40) (the multiplier is odd)."""
    return (k * 0x9E3779B1) & ((1 << 40) - 1)


def hashprobe_case(n_probe, build_cap, n_build, live_share, match_share,
                   gen):
    """A join's key streams: a build table of ``build_cap`` slots holding
    ``n_build`` sparse unique keys, ``live_share`` of them live (the date
    or segment filter), and ``n_probe`` probe keys of which
    ``match_share`` draw from the build keys; 5% of probe keys null."""
    dev = DEV
    rkeys = sparse_keys(torch.arange(build_cap, device=dev,
                                     dtype=torch.int64))
    live_r = (torch.arange(build_cap, device=dev) < n_build) & (
        torch.rand(build_cap, generator=gen, device=dev) < live_share)
    pick = torch.randint(0, n_build, (n_probe,), generator=gen, device=dev)
    miss = sparse_keys(torch.randint(build_cap, 1 << 40, (n_probe,),
                                     generator=gen, device=dev))
    hit = torch.rand(n_probe, generator=gen, device=dev) < match_share
    lkeys = torch.where(hit, rkeys[pick], miss)
    lvalid = torch.rand(n_probe, generator=gen, device=dev) < 0.95
    return lkeys, lvalid, rkeys, live_r


def check_hashprobe(gen) -> dict:
    from spark_rapids_tpu_torch.kernels import hashprobe as H

    def to_cpu(*ts):
        return [t.cpu() for t in ts]

    def run_ranges(name, lkeys, lvalid, rkeys, live_r, tbl, attempts,
                   want_fail=None):
        """probe_ranges on the card (kernel) against probe_ranges on CPU
        copies (plain version): all six outputs bit-identical, and the
        table the card built equal to the CPU's."""
        live_l = torch.ones_like(lvalid)
        args = ((lkeys, lvalid), (rkeys, live_r), live_l, live_r, tbl,
                attempts)
        got = H.probe_ranges(*args)
        cl, clv, cr, clr, cll = to_cpu(lkeys, lvalid, rkeys, live_r, live_l)
        ref = H.probe_ranges((cl, clv), (cr, clr), cll, clr, tbl, attempts)
        g_tab = H.build_table(rkeys, live_r, tbl, attempts)
        r_tab = H.build_table(cr, clr, tbl, attempts)
        torch.cuda.synchronize()
        ok = all(same_bits(g.cpu(), r) for g, r in zip(got, ref)) and all(
            same_bits(g.cpu(), r) for g, r in zip(g_tab, r_tab))
        fail_flag = bool(got[-1])
        if want_fail is not None and fail_flag != want_fail:
            ok = False
        log(f"  hashprobe {name}: matched {int(got[2])}/{lkeys.shape[0]} "
            f"fail={fail_flag} exact={ok} (tol: bit-identical rowids, "
            f"table and fail) {'OK' if ok else 'FAIL'}")
        if not ok:
            fail(f"probe_rowids {name} disagrees with its plain version")
        return got

    big = 1 << 23
    # join 1 of sparse q3 at SF 1: lineitem probes orders (capacity 2^21,
    # 1,500,303 rows, ~40% before the order-date cut), H = 2^22
    j1 = hashprobe_case(big, 1 << 21, 1_500_303, 0.402, 0.4, gen)
    # ~600k live keys at load 0.14: with 4 attempts some 10^2 rows stay
    # homeless (fail set, as in the reference); 8 attempts place them all
    run_ranges("q3 join 1 (2^23 probe rows, H 2^22, 4 attempts)", *j1,
               1 << 22, 4)
    run_ranges("q3 join 1 (2^23 probe rows, H 2^22, 8 attempts)", *j1,
               1 << 22, 8, want_fail=False)
    # join 2: the join 1 output probes customer (capacity 2^18, 150,030
    # rows, 1 in 5 in the segment), H = 2^19
    j2 = hashprobe_case(big, 1 << 18, 150_030, 0.2, 0.2, gen)
    run_ranges("q3 join 2 (2^23 probe rows, H 2^19, 4 attempts)", *j2,
               1 << 19, 4, want_fail=False)
    # edges: extreme keys and nulls; a duplicated build key; homeless rows
    e_l, e_lv, e_r, e_lr = hashprobe_case(4096, 2048, 2048, 0.9, 0.5, gen)
    edges = torch.tensor([-(2 ** 63), 2 ** 63 - 1, 0, -1, -(2 ** 31)],
                         dtype=torch.int64, device=DEV)
    e_r[:5] = edges
    e_l[:5] = edges
    e_l[5:10] = edges
    e_lv[5:10] = False
    run_ranges("edges (INT64_MIN/MAX, 0, -1, -2^31, null probe keys)", e_l,
               e_lv, e_r, e_lr, 4096, 8)
    d_r, d_lr = e_r.clone(), e_lr.clone()
    d_r[100] = d_r[1500]
    d_lr[100] = d_lr[1500] = True
    run_ranges("duplicated build key", e_l, e_lv, d_r, d_lr, 4096, 4,
               want_fail=True)
    run_ranges("homeless rows (H 64, 1 attempt)", e_l, e_lv, e_r, e_lr, 64,
               1, want_fail=True)

    lkeys, lvalid, rkeys, live_r = j1
    tr, tk, _ = H.build_table(rkeys, live_r, 1 << 22, 4)
    ms = time_ms(lambda: H.probe_rowids(lkeys, lvalid, tr, tk, 4))
    plain = time_ms(lambda: H.probe_rowids_plain(lkeys, lvalid, tr, tk, 4))
    sorted_build = torch.sort(rkeys[live_r]).values
    lib = time_ms(lambda: torch.searchsorted(sorted_build, lkeys))
    n = lkeys.shape[0]
    # each probe row: key 8 B + validity 1 B read, rowid 4 B written; the
    # table (rowid 4 B + key 8 B per slot) read once
    nbytes = n * (8 + 1 + 4) + (1 << 22) * 12
    bnd, by = bound_ms(nbytes, 0, INT32_OPS_PER_S)
    log(f"  hashprobe time at q3 join 1 shape: kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, torch.searchsorted into the sorted build keys "
        f"{lib:.4f} ms, bound {bnd:.4f} ms ({by}), "
        f"{nbytes / ms / 1e6:.1f} GB/s")
    return {"name": "probe_rowids", "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib}


INT64_MAX = (1 << 63) - 1
INT64_MIN = -(1 << 63)
#: a NaN with a payload and the sign bit set (the kernel must still give
#: the canonical NaN)
NEG_NAN_BITS = 0xFFF8_0000_0000_0001 - (1 << 64)


Q8_SHAPE = "q8 (Exponential skew)"


def minmax_values(n, dtype, gen):
    """int64 values with the extremes, or doubles with NaN (two payloads),
    -0.0, 0.0 and +-inf sprinkled in."""
    if dtype == torch.int64:
        v = torch.randint(-(2 ** 62), 2 ** 62, (n,), generator=gen,
                          device=DEV, dtype=torch.int64)
        v[:4] = torch.tensor([INT64_MAX, INT64_MIN, 0, -1], dtype=torch.int64)
        return v
    v = torch.randn(n, generator=gen, device=DEV, dtype=torch.float64) * 1e6
    u = torch.rand(n, generator=gen, device=DEV)
    v = torch.where(u < 1e-3, float("nan"), v)
    v = torch.where((u >= 1e-3) & (u < 2e-3), -0.0, v)
    v = torch.where((u >= 2e-3) & (u < 3e-3), 0.0, v)
    v[:3] = torch.tensor([float("inf"), float("-inf"), 0.0],
                         dtype=torch.float64)
    v[3:4] = torch.tensor([NEG_NAN_BITS], dtype=torch.int64).view(
        torch.float64)
    return v


def minmax_edges(v, valid, gid, segs):
    """Rows 8..31 become edge segments ``segs`` = (all-NaN, all-null,
    -0.0 then 0.0, 0.0 then -0.0); for int64 the NaN segment holds the
    extremes instead."""
    s_nan, s_null, s_z1, s_z2 = segs
    rows = torch.arange(8, 32, device=DEV)
    gid[8:14], gid[14:20], gid[20:26], gid[26:32] = s_nan, s_null, s_z1, s_z2
    valid[8:32] = True
    valid[14:20] = False
    if v.dtype == torch.float64:
        v[8:14] = float("nan")
        v[20:26] = torch.where(rows[12:18] % 2 == 0, -0.0, 0.0).to(v.dtype)
        v[26:32] = torch.where(rows[18:24] % 2 == 0, 0.0, -0.0).to(v.dtype)
    else:
        v[8:14] = torch.tensor([INT64_MAX, INT64_MIN] * 3, dtype=torch.int64)


def exponential_keys(n, domain, gen):
    """ForeignKey(parent_rows=domain, distribution=Exponential()) of
    datagen.py, drawn on the card: floor(min(Exp(rate 4), 1-) * domain)."""
    u = torch.empty(n, device=DEV, dtype=torch.float64).exponential_(
        4.0, generator=gen).clamp_(max=1.0 - 2.0 ** -53)
    return (u * domain).to(torch.int64)


def minmax_shapes(gen, global_rows=10_000_000, q8_rows=2_500_000,
                  domain=250_000):
    """{name: (nrows, capacity, nseg, valid, gid, edge segments)} at the
    three shapes the main path gives the kernel."""
    from spark_rapids_tpu_torch.columnar import bucket_for
    shapes = {}
    # q2-style global aggregate over lineitem at SF 10: 10M rows in a
    # 2^24 bucket, all in segment 0 of the global layout's 8, half kept
    # by the filter; the edge segments use the padding slots 1-4
    cap, nrows = bucket_for(global_rows), global_rows
    live = torch.arange(cap, device=DEV) < nrows
    valid = live & (torch.rand(cap, generator=gen, device=DEV) < 0.5)
    gid = torch.zeros(cap, dtype=torch.int32, device=DEV)
    shapes["global (all rows in segment 0 of 8)"] = (
        nrows, cap, 8, valid, gid, (1, 2, 3, 4))
    # q8's inner group-by at SF 10: 2,500,000 orders in a 2^22 bucket,
    # o_custkey under the Exponential skew over 250,000 keys, gpad 2^18;
    # padding rows on the null slot 250,000 (never valid)
    cap, nrows, dom = bucket_for(q8_rows), q8_rows, domain
    gpad = 1 << dom.bit_length()  # the key domain + its null slot, padded
    live = torch.arange(cap, device=DEV) < nrows
    keys = exponential_keys(cap, dom, gen)
    gid = torch.where(live, keys, dom).to(torch.int32)
    shapes[Q8_SHAPE] = (nrows, cap, gpad, live.clone(), gid,
                        tuple(range(gpad - 4, gpad)))
    # the sort-segment path: the same keys sorted and densely ranked,
    # nseg = capacity, dead rows parked past it (never valid)
    srt = torch.sort(keys[:nrows]).values
    rank = torch.cumsum((srt != torch.roll(srt, 1)).to(torch.int64), 0)
    rank = rank - rank[0]
    rows = torch.arange(cap, device=DEV)
    gid = torch.where(live, torch.cat([rank, rank.new_zeros(cap - nrows)]),
                      cap + rows).to(torch.int32)
    ng = int(rank[-1]) + 1
    shapes["sort-segment (nseg = capacity, sorted gid)"] = (
        nrows, cap, cap, live.clone(), gid, (ng, ng + 1, ng + 2, ng + 3))
    return shapes


def check_minmax(seed: int = 3, **shape_args) -> dict:
    """fused_minmax against its plain version at the main path's three
    shapes, on inputs from its own generator (``seed``)."""
    from spark_rapids_tpu_torch.kernels.segreduce import (
        _f64_keys,
        fused_minmax,
        fused_minmax_plain,
    )
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    times = {}
    for name, (nrows, cap, nseg, valid0, gid0, segs) in \
            minmax_shapes(gen, **shape_args).items():
        for dtype in (torch.int64, torch.float64):
            v = minmax_values(cap, dtype, gen)
            valid, gid = valid0.clone(), gid0.clone()
            minmax_edges(v, valid, gid, segs)
            for is_min in (True, False):
                a = fused_minmax(is_min, v, valid, gid, nseg)
                b = fused_minmax(is_min, v, valid, gid, nseg)
                ref = fused_minmax_plain(is_min, v, valid, gid, nseg)
                torch.cuda.synchronize()
                ok = same_bits(a, b) and same_bits(a, ref)
                if dtype == torch.float64:
                    nan = a[segs[0]].view(torch.int64)
                    ok = ok and int(nan) == 0x7FF8_0000_0000_0000
                    z1, z2 = (a[list(segs[2:])].view(torch.int64)
                              .tolist())
                    zero = -(1 << 63) if is_min else 0
                    ok = ok and z1 == z2 == zero
                what = (f"{name} {cap} rows {nseg} segments "
                        f"{str(dtype)[6:]} "
                        f"{'min' if is_min else 'max'}")
                log(f"  minmax {what}: exact={ok} (tol: bit-identical to "
                    f"the plain version and across two launches; NaN "
                    f"canonical, -0.0 < 0.0) {'OK' if ok else 'FAIL'}")
                if not ok:
                    fail(f"fused_minmax {what} disagrees with its plain "
                         "version")
        # times of a double max (q8's aggregate)
        v = minmax_values(cap, torch.float64, gen)
        valid, gid = valid0, gid0
        ms = time_ms(lambda: fused_minmax(False, v, valid, gid, nseg))
        plain = time_ms(lambda: fused_minmax_plain(False, v, valid, gid,
                                                   nseg))
        use = valid & (gid >= 0) & (gid < nseg)
        k_use, g_use = _f64_keys(v)[use], gid[use].to(torch.int64)
        lib_out = torch.full((nseg,), INT64_MIN, dtype=torch.int64,
                             device=DEV)
        lib = time_ms(lambda: lib_out.scatter_reduce_(
            0, g_use, k_use, "amax", include_self=True))
        # what the function needs: every row's validity (1 B), a valid
        # row's gid (4 B), the value (8 B) of a valid row inside the
        # segments, each segment's result (8 B) written once; one compare
        # per used row
        n_valid, n_use = int(valid.sum()), int(use.sum())
        nbytes = cap + n_valid * 4 + n_use * 8 + nseg * 8
        bnd, by = bound_ms(nbytes, n_use, INT32_OPS_PER_S)
        times[name] = (ms, plain, lib, bnd, by)
        log(f"  minmax time at {name} (f64 max, {cap} rows, {nseg} "
            f"segments, {n_use} valid rows): kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, scatter_reduce_ amax on the valid rows' int64 keys {lib:.4f} "
            f"ms, bound {bnd:.4f} ms ({by}), {nbytes / ms / 1e6:.1f} GB/s")
    ms, plain, lib, bnd, by = times[Q8_SHAPE]
    return {"name": "fused_minmax", "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib}


# ---------------------------------------------------------------------------
# phase 4: q1 end to end
# ---------------------------------------------------------------------------

def q1_oracle(table):
    """q1 in plain numpy: rows sorted by (flag, status) with exact counts."""
    from spark_rapids_tpu_torch.models.tpch import Q1_CUTOFF_DAYS
    col = {n: c.data for n, c in zip(table.names, table.columns)}
    m = col["l_shipdate"] <= Q1_CUTOFF_DAYS
    rf_u, rf_i = np.unique(col["l_returnflag"][m].astype(str),
                           return_inverse=True)
    ls_u, ls_i = np.unique(col["l_linestatus"][m].astype(str),
                           return_inverse=True)
    g = rf_i * len(ls_u) + ls_i
    ng = len(rf_u) * len(ls_u)
    qty, price = col["l_quantity"][m], col["l_extendedprice"][m]
    disc, tax = col["l_discount"][m], col["l_tax"][m]
    dp = price * (1.0 - disc)
    cnt = np.bincount(g, minlength=ng)

    def s(v):
        return np.bincount(g, weights=v, minlength=ng)

    present = np.nonzero(cnt)[0]
    n = np.maximum(cnt, 1)
    cols = {
        "l_returnflag": rf_u[present // len(ls_u)].astype(object),
        "l_linestatus": ls_u[present % len(ls_u)].astype(object),
        "sum_qty": s(qty)[present], "sum_base_price": s(price)[present],
        "sum_disc_price": s(dp)[present],
        "sum_charge": s(dp * (1.0 + tax))[present],
        "avg_qty": (s(qty) / n)[present], "avg_price": (s(price) / n)[present],
        "avg_disc": (s(disc) / n)[present],
        "count_order": cnt[present].astype(np.int64),
    }
    return cols


def check_q1_result(got, oracle) -> None:
    if list(got.names) != list(oracle):
        fail(f"q1 columns {got.names}")
    for name, c in zip(got.names, got.columns):
        want = oracle[name]
        if len(c.data) != len(want) or not c.validity.all():
            fail(f"q1 {name}: {len(c.data)} rows / validity, want "
                 f"{len(want)} valid rows")
        if c.data.dtype.kind == "f":
            if not np.isfinite(c.data).all() or not np.allclose(
                    c.data, want, rtol=1e-9, atol=0):
                fail(f"q1 {name}: {c.data} vs oracle {want} (rtol 1e-9)")
        elif not (c.data == want).all() or c.data.dtype != want.dtype:
            fail(f"q1 {name}: {c.data} vs oracle {want} (exact)")


def run_q1(rows: int, profile_dir) -> dict:
    from spark_rapids_tpu_torch import kernels as K
    from spark_rapids_tpu_torch.models.tpch import lineitem_table, q1_dataframe
    from spark_rapids_tpu_torch.session import TorchSession

    t0 = time.perf_counter()
    table = lineitem_table(rows, seed=0)
    log(f"  generated {rows} lineitem rows in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    oracle = q1_oracle(table)
    session = TorchSession()
    if session.device.type != DEV.type:
        fail(f"session device {session.device}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    K.reset_launch_counts()
    syncs = sort_trace_start()
    t0 = time.perf_counter()
    got = q1_dataframe(session, table).collect_table()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = K.launch_counts()
    log(f"  q1 launches during the query: {launches}")
    sort_trace_end("q1", syncs)
    for name in ("onehot_partials", "gather_compact", "sort_with_payload"):
        if launches[name] < 1:
            fail(f"q1 did not launch {name}")
    check_q1_result(got, oracle)
    log(f"  q1 result matches the numpy oracle ({got.num_rows} groups; keys "
        "and counts exact, floats rtol 1e-9)")

    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = q1_dataframe(session, table).collect_table()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        check_q1_result(again, oracle)
    peak = torch.cuda.max_memory_allocated()
    log(f"  q1 at {rows} rows: cold {cold * 1e3:.1f} ms (host dictionary "
        f"encoding + upload included), warm median "
        f"{statistics.median(warm) * 1e3:.2f} ms (scan cache hit; runs "
        f"{[round(w * 1e3, 2) for w in warm]}), peak device memory "
        f"{peak / 2**30:.2f} GiB")
    if profile_dir:
        profile_q1(session, table, profile_dir)
    return launches


def profile_q1(session, table, out_dir) -> None:
    from spark_rapids_tpu_torch.models.tpch import q1_dataframe
    profile_run("q1", lambda: q1_dataframe(session, table).collect_table(),
                out_dir)


#: the radix sort's kernels (csrc/sort.cu), for its share of device time
SORT_KERNELS = ("survey_bits", "pack_hist", "onesweep_pass", "finish_rows",
                "sort_small")


def trace_times(path):
    """(device busy ms, span ms from the first device event to the end of
    the last, sort kernels ms) of a chrome trace's kernels, copies and
    memsets."""
    with open(path) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        fail(f"{path}: no device event in the trace")
    busy = sum(e["dur"] for e in dev) / 1e3
    span = (max(e["ts"] + e["dur"] for e in dev)
            - min(e["ts"] for e in dev)) / 1e3
    sort = sum(e["dur"] for e in dev
               if any(k in e["name"] for k in SORT_KERNELS)) / 1e3
    return busy, span, sort


def profile_run(name, run, out_dir) -> None:
    """One warm run of ``run`` under torch.profiler: the table of device
    time by operator and a chrome trace under ``out_dir``, and the run's
    device busy time, idle share and sort share from that trace."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    table_txt = prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=40)
    tag = "_".join("".join(ch if ch.isalnum() else " "
                           for ch in name).split())
    with open(os.path.join(out_dir, f"{tag}_profile.txt"), "w") as f:
        f.write(table_txt)
    trace = os.path.join(out_dir, f"{tag}_trace.json")
    prof.export_chrome_trace(trace)
    busy, span, sort = trace_times(trace)
    log(f"  {name}: device busy {busy:.3f} ms over a span of {span:.3f} ms "
        f"({100 * (1 - busy / span):.1f}% idle); sort kernels {sort:.3f} ms "
        f"({100 * sort / busy:.1f}% of busy)")
    log(f"  profile of one warm {name} run (top by device time):")
    for line in table_txt.splitlines()[:25]:
        log("    " + line)


# ---------------------------------------------------------------------------
# phase 5: q3 end to end, dense and sparse keys
# ---------------------------------------------------------------------------

Q3_SPARSE_KEYS = ("c_custkey", "o_orderkey", "o_custkey", "l_orderkey")


def sparse_form(table):
    """The table with its q3 key columns mapped k -> (k * 0x9E3779B1)
    mod 2^40 (a bijection: unique keys stay unique, but their range no
    longer fits a direct-address table)."""
    from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
    cols = []
    for name, c in zip(table.names, table.columns):
        if name in Q3_SPARSE_KEYS:
            c = HostColumn(c.dtype, (c.data.astype(np.int64) * 0x9E3779B1)
                           & ((1 << 40) - 1), c.validity)
        cols.append(c)
    return HostTable(table.names, cols)


def q3_oracle(cust, orders, lineitem):
    """q3 in plain numpy: (l_orderkey, revenue, n) of the top 10 by
    revenue, ties in ascending key order."""
    from spark_rapids_tpu_torch.models.tpch import Q3_DATE

    def cols(t):
        return {n: c.data for n, c in zip(t.names, t.columns)}

    c, o, li = cols(cust), cols(orders), cols(lineitem)
    ckeys = c["c_custkey"][c["c_mktsegment"].astype(str) == "BUILDING"]
    om = (o["o_orderdate"] < Q3_DATE) & np.isin(o["o_custkey"], ckeys)
    lm = (li["l_shipdate"] > Q3_DATE) & np.isin(li["l_orderkey"],
                                                o["o_orderkey"][om])
    keys, inv = np.unique(li["l_orderkey"][lm], return_inverse=True)
    vol = li["l_extendedprice"][lm] * (1.0 - li["l_discount"][lm])
    rev = np.bincount(inv, weights=vol, minlength=len(keys))
    cnt = np.bincount(inv, minlength=len(keys)).astype(np.int64)
    top = np.argsort(-rev, kind="stable")[:10]
    return {"l_orderkey": keys[top], "revenue": rev[top], "n": cnt[top]}


def check_q3_result(got, oracle, what) -> None:
    if list(got.names) != list(oracle):
        fail(f"{what} columns {got.names}")
    for name, c in zip(got.names, got.columns):
        want = oracle[name]
        if len(c.data) != len(want) or not c.validity.all():
            fail(f"{what} {name}: {len(c.data)} rows / validity, want "
                 f"{len(want)} valid rows")
        if c.data.dtype.kind == "f":
            if not np.isfinite(c.data).all() or not np.allclose(
                    c.data, want, rtol=1e-9, atol=0):
                fail(f"{what} {name}: {c.data} vs oracle {want} (rtol 1e-9)")
        elif not (c.data == want).all() or c.data.dtype != want.dtype:
            fail(f"{what} {name}: {c.data} vs oracle {want} (exact)")


def run_q3_form(what, tables, oracle, conf, expect, profile_dir) -> dict:
    """Cold run (replays counted), three warm runs, and one more warm run
    between launch-counter reads; every result against the oracle."""
    from spark_rapids_tpu_torch import kernels as K
    from spark_rapids_tpu_torch.models.tpch import q3_dataframe
    from spark_rapids_tpu_torch.runtime import speculation
    from spark_rapids_tpu_torch.session import TorchSession

    # the blocklist is process-wide and both forms share the join sites
    speculation.clear_blocklist()
    session = TorchSession(conf)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = q3_dataframe(session, *tables).collect_table()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    cold_m = session.last_metrics()
    check_q3_result(got, oracle, what)
    warm = []
    revenue_bits = {got.columns[1].data.tobytes()}
    for _ in range(3):
        t0 = time.perf_counter()
        again = q3_dataframe(session, *tables).collect_table()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        check_q3_result(again, oracle, what)
        revenue_bits.add(again.columns[1].data.tobytes())
    K.reset_launch_counts()
    syncs = sort_trace_start()
    again = q3_dataframe(session, *tables).collect_table()
    torch.cuda.synchronize()
    launches = K.launch_counts()
    sort_trace_end(what, syncs)
    warm_m = session.last_metrics()
    check_q3_result(again, oracle, what)
    peak = torch.cuda.max_memory_allocated()
    log(f"  {what}: cold {cold * 1e3:.1f} ms ({cold_m['speculationReplays']} "
        f"replays), warm median {statistics.median(warm) * 1e3:.2f} ms (runs "
        f"{[round(w * 1e3, 2) for w in warm]}), peak device memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"  {what}: cold metrics {cold_m}")
    log(f"  {what}: warm metrics {warm_m}")
    log(f"  {what}: launches during one warm query: {launches}")
    log(f"  {what}: result matches the numpy oracle (keys and counts exact, "
        "revenue rtol 1e-9); the revenue bits of the cold and 3 warm runs "
        f"are {'identical' if len(revenue_bits) == 1 else 'NOT identical'} "
        "(f64 index_add_ adds in atomic order)")
    if warm_m["speculationReplays"] != 0:
        fail(f"{what}: a warm run replayed")
    observed = dict(launches, speculationReplays=cold_m["speculationReplays"])
    for key, allowed in expect.items():
        if observed[key] not in allowed:
            fail(f"{what}: {key} = {observed[key]}, expected one of {allowed}")
    for name in ("gather_compact", "sort_with_payload"):
        if launches[name] < 1:
            fail(f"{what} did not launch {name}")
    if profile_dir:
        profile_run(what, lambda: q3_dataframe(session, *tables)
                    .collect_table(), profile_dir)
    return launches


def run_q3(rows: int, profile_dir) -> int:
    """Dense q3, sparse q3 with the default 4 hash-probe attempts, and
    sparse q3 with 8. Returns probe_rowids' launches in one warm run of
    the 8-attempt sparse form (the form in which both joins probe)."""
    from spark_rapids_tpu_torch.models.tpch import q3_tables
    t0 = time.perf_counter()
    dense = q3_tables(rows, seed=0)
    sparse = tuple(sparse_form(t) for t in dense)
    o_dense, o_sparse = q3_oracle(*dense), q3_oracle(*sparse)
    log(f"  generated q3 tables ({rows} lineitem, {dense[1].num_rows} "
        f"orders, {dense[0].num_rows} customer rows) and both oracles in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    # dense: both joins direct. Sparse: the direct joins fail (one
    # replay); a join whose hash table leaves a build row homeless replays
    # once more onto the sort-based probe, which 4 attempts may do at SF 1
    run_q3_form("q3 dense", dense, o_dense, None,
                {"speculationReplays": (0,), "probe_rowids": (0,),
                 "sort_with_payload": (1,)},
                profile_dir)
    default = run_q3_form("q3 sparse", sparse, o_sparse, None,
                          {"speculationReplays": (1, 2),
                           "probe_rowids": (2, 4),
                           "sort_with_payload": (2, 4)}, profile_dir)
    eight = run_q3_form(
        "q3 sparse, 8 attempts", sparse, o_sparse,
        {"spark.rapids.tpu.kernels.hashprobe.attempts": "8"},
        {"speculationReplays": (1,), "probe_rowids": (4,),
         "sort_with_payload": (2,)}, None)
    log(f"  probe_rowids launches per warm sparse q3: "
        f"{default['probe_rowids']} with 4 attempts, {eight['probe_rowids']} "
        "with 8")
    return eight["probe_rowids"]


# ---------------------------------------------------------------------------
# phase 6: the corpus's q2 and q8, MIN/MAX group-bys and global aggregates
# ---------------------------------------------------------------------------

def host_cols(t):
    return {n: c.data for n, c in zip(t.names, t.columns)}


def sparse_custkey(orders):
    """The orders table with o_custkey mapped by ``sparse_keys``: its range
    no longer fits the no-sort layout, so the group-by takes the
    sort-segment path."""
    from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
    cols = []
    for name, c in zip(orders.names, orders.columns):
        if name == "o_custkey":
            c = HostColumn(c.dtype, sparse_keys(torch.from_numpy(
                c.data.astype(np.int64))).numpy(), c.validity)
        cols.append(c)
    return HostTable(orders.names, cols)


def grouped_oracle(keys, values):
    """{column: per-key MIN/MAX} over the distinct keys in ascending order,
    in numpy (reduceat over the key-sorted rows)."""
    order = np.argsort(keys, kind="stable")
    uniq, starts = np.unique(keys[order], return_index=True)
    out = {"key": uniq}
    for name, (fn, v) in values.items():
        out[name] = fn.reduceat(v[order], starts)
    return out


def check_grouped(got, want, what) -> None:
    """The port's group-by output sorted by its key against the oracle:
    keys, MIN and MAX bit for bit, every value valid."""
    cols = host_cols(got)
    key = cols[got.names[0]]
    if len(key) != len(want["key"]):
        fail(f"{what}: {len(key)} groups, oracle {len(want['key'])}")
    order = np.argsort(key, kind="stable")
    if not (key[order] == want["key"]).all():
        fail(f"{what}: group keys differ from the oracle")
    for name in got.names[1:]:
        c = got.columns[got.names.index(name)]
        if not c.validity.all():
            fail(f"{what} {name}: null results")
        g, w = c.data[order], want[name]
        if g.dtype != w.dtype or g.tobytes() != w.tobytes():
            fail(f"{what} {name}: differs from the oracle (bitwise)")


def check_scalars(got, want, what, rtol=0.0) -> None:
    """One output row against the oracle's scalars: exact, or within
    ``rtol`` where a sum is compared."""
    if got.num_rows != 1:
        fail(f"{what}: {got.num_rows} rows, want 1")
    for name, w in want.items():
        c = got.columns[got.names.index(name)]
        g = c.data[0]
        if not c.validity[0]:
            fail(f"{what} {name}: null")
        if rtol:
            ok = np.isfinite(g) and abs(g - w) <= rtol * abs(w)
        else:
            ok = np.asarray(g).tobytes() == \
                np.asarray(w, c.data.dtype).tobytes()
        if not ok:
            fail(f"{what} {name}: {g!r} vs oracle {w!r}"
                 f"{f' (rtol {rtol})' if rtol else ' (exact)'}")


def corpus_cases(session, tables, sparse_orders):
    """{name: (() -> DataFrame, oracle check, expected fused_minmax
    launches in one warm run)}."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.models.corpus import build_queries
    from spark_rapids_tpu_torch.plan import from_host_table

    q = build_queries(session, tables)
    o, li = host_cols(tables["orders"]), host_cols(tables["lineitem"])
    so = host_cols(sparse_orders)
    n_custs = len(np.unique(o["o_custkey"]))
    m = (li["l_discount"] > 0.05) & (li["l_quantity"] < 25)
    q2_total = float(np.sum(li["l_extendedprice"][m] * li["l_discount"][m]))
    inner = grouped_oracle(o["o_custkey"], {
        "m": (np.maximum, o["o_totalprice"])})
    inner_sparse = grouped_oracle(so["o_custkey"], {
        "m": (np.maximum, so["o_totalprice"])})
    mm = grouped_oracle(o["o_custkey"], {
        "min_key": (np.minimum, o["o_orderkey"]),
        "max_key": (np.maximum, o["o_orderkey"]),
        "min_price": (np.minimum, o["o_totalprice"]),
        "max_price": (np.maximum, o["o_totalprice"])})
    glob = {"max_price": li["l_extendedprice"].max(),
            "min_price": li["l_extendedprice"].min(),
            "max_key": li["l_orderkey"].max()}

    def inner_q(t):
        return lambda: from_host_table(t, session).group_by(
            "o_custkey").agg(F.max("o_totalprice").alias("m"))

    return {
        "q8": (q["q8"], lambda g: check_scalars(
            g, {"n_custs": np.int64(n_custs)}, "q8"), 1),
        "q2": (q["q2"], lambda g: check_scalars(
            g, {"total": q2_total}, "q2", rtol=1e-9), 0),
        "q8 inner": (inner_q(tables["orders"]), lambda g: check_grouped(
            g, inner, "q8 inner"), 1),
        "q8 inner, sparse keys": (inner_q(sparse_orders),
                                  lambda g: check_grouped(
                                      g, inner_sparse, "q8 inner sparse"),
                                  1),
        "min/max group-by": (
            lambda: from_host_table(tables["orders"], session).group_by(
                "o_custkey").agg(
                F.min("o_orderkey").alias("min_key"),
                F.max("o_orderkey").alias("max_key"),
                F.min("o_totalprice").alias("min_price"),
                F.max("o_totalprice").alias("max_price")),
            lambda g: check_grouped(g, mm, "min/max group-by"), 4),
        "global min/max": (
            lambda: from_host_table(tables["lineitem"], session).agg(
                F.max("l_extendedprice").alias("max_price"),
                F.min("l_extendedprice").alias("min_price"),
                F.max("l_orderkey").alias("max_key")),
            lambda g: check_scalars(g, glob, "global min/max"), 3),
    }


#: sorts in one warm run of a phase-6 query (0 where not listed): only
#: the sort-segment aggregate sorts
CORPUS_SORTS = {"q8 inner, sparse keys": 1}


def run_corpus(sf: float, seed: int, profile_dir) -> int:
    """Every phase-6 query: a cold run (replays counted), three warm runs,
    and one more warm run between launch-counter reads; each result
    against its oracle. Returns fused_minmax's launches in one warm q8."""
    from spark_rapids_tpu_torch import kernels as K
    from spark_rapids_tpu_torch.models.corpus import corpus_tables
    from spark_rapids_tpu_torch.session import TorchSession

    t0 = time.perf_counter()
    tables = corpus_tables(sf, seed)
    sparse_orders = sparse_custkey(tables["orders"])
    session = TorchSession()
    cases = corpus_cases(session, tables, sparse_orders)
    log(f"  generated scale_test_specs({sf}) seed {seed}: "
        f"{tables['orders'].num_rows} orders, "
        f"{tables['lineitem'].num_rows} lineitem rows (the columns q2 and "
        f"q8 read) and the oracles in {time.perf_counter() - t0:.2f} s "
        "(host)")
    q8_launches = None
    for name, (build, check, want_minmax) in cases.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = build().collect_table()
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        replays = session.last_metrics()["speculationReplays"]
        check(got)
        warm = []
        for _ in range(3):
            t0 = time.perf_counter()
            again = build().collect_table()
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
            check(again)
        K.reset_launch_counts()
        syncs = sort_trace_start()
        again = build().collect_table()
        torch.cuda.synchronize()
        launches = K.launch_counts()
        sort_trace_end(name, syncs)
        warm_replays = session.last_metrics()["speculationReplays"]
        check(again)
        peak = torch.cuda.max_memory_allocated()
        log(f"  {name}: cold {cold * 1e3:.1f} ms ({replays} replays), warm "
            f"median {statistics.median(warm) * 1e3:.2f} ms (runs "
            f"{[round(w * 1e3, 2) for w in warm]}), peak device memory "
            f"{peak / 2**30:.2f} GiB, {got.num_rows} rows")
        log(f"  {name}: launches during one warm query: {launches}")
        log(f"  {name}: result matches the numpy oracle (MIN, MAX and "
            "counts exact, sums rtol 1e-9)")
        if warm_replays != 0:
            fail(f"{name}: a warm run replayed")
        if launches["fused_minmax"] != want_minmax:
            fail(f"{name}: fused_minmax launched {launches['fused_minmax']} "
                 f"times, expected {want_minmax}")
        want_sorts = CORPUS_SORTS.get(name, 0)
        if launches["sort_with_payload"] != want_sorts:
            fail(f"{name}: sort_with_payload launched "
                 f"{launches['sort_with_payload']} times, expected "
                 f"{want_sorts}")
        if name == "q8":
            q8_launches = launches["fused_minmax"]
        if profile_dir:
            profile_run(name, lambda: build().collect_table(), profile_dir)
    return q8_launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=6_001_215,
                    help="lineitem rows for q1 and q3 (default: TPC-H SF 1)")
    ap.add_argument("--sf", type=float, default=10.0,
                    help="scale factor of the corpus tables of phase 6 "
                         "(default 10)")
    ap.add_argument("--seed", type=int, default=7,
                    help="seed of the corpus tables of phase 6 (default 7)")
    ap.add_argument("--profile", default=None,
                    help="directory for torch.profiler tables and traces of "
                         "one warm run of q1, of each q3 form and of each "
                         "phase-6 query")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from spark_rapids_tpu_torch.columnar import bucket_for
    from spark_rapids_tpu_torch.kernels.build import build

    log("phase 1: the card")
    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    log(f"  {card}")
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"capability {cap} devices {torch.cuda.device_count()}")
    if cap != (9, 0):
        fail(f"compute capability {cap}, want (9, 0)")

    log("phase 2: build the kernels")
    t0 = time.perf_counter()
    reports = build()
    log(f"  built {sorted(reports)} in {time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"    {name}: {line.strip()}")

    log("phase 3: kernels against their plain versions")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    capacity = bucket_for(args.rows)
    rows = [check_segreduce(capacity, args.rows, gen), check_minmax(),
            check_compact(gen), check_sort(gen), check_hashprobe(gen)]

    log("phase 4: TPC-H q1 through TorchSession")
    launches = run_q1(args.rows, args.profile)

    log("phase 5: TPC-H q3 through TorchSession, dense and sparse keys")
    launches["probe_rowids"] = run_q3(args.rows, args.profile)

    log("phase 6: the corpus's q2 and q8 and MIN/MAX through TorchSession")
    launches["fused_minmax"] = run_corpus(args.sf, args.seed, args.profile)

    for r in rows:
        r.update(route="cuda", source=SOURCES[r["name"]],
                 replaces=TPU_KERNELS[r["name"]],
                 launches=launches[r["name"]])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
