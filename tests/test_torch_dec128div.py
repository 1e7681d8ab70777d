"""DECIMAL128 division: the kernel's plain version
(``kernels/decimal.py::dec128_divide_plain``, what the wrapper runs for a
CPU tensor) and DecimalDivide, DecimalRemainder, DecimalPmod and ``div``
over DECIMAL128 operands or results through ``TorchSession`` on the CPU.

- ``chip_smoke.dec128_edges`` (the edge set phase 12 also runs on the
  card: zero divisors, negative operands of each sign, quotients at
  10^38 - 1 and 10^38, decimal(38,0) / decimal(38,38)'s 273-bit
  numerator, 256-bit remainder operands) against Python's ``decimal``
  module with ROUND_HALF_UP (the quotient) and Python ints (the
  remainders): exact.
- The operators against the JAX package's ``TpuSession`` on the same
  numpy inputs (``scale_test.tables_differ``, bitwise) with positive
  divisors: the reference computes every DECIMAL128 quotient on its host,
  whose ``_round_half_up_div`` rounds toward the divisor's sign.
  decimal(38,0) / decimal(38,38) (up = 44) only against the ``decimal``
  oracle: the reference's host form reads 10^44 from a table that ends at
  10^38 and raises IndexError.
- Negative divisors against the ``decimal`` oracle, with the deviation
  pinned: a HALF_UP tie over a negative divisor rounds away from zero in
  the port and in Spark, toward the divisor's sign in the reference."""

import decimal

import numpy as np
import pytest
import torch

import chip_smoke
from scale_test import tables_differ
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.ops import arithmetic as JA
from spark_rapids_tpu.ops.expr import col as jcol
from spark_rapids_tpu.plan import from_host_table as jfrom
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.kernels import decimal as KD
from spark_rapids_tpu_torch.ops import arithmetic as TA
from spark_rapids_tpu_torch.ops.expr import col as tcol
from spark_rapids_tpu_torch.plan import from_host_table as tfrom
from spark_rapids_tpu_torch.session import TorchSession

M64 = (1 << 64) - 1


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _streams(values):
    hi = torch.tensor([v >> 64 for v in values], dtype=torch.int64)
    lo = torch.tensor([(v & M64) - (1 << 64) if v & M64 >= 1 << 63
                       else v & M64 for v in values], dtype=torch.int64)
    return hi, lo


def _decimal_oracle(mode, a, b, pow_a, pow_b, precision):
    """Python's ``decimal`` (ROUND_HALF_UP: half away from zero) for the
    quotient, Python ints for the remainders; None for null."""
    big_a, big_b = a * pow_a, b * pow_b
    if big_b == 0:
        return None
    if mode == "divide":
        with decimal.localcontext() as ctx:
            ctx.prec = 200
            v = int((decimal.Decimal(big_a) / decimal.Decimal(big_b))
                    .quantize(decimal.Decimal(1),
                              rounding=decimal.ROUND_HALF_UP))
    else:
        r = abs(big_a) % abs(big_b)
        v = -r if big_a < 0 else r
        if mode == "pmod" and v != 0 and (v < 0) != (big_b < 0):
            v += big_b
    return v if abs(v) < 10 ** precision else None


def _run(mode, pairs, pow_a, pow_b, precision, valid=None):
    a_hi, a_lo = _streams([a for a, _ in pairs])
    b_hi, b_lo = _streams([b for _, b in pairs])
    if valid is None:
        valid = torch.ones(len(pairs), dtype=torch.bool)
    hi, lo, ok = KD.dec128_divide(mode, a_hi, a_lo, b_hi, b_lo, valid,
                                  pow_a, pow_b, precision)
    return [((h << 64) | (l & M64)) if v else None
            for h, l, v in zip(hi.tolist(), lo.tolist(), ok.tolist())]


@pytest.mark.parametrize("case", range(len(chip_smoke.dec128_edges())),
                         ids=[e[5] for e in chip_smoke.dec128_edges()])
def test_edge_set_matches_python_decimal(case):
    mode, pairs, pow_a, pow_b, prec, _ = chip_smoke.dec128_edges()[case]
    got = _run(mode, pairs, pow_a, pow_b, prec)
    want = [_decimal_oracle(mode, a, b, pow_a, pow_b, prec)
            for a, b in pairs]
    assert got == want
    # the chip script's oracle is the same function
    assert want == [chip_smoke.dec128_oracle(mode, a, b, pow_a, pow_b, prec)
                    for a, b in pairs]
    if "273-bit" in chip_smoke.dec128_edges()[case][5] or pow_a == 10 ** 44:
        assert (10 ** 38 - 1) * pow_a >= 1 << 272


def test_random_operands_and_nulls_match_python_decimal():
    """Seeded operands of every magnitude (both signs), a null on every
    seventh row, each mode at the powers of S1's and the widest shapes."""
    rng = np.random.default_rng(5)

    def value():
        digits = int(rng.integers(0, 39))
        v = int(rng.integers(0, 10 ** min(digits, 18) + 1))
        if digits > 18:
            v = v * 10 ** (digits - 18) + int(rng.integers(0, 10 ** 18))
        v = min(v, 10 ** 38 - 1)
        return -v if rng.random() < 0.5 else v

    pairs = [(value(), value()) for _ in range(300)]
    valid = torch.ones(len(pairs), dtype=torch.bool)
    valid[::7] = False
    for mode, pow_a, pow_b, prec in (("divide", 10 ** 6, 1, 38),
                                     ("divide", 10 ** 44, 1, 38),
                                     ("remainder", 1, 10 ** 2, 17),
                                     ("remainder", 10 ** 38, 1, 38),
                                     ("pmod", 1, 10 ** 38, 38)):
        got = _run(mode, pairs, pow_a, pow_b, prec, valid)
        want = [None if not v else _decimal_oracle(mode, a, b, pow_a, pow_b,
                                                   prec)
                for (a, b), v in zip(pairs, valid.tolist())]
        assert got == want, mode


def test_wrapper_checks_its_arguments_and_refuses_other_devices():
    """The wrapper takes its plain version only for CPU tensors: a tensor
    elsewhere launches or raises; bad modes, powers and types raise."""
    x = torch.zeros(4, dtype=torch.int64)
    ok = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="mode"):
        KD.dec128_divide("mod", x, x, x, x, ok, 1, 1, 38)
    with pytest.raises(ValueError, match="powers"):
        KD.dec128_divide("divide", x, x, x, x, ok, 10 ** 45, 1, 38)
    with pytest.raises(ValueError, match="powers"):
        KD.dec128_divide("remainder", x, x, x, x, ok, 1, 10 ** 39, 38)
    with pytest.raises(TypeError, match="int64"):
        KD.dec128_divide("divide", x.to(torch.int32), x, x, x, ok, 1, 1, 38)
    meta = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        KD.dec128_divide("divide", meta, meta, meta, meta,
                         ok.to("meta"), 1, 1, 38)
    before = KD.dec128_divide.launches
    KD.dec128_divide("divide", x, x, x, x, ok, 1, 1, 38)
    assert KD.dec128_divide.launches == before  # the plain version


def _select_both(table, exprs):
    names, types, arrays = table
    ref = jfrom(JHostTable(list(names), [
        JHostColumn(JT.parse_type(ty), d, np.asarray(v, dtype=bool))
        for ty, (d, v) in zip(types, arrays)]), TpuSession()).select(
        *[e.alias(n) for n, e in exprs(jcol, JA)]).collect_table()
    got = tfrom(host_table_from_arrays(*table),
                TorchSession(device="cpu")).select(
        *[e.alias(n) for n, e in exprs(tcol, TA)]).collect_table()
    names, types, arrays = got.to_arrays()
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(ty), d, np.asarray(v, dtype=bool))
        for ty, (d, v) in zip(types, arrays)]), ref


def _column(type_name, vals):
    dt = JT.parse_type(type_name)
    return np.array(vals, dtype=object if dt.precision > 18 else np.int64)


#: (dividend, divisor) types: S1's quotient, S2's ratio of sums, the
#: widest numerator, 256-bit remainder operands, mixed DECIMAL64 and
#: DECIMAL128, a bigint (decimal(20,0))
WIDE_PAIRS = [("decimal(32,4)", "decimal(15,2)"),
              ("decimal(38,4)", "decimal(38,4)"),
              ("decimal(38,0)", "decimal(38,38)"),
              ("decimal(38,38)", "decimal(38,0)"),
              ("decimal(18,0)", "decimal(18,10)"),
              ("decimal(25,5)", "decimal(9,2)"),
              ("bigint", "decimal(12,2)")]


@pytest.mark.parametrize("lt,rt", WIDE_PAIRS)
def test_operators_match_the_reference_on_positive_divisors(lt, rt):
    """Divide, Remainder, Pmod and ``div`` bit for bit with the reference,
    every divisor positive (dividends of both signs, nulls, zeros)."""
    rng = np.random.default_rng(WIDE_PAIRS.index((lt, rt)))
    n = 160

    def draw(type_name, positive):
        dt = JT.parse_type(type_name)
        p = dt.precision if isinstance(dt, JT.DecimalType) else 18
        out = []
        for _ in range(n):
            digits = int(rng.integers(1, p + 1))
            v = int(rng.integers(1, 10 ** min(digits, 18)))
            if digits > 18:
                v = v * 10 ** (digits - 18) + int(rng.integers(0, 10 ** 18))
            out.append(v if positive or rng.random() < 0.5 else -v)
        return out

    a, b = draw(lt, False), draw(rt, True)
    a[:3] = [0, 1, -1]
    b[3] = 0  # a zero divisor: null
    va, vb = np.ones(n, bool), np.ones(n, bool)
    va[5::11] = False
    vb[7::13] = False
    col_a = (np.array(a, dtype=np.int64) if lt == "bigint"
             else _column(lt, a))
    table = (["a", "b"], [lt, rt], [(col_a, va), (_column(rt, b), vb)])
    # the reference's host quotient reads 10^up from a table that ends at
    # 10^38: the widest numerator (up = 44) has only the decimal oracle
    wide = lt == "decimal(38,0)" and rt == "decimal(38,38)"
    got, ref = _select_both(table, lambda c, A: [
        ("r", c("a") % c("b")), ("p", A.Pmod(c("a"), c("b")))] + ([] if wide
                                                                  else [
        ("q", c("a") / c("b")), ("d", A.IntegralDivide(c("a"), c("b")))]))
    assert [c.dtype for c in got.columns] == [c.dtype for c in ref.columns]
    assert tables_differ(got, ref) is None, tables_differ(got, ref)
    if wide:
        q = tfrom(host_table_from_arrays(*table),
                  TorchSession(device="cpu")).select(
            (tcol("a") / tcol("b")).alias("q")).collect_table()
        want = [None if not (x and y) else _decimal_oracle(
            "divide", u, v, 10 ** 44, 1, 38)
            for u, v, x, y in zip(a, b, va, vb)]
        assert q.columns[0].to_pylist() == want


def test_negative_divisors_follow_spark_not_the_reference_host():
    """The pinned deviation: HALF_UP on the magnitude with the sign of
    a / b (Spark, the reference's device form and the port). The
    reference's host route, which takes every DECIMAL128 quotient, rounds
    a tie toward the divisor's sign. decimal(20,0) / decimal(20,0) is
    decimal(38,18) (up = 18), so 10 / -2 x 10^19 is the tie -0.5 in the
    last unit: -1 there in the port and in Spark, 0 in the reference."""
    a = [10, -10, 10, -10, 3, 7, -7]
    b = [-2 * 10 ** 19, 2 * 10 ** 19, 2 * 10 ** 19, -2 * 10 ** 19,
         -2 * 10 ** 19, -4, 4]
    n = len(a)
    table = (["a", "b"], ["decimal(20,0)", "decimal(20,0)"],
             [(np.array(a, dtype=object), np.ones(n, bool)),
              (np.array(b, dtype=object), np.ones(n, bool))])
    got, ref = _select_both(table, lambda c, A: [("q", c("a") / c("b"))])
    assert got.columns[0].dtype == JT.DecimalType(38, 18)
    port = [int(v) for v in got.columns[0].data]
    assert port == [_decimal_oracle("divide", x, y, 10 ** 18, 1, 38)
                    for x, y in zip(a, b)]
    assert port[:4] == [-1, -1, 1, 1]
    reference = [int(v) for v in ref.columns[0].data]
    assert reference[0] == 0 and reference[1] == -1  # toward b's sign
    positive = [i for i, y in enumerate(b) if y > 0]
    assert [port[i] for i in positive] == [reference[i] for i in positive]
