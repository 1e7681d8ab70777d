"""Order-isomorphic 32-bit sort operands and the lexicographic sort
dispatch point (port of ``spark_rapids_tpu/ops/ordering.py``).

Every sort key becomes a list of <= 32-bit operands whose lexicographic
order is the value order, as in the reference's CPU branch:

  i64  -> (hi = x >> 32 as int32, lo = x & 0xffffffff as uint32)
  f64  -> canonicalized (-0.0 -> 0.0, one NaN pattern), then the classic
          sortable bits as a (uint32 hi, uint32 lo) word pair; NaN sorts
          after +inf (Spark's NaN-last order)
  bool -> int32
  <= 32-bit ints / dictionary codes -> unchanged

torch has few uint32 operations, so uint32 words are built and
complemented through int32 views of the same bits."""

from __future__ import annotations

from typing import List

import torch

_U32 = torch.uint32


def _u32(words_i64: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an int64 tensor as uint32."""
    return words_i64.to(torch.int32).view(_U32)


def _canon_float(d: torch.Tensor) -> torch.Tensor:
    d = torch.where(d == 0.0, torch.zeros_like(d), d)  # -0.0 == 0.0
    return torch.where(torch.isnan(d), torch.full_like(d, float("nan")), d)


def zero_invalid(data: torch.Tensor, validity: torch.Tensor) -> torch.Tensor:
    """where(validity, data, 0)."""
    return torch.where(validity, data, torch.zeros_like(data))


def comparable_operands(data: torch.Tensor) -> List[torch.Tensor]:
    """Decompose one key column into ascending-order operands. Callers add
    their own null-placement flag operand; invalid slots should be zeroed
    first (zero_invalid)."""
    d = data
    if d.ndim != 1:
        raise NotImplementedError("sort keys of DECIMAL128 limb storage are "
                                  "not ported")
    if d.dtype == torch.int64:
        return [(d >> 32).to(torch.int32), _u32(d & 0xFFFFFFFF)]
    if d.dtype == torch.float64:
        raw = _canon_float(d).view(torch.int64)
        bits = torch.where(raw < 0, ~raw, raw ^ (-0x8000000000000000))
        return [_u32((bits >> 32) & 0xFFFFFFFF), _u32(bits & 0xFFFFFFFF)]
    if d.dtype == torch.float32:
        raise NotImplementedError("float32 sort keys are not ported")
    if d.dtype == torch.bool:
        return [d.to(torch.int32)]
    if d.dtype in (torch.int8, torch.int16, torch.int32):
        return [d]
    raise NotImplementedError(f"sort keys of dtype {d.dtype}")


def descending_operands(ops: List[torch.Tensor]) -> List[torch.Tensor]:
    """Order-reverse an operand list: bitwise complement reverses signed
    and unsigned order alike, and equal tuples stay equal."""
    out = []
    for o in ops:
        if o.dtype == _U32:
            out.append((~o.view(torch.int32)).view(_U32))
        else:
            out.append(~o)
    return out


def lex_sort(operands: List[torch.Tensor],
             payload: torch.Tensor) -> List[torch.Tensor]:
    """THE lexicographic sort dispatch point: ``operands`` and ``payload``
    reordered by the operands' ascending order, stable. ``payload`` must be
    a unique int32 row-index iota (every call site passes
    ``arange(capacity)``): the kernel breaks ties on it."""
    from spark_rapids_tpu_torch.kernels import sort as ksort
    ops = [o.to(torch.int32) if o.dtype in (torch.int8, torch.int16) else o
           for o in operands]
    return ksort.sort_with_payload(ops, payload)
