"""Deterministic scalable data-generation DSL (a copy of the reference
package's ``datagen.py``, re-pointed at the port's ``types``,
``columnar`` and ``errors``: one seed gives the same arrays in both).

Reference (SURVEY.md §2.11): the ``datagen/`` module —
``bigDataGen.scala`` (~3,200 LoC): per-column seeded generators with
configurable distributions (flat/normal/exponential/multi-modal),
null/special-value probabilities, correlated key groups for joins, and
the ScaleTest table suite (``ScaleTestDataGen.scala``) parameterized by
scale factor.

Design properties kept from the reference:
- **column-stable determinism**: each column's stream seeds from
  (seed, table, column), so adding/removing OTHER columns or changing
  row-chunking never changes a column's values;
- **distribution objects** compose with any value mapper;
- **key groups** generate join-consistent foreign keys (a child table's
  keys are drawn from the parent's key domain);
- **scale factor** drives row counts multiplicatively.
"""

from __future__ import annotations

import hashlib
import string as _string
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.errors import ColumnarProcessingError


def _column_seed(seed: int, table: str, column: str) -> int:
    h = hashlib.sha256(f"{seed}/{table}/{column}".encode()).digest()
    return int.from_bytes(h[:8], "little")


# ---------------------------------------------------------------------------
# distributions (bigDataGen distribution analog)
# ---------------------------------------------------------------------------

class Distribution:
    """Maps n uniform draws to positions in [0, 1)."""

    def sample(self, n: int, rng: np.random.Generator) -> np.ndarray:
        raise NotImplementedError


class Flat(Distribution):
    def sample(self, n, rng):
        return rng.random(n)


@dataclass
class Normal(Distribution):
    """Truncated normal centered at ``center`` (0..1)."""

    center: float = 0.5
    stddev: float = 0.15

    def sample(self, n, rng):
        return np.clip(rng.normal(self.center, self.stddev, n), 0.0,
                       np.nextafter(1.0, 0.0))


@dataclass
class Exponential(Distribution):
    """Skewed toward 0 (hot keys); rate controls the skew."""

    rate: float = 4.0

    def sample(self, n, rng):
        v = rng.exponential(1.0 / self.rate, n)
        return np.clip(v, 0.0, np.nextafter(1.0, 0.0))


@dataclass
class MultiModal(Distribution):
    """Mixture of normals at the given centers (multi-modal hot spots)."""

    centers: Sequence[float] = (0.2, 0.8)
    stddev: float = 0.05

    def sample(self, n, rng):
        which = rng.integers(0, len(self.centers), n)
        base = rng.normal(0.0, self.stddev, n)
        return np.clip(base + np.asarray(self.centers)[which], 0.0,
                       np.nextafter(1.0, 0.0))


# ---------------------------------------------------------------------------
# column generators
# ---------------------------------------------------------------------------

#: generation block size: row i's value depends only on (column seed,
#: i // BLOCK), so ANY chunking yields identical values (the reference's
#: scalable-determinism property)
GEN_BLOCK = 8192


@dataclass
class ColumnGen:
    dtype: T.DataType
    null_prob: float = 0.0
    distribution: Distribution = field(default_factory=Flat)

    def values(self, n: int, rng: np.random.Generator) -> np.ndarray:
        raise NotImplementedError

    def _block(self, block_index: int, seed: int, table: str, column: str):
        rng = np.random.default_rng(
            (_column_seed(seed, table, column), block_index))
        data = self.values(GEN_BLOCK, rng)
        if self.null_prob > 0:
            validity = rng.random(GEN_BLOCK) >= self.null_prob
        else:
            validity = np.ones(GEN_BLOCK, dtype=np.bool_)
        return data, validity

    def generate(self, n: int, seed: int, table: str,
                 column: str, row_offset: int = 0) -> HostColumn:
        datas = []
        valids = []
        pos = row_offset
        end = row_offset + n
        while pos < end:
            b = pos // GEN_BLOCK
            lo = pos - b * GEN_BLOCK
            hi = min(end - b * GEN_BLOCK, GEN_BLOCK)
            data, validity = self._block(b, seed, table, column)
            datas.append(np.asarray(data, dtype=object)[lo:hi]
                         if isinstance(self.dtype, T.StringType)
                         else np.asarray(data)[lo:hi])
            valids.append(validity[lo:hi])
            pos = b * GEN_BLOCK + hi
        data = np.concatenate(datas) if len(datas) > 1 else datas[0]
        validity = np.concatenate(valids) if len(valids) > 1 else valids[0]
        if isinstance(self.dtype, T.StringType):
            out = np.empty(n, dtype=object)
            out[:] = data
            out[~validity] = None
            return HostColumn(self.dtype, out, validity)
        zero = np.zeros((), dtype=self.dtype.np_dtype).item()
        return HostColumn(
            self.dtype,
            np.where(validity, data, zero).astype(self.dtype.np_dtype),
            validity)


@dataclass
class LongRange(ColumnGen):
    """Integers in [lo, hi] under the distribution."""

    dtype: T.DataType = T.LONG
    lo: int = 0
    hi: int = 1 << 31

    def values(self, n, rng):
        u = self.distribution.sample(n, rng)
        span = self.hi - self.lo + 1
        return (self.lo + (u * span).astype(np.int64)).astype(
            self.dtype.np_dtype)


@dataclass
class SequentialKey(ColumnGen):
    """Unique ascending key: row_offset + i (primary keys)."""

    dtype: T.DataType = T.LONG
    start: int = 0

    def generate(self, n, seed, table, column, row_offset=0):
        data = np.arange(self.start + row_offset,
                         self.start + row_offset + n, dtype=np.int64)
        return HostColumn(self.dtype, data.astype(self.dtype.np_dtype),
                          np.ones(n, dtype=np.bool_))

    def values(self, n, rng):  # pragma: no cover - generate() overrides
        raise AssertionError


@dataclass
class ForeignKey(ColumnGen):
    """Keys drawn from a parent key domain [0, parent_rows) under the
    distribution — join-consistent by construction (key-group analog)."""

    dtype: T.DataType = T.LONG
    parent_rows: int = 1000

    def values(self, n, rng):
        u = self.distribution.sample(n, rng)
        return (u * self.parent_rows).astype(np.int64)


@dataclass
class DoubleRange(ColumnGen):
    dtype: T.DataType = T.DOUBLE
    lo: float = 0.0
    hi: float = 1.0

    def values(self, n, rng):
        u = self.distribution.sample(n, rng)
        return (self.lo + u * (self.hi - self.lo)).astype(
            self.dtype.np_dtype)


@dataclass
class DecimalRange(ColumnGen):
    """decimal(p, s) uniform in [lo, hi] (values, not unscaled)."""

    dtype: T.DataType = field(default_factory=lambda: T.DecimalType(10, 2))
    lo: float = 0.0
    hi: float = 1000.0

    def values(self, n, rng):
        u = self.distribution.sample(n, rng)
        scale = 10 ** self.dtype.scale
        return np.round(
            (self.lo + u * (self.hi - self.lo)) * scale).astype(np.int64)


@dataclass
class Word(ColumnGen):
    """Strings from a bounded vocabulary (cardinality) with the
    distribution choosing the word — dictionary-friendly."""

    dtype: T.DataType = T.STRING
    cardinality: int = 1000
    prefix: str = "w"

    def values(self, n, rng):
        u = self.distribution.sample(n, rng)
        idx = (u * self.cardinality).astype(np.int64)
        return [f"{self.prefix}{i:08d}" for i in idx]


@dataclass
class RandomString(ColumnGen):
    dtype: T.DataType = T.STRING
    min_len: int = 0
    max_len: int = 16
    alphabet: str = _string.ascii_letters + _string.digits + " _"

    def values(self, n, rng):
        lens = rng.integers(self.min_len, self.max_len + 1, n)
        chars = np.array(list(self.alphabet))
        return ["".join(rng.choice(chars, size=l)) for l in lens]


@dataclass
class DateRange(ColumnGen):
    dtype: T.DataType = T.DATE
    lo_days: int = 8000   # ~1991
    hi_days: int = 11000  # ~2000

    def values(self, n, rng):
        u = self.distribution.sample(n, rng)
        span = self.hi_days - self.lo_days + 1
        return (self.lo_days + (u * span)).astype(np.int32)


@dataclass
class TimestampRange(ColumnGen):
    dtype: T.DataType = T.TIMESTAMP
    lo_micros: int = 0
    hi_micros: int = 2_000_000_000_000_000

    def values(self, n, rng):
        u = self.distribution.sample(n, rng)
        span = self.hi_micros - self.lo_micros
        return (self.lo_micros + u * span).astype(np.int64)


@dataclass
class BooleanGen(ColumnGen):
    dtype: T.DataType = T.BOOLEAN
    true_prob: float = 0.5

    def values(self, n, rng):
        return rng.random(n) < self.true_prob


@dataclass
class MappedGen(ColumnGen):
    """Arbitrary value mapper over the distribution (escape hatch)."""

    dtype: T.DataType = T.LONG
    fn: Callable[[np.ndarray], np.ndarray] = None

    def values(self, n, rng):
        return self.fn(self.distribution.sample(n, rng))


# ---------------------------------------------------------------------------
# table specs
# ---------------------------------------------------------------------------

class TableSpec:
    """DSL: TableSpec('orders', rows_per_sf=150_000)
    .col('o_orderkey', SequentialKey())
    .col('o_custkey', ForeignKey(parent_rows=..., distribution=Exponential()))
    """

    def __init__(self, name: str, rows_per_sf: int):
        self.name = name
        self.rows_per_sf = rows_per_sf
        self.columns: List[Tuple[str, ColumnGen]] = []

    def col(self, name: str, gen: ColumnGen) -> "TableSpec":
        self.columns.append((name, gen))
        return self

    def rows_at(self, scale_factor: float) -> int:
        return max(int(self.rows_per_sf * scale_factor), 1)

    def generate(self, scale_factor: float = 1.0, seed: int = 0,
                 chunk_rows: Optional[int] = None) -> List[HostTable]:
        """Chunked generation: values are identical regardless of
        chunking (row_offset re-seeds each chunk per column)."""
        total = self.rows_at(scale_factor)
        chunk = chunk_rows or total
        out = []
        off = 0
        while off < total:
            n = min(chunk, total - off)
            cols = [g.generate(n, seed, self.name, cname, row_offset=off)
                    for cname, g in self.columns]
            out.append(HostTable([c for c, _ in self.columns], cols))
            off += n
        return out

    def generate_table(self, scale_factor: float = 1.0,
                       seed: int = 0) -> HostTable:
        (t,) = self.generate(scale_factor, seed)
        return t


# ---------------------------------------------------------------------------
# ScaleTest suite (ScaleTestDataGen analog): a TPC-H-flavored trio whose
# key domains are join-consistent at any scale factor
# ---------------------------------------------------------------------------

def scale_test_specs(scale_factor: float = 1.0) -> Dict[str, TableSpec]:
    customers = int(25_000 * scale_factor) or 1
    orders = int(250_000 * scale_factor) or 1
    spec_c = (TableSpec("customer", 25_000)
              .col("c_custkey", SequentialKey())
              .col("c_name", Word(cardinality=1 << 20, prefix="Customer#"))
              .col("c_nationkey", LongRange(lo=0, hi=24))
              .col("c_acctbal", DecimalRange(
                  dtype=T.DecimalType(12, 2), lo=-999.99, hi=9999.99)))
    spec_o = (TableSpec("orders", 250_000)
              .col("o_orderkey", SequentialKey())
              .col("o_custkey", ForeignKey(parent_rows=customers,
                                           distribution=Exponential()))
              .col("o_orderdate", DateRange())
              .col("o_totalprice", DoubleRange(lo=100.0, hi=500_000.0,
                                               distribution=Normal())))
    spec_l = (TableSpec("lineitem", 1_000_000)
              .col("l_orderkey", ForeignKey(parent_rows=orders,
                                            distribution=Flat()))
              .col("l_quantity", LongRange(lo=1, hi=50))
              .col("l_extendedprice", DoubleRange(lo=900.0, hi=105_000.0))
              .col("l_discount", DoubleRange(lo=0.0, hi=0.1))
              .col("l_tax", DoubleRange(lo=0.0, hi=0.08))
              .col("l_returnflag", Word(cardinality=3, prefix="R"))
              .col("l_linestatus", Word(cardinality=2, prefix="S"))
              .col("l_shipdate", DateRange())
              .col("l_comment", RandomString(max_len=24, null_prob=0.02)))
    return {"customer": spec_c, "orders": spec_o, "lineitem": spec_l}
