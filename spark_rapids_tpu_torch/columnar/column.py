"""Host and device column representations (port of
``spark_rapids_tpu/columnar/column.py``).

Device columns are torch tensors padded to a power-of-two capacity bucket;
the live row count rides beside them. Strings are dictionary encoded per
column with a SORTED dictionary, so int32 code order is Spark's UTF-8 byte
order; the dictionary stays on the host. Decimals are unscaled integers:
int64 up to precision 18 (DECIMAL64), a ``(capacity, 2)`` int64 limb pair
above it (DECIMAL128: ``[:, 0]`` the signed high 64 bits, ``[:, 1]`` the
unsigned low 64 bits reinterpreted as int64); on the host a DECIMAL128
column holds Python ints in an object array, as the reference's
``ops/decimal.py::host_store`` does. Array, struct and map columns hold a
holder of flat buffers (columnar/nested.py) as their ``data`` on both
sides.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import nested as N
from spark_rapids_tpu_torch.errors import ColumnarProcessingError

#: integer-family types whose upload carries a (min, max) domain statistic
_DOMAIN_TYPES = (T.ByteType, T.ShortType, T.IntegerType, T.LongType,
                 T.DateType, T.TimestampType)

#: smallest capacity bucket (the reference's TPU lane width; kept so both
#: packages pad a batch to the same capacity)
MIN_BUCKET = 128


class BucketPolicy:
    """Capacity buckets: powers of two from ``min_bucket``. Every device
    batch's capacity is drawn from this set; the port's kernels take
    power-of-two capacities, so the reference's 'pow4' and explicit-list
    policies (``spark.rapids.sql.shapeBuckets``) are not offered."""

    __slots__ = ("min_bucket",)

    def __init__(self, min_bucket: int = MIN_BUCKET):
        self.min_bucket = int(min_bucket)
        if (self.min_bucket < 1 or self.min_bucket % MIN_BUCKET
                or self.min_bucket & (self.min_bucket - 1)):
            raise ColumnarProcessingError(
                f"spark.rapids.sql.shapeBuckets.minBucket must be a power of "
                f"two multiple of {MIN_BUCKET}, got {min_bucket}")

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (and >= the min bucket)."""
        b = self.min_bucket
        while b < n:
            b *= 2
        return b


_DEFAULT_POLICY = BucketPolicy()


def bucket_for(n: int) -> int:
    """Smallest default-policy bucket >= n."""
    return _DEFAULT_POLICY.bucket_for(n)


#: distinct keys from which encode_sorted_dict ranks them in C++
NATIVE_SORT_MIN_KEYS = 4096


def encode_sorted_dict(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Order-preserving dictionary encode of an object array of str.
    Returns (codes int32, sorted-unique dictionary object array). Python
    str order is code-point order, which is UTF-8 byte order (Spark's
    UTF8String.compareTo), so sorting the distinct keys gives the same
    dictionary as the reference's encoder."""
    n = len(values)
    if n == 0:
        return np.zeros(0, dtype=np.int32), np.array([], dtype=object)
    table: dict = {}
    setd = table.setdefault
    raw = np.fromiter((setd(s, len(table)) for s in values),
                      dtype=np.int32, count=n)
    keys = np.fromiter(table.keys(), dtype=object, count=len(table))
    rank = None
    if len(keys) >= NATIVE_SORT_MIN_KEYS:
        # the host library's UTF-32 sort of native/strcodec.cpp, as the
        # reference's native.py ranks many distinct keys
        from spark_rapids_tpu_torch.native import sort_rank_distinct
        rank = sort_rank_distinct(keys)
    if rank is None:
        order = np.argsort(keys)
        rank = np.empty(len(keys), dtype=np.int32)
        rank[order] = np.arange(len(keys), dtype=np.int32)
    dictionary = np.empty(len(keys), dtype=object)
    dictionary[rank] = keys
    return rank[raw], dictionary


_MASK64 = (1 << 64) - 1


def dec128_limbs(values, validity, cap: int) -> np.ndarray:
    """Python-int unscaled values -> (cap, 2) int64 limbs: [:, 0] the
    signed high 64 bits, [:, 1] the unsigned low 64 bits reinterpreted as
    int64 (the DECIMAL128 device layout); invalid and padding rows are 0."""
    n = len(values)
    out = np.zeros((cap, 2), dtype=np.int64)
    if n == 0:
        return out
    v = np.where(np.asarray(validity[:n], dtype=bool),
                 np.asarray(values[:n], dtype=object), 0)
    lo = v & _MASK64
    lo = np.where(lo >= (1 << 63), lo - (1 << 64), lo)
    out[:n, 0] = (v >> 64).astype(np.int64)
    out[:n, 1] = lo.astype(np.int64)
    return out


def dec128_unscaled(limbs: np.ndarray, validity) -> np.ndarray:
    """(n, 2) int64 limbs -> Python-int unscaled object array (0 at
    invalid rows)."""
    n = len(limbs)
    out = np.empty(n, dtype=object)
    if n == 0:
        return out
    vals = ((limbs[:, 0].astype(object) << 64)
            | (limbs[:, 1].astype(object) & _MASK64))
    out[:] = np.where(np.asarray(validity[:n], dtype=bool), vals, 0)
    return out


def null_data_array(dt: T.DataType, capacity: int,
                    device) -> torch.Tensor:
    """All-null device data in ``dt``'s storage: int32 codes for a string
    (its column carries an empty dictionary), a ``(capacity, 2)`` limb
    pair for a DECIMAL128, else ``capacity`` zeros of the type's dtype
    (the null side of an outer join, a cast NULL literal)."""
    if T.is_dec128(dt):
        return torch.zeros((capacity, 2), dtype=torch.int64, device=device)
    if isinstance(dt, T.StringType):
        return torch.zeros(capacity, dtype=torch.int32, device=device)
    return torch.zeros(capacity, dtype=T.torch_dtype(dt), device=device)


def null_column(dt: T.DataType, capacity: int, device) -> "DeviceColumn":
    """An all-null device column of ``dt`` (strings: an empty
    dictionary)."""
    return DeviceColumn(
        dt, null_data_array(dt, capacity, device),
        torch.zeros(capacity, dtype=torch.bool, device=device),
        dictionary=(np.array([], dtype=object)
                    if isinstance(dt, T.StringType) else None))


def _object_array(values) -> np.ndarray:
    if isinstance(values, np.ndarray) and values.dtype == object:
        return values
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def subset_codes(enc, rows: np.ndarray):
    """A string column's (codes, sorted dictionary) restricted to ``rows``
    (the dictionary narrowed to the codes they use)."""
    codes, dictionary = enc
    sub = codes[rows]
    used = np.zeros(len(dictionary), dtype=bool)
    used[sub] = True
    remap = np.cumsum(used) - 1
    return remap[sub].astype(np.int32), dictionary[used]


class HostColumn:
    """A column on the host: numpy values + validity mask. STRING data is
    an object array of str (None allowed at invalid slots); an array,
    struct or map column holds a flat holder (columnar/nested.py: given
    one Python object per row, it is flattened once here); everything
    else holds the Spark internal representation (see types.py)."""

    __slots__ = ("dtype", "data", "validity", "_cache", "__weakref__")

    def __init__(self, dtype: T.DataType, data: np.ndarray,
                 validity: Optional[np.ndarray] = None):
        self.dtype = dtype
        if validity is None:
            validity = np.ones(len(data), dtype=np.bool_)
        if N.is_nested_type(dtype) and not isinstance(data, N.NestedData):
            if N.layout_supported(dtype):
                data = N.from_objects(dtype, data, validity)
            else:
                # no device layout (arrays of structs or of arrays, string
                # or decimal leaves): the reference's object array, which
                # only the CPU route reads
                data = _object_array(data)
        self.data = data
        self.validity = validity
        self._cache = {}
        if len(data) != len(validity):
            raise ColumnarProcessingError("data/validity length mismatch")

    def __len__(self) -> int:
        return len(self.data)

    @property
    def all_valid(self) -> bool:
        """No null row (computed once)."""
        got = self._cache.get("all_valid")
        if got is None:
            got = self._cache["all_valid"] = bool(self.validity.all())
        return got

    @property
    def null_count(self) -> int:
        return int(len(self.validity) - self.validity.sum())

    @staticmethod
    def from_numpy(values: np.ndarray, validity: Optional[np.ndarray] = None,
                   dtype: Optional[T.DataType] = None) -> "HostColumn":
        """A column over ``values`` as they are, typed by their numpy dtype
        unless ``dtype`` names one."""
        if dtype is None:
            dtype = T.from_numpy(values.dtype)
        return HostColumn(dtype, values, validity)

    @staticmethod
    def from_pylist(values, dtype: Optional[T.DataType] = None
                    ) -> "HostColumn":
        """A column of Python values (None is null; dates, datetimes and
        DECIMAL128 unscaled ints converted to the internal form), typed by
        the first non-null value unless ``dtype`` names one: the
        reference's ``from_pylist``. A numpy array of a plain dtype is
        taken as a whole (its values are never null)."""
        if isinstance(values, np.ndarray) and values.dtype != object:
            dt = dtype if dtype is not None else T.from_numpy(values.dtype)
            if not (N.is_nested_type(dt) or T.is_dec128(dt)
                    or isinstance(dt, T.StringType)):
                return HostColumn(dt, values.astype(dt.np_dtype, copy=False))
            values = values.tolist()
        if dtype is None:
            sample = next((v for v in values if v is not None), None)
            dtype = (T.python_to_spark_type(sample) if sample is not None
                     else T.NULL)
        validity = np.array([v is not None for v in values], dtype=np.bool_)
        if isinstance(dtype, T.ArrayType):
            conv = _element_conv(dtype.element_type)
            return HostColumn(dtype, _object_array([
                [conv(x) if x is not None else None for x in v]
                if v is not None else None for v in values]), validity)
        if N.is_nested_type(dtype) or isinstance(dtype, T.StringType):
            return HostColumn(dtype, _object_array(list(values)), validity)
        if T.is_dec128(dtype):
            return HostColumn(dtype, _object_array(
                [int(v) if v is not None else 0 for v in values]), validity)
        conv = _element_conv(dtype)
        fill = np.zeros((), dtype=dtype.np_dtype).item()
        data = np.array([conv(v) if v is not None else fill for v in values],
                        dtype=dtype.np_dtype)
        return HostColumn(dtype, data, validity)

    def take(self, rows: np.ndarray) -> "HostColumn":
        """The column at ``rows`` (an index array); a string column's
        codes come along (``subset_codes``), so an upload or a write of
        the rows does not sort their strings again."""
        out = HostColumn(self.dtype, self.data[rows], self.validity[rows])
        enc = self._cache.get("encode")
        if enc is not None:
            out._cache["encode"] = subset_codes(enc, rows)
        return out

    def slice(self, start: int, length: int) -> "HostColumn":
        if isinstance(self.data, N.NestedData):
            return HostColumn(self.dtype,
                              self.data.host_slice(start, length),
                              self.validity[start:start + length])
        out = HostColumn(self.dtype, self.data[start:start + length],
                         self.validity[start:start + length])
        enc = self._cache.get("encode")
        if enc is not None:
            # a sorted dictionary stays one for any subset of the rows
            out._cache["encode"] = (enc[0][start:start + length], enc[1])
        return out

    def encoded(self) -> Tuple[np.ndarray, np.ndarray]:
        """(codes, dictionary) of a STRING column, computed once."""
        got = self._cache.get("encode")
        if got is None:
            vals = np.where(self.validity, self.data, "")
            got = encode_sorted_dict(np.asarray(vals, dtype=object))
            self._cache["encode"] = got
        return got

    def to_pylist(self):
        if isinstance(self.data, N.NestedData):
            rows = self.data.to_objects()
            conv = _temporal_conv(self.dtype.element_type) if isinstance(
                self.dtype, T.ArrayType) else None
            return [(rows[i] if conv is None else
                     [None if x is None else conv(x) for x in rows[i]])
                    if ok else None for i, ok in enumerate(self.validity)]
        return [(v.item() if isinstance(v, np.generic) else v) if ok else None
                for v, ok in zip(self.data, self.validity)]

    def nbytes(self) -> int:
        """Host size in bytes (strings: UTF-8 bytes of the valid values
        plus one byte a row), computed once."""
        got = self._cache.get("nbytes")
        if got is None:
            if isinstance(self.dtype, T.StringType):
                got = int(sum(len(s.encode("utf-8")) for s, v in
                              zip(self.data, self.validity) if v)) + len(self)
            elif isinstance(self.data, N.NestedData):
                got = self.data.nbytes + int(self.validity.nbytes)
            elif T.is_dec128(self.dtype):
                got = 17 * len(self)  # two int64 limbs and a validity byte
            else:
                got = int(self.data.nbytes + self.validity.nbytes)
            self._cache["nbytes"] = got
        return got

    def int_domain(self) -> Optional[Tuple[int, int]]:
        """(min, max) over VALID rows of an integer-family column, else
        None; computed once. A superset contract: every valid value lies
        in [min, max]. The aggregate's no-sort layout reads it
        (execs/aggregate.py)."""
        if "int_domain" in self._cache:
            return self._cache["int_domain"]
        dom = None
        if (isinstance(self.dtype, _DOMAIN_TYPES)
                and self.data.dtype.kind in "iu"):
            vals = self.data[self.validity]
            if len(vals):
                dom = (int(vals.min()), int(vals.max()))
        self._cache["int_domain"] = dom
        return dom


def _element_conv(dt):
    """A Python value into the internal form of ``dt``: a date (or a
    datetime's date) to epoch days, a datetime to UTC epoch microseconds
    (a naive one read as UTC); any other value as it is."""
    import datetime as _dt
    if isinstance(dt, T.DateType):
        epoch = _dt.date(1970, 1, 1)

        def conv(v):
            if isinstance(v, _dt.datetime):  # datetime subclasses date
                v = v.date()
            return (v - epoch).days if isinstance(v, _dt.date) else v
        return conv
    if isinstance(dt, T.TimestampType):
        epoch_ts = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)

        def conv(v):
            if isinstance(v, _dt.datetime):
                if v.tzinfo is None:
                    v = v.replace(tzinfo=_dt.timezone.utc)
                d = v - epoch_ts
                return (d.days * 86_400_000_000 + d.seconds * 1_000_000
                        + d.microseconds)
            return v
        return conv
    return lambda v: v


def _temporal_conv(dt):
    """Python value of a DATE (days) or TIMESTAMP (microseconds) array
    element, as the reference's ``to_pylist`` gives it; None for other
    element types."""
    import datetime as _dt
    if isinstance(dt, T.DateType):
        epoch = _dt.date(1970, 1, 1)
        return lambda x: epoch + _dt.timedelta(days=int(x))
    if isinstance(dt, T.TimestampType):
        epoch_ts = _dt.datetime(1970, 1, 1)
        return lambda x: epoch_ts + _dt.timedelta(microseconds=int(x))
    return None


class DeviceColumn:
    """A column on a torch device.

    ``data``      : tensor of length ``capacity`` (the padded bucket);
                    ``(capacity, 2)`` int64 limbs for a DECIMAL128; a
                    nested holder of tensors for an array, struct or map
                    (columnar/nested.py)
    ``validity``  : bool tensor, True = valid; the padding is False at upload
    ``dictionary``: for STRING, the host object array such that row i's
                    value is dictionary[data[i]]; with ``dict_sorted`` the
                    dictionary is sorted-unique, so code order is string
                    order.
    ``domain``    : for integer-family columns, (min, max) of the valid
                    values at upload (HostColumn.int_domain), carried
                    through gathers and compactions, which only drop or
                    repeat values; None when unknown.
    """

    __slots__ = ("dtype", "data", "validity", "dictionary", "dict_sorted",
                 "domain", "storages", "__weakref__")

    def __init__(self, dtype: T.DataType, data: torch.Tensor,
                 validity: torch.Tensor,
                 dictionary: Optional[np.ndarray] = None,
                 dict_sorted: bool = True,
                 domain: Optional[Tuple[int, int]] = None):
        self.dtype = dtype
        self.data = data
        self.validity = validity
        self.dictionary = dictionary
        self.dict_sorted = dict_sorted
        self.domain = domain
        #: the memory ledger's (storage key, bytes) of ``data`` and
        #: ``validity``, filled on first use (runtime/memory.py)
        self.storages = None

    @property
    def capacity(self) -> int:
        return int(self.validity.shape[0])

    @property
    def is_nested(self) -> bool:
        return isinstance(self.data, N.NestedData)

    def leaves(self) -> tuple:
        """Every tensor of the column's data (one, or a nested holder's
        buffers); the validity is apart."""
        if isinstance(self.data, N.NestedData):
            return self.data.leaves()
        return (self.data,)

    def device_nbytes(self) -> int:
        """Bytes of the data and validity tensors (their element counts,
        tensor metadata only: no device work)."""
        return sum(x.nbytes for x in self.leaves()) + self.validity.nbytes

    @staticmethod
    def from_host(host: HostColumn, capacity: int,
                  device: torch.device) -> "DeviceColumn":
        """``host`` on ``device`` at ``capacity`` rows: a landing, so it
        reserves its estimated bytes with the memory arbiter first (which
        may spill, or raise RetryOOM), then uploads and accounts the
        column (runtime/memory.py)."""
        from spark_rapids_tpu_torch.runtime.memory import (
            MEMORY,
            _device_row_bytes,
        )
        est = _device_row_bytes(host.dtype) * capacity
        if isinstance(host.data, N.NestedData):
            est += host.data.nbytes  # the elements land at their bucket
        res = MEMORY.reserve(est, label="from_host")
        try:
            return MEMORY.account(
                DeviceColumn._upload(host, capacity, device), res)
        finally:
            res.release()

    @staticmethod
    def from_array(dtype: T.DataType, data: np.ndarray,
                   device: torch.device) -> "DeviceColumn":
        """A full-capacity host array whose every slot is valid (an
        operand an exec draws on the host: a sample's keep mask,
        ``rand``'s values) on ``device``: a landing like ``from_host``'s,
        reserved and accounted with the memory arbiter, in one copy (the
        validity is made on the device)."""
        from spark_rapids_tpu_torch.runtime.memory import MEMORY
        n = len(data)
        res = MEMORY.reserve(data.nbytes + n, label="from_array")
        try:
            return MEMORY.account(DeviceColumn(
                dtype, torch.from_numpy(data).to(device),
                torch.ones(n, dtype=torch.bool, device=device)), res)
        finally:
            res.release()

    @staticmethod
    def _upload(host: HostColumn, capacity: int,
                device: torch.device) -> "DeviceColumn":
        n = len(host)
        if capacity < n:
            raise ColumnarProcessingError(f"capacity {capacity} < rows {n}")
        validity = np.zeros(capacity, dtype=np.bool_)
        validity[:n] = host.validity
        if N.is_nested_type(host.dtype):
            if not isinstance(host.data, N.NestedData):
                raise ColumnarProcessingError(
                    f"a {host.dtype.simple_string()} column has no device "
                    "layout; the plan's tag keeps it on the CPU route")
            return DeviceColumn(
                host.dtype, N.upload(host.data, validity, capacity, device),
                torch.from_numpy(validity).to(device))
        dictionary = None
        if isinstance(host.dtype, T.StringType):
            codes, dictionary = host.encoded()
            data = np.zeros(capacity, dtype=np.int32)
            data[:n] = codes
        elif T.is_dec128(host.dtype):
            data = dec128_limbs(host.data, host.validity, capacity)
        else:
            data = np.zeros(capacity, dtype=host.dtype.np_dtype)
            data[:n] = host.data
        return DeviceColumn(host.dtype, torch.from_numpy(data).to(device),
                            torch.from_numpy(validity).to(device),
                            dictionary=dictionary, dict_sorted=True,
                            domain=host.int_domain())

    def decode_host(self, data: np.ndarray, validity: np.ndarray) -> HostColumn:
        """The logical HostColumn from downloaded raw arrays."""
        if isinstance(self.dtype, T.StringType):
            if self.dictionary is None:
                raise ColumnarProcessingError("string column missing "
                                              "dictionary")
            # padding/invalid slots may hold arbitrary codes
            d = self.dictionary
            codes = np.clip(data, 0, max(len(d) - 1, 0))
            vals = np.empty(len(data), dtype=object)
            if len(d):
                vals[:] = d[codes]
            vals[~validity] = None
            col = HostColumn(self.dtype, vals, validity)
            if self.dict_sorted and len(d) and (
                    len(d) == 1 or bool(np.all(d[:-1] < d[1:]))):
                # a strictly increasing dictionary is an encoding of the
                # downloaded rows already: a re-upload or a write of them
                # does not sort their strings again (null rows' codes are
                # 0; nothing reads them)
                col._cache["encode"] = (
                    np.where(validity, codes, 0).astype(np.int32), d)
            return col
        if T.is_dec128(self.dtype):
            return HostColumn(self.dtype, dec128_unscaled(data, validity),
                              validity)
        arr = np.ascontiguousarray(data)
        if arr.dtype != self.dtype.np_dtype:
            arr = arr.astype(self.dtype.np_dtype)
        return HostColumn(self.dtype, arr, validity)

    def host_leaves(self, num_rows: int, total: Optional[int]) -> tuple:
        """The tensors a download of the first ``num_rows`` rows copies:
        the data's (a nested one's first rows, holding ``total``
        elements), then the validity."""
        if isinstance(self.data, N.NestedData):
            head = self.data.head(num_rows, total or 0).leaves()
        else:
            head = (self.data[:num_rows],)
        return head + (self.validity[:num_rows],)

    def decode_leaves(self, leaves: Sequence[np.ndarray]) -> HostColumn:
        """The HostColumn from downloaded :meth:`host_leaves`."""
        validity = np.ascontiguousarray(leaves[-1])
        if isinstance(self.data, N.NestedData):
            return HostColumn(self.dtype, self.data.with_leaves(
                [np.ascontiguousarray(x) for x in leaves[:-1]]), validity)
        return self.decode_host(leaves[0], validity)

    def to_host(self, num_rows: int) -> HostColumn:
        from spark_rapids_tpu_torch.dispatch import note_host_fetch
        note_host_fetch()
        if isinstance(self.data, N.NestedData):
            tot = N.element_total(self.data, num_rows)
            total = None if tot is None else int(tot.item())
            return self.decode_leaves(
                [x.cpu().numpy() for x in self.host_leaves(num_rows,
                                                           total)])
        data = self.data[:num_rows].cpu().numpy()
        validity = np.ascontiguousarray(self.validity[:num_rows].cpu().numpy())
        return self.decode_host(data, validity)

    def with_arrays(self, data: torch.Tensor,
                    validity: torch.Tensor) -> "DeviceColumn":
        return DeviceColumn(self.dtype, data, validity, self.dictionary,
                            self.dict_sorted, self.domain)

    def sliced_rows(self, k: int, copy: bool = False) -> "DeviceColumn":
        """The first ``k`` slots (a smaller capacity bucket): views of this
        column's buffers, or with ``copy`` buffers of their own, so that a
        table kept for long (a spillable partial, a build partition) does
        not hold the whole larger buffer alive, and accounted
        (runtime/memory.py), for a few rows."""
        if isinstance(self.data, N.NestedData):
            v = self.validity[:k]
            return self.with_arrays(self.data.sliced_rows(k, copy),
                                    v.clone() if copy else v)
        if copy:
            return self.with_arrays(self.data[:k].clone(),
                                    self.validity[:k].clone())
        return self.with_arrays(self.data[:k], self.validity[:k])
