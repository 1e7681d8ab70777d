"""Struct and map expressions, lambdas and the higher-order functions
(port of ``spark_rapids_tpu/ops/nested.py``).

A lambda body is an ordinary expression tree evaluated over the ELEMENT
space: the array's (or map's) flat element buffers are its columns, the
lambda variables bind to the element streams, and every outer row-space
column the body reads is gathered per element by its row id. Nothing
runs per row.

The body is REBOUND at binding: lambda variable i -> element-space
ordinal i, outer column j -> ordinal (number of variables + j); the outer
columns become this node's children after the array, so every generic
walk sees them. Element-space liveness is (slot < total elements) and the
parent row's liveness.

Every expression also evaluates on the host (``eval_cpu``, the
reference's per-row Python over the object rows). ``MapEntries`` and
``ArraysZip`` produce arrays of structs, which have no device layout in
either package, and a struct or map of string or decimal leaves has none
either: the plan's tag sends their operators to the CPU route, as the
reference does."""

from __future__ import annotations

from types import SimpleNamespace
from typing import List, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.columnar import bucket_for
from spark_rapids_tpu_torch.columnar.nested import (
    ArrayData,
    MapData,
    StructData,
    fixed_np_dtype,
)
from spark_rapids_tpu_torch.errors import ColumnarProcessingError
from spark_rapids_tpu_torch.ops.collections import (
    _elem_rids,
    check_array,
    pack_elements,
    seg_count,
)
from spark_rapids_tpu_torch.ops.common import UnaryExpression
from spark_rapids_tpu_torch.ops.expr import (
    BoundReference,
    DevVal,
    EvalCtx,
    Expression,
    NodePrep,
    PrepCtx,
    _walk_eval,
    _walk_prep,
)


# ---------------------------------------------------------------------------
# structs
# ---------------------------------------------------------------------------

class CreateNamedStruct(Expression):
    """named_struct(n1, e1, n2, e2, ...): bundles the children's columns
    (no data moves)."""

    def __init__(self, names: Sequence[str], exprs: Sequence[Expression]):
        self.names = tuple(names)
        self.children = tuple(exprs)

    @property
    def data_type(self):
        return T.StructType([T.StructField(n, e.data_type)
                             for n, e in zip(self.names, self.children)])

    def with_children(self, children):
        return CreateNamedStruct(self.names, children)

    def resolve(self, bound):
        out = CreateNamedStruct(self.names, bound)
        return out

    def eval_dev(self, ctx, child_vals, prep) -> DevVal:
        sd = StructData([(cv.data, cv.validity) for cv in child_vals])
        return DevVal(sd, ctx.row_mask())

    def eval_cpu(self, table: HostTable) -> HostColumn:
        kids = [c.eval_cpu(table) for c in self.children]
        n = table.num_rows
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = tuple(
                (k.data[i].item() if hasattr(k.data[i], "item")
                 else k.data[i]) if k.validity[i] else None
                for k in kids)
        return HostColumn(self.data_type, out, np.ones(n, dtype=np.bool_))


class GetStructField(Expression):
    def __init__(self, child: Expression, name: str):
        self.children = (child,)
        self.field_name = name

    def _field(self):
        st = self.children[0].data_type
        if not isinstance(st, T.StructType):
            raise ColumnarProcessingError(
                f"getField({self.field_name!r}) of a non-struct "
                f"{st.simple_string()}")
        for i, f in enumerate(st.fields):
            if f.name == self.field_name:
                return i, f
        raise ColumnarProcessingError(
            f"no field {self.field_name!r} in {st.simple_string()}")

    @property
    def data_type(self):
        return self._field()[1].data_type

    def with_children(self, children):
        return GetStructField(children[0], self.field_name)

    def resolve(self, bound):
        out = GetStructField(bound[0], self.field_name)
        out._field()
        return out

    def eval_dev(self, ctx, child_vals, prep) -> DevVal:
        (c,) = child_vals
        fi, _ = self._field()
        d, v = c.data.fields[fi]
        return DevVal(d, v & c.validity)

    def eval_cpu(self, table: HostTable) -> HostColumn:
        c = self.children[0].eval_cpu(table)
        fi, f = self._field()
        n = len(c)
        npdt = fixed_np_dtype(f.data_type)
        data = np.zeros(n, dtype=npdt if npdt is not None else object)
        validity = np.zeros(n, dtype=np.bool_)
        for i in range(n):
            if c.validity[i]:
                row = c.data[i]
                v = row.get(self.field_name) if isinstance(row, dict) \
                    else row[fi]
                if v is not None:
                    data[i] = v
                    validity[i] = True
        return HostColumn(f.data_type, data, validity)


# ---------------------------------------------------------------------------
# maps
# ---------------------------------------------------------------------------

class CreateMap(Expression):
    """map(k1, v1, k2, v2, ...): a fixed entry count a row. A null key is
    a runtime error in Spark; the device cannot raise per row, so the
    entry's key is marked invalid and the download raises
    (columnar/nested.py::MapData.to_objects)."""

    def __init__(self, *children: Expression):
        if len(children) % 2 != 0 or not children:
            raise ColumnarProcessingError("map() needs key/value pairs")
        self.children = tuple(children)

    @property
    def data_type(self):
        return T.MapType(key_type=self.children[0].data_type,
                         value_type=self.children[1].data_type)

    def with_children(self, children):
        return CreateMap(*children)

    def resolve(self, bound):
        from spark_rapids_tpu_torch.ops.cast import make_cast
        kt, vt = bound[0].data_type, bound[1].data_type
        for i in range(2, len(bound), 2):
            kt = T.promote(kt, bound[i].data_type) \
                if bound[i].data_type != kt else kt
            vt = T.promote(vt, bound[i + 1].data_type) \
                if bound[i + 1].data_type != vt else vt
        out = CreateMap(*[make_cast(b, kt if i % 2 == 0 else vt)
                          for i, b in enumerate(bound)])
        return out

    def eval_dev(self, ctx, child_vals, prep) -> DevVal:
        cap = ctx.capacity
        k = len(child_vals) // 2
        ecap = bucket_for(max(cap * k, 1))
        dev = ctx.device
        live = ctx.row_mask()

        def stream(j, what):
            x = torch.stack([getattr(child_vals[2 * i + j], what)
                             for i in range(k)], 1).reshape(-1)
            out = torch.zeros(ecap, dtype=x.dtype, device=dev)
            out[:cap * k] = x
            return out

        leaves = [(stream(0, "data"), stream(0, "validity")),
                  (stream(1, "data"), stream(1, "validity"))]
        if ctx.live is None:
            rows = torch.arange(cap + 1, dtype=torch.int32, device=dev)
            off = torch.minimum(rows, ctx.nrows.to(torch.int32)) * k
        else:
            rid = torch.arange(ecap, dtype=torch.int64, device=dev) // k
            keep = (rid < cap) & live[rid.clamp(max=cap - 1)]
            off, leaves = pack_elements(ctx, keep, rid, leaves, ecap)
        (kd, kv), (vd, vv) = leaves
        return DevVal(MapData(off, kd, kv, vd, vv), live)

    def eval_cpu(self, table: HostTable) -> HostColumn:
        kids = [c.eval_cpu(table) for c in self.children]
        n = table.num_rows
        out = np.empty(n, dtype=object)
        for i in range(n):
            m = {}
            for j in range(0, len(kids), 2):
                kc, vc = kids[j], kids[j + 1]
                if not kc.validity[i]:
                    raise ColumnarProcessingError(
                        "Cannot use null as map key")
                k = kc.data[i].item() if hasattr(kc.data[i], "item") \
                    else kc.data[i]
                m[k] = (vc.data[i].item() if hasattr(vc.data[i], "item")
                        else vc.data[i]) if vc.validity[i] else None
            out[i] = m
        return HostColumn(self.data_type, out, np.ones(n, dtype=np.bool_))


def _check_map(e: Expression, what: str) -> None:
    dt = e.data_type
    if not isinstance(dt, T.MapType):
        raise ColumnarProcessingError(
            f"{what} needs a map, got {dt.simple_string()}")


class _MapUnary(UnaryExpression):
    def resolve(self, bound):
        _check_map(bound[0], type(self).__name__)
        return type(self)(bound[0])


class MapKeys(_MapUnary):
    @property
    def data_type(self):
        return T.ArrayType(self.children[0].data_type.key_type)

    def eval_dev(self, ctx, child_vals, prep) -> DevVal:
        (c,) = child_vals
        m: MapData = c.data
        return DevVal(ArrayData(m.offsets, m.kdata, m.kvalid), c.validity)

    def eval_cpu(self, table):
        c = self.children[0].eval_cpu(table)
        out = np.empty(len(c), dtype=object)
        for i in range(len(c)):
            if c.validity[i]:
                out[i] = list(c.data[i].keys())
        return HostColumn(self.data_type, out, c.validity.copy())


class MapValues(_MapUnary):
    @property
    def data_type(self):
        return T.ArrayType(self.children[0].data_type.value_type)

    def eval_dev(self, ctx, child_vals, prep) -> DevVal:
        (c,) = child_vals
        m: MapData = c.data
        return DevVal(ArrayData(m.offsets, m.vdata, m.vvalid), c.validity)

    def eval_cpu(self, table):
        c = self.children[0].eval_cpu(table)
        out = np.empty(len(c), dtype=object)
        for i in range(len(c)):
            if c.validity[i]:
                out[i] = list(c.data[i].values())
        return HostColumn(self.data_type, out, c.validity.copy())


class MapEntries(_MapUnary):
    """map_entries(m) -> array<struct<key, value>>: no device layout
    (arrays hold fixed-width elements), CPU-only in the reference."""

    @property
    def data_type(self):
        mt = self.children[0].data_type
        return T.ArrayType(T.StructType([
            T.StructField("key", mt.key_type, False),
            T.StructField("value", mt.value_type)]))


    def eval_cpu(self, table):
        c = self.children[0].eval_cpu(table)
        out = np.empty(len(c), dtype=object)
        for i in range(len(c)):
            if c.validity[i]:
                out[i] = [(k, v) for k, v in c.data[i].items()]
        return HostColumn(self.data_type, out, c.validity.copy())


class GetMapValue(Expression):
    """m[key]: per-row lookup, null when the key is missing; the last
    entry with the key wins."""

    def __init__(self, child: Expression, key_expr: Expression):
        self.children = (child, key_expr)

    @property
    def data_type(self):
        return self.children[0].data_type.value_type

    def with_children(self, children):
        return GetMapValue(children[0], children[1])

    def resolve(self, bound):
        from spark_rapids_tpu_torch.ops.cast import make_cast
        _check_map(bound[0], "a map lookup")
        return GetMapValue(bound[0],
                           make_cast(bound[1], bound[0].data_type.key_type))

    def eval_dev(self, ctx, child_vals, prep) -> DevVal:
        c, k = child_vals
        m: MapData = c.data
        cap = ctx.capacity
        ecap = m.kdata.shape[0]
        rid = _elem_rids(m.offsets, ecap, cap)
        safe = rid.clamp(max=cap - 1)
        hit = (rid < cap) & m.kvalid & k.validity[safe] & \
            (m.kdata == k.data[safe])
        pos = torch.where(hit, torch.arange(ecap, device=ctx.device),
                          torch.full_like(rid, -1))
        best = torch.full((cap + 1,), -1, dtype=torch.int64,
                          device=ctx.device)
        best = best.scatter_reduce(0, rid, pos, reduce="amax")[:cap]
        found = best >= 0
        at = best.clamp(0, ecap - 1)
        validity = found & m.vvalid[at] & c.validity & k.validity
        data = m.vdata[at]
        return DevVal(torch.where(validity, data, torch.zeros_like(data)),
                      validity)

    def eval_cpu(self, table):
        c = self.children[0].eval_cpu(table)
        k = self.children[1].eval_cpu(table)
        vt = self.data_type
        npdt = fixed_np_dtype(vt)
        n = len(c)
        data = np.zeros(n, dtype=npdt if npdt is not None else object)
        validity = np.zeros(n, dtype=np.bool_)
        for i in range(n):
            if c.validity[i] and k.validity[i]:
                kk = k.data[i].item() if hasattr(k.data[i], "item") \
                    else k.data[i]
                if kk in c.data[i] and c.data[i][kk] is not None:
                    data[i] = c.data[i][kk]
                    validity[i] = True
        return HostColumn(vt, data, validity)


class MapConcat(Expression):
    """map_concat(m1, m2, ...): the entries of every input, the LAST
    entry of a duplicated key winning (Spark's mapKeyDedupPolicy
    LAST_WIN; the default EXCEPTION cannot raise per row on the device,
    as in the reference). One stable sort of (row, key words, input
    order) through the radix sort kernel finds each (row, key)'s last
    entry; one compaction packs the kept ones."""

    def __init__(self, *children: Expression):
        self.children = tuple(children)

    @property
    def data_type(self):
        return self.children[0].data_type

    def with_children(self, children):
        return MapConcat(*children)

    def resolve(self, bound):
        for b in bound:
            _check_map(b, "map_concat")
            if b.data_type != bound[0].data_type:
                raise ColumnarProcessingError(
                    "map_concat inputs must share one map type")
        return MapConcat(*bound)

    def eval_dev(self, ctx, child_vals, prep) -> DevVal:
        from spark_rapids_tpu_torch.ops.ordering import (
            comparable_operands,
            lex_sort,
        )
        cap = ctx.capacity
        dev = ctx.device
        validity = ctx.row_mask()
        for cv in child_vals:
            validity = validity & cv.validity
        rids, kds, kvs, vds, vvs = [], [], [], [], []
        for cv in child_vals:
            m: MapData = cv.data
            rid = _elem_rids(m.offsets, m.kdata.shape[0], cap)
            safe = rid.clamp(max=cap - 1)
            live = (rid < cap) & m.kvalid & validity[safe]
            rids.append(torch.where(live, rid, torch.full_like(rid, cap)))
            kds.append(m.kdata)
            kvs.append(live)
            vds.append(m.vdata)
            vvs.append(m.vvalid)
        rid = torch.cat(rids)
        kd, kv = torch.cat(kds), torch.cat(kvs)
        vd, vv = torch.cat(vds), torch.cat(vvs)
        tot = rid.shape[0]
        ecap = bucket_for(max(tot, 1))
        pad = ecap - tot

        def padded(x, fill=0):
            return torch.cat([x, torch.full((pad,), fill, dtype=x.dtype,
                                            device=dev)]) if pad else x

        rid, kd, kv = padded(rid, cap), padded(kd), padded(kv)
        vd, vv = padded(vd), padded(vv)
        keyw = kd.to(torch.int32) if kd.dtype in (
            torch.bool, torch.int8, torch.int16) else kd
        kops = comparable_operands(torch.where(kv, keyw,
                                               torch.zeros_like(keyw)))
        payload = torch.arange(ecap, dtype=torch.int32, device=dev)
        # the payload (the concatenation order) breaks ties: stable
        res = lex_sort([rid.to(torch.int32)] + kops, payload)
        s_rid = res[0]
        perm = res[-1].to(torch.int64)
        nxt_same = torch.zeros(ecap, dtype=torch.bool, device=dev)
        nxt_same[:-1] = s_rid[1:] == s_rid[:-1]
        for o in res[1:-1]:
            o = o.view(torch.int32) if o.dtype == torch.uint32 else o
            eq = torch.zeros(ecap, dtype=torch.bool, device=dev)
            eq[:-1] = o[1:] == o[:-1]
            nxt_same = nxt_same & eq
        keep = (s_rid < cap) & ~nxt_same
        s_rid = s_rid.to(torch.int64)
        off, pairs = pack_elements(
            ctx, keep, s_rid, [(kd[perm], kv[perm]), (vd[perm], vv[perm])],
            ecap)
        (okd, okv), (ovd, ovv) = pairs
        return DevVal(MapData(off, okd, okv, ovd, ovv), validity)

    def eval_cpu(self, table):
        kids = [c.eval_cpu(table) for c in self.children]
        n = table.num_rows
        out = np.empty(n, dtype=object)
        validity = np.ones(n, dtype=np.bool_)
        for i in range(n):
            if any(not k.validity[i] for k in kids):
                validity[i] = False
                continue
            m = {}
            for k in kids:
                m.update(k.data[i])
            out[i] = m
        return HostColumn(self.data_type, out, validity)


# ---------------------------------------------------------------------------
# lambdas
# ---------------------------------------------------------------------------

class NamedLambdaVariable(Expression):
    """A lambda's variable, typed by the enclosing higher-order function
    when it binds."""

    def __init__(self, name: str, dtype: Optional[T.DataType] = None):
        self.var_name = name
        self._dtype = dtype

    @property
    def data_type(self):
        if self._dtype is None:
            raise ColumnarProcessingError(
                f"unbound lambda variable {self.var_name}")
        return self._dtype

    def with_children(self, children):
        return self

    def bind(self, schema):
        return self  # bound by the higher-order function

    def eval_dev(self, ctx, child_vals, prep):
        raise ColumnarProcessingError(
            f"lambda variable {self.var_name} evaluated outside a lambda")

    def __repr__(self):
        return f"lambda {self.var_name}"

    def eval_cpu(self, table):
        raise ColumnarProcessingError(
            f"lambda variable {self.var_name} evaluated outside a lambda")


class LambdaFunction(Expression):
    """x -> body or (x, y) -> body; the higher-order function rebinds and
    evaluates the body in element space."""

    def __init__(self, body: Expression, var_names: Sequence[str]):
        self.children = (body,)
        self.var_names = tuple(var_names)

    @property
    def body(self):
        return self.children[0]

    @property
    def data_type(self):
        return self.body.data_type

    def with_children(self, children):
        return LambdaFunction(children[0], self.var_names)

    def bind(self, schema):
        return self  # the enclosing higher-order function binds the body

    def eval_dev(self, ctx, child_vals, prep):
        raise ColumnarProcessingError("LambdaFunction evaluated directly")

    def __repr__(self):
        return f"({', '.join(self.var_names)}) -> {self.body!r}"

    def eval_cpu(self, table):
        raise ColumnarProcessingError("LambdaFunction evaluated directly")


def _substitute_vars(e: Expression, mapping) -> Expression:
    if isinstance(e, NamedLambdaVariable):
        got = mapping.get(e.var_name)
        return got if got is not None else e
    if not e.children:
        return e
    return e.with_children([_substitute_vars(c, mapping)
                            for c in e.children])


def _collect_outer_refs(e: Expression, acc: set) -> None:
    if isinstance(e, BoundReference):
        acc.add(e.ordinal)
    for c in e.children:
        _collect_outer_refs(c, acc)


class _HigherOrder(Expression):
    """After binding, ``children`` = (array or map, *outer columns) and
    ``_rebound`` is the body over element-space ordinals."""

    def __init__(self, child: Expression, fn: LambdaFunction,
                 _rebound=None, _outer_children=()):
        self.children = (child,) + tuple(_outer_children)
        self.fn = fn
        self._rebound = _rebound

    def _var_types(self) -> List[T.DataType]:
        raise NotImplementedError

    def key(self):
        return (type(self).__name__, tuple(c.key() for c in self.children),
                self.fn.var_names,
                (self.fn.body if self._rebound is None
                 else self._rebound).key())

    def with_children(self, children):
        return type(self)(children[0], self.fn, self._rebound,
                          tuple(children[1:]))

    def _check_input(self, child: Expression) -> None:
        check_array(child, type(self).__name__)

    def bind(self, schema):
        child = self.children[0].bind(schema)
        self._check_input(child)
        fn = self.fn
        out = type(self)(child, fn)
        vts = out._var_types()
        if len(fn.var_names) > len(vts):
            raise ColumnarProcessingError(
                f"{type(self).__name__} takes a lambda of at most "
                f"{len(vts)} variables")
        mapping = {name: NamedLambdaVariable(name, vt)
                   for name, vt in zip(fn.var_names, vts)}
        typed = _substitute_vars(fn.body, mapping).bind(schema)
        outer: set = set()
        _collect_outer_refs(typed, outer)
        outer_sorted = sorted(outer)
        k = len(vts)
        remap = {o: k + i for i, o in enumerate(outer_sorted)}

        def rebind(e):
            if isinstance(e, NamedLambdaVariable):
                idx = fn.var_names.index(e.var_name)
                return BoundReference(idx, vts[idx], name_hint=e.var_name)
            if isinstance(e, BoundReference):
                return BoundReference(remap[e.ordinal], e.data_type,
                                      name_hint=e.name_hint)
            if not e.children:
                return e
            return e.with_children([rebind(c) for c in e.children])

        outer_children = tuple(
            BoundReference(o, schema[o][1], name_hint=schema[o][0])
            for o in outer_sorted)
        return type(self)(child, fn, rebind(typed), outer_children)

    @property
    def device_supported(self):
        # the element-space gather reads fixed-width outer columns
        return all(fixed_np_dtype(oc.data_type) is not None
                   for oc in self.children[1:])

    def _eval_body_cpu(self, table: HostTable, var_cols: List[HostColumn],
                       rids: np.ndarray) -> HostColumn:
        """The rebound body over the element rows: the variable columns,
        then each outer column taken by element row id."""
        cols = list(var_cols)
        names = [f"__v{i}" for i in range(len(var_cols))]
        for j, c in enumerate(self.children[1:]):
            cols.append(c.eval_cpu(table).take(rids))
            names.append(f"__o{j}")
        return self._rebound.eval_cpu(HostTable(names, cols))

    def prep(self, pctx: PrepCtx, child_preps):
        cols = [SimpleNamespace(dictionary=None, dict_sorted=True,
                                domain=None)
                for _ in range(len(self._var_types())
                               + len(self.children) - 1)]
        sub = PrepCtx(SimpleNamespace(columns=cols))
        body_preps: List[NodePrep] = []
        _walk_prep(self._rebound, sub, body_preps)
        return NodePrep(aux={"body": body_preps})

    def _eval_body(self, ctx: EvalCtx, prep, var_vals: List[DevVal],
                   outer_vals, rid, ecap: int, elem_live, total):
        """The rebound body over element space: variable columns first,
        then each outer column gathered by element row id."""
        cap = ctx.capacity
        safe = rid.clamp(max=cap - 1)
        cols = list(var_vals)
        for ov in outer_vals:
            cols.append(DevVal(ov.data[safe], ov.validity[safe] & (rid < cap)))
        ectx = EvalCtx(cols, total, ecap, ctx.device, live=elem_live,
                       ansi=ctx.ansi)
        if ctx.ansi_guard is not None:
            # a branch's guard over rows, carried to their elements
            ectx.ansi_guard = ctx.ansi_guard[safe] & (rid < cap)
        ectx._prep_iter = iter(prep.aux["body"])
        out = _walk_eval(self._rebound, ectx)
        # the body's ANSI flags are the enclosing walk's
        ctx.ansi_errors.extend(ectx.ansi_errors)
        return out

    def _elements(self, ctx, c):
        """(rid, element liveness, total) of an array or map child."""
        cap = ctx.capacity
        off = c.data.offsets
        ecap = c.data.leaves()[1].shape[0]
        rid = _elem_rids(off, ecap, cap)
        live = (rid < cap) & ctx.row_mask()[rid.clamp(max=cap - 1)]
        return rid, live, off[-1], ecap


class _ArrayLambda(_HigherOrder):
    def _var_types(self):
        return [self.children[0].data_type.element_type, T.INT]

    def _array_body(self, ctx, child_vals, prep):
        c = child_vals[0]
        a: ArrayData = c.data
        rid, live, total, ecap = self._elements(ctx, c)
        var_vals = [DevVal(a.data, a.validity)]
        if len(self.fn.var_names) > 1:
            pos = torch.arange(ecap, device=ctx.device) - \
                a.offsets[rid.clamp(max=ctx.capacity - 1)].to(torch.int64)
            var_vals.append(DevVal(pos.to(torch.int32), live))
        else:
            var_vals.append(DevVal(torch.zeros(ecap, dtype=torch.int32,
                                               device=ctx.device), live))
        body = self._eval_body(ctx, prep, var_vals, child_vals[1:], rid,
                               ecap, live, total)
        return a, rid, live, body, ecap


class ArrayTransform(_ArrayLambda):
    """transform(arr, x -> f(x)) or transform(arr, (x, i) -> f(x, i))."""

    @property
    def data_type(self):
        body = self._rebound if self._rebound is not None else self.fn.body
        return T.ArrayType(body.data_type)

    def eval_dev(self, ctx, child_vals, prep) -> DevVal:
        a, rid, live, body, ecap = self._array_body(ctx, child_vals, prep)
        data = torch.where(body.validity & live, body.data,
                           torch.zeros_like(body.data))
        return DevVal(ArrayData(a.offsets, data, body.validity & live),
                      child_vals[0].validity)

    def eval_cpu(self, table):
        c = self.children[0].eval_cpu(table)
        n = len(c)
        rids, elems, evalid = _flatten_cpu(c)
        vts = self._var_types()
        var_cols = [HostColumn(vts[0], elems, evalid)]
        if len(vts) > 1:
            var_cols.append(HostColumn(T.INT, _positions_cpu(c), np.ones(
                len(elems), dtype=np.bool_)))
        body = self._eval_body_cpu(table, var_cols, rids)
        out = np.empty(n, dtype=object)
        pos = 0
        for i in range(n):
            if c.validity[i]:
                ln = len(c.data[i])
                out[i] = [
                    (body.data[pos + j].item()
                     if hasattr(body.data[pos + j], "item")
                     else body.data[pos + j])
                    if body.validity[pos + j] else None
                    for j in range(ln)]
                pos += ln
        return HostColumn(self.data_type, out, c.validity.copy())


class ArrayFilter(_ArrayLambda):
    """filter(arr, x -> pred): the elements where pred is true, packed by
    one compaction kernel launch."""

    @property
    def data_type(self):
        return self.children[0].data_type

    def eval_dev(self, ctx, child_vals, prep) -> DevVal:
        a, rid, live, body, ecap = self._array_body(ctx, child_vals, prep)
        keep = body.data & body.validity & live
        off, pairs = pack_elements(ctx, keep, rid, [(a.data, a.validity)],
                                   ecap)
        return DevVal(ArrayData(off, *pairs[0]), child_vals[0].validity)

    def eval_cpu(self, table):
        c = self.children[0].eval_cpu(table)
        n = len(c)
        rids, elems, evalid = _flatten_cpu(c)
        vts = self._var_types()
        var_cols = [HostColumn(vts[0], elems, evalid)]
        if len(vts) > 1:
            var_cols.append(HostColumn(T.INT, _positions_cpu(c), np.ones(
                len(elems), dtype=np.bool_)))
        body = self._eval_body_cpu(table, var_cols, rids)
        out = np.empty(n, dtype=object)
        pos = 0
        for i in range(n):
            if c.validity[i]:
                ln = len(c.data[i])
                out[i] = [c.data[i][j] for j in range(ln)
                          if body.validity[pos + j]
                          and bool(body.data[pos + j])]
                pos += ln
        return HostColumn(self.data_type, out, c.validity.copy())


class _ArrayPredicate(_ArrayLambda):
    """exists / forall -- Spark's three-valued logic."""

    exists = True

    def _var_types(self):
        return [self.children[0].data_type.element_type]

    @property
    def data_type(self):
        return T.BOOLEAN

    def eval_dev(self, ctx, child_vals, prep) -> DevVal:
        c = child_vals[0]
        a: ArrayData = c.data
        rid, live, total, ecap = self._elements(ctx, c)
        body = self._eval_body(ctx, prep, [DevVal(a.data, a.validity)],
                               child_vals[1:], rid, ecap, live, total)
        cap = ctx.capacity
        want = body.data if self.exists else ~body.data
        hit = seg_count(want & body.validity & live, rid, cap) > 0
        nulls = seg_count(~body.validity & live, rid, cap) > 0
        validity = (hit | ~nulls) & c.validity
        data = hit if self.exists else ~hit
        return DevVal(data & validity, validity)

    def eval_cpu(self, table):
        c = self.children[0].eval_cpu(table)
        n = len(c)
        rids, elems, evalid = _flatten_cpu(c)
        var_cols = [HostColumn(self._var_types()[0], elems, evalid)]
        body = self._eval_body_cpu(table, var_cols, rids)
        data = np.zeros(n, dtype=np.bool_)
        validity = np.zeros(n, dtype=np.bool_)
        pos = 0
        for i in range(n):
            if not c.validity[i]:
                continue
            ln = len(c.data[i])
            vals = [bool(body.data[pos + j]) if body.validity[pos + j]
                    else None for j in range(ln)]
            pos += ln
            hit = any(v is (True if self.exists else False) for v in vals)
            has_null = any(v is None for v in vals)
            if self.exists:
                data[i], validity[i] = (True, True) if hit else \
                    (False, not has_null)
            else:
                data[i], validity[i] = (False, True) if hit else \
                    (True, not has_null)
        return HostColumn(T.BOOLEAN, data, validity)


class ArrayExists(_ArrayPredicate):
    exists = True


class ArrayForAll(_ArrayPredicate):
    exists = False


class _MapLambda(_HigherOrder):
    """(k, v) lambdas over a map's two element streams."""

    def _var_types(self):
        mt = self.children[0].data_type
        return [mt.key_type, mt.value_type]

    def _check_input(self, child):
        _check_map(child, type(self).__name__)

    def _flatten_map_cpu(self, c):
        rids, keys, kvalid, vals, vvalid = [], [], [], [], []
        for i in range(len(c)):
            if c.validity[i]:
                for k, v in c.data[i].items():
                    rids.append(i)
                    keys.append(k)
                    kvalid.append(True)
                    vals.append(v if v is not None else 0)
                    vvalid.append(v is not None)
        mt = self.children[0].data_type
        return (np.asarray(rids, dtype=np.int64),
                HostColumn(mt.key_type,
                           np.asarray(keys, dtype=fixed_np_dtype(
                               mt.key_type) or object),
                           np.asarray(kvalid, dtype=np.bool_)),
                HostColumn(mt.value_type,
                           np.asarray(vals, dtype=fixed_np_dtype(
                               mt.value_type) or object),
                           np.asarray(vvalid, dtype=np.bool_)))

    def _map_body(self, ctx, child_vals, prep):
        c = child_vals[0]
        m: MapData = c.data
        rid, live, total, ecap = self._elements(ctx, c)
        body = self._eval_body(
            ctx, prep, [DevVal(m.kdata, m.kvalid), DevVal(m.vdata, m.vvalid)],
            child_vals[1:], rid, ecap, live, total)
        return m, rid, live, body, ecap


class MapFilter(_MapLambda):
    """map_filter(m, (k, v) -> pred)."""

    @property
    def data_type(self):
        return self.children[0].data_type

    def eval_dev(self, ctx, child_vals, prep) -> DevVal:
        m, rid, live, body, ecap = self._map_body(ctx, child_vals, prep)
        keep = body.data & body.validity & live & m.kvalid
        off, pairs = pack_elements(ctx, keep, rid, [(m.kdata, m.kvalid),
                                                    (m.vdata, m.vvalid)],
                                   ecap)
        (kd, kv), (vd, vv) = pairs
        return DevVal(MapData(off, kd, kv, vd, vv), child_vals[0].validity)

    def eval_cpu(self, table):
        c = self.children[0].eval_cpu(table)
        rids, kc, vc = self._flatten_map_cpu(c)
        body = self._eval_body_cpu(table, [kc, vc], rids)
        out = np.empty(len(c), dtype=object)
        pos = 0
        for i in range(len(c)):
            if c.validity[i]:
                m = {}
                for k, v in c.data[i].items():
                    if body.validity[pos] and bool(body.data[pos]):
                        m[k] = v
                    pos += 1
                out[i] = m
        return HostColumn(self.data_type, out, c.validity.copy())


class TransformValues(_MapLambda):
    """transform_values(m, (k, v) -> f)."""

    @property
    def data_type(self):
        mt = self.children[0].data_type
        body = self._rebound if self._rebound is not None else self.fn.body
        return T.MapType(key_type=mt.key_type, value_type=body.data_type)

    def eval_dev(self, ctx, child_vals, prep) -> DevVal:
        m, rid, live, body, ecap = self._map_body(ctx, child_vals, prep)
        valid = body.validity & live
        data = torch.where(valid, body.data, torch.zeros_like(body.data))
        return DevVal(MapData(m.offsets, m.kdata, m.kvalid, data, valid),
                      child_vals[0].validity)

    def eval_cpu(self, table):
        c = self.children[0].eval_cpu(table)
        rids, kc, vc = self._flatten_map_cpu(c)
        body = self._eval_body_cpu(table, [kc, vc], rids)
        out = np.empty(len(c), dtype=object)
        pos = 0
        for i in range(len(c)):
            if c.validity[i]:
                m = {}
                for k in c.data[i]:
                    m[k] = (body.data[pos].item()
                            if hasattr(body.data[pos], "item")
                            else body.data[pos]) \
                        if body.validity[pos] else None
                    pos += 1
                out[i] = m
        return HostColumn(self.data_type, out, c.validity.copy())


class TransformKeys(_MapLambda):
    """transform_keys(m, (k, v) -> f). A null new key raises at the
    download (MapData.to_objects); duplicate new keys stay as the
    reference's device leaves them."""

    @property
    def data_type(self):
        mt = self.children[0].data_type
        body = self._rebound if self._rebound is not None else self.fn.body
        return T.MapType(key_type=body.data_type, value_type=mt.value_type)

    def eval_dev(self, ctx, child_vals, prep) -> DevVal:
        m, rid, live, body, ecap = self._map_body(ctx, child_vals, prep)
        valid = body.validity & live
        data = torch.where(valid, body.data, torch.zeros_like(body.data))
        return DevVal(MapData(m.offsets, data, valid, m.vdata, m.vvalid),
                      child_vals[0].validity)

    def eval_cpu(self, table):
        c = self.children[0].eval_cpu(table)
        rids, kc, vc = self._flatten_map_cpu(c)
        body = self._eval_body_cpu(table, [kc, vc], rids)
        out = np.empty(len(c), dtype=object)
        pos = 0
        for i in range(len(c)):
            if c.validity[i]:
                m = {}
                for k, v in c.data[i].items():
                    if not body.validity[pos]:
                        raise ColumnarProcessingError(
                            "Cannot use null as map key")
                    nk = body.data[pos].item() \
                        if hasattr(body.data[pos], "item") else body.data[pos]
                    m[nk] = v
                    pos += 1
                out[i] = m
        return HostColumn(self.data_type, out, c.validity.copy())


class ArraysZip(Expression):
    """arrays_zip(a1, a2, ...) -> array<struct<...>>: no device layout,
    CPU-only in the reference."""

    def __init__(self, *children: Expression):
        self.children = tuple(children)

    @property
    def data_type(self):
        return T.ArrayType(T.StructType([
            T.StructField(str(i), c.data_type.element_type)
            for i, c in enumerate(self.children)]))

    def with_children(self, children):
        return ArraysZip(*children)

    def resolve(self, bound):
        for b in bound:
            if not isinstance(b.data_type, T.ArrayType):
                raise ColumnarProcessingError(
                    f"arrays_zip needs arrays, got "
                    f"{b.data_type.simple_string()}")
        return self.with_children(bound)

    def eval_cpu(self, table):
        kids = [c.eval_cpu(table) for c in self.children]
        n = table.num_rows
        out = np.empty(n, dtype=object)
        validity = np.ones(n, dtype=np.bool_)
        for i in range(n):
            if any(not k.validity[i] for k in kids):
                validity[i] = False
                continue
            ln = max(len(k.data[i]) for k in kids)
            out[i] = [tuple(k.data[i][j] if j < len(k.data[i]) else None
                            for k in kids) for j in range(ln)]
        return HostColumn(self.data_type, out, validity)

# ---------------------------------------------------------------------------
# host evaluation helpers (the CPU route)
# ---------------------------------------------------------------------------


def _flatten_cpu(c: HostColumn):
    rids, elems, evalid = [], [], []
    edt = fixed_np_dtype(c.dtype.element_type)
    for i in range(len(c)):
        if c.validity[i]:
            for v in c.data[i]:
                rids.append(i)
                elems.append(v if v is not None else 0)
                evalid.append(v is not None)
    return (np.asarray(rids, dtype=np.int64),
            np.asarray(elems, dtype=edt or object),
            np.asarray(evalid, dtype=np.bool_))


def _positions_cpu(c: HostColumn):
    pos = []
    for i in range(len(c)):
        if c.validity[i]:
            pos.extend(range(len(c.data[i])))
    return np.asarray(pos, dtype=np.int32)
