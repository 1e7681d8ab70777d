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

``MapEntries`` and ``ArraysZip`` produce arrays of structs, which have no
device layout in either package: the reference runs them on its CPU
route, the port raises naming ROADMAP item [9c]."""

from __future__ import annotations

from types import SimpleNamespace
from typing import List, Optional, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import bucket_for
from spark_rapids_tpu_torch.columnar.nested import (
    ArrayData,
    MapData,
    StructData,
    check_layout,
    fixed_np_dtype,
    not_ported_9c,
)
from spark_rapids_tpu_torch.errors import ColumnarProcessingError
from spark_rapids_tpu_torch.ops.collections import (
    _elem_rids,
    check_fixed_array,
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
        check_layout(out.data_type, "named_struct")
        return out

    def eval_dev(self, ctx, child_vals, prep) -> DevVal:
        sd = StructData([(cv.data, cv.validity) for cv in child_vals])
        return DevVal(sd, ctx.row_mask())


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
        check_layout(out.data_type, "map()")
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


def _check_map(e: Expression, what: str) -> None:
    dt = e.data_type
    if not isinstance(dt, T.MapType):
        raise ColumnarProcessingError(
            f"{what} needs a map, got {dt.simple_string()}")
    check_layout(dt, what)


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


class MapValues(_MapUnary):
    @property
    def data_type(self):
        return T.ArrayType(self.children[0].data_type.value_type)

    def eval_dev(self, ctx, child_vals, prep) -> DevVal:
        (c,) = child_vals
        m: MapData = c.data
        return DevVal(ArrayData(m.offsets, m.vdata, m.vvalid), c.validity)


class MapEntries(_MapUnary):
    """map_entries(m) -> array<struct<key, value>>: no device layout
    (arrays hold fixed-width elements), CPU-only in the reference."""

    @property
    def data_type(self):
        mt = self.children[0].data_type
        return T.ArrayType(T.StructType([
            T.StructField("key", mt.key_type, False),
            T.StructField("value", mt.value_type)]))

    def resolve(self, bound):
        not_ported_9c("map_entries")


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
        check_fixed_array(child, type(self).__name__)

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
        for oc in outer_children:
            if fixed_np_dtype(oc.data_type) is None:
                not_ported_9c(f"a lambda reading outer column "
                              f"{oc.name_hint} of type "
                              f"{oc.data_type.simple_string()}")
        return type(self)(child, fn, rebind(typed), outer_children)

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
        ectx = EvalCtx(cols, total, ecap, ctx.device, live=elem_live)
        ectx._prep_iter = iter(prep.aux["body"])
        return _walk_eval(self._rebound, ectx)

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

    def bind(self, schema):
        out = super().bind(schema)
        check_layout(out.data_type, "transform's result")
        return out

    def eval_dev(self, ctx, child_vals, prep) -> DevVal:
        a, rid, live, body, ecap = self._array_body(ctx, child_vals, prep)
        data = torch.where(body.validity & live, body.data,
                           torch.zeros_like(body.data))
        return DevVal(ArrayData(a.offsets, data, body.validity & live),
                      child_vals[0].validity)


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


class TransformValues(_MapLambda):
    """transform_values(m, (k, v) -> f)."""

    @property
    def data_type(self):
        mt = self.children[0].data_type
        body = self._rebound if self._rebound is not None else self.fn.body
        return T.MapType(key_type=mt.key_type, value_type=body.data_type)

    def bind(self, schema):
        out = super().bind(schema)
        check_layout(out.data_type, "transform_values' result")
        return out

    def eval_dev(self, ctx, child_vals, prep) -> DevVal:
        m, rid, live, body, ecap = self._map_body(ctx, child_vals, prep)
        valid = body.validity & live
        data = torch.where(valid, body.data, torch.zeros_like(body.data))
        return DevVal(MapData(m.offsets, m.kdata, m.kvalid, data, valid),
                      child_vals[0].validity)


class TransformKeys(_MapLambda):
    """transform_keys(m, (k, v) -> f). A null new key raises at the
    download (MapData.to_objects); duplicate new keys stay as the
    reference's device leaves them."""

    @property
    def data_type(self):
        mt = self.children[0].data_type
        body = self._rebound if self._rebound is not None else self.fn.body
        return T.MapType(key_type=body.data_type, value_type=mt.value_type)

    def bind(self, schema):
        out = super().bind(schema)
        check_layout(out.data_type, "transform_keys' result")
        return out

    def eval_dev(self, ctx, child_vals, prep) -> DevVal:
        m, rid, live, body, ecap = self._map_body(ctx, child_vals, prep)
        valid = body.validity & live
        data = torch.where(valid, body.data, torch.zeros_like(body.data))
        return DevVal(MapData(m.offsets, data, valid, m.vdata, m.vvalid),
                      child_vals[0].validity)


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
        not_ported_9c("arrays_zip")
