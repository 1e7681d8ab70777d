"""The Generate exec: explode / posexplode [outer] (port of
``spark_rapids_tpu/execs/generate.py``).

The array column already lives flattened as (offsets, elements, element
validity), so explode is a GATHER, not a loop: each element slot finds
its source row with one ``searchsorted`` over the offsets, the passing
columns gather by that row id, and one launch of the compaction kernel
packs the live slots. Outer mode appends one row for each null or empty
array after the element rows (the rows in their order, the position and
element null), as the reference does: those rows ride the same
compaction as a second stream of slots, one per input row."""

from __future__ import annotations

from typing import Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import (
    DeviceColumn,
    DeviceTable,
    bucket_for,
)
from spark_rapids_tpu_torch.execs.base import TpuExec
from spark_rapids_tpu_torch.ops.collections import _elem_rids
from spark_rapids_tpu_torch.ops.expr import (
    Expression,
    PrepCtx,
    eval_expr,
    prep_expr,
    table_vals,
)


class TpuGenerateExec(TpuExec):
    def __init__(self, child: TpuExec, gen_child: Expression,
                 pos: bool, outer: bool, out_names: Sequence[str],
                 required: Sequence[str] = ()):
        self.children = (child,)
        self.gen_child = gen_child
        self.pos = pos
        self.outer = outer
        self.out_names = list(out_names)
        self.required = list(required)

    def output_schema(self):
        child_schema = dict(self.children[0].output_schema())
        out = [(n, child_schema[n]) for n in self.required]
        i = 0
        if self.pos:
            out.append((self.out_names[i], T.INT))
            i += 1
        out.append((self.out_names[i],
                    self.gen_child.data_type.element_type))
        return out

    def describe(self):
        kind = ("posexplode" if self.pos else "explode") + \
            ("_outer" if self.outer else "")
        return f"TpuGenerate[{kind}]"

    def execute(self):
        from spark_rapids_tpu_torch.runtime.retry import with_retry
        for batch in self.children[0].execute():
            yield from with_retry(batch, self._generate, splittable=False)
            del batch

    def _generate(self, full: DeviceTable) -> DeviceTable:
        from spark_rapids_tpu_torch.ops.scatter32 import compact_pairs
        dev, cap = full.device, full.capacity
        keep_ix = [full.names.index(n) for n in self.required]
        arr = eval_expr(self.gen_child,
                        prep_expr(self.gen_child, PrepCtx(full)),
                        table_vals(full), full.nrows_dev, cap, dev,
                        live=full.live)
        a = arr.data
        ecap = a.data.shape[0]
        row_ok = arr.validity & full.row_mask()
        rid = _elem_rids(a.offsets, ecap, cap)
        safe = rid.clamp(max=cap - 1)
        live = (rid < cap) & row_ok[safe]
        pos_val = (torch.arange(ecap, device=dev)
                   - a.offsets[safe].to(torch.int64)).to(torch.int32)
        elem = torch.where(a.validity, a.data, torch.zeros_like(a.data))
        src, keep = safe, live
        pos_valid = live
        elem_valid = a.validity & live
        if self.outer:
            # one extra slot a row: the rows whose array is null or empty
            lens = a.offsets[1:] - a.offsets[:-1]
            empty = full.row_mask() & (~arr.validity | (lens == 0))
            rows = torch.arange(cap, device=dev)
            src = torch.cat([safe, rows])
            keep = torch.cat([live, empty])
            no = torch.zeros(cap, dtype=torch.bool, device=dev)
            pos_valid = torch.cat([live, no])
            elem_valid = torch.cat([elem_valid, no])
            pos_val = torch.cat([pos_val, torch.zeros(cap, dtype=torch.int32,
                                                      device=dev)])
            elem = torch.cat([elem, torch.zeros(cap, dtype=elem.dtype,
                                                device=dev)])
        n_slots = keep.shape[0]
        out_cap = bucket_for(n_slots)
        if out_cap > n_slots:
            pad = out_cap - n_slots

            def grow(x, fill=0):
                return torch.cat([x, torch.full((pad,), fill, dtype=x.dtype,
                                                device=dev)])

            src, keep = grow(src), grow(keep, False)
            pos_val, pos_valid = grow(pos_val), grow(pos_valid, False)
            elem, elem_valid = grow(elem), grow(elem_valid, False)
        datas, valids = [], []
        for i in keep_ix:
            c = full.columns[i]
            datas.append(c.data[src])
            valids.append(c.validity[src])
        if self.pos:
            datas.append(pos_val)
            valids.append(pos_valid)
        datas.append(elem)
        valids.append(elem_valid)
        pairs, nout = compact_pairs(datas, valids, keep, out_cap)
        out_cols, names = [], []
        for j, i in enumerate(keep_ix):
            c = full.columns[i]
            out_cols.append(DeviceColumn(
                c.dtype, pairs[j][0], pairs[j][1], dictionary=c.dictionary,
                dict_sorted=c.dict_sorted, domain=c.domain))
            names.append(full.names[i])
        j = len(keep_ix)
        oi = 0
        if self.pos:
            out_cols.append(DeviceColumn(T.INT, *pairs[j]))
            names.append(self.out_names[oi])
            j += 1
            oi += 1
        out_cols.append(DeviceColumn(self.gen_child.data_type.element_type,
                                     *pairs[j]))
        names.append(self.out_names[oi])
        return DeviceTable(names, out_cols, nout, out_cap, dev)
