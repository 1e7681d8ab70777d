"""``from_json`` and ``to_json`` (port of
``spark_rapids_tpu/ops/json_structs.py``: JsonToStructs, StructsToJson).

from_json on the device: strings are dictionary codes, so each DISTINCT
document parses ONCE on the host into per-field value and validity
tables, and the device gathers them by code into a struct's flat field
buffers (columnar/nested.py). A schema of fields without a device layout
(strings, decimals) runs on the CPU route.

to_json formats each struct row on the host: its strings are of unbounded
cardinality, so it runs on the CPU route (``device_supported`` False), as
in the reference."""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.columnar.nested import (
    StructData,
    fixed_np_dtype,
    layout_supported,
)
from spark_rapids_tpu_torch.ops.common import UnaryExpression, \
    dev_remap_codes
from spark_rapids_tpu_torch.ops.expr import DevVal, NodePrep, PrepCtx
from spark_rapids_tpu_torch.ops.strings import cached_prep


def _coerce(v, dt: T.DataType):
    """PERMISSIVE-mode coercion of a parsed json value to a field type;
    None on mismatch."""
    try:
        if v is None:
            return None
        if isinstance(dt, T.BooleanType):
            return v if isinstance(v, bool) else None
        if isinstance(dt, T.IntegralType):
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                return None
            if isinstance(v, float) and not v.is_integer():
                return None
            iv = int(v)
            info = np.iinfo(dt.np_dtype)
            return iv if info.min <= iv <= info.max else None
        if isinstance(dt, (T.FloatType, T.DoubleType)):
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                return None
            return float(v)
        if isinstance(dt, T.StringType):
            return v if isinstance(v, str) else json.dumps(v)
    except (TypeError, ValueError, OverflowError):
        return None
    return None


def _parse_doc(s: Optional[str], st: T.StructType):
    """One json document -> (tuple of field values, row_valid). Spark
    PERMISSIVE mode: malformed/non-object input yields a NON-NULL row
    with every field null; only a null INPUT yields a null struct."""
    nulls = tuple(None for _ in st.fields)
    if s is None:
        return None, False
    try:
        obj = json.loads(s)
    except (json.JSONDecodeError, TypeError):
        return nulls, True
    if not isinstance(obj, dict):
        return nulls, True
    return tuple(_coerce(obj.get(f.name), f.data_type)
                 for f in st.fields), True


class JsonToStructs(UnaryExpression):
    """from_json(col, schema) — PERMISSIVE mode (malformed -> null row)."""

    def __init__(self, child, schema: T.StructType):
        super().__init__(child)
        self.schema = schema

    @property
    def data_type(self):
        return self.schema

    def with_children(self, children):
        return JsonToStructs(children[0], self.schema)

    @property
    def device_supported(self):
        return (isinstance(self.children[0].data_type, T.StringType)
                and layout_supported(self.schema))

    def eval_cpu(self, table: HostTable) -> HostColumn:
        c = self.children[0].eval_cpu(table)
        n = len(c)
        out = np.empty(n, dtype=object)
        validity = np.zeros(n, dtype=np.bool_)
        for i in range(n):
            if c.validity[i]:
                row, ok = _parse_doc(c.data[i], self.schema)
                if ok:
                    out[i] = row
                    validity[i] = True
        return HostColumn(self.schema, out, validity)

    def prep(self, pctx: PrepCtx, child_preps) -> NodePrep:
        d = child_preps[0].out_dict
        d = np.array([], dtype=object) if d is None else d
        dev = pctx.table.device

        def build():
            nd = max(len(d), 1)
            ok = np.zeros(nd, dtype=np.bool_)
            vals = [np.zeros(nd, dtype=fixed_np_dtype(f.data_type))
                    for f in self.schema.fields]
            oks = [np.zeros(nd, dtype=np.bool_) for _ in self.schema.fields]
            for i, s in enumerate(d):
                row, row_ok = _parse_doc(s, self.schema)
                ok[i] = row_ok
                if row_ok:
                    for fi, v in enumerate(row):
                        if v is not None:
                            vals[fi][i] = v
                            oks[fi][i] = True

            def put(a):
                return torch.from_numpy(a).to(dev)
            return NodePrep(aux={"ok": put(ok),
                                 "fields": [(put(v), put(o))
                                            for v, o in zip(vals, oks)]})
        return cached_prep(self, d, dev, build)

    def eval_dev(self, ctx, child_vals, prep) -> DevVal:
        (c,) = child_vals
        row_valid = c.validity & dev_remap_codes(prep.aux["ok"], c.data)
        fields = [(dev_remap_codes(v, c.data),
                   dev_remap_codes(o, c.data) & row_valid)
                  for v, o in prep.aux["fields"]]
        return DevVal(StructData(fields), row_valid)


def _json_scalar(v, dt: T.DataType):
    if isinstance(dt, T.StringType):
        return json.dumps(v)
    if isinstance(dt, T.BooleanType):
        return "true" if v else "false"
    if isinstance(dt, (T.FloatType, T.DoubleType)):
        f = float(v)
        return json.dumps(int(f)) if f.is_integer() else json.dumps(f)
    return json.dumps(v.item() if hasattr(v, "item") else v)


class StructsToJson(UnaryExpression):
    """to_json(struct) — host formatting (unbounded string cardinality is
    the date_format carve-out; reference gates similar shapes)."""

    device_supported = False

    @property
    def data_type(self):
        return T.STRING

    def with_children(self, children):
        return StructsToJson(children[0])

    def eval_cpu(self, table: HostTable) -> HostColumn:
        c = self.children[0].eval_cpu(table)
        st: T.StructType = self.children[0].data_type
        n = len(c)
        out = np.empty(n, dtype=object)
        for i in range(n):
            if c.validity[i]:
                row = c.data[i]
                parts = []
                for fi, f in enumerate(st.fields):
                    v = (row.get(f.name) if isinstance(row, dict)
                         else row[fi])
                    if v is None:
                        continue  # Spark omits null fields
                    parts.append(
                        f"{json.dumps(f.name)}:{_json_scalar(v, f.data_type)}")
                out[i] = "{" + ",".join(parts) + "}"
        return HostColumn(T.STRING, out, c.validity.copy())
