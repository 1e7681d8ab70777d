"""JSON path expressions (port of ``spark_rapids_tpu/ops/json_fns.py``:
``get_json_object`` and ``json_tuple``).

Device strings are dictionary codes (columnar/column.py), so extraction
runs ONCE per DISTINCT document on the host (stdlib json) and the device
gathers results by code: the dictionary transform of every string
function (ops/strings.py). A path that is not a literal runs on the CPU
route, per row. Spark
semantics: '$'-rooted paths with .field / ['field'] / [index] / [*]
steps; strings return unquoted, other scalars their JSON literal,
objects/arrays compact JSON, anything unresolvable -> null."""

from __future__ import annotations

import json
import re
from typing import List, Optional, Union

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.errors import ColumnarProcessingError
import numpy as np

from spark_rapids_tpu_torch.columnar import HostColumn
from spark_rapids_tpu_torch.ops.expr import Expression, Literal
from spark_rapids_tpu_torch.ops.strings import DictStringToString

_STEP_RE = re.compile(
    r"\.(?P<field>[A-Za-z_][A-Za-z0-9_]*)"
    r"|\[\s*'(?P<qfield>[^']*)'\s*\]"
    r"|\[\s*\"(?P<dqfield>[^\"]*)\"\s*\]"
    r"|\[\s*(?P<index>\d+)\s*\]"
    r"|\[\s*(?P<star>\*)\s*\]")


def parse_json_path(path: str) -> Optional[List[Union[str, int]]]:
    """'$.a[0].b' -> ['a', 0, 'b']; '*' marks a wildcard step; None for
    malformed paths (Spark: whole expression yields null)."""
    if not path or path[0] != "$":
        return None
    steps: List[Union[str, int]] = []
    pos = 1
    while pos < len(path):
        m = _STEP_RE.match(path, pos)
        if m is None:
            return None
        if m.group("field") is not None:
            steps.append(m.group("field"))
        elif m.group("qfield") is not None:
            steps.append(m.group("qfield"))
        elif m.group("dqfield") is not None:
            steps.append(m.group("dqfield"))
        elif m.group("index") is not None:
            steps.append(int(m.group("index")))
        else:
            steps.append("*")
        pos = m.end()
    return steps


def _walk(value, steps: List[Union[str, int]], depth: int = 0):
    """Returns (matched, result) where wildcard steps collect lists."""
    if depth == len(steps):
        return True, value
    step = steps[depth]
    if step == "*":
        if not isinstance(value, list):
            return False, None
        out = []
        for item in value:
            ok, r = _walk(item, steps, depth + 1)
            if ok:
                out.append(r)
        if not out:
            return False, None
        return True, out if len(out) > 1 else out[0]
    if isinstance(step, int):
        if isinstance(value, list) and 0 <= step < len(value):
            return _walk(value[step], steps, depth + 1)
        return False, None
    if isinstance(value, dict) and step in value:
        return _walk(value[step], steps, depth + 1)
    return False, None


def extract_json(doc: str, steps: List[Union[str, int]]) -> Optional[str]:
    try:
        value = json.loads(doc)
    except (ValueError, TypeError):
        return None
    ok, r = _walk(value, steps)
    if not ok or r is None:
        return None
    if isinstance(r, str):
        return r  # strings unquote (Spark)
    if isinstance(r, bool):
        return "true" if r else "false"
    if isinstance(r, (int, float)):
        return json.dumps(r)
    return json.dumps(r, separators=(",", ":"))


class GetJsonObject(DictStringToString):
    """get_json_object(json, path) — path must be a literal (the
    reference requires a foldable path too)."""

    def __init__(self, child: Expression, path: Expression):
        self.children = (child, path)
        self._steps = None
        if isinstance(path, Literal) and path.value is not None:
            self._steps = parse_json_path(str(path.value))

    def with_children(self, children):
        return GetJsonObject(children[0], children[1])

    @property
    def device_supported(self):
        return isinstance(self.children[1], Literal)

    def transform(self, s: str) -> Optional[str]:
        if self._steps is None:
            return None  # malformed literal path -> null per row (Spark)
        return extract_json(s, self._steps)

    def eval_cpu(self, table):
        if isinstance(self.children[1], Literal):
            return super().eval_cpu(table)
        # a non-literal path: the CPU route evaluates it per row
        doc = self.children[0].eval_cpu(table)
        pth = self.children[1].eval_cpu(table)
        n = len(doc)
        out = np.empty(n, dtype=object)
        validity = (doc.validity & pth.validity).copy()
        for i in range(n):
            r = None
            if validity[i]:
                steps = parse_json_path(str(pth.data[i]))
                if steps is not None:
                    r = extract_json(doc.data[i], steps)
            out[i] = r
            validity[i] = r is not None
        return HostColumn(T.STRING, out, validity)


def json_tuple(json_expr, *fields):
    """json_tuple(col, 'f1', 'f2', ...) expands to one top-level field
    extraction per name (Spark plans JsonTuple via Generate; the
    extraction semantics are the GetJsonObject fast path c0..cN)."""
    from spark_rapids_tpu_torch.ops.expr import col as _col
    from spark_rapids_tpu_torch.ops.expr import lit as _lit
    e = _col(json_expr) if isinstance(json_expr, str) else json_expr
    out = []
    for i, f in enumerate(fields):
        if not isinstance(f, str):
            raise ColumnarProcessingError("json_tuple fields must be "
                                          "string literals")
        out.append(GetJsonObject(e, _lit(f"$.{f}")).alias(f"c{i}"))
    return out
