"""RL-CONF-KEY (port of ``spark_rapids_tpu/lint/rules/conf_keys.py``) —
every ``spark.*`` conf key referenced as a string literal must be
declared in the port's conf registry (a typo'd key raises only where a
conf is built from it; read elsewhere it would silently fall back to the
default). The per-operator kill switches are read generically by name
and are not declared: their keys are checked by RA-KILL-SWITCH."""

from __future__ import annotations

import ast
import re
from typing import List

from spark_rapids_tpu_torch.lint.diagnostics import Diagnostic, make

_CONF_KEY_RE = re.compile(r"^spark\.(rapids|sql)\.[A-Za-z0-9_]"
                          r"[A-Za-z0-9_.]*[A-Za-z0-9_]$")

#: the kill switches' key prefixes (conf.py ``_KILL_SWITCH_PREFIXES``)
_KILL_SWITCH_PREFIXES = ("spark.rapids.sql.exec.",
                         "spark.rapids.sql.expression.")


def _check_conf_keys(rel: str, tree: ast.AST, declared,
                     diags: List[Diagnostic]):
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Constant)
                and isinstance(node.value, str)):
            continue
        v = node.value
        if not _CONF_KEY_RE.match(v):
            continue
        if v in declared:
            continue
        if v.startswith(_KILL_SWITCH_PREFIXES) and v.count(".") == 4:
            continue
        diags.append(make(
            "RL-CONF-KEY", f"{rel}:{node.lineno}",
            f"conf key {v!r} is not declared in the conf registry — "
            "typo, or a key removed without cleaning its references"))
