"""RL-MV-EPOCH (port of ``spark_rapids_tpu/lint/rules/streaming_epoch.py``)
— MV/stream maintenance lives in streaming/ and must drive cache
coherence through the invalidation-epoch API only — a direct
result-cache mutation there would race the scheduler's epoch-vector
staleness checks."""

from __future__ import annotations

import ast
from typing import List

from spark_rapids_tpu_torch.lint.diagnostics import Diagnostic, make
from spark_rapids_tpu_torch.lint.rules.common import PACKAGE, _attr_chain

#: the ONLY names streaming/ may import from service/result_cache — the
#: invalidation-epoch API (all re-exported from plan/fingerprint).
#: Anything else (ResultCache itself, its mutators) is a second write
#: path into cache coherence.
_MV_EPOCH_ALLOWED_IMPORTS = frozenset({
    "GLOBAL_EPOCH_KEY",
    "bump_invalidation_epoch",
    "bump_table_epoch",
    "delta_table_id",
    "epoch_snapshot",
    "epochs_current",
    "invalidation_epoch",
    "plan_table_ids",
    "register_epoch_listener",
    "table_epoch",
    "unregister_epoch_listener",
})

_MV_CACHE_MUTATORS = ("put", "clear", "pop", "evict", "invalidate")


def _check_mv_epoch(rel: str, tree: ast.AST, diags: List[Diagnostic]):
    if not rel.startswith(f"{PACKAGE}/streaming/"):
        return
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.endswith("service.result_cache"):
            for alias in node.names:
                if alias.name not in _MV_EPOCH_ALLOWED_IMPORTS:
                    diags.append(make(
                        "RL-MV-EPOCH", f"{rel}:{node.lineno}",
                        f"import of {alias.name!r} from service/"
                        "result_cache in streaming/ — only the "
                        "invalidation-epoch API may cross this "
                        "boundary"))
        elif isinstance(node, ast.Attribute) and node.attr == "_entries":
            diags.append(make(
                "RL-MV-EPOCH", f"{rel}:{node.lineno}",
                "direct access to a result cache's _entries from "
                "streaming/ — mark staleness via bump_table_epoch, "
                "never by reaching into the cache"))
        elif isinstance(node, ast.Call):
            chain = _attr_chain(node.func)
            parts = chain.split(".")
            if len(parts) >= 2 and parts[-1] in _MV_CACHE_MUTATORS \
                    and any("result_cache" in p or p == "cache"
                            for p in parts[:-1]):
                diags.append(make(
                    "RL-MV-EPOCH", f"{rel}:{node.lineno}",
                    f"{chain}() mutates a result cache from "
                    "streaming/ — MV maintenance owns its own "
                    "tables; cache invalidation goes through the "
                    "epoch API"))
