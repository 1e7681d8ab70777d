"""RL-OBS-PASSIVE (port of ``spark_rapids_tpu/lint/rules/obs_passive.py``)
— the telemetry sampler (``obs/telemetry.py``) runs on a background
thread BETWEEN queries by design: it may not touch the device (no torch
device work, no host syncs, no ``finalize_observation`` — that forces the
deferred row-count fetch), may not drive query execution
(``execute``/``collect*``), and may not take the query-path locks (the
device semaphore, the scheduler condition, the session obs lock) —
sampling must never perturb the execution it observes. The module
imports no torch at all: what it reports of the device comes from the
runtime's snapshot surfaces."""

from __future__ import annotations

import ast
from typing import List, Optional

from spark_rapids_tpu_torch.lint.diagnostics import Diagnostic, make
from spark_rapids_tpu_torch.lint.rules.common import (PACKAGE, _attr_chain,
                                                      _host_sync_call)

#: the module RL-OBS-PASSIVE governs (the telemetry sampler + flight
#: recorder — both run off the query path by contract)
_OBS_PASSIVE_MODULE = f"{PACKAGE}/obs/telemetry.py"

#: sanctioned exceptions: "<rel>:<qualified function>" -> justification
_OBS_PASSIVE_ALLOWLIST: dict = {}

#: lock-name fragments that mark a QUERY-PATH lock (the device
#: semaphore, the scheduler's condition, the session's obs lock) —
#: the sampler's own ring lock and the snapshot surfaces' internal
#: locks are fine (each bounds its hold to a dict copy)
_OBS_PASSIVE_LOCK_TOKENS = ("semaphore", "_cond", "_obs_lock")

#: call names that DRIVE execution — the passive module may read
#: state, never create it
_OBS_PASSIVE_EXEC_CALLS = {"execute", "execute_cpu", "execute_masked",
                           "collect", "collect_table", "collect_cpu"}


def _check_obs_passive(rel: str, tree: ast.AST,
                       diags: List[Diagnostic]):
    if rel != _OBS_PASSIVE_MODULE:
        return

    def flag(node, what: str, func: Optional[str]):
        if f"{rel}:{func}" in _OBS_PASSIVE_ALLOWLIST:
            return
        diags.append(make(
            "RL-OBS-PASSIVE", f"{rel}:{node.lineno}",
            f"{what} in the passive telemetry module"
            + (f" (function {func!r})" if func else " (module level)")
            + " — the sampler must never perturb execution: read the "
            "bounded snapshot surfaces only, or allowlist the function "
            "in _OBS_PASSIVE_ALLOWLIST with a justification"))

    def _names_query_lock(expr: ast.AST) -> Optional[str]:
        chain = _attr_chain(expr)
        if isinstance(expr, ast.Call):
            chain = _attr_chain(expr.func)
        low = chain.lower()
        for tok in _OBS_PASSIVE_LOCK_TOKENS:
            if tok in low:
                return chain
        return None

    def walk(node, func: Optional[str]):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            func = f"{func}.{node.name}" if func else node.name
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mod = getattr(node, "module", None) or ""
            names = [a.name for a in node.names]
            if mod == "torch" or mod.startswith("torch.") \
                    or any(n == "torch" or n.startswith("torch.")
                           for n in names):
                flag(node, "torch import (device work)", func)
        elif isinstance(node, ast.Call):
            chain = _attr_chain(node.func)
            sync = _host_sync_call(node)
            if sync:
                flag(node, f"{sync} (host sync)", func)
            elif chain.startswith("torch."):
                flag(node, f"{chain}() (device work)", func)
            elif chain.split(".")[-1] == "finalize_observation":
                flag(node, f"{chain}() (forces the deferred device "
                           "row-count fetch)", func)
            elif chain.split(".")[-1] in _OBS_PASSIVE_EXEC_CALLS:
                flag(node, f"{chain}() (drives query execution)", func)
            elif chain.split(".")[-1] == "acquire":
                locked = _names_query_lock(node.func.value) \
                    if isinstance(node.func, ast.Attribute) else None
                if locked:
                    flag(node, f"{chain}() (query-path lock)", func)
        elif isinstance(node, ast.With):
            for item in node.items:
                locked = _names_query_lock(item.context_expr)
                if locked:
                    flag(node, f"with {locked} (query-path lock)", func)
        for child in ast.iter_child_nodes(node):
            walk(child, func)

    walk(tree, None)
