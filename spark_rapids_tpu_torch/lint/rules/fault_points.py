"""RL-FAULT-POINT (port of ``spark_rapids_tpu/lint/rules/fault_points.py``)
— the chaos harness's fault-point registry (runtime/faults.FAULT_POINTS,
the mesh and host domains included) and the ``fault_point("<name>")``
call sites must agree in both directions: every registered point names
an existing site in its registered module, every site uses a registered
name, and names are string literals (a computed name would dodge the
audit)."""

from __future__ import annotations

import ast
from typing import List

from spark_rapids_tpu_torch.lint.diagnostics import Diagnostic, make
from spark_rapids_tpu_torch.lint.rules.common import _attr_chain


def _is_fault_point_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    chain = _attr_chain(node.func)
    return chain == "fault_point" or chain.endswith(".fault_point")


def _check_fault_sites(rel: str, tree: ast.AST, calls,
                       diags: List[Diagnostic]):
    """Per-file half of RL-FAULT-POINT: record every fault_point call
    into ``calls`` (name -> [file:line]) and flag non-literal or
    unregistered names at the site."""
    from spark_rapids_tpu_torch.runtime.faults import FAULT_POINTS
    for node in ast.walk(tree):
        if not _is_fault_point_call(node):
            continue
        arg = node.args[0] if node.args else None
        if not (isinstance(arg, ast.Constant) and isinstance(arg.value, str)):
            diags.append(make(
                "RL-FAULT-POINT", f"{rel}:{node.lineno}",
                "fault_point() name must be a string literal so the "
                "registry audit can see it"))
            continue
        name = arg.value
        if name not in FAULT_POINTS:
            diags.append(make(
                "RL-FAULT-POINT", f"{rel}:{node.lineno}",
                f"fault_point({name!r}) is not registered in "
                "runtime/faults.FAULT_POINTS"))
            continue
        calls.setdefault(name, []).append(f"{rel}:{node.lineno}")


def _check_fault_registry(calls, diags: List[Diagnostic]):
    """Cross-file half of RL-FAULT-POINT: every registered point must
    name at least one existing call site, and a site must live in the
    module the registry claims hosts it (stale registry entries would
    otherwise advertise injectable faults that never fire)."""
    from spark_rapids_tpu_torch.runtime.faults import FAULT_POINTS
    for name, (module, _doc) in sorted(FAULT_POINTS.items()):
        sites = calls.get(name, [])
        if not sites:
            diags.append(make(
                "RL-FAULT-POINT", f"faults.FAULT_POINTS[{name!r}]",
                f"registered fault point has no fault_point({name!r}) "
                "call site anywhere in the repo"))
        elif not any(s.rsplit(":", 1)[0] == module for s in sites):
            diags.append(make(
                "RL-FAULT-POINT", f"faults.FAULT_POINTS[{name!r}]",
                f"no call site in the registered module {module} "
                f"(found: {', '.join(sites)})"))
