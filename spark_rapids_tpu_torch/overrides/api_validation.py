"""API-drift validation (port of
``spark_rapids_tpu/overrides/api_validation.py``, the reference's
ApiValidation.scala): the plan layer (``plan/``), the execs (``execs/``)
and the expressions evolve apart, glued by overrides/rules.py.
``validate_api()`` audits what drifts:

* every plan node with a device rule is a PlanNode with
  ``output_schema``, ``describe`` and the CPU route's ``execute_cpu``;
* every exec class of the exec modules implements ``execute`` or
  ``execute_masked`` (a transition to the host side ``execute_cpu`` or
  ``collect``) and ``output_schema``;
* every registered expression is an Expression with ``with_children``,
  ``key``, ``eval_cpu`` (the CPU route), ``eval_dev`` and ``data_type``,
  and every per-parameter check names a registered class.

Returns the findings (empty: in sync); ``python -m
spark_rapids_tpu_torch.overrides.api_validation`` prints them."""

from __future__ import annotations

import importlib
import pkgutil
from typing import List


def validate_api() -> List[str]:
    from spark_rapids_tpu_torch import execs as execs_pkg
    from spark_rapids_tpu_torch.execs.base import TpuExec
    from spark_rapids_tpu_torch.ops.expr import Expression
    from spark_rapids_tpu_torch.overrides import rules as R
    from spark_rapids_tpu_torch.plan.nodes import PlanNode
    import spark_rapids_tpu_torch.io  # noqa: F401 (registers the scans)
    R._build_expr_sigs()
    findings: List[str] = []

    for node_cls in set(R._DEVICE_NODES) | R._FILE_SCANS:
        where = f"exec rule {node_cls.__name__}"
        if not issubclass(node_cls, PlanNode):
            findings.append(f"{where}: not a PlanNode subclass")
            continue
        for attr in ("output_schema", "describe", "execute_cpu"):
            if not callable(getattr(node_cls, attr, None)):
                findings.append(f"{where}: plan node lacks {attr}()")

    for cls in R._EXPR_SIGS:
        where = f"expression rule {cls.__name__}"
        if not issubclass(cls, Expression):
            findings.append(f"{where}: not an Expression subclass")
            continue
        for attr in ("with_children", "key", "eval_cpu", "eval_dev"):
            if not callable(getattr(cls, attr, None)):
                findings.append(f"{where}: lacks {attr}")
        if "data_type" not in dir(cls):
            findings.append(f"{where}: lacks data_type")
    for cls in R._EXPR_CHECKS:
        if not any(issubclass(reg, cls) for reg in R._EXPR_SIGS):
            findings.append(f"parameter checks of {cls.__name__}: no "
                            "registered expression uses them")

    seen = set()
    for info in pkgutil.iter_modules(execs_pkg.__path__):
        mod = importlib.import_module(
            f"{execs_pkg.__name__}.{info.name}")
        for obj in vars(mod).values():
            if not (isinstance(obj, type) and issubclass(obj, TpuExec)) \
                    or obj in seen:
                continue
            seen.add(obj)
            # a transition to the host side hands over host tables
            runs = (obj.execute is not TpuExec.execute
                    or obj.execute_masked is not TpuExec.execute_masked
                    or callable(getattr(obj, "execute_cpu", None))
                    or callable(getattr(obj, "collect", None)))
            if obj is not TpuExec and not runs:
                findings.append(f"exec {obj.__name__}: lacks execute()")
            if obj is not TpuExec and \
                    obj.output_schema is TpuExec.output_schema:
                findings.append(f"exec {obj.__name__}: lacks "
                                "output_schema()")
    return findings


def main() -> int:
    findings = validate_api()
    if not findings:
        print("api_validation: no drift")
        return 0
    for f in findings:
        print("DRIFT:", f)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
