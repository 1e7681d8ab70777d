"""The port's static-analysis layer: plan verifier, registry auditor,
repo lint (port of ``spark_rapids_tpu/lint/``, with the reference's
module names, rule ids, diagnostic format and CLI contract).

Reference analogs: the spark-rapids ``spark.rapids.sql.test.enabled``
assert-on-fallback harness and Catalyst's plan-integrity validation.
Three tools, one diagnostic format:

* ``plan_verifier.verify_converted`` — walks a converted physical plan
  (after the overrides, AQE's deferred build nodes and the CPU route's
  transitions included) and asserts cross-layer invariants: schema
  contracts, device/host transitions, exchange partitioning, decimal
  precision/scale, TypeSig conformance, fallback-reason hygiene.
* ``registry_audit.audit_registry`` — cross-checks the expression
  classes against the overrides registries, ExprChecks signatures, kill
  switches, SQL exposure, conf readers and the port's committed
  ``spark_rapids_tpu_torch/docs/SUPPORTED_OPS.md`` / ``CONFIGS.md``.
* ``repo_lint.lint_repo`` — a Python-AST lint of ``spark_rapids_tpu_torch/``
  and ``chip_smoke.py`` enforcing what the type system can't (host
  syncs in hot paths, torch outside the device layers, undeclared conf
  keys, nondeterminism in kernels, dead lambdas, raw device landings...)
  and, over the whole tree, the lock-order contract of ``lockorder.py``
  (``concurrency.check_concurrency``: RL-LOCK-DECL, RL-LOCK-ORDER,
  RL-LOCK-EFFECT).

All three run from one CLI (``python -m spark_rapids_tpu_torch.lint``;
``--device cpu`` off the card) and from ``tests/test_torch_lint.py``. The
plan verifier also runs inline on every fresh conversion of a
``TorchSession`` under ``spark.rapids.sql.planVerify.mode =
off|warn|error``, and the runtime lock witness checks every acquisition
of the locks a session or a query service builds while
``spark.rapids.lint.lockWitness`` arms it.
"""

from spark_rapids_tpu_torch.lint.diagnostics import Diagnostic, RULES, rule_ids

__all__ = [
    "Diagnostic",
    "RULES",
    "rule_ids",
    "verify_converted",
    "verify_plan",
    "audit_registry",
    "lint_repo",
    "run_all",
]


def verify_converted(executable, meta=None, conf=None):
    from spark_rapids_tpu_torch.lint.plan_verifier import (
        verify_converted as _v,
    )
    return _v(executable, meta, conf)


def verify_plan(plan, conf=None, device=None):
    from spark_rapids_tpu_torch.lint.plan_verifier import verify_plan as _v
    return _v(plan, conf, device)


def audit_registry(repo_root=None):
    from spark_rapids_tpu_torch.lint.registry_audit import (
        audit_registry as _a,
    )
    return _a(repo_root)


def lint_repo(repo_root=None):
    from spark_rapids_tpu_torch.lint.repo_lint import lint_repo as _l
    return _l(repo_root)


def run_all(repo_root=None, scale_factor: float = 0.01,
            include_plans: bool = True, device=None):
    """Run repo lint + registry audit (+ the golden-suite plan
    verification, converted for ``device``) and return every
    diagnostic."""
    diags = list(lint_repo(repo_root))
    diags += list(audit_registry(repo_root))
    if include_plans:
        from spark_rapids_tpu_torch.lint.golden import verify_golden_plans
        diags += list(verify_golden_plans(scale_factor=scale_factor,
                                          device=device))
    return diags
