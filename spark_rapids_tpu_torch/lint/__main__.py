"""CLI: ``python -m spark_rapids_tpu_torch.lint`` (port of
``spark_rapids_tpu/lint/__main__.py``).

Runs the repo lint (the lock-order contract's RL-LOCK-* among its
rules), the registry auditor, the golden-suite plan
verification (TPC-H q1-q22, DSL + SQL, AQE on/off, converted for
``--device``) and the executed metrics slice, and exits non-zero on any
diagnostic — the correctness gate every change runs under. ``--device``
defaults to the card; ``--device cpu`` runs everything off it.

Exit status: 0 when every phase ran clean, 1 when ANY diagnostic was
produced (CI gates on it). ``--json`` swaps the human output for one
machine-readable JSON object on stdout::

    {"phases": {"repo": 0, ...},
     "diagnostics": [{"rule_id": ..., "path": ..., "message": ...,
                      "severity": ...}, ...],
     "ok": true/false}

with the same exit-status contract."""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m spark_rapids_tpu_torch.lint",
        description="plan verifier + registry auditor + repo lint "
                    "(with the lock-order contract)")
    ap.add_argument("--skip-repo", action="store_true",
                    help="skip the Python-AST repo lint")
    ap.add_argument("--skip-registry", action="store_true",
                    help="skip the registry/doc-drift audit")
    ap.add_argument("--skip-plans", action="store_true",
                    help="skip golden-suite (TPC-H q1-q22) plan "
                         "verification")
    ap.add_argument("--skip-exec-metrics", action="store_true",
                    help="skip the RA-ESSENTIAL-METRICS executed-corpus "
                         "audit (runs a golden-corpus slice)")
    ap.add_argument("--sf", type=float, default=0.01,
                    help="scale factor for golden-suite table generation")
    ap.add_argument("--device", default=None,
                    help="torch device the golden plans convert for and "
                         "the metrics slice runs on (default: the card; "
                         "'cpu' off it)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print every rule id and exit")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON object (phases, diagnostics, "
                         "ok) instead of human-readable lines; exit "
                         "status stays 1 on any diagnostic")
    ap.add_argument("--repo-root", default=None, metavar="DIR",
                    help="root directory the repo lint scans (default: "
                         "the installed checkout; the smoke tests "
                         "point it at tiny synthetic trees)")
    ap.add_argument("--write-docs", action="store_true",
                    help="regenerate the port's SUPPORTED_OPS.md, "
                         "CONFIGS.md and LOCKS.md "
                         "(spark_rapids_tpu_torch/docs/) from the "
                         "registries, then exit")
    args = ap.parse_args(argv)

    from spark_rapids_tpu_torch.lint.diagnostics import RULES
    if args.list_rules:
        for rid in sorted(RULES):
            print(f"{rid:22s} {RULES[rid]}")
        return 0
    if args.write_docs:
        from spark_rapids_tpu_torch.lint.registry_audit import regenerate_docs
        for path in regenerate_docs():
            print(f"wrote {path}")
        return 0

    quiet = args.json
    diags = []
    ran = []
    phases = {}

    def phase(name: str, label: str, found):
        if not quiet:
            print(f"{label}: {len(found)} diagnostic(s)")
        diags.extend(found)
        ran.append(label)
        phases[name] = len(found)

    if not args.skip_repo:
        from spark_rapids_tpu_torch.lint.repo_lint import lint_repo
        phase("repo", "repo lint", lint_repo(repo_root=args.repo_root))
    if not args.skip_registry:
        from spark_rapids_tpu_torch.lint.registry_audit import audit_registry
        phase("registry", "registry audit", audit_registry())
    if not args.skip_plans:
        from spark_rapids_tpu_torch.lint.golden import verify_golden_plans
        phase("plans", "golden-suite plan verify",
              verify_golden_plans(scale_factor=args.sf, device=args.device))
    if not args.skip_exec_metrics:
        from spark_rapids_tpu_torch.lint.registry_audit import (
            audit_exec_metrics,
        )
        phase("exec_metrics", "exec-metrics audit",
              audit_exec_metrics(device=args.device))

    if args.json:
        print(json.dumps({
            "phases": phases,
            "diagnostics": [
                {"rule_id": d.rule_id, "path": d.path,
                 "message": d.message, "severity": d.severity}
                for d in diags],
            "ok": not diags,
        }, indent=2, sort_keys=True))
        return 1 if diags else 0

    for d in diags:
        print(str(d))
    if diags:
        print(f"FAILED: {len(diags)} diagnostic(s)")
        return 1
    print(f"OK: {', '.join(ran) if ran else 'nothing checked'} clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
