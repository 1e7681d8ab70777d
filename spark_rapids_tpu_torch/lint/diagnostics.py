"""Structured diagnostics and the rule registry (port of
``spark_rapids_tpu/lint/diagnostics.py``).

Every lint finding is a ``Diagnostic`` carrying a stable rule id, a
location path (a plan path like ``Join.left.Project`` for the verifier, a
``file:line`` for the repo lint, a registry coordinate for the auditor)
and a human message. Rule ids are registered here so the CLI can list
them and tests can assert the id surface is complete. The ids and the
format are the reference's; ``RULES`` holds the rules the port runs (the
lock-order contract, RL-LOCK-* and RA-DOC-DRIFT-LOCKS, is not ported)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List


@dataclass(frozen=True)
class Diagnostic:
    rule_id: str
    path: str
    message: str
    severity: str = "error"

    def __str__(self) -> str:
        return f"[{self.rule_id}] {self.path}: {self.message}"


#: rule id -> one-line description (the CLI's --list-rules output; the
#: lint tests assert every id here has at least one negative test)
RULES: Dict[str, str] = {
    # -- plan verifier ------------------------------------------------------
    "PV-SCHEMA": "node output schema malformed or pass-through schema "
                 "diverges from its child",
    "PV-TRANSITION": "device/host boundary crossed without a "
                     "HostToDevice / DeviceToHost / InputAdapter node",
    "PV-EXCHANGE": "exchange partitioning inconsistent (mode, keys, "
                   "partition count)",
    "PV-BOUNDREF": "bound reference ordinal/type disagrees with the "
                   "child's output schema",
    "PV-TYPESIG": "device exec carries an expression outside its "
                  "declared TypeSig",
    "PV-DECIMAL": "decimal precision/scale invalid or arithmetic result "
                  "type diverges from the Spark promotion rules",
    "PV-NULLABLE": "expression nullability contract violated "
                   "(non-nullable claim over nullable inputs)",
    "PV-FALLBACK": "fallback bookkeeping broken (empty reason, reason "
                   "missing from explain(), or convertible node without "
                   "a rule)",
    "PV-AGG": "aggregate contract violated (spec arity, non-aggregate "
              "spec, unsupported device aggregate)",
    "PV-JOIN": "join contract violated (key arity/type mismatch, "
               "unsupported join type)",
    # -- registry auditor ---------------------------------------------------
    "RA-UNREGISTERED": "expression class with a device form (eval_dev) "
                       "but no overrides registration (silently CPU)",
    "RA-PARAM-ARITY": "ExprChecks parameter signature count exceeds the "
                      "expression's constructor arity",
    "RA-KILL-SWITCH": "per-op kill-switch conf key matches no registered "
                      "exec rule or expression",
    "RA-SQL-EXPOSURE": "device-supported operator not exposed through "
                       "the SQL function registry",
    "RA-DOC-DRIFT-OPS": "committed spark_rapids_tpu_torch/docs/"
                        "SUPPORTED_OPS.md differs from the generator "
                        "output",
    "RA-DOC-DRIFT-CONFIGS": "committed spark_rapids_tpu_torch/docs/"
                            "CONFIGS.md differs from the generator "
                            "output",
    "RA-CONF-ORPHAN": "conf key declared in the registry but never "
                      "read by the engine or its harnesses",
    "RA-ESSENTIAL-METRICS": "an executed exec failed to emit the "
                            "ESSENTIAL opTime/numOutputRows/"
                            "numOutputBatches metrics after a "
                            "golden-corpus run (observation boundary "
                            "not installed or bypassed)",
    # -- repo lint ----------------------------------------------------------
    "RL-HOST-SYNC": "host synchronization (.cpu(), .item()/.tolist()/"
                    ".numpy() on a torch value, int/float/bool over a "
                    "torch expression, torch.cuda.synchronize, "
                    ".synchronize()) in an execs/ or ops/ hot path "
                    "outside the sanctioned dispatch.host_fetch and the "
                    "by-design allowlist",
    "RL-JNP-SCOPE": "torch imported outside the device layers",
    "RL-CONF-KEY": "conf key referenced via string literal but not "
                   "declared in the conf registry",
    "RL-NONDETERMINISM": "wall-clock or unseeded randomness inside a "
                         "kernel module",
    "RL-DEAD-LAMBDA": "lambda bound to a name that is never used",
    "RL-FAULT-POINT": "fault-point registry and fault_point() call sites "
                      "out of sync (unregistered name, non-literal name, "
                      "registered point with no site, or site outside "
                      "its registered module)",
    "RL-THREAD-SHARED": "module-global or class-level mutable state in "
                        "runtime/, shuffle/, service/ or streaming/ "
                        "written outside a lock guard (concurrent query "
                        "workers share these modules)",
    "RL-WRITE-COMMIT": "io/ writer opens an output file or promotes a "
                       "path outside the transactional committer (all "
                       "table output must stage through io/committer.py "
                       "so a crash can never leave a torn final file)",
    "RL-MESH-HOST": "host materialization (np.asarray / np.array / "
                    "host_fetch / a host sync) inside parallel/ or the "
                    "mesh re-land outside a sanctioned gather point "
                    "(device shards must stay resident between "
                    "exchanges)",
    "RL-KERNEL-HOST": "numpy import/materialization or host sync "
                      "inside the CUDA kernel layer (kernels/) outside "
                      "the sanctioned allowlist — the wrappers launch "
                      "device work and never read it back",
    "RL-OBS-PASSIVE": "the passive telemetry module (obs/telemetry.py) "
                      "touches the device (torch calls/host syncs/"
                      "finalize_observation), drives query execution, "
                      "or takes a query-path lock — sampling must "
                      "never perturb the execution it observes",
    "RL-MEM-ACCOUNT": "raw device landing (.cuda(), .to(device) of a "
                      "host tensor, torch.tensor(..., device=...)) "
                      "inside execs//ops/ outside the sanctioned "
                      "allowlist — device landings must route through "
                      "the memory-arbiter-accounted DeviceColumn."
                      "from_host path or the device budget silently "
                      "leaks",
    "RL-MV-EPOCH": "streaming/ touches the service result cache "
                   "directly (mutator call, _entries access, or a "
                   "non-epoch import from service/result_cache) — MV "
                   "and stream maintenance must go through the "
                   "invalidation-epoch API (bump_table_epoch/"
                   "epoch listeners) so cache coherence has exactly "
                   "one write path",
}


def rule_ids() -> List[str]:
    return sorted(RULES)


def make(rule_id: str, path: str, message: str,
         severity: str = "error") -> Diagnostic:
    if rule_id not in RULES:  # not an assert: must survive python -O
        raise ValueError(f"unknown lint rule id {rule_id}")
    return Diagnostic(rule_id, path, message, severity)
