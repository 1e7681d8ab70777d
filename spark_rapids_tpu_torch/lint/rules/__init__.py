"""The shared rule registry driving ``lint_repo()`` (port of
``spark_rapids_tpu/lint/rules/__init__.py``).

Each rule family lives in its own module under ``lint/rules/``; this
package assembles them into one ordered registry so the runner
(``repo_lint.lint_repo``) is pure orchestration: parse each source
file once, hand the tree to every per-file check, then run the
cross-file finalizers (registry audits that need the whole repo seen —
the fault points).

A registry entry is ``(rule_ids, file_check, finalizer)``:

* ``file_check(ctx, rel, tree, diags)`` — called once per source file
  with the shared :class:`LintContext`;
* ``finalizer(ctx, diags)`` — called once after every file was walked.

The reference's concurrency finalizer (RL-LOCK-DECL, RL-LOCK-ORDER,
RL-LOCK-EFFECT over the lock rank table) is not ported yet.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from spark_rapids_tpu_torch.lint.rules import (conf_keys, determinism,
                                               device_residency,
                                               fault_points, io_write,
                                               obs_passive, streaming_epoch,
                                               thread_shared)


@dataclass
class LintContext:
    """Per-run shared state: what the cross-file halves need."""

    #: declared conf keys (RL-CONF-KEY)
    declared: Set[str] = field(default_factory=set)
    #: fault_point name -> ["rel:line", ...] (RL-FAULT-POINT)
    fault_calls: Dict[str, List[str]] = field(default_factory=dict)
    #: every parsed tree, rel -> ast
    trees: Dict[str, ast.AST] = field(default_factory=dict)


@dataclass(frozen=True)
class LintRule:
    rule_ids: Tuple[str, ...]
    file_check: Optional[Callable[..., None]] = None
    finalizer: Optional[Callable[..., None]] = None


#: ordered registry — per-file checks run in this order for each file,
#: then finalizers run in this order
REGISTRY: Tuple[LintRule, ...] = (
    LintRule(("RL-HOST-SYNC",),
             lambda ctx, rel, tree, diags:
             device_residency._check_host_sync(rel, tree, diags)),
    LintRule(("RL-JNP-SCOPE",),
             lambda ctx, rel, tree, diags:
             device_residency._check_jnp_scope(rel, tree, diags)),
    LintRule(("RL-CONF-KEY",),
             lambda ctx, rel, tree, diags:
             conf_keys._check_conf_keys(rel, tree, ctx.declared, diags)),
    LintRule(("RL-NONDETERMINISM",),
             lambda ctx, rel, tree, diags:
             determinism._check_nondeterminism(rel, tree, diags)),
    LintRule(("RL-DEAD-LAMBDA",),
             lambda ctx, rel, tree, diags:
             determinism._check_dead_lambdas(rel, tree, diags)),
    LintRule(("RL-THREAD-SHARED",),
             lambda ctx, rel, tree, diags:
             thread_shared._check_thread_shared(rel, tree, diags)),
    LintRule(("RL-WRITE-COMMIT",),
             lambda ctx, rel, tree, diags:
             io_write._check_write_commit(rel, tree, diags)),
    LintRule(("RL-MESH-HOST",),
             lambda ctx, rel, tree, diags:
             device_residency._check_mesh_host(rel, tree, diags)),
    LintRule(("RL-KERNEL-HOST",),
             lambda ctx, rel, tree, diags:
             device_residency._check_kernel_host(rel, tree, diags)),
    LintRule(("RL-OBS-PASSIVE",),
             lambda ctx, rel, tree, diags:
             obs_passive._check_obs_passive(rel, tree, diags)),
    LintRule(("RL-MEM-ACCOUNT",),
             lambda ctx, rel, tree, diags:
             device_residency._check_mem_account(rel, tree, diags)),
    LintRule(("RL-MV-EPOCH",),
             lambda ctx, rel, tree, diags:
             streaming_epoch._check_mv_epoch(rel, tree, diags)),
    LintRule(("RL-FAULT-POINT",),
             lambda ctx, rel, tree, diags:
             fault_points._check_fault_sites(rel, tree, ctx.fault_calls,
                                             diags),
             lambda ctx, diags:
             fault_points._check_fault_registry(ctx.fault_calls, diags)),
)
