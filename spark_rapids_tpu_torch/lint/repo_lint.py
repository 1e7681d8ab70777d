"""Python-AST repo lint (port of ``spark_rapids_tpu/lint/repo_lint.py``):
project invariants the type system can't hold.

The device rule the port lives by (dispatch.py): nothing transfers
host<->device on a warm query outside the sanctioned sites. The type
checker cannot see a stray ``.cpu()`` in a hot path or a conf key
referenced by a typo'd string — this lint can.

The rules live in per-rule modules under ``lint/rules/`` (see each
module's docstring for its contract); this module runs them —
``lint_repo()`` parses every source file of ``spark_rapids_tpu_torch/``
(its own ``lint/`` aside) and ``chip_smoke.py`` once and runs the shared
rule registry (``lint.rules.REGISTRY``) over the trees — and the stable
import surface: every ``_check_*`` checker and allowlist is re-exported
HERE under the reference's name (the same objects the rule modules read,
so a test that patches an allowlist dict in place patches the rule).

Rules (RL-*): RL-HOST-SYNC, RL-JNP-SCOPE, RL-CONF-KEY,
RL-NONDETERMINISM, RL-DEAD-LAMBDA, RL-FAULT-POINT, RL-THREAD-SHARED,
RL-MESH-HOST, RL-WRITE-COMMIT, RL-KERNEL-HOST, RL-OBS-PASSIVE,
RL-MEM-ACCOUNT, RL-MV-EPOCH.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from spark_rapids_tpu_torch.lint.diagnostics import Diagnostic
from spark_rapids_tpu_torch.lint.rules import REGISTRY, LintContext
# re-exports: the stable import surface
from spark_rapids_tpu_torch.lint.rules.common import (  # noqa: F401
    PACKAGE, _attr_chain, _host_sync_call, _is_device_expr,
    _iter_source_files, _rel, _repo_root, _sync_import)
from spark_rapids_tpu_torch.lint.rules.conf_keys import (  # noqa: F401
    _CONF_KEY_RE, _check_conf_keys)
from spark_rapids_tpu_torch.lint.rules.determinism import (  # noqa: F401
    _SEEDED_RANDOM_OK, _check_dead_lambdas, _check_nondeterminism)
from spark_rapids_tpu_torch.lint.rules.device_residency import (  # noqa: F401
    _DEVICE_DIRS, _DEVICE_FILES, _HOST_SYNC_ALLOWLIST,
    _KERNEL_HOST_ALLOWLIST, _MEM_ACCOUNT_ALLOWLIST, _MESH_HOST_ALLOWLIST,
    _check_host_sync, _check_jnp_scope, _check_kernel_host,
    _check_mem_account, _check_mesh_host)
from spark_rapids_tpu_torch.lint.rules.fault_points import (  # noqa: F401
    _check_fault_registry, _check_fault_sites, _is_fault_point_call)
from spark_rapids_tpu_torch.lint.rules.io_write import (  # noqa: F401
    _WRITE_COMMIT_EXEMPT, _WRITE_ONE, _check_write_commit,
    _open_mode_writes)
from spark_rapids_tpu_torch.lint.rules.obs_passive import (  # noqa: F401
    _OBS_PASSIVE_ALLOWLIST, _OBS_PASSIVE_MODULE, _check_obs_passive)
from spark_rapids_tpu_torch.lint.rules.streaming_epoch import (  # noqa: F401
    _MV_EPOCH_ALLOWED_IMPORTS, _check_mv_epoch)
from spark_rapids_tpu_torch.lint.rules.thread_shared import (  # noqa: F401
    _THREAD_SHARED_ALLOWLIST, _THREAD_SHARED_DIRS, _check_thread_shared,
    _is_lock_guard, _is_mutable_container)


def lint_repo(repo_root: Optional[str] = None) -> List[Diagnostic]:
    root = _repo_root(repo_root)
    from spark_rapids_tpu_torch import conf as C
    C._import_package()  # every module's keys and fault points
    ctx = LintContext(declared=set(C.registry()))
    diags: List[Diagnostic] = []
    for path in _iter_source_files(root):
        rel = _rel(root, path)
        with open(path, encoding="utf-8") as f:
            src = f.read()
        tree = ast.parse(src, filename=rel)  # unparseable repo = hard error
        ctx.trees[rel] = tree
        for rule in REGISTRY:
            if rule.file_check is not None:
                rule.file_check(ctx, rel, tree, diags)
    for rule in REGISTRY:
        if rule.finalizer is not None:
            rule.finalizer(ctx, diags)
    return diags
