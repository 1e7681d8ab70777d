"""Device-residency rules (port of
``spark_rapids_tpu/lint/rules/device_residency.py``, re-targeted at
torch): nothing transfers host<->device on a warm query outside the
sanctioned sites. The rule ids are the reference's.

* RL-HOST-SYNC — no host synchronization (common.py's set: ``.cpu()``,
  ``.item()``/``.tolist()``/``.numpy()`` on a torch value, ``int()``/
  ``float()``/``bool()`` over one, ``torch.cuda.synchronize``,
  ``.synchronize()``) inside execs/ or ops/ hot paths except through the
  sanctioned ``dispatch.host_fetch`` or at a by-design sync of the
  allowlist.
* RL-JNP-SCOPE — ``import torch`` only in the device layers
  (``_DEVICE_DIRS``, ``_DEVICE_FILES``); the host layers (sql/, plan/,
  overrides/, io/, lint/ ...) stay device-agnostic.
* RL-MESH-HOST — mesh execution keeps shards on the device BETWEEN
  exchanges: inside ``parallel/`` and the mesh re-land
  (``execs/mesh.py``), host materialization may appear only at the
  sanctioned gather point (``_MESH_HOST_ALLOWLIST``).
* RL-KERNEL-HOST — the CUDA kernel layer's wrappers (``kernels/``)
  launch device work and never read it back: no numpy there at all (so
  every ``.item()``/``.tolist()``/``.numpy()`` is a torch read-back) and
  no host sync, outside the allowlisted survey read-back.
* RL-MEM-ACCOUNT — device landings in execs//ops/ route through the
  arbiter-accounted ``DeviceColumn.from_host`` / ``upload_host_table``; a
  raw ``.cuda()``, a ``.to(device)`` of a host tensor
  (``torch.from_numpy``/``as_tensor``/``tensor``) or a
  ``torch.tensor(..., device=...)`` lands bytes the memory arbiter never
  sees.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from spark_rapids_tpu_torch.lint.diagnostics import Diagnostic, make
from spark_rapids_tpu_torch.lint.rules.common import (PACKAGE, _attr_chain,
                                                      _host_sync_call,
                                                      _sync_import)

#: directories (under spark_rapids_tpu_torch/) whose modules are device
#: layers and may import torch
_DEVICE_DIRS = ("execs", "ops", "columnar", "parallel", "runtime",
                "shuffle", "kernels")
#: device-layer files outside those directories (package-relative), each
#: for its device work
_DEVICE_FILES = (
    "__init__.py",           # resolve_device: the session's torch device
    "dispatch.py",           # host_fetch, the counted device read
    "types.py",              # the Spark type <-> torch dtype map
    "udf.py",                # the UDF compiler emits torch ops
    "service/scheduler.py",  # a worker thread binds to its card
    "tools/__init__.py",     # --require-cuda names the card
    "tools/loadtest.py",     # a report names the card it measured
)


def _qualified_walk(tree: ast.AST, visit) -> None:
    """Call ``visit(node, func)`` for every node, ``func`` the qualified
    name (Class.method / outer.inner) of the enclosing function or class
    (None at module level): a bare-name allowlist key would exempt EVERY
    function sharing the allowlisted name anywhere in the file."""

    def walk(node, func: Optional[str]):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            func = f"{func}.{node.name}" if func else node.name
        visit(node, func)
        for child in ast.iter_child_nodes(node):
            walk(child, func)

    walk(tree, None)


#: by-design host syncs of the execs//ops/ hot paths:
#: "<rel>:<qualified function>" -> justification naming the sync. The
#: hook for new ones — add an entry HERE with a reason, never a bare
#: suppression.
_HOST_SYNC_ALLOWLIST: dict = {
    "spark_rapids_tpu_torch/execs/sort.py:_host_run":
        "the out-of-core sort's download of each sorted run to the host "
        "(past spark.rapids.sql.sort.outOfCoreThresholdBytes, metric "
        "sortOutOfCore): its row count and one copy per column",
    "spark_rapids_tpu_torch/execs/window.py:_Sorted.steps":
        "the doubling scan's pass count: one read of the longest live "
        "segment per sorted window batch (float frames and MIN/MAX)",
    "spark_rapids_tpu_torch/ops/bloom.py:BloomFilter.host_bits":
        "the CPU route's might_contain probes the filter's bits on the "
        "host: one read per filter, kept",
    "spark_rapids_tpu_torch/ops/math.py:_BitwiseBinary.eval_cpu":
        "no device involved: the CPU route runs torch's bitwise ops over "
        "host tensors (torch.from_numpy) and reads them back as numpy",
}


def _check_host_sync(rel: str, tree: ast.AST, diags: List[Diagnostic]):
    if not rel.startswith((f"{PACKAGE}/execs/", f"{PACKAGE}/ops/")):
        return

    def visit(node, func):
        what = _sync_import(node) or _host_sync_call(node)
        if not what or what == "host_fetch()":
            return  # host_fetch IS the sanctioned, counted read
        if f"{rel}:{func}" in _HOST_SYNC_ALLOWLIST:
            return
        diags.append(make(
            "RL-HOST-SYNC", f"{rel}:{node.lineno}",
            f"{what} synchronizes the device in a hot path"
            + (f" (function {func!r})" if func else " (module level)")
            + "; route it through dispatch.host_fetch so syncs are "
            "counted and reviewable, or allowlist the function in "
            "_HOST_SYNC_ALLOWLIST naming its by-design sync"))

    _qualified_walk(tree, visit)


def _check_jnp_scope(rel: str, tree: ast.AST, diags: List[Diagnostic]):
    parts = rel.split("/")
    if parts[0] != PACKAGE:
        return  # chip_smoke.py drives the card
    inner = "/".join(parts[1:])
    if inner in _DEVICE_FILES or (len(parts) > 2
                                  and parts[1] in _DEVICE_DIRS):
        return
    for node in ast.walk(tree):
        hit = None
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch" or a.name.startswith("torch."):
                    hit = f"{a.name} imported"
        elif isinstance(node, ast.ImportFrom):
            if node.module and (node.module == "torch"
                                or node.module.startswith("torch.")):
                hit = f"{node.module} imported"
        if hit:
            diags.append(make(
                "RL-JNP-SCOPE", f"{rel}:{node.lineno}",
                f"{hit} outside the device layers "
                f"({', '.join(_DEVICE_DIRS + _DEVICE_FILES)}); host-side "
                "layers must stay device-agnostic"))


#: sanctioned mesh->host materialization points: "<rel>:<function>" ->
#: justification. The hook for new gather points — add an entry HERE
#: with a reason, never a bare suppression.
_MESH_HOST_ALLOWLIST: dict = {
    "spark_rapids_tpu_torch/parallel/mesh.py:mesh_gather":
        "THE sanctioned mesh->host read (counted by note_host_fetch and "
        "meshGatherRows): each re-land's one read of digests and row "
        "count, and the exchange's one checked read of its (source, "
        "target) counts (parallel/exchange.py verified_counts) come "
        "through here",
}

_NP_MATERIALIZE = ("np.asarray", "numpy.asarray", "asarray", "np.array",
                   "numpy.array")


def _check_mesh_host(rel: str, tree: ast.AST, diags: List[Diagnostic]):
    """RL-MESH-HOST: inside parallel/ and the mesh re-land, host
    materialization of device data (np.asarray/np.array, host_fetch, a
    host sync) is forbidden outside the sanctioned gather points — the
    static guard for 'zero host round-trips between exchanges'."""
    if not (rel.startswith(f"{PACKAGE}/parallel/")
            or rel == f"{PACKAGE}/execs/mesh.py"):
        return

    def visit(node, func):
        what = None
        if isinstance(node, ast.Call):
            chain = _attr_chain(node.func)
            if chain in _NP_MATERIALIZE:
                # bare 'asarray' covers `from numpy import asarray`
                what = f"{chain}()"
            else:
                what = _host_sync_call(node) or None
        if what is None or f"{rel}:{func}" in _MESH_HOST_ALLOWLIST:
            return
        diags.append(make(
            "RL-MESH-HOST", f"{rel}:{node.lineno}",
            f"{what} in mesh/shard-dispatch code"
            + (f" (function {func!r})" if func else " (module level)")
            + " — device shards must stay resident between exchanges; "
            "gather through parallel.mesh.mesh_gather or allowlist the "
            "function in _MESH_HOST_ALLOWLIST with a justification"))

    _qualified_walk(tree, visit)


#: sanctioned host-side operations inside kernels/:
#: "<rel>:<qualified function>" -> justification. The hook for new
#: exceptions — add an entry HERE with a reason, never a bare
#: suppression.
_KERNEL_HOST_ALLOWLIST: dict = {
    "spark_rapids_tpu_torch/kernels/sort.py:sort_with_payload":
        "the radix sort's one survey read-back for more than one tile of "
        "rows: the plan of digit passes needs the varying bits "
        "(counted in sort_with_payload.host_syncs)",
}


def _check_kernel_host(rel: str, tree: ast.AST, diags: List[Diagnostic]):
    """RL-KERNEL-HOST: the kernel wrappers launch device work and never
    read it back — no numpy and no host syncs in kernels/."""
    if not rel.startswith(f"{PACKAGE}/kernels/"):
        return

    def visit(node, func):
        what = None
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mod = getattr(node, "module", None)
            names = [a.name for a in node.names]
            if mod == "numpy" or "numpy" in names \
                    or any(n.startswith("numpy.") for n in names) \
                    or (mod or "").startswith("numpy."):
                what = "numpy import"
            else:
                what = _sync_import(node) or None
        elif isinstance(node, ast.Call):
            chain = _attr_chain(node.func)
            if chain.startswith(("np.", "numpy.")):
                what = f"{chain}()"
            else:
                what = _host_sync_call(node, strict=True) or None
        if what is None or f"{rel}:{func}" in _KERNEL_HOST_ALLOWLIST:
            return
        diags.append(make(
            "RL-KERNEL-HOST", f"{rel}:{node.lineno}",
            f"{what} in the CUDA kernel layer"
            + (f" (function {func!r})" if func else " (module level)")
            + " — kernels/ launches device work and never reads it "
            "back; keep host work at the dispatch sites or allowlist "
            "the function in _KERNEL_HOST_ALLOWLIST with a "
            "justification"))

    _qualified_walk(tree, visit)


#: sanctioned raw landings inside execs//ops/:
#: "<rel>:<qualified function>" -> justification. The hook for new
#: exceptions — add an entry HERE with a reason, never a bare
#: suppression. Table-sized landings are NEVER eligible: they belong on
#: the arbiter-accounted DeviceColumn.from_host path.
_MEM_ACCOUNT_ALLOWLIST: dict = {
    "spark_rapids_tpu_torch/execs/join.py:_unify_string_keys":
        "a string key's code remap into the union dictionary: one int32 "
        "per dictionary entry, not per row",
    "spark_rapids_tpu_torch/ops/common.py:align_string_dicts_many":
        "each child's code remap into the merged dictionary: one int32 "
        "per dictionary entry",
    "spark_rapids_tpu_torch/ops/hashfns.py:HiveHash.prep":
        "the hive hash of each dictionary entry: one int32 per entry",
    "spark_rapids_tpu_torch/ops/json_structs.py:JsonToStructs.prep.build.put":
        "each field parsed once per dictionary entry (values and "
        "validity per entry), cached per dictionary",
    "spark_rapids_tpu_torch/ops/misc.py:ConcatWs.prep.build":
        "the joined strings' code remap: one int32 per dictionary entry, "
        "cached per dictionary",
    "spark_rapids_tpu_torch/ops/strings.py:DictStringToString.prep.build":
        "the transformed dictionary's code remap: one int32 per entry, "
        "cached per dictionary",
    "spark_rapids_tpu_torch/ops/strings.py:DictStringToValue.prep.build":
        "the value of each dictionary entry and its validity, cached per "
        "dictionary",
    "spark_rapids_tpu_torch/ops/tzdb.py:device_tables":
        "a time zone's four transition tables, uploaded once per (zone, "
        "device) and kept for the process",
}

#: torch constructors whose result is a host tensor unless given a device
_HOST_TENSOR_CTORS = ("torch.from_numpy", "torch.as_tensor", "torch.tensor",
                      "torch.asarray")


def _is_dtype_arg(node: ast.AST) -> bool:
    """Is ``.to()``'s argument a dtype (``torch.int64``, ``x.dtype``), a
    cast that lands nothing?"""
    chain = _attr_chain(node)
    return bool(chain) and (chain.startswith("torch.")
                            or chain.endswith("dtype"))


def _raw_landing(node: ast.Call) -> str:
    """The spelling of a raw host->device landing made by call ``node``
    ('' when it makes none)."""
    chain = _attr_chain(node.func)
    if isinstance(node.func, ast.Attribute):
        if node.func.attr == "cuda":
            return ".cuda()"
        recv = node.func.value
        if node.func.attr == "to" and isinstance(recv, ast.Call) and \
                _attr_chain(recv.func) in _HOST_TENSOR_CTORS:
            dev = [kw.value for kw in node.keywords if kw.arg == "device"]
            args = dev or node.args[:1]
            if args and not _is_dtype_arg(args[0]):
                return f"{_attr_chain(recv.func)}(...).to(device)"
    if chain in _HOST_TENSOR_CTORS and \
            any(kw.arg == "device" for kw in node.keywords):
        return f"{chain}(..., device=...)"
    return ""


def _check_mem_account(rel: str, tree: ast.AST,
                       diags: List[Diagnostic]):
    """RL-MEM-ACCOUNT: device landings in execs//ops/ must route through
    arbiter-accounted paths — a raw landing there lands bytes the
    MemoryArbiter never sees, and the device budget contract silently
    breaks."""
    if not rel.startswith((f"{PACKAGE}/execs/", f"{PACKAGE}/ops/")):
        return

    def visit(node, func):
        what = _raw_landing(node) if isinstance(node, ast.Call) else ""
        if not what or f"{rel}:{func}" in _MEM_ACCOUNT_ALLOWLIST:
            return
        diags.append(make(
            "RL-MEM-ACCOUNT", f"{rel}:{node.lineno}",
            f"{what} in a device-landing layer"
            + (f" (function {func!r})" if func else " (module level)")
            + " — land through DeviceColumn.from_host so the memory "
            "arbiter accounts the bytes, or allowlist the function in "
            "_MEM_ACCOUNT_ALLOWLIST with a justification"))

    _qualified_walk(tree, visit)
