"""Shared plumbing for the per-rule lint modules (port of
``spark_rapids_tpu/lint/rules/common.py``).

Every rule module under ``lint/rules/`` walks the same parsed ASTs with
the same small vocabulary: repo-relative paths, dotted attribute chains,
and THE host-synchronization call set. The device-residency rules walk
different scopes but must agree on what a host sync IS in torch — a
spelling added to one and not the other would silently diverge — so this
module is the one place it is spelled:

* ``.cpu()`` (any receiver: numpy arrays have no such method);
* ``.item()``, ``.tolist()`` and ``.numpy()`` on a receiver that is
  provably a torch value (``_is_device_expr``), and ``int()``,
  ``float()`` and ``bool()`` over one — numpy shares those names, and the
  lint does not guess at a receiver it cannot prove;
* ``torch.cuda.synchronize()``, ``.synchronize()`` on an event or a
  stream, and a bare ``synchronize()`` (the ``from torch.cuda import
  synchronize`` form);
* ``host_fetch()``, the sanctioned counted read (dispatch.py), which the
  hot-path rule allows and the stricter scopes do not.
"""

from __future__ import annotations

import ast
import os
from typing import Iterator, Optional

#: the port's package directory (repo-relative) and the card script the
#: lint walks beside it
PACKAGE = "spark_rapids_tpu_torch"
_EXTRA_FILES = ("chip_smoke.py",)

#: the methods whose call on a torch value reads it back to the host
_READBACK_METHODS = ("item", "tolist", "numpy")

#: call names whose result is host data, whatever their argument
_HOST_RESULT_METHODS = ("cpu",) + _READBACK_METHODS


def _repo_root(repo_root: Optional[str]) -> str:
    if repo_root:
        return repo_root
    import spark_rapids_tpu_torch
    return os.path.dirname(os.path.dirname(
        os.path.abspath(spark_rapids_tpu_torch.__file__)))


def _iter_source_files(root: str) -> Iterator[str]:
    """The port's Python sources, without ``lint/`` itself (its rule
    tables name the forbidden patterns), and the card script."""
    pkg = os.path.join(root, PACKAGE)
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = sorted(
            d for d in dirnames
            if d not in ("__pycache__", "_build")
            and os.path.join(dirpath, d) != os.path.join(pkg, "lint"))
        for f in sorted(filenames):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    for f in _EXTRA_FILES:
        p = os.path.join(root, f)
        if os.path.exists(p):
            yield p


def _rel(root: str, path: str) -> str:
    return os.path.relpath(path, root).replace(os.sep, "/")


def _attr_chain(node: ast.AST) -> str:
    """Dotted name of an attribute/name chain ('' when not a plain chain)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_host_fetch(chain: str) -> bool:
    return chain == "host_fetch" or chain.endswith(".host_fetch")


def _is_device_expr(node: ast.AST) -> bool:
    """Is this expression PROVABLY a torch value — a ``torch.`` call in it
    that is not already funneled through the sanctioned host_fetch
    wrapper or read back by ``.cpu()``/``.item()``/``.tolist()``/
    ``.numpy()`` (whose RESULT is host data, however device-y its
    receiver)?"""
    if isinstance(node, ast.Call):
        chain = _attr_chain(node.func)
        if _is_host_fetch(chain):
            return False
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _HOST_RESULT_METHODS:
            return False
        if chain.startswith("torch."):
            return True
    for child in ast.iter_child_nodes(node):
        if _is_device_expr(child):
            return True
    return False


def _host_sync_call(node: ast.AST, strict: bool = False) -> str:
    """THE host-synchronization call set: the spelling of the sync that
    call ``node`` makes ('' when it makes none). ``strict`` (the kernel
    layer, which imports no numpy) counts ``.item()``, ``.tolist()`` and
    ``.numpy()`` on any receiver."""
    if not isinstance(node, ast.Call):
        return ""
    chain = _attr_chain(node.func)
    if _is_host_fetch(chain):
        return "host_fetch()"
    if chain == "synchronize":
        return "synchronize()"
    if isinstance(node.func, ast.Attribute):
        attr = node.func.attr
        if attr == "synchronize":
            return f"{chain or '.synchronize'}()"
        if attr == "cpu" and not node.args:
            return ".cpu()"
        if attr in _READBACK_METHODS and (
                strict or _is_device_expr(node.func.value)):
            return f".{attr}()"
    if chain in ("int", "float", "bool") and node.args and \
            _is_device_expr(node.args[0]):
        return f"{chain}() over a torch expression"
    return ""


def _sync_import(node: ast.AST) -> str:
    """``from torch.cuda import synchronize`` would make the bare call
    invisible to a chain matcher: the import form is a sync spelling
    too ('' when ``node`` is not one)."""
    if isinstance(node, ast.ImportFrom) and node.module in (
            "torch.cuda", "torch"):
        for a in node.names:
            if a.name == "synchronize":
                return f"importing {node.module}.synchronize"
    return ""
