"""RL-THREAD-SHARED (port of ``spark_rapids_tpu/lint/rules/thread_shared.py``)
— the query service executes queries from a worker pool, so runtime/,
shuffle/, service/ and streaming/ modules are concurrent by contract:
module-global mutable containers (and class-level singleton slots)
written inside a function must be written under a lock guard (a
``with <something named *lock*/*cond*>:`` block) or appear in the
sanctioned allowlist with a justification. A new guard is built through
the lockorder.py factories (``ordered_lock``), never as a raw
``threading`` lock."""

from __future__ import annotations

import ast
from typing import List

from spark_rapids_tpu_torch.lint.diagnostics import Diagnostic, make
from spark_rapids_tpu_torch.lint.rules.common import PACKAGE, _attr_chain

#: directories whose modules must be thread-safe (the query service's
#: worker pool runs through all of them concurrently)
_THREAD_SHARED_DIRS = (f"{PACKAGE}/runtime/",
                       f"{PACKAGE}/shuffle/",
                       f"{PACKAGE}/service/",
                       f"{PACKAGE}/streaming/")

#: sanctioned unlocked writes: "file:name" -> why the pattern is safe.
#: Additions need a justification a reviewer can check.
_THREAD_SHARED_ALLOWLIST: dict = {}

#: container-mutating method names on dict/list/set/deque
_MUTATING_METHODS = {"append", "extend", "add", "update", "pop",
                     "popitem", "remove", "discard", "clear",
                     "setdefault", "insert", "appendleft", "popleft",
                     "move_to_end"}

_MUTABLE_CTORS = {"dict", "list", "set", "OrderedDict", "defaultdict",
                  "deque", "Counter", "WeakKeyDictionary",
                  "WeakValueDictionary"}


def _is_mutable_container(node: ast.AST) -> bool:
    if isinstance(node, (ast.Dict, ast.List, ast.Set,
                         ast.ListComp, ast.DictComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        chain = _attr_chain(node.func)
        return chain.split(".")[-1] in _MUTABLE_CTORS
    return False


def _is_lock_guard(with_node: ast.With) -> bool:
    for item in with_node.items:
        chain = _attr_chain(item.context_expr).lower()
        if isinstance(item.context_expr, ast.Call):
            chain = _attr_chain(item.context_expr.func).lower()
        if "lock" in chain or "cond" in chain:
            return True
    return False


def _check_thread_shared(rel: str, tree: ast.AST,
                         diags: List[Diagnostic]):
    if not rel.startswith(_THREAD_SHARED_DIRS):
        return
    shared_globals: dict = {}
    class_names = set()
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            class_names.add(node.name)
        target = value = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            target, value = node.targets[0].id, node.value
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name) \
                and node.value is not None:
            target, value = node.target.id, node.value
        if target is not None and _is_mutable_container(value):
            shared_globals[target] = node.lineno

    def _flag(node, what, name):
        """``name`` is the allowlist key: the container's global name,
        or the attribute name for class-level singleton slots."""
        if f"{rel}:{name}" in _THREAD_SHARED_ALLOWLIST:
            return
        diags.append(make(
            "RL-THREAD-SHARED", f"{rel}:{node.lineno}",
            f"{what} written outside a lock guard in a module shared "
            "by concurrent query workers; hold a lock (with "
            "<..lock..>:, built by lockorder.ordered_lock), use "
            f"threading.local, or allowlist {rel}:{name} with a "
            "justification"))

    def _root_name(node: ast.AST):
        while isinstance(node, ast.Subscript):
            node = node.value
        return node.id if isinstance(node, ast.Name) else None

    def _is_class_attr_target(node: ast.AST):
        return (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and (node.value.id == "cls"
                     or node.value.id in class_names))

    def walk(node, in_func: bool, guarded: bool, fn_globals):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            in_func = True
            fn_globals = {n for g in ast.walk(node)
                          if isinstance(g, ast.Global) for n in g.names}
        elif isinstance(node, ast.With) and _is_lock_guard(node):
            guarded = True
        if in_func and not guarded:
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets
                           if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Subscript):
                        root = _root_name(t)
                        if root in shared_globals:
                            _flag(node, f"{root}[...]", root)
                    elif isinstance(t, ast.Name) and t.id in fn_globals \
                            and t.id in shared_globals:
                        _flag(node, t.id, t.id)
                    elif _is_class_attr_target(t):
                        _flag(node, f"{_attr_chain(t)} (class attribute)",
                              t.attr)
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _MUTATING_METHODS:
                root = _root_name(node.func.value)
                if root in shared_globals:
                    _flag(node, f"{root}.{node.func.attr}(...)", root)
        for child in ast.iter_child_nodes(node):
            walk(child, in_func, guarded, fn_globals)

    walk(tree, False, False, set())
