"""Concurrency contract analyzer (port of
``spark_rapids_tpu/lint/concurrency.py``): lock declarations, the static
acquisition-order graph, and held-lock effects.

Deadlocks reduce to two mistakes: acquiring locks in an undeclared order,
and doing something blocking while a lock is held. Three rules make both
mechanical:

* **RL-LOCK-DECL** — every ``threading.Lock/RLock/Condition/
  Semaphore`` constructed in the concurrent packages
  (:data:`_LOCK_SCOPE_DIRS`) must go through the ``lockorder.py``
  ``ordered_*`` factories with a string-literal name declared in
  ``LOCK_ORDER``, constructed at exactly the declared site; and every
  ``LOCK_ORDER`` entry must have a live construction site (both
  directions, like RL-FAULT-POINT).

* **RL-LOCK-ORDER** — an AST + call-graph pass tracks which declared
  locks are held at each ``with``/``.acquire()`` site, follows calls
  to a bounded depth (:data:`_CALL_DEPTH`), and builds the
  held→acquired edge set.  An edge whose acquired rank is <= a held
  rank violates the hierarchy; the full blocking-edge graph is also
  checked for cycles (an allowlisted edge can silence the local
  finding, but a CLOSED cycle is reported regardless — a justified
  exception must still not compose into a deadlock).
  ``acquire(blocking=False)`` try-acquires are exempt: they cannot
  deadlock, and the spill paths rely on exactly that escape.

* **RL-LOCK-EFFECT** — forbidden while any declared lock is held:
  host syncs (the shared ``_host_sync_call`` set of the torch
  spellings), socket send/recv/connect/accept, ``subprocess.*``,
  ``fault_point()`` raising sites, ``record_incident()``, and
  ``.wait()`` on a Condition other than the one held.  Exceptions go in
  :data:`_LOCK_EFFECT_ALLOWLIST` with a justification (the
  RL-MESH-HOST hook shape).

The pass is deliberately BOUNDED: lock expressions it cannot resolve
to a declaration and calls it cannot resolve to a scanned function are
skipped, never guessed — resolution covers ``self``/``cls``
attributes, module globals, unique class names, module-level
singletons (``MEMORY = MemoryArbiter()``) and globally-unique
attribute/method basenames.  The runtime lock witness
(``spark.rapids.lint.lockWitness``) covers the dynamic remainder.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from spark_rapids_tpu_torch.lint.diagnostics import Diagnostic, make
from spark_rapids_tpu_torch.lint.rules.common import (PACKAGE, _attr_chain,
                                                      _host_sync_call)

#: directories whose lock constructions fall under the contract (the
#: reference's seven: shuffle/, kernels/, native/ and ops/ keep raw locks,
#: as the reference's do)
_LOCK_SCOPE_DIRS = tuple(f"{PACKAGE}/{d}/" for d in (
    "runtime", "service", "parallel", "obs", "io", "columnar", "streaming"))

#: the registry/factory module itself — the one place allowed to touch
#: raw threading primitives (inside the ordered_* factories)
_LOCKORDER_MODULE = f"{PACKAGE}/lockorder.py"

_FACTORY_KINDS = {"ordered_lock": "Lock", "ordered_rlock": "RLock",
                  "ordered_condition": "Condition",
                  "ordered_semaphore": "Semaphore"}

_RAW_CTORS = ("Lock", "RLock", "Condition", "Semaphore",
              "BoundedSemaphore")

#: call-graph depth followed from a held region (order + effect).
#: Deliberate bound: deeper chains trade precision for noise; the
#: runtime witness covers what the static pass cannot see.
_CALL_DEPTH = 3

#: sanctioned order-edge exceptions: "<rel>:<qualified function>" (the
#: function where the violating acquisition happens) -> justification.
#: The hook for reviewed exceptions — add an entry HERE with a reason,
#: never a bare suppression.  NOTE: a cycle in the blocking-edge graph
#: is reported even when every edge in it is allowlisted.
_LOCK_ORDER_ALLOWLIST: Dict[str, str] = {}

#: sanctioned held-lock effects: "<rel>:<qualified function>" ->
#: justification (same shape as RL-MESH-HOST).
_LOCK_EFFECT_ALLOWLIST: Dict[str, str] = {
    f"{PACKAGE}/runtime/cluster.py:ClusterDriver.scan_host":
        "the channel lock EXISTS to serialize one wire request/reply "
        "round trip per host socket — send/recv under it IS the "
        "protected operation; the lock is per-host and leaf-ranked "
        "within the cluster band (nothing is acquired under it), so a "
        "wedged executor stalls only its own channel's queue, never "
        "extends a deadlock chain",
    f"{PACKAGE}/runtime/cluster.py:ClusterDriver.shutdown":
        "the farewell message rides the same serialized-round-trip "
        "channel contract as scan_host; the socket is closed inside "
        "the same hold so no later request can interleave with the "
        "shutdown frame",
    "chip_smoke.py:ping_executor":
        "the card script's executor ping is one more request/reply round "
        "trip on a ClusterDriver's host channel, under the channel lock "
        "by the same contract as ClusterDriver.scan_host",
    f"{PACKAGE}/runtime/spill.py:SpillableBatch.get":
        "fault_point('mem.unspill') fires under the batch RLock on "
        "purpose (via _ensure_host_locked): an injected unspill "
        "failure must unwind through the exact locked region the real "
        "restore uses, or the chaos tests would test an unlocked path "
        "production never takes; fault_point itself never blocks "
        "(raise-or-return). The disk frame's host grant is taken in the "
        "same region: its wait on host_alloc.cv is bounded (then "
        "CpuRetryOOM) and nothing is acquired under that condition. The "
        "restore's upload (_RawSpill.to_device) waits on its pinned "
        "staging buffers' copy events in the region too: the batch must "
        "not read as resident before its device copy is whole, and the "
        "catalog's spill walk only try-acquires a batch lock, so a "
        "restore in flight is skipped, never waited on",
    f"{PACKAGE}/runtime/spill.py:SpillableBatch.get_host":
        "same mem.unspill and host-grant contract as SpillableBatch.get "
        "— the host-side materialization shares _ensure_host_locked",
    f"{PACKAGE}/service/scheduler.py:QueryService._run":
        "the mesh gate EXISTS to serialize the whole device-launch "
        "window — execute (and the worker_crash fault point on its "
        "path) under it IS the protected operation: two concurrent "
        "multi-device launches interleave their exchanges per device. "
        "The gate is taken holding nothing and ranks below the service "
        "band, so a wedged holder stalls only the launch queue (booked "
        "as queue wait, not hard-wall time), never extends a deadlock "
        "chain",
}

_SOCKET_CALL_SUFFIXES = (".sendall", ".recv", ".recv_into", ".accept",
                         ".connect", ".recvfrom")

#: method names the builtin container/str/bytes/file protocol claims —
#: the unique-basename call-resolution fallback must never fire for
#: these (an ``x.update(...)`` is almost always a dict/set, not the one
#: repo class that defines an ``update`` method)
_BUILTIN_METHOD_NAMES = frozenset(
    n for t in (dict, set, frozenset, list, tuple, str, bytes)
    for n in dir(t) if not n.startswith("_")) | frozenset(
    ("read", "write", "close", "flush", "seek", "tell", "readline",
     "readlines", "writelines", "fileno", "truncate"))


@dataclass(frozen=True)
class _LockRef:
    """A resolved reference to a declared lock."""
    name: str
    rank: int
    kind: str


@dataclass
class _Event:
    """One thing a function body may do that the contract cares
    about.  kind: 'acquire' (lock, blocking) or 'effect' (desc, and
    waited= the Condition for wait effects)."""
    kind: str
    lock: Optional[_LockRef] = None
    blocking: bool = True
    desc: str = ""
    waited: Optional[_LockRef] = None
    line: int = 0


@dataclass
class _Func:
    rel: str
    qual: str
    cls: Optional[str]
    #: every event in the body (closure ingredient)
    events: List[_Event] = field(default_factory=list)
    #: every resolved call in the body: (callee key, line)
    calls: List[Tuple[Tuple[str, str], int]] = field(default_factory=list)
    #: direct events while holding locks IN this function:
    #: (held snapshot, event)
    held_events: List[Tuple[Tuple[_LockRef, ...], _Event]] = \
        field(default_factory=list)
    #: resolved calls while holding locks IN this function:
    #: (held snapshot, callee key, line)
    held_calls: List[Tuple[Tuple[_LockRef, ...], Tuple[str, str], int]] \
        = field(default_factory=list)


def _in_scope(rel: str) -> bool:
    return rel.startswith(_LOCK_SCOPE_DIRS)


def _module_to_rel(dotted: str) -> Optional[str]:
    if dotted == PACKAGE or (dotted or "").startswith(PACKAGE + "."):
        return dotted.replace(".", "/") + ".py"
    return None


# ---------------------------------------------------------------------------
# RL-LOCK-DECL
# ---------------------------------------------------------------------------


def _check_lock_decl(trees: Dict[str, ast.AST],
                     diags: List[Diagnostic],
                     registry) -> None:
    """Both directions of the declaration audit (the RL-FAULT-POINT
    shape): raw constructions in scope are findings, every factory
    call must name a declared lock at its declared site, and every
    declared lock must be constructed at that site."""
    constructed: Dict[str, List[str]] = {}
    for rel, tree in sorted(trees.items()):
        if rel == _LOCKORDER_MODULE:
            continue
        threading_names: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) \
                    and node.module == "threading":
                threading_names.update(
                    a.asname or a.name for a in node.names
                    if a.name in _RAW_CTORS)

        def visit(node, cls: Optional[str]):
            if isinstance(node, ast.ClassDef):
                cls = node.name
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                # keep the ENCLOSING class for self.attr assigns
                pass
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                value = node.value
                if isinstance(value, ast.Call):
                    fn = _attr_chain(value.func).split(".")[-1]
                    if fn in _FACTORY_KINDS and len(targets) == 1:
                        qual = _target_qual(targets[0], cls)
                        _factory_site(rel, value, qual, constructed,
                                      diags, registry)
                        return  # the call is consumed; don't re-flag
            if isinstance(node, ast.Call):
                chain = _attr_chain(node.func)
                fn = chain.split(".")[-1]
                raw = (chain.startswith("threading.")
                       and chain.split(".", 1)[1] in _RAW_CTORS) \
                    or chain in threading_names
                if raw and _in_scope(rel):
                    diags.append(make(
                        "RL-LOCK-DECL", f"{rel}:{node.lineno}",
                        f"raw {chain}() constructed in a concurrent "
                        "package — declare the lock in "
                        "lockorder.LOCK_ORDER and construct it via "
                        "the ordered_* factories so it carries a rank"))
                    return
                if fn in _FACTORY_KINDS:
                    # a factory call NOT in a simple assignment — the
                    # site cannot match any declared Class.attr/global
                    _factory_site(rel, node, None, constructed,
                                  diags, registry)
                    return
            for child in ast.iter_child_nodes(node):
                visit(child, cls)

        visit(tree, None)
    for name, decl in sorted(registry.items(),
                             key=lambda kv: kv[1].rank):
        if constructed.get(name):
            continue
        if decl.module in trees:
            diags.append(make(
                "RL-LOCK-DECL", f"lockorder.LOCK_ORDER[{name!r}]",
                f"declared lock has no ordered_* construction at its "
                f"site {decl.site} — stale registry entry (rank "
                f"{decl.rank} ordering nothing)"))


def _target_qual(target: ast.AST, cls: Optional[str]) -> Optional[str]:
    """Qualified name a construction is bound to: ``Class.attr`` for
    ``self.attr``/``cls.attr``/class-body assigns, the bare global
    name at module level, None for any other binding shape."""
    if isinstance(target, ast.Name):
        return f"{cls}.{target.id}" if cls else target.id
    if isinstance(target, ast.Attribute) \
            and isinstance(target.value, ast.Name) \
            and target.value.id in ("self", "cls") and cls:
        return f"{cls}.{target.attr}"
    return None


def _factory_site(rel, call, qual, constructed, diags, registry):
    fn = _attr_chain(call.func).split(".")[-1]
    kind = _FACTORY_KINDS[fn]
    arg = call.args[0] if call.args else None
    if not (isinstance(arg, ast.Constant) and isinstance(arg.value, str)):
        diags.append(make(
            "RL-LOCK-DECL", f"{rel}:{call.lineno}",
            f"{fn}() name must be a string literal so the registry "
            "audit can see it"))
        return
    name = arg.value
    decl = registry.get(name)
    if decl is None:
        diags.append(make(
            "RL-LOCK-DECL", f"{rel}:{call.lineno}",
            f"{fn}({name!r}) is not declared in "
            "lockorder.LOCK_ORDER"))
        return
    if decl.kind != kind:
        diags.append(make(
            "RL-LOCK-DECL", f"{rel}:{call.lineno}",
            f"lock {name!r} declared as {decl.kind} but constructed "
            f"via {fn}()"))
        return
    site = f"{rel}:{qual}" if qual else None
    if site != decl.site:
        diags.append(make(
            "RL-LOCK-DECL", f"{rel}:{call.lineno}",
            f"{fn}({name!r}) constructed at "
            f"{site or f'{rel}:<unbound>'} but declared at "
            f"{decl.site} — one lock, one declared construction site"))
        return
    constructed.setdefault(name, []).append(f"{rel}:{call.lineno}")


# ---------------------------------------------------------------------------
# resolution indexes
# ---------------------------------------------------------------------------


class _Indexes:
    """Whole-repo name resolution for locks and calls — each map only
    answers when the answer is UNIQUE; ambiguity means 'unresolved',
    never a guess."""

    def __init__(self, trees: Dict[str, ast.AST], registry):
        self.registry = registry
        #: exact decl site -> LockRef
        self.by_site: Dict[str, _LockRef] = {}
        #: attr basename -> LockRef (globally unique only)
        self.by_attr: Dict[str, Optional[_LockRef]] = {}
        #: (rel, attr basename) -> LockRef (unique in module only)
        self.by_mod_attr: Dict[Tuple[str, str], Optional[_LockRef]] = {}
        for d in registry.values():
            ref = _LockRef(d.name, d.rank, d.kind)
            self.by_site[d.site] = ref
            a = d.attr
            self.by_attr[a] = None if a in self.by_attr else ref
            k = (d.module, a)
            self.by_mod_attr[k] = None if k in self.by_mod_attr else ref

        #: (rel, qualname) -> _Func (every def, methods as Class.name)
        self.funcs: Dict[Tuple[str, str], _Func] = {}
        #: class name -> rel (globally unique only)
        self.classes: Dict[str, Optional[str]] = {}
        #: method basename -> (rel, qual) (globally unique only)
        self.methods: Dict[str, Optional[Tuple[str, str]]] = {}
        #: singleton global name -> (rel, class name) (unique only)
        self.singletons: Dict[str, Optional[Tuple[str, str]]] = {}
        #: per-file from-imports: rel -> {local name: (rel2, name)}
        self.imports: Dict[str, Dict[str, Tuple[str, str]]] = {}
        #: per-file module aliases: rel -> {alias: rel2}
        self.mod_aliases: Dict[str, Dict[str, str]] = {}

        for rel, tree in trees.items():
            self._index_file(rel, tree)

    def _index_file(self, rel: str, tree: ast.AST):
        imports: Dict[str, Tuple[str, str]] = {}
        aliases: Dict[str, str] = {}
        self.imports[rel] = imports
        self.mod_aliases[rel] = aliases
        local_classes: Set[str] = set()

        def note_func(qual: str, cls: Optional[str], node):
            self.funcs[(rel, qual)] = _Func(rel, qual, cls)
            base = qual.rsplit(".", 1)[-1]
            if "." in qual:  # methods/nested only for unique-name map
                self.methods[base] = (None if base in self.methods
                                      else (rel, qual))

        def walk(node, prefix: str, cls: Optional[str]):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    q = f"{prefix}.{child.name}" if prefix else child.name
                    local_classes.add(child.name)
                    self.classes[child.name] = (
                        None if child.name in self.classes else rel)
                    walk(child, q, child.name)
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    q = f"{prefix}.{child.name}" if prefix else child.name
                    note_func(q, cls, child)
                    walk(child, q, cls)
                else:
                    walk(child, prefix, cls)

        walk(tree, "", None)

        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                rel2 = _module_to_rel(node.module)
                if rel2:
                    for a in node.names:
                        imports[a.asname or a.name] = (rel2, a.name)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    rel2 = _module_to_rel(a.name)
                    if rel2:
                        aliases[a.asname or a.name.split(".")[-1]] = rel2
        # module-level singletons: NAME = ClassName(...)
        for node in tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Call) \
                    and isinstance(node.value.func, ast.Name):
                cname = node.value.func.id
                if cname in local_classes:
                    n = node.targets[0].id
                    self.singletons[n] = (
                        None if n in self.singletons else (rel, cname))

    # -- lock resolution --------------------------------------------

    def resolve_lock(self, node: ast.AST, rel: str,
                     cls: Optional[str]) -> Optional[_LockRef]:
        chain = _attr_chain(node)
        if not chain:
            return None
        parts = chain.split(".")
        if parts[0] in ("self", "cls") and cls and len(parts) == 2:
            return self.by_site.get(f"{rel}:{cls}.{parts[1]}")
        if len(parts) == 1:
            return self.by_site.get(f"{rel}:{parts[0]}")
        if len(parts) == 2:
            # ClassName.attr
            crel = self.classes.get(parts[0])
            if crel:
                ref = self.by_site.get(f"{crel}:{parts[0]}.{parts[1]}")
                if ref:
                    return ref
            # SINGLETON.attr
            s = self.singletons.get(parts[0])
            if s:
                ref = self.by_site.get(f"{s[0]}:{s[1]}.{parts[1]}")
                if ref:
                    return ref
            # imported global: from mod import _LOCK
            imp = self.imports.get(rel, {}).get(parts[0])
            if imp:
                ref = self.by_site.get(f"{imp[0]}:{imp[1]}.{parts[1]}")
                if ref:
                    return ref
        # unique attribute basename — module first, then global
        ref = self.by_mod_attr.get((rel, parts[-1]))
        if ref:
            return ref
        if (rel, parts[-1]) not in self.by_mod_attr:
            return self.by_attr.get(parts[-1])
        return None

    # -- call resolution --------------------------------------------

    def resolve_call(self, call: ast.Call, rel: str, cls: Optional[str],
                     qual: str) -> Optional[Tuple[str, str]]:
        chain = _attr_chain(call.func)
        if not chain:
            return None
        parts = chain.split(".")
        if parts[0] in ("self", "cls") and cls and len(parts) == 2:
            key = (rel, f"{cls}.{parts[1]}")
            if key in self.funcs:
                return key
            m = self.methods.get(parts[1])
            return m if m and m[0] == rel else None
        if len(parts) == 1:
            name = parts[0]
            # sibling nested function first, then module-level, then
            # a from-import
            prefix = qual.rsplit(".", 1)[0] if "." in qual else None
            if prefix and (rel, f"{prefix}.{name}") in self.funcs:
                return (rel, f"{prefix}.{name}")
            if (rel, name) in self.funcs:
                return (rel, name)
            imp = self.imports.get(rel, {}).get(name)
            if imp and imp in self.funcs:
                return imp
            return None
        if len(parts) == 2:
            head, meth = parts
            crel = self.classes.get(head)
            if crel and (crel, f"{head}.{meth}") in self.funcs:
                return (crel, f"{head}.{meth}")
            s = self.singletons.get(head)
            if s and (s[0], f"{s[1]}.{meth}") in self.funcs:
                return (s[0], f"{s[1]}.{meth}")
            arel = self.mod_aliases.get(rel, {}).get(head)
            if arel and (arel, meth) in self.funcs:
                return (arel, meth)
            imp = self.imports.get(rel, {}).get(head)
            if imp:
                # from pkg import module  /  from mod import SINGLETON
                rel2 = _module_to_rel(
                    imp[0][:-3].replace("/", ".") + "." + imp[1]) \
                    if imp[0].endswith("__init__.py") else None
                if rel2 and (rel2, meth) in self.funcs:
                    return (rel2, meth)
                if (imp[0], f"{imp[1]}.{meth}") in self.funcs:
                    return (imp[0], f"{imp[1]}.{meth}")
                s2 = self.singletons.get(imp[1])
                if s2 and (s2[0], f"{s2[1]}.{meth}") in self.funcs:
                    return (s2[0], f"{s2[1]}.{meth}")
        # unique method basename anywhere — except names shared with
        # the builtin container/str/file protocol, where the receiver
        # is far more likely a dict/set/list/file than the one class
        # that happens to define the method (``_BLOCKLIST.update(...)``
        # must not resolve to some unrelated ``Foo.update``)
        if parts[-1] in _BUILTIN_METHOD_NAMES:
            return None
        return self.methods.get(parts[-1])


# ---------------------------------------------------------------------------
# per-function event extraction
# ---------------------------------------------------------------------------


def _acquire_blocking(call: ast.Call) -> bool:
    """blocking flag of a ``.acquire(...)`` call; non-literal ->
    treated as blocking (conservative)."""
    for kw in call.keywords:
        if kw.arg == "blocking":
            return not (isinstance(kw.value, ast.Constant)
                        and kw.value.value is False)
    if call.args:
        a0 = call.args[0]
        if isinstance(a0, ast.Constant) and a0.value is False:
            return False
    return True


def _effect_of(call: ast.Call, chain: str,
               idx: _Indexes, rel: str,
               cls: Optional[str]) -> Optional[_Event]:
    parts = chain.split(".")
    sync = _host_sync_call(call)
    if sync:
        return _Event("effect", desc=f"host sync {sync}",
                      line=call.lineno)
    if chain.endswith(_SOCKET_CALL_SUFFIXES) \
            or chain == "socket.create_connection":
        return _Event("effect", desc=f"socket {chain}()",
                      line=call.lineno)
    if chain.startswith("subprocess."):
        return _Event("effect", desc=f"{chain}()", line=call.lineno)
    if parts[-1] == "fault_point":
        return _Event("effect", desc="fault_point() raise site",
                      line=call.lineno)
    if parts[-1] == "record_incident":
        return _Event("effect", desc="record_incident() (flight-"
                      "recorder dump walks every snapshot surface)",
                      line=call.lineno)
    if parts[-1] in ("wait", "wait_for") and len(parts) >= 2 \
            and isinstance(call.func, ast.Attribute):
        ref = idx.resolve_lock(call.func.value, rel, cls)
        if ref is not None and ref.kind == "Condition":
            return _Event("effect",
                          desc=f"wait on Condition {ref.name!r}",
                          waited=ref, line=call.lineno)
    return None


def _extract_events(trees: Dict[str, ast.AST], idx: _Indexes) -> None:
    """Fill every _Func with its direct events, calls, and
    held-region snapshots."""
    for rel, tree in sorted(trees.items()):
        if rel == _LOCKORDER_MODULE:
            continue

        def do_func(fnode, key: Tuple[str, str]):
            fn = idx.funcs[key]

            def walk(node, held: Tuple[_LockRef, ...]):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef,
                                     ast.Lambda)):
                    # nested defs run later, not under these locks
                    return
                acquired_here: List[_LockRef] = []
                if isinstance(node, ast.With):
                    for item in node.items:
                        ref = idx.resolve_lock(item.context_expr, rel,
                                               fn.cls)
                        if ref is not None:
                            ev = _Event("acquire", lock=ref,
                                        blocking=True,
                                        line=node.lineno)
                            fn.events.append(ev)
                            if held:
                                fn.held_events.append((held, ev))
                            acquired_here.append(ref)
                elif isinstance(node, ast.Call):
                    chain = _attr_chain(node.func)
                    if chain.split(".")[-1] == "acquire" \
                            and isinstance(node.func, ast.Attribute):
                        ref = idx.resolve_lock(node.func.value, rel,
                                               fn.cls)
                        if ref is not None:
                            ev = _Event("acquire", lock=ref,
                                        blocking=_acquire_blocking(node),
                                        line=node.lineno)
                            fn.events.append(ev)
                            if held:
                                fn.held_events.append((held, ev))
                    else:
                        ev = _effect_of(node, chain, idx, rel, fn.cls)
                        if ev is not None:
                            fn.events.append(ev)
                            if held:
                                fn.held_events.append((held, ev))
                        else:
                            callee = idx.resolve_call(node, rel, fn.cls,
                                                      fn.qual)
                            if callee is not None and callee != key:
                                fn.calls.append((callee, node.lineno))
                                if held:
                                    fn.held_calls.append(
                                        (held, callee, node.lineno))
                if acquired_here:
                    inner = held + tuple(acquired_here)
                    for child in ast.iter_child_nodes(node):
                        walk(child, inner)
                else:
                    for child in ast.iter_child_nodes(node):
                        walk(child, held)

            for child in ast.iter_child_nodes(fnode):
                walk(child, ())

        def find_funcs(node, prefix: str):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    q = f"{prefix}.{child.name}" if prefix else child.name
                    find_funcs(child, q)
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    q = f"{prefix}.{child.name}" if prefix else child.name
                    if (rel, q) in idx.funcs:
                        do_func(child, (rel, q))
                    find_funcs(child, q)
                else:
                    find_funcs(child, prefix)

        find_funcs(tree, "")


# ---------------------------------------------------------------------------
# transitive closure + findings
# ---------------------------------------------------------------------------


def _closure(idx: _Indexes, key: Tuple[str, str], depth: int,
             memo: Dict[Tuple[Tuple[str, str], int], List[_Event]],
             stack: Set[Tuple[str, str]]) -> List[_Event]:
    """Every acquire/effect event reachable from ``key`` within
    ``depth`` call hops (cycle-safe, memoized)."""
    mk = (key, depth)
    if mk in memo:
        return memo[mk]
    if key in stack:
        return []
    fn = idx.funcs.get(key)
    if fn is None:
        return []
    out = list(fn.events)
    if depth > 0:
        stack.add(key)
        seen: Set[Tuple[str, str]] = set()
        for callee, _line in fn.calls:
            if callee in seen:
                continue
            seen.add(callee)
            out.extend(_closure(idx, callee, depth - 1, memo, stack))
        stack.discard(key)
    memo[mk] = out
    return out


def check_concurrency(trees: Dict[str, ast.AST],
                      diags: List[Diagnostic],
                      *,
                      registry=None,
                      order_allow: Optional[Dict[str, str]] = None,
                      effect_allow: Optional[Dict[str, str]] = None,
                      call_depth: int = _CALL_DEPTH) -> None:
    """Run all three concurrency rules over the parsed repo.

    ``trees`` maps repo-relative paths to parsed ASTs (the whole
    package in real runs; tests pass synthetic subsets with a custom
    ``registry`` of LockDecls)."""
    if registry is None:
        from spark_rapids_tpu_torch.lockorder import LOCK_ORDER
        registry = LOCK_ORDER
    if order_allow is None:
        order_allow = _LOCK_ORDER_ALLOWLIST
    if effect_allow is None:
        effect_allow = _LOCK_EFFECT_ALLOWLIST

    _check_lock_decl(trees, diags, registry)

    idx = _Indexes(trees, registry)
    _extract_events(trees, idx)

    memo: Dict[Tuple[Tuple[str, str], int], List[_Event]] = {}
    #: blocking held->acquired edges for the cycle pass:
    #: (held name, acquired name) -> first "rel:line via" evidence
    edges: Dict[Tuple[str, str], str] = {}
    seen_findings: Set[Tuple[str, str, str, str]] = set()

    def order_finding(fn: _Func, held: _LockRef, acq: _LockRef,
                      line: int, via: str):
        fkey = f"{fn.rel}:{fn.qual}"
        dedup = ("order", fkey, held.name, acq.name)
        if dedup in seen_findings:
            return
        seen_findings.add(dedup)
        if fkey in order_allow:
            return
        diags.append(make(
            "RL-LOCK-ORDER", f"{fn.rel}:{line}",
            f"blocking acquire of {acq.name!r} (rank {acq.rank}) "
            f"while holding {held.name!r} (rank {held.rank})"
            + (f" via {via}" if via else "")
            + " — acquisition must strictly ascend LOCK_ORDER ranks; "
            "use acquire(blocking=False), reorder, or allowlist "
            f"{fkey} in _LOCK_ORDER_ALLOWLIST with a justification"))

    def effect_finding(fn: _Func, held: _LockRef, ev: _Event,
                       line: int, via: str):
        fkey = f"{fn.rel}:{fn.qual}"
        dedup = ("effect", fkey, held.name, ev.desc)
        if dedup in seen_findings:
            return
        seen_findings.add(dedup)
        if fkey in effect_allow:
            return
        diags.append(make(
            "RL-LOCK-EFFECT", f"{fn.rel}:{line}",
            f"{ev.desc} while holding lock {held.name!r}"
            + (f" via {via}" if via else "")
            + " — blocking work under a lock turns one slow/wedged "
            "operation into a pile-up; move it outside the critical "
            f"section or allowlist {fkey} in _LOCK_EFFECT_ALLOWLIST "
            "with a justification"))

    def consider(fn: _Func, held: Tuple[_LockRef, ...], ev: _Event,
                 line: int, via: str):
        if ev.kind == "acquire":
            for h in held:
                if h.name == ev.lock.name:
                    continue  # reentrant/same-decl: instance ordering
                if ev.blocking:
                    edges.setdefault((h.name, ev.lock.name),
                                     f"{fn.rel}:{line}"
                                     + (f" via {via}" if via else ""))
                    if ev.lock.rank <= h.rank:
                        order_finding(fn, h, ev.lock, line, via)
        else:
            for h in held:
                if ev.waited is not None and ev.waited.name == h.name:
                    continue  # waiting on the condition you hold: fine
                effect_finding(fn, h, ev, line, via)

    for key in sorted(idx.funcs):
        fn = idx.funcs[key]
        for held, ev in fn.held_events:
            consider(fn, held, ev, ev.line, "")
        for held, callee, line in fn.held_calls:
            sub = _closure(idx, callee, call_depth - 1, memo, set())
            via = f"{callee[1]}()"
            for ev in sub:
                consider(fn, held, ev, line, via)

    # cycle pass over ALL blocking edges (allowlisted included): a
    # rank-clean graph cannot cycle, so any cycle here means an
    # allowlisted/violating edge composed into a real deadlock shape
    cyc = _find_cycle(edges)
    if cyc:
        path = " -> ".join(cyc + [cyc[0]])
        evidence = "; ".join(
            f"{a}->{b} at {edges[(a, b)]}"
            for a, b in zip(cyc, cyc[1:] + [cyc[0]])
            if (a, b) in edges)
        diags.append(make(
            "RL-LOCK-ORDER", "lockorder:cycle",
            f"lock acquisition graph contains a cycle: {path} "
            f"({evidence}) — a deadlock is one unlucky interleaving "
            "away; break the cycle, allowlisting cannot suppress it"))


def _find_cycle(edges: Dict[Tuple[str, str], str]) -> List[str]:
    """First cycle in the directed edge set (DFS), [] when acyclic."""
    graph: Dict[str, List[str]] = {}
    for a, b in sorted(edges):
        graph.setdefault(a, []).append(b)
    WHITE, GREY, BLACK = 0, 1, 2
    color: Dict[str, int] = {}
    parent: Dict[str, str] = {}

    def dfs(u: str) -> Optional[List[str]]:
        color[u] = GREY
        for v in graph.get(u, ()):
            c = color.get(v, WHITE)
            if c == GREY:
                cyc = [v]
                w = u
                while w != v:
                    cyc.append(w)
                    w = parent[w]
                cyc.reverse()
                return cyc
            if c == WHITE:
                parent[v] = u
                found = dfs(v)
                if found:
                    return found
        color[u] = BLACK
        return None

    for u in sorted(graph):
        if color.get(u, WHITE) == WHITE:
            found = dfs(u)
            if found:
                return found
    return []
