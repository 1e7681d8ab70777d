"""Canonical structural plan fingerprinting (port of
``spark_rapids_tpu/plan/fingerprint.py``).

One implementation, two variants:

* **full** (``strip_literals=False``) — every non-child attribute of
  every plan node and expression folds in, INCLUDING literal values.
  This is the query service's result-cache key
  (service/result_cache.py) and, within a template, the executable cache's variant key:
  two plans differing in any literal compute different tables and must
  never collide.
* **template** (``strip_literals=True``) — ``Literal`` expression
  nodes contribute only their dtype and null-ness, so distinct-literal
  variants of one query template (``price > 5`` vs ``price > 6``)
  share a fingerprint. This is the executable-cache grouping key
  (plan/executable_cache.py) and the key the poison-query quarantine
  strikes (runtime/health.py).

The two keys diverge EXACTLY on literal values (held against the
reference's classes by tests/test_torch_exec_cache.py): any other
difference changes both.

Correctness over hit rate, everywhere: anything the walk cannot PROVE
structurally stable (a UDF closure, an unknown object with an
address-y repr) raises :class:`Unfingerprintable` and the caller
treats the plan as uncacheable — a miss, never a wrong hit.

The warehouse invalidation epoch lives here too (it versions the
state BOTH caches key against): every catalog mutation, WriteFiles
execution, or Delta/Iceberg commit bumps it; cache entries remember
the epoch they were filled under and stale entries drop on lookup.
"""

from __future__ import annotations

import hashlib
import os
import weakref
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from spark_rapids_tpu_torch.lockorder import ordered_lock

# ---------------------------------------------------------------------------
# Invalidation epochs
# ---------------------------------------------------------------------------
#
# Two granularities version the warehouse state the caches key against:
#
# * the GLOBAL epoch — catalog-wide changes (temp-view/table
#   registration, WriteFiles to arbitrary paths) where the affected
#   table set is unknowable; a bump stales EVERY entry;
# * PER-TABLE epochs — a Delta commit names exactly the table it
#   changed (:func:`delta_table_id`), so only entries whose plans READ
#   that table (:func:`plan_table_ids`) go stale, and a hot cache over
#   an unrelated table survives the commit.
#
# Cache entries snapshot the vector they were filled under
# (:func:`epoch_snapshot`) and drop on lookup when any component moved
# (:func:`epochs_current`). Listeners (:func:`register_epoch_listener`)
# observe every bump (the reference's materialized-view registry rides
# this hook; streaming is item [12b]). Delta's table-scoped bumps
# (``delta_table_id``) wait for Delta (item [12b]).

_EPOCH_LOCK = ordered_lock("fingerprint.epoch")
_EPOCH = [0]
_EPOCH_REASON = [""]
_TABLE_EPOCHS: Dict[str, int] = {}
_EPOCH_LISTENERS: List[Callable] = []

#: the global component's key inside an epoch-snapshot dict (never a
#: valid table id — table ids always carry a "<kind>:" prefix)
GLOBAL_EPOCH_KEY = ""


def invalidation_epoch() -> int:
    with _EPOCH_LOCK:
        return _EPOCH[0]


def table_epoch(table_id: str) -> int:
    """Current epoch of one table identity (0 until its first bump)."""
    with _EPOCH_LOCK:
        return _TABLE_EPOCHS.get(table_id, 0)


def _notify_listeners(table_id: Optional[str], epoch: int,
                      reason: str) -> None:
    # outside _EPOCH_LOCK: listeners run arbitrary user code (the MV
    # registry marks views stale) and must never deadlock a concurrent
    # epoch read; snapshot under the lock, call without it
    with _EPOCH_LOCK:
        listeners = list(_EPOCH_LISTENERS)
    for fn in listeners:
        try:
            fn(table_id, epoch, reason)
        except Exception:
            pass  # a broken listener must not fail the commit path


def register_epoch_listener(fn: Callable) -> None:
    """Subscribe ``fn(table_id_or_None, new_epoch, reason)`` to every
    epoch bump (``table_id`` is None for global bumps). THE hook for
    maintenance that must react to commits without being dropped by
    them (incremental MV refresh)."""
    with _EPOCH_LOCK:
        if fn not in _EPOCH_LISTENERS:
            _EPOCH_LISTENERS.append(fn)


def unregister_epoch_listener(fn: Callable) -> None:
    with _EPOCH_LOCK:
        try:
            _EPOCH_LISTENERS.remove(fn)
        except ValueError:
            pass


def bump_invalidation_epoch(reason: str = "") -> int:
    """Catalog-wide state changed (temp-view or table registration,
    WriteFiles, schema mutation): every currently cached result — and
    every cached executable whose scans may now read different bytes —
    is stale. Called by the session after every WriteFiles run and by the
    SQL catalog's mutators."""
    with _EPOCH_LOCK:
        _EPOCH[0] += 1
        _EPOCH_REASON[0] = reason
        new = _EPOCH[0]
    _notify_listeners(None, new, reason)
    return new


def bump_table_epoch(table_id: str, reason: str = "") -> int:
    """ONE table's state changed (a Delta commit): entries whose plans
    read ``table_id`` are stale; everything else keeps serving. The
    global epoch does not move."""
    with _EPOCH_LOCK:
        _TABLE_EPOCHS[table_id] = _TABLE_EPOCHS.get(table_id, 0) + 1
        new = _TABLE_EPOCHS[table_id]
    _notify_listeners(table_id, new, reason)
    return new


def plan_table_ids(plan) -> frozenset:
    """The epoch-scoped table identities a plan reads: every node carrying
    a ``table_path`` (the reference's Delta and other log-backed scans,
    item [12b]). The port's file scans and in-memory tables key structurally
    through the fingerprint itself, so only the global epoch governs
    them, and this is empty."""
    ids = set()
    stack = [plan]
    while stack:
        n = stack.pop()
        tp = getattr(n, "table_path", None)
        if isinstance(tp, str) and tp:
            ids.add("table:" + os.path.abspath(tp))
        stack.extend(getattr(n, "children", ()))
    return frozenset(ids)


def epoch_snapshot(table_ids: Iterable[str] = ()) -> Dict[str, int]:
    """One atomic view of the global epoch plus the named tables'
    epochs — what a cache entry remembers it was filled under."""
    with _EPOCH_LOCK:
        snap = {GLOBAL_EPOCH_KEY: _EPOCH[0]}
        for t in table_ids:
            snap[t] = _TABLE_EPOCHS.get(t, 0)
    return snap


def epochs_current(snap: Dict[str, int]) -> bool:
    """Is a remembered epoch snapshot still the live state? False as
    soon as ANY component (global or per-table) moved."""
    with _EPOCH_LOCK:
        for k, v in snap.items():
            cur = _EPOCH[0] if k == GLOBAL_EPOCH_KEY \
                else _TABLE_EPOCHS.get(k, 0)
            if cur != v:
                return False
    return True


# ---------------------------------------------------------------------------
# Plan fingerprinting
# ---------------------------------------------------------------------------


class Unfingerprintable(Exception):
    """Internal: the plan holds state the fingerprinter cannot prove
    structurally stable. The query runs uncached."""


#: lazily resolved (datetime, np, T, HostTable, Expression, PlanNode,
#: Literal) — module-level import would pull the whole plan layer at
#: package import; resolving on first fingerprint keeps the module
#: importable standalone while the hot path pays one tuple unpack
_FP_TYPES = None


#: conf key prefixes that cannot change a query's RESULT — observability
#: and service knobs are excluded from the result-cache fingerprint so
#: flipping the event log on does not cold the cache. Everything else
#: folds in.
RESULT_NEUTRAL_PREFIXES = (
    "spark.rapids.sql.eventLog.",
    "spark.rapids.trace.",
    "spark.rapids.profile.",
    "spark.rapids.sql.metrics.level",
    "spark.rapids.sql.lore.",
    "spark.rapids.sql.explain",
    "spark.rapids.sql.planVerify.mode",
    "spark.rapids.service.",
    "spark.rapids.streaming.",
    # the lock witness wraps lock ACQUISITION bookkeeping only — query
    # results are byte-identical with it armed
    "spark.rapids.lint.",
    # fetch mechanics only — the root transition's flag is re-set per
    # query, results and the converted tree are byte-identical
    "spark.rapids.sql.asyncResultFetch",
    "spark.rapids.sql.executableCache.",
)

#: conf key prefixes that cannot change the CONVERTED EXECUTABLE. A
#: strict subset of the result-neutral set: lore dump ids rewrite the
#: tree (_TeeChild wrappers) and planVerify.mode decides whether the
#: tree was proven, so both fold into the executable-cache key even
#: though they cannot change results.
EXECUTABLE_NEUTRAL_PREFIXES = (
    "spark.rapids.sql.eventLog.",
    "spark.rapids.trace.",
    "spark.rapids.profile.",
    "spark.rapids.sql.metrics.level",
    "spark.rapids.sql.explain",
    "spark.rapids.service.",
    "spark.rapids.streaming.",
    "spark.rapids.lint.",
    "spark.rapids.sql.asyncResultFetch",
    "spark.rapids.sql.executableCache.",
)

#: identity tokens for in-memory source tables: a HostTable object IS
#: its data (tables are immutable after construction), so identity is a
#: sound cache key — and the weak keying means a collected table can
#: never alias a new one's token
_TABLE_TOKENS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_TABLE_TOKEN_LOCK = ordered_lock("fingerprint.table_tokens")
_TABLE_TOKEN_SEQ = [0]


def _table_token(table) -> str:
    with _TABLE_TOKEN_LOCK:
        tok = _TABLE_TOKENS.get(table)
        if tok is None:
            _TABLE_TOKEN_SEQ[0] += 1
            tok = f"tbl#{_TABLE_TOKEN_SEQ[0]}"
            _TABLE_TOKENS[table] = tok
        return tok


def _resolve_types():
    global _FP_TYPES
    if _FP_TYPES is None:
        import datetime

        import numpy as np

        from spark_rapids_tpu_torch import types as T
        from spark_rapids_tpu_torch.columnar import HostTable
        from spark_rapids_tpu_torch.ops.expr import Expression, Literal
        from spark_rapids_tpu_torch.plan.nodes import PlanNode
        _FP_TYPES = (datetime, np, T, HostTable, Expression, PlanNode,
                     Literal)
    return _FP_TYPES


def _fp_value(obj, depth: int = 0, strip_literals: bool = False) -> str:
    """One value's canonical token. Raises Unfingerprintable for
    anything that cannot be proven stable."""
    # deferred-but-cached: fingerprinting runs on the service's submit
    # hot path, once per attribute of every plan node — resolve the
    # type anchors once per process, not per call
    datetime, np, T, HostTable, Expression, PlanNode, Literal = \
        _resolve_types()

    if depth > 64:
        raise Unfingerprintable("plan too deep to fingerprint")
    if obj is None or isinstance(obj, (bool, int, float, str, bytes)):
        return f"{type(obj).__name__}:{obj!r}"
    if isinstance(obj, (datetime.date, datetime.datetime)):
        return f"dt:{obj.isoformat()}"
    if isinstance(obj, T.DataType):
        return f"type:{obj}"
    if isinstance(obj, HostTable):
        return _fp_value_table(obj)
    if isinstance(obj, (Expression, PlanNode)) or \
            type(obj).__module__.startswith("spark_rapids_tpu_torch."):
        # generic structural walk over instance state — plan nodes,
        # expressions, and plain engine data holders (SortOrder,
        # WindowSpec, ...). Unlike __repr__ (which some subclasses leave
        # at the children-only default), this captures EVERY non-child
        # attribute, so two
        # nodes differing in any parameter can never collide; state the
        # walk cannot prove stable (closures, device arrays) raises
        # Unfingerprintable and the plan just never caches
        return _fp_node(obj, depth + 1, strip_literals)
    if isinstance(obj, np.generic):
        return f"np:{obj.dtype}:{obj!r}"
    if isinstance(obj, np.ndarray):
        if obj.dtype == object:
            raise Unfingerprintable("object ndarray in plan state")
        digest = hashlib.sha1(np.ascontiguousarray(obj).tobytes())
        return f"nd:{obj.dtype}:{obj.shape}:{digest.hexdigest()}"
    if isinstance(obj, dict):
        items = sorted((str(k), _fp_value(v, depth + 1, strip_literals))
                       for k, v in obj.items())
        return "dict{" + ",".join(f"{k}={v}" for k, v in items) + "}"
    if isinstance(obj, (list, tuple)):
        return ("seq[" +
                ",".join(_fp_value(v, depth + 1, strip_literals)
                         for v in obj) + "]")
    if isinstance(obj, (set, frozenset)):
        return ("set{" +
                ",".join(sorted(_fp_value(v, depth + 1, strip_literals)
                                for v in obj)) +
                "}")
    raise Unfingerprintable(
        f"{type(obj).__name__} in plan state is not fingerprintable")


def _fp_value_table(table) -> str:
    return f"table:{_table_token(table)}"


#: per-node attributes that never affect results (caches, back-refs;
#: the session conf folds into the fingerprint separately); a class may
#: name more in ``FINGERPRINT_SKIP`` (the file scans' lazy caches)
_SKIP_ATTRS = {"_session", "_table", "conf", "_conf"}


def _fp_node(node, depth: int = 0, strip_literals: bool = False) -> str:
    """Canonical token of one plan node or expression: class name +
    every non-child attribute's token (sorted by name) + children in
    order. With ``strip_literals``, a ``Literal`` contributes only its
    dtype and null-ness — the one place the template and full
    fingerprints are allowed to differ."""
    Literal = _resolve_types()[6]
    if strip_literals and isinstance(node, Literal):
        return (f"(Literal;dtype=type:{node.data_type};"
                f"null={node.value is None})[]")
    parts = [type(node).__name__]
    try:
        state = vars(node)
    except TypeError:  # __slots__ object; nothing generic to prove
        raise Unfingerprintable(
            f"{type(node).__name__} has no inspectable state")
    skip = getattr(type(node), "FINGERPRINT_SKIP", ())
    # a literal folded into another expression (the port's
    # StringEqualsLiteral) strips like a Literal
    literals = getattr(type(node), "FINGERPRINT_LITERALS", ()) \
        if strip_literals else ()
    for name in sorted(state):
        if name in _SKIP_ATTRS or name == "children" or name in skip:
            continue
        value = state[name]
        if name in literals:
            parts.append(f"{name}=literal:{type(value).__name__}:"
                         f"null={value is None}")
            continue
        if callable(value) and not isinstance(value, type):
            raise Unfingerprintable(
                f"{type(node).__name__}.{name} holds a callable")
        parts.append(
            f"{name}={_fp_value(value, depth + 1, strip_literals)}")
    kids = ",".join(_fp_node(c, depth + 1, strip_literals)
                    for c in getattr(node, "children", ()))
    return "(" + ";".join(parts) + ")[" + kids + "]"


def fingerprint(plan, conf, *, strip_literals: bool = False,
                neutral_prefixes: Tuple[str, ...] = RESULT_NEUTRAL_PREFIXES,
                ) -> Optional[str]:
    """Canonical fingerprint of (bound plan, result-affecting conf), or
    None when the plan is uncacheable (side-effecting WriteFiles nodes,
    UDF closures, unfingerprintable state)."""
    from spark_rapids_tpu_torch.plan.nodes import WriteFiles

    stack = [plan]
    while stack:
        n = stack.pop()
        if isinstance(n, WriteFiles):
            return None  # side effects never cache
        stack.extend(getattr(n, "children", ()))
    try:
        plan_tok = _fp_node(plan, 0, strip_literals)
    except Unfingerprintable:
        return None
    conf_items = sorted(
        (k, str(v)) for k, v in conf.to_dict().items()
        if not any(k.startswith(p) or k == p.rstrip(".")
                   for p in neutral_prefixes))
    h = hashlib.sha1()
    h.update(plan_tok.encode())
    h.update(repr(conf_items).encode())
    # the reference folds its mesh and cluster identities and its Pallas
    # demotions here; the port has none of the three (one card, no
    # demotion), and the executable cache folds the session's device in
    # beside this key (plan/executable_cache.py)
    return h.hexdigest()


def template_fingerprint(plan, conf) -> Optional[str]:
    """THE template key: literal-stripped, executable-neutral-conf
    fingerprint — what the executable cache groups by and the poison
    quarantine strikes against. One definition so the scheduler's
    strike ledger and explain()'s quarantine flag can never key on
    different fingerprints."""
    return fingerprint(plan, conf, strip_literals=True,
                       neutral_prefixes=EXECUTABLE_NEUTRAL_PREFIXES)


def plan_fingerprints(plan, conf) -> Tuple[Optional[str], Optional[str]]:
    """(template_fp, full_fp) for the executable cache: the template is
    literal-stripped and conf-reduced to executable-affecting keys; the
    full print distinguishes literal variants within the template.
    (None, None) for uncacheable plans."""
    template = template_fingerprint(plan, conf)
    if template is None:
        return None, None
    full = fingerprint(plan, conf, strip_literals=False,
                       neutral_prefixes=EXECUTABLE_NEUTRAL_PREFIXES)
    return template, full
