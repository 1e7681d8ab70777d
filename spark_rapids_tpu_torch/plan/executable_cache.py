"""Plan -> executable cache: skip the conversion of repeated query
templates (port of ``spark_rapids_tpu/plan/executable_cache.py``).

The reference caches the converted exec tree so that a repeated template
skips its overrides, its plan verification and its kernels' re-tracing.
The port's kernels are built once per process by nvcc, so what a hit
saves here is the host planning: column pruning, the conversion, the
LORE numbering and the boundary installs. Entries are grouped by the
LITERAL-STRIPPED structural fingerprint (plan/fingerprint.py), the
TEMPLATE, and within a template keyed by the full fingerprint:

* an exactly repeated plan (same literals, same tables) checks out the
  cached converted tree and runs no conversion
  (``executableCacheHits``);
* a distinct-literal variant of a known template converts afresh and
  counts ``executableCacheTemplateHits``.

Correctness:

* **Exclusive checkout**: a tree is executed by ONE query at a time;
  each variant keeps a small pool of trees for concurrent identical
  queries.
* **Warehouse epoch**: entries remember the invalidation epoch they were
  filled under; a write or a catalog change stales them on lookup.
* **Circuit-breaker trips**: where the reference demotes an operator the
  port raises at every later conversion (runtime/faults.py), so a trip
  must stale the entry all the same: entries pin the tripped set, and
  the device-loss generation, they were converted under.
* **Per-run state** starts clean on checkout (:func:`_reset_for_reuse`:
  the execs' metrics, deferred row counts), and a tree parked idle holds
  no device memory (:func:`_release_device_state`: a broadcast's cached
  batch, so a hit also launches what a fresh tree launches).
* **Failure**: an entry whose run raises is dropped; fills happen only
  after a fully successful run.

Counters live in the ``compile`` metric scope (dispatch.py).
"""

from __future__ import annotations

from collections import OrderedDict

from spark_rapids_tpu_torch.dispatch import COMPILE_SCOPE
from spark_rapids_tpu_torch.lockorder import ordered_lock
from spark_rapids_tpu_torch.obs.metrics import register_metric
from spark_rapids_tpu_torch.plan.fingerprint import (
    invalidation_epoch,
    plan_fingerprints,
)

register_metric("executableCacheHits", "count", "ESSENTIAL",
                "queries that checked out a cached converted "
                "executable (no conversion ran)")
register_metric("executableCacheMisses", "count", "ESSENTIAL",
                "queries that converted their plan fresh (template "
                "unseen, literal variant, stale entry, uncacheable "
                "plan, or entry busy)")
register_metric("executableCacheTemplateHits", "count", "MODERATE",
                "misses whose literal-stripped TEMPLATE was already "
                "cached (a literal variant of a known query)")
register_metric("executableCacheInvalidations", "count", "MODERATE",
                "cached executables dropped on lookup after a "
                "warehouse epoch bump or a circuit-breaker demotion")
register_metric("executableCacheEvictions", "count", "MODERATE",
                "cached executables evicted by the LRU bounds")


def _demotions_token() -> tuple:
    """The coherency component of an entry's generation beyond the
    warehouse epoch: the circuit breaker's demoted operators (a
    demotion re-tags the operator onto the CPU route) and the health
    monitor's device-loss generation (a tree
    converted before a loss never re-parks into a later pool, even though
    the recovery also cleared the cache), the mesh's generation (a tree
    planned under one mesh neither serves nor re-parks under another) and
    the cluster's."""
    from spark_rapids_tpu_torch.parallel.mesh import MESH
    from spark_rapids_tpu_torch.runtime.cluster import CLUSTER
    from spark_rapids_tpu_torch.runtime.faults import CIRCUIT_BREAKER
    from spark_rapids_tpu_torch.runtime.health import HEALTH
    return (tuple(sorted(CIRCUIT_BREAKER.demoted_ops().items())),
            HEALTH.generation(), MESH.generation(), CLUSTER.generation())


def _reset_for_reuse(executable) -> None:
    """Clear the per-run state of a checked-out tree: each exec's metrics
    (each query's record reports its OWN numbers) and deferred row counts
    a previous run left."""
    from spark_rapids_tpu_torch.lore import _iter_tree
    for e in _iter_tree(executable):
        m = e.__dict__.get("_metrics")
        if m is not None:
            m.clear()
        if e.__dict__.get("_obs_pending_rows"):
            e._obs_pending_rows = []


def _release_device_state(executable) -> None:
    """A tree parked idle holds no device memory: a broadcast's cached
    batch is released (the next run builds it again, as a freshly
    converted tree would, launch for launch)."""
    from spark_rapids_tpu_torch.lore import _iter_tree
    for e in _iter_tree(executable):
        cached = e.__dict__.get("_cached")
        if cached is not None:
            e._cached = None
            cached.release()


#: converted trees retained per (template, literal variant): exec
#: instances hold per-run state, so CONCURRENT identical queries each
#: need their own tree — the pool lets a burst of one query check out
#: one tree each instead of all but the first missing
_MAX_TREES_PER_VARIANT = 4


class _Variant:
    """One literal variant's tree pool: ``idle`` trees are available
    for checkout, ``busy`` counts trees currently executing (they pin
    the variant against LRU eviction)."""

    __slots__ = ("idle", "busy", "epoch", "demotions")

    def __init__(self, epoch, demotions):
        self.idle = []  # list of (executable, meta)
        self.busy = 0
        self.epoch = epoch
        self.demotions = demotions


class CheckoutToken:
    """Handle for one query's use of the cache. ``executable`` is None
    on a miss — the holder converts fresh and calls :meth:`fill` after
    a successful run; either way :meth:`release` must be called exactly
    once when the query's envelope (event record included) is done with
    the tree."""

    __slots__ = ("cache", "template_fp", "full_fp", "executable", "meta",
                 "hit", "template_hit", "epoch", "demotions", "_released",
                 "_filled")

    def __init__(self, cache, template_fp, full_fp, executable, meta,
                 hit, template_hit, epoch, demotions):
        self.cache = cache
        self.template_fp = template_fp
        self.full_fp = full_fp
        self.executable = executable
        self.meta = meta
        self.hit = hit
        self.template_hit = template_hit
        #: the coherency generation this token's tree belongs to,
        #: captured at CHECKOUT (i.e. before execution): fills stamp it
        #: and release only re-parks into a generation-matching variant
        #: — a tree converted before a write must never join the
        #: post-write pool, and a mid-run write stales the fill
        self.epoch = epoch
        self.demotions = demotions
        self._released = False
        self._filled = False

    def fill(self, executable, meta) -> None:
        """Register a freshly converted tree after a SUCCESSFUL run.
        The tree stays checked out (busy) until release(). A token the
        envelope already released (e.g. dropped by a recovery replay)
        must not fill — the busy increment would never be paired."""
        if self.hit or self.template_fp is None or self._released:
            return
        self.executable = executable
        self.meta = meta
        self._filled = self.cache._fill(
            self.template_fp, self.full_fp, self.epoch, self.demotions)

    def release(self, drop: bool = False) -> None:
        if self._released:
            return
        self._released = True
        if self.template_fp is not None and self.executable is not None \
                and (self.hit or self._filled):
            self.cache._release(self.template_fp, self.full_fp,
                                self.executable, self.meta, drop,
                                self.epoch, self.demotions)


class ExecutableCache:
    """Two-level LRU: templates (literal-stripped fingerprints) ->
    literal variants (full fingerprints) -> converted executables.

    Bounded by ENTRY COUNT, and a cached tree strongly pins its plan's
    in-memory source tables — ``maxPlans`` is therefore also the memory
    bound and defaults low (64); a serving workload's template set is
    small. (The result cache bounds by bytes because results are
    arbitrary-size outputs; here each template pins roughly its input
    working set, which entry count tracks.)"""

    def __init__(self, max_plans: int = 64, max_variants: int = 4):
        self.max_plans = int(max_plans)
        self.max_variants = int(max_variants)
        self._lock = ordered_lock("executable_cache")
        #: template_fp -> OrderedDict[full_fp, _Variant]
        self._templates: "OrderedDict[str, OrderedDict]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.template_hits = 0
        self.invalidations = 0
        self.evictions = 0

    def configure(self, max_plans: int, max_variants: int) -> None:
        with self._lock:
            self.max_plans = int(max_plans)
            self.max_variants = int(max_variants)

    # -- lookup --------------------------------------------------------------
    def checkout(self, plan, conf, device=None) -> CheckoutToken:
        """Resolve ``plan`` against the cache. Returns a token whose
        ``executable`` is a cached converted tree on a hit (reset for
        reuse, exclusively checked out from the variant's pool) or None
        on a miss. ``device`` (the session's) folds into both keys: a
        tree converted for one device never serves another."""
        template_fp, full_fp = plan_fingerprints(plan, conf)
        if template_fp is not None and device is not None:
            template_fp = f"{template_fp}@{device}"
            full_fp = f"{full_fp}@{device}"
        if template_fp is None:
            with self._lock:
                self.misses += 1
            COMPILE_SCOPE.add("executableCacheMisses", 1)
            return CheckoutToken(self, None, None, None, None, False,
                                 False, 0, ())
        epoch = invalidation_epoch()
        demotions = _demotions_token()
        tree = None
        template_hit = False
        with self._lock:
            variants = self._templates.get(template_fp)
            if variants is not None:
                self._templates.move_to_end(template_fp)
                template_hit = True
                v = variants.get(full_fp)
                if v is not None and (v.epoch != epoch
                                      or v.demotions != demotions):
                    # stale: idle trees drop now; busy ones are simply
                    # never returned (release discards on mismatch)
                    del variants[full_fp]
                    self.invalidations += 1
                    COMPILE_SCOPE.add("executableCacheInvalidations", 1)
                    v = None
                if v is not None and v.idle:
                    tree = v.idle.pop()
                    v.busy += 1
                    variants.move_to_end(full_fp)
            if tree is not None:
                self.hits += 1
            else:
                self.misses += 1
                if template_hit:
                    self.template_hits += 1
        if tree is not None:
            COMPILE_SCOPE.add("executableCacheHits", 1)
            executable, meta = tree
            _reset_for_reuse(executable)
            return CheckoutToken(self, template_fp, full_fp, executable,
                                 meta, True, True, epoch, demotions)
        COMPILE_SCOPE.add("executableCacheMisses", 1)
        if template_hit:
            COMPILE_SCOPE.add("executableCacheTemplateHits", 1)
        return CheckoutToken(self, template_fp, full_fp, None, None,
                             False, template_hit, epoch, demotions)

    # -- internal (token-driven) ---------------------------------------------
    def _fill(self, template_fp, full_fp, epoch, demotions) -> bool:
        """A miss's freshly converted tree becomes a BUSY member of its
        variant's pool (stamped with the CHECKOUT-time generation, so a
        write landing mid-run stales the entry on its first lookup
        instead of being masked); release() parks it idle. Returns
        False — and caches nothing — when a different generation's
        variant already occupies the slot."""
        with self._lock:
            variants = self._templates.get(template_fp)
            if variants is None:
                variants = self._templates[template_fp] = OrderedDict()
                while len(self._templates) > self.max_plans:
                    tkey = next(iter(self._templates))
                    if tkey == template_fp:
                        break
                    dropped = self._templates.pop(tkey)
                    n = sum(len(v.idle) for v in dropped.values())
                    self.evictions += n
                    if n:
                        COMPILE_SCOPE.add("executableCacheEvictions", n)
            else:
                self._templates.move_to_end(template_fp)
            v = variants.get(full_fp)
            if v is not None and (v.epoch, v.demotions) != (epoch,
                                                            demotions):
                # another generation owns the slot (e.g. a post-write
                # refill while this pre-write run was still executing):
                # never displace it with this token's generation
                return False
            if v is None:
                v = variants[full_fp] = _Variant(epoch, demotions)
                while len(variants) > self.max_variants:
                    vkey = next((k for k in variants if k != full_fp),
                                None)
                    if vkey is None:
                        break
                    dropped_v = variants.pop(vkey)
                    n = len(dropped_v.idle)
                    self.evictions += n
                    if n:
                        COMPILE_SCOPE.add("executableCacheEvictions", n)
            variants.move_to_end(full_fp)
            v.busy += 1
            return True

    def _release(self, template_fp, full_fp, executable, meta,
                 drop, epoch, demotions) -> None:
        with self._lock:
            variants = self._templates.get(template_fp)
            v = variants.get(full_fp) if variants is not None else None
            if v is not None and v.busy > 0 \
                    and (v.epoch, v.demotions) == (epoch, demotions):
                # generation must match the TOKEN's: a stale lookup may
                # have dropped this tree's variant and a fresh fill
                # re-created the slot — a pre-invalidation tree must
                # neither join the new pool nor corrupt its busy count
                v.busy -= 1
                if not drop and len(v.idle) < _MAX_TREES_PER_VARIANT:
                    _release_device_state(executable)
                    v.idle.append((executable, meta))
            # drop / stale / evicted-variant trees are simply discarded

    # -- introspection -------------------------------------------------------
    def clear(self) -> None:
        with self._lock:
            self._templates.clear()

    def invalidate_all(self) -> int:
        """Device-loss recovery (runtime/health.py): every cached tree
        may hold state of the lost context (a broadcast's batch), so the
        whole cache drops, COUNTED as invalidations, unlike the
        test-support clear(). Busy trees are simply never returned
        (release discards on generation mismatch). Returns entries
        invalidated."""
        with self._lock:
            n = sum(len(vv.idle) for v in self._templates.values()
                    for vv in v.values())
            self._templates.clear()
            if n:
                self.invalidations += n
        if n:
            COMPILE_SCOPE.add("executableCacheInvalidations", n)
        return n

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "templateHits": self.template_hits,
                "invalidations": self.invalidations,
                "evictions": self.evictions,
                "templates": len(self._templates),
                "variants": sum(len(v) for v in
                                self._templates.values()),
                "idleTrees": sum(
                    len(vv.idle) for v in self._templates.values()
                    for vv in v.values()),
                "busyTrees": sum(
                    vv.busy for v in self._templates.values()
                    for vv in v.values()),
            }


#: the process-wide cache: two sessions with identical
#: executable-affecting conf on one device share entries
EXEC_CACHE = ExecutableCache()
