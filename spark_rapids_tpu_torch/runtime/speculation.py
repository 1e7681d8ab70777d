"""Speculative sizing: deferred validation of data-dependent decisions
(port of ``spark_rapids_tpu/runtime/speculation.py``).

Operators SPECULATE (a direct-address join's key range fits its table, a
hash-probe table placed every build row and found no duplicate key, a
join's output fits the probe side's bucket, a sort-segment aggregate's
groups fit a quarter of its input), keep the real counts on the device,
and record a device boolean "speculation failed" flag at the operator's
SITE. Nothing syncs mid-plan: the session reads every flag of a query at
once when it collects the result. If any is set, the failing sites go on
a process-wide blocklist and the session replays the query; the replay
takes the exact path at those sites, so results are always exact and a
repeated query shape replays at most once per site.
"""

from __future__ import annotations

import contextvars
import threading
from typing import List, Optional, Tuple

import torch


class SpeculationFailed(Exception):
    """A speculative capacity or layout guess was wrong; replay exactly."""

    def __init__(self, sites: List[str]):
        super().__init__(f"speculation failed at sites: {sites}")
        self.sites = list(sites)


class SpecContext:
    """Per-query-execution collection of pending speculation flags (0-d
    bool tensors, True when the speculation they guard FAILED)."""

    def __init__(self):
        self.pending: List[Tuple[str, torch.Tensor]] = []

    def add_flag(self, site_key: str, flag: torch.Tensor) -> None:
        self.pending.append((site_key, flag))

    def take_pending(self) -> List[Tuple[str, torch.Tensor]]:
        out = self.pending
        self.pending = []
        return out

    def validate_remaining(self) -> None:
        """Read every pending flag in one device-to-host copy and raise
        SpeculationFailed naming the failed sites."""
        pending = self.take_pending()
        if not pending:
            return
        vals = torch.stack([f.reshape(()) for _, f in pending]).cpu()
        check_flag_values([s for s, _ in pending], vals.tolist())


def check_flag_values(sites: List[str], values) -> None:
    failed = [s for s, v in zip(sites, values) if bool(v)]
    if failed:
        raise SpeculationFailed(failed)


_CTX: contextvars.ContextVar[Optional[SpecContext]] = contextvars.ContextVar(
    "rapids_torch_spec_ctx", default=None)

#: sites whose speculation failed once: they take the exact path from then
#: on (per process), so a repeated query shape never replays twice
_BLOCKLIST = set()
#: guards _BLOCKLIST writes from concurrent sessions (membership reads
#: stay lock-free: a stale read costs one extra speculative attempt)
_BLOCKLIST_LOCK = threading.Lock()


def current() -> Optional[SpecContext]:
    return _CTX.get()


def activate() -> "contextvars.Token":
    return _CTX.set(SpecContext())


def deactivate(token) -> None:
    _CTX.reset(token)


def allowed(site_key: str) -> Optional[SpecContext]:
    """The active context, iff speculation is enabled for this site."""
    ctx = _CTX.get()
    if ctx is None or site_key in _BLOCKLIST:
        return None
    return ctx


def blocklist(sites) -> None:
    with _BLOCKLIST_LOCK:
        _BLOCKLIST.update(sites)


def clear_blocklist() -> None:
    """Forget every blocklisted site (tests, and a program that runs two
    data forms of one query shape in one process)."""
    with _BLOCKLIST_LOCK:
        _BLOCKLIST.clear()



def guard_attempt(fn):
    """Run ``fn``, dropping the speculation flags it added if it raises:
    an attempt aborted by an OOM and replayed by the retry framework
    (runtime/retry.py) must not leave its flags to be validated, and must
    not consume or clear the flags of the attempt around it.
    ``take_pending`` replaces the pending list, so the snapshot tracks
    the list's identity: if it changed, everything pending was added
    here."""
    ctx = _CTX.get()
    snap_list = ctx.pending if ctx is not None else None
    snap_len = len(snap_list) if snap_list is not None else 0
    try:
        return fn()
    except BaseException:
        if ctx is not None:
            if ctx.pending is snap_list:
                del ctx.pending[snap_len:]
            else:
                ctx.pending.clear()
        raise
