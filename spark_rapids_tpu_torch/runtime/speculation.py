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
from typing import List, Optional, Tuple

import torch

from spark_rapids_tpu_torch.lockorder import ordered_lock


class SpeculationFailed(Exception):
    """A speculative capacity or layout guess was wrong; replay exactly."""

    def __init__(self, sites: List[str]):
        super().__init__(f"speculation failed at sites: {sites}")
        self.sites = list(sites)


#: the site prefix of an ANSI violation flag (ops/expr.py::
#: deliver_ansi_flags): a user error, never a sizing miss
ANSI_PREFIX = "ansi:"


class SpecContext:
    """Per-query-execution collection of pending flags (0-d bool tensors,
    True when the speculation they guard FAILED, or, for an ``ansi:``
    site, when an ANSI check found a violation). ``read`` holds the
    ANSI flags already read with the result's row count
    (``read_with_ansi``), validated with the rest."""

    def __init__(self):
        self.pending: List[Tuple[str, torch.Tensor]] = []
        self.read: List[Tuple[str, bool]] = []

    def add_flag(self, site_key: str, flag: torch.Tensor) -> None:
        self.pending.append((site_key, flag))

    def take_pending(self) -> List[Tuple[str, torch.Tensor]]:
        out = self.pending
        self.pending = []
        return out

    def read_with_ansi(self, count: torch.Tensor) -> int:
        """``count`` (a 0-d device integer: the result's row count) read
        in ONE copy with every pending ANSI flag, which a query with ANSI
        off has none of; the flags' values wait in ``read`` for
        ``validate_remaining``, so a sizing miss still wins."""
        ansi = [(s, f) for s, f in self.pending if s.startswith(ANSI_PREFIX)]
        if ansi:
            self.pending = [(s, f) for s, f in self.pending
                            if not s.startswith(ANSI_PREFIX)]
        vals = torch.stack([count.reshape(()).to(torch.int64)] + [
            f.reshape(()).to(torch.int64) for _, f in ansi]).cpu().tolist()
        self.read.extend((s, bool(v)) for (s, _), v in zip(ansi, vals[1:]))
        return int(vals[0])

    def has_pending_ansi(self) -> bool:
        return any(s.startswith(ANSI_PREFIX) for s, _ in self.pending)

    def validate_remaining(self) -> None:
        """Read every pending flag in one device-to-host copy (none when
        nothing is pending) and check them with the ones already read:
        SpeculationFailed naming the failed sites, else AnsiViolation."""
        pending = self.take_pending()
        read, self.read = self.read, []
        if not pending and not read:
            return
        vals = torch.stack([f.reshape(()) for _, f in pending]).cpu() \
            .tolist() if pending else []
        check_flag_values([s for s, _ in pending] + [s for s, _ in read],
                          list(vals) + [v for _, v in read])


def check_flag_values(sites: List[str], values) -> None:
    """Raise for the set flags: a sizing miss first (its data, and any
    ANSI flag computed from it, is suspect: the exact replay computes
    the flags again over correct data), else an ANSI violation, a user
    error that a replay could not change."""
    failed = [s for s, v in zip(sites, values) if bool(v)]
    if not failed:
        return
    sizing = [s for s in failed if not s.startswith(ANSI_PREFIX)]
    if sizing:
        raise SpeculationFailed(sizing)
    from spark_rapids_tpu_torch.errors import AnsiViolation
    ansi = [s[len(ANSI_PREFIX):] for s in failed]
    raise AnsiViolation("[ANSI] " + "; ".join(sorted(set(ansi))))


_CTX: contextvars.ContextVar[Optional[SpecContext]] = contextvars.ContextVar(
    "rapids_torch_spec_ctx", default=None)

#: sites whose speculation failed once: they take the exact path from then
#: on (per process), so a repeated query shape never replays twice
_BLOCKLIST = set()
#: guards _BLOCKLIST writes from concurrent sessions (membership reads
#: stay lock-free: a stale read costs one extra speculative attempt)
_BLOCKLIST_LOCK = ordered_lock("speculation.blocklist")


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
