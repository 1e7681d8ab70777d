"""Timezone transition tables (port of ``spark_rapids_tpu/ops/tzdb.py``:
the host tables are the reference's, copied; the device lookup is
``torch.searchsorted``).

Reference (SURVEY.md §2.9): ``GpuTimeZoneDB`` (spark-rapids-jni) loads the
Java timezone database's transition rules into device memory so that
from/to_utc_timestamp evaluate on the GPU for DST zones, not only fixed
offsets.

Transitions are derived from the system zoneinfo database by scanning
1850..2200 at day granularity and bisecting each offset change to the
exact second (zoneinfo does not expose raw transitions). Per zone, two
tables:

- UTC direction: (transition instant in UTC micros, offset micros) —
  ``from_utc`` looks up by UTC instant.
- WALL direction: (transition instant in local-wall micros, offset
  micros) — ``to_utc`` looks up by wall clock, resolving DST overlaps to
  the EARLIER offset and gaps to the post-transition offset (java.time
  ``ZonedDateTime.ofLocal`` semantics, which Spark uses).

A lookup is one ``searchsorted`` over a table and one gather; the tables
upload once per (zone, device).
"""

from __future__ import annotations

import datetime as _dt
import threading
from typing import Dict, Tuple

import numpy as np
import torch

_EPOCH = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
#: table coverage window. Instants outside it use the boundary offset —
#: a documented carve-out (the reference's GpuTimeZoneDB likewise builds
#: transitions to a max year). 1850..2200 covers Spark's practical range;
#: sub-day double transitions (not observed in tzdata) would be missed
#: by the day-granularity scan.
_SCAN_START = _dt.datetime(1850, 1, 1, tzinfo=_dt.timezone.utc)
_SCAN_END = _dt.datetime(2200, 1, 1, tzinfo=_dt.timezone.utc)
_US = _dt.timedelta(microseconds=1)


def _offset_micros_at(zone, utc_dt: _dt.datetime) -> int:
    off = utc_dt.astimezone(zone).utcoffset()
    return int(off / _US)


def _find_transitions(zone) -> Tuple[np.ndarray, np.ndarray]:
    """(utc transition instants in micros, offset micros AFTER each
    instant). Index 0 is a sentinel (-inf, initial offset)."""
    day = _dt.timedelta(days=1)
    instants = [-(1 << 62)]
    offsets = [_offset_micros_at(zone, _SCAN_START)]
    t = _SCAN_START
    prev_off = offsets[0]
    while t < _SCAN_END:
        nxt = t + day
        off = _offset_micros_at(zone, nxt)
        if off != prev_off:
            # bisect the change point to the second
            lo, hi = t, nxt
            while hi - lo > _dt.timedelta(seconds=1):
                mid = lo + (hi - lo) / 2
                mid = mid.replace(microsecond=0)
                if mid <= lo:
                    break
                if _offset_micros_at(zone, mid) == prev_off:
                    lo = mid
                else:
                    hi = mid
            instants.append(int((hi - _EPOCH) / _US))
            offsets.append(off)
            prev_off = off
        t = nxt
    return (np.asarray(instants, dtype=np.int64),
            np.asarray(offsets, dtype=np.int64))


class TimeZoneDB:
    """Process-wide cache of per-zone transition tables (GpuTimeZoneDB
    analog). ``tables(name)`` returns numpy."""

    _lock = threading.Lock()
    _cache: Dict[str, Tuple[np.ndarray, np.ndarray,
                            np.ndarray, np.ndarray]] = {}

    @classmethod
    def supported(cls, name: str) -> bool:
        try:
            cls.tables(name)
            return True
        except Exception:
            return False

    @classmethod
    def tables(cls, name: str):
        """(utc_instants, utc_offsets, wall_instants, wall_offsets)."""
        with cls._lock:
            hit = cls._cache.get(name)
        if hit is not None:
            return hit
        from zoneinfo import ZoneInfo
        zone = ZoneInfo(name)
        utc_instants, offsets = _find_transitions(zone)
        # wall-clock transition table for the to-UTC direction: each
        # transition happens at wall time (instant + NEW offset) for the
        # gap bound and (instant + OLD offset) for the overlap bound.
        # Using instant + max(old, new) as the boundary with the EARLIER
        # (pre-transition) offset below it implements java.time ofLocal:
        #  - overlap (offset decreases): wall times in the repeated hour
        #    are below instant+old -> earlier offset. ✓
        #  - gap (offset increases): non-existent wall times are below
        #    instant+new -> resolved with the OLD offset, mapping them
        #    forward past the gap. ✓ (ofLocal shifts by the gap length)
        wall_instants = [-(1 << 62)]
        wall_offsets = [offsets[0]]
        for i in range(1, len(utc_instants)):
            old, new = offsets[i - 1], offsets[i]
            wall_instants.append(utc_instants[i] + max(old, new))
            wall_offsets.append(new)
        out = (utc_instants, offsets,
               np.asarray(wall_instants, dtype=np.int64),
               np.asarray(wall_offsets, dtype=np.int64))
        with cls._lock:
            cls._cache[name] = out
        return out


def from_utc_micros_host(micros: np.ndarray, name: str) -> np.ndarray:
    ui, uo, _wi, _wo = TimeZoneDB.tables(name)
    idx = np.searchsorted(ui, micros, side="right") - 1
    return micros + uo[idx]


def to_utc_micros_host(micros: np.ndarray, name: str) -> np.ndarray:
    _ui, _uo, wi, wo = TimeZoneDB.tables(name)
    idx = np.searchsorted(wi, micros, side="right") - 1
    return micros - wo[idx]


_DEVICE_TABLES: Dict[Tuple[str, str], Tuple] = {}


def device_tables(name: str, device):
    """The zone's four tables as int64 tensors on ``device``, uploaded
    once."""
    key = (name, str(device))
    hit = _DEVICE_TABLES.get(key)
    if hit is None:
        hit = _DEVICE_TABLES[key] = tuple(
            torch.from_numpy(t).to(device) for t in TimeZoneDB.tables(name))
    return hit


def from_utc_micros_dev(micros: torch.Tensor, name: str) -> torch.Tensor:
    ui, uo, _wi, _wo = device_tables(name, micros.device)
    idx = torch.searchsorted(ui, micros, right=True) - 1
    return micros + uo[idx]


def to_utc_micros_dev(micros: torch.Tensor, name: str) -> torch.Tensor:
    _ui, _uo, wi, wo = device_tables(name, micros.device)
    idx = torch.searchsorted(wi, micros, right=True) - 1
    return micros - wo[idx]
