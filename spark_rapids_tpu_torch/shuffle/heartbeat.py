"""Driver-mediated peer discovery for the P2P shuffle (port of
``spark_rapids_tpu/shuffle/heartbeat.py``; spark-rapids'
``RapidsShuffleHeartbeatManager`` and its endpoint).

Executors register with the driver and heartbeat periodically; each reply
carries the peers registered since the executor's last call. Peers that
miss their heartbeats are evicted so that fetches stop targeting them, and
an evicted executor re-registers. The cluster runtime's executor ledger
(runtime/cluster.py) is the same manager."""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from spark_rapids_tpu_torch.errors import ColumnarProcessingError
from spark_rapids_tpu_torch.shuffle.transport import PeerInfo


class ShuffleHeartbeatManager:
    """Driver side: registration order is the peer log; each executor
    remembers the log index it has seen (RapidsShuffleHeartbeatManager)."""

    def __init__(self, heartbeat_timeout_s: float = 30.0):
        self._lock = threading.Lock()
        # append-only registration log; re-registration appends a new entry
        # and supersedes the old one (indices into the log are what each
        # executor's "seen" cursor points at, so entries never move)
        self._log: List[PeerInfo] = []
        self._current: Dict[str, PeerInfo] = {}
        self._seen_index: Dict[str, int] = {}
        self._last_beat: Dict[str, float] = {}
        self.heartbeat_timeout_s = heartbeat_timeout_s

    def register_executor(self, peer: PeerInfo) -> List[PeerInfo]:
        """New executor joins; returns every OTHER live peer known so far."""
        with self._lock:
            self._log.append(peer)
            self._current[peer.executor_id] = peer
            self._seen_index[peer.executor_id] = len(self._log)
            self._last_beat[peer.executor_id] = time.monotonic()
            return [p for ex, p in self._current.items()
                    if ex != peer.executor_id and self._alive_locked(ex)]

    def heartbeat(self, executor_id: str) -> List[PeerInfo]:
        """Returns peers registered since this executor's last call."""
        with self._lock:
            if executor_id not in self._seen_index:
                raise ColumnarProcessingError(
                    f"executor {executor_id} never registered")
            self._last_beat[executor_id] = time.monotonic()
            start = self._seen_index[executor_id]
            # deliver only entries that are still the executor's CURRENT
            # registration (a superseded entry's replacement appears later
            # in the log slice anyway)
            fresh = [p for p in self._log[start:]
                     if p.executor_id != executor_id
                     and self._current.get(p.executor_id) is p]
            self._seen_index[executor_id] = len(self._log)
            return fresh

    def _alive_locked(self, executor_id: str) -> bool:
        last = self._last_beat.get(executor_id)
        return last is not None and (
            time.monotonic() - last) < self.heartbeat_timeout_s

    def live_executors(self) -> List[str]:
        with self._lock:
            return [ex for ex in self._current if self._alive_locked(ex)]

    def evict_dead(self) -> List[str]:
        """Drop executors that missed the heartbeat window; returns their
        ids (the UCX path evicts dead peers the same way). The log keeps
        their entries (cursors point into it) but they stop being current,
        so they are never handed out again."""
        with self._lock:
            dead = [ex for ex in self._current
                    if not self._alive_locked(ex)]
            for ex in dead:
                self._current.pop(ex, None)
                self._seen_index.pop(ex, None)
                self._last_beat.pop(ex, None)
            return dead


class ShuffleHeartbeatEndpoint:
    """Executor side: registers, then heartbeats on a background thread,
    handing freshly discovered peers to ``on_new_peer`` (which typically
    pre-connects the transport).

    A beat rejected because the driver evicted us (a paused-then-resumed
    executor misses its heartbeat window) invokes ``on_evicted``; the
    default re-registers so the executor REJOINS the mesh instead of
    going permanently deaf with its heartbeat thread dead."""

    def __init__(self, manager: ShuffleHeartbeatManager, me: PeerInfo,
                 on_new_peer: Callable[[PeerInfo], None],
                 interval_s: float = 5.0,
                 on_evicted: Optional[Callable[[], None]] = None):
        self.manager = manager
        self.me = me
        self.on_new_peer = on_new_peer
        self.on_evicted = on_evicted if on_evicted is not None else self.rejoin
        self.interval_s = interval_s
        self.evicted_count = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        for peer in manager.register_executor(me):
            on_new_peer(peer)

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name=f"shuffle-heartbeat-{self.me.executor_id}",
            daemon=True)
        self._thread.start()

    def beat_once(self):
        for peer in self.manager.heartbeat(self.me.executor_id):
            self.on_new_peer(peer)

    def rejoin(self):
        """Default eviction response: re-register with the driver (the
        existing peers come back in the reply) and keep beating."""
        for peer in self.manager.register_executor(self.me):
            self.on_new_peer(peer)

    def beat_or_recover(self):
        """One heartbeat; a driver-forgot-us rejection triggers the
        eviction callback instead of being swallowed."""
        try:
            self.beat_once()
        except ColumnarProcessingError:
            self.evicted_count += 1
            self.on_evicted()

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            self.beat_or_recover()

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
