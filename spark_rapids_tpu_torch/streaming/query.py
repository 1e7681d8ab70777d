"""StreamingQuery: a micro-batch stream scheduled through the query
service as a recurring tenant (port of
``spark_rapids_tpu/streaming/query.py``).

Each trigger plans one micro-batch (offsets logged first — the
write-ahead half of exactly-once), submits the batch plan through
``QueryService.submit`` so it rides the normal session path (plan cache,
memory arbiter, retry framework, SLO accounting under the stream's
tenant/pool), commits the result through the transactional sink, then
writes the commit marker. A stream that dies at ANY point resumes from
its checkpoint: a pending batch re-runs over the same recorded offsets
and the sink's txn watermark swallows the duplicate if the data already
landed.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from spark_rapids_tpu_torch.conf import (
    STREAMING_POOL,
    STREAMING_TRIGGER_INTERVAL_MS,
)
from spark_rapids_tpu_torch.errors import ColumnarProcessingError
from spark_rapids_tpu_torch.runtime.faults import fault_point
from spark_rapids_tpu_torch.streaming.metrics import STREAM_METRICS
from spark_rapids_tpu_torch.streaming.offsets import OffsetLog
from spark_rapids_tpu_torch.streaming.sink import DeltaStreamSink
from spark_rapids_tpu_torch.streaming.source import StreamingSource
from spark_rapids_tpu_torch.lockorder import ordered_lock

__all__ = ["StreamingQuery"]


class StreamingQuery:
    """One named stream: source -> optional transform -> sink."""

    def __init__(self, service, source: StreamingSource,
                 sink: DeltaStreamSink, checkpoint_dir: str, *,
                 name: str,
                 transform: Optional[Callable] = None,
                 pool: Optional[str] = None,
                 tenant: Optional[str] = None,
                 trigger_interval_ms: Optional[int] = None):
        if not name:
            raise ColumnarProcessingError("stream needs a non-empty name")
        self.service = service
        self.source = source
        self.sink = sink
        self.transform = transform
        self.name = name
        self.tenant = tenant or name
        conf = service.session.conf
        pool = pool or conf.get_entry(STREAMING_POOL)
        # a stream outlives any one pool spec; fall back to the
        # service's first pool rather than failing every trigger
        self.pool = pool if pool in service.pools \
            else next(iter(service.pools))
        self.trigger_interval_s = (
            trigger_interval_ms if trigger_interval_ms is not None
            else conf.get_entry(STREAMING_TRIGGER_INTERVAL_MS)) / 1000.0
        self.offsets = OffsetLog(checkpoint_dir)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = ordered_lock("streaming.query")
        self._state = "INITIALIZED"
        self._error: Optional[BaseException] = None
        self._batches_run = 0
        self._rows_sunk = 0

    # -- one trigger ---------------------------------------------------------
    def run_one_batch(self) -> bool:
        """Plan/resume and execute one micro-batch. Returns False when the
        source has nothing new (no batch ran)."""
        session = self.service.session
        pending = self.offsets.pending_batch()
        if pending is not None:
            batch_id, off = pending
            start, end = off["start"], off["end"]
        else:
            start = self.offsets.last_end_offset()
            if start is None:
                start = self.source.initial_offset()
            end = self.source.latest_offset(start)
            if end == start:
                return False
            batch_id = self.offsets.latest_batch_id() + 1
            self.offsets.write_offsets(batch_id,
                                       {"start": start, "end": end})
        fault_point("stream.batch", op=self.name)
        plan = self.source.read_batch(session, start, end)
        if self.transform is not None:
            from spark_rapids_tpu_torch.plan.dataframe import DataFrame
            out = self.transform(DataFrame(plan, session))
            plan = out.plan if hasattr(out, "plan") else out
        handle = self.service.submit(plan, tenant=self.tenant,
                                     pool=self.pool,
                                     tag=f"stream:{self.name}:b{batch_id}")
        table = handle.result()
        session.stage_stream_delta("microBatches")
        outcome = self.sink.commit_batch(session, batch_id, table)
        self.offsets.write_commit(
            batch_id, {"outcome": outcome, "rows": table.num_rows})
        with self._lock:
            self._batches_run += 1
            if outcome == "committed":
                self._rows_sunk += table.num_rows
        STREAM_METRICS.add("microBatches", 1)
        return True

    def process_available(self, max_batches: int = 1000) -> int:
        """Synchronously drain everything the source has right now (plus
        any pending batch). Returns the number of batches run."""
        n = 0
        while n < max_batches and self.run_one_batch():
            n += 1
        return n

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "StreamingQuery":
        with self._lock:
            if self._thread is not None:
                raise ColumnarProcessingError(
                    f"stream {self.name!r} already started")
            self._state = "RUNNING"
            self._thread = threading.Thread(
                target=self._drive, name=f"stream-{self.name}", daemon=True)
        self.service.register_stream(self)
        self._thread.start()
        return self

    def _drive(self) -> None:
        while not self._stop.is_set():
            try:
                ran = self.run_one_batch()
            except Exception as e:  # noqa: BLE001 - fault surface
                with self._lock:
                    self._error = e
                    self._state = "FAILED"
                return
            if not ran:
                self._stop.wait(self.trigger_interval_s)
        with self._lock:
            if self._state == "RUNNING":
                self._state = "STOPPED"

    def stop(self, wait: bool = True) -> None:
        self._stop.set()
        t = self._thread
        if wait and t is not None and t is not threading.current_thread():
            t.join(timeout=60)
        self.service.unregister_stream(self.name)
        with self._lock:
            if self._state == "RUNNING":
                self._state = "STOPPED"

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def error(self) -> Optional[BaseException]:
        with self._lock:
            return self._error

    def describe(self) -> dict:
        with self._lock:
            state, batches, rows = (self._state, self._batches_run,
                                    self._rows_sunk)
        return {
            "name": self.name,
            "tenant": self.tenant,
            "pool": self.pool,
            "state": state,
            "batchesRun": batches,
            "rowsSunk": rows,
            "lastBatchId": self.offsets.latest_batch_id(),
            "lastCommittedId": self.offsets.latest_committed_id(),
            "source": self.source.describe(),
            "sink": self.sink.describe(),
        }
