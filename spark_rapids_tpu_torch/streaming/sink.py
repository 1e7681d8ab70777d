"""Exactly-once Delta streaming sink (port of
``spark_rapids_tpu/streaming/sink.py``).

Every micro-batch append commits a ``SetTransaction(stream_id, batch_id)``
action ATOMICALLY with its data files (through the same optimistic
transaction protocol every Delta write uses). On replay — a batch whose
sink commit landed but whose stream died before the commit marker was
written — ``DeltaLog.last_txn_version`` already carries the batch id, so
the sink skips the append instead of duplicating rows. That watermark,
plus the OffsetLog's re-run-the-same-range rule, is the whole
exactly-once story: no distributed coordination, just one idempotence
check in front of one atomic commit.
"""

from __future__ import annotations

from typing import Optional

from spark_rapids_tpu_torch.runtime.faults import fault_point
from spark_rapids_tpu_torch.streaming.metrics import STREAM_METRICS

__all__ = ["DeltaStreamSink"]


class DeltaStreamSink:
    """Appends each micro-batch to a Delta table with txn dedupe."""

    kind = "delta"

    def __init__(self, table_path: str, stream_id: str):
        import os
        self.table_path = os.path.abspath(table_path)
        self.stream_id = stream_id

    def last_committed_batch(self) -> Optional[int]:
        from spark_rapids_tpu_torch.delta.log import DeltaLog
        log = DeltaLog(self.table_path)
        if not log.exists():
            return None
        return log.last_txn_version(self.stream_id)

    def commit_batch(self, session, batch_id: int, table) -> str:
        """Commit one micro-batch's result table. Returns ``"committed"``
        or ``"replayed"`` (watermark already past this batch)."""
        from spark_rapids_tpu_torch.delta.log import DeltaLog, SetTransaction
        from spark_rapids_tpu_torch.delta.table import write_delta
        from spark_rapids_tpu_torch.plan import nodes as P

        last = self.last_committed_batch()
        if last is not None and last >= batch_id:
            STREAM_METRICS.add("sinkReplays", 1)
            session.stage_stream_delta("sinkReplays")
            return "replayed"
        fault_point("stream.sink.commit", op=self.stream_id)
        mode = "append" if DeltaLog(self.table_path).exists() else "error"
        session.stage_stream_delta("sinkCommits")
        write_delta(P.LocalScan([table]), session, self.table_path,
                    mode=mode,
                    txn_action=SetTransaction(self.stream_id, batch_id))
        STREAM_METRICS.add("sinkCommits", 1)
        return "committed"

    def describe(self) -> dict:
        return {"kind": self.kind, "tablePath": self.table_path}
