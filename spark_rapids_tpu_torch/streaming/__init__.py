"""Streaming ingestion and incrementally maintained materialized views
(port of ``spark_rapids_tpu/streaming``).

Two halves over the query service:

* **Micro-batch streams** (query.StreamingQuery): a source (rate /
  file-watch / Delta CDF tail) drives micro-batches through
  ``QueryService.submit`` as a recurring tenant; offsets are
  write-ahead-logged (offsets.OffsetLog) and the sink commits through
  the Delta transaction protocol with a per-stream ``txn`` watermark
  (sink.DeltaStreamSink) — together: exactly-once across kills.
* **Materialized views** (mv.MaterializedViewRegistry): plans registered
  as views are kept current by delta recomputation off the table-scoped
  invalidation epochs, with a full-recompute fallback outside the
  incremental whitelist.

Observability: the ``streaming`` metric scope (metrics.py) feeds the six
per-record schema-v11 fields (microBatches … sinkReplays, mvEpoch).
"""

from spark_rapids_tpu_torch.streaming.metrics import STREAM_METRICS
from spark_rapids_tpu_torch.streaming.mv import (
    MaterializedView,
    MaterializedViewRegistry,
)
from spark_rapids_tpu_torch.streaming.offsets import OffsetLog
from spark_rapids_tpu_torch.streaming.query import StreamingQuery
from spark_rapids_tpu_torch.streaming.sink import DeltaStreamSink
from spark_rapids_tpu_torch.streaming.source import (
    DeltaCDFSource,
    FileWatchSource,
    RateSource,
    StreamingSource,
)

__all__ = [
    "DeltaCDFSource",
    "DeltaStreamSink",
    "FileWatchSource",
    "MaterializedView",
    "MaterializedViewRegistry",
    "OffsetLog",
    "RateSource",
    "STREAM_METRICS",
    "StreamingQuery",
    "StreamingSource",
]
