"""The ``streaming`` metric scope (event-log schema v11; port of
``spark_rapids_tpu/streaming/metrics.py``).

Six counters, snapshotted/diffed per query by the event log like every
other scope, plus surfaced as per-record top-level fields
(``microBatches`` … ``sinkReplays``) so the tools can attribute
streaming work to individual envelopes.
"""

from __future__ import annotations

from spark_rapids_tpu_torch.obs.metrics import metric_scope, register_metric

__all__ = ["STREAM_METRICS"]

register_metric("microBatches", "count", "ESSENTIAL",
                "micro-batches executed end-to-end (offsets logged, "
                "batch run, sink committed)")
register_metric("mvRefreshes", "count", "ESSENTIAL",
                "materialized-view refreshes of any strategy")
register_metric("mvIncrementalRefreshes", "count", "MODERATE",
                "MV refreshes served by delta recomputation "
                "(append or re-aggregate strategy)")
register_metric("mvFullRecomputes", "count", "MODERATE",
                "MV refreshes that fell back to a full recompute")
register_metric("sinkCommits", "count", "ESSENTIAL",
                "streaming sink transactional commits")
register_metric("sinkReplays", "count", "MODERATE",
                "replayed micro-batch sink commits skipped by the txn "
                "watermark (exactly-once dedupe)")

STREAM_METRICS = metric_scope("streaming")
