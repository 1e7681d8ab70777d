"""Multi-tenant concurrent query service (port of
``spark_rapids_tpu/service``).

Reference: the serving layer the plugin assumes Spark provides:
concurrent tasks sharing one device through ``GpuSemaphore``
(``spark.rapids.sql.concurrentGpuTasks``), scheduler pools, and the
driver's kill and timeout plumbing. This engine owns its sessions, so it
owns the serving layer too:

* :mod:`spark_rapids_tpu_torch.service.scheduler`: ``QueryService``, a
  worker pool in front of one ``TorchSession`` on the card, with named
  scheduling pools, per-tenant weighted fair queueing, bounded queue
  depth with typed rejection (``QueryRejectedError`` and a retry-after),
  per-query deadlines, memory-aware admission over the memory arbiter's
  ledger, and the quarantine at admission. Knobs under
  ``spark.rapids.service.*``.
* :mod:`spark_rapids_tpu_torch.service.query`: ``QueryHandle``, the
  QUEUED -> ADMITTED -> RUNNING -> {FINISHED, FAILED, CANCELLED,
  TIMED_OUT} state machine, and the cooperative-cancellation exec
  boundary (the third per-query wrapper beside
  ``install_fault_boundaries`` and ``install_observation``).
* :mod:`spark_rapids_tpu_torch.service.result_cache`: the
  plan-fingerprint LRU result cache over ``HostTable`` results,
  invalidated by catalog mutations and writes.
* :mod:`spark_rapids_tpu_torch.service.watchdog`: ``WorkerWatchdog``,
  hard wall limits on RUNNING queries (a worker stalled inside one launch
  never reaches the cooperative deadline's batch boundary), abandoned
  workers replaced so pool capacity holds, and the dead-worker backstop.
  It can disown a thread, not end a kernel that hangs on the card.
* :mod:`spark_rapids_tpu_torch.service.introspect`: the loopback HTTP
  JSON endpoint ``tools top`` polls.

Pairs with :mod:`spark_rapids_tpu_torch.runtime.health` (device-loss
recovery, the CPU-only latch, the quarantine) and
:mod:`spark_rapids_tpu_torch.obs.telemetry` (the telemetry ring and the
flight recorder).
"""

from spark_rapids_tpu_torch.service.query import (  # noqa: F401
    QueryHandle,
    QueryState,
    install_cancellation,
)
from spark_rapids_tpu_torch.service.result_cache import (  # noqa: F401
    ResultCache,
)
from spark_rapids_tpu_torch.service.scheduler import (  # noqa: F401
    QueryService,
)
from spark_rapids_tpu_torch.service.watchdog import (  # noqa: F401
    WorkerWatchdog,
)
