"""Offline profiling tools over query event logs (port of
``spark_rapids_tpu/tools/``).

``python -m spark_rapids_tpu_torch.tools profile <eventlog>`` turns the
JSONL records the engine writes (``spark.rapids.sql.eventLog.enabled``,
obs/events.py) into a profiling report (top operators by self time, the
compute, transfer, shuffle and spill breakdown, span attribution);
``... compare A B`` diffs two runs per query and per operator, and
``... warmup --eventlog-dir DIR`` replays a log's distinct plans to build
the kernels and fill the executable cache before traffic arrives.

The report and the comparison are pure functions over the JSON records:
no session or device is touched. ``loadtest`` drives the corpus through
the query service (service/*), ``top`` polls its introspection endpoint
and ``incident`` renders the flight recorder's bundles; ``vacuum`` finds
and removes the orphans of a Delta table or a committed write
directory.
"""

from spark_rapids_tpu_torch.tools.compare import (  # noqa: F401
    build_compare,
    render_compare,
)
from spark_rapids_tpu_torch.tools.report import (  # noqa: F401
    build_profile,
    load_events,
    render_profile,
)


def require_cuda() -> str:
    """The ``--require-cuda`` gate (the reference's ``require_tpu_backend``):
    exit 2 with a machine-readable error when torch sees no CUDA device;
    returns the device's name."""
    import json
    import sys

    import torch
    if not torch.cuda.is_available():
        print(json.dumps({
            "error": "no CUDA device but --require-cuda was given",
            "backend": "cpu"}))
        sys.exit(2)
    return torch.cuda.get_device_name(0)
