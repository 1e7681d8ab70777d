"""The port's session: a thin front door that converts a plan into device
execs, drains them and downloads the result (the reference's TpuSession
without its recovery ladder, event log, executable cache and AQE, none
of which is ported yet)."""

from __future__ import annotations

from typing import Optional

from spark_rapids_tpu_torch import resolve_device
from spark_rapids_tpu_torch.columnar import HostTable
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.execs.base import single_batch
from spark_rapids_tpu_torch.plan import nodes as P


class TorchSession:
    """Runs plans on one torch device. ``device=None`` means the current
    CUDA device and raises when there is none; pass ``device="cpu"`` to
    run the kernels' plain torch versions on the CPU."""

    def __init__(self, conf: Optional[dict] = None, device=None):
        self.device = resolve_device(device)
        self.conf = RapidsConf(conf)

    def execute(self, plan: P.PlanNode) -> HostTable:
        from spark_rapids_tpu_torch.overrides.rules import convert
        root = convert(plan, self.conf, self.device)
        # a LocalScan holds at least one batch and every ported exec yields
        # one batch per input batch
        return single_batch(root.execute(), "a query result").to_host()
