"""The port's session: a thin front door that converts a plan into device
execs, drains them under speculative sizing and downloads the result (the
reference's TpuSession and the drain of its runtime/placement.py, without
the recovery ladder, event log, executable cache and AQE, none of which
is ported yet)."""

from __future__ import annotations

from typing import Dict, Optional

from spark_rapids_tpu_torch import resolve_device
from spark_rapids_tpu_torch.columnar import HostTable
from spark_rapids_tpu_torch.conf import SPECULATIVE_SIZING, RapidsConf
from spark_rapids_tpu_torch.execs.base import TpuExec, single_batch
from spark_rapids_tpu_torch.plan import nodes as P
from spark_rapids_tpu_torch.runtime import speculation as spec

#: attempts of one query under speculation; each failed attempt
#: blocklists its sites, so every replay makes strict progress
MAX_ATTEMPTS = 8


class TorchSession:
    """Runs plans on one torch device. ``device=None`` means the current
    CUDA device and raises when there is none; pass ``device="cpu"`` to
    run the kernels' plain torch versions on the CPU."""

    def __init__(self, conf: Optional[dict] = None, device=None):
        self.device = resolve_device(device)
        self.conf = RapidsConf(conf)
        self._last_root: Optional[TpuExec] = None
        self._last_replays = 0

    def execute(self, plan: P.PlanNode) -> HostTable:
        """Run ``plan``. Under speculative sizing (the default) every
        speculation flag of an attempt is read at once when it collects;
        a failed attempt blocklists its sites process-wide and the query
        replays, at most ``MAX_ATTEMPTS`` times, then once without
        speculation. The replay count is ``last_metrics()``'s
        ``speculationReplays``."""
        from spark_rapids_tpu_torch.overrides.rules import convert
        root = convert(plan, self.conf, self.device)
        self._last_root, self._last_replays = root, 0
        if self.conf.get_entry(SPECULATIVE_SIZING):
            for attempt in range(MAX_ATTEMPTS):
                _reset_metrics(root)
                tok = spec.activate()
                try:
                    table = _drain(root)
                    spec.current().validate_remaining()
                    self._last_replays = attempt
                    return table.to_host()
                except spec.SpeculationFailed as sf:
                    spec.blocklist(sf.sites)
                finally:
                    spec.deactivate(tok)
            self._last_replays = MAX_ATTEMPTS
        _reset_metrics(root)
        return _drain(root).to_host()

    def last_metrics(self) -> Dict[str, int]:
        """Metrics of the most recent execute(): the replay count and every
        exec's counters of the attempt that succeeded, summed by name
        (``directJoinBatches``, ``hashProbeBatches``, ...)."""
        out = {"speculationReplays": self._last_replays}
        stack = [self._last_root] if self._last_root is not None else []
        while stack:
            e = stack.pop()
            for k, v in e.metrics.items():
                out[k] = out.get(k, 0) + v
            stack.extend(e.children)
        return out


def _drain(root: TpuExec):
    # a LocalScan holds at least one batch and every ported exec yields
    # one batch per input batch
    return single_batch(root.execute(), "a query result")


def _reset_metrics(root: TpuExec) -> None:
    root.metrics.clear()
    for c in root.children:
        _reset_metrics(c)
