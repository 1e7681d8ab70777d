"""The port's session: a thin front door that converts a plan into device
execs, drains them under speculative sizing and downloads the result (the
reference's TpuSession and the drain of its runtime/placement.py, without
the recovery ladder, event log, executable cache and AQE, none of which
is ported yet), with its SQL entry points (``sql``, ``table``,
``catalog``)."""

from __future__ import annotations

from typing import Dict, Optional

from spark_rapids_tpu_torch import resolve_device
from spark_rapids_tpu_torch.columnar import HostTable
from spark_rapids_tpu_torch.conf import SPECULATIVE_SIZING, RapidsConf
from spark_rapids_tpu_torch.execs.base import TpuExec
from spark_rapids_tpu_torch.ops.misc import reset_nondeterministic_streams
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
        self._catalog = None

    # -- SQL front end -------------------------------------------------------
    @property
    def catalog(self):
        """The session's temp views."""
        if self._catalog is None:
            from spark_rapids_tpu_torch.sql.catalog import SessionCatalog
            self._catalog = SessionCatalog(self)
        return self._catalog

    def sql(self, text: str):
        """One SQL statement (SELECT, CREATE [OR REPLACE] TEMP VIEW, DROP
        VIEW) through the parser and the analyzer onto the plan layer: a
        DataFrame bound to this session, and so to its device, that runs
        through pruning, the overrides and the execs exactly as a
        DSL-built one does."""
        from spark_rapids_tpu_torch.sql import lower_statement
        return lower_statement(self, text)

    def table(self, name: str):
        """DataFrame over a temp view."""
        return self.catalog.table(name)

    def range(self, start: int, end: Optional[int] = None, step: int = 1):
        """spark.range: a LONG column ``id`` made on the device in batches
        of 2^20 rows."""
        from spark_rapids_tpu_torch.plan.dataframe import range_df
        return range_df(start, end, step, self)

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
                reset_nondeterministic_streams()
                tok = spec.activate()
                try:
                    table = _drain(root)
                    spec.current().validate_remaining()
                    self._last_replays = attempt
                    return table
                except spec.SpeculationFailed as sf:
                    spec.blocklist(sf.sites)
                finally:
                    spec.deactivate(tok)
            self._last_replays = MAX_ATTEMPTS
        _reset_metrics(root)
        reset_nondeterministic_streams()
        return _drain(root)

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


def _drain(root: TpuExec) -> HostTable:
    """The root's batches concatenated on the device and downloaded (an
    empty table of the root's schema when it yields none)."""
    from spark_rapids_tpu_torch.columnar.table import (
        concat_device,
        empty_host_table,
    )
    batches = list(root.execute())
    if not batches:
        return empty_host_table(root.output_schema())
    return concat_device(batches).to_host()


def _reset_metrics(root: TpuExec) -> None:
    root.metrics.clear()
    for c in root.children:
        _reset_metrics(c)
