"""Golden-suite plan verification (port of
``spark_rapids_tpu/lint/golden.py``): the corpus's TPC-H q1-q22
(``models/corpus.py``), in DSL and SQL form, with AQE on and off, tagged,
converted and verified — the lint CLI's plans phase.

This module only builds and converts the plans, never executes them, so
verification stays fast enough to run on every change. The plans are
converted for ``device``: the card by default, like every entry point of
the port; the CPU tests pass ``"cpu"``."""

from __future__ import annotations

from typing import Iterable, List, Tuple

from spark_rapids_tpu_torch.lint.diagnostics import Diagnostic


def golden_tables(scale_factor: float = 0.01, seed: int = 0):
    """The corpus tables the golden plans read (their sizes steer only
    the broadcast decisions)."""
    from spark_rapids_tpu_torch.models.corpus import corpus_tables
    return corpus_tables(scale_factor, seed)


def iter_golden_plans(scale_factor: float = 0.01, tables=None,
                      device=None) -> Iterable[Tuple[str, object, object]]:
    """Yield (query_id, logical_plan, conf) for every corpus query in
    both DSL and SQL form, with AQE on and off."""
    from spark_rapids_tpu_torch.models.corpus import (
        build_queries,
        build_sql_queries,
    )
    from spark_rapids_tpu_torch.session import TorchSession
    tables = tables if tables is not None else golden_tables(scale_factor)
    for mode, build in (("dsl", build_queries),
                        ("sql", build_sql_queries)):
        for aqe in (True, False):
            session = TorchSession({
                "spark.rapids.sql.adaptive.enabled": str(aqe).lower(),
            }, device=device)
            queries = build(session, tables)
            for name, fn in queries.items():
                qid = f"{name}[{mode},aqe={'on' if aqe else 'off'}]"
                yield qid, fn().plan, session.conf


def verify_golden_plans(scale_factor: float = 0.01, tables=None,
                        device=None) -> List[Diagnostic]:
    from spark_rapids_tpu_torch.lint.plan_verifier import verify_plan
    diags: List[Diagnostic] = []
    for qid, plan, conf in iter_golden_plans(scale_factor, tables, device):
        for d in verify_plan(plan, conf, device):
            diags.append(Diagnostic(d.rule_id, f"{qid}:{d.path}",
                                    d.message, d.severity))
    return diags
