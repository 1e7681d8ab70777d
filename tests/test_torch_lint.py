"""The port's static-analysis layer (spark_rapids_tpu_torch/lint/) against
the reference's (spark_rapids_tpu/lint/), where both can see the same
thing.

Four layers, as the reference's tests/test_lint.py:
  * clean runs: the golden suite (the corpus's q1-q22, DSL + SQL, AQE
    on/off: 88 plans converted for the CPU) verifies clean, the port's
    tree lints clean, the registry audit is clean, and the port's
    committed documents (spark_rapids_tpu_torch/docs/) equal their
    generators byte for byte;
  * one NEGATIVE case per rule id of the port's RULES: a deliberately
    broken plan, registry entry or source fragment gives that id. Where a
    malformed plan can be built in both packages, it is, and the two
    verifiers must give the same set of rule ids;
  * the session's verifier modes (warn, error, a bad mode, no second
    verification of a cached tree) and the CLI's --json contract in a
    subprocess;
  * pins for the faults the audit and the lint found and this layer's
    repairs.

Comparator: the sets of rule ids (exact), each diagnostic's path and
message by substring.
"""

import ast
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.lint.plan_verifier import (
    verify_converted as j_verify_converted,
)
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import BucketPolicy, HostColumn, HostTable
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.lint.diagnostics import RULES
from spark_rapids_tpu_torch.lint.plan_verifier import (
    verify_converted,
    verify_meta,
)
from spark_rapids_tpu_torch.ops.expr import (
    BoundReference,
    Expression,
    Literal,
    col,
)
from spark_rapids_tpu_torch.plan import nodes as P
from spark_rapids_tpu_torch.session import TorchSession

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "spark_rapids_tpu_torch"
CPU = "cpu"


def _ids(diags):
    return {d.rule_id for d in diags}


def _find(diags, rule_id):
    hits = [d for d in diags if d.rule_id == rule_id]
    assert hits, f"no {rule_id} diagnostic in {[str(d) for d in diags]}"
    return hits


# -- malformed plans in both packages ---------------------------------------


def _scan(names=("a",), dtypes=(T.LONG,)):
    """A device scan of the port over a 3-row table of ``dtypes``."""
    from spark_rapids_tpu_torch.execs.basic import TpuScanExec
    cols = [HostColumn(dt, np.arange(3, dtype=np.int64).astype(dt.np_dtype))
            for dt in dtypes]
    return TpuScanExec([HostTable(list(names), cols)], CPU,
                       BucketPolicy(128))


def _jscan(names=("a",), dtypes=(JT.LONG,)):
    """The same scan in the reference."""
    from spark_rapids_tpu.execs.basic import TpuScanExec
    cols = [JHostColumn(dt, np.arange(3, dtype=np.int64).astype(dt.np_dtype))
            for dt in dtypes]
    return TpuScanExec([JHostTable(list(names), cols)])


def _jwrap(exec_):
    """The reference's converted root: a DeviceToHost over the device
    tree (the port's root is the device exec itself)."""
    from spark_rapids_tpu.execs.base import DeviceToHost
    return DeviceToHost(exec_)


def _both(port_root, ref_root):
    """Verify one malformed plan in each package: the port's diagnostics,
    held to the reference's rule ids."""
    got = verify_converted(port_root)
    want = j_verify_converted(ref_root)
    assert _ids(got) == _ids(want), ([str(d) for d in got],
                                     [str(d) for d in want])
    return got


# ---------------------------------------------------------------------------
# clean runs
# ---------------------------------------------------------------------------


def test_golden_suite_plans_verify_clean():
    """The corpus's 22 queries in DSL and SQL, AQE on and off, convert
    for the CPU with zero diagnostics: 88 plans."""
    from spark_rapids_tpu_torch.lint.golden import (
        golden_tables,
        iter_golden_plans,
        verify_golden_plans,
    )
    tables = golden_tables(0.002)
    ids = [qid for qid, _, _ in iter_golden_plans(tables=tables, device=CPU)]
    assert len(ids) == 88 and len(set(ids)) == 88
    assert {q.split("[")[0] for q in ids} == {f"q{i}" for i in range(1, 23)}
    diags = verify_golden_plans(tables=tables, device=CPU)
    assert diags == [], [str(d) for d in diags]


def test_repo_lints_clean():
    from spark_rapids_tpu_torch.lint.repo_lint import lint_repo
    diags = lint_repo()
    assert diags == [], [str(d) for d in diags]


def test_registry_audit_clean():
    from spark_rapids_tpu_torch.lint.registry_audit import audit_registry
    diags = audit_registry()
    assert diags == [], [str(d) for d in diags]


def test_committed_docs_are_byte_identical_to_generators():
    """The port's documents (never the root's, which are the
    reference's) equal their generators: regenerate with
    ``python -m spark_rapids_tpu_torch.lint --write-docs``."""
    from spark_rapids_tpu.lockorder import (
        generate_locks_md as j_generate_locks_md,
    )
    from spark_rapids_tpu_torch.conf import generate_docs
    from spark_rapids_tpu_torch.lockorder import generate_locks_md
    from spark_rapids_tpu_torch.overrides.docs import generate_supported_ops
    docs = os.path.join(ROOT, PKG, "docs")
    with open(os.path.join(docs, "SUPPORTED_OPS.md")) as f:
        assert f.read() == generate_supported_ops()
    with open(os.path.join(docs, "CONFIGS.md")) as f:
        assert f.read() == generate_docs()
    with open(os.path.join(docs, "LOCKS.md")) as f:
        assert f.read() == generate_locks_md()
    # the root's LOCKS.md stays the reference's own
    with open(os.path.join(ROOT, "LOCKS.md")) as f:
        assert f.read() == j_generate_locks_md()


def test_write_docs_writes_the_ports_documents_only(tmp_path):
    from spark_rapids_tpu_torch.lint.registry_audit import regenerate_docs
    written = regenerate_docs(str(tmp_path))
    assert sorted(os.path.relpath(p, tmp_path) for p in written) == [
        os.path.join(PKG, "docs", "CONFIGS.md"),
        os.path.join(PKG, "docs", "LOCKS.md"),
        os.path.join(PKG, "docs", "SUPPORTED_OPS.md")]
    assert sorted(os.listdir(tmp_path)) == [PKG]


def test_cli_lists_every_rule(capsys):
    from spark_rapids_tpu_torch.lint.__main__ import main
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == len(RULES) == 35
    assert [line.split()[0] for line in out] == sorted(RULES)


def test_rule_ids_are_the_references():
    """The lock-order contract is ported: the port's rule ids are the
    reference's, RL-LOCK-* and RA-DOC-DRIFT-LOCKS included."""
    from spark_rapids_tpu.lint.diagnostics import RULES as JRULES
    assert set(RULES) == set(JRULES)


# ---------------------------------------------------------------------------
# negative cases: plan verifier rules (built in both packages where both
# can hold the malformed plan)
# ---------------------------------------------------------------------------


def test_pv_schema_pass_through_divergence():
    from spark_rapids_tpu.execs.basic import TpuLimitExec as JLimit
    from spark_rapids_tpu_torch.execs.basic import TpuLimitExec
    ex = TpuLimitExec(_scan(), 5)
    ex.output_schema = lambda: [("other", T.INT)]  # break the contract
    jex = JLimit(_jscan(), 5)
    jex.output_schema = lambda: [("other", JT.INT)]
    diags = _find(_both(ex, _jwrap(jex)), "PV-SCHEMA")
    assert any("pass-through" in d.message and d.path == "Limit"
               for d in diags), [str(d) for d in diags]


def test_pv_schema_malformed_entry():
    from spark_rapids_tpu.execs.basic import TpuLimitExec as JLimit
    from spark_rapids_tpu_torch.execs.basic import TpuLimitExec
    ex = TpuLimitExec(_scan(), 5)
    ex.output_schema = lambda: [("a", "not-a-datatype")]
    jex = JLimit(_jscan(), 5)
    jex.output_schema = lambda: [("a", "not-a-datatype")]
    diags = _find(_both(ex, _jwrap(jex)), "PV-SCHEMA")
    assert any("malformed" in d.message for d in diags)


def test_pv_transition_device_exec_over_host_node():
    from spark_rapids_tpu.execs.basic import TpuLimitExec as JLimit
    from spark_rapids_tpu.plan import nodes as JP
    from spark_rapids_tpu_torch.execs.basic import TpuLimitExec
    ex = TpuLimitExec(P.RangeNode(0, 10), 5)  # host node under a device exec
    diags = _find(_both(ex, _jwrap(JLimit(JP.RangeNode(0, 10), 5))),
                  "PV-TRANSITION")
    assert "without a HostToDevice transition" in diags[0].message
    assert diags[0].path == "Limit"


def test_pv_transition_host_node_over_device_exec():
    from spark_rapids_tpu.ops.expr import Literal as JLiteral
    from spark_rapids_tpu.ops.expr import col as jcol
    from spark_rapids_tpu.plan import nodes as JP
    f = P.Filter(P.RangeNode(0, 10), col("id") > Literal(3))
    f.children = (_scan(("id",), (T.LONG,)),)  # device exec, no adapter
    jf = JP.Filter(JP.RangeNode(0, 10), jcol("id") > JLiteral(3))
    jf.children = (_jscan(("id",), (JT.LONG,)),)
    diags = _find(_both(f, jf), "PV-TRANSITION")
    assert "InputAdapter(DeviceToHost)" in diags[0].message
    assert diags[0].path == "Filter"  # reported at the consuming parent
    assert "Scan" in diags[0].message


def test_pv_transition_port_transitions():
    """The port's own transitions: an InputAdapter must source a
    DeviceToHost, a DeviceToHost wraps a device exec, and a CpuRootExec
    roots the plan (below the root its host plan needs a HostToDevice)."""
    from spark_rapids_tpu_torch.execs.base import (
        CpuRootExec,
        DeviceToHost,
        HostToDevice,
        InputAdapter,
    )
    from spark_rapids_tpu_torch.execs.basic import TpuLimitExec
    ia = InputAdapter(_scan(), [("a", T.LONG)])  # no DeviceToHost
    f = P.Filter(P.RangeNode(0, 10), col("id") > Literal(3))
    f.children = (ia,)
    diags = _find(verify_converted(CpuRootExec(f)), "PV-TRANSITION")
    assert any("InputAdapter sources Scan" in d.message for d in diags)
    d2h = DeviceToHost(P.RangeNode(0, 3))
    diags = _find(verify_converted(d2h), "PV-TRANSITION")
    assert "not a device exec" in diags[0].message
    # a device exec reads a host plan through HostToDevice: clean
    assert verify_converted(TpuLimitExec(
        HostToDevice(P.RangeNode(0, 3), CPU), 1)) == []
    nested = TpuLimitExec(CpuRootExec(P.RangeNode(0, 3)), 1)
    assert any("below the root" in d.message for d in _find(
        verify_converted(nested), "PV-TRANSITION"))
    # the well-formed route verifies clean
    ok = P.Filter(P.RangeNode(0, 10), col("id") > Literal(3))
    ok.children = (InputAdapter(DeviceToHost(_scan(("id",), (T.LONG,))),
                                [("id", T.LONG)]),)
    assert verify_converted(CpuRootExec(ok)) == []


def test_pv_exchange_hash_without_keys():
    from spark_rapids_tpu.conf import RapidsConf as JConf
    from spark_rapids_tpu.execs.exchange import (
        TpuShuffleExchangeExec as JExchange,
    )
    from spark_rapids_tpu_torch.execs.exchange import TpuShuffleExchangeExec
    ex = TpuShuffleExchangeExec(_scan(), "hash", 4, [], RapidsConf())
    jex = JExchange(_jscan(), "hash", 4, [], JConf())
    diags = _find(_both(ex, _jwrap(jex)), "PV-EXCHANGE")
    assert "hash partitioning requires keys" in diags[0].message
    assert "ShuffleExchange" in diags[0].path


def test_pv_exchange_key_outside_child_output():
    from spark_rapids_tpu.conf import RapidsConf as JConf
    from spark_rapids_tpu.execs.exchange import (
        TpuShuffleExchangeExec as JExchange,
    )
    from spark_rapids_tpu.ops.expr import BoundReference as JRef
    from spark_rapids_tpu_torch.execs.exchange import TpuShuffleExchangeExec
    ex = TpuShuffleExchangeExec(_scan(), "hash", 4,
                                [BoundReference(7, T.LONG)], RapidsConf())
    jex = JExchange(_jscan(), "hash", 4, [JRef(7, JT.LONG)], JConf())
    diags = _find(_both(ex, _jwrap(jex)), "PV-EXCHANGE")
    assert any("ordinal 7" in d.message for d in diags)


def test_pv_boundref_ordinal_and_type():
    from spark_rapids_tpu.execs.basic import TpuProjectExec as JProject
    from spark_rapids_tpu.ops.expr import BoundReference as JRef
    from spark_rapids_tpu_torch.execs.basic import TpuProjectExec
    ex = TpuProjectExec(_scan(), [BoundReference(3, T.LONG)], ["x"])
    jex = JProject(_jscan(), [JRef(3, JT.LONG)], ["x"])
    diags = _find(_both(ex, _jwrap(jex)), "PV-BOUNDREF")
    assert "ordinal 3" in diags[0].message and diags[0].path == "Project"
    ex2 = TpuProjectExec(_scan(), [BoundReference(0, T.STRING)], ["x"])
    jex2 = JProject(_jscan(), [JRef(0, JT.STRING)], ["x"])
    diags2 = _find(_both(ex2, _jwrap(jex2)), "PV-BOUNDREF")
    assert "typed string" in diags2[0].message


class _UnregisteredExpr(Expression):
    """No signature: an underscore name is never registered."""

    def __init__(self, child):
        self.children = (child,)

    @property
    def data_type(self):
        return T.LONG


def test_pv_typesig_unregistered_expression_on_device():
    from spark_rapids_tpu_torch.execs.basic import TpuProjectExec
    ex = TpuProjectExec(_scan(), [_UnregisteredExpr(
        BoundReference(0, T.LONG))], ["x"])
    diags = _find(verify_converted(ex), "PV-TYPESIG")
    assert "_UnregisteredExpr" in diags[0].message
    assert "ran on device anyway" in diags[0].message


def test_pv_decimal_result_type_divergence():
    from spark_rapids_tpu.execs.basic import TpuProjectExec as JProject
    from spark_rapids_tpu.ops.decimal import DecimalAdd as JDecimalAdd
    from spark_rapids_tpu.ops.expr import BoundReference as JRef
    from spark_rapids_tpu_torch.execs.basic import TpuProjectExec
    from spark_rapids_tpu_torch.ops.decimal import DecimalAdd

    class _TamperedAdd(DecimalAdd):
        # the port derives its result type from its operands on every
        # read: a subclass stands in for the reference's tampered field
        data_type = property(lambda self: T.DecimalType(7, 1))

    d10 = T.DecimalType(10, 2)
    e = _TamperedAdd(BoundReference(0, d10), BoundReference(1, d10))
    ex = TpuProjectExec(_scan(("a", "b"), (d10, d10)), [e], ["x"])
    jd10 = JT.DecimalType(10, 2)
    je = JDecimalAdd(JRef(0, jd10), JRef(1, jd10))
    je._result = JT.DecimalType(7, 1)  # violates the promotion rule
    jex = JProject(_jscan(("a", "b"), (jd10, jd10)), [je], ["x"])
    diags = _find(_both(ex, _jwrap(jex)), "PV-DECIMAL")
    assert "promotion rule gives decimal(11,2)" in diags[0].message


class _BadNotNull(Expression):
    nullable = False  # plain class attr shadowing the derived property

    def __init__(self, child):
        self.children = (child,)

    @property
    def data_type(self):
        return T.LONG


def test_pv_nullable_plain_attr_over_nullable_child():
    from spark_rapids_tpu_torch.execs.basic import TpuProjectExec
    from spark_rapids_tpu_torch.ops.expr import Alias
    ex = TpuProjectExec(_scan(), [_BadNotNull(BoundReference(0, T.LONG))],
                        ["x"])
    diags = _find(verify_converted(ex), "PV-NULLABLE")
    assert "_BadNotNull" in diags[0].message
    assert "without overriding the nullable property" in diags[0].message
    # the derived contract: leaves nullable, an alias its child's, a
    # literal by its value
    assert BoundReference(0, T.LONG).nullable
    assert Alias(Literal(3), "x").nullable is False
    assert Literal(None, T.LONG).nullable


def test_pv_fallback_empty_reason_and_missing_rule():
    from spark_rapids_tpu_torch.overrides.rules import PlanMeta
    meta = PlanMeta(P.RangeNode(0, 5), RapidsConf())
    meta.reasons = ["   "]
    diags = []
    verify_meta(meta, diags)
    assert any(d.rule_id == "PV-FALLBACK"
               and "empty reason" in d.message for d in diags)

    class _RuleLess(P.PlanNode):
        def output_schema(self):
            return [("x", T.LONG)]

    meta2 = PlanMeta(_RuleLess(), RapidsConf())  # untagged: no reasons
    diags2 = []
    verify_meta(meta2, diags2)
    assert any(d.rule_id == "PV-FALLBACK"
               and "no exec rule" in d.message for d in diags2)


def test_pv_agg_non_aggregate_spec():
    from spark_rapids_tpu.execs.aggregate import (
        TpuHashAggregateExec as JAgg,
    )
    from spark_rapids_tpu.ops.expr import BoundReference as JRef
    from spark_rapids_tpu.ops.expr import Literal as JLiteral
    from spark_rapids_tpu_torch.execs.aggregate import TpuHashAggregateExec
    from spark_rapids_tpu_torch.ops.aggregates import Count
    ex = TpuHashAggregateExec(_scan(), [BoundReference(0, T.LONG)],
                              [("n", Count(BoundReference(0, T.LONG)))],
                              ["k"])
    # the port's constructor checks its specs: break it afterwards
    ex.agg_specs = [("bad", Literal(1))]
    jex = JAgg(_jscan(), [JRef(0, JT.LONG)], [("bad", JLiteral(1))], ["k"])
    diags = _find(_both(ex, _jwrap(jex)), "PV-AGG")
    assert "not an AggregateFunction" in diags[0].message
    assert "HashAggregate" in diags[0].path


def test_pv_agg_cpu_route_aggregate_in_a_device_exec():
    """An aggregate the tag sends to the CPU route (a collect of strings)
    sitting in a device exec."""
    from spark_rapids_tpu_torch.execs.aggregate import TpuHashAggregateExec
    from spark_rapids_tpu_torch.ops.aggregates import CollectList, Count
    ex = TpuHashAggregateExec(_scan(), [BoundReference(0, T.LONG)],
                              [("n", Count(BoundReference(0, T.LONG)))],
                              ["k"])
    ex.agg_specs = [("c", CollectList(BoundReference(0, T.STRING)))]
    diags = _find(verify_converted(ex), "PV-AGG")
    assert any("belongs on the CPU route" in d.message for d in diags)


def test_pv_join_key_type_divergence():
    from spark_rapids_tpu.execs.join import TpuJoinExec as JJoin
    from spark_rapids_tpu.ops.expr import BoundReference as JRef
    from spark_rapids_tpu_torch.execs.join import TpuJoinExec
    ex = TpuJoinExec(_scan(("a",), (T.LONG,)), _scan(("b",), (T.INT,)),
                     "inner", [BoundReference(0, T.LONG)],
                     [BoundReference(0, T.INT)], None, [("a", T.LONG)],
                     [("b", T.INT)])
    jex = JJoin(_jscan(("a",), (JT.LONG,)), _jscan(("b",), (JT.INT,)),
                "inner", [JRef(0, JT.LONG)], [JRef(0, JT.INT)], None,
                [("a", JT.LONG)], [("b", JT.INT)])
    diags = _find(_both(ex, _jwrap(jex)), "PV-JOIN")
    assert "types diverge: bigint vs int" in diags[0].message

    ex2 = TpuJoinExec(_scan(("a",), (T.LONG,)), _scan(("b",), (T.LONG,)),
                      "sideways", [BoundReference(0, T.LONG)],
                      [BoundReference(0, T.LONG)], None, [("a", T.LONG)],
                      [("b", T.LONG)])
    jex2 = JJoin(_jscan(("a",), (JT.LONG,)), _jscan(("b",), (JT.LONG,)),
                 "sideways", [JRef(0, JT.LONG)], [JRef(0, JT.LONG)], None,
                 [("a", JT.LONG)], [("b", JT.LONG)])
    diags2 = _find(_both(ex2, _jwrap(jex2)), "PV-JOIN")
    assert "unsupported join type" in diags2[0].message


def test_verifier_makes_no_device_call(monkeypatch):
    """verify_converted reads structure only: over a converted corpus plan
    it never reads a tensor back (no .cpu(), .item(), .tolist())."""
    import torch

    from spark_rapids_tpu_torch.lint.golden import (
        golden_tables,
        iter_golden_plans,
    )
    from spark_rapids_tpu_torch.lint.plan_verifier import convert_plan
    trees = [convert_plan(plan, conf, torch.device(CPU))
             for _, plan, conf in list(iter_golden_plans(
                 tables=golden_tables(0.002), device=CPU))[:22]]

    def forbidden(*a, **k):
        raise AssertionError("the verifier read a tensor")

    for name in ("cpu", "item", "tolist", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, forbidden)
    for root, meta in trees:
        assert verify_converted(root, meta) == []


# ---------------------------------------------------------------------------
# negative cases: registry auditor rules
# ---------------------------------------------------------------------------


def test_ra_conf_orphan_unread_key():
    from spark_rapids_tpu_torch import conf as C
    from spark_rapids_tpu_torch.lint.registry_audit import (
        _audit_conf_referenced,
        _repo_root,
    )
    key = "spark.rapids.sql.test.orphanedProbeKey"
    C._conf(key, "", "negative-test probe: intentionally unread", str)
    try:
        diags = []
        _audit_conf_referenced(diags, _repo_root(None))
        hits = _find(diags, "RA-CONF-ORPHAN")
        assert [d.path for d in hits] == [key]
    finally:
        C._REGISTRY.pop(key, None)


def test_ra_unregistered_device_expression():
    import spark_rapids_tpu_torch.ops.math as math_mod
    from spark_rapids_tpu_torch.lint.registry_audit import _audit_unregistered
    from spark_rapids_tpu_torch.overrides import rules as R
    R._build_expr_sigs()  # built: a class defined after it is not in it

    class FakeDevExpr(Expression):
        def eval_dev(self, ctx, child_vals, prep):  # a device form
            raise AssertionError

    FakeDevExpr.__module__ = "spark_rapids_tpu_torch.ops.math"
    math_mod.FakeDevExpr = FakeDevExpr
    try:
        diags = []
        _audit_unregistered(diags)
        hits = _find(diags, "RA-UNREGISTERED")
        assert [d.path for d in hits] == [
            "spark_rapids_tpu_torch.ops.math.FakeDevExpr"]
    finally:
        del math_mod.FakeDevExpr
        del FakeDevExpr
        gc.collect()


def test_ra_param_arity_overflow():
    from spark_rapids_tpu_torch.lint.registry_audit import _audit_param_arity
    from spark_rapids_tpu_torch.overrides import rules as R
    from spark_rapids_tpu_torch.overrides.typesig import ExprChecks, TypeSig

    class OneArg(Expression):
        def __init__(self, child):
            self.children = (child,)

    R._build_expr_sigs()
    sig = TypeSig(T.LongType)
    R._EXPR_CHECKS[OneArg] = ExprChecks((sig, sig, sig))
    try:
        diags = []
        _audit_param_arity(diags)
        hits = _find(diags, "RA-PARAM-ARITY")
        assert any("OneArg" in d.path and "3 parameter" in d.message
                   for d in hits)
    finally:
        del R._EXPR_CHECKS[OneArg]


def test_ra_kill_switch_orphan():
    from spark_rapids_tpu_torch import conf as C
    from spark_rapids_tpu_torch.lint.registry_audit import (
        _audit_kill_switches,
    )
    key = "spark.rapids.sql.exec.NoSuchExecRule"
    C._conf(key, True, "orphan", C._to_bool)
    try:
        diags = []
        _audit_kill_switches(diags)
        assert [d.path for d in _find(diags, "RA-KILL-SWITCH")] == [key]
    finally:
        C._REGISTRY.pop(key, None)


def test_kill_switches_that_switch_nothing_are_refused():
    """The audit's catch, repaired: the conf used to accept a switch for
    every plan node and expression class, bases included (PlanNode,
    FileScanNode, WriteFiles, Expression), though the tag consults none
    of them; those keys now raise as unknown."""
    for key in ("spark.rapids.sql.exec.WriteFiles",
                "spark.rapids.sql.exec.PlanNode",
                "spark.rapids.sql.exec.FileScanNode",
                "spark.rapids.sql.expression.Expression"):
        with pytest.raises(NotImplementedError, match="conf keys"):
            RapidsConf({key: "false"})
    conf = RapidsConf({"spark.rapids.sql.exec.Filter": "false",
                       "spark.rapids.sql.exec.ParquetScanNode": "false",
                       "spark.rapids.sql.expression.Upper": "false"})
    assert not conf.is_op_enabled("exec", "Filter")
    assert not conf.is_op_enabled("expression", "Upper")


def test_ra_sql_exposure_missing_aggregate(monkeypatch):
    from spark_rapids_tpu_torch.lint import registry_audit as RA
    names = dict(RA._AGG_SQL_NAMES)
    del names["Sum"]
    monkeypatch.setattr(RA, "_AGG_SQL_NAMES", names)
    diags = []
    RA._audit_sql_exposure(diags)
    assert [d.path for d in _find(diags, "RA-SQL-EXPOSURE")] == [
        "sql.registry.Sum"]


def test_ra_essential_metrics_missing():
    from spark_rapids_tpu_torch.execs.base import TpuExec
    from spark_rapids_tpu_torch.lint.registry_audit import (
        audit_exec_metrics_tree,
    )

    class HalfMetered(TpuExec):
        pass

    e = HalfMetered()
    e.metrics["opTime"] = 0.1  # ran, but never counted its output
    diags = []
    audit_exec_metrics_tree(e, diags)
    hits = _find(diags, "RA-ESSENTIAL-METRICS")
    assert any("HalfMetered" in d.path and "numOutputRows" in d.message
               for d in hits)
    # a metric-less ROOT means the observation boundary never installed
    diags2 = []
    audit_exec_metrics_tree(HalfMetered(), diags2)
    assert any("never installed" in d.message
               for d in _find(diags2, "RA-ESSENTIAL-METRICS"))


def test_ra_essential_metrics_over_an_executed_slice():
    """The executed half on the CPU: q1 and q7 of the corpus run through
    the observation boundaries and carry every ESSENTIAL metric."""
    from spark_rapids_tpu_torch.lint.registry_audit import audit_exec_metrics
    assert audit_exec_metrics(0.002, ("q1", "q7"), device=CPU) == []


def test_ra_doc_drift(tmp_path):
    from spark_rapids_tpu_torch.lint.registry_audit import _audit_doc_drift
    docs = tmp_path / PKG / "docs"
    docs.mkdir(parents=True)
    (docs / "SUPPORTED_OPS.md").write_text("stale\n")
    # CONFIGS.md missing entirely
    diags = []
    _audit_doc_drift(diags, str(tmp_path))
    assert any(d.rule_id == "RA-DOC-DRIFT-OPS"
               and d.path == f"{PKG}/docs/SUPPORTED_OPS.md:1"
               and "differs from the generator" in d.message for d in diags)
    assert any(d.rule_id == "RA-DOC-DRIFT-CONFIGS"
               and "missing" in d.message for d in diags)
    # LOCKS.md missing, then stale in its first table row
    assert any(d.rule_id == "RA-DOC-DRIFT-LOCKS"
               and d.path == f"{PKG}/docs/LOCKS.md"
               and "missing" in d.message for d in diags)
    from spark_rapids_tpu_torch.lockorder import generate_locks_md
    lines = generate_locks_md().splitlines(keepends=True)
    row = next(i for i, line in enumerate(lines) if line.startswith("| 100 "))
    lines[row] = lines[row].replace("| 100 ", "| 101 ")
    (docs / "LOCKS.md").write_text("".join(lines))
    diags = []
    _audit_doc_drift(diags, str(tmp_path))
    assert any(d.rule_id == "RA-DOC-DRIFT-LOCKS"
               and d.path == f"{PKG}/docs/LOCKS.md:{row + 1}"
               for d in diags), [str(d) for d in diags]


# ---------------------------------------------------------------------------
# negative cases: repo lint rules (synthetic sources)
# ---------------------------------------------------------------------------


def _run_rl(check, rel, src, *extra):
    diags = []
    check(rel, ast.parse(src), *extra, diags)
    return diags


def _lines(diags):
    return sorted(int(d.path.rsplit(":", 1)[1]) for d in diags)


def test_rl_host_sync_torch_receivers_flagged_numpy_not():
    from spark_rapids_tpu_torch.lint.repo_lint import _check_host_sync
    src = (
        "import numpy as np\n"
        "import torch\n"
        "a = torch.arange(4).sum().item()\n"       # 3: torch receiver
        "b = np.arange(4).sum().item()\n"          # numpy: clean
        "c = x.cpu()\n"                            # 5: .cpu()
        "d = int(torch.count_nonzero(m))\n"        # 6: int over torch
        "e = torch.stack(v).tolist()\n"            # 7: torch receiver
        "f = arr.tolist()\n"                       # unprovable: clean
        "g = float(np.sum(arr))\n"                 # numpy: clean
        "torch.cuda.synchronize()\n"               # 10
        "ev.synchronize()\n"                       # 11: event/stream
        "from torch.cuda import synchronize\n"     # 12: import form
        "synchronize()\n"                          # 13: bare call
        "n = int(host_fetch([torch.sum(x)])[0])\n"  # sanctioned: clean
        "h = torch.from_numpy(a).numpy()\n"        # 15: torch receiver
    )
    hits = _find(_run_rl(_check_host_sync, f"{PKG}/execs/foo.py", src),
                 "RL-HOST-SYNC")
    assert _lines(hits) == [3, 5, 6, 7, 10, 11, 12, 13, 15], \
        [str(d) for d in hits]
    # ops/ is a hot path too; io/ is not
    assert _lines(_run_rl(_check_host_sync, f"{PKG}/ops/foo.py", src)) == \
        [3, 5, 6, 7, 10, 11, 12, 13, 15]
    assert _run_rl(_check_host_sync, f"{PKG}/io/foo.py", src) == []


def test_rl_host_sync_allowlist_keys_on_qualified_function():
    from spark_rapids_tpu_torch.lint import repo_lint as RL
    src = ("class Run:\n"
           "    def steps(self, x):\n"
           "        return x.cpu()\n"
           "def steps(x):\n"
           "    return x.cpu()\n")
    rel = f"{PKG}/execs/foo.py"
    RL._HOST_SYNC_ALLOWLIST[f"{rel}:Run.steps"] = "negative-test probe"
    try:
        hits = _find(_run_rl(RL._check_host_sync, rel, src), "RL-HOST-SYNC")
        assert _lines(hits) == [5]
    finally:
        del RL._HOST_SYNC_ALLOWLIST[f"{rel}:Run.steps"]
    # every allowlist entry names a function of the real tree and a reason
    for allow in (RL._HOST_SYNC_ALLOWLIST, RL._KERNEL_HOST_ALLOWLIST,
                  RL._MESH_HOST_ALLOWLIST, RL._MEM_ACCOUNT_ALLOWLIST):
        for key, why in allow.items():
            path, func = key.split(":")
            assert os.path.exists(os.path.join(ROOT, path)), key
            src = open(os.path.join(ROOT, path)).read()
            assert f"def {func.split('.')[-1]}(" in src, key
            assert len(why) > 40, key


def test_rl_jnp_scope():
    from spark_rapids_tpu_torch.lint.repo_lint import _check_jnp_scope
    src = "import torch\n"
    hits = _find(_run_rl(_check_jnp_scope, f"{PKG}/sql/analyzer.py", src),
                 "RL-JNP-SCOPE")
    assert "outside the device layers" in hits[0].message
    assert _find(_run_rl(_check_jnp_scope, f"{PKG}/plan/foo.py",
                         "from torch import nn\n"), "RL-JNP-SCOPE")
    assert _find(_run_rl(_check_jnp_scope, f"{PKG}/lint/foo.py",
                         "import torch.cuda\n"), "RL-JNP-SCOPE")
    for ok in (f"{PKG}/execs/basic.py", f"{PKG}/types.py",
               f"{PKG}/service/scheduler.py", "chip_smoke.py"):
        assert _run_rl(_check_jnp_scope, ok, src) == [], ok
    # a device directory's name is not a device file at the top level
    assert _find(_run_rl(_check_jnp_scope, f"{PKG}/service/query.py", src),
                 "RL-JNP-SCOPE")


def test_rl_conf_key():
    from spark_rapids_tpu_torch.lint.repo_lint import _check_conf_keys
    declared = {"spark.rapids.sql.enabled"}
    src = 'k = conf.get("spark.rapids.sql.noSuchKey")\n'
    hits = _find(_run_rl(_check_conf_keys, f"{PKG}/session.py", src,
                         declared), "RL-CONF-KEY")
    assert "spark.rapids.sql.noSuchKey" in hits[0].message
    ok = ('k = conf.get("spark.rapids.sql.enabled")\n'
          'f = {"spark.rapids.sql.exec.Filter": "false"}\n')
    assert _run_rl(_check_conf_keys, f"{PKG}/session.py", ok, declared) == []


def test_rl_nondeterminism():
    from spark_rapids_tpu_torch.lint.repo_lint import _check_nondeterminism
    src = ("import time\nt = time.time()\n"
           "import numpy as np\nr = np.random.rand(3)\n"
           "g = np.random.default_rng(0)\n"
           "import torch\nu = torch.rand(3)\n"
           "gen = torch.Generator()\nv = torch.rand(3, generator=gen)\n"
           "torch.manual_seed(1)\n")
    hits = _find(_run_rl(_check_nondeterminism, f"{PKG}/ops/foo.py", src),
                 "RL-NONDETERMINISM")
    # time.time, np.random.rand, torch.rand without a generator and the
    # global seed; default_rng and a torch.Generator are fine
    assert _lines(hits) == [2, 4, 7, 10]
    assert _run_rl(_check_nondeterminism, f"{PKG}/io/foo.py", src) == []


def test_rl_dead_lambda():
    from spark_rapids_tpu_torch.lint.repo_lint import _check_dead_lambdas
    src = "pn = lambda x: x\nused = lambda y: y\nprint(used(1))\n"
    hits = _find(_run_rl(_check_dead_lambdas, f"{PKG}/delta/foo.py", src),
                 "RL-DEAD-LAMBDA")
    assert len(hits) == 1 and "'pn'" in hits[0].message
    assert hits[0].path.endswith(":1")


def test_rl_thread_shared():
    from spark_rapids_tpu_torch.lint import repo_lint as RL
    src = (
        "from spark_rapids_tpu_torch.lockorder import ordered_lock\n"
        "_CACHE = {}\n"
        "_ITEMS = []\n"
        "_LOCK = ordered_lock('t.lock')\n"
        "class Mgr:\n"
        "    _instance = None\n"
        "    @classmethod\n"
        "    def get(cls):\n"
        "        cls._instance = Mgr()\n"         # unlocked class attr
        "        return cls._instance\n"
        "def bad(k, v):\n"
        "    _CACHE[k] = v\n"                     # unlocked subscript
        "    _ITEMS.append(v)\n"                  # unlocked mutator
        "def good(k, v):\n"
        "    with _LOCK:\n"
        "        _CACHE[k] = v\n"                 # guarded: clean
        "        _ITEMS.append(v)\n"
        "def rebind():\n"
        "    global _CACHE\n"
        "    _CACHE = {}\n"                       # unlocked global rebind
    )
    rel = f"{PKG}/runtime/foo.py"
    hits = _find(_run_rl(RL._check_thread_shared, rel, src),
                 "RL-THREAD-SHARED")
    assert _lines(hits) == [9, 12, 13, 20], [str(d) for d in hits]
    for d in (f"{PKG}/shuffle/", f"{PKG}/service/", f"{PKG}/streaming/"):
        assert len(_run_rl(RL._check_thread_shared, d + "foo.py", src)) == 4
    assert _run_rl(RL._check_thread_shared, f"{PKG}/ops/foo.py", src) == []
    assert _run_rl(RL._check_thread_shared, f"{PKG}/shuffle/foo.py",
                   "_REG = {}\n_REG['x'] = 1\n") == []
    saved = dict(RL._THREAD_SHARED_ALLOWLIST)
    try:
        RL._THREAD_SHARED_ALLOWLIST.update({f"{rel}:_CACHE": "test",
                                            f"{rel}:_instance": "test"})
        left = _find(_run_rl(RL._check_thread_shared, rel, src),
                     "RL-THREAD-SHARED")
        assert len(left) == 1 and "_ITEMS.append" in left[0].message
    finally:
        RL._THREAD_SHARED_ALLOWLIST.clear()
        RL._THREAD_SHARED_ALLOWLIST.update(saved)


def test_nvtx_decision_is_guarded():
    """The lint's catch in runtime/profiler.py, repaired: the process-wide
    NVTX decision is appended under a factory-built lock, once."""
    from spark_rapids_tpu_torch.lint.repo_lint import _check_thread_shared
    from spark_rapids_tpu_torch.runtime import profiler
    rel = f"{PKG}/runtime/profiler.py"
    with open(os.path.join(ROOT, rel)) as f:
        assert _run_rl(_check_thread_shared, rel, f.read()) == []
    assert profiler._nvtx_enabled() == profiler._nvtx_enabled()
    assert len(profiler._NVTX) == 1


def test_rl_write_commit():
    from spark_rapids_tpu_torch.lint.repo_lint import _check_write_commit
    src = (
        "import os\n"
        "from spark_rapids_tpu_torch.io import parquet_format as PF\n"
        "def write_stuff(t, path):\n"
        "    PF.write_table(t, path)\n"            # 4: outside _write_one
        "    with open(path, 'w') as f:\n"         # 5: write-mode open
        "        f.write('x')\n"
        "    os.replace(path + '.tmp', path)\n"    # 7: promotion
        "def _write_one(tbl, file_path):\n"
        "    PF.write_table(tbl, file_path)\n"     # sanctioned callback
        "    with open(file_path, 'w') as f:\n"
        "        f.write('x')\n"
        "def read_stuff(path):\n"
        "    with open(path) as f:\n"              # default 'r': clean
        "        return f.read()\n"
    )
    hits = _find(_run_rl(_check_write_commit, f"{PKG}/io/foo.py", src),
                 "RL-WRITE-COMMIT")
    assert _lines(hits) == [4, 5, 7]
    assert "committer" in " ".join(d.message for d in hits)
    for exempt in ("committer.py", "filecache.py", "parquet_format.py",
                   "orc_format.py", "parquet_records.py"):
        assert _run_rl(_check_write_commit, f"{PKG}/io/{exempt}", src) == []
    assert _run_rl(_check_write_commit, f"{PKG}/delta/foo.py", src) == []


def test_rl_mesh_host():
    from spark_rapids_tpu_torch.lint.repo_lint import _check_mesh_host
    src = (
        "import numpy as np\n"
        "import torch\n"
        "from spark_rapids_tpu_torch.dispatch import host_fetch\n"
        "def bad(x):\n"
        "    a = np.asarray(x)\n"            # 5: host materialization
        "    b = x.cpu()\n"                  # 6: download
        "    c = host_fetch(x)\n"            # 7: not the gather point
        "    torch.cuda.synchronize()\n"     # 8: device sync
        "    return int(torch.sum(x))\n"     # 9: a read-back
        "def mesh_gather(x):\n"
        "    return x.cpu().numpy()\n"       # 11: foo.py's own gather
    )
    hits = _find(_run_rl(_check_mesh_host, f"{PKG}/parallel/foo.py", src),
                 "RL-MESH-HOST")
    assert _lines(hits) == [5, 6, 7, 8, 9, 11], [str(d) for d in hits]
    # the re-land is covered; mesh.py's mesh_gather is THE gather point,
    # a method merely named so is not
    assert _find(_run_rl(_check_mesh_host, f"{PKG}/execs/mesh.py", src),
                 "RL-MESH-HOST")
    gather = "def mesh_gather(x):\n    return x.cpu().numpy()\n"
    assert _run_rl(_check_mesh_host, f"{PKG}/parallel/mesh.py", gather) == []
    nested = "class Foo:\n" + "".join("    " + line + "\n"
                                      for line in gather.splitlines())
    assert len(_run_rl(_check_mesh_host, f"{PKG}/parallel/mesh.py",
                       nested)) == 1
    assert _run_rl(_check_mesh_host, f"{PKG}/execs/foo.py", src) == []


def test_rl_kernel_host():
    from spark_rapids_tpu_torch.lint import repo_lint as RL
    src = (
        "import numpy as np\n"                   # 1: numpy import
        "import torch\n"
        "def bad(x, survey):\n"
        "    a = np.asarray(x)\n"               # 4: np materialization
        "    words = survey.tolist()\n"         # 5: a read-back (no numpy
        "    n = x.sum().item()\n"              # 6:  here: any receiver)
        "    torch.cuda.synchronize()\n"        # 7
        "    return x.cpu()\n"                  # 8
    )
    rel = f"{PKG}/kernels/foo.py"
    hits = _find(_run_rl(RL._check_kernel_host, rel, src), "RL-KERNEL-HOST")
    assert _lines(hits) == [1, 4, 5, 6, 7, 8], [str(d) for d in hits]
    ok = ("import torch\n"
          "def launch(x):\n"
          "    out = torch.empty_like(x)\n"
          "    return out\n")
    assert _run_rl(RL._check_kernel_host, rel, ok) == []
    assert _run_rl(RL._check_kernel_host, f"{PKG}/ops/foo.py", src) == []
    RL._KERNEL_HOST_ALLOWLIST[f"{rel}:ok_fn"] = "negative-test probe"
    try:
        assert _run_rl(RL._check_kernel_host, rel,
                       "def ok_fn(s):\n    return s.tolist()\n") == []
    finally:
        del RL._KERNEL_HOST_ALLOWLIST[f"{rel}:ok_fn"]


def test_rl_fault_point():
    from spark_rapids_tpu_torch.lint.repo_lint import (
        _check_fault_registry,
        _check_fault_sites,
    )
    from spark_rapids_tpu_torch.runtime.faults import FAULT_POINTS
    src = ("from spark_rapids_tpu_torch.runtime.faults import fault_point\n"
           "fault_point('no.such.point')\n"
           "name = 'dispatch.kernel'\n"
           "fault_point(name)\n")
    hits = _find(_run_rl(_check_fault_sites, f"{PKG}/foo.py", src, {}),
                 "RL-FAULT-POINT")
    assert len(hits) == 2
    assert "not registered" in hits[0].message
    assert "string literal" in hits[1].message

    diags2 = []
    _check_fault_registry({}, diags2)
    assert len(diags2) == len(FAULT_POINTS)
    assert all("no fault_point" in d.message for d in diags2)

    full = {name: [f"{module}:1"]
            for name, (module, _) in FAULT_POINTS.items()}
    full["dispatch.kernel"] = [f"{PKG}/elsewhere.py:2"]
    diags3 = []
    _check_fault_registry(full, diags3)
    assert len(diags3) == 1 and "registered module" in diags3[0].message

    # the mesh and host domains ride the same two-direction audit
    domains = [n for n in FAULT_POINTS if n.startswith(("mesh.", "host."))]
    assert len(domains) >= 6, domains
    calls = {name: [f"{module}:1"]
             for name, (module, _) in FAULT_POINTS.items()
             if name not in domains}
    diags4 = []
    _check_fault_registry(calls, diags4)
    assert sorted(d.path for d in diags4) == sorted(
        f"faults.FAULT_POINTS[{n!r}]" for n in domains)


def test_rl_obs_passive():
    from spark_rapids_tpu_torch.lint.repo_lint import (
        _OBS_PASSIVE_MODULE,
        _check_obs_passive,
    )
    src = (
        "import torch\n"                                   # 1: device
        "from spark_rapids_tpu_torch.dispatch import host_fetch\n"
        "def bad_sample(session, svc, exe, table, t):\n"
        "    a = host_fetch(table)\n"                      # 4: host sync
        "    b = t.cpu()\n"                                # 5: host sync
        "    finalize_observation(exe)\n"                  # 6: device fetch
        "    session.execute(table)\n"                     # 7: a query
        "    with session._obs_lock:\n"                    # 8: query lock
        "        pass\n"
        "    svc._cond.acquire()\n"                        # 10: query lock
    )
    hits = _find(_run_rl(_check_obs_passive, _OBS_PASSIVE_MODULE, src),
                 "RL-OBS-PASSIVE")
    assert _lines(hits) == [1, 4, 5, 6, 7, 8, 10], [str(d) for d in hits]
    ok = ("import threading\n"
          "from spark_rapids_tpu_torch.obs.metrics import scopes_snapshot\n"
          "_lock = threading.Lock()\n"
          "def sample():\n"
          "    snap = scopes_snapshot()\n"
          "    with _lock:\n"
          "        return dict(snap)\n")
    assert _run_rl(_check_obs_passive, _OBS_PASSIVE_MODULE, ok) == []
    assert _run_rl(_check_obs_passive, f"{PKG}/obs/events.py", src) == []
    with open(os.path.join(ROOT, _OBS_PASSIVE_MODULE)) as f:
        assert _run_rl(_check_obs_passive, _OBS_PASSIVE_MODULE,
                       f.read()) == []


def test_rl_mem_account():
    from spark_rapids_tpu_torch.lint.repo_lint import (
        _MEM_ACCOUNT_ALLOWLIST,
        _check_mem_account,
    )
    src = (
        "import numpy as np\n"
        "import torch\n"
        "def bad(a, dev, vals):\n"
        "    w = a.cuda()\n"                                  # 4
        "    x = torch.from_numpy(a).to(dev)\n"               # 5
        "    y = torch.tensor(vals, device=dev)\n"            # 6
        "    z = torch.as_tensor(a).to(device=dev)\n"         # 7
        "    c = torch.from_numpy(a).to(torch.int64)\n"       # a cast
        "    d = torch.from_numpy(a).to(x.dtype)\n"           # a cast
        "    return w, x, y, z, c, d\n"
    )
    for rel in (f"{PKG}/execs/foo.py", f"{PKG}/ops/foo.py"):
        hits = _find(_run_rl(_check_mem_account, rel, src), "RL-MEM-ACCOUNT")
        assert _lines(hits) == [4, 5, 6, 7], [str(d) for d in hits]
        assert "from_host" in hits[0].message
    ok = ("from spark_rapids_tpu_torch.columnar import DeviceColumn\n"
          "def good(host, cap, dev):\n"
          "    return DeviceColumn.from_host(host, cap, dev)\n")
    assert _run_rl(_check_mem_account, f"{PKG}/execs/foo.py", ok) == []
    # columnar/ IS the accounted landing layer
    assert _run_rl(_check_mem_account, f"{PKG}/columnar/table.py", src) == []
    key = f"{PKG}/ops/tzdb.py:device_tables"
    assert key in _MEM_ACCOUNT_ALLOWLIST
    allow = ("import torch\n"
             "def device_tables(name, device):\n"
             "    return torch.from_numpy(t).to(device)\n")
    assert _run_rl(_check_mem_account, f"{PKG}/ops/tzdb.py", allow) == []


def test_row_sized_landings_are_accounted(monkeypatch):
    """The lint's catches, repaired: the sample's keep mask and rand()'s
    values land through DeviceColumn.from_array (one copy, as before:
    the card's warm host syncs stay); each reserved and accounted, not a
    raw upload. The bloom filter's build column no longer lands at all:
    it stays on the device through the export (to_device_arrays)."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.columnar import DeviceColumn
    from spark_rapids_tpu_torch.ops.bloom import build_bloom_filter
    from spark_rapids_tpu_torch.plan import from_host_table
    landed = []
    from_host, from_array = DeviceColumn.from_host, DeviceColumn.from_array

    def counting_host(host, capacity, device):
        landed.append((sys._getframe(1).f_code.co_name,
                       host.dtype.simple_string()))
        return from_host(host, capacity, device)

    def counting_array(dtype, data, device):
        landed.append((sys._getframe(1).f_code.co_name,
                       dtype.simple_string()))
        return from_array(dtype, data, device)

    monkeypatch.setattr(DeviceColumn, "from_host",
                        staticmethod(counting_host))
    monkeypatch.setattr(DeviceColumn, "from_array",
                        staticmethod(counting_array))
    s = TorchSession({"spark.rapids.sql.executableCache.enabled": "false"},
                     device=CPU)
    t = HostTable(["k"], [HostColumn(T.LONG, np.arange(500, dtype=np.int64))])
    df = from_host_table(t, s)
    landed.clear()
    n = df.sample(0.5, 3).count()
    assert 0 < n < 500 and ("run", "boolean") in landed, landed
    landed.clear()
    got = df.select(F.rand(7).alias("r")).collect_table()
    assert got.num_rows == 500 and ("prep", "double") in landed, landed
    landed.clear()
    bf = build_bloom_filter(df, "k", num_bits=1024, num_hashes=3)
    assert bf.num_bits == 1024
    assert not [x for x in landed if x[0] == "build_bloom_filter"], landed


def test_rl_mv_epoch():
    from spark_rapids_tpu_torch.lint.repo_lint import _check_mv_epoch
    src = (
        "from spark_rapids_tpu_torch.service.result_cache import "
        "ResultCache\n"
        "def bad(service, key, table):\n"
        "    service.result_cache.put(key, table)\n"
        "    service.result_cache._entries.clear()\n"
    )
    hits = _find(_run_rl(_check_mv_epoch, f"{PKG}/streaming/mv.py", src),
                 "RL-MV-EPOCH")
    assert len(hits) >= 3 and any("epoch" in h.message for h in hits)
    ok = ("from spark_rapids_tpu_torch.service.result_cache import (\n"
          "    bump_table_epoch,\n"
          "    register_epoch_listener,\n"
          ")\n"
          "def good(path):\n"
          "    bump_table_epoch('delta:' + path, 'refresh')\n")
    assert _run_rl(_check_mv_epoch, f"{PKG}/streaming/mv.py", ok) == []
    assert _run_rl(_check_mv_epoch, f"{PKG}/service/scheduler.py", src) == []


def _port_trees(rels=None, edits=None):
    """The port's parsed sources (what ``lint_repo`` walks), or those of
    ``rels``, with ``{rel: [(old, new), ...]}`` text edits applied."""
    from spark_rapids_tpu_torch.lint.rules.common import (
        _iter_source_files,
        _rel,
    )
    trees = {}
    for path in _iter_source_files(ROOT):
        rel = _rel(ROOT, path)
        if rels is not None and rel not in rels:
            continue
        with open(path, encoding="utf-8") as f:
            src = f.read()
        for old, new in (edits or {}).get(rel, ()):
            assert src.count(old) == 1, (rel, old)
            src = src.replace(old, new)
        trees[rel] = ast.parse(src)
    return trees


def _concurrency(trees):
    from spark_rapids_tpu_torch.lint.concurrency import check_concurrency
    diags = []
    check_concurrency(trees, diags)
    return diags


#: the mesh gate's construction as committed, and its former shape (one
#: conditional expression)
_MESH_GATE = (
    "        self._mesh_gate = None\n"
    "        if bool(self.conf.get_entry(MESH_ENABLED)):\n"
    '            self._mesh_gate = ordered_lock("service.mesh_gate")',
    '        self._mesh_gate = (ordered_lock("service.mesh_gate")\n'
    "                           if bool(self.conf.get_entry(MESH_ENABLED))\n"
    "                           else None)")


def test_rl_lock_decl_pins_the_ports_repairs():
    """RL-LOCK-DECL over the port's modules (the whole tree lints clean:
    ``test_repo_lints_clean``): the mesh gate's former one-expression
    construction binds nothing (unbound, then stale), and a raw lock back
    in a scope directory is raw (and leaves its declaration stale)."""
    sched = f"{PKG}/service/scheduler.py"
    assert _concurrency(_port_trees({sched})) == []
    diags = _concurrency(_port_trees({sched}, {sched: [_MESH_GATE]}))
    assert {d.rule_id for d in diags} == {"RL-LOCK-DECL"}
    assert any("<unbound>" in d.message and d.path.startswith(sched)
               for d in diags)
    assert any(d.path == "lockorder.LOCK_ORDER['service.mesh_gate']"
               and "stale" in d.message for d in diags)
    spec = f"{PKG}/runtime/speculation.py"
    diags = _concurrency(_port_trees({spec}, {spec: [(
        'ordered_lock("speculation.blocklist")', "threading.Lock()")]}))
    assert len(diags) == 2 and {d.rule_id for d in diags} == {"RL-LOCK-DECL"}
    assert any(d.path.startswith(spec)
               and "raw threading.Lock()" in d.message for d in diags)
    assert any(d.path == "lockorder.LOCK_ORDER['speculation.blocklist']"
               for d in diags)


def test_rl_lock_order_pins_the_topology_nest():
    """The topology snapshot's former nest (quarantine taken under the
    mesh's lock) is an RL-LOCK-ORDER finding over the port's tree."""
    rel = f"{PKG}/runtime/health.py"
    # the nest's owners: the pass resolves their singletons there
    owners = {rel} | {f"{PKG}/{m}.py" for m in (
        "runtime/cluster", "parallel/mesh", "runtime/memory")}
    assert _concurrency(_port_trees(owners)) == []
    diags = _concurrency(_port_trees(owners, {rel: [(
        "            with QUARANTINE._lock:\n"
        "                with MESH._lock:",
        "            with MESH._lock:\n"
        "                with QUARANTINE._lock:")]}))
    hits = _find(diags, "RL-LOCK-ORDER")
    assert any(d.path.startswith(rel) and "'health.quarantine' (rank 410) "
               "while holding 'mesh.runtime' (rank 530)" in d.message
               for d in hits), [str(d) for d in diags]


def test_rl_lock_effect_allowlists_name_live_functions():
    """RL-LOCK-EFFECT: every allowlisted holder is a function of the
    port's tree (a stale key silences nothing it names), and a host sync
    under a declared lock is a finding."""
    from spark_rapids_tpu_torch.lint import concurrency as C
    from spark_rapids_tpu_torch.lockorder import LOCK_ORDER
    idx = C._Indexes(_port_trees(), LOCK_ORDER)
    for key in list(C._LOCK_EFFECT_ALLOWLIST) + list(
            C._LOCK_ORDER_ALLOWLIST):
        rel, qual = key.split(":")
        assert (rel, qual) in idx.funcs, key
    rel = f"{PKG}/io/filecache.py"
    trees = {rel: ast.parse(
        "from spark_rapids_tpu_torch.lockorder import ordered_lock\n"
        "class _FileCache:\n"
        "    def __init__(self):\n"
        '        self._lock = ordered_lock("io.filecache")\n'
        "    def peek(self, t):\n"
        "        with self._lock:\n"
        "            return t.cpu()\n")}
    hits = _find(_concurrency(trees), "RL-LOCK-EFFECT")
    assert any(d.path == f"{rel}:7" and "host sync .cpu() while holding "
               "lock 'io.filecache'" in d.message for d in hits)


def test_every_rule_has_a_negative_test():
    """Meta-pin: the rule surface and this module's negative coverage
    cannot drift apart."""
    with open(__file__) as f:
        module_src = f.read()
    for rid in RULES:
        assert rid in module_src, f"rule {rid} has no negative test"


# ---------------------------------------------------------------------------
# the session's verifier
# ---------------------------------------------------------------------------


@pytest.fixture
def small_df():
    from spark_rapids_tpu_torch.plan.executable_cache import EXEC_CACHE
    EXEC_CACHE.clear()
    t = HostTable(["k", "v"], [
        HostColumn(T.LONG, np.arange(20, dtype=np.int64) % 4),
        HostColumn(T.DOUBLE, np.arange(20, dtype=np.float64))])

    def make(conf):
        from spark_rapids_tpu_torch import functions as F
        from spark_rapids_tpu_torch.plan import from_host_table
        s = TorchSession(conf, device=CPU)
        return s, (from_host_table(t, s).filter(col("v") > Literal(2.0))
                   .group_by("k").agg(F.sum("v").alias("s")))

    yield make
    EXEC_CACHE.clear()


@pytest.fixture
def blank_reason(monkeypatch):
    """convert_meta as the session calls it, with a blank fallback reason
    left on the root's meta after conversion (the tree still runs)."""
    from spark_rapids_tpu_torch.overrides import rules
    orig = rules.convert_meta

    def tampered(meta, device):
        root = orig(meta, device)
        meta.reasons.append("   ")
        return root

    monkeypatch.setattr(rules, "convert_meta", tampered)


def _verify_calls(monkeypatch):
    from spark_rapids_tpu_torch.lint import plan_verifier
    calls = []
    orig = plan_verifier.verify_converted

    def counting(root, meta=None, conf=None):
        calls.append(root)
        return orig(root, meta, conf)

    monkeypatch.setattr(plan_verifier, "verify_converted", counting)
    return calls


def test_plan_verify_default_is_off(small_df, monkeypatch):
    from spark_rapids_tpu_torch.conf import PLAN_VERIFY_MODE
    assert RapidsConf().get_entry(PLAN_VERIFY_MODE) == "off"
    calls = _verify_calls(monkeypatch)
    s, df = small_df({})
    assert sorted(df.collect()) == [(0, 40.0), (1, 44.0), (2, 48.0),
                                    (3, 55.0)]
    assert calls == []


def test_plan_verify_warn_prints(small_df, blank_reason, capsys):
    s, df = small_df({"spark.rapids.sql.planVerify.mode": "warn"})
    assert len(df.collect()) == 4
    out = capsys.readouterr().out
    assert "planVerify: [PV-FALLBACK]" in out and "empty reason" in out


def test_plan_verify_error_raises(small_df, blank_reason):
    from spark_rapids_tpu_torch.errors import PlanVerificationError
    s, df = small_df({"spark.rapids.sql.planVerify.mode": "error"})
    with pytest.raises(PlanVerificationError) as info:
        df.collect()
    assert _ids(info.value.diagnostics) == {"PV-FALLBACK"}
    assert "[PV-FALLBACK]" in str(info.value)


def test_plan_verify_error_raises_before_any_launch(small_df, monkeypatch):
    """A hand-broken converted plan (a Limit exec over a host node) raises
    in error mode before anything runs: no kernel wrapper is called."""
    from spark_rapids_tpu_torch import kernels as K
    from spark_rapids_tpu_torch.errors import PlanVerificationError
    from spark_rapids_tpu_torch.execs.basic import TpuLimitExec
    from spark_rapids_tpu_torch.overrides import rules
    monkeypatch.setattr(rules, "convert_meta", lambda meta, device:
                        TpuLimitExec(P.RangeNode(0, 10), 5))
    K.reset_launch_counts()
    calls = K.calls = []
    try:
        s, df = small_df({"spark.rapids.sql.planVerify.mode": "error"})
        with pytest.raises(PlanVerificationError) as info:
            df.collect()
    finally:
        K.calls = None
    assert "PV-TRANSITION" in _ids(info.value.diagnostics)
    assert calls == [] and not any(K.launch_counts().values())


def test_plan_verify_bad_mode_raises(small_df):
    from spark_rapids_tpu_torch.errors import ColumnarProcessingError
    s, df = small_df({"spark.rapids.sql.planVerify.mode": "strict"})
    with pytest.raises(ColumnarProcessingError, match="off, warn or error"):
        df.collect()


def test_plan_verify_skips_a_cache_hit(small_df, monkeypatch):
    calls = _verify_calls(monkeypatch)
    s, df = small_df({"spark.rapids.sql.planVerify.mode": "error"})
    first = df.collect()
    assert len(calls) == 1 and not s.last_executable_cache_hit
    assert df.collect() == first
    assert s.last_executable_cache_hit and len(calls) == 1


def test_plan_verify_not_run_with_sql_disabled(small_df, monkeypatch):
    calls = _verify_calls(monkeypatch)
    s, df = small_df({"spark.rapids.sql.planVerify.mode": "error",
                      "spark.rapids.sql.enabled": "false"})
    assert len(df.collect()) == 4
    assert calls == [] and s.last_meta is None


# ---------------------------------------------------------------------------
# the CLI in a subprocess
# ---------------------------------------------------------------------------

#: the two CLI runs below together (each imports torch and the port):
#: 7.3 s on an idle 8-core host, 10.2 s beside five other test files
#: under -n 6; the bound leaves room for a host loaded further
CLI_BOUND_S = 60.0


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "spark_rapids_tpu_torch.lint",
                           "--json", *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=CLI_BOUND_S)


def test_cli_json_contract(tmp_path):
    t0 = time.monotonic()
    clean = _cli("--skip-repo", "--skip-registry", "--skip-plans",
                 "--skip-exec-metrics")
    assert clean.returncode == 0, clean.stderr
    assert json.loads(clean.stdout) == {"phases": {}, "diagnostics": [],
                                        "ok": True}

    bad = tmp_path / PKG / "runtime"
    bad.mkdir(parents=True)
    (bad / "bad.py").write_text(
        'import os\nKEY = "spark.rapids.sql.noSuchKey"\n')
    failing = _cli("--repo-root", str(tmp_path), "--skip-registry",
                   "--skip-plans", "--skip-exec-metrics", "--device", CPU)
    assert failing.returncode == 1, failing.stderr
    out = json.loads(failing.stdout)
    assert out["ok"] is False and out["phases"]["repo"] >= 1
    assert any(d["rule_id"] == "RL-CONF-KEY"
               and d["path"] == f"{PKG}/runtime/bad.py:2"
               and d["severity"] == "error" for d in out["diagnostics"])
    assert time.monotonic() - t0 < CLI_BOUND_S
