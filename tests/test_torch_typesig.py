"""The type-signature matrix of the PyTorch port
(``overrides/typesig.py``, the expression signatures and per-parameter
checks of ``overrides/rules.py``, ``overrides/docs.py``,
``overrides/api_validation.py``) against the reference: the probe table
of ``tests/test_typesig_matrix.py:31-60``, each bad input tagged with the
reference's reason (its "TPU" read as "GPU") and each good input on the
device in both packages; the device probes answering as the reference's
(``scale_test.tables_differ``, bit for bit); every expression class
registered with a signature; ``validate_api()`` in sync; and the
generated matrix's parameter rows."""

import importlib

import numpy as np
import pytest

from scale_test import tables_differ
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.conf import RapidsConf as JRapidsConf
from spark_rapids_tpu.ops.expr import BoundReference as JBoundReference
from spark_rapids_tpu.ops.expr import Literal as JLiteral
from spark_rapids_tpu.ops.expr import col as jcol
from spark_rapids_tpu.overrides import rules as JR
from spark_rapids_tpu.plan import from_host_table as jfrom
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.ops.expr import BoundReference, Literal, col
from spark_rapids_tpu_torch.overrides import rules as R
from spark_rapids_tpu_torch.plan import from_host_table as tfrom
from spark_rapids_tpu_torch.session import TorchSession

# (class path under ops/, bad input types, good input types, literal args)
PROBES = [
    ("math.Acos", ("STRING",), ("DOUBLE",), ()),
    ("math.Sqrt", ("DATE",), ("DOUBLE",), ()),
    ("math.BitwiseNot", ("DOUBLE",), ("LONG",), ()),
    ("math.ShiftLeft", ("STRING", "INT"), ("INT", "INT"), ()),
    ("arithmetic.Add", ("DATE", "DATE"), ("LONG", "LONG"), ()),
    ("arithmetic.Multiply", ("STRING", "LONG"), ("DOUBLE", "LONG"), ()),
    ("arithmetic.Abs", ("STRING",), ("INT",), ()),
    ("predicates.And", ("LONG", "BOOLEAN"), ("BOOLEAN", "BOOLEAN"), ()),
    ("predicates.Not", ("STRING",), ("BOOLEAN",), ()),
    ("predicates.IsNaN", ("STRING",), ("DOUBLE",), ()),
    ("strings.Upper", ("LONG",), ("STRING",), ()),
    ("strings.Contains", ("STRING", "LONG"), ("STRING", "STRING"), ()),
    ("strings.Substring", ("DATE",), ("STRING",), (1, 2)),
    ("datetime.Year", ("STRING",), ("DATE",), ()),
    ("datetime.DateAdd", ("TIMESTAMP", "INT"), ("DATE", "INT"), ()),
]


def _reasons(pkg, path, types, lits):
    """check_expr's reasons for the probe class of ``pkg`` over bound
    references of ``types`` and literal arguments ``lits``."""
    mod, name = path.split(".")
    cls = getattr(importlib.import_module(f"{pkg}.ops.{mod}"), name)
    if pkg == "spark_rapids_tpu":
        tmod, ref, lit, rules, conf = (JT, JBoundReference, JLiteral, JR,
                                       JRapidsConf())
    else:
        tmod, ref, lit, rules, conf = (T, BoundReference, Literal, R,
                                       RapidsConf())
    e = cls(*[ref(i, getattr(tmod, t)) for i, t in enumerate(types)],
            *[lit(v) for v in lits])
    out = []
    rules.check_expr(e, conf, out)
    return out


@pytest.mark.parametrize("path,bad,good,lits", PROBES,
                         ids=[p[0] for p in PROBES])
def test_param_checks_tag_what_the_reference_tags(path, bad, good, lits):
    got = _reasons("spark_rapids_tpu_torch", path, bad, lits)
    want = _reasons("spark_rapids_tpu", path, bad, lits)
    assert any("unsupported type" in r for r in got), got
    assert got == [r.replace("on TPU", "on GPU") for r in want]
    got_good = _reasons("spark_rapids_tpu_torch", path, good, lits)
    want_good = _reasons("spark_rapids_tpu", path, good, lits)
    assert not any("input" in r and "unsupported" in r for r in got_good)
    assert got_good == [r.replace("on TPU", "on GPU") for r in want_good]


def _probe_data(kind):
    n = 3
    if kind == "double":
        return "double", (np.array([0.1, 0.5, 0.0]),
                          np.array([True, True, False]))
    if kind == "long":
        return "bigint", (np.array([1, 2, 3]), np.ones(n, bool))
    if kind == "string":
        return "string", (np.array(["a", "Bc", ""], dtype=object),
                          np.array([True, True, False]))
    return "date", (np.array([0, 400, 800], dtype=np.int32),
                    np.ones(n, bool))


# the good cells that run: (name, column kind, port and reference builds)
def _acos(Fn, c):
    pkg = Fn.__name__.rsplit(".", 1)[0]
    return importlib.import_module(f"{pkg}.ops.math").Acos(c("x"))


DEVICE_PROBES = [
    ("acos_double", "double", _acos),
    ("add_longs", "long", lambda Fn, c: c("x") + c("x")),
    ("upper_string", "string", lambda Fn, c: Fn.upper(c("x"))),
    ("year_date", "date", lambda Fn, c: Fn.year(c("x"))),
]


@pytest.mark.parametrize("name,kind,mk", DEVICE_PROBES,
                         ids=[p[0] for p in DEVICE_PROBES])
def test_good_cells_run_on_the_device(name, kind, mk):
    """The reference's ``test_s_cells_execute_on_device``: each good cell
    converts with no CPU-route node and answers as the reference."""
    ty, arr = _probe_data(kind)
    t = host_table_from_arrays(["x"], [ty], [arr])
    s = TorchSession(device="cpu")
    got = tfrom(t, s).select(mk(F, col).alias("r")).collect_table()
    assert R.collect_cpu_nodes(s._last_root) == []
    assert s.last_meta.can_run_on_gpu
    jt = JHostTable(["x"], [JHostColumn(JT.parse_type(ty), c.data,
                                        c.validity) for c in t.columns])
    want = jfrom(jt, TpuSession()).select(mk(JF, jcol).alias("r")) \
        .collect_table()
    names, types, arrays = got.to_arrays()
    assert tables_differ(JHostTable(names, [
        JHostColumn(JT.parse_type(ty2), d, v)
        for ty2, (d, v) in zip(types, arrays)]), want) is None


def test_every_expression_class_has_a_signature():
    """Every expression class of the port's modules is registered with an
    output signature (the reference's breadth guard), and every
    per-parameter check is well formed."""
    from spark_rapids_tpu_torch.conf import _op_names
    R._build_expr_sigs()
    assert len(R._EXPR_SIGS) >= 190
    names = {c.__name__ for c in R._EXPR_SIGS}
    assert _op_names("expression") - {"Expression"} <= names | {
        n for n in _op_names("expression") if n.startswith("_")}
    for cls, checks in R._EXPR_CHECKS.items():
        assert cls in R._EXPR_SIGS, cls
        for i, sig in enumerate(checks.param_sigs):
            assert hasattr(sig, "supports"), (cls, i)
    # the reference's per-parameter families are all here
    assert {c.__name__ for c in R._EXPR_CHECKS} >= {
        c.__name__ for c in JR._EXPR_CHECKS}


def test_api_validation_no_drift():
    from spark_rapids_tpu_torch.overrides.api_validation import validate_api
    assert validate_api() == []


def test_matrix_reports_param_rows():
    """The reference's ``test_matrix_reports_param_rows``: Acos has a
    result row and a parameter row, STRING NS on the parameter, DOUBLE S
    on the result."""
    from spark_rapids_tpu_torch.overrides.docs import generate_supported_ops
    md = generate_supported_ops()
    acos = [ln for ln in md.splitlines() if ln.startswith("| Acos ")]
    param0 = next(ln for ln in acos if "/ param 0" in ln)
    assert [c.strip() for c in param0.split("|")][11] == "NS"
    result = next(ln for ln in acos if "/ result" in ln)
    assert [c.strip() for c in result.split("|")][7] == "S"


def test_exec_matrix_rows_match_the_tags():
    """The exec rows read the signatures the tags check: DECIMAL128 is S
    wherever storage carries it, as the reference's matrix says; nested
    columns are S only where the tag lets them through (a scan, a
    project; arrays out of an aggregate)."""
    from spark_rapids_tpu_torch.overrides.docs import generate_supported_ops
    execs = generate_supported_ops().split("## Expressions")[0]

    def cells(name):
        row = next(ln for ln in execs.splitlines()
                   if ln.startswith(f"| {name} "))
        return [c.strip() for c in row.split("|")]
    for name in ("LocalScan", "Filter", "Sort", "Aggregate", "Join",
                 "Exchange", "TakeOrderedAndProject", "Limit", "Union",
                 "Project"):
        assert cells(name)[13] == "S", name
    assert cells("Filter")[14:17] == ["NS", "NS", "NS"]
    assert cells("Project")[14:17] == ["S", "S", "S"]
    assert cells("Aggregate")[14:17] == ["S", "NS", "NS"]
