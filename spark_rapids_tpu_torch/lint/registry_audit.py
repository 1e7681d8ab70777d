"""Registry auditor (port of ``spark_rapids_tpu/lint/registry_audit.py``;
reference: the supported_ops.md generator contract — docs, tag functions
and registries must agree).

Cross-checks the port's registries, one Diagnostic per disagreement
(RA-* rules):

* the expression classes with a device form against the overrides
  ``_EXPR_SIGS`` registrations (unregistered = silently CPU);
* ``_EXPR_CHECKS`` per-parameter signatures against constructor arity;
* the per-op kill switches the conf accepts against the rule registries;
* the device aggregates against the SQL function registry;
* the declared conf keys against their readers;
* the port's committed ``spark_rapids_tpu_torch/docs/SUPPORTED_OPS.md``,
  ``CONFIGS.md`` and ``LOCKS.md`` against their generators (the root's
  documents belong to the reference and are never read or written here);
* and, executed, the ESSENTIAL exec metrics of a golden-corpus slice.
"""

from __future__ import annotations

import inspect
import os
import sys
from typing import List, Optional

from spark_rapids_tpu_torch.lint.diagnostics import Diagnostic, make

#: the port's generated documents, relative to the repo root
DOCS_DIR = os.path.join("spark_rapids_tpu_torch", "docs")


def _repo_root(repo_root: Optional[str]) -> str:
    if repo_root:
        return repo_root
    import spark_rapids_tpu_torch
    return os.path.dirname(os.path.dirname(
        os.path.abspath(spark_rapids_tpu_torch.__file__)))


#: classes that are never evaluated as row expressions, so an _EXPR_SIGS
#: entry would be meaningless: generator markers are consumed by the
#: Generate plan node (tagged by _tag_generate), and the HOF lambda
#: plumbing is rebound into element space by its enclosing function
_NON_EXPR_EVALUATED = {
    "Explode", "ExplodeOuter", "PosExplode", "PosExplodeOuter",
    "LambdaFunction", "NamedLambdaVariable",
}


def _audit_unregistered(diags: List[Diagnostic]) -> None:
    """Every Expression subclass of the port's loaded modules that has a
    device form must be in ``_EXPR_SIGS``: the registry is built once,
    from the subclasses of the modules ``conf._import_op_modules``
    imports, so a class defined elsewhere, or imported after the first
    build, would be tagged "not supported on GPU"."""
    from spark_rapids_tpu_torch.ops.expr import Expression
    from spark_rapids_tpu_torch.overrides import rules as R
    from spark_rapids_tpu_torch.overrides.typesig import lookup_mro
    R._build_expr_sigs()
    for mod_name in sorted(sys.modules):
        mod = sys.modules[mod_name]
        if mod is None or not mod_name.startswith("spark_rapids_tpu_torch."):
            continue
        for name, obj in sorted(vars(mod).items()):
            if not (isinstance(obj, type) and issubclass(obj, Expression)
                    and not name.startswith("_")
                    and obj.__module__ == mod.__name__):
                continue
            has_dev = getattr(obj, "eval_dev", None) \
                is not Expression.eval_dev
            if name in _NON_EXPR_EVALUATED:
                continue
            if has_dev and lookup_mro(R._EXPR_SIGS, obj) is None:
                diags.append(make(
                    "RA-UNREGISTERED", f"{mod_name}.{name}",
                    "expression has a device form (eval_dev) but no "
                    "_EXPR_SIGS registration — it silently falls back "
                    "to the CPU route"))


def _audit_param_arity(diags: List[Diagnostic]) -> None:
    from spark_rapids_tpu_torch.overrides import rules as R
    R._build_expr_sigs()
    for cls, checks in R._EXPR_CHECKS.items():
        try:
            sig = inspect.signature(cls.__init__)
        except (TypeError, ValueError):
            continue
        params = [p for n, p in sig.parameters.items() if n != "self"]
        if any(p.kind == inspect.Parameter.VAR_POSITIONAL for p in params):
            continue  # *args constructors accept any arity
        max_args = len([p for p in params if p.kind in (
            inspect.Parameter.POSITIONAL_ONLY,
            inspect.Parameter.POSITIONAL_OR_KEYWORD)])
        if len(checks.param_sigs) > max_args:
            diags.append(make(
                "RA-PARAM-ARITY",
                f"{cls.__module__}.{cls.__name__}",
                f"ExprChecks declares {len(checks.param_sigs)} parameter "
                f"signatures but the constructor takes at most "
                f"{max_args} positional arguments"))


def _audit_kill_switches(diags: List[Diagnostic]) -> None:
    """A kill switch must switch something: every declared key of the
    ``spark.rapids.sql.exec.<X>`` / ``.expression.<X>`` form, and every
    name the conf accepts for one (``conf._op_names``), names a class with
    an exec rule (a device plan node or a subclass, a registered file
    scan) or an expression class with a signature (its own or a
    base's)."""
    from spark_rapids_tpu_torch import conf as C
    from spark_rapids_tpu_torch.ops.expr import Expression
    from spark_rapids_tpu_torch.overrides import rules as R
    from spark_rapids_tpu_torch.overrides.typesig import lookup_mro
    R._build_expr_sigs()

    def subclasses(roots):
        out, todo = set(), list(roots)
        while todo:
            cls = todo.pop()
            out.add(cls)
            todo.extend(cls.__subclasses__())
        return out

    exec_names = {c.__name__ for c in subclasses(R._DEVICE_NODES)} | \
        {c.__name__ for c in R._FILE_SCANS}
    expr_names = {c.__name__ for c in subclasses([Expression])
                  if lookup_mro(R._EXPR_SIGS, c) is not None}
    named = {"exec": exec_names, "expression": expr_names}
    keys = [k for k in C.registry()
            if k.startswith(tuple(C._KILL_SWITCH_PREFIXES.values()))]
    for kind, prefix in C._KILL_SWITCH_PREFIXES.items():
        keys += [prefix + n for n in sorted(C._op_names(kind))]
    for key in sorted(set(keys)):
        parts = key.split(".")
        if len(parts) != 5:
            continue
        kind, name = parts[3], parts[4]
        if name not in named.get(kind, ()):
            diags.append(make(
                "RA-KILL-SWITCH", key,
                f"kill switch names {kind} {name!r} but no "
                f"{'exec rule' if kind == 'exec' else 'expression signature'}"
                " is registered under that class"))


#: device aggregate class -> the SQL builtin name users reach it by;
#: RA-SQL-EXPOSURE fails when a DEVICE_SUPPORTED_AGGS class is missing
#: here or its name is missing from the builtin table
_AGG_SQL_NAMES = {
    "Sum": "sum", "Min": "min", "Max": "max", "Count": "count",
    "Average": "avg", "First": "first", "Last": "last",
    "StddevPop": "stddev_pop", "StddevSamp": "stddev_samp",
    "VariancePop": "var_pop", "VarianceSamp": "var_samp",
    "CollectList": "collect_list", "CollectSet": "collect_set",
    "Percentile": "percentile",
}


def _audit_sql_exposure(diags: List[Diagnostic]) -> None:
    from spark_rapids_tpu_torch.execs.aggregate import DEVICE_SUPPORTED_AGGS
    from spark_rapids_tpu_torch.sql import registry as sql_registry
    try:
        table_probe = sql_registry.builtin("sum")
    except Exception as exc:
        diags.append(make(
            "RA-SQL-EXPOSURE", "sql.registry",
            f"builtin function table fails to build: {exc!r}"))
        return
    if table_probe is None:
        diags.append(make("RA-SQL-EXPOSURE", "sql.registry.sum",
                          "core aggregate 'sum' missing from builtins"))
    for cls in DEVICE_SUPPORTED_AGGS:
        sql_name = _AGG_SQL_NAMES.get(cls.__name__)
        where = f"sql.registry.{cls.__name__}"
        if sql_name is None:
            diags.append(make(
                "RA-SQL-EXPOSURE", where,
                f"device aggregate {cls.__name__} has no known SQL "
                "name (add it to the auditor map AND the SQL registry)"))
        elif sql_registry.builtin(sql_name) is None:
            diags.append(make(
                "RA-SQL-EXPOSURE", where,
                f"device aggregate {cls.__name__} is not callable from "
                f"SQL (builtin {sql_name!r} missing)"))


def _generators():
    """(file name, generator, drift rule) of the port's documents."""
    from spark_rapids_tpu_torch.conf import generate_docs
    from spark_rapids_tpu_torch.lockorder import generate_locks_md
    from spark_rapids_tpu_torch.overrides.docs import generate_supported_ops
    return (("SUPPORTED_OPS.md", generate_supported_ops, "RA-DOC-DRIFT-OPS"),
            ("CONFIGS.md", generate_docs, "RA-DOC-DRIFT-CONFIGS"),
            ("LOCKS.md", generate_locks_md, "RA-DOC-DRIFT-LOCKS"))


def _audit_doc_drift(diags: List[Diagnostic], root: str) -> None:
    """``root`` is the repo root: the documents are under ``DOCS_DIR``."""
    for fname, gen, rule in _generators():
        rel = os.path.join(DOCS_DIR, fname)
        path = os.path.join(root, rel)
        if not os.path.exists(path):
            diags.append(make(rule, rel, "committed file is missing"))
            continue
        with open(path, encoding="utf-8") as f:
            on_disk = f.read()
        want = gen()
        if on_disk != want:
            # first diverging line makes the drift actionable
            got_lines = on_disk.splitlines()
            want_lines = want.splitlines()
            where = next((i for i, (a, b) in
                          enumerate(zip(got_lines, want_lines)) if a != b),
                         min(len(got_lines), len(want_lines)))
            diags.append(make(
                rule, f"{rel}:{where + 1}",
                "committed file differs from the generator output — "
                "regenerate via `python -m spark_rapids_tpu_torch.lint "
                "--write-docs`"))


def regenerate_docs(repo_root: Optional[str] = None) -> List[str]:
    """Write the port's SUPPORTED_OPS.md, CONFIGS.md and LOCKS.md (under
    ``spark_rapids_tpu_torch/docs/``) from their generators; returns the
    files written (the CLI's --write-docs). The root's documents are the
    reference's and are not touched."""
    root = _repo_root(repo_root)
    os.makedirs(os.path.join(root, DOCS_DIR), exist_ok=True)
    written = []
    for fname, gen, _rule in _generators():
        path = os.path.join(root, DOCS_DIR, fname)
        with open(path, "w", encoding="utf-8") as f:
            f.write(gen())
        written.append(path)
    return written


#: the ESSENTIAL metrics every exec that ran must carry (the reference's
#: ``obs/metrics.py::ESSENTIAL_EXEC_METRICS``; obs/spans.py registers and
#: counts them at the observation boundary)
ESSENTIAL_EXEC_METRICS = ("opTime", "numOutputRows", "numOutputBatches")

#: golden-corpus slice the metrics audit executes: one query per major
#: exec family (agg, join, sort+limit, window, exchange) — enough to
#: observe every hot exec class without running all 22
_METRICS_AUDIT_QUERIES = ("q1", "q3", "q5", "q6", "q7")


def audit_exec_metrics_tree(executable,
                            diags: List[Diagnostic],
                            context: str = "") -> None:
    """RA-ESSENTIAL-METRICS over ONE executed tree: every device exec
    that ran must carry the ESSENTIAL opTime/numOutputRows/
    numOutputBatches metrics. An exec whose metrics are entirely empty
    never ran (a lazily-pulled branch an early-terminating consumer
    abandoned) — skipped, EXCEPT the root, whose silence means the
    observation boundary was never installed."""
    from spark_rapids_tpu_torch.execs.base import TpuExec
    from spark_rapids_tpu_torch.lore import _iter_tree

    root = executable
    for e in _iter_tree(executable):
        if not isinstance(e, TpuExec):
            continue
        name = type(e).__name__
        where = f"{context}{name}[loreId={getattr(e, '_lore_id', '?')}]"
        m = e.metrics
        if not m:
            if e is root:
                diags.append(make(
                    "RA-ESSENTIAL-METRICS", where,
                    "root of an executed plan has NO metrics — the "
                    "observation boundary was never installed"))
            continue
        missing = [k for k in ESSENTIAL_EXEC_METRICS if k not in m]
        if missing:
            diags.append(make(
                "RA-ESSENTIAL-METRICS", where,
                f"executed exec is missing ESSENTIAL metric(s) "
                f"{', '.join(missing)}"))


def audit_exec_metrics(scale_factor: float = 0.005,
                       queries=_METRICS_AUDIT_QUERIES,
                       device=None) -> List[Diagnostic]:
    """Execute a golden-corpus slice on ``device`` (default: the card)
    and assert every exec that ran emitted its ESSENTIAL metrics (the
    obs/spans.install_observation contract — an exec class overriding
    execute without riding the boundary shows up here, not as
    silently-missing tool data)."""
    from spark_rapids_tpu_torch.lint.golden import golden_tables
    from spark_rapids_tpu_torch.models.corpus import build_queries
    from spark_rapids_tpu_torch.obs.spans import finalize_observation
    from spark_rapids_tpu_torch.session import TorchSession

    tables = golden_tables(scale_factor)
    session = TorchSession(device=device)
    corpus = build_queries(session, tables)
    diags: List[Diagnostic] = []
    for name in queries:
        corpus[name]().collect_table()
        executable = session._last_executable
        finalize_observation(executable)
        audit_exec_metrics_tree(executable, diags, context=f"{name}:")
    return diags


#: declared keys consumed through a mechanism the text scan cannot see.
#: Add "key: why" entries, never bare keys — NEW keys must wire a reader.
_CONF_ORPHAN_ALLOWLIST: dict = {}


def _audit_conf_referenced(diags: List[Diagnostic], root: str) -> None:
    """RA-CONF-ORPHAN: every declared conf key must be CONSUMED by the
    engine or its harnesses — a key whose ConfEntry variable and key
    string both appear exactly once (their declaration) was added
    without wiring a reader, so setting it silently does nothing (the
    complement of RL-CONF-KEY, which catches references without a
    declaration). The per-op kill switches are read generically by
    name and are not declared."""
    import collections
    import re

    from spark_rapids_tpu_torch.conf import ConfEntry, registry
    from spark_rapids_tpu_torch.lint.rules.common import _iter_source_files

    # the texts a key may be read from: the port's modules and the card
    # script, counted in one pass each: every maximal dotted spark.*
    # token (boundary-aware: 'a.b' is not counted inside 'a.b.c', or a
    # key that is a dotted prefix of another declared key would count its
    # sibling's declaration as a reference) and every identifier
    text = "\n".join(open(p, encoding="utf-8").read()
                     for p in _iter_source_files(root))
    key_tokens = collections.Counter(
        re.findall(r"spark\.[\w.]*\w(?![.\w])", text))
    name_tokens = collections.Counter(re.findall(r"\w+", text))

    #: key -> ConfEntry variable names bound in any module of the port
    var_names: dict = {}
    for mod_name, mod in list(sys.modules.items()):
        if not mod_name.startswith("spark_rapids_tpu_torch") or mod is None:
            continue
        for attr, val in list(vars(mod).items()):
            if isinstance(val, ConfEntry):
                var_names.setdefault(val.key, set()).add(attr)

    for key in registry():
        if key in _CONF_ORPHAN_ALLOWLIST:
            continue
        key_uses = key_tokens[key]
        name_uses = sum(name_tokens[n] for n in var_names.get(key, ()))
        # one key-string occurrence (the declaration) + one occurrence
        # per variable binding (assignment/import) is declaration-only
        if key_uses <= 1 and name_uses <= len(var_names.get(key, ())):
            diags.append(make(
                "RA-CONF-ORPHAN", key,
                "conf key is declared but never read — wire a consumer "
                "or remove it (allowlist with a justification if it is "
                "consumed through a mechanism this scan cannot see)"))


def audit_registry(repo_root: Optional[str] = None) -> List[Diagnostic]:
    # every registration made at import (file scans, conf keys, metrics,
    # expression classes) must be present
    from spark_rapids_tpu_torch.conf import _import_package
    _import_package()
    root = _repo_root(repo_root)
    diags: List[Diagnostic] = []
    _audit_unregistered(diags)
    _audit_param_arity(diags)
    _audit_kill_switches(diags)
    _audit_sql_exposure(diags)
    _audit_doc_drift(diags, root)
    _audit_conf_referenced(diags, root)
    return diags
