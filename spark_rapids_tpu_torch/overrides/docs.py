"""Supported-operators documentation generator (port of
``spark_rapids_tpu/overrides/docs.py``, the reference's TypeChecks.scala
``supported_ops.md``): the per-operator type-support matrix, built from
the same registries the tagging reads (overrides/rules.py's device
nodes, file scans, ``_EXPR_SIGS`` and ``_EXPR_CHECKS``), so the document
cannot drift from the fallbacks. ``generate_supported_ops()`` returns it
as a string; the port commits no copy."""

from __future__ import annotations

from typing import List

from spark_rapids_tpu_torch import types as T

#: one probe type per column: a signature supports the column iff it
#: supports this type
_TYPE_COLUMNS = [
    ("BOOLEAN", T.BOOLEAN),
    ("BYTE", T.BYTE),
    ("SHORT", T.SHORT),
    ("INT", T.INT),
    ("LONG", T.LONG),
    ("FLOAT", T.FLOAT),
    ("DOUBLE", T.DOUBLE),
    ("DATE", T.DATE),
    ("TIMESTAMP", T.TIMESTAMP),
    ("STRING", T.STRING),
    ("DECIMAL", T.DecimalType(18, 2)),
    ("DECIMAL128", T.DecimalType(38, 2)),
    ("ARRAY", T.ArrayType(T.LONG)),
    ("MAP", T.MapType(T.LONG, T.DOUBLE)),
    ("STRUCT", T.StructType([T.StructField("f", T.LONG)])),
]

#: plan node class -> the output TypeSig its tag checks
_EXEC_SIGS = {}


def register_exec_sig(node_cls, sig) -> None:
    _EXEC_SIGS[node_cls] = sig


def _matrix_row(name: str, sig, notes: str = "") -> str:
    cells = ["S" if sig.supports(probe) else "NS"
             for _, probe in _TYPE_COLUMNS]
    return "| " + name + " | " + " | ".join(cells) + " | " + notes + " |"


def generate_supported_ops() -> str:
    """The matrix as markdown: one row per exec, one per expression (and
    per parameter where per-parameter checks exist), an S or NS cell per
    type column."""
    import spark_rapids_tpu_torch.io  # noqa: F401 (registers the scans)
    from spark_rapids_tpu_torch.overrides import rules as R
    from spark_rapids_tpu_torch.overrides.typesig import (
        COMMON_128,
        lookup_mro,
    )
    R._build_expr_sigs()
    header = ("| Operator | " + " | ".join(n for n, _ in _TYPE_COLUMNS)
              + " | Notes |")
    sep = "|" + "---|" * (len(_TYPE_COLUMNS) + 2)
    lines: List[str] = [
        "# Supported operators and types",
        "",
        "Generated from the overrides registries "
        "(`spark_rapids_tpu_torch.overrides.docs.generate_supported_ops`): "
        "the same `TypeSig` objects drive the tags that send a node to the "
        "CPU route. `S` = runs on the GPU for that type; `NS` = the "
        "operator (or its column of that type) runs on the CPU route. "
        "Every operator also has a kill switch "
        "`spark.rapids.sql.exec.<Name>` / "
        "`spark.rapids.sql.expression.<Name>`.",
        "",
        "## Execs",
        "",
        header,
        sep,
    ]
    for node_cls in sorted(set(R._DEVICE_NODES) | R._FILE_SCANS,
                           key=lambda c: c.__name__):
        lines.append(_matrix_row(node_cls.__name__,
                                 _EXEC_SIGS.get(node_cls, COMMON_128)))
    lines += ["", "## Expressions", "", header, sep]
    for cls, sig in sorted(R._EXPR_SIGS.items(),
                           key=lambda kv: kv[0].__name__):
        checks = lookup_mro(R._EXPR_CHECKS, cls)
        if checks is None:
            lines.append(_matrix_row(cls.__name__, sig))
            continue
        lines.append(_matrix_row(f"{cls.__name__} / result", sig))
        for label, psig in checks.doc_param_rows():
            lines.append(_matrix_row(f"{cls.__name__} / {label}", psig))
    lines.append("")
    return "\n".join(lines)
