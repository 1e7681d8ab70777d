"""RL-WRITE-COMMIT (port of ``spark_rapids_tpu/lint/rules/io_write.py``)
— the exactly-once write contract holds only if every byte of table
output stages through the transactional committer (io/committer.py): in
``io/`` modules, file-creating calls (write-mode ``open``,
``*.write_table``, ``*.write_csv``) may appear only inside the
``_write_one`` staged-path callbacks, and ``os.replace``/``os.rename``
promotion belongs to the committer alone. ``committer.py`` itself and
``filecache.py`` (cache files are not table output) are exempt."""

from __future__ import annotations

import ast
from typing import List

from spark_rapids_tpu_torch.lint.diagnostics import Diagnostic, make
from spark_rapids_tpu_torch.lint.rules.common import PACKAGE, _attr_chain

#: io/ modules exempt from RL-WRITE-COMMIT: the committer IS the
#: sanctioned writer, the file cache's files are not table output, and
#: the port's own format encoders (the reference's pyarrow writers) write
#: the path their caller hands them — the rule holds those callers
#: (``*.write_table`` outside a ``_write_one`` callback)
_WRITE_COMMIT_EXEMPT = (f"{PACKAGE}/io/committer.py",
                        f"{PACKAGE}/io/filecache.py",
                        f"{PACKAGE}/io/parquet_format.py",
                        f"{PACKAGE}/io/orc_format.py",
                        f"{PACKAGE}/io/parquet_records.py")

#: the sanctioned callback name: write_partitioned hands these a
#: committer staging path, never a final destination
_WRITE_ONE = "_write_one"


def _open_mode_writes(node: ast.Call) -> bool:
    """Is this an ``open()`` call with a write/append/exclusive mode?
    A non-literal mode is treated as writing (it would dodge the
    audit)."""
    mode = None
    if len(node.args) >= 2:
        mode = node.args[1]
    for kw in node.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if mode is None:
        return False  # default 'r'
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
        return any(c in mode.value for c in "wxa")
    return True


def _check_write_commit(rel: str, tree: ast.AST,
                        diags: List[Diagnostic]):
    if not rel.startswith(f"{PACKAGE}/io/") \
            or rel in _WRITE_COMMIT_EXEMPT:
        return

    def walk(node, in_write_one: bool):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            in_write_one = in_write_one or node.name == _WRITE_ONE
        if isinstance(node, ast.Call):
            chain = _attr_chain(node.func)
            if chain in ("os.replace", "os.rename"):
                diags.append(make(
                    "RL-WRITE-COMMIT", f"{rel}:{node.lineno}",
                    f"{chain}() in an io/ writer module — promotion "
                    "into final destinations is the committer's job "
                    "(io/committer.py)"))
            elif not in_write_one and (
                    chain.endswith((".write_table", ".write_csv"))
                    or (chain == "open" and _open_mode_writes(node))):
                diags.append(make(
                    "RL-WRITE-COMMIT", f"{rel}:{node.lineno}",
                    f"{chain}() creates an output file outside a "
                    f"{_WRITE_ONE} staged-path callback — table "
                    "output must stage through the transactional "
                    "committer, never open a final destination"))
        for child in ast.iter_child_nodes(node):
            walk(child, in_write_one)

    walk(tree, False)
