"""SQL front-end errors with position annotation (a copy of
``spark_rapids_tpu/sql/errors.py``).

Spark's ParseException / AnalysisException carry the failing line/column
plus a caret snippet of the query text; these do the same. Both error
classes derive from ColumnarProcessingError so callers that catch engine
errors keep working.
"""

from __future__ import annotations

from spark_rapids_tpu_torch.errors import ColumnarProcessingError


def annotate(sql: str, line: int, col: int, msg: str) -> str:
    """Message + the offending line with a caret under (line, col).
    Positions are 1-based (the lexer's convention)."""
    lines = sql.splitlines() or [""]
    out = [msg, f"(line {line}, pos {col})"]
    if 1 <= line <= len(lines):
        out.append(lines[line - 1])
        out.append(" " * (col - 1) + "^")
    return "\n".join(out)


class SqlError(ColumnarProcessingError):
    """Base for parse/analysis errors; carries the 1-based position."""

    def __init__(self, msg: str, sql: str = "", line: int = 0, col: int = 0):
        self.raw_msg = msg
        self.line = line
        self.col = col
        super().__init__(annotate(sql, line, col, msg) if sql else msg)


class SqlParseError(SqlError):
    """Lexer/parser rejection (ParseException analog)."""


class SqlAnalysisError(SqlError):
    """Binder/lowering rejection (AnalysisException analog): unresolved
    identifiers, bad function arity, constructs outside the supported
    subset. Unsupported constructs name themselves the way overrides
    fallback reasons do ("<construct> is not supported ...")."""


def unsupported(construct: str, reason: str, sql: str = "",
                line: int = 0, col: int = 0) -> SqlAnalysisError:
    """Per-construct rejection, in the overrides' explain style
    (`! <node>  <-- <reason>`)."""
    return SqlAnalysisError(
        f"{construct} is not supported by the SQL front end: {reason}",
        sql, line, col)
