"""SQL lexer: text -> position-annotated token stream (a copy of
``spark_rapids_tpu/sql/lexer.py``).

Hand-written (no re-based scanner tables) so every token carries its
1-based (line, col) and error messages can point into the query text the
way Spark's ParseException does. Keywords are case-insensitive;
identifiers keep their original spelling (the plan layer is
case-sensitive, matching this engine's DataFrame API)."""

from __future__ import annotations

from typing import List, NamedTuple, Optional

from spark_rapids_tpu_torch.sql.errors import SqlParseError

# token kinds
IDENT = "IDENT"          # bare or `quoted` identifier
NUMBER = "NUMBER"        # value holds (python value, is_decimal_suffix)
STRING = "STRING"        # single-quoted literal, unescaped
OP = "OP"                # punctuation / operator
HINT = "HINT"            # /*+ ... */ contents
EOF = "EOF"

#: IDENT token value marking a backtick/double-quoted identifier — the
#: parser never treats a quoted identifier as a keyword, so reserved
#: words stay usable as column/table names (`order`, `from`, ...)
QUOTED = "quoted-ident"

#: multi-char operators, longest first
_OPS = ["<=>", "<>", "!=", "<=", ">=", "||", "==",
        "(", ")", ",", ".", "+", "-", "*", "/", "%", "<", ">", "=", ";"]


class Token(NamedTuple):
    kind: str
    text: str            # raw text (uppercased for keyword checks by parser)
    value: object        # parsed value for NUMBER/STRING
    line: int
    col: int

    def upper(self) -> str:
        return self.text.upper()


def _is_ident_start(c: str) -> bool:
    return c.isalpha() or c == "_"


def _is_ident_part(c: str) -> bool:
    return c.isalnum() or c == "_"


def tokenize(sql: str) -> List[Token]:
    toks: List[Token] = []
    i, n = 0, len(sql)
    line, col = 1, 1

    def err(msg: str, ln: int, cl: int) -> SqlParseError:
        return SqlParseError(msg, sql, ln, cl)

    def advance(k: int) -> None:
        nonlocal i, line, col
        for _ in range(k):
            if i < n and sql[i] == "\n":
                line += 1
                col = 1
            else:
                col += 1
            i += 1

    while i < n:
        c = sql[i]
        if c in " \t\r\n":
            advance(1)
            continue
        # comments: -- to end of line; /* ... */ (a /*+ ... */ is a HINT)
        if sql.startswith("--", i):
            while i < n and sql[i] != "\n":
                advance(1)
            continue
        if sql.startswith("/*", i):
            ln, cl = line, col
            is_hint = sql.startswith("/*+", i)
            end = sql.find("*/", i + 2)
            if end < 0:
                raise err("unterminated comment", ln, cl)
            if is_hint:
                toks.append(Token(HINT, sql[i + 3:end].strip(), None, ln, cl))
            advance(end + 2 - i)
            continue
        if c == "'":
            ln, cl = line, col
            advance(1)
            buf = []
            while True:
                if i >= n:
                    raise err("unterminated string literal", ln, cl)
                if sql[i] == "'":
                    if i + 1 < n and sql[i + 1] == "'":  # '' escape
                        buf.append("'")
                        advance(2)
                        continue
                    advance(1)
                    break
                if sql[i] == "\\" and i + 1 < n:  # backslash escapes
                    nxt = sql[i + 1]
                    buf.append({"n": "\n", "t": "\t"}.get(nxt, nxt))
                    advance(2)
                    continue
                buf.append(sql[i])
                advance(1)
            toks.append(Token(STRING, "'...'", "".join(buf), ln, cl))
            continue
        if c in "`\"":  # quoted identifier
            ln, cl = line, col
            quote = c
            advance(1)
            start = i
            while i < n and sql[i] != quote:
                advance(1)
            if i >= n:
                raise err("unterminated quoted identifier", ln, cl)
            toks.append(Token(IDENT, sql[start:i], QUOTED, ln, cl))
            advance(1)
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            ln, cl = line, col
            start = i
            seen_dot = seen_exp = False
            while i < n:
                ch = sql[i]
                if ch.isdigit():
                    advance(1)
                elif ch == "." and not seen_dot and not seen_exp:
                    # `1.foo` is member access on a number? no — numbers
                    # never precede idents here; a dot followed by a digit
                    # continues the number
                    seen_dot = True
                    advance(1)
                elif ch in "eE" and not seen_exp and i + 1 < n and (
                        sql[i + 1].isdigit()
                        or (sql[i + 1] in "+-" and i + 2 < n
                            and sql[i + 2].isdigit())):
                    seen_exp = True
                    advance(2 if sql[i + 1] in "+-" else 1)
                else:
                    break
            text = sql[start:i]
            # Spark literal suffixes: L/l bigint, D/d double, BD decimal
            suffix = ""
            if i + 1 < n and sql[i:i + 2].upper() == "BD":
                suffix = "BD"
                advance(2)
            elif i < n and sql[i].upper() in ("L", "D") \
                    and not (i + 1 < n and _is_ident_part(sql[i + 1])):
                suffix = sql[i].upper()
                advance(1)
            if suffix == "BD":
                import decimal
                value = decimal.Decimal(text)
            elif suffix == "D" or seen_dot or seen_exp:
                value = float(text)
            else:
                value = int(text)
            toks.append(Token(NUMBER, text, value, ln, cl))
            continue
        if _is_ident_start(c):
            ln, cl = line, col
            start = i
            while i < n and _is_ident_part(sql[i]):
                advance(1)
            toks.append(Token(IDENT, sql[start:i], None, ln, cl))
            continue
        matched: Optional[str] = None
        for op in _OPS:
            if sql.startswith(op, i):
                matched = op
                break
        if matched is None:
            raise err(f"unexpected character {c!r}", line, col)
        toks.append(Token(OP, matched, None, line, col))
        advance(len(matched))
    toks.append(Token(EOF, "<eof>", None, line, col))
    return toks
