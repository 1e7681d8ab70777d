"""Recursive-descent SQL parser for the supported subset (a copy of
``spark_rapids_tpu/sql/parser.py``).

Grammar (hand-written, mirroring Spark's SELECT surface this engine can
lower):

  statement   := query | createView | dropView [;]
  createView  := CREATE [OR REPLACE] TEMP[ORARY] VIEW name
                 ( AS query | USING fmt OPTIONS '(' k 'v' [,...] ')' )
  query       := [WITH name AS '(' query ')' [,...]] setExpr
                 [ORDER BY sortItem [,...]] [LIMIT n]
  setExpr     := select (UNION [ALL|DISTINCT] select)*
  select      := SELECT [hint] [DISTINCT] item [,...] [FROM relation]
                 [WHERE expr] [GROUP BY expr [,...]] [HAVING expr]
               | '(' query ')'
  relation    := relPrimary (join)*
  join        := [INNER|LEFT|RIGHT|FULL [OUTER]|CROSS] JOIN relPrimary
                 [ON expr | USING '(' col [,...] ')']
  expr        := precedence-climbing over OR, AND, NOT, predicates
                 (=, <>, <, <=, >, >=, IS [NOT] NULL, [NOT] IN,
                 [NOT] LIKE/RLIKE, [NOT] BETWEEN), ||, additive,
                 multiplicative, unary -, primary
  primary     := literal | DATE/TIMESTAMP/INTERVAL literal | CAST(e AS t)
               | CASE ... END | fn '(' [DISTINCT] args ')' [OVER windowDef]
               | qualified ident | '(' expr ')' | '(' query ')'

Every production records its start position so SqlParseError points at
the offending token."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from spark_rapids_tpu_torch.sql import ast as A
from spark_rapids_tpu_torch.sql.errors import SqlParseError
from spark_rapids_tpu_torch.sql.lexer import (
    EOF,
    HINT,
    IDENT,
    NUMBER,
    OP,
    QUOTED,
    STRING,
    Token,
    tokenize,
)

#: words that terminate an expression/alias position (so `FROM t` never
#: parses FROM as an alias)
_RESERVED = {
    "SELECT", "FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT",
    "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "CROSS", "OUTER", "ON",
    "USING", "UNION", "ALL", "DISTINCT", "AS", "AND", "OR", "NOT", "IN",
    "IS", "NULL", "LIKE", "RLIKE", "BETWEEN", "CASE", "WHEN", "THEN",
    "ELSE", "END", "CAST", "OVER", "PARTITION", "BY", "ROWS", "RANGE",
    "WITH", "ASC", "DESC", "NULLS", "FIRST", "LAST", "EXISTS", "SEMI",
    "ANTI",
}

_INTERVAL_UNITS = {
    "YEAR": ("months", 12), "YEARS": ("months", 12),
    "MONTH": ("months", 1), "MONTHS": ("months", 1),
    "WEEK": ("days", 7), "WEEKS": ("days", 7),
    "DAY": ("days", 1), "DAYS": ("days", 1),
}


class Parser:
    def __init__(self, sql: str):
        self.sql = sql
        self.toks: List[Token] = tokenize(sql)
        self.pos = 0

    # -- token helpers -------------------------------------------------------
    def peek(self, ahead: int = 0) -> Token:
        i = min(self.pos + ahead, len(self.toks) - 1)
        return self.toks[i]

    def next(self) -> Token:
        t = self.peek()
        if t.kind != EOF:
            self.pos += 1
        return t

    def at_kw(self, *words: str) -> bool:
        t = self.peek()
        return t.kind == IDENT and t.value is not QUOTED \
            and t.upper() in words

    def eat_kw(self, *words: str) -> Optional[Token]:
        if self.at_kw(*words):
            return self.next()
        return None

    def expect_kw(self, word: str) -> Token:
        t = self.peek()
        if t.kind == IDENT and t.value is not QUOTED \
                and t.upper() == word:
            return self.next()
        raise self.err(f"expected {word}, found {t.text!r}", t)

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == OP and t.text in ops

    def eat_op(self, *ops: str) -> Optional[Token]:
        if self.at_op(*ops):
            return self.next()
        return None

    def expect_op(self, op: str) -> Token:
        t = self.peek()
        if t.kind == OP and t.text == op:
            return self.next()
        raise self.err(f"expected {op!r}, found {t.text!r}", t)

    def err(self, msg: str, tok: Optional[Token] = None) -> SqlParseError:
        t = tok or self.peek()
        return SqlParseError(msg, self.sql, t.line, t.col)

    @staticmethod
    def _at(node: A.Node, tok: Token) -> A.Node:
        node.line, node.col = tok.line, tok.col
        return node

    # -- statements ----------------------------------------------------------
    def parse_statement(self) -> A.Node:
        t = self.peek()
        if self.at_kw("CREATE"):
            stmt = self._create_view()
        elif self.at_kw("DROP"):
            stmt = self._drop_view()
        else:
            stmt = self.parse_query()
        self.eat_op(";")
        end = self.peek()
        if end.kind != EOF:
            raise self.err(f"unexpected input {end.text!r} after statement",
                           end)
        return self._at(stmt, t)

    def _create_view(self) -> A.Node:
        self.expect_kw("CREATE")
        replace = False
        if self.eat_kw("OR"):
            self.expect_kw("REPLACE")
            replace = True
        if not (self.eat_kw("TEMP") or self.eat_kw("TEMPORARY")):
            raise self.err("only TEMPORARY views are supported "
                           "(CREATE [OR REPLACE] TEMP VIEW ...)")
        self.expect_kw("VIEW")
        name = self._ident_token("view name").text
        if self.eat_kw("USING"):
            fmt = self._ident_token("format name").text
            options = {}
            if self.eat_kw("OPTIONS"):
                self.expect_op("(")
                while True:
                    k = self._ident_token("option key").text
                    v = self.peek()
                    if v.kind not in (STRING, NUMBER):
                        raise self.err("option value must be a literal", v)
                    self.next()
                    options[k] = v.value
                    if not self.eat_op(","):
                        break
                self.expect_op(")")
            return A.CreateView(name=name, replace=replace, using=fmt,
                                options=options)
        self.expect_kw("AS")
        return A.CreateView(name=name, replace=replace,
                            query=self.parse_query())

    def _drop_view(self) -> A.Node:
        self.expect_kw("DROP")
        self.expect_kw("VIEW")
        if_exists = False
        if self.eat_kw("IF"):
            self.expect_kw("EXISTS")
            if_exists = True
        return A.DropView(name=self._ident_token("view name").text,
                          if_exists=if_exists)

    def _ident_token(self, what: str) -> Token:
        t = self.peek()
        if t.kind != IDENT:
            raise self.err(f"expected {what}, found {t.text!r}", t)
        return self.next()

    # -- query ---------------------------------------------------------------
    def parse_query(self) -> A.Query:
        start = self.peek()
        ctes: List[Tuple[str, A.Query]] = []
        if self.eat_kw("WITH"):
            while True:
                name = self._ident_token("CTE name").text
                self.expect_kw("AS")
                self.expect_op("(")
                ctes.append((name, self.parse_query()))
                self.expect_op(")")
                if not self.eat_op(","):
                    break
        body = self._set_expr()
        order_by: List[A.SortItem] = []
        limit = None
        if self.eat_kw("ORDER"):
            self.expect_kw("BY")
            order_by = self._sort_items()
        if self.eat_kw("LIMIT"):
            t = self.peek()
            if t.kind != NUMBER or not isinstance(t.value, int):
                raise self.err("LIMIT takes an integer literal", t)
            self.next()
            limit = t.value
        q = A.Query(ctes=ctes, body=body, order_by=order_by, limit=limit)
        return self._at(q, start)

    def _set_expr(self) -> A.Node:
        left = self._select_core()
        while self.at_kw("UNION"):
            t = self.next()
            op = "union"
            if self.eat_kw("ALL"):
                op = "unionall"
            elif self.eat_kw("DISTINCT"):
                op = "union"
            right = self._select_core()
            left = self._at(A.SetOp(op=op, left=left, right=right), t)
        return left

    def _select_core(self) -> A.Node:
        if self.at_op("("):
            # parenthesized query as a set-operand
            t = self.next()
            q = self.parse_query()
            self.expect_op(")")
            return self._at(q, t)
        start = self.expect_kw("SELECT")
        hints: List[Tuple[str, Sequence[str]]] = []
        while self.peek().kind == HINT:
            hints.extend(self._parse_hint(self.next()))
        distinct = bool(self.eat_kw("DISTINCT"))
        self.eat_kw("ALL")
        items: List[A.Node] = []
        while True:
            items.append(self._select_item())
            if not self.eat_op(","):
                break
        from_ = None
        if self.eat_kw("FROM"):
            from_ = self._relation()
        where = None
        if self.eat_kw("WHERE"):
            where = self.parse_expr()
        group_by: List[A.Node] = []
        if self.eat_kw("GROUP"):
            self.expect_kw("BY")
            while True:
                group_by.append(self.parse_expr())
                if not self.eat_op(","):
                    break
        having = None
        if self.eat_kw("HAVING"):
            having = self.parse_expr()
        sel = A.Select(distinct=distinct, hints=hints, items=items,
                       from_=from_, where=where, group_by=group_by,
                       having=having)
        return self._at(sel, start)

    def _parse_hint(self, tok: Token) -> List[Tuple[str, Sequence[str]]]:
        """`REPARTITION(8, col)` style hints inside /*+ ... */."""
        sub = Parser(tok.text)
        out: List[Tuple[str, Sequence[str]]] = []
        while sub.peek().kind == IDENT:
            name = sub.next().upper()
            args: List[str] = []
            if sub.eat_op("("):
                while not sub.at_op(")"):
                    a = sub.next()
                    if a.kind == EOF:
                        raise self.err("unterminated hint", tok)
                    if a.kind in (IDENT, NUMBER):
                        args.append(a.text)
                    else:
                        raise self.err(
                            f"unsupported hint argument {a.text!r} "
                            "(identifiers and integers only)", tok)
                    sub.eat_op(",")
                sub.expect_op(")")
            out.append((name, args))
            sub.eat_op(",")
        return out

    def _select_item(self) -> A.Node:
        t = self.peek()
        if self.at_op("*"):
            self.next()
            return self._at(A.Star(), t)
        # tbl.* star
        if (t.kind == IDENT
                and (t.value is QUOTED or t.upper() not in _RESERVED)
                and self.peek(1).kind == OP and self.peek(1).text == "."
                and self.peek(2).kind == OP and self.peek(2).text == "*"):
            self.next(), self.next(), self.next()
            return self._at(A.Star(qualifier=t.text), t)
        e = self.parse_expr()
        alias = None
        if self.eat_kw("AS"):
            alias = self._ident_token("alias").text
        elif (self.peek().kind == IDENT
              and (self.peek().value is QUOTED
                   or self.peek().upper() not in _RESERVED)):
            alias = self.next().text
        return self._at(A.SelectItem(expr=e, alias=alias), t)

    def _sort_items(self) -> List[A.SortItem]:
        out: List[A.SortItem] = []
        while True:
            t = self.peek()
            e = self.parse_expr()
            asc = True
            if self.eat_kw("ASC"):
                asc = True
            elif self.eat_kw("DESC"):
                asc = False
            nulls_first = None
            if self.eat_kw("NULLS"):
                if self.eat_kw("FIRST"):
                    nulls_first = True
                elif self.eat_kw("LAST"):
                    nulls_first = False
                else:
                    raise self.err("expected FIRST or LAST after NULLS")
            out.append(self._at(
                A.SortItem(expr=e, ascending=asc, nulls_first=nulls_first),
                t))
            if not self.eat_op(","):
                break
        return out

    # -- relations -----------------------------------------------------------
    def _relation(self) -> A.Node:
        left = self._rel_primary()
        while True:
            t = self.peek()
            how = None
            if self.at_kw("JOIN"):
                how = "inner"
                self.next()
            elif self.at_kw("INNER"):
                self.next()
                self.expect_kw("JOIN")
                how = "inner"
            elif self.at_kw("CROSS"):
                self.next()
                self.expect_kw("JOIN")
                how = "cross"
            elif self.at_kw("LEFT", "RIGHT", "FULL"):
                how = self.next().upper().lower()
                if not self.eat_kw("OUTER"):
                    # LEFT SEMI / LEFT ANTI
                    if how == "left" and self.eat_kw("SEMI"):
                        how = "leftsemi"
                    elif how == "left" and self.eat_kw("ANTI"):
                        how = "leftanti"
                self.expect_kw("JOIN")
            else:
                return left
            right = self._rel_primary()
            on = None
            using: Sequence[str] = ()
            if how != "cross":
                if self.eat_kw("ON"):
                    on = self.parse_expr()
                elif self.eat_kw("USING"):
                    self.expect_op("(")
                    cols = [self._ident_token("join column").text]
                    while self.eat_op(","):
                        cols.append(self._ident_token("join column").text)
                    self.expect_op(")")
                    using = cols
                else:
                    raise self.err(
                        f"{how.upper()} JOIN requires ON or USING", t)
            left = self._at(A.JoinRel(left=left, right=right, how=how,
                                      on=on, using=using), t)

    def _rel_primary(self) -> A.Node:
        t = self.peek()
        if self.eat_op("("):
            q = self.parse_query()
            self.expect_op(")")
            alias = self._maybe_alias()
            return self._at(A.SubqueryRef(query=q, alias=alias), t)
        name = self._ident_token("table name").text
        return self._at(A.TableRef(name=name, alias=self._maybe_alias()), t)

    def _maybe_alias(self) -> Optional[str]:
        if self.eat_kw("AS"):
            return self._ident_token("alias").text
        t = self.peek()
        if t.kind == IDENT and (t.value is QUOTED
                                or t.upper() not in _RESERVED):
            return self.next().text
        return None

    # -- expressions ---------------------------------------------------------
    def parse_expr(self) -> A.Node:
        return self._or_expr()

    def _or_expr(self) -> A.Node:
        left = self._and_expr()
        while self.at_kw("OR"):
            t = self.next()
            left = self._at(A.BinOp(op="OR", left=left,
                                    right=self._and_expr()), t)
        return left

    def _and_expr(self) -> A.Node:
        left = self._not_expr()
        while self.at_kw("AND"):
            t = self.next()
            left = self._at(A.BinOp(op="AND", left=left,
                                    right=self._not_expr()), t)
        return left

    def _not_expr(self) -> A.Node:
        if self.at_kw("NOT"):
            t = self.next()
            return self._at(A.UnOp(op="NOT", operand=self._not_expr()), t)
        return self._predicate()

    def _predicate(self) -> A.Node:
        left = self._additive()
        t = self.peek()
        if t.kind == OP and t.text in ("=", "==", "<>", "!=", "<", "<=",
                                       ">", ">=", "<=>"):
            self.next()
            op = {"==": "=", "!=": "<>"}.get(t.text, t.text)
            right = self._additive()
            return self._at(A.BinOp(op=op, left=left, right=right), t)
        if self.at_kw("IS"):
            t = self.next()
            negated = bool(self.eat_kw("NOT"))
            self.expect_kw("NULL")
            return self._at(A.IsNull(operand=left, negated=negated), t)
        negated = False
        if self.at_kw("NOT") and self.peek(1).kind == IDENT and \
                self.peek(1).upper() in ("IN", "LIKE", "RLIKE", "BETWEEN"):
            self.next()
            negated = True
        if self.at_kw("IN"):
            t = self.next()
            self.expect_op("(")
            if self.at_kw("SELECT", "WITH"):
                q = self.parse_query()
                self.expect_op(")")
                return self._at(A.InSubquery(operand=left, query=q,
                                             negated=negated), t)
            items = [self.parse_expr()]
            while self.eat_op(","):
                items.append(self.parse_expr())
            self.expect_op(")")
            return self._at(A.InList(operand=left, items=items,
                                     negated=negated), t)
        if self.at_kw("LIKE", "RLIKE"):
            t = self.next()
            kind = t.upper().lower()
            return self._at(A.LikeOp(kind=kind, operand=left,
                                     pattern=self._additive(),
                                     negated=negated), t)
        if self.at_kw("BETWEEN"):
            t = self.next()
            low = self._additive()
            self.expect_kw("AND")
            high = self._additive()
            return self._at(A.Between(operand=left, low=low, high=high,
                                      negated=negated), t)
        if negated:
            raise self.err("expected IN, LIKE, RLIKE or BETWEEN after NOT")
        return left

    def _additive(self) -> A.Node:
        left = self._multiplicative()
        while self.at_op("+", "-", "||"):
            t = self.next()
            left = self._at(A.BinOp(op=t.text, left=left,
                                    right=self._multiplicative()), t)
        return left

    def _multiplicative(self) -> A.Node:
        left = self._unary()
        while self.at_op("*", "/", "%"):
            t = self.next()
            left = self._at(A.BinOp(op=t.text, left=left,
                                    right=self._unary()), t)
        return left

    def _unary(self) -> A.Node:
        if self.at_op("-"):
            t = self.next()
            return self._at(A.UnOp(op="-", operand=self._unary()), t)
        if self.at_op("+"):
            self.next()
            return self._unary()
        return self._primary()

    def _primary(self) -> A.Node:
        t = self.peek()
        if t.kind == NUMBER:
            self.next()
            return self._at(A.Literal(value=t.value), t)
        if t.kind == STRING:
            self.next()
            return self._at(A.Literal(value=t.value), t)
        if self.at_op("("):
            self.next()
            if self.at_kw("SELECT", "WITH"):
                q = self.parse_query()
                self.expect_op(")")
                return self._at(A.ScalarSubquery(query=q), t)
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if t.kind != IDENT:
            raise self.err(f"unexpected {t.text!r} in expression", t)
        if t.value is QUOTED:
            # quoted identifiers are never keywords or literals:
            # `order`, `null`, `case` reference columns with those names
            if self.peek(1).kind == OP and self.peek(1).text == "(":
                return self._func_call()
            self.next()
            parts = [t.text]
            while self.at_op(".") and self.peek(1).kind == IDENT:
                self.next()
                parts.append(self.next().text)
            return self._at(A.Ident(parts=tuple(parts)), t)
        word = t.upper()
        if word == "NULL":
            self.next()
            return self._at(A.Literal(value=None), t)
        if word in ("TRUE", "FALSE"):
            self.next()
            return self._at(A.Literal(value=word == "TRUE"), t)
        if word in ("DATE", "TIMESTAMP") and self.peek(1).kind == STRING:
            self.next()
            s = self.next()
            return self._at(A.TypedLiteral(kind=word.lower(),
                                           text=s.value), t)
        if word == "INTERVAL":
            return self._interval()
        if word == "CAST":
            self.next()
            self.expect_op("(")
            e = self.parse_expr()
            self.expect_kw("AS")
            tn = self._type_name()
            self.expect_op(")")
            return self._at(A.Cast(operand=e, type_name=tn), t)
        if word == "CASE":
            return self._case()
        if word == "EXISTS" and self.peek(1).kind == OP \
                and self.peek(1).text == "(":
            raise self.err("EXISTS subqueries are not supported by the "
                           "SQL front end: use an IN subquery or a "
                           "LEFT SEMI JOIN", t)
        # function call?
        if self.peek(1).kind == OP and self.peek(1).text == "(" \
                and word not in _RESERVED:
            return self._func_call()
        # qualified / bare identifier
        if word in _RESERVED:
            raise self.err(f"unexpected keyword {t.text!r} in expression", t)
        self.next()
        parts = [t.text]
        while self.at_op(".") and self.peek(1).kind == IDENT:
            self.next()
            parts.append(self.next().text)
        return self._at(A.Ident(parts=tuple(parts)), t)

    def _interval(self) -> A.Node:
        t = self.expect_kw("INTERVAL")
        months = days = 0
        saw = False
        while self.peek().kind == NUMBER or (
                self.at_op("-") and self.peek(1).kind == NUMBER):
            sign = 1
            if self.eat_op("-"):
                sign = -1
            num = self.next()
            if not isinstance(num.value, int):
                raise self.err("interval quantity must be an integer", num)
            unit = self.peek()
            if unit.kind != IDENT or unit.upper() not in _INTERVAL_UNITS:
                raise self.err(
                    f"unsupported interval unit {unit.text!r} (supported: "
                    "YEAR/MONTH/WEEK/DAY)", unit)
            self.next()
            field, mult = _INTERVAL_UNITS[unit.upper()]
            if field == "months":
                months += sign * num.value * mult
            else:
                days += sign * num.value * mult
            saw = True
        if not saw:
            raise self.err("INTERVAL requires '<n> <unit>'", t)
        return self._at(A.IntervalLiteral(months=months, days=days), t)

    def _case(self) -> A.Node:
        t = self.expect_kw("CASE")
        operand = None
        if not self.at_kw("WHEN"):
            operand = self.parse_expr()
        branches = []
        while self.eat_kw("WHEN"):
            c = self.parse_expr()
            self.expect_kw("THEN")
            v = self.parse_expr()
            branches.append((c, v))
        if not branches:
            raise self.err("CASE requires at least one WHEN branch", t)
        else_value = None
        if self.eat_kw("ELSE"):
            else_value = self.parse_expr()
        self.expect_kw("END")
        return self._at(A.Case(operand=operand, branches=branches,
                               else_value=else_value), t)

    def _type_name(self) -> str:
        t = self._ident_token("type name")
        name = t.text
        if self.at_op("("):  # decimal(p, s) / varchar(n)
            self.next()
            args = []
            while not self.at_op(")"):
                a = self.next()
                if a.kind == EOF:
                    raise self.err("unterminated type arguments", t)
                if a.kind == NUMBER:
                    args.append(a.text)
                self.eat_op(",")
            self.expect_op(")")
            name += "(" + ", ".join(args) + ")"
        return name

    def _func_call(self) -> A.Node:
        t = self.next()
        name = t.text
        self.expect_op("(")
        distinct = bool(self.eat_kw("DISTINCT"))
        args: List[A.Node] = []
        if not self.at_op(")"):
            while True:
                if self.at_op("*"):
                    st = self.next()
                    args.append(self._at(A.Star(), st))
                else:
                    args.append(self.parse_expr())
                if not self.eat_op(","):
                    break
        self.expect_op(")")
        window = None
        if self.at_kw("OVER"):
            self.next()
            window = self._window_def()
        return self._at(A.FuncCall(name=name, args=args, distinct=distinct,
                                   window=window), t)

    def _window_def(self) -> A.WindowDef:
        t = self.expect_op("(")
        partition: List[A.Node] = []
        order: List[A.SortItem] = []
        frame = None
        if self.eat_kw("PARTITION"):
            self.expect_kw("BY")
            while True:
                partition.append(self.parse_expr())
                if not self.eat_op(","):
                    break
        if self.eat_kw("ORDER"):
            self.expect_kw("BY")
            order = self._sort_items()
        if self.at_kw("ROWS", "RANGE"):
            kind = self.next().upper().lower()
            if self.eat_kw("BETWEEN"):
                t_lo = self.peek()
                lo = self._frame_bound()
                self.expect_kw("AND")
                t_hi = self.peek()
                hi = self._frame_bound()
            else:
                t_lo = t_hi = self.peek()
                lo = self._frame_bound()
                hi = 0
            # Spark rejects backwards unbounded frames at parse time;
            # collapsing both directions to None would silently compute
            # a running aggregate instead
            if lo == "unb_following":
                raise self.err("UNBOUNDED FOLLOWING is not a valid frame "
                               "START bound", t_lo)
            if hi == "unb_preceding":
                raise self.err("UNBOUNDED PRECEDING is not a valid frame "
                               "END bound", t_hi)
            lo = None if lo == "unb_preceding" else lo
            hi = None if hi == "unb_following" else hi
            frame = (kind, lo, hi)
        self.expect_op(")")
        w = A.WindowDef(partition_by=partition, order_by=order, frame=frame)
        return self._at(w, t)

    def _frame_bound(self):
        """int offset, 0 for CURRENT ROW, or the direction-preserving
        sentinels 'unb_preceding'/'unb_following' (validated by the
        caller — which side UNBOUNDED is legal on depends on position)."""
        if self.eat_kw("UNBOUNDED"):
            if self.eat_kw("PRECEDING"):
                return "unb_preceding"
            if self.eat_kw("FOLLOWING"):
                return "unb_following"
            raise self.err(
                "expected PRECEDING or FOLLOWING after UNBOUNDED")
        if self.eat_kw("CURRENT"):
            self.expect_kw("ROW")
            return 0
        t = self.peek()
        if t.kind != NUMBER or not isinstance(t.value, int):
            raise self.err("frame bound must be UNBOUNDED, CURRENT ROW or "
                           "an integer", t)
        self.next()
        if self.eat_kw("PRECEDING"):
            return -t.value
        if self.eat_kw("FOLLOWING"):
            return t.value
        raise self.err("expected PRECEDING or FOLLOWING after frame offset")


def parse_statement(sql: str) -> A.Node:
    return Parser(sql).parse_statement()


def parse_expression(sql: str) -> A.Node:
    """Parse a standalone SQL expression (F.expr analog)."""
    p = Parser(sql)
    e = p.parse_expr()
    end = p.peek()
    if end.kind != EOF:
        raise p.err(f"unexpected input {end.text!r} after expression", end)
    return e
