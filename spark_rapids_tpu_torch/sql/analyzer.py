"""Analyzer/binder: untyped SQL AST -> the existing DataFrame/plan layer
(port of ``spark_rapids_tpu/sql/analyzer.py``).

Every lowered query flows through the SAME plan nodes the DataFrame API
builds (Project/Filter/Aggregate/Join/WindowNode/...), so the overrides
engine tags, falls back, and converts SQL queries exactly as it does DSL
queries — there is no parallel execution path. The analyzer's jobs:

  * resolve table names against the session catalog (temp views, file
    tables via the sources SPI) and CTEs;
  * resolve column identifiers (optionally alias-qualified) against the
    in-scope relation schemas;
  * resolve function names through sql.registry (builtins from
    functions.py, registered Python UDFs, Hive UDFs);
  * lower SELECT semantics in Spark's phase order — FROM, WHERE,
    GROUP BY/HAVING, window functions, projection, DISTINCT, set ops,
    ORDER BY, LIMIT — while ELIDING identity projections so a SQL query
    and its DSL form produce the same plan shape (and hence the same
    device dispatch count);
  * rewrite IN (subquery) to a left-semi/anti join and uncorrelated
    scalar subqueries to a cross join + hidden column (Spark's own
    rewrites), because the plan layer has no subquery nodes.

Unsupported constructs raise SqlAnalysisError with the query position
and an overrides-style per-construct reason.

In the port, a construct whose plan node exists lowers exactly as in the
reference and runs as the DSL's form does (outer, semi, anti and cross
joins, join conditions, IN and NOT IN and scalar subqueries, a bare
LIMIT, UNION [ALL | DISTINCT], SELECT without FROM over the reference's
one-row range); where the reference falls back to its CPU (an outer,
semi or anti join with equi keys plus a residual condition), the
overrides raise at collect. A construct whose node or expression the
port lacks raises NotImplementedError naming it while it is lowered:
DATE +/- INTERVAL, LIKE/RLIKE and ``||``."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.ops import aggregates as agg
from spark_rapids_tpu_torch.ops.expr import (
    Alias,
    AttributeReference,
    Expression,
    Literal,
    col,
    lit,
    output_name,
)
from spark_rapids_tpu_torch.plan import nodes as P
from spark_rapids_tpu_torch.sql import ast as A
from spark_rapids_tpu_torch.sql import registry
from spark_rapids_tpu_torch.sql.errors import SqlAnalysisError, unsupported


class Scope:
    """In-scope relation: the lowered DataFrame plus per-relation-alias
    {logical name -> physical plan column} maps for qualified-name
    resolution. The plan layer binds AttributeReferences BY NAME over
    the concatenated join schema, so when both join sides carry a
    column `x` the right copy is renamed to a fresh physical name; the
    alias map and ``display`` keep the SQL-level names addressable."""

    def __init__(self, df,
                 aliases: Optional[Dict[str, Dict[str, str]]] = None,
                 visible: Optional[List[str]] = None,
                 display: Optional[Dict[str, str]] = None):
        self.df = df
        self.aliases = aliases or {}
        #: columns star-expansion may see (hides scalar-subquery helpers)
        self.visible = visible if visible is not None else self.columns
        #: physical -> SQL-level name for star expansion of renamed
        #: right-side join duplicates
        self.display = display or {}

    @property
    def columns(self) -> List[str]:
        return [n for n, _ in self.df.plan.output_schema()]

    def with_df(self, df) -> "Scope":
        return Scope(df, self.aliases, self.visible, self.display)


class Analyzer:
    def __init__(self, session, sql_text: str):
        self.session = session
        self.sql = sql_text
        self.ctes: Dict[str, object] = {}   # name -> plan (lowered CTEs)
        self._fresh = 0

    # -- errors --------------------------------------------------------------
    def err(self, msg: str, node: Optional[A.Node] = None) -> SqlAnalysisError:
        line = getattr(node, "line", 0) or 0
        colno = getattr(node, "col", 0) or 0
        return SqlAnalysisError(msg, self.sql, line, colno)

    def unsup(self, construct: str, reason: str,
              node: Optional[A.Node] = None) -> SqlAnalysisError:
        line = getattr(node, "line", 0) or 0
        colno = getattr(node, "col", 0) or 0
        return unsupported(construct, reason, self.sql, line, colno)

    def fresh_name(self, prefix: str) -> str:
        self._fresh += 1
        return f"__{prefix}{self._fresh}"

    # -- statements ----------------------------------------------------------
    def lower_statement(self, stmt: A.Node):
        from spark_rapids_tpu_torch.plan import from_host_table

        if isinstance(stmt, A.Query):
            return self.lower_query(stmt)
        if isinstance(stmt, A.CreateView):
            cat = self.session.catalog
            if not stmt.replace and stmt.name.lower() in [
                    t.lower() for t in cat.list_tables()]:
                raise self.err(f"view {stmt.name!r} already exists "
                               "(use CREATE OR REPLACE)", stmt)
            if stmt.using is not None:
                path = stmt.options.get("path")
                if path is None:
                    raise self.err(
                        "CREATE TEMP VIEW ... USING requires a "
                        "path option: OPTIONS (path '...')", stmt)
                opts = {k: v for k, v in stmt.options.items()
                        if k != "path"}
                cat.register_table(stmt.name, stmt.using, path, **opts)
                return cat.table(stmt.name)
            df = self.lower_query(stmt.query)
            cat.create_or_replace_temp_view(stmt.name, df)
            return df
        if isinstance(stmt, A.DropView):
            cat = self.session.catalog
            if not cat.drop_temp_view(stmt.name) and not stmt.if_exists:
                raise self.err(f"view {stmt.name!r} not found", stmt)
            import numpy as np

            from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
            return from_host_table(
                HostTable(["dropped"], [HostColumn(
                    T.STRING, np.array([stmt.name], dtype=object))]),
                self.session)
        raise self.err(f"unsupported statement {type(stmt).__name__}", stmt)

    # -- query / set ops -----------------------------------------------------
    def lower_query(self, q: A.Query):
        saved = dict(self.ctes)
        try:
            for name, sub in q.ctes:
                self.ctes[name.lower()] = self.lower_query(sub).plan
            if isinstance(q.body, A.Select):
                # plain selects take ORDER BY with them so sort keys may
                # reference input columns the projection drops (Spark
                # plans Project over Sort for that case)
                return self.lower_select(q.body, order_by=q.order_by,
                                         limit=q.limit)
            df = self._lower_set(q.body)
            if q.order_by:
                df = self._apply_order(df, q.order_by)
            if q.limit is not None:
                df = df.limit(q.limit)
            return df
        finally:
            self.ctes = saved

    def _lower_set(self, body: A.Node):
        if isinstance(body, A.Select):
            return self.lower_select(body)
        if isinstance(body, A.Query):
            return self.lower_query(body)
        if isinstance(body, A.SetOp):
            left = self._lower_set(body.left)
            right = self._lower_set(body.right)
            if len(left.columns) != len(right.columns):
                raise self.err(
                    f"UNION arms have {len(left.columns)} vs "
                    f"{len(right.columns)} columns", body)
            out = left.union(right)
            if body.op == "union":      # UNION DISTINCT
                out = self._distinct(out)
            return out
        raise self.err(f"unsupported query body {type(body).__name__}", body)

    def _distinct(self, df):
        # Spark plans DISTINCT as Aggregate(all output columns, no aggs)
        return df.group_by(*[col(n) for n in df.columns]).agg()

    # -- relations -----------------------------------------------------------
    def lower_relation(self, rel: A.Node) -> Scope:
        if isinstance(rel, A.TableRef):
            from spark_rapids_tpu_torch.plan import DataFrame
            plan = self.ctes.get(rel.name.lower())
            if plan is not None:
                df = DataFrame(plan, self.session)
            else:
                df = self.session.catalog.lookup_relation(rel.name)
                if df is None:
                    raise self.err(
                        f"table or view {rel.name!r} not found (known: "
                        f"{self.session.catalog.list_tables()})", rel)
            names = [n for n, _ in df.plan.output_schema()]
            key = (rel.alias or rel.name).lower()
            return Scope(df, {key: {n: n for n in names}})
        if isinstance(rel, A.SubqueryRef):
            df = self.lower_query(rel.query)
            names = [n for n, _ in df.plan.output_schema()]
            aliases = {rel.alias.lower(): {n: n for n in names}} \
                if rel.alias else {}
            return Scope(df, aliases)
        if isinstance(rel, A.JoinRel):
            return self._lower_join(rel)
        raise self.err(f"unsupported relation {type(rel).__name__}", rel)

    def _disambiguate_right(self, ls: Scope, rs: Scope,
                            keep: Sequence[str] = ()):
        """Rename right-side columns whose names collide with the left
        side to fresh physical names (the plan layer binds references by
        NAME over the concatenated join schema, so duplicates would
        silently bind left). Returns (new_rs, old physical -> new
        physical map); ``keep`` columns (USING keys joined by name)
        stay. No collisions -> rs unchanged, no extra Project."""
        dup = [n for n in rs.columns if n in ls.columns and n not in keep]
        pmap = {n: n for n in rs.columns}
        if not dup:
            return rs, pmap
        exprs: List[Expression] = []
        for n in rs.columns:
            if n in dup:
                pmap[n] = self.fresh_name("r")
                exprs.append(Alias(col(n), pmap[n]))
            else:
                exprs.append(col(n))
        rdf = rs.df.select(*exprs)
        aliases = {a: {ln: pmap.get(pn, pn) for ln, pn in m.items()}
                   for a, m in rs.aliases.items()}
        display = {pmap.get(p, p): l for p, l in rs.display.items()}
        display.update({pmap[n]: n for n in dup})
        visible = [pmap.get(n, n) for n in rs.visible]
        return Scope(rdf, aliases, visible, display), pmap

    def _lower_join(self, rel: A.JoinRel) -> Scope:
        from spark_rapids_tpu_torch.plan import DataFrame
        ls = self.lower_relation(rel.left)
        rs = self.lower_relation(rel.right)
        how = rel.how
        if how == "cross":
            rs, _ = self._disambiguate_right(ls, rs)
            # the Join node itself, as the reference builds it
            df = DataFrame(P.Join(ls.df.plan, rs.df.plan, "cross", [], []),
                           self.session)
            return Scope(df, {**ls.aliases, **rs.aliases},
                         display={**ls.display, **rs.display})
        if rel.using:
            for c in rel.using:
                if c not in ls.columns or c not in rs.columns:
                    raise self.err(
                        f"USING column {c!r} must exist on both sides "
                        f"(left: {ls.columns}, right: {rs.columns})", rel)
            if how in ("right", "full"):
                return self._lower_outer_using(ls, rs, rel, how)
            rs, _ = self._disambiguate_right(ls, rs, keep=rel.using)
            df = ls.df.join(rs.df, on=list(rel.using), how=how)
            # USING hides the right-side duplicate of each join column
            # from star expansion (SQL natural-join output shape);
            # semi/anti output is the left side only
            if how in ("leftsemi", "leftanti"):
                visible = list(ls.visible)
            else:
                visible = ls.visible + [c for c in rs.visible
                                        if c not in rel.using]
            return Scope(df, {**ls.aliases, **rs.aliases}, visible,
                         display={**ls.display, **rs.display})
        # ON condition: extract equi key pairs (ExtractEquiJoinKeys
        # analog) so hash-join-able conditions take the equi path the
        # DSL's on=["k"] form takes
        rs, _ = self._disambiguate_right(ls, rs)
        merged_aliases = {**ls.aliases, **rs.aliases}
        merged_display = {**ls.display, **rs.display}
        combined = Scope(
            DataFrame(P.Join(ls.df.plan, rs.df.plan, "cross", [], []),
                      self.session), merged_aliases)
        conjuncts = _split_conjuncts(rel.on)
        lkeys: List[Expression] = []
        rkeys: List[Expression] = []
        residual: List[A.Node] = []
        for c in conjuncts:
            pair = self._equi_pair(c, ls, rs)
            if pair is None:
                residual.append(c)
            else:
                lkeys.append(pair[0])
                rkeys.append(pair[1])
        cond = None
        if residual:
            rest = residual[0]
            for nxt in residual[1:]:
                rest = A.BinOp(op="AND", left=rest, right=nxt,
                               line=nxt.line, col=nxt.col)
            cond = self.lower_expr(rest, combined)
        join = P.Join(ls.df.plan, rs.df.plan, how, lkeys, rkeys,
                      condition=cond)
        if how in ("leftsemi", "leftanti"):
            return Scope(DataFrame(join, self.session), merged_aliases,
                         list(ls.visible), display=dict(ls.display))
        return Scope(DataFrame(join, self.session), merged_aliases,
                     ls.visible + rs.visible, display=merged_display)

    def _lower_outer_using(self, ls: Scope, rs: Scope, rel: A.JoinRel,
                           how: str) -> Scope:
        """RIGHT/FULL JOIN ... USING: the merged key column is
        COALESCE(left, right) (right join: the right copy), NOT the
        left copy — an unmatched right row must surface its key, not
        NULL. Joins on explicit key pairs over a renamed right side,
        then projects the merged key back under the USING name."""
        from spark_rapids_tpu_torch import functions as F
        from spark_rapids_tpu_torch.plan import DataFrame
        rs, pmap = self._disambiguate_right(ls, rs)
        lk = [col(c) for c in rel.using]
        rk = [col(pmap[c]) for c in rel.using]
        df = DataFrame(P.Join(ls.df.plan, rs.df.plan, how, lk, rk),
                       self.session)
        right_key_phys = {pmap[c] for c in rel.using}
        exprs: List[Expression] = []
        for n in ls.columns:
            if n in rel.using:
                rc = col(pmap[n])
                e = rc if how == "right" else F.coalesce(col(n), rc)
                exprs.append(Alias(e, n))
            else:
                exprs.append(col(n))
        exprs += [col(n) for n in rs.columns if n not in right_key_phys]
        df = df.select(*exprs)
        # both sides' qualified key references resolve to the merged key
        aliases = {**ls.aliases,
                   **{a: {ln: (ln if ln in rel.using else pn)
                          for ln, pn in m.items()}
                      for a, m in rs.aliases.items()}}
        visible = ls.visible + [n for n in rs.visible
                                if n not in right_key_phys]
        display = {**ls.display,
                   **{p: l for p, l in rs.display.items()
                      if p not in right_key_phys}}
        return Scope(df, aliases, visible, display)

    def _equi_pair(self, c: A.Node, ls: Scope, rs: Scope):
        """(left_key, right_key) when ``c`` is `<left-only> = <right-only>`
        (either orientation), else None."""
        if not (isinstance(c, A.BinOp) and c.op == "="):
            return None
        s1 = self._ref_sides(c.left, ls, rs)
        s2 = self._ref_sides(c.right, ls, rs)
        if s1 == {"L"} and s2 == {"R"}:
            return (self.lower_expr(c.left, ls),
                    self.lower_expr(c.right, rs))
        if s1 == {"R"} and s2 == {"L"}:
            return (self.lower_expr(c.right, ls),
                    self.lower_expr(c.left, rs))
        return None

    def _ref_sides(self, node: A.Node, ls: Scope, rs: Scope) -> set:
        """Which join side(s) the column references in ``node`` touch."""
        sides: set = set()

        def walk(x):
            if isinstance(x, A.Ident):
                if len(x.parts) == 2:
                    q = x.parts[0].lower()
                    if q in ls.aliases:
                        sides.add("L")
                    elif q in rs.aliases:
                        sides.add("R")
                    else:
                        sides.add("?")
                else:
                    name = x.parts[0]
                    inl = name in ls.columns
                    inr = name in rs.columns
                    if inl and inr:
                        sides.update({"L", "R"})
                    elif inl:
                        sides.add("L")
                    elif inr:
                        sides.add("R")
                    else:
                        sides.add("?")
                return
            for f in ("left", "right", "operand", "low", "high", "pattern"):
                sub = getattr(x, f, None)
                if isinstance(sub, A.Node):
                    walk(sub)
            for seq in (getattr(x, "args", ()) or (),
                        getattr(x, "items", ()) or ()):
                for sub in seq:
                    if isinstance(sub, A.Node):
                        walk(sub)
        walk(node)
        return sides

    # -- SELECT --------------------------------------------------------------
    def lower_select(self, sel: A.Select, order_by=None, limit=None):
        # FROM (the reference evaluates a FROM-less select over one
        # synthetic row)
        if sel.from_ is None:
            from spark_rapids_tpu_torch.plan import DataFrame
            scope = Scope(DataFrame(P.RangeNode(0, 1, 1), self.session),
                          {}, visible=[])
        else:
            scope = self.lower_relation(sel.from_)

        # hints (the DSL's .repartition escape hatch)
        for hname, hargs in sel.hints:
            if hname == "REPARTITION":
                if not hargs or not hargs[0].isdigit():
                    raise self.err(
                        "REPARTITION hint needs (numPartitions[, cols...])",
                        sel)
                n = int(hargs[0])
                scope = scope.with_df(
                    scope.df.repartition(n, *hargs[1:]))
            elif hname == "COALESCE":
                if not hargs or not hargs[0].isdigit():
                    raise self.err("COALESCE hint needs (numPartitions)",
                                   sel)
                scope = scope.with_df(
                    scope.df.repartition(int(hargs[0])))
            else:
                raise self.unsup(f"hint {hname}",
                                 "supported hints: REPARTITION, COALESCE",
                                 sel)

        # WHERE (subquery rewrites first, then one Filter preserving the
        # original predicate tree so SQL text and DSL build equal plans)
        if sel.where is not None:
            scope = self._apply_where(scope, sel.where)

        # expand stars / assign positions
        items = self._expand_items(sel.items, scope)

        has_group = bool(sel.group_by) or sel.having is not None
        has_agg = has_group or any(
            self._contains_agg_call(it.expr) for it in items)

        if has_agg:
            df, names = self._lower_aggregate(scope, items, sel)
        else:
            df, names, pre_sorted = self._lower_plain_select(
                scope, items, sel, order_by)
            if pre_sorted:
                order_by = None

        if sel.distinct:
            df = self._distinct(df)
        if order_by:
            df = self._apply_order(df, order_by)
        if limit is not None:
            df = df.limit(limit)
        return df

    # -- WHERE ---------------------------------------------------------------
    def _apply_where(self, scope: Scope, where: A.Node) -> Scope:
        if not self._contains_subquery(where):
            return scope.with_df(
                scope.df.filter(self.lower_expr(where, scope)))
        conjuncts = _split_conjuncts(where)
        plain: List[A.Node] = []
        from spark_rapids_tpu_torch.plan import DataFrame
        df = scope.df
        hidden: List[str] = []
        for c in conjuncts:
            if isinstance(c, A.InSubquery):
                sub = self.lower_query(c.query)
                sub_cols = sub.columns
                if len(sub_cols) != 1:
                    raise self.err(
                        "IN subquery must produce exactly one column, "
                        f"got {sub_cols}", c)
                key = self.lower_expr(c.operand, scope.with_df(df))
                if c.negated:
                    # NOT IN is null-aware (Spark's NullAwareAntiJoin):
                    # a NULL key or any NULL in the subquery makes the
                    # predicate UNKNOWN, which WHERE drops — a plain
                    # anti join would keep those rows. leftanti keeps
                    # rows with NO matching right row, so matching on
                    # (key = y OR key IS NULL OR y IS NULL) drops them;
                    # an empty subquery keeps everything (NOT IN over
                    # the empty set is TRUE, NULL key included).
                    name = self.fresh_name("notin")
                    sub = sub.select(col(sub_cols[0]).alias(name))
                    rkey = col(name)
                    cond = (key == rkey) | key.isnull() | rkey.isnull()
                    df = DataFrame(
                        P.Join(df.plan, sub.plan, "leftanti", [], [],
                               condition=cond), self.session)
                    continue
                df = DataFrame(
                    P.Join(df.plan, sub.plan, "leftsemi", [key],
                           [col(sub_cols[0])]), self.session)
                continue
            if self._contains_subquery(c):
                c, df, new_hidden = self._rewrite_scalar_subqueries(
                    c, df, scope)
                hidden.extend(new_hidden)
            plain.append(c)
        if plain:
            merged = plain[0]
            for nxt in plain[1:]:
                merged = A.BinOp(op="AND", left=merged, right=nxt,
                                 line=nxt.line, col=nxt.col)
            df = df.filter(self.lower_expr(
                merged, Scope(df, scope.aliases, scope.visible, scope.display)))
        if hidden:
            # project the helper columns back out
            keep = [col(n) for n in scope.visible]
            df = df.select(*keep)
        return Scope(df, scope.aliases, scope.visible, scope.display)

    def _rewrite_scalar_subqueries(self, node: A.Node, df, scope: Scope):
        """Uncorrelated scalar subqueries -> cross join + hidden column
        (RewriteCorrelatedScalarSubquery's uncorrelated slice)."""
        from spark_rapids_tpu_torch.plan import DataFrame
        hidden: List[str] = []

        def walk(x):
            nonlocal df
            if isinstance(x, A.ScalarSubquery):
                sub = self.lower_query(x.query)
                if len(sub.columns) != 1:
                    raise self.err(
                        "scalar subquery must produce exactly one "
                        f"column, got {sub.columns}", x)
                name = self.fresh_name("scalar_sq")
                sub = sub.select(col(sub.columns[0]).alias(name))
                df = DataFrame(
                    P.Join(df.plan, sub.plan, "cross", [], []),
                    self.session)
                hidden.append(name)
                return A.Ident(parts=(name,), line=x.line, col=x.col)
            if isinstance(x, A.InSubquery):
                raise self.unsup(
                    "IN subquery", "only supported as a top-level WHERE "
                    "conjunct (it rewrites to a semi join)", x)
            for f in ("left", "right", "operand", "low", "high",
                      "pattern"):
                sub = getattr(x, f, None)
                if isinstance(sub, A.Node):
                    setattr(x, f, walk(sub))
            if getattr(x, "args", None):
                x.args = [walk(a) if isinstance(a, A.Node) else a
                          for a in x.args]
            if getattr(x, "items", None) and not isinstance(x, A.Select):
                x.items = [walk(a) if isinstance(a, A.Node) else a
                           for a in x.items]
            return x

        node = walk(node)
        return node, df, hidden

    # -- select items --------------------------------------------------------
    def _expand_items(self, items: Sequence[A.Node],
                      scope: Scope) -> List[A.SelectItem]:
        out: List[A.SelectItem] = []
        for it in items:
            if isinstance(it, A.Star):
                if it.qualifier is not None:
                    m = scope.aliases.get(it.qualifier.lower())
                    if m is None:
                        raise self.err(
                            f"unknown relation alias {it.qualifier!r} "
                            f"in {it.qualifier}.* (known: "
                            f"{sorted(scope.aliases)})", it)
                    pairs = list(m.items())     # logical -> physical
                else:
                    pairs = [(scope.display.get(n, n), n)
                             for n in scope.visible]
                for logical, physical in pairs:
                    out.append(A.SelectItem(
                        expr=A.Ident(parts=(physical,), line=it.line,
                                     col=it.col),
                        alias=logical if logical != physical else None,
                        line=it.line, col=it.col))
            else:
                out.append(it)
        return out

    def _contains_agg_call(self, node: A.Node) -> bool:
        if isinstance(node, A.FuncCall) and node.window is None:
            if node.name.lower() in _AGG_NAMES:
                return True
        for ch in _ast_children(node):
            if self._contains_agg_call(ch):
                return True
        return False

    def _contains_subquery(self, node: A.Node) -> bool:
        if isinstance(node, (A.ScalarSubquery, A.InSubquery)):
            return True
        return any(self._contains_subquery(c) for c in _ast_children(node))

    def _contains_window(self, node: A.Node) -> bool:
        if isinstance(node, A.FuncCall) and node.window is not None:
            return True
        return any(self._contains_window(c) for c in _ast_children(node))

    # -- plain (non-aggregate) select ---------------------------------------
    def _lower_plain_select(self, scope: Scope,
                            items: List[A.SelectItem], sel: A.Select,
                            order_by=None):
        df = scope.df
        win_items = [it for it in items if self._contains_window(it.expr)]
        if win_items:
            df, items = self._apply_windows(scope, items, sel)
            scope = Scope(df, scope.aliases, scope.visible, scope.display)
        exprs: List[Expression] = []
        names: List[str] = []
        for i, it in enumerate(items):
            e = self.lower_expr(it.expr, scope.with_df(df))
            if it.alias is not None:
                name = it.alias
                exprs.append(Alias(e, name))
            elif isinstance(it.expr, A.Ident):
                # qualified refs over renamed join duplicates output the
                # SQL-level name, not the internal physical one
                name = it.expr.parts[-1]
                exprs.append(e if output_name(e, name) == name
                             else Alias(e, name))
            else:
                name = output_name(e, f"col{i}")
                exprs.append(e)
            names.append(name)
        pre_sorted = False
        if order_by and not sel.distinct and \
                not self._order_uses_output_only(order_by, names):
            # sort keys reference input columns the projection drops:
            # sort first, then project (Spark's Project-over-Sort)
            in_scope = scope.with_df(df)
            orders = [
                P.SortOrder(
                    self._presort_expr(s, exprs, names, in_scope),
                    s.ascending, s.nulls_first)
                for s in order_by]
            df = df.sort(*orders)
            pre_sorted = True
        if _is_identity(exprs, names, df):
            return df, names, pre_sorted
        return df.select(*exprs), names, pre_sorted

    def _order_uses_output_only(self, order_by, names: List[str]) -> bool:
        """True when every sort key resolves against the select output
        (ordinals, select aliases, or idents that survive projection)."""
        def idents(x):
            if isinstance(x, A.Ident):
                yield x
            for ch in _ast_children(x):
                yield from idents(ch)
        for s in order_by:
            if isinstance(s.expr, A.Literal) and isinstance(
                    s.expr.value, int):
                continue
            for ident in idents(s.expr):
                # qualified refs only resolve against the INPUT scope
                # (the projected output loses relation aliases)
                if len(ident.parts) > 1 or ident.parts[-1] not in names:
                    return False
        return True

    def _presort_expr(self, s: A.SortItem, exprs, names: List[str],
                      scope: Scope) -> Expression:
        """Sort key for a pre-projection sort: ordinals and select
        aliases map to the projected expression over the input."""
        def unalias(e):
            return e.children[0] if isinstance(e, Alias) else e
        if isinstance(s.expr, A.Literal) and isinstance(s.expr.value, int):
            pos = s.expr.value
            if not (1 <= pos <= len(exprs)):
                raise self.err(
                    f"ORDER BY position {pos} is out of range", s.expr)
            return unalias(exprs[pos - 1])
        if isinstance(s.expr, A.Ident) and len(s.expr.parts) == 1 \
                and s.expr.parts[0] in names \
                and s.expr.parts[0] not in scope.columns:
            return unalias(exprs[names.index(s.expr.parts[0])])
        return self.lower_expr(s.expr, scope)

    def _apply_windows(self, scope: Scope, items: List[A.SelectItem],
                       sel: A.Select):
        """Append window columns via WindowNode, rewriting the items to
        reference them (window exprs must be top-level select items)."""
        df = scope.df
        pairs: List[Tuple[str, Expression]] = []
        new_items: List[A.SelectItem] = []
        for i, it in enumerate(items):
            if not self._contains_window(it.expr):
                new_items.append(it)
                continue
            if not (isinstance(it.expr, A.FuncCall)
                    and it.expr.window is not None):
                raise self.unsup(
                    "window expression",
                    "window functions must be top-level select items "
                    "(wrap arithmetic over them in an outer SELECT)",
                    it)
            wexpr = self._lower_window_call(
                it.expr, scope.with_df(df))
            name = it.alias or f"col{i}"
            pairs.append((name, wexpr))
            new_items.append(A.SelectItem(
                expr=A.Ident(parts=(name,), line=it.line, col=it.col),
                alias=None, line=it.line, col=it.col))
        df = df._wrap(P.WindowNode(df.plan, pairs))
        return df, new_items

    def _lower_window_call(self, call: A.FuncCall, scope: Scope):
        from spark_rapids_tpu_torch.ops.window import (
            WindowExpression,
            WindowFunction,
            WindowSpec,
        )
        fn = self._lower_func(call, scope, allow_window_fn=True)
        if not isinstance(fn, (WindowFunction, agg.AggregateFunction)):
            raise self.unsup(
                f"window function {call.name}",
                "only ranking/offset functions and aggregates may be "
                "used with OVER", call)
        w = call.window
        partition = [self.lower_expr(p, scope) for p in w.partition_by]
        orders = [self._sort_order(s, scope) for s in w.order_by]
        spec = WindowSpec(partition, orders, w.frame)
        return WindowExpression(fn, spec)

    def _sort_order(self, s: A.SortItem, scope: Scope) -> P.SortOrder:
        return P.SortOrder(self.lower_expr(s.expr, scope), s.ascending,
                           s.nulls_first)

    # -- aggregate select ----------------------------------------------------
    def _lower_aggregate(self, scope: Scope, items: List[A.SelectItem],
                         sel: A.Select):
        # 1. grouping expressions (support ordinals and select aliases)
        key_asts: List[A.Node] = []
        for g in sel.group_by:
            if isinstance(g, A.Literal) and isinstance(g.value, int) \
                    and not isinstance(g.value, bool):
                if not (1 <= g.value <= len(items)):
                    raise self.err(
                        f"GROUP BY position {g.value} is out of range "
                        f"(select list has {len(items)} items)", g)
                key_asts.append(items[g.value - 1].expr)
                continue
            if isinstance(g, A.Ident) and len(g.parts) == 1 \
                    and g.parts[0] not in scope.columns:
                match = [it for it in items if it.alias == g.parts[0]]
                if match:
                    key_asts.append(match[0].expr)
                    continue
            key_asts.append(g)
        keys = [self.lower_expr(k, scope) for k in key_asts]
        key_lookup = {k.key(): i for i, k in enumerate(keys)}
        key_names = [output_name(k, f"k{i}") for i, k in enumerate(keys)]

        # 2. classify select items; collect agg specs in select order
        agg_specs: List[Tuple[str, agg.AggregateFunction]] = []
        plan_items: List[Tuple[str, str, object]] = []
        need_project = False
        for i, it in enumerate(items):
            if self._contains_window(it.expr):
                raise self.unsup(
                    "window function in an aggregate query",
                    "compute the aggregate in a subquery, then apply "
                    "the window in an outer SELECT", it)
            e = self.lower_expr(it.expr, scope)
            k = _safe_key(e)
            if k is not None and k in key_lookup:
                kn = key_names[key_lookup[k]]
                name = it.alias or (
                    it.expr.parts[-1] if isinstance(it.expr, A.Ident)
                    else kn)
                plan_items.append(("key", kn, name))
                if name != kn:
                    need_project = True
                continue
            if isinstance(e, agg.AggregateFunction):
                name = it.alias or f"col{i}"
                agg_specs.append((name, e))
                plan_items.append(("agg", name, name))
                continue
            # composite: expression over aggregates / keys
            rewritten = self._rewrite_over_agg(
                e, key_lookup, key_names, agg_specs, it)
            name = it.alias or f"col{i}"
            plan_items.append(("expr", rewritten, name))
            need_project = True

        # 3. HAVING may add hidden aggregates
        having_pred = None
        n_visible_aggs = len(agg_specs)
        if sel.having is not None:
            he = self.lower_expr(
                self._subst_select_aliases(sel.having, items, scope), scope)
            having_pred = self._rewrite_over_agg(
                he, key_lookup, key_names, agg_specs, sel.having,
                hidden=True, select_items=plan_items)
        if len(agg_specs) > n_visible_aggs:
            need_project = True

        # 4. build Aggregate through the DSL path
        aliased = [Alias(fn, name) for name, fn in agg_specs]
        df = scope.df.group_by(*keys).agg(*aliased)
        if having_pred is not None:
            df = df.filter(having_pred)

        # 5. natural-output check: SELECT keys..., aggs... in plan order
        # needs no projection (the shape every DSL group_by().agg() has)
        natural = [("key", kn, kn) for kn in key_names] + \
            [("agg", n, n) for n, _ in agg_specs]
        if not need_project and plan_items == natural:
            return df, [p[2] for p in plan_items]
        out_exprs: List[Expression] = []
        names: List[str] = []
        for kind, payload, name in plan_items:
            base = col(payload) if kind in ("key", "agg") else payload
            out_exprs.append(Alias(base, name))
            names.append(name)
        return df.select(*out_exprs), names

    def _subst_select_aliases(self, node: A.Node, items, scope: Scope):
        """HAVING may reference select-list aliases (Spark resolves them
        after aggregation); substitute the aliased expression AST.  Real
        input columns win on a name clash (Spark's resolution order), and
        subqueries keep their own scope."""
        import dataclasses
        if isinstance(node, A.Ident) and len(node.parts) == 1 \
                and node.parts[0] not in scope.columns:
            for it in items:
                if isinstance(it, A.SelectItem) \
                        and it.alias == node.parts[0]:
                    return it.expr
        if not dataclasses.is_dataclass(node) or isinstance(node, A.Query):
            return node

        def walk(v):
            if isinstance(v, A.Query):
                return v
            if isinstance(v, A.Node):
                return self._subst_select_aliases(v, items, scope)
            if isinstance(v, (list, tuple)):
                return type(v)(walk(x) for x in v)
            return v

        changes = {}
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            nv = walk(v)
            if nv is not v and nv != v:
                changes[f.name] = nv
        return dataclasses.replace(node, **changes) if changes else node

    def _rewrite_over_agg(self, e: Expression, key_lookup, key_names,
                          agg_specs, node: A.Node, hidden: bool = False,
                          select_items=None) -> Expression:
        """Replace grouping-expr / aggregate subtrees with references to
        the Aggregate's output columns; anything else referencing input
        columns is an error (Spark's 'neither grouped nor aggregated')."""
        k = _safe_key(e)
        if k is not None and k in key_lookup:
            return col(key_names[key_lookup[k]])
        if isinstance(e, agg.AggregateFunction):
            for name, fn in agg_specs:
                if fn.key() == e.key():
                    return col(name)
            name = self.fresh_name("hav") if hidden else \
                self.fresh_name("agg")
            agg_specs.append((name, e))
            return col(name)
        if isinstance(e, AttributeReference):
            # HAVING may reference select aliases of aggregates
            if select_items is not None:
                for kind, payload, name in select_items:
                    if name == e.col_name and kind in ("key", "agg"):
                        return col(payload)
                    if name == e.col_name:
                        return payload
            raise self.err(
                f"column {e.col_name!r} must appear in GROUP BY or be "
                "inside an aggregate function", node)
        if not e.children:
            return e
        return e.with_children([
            self._rewrite_over_agg(c, key_lookup, key_names, agg_specs,
                                   node, hidden, select_items)
            for c in e.children])

    # -- ORDER BY / LIMIT ----------------------------------------------------
    def _apply_order(self, df, order_by: Sequence[A.SortItem]):
        out_cols = df.columns
        orders: List[P.SortOrder] = []
        scope = Scope(df, {})
        for s in order_by:
            if isinstance(s.expr, A.Literal) and isinstance(s.expr.value,
                                                            int):
                pos = s.expr.value
                if not (1 <= pos <= len(out_cols)):
                    raise self.err(
                        f"ORDER BY position {pos} is out of range", s.expr)
                e: Expression = col(out_cols[pos - 1])
            else:
                if self._contains_agg_call(s.expr):
                    raise self.unsup(
                        "aggregate in ORDER BY",
                        "alias the aggregate in the select list and "
                        "order by the alias", s.expr)
                e = self.lower_expr(s.expr, scope)
            orders.append(P.SortOrder(e, s.ascending, s.nulls_first))
        return df.sort(*orders)

    # -- expressions ---------------------------------------------------------
    def lower_expr(self, node: A.Node, scope: Scope) -> Expression:
        if isinstance(node, A.Literal):
            return self._literal(node)
        if isinstance(node, A.TypedLiteral):
            return self._typed_literal(node)
        if isinstance(node, A.IntervalLiteral):
            raise self.unsup(
                "standalone INTERVAL value",
                "intervals are only supported in date +/- INTERVAL "
                "arithmetic", node)
        if isinstance(node, A.Ident):
            return self._ident(node, scope)
        if isinstance(node, A.BinOp):
            return self._binop(node, scope)
        if isinstance(node, A.UnOp):
            if node.op == "NOT":
                return ~self.lower_expr(node.operand, scope)
            inner = node.operand
            if isinstance(inner, A.Literal) and isinstance(
                    inner.value, (int, float)) and not isinstance(
                    inner.value, bool):
                return lit(-inner.value)
            return -self.lower_expr(inner, scope)
        if isinstance(node, A.IsNull):
            e = self.lower_expr(node.operand, scope)
            return e.isnotnull() if node.negated else e.isnull()
        if isinstance(node, A.InList):
            from spark_rapids_tpu_torch.ops.predicates import In
            e = In(self.lower_expr(node.operand, scope),
                   [self.lower_expr(i, scope) for i in node.items])
            return ~e if node.negated else e
        if isinstance(node, A.InSubquery):
            raise self.unsup(
                "IN subquery", "only supported as a top-level WHERE "
                "conjunct (it rewrites to a semi join)", node)
        if isinstance(node, A.ScalarSubquery):
            raise self.unsup(
                "scalar subquery", "only supported inside WHERE (it "
                "rewrites to a cross join)", node)
        if isinstance(node, A.Between):
            e = self.lower_expr(node.operand, scope)
            lo = self.lower_expr(node.low, scope)
            hi = self.lower_expr(node.high, scope)
            out = (e >= lo) & (e <= hi)
            return ~out if node.negated else out
        if isinstance(node, A.LikeOp):
            from spark_rapids_tpu_torch.ops.strings import Like, RLike
            e = self.lower_expr(node.operand, scope)
            pat = self.lower_expr(node.pattern, scope)
            out = Like(e, pat) if node.kind == "like" else RLike(e, pat)
            return ~out if node.negated else out
        if isinstance(node, A.Cast):
            try:
                dt = T.parse_type(node.type_name)
            except TypeError as exc:
                raise self.err(str(exc), node)
            return self.lower_expr(node.operand, scope).cast(dt)
        if isinstance(node, A.Case):
            return self._case(node, scope)
        if isinstance(node, A.FuncCall):
            if node.window is not None:
                return self._lower_window_call(node, scope)
            return self._lower_func(node, scope)
        if isinstance(node, A.Star):
            raise self.err("'*' is only valid in the select list or "
                           "count(*)", node)
        raise self.err(
            f"unsupported expression {type(node).__name__}", node)

    def _literal(self, node: A.Literal) -> Expression:
        import decimal
        v = node.value
        if isinstance(v, decimal.Decimal):
            tup = v.as_tuple()
            scale = max(-tup.exponent, 0)
            # positive exponents widen the integer part: 1E2BD is 100 =
            # decimal(3,0), not decimal(1,0) (code-review fix — the old
            # precision left CheckOverflow nulling 1E2BD + 1BD)
            digits = len(tup.digits) + max(tup.exponent, 0)
            precision = max(digits, scale)
            unscaled = int(v.scaleb(scale))
            return Literal(unscaled, T.DecimalType(precision, scale))
        return lit(v)

    def _typed_literal(self, node: A.TypedLiteral) -> Expression:
        import datetime as _dt
        try:
            if node.kind == "date":
                return lit(_dt.date.fromisoformat(node.text))
            v = _dt.datetime.fromisoformat(node.text)
            return lit(v)
        except ValueError as exc:
            raise self.err(
                f"cannot parse {node.kind.upper()} literal "
                f"{node.text!r}: {exc}", node)

    def _ident(self, node: A.Ident, scope: Scope) -> Expression:
        if len(node.parts) == 1:
            name = node.parts[0]
            if name not in scope.columns:
                raise self.err(
                    f"cannot resolve column {name!r} "
                    f"(in scope: {scope.columns})", node)
            return col(name)
        if len(node.parts) == 2:
            qual, name = node.parts
            cols = scope.aliases.get(qual.lower())
            if cols is None:
                raise self.err(
                    f"unknown relation alias {qual!r} (known: "
                    f"{sorted(scope.aliases)})", node)
            if name not in cols:
                raise self.err(
                    f"column {name!r} not found in {qual!r} "
                    f"(columns: {list(cols)})", node)
            return col(cols[name])
        raise self.unsup(
            ".".join(node.parts),
            "only col and alias.col references are supported", node)

    def _binop(self, node: A.BinOp, scope: Scope) -> Expression:
        op = node.op
        if op == "AND":
            return self.lower_expr(node.left, scope) & \
                self.lower_expr(node.right, scope)
        if op == "OR":
            return self.lower_expr(node.left, scope) | \
                self.lower_expr(node.right, scope)
        # date +/- INTERVAL folds onto DateAdd/DateSub/AddMonths
        if op in ("+", "-") and isinstance(node.right, A.IntervalLiteral):
            return self._date_interval(node, scope)
        if op == "+" and isinstance(node.left, A.IntervalLiteral):
            flipped = A.BinOp(op="+", left=node.right, right=node.left,
                              line=node.line, col=node.col)
            return self._date_interval(flipped, scope)
        left = self.lower_expr(node.left, scope)
        right = self.lower_expr(node.right, scope)
        if op == "+":
            return left + right
        if op == "-":
            return left - right
        if op == "*":
            return left * right
        if op == "/":
            return left / right
        if op == "%":
            return left % right
        if op == "||":
            from spark_rapids_tpu_torch.ops.strings import Concat
            return Concat(left, right)
        if op == "=":
            return left == right
        if op == "<=>":
            # null-safe equal: NEVER null (code-review fix: the previous
            # (isnull&isnull)|(==) lowering returned NULL when exactly
            # one side was null, so NOT(a <=> b) dropped rows)
            from spark_rapids_tpu_torch.ops.predicates import EqualNullSafe
            return EqualNullSafe(left, right)
        if op == "<>":
            return left != right
        if op == "<":
            return left < right
        if op == "<=":
            return left <= right
        if op == ">":
            return left > right
        if op == ">=":
            return left >= right
        raise self.err(f"unsupported operator {op!r}", node)

    def _date_interval(self, node: A.BinOp, scope: Scope) -> Expression:
        """date +/- INTERVAL folds onto AddMonths, then DateAdd/DateSub,
        as the reference's analyzer does."""
        from spark_rapids_tpu_torch.ops.datetime import (
            AddMonths,
            DateAdd,
            DateSub,
        )
        iv: A.IntervalLiteral = node.right
        e = self.lower_expr(node.left, scope)
        sign = 1 if node.op == "+" else -1
        if iv.months:
            e = AddMonths(e, lit(sign * iv.months))
        if iv.days:
            e = DateAdd(e, lit(iv.days)) if node.op == "+" else \
                DateSub(e, lit(iv.days))
        return e

    def _case(self, node: A.Case, scope: Scope) -> Expression:
        from spark_rapids_tpu_torch.ops.conditional import CaseWhen
        flat: List[Expression] = []
        operand = (self.lower_expr(node.operand, scope)
                   if node.operand is not None else None)
        for c, v in node.branches:
            ce = self.lower_expr(c, scope)
            if operand is not None:
                ce = operand == ce
            flat.append(ce)
            flat.append(self.lower_expr(v, scope))
        if node.else_value is not None:
            flat.append(self.lower_expr(node.else_value, scope))
        return CaseWhen(*flat)

    def _lower_func(self, node: A.FuncCall, scope: Scope,
                    allow_window_fn: bool = False) -> Expression:
        name = node.name
        if node.distinct:
            raise self.unsup(
                f"{name}(DISTINCT ...)",
                "distinct aggregates are not supported; use a "
                "subquery with GROUP BY", node)
        # count(*) / count(1) count rows
        if name.lower() == "count" and (
                (len(node.args) == 1 and isinstance(node.args[0], A.Star))
                or (len(node.args) == 1
                    and isinstance(node.args[0], A.Literal)
                    and node.args[0].value == 1)
                or not node.args):
            return agg.Count()
        builder = registry.lookup(name, self.session)
        if builder is None:
            raise self.err(
                f"undefined function {name!r} (not a builtin or a "
                "registered SQL function)", node)
        args = []
        for a in node.args:
            if isinstance(a, A.Star):
                raise self.err(
                    f"'*' argument is only valid in count(*)", a)
            args.append(self.lower_expr(a, scope))
        try:
            return builder(args)
        except SqlAnalysisError as exc:
            raise self.err(exc.raw_msg, node)
        except (TypeError, ValueError) as exc:
            raise self.err(f"function {name}: {exc}", node)


#: function names that produce AggregateFunction expressions — used to
#: decide whether a select needs the aggregate lowering path
_AGG_NAMES = {
    "sum", "min", "max", "avg", "mean", "count", "first", "last",
    "collect_list", "collect_set", "percentile", "approx_percentile",
    "stddev", "stddev_samp", "std", "stddev_pop", "variance",
    "var_samp", "var_pop",
}


def _ast_children(node: A.Node):
    for f in ("left", "right", "operand", "low", "high", "pattern",
              "else_value", "expr"):
        sub = getattr(node, f, None)
        if isinstance(sub, A.Node):
            yield sub
    for a in getattr(node, "args", ()) or ():
        if isinstance(a, A.Node):
            yield a
    for a in getattr(node, "items", ()) or ():
        if isinstance(a, A.Node):
            yield a
        elif isinstance(a, A.SelectItem):
            yield a.expr
    for c, v in getattr(node, "branches", ()) or ():
        yield c
        yield v


def _split_conjuncts(node: A.Node) -> List[A.Node]:
    if isinstance(node, A.BinOp) and node.op == "AND":
        return _split_conjuncts(node.left) + _split_conjuncts(node.right)
    return [node]


def _safe_key(e: Expression):
    try:
        return e.key()
    except Exception:
        return None


def _is_identity(exprs: List[Expression], names: List[str], df) -> bool:
    """SELECT of exactly the child's columns in order -> elide Project
    (keeps SQL plan shapes equal to their DSL forms)."""
    cols = df.columns
    if len(exprs) != len(cols):
        return False
    for e, n, c in zip(exprs, names, cols):
        if not isinstance(e, AttributeReference):
            return False
        if e.col_name != c or n != c:
            return False
    return True


def lower_statement(session, sql_text: str):
    """Parse + analyze one SQL statement into a DataFrame."""
    from spark_rapids_tpu_torch.sql.parser import parse_statement
    stmt = parse_statement(sql_text)
    return Analyzer(session, sql_text).lower_statement(stmt)
