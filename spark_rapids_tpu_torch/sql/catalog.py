"""Session catalog: temp views (port of the temp-view part of
``spark_rapids_tpu/sql/catalog.py``, Spark's SessionCatalog slice).

A temp view holds a plan; ``SELECT ... FROM name`` reads that plan.
File-format tables (``register_table``, ``CREATE TEMP VIEW ... USING
fmt``) resolve lazily through the source provider SPI
(``sources.create_scan``), so each lookup scans the files as they are
then; views and tables share one name space, views first.
``register_function`` makes a session-scoped function callable from SQL
(a UDF of ``functions.udf``, compiled or row-wise on the CPU route, or an
F-style composition); the analyzer looks it up before the global and
builtin tables (sql/registry.py)."""

from __future__ import annotations

from typing import Dict, List

from spark_rapids_tpu_torch.errors import ColumnarProcessingError


def _invalidate(reason: str) -> None:
    """A catalog change stales every cached executable (the reference's
    ``sql/catalog.py:22-24``)."""
    from spark_rapids_tpu_torch.plan.fingerprint import (
        bump_invalidation_epoch,
    )
    bump_invalidation_epoch(reason)


class SessionCatalog:
    def __init__(self, session):
        self._session = session
        #: name -> PlanNode (shared subtree; plan nodes are not mutated)
        self._views: Dict[str, object] = {}
        #: name -> (fmt, paths, options), resolved through sources.py
        self._tables: Dict[str, tuple] = {}
        #: name -> expression builder (register_function)
        self._functions: Dict[str, object] = {}

    # -- temp views ----------------------------------------------------------
    def create_or_replace_temp_view(self, name: str, df) -> None:
        # a same-name table goes, or it would outlive a later DROP VIEW
        self._tables.pop(name.lower(), None)
        self._views[name.lower()] = getattr(df, "plan", df)
        _invalidate(f"temp view {name}")

    def drop_temp_view(self, name: str) -> bool:
        dropped = self._views.pop(name.lower(), None) is not None
        if dropped:
            _invalidate(f"drop view {name}")
        return dropped

    # -- file-format tables (sources SPI) -----------------------------------
    def register_table(self, name: str, fmt: str, *paths,
                       **options) -> None:
        """Register ``name`` as a lazy scan of ``paths`` in ``fmt``
        through the source provider registry. A format with no provider
        raises when it is registered, and so do options the format does
        not know (the scan is built once here to check them; SQL OPTIONS
        values arrive as strings)."""
        from spark_rapids_tpu_torch.sources import (
            provider_for,
            supported_formats,
        )
        if provider_for(fmt) is None:
            raise ColumnarProcessingError(
                f"no available source provider for format {fmt!r} "
                f"(available: {list(supported_formats())})")
        from spark_rapids_tpu_torch.sources import create_scan
        create_scan(fmt, list(paths), self._session.conf, **options)
        self._views.pop(name.lower(), None)
        self._tables[name.lower()] = (fmt, list(paths), dict(options))
        _invalidate(f"table {name}")

    def drop_table(self, name: str) -> bool:
        dropped = self._tables.pop(name.lower(), None) is not None
        if dropped:
            _invalidate(f"drop table {name}")
        return dropped

    def list_tables(self) -> List[str]:
        return sorted(set(self._views) | set(self._tables))

    # -- session functions ---------------------------------------------------

    def register_function(self, name: str, builder) -> None:
        """Make ``builder(*arg_exprs) -> Expression`` callable from SQL as
        ``name(...)``: a UDF of ``functions.udf`` (compiled, or row-wise on
        the CPU route) or an F-style composition."""
        self._functions[name.lower()] = builder

    def unregister_function(self, name: str) -> bool:
        return self._functions.pop(name.lower(), None) is not None

    def lookup_function(self, name: str):
        return self._functions.get(name.lower())

    # -- resolution ----------------------------------------------------------
    def lookup_relation(self, name: str):
        """DataFrame over a temp view or a registered table, else None."""
        from spark_rapids_tpu_torch.plan import DataFrame
        key = name.lower()
        plan = self._views.get(key)
        if plan is not None:
            return DataFrame(plan, self._session)
        entry = self._tables.get(key)
        if entry is None:
            return None
        from spark_rapids_tpu_torch.sources import create_scan
        fmt, paths, options = entry
        return DataFrame(create_scan(fmt, paths, self._session.conf,
                                     **options), self._session)

    def table(self, name: str):
        df = self.lookup_relation(name)
        if df is None:
            raise ColumnarProcessingError(
                f"table or view {name!r} not found "
                f"(known: {self.list_tables()})")
        return df
