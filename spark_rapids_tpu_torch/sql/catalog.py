"""Session catalog: temp views (port of the temp-view part of
``spark_rapids_tpu/sql/catalog.py``, Spark's SessionCatalog slice).

A temp view holds a plan; ``SELECT ... FROM name`` reads that plan. Views
over file-format tables (``register_table``, ``CREATE TEMP VIEW ...
USING fmt``) need the IO layer and session-scoped functions need
``udf.py``; neither is ported, so both raise NotImplementedError."""

from __future__ import annotations

from typing import Dict, List

from spark_rapids_tpu_torch.errors import ColumnarProcessingError


class SessionCatalog:
    def __init__(self, session):
        self._session = session
        #: name -> PlanNode (shared subtree; plan nodes are not mutated)
        self._views: Dict[str, object] = {}

    # -- temp views ----------------------------------------------------------
    def create_or_replace_temp_view(self, name: str, df) -> None:
        self._views[name.lower()] = getattr(df, "plan", df)

    def drop_temp_view(self, name: str) -> bool:
        return self._views.pop(name.lower(), None) is not None

    def list_tables(self) -> List[str]:
        return sorted(self._views)

    # -- what is not ported --------------------------------------------------
    def register_table(self, name: str, fmt: str, *paths, **options):
        raise NotImplementedError(
            f"table {name!r} over {fmt} files: file sources (io/*, "
            "sources.py) are not ported to spark_rapids_tpu_torch yet")

    def register_function(self, name: str, builder) -> None:
        raise NotImplementedError(
            f"session function {name!r}: session-scoped SQL functions "
            "(registered Python UDFs, udf.py) are not ported to "
            "spark_rapids_tpu_torch yet; functions.register_sql_function "
            "registers a builder for every session")

    # -- resolution ----------------------------------------------------------
    def lookup_relation(self, name: str):
        """DataFrame over a temp view, else None."""
        from spark_rapids_tpu_torch.plan import DataFrame
        plan = self._views.get(name.lower())
        return None if plan is None else DataFrame(plan, self._session)

    def table(self, name: str):
        df = self.lookup_relation(name)
        if df is None:
            raise ColumnarProcessingError(
                f"table or view {name!r} not found "
                f"(known: {self.list_tables()})")
        return df
