"""SQL front end (port of ``spark_rapids_tpu/sql``): text -> lexer ->
parser -> analyzer -> the port's DataFrame/plan layer.

Entry points:
  * ``TorchSession.sql(text)``              — run a statement
  * ``spark_rapids_tpu_torch.functions.expr`` — parse one expression
  * ``SessionCatalog``                      — temp views

The analyzer lowers onto plan nodes only; every SQL query then flows
through column pruning, the overrides and the execs exactly as a DSL
query does."""

from spark_rapids_tpu_torch.sql.analyzer import lower_statement  # noqa: F401
from spark_rapids_tpu_torch.sql.catalog import SessionCatalog  # noqa: F401
from spark_rapids_tpu_torch.sql.errors import (  # noqa: F401
    SqlAnalysisError,
    SqlError,
    SqlParseError,
)
from spark_rapids_tpu_torch.sql.parser import (  # noqa: F401
    parse_expression,
    parse_statement,
)
