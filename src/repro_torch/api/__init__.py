"""repro_torch.api — the declarative PolyFit query API (one-key tables:
static, dynamic, windowed; static two-key tables).

* ``ErrorBudget(abs=..., rel=...)`` — the composable error budget; the only
  place the Lemma 5.1/5.3/6.3 delta derivations live.
* ``TableSpec`` — fit-time description of a table (aggregate, budget,
  degree).
* ``QuerySpec`` / ``QueryBatch`` — declarative request batches.
* ``PolyFit`` — the session facade: ``PolyFit.fit(datasets, specs)`` builds
  the indexes on the host and their plans on the card,
  ``session.query(batch)`` answers mixed batches in request order as
  ``Answer``s.
"""
from .budget import ErrorBudget
from .session import Answer, PolyFit
from .spec import DEFAULT_REL, QueryBatch, QuerySpec, TableSpec

__all__ = ["Answer", "ErrorBudget", "PolyFit", "QueryBatch", "QuerySpec",
           "TableSpec", "DEFAULT_REL"]
