"""ErrorBudget — the one place the paper's delta derivations live.

A straight copy of ``repro.api.budget``.

PolyFit guarantees are stated per aggregate family against the *index build
parameter* delta (the per-segment minimax fitting tolerance), while callers
think in terms of the answer-level bounds eps_abs / eps_rel:

* SUM/COUNT  — Lemma 5.1: |A - R| <= 2*delta, so build with delta = eps_abs/2;
* MAX/MIN    — Lemma 5.3: |A - R| <= delta,   so build with delta = eps_abs;
* 2-key COUNT — Lemma 6.3: |A - R| <= 4*delta, so build with delta = eps_abs/4.

Before this module those divisions were hand-inlined at every build site
(``serve/aggregates.py``, ``examples/*.py``), with nothing keeping the
service's convention in sync with the engine's acceptance tests (Lemma
5.2/5.4/6.4 read ``plan.delta`` directly).  ``ErrorBudget`` owns the
conversion in both directions and travels with a ``TableSpec`` through the
``repro.api.PolyFit`` facade, so a request-level guarantee is one declarative
object instead of scattered ``delta``/``eps_rel`` kwargs — the composable
error accounting arXiv:2503.05007 / arXiv:2506.20139 argue for.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ErrorBudget", "DELTA_FRACTION"]

# delta = DELTA_FRACTION[agg] * eps_abs  (Lemmas 5.1 / 5.3 / 6.3; the 2-D
# measure aggregates follow the same shapes — 4-corner SUM inherits the
# Lemma 6.3 factor, dominance MAX/MIN the Lemma 5.3 one, DESIGN.md §12)
DELTA_FRACTION = {"sum": 0.5, "count": 0.5, "max": 1.0, "min": 1.0,
                  "count2d": 0.25, "sum2d": 0.25, "max2d": 1.0,
                  "min2d": 1.0,
                  # quantile inversion widens the target rank by +-delta
                  # (plus data-dependent rank slack), so the rank-domain
                  # budget passes through 1:1 — DESIGN.md §16.  Not a
                  # TableSpec aggregate: quantiles read SUM/COUNT tables.
                  "quantile": 1.0}

# answer-level bound as a multiple of delta (the inverse direction: what a
# plan built with delta certifies — Lemmas 5.1 / 5.3 / 6.3 again)
BOUND_FACTOR = {"sum": 2.0, "count": 2.0, "max": 1.0, "min": 1.0,
                "count2d": 4.0, "sum2d": 4.0, "max2d": 1.0, "min2d": 1.0,
                "quantile": 1.0}


@dataclasses.dataclass(frozen=True)
class ErrorBudget:
    """Declarative per-table error budget: ``ErrorBudget(abs=100, rel=0.01)``.

    ``abs`` is the certified Q_abs bound the built index must satisfy on its
    raw answers (required — it fixes the build delta).  ``rel`` is the
    optional default Q_rel target: queries failing the Lemma 5.2/5.4/6.4
    acceptance test against it are refined exactly in-path.  ``rel=None``
    means Q_abs only (no refinement arrays consulted).
    """

    abs: float
    rel: Optional[float] = None

    def __post_init__(self):
        if not (self.abs > 0):
            raise ValueError(f"ErrorBudget.abs must be > 0, got {self.abs}")
        if self.rel is not None and not (self.rel > 0):
            raise ValueError(f"ErrorBudget.rel must be > 0 or None, "
                             f"got {self.rel}")

    @staticmethod
    def _check_agg(agg: str) -> None:
        if agg not in DELTA_FRACTION:
            raise ValueError(f"unknown aggregate {agg!r}; expected one of "
                             f"{sorted(DELTA_FRACTION)}")

    def delta(self, agg: str) -> float:
        """Index build tolerance for ``agg`` (Lemma 5.1 / 5.3 / 6.3)."""
        self._check_agg(agg)
        return DELTA_FRACTION[agg] * self.abs

    def bound(self, agg: str) -> float:
        """The certified |A - R| bound a plan built from this budget carries
        (equals ``abs`` by construction; exposed for assertions/tests)."""
        self._check_agg(agg)
        return BOUND_FACTOR[agg] * self.delta(agg)

    @classmethod
    def from_delta(cls, delta: float, agg: str,
                   rel: Optional[float] = None) -> "ErrorBudget":
        """Inverse constructor for callers holding a raw build delta."""
        cls._check_agg(agg)
        return cls(abs=delta / DELTA_FRACTION[agg], rel=rel)
