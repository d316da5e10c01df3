"""Declarative request/fit descriptions for the ``PolyFit`` session facade.

The twin of ``repro.api.spec`` for static, dynamic and windowed one-key
tables and static and dynamic two-key tables.  ``QuerySpec`` names a
fitted table and carries the query ranges (scalars or equal-length
batches): ``(lq, uq)`` for one key, ``(lx, ux, ly, uy)`` for a 2-D rectangle, ``(u, v)`` for a
2-D dominance corner — or, for ``kind='quantile'``, the rank fractions
alone, and for ``kind='window'`` an inclusive epoch interval ``params=(t0,
t1)`` beside the range; ``QueryBatch`` is an ordered tuple of specs that
may mix kinds and tables freely — the session groups them by (table, kind,
guarantee, params), dispatches each group through one executor, and
scatters answers back in request order.

``TableSpec`` is the fit-time counterpart: aggregate family, ``ErrorBudget``
(the only source of build deltas — see ``budget.py``), degree, the delta
buffer of a ``dynamic`` table, the level ladder of an ``lsm`` table, the
epoch ring of a ``window`` table, the partition count of a ``shards``
table and the serving guarantee class (``deadline``, ``priority``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .budget import DELTA_FRACTION, ErrorBudget

__all__ = ["QuerySpec", "QueryBatch", "TableSpec", "DEFAULT_REL", "KINDS",
           "KIND_OF_AGG"]

# sentinel: "use the table budget's rel" (None means "Q_abs only, no
# refinement", so a third state is needed for per-spec overrides)
DEFAULT_REL = ...

_NRANGES = {"sum": 2, "count": 2, "max": 2, "min": 2, "count2d": 4,
            "sum2d": 4, "max2d": 2, "min2d": 2}

# query kinds a spec can name explicitly
KINDS = ("count", "sum", "max", "min", "quantile", "window")

# kind a kind-less spec resolves to from its table's aggregate
KIND_OF_AGG = {"count": "count", "sum": "sum", "max": "max", "min": "min",
               "count2d": "count", "sum2d": "sum", "max2d": "max",
               "min2d": "min"}

def _norm_range(r):
    """Normalize one range coordinate to a rank-1 array: tensors stay on
    their device, everything else becomes a host float64 array."""
    if isinstance(r, torch.Tensor):
        return torch.atleast_1d(r)
    return np.atleast_1d(np.asarray(r, np.float64))


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    """One declarative request: ``QuerySpec.range("sales", lo, hi)``.

    ``ranges`` is ``(lq, uq)`` (``(q,)`` for quantiles); entries may be
    python scalars or equal-length 1-D arrays or tensors (a whole
    sub-batch in one spec).  ``rel`` overrides the table's default Q_rel
    target for this spec only: ``DEFAULT_REL`` (the default) inherits the
    table budget, ``None`` forces Q_abs-only, a float is an explicit
    eps_rel.  ``params`` is ``(t0, t1)`` for window specs, else empty.
    """

    table: str
    ranges: Tuple
    rel: object = DEFAULT_REL
    kind: Optional[str] = None
    params: Tuple = ()

    def __post_init__(self):
        if self.kind is not None and self.kind not in KINDS:
            raise ValueError(f"unknown query kind {self.kind!r}; expected "
                             f"one of {KINDS}")
        if self.kind == "quantile":
            if len(self.ranges) != 1:
                raise ValueError("quantile specs carry exactly the rank "
                                 f"fractions; got {len(self.ranges)} ranges")
        elif self.kind == "window":
            if len(self.ranges) != 2:
                raise ValueError("window specs carry (lq, uq); got "
                                 f"{len(self.ranges)} ranges")
            if len(self.params) != 2:
                raise ValueError("window specs need params=(t0, t1); got "
                                 f"{self.params!r}")
        elif len(self.ranges) not in (2, 4):
            raise ValueError("QuerySpec.ranges must have 2 entries (1-D) or "
                             f"4 (2-D); got {len(self.ranges)}")
        object.__setattr__(self, "ranges",
                           tuple(_norm_range(r) for r in self.ranges))
        object.__setattr__(self, "params",
                           tuple(int(p) for p in self.params))
        n = {r.shape[0] for r in self.ranges}
        if len(n) != 1:
            raise ValueError(f"QuerySpec.ranges lengths differ: {sorted(n)}")

    def __len__(self) -> int:
        return int(self.ranges[0].shape[0])

    @classmethod
    def range(cls, table: str, lq, uq, rel=DEFAULT_REL) -> "QuerySpec":
        """1-D range (SUM/COUNT over (lq, uq], MAX/MIN over [lq, uq])."""
        return cls(table, (lq, uq), rel)

    @classmethod
    def rect(cls, table: str, lx, ux, ly, uy, rel=DEFAULT_REL) -> "QuerySpec":
        """2-key COUNT/SUM over the rectangle (lx, ux] x (ly, uy]."""
        return cls(table, (lx, ux, ly, uy), rel)

    @classmethod
    def corner(cls, table: str, u, v, rel=DEFAULT_REL) -> "QuerySpec":
        """2-key dominance MAX/MIN over {x <= u, y <= v}."""
        return cls(table, (u, v), rel)

    @classmethod
    def quantile(cls, table: str, q, rel=None) -> "QuerySpec":
        """Certified q-quantile(s): the answer interval brackets the exact
        order statistic (SUM/COUNT tables only).  ``rel`` is accepted for
        symmetry but quantiles always answer with their certified key
        interval — there is no refinement path."""
        return cls(table, (q,), rel, kind="quantile")

    @classmethod
    def window(cls, table: str, lq, uq, t0, t1,
               rel=DEFAULT_REL) -> "QuerySpec":
        """Range aggregate restricted to epochs ``t0..t1`` inclusive of a
        windowed table (``TableSpec.window > 0``)."""
        return cls(table, (lq, uq), rel, kind="window",
                   params=(int(t0), int(t1)))


@dataclasses.dataclass(frozen=True)
class QueryBatch:
    """An ordered, possibly mixed-aggregate batch of ``QuerySpec``s."""

    specs: Tuple[QuerySpec, ...]

    def __post_init__(self):
        object.__setattr__(self, "specs", tuple(self.specs))

    @classmethod
    def of(cls, *specs: QuerySpec) -> "QueryBatch":
        return cls(specs)

    def __len__(self) -> int:
        return len(self.specs)

    def __iter__(self):
        return iter(self.specs)

    def __getitem__(self, i):
        return self.specs[i]

    @property
    def n_queries(self) -> int:
        return sum(len(s) for s in self.specs)


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """Fit-time description of one table (dataset x aggregate).

    ``agg``: 'sum' | 'count' | 'max' | 'min' for one key, or 'count2d' |
    'sum2d' | 'max2d' | 'min2d' for two (2-D MAX/MIN are dominance-corner
    queries).  ``budget``: the table's ``ErrorBudget`` — the *only* place
    the build delta comes from.  ``deg`` defaults to 2 for SUM/COUNT and 3
    for MAX/MIN/2-D (the paper's recommendations).  ``dynamic`` wraps the
    plan in a delta-buffered engine (inserts/deletes without rebuild, one
    key or two): ``capacity`` is the buffer's size (a power of two),
    ``background`` runs merges on a worker thread, ``auto_refit`` merges
    when the buffer fills (or, for one key, when a segment's drift passes
    its headroom).  ``window`` (the number of sealed epochs to retain) makes
    an epoch-ring table that takes ``ingest``/``advance_epoch`` and answers
    window queries; ``capacity`` is then the open epoch's buffer.  ``lsm``
    (requires ``dynamic``) tiers the table into a geometric ladder of
    immutable plans (``engine/lsm.py`` — bounded compactions instead of
    full refits, deletes that never merge; ``growth`` is the ladder's
    geometric factor).  ``shards`` (a power of two, checked when the
    table is fitted) partitions the table's plan — or every level of its
    ladder — into that many contiguous key ranges (Morton z-ranges for two
    keys) that queries answer shard by shard (``engine/sharded.py``);
    window tables take no shards.

    ``deadline``/``priority`` declare the table's serving guarantee class:
    ``deadline`` is the default admission deadline in seconds for reads on
    this table (a request still queued when it expires fails with
    ``DeadlineExceeded`` instead of dispatching; ``None`` = no deadline),
    and ``priority`` picks the table's rung on the serving engine's
    load-shedding ladder (higher sheds later).  Both can be overridden per
    request at ``ServingEngine.submit``.
    """

    agg: str
    budget: ErrorBudget
    deg: Optional[int] = None
    dynamic: bool = False
    lsm: bool = False
    growth: int = 4
    capacity: int = 1024
    background: bool = True
    auto_refit: bool = True
    shards: Optional[int] = None
    deadline: Optional[float] = None
    priority: int = 0
    window: int = 0

    def __post_init__(self):
        if self.agg not in _NRANGES:
            raise ValueError(f"unknown aggregate {self.agg!r}; expected one "
                             f"of {sorted(_NRANGES)}")
        assert self.agg in DELTA_FRACTION
        if self.window:
            if self.window < 1:
                raise ValueError("window must be >= 1 retained epochs "
                                 "(or 0 for a non-windowed table)")
            if self.agg not in ("sum", "count"):
                raise ValueError("windowed tables support 1-D SUM/COUNT "
                                 f"only, got {self.agg!r}")
            if self.dynamic or self.lsm or self.shards:
                raise ValueError("window tables manage their own epoch "
                                 "ring; dynamic/lsm/shards do not apply")
        if self.lsm and not self.dynamic:
            raise ValueError("lsm=True tiers the *update* path into a level "
                             "ladder; it requires dynamic=True")
        if self.growth < 2:
            raise ValueError("growth must be >= 2")
        if self.deadline is not None and self.deadline <= 0:
            raise ValueError("deadline must be positive seconds (or None)")
        if self.priority < 0:
            raise ValueError("priority must be >= 0")

    @property
    def degree(self) -> int:
        return self.deg if self.deg is not None else (
            2 if self.agg in ("sum", "count") else 3)

    @property
    def n_ranges(self) -> int:
        return _NRANGES[self.agg]
