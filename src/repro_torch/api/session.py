"""The ``PolyFit`` session facade for one-key tables (static, dynamic,
windowed) and two-key tables (static, dynamic).

The twin of ``repro.api.session``:

    from repro_torch.api import ErrorBudget, PolyFit, QueryBatch, QuerySpec, TableSpec

    session = PolyFit.fit(
        {"lat": keys, "price": (ts, vals)},
        {"lat":   TableSpec("count", ErrorBudget(abs=100, rel=0.01)),
         "price": TableSpec("max",   ErrorBudget(abs=50.0))})
    results = session.query(QueryBatch.of(
        QuerySpec.range("lat", -10.0, 30.0),
        QuerySpec.range("price", t0, t1)))

``fit`` builds one index per named table on the host, with the delta its
``ErrorBudget`` derives (Lemma 5.1/5.3 — see ``budget.py``), and lowers each
to a plan on the query device: the card unless ``device`` says otherwise.
``query`` groups a mixed batch by (table, kind, guarantee), pads each group
to its power-of-two bucket, runs one fused executor per group, and scatters
the answers back in request order.

A table fitted with ``TableSpec(..., dynamic=True)`` sits behind a
``DynamicEngine``: ``insert``/``delete`` buffer updates that every query
folds in exactly, ``flush`` merges them into a selectively refit plan.
``QuerySpec.quantile`` asks a static or dynamic SUM/COUNT table for
certified quantiles (the answer's ``bound`` is the ``(lo, hi)`` key
interval).  A table fitted with ``TableSpec(..., window=ring)`` is an epoch
ring (``WindowEngine``): ``ingest`` appends to the open epoch,
``advance_epoch`` seals it, and ``QuerySpec.window(table, lq, uq, t0, t1)``
reads the epochs t0..t1 with the bound composed over them.  A two-key
table (``count2d``/``sum2d`` rectangles through ``QuerySpec.rect``,
``max2d``/``min2d`` dominance corners through ``QuerySpec.corner``) takes
``(xs, ys)`` or ``(xs, ys, measures)`` and is fitted as a quadtree
(``build_index_2d``); its specs mix freely with one-key specs in a batch.
A dynamic two-key table sits behind a ``DynamicEngine2D`` and takes
``insert(table, xs, ys[, measures])`` and ``delete(table, xs, ys)``.  A
table fitted with ``TableSpec(..., dynamic=True, lsm=True)`` sits behind an
``LsmEngine`` / ``LsmEngine2D`` geometric level ladder instead: the same
``insert``/``delete``/``flush`` calls, deletes that shadow their rows and
never merge, and compactions that refit only the levels they fold.  A
table fitted with ``TableSpec(..., shards=S)`` partitions its plan (every
level of an LSM ladder) into S contiguous key ranges (Morton z-ranges for
two keys) at fit, and its queries run shard by shard through a
``ShardedEngine`` / ``ShardedEngine2D`` on the ``'torch'`` arithmetic, the
reference's shard semantics; a dynamic sharded table answers from its live
(plan, buffer) snapshot, and quantiles run on the unsharded plan.

The serving hooks (``snapshot``, ``resolve_rel``, ``on_plan_swap``,
``admission_class``, ``serving_executor``, ``resolve_spec``,
``resolve_kind``, ``window_snapshot``) are what
``repro_torch.serve.ServingEngine`` drives a session through.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import DTYPE, resolve_device
from ..core import AGGS_2D, build_index_1d, build_index_2d
from ..engine import (DynamicEngine, DynamicEngine2D, IndexPlan, IndexPlan2D,
                      LsmEngine, LsmEngine2D, ShardedEngine, ShardedEngine2D,
                      WindowEngine, build_plan, build_plan_2d, execute,
                      execute_quantile, fused_executor,
                      fused_quantile_executor, resolve_backend)
from .budget import ErrorBudget
from .spec import DEFAULT_REL, KIND_OF_AGG, QueryBatch, QuerySpec, TableSpec

__all__ = ["PolyFit", "Answer"]

Request = Union[QuerySpec, QueryBatch, Sequence[QuerySpec]]


@dataclasses.dataclass(frozen=True)
class Answer:
    """One structured query answer.

    ``value`` is the (possibly refined) answer batch; ``approx``/``refined``
    expose the raw index answers and the Q_rel refinement mask exactly as
    :class:`~repro_torch.core.queries.QueryResult` does.  ``bound`` is the
    certified guarantee that travels with the answer: the scalar Q_abs
    bound for range aggregates (composed over the selected epochs for
    window queries), or the ``(lo, hi)`` certified key interval for
    quantiles (``value`` is clipped inside it).  ``staleness`` counts the
    buffered-but-unmerged rows of a dynamic table, the trailing epochs
    (current minus ``t1``) of a window query, 0 for static tables; buffered
    rows are still folded in exactly, so it is an operational signal, not
    extra error.  ``.answer`` aliases ``value``.
    """

    value: torch.Tensor
    approx: torch.Tensor
    refined: torch.Tensor
    bound: object = None
    staleness: int = 0

    @property
    def answer(self):
        return self.value

    def __iter__(self):   # (value, approx, refined) unpacking
        return iter((self.value, self.approx, self.refined))


class _Table:
    """One fitted table: the spec and its device plan, the
    ``DynamicEngine`` / ``DynamicEngine2D`` that holds it for a dynamic
    table (``LsmEngine`` / ``LsmEngine2D`` for an LSM-tiered one), or the
    ``WindowEngine`` of an epoch-ring table; and, for a sharded table, the
    ``ShardedEngine`` / ``ShardedEngine2D`` its queries run through."""

    def __init__(self, name: str, spec: TableSpec, data, *,
                 device: torch.device, backend: str, min_bucket: int):
        self.name = name
        self.spec = spec
        self.dyn: Union[DynamicEngine, DynamicEngine2D, LsmEngine,
                        LsmEngine2D, None] = None
        self.win: Optional[WindowEngine] = None
        self.sharded: Union[ShardedEngine, ShardedEngine2D, None] = None
        self._static_plan: Union[IndexPlan, IndexPlan2D, None] = None
        self._certified = float(spec.budget.delta(spec.agg))
        t0 = time.perf_counter()
        self._build(data, device=device, backend=backend,
                    min_bucket=min_bucket)
        if spec.shards is not None:
            cls = ShardedEngine2D if spec.agg in AGGS_2D else ShardedEngine
            self.sharded = cls(spec.shards, min_bucket=min_bucket)
            self.sharded.shard(self.plan)   # warm the partition cache
        self.build_seconds = time.perf_counter() - t0

    def _build(self, data, *, device: torch.device, backend: str,
               min_bucket: int) -> None:
        spec = self.spec
        agg, delta = spec.agg, spec.budget.delta(spec.agg)
        if agg in AGGS_2D:
            xs, ys, ws = (None if a is None else np.asarray(a, np.float64)
                          for a in data)
            if spec.lsm:
                self.dyn = LsmEngine2D(
                    xs, ys, ws, agg=agg, deg=spec.degree, delta=delta,
                    backend=backend, capacity=spec.capacity,
                    growth=spec.growth, background=spec.background,
                    auto_refit=spec.auto_refit, min_bucket=min_bucket,
                    device=device)
                return
            idx = build_index_2d(xs, ys, measures=ws, agg=agg,
                                 deg=spec.degree, delta=delta, device=device)
            if spec.dynamic:
                self.dyn = DynamicEngine2D(
                    idx, backend=backend, capacity=spec.capacity,
                    background=spec.background, auto_refit=spec.auto_refit,
                    min_bucket=min_bucket)
            else:
                self._certified = idx.certified_delta
                self._static_plan = build_plan_2d(idx)
            return
        keys, meas = data
        keys = np.asarray(keys, np.float64)
        meas = None if meas is None else np.asarray(meas, np.float64)
        if spec.window:
            self.win = WindowEngine(
                keys, meas, agg=agg, delta=delta, deg=spec.degree,
                ring=spec.window, capacity=spec.capacity, backend=backend,
                device=device, min_bucket=min_bucket)
        elif spec.lsm:
            self.dyn = LsmEngine(
                keys, meas, agg=agg, deg=spec.degree, delta=delta,
                backend=backend, capacity=spec.capacity, growth=spec.growth,
                background=spec.background, auto_refit=spec.auto_refit,
                min_bucket=min_bucket, device=device)
        else:
            idx = build_index_1d(keys, meas, agg, deg=spec.degree,
                                 delta=delta, device=device)
            if spec.dynamic:
                self.dyn = DynamicEngine(
                    idx, backend=backend, capacity=spec.capacity,
                    background=spec.background, auto_refit=spec.auto_refit,
                    min_bucket=min_bucket)
            else:
                self._static_plan = build_plan(idx)

    @property
    def certified_delta(self) -> float:
        """The error every leaf is certified to: delta, unless a 2-D leaf
        stopped at max_depth with residual error; a dynamic 2-D table's
        follows its live index through merges."""
        if isinstance(self.dyn, DynamicEngine2D):
            return self.dyn.index.certified_delta
        return self._certified

    @property
    def plan(self) -> Union[IndexPlan, IndexPlan2D]:
        if self.win is not None:
            raise RuntimeError(
                f"table {self.name!r} is windowed — there is no single "
                "plan; take window_snapshot(t0, t1) snapshots instead")
        return self.dyn.plan if self.dyn is not None else self._static_plan

    def size_bytes(self) -> int:
        if self.win is not None:
            return sum(lvl.plan.size_bytes() for lvl in self.win.levels())
        return self.plan.size_bytes()

    def snapshot(self):
        """Immutable (plan, delta-buffer) pair; ``()`` buffer when static."""
        if self.dyn is not None:
            return self.dyn.snapshot()
        return self._static_plan, ()

    def staleness(self, kind: str, params: Tuple) -> int:
        if kind == "window":
            return max(0, self.win.epoch - params[1])
        return self.dyn.n_pending if self.dyn is not None else 0

    def resolve_rel(self, rel) -> Optional[float]:
        return self.spec.budget.rel if rel is DEFAULT_REL else rel

    @property
    def kind(self) -> str:
        """The range-query kind this table's aggregate answers."""
        return KIND_OF_AGG[self.spec.agg]


class PolyFit:
    """A fitted PolyFit session — construct with :meth:`fit`."""

    def __init__(self, tables: Dict[str, _Table], *, backend: str,
                 device: torch.device, min_bucket: int):
        self._tables = tables
        self.backend = backend
        self.device = device
        self.min_bucket = min_bucket

    # -- construction ----------------------------------------------------

    @classmethod
    def fit(cls, datasets: Mapping, specs: Mapping[str, TableSpec], *,
            backend: Optional[str] = None, device=None,
            min_bucket: int = 64) -> "PolyFit":
        """Build one index per named table and return the query session.

        ``datasets`` maps table name -> data: a bare key array (COUNT),
        ``(keys, measures)`` for SUM/MAX/MIN, ``(xs, ys)`` for 2-key COUNT
        and ``(xs, ys, measures)`` for 2-key SUM/MAX/MIN.  ``specs`` maps
        the same names to ``TableSpec``s; the spec's ``ErrorBudget`` is the
        only source of build deltas.  ``device`` defaults to the card and raises
        ``RuntimeError`` when there is none; ``backend`` defaults to
        ``'cuda'`` on a CUDA device and ``'torch'`` on the CPU
        (``'cuda_scan'`` selects the one-hot scan kernels, and the whole-log
        scans K16-K20 for the buffered corrections of dynamic tables).
        """
        device = resolve_device(device)
        backend = resolve_backend(backend, device)
        missing = set(datasets) ^ set(specs)
        if missing:
            raise ValueError(f"datasets and specs disagree on tables: "
                             f"{sorted(missing)}")
        tables = {}
        for name, spec in specs.items():
            data = datasets[name]
            if spec.agg == "count2d":
                if not (isinstance(data, tuple) and len(data) == 2):
                    raise ValueError(f"table {name!r}: count2d data must be "
                                     "(xs, ys)")
                data = (*data, None)
            elif spec.agg in AGGS_2D:
                if not (isinstance(data, tuple) and len(data) == 3):
                    raise ValueError(f"table {name!r}: {spec.agg} data must "
                                     "be (xs, ys, measures)")
            elif spec.agg == "count":
                if not isinstance(data, tuple):
                    data = (data, None)
                elif len(data) == 1:
                    data = (data[0], None)
            elif not (isinstance(data, tuple) and len(data) == 2):
                raise ValueError(f"table {name!r}: {spec.agg} data must be "
                                 "(keys, measures)")
            tables[name] = _Table(name, spec, data, device=device,
                                  backend=backend, min_bucket=min_bucket)
        return cls(tables, backend=backend, device=device,
                   min_bucket=min_bucket)

    # -- introspection ---------------------------------------------------

    @property
    def tables(self) -> Tuple[str, ...]:
        return tuple(self._tables)

    def spec(self, table: str) -> TableSpec:
        return self._table(table).spec

    def budget(self, table: str) -> ErrorBudget:
        return self._table(table).spec.budget

    def plan(self, table: str) -> Union[IndexPlan, IndexPlan2D]:
        """The table's current device plan (fresh after dynamic merges)."""
        return self._table(table).plan

    def snapshot(self, table: str):
        """The table's current immutable (plan, delta-buffer) pair; static
        tables return ``()`` for the buffer.  Merges install a *new* plan
        object, so the pair is safe to hold across a dispatch."""
        return self._table(table).snapshot()

    def size_bytes(self) -> Dict[str, int]:
        return {k: t.size_bytes() for k, t in self._tables.items()}

    def certified_delta(self, table: str) -> float:
        """The per-leaf error the table's fit is certified to: its build
        delta, or more where a 2-D leaf stopped at the tree's max_depth
        (``PolyFitIndex2D.certified_delta``); dominance MAX/MIN answers
        hold this bound, rectangles four times it."""
        return self._table(table).certified_delta

    def build_seconds(self) -> Dict[str, float]:
        """Host seconds each table's index build and plan lowering took."""
        return {k: t.build_seconds for k, t in self._tables.items()}

    def _table(self, name: str) -> _Table:
        t = self._tables.get(name)
        if t is None:
            raise KeyError(f"unknown table {name!r}; fitted tables: "
                           f"{sorted(self._tables)}")
        return t

    def is_sharded(self, table: str) -> bool:
        """True when the table is partitioned (``TableSpec.shards``)."""
        return self._table(table).sharded is not None

    def is_lsm(self, table: str) -> bool:
        """True when the table is a tiered level ladder (``lsm=True``)."""
        return self._table(table).spec.lsm

    def is_window(self, table: str) -> bool:
        """True when the table is an epoch ring (``TableSpec.window``)."""
        return self._table(table).win is not None

    # -- serving hooks (repro_torch.serve.engine) --------------------------

    def resolve_rel(self, table: str, rel=DEFAULT_REL) -> Optional[float]:
        """Concrete eps_rel for ``table``: the budget's default unless a
        per-request override is given."""
        return self._table(table).resolve_rel(rel)

    def on_plan_swap(self, table: str, fn) -> None:
        """Register ``fn(incoming_plan)`` to run on the merge/compaction
        thread immediately *before* a refit installs the new plan (or
        ladder).  The serving engine uses this to capture the incoming
        plan's warmed buckets so post-swap dispatches never capture; a
        listener exception aborts the install and surfaces as the table's
        refit error."""
        self._dyn(table).add_install_listener(fn)

    def admission_class(self, table: str) -> Tuple[Optional[float], int]:
        """The table's serving guarantee class ``(deadline, priority)``
        (``TableSpec.deadline``/``priority``) — the serving engine's
        per-request defaults for admission deadlines and load shedding."""
        spec = self._table(table).spec
        return spec.deadline, spec.priority

    def serving_executor(self, table: str, eps_rel: Optional[float], *,
                         kind: str = "range"):
        """A plain ``fn(plan, buf, *padded_ranges)`` for ``table`` with this
        session's backend closed over — the unit the serving engine caches
        (and captures as a CUDA graph on the card) per bucket size.
        ``kind='quantile'`` returns the CF-inversion executor ``fn(plan,
        buf, padded_qs)`` instead of the range one."""
        t = self._table(table)
        if kind == "quantile":
            return fused_quantile_executor(t.dyn is not None,
                                           backend=self.backend,
                                           deg=t.spec.degree)
        return fused_executor(t.spec.agg, t.dyn is not None,
                              backend=self.backend, eps_rel=eps_rel,
                              deg=t.spec.degree)

    def resolve_spec(self, spec: QuerySpec):
        """Validated ``(kind, eps_rel, params)`` grouping coordinates for a
        spec — the serving engine's admission-time resolution (quantiles
        force ``eps_rel=None``; kind-less specs resolve from the table's
        aggregate)."""
        return self._resolve(spec)

    def resolve_kind(self, table: str, kind: Optional[str]) -> str:
        """Concrete query kind for ``table``: an explicit spec kind wins, a
        ``None`` kind resolves from the table's aggregate."""
        return self._table(table).kind if kind is None else kind

    def window_bound(self, table: str, t0: int, t1: int) -> float:
        """Certified Q_abs bound of a [t0, t1] window answer."""
        return self._win(table).bound(t0, t1)

    def window_snapshot(self, table: str, t0: int, t1: int):
        """Atomic (LsmPlan-or-None, buf-or-None) snapshot of a window."""
        return self._win(table).window_plan(t0, t1)

    # -- queries ---------------------------------------------------------

    def query(self, request: Request):
        """Answer a request batch, preserving request order.

        A single ``QuerySpec`` returns its :class:`Answer`; a ``QueryBatch``
        (or a sequence of specs) returns a list of ``Answer``s aligned with
        the specs.  Specs are grouped by (table, kind, guarantee, params);
        each group enters one executor.
        """
        if isinstance(request, QuerySpec):
            kind, rel, params = self._resolve(request)
            res = self._exec_group(request.table, kind, request.ranges, rel,
                                   params)
            return self._wrap(request.table, kind, params, res)
        specs = list(request.specs if isinstance(request, QueryBatch)
                     else request)
        if not specs:
            return []
        groups: Dict[Tuple, List[int]] = {}
        for i, spec in enumerate(specs):
            if not isinstance(spec, QuerySpec):
                raise TypeError(f"expected QuerySpec, got {type(spec)}")
            kind, rel, params = self._resolve(spec)
            groups.setdefault((spec.table, kind, rel, params), []).append(i)
        out: List[Optional[Answer]] = [None] * len(specs)
        for (table, kind, rel, params), idxs in groups.items():
            ranges = tuple(self._concat([specs[i].ranges[j] for i in idxs])
                           for j in range(len(specs[idxs[0]].ranges)))
            res = self._exec_group(table, kind, ranges, rel, params)
            off = 0
            for i in idxs:
                m = len(specs[i])
                part = type(res)(*(f[off:off + m] for f in res))
                out[i] = self._wrap(table, kind, params, part)
                off += m
        return out

    def _concat(self, parts):
        """One range coordinate of a group: a host concat for numpy parts,
        a device concat once any part is a tensor."""
        if len(parts) == 1:
            return parts[0]
        if all(isinstance(p, np.ndarray) for p in parts):
            return np.concatenate(parts)
        return torch.cat([torch.as_tensor(p, dtype=DTYPE, device=self.device)
                          for p in parts])

    def _resolve(self, spec: QuerySpec):
        """Validate a spec against its table and return the concrete
        ``(kind, eps_rel, params)`` grouping coordinates."""
        t = self._table(spec.table)
        kind = t.kind if spec.kind is None else spec.kind
        if kind == "quantile":
            if t.spec.agg not in ("sum", "count") or t.spec.window:
                raise ValueError(
                    f"table {spec.table!r} ({t.spec.agg}"
                    f"{', windowed' if t.spec.window else ''}) cannot "
                    "answer quantiles; they invert 1-D SUM/COUNT tables")
            if t.spec.lsm:
                raise ValueError(
                    f"table {spec.table!r} is LSM-tiered; quantile "
                    "inversion needs a single fitted CF (flush to a "
                    "dynamic or static table)")
            return kind, None, ()    # no refinement path
        if kind == "window":
            if t.win is None:
                raise ValueError(
                    f"table {spec.table!r} is not windowed; fit it with "
                    "TableSpec(window=<ring>) to take window queries")
            return kind, t.resolve_rel(spec.rel), spec.params
        if t.win is not None:
            raise ValueError(
                f"table {spec.table!r} is windowed; use "
                "QuerySpec.window(..., t0, t1) to name the epoch range")
        if kind != t.kind:
            raise ValueError(
                f"table {spec.table!r} ({t.spec.agg}) answers "
                f"{t.kind!r} queries, spec asks for {kind!r}")
        if len(spec.ranges) != t.spec.n_ranges:
            raise ValueError(
                f"table {spec.table!r} ({t.spec.agg}) takes "
                f"{t.spec.n_ranges} range coordinates, spec has "
                f"{len(spec.ranges)}")
        return kind, t.resolve_rel(spec.rel), ()

    def _exec_group(self, table: str, kind: str, ranges, eps_rel, params):
        t = self._table(table)
        if kind == "quantile":
            (qs,) = ranges
            if t.sharded is not None:
                plan, buf = t.snapshot()
                return t.sharded.quantile(plan, qs, buf=buf or None)
            if t.dyn is not None:
                return t.dyn.quantile(qs)
            return execute_quantile(t.plan, qs, backend=self.backend,
                                    min_bucket=self.min_bucket)
        if kind == "window":
            return t.win.query(*ranges, *params, eps_rel=eps_rel)
        if t.sharded is not None:
            plan, buf = t.snapshot()
            return t.sharded.query(plan, *ranges, eps_rel=eps_rel,
                                   buf=buf or None)
        if t.dyn is not None:
            return t.dyn.query(*ranges, eps_rel=eps_rel)
        return execute(t.plan, ranges, backend=self.backend,
                       eps_rel=eps_rel, min_bucket=self.min_bucket)

    def _wrap(self, table: str, kind: str, params, res) -> Answer:
        t = self._table(table)
        stale = t.staleness(kind, params)
        if kind == "quantile":
            return Answer(res.answer, res.answer,
                          torch.zeros(res.answer.shape, dtype=torch.bool,
                                      device=res.answer.device),
                          bound=(res.lo, res.hi), staleness=stale)
        bound = (t.win.bound(*params) if kind == "window"
                 else t.spec.budget.bound(t.spec.agg))
        return Answer(res.answer, res.approx, res.refined, bound=bound,
                      staleness=stale)

    # -- updates (dynamic tables) ----------------------------------------

    def _dyn(self, table: str) -> Union[DynamicEngine, DynamicEngine2D,
                                        LsmEngine, LsmEngine2D]:
        t = self._table(table)
        if t.dyn is None:
            raise RuntimeError(f"table {table!r} is static; fit it with "
                               "TableSpec(dynamic=True) to take updates")
        return t.dyn

    def insert(self, table: str, *args) -> None:
        """Buffer new records: ``(keys[, measures])``, or ``(xs, ys[,
        measures])`` for a two-key table.  Queries fold them in exactly."""
        self._dyn(table).insert(*args)

    def delete(self, table: str, *args) -> None:
        """Buffer delete tombstones for existing records: ``(keys)``, or
        ``(xs, ys)`` for a two-key table."""
        self._dyn(table).delete(*args)

    def flush(self, table: Optional[str] = None) -> None:
        """Merge buffered updates into fresh plans (all dynamic tables by
        default)."""
        names = [table] if table is not None else [
            k for k, t in self._tables.items() if t.dyn is not None]
        for name in names:
            self._dyn(name).flush()

    # -- windowed tables --------------------------------------------------

    def _win(self, table: str) -> WindowEngine:
        t = self._table(table)
        if t.win is None:
            raise RuntimeError(f"table {table!r} is not windowed; fit it "
                               "with TableSpec(window=<ring>) to stream "
                               "epochs")
        return t.win

    def ingest(self, table: str, keys, measures=None) -> None:
        """Append rows to a windowed table's open epoch (exact until sealed
        by :meth:`advance_epoch`)."""
        self._win(table).ingest(keys, measures)

    def advance_epoch(self, table: str) -> int:
        """Seal the open epoch into an immutable fitted plan on the ring;
        returns the new open epoch id."""
        return self._win(table).advance()

    def epoch(self, table: str) -> int:
        """The windowed table's current open epoch id."""
        return self._win(table).epoch
