"""Aggregate-query serving on the declarative PolyFit session: the twin of
``repro.serve.aggregates``.

``AggregateService`` is the deployment-shaped wrapper around
``repro_torch.api.PolyFit``: it declares one ``TableSpec`` per (dataset,
aggregate) with a shared ``ErrorBudget`` — the budget, not the service,
owns the Lemma 5.1/5.3/6.3 delta derivations — fits them into one
session, and serves requests through a ``ServingEngine``
(``serve/engine.py``): a bounded request queue with admission batching,
a per-(table, guarantee, bucket) cache of captured CUDA graphs, and an
async staged update pipeline.  The request endpoints
(``serve``/``insert``/``delete``/``flush``/``warmup``) keep their
pre-engine signatures — ``serve`` still blocks on the answer and
``insert`` is still read-your-writes by default — plus ``submit`` for
callers that want the future.  The backend ('torch' | 'cuda' |
'cuda_scan' | 'ref') and the device are constructor arguments: the
service runs on the card with the hand-written kernels by default
(``'cuda'``, or the one-hot scan kernels on ``'cuda_scan'``), and on the
CPU through the plain torch path with ``device='cpu'``.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np

from ..api import ErrorBudget, PolyFit, QuerySpec, TableSpec
from ..data import hki_series, osm_points, tweet_latitudes
from .engine import ServingEngine

__all__ = ["AggregateService"]


class AggregateService:
    """Holds one fitted table per (dataset, aggregate); serves batched
    requests through a continuous-batching ``ServingEngine`` over the
    ``PolyFit`` session.

    Request kinds: 1-D 'count' (TWEET latitudes), 'sum' / 'max' / 'min'
    (HKI series values over timestamps), and 2-key 'count2d' (OSM
    points), 'sum2d' / 'max2d' / 'min2d' (OSM points with synthetic
    per-node weights).

    ``dynamic=True`` fits every table with delta-buffered updates
    (``engine/dynamic.py``) and opens the ``insert``/``delete``/``flush``
    endpoints: updates stage on the host, drain in fused chunks off the
    query path, and merges refit only affected segments (1-D) or leaves
    (2-D selective refit) on a background-installable plan swap —
    readers never block on writers.  ``shards=N`` serves every table
    from partitioned plans through the sharded engines
    (``engine/sharded.py``; 1-D key ranges, 2-D Morton z-ranges, all
    shards on one device).  ``n1``/``n2`` are the one- and two-key table
    sizes.
    """

    KINDS_1D = ("count", "sum", "max", "min")
    KINDS_2D = ("count2d", "sum2d", "max2d", "min2d")

    def __init__(self, backend: Optional[str] = None, eps_abs: float = 100.0,
                 eps_rel: Optional[float] = 0.01, n1: int = 150_000,
                 n2: int = 60_000, device=None,
                 verbose: bool = True, dynamic: bool = False,
                 capacity: int = 1024, shards: Optional[int] = None,
                 max_queue: int = 1024, workers: int = 1,
                 admission: str = "block", start: bool = True,
                 guarantees: Optional[Dict[str, Tuple]] = None,
                 injector=None, retry=None, supervise: bool = True,
                 shed_watermark: Optional[float] = None,
                 default_deadline: Optional[float] = None):
        self.backend = backend
        self.eps_rel = eps_rel
        self.dynamic = dynamic
        say = print if verbose else (lambda *a, **k: None)
        say(f"[server] building indexes (backend={backend}, "
            f"dynamic={dynamic}, shards={shards}) ...")
        t0 = time.time()
        lat = tweet_latitudes(n1)
        ts, vals = hki_series(n1)
        px, py = osm_points(n2)
        # synthetic per-node weights for the 2-D measure tables
        pw = 50.0 + 20.0 * np.sin(px / 7.0) + 15.0 * np.cos(py / 11.0)

        budget = ErrorBudget(abs=eps_abs, rel=eps_rel)
        # weighted sums run ~mean(w) larger than counts at the same shape,
        # so the SUM/SUM2D budgets scale the COUNT one to matching
        # *relative* tightness (the absolute bound is still certified,
        # just in measure units); extremum answers live on the measure
        # *spread*, so their budgets are a fraction of that — reusing the
        # count-unit eps_abs would exceed the whole spread and certify a
        # trivial one-leaf fit
        sbudget = ErrorBudget(abs=eps_abs * float(np.abs(vals).mean()),
                              rel=eps_rel)
        vbudget = ErrorBudget(abs=0.1 * float(vals.max() - vals.min()),
                              rel=eps_rel)
        wbudget = ErrorBudget(abs=eps_abs * float(pw.mean()), rel=eps_rel)
        mbudget = ErrorBudget(abs=0.1 * float(pw.max() - pw.min()),
                              rel=eps_rel)
        kw = dict(dynamic=dynamic, capacity=capacity, background=True,
                  shards=shards)

        # per-kind serving guarantee classes: {kind: (deadline_s, priority)}
        # become the engine's admission-deadline / shed-ladder defaults
        def klass(kind):
            d, p = (guarantees or {}).get(kind, (None, 0))
            return dict(deadline=d, priority=p)
        self.session = PolyFit.fit(
            {"count": lat, "sum": (ts, vals), "max": (ts, vals),
             "min": (ts, vals), "count2d": (px, py),
             "sum2d": (px, py, pw), "max2d": (px, py, pw),
             "min2d": (px, py, pw)},
            {"count": TableSpec("count", budget, deg=2, **kw,
                                **klass("count")),
             "sum": TableSpec("sum", sbudget, deg=2, **kw, **klass("sum")),
             "max": TableSpec("max", vbudget, deg=3, **kw, **klass("max")),
             "min": TableSpec("min", vbudget, deg=3, **kw, **klass("min")),
             "count2d": TableSpec("count2d", budget, deg=3, **kw,
                                  **klass("count2d")),
             "sum2d": TableSpec("sum2d", wbudget, deg=3, **kw,
                                **klass("sum2d")),
             "max2d": TableSpec("max2d", mbudget, deg=3, **kw,
                                **klass("max2d")),
             "min2d": TableSpec("min2d", mbudget, deg=3, **kw,
                                **klass("min2d"))},
            backend=backend, device=device)
        self.backend = self.session.backend

        dom1 = (float(ts.min()), float(ts.max()))
        dom2 = (float(px.min()), float(px.max()),
                float(py.min()), float(py.max()))
        self.domains: Dict[str, Tuple[float, ...]] = {
            "count": (float(lat.min()), float(lat.max())),
            "sum": dom1, "max": dom1, "min": dom1,
            "count2d": dom2, "sum2d": dom2,
            "max2d": dom2[1::2], "min2d": dom2[1::2],
        }
        self.engine = ServingEngine(self.session, max_queue=max_queue,
                                    workers=workers, admission=admission,
                                    start=start, injector=injector,
                                    retry=retry, supervise=supervise,
                                    shed_watermark=shed_watermark,
                                    default_deadline=default_deadline)
        say(f"[server] ready in {time.time() - t0:.1f}s — sizes: " +
            " ".join(f"{k}={b}B"
                     for k, b in self.session.size_bytes().items()))

    @property
    def plans(self):
        """Current device plans (fresh after dynamic merges)."""
        return {k: self.session.plan(k) for k in self.session.tables}

    @property
    def stats(self):
        """The serving engine's monotonic counters."""
        return self.engine.stats

    def serve(self, kind: str, *ranges):
        """Answer one batched request; blocks until the device is done.
        The request rides the engine queue, so concurrent callers
        coalesce into shared dispatches."""
        return self.engine.serve(kind, *ranges)

    def submit(self, kind: str, *ranges, deadline: Optional[float] = None,
               priority: Optional[int] = None):
        """Non-blocking variant: a future resolving to the ``Answer``
        (carrying ``.staleness``).  ``deadline``/``priority`` override the
        kind's guarantee class for this request."""
        return self.engine.submit(QuerySpec(kind, ranges),
                                  deadline=deadline, priority=priority)

    def health(self) -> Dict:
        """The engine's liveness snapshot (thread states, stall list,
        crash counters, journal depth) — for operators and the chaos
        harness."""
        return self.engine.health()

    def shutdown(self, drain: bool = True) -> None:
        """Stop the serving engine (answers queued work when draining)."""
        self.engine.shutdown(drain=drain)

    # -- update endpoints (dynamic mode) ---------------------------------

    def _require_dynamic(self):
        if not self.dynamic:
            raise RuntimeError("updates require AggregateService("
                               "dynamic=True)")

    def insert(self, kind: str, *args, wait: bool = True) -> None:
        """Buffer new records: (keys[, measures]) for 1-D, (xs, ys) for
        'count2d', (xs, ys, measures) for the other 2-D kinds.
        ``wait=True`` (default) blocks until the records are
        query-visible; ``wait=False`` stages and returns immediately —
        the async pipeline folds them in off the query path."""
        self._require_dynamic()
        self.engine.insert(kind, *args, wait=wait)

    def delete(self, kind: str, *args, wait: bool = True) -> None:
        """Buffer delete tombstones for existing records."""
        self._require_dynamic()
        self.engine.delete(kind, *args, wait=wait)

    def flush(self, kind: Optional[str] = None) -> None:
        """Drain staged updates and merge them into fresh plans (all
        kinds by default)."""
        self._require_dynamic()
        self.engine.flush(kind)

    def warmup(self, batch_size: int = 1024) -> None:
        """Capture the serving executables: the full power-of-two bucket
        ladder up to ``batch_size`` for every kind, then one device
        execution per kind to warm allocator/runtime paths."""
        self.engine.warmup(max_bucket=batch_size)
        full = lambda v: np.full((batch_size,), v)
        for kind in self.KINDS_1D:
            a, b = self.domains[kind]
            self.serve(kind, full(a), full(b))
        x0, x1, y0, y1 = self.domains["count2d"]
        for kind in ("count2d", "sum2d"):
            self.serve(kind, full(x0), full(x1), full(y0), full(y1))
        for kind in ("max2d", "min2d"):
            self.serve(kind, full(x1), full(y1))
