"""Epoch-ring windowed aggregates over the level-ladder machinery.

The twin of ``repro.engine.window``.  Streaming rows land in an
append-only delta buffer (the open epoch); ``advance()`` seals the buffer
into an immutable fitted plan wrapped as a tombstone-free ``LsmLevel`` and
pushes it onto a bounded ring.  A window query ``[t0, t1]`` then *is* a
ladder execution over the selected epoch levels — ``execute_lsm`` fuses
the per-epoch evaluations exactly (kernel K2 per level on ``'cuda'``, K14
on ``'cuda_scan'``, K1 in each level's Q_rel truth on both), plus the open
epoch's exact buffer correction (K5 on ``'cuda'``, K16 on ``'cuda_scan'``;
K5 on both when the window holds the open epoch alone) when the window
reaches it.  Bounds compose via
``composed_bound`` over the selected levels' deltas.

Epoch ids are dense integers starting at 0; the ring retains the last
``ring`` sealed epochs and queries below the oldest retained epoch raise
(the data is gone).  1-D SUM/COUNT only, append-only: a windowed stream
has no deletes — rows leave by epoch eviction.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import DTYPE, resolve_device
from ..core.index import build_index_1d
from ..core.queries import QueryResult
from .dynamic import DeltaBuffer, _append_1d, _delta_sum
from .engine import CARD_BACKENDS, check_pow2, resolve_backend
from .lsm import LsmLevel, LsmPlan, composed_bound, execute_lsm
from .plan import build_plan

__all__ = ["WindowEngine"]


class WindowEngine:
    """Ring of per-epoch immutable plans answering windowed SUM/COUNT.

    ``keys``/``measures`` (optional) seal immediately as epoch 0; the open
    epoch is always ``self.epoch``.  ``ingest`` appends to the open epoch,
    ``advance`` seals it, ``query(lq, uq, t0, t1)`` evaluates the range
    aggregate restricted to epochs t0..t1 inclusive.  Plans and the buffer
    live on ``device`` (the card by default); ``backend`` defaults to
    ``'cuda'`` there and ``'torch'`` on the CPU.
    """

    def __init__(self, keys=None, measures=None, *, agg: str = "count",
                 delta: float = 64.0, deg: int = 2, ring: int = 8,
                 capacity: int = 1024, backend: Optional[str] = None,
                 device=None, min_bucket: int = 64):
        if agg not in ("sum", "count"):
            raise ValueError("windowed aggregates support 1-D SUM/COUNT "
                             f"only, got {agg!r}")
        if ring < 1:
            raise ValueError("ring must retain at least one epoch")
        check_pow2("capacity", capacity)
        check_pow2("min_bucket", min_bucket)
        self.device = resolve_device(device)
        self.backend = resolve_backend(backend, self.device)
        self.agg = agg
        self.delta = float(delta)
        self.deg = deg
        self.ring = ring
        self.capacity = capacity
        self.min_bucket = min_bucket
        self._lock = threading.RLock()
        self._ring: deque = deque(maxlen=ring)   # (epoch_id, level-or-None)
        self._buf = self._empty_buffer()
        self._pend: List[Tuple[np.ndarray, np.ndarray]] = []
        self._n_buf = 0
        self.epoch = 0
        if keys is not None and len(np.atleast_1d(keys)):
            self._ring.append((0, self._build_level(
                np.atleast_1d(np.asarray(keys, np.float64)), measures, 0)))
            self.epoch = 1

    # -- epoch lifecycle -------------------------------------------------

    def _empty_buffer(self) -> DeltaBuffer:
        return DeltaBuffer.empty(self.capacity, DTYPE, self.device)

    def _values(self, keys: np.ndarray, measures) -> np.ndarray:
        if self.agg == "count":
            return np.ones_like(keys)
        if measures is None:
            raise ValueError("measures required unless agg='count'")
        return np.broadcast_to(np.asarray(measures, np.float64),
                               keys.shape).copy()

    def _build_level(self, k: np.ndarray, v, slot: int) -> LsmLevel:
        v = self._values(k, v)
        order = np.argsort(k, kind="stable")
        idx = build_index_1d(k[order], v[order], agg=self.agg,
                             delta=self.delta, deg=self.deg,
                             keep_exact=True, device=self.device)
        return LsmLevel(build_plan(idx), None, None, None, None, slot=slot)

    def ingest(self, keys, measures=None) -> None:
        """Append rows to the open epoch (exact until sealed)."""
        keys = np.atleast_1d(np.array(keys, np.float64))
        vals = self._values(keys, measures)
        if not len(keys):
            return
        with self._lock:
            if self._n_buf + len(keys) > self.capacity:
                raise ValueError(
                    f"open epoch holds {self._n_buf} rows; {len(keys)} more "
                    f"exceeds capacity {self.capacity} — call advance()")
            buf = self._buf
            ik, iv, icf, _ = _append_1d(
                buf.ins_keys, buf.ins_vals,
                torch.as_tensor(keys, dtype=DTYPE, device=self.device),
                torch.as_tensor(vals, dtype=DTYPE, device=self.device),
                cap=buf.cap, with_st=False)
            self._buf = dataclasses.replace(buf, ins_keys=ik, ins_vals=iv,
                                            ins_cf=icf)
            self._pend.append((keys, vals))
            self._n_buf += len(keys)

    def advance(self) -> int:
        """Seal the open epoch into an immutable level; empty epochs seal
        as holes (no level).  Returns the new open epoch id."""
        with self._lock:
            eid = self.epoch
            if self._n_buf:
                k = np.concatenate([p[0] for p in self._pend])
                v = np.concatenate([p[1] for p in self._pend])
                lvl = self._build_level(k, v, eid)
            else:
                lvl = None
            self._ring.append((eid, lvl))
            self._buf = self._empty_buffer()
            self._pend = []
            self._n_buf = 0
            self.epoch = eid + 1
            return self.epoch

    @property
    def oldest(self) -> int:
        """Oldest retained epoch id (sealed or the open epoch)."""
        return self._ring[0][0] if self._ring else self.epoch

    def levels(self) -> Tuple[LsmLevel, ...]:
        """The retained sealed levels, oldest first (holes skipped)."""
        with self._lock:
            return tuple(lvl for _, lvl in self._ring if lvl is not None)

    # -- queries ---------------------------------------------------------

    def _select(self, t0: int, t1: int):
        t0, t1 = int(t0), int(t1)
        if t1 < t0:
            raise ValueError(f"empty window [{t0}, {t1}]")
        if t0 < self.oldest:
            raise ValueError(f"epoch {t0} evicted (oldest retained is "
                             f"{self.oldest}, ring={self.ring})")
        levels = tuple(lvl for eid, lvl in self._ring
                       if t0 <= eid <= t1 and lvl is not None)
        buf = self._buf if (t0 <= self.epoch <= t1 and self._n_buf) else None
        return levels, buf

    def window_plan(self, t0: int, t1: int):
        """Atomic (LsmPlan-or-None, buf-or-None) snapshot of the window —
        the pair an external executor evaluates against."""
        with self._lock:
            levels, buf = self._select(t0, t1)
        plan = LsmPlan(levels=levels, agg=self.agg) if levels else None
        return plan, buf

    def bound(self, t0: int, t1: int) -> float:
        """Certified absolute error of a [t0, t1] window answer: the sealed
        epochs' deltas compose (Lemma 5.1 per level); the open epoch's
        buffer correction is exact and adds nothing."""
        with self._lock:
            levels, _ = self._select(t0, t1)
        return composed_bound(self.agg, [l.plan.delta for l in levels]) \
            if levels else 0.0

    def query(self, lq, uq, t0: int, t1: int,
              eps_rel: Optional[float] = None) -> QueryResult:
        """SUM/COUNT over (lq, uq] restricted to epochs t0..t1."""
        plan, buf = self.window_plan(t0, t1)
        if plan is not None:
            return execute_lsm(plan, buf, (lq, uq), backend=self.backend,
                               eps_rel=eps_rel, min_bucket=self.min_bucket)
        lq, uq = (torch.as_tensor(q, dtype=DTYPE, device=self.device)
                  .reshape(-1) for q in (lq, uq))
        if buf is None:        # window covers no rows at all
            ans = torch.zeros(lq.shape, dtype=DTYPE, device=self.device)
        else:
            # open epoch only: the exact prefix-sum correction is the
            # answer (K5 on both card backends; the reference's gather
            # form on the others, whatever the one-hot oracle would give)
            ans = _delta_sum(lq, uq, buf.ins_keys, buf.ins_vals, buf.ins_cf,
                             backend="cuda" if self.backend in CARD_BACKENDS
                             else "torch")
        return QueryResult(ans, ans, torch.zeros(lq.shape, dtype=torch.bool,
                                                 device=self.device))
