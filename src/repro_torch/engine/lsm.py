"""Level ladders of immutable plans: the plan half of LSM-tiered PolyFit.

The twin of the plan half of ``repro.engine.lsm`` for 1-D SUM/COUNT.  A
ladder is a tuple of immutable levels, each one ordinary ``IndexPlan``
fitted once; a query fuses the per-level evaluations exactly:

* SUM/COUNT partials **add** across levels, and the certified bound
  composes additively over the levels' data plans:
  ``B = sum_k FACTOR * delta_k`` (``composed_bound``);
* the optional level-0 delta buffer adds its exact correction (kernel K5
  on the ``'cuda'`` backend, the whole-log scan K16 on ``'cuda_scan'``);
* under Q_rel the composed bound drives the Lemma 5.2 acceptance test and
  rejected lanes take the sum of the levels' exact answers (kernel K1 in
  each level's refinement on both card backends).

Each level's raw approximation is ``engine.raw_sum``: K2 on ``'cuda'``,
K14 on ``'cuda_scan'``.

Per-level answers are bit-identical to the flat ``execute_sum`` for
in-domain queries: the below-domain first-key addend is exactly ``+0.0``
when the query lies inside the level's domain, so a one-level ladder
reproduces the flat engine bit for bit.

The epoch ring of ``engine/window.py`` is the user of this module in the
port so far.  ``LsmEngine`` with its compactions, per-level tombstones,
the MAX/MIN level fusion and ``CompactionPolicy`` come with ROADMAP Queue 1
item 12; the 2-D ladders with item 13.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .. import DTYPE
from ..core.queries import QueryResult
from .dynamic import DeltaBuffer, _delta_sum
from .engine import (_bucket_size, _pad_bucket, check_pow2, pad_fills,
                     raw_sum, resolve_backend, truth_sum)
from .plan import IndexPlan

__all__ = ["LsmLevel", "LsmPlan", "composed_bound", "combine_levels",
           "execute_lsm"]

_ADDITIVE = ("sum", "count")


def _require_additive(agg: str) -> None:
    if agg not in _ADDITIVE:
        raise _not_ported(f"{agg} level ladders", 13 if "2d" in agg else 12)


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} are not ported yet: ROADMAP Queue 1 "
                               f"item {item}")


@dataclasses.dataclass(frozen=True)
class LsmLevel:
    """One immutable 1-D level: the fitted plan plus delete shadows.

    ``tomb_keys``/``tomb_cf`` (SUM/COUNT tombstones) and ``vic_keys``/
    ``live_st`` (MAX/MIN victims) are the reference's delete side arrays;
    the levels the port builds so far (sealed window epochs) carry none,
    and the executors that read them come with ``LsmEngine``.
    """

    plan: IndexPlan
    tomb_keys: Optional[torch.Tensor]   # (t,) sorted; None when no tombs
    tomb_cf: Optional[torch.Tensor]     # (t,) inclusive prefix sums
    vic_keys: Optional[torch.Tensor]    # (vcap,) sorted, sentinel-padded
    live_st: Optional[torch.Tensor]     # (L, n) victim-masked sparse table
    slot: int


@dataclasses.dataclass(frozen=True)
class LsmPlan:
    """The immutable level ladder, ascending slot order (newest first)."""

    levels: Tuple[LsmLevel, ...]
    agg: str

    @property
    def device(self) -> torch.device:
        return self.levels[0].plan.device

    @property
    def deltas(self) -> Tuple[float, ...]:
        return tuple(lvl.plan.delta for lvl in self.levels)


def composed_bound(agg: str, deltas) -> float:
    """Certified |A - R| bound of the fused multi-level answer.

    Tombstone/victim corrections are exact, so only the data plans
    contribute: additive aggregates sum the per-level Lemma bounds,
    extremal ones take the worst level."""
    from ..api.budget import BOUND_FACTOR   # lazy: api imports engine
    f = BOUND_FACTOR[agg]
    if agg in ("max", "min", "max2d", "min2d"):
        return f * max(deltas)
    return f * sum(deltas)


def _level_sum(lvl: LsmLevel, lq, uq, *, backend: str, with_truth: bool):
    """(partial, truth?) for SUM/COUNT over (lq, uq] against one level."""
    if lvl.tomb_keys is not None:
        raise _not_ported("per-level tombstones (LsmEngine)", 12)
    p = lvl.plan
    lo = p.seg_lo[0]
    lqc = torch.maximum(lq, lo)
    uqc = torch.maximum(uq, lo)
    part = raw_sum(p, lqc, uqc, backend=backend)
    # the fitted CF is inclusive: clamping lq up to the level's first key
    # subtracts ~P(lo) ~= m0, excluding that key's measure from queries
    # that start below this level's domain — add it back (exactly +0.0
    # when the query is in-domain, preserving flat bit-identity)
    m0 = p.ref_cf[0]
    part = part + torch.where((lq < lo) & (uq >= lo), m0,
                              torch.zeros((), dtype=p.dtype, device=p.device))
    if not with_truth:
        return (part,)
    return part, truth_sum(p, lq, uq, backend=backend)


def combine_levels(agg: str, level_outs, buf: Optional[DeltaBuffer], qs, *,
                   backend: str, eps_rel: Optional[float], bound: float):
    """Fuse per-level core outputs (+ optional delta buffer) into the final
    (ans, approx, refined) triple: SUM/COUNT partials add, and the composed
    bound drives the acceptance shape the flat executor uses (identical
    floats for a one-level ladder)."""
    _require_additive(agg)
    total = level_outs[0][0]
    for o in level_outs[1:]:
        total = total + o[0]
    corr = None
    if buf is not None:
        # exact level-0 contribution: only the insert side exists
        lq, uq = qs
        corr = _delta_sum(lq, uq, buf.ins_keys, buf.ins_vals, buf.ins_cf,
                          backend=backend)
        total = total + corr
    if eps_rel is None:
        return total, total, torch.zeros(total.shape, dtype=torch.bool,
                                          device=total.device)
    # Lemma 5.2 shape with the composed bound B = sum_k 2*delta_k
    ok = ((total - bound > 0)
          & (bound / torch.clamp(total - bound, min=1e-300) <= eps_rel))
    truth = level_outs[0][1]
    for o in level_outs[1:]:
        truth = truth + o[1]
    if corr is not None:
        truth = truth + corr
    return torch.where(ok, total, truth), total, ~ok


def execute_lsm(lsm: LsmPlan, buf: Optional[DeltaBuffer], ranges, *,
                backend: Optional[str] = None,
                eps_rel: Optional[float] = None,
                min_bucket: int = 64) -> QueryResult:
    """Execute a query batch against an ``LsmPlan`` ladder plus an optional
    level-0 delta buffer (1-D SUM/COUNT over (lq, uq])."""
    agg = lsm.agg
    _require_additive(agg)
    backend = resolve_backend(backend, lsm.device)
    check_pow2("min_bucket", min_bucket)
    qs = [torch.as_tensor(q, dtype=DTYPE, device=lsm.device).reshape(-1)
          for q in ranges]
    n = qs[0].shape[0]
    size = _bucket_size(n, min_bucket)
    fills = pad_fills(lsm.levels[0].plan)
    qs = [_pad_bucket(q, size, f.to(q.dtype)) for q, f in zip(qs, fills)]
    outs = [_level_sum(lvl, *qs, backend=backend,
                       with_truth=eps_rel is not None)
            for lvl in lsm.levels]
    ans, approx, refined = combine_levels(
        agg, outs, buf, qs, backend=backend, eps_rel=eps_rel,
        bound=composed_bound(agg, lsm.deltas))
    return QueryResult(ans[:n], approx[:n], refined[:n])
