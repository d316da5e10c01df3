"""PolyFit 1-D index: a sequence of minimax polynomial segments + aggregates.

The twin of ``repro.core.index``.  Construction follows the paper (§4):
build F(k) (CF_sum for SUM/COUNT, DF_max for MAX/MIN; Eq. 7), segment it
with GS subject to E(I) <= delta on the host, and hold the segments as flat
tensors on the query device:

    seg_lo     (h,)        first key of each segment (sorted; search bounds)
    seg_hi     (h,)        last key of each segment (the fit's own scale hi)
    coeffs     (h, deg+1)  polynomial coefficients in the scaled variable u
    seg_start  (h,)        index of the first dataset key in the segment
    seg_agg    (h,)        exact MAX (or -MIN) of measures inside the segment
    st         (L, h)      sparse table over seg_agg (MAX/MIN only)

Query semantics: ranges are (lq, uq] for SUM/COUNT and [lq, uq] for
MAX/MIN.  ``staircase=True`` additionally constrains each fit at both ends
of every flat piece of the step function; the paper-faithful default is
False.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from .exact import ExactMax, ExactSum, build_sparse_table
from .fitting import PolyModel, continuum_error, fit_minimax_lp
from .poly import eval_segments, locate as locate_segments
from .segmentation import (FastAcceptFitter, Fitter, greedy_segmentation,
                           parallel_segmentation)

__all__ = ["PolyFitIndex1D", "build_index_1d", "assemble_index_1d",
           "index_from_numpy"]

_SUPPORTED = ("sum", "count", "max", "min")


@dataclasses.dataclass(frozen=True)
class PolyFitIndex1D:
    agg: str                 # 'sum' | 'count' | 'max' | 'min'
    deg: int
    delta: float
    # device tensors ----------------------------------------------------
    seg_lo: torch.Tensor     # (h,)
    seg_hi: torch.Tensor     # (h,)
    coeffs: torch.Tensor     # (h, deg+1)
    seg_start: torch.Tensor  # (h,) int32
    seg_agg: Optional[torch.Tensor]   # (h,)  (max/min only)
    st: Optional[torch.Tensor]        # (L, h) sparse table (max/min only)
    # refinement backend (exact structures over the raw data) -----------
    exact_sum: Optional[ExactSum]
    exact_max: Optional[ExactMax]
    n: int                   # dataset size
    # per-segment certified E(I), on the host
    seg_err: Optional[np.ndarray] = None

    @property
    def h(self) -> int:
        return int(self.seg_lo.shape[0])

    def size_bytes(self) -> int:
        """Index size (paper's metric): segments + coefficients + aggregates.

        Excludes the raw-data refinement backend, mirroring the paper.
        """
        nb = lambda t: t.numel() * t.element_size()
        total = (nb(self.seg_lo) + nb(self.seg_hi) + nb(self.coeffs)
                 + nb(self.seg_start))
        if self.seg_agg is not None:
            total += nb(self.seg_agg) + nb(self.st)
        return int(total)

    def locate(self, q: torch.Tensor) -> torch.Tensor:
        """Segment id containing each query key (clamped to the domain)."""
        return locate_segments(q, self.seg_lo)

    def eval_at(self, q: torch.Tensor) -> torch.Tensor:
        """P_{I(q)}(q): evaluate the covering polynomial (vectorized), with
        u clamped to [-1, 1] (see ``core.poly``)."""
        return eval_segments(q, self.seg_lo, self.seg_hi, self.coeffs)


def _exact_function(keys: np.ndarray, measures: np.ndarray, agg: str):
    """(sorted_keys, F(k_i) values at keys, sorted_measures)."""
    order = np.argsort(keys, kind="stable")
    k = np.asarray(keys, np.float64)[order]
    m = np.asarray(measures, np.float64)[order]
    if agg in ("sum", "count"):
        F = np.cumsum(m)                      # CF_sum (inclusive)
    elif agg == "max":
        F = m                                 # DF_max at the keys
    elif agg == "min":
        F = -m                                # reuse MAX machinery
        m = -m
    else:
        raise ValueError(f"agg must be one of {_SUPPORTED}, got {agg}")
    return k, F, m


def _continuum_post(m: PolyModel, keys, values) -> PolyModel:
    """Certificate post-processor: err := max(key error, continuum sup-error
    vs the step function F) — required for sound MAX/MIN evaluation."""
    ce = continuum_error(m, keys, values)
    if ce > m.err:
        m = PolyModel(m.lo, m.hi, m.coeffs, ce)
    return m


def _enforce_continuum(segs, k, F, deg, delta, fitter):
    """Re-segment (greedily) any parallel-built segment whose continuum
    certificate exceeds delta."""
    out = []
    for s in segs:
        i = int(np.searchsorted(k, s.lo, side="left"))
        j = int(np.searchsorted(k, s.hi, side="right"))
        m = fitter(k[i:j], F[i:j], deg)
        if m.err <= delta:
            out.append(m)
        else:
            out.extend(greedy_segmentation(k[i:j], F[i:j], deg, delta,
                                           fitter=fitter))
    return out


def _staircase_points(k: np.ndarray, F: np.ndarray):
    """Add (k_{i+1}, F(k_i)) constraint pairs: both ends of each flat piece."""
    if len(k) < 2:
        return k, F
    ks = np.concatenate([k, k[1:]])
    Fs = np.concatenate([F, F[:-1]])
    order = np.argsort(ks, kind="stable")
    return ks[order], Fs[order]


def build_index_1d(
    keys: np.ndarray,
    measures: Optional[np.ndarray],
    agg: str,
    deg: int = 2,
    delta: float = 100.0,
    fitter: Fitter = fit_minimax_lp,
    method: str = "greedy",          # 'greedy' | 'parallel'
    staircase: bool = False,
    continuum: Optional[bool] = None,
    fast_accept: bool = True,
    keep_exact: bool = True,
    device=None,
) -> PolyFitIndex1D:
    """Construct a PolyFit index (paper §4) on the host, held on ``device``
    (the card by default).

    measures=None with agg='count' counts records (measure := 1).
    ``method='parallel'`` uses the batched-Lawson construction, its probes
    fitted on ``device``.  ``continuum`` (default: True for max/min, False
    for sum/count) makes the per-segment certificate cover the whole key
    span, not just the keys.
    """
    device = resolve_device(device)
    keys = np.asarray(keys, np.float64)
    if measures is None:
        if agg != "count":
            raise ValueError("measures required unless agg='count'")
        measures = np.ones_like(keys)
    measures = np.asarray(measures, np.float64)
    if agg == "count":
        measures = np.ones_like(keys)
    k, F, m_sorted = _exact_function(keys, measures, agg)

    if continuum is None:
        continuum = agg in ("max", "min")
    eff_fitter = FastAcceptFitter(
        exact=fitter, delta=delta,
        post=_continuum_post if continuum else None, screen=fast_accept)

    fit_k, fit_F = (_staircase_points(k, F) if staircase else (k, F))
    if method == "parallel":
        segs = parallel_segmentation(fit_k, fit_F, deg, delta,
                                     fitter=eff_fitter, device=device)
        if continuum:
            segs = _enforce_continuum(segs, fit_k, fit_F, deg, delta,
                                      eff_fitter)
    else:
        segs = greedy_segmentation(fit_k, fit_F, deg, delta,
                                   fitter=eff_fitter)
    return assemble_index_1d(segs, k, m_sorted, agg, deg, delta,
                             keep_exact=keep_exact, device=device)


def assemble_index_1d(
    segs: Sequence[PolyModel],
    k: np.ndarray,
    m_sorted: np.ndarray,
    agg: str,
    deg: int,
    delta: float,
    keep_exact: bool = True,
    device=None,
) -> PolyFitIndex1D:
    """Assemble a PolyFitIndex1D from fitted segments + sorted data.

    ``k`` must be sorted ascending and ``m_sorted`` in internal space
    (negated for agg='min'); ``segs`` must tile the key range in order.
    """
    device = resolve_device(device)
    is_extremal = agg in ("max", "min")
    h = len(segs)
    seg_lo = np.array([s.lo for s in segs])
    seg_hi = np.array([s.hi for s in segs])   # the fit's own scale hi
    coeffs = np.zeros((h, deg + 1))
    for i, s in enumerate(segs):
        coeffs[i, : len(s.coeffs)] = s.coeffs
    seg_err = np.array([s.err for s in segs])
    seg_start = np.searchsorted(k, seg_lo, side="left").astype(np.int32)

    seg_agg = st = None
    exact_sum = exact_max = None
    if is_extremal:
        seg_end = np.concatenate([seg_start[1:], [len(k)]]).astype(np.int32)
        seg_agg = np.array([
            m_sorted[s:e].max() if e > s else -np.inf
            for s, e in zip(seg_start, seg_end)
        ])
        st = build_sparse_table(seg_agg)
    to = lambda a: torch.as_tensor(a, device=device)
    if keep_exact:
        if is_extremal:
            exact_max = ExactMax(to(k), to(m_sorted),
                                 to(build_sparse_table(m_sorted)))
        else:
            exact_sum = ExactSum(to(k), to(np.cumsum(m_sorted)))

    return PolyFitIndex1D(
        agg=agg, deg=deg, delta=float(delta),
        seg_lo=to(seg_lo), seg_hi=to(seg_hi), coeffs=to(coeffs),
        seg_start=to(seg_start),
        seg_agg=None if seg_agg is None else to(seg_agg),
        st=None if st is None else to(st),
        exact_sum=exact_sum, exact_max=exact_max, n=len(k),
        seg_err=seg_err,
    )


def index_from_numpy(fields: Mapping, device) -> PolyFitIndex1D:
    """A port index from a reference ``PolyFitIndex1D``'s fields as numpy.

    ``fields`` holds the metadata ``agg``, ``deg``, ``delta``, ``n``, the
    arrays ``seg_lo``, ``seg_hi``, ``coeffs``, ``seg_start``, ``seg_agg``,
    ``st``, ``seg_err`` (None where the reference has None), and the exact
    structures as ``exact_sum = (keys, cf)`` and ``exact_max = (keys,
    measures, st)`` tuples, or None.  Lets the query path be held to the
    reference apart from construction.
    """
    device = torch.device(device)
    to = lambda a: None if a is None else torch.as_tensor(np.array(a),
                                                          device=device)
    es, em = fields.get("exact_sum"), fields.get("exact_max")
    seg_err = fields.get("seg_err")
    return PolyFitIndex1D(
        agg=str(fields["agg"]), deg=int(fields["deg"]),
        delta=float(fields["delta"]),
        seg_lo=to(fields["seg_lo"]), seg_hi=to(fields["seg_hi"]),
        coeffs=to(fields["coeffs"]), seg_start=to(fields["seg_start"]),
        seg_agg=to(fields.get("seg_agg")), st=to(fields.get("st")),
        exact_sum=None if es is None else ExactSum(*map(to, es)),
        exact_max=None if em is None else ExactMax(*map(to, em)),
        n=int(fields["n"]),
        seg_err=None if seg_err is None else np.asarray(seg_err),
    )
