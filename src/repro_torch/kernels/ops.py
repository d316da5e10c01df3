"""Public wrappers around the raw query kernels: the twin of
``repro.kernels.ops``.

The segment-table layout these kernels consume is the engine's canonical
``IndexPlan`` (``SegTable`` stays as an alias, and ``from_index`` as the
adapter constructor, for callers that want the raw kernels without the
engine's fused refinement path).  The wrappers handle the kernel ABI only:
the queries are cast to the table's type and clamped to the index domain
(``seg_lo[0]``), as the reference clamps them.  The port's kernels take any
query count, so nothing is padded, and each result is (n,).

``backend`` selects: ``'cuda'`` (the default, twin of ``'pallas'``: K21 for
``poly_eval``, the locate->gather kernels K2 and K3 for ``range_sum`` and
``range_max``), ``'cuda_scan'`` (twin of ``'pallas_scan'``: K21, and the
one-hot scans K14 and K15) or ``'ref'`` (the plain oracles of
``kernels/ref.py``).  The two card backends need a table on a CUDA device,
as the engine's do.  Tables are float32 by default, as the reference's
are: every kernel here has a float32 instantiation, picked by the table's
type.  For the full engine (backend dispatch plus in-path Q_rel
refinement) use ``repro_torch.engine.Engine``.
"""
from __future__ import annotations

import torch

from ..engine.engine import resolve_backend
from ..engine.plan import DEFAULT_BH, IndexPlan, build_plan
from . import poly_eval as _pe
from . import range_max as _rmax
from . import range_sum as _rsum
from . import ref as _ref

__all__ = ["SegTable", "BACKENDS", "from_index", "poly_eval", "range_sum",
           "range_max"]

# The flat tile-padded segment table is the engine's canonical plan; the
# historical name stays importable.
SegTable = IndexPlan
BACKENDS = ("cuda", "cuda_scan", "ref")


def from_index(index, dtype: torch.dtype = torch.float32,
               bh: int = DEFAULT_BH) -> IndexPlan:
    """A kernel-ready IndexPlan from a ``core.index.PolyFitIndex1D`` (on the
    index's device).

    Skips the exact-refinement arrays (raw-kernel callers measure the pure
    approximation path); ``engine.build_plan`` includes them.
    """
    return build_plan(index, dtype=dtype, bh=bh, with_exact=False)


def _backend(backend: str, table: IndexPlan) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend}")
    return resolve_backend(backend, table.device)


def _queries(table: IndexPlan, *qs):
    """The queries as (n,) tensors of the table's type on its device,
    clamped to the domain."""
    return [torch.maximum(torch.as_tensor(q, dtype=table.dtype,
                                          device=table.device),
                          table.seg_lo[0]) for q in qs]


def poly_eval(table: IndexPlan, q, backend: str = "cuda") -> torch.Tensor:
    """P_{I(q)}(q) for each key: K21 on ``'cuda'`` and ``'cuda_scan'``."""
    backend = _backend(backend, table)
    (q,) = _queries(table, q)
    if backend == "ref":
        # padded segments (sentinel lo) are never matched, so ref can
        # consume the padded table directly
        return _ref.poly_eval_ref(q, table.seg_lo, table.seg_next,
                                  table.seg_hi, table.coeffs)
    return _pe.poly_eval(q, table.seg_lo, table.seg_next, table.seg_hi,
                         table.coeffs, table.seg_tree)


def range_sum(table: IndexPlan, lq, uq,
              backend: str = "cuda") -> torch.Tensor:
    """Approximate SUM/COUNT over (lq, uq]: K2 on ``'cuda'``, K14 on
    ``'cuda_scan'``."""
    backend = _backend(backend, table)
    lq, uq = _queries(table, lq, uq)
    if backend == "ref":
        return _ref.range_sum_ref(lq, uq, table.seg_lo, table.seg_next,
                                  table.seg_hi, table.coeffs)
    if backend == "cuda_scan":
        return _rsum.range_sum(lq, uq, table.seg_lo, table.seg_next,
                               table.seg_hi, table.coeffs)
    return _rsum.range_sum_gather(lq, uq, table.seg_lo, table.seg_hi,
                                  table.coeffs, table.seg_tree)


def range_max(table: IndexPlan, lq, uq,
              backend: str = "cuda") -> torch.Tensor:
    """Approximate MAX over [lq, uq] (deg <= 3): K3 on ``'cuda'``, K15 on
    ``'cuda_scan'``."""
    backend = _backend(backend, table)
    lq, uq = _queries(table, lq, uq)
    if backend == "ref":
        return _ref.range_max_ref(lq, uq, table.seg_lo, table.seg_next,
                                  table.seg_hi, table.coeffs, table.seg_agg)
    if backend == "cuda_scan":
        return _rmax.range_max(lq, uq, table.seg_lo, table.seg_next,
                               table.seg_hi, table.coeffs, table.seg_agg)
    return _rmax.range_max_gather(lq, uq, table.seg_lo, table.seg_hi,
                                  table.coeffs, table.st, table.seg_tree)
