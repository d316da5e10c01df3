"""Kernels of the PolyFit query hot path: hand-written CUDA for Hopper.

Each kernel module holds a plain torch version and a wrapper that launches
the CUDA kernel on CUDA tensors (``csrc/``, built by ``_build``) and runs
the plain version on CPU tensors; ``ref.py`` holds the one-hot oracles.
The K1 wrapper is ``kernels.locate.locate``, the K4 wrapper
``kernels.quantile_invert.quantile_invert``, the K14 and K15 wrappers
(the one-hot scans of the ``cuda_scan`` backend)
``kernels.range_sum.range_sum`` and ``kernels.range_max.range_max``, and
the K21 wrapper ``kernels.poly_eval.poly_eval``; they are not re-exported
here, so that ``repro_torch.kernels.locate``, ``.quantile_invert``,
``.range_sum``, ``.range_max`` and ``.poly_eval`` stay the modules.
The 2-D leaf kernels K7, K8, K12 and K13 live in ``kernels.leaf_eval2d``,
the buffered 2-D corrections K9, K10 and K11, the whole-log scans K16 and
K17 and their two-key twins K18 (``delta_count2d``), K19
(``delta_sum2d``) and K20 (``delta_dommax2d``) beside K5 and K6 in
``kernels.delta_scan``.  ``kernels.ops`` (the twin of ``repro.kernels.ops``,
float32 tables by default) serves ``poly_eval``, ``range_sum`` and
``range_max`` on a plan through K21 and K2/K3 (``'cuda'``) or K14/K15
(``'cuda_scan'``); callers import the module, since its ``range_sum`` and
``range_max`` would shadow the modules of those names here.
"""
from .delta_scan import (delta_count2d, delta_count2d_gather,
                         delta_count2d_gather_plain, delta_count2d_plain,
                         delta_dommax2d, delta_dommax2d_gather,
                         delta_dommax2d_gather_plain, delta_dommax2d_plain,
                         delta_max, delta_max_gather, delta_max_gather_plain,
                         delta_max_plain, delta_sum, delta_sum2d,
                         delta_sum2d_gather, delta_sum2d_gather_plain,
                         delta_sum2d_plain, delta_sum_gather,
                         delta_sum_gather_plain, delta_sum_plain)
from .leaf_eval2d import (corner_count2d, corner_count2d_gather,
                          corner_count2d_gather_plain, corner_count2d_plain,
                          corner_eval2d, corner_eval2d_gather,
                          corner_eval2d_gather_plain, corner_eval2d_plain)
from .locate import bsearch_count, locate_segments, rmq_gather
from .poly_eval import poly_eval_plain
from .quantile_invert import quantile_invert_plain
from .range_max import (range_max_gather, range_max_gather_plain,
                        range_max_plain)
from .range_sum import (range_sum_gather, range_sum_gather_plain,
                        range_sum_plain)
from .ref import (corner_count2d_ref, delta_count2d_ref, delta_dommax2d_ref,
                  delta_max_ref, delta_sum2d_ref, delta_sum_ref,
                  leaf_eval2d_ref)

__all__ = ["bsearch_count", "locate_segments", "rmq_gather",
           "range_max_gather", "range_max_gather_plain", "range_sum_gather",
           "range_sum_gather_plain", "delta_sum_gather",
           "delta_sum_gather_plain", "delta_max_gather",
           "delta_max_gather_plain", "quantile_invert_plain",
           "delta_sum_ref", "delta_max_ref", "corner_count2d",
           "corner_count2d_gather", "corner_count2d_gather_plain",
           "corner_count2d_plain", "corner_eval2d", "corner_eval2d_gather",
           "corner_eval2d_gather_plain", "corner_eval2d_plain",
           "leaf_eval2d_ref", "corner_count2d_ref",
           "delta_count2d_gather", "delta_count2d_gather_plain",
           "delta_sum2d_gather", "delta_sum2d_gather_plain",
           "delta_dommax2d_gather", "delta_dommax2d_gather_plain",
           "delta_count2d_ref", "delta_sum2d_ref", "delta_dommax2d_ref",
           "range_sum_plain", "range_max_plain", "delta_sum",
           "delta_sum_plain", "delta_max", "delta_max_plain",
           "delta_count2d", "delta_count2d_plain", "delta_sum2d",
           "delta_sum2d_plain", "delta_dommax2d", "delta_dommax2d_plain",
           "poly_eval_plain"]
