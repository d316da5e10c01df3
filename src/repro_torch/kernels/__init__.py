"""Kernels of the PolyFit query hot path: hand-written CUDA for Hopper.

Each kernel module holds a plain torch version and a wrapper that launches
the CUDA kernel on CUDA tensors (``csrc/``, built by ``_build``) and runs
the plain version on CPU tensors; ``ref.py`` holds the one-hot oracles.
The K1 wrapper is ``kernels.locate.locate``; it is not re-exported here, so
that ``repro_torch.kernels.locate`` stays the module.
"""
from .delta_scan import (delta_max_gather, delta_max_gather_plain,
                         delta_sum_gather, delta_sum_gather_plain)
from .locate import bsearch_count, locate_segments, rmq_gather
from .range_max import range_max_gather, range_max_gather_plain
from .range_sum import range_sum_gather, range_sum_gather_plain
from .ref import delta_max_ref, delta_sum_ref

__all__ = ["bsearch_count", "locate_segments", "rmq_gather",
           "range_max_gather", "range_max_gather_plain", "range_sum_gather",
           "range_sum_gather_plain", "delta_sum_gather",
           "delta_sum_gather_plain", "delta_max_gather",
           "delta_max_gather_plain", "delta_sum_ref", "delta_max_ref"]
