"""PolyFit core — the paper's contribution as torch modules.

Index construction (fitting + segmentation) runs on the host in float64;
the built index lives on the query device as float64 tensors.
"""
from .exact import ExactMax, ExactSum, build_sparse_table, sparse_table_range_max
from .fitting import (PolyModel, continuum_error, eval_poly, fit_lstsq,
                      fit_minimax_lawson, fit_minimax_lp, lawson_batched,
                      max_error, rescale)
from .index import (PolyFitIndex1D, assemble_index_1d, build_index_1d,
                    index_from_numpy)
from .index2d import (AGGS_2D, MergeSortTree, PolyFitIndex2D, build_index_2d,
                      count_dominated, dominance_rank, index2d_from_numpy,
                      query_count_2d, query_dommax_2d, query_sum_2d,
                      selective_refit_2d)
from .poly import (clipped_poly_max, eval_segments, fma, horner, horner_fma,
                   locate, scale_unit)
from .quantile import (boundary_array, certified_quantile,
                       certified_quantile_shifted, invert_cf, rank_slack)
from .queries import (QueryResult, max_eval_segments, poly_max_on_interval,
                      query_max, query_sum)
from .segmentation import (FastAcceptFitter, dp_segmentation,
                           greedy_segmentation, parallel_segmentation)

__all__ = [
    "PolyModel", "continuum_error", "eval_poly", "fit_lstsq",
    "fit_minimax_lp", "fit_minimax_lawson", "lawson_batched", "max_error",
    "rescale", "FastAcceptFitter", "greedy_segmentation", "dp_segmentation",
    "parallel_segmentation", "PolyFitIndex1D", "build_index_1d",
    "assemble_index_1d", "index_from_numpy",
    "AGGS_2D", "MergeSortTree", "PolyFitIndex2D", "build_index_2d",
    "count_dominated", "dominance_rank", "index2d_from_numpy",
    "query_count_2d", "query_sum_2d", "query_dommax_2d",
    "selective_refit_2d", "ExactMax", "ExactSum", "build_sparse_table", "sparse_table_range_max",
    "QueryResult", "max_eval_segments", "poly_max_on_interval", "query_max",
    "query_sum", "clipped_poly_max", "eval_segments", "fma", "horner",
    "horner_fma", "locate",
    "scale_unit", "boundary_array", "certified_quantile",
    "certified_quantile_shifted", "invert_cf", "rank_slack",
]
