"""repro_torch.engine — backend-dispatched query execution.

Lower a constructed index into a canonical device-resident ``IndexPlan``
once, then execute queries through the module-level ``execute_*`` dispatch
path (or the ``Engine`` shim) with ``backend='torch' | 'cuda' | 'cuda_scan'
| 'ref'`` (``'cuda_scan'``: the one-hot scan kernels, equal to ``'cuda'``
bit for bit):

    from repro_torch.core import build_index_1d
    from repro_torch.engine import Engine, build_plan

    plan = build_plan(build_index_1d(keys, meas, "sum", delta=eps / 2))
    res = Engine().query(plan, lq, uq, eps_rel=0.01)   # fused approx + refine

``DynamicEngine`` wraps an index in a delta buffer that takes inserts and
deletes without a rebuild (exact corrections K5/K6 on ``'cuda'``, K16/K17
on ``'cuda_scan'``) and refits only the segments they touch;
``DynamicEngine2D`` does the same for a two-key index (K9-K11 on
``'cuda'``, the whole-log scans K18-K20 on ``'cuda_scan'``) and refits
only the quadtree leaves the changed points touch.
``execute_quantile`` (K4 on ``'cuda'``, its scan mode on ``'cuda_scan'``)
and ``DynamicEngine.quantile`` answer certified quantiles of SUM/COUNT
tables; ``WindowEngine`` keeps an epoch ring of sealed plans and
answers windowed SUM/COUNT through ``execute_lsm``; ``LsmEngine`` and
``LsmEngine2D`` tier an updatable table into a geometric ladder of
immutable plans (tombstone and victim deletes that never merge, bounded
compactions) and answer through ``execute_lsm`` as well.
``ShardedEngine`` / ``ShardedEngine2D`` partition a plan (or every level
of a ladder) into contiguous key or Morton z-ranges stacked on a leading
axis and answer shard by shard on the ``'torch'`` arithmetic, equal to the
unsharded ``'torch'`` path bit for bit.  Two-key tables lower
to an ``IndexPlan2D`` (``build_plan_2d``) and run through
``execute_count2d`` / ``execute_sum2d`` (rectangles, K7 or K12 on
``'cuda'``, K12 on ``'cuda_scan'``) and ``execute_extremum2d`` (dominance
corners, K8 or K13; K13 on ``'cuda_scan'``).  ``fused_executor`` and
``fused_quantile_executor`` close a table's statics over one executor
callable, the unit ``repro_torch.serve.ServingEngine`` caches per bucket.
"""
from .dynamic import (DeltaBuffer, DeltaBuffer2D, DynamicEngine,
                      DynamicEngine2D, fused_executor, fused_quantile_executor)
from .engine import (BACKENDS, Engine, QuantileResult, check_pow2, execute,
                     execute_count2d, execute_extremum, execute_extremum2d,
                     execute_quantile, execute_sum, execute_sum2d, key_span,
                     pad_fills, raw_count2d, raw_eval2d, raw_extremum,
                     raw_sum, resolve_backend, truth_count2d, truth_dommax2d,
                     truth_extremum, truth_sum, truth_sum2d)
from .lsm import (CompactionPolicy, LsmEngine, LsmEngine2D, LsmLevel,
                  LsmLevel2D, LsmPlan, LsmPlan2D, combine_levels,
                  composed_bound, execute_lsm, level_executor)
from .plan import (IndexPlan, IndexPlan2D, big_sentinel, build_plan,
                   build_plan_2d, pad_to_multiple, plan2d_from_numpy,
                   plan_from_numpy)
from .sharded import (ShardedDelta, ShardedEngine, ShardedEngine2D,
                      ShardedLsmPlan, ShardedLsmPlan2D, ShardedPlan,
                      ShardedPlan2D, execute_lsm_sharded, shard_buffer,
                      shard_lsm_plan, shard_lsm_plan_2d, shard_plan,
                      shard_plan_2d)
from .window import WindowEngine

__all__ = ["BACKENDS", "Engine", "QuantileResult", "check_pow2", "execute",
           "execute_extremum", "execute_quantile", "execute_sum",
           "pad_fills", "raw_extremum", "raw_sum", "resolve_backend",
           "truth_extremum", "truth_sum", "IndexPlan", "big_sentinel",
           "build_plan", "pad_to_multiple", "plan_from_numpy", "DeltaBuffer",
           "DynamicEngine", "DeltaBuffer2D", "DynamicEngine2D", "key_span",
           "LsmLevel", "LsmLevel2D", "LsmPlan", "LsmPlan2D", "LsmEngine",
           "LsmEngine2D", "CompactionPolicy", "level_executor",
           "combine_levels", "composed_bound", "execute_lsm", "WindowEngine",
           "execute_count2d", "execute_sum2d", "execute_extremum2d",
           "raw_count2d", "raw_eval2d", "truth_count2d", "truth_sum2d",
           "truth_dommax2d", "IndexPlan2D", "build_plan_2d",
           "plan2d_from_numpy", "ShardedPlan", "ShardedDelta",
           "ShardedEngine", "shard_plan", "shard_buffer", "ShardedPlan2D",
           "ShardedEngine2D", "shard_plan_2d", "ShardedLsmPlan",
           "ShardedLsmPlan2D", "shard_lsm_plan", "shard_lsm_plan_2d",
           "execute_lsm_sharded", "fused_executor",
           "fused_quantile_executor"]
