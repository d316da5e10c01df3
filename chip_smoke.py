#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port of PolyFit (src/repro_torch) once on one
NVIDIA card, and hold its kernels to their plain PyTorch versions.

    python3 chip_smoke.py             # about 14-19 minutes on an H100 host

Phases, each of which fails the run with a non-zero exit:

1. device   - a CUDA card must be present; print its name and power limit;
2. build    - compile the CUDA kernels from src/repro_torch/csrc with nvcc
              (one nvcc per translation unit, all started together);
3. fit      - PolyFit.fit on the card: TWEET latitudes (COUNT), HKI minute
              bars (MAX, deg 3; and SUM of the prices, deg 3) and a smaller
              HKI table for MIN, cut to the sizes printed on the CUT lines;
              then the parallel step, which builds no session:
              build_index_1d(method="parallel") (lockstep-chunked greedy
              segmentation, every round's probes fitted by one batched
              Lawson call on the card) of the paper's 1M TWEET keys and of
              the static lat table's 200k, at delta 50: every segment must
              certify and the segments tile the keys, the 200k build is
              compared with lat's greedy fit (segments within chunks - 1,
              both seconds printed), the lockstep rounds and one Lawson
              round's device time at the largest (B, Lmax) are printed,
              and 65,536 ranges go through execute_sum on each plan under
              Q_abs and Q_rel against numpy truth, K2 held to its plain
              version there;
4. main     - one mixed batch of COUNT, MAX and MIN ranges through
              session.query under Q_abs, then under Q_rel, checked against
              exact answers computed on the host with numpy alone; the
              kernel launch counters must show that the batch ran the
              kernels, and no deg > 3 reroute;
5. quantile - 65,536 rank fractions each on the COUNT and SUM tables
              through session.query(QuerySpec.quantile(...)): every
              certificate [lo, hi] must bracket numpy's quantiles (every
              np.quantile method for COUNT, the weighted convention for
              SUM) and hold its answer; the counters must show K4;
6. parity   - each kernel against its plain version on the card, on the
              plans and queries of phases 4 and 5 (K1-K4 exactly);
7. timing   - device time of each kernel, its plain version and the
              one-call library yardstick where there is one (CUDA-event
              timed replays of a CUDA graph of the calls, so host dispatch
              drops out), the kernel's eager per-call time (host dispatch
              included), and the session's end-to-end query latency, with
              one batch traced by torch.profiler (device busy time, idle
              share, heaviest kernels);
8. dynamic  - PolyFit.fit of three dynamic tables (TableSpec(dynamic=True),
              capacity 4,096): TWEET 300k (COUNT), HKI 150k (MAX, deg 3)
              and HKI 50k (MIN), cut as the CUT lines say.  A hot-band step (inserts
              and deletes in one dense band, appended bars and extremal
              deletes in one window) is queried while buffered, then
              flushed (the merge must refit few segments) and queried
              again; a buffer-full step (4,096 pending ops a table, no
              merge) is queried last.  Every batch is checked against numpy
              truth over the updated multiset, the launch counters must show
              K1-K3, K5 and K6, and in each state every one of them is held
              to its plain version at the shapes the path gave it (K1-K3 on
              that state's plans, K5/K6 on its buffers).  In
              each state 65,536 quantile fractions on the COUNT table go
              through the session's dynamic quantile path (plain torch by
              design) and are checked against numpy over the live
              multiset; in the merged state K4 runs through
              execute_quantile on the 300k-key plan, is held to its plain
              version there and timed.  K1-K3 are timed again at the
              dynamic plans, K5/K6 on the full buffers, with the
              full-buffer query latency, one 4,096-record insert and the
              merges;
9. window   - an epoch-ring COUNT table (TableSpec(window=4), capacity
              65,536): epoch 0 is the fit's 65,536 TWEET keys, epochs 1-3
              are each filled by 16 ingests of 4,096 rows and sealed, the
              open epoch 4 holds 4,096 rows.  Four windows (all epochs, the
              last sealed epoch and the open one, one sealed epoch, the open
              epoch alone) each take 65,536 ranges under Q_abs and Q_rel,
              checked against numpy over exactly the selected epochs' rows;
              the counters must show K2 per sealed epoch, K5 when the
              window reaches the open epoch and K1 under Q_rel, and K1, K2
              and K5 are held to their plain versions at the window's
              shapes (K5 exactly).  One more seal evicts epoch 0, whose
              window must then raise;
10. 2d      - PolyFit.fit of four static two-key tables over OSM-like
              points (cut as the CUT lines say): ``osm`` COUNT rectangles
              (60k points, delta 50, deg 3), ``osm_sum`` SUM rectangles
              (50k, delta 2,500), ``osm_max`` / ``osm_min`` dominance
              MAX / MIN (20k, delta 10, deg 2).  One mixed batch of 65,536
              rectangles a rectangle table and 65,536 data-anchored
              corners a dominance table goes through session.query under
              Q_abs and under Q_rel; the counters must show K7, K8 and K1.
              Two plans deeper than 15 levels (COUNT and MIN over 20k
              points, max_depth 16) run through execute_count2d /
              execute_extremum2d, whose counters must show K12 and K13 and
              neither K7 nor K8.  Every answer is checked against dense
              truth computed on the card (chunked compare-and-count,
              compare-and-sum, masked max): Q_abs within 4 x the table's
              certified delta (rectangles) or 1 x (corners), Q_rel within
              1%.  K7, K8, K12 and K13 are held to their plain versions on
              ``osm``'s plan (max abs error 0; K12 and K13 on its full
              flat table), K7 to K12 on corners on the split lines, K8 on
              the dominance plans and K12/K13 on the deep ones, and each is
              timed on ``osm``'s plan, K7 beside its loads a rectangle
              and K8 beside its loads a corner (each before and after its
              redesign) and the rate an SM served them at;
11. dyn2d   - PolyFit.fit of three dynamic two-key tables
              (TableSpec(dynamic=True), capacity 4,096) over OSM-like
              points: ``osm_dyn`` COUNT (50k, delta 50, deg 3),
              ``osm_sum_dyn`` SUM (40k, delta 2,500, deg 2), ``osm_min_dyn``
              dominance MIN (20k, delta 10, deg 2).  A hot-box step (1,024
              inserts in one square degree at a metro core, and the 256
              base points nearest its center deleted; 64 on the MIN table,
              whose deletes shadow their victims) is queried while
              buffered, then flushed (``last_refit_stats``: no rebuild,
              fewer leaves refit than there are); one MIN insert above
              every measure (below the frozen floor in MAX space) must
              merge at once; the merged state is queried; a buffer-full
              step (3,072 inserts and 1,024 deletes a table, no merge) is
              queried last.  Each state: 65,536 rectangles or corners a
              table under Q_abs and Q_rel, checked against dense truth on
              the card over the live multisets (rectangles within 4 x the
              live certified delta, corners 1 x, Q_rel within 1%); the
              counters must show K9 4, K10 4, K11 2, K7 4, K8 2 and K1;
              K9-K11, K1, K7 and K8 are held to their plain versions at the
              path's shapes (max abs error 0), and K9-K11 are timed on the
              full 4,096-slot logs, K9 and K10 beside their loads a
              rectangle (before and after the set-bits walk) and the rate
              an SM served them at;
12. lsm     - PolyFit.fit of three LSM-tiered tables (TableSpec(dynamic=True,
              lsm=True), capacity 2,048) at the reference's LSM bench
              configuration: ``lsm`` TWEET 100k COUNT (delta 50),
              ``lsm_max`` HKI 50k MAX (deg 3, delta 50) and ``lsm_sum2d``
              OSM-like 100k SUM rectangles (w = 50 + 20 sin(x/7) + 15
              cos(y/11), delta 1% of sum |w|).  Ten batches of 512 inserts
              a table (uniform over its domain; new bars valued by the
              series at their time plus the generator's noise; a
              compaction every second batch), deletes of 3 x 256 base rows (tombstones; on
              ``lsm_max`` the 64 largest bars of one window, victims that
              must compact nothing), and one more buffered batch; at least
              two levels and one compaction a table.  65,536 ranges or
              rectangles a table under Q_abs and Q_rel through one mixed
              session batch, checked against numpy truth (1-D) or dense
              truth on the card (2-D) over the live multisets: Q_abs within
              the composed bound, Q_rel within 1%.  The counters must show
              exactly K2, K3 and K7 a level, K8 four times a level, K5, K6
              and K10 on the buffers and K1 in the exact answers, each held
              to its plain version at the ladder's shapes (max abs error
              0); ``execute_lsm`` on the ``lsm`` ladder and buffer on
              ``cuda_scan`` (K14, K16) equals ``cuda`` bit for bit.  The
              worst insert, compaction-carrying, tombstone and victim
              delete ops and the fused query latency are printed.
13. shard   - the sharded engines (engine/sharded.py: each plan
              partitioned into S contiguous key ranges, or Morton
              z-ranges, and answered shard by shard on the plain 'torch'
              arithmetic, as the reference's shard body runs XLA; no
              kernel may launch): the parallel step's 1M-key TWEET plan
              (kept alive since phase 3) at S = 1, 2, 4 and 8, 65,536
              ranges under Q_abs and Q_rel; then PolyFit.fit of two
              TableSpec(shards=4) tables (TWEET COUNT and HKI MAX, deg 3,
              50k keys each, CUT lines) and one mixed batch through
              session.query under Q_abs and Q_rel.  Every answer,
              approximation and refined flag must equal the unsharded
              'torch' path on the same plan (Engine(backend="torch") on
              session.plan(name) for the session) exactly, and every
              answer must hold its bound against numpy truth.  Each S
              prints the partition's host seconds and the batch's median
              latency beside the unsharded path's, the session its median
              beside the unsharded Engine's, and the card's name and power
              limit follow;
14. serve   - a repro_torch.serve.ServingEngine over each session phases
              3, 8, 10 and 12 hold (static; dynamic with full buffers and
              shadowed victims; 2d; lsm ladders with buffers), no table
              built: the bucket ladder up to 4,096 captured as one CUDA
              graph a bucket (a level, on the ladders) for ranges and
              quantiles (captures, graph-pool bytes and seconds printed);
              4,000 mixed requests of 1-64 lanes (COUNT, SUM, MAX, MIN,
              quantiles, rectangles, corners, ladders; Q_abs and Q_rel)
              from four client threads, every answer, approximation,
              refined flag and certificate equal to the serial
              session.query bit for bit and within its bound against the
              phase's truth, the wrappers' counters showing K1-K8 and K10
              captured; 512 inserts through engine.insert(wait=True)
              into the lsm ladder and a flush (a compaction): staged
              level graphs promoted, no capture after the swap, answers
              equal session.query and hold their bounds; the median
              engine.query latency per bucket beside session.query's on
              the same batch, and one traced batch of each (idle share);
              chaos on the lsm session (serve.worker, serve.dispatch
              retried, serve.updater armed): every future resolves with
              its answer or the injected error, the journal replays, the
              staged rows land exactly once; then AggregateService (dynamic, eight tables,
              cut as the CUT line says), warmed to 1,024, every kind
              served equal to session.query, 256 inserts and a flush.

The ``shard`` steps do the same at S = 2 and 8, at the end of phases 7,
8, 10, 11 and 12, on what those phases hold (no table built): the static
``hki``, ``hki_min`` and ``hki_sum`` plans, the full-buffer states of
``lat_dyn`` (tombstones) and ``hki_dyn`` (shadowed victims), the four
two-key plans, the dyn2d tables' full-buffer states and the three lsm
ladders with their buffers (Q_abs only: a sharded ladder takes no Q_rel);
each answer equal to the unsharded 'torch' path's and within its bound
against the phase's truth.

The ``cuda_scan`` backend (the one-hot scan kernels K14-K17, K4's scan
mode and the two-key whole-log scans K18-K20) runs at the end of phases
7-11 on the plans, indexes and logs those phases already hold, building
no table and fitting nothing (``scan`` steps): the four static plans take
the main-path batch under Q_abs and Q_rel and 65,536 quantile fractions
on the COUNT and SUM tables; ``osm`` and ``osm_max`` take the 2d batch
(K12/K13, never K7/K8); a ``DynamicEngine(backend="cuda_scan")`` over
each dynamic table's merged index takes the table's buffer-full ops and
queries; the all-epochs window runs through ``execute_lsm``; a
``DynamicEngine2D(backend="cuda_scan")`` over each dynamic two-key
table's merged index takes its buffer-full ops and the 2 x 65,536
rectangles and 65,536 corners under Q_abs and Q_rel.  Every answer,
approximation and refined flag must equal the ``cuda`` backend's bit for
bit (the two-key SUM table's within 1e-9: K19 adds the measures K10
differences as prefix sums) and hold against the truths above, the
counters must show K14-K20 and K4's scan mode and none of K2, K3, K5-K11
or gather-mode K4, and K14-K20 and K4's scan mode are held to their plain
versions (max abs error 0) and timed: K4's scan mode at the static COUNT
and SUM plans, K14/K15 at the dynamic plans, K16-K20 on the full
4,096-slot logs and K16 also on the window's 65,536-slot log.  K16,
K17 and K20 stop at a log's sentinel tail, so their bounds count the
slots that hold entries (counted on the card before the timing); the
bound over every slot of the log and the pairs a clock an SM the time
implies are printed beside it.  K13 stops at its leaf table's sentinel
tail likewise (its bound counts the live leaves, the bound over every
leaf printed beside it).  K18 and K19 rank each rectangle's x range to
the slots [a, b) of the x-sorted log and test only those, so their bound
counts the searches and 3 operations a (rectangle, [a, b) slot) pair (the
ranks taken on the card before the timing); the old form's bound, 5
operations a (rectangle, slot) pair over the live slots and over every
slot, the live slots, the mean [a, b) width and the pairs a clock an SM
are printed beside it.  K14 counts #(seg_lo <= q) over the segments
before its table's sentinel tail, so its bound counts the live segments
(2 compares a range and segment, and the rows' Horner); the bound over
every row and K2's time on the same ranges are printed beside it.

K1 runs where the main path runs it, on the plans' keys and their search
trees (``IndexPlan.ref_tree``, ``IndexPlan2D.ref_xs_tree``, built once per
plan); the fit phases print each plan's tree bytes beside its device
bytes, and K1's timings print the tree's bytes, its sector loads a query
(and the binary search's probes before the redesign) and the loads a
clock an SM its time implies.  Its bound counts the bytes the search
needs (queries, answers, and of the keys one 32-byte sector a query, or
every key where that is less) and one compare a binary-search probe; the
bound with every key read once is printed beside it.

The ``ops`` step, at the end of phase 7, runs ``repro_torch.kernels.ops``
(the twin of ``repro.kernels.ops``) on ``lat`` (COUNT, deg 2) and ``hki``
(MAX, deg 3) through ``from_index`` at float64 and at float32 (its
default): ``poly_eval`` on 65,536 data keys a table (K21), ``range_sum``
and ``range_max`` on the main-path ranges on ``cuda`` (K2, K3) and
``cuda_scan`` (K14, K15).  The counters must show exactly those launches,
the two backends must agree bit for bit, the float64 answers must equal
the engine's raw approximation and ``eval_segments`` on the session's
plans, every answer must meet the table's bound against numpy truth (at
float32 plus 8 x eps32 x the CF or measure scale, tests/test_kernels.py's
slack), and each kernel is held to its plain version at both types (max
abs error 0) and timed: K21 at both, the float32 K2, K3, K14 and K15
(their rows' ``by_dtype`` entries).

The line before last is the card's nvidia-smi name and power limit, the
line before that the kernels' JSON record: one row a kernel (K1-K21 and
K4's scan mode), whose own numbers are the dynamic phase's (TWEET 300k;
the 2-D leaf kernels' the 2d phase's, K9-K11's the dyn2d
phase's, K18-K20's the scan dyn2d step's, K21's the float64 ops step's),
whose ``by_dtype`` gives the float32 numbers of K2, K3, K14, K15 and K21,
and whose
``launches`` sums every phase, with ``by_phase``
giving each phase's launches, shape, times and bound; the last line is the
result.
Imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# the static phase, cut from the paper's instance sizes (TWEET 1M
# latitudes, HKI 0.9M minute bars) so that the host builds of every phase
# fit in half the run's time limit; the MIN table only exercises the
# negation path
N_TWEET = 200_000
N_HKI = 100_000
N_HKI_MIN = 50_000
# the SUM table over HKI bars: a budget of 100,000 index points is about
# 3.3 bars' worth of the summed price (bars sit near 30,000)
N_HKI_SUM = 100_000         # 200k until the serve phase took its time
HKI_SUM_ABS = 1e5
# the dynamic phase: TWEET cut from the paper's 1M (its greedy fit took
# 204 s of host time; the parallel step fits the paper's size instead), HKI
# cut (its 0.9M-bar MAX build alone takes 190-330 s of host time); its MIN
# table exercises the negation and victim paths
N_TWEET_DYN = 300_000
N_HKI_DYN = 150_000         # 300k until the shard phase took its time
N_HKI_MIN_DYN = 50_000      # 100k until the serve phase took its time
CAPACITY = 4096             # delta-buffer slots per dynamic table
# the parallel step: batched-Lawson construction (method="parallel") of the
# paper's 1M TWEET keys and of the static phase's 200k, at lat_dyn's delta
N_PARALLEL = 1_000_000
PARALLEL_DELTA = 50.0
# the lsm phase, at the reference's LSM bench configuration
# (benchmarks/bench_updates.py run_lsm): TWEET 100k COUNT (delta 50), OSM-like
# 100k SUM rectangles (w = 50 + 20 sin(x/7) + 15 cos(y/11), delta 1% of
# sum |w|), and an HKI MAX table (deg 3, hki_dyn's delta) for the victims;
# capacity 2,048, ten insert batches of 512, three deletes of 256 base rows
N_LSM = 100_000
N_LSM_MAX = 50_000
N_LSM_SUM2D = 100_000
LSM_CAPACITY = 2048
LSM_BATCH = LSM_CAPACITY // 4
LSM_BATCHES = 10
LSM_VICTIMS = 64            # the largest bars of one WINDOW-bar window
# the window phase: four sealed epochs of 65,536 TWEET rows, each filled
# by 16 ingests of 4,096 rows; the ring retains 4 sealed epochs
N_EPOCH = 65_536             # 131,072 until the serve phase took its time
INGEST_ROWS = 4096
WINDOW_RING = 4
# the 2d phase: OSM-like points (the generator's default 1M, the paper's
# OSM 100M), cut so that its host builds take about 110 s and the dyn2d
# phase's about 70 s; measures w = 50 + 10 sin(x/10) + 10 cos(y/15) on the
# SUM, MAX and MIN tables
N_OSM = 60_000              # 100k until the serve phase took its time
N_OSM_SUM = 50_000
N_OSM_EXT = 20_000
N_OSM_DEEP = 20_000
DEEP_DEPTH = 16             # past MAX_MORTON_DEPTH: the scan kernels
# the dyn2d phase: dynamic two-key tables over OSM-like points, cut from the
# generator's 1M (osm_sum_dyn at the size of the reference's own 2-D update
# bench, benchmarks/bench_updates.py run2d); capacity 4,096 as above
N_OSM_DYN = 50_000          # 100k until the serve phase took its time
N_OSM_SUM_DYN = 40_000
N_OSM_MIN_DYN = 20_000
# the shard phase: the parallel step's 1M TWEET plan at every shard count,
# the other phases' tables at two, and one session of sharded tables
SHARDS_ALL = (1, 2, 4, 8)
SHARDS_TWO = (2, 8)
SESSION_SHARDS = 4
N_SHARD = 50_000            # each of the sharded session's two tables
# the serve phase: engines over the sessions phases 3, 8, 10 and 12 hold
SERVE_REQUESTS = 4000       # mixed requests of 1-64 lanes each
SERVE_CLIENTS = 4           # client threads submitting them
SERVE_MAX_BUCKET = 4096     # the warmed bucket ladder's top
SERVE_BUCKETS = (64, 256, 1024, 4096)
SERVE_SWAP_INSERTS = 512    # rows inserted through the engine before a swap
SERVE_CHAOS_ROWS = 64       # rows a staged insert carries under chaos
N_AGG_1D = 10_000           # AggregateService, cut from its 150k
N_AGG_2D = 10_000           # and from its 60k two-key points
NQ = 65_536                 # ranges per table in the main-path batch
SEED = 7
EPS_REL = 0.01
TOL = 1e-9                  # kernel vs plain version (ROADMAP rule 4)
TIMED_LAUNCHES = 100
DEVICE = "cuda"

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, FP64 and FP32 (non-tensor)
# peaks
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12
FP32_FLOPS = 67e12

REPLACES = {
    "locate": "src/repro/kernels/locate.py:179",
    "range_sum_gather": "src/repro/kernels/range_sum.py:49",
    "range_max_gather": "src/repro/kernels/range_max.py:62",
    "quantile_invert": "src/repro/kernels/quantile_invert.py:52",
    "delta_sum_gather": "src/repro/kernels/delta_scan.py:113",
    "delta_max_gather": "src/repro/kernels/delta_scan.py:188",
    "corner_count2d_gather": "src/repro/kernels/leaf_eval2d.py:85",
    "corner_eval2d_gather": "src/repro/kernels/leaf_eval2d.py:134",
    "corner_count2d": "src/repro/kernels/leaf_eval2d.py:278",
    "corner_eval2d": "src/repro/kernels/leaf_eval2d.py:193",
    "delta_count2d_gather": "src/repro/kernels/delta_scan.py:280",
    "delta_sum2d_gather": "src/repro/kernels/delta_scan.py:378",
    "delta_dommax2d_gather": "src/repro/kernels/delta_scan.py:461",
    "range_sum": "src/repro/kernels/range_sum.py:108",
    "range_max": "src/repro/kernels/range_max.py:142",
    "delta_sum": "src/repro/kernels/delta_scan.py:80",
    "delta_max": "src/repro/kernels/delta_scan.py:156",
    "quantile_invert_scan": "src/repro/kernels/quantile_invert.py:52",
    "delta_count2d": "src/repro/kernels/delta_scan.py:236",
    "delta_sum2d": "src/repro/kernels/delta_scan.py:335",
    "delta_dommax2d": "src/repro/kernels/delta_scan.py:427",
    "poly_eval": "src/repro/kernels/poly_eval.py:75",
}
SOURCE = {name: "src/repro_torch/csrc/polyfit_kernels.cu" for name in REPLACES}
SOURCE["quantile_invert"] = "src/repro_torch/csrc/quantile.cu"
KERNELS_2D = ("corner_count2d_gather", "corner_eval2d_gather",
              "corner_count2d", "corner_eval2d")
for _name in KERNELS_2D:
    SOURCE[_name] = "src/repro_torch/csrc/leaf_eval2d.cu"
KERNELS_DYN2D = ("delta_count2d_gather", "delta_sum2d_gather",
                 "delta_dommax2d_gather")
for _name in KERNELS_DYN2D:
    SOURCE[_name] = "src/repro_torch/csrc/delta2d.cu"
# the cuda_scan backend's kernels; K4's scan mode has a row of its own
KERNELS_SCAN = ("range_sum", "range_max", "delta_sum", "delta_max")
for _name in KERNELS_SCAN:
    SOURCE[_name] = "src/repro_torch/csrc/scan1d.cu"
SOURCE["quantile_invert_scan"] = "src/repro_torch/csrc/quantile.cu"
# the cuda_scan backend's two-key buffered corrections
KERNELS_SCAN2D = ("delta_count2d", "delta_sum2d", "delta_dommax2d")
for _name in KERNELS_SCAN2D:
    SOURCE[_name] = "src/repro_torch/csrc/scan2d.cu"
SOURCE["poly_eval"] = "src/repro_torch/csrc/scan1d.cu"
# the kernels with a float32 instantiation (kernels/ops.py's tables): their
# rows carry the float32 numbers under by_dtype
KERNELS_F32 = ("poly_eval", "range_sum_gather", "range_max_gather",
               "range_sum", "range_max")
# the phase whose measurements head each kernel's row
HEAD_PHASE = {**dict.fromkeys(KERNELS_2D, "2d"),
              **dict.fromkeys(KERNELS_DYN2D, "dyn2d"),
              **dict.fromkeys(KERNELS_SCAN, "scan dynamic"),
              **dict.fromkeys(KERNELS_SCAN2D, "scan dyn2d"),
              "quantile_invert_scan": "scan static", "poly_eval": "ops f64"}
SCAN_STATIC = ("lat", "hki", "hki_min", "hki_sum")
METHODS = ("linear", "lower", "higher", "nearest", "midpoint")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# exact answers on the host, with numpy alone
# ---------------------------------------------------------------------------

def host_sparse_table(m: np.ndarray) -> np.ndarray:
    """st[j, i] = max(m[i : i + 2^j]); O(1) range max per query."""
    levels = max(1, int(np.log2(len(m))) + 1)
    st = np.full((levels, len(m)), -np.inf)
    st[0] = m
    for j in range(1, levels):
        half = 1 << (j - 1)
        st[j, :-half] = np.maximum(st[j - 1, :-half], st[j - 1, half:])
        st[j, -half:] = st[j - 1, -half:]
    return st


def host_range_max(st: np.ndarray, i: np.ndarray, j: np.ndarray) -> np.ndarray:
    """max over [i, j) for non-empty spans."""
    lvl = np.floor(np.log2(j - i)).astype(np.int64)
    return np.maximum(st[lvl, i], st[lvl, j - (1 << lvl)])


def host_truth(keys, meas, lq, uq, agg):
    """COUNT and SUM over (lq, uq]; MAX/MIN over [lq, uq] (every span
    non-empty, since the endpoints are drawn from the keys)."""
    order = np.argsort(keys, kind="stable")
    k = keys[order]
    if agg == "count":
        return (np.searchsorted(k, uq, side="right")
                - np.searchsorted(k, lq, side="right")).astype(np.float64)
    if agg == "sum":
        cf = np.concatenate([[0.0], np.cumsum(meas[order])])
        return (cf[np.searchsorted(k, uq, side="right")]
                - cf[np.searchsorted(k, lq, side="right")])
    m = meas[order] if agg == "max" else -meas[order]
    i = np.searchsorted(k, lq, side="left")
    j = np.searchsorted(k, uq, side="right")
    out = host_range_max(host_sparse_table(m), i, j)
    return out if agg == "max" else -out


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def _events_ms(torch, run, count: int) -> float:
    """CUDA-event milliseconds of ``run()`` divided by ``count``."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / count


def call_ms(torch, fn, calls: int = TIMED_LAUNCHES) -> float:
    """Milliseconds per eager call over ``calls`` warm calls: what a Python
    caller waits, host dispatch included."""
    for _ in range(10):
        fn()

    def run():
        for _ in range(calls):
            fn()
    return _events_ms(torch, run, calls)


def device_ms(torch, fn, calls: int = 20, replays: int = 5) -> float:
    """Device milliseconds per call: ``calls`` calls captured in one CUDA
    graph, the graph replayed ``replays`` times between two events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()

    def run():
        for _ in range(replays):
            graph.replay()
    return _events_ms(torch, run, calls * replays)


def bound_ms(nbytes: float, flops: float, peak: float = FP64_FLOPS):
    """The least time for the work: bytes over HBM bandwidth or operations
    over the peak of their type (FP64 unless ``peak`` says otherwise),
    whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def probe_rounds(n: int) -> int:
    """Probe rounds of the branch-free binary search over n entries."""
    return max(0, (n - 1).bit_length()) + 1


def k1_plain(q, keys, tree=None):
    """K1's plain version on K1's arguments (the binary search needs no
    tree)."""
    from repro_torch.kernels.locate import locate_segments
    return locate_segments(keys, q)


def range_max_flops(rounds: int, deg: int) -> int:
    """f64 operations of K3 for one query (locate.cuh): two binary searches,
    and per boundary segment two scale_unit (5 each), up to four Horner
    evaluations (2 * deg each) and about 20 for the roots, maxima and
    clips; 6 for the interior max and the final maxima."""
    return 2 * rounds + 2 * (10 + 4 * 2 * deg + 20) + 6


def quantile_flops(deg: int, rounds_b: int, rounds_keys: int) -> int:
    """f64 operations of K4 for one rank target (csrc/quantile.cu): three
    searches over B (``rounds_b`` compares each) and the snap's
    ``rounds_keys`` compares over the key grid, and per inversion (hi, lo,
    mid) the root solve, the root checks and the unscale.  The solve
    costs, counting a transcendental (acos, cos, pow) as 20: deg 1 about
    3, deg 2 about 14, deg 3 about 60 plus the four transcendentals of the
    trigonometric branch (Cardano's takes two; the solve computes only the
    branch it keeps), and above deg 3 (mid only: the certified sides keep
    segment endpoints) 40 Newton steps of 4 * deg + 10."""
    if deg <= 1:
        solve = 3
    elif deg == 2:
        solve = 14
    elif deg == 3:
        solve = 60 + 4 * 20
    else:
        solve = 40 * (4 * deg + 10)
    sides = 3 if deg <= 3 else 1
    return (3 * rounds_b + rounds_keys + sides * (solve + 12)
            + 2 * deg + 10)


def max_abs_err(a, b) -> float:
    """Largest |a - b| (equal infinities count 0)."""
    same = a == b
    d = (a - b).abs().masked_fill(same, 0.0)
    return float(d.max()) if d.numel() else 0.0


def check_answers(tag, names, answers, truth, bounds):
    """Hold a Q_abs and a Q_rel batch to the exact answers: every Q_abs
    answer within its bound, every Q_rel answer within EPS_REL.  Returns
    the Q_rel refined share of each table."""
    shares = {}
    for label in ("Q_abs", "Q_rel"):
        for name, ans in zip(names, answers[label]):
            a = ans.value.cpu().numpy()
            r = truth[name]
            check(a.shape == r.shape and np.all(np.isfinite(a)),
                  f"{tag}{label} {name}: bad answers")
            err = np.abs(a - r)
            if label == "Q_abs":
                check(err.max() <= bounds[name] + 1e-6,
                      f"{tag}{label} {name}: |A-R| {err.max()} > "
                      f"{bounds[name]}")
                print(f"{tag}{label} {name}: max |A-R| = {err.max()!r} <= "
                      f"{bounds[name]}")
            else:
                pos = r != 0
                rel = float((err[pos] / np.abs(r[pos])).max())
                share = shares[name] = float(ans.refined.float().mean())
                check(rel <= EPS_REL + 1e-12,
                      f"{tag}{label} {name}: relative error {rel} > "
                      f"{EPS_REL}")
                print(f"{tag}{label} {name}: max rel err = {rel!r} <= "
                      f"{EPS_REL}; refined share {share!r}")
    return shares


def fractions(seed: int) -> np.ndarray:
    """NQ quantile fractions: uniform draws from ``seed`` plus 0 and 1."""
    rng = np.random.default_rng(seed)
    return np.concatenate([[0.0, 1.0], rng.uniform(0.0, 1.0, NQ - 2)])


def check_quantiles(tag, name, a, lo, hi, keys, weights, fr):
    """Hold one quantile answer batch to numpy: [lo, hi] brackets every
    np.quantile method (COUNT, ``weights`` None) or the weighted
    convention x* = min{k : F(k) >= q * total} (SUM) over the sorted
    ``keys``, and the answer lies in [lo, hi].  lo is an unsnapped root and
    hi a snapped key: where both land on one key, lo may sit ulps above hi
    and the answer is hi; such lanes are counted."""
    a, lo, hi = (x.cpu().numpy() for x in (a, lo, hi))
    check(a.shape == fr.shape and np.all(np.isfinite(a))
          and np.all(np.isfinite(lo)) and np.all(np.isfinite(hi)),
          f"{tag}quantile {name}: bad answers")
    if weights is None:
        truths = {m: np.quantile(keys, fr, method=m) for m in METHODS}
    else:
        cf = np.cumsum(weights)
        i = np.minimum(np.searchsorted(cf, fr * cf[-1], side="left"),
                       len(keys) - 1)
        truths = {"weighted": keys[i]}
    for m, truth in truths.items():
        check(np.all(lo <= truth + 1e-12) and np.all(truth <= hi + 1e-12),
              f"{tag}quantile {name}: the certificate misses the {m} "
              f"quantile in {int(np.sum((lo > truth) | (truth > hi)))} lanes")
    ulps = int(np.sum(lo > a))
    check(np.all(a <= hi) and np.all(lo <= a + 1e-9 * (1.0 + np.abs(a))),
          f"{tag}quantile {name}: an answer lies outside its certificate")
    width = hi - lo
    print(f"{tag}quantile {name}: {len(fr)} fractions, every certificate "
          f"brackets {'/'.join(truths)}; width median {np.median(width)!r} "
          f"max {width.max()!r}; lanes with lo ulps above the answer "
          f"{ulps}", flush=True)


def measure(torch, tag, name, fn, plain, args, library, nbytes, flops,
            shape, plain_calls=20, peak=FP64_FLOPS):
    """Time one kernel, its plain version and its library yardstick on the
    same arguments, at one shape of the main path (the plain version over
    ``plain_calls`` calls a graph, fewer where one call takes long); the
    operations count against ``peak`` (FP64, or FP32 for float32 work)."""
    ms = device_ms(torch, lambda: fn(*args))
    eager_ms = call_ms(torch, lambda: fn(*args))
    plain_ms = device_ms(torch, lambda: plain(*args), calls=plain_calls,
                         replays=min(5, plain_calls))
    lib_ms = None if library is None else device_ms(
        torch, lambda: library(*args))
    b_ms, b_by = bound_ms(nbytes, flops, peak)
    kind = "f64" if peak == FP64_FLOPS else "f32"
    print(f"{tag}timing {name} [{shape}]: kernel {ms!r} ms on the device, "
          f"{eager_ms!r} ms per eager call; plain {plain_ms!r} ms; library "
          f"{lib_ms!r} ms; bound {b_ms!r} ms ({b_by}: {int(nbytes)} bytes, "
          f"{int(flops)} {kind} operations)", flush=True)
    return {"shape": shape, "ms": ms, "call_ms": eager_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
            "bound_by": b_by, "bound_bytes": int(nbytes),
            "bound_ops": int(flops)}


# the measure() keys a by_phase entry keeps (the timing lines print the
# shapes and counts, which would make the record too long to read back)
PHASE_KEYS = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")


def kernel_row(name, phases, err):
    """One kernel's row of the kernels' JSON record.  ``phases`` maps each
    phase that launched it to (launches, its measure() at that phase's
    shapes, or None where it was not timed there); the row's own numbers
    are the dynamic phase's (TWEET 300k), the 2d phase's for
    the 2-D leaf kernels, the dyn2d phase's for K9-K11, the scan dynamic
    step's for K14-K17, the scan static step's for K4's scan mode, the
    scan dyn2d step's for K18-K20 and the float64 ops step's for K21
    (``HEAD_PHASE``), and ``launches`` sums them all."""
    head = phases[HEAD_PHASE.get(name, "dynamic")][1]
    return {"name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name],
            "launches": sum(n for n, _ in phases.values()),
            "max_abs_err": err, **head,
            "by_phase": [{"phase": ph, "launches": n,
                          **{k: m[k] for k in PHASE_KEYS if m}}
                         for ph, (n, m) in phases.items()]}


def query_latency(torch, session, req, label, nq):
    """Median of 5 host wall times of ``session.query(req)``, synchronized."""
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.query(req)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"{label} ({nq} ranges, numpy in): median "
          f"{statistics.median(times)!r} ms, runs {times!r}", flush=True)


def profile_batch(torch, session, req, label):
    """One batch under torch.profiler: its wall time there, the device's
    busy time (its kernels and copies) and the heaviest device entries."""
    from torch.profiler import ProfilerActivity, profile
    session.query(req)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        session.query(req)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev)
    top = sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)
    heavy = "; ".join(f"{e.key[:48]} {e.self_device_time_total!r} us "
                      f"x{e.count}" for e in top[:6])
    idle = f"{1 - busy / wall_us!r}" if busy else "not measured"
    print(f"{label} under the profiler: wall {wall_us!r} us, device busy "
          f"{busy!r} us, idle share {idle}; heaviest: {heavy}", flush=True)


# ---------------------------------------------------------------------------
# the 2d phase: dense truth on the card, bounds of the leaf kernels
# ---------------------------------------------------------------------------

def osm_measure(px, py):
    """The 2-D tables' measure (the reference tests' smooth surface)."""
    return 50 + 10 * np.sin(px / 10) + 10 * np.cos(py / 15)


def dense_rect(torch, px, py, w, lx, ux, ly, uy, chunk=512):
    """Sum of w (None: count) over points in (lx, ux] x (ly, uy], one
    chunk of rectangles against every point at a time: an exact
    compare-and-sum on the card, independent of the merge-sort tree."""
    out = []
    for s in range(0, lx.shape[0], chunk):
        sl = slice(s, s + chunk)
        m = ((px[None, :] > lx[sl, None]) & (px[None, :] <= ux[sl, None])
             & (py[None, :] > ly[sl, None]) & (py[None, :] <= uy[sl, None]))
        out.append(m.sum(dim=1, dtype=torch.float64) if w is None
                   else (m.to(torch.float64) * w[None, :]).sum(dim=1))
    return torch.cat(out)


def dense_dominance(torch, px, py, w, u, v, extreme, chunk=1024):
    """max (or min) of w over {x <= u, y <= v}, masked on the card."""
    fill = -torch.inf if extreme == "max" else torch.inf
    out = []
    for s in range(0, u.shape[0], chunk):
        sl = slice(s, s + chunk)
        m = (px[None, :] <= u[sl, None]) & (py[None, :] <= v[sl, None])
        x = torch.where(m, w[None, :], fill)
        out.append(x.amax(dim=1) if extreme == "max" else x.amin(dim=1))
    return torch.cat(out)


def horner2d_flops(deg: int) -> int:
    """f64 operations of one leaf evaluation: the two scaled coordinates
    (5 each) and Horner in v inside Horner in u (2 (deg+1)^2 + 2 (deg+1))."""
    return 10 + 2 * (deg + 1) ** 2 + 2 * (deg + 1)


def mst_probes(cap: int) -> int:
    """Dependent probes of one corner over a (cap.bit_length(), cap)
    merge-sort tree: the x-rank's binary search and (l + 1) rounds a
    level."""
    levels = cap.bit_length()
    return probe_rounds(cap) + levels * (levels + 1) // 2


def walk_probes(torch, args, weighted: bool):
    """Mean loads a rectangle of K9 (K10 where ``weighted``) on one argument
    set, computed on the card from its x-ranks: as the walk was before its
    redesign (four corners, each an x-rank and every level's l + 1 probes,
    K10 a prefix-sum load a level) and as it is (two x-ranks, l + 1 probes
    for each set bit l of each corner's x-rank, K10 at most one prefix-sum
    load a set bit)."""
    lx, ux, _, _, kx = args[:5]
    cap = kx.shape[0]
    levels = cap.bit_length()
    old = 4 * (mst_probes(cap) + (levels if weighted else 0))
    i = torch.searchsorted(kx, torch.stack([ux, lx]), right=True)
    bits = torch.stack([(i >> l) & 1 for l in range(levels)]).double()
    per = torch.arange(1, levels + 1, dtype=torch.float64,
                       device=kx.device)[:, None, None]
    tree = 2 * (bits * (per + (1 if weighted else 0))).sum((0, 1))
    return float(old), float(2 * probe_rounds(cap) + tree.mean())


def cut_rank_loads(torch, c, q):
    """Loads of csrc/locate.cuh cut_rank_guess for each value q against the
    sorted cuts c: the two end cuts, then c[g - 1] and c[g] where they exist
    at each check of the guess g (at most three), and the binary search's
    rounds where every check failed (the search alone at n <= 2)."""
    n = c.shape[0]
    if n <= 2:
        return torch.full_like(q, float(probe_rounds(n)))
    t = (q - c[0]) * ((n - 1) / (c[n - 1] - c[0]))
    inside = (t >= 0) & (t < n - 1)
    g = torch.where(inside, torch.where(inside, t, 0.0).long() + 1,
                    torch.where(t >= 0, n, 0))
    loads = torch.full_like(q, 2.0)
    done = torch.zeros_like(q, dtype=torch.bool)
    for _ in range(3):
        loads += torch.where(done, 0, (g > 0).double() + (g < n).double())
        lo_ok = (g == 0) | (c[(g - 1).clamp(0, n - 1)] <= q)
        hi_ok = (g == n) | (q < c[g.clamp(0, n - 1)])
        done |= lo_ok & hi_ok
        g = torch.where(done, g, g + torch.where(lo_ok, 1, -1))
    return loads + torch.where(done, 0.0, float(probe_rounds(n)))


def k7_loads(torch, args):
    """Mean loads a rectangle of K7 on one argument set, computed on the
    card from its corners: as it was (four corners, each three binary
    searches and a row of 4 + (deg+1)^2 8-byte loads) and as it is (each of
    the two x and two y values ranked once by cut_rank_guess, four leaf-code
    searches, four rows of 2 + (deg+1)^2 / 2 16-byte loads, 8-byte
    coefficient loads at an odd count)."""
    lx, ux, ly, uy, xcuts, ycuts, leaf_z, _, coeffs = args[:9]
    k = coeffs.shape[1]
    nx, ny, L = xcuts.shape[0], ycuts.shape[0], leaf_z.shape[0]
    row_old, row_new = 4 + k, 2 + (k // 2 if k % 2 == 0 else k)
    old = 4 * (probe_rounds(nx) + probe_rounds(ny) + probe_rounds(L) + row_old)
    ranks = (cut_rank_loads(torch, xcuts, ux) + cut_rank_loads(torch, xcuts, lx)
             + cut_rank_loads(torch, ycuts, uy)
             + cut_rank_loads(torch, ycuts, ly))
    new = ranks.mean() + 4 * (probe_rounds(L) + row_new)
    return float(old), float(new)


def k8_loads(torch, args):
    """Mean loads a corner of K8 on one argument set, computed on the card
    from its corners: as it was (three binary searches and a row of 4 +
    (deg+1)^2 8-byte loads) and as it is (the x and the y value ranked by
    cut_rank_guess, one leaf-code search, the row by 16-byte loads: 2 for
    the bounds and (deg+1)^2 / 2 for the coefficients, 8-byte coefficient
    loads at an odd count).  Each load counts once: the two lanes of a
    corner issue the code search's loads together, to one address."""
    u, v, xcuts, ycuts, leaf_z, _, coeffs = args[:7]
    k = coeffs.shape[1]
    nx, ny, L = xcuts.shape[0], ycuts.shape[0], leaf_z.shape[0]
    old = probe_rounds(nx) + probe_rounds(ny) + probe_rounds(L) + 4 + k
    ranks = cut_rank_loads(torch, xcuts, u) + cut_rank_loads(torch, ycuts, v)
    row = 2 + (k // 2 if k % 2 == 0 else k)
    return float(old), float(ranks.mean() + probe_rounds(L) + row)


def k11_loads(torch, args):
    """Mean loads a corner of K11 on one argument set, computed on the card
    from its x-ranks: as it was (the x-rank's rounds, every level's l + 1
    probes and a prefix-max load a level) and as it is (the x-rank's
    rounds, l + 1 for each set bit l of the x-rank, and a prefix-max load
    for each taken block that holds a y at or below the corner's: its
    first, smallest y)."""
    u, v, kx, ylv = args[:4]
    cap = kx.shape[0]
    levels = cap.bit_length()
    old = mst_probes(cap) + levels
    i = torch.searchsorted(kx, u, right=True)
    new = torch.full_like(u, float(probe_rounds(cap)))
    for lv in range(levels):
        take = ((i >> lv) & 1) == 1
        pos = (i & ~((2 << lv) - 1)).clamp(max=cap - 1)
        hit = take & (ylv[lv][pos] <= v)
        new += take.double() * (lv + 1) + hit.double()
    return float(old), float(new.mean())


# instructions of the FP64 pipe in SASS (a compare, a min/max, a fused or
# plain multiply or add, and the seeds of a division and a square root)
FP64_PIPE = ("DFMA", "DMUL", "DADD", "DSETP", "DSET", "DMNMX", "MUFU.RCP64H",
             "MUFU.RSQ64H")


def sass_fp64(sass: str, pattern: str):
    """FP64-pipe instructions of the first kernel in ``sass`` (``cuobjdump
    -sass``) whose mangled name matches ``pattern``, up to its first
    unpredicated EXIT (after it come the out-of-line slow paths of the
    divisions and square roots): (outside loops, inside loops, DSETP
    inside loops).  A loop is the span from a backward branch's target to
    the branch."""
    for block in sass.split("Function : ")[1:]:
        if not re.search(pattern, block.split()[0]):
            continue
        labels, code = {}, []
        for line in block.splitlines():
            m = re.match(r"\s*(\.L_x_\d+):", line)
            if m:
                labels[m.group(1)] = len(code)
                continue
            m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(@!?U?P\w+\s+)?"
                         r"([A-Z0-9_.]+)([^;]*)", line)
            if m:
                code.append((int(m.group(1), 16), m.group(2), m.group(3),
                             m.group(4)))
        addr = {a: k for k, (a, *_rest) in enumerate(code)}
        end = next((k for k, (_, pred, op, _) in enumerate(code)
                    if op == "EXIT" and not pred), len(code))
        looped = [False] * len(code)
        for k, (_, _, op, rest) in enumerate(code[:end]):
            if not op.startswith("BRA"):
                continue
            m = re.search(r"(\.L_x_\d+)|0x([0-9a-f]+)", rest)
            if not m:
                continue
            t = labels.get(m.group(1)) if m.group(1) else addr.get(
                int(m.group(2), 16))
            if t is not None and t < k:
                for j in range(t, k + 1):
                    looped[j] = True
        fp64 = [k for k, (_, _, op, _) in enumerate(code[:end])
                if op.startswith(FP64_PIPE)]
        inside = [k for k in fp64 if looped[k]]
        return (len(fp64) - len(inside), len(inside),
                sum(code[k][2].startswith("DSETP") for k in inside))
    raise ValueError(f"no kernel matching {pattern} in the SASS")


def k3_sass_counts(sass: str) -> dict:
    """FP64-pipe instructions outside loops (sass_fp64) of K3's float64
    instantiations, by degree, and of K1 (``"k1"``), from the SASS of the
    polyfit_kernels library: K1 is the search tree's descent alone, the
    code K3 runs for its search."""
    counts = {deg: sass_fp64(sass, rf"range_max_gather_kernelIdLi{deg}E")[0]
              for deg in range(4)}
    counts["k1"] = sass_fp64(sass, r"locate_tree_kernel")[0]
    return counts


def k3_fp64_per_query(counts: dict, deg: int, tree_levels: int) -> int:
    """FP64-pipe instructions K3 issues a query: two threads, each the
    straight-line code of its boundary (its SASS outside loops less the
    unrolled descent, K1's count) and the descent's four compares a node
    on the tree's levels and the leaf."""
    return 2 * (counts[deg] - counts["k1"] + 4 * (tree_levels + 1))


def sm_clock(torch):
    """The card's SM count and its maximum SM clock in GHz (nvidia-smi
    clocks.max.sm): the rates a clock an SM below assume that clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ghz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0]) / 1e3
    return sms, ghz


# ---------------------------------------------------------------------------
# the dynamic phase's data: host mirrors of the live multisets
# ---------------------------------------------------------------------------

DYN = ("lat_dyn", "hki_dyn", "hki_min_dyn")
DYN_AGG = {"lat_dyn": "count", "hki_dyn": "max", "hki_min_dyn": "min"}
DYN_BOUND = {"lat_dyn": 100.0, "hki_dyn": 50.0, "hki_min_dyn": 50.0}
HOT_BAND = (40.70, 40.80)   # 0.1 degree at the core of the densest cluster
HOT_INSERTS, HOT_DELETES = 1024, 256
HOT_BARS, EXTREMAL_DELETES, WINDOW = 1440, 64, 512


class Live:
    """One dynamic table's live multiset on the host, for exact truth."""

    def __init__(self, keys, meas):
        self.keys = np.array(keys, np.float64)
        self.meas = None if meas is None else np.array(meas, np.float64)
        self.base = self.keys.copy()          # the fitted rows
        self.base_meas = None if meas is None else self.meas.copy()
        self.deleted = np.zeros(len(self.keys), bool)
        self.hot = []                          # key intervals under update

    def insert(self, keys, meas=None):
        self.keys = np.concatenate([self.keys, keys])
        if self.meas is not None:
            self.meas = np.concatenate([self.meas, meas])

    def delete(self, keys):
        """Remove one occurrence of each (distinct) key."""
        order = np.argsort(self.keys, kind="stable")
        pos = np.minimum(np.searchsorted(self.keys[order], keys),
                         len(self.keys) - 1)
        check(np.all(self.keys[order][pos] == keys), "deleting a missing key")
        keep = np.ones(len(self.keys), bool)
        keep[order[pos]] = False
        self.keys = self.keys[keep]
        if self.meas is not None:
            self.meas = self.meas[keep]

    def pick_base(self, rng, m, lo=-np.inf, hi=np.inf):
        """m distinct, not yet deleted base keys in [lo, hi]; marks them."""
        idx = np.flatnonzero(~self.deleted & (self.base >= lo)
                             & (self.base <= hi))
        idx = rng.choice(idx, m, replace=False)
        self.deleted[idx] = True
        return self.base[idx]

    def queries(self, make_queries_1d, seed):
        """NQ ranges with endpoints from the live keys: three quarters over
        the whole table (``make_queries_1d``), a quarter inside the
        intervals under update."""
        k = np.sort(self.keys)
        lq, uq = make_queries_1d(k, NQ - NQ // 4, seed=seed)
        hot = np.zeros(len(k), bool)
        for lo, hi in self.hot:
            hot |= (k >= lo) & (k <= hi)
        hk = k[hot]
        rng = np.random.default_rng(seed + 1)
        a = hk[rng.integers(0, len(hk), NQ // 4)]
        b = hk[rng.integers(0, len(hk), NQ // 4)]
        return (np.concatenate([lq, np.minimum(a, b)]),
                np.concatenate([uq, np.maximum(a, b)]))


def new_bars(rng, t_last, v_last, m):
    """m minute bars after t_last, continuing the walk from v_last (the
    HKI generator's steps)."""
    t = t_last + np.cumsum(rng.uniform(0.5, 1.5, m))
    steps = rng.normal(0, 12.0, m) + rng.normal(0, 80.0, m) * (
        rng.uniform(size=m) < 0.002)
    return t, np.maximum(v_last + np.cumsum(steps), 1000.0)


def extremal_victims(rng, live, extreme):
    """EXTREMAL_DELETES base bars from one WINDOW-bar window, its own
    extreme (argmax for MAX, argmin for MIN) among them; marks them."""
    while True:
        w0 = int(rng.integers(0, len(live.base) - WINDOW))
        if not live.deleted[w0:w0 + WINDOW].any():
            break
    win = np.arange(w0, w0 + WINDOW)
    top = w0 + int(extreme(live.base_meas[win]))
    pick = np.concatenate([[top], rng.choice(
        win[win != top], EXTREMAL_DELETES - 1, replace=False)])
    live.deleted[pick] = True
    live.hot.append((live.base[w0], live.base[w0 + WINDOW - 1]))
    return live.base[pick]


# ---------------------------------------------------------------------------
# the dyn2d phase's data: host mirrors of the live point multisets
# ---------------------------------------------------------------------------

DYN2D = ("osm_dyn", "osm_sum_dyn", "osm_min_dyn")
# one degree square at the core of one metro cluster (x = latitude)
HOT_BOX = (40.2, 41.2, -74.5, -73.5)
HOT2D_INSERTS, HOT2D_DELETES, HOT2D_VICTIMS = 1024, 256, 64
FULL2D_DELETES = 1024
MIN_ABOVE_MAX = 75.0        # a MIN measure above every osm_measure value


class Live2D:
    """One dynamic two-key table's live point multiset on the host."""

    def __init__(self, x, y, w):
        self.x, self.y = np.array(x), np.array(y)
        self.w = None if w is None else np.array(w)
        self.bx, self.by = self.x.copy(), self.y.copy()   # the fitted points
        self.used = np.zeros(len(self.x), bool)          # deleted base points

    def insert(self, x, y, w=None):
        self.x = np.concatenate([self.x, x])
        self.y = np.concatenate([self.y, y])
        if self.w is not None:
            self.w = np.concatenate([self.w, w])

    def delete(self, x, y):
        """Remove one occurrence of each (x, y)."""
        pos = {}
        for i, k in enumerate(zip(self.x.tolist(), self.y.tolist())):
            pos.setdefault(k, []).append(i)
        keep = np.ones(len(self.x), bool)
        for k in zip(x.tolist(), y.tolist()):
            check(bool(pos.get(k)), "deleting a missing point")
            keep[pos[k].pop()] = False
        self.x, self.y = self.x[keep], self.y[keep]
        if self.w is not None:
            self.w = self.w[keep]

    def pick(self, idx):
        """The base points ``idx`` (not yet deleted); marks them."""
        check(not self.used[idx].any(), "a base point deleted twice")
        self.used[idx] = True
        return self.bx[idx], self.by[idx]

    def nearest(self, m, cx, cy):
        """Indices of the m undeleted base points nearest (cx, cy)."""
        d = np.hypot(self.bx - cx, self.by - cy)
        d[self.used] = np.inf
        return np.argsort(d, kind="stable")[:m]

    def queries(self, make_queries_2d, seed, corners):
        """NQ rectangles (or corners at live points): three quarters over
        the whole table, a quarter at live points in or near the hot box."""
        rng = np.random.default_rng(seed)
        x0, x1, y0, y1 = HOT_BOX
        near = np.flatnonzero((self.x >= x0 - 1) & (self.x <= x1 + 1)
                              & (self.y >= y0 - 1) & (self.y <= y1 + 1))
        m = NQ // 4
        if corners:
            ci = np.concatenate([rng.integers(0, len(self.x), NQ - m),
                                 near[rng.integers(0, len(near), m)]])
            return self.x[ci], self.y[ci]
        lx, ux, ly, uy = make_queries_2d(self.x, self.y, NQ - m, seed=seed)
        ci = near[rng.integers(0, len(near), m)]
        wx, wy = rng.uniform(0.2, 2.0, (2, m))
        return (np.concatenate([lx, self.x[ci] - wx / 2]),
                np.concatenate([ux, self.x[ci] + wx / 2]),
                np.concatenate([ly, self.y[ci] - wy / 2]),
                np.concatenate([uy, self.y[ci] + wy / 2]))


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def main() -> None:
    import torch

    wall0 = time.perf_counter()
    # -- 1. device --------------------------------------------------------
    check(torch.cuda.is_available(), "no CUDA device: this script needs one "
          "NVIDIA card")
    src = os.path.join(ROOT, "src")
    check(os.path.isdir(os.path.join(src, "repro_torch")),
          f"the port's package is missing under {src}")
    sys.path.insert(0, src)
    from repro_torch.api import (ErrorBudget, PolyFit, QueryBatch, QuerySpec,
                                 TableSpec)
    from repro_torch.core import (PolyFitIndex1D, build_index_1d,
                                  build_index_2d, lawson_batched)
    from repro_torch.core import segmentation as kseg
    from repro_torch.core.index2d import _node_depths
    from repro_torch.data import (hki_series, make_queries_1d,
                                  make_queries_2d, osm_points,
                                  tweet_latitudes)
    from repro_torch.core.poly import eval_segments
    from repro_torch.engine import (DynamicEngine, DynamicEngine2D, Engine,
                                    IndexPlan2D, ShardedEngine,
                                    ShardedEngine2D, build_plan,
                                    build_plan_2d, composed_bound, execute,
                                    execute_count2d, execute_extremum,
                                    execute_extremum2d, execute_lsm,
                                    execute_quantile, execute_sum,
                                    raw_extremum, raw_sum)
    from repro_torch.engine.plan import big_sentinel
    from repro_torch.engine.engine import quantile_mass, quantile_tables
    from repro_torch.kernels import _build
    from repro_torch.kernels import delta_scan as kdel
    from repro_torch.kernels import leaf_eval2d as k2d
    from repro_torch.kernels import locate as kloc
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import poly_eval as kpe
    from repro_torch.kernels import quantile_invert as kq
    from repro_torch.kernels import range_max as kmax
    from repro_torch.kernels import range_sum as ksum

    dev = torch.device(DEVICE)
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    build = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.3f} s (nvcc {build.seconds:.3f} s,"
          " units in parallel) -> "
          f"{', '.join(os.path.relpath(p, ROOT) for p in build.paths)}",
          flush=True)
    for line in build.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")
    lib = next(p for p in build.paths
               if os.path.basename(p) == "libpolyfit_kernels.so")
    k3_fp64 = k3_sass_counts(subprocess.run(
        [os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"), "-sass",
         str(lib)], capture_output=True, text=True, check=True,
        timeout=300).stdout)
    print(f"FP64-pipe instructions outside loops in the SASS: K3 by degree "
          f"and K1 {k3_fp64}", flush=True)

    # -- 3. fit -----------------------------------------------------------
    sizes = {"lat": N_TWEET, "hki": N_HKI, "hki_min": N_HKI_MIN,
             "hki_sum": N_HKI_SUM}
    for name, paper in (("lat", 1_000_000), ("hki", 900_000),
                        ("hki_min", 900_000), ("hki_sum", 900_000)):
        if sizes[name] < paper:
            print(f"CUT: {name} n {paper} -> {sizes[name]}")
    lat = tweet_latitudes(sizes["lat"])
    t_h, v_h = hki_series(sizes["hki"])
    t_m, v_m = hki_series(sizes["hki_min"])
    t_s, v_s = hki_series(sizes["hki_sum"])
    datasets = {"lat": lat, "hki": (t_h, v_h), "hki_min": (t_m, v_m),
                "hki_sum": (t_s, v_s)}
    specs = {"lat": TableSpec("count", ErrorBudget(abs=100.0)),
             "hki": TableSpec("max", ErrorBudget(abs=50.0, rel=EPS_REL)),
             "hki_min": TableSpec("min", ErrorBudget(abs=50.0, rel=EPS_REL)),
             "hki_sum": TableSpec("sum", ErrorBudget(abs=HKI_SUM_ABS),
                                  deg=3)}

    def fit(datasets, specs, tag):
        t0 = time.perf_counter()
        session = PolyFit.fit(datasets, specs, device=dev)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        check(session.backend == "cuda", f"default backend {session.backend}")
        secs = session.build_seconds()
        for name in session.tables:
            if session.is_window(name):
                lsm, _ = session.window_snapshot(name, 0, 0)
                plans = [lvl.plan for lvl in lsm.levels]
            elif session.is_lsm(name):
                plans = [lvl.plan for lvl in session.plan(name).levels]
            else:
                plans = [session.plan(name)]
            for p in plans:
                check(p.device.type == "cuda", f"plan {name} on {p.device}")
                shape = (f"leaves={p.n_leaves} Lp={p.leaf_mx0.shape[0]} "
                         f"max_depth={p.max_depth} certified_delta="
                         f"{session.certified_delta(name)!r}"
                         if isinstance(p, IndexPlan2D) else
                         f"h={p.h} Hp={p.seg_lo.shape[0]}")
                print(f"fit {name}: agg={p.agg} n={p.n} {shape} deg={p.deg} "
                      f"delta={p.delta} budget={session.budget(name)} "
                      f"host_build_s={secs[name]:.3f} device_bytes="
                      f"{p.device_bytes()} tree_bytes={p.tree_bytes()} "
                      f"index_bytes={p.size_bytes()}",
                      flush=True)
        print(f"fit {tag}total: {fit_s:.3f} s", flush=True)
        return session

    class K4Scan:
        """K4's scan mode as a counter: its wrapper counts it apart."""
        __name__ = "quantile_invert_scan"
        launches = property(
            lambda self: kq.quantile_invert.scan_launches,
            lambda self, v: setattr(kq.quantile_invert, "scan_launches", v))

    counters = (kloc.locate, ksum.range_sum_gather, kmax.range_max_gather,
                kq.quantile_invert, kdel.delta_sum_gather,
                kdel.delta_max_gather, k2d.corner_count2d_gather,
                k2d.corner_eval2d_gather, k2d.corner_count2d,
                k2d.corner_eval2d, kdel.delta_count2d_gather,
                kdel.delta_sum2d_gather, kdel.delta_dommax2d_gather,
                ksum.range_sum, kmax.range_max, kdel.delta_sum,
                kdel.delta_max, K4Scan(), kdel.delta_count2d,
                kdel.delta_sum2d, kdel.delta_dommax2d, kpe.poly_eval)
    # the kernels cuda_scan must not launch
    GATHERS = ("range_sum_gather", "range_max_gather", "delta_sum_gather",
               "delta_max_gather", "corner_count2d_gather",
               "corner_eval2d_gather", "quantile_invert")
    phase_launches = {}         # phase -> kernel -> launches on its main path

    def reset():
        """Every launch counter (and reroute count) to 0."""
        for c in counters:
            c.launches = 0
        execute_extremum.torch_routes = 0
        execute_quantile.torch_routes = 0

    def read(phase):
        """The counters since reset(), added to ``phase``'s launches."""
        launches = {c.__name__: c.launches for c in counters}
        acc = phase_launches.setdefault(phase, dict.fromkeys(launches, 0))
        for k, v in launches.items():
            acc[k] += v
        return launches

    errs = {}

    def hold(name, fn, plain, args_list, exact=False):
        """Hold a kernel to its plain version on each argument set (equal
        when ``exact``, else to TOL); keep the largest |kernel - plain| in
        errs."""
        errs.setdefault(name, 0.0)
        for args in args_list:
            a, b = fn(*args), plain(*args)
            torch.cuda.synchronize()
            if exact:
                check(torch.equal(a, b), f"{name} differs from its plain "
                      "version")
            else:
                check(torch.allclose(a, b, rtol=TOL, atol=TOL,
                                     equal_nan=False),
                      f"{name} differs from its plain version")
            errs[name] = max(errs[name], max_abs_err(a, b))

    session = fit(datasets, specs, "")

    # -- 3b. parallel: batched-Lawson construction on the card ----------------
    step0 = time.perf_counter()
    labels = (("Q_abs", None), ("Q_rel", EPS_REL))
    rounds = []     # (B, Lmax) of each lockstep round's lawson_batched call

    def counted_lawson(u, F, valid, deg, iters=60):
        rounds.append(tuple(u.shape))
        return lawson_batched(u, F, valid, deg, iters)

    def parallel_build(name, keys, greedy=None):
        """build_index_1d(method="parallel") of ``keys`` on the card (its
        rounds counted), every segment certified and the segments tiling
        the keys; then 65,536 ranges through execute_sum on its plan under
        Q_abs and Q_rel against numpy truth, K2 held to its plain version
        there.  ``greedy``: (segments, seconds) of the greedy fit of the
        same keys."""
        tag = f"parallel {name}: "
        rounds.clear()
        kseg.lawson_batched = counted_lawson
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            idx = build_index_1d(keys, None, "count", deg=2,
                                 delta=PARALLEL_DELTA, method="parallel",
                                 device=dev)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            kseg.lawson_batched = lawson_batched
        k = np.sort(keys)
        starts = idx.seg_start.cpu().numpy().astype(np.int64)
        ends = np.append(starts[1:], len(k)) - 1
        check(bool(np.all(idx.seg_err <= PARALLEL_DELTA)),
              f"{tag}a segment certifies {idx.seg_err.max()!r} > "
              f"{PARALLEL_DELTA}")
        check(starts[0] == 0 and bool(np.all(np.diff(starts) > 0))
              and np.array_equal(idx.seg_lo.cpu().numpy(), k[starts])
              and np.array_equal(idx.seg_hi.cpu().numpy(), k[ends]),
              f"{tag}the segments do not tile the keys")
        chunks = max(1, min(64, len(k) // 4096, len(k)))
        big = max(rounds, key=lambda r: r[0] * r[1])
        vs = ""
        if greedy is not None:
            check(greedy[0] <= idx.h <= greedy[0] + chunks - 1,
                  f"{tag}{idx.h} segments against greedy's {greedy[0]} "
                  f"({chunks} chunks)")
            vs = (f"; greedy GS: {greedy[0]} segments in {greedy[1]!r} s "
                  f"(within chunks - 1 = {chunks - 1})")
        print(f"{tag}n {len(k)}, delta {PARALLEL_DELTA}, {chunks} chunks: "
              f"{idx.h} segments in {secs!r} s, {len(rounds)} lockstep "
              f"rounds, the largest (B, Lmax) {big}; every segment certifies "
              f"(max err {float(idx.seg_err.max())!r}) and the segments tile "
              f"the keys{vs}", flush=True)
        plan = build_plan(idx)
        lq, uq = make_queries_1d(keys, NQ, seed=SEED + 80)
        truth = {name: host_truth(keys, None, lq, uq, "count")}
        reset()
        res = {label: [execute_sum(plan, lq, uq, eps_rel=rel)]
               for label, rel in labels}
        torch.cuda.synchronize()
        launches = read("parallel")
        check(launches["range_sum_gather"] == 2 and launches["locate"] == 2,
              f"{tag}execute_sum launches {launches}")
        check_answers(tag, (name,), {
            label: [SimpleNamespace(value=r.answer, refined=r.refined)
                    for r in res[label]] for label, _ in labels}, truth,
            {name: 2 * PARALLEL_DELTA})
        lqd, uqd = (torch.maximum(torch.as_tensor(q, device=dev),
                                  plan.domain_lo) for q in (lq, uq))
        hold("range_sum_gather", ksum.range_sum_gather,
             ksum.range_sum_gather_plain,
             [(lqd, uqd, plan.seg_lo, plan.seg_hi, plan.coeffs,
               plan.seg_tree)], exact=True)
        print(f"{tag}parity K2 on its plan: max |kernel - plain| = "
              f"{errs['range_sum_gather']!r}", flush=True)
        return big, plan, (lq, uq), truth[name]

    if N_PARALLEL < 1_000_000:
        print(f"CUT: tweet (parallel) n 1000000 -> {N_PARALLEL}", flush=True)
    # the 1M-key plan stays alive for the shard phase (phase 13)
    big, *tweet_1m = parallel_build("tweet", tweet_latitudes(N_PARALLEL))
    parallel_build("lat", lat, (session.plan("lat").h,
                                session.build_seconds()["lat"]))
    # one lockstep round at the largest (B, Lmax): its device time by CUDA
    # events around eager calls, and the device's busy time under the
    # profiler (about iters x 6 small launches a round)
    B, L = big
    u = torch.sort(torch.rand((B, L), dtype=torch.float64, device=dev,
                              generator=torch.Generator(dev).manual_seed(SEED))
                   * 2.0 - 1.0, dim=1).values
    F = torch.cumsum(torch.ones_like(u), dim=1)
    ones = torch.ones_like(u)
    one_round = lambda: lawson_batched(u, F, ones, 2, 40)
    for _ in range(3):
        one_round()
    round_ms = _events_ms(torch, lambda: [one_round() for _ in range(5)], 5)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        one_round()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    launched = sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"parallel: one lawson_batched round at (B, Lmax) = {big}, deg 2, "
          f"40 steps: {round_ms!r} ms between CUDA events (eager calls), "
          f"device busy {busy!r} us in {launched} device launches; step "
          f"seconds {time.perf_counter() - step0!r}", flush=True)



    # -- shard steps: the sharded engines on what a phase holds ---------------
    def no_launches(tag):
        """The sharded path runs the plain 'torch' arithmetic, as the
        reference's shard body runs XLA: no kernel since reset()."""
        moved = {c.__name__: c.launches for c in counters if c.launches}
        check(not moved, f"{tag}the sharded path launched kernels {moved}")

    def median_ms(fn):
        """Median of 5 synchronized host wall times of fn(), in ms."""
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def is_2d(plan):
        p = plan.levels[0].plan if hasattr(plan, "levels") else plan
        return isinstance(p, IndexPlan2D)

    def torch_dyn(eng, ranges, rel):
        """The unsharded 'torch' path on a dynamic engine's live (plan,
        buffer) state: its backend swapped for the call."""
        backend, eng.backend = eng.backend, "torch"
        try:
            return eng.query(*ranges, eps_rel=rel)
        finally:
            eng.backend = backend

    def shard_step(tag, names, plans, ranges, unsharded, counts, bufs=None,
                   labels_=labels):
        """Each table's plan (or ladder) partitioned at each S of
        ``counts`` by a fresh ShardedEngine / ShardedEngine2D, its ranges
        answered under each of ``labels_`` (with ``bufs[name]`` folded
        in): every answer, approximation and refined flag must equal
        ``unsharded(name, rel)``, the unsharded 'torch' path on the same
        plan (and buffer), exactly, and no kernel may launch.  Prints for
        each S the partition's host seconds, the first call's seconds (a
        buffer's partition included) and the Q_abs batch's median latency
        beside the unsharded path's.  Returns {S: {label: results}}."""
        want = {label: [unsharded(n, rel) for n in names]
                for label, rel in labels_}
        plain_ms = {n: median_ms(lambda n=n: unsharded(n, None))
                    for n in names}
        out = {}
        for s in counts:
            out[s] = {label: [] for label, _ in labels_}
            for i, n in enumerate(names):
                plan, buf = plans[n], None if bufs is None else bufs[n]
                se = (ShardedEngine2D if is_2d(plan) else ShardedEngine)(s)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                se.shard(plan)
                torch.cuda.synchronize()
                part_s = time.perf_counter() - t0
                run = lambda rel: se.query(plan, *ranges[n], eps_rel=rel,
                                           buf=buf)
                reset()
                first_s = None
                for label, rel in labels_:
                    t0 = time.perf_counter()
                    r = run(rel)
                    torch.cuda.synchronize()
                    if first_s is None:
                        first_s = time.perf_counter() - t0
                    for field, a, b in zip(r._fields, r, want[label][i]):
                        check(torch.equal(a, b),
                              f"{tag}{n} S={s} {label}: the sharded "
                              f"{field} differs from the unsharded torch "
                              "path")
                    out[s][label].append(r)
                no_launches(f"{tag}{n} S={s}: ")
                ms = median_ms(lambda: run(None))
                print(f"{tag}shard {n} S={s}: partition {part_s!r} s "
                      f"(host), first call {first_s!r} s; Q_abs batch of "
                      f"{len(ranges[n][0])}: median {ms!r} ms sharded, "
                      f"{plain_ms[n]!r} ms unsharded torch; every answer "
                      "equals the unsharded torch path", flush=True)
        return out

    def as_answers(results):
        return {label: [SimpleNamespace(value=r.answer, refined=r.refined)
                        for r in rs] for label, rs in results.items()}

    # -- 4. main path -----------------------------------------------------
    qs = {"lat": make_queries_1d(lat, NQ, seed=SEED),
          "hki": make_queries_1d(t_h, NQ, seed=SEED),
          "hki_min": make_queries_1d(t_m, NQ, seed=SEED)}
    keys = {"lat": (lat, None), "hki": (t_h, v_h), "hki_min": (t_m, v_m)}
    aggs = {"lat": "count", "hki": "max", "hki_min": "min"}
    truth = {name: host_truth(*keys[name], *qs[name], aggs[name])
             for name in qs}
    bounds = {"lat": 100.0, "hki": 50.0, "hki_min": 50.0}

    def batch(names, queries, rel):
        return QueryBatch.of(*(QuerySpec.range(name, *queries[name], rel=rel)
                               for name in names))

    def drive(session, names, queries, tag, phase):
        """The main path of one phase: counters to 0, a Q_abs and a Q_rel
        batch through session.query, counters read."""
        reset()
        main_s, answers = {}, {}
        for label, rel in (("Q_abs", None), ("Q_rel", EPS_REL)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            answers[label] = session.query(batch(names, queries, rel))
            torch.cuda.synchronize()
            main_s[label] = time.perf_counter() - t0
        routes = execute_extremum.torch_routes
        launches = read(phase)
        print(f"{tag}main path: launches {launches}, deg>3 reroutes "
              f"{routes}, first-call seconds {main_s}", flush=True)
        check(launches["range_sum_gather"] > 0, f"{tag}K2 was not launched")
        check(launches["range_max_gather"] > 0, f"{tag}K3 was not launched")
        check(launches["locate"] > 0,
              f"{tag}K1 was not launched by the refinement")
        check(routes == 0, f"{tag}a MAX/MIN group was rerouted off the "
              "kernels")
        return answers, launches

    answers, _ = drive(session, ("lat", "hki", "hki_min"), qs, "", "static")
    shares = check_answers("", ("lat", "hki", "hki_min"), answers, truth,
                           bounds)
    # MIN runs in MAX space on negated measures, where the Lemma 5.4 test
    # cannot pass for positive measures: it refines every query by design
    check(shares["lat"] < 1.0 and shares["hki"] < 1.0,
          f"Q_rel refined every query: {shares}")

    # -- 5. quantiles -------------------------------------------------------
    fr = fractions(SEED + 50)
    fr_t = torch.as_tensor(fr, device=dev)
    qnames = ("lat", "hki_sum")
    qkeys = {"lat": (np.sort(lat), None), "hki_sum": (t_s, v_s)}

    def qbatch(names):
        return QueryBatch.of(*(QuerySpec.quantile(n, fr) for n in names))

    def drive_quantile(session, names, tag, phase):
        """The quantile path of one phase: counters to 0, one batch of
        QuerySpec.quantile through session.query, counters read."""
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        answers = session.query(qbatch(names))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        routes = execute_quantile.torch_routes
        launches = read(phase)
        print(f"{tag}quantile path {names}: launches {launches}, reroutes "
              f"off K4 {routes}, first-call seconds {secs!r}", flush=True)
        return answers, launches, routes

    qans, launches, routes = drive_quantile(session, qnames, "", "static")
    check(launches["quantile_invert"] > 0, "K4 was not launched by the "
          "quantile path")
    check(routes == 0, "a quantile group was rerouted off K4")
    for name, ans in zip(qnames, qans):
        check_quantiles("", name, ans.value, *ans.bound, *qkeys[name], fr)

    # -- 6. kernel parity on the card ---------------------------------------
    Q = NQ

    def path_args(plans, queries, aggs):
        """The argument sets the main path gives K1-K3 on these plans: K1
        the exact refinement's (and the victim path's) binary searches of
        each table's sorted keys on the raw endpoints (#(keys < lq) as
        #(keys <= nextafter(lq)) for MAX/MIN), K2 the COUNT table's clamped
        ranges, K3 each MAX/MIN table's clamped ranges.  The COUNT table
        comes first, its MAX table before its MIN table."""
        sets = {"locate": [], "range_sum_gather": [], "range_max_gather": []}
        for name, p in plans.items():
            lq, uq = (torch.as_tensor(q, device=dev) for q in queries[name])
            lqc, uqc = (torch.maximum(q, p.domain_lo) for q in (lq, uq))
            if aggs[name] == "count":
                lo = lq
                sets["range_sum_gather"].append(
                    (lqc, uqc, p.seg_lo, p.seg_hi, p.coeffs, p.seg_tree))
            else:
                lo = torch.nextafter(lq, lq.new_full((), -torch.inf))
                sets["range_max_gather"].append(
                    (lqc, uqc, p.seg_lo, p.seg_hi, p.coeffs, p.st,
                     p.seg_tree))
            sets["locate"] += [(uq, p.ref_keys, p.ref_tree),
                               (lo, p.ref_keys, p.ref_tree)]
        return sets

    def hold_k123(sets, tag):
        hold("locate", kloc.locate, k1_plain, sets["locate"], exact=True)
        hold("range_sum_gather", ksum.range_sum_gather,
             ksum.range_sum_gather_plain, sets["range_sum_gather"],
             exact=True)
        hold("range_max_gather", kmax.range_max_gather,
             kmax.range_max_gather_plain, sets["range_max_gather"],
             exact=True)
        print(f"{tag}parity K1-K3 on {len(sets['locate'])}/"
              f"{len(sets['range_sum_gather'])}/"
              f"{len(sets['range_max_gather'])} argument sets: max |kernel "
              f"- plain| = { {k: errs[k] for k in sets} }", flush=True)

    plans = {n: session.plan(n) for n in ("lat", "hki", "hki_min")}
    sets = path_args(plans, qs, aggs)
    hold_k123(sets, "")

    def k4_args(plan):
        """The arguments execute_quantile gives K4 for the fractions: the
        targets and their slack-shifted twins, the boundary array, the
        tables, the 128-padded key grid and its live keys' search tree
        (65,536 fractions need no bucket padding)."""
        M, slack = quantile_mass(plan)
        err, B, keys, nk = quantile_tables(plan)
        t = torch.clamp(fr_t, 0.0, 1.0) * M
        return ((t, t - slack, t + slack, B, plan.seg_lo, plan.seg_hi,
                 plan.coeffs, err, keys, plan.ref_tree),
                dict(h=plan.h, n=nk, delta=float(plan.delta)))

    def hold_k4(plans, tag):
        """Hold K4 to its plain version on each plan (exactly), print every
        lane that differs at all."""
        errs.setdefault("quantile_invert", 0.0)
        for name, plan in plans.items():
            args, kw = k4_args(plan)
            got = kq.quantile_invert(*args, **kw)
            want = kq.quantile_invert_plain(*args, **kw)
            torch.cuda.synchronize()
            for label, g, w in zip(("answer", "lo", "hi"), got, want):
                check(torch.equal(g, w),
                      f"{tag}K4 {label} on {name} differs from its plain "
                      "version")
                e = max_abs_err(g, w)
                errs["quantile_invert"] = max(errs["quantile_invert"], e)
                if e > 0:
                    bad = torch.nonzero(g != w).flatten()[:5].tolist()
                    print(f"{tag}K4 {label} on {name} (deg {plan.deg}): "
                          f"{int((g != w).sum())} lanes differ from the "
                          f"plain version, max |diff| {e!r}; first lanes "
                          f"{bad}: kernel {g[bad].tolist()} plain "
                          f"{w[bad].tolist()} targets "
                          f"{args[0][bad].tolist()}", flush=True)
            print(f"{tag}parity K4 on {name} (deg {plan.deg}, Hp "
                  f"{plan.seg_lo.shape[0]}, key grid {args[8].shape[0]}): "
                  f"max |kernel - plain| = {errs['quantile_invert']!r}",
                  flush=True)

    def measure_k4(plan, tag, scan=False):
        """Time K4 (or its scan mode) at one plan's execute_quantile
        shapes.  The gather mode reads the tables once and a 32-byte
        sector of the key grid a target for its snap (the grid's tree left
        out, as K1's), and compares 4 separators a level of the tree and
        the leaf; the scan mode reads every table and the whole grid, its
        counts comparison sums: a compare and an add per entry of B (three
        times) and of the key grid."""
        args, kw = k4_args(plan)
        kw = dict(kw, scan=scan)
        H, cols, nk = plan.seg_lo.shape[0], plan.coeffs.shape[1], \
            args[8].shape[0]
        tables = 6 * Q * 8 + 4 * H * 8 + H * cols * 8
        if scan:
            nbytes = tables + nk * 8
            flops = Q * quantile_flops(plan.deg, 2 * H, 2 * nk)
        else:
            nbytes = tables + min(nk * 8, Q * 32)
            flops = Q * quantile_flops(
                plan.deg, probe_rounds(H),
                4 * (len(kloc.tree_levels(kw["n"])) + 1))
        shape = (f"t_mid, t_lo, t_hi ({Q},); B, seg_lo, seg_hi, seg_err "
                 f"({H},); coeffs ({H}, {cols}); ref_keys ({nk},)"
                 f"{'' if scan else f'; tree {tuple(args[9].shape)}'} f64 "
                 f"-> 3 x ({Q},)")
        return measure(torch, tag,
                       "quantile_invert_scan" if scan else "quantile_invert",
                       lambda *a: kq.quantile_invert(*a, **kw),
                       lambda *a: kq.quantile_invert_plain(*a, **kw), args,
                       None, nbytes, flops, shape,
                       plain_calls=2 if scan else 20)

    qplans = {n: session.plan(n) for n in qnames}
    hold_k4(qplans, "")

    # -- 7. timing --------------------------------------------------------

    def measure_k123(sets, tag):
        """Time K1 on the COUNT table's search, K2 on its ranges and K3 on
        the MAX table's ranges."""
        out = {}
        k1 = sets["locate"][0]
        n, tree = k1[1].shape[0], k1[2]
        levels = len(kloc.tree_levels(n))
        # what the search needs: the queries, the answers, and of the keys
        # at most one 32-byte sector a query (all of them where that is
        # less); the search's compares, one a probe of the binary search
        out["locate"] = measure(
            torch, tag, "locate", kloc.locate, k1_plain, k1,
            lambda q, k, t: torch.searchsorted(k, q, right=True),
            Q * 8 + Q * 4 + min(n * 8, Q * 32), Q * probe_rounds(n),
            f"q ({Q},) f64, keys ({n},) f64, tree {tuple(tree.shape)} f64 "
            f"-> ({Q},) int32")
        sms, ghz = sm_clock(torch)
        rate = Q * (levels + 1) / (out["locate"]["ms"] * 1e-3) / sms / (
            ghz * 1e9)
        keys_once, _ = bound_ms(Q * 8 + n * 8 + Q * 4, Q * probe_rounds(n))
        print(f"{tag}locate: bound if every key were read once "
              f"{keys_once!r} ms; the search tree's {tree.numel() * 8} bytes "
              f"beside {n * 8} of keys; {levels + 1} sector loads a query "
              f"({levels} levels and the leaf; the binary search before the "
              f"redesign: {probe_rounds(n)} probes), {rate!r} loads a clock "
              f"an SM ({sms} SMs at {ghz} GHz)", flush=True)
        for name, fn, plain in (
                ("range_sum_gather", ksum.range_sum_gather,
                 ksum.range_sum_gather_plain),
                ("range_max_gather", kmax.range_max_gather,
                 kmax.range_max_gather_plain)):
            args = sets[name][0]
            H, cols = args[2].shape[0], args[4].shape[1]
            deg = cols - 1
            nbytes = 2 * Q * 8 + 2 * H * 8 + H * cols * 8 + Q * 8
            per_end = probe_rounds(H)
            if name == "range_sum_gather":
                # seg_lo's search tree, as K3's, stands beside the bound
                flops = Q * (2 * (per_end + 5 + 2 * deg) + 1)
                shape = (f"lq, uq ({Q},); seg_lo, seg_hi ({H},); coeffs "
                         f"({H}, {cols}); tree {tuple(args[5].shape)} f64 -> "
                         f"({Q},)")
            else:
                # seg_lo's search tree is the kernel's search structure,
                # not the function's input: its bytes stand beside the
                # bound (k3_pipe), as K1's do
                st, tree = args[5], args[6]
                nbytes += st.numel() * 8
                flops = Q * range_max_flops(per_end, deg)
                shape = (f"lq, uq ({Q},); seg_lo, seg_hi ({H},); coeffs "
                         f"({H}, {cols}); st {tuple(st.shape)}; tree "
                         f"{tuple(tree.shape)} f64 -> ({Q},)")
            out[name] = measure(torch, tag, name, fn, plain, args, None,
                                nbytes, flops, shape)
        k3_pipe(sets["range_max_gather"][0], out["range_max_gather"], tag)
        # the main path's other K3 launch: the MIN table's, a smaller plan
        mn = sets["range_max_gather"][1]
        min_ms = device_ms(torch, lambda: kmax.range_max_gather(*mn))
        print(f"{tag}timing range_max_gather on the MIN table (Hp "
              f"{mn[2].shape[0]}): kernel {min_ms!r} ms on the device",
              flush=True)
        return out

    def k3_pipe(args, m, tag):
        """K3's FP64-pipe bound beside its byte bound, at the FP64 peak's
        fused multiply-adds a second (k3_fp64_per_query)."""
        H, deg = args[2].shape[0], args[4].shape[1] - 1
        levels = len(kloc.tree_levels(H))
        per_q = k3_fp64_per_query(k3_fp64, deg, levels)
        pipe_ms = Q * per_q / (FP64_FLOPS / 2) * 1e3
        m["fp64_pipe_ms"] = pipe_ms
        print(f"{tag}range_max_gather: FP64-pipe bound {pipe_ms!r} ms "
              f"({per_q} FP64-pipe instructions a query: 2 threads x "
              f"({k3_fp64[deg]} in the SASS outside loops - {k3_fp64['k1']} "
              f"of the unrolled descent + 4 x {levels + 1} nodes)) beside the "
              f"byte bound {m['bound_ms']!r} ms (the search tree's "
              f"{args[6].numel() * 8} bytes beside {H * 8} of seg_lo, left "
              f"out of it); the kernel {m['ms']!r} ms", flush=True)

    timed = {"static": measure_k123(sets, "")}
    timed["static"]["quantile_invert"] = measure_k4(qplans["hki_sum"],
                                                    "hki_sum: ")
    measure_k4(qplans["lat"], "lat: ")
    for label, rel in (("Q_abs", None), ("Q_rel", EPS_REL)):
        query_latency(torch, session, batch(("lat", "hki", "hki_min"), qs,
                                            rel),
                      f"session.query {label}", 3 * NQ)
    profile_batch(torch, session, batch(("lat", "hki", "hki_min"), qs, None),
                  "session.query Q_abs")
    query_latency(torch, session, qbatch(qnames), "session.query quantile",
                  2 * NQ)
    profile_batch(torch, session, qbatch(qnames), "session.query quantile")

    # -- 7b. scan: the cuda_scan backend on the static plans ------------------
    def same_results(tag, triples):
        """Every field of each (name, cuda_scan result, cuda result) equal
        bit for bit (QueryResult or QuantileResult)."""
        for name, g, w in triples:
            for field, a, b in zip(g._fields, g, w):
                check(torch.equal(a, b), f"{tag}{name}: cuda_scan {field} "
                      "differs from cuda")

    def check_scan_launches(tag, launches, want):
        """The scan step's counts: ``want`` exactly, none of the gather
        kernels (K2, K3, K5, K6, K7, K8, gather-mode K4)."""
        print(f"{tag}launches {launches}", flush=True)
        check(all(launches[k] == v for k, v in want.items()),
              f"{tag}launches {launches}, expected {want}")
        check(all(launches[k] == 0 for k in GATHERS),
              f"{tag}a gather kernel ran on cuda_scan: {launches}")

    def scan_range_args(plan, lq, uq):
        """(K14 or K15 name, the arguments the path gives it)."""
        lqc, uqc = (torch.maximum(q, plan.domain_lo) for q in (lq, uq))
        if plan.agg in ("sum", "count"):
            return "range_sum", (lqc, uqc, plan.seg_lo, plan.seg_next,
                                 plan.seg_hi, plan.coeffs)
        return "range_max", (lqc, uqc, plan.seg_lo, plan.seg_next,
                             plan.seg_hi, plan.coeffs, plan.seg_agg)

    def hold_scan(sets, tag):
        """K14-K17 against their plain versions, exactly."""
        for name, args in sets.items():
            mod = kdel if name.startswith("delta") else (
                ksum if name == "range_sum" else kmax)
            hold(name, getattr(mod, name), getattr(mod, name + "_plain"),
                 args, exact=True)
        print(f"{tag}parity {'/'.join(sets)} on "
              f"{'/'.join(str(len(v)) for v in sets.values())} argument "
              f"sets: max |kernel - plain| = "
              f"{ {k: errs[k] for k in sets} }", flush=True)

    def hold_k4_scan(plans, tag):
        """K4's scan mode against its plain version and the gather mode,
        exactly, on each plan."""
        errs.setdefault("quantile_invert_scan", 0.0)
        for name, plan in plans.items():
            args, kw = k4_args(plan)
            got = kq.quantile_invert(*args, scan=True, **kw)
            want = kq.quantile_invert_plain(*args, scan=True, **kw)
            gather = kq.quantile_invert(*args, **kw)
            torch.cuda.synchronize()
            for label, g, w, a in zip(("answer", "lo", "hi"), got, want,
                                      gather):
                check(torch.equal(g, w) and torch.equal(g, a),
                      f"{tag}K4 scan {label} on {name} differs from its "
                      "plain version or the gather mode")
                errs["quantile_invert_scan"] = max(
                    errs["quantile_invert_scan"], max_abs_err(g, w))
        print(f"{tag}parity K4 scan mode on {len(plans)} plans: max |kernel "
              f"- plain| = {errs['quantile_invert_scan']!r}", flush=True)

    def measure_delta_scan(name, args, tag, plain_calls=20):
        """Time K16 (``delta_sum``) or K17 (``delta_max``) on one log.
        Each walks the slots before the log's sentinel tail, so the bound
        counts those (``live``, counted here, outside the timed window): 3
        f64 operations a (query, live slot) pair (K16: 2 compares and an
        add; K17: 2 compares and the compare of its select), the queries
        and the live slots read once.  The bound over every slot of the log
        and the pairs a clock an SM the time implies are printed beside
        it."""
        cap = args[2].shape[0]
        live = int((args[2] != big_sentinel(torch.float64)).sum())
        row = measure(torch, tag, name, getattr(kdel, name),
                      getattr(kdel, name + "_plain"), args, None,
                      3 * Q * 8 + 2 * live * 8, Q * 3 * live,
                      f"lq, uq ({Q},); keys, vals ({cap},), {live} live "
                      f"f64 -> ({Q},)", plain_calls=plain_calls)
        cap_ms, cap_by = bound_ms(3 * Q * 8 + 2 * cap * 8, Q * 3 * cap)
        sms, ghz = sm_clock(torch)
        rate = Q * live / (row["ms"] * 1e-3) / sms / (ghz * 1e9)
        print(f"{tag}{name} bound over all {cap} slots {cap_ms!r} ms "
              f"({cap_by}); over the {live} live slots {row['bound_ms']!r} "
              f"ms; {rate!r} (query, live slot) pairs a clock an SM ({sms} "
              f"SMs at {ghz} GHz)", flush=True)
        return row

    def measure_dommax2d(args, tag):
        """Time K20 (``delta_dommax2d``) on one point log.  It walks the
        slots before the log's sentinel tail, so the bound counts those
        (``live``, counted here, outside the timed window): 3 f64
        operations a (query, live slot) pair (2 compares for dominance, the
        compare of its select), the corners and the live slots read once.
        The bound over every slot and the pairs a clock an SM the time
        implies are printed beside it."""
        cap = args[2].shape[0]
        live = int((args[2] != big_sentinel(torch.float64)).sum())
        row = measure(torch, tag, "delta_dommax2d", kdel.delta_dommax2d,
                      kdel.delta_dommax2d_plain, args, None,
                      3 * Q * 8 + 3 * live * 8, Q * 3 * live,
                      f"u, v ({Q},); keys_x, keys_y, wv ({cap},), {live} "
                      f"live f64 -> ({Q},)", plain_calls=2)
        cap_ms, cap_by = bound_ms(3 * Q * 8 + 3 * cap * 8, Q * 3 * cap)
        sms, ghz = sm_clock(torch)
        rate = Q * live / (row["ms"] * 1e-3) / sms / (ghz * 1e9)
        print(f"{tag}delta_dommax2d bound over all {cap} slots {cap_ms!r} ms "
              f"({cap_by}); over the {live} live slots {row['bound_ms']!r} "
              f"ms; {rate!r} (query, live slot) pairs a clock an SM ({sms} "
              f"SMs at {ghz} GHz)", flush=True)
        return row

    def measure_corner_eval2d(args, tag):
        """Time K13 (``corner_eval2d``) on one flat leaf table.  It walks
        the leaves before the table's sentinel tail, so the bound counts
        those (``live``, counted here, outside the timed window): 4 f64
        compares a (corner, live leaf) pair and one row evaluation a
        corner, the corners, the live leaves' bounds and the rows read
        once.  The bound over every leaf and the pairs a clock an SM the
        time implies are printed beside it."""
        u, mx0, bounds, coeffs = args[0], args[2], args[6], args[7]
        L, k = mx0.shape[0], coeffs.shape[1]
        live = int((mx0 != big_sentinel(torch.float64)).sum())
        rows = L * 4 * 8 + L * k * 8
        row = measure(torch, tag, "corner_eval2d", k2d.corner_eval2d,
                      k2d.corner_eval2d_plain, args, None,
                      3 * Q * 8 + 4 * live * 8 + rows,
                      Q * (4 * live + horner2d_flops(args[-1])),
                      f"u, v ({Q},); mx0, mx1, my0, my1 ({L},), {live} "
                      f"live, bounds ({L}, 4), coeffs ({L}, {k}) f64 -> "
                      f"({Q},)")
        all_ms, all_by = bound_ms(3 * Q * 8 + 4 * L * 8 + rows,
                                  Q * (4 * L + horner2d_flops(args[-1])))
        sms, ghz = sm_clock(torch)
        rate = Q * live / (row["ms"] * 1e-3) / sms / (ghz * 1e9)
        print(f"{tag}corner_eval2d bound over all {L} leaves {all_ms!r} ms "
              f"({all_by}); over the {live} live leaves "
              f"{row['bound_ms']!r} ms; {rate!r} (corner, live leaf) pairs "
              f"a clock an SM ({sms} SMs at {ghz} GHz)", flush=True)
        return row

    def measure_rank2d(name, args, tag):
        """Time K18 (``delta_count2d``) or K19 (``delta_sum2d``) on one
        point log.  Each ranks each rectangle's x range to slots [a, b) of
        the x-sorted log by two binary searches and tests only those, so
        the bound counts the work these rectangles need (the ranks, counted
        here outside the timed window): the searches' compares, and the f64
        operations a (rectangle, [a, b) slot) pair (K19: 2 y compares and
        an add; K18: the 2 y compares, its count being an integer add); the
        rectangles, the answers and the live slots' columns (K18 reads x
        and y, K19 also w) read once.  The bound of the old form, 5
        operations a (rectangle, slot) pair, over the live slots and over
        every slot, the mean [a, b) width and the pairs a clock an SM the
        time implies are printed beside it, and for K18 the bound at K19's
        3 operations a pair."""
        lx, ux, kx = args[0], args[1], args[4]
        cols = len(args) - 4
        cap = kx.shape[0]
        big = big_sentinel(torch.float64)
        live = int((kx != big).sum())
        tail = int(torch.searchsorted(kx, torch.tensor([big], device=dev)))
        a = torch.where(torch.isnan(lx), cap,
                        torch.searchsorted(kx, lx, right=True))
        b = torch.where(torch.isnan(ux), 0, torch.clamp(
            torch.searchsorted(kx, ux, right=True), max=tail))
        width = float(torch.clamp(b - a, min=0).double().sum())
        per_pair = 2 if name == "delta_count2d" else 3
        mod = getattr(kdel, name)
        row = measure(torch, tag, name, mod, getattr(kdel, name + "_plain"),
                      args, None, 5 * Q * 8 + cols * live * 8,
                      Q * 2 * probe_rounds(cap) + per_pair * width,
                      f"lx, ux, ly, uy ({Q},); {cols} log columns ({cap},), "
                      f"{live} live, mean [a, b) {width / Q!r} slots f64 -> "
                      f"({Q},)", plain_calls=1)
        live_ms, live_by = bound_ms(5 * Q * 8 + cols * live * 8,
                                    5 * Q * live)
        cap_ms, cap_by = bound_ms(5 * Q * 8 + cols * cap * 8, 5 * Q * cap)
        three = "" if per_pair == 3 else "; at 3 {!r} ms".format(bound_ms(
            5 * Q * 8 + cols * live * 8,
            Q * 2 * probe_rounds(cap) + 3 * width)[0])
        sms, ghz = sm_clock(torch)
        per = lambda n: n / (row["ms"] * 1e-3) / sms / (ghz * 1e9)
        print(f"{tag}{name} bound of the [a, b) ranges {row['bound_ms']!r} "
              f"ms ({per_pair} operations a pair{three}); "
              f"at 5 operations a pair over the {live} live slots "
              f"{live_ms!r} ms ({live_by}), over all {cap} slots {cap_ms!r} "
              f"ms ({cap_by}); mean [a, b) width {width / Q!r} slots; "
              f"{per(Q * live)!r} (rectangle, live slot) pairs and "
              f"{per(width)!r} (rectangle, [a, b) slot) pairs a clock an SM "
              f"({sms} SMs at {ghz} GHz)", flush=True)
        return row

    def range_sum_work(args, isz):
        """K14's bytes and operations on one plan's segment table: the
        ranges and the answers, and per range 2 compares a segment start
        walked and each endpoint's row (scale_unit's 5 operations and
        Horner's 2 a degree) and the difference; over the ``live``
        segments before the table's sentinel tail (counted here) and over
        every row.  (live, H, shape, (bytes, ops) over the live segments,
        (bytes, ops) over every row, ops of the old form: 4 compares a row
        and range)."""
        seg_lo, coeffs = args[2], args[5]
        H, cols = seg_lo.shape[0], coeffs.shape[1]
        live = int((seg_lo != big_sentinel(seg_lo.dtype)).sum())
        finish = 2 * (5 + 2 * (cols - 1)) + 1
        work = lambda n: (3 * Q * isz + n * (3 + cols) * isz,
                          Q * (2 * n + finish))
        shape = (f"lq, uq ({Q},); seg_lo, seg_next, seg_hi ({H},), {live} "
                 f"live; coeffs ({H}, {cols})")
        return live, H, shape, work(live), work(H), Q * (4 * H + finish)

    def measure_range_sum(tag, args, dname="f64", peak=FP64_FLOPS):
        """Time K14 (``range_sum``) at its bound over the live segments,
        and print the bound over every row, the old form's, and K2
        (``range_sum_gather``) timed on the same ranges and table."""
        isz = 8 if peak == FP64_FLOPS else 4
        live, H, shape, (nb, fl), (nb_all, fl_all), fl_old = \
            range_sum_work(args, isz)
        row = measure(torch, tag, "range_sum", ksum.range_sum,
                      ksum.range_sum_plain, args, None, nb, fl,
                      f"{shape} {dname} -> ({Q},)", peak=peak)
        all_ms, all_by = bound_ms(nb_all, fl_all, peak)
        old_ms, old_by = bound_ms(nb_all, fl_old, peak)
        lq, uq, seg_lo, _, seg_hi, coeffs = args
        tree = kloc.search_tree(seg_lo)
        k2_ms = device_ms(torch, lambda: ksum.range_sum_gather(
            lq, uq, seg_lo, seg_hi, coeffs, tree))
        print(f"{tag}range_sum bound over the {live} live segments "
              f"{row['bound_ms']!r} ms; over all {H} rows {all_ms!r} ms "
              f"({all_by}); the old form's (4 compares a row and range) "
              f"{old_ms!r} ms ({old_by}); K2 (range_sum_gather) on the same "
              f"ranges {k2_ms!r} ms", flush=True)
        return row

    tag = "scan static: "
    step0 = time.perf_counter()
    s_qs = dict(qs, hki_sum=make_queries_1d(t_s, NQ, seed=SEED + 5))
    s_truth = dict(truth, hki_sum=host_truth(t_s, v_s, *s_qs["hki_sum"],
                                             "sum"))
    splans = {n: session.plan(n) for n in SCAN_STATIC}
    run = lambda b: {label: [execute(splans[n], s_qs[n], backend=b,
                                     eps_rel=rel) for n in SCAN_STATIC]
                     for label, rel in labels}
    runq = lambda b: [execute_quantile(qplans[n], fr_t, backend=b)
                      for n in qnames]
    want_s, want_q = run("cuda"), runq("cuda")
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    got_s, got_q = run("cuda_scan"), runq("cuda_scan")
    torch.cuda.synchronize()
    print(f"{tag}first-call seconds {time.perf_counter() - t0!r}", flush=True)
    check_scan_launches(tag, read("scan static"),
                        {"range_sum": 4, "range_max": 4,
                         "quantile_invert_scan": 2})
    for label, _ in labels:
        same_results(f"{tag}{label} ",
                     zip(SCAN_STATIC, got_s[label], want_s[label]))
    same_results(tag + "quantile ", zip(qnames, got_q, want_q))
    check_answers(tag, SCAN_STATIC, {
        label: [SimpleNamespace(value=r.answer, refined=r.refined)
                for r in got_s[label]] for label, _ in labels}, s_truth,
        dict(bounds, hki_sum=HKI_SUM_ABS))
    for name, res in zip(qnames, got_q):
        check_quantiles(tag, name, *res, *qkeys[name], fr)
    scan_sets = {"range_sum": [], "range_max": []}
    for n in SCAN_STATIC:
        lq, uq = (torch.as_tensor(q, device=dev) for q in s_qs[n])
        k, args = scan_range_args(splans[n], lq, uq)
        scan_sets[k].append(args)
    hold_scan(scan_sets, tag)
    hold_k4_scan(qplans, tag)
    timed["scan static"] = {"quantile_invert_scan": measure_k4(
        qplans["hki_sum"], "scan hki_sum: ", scan=True)}
    measure_k4(qplans["lat"], "scan lat: ", scan=True)
    print(f"{tag}step seconds {time.perf_counter() - step0!r}", flush=True)

    # -- 7c. ops: kernels.ops on lat and hki at float64 and float32 -----------
    def index_of(plan):
        """The PolyFitIndex1D a session plan was lowered from: build_plan
        pads and casts it and adds the refinement arrays, which from_index
        leaves out, so its h real rows, aggregates, sparse table and
        certified errors are the index's."""
        h = plan.h
        return PolyFitIndex1D(
            agg=plan.agg, deg=plan.deg, delta=plan.delta,
            seg_lo=plan.seg_lo[:h], seg_hi=plan.seg_hi[:h],
            coeffs=plan.coeffs[:h],
            seg_start=torch.zeros(h, dtype=torch.int32, device=dev),
            seg_agg=(plan.seg_agg[:h] if plan.agg in ("max", "min")
                     else None),
            st=plan.st, exact_sum=None, exact_max=None, n=plan.n,
            seg_err=(None if plan.seg_err is None
                     else plan.seg_err[:h].cpu().numpy()))

    tag = "ops: "
    step0 = time.perf_counter()
    ONAMES = ("lat", "hki")
    oplans = {n: session.plan(n) for n in ONAMES}
    oidx = {n: index_of(p) for n, p in oplans.items()}
    # poly_eval on 65,536 data keys a table, ranges from the main path
    okeys = {"lat": qs["lat"][1], "hki": qs["hki"][1]}
    f32_rows = {}
    for dt, phase in ((torch.float64, "ops f64"), (torch.float32, "ops f32")):
        dname = str(dt).replace("torch.", "")
        tabs = {n: kops.from_index(oidx[n], dt) for n in ONAMES}
        if dt == torch.float64:
            for n in ONAMES:
                check(all(torch.equal(getattr(tabs[n], f),
                                      getattr(oplans[n], f))
                          for f in ("seg_lo", "seg_next", "seg_hi", "coeffs",
                                    "seg_agg")),
                      f"{tag}from_index({n}) differs from the session's plan")
        ranges = {"lat": kops.range_sum, "hki": kops.range_max}
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = {n: {"poly_eval": kops.poly_eval(tabs[n], okeys[n]),
                   "cuda": ranges[n](tabs[n], *qs[n]),
                   "cuda_scan": ranges[n](tabs[n], *qs[n],
                                          backend="cuda_scan")}
               for n in ONAMES}
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read(phase)
        want = {"poly_eval": 2, "range_sum_gather": 1, "range_max_gather": 1,
                "range_sum": 1, "range_max": 1}
        print(f"{tag}{dname}: launches {launches}, first-call seconds "
              f"{secs!r}", flush=True)
        check(all(launches[k] == want.get(k, 0) for k in launches),
              f"{tag}{dname}: launches {launches}, expected {want}")
        for n in ONAMES:
            for k, v in res[n].items():
                check(v.dtype == dt and v.shape == (NQ,)
                      and bool(torch.isfinite(v).all()),
                      f"{tag}{dname} {n} {k}: bad answers")
            check(torch.equal(res[n]["cuda"], res[n]["cuda_scan"]),
                  f"{tag}{dname} {n}: cuda_scan differs from cuda")
        # the answers against the main path's numpy truth over the ranges
        # asked (float64 ends): the table's bound, plus at float32 8 x eps
        # x the CF (COUNT) or measure (MAX) scale, as tests/test_kernels.py
        # :90 holds its float32 range SUM
        eps = float(torch.finfo(dt).eps)
        for n, scale in (("lat", float(len(lat))),
                         ("hki", float(np.abs(v_h).max()))):
            truth_n = truth[n]
            slack = 8 * eps * scale if dt == torch.float32 else 0.0
            err = np.abs(res[n]["cuda"].double().cpu().numpy() - truth_n)
            check(err.max() <= bounds[n] + slack + 1e-6,
                  f"{tag}{dname} {n}: |A-R| {err.max()!r} > {bounds[n]} + "
                  f"{slack!r}")
            print(f"{tag}{dname} {n}: max |A-R| = {err.max()!r} <= "
                  f"{bounds[n]} + {slack!r}", flush=True)
        # poly_eval at data keys: the fitted CF against the rank, within
        # delta (certified) at float64; at float32 the keys and segment
        # ends round to float32 first, which no certificate covers, so the
        # error is printed only
        kq_ = torch.as_tensor(okeys["lat"], dtype=dt).double().numpy()
        rank = np.searchsorted(np.sort(lat), kq_, side="right")
        perr = np.abs(res["lat"]["poly_eval"].double().cpu().numpy()
                      - rank).max()
        if dt == torch.float64:
            check(perr <= oplans["lat"].delta + 1e-6, f"{tag}{dname} lat "
                  f"poly_eval: |P - F| {perr!r} > {oplans['lat'].delta}")
        print(f"{tag}{dname} lat poly_eval: max |P - F| = {perr!r} (delta "
              f"{oplans['lat'].delta})", flush=True)
        # each kernel against its plain version, exactly, at the path's
        # arguments (the queries clamped as the wrappers clamp them)
        args = {}
        for n in ONAMES:
            t = tabs[n]
            lqc, uqc = (torch.maximum(torch.as_tensor(q, dtype=dt,
                                                      device=dev),
                                      t.seg_lo[0]) for q in qs[n])
            kc = torch.maximum(torch.as_tensor(okeys[n], dtype=dt,
                                               device=dev), t.seg_lo[0])
            args.setdefault("poly_eval", []).append(
                (kc, t.seg_lo, t.seg_next, t.seg_hi, t.coeffs, t.seg_tree))
            if n == "lat":
                args["range_sum_gather"] = [(lqc, uqc, t.seg_lo, t.seg_hi,
                                             t.coeffs, t.seg_tree)]
                args["range_sum"] = [(lqc, uqc, t.seg_lo, t.seg_next,
                                      t.seg_hi, t.coeffs)]
            else:
                args["range_max_gather"] = [(lqc, uqc, t.seg_lo, t.seg_hi,
                                             t.coeffs, t.st, t.seg_tree)]
                args["range_max"] = [(lqc, uqc, t.seg_lo, t.seg_next,
                                      t.seg_hi, t.coeffs, t.seg_agg)]
        mods = {"poly_eval": kpe, "range_sum_gather": ksum, "range_sum": ksum,
                "range_max_gather": kmax, "range_max": kmax}
        sfx = "" if dt == torch.float64 else " float32"
        for k, a in args.items():
            hold(k + sfx, getattr(mods[k], k), getattr(mods[k], k + "_plain"),
                 a, exact=True)
        print(f"{tag}{dname} parity K21/K2/K3/K14/K15: max |kernel - plain| "
              f"= { {k: errs[k + sfx] for k in args} }", flush=True)
        if dt == torch.float64:
            # ops on 'cuda' runs the very kernels the engine's raw path does
            p = oplans["lat"]
            lqc, uqc = args["range_sum_gather"][0][:2]
            check(torch.equal(res["lat"]["cuda"],
                              raw_sum(p, lqc, uqc, backend="cuda")),
                  f"{tag}range_sum differs from the engine's raw SUM")
            lqc, uqc = args["range_max_gather"][0][:2]
            check(torch.equal(res["hki"]["cuda"],
                              raw_extremum(oplans["hki"], lqc, uqc,
                                           backend="cuda")),
                  f"{tag}range_max differs from the engine's raw MAX")
            check(torch.equal(res["lat"]["poly_eval"], eval_segments(
                args["poly_eval"][0][0], p.seg_lo, p.seg_hi, p.coeffs)),
                  f"{tag}poly_eval differs from the plan's eval_segments")
        # times at this type: K21, and at float32 K2, K3, K14 and K15 too
        isz = 8 if dt == torch.float64 else 4
        peak = FP64_FLOPS if dt == torch.float64 else FP32_FLOPS
        timed[phase] = {}
        for k in (("poly_eval",) if dt == torch.float64 else KERNELS_F32):
            a = args[k][0]
            # positions of seg_lo and coeffs among the kernel's arguments
            i_lo, i_c = {"poly_eval": (1, 4), "range_sum_gather": (2, 4),
                         "range_max_gather": (2, 4)}.get(k, (2, 5))
            H, cols = a[i_lo].shape[0], a[i_c].shape[1]
            deg = cols - 1
            table = H * cols * isz
            if k == "poly_eval":
                # keys, answers and the rows the keys touch (start, next
                # start, end and coefficients; seg_tree left out); a
                # descent's 4 compares a level and the leaf, the
                # membership test, scale_unit and Horner a key
                rows = int(torch.unique(kloc.locate_segments(a[1], a[0]))
                           .numel())
                levels = len(kloc.tree_levels(H))
                nb = 2 * Q * isz + rows * (cols + 3) * isz
                fl = Q * (4 * (levels + 1) + 1 + 5 + 2 * deg)
                every_ms, every_by = bound_ms(
                    2 * Q * isz + 3 * H * isz + table,
                    Q * (2 * H + 5 + 2 * deg), peak)
                print(f"{tag}{dname} poly_eval bound over every row (the "
                      f"old form's one-hot test a row) {every_ms!r} ms "
                      f"({every_by}); {rows} rows touched", flush=True)
                shape = (f"q ({Q},); seg_lo, seg_next, seg_hi ({H},); "
                         f"coeffs ({H}, {cols}); tree {tuple(a[5].shape)}")
            elif k == "range_sum_gather":
                nb = 3 * Q * isz + 2 * H * isz + table
                fl = Q * (2 * (probe_rounds(H) + 5 + 2 * deg) + 1)
                shape = (f"lq, uq ({Q},); seg_lo, seg_hi ({H},); coeffs "
                         f"({H}, {cols}); tree {tuple(a[5].shape)}")
            elif k == "range_max_gather":
                nb = 3 * Q * isz + 2 * H * isz + table + a[5].numel() * isz
                fl = Q * range_max_flops(probe_rounds(H), deg)
                shape = (f"lq, uq ({Q},); seg_lo, seg_hi ({H},); coeffs "
                         f"({H}, {cols}); st {tuple(a[5].shape)}; tree "
                         f"{tuple(a[6].shape)}")
            elif k == "range_max":
                nb = 3 * Q * isz + 4 * H * isz + table
                fl = Q * (7 * H + range_max_flops(0, deg))
                shape = (f"lq, uq ({Q},); seg_lo, seg_next, seg_hi, seg_agg "
                         f"({H},); coeffs ({H}, {cols})")
            if k == "range_sum":   # its bound over the live segments
                timed[phase][k] = measure_range_sum(tag, a, dname, peak)
            else:
                timed[phase][k] = measure(
                    torch, tag, k, getattr(mods[k], k),
                    getattr(mods[k], k + "_plain"), a, None, nb, fl,
                    f"{shape} {dname} -> ({Q},)", peak=peak)
            if dt == torch.float32:
                f32_rows[k] = {"launches": launches[k],
                               "max_abs_err": errs[k + sfx],
                               **{f: timed[phase][k][f]
                                  for f in ("shape", *PHASE_KEYS)}}
    print(f"{tag}step seconds {time.perf_counter() - step0!r}", flush=True)

    # -- 7d. shard: the static MAX, MIN and SUM plans at S = 2 and 8 -----------
    tag = "shard static: "
    step0 = time.perf_counter()
    SH_STATIC = ("hki", "hki_min", "hki_sum")
    sh_plans = {n: session.plan(n) for n in SH_STATIC}
    res = shard_step(tag, SH_STATIC, sh_plans, s_qs, lambda n, rel: Engine(
        backend="torch").query(sh_plans[n], *s_qs[n], eps_rel=rel),
        SHARDS_TWO)
    for sc, r in res.items():
        check_answers(f"{tag}S={sc} ", SH_STATIC, as_answers(r), s_truth,
                      dict(bounds, hki_sum=HKI_SUM_ABS))
    print(f"{tag}step seconds {time.perf_counter() - step0!r}", flush=True)

    # -- 8. dynamic tables ---------------------------------------------------
    # the static session stays alive for the serve phase (phase 14)
    rng = np.random.default_rng(SEED + 100)
    for name, n, paper in (("lat_dyn", N_TWEET_DYN, 1_000_000),
                           ("hki_dyn", N_HKI_DYN, 900_000),
                           ("hki_min_dyn", N_HKI_MIN_DYN, 900_000)):
        if n < paper:
            print(f"CUT: {name} n {paper} -> {n}")
    lat_d = tweet_latitudes(N_TWEET_DYN)
    t_d, v_d = hki_series(N_HKI_DYN)
    t_dm, v_dm = hki_series(N_HKI_MIN_DYN)
    live = {"lat_dyn": Live(lat_d, None), "hki_dyn": Live(t_d, v_d),
            "hki_min_dyn": Live(t_dm, v_dm)}
    dyn_spec = dict(dynamic=True, capacity=CAPACITY, auto_refit=False,
                    background=False)
    dsession = fit(
        {"lat_dyn": lat_d, "hki_dyn": (t_d, v_d),
         "hki_min_dyn": (t_dm, v_dm)},
        {"lat_dyn": TableSpec("count", ErrorBudget(abs=100.0), **dyn_spec),
         "hki_dyn": TableSpec("max", ErrorBudget(abs=50.0, rel=EPS_REL),
                              **dyn_spec),
         "hki_min_dyn": TableSpec("min", ErrorBudget(abs=50.0, rel=EPS_REL),
                                  **dyn_spec)}, "dynamic ")

    k4_dyn = {}

    def dyn_quantiles(tag, with_k4):
        """The dynamic quantile path on lat_dyn (plain torch for every
        backend, by design): counters to 0, one session.query, counters
        read, certificates against numpy over the live multiset.  With
        ``with_k4`` (a merged state: empty buffer) K4 also runs through
        execute_quantile on the merged 300k-key plan, is checked the same
        way, held to its plain version and timed there."""
        keys = np.sort(live["lat_dyn"].keys)
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ans = dsession.query(QuerySpec.quantile("lat_dyn", fr))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read("dynamic")
        print(f"{tag}dynamic quantile path: launches {launches} (plain torch "
              f"by design), first-call seconds {secs!r}, staleness "
              f"{ans.staleness}", flush=True)
        check_quantiles(tag, "lat_dyn", ans.value, *ans.bound, keys, None, fr)
        if not with_k4:
            return
        check(dsession._dyn("lat_dyn").n_pending == 0,
              f"{tag}lat_dyn has buffered ops")
        plan = dsession.plan("lat_dyn")
        reset()
        res = execute_quantile(plan, fr_t)
        torch.cuda.synchronize()
        launches = read("dynamic")
        check(launches["quantile_invert"] == 1,
              f"{tag}execute_quantile did not launch K4 once: {launches}")
        print(f"{tag}execute_quantile on the merged lat_dyn plan (n "
              f"{plan.n}): launches {launches}", flush=True)
        check_quantiles(tag, "lat_dyn (execute_quantile)", res.answer,
                        res.lo, res.hi, keys, None, fr)
        hold_k4({"lat_dyn": plan}, tag)
        k4_dyn["quantile_invert"] = measure_k4(plan, tag)

    def dyn_state(tag, seed, with_k4=False):
        """One state of the dynamic tables: the main path, the answers
        against the updated multisets, and every kernel the path launched
        held to its plain version at the shapes it ran: K1-K3 on this
        state's plans, K5/K6 on its buffers, all on its queries; then the
        dynamic quantile path (and K4 on a merged state)."""
        dq = {name: live[name].queries(make_queries_1d, seed + i)
              for i, name in enumerate(DYN)}
        truth = {name: host_truth(live[name].keys, live[name].meas, *dq[name],
                                  DYN_AGG[name]) for name in DYN}
        torch.cuda.reset_peak_memory_stats(dev)
        answers, launches = drive(dsession, DYN, dq, tag, "dynamic")
        check(launches["delta_sum_gather"] > 0,
              f"{tag}K5 was not launched on lat_dyn")
        check(launches["delta_max_gather"] > 0,
              f"{tag}K6 was not launched on hki_dyn")
        shares = check_answers(tag, DYN, answers, truth, DYN_BOUND)
        check(shares["lat_dyn"] < 1.0, f"{tag}Q_rel refined every query")
        stale = {name: a.staleness for name, a in zip(DYN, answers["Q_abs"])}
        print(f"{tag}staleness {stale}; peak device memory "
              f"{torch.cuda.max_memory_allocated(dev)} B", flush=True)
        dt = {name: tuple(torch.as_tensor(q, device=dev) for q in dq[name])
              for name in DYN}
        k123 = path_args({name: dsession.snapshot(name)[0] for name in DYN},
                         dq, DYN_AGG)
        hold_k123(k123, tag)
        _, buf = dsession.snapshot("lat_dyn")
        k5 = [(*dt["lat_dyn"], buf.ins_keys, buf.ins_cf),
              (*dt["lat_dyn"], buf.del_keys, buf.del_cf)]
        k6 = []
        for name in ("hki_dyn", "hki_min_dyn"):
            _, b = dsession.snapshot(name)
            k6.append((*dt[name], b.ins_keys, b.ins_st))
        hold("delta_sum_gather", kdel.delta_sum_gather,
             kdel.delta_sum_gather_plain, k5, exact=True)
        hold("delta_max_gather", kdel.delta_max_gather,
             kdel.delta_max_gather_plain, k6, exact=True)
        print(f"{tag}parity K5/K6: max |kernel - plain| = "
              f"{ {k: errs[k] for k in ('delta_sum_gather', 'delta_max_gather')} }",
              flush=True)
        dyn_quantiles(tag, with_k4)
        return dq, k123, k5, k6

    def merge(name, tag):
        """Flush one table; print its merge seconds and refit segments."""
        before = dsession.plan(name)
        old = set(zip(before.seg_lo[:before.h].tolist(),
                      before.seg_hi[:before.h].tolist()))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dsession.flush(name)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        after = dsession.plan(name)
        refit = sum((lo, hi) not in old for lo, hi in zip(
            after.seg_lo[:after.h].tolist(), after.seg_hi[:after.h].tolist()))
        print(f"{tag}merge {name}: {secs!r} s, refit_count "
              f"{dsession._dyn(name).refit_count}, h {before.h} -> "
              f"{after.h}, refit segments {refit}", flush=True)
        return refit, after.h

    # step 1: a hot band, queried while buffered, then merged
    lv = live["lat_dyn"]
    lv.hot.append((HOT_BAND[0] - 0.25, HOT_BAND[1] + 0.25))
    ins = rng.uniform(*HOT_BAND, HOT_INSERTS)
    gone = lv.pick_base(rng, HOT_DELETES, *HOT_BAND)
    dsession.insert("lat_dyn", ins)
    dsession.delete("lat_dyn", gone)
    lv.insert(ins)
    lv.delete(gone)
    for name, extreme in (("hki_dyn", np.argmax), ("hki_min_dyn", np.argmin)):
        lv = live[name]
        tb, vb = new_bars(rng, lv.keys.max(), lv.meas[np.argmax(lv.keys)],
                          HOT_BARS)
        lv.hot.append((lv.keys.max() - 200.0, np.inf))
        gone = extremal_victims(rng, lv, extreme)
        dsession.insert(name, tb, vb)
        dsession.delete(name, gone)
        lv.insert(tb, vb)
        lv.delete(gone)
    dyn_state("hot band, buffered: ", SEED + 10)
    for name in DYN:
        refit, h = merge(name, "hot band: ")
        check(0 < refit <= max(8, h // 10),
              f"the hot-band merge of {name} refit {refit} of {h} segments")
    dyn_state("hot band, merged: ", SEED + 20, with_k4=True)
    # scan: a cuda_scan engine over each table's merged index, fed the same
    # buffer-full ops below
    scan_dyn = {name: DynamicEngine(dsession._dyn(name).index,
                                    backend="cuda_scan", capacity=CAPACITY,
                                    auto_refit=False) for name in DYN}

    # step 2: a full buffer (CAPACITY pending ops a table), no merge
    lv = live["lat_dyn"]
    ins = tweet_latitudes(CAPACITY - 1024, seed=SEED + 2)
    gone = lv.pick_base(rng, 1024)
    dsession.insert("lat_dyn", ins)
    dsession.delete("lat_dyn", gone)
    scan_dyn["lat_dyn"].insert(ins)
    scan_dyn["lat_dyn"].delete(gone)
    lv.insert(ins)
    lv.delete(gone)
    for name, extreme in (("hki_dyn", np.argmax), ("hki_min_dyn", np.argmin)):
        lv = live[name]
        tb, vb = new_bars(rng, lv.keys.max(), lv.meas[np.argmax(lv.keys)],
                          CAPACITY - EXTREMAL_DELETES)
        gone = extremal_victims(rng, lv, extreme)
        dsession.insert(name, tb, vb)
        dsession.delete(name, gone)
        scan_dyn[name].insert(tb, vb)
        scan_dyn[name].delete(gone)
        lv.insert(tb, vb)
        lv.delete(gone)
    refits = {name: dsession._dyn(name).refit_count for name in DYN}
    dq, k123, k5, k6 = dyn_state("buffer full: ", SEED + 30)
    check({name: dsession._dyn(name).refit_count for name in DYN} == refits
          and all(dsession._dyn(name).n_pending == CAPACITY for name in DYN),
          "the buffer-full step merged or lost an op")
    # shard: the full-buffer states of lat_dyn (tombstones) and hki_dyn
    # (shadowed victims) at S = 2 and 8
    tag = "shard dynamic: "
    step0 = time.perf_counter()
    SH_DYN = ("lat_dyn", "hki_dyn")
    snaps_d = {n: dsession.snapshot(n) for n in SH_DYN}
    check(snaps_d["hki_dyn"][1].vic_keys is not None,
          f"{tag}hki_dyn's full buffer shadows no victim")
    res = shard_step(tag, SH_DYN, {n: snaps_d[n][0] for n in SH_DYN}, dq,
                     lambda n, rel: torch_dyn(dsession._dyn(n), dq[n], rel),
                     SHARDS_TWO, bufs={n: snaps_d[n][1] for n in SH_DYN})
    d_truth = {n: host_truth(live[n].keys, live[n].meas, *dq[n], DYN_AGG[n])
               for n in SH_DYN}
    for sc, r in res.items():
        check_answers(f"{tag}S={sc} ", SH_DYN, as_answers(r), d_truth,
                      DYN_BOUND)
    print(f"{tag}step seconds {time.perf_counter() - step0!r}", flush=True)

    # K1-K3 at the dynamic plans, K5/K6 on the full buffers
    tag = "buffer full: "
    dyn = timed["dynamic"] = measure_k123(k123, tag)
    dyn.update(k4_dyn)
    cap = CAPACITY
    rounds = probe_rounds(cap)
    st = k6[0][3]
    dyn["delta_sum_gather"] = measure(
        torch, tag, "delta_sum_gather", kdel.delta_sum_gather,
        kdel.delta_sum_gather_plain, k5[0], None,
        3 * Q * 8 + cap * 8 + (cap + 1) * 8, Q * (2 * rounds + 1),
        f"lq, uq ({Q},); keys ({cap},); cf ({cap + 1},) f64 -> ({Q},)")
    dyn["delta_max_gather"] = measure(
        torch, tag, "delta_max_gather", kdel.delta_max_gather,
        kdel.delta_max_gather_plain, k6[0], None,
        3 * Q * 8 + cap * 8 + st.numel() * 8, Q * (2 * rounds + 4),
        f"lq, uq ({Q},); keys ({cap},); st {tuple(st.shape)} f64 -> ({Q},)")
    # scan: the cuda_scan engines against the session's cuda engines
    tag = "scan dynamic: "
    step0 = time.perf_counter()
    check(all(e.n_pending == CAPACITY and e.refit_count == 0
              for e in scan_dyn.values())
          and all(e.snapshot()[1].ins_st is None for e in scan_dyn.values()),
          f"{tag}a cuda_scan engine merged, lost an op or keeps a sparse "
          "table")
    drun = lambda engines: {label: [engines[n].query(*dq[n], eps_rel=rel)
                                    for n in DYN] for label, rel in labels}
    want_d = drun({n: dsession._dyn(n) for n in DYN})
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    got_d = drun(scan_dyn)
    torch.cuda.synchronize()
    print(f"{tag}first-call seconds {time.perf_counter() - t0!r}", flush=True)
    check_scan_launches(tag, read("scan dynamic"),
                        {"range_sum": 2, "delta_sum": 4, "range_max": 4,
                         "delta_max": 4})
    for label, _ in labels:
        same_results(f"{tag}{label} ", zip(DYN, got_d[label], want_d[label]))
    print(f"{tag}every answer, approximation and refined flag equals the "
          "cuda engine's", flush=True)
    dt = {name: tuple(torch.as_tensor(q, device=dev) for q in dq[name])
          for name in DYN}
    scan_sets = {"range_sum": [], "range_max": [], "delta_sum": [],
            "delta_max": []}
    for name in DYN:
        plan, buf = scan_dyn[name].snapshot()
        k, args = scan_range_args(plan, *dt[name])
        scan_sets[k].append(args)
        if DYN_AGG[name] == "count":
            scan_sets["delta_sum"] += [(*dt[name], buf.ins_keys, buf.ins_vals),
                                  (*dt[name], buf.del_keys, buf.del_vals)]
        else:
            scan_sets["delta_max"].append(
                (*dt[name], buf.ins_keys, buf.ins_vals))
    hold_scan(scan_sets, tag)
    timed["scan dynamic"] = {
        "range_sum": measure_range_sum(tag, scan_sets["range_sum"][0])}
    plan = scan_dyn["hki_dyn"].snapshot()[0]
    H, cols = plan.seg_lo.shape[0], plan.coeffs.shape[1]
    timed["scan dynamic"]["range_max"] = measure(
        torch, tag, "range_max", kmax.range_max, kmax.range_max_plain,
        scan_sets["range_max"][0], None,
        2 * Q * 8 + 4 * H * 8 + H * cols * 8 + Q * 8,
        Q * (7 * H + range_max_flops(0, cols - 1)),
        f"lq, uq ({Q},); seg_lo, seg_next, seg_hi, seg_agg ({H},); coeffs "
        f"({H}, {cols}) f64 -> ({Q},)")
    timed["scan dynamic"]["delta_sum"] = measure_delta_scan(
        "delta_sum", scan_sets["delta_sum"][0], tag)
    timed["scan dynamic"]["delta_max"] = measure_delta_scan(
        "delta_max", scan_sets["delta_max"][0], tag)
    print(f"{tag}step seconds {time.perf_counter() - step0!r} (engines "
          "built before the buffer-full ops not counted)", flush=True)
    for label, rel in (("Q_abs", None), ("Q_rel", EPS_REL)):
        query_latency(torch, dsession, batch(DYN, dq, rel),
                      f"buffer full: session.query {label}", 3 * NQ)
        profile_batch(torch, dsession, batch(DYN, dq, rel),
                      f"buffer full: session.query {label}")
    query_latency(torch, dsession, QuerySpec.quantile("lat_dyn", fr),
                  "buffer full: session.query quantile (dynamic)", NQ)
    profile_batch(torch, dsession, QuerySpec.quantile("lat_dyn", fr),
                  "buffer full: session.query quantile (dynamic)")
    # one CAPACITY-record insert into an emptied buffer
    merge("hki_min_dyn", "buffer full: ")
    lv = live["hki_min_dyn"]
    tb, vb = new_bars(rng, lv.keys.max(), lv.meas[np.argmax(lv.keys)],
                      CAPACITY)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dsession.insert("hki_min_dyn", tb, vb)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"insert: {CAPACITY} records into hki_min_dyn in {secs!r} s, "
          f"{CAPACITY / secs!r} records/s", flush=True)

    # -- 9. window table -----------------------------------------------------
    # the dynamic session (full buffers) stays alive for phase 14
    torch.cuda.empty_cache()
    print(f"CUT: lat_win epoch rows 131072 -> {N_EPOCH}", flush=True)
    epochs = [tweet_latitudes(N_EPOCH, seed=SEED + 300 + e) for e in range(4)]
    epochs.append(tweet_latitudes(INGEST_ROWS, seed=SEED + 304))
    wsession = fit({"lat_win": epochs[0]},
                   {"lat_win": TableSpec("count", ErrorBudget(abs=100.0),
                                         window=WINDOW_RING,
                                         capacity=N_EPOCH)}, "window ")
    ingest_s, seal_s = [], []

    def ingest(rows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wsession.ingest("lat_win", rows)
        torch.cuda.synchronize()
        ingest_s.append(time.perf_counter() - t0)

    for e in (1, 2, 3):
        for c in range(N_EPOCH // INGEST_ROWS):
            ingest(epochs[e][c * INGEST_ROWS:(c + 1) * INGEST_ROWS])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wsession.advance_epoch("lat_win")
        torch.cuda.synchronize()
        seal_s.append(time.perf_counter() - t0)
    ingest(epochs[4])
    check(wsession.epoch("lat_win") == 4, "the ring is not at epoch 4")
    print(f"window: {len(ingest_s)} ingests of {INGEST_ROWS} rows: median "
          f"{statistics.median(ingest_s)!r} s, max {max(ingest_s)!r} s; "
          f"seals of {N_EPOCH} rows: {seal_s!r} s", flush=True)

    windows = (("all epochs", 0, 4), ("last sealed + open", 3, 4),
               ("one sealed", 1, 1), ("open only", 4, 4))
    wq = {}
    for i, (label, t0_, t1_) in enumerate(windows):
        tag = f"window {label} [{t0_}, {t1_}]: "
        rows_w = np.concatenate(epochs[t0_:t1_ + 1])
        lq, uq = make_queries_1d(rows_w, NQ, seed=SEED + 400 + i)
        wq[label] = (lq, uq)
        truth = {"lat_win": host_truth(rows_w, None, lq, uq, "count")}
        sealed = sum(1 for e in range(t0_, t1_ + 1) if e < 4)
        has_open = int(t1_ >= 4)
        reset()
        answers = {}
        for qlabel, rel in (("Q_abs", None), ("Q_rel", EPS_REL)):
            answers[qlabel] = [wsession.query(QuerySpec.window(
                "lat_win", lq, uq, t0_, t1_, rel=rel))]
        torch.cuda.synchronize()
        launches = read("window")
        want = {"range_sum_gather": 2 * sealed,
                "delta_sum_gather": 2 * has_open, "locate": 2 * sealed}
        print(f"{tag}{len(rows_w)} rows, {sealed} sealed epochs, open epoch "
              f"{bool(has_open)}: launches {launches}; staleness "
              f"{answers['Q_abs'][0].staleness}", flush=True)
        check(all(launches[k] == v for k, v in want.items()),
              f"{tag}launches {launches}, expected {want}")
        check_answers(tag, ("lat_win",), answers, truth,
                      {"lat_win": wsession.window_bound("lat_win", t0_, t1_)})

    # K1, K2 and K5 at the window's shapes: every sealed epoch's plan and
    # the open epoch's 65,536-slot buffer, on the all-epochs ranges
    lsm, wbuf = wsession.window_snapshot("lat_win", 0, 4)
    lq, uq = (torch.as_tensor(q, device=dev) for q in wq["all epochs"])
    wsets = {"locate": [], "range_sum_gather": []}
    for lvl in lsm.levels:
        p = lvl.plan
        wsets["range_sum_gather"].append(
            (torch.maximum(lq, p.domain_lo), torch.maximum(uq, p.domain_lo),
             p.seg_lo, p.seg_hi, p.coeffs, p.seg_tree))
        wsets["locate"] += [(uq, p.ref_keys, p.ref_tree),
                            (lq, p.ref_keys, p.ref_tree)]
    hold("locate", kloc.locate, k1_plain, wsets["locate"], exact=True)
    hold("range_sum_gather", ksum.range_sum_gather,
         ksum.range_sum_gather_plain, wsets["range_sum_gather"], exact=True)
    k5w = (lq, uq, wbuf.ins_keys, wbuf.ins_cf)
    hold("delta_sum_gather", kdel.delta_sum_gather,
         kdel.delta_sum_gather_plain, [k5w], exact=True)
    print(f"window: parity K1/K2/K5 on {len(wsets['locate'])}/"
          f"{len(wsets['range_sum_gather'])}/1 argument sets: max |kernel - "
          f"plain| = { {k: errs[k] for k in ('locate', 'range_sum_gather', 'delta_sum_gather')} }",
          flush=True)
    cap = wbuf.ins_keys.shape[0]
    timed["window"] = {"delta_sum_gather": measure(
        torch, "window: ", "delta_sum_gather", kdel.delta_sum_gather,
        kdel.delta_sum_gather_plain, k5w, None,
        3 * Q * 8 + cap * 8 + (cap + 1) * 8,
        Q * (2 * probe_rounds(cap) + 1),
        f"lq, uq ({Q},); keys ({cap},); cf ({cap + 1},) f64 -> ({Q},)")}
    spans = {label: (t0_, t1_) for label, t0_, t1_ in windows}
    for label in ("all epochs", "open only"):
        t0_, t1_ = spans[label]
        for qlabel, rel in (("Q_abs", None), ("Q_rel", EPS_REL)):
            query_latency(torch, wsession, QuerySpec.window(
                "lat_win", *wq[label], t0_, t1_, rel=rel),
                f"window {label}: session.query {qlabel}", NQ)
    profile_batch(torch, wsession, QuerySpec.window(
        "lat_win", *wq["all epochs"], 0, 4), "window all epochs: "
        "session.query Q_abs")

    # scan: the all-epochs window through execute_lsm on cuda_scan (K14 per
    # sealed epoch, K16 on the open epoch's log)
    tag = "scan window: "
    step0 = time.perf_counter()
    wrun = lambda b: {label: [execute_lsm(lsm, wbuf, wq["all epochs"],
                                          backend=b, eps_rel=rel)]
                      for label, rel in labels}
    want_w = wrun("cuda")
    torch.cuda.synchronize()
    reset()
    got_w = wrun("cuda_scan")
    torch.cuda.synchronize()
    check_scan_launches(tag, read("scan window"),
                        {"range_sum": 2 * len(lsm.levels), "delta_sum": 2})
    for label, _ in labels:
        same_results(f"{tag}{label} ",
                     zip(("lat_win",), got_w[label], want_w[label]))
    print(f"{tag}every answer equals the cuda backend's", flush=True)
    hold_scan({"range_sum": [scan_range_args(lvl.plan, lq, uq)[1]
                             for lvl in lsm.levels],
               "delta_sum": [(lq, uq, wbuf.ins_keys, wbuf.ins_vals)]}, tag)
    timed["scan window"] = {"delta_sum": measure_delta_scan("delta_sum",
        (lq, uq, wbuf.ins_keys, wbuf.ins_vals), tag, plain_calls=2)}
    print(f"{tag}step seconds {time.perf_counter() - step0!r}", flush=True)

    # one more seal evicts epoch 0: its window must raise
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wsession.advance_epoch("lat_win")
    torch.cuda.synchronize()
    print(f"window: sealed the open epoch ({INGEST_ROWS} rows) in "
          f"{time.perf_counter() - t0!r} s", flush=True)
    try:
        wsession.query(QuerySpec.window("lat_win", *wq["all epochs"], 0, 4))
    except ValueError as e:
        check("evicted" in str(e), f"window: unexpected error {e}")
        print(f"window: epoch 0 evicted as it should be: {e}", flush=True)
    else:
        fail("window: a window over the evicted epoch 0 answered")

    # -- 10. two-key tables --------------------------------------------------
    del wsession
    torch.cuda.empty_cache()
    on_dev = lambda *arrs: [torch.as_tensor(a, device=dev) for a in arrs]
    for name, n in (("osm", N_OSM), ("osm_sum", N_OSM_SUM),
                    ("osm_max", N_OSM_EXT), ("osm_min", N_OSM_EXT),
                    ("osm_deep", N_OSM_DEEP)):
        print(f"CUT: {name} n 1000000 -> {n}")
    opx, opy = osm_points(N_OSM)
    spx, spy = osm_points(N_OSM_SUM, seed=3)
    sw = osm_measure(spx, spy)
    epx, epy = osm_points(N_OSM_EXT, seed=4)
    ew = osm_measure(epx, epy)
    session2 = fit(
        {"osm": (opx, opy), "osm_sum": (spx, spy, sw),
         "osm_max": (epx, epy, ew), "osm_min": (epx, epy, ew)},
        {"osm": TableSpec("count2d", ErrorBudget(abs=200.0)),
         "osm_sum": TableSpec("sum2d", ErrorBudget(abs=1e4)),
         "osm_max": TableSpec("max2d", ErrorBudget(abs=10.0), deg=2),
         "osm_min": TableSpec("min2d", ErrorBudget(abs=10.0), deg=2)}, "2d ")
    names2 = ("osm", "osm_max", "osm_sum", "osm_min")
    rects = {"osm": make_queries_2d(opx, opy, NQ, seed=SEED),
             "osm_sum": make_queries_2d(spx, spy, NQ, seed=SEED)}
    ci = np.random.default_rng(SEED + 50).integers(0, N_OSM_EXT, NQ)
    corners = (epx[ci], epy[ci])
    certs = {name: session2.certified_delta(name) for name in names2}

    def check_2d(tag, names, answers, truth, certs):
        """Q_abs answers within 4 x (rectangles) or 1 x (corners) the
        table's certified delta of the dense truth, Q_rel answers within
        EPS_REL of it wherever it is non-zero (1e-6 absolute slack for the
        summation order of SUM truths)."""
        for label in ("Q_abs", "Q_rel"):
            for name, ans in zip(names, answers[label]):
                a, r = ans.answer, truth[name]
                check(a.shape == r.shape and bool(torch.isfinite(a).all()),
                      f"{tag}{label} {name}: bad answers")
                err = (a - r).abs()
                share = float(ans.refined.float().mean())
                if label == "Q_abs":
                    bound = certs[name] * (1 if "max" in name or "min" in
                                           name else 4)
                    e = float(err.max())
                    check(e <= bound + 1e-6, f"{tag}{label} {name}: |A-R| "
                          f"{e} > {bound}")
                    print(f"{tag}{label} {name}: max |A-R| = {e!r} <= "
                          f"{bound!r}", flush=True)
                else:
                    pos = r != 0
                    rel = float((err[pos] / r[pos].abs()).max())
                    check(bool((err[pos] <= EPS_REL * r[pos].abs()
                                + 1e-6).all()),
                          f"{tag}{label} {name}: relative error {rel} > "
                          f"{EPS_REL}")
                    print(f"{tag}{label} {name}: max rel err = {rel!r} <= "
                          f"{EPS_REL}; refined share {share!r}", flush=True)

    t0 = time.perf_counter()
    P, S, E = on_dev(opx, opy), on_dev(spx, spy, sw), on_dev(epx, epy, ew)
    C = on_dev(*corners)
    truth2 = {"osm": dense_rect(torch, *P, None, *on_dev(*rects["osm"])),
              "osm_sum": dense_rect(torch, *S, *on_dev(*rects["osm_sum"])),
              "osm_max": dense_dominance(torch, *E, *C, "max"),
              "osm_min": dense_dominance(torch, *E, *C, "min")}
    torch.cuda.synchronize()
    print(f"2d: dense truth on the card in {time.perf_counter() - t0!r} s",
          flush=True)

    def batch2d(rel):
        return QueryBatch.of(
            QuerySpec.rect("osm", *rects["osm"], rel=rel),
            QuerySpec.corner("osm_max", *corners, rel=rel),
            QuerySpec.rect("osm_sum", *rects["osm_sum"], rel=rel),
            QuerySpec.corner("osm_min", *corners, rel=rel))

    # the main path: one mixed batch under Q_abs, then under Q_rel
    reset()
    answers2, main_s = {}, {}
    for label, rel in (("Q_abs", None), ("Q_rel", EPS_REL)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        answers2[label] = session2.query(batch2d(rel))
        torch.cuda.synchronize()
        main_s[label] = time.perf_counter() - t0
    launches = read("2d")
    print(f"2d main path: launches {launches}, first-call seconds {main_s}",
          flush=True)
    check(launches["corner_count2d_gather"] > 0, "2d: K7 was not launched")
    check(launches["corner_eval2d_gather"] > 0, "2d: K8 was not launched")
    check(launches["locate"] > 0, "2d: K1 was not launched by the refinement")
    check(launches["corner_count2d"] == 0 and launches["corner_eval2d"] == 0,
          "2d: a plan with Morton codes ran the scan kernels")
    check_2d("2d ", names2, answers2, truth2, certs)
    # shard: the four static two-key plans at S = 2 and 8
    tag = "shard 2d: "
    step0 = time.perf_counter()
    q2d = {"osm": rects["osm"], "osm_max": corners,
           "osm_sum": rects["osm_sum"], "osm_min": corners}
    sh_plans = {n: session2.plan(n) for n in names2}
    res = shard_step(tag, names2, sh_plans, q2d, lambda n, rel: Engine(
        backend="torch").query(sh_plans[n], *q2d[n], eps_rel=rel),
        SHARDS_TWO)
    for sc, r in res.items():
        check_2d(f"{tag}S={sc} ", names2, r, truth2, certs)
    print(f"{tag}step seconds {time.perf_counter() - step0!r}", flush=True)

    # plans deeper than 15 levels: no Morton codes, the scan kernels
    dpx, dpy = osm_points(N_OSM_DEEP, seed=5)
    dw = osm_measure(dpx, dpy)
    deep = {}
    for name, kw in (("deep_count", dict(deg=3, delta=50.0)),
                     ("deep_min", dict(measures=dw, agg="min2d", deg=2,
                                       delta=10.0))):
        t0 = time.perf_counter()
        idx = build_index_2d(dpx, dpy, max_depth=DEEP_DEPTH, device=dev, **kw)
        plan = build_plan_2d(idx)
        check(plan.leaf_z is None, f"{name}: a depth-{DEEP_DEPTH} plan has "
              "Morton codes")
        deep[name] = (plan, idx.certified_delta)
        print(f"fit {name}: agg={plan.agg} n={plan.n} leaves="
              f"{plan.n_leaves} Lp={plan.leaf_mx0.shape[0]} max_depth="
              f"{plan.max_depth} deg={plan.deg} delta={plan.delta} "
              f"certified_delta={idx.certified_delta!r} host_build_s="
              f"{time.perf_counter() - t0:.3f}", flush=True)
    drect = make_queries_2d(dpx, dpy, NQ, seed=SEED + 60)
    dci = np.random.default_rng(SEED + 61).integers(0, N_OSM_DEEP, NQ)
    dcorn = (dpx[dci], dpy[dci])
    reset()
    deep_ans = {}
    for label, rel in (("Q_abs", None), ("Q_rel", EPS_REL)):
        deep_ans[label] = [
            execute_count2d(deep["deep_count"][0], *drect, eps_rel=rel),
            execute_extremum2d(deep["deep_min"][0], *dcorn, eps_rel=rel)]
    torch.cuda.synchronize()
    launches = read("2d deep")
    print(f"2d deep plans: launches {launches}", flush=True)
    check(launches["corner_count2d"] > 0, "2d deep: K12 was not launched")
    check(launches["corner_eval2d"] > 0, "2d deep: K13 was not launched")
    check(launches["corner_count2d_gather"] == 0
          and launches["corner_eval2d_gather"] == 0,
          "2d deep: a plan without Morton codes ran the gather kernels")
    D = on_dev(dpx, dpy, dw)
    dtruth = {"deep_count": dense_rect(torch, D[0], D[1], None,
                                       *on_dev(*drect)),
              "deep_min": dense_dominance(torch, *D, *on_dev(*dcorn), "min")}
    check_2d("2d deep ", ("deep_count", "deep_min"), deep_ans, dtruth,
             {name: c for name, (_, c) in deep.items()})

    # K7, K8, K12 and K13 against their plain versions: on osm's plan (the
    # scan kernels on its full flat table), K8 on the dominance plans, K12
    # and K13 on the deep plans, all at the shapes the paths gave them
    def clamped(plan, qs):
        x0, x1, y0, y1 = plan.root
        lim = ((x0, x1), (x0, x1), (y0, y1), (y0, y1)) if len(qs) == 4 \
            else ((x0, x1), (y0, y1))
        return [torch.clamp(q, lo, hi) for q, (lo, hi) in zip(qs, lim)]

    def tables(plan):
        return ((plan.xcuts, plan.ycuts, plan.leaf_z, plan.leaf_bounds,
                 plan.leaf_coeffs),
                (plan.leaf_mx0, plan.leaf_mx1, plan.leaf_my0, plan.leaf_my1,
                 plan.leaf_bounds, plan.leaf_coeffs))

    op = session2.plan("osm")
    gather, scan = tables(op)
    lxc, uxc, lyc, uyc = clamped(op, on_dev(*rects["osm"]))
    k7_args = (lxc, uxc, lyc, uyc, *gather, op.deg, op.max_depth)
    k8_args = (uxc, uyc, *gather, op.deg, op.max_depth)
    k12_args = (lxc, uxc, lyc, uyc, *scan, op.deg)
    k13_args = (uxc, uyc, *scan, op.deg)
    k8_sets = [k8_args]
    for name in ("osm_max", "osm_min"):
        p = session2.plan(name)
        g, _ = tables(p)
        k8_sets.append((*clamped(p, C), *g, p.deg, p.max_depth))
    k12_sets, k13_sets = [k12_args], [k13_args]
    dp = deep["deep_count"][0]
    k12_sets.append((*clamped(dp, on_dev(*drect)), *tables(dp)[1], dp.deg))
    dp = deep["deep_min"][0]
    k13_sets.append((*clamped(dp, on_dev(*dcorn)), *tables(dp)[1], dp.deg))
    hold("corner_count2d_gather", k2d.corner_count2d_gather,
         k2d.corner_count2d_gather_plain, [k7_args], exact=True)
    hold("corner_eval2d_gather", k2d.corner_eval2d_gather,
         k2d.corner_eval2d_gather_plain, k8_sets, exact=True)
    hold("corner_count2d", k2d.corner_count2d, k2d.corner_count2d_plain,
         k12_sets, exact=True)
    hold("corner_eval2d", k2d.corner_eval2d, k2d.corner_eval2d_plain,
         k13_sets, exact=True)
    # corners on every split line of osm's plan: K7 equals K12
    x0, x1, y0, y1 = op.root
    m = min(op.xcuts.shape[0], op.ycuts.shape[0])
    on_lines = clamped(op, (op.xcuts[:m], op.xcuts[:m] + 0.5,
                            op.ycuts[:m], op.ycuts[:m] + 0.5))
    a = k2d.corner_count2d_gather(*on_lines, *gather, op.deg, op.max_depth)
    b = k2d.corner_count2d(*on_lines, *scan, op.deg)
    torch.cuda.synchronize()
    check(torch.equal(a, b), "2d: K7 and K12 differ on split-line corners")
    print(f"2d: parity K7/K8/K12/K13 on 1/{len(k8_sets)}/{len(k12_sets)}/"
          f"{len(k13_sets)} argument sets: max |kernel - plain| = "
          f"{ {k: errs[k] for k in KERNELS_2D} }; K7 == K12 on {m} "
          "split-line rectangles", flush=True)

    L, nx, ny = op.leaf_z.shape[0], op.xcuts.shape[0], op.ycuts.shape[0]
    k, deg = op.leaf_coeffs.shape[1], op.deg
    table_g = nx * 8 + ny * 8 + L * 4 + L * 4 * 8 + L * k * 8
    table_s = 4 * L * 8 + L * 4 * 8 + L * k * 8
    corner_g = (probe_rounds(nx) + probe_rounds(ny) + probe_rounds(L)
                + horner2d_flops(deg))
    corner_s = 4 * L + horner2d_flops(deg)
    tab = (f"xcuts ({nx},), ycuts ({ny},), leaf_z ({L},) int32, bounds "
           f"({L}, 4), coeffs ({L}, {k})")
    stab = f"mx0, mx1, my0, my1 ({L},), bounds ({L}, 4), coeffs ({L}, {k})"
    timed["2d"] = {
        "corner_count2d_gather": measure(
            torch, "2d osm: ", "corner_count2d_gather",
            k2d.corner_count2d_gather, k2d.corner_count2d_gather_plain,
            k7_args, None, 5 * Q * 8 + table_g, Q * (4 * corner_g + 3),
            f"lx, ux, ly, uy ({Q},); {tab} f64 -> ({Q},)"),
        "corner_eval2d_gather": measure(
            torch, "2d osm: ", "corner_eval2d_gather",
            k2d.corner_eval2d_gather, k2d.corner_eval2d_gather_plain,
            k8_args, None, 3 * Q * 8 + table_g, Q * corner_g,
            f"u, v ({Q},); {tab} f64 -> ({Q},)"),
        "corner_count2d": measure(
            torch, "2d osm: ", "corner_count2d", k2d.corner_count2d,
            k2d.corner_count2d_plain, k12_args, None, 5 * Q * 8 + table_s,
            Q * (4 * corner_s + 3),
            f"lx, ux, ly, uy ({Q},); {stab} f64 -> ({Q},)"),
        "corner_eval2d": measure_corner_eval2d(k13_args, "2d osm: ")}
    # the loads behind K7's time, and the rate at which an SM served them
    # (tools/k7_k17_rates.py measures its variants)
    old, new = k7_loads(torch, k7_args)
    sms, ghz = sm_clock(torch)
    ms = timed["2d"]["corner_count2d_gather"]["ms"]
    rate = Q * new / (ms * 1e-3) / sms / (ghz * 1e9)
    print(f"2d osm: loads corner_count2d_gather: {old!r} a rectangle before "
          f"the redesign, {new!r} now; {rate!r} loads a clock an SM at "
          f"{ms!r} ms ({sms} SMs at {ghz} GHz)", flush=True)
    # the same for K8 (tools/k5_k8_rates.py measures its variants)
    old, new = k8_loads(torch, k8_args)
    ms = timed["2d"]["corner_eval2d_gather"]["ms"]
    rate = Q * new / (ms * 1e-3) / sms / (ghz * 1e9)
    print(f"2d osm: loads corner_eval2d_gather: {old!r} a corner before the "
          f"redesign, {new!r} now; {rate!r} loads a clock an SM at {ms!r} "
          f"ms", flush=True)
    for label, rel in (("Q_abs", None), ("Q_rel", EPS_REL)):
        query_latency(torch, session2, batch2d(rel),
                      f"2d: session.query {label}", 4 * NQ)
        profile_batch(torch, session2, batch2d(rel),
                      f"2d: session.query {label}")
    # scan: osm's rectangles and osm_max's corners on cuda_scan (K12 and K13
    # at every depth, never K7 or K8)
    tag = "scan 2d: "
    step0 = time.perf_counter()
    mp = session2.plan("osm_max")
    reset()
    got2 = {label: [execute_count2d(op, *rects["osm"], backend="cuda_scan",
                                    eps_rel=rel),
                    execute_extremum2d(mp, *corners, backend="cuda_scan",
                                       eps_rel=rel)]
            for label, rel in labels}
    torch.cuda.synchronize()
    check_scan_launches(tag, read("scan 2d"),
                        {"corner_count2d": 2, "corner_eval2d": 2})
    for label, _ in labels:
        for name, g, w in zip(("osm", "osm_max"), got2[label],
                              answers2[label][:2]):
            check(torch.equal(g.answer, w.value)
                  and torch.equal(g.approx, w.approx)
                  and torch.equal(g.refined, w.refined),
                  f"{tag}{label} {name}: cuda_scan differs from cuda")
    check_2d(tag, ("osm", "osm_max"), got2, truth2, certs)
    print(f"{tag}every answer equals the cuda backend's; step seconds "
          f"{time.perf_counter() - step0!r}", flush=True)
    # session2 stays alive for phase 14

    # -- 11. dynamic two-key tables ------------------------------------------
    torch.cuda.empty_cache()
    for name, n in (("osm_dyn", N_OSM_DYN), ("osm_sum_dyn", N_OSM_SUM_DYN),
                    ("osm_min_dyn", N_OSM_MIN_DYN)):
        print(f"CUT: {name} n 1000000 -> {n}")
    rng2 = np.random.default_rng(SEED + 700)
    cpx, cpy = osm_points(N_OSM_DYN, seed=6)
    spx2, spy2 = osm_points(N_OSM_SUM_DYN, seed=8)
    sw2 = osm_measure(spx2, spy2)
    mpx, mpy = osm_points(N_OSM_MIN_DYN, seed=9)
    mw = osm_measure(mpx, mpy)
    live2 = {"osm_dyn": Live2D(cpx, cpy, None),
             "osm_sum_dyn": Live2D(spx2, spy2, sw2),
             "osm_min_dyn": Live2D(mpx, mpy, mw)}
    dsession2 = fit(
        {"osm_dyn": (cpx, cpy), "osm_sum_dyn": (spx2, spy2, sw2),
         "osm_min_dyn": (mpx, mpy, mw)},
        {"osm_dyn": TableSpec("count2d", ErrorBudget(abs=200.0), **dyn_spec),
         "osm_sum_dyn": TableSpec("sum2d", ErrorBudget(abs=1e4), deg=2,
                                  **dyn_spec),
         "osm_min_dyn": TableSpec("min2d", ErrorBudget(abs=10.0), deg=2,
                                  **dyn_spec)}, "dyn2d ")

    def batch_dyn2d(q, rel):
        return QueryBatch.of(
            QuerySpec.rect("osm_dyn", *q["osm_dyn"], rel=rel),
            QuerySpec.rect("osm_sum_dyn", *q["osm_sum_dyn"], rel=rel),
            QuerySpec.corner("osm_min_dyn", *q["osm_min_dyn"], rel=rel))

    def dyn2d_state(tag, seed):
        """One state of the dynamic two-key tables: the main path (a Q_abs
        and a Q_rel batch), every answer against dense truth over the live
        multisets on the card, the launch counts, and K9-K11 (and K1, K7,
        K8) held to their plain versions at the shapes the path gave
        them."""
        q = {name: live2[name].queries(make_queries_2d, seed + i,
                                       name == "osm_min_dyn")
             for i, name in enumerate(DYN2D)}
        victims = dsession2.snapshot("osm_min_dyn")[1].vic_x is not None
        reset()
        answers, main_s = {}, {}
        for label, rel in (("Q_abs", None), ("Q_rel", EPS_REL)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            answers[label] = dsession2.query(batch_dyn2d(q, rel))
            torch.cuda.synchronize()
            main_s[label] = time.perf_counter() - t0
        launches = read("dyn2d")
        want = {"delta_count2d_gather": 4, "delta_sum2d_gather": 4,
                "delta_dommax2d_gather": 2, "corner_count2d_gather": 4,
                "corner_eval2d_gather": 2, "corner_count2d": 0,
                "corner_eval2d": 0, "locate": 4 + (2 if victims else 1)}
        print(f"{tag}main path: launches {launches}, first-call seconds "
              f"{main_s}; staleness "
              f"{ {n: a.staleness for n, a in zip(DYN2D, answers['Q_abs'])} }",
              flush=True)
        check(all(launches[k] == v for k, v in want.items()),
              f"{tag}launches {launches}, expected {want}")
        t0 = time.perf_counter()
        qd = {name: on_dev(*q[name]) for name in DYN2D}
        lv = {name: on_dev(*(a for a in (live2[name].x, live2[name].y,
                                          live2[name].w) if a is not None))
              for name in DYN2D}
        truth = {"osm_dyn": dense_rect(torch, *lv["osm_dyn"], None,
                                       *qd["osm_dyn"]),
                 "osm_sum_dyn": dense_rect(torch, *lv["osm_sum_dyn"],
                                           *qd["osm_sum_dyn"]),
                 "osm_min_dyn": dense_dominance(torch, *lv["osm_min_dyn"],
                                                *qd["osm_min_dyn"], "min")}
        torch.cuda.synchronize()
        print(f"{tag}dense truth on the card in "
              f"{time.perf_counter() - t0!r} s", flush=True)
        check_2d(tag, DYN2D, answers, truth,
                 {name: dsession2.certified_delta(name) for name in DYN2D})
        # K9-K11 (both logs, insert log) and K1, K7, K8 at the path's shapes
        sets = {k: [] for k in ("delta_count2d_gather", "delta_sum2d_gather",
                                "delta_dommax2d_gather", "locate",
                                "corner_count2d_gather",
                                "corner_eval2d_gather")}
        for name in DYN2D:
            plan, buf = dsession2.snapshot(name)
            g, _ = tables(plan)
            c = clamped(plan, qd[name])
            if name == "osm_min_dyn":
                sets["delta_dommax2d_gather"].append(
                    (*qd[name], buf.ins_x, buf.ins_ylv, buf.ins_wpmax))
                sets["corner_eval2d_gather"].append(
                    (*c, *g, plan.deg, plan.max_depth))
                sets["locate"].append((qd[name][0], plan.ref_xs,
                                       plan.ref_xs_tree))
                continue
            for p_ in ("ins_", "del_"):
                log = [getattr(buf, p_ + f) for f in ("x", "ylv", "wcum")]
                if name == "osm_dyn":
                    sets["delta_count2d_gather"].append((*qd[name], *log[:2]))
                else:
                    sets["delta_sum2d_gather"].append((*qd[name], *log))
            sets["corner_count2d_gather"].append(
                (*c, *g, plan.deg, plan.max_depth))
            sets["locate"] += [(qd[name][0], plan.ref_xs, plan.ref_xs_tree),
                               (qd[name][1], plan.ref_xs, plan.ref_xs_tree)]
        plain = {"locate": k1_plain,
                 "corner_count2d_gather": k2d.corner_count2d_gather_plain,
                 "corner_eval2d_gather": k2d.corner_eval2d_gather_plain}
        for k, args in sets.items():
            mod = kloc if k == "locate" else k2d if k in plain else kdel
            hold(k, getattr(mod, k), plain.get(k) or getattr(
                kdel, k + "_plain"), args, exact=True)
        print(f"{tag}parity K9/K10/K11/K1/K7/K8 on "
              f"{'/'.join(str(len(v)) for v in sets.values())} argument "
              f"sets: max |kernel - plain| = "
              f"{ {k: errs[k] for k in sets} }", flush=True)
        return q, sets, truth

    def update2d(name, ins, gone, twin=None):
        """Insert (xs, ys[, ws]) and delete the base points ``gone`` (an
        index array) on one table and its host mirror (and on ``twin``, an
        engine fed the same ops)."""
        lv = live2[name]
        gx, gy = lv.pick(gone)
        t0 = time.perf_counter()
        dsession2.insert(name, *ins)
        dsession2.delete(name, gx, gy)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        lv.insert(*ins)
        lv.delete(gx, gy)
        if twin is not None:
            twin.insert(*ins)
            twin.delete(gx, gy)
        print(f"dyn2d: {name} took {len(ins[0])} inserts and {len(gx)} "
              f"deletes in {secs!r} s", flush=True)

    def new_points(name, m, box=None):
        """m new points (uniform in ``box``, else OSM-like), with measures
        for the SUM and MIN tables."""
        if box is None:
            x, y = osm_points(m, seed=int(rng2.integers(100, 10_000)))
        else:
            x = rng2.uniform(box[0], box[1], m)
            y = rng2.uniform(box[2], box[3], m)
        return (x, y) if name == "osm_dyn" else (x, y, osm_measure(x, y))

    # step 1: a hot box, queried while buffered, then merged
    cx, cy = 0.5 * (HOT_BOX[0] + HOT_BOX[1]), 0.5 * (HOT_BOX[2] + HOT_BOX[3])
    for name in DYN2D:
        m = HOT2D_VICTIMS if name == "osm_min_dyn" else HOT2D_DELETES
        update2d(name, new_points(name, HOT2D_INSERTS, HOT_BOX),
                 live2[name].nearest(m, cx, cy))
    dyn2d_state("dyn2d hot box, buffered: ", SEED + 710)
    for name in DYN2D:
        dyn = dsession2._dyn(name)
        leaves = dyn.plan.n_leaves
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dsession2.flush(name)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        stats = dyn.last_refit_stats
        print(f"dyn2d hot box: merge {name}: {secs!r} s, refit_count "
              f"{dyn.refit_count}, leaves {leaves} -> {dyn.plan.n_leaves}, "
              f"stats {stats}, certified_delta "
              f"{dsession2.certified_delta(name)!r}", flush=True)
        check(not stats["rebuild"] and stats["refit"] < stats["n_leaves"],
              f"dyn2d: the hot-box merge of {name} refit {stats}")
    # a MIN measure above every other one sits below the frozen floor (in
    # MAX space): the insert merges at once
    dyn = dsession2._dyn("osm_min_dyn")
    before = dyn.refit_count
    ins = (np.array([cx]), np.array([cy]), np.array([MIN_ABOVE_MAX]))
    t0 = time.perf_counter()
    dsession2.insert("osm_min_dyn", *ins)
    torch.cuda.synchronize()
    live2["osm_min_dyn"].insert(*ins)
    print(f"dyn2d: below-floor insert into osm_min_dyn merged in "
          f"{time.perf_counter() - t0!r} s: refit_count {before} -> "
          f"{dyn.refit_count}, pending {dyn.n_pending}, stats "
          f"{dyn.last_refit_stats}", flush=True)
    check(dyn.refit_count == before + 1 and dyn.n_pending == 0,
          "dyn2d: the below-floor insert did not merge once")
    dyn2d_state("dyn2d hot box, merged: ", SEED + 720)
    # scan: a cuda_scan engine over each table's merged index, fed the same
    # buffer-full ops below
    check(all(dsession2._dyn(n).n_pending == 0 for n in DYN2D),
          "dyn2d: a merged table has buffered ops")
    scan2d = {name: DynamicEngine2D(dsession2._dyn(name).index,
                                    backend="cuda_scan", capacity=CAPACITY,
                                    auto_refit=False) for name in DYN2D}

    # step 2: a full buffer (CAPACITY pending ops a table), no merge
    for name in DYN2D:
        lv = live2[name]
        free = np.flatnonzero(~lv.used)
        update2d(name, new_points(name, CAPACITY - FULL2D_DELETES),
                 rng2.choice(free, FULL2D_DELETES, replace=False),
                 twin=scan2d[name])
    check(all(dsession2._dyn(n).n_pending == CAPACITY for n in DYN2D),
          "dyn2d: the buffer-full step merged or lost an op")
    tag = "dyn2d buffer full: "
    q2, sets, truth2d = dyn2d_state(tag, SEED + 730)
    # shard: the full-buffer states (osm_min_dyn's victims included) at
    # S = 2 and 8, the buffers read whole
    step0 = time.perf_counter()
    snaps2 = {n: dsession2.snapshot(n) for n in DYN2D}
    res = shard_step("shard dyn2d: ", DYN2D,
                     {n: snaps2[n][0] for n in DYN2D}, q2,
                     lambda n, rel: torch_dyn(dsession2._dyn(n), q2[n], rel),
                     SHARDS_TWO, bufs={n: snaps2[n][1] for n in DYN2D})
    for sc, r in res.items():
        check_2d(f"shard dyn2d: S={sc} ", DYN2D, r, truth2d,
                 {n: dsession2.certified_delta(n) for n in DYN2D})
    print(f"shard dyn2d: step seconds {time.perf_counter() - step0!r}",
          flush=True)

    # K9, K10 and K11 on the full 4,096-slot insert logs
    cap = CAPACITY
    levels = cap.bit_length()
    probes = mst_probes(cap)
    table = cap * 8 + levels * cap * 8          # the x keys and the levels
    timed["dyn2d"] = {
        "delta_count2d_gather": measure(
            torch, tag, "delta_count2d_gather", kdel.delta_count2d_gather,
            kdel.delta_count2d_gather_plain,
            sets["delta_count2d_gather"][0], None, 5 * Q * 8 + table,
            Q * (4 * probes + 3),
            f"lx, ux, ly, uy ({Q},); keys_x ({cap},); ys_levels ({levels}, "
            f"{cap}) f64 -> ({Q},)"),
        "delta_sum2d_gather": measure(
            torch, tag, "delta_sum2d_gather", kdel.delta_sum2d_gather,
            kdel.delta_sum2d_gather_plain, sets["delta_sum2d_gather"][0],
            None, 5 * Q * 8 + table + levels * cap * 8,
            Q * (4 * (probes + levels) + 3),
            f"lx, ux, ly, uy ({Q},); keys_x ({cap},); ys_levels, "
            f"wcum_levels ({levels}, {cap}) f64 -> ({Q},)"),
        "delta_dommax2d_gather": measure(
            torch, tag, "delta_dommax2d_gather", kdel.delta_dommax2d_gather,
            kdel.delta_dommax2d_gather_plain,
            sets["delta_dommax2d_gather"][0], None,
            3 * Q * 8 + table + levels * cap * 8, Q * (probes + levels),
            f"u, v ({Q},); keys_x ({cap},); ys_levels, wpmax_levels "
            f"({levels}, {cap}) f64 -> ({Q},)")}
    # the probes behind K9's, K10's and K11's times: the loads a rectangle
    # (a corner for K11), and the rate at which an SM served them
    # (tools/mst_rates.py measures the rates of scattered loads alone)
    sms, ghz = sm_clock(torch)
    for name, weighted in (("delta_count2d_gather", False),
                           ("delta_sum2d_gather", True)):
        old, new = walk_probes(torch, sets[name][0], weighted)
        ms = timed["dyn2d"][name]["ms"]
        rate = Q * new / (ms * 1e-3) / sms / (ghz * 1e9)
        print(f"{tag}probes {name}: {old!r} loads a rectangle before the "
              f"set-bits walk, {new!r} now; {rate!r} loads a clock an SM at "
              f"{ms!r} ms ({sms} SMs at {ghz} GHz)", flush=True)
    old, new = k11_loads(torch, sets["delta_dommax2d_gather"][0])
    ms = timed["dyn2d"]["delta_dommax2d_gather"]["ms"]
    rate = Q * new / (ms * 1e-3) / sms / (ghz * 1e9)
    print(f"{tag}probes delta_dommax2d_gather: {old!r} loads a corner before "
          f"the set-bits walk, {new!r} now; {rate!r} loads a clock an SM at "
          f"{ms!r} ms ({sms} SMs at {ghz} GHz)", flush=True)
    # scan: the cuda_scan engines (K18-K20 beside K12/K13) against the
    # session's cuda engines (K9-K11 beside K7/K8) on the buffer-full ops
    tag = "scan dyn2d: "
    step0 = time.perf_counter()
    check(all(e.n_pending == CAPACITY and e.refit_count == 0
              for e in scan2d.values()),
          f"{tag}a cuda_scan engine merged or lost an op")
    big = big_sentinel(torch.float64)
    check(all(bool((e.snapshot()[1].ins_ylv == big).all())
              for e in scan2d.values()),
          f"{tag}a cuda_scan buffer built merge-sort-tree levels")
    victims = scan2d["osm_min_dyn"].snapshot()[1].vic_x is not None
    d2run = lambda engines: {label: [engines[n].query(*q2[n], eps_rel=rel)
                                     for n in DYN2D] for label, rel in labels}
    want_2 = d2run({n: dsession2._dyn(n) for n in DYN2D})
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    got_2 = d2run(scan2d)
    torch.cuda.synchronize()
    print(f"{tag}first-call seconds {time.perf_counter() - t0!r}", flush=True)
    launches = read("scan dyn2d")
    want = {"delta_count2d": 4, "delta_sum2d": 4, "delta_dommax2d": 2,
            "corner_count2d": 4, "corner_eval2d": 2,
            "locate": 4 + (2 if victims else 1), "delta_count2d_gather": 0,
            "delta_sum2d_gather": 0, "delta_dommax2d_gather": 0}
    check_scan_launches(tag, launches, want)
    for label, _ in labels:
        for name, g, w in zip(DYN2D, got_2[label], want_2[label]):
            same = (torch.allclose(g.answer, w.answer, rtol=TOL, atol=TOL)
                    and torch.allclose(g.approx, w.approx, rtol=TOL,
                                       atol=TOL)
                    if name == "osm_sum_dyn" else
                    torch.equal(g.answer, w.answer)
                    and torch.equal(g.approx, w.approx))
            check(same and torch.equal(g.refined, w.refined),
                  f"{tag}{label} {name}: cuda_scan differs from cuda")
    print(f"{tag}every answer and refined flag equals the cuda engine's "
          f"(osm_sum_dyn within {TOL}: K19 adds what K10 differences)",
          flush=True)
    check_2d(tag, DYN2D, got_2, truth2d,
             {name: scan2d[name].index.certified_delta for name in DYN2D})
    qd2 = {name: on_dev(*q2[name]) for name in DYN2D}
    scan2d_sets = {k: [] for k in KERNELS_SCAN2D}
    for name in DYN2D:
        _, buf = scan2d[name].snapshot()
        if name == "osm_min_dyn":
            scan2d_sets["delta_dommax2d"].append(
                (*qd2[name], buf.ins_x, buf.ins_y, buf.ins_w))
            continue
        for p_ in ("ins_", "del_"):
            log = [getattr(buf, p_ + f) for f in ("x", "y", "w")]
            if name == "osm_dyn":
                scan2d_sets["delta_count2d"].append((*qd2[name], *log[:2]))
            else:
                scan2d_sets["delta_sum2d"].append((*qd2[name], *log))
    for k, a in scan2d_sets.items():
        hold(k, getattr(kdel, k), getattr(kdel, k + "_plain"), a, exact=True)
    print(f"{tag}parity K18/K19/K20 on "
          f"{'/'.join(str(len(v)) for v in scan2d_sets.values())} argument "
          f"sets: max |kernel - plain| = "
          f"{ {k: errs[k] for k in KERNELS_SCAN2D} }", flush=True)
    # K18, K19 and K20 on the full 4,096-slot insert logs: 2 compares and
    # an add a (query, [a, b) slot) pair beside the ranks (K18, K19), 3
    # compares a (query, live slot) pair (K20)
    timed["scan dyn2d"] = {
        "delta_count2d": measure_rank2d(
            "delta_count2d", scan2d_sets["delta_count2d"][0], tag),
        "delta_sum2d": measure_rank2d(
            "delta_sum2d", scan2d_sets["delta_sum2d"][0], tag),
        "delta_dommax2d": measure_dommax2d(scan2d_sets["delta_dommax2d"][0],
                                           tag)}
    print(f"{tag}step seconds {time.perf_counter() - step0!r} (engines "
          "built before the buffer-full ops not counted)", flush=True)
    del scan2d
    tag = "dyn2d buffer full: "
    for label, rel in (("Q_abs", None), ("Q_rel", EPS_REL)):
        query_latency(torch, dsession2, batch_dyn2d(q2, rel),
                      f"{tag}session.query {label}", 3 * NQ)
        profile_batch(torch, dsession2, batch_dyn2d(q2, rel),
                      f"{tag}session.query {label}")
    del dsession2

    # -- 12. LSM level ladders -----------------------------------------------
    torch.cuda.empty_cache()
    step0 = time.perf_counter()
    print(f"CUT: lsm_max n 900000 -> {N_LSM_MAX}", flush=True)
    rng3 = np.random.default_rng(SEED + 900)
    lk = tweet_latitudes(N_LSM)
    mt, mv = hki_series(N_LSM_MAX)
    qx, qy = osm_points(N_LSM_SUM2D)
    qw = 50.0 + 20.0 * np.sin(qx / 7.0) + 15.0 * np.cos(qy / 11.0)
    delta2 = 0.01 * float(np.abs(qw).sum())
    lsm_spec = dict(dynamic=True, lsm=True, capacity=LSM_CAPACITY,
                    background=False)
    LSM = ("lsm", "lsm_max", "lsm_sum2d")
    lsession = fit(
        {"lsm": lk, "lsm_max": (mt, mv), "lsm_sum2d": (qx, qy, qw)},
        {"lsm": TableSpec("count", ErrorBudget(abs=100.0), **lsm_spec),
         "lsm_max": TableSpec("max", ErrorBudget(abs=50.0, rel=EPS_REL),
                              **lsm_spec),
         "lsm_sum2d": TableSpec("sum2d", ErrorBudget(abs=4.0 * delta2),
                                **lsm_spec)}, "lsm ")
    engines = {name: lsession._dyn(name) for name in LSM}
    base2d = engines["lsm_sum2d"]._levels[
        max(engines["lsm_sum2d"]._levels)].index
    deepest = int(_node_depths(base2d.children.cpu().numpy())[
        base2d.leaf_nodes.cpu().numpy()].max())
    print(f"lsm_sum2d: delta {delta2!r}; TableSpec takes no max_depth (as the "
          f"reference's), so the table runs at LsmEngine2D's 12; its deepest "
          f"leaf sits at depth {deepest} (the bench's max_depth 8 "
          f"{'binds' if deepest > 8 else 'binds nothing'})", flush=True)
    llive = {"lsm": Live(lk, None), "lsm_max": Live(mt, mv)}
    llive2 = Live2D(qx, qy, qw)
    lo1, hi1 = float(lk.min()), float(lk.max())
    t0m, t1m = float(mt.min()), float(mt.max())
    x0, x1, y0, y1 = qx.min(), qx.max(), qy.min(), qy.max()

    def lsm_cols(name, m):
        if name == "lsm":
            return (rng3.uniform(lo1, hi1, m),)
        if name == "lsm_max":
            # bars at uniform times over the span, valued by the series
            # there plus one step of the HKI generator's noise
            t = rng3.uniform(t0m, t1m, m)
            return (t, np.interp(t, mt, mv) + rng3.normal(0.0, 12.0, m))
        return (rng3.uniform(x0, x1, m), rng3.uniform(y0, y1, m),
                rng3.uniform(0.0, 100.0, m))

    def timed_op(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def lsm_insert(name, cols):
        secs = timed_op(lambda: lsession.insert(name, *cols))
        if name == "lsm_sum2d":
            llive2.insert(*cols)
        else:
            llive[name].insert(*cols)
        return secs

    worst = {name: {"insert": 0.0, "append": 0.0, "compaction": 0.0}
             for name in LSM}
    compaction_s = {name: [] for name in LSM}
    for _ in range(LSM_BATCHES):
        for name in LSM:
            c0 = engines[name].compaction_count
            secs = lsm_insert(name, lsm_cols(name, LSM_BATCH))
            worst[name]["insert"] = max(worst[name]["insert"], secs)
            if engines[name].compaction_count > c0:
                worst[name]["compaction"] = max(worst[name]["compaction"],
                                                secs)
                compaction_s[name].append(secs)
            else:   # an insert that only appends to the buffer
                worst[name]["append"] = max(worst[name]["append"], secs)
    # deletes: three batches of 256 base rows (the bench's), tombstones
    for name in ("lsm", "lsm_sum2d"):
        worst[name]["delete"] = 0.0
        for i in (1, 3, 5):
            sl = slice(i * LSM_BATCH, i * LSM_BATCH + LSM_BATCH // 2)
            if name == "lsm":
                gone = (lk[sl].copy(),)
                llive["lsm"].delete(gone[0])
            else:
                gone = (qx[sl].copy(), qy[sl].copy())
                llive2.delete(*gone)
            secs = timed_op(lambda: lsession.delete(name, *gone))
            worst[name]["delete"] = max(worst[name]["delete"], secs)
    # on lsm_max the 64 largest bars of one window: victims, in 8 deletes
    # of 8 that must compact nothing
    c0 = engines["lsm_max"].compaction_count
    w0 = int(rng3.integers(0, N_LSM_MAX - WINDOW))
    top = w0 + np.argsort(mv[w0:w0 + WINDOW])[::-1][:LSM_VICTIMS]
    worst["lsm_max"]["victim delete"] = 0.0
    for j in range(0, LSM_VICTIMS, 8):
        gone = mt[top[j:j + 8]].copy()
        secs = timed_op(lambda: lsession.delete("lsm_max", gone))
        llive["lsm_max"].delete(gone)
        worst["lsm_max"]["victim delete"] = max(
            worst["lsm_max"]["victim delete"], secs)
    check(engines["lsm_max"].compaction_count == c0,
          "lsm_max: a victim delete compacted")
    # one more batch stays buffered, so every buffer correction reads a log
    # with entries
    for name in LSM:
        c0 = engines[name].compaction_count
        lsm_insert(name, lsm_cols(name, LSM_BATCH))
        check(engines[name].compaction_count == c0,
              f"{name}: the buffered batch compacted")
    for name, e in engines.items():
        check(e.n_levels >= 2 and e.compaction_count >= 1
              and e.n_pending == LSM_BATCH,
              f"{name}: {e.n_levels} levels, {e.compaction_count} "
              f"compactions, {e.n_pending} pending")
        ladder = {s_: (len(h.cols[0]), len(h.tomb) + len(h.vic))
                  for s_, h in sorted(e._levels.items())}
        print(f"lsm {name}: ladder slot -> (rows, shadowed) {ladder}, "
              f"{e.compaction_count} compactions, {e.n_pending} buffered; "
              f"worst op seconds {worst[name]}; compaction-carrying ops "
              f"{compaction_s[name]!r} s", flush=True)

    # the main path: one mixed batch under Q_abs, then under Q_rel
    lqs = {name: make_queries_1d(np.sort(llive[name].keys), NQ,
                                 seed=SEED + 910 + i)
           for i, name in enumerate(("lsm", "lsm_max"))}
    lrect = make_queries_2d(llive2.x, llive2.y, NQ, seed=SEED + 912)

    def lbatch(rel):
        return QueryBatch.of(
            QuerySpec.range("lsm", *lqs["lsm"], rel=rel),
            QuerySpec.range("lsm_max", *lqs["lsm_max"], rel=rel),
            QuerySpec.rect("lsm_sum2d", *lrect, rel=rel))

    snaps = {name: lsession.snapshot(name) for name in LSM}
    nlev = {name: len(snaps[name][0].levels) for name in LSM}
    reset()
    lans, main_s = {}, {}
    for label, rel in labels:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lans[label] = lsession.query(lbatch(rel))
        torch.cuda.synchronize()
        main_s[label] = time.perf_counter() - t0
    launches = read("lsm")
    want = {"range_sum_gather": 2 * nlev["lsm"],
            "range_max_gather": 2 * nlev["lsm_max"],
            "corner_count2d_gather": 2 * nlev["lsm_sum2d"],
            "corner_eval2d_gather": 8 * nlev["lsm_sum2d"],
            "delta_sum_gather": 2, "delta_max_gather": 2,
            "delta_sum2d_gather": 2,
            "locate": (2 * nlev["lsm"] + 4 * nlev["lsm_max"]
                       + 2 * nlev["lsm_sum2d"])}
    print(f"lsm main path: levels {nlev}, launches {launches}, first-call "
          f"seconds {main_s}", flush=True)
    check(all(launches[k] == want.get(k, 0) for k in launches),
          f"lsm: launches {launches}, expected {want}")
    ltruth = {name: host_truth(llive[name].keys, llive[name].meas,
                               *lqs[name], engines[name].agg)
              for name in ("lsm", "lsm_max")}
    lbound = {name: composed_bound(engines[name].agg, snaps[name][0].deltas)
              for name in ("lsm", "lsm_max")}
    check_answers("lsm ", ("lsm", "lsm_max"), {
        label: lans[label][:2] for label, _ in labels}, ltruth, lbound)
    rect_d = on_dev(*lrect)
    truth_s = dense_rect(torch, *on_dev(llive2.x, llive2.y, llive2.w),
                         *rect_d)
    cert = [h.index.certified_delta
            for h in engines["lsm_sum2d"]._levels.values()]
    bound_s = composed_bound("sum2d", cert)
    for label, _ in labels:
        a = lans[label][2]
        err = (a.answer - truth_s).abs()
        check(a.answer.shape == truth_s.shape
              and bool(torch.isfinite(a.answer).all()),
              f"lsm {label} lsm_sum2d: bad answers")
        if label == "Q_abs":
            check(float(err.max()) <= bound_s + 1e-6,
                  f"lsm Q_abs lsm_sum2d: |A-R| {float(err.max())} > "
                  f"{bound_s}")
            print(f"lsm Q_abs lsm_sum2d: max |A-R| = {float(err.max())!r} <= "
                  f"{bound_s!r} (composed over certified deltas {cert})",
                  flush=True)
        else:
            pos = truth_s != 0
            check(bool((err[pos] <= EPS_REL * truth_s[pos].abs()
                        + 1e-6).all()),
                  f"lsm Q_rel lsm_sum2d: relative error above {EPS_REL}")
            print(f"lsm Q_rel lsm_sum2d: max rel err = "
                  f"{float((err[pos] / truth_s[pos].abs()).max())!r} <= "
                  f"{EPS_REL}; refined share "
                  f"{float(a.refined.float().mean())!r}", flush=True)

    # shard: the three ladders and their buffers at S = 2 and 8 (Q_abs:
    # sharded ladders take no Q_rel)
    tag = "shard lsm: "
    step0 = time.perf_counter()
    lranges = dict(lqs, lsm_sum2d=lrect)
    res = shard_step(tag, LSM, {n: snaps[n][0] for n in LSM}, lranges,
                     lambda n, rel: execute_lsm(*snaps[n], lranges[n],
                                                backend="torch", eps_rel=rel),
                     SHARDS_TWO, bufs={n: snaps[n][1] for n in LSM},
                     labels_=(("Q_abs", None),))
    for sc, r in res.items():
        check_answers(f"{tag}S={sc} ", ("lsm", "lsm_max"), {
            "Q_abs": as_answers(r)["Q_abs"][:2], "Q_rel": []}, ltruth,
            lbound)
        e = float((r["Q_abs"][2].answer - truth_s).abs().max())
        check(e <= bound_s + 1e-6, f"{tag}S={sc} Q_abs lsm_sum2d: |A-R| "
              f"{e} > {bound_s}")
        print(f"{tag}S={sc} Q_abs lsm_sum2d: max |A-R| = {e!r} <= "
              f"{bound_s!r}", flush=True)
    print(f"{tag}step seconds {time.perf_counter() - step0!r}", flush=True)

    # every kernel the path launched against its plain version, exactly, at
    # the ladder's shapes: each level's plan and each table's buffer
    lsets = {k: [] for k in want}
    for name in ("lsm", "lsm_max"):
        lsm_, buf = snaps[name]
        lq, uq = (torch.as_tensor(q, device=dev) for q in lqs[name])
        for lvl in lsm_.levels:
            p = lvl.plan
            if name == "lsm":
                lsets["range_sum_gather"].append(
                    (torch.maximum(lq, p.seg_lo[0]),
                     torch.maximum(uq, p.seg_lo[0]), p.seg_lo, p.seg_hi,
                     p.coeffs, p.seg_tree))
                lsets["locate"] += [(uq, p.ref_keys, p.ref_tree),
                                    (lq, p.ref_keys, p.ref_tree)]
            else:
                lo_, hi_ = p.seg_lo[0], p.seg_hi[p.h - 1]
                lsets["range_max_gather"].append(
                    (torch.clamp(lq, lo_, hi_), torch.clamp(uq, lo_, hi_),
                     p.seg_lo, p.seg_hi, p.coeffs, p.st, p.seg_tree))
                below = torch.nextafter(lq, lq.new_full((), -torch.inf))
                lsets["locate"] += [(below, p.ref_keys, p.ref_tree),
                                    (uq, p.ref_keys, p.ref_tree)]
        if name == "lsm":
            lsets["delta_sum_gather"].append((lq, uq, buf.ins_keys,
                                              buf.ins_cf))
        else:
            lsets["delta_max_gather"].append((lq, uq, buf.ins_keys,
                                              buf.ins_st))
    lsm_, buf = snaps["lsm_sum2d"]
    for lvl in lsm_.levels:
        p = lvl.plan
        g, _ = tables(p)
        lxc, uxc, lyc, uyc = clamped(p, rect_d)
        lsets["corner_count2d_gather"].append(
            (lxc, uxc, lyc, uyc, *g, p.deg, p.max_depth))
        for u_, v_ in ((uxc, uyc), (lxc, uyc), (uxc, lyc), (lxc, lyc)):
            lsets["corner_eval2d_gather"].append(
                (u_, v_, *g, p.deg, p.max_depth))
        lsets["locate"] += [(rect_d[0], p.ref_xs, p.ref_xs_tree),
                            (rect_d[1], p.ref_xs, p.ref_xs_tree)]
    lsets["delta_sum2d_gather"].append((*rect_d, buf.ins_x, buf.ins_ylv,
                                        buf.ins_wcum))
    mods = {"locate": (kloc, k1_plain),
            "range_sum_gather": (ksum, None), "range_max_gather": (kmax, None),
            "delta_sum_gather": (kdel, None), "delta_max_gather": (kdel, None),
            "delta_sum2d_gather": (kdel, None),
            "corner_count2d_gather": (k2d, None),
            "corner_eval2d_gather": (k2d, None)}
    for k, args in lsets.items():
        mod, plain = mods[k]
        hold(k, getattr(mod, k), plain or getattr(mod, k + "_plain"), args,
             exact=True)
    print(f"lsm: parity {'/'.join(lsets)} on "
          f"{'/'.join(str(len(v)) for v in lsets.values())} argument sets: "
          f"max |kernel - plain| = { {k: errs[k] for k in lsets} }",
          flush=True)

    # scan: the lsm ladder and its buffer through execute_lsm on cuda_scan
    # (K14 a level, K16 on the buffer) equal cuda bit for bit
    lsm_, buf = snaps["lsm"]
    lrun = lambda b: {label: [execute_lsm(lsm_, buf, lqs["lsm"], backend=b,
                                          eps_rel=rel)]
                      for label, rel in labels}
    want_l = lrun("cuda")
    torch.cuda.synchronize()
    reset()
    got_l = lrun("cuda_scan")
    torch.cuda.synchronize()
    check_scan_launches("scan lsm: ", read("scan lsm"),
                        {"range_sum": 2 * nlev["lsm"], "delta_sum": 2,
                         "locate": 2 * nlev["lsm"]})
    for label, _ in labels:
        same_results(f"scan lsm: {label} ",
                     zip(("lsm",), got_l[label], want_l[label]))
        check(torch.equal(want_l[label][0].answer, lans[label][0].value),
              f"lsm: execute_lsm differs from the session's {label} answer")
    print("scan lsm: every answer, approximation and refined flag equals "
          "the cuda backend's (and the session's)", flush=True)
    for label, rel in labels:
        query_latency(torch, lsession, lbatch(rel),
                      f"lsm: session.query {label} (fused, 3 tables)", 3 * NQ)
    for name, spec in (("lsm", QuerySpec.range("lsm", *lqs["lsm"])),
                       ("lsm_max", QuerySpec.range("lsm_max",
                                                   *lqs["lsm_max"])),
                       ("lsm_sum2d", QuerySpec.rect("lsm_sum2d", *lrect))):
        query_latency(torch, lsession, spec, f"lsm: {name} session.query "
                      f"Q_abs ({nlev[name]} levels)", NQ)
    profile_batch(torch, lsession, lbatch(None), "lsm: session.query Q_abs")
    print(f"lsm: step seconds {time.perf_counter() - step0!r}", flush=True)
    # lsession stays alive for phase 14

    # -- 13. shard: the paper's 1M TWEET plan, and a sharded session ----------
    torch.cuda.empty_cache()
    tag = "shard: "
    step0 = time.perf_counter()
    plan_1m, q_1m, truth_1m = tweet_1m
    res = shard_step(tag, ("tweet",), {"tweet": plan_1m}, {"tweet": q_1m},
                     lambda n, rel: execute_sum(plan_1m, *q_1m,
                                                backend="torch",
                                                eps_rel=rel), SHARDS_ALL)
    for sc, r in res.items():
        check_answers(f"{tag}S={sc} ", ("tweet",), as_answers(r),
                      {"tweet": truth_1m}, {"tweet": 2 * PARALLEL_DELTA})
    print(f"{tag}the 1M TWEET plan (h {plan_1m.h}, n {plan_1m.n}) at S = "
          f"{SHARDS_ALL}: step seconds {time.perf_counter() - step0!r}",
          flush=True)
    del plan_1m, tweet_1m
    SH = ("shard_lat", "shard_hki")
    print(f"CUT: shard_lat n 1000000 -> {N_SHARD}", flush=True)
    print(f"CUT: shard_hki n 900000 -> {N_SHARD}", flush=True)
    sk = tweet_latitudes(N_SHARD, seed=SEED + 1300)
    sht, shv = hki_series(N_SHARD, seed=SEED + 1301)
    ssession = fit(
        {"shard_lat": sk, "shard_hki": (sht, shv)},
        {"shard_lat": TableSpec("count", ErrorBudget(abs=100.0),
                                shards=SESSION_SHARDS),
         "shard_hki": TableSpec("max", ErrorBudget(abs=50.0, rel=EPS_REL),
                                shards=SESSION_SHARDS)}, "shard ")
    check(all(ssession.is_sharded(n) for n in SH), f"{tag}a session table "
          "is not sharded")
    sq = {"shard_lat": make_queries_1d(sk, NQ, seed=SEED + 1302),
          "shard_hki": make_queries_1d(sht, NQ, seed=SEED + 1303)}
    s_aggs = {"shard_lat": "count", "shard_hki": "max"}
    s_keys = {"shard_lat": (sk, None), "shard_hki": (sht, shv)}
    reset()
    sans = {label: ssession.query(batch(SH, sq, rel))
            for label, rel in labels}
    torch.cuda.synchronize()
    no_launches(f"{tag}session: ")
    eng_t = Engine(backend="torch")
    for label, rel in labels:
        for n, a in zip(SH, sans[label]):
            w = eng_t.query(ssession.plan(n), *sq[n], eps_rel=rel)
            for field, x, y in (("answer", a.value, w.answer),
                                ("approx", a.approx, w.approx),
                                ("refined", a.refined, w.refined)):
                check(torch.equal(x, y), f"{tag}session {label} {n}: "
                      f"{field} differs from Engine(backend='torch')")
    check_answers(f"{tag}session ", SH, sans, {
        n: host_truth(*s_keys[n], *sq[n], s_aggs[n]) for n in SH},
        {"shard_lat": 100.0, "shard_hki": 50.0})
    for label, rel in labels:
        ms = median_ms(lambda: ssession.query(batch(SH, sq, rel)))
        plain = median_ms(lambda: [eng_t.query(ssession.plan(n), *sq[n],
                                               eps_rel=rel) for n in SH])
        print(f"{tag}session.query {label} (S={SESSION_SHARDS}, 2 x {NQ} "
              f"ranges, numpy in): median {ms!r} ms; unsharded torch "
              f"Engine on the same plans {plain!r} ms", flush=True)
    print(f"{tag}every sharded answer equals Engine(backend='torch') on "
          f"session.plan(name); phase seconds "
          f"{time.perf_counter() - step0!r}", flush=True)
    print(nvidia_smi(), flush=True)
    del ssession

    # -- 14. serve: ServingEngine over the sessions the phases hold ----------
    from repro_torch.dist import (FailureInjector, RetryPolicy,
                                  SimulatedPodFailure)
    from repro_torch.serve import AggregateService, ServingEngine
    torch.cuda.empty_cache()
    tag = "serve: "
    step0 = time.perf_counter()
    print(nvidia_smi(), flush=True)
    # one engine a session: the static, dynamic (full buffers, victims in
    # hki_dyn), 2d and lsm sessions of phases 3, 8, 10 and 12
    sessions = {"static": session, "dynamic": dsession, "2d": session2,
                "lsm": lsession}
    engines_s = {k: ServingEngine(s, workers=2, max_queue=8192)
                 for k, s in sessions.items()}
    # the request sources: (session key, table, kind, range columns, the
    # truth of every lane, the Q_abs bound); quantile sources carry the
    # fractions and their sorted keys / weights instead
    q_sum = make_queries_1d(t_s, NQ, seed=SEED + 1400)
    srcs = {n: ("static", "range", qs[n], host_truth(*data, *qs[n], agg),
                bounds[n])
            for n, data, agg in (("lat", (lat, None), "count"),
                                 ("hki", (t_h, v_h), "max"),
                                 ("hki_min", (t_m, v_m), "min"))}
    srcs["hki_sum"] = ("static", "range", q_sum,
                       host_truth(t_s, v_s, *q_sum, "sum"),
                       session.budget("hki_sum").bound("sum"))
    for i, n in enumerate(DYN):
        dqn = live[n].queries(make_queries_1d, SEED + 1410 + i)
        srcs[n] = ("dynamic", "range", dqn,
                   host_truth(live[n].keys, live[n].meas, *dqn, DYN_AGG[n]),
                   DYN_BOUND[n])
    for n in names2:
        cols = rects[n] if n in rects else corners
        srcs[n] = ("2d", "range", cols, truth2[n].cpu().numpy(),
                   (4.0 if n in rects else 1.0) * certs[n])
    for n in ("lsm", "lsm_max"):
        srcs[n] = ("lsm", "range", lqs[n], ltruth[n], lbound[n])
    srcs["lsm_sum2d"] = ("lsm", "range", lrect, truth_s.cpu().numpy(),
                         bound_s)
    fr_s = fractions(SEED + 1420)
    qsrc = {"lat": ("static", (np.sort(lat), None)),
            "hki_sum": ("static", (t_s, v_s)),
            "lat_dyn": ("dynamic", (np.sort(live["lat_dyn"].keys), None))}

    # warm-up: the bucket ladder up to SERVE_MAX_BUCKET, ranges and
    # quantiles, at each table's default guarantee
    reset()
    mem0 = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    caps = {k: e.warmup(max_bucket=SERVE_MAX_BUCKET,
                        kinds=("range", "quantile"))
            for k, e in engines_s.items()}
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    pools = {k: e.pool_bytes() for k, e in engines_s.items()}
    print(f"{tag}warm-up to bucket {SERVE_MAX_BUCKET} (ranges and "
          f"quantiles): captures {caps} in {warm_s!r} s; graph pool bytes "
          f"{pools}; device bytes allocated since (slots and pools) "
          f"{torch.cuda.memory_allocated(dev) - mem0}", flush=True)
    check(all(caps.values()), f"{tag}a warm-up captured nothing: {caps}")

    # SERVE_REQUESTS mixed requests of 1-64 lanes from SERVE_CLIENTS client
    # threads, each request a slice of its source's pool, under Q_abs and
    # Q_rel (quantiles: their certificate)
    rng = np.random.default_rng(SEED + 1430)
    names_s = list(srcs) + [f"{n}:quantile" for n in qsrc]
    reqs = []
    for i in range(SERVE_REQUESTS):
        src = names_s[int(rng.integers(len(names_s)))]
        m = int(rng.integers(1, 65))
        off = int(rng.integers(0, NQ - m))
        lanes = slice(off, off + m)
        if src.endswith(":quantile"):
            n = src.split(":")[0]
            spec = QuerySpec.quantile(n, fr_s[lanes])
            reqs.append((qsrc[n][0], n, "quantile", None, lanes, spec))
        else:
            rel = None if rng.uniform() < 0.5 else EPS_REL
            spec = QuerySpec(src, tuple(c[lanes] for c in srcs[src][2]), rel)
            reqs.append((srcs[src][0], src, "range", rel, lanes, spec))
    futures = [None] * len(reqs)

    def client(c):
        for i in range(c, len(reqs), SERVE_CLIENTS):
            futures[i] = engines_s[reqs[i][0]].submit(reqs[i][5])

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    got = [f.result(timeout=600) for f in futures]
    run_s = time.perf_counter() - t0
    launches = read("serve")
    stats = {k: e.stats for k, e in engines_s.items()}
    print(f"{tag}{len(reqs)} requests ({sum(len(r[5]) for r in reqs)} lanes) "
          f"from {SERVE_CLIENTS} client threads in {run_s!r} s; launches "
          f"through the wrappers (eager warm-ups and captures; replays "
          f"launch the captured kernels uncounted) {launches}; engine "
          f"stats {{k: (dispatches, coalesced, captures, hits)}} "
          f"{ {k: (s.dispatches, s.coalesced, s.aot_compiles, s.aot_hits) for k, s in stats.items()} }",
          flush=True)
    for k in ("locate", "range_sum_gather", "range_max_gather",
              "quantile_invert", "delta_sum_gather", "delta_max_gather",
              "corner_count2d_gather", "corner_eval2d_gather",
              "delta_sum2d_gather"):
        check(launches[k] > 0, f"{tag}{k} was not captured on the path")
    # every answer, approximation and refined flag equals the serial
    # session.query on the same specs (one batch a session)
    for key, sess in sessions.items():
        idx = [i for i, r in enumerate(reqs) if r[0] == key]
        want = sess.query(QueryBatch.of(*(reqs[i][5] for i in idx)))
        for i, w in zip(idx, want):
            for field in ("value", "approx", "refined"):
                check(torch.equal(getattr(got[i], field), getattr(w, field)),
                      f"{tag}request {i} ({reqs[i][1]}): the served {field} "
                      f"differs from session.query")
            if isinstance(w.bound, tuple):
                check(all(torch.equal(a, b)
                          for a, b in zip(got[i].bound, w.bound)),
                      f"{tag}request {i}: the quantile certificate differs")
    # every answer within its bound against the phase's truth
    for src, (_, _, _, tr, bound) in srcs.items():
        for label, rel in labels:
            sel = [i for i, r in enumerate(reqs)
                   if r[1] == src and r[2] == "range" and r[3] == rel]
            if not sel:
                continue
            a = torch.cat([got[i].value for i in sel]).cpu().numpy()
            r = np.concatenate([tr[reqs[i][4]] for i in sel])
            check(np.all(np.isfinite(a)), f"{tag}{src} {label}: bad answers")
            err = np.abs(a - r)
            ok = (err <= bound + 1e-6) if rel is None else (
                err <= EPS_REL * np.abs(r) + 1e-6)
            check(bool(np.all(ok)), f"{tag}{src} {label}: an answer misses "
                  f"its bound ({int(np.sum(~ok))} lanes)")
    for n, (_, (keys_q, w_q)) in qsrc.items():
        sel = [i for i, r in enumerate(reqs)
               if r[1] == n and r[2] == "quantile"]
        a, lo, hi = (torch.cat([v(got[i]) for i in sel])
                     for v in (lambda g: g.value, lambda g: g.bound[0],
                               lambda g: g.bound[1]))
        check_quantiles(tag, n, a, lo, hi, keys_q, w_q,
                        np.concatenate([fr_s[reqs[i][4]] for i in sel]))
    print(f"{tag}every served answer, approximation and refined flag equals "
          f"session.query bit for bit, every answer holds its bound; "
          f"{len(reqs)} futures resolved", flush=True)

    # a plan swap: inserts through the engine, then a flush, on the lsm
    # ladder (a compaction: cheap, where a merge of lat_dyn's full buffer
    # refits most of its 300k keys; the card tests swap flat dynamic
    # tables); the compaction thread stages the warmed buckets' level
    # graphs, so the next dispatches promote
    leng, lv = engines_s["lsm"], llive["lsm"]

    def swap_specs(seed):
        """A Q_abs and a Q_rel batch of the top bucket on the ladder's live
        keys, and the ranges' truth."""
        lq_, uq_ = make_queries_1d(np.sort(lv.keys), SERVE_MAX_BUCKET,
                                   seed=seed)
        return ([QuerySpec.range("lsm", lq_, uq_, rel=rel)
                 for _, rel in labels],
                host_truth(lv.keys, None, lq_, uq_, "count"))

    # the batch once before the swap, so that every bucket it reaches is
    # cached: after the swap each must be hit or promoted, none captured
    leng.query(swap_specs(SEED + 1439)[0], timeout=600)
    new_k = make_queries_1d(lv.keys, SERVE_SWAP_INSERTS,
                            seed=SEED + 1440)[0]
    c0, p0 = leng.stats.aot_compiles, leng.stats.aot_promotions
    k0 = engines["lsm"].compaction_count
    t0 = time.perf_counter()
    leng.insert("lsm", new_k, wait=True)
    lv.insert(new_k)
    leng.flush("lsm")
    swap_s = time.perf_counter() - t0
    specs, dtr = swap_specs(SEED + 1441)
    after = leng.query(specs, timeout=600)
    st = leng.stats
    check(engines["lsm"].compaction_count > k0,
          f"{tag}the inserts and the flush compacted nothing")
    check(not leng.stage_errors, f"{tag}staging failed: {leng.stage_errors}")
    check(st.aot_compiles == c0 and st.aot_promotions > p0,
          f"{tag}after the swap: captures {c0} -> {st.aot_compiles}, "
          f"promotions {p0} -> {st.aot_promotions}")
    for g, w in zip(after, lsession.query(specs)):
        for field in ("value", "approx", "refined"):
            check(torch.equal(getattr(g, field), getattr(w, field)),
                  f"{tag}after the swap the served {field} differs")
    sbound = composed_bound("count", lsession.snapshot("lsm")[0].deltas)
    for g, (_, rel) in zip(after, labels):
        err = np.abs(g.value.cpu().numpy() - dtr)
        check(bool(np.all(err <= (sbound + 1e-6 if rel is None else
                                  EPS_REL * dtr + 1e-6))),
              f"{tag}after the swap an answer misses its bound")
    print(f"{tag}plan swap on the lsm ladder ({SERVE_SWAP_INSERTS} inserts "
          f"through engine.insert(wait=True), then a flush; compactions "
          f"{k0} -> {engines['lsm'].compaction_count}): {swap_s!r} s; "
          f"precompiles {st.aot_precompiles}, promotions {p0} -> "
          f"{st.aot_promotions}, captures unchanged at {st.aot_compiles}; "
          f"answers equal session.query and hold their bounds", flush=True)

    # replay latency per bucket beside session.query's on the same batch,
    # and the idle share of one traced replay
    lat_cases = (("static", "hki", EPS_REL, "range"),
                 ("dynamic", "lat_dyn", None, "quantile"),
                 ("2d", "osm", EPS_REL, "range"),
                 ("lsm", "lsm_sum2d", None, "range"))
    for key, n, rel, qkind in lat_cases:
        eng, sess = engines_s[key], sessions[key]
        for b in SERVE_BUCKETS:
            spec = (QuerySpec.quantile(n, fr_s[:b]) if qkind == "quantile"
                    else QuerySpec(n, tuple(c[:b] for c in srcs[n][2]), rel))
            eng.query(spec, timeout=600)
            e_ms = median_ms(lambda: eng.query(spec, timeout=600))
            s_ms = median_ms(lambda: sess.query(spec))
            print(f"{tag}{n} {qkind} {'Q_abs' if rel is None else 'Q_rel'} "
                  f"bucket {b}: engine.query (queue, graph replay, sync) "
                  f"median {e_ms!r} ms; session.query {s_ms!r} ms", flush=True)
        spec = (QuerySpec.quantile(n, fr_s[:SERVE_MAX_BUCKET])
                if qkind == "quantile" else
                QuerySpec(n, tuple(c[:SERVE_MAX_BUCKET]
                                   for c in srcs[n][2]), rel))
        profile_batch(torch, SimpleNamespace(query=lambda s: eng.query(
            s, timeout=600)), spec, f"{tag}{n} {qkind} engine.query (one "
            f"graph replay a level) at bucket {SERVE_MAX_BUCKET}")
        profile_batch(torch, sess, spec, f"{tag}{n} {qkind} session.query "
                      f"at bucket {SERVE_MAX_BUCKET}")
    print(nvidia_smi(), flush=True)

    # chaos: the three failure sites armed on an engine over the lsm
    # session (reads of lsm_max and lsm_sum2d, staged inserts into lsm,
    # whose rows are counted across its ladder: a compaction may fold
    # them); every future resolves, none is lost, the journal replays
    inj = (FailureInjector(seed=SEED).arm("serve.worker", nth=4)
           .arm("serve.dispatch", nth=5).arm("serve.updater", nth=2))
    ceng = ServingEngine(lsession, workers=2, injector=inj,
                         retry=RetryPolicy(max_attempts=3, base=0.001,
                                           cap=0.01, seed=SEED,
                                           retry_on=(SimulatedPodFailure,)))
    rows0 = engines["lsm"].n
    crng = np.random.default_rng(SEED + 1450)
    creqs = [r for r in reqs if r[1] in ("lsm_max", "lsm_sum2d")][:400]
    cfut = []
    for j, r in enumerate(creqs):
        # paced, so that the workers form many small batches and each
        # staged insert is a pack of its own
        time.sleep(0.004)
        cfut.append(ceng.submit(r[5]))
        if j % 64 == 0:
            ceng.insert("lsm", crng.uniform(30.0, 50.0, SERVE_CHAOS_ROWS),
                        wait=False)
    ceng.drain_updates()
    served = failed = 0
    for f, r in zip(cfut, creqs):
        exc = f.exception(timeout=600)
        if exc is None:
            served += 1
            w = lsession.query(r[5])
            check(torch.equal(f.result().value, w.value),
                  f"{tag}chaos: a served answer differs from session.query")
        else:
            check(isinstance(exc, SimulatedPodFailure),
                  f"{tag}chaos: unexpected failure {exc!r}")
            failed += 1
    cst = ceng.stats
    n_ins = SERVE_CHAOS_ROWS * len(range(0, len(creqs), 64))
    check(served + failed == len(creqs) and served > 0,
          f"{tag}chaos: {served} served + {failed} failed of {len(creqs)}")
    check(cst.worker_crashes >= 1 and cst.updater_crashes >= 1
          and cst.journal_replayed >= 1 and cst.restarts >= 2,
          f"{tag}chaos: {cst}")
    check(engines["lsm"].n == rows0 + n_ins
          and ceng.staleness("lsm") == 0,
          f"{tag}chaos: {n_ins} staged rows did not land exactly once")
    print(f"{tag}chaos (serve.worker every 4th, serve.dispatch every 5th, "
          f"retried, serve.updater every 2nd): {served} served, {failed} "
          f"failed with the injected error, none lost; worker crashes "
          f"{cst.worker_crashes}, updater crashes {cst.updater_crashes}, "
          f"restarts {cst.restarts}, journal items replayed "
          f"{cst.journal_replayed}, retries {ceng.health()['retry']}; the "
          f"{n_ins} staged rows landed exactly once", flush=True)
    ceng.shutdown()
    for e in engines_s.values():
        e.shutdown()
    del ceng, engines_s, leng, eng

    # AggregateService: the paper's deployment at a cut size
    print(f"CUT: AggregateService n1 150000 -> {N_AGG_1D}, n2 60000 -> "
          f"{N_AGG_2D}", flush=True)
    t0 = time.perf_counter()
    svc = AggregateService(n1=N_AGG_1D, n2=N_AGG_2D, device=dev,
                           dynamic=True, capacity=1024, workers=2)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    svc.warmup(batch_size=1024)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    arng = np.random.default_rng(SEED + 1460)
    for akind in svc.KINDS_1D + svc.KINDS_2D:
        # corners range over the points' box; the service's own domain
        # of a dominance kind is its upper corner
        dom = svc.domains["count2d" if akind in ("max2d", "min2d")
                          else akind]
        if akind in ("max2d", "min2d"):
            cols = tuple(arng.uniform(dom[2 * i], dom[2 * i + 1], 512)
                         for i in range(2))
        else:
            cols = ()
            for i in range(len(dom) // 2):
                c = np.sort(arng.uniform(dom[2 * i], dom[2 * i + 1],
                                         (2, 512)), axis=0)
                cols += (c[0], c[1])
        res = svc.serve(akind, *cols)
        w = svc.session.query(QuerySpec(akind, cols))
        check(torch.equal(res.value, w.value)
              and torch.equal(res.refined, w.refined),
              f"{tag}AggregateService {akind}: served != session.query")
    svc.insert("count", arng.uniform(*svc.domains["count"], 256))
    svc.flush("count")
    res = svc.serve("count", np.array([svc.domains["count"][0] - 1.0]),
                    np.array([svc.domains["count"][1]]))
    check(abs(float(res.value[0]) - (N_AGG_1D + 256)) <= 100.0,
          f"{tag}AggregateService: the whole-domain count after 256 "
          f"inserts is {float(res.value[0])}")
    ast_ = svc.stats
    print(f"{tag}AggregateService (dynamic, 8 tables): fit {fit_s!r} s, "
          f"warm-up to 1024 {warm_s!r} s ({ast_.aot_compiles} captures); "
          f"every kind served equals session.query; 256 inserts and a "
          f"flush ({ast_.aot_promotions} promotions); phase seconds "
          f"{time.perf_counter() - step0!r}", flush=True)
    svc.shutdown()
    print(nvidia_smi(), flush=True)
    del svc, sessions, session, dsession, session2, lsession, engines

    rows = []
    for c in counters:
        name = c.__name__
        phases = {}
        for ph, launched in phase_launches.items():
            m = timed.get(ph, {}).get(name)
            if launched[name] or m is not None:
                phases[ph] = (launched[name], m)
        rows.append(kernel_row(name, phases, errs[name]))
        if name in KERNELS_F32:
            rows[-1]["by_dtype"] = {"float32": f32_rows[name]}
    print(f"wall: {time.perf_counter() - wall0:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
