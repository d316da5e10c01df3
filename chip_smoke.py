#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port of PolyFit (src/repro_torch) once on one
NVIDIA card, and hold its kernels to their plain PyTorch versions.

    python3 chip_smoke.py             # the paper's sizes, about 10 minutes

Phases, each of which fails the run with a non-zero exit:

1. device  - a CUDA card must be present; print its name and power limit;
2. build   - compile the CUDA kernels from src/repro_torch/csrc with nvcc;
3. fit     - PolyFit.fit on the card: TWEET latitudes (COUNT), HKI minute
             bars (MAX, deg 3) and a smaller HKI table for MIN, at the
             paper's sizes or at the cut printed on a CUT line;
4. main    - one mixed batch of COUNT, MAX and MIN ranges through
             session.query under Q_abs, then under Q_rel, checked against
             exact answers computed on the host with numpy alone; the
             kernel launch counters must show that the batch ran the
             kernels, and no deg > 3 reroute;
5. parity  - each kernel against its plain version on the card, on the
             plans and queries of phase 4 (K1 exactly, K2/K3 to 1e-9);
6. timing  - device time of each kernel, its plain version and the
             one-call library yardstick where there is one (CUDA-event
             timed replays of a CUDA graph of the calls, so host dispatch
             drops out), the kernel's eager per-call time (host dispatch
             included), and the session's end-to-end query latency.

The line before last is the card's nvidia-smi name and power limit, the
line before that the kernels' JSON record; the last line is the result.
Imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# the paper's instance sizes (TWEET 1M latitudes, HKI 0.9M minute bars);
# the MIN table only exercises the negation path and is built smaller
N_TWEET = 1_000_000
N_HKI = 900_000
N_HKI_MIN = 100_000
NQ = 65_536                 # ranges per table in the main-path batch
SEED = 7
EPS_REL = 0.01
TOL = 1e-9                  # kernel vs plain version (ROADMAP rule 4)
TIMED_LAUNCHES = 100
DEVICE = "cuda"

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and FP64 (non-tensor) peak
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12

REPLACES = {
    "locate": "src/repro/kernels/locate.py:179",
    "range_sum_gather": "src/repro/kernels/range_sum.py:49",
    "range_max_gather": "src/repro/kernels/range_max.py:62",
}
SOURCE = "src/repro_torch/csrc/polyfit_kernels.cu"


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
    """COUNT over (lq, uq]; MAX/MIN over [lq, uq] (every span non-empty,
    since the endpoints are drawn from the keys)."""
    order = np.argsort(keys, kind="stable")
    k = keys[order]
    if agg == "count":
        return (np.searchsorted(k, uq, side="right")
                - np.searchsorted(k, lq, side="right")).astype(np.float64)
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


def bound_ms(nbytes: float, flops: float):
    """The least time for the work: bytes over HBM bandwidth or f64 flops
    over the FP64 peak, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP64_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def probe_rounds(n: int) -> int:
    """Probe rounds of the branch-free binary search over n entries."""
    return max(0, (n - 1).bit_length()) + 1


def range_max_flops(rounds: int, deg: int) -> int:
    """f64 operations of K3 for one query (locate.cuh): two binary searches,
    and per boundary segment two scale_unit (5 each), up to four Horner
    evaluations (2 * deg each) and about 20 for the roots, maxima and
    clips; 6 for the interior max and the final maxima."""
    return 2 * rounds + 2 * (10 + 4 * 2 * deg + 20) + 6


def max_abs_err(a, b) -> float:
    """Largest |a - b| (equal infinities count 0)."""
    same = a == b
    d = (a - b).abs().masked_fill(same, 0.0)
    return float(d.max()) if d.numel() else 0.0


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def main() -> None:
    import torch

    # -- 1. device --------------------------------------------------------
    check(torch.cuda.is_available(), "no CUDA device: this script needs one "
          "NVIDIA card")
    src = os.path.join(ROOT, "src")
    check(os.path.isdir(os.path.join(src, "repro_torch")),
          f"the port's package is missing under {src}")
    sys.path.insert(0, src)
    from repro_torch.api import (ErrorBudget, PolyFit, QueryBatch, QuerySpec,
                                 TableSpec)
    from repro_torch.data import hki_series, make_queries_1d, tweet_latitudes
    from repro_torch.engine import execute_extremum
    from repro_torch.kernels import _build
    from repro_torch.kernels import locate as kloc
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
    print(f"build: {time.perf_counter() - t0:.3f} s (nvcc {build.seconds:.3f} s)"
          f" -> {os.path.relpath(build.path, ROOT)}", flush=True)
    for line in build.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")

    # -- 3. fit -----------------------------------------------------------
    sizes = {"lat": N_TWEET, "hki": N_HKI, "hki_min": N_HKI_MIN}
    for name, paper in (("lat", 1_000_000), ("hki", 900_000)):
        if sizes[name] < paper:
            print(f"CUT: {name} n {paper} -> {sizes[name]}")
    lat = tweet_latitudes(sizes["lat"])
    t_h, v_h = hki_series(sizes["hki"])
    t_m, v_m = hki_series(sizes["hki_min"])
    datasets = {"lat": lat, "hki": (t_h, v_h), "hki_min": (t_m, v_m)}
    specs = {"lat": TableSpec("count", ErrorBudget(abs=100.0)),
             "hki": TableSpec("max", ErrorBudget(abs=50.0, rel=EPS_REL)),
             "hki_min": TableSpec("min", ErrorBudget(abs=50.0, rel=EPS_REL))}
    t0 = time.perf_counter()
    session = PolyFit.fit(datasets, specs, device=dev)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    check(session.backend == "cuda", f"default backend {session.backend}")
    secs = session.build_seconds()
    for name in session.tables:
        p = session.plan(name)
        check(p.device.type == "cuda", f"plan {name} on {p.device}")
        print(f"fit {name}: agg={p.agg} n={p.n} h={p.h} Hp={p.seg_lo.shape[0]}"
              f" deg={p.deg} delta={p.delta} host_build_s={secs[name]:.3f} "
              f"device_bytes={p.device_bytes()} index_bytes={p.size_bytes()}",
              flush=True)
    print(f"fit total: {fit_s:.3f} s", flush=True)

    # -- 4. main path -----------------------------------------------------
    qs = {"lat": make_queries_1d(lat, NQ, seed=SEED),
          "hki": make_queries_1d(t_h, NQ, seed=SEED),
          "hki_min": make_queries_1d(t_m, NQ, seed=SEED)}
    keys = {"lat": (lat, None), "hki": (t_h, v_h), "hki_min": (t_m, v_m)}
    aggs = {"lat": "count", "hki": "max", "hki_min": "min"}
    truth = {name: host_truth(*keys[name], *qs[name], aggs[name])
             for name in qs}
    bounds = {"lat": 100.0, "hki": 50.0, "hki_min": 50.0}

    def batch(rel):
        return QueryBatch.of(*(QuerySpec.range(name, *qs[name], rel=rel)
                               for name in ("lat", "hki", "hki_min")))

    counters = (kloc.locate, ksum.range_sum_gather, kmax.range_max_gather)
    for c in counters:
        c.launches = 0
    execute_extremum.torch_routes = 0
    main_s = {}
    answers = {}
    for label, rel in (("Q_abs", None), ("Q_rel", EPS_REL)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        answers[label] = session.query(batch(rel))
        torch.cuda.synchronize()
        main_s[label] = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    routes = execute_extremum.torch_routes
    print(f"main path: launches {launches}, deg>3 reroutes {routes}, "
          f"first-call seconds {main_s}", flush=True)
    check(launches["range_sum_gather"] > 0, "K2 was not launched")
    check(launches["range_max_gather"] > 0, "K3 was not launched")
    check(launches["locate"] > 0, "K1 was not launched by the refinement")
    check(routes == 0, "a MAX/MIN group was rerouted off the kernels")

    shares = {}
    for label in ("Q_abs", "Q_rel"):
        for name, ans in zip(("lat", "hki", "hki_min"), answers[label]):
            a = ans.value.cpu().numpy()
            r = truth[name]
            check(a.shape == (NQ,) and np.all(np.isfinite(a)),
                  f"{label} {name}: bad answers")
            err = np.abs(a - r)
            if label == "Q_abs":
                check(err.max() <= bounds[name] + 1e-6,
                      f"{label} {name}: |A-R| {err.max()} > {bounds[name]}")
                print(f"{label} {name}: max |A-R| = {err.max()!r} <= "
                      f"{bounds[name]}")
            else:
                pos = r != 0
                rel = float((err[pos] / np.abs(r[pos])).max())
                share = shares[name] = float(ans.refined.float().mean())
                check(rel <= EPS_REL + 1e-12,
                      f"{label} {name}: relative error {rel} > {EPS_REL}")
                print(f"{label} {name}: max rel err = {rel!r} <= {EPS_REL}; "
                      f"refined share {share!r}")
    # MIN runs in MAX space on negated measures, where the Lemma 5.4 test
    # cannot pass for positive measures: it refines every query by design
    check(shares["lat"] < 1.0 and shares["hki"] < 1.0,
          f"Q_rel refined every query: {shares}")

    # -- 5. kernel parity on the card ---------------------------------------
    lat_plan, hki_plan, min_plan = (session.plan(n)
                                    for n in ("lat", "hki", "hki_min"))

    def clamped(name, plan):
        return tuple(torch.maximum(torch.as_tensor(q, device=dev),
                                   plan.domain_lo) for q in qs[name])

    lq_c, uq_c = clamped("lat", lat_plan)
    lq_m, uq_m = clamped("hki", hki_plan)
    lq_n, uq_n = clamped("hki_min", min_plan)
    uq_raw = torch.as_tensor(qs["lat"][1], device=dev)
    k1_args = (uq_raw, lat_plan.ref_keys)       # the refinement's search
    k2_args = (lq_c, uq_c, lat_plan.seg_lo, lat_plan.seg_hi, lat_plan.coeffs)
    k3_args = (lq_m, uq_m, hki_plan.seg_lo, hki_plan.seg_hi, hki_plan.coeffs,
               hki_plan.st)
    k3n_args = (lq_n, uq_n, min_plan.seg_lo, min_plan.seg_hi,
                min_plan.coeffs, min_plan.st)

    got = kloc.locate(*k1_args)
    want = kloc.locate_segments(k1_args[1], k1_args[0])
    torch.cuda.synchronize()
    check(torch.equal(got, want), "K1 ids differ from the plain version")
    errs = {"locate": 0.0}
    for name, fn, plain, args_list in (
            ("range_sum_gather", ksum.range_sum_gather,
             ksum.range_sum_gather_plain, (k2_args,)),
            ("range_max_gather", kmax.range_max_gather,
             kmax.range_max_gather_plain, (k3_args, k3n_args))):
        errs[name] = 0.0
        for args in args_list:
            a, b = fn(*args), plain(*args)
            torch.cuda.synchronize()
            check(torch.allclose(a, b, rtol=TOL, atol=TOL, equal_nan=False),
                  f"{name} differs from its plain version")
            errs[name] = max(errs[name], max_abs_err(a, b))
    print(f"parity: max |kernel - plain| = {errs}", flush=True)

    # -- 6. timing --------------------------------------------------------
    Q = NQ
    rows = []
    for name, fn, plain, args, library in (
            ("locate", kloc.locate, lambda q, k: kloc.locate_segments(k, q),
             k1_args, lambda q, k: torch.searchsorted(k, q, right=True)),
            ("range_sum_gather", ksum.range_sum_gather,
             ksum.range_sum_gather_plain, k2_args, None),
            ("range_max_gather", kmax.range_max_gather,
             kmax.range_max_gather_plain, k3_args, None)):
        ms = device_ms(torch, lambda: fn(*args))
        eager_ms = call_ms(torch, lambda: fn(*args))
        plain_ms = device_ms(torch, lambda: plain(*args))
        lib_ms = None if library is None else device_ms(
            torch, lambda: library(*args))
        if name == "locate":
            n = args[1].shape[0]
            nbytes = Q * 8 + n * 8 + Q * 4
            flops = Q * probe_rounds(n)
            shape = f"q ({Q},) f64, keys ({n},) f64 -> ({Q},) int32"
        else:
            H, cols = args[2].shape[0], args[4].shape[1]
            deg = cols - 1
            nbytes = 2 * Q * 8 + 2 * H * 8 + H * cols * 8 + Q * 8
            per_end = probe_rounds(H)
            if name == "range_sum_gather":
                flops = Q * (2 * (per_end + 5 + 2 * deg) + 1)
                shape = (f"lq, uq ({Q},); seg_lo, seg_hi ({H},); coeffs "
                         f"({H}, {cols}) f64 -> ({Q},)")
            else:
                st = args[5]
                nbytes += st.numel() * 8
                flops = Q * range_max_flops(per_end, deg)
                shape = (f"lq, uq ({Q},); seg_lo, seg_hi ({H},); coeffs "
                         f"({H}, {cols}); st {tuple(st.shape)} f64 -> ({Q},)")
        b_ms, b_by = bound_ms(nbytes, flops)
        rows.append({"name": name, "route": "cuda", "source": SOURCE,
                     "replaces": REPLACES[name], "shape": shape,
                     "launches": launches[name], "max_abs_err": errs[name],
                     "ms": ms, "call_ms": eager_ms,
                     "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": b_ms, "bound_by": b_by})
        print(f"timing {name}: kernel {ms!r} ms on the device, {eager_ms!r} "
              f"ms per eager call; plain {plain_ms!r} ms; library {lib_ms!r}"
              f" ms; bound {b_ms!r} ms ({b_by})", flush=True)
    # the main path's other K3 launch: the MIN table's, a smaller plan
    min_ms = device_ms(torch, lambda: kmax.range_max_gather(*k3n_args))
    print(f"timing range_max_gather on hki_min (Hp "
          f"{min_plan.seg_lo.shape[0]}): kernel {min_ms!r} ms on the device",
          flush=True)

    for label, rel in (("Q_abs", None), ("Q_rel", EPS_REL)):
        req = batch(rel)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            session.query(req)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"session.query {label} ({3 * NQ} ranges, numpy in): "
              f"median {statistics.median(times)!r} ms, runs {times!r}")

    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
