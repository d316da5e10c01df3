"""The rates behind K14's and K18's design on the card.

K14 (``tools/k14_rates.cu``): the kernel before its redesign (one-hot
membership of both endpoints over every row of the padded table), the
shipped count walk (seg_lo's tiles up to the sentinel tail, two counts,
boundary rows and Horner in one launch, 1 range a thread in blocks of
256) and other shapes of it (1, 2 and 4 ranges a thread in blocks of 128,
256-start tiles; the variant template at the shipped shape, which must
time as the shipped kernel does), on segment tables in a plan's layout at the shapes of
``chip_smoke.py``'s plans: ``lat_dyn`` (105 live segments of 512, deg 2),
``lat`` at float32 (40 of 512, deg 2) and ``hki_sum`` (900 of 1,024, deg
3), each at 65,536 ranges clamped into the domain: device milliseconds (20
launches a CUDA graph), with K2 (``range_sum_gather``) on the same table
and ranges beside them.

K18 (``tools/k18_rates.cu``): the kernel before its redesign, the shipped
rank form and its variants (the live log in 2 and 4 chunks along the
grid; no buckets; 1 or 2 rectangles a thread in blocks of 128; groups of
16 slots; the x keys searched in shared memory; each warp's union split
across 2 or 4 warps; the rank test once a group of slots; the variant
template at the shipped shape), and K19 as shipped, on the x-sorted 4,096-slot logs of an OSM-like COUNT table like
``chip_smoke.py``'s ``osm_dyn`` (3,072 OSM-like inserts, 1,024 deleted
base points, and a full log) against its rectangles (three quarters from
the table's 100,000 points, a quarter narrow ones at the hot box):
device milliseconds, the mean [a, b) width and a warp's mean union, and
(rectangle, live slot) pairs a clock an SM; some variants again with one
of the rectangles over the whole plane (its warp walks every live slot,
or its part of them) and on rectangles whose x ranges are all empty (the
rank prologue and the writes alone).

Every variant is held to its plain version (K14's on the ranges plus its
edge lanes, NaN equal; K18's exactly on the rectangles plus NaN, infinite,
signed-zero, inverted and sentinel ones).  Then each kernel's registers,
spills and loads from ``cuobjdump``.

    python3 tools/k14_k18_rates.py      # on a machine with the card and nvcc

The rates assume the card's maximum SM clock (``nvidia-smi``
clocks.max.sm); the card's name and power limit are printed beside them.
"""
import ctypes
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
from chip_smoke import Live2D, N_OSM_DYN, device_ms  # noqa: E402
from k13_k19_rates import bits_equal, warp_unions  # noqa: E402
from k7_k17_rates import build, resources, smi  # noqa: E402
from repro_torch.data import make_queries_2d, osm_points  # noqa: E402
from repro_torch.engine import DeltaBuffer2D  # noqa: E402
from repro_torch.engine.dynamic import _append_2d  # noqa: E402
from repro_torch.engine.plan import big_sentinel  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import delta_scan as kdel  # noqa: E402
from repro_torch.kernels import range_sum as ksum  # noqa: E402

NQ, CAP = 65_536, 4096
K14_TABLES = (("lat_dyn", 105, 512, 2, torch.float64),
              ("lat float32", 40, 512, 2, torch.float32),
              ("hki_sum", 900, 1024, 3, torch.float64))
K14_VARIANTS = ((0, "K14 before"),
                (1, "K14 shipped (256 x 1, 128-start tiles)"),
                (2, "1 range a thread, blocks of 128"),
                (4, "2 ranges a thread, blocks of 128 (the first shape)"),
                (3, "4 ranges a thread, blocks of 128"),
                (5, "256-start tiles"),
                (6, "k14_variant at the shipped shape (256 x 1, 128-start "
                    "tiles)"))
K18_VARIANTS = ((0, "K18 before"),
                (1, "K18 shipped (split in 2, x keys in shared memory, "
                    "the rank test once a group of 32)"),
                (22, "the first rank form (a rank test a slot, groups of "
                     "8, x keys in global memory)"),
                (2, "first form, 4 chunks"), (3, "first form, 2 chunks"),
                (5, "first form, no buckets"), (6, "first form, 128 x 2"),
                (14, "first form, 128 x 1"),
                (7, "first form, groups of 16 slots"),
                (10, "first form, x keys in shared memory"),
                (11, "first form, split in 2"),
                (12, "first form, split in 2, x keys in shared memory"),
                (13, "first form, split in 4, x keys in shared memory"),
                (15, "first form, 128 x 1, split in 2"),
                (16, "rank test a group of 8, x keys in shared memory"),
                (17, "rank test a group of 16, x keys in shared memory"),
                (18, "rank test a group of 32, x keys in shared memory"),
                (21, "rank test a group of 16, split in 2, x keys in global "
                     "memory"),
                (20, "rank test a group of 16, split in 2, x keys in shared "
                     "memory"),
                (19, "k18_variant at the shipped shape"),
                (9, "K19 shipped (delta_sum2d), for comparison"))
# the variants timed again on rectangles whose x ranges are all empty (the
# rank prologue and the writes alone) and with one rectangle over the
# whole plane
K18_FIXED = (1, 22, 2, 10)
K18_WIDE = (1, 22, 2, 12, 17)


def segment_table(dev, live, n, deg, dt, seed=0):
    """A segment table in a plan's layout: ``live`` sorted starts over
    [0, 1000] in ``n`` slots, seg_next the next start and the sentinel
    last, seg_hi 90% of the way to the next start, random rows of ``deg``.
    (seg_lo, seg_next, seg_hi, coeffs)."""
    rng = np.random.default_rng(seed + live)
    big = big_sentinel(dt)
    lo = np.sort(rng.uniform(0, 1000, live))
    lo[0] = 0.0
    nx = np.append(lo[1:], big)
    hi = np.append(lo[:-1] + 0.9 * (lo[1:] - lo[:-1]), 1000.0)
    cf = rng.normal(0, 100, (live, deg + 1))
    pad = lambda a, v: torch.as_tensor(
        np.concatenate([a, np.full((n - live, *a.shape[1:]), v)]),
        dtype=dt, device=dev)
    return pad(lo, big), pad(nx, big), pad(hi, big), pad(cf, 0.0)


def ranges(table, dev, seed=3):
    """NQ ranges clamped into [seg_lo[0], 1000], and the same with the edge
    lanes (NaN, +-inf, the sentinel, below the table, inverted) in front."""
    dt = table[0].dtype
    rng = np.random.default_rng(seed)
    a, b = rng.uniform(-5, 1005, (2, NQ))
    lq, uq = np.clip(np.minimum(a, b), 0, 1000), np.clip(np.maximum(a, b),
                                                        0, 1000)
    big = big_sentinel(dt)
    el = np.array([np.nan, 5.0, np.inf, -np.inf, big, -1.0, 700.0])
    eu = np.array([5.0, np.nan, np.inf, np.inf, 2 * big, 3.0, 300.0])
    to = lambda v: torch.as_tensor(v, dtype=dt, device=dev)
    return ((to(lq), to(uq)),
            (to(np.concatenate([el, lq])), to(np.concatenate([eu, uq]))))


def count_logs(dev, seed=5):
    """osm_dyn-like x-sorted 4,096-slot logs built by the engine's append:
    3,072 OSM-like inserts, 1,024 deleted base points and a full log; the
    base points' rectangles (chip_smoke.Live2D), and the same with edge
    lanes at the end."""
    bx, by = osm_points(N_OSM_DYN, seed=seed)
    rng = np.random.default_rng(seed)
    to = lambda a: torch.as_tensor(a, device=dev)

    def log(x, y):
        e = DeltaBuffer2D.empty(CAP, device=dev, weighted=True)
        return _append_2d(e.ins_x, e.ins_y, e.ins_w, to(x), to(y),
                          to(np.ones(len(x))), cap=CAP, levels=False,
                          weighted=True)[:3]

    ix, iy = osm_points(3072, seed=seed + 1)
    fx, fy = osm_points(CAP, seed=seed + 2)
    gone = rng.choice(len(bx), 1024, replace=False)
    logs = {"insert log": log(ix, iy), "delete log": log(bx[gone], by[gone]),
            "full log": log(fx, fy)}
    qs = Live2D(bx, by, None).queries(make_queries_2d, seed + 3, False)
    big = big_sentinel(torch.float64)
    inf, nan = np.inf, np.nan
    extra = np.array([  # lx, ux, ly, uy
        [nan, 50.0, 0.0, 50.0], [0.0, nan, 0.0, 50.0],
        [0.0, 50.0, nan, 50.0], [0.0, 50.0, 0.0, nan],
        [-inf, inf, -inf, inf], [20.0, inf, 20.0, inf],
        [inf, -inf, inf, -inf], [-0.0, 0.0, -0.0, 0.0],
        [40.0, 30.0, -90.0, 90.0], [-1.0, big, -100.0, big]])
    edge = [np.concatenate([q, extra[:, j]]) for j, q in enumerate(qs)]
    return logs, [to(q) for q in qs], [to(q) for q in edge]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k14_k18_rates: needs an NVIDIA card")
    k14_path, k18_path = build(("k14_rates", "k18_rates"))
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    k14 = ctypes.CDLL(str(k14_path))
    k14.k14_run.argtypes = (I, I) + (P,) * 7 + (I, I, I, D, P)
    k18 = ctypes.CDLL(str(k18_path))
    k18.k18_run.argtypes = (I,) + (P,) * 9 + (I, I, D, P)
    name_limit = smi("name,power.limit")
    ghz = float(smi("clocks.max.sm").split("\n")[0]) / 1e3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"{name_limit}; rates at {ghz} GHz, {sms} SMs", flush=True)
    dev = torch.device("cuda")
    per_clock = lambda n, ms: n / (ms * 1e-3) / sms / (ghz * 1e9)
    stream = lambda: torch.cuda.current_stream().cuda_stream

    # -- K14 -----------------------------------------------------------------
    for tag, live, n, deg, dt in K14_TABLES:
        table = segment_table(dev, live, n, deg, dt)
        (lq, uq), (el, eu) = ranges(table, dev)
        f32 = int(dt == torch.float32)
        big = big_sentinel(dt)
        want = ksum.range_sum_plain(el, eu, *table)
        out_e = torch.empty_like(el)
        out = torch.empty_like(lq)
        print(f"K14 {tag}: {live} live segments of {n}, deg {deg}, {NQ} "
              "ranges", flush=True)
        for which, label in K14_VARIANTS:
            args = (which, f32, el.data_ptr(), eu.data_ptr(),
                    *(t.data_ptr() for t in table), out_e.data_ptr(),
                    el.shape[0], n, deg, big)
            out_e.fill_(0.5)
            _build.check(k14.k14_run(*args, stream()), "k14_run")
            torch.cuda.synchronize()
            same = bool(torch.isclose(out_e, want, rtol=0, atol=0,
                                      equal_nan=True).all())
            args = (which, f32, lq.data_ptr(), uq.data_ptr(),
                    *(t.data_ptr() for t in table), out.data_ptr(), NQ, n,
                    deg, big)
            ms = device_ms(torch, lambda: k14.k14_run(*args, stream()))
            print(f"K14 {tag}, {label}: {ms!r} ms, "
                  f"{per_clock(NQ * 2 * live, ms)!r} (endpoint, live "
                  f"segment) pairs a clock an SM; equals the plain version "
                  f"(NaN equal): {same}", flush=True)
        ms = device_ms(torch, lambda: ksum.range_sum_gather(
            lq, uq, table[0], table[2], table[3]))
        print(f"K14 {tag}, K2 (range_sum_gather) on the same ranges: "
              f"{ms!r} ms", flush=True)

    # -- K18 -----------------------------------------------------------------
    logs, q, q_edge = count_logs(dev)
    lx, ux = q[0], q[1]
    q_wide = [t.clone() for t in q]
    for t, val in zip(q_wide, (-np.inf, np.inf, -np.inf, np.inf)):
        t[NQ // 2] = val
    big = big_sentinel(torch.float64)
    ne = q_edge[0].shape[0]
    out = torch.empty(NQ, dtype=torch.float64, device=dev)
    out_e = torch.empty(ne, dtype=torch.float64, device=dev)
    part = torch.empty((8, ne), dtype=torch.int32, device=dev)
    for tag, (x, y, w) in logs.items():
        live = int((x != big).sum())
        tail = int(torch.searchsorted(x, torch.tensor([big], device=dev)))
        a = torch.searchsorted(x, lx.contiguous(), right=True)
        b = torch.clamp(torch.searchsorted(x, ux.contiguous(), right=True),
                        max=tail)
        width = float(torch.clamp(b - a, min=0).double().mean())
        union = warp_unions(a, b, tail, True)
        print(f"K18 {tag}: {live} live slots of {CAP}, mean [a, b) width "
              f"{width!r} slots ({width / max(live, 1)!r} of the live); a "
              f"warp's union {union!r} slots unchunked", flush=True)
        want = kdel.delta_count2d_plain(*q_edge, x, y)
        want_s = kdel.delta_sum2d_plain(*q_edge, x, y, w)
        for which, label in K18_VARIANTS:
            args = (which, *(t.data_ptr() for t in (*q_edge, x, y, w)),
                    out_e.data_ptr(), part.data_ptr(), ne, CAP, big)
            out_e.fill_(0.5)
            _build.check(k18.k18_run(*args, stream()), "k18_run")
            torch.cuda.synchronize()
            same = bits_equal(out_e, want_s if which == 9 else want)
            args = (which, *(t.data_ptr() for t in (*q, x, y, w)),
                    out.data_ptr(), part.data_ptr(), NQ, CAP, big)
            ms = device_ms(torch, lambda: k18.k18_run(*args, stream()))
            print(f"K18 {tag}, {label}: {ms!r} ms, "
                  f"{per_clock(NQ * live, ms)!r} (rectangle, live slot) "
                  f"pairs a clock an SM, {per_clock(NQ * width, ms)!r} "
                  f"(rectangle, [a, b) slot) pairs; equals the plain "
                  f"version: {same}", flush=True)
        for which in K18_WIDE:
            args = (which, *(t.data_ptr() for t in (*q_wide, x, y, w)),
                    out.data_ptr(), part.data_ptr(), NQ, CAP, big)
            ms = device_ms(torch, lambda: k18.k18_run(*args, stream()))
            print(f"K18 {tag}, {dict(K18_VARIANTS)[which]}, one rectangle "
                  f"of the {NQ} over the whole plane: {ms!r} ms", flush=True)
        for which in K18_FIXED:
            args = (which, *(t.data_ptr() for t in (lx, lx, *q[2:], x, y, w)),
                    out.data_ptr(), part.data_ptr(), NQ, CAP, big)
            ms = device_ms(torch, lambda: k18.k18_run(*args, stream()))
            print(f"K18 {tag}, {dict(K18_VARIANTS)[which]}, every x range "
                  f"empty (ux = lx): {ms!r} ms", flush=True)

    resources(k14_path, "k14_old|k14_variant|range_sum_scan")
    resources(k18_path,
              "k18_old|k18_variant|delta_count2d|count_combine|delta_sum2d")


if __name__ == "__main__":
    main()
