"""The rates behind K13's and K19's design on the card.

K13 (``tools/k13_rates.cu``): the corner scan before its redesign, the
shipped scan and finish, the shipped design at other shapes (4 and 16
corners a thread, rows by 8-byte loads, 256 threads a block, 256-leaf
tiles, 1 and 8 chunks) and the shipped finish alone, on two leaf tables:
an OSM-like one (100,000 clustered points, a quadtree split to depth 12
where a cell holds more than 100 of them, random deg-3 rows, in a plan's
flat layout: the shape of ``chip_smoke.py``'s ``osm`` plan) and the
smoke's depth-16 MIN plan over 20,000 OSM-like points (built here), each at
65,536 corners clamped into the root and a few NaN and infinite ones:
milliseconds (events around 20 eager calls) and (corner, live leaf) pairs
a clock an SM.

K19 (``tools/k19_rates.cu``): the kernel before its redesign, the shipped
rank form and its variants (no buckets; buckets at other shapes, stages
and groups; two chunked forms, whose sums round otherwise), on the x-sorted 4,096-slot logs of an OSM-like SUM
table (3,072 OSM-like inserts, 1,024 deleted base points, and a full log)
against ``chip_smoke.py``'s rectangles for ``osm_sum_dyn`` (three
quarters from the table's points, a quarter narrow ones at the hot box):
milliseconds, the mean [a, b) width, and (rectangle, live slot) pairs a
clock an SM; the shipped kernel again with one of the rectangles over the
whole plane (its warp walks every live slot).  K18 runs beside it on the
same logs.

Every variant is held to its plain version bit for bit (NaN equal), K19's
on the rectangles plus NaN, infinite, signed-zero and inverted ones; the
chunked forms to a transcription of their order (each chunk's plain sum,
the chunks added in order).  Then each kernel's registers, spills and
loads from ``cuobjdump``.

    python3 tools/k13_k19_rates.py      # on a machine with the card and nvcc

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
from chip_smoke import (DEEP_DEPTH, Live2D, N_OSM_DEEP,  # noqa: E402
                        N_OSM_SUM_DYN, osm_measure)
from k7_k17_rates import (build, osm_like_table, resources, smi,  # noqa: E402
                          timed_ms)
from repro_torch.core import build_index_2d  # noqa: E402
from repro_torch.data import make_queries_2d, osm_points  # noqa: E402
from repro_torch.engine import DeltaBuffer2D, build_plan_2d  # noqa: E402
from repro_torch.engine.dynamic import _append_2d  # noqa: E402
from repro_torch.engine.plan import big_sentinel  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import delta_scan as kdel  # noqa: E402
from repro_torch.kernels import leaf_eval2d as k2d  # noqa: E402

NQ, CAP, PAD = 65_536, 4096, 512
K13_VARIANTS = ((0, "K13 before"),
                (1, "K13 shipped (128 x 8, 128-leaf tiles, 4 chunks, "
                    "16-byte rows)"),
                (10, "the shipped finish alone (eager launches)"),
                (2, "4 corners a thread"), (3, "rows by 8-byte loads"),
                (4, "4 corners a thread, 8-byte rows (first shape)"),
                (5, "16 corners a thread"), (6, "256 threads a block"),
                (7, "256-leaf tiles"), (8, "1 chunk"), (9, "up to 8 chunks"))
K19_VARIANTS = ((0, "K19 before"), (1, "K19 shipped (buckets, 256 x 1, "
                                       "groups of 8)"),
                (2, "no buckets, 128 x 4, 1,024-slot stages"),
                (3, "no buckets, 256 x 1, the whole log"),
                (4, "buckets, 128 x 2"), (5, "buckets, 256 x 2"),
                (6, "buckets, 256 x 1, 2,048-slot stages"),
                (7, "buckets, 128 x 1"), (8, "groups of 4 slots"),
                (9, "groups of 16 slots"),
                (11, "chunked (4 rows), buckets 256 x 1"),
                (12, "chunked (4 rows), no buckets 128 x 4"))
CHUNKED = (11, 12)


def bits_equal(a, b) -> bool:
    return bool(torch.isclose(a, b, rtol=0, atol=0, equal_nan=True).all()
                and torch.equal(torch.signbit(a), torch.signbit(b)))


def pad(t, n, value):
    return torch.cat([t, t.new_full((n - t.shape[0], *t.shape[1:]), value)])


def osm_scan_table(dev):
    """The OSM-like leaf table in a plan's flat layout (engine.plan.
    build_plan_2d): membership bounds with the root's top and right edges
    open to the sentinel, padded to a multiple of 512 leaves."""
    _, root, _, _, _, b, coeffs = osm_like_table(dev)
    big = big_sentinel(torch.float64)
    L = b.shape[0]
    Lp = -(-L // PAD) * PAD
    mx1 = torch.where(b[:, 1] >= root[1], big, b[:, 1])
    my1 = torch.where(b[:, 3] >= root[3], big, b[:, 3])
    table = (pad(b[:, 0], Lp, big), pad(mx1, Lp, big), pad(b[:, 2], Lp, big),
             pad(my1, Lp, big), pad(b, Lp, 0.0), pad(coeffs, Lp, 0.0))
    return root, table, 3


def deep_scan_table(dev):
    """The smoke's depth-16 dominance MIN plan over 20,000 OSM-like points
    (chip_smoke.py's deep_min), built on the card."""
    px, py = osm_points(N_OSM_DEEP, seed=5)
    plan = build_plan_2d(build_index_2d(
        px, py, measures=osm_measure(px, py), agg="min2d", deg=2, delta=10.0,
        max_depth=DEEP_DEPTH, device=dev))
    table = (plan.leaf_mx0, plan.leaf_mx1, plan.leaf_my0, plan.leaf_my1,
             plan.leaf_bounds, plan.leaf_coeffs)
    return plan.root, table, plan.deg, (px, py)


def corners(root, px, py, dev, seed):
    """NQ corners of rectangles from the points, clamped into the root, the
    last few NaN and infinite."""
    _, ux, _, uy = make_queries_2d(px, py, NQ, seed=seed)
    ux, uy = np.clip(ux, root[0], root[1]), np.clip(uy, root[2], root[3])
    ux[-4:] = (np.nan, np.inf, -np.inf, root[1])
    uy[-4:] = (5.0, np.nan, np.inf, root[3])
    return (torch.as_tensor(ux, device=dev), torch.as_tensor(uy, device=dev))


def sum_logs(dev, seed=5):
    """osm_sum_dyn-like x-sorted 4,096-slot logs built by the engine's
    append: 3,072 OSM-like inserts, 1,024 deleted base points and a full
    log of inserts; the base points' rectangles (chip_smoke.Live2D)."""
    bx, by = osm_points(N_OSM_SUM_DYN, seed=seed)
    bw = osm_measure(bx, by)
    rng = np.random.default_rng(seed)
    to = lambda a: torch.as_tensor(a, device=dev)

    def log(x, y, w):
        e = DeltaBuffer2D.empty(CAP, device=dev, weighted=True)
        return _append_2d(e.ins_x, e.ins_y, e.ins_w, to(x), to(y), to(w),
                          cap=CAP, levels=False, weighted=True)[:3]

    ix, iy = osm_points(3072, seed=seed + 1)
    fx, fy = osm_points(CAP, seed=seed + 2)
    gone = rng.choice(len(bx), 1024, replace=False)
    logs = {"insert log": log(ix, iy, osm_measure(ix, iy)),
            "delete log": log(bx[gone], by[gone], bw[gone]),
            "full log": log(fx, fy, osm_measure(fx, fy))}
    qs = Live2D(bx, by, bw).queries(make_queries_2d, seed + 3, False)
    inf, nan = np.inf, np.nan
    extra = np.array([  # lx, ux, ly, uy
        [nan, 50.0, 0.0, 50.0], [0.0, nan, 0.0, 50.0],
        [0.0, 50.0, nan, 50.0], [0.0, 50.0, 0.0, nan],
        [-inf, inf, -inf, inf], [20.0, inf, 20.0, inf],
        [inf, -inf, inf, -inf], [-0.0, 0.0, -0.0, 0.0],
        [40.0, 30.0, -90.0, 90.0], [1e308, inf, 1e308, inf]])
    edge = [np.concatenate([q, extra[:, j]]) for j, q in enumerate(qs)]
    return logs, [to(q) for q in qs], [to(q) for q in edge]


def warp_unions(a, b, tail, bucketed, block=256, buckets=128):
    """The mean number of slots a warp of K19 walks: the union of its 32
    rectangles' [a, b) ranges (b cut at the log's sentinel tail), the
    block's rectangles in bucket order of a (as K19 sorts them) or in their
    own order."""
    empty = a >= b
    shift = max(0, max(tail, 1).bit_length() - 7)
    key = torch.where(empty, buckets - 1,
                      torch.clamp(a >> shift, max=buckets - 2))
    lo = torch.where(empty, torch.iinfo(a.dtype).max, a)
    hi = torch.where(empty, 0, b)
    total, warps = 0, 0
    for b0 in range(0, a.shape[0], block):
        idx = torch.arange(b0, min(b0 + block, a.shape[0]), device=a.device)
        if bucketed:
            idx = idx[torch.argsort(key[idx], stable=True)]
        n = idx.shape[0] // 32 * 32
        g = idx[:n].view(-1, 32)
        total += int(torch.clamp(hi[g].amax(dim=1) - lo[g].amin(dim=1),
                                 min=0).sum())
        warps += g.shape[0]
    return total / max(warps, 1)


def chunked_plain(q, x, y, w):
    """The chunked forms' order: each of 4 rows' plain sum, added in
    order."""
    D = x.shape[0]
    chunk = -(-D // 4)
    acc = None
    for c0 in range(0, D, chunk):
        sl = slice(c0, c0 + chunk)
        part = kdel.delta_sum2d_plain(*q, x[sl], y[sl], w[sl])
        acc = part if acc is None else acc + part
    return acc


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k13_k19_rates: needs an NVIDIA card")
    k13_path, k19_path = build(("k13_rates", "k19_rates"))
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    k13 = ctypes.CDLL(str(k13_path))
    k13.k13_run.argtypes = (I,) + (P,) * 10 + (I, I, I, D)
    k19 = ctypes.CDLL(str(k19_path))
    k19.k19_run.argtypes = (I,) + (P,) * 9 + (I, I, D)
    name_limit = smi("name,power.limit")
    ghz = float(smi("clocks.max.sm").split("\n")[0]) / 1e3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"{name_limit}; rates at {ghz} GHz, {sms} SMs", flush=True)
    dev = torch.device("cuda")
    big = big_sentinel(torch.float64)
    per_clock = lambda n, ms: n / (ms * 1e-3) / sms / (ghz * 1e9)

    # -- K13 -----------------------------------------------------------------
    root, table, deg = osm_scan_table(dev)
    px, py = osm_points(100_000, seed=2)
    sets = [("osm-like table", table, deg, corners(root, px, py, dev, 71))]
    root, table, deg, (dx, dy) = deep_scan_table(dev)
    sets.append(("depth-16 MIN plan", table, deg,
                 corners(root, dx, dy, dev, 72)))
    out = torch.empty(NQ, dtype=torch.float64, device=dev)
    hits = torch.empty((8, NQ), dtype=torch.int32, device=dev)
    for tag, table, deg, (u, v) in sets:
        L = table[0].shape[0]
        live = int((table[0] != big).sum())
        want = k2d.corner_eval2d_plain(u, v, *table, deg)
        print(f"K13 {tag}: {live} live leaves of {L}, deg {deg}", flush=True)
        for which, label in K13_VARIANTS:
            args = (which, u.data_ptr(), v.data_ptr(),
                    *(t.data_ptr() for t in table), out.data_ptr(),
                    hits.data_ptr(), NQ, L, deg, big)
            if which != 10:
                out.fill_(0.5)
            _build.check(k13.k13_run(*args), "k13_run")
            torch.cuda.synchronize()
            same = bits_equal(out, want)
            ms = timed_ms(lambda: k13.k13_run(*args))
            print(f"K13 {tag}, {label}: {ms!r} ms, "
                  f"{per_clock(NQ * live, ms)!r} (corner, live leaf) pairs "
                  f"a clock an SM, {per_clock(NQ * L, ms)!r} over every "
                  f"leaf; equals the plain version bit for bit: {same}",
                  flush=True)

    # -- K19 -----------------------------------------------------------------
    logs, q, q_edge = sum_logs(dev)
    lx, ux = q[0], q[1]
    # one rectangle over the whole plane: its warp walks every live slot
    q_wide = [t.clone() for t in q]
    for t, val in zip(q_wide, (-np.inf, np.inf, -np.inf, np.inf)):
        t[NQ // 2] = val
    out_e = torch.empty(NQ + 10, dtype=torch.float64, device=dev)
    part = torch.empty((4, NQ + 10), dtype=torch.float64, device=dev)
    for tag, (x, y, w) in logs.items():
        live = int((x != big).sum())
        tail = int(torch.searchsorted(x, torch.tensor([big], device=dev)))
        a = torch.searchsorted(x, lx.contiguous(), right=True)
        b = torch.clamp(torch.searchsorted(x, ux.contiguous(), right=True),
                        max=tail)
        ok = ~(torch.isnan(lx) | torch.isnan(ux))
        width = float(torch.clamp(b - a, min=0)[ok].double().mean())
        want = kdel.delta_sum2d_plain(*q_edge, x, y, w)
        want_c = chunked_plain(q_edge, x, y, w)
        sorted_u = warp_unions(a, b, tail, True)
        plain_u = warp_unions(a, b, tail, False)
        print(f"K19 {tag}: {live} live slots of {CAP}, mean [a, b) width "
              f"{width!r} slots ({width / max(live, 1)!r} of the live); a "
              f"warp's union {sorted_u!r} slots ({sorted_u / live!r}) with "
              f"the buckets, {plain_u!r} ({plain_u / live!r}) without",
              flush=True)
        for which, label in K19_VARIANTS:
            args = (which, *(t.data_ptr() for t in (*q_edge, x, y, w)),
                    out_e.data_ptr(), part.data_ptr(), NQ + 10, CAP, big)
            out_e.fill_(0.5)
            _build.check(k19.k19_run(*args), "k19_run")
            torch.cuda.synchronize()
            same = bits_equal(out_e, want_c if which in CHUNKED else want)
            args = (which, *(t.data_ptr() for t in (*q, x, y, w)),
                    out.data_ptr(), part.data_ptr(), NQ, CAP, big)
            ms = timed_ms(lambda: k19.k19_run(*args))
            held = ("its chunked order" if which in CHUNKED
                    else "the plain version")
            print(f"K19 {tag}, {label}: {ms!r} ms, "
                  f"{per_clock(NQ * live, ms)!r} (rectangle, live slot) "
                  f"pairs a clock an SM, {per_clock(NQ * width, ms)!r} "
                  f"(rectangle, [a, b) slot) pairs; equals {held} bit for "
                  f"bit: {same}", flush=True)
        args = (1, *(t.data_ptr() for t in (*q_wide, x, y, w)),
                out.data_ptr(), part.data_ptr(), NQ, CAP, big)
        ms = timed_ms(lambda: k19.k19_run(*args))
        print(f"K19 {tag}, shipped, one rectangle of the {NQ} over the whole "
              f"plane: {ms!r} ms", flush=True)
        ms = timed_ms(lambda: kdel.delta_count2d(*q, x, y))
        print(f"K18 {tag}: {ms!r} ms", flush=True)

    resources(k13_path, "k13_old|corner_eval2d")
    resources(k19_path, "k19_old|delta_sum2d")


if __name__ == "__main__":
    main()
