"""The rates behind K3's and K11's design on the card.

K3 (``tools/k3_rates.cu``): the kernel before its redesign (one thread a
query, the degree a runtime argument), the shipped kernel (two threads a
query, one a boundary, the degree a template argument, rows by 16-byte
loads) and the variants it was chosen from: one thread a query at the
template degree; the stationary points of each segment from a table built
once (lin, r1 and r2 by the plain version's own expressions at the
table's type, ``stationary_table``) in place of three divisions and a
square root a boundary; seg_lo staged in shared memory; and a breakdown
of the shipped shape into the endpoints' loads and the writes alone (no
search), then the two searches, then the rows and boundary maxima, then
the sparse table (the whole kernel).  On
``chip_smoke.py``'s ``hki`` plan (HKI 100,000 MAX, deg 3, delta 50: Hp
1,024) at float64 and at float32 (``ops.from_index``, the ops step's
table), and on an ``hki_dyn``-like plan: ``hki``'s segments three times
over, shifted along the keys (h 2,295, Hp 2,560, the shape of ``hki_dyn``
at 300,000 bars), each with 65,536 ranges drawn from the keys
(``make_queries_1d``) and clamped to the domain as the engine clamps
them.  Beside the times: the FP64-pipe instructions a query of the
shipped kernel, counted in its SASS (``cuobjdump -sass``; the
instructions outside loops, less the unrolled tree descent, plus its
four compares a node it visits: ``chip_smoke.k3_fp64_per_query``), the
bound they set at the FP64 peak, and the old kernel's static counts.

K11 (``tools/k11_rates.cu``): the kernel before its redesign (every
level's search, one thread a corner), the shipped set-bits walk and its
variants (1, 2 or 4 taken levels in lockstep; one, two or four threads a
corner, each walking a group of the set bits), on ``osm_min_dyn``-like
x-sorted 4,096-slot insert logs (3,072 OSM-like points with the negated
MIN measures, and a full log of 4,096) against 65,536 corners at live
points, a quarter of them near the hot box: device milliseconds, loads a
corner (the x-rank's rounds, l + 1 for each set bit l, a prefix-max load
where the block holds a y at or below the corner's) and loads a clock an
SM.

Every full kernel is held to its plain version bit for bit (NaN equal).
Times are device milliseconds over 20 launches a CUDA graph
(``chip_smoke.device_ms``).  Then each kernel's registers, spills and loads
from ``cuobjdump``.

    python3 tools/k3_k11_rates.py      # on a machine with the card and nvcc

The rates assume the card's maximum SM clock (``nvidia-smi``
clocks.max.sm); the card's name and power limit are printed beside them.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
from chip_smoke import (FP64_FLOPS, HOT_BOX, NQ, SEED, device_ms,  # noqa: E402
                        k11_loads, k3_fp64_per_query, k3_sass_counts,
                        osm_measure, probe_rounds, sass_fp64)
from k7_k17_rates import build, resources, smi  # noqa: E402
from repro_torch.core import build_index_1d  # noqa: E402
from repro_torch.core.exact import build_sparse_table  # noqa: E402
from repro_torch.data import hki_series, make_queries_1d, osm_points  # noqa: E402
from repro_torch.engine import DeltaBuffer2D, build_plan  # noqa: E402
from repro_torch.engine.dynamic import _append_2d  # noqa: E402
from repro_torch.engine.plan import big_sentinel, pad_to_multiple  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.locate import search_tree, tree_levels  # noqa: E402
from repro_torch.kernels import delta_scan as kdel  # noqa: E402
from repro_torch.kernels import range_max as kmax  # noqa: E402

CAP, FILL = 4096, 3072
# (variant, label, the whole kernel: held to the plain version)
K3_VARIANTS = (
    (0, "K3 before (one thread a query, runtime degree, binary searches)",
     True),
    (1, "K3 shipped (two threads a query, template degree, seg_lo's search "
        "tree)", True),
    (11, "k3_variant at the shipped shape", True),
    (5, "two threads a query, binary searches (the first redesign)", True),
    (2, "one thread a query, binary searches", True),
    (6, "two threads, binary searches, stationary points from a table", True),
    (13, "two threads, the tree, stationary points from a table", True),
    (7, "two threads, binary searches over seg_lo staged in shared memory",
     True),
    (10, "breakdown: the endpoints' loads and the writes alone", False),
    (3, "breakdown: and the binary searches", False),
    (4, "breakdown: and the rows and boundary maxima", False),
    (12, "breakdown: the tree's searches in place of the binary ones", False),
    (14, "breakdown: the tree, and the rows and boundary maxima", False),
    (9, "the binary searches alone, one thread a query", False),
    (8, "the binary searches alone, seg_lo staged", False))
K11_VARIANTS = ((0, "K11 before (every level, one thread a corner)", 1),
                (1, "K11 shipped", None),
                (2, "set bits, 1 level at a time, 1 thread a corner", 1),
                (3, "set bits, 2 levels at a time, 1 thread a corner", 1),
                (4, "set bits, 4 levels at a time, 1 thread a corner", 1),
                (5, "set bits, 1 level at a time, 2 threads a corner", 2),
                (6, "set bits, 2 levels at a time, 2 threads a corner (the "
                    "shipped shape)", 2),
                (7, "set bits, 4 levels at a time, 2 threads a corner", 2),
                (8, "set bits, 1 level at a time, 4 threads a corner", 4),
                (9, "set bits, 2 levels at a time, 4 threads a corner", 4))


def stationary_table(coeffs):
    """(H, 4) rows (lin, r1, r2, code) of a segment table's rows at its
    type: the stationary points of P by clipped_poly_max's expressions,
    code bit 0 where lin holds (|c2| > 0; else the kernel takes ua), bit 1
    where r1 and r2 do (|c3| > 0 and disc >= 0; else they are lin)."""
    deg = coeffs.shape[1] - 1
    sp = torch.zeros((coeffs.shape[0], 4), dtype=coeffs.dtype,
                     device=coeffs.device)
    if deg < 2:
        return sp
    c1 = coeffs[:, 1]
    c2 = 2.0 * coeffs[:, 2]
    sp[:, 0] = -c1 / torch.where(c2 == 0, 1.0, c2)
    code = (torch.abs(c2) > 0).to(coeffs.dtype)
    if deg == 3:
        c3 = 3.0 * coeffs[:, 3]
        disc = c2 * c2 - 4.0 * c3 * c1
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        den = torch.where(torch.abs(c3) > 0, 2.0 * c3, 1.0)
        sp[:, 1] = (-c2 - sq) / den
        sp[:, 2] = (-c2 + sq) / den
        code = code + 2 * ((torch.abs(c3) > 0) & (disc >= 0)).to(coeffs.dtype)
    sp[:, 3] = code
    return sp


def tiled(plan, copies, dev):
    """A MAX plan's live segments ``copies`` times over, each copy shifted
    past the last: (seg_lo, seg_hi, coeffs, st) padded to a multiple of the
    plan's 512 rows as build_plan pads them, and the key shift."""
    h = plan.h
    lo, hi, cf = plan.seg_lo[:h], plan.seg_hi[:h], plan.coeffs[:h]
    agg = plan.st[0, :h]
    span = float(hi[-1] - lo[0]) + 1.0
    big = big_sentinel(torch.float64)
    lo = torch.cat([lo + k * span for k in range(copies)])
    hi = torch.cat([hi + k * span for k in range(copies)])
    cf = torch.cat([cf] * copies)
    st = torch.as_tensor(build_sparse_table(torch.cat([agg] * copies)
                                            .cpu().numpy()), device=dev)
    return (pad_to_multiple(lo, plan.bh, big), pad_to_multiple(hi, plan.bh, big),
            pad_to_multiple(cf, plan.bh, 0.0), st), span


def same_bits(a, b):
    return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(a[~torch.isnan(a)], b[~torch.isnan(b)]))


def k3_tables(dev):
    """[(label, (lq, uq, seg_lo, seg_hi, coeffs, st))] at the smoke's
    shapes."""
    t, v = hki_series(100_000)
    idx = build_index_1d(t, v, "max", deg=3, delta=50.0, device=dev)
    plan = build_plan(idx)
    to = lambda a, dt=torch.float64: torch.as_tensor(a, dtype=dt, device=dev)
    lq, uq = make_queries_1d(t, NQ, seed=SEED)
    clamp = lambda q, lo, dt=torch.float64: torch.maximum(to(q, dt), lo)
    out = [("hki (h %d, Hp %d) float64" % (plan.h, plan.seg_lo.shape[0]),
            (clamp(lq, plan.domain_lo), clamp(uq, plan.domain_lo),
             plan.seg_lo, plan.seg_hi, plan.coeffs, plan.st))]
    f32 = ops.from_index(idx, torch.float32)
    out.append(("hki (h %d, Hp %d) float32" % (plan.h, f32.seg_lo.shape[0]),
                (clamp(lq, f32.seg_lo[0], torch.float32),
                 clamp(uq, f32.seg_lo[0], torch.float32), f32.seg_lo,
                 f32.seg_hi, f32.coeffs, f32.st)))
    (lo, hi, cf, st), span = tiled(plan, 3, dev)
    keys = np.concatenate([t + k * span for k in range(3)])
    lq, uq = make_queries_1d(keys, NQ, seed=SEED)
    out.append(("hki_dyn-like (h %d, Hp %d) float64" % (st.shape[1],
                                                         lo.shape[0]),
                (clamp(lq, lo[0]), clamp(uq, lo[0]), lo, hi, cf, st)))
    return out


def run_k3(lib, tables, ghz, sms, sass):
    for label, args in tables:
        lq, uq, lo, hi, cf, st = args
        f32 = lq.dtype == torch.float32
        st_t = st.to(lq.dtype)
        Q, H, deg, h = lq.shape[0], lo.shape[0], cf.shape[1] - 1, st.shape[1]
        want = kmax.range_max_gather_plain(*args)
        sp = stationary_table(cf)
        tree = search_tree(lo)
        out = torch.empty_like(lq)
        rounds = probe_rounds(H)
        print(f"K3 on {label}: deg {deg}, {rounds} search rounds, same "
              f"segment in {float((torch.searchsorted(lo, lq, right=True) == torch.searchsorted(lo, uq, right=True)).double().mean())!r} of the ranges",
              flush=True)
        for v, name, whole in K3_VARIANTS:
            call = (lambda v=v: lib.k3_run(
                v, int(f32), lq.data_ptr(), uq.data_ptr(), lo.data_ptr(),
                hi.data_ptr(), cf.data_ptr(), st_t.data_ptr(), sp.data_ptr(),
                tree.data_ptr(), out.data_ptr(), Q, H, deg, h, _build.stream(lq.device)))
            _build.check(call(), "k3_run")
            torch.cuda.synchronize()
            held = ("equals the plain version bit for bit: "
                    f"{same_bits(out, want)}" if whole else "partial")
            ms = device_ms(torch, call)
            print(f"  {name}: {ms!r} ms; {held}", flush=True)
        if not f32:
            counts = k3_sass_counts(sass)
            levels = len(tree_levels(H))
            per_q = k3_fp64_per_query(counts, deg, levels)
            b_ms = Q * per_q / (FP64_FLOPS / 2) * 1e3
            alone = sass_fp64(
                sass, r"k3_variantIdLi%dELi2ELi0ELb0ELb0ELb1E" % deg)[0]
            print(f"  FP64-pipe instructions, shipped: {counts[deg]} outside "
                  f"loops a thread, {counts['k1']} of them the unrolled "
                  f"descent (K1's count; the tree's searches alone: "
                  f"{alone}), so {per_q} a query with 4 compares on each of "
                  f"the {levels} levels and the leaf; bound {b_ms!r} ms at "
                  f"{FP64_FLOPS / 2:.3g} FP64 instructions a second",
                  flush=True)
            o, i, d = sass_fp64(sass, r"k3_oldIdE")
            print(f"  FP64-pipe instructions, before: {o} outside loops, "
                  f"{i} in loops ({d} DSETP; its Horner and closed forms "
                  f"loop on the runtime degree)", flush=True)


def k11_logs(dev):
    """osm_min_dyn-like insert logs: (label, (x, ylv, wpmax))."""
    out = []
    for fill in (FILL, CAP):
        px, py = osm_points(fill, seed=11)
        e = DeltaBuffer2D.empty(CAP, device=dev, weighted=True)
        to = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
        x, _, _, ylv, _, wpmax = _append_2d(
            e.ins_x, e.ins_y, e.ins_w, to(px), to(py),
            to(-osm_measure(px, py)), cap=CAP, levels=True, weighted=True)
        out.append((f"{fill} points in {CAP} slots", (x, ylv, wpmax),
                    (px, py)))
    return out


def k11_corners(dev, px, py):
    """NQ corners at live points (20,000 OSM-like base points and the
    log's), a quarter near the hot box."""
    bx, by = osm_points(20_000, seed=3)
    x, y = np.concatenate([bx, px]), np.concatenate([by, py])
    rng = np.random.default_rng(SEED + 730)
    x0, x1, y0, y1 = HOT_BOX
    near = np.flatnonzero((x >= x0 - 1) & (x <= x1 + 1) & (y >= y0 - 1)
                          & (y <= y1 + 1))
    m = NQ // 4
    ci = np.concatenate([rng.integers(0, len(x), NQ - m),
                         near[rng.integers(0, len(near), m)]
                         if len(near) else rng.integers(0, len(x), m)])
    to = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    return to(x[ci]), to(y[ci])


def run_k11(lib, logs, ghz, sms, dev):
    for label, (x, ylv, wpmax), (px, py) in logs:
        u, v = k11_corners(dev, px, py)
        Q, levels = u.shape[0], ylv.shape[0]
        args = (u, v, x, ylv, wpmax)
        want = kdel.delta_dommax2d_gather_plain(*args)
        old, new = k11_loads(torch, args)
        out = torch.empty_like(u)
        print(f"K11 on {label}: {Q} corners; loads a corner {old!r} before, "
              f"{new!r} on the set-bits walk", flush=True)
        for var, name, _ in K11_VARIANTS:
            call = (lambda var=var: lib.k11_run(
                var, u.data_ptr(), v.data_ptr(), x.data_ptr(),
                ylv.data_ptr(), wpmax.data_ptr(), out.data_ptr(), Q, CAP,
                levels, _build.stream(u.device)))
            _build.check(call(), "k11_run")
            torch.cuda.synchronize()
            ok = same_bits(out, want)
            ms = device_ms(torch, call)
            loads = old if var == 0 else new
            rate = Q * loads / (ms * 1e-3) / sms / (ghz * 1e9)
            print(f"  {name}: {ms!r} ms, {rate!r} loads a clock an SM; "
                  f"equals the plain version bit for bit: {ok}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k3_k11_rates: needs an NVIDIA card")
    dev = torch.device("cuda")
    k3_lib, k11_lib = build(("k3_rates", "k11_rates"))
    P, I = ctypes.c_void_p, ctypes.c_int
    k3 = ctypes.CDLL(str(k3_lib))
    k3.k3_run.argtypes = (I, I) + (P,) * 9 + (I,) * 4 + (P,)
    k11 = ctypes.CDLL(str(k11_lib))
    k11.k11_run.argtypes = (I,) + (P,) * 6 + (I,) * 3 + (P,)
    ghz = float(smi("clocks.max.sm").split("\n")[0]) / 1e3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"{smi('name,power.limit')}; {sms} SMs, rates at {ghz} GHz",
          flush=True)
    tools = Path(_build._nvcc()).parent
    sass = subprocess.run([str(tools / "cuobjdump"), "-sass", str(k3_lib)],
                          capture_output=True, text=True).stdout
    run_k3(k3, k3_tables(dev), ghz, sms, sass)
    run_k11(k11, k11_logs(dev), ghz, sms, dev)
    resources(k3_lib, "range_max_gather_kernel|k3_old|k3_variant")
    resources(k11_lib, "dommax2d_gather_kernel|k11_old|k11_variant")


if __name__ == "__main__":
    main()
