"""The rates behind the designs of K4's gather mode and of K21 on the card.

K4 (``tools/k4_rates.cu``): the kernel before its redesign (one thread a
target, three binary searches over B, every root branch computed, the
snap by a binary search over the padded key grid), the shipped kernel
(three lanes a target, one inversion a lane, the snap by a descent of the
key grid's search tree, each solve computing only the branch it keeps)
and every form it was chosen from: 1, 3 or 4 lanes a target, the binary
search or the tree for the snap, the branches all computed or skipped.  On
quantile tables fitted here like a plan's (sorted keys cut into
equal-count segments, each row the least-squares fit of the cumulative
function at the scaled key, its error the largest miss at the keys, the
tables padded as ``engine.plan.build_plan`` pads them, ``B`` the boundary
array, the key grid padded to 128 with its tree over the live keys): a
``lat_dyn``-like COUNT table (1,000,000 TWEET latitudes, 104 segments of
512 rows, deg 2) and an ``hki_sum``-like SUM table (200,000 HKI prices,
900 segments of 1,024, deg 3), at 65,536 fractions (0, 1 and uniform
draws) as ``execute_quantile`` turns them into targets, and edge targets
(below 0, past the mass, on every segment's top).  Then the FP64-pipe
instructions a target of the shipped kernel, from its SASS and the
probes' (``chip_smoke.sass_fp64``: straight-line code outside loops): each
lane's path is the kernel's code less the unrolled descent, the search's
unrolled rounds and the root branches it does not take; the three lanes'
paths at the branches this data takes (the trigonometric roots where the
cubic's discriminant is <= 0, else Cardano's), the descent's four
compares a level and the leaf, and two compares a round of the search
over B.  At 34 TFLOP/s, which counts an FMA as two, the FP64 pipe issues
1.7e13 lane instructions a second.

K21 (``tools/k21_rates.cu``): the kernel before its redesign (a key a
thread tested against every row of the padded table through shared
tiles), the shipped kernel (a key a thread, #(seg_lo <= q) by a descent of
seg_lo's search tree, the boundary row, the row by 16-byte loads, Horner
at the template degree) and its variants (two keys a thread; the binary
search), on segment tables in a plan's layout
(``k14_k18_rates.segment_table``) of 40 and 103 live segments in 512 rows
(deg 2) and 2,295 in 2,560 (deg 3), at float64 and float32, at 65,536
keys in the domain and edge keys (every start, the sentinel, +inf, NaN).

Every whole kernel is held to its plain version bit for bit (NaN equal).
Times are device milliseconds over 20 launches a CUDA graph
(``chip_smoke.device_ms``).  Then each kernel's registers, spills and
loads from ``cuobjdump``.

    python3 tools/k4_k21_rates.py      # on a machine with the card and nvcc

The card's name and power limit are printed beside the times.
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
from chip_smoke import (FP64_FLOPS, NQ, device_ms, probe_rounds,  # noqa: E402
                        sass_fp64)
from k14_k18_rates import segment_table  # noqa: E402
from k5_k8_rates import same_bits  # noqa: E402
from k7_k17_rates import build, resources, smi  # noqa: E402
from repro_torch.core.quantile import boundary_array, rank_slack  # noqa: E402
from repro_torch.data import hki_series, tweet_latitudes  # noqa: E402
from repro_torch.engine.plan import big_sentinel, pad_to_multiple  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import poly_eval as kpe  # noqa: E402
from repro_torch.kernels import quantile_invert as kq  # noqa: E402
from repro_torch.kernels.locate import (bsearch_count, search_tree,  # noqa: E402
                                        tree_levels)

# (label, agg, keys, live segments, padded rows, deg)
K4_TABLES = (("lat_dyn-like", "count", 1_000_000, 104, 512, 2),
             ("hki_sum-like", "sum", 200_000, 900, 1024, 3))
# (which, label) in k4_rates.cu's order: 2 + (bit 0 the tree, bit 1 skip,
# bits 2-3 lanes 1 / 3 / 4)
K4_VARIANTS = (
    (0, "K4 before (one thread a target, binary searches, every branch)"),
    (1, "K4 shipped (three lanes a target, the tree snap, the branches "
        "skipped)"),
    (9, "k4_variant at the shipped shape (3 lanes, tree, skip)"),
    (7, "3 lanes, tree, every branch"),
    (8, "3 lanes, binary search, skip"),
    (6, "3 lanes, binary search, every branch"),
    (13, "4 lanes, tree, skip"),
    (11, "4 lanes, tree, every branch"),
    (12, "4 lanes, binary search, skip"),
    (10, "4 lanes, binary search, every branch"),
    (5, "1 lane, tree, skip"),
    (3, "1 lane, tree, every branch"),
    (4, "1 lane, binary search, skip"),
    (2, "1 lane, binary search, every branch"),
    (14, "3 lanes, tree, skip, two targets a lane in lockstep"),
    (15, "3 lanes, tree, skip, at least 6 blocks an SM"),
    (16, "3 lanes, tree, skip, at least 7 blocks an SM"),
    (17, "breakdown: 1 lane, tree, skip, no snap"),
    (18, "breakdown: 3 lanes, tree, skip, no snap"),
    (19, "3 lanes, tree, skip, B staged in shared memory"),
    (20, "1 lane, tree, skip, B staged in shared memory"))
# (label, live, padded rows, deg, dtype)
K21_TABLES = (("lat-like", 40, 512, 2, torch.float64),
              ("lat_dyn-like", 103, 512, 2, torch.float64),
              ("hki_dyn-like", 2295, 2560, 3, torch.float64),
              ("lat-like float32", 40, 512, 2, torch.float32),
              ("lat_dyn-like float32", 103, 512, 2, torch.float32),
              ("hki_dyn-like float32", 2295, 2560, 3, torch.float32))
K21_VARIANTS = (
    (0, "K21 before (every row of the padded table, shared tiles)"),
    (1, "K21 shipped (a key a thread, seg_lo's search tree, template "
        "degree)"),
    (4, "k21_variant at the shipped shape (one key, tree)"),
    (5, "two keys a thread, tree"),
    (2, "one key, binary search"),
    (3, "two keys a thread, binary search"))
FP64_LANE_INSTR = FP64_FLOPS / 2


def scale_unit(q, lo, hi):
    span = np.where(hi > lo, hi - lo, 1.0)
    return np.clip((2.0 * q - lo - hi) / span, -1.0, 1.0)


def quantile_table(dev, agg, nkeys, live, H, deg):
    """The tables ``execute_quantile`` hands K4, fitted here (module
    docstring), and the plan's meta: (tables, h, n, delta, M)."""
    if agg == "count":
        keys, w = np.sort(tweet_latitudes(nkeys)), np.ones(nkeys)
    else:
        t, v = hki_series(nkeys)
        order = np.argsort(t, kind="stable")
        keys, w = t[order], v[order]
    F = np.cumsum(w)
    cuts = np.linspace(0, nkeys, live + 1).astype(int)
    lo, hi = keys[cuts[:-1]], keys[cuts[1:] - 1]
    cf, err = np.zeros((live, deg + 1)), np.zeros(live)
    for s in range(live):
        a, b = cuts[s], cuts[s + 1]
        u = scale_unit(keys[a:b], lo[s], hi[s])
        c = np.polynomial.polynomial.polyfit(u, F[a:b], deg)
        cf[s] = c
        err[s] = np.abs(np.polynomial.polynomial.polyval(u, c) - F[a:b]).max()
    delta = float(err.max())
    big = big_sentinel(torch.float64)
    pad = lambda x, v: torch.as_tensor(
        np.concatenate([x, np.full((H - live, *x.shape[1:]), v)]),
        dtype=torch.float64, device=dev)
    seg_lo, seg_hi, coeffs, seg_err = (pad(lo, big), pad(hi, big),
                                       pad(cf, 0.0), pad(err, delta))
    live_keys = torch.as_tensor(keys, device=dev)
    grid = pad_to_multiple(live_keys, 128, big)
    tables = (boundary_array(coeffs), seg_lo, seg_hi, coeffs, seg_err, grid,
              search_tree(live_keys))
    return tables, live, nkeys, delta, float(F[-1])


def k4_targets(dev, agg, M, hi_keys, seed=7):
    """(t_mid, t_lo, t_hi) for NQ fractions as execute_quantile forms them
    (0, 1, uniform draws), and the same with edge targets in front: below
    0, past the mass, the fitted value at every segment's top."""
    rng = np.random.default_rng(seed)
    fr = np.concatenate([[0.0, 1.0], rng.uniform(0.0, 1.0, NQ - 2)])
    Mt = torch.tensor(M, dtype=torch.float64, device=dev)
    slack = rank_slack(agg, Mt)
    t = torch.as_tensor(fr, device=dev) * Mt
    edge = torch.as_tensor(np.concatenate([[-5.0, -1e-9, M * 1.01, M + 3.0,
                                            M * 2.0], hi_keys]), device=dev)
    te = torch.cat([edge, t])
    return (t, t - slack, t + slack), (te, te - slack, te + slack)


def disc_three(c, T):
    """Per lane whether the cubic P(u) = T takes the trigonometric branch
    (its discriminant <= 0, as csrc/quantile.cu roots_cubic computes it);
    a zero leading coefficient counts as the quadratic's (False)."""
    a, b, cc, d = c[:, 3], c[:, 2], c[:, 1], c[:, 0] - T
    p = (3.0 * a * cc - b * b) / (3.0 * a * a)
    q = (2.0 * (b * b * b) - 9.0 * a * b * cc + 27.0 * a * a * d) / (
        27.0 * (a * a * a))
    disc = (q * q) * 0.25 + (p * p * p) * (1.0 / 27.0)
    return (disc <= 0) & (a.abs() > 0)


def k4_branch_shares(targets, tables, h, delta):
    """The share of each side's solves on the trigonometric branch."""
    B, _, _, coeffs, seg_err = tables[:5]
    shares = {}
    for side, t in zip(("mid", "lo", "hi"), targets):
        if side == "hi":
            s = bsearch_count(B, t + delta, side="left")
        elif side == "lo":
            s = bsearch_count(B, t - delta, side="right")
        else:
            s = bsearch_count(B, t, side="left")
        s = torch.clamp(s, max=h - 1).long()
        T = {"mid": t, "lo": t - seg_err[s], "hi": t + seg_err[s]}[side]
        shares[side] = float(disc_three(coeffs[s], T).double().mean())
    return shares


def k4_fp64(sass, deg, H, n, shares):
    """FP64-pipe instructions a target of the shipped kernel at ``deg``
    (module docstring): (per target, the counts it came from)."""
    out = lambda pat: sass_fp64(sass, pat)[0]
    kernel = out(rf"quantile_invert_kernelILi{deg}E")
    search, descent = out("k4_probe_search"), out("k4_probe_descent")
    base = kernel - search - descent
    if deg == 3:
        full = out(r"k4_probe_rootsILi0E")
        trig, card = out(r"k4_probe_rootsILi1E"), out(r"k4_probe_rootsILi2E")
        lane = {s: base - full + sh * trig + (1 - sh) * card
                for s, sh in shares.items()}
        parts = dict(kernel=kernel, search=search, descent=descent,
                     roots=full, trig=trig, cardano=card)
    else:
        full, quad = out(r"k4_probe_rootsILi3E"), out(r"k4_probe_rootsILi4E")
        lane = {s: base - full + quad for s in shares}
        parts = dict(kernel=kernel, search=search, descent=descent,
                     roots=full, quadratic=quad)
    per_target = (sum(lane.values()) + 3 * 2 * probe_rounds(H)
                  + 4 * (len(tree_levels(n)) + 1))
    return per_target, parts


def run_k4(lib, dev, sass):
    for label, agg, nkeys, live, H, deg in K4_TABLES:
        tables, h, n, delta, M = quantile_table(dev, agg, nkeys, live, H, deg)
        B, seg_lo, seg_hi, coeffs, seg_err, grid, tree = tables
        nk = grid.shape[0]
        hi_top = (coeffs[:h].sum(dim=1)).cpu().numpy()
        targets, edges = k4_targets(dev, agg, M, hi_top)
        kw = dict(h=h, n=n, delta=delta)
        print(f"K4 on a {label} table: {agg}, {n} keys (grid {nk}), {h} "
              f"segments of {H}, deg {deg}, delta {delta!r}; "
              f"{probe_rounds(H)} search rounds over B, "
              f"{probe_rounds(nk)} over the grid, the tree "
              f"{len(tree_levels(n))} levels and the leaf", flush=True)
        for which, name in K4_VARIANTS:
            def call(tt, outs, which=which):
                ptrs = [x.data_ptr() for x in (*tt, *tables[:5], grid, tree,
                                               *outs)]
                return lib.k4_run(which, *ptrs, tt[0].shape[0], H, deg, h,
                                  nk, n, delta, _build.stream(dev))
            ok = True
            for tt in (targets, edges):
                outs = torch.full((3, tt[0].shape[0]), float("nan"),
                                  dtype=torch.float64, device=dev)
                _build.check(call(tt, outs), "k4_run")
                torch.cuda.synchronize()
                want = kq.quantile_invert_plain(*tt, *tables[:5], grid, **kw)
                ok &= all(same_bits(g, w) for g, w in zip(outs, want))
            outs = torch.empty((3, NQ), dtype=torch.float64, device=dev)
            ms = device_ms(torch, lambda: call(targets, outs))
            held = ("not held (a breakdown)" if name.startswith("breakdown")
                    else f"equals the plain version bit for bit: {ok}")
            print(f"  {name}: {ms!r} ms; {held}", flush=True)
        shares = k4_branch_shares(targets, tables, h, delta) if deg == 3 \
            else {"mid": 0.0, "lo": 0.0, "hi": 0.0}
        per, parts = k4_fp64(sass, deg, H, n, shares)
        print(f"  FP64 pipe, shipped kernel: {per!r} lane instructions a "
              f"target (SASS outside loops {parts}; trigonometric share by "
              f"side {shares}), {per * NQ / FP64_LANE_INSTR * 1e3!r} ms at "
              f"{NQ} targets", flush=True)


def k21_keys(table, dev):
    """NQ keys in the domain, and the same with the edge keys in front:
    every start, the sentinel, +inf, NaN."""
    lo = table[0]
    dt = lo.dtype
    big = big_sentinel(dt)
    live = int((lo < big).sum())
    rng = np.random.default_rng(11)
    q = torch.as_tensor(rng.uniform(0, 1000, NQ), dtype=dt, device=dev)
    edge = torch.cat([lo[:live], torch.tensor([big, np.inf, np.nan, 1000.0],
                                              dtype=dt, device=dev)])
    return q, torch.cat([edge, q])


def run_k21(lib, dev):
    for label, live, H, deg, dt in K21_TABLES:
        lo, nx, hi, cf = segment_table(dev, live, H, deg, dt)
        tree = search_tree(lo)
        q, qe = k21_keys((lo, nx, hi, cf), dev)
        rows = torch.unique(torch.clamp(bsearch_count(lo, q) - 1, min=0))
        f32 = int(dt == torch.float32)
        print(f"K21 on a {label} table: {live} live segments of {H}, deg "
              f"{deg}, {dt}; the tree {len(tree_levels(H))} levels and the "
              f"leaf; {rows.numel()} rows touched by the {NQ} keys",
              flush=True)
        for which, name in K21_VARIANTS:
            def call(x, out, which=which):
                return lib.k21_run(which, f32, x.data_ptr(), lo.data_ptr(),
                                   nx.data_ptr(), hi.data_ptr(),
                                   cf.data_ptr(), tree.data_ptr(),
                                   out.data_ptr(), x.shape[0], H, deg,
                                   _build.stream(dev))
            ok = True
            for x in (q, qe):
                out = torch.full_like(x, float("nan"))
                _build.check(call(x, out), "k21_run")
                torch.cuda.synchronize()
                ok &= same_bits(out, kpe.poly_eval_plain(x, lo, nx, hi, cf))
            out = torch.empty_like(q)
            ms = device_ms(torch, lambda: call(q, out))
            print(f"  {name}: {ms!r} ms; equals the plain version bit for "
                  f"bit: {ok}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k4_k21_rates: needs an NVIDIA card")
    dev = torch.device("cuda")
    k4_lib, k21_lib = build(("k4_rates", "k21_rates"))
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    k4 = ctypes.CDLL(str(k4_lib))
    k4.k4_run.argtypes = (I,) + (P,) * 13 + (I,) * 6 + (D, P)
    k21 = ctypes.CDLL(str(k21_lib))
    k21.k21_run.argtypes = (I, I) + (P,) * 7 + (I,) * 3 + (P,)
    print(f"{smi('name,power.limit')}; "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs",
          flush=True)
    sass = subprocess.run(
        [str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass",
         str(k4_lib)], capture_output=True, text=True, check=True,
        timeout=300).stdout
    run_k4(k4, dev, sass)
    run_k21(k21, dev)
    resources(k4_lib, "quantile_invert_kernel|k4_old|k4_variant|k4_shape")
    resources(k21_lib, "segment_eval_kernel|k21_old|k21_variant")


if __name__ == "__main__":
    main()
