"""The rates behind K5's and K8's design on the card.

K8 (``tools/k8_rates.cu``): the kernel before its redesign (one thread a
corner, three binary searches, a row of 8-byte loads), the shipped kernel
(two threads a corner, each a coordinate's checked-guess rank, both
searching the leaf code, the row split between them) and the variants it
was chosen from: one thread a corner (two checked guesses, or both in
lockstep), two threads with one lane searching and evaluating, each of
those with the leaf code found by a descent of a search tree over the
codes, and a breakdown of the one-thread and the shipped shape into the
two ranks alone, then the code search, then the row (the whole kernel).
On an ``osm``-like table (100,000 OSM-like points, a quadtree split to
depth 12 where a cell holds more than 100 of them: 2,467 leaves, random
deg-3 rows; ``osm``'s plan has 2,446) and an ``osm_max``-like one (split
above 35 points: 6,112 leaves, random deg-2 rows; ``osm_max``'s plan has
6,187), at 65,536 OSM-like corners and at eight times as many:
milliseconds, loads a corner (``chip_smoke.k8_loads``; the tree variants
with the tree's levels and leaf in place of the code search's rounds) and
loads a clock an SM.

K5 (``tools/k5_rates.cu``): the kernel before its redesign (one thread a
query, two binary searches), the shipped kernel (two threads a query, one
an endpoint, each a binary search) and each endpoint's count by a descent
of the log's search tree (K1's) in its place, at one and at two threads a
query, timed on 4,096-slot logs (4,096 and 3,072 live keys, the dynamic
tables' buffers) and a 131,072-slot log of 4,096 (the window's open
epoch), 65,536 ranges; the tree's build beside them (what every append
would add if a log kept its tree); and the insert and delete
logs of a dynamic SUM batch in one launch (with binary searches or the
trees) against the engine's two launches and a subtraction.

Every whole kernel is held to its plain version bit for bit (NaN equal).
Times are device milliseconds over 20 launches a CUDA graph
(``chip_smoke.device_ms``).  Then each kernel's registers, spills and loads
from ``cuobjdump``.

    python3 tools/k5_k8_rates.py      # on a machine with the card and nvcc

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
from chip_smoke import NQ, call_ms, device_ms, k8_loads, probe_rounds  # noqa: E402
from k7_k17_rates import build, osm_like_table, resources, smi  # noqa: E402
from repro_torch.data import make_queries_2d  # noqa: E402
from repro_torch.engine.dynamic import _append_1d  # noqa: E402
from repro_torch.engine.plan import big_sentinel  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import delta_scan as kdel  # noqa: E402
from repro_torch.kernels import leaf_eval2d as k2d  # noqa: E402
from repro_torch.kernels.locate import search_tree, tree_levels  # noqa: E402

DEPTH = 12
# (variant, label, steps kept: "whole" is held to the plain version, "tree"
# counts the tree's loads) in k8_rates.cu's order; 12 is the shipped
# launcher
K8_VARIANTS = (
    (0, "K8 before (one thread a corner, three binary searches, 8-byte "
        "rows)", "whole"),
    (12, "K8 shipped (two threads a corner, both search, the row split)",
     "whole"),
    (4, "k8_variant at the shipped shape", "whole"),
    (1, "one thread a corner, two checked guesses, 16-byte rows", "whole"),
    (2, "one thread a corner, the guesses in lockstep, 16-byte rows",
     "whole"),
    (3, "two threads a corner, lane 0 searches and evaluates", "whole"),
    (5, "one thread a corner, lockstep, the codes' search tree", "tree"),
    (6, "two threads, lane 0 searches and evaluates, the codes' search "
        "tree", "tree"),
    (7, "two threads, both search, the row split, the codes' search tree",
     "tree"),
    (8, "breakdown, one thread (lockstep): the two ranks alone", "part"),
    (9, "breakdown, one thread (lockstep): and the code search", "part"),
    (10, "breakdown, shipped shape: the two ranks alone", "part"),
    (11, "breakdown, shipped shape: and the code search", "part"))
# (variant, label, held exactly to the plain version)
K5_VARIANTS = (
    (0, "K5 before (one thread a query, two binary searches)"),
    (3, "K5 shipped (two threads a query, a binary search each)"),
    (1, "one thread a query, two descents of the log's search tree"),
    (2, "two threads a query, a descent of the log's search tree each"))
CAP, WINDOW_CAP = 4096, 131_072


def same_bits(a, b):
    return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(a[~torch.isnan(a)], b[~torch.isnan(b)]))


def run_k8(lib, ghz, sms, dev):
    for label, leaf_cap, deg in (
            ("osm-like, deg 3", 100, 3), ("osm_max-like, deg 2", 35, 2)):
        (px, py), root, xcuts, ycuts, leaf_z, bounds, coeffs = \
            osm_like_table(dev, leaf_cap=leaf_cap, deg=deg)
        codes = leaf_z.double()
        tree = search_tree(codes)
        L, nx, ny = leaf_z.shape[0], xcuts.shape[0], ycuts.shape[0]
        _, ux, _, uy = make_queries_2d(px, py, NQ, seed=5)
        base = [torch.as_tensor(np.clip(ux, *root[:2]), device=dev),
                torch.as_tensor(np.clip(uy, *root[2:]), device=dev)]
        print(f"K8 on {label}: {L} leaves, depth {DEPTH}, {nx} x {ny} cuts, "
              f"{probe_rounds(L)} code-search rounds, the codes' tree "
              f"{len(tree_levels(L))} levels", flush=True)
        for scale in (1, 8):
            u, v = (q.repeat(scale) for q in base)
            Q = u.shape[0]
            out = torch.empty(Q, dtype=torch.float64, device=dev)
            args = (u, v, xcuts, ycuts, leaf_z, bounds, coeffs, deg, DEPTH)
            want = k2d.corner_eval2d_gather_plain(*args)
            old, new = k8_loads(torch, args)
            tree_new = new - probe_rounds(L) + len(tree_levels(L)) + 1
            for which, name, kind in K8_VARIANTS:
                if scale > 1 and which not in (0, 12):
                    continue
                call = (lambda which=which: lib.k8_run(
                    which, deg, u.data_ptr(), v.data_ptr(), xcuts.data_ptr(),
                    ycuts.data_ptr(), leaf_z.data_ptr(), codes.data_ptr(),
                    tree.data_ptr(), bounds.data_ptr(), coeffs.data_ptr(),
                    out.data_ptr(), Q, nx, ny, L, DEPTH,
                    _build.stream(dev)))
                out.fill_(float("nan"))
                _build.check(call(), "k8_run")
                torch.cuda.synchronize()
                held = ("partial" if kind == "part" else
                        f"equals the plain version bit for bit: "
                        f"{same_bits(out, want)}")
                ms = device_ms(torch, call)
                loads = (old if which == 0 else
                         tree_new if kind == "tree" else new)
                rate = Q * loads / (ms * 1e-3) / sms / (ghz * 1e9)
                shown = "" if kind == "part" else (
                    f", {loads!r} loads a corner, {rate!r} loads a clock an "
                    "SM")
                print(f"  Q {Q}, {name}: {ms!r} ms{shown}; {held}",
                      flush=True)


def k5_log(dev, fill, cap, seed):
    """(keys, cf): a sorted, sentinel-padded log of ``fill`` keys (ties
    included) in ``cap`` slots, built by the engine's append."""
    rng = np.random.default_rng(seed)
    big = big_sentinel(torch.float64)
    k = np.full(cap, big)
    v = np.zeros(cap)
    k[:fill] = np.round(rng.uniform(0, 1000, fill), 1)
    v[:fill] = rng.normal(0, 50, fill)
    keys, _, cf, _ = _append_1d(
        torch.full((cap,), big, dtype=torch.float64, device=dev),
        torch.zeros(cap, dtype=torch.float64, device=dev),
        torch.as_tensor(k, device=dev), torch.as_tensor(v, device=dev),
        cap=cap, with_st=False)
    return keys, cf


def run_k5(lib, dev):
    rng = np.random.default_rng(41)
    a, b = rng.uniform(-50, 1050, (2, NQ))
    lq = torch.as_tensor(np.minimum(a, b), device=dev)
    uq = torch.as_tensor(np.maximum(a, b), device=dev)
    out = torch.empty(NQ, dtype=torch.float64, device=dev)
    call = lambda which, keys, cf, tree, dk=None, dcf=None, dtree=None: \
        lib.k5_run(which, lq.data_ptr(), uq.data_ptr(), keys.data_ptr(),
                   cf.data_ptr(), tree.data_ptr(),
                   *(0 if t is None else t.data_ptr()
                     for t in (dk, dcf, dtree)),
                   out.data_ptr(), NQ, keys.shape[0], _build.stream(dev))
    logs = {}
    for fill, cap in ((CAP, CAP), (3072, CAP), (1024, CAP),
                      (CAP, WINDOW_CAP)):
        keys, cf = k5_log(dev, fill, cap, seed=fill + cap)
        tree = search_tree(keys)
        logs[fill, cap] = (keys, cf, tree)
        if fill == 1024:
            continue
        want = kdel.delta_sum_gather_plain(lq, uq, keys, cf)
        tree_ms = call_ms(torch, lambda keys=keys: search_tree(keys))
        print(f"K5 on a log of {fill} keys in {cap} slots: "
              f"{probe_rounds(cap)} search rounds, the tree "
              f"{len(tree_levels(cap))} levels and the leaf; building the "
              f"tree (search_tree, eager) {tree_ms!r} ms", flush=True)
        for which, name in K5_VARIANTS:
            out.fill_(float("nan"))
            _build.check(call(which, keys, cf, tree), "k5_run")
            torch.cuda.synchronize()
            ok = same_bits(out, want)
            ms = device_ms(torch, lambda which=which: call(which, keys, cf,
                                                           tree))
            print(f"  {name}: {ms!r} ms; equals the plain version bit for "
                  f"bit: {ok}", flush=True)
    # the insert and the delete log of one batch: the engine's two launches
    # and a subtraction against one launch
    ik, icf, it = logs[3072, CAP]
    dk, dcf, dt = logs[1024, CAP]
    want = (kdel.delta_sum_gather_plain(lq, uq, ik, icf)
            - kdel.delta_sum_gather_plain(lq, uq, dk, dcf))
    two = lambda: (kdel.delta_sum_gather(lq, uq, ik, icf)
                   - kdel.delta_sum_gather(lq, uq, dk, dcf))
    print("K5 on an insert log of 3072 and a delete log of 1024 keys in "
          f"{CAP} slots each:", flush=True)
    print(f"  two launches of the shipped kernel and a subtraction (the "
          f"engine's): {device_ms(torch, two)!r} ms; equals the plain "
          f"versions bit for bit: {same_bits(two(), want)}", flush=True)
    for which, name in ((4, "both logs in one launch, four threads a "
                            "query, binary searches"),
                        (5, "both logs in one launch, four threads a "
                            "query, the logs' search trees")):
        out.fill_(float("nan"))
        _build.check(call(which, ik, icf, it, dk, dcf, dt), "k5_run")
        torch.cuda.synchronize()
        ok = same_bits(out, want)
        ms = device_ms(torch, lambda which=which: call(which, ik, icf, it,
                                                       dk, dcf, dt))
        print(f"  {name}: {ms!r} ms; equals the plain versions bit for "
              f"bit: {ok}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k5_k8_rates: needs an NVIDIA card")
    dev = torch.device("cuda")
    k8_lib, k5_lib = build(("k8_rates", "k5_rates"))
    P, I = ctypes.c_void_p, ctypes.c_int
    k8 = ctypes.CDLL(str(k8_lib))
    k8.k8_run.argtypes = (I, I) + (P,) * 10 + (I,) * 5 + (P,)
    k5 = ctypes.CDLL(str(k5_lib))
    k5.k5_run.argtypes = (I,) + (P,) * 9 + (I, I, P)
    ghz = float(smi("clocks.max.sm").split("\n")[0]) / 1e3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"{smi('name,power.limit')}; {sms} SMs, rates at {ghz} GHz",
          flush=True)
    run_k8(k8, ghz, sms, dev)
    run_k5(k5, dev)
    resources(k8_lib, "corner_eval2d_gather_kernel|k8_old|k8_variant")
    resources(k5_lib, "delta_sum_gather_kernel|k5_old|k5_variant|k5_both")


if __name__ == "__main__":
    main()
