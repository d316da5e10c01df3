"""The rates behind K2's and K6's design on the card.

K2 (``tools/k2_rates.cu``): the kernel before its redesign (one thread a
query, two binary searches, the degree a runtime argument), the shipped
kernel (two threads a query, one an endpoint, each endpoint's segment by a
descent of seg_lo's search tree, the row in registers, Horner at the
template degree, a shuffle to the uq thread) and every form it was chosen
from: one or two threads a query, the binary search or the tree, the
runtime or the template degree.  On segment tables in a plan's layout
(``k14_k18_rates.segment_table``) at the shapes of ``chip_smoke.py``'s
plans: ``lat`` (40 live segments of 512, deg 2), ``lat_dyn`` (103 of 512),
an ``hki_dyn``-like table (2,295 of 2,560, deg 3) and ``lat`` at float32,
each at 65,536 ranges clamped into the domain.  Beside them, the time of
``search_tree`` (what every plan build adds for the tree; eager) at each
Hp, and the shipped kernel at deg 5 and 10 (an instantiated degree and
the runtime-degree form), held to the plain version only.

K6 (``tools/k6_rates.cu``): the kernel before its redesign (one thread a
query, both searches, both sparse-table loads), the shipped kernel (two
threads a query, one search loop for both endpoints, the uq thread alone
takes the sparse-table step: unsplit) and its variants (split: each
thread one of the sparse table's two loads, a shuffle of the left one;
split with the two searches as two diverging loops; one thread a query
with the two searches in lockstep), on 4,096-slot logs of 4,096 and
3,072 live keys with their sparse tables (the dynamic MAX/MIN tables'
buffers), 65,536 ranges.

Every whole kernel is held to its plain version bit for bit (NaN equal),
on the timed ranges and on edge lanes.  Times are device milliseconds over
20 launches a CUDA graph (``chip_smoke.device_ms``).  Then each kernel's
registers, spills and loads from ``cuobjdump``.

    python3 tools/k2_k6_rates.py      # on a machine with the card and nvcc

The card's name and power limit are printed beside the times.
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
from chip_smoke import NQ, call_ms, device_ms, probe_rounds  # noqa: E402
from k14_k18_rates import ranges, segment_table  # noqa: E402
from k5_k8_rates import same_bits  # noqa: E402
from k7_k17_rates import build, resources, smi  # noqa: E402
from repro_torch.engine.dynamic import _append_1d  # noqa: E402
from repro_torch.engine.plan import big_sentinel  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import delta_scan as kdel  # noqa: E402
from repro_torch.kernels import range_sum as ksum  # noqa: E402
from repro_torch.kernels.locate import search_tree, tree_levels  # noqa: E402

# (label, live segments, padded rows, deg, dtype)
K2_TABLES = (("lat-like", 40, 512, 2, torch.float64),
             ("lat_dyn-like", 103, 512, 2, torch.float64),
             ("hki_dyn-like", 2295, 2560, 3, torch.float64),
             ("lat-like float32", 40, 512, 2, torch.float32))
# (which, label) in k2_rates.cu's order: 2 + (bit 0 two threads, bit 1 the
# tree, bit 2 the template degree)
K2_VARIANTS = (
    (0, "K2 before (one thread a query, binary searches, runtime degree)"),
    (1, "K2 shipped (two threads a query, seg_lo's search tree, template "
        "degree)"),
    (9, "k2_variant at the shipped shape (two threads, tree, template)"),
    (7, "two threads, binary search, template degree"),
    (5, "two threads, tree, runtime degree"),
    (3, "two threads, binary search, runtime degree"),
    (8, "one thread, tree, template degree"),
    (6, "one thread, binary search, template degree"),
    (4, "one thread, tree, runtime degree"),
    (2, "one thread, binary search, runtime degree (k2_old's body)"))
K6_VARIANTS = (
    (0, "K6 before (one thread a query, two searches, both sparse-table "
        "loads)"),
    (1, "K6 shipped (two threads a query, one search loop, the uq thread "
        "takes both sparse-table loads)"),
    (2, "k6_variant at the shipped shape (unsplit)"),
    (3, "two threads, the sparse-table step split over the pair"),
    (4, "two threads, split, the two searches as diverging loops"),
    (5, "one thread a query, the two searches in lockstep"))
CAP = 4096


def run_k2(lib, dev):
    for label, live, n, deg, dt in K2_TABLES:
        table = segment_table(dev, live, n, deg, dt)
        lo, _, hi, cf = table
        tree = search_tree(lo)
        (lq, uq), (el, eu) = ranges(table, dev)
        f32 = int(dt == torch.float32)
        tree_ms = call_ms(torch, lambda: search_tree(lo))
        print(f"K2 on a {label} table: {live} live segments of {n}, deg "
              f"{deg}, {dt}; {probe_rounds(n)} search rounds, the tree "
              f"{len(tree_levels(n))} levels and the leaf; building the tree "
              f"(search_tree, eager) {tree_ms!r} ms", flush=True)
        for which, name in K2_VARIANTS:
            def call(a, b, out, which=which):
                return lib.k2_run(which, f32, a.data_ptr(), b.data_ptr(),
                                  lo.data_ptr(), hi.data_ptr(), cf.data_ptr(),
                                  tree.data_ptr(), out.data_ptr(),
                                  a.shape[0], n, deg, _build.stream(dev))
            ok = True
            for a, b in ((lq, uq), (el, eu)):
                out = torch.full_like(a, float("nan"))
                _build.check(call(a, b, out), "k2_run")
                torch.cuda.synchronize()
                ok &= same_bits(out, ksum.range_sum_gather_plain(a, b, lo,
                                                                 hi, cf))
            out = torch.empty_like(lq)
            ms = device_ms(torch, lambda: call(lq, uq, out))
            print(f"  {name}: {ms!r} ms; equals the plain version bit for "
                  f"bit: {ok}", flush=True)
    # the shipped kernel at another instantiated degree and at the runtime
    # degree form (deg 10), on the lat_dyn-like shape: held only
    for deg in (5, 10):
        table = segment_table(dev, 103, 512, deg, torch.float64)
        lo, _, hi, cf = table
        _, (el, eu) = ranges(table, dev)
        got = ksum.range_sum_gather(el, eu, lo, hi, cf, search_tree(lo))
        print(f"K2 shipped at deg {deg}: equals the plain version bit for "
              f"bit: {same_bits(got, ksum.range_sum_gather_plain(el, eu, lo, hi, cf))}",
              flush=True)


def k6_log(dev, fill, seed):
    """(keys, st): a sorted, sentinel-padded 4,096-slot log of ``fill`` keys
    (ties included) and its sparse table, built by the engine's append."""
    rng = np.random.default_rng(seed)
    big = big_sentinel(torch.float64)
    k = np.full(CAP, big)
    v = np.zeros(CAP)
    k[:fill] = np.round(rng.uniform(0, 1000, fill), 1)
    v[:fill] = rng.normal(0, 50, fill)
    keys, _, _, st = _append_1d(
        torch.full((CAP,), big, dtype=torch.float64, device=dev),
        torch.zeros(CAP, dtype=torch.float64, device=dev),
        torch.as_tensor(k, device=dev), torch.as_tensor(v, device=dev),
        cap=CAP, with_st=True)
    return keys, st


def run_k6(lib, dev):
    rng = np.random.default_rng(43)
    a, b = rng.uniform(-50, 1050, (2, NQ))
    to = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=dev)
    lq, uq = to(np.minimum(a, b)), to(np.maximum(a, b))
    for fill in (CAP, 3072):
        keys, st = k6_log(dev, fill, seed=fill)
        kh = keys[:fill].cpu().numpy()
        big, nan, inf = big_sentinel(torch.float64), np.nan, np.inf
        # edge lanes: NaN and infinite bounds, the sentinel, endpoints on a
        # key, empty and inverted spans
        el = np.concatenate([[nan, 0.0, nan, -inf, big, 2000.0, 700.0],
                             kh[::7], kh[::5], np.minimum(a, b)[:1001]])
        eu = np.concatenate([[5.0, nan, nan, inf, big, inf, 300.0],
                             kh[::7], kh[::5][::-1], np.full(1001, inf)])
        el, eu = to(el), to(eu)
        print(f"K6 on a log of {fill} keys in {CAP} slots: "
              f"{probe_rounds(CAP)} search rounds, a {tuple(st.shape)} "
              "sparse table", flush=True)
        for which, name in K6_VARIANTS:
            def call(x, y, out, which=which):
                return lib.k6_run(which, x.data_ptr(), y.data_ptr(),
                                  keys.data_ptr(), st.data_ptr(),
                                  out.data_ptr(), x.shape[0], CAP,
                                  _build.stream(dev))
            ok = True
            for x, y in ((lq, uq), (el, eu)):
                out = torch.full_like(x, float("nan"))
                _build.check(call(x, y, out), "k6_run")
                torch.cuda.synchronize()
                ok &= same_bits(out, kdel.delta_max_gather_plain(x, y, keys,
                                                                 st))
            out = torch.empty_like(lq)
            ms = device_ms(torch, lambda: call(lq, uq, out))
            print(f"  {name}: {ms!r} ms; equals the plain version bit for "
                  f"bit: {ok}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k2_k6_rates: needs an NVIDIA card")
    dev = torch.device("cuda")
    k2_lib, k6_lib = build(("k2_rates", "k6_rates"))
    P, I = ctypes.c_void_p, ctypes.c_int
    k2 = ctypes.CDLL(str(k2_lib))
    k2.k2_run.argtypes = (I, I) + (P,) * 7 + (I,) * 3 + (P,)
    k6 = ctypes.CDLL(str(k6_lib))
    k6.k6_run.argtypes = (I,) + (P,) * 5 + (I, I, P)
    print(f"{smi('name,power.limit')}; "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs",
          flush=True)
    run_k2(k2, dev)
    run_k6(k6, dev)
    resources(k2_lib, "range_sum_gather_kernel|k2_old|k2_variant")
    resources(k6_lib, "delta_max_gather_kernel|k6_old|k6_variant")


if __name__ == "__main__":
    main()
