"""The rates behind K1's and K20's design on the card.

K1 (``tools/k1_rates.cu``): the binary search before the redesign and the
shipped descent of the keys' search tree, on 4,096, 32,768, 200,000 and
1,000,768 sorted keys (rounded, so runs of duplicates) at 65,536 queries
drawn over the keys' range (every tenth one a key itself, a few NaN and
+-inf): device milliseconds (20 launches a CUDA graph), sector loads a
query from each kernel's code (a probe a round; a node a level and the
leaf) and loads a clock an SM.  The small sizes fit in L1 and isolate the
launch gap and the dependent chain from the L2 loads.  ``torch.searchsorted``
is timed beside them.

K20 (``tools/k20_rates.cu``): the kernel before its redesign, the shipped
kernel (1,024-slot tiles) and two other shapes of it (512-slot tiles; 2
queries a thread),
and K17 (``tools/k17_rates.cu``, the one-key twin of its walk) on 4,096-slot
logs of 3,072 and 4,096 live slots and on one with a NaN measure in every
tile, at 65,536 corners: milliseconds (events around 20 calls) and
(query, live slot) pairs a clock an SM.

Every variant is held to its plain version: K1 bit for bit, K20 in value
(NaN equal).  Then each kernel's registers, spills and loads from
``cuobjdump``.

    python3 tools/k1_k20_rates.py      # on a machine with the card and nvcc

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
from chip_smoke import device_ms, probe_rounds  # noqa: E402
from k7_k17_rates import build, resources, smi, timed_ms  # noqa: E402
from repro_torch.engine.plan import big_sentinel  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import delta_scan as kdel  # noqa: E402
from repro_torch.kernels import locate as kloc  # noqa: E402

NQ, CAP = 65_536, 4096
K1_SIZES = (4096, 32_768, 200_000, 1_000_768)
K20_VARIANTS = ((0, "K20 before"), (1, "K20 shipped"),
                (2, "K20, 512-slot tiles"), (3, "K20, 2 queries a thread"))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k1_k20_rates: needs an NVIDIA card")
    k1_path, k20_path, k17_path = build(("k1_rates", "k20_rates",
                                         "k17_rates"))
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    k1 = ctypes.CDLL(str(k1_path))
    k1.k1_run.argtypes = (I,) + (P,) * 4 + (I, I, P)
    k20 = ctypes.CDLL(str(k20_path))
    k20.k20_run.argtypes = (I,) + (P,) * 7 + (I, I, D, P)
    k17 = ctypes.CDLL(str(k17_path))
    k17.k17_run.argtypes = (I,) + (P,) * 6 + (I, I, D)
    name_limit = smi("name,power.limit")
    ghz = float(smi("clocks.max.sm").split("\n")[0]) / 1e3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"{name_limit}; rates at {ghz} GHz, {sms} SMs", flush=True)
    dev = torch.device("cuda")
    per_clock = lambda n, ms: n / (ms * 1e-3) / sms / (ghz * 1e9)
    stream = lambda: torch.cuda.current_stream().cuda_stream

    # -- K1 ------------------------------------------------------------------
    rng = np.random.default_rng(11)
    for n in K1_SIZES:
        keys = np.sort(np.round(rng.uniform(0, n / 4, n)))   # ~4 a value
        q = rng.uniform(-10, n / 4 + 10, NQ)
        q[::10] = keys[rng.integers(0, n, len(q[::10]))]
        q[1:40:8] = (np.nan, np.inf, -np.inf, keys[0], keys[-1])
        keys_t = torch.as_tensor(keys, device=dev)
        q_t = torch.as_tensor(q, device=dev)
        tree = kloc.search_tree(keys_t)
        levels = len(kloc.tree_levels(n))
        out = torch.empty(NQ, dtype=torch.int32, device=dev)
        want = kloc.locate_segments(keys_t, q_t)
        print(f"K1 keys {n}: tree {tuple(tree.shape)}, {levels} levels, "
              f"{tree.numel() * 8} bytes beside {n * 8} of keys", flush=True)
        for which, label, loads in ((0, "K1 before (binary search)",
                                     probe_rounds(n)),
                                    (1, "K1 shipped (search tree)",
                                     levels + 1)):
            run = lambda: _build.check(k1.k1_run(
                which, q_t.data_ptr(), keys_t.data_ptr(), tree.data_ptr(),
                out.data_ptr(), NQ, n, stream()), "k1_run")
            out.fill_(-1)
            run()
            torch.cuda.synchronize()
            same = torch.equal(out, want)
            ms = device_ms(torch, run)
            print(f"K1 keys {n}, {label}: {ms!r} ms, {loads} sector loads "
                  f"a query, {per_clock(NQ * loads, ms)!r} loads a clock an "
                  f"SM; equals the plain version bit for bit: {same}",
                  flush=True)
        ms = device_ms(torch, lambda: torch.searchsorted(keys_t, q_t,
                                                         right=True))
        print(f"K1 keys {n}, torch.searchsorted: {ms!r} ms", flush=True)

    # -- K20 -----------------------------------------------------------------
    big = big_sentinel(torch.float64)
    u = rng.uniform(-50, 1050, NQ)
    v = rng.uniform(-50, 1050, NQ)
    u[-4:], v[-4:] = (np.inf, big, np.nan, 2000.0), (np.inf, big, 5.0, big)
    u, v = (torch.as_tensor(a, device=dev) for a in (u, v))
    out = torch.empty(NQ, dtype=torch.float64, device=dev)
    part = torch.empty((4, NQ), dtype=torch.float64, device=dev)
    for live, nan in ((3072, False), (4096, False), (3072, True)):
        x = np.full(CAP, big)
        y = np.full(CAP, big)
        w = np.zeros(CAP)
        x[:live] = np.sort(rng.uniform(0, 1000, live))
        y[:live] = rng.uniform(0, 1000, live)
        w[:live] = -np.abs(rng.normal(0, 50, live)) - 1.0   # a MIN table's
        if nan:
            w[:live:512] = np.nan
        x, y, w = (torch.as_tensor(a, device=dev) for a in (x, y, w))
        want = kdel.delta_dommax2d_plain(u, v, x, y, w)
        tag = f"log {live} live of {CAP}{', a NaN a tile' if nan else ''}"
        for which, label in K20_VARIANTS:
            args = (which, u.data_ptr(), v.data_ptr(), x.data_ptr(),
                    y.data_ptr(), w.data_ptr(), out.data_ptr(),
                    part.data_ptr(), NQ, CAP, big, None)
            out.fill_(0.5)
            _build.check(k20.k20_run(*args), "k20_run")
            torch.cuda.synchronize()
            same = bool(torch.isclose(out, want, rtol=0, atol=0,
                                      equal_nan=True).all())
            ms = timed_ms(lambda: k20.k20_run(*args))
            print(f"{tag}, {label}: {ms!r} ms, {per_clock(NQ * live, ms)!r} "
                  f"(query, live slot) pairs a clock an SM, "
                  f"{per_clock(NQ * CAP, ms)!r} over every slot; equals the "
                  f"plain version: {same}", flush=True)
        lq = torch.minimum(u, v).nan_to_num(0.0)
        uq = torch.maximum(u, v).nan_to_num(0.0)
        args = (1, lq.data_ptr(), uq.data_ptr(), x.data_ptr(), w.data_ptr(),
                out.data_ptr(), part.data_ptr(), NQ, CAP, big)
        _build.check(k17.k17_run(*args), "k17_run")
        ms = timed_ms(lambda: k17.k17_run(*args))
        print(f"{tag}, K17 on the x keys and measures: {ms!r} ms, "
              f"{per_clock(NQ * live, ms)!r} (query, live slot) pairs a "
              f"clock an SM", flush=True)

    resources(k1_path, "k1_old|locate_tree")
    resources(k20_path, "k20_old|delta_dommax2d")


if __name__ == "__main__":
    main()
