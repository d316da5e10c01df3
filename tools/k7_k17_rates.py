"""The rates behind K7's and K17's design on the card.

K7 (``tools/k7_rates.cu``): the corner locate-and-gather before its
redesign, each step of the redesign added one at a time (both x and both y
values ranked once, by a checked guess instead of a binary search, the leaf
code searches in lockstep, rows by 16-byte loads, the codes staged in
shared memory) at one, two and four threads a rectangle, and the shipped
kernel, on an OSM-like table (100,000 clustered points, a quadtree split to
depth 12 where a cell holds more than 100 of them, random deg-3 rows: the
shape of ``chip_smoke.py``'s ``osm`` plan) at 65,536 OSM-like rectangles
and at eight times as many: milliseconds, loads a rectangle (from each
variant's code and the guess checks its corners take) and loads a clock an
SM.  Every variant is held to the plain version bit for bit.

K17 (``tools/k17_rates.cu``): the kernel before its redesign, the shipped
kernel and K16 on the same 4,096-slot logs (3,072 and 4,096 live slots,
and one with a NaN measure in every tile) at 65,536 ranges, in (query,
live slot) pairs a clock an SM.  ``tools/scan_rates.py`` times their loops
alone.

Then each kernel's registers, spills and loads from ``cuobjdump``.

    python3 tools/k7_k17_rates.py      # on a machine with the card and nvcc

The rates assume the card's maximum SM clock (``nvidia-smi``
clocks.max.sm); the card's name and power limit are printed beside them.
"""
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
from chip_smoke import cut_rank_loads, probe_rounds  # noqa: E402
from repro_torch.data import make_queries_2d, osm_points  # noqa: E402
from repro_torch.engine.plan import big_sentinel  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import delta_scan as kdel  # noqa: E402
from repro_torch.kernels import leaf_eval2d as k2d  # noqa: E402
from repro_torch.kernels.locate import dyadic_cuts, leaf_morton_codes  # noqa: E402

NQ, DEPTH, DEG, LEAF_CAP = 65_536, 12, 3, 100
# (label, threads a rectangle, guess, lockstep, 16-byte rows, staged codes)
# in k7_rates.cu's kVariants order; the shipped launcher follows them
VARIANTS = (
    ("K7 before: four corners, three searches each", 1, False, False, False,
     False),
    ("shared ranks", 1, False, False, False, False),
    ("+ checked guess", 1, True, False, False, False),
    ("+ lockstep code searches", 1, True, True, False, False),
    ("+ 16-byte rows", 1, True, True, True, False),
    ("+ staged codes", 1, True, True, True, True),
    ("two threads a rectangle, guess, lockstep, 16-byte rows", 2, True, True,
     True, False),
    ("four threads a rectangle, guess, 8-byte rows", 4, True, False, False,
     False),
    ("four threads a rectangle, guess, 16-byte rows, staged codes", 4, True,
     False, True, True),
    ("four threads a rectangle, guess, 16-byte rows, at most 40 registers",
     4, True, False, True, False),
    ("four threads a rectangle, guess, 16-byte rows, at most 32 registers",
     4, True, False, True, False),
    ("shipped: four threads a rectangle, guess, 16-byte rows", 4, True,
     False, True, False))
CAP = 4096


def smi(fields: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                           "--format=csv,noheader,nounits"],
                          capture_output=True, text=True).stdout.strip()


def timed_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def osm_like_table(dev, n=100_000, leaf_cap=LEAF_CAP, deg=DEG):
    """(points, root, xcuts, ycuts, leaf_z, bounds, coeffs): a quadtree over
    n OSM-like points split to depth 12 where a cell holds more than
    ``leaf_cap`` points, its leaves z-sorted, random rows of degree
    ``deg``."""
    px, py = osm_points(n, seed=2)
    root = (float(px.min()), float(px.max()), float(py.min()),
            float(py.max()))
    xc, yc = dyadic_cuts(*root[:2], DEPTH), dyadic_cuts(*root[2:], DEPTH)
    gx = np.concatenate([[root[0]], xc, [root[1]]])
    gy = np.concatenate([[root[2]], yc, [root[3]]])
    ix = np.searchsorted(xc, px, side="right")
    iy = np.searchsorted(yc, py, side="right")
    cells, stack = [], [(0, 0, 1 << DEPTH, np.arange(len(px)))]
    while stack:
        i0, j0, s, idx = stack.pop()
        if len(idx) <= leaf_cap or s == 1:
            cells.append((i0, j0, s))
            continue
        h = s // 2
        right, up = ix[idx] >= i0 + h, iy[idx] >= j0 + h
        for di, dj, m in ((0, 0, ~right & ~up), (h, 0, right & ~up),
                          (0, h, ~right & up), (h, h, right & up)):
            stack.append((i0 + di, j0 + dj, h, idx[m]))
    c = np.array(cells)
    b = np.stack([gx[c[:, 0]], gx[c[:, 0] + c[:, 2]], gy[c[:, 1]],
                  gy[c[:, 1] + c[:, 2]]], axis=1)
    z = leaf_morton_codes(b, xc, yc, DEPTH)
    order = np.argsort(z)
    rng = np.random.default_rng(3)
    to = lambda a: torch.as_tensor(a, device=dev)
    return ((px, py), root, to(xc), to(yc), to(z[order].astype(np.int32)),
            to(b[order]), to(rng.normal(0, 1, (len(c), (deg + 1) ** 2))))


def variant_loads(spec, qs, xcuts, ycuts, L):
    """Mean loads a rectangle of one variant, from its code: the ranks (the
    binary search, or the guess's loads on these corners), four leaf-code
    searches and four rows (20 8-byte or 10 16-byte loads at deg 3); the
    old kernel ranks each of the four corners' x and y."""
    _, tpq, guess, _, vec, _ = spec
    nx, ny = xcuts.shape[0], ycuts.shape[0]
    codes = 4 * probe_rounds(L)
    if spec is VARIANTS[0]:
        return 4 * (probe_rounds(nx) + probe_rounds(ny) + probe_rounds(L)
                    + 20)
    lx, ux, ly, uy = qs
    if guess:
        ranks = float((cut_rank_loads(torch, xcuts, ux)
                       + cut_rank_loads(torch, xcuts, lx)
                       + cut_rank_loads(torch, ycuts, uy)
                       + cut_rank_loads(torch, ycuts, ly)).mean())
    else:
        ranks = 2 * probe_rounds(nx) + 2 * probe_rounds(ny)
    return ranks + codes + 4 * (10 if vec else 20)


def build(units):
    out_dir = _build.CSRC / "build" / "tools"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for unit in units:
        lib = out_dir / f"lib{unit}.so"
        jobs.append((lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(ROOT / "tools" / f"{unit}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    libs = []
    for lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {lib.name}:\n{log}")
        libs.append(lib)
    return libs


def resources(lib_path, pattern):
    """Registers, spills and loads of the kernels whose name matches."""
    tools = Path(_build._nvcc()).parent
    res = subprocess.run([str(tools / "cuobjdump"), "-res-usage",
                          str(lib_path)], capture_output=True,
                         text=True).stdout
    sass = subprocess.run([str(tools / "cuobjdump"), "-sass", str(lib_path)],
                          capture_output=True, text=True).stdout
    for m in re.finditer(r"Function (\S*(?:%s)\S*):\s*\n?\s*"
                         r"(REG:\d+ STACK:\d+ SHARED:\d+ LOCAL:\d+)"
                         % pattern, res):
        print(f"{m.group(1)}: {m.group(2)}", flush=True)
    for block in sass.split("Function : ")[1:]:
        name = block.split()[0]
        if not re.search(pattern, name):
            continue
        ops = re.findall(r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z0-9_.]+)", block, re.M)
        count = lambda p: sum(op.startswith(p) for op in ops)
        print(f"{name}: {len(ops)} instructions, LDG {count('LDG')} "
              f"(LDG.E.128 {count('LDG.E.128')}), LDS {count('LDS')}, SHFL "
              f"{count('SHFL')}, LDL {count('LDL')}, STL {count('STL')}, BRA "
              f"{count('BRA')}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k7_k17_rates: needs an NVIDIA card")
    k7_path, k17_path = build(("k7_rates", "k17_rates"))
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    k7 = ctypes.CDLL(str(k7_path))
    k7.k7_variant.argtypes = (I,) + (P,) * 10 + (I,) * 5
    k17 = ctypes.CDLL(str(k17_path))
    k17.k17_run.argtypes = (I,) + (P,) * 6 + (I, I, D)
    name_limit = smi("name,power.limit")
    ghz = float(smi("clocks.max.sm").split("\n")[0]) / 1e3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"{name_limit}; rates at {ghz} GHz, {sms} SMs", flush=True)
    dev = torch.device("cuda")
    per_clock = lambda n, ms: n / (ms * 1e-3) / sms / (ghz * 1e9)

    # -- K7 ------------------------------------------------------------------
    (px, py), root, xcuts, ycuts, leaf_z, bounds, coeffs = osm_like_table(dev)
    L, nx, ny = leaf_z.shape[0], xcuts.shape[0], ycuts.shape[0]
    base = make_queries_2d(px, py, NQ, seed=5)
    lim = (root[:2], root[:2], root[2:], root[2:])
    base = [torch.as_tensor(np.clip(q, *b), device=dev)
            for q, b in zip(base, lim)]
    print(f"K7 table: {L} leaves, depth {DEPTH}, {nx} x {ny} cuts, deg {DEG}",
          flush=True)
    for scale in (1, 8):
        qs = [q.repeat(scale) for q in base]
        Q = qs[0].shape[0]
        out = torch.empty(Q, dtype=torch.float64, device=dev)
        want = k2d.corner_count2d_gather_plain(*qs, xcuts, ycuts, leaf_z,
                                               bounds, coeffs, DEG, DEPTH)
        for which, spec in enumerate(VARIANTS):
            if scale > 1 and which not in (0, len(VARIANTS) - 1):
                continue
            args = (which, *(q.data_ptr() for q in qs), xcuts.data_ptr(),
                    ycuts.data_ptr(), leaf_z.data_ptr(), bounds.data_ptr(),
                    coeffs.data_ptr(), out.data_ptr(), Q, nx, ny, L, DEPTH)
            out.fill_(float("nan"))
            _build.check(k7.k7_variant(*args), "k7_variant")
            torch.cuda.synchronize()
            same = torch.equal(out.view(torch.int64), want.view(torch.int64))
            ms = timed_ms(lambda: k7.k7_variant(*args))
            loads = variant_loads(spec, qs, xcuts, ycuts, L)
            print(f"Q {Q}, {spec[0]}: {ms!r} ms, {loads!r} loads a "
                  f"rectangle, {per_clock(Q * loads, ms)!r} loads a clock an "
                  f"SM; equals the plain version bit for bit: {same}",
                  flush=True)

    # -- K17 -----------------------------------------------------------------
    big = big_sentinel(torch.float64)
    rng = np.random.default_rng(7)
    a, b = rng.uniform(-50, 1050, (2, NQ))
    lq = torch.as_tensor(np.minimum(a, b), device=dev)
    uq = torch.as_tensor(np.maximum(a, b), device=dev)
    out = torch.empty(NQ, dtype=torch.float64, device=dev)
    part = torch.empty((4, NQ), dtype=torch.float64, device=dev)
    for live, nan in ((3072, False), (4096, False), (3072, True)):
        keys = np.full(CAP, big)
        vals = np.zeros(CAP)
        keys[:live] = np.sort(rng.uniform(0, 1000, live))
        vals[:live] = rng.normal(0, 50, live)
        if nan:
            vals[:live:1024] = np.nan
        keys = torch.as_tensor(keys, device=dev)
        vals = torch.as_tensor(vals, device=dev)
        want = kdel.delta_max_plain(lq, uq, keys, vals)
        for which, label in ((0, "K17 before"), (1, "K17"),
                             (2, "K16 (delta_sum)")):
            args = (which, lq.data_ptr(), uq.data_ptr(), keys.data_ptr(),
                    vals.data_ptr(), out.data_ptr(), part.data_ptr(), NQ,
                    CAP, big)
            _build.check(k17.k17_run(*args), "k17_run")
            torch.cuda.synchronize()
            same = "" if which == 2 else (
                "; equals the plain version: "
                f"{bool(torch.isclose(out, want, rtol=0, atol=0, equal_nan=True).all())}")
            ms = timed_ms(lambda: k17.k17_run(*args))
            print(f"log {live} live of {CAP}{', a NaN a tile' if nan else ''}"
                  f", {label}: {ms!r} ms, {per_clock(NQ * live, ms)!r} "
                  f"(query, live slot) pairs a clock an SM, "
                  f"{per_clock(NQ * CAP, ms)!r} over every slot{same}",
                  flush=True)

    resources(k7_path, "k7_old|variant|corner_count2d_gather_kernel")
    resources(k17_path, "k17_old|delta_max|delta_sum")


if __name__ == "__main__":
    main()
