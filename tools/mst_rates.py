"""The rates behind K9's and K10's design (``tools/mst_rates.cu``) on the
card: the merge-sort-tree walks of K9 before and after its redesign, and of
K10, in probes a clock an SM, on a 4,096-slot insert log of 3,072 OSM-like
points with 65,536 OSM-like rectangles (the shapes ``chip_smoke.py`` times
them at) and on eight times as many rectangles; then a dependent load chain
alone over tables that sit in L1, in L2 and in HBM (its latency at one warp
an SM, and the rate at which an SM serves scattered 8-byte loads at full
occupancy); then each kernel's registers, spills and loads from
``cuobjdump``.

    python3 tools/mst_rates.py      # on a machine with the card and nvcc

The probes of a walk are its loads: the old walk's 4 x (13 + 91) a
rectangle, the new one's two (or four) 13-round x-ranks and l + 1 rounds
for every set bit l of each corner's x-rank, plus for K10 at most one
prefix-sum load a taken level.  The rates assume the card's maximum SM
clock (``nvidia-smi`` clocks.max.sm); the card's name and power limit are
printed beside them.
"""
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.data import make_queries_2d, osm_points  # noqa: E402
from repro_torch.engine import DeltaBuffer2D  # noqa: E402
from repro_torch.engine.dynamic import _append_2d  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import delta_scan as kdel  # noqa: E402

SMS, CAP, FILL, NQ = 132, 4096, 3072, 65_536
# (walk, label, threads a query) in mst_rates.cu's numbering; K10 runs
# walk + 10
WALKS = ((1, "shipped: set bits two levels at a time", 2),
         (2, "set bits two levels at a time", 4),
         (3, "set bits one level after another", 4),
         (4, "set bits one level after another", 2),
         (5, "set bits three levels at a time", 2),
         (6, "set bits, every taken level in lockstep", 4),
         (7, "set bits, every taken level in lockstep, x keys staged", 2))
SHIPPED = 1
TABLES = (("L1", 4096), ("L2", 53_248), ("HBM", 1 << 23))


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


def tree_probes(i: torch.Tensor, levels: int):
    """Per x-rank: the probes of its taken levels' block searches (l + 1
    for every set bit l) and the set bits."""
    bits = torch.stack([(i >> l) & 1 for l in range(levels)])
    rounds = torch.arange(1, levels + 1, device=i.device)[:, None]
    return (bits * rounds).sum(0), bits.sum(0)


def short(mangled: str) -> str:
    """A kernel's name, with walk's template arguments spelled out."""
    m = re.search(r"4walkILN7polyfit7MstModeE(\d)ELi(\d+)ELi(\d+)ELb(\d)E",
                  mangled)
    if m:
        return "walk<%s, NY %s, G %s, staged %s>" % (
            ("kCount", "kSum")[int(m.group(1))], m.group(2), m.group(3),
            ("false", "true")[int(m.group(4))])
    for name in ("k9_old", "delta_count2d_gather_kernel",
                 "delta_sum2d_gather_kernel"):
        if name in mangled:
            return name
    return mangled


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("mst_rates: needs an NVIDIA card")
    out_dir = _build.CSRC / "build" / "tools"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libmst_rates.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(ROOT / "tools" / "mst_rates.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.mst_walk.argtypes = (I,) + (P,) * 8 + (I,) * 3
    lib.mst_chase.argtypes = (I, P, P, I, I, I, I)
    name_limit = smi("name,power.limit")
    ghz = float(smi("clocks.max.sm").split("\n")[0]) / 1e3
    print(f"{name_limit}; rates at {ghz} GHz", flush=True)
    dev = torch.device("cuda")
    to = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)

    bx, by = osm_points(100_000, seed=2)
    base = [to(a) for a in make_queries_2d(bx, by, NQ, seed=5)]
    out = torch.empty(8 * NQ, dtype=torch.float64, device=dev)
    # the 4,096-slot log at the smoke's Q and at 8 Q; then a 1,024-slot log
    # whose levels (88 KB) fit in L1
    for cap, fill, scale in ((CAP, FILL, 1), (CAP, FILL, 8),
                             (CAP // 4, FILL // 4, 8)):
        px, py = osm_points(fill, seed=11)
        e = DeltaBuffer2D.empty(cap, device=dev, weighted=True)
        kx, _, _, ylv, wcum, _ = _append_2d(
            e.ins_x, e.ins_y, e.ins_w, to(px), to(py),
            to(50 + px / 10 - py / 20), cap=cap, levels=True, weighted=True)
        levels = cap.bit_length()
        probe_rounds = (cap - 1).bit_length() + 1
        lx, ux, ly, uy = (q.repeat(scale) for q in base)
        Q = lx.shape[0]
        iu = torch.searchsorted(kx, ux, right=True)
        il = torch.searchsorted(kx, lx, right=True)
        (tu, bu), (tl, bl) = tree_probes(iu, levels), tree_probes(il, levels)
        tree, sets = float(2 * (tu + tl).sum()), float(2 * (bu + bl).sum())
        want = {False: kdel.delta_count2d_gather_plain(lx, ux, ly, uy, kx,
                                                       ylv),
                True: kdel.delta_sum2d_gather_plain(lx, ux, ly, uy, kx, ylv,
                                                    wcum)}
        print(f"cap {cap}, fill {fill}, Q {Q}: mean x-rank {float((iu + il).double().mean()) / 2!r}"
              f", mean set bits a corner {sets / (4 * Q)!r}, mean tree "
              f"probes a corner {tree / (4 * Q)!r} (every level: "
              f"{levels * (levels + 1) // 2})", flush=True)
        runs = [(0, "K9 before: four corners, every level", None)]
        runs += [(w + 10 * k10, f"{'K10' if k10 else 'K9'} {label}, {tpq} "
                  f"threads a query", tpq)
                 for k10 in (False, True)
                 for w, label, tpq in WALKS
                 if cap == CAP or w == SHIPPED]
        for walk, label, shape in runs:
            k10 = walk >= 10
            args = (walk, lx.data_ptr(), ux.data_ptr(), ly.data_ptr(),
                    uy.data_ptr(), kx.data_ptr(), ylv.data_ptr(),
                    wcum.data_ptr(), out.data_ptr(), Q, cap, levels)
            _build.check(lib.mst_walk(*args), "mst_walk")
            torch.cuda.synchronize()
            same = torch.equal(out[:Q].view(torch.int64),
                               want[k10].view(torch.int64))
            ms = timed_ms(lambda: lib.mst_walk(*args))
            if shape is None:
                probes = Q * 4 * (probe_rounds + levels * (levels + 1) // 2)
            else:
                probes = (Q * shape * probe_rounds + tree
                          + (sets if k10 else 0.0))
            rate = probes / (ms * 1e-3) / SMS / (ghz * 1e9)
            print(f"  {label}: {ms!r} ms, {probes / Q!r} probes a query, "
                  f"{rate!r} probes a clock an SM; equals its plain version "
                  f"bit for bit: {same}", flush=True)

    # a dependent chain alone: j = next[j] over a random cycle
    sink = torch.zeros(1, dtype=torch.int64, device=dev)
    for where, span in TABLES:
        perm = torch.randperm(span, device=dev)
        nxt = torch.empty(span, dtype=torch.int64, device=dev)
        nxt[perm] = torch.roll(perm, -1)
        for warps, r, steps in ((1, 1, 4096), (64, 1, 512), (64, 4, 256),
                                (64, 16, 128)):
            threads = 256 if warps >= 8 else 32 * warps
            blocks = SMS * warps * 32 // threads
            args = (r, nxt.data_ptr(), sink.data_ptr(), span, steps, blocks,
                    threads)
            _build.check(lib.mst_chase(*args), "mst_chase")
            ms = timed_ms(lambda: lib.mst_chase(*args), reps=5)
            loads = blocks * threads * r * steps
            rate = loads / (ms * 1e-3) / SMS / (ghz * 1e9)
            lat = ms * 1e-3 * ghz * 1e9 / steps
            print(f"chase over {span * 8} bytes ({where}), {warps} warps an "
                  f"SM, {r} chains a thread: {ms!r} ms, {lat!r} clocks a "
                  f"step, {rate!r} loads a clock an SM", flush=True)

    # registers, spills and loads of each kernel
    tools = Path(_build._nvcc()).parent
    res = subprocess.run([str(tools / "cuobjdump"), "-res-usage",
                          str(lib_path)], capture_output=True,
                         text=True).stdout
    sass = subprocess.run([str(tools / "cuobjdump"), "-sass", str(lib_path)],
                          capture_output=True, text=True).stdout
    for m in re.finditer(r"Function (\S*(?:walk|k9_old|gather_kernel)\S*):"
                         r"\s*\n?\s*"
                         r"(REG:\d+ STACK:\d+ SHARED:\d+ LOCAL:\d+)", res):
        print(f"{short(m.group(1))}: {m.group(2)}", flush=True)
    for block in sass.split("Function : ")[1:]:
        name = block.split()[0]
        if not re.search("walk|k9_old|gather_kernel", name):
            continue
        ops = re.findall(r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z0-9_]+)", block, re.M)
        count = lambda p: sum(op.startswith(p) for op in ops)
        print(f"{short(name)}: {len(ops)} instructions, LDG {count('LDG')}, LDS "
              f"{count('LDS')}, LDL {count('LDL')}, STL {count('STL')}, BRA "
              f"{count('BRA')}", flush=True)


if __name__ == "__main__":
    main()
