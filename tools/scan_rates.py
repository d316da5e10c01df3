"""The rates at which an H100 runs the inner loops of the whole-array scans
K16, K4's scan mode, K15, K12 and K17, apart from their kernels
(``tools/scan_rates.cu``; K15, K12 and K17 as they were before their
redesign too): (query, slot) pairs a clock an SM at full occupancy, against an f64
add alone.  They bound what any block shape of those kernels can reach.
Then, from the compiled code (``cuobjdump -sass``), the instructions of
each loop's innermost body a pair, by opcode.

    python3 tools/scan_rates.py      # on a machine with the card and nvcc

The rates assume the card's maximum SM clock (``nvidia-smi``
clocks.max.sm); the card's name and power limit are printed beside them.
"""
import collections
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import _build  # noqa: E402

SMS, TILE, THREADS, REPS = 132, 1024, 256, 16
# (name, queries a thread) in scan_rates.cu's loop order
LOOPS = (("k16 compare-compare-select-add", (4, 8)),
         ("k4 compare-increment", (4, 8)),
         ("k15 before: one-hot first hits, interior, jmax", (1, 4)),
         ("k15: three compares, two increments, a select", (2, 4, 8)),
         ("k12 before: four corners, first hits", (1, 2)),
         ("k12: two x and two y tests, a select a corner", (1, 2, 4)),
         ("k17 before: two compares, a select, jmax", (1, 4)),
         ("k17: three compares, a predicated move", (4, 8)),
         ("f64 add alone", (4, 8)))
SASS_OPS = ("DSETP", "DMNMX", "DADD", "FSEL", "SEL", "IADD3", "VIADD",
            "PLOP3", "ISETP", "P2R", "MOV", "IMAD", "LDS")


def smi(fields: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                           "--format=csv,noheader,nounits"],
                          capture_output=True, text=True).stdout.strip()


def innermost_loops(sass: str):
    """{(loop, R): opcode counts of its innermost loop body}: the shortest
    span from a branch target to a branch back to it that holds f64
    compares or adds, in each loop_kernel."""
    out = {}
    for block in sass.split("Function : ")[1:]:
        m = re.match(r"\S*loop_kernelILi(\d+)ELi(\d+)E", block)
        if not m:
            continue
        ops, at, spans = [], {}, []
        for line in block.splitlines():
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                at[lab.group(1)] = len(ops)
                continue
            ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                           r"([A-Z0-9_]+)", line)
            if not ins:
                continue
            at[hex(int(ins.group(1), 16))] = len(ops)
            ops.append(ins.group(3))
            tgt = re.search(r"BRA\s+`?\(?(\.L_x_\d+|0x[0-9a-f]+)", line)
            if tgt:
                key = tgt.group(1)
                key = hex(int(key, 16)) if key.startswith("0x") else key
                if key in at and at[key] < len(ops) - 1:
                    spans.append((at[key], len(ops)))
        # the innermost loop that does f64 work (not a staging loop)
        spans = [(a, b) for a, b in spans
                 if any(op.startswith(("DSETP", "DADD")) for op in ops[a:b])]
        if spans:
            a, b = min(spans, key=lambda s: s[1] - s[0])
            out[int(m.group(1)), int(m.group(2))] = \
                collections.Counter(ops[a:b])
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("scan_rates: needs an NVIDIA card")
    out_dir = _build.CSRC / "build" / "tools"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libscan_rates.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(lib_path),
                    str(ROOT / "tools" / "scan_rates.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.scan_rates.argtypes = (I, I, P, P, P, I, I)
    name_limit = smi("name,power.limit")
    ghz = float(smi("clocks.max.sm").split("\n")[0]) / 1e3
    print(f"{name_limit}; rates at {ghz} GHz")
    dev = torch.device("cuda")
    # slots: sorted starts, the next start, a value, an upper y bound
    g = torch.rand((TILE, 4), dtype=torch.float64, device=dev)
    g[:, 0] = torch.sort(g[:, 0])[0]
    g[:-1, 1] = g[1:, 0]
    g[-1, 1] = 2.0
    g[:, 3] += g[:, 2]
    for warps in (16, 32, 64):
        blocks = SMS * warps * 32 // THREADS
        n = blocks * THREADS
        out = torch.empty(n, dtype=torch.float64, device=dev)
        for loop, (label, rs) in enumerate(LOOPS):
            for r in rs:
                q = torch.rand((n * r, 4), dtype=torch.float64, device=dev)
                q[:, 1] += q[:, 0]
                q[:, 3] += q[:, 2]
                args = (loop, r, g.data_ptr(), q.data_ptr(), out.data_ptr(),
                        blocks, REPS)
                _build.check(lib.scan_rates(*args), "scan_rates")
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(5):
                    lib.scan_rates(*args)
                stop.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(stop) / 5
                pairs = n * r * TILE * REPS
                rate = pairs / (ms * 1e-3) / SMS / (ghz * 1e9)
                print(f"{warps} warps an SM, {r} queries a thread, {label}: "
                      f"{ms!r} ms, {rate!r} pairs a clock an SM", flush=True)
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True).stdout
    bodies = innermost_loops(sass)
    print("instructions a pair in each loop's innermost body (8 slots x R "
          "queries a pass):")
    for loop, (label, rs) in enumerate(LOOPS):
        for r in rs:
            ops = bodies.get((loop, r))
            if ops is None:
                print(f"{label}, R {r}: no loop found in the SASS")
                continue
            per = 8 * r
            top = ", ".join(f"{op} {ops[op] / per:g}" for op in SASS_OPS
                            if ops[op])
            print(f"{label}, R {r}: {sum(ops.values()) / per:g} in all; "
                  f"{top}", flush=True)


if __name__ == "__main__":
    main()
