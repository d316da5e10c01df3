"""The rates at which an H100 runs the inner loops of the one-key scans
K16 and K4's scan mode, apart from their kernels (``tools/scan_rates.cu``):
(query, slot) pairs a clock an SM at full occupancy, against an f64 add
alone.  They bound what any block shape of those kernels can reach.

    python3 tools/scan_rates.py      # on a machine with the card and nvcc

The rates assume the card's maximum SM clock (``nvidia-smi``
clocks.max.sm); the card's name and power limit are printed beside them.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import _build  # noqa: E402

SMS, TILE, THREADS, REPS = 132, 1024, 256, 16
LOOPS = ("k16 compare-compare-select-add", "k4 compare-increment",
         "f64 add alone")


def smi(fields: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                           "--format=csv,noheader,nounits"],
                          capture_output=True, text=True).stdout.strip()


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
    g = torch.rand((TILE, 2), dtype=torch.float64, device=dev)
    g[:, 0] = torch.sort(g[:, 0])[0]
    for warps in (16, 32, 64):
        blocks = SMS * warps * 32 // THREADS
        for r in (4, 8):
            n = blocks * THREADS
            q = torch.rand((n * r, 2), dtype=torch.float64, device=dev)
            q[:, 1] += q[:, 0]
            out = torch.empty(n, dtype=torch.float64, device=dev)
            for loop, label in enumerate(LOOPS):
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


if __name__ == "__main__":
    main()
