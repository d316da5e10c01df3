"""Build and bind the CUDA kernels of ``repro_torch/csrc``.

The sources are compiled with plain ``nvcc`` into one shared library with a
C interface and loaded with ``ctypes`` — seconds, where a build through
``torch.utils.cpp_extension`` (PyTorch's headers) takes minutes.  The build
happens at first use, never at import, so the package imports on hosts
without ``nvcc``.  The library lands in ``csrc/build/<hash>/``, keyed by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads at once.

Every launcher takes its pointers and the stream as ``c_void_p`` and its
sizes as ``c_int``, and returns ``cudaGetLastError()``; :func:`check`
raises on a non-zero code.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import torch

__all__ = ["CSRC", "SOURCES", "NVCC_FLAGS", "Build", "build", "library",
           "check", "require_cuda", "stream"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("locate.cuh", "polyfit_kernels.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # q, seg_lo, out, Q, H, stream
    "polyfit_locate": (_P, _P, _P, _I, _I, _P),
    # lq, uq, seg_lo, seg_hi, coeffs, out, Q, H, deg, stream
    "polyfit_range_sum_gather": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # lq, uq, seg_lo, seg_hi, coeffs, st, out, Q, H, deg, h, stream
    "polyfit_range_max_gather": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _P),
    # lq, uq, keys, cf, out, Q, cap, stream
    "polyfit_delta_sum_gather": (_P, _P, _P, _P, _P, _I, _I, _P),
    # lq, uq, keys, st, out, Q, cap, stream
    "polyfit_delta_max_gather": (_P, _P, _P, _P, _P, _I, _I, _P),
}


class Build(NamedTuple):
    path: Path          # the shared library
    seconds: float      # nvcc wall time (0.0 when a cached build was found)
    log: str            # nvcc's output (ptxas register/spill report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


@functools.lru_cache(maxsize=None)
def build() -> Build:
    """Compile the kernels (once per source hash) and return the build."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    out_dir = CSRC / "build" / digest.hexdigest()[:16]
    lib = out_dir / "libpolyfit_kernels.so"
    if lib.exists():
        return Build(lib, 0.0, "")
    out_dir.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builders never load
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / "polyfit_kernels.cu")],
        capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}"
                           f"\n{proc.stderr}")
    os.replace(tmp, lib)
    return Build(lib, seconds, proc.stdout + proc.stderr)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, with every launcher's signature set."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(code: int, name: str) -> None:
    """Raise when a launcher reports a CUDA error."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")


def require_cuda(name: str, *tensors: torch.Tensor,
                 dtype: torch.dtype = torch.float64) -> None:
    """Validate a kernel's tensor arguments before their pointers are taken:
    one CUDA device, ``dtype``, contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: every tensor must be on one CUDA "
                             f"device, got {t.device} and {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def stream(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as a raw handle."""
    return torch.cuda.current_stream(device).cuda_stream
