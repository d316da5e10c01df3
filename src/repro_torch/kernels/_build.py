"""Build and bind the CUDA kernels of ``repro_torch/csrc``.

Each translation unit in ``UNITS`` is compiled with plain ``nvcc`` into a
shared library with a C interface, all units at once in parallel, and
loaded with ``ctypes`` — seconds, where a build through
``torch.utils.cpp_extension`` (PyTorch's headers) takes minutes.  The build
happens at first use, never at import, so the package imports on hosts
without ``nvcc``.  The libraries land in ``csrc/build/<hash>/``, keyed by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads at once.

Every launcher takes its pointers and the stream as ``c_void_p``, its sizes
as ``c_int`` and its float scalars as ``c_double``, and returns
``cudaGetLastError()``; :func:`check` raises on a non-zero code.
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

__all__ = ["CSRC", "SOURCES", "UNITS", "NVCC_FLAGS", "Build", "build",
           "library", "check", "require_cuda", "float_dtype", "launcher",
           "stream", "sentinel"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("locate.cuh", "scan_tile.cuh", "polyfit_kernels.cu",
           "quantile.cu", "leaf_eval2d.cu", "delta2d.cu", "scan1d.cu",
           "scan2d.cu")
# translation units: one shared library each, compiled in parallel
UNITS = ("polyfit_kernels.cu", "quantile.cu", "leaf_eval2d.cu", "delta2d.cu",
         "scan1d.cu", "scan2d.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    # q, keys, tree, out, Q, n, stream; ``tree`` the keys' search tree
    # (kernels/locate.py search_tree)
    "polyfit_locate": (_P, _P, _P, _P, _I, _I, _P),
    # lq, uq, seg_lo, seg_hi, coeffs, tree, out, Q, H, deg, stream;
    # ``tree`` seg_lo's search tree
    "polyfit_range_sum_gather": (_P,) * 7 + (_I,) * 3 + (_P,),
    # lq, uq, seg_lo, seg_hi, coeffs, st, tree, out, Q, H, deg, h, stream;
    # ``tree`` seg_lo's search tree
    "polyfit_range_max_gather": (_P,) * 8 + (_I,) * 4 + (_P,),
    # lq, uq, keys, cf, out, Q, cap, stream
    "polyfit_delta_sum_gather": (_P, _P, _P, _P, _P, _I, _I, _P),
    # lq, uq, keys, st, out, Q, cap, stream
    "polyfit_delta_max_gather": (_P, _P, _P, _P, _P, _I, _I, _P),
    # t_mid, t_lo, t_hi, B, seg_lo, seg_hi, coeffs, seg_err, ref_keys,
    # tree, out_mid, out_lo, out_hi, Q, H, deg, h, n, delta, stream;
    # ``tree`` the search tree of ref_keys[:n]
    "polyfit_quantile_invert": (_P,) * 13 + (_I,) * 5 + (_D, _P),
    # K4's scan mode: t_mid ... ref_keys, out_mid, out_lo, out_hi, an int32
    # (S + 2, Q) scratch ``part``, S = polyfit_quantile_scan_chunks(nk),
    # Q, H, deg, h, nk, n, delta, stream
    "polyfit_quantile_invert_scan": (_P,) * 13 + (_I,) * 6 + (_D, _P),
    "polyfit_quantile_scan_chunks": (_I,),
    # lx, ux, ly, uy, xcuts, ycuts, leaf_z, bounds, coeffs, out, Q, nx, ny,
    # L, deg, depth, stream
    "polyfit_corner_count2d_gather": (_P,) * 10 + (_I,) * 6 + (_P,),
    # u, v, xcuts, ycuts, leaf_z, bounds, coeffs, out, Q, nx, ny, L, deg,
    # depth, stream
    "polyfit_corner_eval2d_gather": (_P,) * 8 + (_I,) * 6 + (_P,),
    # lx, ux, ly, uy, mx0, mx1, my0, my1, bounds, coeffs, out, hits, Q, L,
    # deg, sentinel, stream; ``hits`` an (S, 4, Q) int32 scratch,
    # S = polyfit_corner_count2d_chunks(L)
    "polyfit_corner_count2d": (_P,) * 12 + (_I,) * 3 + (_D, _P),
    "polyfit_corner_count2d_chunks": (_I,),
    # u, v, mx0, mx1, my0, my1, bounds, coeffs, out, hits, Q, L, deg,
    # sentinel, stream; ``hits`` an (S, Q) int32 scratch,
    # S = polyfit_corner_eval2d_chunks(L)
    "polyfit_corner_eval2d": (_P,) * 10 + (_I,) * 3 + (_D, _P),
    "polyfit_corner_eval2d_chunks": (_I,),
    # lx, ux, ly, uy, kx, ylv, out, Q, cap, levels, stream
    "polyfit_delta_count2d_gather": (_P,) * 7 + (_I,) * 3 + (_P,),
    # lx, ux, ly, uy, kx, ylv, wcum, out, Q, cap, levels, stream
    "polyfit_delta_sum2d_gather": (_P,) * 8 + (_I,) * 3 + (_P,),
    # u, v, kx, ylv, wpmax, out, Q, cap, levels, stream
    "polyfit_delta_dommax2d_gather": (_P,) * 6 + (_I,) * 3 + (_P,),
    # lq, uq, seg_lo, seg_next, seg_hi, coeffs, out, Q, H, deg, sentinel,
    # stream
    "polyfit_range_sum": (_P,) * 7 + (_I,) * 3 + (_D, _P),
    # lq, uq, seg_lo, seg_next, seg_hi, coeffs, seg_agg, out, cnt, part, Q,
    # H, deg, sentinel, stream; ``cnt`` a (2S, Q) int32 and ``part`` an
    # (S, Q) scratch, S = polyfit_range_max_chunks(H)
    "polyfit_range_max": (_P,) * 10 + (_I,) * 3 + (_D, _P),
    "polyfit_range_max_chunks": (_I,),
    # lq, uq, keys, vals, out, part, Q, D, sentinel, stream; ``part`` an
    # (S, Q) scratch, S = polyfit_delta_sum_chunks(D)
    "polyfit_delta_sum": (_P,) * 6 + (_I,) * 2 + (_D, _P),
    "polyfit_delta_sum_chunks": (_I,),
    # lq, uq, keys, vals, out, part, Q, D, sentinel, stream; ``part`` an
    # (S, Q) scratch, S = polyfit_delta_max_chunks(D)
    "polyfit_delta_max": (_P,) * 6 + (_I,) * 2 + (_D, _P),
    "polyfit_delta_max_chunks": (_I,),
    # q, seg_lo, seg_next, seg_hi, coeffs, tree, out, Q, H, deg, stream;
    # ``tree`` seg_lo's search tree
    "polyfit_poly_eval": (_P,) * 7 + (_I,) * 3 + (_P,),
    # lx, ux, ly, uy, kx, ky, out, Q, D, sentinel, stream
    "polyfit_delta_count2d": (_P,) * 7 + (_I,) * 2 + (_D, _P),
    # lx, ux, ly, uy, kx, ky, w, out, Q, D, sentinel, stream
    "polyfit_delta_sum2d": (_P,) * 8 + (_I,) * 2 + (_D, _P),
    # u, v, kx, ky, w, out, part, Q, D, sentinel, stream; ``part`` an
    # (S, Q) scratch, S = polyfit_delta_dommax2d_chunks(D)
    "polyfit_delta_dommax2d": (_P,) * 7 + (_I,) * 2 + (_D, _P),
    "polyfit_delta_dommax2d_chunks": (_I,),
}
# the float32 instantiations (kernels/ops.py's float32 plans) take the
# arguments of their float64 twins
for _name in ("polyfit_range_sum_gather", "polyfit_range_max_gather",
              "polyfit_range_sum", "polyfit_range_max", "polyfit_poly_eval"):
    _SIGNATURES[_name + "_f32"] = _SIGNATURES[_name]


class Build(NamedTuple):
    paths: tuple        # the shared libraries, one per unit
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
    """Compile the kernels (once per source hash) and return the build:
    one ``nvcc`` per unit, all started together."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    out_dir = CSRC / "build" / digest.hexdigest()[:16]
    libs = tuple(out_dir / f"lib{Path(u).stem}.so" for u in UNITS)
    if all(lib.exists() for lib in libs):
        return Build(libs, 0.0, "")
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for unit, lib in zip(UNITS, libs):
        # compile to a private name, then rename: a concurrent build never
        # loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / unit)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((unit, lib, tmp, proc))
    logs, failed = [], []
    for unit, lib, tmp, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"== {unit}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{unit} ({proc.returncode})")
            os.unlink(tmp)
        else:
            os.replace(tmp, lib)
    seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n"
                           + "\n".join(logs))
    return Build(libs, seconds, "\n".join(logs))


class _Library:
    """The launchers of every unit's library, as attributes."""

    def __init__(self, cdlls):
        for name, argtypes in _SIGNATURES.items():
            fn = next((getattr(d, name) for d in cdlls
                       if hasattr(d, name)), None)
            if fn is None:
                raise RuntimeError(f"no kernel library exports {name}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            setattr(self, name, fn)


@functools.lru_cache(maxsize=None)
def library() -> _Library:
    """The loaded kernel libraries, with every launcher's signature set."""
    return _Library([ctypes.CDLL(str(p)) for p in build().paths])


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


def float_dtype(name: str, t: torch.Tensor) -> torch.dtype:
    """The element type of a kernel that has a float32 instantiation:
    float64 or float32, taken from ``t``."""
    if t.dtype not in (torch.float64, torch.float32):
        raise ValueError(f"{name}: expected torch.float64 or torch.float32, "
                         f"got {t.dtype}")
    return t.dtype


def launcher(name: str, dtype: torch.dtype):
    """The launcher ``polyfit_<name>`` for float64 tensors, or its float32
    instantiation ``polyfit_<name>_f32`` (K2, K3, K14, K15 and K21 only)."""
    if dtype == torch.float32:
        name += "_f32"
    return getattr(library(), f"polyfit_{name}")


def stream(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as a raw handle."""
    return torch.cuda.current_stream(device).cuda_stream


def sentinel(dtype: torch.dtype) -> float:
    """The padding value of a plan's tables at ``dtype`` (finfo.max / 4,
    ``engine.plan.big_sentinel``): the whole-table scans K12-K15 stop at
    the first tile that starts on it."""
    return float(torch.finfo(dtype).max) / 4
