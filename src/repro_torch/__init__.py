"""repro_torch — PolyFit in PyTorch with hand-written CUDA kernels for Hopper.

The twin of ``repro`` (JAX + Pallas): the same modules under the same names,
held to ``repro`` by the ``tests/test_torch_*.py`` parity tests.  Two
package-wide policies live here:

* ``DTYPE``: every index, plan and query runs in float64, as the reference
  does (the minimax certificates mean nothing at float32 for cumulative
  functions reaching 1e8).  Dtypes are passed explicitly; torch's global
  default dtype is never changed.
* ``resolve_device``: entry points run on the card unless the caller names
  another device, and they refuse to fall back to the CPU silently.
"""
from __future__ import annotations

import torch

__all__ = ["DTYPE", "resolve_device"]

DTYPE = torch.float64


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` when ``device`` is None.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or
    by default) and none is available; pass ``device="cpu"`` to run on the
    CPU on purpose.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    return dev
