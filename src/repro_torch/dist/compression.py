"""Gradient compression for cross-replica reduction: symmetric per-tensor
int8 quantization, the twin of ``repro.dist.compression`` on torch tensors.

``quantize_int8`` maps a float tensor to (int8 codes, float scale) with
scale = max|x| / 127, so dequantization error is bounded by scale/2 per
element (round half to even, as ``jnp.round`` rounds).  Symmetric
(zero-point-free) quantization keeps the all-reduce associative: summing
codes then dequantizing equals dequantizing then summing, up to the shared
scale handling.  Both functions run on the tensor's own device with no host
synchronization, so they also run inside a captured CUDA graph.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["quantize_int8", "dequantize_int8"]

_QMAX = 127.0


def quantize_int8(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization.

    Returns (q, scale): q int8 with |q| <= 127, scale a 0-d tensor of x's
    dtype such that |dequantize(q, scale) - x| <= scale/2 elementwise.
    All-zero tensors quantize to zeros with scale 0.
    """
    x = torch.as_tensor(x)
    amax = torch.amax(torch.abs(x)) if x.numel() else x.new_zeros(())
    safe = torch.where(amax > 0, amax, torch.ones_like(amax))
    scale = safe / _QMAX
    q = torch.clamp(torch.round(x / scale), -_QMAX, _QMAX).to(torch.int8)
    return q, torch.where(amax > 0, scale, torch.zeros_like(scale))


def dequantize_int8(q: torch.Tensor, scale,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of ``quantize_int8``: q * scale in the requested dtype."""
    return q.to(dtype) * torch.as_tensor(scale, device=q.device).to(dtype)
