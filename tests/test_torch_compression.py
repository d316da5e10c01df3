"""The port's int8 gradient compression (repro_torch.dist.compression): the
twin of tests/test_compression.py on torch tensors, and the codes and
scales held to the reference's exactly."""
import torch_threads  # noqa: F401  (one intra-op thread per test process)
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

jax.config.update("jax_enable_x64", True)

from repro.dist.compression import quantize_int8 as ref_quantize  # noqa: E402
from repro_torch.dist.compression import (dequantize_int8,  # noqa: E402
                                          quantize_int8)

DTYPES = {torch.float32: jnp.float32, torch.float64: jnp.float64}


@pytest.mark.parametrize("shape", [(16,), (8, 32), (2, 3, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_round_trip_error_bound(shape, dtype):
    """|dequantize(quantize(x)) - x| <= scale/2 elementwise (round-to-
    nearest of symmetric per-tensor quantization)."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(0, 3.0, shape), dtype=dtype)
    q, scale = quantize_int8(x)
    back = dequantize_int8(q, scale, dtype=dtype)
    err = (back - x).abs()
    assert float(err.max()) <= float(scale) / 2 + 1e-7


@pytest.mark.parametrize("shape", [(16,), (8, 32), (2, 3, 5), (1000,)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_codes_and_scale_match_reference(shape, dtype):
    """The same input gives the reference's int8 codes and scale exactly,
    ties at half a step included (both round half to even)."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2.0, shape)
    # amax 127 makes the scale exactly 1: 2.5, -2.5 and 0.5 are ties
    x.reshape(-1)[:4] = [127.0, 2.5, -2.5, 0.5]
    q, scale = quantize_int8(torch.as_tensor(x, dtype=dtype))
    rq, rs = ref_quantize(jnp.asarray(x, DTYPES[dtype]))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert q.dtype == torch.int8
    assert float(scale) == float(rs)


def test_dtype_and_shape_preservation():
    x = torch.as_tensor(np.linspace(-4, 4, 24).reshape(4, 6),
                        dtype=torch.float32)
    q, scale = quantize_int8(x)
    assert q.dtype == torch.int8
    assert q.shape == x.shape
    assert scale.dtype == x.dtype
    assert scale.shape == ()
    for out_dtype in (torch.float32, torch.float64, torch.bfloat16):
        back = dequantize_int8(q, scale, dtype=out_dtype)
        assert back.dtype == out_dtype
        assert back.shape == x.shape


def test_codes_bounded_and_extremes_hit():
    """Codes stay in [-127, 127] and the absolute max maps to +-127."""
    x = torch.tensor([0.5, -2.0, 4.0, -1.0], dtype=torch.float32)
    q, scale = quantize_int8(x)
    assert int(q.min()) >= -127 and int(q.max()) <= 127
    assert int(q[2]) == 127
    np.testing.assert_allclose(float(scale), 4.0 / 127.0, rtol=1e-6)


def test_all_zero_tensor():
    x = torch.zeros((5, 5), dtype=torch.float32)
    q, scale = quantize_int8(x)
    assert float(scale) == 0.0
    assert bool((q == 0).all())
    assert bool((dequantize_int8(q, scale) == 0.0).all())


def test_repeatable_and_symmetry():
    """Repeated calls agree, and quantization is sign-symmetric:
    q(-x) == -q(x)."""
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(0, 1, (32,)), dtype=torch.float32)
    q1, s1 = quantize_int8(x)
    q2, s2 = quantize_int8(x.clone())
    assert torch.equal(q1, q2) and float(s1) == float(s2)
    qneg, sneg = quantize_int8(-x)
    assert torch.equal(qneg, -q2)
    assert float(sneg) == float(s2)
