"""repro_torch.kernels.locate against repro.kernels.locate: the branch-free
binary search, segment location (against ``locate_pallas`` in interpret
mode) and the sparse-table range max, on boundary endpoints, duplicate
keys and sentinel-padded tails.  The K1 kernel itself is held to this plain
version on the card by tests/test_torch_cuda.py."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

jax.config.update("jax_enable_x64", True)

import repro.core  # noqa: E402,F401  (turns on x64 before any reference call)
from repro.core.exact import build_sparse_table  # noqa: E402
from repro.engine.plan import big_sentinel  # noqa: E402
from repro.kernels import locate as rloc  # noqa: E402
from repro_torch.kernels import locate as tloc  # noqa: E402


@pytest.mark.parametrize("n", [1, 2, 3, 17, 256, 1000])
@pytest.mark.parametrize("side", ["left", "right"])
def test_bsearch_count_matches_reference(n, side):
    rng = np.random.default_rng(n)
    keys = np.sort(rng.uniform(0, 100, n))
    q = np.concatenate([rng.uniform(-10, 110, 199), keys[: min(n, 50)],
                        [keys[0], keys[-1], -1e30, 1e30]])
    got = tloc.bsearch_count(torch.as_tensor(keys), torch.as_tensor(q),
                             side=side).numpy()
    want = np.asarray(rloc.bsearch_count(jnp.asarray(keys), jnp.asarray(q),
                                         side=side))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.searchsorted(keys, q, side=side))
    assert got.dtype == np.int32


def test_bsearch_count_duplicate_keys():
    keys = np.array([1.0, 3.0, 3.0, 3.0, 7.0, 7.0, 9.0])
    q = np.array([3.0, 7.0, 0.0, 9.0, 10.0])
    for side in ("left", "right"):
        got = tloc.bsearch_count(torch.as_tensor(keys), torch.as_tensor(q),
                                 side=side).numpy()
        want = np.asarray(rloc.bsearch_count(jnp.asarray(keys),
                                             jnp.asarray(q), side=side))
        np.testing.assert_array_equal(got, want)


def _boundary_case():
    """Endpoints exactly on seg_lo boundaries, straddling them, below and
    above the domain, against a table whose tail is sentinel padding."""
    rng = np.random.default_rng(0)
    seg = np.sort(rng.uniform(0, 100, 37))
    padded = np.concatenate([seg, np.full(512 - 37, big_sentinel(np.float64))])
    q = np.concatenate([seg, seg - 1e-9, seg + 1e-9,
                        [-1e9, seg[0] - 1.0, seg[-1] + 1.0, 1e9],
                        rng.uniform(-5, 105, 141)])
    return np.pad(q, (0, (-len(q)) % 256), constant_values=seg[0]), padded


def test_locate_matches_locate_pallas_on_boundaries_and_sentinel_tail():
    q, padded = _boundary_case()
    want = np.asarray(rloc.locate_pallas(jnp.asarray(q), jnp.asarray(padded),
                                         bq=256))
    plain = tloc.locate_segments(torch.as_tensor(padded), torch.as_tensor(q))
    np.testing.assert_array_equal(plain.numpy(), want)
    # the K1 wrapper takes its plain version on CPU tensors, launching nothing
    before = tloc.locate.launches
    got = tloc.locate(torch.as_tensor(q), torch.as_tensor(padded))
    np.testing.assert_array_equal(got.numpy(), want)
    assert tloc.locate.launches == before


@pytest.mark.parametrize("n", [1, 5, 64, 1000])
def test_rmq_gather_matches_reference(n):
    rng = np.random.default_rng(100 + n)
    st = build_sparse_table(rng.normal(0, 10, n))
    i0 = rng.integers(0, n + 2, 300).astype(np.int32)
    i1 = rng.integers(0, n + 1, 300).astype(np.int32)   # many empty spans
    want = np.asarray(rloc.rmq_gather(jnp.asarray(st), jnp.asarray(i0),
                                      jnp.asarray(i1)))
    got = tloc.rmq_gather(torch.as_tensor(st), torch.as_tensor(i0),
                          torch.as_tensor(i1)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.all(np.isneginf(got[i1 <= i0]))


def test_floor_log2_matches_reference():
    length = np.arange(0, 5000, dtype=np.int32)
    want = np.asarray(rloc.floor_log2(jnp.asarray(length), 14))
    got = tloc.floor_log2(torch.as_tensor(length), 14).numpy()
    np.testing.assert_array_equal(got, want)
