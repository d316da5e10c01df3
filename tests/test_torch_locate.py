"""repro_torch.kernels.locate against repro.kernels.locate: the branch-free
binary search, segment location (against ``locate_pallas`` in interpret
mode) and the sparse-table range max, on boundary endpoints, duplicate
keys and sentinel-padded tails; and K1's search tree (``search_tree``)
with its plain descent (``tree_count``), held to the binary search and to
``locate_pallas`` on tables either side of a leaf's, a node's and a
level's size, and its strict twin (``tree_count_left``, K4's snap) held
to ``torch.searchsorted`` and the reference's binary search.  The K1 kernel itself is held to these plain versions on
the card by tests/test_torch_cuda.py."""
import torch_threads  # noqa: F401  (one intra-op thread per test process)
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


# K1's search tree: sizes either side of a full leaf (4 keys), a full node
# (5 children) and a level (25 leaves), and larger tables
TREE_SIZES = [1, 2, 3, 4, 5, 6, 24, 25, 26, 4097, 3000]


def _tree_case(n):
    """n sorted keys with runs of duplicates (a sentinel-padded tail from 24
    keys on), and queries on every key, the next doubles either side of
    every key, NaN, +-inf and random values (padded to a multiple of 128
    with the first key).  The keys start at 1, so no query is subnormal:
    XLA on the CPU flushes those to zero, which ``locate_pallas`` would
    then count as 0.0."""
    rng = np.random.default_rng(200 + n)
    keys = np.sort(np.round(rng.uniform(1, 51, n)))
    if n >= 24:
        keys[-(n // 8):] = big_sentinel(np.float64)
    q = np.concatenate([keys, np.nextafter(keys, -np.inf),
                        np.nextafter(keys, np.inf),
                        [np.nan, -np.inf, np.inf, -0.0],
                        rng.uniform(-5, 55, 300)])
    return keys, np.pad(q, (0, (-len(q)) % 128), constant_values=keys[0])


@pytest.mark.parametrize("n", TREE_SIZES)
def test_search_tree_walk_matches_bsearch_and_locate_pallas(n):
    """The descent of ``search_tree`` counts #(keys <= q) as the binary
    search does in every lane (NaN 0), and max(count - 1, 0) equals the
    reference's ``locate_pallas``; the tree holds n / 16 nodes or so, each
    a sorted run of separators with NaN only after the last child."""
    keys, q = _tree_case(n)
    kt, qt = torch.as_tensor(keys), torch.as_tensor(q)
    tree = tloc.search_tree(kt)
    got = tloc.tree_count(kt, tree, qt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  tloc.bsearch_count(kt, qt).numpy())
    want = np.asarray(rloc.locate_pallas(jnp.asarray(q), jnp.asarray(keys),
                                         bq=len(q)))
    np.testing.assert_array_equal(np.maximum(got.numpy() - 1, 0), want)
    t = tree.numpy()
    assert t.shape == (sum(tloc.tree_levels(n)), 4) and t.shape[0] <= n
    filled = ~np.isnan(t)
    assert (filled[:, :1] | ~filled.any(axis=1, keepdims=True)).all()
    assert (filled[:, :-1] >= filled[:, 1:]).all()   # NaN only at the end
    with np.errstate(invalid="ignore"):   # inf - inf past the last child
        steps = np.diff(np.where(filled, t, np.inf), axis=1)
    assert (steps[filled[:, 1:]] >= 0).all()


def test_search_tree_levels_at_the_main_path_sizes():
    """8 internal levels over lat_dyn's 1,000,768 keys and 7 over lat's
    200,000: with the leaf, 9 and 8 sector loads a query."""
    assert len(tloc.tree_levels(1_000_768)) == 8
    assert len(tloc.tree_levels(200_000)) == 7
    assert tloc.tree_levels(4) == [] and tloc.tree_levels(5) == [1]
    assert tloc.search_tree(torch.zeros(4, dtype=torch.float64)).shape == (
        0, 4)


@pytest.mark.parametrize("n", TREE_SIZES)
def test_tree_count_left_matches_searchsorted(n):
    """The strict descent (``tree_count_left``, K4's snap to the key grid)
    counts #(keys < q) as ``torch.searchsorted(..., right=False)`` does on
    sorted keys with runs of duplicates and a sentinel tail, at counts that
    leave partial leaves and nodes, on every key, the doubles either side
    of each, +-inf and -0.0; a NaN query counts 0, as the binary search
    counts it (searchsorted puts NaN above every key).  The reference's
    binary search with side='left' agrees in every lane."""
    keys, q = _tree_case(n)
    kt, qt = torch.as_tensor(keys), torch.as_tensor(q)
    tree = tloc.search_tree(kt)
    got = tloc.tree_count_left(kt, tree, qt)
    assert got.dtype == torch.int32
    nan = torch.isnan(qt)
    want = torch.searchsorted(kt, qt, right=False).to(torch.int32)
    assert torch.equal(got[~nan], want[~nan])
    assert nan.any() and torch.equal(got[nan], torch.zeros_like(got[nan]))
    assert torch.equal(got, tloc.bsearch_count(kt, qt, side="left"))
    ref = np.asarray(rloc.bsearch_count(jnp.asarray(keys), jnp.asarray(q),
                                        side="left"))
    np.testing.assert_array_equal(got.numpy(), ref)
