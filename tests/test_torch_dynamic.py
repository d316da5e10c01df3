"""repro_torch's dynamic one-key tables against repro's: twins of the 1-D
tests of tests/test_dynamic.py and of
tests/test_api.py::test_dynamic_session_updates.

The same seeded op sequence goes to ``repro.engine.DynamicEngine`` and
``repro_torch.engine.DynamicEngine`` (the reference index carried across
with ``index_from_numpy``): answers agree at rtol = atol = 1e-9 with equal
``refined`` flags and ``refit_count``, and after a flush the merged index
agrees to 1e-9.  The plain versions of kernels K5/K6 are held to
``delta_sum_gather_pallas`` / ``delta_max_gather_pallas`` in interpret
mode and to the one-hot oracles; the kernels themselves are held to the
plain versions on the card by tests/test_torch_cuda.py.
"""
import torch_threads  # noqa: F401  (one intra-op thread per test process)
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

jax.config.update("jax_enable_x64", True)

import repro.api as rapi  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro.core import build_index_1d  # noqa: E402
from repro.engine import DynamicEngine as RDynamicEngine  # noqa: E402
from repro.engine.dynamic import _append_1d as r_append_1d  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.kernels.delta_scan import (delta_max_gather_pallas,  # noqa: E402
                                      delta_sum_gather_pallas)
from repro_torch.core import index_from_numpy  # noqa: E402
from repro_torch.engine import (DynamicEngine, execute_extremum,  # noqa: E402
                                big_sentinel)
from repro_torch.engine.dynamic import DeltaBuffer, _append_1d  # noqa: E402
from repro_torch.kernels.locate import (bsearch_count, floor_log2,  # noqa: E402
                                        rmq_gather)
from repro_torch.kernels import (delta_max_gather, delta_max_gather_plain,  # noqa: E402
                                 delta_max_plain, delta_max_ref,
                                 delta_sum_gather, delta_sum_gather_plain,
                                 delta_sum_ref)

N = 2500
NQ = 256
DELTA = 25.0
CAP = 256
TOL = dict(rtol=1e-9, atol=1e-9)
AGGS = ("sum", "count", "max", "min")
PORT_BACKENDS = ("torch", "ref")
TWIN = {"torch": "xla", "ref": "ref"}   # port backend -> reference twin


def _fields(idx):
    """A reference index's fields as numpy, the shape index_from_numpy
    takes."""
    arr = lambda a: None if a is None else np.asarray(a)
    out = {f: arr(getattr(idx, f)) for f in
           ("seg_lo", "seg_hi", "coeffs", "seg_start", "seg_agg", "st",
            "seg_err")}
    out.update(agg=idx.agg, deg=idx.deg, delta=idx.delta, n=idx.n)
    es, em = idx.exact_sum, idx.exact_max
    out["exact_sum"] = None if es is None else (arr(es.keys), arr(es.cf))
    out["exact_max"] = None if em is None else (
        arr(em.keys), arr(em.measures), arr(em.st))
    return out


def _carry(ridx):
    return index_from_numpy(_fields(ridx), "cpu")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(42)
    keys = np.sort(rng.uniform(0, 600, N))
    meas = rng.uniform(0, 10, N)
    return keys, meas


@pytest.fixture(scope="module")
def updates(data):
    keys, _ = data
    rng = np.random.default_rng(43)
    ins_k = np.concatenate([rng.uniform(0, 600, 56),
                            [-5.0, 610.0]])   # includes out-of-domain keys
    ins_v = rng.uniform(0, 10, len(ins_k))
    del_k = np.unique(keys[rng.integers(0, N, 24)])
    return ins_k, ins_v, del_k


@pytest.fixture(scope="module")
def queries(data):
    keys, _ = data
    rng = np.random.default_rng(44)
    a = keys[rng.integers(0, N, NQ)]
    b = keys[rng.integers(0, N, NQ)]
    return np.minimum(a, b), np.maximum(a, b)


@pytest.fixture(scope="module")
def indexes(data):
    """agg -> reference index (built once; the port gets it carried)."""
    keys, meas = data
    out = {}
    for agg, m, deg in (("sum", meas, 2), ("count", None, 2),
                        ("max", meas * 100, 3), ("min", meas * 100, 3)):
        out[agg] = build_index_1d(keys, m, agg, deg=deg, delta=DELTA)
    return out


def _apply_updates(keys, meas, ins_k, ins_v, del_k):
    """Ground-truth multiset after the updates (first occurrence deleted)."""
    all_k = np.concatenate([keys, ins_k])
    all_v = np.concatenate([meas, ins_v])
    alive = np.ones(len(all_k), bool)
    for k in del_k:
        hit = np.where(alive & (all_k == k))[0]
        alive[hit[0]] = False
    order = np.argsort(all_k[alive], kind="stable")
    return all_k[alive][order], all_v[alive][order]


def _truth_1d(agg, keys, meas, lq, uq):
    """Exact answers with numpy alone: (lq, uq] sums, [lq, uq] extrema."""
    if agg in ("sum", "count"):
        m = np.ones_like(keys) if agg == "count" else meas
        cf = np.concatenate([[0.0], np.cumsum(m)])
        return (cf[np.searchsorted(keys, uq, side="right")]
                - cf[np.searchsorted(keys, lq, side="right")])
    i = np.searchsorted(keys, lq, side="left")
    j = np.searchsorted(keys, uq, side="right")
    red = np.max if agg == "max" else np.min
    return np.array([red(meas[a:b]) for a, b in zip(i, j)])


def _updated_truth(agg, data, updates, lq, uq):
    keys, meas = data
    ins_k, ins_v, del_k = updates
    scale = 100 if agg in ("max", "min") else 1
    uk, uv = _apply_updates(keys, meas * scale, ins_k, ins_v * scale, del_k)
    return _truth_1d(agg, uk, uv, lq, uq)


def _with_updates(dyn, agg, updates):
    ins_k, ins_v, del_k = updates
    if agg == "count":
        dyn.insert(ins_k)
    elif agg in ("max", "min"):
        dyn.insert(ins_k, ins_v * 100)
    else:
        dyn.insert(ins_k, ins_v)
    dyn.delete(del_k)
    return dyn


def _pair(indexes, agg, backend, updates, **kw):
    """(reference engine on the twin backend, port engine) after the same
    updates."""
    kw.setdefault("capacity", CAP)
    kw.setdefault("auto_refit", False)
    ridx = indexes[agg] if isinstance(indexes, dict) else indexes
    r = RDynamicEngine(ridx, backend=TWIN.get(backend, backend), **kw)
    p = DynamicEngine(_carry(ridx), backend=backend, **kw)
    if updates is not None:
        _with_updates(r, agg, updates)
        _with_updates(p, agg, updates)
    return r, p


def _assert_same(got, want):
    np.testing.assert_allclose(got.answer.numpy(), np.asarray(want.answer),
                               **TOL)
    np.testing.assert_array_equal(got.refined.numpy(),
                                  np.asarray(want.refined))


def _assert_same_index(got, want):
    for f in ("seg_lo", "seg_hi", "coeffs", "seg_start"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), **TOL,
                                   err_msg=f)


# ---------------------------------------------------------------------------
# the engine, port against reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("agg", AGGS)
def test_certified_bounds_after_updates(indexes, data, updates, queries,
                                        agg, backend):
    """Lemma 5.1/5.3 hold over the *updated* dataset while the updates sit
    in the delta buffer, and the port answers as the reference does."""
    lq, uq = queries
    r, p = _pair(indexes, agg, backend, updates)
    res = p.query(lq, uq)
    _assert_same(res, r.query(lq, uq))
    truth = _updated_truth(agg, data, updates, lq, uq)
    bound = 2 * DELTA if agg in ("sum", "count") else DELTA
    assert np.max(np.abs(res.answer.numpy() - truth)) <= bound + 1e-6


@pytest.mark.parametrize("agg", AGGS)
def test_cross_backend_equivalence_post_update(indexes, updates, queries,
                                               agg):
    """The port's backends agree with every reference backend (pallas in
    interpret mode) on post-update answers."""
    lq, uq = queries
    want = {}
    for b in ("xla", "pallas", "ref"):
        dyn = RDynamicEngine(indexes[agg], backend=b, capacity=CAP,
                             auto_refit=False)
        want[b] = np.asarray(_with_updates(dyn, agg, updates)
                             .query(lq, uq).answer)
    for b in PORT_BACKENDS:
        dyn = DynamicEngine(_carry(indexes[agg]), backend=b, capacity=CAP,
                            auto_refit=False)
        got = _with_updates(dyn, agg, updates).query(lq, uq).answer.numpy()
        for rb, w in want.items():
            np.testing.assert_allclose(got, w, **TOL, err_msg=f"{b} vs {rb}")


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("agg", AGGS)
def test_qrel_after_updates(indexes, data, updates, queries, agg, backend):
    """The Q_rel refinement keeps the relative bound after updates, with
    the reference's refined flags."""
    lq, uq = queries
    r, p = _pair(indexes, agg, backend, updates)
    eps_rel = 0.05
    res = p.query(lq, uq, eps_rel=eps_rel)
    _assert_same(res, r.query(lq, uq, eps_rel=eps_rel))
    truth = _updated_truth(agg, data, updates, lq, uq)
    ans = res.answer.numpy()
    pos = np.abs(truth) > 0
    rel = np.abs(ans[pos] - truth[pos]) / np.abs(truth[pos])
    assert rel.max() <= eps_rel + 1e-9


@pytest.mark.parametrize("agg", ["sum", "max"])
def test_flush_refits_and_preserves_bounds(indexes, data, updates, queries,
                                           agg):
    """A merge empties the buffer, re-certifies the touched segments, and
    builds the reference's merged index; answers before and after stay
    within the certified bound."""
    lq, uq = queries
    r, p = _pair(indexes, agg, "torch", updates)
    before = p.query(lq, uq)
    assert p.n_pending == r.n_pending > 0
    r.flush()
    p.flush()
    assert p.n_pending == 0
    assert p.refit_count == r.refit_count >= 1
    _assert_same_index(p.index, r.index)
    truth = _updated_truth(agg, data, updates, lq, uq)
    after = p.query(lq, uq)
    _assert_same(after, r.query(lq, uq))
    bound = 2 * DELTA if agg == "sum" else DELTA
    assert np.max(np.abs(after.answer.numpy() - truth)) <= bound + 1e-6
    assert np.max(np.abs(before.answer.numpy() - truth)) <= bound + 1e-6
    assert float(np.max(p.index.seg_err)) <= DELTA + 1e-9


def test_selective_refit_leaves_far_segments_alone(indexes):
    """Only segments whose span contains changed keys are refit; clean SUM
    segments absorb upstream inserts as an exact constant-coefficient
    shift."""
    r, p = _pair(indexes, "sum", "torch", None)
    rng = np.random.default_rng(7)
    ins_k, ins_v = rng.uniform(0, 50, 30), rng.uniform(0, 10, 30)
    for dyn in (r, p):
        dyn.insert(ins_k, ins_v)
    net = float(np.sum(p._ins_log[0][1]))
    old_lo = p.index.seg_lo.numpy()
    old_coeffs = p.index.coeffs.numpy()
    r.flush()
    p.flush()
    _assert_same_index(p.index, r.index)
    new_lo = p.index.seg_lo.numpy()
    new_coeffs = p.index.coeffs.numpy()
    far_old = np.where(old_lo > 100)[0]
    assert len(far_old) > 2
    for i in far_old:
        j = np.searchsorted(new_lo, old_lo[i])
        assert new_lo[j] == old_lo[i]
        np.testing.assert_array_equal(new_coeffs[j, 1:], old_coeffs[i, 1:])
        np.testing.assert_allclose(new_coeffs[j, 0] - old_coeffs[i, 0], net,
                                   rtol=1e-12)


def test_capacity_trigger_auto_refits(indexes, queries):
    r, p = _pair(indexes, "sum", "torch", None, capacity=64, auto_refit=True)
    rng = np.random.default_rng(8)
    for _ in range(3):
        k, v = rng.uniform(0, 600, 40), rng.uniform(0, 10, 40)
        r.insert(k, v)
        p.insert(k, v)
    assert p.refit_count == r.refit_count >= 1
    assert p.n_pending == r.n_pending < 64
    _assert_same(p.query(*queries), r.query(*queries))


def test_drift_trigger_refits_hot_segment(indexes):
    """Accumulated |measure| drift past a segment's error headroom forces a
    merge before the buffer fills."""
    r, p = _pair(indexes, "sum", "torch", None, capacity=1024,
                 auto_refit=True)
    hot = float(p.index.seg_lo[3]) + 1e-9
    for dyn in (r, p):
        dyn.insert(np.full(8, hot), np.full(8, 50.0))
    assert p.refit_count == r.refit_count >= 1
    assert p.n_pending == 0
    _assert_same_index(p.index, r.index)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("agg", ["max", "min"])
def test_extremal_delete_shadows_victim_without_merge(indexes, data, queries,
                                                      agg, backend):
    """A MAX/MIN delete never pays a merge on the write path: the victim is
    shadowed in the buffer, ranges covering it refine against the
    victim-masked exact sparse table, and the next merge applies it."""
    keys, meas = data
    lq, uq = queries
    gone = keys[[10, 500, 2000]]
    r, p = _pair(indexes, agg, backend, None, capacity=128)
    for dyn in (r, p):
        dyn.delete(gone)
    assert p.refit_count == 0 and p.n_pending == 3   # no eager merge
    _, buf = p.snapshot()
    assert buf.vic_keys is not None and buf.live_st is not None
    uk, uv = _apply_updates(keys, meas * 100, np.zeros(0), np.zeros(0), gone)
    truth = _truth_1d(agg, uk, uv, lq, uq)
    for eps_rel in (None, 0.2):
        res = p.query(lq, uq, eps_rel=eps_rel)
        _assert_same(res, r.query(lq, uq, eps_rel=eps_rel))
        assert np.max(np.abs(res.answer.numpy() - truth)) <= DELTA + 1e-6
    # threatened ranges (victim inside) answer exactly
    res = p.query(lq, uq)
    ref = res.refined.numpy()
    assert ref.any()
    assert np.allclose(res.answer.numpy()[ref], truth[ref])
    r.flush()
    p.flush()
    assert p.n_pending == 0 and p.refit_count == r.refit_count == 1
    _assert_same_index(p.index, r.index)
    _, buf = p.snapshot()
    assert buf.vic_keys is None
    res = p.query(lq, uq)
    _assert_same(res, r.query(lq, uq))
    assert np.max(np.abs(res.answer.numpy() - truth)) <= DELTA + 1e-6


def test_extremal_delete_cancels_pending_insert(indexes, queries):
    """Deleting a key that only a pending insert holds cancels the insert
    in place (NaN in the host log) and rebuilds the device insert log."""
    r, p = _pair(indexes, "max", "torch", None)
    for dyn in (r, p):
        dyn.insert([123.456, 321.0], [5000.0, 7000.0])
        dyn.delete([123.456])
    assert p.n_pending == r.n_pending == 1   # the other insert
    _assert_same(p.query(*queries), r.query(*queries))
    np.testing.assert_array_equal(np.isnan(p._ins_log[0][0]),
                                  np.isnan(r._ins_log[0][0]))


def test_background_refit_never_blocks_queries(indexes, data, queries):
    rng = np.random.default_rng(9)
    ins_k = rng.uniform(0, 600, 50)
    ins_v = rng.uniform(0, 10, 50)
    p = DynamicEngine(_carry(indexes["sum"]), capacity=CAP, auto_refit=False,
                      background=True)
    seen = []   # install listeners see the plan before it is installed
    p.add_install_listener(lambda plan: seen.append((plan, p.plan)))
    p.insert(ins_k, ins_v)
    lq, uq = queries
    truth = _updated_truth("sum", data, (ins_k, ins_v, np.zeros(0)), lq, uq)
    old_plan = p.plan
    p.refit(wait=False)   # merge runs on a worker thread
    for _ in range(5):
        ans = p.query(lq, uq).answer.numpy()
        assert np.max(np.abs(ans - truth)) <= 2 * DELTA + 1e-6
    p.refit(wait=True)    # join + surface any merge error
    assert p.refit_count == 1 and p.n_pending == 0
    assert len(seen) == 1
    assert seen[0][0] is p.plan and seen[0][1] is old_plan
    ans = p.query(lq, uq).answer.numpy()
    assert np.max(np.abs(ans - truth)) <= 2 * DELTA + 1e-6


@pytest.mark.parametrize("agg", ["sum", "max"])
def test_writes_racing_background_merges_lose_nothing(indexes, data, queries,
                                                      agg):
    """Inserts and deletes keep arriving while background merges run (a
    small buffer, auto refit, a short switch interval): ops logged after a
    merge's snapshot are replayed into the fresh buffer, extremal deletes
    of pending inserts included, so after a final flush the port answers
    over exactly the updated multiset, as the reference does."""
    keys, meas = data
    scale = 100 if agg == "max" else 1
    kw = dict(capacity=32, auto_refit=True, background=True)
    p = DynamicEngine(_carry(indexes[agg]), **kw)
    r = RDynamicEngine(indexes[agg], backend="xla",
                       **{**kw, "background": False})
    rng = np.random.default_rng(31)
    all_k, all_v, gone = [], [], []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for step in range(12):
            k = rng.uniform(0, 600, 12)
            v = rng.uniform(0, 10, 12) * scale
            dk = keys[rng.choice(N, 3, replace=False)]
            dk = dk[~np.isin(dk, gone)]
            if agg == "max":   # cancels a pending insert of this batch
                dk = np.concatenate([dk, k[:1]])
            for dyn in (p, r):
                dyn.insert(k, v)
                dyn.delete(dk)
            all_k.append(k)
            all_v.append(v)
            gone.extend(dk.tolist())
            p.query(*queries)   # reads race the merge thread too
    finally:
        sys.setswitchinterval(old)
    for dyn in (p, r):
        dyn.flush()
    assert p.n_pending == r.n_pending == 0 and p.refit_count >= 2
    assert p._thread is None
    truth = _truth_1d(agg, *_apply_updates(
        keys, meas * scale, np.concatenate(all_k), np.concatenate(all_v),
        np.array(gone)), *queries)
    res = p.query(*queries)
    bound = 2 * DELTA if agg == "sum" else DELTA
    assert np.max(np.abs(res.answer.numpy() - truth)) <= bound + 1e-6
    np.testing.assert_array_equal(np.sort(p._keys), np.sort(r._keys))


def test_duplicate_deletes_in_one_batch_take_distinct_victims(data):
    """delete([k, k]) tombstones *both* occurrences' measures, not the
    first one twice."""
    keys, meas = data
    k = 300.0
    keys2 = np.sort(np.concatenate([keys, [k, k]]))
    order = np.argsort(np.concatenate([keys, [k, k]]), kind="stable")
    meas2 = np.concatenate([meas, [4.0, 9.0]])[order]
    ridx = build_index_1d(keys2, meas2, "sum", deg=2, delta=DELTA)
    r, p = _pair(ridx, "sum", "torch", None, capacity=64)
    for dyn in (r, p):
        dyn.delete([k, k])
    assert sorted(p._del_log[0][1].tolist()) == [4.0, 9.0]
    np.testing.assert_array_equal(p._del_log[0][1], r._del_log[0][1])
    with pytest.raises(KeyError):
        p.delete([k])   # only two occurrences existed


@pytest.mark.parametrize("agg", ["sum", "max"])
def test_delete_missing_key_raises(indexes, data, agg):
    keys, _ = data
    p = DynamicEngine(_carry(indexes[agg]), capacity=64, auto_refit=False)
    with pytest.raises(KeyError):
        p.delete([keys[0] + 0.123456789])


def test_oversize_batch_raises(indexes):
    p = DynamicEngine(_carry(indexes["sum"]), capacity=64, auto_refit=False)
    with pytest.raises(ValueError, match="capacity"):
        p.insert(np.linspace(0, 600, 100), np.ones(100))


def test_deg4_max_routes_to_torch(data, updates, queries):
    """deg-4 MAX has no closed form in the kernel: the engine routes it to
    the 'torch' path (counted), as the reference routes it to XLA."""
    keys, meas = data
    ridx = build_index_1d(keys, meas * 100, "max", deg=4, delta=DELTA)
    r, p = _pair(ridx, "max", "ref", updates)
    before = execute_extremum.torch_routes
    res = p.query(*queries)
    assert execute_extremum.torch_routes == before + 1
    _assert_same(res, r.query(*queries))


def test_not_ported_and_device_rules(indexes):
    p = DynamicEngine(_carry(indexes["sum"]), capacity=64)
    assert p.backend == "torch"   # the default for an index on the CPU
    # quantiles over dynamic tables are ported (ROADMAP Queue 1 item 11):
    # they answer as the reference engine does
    r = RDynamicEngine(indexes["sum"], capacity=64)
    got, want = p.quantile([0.5]), r.quantile(np.array([0.5]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    with pytest.raises(ValueError, match="does not answer"):
        DynamicEngine(_carry(indexes["max"]), capacity=64).quantile([0.5])
    with pytest.raises(ValueError, match="CUDA device"):
        DynamicEngine(_carry(indexes["sum"]), backend="cuda")
    with pytest.raises(ValueError, match="power of two"):
        DynamicEngine(_carry(indexes["sum"]), capacity=100)


# ---------------------------------------------------------------------------
# the buffer structures and the plain versions of K5/K6
# ---------------------------------------------------------------------------

def _buffers(fill, with_st):
    """A sorted, sentinel-padded log of ``fill`` entries of capacity CAP,
    built by the port's and the reference's append from the same batch."""
    rng = np.random.default_rng(fill)
    big = big_sentinel(torch.float64)
    k = np.round(rng.uniform(-10, 610, fill), 1)   # ties included
    v = rng.normal(0, 10, fill)
    size = max(1, 1 << max(0, fill - 1).bit_length())
    pk = np.full(size, big)
    pv = np.zeros(size)
    pk[:fill], pv[:fill] = k, v
    empty_k, empty_v = np.full(CAP, big), np.zeros(CAP)
    got = _append_1d(torch.as_tensor(empty_k), torch.as_tensor(empty_v),
                     torch.as_tensor(pk), torch.as_tensor(pv), cap=CAP,
                     with_st=with_st)
    want = r_append_1d(jnp.asarray(empty_k), jnp.asarray(empty_v),
                       jnp.asarray(pk), jnp.asarray(pv), cap=CAP,
                       with_st=with_st)
    return got, want


def _delta_queries(seed):
    """Ranges across and outside the log's keys: empty spans (lq == uq on
    and off a key, lq > uq), the sentinel tail, NaN-free."""
    rng = np.random.default_rng(seed)
    a, b = rng.uniform(-30, 630, (2, 192))
    lq = np.concatenate([np.minimum(a, b), [5.0, 100.0, 300.0, -1e300],
                         np.full(28, 700.0), [-50.0] * 16, [200.0] * 16])
    uq = np.concatenate([np.maximum(a, b), [5.0, 100.0, 299.0, 1e300],
                         np.full(28, 1e308), [-20.0] * 16, [200.0] * 16])
    return lq, uq


@pytest.mark.parametrize("with_st", [False, True])
def test_append_matches_reference(with_st):
    """The port's append (stable merge, exclusive prefix sums, sparse
    table) builds the reference's buffer."""
    for fill in (1, 37, CAP):
        got, want = _buffers(fill, with_st)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **TOL)
        if with_st:
            np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        else:
            assert got[3] is None and want[3] is None


def _k5_two_lane(lq, uq, keys, cf):
    """csrc/polyfit_kernels.cu K5 in torch: lane 2q of the grid (256-lane
    blocks) counts the log's keys <= uq of query q by the binary search and
    reads that prefix sum, lane 2q + 1 the same for lq; lanes past Q redo
    the last query; lane 2q writes its value less its partner's (the
    shuffle)."""
    Q = lq.shape[0]
    t = torch.arange(-(-2 * Q // 256) * 256)
    q = torch.clamp(t // 2, max=Q - 1)
    low = (t & 1) == 1
    x = torch.where(low, lq[q], uq[q])
    c = bsearch_count(keys, x, side="right")
    v = cf[c.long()]
    diff = v - v[t ^ 1]
    out = torch.full((Q,), torch.nan, dtype=cf.dtype)
    writes = ~low & (t // 2 < Q)
    out[q[writes]] = diff[writes]
    return out


@pytest.mark.parametrize("fill", [0, 1, 37, CAP])
def test_delta_sum_gather_plain_matches_pallas(fill):
    """K5's plain version against delta_sum_gather_pallas (interpret mode)
    and the one-hot oracles, on an empty, a partly filled and a full log;
    the wrapper takes the plain version on CPU tensors.  K5's two-lane form
    equals the plain version bit for bit, on inverted ranges too."""
    (k, v, cf, _), _ = _buffers(max(fill, 1), False)
    if fill == 0:   # an empty log: all sentinels, flat prefix sums
        k = torch.full((CAP,), big_sentinel(torch.float64),
                       dtype=torch.float64)
        v = torch.zeros(CAP, dtype=torch.float64)
        cf = torch.zeros(CAP + 1, dtype=torch.float64)
    lq, uq = _delta_queries(fill)
    tq = [torch.as_tensor(x) for x in (lq, uq)]
    before = delta_sum_gather.launches
    got = delta_sum_gather(*tq, k, cf)
    assert delta_sum_gather.launches == before
    np.testing.assert_array_equal(got.numpy(),
                                  delta_sum_gather_plain(*tq, k, cf).numpy())
    assert torch.equal(_k5_two_lane(*tq, k, cf), got)
    want = delta_sum_gather_pallas(jnp.asarray(lq), jnp.asarray(uq),
                                   jnp.asarray(k.numpy()),
                                   jnp.asarray(cf.numpy()), bq=128,
                                   interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    oracle = np.asarray(rref.delta_sum_ref(jnp.asarray(lq), jnp.asarray(uq),
                                           jnp.asarray(k.numpy()),
                                           jnp.asarray(v.numpy())))
    np.testing.assert_allclose(delta_sum_ref(*tq, k, v).numpy(), oracle,
                               **TOL)
    # on an inverted range (lq > uq) the gather form gives the signed
    # prefix difference -(mass in (uq, lq]), as the reference's kernel does;
    # the one-hot oracle gives 0 there
    ok = lq <= uq
    np.testing.assert_allclose(got.numpy()[ok], oracle[ok], **TOL)
    flip = delta_sum_gather_plain(*tq[::-1], k, cf).numpy()[~ok]
    np.testing.assert_allclose(got.numpy()[~ok], -flip, **TOL)
    if fill == 0:
        assert not got.numpy().any()


@pytest.mark.parametrize("fill", [0, 1, 37, CAP])
def test_delta_max_gather_plain_matches_pallas(fill):
    """K6's plain version against delta_max_gather_pallas (interpret mode)
    and the one-hot oracles; empty spans give -inf."""
    (k, v, _, st), _ = _buffers(max(fill, 1), True)
    if fill == 0:
        k = torch.full((CAP,), big_sentinel(torch.float64),
                       dtype=torch.float64)
        v = torch.zeros(CAP, dtype=torch.float64)
        st = torch.full(st.shape, -torch.inf, dtype=torch.float64)
    lq, uq = _delta_queries(100 + fill)
    tq = [torch.as_tensor(x) for x in (lq, uq)]
    before = delta_max_gather.launches
    got = delta_max_gather(*tq, k, st)
    assert delta_max_gather.launches == before
    np.testing.assert_array_equal(got.numpy(),
                                  delta_max_gather_plain(*tq, k, st).numpy())
    want = np.asarray(delta_max_gather_pallas(
        jnp.asarray(lq), jnp.asarray(uq), jnp.asarray(k.numpy()),
        jnp.asarray(st.numpy()), bq=128, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    vals = v.numpy() if fill else np.full(CAP, -np.inf)
    oracle = np.asarray(rref.delta_max_ref(jnp.asarray(lq), jnp.asarray(uq),
                                           jnp.asarray(k.numpy()),
                                           jnp.asarray(vals)))
    np.testing.assert_array_equal(got.numpy(), oracle)
    np.testing.assert_array_equal(
        delta_max_ref(*tq, k, torch.as_tensor(vals)).numpy(), oracle)
    assert np.isneginf(got.numpy()[lq > uq]).all()


def _count_side(keys, x, right):
    """csrc/locate.cuh bsearch_count_side in torch: the binary search's
    probe rounds with the compare picked per lane, pv < x or, where
    ``right``, pv == x too."""
    n = keys.shape[0]
    c = torch.zeros(x.shape, dtype=torch.int32)
    step = 1 << max(0, (n - 1).bit_length())
    while step >= 1:
        probe = c + (step - 1)
        pv = keys[torch.clamp(probe, max=n - 1)]
        ok = (pv < x) | (right & (pv == x))
        c = torch.where((probe <= n - 1) & ok, c + step, c)
        step >>= 1
    return c


def _k6_pair(lq, uq, keys, st, split):
    """csrc/polyfit_kernels.cu K6 in torch: lane 2q of the grid (256-lane
    blocks) counts the log's keys < lq of query q, lane 2q + 1 its keys <=
    uq, in one search loop; lanes past Q redo the last query.  The shipped
    form shuffles #(keys < lq) to lane 2q + 1, which runs rmq_gather; the
    ``split`` form (tools/k6_rates.cu) gives each lane its partner's count,
    lane 2q loads rmq_gather's entry at i0, lane 2q + 1 the one ending at
    i1 (rmq_gather's level, clamps and indices), and lane 2q + 1 writes
    jmax(left, right), -inf on an empty span."""
    Q = lq.shape[0]
    levels, n = st.shape
    t = torch.arange(-(-2 * Q // 256) * 256)
    q = torch.clamp(t // 2, max=Q - 1)
    upper = (t & 1) == 1
    c = _count_side(keys, torch.where(upper, uq[q], lq[q]), upper)
    other = c[t ^ 1]
    i0, i1 = torch.where(upper, other, c), torch.where(upper, c, other)
    if split:
        length = torch.clamp(i1 - i0, min=0)
        lvl = floor_log2(torch.clamp(length, min=1), levels)
        b = torch.clamp(i1 - torch.bitwise_left_shift(torch.ones_like(lvl),
                                                      lvl), 0, n - 1)
        a = torch.clamp(i0, max=n - 1)
        e = st.reshape(-1)[lvl.long() * n + torch.where(upper, b, a).long()]
        val = torch.where(length > 0, torch.maximum(e[t ^ 1], e),
                          -torch.inf)
    else:
        val = rmq_gather(st, i0, i1)
    out = torch.full((Q,), torch.nan, dtype=st.dtype)
    writes = upper & (t // 2 < Q)
    out[q[writes]] = val[writes]
    return out


@pytest.mark.parametrize("split", [False, True], ids=["shipped", "split"])
@pytest.mark.parametrize("fill,cap,with_nan", [
    (0, CAP, False), (1, CAP, True), (37, CAP, False), (37, CAP, True),
    (CAP, CAP, True), (4096, 4096, False)])
def test_k6_two_thread_form_matches_plain(fill, cap, with_nan, split):
    """K6's two-thread form (_k6_pair: one search loop for both endpoints,
    the uq lane taking the sparse-table step, or the step split over the
    pair) equals the plain K6 bit for bit, NaN as NaN, on an all-sentinel
    log (``DeltaBuffer.empty``), partly filled and full logs, with NaN
    measures in some, at an odd range count; on empty spans (lq == uq off a
    key, lq > uq), endpoints equal to keys, NaN and infinite bounds and the
    sentinel.  Each lane's count equals the binary search of its side."""
    big = big_sentinel(torch.float64)
    if fill == 0:
        buf = DeltaBuffer.empty(cap, torch.float64, "cpu", with_st=True)
        keys, st = buf.ins_keys, buf.ins_st
    else:
        rng = np.random.default_rng(fill + cap + with_nan)
        k = np.round(rng.uniform(-10, 610, fill), 1)   # ties included
        v = rng.normal(0, 10, fill)
        if with_nan:
            v[rng.integers(0, fill, 1 + fill // 50)] = np.nan
        keys, _, _, st = _append_1d(
            torch.full((cap,), big, dtype=torch.float64),
            torch.zeros(cap, dtype=torch.float64), torch.as_tensor(k),
            torch.as_tensor(v), cap=cap, with_st=True)
    lq, uq = _delta_queries(200 + fill)
    kh = keys[:fill].numpy()
    nan, inf = np.nan, np.inf
    lq = np.concatenate([lq, kh, kh, np.roll(kh, 3), [nan, 0.0, nan, -inf,
                                                      big, 700.0, big]])
    uq = np.concatenate([uq, kh, np.roll(kh, 3), kh, [5.0, nan, nan, inf,
                                                      big, inf, inf]])
    if len(lq) % 2 == 0:
        lq, uq = lq[:-1], uq[:-1]
    lq, uq = torch.as_tensor(lq), torch.as_tensor(uq)
    want = delta_max_gather_plain(lq, uq, keys, st)
    got = _k6_pair(lq, uq, keys, st, split)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert torch.equal(got[ok].view(torch.int64), want[ok].view(torch.int64))
    assert torch.isneginf(want).any() and (torch.isfinite(want).any()
                                           or fill == 0)
    if with_nan:
        assert torch.isnan(want).any()
    for x in (lq, uq):
        for right in (False, True):
            assert torch.equal(_count_side(keys, x, torch.tensor(right)),
                               bsearch_count(keys, x, side="right" if right
                                             else "left"))


# ---------------------------------------------------------------------------
# the session
# ---------------------------------------------------------------------------

def test_dynamic_session_updates(data):
    """Twin of tests/test_api.py::test_dynamic_session_updates: inserts,
    deletes and a flush through the session, answer for answer against the
    reference session, with the staleness each answer reports."""
    keys, _ = data
    budget = {api: api.ErrorBudget(abs=2 * DELTA) for api in (rapi, tapi)}
    spec = lambda api: api.TableSpec("count", budget[api], dynamic=True,
                                     capacity=128, background=False,
                                     auto_refit=False)
    ref = rapi.PolyFit.fit({"cnt": keys}, {"cnt": spec(rapi)})
    port = tapi.PolyFit.fit({"cnt": keys}, {"cnt": spec(tapi)}, device="cpu")
    lq = np.full(8, keys[0] - 1.0)
    uq = np.full(8, keys[-1] + 1.0)

    def ask():
        g = port.query(tapi.QuerySpec.range("cnt", lq, uq))
        w = ref.query(rapi.QuerySpec.range("cnt", lq, uq))
        np.testing.assert_allclose(g.value.numpy(), np.asarray(w.value),
                                   **TOL)
        assert g.staleness == w.staleness
        return float(g.value[0]), g.staleness

    base, stale = ask()
    assert stale == 0
    for s in (ref, port):
        s.insert("cnt", np.linspace(keys[0], keys[-1], 32))
    upd, stale = ask()
    assert abs(upd - (base + 32)) < 1e-6 and stale == 32
    for s in (ref, port):
        s.delete("cnt", keys[:4])
    del_upd, stale = ask()
    assert abs(del_upd - (upd - 4)) < 1e-6 and stale == 36
    for s in (ref, port):
        s.flush()
    post, stale = ask()
    assert abs(post - del_upd) <= 2 * DELTA + 1e-6 and stale == 0
    plan, buf = port.snapshot("cnt")
    assert plan is port.plan("cnt") and buf.cap == 128
    static = tapi.PolyFit.fit(
        {"cnt": keys}, {"cnt": tapi.TableSpec("count", budget[tapi])},
        device="cpu")
    with pytest.raises(RuntimeError, match="static"):
        static.insert("cnt", [1.0])


# K17's walk (csrc/scan1d.cu delta_max_kernel): csrc/scan1d.cu kDeltaTile
# slots a tile, the log in up to kDeltaChunks interleaved chunks
K17_TILE, K17_CHUNKS = 1024, 4


def _k17_walk(lq, uq, keys, vals):
    """K17's formulation in torch: each chunk walks its tiles in slot order
    and stops at its first tile that starts on the sentinel; a tile with a
    NaN measure runs the NaN-propagating max, any other the compare-only
    step (v > acc, which never replaces a NaN acc); a chunk that skipped
    tiles gives a range holding the sentinel the tail's 0; the chunks'
    maxima are taken in chunk order."""
    big = big_sentinel(torch.float64)
    D = keys.shape[0]
    tiles = -(-D // K17_TILE)
    S = max(1, min(K17_CHUNKS, tiles))
    out = None
    for y in range(S):
        acc = torch.full_like(lq, -torch.inf)
        skipped = False
        for t in range(y, tiles, S):
            k = keys[t * K17_TILE:(t + 1) * K17_TILE]
            v = vals[t * K17_TILE:(t + 1) * K17_TILE]
            if k[0] == big:
                skipped = True
                break
            member = (lq[:, None] <= k) & (k <= uq[:, None])
            if torch.isnan(v).any():
                acc = torch.maximum(
                    acc, torch.where(member, v, -torch.inf).amax(dim=1))
            else:
                for j in range(k.shape[0]):
                    acc = torch.where(member[:, j] & (v[j] > acc), v[j], acc)
        if skipped:
            holds = (lq <= big) & (big <= uq)
            acc = torch.where(holds, torch.maximum(acc, torch.zeros_like(acc)),
                              acc)
        out = acc if out is None else torch.maximum(out, acc)
    return out


@pytest.mark.parametrize("fill,with_nan", [(0, False), (1, True),
                                           (1023, False), (1024, True),
                                           (1025, True), (4096, False),
                                           (4096, True)])
def test_delta_max_tail_fold_matches_plain(fill, with_nan):
    """K17's walk, which stops at the log's sentinel tail and folds the
    skipped slots' 0 back in, equals the plain masked max in value (NaN
    equal) on all-negative measures, a NaN measure in some logs, and the
    lanes that reach the tail: uq = +inf, lq = uq = sentinel, NaN bounds."""
    cap = 4096
    big = big_sentinel(torch.float64)
    rng = np.random.default_rng(fill + 7 * with_nan)
    k = np.round(rng.uniform(0, 1000, fill), 1)
    v = -rng.uniform(1, 100, fill)
    if with_nan:
        v[rng.integers(0, fill)] = np.nan
    keys, vals, _, _ = _append_1d(
        torch.full((cap,), big, dtype=torch.float64),
        torch.zeros(cap, dtype=torch.float64), torch.as_tensor(k),
        torch.as_tensor(v), cap=cap, with_st=False)
    a, b = rng.uniform(-100, 1100, (2, 300))
    nan, inf = np.nan, np.inf
    lq = np.concatenate([np.minimum(a, b), a, [big, -inf, 500.0, nan, 0.0,
                                               nan, big, 2000.0]])
    uq = np.concatenate([np.maximum(a, b), np.full(300, inf),
                         [big, inf, 400.0, 10.0, nan, nan, inf, big]])
    lq, uq = torch.as_tensor(lq), torch.as_tensor(uq)
    torch.testing.assert_close(_k17_walk(lq, uq, keys, vals),
                               delta_max_plain(lq, uq, keys, vals),
                               rtol=0, atol=0, equal_nan=True)
