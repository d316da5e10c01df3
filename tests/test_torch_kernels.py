"""The plain versions of kernels K2 (range SUM) and K3 (range MAX) against
``range_sum_gather_pallas`` / ``range_max_gather_pallas`` in interpret mode,
for deg 1-3, on reference plans carried across with ``plan_from_numpy``
(rtol = atol = 1e-9); and torch transcriptions of K2's and K3's two-thread
forms (each endpoint's search by seg_lo's search tree; K2 its row's value
and the difference on the uq thread, K3 each boundary's row and clipped
maximum and the combine) and of K21's descent-plus-membership form held to
their plain versions bit for bit.  The kernels
themselves are held to these plain versions on the card by
tests/test_torch_cuda.py."""
import torch_threads  # noqa: F401  (one intra-op thread per test process)
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

jax.config.update("jax_enable_x64", True)

from repro.core import build_index_1d  # noqa: E402
from repro.data import hki_series  # noqa: E402
from repro.engine import build_plan  # noqa: E402
from repro.kernels.range_max import range_max_gather_pallas  # noqa: E402
from repro.kernels.range_sum import range_sum_gather_pallas  # noqa: E402
from repro_torch.core.poly import clipped_poly_max, horner, scale_unit  # noqa: E402
from repro_torch.engine.plan import (ARRAY_FIELDS, META_FIELDS,  # noqa: E402
                                     big_sentinel, plan_from_numpy)
from repro_torch.kernels import locate as tloc  # noqa: E402
from repro_torch.kernels import poly_eval as tpe  # noqa: E402
from repro_torch.kernels import range_max as tmax  # noqa: E402
from repro_torch.kernels import range_sum as tsum  # noqa: E402

TOL = dict(rtol=1e-9, atol=1e-9)
N = 1000
Q = 512


def port_plan(rplan, device="cpu"):
    fields = {f: (None if getattr(rplan, f) is None
                  else np.asarray(getattr(rplan, f))) for f in ARRAY_FIELDS}
    fields.update({f: getattr(rplan, f) for f in META_FIELDS})
    return plan_from_numpy(fields, device)


@pytest.fixture(scope="module")
def plans():
    """Reference plans, deg 1-3, SUM over the HKI walk and MAX/MIN of it."""
    t, v = hki_series(N, seed=3)
    out = {}
    for deg in (1, 2, 3):
        out["sum", deg] = build_plan(build_index_1d(t, v / 100, "sum",
                                                    deg=deg, delta=100.0))
        out["max", deg] = build_plan(build_index_1d(t, v, "max", deg=deg,
                                                    delta=30.0))
    out["min", 3] = build_plan(build_index_1d(t, v, "min", deg=3, delta=30.0))
    return t, out


@pytest.fixture(scope="module")
def queries(plans):
    """Endpoints drawn from the keys, on segment boundaries and outside the
    domain, clamped to the domain as the engine clamps them."""
    t, _ = plans
    rng = np.random.default_rng(5)
    a = t[rng.integers(0, N, Q - 64)]
    b = t[rng.integers(0, N, Q - 64)]
    lq = np.concatenate([np.minimum(a, b), t[::20][:32], [t[0] - 5.0] * 32])
    uq = np.concatenate([np.maximum(a, b), t[::20][:32] + 3.0, [t[-1] + 5.0] * 32])
    lq = np.maximum(lq, t[0])
    uq = np.maximum(uq, t[0])
    return lq, uq


def _sum_args(rplan, lq, uq):
    return lq, uq, rplan.seg_lo, rplan.seg_hi, rplan.coeffs


def _max_args(rplan, lq, uq):
    return lq, uq, rplan.seg_lo, rplan.seg_hi, rplan.coeffs, rplan.st


@pytest.mark.parametrize("deg", [1, 2, 3])
def test_range_sum_plain_matches_pallas(plans, queries, deg):
    _, ps = plans
    rplan = ps["sum", deg]
    lq, uq = queries
    want = np.asarray(range_sum_gather_pallas(
        *map(jnp.asarray, _sum_args(rplan, lq, uq)), bq=256))
    p = port_plan(rplan)
    args = (torch.as_tensor(lq), torch.as_tensor(uq), p.seg_lo, p.seg_hi,
            p.coeffs)
    np.testing.assert_allclose(tsum.range_sum_gather_plain(*args).numpy(),
                               want, **TOL)
    before = tsum.range_sum_gather.launches
    np.testing.assert_allclose(tsum.range_sum_gather(*args).numpy(), want,
                               **TOL)
    assert tsum.range_sum_gather.launches == before


@pytest.mark.parametrize("agg,deg", [("max", 1), ("max", 2), ("max", 3),
                                     ("min", 3)])
def test_range_max_plain_matches_pallas(plans, queries, agg, deg):
    _, ps = plans
    rplan = ps[agg, deg]
    lq, uq = queries
    want = np.asarray(range_max_gather_pallas(
        *map(jnp.asarray, _max_args(rplan, lq, uq)), bq=256))
    p = port_plan(rplan)
    args = (torch.as_tensor(lq), torch.as_tensor(uq), p.seg_lo, p.seg_hi,
            p.coeffs, p.st)
    np.testing.assert_allclose(tmax.range_max_gather_plain(*args).numpy(),
                               want, **TOL)
    before = tmax.range_max_gather.launches
    np.testing.assert_allclose(tmax.range_max_gather(*args).numpy(), want,
                               **TOL)
    assert tmax.range_max_gather.launches == before


def test_range_max_rejects_deg4():
    c = torch.zeros(512, 5, dtype=torch.float64)
    z = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="deg <= 3"):
        tmax.range_max_gather(z, z, c[:, 0], c[:, 0], c, c[:1, :4])


def _k3_two_threads(lq, uq, seg_lo, seg_hi, coeffs, st, tree):
    """torch transcription of K3 as csrc/polyfit_kernels.cu runs it: two
    threads a query (the leading axis), thread 0 lq's boundary, thread 1
    uq's.  Each finds its segment by the descent of seg_lo's search tree,
    max(#(seg_lo <= q) - 1, 0), gathers its row and takes the clipped
    maximum over its part of the segment: thread 0 over [lq, min(hi, uq)],
    dropped where lq is past hi; thread 1 over [max(lo, lq), uq].  Thread 1
    then takes thread 0's segment and maximum (the shuffle), drops its own
    where the two segments are one, takes the sparse-table max over
    (il, iu) and combines the three in the plain version's order."""
    st = st.to(coeffs.dtype)
    q = torch.stack([lq, uq])
    idx = torch.clamp(tloc.tree_count(seg_lo, tree, q) - 1, min=0)
    lo, hi, c = seg_lo[idx], seg_hi[idx], coeffs[idx]
    right = torch.tensor([[False], [True]])
    m = clipped_poly_max(c, lo, hi, torch.where(right, torch.maximum(lo, lq),
                                                lq),
                         torch.where(right, uq, torch.minimum(hi, uq)))
    m = torch.where(right | (lq <= hi), m, -torch.inf)
    il, iu = idx[0], idx[1]
    m_right = torch.where(il == iu, -torch.inf, m[1])
    m_int = tloc.rmq_gather(st, il + 1, iu)
    return torch.maximum(torch.maximum(m[0], m_right), m_int)


def _k3_edge_lanes(p, lq, uq, dt):
    """The module's ranges after K3's edge lanes over plan ``p``: every
    pairing of NaN, +-inf, below the table, past its last segment and the
    sentinel; lq == uq on every start, on a start and on a segment's end
    (il == iu), a range inside each segment (il == iu), a start and the
    third on, and the same inverted (lq > uq)."""
    s = p.seg_lo[:p.h].double().numpy()
    e = p.seg_hi[:p.h].double().numpy()
    special = np.array([np.nan, np.inf, -np.inf, s[0] - 1.0, e[-1] + 5.0,
                        big_sentinel(dt)])
    a, b = np.meshgrid(special, special)
    inside = s + (e - s) / 3
    far = np.roll(s, -3)
    el = np.concatenate([a.ravel(), s, s, inside, s, far, lq])
    eu = np.concatenate([b.ravel(), s, e, inside + (e - s) / 3, far, s, uq])
    return (torch.as_tensor(el.astype(np.float32 if dt == torch.float32
                                      else np.float64)),
            torch.as_tensor(eu.astype(np.float32 if dt == torch.float32
                                      else np.float64)))


def _bits(t):
    """(NaN mask, the other lanes' bits)."""
    nan = torch.isnan(t)
    return nan, t[~nan].view(torch.int32 if t.dtype == torch.float32
                             else torch.int64)


@pytest.mark.parametrize("case", ["max1", "max2", "max3", "min3", "max0",
                                  "max3_f32", "max2_f32"])
def test_k3_two_thread_form_matches_plain(plans, queries, case):
    """K3's two-thread form (_k3_two_threads) equals the plain K3 bit for
    bit (NaN as NaN) on the plans at deg 0-3 (deg 0: the deg-1 plan's
    constant terms) and at float32, on the plans' ranges and the edge
    lanes; the search tree's descent counts as the binary search does."""
    _, ps = plans
    dt = torch.float32 if case.endswith("_f32") else torch.float64
    agg, deg = case[:3], int(case[3])
    p = port_plan(ps[agg, max(deg, 1)])
    seg_lo, seg_hi = p.seg_lo.to(dt), p.seg_hi.to(dt)
    coeffs = p.coeffs[:, :deg + 1].to(dt).contiguous()
    tree = tloc.search_tree(seg_lo)
    if dt == torch.float64:
        assert torch.equal(p.seg_tree.nan_to_num(-1.0),
                           tree.nan_to_num(-1.0))
    lq, uq = _k3_edge_lanes(p, *queries, dt)
    got = _k3_two_threads(lq, uq, seg_lo, seg_hi, coeffs, p.st, tree)
    want = tmax.range_max_gather_plain(lq, uq, seg_lo, seg_hi, coeffs, p.st)
    assert got.dtype == want.dtype == dt
    (gn, gb), (wn, wb) = _bits(got), _bits(want)
    assert torch.equal(gn, wn) and torch.equal(gb, wb)
    assert torch.isfinite(want).any() and torch.isneginf(want).any()
    for q in (lq, uq):
        assert torch.equal(tloc.tree_count(seg_lo, tree, q),
                           tloc.bsearch_count(seg_lo, q))


def _k2_two_threads(lq, uq, seg_lo, seg_hi, coeffs, tree):
    """torch transcription of K2 as csrc/polyfit_kernels.cu runs it: lane
    2q of the grid (256-lane blocks) evaluates lq of query q, lane 2q + 1
    its uq; lanes past Q redo the last query.  Each finds its segment by
    the descent of seg_lo's search tree, max(#(seg_lo <= x) - 1, 0), and
    evaluates its row by Horner; lane 2q + 1 takes lane 2q's value (the
    shuffle) and writes v_u - v_l."""
    Q = lq.shape[0]
    t = torch.arange(-(-2 * Q // 256) * 256)
    q = torch.clamp(t // 2, max=Q - 1)
    upper = (t & 1) == 1
    x = torch.where(upper, uq[q], lq[q])
    idx = torch.clamp(tloc.tree_count(seg_lo, tree, x) - 1, min=0)
    v = horner(coeffs[idx], scale_unit(x, seg_lo[idx], seg_hi[idx]))
    out = torch.full((Q,), torch.nan, dtype=coeffs.dtype)
    writes = upper & (t // 2 < Q)
    out[q[writes]] = (v - v[t ^ 1])[writes]
    return out


@pytest.mark.parametrize("case", ["sum0", "sum1", "sum2", "sum3", "sum10",
                                  "sum2_f32", "sum3_f32"])
def test_k2_two_thread_form_matches_plain(plans, queries, case):
    """K2's two-thread form (_k2_two_threads) equals the plain K2 bit for
    bit (NaN as NaN) on the SUM plans at deg 0-3 (deg 0: the deg-1 plan's
    constant terms), at deg 10 (the runtime-degree form: the deg-3 plan's
    rows and seven random higher terms) and at float32, on the plans'
    ranges and K3's edge lanes (segment starts, below the domain, NaN,
    +-inf, the sentinel, inverted ranges) at an odd count; the plan carries
    seg_lo's search tree, and its descent counts as the binary search
    does."""
    _, ps = plans
    dt = torch.float32 if case.endswith("_f32") else torch.float64
    deg = int(case[3:].split("_")[0])
    p = port_plan(ps["sum", min(max(deg, 1), 3)])
    seg_lo, seg_hi = p.seg_lo.to(dt), p.seg_hi.to(dt)
    coeffs = p.coeffs[:, :deg + 1]
    if deg > 3:
        rng = np.random.default_rng(deg)
        extra = torch.as_tensor(rng.normal(0, 1e-3, (coeffs.shape[0],
                                                     deg - 3)))
        coeffs = torch.cat([coeffs, extra], dim=1)
    coeffs = coeffs.to(dt).contiguous()
    tree = tloc.search_tree(seg_lo)
    if dt == torch.float64:
        assert torch.equal(p.seg_tree.nan_to_num(-1.0),
                           tree.nan_to_num(-1.0))
    lq, uq = _k3_edge_lanes(p, *queries, dt)
    if lq.shape[0] % 2 == 0:
        lq, uq = lq[:-1], uq[:-1]
    got = _k2_two_threads(lq, uq, seg_lo, seg_hi, coeffs, tree)
    want = tsum.range_sum_gather_plain(lq, uq, seg_lo, seg_hi, coeffs, tree)
    assert got.dtype == want.dtype == dt
    (gn, gb), (wn, wb) = _bits(got), _bits(want)
    assert torch.equal(gn, wn) and torch.equal(gb, wb)
    # a NaN endpoint reaches the value through u (deg 0 reads no u)
    assert torch.isfinite(want).any() and torch.isnan(want).any() == (deg > 0)
    before = tsum.range_sum_gather.launches
    assert torch.equal(_bits(tsum.range_sum_gather(lq, uq, seg_lo, seg_hi,
                                                   coeffs, tree))[1], wb)
    assert tsum.range_sum_gather.launches == before
    for x in (lq, uq):
        assert torch.equal(tloc.tree_count(seg_lo, tree, x),
                           tloc.bsearch_count(seg_lo, x))


def _k21_descent(q, seg_lo, seg_next, seg_hi, coeffs, tree):
    """torch transcription of K21 as csrc/scan1d.cu runs it: one key a
    thread, c = #(seg_lo <= q) by the descent of seg_lo's search tree, the
    boundary row c - 1 where q < seg_next[c - 1] (else none: the zero row,
    lo = hi = 0), Horner at the scaled coordinate."""
    c = tloc.tree_count(seg_lo, tree, q).long()
    prev = torch.clamp(c - 1, min=0)
    hit = (c > 0) & (q < seg_next[prev])
    zero = torch.zeros((), dtype=coeffs.dtype)
    lo = torch.where(hit, seg_lo[prev], zero)
    hi = torch.where(hit, seg_hi[prev], zero)
    cf = torch.where(hit[:, None], coeffs[prev], zero)
    return horner(cf, scale_unit(q, lo, hi))


@pytest.mark.parametrize("case", ["sum0", "sum1", "sum2", "sum3", "sum10",
                                  "sum2_f32", "sum3_f32"])
def test_k21_descent_form_matches_plain(plans, queries, case):
    """K21's descent-plus-membership form (_k21_descent) equals the plain
    K21 (one-hot membership over every row) bit for bit (NaN as NaN) on the
    SUM plans at deg 0-3 (deg 0: the deg-1 plan's constant terms), at deg
    10 (the runtime-degree form: the deg-3 plan's rows and seven random
    higher terms) and at float32, where the table (padded with float32's
    sentinel, seg_next its starts shifted, as a float32 plan is) has two
    starts rounded to one float; on the plans' range endpoints, every
    start, the doubles either side of each, the sentinel, +inf, NaN and
    below the domain.  The wrapper runs the plain version on CPU tensors,
    counting nothing."""
    _, ps = plans
    dt = torch.float32 if case.endswith("_f32") else torch.float64
    deg = int(case[3:].split("_")[0])
    p = port_plan(ps["sum", min(max(deg, 1), 3)])
    coeffs = p.coeffs[:, :deg + 1]
    if deg > 3:
        rng = np.random.default_rng(deg)
        extra = torch.as_tensor(rng.normal(0, 1e-3, (coeffs.shape[0],
                                                     deg - 3)))
        coeffs = torch.cat([coeffs, extra], dim=1)
    lo64, hi64 = p.seg_lo.clone(), p.seg_hi
    if dt == torch.float32:
        # starts 4 and 5 a millionth of an ulp of float32 apart
        lo64[5] = lo64[4] * (1 + 1e-12)
    big = big_sentinel(dt)
    pad = lambda t: torch.where(t >= big_sentinel(torch.float64),
                                torch.tensor(big, dtype=dt), t.to(dt))
    seg_lo, seg_hi = pad(lo64), pad(hi64)
    seg_next = torch.cat([seg_lo[1:], torch.tensor([big], dtype=dt)])
    coeffs = coeffs.to(dt).contiguous()
    if dt == torch.float32:
        assert seg_lo[4] == seg_lo[5] and lo64[4] != lo64[5]
    tree = tloc.search_tree(seg_lo)
    s = seg_lo[:p.h]
    edge = torch.cat([s, torch.nextafter(s, torch.tensor(-np.inf, dtype=dt)),
                      torch.nextafter(s, torch.tensor(np.inf, dtype=dt)),
                      torch.tensor([big, np.inf, np.nan, -np.inf,
                                    float(s[0]) - 1.0], dtype=dt)])
    q = torch.cat([edge, *(torch.as_tensor(x).to(dt) for x in queries)])
    got = _k21_descent(q, seg_lo, seg_next, seg_hi, coeffs, tree)
    want = tpe.poly_eval_plain(q, seg_lo, seg_next, seg_hi, coeffs, tree)
    assert got.dtype == want.dtype == dt
    (gn, gb), (wn, wb) = _bits(got), _bits(want)
    assert torch.equal(gn, wn) and torch.equal(gb, wb)
    assert torch.isfinite(want).any() and torch.isnan(want).any() == (deg > 0)
    before = tpe.poly_eval.launches
    assert torch.equal(_bits(tpe.poly_eval(q, seg_lo, seg_next, seg_hi,
                                           coeffs, tree))[1], wb)
    assert tpe.poly_eval.launches == before
