"""The ``cuda_scan`` backend (twin of the reference's ``pallas_scan``) on
the CPU, where its kernels run as their plain versions.

* The plain versions of K14 (``range_sum``), K15 (``range_max``), K17
  (``delta_max``) and K4's scan mode are held to ``range_sum_pallas``,
  ``range_max_pallas``, ``delta_max_pallas`` and
  ``quantile_invert_pallas(scan=True)`` in interpret mode, and to their
  gather twins (K2, K3, K6, gather-mode K4) bit for bit.  Against the
  Pallas kernels K17 is exact; K14, K15 and K4 evaluate polynomials, whose
  Horner steps the reference's XLA on the CPU contracts into fused
  multiply-adds (apart from the port's in the last bits of some lanes,
  more where the sum cancels), so they are held at rtol = atol = 1e-9, as
  tests/test_torch_kernels.py holds K2/K3.
* The plain K16 (``delta_sum``) is held to ``delta_sum_pallas`` exactly on
  a COUNT log (integer measures: every order of summation is exact) and
  within 1e-12 x sum |v| of the lane on a SUM log (the one-hot product may
  add the members in another order than the Pallas tiles).
* A torch transcription of K14's count walk (seg_lo's tiles up to the
  sentinel tail, #(seg_lo <= q) for each endpoint, the row found from the
  count, Horner) equals the plain K14 bit for bit, and finds the one-hot
  rows, on the reference's SUM plans at deg 1-3 (one with two equal
  starts), float32 tables (one whose starts round to one float) and
  synthetic tables whose tail starts mid-tile, on a tile edge or nowhere,
  on NaN, infinite, sentinel, below-the-table and inverted lanes.
* Every log the port hands K16 (the append with ties, a dynamic table's
  insert and delete logs before and after a merge, a window's open epoch
  after ingests and a seal) is sorted with a sentinel tail of value 0, the
  layout at whose first sentinel tile the kernel stops; on those logs the
  plain K16 equals ``delta_sum_pallas``.
* The ``cuda_scan`` route equals the ``cuda`` route bit for bit on segment
  boundaries (twin of tests/test_locate.py::
  test_gather_bit_identical_on_boundaries_1d).  Both routes run on CPU
  plans here through the engine's own dispatch, with the card-only backend
  check lifted (``card_route``): every wrapper then takes its plain
  version, as it does on CPU tensors.
* Static, dynamic (inserts, deletes, shadowed victims) and window tables
  on ``cuda_scan`` agree with the reference's ``pallas_scan`` at
  rtol = atol = 1e-9 with equal refined flags; the ``cuda_scan`` buffer
  keeps no sparse table.
* ``cuda_scan`` refuses CPU plans.  Its dynamic two-key tables (K18-K20)
  are held in tests/test_torch_scan2d.py.

The kernels themselves are held to these plain versions on the card by
tests/test_torch_cuda.py.
"""
import torch_threads  # noqa: F401  (one intra-op thread per test process)
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

jax.config.update("jax_enable_x64", True)

from repro.core import build_index_1d as r_build_1d  # noqa: E402
from repro.data import hki_series  # noqa: E402
from repro.engine import DynamicEngine as RDynamicEngine  # noqa: E402
from repro.engine import Engine as REngine  # noqa: E402
from repro.engine import WindowEngine as RWindowEngine  # noqa: E402
from repro.engine import build_plan  # noqa: E402
from repro.kernels.delta_scan import (delta_max_pallas,  # noqa: E402
                                      delta_sum_pallas)
from repro.kernels.quantile_invert import quantile_invert_pallas  # noqa: E402
from repro.kernels.range_max import range_max_pallas  # noqa: E402
from repro.kernels.range_sum import range_sum_pallas  # noqa: E402
from repro_torch.core import build_index_1d as t_build_1d  # noqa: E402
from repro_torch.core import index_from_numpy, rank_slack  # noqa: E402
from repro_torch.core.poly import (clipped_poly_max, horner,  # noqa: E402
                                   scale_unit)
from repro_torch.engine import (BACKENDS, DynamicEngine,  # noqa: E402
                                Engine, WindowEngine, big_sentinel, execute,
                                execute_quantile)
from repro_torch.engine import build_plan as t_build_plan  # noqa: E402
from repro_torch.engine import engine as eng  # noqa: E402
from repro_torch.engine import dynamic as dyn_mod  # noqa: E402
from repro_torch.engine import lsm as lsm_mod  # noqa: E402
from repro_torch.engine import window as win_mod  # noqa: E402
from repro_torch.engine.plan import (ARRAY_FIELDS, META_FIELDS,  # noqa: E402
                                     pad_to_multiple, plan_from_numpy)
from repro_torch.kernels import delta_scan as kdel  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import quantile_invert as kq  # noqa: E402
from repro_torch.kernels import range_max as kmax  # noqa: E402
from repro_torch.kernels import range_sum as ksum  # noqa: E402
from repro_torch.kernels.range_sum import gather_rows  # noqa: E402
from repro_torch.core.quantile import boundary_array  # noqa: E402

TOL = dict(rtol=1e-9, atol=1e-9)
N = 1000
Q = 512
BQ = 256
AGGS = ("sum", "count", "max", "min")


def port_plan(rplan):
    fields = {f: (None if getattr(rplan, f) is None
                  else np.asarray(getattr(rplan, f))) for f in ARRAY_FIELDS}
    fields.update({f: getattr(rplan, f) for f in META_FIELDS})
    return plan_from_numpy(fields, "cpu")


def _fields(idx):
    """A reference index's fields as numpy (``index_from_numpy``'s input)."""
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


def _same(got, want, exact=False):
    """A port QueryResult against a reference one: answers at TOL (or
    exactly), refined flags equal."""
    check = (np.testing.assert_array_equal if exact else
             lambda a, b: np.testing.assert_allclose(a, b, **TOL))
    check(got.answer.numpy(), np.asarray(want.answer))
    np.testing.assert_array_equal(got.refined.numpy(),
                                  np.asarray(want.refined))


@pytest.fixture
def card_route(monkeypatch):
    """Let the card backends run CPU plans: every kernel wrapper then takes
    its plain version, as it does on CPU tensors, and the engine's dispatch
    (the routing under test) is the card's."""
    lift = lambda backend, device: ("torch" if backend is None else backend)
    for mod in (eng, dyn_mod, lsm_mod, win_mod):
        monkeypatch.setattr(mod, "resolve_backend", lift)


# ---------------------------------------------------------------------------
# the plain kernels against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def plans():
    """Reference plans over an HKI walk: SUM deg 1-3, MAX deg 1-3, MIN
    deg 3 (Hp 512: one Pallas tile)."""
    t, v = hki_series(N, seed=3)
    out = {}
    for deg in (1, 2, 3):
        out["sum", deg] = build_plan(r_build_1d(t, v / 100, "sum", deg=deg,
                                                delta=100.0))
        out["max", deg] = build_plan(r_build_1d(t, v, "max", deg=deg,
                                                delta=30.0))
    out["min", 3] = build_plan(r_build_1d(t, v, "min", deg=3, delta=30.0))
    return t, out


@pytest.fixture(scope="module")
def queries(plans):
    """Q endpoints from the keys, on segment boundaries and past both ends,
    clamped to the domain as the engine clamps them."""
    t, _ = plans
    rng = np.random.default_rng(5)
    a, b = t[rng.integers(0, N, Q - 64)], t[rng.integers(0, N, Q - 64)]
    lq = np.concatenate([np.minimum(a, b), t[::20][:32], [t[0] - 5.0] * 32])
    uq = np.concatenate([np.maximum(a, b), t[::20][:32] + 3.0,
                         [t[-1] + 5.0] * 32])
    return np.maximum(lq, t[0]), np.maximum(uq, t[0])


@pytest.mark.parametrize("deg", [1, 2, 3])
def test_range_sum_plain_matches_pallas(plans, queries, deg):
    rplan = plans[1]["sum", deg]
    lq, uq = queries
    want = np.asarray(range_sum_pallas(
        jnp.asarray(lq), jnp.asarray(uq), rplan.seg_lo, rplan.seg_next,
        rplan.seg_hi, rplan.coeffs, bq=BQ, bh=rplan.bh))
    p = port_plan(rplan)
    tq = [torch.as_tensor(q) for q in queries]
    args = (*tq, p.seg_lo, p.seg_next, p.seg_hi, p.coeffs)
    got = ksum.range_sum_plain(*args)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the gather twin (K2) reads the very rows the scan selects
    np.testing.assert_array_equal(
        got.numpy(), ksum.range_sum_gather_plain(
            *tq, p.seg_lo, p.seg_hi, p.coeffs).numpy())
    before = ksum.range_sum.launches
    np.testing.assert_array_equal(ksum.range_sum(*args).numpy(), got.numpy())
    assert ksum.range_sum.launches == before


@pytest.mark.parametrize("agg,deg", [("max", 1), ("max", 2), ("max", 3),
                                     ("min", 3)])
def test_range_max_plain_matches_pallas(plans, queries, agg, deg):
    rplan = plans[1][agg, deg]
    lq, uq = queries
    want = np.asarray(range_max_pallas(
        jnp.asarray(lq), jnp.asarray(uq), rplan.seg_lo, rplan.seg_next,
        rplan.seg_hi, rplan.coeffs, rplan.seg_agg, bq=BQ, bh=rplan.bh))
    p = port_plan(rplan)
    tq = [torch.as_tensor(q) for q in queries]
    args = (*tq, p.seg_lo, p.seg_next, p.seg_hi, p.coeffs, p.seg_agg)
    got = kmax.range_max_plain(*args)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(
        got.numpy(), kmax.range_max_gather_plain(
            *tq, p.seg_lo, p.seg_hi, p.coeffs, p.st).numpy())
    before = kmax.range_max.launches
    np.testing.assert_array_equal(kmax.range_max(*args).numpy(), got.numpy())
    assert kmax.range_max.launches == before


def test_range_max_scan_rejects_deg4():
    c = torch.zeros(512, 5, dtype=torch.float64)
    z = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="deg <= 3"):
        kmax.range_max(z, z, c[:, 0], c[:, 0], c[:, 0], c, c[:, 0])


CAP = 256


def _log(fill, seed, count):
    """A sorted, sentinel-padded CAP-slot log holding ``fill`` entries
    (unit measures when ``count``), its prefix sums and queries over it,
    ragged and inverted ones included."""
    rng = np.random.default_rng(seed)
    k = np.sort(np.round(rng.uniform(0, 100, fill), 1))   # duplicate keys
    v = np.ones(fill) if count else rng.normal(0, 50, fill)
    keys = np.full(CAP, big_sentinel(torch.float64))
    vals = np.zeros(CAP)
    keys[:fill], vals[:fill] = k, v
    cf = np.concatenate([[0.0], np.cumsum(vals)])
    on = k[:28] if fill >= 28 else rng.uniform(0, 100, 28)  # on the keys
    a = np.concatenate([rng.uniform(-10, 110, 200), on])
    b = np.concatenate([rng.uniform(-10, 110, 200), on + 0.05])
    lq = np.concatenate([np.minimum(a, b), [-1e9, 50.0, 200.0],
                         np.maximum(a, b)[:25]])
    uq = np.concatenate([np.maximum(a, b), [1e9, 50.0, 300.0],
                         np.minimum(a, b)[:25]])
    return keys, vals, cf, lq[:Q // 2], uq[:Q // 2]


@pytest.mark.parametrize("fill", [0, 37, CAP])
@pytest.mark.parametrize("count", [True, False], ids=["count", "sum"])
def test_delta_sum_plain_matches_pallas(fill, count):
    keys, vals, cf, lq, uq = _log(fill, 3 + fill, count)
    want = np.asarray(delta_sum_pallas(
        jnp.asarray(lq), jnp.asarray(uq), jnp.asarray(keys),
        jnp.asarray(vals), bq=BQ, bd=128))
    tk, tv, tcf = (torch.as_tensor(a) for a in (keys, vals, cf))
    tq = [torch.as_tensor(q) for q in (lq, uq)]
    got = kdel.delta_sum_plain(*tq, tk, tv).numpy()
    before = kdel.delta_sum.launches
    np.testing.assert_array_equal(kdel.delta_sum(*tq, tk, tv).numpy(), got)
    assert kdel.delta_sum.launches == before
    gather = kdel.delta_sum_gather_plain(*tq, tk, tcf).numpy()
    ok = lq <= uq      # on inverted ranges the gather form is signed
    if count:
        # integer measures: every summation order is exact
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[ok], gather[ok])
    else:
        # the one-hot product may add the members in another order than
        # the Pallas tiles: a few ulps of the lane's sum of |measure|
        scale = np.abs(vals).sum()
        assert np.all(np.abs(got - want) <= 1e-12 * scale)
        np.testing.assert_allclose(got[ok], gather[ok], **TOL)
    assert not got[~ok].any()


@pytest.mark.parametrize("fill", [0, 37, CAP])
def test_delta_max_plain_matches_pallas(fill):
    keys, vals, _, lq, uq = _log(fill, 11 + fill, False)
    if fill == 0:
        vals = np.full(CAP, -np.inf)
    want = np.asarray(delta_max_pallas(
        jnp.asarray(lq), jnp.asarray(uq), jnp.asarray(keys),
        jnp.asarray(vals), bq=BQ, bd=128))
    tq = [torch.as_tensor(q) for q in (lq, uq)]
    tk, tv = torch.as_tensor(keys), torch.as_tensor(vals)
    got = kdel.delta_max_plain(*tq, tk, tv).numpy()
    np.testing.assert_array_equal(got, want)
    before = kdel.delta_max.launches
    np.testing.assert_array_equal(kdel.delta_max(*tq, tk, tv).numpy(), want)
    assert kdel.delta_max.launches == before
    assert np.isneginf(got[lq > uq]).all()


# ---------------------------------------------------------------------------
# K4's scan mode
# ---------------------------------------------------------------------------

FRACTIONS = np.concatenate([[0.0, 1.0, 0.01, 0.5, 0.99],
                            np.linspace(0.0, 1.0, 123)])


@pytest.fixture(scope="module")
def quantile_plans():
    """(agg, deg) -> reference plan over a skewed key set (n 1024)."""
    rng = np.random.default_rng(5)
    keys = np.sort(rng.lognormal(mean=1.0, sigma=1.2, size=1024))
    vals = np.abs(rng.normal(2.0, 1.0, 1024)) + 0.1
    out = {}
    for agg in ("count", "sum"):
        for deg in (1, 2, 3, 4, 5):
            out[agg, deg] = build_plan(r_build_1d(
                keys, None if agg == "count" else vals, agg, deg=deg,
                delta=8.0 if agg == "count" else 20.0))
    return out


@pytest.mark.parametrize("agg", ["count", "sum"])
@pytest.mark.parametrize("deg", [1, 2, 3, 4, 5])
def test_quantile_scan_plain_matches_pallas(quantile_plans, agg, deg):
    rplan = quantile_plans[agg, deg]
    M = float(rplan.n) if agg == "count" else float(rplan.ref_cf[-1])
    slack = float(rank_slack(agg, torch.tensor(M)))
    t = np.clip(FRACTIONS, 0.0, 1.0) * M
    p = port_plan(rplan)
    B = boundary_array(p.coeffs)
    keys = pad_to_multiple(p.ref_keys, 128, big_sentinel(torch.float64))
    err = p.seg_err
    targets = [torch.as_tensor(a) for a in (t, t - slack, t + slack)]
    kw = dict(h=rplan.h, n=rplan.n, delta=float(rplan.delta))
    args = (*targets, B, p.seg_lo, p.seg_hi, p.coeffs, err, keys)
    want = quantile_invert_pallas(
        *(jnp.asarray(a.numpy()) for a in args), bq=128, interpret=True,
        scan=True, **kw)
    got = kq.quantile_invert_plain(*args, scan=True, **kw)
    gather = kq.quantile_invert_plain(*args, **kw)
    before = (kq.quantile_invert.launches, kq.quantile_invert.scan_launches)
    wrapped = kq.quantile_invert(*args, scan=True, **kw)
    assert (kq.quantile_invert.launches,
            kq.quantile_invert.scan_launches) == before
    for g, w, a, b in zip(got, want, gather, wrapped):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        np.testing.assert_array_equal(g.numpy(), a.numpy())
        np.testing.assert_array_equal(g.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# the engine: cuda_scan against cuda and against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tables():
    """One reference index per aggregate over 2,000 keys (SUM and COUNT
    deg 2, MAX and MIN deg 3 over a walk of both signs), each with its
    reference plan and the port's twin of it, and 400 ranges from the
    keys."""
    rng = np.random.default_rng(7)
    keys = np.sort(rng.uniform(0, 800, 2000))
    meas = rng.uniform(0, 10, 2000)
    _, walk = hki_series(2000, seed=4)
    walk = walk - np.median(walk)
    m = {"sum": meas, "count": None, "max": walk, "min": walk}
    out = {}
    for agg in AGGS:
        idx = r_build_1d(keys, m[agg], agg,
                         deg=2 if agg in ("sum", "count") else 3, delta=25.0)
        rplan = build_plan(idx)
        out[agg] = (idx, rplan, port_plan(rplan))
    a, b = keys[rng.integers(0, 2000, 400)], keys[rng.integers(0, 2000, 400)]
    return keys, out, (np.minimum(a, b), np.maximum(a, b))


@pytest.mark.parametrize("agg", AGGS)
def test_scan_bit_identical_on_boundaries_1d(tables, card_route, agg):
    """Twin of tests/test_locate.py::test_gather_bit_identical_on_boundaries_1d:
    ranges from and to every segment boundary, midpoints and both domain
    ends."""
    _, rplan, plan = tables[1][agg]
    sl = np.asarray(rplan.seg_lo)[:rplan.h]
    sh = np.asarray(rplan.seg_hi)[:rplan.h]
    lq = np.concatenate([sl, sh, [-1e9, sl[0], sh[-1]]])
    uq = np.concatenate([sh, sl + (sh - sl) / 2, [sl[-1], 1e9, 1e9]])
    lq, uq = np.minimum(lq, uq), np.maximum(lq, uq)
    launched = (ksum.range_sum_gather, kmax.range_max_gather,
                ksum.range_sum, kmax.range_max)
    before = [k.launches for k in launched]
    outs = {b: Engine(backend=b).query(plan, lq, uq).answer.numpy()
            for b in ("cuda", "cuda_scan", "torch")}
    assert [k.launches for k in launched] == before   # plain versions here
    # the scan reads the very rows the gather path locates
    np.testing.assert_array_equal(outs["cuda_scan"], outs["cuda"])
    np.testing.assert_allclose(outs["cuda_scan"], outs["torch"], **TOL)
    want = np.asarray(REngine(backend="pallas_scan").query(rplan, lq, uq)
                      .answer)
    np.testing.assert_allclose(outs["cuda_scan"], want, **TOL)


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("eps_rel", [None, 0.05])
def test_static_scan_matches_reference(tables, card_route, agg, eps_rel):
    _, plans, (lq, uq) = tables
    _, rplan, plan = plans[agg]
    got = Engine(backend="cuda_scan").query(plan, lq, uq, eps_rel=eps_rel)
    want = REngine(backend="pallas_scan").query(rplan, lq, uq,
                                                eps_rel=eps_rel)
    _same(got, want)
    cuda = Engine(backend="cuda").query(plan, lq, uq, eps_rel=eps_rel)
    np.testing.assert_array_equal(got.answer.numpy(), cuda.answer.numpy())
    np.testing.assert_array_equal(got.refined.numpy(), cuda.refined.numpy())


@pytest.mark.parametrize("agg", ["count", "sum"])
def test_quantile_scan_route_matches_reference(tables, card_route, agg):
    _, rplan, plan = tables[1][agg]
    fr = np.linspace(0.0, 1.0, 200)
    got = execute_quantile(plan, fr, backend="cuda_scan")
    want = REngine(backend="pallas_scan").quantile(rplan, fr)
    gather = execute_quantile(plan, fr, backend="cuda")
    for g, w, a in zip(got, want, gather):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        np.testing.assert_array_equal(g.numpy(), a.numpy())


DCAP = 256


@pytest.fixture(scope="module")
def ops(tables):
    """One op sequence over the tables' keys: inserts in and out of the
    domain, deletes of base keys (for MAX/MIN: victims shadowed until a
    merge), a pending insert deleted again."""
    keys = tables[0]
    rng = np.random.default_rng(43)
    ins_k = np.concatenate([rng.uniform(0, 800, 56), [-5.0, 810.0]])
    ins_v = rng.uniform(0, 10, len(ins_k))
    del_k = np.unique(keys[rng.integers(0, len(keys), 24)])
    return ins_k, ins_v, del_k


def _updates(dyn, agg, ops):
    ins_k, ins_v, del_k = ops
    scale = 100 if agg in ("max", "min") else 1
    if agg == "count":
        dyn.insert(ins_k)
    else:
        dyn.insert(ins_k, ins_v * scale)
    dyn.delete(del_k)
    dyn.delete(ins_k[:3])          # pending inserts deleted again


def _log_layout(keys, vals):
    """Assert the DeltaBuffer layout K16 relies on (keys non-decreasing;
    from the first sentinel on every slot holds the sentinel key with value
    0) and return the number of live slots."""
    k, v = keys.numpy(), vals.numpy()
    big = big_sentinel(torch.float64)
    assert np.all(np.diff(k) >= 0)
    live = int(np.argmax(k == big)) if (k == big).any() else len(k)
    assert np.all(k[:live] < big)
    assert np.all(k[live:] == big) and np.all(v[live:] == 0)
    return live


def _port_logs(source, tables, ops):
    """(keys, vals) of every log ``source`` builds, in order: the append
    with ties; a dynamic SUM or COUNT table's insert and delete logs before
    and after a merge; a window's open epoch after ingests and a seal."""
    if source == "append":
        empty = torch.full((DCAP,), big_sentinel(torch.float64),
                           dtype=torch.float64)
        rng = np.random.default_rng(61)
        k1 = np.round(rng.uniform(0, 50, 90), 0)           # many ties
        k2 = np.concatenate([k1[:20], np.round(rng.uniform(0, 50, 30), 0)])
        k, v, _, _ = dyn_mod._append_1d(
            empty, torch.zeros(DCAP, dtype=torch.float64),
            torch.as_tensor(k1), torch.as_tensor(rng.normal(0, 5, 90)),
            cap=DCAP, with_st=False)
        out = [(k, v)]
        k, v, _, _ = dyn_mod._append_1d(
            k, v, torch.as_tensor(k2), torch.as_tensor(rng.normal(0, 5, 50)),
            cap=DCAP, with_st=False)
        return out + [(k, v)]
    if source == "window":
        eps = _epochs(seed=67, n_epochs=4, rows=300)
        w = WindowEngine(eps[0], agg="count", delta=16.0, deg=2, ring=8,
                         capacity=512, backend="cuda_scan", device="cpu")
        w.ingest(eps[1])
        w.ingest(eps[1][:40])                               # repeated keys
        out = [(w._buf.ins_keys, w._buf.ins_vals)]
        w.advance()
        out.append((w._buf.ins_keys, w._buf.ins_vals))
        w.ingest(eps[2])
        return out + [(w._buf.ins_keys, w._buf.ins_vals)]
    agg = source.split("_")[1]
    dyn = DynamicEngine(index_from_numpy(_fields(tables[1][agg][0]), "cpu"),
                        backend="cuda_scan", capacity=DCAP, auto_refit=False)

    def logs():
        buf = dyn.snapshot()[1]
        return [(buf.ins_keys, buf.ins_vals), (buf.del_keys, buf.del_vals)]

    _updates(dyn, agg, ops)
    out = logs()
    dyn.flush()                 # merged: both logs empty
    out += logs()
    ins_k, ins_v, _ = ops       # and refilled after the merge
    dyn.insert(ins_k[:20], None if agg == "count" else ins_v[:20])
    dyn.delete(ins_k[:5])
    return out + logs()


@pytest.mark.parametrize("source", ["append", "dynamic_sum",
                                    "dynamic_count", "window"])
def test_port_logs_keep_the_sentinel_tail(tables, ops, card_route, source):
    """Every log the port hands K16 is sorted with a sentinel tail of value
    0, the layout at whose first sentinel tile K16 stops; on the logs that
    hold entries, at partial fill, the plain K16 equals delta_sum_pallas
    (exactly on unit measures, within 1e-12 x sum |v| otherwise)."""
    logs = _port_logs(source, tables, ops)
    lives = [_log_layout(k, v) for k, v in logs]
    assert any(0 < n < k.shape[0] for n, (k, _) in zip(lives, logs))
    rng = np.random.default_rng(71)
    for live, (keys, vals) in zip(lives, logs):
        if not live:
            continue
        k = keys[:live].numpy()
        a, b = rng.uniform(k[0] - 5, k[-1] + 5, (2, BQ))
        lq, uq = np.minimum(a, b), np.maximum(a, b)
        on = k[:8]                                          # on the keys
        lq[:len(on)], uq[:len(on)] = on, on + 1.0
        want = np.asarray(delta_sum_pallas(
            jnp.asarray(lq), jnp.asarray(uq), jnp.asarray(keys.numpy()),
            jnp.asarray(vals.numpy()), bq=BQ, bd=128))
        got = kdel.delta_sum_plain(torch.as_tensor(lq), torch.as_tensor(uq),
                                   keys, vals).numpy()
        v = vals.numpy()
        if np.all(v[:live] == np.round(v[:live])):
            np.testing.assert_array_equal(got, want)
        else:
            assert np.all(np.abs(got - want) <= 1e-12 * np.abs(v).sum())


def _segment_layout(plan):
    """Assert the layout K15 relies on (engine.plan.build_plan): seg_lo
    non-decreasing and below the sentinel on the h real segments, the
    sentinel on the padded tail only, seg_next[j] == seg_lo[j + 1] with the
    sentinel last, seg_agg finite on the real segments and -inf on the
    tail, no NaN anywhere."""
    lo, nx, agg = (t.numpy() for t in (plan.seg_lo, plan.seg_next,
                                       plan.seg_agg))
    big, h = big_sentinel(plan.seg_lo.dtype), plan.h
    assert not any(np.isnan(a).any() for a in (lo, nx, agg))
    assert np.all(np.diff(lo) >= 0)
    assert np.all(lo[:h] < big) and np.all(lo[h:] == big)
    assert np.all(nx[:-1] == lo[1:]) and nx[-1] == big
    assert np.all(np.isfinite(agg[:h])) and np.all(agg[h:] == -np.inf)


def _k15_count_form(lq, uq, plan):
    """A numpy transcription of K15's formulation (csrc/scan1d.cu): it
    counts c_l = #(seg_lo <= lq), and n and the max of seg_agg over the
    interior !(seg_lo <= lq) & (seg_next <= uq) (emptied for a NaN lq);
    then #(seg_lo <= uq) is c_l + n + 1 for n > 0, else c_l plus whether
    seg_lo[c_l] <= uq; each boundary row is c - 1 where q < seg_next[c - 1]
    (else none); then range_max_plain's closed-form tail on those rows.
    Returns the answers and the two rows."""
    lo, nx, agg = (t.numpy() for t in (plan.seg_lo, plan.seg_next,
                                       plan.seg_agg))
    H = len(lo)

    def row(c, q):
        hit = (c > 0) & (q < nx[np.maximum(c - 1, 0)])
        return torch.as_tensor(np.where(hit, c - 1, -1))

    c_l = (lo[None, :] <= lq[:, None]).sum(axis=1)
    inside = ~(lo[None, :] <= lq[:, None]) & (nx[None, :] <= uq[:, None])
    n = inside.sum(axis=1)
    c_u = np.where(n > 0, c_l + n + 1,
                   c_l + ((c_l < H) & (lo[np.minimum(c_l, H - 1)] <= uq)))
    m_int = np.where(inside, agg[None, :], -np.inf).max(axis=1)
    m_int = torch.as_tensor(np.where(np.isnan(lq), -np.inf, m_int))
    il, iu = row(c_l, lq), row(c_u, uq)
    lq, uq = torch.as_tensor(lq), torch.as_tensor(uq)
    cl, lo_l, hi_l = gather_rows(il, plan.coeffs, plan.seg_lo, plan.seg_hi)
    cu, lo_u, hi_u = gather_rows(iu, plan.coeffs, plan.seg_lo, plan.seg_hi)
    same = (lo_l == lo_u) & (hi_l == hi_u)
    m_left = clipped_poly_max(cl, lo_l, hi_l, lq, torch.minimum(hi_l, uq))
    m_left = torch.where(lq <= hi_l, m_left, -torch.inf)
    m_right = clipped_poly_max(cu, lo_u, hi_u, torch.maximum(lo_u, lq), uq)
    m_right = torch.where(same, -torch.inf, m_right)
    return (torch.maximum(torch.maximum(m_left, m_right), m_int).numpy(),
            il.numpy(), iu.numpy())


def _layout_plans(source, tables, ops):
    """The plan ``source`` names, lowered by the port: the static MAX or
    MIN plan (engine.build_plan), a dynamic MAX plan after a merge, the
    float32 kernels.ops MAX table, and a float32 table over keys near 1e7
    0.05 apart, where several segment starts round to one float."""
    if source in ("static_max", "static_min"):
        idx = tables[1][source.split("_")[1]][0]
        return t_build_plan(index_from_numpy(_fields(idx), "cpu"))
    if source == "dynamic_merged":
        dyn = DynamicEngine(
            index_from_numpy(_fields(tables[1]["max"][0]), "cpu"),
            backend="cuda_scan", capacity=DCAP, auto_refit=False)
        _updates(dyn, "max", ops)
        dyn.flush()
        assert dyn.refit_count == 1 and dyn.n_pending == 0
        return dyn.snapshot()[0]
    if source == "ops_f32":
        return kops.from_index(
            index_from_numpy(_fields(tables[1]["max"][0]), "cpu"))
    keys = 1e7 + 0.05 * np.arange(1500)
    idx = t_build_1d(keys, hki_series(1500, seed=3)[1], "max", deg=3,
                     delta=15.0, device="cpu")
    return kops.from_index(idx, torch.float32)


@pytest.mark.parametrize("source", ["static_max", "static_min",
                                    "dynamic_merged", "ops_f32",
                                    "ops_f32_ties"])
def test_port_plans_keep_the_segment_layout(tables, ops, card_route,
                                            source):
    """Every segment table the port hands K15 keeps the layout the kernel
    relies on, and on it the kernel's count formulation equals the plain
    K15 (one-hot first hit, interior lo > lq) bit for bit: on every
    segment start, just below every next start, the domain's low end,
    float32 starts that round to one float, inverted ranges and NaN
    lanes."""
    plan = _layout_plans(source, tables, ops)
    _segment_layout(plan)
    dt = plan.seg_lo.dtype
    lo = plan.seg_lo.numpy()[:plan.h]
    below = np.nextafter(plan.seg_next.numpy()[:plan.h],
                         np.array(-np.inf, dtype=lo.dtype))
    if source == "ops_f32_ties":
        assert np.any(np.diff(lo) == 0), "no float32 starts coincide"
    rng = np.random.default_rng(73)
    pick = lambda a: a[rng.integers(0, len(a), len(a))]
    ends = np.concatenate([lo, below, [lo[0]]])
    a = np.concatenate([ends, pick(ends), lo])
    b = np.concatenate([pick(ends), ends, below])
    # then inverted ranges, and NaN lanes: lq, uq, both
    lq = np.concatenate([np.minimum(a, b), np.maximum(a, b)[::7],
                         [np.nan, lo[0], np.nan]])
    uq = np.concatenate([np.maximum(a, b), np.minimum(a, b)[::7],
                         [lo[-1], np.nan, np.nan]])
    lq, uq = lq.astype(lo.dtype), uq.astype(lo.dtype)
    want = kmax.range_max_plain(
        torch.as_tensor(lq), torch.as_tensor(uq), plan.seg_lo,
        plan.seg_next, plan.seg_hi, plan.coeffs, plan.seg_agg)
    assert want.dtype == dt
    got, il, iu = _k15_count_form(lq, uq, plan)
    np.testing.assert_array_equal(got, want.numpy())
    # the very rows the one-hot membership finds (for uq on every range
    # that is not inverted; on an inverted one both clipped maxima are
    # empty whatever the rows)
    rows = [ksum.segment_rows(torch.as_tensor(q), plan.seg_lo,
                              plan.seg_next).numpy() for q in (lq, uq)]
    np.testing.assert_array_equal(il, rows[0])
    ok = ~(lq > uq)
    np.testing.assert_array_equal(iu[ok], rows[1][ok])


# K14's walk (csrc/scan1d.cu range_sum_scan_kernel): kRangeTile segment
# starts a tile
K14_TILE = 128


def _k14_count_walk(lq, uq, seg_lo, seg_next, seg_hi, coeffs):
    """K14's formulation in torch: the tiles of seg_lo walked up to the
    first that starts on the sentinel, #(seg_lo <= q) counted over the
    walked starts for each endpoint, its row the segment c - 1 where
    q < seg_next[c - 1] (boundary_row; a zero row where none), then Horner
    at the scaled coordinate, P(uq) - P(lq).  Returns the answers, the
    starts walked and the two endpoints' rows."""
    big = big_sentinel(seg_lo.dtype)
    H = seg_lo.shape[0]
    walked = next((t for t in range(0, H, K14_TILE) if seg_lo[t] == big), H)
    vals, rows = [], []
    for q in (lq, uq):
        c = (seg_lo[None, :walked] <= q[:, None]).sum(dim=1)
        hit = (c > 0) & (q < seg_next[(c - 1).clamp(min=0)])
        rows.append(torch.where(hit, c - 1, -1))
        cf, lo, hi = gather_rows(rows[-1], coeffs, seg_lo, seg_hi)
        vals.append(horner(cf, scale_unit(q, lo, hi)))
    return vals[1] - vals[0], walked, rows


def _segment_table(live, n, dt, seed=0):
    """A segment table in a plan's layout with ``live`` segments in ``n``
    slots at type ``dt``: starts sorted from 0 (two equal ones, a segment
    that holds nothing, where there are more than 8), seg_next the next
    start and the sentinel last, random cubic rows.  (seg_lo, seg_next,
    seg_hi, coeffs)."""
    rng = np.random.default_rng(seed + live)
    big = big_sentinel(dt)
    lo = np.sort(rng.uniform(0, 1000, live))
    lo[0] = 0.0
    if live > 8:
        lo[4] = lo[5]
    nx = np.append(lo[1:], big)
    hi = np.append(lo[:-1] + 0.9 * (lo[1:] - lo[:-1]), 1000.0)
    pad = lambda a, v: torch.as_tensor(
        np.concatenate([a, np.full((n - live, *a.shape[1:]), v)]), dtype=dt)
    return (pad(lo, big), pad(nx, big), pad(hi, big),
            pad(rng.normal(0, 1, (live, 4)), 0.0))


def _k14_table(source, plans, tables):
    """(seg_lo, seg_next, seg_hi, coeffs) of the table ``source`` names:
    the reference's SUM plans at deg 1-3 carried into the port, the deg-3
    one with two equal starts, a float32 ``kernels.ops`` SUM table, the
    float32 table whose starts round to one float, or a synthetic table of
    (live, slots) at float64 or float32."""
    if source.startswith("sum"):
        p = port_plan(plans[1]["sum", int(source[3])])
        lo, nx = p.seg_lo.clone(), p.seg_next.clone()
        if source.endswith("ties"):
            assert p.h > 8
            lo[4] = lo[5]
            nx[3] = lo[4]
        return lo, nx, p.seg_hi, p.coeffs
    if source.startswith("ops_f32"):
        if source == "ops_f32":
            p = kops.from_index(index_from_numpy(
                _fields(tables[1]["sum"][0]), "cpu"))
        else:
            p = _layout_plans(source, tables, None)
        assert p.seg_lo.dtype == torch.float32
        return p.seg_lo, p.seg_next, p.seg_hi, p.coeffs
    _, live, n, dt = source.split("_")
    return _segment_table(int(live), int(n), getattr(torch, dt))


def _k14_lanes(seg_lo, seg_next, seed=0):
    """Ranges over a table: every start, just below every next start, the
    table's low end and below it, NaN, +-inf, the sentinel and above it,
    random keys over the domain; paired both ways (some inverted)."""
    big = big_sentinel(seg_lo.dtype)
    h = int((seg_lo < big).sum())
    lo, nx = seg_lo.numpy()[:h], seg_next.numpy()[:h]
    dt = lo.dtype
    below = np.nextafter(nx, np.array(-np.inf, dtype=dt))
    rng = np.random.default_rng(seed)
    span = float(lo[-1] - lo[0]) + 1.0
    special = np.array([np.nan, np.inf, -np.inf, big,
                        np.nextafter(np.array(big, dtype=dt),
                                     np.array(np.inf, dtype=dt)),
                        float(lo[0]) - 1.0, lo[0]], dtype=dt)
    rand = rng.uniform(lo[0] - 0.05 * span, lo[-1] + 0.05 * span, 200)
    a = np.concatenate([lo, below, special, rand.astype(dt)])
    b = rng.permutation(a)
    lq = np.concatenate([a, np.minimum(a, b)])
    uq = np.concatenate([b, np.maximum(a, b)])
    return torch.as_tensor(lq), torch.as_tensor(uq)


@pytest.mark.parametrize("source", ["sum1", "sum2", "sum3", "sum3_ties",
                                    "ops_f32", "ops_f32_ties",
                                    "grid_1_512_float64",
                                    "grid_128_256_float64",
                                    "grid_200_512_float64",
                                    "grid_300_300_float64",
                                    "grid_700_1024_float32"])
def test_range_sum_count_walk_matches_plain(plans, tables, source):
    """K14's count walk (the starts' tiles up to the sentinel tail, the two
    counts, boundary_row, Horner) equals the plain K14 (one-hot first hit
    over every entry) bit for bit, and finds the very rows the one-hot
    membership finds, on the reference's SUM plans at deg 1-3, a float32
    ops table, float32 starts that round to one float, two equal starts,
    and tables whose tail starts mid-tile, on a tile edge or not at all;
    on every start, just below every next start, below the table, NaN,
    +-inf, at and above the sentinel, and inverted ranges."""
    table = _k14_table(source, plans, tables)
    lq, uq = _k14_lanes(*table[:2])
    assert lq.dtype == table[0].dtype
    got, walked, rows = _k14_count_walk(lq, uq, *table)
    want = ksum.range_sum_plain(lq, uq, *table)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    for q, r in zip((lq, uq), rows):
        assert torch.equal(r, ksum.segment_rows(q, *table[:2]))
    h = int((table[0] < big_sentinel(table[0].dtype)).sum())
    assert walked == min(table[0].shape[0], -(-h // K14_TILE) * K14_TILE)
    if source.endswith("ties"):
        assert (table[0][1:h] == table[0][:h - 1]).any()


@pytest.mark.parametrize("agg", AGGS)
def test_dynamic_scan_matches_reference(tables, ops, card_route, agg):
    _, plans, (lq, uq) = tables
    idx = plans[agg][0]
    kw = dict(capacity=DCAP, auto_refit=False)
    ref = RDynamicEngine(idx, backend="pallas_scan", **kw)
    scan = DynamicEngine(index_from_numpy(_fields(idx), "cpu"),
                         backend="cuda_scan", **kw)
    cuda = DynamicEngine(index_from_numpy(_fields(idx), "cpu"),
                         backend="cuda", **kw)
    for e in (ref, scan, cuda):
        _updates(e, agg, ops)
    _, buf = scan._state
    assert buf.ins_st is None               # K17 reads the log itself
    assert cuda._state[1].ins_st is not None or agg in ("sum", "count")
    if agg in ("max", "min"):
        assert buf.vic_keys is not None     # shadowed victims
    for eps_rel in (None, 0.05):
        got = scan.query(lq, uq, eps_rel=eps_rel)
        _same(got, ref.query(lq, uq, eps_rel=eps_rel))
        # the whole-log scans add the log's unit measures exactly; on the
        # SUM table the sums may round apart from the prefix differences
        want = cuda.query(lq, uq, eps_rel=eps_rel)
        if agg == "sum":
            np.testing.assert_allclose(got.answer.numpy(),
                                       want.answer.numpy(), **TOL)
        else:
            np.testing.assert_array_equal(got.answer.numpy(),
                                          want.answer.numpy())
        np.testing.assert_array_equal(got.refined.numpy(),
                                      want.refined.numpy())


def _epochs(seed=29, n_epochs=5, rows=400):
    rng = np.random.default_rng(seed)
    return [np.round(rng.uniform(-100, 100, rows), 3)
            for _ in range(n_epochs)]


def _fill(w, eps):
    """Epochs 1-3 sealed, epoch 4 left open."""
    for e in eps[1:4]:
        w.ingest(e)
        w.advance()
    w.ingest(eps[4])
    return w


def test_window_scan_matches_reference(card_route):
    eps = _epochs()
    kw = dict(agg="count", delta=16.0, deg=2, ring=8, capacity=512)
    ref = _fill(RWindowEngine(eps[0], backend="pallas_scan", **kw), eps)
    port = _fill(WindowEngine(eps[0], backend="cuda_scan", device="cpu",
                              **kw), eps)
    cuda = _fill(WindowEngine(eps[0], backend="cuda", device="cpu", **kw),
                 eps)
    rng = np.random.default_rng(31)
    lq = rng.uniform(-110, 90, 200)
    uq = lq + rng.uniform(0, 60, 200)
    for t0, t1 in [(0, 4), (3, 4), (1, 1), (4, 4), (0, 3)]:
        for eps_rel in (None, 0.05):
            got = port.query(lq, uq, t0, t1, eps_rel=eps_rel)
            _same(got, ref.query(lq, uq, t0, t1, eps_rel=eps_rel))
            _same(got, cuda.query(lq, uq, t0, t1, eps_rel=eps_rel),
                  exact=True)


# ---------------------------------------------------------------------------
# what cuda_scan refuses
# ---------------------------------------------------------------------------

def test_scan_backend_is_listed_and_needs_a_card(tables):
    _, plans, (lq, uq) = tables
    _, _, plan = plans["sum"]
    assert "cuda_scan" in BACKENDS
    with pytest.raises(ValueError, match="CUDA device"):
        Engine(backend="cuda_scan").sum(plan, lq, uq)
    with pytest.raises(ValueError, match="CUDA device"):
        execute(plan, (lq, uq), backend="cuda_scan")
    with pytest.raises(ValueError, match="CUDA device"):
        WindowEngine(np.arange(10.0), agg="count", delta=4.0,
                     backend="cuda_scan", device="cpu")

