"""repro_torch's sharded tables (``engine/sharded.py``) against repro's.

The reference's own sharded tests need 8 JAX devices and skip on a
single-device host; its partition functions need no mesh, and its
selftests (tests/test_sharded.py, run in tier-1 through a subprocess with
8 forced devices) hold its sharded answers equal to its unsharded
``Engine(backend="xla")`` answers bit for bit.  So the port is held to the
reference in three ways, none needing a device mesh:

(a) ``shard_plan``, ``shard_buffer`` and ``shard_plan_2d`` equal the
    reference's partitions field by field, exactly, at S in {1, 2, 4, 8}
    (reference plans carried across with ``plan_from_numpy`` /
    ``plan2d_from_numpy``), a plan with fewer segments than shards
    included; a 2-D plan without the Morton layout raises;
(b) the port's sharded answers agree with the reference's *unsharded*
    answers (static Q_abs and Q_rel with ranges on and around the shard
    bounds, dynamic states after inserts and deletes, the four 2-D
    aggregates static and dynamic, a 1-D and a 2-D LSM ladder under Q_abs)
    at rtol = atol = 1e-9 with equal refined flags, at S in {2, 8};
(c) the port's sharded answers equal the port's unsharded ``'torch'``
    answers exactly (``torch.equal``, -0.0 equal to +0.0) at S in
    {1, 2, 4, 8}: static, dynamic (victims of extremal deletes included),
    2-D and LSM ladders of every aggregate;

and (d) a session with ``shards=2`` answers a mixed batch as the
reference's unsharded session does (1e-9) and as the port's unsharded
session does (exactly)."""
import torch_threads  # noqa: F401  (one intra-op thread per test process)
import dataclasses

import numpy as np
import pytest
import jax
import torch

jax.config.update("jax_enable_x64", True)

import repro.api as rapi  # noqa: E402
import repro.engine as R  # noqa: E402
from repro.core import build_index_1d, build_index_2d  # noqa: E402
from repro.engine import lsm as ref_lsm  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro_torch.core import (index2d_from_numpy,  # noqa: E402
                              index_from_numpy)
from repro_torch.core import build_index_2d as t_build_2d  # noqa: E402
from repro_torch.engine import (CompactionPolicy,  # noqa: E402
                                DeltaBuffer, DynamicEngine, DynamicEngine2D, Engine,
                                LsmEngine, LsmEngine2D, ShardedEngine,
                                ShardedEngine2D, build_plan_2d, execute_lsm,
                                plan2d_from_numpy, plan_from_numpy,
                                shard_buffer, shard_plan, shard_plan_2d)
from repro_torch.engine.plan import (ARRAY_FIELDS, ARRAY_FIELDS_2D,  # noqa: E402
                                     META_FIELDS, META_FIELDS_2D)

N = 4000
DELTA = 25.0
NQ = 256
CAP = 256
TOL = dict(rtol=1e-9, atol=1e-9)
AGGS = ("sum", "count", "max", "min")
AGGS_2D = ("count2d", "sum2d", "max2d", "min2d")
DELTA_2D = {"count2d": 25.0, "sum2d": 400.0, "max2d": 5.0, "min2d": 5.0}
SHARDS = (1, 2, 4, 8)
EPS = (None, 0.05)
CPU = "cpu"


def _np(a):
    return None if a is None else np.asarray(a)


def _port_plan(rplan):
    fields = {f: _np(getattr(rplan, f)) for f in ARRAY_FIELDS}
    fields.update({f: getattr(rplan, f) for f in META_FIELDS})
    return plan_from_numpy(fields, CPU)


def _port_plan_2d(rplan):
    fields = {f: _np(getattr(rplan, f)) for f in ARRAY_FIELDS_2D}
    fields.update({f: getattr(rplan, f) for f in META_FIELDS_2D})
    return plan2d_from_numpy(fields, CPU)


def _carry(ridx):
    """A reference 1-D index carried into the port."""
    out = {f: _np(getattr(ridx, f)) for f in
           ("seg_lo", "seg_hi", "coeffs", "seg_start", "seg_agg", "st",
            "seg_err")}
    out.update(agg=ridx.agg, deg=ridx.deg, delta=ridx.delta, n=ridx.n)
    es, em = ridx.exact_sum, ridx.exact_max
    out["exact_sum"] = None if es is None else (_np(es.keys), _np(es.cf))
    out["exact_max"] = None if em is None else (
        _np(em.keys), _np(em.measures), _np(em.st))
    return index_from_numpy(out, CPU)


def _carry_2d(ridx):
    """A reference 2-D index carried into the port."""
    ex = ridx.exact
    fields = {f: _np(getattr(ridx, f)) for f in
              ("children", "leaf_of", "bounds", "coeffs", "leaf_nodes",
               "leaf_agg", "leaf_err", "measures_sorted")}
    fields.update(deg=ridx.deg, delta=ridx.delta, max_depth=ridx.max_depth,
                  root_bounds=ridx.root_bounds, n=ridx.n, agg=ridx.agg,
                  extremal_floor=ridx.extremal_floor,
                  exact=None if ex is None else tuple(
                      _np(a) for a in (ex.xs, ex.ys_levels, ex.wcum_levels,
                                       ex.wpmax_levels, ex.ws)))
    return index2d_from_numpy(fields, CPU)


def _agree(got, want):
    """Port answers against the reference's, at 1e-9, refined flags equal."""
    for f in ("answer", "approx"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), **TOL,
                                   err_msg=f)
    np.testing.assert_array_equal(got.refined.numpy(),
                                  np.asarray(want.refined))


def _equal(got, want):
    """Port sharded answers against the port's unsharded ones, exactly."""
    for f in ("answer", "approx", "refined"):
        a, b = getattr(got, f), getattr(want, f)
        assert torch.equal(a, b), (f, a[a != b][:5], b[a != b][:5])


# ---------------------------------------------------------------------------
# fixtures: tests/test_sharded.py's data, every index built once
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    """The reference test's keys, measures and ranges (seed 3), the ranges
    padded to NQ with ranges on, just around and across the S = 8 shard
    bounds of the MAX plan, and past both ends of the keys."""
    rng = np.random.default_rng(3)
    keys = np.sort(rng.uniform(0, 1000, N))
    meas = rng.uniform(0, 10, N)
    a = keys[rng.integers(0, N, 160)]
    b = keys[rng.integers(0, N, 160)]
    return keys, meas, np.minimum(a, b), np.maximum(a, b)


@pytest.fixture(scope="module")
def indexes(data):
    keys, meas, _, _ = data
    return {agg: build_index_1d(keys, m, agg, deg=deg, delta=DELTA)
            for agg, m, deg in (("sum", meas, 2), ("count", None, 2),
                                ("max", meas * 100, 3),
                                ("min", meas * 100, 3))}


@pytest.fixture(scope="module")
def plans(indexes):
    """agg -> (reference plan, port plan)."""
    out = {}
    for agg, idx in indexes.items():
        rplan = R.build_plan(idx)
        out[agg] = (rplan, _port_plan(rplan))
    return out


@pytest.fixture(scope="module")
def ranges(data, plans):
    _, _, lq, uq = data
    edges = np.asarray([e for e in shard_plan(plans["max"][1], 8).bounds
                        if np.isfinite(e)])
    lo = np.concatenate([lq, edges, edges - 1e-9, edges - 5.0,
                         [-30.0, 1.0, 500.0, 990.0]])
    hi = np.concatenate([uq, edges + 29.0, edges + 1e-9, edges + 5.0,
                         [1030.0, -5.0, 1200.0, 2000.0]])
    pad = NQ - len(lo)
    rng = np.random.default_rng(9)
    x = rng.uniform(-20, 1020, (2, pad))
    return (np.concatenate([lo, x.min(0)]), np.concatenate([hi, x.max(0)]))


@pytest.fixture(scope="module")
def dynamic(data, indexes):
    """agg -> (reference DynamicEngine on xla, port DynamicEngine), fed the
    same inserts (in and out of the key domain) and deletes (tombstones
    for SUM/COUNT, shadowed victims for MAX/MIN)."""
    keys, _, _, _ = data
    rng = np.random.default_rng(17)
    out = {}
    for agg, idx in indexes.items():
        re = R.DynamicEngine(idx, backend="xla", capacity=CAP,
                             auto_refit=False)
        te = DynamicEngine(_carry(idx), capacity=CAP, auto_refit=False)
        k = rng.uniform(-50, 1100, 48)
        v = None if agg == "count" else rng.uniform(0, 500, 48)
        for e in (re, te):
            e.insert(k, v)
            e.delete(keys[30:40])
        out[agg] = (re, te)
    return out


@pytest.fixture(scope="module")
def data2d():
    """tests/test_sharded.py's 2-D data (seed 0x2D5): points, measures,
    96 rectangles, 96 data-anchored corners, one reference index an
    aggregate (max_depth 6)."""
    rng = np.random.default_rng(0x2D5)
    n = 2000
    px, py = rng.uniform(0, 100, n), rng.uniform(0, 100, n)
    w = 50 + 10 * np.sin(px / 9) + 10 * np.cos(py / 13)
    idx = {agg: build_index_2d(px, py,
                               measures=None if agg == "count2d" else w,
                               agg=agg, deg=2, delta=DELTA_2D[agg],
                               max_depth=6) for agg in AGGS_2D}
    nq = 96
    lx = rng.uniform(0, 75, nq)
    ux = lx + rng.uniform(5, 25, nq)
    ly = rng.uniform(0, 75, nq)
    uy = ly + rng.uniform(5, 25, nq)
    ci = rng.integers(0, n, nq)
    return px, py, w, idx, (lx, ux, ly, uy), (px[ci], py[ci])


@pytest.fixture(scope="module")
def plans2d(data2d):
    out = {}
    for agg, idx in data2d[3].items():
        rplan = R.build_plan_2d(idx)
        out[agg] = (rplan, _port_plan_2d(rplan))
    return out


@pytest.fixture(scope="module")
def dynamic2d(data2d):
    """agg -> (reference DynamicEngine2D on xla, port DynamicEngine2D) after
    24 inserts and 8 deletes (victims on the dominance tables)."""
    px, py, _, idx, _, _ = data2d
    rng = np.random.default_rng(23)
    out = {}
    for agg in AGGS_2D:
        re = R.DynamicEngine2D(idx[agg], backend="xla", capacity=128,
                               auto_refit=False)
        te = DynamicEngine2D(_carry_2d(idx[agg]), capacity=128,
                             auto_refit=False)
        ins = (rng.uniform(5, 95, 24), rng.uniform(5, 95, 24))
        if agg != "count2d":
            ins = ins + (rng.uniform(30, 70, 24),)
        for e in (re, te):
            e.insert(*ins)
            e.delete(px[30:38], py[30:38])
        out[agg] = (re, te)
    return out


def _queries2d(data2d, agg):
    return data2d[4] if agg in ("count2d", "sum2d") else data2d[5]


# ---------------------------------------------------------------------------
# (a) partitions, field by field
# ---------------------------------------------------------------------------

_SPLAN_META = ("agg", "deg", "delta", "h", "n", "nshards", "domain_lo",
               "bounds")
_SPLAN_ARRAYS = ("rlo", "rhi", "off", "hloc", "seg_lo", "seg_hi", "coeffs",
                 "seg_agg", "st", "ref_keys", "ref_cf", "ref_st")
_SPLAN2D_META = ("agg", "deg", "delta", "n", "n_leaves", "nshards",
                 "max_depth", "root", "zbounds")
_SPLAN2D_ARRAYS = ("zlo", "zhi", "leaf_z", "leaf_bounds", "leaf_coeffs",
                   "xcuts", "ycuts", "ref_xs", "ref_ys_levels", "ref_wcum",
                   "ref_wpmax")


def _same_fields(got, want, meta, arrays):
    for f in meta:
        assert getattr(got, f) == getattr(want, f), f
    for f in arrays:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if g is not None:
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype, f
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f)


@pytest.fixture(scope="module")
def few():
    """tests/test_sharded.py's plan with fewer segments than shards."""
    keys = np.sort(np.random.default_rng(0).uniform(0, 100, 500))
    rplan = R.build_plan(build_index_1d(keys, None, "count", deg=2,
                                        delta=1000.0))
    assert rplan.h < 8
    return rplan, _port_plan(rplan)


@pytest.mark.parametrize("nshards", SHARDS)
@pytest.mark.parametrize("agg", AGGS + ("few",))
def test_shard_plan_matches_reference(plans, few, agg, nshards):
    rplan, tplan = few if agg == "few" else plans[agg]
    got = shard_plan(tplan, nshards)
    _same_fields(got, R.shard_plan(rplan, nshards), _SPLAN_META,
                 _SPLAN_ARRAYS)
    assert got.ref_edges[0] == 0 and got.ref_edges[-1] == tplan.n


@pytest.mark.parametrize("nshards", SHARDS)
@pytest.mark.parametrize("agg", AGGS)
def test_shard_buffer_matches_reference(plans, dynamic, agg, nshards):
    """The reference engine's live buffer, carried across, partitions
    alike; MAX/MIN victims split the victim-masked measures at the
    refinement keys' edges (the port's own fields)."""
    re, _ = dynamic[agg]
    rplan, rbuf = re.snapshot()
    tbuf = DeltaBuffer(**{f.name: (torch.as_tensor(np.array(v))
                                   if hasattr(v, "shape") else v)
                          for f in dataclasses.fields(rbuf)
                          for v in (getattr(rbuf, f.name),)})
    tsp = shard_plan(_port_plan(rplan), nshards)
    got = shard_buffer(tbuf, tsp)
    want = R.shard_buffer(rbuf, R.shard_plan(rplan, nshards))
    assert got.cap == want.cap == CAP
    for f in ("ins_keys", "ins_vals", "ins_cf", "del_keys", "del_vals",
              "del_cf"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    if agg in ("max", "min"):
        live = tbuf.live_st[0].numpy()
        e = tsp.ref_edges
        for s in range(nshards):
            row = got.live_st[s, 0].numpy()
            np.testing.assert_array_equal(row[: e[s + 1] - e[s]],
                                          live[e[s]: e[s + 1]])
            assert np.all(row[e[s + 1] - e[s]:] == -np.inf)
        assert torch.equal(got.vic_keys, tbuf.vic_keys)
    else:
        assert got.vic_keys is None and got.live_st is None


@pytest.mark.parametrize("nshards", SHARDS)
@pytest.mark.parametrize("agg", AGGS_2D)
def test_shard_plan_2d_matches_reference(plans2d, agg, nshards):
    rplan, tplan = plans2d[agg]
    _same_fields(shard_plan_2d(tplan, nshards),
                 R.shard_plan_2d(rplan, nshards), _SPLAN2D_META,
                 _SPLAN2D_ARRAYS)


def test_shard_plan_2d_requires_morton_layout():
    rng = np.random.default_rng(0)
    px, py = rng.uniform(0, 50, 800), rng.uniform(0, 50, 800)
    plan = build_plan_2d(t_build_2d(px, py, deg=2, delta=1000.0,
                                    max_depth=16, device=CPU))
    assert plan.leaf_z is None   # beyond the int32 Morton range
    with pytest.raises(ValueError, match="Morton"):
        shard_plan_2d(plan, 2)


# ---------------------------------------------------------------------------
# (b) answers against the reference's unsharded engines, (c) against the
# port's unsharded 'torch' engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("agg", AGGS)
def test_static_1d(plans, ranges, agg):
    rplan, tplan = plans[agg]
    for eps in EPS:
        want = R.Engine(backend="xla").query(rplan, *ranges, eps_rel=eps)
        mine = Engine(backend="torch").query(tplan, *ranges, eps_rel=eps)
        for s in SHARDS:
            got = ShardedEngine(s).query(tplan, *ranges, eps_rel=eps)
            _equal(got, mine)
            if s in (2, 8):
                _agree(got, want)


@pytest.mark.parametrize("agg", AGGS)
def test_dynamic_1d(dynamic, ranges, agg):
    """Tombstones (SUM/COUNT), victims (MAX/MIN) and inserts in and out of
    the key domain: sharded answers over the live (plan, buffer)."""
    re, te = dynamic[agg]
    plan, buf = te.snapshot()
    for eps in EPS:
        want = re.query(*ranges, eps_rel=eps)
        mine = te.query(*ranges, eps_rel=eps)
        for s in SHARDS:
            got = ShardedEngine(s).query(plan, *ranges, eps_rel=eps, buf=buf)
            _equal(got, mine)
            if s in (2, 8):
                _agree(got, want)


# the guarantees held to the reference in 2-D: the reference's jitted
# rectangle Q_rel truths (merge-sort-tree prefix counts over four corners)
# take about ten seconds a shape to compile, so rectangles, and the dynamic
# tables, are held to it under Q_abs; their Q_rel paths are the unsharded
# 'torch' truths, held to the reference by tests/test_torch_engine2d.py and
# tests/test_torch_dynamic2d.py and to the sharded answers exactly below
REF_EPS_2D = {"count2d": (None,), "sum2d": (None,), "max2d": EPS,
              "min2d": EPS}


@pytest.mark.parametrize("agg", AGGS_2D)
def test_static_2d(data2d, plans2d, agg):
    rplan, tplan = plans2d[agg]
    q = _queries2d(data2d, agg)
    for eps in EPS:
        mine = Engine(backend="torch").query(tplan, *q, eps_rel=eps)
        want = (R.Engine(backend="xla").query(rplan, *q, eps_rel=eps)
                if eps in REF_EPS_2D[agg] else None)
        for s in SHARDS:
            got = ShardedEngine2D(s).query(tplan, *q, eps_rel=eps)
            _equal(got, mine)
            if s in (2, 8) and want is not None:
                _agree(got, want)


@pytest.mark.parametrize("agg", AGGS_2D)
def test_dynamic_2d(data2d, dynamic2d, agg):
    re, te = dynamic2d[agg]
    plan, buf = te.snapshot()
    q = _queries2d(data2d, agg)
    for eps in EPS:
        mine = te.query(*q, eps_rel=eps)
        want = re.query(*q) if eps is None else None
        for s in SHARDS:
            got = ShardedEngine2D(s).query(plan, *q, eps_rel=eps, buf=buf)
            _equal(got, mine)
            if s in (2, 8) and want is not None:
                _agree(got, want)


def test_s1_2d_and_quantile_refuse_partitioned_plans(plans, plans2d, data2d):
    """S = 1 in 2-D runs the unsharded executors and refuses a
    pre-partitioned plan; quantiles refuse partitioned plans and answer
    the unsharded one as the 'torch' engine does."""
    tplan = plans2d["count2d"][1]
    rect = _queries2d(data2d, "count2d")
    with pytest.raises(ValueError, match="unsharded"):
        ShardedEngine2D(1).count2d(shard_plan_2d(tplan, 1), *rect)
    assert ShardedEngine2D(1).count2d(tplan, *rect).answer.shape == (96,)
    splan = plans["sum"][1]
    se = ShardedEngine(4)
    with pytest.raises(ValueError, match="unsharded IndexPlan"):
        se.quantile(se.shard(splan), [0.5])
    qs = np.linspace(0.0, 1.0, 33)
    got = se.quantile(splan, qs)
    want = Engine(backend="torch").quantile(splan, qs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# -- LSM ladders ------------------------------------------------------------

LSM_POLICY = dict(watermark=0.5, merge_us_per_row=75.0,
                  query_overhead_us_per_row=0.0, shadow_fraction=0.25)


def _ladder(agg, seed):
    """(reference engine, port engine) replaying one op sequence: 600 base
    rows (300 points in 2-D), inserts that compact into new slots, a
    buffered batch, deletes of base rows."""
    rng = np.random.default_rng(seed)
    two = agg in AGGS_2D
    n, cap = (300, 64) if two else (600, 128)
    kw = dict(agg=agg, delta=20.0 if two else 40.0, capacity=cap, growth=2,
              background=False)
    if two:
        cols = (rng.uniform(0, 100, n), rng.uniform(0, 100, n))
        w = rng.uniform(1, 5, n)
        base = cols + (() if agg == "count2d" else (w,))
        re = R.LsmEngine2D(*base, policy=R.CompactionPolicy(**LSM_POLICY),
                           **kw)
        te = LsmEngine2D(*base, policy=CompactionPolicy(**LSM_POLICY),
                         device=CPU, **kw)
    else:
        keys = np.sort(rng.uniform(0.0, 1000.0, n))
        base = (keys, None if agg == "count" else rng.uniform(0.5, 8.0, n))
        re = R.LsmEngine(*base, policy=R.CompactionPolicy(**LSM_POLICY),
                         **kw)
        te = LsmEngine(*base, policy=CompactionPolicy(**LSM_POLICY),
                       device=CPU, **kw)
    for m in (cap, cap // 3):
        if two:
            ins = (rng.uniform(0, 100, m), rng.uniform(0, 100, m))
            if agg != "count2d":
                ins = ins + (rng.uniform(1, 5, m),)
        else:
            ins = (rng.uniform(1.0, 999.0, m),
                   None if agg == "count" else rng.uniform(0.5, 8.0, m))
        for e in (re, te):
            e.insert(*ins)
    dead = (base[0][:12], base[1][:12]) if two else (base[0][40:60],)
    for e in (re, te):
        e.delete(*dead)
    assert te.n_levels == re.n_levels >= 2
    return re, te


def _lsm_ranges(agg, seed):
    rng = np.random.default_rng(seed)
    if agg in ("count2d", "sum2d"):
        lx, ly = rng.uniform(-5, 80, NQ), rng.uniform(-5, 80, NQ)
        return (lx, lx + rng.uniform(1, 30, NQ), ly,
                ly + rng.uniform(1, 30, NQ))
    if agg in ("max2d", "min2d"):
        return rng.uniform(-5, 100, NQ), rng.uniform(-5, 100, NQ)
    lq = rng.uniform(-20, 1000, NQ)
    return lq, lq + rng.uniform(0, 300, NQ)


@pytest.mark.parametrize("agg", AGGS + AGGS_2D)
def test_lsm_ladders(agg):
    """Every aggregate's ladder (and buffer) through the sharded LSM path
    equals the port's unsharded execute_lsm on 'torch' exactly; the SUM
    and sum2d ladders also agree with the reference's unsharded ladder
    (its levels run one by one through its level_executor, as
    tests/test_torch_lsm.py runs them).  Q_rel on a sharded ladder
    raises, naming Q_abs."""
    re, te = _ladder(agg, 11)
    lsm, buf = te.snapshot()
    q = _lsm_ranges(agg, 12)
    mine = execute_lsm(lsm, buf, q, backend="torch")
    cls = ShardedEngine2D if agg in AGGS_2D else ShardedEngine
    for s in SHARDS:
        _equal(cls(s).query(lsm, *q, buf=buf), mine)
    if agg in ("sum", "sum2d"):
        rlsm, rbuf = re.snapshot()
        core = ref_lsm.level_executor(agg, backend="xla", interpret=True,
                                      bq=64, with_truth=False)
        want = R.execute_lsm(rlsm, rbuf, q, backend="xla",
                             level_runner=lambda i, lvl, *p: core(lvl, *p))
        _agree(ShardedEngine2D(2).query(lsm, *q, buf=buf) if agg == "sum2d"
               else ShardedEngine(8).query(lsm, *q, buf=buf), want)
    with pytest.raises(ValueError, match="Q_abs"):
        cls(2).query(lsm, *q, eps_rel=0.05, buf=buf)


# ---------------------------------------------------------------------------
# (d) the session
# ---------------------------------------------------------------------------

def _session_specs(api, shards):
    kw = {} if shards is None else dict(shards=shards)
    return {"cnt": api.TableSpec("count", api.ErrorBudget(abs=2 * DELTA,
                                                          rel=0.05), **kw),
            "geo": api.TableSpec("count2d", api.ErrorBudget(abs=100.0),
                                 **kw),
            "dyn": api.TableSpec("sum", api.ErrorBudget(abs=2 * DELTA,
                                                        rel=0.05),
                                 dynamic=True, background=False,
                                 auto_refit=False, capacity=64, **kw),
            "tier": api.TableSpec("count", api.ErrorBudget(abs=80.0),
                                  dynamic=True, lsm=True, capacity=64,
                                  background=False, growth=2, **kw)}


@pytest.fixture(scope="module")
def sessions(data, data2d):
    keys, meas, _, _ = data
    px, py = data2d[0], data2d[1]
    small = keys[::4]
    datasets = {"cnt": keys, "geo": (px, py), "dyn": (small, meas[::4]),
                "tier": small}
    ref = rapi.PolyFit.fit(datasets, _session_specs(rapi, None))
    plain = tapi.PolyFit.fit(datasets, _session_specs(tapi, None),
                             device=CPU)
    sharded = tapi.PolyFit.fit(datasets, _session_specs(tapi, 2), device=CPU)
    rng = np.random.default_rng(31)
    k = rng.uniform(0, 1000, 40)
    v = rng.uniform(0, 10, 40)
    for s in (ref, plain, sharded):
        s.insert("dyn", k, v)
        s.delete("dyn", small[10:20])
        s.insert("tier", k[:20])
        s.delete("tier", small[30:40])
    return ref, plain, sharded


def test_session_shards(data, data2d, sessions):
    ref, plain, sharded = sessions
    _, _, lq, uq = data
    rect = data2d[4]

    def batch(api):
        return api.QueryBatch.of(
            api.QuerySpec.range("cnt", lq, uq),
            api.QuerySpec.rect("geo", *rect),
            api.QuerySpec.range("dyn", lq, uq),
            api.QuerySpec.range("tier", lq, uq),
            api.QuerySpec.range("cnt", lq, uq, rel=None),
            api.QuerySpec.quantile("cnt", np.linspace(0, 1, 17)))

    got = sharded.query(batch(tapi))
    mine = plain.query(batch(tapi))
    want = ref.query(batch(rapi))
    for g, m, w in zip(got, mine, want):
        assert torch.equal(g.value, m.value)
        assert torch.equal(g.refined, m.refined)
        np.testing.assert_allclose(g.value.numpy(), np.asarray(w.value),
                                   **TOL)
        np.testing.assert_array_equal(g.refined.numpy(),
                                      np.asarray(w.refined))
        assert g.staleness == m.staleness
    # the dynamic quantile runs the unsharded 'torch' loop (the reference
    # compiles it for seconds; tests/test_torch_dynamic.py holds it)
    q = tapi.QuerySpec.quantile("dyn", np.linspace(0, 1, 17))
    g, m = sharded.query(q), plain.query(q)
    assert torch.equal(g.value, m.value)
    assert all(torch.equal(a, b) for a, b in zip(g.bound, m.bound))
    assert all(sharded.is_sharded(t) for t in sharded.tables)
    assert not any(plain.is_sharded(t) for t in plain.tables)
    with pytest.raises(ValueError, match="shards do not apply"):
        tapi.TableSpec("count", tapi.ErrorBudget(abs=10.0), window=4,
                       shards=2)
    with pytest.raises(ValueError, match="power of two"):
        tapi.PolyFit.fit({"c": data[0][:500]},
                         {"c": tapi.TableSpec("count",
                                              tapi.ErrorBudget(abs=50.0),
                                              shards=3)}, device=CPU)
