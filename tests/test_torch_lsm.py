"""The port's LSM level ladders (``repro_torch.engine.lsm``) against the
reference's (``repro.engine.lsm``), twins of tests/test_lsm.py without its
sharding and serving cases.

One op sequence (full-capacity inserts that compact into new slots, a
buffered batch, deletes of level rows and of buffered inserts) is replayed
through both packages' ``LsmEngine`` / ``LsmEngine2D`` with one explicit
``CompactionPolicy``: after every op the ladders have the same slots, rows
and shadows a level and the same ``compaction_count``, and the answers
agree at rtol = atol = 1e-9 with equal refined flags, for all eight
aggregates, under Q_abs and Q_rel; they also hold against the exact
answers over the live multiset.  The reference's levels run op by op
through its ``level_executor`` (the ``level_runner`` hook of
``execute_lsm``).  The rest runs on the port alone: a one-level ladder is the flat
executor bit for bit, deletes never merge, a compaction installs
atomically under a concurrent reader, the session's ``lsm=True`` tables,
and the policy's ``from_bench`` and ``should_fold``."""
import torch_threads  # noqa: F401  (one intra-op thread per test process)
import json
import threading
from pathlib import Path

import numpy as np
import pytest
import jax
import torch

jax.config.update("jax_enable_x64", True)

import repro.engine as R  # noqa: E402
from repro.engine import lsm as ref_lsm  # noqa: E402
from repro.api import TableSpec as RefTableSpec  # noqa: E402
from repro.api.budget import ErrorBudget as RefBudget  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.core import build_index_1d  # noqa: E402
from repro_torch.engine import (CompactionPolicy, LsmEngine,  # noqa: E402
                                LsmEngine2D, build_plan, composed_bound,
                                execute, execute_lsm)

TOL = dict(rtol=1e-9, atol=1e-9)
CPU = "cpu"
DELTA = 40.0
# one explicit policy for both packages (queries never trigger a
# compaction, so the two sides may run different query counts)
POLICY = dict(watermark=0.5, merge_us_per_row=75.0,
              query_overhead_us_per_row=0.0, shadow_fraction=0.25)
EPS = (None, 0.05, 1e-12)


def _ref_query(eng, qs, eps):
    """The reference engine's answer, its levels run op by op through the
    reference's ``level_executor`` with their truths on (the extremal
    cores ignore the flag; the additive combine reads the truths only
    under Q_rel): no level compiles as a whole, which on the CPU costs
    seconds a level shape."""
    lsm, buf = eng.snapshot()
    core = ref_lsm.level_executor(lsm.agg, backend="xla", interpret=True,
                                  bq=64, with_truth=True)
    return R.execute_lsm(lsm, buf, qs, backend="xla", eps_rel=eps,
                         level_runner=lambda i, lvl, *p: core(lvl, *p))


def _same_ladder(re, te):
    assert sorted(re._levels) == sorted(te._levels)
    for s in re._levels:
        a, b = re._levels[s], te._levels[s]
        assert len(a.cols[0]) == len(b.cols[0])
        assert sorted(a.shadowed()) == sorted(b.shadowed())
        for ca, cb in zip(a.cols, b.cols):
            np.testing.assert_array_equal(ca, cb)
    assert re.compaction_count == te.compaction_count
    assert re.n_pending == te.n_pending
    assert re.n == te.n


def _agree(got, want):
    for f in ("answer", "approx"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), **TOL,
                                   err_msg=f)
    np.testing.assert_array_equal(got.refined.numpy(),
                                  np.asarray(want.refined))


# -- 1-D: one op sequence through both packages ----------------------------

@pytest.fixture(scope="module", params=["sum", "count", "max", "min"])
def ladder1d(request):
    """Base 1,000 rows at slot 3, four 128-row inserts (each compacts: slots
    1, 1, 2, 1), a buffered 40-row batch, then deletes: 30 base rows, 5
    rows of a compacted level and 10 buffered inserts (cancelled in
    place).  Returns (agg, ref engine, port engine, live keys, live
    measures in answer space)."""
    agg = request.param
    rng = np.random.default_rng(11)
    keys = np.sort(rng.uniform(0.0, 1000.0, 1000))
    vals = rng.uniform(0.5, 8.0, 1000)
    meas = lambda v: None if agg == "count" else v
    kw = dict(agg=agg, delta=DELTA, capacity=128, growth=2,
              background=False)
    re = R.LsmEngine(keys, meas(vals), policy=R.CompactionPolicy(**POLICY),
                     **kw)
    te = LsmEngine(keys, meas(vals), policy=CompactionPolicy(**POLICY),
                   device=CPU, **kw)
    live = dict(zip(keys, vals if agg != "count" else np.ones(1000)))
    batches = []
    for m in (128, 128, 128, 128, 40):
        k = rng.uniform(1.0, 999.0, m)
        v = rng.uniform(0.5, 8.0, m)
        re.insert(k, meas(v))
        te.insert(k, meas(v))
        live.update(zip(k, v if agg != "count" else np.ones(m)))
        batches.append(k)
        _same_ladder(re, te)
    assert re.n_levels == 3 and re.n_pending == 40
    for dead in (keys[100:130], batches[0][:5], batches[-1][:10]):
        re.delete(dead)
        te.delete(dead)
        for k in dead:
            del live[k]
        _same_ladder(re, te)
    assert re.compaction_count == 4 and re.n_pending == 30
    lk = np.array(sorted(live))
    lv = np.array([live[k] for k in lk])
    return agg, re, te, lk, lv


def test_ladder_replay_matches_reference(ladder1d):
    """Ranges over the live keys and past both ends: the port's fused
    answers are the reference's, and they hold against the live truth
    (Q_abs within the composed bound, Q_rel at eps 1e-12 exact)."""
    agg, re, te, lk, lv = ladder1d
    rng = np.random.default_rng(3)
    i = rng.integers(0, len(lk) - 1, 96)
    j = np.minimum(i + rng.integers(0, 300, 96), len(lk) - 1)
    lq, uq = lk[i], lk[j]
    if agg in ("sum", "count"):
        # half the ranges are open below the keys: (lq, uq] excludes lq
        lq = np.where(np.arange(96) % 2 == 0, lq - 1e-3, lq)
        lq[:4] = [-30.0, -30.0, lk[0] - 1.0, 500.0]
        uq[:4] = [20.0, 1030.0, lk[-1], 1030.0]
        truth = np.array([lv[(lk > a) & (lk <= b)].sum()
                          for a, b in zip(lq, uq)])
    else:
        lq[:2], uq[:2] = [-30.0, 500.0], [lk[3], 1030.0]
        sign = 1.0 if agg == "max" else -1.0
        truth = np.array([sign * (sign * lv[(lk >= a) & (lk <= b)]).max()
                          for a, b in zip(lq, uq)])
    lsm, _ = te.snapshot()
    assert len(lsm.levels) == 3
    bound = composed_bound(agg, lsm.deltas)
    for eps in EPS:
        got = te.query(lq, uq, eps_rel=eps)
        _agree(got, _ref_query(re, (lq, uq), eps))
        err = np.abs(got.answer.numpy() - truth)
        if eps is None:
            assert err.max() <= bound + 1e-9
        elif eps == 1e-12:
            assert bool(got.refined.all())
            np.testing.assert_allclose(got.answer.numpy(), truth, **TOL)


# -- 2-D: the same sequence over point columns -----------------------------

@pytest.fixture(scope="module", params=["count2d", "sum2d", "max2d", "min2d"])
def ladder2d(request):
    """Base 300 points at slot 3, one 64-point insert (compacts to slot 1),
    a buffered 12-point batch, then deletes: 2 base points, 1 point of the
    compacted level and 3 buffered points.  Returns (agg, ref engine, port
    engine, live xs, ys, measures in answer space)."""
    agg = request.param
    rng = np.random.default_rng(5)
    xs = rng.uniform(0.0, 100.0, 300)
    ys = rng.uniform(0.0, 100.0, 300)
    ws = rng.uniform(1.0, 5.0, 300)
    weighted = agg != "count2d"
    meas = lambda w: w if weighted else None
    delta = {"count2d": 10.0, "sum2d": 30.0}.get(agg, 2.0)
    kw = dict(agg=agg, deg=2, delta=delta, max_depth=8, capacity=64,
              growth=2, background=False)
    re = R.LsmEngine2D(xs, ys, meas(ws), policy=R.CompactionPolicy(**POLICY),
                       **kw)
    te = LsmEngine2D(xs, ys, meas(ws), policy=CompactionPolicy(**POLICY),
                     device=CPU, **kw)
    pts = {(x, y): (w if weighted else 1.0) for x, y, w in zip(xs, ys, ws)}
    batches = []
    for m in (64, 12):
        bx, by = rng.uniform(0.0, 100.0, m), rng.uniform(0.0, 100.0, m)
        bw = rng.uniform(1.0, 5.0, m)
        re.insert(bx, by, meas(bw))
        te.insert(bx, by, meas(bw))
        pts.update(((x, y), (w if weighted else 1.0))
                   for x, y, w in zip(bx, by, bw))
        batches.append((bx, by))
        _same_ladder(re, te)
    assert re.n_levels == 2 and re.n_pending == 12
    for dx, dy in ((xs[40:42], ys[40:42]), (batches[0][0][:1],
                                            batches[0][1][:1]),
                   (batches[1][0][:3], batches[1][1][:3])):
        re.delete(dx, dy)
        te.delete(dx, dy)
        for p in zip(dx, dy):
            del pts[p]
        _same_ladder(re, te)
    assert re.compaction_count == 1 and re.n_pending == 9
    P = np.array(list(pts))
    W = np.array(list(pts.values()))
    return agg, re, te, P[:, 0], P[:, 1], W


def test_ladder2d_replay_matches_reference(ladder2d):
    """Rectangles (some reaching below the levels' roots) or dominance
    corners (some anchored on live points): the port's fused answers are
    the reference's, Q_abs holds the composed bound of the live truth
    (rectangles, and corners that dominate a point of every level) and
    Q_rel at eps 1e-12 is exact."""
    agg, re, te, X, Y, W = ladder2d
    rng = np.random.default_rng(7)
    m = 64
    if agg in ("count2d", "sum2d"):
        qx = np.sort(rng.uniform(-5.0, 105.0, (2, m)), axis=0)
        qy = np.sort(rng.uniform(-5.0, 105.0, (2, m)), axis=0)
        qs = (qx[0], qx[1], qy[0], qy[1])
        truth = np.array([W[(X > a) & (X <= b) & (Y > c) & (Y <= d)].sum()
                          for a, b, c, d in zip(*qs)])
    else:
        k = rng.integers(0, len(X), m)
        u = np.where(np.arange(m) < m // 2, X[k] + 0.5,
                     rng.uniform(-5.0, 105.0, m))
        v = np.where(np.arange(m) < m // 2, Y[k] + 0.5,
                     rng.uniform(-5.0, 105.0, m))
        qs = (u, v)
        sign = 1.0 if agg == "max2d" else -1.0
        truth = np.array([sign * (sign * W[(X <= a) & (Y <= b)]).max()
                          if ((X <= a) & (Y <= b)).any() else -sign * np.inf
                          for a, b in zip(u, v)])
    lsm, _ = te.snapshot()
    assert len(lsm.levels) == 2
    # a leaf that stops at max_depth certifies past delta: the bound
    # composes the levels' certified deltas
    bound = composed_bound(agg, [h.index.certified_delta
                                 for h in te._levels.values()])
    for eps in EPS:
        got = te.query(*qs, eps_rel=eps)
        _agree(got, _ref_query(re, qs, eps))
        ans = got.answer.numpy()
        if eps is None and agg in ("count2d", "sum2d"):
            assert np.abs(ans - truth).max() <= bound + 1e-9
        elif eps == 1e-12:
            np.testing.assert_allclose(ans, truth, **TOL)


def test_extremal_level_holds_its_certificate_off_its_keys():
    """A MAX level's fitted staircase is certified at the level's own keys;
    between two of them (an endpoint that is a key of another level only)
    the polynomial leans towards the next key.  Here level 1 holds two
    keys, 10.5 (measure 0) and 20.5 (1,000): on [5, 15] and [5, 19] the
    reference's level part over-reports its truth (0) by far more than
    delta, and so does its fused answer; the port holds each part within
    delta of the level's exact live maximum, and equals the reference
    where the reference's parts hold their certificate."""
    rng = np.random.default_rng(0)
    keys = np.arange(1000.0)
    vals = rng.uniform(0.0, 10.0, 1000)
    kw = dict(agg="max", delta=50.0, deg=3, capacity=128, background=False)
    re = R.LsmEngine(keys, vals, policy=R.CompactionPolicy(**POLICY), **kw)
    te = LsmEngine(keys, vals, policy=CompactionPolicy(**POLICY),
                   device=CPU, **kw)
    for e in (re, te):
        e.insert(np.array([10.5, 20.5]), np.array([0.0, 1000.0]))
        e.flush()
        assert e.n_levels == 2
    lq = np.array([5.0, 5.0, 0.0, 12.0])
    uq = np.array([15.0, 19.0, 30.0, 18.0])
    k = np.concatenate([keys, [10.5, 20.5]])
    v = np.concatenate([vals, [0.0, 1000.0]])
    truth = np.array([v[(k >= a) & (k <= b)].max() for a, b in zip(lq, uq)])
    bound = composed_bound("max", te.snapshot()[0].deltas)
    want = np.asarray(_ref_query(re, (lq, uq), None).answer)
    got = te.query(lq, uq).answer.numpy()
    assert np.all(np.abs(want[:2] - truth[:2]) > bound)
    assert np.all(np.abs(got - truth) <= bound)
    np.testing.assert_array_equal(got[2:], want[2:])


# -- the port alone ---------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    keys = np.sort(rng.uniform(0.0, 1000.0, 1200))
    vals = rng.uniform(0.5, 8.0, 1200)
    return keys, vals


def _ranges(rng, lo, hi, m=33):
    lq = rng.uniform(lo, hi, m)
    uq = rng.uniform(lo, hi, m)
    return np.minimum(lq, uq), np.maximum(lq, uq)


@pytest.mark.parametrize("agg", ["sum", "max"])
@pytest.mark.parametrize("backend", ["torch", "ref"])
def test_single_level_matches_flat_executor(data, agg, backend):
    """A one-level ladder computes the flat plan's floats exactly (the
    combiner is the identity for one level, in-domain queries)."""
    keys, vals = data
    rng = np.random.default_rng(1)
    eng = LsmEngine(keys, vals, agg=agg, delta=DELTA, backend=backend,
                    policy=CompactionPolicy(**POLICY), device=CPU)
    lsm, _ = eng.snapshot()
    assert len(lsm.levels) == 1
    flat = build_plan(build_index_1d(keys, vals, agg, deg=eng.deg,
                                     delta=DELTA, device=CPU))
    if agg == "sum":
        lq, uq = _ranges(rng, keys[0], keys[-1])
    else:
        i = rng.integers(0, keys.size - 1, 25)
        lq, uq = keys[i], keys[rng.integers(i, keys.size)]
    for eps in (None, 0.05):
        got = execute_lsm(lsm, None, (lq, uq), backend=backend, eps_rel=eps)
        want = execute(flat, (lq, uq), backend=backend, eps_rel=eps)
        for f in ("answer", "approx", "refined"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_deletes_never_merge(data):
    """A victim delete of the global maximum is answered exactly on the Q_abs
    path, and tombstone deletes hold the composed bound: no delete
    compacts."""
    keys, vals = data
    pol = CompactionPolicy(**POLICY)
    eng = LsmEngine(keys, vals, agg="max", delta=DELTA, policy=pol,
                    device=CPU)
    top = int(np.argmax(vals))
    eng.delete(keys[top:top + 1])
    assert eng.compaction_count == 0
    res = eng.query(np.array([keys[0]]), np.array([keys[-1]]))
    assert float(res.answer[0]) == float(np.delete(vals, top).max())
    eng = LsmEngine(keys, vals, agg="sum", delta=DELTA, policy=pol,
                    device=CPU)
    eng.delete(keys[500:560])
    assert eng.compaction_count == 0
    live = np.ones(keys.size, bool)
    live[500:560] = False
    lq, uq = _ranges(np.random.default_rng(6), keys[0], keys[-1])
    truth = np.array([vals[live & (keys > a) & (keys <= b)].sum()
                      for a, b in zip(lq, uq)])
    lsm, _ = eng.snapshot()
    err = np.abs(eng.query(lq, uq).answer.numpy() - truth)
    assert err.max() <= composed_bound("sum", lsm.deltas) + 1e-9


def test_compaction_atomic_under_concurrent_reader(data):
    """Background compactions install atomically: a reader thread only ever
    sees the counts of whole inserted batches, never decreasing."""
    keys, _ = data
    cap, nbatch = 256, 5
    eng = LsmEngine(keys, agg="count", delta=DELTA, capacity=cap,
                    background=True, policy=CompactionPolicy(**POLICY),
                    device=CPU)
    rng = np.random.default_rng(7)
    lq = np.array([keys[0]])             # (kmin, kmax]: all live but kmin
    uq = np.array([keys[-1]])
    valid = {float(keys.size - 1 + i * cap) for i in range(nbatch + 1)}
    bad, done = [], threading.Event()

    def reader():
        last = 0.0
        while not done.is_set():
            ans = float(eng.query(lq, uq, eps_rel=1e-12).answer[0])
            if ans not in valid or ans < last:
                bad.append(ans)
                return
            last = ans

    t = threading.Thread(target=reader)
    t.start()
    try:
        for _ in range(nbatch):
            eng.insert(rng.uniform(keys[0] + 1.0, keys[-1] - 1.0, cap))
    finally:
        done.set()
        t.join()
    eng.refit(wait=True)
    assert not bad, f"torn reads: {bad}"
    final = float(eng.query(lq, uq, eps_rel=1e-12).answer[0])
    assert final == keys.size - 1 + nbatch * cap
    assert eng.compaction_count >= 1


def test_session_lsm_table(data):
    """TableSpec(dynamic=True, lsm=True) builds an LsmEngine behind the
    session: its answers are the ladder's own, a flush compacts the
    buffered batch in, quantiles are refused, and the spec validates as
    the reference's does."""
    keys, vals = data
    b = tapi.ErrorBudget(abs=100.0)
    pf = tapi.PolyFit.fit(
        {"t": (keys, vals)},
        {"t": tapi.TableSpec("sum", b, dynamic=True, lsm=True,
                             capacity=256, background=False)}, device=CPU)
    assert pf.is_lsm("t") and pf.spec("t").growth == 4
    eng = pf._table("t").dyn
    assert isinstance(eng, LsmEngine)
    spec = tapi.QuerySpec.range("t", 100.0, 700.0)
    before = pf.query(spec)
    lsm, buf = pf.snapshot("t")
    direct = execute_lsm(lsm, buf, (np.array([100.0]), np.array([700.0])),
                         eps_rel=b.rel)
    assert torch.equal(before.answer, direct.answer)
    rng = np.random.default_rng(12)
    pf.insert("t", rng.uniform(keys[0], keys[-1], 64),
              rng.uniform(0.5, 8.0, 64))
    assert pf.query(spec).staleness == 64
    pf.flush("t")
    after = pf.query(spec)
    assert eng.compaction_count == 1 and after.staleness == 0
    assert float(after.answer[0]) >= float(before.answer[0])
    assert pf.size_bytes()["t"] == pf.plan("t").size_bytes() > 0
    with pytest.raises(ValueError, match="LSM-tiered"):
        pf.query(tapi.QuerySpec.quantile("t", 0.5))
    for spec_cls, budget in ((tapi.TableSpec, b), (RefTableSpec,
                                                   RefBudget(abs=100.0))):
        with pytest.raises(ValueError, match="dynamic"):
            spec_cls("sum", budget, lsm=True)
        with pytest.raises(ValueError, match="growth"):
            spec_cls("sum", budget, dynamic=True, lsm=True, growth=1)
    assert tapi.TableSpec("max2d", b, dynamic=True, lsm=True).lsm


def test_policy_from_bench(tmp_path, monkeypatch):
    """from_bench parses update records as the reference does: the same
    policy from one explicit path; the defaults read only the port's own
    BENCH_torch_updates.json (working directory first), never the
    reference's BENCH_updates.json."""
    ref_json = Path(__file__).resolve().parents[1] / "BENCH_updates.json"
    for dim in (1, 2):
        got = CompactionPolicy.from_bench(str(ref_json), dim=dim)
        want = R.CompactionPolicy.from_bench(str(ref_json), dim=dim)
        assert dataclasses_equal(got, want)
        assert got.source == str(ref_json) and got.merge_us_per_row > 0
    monkeypatch.chdir(tmp_path)
    pol = CompactionPolicy.from_bench(dim=1)
    assert pol.source != str(ref_json)
    records = [{"meta": {"dim": 1, "n": 1000, "capacity": 100},
                "results": [{"name": "u.merge.x", "us_per_query": 5000.0},
                            {"name": "u.query_full.x", "us_per_query": 30.0},
                            {"name": "u.query_postmerge.x",
                             "us_per_query": 10.0}]}]
    (tmp_path / "BENCH_torch_updates.json").write_text(json.dumps(records))
    pol = CompactionPolicy.from_bench(dim=1)
    assert pol.source == str(tmp_path / "BENCH_torch_updates.json")
    assert pol.merge_us_per_row == 5.0
    assert pol.query_overhead_us_per_row == 0.2
    assert CompactionPolicy.from_bench(dim=2).source != pol.source


def dataclasses_equal(a, b) -> bool:
    return all(getattr(a, f) == getattr(b, f) for f in (
        "watermark", "merge_us_per_row", "query_overhead_us_per_row",
        "shadow_fraction"))


def test_shadow_fraction_folds_delete_only_workload(data):
    """Twin of tests/test_lsm.py's delete-only regression: tombstones past
    the shadow fraction fold the level with no pending insert, and the
    folded ladder answers COUNT exactly where refinement lands."""
    keys, _ = data
    pol = CompactionPolicy(query_overhead_us_per_row=0.0,
                           shadow_fraction=0.25)
    assert not pol.should_fold(shadow_rows=0, live_rows=100)
    assert not pol.should_fold(shadow_rows=24, live_rows=100)
    assert pol.should_fold(shadow_rows=25, live_rows=100)
    assert pol.should_fold(shadow_rows=10, live_rows=0)
    eng = LsmEngine(keys, agg="count", delta=DELTA, capacity=256,
                    background=False, policy=pol, device=CPU)
    drop = np.random.default_rng(31).choice(len(keys), size=480,
                                            replace=False)
    for lo in range(0, len(drop), 120):
        eng.delete(keys[drop[lo:lo + 120]])
    assert eng.compaction_count >= 1
    assert not eng._shadow_slots() and eng.n_pending == 0
    live = np.delete(keys, drop)
    lq, uq = _ranges(np.random.default_rng(37), 0.0, 1000.0)
    got = eng.query(lq, uq, eps_rel=1e-9).answer.numpy()
    want = np.array([np.sum((live > a) & (live <= b))
                     for a, b in zip(lq, uq)], np.float64)
    np.testing.assert_array_equal(got, want)
