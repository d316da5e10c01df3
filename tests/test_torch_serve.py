"""The port's serving engine (``repro_torch.serve.ServingEngine``) against
its own session and the reference's: the twin of tests/test_serve.py.

Served answers (static and dynamic 1-D SUM and MIN, 2-D COUNT rectangles
and MIN2D corners, quantiles, buffered and merged states) equal the
reference's ``session.query`` on the same tables at rtol = atol = 1e-9 with
equal refined flags; the reference's answers come from one concatenated
batch per table through its session (its own ``ServingEngine`` would
compile an AOT ladder).  Coalesced answers equal the port's serial
``session.query`` bit for bit; the cache's counters (captures on the card,
the plain callables here), plan-swap staging with zero new entries after a
swap, concurrent readers, linearizable readers and writers, back-pressure,
shutdown and the update error paths behave as the reference's do.  The
reference session's static plans, carried across with
``plan_from_numpy``/``plan2d_from_numpy``, serve the reference's answers
too.
"""
from __future__ import annotations

import copy
import threading
import time

import torch_threads  # noqa: F401  (one intra-op thread per test process)
import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

import repro.api as rapi  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro_torch.api import PolyFit, QuerySpec  # noqa: E402
from repro_torch.engine import plan2d_from_numpy, plan_from_numpy  # noqa: E402
from repro_torch.engine.plan import (ARRAY_FIELDS, ARRAY_FIELDS_2D,  # noqa: E402
                                     META_FIELDS, META_FIELDS_2D)
from repro_torch.serve import QueueFull, ServingEngine  # noqa: E402

N1 = 4000
N2 = 2000
TOL = dict(rtol=1e-9, atol=1e-9)


def _data():
    rng = np.random.default_rng(0xE17)
    keys = np.sort(rng.uniform(0.0, 100.0, N1))
    vals = rng.uniform(0.0, 10.0, N1)
    xs = rng.uniform(0.0, 50.0, N2)
    ys = rng.uniform(0.0, 50.0, N2)
    ws = rng.uniform(1.0, 5.0, N2)
    return ({"sum": (keys, vals), "min": (keys, vals), "c2": (xs, ys),
             "mn2": (xs, ys, ws)})


def _specs(api):
    b = api.ErrorBudget(abs=50.0, rel=0.01)
    m = api.ErrorBudget(abs=0.5, rel=0.01)
    return {"sum": api.TableSpec("sum", b, dynamic=True, capacity=256,
                                 auto_refit=False),
            "min": api.TableSpec("min", m),
            "c2": api.TableSpec("count2d", b, dynamic=True, capacity=256,
                                auto_refit=False),
            "mn2": api.TableSpec("min2d", m)}


@pytest.fixture(scope="module")
def sessions():
    """(port session, reference session) over the same tables: the
    reference's serving test tables, fitted once for the module."""
    data = _data()
    port = PolyFit.fit(data, _specs(tapi), device="cpu")
    ref = rapi.PolyFit.fit(data, _specs(rapi), backend="ref")
    return port, ref


@pytest.fixture(scope="module")
def session(sessions):
    return sessions[0]


def _mixed_specs(rng, n, api=tapi):
    specs = []
    for _ in range(n):
        m = int(rng.integers(1, 5))
        kind = int(rng.integers(4))
        if kind == 0:
            lq = rng.uniform(0, 80, m)
            specs.append(api.QuerySpec.range("sum", lq, lq + 10.0))
        elif kind == 1:
            lq = rng.uniform(0, 80, m)
            specs.append(api.QuerySpec.range("min", lq, lq + 15.0))
        elif kind == 2:
            lx, ly = rng.uniform(0, 40, m), rng.uniform(0, 40, m)
            specs.append(api.QuerySpec.rect("c2", lx, lx + 8, ly, ly + 8))
        else:
            specs.append(api.QuerySpec.corner("mn2", rng.uniform(10, 50, m),
                                              rng.uniform(10, 50, m)))
    return specs


def _assert_identical(got, want):
    assert torch.equal(got.answer, want.answer)
    assert torch.equal(got.approx, want.approx)
    assert torch.equal(got.refined, want.refined)


def _reference_answers(ref, specs):
    """The reference session's answers to ``specs``: one concatenated
    batch per (table, kind, guarantee), scattered back in spec order."""
    groups = {}
    for i, s in enumerate(specs):
        groups.setdefault((s.table, s.kind, s.rel), []).append(i)
    out = [None] * len(specs)
    for (table, kind, rel), idxs in groups.items():
        cols = tuple(np.concatenate([np.asarray(specs[i].ranges[j])
                                     for i in idxs])
                     for j in range(len(specs[idxs[0]].ranges)))
        r = ref.query(rapi.QuerySpec(table, cols, rapi.DEFAULT_REL
                                     if rel is tapi.DEFAULT_REL else rel,
                                     kind=kind))
        off = 0
        for i in idxs:
            m = len(specs[i])
            out[i] = tuple(np.asarray(f)[off:off + m] for f in
                           (r.answer, r.approx, r.refined))
            off += m
    return out


def _assert_matches_reference(got, want):
    np.testing.assert_allclose(got.answer.numpy(), want[0], **TOL)
    np.testing.assert_allclose(got.approx.numpy(), want[1], **TOL)
    np.testing.assert_array_equal(got.refined.numpy(), want[2])


def _quantile_specs(rng, n):
    return [tapi.QuerySpec.quantile("sum", rng.uniform(0, 1, 3))
            for _ in range(n)]


def test_served_answers_match_reference(sessions):
    """Every table kind, served through the engine (coalesced, padded to
    buckets), equals the reference session at 1e-9 with equal refined
    flags: static MIN and MIN2D, dynamic SUM and COUNT2D with empty, then
    buffered, then merged state, and certified quantiles on the SUM
    table."""
    port, ref = sessions
    rng = np.random.default_rng(11)
    specs = _mixed_specs(rng, 40)
    qspecs = _quantile_specs(rng, 4)
    eng = ServingEngine(port, start=False)
    try:
        futures = [eng.submit(s) for s in specs + qspecs]
        eng.start()
        got = [f.result(timeout=120) for f in futures]
        want = _reference_answers(ref, specs)
        for g, w in zip(got[:len(specs)], want):
            _assert_matches_reference(g, w)
        for g, s in zip(got[len(specs):], qspecs):
            r = ref.query(rapi.QuerySpec.quantile("sum", s.ranges[0]))
            np.testing.assert_allclose(g.answer.numpy(),
                                       np.asarray(r.answer), **TOL)
            for b, rb in zip(g.bound, r.bound):
                np.testing.assert_allclose(b.numpy(), np.asarray(rb), **TOL)
        # buffered: the same inserts through the engine and the reference
        ins = np.random.default_rng(12)
        k, v = ins.uniform(0, 100, 40), ins.uniform(0, 10, 40)
        px, py = ins.uniform(0, 50, 30), ins.uniform(0, 50, 30)
        eng.insert("sum", k, v, wait=True)
        eng.insert("c2", px, py, wait=True)
        ref.insert("sum", k, v)
        ref.insert("c2", px, py)
        dyn = [s for s in specs if s.table in ("sum", "c2")]
        got = eng.query(dyn, timeout=120)
        for g, w in zip(got, _reference_answers(ref, dyn)):
            _assert_matches_reference(g, w)
        # merged: both sessions refit the SUM table's dirty segments
        eng.flush("sum")
        ref.flush("sum")
        sums = [s for s in specs if s.table == "sum"]
        got = eng.query(sums, timeout=120)
        for g, w in zip(got, _reference_answers(ref, sums)):
            _assert_matches_reference(g, w)
    finally:
        eng.shutdown()


def test_carried_reference_plans_serve_the_same(sessions):
    """The reference session's static plans, carried into the port's plan
    types field for field, serve the reference's answers through a port
    ``ServingEngine`` over a session that holds them."""
    port, ref = sessions
    carried = copy.copy(port)
    carried._tables = dict(port._tables)
    for name, fields, meta, carry in (
            ("min", ARRAY_FIELDS, META_FIELDS, plan_from_numpy),
            ("mn2", ARRAY_FIELDS_2D, META_FIELDS_2D, plan2d_from_numpy)):
        rplan = ref.plan(name)
        f = {a: (None if getattr(rplan, a) is None
                 else np.asarray(getattr(rplan, a))) for a in fields}
        f.update({a: getattr(rplan, a) for a in meta})
        t = copy.copy(port._tables[name])
        t._static_plan = carry(f, "cpu")
        carried._tables[name] = t
    rng = np.random.default_rng(13)
    specs = [s for s in _mixed_specs(rng, 30)
             if s.table in ("min", "mn2")]
    specs += [QuerySpec.range("min", s.ranges[0], s.ranges[1], rel=None)
              for s in specs if s.table == "min"]
    eng = ServingEngine(carried)
    try:
        got = eng.query(specs, timeout=120)
        for g, w in zip(got, _reference_answers(ref, specs)):
            _assert_matches_reference(g, w)
        for name in ("min", "mn2"):
            assert eng._cache[next(k for k in eng.cache_keys()
                                   if k[0] == name)].cur.plan_ref \
                is carried.plan(name)
    finally:
        eng.shutdown()


def test_coalesced_bit_identical_to_serial(session):
    """A stream submitted through the queue (admission batching on) gives
    exactly the serial per-spec answers, across all four kinds."""
    rng = np.random.default_rng(1)
    specs = _mixed_specs(rng, 40) + _quantile_specs(rng, 3)
    serial = [session.query(s) for s in specs]
    eng = ServingEngine(session, start=False)
    futures = [eng.submit(s) for s in specs]   # all queued before serving
    eng.start()
    try:
        for fut, want in zip(futures, serial):
            _assert_identical(fut.result(timeout=120), want)
        st = eng.stats
        assert st.answered == len(specs)
        assert st.coalesced > 0          # batching actually kicked in
        assert st.dispatches < len(specs)
    finally:
        eng.shutdown()


def test_aot_cache_reuse_and_warmup(session):
    eng = ServingEngine(session)
    try:
        n = eng.warmup(max_bucket=128)
        assert n == 8                    # 4 tables x ladder {64, 128}
        assert eng.warmup(max_bucket=128) == 0   # idempotent
        c0 = eng.stats.aot_compiles
        rng = np.random.default_rng(2)
        for s in _mixed_specs(rng, 12):
            eng.query(s, timeout=120)
        st = eng.stats
        assert st.aot_compiles == c0     # warm ladder: zero new entries
        assert st.aot_hits >= 12 or st.dispatches < 12
        assert len(eng.cache_keys()) == 8
    finally:
        eng.shutdown()


def test_plan_swap_precompiles_executables(session):
    """A merge stages the incoming plan's executables on the merge thread
    (``on_plan_swap`` listener), so the post-swap dispatch promotes instead
    of creating an entry: zero new entries after a swap."""
    eng = ServingEngine(session)
    spec = QuerySpec.range("sum", 5.0, 60.0)
    try:
        before = eng.query(spec, timeout=120)
        eng.insert("sum", np.array([10.0, 20.0]),
                   np.array([7.0, 3.0]), wait=True)
        buffered = eng.query(spec, timeout=120)
        assert float(buffered.answer[0]) == pytest.approx(
            float(before.answer[0]) + 10.0)
        c0 = eng.stats.aot_compiles
        promo0 = eng.stats.aot_promotions
        eng.flush("sum")                 # merge -> plan swap
        assert eng.stats.aot_precompiles > 0   # staged pre-install
        assert not eng.stage_errors
        merged = eng.query(spec, timeout=120)
        # the refit plan approximates anew: answers agree within the two
        # certified Q_abs bounds, not bitwise
        assert abs(float(merged.answer[0])
                   - float(buffered.answer[0])) <= 100.0
        st = eng.stats
        assert st.aot_compiles == c0           # zero new entries post-swap
        assert st.aot_promotions > promo0      # served the staged entry
        # engine answers == session answers on the swapped plan too
        _assert_identical(merged, session.query(spec))
    finally:
        eng.shutdown()
        # leave the module-scoped session clean for the other tests
        session.flush("sum")


def test_concurrent_reader_pool_bit_identical(session):
    """Many reader threads hammering the queue still each get exactly
    their own serial answer (futures scatter per request)."""
    rng = np.random.default_rng(3)
    specs = _mixed_specs(rng, 60)
    serial = [session.query(s) for s in specs]
    eng = ServingEngine(session, workers=2)
    errors = []

    def reader(lo, hi):
        try:
            for i in range(lo, hi):
                got = eng.query(specs[i], timeout=120)
                _assert_identical(got, serial[i])
        except BaseException as e:       # pragma: no cover - surfaced below
            errors.append(e)

    try:
        threads = [threading.Thread(target=reader, args=(i, i + 15))
                   for i in range(0, 60, 15)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
    finally:
        eng.shutdown()


def test_mixed_readers_writers_linearizable(session):
    """Concurrent readers + async writers: with writes staged through the
    engine, every read matches a serial replay of the write log at *some*
    prefix (monotone in time), and after a full drain the engine answer
    equals the serial answer of the complete log."""
    eng = ServingEngine(session)
    spec = QuerySpec.range("sum", 0.0, 100.0)
    base = float(session.query(spec).answer[0])
    chunks = 6
    chunk = 16
    per_chunk = 2.0 * chunk              # each record adds measure 2.0
    errors = []
    seen = []

    def writer():
        try:
            rng = np.random.default_rng(4)
            for _ in range(chunks):
                eng.insert("sum", rng.uniform(0, 100, chunk),
                           np.full(chunk, 2.0), wait=False)
                time.sleep(0.01)
        except BaseException as e:
            errors.append(e)

    def reader():
        try:
            for _ in range(12):
                seen.append(float(eng.query(spec, timeout=120).answer[0]))
        except BaseException as e:
            errors.append(e)

    try:
        threads = [threading.Thread(target=writer),
                   threading.Thread(target=reader)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        eng.drain_updates()
        final = float(eng.query(spec, timeout=120).answer[0])
        assert final == pytest.approx(base + chunks * per_chunk)
        # reads only ever see whole staged-chunk prefixes, in order
        tol = 1e-6 * max(1.0, abs(base))
        valid = [base + k * per_chunk for k in range(chunks + 1)]
        for v in seen:
            assert min(abs(v - x) for x in valid) < tol, (v, valid)
        assert seen == sorted(seen)      # write visibility is monotone
    finally:
        eng.shutdown()
        session.flush("sum")


def test_backpressure_reject_and_block(session):
    spec = QuerySpec.range("min", 0.0, 1.0)
    eng = ServingEngine(session, max_queue=4, admission="reject",
                        start=False)   # nothing drains: deterministic
    for _ in range(4):
        eng.submit(spec)
    with pytest.raises(QueueFull):
        eng.submit(spec)
    assert eng.stats.rejected == 1
    assert eng.queue_depth == 4
    eng.start()                          # drain the queued four
    eng.shutdown(drain=True)
    assert eng.stats.answered == 4

    blocking = ServingEngine(session, max_queue=2, admission="block",
                             start=False)
    blocking.submit(spec)
    blocking.submit(spec)
    with pytest.raises(QueueFull):       # block admission honors timeout
        blocking.submit(spec, timeout=0.05)
    blocking.start()
    blocking.shutdown(drain=True)


def test_shutdown_drain_answers_everything(session):
    rng = np.random.default_rng(5)
    specs = _mixed_specs(rng, 10)
    eng = ServingEngine(session, start=False)
    futures = [eng.submit(s) for s in specs]
    eng.insert("sum", np.array([1.0]), np.array([1.0]), wait=False)
    eng.start()
    eng.shutdown(drain=True)             # must answer + apply everything
    assert all(f.done() and f.exception() is None for f in futures)
    assert eng.staged_depth == 0
    with pytest.raises(RuntimeError):
        eng.submit(specs[0])
    eng.shutdown()                       # idempotent
    session.flush("sum")


def test_shutdown_no_drain_cancels_queued(session):
    spec = QuerySpec.range("sum", 0.0, 1.0)
    eng = ServingEngine(session, start=False)
    futures = [eng.submit(spec) for _ in range(5)]
    eng.shutdown(drain=False)
    for f in futures:
        assert isinstance(f.exception(timeout=5), RuntimeError)


def test_delete_error_surfaces(session):
    eng = ServingEngine(session)
    try:
        with pytest.raises(KeyError):    # no live occurrence of key 1e9
            eng.delete("sum", np.array([1e9]), wait=True)
        eng.delete("sum", np.array([2e9]), wait=False)
        with pytest.raises(KeyError):    # deferred error lands on drain
            eng.drain_updates()
    finally:
        eng.shutdown()


def test_update_normalization_errors(session):
    eng = ServingEngine(session, start=False)
    with pytest.raises(ValueError):
        eng.insert("sum", np.array([1.0]), wait=False)   # measures missing
    with pytest.raises(ValueError):
        eng.delete("c2", np.array([1.0]), wait=False)    # ys missing
    with pytest.raises(RuntimeError):                    # static table
        eng.insert("min", np.array([1.0]), np.array([1.0]), wait=False)


def test_many_workers_under_fast_switching_lose_nothing(session):
    """Sixteen workers (more than the cores) and eight clients with the
    interpreter switching threads every 10 us: every future resolves to
    its serial answer, the counters add up, and every staged insert lands
    exactly once."""
    import sys
    rng = np.random.default_rng(8)
    # reads of the other tables; the writes go to c2
    specs = [s for s in _mixed_specs(rng, 100) if s.table != "c2"]
    serial = [session.query(s) for s in specs]
    dyn = session._dyn("c2")
    pending0 = dyn.n_pending
    eng = ServingEngine(session, workers=16)
    got, errors = [None] * len(specs), []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def client(c):
            try:
                for i in range(c, len(specs), 8):
                    got[i] = eng.submit(specs[i])
                    if i % 20 == 0:
                        eng.insert("c2", np.array([25.0 + c]),
                                   np.array([25.0 - c]), wait=False)
            except BaseException as e:       # pragma: no cover
                errors.append(e)
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        for f, want in zip(got, serial):
            _assert_identical(f.result(timeout=120), want)
        eng.drain_updates()
        st = eng.stats
        assert st.submitted == st.answered == len(specs)
        n_ins = sum(1 for c in range(8)
                    for i in range(c, len(specs), 8) if i % 20 == 0)
        assert dyn.n_pending == pending0 + n_ins
        assert eng.staged_depth == 0
    finally:
        sys.setswitchinterval(old)
        eng.shutdown()
