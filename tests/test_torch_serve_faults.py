"""Fault tolerance of the port's serving engine: the twin of
tests/test_serve_faults.py — admission deadlines and guarantee classes
(``TableSpec.deadline``/``priority``), supervised worker/updater restarts,
dispatch retry, crash-safe journal replay, the load-shedding ladder,
staleness surfacing, and the deferred-update error paths, on a CPU session
of the reference test's tables (whose answers other tests hold to the
reference's).

Crashes are driven through the engine's real injection sites
(``serve.worker`` / ``serve.dispatch`` / ``serve.updater``) by a
``FailureInjector``, so every recovery path exercised here is the one a
deployment takes.
"""
from __future__ import annotations

import threading
import time

import torch_threads  # noqa: F401  (one intra-op thread per test process)
import numpy as np
import pytest

from repro_torch.api import ErrorBudget, PolyFit, QuerySpec, TableSpec
from repro_torch.dist.fault_tolerance import (FailureInjector, RetryPolicy,
                                              SimulatedPodFailure)
from repro_torch.serve import (DeadlineExceeded, Overloaded, QueueFull,
                               ServingEngine)

N1 = 3000
N2 = 1500


@pytest.fixture(scope="module")
def session():
    rng = np.random.default_rng(0xFA17)
    keys = np.sort(rng.uniform(0.0, 100.0, N1))
    vals = rng.uniform(0.0, 10.0, N1)
    xs = rng.uniform(0.0, 50.0, N2)
    ys = rng.uniform(0.0, 50.0, N2)
    b = ErrorBudget(abs=50.0, rel=0.01)
    return PolyFit.fit(
        {"sum": (keys, vals), "fast": (keys, vals), "c2": (xs, ys)},
        {"sum": TableSpec("sum", b, dynamic=True, capacity=256,
                          auto_refit=False),
         "fast": TableSpec("sum", b, deadline=0.05, priority=2),
         "c2": TableSpec("count2d", b, dynamic=True, capacity=256,
                         auto_refit=False)},
        device="cpu")


SPEC = QuerySpec.range("sum", 0.0, 100.0)


def _wait(pred, timeout=10.0, what="condition"):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


# -- guarantee classes ----------------------------------------------------

def test_admission_class_from_table_spec(session):
    assert session.admission_class("fast") == (0.05, 2)
    assert session.admission_class("sum") == (None, 0)
    b = ErrorBudget(abs=1.0)
    with pytest.raises(ValueError, match="deadline"):
        TableSpec("sum", b, deadline=-1.0)
    with pytest.raises(ValueError, match="priority"):
        TableSpec("sum", b, priority=-1)


def test_deadline_expires_in_queue(session):
    eng = ServingEngine(session, start=False)
    try:
        f_tight = eng.submit(SPEC, deadline=0.02)
        f_slack = eng.submit(SPEC)
        time.sleep(0.1)
        eng.start()
        with pytest.raises(DeadlineExceeded):
            f_tight.result(timeout=30)
        assert f_slack.result(timeout=30).answer.shape == (1,)
        assert eng.stats.deadline_expired == 1
        assert eng.stats.answered == 1
    finally:
        eng.shutdown()


def test_table_default_deadline_applies(session):
    spec = QuerySpec.range("fast", 0.0, 100.0)
    eng = ServingEngine(session, start=False)
    try:
        f_default = eng.submit(spec)                 # table class: 0.05s
        f_override = eng.submit(spec, deadline=30.0)
        time.sleep(0.15)
        eng.start()
        with pytest.raises(DeadlineExceeded):
            f_default.result(timeout=30)
        assert f_override.result(timeout=30).answer.shape == (1,)
        assert eng.stats.deadline_expired == 1
    finally:
        eng.shutdown()


def test_deadline_class_splits_coalescing(session):
    """A tight-deadline request is never padded into a slack batch: the
    deadline class joins the group key, so one admission batch with mixed
    classes produces one dispatch per class."""
    eng = ServingEngine(session, start=False)
    try:
        slack = [eng.submit(SPEC) for _ in range(3)]
        tight = eng.submit(SPEC, deadline=5.0)
        eng.start()
        want = session.query(SPEC).answer[0]
        for f in slack + [tight]:
            assert float(f.result(timeout=60).answer[0]) == float(want)
        st = eng.stats
        assert st.dispatches == 2          # one per deadline class
        assert st.answered == 4
        assert st.coalesced == 3           # only the slack trio shared
    finally:
        eng.shutdown()


# -- supervised crash recovery --------------------------------------------

def test_worker_crash_fails_batch_and_supervisor_restarts(session):
    inj = FailureInjector().arm("serve.worker", nth=1, times=1)
    eng = ServingEngine(session, injector=inj)
    try:
        f = eng.submit(SPEC)
        assert isinstance(f.exception(timeout=30), SimulatedPodFailure)
        _wait(lambda: eng.health()["workers_alive"] == 1,
              what="worker restart")
        # the replacement worker serves normally
        assert eng.query(SPEC, timeout=60).answer.shape == (1,)
        st = eng.stats
        assert st.worker_crashes == 1 and st.restarts >= 1
    finally:
        eng.shutdown()


def test_transient_dispatch_failure_is_retried(session):
    inj = FailureInjector().arm("serve.dispatch", nth=1, times=1)
    pol = RetryPolicy(max_attempts=3, base=0.001, cap=0.01,
                      retry_on=(SimulatedPodFailure,))
    eng = ServingEngine(session, injector=inj, retry=pol)
    try:
        res = eng.query(SPEC, timeout=60)
        assert res.answer.shape == (1,)
        assert pol.retries == 1 and pol.giveups == 0
        assert eng.health()["retry"]["retries"] == 1
        assert eng.stats.worker_crashes == 0   # absorbed below thread level
    finally:
        eng.shutdown()


def test_updater_crash_replays_exactly_unapplied_suffix(session):
    """Kill the updater between fused applies: the restarted updater must
    replay exactly the un-applied journal suffix — applied-prefix sums are
    neither lost nor double-applied."""
    inj = FailureInjector().arm("serve.updater", nth=2, times=1)
    eng = ServingEngine(session, injector=inj)
    try:
        before = float(eng.query(SPEC, timeout=60).answer[0])
        per_item = 200 * 100.0
        for _ in range(3):
            eng.insert("sum", np.random.default_rng(1).uniform(0, 100, 200),
                       np.full(200, 100.0), wait=False)
        eng.drain_updates()                   # rides through crash + replay
        after = float(eng.query(SPEC, timeout=60).answer[0])
        # 3 items x 20000; a lost suffix (-20000) or a double-applied
        # prefix (+20000) lands far outside the certified window
        assert after - before == pytest.approx(3 * per_item, abs=5000.0)
        st = eng.stats
        assert st.updater_crashes == 1
        assert st.restarts >= 1
        assert st.journal_replayed >= 1
        assert eng.staged_depth == 0 and eng.staleness("sum") == 0
        eng.drain_updates()                   # crash deferred no errors
    finally:
        eng.shutdown()


def test_staleness_surfaced_while_updater_down(session):
    inj = FailureInjector().arm("serve.updater", nth=1, times=1000)
    eng = ServingEngine(session, injector=inj, supervise=False)
    try:
        before = float(eng.query(SPEC, timeout=60).answer[0])
        eng.insert("sum", np.linspace(1.0, 9.0, 10), np.full(10, 3.0),
                   wait=False)
        _wait(lambda: not eng.health()["updater_alive"],
              what="updater crash")
        assert eng.staged_depth == 10 and eng.staleness("sum") == 10
        # reads degrade gracefully: last snapshot, staleness on the answer
        f = eng.submit(SPEC)
        res = f.result(timeout=60)
        assert float(res.answer[0]) == pytest.approx(before)
        assert f.staleness == 10
        st = eng.stats
        assert st.stale_reads >= 1 and st.updater_crashes == 1
        assert eng.health()["restarts"] == 0     # supervision disabled
        # recovery: disarm and drain inline (updater dead, no supervisor)
        inj.disarm("serve.updater")
        eng.drain_updates()
        assert eng.staleness("sum") == 0
        f2 = eng.submit(SPEC)
        assert float(f2.result(timeout=60).answer[0]) == pytest.approx(
            before + 30.0)
        assert f2.staleness == 0
    finally:
        eng.shutdown()


# -- graceful degradation -------------------------------------------------

def test_shed_ladder_reserves_headroom_by_priority(session):
    eng = ServingEngine(session, start=False, max_queue=8,
                        shed_watermark=0.5)
    try:
        for _ in range(4):                     # class 0 may fill w = 1/2
            eng.submit(SPEC, priority=0)
        with pytest.raises(Overloaded):
            eng.submit(SPEC, priority=0)
        for _ in range(2):                     # class 1: up to 3/4
            eng.submit(SPEC, priority=1)
        with pytest.raises(Overloaded):
            eng.submit(SPEC, priority=1)
        for _ in range(2):                     # class 3: up to 15/16
            eng.submit(SPEC, priority=3)
        with pytest.raises(Overloaded):
            eng.submit(SPEC, priority=3)
        st = eng.stats
        assert st.shed == 3 and st.submitted == 8 and st.rejected == 0
    finally:
        eng.shutdown(drain=False)


# -- deferred-update error paths ------------------------------------------

def test_deferred_errors_surface_in_submission_order(session):
    """Two tables fail in one drain: ``drain_updates`` surfaces one error
    per call, oldest first, across tables."""
    eng = ServingEngine(session)
    try:
        eng.delete("sum", 2e9, wait=False)              # no such key
        eng.delete("c2", 999.0, 999.0, wait=False)      # no such point
        with pytest.raises(KeyError, match="key") as e1:
            eng.drain_updates()
        with pytest.raises(KeyError, match="point") as e2:
            eng.drain_updates()
        assert "2" in str(e1.value) and "999" in str(e2.value)
        eng.drain_updates()                             # now clean
    finally:
        eng.shutdown()


def test_drain_after_shutdown_surfaces_leftover_errors(session):
    eng = ServingEngine(session)
    eng.delete("sum", 3e9, wait=False)
    eng.shutdown()            # cleanup path: applies, never raises
    with pytest.raises(KeyError):
        eng.drain_updates()
    eng.drain_updates()       # leftovers exhausted: clean no-op


def test_queue_full_under_concurrent_reject_submitters(session):
    eng = ServingEngine(session, start=False, max_queue=4,
                        admission="reject")
    outcomes = []
    lock = threading.Lock()

    def one():
        try:
            f = eng.submit(SPEC)
            with lock:
                outcomes.append(f)
        except QueueFull as e:
            with lock:
                outcomes.append(e)

    try:
        threads = [threading.Thread(target=one) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        ok = [o for o in outcomes if not isinstance(o, Exception)]
        full = [o for o in outcomes if isinstance(o, QueueFull)]
        assert len(ok) == 4 and len(full) == 4
        st = eng.stats
        assert st.submitted == 4 and st.rejected == 4
    finally:
        eng.shutdown(drain=False)


def test_shutdown_vs_submit_race_strands_no_future(session):
    """Futures submitted concurrently with shutdown either get served or
    resolve with the shutdown error — none hangs, none is silently lost."""
    eng = ServingEngine(session, workers=2)
    futures = []
    lock = threading.Lock()
    stop = threading.Event()

    def submitter():
        while not stop.is_set():
            try:
                f = eng.submit(SPEC, timeout=1.0)
            except (RuntimeError, QueueFull):
                return                        # engine gone: acceptable
            with lock:
                futures.append(f)

    threads = [threading.Thread(target=submitter) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.2)
    eng.shutdown(drain=True)
    stop.set()
    for t in threads:
        t.join(60)
    assert futures
    served = errored = 0
    for f in futures:
        exc = f.exception(timeout=30)         # TimeoutError => stranded
        if exc is None:
            served += 1
        else:
            assert isinstance(exc, RuntimeError)
            errored += 1
    assert served >= 1
    assert served + errored == len(futures)
