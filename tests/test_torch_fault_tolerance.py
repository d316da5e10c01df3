"""The port's fault-tolerance primitives (repro_torch.dist.fault_tolerance):
the twin of tests/test_fault_tolerance.py for the injector triggers, the
heartbeat ledger and the retry policy (``elastic_remesh`` moves state onto
a JAX mesh and has no twin yet), plus the reference held to the port: the
same seeded fire sequences, the same backoff delays."""
import torch_threads  # noqa: F401  (one intra-op thread per test process)
import pytest

from repro.dist import fault_tolerance as rft
from repro_torch.dist import fault_tolerance as tft
from repro_torch.dist.fault_tolerance import (FailureInjector,
                                              HeartbeatMonitor, RetryPolicy,
                                              SimulatedPodFailure)


# -- FailureInjector ------------------------------------------------------

def test_step_trigger_fires_at_configured_steps():
    inj = FailureInjector((3, 7))
    for step in range(10):
        if step in (3, 7):
            with pytest.raises(SimulatedPodFailure, match=f"step {step}"):
                inj.check(step)
        else:
            inj.check(step)


def test_probability_trigger_is_seeded():
    def run(seed):
        inj = FailureInjector(p=0.3, seed=seed)
        hits = []
        for step in range(200):
            try:
                inj.check(step)
            except SimulatedPodFailure:
                hits.append(step)
        return hits
    a, b = run(7), run(7)
    assert a == b and 20 < len(a) < 120          # deterministic, ~30%
    assert run(8) != a                            # seed matters


def test_site_nth_trigger_and_times_cap():
    inj = FailureInjector().arm("w", nth=3, times=2)
    fired = []
    for i in range(12):
        try:
            inj.maybe_fail("w")
        except SimulatedPodFailure:
            fired.append(i)
    assert fired == [2, 5]                        # every 3rd, capped at 2
    assert inj.fires("w") == 2 and inj.calls("w") == 12
    inj.maybe_fail("unarmed-site")                # no-op
    inj.disarm("w")
    inj.maybe_fail("w")                           # disarmed: no-op


def test_site_probability_trigger_replays():
    def run():
        inj = FailureInjector(seed=42).arm("d", p=0.1)
        out = []
        for i in range(300):
            try:
                inj.maybe_fail("d")
            except SimulatedPodFailure:
                out.append(i)
        return out
    a, b = run(), run()
    assert a == b and 10 < len(a) < 70


def test_arm_requires_a_trigger():
    with pytest.raises(ValueError):
        FailureInjector().arm("w")


def test_custom_exception_class():
    class Boom(ConnectionError):
        pass
    inj = FailureInjector(exc=Boom).arm("s", nth=1)
    with pytest.raises(Boom):
        inj.maybe_fail("s")


# -- HeartbeatMonitor -----------------------------------------------------

def test_straggler_warning_on_own_gap():
    t = [0.0]
    mon = HeartbeatMonitor(deadline=1.0, clock=lambda: t[0])
    assert mon.beat("w") is None                  # first beat: no gap yet
    t[0] = 0.5
    assert mon.beat("w") is None
    t[0] = 2.0
    msg = mon.beat("w")
    assert msg is not None and "straggler" in msg and "w" in msg
    assert mon.beats("w") == 3


def test_stalled_lists_participants_past_deadline():
    t = [0.0]
    mon = HeartbeatMonitor(deadline=1.0, clock=lambda: t[0])
    mon.beat("a")
    mon.beat("b")
    t[0] = 0.9
    assert mon.stalled() == []
    mon.beat("b")
    t[0] = 1.5
    stalls = mon.stalled()
    assert [n for n, _ in stalls] == ["a"]
    assert stalls[0][1] == pytest.approx(1.5)
    mon.forget("a")
    assert mon.stalled() == [] and mon.participants == ("b",)


# -- RetryPolicy ----------------------------------------------------------

def test_retry_succeeds_after_transient_failures():
    sleeps = []
    pol = RetryPolicy(max_attempts=4, base=0.01, cap=0.05,
                      retry_on=(ConnectionError,), sleep=sleeps.append)
    calls = [0]

    def flaky():
        calls[0] += 1
        if calls[0] < 3:
            raise ConnectionError("transient")
        return "ok"

    assert pol.call(flaky) == "ok"
    assert calls[0] == 3 and pol.retries == 2 and pol.giveups == 0
    assert len(sleeps) == 2
    assert all(0.0 < s <= 0.05 for s in sleeps)
    assert pol.slept == pytest.approx(sum(sleeps))


def test_retry_filters_exception_classes():
    pol = RetryPolicy(max_attempts=5, retry_on=(ConnectionError,),
                      sleep=lambda _: None)
    calls = [0]

    def bug():
        calls[0] += 1
        raise KeyError("not transient")

    with pytest.raises(KeyError):
        pol.call(bug)
    assert calls[0] == 1 and pol.retries == 0     # no retry on a real bug


def test_retry_exhausts_attempts_then_raises():
    pol = RetryPolicy(max_attempts=3, retry_on=(ConnectionError,),
                      sleep=lambda _: None)
    calls = [0]

    def always():
        calls[0] += 1
        raise ConnectionError("down")

    with pytest.raises(ConnectionError):
        pol.call(always)
    assert calls[0] == 3 and pol.giveups == 1


def test_retry_budget_caps_total_sleep():
    pol = RetryPolicy(max_attempts=100, base=0.05, cap=10.0, budget=0.2,
                      retry_on=(ConnectionError,), sleep=lambda _: None)

    def always():
        raise ConnectionError("down")

    with pytest.raises(ConnectionError):
        pol.call(always)
    assert pol.slept <= 0.2 + 1e-9 and pol.giveups == 1


def test_retry_decorator_form():
    pol = RetryPolicy(max_attempts=2, retry_on=(ConnectionError,),
                      sleep=lambda _: None)
    state = [0]

    @pol
    def once():
        state[0] += 1
        if state[0] == 1:
            raise ConnectionError
        return state[0]

    assert once() == 2


# -- the reference's sequences ---------------------------------------------

def _fires(mod, seed):
    inj = mod.FailureInjector(p=0.2, seed=seed).arm("d", p=0.05)
    out = []
    for i in range(400):
        for call in (lambda: inj.check(i), lambda: inj.maybe_fail("d")):
            try:
                call()
            except mod.SimulatedPodFailure:
                out.append(i)
    return out, inj.fires("d"), inj.calls("d")


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_injector_fires_as_the_reference(seed):
    """Step and site triggers drawn from one seeded stream fire at the
    reference's calls exactly."""
    assert _fires(tft, seed) == _fires(rft, seed)


@pytest.mark.parametrize("budget", [None, 0.3])
def test_retry_delays_match_the_reference(budget):
    """The decorrelated-jitter delays, the sleep total and the give-ups of
    the same seeded policy equal the reference's."""
    def run(cls):
        sleeps = []
        pol = cls(max_attempts=6, base=0.01, cap=0.2, seed=3, budget=budget,
                  retry_on=(ConnectionError,), sleep=sleeps.append)

        def always():
            raise ConnectionError("down")
        for _ in range(3):
            with pytest.raises(ConnectionError):
                pol.call(always)
        return sleeps, pol.retries, pol.giveups, pol.slept
    assert run(RetryPolicy) == run(rft.RetryPolicy)
