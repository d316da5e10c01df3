"""Fault-tolerance primitives of the serving engine: the twin of
``repro.dist.fault_tolerance`` (plain Python and numpy), without its
``elastic_remesh``, which moves model state onto a JAX mesh and waits for
the port's distributed substrate.

Three small, composable pieces:

* ``FailureInjector`` — deterministic failure injection.  Step-triggered
  (``check(step)`` raises at the configured steps — a simulated pod loss)
  and site-triggered (``arm(site, nth=..., p=...)`` + ``maybe_fail(site)``
  at well-defined points inside the serving engine's worker/updater
  loops — the chaos harness's crash storms).  All triggers are seeded, so
  a chaos run replays bit-identically.

* ``HeartbeatMonitor`` — a per-participant beat ledger.  Workers call
  ``beat(name)`` once per loop iteration; ``beat`` returns a straggler
  warning when the participant's own inter-beat gap exceeded ``deadline``,
  and ``stalled()`` lists participants whose *latest* beat is older than
  the deadline (the supervisor's stall detector).

* ``RetryPolicy`` — bounded retry with exponential backoff and
  decorrelated jitter, filtered by exception class, capped by both an
  attempt count and a total-sleep budget.  The serving engine wraps
  transient dispatch failures in one; the policy is seeded so tests are
  deterministic.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["SimulatedPodFailure", "FailureInjector", "HeartbeatMonitor",
           "RetryPolicy"]


class SimulatedPodFailure(RuntimeError):
    """Raised by ``FailureInjector`` at a configured trigger point."""


class FailureInjector:
    """Deterministic step- and site-triggered failure injection.

    ``steps`` is the step-triggered contract: ``check(step)`` raises
    ``SimulatedPodFailure`` when ``step`` is in the set.  ``p`` adds a
    seeded per-``check`` failure probability on top.

    Sites are the serving-engine contract: ``arm(name, nth=50)`` fires on
    every 50th ``maybe_fail(name)`` call, ``arm(name, p=0.01)`` fires each
    call with probability 0.01 (seeded), ``times`` caps the total fires
    per site (``times=1`` is a one-shot crash).  Un-armed sites are
    no-ops, so production code can keep its injection points unconditionally.
    """

    def __init__(self, steps: Tuple[int, ...] = (), p: float = 0.0,
                 seed: int = 0, exc=SimulatedPodFailure):
        self.steps = frozenset(int(s) for s in steps)
        self.p = float(p)
        self.exc = exc
        self._rng = np.random.default_rng(seed)
        self._sites: Dict[str, dict] = {}
        self._lock = threading.Lock()

    # -- step-triggered ---------------------------------------------------

    def check(self, step: int) -> None:
        """Raise at the configured steps (or with probability ``p``)."""
        if int(step) in self.steps:
            raise self.exc(f"injected pod failure at step {step}")
        if self.p > 0.0:
            with self._lock:
                hit = self._rng.random() < self.p
            if hit:
                raise self.exc(f"injected random pod failure at step {step}")

    # -- site-triggered (serve/engine.py thread loops) --------------------

    def arm(self, site: str, *, nth: Optional[int] = None, p: float = 0.0,
            times: Optional[int] = None) -> "FailureInjector":
        """Arm a named injection site; returns self for chaining."""
        if nth is None and p <= 0.0:
            raise ValueError("arm() needs nth=N and/or p>0")
        with self._lock:
            self._sites[site] = {"nth": nth, "p": float(p), "times": times,
                                 "calls": 0, "fires": 0}
        return self

    def disarm(self, site: str) -> None:
        with self._lock:
            self._sites.pop(site, None)

    def maybe_fail(self, site: str) -> None:
        """Raise ``exc`` when the armed trigger for ``site`` fires.

        No-op for un-armed sites.  Thread-safe; the call/fire counters are
        shared across threads so ``nth`` means "every nth call engine-wide".
        """
        with self._lock:
            cfg = self._sites.get(site)
            if cfg is None:
                return
            cfg["calls"] += 1
            if cfg["times"] is not None and cfg["fires"] >= cfg["times"]:
                return
            fire = ((cfg["nth"] is not None and cfg["calls"] % cfg["nth"] == 0)
                    or (cfg["p"] > 0.0 and self._rng.random() < cfg["p"]))
            if fire:
                cfg["fires"] += 1
                calls = cfg["calls"]
            else:
                return
        raise self.exc(f"injected failure at site {site!r} (call {calls})")

    def fires(self, site: str) -> int:
        with self._lock:
            cfg = self._sites.get(site)
            return cfg["fires"] if cfg else 0

    def calls(self, site: str) -> int:
        with self._lock:
            cfg = self._sites.get(site)
            return cfg["calls"] if cfg else 0


class HeartbeatMonitor:
    """Per-participant beat ledger with straggler/stall detection.

    ``beat(name)`` records a beat and returns a warning string when the
    participant's own gap since its previous beat exceeded ``deadline``
    (a straggler that *did* come back); ``stalled()`` lists participants
    whose latest beat is older than the deadline right now (threads that
    have not come back — the supervisor's crash/stall signal).
    """

    def __init__(self, deadline: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.deadline = float(deadline)
        self._clock = clock
        self._last: Dict[str, float] = {}
        self._beats: Dict[str, int] = {}
        self._lock = threading.Lock()

    def beat(self, name: str = "main") -> Optional[str]:
        now = self._clock()
        with self._lock:
            prev = self._last.get(name)
            self._last[name] = now
            self._beats[name] = self._beats.get(name, 0) + 1
        if prev is not None and now - prev > self.deadline:
            return (f"straggler: {name!r} beat after {now - prev:.1f}s "
                    f"(deadline {self.deadline:.1f}s)")
        return None

    def forget(self, name: str) -> None:
        with self._lock:
            self._last.pop(name, None)

    def stalled(self, now: Optional[float] = None) -> List[Tuple[str, float]]:
        """Participants whose latest beat is older than the deadline:
        ``[(name, seconds_since_last_beat), ...]``."""
        now = self._clock() if now is None else now
        with self._lock:
            return [(n, now - t) for n, t in self._last.items()
                    if now - t > self.deadline]

    def beats(self, name: str) -> int:
        with self._lock:
            return self._beats.get(name, 0)

    @property
    def participants(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._last))


class RetryPolicy:
    """Exponential backoff with decorrelated jitter, class-filtered,
    attempt- and sleep-budget-capped.

    ``call(fn, *args, **kwargs)`` runs ``fn`` up to ``max_attempts`` times.
    Only exceptions matching ``retry_on`` are retried; anything else (and
    the final failure) propagates.  Sleeps follow AWS-style decorrelated
    jitter — ``sleep = min(cap, uniform(base, 3 * prev))`` — summed across
    the policy's lifetime and capped by ``budget`` seconds, after which
    retries stop engine-wide (a crash storm must not amplify itself into
    a sleep storm).
    """

    def __init__(self, max_attempts: int = 3, base: float = 0.01,
                 cap: float = 0.25, retry_on: Tuple[type, ...] = (Exception,),
                 budget: Optional[float] = None, seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.base = float(base)
        self.cap = float(cap)
        self.retry_on = tuple(retry_on)
        self.budget = None if budget is None else float(budget)
        self._sleep = sleep
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self.retries = 0          # sleeps taken (monotonic, engine-wide)
        self.giveups = 0          # calls that exhausted attempts/budget
        self.slept = 0.0          # total backoff seconds consumed

    def _next_delay(self, prev: float) -> Optional[float]:
        """The next backoff, or None when the budget is exhausted."""
        with self._lock:
            if self.budget is not None and self.slept >= self.budget:
                return None
            d = float(min(self.cap,
                          self._rng.uniform(self.base, max(3 * prev,
                                                           self.base))))
            if self.budget is not None:
                d = min(d, self.budget - self.slept)
            self.slept += d
            self.retries += 1
            return d

    def call(self, fn: Callable, *args, **kwargs):
        prev = self.base
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn(*args, **kwargs)
            except self.retry_on:
                if attempt == self.max_attempts:
                    with self._lock:
                        self.giveups += 1
                    raise
                delay = self._next_delay(prev)
                if delay is None:          # budget exhausted: stop retrying
                    with self._lock:
                        self.giveups += 1
                    raise
                prev = delay
                self._sleep(delay)
        raise AssertionError("unreachable")  # pragma: no cover

    def __call__(self, fn: Callable) -> Callable:
        """Decorator form: ``@policy`` wraps ``fn`` in ``call``."""
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, **kwargs)
        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        return wrapped

