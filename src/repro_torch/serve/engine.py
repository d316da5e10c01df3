"""Continuous-batching serving engine over a ``PolyFit`` session: the twin
of ``repro.serve.engine``.

``ServingEngine`` turns the synchronous session facade into a traffic
engine with three moving parts:

* **Bounded request queue + admission batching.**  ``submit`` enqueues a
  read and returns a future; background worker threads drain the queue,
  coalesce whatever is waiting (up to ``max_batch`` queries) into groups
  keyed on (table, kind, guarantee, deadline class, params), pad each group
  to its power-of-two bucket, and answer every caller's future from one
  device dispatch.  The executors are elementwise per query, so coalesced
  answers are bit-identical to serial execution of the same requests.
  Admission is ``'block'`` (default: ``submit`` waits for room) or
  ``'reject'`` (``QueueFull`` when the queue is at capacity).

* **Executable cache: one CUDA graph per bucket.**  Each (table,
  guarantee, bucket) is served by the session's ``serving_executor``
  captured once as a ``torch.cuda.CUDAGraph`` (the reference's AOT
  executable): the entry owns static slots for the padded query columns
  and for the delta buffer's tensors, and a dispatch copies the requests
  (and, when the table's buffer object changed, the buffer) into the
  slots, replays, and clones the outputs.  The plan's tensors are read in
  place, so entries are keyed by plan identity; a plan swap, or a buffer
  whose signature (shapes, which optional fields are ``None``) changed,
  re-captures.  Every graph of an engine shares one memory pool, captures
  run on the engine's own stream (``capture_error_mode="thread_local"``)
  after one eager run of the callable there, replays run on the
  dispatching thread's current stream, and both are serialized across
  the process (a replay with its copies and the clone of its outputs is
  one step).  On a CPU session the
  entry holds the plain callable, with the same keys and counters.
  ``warmup`` captures the full bucket ladder per table.  LSM ladders and
  window tables are served through ``execute_lsm`` with one graph *per
  level*, keyed (table, guarantee, bucket, slot); a compaction invalidates
  only the rebuilt slots.  The engine registers a ``session.on_plan_swap``
  listener per dynamic table, so the merge/compaction thread captures the
  incoming plan (or ladder) for every warmed bucket *before* the atomic
  install: post-swap dispatches promote the staged graph
  (``aot_promotions``) instead of capturing.

* **Async insert pipeline with a write-ahead journal.**  ``insert``/
  ``delete`` append to a host-side journal and return immediately
  (``wait=False``); a background updater thread drains the *un-applied
  suffix*, coalescing consecutive same-(table, op) runs into few engine
  calls — one append per capacity-sized, item-aligned chunk — and marks
  each item applied only after its chunk lands.  A crashed updater
  therefore replays exactly the un-applied suffix on restart, preserving
  the whole-chunk-prefix visibility order readers rely on.  Per-table
  submission order is preserved; ``wait=True`` blocks until the caller's
  records are query-visible.

Fault tolerance (``repro_torch.dist.fault_tolerance``): admission
deadlines (``submit(spec, deadline=...)`` or ``TableSpec.deadline``; the
deadline class joins the coalescing key and groups dispatch
earliest-deadline-first), supervised worker and updater threads that
heartbeat into a ``HeartbeatMonitor`` and are restarted after a crash (a
crash fails only the in-flight group's futures), a load-shedding ladder
(``shed_watermark``: class p may fill a ``w + (1-w)(1 - 2^-p)`` fraction of
the queue), per-answer ``.staleness`` (acknowledged-but-unapplied records
at dispatch time), an optional ``RetryPolicy`` around dispatches, and a
``FailureInjector`` consulted at three sites — ``serve.worker``,
``serve.dispatch`` and ``serve.updater``.

Sharded tables (``TableSpec(shards=N)``) are answered through
``session.query``, whose sharded engines keep their own partitions, as
the reference answers them through its shard_map executors.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import queue
import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..api.session import Answer
from ..api.spec import DEFAULT_REL, QueryBatch, QuerySpec
from ..dist.fault_tolerance import HeartbeatMonitor
from ..engine import execute_lsm, level_executor, pad_fills
from ..engine.engine import _bucket_size

__all__ = ["ServingEngine", "QueueFull", "Overloaded", "DeadlineExceeded",
           "EngineStats"]


class QueueFull(RuntimeError):
    """``admission='reject'`` and the bounded request queue is at capacity."""


class Overloaded(QueueFull):
    """Shed by the degradation ladder: the queue is past the watermark and
    this request's priority class has no reserved headroom left."""


class DeadlineExceeded(TimeoutError):
    """The request's admission deadline expired while it was queued."""


@dataclasses.dataclass
class EngineStats:
    """Monotonic counters; read a consistent copy via ``engine.stats``.
    The ``aot_*`` names are the reference's: on the card ``aot_compiles``
    counts CUDA-graph captures."""

    submitted: int = 0        # read requests accepted into the queue
    rejected: int = 0         # read requests refused by admission='reject'
    shed: int = 0             # read requests shed by the priority ladder
    answered: int = 0         # read requests resolved by a dispatch
    deadline_expired: int = 0  # queued requests expired before dispatch
    dispatches: int = 0       # device dispatches serving reads
    coalesced: int = 0        # requests that shared a dispatch with others
    stale_reads: int = 0      # answers served with unapplied updates pending
    aot_compiles: int = 0     # executables captured on dispatch or warm-up
    aot_hits: int = 0         # dispatches served from the cache
    aot_invalidations: int = 0  # cache entries dropped on plan swap
    aot_precompiles: int = 0  # executables staged on the merge thread
    aot_promotions: int = 0   # staged executables promoted at dispatch
    staged_records: int = 0   # update records accepted into the journal
    drains: int = 0           # updater wake-ups that applied work
    fused_applies: int = 0    # engine insert/delete calls made by drains
    worker_crashes: int = 0   # worker threads that died mid-batch
    updater_crashes: int = 0  # updater threads that died mid-drain
    restarts: int = 0         # threads respawned by the supervisor
    journal_replayed: int = 0  # items a restarted updater found un-applied


class _ReadRequest:
    __slots__ = ("table", "kind", "rel", "ranges", "params", "n", "future",
                 "deadline", "dclass", "priority")

    def __init__(self, table: str, rel, ranges: Tuple, n: int,
                 deadline: Optional[float] = None,
                 dclass: Optional[int] = None, priority: int = 0,
                 kind: str = "count", params: Tuple = ()):
        self.table = table
        self.kind = kind            # resolved query kind (never None)
        self.rel = rel
        self.ranges = ranges
        self.params = params        # static kind params ((t0, t1) windows)
        self.n = n
        self.deadline = deadline    # absolute monotonic, or None
        self.dclass = dclass        # pow-2 bucket of the deadline duration
        self.priority = priority
        self.future: Future = Future()


class _WriteItem:
    __slots__ = ("table", "kind", "args", "n", "future", "seq")

    def __init__(self, table: Optional[str], kind: str, args: Tuple,
                 n: int):
        self.table = table
        self.kind = kind            # 'insert' | 'delete' | 'barrier'
        self.args = args
        self.n = n
        self.seq = -1               # assigned by the journal
        self.future: Future = Future()


class _UpdateJournal:
    """Write-ahead staging log with an applied watermark.

    ``append`` assigns a monotone sequence number; ``pending`` returns the
    un-applied suffix (items above the watermark, in order); the updater
    calls ``mark_applied`` only after an item's chunk has landed on the
    engine, so whatever the updater was holding when it crashed is exactly
    what ``pending`` hands its replacement.  All methods run under the
    engine's staging condition variable.
    """

    __slots__ = ("_items", "_next_seq", "_applied")

    def __init__(self):
        self._items: deque = deque()
        self._next_seq = 0
        self._applied = -1          # every seq <= this has been applied

    def append(self, item: _WriteItem) -> int:
        item.seq = self._next_seq
        self._next_seq += 1
        self._items.append(item)
        return item.seq

    def pending(self) -> List[_WriteItem]:
        return [it for it in self._items if it.seq > self._applied]

    def mark_applied(self, seq: int) -> None:
        self._applied = max(self._applied, seq)
        while self._items and self._items[0].seq <= self._applied:
            self._items.popleft()

    def depth(self, table: Optional[str] = None) -> int:
        return sum(it.n for it in self._items
                   if it.seq > self._applied
                   and (table is None or it.table == table))


# ---------------------------------------------------------------------------
# the executable cache: one captured CUDA graph (or, on the CPU, the plain
# callable) per key
# ---------------------------------------------------------------------------

def _state_fields(state):
    """The (name, value) pairs of the non-plan operands a unit copies into
    its slots: a delta buffer's fields, or an LSM level's fields other than
    its plan (which the graph reads in place); none for a static table."""
    if not dataclasses.is_dataclass(state):
        return ()
    return tuple((f.name, getattr(state, f.name))
                 for f in dataclasses.fields(state) if f.name != "plan")


def _state_sig(state) -> Tuple:
    """Hashable signature of the non-plan operands: every tensor's shape and
    dtype, which optional fields are ``None``, and the scalar fields.  A
    capture bakes all three in (``buf.vic_keys is None`` is a Python
    branch), so a signature change re-captures."""
    out = []
    for name, v in _state_fields(state):
        if isinstance(v, torch.Tensor):
            out.append((name, tuple(v.shape), str(v.dtype)))
        else:
            out.append((name, v))
    return type(state).__name__, tuple(out)


def _clone_state(state):
    """The state with every tensor replaced by a fresh copy (its slots)."""
    fields = {name: v.clone() for name, v in _state_fields(state)
              if isinstance(v, torch.Tensor)}
    return dataclasses.replace(state, **fields) if fields else state


def _copy_state(slots, state) -> None:
    for name, v in _state_fields(state):
        if isinstance(v, torch.Tensor):
            getattr(slots, name).copy_(v)


class _Unit:
    """One cached executable for one plan and one operand signature.

    On a CPU session ``graph`` is None and ``run`` calls the plain callable.
    On the card ``graph`` is the CUDA graph of ``call(plan, state_slots,
    *q_slots)``; ``run`` copies the padded queries into ``q_slots`` (and
    the state into ``state_slots`` when the state object is not the one
    last copied), replays, and returns clones of the static outputs, all
    under ``_REPLAY_LOCK``: an engine's graphs share a memory pool, so a
    later capture may place its outputs in an earlier graph's scratch
    memory, and no other replay may run between a replay and the clone of
    its outputs."""

    __slots__ = ("plan_ref", "sig", "call", "fills", "graph", "state_slots",
                 "state_ref", "q_slots", "outs")

    def __init__(self, plan_ref, call, fills):
        self.plan_ref = plan_ref
        self.sig = None             # set by the cache that keys the unit
        self.call = call
        self.fills = fills          # host padding values of the columns
        self.graph = None
        self.state_slots = None
        self.state_ref = None
        self.q_slots: List[torch.Tensor] = []
        self.outs: Tuple[torch.Tensor, ...] = ()

    def run(self, state, qs: Sequence[torch.Tensor]):
        if self.graph is None:
            return tuple(self.call(self.plan_ref, state, *qs))
        with _REPLAY_LOCK:
            if state is not self.state_ref:
                _copy_state(self.state_slots, state)
                self.state_ref = state
            for slot, q in zip(self.q_slots, qs):
                slot.copy_(q)
            self.graph.replay()
            return tuple(o.clone() for o in self.outs)


class _ExecEntry:
    """The unit serving one cache key plus its staged successor.

    ``cur`` is valid for a (plan identity, state signature) pair; ``nxt``
    holds the successor the merge-thread listener captured for an incoming
    plan, which ``promote`` installs at the first dispatch that sees that
    plan, so a swap costs zero captures."""

    __slots__ = ("cur", "nxt")

    def __init__(self, cur: Optional[_Unit] = None):
        self.cur = cur
        self.nxt: Optional[_Unit] = None

    def matches(self, plan_ref, sig) -> bool:
        return (self.cur is not None and self.cur.plan_ref is plan_ref
                and self.cur.sig == sig)

    def staged_for(self, plan_ref, sig) -> bool:
        return (self.nxt is not None and self.nxt.plan_ref is plan_ref
                and self.nxt.sig == sig)

    def promote(self, plan_ref, sig) -> bool:
        if self.staged_for(plan_ref, sig):
            self.cur, self.nxt = self.nxt, None
            return True
        return False


# captures run one at a time in the process, with no replay running and
# the cyclic garbage collector paused: a collection during a capture could
# free another engine's CUDA graph on the capturing thread, which the
# capture refuses
_CAPTURE_LOCK = threading.Lock()
_REPLAY_LOCK = threading.Lock()


@contextlib.contextmanager
def _capturing():
    with _CAPTURE_LOCK, _REPLAY_LOCK:
        was = gc.isenabled()
        gc.disable()
        try:
            yield
        finally:
            if was:
                gc.enable()


def _host_fills(plan) -> Tuple[float, ...]:
    """The range columns' padding values (``pad_fills``) as host floats."""
    return tuple(float(f) for f in pad_fills(plan))


class ServingEngine:
    """Queue -> admission batcher -> CUDA-graph executable cache over one
    session.

    ``max_queue`` bounds the read queue (backpressure), ``max_batch`` caps
    the queries coalesced into one dispatch, ``workers`` is the number of
    drain threads (1 keeps dispatch order deterministic).  ``start=False``
    builds the engine without threads — ``submit`` still queues, nothing
    drains — which makes backpressure deterministic to test; call
    ``start()`` to begin serving.

    Fault-tolerance knobs: ``injector`` (a ``FailureInjector`` consulted
    at the serve.worker / serve.dispatch / serve.updater sites),
    ``retry`` (a ``RetryPolicy`` wrapped around dispatches — filter its
    ``retry_on`` to the transient exception classes), ``supervise``
    (restart crashed worker/updater threads; on by default),
    ``heartbeat_deadline`` (seconds without a beat before a thread counts
    as stalled), ``shed_watermark`` (queue fraction where the priority
    ladder starts shedding; ``None`` disables shedding), and
    ``default_deadline`` (admission deadline for requests whose table
    declares none).

    On a session whose tables live on the card every cached executable is
    a captured CUDA graph; a capture that fails raises to the requests it
    was serving (it never falls back to eager execution).
    """

    def __init__(self, session, *, max_queue: int = 1024,
                 max_batch: int = 4096, workers: int = 1,
                 admission: str = "block", start: bool = True,
                 injector=None, retry=None, supervise: bool = True,
                 heartbeat_deadline: float = 5.0,
                 shed_watermark: Optional[float] = None,
                 default_deadline: Optional[float] = None):
        if admission not in ("block", "reject"):
            raise ValueError(f"admission must be 'block' or 'reject', "
                             f"got {admission!r}")
        if workers < 1:
            raise ValueError("workers must be >= 1")
        if shed_watermark is not None and not 0.0 < shed_watermark <= 1.0:
            raise ValueError("shed_watermark must be in (0, 1]")
        self.session = session
        self.max_batch = int(max_batch)
        self.admission = admission
        self.supervise = bool(supervise)
        self.shed_watermark = shed_watermark
        self.default_deadline = default_deadline
        self._injector = injector
        self._retry = retry
        self._crash_exc = injector.exc if injector is not None else ()
        self.monitor = HeartbeatMonitor(deadline=heartbeat_deadline)
        self._queue: "queue.Queue[_ReadRequest]" = queue.Queue(max_queue)
        self._cache: Dict[Tuple, _ExecEntry] = {}
        self._compile_lock = threading.Lock()
        self.device = torch.device(session.device)
        self.graphs = self.device.type == "cuda"
        if self.graphs:
            # every graph of this engine allocates from one pool; captures
            # run on the engine's own stream
            self._pool = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(self.device)
        # exceptions raised while staging an incoming plan's graphs on the
        # merge thread (the dispatch then captures, and raises if it fails)
        self.stage_errors: List[BaseException] = []
        self._journal = _UpdateJournal()
        self._staging_cv = threading.Condition()
        self._drain_lock = threading.Lock()
        self._stats = EngineStats()
        self._stats_lock = threading.Lock()
        self._update_errors: List[BaseException] = []
        self._stop = threading.Event()
        self._shut_down = False
        self._closing = False       # shutdown has begun: refuse new reads
        self._n_workers = int(workers)
        self._thread_lock = threading.Lock()
        self._workers: List[Optional[threading.Thread]] = []
        self._updater: Optional[threading.Thread] = None
        self._supervisor: Optional[threading.Thread] = None
        self._register_swap_listeners()
        if start:
            self.start()

    # -- lifecycle --------------------------------------------------------

    def _spawn_worker(self, i: int) -> threading.Thread:
        t = threading.Thread(target=self._worker_run, args=(i,),
                             daemon=True, name=f"polyfit-serve-{i}")
        t.start()
        return t

    def _spawn_updater(self, replaying: bool) -> threading.Thread:
        t = threading.Thread(target=self._updater_run, args=(replaying,),
                             daemon=True, name="polyfit-update")
        t.start()
        return t

    def start(self) -> None:
        """Spawn the worker + updater (+ supervisor) threads (idempotent)."""
        if self._shut_down:
            raise RuntimeError("engine was shut down")
        with self._thread_lock:
            if self._workers:
                return
            self._workers = [self._spawn_worker(i)
                             for i in range(self._n_workers)]
            self._updater = self._spawn_updater(replaying=False)
            if self.supervise:
                self._supervisor = threading.Thread(
                    target=self._supervisor_loop, daemon=True,
                    name="polyfit-supervise")
                self._supervisor.start()

    @property
    def _threads(self) -> List[threading.Thread]:
        with self._thread_lock:
            out = [t for t in self._workers if t is not None]
            if self._updater is not None:
                out.append(self._updater)
            if self._supervisor is not None:
                out.append(self._supervisor)
            return out

    @property
    def running(self) -> bool:
        return bool(self._threads) and not self._shut_down

    def shutdown(self, drain: bool = True, timeout: Optional[float] = None
                 ) -> None:
        """Stop the engine.  ``drain=True`` answers everything already
        queued (reads) and applies everything staged (writes) first;
        ``drain=False`` cancels queued reads and staged writes with a
        ``RuntimeError``.  Idempotent; a ``submit`` racing shutdown either
        gets served (drain) or resolves with the same error — never
        hangs."""
        if self._shut_down:
            return
        # refuse new reads from here on: a drain that kept admitting them
        # would wait as long as clients keep submitting
        self._closing = True
        threads = self._threads
        if drain and threads:
            self._queue.join()
            # apply staged writes but never raise deferred errors out of a
            # cleanup path — they stay queued for explicit drain_updates()
            self._drain_updates(raise_errors=False)
        self._shut_down = True
        self._stop.set()
        with self._staging_cv:
            self._staging_cv.notify_all()
        if not drain:
            self._cancel_queued("serving engine shut down")
            self._cancel_staged("serving engine shut down")
        for t in threads:
            t.join(timeout)
        with self._thread_lock:
            self._workers = []
            self._updater = None
            self._supervisor = None
        # a submit may have slipped in between the drain/cancel above and
        # the _shut_down flag landing; nothing serves it now, so sweep —
        # submit() re-checks the flag after its put for the same reason
        self._cancel_queued("serving engine shut down")

    def _cancel_queued(self, msg: str) -> None:
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            if not req.future.done():
                req.future.set_exception(RuntimeError(msg))
            self._queue.task_done()

    def _cancel_staged(self, msg: str) -> None:
        with self._staging_cv:
            items = self._journal.pending()
            for it in items:
                self._journal.mark_applied(it.seq)
        for it in items:
            if not it.future.done():
                if it.kind == "barrier":
                    it.future.set_result(None)
                else:
                    it.future.set_exception(RuntimeError(msg))

    # -- supervision ------------------------------------------------------

    def _supervisor_loop(self) -> None:
        """Restart crashed worker/updater threads until shutdown."""
        while not self._stop.wait(0.02):
            with self._thread_lock:
                if self._stop.is_set() or not self._workers:
                    continue
                restarted = 0
                for i, t in enumerate(self._workers):
                    if t is not None and not t.is_alive():
                        self._workers[i] = self._spawn_worker(i)
                        restarted += 1
                if self._updater is not None and not self._updater.is_alive():
                    self._updater = self._spawn_updater(replaying=True)
                    restarted += 1
            if restarted:
                with self._stats_lock:
                    self._stats.restarts += restarted

    def health(self) -> Dict:
        """Liveness snapshot: thread states, stall list, crash counters,
        journal depth — the supervisor's view, for operators."""
        with self._thread_lock:
            workers_alive = sum(1 for t in self._workers
                                if t is not None and t.is_alive())
            updater_alive = (self._updater is not None
                             and self._updater.is_alive())
        st = self.stats
        out = {
            "running": self.running,
            "workers_alive": workers_alive,
            "updater_alive": updater_alive,
            "stalled": self.monitor.stalled(),
            "queue_depth": self.queue_depth,
            "staged_depth": self.staged_depth,
            "worker_crashes": st.worker_crashes,
            "updater_crashes": st.updater_crashes,
            "restarts": st.restarts,
        }
        if self._retry is not None:
            out["retry"] = {"retries": self._retry.retries,
                            "giveups": self._retry.giveups,
                            "slept": self._retry.slept}
        return out

    def _maybe_fail(self, site: str) -> None:
        if self._injector is not None:
            self._injector.maybe_fail(site)

    # -- reads ------------------------------------------------------------

    def _admission_class(self, table: str) -> Tuple[Optional[float], int]:
        deadline, priority = self.session.admission_class(table)
        if deadline is None:
            deadline = self.default_deadline
        return deadline, int(priority)

    def _shed(self, priority: int) -> bool:
        w = self.shed_watermark
        cap = self._queue.maxsize
        if w is None or cap <= 0:
            return False
        # the (1-w) tail of the queue is reserved in geometric slices for
        # higher priority classes: class p may fill w + (1-w)(1 - 2^-p)
        limit = cap * (w + (1.0 - w) * (1.0 - 2.0 ** (-max(priority, 0))))
        return self._queue.qsize() >= limit

    def submit(self, spec: QuerySpec, *, deadline: Optional[float] = None,
               priority: Optional[int] = None,
               timeout: Optional[float] = None) -> Future:
        """Enqueue one read; the future resolves to its structured
        ``Answer`` (value + certified bound + staleness; ``.staleness`` is
        also set on the future itself).

        ``deadline`` (seconds from now; default the table's class) bounds
        the *queue wait*: a request still queued when it expires resolves
        with ``DeadlineExceeded`` instead of dispatching.  ``priority``
        picks the shedding rung when the ladder is armed.
        ``admission='block'`` waits up to ``timeout`` for queue room (then
        raises ``QueueFull``); ``'reject'`` raises immediately when full.
        Once ``shutdown`` has begun, ``submit`` raises ``RuntimeError``.
        """
        if self._closing:
            raise RuntimeError("serving engine shut down")
        kind, rel, params = self.session.resolve_spec(spec)
        d_default, p_default = self._admission_class(spec.table)
        if deadline is None:
            deadline = d_default
        if priority is None:
            priority = p_default
        if self._shed(priority):
            with self._stats_lock:
                self._stats.shed += 1
            raise Overloaded(
                f"load shed: queue past watermark "
                f"{self.shed_watermark:.2f} for priority {priority}")
        dclass = (None if deadline is None
                  else max(math.ceil(math.log2(max(deadline, 1e-3))), -10))
        abs_deadline = (None if deadline is None
                        else time.monotonic() + deadline)
        req = _ReadRequest(spec.table, rel, spec.ranges, len(spec),
                           abs_deadline, dclass, priority, kind=kind,
                           params=params)
        try:
            if self.admission == "reject":
                self._queue.put_nowait(req)
            else:
                self._queue.put(req, timeout=timeout)
        except queue.Full:
            with self._stats_lock:
                self._stats.rejected += 1
            raise QueueFull(f"request queue at capacity "
                            f"({self._queue.maxsize})") from None
        with self._stats_lock:
            self._stats.submitted += 1
        if self._closing:
            # raced shutdown's drain or final sweep: make sure this future
            # resolves (served by a draining worker, or cancelled here)
            if self._shut_down:
                self._cancel_queued("serving engine shut down")
        return req.future

    def query(self, request: Union[QuerySpec, QueryBatch,
                                   Sequence[QuerySpec]],
              *, timeout: Optional[float] = None):
        """Blocking convenience mirroring ``session.query``: one spec
        returns its ``Answer``, a batch returns the aligned list."""
        if isinstance(request, QuerySpec):
            return self.submit(request).result(timeout)
        specs = list(request.specs if isinstance(request, QueryBatch)
                     else request)
        futures = [self.submit(s) for s in specs]
        return [f.result(timeout) for f in futures]

    def serve(self, table: str, *ranges, rel=DEFAULT_REL,
              timeout: Optional[float] = None):
        """Blocking single-request endpoint: ``serve('count', lq, uq)``;
        the answer is on the device and complete when it returns."""
        return self.submit(QuerySpec(table, ranges, rel)).result(timeout)

    # -- worker: drain, coalesce, dispatch --------------------------------

    def _worker_run(self, wid: int) -> None:
        """Thread body: loop until stop; on crash, die quietly (the
        supervisor restarts; the crash already failed only the in-flight
        batch inside ``_worker_loop``)."""
        name = f"worker-{wid}"
        try:
            self._worker_loop(name)
        except BaseException:
            with self._stats_lock:
                self._stats.worker_crashes += 1
        finally:
            self.monitor.forget(name)

    def _worker_loop(self, name: str) -> None:
        q = self._queue
        while True:
            self.monitor.beat(name)
            try:
                req = q.get(timeout=0.05)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            batch = [req]
            try:
                # chaos site: a crash here has requests in flight — fail
                # exactly those futures, account the queue, then die
                self._maybe_fail("serve.worker")
                budget = self.max_batch - req.n
                while budget > 0:
                    # peek so the admission batch never overshoots
                    # max_batch — overshoot would hit a bucket above the
                    # warmed ladder
                    with q.mutex:
                        if not q.queue or q.queue[0].n > budget:
                            break
                    try:
                        nxt = q.get_nowait()
                    except queue.Empty:
                        break
                    batch.append(nxt)
                    budget -= nxt.n
                self._process_batch(batch)
            except BaseException as e:
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)
                raise
            finally:
                for _ in batch:
                    q.task_done()

    def _process_batch(self, batch: List[_ReadRequest]) -> None:
        # admission deadlines: expire pre-dispatch, never waste the device
        now = time.monotonic()
        live: List[_ReadRequest] = []
        expired = 0
        for r in batch:
            if r.deadline is not None and now > r.deadline:
                if not r.future.done():
                    r.future.set_exception(DeadlineExceeded(
                        f"deadline expired after "
                        f"{now - r.deadline:.3f}s in queue"))
                expired += 1
            else:
                live.append(r)
        if expired:
            with self._stats_lock:
                self._stats.deadline_expired += expired
        groups: Dict[Tuple, List[_ReadRequest]] = {}
        for r in live:
            # the deadline class keys the group: tight requests are never
            # padded into (or billed for) a slack batch's bucket; kind and
            # its static params key it too — a quantile never coalesces
            # into a range bucket, nor one window into another's epochs
            groups.setdefault((r.table, r.kind, r.rel, r.dclass, r.params),
                              []).append(r)
        # earliest-deadline-first across the batch's groups
        ordered = sorted(
            groups.items(),
            key=lambda kv: min((r.deadline for r in kv[1]
                                if r.deadline is not None),
                               default=float("inf")))
        for (table, kind, rel, _, params), grp in ordered:
            # count before resolving: a caller that saw its future
            # complete must also see it reflected in ``stats``
            with self._stats_lock:
                self._stats.dispatches += 1
                self._stats.answered += len(grp)
                if len(grp) > 1:
                    self._stats.coalesced += len(grp)
            try:
                if self._retry is not None:
                    self._retry.call(self._dispatch, table, kind, rel,
                                     params, grp)
                else:
                    self._dispatch(table, kind, rel, params, grp)
            except BaseException as e:   # surface on the callers
                for r in grp:
                    if not r.future.done():
                        r.future.set_exception(e)

    def _sync(self) -> None:
        """Futures resolve device-ready: wait for this thread's stream."""
        if self.graphs:
            torch.cuda.current_stream(self.device).synchronize()

    def _dispatch(self, table: str, kind: str, rel, params: Tuple,
                  grp: List[_ReadRequest]) -> None:
        self._maybe_fail("serve.dispatch")
        sess = self.session
        staleness = self.staleness(table)
        if staleness:
            with self._stats_lock:
                self._stats.stale_reads += len(grp)
        nq = sum(r.n for r in grp)
        size = _bucket_size(nq, sess.min_bucket)
        if kind == "window":
            # epoch-ring tables: the window snapshot *is* a small LSM plan
            # of immutable per-epoch levels — served by the same per-level
            # graphs (sealed epochs never invalidate their entries)
            plan, buf = sess.window_snapshot(table, *params)
            bound = sess.window_bound(table, *params)
            if plan is None:
                res = sess.query(QuerySpec(table, self._concat_ranges(grp),
                                           rel, kind="window",
                                           params=params))
            else:
                res = execute_lsm(plan, buf, self._concat_ranges(grp),
                                  backend=sess.backend, eps_rel=rel,
                                  min_bucket=sess.min_bucket,
                                  level_runner=self._lsm_runner(
                                      table, rel, size, plan))
                res = Answer(res.answer, res.approx, res.refined,
                             bound=bound, staleness=staleness)
            self._sync()
            self._scatter(grp, res, staleness)
            return
        if sess.is_sharded(table):
            # the sharded engines keep their own partitions; no graph here
            res = sess.query(QuerySpec(table, self._concat_ranges(grp), rel,
                                       kind=kind, params=params))
            self._sync()
            self._scatter(grp, res, staleness)
            return
        plan, buf = sess.snapshot(table)
        if kind == "quantile":
            unit = self._executable(table, rel, size, plan, buf,
                                    kind="quantile")
            qs = self._padded(grp, size, unit.fills, plan.dtype)
            ans, lo, hi = unit.run(buf, qs)
            self._sync()
            res = Answer(ans, ans, torch.zeros(ans.shape, dtype=torch.bool,
                                               device=ans.device),
                         bound=(lo, hi), staleness=staleness)
            self._scatter(grp, res, staleness)
            return
        bound = sess.budget(table).bound(sess.spec(table).agg)
        if hasattr(plan, "levels"):
            # LSM ladder: one graph *per level*, fused exactly by
            # execute_lsm's combiner — a compaction only invalidates the
            # rebuilt slots' entries
            res = execute_lsm(plan, buf, self._concat_ranges(grp),
                              backend=sess.backend, eps_rel=rel,
                              min_bucket=sess.min_bucket,
                              level_runner=self._lsm_runner(
                                  table, rel, size, plan))
            self._sync()
            self._scatter(grp, Answer(res.answer, res.approx, res.refined,
                                      bound=bound, staleness=staleness),
                          staleness)
            return
        unit = self._executable(table, rel, size, plan, buf)
        qs = self._padded(grp, size, unit.fills, plan.dtype)
        ans, approx, refined = unit.run(buf, qs)
        self._sync()
        self._scatter(grp, Answer(ans, approx, refined, bound=bound,
                                  staleness=staleness), staleness)

    @staticmethod
    def _concat_ranges(grp: List[_ReadRequest]) -> Tuple:
        """The group's range columns: host concatenations of numpy parts,
        a torch concatenation once any part is a tensor."""
        if len(grp) == 1:
            return tuple(grp[0].ranges)
        out = []
        for j in range(len(grp[0].ranges)):
            parts = [r.ranges[j] for r in grp]
            if all(isinstance(p, np.ndarray) for p in parts):
                out.append(np.concatenate(parts))
            else:
                dev = next(p.device for p in parts
                           if isinstance(p, torch.Tensor))
                out.append(torch.cat([torch.as_tensor(p, dtype=torch.float64,
                                                      device=dev)
                                      for p in parts]))
        return tuple(out)

    def _padded(self, grp: List[_ReadRequest], size: int, fills,
                dtype: torch.dtype) -> List[torch.Tensor]:
        """The group's columns padded to the bucket with the plan's fills
        (the values ``execute_*`` pads with): host tensors for numpy input,
        device tensors for tensor input."""
        out = []
        for col, fill in zip(self._concat_ranges(grp), fills):
            if isinstance(col, np.ndarray):
                a = np.full(size, fill, np.float64)
                a[:len(col)] = col
                out.append(torch.from_numpy(a).to(dtype))
            else:
                col = col.to(dtype).reshape(-1)
                pad = col.new_full((size - col.shape[0],), fill)
                out.append(torch.cat([col, pad]))
        return out

    @staticmethod
    def _slice_answer(a, off: int, m: int) -> "Answer":
        bound = a.bound
        if isinstance(bound, tuple):     # quantile (lo, hi) certificates
            bound = tuple(b[off:off + m] for b in bound)
        return Answer(a.value[off:off + m], a.approx[off:off + m],
                      a.refined[off:off + m], bound=bound,
                      staleness=a.staleness)

    @staticmethod
    def _scatter(grp: List[_ReadRequest], res, staleness: int = 0) -> None:
        if not isinstance(res, Answer):  # degenerate paths (QueryResult)
            res = Answer(res.answer, res.approx, res.refined,
                         staleness=staleness)
        off = 0
        for r in grp:
            m = r.n
            # per-answer degradation signal: how many acknowledged update
            # records were not yet applied when this answer was computed
            r.future.staleness = staleness
            if not r.future.done():
                r.future.set_result(
                    ServingEngine._slice_answer(res, off, m))
            off += m

    # -- the executable cache ---------------------------------------------

    def _new_unit(self, call, plan, state, size: int, fills) -> _Unit:
        """A unit for ``call(plan, state, *qs)`` at bucket ``size``: the
        plain callable on the CPU; on the card, slots for the state and the
        queries (the queries filled with the padding values), one eager run
        on the engine's stream (it builds the kernel library and loads its
        modules), then the capture.  Call under ``_compile_lock``."""
        unit = _Unit(plan, call, fills)
        if not self.graphs:
            return unit
        dev, dt = self.device, plan.dtype
        unit.state_slots = _clone_state(state)
        unit.state_ref = state
        unit.q_slots = [torch.full((size,), f, dtype=dt, device=dev)
                        for f in fills]
        cs = self._capture_stream
        cs.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with _capturing():
            with torch.cuda.stream(cs):
                call(plan, unit.state_slots, *unit.q_slots)
            with torch.cuda.graph(graph, pool=self._pool, stream=cs,
                                  capture_error_mode="thread_local"):
                outs = call(plan, unit.state_slots, *unit.q_slots)
        torch.cuda.current_stream(dev).wait_stream(cs)
        unit.graph = graph
        unit.outs = tuple(outs)
        return unit

    def _lookup(self, key: Tuple, plan_ref, sig, make) -> _Unit:
        """The unit for ``key`` valid for (plan_ref, sig): a hit, a staged
        successor promoted, or a fresh capture from ``make()``."""
        entry = self._cache.get(key)
        if entry is not None and entry.matches(plan_ref, sig):
            with self._stats_lock:
                self._stats.aot_hits += 1
            return entry.cur
        with self._compile_lock:
            entry = self._cache.get(key)
            if entry is not None:
                if entry.matches(plan_ref, sig):
                    with self._stats_lock:
                        self._stats.aot_hits += 1
                    return entry.cur
                if entry.promote(plan_ref, sig):
                    with self._stats_lock:
                        self._stats.aot_promotions += 1
                    return entry.cur
                with self._stats_lock:
                    self._stats.aot_invalidations += 1
            unit = make()
            unit.sig = sig
            if entry is None:
                self._cache[key] = _ExecEntry(unit)
            else:
                entry.cur = unit
            with self._stats_lock:
                self._stats.aot_compiles += 1
            return unit

    def _executable(self, table: str, rel, size: int, plan, buf,
                    kind: str = "range") -> _Unit:
        # quantile executables live under their own 4-tuple keys so the
        # range ladder and the inversion ladder never collide (LSM level
        # entries are 4-tuples too, distinguished by an int slot)
        key = ((table, rel, size) if kind == "range"
               else (table, rel, size, "quantile"))

        def make():
            fn = self.session.serving_executor(table, rel, kind=kind)
            fills = ((0.5,) if kind == "quantile" else _host_fills(plan))
            return self._new_unit(fn, plan, buf, size, fills)
        return self._lookup(key, plan, _state_sig(buf), make)

    # -- LSM tables: per-level graphs --------------------------------------

    def _lsm_statics(self, rel, lsm) -> dict:
        """The statics ``execute_lsm`` resolves for this dispatch — the
        per-level unit must run with exactly these so the cached call
        computes the same floats as the session's path."""
        backend = self.session.backend
        if lsm.agg in ("max", "min") \
                and backend in ("cuda", "cuda_scan", "ref") \
                and any(lvl.plan.deg > 3 for lvl in lsm.levels):
            backend = "torch"   # mirrors execute_lsm's extremal downgrade
        return dict(backend=backend, with_truth=rel is not None)

    def _new_level_unit(self, lvl, agg: str, statics: dict,
                        size: int) -> _Unit:
        fn = level_executor(agg, **statics)
        fills = _host_fills(lvl.plan)
        return self._new_unit(lambda plan, level, *qs: fn(level, *qs),
                              lvl.plan, lvl, size, fills)

    @staticmethod
    def _level_sig(lvl, statics: dict) -> Tuple:
        return _state_sig(lvl), tuple(sorted(statics.items()))

    def _level_executable(self, table: str, rel, size: int, lvl, agg: str,
                          statics: dict) -> _Unit:
        key = (table, rel, size, lvl.slot)
        return self._lookup(
            key, lvl.plan, self._level_sig(lvl, statics),
            lambda: self._new_level_unit(lvl, agg, statics, size))

    def _lsm_runner(self, table: str, rel, size: int, lsm):
        """A ``level_runner`` for ``execute_lsm`` that serves each level
        from the cache (keyed by slot, validated by level plan identity and
        signature)."""
        statics = self._lsm_statics(rel, lsm)
        agg = lsm.agg

        def runner(i, lvl, *qs):
            unit = self._level_executable(table, rel, size, lvl, agg,
                                          statics)
            return unit.run(lvl, qs)
        return runner

    # -- plan-swap staging (merge-thread listener) --------------------------

    def _register_swap_listeners(self) -> None:
        """Hook ``session.on_plan_swap`` for every dynamic, unsharded
        table: the merge/compaction thread hands the incoming plan (or
        preview ladder) to ``_precompile`` *before* the atomic install,
        so post-swap dispatches promote staged graphs instead of
        capturing."""
        sess = self.session
        for table in sess.tables:
            if sess.spec(table).dynamic and not sess.is_sharded(table):
                sess.on_plan_swap(table, self._precompile_listener(table))

    def _precompile_listener(self, table: str):
        # the session keeps its listeners for its lifetime: a weak reference
        # lets an engine that is no longer used be freed (with its graphs)
        ref = weakref.ref(self)

        def listener(incoming) -> None:
            eng = ref()
            if eng is None or eng._shut_down:
                return   # a dead engine's cache needs no staged successors
            try:
                eng._precompile(table, incoming)
            except Exception as e:   # never abort an install: the first
                eng.stage_errors.append(e)   # dispatch captures instead
        return listener

    def _stage(self, key: Tuple, plan_ref, sig, make) -> None:
        """Capture ``make()``'s unit as ``key``'s staged successor unless
        the current or staged unit already serves (plan_ref, sig)."""
        with self._compile_lock:
            entry = self._cache.get(key)
            if entry is not None and (entry.matches(plan_ref, sig)
                                      or entry.staged_for(plan_ref, sig)):
                return
            unit = make()
            unit.sig = sig
            entry = self._cache.get(key)
            if entry is None:
                entry = self._cache[key] = _ExecEntry()
            entry.nxt = unit
        with self._stats_lock:
            self._stats.aot_precompiles += 1

    def _precompile(self, table: str, incoming) -> None:
        with self._compile_lock:
            keys = [k for k in self._cache if k[0] == table]
            flat = {k: self._cache[k].cur for k in keys
                    if self._cache[k].cur is not None
                    and (len(k) == 3 or k[3] == "quantile")}
        if hasattr(incoming, "levels"):
            combos = sorted({(k[1], k[2]) for k in keys
                             if len(k) == 4 and k[3] != "quantile"},
                            key=lambda c: (repr(c[0]), c[1]))
            for rel, size in combos:
                statics = self._lsm_statics(rel, incoming)
                for lvl in incoming.levels:
                    self._stage(
                        (table, rel, size, lvl.slot), lvl.plan,
                        self._level_sig(lvl, statics),
                        lambda lvl=lvl, statics=statics, size=size:
                        self._new_level_unit(lvl, incoming.agg, statics,
                                             size))
            return
        for key in sorted(flat, key=repr):
            cur = flat[key]
            if cur.plan_ref is incoming:
                continue
            kind = "range" if len(key) == 3 else "quantile"
            # the incoming plan is staged against the current unit's state
            # slots as its template: the buffer a swap installs keeps its
            # signature (a CPU unit keeps no slots and needs none)
            tmpl = cur.state_slots
            rel, size = key[1], key[2]

            def make(rel=rel, size=size, kind=kind, tmpl=tmpl):
                fn = self.session.serving_executor(table, rel, kind=kind)
                fills = ((0.5,) if kind == "quantile"
                         else _host_fills(incoming))
                unit = self._new_unit(fn, incoming, tmpl, size, fills)
                unit.state_ref = None   # the slots hold no live buffer yet
                return unit
            self._stage(key, incoming, cur.sig, make)

    def warmup(self, max_bucket: int = 1024,
               tables: Optional[Sequence[str]] = None,
               kinds: Sequence[str] = ("range",)) -> int:
        """Capture the full power-of-two bucket ladder (``min_bucket`` ..
        ``max_bucket``) for every (table, default guarantee); returns the
        number of executables captured.  After this, any admitted batch up
        to ``max_bucket`` queries serves without capturing.  ``kinds``
        picks the executor ladders: ``'range'`` (the aggregate family)
        and/or ``'quantile'`` (CF inversion; skipped on tables that cannot
        answer quantiles).  Windowed tables warm lazily — their per-epoch
        levels capture on first touch and sealed epochs never
        invalidate."""
        sess = self.session
        before = self.stats.aot_compiles
        for table in (tables if tables is not None else sess.tables):
            if sess.is_sharded(table) or sess.is_window(table):
                continue
            spec = sess.spec(table)
            rel = sess.resolve_rel(table)
            plan, buf = sess.snapshot(table)
            size = sess.min_bucket
            while size <= max_bucket:
                if hasattr(plan, "levels"):
                    if "range" in kinds:
                        statics = self._lsm_statics(rel, plan)
                        for lvl in plan.levels:
                            self._level_executable(table, rel, size, lvl,
                                                   plan.agg, statics)
                else:
                    if "range" in kinds:
                        self._executable(table, rel, size, plan, buf)
                    if "quantile" in kinds \
                            and spec.agg in ("sum", "count") \
                            and not spec.lsm:
                        self._executable(table, None, size, plan, buf,
                                         kind="quantile")
                size *= 2
        return self.stats.aot_compiles - before

    def pool_bytes(self) -> Optional[int]:
        """Bytes the allocator holds in this engine's graph pool (the
        segments tagged with its pool id), or None on a CPU session or
        where the allocator's snapshot does not tag segments by pool."""
        if not self.graphs:
            return None
        total, tagged = 0, False
        for seg in torch.cuda.memory_snapshot():
            pid = seg.get("segment_pool_id")
            if pid is None:
                continue
            tagged = True
            if tuple(pid) == tuple(self._pool):
                total += int(seg.get("total_size", 0))
        return total if tagged else None

    # -- writes: journal + background drain -------------------------------

    def insert(self, table: str, *args, wait: bool = False) -> None:
        """Stage new records; ``wait=True`` blocks until they are
        query-visible (folded into the table's delta buffer)."""
        self._stage_write(table, "insert", args, wait)

    def delete(self, table: str, *args, wait: bool = True) -> None:
        """Stage delete tombstones.  Default ``wait=True`` so a bad key
        (``KeyError``: no live occurrence) surfaces to the caller;
        ``wait=False`` defers the error to the next ``flush``."""
        self._stage_write(table, "delete", args, wait)

    def _stage_write(self, table: str, kind: str, args: Tuple,
                     wait: bool) -> None:
        if self._shut_down:
            raise RuntimeError("serving engine shut down")
        cols = self._norm_update(table, kind, args)
        item = _WriteItem(table, kind, cols, len(cols[0]))
        with self._staging_cv:
            self._journal.append(item)
            self._staging_cv.notify()
        with self._stats_lock:
            self._stats.staged_records += item.n
        if wait:
            if self._updater is None:   # no updater running: apply inline
                self._drain_once()
            item.future.result()

    def _norm_update(self, table: str, kind: str, args: Tuple) -> Tuple:
        """Host-normalize update args so same-(table, op) runs concat
        columnwise: every column rank-1 float64 of equal length."""
        spec = self.session.spec(table)
        if not spec.dynamic:
            raise RuntimeError(f"table {table!r} is static; fit it with "
                               "TableSpec(dynamic=True) to take updates")
        want = (1 if spec.agg in ("sum", "count", "max", "min")
                else 2) if kind == "delete" else (
            1 if spec.agg == "count" else
            2 if spec.agg in ("sum", "max", "min", "count2d") else 3)
        arrs = [np.atleast_1d(np.asarray(a, np.float64)) for a in args]
        if spec.agg == "count" and kind == "insert" and len(arrs) == 2:
            arrs = arrs[:1]          # engine forces unit measures anyway
        if len(arrs) != want:
            raise ValueError(f"{kind} on {table!r} ({spec.agg}) takes "
                             f"{want} array argument(s), got {len(args)}")
        base = arrs[0].shape
        return tuple(np.broadcast_to(a, base).astype(np.float64, copy=True)
                     for a in arrs)

    def drain_updates(self) -> None:
        """Block until every staged update is applied, then surface the
        oldest deferred write error (one per call, submission order).
        After shutdown this only surfaces deferred errors."""
        self._drain_updates(raise_errors=True)

    def _drain_updates(self, *, raise_errors: bool) -> None:
        if self._shut_down:
            if raise_errors:
                self._raise_update_error()
            return
        barrier = _WriteItem(None, "barrier", (), 0)
        with self._staging_cv:
            self._journal.append(barrier)
            self._staging_cv.notify()
        if self._updater is None or (not self._updater.is_alive()
                                     and self._supervisor is None):
            self._drain_once()
        barrier.future.result()
        if raise_errors:
            self._raise_update_error()

    def flush(self, table: Optional[str] = None) -> None:
        """Drain staging, then merge the tables' delta buffers into fresh
        plans (the cache stages the incoming plans' graphs on the swap)."""
        self.drain_updates()
        self.session.flush(table)

    def _raise_update_error(self) -> None:
        if self._update_errors:
            raise self._update_errors.pop(0)

    def _updater_run(self, replaying: bool) -> None:
        if replaying:
            with self._staging_cv:
                n = len([it for it in self._journal.pending()
                         if it.kind != "barrier"])
            if n:
                with self._stats_lock:
                    self._stats.journal_replayed += n
        try:
            self._updater_loop()
        except BaseException:
            # un-applied suffix stays in the journal; the supervisor's
            # replacement updater replays exactly that
            with self._stats_lock:
                self._stats.updater_crashes += 1
        finally:
            self.monitor.forget("updater")

    def _updater_loop(self) -> None:
        while True:
            self.monitor.beat("updater")
            with self._staging_cv:
                while not self._journal.pending() and not self._stop.is_set():
                    self._staging_cv.wait(timeout=0.1)
            if not self._drain_once() and self._stop.is_set():
                return

    def _drain_once(self) -> bool:
        """Apply the journal's current un-applied suffix; True if any.

        Serialized by ``_drain_lock`` (an inline drain must not race a
        restarting updater into double-applying).  Items are applied in
        sequence order and marked applied chunk by chunk, so an injected
        crash between applies leaves exactly the un-applied suffix for
        replay.
        """
        with self._drain_lock:
            with self._staging_cv:
                items = self._journal.pending()
            if not items:
                return False
            # coalesce consecutive same-(table, op) runs; per-table order
            # is global order restricted to the table, so victim
            # resolution and read-your-writes see writes in submission
            # order
            runs: List[List[_WriteItem]] = []
            for it in items:
                if (runs and it.kind != "barrier"
                        and runs[-1][0].kind == it.kind
                        and runs[-1][0].table == it.table):
                    runs[-1].append(it)
                else:
                    runs.append([it])
            applies = 0
            for run in runs:
                head = run[0]
                if head.kind == "barrier":
                    with self._staging_cv:
                        self._journal.mark_applied(head.seq)
                    head.future.set_result(None)
                    continue
                try:
                    applies += self._apply_run(head.table, head.kind, run)
                except self._crash_exc:
                    # injected crash: leave the un-applied suffix in the
                    # journal and die through _updater_run
                    with self._stats_lock:
                        self._stats.drains += 1
                        self._stats.fused_applies += applies
                    raise
                except BaseException as e:
                    # permanent engine error: consume the run, defer the
                    # error (submission order) and fail its futures
                    self._update_errors.append(e)
                    with self._staging_cv:
                        for it in run:
                            self._journal.mark_applied(it.seq)
                    for it in run:
                        if not it.future.done():
                            it.future.set_exception(e)
                    continue
            with self._stats_lock:
                self._stats.drains += 1
                self._stats.fused_applies += applies
            return True

    def _apply_run(self, table: str, kind: str,
                   run: List[_WriteItem]) -> int:
        """Apply one same-(table, op) run in capacity-sized, item-aligned
        chunks; each item is marked applied (and its future resolved)
        only after the call covering it lands."""
        cap = self.session.spec(table).capacity
        op = self.session.insert if kind == "insert" else self.session.delete
        applies = 0
        pack: List[_WriteItem] = []
        pack_n = 0

        def flush_pack() -> int:
            nonlocal pack, pack_n
            if not pack:
                return 0
            # chaos site: a crash here is *between* applies — the journal
            # watermark sits exactly at the last applied item
            self._maybe_fail("serve.updater")
            cols = (pack[0].args if len(pack) == 1 else
                    tuple(np.concatenate([it.args[j] for it in pack])
                          for j in range(len(pack[0].args))))
            n = len(cols[0])
            calls = 0
            for lo in range(0, n, cap):
                op(table, *(c[lo:lo + cap] for c in cols))
                calls += 1
            with self._staging_cv:
                for it in pack:
                    self._journal.mark_applied(it.seq)
            for it in pack:
                if not it.future.done():
                    it.future.set_result(None)
            pack, pack_n = [], 0
            return calls

        for it in run:
            if pack and pack_n + it.n > cap:
                applies += flush_pack()
            pack.append(it)
            pack_n += it.n
        applies += flush_pack()
        return applies

    # -- introspection ----------------------------------------------------

    @property
    def stats(self) -> EngineStats:
        with self._stats_lock:
            return dataclasses.replace(self._stats)

    @property
    def queue_depth(self) -> int:
        return self._queue.qsize()

    @property
    def staged_depth(self) -> int:
        with self._staging_cv:
            return self._journal.depth()

    def staleness(self, table: str) -> int:
        """Acknowledged-but-unapplied update records for ``table`` —
        the per-answer degradation signal while the updater is down."""
        with self._staging_cv:
            return self._journal.depth(table)

    def cache_keys(self) -> Tuple[Tuple, ...]:
        return tuple(sorted(self._cache, key=repr))
