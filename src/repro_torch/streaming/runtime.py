"""Real threaded mini-runtime (paper §5 / Appendix A, shared-memory design).

Executes a :class:`StreamingApp` for real on the host CPU.  Every replica —
spout or task — is one :class:`Executor` thread sharing a single emit path:
tuples are numpy batches passed *by reference* through bounded queues
(backpressure via blocking put) and accumulated into **jumbo tuples** — one
queue insertion per ``batch`` tuples with a single shared header (timestamp),
amortising queue overhead exactly as §5.2 describes.  ``jumbo=False``
degrades to per-tuple insertion for the Fig. 16 factor analysis.

All partitioning decisions go through compiled :class:`~.routing.Route`
objects (see :mod:`repro_torch.streaming.routing`) — the same tables the planner
and the DES consume — so there is no strategy branching here.  The hot path
is batch-vectorized: keyed splits are one argsort/bincount per batch and
jumbo accumulation copies rows into preallocated buffers instead of
list-append-then-concatenate.

This runtime validates streaming *semantics* (WC really counts words); the
NUMA placement effects are exercised through the simulator instead (this
container has a single socket — see DESIGN.md §6).
"""
from __future__ import annotations

import collections
import dataclasses
import math
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .apps import StreamingApp
from .checkpoint import Checkpoint, CheckpointCoordinator
from .routing import (BarrierAligner, Route, WatermarkMerger, compile_routes,
                      extract_event_times, validate_operator_names)
from .state import (EventTimeWindowState, OperatorState, make_operator_state,
                    restore_state, state_payload)

_POISON = object()


class _Watermark:
    """In-band low-watermark message: ``lane`` is the producer executor's
    unique name (one merge lane per producer replica)."""

    __slots__ = ("lane", "value")

    def __init__(self, lane: str, value: float):
        self.lane = lane
        self.value = value


class _Barrier:
    """In-band checkpoint barrier: the second kind of mark.

    Rides exactly the lanes a watermark rides (``Route.watermark_lanes``,
    in-band tagged ring slots across processes), but consumers *align*
    instead of min-merging: state snapshots only once barrier ``ckpt_id``
    has arrived on every producer lane — see
    :class:`~.routing.BarrierAligner`.
    """

    __slots__ = ("lane", "ckpt_id")

    def __init__(self, lane: str, ckpt_id: int):
        self.lane = lane
        self.ckpt_id = ckpt_id


@dataclasses.dataclass
class RuntimeResult:
    duration: float
    sink_tuples: int
    spout_tuples: int
    throughput: float               # sink tuples/sec
    latency_p50: float
    latency_p99: float
    states: Dict[str, List[dict]]   # per-operator replica OperatorStates
    # (dict-compatible; .managed holds declared KeyedStore/BroadcastTable/
    #  ValueStore instances — see repro_torch.streaming.state)
    late_drops: int = 0             # event-time tuples past their last pane
    panes_fired: int = 0            # event-time panes emitted
    #: per-spout-replica emitted batch counters ("spout#0" -> batches ever
    #: emitted, including any initial_offsets base).  Feed them back as
    #: ``run_app(initial_offsets=)`` and the resumed run continues the
    #: deterministic source sequence exactly where this one stopped.
    spout_offsets: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: completed aligned checkpoints, in id order (empty unless the run had
    #: ``checkpoint_every`` set).  Each is a
    #: :class:`repro_torch.streaming.checkpoint.Checkpoint` — feed one back as
    #: ``run_app(from_checkpoint=)`` to resume from that cut.
    checkpoints: List[Checkpoint] = dataclasses.field(default_factory=list)
    #: per-replica runtime counters, keyed by executor uid ("op#i"):
    #: ``batches`` / ``tuples_in`` processed, ``tuples_out`` enqueued
    #: (summed over output streams), ``queue_wait_s`` blocked on the input
    #: queue, ``kernel_s`` inside the operator kernel.  Fused chain members
    #: report under their own uids (queue wait lands on the chain head).
    #: Fusion wins — and placement decisions — are measurable from a run
    #: instead of only from the bench harness.
    exec_stats: Dict[str, dict] = dataclasses.field(default_factory=dict)


class _Lease:
    """Reference count over one pooled arena buffer.

    Every queue item built from a pooled buffer carries the lease with a
    reference already counted for it; the consumer releases after fully
    processing the item, and the buffer returns to its arena's free list
    when the last reference drops.  ``retain``/``release`` are cross-thread
    (producer flushes, consumers release), hence the lock — one lock
    operation per *jumbo*, not per tuple.
    """

    __slots__ = ("buf", "_arena", "_rc", "_lock")

    def __init__(self, buf: np.ndarray, arena: "_Arena"):
        self.buf = buf
        self._arena = arena
        self._rc = 1
        self._lock = threading.Lock()

    def retain(self, n: int = 1) -> None:
        with self._lock:
            self._rc += n

    def release(self) -> None:
        with self._lock:
            self._rc -= 1
            free = self._rc == 0
        if free:
            self._arena.recycle(self.buf)


class _Arena:
    """Pool of fixed-cap jumbo row buffers, shared by one output port.

    ``acquire`` hands out a ``(cap, *row_shape)`` buffer plus its
    :class:`_Lease`; ``recycle`` (called by the last ``release``) returns
    it to the free list, so steady-state flushing reuses a small warm set
    of buffers instead of allocating one per flush and copying on every
    hand-off.  Buffers whose shape/dtype no longer match, or beyond the
    pool bound, are simply dropped to the garbage collector.

    ``outstanding_total()`` counts leased-out buffers across every arena
    (acquire +1, last release -1): a drained run — even one that died on a
    kernel exception — must return it to its pre-run baseline, or a lease
    leaked (the regression the per-item release guards exist to prevent).
    """

    __slots__ = ("cap", "max_pooled", "_free", "_lock")

    _outstanding = 0                       # leased-out buffers, all arenas
    _class_lock = threading.Lock()

    def __init__(self, cap: int, max_pooled: int = 8):
        self.cap = cap
        self.max_pooled = max_pooled
        self._free: List[np.ndarray] = []
        self._lock = threading.Lock()

    @classmethod
    def outstanding_total(cls) -> int:
        with cls._class_lock:
            return cls._outstanding

    def acquire(self, row_shape: Tuple[int, ...],
                dtype: np.dtype) -> Tuple[np.ndarray, _Lease]:
        with _Arena._class_lock:
            _Arena._outstanding += 1
        with self._lock:
            for i in range(len(self._free) - 1, -1, -1):
                buf = self._free[i]
                if buf.shape[1:] == row_shape and buf.dtype == dtype:
                    del self._free[i]
                    return buf, _Lease(buf, self)
        buf = np.empty((self.cap,) + tuple(row_shape), dtype)
        return buf, _Lease(buf, self)

    def recycle(self, buf: np.ndarray) -> None:
        with _Arena._class_lock:
            _Arena._outstanding -= 1
        with self._lock:
            if len(self._free) < self.max_pooled:
                self._free.append(buf)


#: a flushed jumbo: (rows, oldest-buffered t0, lease or None).  A non-None
#: lease already counts the reference this item hands its consumer.
_Flush = Tuple[np.ndarray, float, Optional[_Lease]]


class _JumboBuffer:
    """Pooled jumbo accumulator for one (stream, consumer-replica) lane.

    Rows are copied in place into an arena-acquired ``cap``-row store — no
    per-emit list append + concatenate — and ``add`` hands back full
    jumbos.  Flushes are **views** into the pooled store (read-only, with
    the store's refcount lease attached) instead of the former
    copy-on-flush: the consumer reads the view and releases the lease, at
    which point the buffer recycles.  The flush timestamp is the *oldest*
    buffered tuple's, so end-to-end latency accounting matches the seed
    runtime.  A whole batch that already fills a jumbo passes through
    untouched (zero copies), which keeps the common selectivity-one
    shuffle path as cheap as before.  Flush boundaries are byte-identical
    to the copying implementation (the overflow case still concatenates,
    preserving jumbo sizes exactly — boundary changes would alter stateful
    kernels' running outputs).
    """

    __slots__ = ("cap", "arena", "_store", "_lease", "_n", "_t0")

    def __init__(self, cap: int, arena: Optional[_Arena] = None):
        self.cap = cap
        self.arena = arena if arena is not None else _Arena(cap)
        self._store: Optional[np.ndarray] = None
        self._lease: Optional[_Lease] = None
        self._n = 0
        self._t0 = 0.0

    def _flush(self) -> _Flush:
        """Hand the filled prefix to a consumer: a read-only view carrying
        the store's lease (ownership transfers — the filler stops using
        this buffer and acquires a fresh one on the next partial add)."""
        view = self._store[: self._n]
        view.flags.writeable = False
        lease, self._lease = self._lease, None
        self._store = None
        self._n = 0
        return view, self._t0, lease

    def add(self, arr: np.ndarray, t0: float) -> List[_Flush]:
        """Buffer ``arr``; return the jumbos (if any) now ready to flush."""
        out: List[_Flush] = []
        store = self._store
        if self._n and (store.shape[1:] != arr.shape[1:]
                        or store.dtype != arr.dtype):
            # the stream changed row shape mid-lane: flush what we have
            out.append(self._flush())
            store = None
        if self._n == 0 and len(arr) >= self.cap:
            out.append((arr, t0, None))                # zero-copy fast path
            return out
        if store is None or store.shape[1:] != arr.shape[1:] \
                or store.dtype != arr.dtype:
            if self._lease is not None:    # empty store of the wrong shape
                self._lease.release()
            self._store, self._lease = self.arena.acquire(arr.shape[1:],
                                                          arr.dtype)
            store = self._store
        if self._n == 0:
            self._t0 = t0
        end = self._n + len(arr)
        if end > self.cap:
            # rare overflow: concatenate so the jumbo boundary lands where
            # it always did (a fresh array — no lease)
            out.append((np.concatenate([store[: self._n], arr]),
                        self._t0, None))
            self._n = 0
        elif end == self.cap:
            store[self._n:end] = arr
            self._n = end
            out.append(self._flush())
        else:
            store[self._n:end] = arr
            self._n = end
        return out

    def drain(self) -> Optional[_Flush]:
        if self._n == 0:
            return None
        return self._flush()


class _OutPort:
    """One output stream of an executor: a bound route plus the consumer
    replica queues and their jumbo lanes.

    All lanes share one :class:`_Arena` (their rows have one shape/dtype
    per stream, so recycled buffers rotate across lanes).  A broadcast
    route collapses to a **single shared lane buffer**: every consumer
    replica receives every tuple, so the lanes fill in lockstep and one
    flush view — refcounted once per lane — replaces the former
    one-accumulated-copy-per-consumer."""

    __slots__ = ("route", "queues", "buffers", "delivered", "shared_flush")

    def __init__(self, route: Route, queues: List[queue.Queue], batch: int):
        self.route = route
        self.queues = queues
        self.shared_flush = route.is_broadcast and len(queues) > 1
        arena = _Arena(batch)
        n_buffers = 1 if self.shared_flush else len(queues)
        self.buffers = [_JumboBuffer(batch, arena) for _ in range(n_buffers)]
        self.delivered = [0] * len(queues)   # tuples enqueued, per lane

    def tuples_entered(self) -> int:
        return self.route.tuples_entered(self.delivered)


class Executor(threading.Thread):
    """One replica of any operator — spout or task (the paper's "executor").

    Spouts generate input with ``source``; tasks pull jumbos from ``in_q``.
    Both emit through the same path: ``Route.split`` assigns tuples to
    consumer replicas and per-lane jumbo buffers amortise queue insertions,
    for per-tuple (``jumbo=False``) and jumbo modes alike.
    """

    def __init__(self, name: str, ports: List[_OutPort], batch: int,
                 jumbo: bool, state: dict, *,
                 kernel: Optional[Callable] = None,
                 in_q: Optional[queue.Queue] = None,
                 expected_poisons: int = 0,
                 source: Optional[Callable] = None,
                 stop: Optional[threading.Event] = None,
                 seed: int = 0,
                 lat_sink: Optional[List[float]] = None,
                 on_delivered: Optional[Callable[[int], None]] = None,
                 max_batches: Optional[int] = None,
                 event_time=None,
                 wm_every: int = 1,
                 wm_interval: Optional[float] = None,
                 device_depth: int = 0,
                 start_batch: int = 0,
                 ckpt: Optional[CheckpointCoordinator] = None,
                 final_watermark: bool = True,
                 initial_aux: Optional[dict] = None):
        super().__init__(daemon=True, name=name)
        # the merge-lane identity this executor stamps on everything it
        # emits (marks, barriers, checkpoint-tagged data items).  Equal to
        # the executor name except for fused chains, which emit as their
        # *tail* member — downstream lane bookkeeping is identical to the
        # unfused plan's.
        self.lane = name
        self.ports = ports
        self.batch = batch
        self.jumbo = jumbo
        self.state = state
        self.kernel = kernel
        self.in_q = in_q
        self.expected_poisons = expected_poisons
        self.source = source
        self.stop_event = stop
        self.seed = seed
        self.lat_sink = lat_sink
        self.on_delivered = on_delivered
        self.max_batches = max_batches
        # event-time plumbing: spouts with a declared extractor emit
        # low-watermarks; tasks min-merge them per producer lane and fire
        # event-time window panes on passage.  wm_every / wm_interval are
        # the spout's declared cadence (every N batches / every T event-
        # time units of advance) — marks amortize jumbo flushes, the
        # end-of-stream +inf mark still flushes everything
        self.event_time = event_time
        self.wm_every = wm_every
        self.wm_interval = wm_interval
        self._wm = -math.inf
        self._wm_sent = -math.inf
        self._wm_batches = 0
        self._wm_merge = WatermarkMerger(max(expected_poisons, 1))
        self._wm_fwd = -math.inf
        # single-lane fast path: with exactly one producer lane the merged
        # watermark IS the lane's value — skip the min-merge bookkeeping
        # (LR's dispatcher edge and every fused chain's inbound edge)
        self._single_lane = source is None and max(expected_poisons, 1) == 1
        self._wm_lane: Optional[str] = None
        self._stats = {"batches": 0, "tuples_in": 0, "tuples_out": 0,
                       "queue_wait_s": 0.0, "kernel_s": 0.0}
        win = getattr(state, "window", None)
        self._et_win = win if isinstance(win, EventTimeWindowState) else None
        # device operator: the kernel is an async (jitted) computation and
        # up to device_depth results stay in flight before the oldest is
        # materialized + dispatched (0 = host op, 1 = device but synchronous)
        self.device_depth = device_depth
        if device_depth and self._et_win is not None:
            raise ValueError(
                f"{name}: device operators cannot drive event-time window "
                "panes (v1 exclusion — see Topology.op(device=))")
        self._inflight: collections.deque = collections.deque()
        # spout resume point: the source sequence continues at this batch
        # index (seeds seed+start_batch ..), making a resumed duration run
        # a prefix-continuation of the original
        self.start_batch = start_batch
        self.emitted_batches = start_batch
        # checkpointing: spouts inject numbered barriers every
        # ckpt.every batches; tasks align them per producer lane and
        # snapshot state at the aligned cut.  While a lane has aligned the
        # active round, its subsequent items are *held* (the Chandy-
        # Lamport discipline) — data items therefore carry their producer
        # lane as a 4th tuple element whenever checkpointing is on.
        self.ckpt = ckpt
        self.final_watermark = final_watermark
        self._aligner = BarrierAligner(max(expected_poisons, 1)) \
            if ckpt is not None else None
        self._held: List[object] = []
        if initial_aux:
            self._apply_aux(initial_aux)

    def _apply_aux(self, aux: dict) -> None:
        """Install checkpointed watermark bookkeeping: spout mark cadence
        counters and the task-side merged-lane map + forwarded frontier.
        Without these a resumed run would re-merge lanes from -inf and
        advance the fired frontier on a different schedule than the
        uninterrupted run — same panes eventually, but a *different* late
        classification for tuples racing the frontier."""
        if "wm" in aux:
            self._wm = aux["wm"]
            self._wm_sent = aux["wm_sent"]
            self._wm_batches = aux["wm_batches"]
        if "wm_lanes" in aux:
            for lane, value in aux["wm_lanes"].items():
                self._wm_merge.update(lane, value)
                self._wm_lane = lane
            self._wm_fwd = aux["wm_fwd"]

    def _aux_payload(self) -> dict:
        if self.is_spout:
            return {"wm": self._wm, "wm_sent": self._wm_sent,
                    "wm_batches": self._wm_batches}
        if self._single_lane:
            # the lane frontier equals the forwarded frontier (one lane,
            # monotone) — synthesize the map the merger would have held
            lanes = {} if self._wm_lane is None \
                else {self._wm_lane: self._wm_fwd}
            return {"wm_lanes": lanes, "wm_fwd": self._wm_fwd}
        return {"wm_lanes": dict(self._wm_merge._lanes),
                "wm_fwd": self._wm_fwd}

    def stats_payload(self) -> Dict[str, dict]:
        """Per-uid runtime counters for :attr:`RuntimeResult.exec_stats`.
        ``tuples_out`` counts tuples entering each output stream, summed
        over streams (fan-out counts once per stream, like the routes)."""
        s = dict(self._stats)
        s["tuples_out"] = int(sum(p.tuples_entered() for p in self.ports))
        return {self.name: s}

    @property
    def is_spout(self) -> bool:
        return self.source is not None

    def run(self):
        if self.is_spout:
            self._run_spout()
        else:
            self._run_task()

    def _run_spout(self):
        b = self.start_batch
        while not self.stop_event.is_set() and \
                (self.max_batches is None or
                 b - self.start_batch < self.max_batches):
            tk = time.perf_counter()
            arr = self.source(self.batch, self.seed + b)
            t0 = time.perf_counter()
            self._stats["kernel_s"] += t0 - tk
            self._stats["batches"] += 1
            b += 1
            self.emitted_batches = b
            # logical fan-out: every output stream carries the same batch
            self._dispatch([arr] * len(self.ports), t0)
            if self.event_time is not None and len(arr):
                ets = extract_event_times(arr, self.event_time)
                self._wm = max(self._wm, float(ets.max()))
                self._wm_batches += 1
                if self.wm_interval is not None:
                    due = self._wm - self._wm_sent >= self.wm_interval \
                        or math.isinf(self._wm_sent)
                else:
                    due = self._wm_batches >= self.wm_every
                if due and self._wm > self._wm_sent:
                    self._wm_sent = self._wm
                    self._wm_batches = 0
                    self._emit_watermark(self._wm)
            if self.ckpt is not None and b % self.ckpt.every == 0:
                self._emit_barrier(b)
        self._drain()
        if self.event_time is not None and self.final_watermark:
            # end of stream: +inf flushes every buffered pane downstream.
            # final_watermark=False suspends instead: pane buffers stay
            # resident for migrate_states / a later resume (the +inf mark
            # would close the frontier and leave nothing to carry)
            self._emit_watermark(math.inf)
        if self.on_delivered is not None:
            # tuples that entered the dataflow: max over streams — fan-out
            # duplicates tuples, it does not multiply them — and only what
            # was actually enqueued (stop can interrupt a keyed delivery
            # between partitions).  Counted before the blocking poison puts
            # so a stalled consumer cannot zero the tally.
            self.on_delivered(max((p.tuples_entered() for p in self.ports),
                                  default=0))
        self._poison()

    def _run_task(self):
        try:
            self._task_loop()
        except BaseException:
            # the executor is dying (a kernel raised mid-batch): release
            # every in-flight device lease so the pooled buffers recycle —
            # the exception path must not strand arena buffers
            self._release_inflight()
            raise

    def _release_inflight(self) -> None:
        while self._inflight:
            _, _, lease = self._inflight.popleft()
            if lease is not None:
                lease.release()

    def _lane_of(self, item) -> Optional[str]:
        """Producer lane of an in-band item, when it carries one: marks
        and barriers always do; data items only when checkpointing tagged
        them (4-tuples).  Poisons never — they are not held back (FIFO per
        lane puts a lane's barrier before its poison, so alignment cannot
        be waiting on a poisoned lane's barrier)."""
        if isinstance(item, (_Watermark, _Barrier)):
            return item.lane
        if type(item) is tuple and len(item) == 4:
            return item[3]
        return None

    def _run_task_loop_item(self, item) -> None:
        lane = self._lane_of(item)
        if self._aligner is not None and lane is not None \
                and self._aligner.holding(lane):
            self._held.append(item)      # post-barrier: wait for the cut
            return
        if isinstance(item, _Barrier):
            self._on_barrier(item)
            return
        self._handle(item)

    def _task_loop(self):
        poisons = 0
        while True:
            tw = time.perf_counter()
            item = self.in_q.get()
            self._stats["queue_wait_s"] += time.perf_counter() - tw
            if item is _POISON:
                poisons += 1
                if poisons < self.expected_poisons:
                    continue         # wait for every producer replica to end
                self._flush_held()   # abandoned barrier round at stream end
                self._shutdown()
                return
            self._run_task_loop_item(item)

    def _call_kernel(self, arr, state):
        tk = time.perf_counter()
        try:
            return self.kernel(arr, state)
        finally:
            self._stats["kernel_s"] += time.perf_counter() - tk

    def _handle(self, item) -> None:
        if isinstance(item, _Watermark):
            self._on_watermark(item)
            return
        arr, t0, lease = item[0], item[1], item[2]
        self._stats["batches"] += 1
        self._stats["tuples_in"] += len(arr)
        if self.lat_sink is not None:
            self.lat_sink.append(time.perf_counter() - t0)
        if self._et_win is not None:
            # event-time windowed operator: arriving batches only fill
            # the buffer; the kernel runs per fired pane on watermark
            # passage (complete panes in, whatever the batch cut was).
            # The window retains rows past this item's release point,
            # so a pooled view is privatized first (the only consumer
            # that holds input rows beyond the batch boundary).
            if lease is not None:
                arr = arr.copy()
                lease.release()
            self._et_win.insert(arr, t0)
            return
        if self.device_depth:
            # async device dispatch: enqueue the (lazy) kernel result
            # and only materialize the oldest once the bounded window
            # is full — host-side route/split/emit of batch N overlaps
            # the device computing batch N+1.  The input lease is held
            # until retirement so the pooled buffer cannot recycle
            # while the device may still read it.
            try:
                lazy = self._call_kernel(arr, self.state)
            except BaseException:
                if lease is not None:
                    lease.release()
                raise
            self._inflight.append((lazy, t0, lease))
            while len(self._inflight) >= self.device_depth:
                self._retire_one()
            return
        try:
            self._dispatch(self._call_kernel(arr, self.state), t0, lease)
        finally:
            if lease is not None:
                lease.release()

    # -- checkpoint barriers ----------------------------------------------
    def _emit_barrier(self, b: int) -> None:
        """Spout side of a checkpoint: retire offset ``b`` into the
        snapshot (every emitted batch is flushed first — drain-on-snapshot,
        so the recorded offset never includes a batch whose rows are still
        buffered on this side of the cut) and forward the numbered barrier
        on every lane a watermark would ride."""
        ckpt_id = b // self.ckpt.every
        self._drain()
        self.ckpt.deposit(
            ckpt_id, self.name,
            payload=state_payload(self.state, copy=True),
            aux=self._aux_payload(), offset=b)
        for port in self.ports:
            for j in port.route.watermark_lanes():
                self._put_wm(port.queues[j], _Barrier(self.lane, ckpt_id))

    def _on_barrier(self, msg: _Barrier) -> None:
        """Align one lane's barrier; on the last lane, cut.

        The cut: retire the whole device dispatch window (in-flight lazy
        results belong before the barrier), deposit a deep-copied state
        payload, forward the barrier downstream (after draining buffered
        jumbos, which logically precede it), then re-process the items
        held back during alignment — a held barrier can immediately open
        (or even complete) the next round, re-holding its lane, so this
        loops until no held item is processable."""
        if not self._aligner.arrive(msg.lane, msg.ckpt_id):
            return
        self._cut(msg.ckpt_id)
        while self._held:
            pending, self._held = self._held, []
            progressed = False
            for item in pending:
                lane = self._lane_of(item)
                if lane is not None and self._aligner.holding(lane):
                    self._held.append(item)
                    continue
                progressed = True
                if isinstance(item, _Barrier):
                    if self._aligner.arrive(item.lane, item.ckpt_id):
                        self._cut(item.ckpt_id)
                else:
                    self._handle(item)
            if not progressed:
                return   # the rest waits on a still-incomplete round

    def _cut(self, ckpt_id: int) -> None:
        self._retire_all()
        self.ckpt.deposit(
            ckpt_id, self.name,
            payload=state_payload(self.state, copy=True),
            aux=self._aux_payload())
        self._drain()
        for port in self.ports:
            for j in port.route.watermark_lanes():
                self._put_wm(port.queues[j], _Barrier(self.lane, ckpt_id))

    def _flush_held(self) -> None:
        """End of stream with an incomplete barrier round (duration cut
        dropped a barrier, or the stream simply drained between barriers):
        the round can never complete, so abandon it — process the held
        data and marks in arrival order, dropping the orphaned barriers.
        Recovery only ever reads *completed* checkpoints, so an abandoned
        round is invisible to it."""
        if self._aligner is None or not self._held:
            return
        self._aligner.reset()
        held, self._held = self._held, []
        for item in held:
            if not isinstance(item, _Barrier):
                self._handle(item)

    def _retire_one(self) -> None:
        """Materialize + dispatch the oldest in-flight device result (FIFO
        — output order and watermark order are identical to the synchronous
        path by construction)."""
        outs, t0, lease = self._inflight.popleft()
        try:
            self._dispatch(
                [None if o is None else np.asarray(o) for o in outs],
                t0, lease)
        finally:
            if lease is not None:
                lease.release()

    def _retire_all(self) -> None:
        while self._inflight:
            self._retire_one()

    def _merged_watermark(self, msg: _Watermark) -> float:
        """Merged frontier after one lane's mark.  With a single producer
        lane the merged value IS the lane's value (regressions are caught
        by the caller's frontier check), so the min-merge bookkeeping is
        skipped entirely."""
        if self._single_lane:
            self._wm_lane = msg.lane
            return msg.value
        return self._wm_merge.update(msg.lane, msg.value)

    def _on_watermark(self, msg: _Watermark) -> None:
        """Merge one lane's watermark; on advance, fire panes and forward.

        The merged watermark is min over producer lanes (monotone per lane,
        see :class:`~.routing.WatermarkMerger`).  Every pane the mark
        released arrives as **one** stacked :class:`~.state.PaneBatch`; a
        :func:`~.state.segmented` kernel runs once over it with
        ``state.segments`` set, an unmarked kernel is driven one segment
        slice at a time with ``state.pane`` set (the single-span compat
        shim over the same buffer).  Either way there is one batched
        dispatch per watermark, and the advanced watermark is forwarded
        along every compiled route *after* the panes it released."""
        # a mark trails the batches before it in queue order: retire every
        # in-flight device result first so outputs never follow their mark
        self._retire_all()
        merged = self._merged_watermark(msg)
        if not merged > self._wm_fwd:
            return
        self._wm_fwd = merged
        if self._et_win is not None:
            batch = self._et_win.on_watermark(merged)
            if batch.n:
                if getattr(self.kernel, "segmented", False):
                    self.state.segments = batch.segments
                    self.state.pane = batch.segments.span(0) \
                        if batch.n == 1 else None
                    try:
                        outs = self._call_kernel(batch.rows, self.state)
                    finally:
                        self.state.segments = None
                        self.state.pane = None
                    self._dispatch(outs, batch.t0)
                else:
                    acc: List[List[np.ndarray]] = [[] for _ in self.ports]
                    for rows, t0, span in batch:
                        self.state.pane = span
                        outs = self._call_kernel(rows, self.state)
                        if len(outs) != len(self.ports):
                            self._dispatch(outs, t0)  # raises the mismatch
                        for i, arr in enumerate(outs):
                            if arr is not None and len(arr):
                                acc[i].append(arr)
                    self.state.pane = None
                    self._dispatch(
                        [np.concatenate(a) if len(a) > 1 else
                         (a[0] if a else None) for a in acc], batch.t0)
        if self.ports:
            self._emit_watermark(merged)

    def _emit_watermark(self, value: float) -> None:
        """Flush buffered jumbos, then forward ``value`` on every lane of
        every output route (a watermark is a promise about the whole
        stream; buffered tuples logically precede it and must not be
        overtaken)."""
        self._drain()
        for port in self.ports:
            for j in port.route.watermark_lanes():
                self._put_wm(port.queues[j], _Watermark(self.lane, value))

    def _put_wm(self, q: queue.Queue, msg: _Watermark) -> None:
        if self.is_spout:                # interruptible put: stop wins
            while True:
                try:
                    q.put(msg, timeout=0.02)
                    return
                except queue.Full:
                    if self.stop_event.is_set():
                        # dropped: in duration mode tail panes may stay
                        # buffered (non-deterministic cut anyway);
                        # deterministic replay (max_batches) never drops —
                        # spouts finish their budget and block here freely
                        return
        q.put(msg)

    # -- the one emit path -------------------------------------------------
    def _dispatch(self, outs, t0: float,
                  lease: Optional[_Lease] = None) -> None:
        """Route kernel/spout outputs to consumer lanes.  ``lease`` is the
        *input* batch's pooled-buffer lease (None for fresh arrays): any
        enqueued array still sharing that buffer's memory — pass-through
        jumbos, kernel outputs that are views of the input — retains it so
        the buffer cannot recycle under a downstream reader."""
        if len(outs) != len(self.ports):
            raise ValueError(
                f"{self.name}: kernel returned {len(outs)} output streams "
                f"for {len(self.ports)} declared consumers")
        for port, arr in zip(self.ports, outs):
            if arr is None or len(arr) == 0:
                continue
            if port.shared_flush:        # broadcast: one flush, all lanes
                self._deliver_fanout(port, arr, t0, lease)
                continue
            for j, part in port.route.split(arr):
                self._deliver(port, j, part, t0, lease)

    def _passthrough_lease(self, port: _OutPort, jumbo: np.ndarray,
                           jlease: Optional[_Lease],
                           in_lease: Optional[_Lease]) -> Optional[_Lease]:
        """Lease for one enqueued jumbo: a flush's own lease (already
        counted), else the input's lease when the jumbo still aliases the
        input's pooled buffer (retained here, once per enqueue)."""
        if jlease is not None:
            return jlease
        if in_lease is not None and port.route.aliases_input() \
                and np.may_share_memory(jumbo, in_lease.buf):
            in_lease.retain()
            return in_lease
        return None

    def _deliver(self, port: _OutPort, j: int, part: np.ndarray,
                 t0: float, in_lease: Optional[_Lease] = None) -> None:
        if not self.jumbo:
            for row in part:             # per-tuple insertion (Fig. 16)
                self._put(port, j, np.asarray([row]), t0)
            return
        for jumbo, jt0, jlease in port.buffers[j].add(part, t0):
            self._put(port, j, jumbo, jt0,
                      self._passthrough_lease(port, jumbo, jlease, in_lease))

    def _deliver_fanout(self, port: _OutPort, arr: np.ndarray, t0: float,
                        in_lease: Optional[_Lease] = None) -> None:
        """Broadcast emit: accumulate once in the port's shared lane buffer
        and enqueue the *same* flush view on every lane, refcounted once
        per lane — no per-consumer copy is ever materialized."""
        k = len(port.queues)
        if not self.jumbo:
            for row in arr:
                row1 = np.asarray([row])
                for j in range(k):
                    self._put(port, j, row1, t0)
            return
        for jumbo, jt0, jlease in port.buffers[0].add(arr, t0):
            lease = self._passthrough_lease(port, jumbo, jlease, in_lease)
            if lease is not None:
                lease.retain(k - 1)      # one reference per lane
            for j in range(k):
                self._put(port, j, jumbo, jt0, lease)

    def _put(self, port: _OutPort, j: int, arr: np.ndarray,
             t0: float, lease: Optional[_Lease] = None) -> None:
        q = port.queues[j]
        # checkpointing lane-tags data items: a consumer's single FIFO
        # input interleaves producer lanes, and alignment must know which
        # lane each item came from to hold back post-barrier items
        item = (arr, t0, lease, self.lane) if self.ckpt is not None \
            else (arr, t0, lease)
        if self.is_spout:                # interruptible put: stop wins
            while True:
                try:
                    q.put(item, timeout=0.02)
                    break
                except queue.Full:
                    if self.stop_event.is_set():
                        if lease is not None:
                            lease.release()
                        return           # dropped, never counted
        else:                            # task: block (backpressure)
            q.put(item)
        if lease is not None and not getattr(q, "by_reference", True):
            # copying transports (shared-memory rings) consumed the bytes
            # synchronously inside put — the consumer process never sees
            # the lease, so this side retires its reference now
            lease.release()
        port.delivered[j] += len(arr)

    def _shutdown(self):
        self._retire_all()
        self._drain()
        self._poison()

    def _drain(self):
        # flush partially-filled jumbo lanes
        for port in self.ports:
            if port.shared_flush:
                out = port.buffers[0].drain()
                if out is not None:
                    jumbo, t0, lease = out
                    if lease is not None:
                        lease.retain(len(port.queues) - 1)
                    for j in range(len(port.queues)):
                        self._put(port, j, jumbo, t0, lease)
                continue
            for j, buf in enumerate(port.buffers):
                out = buf.drain()
                if out is not None:
                    self._put(port, j, *out)

    def _poison(self):
        # once per consumer queue per producer replica
        for port in self.ports:
            for q in port.queues:
                q.put(_POISON)


class _ChainBuffer:
    """Lease-free jumbo accumulator for one intra-chain hop of a fused
    executor.

    Replicates :class:`_JumboBuffer`'s flush-boundary semantics exactly —
    shape-change flush, whole-batch pass-through, overflow concatenate,
    oldest-tuple timestamp — because downstream kernel-call granularity
    *is* those boundaries, and stateful count-window kernels make them
    byte-parity-critical.  No arena/lease: flushed views feed the next
    member's kernel in the same thread, and a fresh store is allocated
    per fill cycle since the tail may pass a flushed view straight into
    an output queue where it lives arbitrarily long.
    """

    __slots__ = ("cap", "_store", "_n", "_t0")

    def __init__(self, cap: int):
        self.cap = cap
        self._store: Optional[np.ndarray] = None
        self._n = 0
        self._t0 = 0.0

    def _flush(self) -> Tuple[np.ndarray, float]:
        view = self._store[: self._n]
        view.flags.writeable = False
        self._store = None
        self._n = 0
        return view, self._t0

    def add(self, arr: np.ndarray, t0: float) -> List[Tuple[np.ndarray,
                                                            float]]:
        out: List[Tuple[np.ndarray, float]] = []
        store = self._store
        if self._n and (store.shape[1:] != arr.shape[1:]
                        or store.dtype != arr.dtype):
            out.append(self._flush())
            store = None
        if self._n == 0 and len(arr) >= self.cap:
            out.append((arr, t0))                      # pass-through
            return out
        if store is None or store.shape[1:] != arr.shape[1:] \
                or store.dtype != arr.dtype:
            self._store = store = np.empty((self.cap,) + arr.shape[1:],
                                           arr.dtype)
        if self._n == 0:
            self._t0 = t0
        end = self._n + len(arr)
        if end > self.cap:
            # overflow: concatenate so the boundary lands where the
            # unfused lane's would (the store stays for the next cycle —
            # its prefix was copied out)
            out.append((np.concatenate([store[: self._n], arr]), self._t0))
            self._n = 0
        elif end == self.cap:
            store[self._n:end] = arr
            self._n = end
            out.append(self._flush())
        else:
            store[self._n:end] = arr
            self._n = end
        return out

    def drain(self) -> Optional[Tuple[np.ndarray, float]]:
        if self._n == 0:
            return None
        return self._flush()


class _FusedMember:
    """One operator of a fused chain as one replica executes it."""

    __slots__ = ("op", "uid", "kernel", "state", "stats")

    def __init__(self, op: str, uid: str, kernel: Callable, state):
        self.op = op
        self.uid = uid
        self.kernel = kernel
        self.state = state
        self.stats = {"batches": 0, "tuples_in": 0, "tuples_out": 0,
                      "queue_wait_s": 0.0, "kernel_s": 0.0}


class FusedExecutor(Executor):
    """One replica of a fused operator chain (the tentpole of operator
    fusion, after Prasaad et al. 1803.11328).

    Member kernels run back-to-back on the same batch in one thread: no
    intermediate queue, no per-hop watermark min-merge (the head merges
    once; marks and checkpoint barriers traverse the chain inline), no
    arena lease per stage.  Inter-member jumbo boundaries are reproduced
    by :class:`_ChainBuffer` so every member sees byte-identical kernel
    calls to the unfused plan, and state handles stay per member — so
    ``migrate_states``, checkpoints and :class:`RuntimeResult`
    fingerprints are byte-identical to the unfused run.  The executor
    consumes as the head (its input queue, its expected poisons) and
    emits as the tail (``self.lane``), which keeps every downstream
    lane/poison count exactly what the unfused plan produced.
    """

    def __init__(self, chain: List[str], index: int, replicas: int,
                 ports: List[_OutPort], batch: int, jumbo: bool,
                 states: List[object], kernels: List[Callable], **kw):
        super().__init__(f"{chain[0]}#{index}", ports, batch, jumbo,
                         states[0], kernel=kernels[0], **kw)
        self.chain = list(chain)
        self._replicas = replicas      # uniform member parallelism
        self.members = [
            _FusedMember(op, f"{op}#{index}", kernels[j], states[j])
            for j, op in enumerate(chain)]
        self.lane = f"{chain[-1]}#{index}"
        self._accs = [_ChainBuffer(batch) for _ in chain[:-1]]
        # base-class counters (queue wait from _task_loop) land on the head
        self._stats = self.members[0].stats

    def stats_payload(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for j, m in enumerate(self.members):
            s = dict(m.stats)
            if j == len(self.members) - 1:
                s["tuples_out"] = int(sum(p.tuples_entered()
                                          for p in self.ports))
            out[m.uid] = s
        return out

    def _handle(self, item) -> None:
        if isinstance(item, _Watermark):
            self._on_watermark(item)
            return
        arr, t0, lease = item[0], item[1], item[2]
        try:
            self._feed(0, arr, t0, lease)
        finally:
            if lease is not None:
                lease.release()

    def _feed(self, j: int, arr: np.ndarray, t0: float,
              in_lease: Optional[_Lease]) -> None:
        """Run member ``j`` on one jumbo and push its output down the
        chain through the member's :class:`_ChainBuffer` (tail output
        goes out the normal dispatch path; ``in_lease`` rides along so a
        tail pass-through of the inbound pooled buffer still retains it).
        """
        m = self.members[j]
        m.stats["batches"] += 1
        m.stats["tuples_in"] += len(arr)
        last = j == len(self.members) - 1
        if last and self.lat_sink is not None:
            # sink receipt latency samples at the same jumbo boundaries
            # the unfused sink saw
            self.lat_sink.append(time.perf_counter() - t0)
        tk = time.perf_counter()
        try:
            outs = m.kernel(arr, m.state)
        finally:
            m.stats["kernel_s"] += time.perf_counter() - tk
        if last:
            self._dispatch(outs, t0, in_lease)
            return
        if len(outs) != 1:
            raise ValueError(
                f"{self.name}: fused member {m.op!r} returned {len(outs)} "
                "output streams for its single intra-chain consumer")
        out = outs[0]
        if out is None or len(out) == 0:
            return
        m.stats["tuples_out"] += len(out)
        if not self.jumbo:
            for row in out:              # per-tuple mode (Fig. 16) parity
                self._feed(j + 1, np.asarray([row]), t0, in_lease)
            return
        for jum, jt0 in self._accs[j].add(out, t0):
            self._feed(j + 1, jum, jt0, in_lease)

    def _flush_chain(self) -> None:
        """Drain inter-member accumulators head-to-tail: member ``j``'s
        partial jumbo feeds ``j+1`` before ``j+1``'s own partial flushes —
        the same cascade order the unfused pipeline's per-hop drains
        produce at a mark/cut/stream-end.  Accumulator contents are always
        private copies, so no input lease is involved."""
        for j in range(1, len(self.members)):
            out = self._accs[j - 1].drain()
            if out is not None:
                self._feed(j, out[0], out[1], None)

    def _on_watermark(self, msg: _Watermark) -> None:
        """One merge at the head per mark (single-lane fast path applies
        when the head has one producer lane); on advance the chain's
        buffered rows flush member-to-member — they logically precede the
        mark, exactly like the unfused per-hop drains — before the tail
        forwards it.  Chains contain no device or event-time-window
        members by eligibility, so the base pane logic never applies."""
        merged = self._merged_watermark(msg)
        if not merged > self._wm_fwd:
            return
        self._wm_fwd = merged
        self._flush_chain()
        if self.ports:
            self._emit_watermark(merged)

    def _member_aux(self, j: int) -> dict:
        """Checkpoint aux for member ``j``: the head's is its real merge
        bookkeeping; downstream members' is synthesized exactly.  Marks
        ride every lane and each replica of member ``j-1`` forwards the
        same merged frontier, so at an aligned cut every inbound lane of
        member ``j`` sits precisely at this executor's forwarded
        frontier."""
        if j == 0:
            return self._aux_payload()
        fwd = self._wm_fwd
        if fwd == -math.inf:
            return {"wm_lanes": {}, "wm_fwd": fwd}
        prev = self.chain[j - 1]
        return {"wm_lanes": {f"{prev}#{r}": fwd
                             for r in range(self._replicas)},
                "wm_fwd": fwd}

    def _cut(self, ckpt_id: int) -> None:
        """Aligned snapshot through the chain: drain each hop's
        accumulator into the next member (buffered rows logically precede
        the barrier), deposit every member's state under its own uid —
        byte-identical to the unfused executors' deposits — then forward
        the barrier as the tail."""
        for j, m in enumerate(self.members):
            if j:
                out = self._accs[j - 1].drain()
                if out is not None:
                    self._feed(j, out[0], out[1], None)
            self.ckpt.deposit(
                ckpt_id, m.uid,
                payload=state_payload(m.state, copy=True),
                aux=self._member_aux(j))
        self._drain()
        for port in self.ports:
            for jj in port.route.watermark_lanes():
                self._put_wm(port.queues[jj], _Barrier(self.lane, ckpt_id))

    def _shutdown(self):
        self._flush_chain()
        self._drain()
        self._poison()


WM_TARGET_PANES = 128   # adaptive cadence: aim for this many released panes
# per watermark.  Derived from the declared window grid (panes per batch =
# batch * et_spacing / slide, times the probed (key, span) multiplicity for
# keyed pane groups) instead of a hand-calibrated constant: sd_et at the
# bench batch of 256 lands exactly on the previously calibrated 8 marks.


def upstream_spouts(graph, op: str) -> List[str]:
    """Spout operators upstream of ``op`` (inclusive if ``op`` is one)."""
    seen, frontier = set(), [op]
    while frontier:
        x = frontier.pop()
        if x in seen:
            continue
        seen.add(x)
        frontier.extend(graph.producers(x))
    return [s for s in graph.spouts() if s in seen]


def derive_watermark_every(app: StreamingApp, spout: str,
                           batch: int) -> int:
    """Resolve a spout's ``watermark_every="auto"`` declaration.

    Panes released per batch follow from the declared grid: ``batch *
    et_spacing / slide`` spans advance per batch, each multiplied by the
    probed per-span ``(key, span)`` multiplicity for keyed pane groups
    (:func:`~.simulator.probe_pane_keys`).  The cadence then targets
    :data:`WM_TARGET_PANES` panes per mark — enough panes to amortize the
    per-mark jumbo flush + merge + one stacked segmented fire, without the
    fire bursts outgrowing the pipeline's queue slack (the failure mode of
    over-coarse hand tunings).  Clamped to ``[1, 64]`` batches.
    """
    from .simulator import probe_et_spacing, probe_pane_keys
    spacing = probe_et_spacing(app, batch=batch).get(spout, 1.0)
    mult = probe_pane_keys(app, batch=batch)
    panes_per_batch = 0.0
    for op, w in app.time_windows().items():
        if spout not in upstream_spouts(app.graph, op):
            continue
        panes_per_batch += batch * spacing / w.slide * mult.get(op, 1.0)
    if panes_per_batch <= 0:
        return 1
    return int(max(1, min(64, round(WM_TARGET_PANES / panes_per_batch))))


@dataclasses.dataclass
class PreparedApp:
    """Construct phase of the executor lifecycle: everything ``run_app``
    derives *before* any thread (or worker process) starts — validated
    graph, compiled routes, per-replica states, resolved watermark
    cadences.  Backends (threads here, processes in
    :mod:`repro_torch.streaming.procexec`) share this one construct path and
    differ only in how they wire queues and run the executors."""

    lg: object                              # LogicalGraph
    parallelism: Dict[str, int]
    routes: object                          # RoutingTable
    states: Dict[str, List[OperatorState]]
    win_key_by: Dict[str, object]
    wm_every: Dict[str, int]                # resolved per-spout cadence
    #: fused chains (lists of member operator names) this run realizes:
    #: :func:`build_executors` compiles each into one
    #: :class:`FusedExecutor` per replica instead of per-member executors
    chains: List[List[str]] = dataclasses.field(default_factory=list)


def prepare_app(app: StreamingApp,
                parallelism: Optional[Dict[str, int]] = None,
                partition: Optional[Dict[str, str]] = None,
                initial_states: Optional[Dict[str, List[dict]]] = None,
                batch: int = 256, fuse=None) -> PreparedApp:
    """Validate + compile + build state: the serializable construct phase.

    Raises exactly what ``run_app`` raised inline before the split; the
    returned :class:`PreparedApp` feeds :func:`build_executors` in any
    backend.

    ``fuse`` selects operator fusion: ``None``/``"off"`` (no fusion),
    ``"auto"`` (fuse every maximal eligible chain — see
    :mod:`repro_torch.streaming.fusion`), or an explicit list of chains
    (lists of operator names).  Explicit chains are validated
    structurally; a chain realized with mismatched member parallelism is
    dropped, not an error — fusion is an optimization and a plan-derived
    chain may be invalidated by elastic rescaling."""
    lg = app.graph
    parallelism = dict(parallelism or {})
    validate_operator_names(lg, parallelism, "parallelism")
    for name in lg.operators:
        parallelism.setdefault(name, 1)
    routes = compile_routes(app, partition=partition)
    # event-time panes fire per replica from per-replica buffers: a
    # non-keyed split would scatter each pane's rows over replicas and
    # every replica would fire its own partial pane — reject instead of
    # silently aggregating subsets.  Keyed inputs give *sharded* panes;
    # with keyed pane groups (WindowSpec(keyed=True)) the pane unit is
    # (key, span), so replication preserves pane bytes exactly — that is
    # the lift of the PR 4 replication clamp for keyed time windows.
    win_key_by: Dict[str, object] = {}
    for name, sspec in (getattr(app, "state", None) or {}).items():
        if sspec.window is None or not sspec.window.time:
            continue
        strategies = {routes.strategy(u, name) for u in lg.producers(name)}
        if sspec.window.keyed:
            if strategies != {"key"}:
                raise ValueError(
                    f"operator {name!r} declares keyed event-time panes "
                    f"with {sorted(strategies)} input routing: pane groups "
                    "shard by the compiled keyed route, so every input "
                    "stream must be partition='key'")
            win_key_by[name] = routes.key_extractor(name)
        elif parallelism[name] > 1 and strategies != {"key"}:
            raise ValueError(
                f"operator {name!r} declares an event-time window at "
                f"parallelism {parallelism[name]} with "
                f"{sorted(strategies)} input routing: replicas would "
                "each fire partial panes over an arbitrary subset of "
                "rows. Key every input stream (sharded panes) or keep "
                "parallelism 1")

    states: Dict[str, List[OperatorState]] = {
        name: [make_operator_state(app.state.get(name), parallelism[name], j,
                                   key_by=win_key_by.get(name))
               for j in range(parallelism[name])]
        for name in lg.operators}
    if initial_states:
        validate_operator_names(lg, initial_states, "initial_states")
        for name, reps in initial_states.items():
            if len(reps) != parallelism[name]:
                raise ValueError(
                    f"initial_states[{name!r}] has {len(reps)} replica "
                    f"states for parallelism {parallelism[name]} "
                    "(migrate_states targets one replica set)")
            states[name] = list(reps)
        # keyed pane groups shard by the *current* compiled route: re-attach
        # the extractor to migrated window buffers (idempotent)
        for name, kb in win_key_by.items():
            for st in states[name]:
                win = getattr(st, "window", None)
                if isinstance(win, EventTimeWindowState):
                    win.key_by = kb

    wm_every: Dict[str, int] = {}
    declared = getattr(app, "watermark_every", None) or {}
    for name in lg.spouts():
        cadence = declared.get(name, 1)
        wm_every[name] = derive_watermark_every(app, name, batch) \
            if cadence == "auto" else cadence

    chains: List[List[str]] = []
    if fuse is not None and fuse != "off":
        from .fusion import detect_chains, validate_chains
        no_fuse = frozenset(getattr(app, "no_fuse", ()))
        tw = frozenset(app.time_windows())
        if fuse == "auto":
            chains = detect_chains(lg, routes, no_fuse=no_fuse,
                                   time_windows=tw, parallelism=parallelism)
        else:
            chains = validate_chains(lg, routes, fuse, no_fuse=no_fuse,
                                     time_windows=tw)
            chains = [c for c in chains
                      if len({parallelism[m] for m in c}) == 1]
    return PreparedApp(lg, parallelism, routes, states, win_key_by,
                       wm_every, chains)


def resolve_offsets(lg, parallelism: Dict[str, int],
                    initial_offsets: Optional[Dict[str, int]]
                    ) -> Dict[Tuple[str, int], int]:
    """Expand ``initial_offsets`` (spout operator names or replica uids
    like ``"spout#0"`` -> emitted-batch counter) to per-replica start
    batches, validating every key against the graph's spouts."""
    out: Dict[Tuple[str, int], int] = {}
    if not initial_offsets:
        return out
    spouts = set(lg.spouts())
    for key, off in initial_offsets.items():
        if isinstance(off, bool) or not isinstance(off, int) or off < 0:
            raise ValueError(
                f"initial_offsets[{key!r}] must be an int >= 0, got {off!r}")
        name, _, idx = key.partition("#")
        if name not in spouts:
            raise ValueError(
                f"initial_offsets names {key!r}, which is not a spout "
                f"(spouts: {sorted(spouts)})")
        if idx:
            i = int(idx)
            if not 0 <= i < parallelism[name]:
                raise ValueError(
                    f"initial_offsets names replica {key!r} but {name!r} "
                    f"has parallelism {parallelism[name]}")
            out[(name, i)] = off
        else:
            for i in range(parallelism[name]):
                out.setdefault((name, i), off)
    return out


def build_executors(app: StreamingApp, prep: PreparedApp, *, batch: int,
                    jumbo: bool, vectorized: Optional[bool], seed: int,
                    max_batches: Optional[int], stop, latencies: List[float],
                    add_spout_count: Callable[[int], None],
                    in_q_of: Callable, out_q_of: Callable,
                    only=None, dispatch_depth: Optional[int] = None,
                    initial_offsets: Optional[Dict[str, int]] = None,
                    coordinator: Optional[CheckpointCoordinator] = None,
                    final_watermark: bool = True,
                    initial_aux: Optional[Dict[Tuple[str, int], dict]] = None
                    ) -> Tuple[List[Executor], List[Executor]]:
    """Instantiate the executors of a prepared app (the run phase's cast).

    ``in_q_of(name, i)`` returns the input endpoint of a task replica;
    ``out_q_of(name, i, consumer)`` the list of per-consumer-replica output
    endpoints for one producer replica.  Endpoints only need the
    ``queue.Queue`` protocol the :class:`Executor` uses (``get``, blocking
    ``put``, ``put(timeout=)`` raising ``queue.Full``) — threads pass real
    queues, the process backend passes shared-memory rings.  ``only``
    restricts construction to a replica subset (one worker's share).

    ``dispatch_depth`` overrides every device operator's declared in-flight
    window (the sync-vs-async A/B flag); ``initial_offsets`` resumes spout
    replicas at recorded emitted-batch counters (see
    :func:`resolve_offsets`).

    ``coordinator`` enables aligned-barrier checkpointing (spouts inject
    barriers every ``coordinator.every`` batches, every executor deposits
    its aligned snapshot into it); ``initial_aux`` restores per-replica
    watermark bookkeeping from a checkpoint; ``final_watermark=False``
    suspends instead of draining — spouts skip the end-of-stream ``+inf``
    mark so event-time pane buffers stay resident for migration/resume.
    """
    lg, parallelism = prep.lg, prep.parallelism
    offsets = resolve_offsets(lg, parallelism, initial_offsets)
    aux = initial_aux or {}
    spouts: List[Executor] = []
    tasks: List[Executor] = []
    chain_of_head = {c[0]: c for c in prep.chains}
    fused_members = {m for c in prep.chains for m in c[1:]}
    for name, spec in lg.operators.items():
        if name in fused_members:
            continue                 # realized inside the head's executor
        chain = chain_of_head.get(name)
        if chain is not None:
            # one FusedExecutor per replica: consumes as the head, emits
            # as the tail — downstream queues/lanes/poison counts are
            # exactly the unfused plan's
            tail = chain[-1]
            is_sink = not lg.consumers(tail)
            n_producer_units = sum(parallelism[p]
                                   for p in lg.producers(name))
            for i in range(parallelism[name]):
                if only is not None and (name, i) not in only:
                    continue
                ports = [
                    _OutPort(prep.routes.route(tail, cop).bind(
                        parallelism[cop], vectorized=vectorized),
                        out_q_of(tail, i, cop), batch)
                    for cop in lg.consumers(tail)]
                tasks.append(FusedExecutor(
                    chain, i, parallelism[name], ports, batch, jumbo,
                    [prep.states[m][i] for m in chain],
                    [app.kernels[m] for m in chain],
                    in_q=in_q_of(name, i),
                    expected_poisons=max(n_producer_units, 1),
                    lat_sink=latencies if is_sink else None,
                    ckpt=coordinator, initial_aux=aux.get((name, i))))
            continue
        is_sink = not lg.consumers(name)
        n_producer_units = sum(parallelism[p] for p in lg.producers(name))
        for i in range(parallelism[name]):
            if only is not None and (name, i) not in only:
                continue
            ports = [
                _OutPort(prep.routes.route(name, cop).bind(
                    parallelism[cop], vectorized=vectorized),
                    out_q_of(name, i, cop), batch)
                for cop in lg.consumers(name)]
            if spec.is_spout:
                spouts.append(Executor(
                    f"{name}#{i}", ports, batch, jumbo,
                    prep.states[name][i], source=app.source_for(name),
                    stop=stop, seed=seed + 7919 * i,
                    on_delivered=add_spout_count, max_batches=max_batches,
                    event_time=getattr(app, "event_time", {}).get(name),
                    wm_every=prep.wm_every.get(name, 1),
                    wm_interval=getattr(app, "watermark_interval",
                                        {}).get(name),
                    start_batch=offsets.get((name, i), 0),
                    ckpt=coordinator, final_watermark=final_watermark,
                    initial_aux=aux.get((name, i))))
            else:
                depth = 0
                if getattr(spec, "device", False):
                    depth = dispatch_depth if dispatch_depth is not None \
                        else spec.dispatch_depth
                tasks.append(Executor(
                    f"{name}#{i}", ports, batch, jumbo,
                    prep.states[name][i], kernel=app.kernels[name],
                    in_q=in_q_of(name, i),
                    expected_poisons=max(n_producer_units, 1),
                    lat_sink=latencies if is_sink else None,
                    device_depth=depth,
                    ckpt=coordinator, initial_aux=aux.get((name, i))))
    return spouts, tasks


def collect_result(prep: PreparedApp, spout_tuples: int,
                   latencies: List[float], wall: float,
                   spout_offsets: Optional[Dict[str, int]] = None,
                   checkpoints: Optional[List[Checkpoint]] = None,
                   exec_stats: Optional[Dict[str, dict]] = None
                   ) -> RuntimeResult:
    """Assemble the common :class:`RuntimeResult` from final states —
    shared by the threaded and process backends."""
    lg, states = prep.lg, prep.states
    sink_ops = lg.sinks()
    sink_tuples = sum(st.get("seen", 0)
                      for op in sink_ops for st in states[op])
    late = panes = 0
    for reps in states.values():
        for st in reps:
            win = getattr(st, "window", None)
            if isinstance(win, EventTimeWindowState):
                late += win.late_drops
                panes += win.panes_fired
    lat = np.array(latencies) if latencies else np.array([0.0])
    return RuntimeResult(
        duration=wall, sink_tuples=int(sink_tuples),
        spout_tuples=int(spout_tuples),
        throughput=sink_tuples / max(wall, 1e-9),
        latency_p50=float(np.percentile(lat, 50)),
        latency_p99=float(np.percentile(lat, 99)),
        states=states, late_drops=late, panes_fired=panes,
        spout_offsets=dict(spout_offsets or {}),
        checkpoints=list(checkpoints or []),
        exec_stats=dict(exec_stats or {}))


def resolve_checkpoint_every(app: StreamingApp, checkpoint_every) -> \
        Optional[int]:
    """The effective barrier cadence: the ``run_app`` argument wins, else
    the Topology declaration (``Topology(checkpoint_every=)``)."""
    every = checkpoint_every if checkpoint_every is not None \
        else getattr(app, "checkpoint_every", None)
    if every is None:
        return None
    if isinstance(every, bool) or not isinstance(every, int) or every < 1:
        raise ValueError(
            f"checkpoint_every must be an int >= 1 (batches between "
            f"barriers), got {every!r}")
    return every


def validate_from_checkpoint(app: StreamingApp, ckpt: Checkpoint, *,
                             batch: int, seed: int,
                             parallelism: Optional[Dict[str, int]],
                             initial_states, initial_offsets
                             ) -> Tuple[Dict[str, int], Dict[str, int]]:
    """Validate a resume request against its checkpoint and derive the
    effective (parallelism, initial_offsets).  Replay determinism requires
    the same app/seed/batch; the snapshot payloads are per-replica, so the
    checkpoint's parallelism is adopted (an explicit conflicting one is
    an error — resharding snapshots is ``migrate_states``' job, not a
    resume's)."""
    if not isinstance(ckpt, Checkpoint):
        raise ValueError(
            "from_checkpoint expects a Checkpoint (restore_checkpoint() "
            f"or RuntimeResult.checkpoints[-1]), got {type(ckpt).__name__}")
    if initial_states is not None or initial_offsets is not None:
        raise ValueError(
            "from_checkpoint conflicts with explicit initial_states/"
            "initial_offsets: the checkpoint carries both halves of the "
            "cut — passing either separately would tear it")
    if ckpt.app != app.name:
        raise ValueError(
            f"checkpoint belongs to app {ckpt.app!r}, not {app.name!r}")
    if ckpt.seed != seed:
        raise ValueError(
            f"checkpoint was taken at seed {ckpt.seed}, resume requested "
            f"seed {seed}: offset replay would produce different batches")
    if ckpt.batch != batch:
        raise ValueError(
            f"checkpoint was taken at batch={ckpt.batch}, resume requested "
            f"batch={batch}: the deterministic source sequence differs")
    if parallelism:
        for name, k in ckpt.parallelism.items():
            if parallelism.get(name, 1) != k:
                raise ValueError(
                    f"checkpoint holds {k} replica snapshots for "
                    f"{name!r} but parallelism requests "
                    f"{parallelism.get(name, 1)} — snapshots are "
                    "per-replica (use migrate_states to reshard)")
    return dict(ckpt.parallelism), dict(ckpt.spout_offsets)


def install_checkpoint(prep: PreparedApp, ckpt: Checkpoint
                       ) -> Dict[Tuple[str, int], dict]:
    """Restore every snapshot payload onto the prepared per-replica
    states (in place, pre-start — workers fork after this in the process
    backend) and return the ``initial_aux`` watermark bookkeeping map."""
    for uid, payload in ckpt.states.items():
        name, _, idx = uid.partition("#")
        restore_state(prep.states[name][int(idx)], payload)
    return {(uid.partition("#")[0], int(uid.partition("#")[2])): aux
            for uid, aux in ckpt.aux.items()}


def run_app(app: StreamingApp, parallelism: Optional[Dict[str, int]] = None,
            batch: int = 256, duration: float = 1.0, jumbo: bool = True,
            queue_cap: int = 32, partition: Optional[Dict[str, str]] = None,
            seed: int = 0, vectorized: Optional[bool] = None,
            max_batches: Optional[int] = None,
            initial_states: Optional[Dict[str, List[dict]]] = None,
            dispatch_depth: Optional[int] = None,
            initial_offsets: Optional[Dict[str, int]] = None,
            checkpoint_every: Optional[int] = None,
            checkpoint_dir: Optional[str] = None,
            from_checkpoint: Optional[Checkpoint] = None,
            final_watermark: bool = True,
            fuse=None
            ) -> RuntimeResult:
    """Execute ``app`` for ``duration`` seconds and return measured stats.

    Partition strategies and key extractors come from the app's Topology
    declaration, compiled once into routes (:mod:`repro_torch.streaming.routing`);
    the ``partition`` argument overrides per operator.  ``vectorized=None``
    (default) picks the keyed-split implementation per edge from the
    calibrated :func:`~.routing.auto_vectorized` threshold;
    ``True``/``False`` force the argsort+bincount / seed per-mask path
    everywhere (the ``bench_runtime.py`` A/B override).

    Declared operator state (``Topology.op(state=StateSpec(...))``) becomes
    managed stores on the replica state handles: keyed stores are sharded
    exactly like the compiled keyed route, so the union of the replica
    stores equals a single-replica run's store.

    ``max_batches`` switches to *deterministic replay*: every spout emits
    exactly that many batches (seeds ``seed .. seed+max_batches-1``) and the
    run drains fully — no drops, no duration cutoff — which makes keyed
    state byte-reproducible across replica counts.  ``initial_states`` seeds
    per-replica state (one entry per replica, e.g. from
    :func:`repro_torch.streaming.state.migrate_states` after a replan).

    ``dispatch_depth`` overrides every declared device operator's async
    in-flight window (1 forces the synchronous path — the A/B flag; the
    outputs are byte-identical either way, only the overlap changes).
    ``initial_offsets`` resumes each spout's deterministic source sequence
    at a recorded emitted-batch counter (``RuntimeResult.spout_offsets``
    from a previous run): the resumed run emits the batches the original
    would have emitted next, making duration-mode runs prefix-continuable.

    ``checkpoint_every`` (or ``Topology(checkpoint_every=)``) turns on
    aligned-barrier checkpointing: every spout injects a numbered barrier
    after each ``checkpoint_every``-th batch, every executor snapshots its
    state at the aligned cut, and each completed checkpoint lands in
    ``RuntimeResult.checkpoints`` (and, with ``checkpoint_dir``, on disk —
    atomically, so a kill mid-run leaves only complete files).
    ``from_checkpoint`` resumes from such a snapshot: states, offsets and
    watermark bookkeeping restore to the cut, and the resumed run's
    output (sink counters, keyed stores, pane multiset, late drops) is
    byte-identical to never having stopped.  ``final_watermark=False``
    suspends an event-time run instead of draining it (no end-of-stream
    ``+inf`` mark), keeping pane buffers resident for ``migrate_states``.

    ``fuse`` enables operator fusion (``"auto"``, explicit chains, or
    ``None``/``"off"``): eligible 1:1 shuffle segments execute as single
    :class:`FusedExecutor` threads with byte-identical results — see
    :mod:`repro_torch.streaming.fusion` and ``docs/API.md`` §3e.
    """
    every = resolve_checkpoint_every(app, checkpoint_every)
    if from_checkpoint is not None:
        parallelism, initial_offsets = validate_from_checkpoint(
            app, from_checkpoint, batch=batch, seed=seed,
            parallelism=parallelism, initial_states=initial_states,
            initial_offsets=initial_offsets)
        if every is None:
            every = from_checkpoint.checkpoint_every
    prep = prepare_app(app, parallelism, partition, initial_states,
                       batch=batch, fuse=fuse)
    initial_aux = install_checkpoint(prep, from_checkpoint) \
        if from_checkpoint is not None else None
    coordinator = CheckpointCoordinator(
        app, prep.parallelism, batch=batch, seed=seed, every=every,
        directory=checkpoint_dir) if every else None
    lg, parallelism = prep.lg, prep.parallelism

    # one input queue per non-spout replica
    in_qs: Dict[Tuple[str, int], queue.Queue] = {}
    for name in lg.operators:
        if not lg.operators[name].is_spout:
            for i in range(parallelism[name]):
                in_qs[(name, i)] = queue.Queue(maxsize=queue_cap)

    latencies: List[float] = []
    stop = threading.Event()
    spout_counts = [0]
    count_lock = threading.Lock()

    def add_spout_count(n: int) -> None:
        with count_lock:
            spout_counts[0] += n

    spouts, tasks = build_executors(
        app, prep, batch=batch, jumbo=jumbo, vectorized=vectorized,
        seed=seed, max_batches=max_batches, stop=stop, latencies=latencies,
        add_spout_count=add_spout_count,
        in_q_of=lambda name, i: in_qs[(name, i)],
        out_q_of=lambda name, i, cop: [in_qs[(cop, j)]
                                       for j in range(parallelism[cop])],
        dispatch_depth=dispatch_depth, initial_offsets=initial_offsets,
        coordinator=coordinator, final_watermark=final_watermark,
        initial_aux=initial_aux)

    for t in tasks:
        t.start()
    t_start = time.perf_counter()
    for th in spouts:
        th.start()
    if max_batches is None:
        time.sleep(duration)
        stop.set()
        join_timeout = 5.0
    else:
        # deterministic replay: spouts finish their batch budget on their
        # own (backpressure, no drops); stop only guards a crashed consumer
        join_timeout = 60.0
    for th in spouts:
        th.join(timeout=join_timeout)
    stop.set()
    for t in tasks:
        t.join(timeout=join_timeout)
    wall = time.perf_counter() - t_start
    exec_stats: Dict[str, dict] = {}
    for ex in spouts + tasks:
        exec_stats.update(ex.stats_payload())
    return collect_result(prep, spout_counts[0], latencies, wall,
                          spout_offsets={s.name: s.emitted_batches
                                         for s in spouts},
                          checkpoints=coordinator.completed
                          if coordinator else None,
                          exec_stats=exec_stats)
