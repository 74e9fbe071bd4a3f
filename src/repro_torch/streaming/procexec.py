"""Process-parallel execution backend: shared-memory lanes that make RLAS
placement physically real.

The threaded runtime (:mod:`repro_torch.streaming.runtime`) validates streaming
*semantics*, but every replica shares one GIL and one allocator arena — a
bad placement cannot hurt and RLAS cannot win.  This backend runs the same
executors in **worker processes**:

* one worker per *core group* — by default one per replica; in the
  placement-faithful mode (:func:`plan_placement`, what
  ``Plan.execute(backend="processes", faithful=True)`` uses) one per
  plan-assigned socket, pinned to that socket's share of the host cores via
  ``os.sched_setaffinity``;
* tuples that stay inside a group move by reference through ordinary
  in-process queues, exactly as in the threaded backend;
* tuples that cross groups move over fixed-slot **shared-memory SPSC jumbo
  rings** (:class:`ShmRing`, ``multiprocessing.shared_memory``) in a **raw
  zero-copy slot format**: a fixed header (tag, dtype id, shape, ``t0``)
  followed by the batch's raw bytes, written straight into the slot
  through a NumPy view (one vectorized copy, no pickle, no intermediate
  ``bytes``) and read back as a view over the slot that is copied exactly
  once on hand-off before the head advances — the minimum physical
  movement a cross-process edge can pay, the shared-memory analogue of
  the paper's remote-memory / QPI hop.  Batch dtypes resolve through a
  small table (:func:`register_ring_dtype`) negotiated at worker spawn
  (fork inherits the parent's table); anything unregistered falls back to
  a tagged pickle slot with byte-identical semantics
  (``ring_format="pickle"`` forces the fallback everywhere — the
  serialization A/B in ``benchmarks/bench_runtime.py``).  Watermarks and
  end-of-stream marks travel the same rings as in-band tagged slots, so
  the :class:`~.runtime.Executor` routing/merge/shutdown logic is reused
  *verbatim* — the ring endpoints implement the ``queue.Queue`` protocol
  the executor already speaks.

Because colocated replicas communicate by reference and cross-group edges
pay serialization, a plan's placement quality has a measurable physical
cost even on a small host: RLAS (which colocates heavy edges) beats a
worst-case placement (which alternates sockets along the chain, maximizing
ring crossings) by a real margin — the ``placement_sensitivity`` section of
``BENCH_streaming.json``.

Workers are **forked**, not spawned: app kernels, sources and
``StateSpec.init`` factories are closures and need not pickle — they are
inherited.  What crosses process boundaries explicitly is (a) ring slots —
raw-encoded ``numpy`` batches — and (b) the end-of-run **state payloads**:
each worker reduces its replicas' :class:`~.state.OperatorState` handles to
plain arrays (:func:`_state_payload`), ships them over a pipe, and the
parent restores them onto its own handles (:func:`_restore_state`) — so
``migrate_states`` and every downstream consumer of
``RuntimeResult.states`` work unchanged across process boundaries.

Device operators (the ``streaming_inference`` predictor) run in PyTorch on
the one CUDA card, which every worker shares; CUDA must not be initialized
in the parent before the fork (a forked child of a CUDA parent cannot use
the card), so such an app needs a CUDA-clean parent.  (tcmalloc, per the
exemplar run scripts, must be ``LD_PRELOAD``-ed into the *parent* before
Python starts: preloading happens at exec time and forked workers inherit
it — see docs/API.md.)
"""
from __future__ import annotations

import math
import os
import pickle
import queue
import struct
import sys
import threading
import time
import traceback
import multiprocessing as mp
from multiprocessing import shared_memory
from multiprocessing.connection import wait as conn_wait
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

from .apps import StreamingApp
from .checkpoint import Checkpoint, CheckpointCoordinator
from .runtime import (RuntimeResult, _Barrier, _POISON, _Watermark,
                      build_executors, collect_result, install_checkpoint,
                      prepare_app, resolve_checkpoint_every,
                      validate_from_checkpoint)
from .state import (BroadcastTable, EventTimeWindowState, KeyedStore,
                    OperatorState, ValueStore, WindowState,
                    restore_state, state_payload)

__all__ = ["ShmRing", "register_ring_dtype", "run_app_processes",
           "plan_placement", "socket_core_map", "host_device_env",
           "get_backend", "register_backend", "BACKENDS"]

_SLOT_BYTES = 128 * 1024     # default ring slot: comfortably holds the
# largest benchmark jumbo (WC's splitter emits batch x 10 int64 words —
# 80 KiB at batch 1024) with headroom; oversize payloads raise with a
# pointer at slot_bytes= instead of splitting the batch (a split would
# change stateful kernels' running outputs and break byte parity)
_RING_SLOTS = 8              # slots per ring (jumbos in flight per lane)
_CTRL = 16                   # ring header: head int64 @0, tail int64 @8
_POLL = 50e-6                # idle poll quantum (grows to _POLL_MAX)
_POLL_MAX = 2e-3
_SPIN = 128                  # bounded busy-spin tries before the first
# sleep: a slot under load frees in O(µs), while even the shortest
# time.sleep costs a scheduler round-trip (~50µs wake latency) on every
# slot — the hybrid spins briefly, then falls back to the sleep ladder

# -- raw slot format --------------------------------------------------------
# slot := tag u8, then per tag:
#   RAW     @1 dtype-id u8, @2 ndim u8, @3 lane-length u8 (0 = untagged),
#           @8 t0 f64, @16 shape ndim*i64, @16+8*ndim raw row bytes
#           (8-aligned: slots start 8-aligned and the header is a multiple
#           of 8), then lane utf-8 after the rows
#   PICKLE  @1 blob-length u32, @5 pickled ("d", array, t0[, lane]) payload
#   WM      @1 lane-length u32, @5 lane utf-8, then value f64
#   POISON  tag only
#   BARRIER @1 lane-length u32, @5 lane utf-8, then ckpt_id i64
# Lane tags ride only under checkpointing — the runtime emits 4-tuple
# items then, and the consumer-side barrier aligner needs the producer
# lane to hold the right inputs back.
_TAG_RAW, _TAG_PICKLE, _TAG_WM, _TAG_POISON, _TAG_BARRIER = 0, 1, 2, 3, 4
_RAW_HDR = 16
_RAW_MAX_DIMS = 4

#: the dtype table: id <-> dtype, shared producer/consumer.  Negotiated at
#: worker spawn — forked workers inherit the parent's table, so structured
#: or otherwise app-specific dtypes must register *before*
#: ``run_app_processes`` forks (a registration after spawn stays local to
#: the registering process and the other side falls back to pickle).
_DTYPE_TABLE: List[np.dtype] = [np.dtype(s) for s in (
    "bool", "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64",
    "float16", "float32", "float64", "complex64", "complex128")]
_DTYPE_IDS: Dict[np.dtype, int] = {dt: i
                                   for i, dt in enumerate(_DTYPE_TABLE)}


def register_ring_dtype(dtype) -> int:
    """Register ``dtype`` (structured dtypes included) in the ring's raw
    slot dtype table and return its id.  Idempotent.  Must run before the
    worker fork to be visible on both ring endpoints; unregistered dtypes
    are not an error — they ride the tagged pickle fallback."""
    dt = np.dtype(dtype)
    did = _DTYPE_IDS.get(dt)
    if did is None:
        if len(_DTYPE_TABLE) >= 256:
            raise ValueError("ring dtype table is full (256 entries)")
        _DTYPE_TABLE.append(dt)
        did = _DTYPE_IDS[dt] = len(_DTYPE_TABLE) - 1
    return did


_seq_lock = threading.Lock()
_seq = [0]


def _ring_name() -> str:
    with _seq_lock:
        _seq[0] += 1
        # "bst", not the reference package's "bsr": the two packages' tests
        # each check that no segment of their own prefix outlives a run
        return f"bst{os.getpid()}x{_seq[0]}"


class ShmRing:
    """Fixed-slot SPSC ring over one shared-memory segment.

    Layout: ``head`` (int64, consumer-owned) at offset 0, ``tail`` (int64,
    producer-owned) at offset 8, then ``capacity`` slots of ``slot_bytes``
    in the tagged raw format (see the module header): data batches are a
    fixed header plus raw row bytes written through a NumPy view directly
    into the slot — no pickle, no intermediate ``bytes`` — with a tagged
    pickle fallback for dtypes outside the negotiated table (or everywhere
    under ``raw=False``, the A/B baseline).  Exactly one producer process
    writes ``tail`` and slots; exactly one consumer process writes
    ``head`` — no locks, just the two indices (single-writer per cache
    line; CPython's bytecode boundaries plus x86 store ordering make the
    payload-then-tail publication safe).

    The consumer materializes a batch as an ``ndarray`` view over the
    slot and copies it exactly once — *before* advancing ``head``, since
    the advance hands the slot back to the producer for reuse.  Waits are
    hybrid: a short bounded spin (:data:`_SPIN` tries) before the first
    ``time.sleep``, then an exponential sleep ladder — the immediate-sleep
    path paid one scheduler wake latency per slot under load.

    The endpoint speaks the ``queue.Queue`` protocol the
    :class:`~.runtime.Executor` uses: blocking ``put`` (backpressure),
    ``put(timeout=)`` raising ``queue.Full`` (the spout's interruptible
    path), blocking ``get`` and ``get_nowait`` raising ``queue.Empty``.
    Data tuples, watermarks and the poison sentinel are tagged in-band —
    consumers receive the exact runtime objects (poison by identity; data
    as ``(array, t0, None)`` items).  ``put_slots``/``put_tuples``/
    ``put_bytes`` and the ``get_*`` mirrors count slots, tuples and bytes
    actually copied per side — the bytes-copied-per-tuple instrumentation
    behind the ``serialization`` bench section.
    """

    #: rings copy payloads out of the producer's address space inside
    #: ``put`` — the emit path releases pooled-buffer leases immediately
    #: instead of expecting the (other-process) consumer to
    by_reference = False

    __slots__ = ("name", "capacity", "slot_bytes", "raw", "shm", "_buf",
                 "put_slots", "put_tuples", "put_bytes",
                 "get_slots", "get_tuples", "get_bytes")

    def __init__(self, name: Optional[str] = None, *,
                 capacity: int = _RING_SLOTS,
                 slot_bytes: int = _SLOT_BYTES, create: bool = True,
                 raw: bool = True):
        self.capacity = capacity
        self.slot_bytes = slot_bytes
        self.raw = raw
        size = _CTRL + capacity * slot_bytes
        if create:
            name = name or _ring_name()
            self.shm = shared_memory.SharedMemory(name=name, create=True,
                                                  size=size)
            self.shm.buf[:_CTRL] = b"\0" * _CTRL
        else:
            self.shm = shared_memory.SharedMemory(name=name)
        self.name = self.shm.name
        self._buf = self.shm.buf
        self.put_slots = self.put_tuples = self.put_bytes = 0
        self.get_slots = self.get_tuples = self.get_bytes = 0

    # -- the two indices ---------------------------------------------------
    def _head(self) -> int:
        return struct.unpack_from("<q", self._buf, 0)[0]

    def _tail(self) -> int:
        return struct.unpack_from("<q", self._buf, 8)[0]

    def _set_head(self, v: int) -> None:
        struct.pack_into("<q", self._buf, 0, v)

    def _set_tail(self, v: int) -> None:
        struct.pack_into("<q", self._buf, 8, v)

    def _oversize(self, nbytes: int) -> ValueError:
        return ValueError(
            f"ring payload of {nbytes} bytes exceeds the "
            f"{self.slot_bytes}-byte slot; raise slot_bytes= "
            "(run_app_processes / ShmRing) for jumbo batches this "
            "large — the ring never splits a batch, splitting would "
            "change stateful kernels' outputs")

    # -- producer side -----------------------------------------------------
    def put(self, item, timeout: Optional[float] = None) -> None:
        # classify + size the slot before claiming it (the oversize check
        # must fire even when the ring is full)
        arr = blob = lane = None
        if item is _POISON:
            tag, need = _TAG_POISON, 1
        elif isinstance(item, _Watermark):
            tag = _TAG_WM
            lane = item.lane.encode()
            need = 5 + len(lane) + 8
        elif isinstance(item, _Barrier):
            tag = _TAG_BARRIER
            lane = item.lane.encode()
            need = 5 + len(lane) + 8
        else:                   # (arr, t0[, lease[, lane]]) data jumbo
            arr, t0 = item[0], item[1]
            if len(item) >= 4 and item[3] is not None:
                lane = item[3].encode()
                if len(lane) > 255:
                    raise ValueError(f"operator name {item[3]!r} exceeds "
                                     "the 255-byte ring lane tag")
            did = _DTYPE_IDS.get(arr.dtype) if self.raw else None
            if did is not None and 1 <= arr.ndim <= _RAW_MAX_DIMS:
                tag = _TAG_RAW
                arr = np.ascontiguousarray(arr)
                need = (_RAW_HDR + 8 * arr.ndim + arr.nbytes
                        + (len(lane) if lane else 0))
            else:                       # unregistered dtype: tagged fallback
                tag = _TAG_PICKLE
                payload = (("d", np.ascontiguousarray(arr), t0) if lane is None
                           else ("d", np.ascontiguousarray(arr), t0, item[3]))
                blob = pickle.dumps(payload,
                                    protocol=pickle.HIGHEST_PROTOCOL)
                need = 5 + len(blob)
        if need > self.slot_bytes:
            raise self._oversize(need)
        deadline = None if timeout is None else time.monotonic() + timeout
        tail = self._tail()
        spins = _SPIN
        sleep = _POLL
        while tail - self._head() >= self.capacity:
            if spins:                    # bounded spin before first sleep
                spins -= 1
                continue
            if deadline is not None and time.monotonic() > deadline:
                raise queue.Full
            time.sleep(sleep)
            sleep = min(sleep * 2, _POLL_MAX)
        off = _CTRL + (tail % self.capacity) * self.slot_bytes
        if tag == _TAG_RAW:
            # lane-length is always written: slots are reused without
            # zeroing, so byte 3 would otherwise carry a stale tag
            struct.pack_into("<BBBB", self._buf, off, tag, did, arr.ndim,
                             len(lane) if lane else 0)
            struct.pack_into("<d", self._buf, off + 8, float(t0))
            struct.pack_into(f"<{arr.ndim}q", self._buf, off + _RAW_HDR,
                             *arr.shape)
            if arr.nbytes:
                dst = np.ndarray(arr.shape, arr.dtype, buffer=self._buf,
                                 offset=off + _RAW_HDR + 8 * arr.ndim)
                dst[...] = arr        # the one producer-side copy, into shm
            if lane:
                end = off + _RAW_HDR + 8 * arr.ndim + arr.nbytes
                self._buf[end:end + len(lane)] = lane
            self.put_tuples += len(arr)
            self.put_bytes += arr.nbytes
        elif tag == _TAG_PICKLE:
            struct.pack_into("<BI", self._buf, off, tag, len(blob))
            self._buf[off + 5:off + 5 + len(blob)] = blob
            self.put_tuples += len(arr)
            self.put_bytes += arr.nbytes + len(blob)   # dumps + slot write
        elif tag == _TAG_WM:
            struct.pack_into("<BI", self._buf, off, tag, len(lane))
            self._buf[off + 5:off + 5 + len(lane)] = lane
            struct.pack_into("<d", self._buf, off + 5 + len(lane),
                             item.value)
        elif tag == _TAG_BARRIER:
            struct.pack_into("<BI", self._buf, off, tag, len(lane))
            self._buf[off + 5:off + 5 + len(lane)] = lane
            struct.pack_into("<q", self._buf, off + 5 + len(lane),
                             item.ckpt_id)
        else:
            self._buf[off] = _TAG_POISON
        self.put_slots += 1
        self._set_tail(tail + 1)

    # -- consumer side -----------------------------------------------------
    def get_nowait(self):
        head = self._head()
        if self._tail() - head <= 0:
            raise queue.Empty
        off = _CTRL + (head % self.capacity) * self.slot_bytes
        tag = self._buf[off]
        if tag == _TAG_RAW:
            did, ndim = self._buf[off + 1], self._buf[off + 2]
            lane_len = self._buf[off + 3]
            (t0,) = struct.unpack_from("<d", self._buf, off + 8)
            shape = struct.unpack_from(f"<{ndim}q", self._buf,
                                       off + _RAW_HDR)
            dt = _DTYPE_TABLE[did]
            if math.prod(shape):
                src = np.ndarray(shape, dt, buffer=self._buf,
                                 offset=off + _RAW_HDR + 8 * ndim)
                arr = src.copy()   # the one hand-off copy, pre head-advance
            else:
                arr = np.empty(shape, dt)
            self.get_tuples += len(arr)
            self.get_bytes += arr.nbytes
            if lane_len:
                end = off + _RAW_HDR + 8 * ndim + arr.nbytes
                lane = bytes(self._buf[end:end + lane_len]).decode()
                item = (arr, t0, None, lane)
            else:
                item = (arr, t0, None)
        elif tag == _TAG_PICKLE:
            (length,) = struct.unpack_from("<I", self._buf, off + 1)
            payload = pickle.loads(self._buf[off + 5:off + 5 + length])
            arr = payload[1]
            self.get_tuples += len(arr)
            self.get_bytes += arr.nbytes
            item = ((arr, payload[2], None, payload[3])
                    if len(payload) >= 4 else (arr, payload[2], None))
        elif tag == _TAG_WM:
            (length,) = struct.unpack_from("<I", self._buf, off + 1)
            lane = bytes(self._buf[off + 5:off + 5 + length]).decode()
            (value,) = struct.unpack_from("<d", self._buf,
                                          off + 5 + length)
            item = _Watermark(lane, value)
        elif tag == _TAG_BARRIER:
            (length,) = struct.unpack_from("<I", self._buf, off + 1)
            lane = bytes(self._buf[off + 5:off + 5 + length]).decode()
            (ckpt_id,) = struct.unpack_from("<q", self._buf,
                                            off + 5 + length)
            item = _Barrier(lane, ckpt_id)
        else:
            item = _POISON
        self.get_slots += 1
        self._set_head(head + 1)
        return item

    def get(self):
        spins = _SPIN
        sleep = _POLL
        while True:
            try:
                return self.get_nowait()
            except queue.Empty:
                if spins:                # bounded spin before first sleep
                    spins -= 1
                    continue
                time.sleep(sleep)
                sleep = min(sleep * 2, _POLL_MAX)

    # -- lifecycle (parent-side) -------------------------------------------
    def close(self) -> None:
        try:
            self._buf = None
            self.shm.close()
        except (BufferError, OSError):
            pass

    def unlink(self) -> None:
        try:
            self.shm.unlink()
        except FileNotFoundError:
            pass


class _FanIn:
    """Consumer-side merge of one replica's input endpoints — shared-memory
    rings (one per cross-group producer replica) plus at most one local
    in-process queue.  Implements the blocking ``get()`` the executor's
    task loop calls, polling sources round-robin so no producer lane can
    starve another (the threaded backend's single shared queue has the
    same no-starvation property by FIFO interleaving)."""

    __slots__ = ("sources", "_i", "_solo")

    def __init__(self, sources: List[object]):
        self.sources = sources
        self._i = 0
        # single-lane fast path: one producer endpoint means no fan-in
        # bookkeeping at all — poll it directly
        self._solo = sources[0] if len(sources) == 1 else None

    def get(self):
        spins = _SPIN
        sleep = _POLL
        if self._solo is not None:
            src = self._solo
            while True:
                try:
                    return src.get_nowait()
                except queue.Empty:
                    pass
                if spins:
                    spins -= 1
                    continue
                time.sleep(sleep)
                sleep = min(sleep * 2, _POLL_MAX)
        while True:
            for _ in range(len(self.sources)):
                src = self.sources[self._i]
                self._i = (self._i + 1) % len(self.sources)
                try:
                    return src.get_nowait()
                except queue.Empty:
                    pass
            if spins:                    # bounded spin before first sleep
                spins -= 1
                continue
            time.sleep(sleep)
            sleep = min(sleep * 2, _POLL_MAX)


class _ShmEvent:
    """``threading.Event`` facade over one shared-memory byte — the spout
    stop flag, settable from the parent and visible in every worker."""

    __slots__ = ("shm", "_off")

    def __init__(self, shm: shared_memory.SharedMemory, offset: int = 0):
        self.shm = shm
        self._off = offset

    def is_set(self) -> bool:
        return self.shm.buf[self._off] != 0

    def set(self) -> None:
        self.shm.buf[self._off] = 1


class _CkptProxy:
    """Worker-side stand-in for the parent's
    :class:`~.checkpoint.CheckpointCoordinator`.

    Executors call the same ``deposit`` surface; the proxy forwards each
    snapshot over the worker's result pipe as an in-band ``("ckpt", ...)``
    message, so alignment bookkeeping and completed-round assembly live
    only in the parent — which persists finished checkpoints mid-run and
    therefore survives worker kills.  The pipe lock is shared with the
    end-of-run ``("ok", ...)`` send: several executor threads per worker
    deposit concurrently and ``Connection.send`` is not thread-safe."""

    __slots__ = ("every", "_conn", "_lock")

    def __init__(self, conn, lock: threading.Lock, every: int):
        self.every = every
        self._conn = conn
        self._lock = lock

    def deposit(self, ckpt_id: int, uid: str, *, payload: dict,
                aux: Optional[dict] = None,
                offset: Optional[int] = None) -> None:
        with self._lock:
            self._conn.send(("ckpt", ckpt_id, uid, payload, aux, offset))


# ---------------------------------------------------------------------------
# State payloads: what crosses the pipe back to the parent
# ---------------------------------------------------------------------------


# Grown into public repro_torch.streaming.state.state_payload / restore_state
# when checkpointing needed the same reduction for live snapshots (with
# copy=True); the worker pipe hand-off keeps using them under the old
# names.
_state_payload = state_payload
_restore_state = restore_state


# ---------------------------------------------------------------------------
# Worker grouping and pinning
# ---------------------------------------------------------------------------

Replica = Tuple[str, int]


def _normalize_groups(groups, replicas: List[Replica]) -> Dict[Replica, object]:
    """Resolve the ``groups`` argument to replica -> group id.

    ``None`` gives every replica its own worker (maximum parallelism, every
    edge a ring).  A mapping may assign by replica ``(op, i)`` or by
    operator name; unassigned replicas get solo workers."""
    if groups is None:
        return {rep: idx for idx, rep in enumerate(replicas)}
    out: Dict[Replica, object] = {}
    for rep in replicas:
        name, _ = rep
        if rep in groups:
            out[rep] = groups[rep]
        elif name in groups:
            out[rep] = groups[name]
        else:
            out[rep] = ("solo",) + rep
    return out


def _numa_node_cpus(sysfs: str = "/sys/devices/system/node"
                    ) -> List[List[int]]:
    """Per-NUMA-node CPU lists from sysfs (``node*/cpulist``, the kernel's
    ``"0-3,8-11"`` range syntax), sorted by node id.  Empty when the tree
    is absent (non-Linux, containers masking /sys) — callers fall back to
    topology-blind round-robin."""
    try:
        nodes = sorted((d for d in os.listdir(sysfs)
                        if d.startswith("node") and d[4:].isdigit()),
                       key=lambda d: int(d[4:]))
    except OSError:
        return []
    out: List[List[int]] = []
    for node in nodes:
        try:
            with open(os.path.join(sysfs, node, "cpulist")) as fh:
                text = fh.read().strip()
        except OSError:
            continue
        cpus: List[int] = []
        for part in text.split(","):
            if not part:
                continue
            lo, _, hi = part.partition("-")
            cpus.extend(range(int(lo), int(hi or lo) + 1))
        if cpus:
            out.append(cpus)
    return out


def socket_core_map(n_sockets: int,
                    cores: Optional[List[int]] = None,
                    sysfs: str = "/sys/devices/system/node"
                    ) -> Dict[int, List[int]]:
    """Host cores bucketed into ``n_sockets`` pinning sets — the worker
    map for plan-faithful execution.

    When the host exposes more than one NUMA node (``sysfs``) and no
    explicit ``cores=`` override is given, modelled socket ``s`` gets the
    affinity-visible cores of host node ``s % n_nodes`` — so a plan
    socket's workers really share one physical memory domain and
    cross-socket rings really cross the interconnect, the topology the
    paper's remote-memory penalty models.  Single-node hosts (and
    explicit ``cores=``) keep the topology-blind round-robin.  Sockets
    left with no core on small hosts are simply unpinned (the scheduler
    places them)."""
    if cores is None:
        avail = os.sched_getaffinity(0)
        nodes = [[c for c in node if c in avail]
                 for node in _numa_node_cpus(sysfs)]
        nodes = [n for n in nodes if n]
        if len(nodes) > 1:
            buckets = {s: [] for s in range(n_sockets)}
            for s in range(n_sockets):
                buckets[s] = list(nodes[s % len(nodes)])
            return {s: cs for s, cs in buckets.items() if cs}
        cores = avail
    cores = sorted(cores)
    buckets: Dict[int, List[int]] = {s: [] for s in range(n_sockets)}
    for idx, c in enumerate(cores):
        buckets[idx % n_sockets].append(c)
    return {s: cs for s, cs in buckets.items() if cs}


def plan_placement(plan, parallelism: Dict[str, int]
                   ) -> Tuple[Dict[Replica, int], Dict[int, List[int]]]:
    """Derive (groups, pins) from a plan's socket map — the placement-
    faithful mode of ``Plan.execute(backend="processes")``.

    Runtime replica ``(op, j)`` inherits the socket of the plan's unit
    ``j % planned_units(op)`` (the runtime replica count may have been
    scaled down from the modelled machine), so colocated units share a
    worker and cross-socket streams pay the ring copy — placement cost
    becomes communication cost, measurable even on a single-core host.
    Pins round-robin the host cores over the plan's sockets."""
    socks: Dict[str, List[int]] = {}
    for idx, rep in enumerate(plan.graph.replicas):
        socks.setdefault(rep.op, []).append(plan.placement[idx])
    # fused plans place whole chains as single units: every member
    # inherits the fused unit's sockets (chain replicas share a worker)
    alias = {m: "+".join(c) for c in getattr(plan, "chains", []) for m in c}
    groups: Dict[Replica, int] = {}
    for op, k in parallelism.items():
        placed = socks.get(op)
        if placed is None and op in alias:
            placed = socks.get(alias[op])
        s = sorted(max(0, x) for x in (placed or [0]))  # UNPLACED -> 0
        for j in range(k):
            groups[(op, j)] = s[j % len(s)]
    pins = socket_core_map(plan.machine.n_sockets)
    return groups, pins


def _cuda_initialized() -> bool:
    """True when this process has initialized CUDA through PyTorch (one
    that never imported torch has not; importing it alone does not)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_initialized()


def host_device_env(n: int, base: Optional[Mapping[str, str]] = None
                    ) -> Dict[str, str]:
    """Worker environment for an app with device operators.

    ``n`` (the number of worker groups) is kept for the signature's sake:
    every worker of a device app uses the one CUDA card, so no per-worker
    device count is set (the reference's XLA host-device-count flag means
    nothing to PyTorch and is not set).  Sets the tcmalloc large-alloc
    report threshold the exemplar run scripts use; tcmalloc itself must be
    LD_PRELOAD-ed into the *parent* (preloading happens at exec, forked
    workers inherit it — see docs/API.md)."""
    env = dict(base or {})
    env.setdefault("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD", "60000000000")
    return env


# ---------------------------------------------------------------------------
# The process backend
# ---------------------------------------------------------------------------


def run_app_processes(app: StreamingApp,
                      parallelism: Optional[Dict[str, int]] = None,
                      batch: int = 256, duration: float = 1.0,
                      jumbo: bool = True, queue_cap: int = 32,
                      partition: Optional[Dict[str, str]] = None,
                      seed: int = 0, vectorized: Optional[bool] = None,
                      max_batches: Optional[int] = None,
                      initial_states: Optional[Dict[str, List[dict]]] = None,
                      groups: Optional[Mapping] = None,
                      pin: Optional[Mapping[object, List[int]]] = None,
                      env: Optional[Mapping[str, str]] = None,
                      slot_bytes: int = _SLOT_BYTES,
                      ring_slots: int = _RING_SLOTS,
                      ring_format: str = "raw",
                      timeout: Optional[float] = None,
                      dispatch_depth: Optional[int] = None,
                      initial_offsets: Optional[Dict[str, int]] = None,
                      checkpoint_every: Optional[int] = None,
                      checkpoint_dir: Optional[str] = None,
                      from_checkpoint: Optional[Checkpoint] = None,
                      final_watermark: bool = True,
                      fuse=None
                      ) -> RuntimeResult:
    """Execute ``app`` on forked worker processes (see module docstring).

    Accepts the full ``run_app`` surface plus: ``groups`` (replica/operator
    -> worker group id; default one worker per replica), ``pin`` (group id
    -> CPU cores, applied via ``sched_setaffinity``), ``env`` (extra
    worker environment), ``slot_bytes``/``ring_slots``/``ring_format``
    (ring geometry and slot encoding — ``"raw"`` is the zero-copy default,
    ``"pickle"`` forces the fallback path everywhere for serialization
    A/Bs) and ``timeout`` (whole-run deadline; on expiry workers are
    terminated, every shared-memory segment is unlinked and
    ``TimeoutError`` is raised — a wedged ring cannot orphan segments or
    hang the caller).

    Parity contract: under deterministic replay (``max_batches``) the
    result — sink counters, keyed state bytes, pane multisets, late
    drops — is byte-identical to ``run_app``'s for any grouping, because
    both backends run the same executors over the same compiled routes and
    only the transport differs.

    Checkpointing (``checkpoint_every`` / ``checkpoint_dir`` /
    ``from_checkpoint`` / ``final_watermark``) matches ``run_app``:
    barriers travel cross-process as in-band tagged ring slots, data
    slots carry their producer lane for the consumer-side aligner, and
    workers stream every aligned snapshot back over their result pipe —
    the parent assembles and persists completed checkpoints *mid-run*,
    so a SIGKILL-ed run restores from the last completed cut.
    """
    if ring_format not in ("raw", "pickle"):
        raise ValueError(f"ring_format must be 'raw' or 'pickle', "
                         f"got {ring_format!r}")
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
    # restore *before* the fork: workers inherit the restored states
    initial_aux = install_checkpoint(prep, from_checkpoint) \
        if from_checkpoint is not None else None
    coordinator = CheckpointCoordinator(
        app, prep.parallelism, batch=batch, seed=seed, every=every,
        directory=checkpoint_dir) if every else None
    lg, par = prep.lg, prep.parallelism
    replicas: List[Replica] = [(name, i) for name in lg.operators
                               for i in range(par[name])]
    group_of = _normalize_groups(groups, replicas)
    # a fused chain replica is one executor: every member replica lands in
    # the head replica's group (overriding any requested split — fusion
    # already collapsed those edges to function calls)
    for chain in prep.chains:
        head = chain[0]
        for m in chain[1:]:
            for i in range(par[head]):
                group_of[(m, i)] = group_of[(head, i)]
    gids = list(dict.fromkeys(group_of.values()))      # first-appearance order
    if getattr(app, "device_ops", None) and app.device_ops():
        # a forked child of a parent that has initialized CUDA cannot use
        # the card (its first CUDA call fails) — fail fast with the
        # workaround instead of failing in every worker
        if _cuda_initialized():
            raise RuntimeError(
                "backend='processes' with device operators requires a "
                "CUDA-clean parent: CUDA is already initialized in this "
                "process (forked workers cannot use the card). Run device "
                "apps from a fresh process that has not touched CUDA, or "
                "use backend='threads'")
        env = host_device_env(max(1, len(gids)), base=env)
    members: Dict[object, List[Replica]] = {g: [] for g in gids}
    for rep in replicas:
        members[group_of[rep]].append(rep)

    # -- wiring: local queues inside a group, rings across groups ----------
    local_qs: Dict[Replica, queue.Queue] = {}
    rings: Dict[Tuple[Replica, Replica], ShmRing] = {}
    ring_cap = max(2, min(queue_cap, ring_slots))
    intra = {(u, v) for chain in prep.chains
             for u, v in zip(chain, chain[1:])}
    for v in lg.operators:
        if lg.operators[v].is_spout:
            continue
        for j in range(par[v]):
            for u in lg.producers(v):
                if (u, v) in intra:
                    continue       # fused away: no queue, no ring
                for i in range(par[u]):
                    pr, cr = (u, i), (v, j)
                    if group_of[pr] == group_of[cr]:
                        if cr not in local_qs:
                            local_qs[cr] = queue.Queue(maxsize=queue_cap)
                    else:
                        rings[(pr, cr)] = ShmRing(
                            capacity=ring_cap, slot_bytes=slot_bytes,
                            raw=ring_format == "raw")

    ctrl = shared_memory.SharedMemory(name=_ring_name(), create=True, size=16)
    ctrl.buf[:16] = b"\0" * 16
    stop = _ShmEvent(ctrl)

    def in_q_of(name: str, i: int):
        cr = (name, i)
        in_rings = [r for (pr, c), r in rings.items() if c == cr]
        local = local_qs.get(cr)
        if not in_rings:
            return local if local is not None else queue.Queue()
        if local is None and len(in_rings) == 1:
            return in_rings[0]
        return _FanIn(in_rings + ([local] if local is not None else []))

    def out_q_of(name: str, i: int, cop: str):
        pr = (name, i)
        return [rings[(pr, (cop, j))] if (pr, (cop, j)) in rings
                else local_qs[(cop, j)] for j in range(par[cop])]

    def _worker(gid, conn) -> None:
        send_lock = threading.Lock()
        try:
            if env:
                os.environ.update(env)
            if pin and gid in pin:
                try:
                    os.sched_setaffinity(0, set(pin[gid]))
                except (OSError, ValueError):
                    pass                     # cores absent on this host
            # a kernel crash happens on an executor *thread*; without this
            # hook the worker main thread would join the corpse and report
            # "ok" while downstream workers starve — record and fail fast
            errors: List[str] = []
            threading.excepthook = lambda a: errors.append("".join(
                traceback.format_exception(a.exc_type, a.exc_value,
                                           a.exc_traceback)))
            latencies: List[float] = []
            counts = [0]
            proxy = _CkptProxy(conn, send_lock, every) if every else None
            spouts, tasks = build_executors(
                app, prep, batch=batch, jumbo=jumbo, vectorized=vectorized,
                seed=seed, max_batches=max_batches, stop=stop,
                latencies=latencies,
                add_spout_count=lambda n: counts.__setitem__(
                    0, counts[0] + n),
                in_q_of=in_q_of, out_q_of=out_q_of,
                only=set(members[gid]), dispatch_depth=dispatch_depth,
                initial_offsets=initial_offsets,
                coordinator=proxy, final_watermark=final_watermark,
                initial_aux=initial_aux)
            for t in tasks:
                t.start()
            for s in spouts:
                s.start()
            join_timeout = 5.0 if max_batches is None else 60.0
            # Unlike run_app, do NOT set the stop flag when this worker's
            # spouts finish: the flag is shared across workers and another
            # group's spout may still be mid-replay.  The parent sets it
            # (duration cutoff / shutdown); tasks exit by poison counting.
            # Joins poll so a recorded crash aborts the wait immediately.
            local_deadline = time.monotonic() + join_timeout
            for x in spouts + tasks:
                while x.is_alive() and not errors \
                        and time.monotonic() < local_deadline:
                    x.join(timeout=0.1)
                if errors:
                    raise RuntimeError("executor crashed:\n"
                                       + "\n".join(errors))
            payload = {
                "states": {rep: _state_payload(prep.states[rep[0]][rep[1]])
                           for rep in members[gid]},
                "latencies": latencies,
                "spout_tuples": counts[0],
                "spout_offsets": {s.name: s.emitted_batches
                                  for s in spouts},
                "exec_stats": {uid: st for x in spouts + tasks
                               for uid, st in x.stats_payload().items()}}
            with send_lock:
                conn.send(("ok", payload))
            conn.close()
        except BaseException:
            try:
                with send_lock:
                    conn.send(("error", f"worker {gid!r}:\n"
                               + traceback.format_exc()))
                conn.close()
            finally:
                os._exit(1)

    ctx = mp.get_context("fork")
    procs: List[mp.Process] = []
    conns = []
    t_start = time.perf_counter()
    wall = 0.0
    spout_total = 0
    spout_offsets: Dict[str, int] = {}
    latencies: List[float] = []
    exec_stats: Dict[str, dict] = {}
    deadline = time.monotonic() + (
        timeout if timeout is not None
        else 120.0 + (duration if max_batches is None else 0.0))
    try:
        for gid in gids:
            parent_conn, child_conn = ctx.Pipe(duplex=False)
            p = ctx.Process(target=_worker, args=(gid, child_conn),
                            daemon=True, name=f"procexec-{gid}")
            p.start()
            child_conn.close()
            procs.append(p)
            conns.append(parent_conn)
        if max_batches is None:
            time.sleep(duration)
            stop.set()
        pending = {c: (g, p) for c, g, p in zip(conns, gids, procs)}
        while pending:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"process backend exceeded its deadline with "
                    f"{len(pending)} worker(s) still running "
                    f"({sorted(str(g) for _, (g, _) in pending.items())}); "
                    "workers terminated, shared memory unlinked")
            for c in conn_wait(list(pending), timeout=min(remaining, 0.25)):
                gid, p = pending[c]
                try:
                    msg = c.recv()
                except EOFError:
                    pending.pop(c)
                    raise RuntimeError(
                        f"worker {gid!r} died without reporting "
                        f"(exitcode {p.exitcode})") from None
                if msg[0] == "ckpt":
                    # in-band snapshot deposit: the conn stays pending —
                    # the worker keeps running, its "ok" comes later
                    if coordinator is not None:
                        coordinator.deposit(msg[1], msg[2], payload=msg[3],
                                            aux=msg[4], offset=msg[5])
                    continue
                pending.pop(c)
                status, payload = msg
                if status == "error":
                    raise RuntimeError(
                        "process backend worker failed — " + payload)
                for rep, sp in payload["states"].items():
                    _restore_state(prep.states[rep[0]][rep[1]], sp)
                latencies.extend(payload["latencies"])
                spout_total += payload["spout_tuples"]
                spout_offsets.update(payload.get("spout_offsets", {}))
                exec_stats.update(payload.get("exec_stats", {}))
            # a silent crash (SIGKILL, segfault) leaves no pipe message
            for c, (gid, p) in list(pending.items()):
                if not p.is_alive() and not c.poll():
                    raise RuntimeError(
                        f"worker {gid!r} died without reporting "
                        f"(exitcode {p.exitcode})")
        wall = time.perf_counter() - t_start
    finally:
        stop.set()
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        for r in rings.values():
            r.close()
            r.unlink()
        try:
            ctrl.close()
            ctrl.unlink()
        except FileNotFoundError:
            pass
    return collect_result(prep, spout_total, latencies, wall,
                          spout_offsets=spout_offsets,
                          checkpoints=coordinator.completed
                          if coordinator else None,
                          exec_stats=exec_stats)


def _run_app_threads(app: StreamingApp, **kw) -> RuntimeResult:
    """Registry adapter for the default threaded backend."""
    from .runtime import run_app
    return run_app(app, **kw)


BACKENDS: Dict[str, Callable[..., RuntimeResult]] = {
    "threads": _run_app_threads,
    "processes": run_app_processes,
}


def register_backend(name: str,
                     fn: Callable[..., RuntimeResult]) -> None:
    """Register an execution backend under ``name`` for
    ``Plan.execute(backend=name)``.  The callable must accept the
    ``run_app`` keyword surface and return a
    :class:`~.runtime.RuntimeResult`."""
    BACKENDS[name] = fn


def get_backend(name: str) -> Callable[..., RuntimeResult]:
    try:
        return BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown execution backend {name!r} "
            f"(registered: {sorted(BACKENDS)})") from None
