"""Managed keyed operator state: declared, partitioned, migratable.

BriskStream's benchmark operators are stateful (WC's counter, LR's account
balances) and the paper's memory-bandwidth constraint (§3.3, ``mem_bytes``)
exists precisely because state access dominates NUMA cost — yet ad-hoc
per-kernel dicts are invisible to the planner, duplicated per replica and
silently discarded on replan.  This module makes operator state a *declared*
artefact that every layer shares:

* :class:`StateSpec` — the declaration, attached to an operator via
  ``Topology.op(state=...)``.  Three kinds:

  - ``"keyed"``  — a dense table sharded **by the operator's compiled keyed
    route**: replica ``j`` of ``k`` owns exactly the keys ``key % k == j``
    that the router delivers to it, so the keyed tuple-conservation contract
    extends to state (the ownership-union of the replica stores equals the
    single-replica store, byte for byte).
  - ``"value"``  — a private per-replica value (running aggregates, window
    history); not merged across replicas.
  - ``"broadcast"`` — a read-mostly table replicated to every replica and
    kept in sync by a broadcast-partitioned update stream (every replica
    applies the same updates in lane-FIFO order), e.g. FD's model weights.

  The declaration also *prices* the state: ``bytes_per_tuple()`` feeds the
  operator's ``mem_bytes`` (paper Table 1 ``M``) so the §3.3 bandwidth
  constraint, the fluid solver and the DES all charge state traffic from the
  declaration instead of a hand-tuned constant.

* :class:`WindowSpec` / :class:`WindowState` — declarative tumbling/sliding
  count windows (``moving_avg``-style history without hand-rolled buffers).

* Event-time windows (``WindowSpec(..., time=True)`` or the
  ``WindowSpec.time_tumbling`` / ``time_sliding`` constructors) — panes over
  an *event-time column* rather than arrival counts, fired by low-watermark
  passage (see :mod:`repro_torch.streaming.routing` for merge semantics).  The
  runtime buffer is :class:`EventTimeWindowState`: out-of-order tuples are
  held until the merged watermark passes ``pane_end + lateness``, pane
  contents are emitted in a *canonical order* (event time, then row bytes)
  so they are byte-identical no matter how arrivals were shuffled, and
  tuples arriving after their last pane fired are **counted**
  (``late_drops``), never silently discarded.  The pane-frontier arithmetic
  (:func:`pane_range`, :func:`fired_bound`) is shared with the DES so both
  layers assign tuples to panes identically.

* **Segmented pane execution** — the one firing path for every window kind.
  When a watermark (or count boundary) releases N panes, the engine builds
  *one* stacked buffer plus a segment-boundary index
  (:class:`PaneSegments`, ``reduceat``-style offsets) via a single
  vectorized gather (:func:`gather_segments`) and hands the whole
  :class:`PaneBatch` to the kernel **once**; per-pane outputs are emitted
  in canonical segment order, byte-identical to driving the kernel one
  pane at a time.  Kernels opt in with the :func:`segmented` decorator and
  read ``state.segments``; unmarked kernels keep the single-span contract
  (``state.pane``) — the runtime drives them one *segment slice* at a time
  over the same stacked buffer, so there is exactly one pane-assembly path.
  Count windows (:meth:`WindowState.tumble`) are the degenerate segmented
  case: complete windows are contiguous segments of the arrival buffer.

* **Keyed event-time panes** (``WindowSpec(..., keyed=True)``) — one pane
  group per routing key: the pane unit becomes ``(key, span)`` and the
  buffer groups rows by the *compiled keyed route's* extractor, so
  replicated keyed windowed operators fire sharded panes whose union
  equals the single-replica run's panes exactly (the PR 3 store-union
  invariant extended to panes).

* :class:`KeyedStore` / :class:`ValueStore` / :class:`BroadcastTable` — the
  runtime stores.  Kernels receive them through the dict-compatible
  :class:`OperatorState` handle (``state.managed`` / ``state.window``), so
  undeclared scratch keys keep working as plain dict entries.

* :func:`merge_keyed` / :func:`repartition_keyed` / :func:`migrate_states` —
  elastic state migration: merge the old shards by key ownership, repartition
  onto the new replica set (``Plan.replan`` then ``Plan.execute(
  initial_states=...)``), and a WC/LR run interrupted mid-stream resumes with
  byte-identical keyed state.
"""
from __future__ import annotations

import copy as _copylib
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .routing import extract_event_times, extract_keys

STATE_KINDS = ("keyed", "value", "broadcast")


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    """Count- or event-time-based window declaration.

    Count windows (the default): ``size`` tuples per window; ``slide`` is
    the hop between emitted windows (``1`` = per-tuple sliding;
    ``slide == size`` = tumbling).

    Event-time windows (``time=True``, or the :meth:`time_tumbling` /
    :meth:`time_sliding` constructors): ``size`` and ``slide`` are spans of
    the *event-time column* over the pane grid ``[k*slide, k*slide + size)``
    anchored at event time 0.  A pane fires when the operator's merged
    low-watermark (see :class:`repro_torch.streaming.routing.WatermarkMerger`)
    passes ``pane_end + lateness`` — so any arrival skew up to ``lateness``
    cannot change pane contents — and tuples whose every pane has already
    fired are *counted* (:attr:`EventTimeWindowState.late_drops`), never
    silently dropped.  ``time_by`` names the event-time column of the
    operator's input batches (column index or callable; default: column 0
    of 2-D batches, the tuple value itself for 1-D).

    Keyed event-time panes (``keyed=True``, time windows only): the pane
    unit becomes ``(key, span)`` — one pane group per routing key, fired by
    the same merged watermark.  The key extractor is the operator's
    *compiled keyed route* (the ``key_by`` declaration), so the shard that
    owns a key fires exactly the panes a single-replica run would fire for
    that key — replication preserves pane bytes, not just pane unions.
    """

    size: float
    slide: float = 1
    time: bool = False
    lateness: float = 0.0
    time_by: object = None
    keyed: bool = False

    def __post_init__(self):
        if self.keyed and not self.time:
            raise ValueError("keyed panes are an event-time concept; "
                             "declare the window with time=True")
        if self.time:
            if not self.size > 0:
                raise ValueError(
                    f"time window size must be > 0, got {self.size}")
            if not 0 < self.slide <= self.size:
                raise ValueError(
                    f"time window slide must be in (0, size={self.size}], "
                    f"got {self.slide}")
            if self.lateness < 0:
                raise ValueError(
                    f"window lateness must be >= 0, got {self.lateness}")
            return
        if self.lateness:
            raise ValueError("lateness is an event-time concept; declare "
                             "the window with time=True")
        if self.time_by is not None:
            raise ValueError("time_by is an event-time concept; declare "
                             "the window with time=True")
        if self.size < 1:
            raise ValueError(f"window size must be >= 1, got {self.size}")
        if not 1 <= self.slide <= self.size:
            raise ValueError(
                f"window slide must be in [1, size={self.size}], "
                f"got {self.slide}")

    @classmethod
    def tumbling(cls, size: int) -> "WindowSpec":
        return cls(size, slide=size)

    @classmethod
    def time_tumbling(cls, size: float, *, lateness: float = 0.0,
                      time_by: object = None,
                      keyed: bool = False) -> "WindowSpec":
        return cls(size, slide=size, time=True, lateness=lateness,
                   time_by=time_by, keyed=keyed)

    @classmethod
    def time_sliding(cls, size: float, slide: float, *,
                     lateness: float = 0.0,
                     time_by: object = None,
                     keyed: bool = False) -> "WindowSpec":
        return cls(size, slide=slide, time=True, lateness=lateness,
                   time_by=time_by, keyed=keyed)

    @property
    def is_tumbling(self) -> bool:
        return self.slide == self.size

    def bytes_per_tuple(self, item_bytes: float) -> float:
        """Window bytes charged per input tuple.

        Count windows: each emitted window touches ``size`` items and one
        window is emitted every ``slide`` tuples.  Event-time windows: one
        buffered write plus one *gathered* read per pane the tuple joins
        (``size/slide`` panes on the grid).  The segmented pane engine
        sorts the buffer once per watermark and slices every released pane
        out of the one canonical order, so lateness-held stragglers no
        longer add a per-pane re-scan share — this is how the in-flight
        pane buffer reaches the planner's ``OperatorSpec.state_bytes`` /
        ``PlanEval.state_usage`` without over-pricing the pane *batch*.
        """
        if self.time:
            return item_bytes * (1.0 + self.size / self.slide)
        return item_bytes * self.size / self.slide

    def resident_tuples(self, et_spacing: float = 1.0) -> float:
        """Buffer occupancy in *tuples* — how many rows the window holds
        resident at once, the planner-side capacity view of in-flight
        pane batches (``OperatorSpec.state_resident_tuples`` ->
        ``PlanEval.state_resident_bytes``).

        Event-time windows hold a tuple until the watermark passes its
        last pane end plus the lateness allowance: ``(size + lateness)``
        event-time units of stream, i.e. ``(size + lateness)/et_spacing``
        tuples at ``et_spacing`` event-time units per tuple (default: the
        one-tick-per-reading convention).  Count windows are the
        degenerate segmented case and hold ``size`` arrivals of history.
        Occupancy is rate-independent — pricing it per wall-second was the
        over-charge the segmented engine retires (a 64-tick pane is
        microseconds of buffering at realistic rates, not 64 seconds).
        """
        if self.time:
            return (self.size + self.lateness) / max(et_spacing, _GRID_EPS)
        return float(self.size)


# ---------------------------------------------------------------------------
# Event-time pane arithmetic — shared by the runtime window state and the DES
# ---------------------------------------------------------------------------

_GRID_EPS = 1e-9


def pane_range(ets: np.ndarray, size: float,
               slide: float) -> Tuple[np.ndarray, np.ndarray]:
    """Inclusive pane-index range ``[k_lo, k_hi]`` containing each event
    time: pane ``k`` spans ``[k*slide, k*slide + size)`` on the grid
    anchored at 0.  The same arithmetic assigns tuples to panes in the
    threaded runtime and paces pane firing in the DES, which is what the
    runtime==DES pane-assignment equivalence tests pin down."""
    ets = np.asarray(ets, dtype=np.float64)
    k_hi = np.floor(ets / slide + _GRID_EPS).astype(np.int64)
    k_lo = np.floor((ets - size) / slide + _GRID_EPS).astype(np.int64) + 1
    return np.maximum(k_lo, 0), k_hi


def grid_pane_ends(lo: float, hi: float, size: float,
                   slide: float) -> np.ndarray:
    """Grid pane ends ``e = k*slide + size`` with ``lo < e <= hi`` (k >= 0).
    The DES walks this grid to fire panes as unit watermarks advance."""
    if not hi > lo or math.isinf(hi):
        return np.zeros(0)
    k1 = math.floor((hi - size) / slide + _GRID_EPS)
    k0 = max(0, math.floor((lo - size) / slide + _GRID_EPS) + 1) \
        if math.isfinite(lo) else 0
    if k1 < k0:
        return np.zeros(0)
    return np.arange(k0, k1 + 1, dtype=np.float64) * slide + size


# ---------------------------------------------------------------------------
# Segmented pane execution — the one firing path for every window kind
# ---------------------------------------------------------------------------


def segmented(kernel):
    """Mark a kernel as *segment-aware*.

    When a watermark releases N panes, the runtime invokes a segmented
    kernel **once** over the stacked buffer of all N panes with
    ``state.segments`` (:class:`PaneSegments`) set — ``reduceat`` over
    ``state.segments.starts`` is the idiomatic per-pane aggregate — and the
    kernel must emit its per-pane outputs in segment order (the engine's
    canonical pane order), which makes the one call byte-identical to the
    pane-at-a-time contract.  Unmarked kernels keep the single-span
    contract: the runtime drives them one segment slice at a time with
    ``state.pane`` set (the compat shim over the same stacked buffer).
    """
    kernel.segmented = True
    return kernel


def gather_segments(rows: np.ndarray, los: np.ndarray, his: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Build one stacked buffer from segment ranges ``[los[i], his[i])`` of
    ``rows`` — the single vectorized gather behind every pane flush.

    Returns ``(stacked, offsets)`` where segment ``i`` is
    ``stacked[offsets[i]:offsets[i+1]]``.  Adjacent-contiguous ranges
    (tumbling panes, count windows) are returned as one zero-copy slice;
    overlapping ranges (sliding panes share rows) gather through a single
    fancy index built arithmetically — no per-pane python loop either way.
    """
    los = np.asarray(los, dtype=np.int64)
    his = np.asarray(his, dtype=np.int64)
    lens = his - los
    offsets = np.zeros(len(los) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    if len(los) and np.array_equal(los[1:], his[:-1]):
        return rows[los[0]:his[-1]], offsets          # contiguous: no copy
    total = int(offsets[-1])
    idx = np.arange(total, dtype=np.int64) + np.repeat(los - offsets[:-1],
                                                       lens)
    return rows[idx], offsets


class PaneSegments:
    """Segment-boundary index over one stacked pane buffer.

    ``offsets`` — ``(n+1,)`` int64 boundaries: segment ``i`` spans rows
    ``[offsets[i], offsets[i+1])`` of the stacked buffer (``reduceat``
    convention: ``starts`` is the argument ``np.<op>.reduceat`` wants).
    ``spans``   — ``(n, 2)`` float64 ``(start, end)`` pane span per segment
    (event-time units for time windows, arrival indices for count windows).
    ``keys``    — ``(n,)`` int64 pane-group key per segment for keyed
    event-time windows, else ``None``.
    """

    __slots__ = ("offsets", "spans", "keys")

    def __init__(self, offsets: np.ndarray, spans: np.ndarray,
                 keys: Optional[np.ndarray] = None):
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.spans = np.asarray(spans, dtype=np.float64).reshape(-1, 2)
        self.keys = None if keys is None else np.asarray(keys, np.int64)

    @property
    def n(self) -> int:
        return len(self.offsets) - 1

    @property
    def starts(self) -> np.ndarray:
        """Segment start offsets — feed straight into ``np.add.reduceat``
        and friends for one-call per-pane aggregates."""
        return self.offsets[:-1]

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def span(self, i: int) -> Tuple[float, float]:
        return (float(self.spans[i, 0]), float(self.spans[i, 1]))


class PaneBatch:
    """Every pane one watermark (or count boundary) released, stacked.

    ``rows`` is the one gathered buffer, ``segments`` the boundary index,
    ``t0s`` the per-pane oldest wall arrival (latency accounting).
    Iterating yields the classic pane-at-a-time view ``(rows_i, t0_i,
    (start, end))`` in canonical order — segment slices of the same
    buffer, so the compat contract and the segmented contract cannot
    drift apart.
    """

    __slots__ = ("rows", "segments", "t0s")

    def __init__(self, rows: np.ndarray, segments: PaneSegments,
                 t0s: np.ndarray):
        self.rows = rows
        self.segments = segments
        self.t0s = np.asarray(t0s, dtype=np.float64)

    @classmethod
    def empty(cls) -> "PaneBatch":
        return cls(np.zeros(0), PaneSegments(np.zeros(1, np.int64),
                                             np.zeros((0, 2))), np.zeros(0))

    @property
    def n(self) -> int:
        return self.segments.n

    @property
    def t0(self) -> float:
        """Oldest wall arrival over the batch — the flush timestamp."""
        return float(self.t0s.min()) if len(self.t0s) else 0.0

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        off = self.segments.offsets
        for i in range(self.n):
            yield (self.rows[off[i]:off[i + 1]], float(self.t0s[i]),
                   self.segments.span(i))


@dataclasses.dataclass(frozen=True)
class StateSpec:
    """Declared operator state (see module docstring for the three kinds).

    ``item_bytes``  — bytes charged per state access, as profiled (cache-line
                      -fraction granularity, the paper's ``M`` provenance).
    ``reads_per_tuple`` / ``writes_per_tuple`` — average state touches per
                      processed tuple.
    ``key_space``   — dense table size (required for "keyed", optional
                      sizing hint for "broadcast").
    ``dtype``/``fill`` — table element type and initial value.
    ``init``        — factory for the initial table/value (overrides
                      ``fill``; required shape ``(key_space,)`` for keyed).
    ``window``      — optional :class:`WindowSpec`; its history scan is
                      added to ``bytes_per_tuple``.
    """

    kind: str
    item_bytes: float = 8.0
    reads_per_tuple: float = 1.0
    writes_per_tuple: float = 1.0
    key_space: Optional[int] = None
    dtype: object = np.float64
    fill: float = 0.0
    init: Optional[Callable[[], np.ndarray]] = None
    window: Optional[WindowSpec] = None

    def __post_init__(self):
        if self.kind not in STATE_KINDS:
            raise ValueError(
                f"unknown state kind {self.kind!r} "
                f"(choose from {STATE_KINDS})")
        if self.item_bytes <= 0:
            raise ValueError("state item_bytes must be positive")
        if self.reads_per_tuple < 0 or self.writes_per_tuple < 0:
            raise ValueError("state reads/writes per tuple must be >= 0")
        if self.kind == "keyed" and (self.key_space is None
                                     or self.key_space < 1):
            raise ValueError(
                "keyed state requires key_space= (the dense table size the "
                "compiled route's keys index into)")

    def bytes_per_tuple(self) -> float:
        """State traffic per processed tuple, charged into ``mem_bytes``."""
        b = self.item_bytes * (self.reads_per_tuple + self.writes_per_tuple)
        if self.window is not None:
            b += self.window.bytes_per_tuple(self.item_bytes)
        return b

    def resident_tuples(self) -> float:
        """Tuples held resident in declared window buffers — the
        planner-side occupancy of in-flight pane batches
        (``OperatorSpec.state_resident_tuples`` /
        ``PlanEval.state_resident_bytes``)."""
        return self.window.resident_tuples() if self.window is not None \
            else 0.0

    def initial_table(self) -> np.ndarray:
        if self.init is not None:
            return np.asarray(self.init()).copy()
        assert self.key_space is not None
        return np.full(self.key_space, self.fill, dtype=self.dtype)


# ---------------------------------------------------------------------------
# Runtime stores
# ---------------------------------------------------------------------------


class KeyedStore:
    """Dense keyed table sharded exactly like the operator's keyed route.

    Shard ``shard`` of ``n_shards`` owns keys ``key % n_shards == shard`` —
    the same assignment :func:`repro_torch.streaming.routing.split_by_key` makes —
    so under keyed routing each key is only ever touched by its owner and
    :func:`merge_keyed` reconstructs the single-replica store exactly.
    """

    __slots__ = ("spec", "n_shards", "shard", "table")

    def __init__(self, spec: StateSpec, n_shards: int = 1, shard: int = 0,
                 table: Optional[np.ndarray] = None):
        assert spec.kind == "keyed"
        assert 0 <= shard < n_shards
        self.spec = spec
        self.n_shards = n_shards
        self.shard = shard
        self.table = spec.initial_table() if table is None else table
        if len(self.table) != spec.key_space:
            raise ValueError(
                f"keyed table has {len(self.table)} entries for "
                f"key_space={spec.key_space}")

    def owned_mask(self) -> np.ndarray:
        return np.arange(len(self.table)) % self.n_shards == self.shard

    def get(self, keys: np.ndarray) -> np.ndarray:
        return self.table[keys]

    def add(self, keys: np.ndarray, amounts=1) -> None:
        np.add.at(self.table, keys, amounts)

    def put(self, keys: np.ndarray, values) -> None:
        self.table[keys] = values

    def snapshot(self) -> np.ndarray:
        return self.table.copy()

    def __repr__(self) -> str:
        return (f"KeyedStore(shard {self.shard}/{self.n_shards}, "
                f"{len(self.table)} keys)")


class ValueStore:
    """Private per-replica value (running aggregate, model residuals, ...)."""

    __slots__ = ("spec", "value")

    def __init__(self, spec: StateSpec):
        assert spec.kind == "value"
        self.spec = spec
        self.value = spec.init() if spec.init is not None else None


class BroadcastTable:
    """Read-replicated table, synced by a broadcast update stream.

    Every replica receives every update (broadcast partitioning), and
    ``load`` applies them *last-writer-wins by version*: an update older
    than the installed one is ignored.  Since all replicas eventually see
    the same update set, they converge to the same (data, version) no
    matter how updates from concurrent producers interleave — replicas may
    differ transiently mid-stream, but drained runs end identical, which is
    what ``migrate_states`` relies on when it copies one replica's table.
    """

    __slots__ = ("spec", "data", "version")

    def __init__(self, spec: StateSpec,
                 data: Optional[np.ndarray] = None, version: int = 0):
        assert spec.kind == "broadcast"
        self.spec = spec
        if data is not None:
            self.data = data
        elif spec.init is not None:
            self.data = np.asarray(spec.init()).copy()
        elif spec.key_space is not None:
            self.data = np.full(spec.key_space, spec.fill, dtype=spec.dtype)
        else:
            self.data = None
        self.version = version

    def load(self, data: np.ndarray, version: Optional[int] = None) -> None:
        """Install an update.  ``version=None`` bumps the local counter
        (single-producer streams); versioned updates below the installed
        version are stale and dropped."""
        if version is not None and int(version) < self.version:
            return
        self.data = np.asarray(data).copy()
        self.version = self.version + 1 if version is None else int(version)


class WindowState:
    """Runtime buffer behind a :class:`WindowSpec`.

    ``slide(batch)`` is the vectorized per-tuple sliding path (slide == 1):
    returns ``concat(history, batch)`` — one aggregate per input tuple over
    the trailing ``size`` values — and retains the last ``size`` values,
    exactly the seed ``moving_avg`` convention (history starts as zeros).

    ``tumble(batch)`` is the general hop path: buffers tuples and returns
    every complete window (``size`` rows, advancing by ``slide``).  It is
    the degenerate segmented case — :meth:`tumble_segments` builds the
    stacked buffer + boundary index through the same
    :func:`gather_segments` path event-time panes use, and ``tumble``
    merely splits it back out.
    """

    __slots__ = ("spec", "_hist", "_buf", "_base")

    def __init__(self, spec: WindowSpec, dtype=np.float64):
        self.spec = spec
        self._hist = np.zeros(spec.size, dtype=dtype)
        self._buf: Optional[np.ndarray] = None
        self._base = 0                      # arrival index of _buf[0]

    def slide(self, batch: np.ndarray) -> np.ndarray:
        if self.spec.slide != 1:
            raise ValueError(
                f"slide() is the per-tuple sliding path (slide=1); this "
                f"window hops by {self.spec.slide} — use tumble()")
        vals = np.concatenate([self._hist, batch])
        self._hist = vals[-self.spec.size:]
        return vals

    def tumble_segments(self, batch: np.ndarray
                        ) -> Tuple[np.ndarray, PaneSegments]:
        """Segmented count-window flush: every complete window as one
        stacked buffer + boundary index (spans are arrival-index ranges).
        Segment-aware kernels consume this directly; :meth:`tumble` is the
        pane-at-a-time view of the same result."""
        buf = batch if self._buf is None else \
            np.concatenate([self._buf, batch])
        size, hop = int(self.spec.size), int(self.spec.slide)
        m = max(0, (len(buf) - size) // hop + 1) if len(buf) >= size else 0
        los = np.arange(m, dtype=np.int64) * hop
        stacked, offsets = gather_segments(buf, los, los + size)
        spans = np.stack([los + self._base, los + self._base + size],
                         axis=1).astype(np.float64) if m else \
            np.zeros((0, 2))
        self._buf = buf[m * hop:]
        self._base += m * hop
        return stacked, PaneSegments(offsets, spans)

    def tumble(self, batch: np.ndarray) -> List[np.ndarray]:
        stacked, seg = self.tumble_segments(batch)
        return [stacked[a:b].copy()
                for a, b in zip(seg.offsets[:-1], seg.offsets[1:])]


class EventTimeWindowState:
    """Runtime buffer behind an event-time :class:`WindowSpec`.

    Out-of-order tuples are buffered with their event times and wall-clock
    arrival stamps; :meth:`on_watermark` fires every non-empty pane whose
    end the merged watermark has passed by ``lateness`` — as **one**
    :class:`PaneBatch`: a stacked buffer plus segment boundaries, built by
    a single canonical sort and one vectorized gather, never a per-pane
    loop.  Fired pane rows sit in a *canonical order* — ascending event
    time, ties broken by the full row contents; panes ordered by
    ``(end, key)`` — so pane bytes are identical no matter how arrivals
    were permuted within the lateness bound.  Tuples whose every pane has
    already fired are counted in :attr:`late_drops` and never silently
    discarded.  Event times must be >= 0 (the pane grid anchors at 0).

    Keyed pane groups (``spec.keyed``): :attr:`key_by` holds the compiled
    keyed route's extractor (the runtime attaches it, column 0 by the
    historical convention when ``None``); the buffer groups rows by key and
    each ``(key, span)`` pair is its own segment, so a key's pane bytes
    depend only on that key's rows — replication by the keyed route cannot
    change them.
    """

    __slots__ = ("spec", "key_by", "_pending", "_ets", "_rows", "_t0s",
                 "_keys", "_fired_bound", "late_drops", "panes_fired")

    def __init__(self, spec: WindowSpec, key_by=None):
        # (no dtype parameter: pane rows keep the arriving batches' dtype,
        # unlike the count WindowState whose history buffer needs one)
        assert spec.time, "EventTimeWindowState requires a time window"
        self.spec = spec
        self.key_by = key_by
        self._pending: List[tuple] = []
        self._ets: Optional[np.ndarray] = None
        self._rows: Optional[np.ndarray] = None
        self._t0s: Optional[np.ndarray] = None
        self._keys: Optional[np.ndarray] = None
        self._fired_bound = -math.inf     # every pane end <= this has fired
        self.late_drops = 0
        self.panes_fired = 0

    def insert(self, arr: np.ndarray, t0: float = 0.0) -> int:
        """Buffer a batch (``t0`` = wall arrival, for pane latency
        accounting downstream).  Returns the number of late tuples —
        counted in :attr:`late_drops`, excluded from the buffer."""
        ets = extract_event_times(arr, self.spec.time_by)
        if len(ets) and float(ets.min()) < 0:
            raise ValueError("event times must be >= 0 (the pane grid "
                             "anchors at event time 0)")
        _, k_hi = pane_range(ets, self.spec.size, self.spec.slide)
        last_end = k_hi * self.spec.slide + self.spec.size
        late = last_end <= self._fired_bound
        n_late = int(late.sum())
        if n_late:
            self.late_drops += n_late
            keep = ~late
            arr, ets = arr[keep], ets[keep]
        if len(arr):
            keys = extract_keys(arr, self.key_by) if self.spec.keyed \
                else None
            self._pending.append((ets, arr, np.full(len(arr), float(t0)),
                                  keys))
        return n_late

    def _compact(self) -> None:
        if not self._pending:
            return
        chunks = self._pending
        self._pending = []
        if self._ets is not None and len(self._ets):
            chunks.insert(0, (self._ets, self._rows, self._t0s, self._keys))
        self._ets = np.concatenate([c[0] for c in chunks])
        self._rows = np.concatenate([c[1] for c in chunks])
        self._t0s = np.concatenate([c[2] for c in chunks])
        self._keys = np.concatenate([c[3] for c in chunks]) \
            if self.spec.keyed else None

    def _canonical_order(self) -> np.ndarray:
        """Deterministic buffer order: (key,) event time, then row
        contents — one stable sort from which every pane is a contiguous
        slice."""
        rows = self._rows
        if rows.ndim == 1:
            keys: Tuple[np.ndarray, ...] = (rows, self._ets)
        else:
            keys = tuple(rows[:, c] for c in range(rows.shape[1] - 1, -1, -1)
                         ) + (self._ets,)
        if self._keys is not None:
            keys = keys + (self._keys,)
        return np.lexsort(keys)

    def _group_bounds(self) -> List[Tuple[int, int, int]]:
        """Key-group slices ``(key, lo, hi)`` of the canonically sorted
        buffer (one pseudo-group spanning everything when unkeyed)."""
        if self._keys is None:
            return [(0, 0, len(self._ets))]
        cuts = np.flatnonzero(self._keys[1:] != self._keys[:-1]) + 1
        bounds = np.concatenate([[0], cuts, [len(self._keys)]])
        return [(int(self._keys[lo]), int(lo), int(hi))
                for lo, hi in zip(bounds[:-1], bounds[1:])]

    def on_watermark(self, wm: float) -> PaneBatch:
        """Fire every pane the watermark has passed, as one
        :class:`PaneBatch`.

        Segments arrive in canonical pane order — ascending ``(end, key)``
        — each with the earliest wall arrival among its rows
        (``PaneBatch.t0s``), so downstream latency includes the time spent
        waiting for completeness.  A ``+inf`` watermark (end of stream)
        flushes every buffered pane.  Iterating the batch recovers the
        pane-at-a-time view; there is no other firing path.
        """
        size, slide = self.spec.size, self.spec.slide
        bound = wm - self.spec.lateness
        if not bound > self._fired_bound:
            return PaneBatch.empty()
        if not math.isinf(bound):
            # grid early-out: no pane end lies in (fired_bound, bound] —
            # advance the frontier without touching the buffer (identical
            # late/retention classification: both compare against grid
            # ends, and none sits between the two bounds)
            k_last_q = math.floor((bound - size) / slide + _GRID_EPS)
            k_base_q = 0 if math.isinf(self._fired_bound) else max(
                0, math.floor((self._fired_bound - size) / slide
                              + _GRID_EPS) + 1)
            if k_last_q < k_base_q:
                self._fired_bound = bound
                return PaneBatch.empty()
        self._compact()
        if self._ets is None or not len(self._ets):
            self._fired_bound = bound
            return PaneBatch.empty()
        # one canonical sort; panes are then contiguous (key-group, et)
        # ranges, sliced by searchsorted instead of a mask per pane
        order = self._canonical_order()
        ets = self._ets = self._ets[order]
        rows = self._rows = self._rows[order]
        t0s = self._t0s = self._t0s[order]
        if self._keys is not None:
            self._keys = self._keys[order]
        _, k_hi = pane_range(ets, size, slide)
        if math.isinf(bound):
            k_last = int(k_hi.max())
        else:
            k_last = math.floor((bound - size) / slide + _GRID_EPS)
        k_base = 0 if math.isinf(self._fired_bound) else max(
            0, math.floor((self._fired_bound - size) / slide + _GRID_EPS) + 1)
        seg_lo: List[np.ndarray] = []
        seg_hi: List[np.ndarray] = []
        seg_end: List[np.ndarray] = []
        seg_key: List[np.ndarray] = []
        for key, glo, ghi in self._group_bounds():
            g_ets = ets[glo:ghi]
            k_first = max(k_base, int(pane_range(g_ets[:1], size,
                                                 slide)[0][0]))
            if k_last < k_first:
                continue
            ends = np.arange(k_first, k_last + 1) * slide + size
            los = glo + np.searchsorted(g_ets, ends - size, side="left")
            his = glo + np.searchsorted(g_ets, ends, side="left")
            mask = his > los                           # no empty panes
            if mask.any():
                seg_lo.append(los[mask])
                seg_hi.append(his[mask])
                seg_end.append(ends[mask])
                seg_key.append(np.full(int(mask.sum()), key, np.int64))
        self._fired_bound = bound
        if seg_lo:
            los = np.concatenate(seg_lo)
            his = np.concatenate(seg_hi)
            ends = np.concatenate(seg_end)
            skeys = np.concatenate(seg_key)
            # per-pane oldest arrival without a second gather: reduceat
            # over (lo, hi) index pairs reduces [lo, hi) at even slots —
            # odd slots (inter-pane gaps, possibly reversed for sliding
            # overlaps) are discarded.  A sentinel element keeps hi ==
            # len(t0s) a legal reduceat index (several trailing panes can
            # share it); even-slot slices never read it
            pairs = np.empty(2 * len(los), np.int64)
            pairs[0::2] = los
            pairs[1::2] = his
            t0s_ext = np.concatenate([t0s, t0s[-1:]])
            pane_t0s = np.minimum.reduceat(t0s_ext, pairs)[0::2]
            # canonical pane order across key groups: (end, key)
            order = np.lexsort((skeys, ends))
            los, his, ends, skeys, pane_t0s = (
                los[order], his[order], ends[order], skeys[order],
                pane_t0s[order])
            stacked, offsets = gather_segments(rows, los, his)
            batch = PaneBatch(
                stacked,
                PaneSegments(offsets,
                             np.stack([ends - size, ends], axis=1),
                             skeys if self.spec.keyed else None),
                pane_t0s)
        else:
            batch = PaneBatch.empty()
        self.panes_fired += batch.n
        keep = (k_hi * slide + size) > self._fired_bound
        self._ets = ets[keep].copy()
        self._rows = rows[keep].copy()
        self._t0s = t0s[keep].copy()
        if self._keys is not None:
            self._keys = self._keys[keep].copy()
        return batch


class OperatorState(dict):
    """Per-replica state handle a kernel receives.

    A plain ``dict`` for undeclared scratch keys (the seed convention keeps
    working), plus the declared artefacts:

    ``managed`` — :class:`KeyedStore` / :class:`ValueStore` /
    :class:`BroadcastTable` per the operator's :class:`StateSpec`;
    ``window`` — :class:`WindowState` (count) or
    :class:`EventTimeWindowState` (time) when the spec declares one;
    ``segments`` — the :class:`PaneSegments` index of the stacked pane
    buffer a :func:`segmented` kernel is invoked on (None outside a
    segmented firing);
    ``pane`` — the ``(start, end)`` event-time span of the pane a
    single-span kernel is currently invoked on (the compat shim; None for
    segmented invocations with more than one segment);
    ``replica`` / ``fanout`` — this replica's position in the operator.
    """

    managed: Optional[object]
    window: Optional[object]

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.managed = None
        self.window = None
        self.pane = None
        self.segments = None
        self.replica = 0
        self.fanout = 1


def make_operator_state(spec: Optional[StateSpec], fanout: int = 1,
                        replica: int = 0, key_by=None) -> OperatorState:
    """Build one replica's state handle from its declaration (or a bare
    dict-compatible handle when no state is declared).  ``key_by`` is the
    operator's compiled keyed-route extractor — keyed pane groups
    (``WindowSpec(keyed=True)``) shard by exactly the key the router
    splits on."""
    st = OperatorState()
    st.replica, st.fanout = replica, fanout
    if spec is None:
        return st
    if spec.window is not None:
        st.window = EventTimeWindowState(spec.window, key_by=key_by) \
            if spec.window.time \
            else WindowState(spec.window, dtype=spec.dtype)
    if spec.kind == "keyed":
        st.managed = KeyedStore(spec, n_shards=fanout, shard=replica)
    elif spec.kind == "broadcast":
        st.managed = BroadcastTable(spec)
    else:
        st.managed = ValueStore(spec)
    return st


# ---------------------------------------------------------------------------
# Elastic migration: merge by ownership, repartition onto the new replica set
# ---------------------------------------------------------------------------


def merge_keyed(stores: Sequence[KeyedStore]) -> np.ndarray:
    """Union of keyed shards by ownership: entry ``key`` comes from the shard
    with ``key % n_shards == shard``.  Under route-aligned keyed execution
    this equals the single-replica table byte for byte."""
    if not stores:
        raise ValueError("merge_keyed needs at least one shard")
    spec = stores[0].spec
    merged = spec.initial_table()
    for s in stores:
        if s.spec.key_space != spec.key_space:
            raise ValueError("cannot merge keyed stores of different "
                             "key spaces")
        mask = s.owned_mask()
        merged[mask] = s.table[mask]
    return merged


def repartition_keyed(spec: StateSpec, merged: np.ndarray,
                      n_shards: int) -> List[KeyedStore]:
    """Split a merged table onto ``n_shards`` new owners; entries outside a
    shard's residue class reset to the initial value (they are unreachable
    under the new route and must not leak into a later merge)."""
    fresh = spec.initial_table()
    out = []
    for j in range(n_shards):
        table = fresh.copy()
        mask = np.arange(len(merged)) % n_shards == j
        table[mask] = merged[mask]
        out.append(KeyedStore(spec, n_shards=n_shards, shard=j, table=table))
    return out


# ---------------------------------------------------------------------------
# Snapshot payloads: one replica's state as plain picklable data
# ---------------------------------------------------------------------------


def state_payload(st: OperatorState, *, copy: bool = False) -> dict:
    """Reduce one replica's state handle to plain picklable data.

    Ships arrays and scalars only — managed store tables, window buffers
    (compacted), scratch dict entries, the late/pane counters — never the
    stores themselves (their specs can hold closure ``init`` factories,
    which fork inherits but pickle rejects).

    ``copy=True`` deep-copies every array and scratch value: required for
    *live* snapshots (checkpoint barriers), where the run keeps mutating
    tables and buffers after the payload is taken.  The process backend's
    end-of-run hand-off keeps ``copy=False`` — the worker is done with the
    state, so aliasing is safe and cheaper.
    """
    scratch = dict(st)
    if copy:
        scratch = _copylib.deepcopy(scratch)
    p: dict = {"scratch": scratch}

    def _arr(a):
        if copy and isinstance(a, np.ndarray):
            return a.copy()
        return a

    m = st.managed
    if isinstance(m, KeyedStore):
        p["managed"] = ("keyed", _arr(m.table))
    elif isinstance(m, BroadcastTable):
        p["managed"] = ("broadcast", _arr(m.data), m.version)
    elif isinstance(m, ValueStore):
        p["managed"] = ("value",
                        _copylib.deepcopy(m.value) if copy else m.value)
    w = st.window
    if isinstance(w, EventTimeWindowState):
        w._compact()
        p["window"] = ("et", _arr(w._ets), _arr(w._rows), _arr(w._t0s),
                       _arr(w._keys), w._fired_bound, w.late_drops,
                       w.panes_fired)
    elif isinstance(w, WindowState):
        p["window"] = ("count", _arr(w._hist), _arr(w._buf), w._base)
    return p


def restore_state(st: OperatorState, payload: dict) -> None:
    """Install a payload onto a matching handle, in place — the handle
    keeps its spec, shard identity and key extractor, so
    ``migrate_states`` and the result assembly read it exactly as if the
    snapshot had never crossed a process (or checkpoint) boundary."""
    st.clear()
    st.update(payload["scratch"])
    m = payload.get("managed")
    if m is not None:
        kind = m[0]
        if kind == "keyed":
            st.managed.table = m[1]
        elif kind == "broadcast":
            st.managed.data = m[1]
            st.managed.version = m[2]
        else:
            st.managed.value = m[1]
    w = payload.get("window")
    if w is not None:
        if w[0] == "et":
            win = st.window
            win._pending = []
            (win._ets, win._rows, win._t0s, win._keys,
             win._fired_bound, win.late_drops, win.panes_fired) = w[1:]
        else:
            win = st.window
            win._hist, win._buf, win._base = w[1:]


class UndeclaredStateError(RuntimeError):
    """``migrate_states(audit=True)`` found non-empty undeclared scratch
    state that would be silently left behind by the migration."""


def _has_content(value) -> bool:
    if value is None:
        return False
    if isinstance(value, np.ndarray):
        return value.size > 0 and bool(np.any(value))
    try:
        return bool(value)
    except Exception:
        return True


def migrate_states(app, states: Dict[str, List[OperatorState]],
                   parallelism: Dict[str, int], *, audit: bool = False
                   ) -> Dict[str, List[OperatorState]]:
    """Repartition a finished run's states onto a new replica set.

    The elastic half of ``Plan.replan``: ``keyed`` stores are merged by key
    ownership and re-sharded to the new fan-out; ``broadcast`` tables are
    copied to every new replica (replicas are identical by construction);
    ``value`` states are per-replica by definition — the first
    ``min(k_old, k_new)`` replicas carry over, the rest start fresh.
    Undeclared dict scratch state does not migrate (declare it if it must
    survive a replan).  Feed the result to ``run_app(initial_states=...)`` /
    ``Plan.execute(initial_states=...)``.

    ``audit=True`` raises :class:`UndeclaredStateError` when any replica
    holds non-empty undeclared dict scratch entries — the ROADMAP's audit
    mode for apps that forgot to declare.  Metric counters ("seen" tallies
    and the like) count too: they are state the migration loses, and the
    audit's job is to make that loss explicit, not to guess which keys were
    disposable.
    """
    specs: Dict[str, StateSpec] = getattr(app, "state", {}) or {}
    if audit:
        leftover = []
        for name in app.graph.operators:
            for j, st in enumerate(states.get(name, [])):
                keys = sorted(k for k, v in dict(st).items()
                              if _has_content(v))
                if keys:
                    leftover.append(f"{name}#{j}: {keys}")
        if leftover:
            raise UndeclaredStateError(
                "non-empty undeclared scratch state would not survive this "
                "migration (declare it via Topology.op(state=StateSpec(...))"
                " or drop it before migrating): " + "; ".join(leftover))
    out: Dict[str, List[OperatorState]] = {}
    for name in app.graph.operators:
        k_new = parallelism.get(name, 1)
        spec = specs.get(name)
        old = states.get(name, [])
        fresh = [make_operator_state(spec, k_new, j) for j in range(k_new)]
        if spec is None or not old:
            out[name] = fresh
            continue
        if spec.kind == "keyed":
            merged = merge_keyed([st.managed for st in old
                                  if st.managed is not None])
            shards = repartition_keyed(spec, merged, k_new)
            for st, shard in zip(fresh, shards):
                st.managed = shard
        elif spec.kind == "broadcast":
            src = old[0].managed
            for st in fresh:
                st.managed = BroadcastTable(
                    spec,
                    data=None if src.data is None else src.data.copy(),
                    version=src.version)
        else:                                   # value: best-effort carry
            for j in range(min(len(old), k_new)):
                fresh[j].managed = old[j].managed
                if not isinstance(old[j].window, EventTimeWindowState):
                    fresh[j].window = old[j].window
        if spec.window is not None and spec.window.time:
            _carry_event_windows(old, fresh)
        out[name] = fresh
    return out


def _carry_event_windows(old: List[OperatorState],
                         fresh: List[OperatorState]) -> None:
    """Carry event-time pane buffers and the watermark frontier across a
    migration.

    Buffered (not-yet-fired) rows, the fired frontier and the late/pane
    counters are state exactly like a keyed table: dropping them loses
    every out-of-order tuple still waiting inside its lateness bound, so a
    migrated run would fire a different pane multiset than an
    uninterrupted one.  Keyed pane groups merge all old replicas' buffers
    and reshard rows by ``key % k_new`` (the compiled keyed route's
    ownership); unkeyed windows carry index-wise at equal fan-out and
    collapse onto replica 0 otherwise.  The frontier carries as the max
    over replicas — under quiesced migration every replica saw the same
    merged watermark, so the max equals each.  Suspend the old run with
    ``final_watermark=False`` (otherwise the end-of-stream ``+inf`` mark
    has already fired every pane and there is nothing left to carry).
    """
    wins = [st.window for st in old
            if isinstance(st.window, EventTimeWindowState)]
    if not wins:
        return
    for w in wins:
        w._compact()
    fired = max(w._fired_bound for w in wins)
    if fired == math.inf:
        # fully drained run: the end-of-stream +inf mark already fired
        # every pane and emptied the buffers — nothing to carry, and a
        # carried +inf frontier would classify the entire next stream as
        # late.  Migrated windows start fresh (the pre-suspend contract).
        return
    total_late = sum(w.late_drops for w in wins)
    total_panes = sum(w.panes_fired for w in wins)
    keyed = wins[0].spec.keyed
    chunks = [(w._ets, w._rows, w._t0s, w._keys) for w in wins
              if w._ets is not None and len(w._ets)]
    if chunks:
        ets = np.concatenate([c[0] for c in chunks])
        rows = np.concatenate([c[1] for c in chunks])
        t0s = np.concatenate([c[2] for c in chunks])
        keys = np.concatenate([c[3] for c in chunks]) if keyed else None
    else:
        ets = rows = t0s = keys = None
    k_new = len(fresh)
    index_wise = not keyed and k_new == len(old) and len(wins) == len(old)
    for j, st in enumerate(fresh):
        win = st.window
        if not isinstance(win, EventTimeWindowState):
            continue
        win._fired_bound = fired
        if index_wise:
            src = old[j].window
            win._fired_bound = src._fired_bound
            if src._ets is not None and len(src._ets):
                win._ets = src._ets.copy()
                win._rows = src._rows.copy()
                win._t0s = src._t0s.copy()
                win._keys = src._keys.copy() if src._keys is not None \
                    else None
            win.late_drops = src.late_drops
            win.panes_fired = src.panes_fired
            continue
        if ets is None:
            continue
        if keyed and k_new > 1:
            mask = keys % k_new == j
            win._ets = ets[mask].copy()
            win._rows = rows[mask].copy()
            win._t0s = t0s[mask].copy()
            win._keys = keys[mask].copy()
        elif j == 0:
            win._ets = ets.copy()
            win._rows = rows.copy()
            win._t0s = t0s.copy()
            win._keys = keys.copy() if keys is not None else None
    if not index_wise:
        # counters live on replica 0: RuntimeResult sums over replicas
        w0 = fresh[0].window
        if isinstance(w0, EventTimeWindowState):
            w0.late_drops = total_late
            w0.panes_fired = total_panes
