"""The four benchmark applications (paper §6.1, Appendix B), declared through
the :class:`repro_torch.streaming.api.Topology` builder.

Each factory returns a built :class:`StreamingApp` — logical graph, compute
kernels (operating on *jumbo batches*, arrays of tuples), spout sources,
partition declarations and *managed state* all come from one fluent
declaration, so the same object feeds planning (``Job(...).plan``), the
simulators, and the real threaded runtime.

Stateful operators declare :class:`~repro_torch.streaming.state.StateSpec` instead
of mutating ad-hoc dicts: WC's counter and LR's account table are keyed
stores sharded exactly like their keyed routes (so replica stores union to
the single-replica store and survive a replan via
``repro_torch.streaming.state.migrate_states``); SD's moving average is a
declarative sliding window; FD's model weights are a broadcast-replicated
table kept in sync by a dedicated model-sync stream.  The operators'
``mem_bytes`` (paper Table 1 ``M``) are *derived* from these declarations —
``tuple_bytes + state.bytes_per_tuple()`` — rather than hand-tuned.

Profile provenance: the per-tuple execution times anchor on the paper's
measurements where given — WC Splitter 1612.8 ns and Counter 612.3 ns local
(Table 3) — and on Fig. 8's qualitative statements (Parser has little
computation; BriskStream's T^e is 5–24% of Storm's) for the rest.  LR's
per-stream selectivities (paper Table 8 is not included in the text) are
plausible values documented here as assumptions; state access weights
(``item_bytes`` x reads/writes, cache-line-fraction granularity) are chosen
to reproduce the same profiled ``M`` the seed asserted as constants.
"""
from __future__ import annotations

import collections
import threading
import time

import numpy as np
import torch

from repro_torch.kernels.ref import mlp_ref

from .api import StreamingApp, Topology
from .state import StateSpec, WindowSpec, segmented

__all__ = ["ALL_APPS", "StreamingApp", "word_count", "fraud_detection",
           "spike_detection", "spike_detection_eventtime",
           "spike_detection_keyed", "linear_road", "shuffle_within_skew",
           "streaming_inference", "inf_model_weights", "chain_pipeline"]


# ---------------------------------------------------------------------------
# Word Count (Fig. 2): spout -> parser -> splitter -> counter -> sink
# ---------------------------------------------------------------------------

WC_VOCAB = 4096
WC_WORDS_PER_SENTENCE = 10     # "a sentence with ten random words"


def word_count() -> StreamingApp:
    def source(batch, seed):
        rng = np.random.default_rng(seed)
        return rng.integers(0, WC_VOCAB,
                            size=(batch, WC_WORDS_PER_SENTENCE))

    def k_parser(batch, state):
        return [batch]                       # selectivity one; drops invalid

    def k_splitter(batch, state):
        return [batch.reshape(-1)]           # (B, 10) words -> (10B,)

    def k_counter(batch, state):
        counts = state.managed               # keyed store, route-sharded
        counts.add(batch, 1)
        return [counts.get(batch)]

    def k_sink(batch, state):
        state["seen"] = state.get("seen", 0) + len(batch)
        return []

    return (
        Topology("wc")
        .spout("spout", source, exec_ns=500.0, tuple_bytes=120.0)
        .op("parser", k_parser, exec_ns=350.0, tuple_bytes=120.0)
        .op("splitter", k_splitter, exec_ns=1612.8, tuple_bytes=120.0,
            mem_bytes=240.0, selectivity=10.0)
        .op("counter", k_counter, exec_ns=612.3, tuple_bytes=32.0,
            partition="key",
            state=StateSpec("keyed", item_bytes=32.0, reads_per_tuple=1,
                            writes_per_tuple=1, key_space=WC_VOCAB,
                            dtype=np.int64))
        .sink("sink", k_sink, exec_ns=100.0, tuple_bytes=32.0)
        .build())


# ---------------------------------------------------------------------------
# Fraud Detection (Fig. 18a style):
#   spout -> parser -> predictor -> sink
#   model_spout -> predictor        (broadcast model-sync stream)
# The predictor scores transactions against a weight table replicated to
# every replica; a slow second spout streams refreshed weights, broadcast so
# all replicas apply the same updates in order and stay identical.
# ---------------------------------------------------------------------------

FD_FEATURES = 16


def fd_model_weights(version: int) -> np.ndarray:
    """The version-``v`` model the sync stream publishes (deterministic)."""
    rng = np.random.default_rng(10_000 + version)
    return np.linspace(-1.0, 1.0, FD_FEATURES) * \
        (1.0 + 0.01 * rng.standard_normal(FD_FEATURES))


def fraud_detection() -> StreamingApp:
    def source(batch, seed):
        rng = np.random.default_rng(seed)
        return rng.normal(size=(batch, FD_FEATURES))

    def model_source(batch, seed):
        # model-sync stream: one refreshed weight vector per batch row,
        # rows = [version, w0..w15]; throttled — retraining is slow
        time.sleep(0.001)
        w = fd_model_weights(seed)
        return np.concatenate([[float(seed)], w])[None, :].repeat(batch, 0)

    def k_parser(batch, state):
        return [batch]

    def k_predictor(batch, state):
        table = state.managed                # broadcast-replicated weights
        if batch.ndim == 2 and batch.shape[1] == FD_FEATURES + 1:
            # a model-sync batch: apply the newest weights, emit nothing
            table.load(batch[-1, 1:], version=int(batch[-1, 0]))
            return [np.zeros(0, np.int8)]
        score = 1.0 / (1.0 + np.exp(-batch @ table.data))
        # "a signal is passed to Sink ... regardless of detection"
        return [(score > 0.5).astype(np.int8)]

    def k_sink(batch, state):
        state["seen"] = state.get("seen", 0) + len(batch)
        state["flagged"] = state.get("flagged", 0) + int(batch.sum())
        return []

    return (
        Topology("fd")
        .spout("spout", source, exec_ns=400.0, tuple_bytes=160.0)
        .op("parser", k_parser, exec_ns=300.0, tuple_bytes=160.0)
        .spout("model_spout", model_source, exec_ns=50_000.0,
               tuple_bytes=8.0 * (FD_FEATURES + 1))
        .op("predictor", k_predictor, inputs=["parser", "model_spout"],
            exec_ns=2400.0, tuple_bytes=160.0,
            partition={"model_spout": "broadcast"},
            state=StateSpec("broadcast", item_bytes=8.0 * FD_FEATURES,
                            reads_per_tuple=2.5, writes_per_tuple=0,
                            init=lambda: fd_model_weights(0)))
        .sink("sink", k_sink, exec_ns=100.0, tuple_bytes=16.0)
        .build())


# ---------------------------------------------------------------------------
# Spike Detection: spout -> parser -> moving_avg -> spike -> sink
# ---------------------------------------------------------------------------

SD_WINDOW = 16


def spike_detection() -> StreamingApp:
    def source(batch, seed):
        rng = np.random.default_rng(seed)
        return rng.normal(loc=10.0, scale=2.0, size=batch)

    def k_parser(batch, state):
        return [batch]

    def k_moving_avg(batch, state):
        vals = state.window.slide(batch)     # declared sliding window
        kernel = np.ones(SD_WINDOW) / SD_WINDOW
        avg = np.convolve(vals, kernel, mode="valid")[-len(batch):]
        return [np.stack([batch, avg], axis=1)]

    def k_spike(batch, state):
        val, avg = batch[:, 0], batch[:, 1]
        return [(np.abs(val - avg) > 0.3 * np.abs(avg) + 1e-9).astype(np.int8)]

    def k_sink(batch, state):
        state["seen"] = state.get("seen", 0) + len(batch)
        state["spikes"] = state.get("spikes", 0) + int(batch.sum())
        return []

    return (
        Topology("sd")
        .spout("spout", source, exec_ns=400.0, tuple_bytes=64.0)
        .op("parser", k_parser, exec_ns=250.0, tuple_bytes=64.0)
        .op("moving_avg", k_moving_avg, exec_ns=900.0, tuple_bytes=64.0,
            state=StateSpec("value", item_bytes=8.0, reads_per_tuple=0,
                            writes_per_tuple=0, window=WindowSpec(SD_WINDOW)))
        .op("spike", k_spike, exec_ns=350.0, tuple_bytes=64.0)
        .sink("sink", k_sink, exec_ns=100.0, tuple_bytes=16.0)
        .build())


# ---------------------------------------------------------------------------
# Linear Road (Fig. 18c style): the multi-stream, multi-spout topology.
#   spout -> dispatcher -> {avg_speed, count_vehicles, accident}
#   {avg_speed, count_vehicles} -> toll ; accident -> notification
#   hist_spout -> toll_history (keyed by vehicle id)
#   {toll, notification, toll_history} -> sink
# Assumed per-stream selectivities (Table 8 not in the provided text):
#   dispatcher->avg_speed 0.9, ->count 0.9, ->accident 0.1
#   avg_speed->toll 1.0, count->toll 1.0, accident->notification 1.0
# The historical-query stream is the benchmark's second spout: account
# balance requests arrive on their own source and are keyed to the replica
# owning that vehicle's account (LRB's "Type 2/3" queries).  The account
# table is declared keyed state, so it is sharded by the same route and can
# be migrated across replica sets on replan.
# ---------------------------------------------------------------------------

LR_VEHICLES = 512


def linear_road() -> StreamingApp:
    def source(batch, seed):
        rng = np.random.default_rng(seed)
        seg = rng.integers(0, 64, size=batch).astype(np.float64)
        speed = rng.uniform(0.0, 100.0, size=batch)
        return np.stack([seg, speed], axis=1)

    def hist_source(batch, seed):
        rng = np.random.default_rng(seed)
        vid = rng.integers(0, LR_VEHICLES, size=batch).astype(np.float64)
        day = rng.integers(1, 70, size=batch).astype(np.float64)
        return np.stack([vid, day], axis=1)

    def k_dispatcher(batch, state):
        speed = batch[:, 1]
        keep = batch[speed >= np.quantile(speed, 0.1)] if len(batch) else batch
        acc = batch[speed < 10.0]      # ~0.1 of uniform(0,100) speeds —
        return [keep, keep, acc]       # matches the declared 0.1 selectivity

    def k_avg_speed(batch, state):
        if not len(batch):
            return [batch[:, :2] if batch.ndim == 2 else batch]
        seg = batch[:, 0].astype(np.int64) % 64
        sums = np.zeros(64)
        cnts = np.zeros(64)
        np.add.at(sums, seg, batch[:, 1])
        np.add.at(cnts, seg, 1)
        avg = sums[seg] / np.maximum(cnts[seg], 1)
        return [np.stack([seg.astype(np.float64), avg], axis=1)]

    def k_count_vehicles(batch, state):
        if not len(batch):
            return [batch[:, :2] if batch.ndim == 2 else batch]
        seg = batch[:, 0].astype(np.int64) % 64
        cnt = np.bincount(seg, minlength=64)
        return [np.stack([seg.astype(np.float64),
                          cnt[seg].astype(np.float64)], axis=1)]

    def k_accident(batch, state):
        return [batch[:, :2] if batch.ndim == 2 and len(batch) else
                np.zeros((0, 2))]

    def k_toll(batch, state):
        if not len(batch):
            return [np.zeros((0,))]
        base = 2.0
        return [base + 0.1 * np.maximum(batch[:, 1] - 50.0, 0.0)]

    def k_notification(batch, state):
        return [np.ones(len(batch), np.int8)]

    def k_toll_history(batch, state):
        if not len(batch):
            return [np.zeros((0,))]
        vid = batch[:, 0].astype(np.int64) % LR_VEHICLES
        acct = state.managed           # keyed account table, route-sharded
        acct.add(vid, 0.5)             # each query accrues an assessed toll
        state["queries"] = state.get("queries", 0) + len(batch)
        return [acct.get(vid)]

    def k_sink(batch, state):
        state["seen"] = state.get("seen", 0) + len(batch)
        return []

    return (
        Topology("lr")
        .spout("spout", source, exec_ns=450.0, tuple_bytes=96.0)
        .op("dispatcher", k_dispatcher, exec_ns=400.0, tuple_bytes=96.0)
        .op("avg_speed", k_avg_speed, inputs={"dispatcher": 0.9},
            exec_ns=1100.0, tuple_bytes=96.0, mem_bytes=288.0)
        .op("count_vehicles", k_count_vehicles, inputs={"dispatcher": 0.9},
            exec_ns=800.0, tuple_bytes=96.0, mem_bytes=192.0)
        .op("accident", k_accident, inputs={"dispatcher": 0.1},
            exec_ns=700.0, tuple_bytes=96.0)
        .op("toll", k_toll, inputs=["avg_speed", "count_vehicles"],
            exec_ns=950.0, tuple_bytes=48.0, mem_bytes=144.0)
        .op("notification", k_notification, inputs=["accident"],
            exec_ns=300.0, tuple_bytes=48.0)
        .spout("hist_spout", hist_source, exec_ns=350.0, tuple_bytes=64.0)
        .op("toll_history", k_toll_history, inputs=["hist_spout"],
            exec_ns=650.0, tuple_bytes=64.0,
            partition="key", key_by=0,
            state=StateSpec("keyed", item_bytes=32.0, reads_per_tuple=2,
                            writes_per_tuple=1, key_space=LR_VEHICLES))
        .sink("sink", k_sink, inputs=["toll", "notification",
                                      "toll_history"],
              exec_ns=100.0, tuple_bytes=16.0)
        .build())


# ---------------------------------------------------------------------------
# Spike Detection, event-time variant: an out-of-order sensor stream with
# configurable skew, watermark-fired sliding panes instead of arrival-count
# history — the first benchmark user of the event-time substrate.
#   spout (event_time=col 0) -> parser -> pane_stats (time window) -> sink
# ---------------------------------------------------------------------------

SD_ET_SIZE = 64.0       # pane span, event-time ticks (1 tick per reading)
SD_ET_SLIDE = 16.0      # sliding hop
SD_ET_SKEW = 8.0        # default max out-of-orderness of the sensor stream
SD_ET_WM_EVERY = "auto"  # watermark cadence: derived from the declared
# window grid at run time (runtime.derive_watermark_every targets
# WM_TARGET_PANES released panes per mark).  The derivation lands on the
# previously hand-calibrated value — 8 batches/mark for sd_et at the bench
# batch of 256 — and adapts when batch size or window grid change, where
# the constant silently went stale (16 measured *worse* on the CI
# container: fire bursts outgrew the pipeline's queue slack).  Explicit
# int declarations remain as overrides; bench_runtime's cadence A/B
# records auto vs fixed on sd_et.


def shuffle_within_skew(ets: np.ndarray, bound: float,
                        rng: np.random.Generator) -> np.ndarray:
    """Permutation that delays each tuple by at most ``bound`` event-time
    units: sort by ``et + U(0, bound)`` (stable).  In the permuted stream a
    tuple can be preceded by tuples up to ``bound`` ticks younger, so the
    running max event time never exceeds any pending tuple's by more than
    ``bound`` — the seeded out-of-order harness behind the determinism
    tests and the SD event-time source."""
    if bound <= 0 or len(ets) < 2:
        return np.arange(len(ets))
    return np.argsort(np.asarray(ets, np.float64)
                      + rng.uniform(0.0, bound, len(ets)), kind="stable")


def spike_detection_eventtime(skew: float = SD_ET_SKEW,
                              lateness: float = None,
                              watermark_every=SD_ET_WM_EVERY
                              ) -> StreamingApp:
    """SD over an out-of-order sensor stream (event-time windows).

    ``skew`` bounds the stream's out-of-orderness (tuples are permuted
    within it, seeded); ``lateness`` is the window's lateness allowance and
    defaults to ``skew`` — the bound under which pane contents are provably
    identical to an ordered run.  The permutation is intra-batch and the
    spout emits its watermark *at* batch boundaries, so this stream never
    produces late tuples regardless of ``lateness`` (which still delays
    firing and prices the buffer); the late-drop path needs disorder that
    crosses watermark emissions — see the cross-batch straggler source in
    ``tests/test_eventtime.py`` for that harness.

    ``watermark_every`` is the declared mark cadence (batches per mark):
    the segmented pane engine fires every released pane of a mark as one
    stacked kernel call, so a coarser cadence divides the per-mark
    flush/merge/fire overhead across more tuples at the cost of pane-
    firing latency — pane *contents* are cadence-independent.  The default
    ``"auto"`` derives the cadence from the declared window grid
    (:func:`~.runtime.derive_watermark_every`); pass an int to pin it.
    """
    lateness = skew if lateness is None else lateness

    def source(batch, seed):
        rng = np.random.default_rng(seed)
        # one reading per tick; the batch's ticks follow on from the seed so
        # event time is globally increasing before the skew permutation.
        # The value distribution matches count-window SD's source exactly —
        # the bench A/B then prices only what differs: the event-time
        # column, the skew permutation and the watermark/pane machinery
        ets = np.abs(seed) * batch + np.arange(batch, dtype=np.float64)
        vals = rng.normal(loc=10.0, scale=2.0, size=batch)
        rows = np.stack([ets, vals], axis=1)
        return rows[shuffle_within_skew(ets, skew, rng)]

    def k_parser(batch, state):
        return [batch]

    @segmented
    def k_pane_stats(stack, state):
        # segmented contract: one call over ALL panes a watermark released
        # — `stack` is the stacked buffer, state.segments the boundary
        # index; reduceat over segment starts gives per-pane aggregates,
        # emitted in segment order (canonical pane order, so the output
        # bytes match driving the kernel one pane at a time)
        seg = state.segments
        vals = stack[:, 1]
        avg = np.add.reduceat(vals, seg.starts) / seg.lengths
        mx = np.maximum.reduceat(vals, seg.starts)
        ends = seg.spans[:, 1]
        return [np.stack([ends, avg, mx,
                          (mx > 1.5 * avg).astype(np.float64)], axis=1)]

    def k_sink(batch, state):
        state["seen"] = state.get("seen", 0) + len(batch)
        state["spikes"] = state.get("spikes", 0) + int(batch[:, 3].sum())
        return []

    return (
        Topology("sd_et")
        .spout("spout", source, exec_ns=400.0, tuple_bytes=64.0,
               event_time=0, watermark_every=watermark_every)
        .op("parser", k_parser, exec_ns=250.0, tuple_bytes=64.0)
        .op("pane_stats", k_pane_stats, exec_ns=900.0, tuple_bytes=64.0,
            selectivity=1.0 / SD_ET_SLIDE,   # one aggregate per slide ticks
            state=StateSpec("value", item_bytes=16.0, reads_per_tuple=0,
                            writes_per_tuple=0,
                            window=WindowSpec.time_sliding(
                                SD_ET_SIZE, SD_ET_SLIDE, lateness=lateness,
                                time_by=0)))
        .sink("sink", k_sink, exec_ns=100.0, tuple_bytes=32.0)
        .build())


# ---------------------------------------------------------------------------
# Spike Detection, keyed event-time variant: per-device spike sessions.
#   spout (event_time=col 0) -> parser -> device_stats (KEYED time window,
#   partition="key" on the device column) -> sink
# The pane unit is (device, span): each device's readings aggregate into
# that device's own pane, fired by the one merged watermark — so replicating
# device_stats over the keyed route shards panes by device ownership and the
# union of the replica panes equals the single-replica run byte for byte.
# ---------------------------------------------------------------------------

SD_KEY_DEVICES = 8      # sensor fleet size
SD_KEY_SIZE = 32.0      # session pane span, event-time ticks


def spike_detection_keyed(devices: int = SD_KEY_DEVICES,
                          skew: float = SD_ET_SKEW,
                          lateness: float = None,
                          watermark_every=SD_ET_WM_EVERY
                          ) -> StreamingApp:
    """Per-device spike sessions over an out-of-order sensor fleet.

    Each reading is ``[tick, device, value]``; ``device_stats`` declares a
    *keyed* tumbling event-time window (``WindowSpec(keyed=True)`` sharded
    by the compiled keyed route on the device column), so every fired pane
    is one device's session — the first benchmark user of keyed pane
    groups and the replication-invariance they buy.
    """
    lateness = skew if lateness is None else lateness

    def source(batch, seed):
        rng = np.random.default_rng(seed)
        ets = np.abs(seed) * batch + np.arange(batch, dtype=np.float64)
        dev = rng.integers(0, devices, size=batch).astype(np.float64)
        vals = rng.normal(loc=10.0, scale=2.0, size=batch)
        rows = np.stack([ets, dev, vals], axis=1)
        return rows[shuffle_within_skew(ets, skew, rng)]

    def k_parser(batch, state):
        return [batch]

    @segmented
    def k_device_stats(stack, state):
        # one call per watermark over every (device, span) pane released;
        # state.segments.keys carries each pane's device
        seg = state.segments
        vals = stack[:, 2]
        avg = np.add.reduceat(vals, seg.starts) / seg.lengths
        mx = np.maximum.reduceat(vals, seg.starts)
        return [np.stack([seg.spans[:, 1], seg.keys.astype(np.float64),
                          avg, mx,
                          (mx > 1.5 * avg).astype(np.float64)], axis=1)]

    def k_sink(batch, state):
        state["seen"] = state.get("seen", 0) + len(batch)
        state["spikes"] = state.get("spikes", 0) + int(batch[:, 4].sum())
        return []

    return (
        Topology("sd_key")
        .spout("spout", source, exec_ns=400.0, tuple_bytes=64.0,
               event_time=0, watermark_every=watermark_every)
        .op("parser", k_parser, exec_ns=250.0, tuple_bytes=64.0)
        .op("device_stats", k_device_stats, exec_ns=900.0, tuple_bytes=64.0,
            selectivity=devices / SD_KEY_SIZE,   # ~one pane per device/span
            partition="key", key_by=1,
            state=StateSpec("value", item_bytes=16.0, reads_per_tuple=0,
                            writes_per_tuple=0,
                            window=WindowSpec.time_tumbling(
                                SD_KEY_SIZE, lateness=lateness,
                                time_by=0, keyed=True)))
        .sink("sink", k_sink, exec_ns=100.0, tuple_bytes=40.0)
        .build())


# ---------------------------------------------------------------------------
# Streaming ML inference (ROADMAP 5a): FD's model-sync broadcast pattern
# feeding a *device* predictor — the port's tanh-MLP scored over sensor
# batches on a CUDA card with async dispatch, so host ingest overlaps device
# compute.
#   spout -> parser -> predictor (device=True) -> sink
#   model_spout -> predictor      (broadcast model-version stream)
# The predictor runs exactly repro_torch.kernels.ref.mlp_ref in PyTorch,
# replayed from a CUDA graph (the port's jax.jit), with the current model
# version's weight stack resident on the device (uploaded once, cached per
# version — per-call host->device transfer of the weights
# would swamp the dispatch window and erase the overlap win; only the small
# sensor batch crosses per call).  The model-sync stream broadcasts version
# numbers; weights derive deterministically from the version
# (inf_model_weights), so every replica loads byte-identical tables in
# version order, and model_versions=1 pins the model for deterministic
# replay (the sync-vs-async parity harness — with live updates the
# sensor/sync interleaving at the predictor queue is scheduling-dependent,
# exactly like FD).
# ---------------------------------------------------------------------------

INF_FEATURES = 32       # sensor feature dim == model width
INF_LAYERS = 4          # tanh-MLP depth


def inf_model_weights(version: int) -> np.ndarray:
    """The version-``v`` weight stack (L, D, D), deterministic."""
    rng = np.random.default_rng(77_000 + version)
    w = rng.standard_normal((INF_LAYERS, INF_FEATURES, INF_FEATURES))
    return (w / np.sqrt(INF_FEATURES)).astype(np.float32)


class _DeviceScores:
    """One predictor call's scores on their way to the host: a
    ``non_blocking`` copy into a pinned buffer of this result's own, then a
    CUDA event.  ``np.asarray`` (the Executor's FIFO retirement) waits on
    the event.  Until then the tensors the call reads stay referenced (its
    model version's weight stack may leave the cache meanwhile), so none is
    freed and reused while the stream may still read it."""

    __slots__ = ("_host", "_start", "_done", "_tensors", "_owner")

    def __init__(self, out, tensors, start, stream, owner):
        self._host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        self._host.copy_(out, non_blocking=True)
        self._done = torch.cuda.Event(enable_timing=True)
        self._done.record(stream)
        self._start, self._owner = start, owner
        self._tensors = tensors + (out,)

    def __array__(self, dtype=None, copy=None):
        if self._tensors is not None:
            self._done.synchronize()
            self._owner._retired(self._start.elapsed_time(self._done))
            self._tensors = None
        a = self._host.numpy()
        if dtype is not None and np.dtype(dtype) != a.dtype:
            return a.astype(dtype)
        return a.copy() if copy else a


class _Replica:
    """One predictor replica's device side: its CUDA stream, the weight
    buffer its graphs read (refilled when the model version changes) and
    one captured graph per batch shape."""

    __slots__ = ("stream", "w", "version", "graphs")

    def __init__(self, device):
        self.stream = torch.cuda.Stream(device)
        self.w = None
        self.version = None
        self.graphs = {}        # (rows, dtype) -> (graph, x buffer, scores)


class InferencePredictor:
    """The ``streaming_inference`` predictor's compute: :func:`mlp_ref` on
    ``device`` with each model version's weight stack uploaded once (a
    cache of 8 versions, as the reference's).

    On CUDA, each predictor replica has its own stream (every depth issues
    a replica's calls in one order: the same bits) and replays
    :func:`mlp_ref` from a CUDA graph captured at its first call of each
    batch shape — the counterpart of the reference's ``jax.jit``: one
    launch a call, not one a kernel.  A call copies the batch into the
    graph's input buffer, replays, and returns a lazy result
    (:class:`_DeviceScores`); all on the replica's stream, so a call never
    overwrites a buffer that an earlier call still reads.

    ``graphs=False`` launches :func:`mlp_ref`'s kernels one by one on the
    replica's stream instead (the plain path ``chip_smoke.py`` times the
    graphs against).  ``device="cuda"`` raises when there is no CUDA
    device; only ``device="cpu"`` computes on the CPU, eagerly and
    synchronously.
    ``batches`` counts the batches scored per device type, ``captures``
    the graphs captured; ``device_ms`` / ``timed`` sum the device time
    (CUDA events around each call's copies and replay) of the CUDA calls
    retired so far.
    """

    def __init__(self, device="cuda", graphs: bool = True):
        dev = torch.device(device)
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"streaming_inference: device must be 'cuda' "
                             f"or 'cpu', got {str(device)!r}")
        # device_count() asks NVML, so checking leaves this process fork-safe
        # for the processes backend (is_available() initializes the driver)
        if dev.type == "cuda" and torch.cuda.device_count() == 0:
            raise RuntimeError(
                f"streaming_inference: device={str(device)!r} but no CUDA "
                "device is available; pass device='cpu' to score on the CPU")
        self.device, self.graphs = dev, graphs
        self.batches = collections.Counter()
        self.captures = 0
        self.device_ms = 0.0
        self.timed = 0
        self._weights = {}      # version -> (device weight stack, ready event)
        self._replicas = {}     # replica -> _Replica
        self._lock = threading.Lock()

    def __call__(self, batch: np.ndarray, version: int, weights: np.ndarray,
                 replica: int = 0):
        x = torch.from_numpy(np.ascontiguousarray(batch))
        if self.device.type == "cpu":
            out = mlp_ref(x, self._weights_for(version, weights, None))
            with self._lock:
                self.batches["cpu"] += 1
            return out.numpy()
        with self._lock:
            rep = self._replicas.get(replica)
            if rep is None:
                rep = self._replicas[replica] = _Replica(self.device)
        # the batch goes to the card from pinned memory of this call's own:
        # from pageable memory the driver may first wait for the stream, and
        # the next call's copy would wait for this call to finish
        x = torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)
        with torch.cuda.stream(rep.stream):
            w = self._weights_for(version, weights, rep.stream)
            start = torch.cuda.Event(enable_timing=True)
            start.record(rep.stream)
            if self.graphs:
                reads, scores = (w, x), self._replay(rep, x, w, version)
            else:
                x_dev = x.to(self.device, non_blocking=True)
                reads, scores = (w, x, x_dev), mlp_ref(x_dev, w)
            result = _DeviceScores(scores, reads, start, rep.stream, self)
        with self._lock:
            self.batches["cuda"] += 1
        return result

    def _replay(self, rep, x, w, version):
        """Copy the version's weights (when they changed) and the batch into
        the buffers of the replica's graph for this shape, and replay it;
        returns the graph's scores buffer."""
        if rep.version != version:
            if rep.w is None:
                rep.w = torch.empty_like(w)
            elif rep.w.shape != w.shape:
                raise ValueError(
                    f"model version {version} has weights of shape "
                    f"{tuple(w.shape)}, the graphs read {tuple(rep.w.shape)}")
            rep.w.copy_(w, non_blocking=True)
            rep.version = version
        key = (tuple(x.shape), x.dtype)
        if key not in rep.graphs:
            rep.graphs[key] = self._capture(rep, x)
        graph, x_in, scores = rep.graphs[key]
        x_in.copy_(x, non_blocking=True)
        graph.replay()
        return scores

    def _capture(self, rep, x):
        """A graph of :func:`mlp_ref` on a fresh input buffer and the
        replica's weight buffer, after two eager calls on its stream."""
        x_in = torch.zeros(x.shape, dtype=x.dtype, device=self.device)
        for _ in range(2):
            mlp_ref(x_in, rep.w)
        graph = torch.cuda.CUDAGraph()
        # thread_local: another replica's thread may use CUDA meanwhile
        with torch.cuda.graph(graph, stream=rep.stream,
                              capture_error_mode="thread_local"):
            scores = mlp_ref(x_in, rep.w)
        with self._lock:
            self.captures += 1
        return graph, x_in, scores

    def _weights_for(self, version, weights, stream):
        with self._lock:
            hit = self._weights.get(version)
            if hit is None:
                if len(self._weights) >= 8:  # bound the per-version cache
                    self._weights.pop(next(iter(self._weights)))
                w = torch.from_numpy(weights).to(self.device, copy=True,
                                                 non_blocking=True)
                ready = None
                if stream is not None:
                    ready = torch.cuda.Event()
                    ready.record(stream)
                hit = self._weights[version] = (w, ready)
        w, ready = hit
        if ready is not None:       # the upload may be another replica's
            stream.wait_event(ready)
        return w

    def _retired(self, ms: float) -> None:
        with self._lock:
            self.device_ms += ms
            self.timed += 1


def streaming_inference(model_versions: int = 8,
                        model_interval: float = 0.002,
                        dispatch_depth: int = 2,
                        device="cuda", graphs: bool = True) -> StreamingApp:
    """Streaming ML inference with async device dispatch.

    ``model_versions`` cycles the broadcast model-sync stream through that
    many deterministic weight versions (1 pins version 0 — idempotent
    updates, deterministic replay); ``model_interval`` throttles it
    (retraining is slow); ``dispatch_depth`` is the predictor's declared
    in-flight window (``run_app(dispatch_depth=)`` overrides for A/Bs);
    ``device`` is where the predictor scores and ``graphs`` whether it
    replays a CUDA graph there (see :class:`InferencePredictor`, which is
    ``app.kernels["predictor"].predictor``).

    The throughput win of depth > 1 on a single-core host is *dispatch
    pipelining*: every synchronous call pays a fixed scheduler bubble
    (result wake-up + Python re-dispatch) with the device queue empty; keeping
    ``depth`` results in flight hides that bubble behind device compute.
    The effect is per *call*, so small jumbo batches (16–32 rows) show the
    largest relative win — the bench runs this app at batch 16.
    """

    predictor = InferencePredictor(device, graphs)

    def source(batch, seed):
        rng = np.random.default_rng(seed)
        return rng.normal(size=(batch, INF_FEATURES)).astype(np.float32)

    def model_source(batch, seed):
        # model-sync stream: one [version, layers] row per emission,
        # throttled — the weights themselves derive from the version
        time.sleep(model_interval)
        return np.array([[float(seed % model_versions),
                          float(INF_LAYERS)]])

    def k_parser(batch, state):
        return [batch]

    def k_predictor(batch, state):
        table = state.managed            # broadcast-replicated weights
        if batch.ndim == 2 and batch.shape[1] == 2:
            # a model-sync batch: load that version's weights, emit nothing
            v = int(batch[-1, 0])
            table.load(inf_model_weights(v), version=v)
            return [np.zeros(0, np.float32)]
        # on CUDA returns the *lazy* result: the Executor's in-flight
        # window materializes it on retirement (async dispatch, FIFO retire)
        return [predictor(batch, table.version, table.data, state.replica)]

    k_predictor.predictor = predictor

    def k_sink(batch, state):
        state["seen"] = state.get("seen", 0) + len(batch)
        state["score"] = state.get("score", 0.0) + float(np.asarray(batch,
                                                         np.float64).sum())
        return []

    return (
        Topology("inference")
        .spout("spout", source, exec_ns=400.0,
               tuple_bytes=4.0 * INF_FEATURES)
        .op("parser", k_parser, exec_ns=250.0,
            tuple_bytes=4.0 * INF_FEATURES)
        .spout("model_spout", model_source, exec_ns=50_000.0,
               tuple_bytes=16.0)
        .op("predictor", k_predictor, inputs=["parser", "model_spout"],
            exec_ns=600.0, tuple_bytes=4.0 * INF_FEATURES,
            # device_ns: the reference's declared per-tuple device time,
            # not a measurement (plans equal the reference's; chip_smoke.py
            # prints the time measured on the card beside it)
            device=True, device_ns=2500.0, dispatch_depth=dispatch_depth,
            partition={"model_spout": "broadcast"},
            state=StateSpec(
                "broadcast",
                item_bytes=4.0 * INF_LAYERS * INF_FEATURES * INF_FEATURES,
                reads_per_tuple=1.0, writes_per_tuple=0,
                init=lambda: inf_model_weights(0)))
        .sink("sink", k_sink, exec_ns=100.0, tuple_bytes=8.0)
        .build())


# ---------------------------------------------------------------------------
# Chain pipeline: spout -> f1 -> ... -> fN -> sink, every hop 1:1 shuffle.
# The worst case for per-hop runtime overhead (queue, fan-in poll, watermark
# merge, arena lease per stage) and therefore the showcase for operator
# fusion: with fuse="auto" the whole f1..fN+sink segment collapses into one
# executor.  Stage kernels are light affine arithmetic so the hop overhead
# dominates; the sink keeps a float fingerprint so fused and unfused runs
# can be compared byte-for-byte.
# ---------------------------------------------------------------------------


def chain_pipeline(stages: int = 4) -> StreamingApp:
    def source(batch, seed):
        rng = np.random.default_rng(seed)
        return rng.normal(loc=1.0, scale=0.5, size=batch)

    def make_stage(j):
        a = 1.0 + 0.01 * j
        b = 0.1 * j

        def k_stage(batch, state):
            return [batch * a + b]
        return k_stage

    def k_sink(batch, state):
        state["seen"] = state.get("seen", 0) + len(batch)
        state["total"] = state.get("total", 0.0) + float(
            np.asarray(batch, np.float64).sum())
        return []

    t = Topology("chain").spout("spout", source, exec_ns=400.0,
                                tuple_bytes=8.0)
    prev = "spout"
    for j in range(1, stages + 1):
        name = f"f{j}"
        t = t.op(name, make_stage(j), inputs=prev, exec_ns=300.0,
                 tuple_bytes=8.0)
        prev = name
    return t.sink("sink", k_sink, inputs=prev, exec_ns=100.0,
                  tuple_bytes=8.0).build()


ALL_APPS = {"wc": word_count, "fd": fraud_detection, "sd": spike_detection,
            "sd_et": spike_detection_eventtime,
            "sd_key": spike_detection_keyed, "lr": linear_road,
            "inference": streaming_inference, "chain": chain_pipeline}
