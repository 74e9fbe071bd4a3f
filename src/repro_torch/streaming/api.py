"""Unified Topology/Job API: one declarative surface from graph construction
to RLAS planning to execution.

The paper's value is the *pipeline* — profile a topology, jointly optimize
replication + placement (RLAS, Alg. 1+2), then run the plan — and this module
is its single entry point:

* :class:`Topology` — fluent dataflow builder.  Operators declare their
  profiled spec (T^e, N, M, selectivity), their compute kernel, their inputs
  (with optional per-stream selectivity overrides, paper Table 8) and their
  *input partitioning strategy* (``"shuffle"``, ``"key"`` with an optional
  ``key_by`` extractor, or ``"broadcast"``) in one place.  Declarations
  compile into the single routing substrate (:mod:`repro_torch.streaming.routing`)
  consumed by planner, simulators and runtime alike.
  ``build()`` validates the graph (duplicate operators, unknown endpoints,
  edges into spouts, cycles, unreachable operators) before anything runs.
* :class:`Job` — wraps a built app (or a planning-only logical graph) and
  produces execution :class:`Plan`\\ s via ``plan(machine, optimizer=...)``
  where the optimizer is RLAS (joint scaling+placement), plain B&B placement,
  or one of the paper's §6.4 baselines (first-fit / round-robin / random).
* :class:`Plan` — one plan object flows through the Table 4 protocol:
  ``estimate()`` (analytical §3.1 model), ``simulate()`` (DES or fluid
  oracle) and ``execute()`` (real threaded runtime), all returning a common
  :class:`Metrics` record so estimated vs measured numbers compare directly.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np

from repro_torch.core import (ExecutionGraph, LogicalGraph, MachineSpec,
                              OperatorSpec, bnb_place, evaluate,
                              rlas_optimize)
from repro_torch.core.baselines import ff_place, random_plan, rr_place

from .routing import (KeyBy, PARTITION_STRATEGIES, PartitionDecl,
                      RoutingTable, compile_routes, declares_key,
                      validate_key_extractor, validate_operator_names,
                      validate_partition_decl, validate_time_extractor)
from .state import StateSpec, WindowSpec

_UNSET = object()


class TopologyError(ValueError):
    """A topology declaration is invalid (raised at build time)."""


@dataclasses.dataclass
class StreamingApp:
    """A built streaming application: logical graph + runtime artefacts.

    ``partition`` maps a consumer operator to its declared input-partitioning
    strategy ("shuffle" unless declared otherwise); ``sources`` maps each
    spout to its generator ``(batch, seed) -> np.ndarray``.  ``make_source``
    remains the default generator for spouts without a dedicated entry.
    """

    name: str
    graph: LogicalGraph
    kernels: Dict[str, Callable]
    make_source: Optional[Callable[[int, int], np.ndarray]] = None
    partition: Dict[str, PartitionDecl] = dataclasses.field(
        default_factory=dict)
    sources: Dict[str, Callable] = dataclasses.field(default_factory=dict)
    key_by: Dict[str, KeyBy] = dataclasses.field(default_factory=dict)
    state: Dict[str, StateSpec] = dataclasses.field(default_factory=dict)
    event_time: Dict[str, KeyBy] = dataclasses.field(default_factory=dict)
    watermark_every: Dict[str, int] = dataclasses.field(default_factory=dict)
    watermark_interval: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    checkpoint_every: Optional[int] = None   # declared barrier cadence
    #: operators that opted out of operator fusion (``op(fuse=False)``) —
    #: chain detection never fuses an edge touching one of these
    no_fuse: frozenset = frozenset()

    def time_windows(self) -> Dict[str, WindowSpec]:
        """Declared event-time windows (operator -> WindowSpec) — what
        ``Plan.simulate(backend='des')`` hands the DES for pane pacing."""
        return {op: sp.window for op, sp in self.state.items()
                if sp.window is not None and sp.window.time}

    def device_ops(self) -> Dict[str, int]:
        """Declared device operators -> their dispatch depth (the async
        in-flight window; 1 == synchronous)."""
        return {n: sp.dispatch_depth
                for n, sp in self.graph.operators.items() if sp.device}

    def source_for(self, spout: str) -> Callable[[int, int], np.ndarray]:
        fn = self.sources.get(spout, self.make_source)
        if fn is None:
            raise TopologyError(f"spout {spout!r} has no source generator")
        return fn

    def routes(self, partition: Optional[Dict[str, str]] = None
               ) -> RoutingTable:
        """Compile this app's routing table (see ``streaming.routing``)."""
        return compile_routes(self, partition=partition)


@dataclasses.dataclass
class _OpDecl:
    name: str
    kernel: Optional[Callable]
    spec: OperatorSpec
    inputs: List[str]
    edge_selectivity: Dict[str, float]      # producer -> override
    partition: PartitionDecl
    source: Optional[Callable]
    key_by: Optional[KeyBy] = None
    state: Optional[StateSpec] = None
    event_time: Optional[KeyBy] = None      # spouts: event-time extractor
    watermark_every: int = 1                # spouts: mark every N batches
    watermark_interval: Optional[float] = None   # ... or every T et units
    fuse: bool = True                       # eligible for operator fusion


class Topology:
    """Fluent dataflow builder (declare -> validate -> build).

    >>> app = (Topology("wc")
    ...        .spout("spout", source, exec_ns=500, tuple_bytes=120)
    ...        .op("parser", k_parser, exec_ns=350)
    ...        .op("counter", k_counter, exec_ns=612.3, partition="key")
    ...        .sink("sink", k_sink)
    ...        .build())

    ``inputs`` defaults to the previously declared operator (linear-chain
    convenience); pass a name, a list of names, or a ``{producer: selectivity}``
    mapping for multi-stream edges with per-stream selectivity overrides.
    Forward references are allowed — validation happens in ``build()``.
    """

    def __init__(self, name: str, *, checkpoint_every: Optional[int] = None):
        self.name = name
        if checkpoint_every is not None and (
                isinstance(checkpoint_every, bool)
                or not isinstance(checkpoint_every, int)
                or checkpoint_every < 1):
            raise TopologyError(
                f"topology {name!r}: checkpoint_every must be an int >= 1 "
                f"(batches between barriers), got {checkpoint_every!r}")
        self.checkpoint_every = checkpoint_every
        self._decls: Dict[str, _OpDecl] = {}
        self._last: Optional[str] = None

    # -- declaration ------------------------------------------------------
    def spout(self, name: str,
              source: Optional[Callable[[int, int], np.ndarray]] = None, *,
              exec_ns: float, tuple_bytes: float = 64.0,
              mem_bytes: Optional[float] = None,
              selectivity: float = 1.0,
              event_time: Optional[KeyBy] = None,
              watermark_every: int = 1,
              watermark_interval: Optional[float] = None) -> "Topology":
        """Declare a source operator.  ``source(batch, seed) -> array``.

        ``event_time`` names the event-time column of the spout's output
        batches (column index or callable, same shape rule as ``key_by``).
        A spout that declares it emits *low-watermarks*: the runtime
        forwards ``max(event time emitted so far)`` along every compiled
        route, which is what fires downstream event-time window panes
        (``WindowSpec(time=True)``).

        ``watermark_every=N`` emits the mark every N batches instead of
        every batch; ``watermark_interval=T`` emits whenever the spout's
        event clock advanced by at least T event-time units since the last
        mark (declare one or the other).  ``watermark_every="auto"``
        derives the cadence at run time from the declared window grid —
        panes released per batch vs the
        :data:`~repro_torch.streaming.runtime.WM_TARGET_PANES` target (see
        :func:`~repro_torch.streaming.runtime.derive_watermark_every`) — so
        apps need not hand-calibrate a constant per batch size.  Each
        mark flushes the spout's buffered jumbos — a watermark never
        overtakes its tuples — so a coarser cadence amortizes flushes
        against pane-firing latency.  The defaults preserve the per-batch
        behavior, and end of stream always emits a final ``+inf`` mark."""
        try:
            if event_time is not None:
                validate_time_extractor(name, event_time)
            if watermark_every != "auto" and (
                    isinstance(watermark_every, bool) or
                    not isinstance(watermark_every, int) or
                    watermark_every < 1):
                raise ValueError(
                    f"spout {name!r}: watermark_every must be an int >= 1 "
                    f"or 'auto', got {watermark_every!r}")
            if watermark_interval is not None and \
                    not watermark_interval > 0:
                raise ValueError(
                    f"spout {name!r}: watermark_interval must be > 0, "
                    f"got {watermark_interval!r}")
            if watermark_every != 1 and watermark_interval is not None:
                raise ValueError(
                    f"spout {name!r}: declare watermark_every or "
                    "watermark_interval, not both (batch-count and "
                    "event-time cadences would race)")
            if (watermark_every != 1 or watermark_interval is not None) \
                    and event_time is None:
                raise ValueError(
                    f"spout {name!r}: a watermark cadence requires "
                    "event_time= (no event clock, no watermarks)")
        except ValueError as e:
            raise TopologyError(str(e)) from None
        self._declare(_OpDecl(
            name, None,
            OperatorSpec(name, exec_ns, tuple_bytes,
                         tuple_bytes if mem_bytes is None else mem_bytes,
                         selectivity, is_spout=True),
            inputs=[], edge_selectivity={}, partition="shuffle",
            source=source, event_time=event_time,
            watermark_every=watermark_every,
            watermark_interval=watermark_interval))
        return self

    def op(self, name: str, kernel: Optional[Callable] = None, *,
           inputs: Union[None, str, Sequence[str],
                         Mapping[str, float]] = None,
           exec_ns: float, tuple_bytes: float = 64.0,
           mem_bytes: Optional[float] = None, selectivity: float = 1.0,
           partition: PartitionDecl = "shuffle",
           key_by: Optional[KeyBy] = None,
           state: Optional[StateSpec] = None,
           device: bool = False, device_ns: float = 0.0,
           dispatch_depth: int = 1, fuse: bool = True) -> "Topology":
        """Declare an operator.  ``kernel(batch, state) -> [out_batch, ...]``
        emits one array per declared *downstream* stream, in the order the
        consumers were declared.  ``partition`` is how *this* operator's
        input streams are split over its replicas ("shuffle", "key" or
        "broadcast", or a ``{producer: strategy}`` mapping for per-stream
        strategies, e.g. a shuffled data stream plus a broadcast model-sync
        stream); ``key_by`` names the key for keyed streams — a column index
        into 2-D batches or a callable ``batch -> keys`` (default: the
        historical hash-column-0 convention).

        ``state`` declares *managed operator state*
        (:class:`~repro_torch.streaming.state.StateSpec`): the runtime builds the
        store sharded by this operator's compiled route, the planner derives
        ``mem_bytes = tuple_bytes + state.bytes_per_tuple()`` from it, and
        ``Plan.replan`` can migrate it to a new replica set.  Declaring both
        ``state`` and a hand-tuned ``mem_bytes`` is an error — the point of
        the declaration is that the constant is derived, not asserted.

        ``device=True`` marks the kernel as a PyTorch computation on a CUDA
        card whose lazy result waits on its CUDA event when materialized;
        the Executor dispatches it asynchronously: up to ``dispatch_depth``
        batches (default 1 == synchronous) are in flight on the device while the
        host continues ingesting, and results retire strictly FIFO so
        outputs and watermark order are byte-identical to the synchronous
        path.  ``device_ns`` is the profiled per-tuple *device* compute
        time; ``exec_ns`` keeps its host-side meaning, and the planner/DES
        charge ``max(exec_ns, device_ns/dispatch_depth)`` at depth >= 2
        (overlap) instead of the serial sum.  Device operators cannot also
        be windowed/segmented-pane kernels in v1 — pane firing happens
        inside the watermark path, which must retire the in-flight window
        first.

        ``fuse=False`` opts this operator out of operator fusion (see
        ``docs/API.md`` §3e): no chain detected by ``Job.plan(fuse="auto")``
        or the backends' ``fuse="auto"`` will include it."""
        try:
            validate_partition_decl(name, partition)
            if not isinstance(fuse, bool):
                raise ValueError(
                    f"operator {name!r}: fuse must be a bool, got {fuse!r}")
            if key_by is not None:
                if not declares_key(partition):
                    raise ValueError(
                        f"operator {name!r} declares key_by but partition="
                        f"{partition!r} (key extractors require "
                        "partition='key')")
                validate_key_extractor(name, key_by)
            if isinstance(partition, Mapping):
                unknown = sorted(set(partition) -
                                 set(self._normalize_inputs(name, inputs)[0]))
                if unknown:
                    raise ValueError(
                        f"operator {name!r}: partition mapping names "
                        f"{unknown}, which are not inputs of {name!r}")
            if state is not None:
                if mem_bytes is not None:
                    raise ValueError(
                        f"operator {name!r} declares both state= and "
                        "mem_bytes=; mem_bytes is derived from the state "
                        "declaration (tuple_bytes + state.bytes_per_tuple())")
                if state.kind == "keyed" and not declares_key(partition):
                    raise ValueError(
                        f"operator {name!r} declares keyed state but "
                        f"partition={partition!r}: a keyed store is sharded "
                        "by the operator's keyed route (partition='key')")
                if state.window is not None and state.window.keyed \
                        and not declares_key(partition):
                    raise ValueError(
                        f"operator {name!r} declares keyed event-time "
                        f"panes but partition={partition!r}: pane groups "
                        "shard by the operator's compiled keyed route "
                        "(partition='key')")
            if isinstance(dispatch_depth, bool) or \
                    not isinstance(dispatch_depth, int) or dispatch_depth < 1:
                raise ValueError(
                    f"operator {name!r}: dispatch_depth must be an int >= 1,"
                    f" got {dispatch_depth!r}")
            if not device:
                if device_ns:
                    raise ValueError(
                        f"operator {name!r} declares device_ns="
                        f"{device_ns!r} without device=True (host operators"
                        " have no device compute to price)")
                if dispatch_depth != 1:
                    raise ValueError(
                        f"operator {name!r} declares dispatch_depth="
                        f"{dispatch_depth!r} without device=True (only "
                        "device kernels dispatch asynchronously)")
            else:
                if device_ns < 0:
                    raise ValueError(
                        f"operator {name!r}: device_ns must be >= 0, got "
                        f"{device_ns!r}")
                if state is not None and state.window is not None:
                    raise ValueError(
                        f"operator {name!r} declares device=True with a "
                        "windowed state: device operators cannot be "
                        "segmented-pane kernels in v1 (panes fire inside "
                        "the watermark path, which must drain the "
                        "in-flight dispatch window first)")
                if kernel is not None and getattr(kernel, "segmented",
                                                  False):
                    raise ValueError(
                        f"operator {name!r} declares device=True with a "
                        "@segmented kernel: device operators cannot be "
                        "segmented-pane kernels in v1")
        except ValueError as e:
            raise TopologyError(str(e)) from None
        state_bytes = state.bytes_per_tuple() if state is not None else 0.0
        resident = state.resident_tuples() if state is not None else 0.0
        # event-time pane buffers shard the stream across replicas; count-
        # window history is per-replica arrival position and replicates
        shared = state is None or state.window is None or state.window.time
        if state is not None:
            mem = tuple_bytes + state_bytes
        else:
            mem = tuple_bytes if mem_bytes is None else mem_bytes
        names, esel = self._normalize_inputs(name, inputs)
        self._declare(_OpDecl(
            name, kernel,
            OperatorSpec(name, exec_ns, tuple_bytes, mem, selectivity,
                         state_bytes=state_bytes,
                         state_resident_tuples=resident,
                         state_resident_shared=shared,
                         device=device, device_ns=float(device_ns),
                         dispatch_depth=dispatch_depth),
            inputs=names, edge_selectivity=esel, partition=partition,
            source=None, key_by=key_by, state=state, fuse=fuse))
        return self

    def sink(self, name: str, kernel: Optional[Callable] = None,
             **kwargs) -> "Topology":
        """Convenience alias: a sink is an operator nothing consumes."""
        kwargs.setdefault("exec_ns", 100.0)
        return self.op(name, kernel, **kwargs)

    def _normalize_inputs(self, name, inputs):
        esel: Dict[str, float] = {}
        if inputs is None:
            if self._last is None:
                raise TopologyError(
                    f"operator {name!r} has no inputs and no upstream "
                    "operator to chain from (declare a spout first)")
            names = [self._last]
        elif isinstance(inputs, str):
            names = [inputs]
        elif isinstance(inputs, Mapping):
            names = list(inputs)
            esel = {u: float(s) for u, s in inputs.items()}
        else:
            names = list(inputs)
        if not names:
            raise TopologyError(f"operator {name!r} declares an empty "
                                "input list")
        if len(set(names)) != len(names):
            raise TopologyError(f"operator {name!r} lists a duplicate input")
        return names, esel

    def _declare(self, decl: _OpDecl) -> None:
        if decl.name in self._decls:
            raise TopologyError(f"duplicate operator {decl.name!r}")
        self._decls[decl.name] = decl
        self._last = decl.name

    # -- introspection ----------------------------------------------------
    @property
    def operators(self) -> List[str]:
        return list(self._decls)

    @property
    def partition(self) -> Dict[str, PartitionDecl]:
        """Declared non-default partition strategies (consumer -> strategy
        or per-producer mapping)."""
        return {n: d.partition for n, d in self._decls.items()
                if d.partition != "shuffle"}

    @property
    def key_by(self) -> Dict[str, KeyBy]:
        """Declared key extractors (consumer -> column index or callable)."""
        return {n: d.key_by for n, d in self._decls.items()
                if d.key_by is not None}

    @property
    def state(self) -> Dict[str, StateSpec]:
        """Declared managed state (operator -> StateSpec)."""
        return {n: d.state for n, d in self._decls.items()
                if d.state is not None}

    @property
    def event_time(self) -> Dict[str, KeyBy]:
        """Declared spout event-time extractors (spout -> column/callable)."""
        return {n: d.event_time for n, d in self._decls.items()
                if d.event_time is not None}

    @property
    def watermark_every(self) -> Dict[str, int]:
        """Declared non-default batch-count watermark cadences."""
        return {n: d.watermark_every for n, d in self._decls.items()
                if d.watermark_every != 1}

    @property
    def watermark_interval(self) -> Dict[str, float]:
        """Declared event-time watermark cadences (spout -> T units)."""
        return {n: d.watermark_interval for n, d in self._decls.items()
                if d.watermark_interval is not None}

    @property
    def no_fuse(self) -> frozenset:
        """Operators that opted out of fusion (``op(fuse=False)``)."""
        return frozenset(n for n, d in self._decls.items() if not d.fuse)

    @property
    def is_executable(self) -> bool:
        """True when every non-spout op has a kernel and every spout a
        source — i.e. ``build()`` would succeed where ``build_logical()``
        does."""
        return all((d.spec.is_spout and d.source is not None) or
                   (not d.spec.is_spout and d.kernel is not None)
                   for d in self._decls.values())

    # -- validation + build ----------------------------------------------
    def build_logical(self) -> LogicalGraph:
        """Validate the declarations and compile the logical DAG."""
        if not self._decls:
            raise TopologyError(f"topology {self.name!r} declares no "
                                "operators")
        spouts = [n for n, d in self._decls.items() if d.spec.is_spout]
        if not spouts:
            raise TopologyError(f"topology {self.name!r} has no spout")
        edges: List[tuple] = []
        esel: Dict[tuple, float] = {}
        for name, decl in self._decls.items():
            for u in decl.inputs:
                if u not in self._decls:
                    raise TopologyError(
                        f"operator {name!r} reads from unknown operator "
                        f"{u!r} (declared: {sorted(self._decls)})")
                edges.append((u, name))
                if u in decl.edge_selectivity:
                    esel[(u, name)] = decl.edge_selectivity[u]
        for u, v in edges:
            if self._decls[v].spec.is_spout:
                raise TopologyError(f"spout {v!r} cannot have inputs "
                                    f"(edge {u!r} -> {v!r})")
        self._check_acyclic(edges)
        self._check_watermark_coverage(edges)
        ops = {n: d.spec for n, d in self._decls.items()}
        return LogicalGraph(ops, edges, esel)

    def _check_watermark_coverage(self, edges) -> None:
        """Every spout upstream of an event-time window must declare
        ``event_time=``: the merged watermark is a *min* over input lanes,
        so one watermark-less ancestor pins it at -inf forever and no pane
        can ever fire — the classic stuck-watermark deadlock, rejected at
        build time instead of hanging at run time."""
        windowed = [n for n, d in self._decls.items()
                    if d.state is not None and d.state.window is not None
                    and d.state.window.time]
        if not windowed:
            return
        producers: Dict[str, List[str]] = {}
        for u, v in edges:
            producers.setdefault(v, []).append(u)
        for op in windowed:
            frontier, seen = [op], set()
            while frontier:
                n = frontier.pop()
                if n in seen:
                    continue
                seen.add(n)
                frontier.extend(producers.get(n, []))
            silent = sorted(
                n for n in seen
                if self._decls[n].spec.is_spout
                and self._decls[n].event_time is None)
            if silent:
                raise TopologyError(
                    f"operator {op!r} declares an event-time window but "
                    f"upstream spouts {silent} declare no event_time= — "
                    "their watermark lanes would stay at -inf and the "
                    "window could never fire")

    def _check_acyclic(self, edges) -> None:
        indeg = {n: 0 for n in self._decls}
        for _, v in edges:
            indeg[v] += 1
        frontier = [n for n, d in indeg.items() if d == 0]
        seen = 0
        while frontier:
            n = frontier.pop()
            seen += 1
            for u, v in edges:
                if u == n:
                    indeg[v] -= 1
                    if indeg[v] == 0:
                        frontier.append(v)
        if seen != len(self._decls):
            # every non-spout op declares >=1 input and spouts accept none,
            # so any operator unreachable from a spout is also on a cycle —
            # this check covers both
            cyclic = sorted(n for n, d in indeg.items() if d > 0)
            raise TopologyError(
                f"topology {self.name!r} has a cycle involving {cyclic}")

    def build(self) -> StreamingApp:
        """Compile to an executable :class:`StreamingApp` (graph + kernels +
        sources + partition declarations)."""
        graph = self.build_logical()
        missing = [n for n, d in self._decls.items()
                   if not d.spec.is_spout and d.kernel is None]
        if missing:
            raise TopologyError(
                f"operators without kernels cannot execute: {missing} "
                "(use build_logical() for planning-only topologies)")
        unsourced = [n for n, d in self._decls.items()
                     if d.spec.is_spout and d.source is None]
        if unsourced:
            raise TopologyError(
                f"spouts without source generators: {unsourced}")
        kernels = {n: d.kernel for n, d in self._decls.items()
                   if d.kernel is not None}
        sources = {n: d.source for n, d in self._decls.items()
                   if d.source is not None}
        return StreamingApp(self.name, graph, kernels,
                            make_source=next(iter(sources.values())),
                            partition=self.partition, sources=sources,
                            key_by=self.key_by, state=self.state,
                            event_time=self.event_time,
                            watermark_every=self.watermark_every,
                            watermark_interval=self.watermark_interval,
                            checkpoint_every=self.checkpoint_every,
                            no_fuse=self.no_fuse)


# ---------------------------------------------------------------------------
# Unified result record
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Metrics:
    """Common result shape for estimate / simulate / execute.

    ``source`` tags provenance: "estimate" (analytical model), "fluid" /
    "des" (simulators), "runtime" (real threads).  Latency percentiles are
    NaN where the backend does not model latency; ``raw`` keeps the
    backend-specific result (PlanEval / FluidResult / DesResult /
    RuntimeResult) for detailed inspection.
    """

    source: str
    throughput: float                  # R, sink tuples/s
    latency_p50: float = math.nan      # seconds, spout entry -> sink
    latency_p99: float = math.nan
    feasible: bool = True
    cpu_usage: Optional[np.ndarray] = None     # per-socket core-secs/sec
    mem_usage: Optional[np.ndarray] = None     # per-socket bytes/s
    violations: List[str] = dataclasses.field(default_factory=list)
    raw: object = None

    def summary(self) -> str:
        lat = ("" if math.isnan(self.latency_p50) else
               f" p50={self.latency_p50*1e6:.0f}us "
               f"p99={self.latency_p99*1e6:.0f}us")
        return (f"[{self.source}] R={self.throughput:,.0f} tuples/s "
                f"feasible={self.feasible}{lat}")


# ---------------------------------------------------------------------------
# Job facade: topology/app -> Plan -> estimate/simulate/execute
# ---------------------------------------------------------------------------

OPTIMIZERS = ("rlas", "bnb", "ff", "rr", "random", "manual")


class Job:
    """One streaming job: a topology plus everything you can do with it.

    The job compiles its :class:`~.routing.RoutingTable` once — the same
    tables the runtime executes and the DES measures — and every planner
    call reads edge selectivity/partition from it, so estimate, simulate and
    execute share one source of truth.  ``plan()`` results are cached per
    ``(machine, optimizer, settings)``; :meth:`Plan.replan` re-plans on a
    new machine through the same cache (the elastic path of
    ``launch/elastic.py``).
    """

    def __init__(self, source: Union[Topology, StreamingApp, LogicalGraph]):
        declared_partition: Dict[str, str] = {}
        declared_key_by: Dict[str, KeyBy] = {}
        declared_state: Dict[str, StateSpec] = {}
        declared_no_fuse: frozenset = frozenset()
        if isinstance(source, Topology):
            if source.is_executable:
                self.app: Optional[StreamingApp] = source.build()
                self.graph = self.app.graph
            else:
                # planning-only: the declaration's routing semantics must
                # still reach the planner
                self.app = None
                self.graph = source.build_logical()
                declared_partition = source.partition
                declared_key_by = source.key_by
                declared_state = source.state
                declared_no_fuse = source.no_fuse
            self.name = source.name
        elif isinstance(source, StreamingApp):
            self.app = source
            self.graph = source.graph
            self.name = source.name
        elif isinstance(source, LogicalGraph):
            self.app = None
            self.graph = source
            self.name = "job"
        else:
            raise TypeError(
                f"Job expects Topology, StreamingApp or LogicalGraph, "
                f"got {type(source).__name__}")
        self.routes = compile_routes(
            self.app if self.app is not None else self.graph,
            partition=declared_partition, key_by=declared_key_by)
        if self.app is not None:
            self.no_fuse = frozenset(getattr(self.app, "no_fuse", ()))
            self.time_windows = self.app.time_windows()
        else:
            self.no_fuse = declared_no_fuse
            self.time_windows = {
                op: sp.window for op, sp in declared_state.items()
                if sp.window is not None and sp.window.time}
        self._reprice_window_residency()
        self._plan_cache: Dict[tuple, "Plan"] = {}

    def _reprice_window_residency(self) -> None:
        """Price event-time pane occupancy from the *probed* event-time
        spacing instead of the declared grid alone.

        ``WindowSpec.resident_tuples`` defaults to the one-tick-per-tuple
        convention; a source whose event clock advances faster (sparse
        ticks) holds proportionally fewer rows resident, and one that
        advances slower (bursty readings per tick) holds more.  The probe
        (:func:`~.simulator.probe_et_spacing`, seeded source draws) feeds
        the planner's ``OperatorSpec.state_resident_tuples`` ->
        ``PlanEval.state_resident_bytes`` ledger here, at Job construction
        — only the planner-side graph is rewritten; the app's executable
        graph is untouched.  Sources at the default spacing (all benchmark
        apps) reprice to exactly the declared value."""
        if self.app is None or not self.time_windows:
            return
        from .runtime import upstream_spouts
        from .simulator import probe_et_spacing
        spacing = probe_et_spacing(self.app)
        ops = dict(self.graph.operators)
        changed = False
        for op, w in self.time_windows.items():
            sps = [spacing[s] for s in upstream_spouts(self.graph, op)
                   if s in spacing]
            if not sps:
                continue
            # the slowest-advancing ancestor clock bounds retention: the
            # merged watermark is a min over lanes
            resident = w.resident_tuples(min(sps))
            if resident != ops[op].state_resident_tuples:
                ops[op] = dataclasses.replace(
                    ops[op], state_resident_tuples=resident)
                changed = True
        if changed:
            self.graph = LogicalGraph(ops, list(self.graph.edges),
                                      dict(self.graph.edge_selectivity))

    def plan(self, machine: MachineSpec, optimizer: str = "rlas", *,
             input_rate: Optional[float] = None,
             parallelism: Optional[Dict[str, int]] = None,
             compress_ratio: int = 1, seed: int = 0,
             cache: bool = True, fuse: object = "off", **kw) -> "Plan":
        """Produce an execution plan (replication + placement).

        ``optimizer``: "rlas" (joint scaling + B&B placement, the paper),
        "bnb" (B&B placement at fixed ``parallelism``), "ff"/"rr" (§6.4
        baselines at fixed ``parallelism``), "random" (Fig. 14 sample;
        honours ``rng=`` for reproducible Monte-Carlo sweeps), or "manual"
        (caller-supplied ``placement=`` list, one socket per unit).

        ``fuse`` prices operator fusion (docs/API.md §3e): "off" (default)
        plans the graph as declared; "auto" detects maximal 1:1
        shuffle-routed chains and plans each as a single operator with
        summed service time and zero intra-chain comm cost — letting the
        optimizer trade fusion against replication; an explicit list of
        chains (e.g. ``[["parser", "filter"]]``) fuses exactly those,
        raising on ineligible edges.  The resulting plan's
        ``parallelism`` is expanded back to member names and its
        ``chains`` are handed to ``execute()`` so the runtime realizes
        the same fused pipeline the planner priced.

        Identical requests return the cached :class:`Plan` (pass
        ``cache=False`` to force a fresh search); "random" plans and
        requests with unhashable settings are never cached.
        """
        if parallelism:
            validate_operator_names(self.graph, parallelism, "parallelism")
        # snapshot mutable settings so later caller-side mutation cannot
        # change what replan() replays or what the cache key describes
        options = {k: dict(v) if isinstance(v, dict) else
                   list(v) if isinstance(v, list) else v
                   for k, v in dict(kw, input_rate=input_rate,
                                    parallelism=parallelism,
                                    compress_ratio=compress_ratio,
                                    seed=seed, fuse=fuse).items()}
        key = None if not cache or optimizer == "random" else \
            _plan_cache_key(machine, optimizer, options)
        if key is not None and key in self._plan_cache:
            return self._plan_cache[key]
        plan = self._plan(machine, optimizer, input_rate, parallelism,
                          compress_ratio, seed, fuse, kw)
        plan.options = options
        if key is not None:
            self._plan_cache[key] = plan
        return plan

    def _plan(self, machine, optimizer, input_rate, parallelism,
              compress_ratio, seed, fuse, kw) -> "Plan":
        chains: List[List[str]] = []
        graph_l, routes = self.graph, self.routes
        if fuse is not None and fuse != "off":
            from .fusion import (detect_chains, expand_parallelism,
                                 fuse_graph, fuse_parallelism,
                                 validate_chains)
            if fuse == "auto":
                chains = detect_chains(
                    graph_l, routes, no_fuse=self.no_fuse,
                    time_windows=set(self.time_windows),
                    parallelism=parallelism)
            else:
                chains = validate_chains(
                    graph_l, routes, fuse, no_fuse=self.no_fuse,
                    time_windows=set(self.time_windows))
                if parallelism:
                    # mismatched replica counts cannot fuse — drop, the
                    # same forgiveness prepare_app applies at run time
                    chains = [c for c in chains if len(
                        {parallelism.get(m, 1) for m in c}) == 1]
            if chains:
                graph_l, routes = fuse_graph(graph_l, routes, chains)
                if parallelism:
                    parallelism = fuse_parallelism(parallelism, chains)
        plan = self._plan_graph(graph_l, routes, machine, optimizer,
                                input_rate, parallelism, compress_ratio,
                                seed, kw)
        if chains:
            # callers (and execute()) speak member names; the fused unit
            # scales as one, so every member inherits its replica count
            plan.parallelism = expand_parallelism(plan.parallelism, chains)
            plan.chains = [list(c) for c in chains]
        return plan

    def _plan_graph(self, graph_l, routes, machine, optimizer, input_rate,
                    parallelism, compress_ratio, seed, kw) -> "Plan":
        if optimizer == "rlas":
            res = rlas_optimize(graph_l, machine, input_rate=input_rate,
                                compress_ratio=compress_ratio,
                                initial_parallelism=parallelism,
                                routes=routes, **kw)
            return Plan(self, machine, res.graph,
                        list(res.placement.placement),
                        dict(res.parallelism), "rlas", input_rate,
                        res.placement.eval, res)
        if optimizer == "random":
            rng = kw.pop("rng", None)
            if rng is None:
                rng = np.random.default_rng(seed)
            if parallelism is not None:
                raise TypeError(
                    "optimizer='random' draws its own replication "
                    "(paper Fig. 14 protocol) and would silently discard "
                    "the parallelism argument")
            if kw:
                raise TypeError(f"unexpected arguments for optimizer="
                                f"'random': {sorted(kw)}")
            graph, placement, ev = random_plan(
                graph_l, machine, rng, input_rate=input_rate,
                compress_ratio=compress_ratio, routes=routes)
            return Plan(self, machine, graph, list(placement),
                        dict(graph.parallelism), "random", input_rate,
                        ev, None)
        par = {name: 1 for name in graph_l.operators}
        par.update(parallelism or {})
        graph = ExecutionGraph(graph_l, par, compress_ratio,
                               routes=routes)
        if optimizer == "manual":
            if "placement" not in kw:
                raise TypeError("optimizer='manual' requires a placement= "
                                "list (one socket per execution unit)")
            placement = list(kw.pop("placement"))
            if kw:
                raise TypeError(f"unexpected arguments for optimizer="
                                f"'manual': {sorted(kw)}")
            if len(placement) != graph.n_units:
                raise ValueError(
                    f"manual placement has {len(placement)} entries for "
                    f"{graph.n_units} execution units")
            bad = sorted({s for s in placement
                          if s != -1 and not 0 <= s < machine.n_sockets})
            if bad:
                raise ValueError(
                    f"manual placement names sockets {bad} on a "
                    f"{machine.n_sockets}-socket machine (-1 = unplaced)")
            ev = evaluate(graph, machine, placement, input_rate)
            return Plan(self, machine, graph, placement, par, "manual",
                        input_rate, ev, None)
        if optimizer == "bnb":
            pres = bnb_place(graph, machine, input_rate, **kw)
        elif optimizer in ("ff", "rr"):
            if kw:
                raise TypeError(f"unexpected arguments for optimizer="
                                f"{optimizer!r}: {sorted(kw)}")
            place = ff_place if optimizer == "ff" else rr_place
            pres = place(graph, machine, input_rate)
        else:
            raise ValueError(f"unknown optimizer {optimizer!r} "
                             f"(choose from {OPTIMIZERS})")
        return Plan(self, machine, graph, list(pres.placement), par,
                    optimizer, input_rate, pres.eval, pres)


def _plan_cache_key(machine: MachineSpec, optimizer: str,
                    options: Dict) -> Optional[tuple]:
    """Hashable identity of a plan request, or None when uncacheable."""
    opts = []
    for k, v in sorted(options.items()):
        if isinstance(v, dict):
            v = tuple(sorted(v.items()))
        elif isinstance(v, list):
            v = tuple(v)
        opts.append((k, v))
    key = (machine.name, machine.n_sockets, machine.cores_per_socket,
           machine.local_bw, machine.cache_line, machine.ghz,
           machine.Q.tobytes(), machine.L.tobytes(),
           optimizer, tuple(opts))
    try:
        hash(key)
    except TypeError:
        return None
    return key


@dataclasses.dataclass
class Plan:
    """An execution plan: (replication, placement) on a concrete machine.

    The same object flows through the paper's Table 4 protocol:
    ``estimate()`` -> ``simulate()`` -> ``execute()``.
    """

    job: Job
    machine: MachineSpec
    graph: ExecutionGraph
    placement: List[int]
    parallelism: Dict[str, int]
    optimizer: str
    input_rate: Optional[float]
    eval: object                        # PlanEval from planning, if any
    result: object                      # optimizer-specific result
    options: Dict = dataclasses.field(default_factory=dict)
    #: fusion chains the plan was priced with (``plan(fuse=...)``); the
    #: fused names live in ``graph``/``placement`` while ``parallelism``
    #: is expanded back to member names, and ``execute()`` forwards the
    #: chains so the runtime realizes the same fused pipeline
    chains: List[List[str]] = dataclasses.field(default_factory=list)

    @property
    def feasible(self) -> bool:
        return bool(self.eval is not None and self.eval.feasible)

    def replan(self, machine: MachineSpec, **overrides) -> "Plan":
        """Re-plan this job for a different machine (elastic path).

        Mirrors ``launch/elastic.replan``: the same optimizer and search
        settings are re-run against the new topology — replication and
        placement are re-derived from the performance model, not hand-edited
        — and the result lands in the job's plan cache.
        """
        opts = dict(self.options)
        opts.update(overrides)
        if self.optimizer == "manual" and "placement" not in overrides:
            # the stored placement names THIS plan's sockets; replaying it
            # on a different machine is stale at best, out of range at worst
            raise ValueError(
                "manual plans carry a machine-specific placement; pass "
                "placement= for the new machine or replan with an "
                "optimizer")
        return self.job.plan(machine, self.optimizer, **opts)

    @property
    def R(self) -> float:
        """Planner's estimated throughput (0 when infeasible)."""
        return self.eval.R if self.feasible else 0.0

    @property
    def total_threads(self) -> int:
        return self.graph.total_threads()

    def describe(self) -> str:
        placed = {}
        for idx, rep in enumerate(self.graph.replicas):
            placed.setdefault(rep.op, []).append(self.placement[idx])
        rows = [f"  {op:<16} x{self.graph.parallelism.get(op, 1):<4} "
                f"sockets={sorted(set(s))}" for op, s in placed.items()]
        return (f"Plan[{self.optimizer}] for {self.job.name!r} on "
                f"{self.machine.name} ({self.total_threads} threads, "
                f"R={self.R:,.0f} tuples/s)\n" + "\n".join(rows))

    # -- the three measurement backends -----------------------------------
    def estimate(self, input_rate=_UNSET, tf_mode: str = "relative",
                 mix: str = "weighted") -> Metrics:
        """Analytical §3.1 rate model (instant, no simulation)."""
        rate = self.input_rate if input_rate is _UNSET else input_rate
        ev = evaluate(self.graph, self.machine, self.placement, rate,
                      mix=mix, tf_mode=tf_mode)
        return Metrics("estimate", ev.R, feasible=ev.feasible,
                       cpu_usage=ev.cpu_usage, mem_usage=ev.mem_usage,
                       violations=list(ev.violations), raw=ev)

    def simulate(self, backend: str = "des", *, input_rate=_UNSET,
                 batch: Optional[int] = None, horizon: Optional[float] = None,
                 seed: Optional[int] = None, **kw) -> Metrics:
        """Measurement oracle: "des" (jumbo-tuple discrete-event sim with
        latency percentiles) or "fluid" (fixed-point rate solver that
        degrades under contention).  ``input_rate=None`` measures saturation
        capacity (the paper's §6.1 protocol).  ``batch``/``horizon``/``seed``
        are DES-only (defaults 64 / 0.02 s / 0); the fluid solver rejects
        them rather than silently ignore a parameter sweep."""
        from .simulator import des_simulate, fluid_solve, measure_capacity
        rate = self.input_rate if input_rate is _UNSET else input_rate
        if backend == "fluid":
            stray = [n for n, v in [("batch", batch), ("horizon", horizon),
                                    ("seed", seed)] if v is not None]
            if stray:
                raise TypeError(
                    f"simulate(backend='fluid') does not take {stray} "
                    "(DES-only parameters)")
            fl = fluid_solve(self.graph, self.machine, self.placement,
                             input_rate=rate, **kw)
            return Metrics("fluid", fl.R, raw=fl)
        if backend != "des":
            raise ValueError(f"unknown simulate backend {backend!r} "
                             "(choose 'des' or 'fluid')")
        batch = 64 if batch is None else batch
        horizon = 0.02 if horizon is None else horizon
        seed = 0 if seed is None else seed
        # declared event-time windows ride along so the DES paces pane
        # firing and reports pane latency (DesResult.pane_latency_*)
        if self.job.time_windows and "time_windows" not in kw:
            kw["time_windows"] = self.job.time_windows
        # pace each spout's event clock at its *measured* increment (a
        # seeded source probe) instead of the one-tick-per-tuple constant,
        # so pane latency percentiles track bursty sources
        if kw.get("time_windows") and "et_spacing" not in kw \
                and self.job.app is not None:
            from .simulator import probe_et_spacing
            kw["et_spacing"] = probe_et_spacing(self.job.app, batch=batch,
                                                seed=seed)
        # keyed pane groups fire one pane per occupied key per span: probe
        # the per-span multiplicity so DES pane counts match the runtime's
        # sharded-pane union instead of the bare grid walk
        if kw.get("time_windows") and "pane_keys" not in kw \
                and self.job.app is not None \
                and any(w.keyed for w in kw["time_windows"].values()):
            from .simulator import probe_pane_keys
            kw["pane_keys"] = probe_pane_keys(self.job.app, batch=batch,
                                              seed=seed)
        if rate is None:
            des = measure_capacity(self.graph, self.machine, self.placement,
                                   batch=batch, horizon=horizon, seed=seed,
                                   **kw)
        else:
            des = des_simulate(self.graph, self.machine, self.placement,
                               input_rate=rate, batch=batch,
                               horizon=horizon, seed=seed, **kw)
        return Metrics("des", des.R, des.latency_p50, des.latency_p99,
                       raw=des)

    def execute(self, *, duration: float = 1.0, batch: int = 256,
                jumbo: bool = True, queue_cap: int = 32,
                partition: Optional[Dict[str, str]] = None,
                parallelism: Optional[Dict[str, int]] = None,
                max_threads: Optional[int] = None, seed: int = 0,
                vectorized: Optional[bool] = None,
                batches: Optional[int] = None,
                initial_states: Optional[Dict[str, list]] = None,
                backend: str = "threads", faithful: bool = True,
                env: Optional[Dict[str, str]] = None,
                timeout: Optional[float] = None,
                dispatch_depth: Optional[int] = None,
                initial_offsets: Optional[Dict[str, int]] = None,
                checkpoint_every: Optional[int] = None,
                checkpoint_dir: Optional[str] = None,
                from_checkpoint: Optional[object] = None,
                final_watermark: bool = True) -> Metrics:
        """Run the plan on this host's real runtime.

        ``backend`` selects the execution substrate from the
        :mod:`repro_torch.streaming.procexec` registry: ``"threads"`` (default —
        one thread per replica in this process, unchanged semantics) or
        ``"processes"`` (one pinned worker process per plan-assigned core
        group, tuples crossing groups over shared-memory rings).  Both
        produce byte-identical outputs and state under deterministic
        replay — the backend parity contract ``tests/test_procexec.py``
        pins down.

        Under ``backend="processes"``, ``faithful=True`` (default) realizes
        the plan's *placement*: replicas grouped by their plan-assigned
        socket (one worker per socket, colocated replicas communicate
        in-process, cross-socket streams pay a real shared-memory
        serialize+copy), workers pinned to the socket's share of the host
        cores via ``os.sched_setaffinity``.  ``faithful=False`` gives every
        replica its own worker.  ``env`` seeds extra environment variables
        into each worker before kernels run (e.g.
        :func:`~repro_torch.streaming.procexec.host_device_env` for the
        workers of a device app, which all share the one CUDA card);
        ``timeout`` bounds the whole run — a wedged ring fails fast instead
        of hanging.

        The plan's replication levels target the *modelled* machine; by
        default they are scaled down to ``max_threads`` (2x host cores)
        respecting the plan evaluation's per-operator core demand —
        bottleneck operators keep their share instead of shrinking
        uniformly.  Pass ``parallelism`` to override entirely.

        ``batches`` runs each spout for exactly that many batches instead of
        ``duration`` seconds (deterministic input — the replay mode behind
        state-migration conservation checks); ``initial_states`` seeds
        per-replica operator state, typically from
        :func:`repro_torch.streaming.state.migrate_states` after a ``replan``.

        ``dispatch_depth`` overrides every device operator's declared async
        in-flight window (1 = synchronous, the A/B flag);
        ``initial_offsets`` resumes spouts from a previous run's
        ``RuntimeResult.spout_offsets`` counters (prefix-continuation of
        duration-mode runs).

        ``checkpoint_every`` (or ``Topology(checkpoint_every=)``) turns on
        aligned-barrier checkpointing on either backend; completed
        snapshots land in ``Metrics.raw.checkpoints`` and, with
        ``checkpoint_dir``, on disk.  ``from_checkpoint`` resumes from a
        snapshot (byte-identical continuation — see ``docs/API.md`` §3d);
        note it pins parallelism to the checkpoint's, overriding the
        plan's scaling.  ``final_watermark=False`` suspends an event-time
        run instead of draining it, keeping pane buffers resident for
        ``migrate_states``.
        """
        from .procexec import get_backend
        run_backend = get_backend(backend)
        if self.job.app is None:
            raise TopologyError(
                f"job {self.job.name!r} is planning-only (no kernels); "
                "build the topology with kernels and sources to execute")
        if from_checkpoint is not None and parallelism is None:
            # snapshots are per-replica: the resumed run must re-create the
            # checkpoint's replica layout, not the plan's scaled one
            parallelism = dict(getattr(from_checkpoint, "parallelism", {}))
        if parallelism is None:
            budget = max_threads if max_threads is not None else \
                2 * (os.cpu_count() or 2)
            if self.chains:
                # scale on fused names (one demand share per fused unit,
                # matching the plan evaluation) and expand after, so every
                # chain member keeps an equal replica count — a mismatched
                # down-scaling would silently unfuse the chain at prepare
                from .fusion import expand_parallelism
                scaled = _scale_parallelism(dict(self.graph.parallelism),
                                            budget, self.eval, self.graph)
                parallelism = expand_parallelism(scaled, self.chains)
            else:
                parallelism = _scale_parallelism(self.parallelism, budget,
                                                 self.eval, self.graph)
            # auto-derived plans clamp non-keyed event-time windowed ops
            # to one replica (run_app rejects them outright): panes fire
            # per replica, so a shuffle split would shatter every pane.
            # Keyed routes keep their planned replication — with keyed
            # pane groups (WindowSpec(keyed=True)) the pane unit is
            # (key, span) and replication preserves pane bytes exactly
            for op in self.job.time_windows:
                prods = self.job.graph.producers(op)
                keyed = bool(prods) and all(
                    self.job.routes.strategy(u, op) == "key"
                    for u in prods)
                if not keyed:
                    parallelism[op] = 1
        kw: Dict[str, object] = {}
        if self.chains:
            # only forwarded when the plan priced fusion, so custom
            # registered backends without a fuse= parameter keep working
            kw["fuse"] = [list(c) for c in self.chains]
        if backend != "threads":
            kw.update(env=env, timeout=timeout)
            if faithful:
                from .procexec import plan_placement
                groups, pins = plan_placement(self, parallelism)
                kw.update(groups=groups, pin=pins)
        elif env is not None:
            raise ValueError(
                "env= requires backend='processes' (threads share this "
                "process's environment)")
        rt = run_backend(self.job.app, parallelism=parallelism, batch=batch,
                         duration=duration, jumbo=jumbo, queue_cap=queue_cap,
                         partition=partition, seed=seed,
                         vectorized=vectorized, max_batches=batches,
                         initial_states=initial_states,
                         dispatch_depth=dispatch_depth,
                         initial_offsets=initial_offsets,
                         checkpoint_every=checkpoint_every,
                         checkpoint_dir=checkpoint_dir,
                         from_checkpoint=from_checkpoint,
                         final_watermark=final_watermark, **kw)
        return Metrics("runtime", rt.throughput, rt.latency_p50,
                       rt.latency_p99, raw=rt)


def _scale_parallelism(parallelism: Dict[str, int], budget: int,
                       plan_eval: object = None,
                       graph: Optional[ExecutionGraph] = None
                       ) -> Dict[str, int]:
    """Shrink replication to fit ``budget`` threads (>=1 per operator).

    With a plan evaluation available, threads are allotted proportionally to
    each operator's modelled core demand (``PlanEval.utilization``) by
    largest remainder, capped at the planned replication — the bottleneck
    ratios the optimizer balanced survive the down-mapping instead of being
    flattened by uniform proportional scaling.  Without one (or with an
    all-idle evaluation) the old proportional rule applies.
    """
    total = sum(parallelism.values())
    if total <= budget:
        return dict(parallelism)
    demand: Optional[Dict[str, float]] = None
    util = getattr(plan_eval, "utilization", None)
    if util is not None and graph is not None \
            and len(util) == len(graph.replicas):
        demand = {}
        for idx, rep in enumerate(graph.replicas):
            demand[rep.op] = demand.get(rep.op, 0.0) + float(util[idx])
        if not all(op in demand for op in parallelism) or \
                sum(demand.values()) <= 0:
            demand = None
    if demand is None or budget < len(parallelism):
        scale = budget / total
        return {op: max(1, int(k * scale)) for op, k in parallelism.items()}
    tot = sum(demand.values())
    raw = {op: budget * demand[op] / tot for op in parallelism}
    # one thread each, then award the rest by largest unmet demand (capped
    # at the planned replication) — never exceeds the budget, unlike
    # rounding raw shares up per-operator
    alloc = {op: 1 for op in parallelism}
    for _ in range(budget - len(alloc)):
        candidates = [o for o in parallelism if alloc[o] < parallelism[o]]
        if not candidates:
            break
        best = max(candidates, key=lambda o: (raw[o] - alloc[o], o))
        alloc[best] += 1
    return alloc
