"""Operator graphs (paper §2.2).

A :class:`LogicalGraph` is the application DAG: vertices are continuously
running operators, edges are streams.  Replication expands it into an
:class:`ExecutionGraph` whose vertices are *replicas* (the schedulable unit —
"we refer a replica of an operator simply as an operator", §3.1).  Shuffle
partitioning connects every producer replica to every consumer replica with
the producer's output split evenly.

The *compress-graph* heuristic (§4, heuristic 3) groups up to ``ratio``
replicas of one logical operator into a single schedulable unit whose capacity
and resource demand scale with the group size.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class OperatorSpec:
    """Profiled operator specification (paper Table 1, "operator specific").

    ``exec_ns``  — T^e, average execution+emit time per input tuple (ns).
    ``tuple_bytes`` — N, average size of one *input* tuple fetched from the
                   producer (bytes).
    ``mem_bytes``  — M, memory traffic per processed tuple (bytes) charged
                   against the local-bandwidth budget B.
    ``selectivity`` — output tuples emitted per input tuple processed.
    ``state_bytes`` — the share of ``mem_bytes`` attributable to *declared
                   operator state* (``repro_torch.streaming.state.StateSpec``):
                   when an operator declares managed state, its topology
                   derives ``mem_bytes = tuple_bytes + state_bytes`` from
                   the declaration instead of a hand-tuned constant, and
                   the model reports the state share separately
                   (``PlanEval.state_usage``).
    ``state_resident_tuples`` — window-buffer *occupancy* in tuples: how
                   many rows the operator's declared window holds resident
                   at once (event-time windows buffer ``size + lateness``
                   event-time units of stream awaiting watermark passage;
                   count windows hold ``size`` arrivals of history — the
                   degenerate segmented case).  The model multiplies it by
                   the tuple size (shared across an operator's replicas —
                   each shard buffers its slice of the stream) to expose
                   the memory pinned by in-flight pane batches
                   (``PlanEval.state_resident_bytes``).  Occupancy is
                   rate-independent: pricing residency in wall-seconds
                   Little's-law style over-charged event-time operators by
                   orders of magnitude (a 64-tick pane is microseconds of
                   buffering at realistic rates, not 64 seconds).
    """

    name: str
    exec_ns: float
    tuple_bytes: float = 64.0
    mem_bytes: float = 64.0
    selectivity: float = 1.0
    is_spout: bool = False
    state_bytes: float = 0.0
    state_resident_tuples: float = 0.0
    #: True when the occupancy is a property of the *stream* and shards
    #: across the operator's replicas (event-time pane buffers: each keyed
    #: shard holds its slice of the same size+lateness span); False when
    #: every replica holds its own full buffer (count-window history is
    #: per-replica arrival position, so replication multiplies it)
    state_resident_shared: bool = True
    #: device operator: the kernel runs the port's own device computation
    #: on a CUDA card, its result lazy until the Executor retires it.
    #: ``device_ns`` is the per-tuple device compute time; ``exec_ns`` keeps
    #: its meaning as the *host-side* work (decode/route/emit).
    #: ``dispatch_depth`` is the bounded in-flight dispatch window the
    #: Executor runs with (1 == synchronous).
    device: bool = False
    device_ns: float = 0.0
    dispatch_depth: int = 1

    @property
    def exec_s(self) -> float:
        """Effective per-tuple service time in seconds.

        Host operators: ``exec_ns``.  Device operators at ``dispatch_depth``
        1 pay host + device serially; at depth >= 2 the async dispatch window
        overlaps host ingest with device compute, so the bottleneck is
        ``max(host, device/depth)`` — the planner, placement model, and DES
        all consume this property, so overlap pricing propagates everywhere
        from this one definition.
        """
        if not self.device:
            return self.exec_ns * 1e-9
        if self.dispatch_depth <= 1:
            return (self.exec_ns + self.device_ns) * 1e-9
        return max(self.exec_ns, self.device_ns / self.dispatch_depth) * 1e-9


@dataclasses.dataclass
class LogicalGraph:
    """Application DAG over logical operators.

    ``edge_selectivity`` optionally overrides the producer's default
    selectivity per (producer, consumer) stream — LR's operators emit
    multiple output streams with distinct selectivities (paper Table 8).
    """

    operators: Dict[str, OperatorSpec]
    edges: List[Tuple[str, str]]                 # (producer, consumer)
    edge_selectivity: Dict[Tuple[str, str], float] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        names = set(self.operators)
        for u, v in self.edges:
            assert u in names and v in names, f"unknown edge {u}->{v}"
        self._check_acyclic()

    def sel(self, u: str, v: str) -> float:
        return self.edge_selectivity.get((u, v), self.operators[u].selectivity)

    def _check_acyclic(self) -> None:
        order = self.topo_order()
        assert len(order) == len(self.operators), "graph has a cycle"

    def producers(self, name: str) -> List[str]:
        return [u for u, v in self.edges if v == name]

    def consumers(self, name: str) -> List[str]:
        return [v for u, v in self.edges if u == name]

    def spouts(self) -> List[str]:
        return [n for n, op in self.operators.items() if op.is_spout]

    def sinks(self) -> List[str]:
        cons = {u for u, _ in self.edges}
        return [n for n in self.operators if n not in cons]

    def topo_order(self) -> List[str]:
        indeg = {n: 0 for n in self.operators}
        for _, v in self.edges:
            indeg[v] += 1
        frontier = sorted(n for n, d in indeg.items() if d == 0)
        order: List[str] = []
        while frontier:
            n = frontier.pop(0)
            order.append(n)
            for c in self.consumers(n):
                indeg[c] -= 1
                if indeg[c] == 0:
                    frontier.append(c)
            frontier.sort()
        return order


@dataclasses.dataclass(frozen=True)
class Replica:
    """One schedulable unit: ``group`` replicas of ``op`` scheduled together."""

    op: str                    # logical operator name
    index: int                 # replica-group index within the operator
    group: int                 # number of fused replicas (compression, >=1)
    spec: OperatorSpec

    @property
    def uid(self) -> str:
        return f"{self.op}#{self.index}"


class ExecutionGraph:
    """Replica-level DAG produced from (logical graph, replication levels).

    ``parallelism[name]`` is the replication level of each logical operator.
    ``compress_ratio`` fuses up to that many replicas into one unit
    (heuristic 3); the last unit of an operator may be smaller.

    ``routes`` optionally supplies the compiled routing table
    (:class:`repro_torch.streaming.routing.RoutingTable`, duck-typed here to keep
    the planning core standalone): when given, replica-level edge weights
    come from ``routes.unit_weight`` so the planner models exactly the
    partition strategy and per-stream selectivity the runtime and the DES
    execute.  Without it, edges fall back to the logical graph's
    selectivities under shuffle semantics.
    """

    def __init__(self, logical: LogicalGraph, parallelism: Dict[str, int],
                 compress_ratio: int = 1, routes=None):
        assert compress_ratio >= 1
        self.logical = logical
        self.parallelism = dict(parallelism)
        self.compress_ratio = compress_ratio
        self.routes = routes
        self.replicas: List[Replica] = []
        self._by_op: Dict[str, List[int]] = {}
        for name in logical.topo_order():
            k = self.parallelism.get(name, 1)
            assert k >= 1
            groups = _split_groups(k, compress_ratio)
            idxs = []
            for gi, gsize in enumerate(groups):
                idxs.append(len(self.replicas))
                self.replicas.append(
                    Replica(name, gi, gsize, logical.operators[name]))
            self._by_op[name] = idxs
        # Replica-level edges: producer unit u routes sel(u,v) output tuples
        # per processed input, split over consumer units by group weight
        # (shuffle partitioning).  Edge weight = sel * group_v / k_v, i.e. the
        # tuples arriving at unit v per tuple *processed* by unit u.
        self.edges: List[Tuple[int, int, float]] = []   # (u, v, weight)
        self.in_edges: Dict[int, List[Tuple[int, float]]] = {
            i: [] for i in range(len(self.replicas))}
        self.out_edges: Dict[int, List[Tuple[int, float]]] = {
            i: [] for i in range(len(self.replicas))}
        for pu, cv in logical.edges:
            k_c = self.parallelism.get(cv, 1)
            sel = logical.sel(pu, cv)
            for ui in self._by_op[pu]:
                for vi in self._by_op[cv]:
                    if routes is not None:
                        w = routes.unit_weight(pu, cv,
                                               self.replicas[vi].group, k_c)
                    else:
                        w = sel * self.replicas[vi].group / k_c
                    self.edges.append((ui, vi, w))
                    self.in_edges[vi].append((ui, w))
                    self.out_edges[ui].append((vi, w))

    # -- convenience ------------------------------------------------------
    def units_of(self, op: str) -> List[int]:
        return self._by_op[op]

    @property
    def n_units(self) -> int:
        return len(self.replicas)

    def total_threads(self) -> int:
        return sum(r.group for r in self.replicas)

    def topo_unit_order(self) -> List[int]:
        order: List[int] = []
        for name in self.logical.topo_order():
            order.extend(self._by_op[name])
        return order

    def sink_units(self) -> List[int]:
        return [i for name in self.logical.sinks() for i in self._by_op[name]]

    def spout_units(self) -> List[int]:
        return [i for name in self.logical.spouts() for i in self._by_op[name]]


def _split_groups(k: int, ratio: int) -> List[int]:
    """Split k replicas into ceil(k/ratio) units of size <= ratio."""
    n_units = math.ceil(k / ratio)
    base, rem = divmod(k, n_units)
    return [base + (1 if i < rem else 0) for i in range(n_units)]
