"""One routing substrate: compiled per-edge routes shared by every layer.

The paper's throughput story (§5.2 jumbo tuples, §3.1 rate model) only holds
if the *same* edge semantics — partition strategy, key extraction, per-stream
selectivity, consumer fan-out — are what the planner models, what the DES
measures and what the threaded runtime executes.  This module is that single
source of truth:

* :class:`RouteSpec` — one logical stream (producer -> consumer) compiled
  from the Topology declaration: strategy (``shuffle`` / ``key`` /
  ``broadcast``), declared key extractor, per-stream selectivity.
* :class:`Route` — a spec bound to a concrete consumer fan-out.  Its
  ``split`` is the only place tuple->replica assignment happens at runtime;
  key partitioning is vectorized (one ``argsort`` + ``bincount`` instead of
  ``k`` boolean masks per batch).
* :class:`RoutingTable` — all routes of one logical graph, compiled once by
  :func:`compile_routes`.  ``repro_torch.core.ExecutionGraph`` derives its edge
  weights from it (the planner side), :func:`unit_delivery` derives the DES
  delivery tables from it (the simulator side), and the runtime binds its
  per-replica :class:`Route` objects from it (the execution side).

Keeping all three consumers on these tables closes the drift the ROADMAP
flagged (non-first-stream ``edge_selectivity`` silently ignored by routing)
and makes every later routing feature a one-place change.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np

PARTITION_STRATEGIES = ("shuffle", "key", "broadcast")

#: a key extractor: a column index into 2-D batches, or ``f(batch) -> keys``
KeyBy = Union[int, Callable[[np.ndarray], np.ndarray]]


#: a consumer's declared partitioning: one strategy for every input stream,
#: or a per-producer mapping (e.g. FD's predictor reads a shuffled feature
#: stream AND a broadcast model-sync stream)
PartitionDecl = Union[str, Mapping[str, str]]


def validate_strategy(op: str, strategy: str) -> None:
    if strategy not in PARTITION_STRATEGIES:
        raise ValueError(
            f"operator {op!r}: unknown partition strategy {strategy!r} "
            f"(choose from {PARTITION_STRATEGIES})")


def validate_partition_decl(op: str, decl: PartitionDecl) -> None:
    """A partition declaration is one strategy or a per-producer mapping."""
    if isinstance(decl, str):
        validate_strategy(op, decl)
        return
    if not isinstance(decl, Mapping):
        raise ValueError(
            f"operator {op!r}: partition must be a strategy or a "
            f"{{producer: strategy}} mapping, got {type(decl).__name__}")
    for producer, strategy in decl.items():
        validate_strategy(op, strategy)


def edge_strategy(strategies: Mapping[str, PartitionDecl], producer: str,
                  consumer: str) -> str:
    """Resolve the strategy of one edge from the consumer declarations
    (per-producer mappings default unnamed producers to shuffle)."""
    decl = strategies.get(consumer, "shuffle")
    if isinstance(decl, Mapping):
        return decl.get(producer, "shuffle")
    return decl


def declares_key(decl: PartitionDecl) -> bool:
    """True when a partition declaration keys at least one input stream."""
    if isinstance(decl, Mapping):
        return "key" in decl.values()
    return decl == "key"


def validate_operator_names(graph, names, what: str) -> None:
    """Reject references to operators the graph does not declare (one rule
    for every per-operator mapping: parallelism, partition, key_by)."""
    unknown = sorted(set(names) - set(graph.operators))
    if unknown:
        raise ValueError(
            f"{what} names unknown operators {unknown} "
            f"(declared: {sorted(graph.operators)})")


def validate_key_extractor(op: str, key_by: KeyBy) -> None:
    """A key extractor is a column index or a callable (bools are not
    column indices)."""
    if callable(key_by):
        return
    if isinstance(key_by, bool) or not isinstance(key_by, (int, np.integer)):
        raise ValueError(
            f"operator {op!r}: key_by must be a column index or a "
            f"callable, got {type(key_by).__name__}")


def extract_keys(arr: np.ndarray, key_by: Optional[KeyBy]) -> np.ndarray:
    """Integer keys for ``arr`` under a declared extractor.

    ``None`` keeps the historical convention: the tuple itself for 1-D
    batches, column 0 for 2-D batches.
    """
    if callable(key_by):
        keys = np.asarray(key_by(arr))
        if keys.shape[:1] != arr.shape[:1]:
            raise ValueError(
                f"key extractor returned {keys.shape} keys for a batch of "
                f"{len(arr)} tuples")
        return keys.astype(np.int64, copy=False)
    col = 0 if key_by is None else int(key_by)
    if arr.ndim == 1:
        if col != 0:
            raise ValueError(
                f"key_by column {col} requested on a 1-D batch")
        return arr.astype(np.int64, copy=False)
    return arr[:, col].astype(np.int64, copy=False)


def validate_time_extractor(op: str, event_time) -> None:
    """An event-time extractor is a column index or a callable (same shape
    rule as key extractors, distinct message)."""
    if callable(event_time):
        return
    if isinstance(event_time, bool) or \
            not isinstance(event_time, (int, np.integer)):
        raise ValueError(
            f"operator {op!r}: event_time must be a column index or a "
            f"callable, got {type(event_time).__name__}")


def extract_event_times(arr: np.ndarray, time_by) -> np.ndarray:
    """Float event times for ``arr`` under a declared extractor.

    ``None`` mirrors :func:`extract_keys`: the tuple itself for 1-D
    batches, column 0 for 2-D batches.
    """
    if callable(time_by):
        ets = np.asarray(time_by(arr), dtype=np.float64)
        if ets.shape != arr.shape[:1]:
            raise ValueError(
                f"event-time extractor returned {ets.shape} times for a "
                f"batch of {len(arr)} tuples")
        return ets
    col = 0 if time_by is None else int(time_by)
    if arr.ndim == 1:
        if col != 0:
            raise ValueError(
                f"event_time column {col} requested on a 1-D batch")
        return arr.astype(np.float64, copy=False)
    return arr[:, col].astype(np.float64, copy=False)


class WatermarkMerger:
    """Min-merge of per-lane low-watermarks, monotone per lane.

    One lane per producer execution unit.  A lane's watermark never
    regresses (stale values are ignored), and the merged watermark is the
    minimum over *all* expected lanes — ``-inf`` until every lane has
    reported, because an unheard-from producer may still hold arbitrarily
    old tuples.  Min-merge is associative and commutative, so replica
    fan-in can be merged in any grouping (the property test pins this
    down); that is what lets watermarks ride the same compiled routes as
    data with no ordering coordination across lanes.
    """

    __slots__ = ("expected", "_lanes")

    def __init__(self, expected: int):
        self.expected = expected
        self._lanes: Dict[str, float] = {}

    def update(self, lane: str, value: float) -> float:
        """Advance ``lane`` to ``value`` (monotone) and return the merged
        watermark."""
        if value > self._lanes.get(lane, -math.inf):
            self._lanes[lane] = value
        return self.merged

    @property
    def merged(self) -> float:
        if len(self._lanes) < self.expected:
            return -math.inf
        return min(self._lanes.values())

    def lane(self, name: str) -> float:
        return self._lanes.get(name, -math.inf)


class BarrierAligner:
    """Per-consumer checkpoint-barrier alignment (the Chandy-Lamport cut).

    The watermark idiom, one notch stricter: a checkpoint barrier is a
    second kind of mark that rides every route a watermark rides, but
    where watermarks *min-merge* (a stale lane just holds the merged value
    back), barriers must **align** — the consumer snapshots its state only
    once barrier *n* has arrived on *every* producer lane, and everything
    a fast lane sends after its barrier is held back until then (otherwise
    post-barrier effects leak into the snapshot and replay double-applies
    them).  One aligner per executor, ``expected`` producer lanes, exactly
    like the poison count.

    Rounds are strictly sequential by construction: a lane that has
    delivered barrier ``n`` is *holding* — the executor queues that lane's
    subsequent items (data, watermarks, even barrier ``n+1``) instead of
    processing them — so a barrier for a different round while one is
    active is a protocol violation, not a case to handle.
    """

    __slots__ = ("expected", "active", "_arrived")

    def __init__(self, expected: int):
        self.expected = expected
        self.active: Optional[int] = None     # ckpt id being aligned
        self._arrived: set = set()

    def arrive(self, lane: str, ckpt_id: int) -> bool:
        """Record barrier ``ckpt_id`` from ``lane``; True when this
        completes the round (all expected lanes aligned)."""
        if self.active is None:
            self.active = ckpt_id
            self._arrived = set()
        elif ckpt_id != self.active:
            raise RuntimeError(
                f"barrier {ckpt_id} from lane {lane!r} while round "
                f"{self.active} is still aligning")
        self._arrived.add(lane)
        if len(self._arrived) >= self.expected:
            self.active = None
            self._arrived = set()
            return True
        return False

    def holding(self, lane: str) -> bool:
        """True while ``lane`` has aligned the active round and its
        subsequent items must be held back."""
        return self.active is not None and lane in self._arrived

    def reset(self) -> None:
        """Abandon the active round (end of stream reached before every
        lane's barrier arrived — the round can never complete)."""
        self.active = None
        self._arrived = set()


#: calibrated crossover for the keyed-split implementation, refit from a
#: dense best-of-3 micro grid (rows in {128..10240} x k in {2,4,8},
#: us/call): the per-mask path is k linear scans and stays cache-friendly
#: while k is small; the radix argsort+gather is one O(n) pass whose setup
#: amortizes quickly as fan-out grows.  The measured crossover falls much
#: faster in k than the previous ``rows * k**2`` fit assumed (k=2 flips
#: near 5120 rows, k=4 by 256 rows, k=8 always prefers vectorized — the
#: old rule misclassified the small-row k>=4 points, where vectorized
#: wins 1.1-1.6x): ``rows * k**3 > 8192`` leaves at most two near-tie
#: misses on the fresh 21-point grid ((128, 4) and (2560, 2), both within
#: 4% of best), versus 11-12% regret at the k=4 mid-rows under any larger
#: threshold.  Boundary points are within run-to-run noise either way;
#: the threshold's job is the clear regions, where forcing the wrong path
#: costs 1.5-3x per split.
VEC_CROSSOVER = 8192


def auto_vectorized(rows: int, k: int) -> bool:
    """Per-call implementation choice for a keyed split: True selects the
    vectorized argsort+bincount path, False the per-mask scans.  Batch
    size is stable per edge, so this is effectively a per-edge decision —
    made from the calibrated :data:`VEC_CROSSOVER` threshold instead of a
    global flag (``vectorized=`` on ``run_app``/``Plan.execute`` remains
    the override)."""
    return rows * k * k * k > VEC_CROSSOVER


def split_by_key(arr: np.ndarray, keys: np.ndarray,
                 k: int) -> List[Tuple[int, np.ndarray]]:
    """Vectorized keyed split: one stable argsort + bincount per batch
    instead of ``k`` boolean masks (k full-array scans + gathers).

    The residues fit in uint8 for any realistic fan-out, where numpy's
    stable argsort is a single-pass radix sort — O(n) rather than the
    per-mask path's O(n*k).  The stable order preserves arrival order
    within each partition, so the result is row-for-row identical to the
    per-mask path.  Returns ``(replica, rows)`` for non-empty partitions;
    the rows are views into one gathered array (no per-partition copies).
    """
    keys = keys % k
    if k <= 256:
        keys = keys.astype(np.uint8)
    counts = np.bincount(keys, minlength=k)
    gathered = arr[np.argsort(keys, kind="stable")]
    ends = np.cumsum(counts)
    return [(j, gathered[ends[j] - counts[j]:ends[j]])
            for j in range(k) if counts[j]]


def split_by_key_masks(arr: np.ndarray, keys: np.ndarray,
                       k: int) -> List[Tuple[int, np.ndarray]]:
    """The seed runtime's per-mask path (k boolean scans per batch).

    Kept only as the baseline for ``benchmarks/bench_runtime.py`` and the
    parity tests; the runtime uses :func:`split_by_key`.
    """
    keys = keys % k
    out = []
    for j in range(k):
        part = arr[keys == j]
        if len(part):
            out.append((j, part))
    return out


@dataclasses.dataclass(frozen=True)
class RouteSpec:
    """One logical stream, compiled from the Topology declaration.

    ``stream`` is the producer's output-stream index (consumer declaration
    order — the position of this edge's array in the kernel's return list).
    ``selectivity`` is the declared per-stream selectivity (the producer's
    default or the consumer's per-edge override, paper Table 8).
    """

    producer: str
    consumer: str
    stream: int
    strategy: str = "shuffle"
    selectivity: float = 1.0
    key_by: Optional[KeyBy] = None

    def keys(self, arr: np.ndarray) -> np.ndarray:
        return extract_keys(arr, self.key_by)

    def unit_weight(self, group: int, fanout: int) -> float:
        """Tuples arriving at one consumer unit of ``group`` fused replicas
        (``fanout`` replicas total) per tuple processed by a producer unit —
        the replica-level edge weight of the §3.1 rate model."""
        if self.strategy == "broadcast":
            return self.selectivity * group
        return self.selectivity * group / fanout

    def bind(self, fanout: int,
             vectorized: Optional[bool] = None) -> "Route":
        return Route(self, fanout, vectorized)


class Route:
    """A :class:`RouteSpec` bound to a concrete consumer fan-out.

    Owns the per-producer-replica round-robin cursor, so every executor
    binds its own instance.  ``vectorized`` selects the keyed-split
    implementation: ``None`` (default) picks per edge from the calibrated
    :func:`auto_vectorized` threshold, ``True``/``False`` force the
    argsort+bincount path / the seed's per-mask path (the benchmark A/B
    override).
    """

    __slots__ = ("spec", "fanout", "vectorized", "_rr")

    def __init__(self, spec: RouteSpec, fanout: int,
                 vectorized: Optional[bool] = None):
        assert fanout >= 1
        self.spec = spec
        self.fanout = fanout
        self.vectorized = vectorized
        self._rr = 0

    @property
    def is_broadcast(self) -> bool:
        """True when every consumer replica receives every tuple — the
        fan-out shape where the runtime shares **one** jumbo flush across
        all lanes (one refcounted buffer view enqueued ``fanout`` times)
        instead of accumulating a private per-lane copy.  Lanes of a
        broadcast route fill in lockstep by definition, which is what makes
        a single shared accumulation buffer correct."""
        return self.spec.strategy == "broadcast"

    def aliases_input(self) -> bool:
        """True when :meth:`split` may return arrays sharing memory with
        its input (shuffle passes the whole batch through; broadcast hands
        the same array to every lane).  Keyed splits always materialize new
        arrays (argsort+gather or boolean masks), so their parts never
        alias — the emit path uses this to skip the overlap check that
        guards pooled-buffer recycling."""
        return self.fanout == 1 or self.spec.strategy != "key"

    def split(self, arr: np.ndarray) -> List[Tuple[int, np.ndarray]]:
        """Assign a batch to consumer replicas: ``[(replica, rows), ...]``."""
        k = self.fanout
        if k == 1:
            return [(0, arr)]
        strategy = self.spec.strategy
        if strategy == "key":
            keys = self.spec.keys(arr)
            use_vec = auto_vectorized(len(arr), k) \
                if self.vectorized is None else self.vectorized
            if use_vec:
                return split_by_key(arr, keys, k)
            return split_by_key_masks(arr, keys, k)
        if strategy == "broadcast":
            return [(j, arr) for j in range(k)]
        j = self._rr % k                 # shuffle: whole batch round-robin
        self._rr += 1
        return [(j, arr)]

    def watermark_lanes(self) -> range:
        """Lanes a low-watermark is forwarded on: *every* consumer replica,
        regardless of the data strategy — a watermark is a promise about
        the whole stream, so each replica needs it even when the data split
        sends it only a subset of tuples."""
        return range(self.fanout)

    def tuples_entered(self, lane_counts) -> int:
        """Distinct tuples that entered this stream, given per-replica
        delivered counts: broadcast duplicates a tuple onto every lane
        (count it once), partitioning strategies split it (sum lanes)."""
        if self.spec.strategy == "broadcast":
            return max(lane_counts, default=0)
        return sum(lane_counts)

    def __repr__(self) -> str:
        return (f"Route({self.spec.producer}->{self.spec.consumer} "
                f"{self.spec.strategy} sel={self.spec.selectivity} "
                f"k={self.fanout})")


class RoutingTable:
    """All compiled routes of one logical graph (one entry per edge)."""

    def __init__(self, graph, routes: Dict[Tuple[str, str], RouteSpec]):
        self.graph = graph
        self._routes = dict(routes)
        self._out: Dict[str, List[RouteSpec]] = {}
        for (u, _), spec in sorted(self._routes.items(),
                                   key=lambda kv: kv[1].stream):
            self._out.setdefault(u, []).append(spec)

    def route(self, producer: str, consumer: str) -> RouteSpec:
        return self._routes[(producer, consumer)]

    def out_routes(self, producer: str) -> List[RouteSpec]:
        """Routes leaving ``producer`` in output-stream order (the order of
        the kernel's return list)."""
        return self._out.get(producer, [])

    def sel(self, producer: str, consumer: str) -> float:
        return self._routes[(producer, consumer)].selectivity

    def strategy(self, producer: str, consumer: str) -> str:
        return self._routes[(producer, consumer)].strategy

    def key_extractor(self, consumer: str) -> Optional[KeyBy]:
        """The declared key extractor of ``consumer``'s keyed input routes
        (one declaration per consumer, so every keyed edge agrees).  This
        is what keyed pane groups shard by — the same extractor the router
        splits on, so a key's panes live exactly where its tuples land."""
        for (_, v), spec in self._routes.items():
            if v == consumer and spec.strategy == "key":
                return spec.key_by
        return None

    def unit_weight(self, producer: str, consumer: str, group: int,
                    fanout: int) -> float:
        return self._routes[(producer, consumer)].unit_weight(group, fanout)

    def items(self):
        return self._routes.items()

    def __len__(self) -> int:
        return len(self._routes)

    def __contains__(self, edge) -> bool:
        return edge in self._routes


def compile_routes(source, partition: Optional[Mapping[str,
                                                       PartitionDecl]] = None,
                   key_by: Optional[Mapping[str, KeyBy]] = None
                   ) -> RoutingTable:
    """Compile the routing table for an app or logical graph.

    ``source`` is a ``StreamingApp`` (whose declared ``partition`` /
    ``key_by`` travel with it) or a bare ``LogicalGraph``.  The ``partition``
    and ``key_by`` arguments override per *consumer* operator (that is how
    ``run_app(partition=...)`` overrides a declaration); an override
    replaces the consumer's whole declaration, including a per-producer
    mapping.
    """
    graph = getattr(source, "graph", source)
    strategies: Dict[str, PartitionDecl] = \
        dict(getattr(source, "partition", None) or {})
    strategies.update(partition or {})
    extractors = dict(getattr(source, "key_by", None) or {})
    validate_operator_names(graph, strategies, "partition")
    for op, decl in strategies.items():
        validate_partition_decl(op, decl)
        if isinstance(decl, Mapping):
            producers = set(graph.producers(op))
            unknown = sorted(set(decl) - producers)
            if unknown:
                raise ValueError(
                    f"operator {op!r}: partition mapping names {unknown}, "
                    f"which are not producers of {op!r} "
                    f"(producers: {sorted(producers)})")
    # a partition override away from "key" disables the *declared* extractor
    # (so run_app(partition={'op': 'shuffle'}) A/Bs keyed-by apps cleanly);
    # an extractor passed explicitly alongside a non-key strategy is a
    # caller error and is rejected below
    for op in [o for o, kb in extractors.items()
               if not declares_key(strategies.get(o, "shuffle"))]:
        del extractors[op]
    extractors.update(key_by or {})
    validate_operator_names(graph, extractors, "key_by")
    for op, kb in extractors.items():
        if not declares_key(strategies.get(op, "shuffle")):
            raise ValueError(
                f"operator {op!r} declares key_by but its partition "
                f"strategy is {strategies.get(op, 'shuffle')!r} (key "
                "extractors require partition='key')")
        validate_key_extractor(op, kb)
    routes: Dict[Tuple[str, str], RouteSpec] = {}
    for u in graph.operators:
        for stream, v in enumerate(graph.consumers(u)):
            strategy = edge_strategy(strategies, u, v)
            routes[(u, v)] = RouteSpec(
                producer=u, consumer=v, stream=stream,
                strategy=strategy,
                selectivity=graph.sel(u, v),
                key_by=extractors.get(v) if strategy == "key" else None)
    return RoutingTable(graph, routes)


def unit_delivery(graph, routes: Optional[RoutingTable] = None
                  ) -> Dict[int, List[Tuple[int, float]]]:
    """Replica-level delivery table for the DES, derived from the routes.

    ``table[u] = [(v, w), ...]``: a producer unit ``u`` hands ``w`` tuples to
    consumer unit ``v`` per tuple it processes — selectivity x strategy x
    fan-out, the same quantities ``ExecutionGraph`` feeds the rate model.
    """
    if routes is None:
        routes = getattr(graph, "routes", None) or \
            compile_routes(graph.logical)
    table: Dict[int, List[Tuple[int, float]]] = {
        u: [] for u in range(graph.n_units)}
    for (pu, cv), spec in routes.items():
        fanout = graph.parallelism.get(cv, 1)
        for ui in graph.units_of(pu):
            for vi in graph.units_of(cv):
                w = spec.unit_weight(graph.replicas[vi].group, fanout)
                table[ui].append((vi, w))
    return table
