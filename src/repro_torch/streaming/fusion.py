"""Operator fusion: compile 1:1 pipeline segments into single executors.

BriskStream's RLAS prices every producer-consumer pair by relative
location, but the best case — distance zero — still costs a full queue
hop in the runtime: enqueue, fan-in wait, watermark min-merge, arena
lease hand-off.  Following Prasaad et al. (arXiv:1803.11328), a maximal
chain of fusion-eligible edges is collapsed into one ``FusedExecutor``
that calls the member kernels back-to-back on the same batch.

An edge ``u -> v`` is fusion-eligible when all of the following hold:

- ``u`` is not a spout (spout replay offsets stay per-source),
- ``u`` has exactly one consumer and ``v`` exactly one producer,
- the edge is shuffle-routed (keyed and broadcast edges repartition
  or replicate data and must stay queue-crossing),
- neither endpoint is a ``device=True`` operator (v1 keeps the async
  dispatch window at a queue boundary),
- neither endpoint carries an event-time window (pane firing is driven
  by the watermark frontier at a lane boundary; count windows live
  inside kernels and fuse fine),
- neither endpoint opted out via ``fuse=False``,
- when a parallelism map is given, both endpoints run the same number
  of replicas (replica ``i`` of the chain fuses end-to-end).

Chains are *maximal* runs of eligible edges.  This module is pure graph
logic: the runtime realization lives in ``runtime.FusedExecutor`` and
the planner pricing in ``fuse_graph`` below, which rewrites a logical
graph + route table so a chain becomes one ``OperatorSpec`` with summed
(selectivity-weighted) service time and zero intra-chain comm cost —
letting RLAS/BnB choose fusion against replication.

Distribution contract: fusing an edge turns its shuffle into replica-
local *forwarding* — chain replica ``i`` is member ``i`` of every stage,
end-to-end.  Any assignment of batches to replicas is a valid shuffle,
so stream contents, global counters and keyed-state bytes are preserved,
but the unfused plan's whole-batch round-robin is not emulated across
executors.  Byte-for-byte parity with the unfused plan therefore holds
when the chain runs one replica (every boundary distribution is the
identity) and at preserved boundaries (the head's inbound route,
including keyed shards, is verbatim); a *replicated* chain is instead
deterministic against itself — same fused plan, same bytes — which is
what checkpoint restore and migration consume.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core import LogicalGraph, OperatorSpec

from .routing import RouteSpec, RoutingTable

__all__ = [
    "detect_chains",
    "validate_chains",
    "fuse_graph",
    "fused_name",
    "fuse_parallelism",
    "expand_parallelism",
]


def fused_name(chain: Sequence[str]) -> str:
    """Display/plan name of a fused chain: ``"parser+avg+spike"``."""
    return "+".join(chain)


def _edge_eligible(lg: LogicalGraph, routes: RoutingTable, u: str, v: str,
                   no_fuse: frozenset, time_windows: frozenset,
                   parallelism: Optional[Mapping[str, int]]) -> bool:
    if lg.operators[u].is_spout:
        return False
    if u in no_fuse or v in no_fuse:
        return False
    if u in time_windows or v in time_windows:
        return False
    if len(lg.consumers(u)) != 1 or len(lg.producers(v)) != 1:
        return False
    if routes.strategy(u, v) != "shuffle":
        return False
    if lg.operators[u].device or lg.operators[v].device:
        return False
    if parallelism is not None and \
            parallelism.get(u, 1) != parallelism.get(v, 1):
        return False
    return True


def detect_chains(lg: LogicalGraph, routes: RoutingTable, *,
                  no_fuse: Iterable[str] = (),
                  time_windows: Iterable[str] = (),
                  parallelism: Optional[Mapping[str, int]] = None,
                  ) -> List[List[str]]:
    """Maximal fusion-eligible chains, in topological order of their heads.

    With ``parallelism=None`` the detection is structural (the planner
    assigns one replica count to the whole fused operator, so members
    match by construction); with a map, mismatched edges break chains.
    """
    no_fuse = frozenset(no_fuse)
    time_windows = frozenset(time_windows)
    nxt: Dict[str, str] = {}
    prv: Dict[str, str] = {}
    for u, v in lg.edges:
        if _edge_eligible(lg, routes, u, v, no_fuse, time_windows,
                          parallelism):
            # eligible edges have unique endpoints on both sides, so
            # nxt/prv are functions, never multimaps
            nxt[u] = v
            prv[v] = u
    chains: List[List[str]] = []
    for u in lg.topo_order():
        if u in nxt and u not in prv:
            chain = [u]
            while chain[-1] in nxt:
                chain.append(nxt[chain[-1]])
            chains.append(chain)
    return chains


def validate_chains(lg: LogicalGraph, routes: RoutingTable,
                    chains: Iterable[Sequence[str]], *,
                    no_fuse: Iterable[str] = (),
                    time_windows: Iterable[str] = (),
                    ) -> List[List[str]]:
    """Check explicitly requested chains against the eligibility rules.

    Raises ``ValueError`` on any structural violation (unknown member,
    short chain, overlapping chains, keyed/broadcast/device/windowed or
    fan-crossing edge).  Parallelism is *not* checked here: a chain that
    is structurally sound but realized with mismatched replica counts is
    silently dropped at prepare time — fusion is an optimization, and a
    plan-derived chain may be invalidated by elastic rescaling.
    """
    no_fuse = frozenset(no_fuse)
    time_windows = frozenset(time_windows)
    out: List[List[str]] = []
    seen: set = set()
    for chain in chains:
        chain = list(chain)
        if len(chain) < 2:
            raise ValueError(f"fusion chain {chain!r} needs >= 2 operators")
        for m in chain:
            if m not in lg.operators:
                raise ValueError(f"fusion chain member {m!r} is not an "
                                 "operator of this graph")
            if m in seen:
                raise ValueError(f"operator {m!r} appears in more than one "
                                 "fusion chain")
            seen.add(m)
        for u, v in zip(chain, chain[1:]):
            if v not in lg.consumers(u):
                raise ValueError(f"fusion chain edge {u!r} -> {v!r} is not "
                                 "an edge of this graph")
            if not _edge_eligible(lg, routes, u, v, no_fuse, time_windows,
                                  None):
                raise ValueError(
                    f"edge {u!r} -> {v!r} is not fusion-eligible (needs "
                    "shuffle routing, fan-in 1 / fan-out 1, no device or "
                    "event-time window endpoint, no fuse=False opt-out)")
        out.append(chain)
    return out


def _prefix_products(lg: LogicalGraph, chain: Sequence[str]) -> List[float]:
    """``P[j]`` = expected tuples reaching member ``j`` per head-input tuple."""
    prods = [1.0]
    for u, v in zip(chain, chain[1:]):
        prods.append(prods[-1] * lg.sel(u, v))
    return prods


def fuse_graph(lg: LogicalGraph, routes: RoutingTable,
               chains: Sequence[Sequence[str]],
               ) -> Tuple[LogicalGraph, RoutingTable]:
    """Rewrite ``(lg, routes)`` so each chain is one logical operator.

    The fused spec prices what one replica actually executes: service
    time is the selectivity-weighted sum of member service times (a
    tuple that dies at member ``j`` never costs ``j+1``'s kernel), the
    intra-chain edges vanish (zero comm cost — the collocation limit
    RLAS prices made exact), and the fused selectivity composes the
    members' so downstream rates are unchanged.  Inbound routing of the
    head (including keyed/broadcast strategies) and outbound routing of
    the tail are preserved verbatim.
    """
    fused_of: Dict[str, str] = {}
    tail_scale: Dict[str, float] = {}
    specs: Dict[str, OperatorSpec] = {}
    for chain in chains:
        fname = fused_name(chain)
        prods = _prefix_products(lg, chain)
        exec_ns = mem = state_b = device_ns = 0.0
        resident = 0.0
        resident_shared = True
        for m, p in zip(chain, prods):
            spec = lg.operators[m]
            exec_ns += p * spec.exec_ns
            mem += p * spec.mem_bytes
            state_b += p * spec.state_bytes
            device_ns += p * spec.device_ns
            resident += spec.state_resident_tuples
            if spec.state_resident_tuples > 0:
                resident_shared = resident_shared and spec.state_resident_shared
        head_spec = lg.operators[chain[0]]
        tail_spec = lg.operators[chain[-1]]
        specs[fname] = OperatorSpec(
            name=fname,
            exec_ns=exec_ns,
            tuple_bytes=head_spec.tuple_bytes,
            mem_bytes=mem,
            selectivity=prods[-1] * tail_spec.selectivity,
            state_bytes=state_b,
            state_resident_tuples=resident,
            state_resident_shared=resident_shared,
        )
        tail_scale[chain[-1]] = prods[-1]
        for m in chain:
            fused_of[m] = fname

    operators: Dict[str, OperatorSpec] = {}
    for name, spec in lg.operators.items():
        fname = fused_of.get(name)
        if fname is None:
            operators[name] = spec
        elif fname not in operators:
            operators[fname] = specs[fname]

    edges: List[Tuple[str, str]] = []
    edge_sel: Dict[Tuple[str, str], float] = {}
    orig_edge: Dict[Tuple[str, str], Tuple[str, str]] = {}
    for u, v in lg.edges:
        mu = fused_of.get(u, u)
        mv = fused_of.get(v, v)
        if mu == mv:
            continue                     # intra-chain edge: fused away
        edges.append((mu, mv))
        orig_edge[(mu, mv)] = (u, v)
        if u in tail_scale:
            # per-input-tuple rate out of the fused op = rate at the
            # tail times the tail's own per-edge selectivity
            edge_sel[(mu, mv)] = tail_scale[u] * lg.sel(u, v)
        elif (u, v) in lg.edge_selectivity:
            edge_sel[(mu, mv)] = lg.edge_selectivity[(u, v)]

    fused_lg = LogicalGraph(operators, edges, edge_sel)

    new_routes: Dict[Tuple[str, str], RouteSpec] = {}
    for mu in fused_lg.operators:
        for stream, mv in enumerate(fused_lg.consumers(mu)):
            u, v = orig_edge[(mu, mv)]
            old = routes.route(u, v)
            new_routes[(mu, mv)] = dataclasses.replace(
                old, producer=mu, consumer=mv, stream=stream,
                selectivity=edge_sel.get((mu, mv), fused_lg.sel(mu, mv)))
    return fused_lg, RoutingTable(fused_lg, new_routes)


def fuse_parallelism(par: Mapping[str, int],
                     chains: Sequence[Sequence[str]]) -> Dict[str, int]:
    """Collapse a member-keyed parallelism map onto fused names."""
    member = {m: fused_name(c) for c in chains for m in c}
    out: Dict[str, int] = {}
    for op, k in par.items():
        out[member.get(op, op)] = int(k)
    return out


def expand_parallelism(par: Mapping[str, int],
                       chains: Sequence[Sequence[str]]) -> Dict[str, int]:
    """Expand a fused-keyed parallelism map back to member names."""
    by_name = {fused_name(c): c for c in chains}
    out: Dict[str, int] = {}
    for op, k in par.items():
        for m in by_name.get(op, [op]):
            out[m] = int(k)
    return out
