"""Competing execution-plan strategies (paper §6.4, Table 6).

* ``ff_place``  — First-Fit: topological greedy that collocates each unit with
  its producers when resources allow (the traffic-minimising heuristic family
  of T-Storm [52] / Aniello et al. [13]).
* ``rr_place``  — Round-Robin across sockets (R-Storm-style load balancing).
* ``RLAS_fix(L)/(U)`` — the paper's fixed-capability ablations: run the same
  search/scaling as RLAS but assume a constant T^f (worst-case / zero);
  exposed via ``tf_mode`` on :func:`repro_torch.core.scaling.rlas_optimize`.
* ``random_plan`` — Monte-Carlo random replication+placement (Fig. 14).

FF and RR enforce resource constraints as far as possible and, like the paper,
gradually relax them (scaling capacities by 1.25x) when no feasible slot
exists, which typically ends up oversubscribing a few sockets.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from .graph import ExecutionGraph, LogicalGraph
from .perfmodel import UNPLACED, evaluate
from .placement import PlacementResult
from .topology import MachineSpec


def _greedy_fill(graph: ExecutionGraph, machine: MachineSpec,
                 input_rate: Optional[float],
                 socket_order_fn) -> List[int]:
    """Shared FF/RR skeleton: place units one by one under relaxable limits."""
    n = graph.n_units
    placement = [UNPLACED] * n
    relax = 1.0
    for _ in range(32):                          # relaxation ladder
        placement = [UNPLACED] * n
        ok = True
        for v in graph.topo_unit_order():
            placed = False
            for s in socket_order_fn(v, placement, graph, machine):
                placement[v] = s
                ev = evaluate(graph, machine, placement, input_rate)
                within = all(
                    ev.cpu_usage[t] <= machine.cores_per_socket * relax + 1e-9
                    for t in range(machine.n_sockets)) and all(
                    ev.mem_usage[t] <= machine.local_bw * relax * (1 + 1e-9)
                    for t in range(machine.n_sockets))
                chan_ok = np.all(ev.chan_usage <= machine.Q * relax + 1e-6)
                if within and chan_ok:
                    placed = True
                    break
                placement[v] = UNPLACED
            if not placed:
                ok = False
                break
        if ok:
            return placement
        relax *= 1.25
    # last resort: force-place everything ignoring constraints
    for v in graph.topo_unit_order():
        if placement[v] == UNPLACED:
            placement[v] = 0
    return placement


def ff_place(graph: ExecutionGraph, machine: MachineSpec,
             input_rate: Optional[float] = None) -> PlacementResult:
    """First-Fit with producer collocation preference (topo order)."""

    def order(v, placement, g, m):
        prods = [placement[u] for u, _ in g.in_edges[v]
                 if placement[u] != UNPLACED]
        pref = sorted(set(prods), key=prods.count, reverse=True)
        rest = [s for s in range(m.n_sockets) if s not in pref]
        return pref + rest

    placement = _greedy_fill(graph, machine, input_rate, order)
    ev = evaluate(graph, machine, placement, input_rate)
    return PlacementResult(placement, ev, ev.feasible, graph.n_units, True, 0.0)


def rr_place(graph: ExecutionGraph, machine: MachineSpec,
             input_rate: Optional[float] = None) -> PlacementResult:
    """Round-robin across sockets in topological unit order."""
    counter = {"i": 0}

    def order(v, placement, g, m):
        start = counter["i"] % m.n_sockets
        counter["i"] += 1
        return [(start + k) % m.n_sockets for k in range(m.n_sockets)]

    placement = _greedy_fill(graph, machine, input_rate, order)
    ev = evaluate(graph, machine, placement, input_rate)
    return PlacementResult(placement, ev, ev.feasible, graph.n_units, True, 0.0)


def random_plan(logical: LogicalGraph, machine: MachineSpec,
                rng: np.random.Generator,
                input_rate: Optional[float] = None,
                max_threads: Optional[int] = None,
                compress_ratio: int = 1,
                routes=None,
                ) -> Tuple[ExecutionGraph, List[int], "PlanEval"]:
    """One Monte-Carlo sample: random replication until the thread budget is
    hit, then uniform random placement (paper Fig. 14 protocol).  Returns the
    full :class:`PlanEval` (``.R`` is 0-equivalent when infeasible)."""
    if max_threads is None:
        max_threads = machine.total_cores
    names = list(logical.operators)
    parallelism = {name: 1 for name in names}
    while sum(parallelism.values()) < max_threads:
        op = names[rng.integers(len(names))]
        parallelism[op] += 1
        if rng.random() < 0.15:          # random stopping point
            break
    graph = ExecutionGraph(logical, parallelism, compress_ratio,
                           routes=routes)
    placement = [int(rng.integers(machine.n_sockets))
                 for _ in range(graph.n_units)]
    ev = evaluate(graph, machine, placement, input_rate)
    return graph, placement, ev
