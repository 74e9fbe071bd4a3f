"""Topologically-sorted iterative scaling (paper Algorithm 1).

Joint replication + placement optimization: starting from replication level 1
for every operator, repeatedly (1) optimize placement with the B&B, (2) find
the bottleneck (over-supplied) operator scanning from sinks toward the spout
(reverse topological order), (3) raise its replication level by the oversupply
ratio ``ceil(r_i / r_o)``, and re-optimize.  Terminates when placement fails,
no further increase is possible, or the thread budget (total cores by default)
is exhausted.  The best plan seen is returned.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from .graph import ExecutionGraph, LogicalGraph
from .placement import PlacementResult, bnb_place
from .topology import MachineSpec


@dataclasses.dataclass
class ScalingResult:
    parallelism: Dict[str, int]
    placement: PlacementResult
    graph: ExecutionGraph
    history: List[Tuple[Dict[str, int], float]]   # (parallelism, R) per iter
    iterations: int

    @property
    def R(self) -> float:
        return self.placement.R


def rlas_optimize(logical: LogicalGraph, machine: MachineSpec,
                  input_rate: Optional[float] = None,
                  compress_ratio: int = 1,
                  max_threads: Optional[int] = None,
                  bestfit: bool = False,
                  max_nodes: int = 50_000,
                  tf_mode: str = "relative",
                  max_iters: int = 200,
                  initial_parallelism: Optional[Dict[str, int]] = None,
                  bottleneck_rule: str = "reverse_topo",
                  routes=None,
                  ) -> ScalingResult:
    """RLAS: jointly optimize replication and placement (Alg. 1 + Alg. 2).

    ``tf_mode`` selects the capability assumption used *during optimization*
    ("relative" = RLAS, "worst" = RLAS_fix(L), "zero" = RLAS_fix(U)); results
    are always reported under the true relative model.  ``routes`` is the
    compiled routing table forwarded to :class:`ExecutionGraph` so scaling
    decisions see the same edge semantics the runtime executes.
    """
    if max_threads is None:
        max_threads = machine.total_cores
    parallelism = {name: 1 for name in logical.operators}
    if initial_parallelism:
        parallelism.update(initial_parallelism)
    best: Optional[ScalingResult] = None
    history: List[Tuple[Dict[str, int], float]] = []
    rev_topo = list(reversed(logical.topo_order()))

    it = 0
    while it < max_iters:
        it += 1
        graph = ExecutionGraph(logical, parallelism, compress_ratio,
                               routes=routes)
        pres = bnb_place(graph, machine, input_rate, bestfit=bestfit,
                         max_nodes=max_nodes, tf_mode=tf_mode)
        history.append((dict(parallelism), pres.R))
        if pres.feasible and (best is None or pres.R > best.R):
            best = ScalingResult(dict(parallelism), pres, graph, history, it)
        if not pres.feasible:
            break                       # Alg.1 line 9-10: placement failed
        # Identify the bottleneck: the paper scans sinks -> spout (reverse
        # topological order); "max_ratio" grows the most over-supplied
        # operator first, which balances deep chains faster (autoshard).
        bottlenecks = pres.eval.bottlenecks
        grew = False
        if bottleneck_rule == "max_ratio":
            scan = sorted(bottlenecks,
                          key=lambda o: -bottlenecks[o]
                          if math.isfinite(bottlenecks[o]) else -1e30)
        else:
            scan = [op for op in rev_topo if op in bottlenecks]
        for op in scan:
            ratio = bottlenecks[op]
            k = parallelism[op]
            if math.isfinite(ratio):
                new_k = max(k + 1, math.ceil(k * ratio))
            else:                        # unbounded ingress (I = None) spout
                new_k = k * 2
            # geometric growth cap: an extreme oversupply ratio (common for
            # the first stage behind an unbounded feed) must not grab the
            # whole thread budget in one iteration — growth stays balanced
            # across bottlenecks and converges within max_iters
            new_k = min(new_k, k * 2)
            # cap so the total thread count stays within budget
            budget = max_threads - (sum(parallelism.values()) - k)
            new_k = min(new_k, budget)
            if new_k <= k:
                continue                 # cannot grow this op further
            parallelism[op] = new_k
            grew = True
            break
        if not grew:
            break                        # no bottleneck can be scaled
    if best is None:
        graph = ExecutionGraph(logical, parallelism, compress_ratio,
                               routes=routes)
        pres = bnb_place(graph, machine, input_rate, bestfit=bestfit,
                         max_nodes=max_nodes, tf_mode=tf_mode)
        best = ScalingResult(dict(parallelism), pres, graph, history, it)
    best = dataclasses.replace(best, history=history, iterations=it)
    return best
