"""Branch-and-bound placement optimization (paper §4, Algorithm 2).

Search organisation
-------------------
Units are branched in topological order, so every producer is placed before
its consumers.  Placing unit ``v`` on socket ``s`` *is* the set of collocation
decisions for all edges into ``v`` (heuristic 1 — decisions are per
producer-consumer pair; a vertex placement that touches no pending edge is
never branched).  Because the rate model is feed-forward, a placed unit's
rates are final, enabling incremental evaluation.

Heuristics (paper §4):
1. *Collocation/edge branching* — realised by the topological unit order, plus
   socket symmetry collapse: untouched sockets with identical distance tiers
   to all used sockets are interchangeable, so only one representative is
   branched ("S1 is identical to S0 ... does not need to repeatedly consider").
2. *Best-fit + redundancy elimination* — when all predecessors of the unit are
   placed (always true in our order), optionally branch only the socket(s)
   maximising the unit's own output rate, tie-broken by least remaining CPU
   resource, keeping a single child (``bestfit=True``, the paper's behaviour).
   With ``bestfit=False`` all sockets are branched best-bound-first, which is
   exhaustive and provably optimal (tested against brute force).
3. *Graph compression* — handled upstream by ``ExecutionGraph(compress_ratio)``.

Bounding function: unplaced units are assumed collocated with all producers
(``T^f = 0``); see :func:`repro_torch.core.perfmodel.bound_value` for why the bound
uses the monotone ``min`` service aggregation.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .graph import ExecutionGraph
from .perfmodel import UNPLACED, PlanEval, evaluate, fetch_ns
from .topology import MachineSpec


@dataclasses.dataclass
class PlacementResult:
    placement: List[int]
    eval: Optional[PlanEval]
    feasible: bool
    nodes_explored: int
    exhausted: bool               # search ran to completion (vs. node budget)
    wall_s: float

    @property
    def R(self) -> float:
        return self.eval.R if self.eval is not None and self.feasible else 0.0


class _State:
    """Incremental per-node search state (copied on branch)."""

    __slots__ = ("placement", "proc_w", "proc_b", "cpu", "mem", "chan")

    def __init__(self, n_units: int, machine: MachineSpec):
        self.placement = np.full(n_units, UNPLACED, dtype=np.int64)
        self.proc_w = np.zeros(n_units)     # faithful weighted-mix rates
        self.proc_b = np.zeros(n_units)     # monotone min-mix rates (bound)
        self.cpu = np.zeros(machine.n_sockets)
        self.mem = np.zeros(machine.n_sockets)
        self.chan = np.zeros((machine.n_sockets, machine.n_sockets))

    def copy(self) -> "_State":
        st = _State.__new__(_State)
        st.placement = self.placement.copy()
        st.proc_w = self.proc_w.copy()
        st.proc_b = self.proc_b.copy()
        st.cpu = self.cpu.copy()
        st.mem = self.mem.copy()
        st.chan = self.chan.copy()
        return st


class _Search:
    def __init__(self, graph: ExecutionGraph, machine: MachineSpec,
                 input_rate: Optional[float], bestfit: bool,
                 max_nodes: int,
                 time_limit: Optional[float], tf_mode: str = "relative"):
        self.g = graph
        self.m = machine
        self.I = input_rate
        self.bestfit = bestfit
        self.max_nodes = max_nodes
        self.time_limit = time_limit
        self.tf_mode = tf_mode
        self.worst_lat = float(np.max(machine.L))
        self.order = graph.topo_unit_order()
        self.tiers = machine.distance_tiers()
        self.nodes = 0
        self.best_R = 0.0
        self.best_placement: Optional[np.ndarray] = None
        self.exhausted = True

    def _tf(self, su: int, sv: int, nbytes: float) -> float:
        """T^f under the search's capability assumption (RLAS / fix(L) / fix(U))."""
        if self.tf_mode == "zero":
            return 0.0
        if self.tf_mode == "worst":
            return math.ceil(nbytes / self.m.cache_line) * self.worst_lat
        return fetch_ns(nbytes, self.m, su, sv)

    # -- rate updates ------------------------------------------------------
    def _unit_rates(self, st: _State, v: int, socket: int
                    ) -> Tuple[float, float, float, float, List[Tuple[int, float]]]:
        """Rates of unit v if placed on ``socket`` given the placed prefix.

        Returns (processed_w, processed_b, util_w, r_in, fetch_shares)."""
        rep = self.g.replicas[v]
        te = rep.spec.exec_s
        group = rep.group
        if rep.spec.is_spout:
            cap = group / te if te > 0 else math.inf
            if self.I is None:
                share = math.inf
            else:
                share = self.I * group / self.g.parallelism[rep.op]
            p = min(share, cap)
            return p, p, p * te, share, []
        ins = self.g.in_edges[v]
        rates_w, rates_b, svcs = [], [], []
        for u, w in ins:
            rates_w.append(st.proc_w[u] * w)
            rates_b.append(st.proc_b[u] * w)
            su = st.placement[u]
            tf = self._tf(su, socket, rep.spec.tuple_bytes) \
                if socket != UNPLACED else self._tf(UNPLACED, UNPLACED,
                                                    rep.spec.tuple_bytes)
            svcs.append(te + tf)
        tot_w = sum(rates_w)
        tot_b = sum(rates_b)
        if tot_w <= 0:
            pw = 0.0
            util = 0.0
            shares: List[Tuple[int, float]] = []
        else:
            t_mix = sum(r * s for r, s in zip(rates_w, svcs)) / tot_w
            cap_w = group / t_mix if t_mix > 0 else math.inf
            pw = min(tot_w, cap_w)
            util = pw * t_mix
            shares = [(u, pw * (r / tot_w)) for (u, _), r in zip(ins, rates_w)]
        if tot_b <= 0:
            pb = 0.0
        else:
            t_min = min(svcs)
            cap_b = group / t_min if t_min > 0 else math.inf
            pb = min(tot_b, cap_b)
        return pw, pb, util, tot_w, shares

    def _apply(self, st: _State, v: int, socket: int) -> bool:
        """Place v on socket, updating usage. False if constraints violated."""
        pw, pb, util, _, shares = self._unit_rates(st, v, socket)
        rep = self.g.replicas[v]
        st.placement[v] = socket
        st.proc_w[v] = pw
        st.proc_b[v] = pb
        st.cpu[socket] += util
        st.mem[socket] += pw * rep.spec.mem_bytes
        ok = True
        if st.cpu[socket] > self.m.cores_per_socket + 1e-9:
            ok = False
        if st.mem[socket] > self.m.local_bw * (1 + 1e-9):
            ok = False
        for u, fr in shares:
            su = st.placement[u]
            if su != socket and su != UNPLACED:
                st.chan[su, socket] += fr * rep.spec.tuple_bytes
                if st.chan[su, socket] > self.m.Q[su, socket] * (1 + 1e-9):
                    ok = False
        return ok

    # -- bounding ----------------------------------------------------------
    def _bound(self, st: _State, depth: int) -> float:
        """Optimistic R: propagate min-mix rates with T^f=0 for unplaced."""
        proc = st.proc_b.copy()
        for d in range(depth, len(self.order)):
            v = self.order[d]
            rep = self.g.replicas[v]
            if rep.spec.is_spout:
                te = rep.spec.exec_s
                cap = rep.group / te if te > 0 else math.inf
                share = math.inf if self.I is None else \
                    self.I * rep.group / self.g.parallelism[rep.op]
                proc[v] = min(share, cap)
                continue
            te = rep.spec.exec_s + self._tf(UNPLACED, UNPLACED,
                                            rep.spec.tuple_bytes)
            tot = sum(proc[u] * w for u, w in self.g.in_edges[v])
            cap = rep.group / te if te > 0 else math.inf
            proc[v] = min(tot, cap)
        return float(sum(proc[v] for v in self.g.sink_units()))

    # -- candidate sockets with symmetry collapse (heuristic 1) -------------
    def _candidates(self, st: _State) -> List[int]:
        used = [s for s in range(self.m.n_sockets)
                if st.cpu[s] > 0 or st.mem[s] > 0]
        out: List[int] = []
        seen_sigs = set()
        for s in range(self.m.n_sockets):
            if s in used:
                out.append(s)
                continue
            sig = tuple(self.tiers[s, t] for t in used)
            if sig in seen_sigs:
                continue
            seen_sigs.add(sig)
            out.append(s)
        return out

    # -- main DFS ------------------------------------------------------------
    def run(self) -> PlacementResult:
        t0 = time.time()
        n = self.g.n_units
        root = _State(n, self.m)
        stack: List[Tuple[_State, int]] = [(root, 0)]
        while stack:
            if self.nodes >= self.max_nodes or (
                    self.time_limit and time.time() - t0 > self.time_limit):
                self.exhausted = False
                break
            st, depth = stack.pop()
            self.nodes += 1
            if depth == n:
                R = float(sum(st.proc_w[v] for v in self.g.sink_units()))
                if R > self.best_R:
                    self.best_R = R
                    self.best_placement = st.placement.copy()
                continue
            if self._bound(st, depth) <= self.best_R * (1 + 1e-12):
                continue
            v = self.order[depth]
            children: List[Tuple[float, float, int, _State]] = []
            for s in self._candidates(st):
                child = st.copy()
                ok = self._apply(child, v, s)
                if not ok:
                    # Rates of placed units are final (the model is
                    # feed-forward), so resource usage only grows with depth:
                    # a violated prefix can never become feasible -> exact prune.
                    continue
                bound = self._bound(child, depth + 1)
                if bound <= self.best_R * (1 + 1e-12):
                    continue
                # best-fit key: own output rate, then least remaining CPU
                remaining = self.m.cores_per_socket - child.cpu[s]
                children.append((child.proc_w[v], -remaining, s, child))
            if not children:
                continue
            children.sort(key=lambda c: (c[0], c[1]))
            if self.bestfit:
                # heuristic 2: keep only the best-fit child
                children = children[-1:]
            for _, _, _, child in children:      # best last -> popped first
                stack.append((child, depth + 1))
        placement = self.best_placement
        if placement is None:
            return PlacementResult(
                placement=[UNPLACED] * n, eval=None, feasible=False,
                nodes_explored=self.nodes, exhausted=self.exhausted,
                wall_s=time.time() - t0)
        # Final value is always reported under the *true* relative model, even
        # when the search optimized under a fixed-capability assumption
        # (RLAS_fix evaluation protocol, paper §6.4).
        ev = evaluate(self.g, self.m, list(placement), self.I, mix="weighted",
                      tf_mode="relative")
        return PlacementResult(
            placement=[int(s) for s in placement], eval=ev,
            feasible=ev.feasible, nodes_explored=self.nodes,
            exhausted=self.exhausted, wall_s=time.time() - t0)


def bnb_place(graph: ExecutionGraph, machine: MachineSpec,
              input_rate: Optional[float] = None, bestfit: bool = False,
              max_nodes: int = 200_000,
              time_limit: Optional[float] = None,
              tf_mode: str = "relative") -> PlacementResult:
    """Optimize placement of ``graph`` on ``machine`` (Algorithm 2)."""
    return _Search(graph, machine, input_rate, bestfit,
                   max_nodes, time_limit, tf_mode).run()


def brute_force_place(graph: ExecutionGraph, machine: MachineSpec,
                      input_rate: Optional[float] = None) -> PlacementResult:
    """Exhaustive reference optimizer for tests (tiny instances only)."""
    import itertools
    n = graph.n_units
    assert machine.n_sockets ** n <= 3_000_000, "instance too large"
    best_R, best_p = 0.0, None
    count = 0
    t0 = time.time()
    for combo in itertools.product(range(machine.n_sockets), repeat=n):
        count += 1
        ev = evaluate(graph, machine, list(combo), input_rate, mix="weighted")
        if ev.feasible and ev.R > best_R:
            best_R, best_p = ev.R, list(combo)
    if best_p is None:
        return PlacementResult([UNPLACED] * n, None, False, count, True,
                               time.time() - t0)
    ev = evaluate(graph, machine, best_p, input_rate, mix="weighted")
    return PlacementResult(best_p, ev, True, count, True, time.time() - t0)
