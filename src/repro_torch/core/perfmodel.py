"""Rate-based NUMA-aware performance model (paper §3.1).

Given an execution graph, a machine spec and a (possibly partial) placement,
estimate every unit's input/processed/output rates, application throughput
``R = sum_sink r_o`` and the resource-constraint slack of Eq. 3–5.

Faithful elements
-----------------
* ``T(p) = T^e + T^f`` with ``T^f = ceil(N/S) * L(i,j)`` for anti-collocated
  producer/consumer pairs and 0 when collocated (Formula 2).
* Over-supplied vs under-supplied cases (Case 1/2): an over-supplied unit
  saturates at its capacity; per-producer shares are proportional to the
  corresponding input rates (FCFS mixing).
* The bounding relaxation: unplaced units are assumed collocated with all of
  their producers (``T^f = 0``), giving an optimistic completion.

Deviation (documented, see DESIGN.md §6): the paper aggregates per-producer
service times by *FCFS weighted mixing*, which makes rates non-monotonic in
input rates (a faster upstream can shift the service mix toward a slow remote
edge and *lower* downstream capacity), so the paper's bound is not a strict
upper bound in adversarial cases.  ``evaluate(..., mix="min")`` instead uses
the per-unit *minimum* service time, which restores monotonicity; the branch
and bound uses that form for provably-safe pruning, while plan evaluation
keeps the faithful weighted mix (``mix="weighted"``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .graph import ExecutionGraph
from .topology import MachineSpec

UNPLACED = -1


@dataclasses.dataclass
class PlanEval:
    """Model outputs for one (execution graph, placement) pair."""

    R: float                          # application throughput, tuples/s
    r_in: np.ndarray                  # per-unit total input rate
    processed: np.ndarray             # per-unit processed-tuple rate
    utilization: np.ndarray           # per-unit core-seconds/sec demand
    feasible: bool                    # Eq.3-5 satisfied (placed units only)
    violations: List[str]
    cpu_usage: np.ndarray             # per-socket core-seconds/sec
    mem_usage: np.ndarray             # per-socket bytes/s
    chan_usage: np.ndarray            # (n,n) cross-socket bytes/s
    bottlenecks: Dict[str, float]     # logical op -> max oversupply ratio
    over_supplied: np.ndarray         # per-unit bool
    state_usage: Optional[np.ndarray] = None  # per-socket bytes/s from
    # declared operator state (OperatorSpec.state_bytes) — the share of
    # mem_usage that managed keyed/broadcast/window state accounts for
    state_resident_bytes: Optional[np.ndarray] = None  # per-socket bytes
    # held RESIDENT by in-flight window pane batches: buffer occupancy in
    # tuples x tuple size (OperatorSpec.state_resident_tuples, shared
    # across an operator's replicas) — how much memory window buffering
    # pins on each socket.  Occupancy is rate-independent: the retired
    # wall-seconds Little's-law form priced panes, not pane batches, and
    # over-charged event-time operators by orders of magnitude.

    def summary(self) -> str:
        return (f"R={self.R:,.0f} tuples/s feasible={self.feasible} "
                f"bottlenecks={ {k: round(v, 2) for k, v in self.bottlenecks.items()} }")


def fetch_ns(spec_bytes: float, machine: MachineSpec, si: int, sj: int) -> float:
    """Formula 2 in seconds; 0 when collocated or either side unplaced."""
    if si == UNPLACED or sj == UNPLACED or si == sj:
        return 0.0
    return machine.fetch_time(si, sj, spec_bytes)


def evaluate(graph: ExecutionGraph, machine: MachineSpec,
             placement: Sequence[int], input_rate: Optional[float] = None,
             mix: str = "weighted", tf_mode: str = "relative",
             constrained_only_placed: bool = True) -> PlanEval:
    """Run the rate model over ``graph`` under ``placement``.

    placement[i] is the socket of unit i, or UNPLACED (-1).
    ``input_rate`` is I, the external ingress rate; ``None`` means unbounded
    (the paper's max-capacity configuration, §5.3).
    ``tf_mode``: 'relative' (RLAS), 'zero' (RLAS_fix(U)), 'worst' (RLAS_fix(L)).
    """
    n = graph.n_units
    placement = list(placement)
    assert len(placement) == n
    r_in = np.zeros(n)
    processed = np.zeros(n)
    util = np.zeros(n)
    over = np.zeros(n, dtype=bool)
    # per-edge processed-from-producer rate, for channel constraints
    edge_fetch: Dict[Tuple[int, int], float] = {}

    worst_lat = float(np.max(machine.L))

    def tf(u: int, v: int, nbytes: float) -> float:
        if tf_mode == "zero":
            return 0.0
        if tf_mode == "worst":
            return math.ceil(nbytes / machine.cache_line) * worst_lat
        return fetch_ns(nbytes, machine, placement[u], placement[v])

    for v in graph.topo_unit_order():
        rep = graph.replicas[v]
        te = rep.spec.exec_s
        group = rep.group
        ins = graph.in_edges[v]
        if rep.spec.is_spout:
            cap = group / te if te > 0 else math.inf
            if input_rate is None:
                share = math.inf
            else:
                k = graph.parallelism[rep.op]
                share = input_rate * group / k
            r_in[v] = share
            processed[v] = min(share, cap)
            over[v] = share > cap or input_rate is None
            util[v] = processed[v] * te
            continue
        rates = np.array([processed[u] * w for u, w in ins])
        tot_in = float(rates.sum())
        r_in[v] = tot_in
        svc = np.array([te + tf(u, v, rep.spec.tuple_bytes) for u, _ in ins])
        if tot_in <= 0:
            processed[v] = 0.0
            continue
        if mix == "weighted":
            t_mix = float((rates * svc).sum() / tot_in)
        elif mix == "min":
            t_mix = float(svc.min())
        else:
            raise ValueError(mix)
        cap = group / t_mix if t_mix > 0 else math.inf
        if tot_in > cap:
            processed[v] = cap
            over[v] = True
        else:
            processed[v] = tot_in
        util[v] = processed[v] * t_mix
        # what this unit actually pulls from each producer (Case 1 share)
        for (u, _), rate in zip(ins, rates):
            edge_fetch[(u, v)] = edge_fetch.get((u, v), 0.0) + \
                processed[v] * (rate / tot_in)

    # ---- constraints (Eq. 3-5) over placed units ------------------------
    ns = machine.n_sockets
    cpu = np.zeros(ns)
    mem = np.zeros(ns)
    state_mem = np.zeros(ns)
    state_resident = np.zeros(ns)
    chan = np.zeros((ns, ns))
    violations: List[str] = []
    for v in range(n):
        s = placement[v]
        if s == UNPLACED:
            if constrained_only_placed:
                continue
            s = 0
        rep = graph.replicas[v]
        cpu[s] += util[v]
        mem[s] += processed[v] * rep.spec.mem_bytes
        state_mem[s] += processed[v] * rep.spec.state_bytes
        # occupancy is a property of the window, not the rate.  Stream-
        # sharded buffers (event-time panes) split across the operator's
        # replicas, so a unit's share scales with group/fan-out; per-
        # replica buffers (count-window history) replicate with the group
        occ = rep.spec.state_resident_tuples * rep.spec.tuple_bytes \
            * rep.group
        if rep.spec.state_resident_shared:
            occ /= graph.parallelism[rep.op]
        state_resident[s] += occ
    for (u, v), rate in edge_fetch.items():
        su, sv = placement[u], placement[v]
        if su == UNPLACED or sv == UNPLACED or su == sv:
            continue
        chan[su, sv] += rate * graph.replicas[v].spec.tuple_bytes
    for s in range(ns):
        if cpu[s] > machine.cores_per_socket + 1e-9:
            violations.append(f"cpu@S{s}: {cpu[s]:.2f}>{machine.cores_per_socket}")
        if mem[s] > machine.local_bw * (1 + 1e-9):
            violations.append(f"mem@S{s}: {mem[s]:.2e}>{machine.local_bw:.2e}")
    for i in range(ns):
        for j in range(ns):
            if i != j and chan[i, j] > machine.Q[i, j] * (1 + 1e-9):
                violations.append(
                    f"chan S{i}->S{j}: {chan[i, j]:.2e}>{machine.Q[i, j]:.2e}")

    R = float(sum(processed[v] for v in graph.sink_units()))
    bottlenecks: Dict[str, float] = {}
    for v in range(n):
        if over[v]:
            rep = graph.replicas[v]
            cap = processed[v]
            ratio = math.inf if not np.isfinite(r_in[v]) else (
                r_in[v] / cap if cap > 0 else math.inf)
            bottlenecks[rep.op] = max(bottlenecks.get(rep.op, 0.0), ratio)
    return PlanEval(R=R, r_in=r_in, processed=processed, utilization=util,
                    feasible=not violations, violations=violations,
                    cpu_usage=cpu, mem_usage=mem, chan_usage=chan,
                    bottlenecks=bottlenecks, over_supplied=over,
                    state_usage=state_mem,
                    state_resident_bytes=state_resident)


def bound_value(graph: ExecutionGraph, machine: MachineSpec,
                placement: Sequence[int],
                input_rate: Optional[float] = None,
                paper_bound: bool = False) -> float:
    """Bounding function of the B&B (§4): optimistic throughput of any
    completion of ``placement``.

    With ``paper_bound=True`` this is the paper's exact formulation (weighted
    FCFS mix, unplaced edges at T^f=0); the default uses the monotone ``min``
    mix which is a provable upper bound (see module docstring).
    """
    ev = evaluate(graph, machine, placement, input_rate,
                  mix="weighted" if paper_bound else "min")
    return ev.R
