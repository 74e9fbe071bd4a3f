"""Execution-plan measurement oracle (no NUMA hardware in this container).

Two simulators stand in for the paper's bare-metal runs (DESIGN.md §6):

* :func:`fluid_solve` — a damped fixed-point solver over tuple rates that,
  unlike the analytical §3.1 model, *degrades* under contention instead of
  declaring plans infeasible: CPU oversubscription causes processor sharing,
  memory-bandwidth and channel saturation stretch service times.  This is the
  physical behaviour of the paper's relaxed FF/RR plans ("ends up with
  oversubscribing of a few CPU sockets").
* :func:`des_simulate` — a discrete-event simulation at *jumbo tuple*
  granularity: bounded queues, FCFS service, batching delay, CPU processor
  sharing.  Reports throughput and end-to-end latency percentiles (the
  paper's Fig. 7 protocol: event enters at the spout, leaves at the sink).

The analytical model (estimate) vs these simulators (measurement) gives the
Table 4 relative-error analysis.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
import math
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np

from repro_torch.core import ExecutionGraph, MachineSpec
from repro_torch.core.perfmodel import UNPLACED

from .routing import (RoutingTable, compile_routes, extract_event_times,
                      extract_keys, unit_delivery)
from .state import WindowSpec, grid_pane_ends, pane_range


@dataclasses.dataclass
class FluidResult:
    R: float
    processed: np.ndarray
    cpu_scale: np.ndarray          # per-socket processor-sharing factor
    iterations: int
    converged: bool


def _validate_spout_rates(graph: ExecutionGraph, input_rate) -> None:
    """Per-spout rate dicts must name spout operators only (spouts absent
    from the mapping are fed at rate 0) — one rule for DES and fluid."""
    spout_ops = set(graph.logical.spouts())
    unknown = sorted(set(input_rate) - spout_ops)
    if unknown:
        raise ValueError(
            f"input_rate names non-spout operators {unknown} "
            f"(spouts: {sorted(spout_ops)}); spouts absent from the "
            "mapping are fed at rate 0")


def fluid_solve(graph: ExecutionGraph, machine: MachineSpec,
                placement: List[int], input_rate=None,
                max_iters: int = 200, tol: float = 1e-6) -> FluidResult:
    """Damped fixed-point rate solver (see module docstring).

    ``input_rate`` is the external ingress: ``None`` (saturation), a float
    feeding every spout operator at that rate, or a ``{spout_op: rate}``
    mapping feeding each spout its own stream — the same contract
    :func:`des_simulate` honours, so under-fed multi-spout studies are
    uniform across backends.
    """
    if isinstance(input_rate, dict):
        _validate_spout_rates(graph, input_rate)
    n = graph.n_units
    order = graph.topo_unit_order()
    te = np.array([r.spec.exec_s for r in graph.replicas])
    group = np.array([float(r.group) for r in graph.replicas])
    nbytes = np.array([r.spec.tuple_bytes for r in graph.replicas])
    mbytes = np.array([r.spec.mem_bytes for r in graph.replicas])
    is_spout = np.array([r.spec.is_spout for r in graph.replicas])
    sock = np.array(placement)

    base_tf = np.zeros((n, n))
    for u, v, _ in graph.edges:
        su, sv = placement[u], placement[v]
        if su != UNPLACED and sv != UNPLACED and su != sv:
            base_tf[u, v] = machine.fetch_time(su, sv, nbytes[v])

    processed = np.zeros(n)
    cpu_scale = np.ones(machine.n_sockets)
    it = 0
    converged = False
    for it in range(1, max_iters + 1):
        # contention multipliers from current rates
        mem_demand = np.zeros(machine.n_sockets)
        chan_demand = np.zeros((machine.n_sockets, machine.n_sockets))
        for v in range(n):
            if sock[v] != UNPLACED:
                mem_demand[sock[v]] += processed[v] * mbytes[v]
        for u, v, w in graph.edges:
            su, sv = sock[u], sock[v]
            if su != UNPLACED and sv != UNPLACED and su != sv:
                chan_demand[su, sv] += processed[u] * w * nbytes[v]
        mem_mult = np.maximum(1.0, mem_demand / machine.local_bw)
        with np.errstate(divide="ignore", invalid="ignore"):
            chan_mult = np.where(machine.Q > 0,
                                 np.maximum(1.0, chan_demand / machine.Q), 1.0)
        # forward pass: desired rates under stretched service times
        desired = np.zeros(n)
        util = np.zeros(n)
        for v in order:
            if is_spout[v]:
                cap = group[v] / te[v] if te[v] > 0 else math.inf
                op = graph.replicas[v].op
                rate = input_rate.get(op, 0.0) \
                    if isinstance(input_rate, dict) else input_rate
                share = math.inf if rate is None else \
                    rate * group[v] / graph.parallelism[op]
                desired[v] = min(share, cap)
                util[v] = desired[v] * te[v]
                continue
            ins = graph.in_edges[v]
            rates = np.array([desired[u] * w for u, w in ins])
            tot = rates.sum()
            if tot <= 0:
                continue
            mm = mem_mult[sock[v]] if sock[v] != UNPLACED else 1.0
            svc = np.array([
                te[v] * mm + base_tf[u, v] *
                (chan_mult[sock[u], sock[v]]
                 if sock[u] != UNPLACED and sock[v] != UNPLACED else 1.0)
                for u, _ in ins])
            t_mix = float((rates * svc).sum() / tot)
            cap = group[v] / t_mix if t_mix > 0 else math.inf
            desired[v] = min(tot, cap)
            util[v] = desired[v] * t_mix
        # processor sharing: scale back oversubscribed sockets
        cpu_demand = np.zeros(machine.n_sockets)
        for v in range(n):
            if sock[v] != UNPLACED:
                cpu_demand[sock[v]] += util[v]
        cpu_scale = np.minimum(
            1.0, machine.cores_per_socket / np.maximum(cpu_demand, 1e-30))
        new = np.array([
            desired[v] * (cpu_scale[sock[v]] if sock[v] != UNPLACED else 1.0)
            for v in range(n)])
        if np.allclose(new, processed, rtol=tol, atol=1e-9):
            processed = new
            converged = True
            break
        processed = 0.5 * processed + 0.5 * new
    R = float(sum(processed[v] for v in graph.sink_units()))
    return FluidResult(R, processed, cpu_scale, it, converged)


# ---------------------------------------------------------------------------
# Discrete-event simulation at jumbo-tuple granularity
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DesResult:
    R: float                        # sink tuples/sec
    latency_p50: float              # seconds, spout entry -> sink
    latency_p99: float
    sim_time: float
    sink_tuples: float
    queue_drops: int                # jumbos dropped at full queues
    busy_s: Optional[np.ndarray] = None       # per-unit busy seconds
    unit_tuples: Optional[np.ndarray] = None  # per-unit processed tuples
    mem_rate: Optional[np.ndarray] = None     # per-socket bytes/s (M traffic)
    state_bytes: float = 0.0        # total declared-state bytes charged
    # (OperatorSpec.state_bytes x tuples — the DES-side ledger of the same
    #  StateSpec-derived traffic the §3.3 constraint and fluid solver charge)
    pane_latency_p50: float = math.nan  # seconds, pane-end event generated
    pane_latency_p99: float = math.nan  # at the spout -> pane fired
    panes_fired: int = 0            # event-time panes fired (post-warmup)
    pane_batches: int = 0           # watermark advances that released >=1
    # pane — the unit of work the segmented engine executes (one stacked
    # kernel call per batch), so panes_fired/pane_batches is the
    # amortization the runtime gets over a pane-at-a-time loop


def probe_et_spacing(app, batch: int = 256, batches: int = 3,
                     seed: int = 0) -> Dict[str, float]:
    """Empirical event-time increment per tuple, per spout.

    Draws ``batches`` seeded batches from each spout that declares
    ``event_time=`` and reports the mean increment —
    ``(max - min) / (count - 1)`` over the observed event times — so the
    DES paces watermarks (and therefore pane firing and pane latency) at
    the *app's* actual event-time density instead of the one-tick-per-
    tuple constant.  Bursty sources (many readings per tick, or sparse
    ticks) get correspondingly tighter ``pane_latency_p50/p99``.
    """
    out: Dict[str, float] = {}
    for spout, extractor in (getattr(app, "event_time", None) or {}).items():
        source = app.source_for(spout)
        ets = [extract_event_times(source(batch, seed + b), extractor)
               for b in range(batches)]
        allts = np.concatenate([e for e in ets if len(e)]) \
            if any(len(e) for e in ets) else np.zeros(0)
        if len(allts) > 1 and float(allts.max()) > float(allts.min()):
            out[spout] = (float(allts.max()) - float(allts.min())) \
                / (len(allts) - 1)
        else:
            out[spout] = 1.0
    return out


def _spout_rows(app, op: str, batch: int, batches: int,
                seed: int) -> List[np.ndarray]:
    """Seeded sample batches from every spout upstream of ``op`` (the probe
    convention: extractors are applied to *spout* rows, valid whenever the
    upstream path passes the probed columns through unchanged — true of
    every benchmark app and documented as the probes' contract)."""
    from .runtime import upstream_spouts
    rows = []
    for sp in upstream_spouts(app.graph, op):
        source = app.source_for(sp)
        rows.extend(source(batch, seed + b) for b in range(batches))
    return rows


def probe_pane_keys(app, batch: int = 256, batches: int = 3,
                    seed: int = 0) -> Dict[str, float]:
    """Empirical per-span pane multiplicity of keyed event-time windows.

    For each operator declaring keyed pane groups
    (``WindowSpec(keyed=True)``), draws seeded batches from its upstream
    spouts and counts distinct non-empty ``(key, span)`` pairs against
    distinct spans — the mean number of key panes one grid span fires.
    ``des_simulate(pane_keys=...)`` scales its grid-walk pane accounting by
    this factor (the DES tracks rates, not tuple contents, so it cannot see
    key occupancy itself); ``Plan.simulate`` plumbs the probe in
    automatically.  Unkeyed windows are multiplicity 1 and omitted.
    """
    out: Dict[str, float] = {}
    routes = compile_routes(app)
    for op, sspec in (getattr(app, "state", None) or {}).items():
        w = sspec.window
        if w is None or not w.time or not w.keyed:
            continue
        key_by = routes.key_extractor(op)
        pairs, spans = set(), set()
        for arr in _spout_rows(app, op, batch, batches, seed):
            if not len(arr):
                continue
            ets = extract_event_times(arr, w.time_by)
            keys = extract_keys(arr, key_by)
            k_lo, k_hi = pane_range(ets, w.size, w.slide)
            for lo, hi, key in zip(k_lo, k_hi, keys):
                for k in range(int(lo), int(hi) + 1):
                    pairs.add((k, int(key)))
                    spans.add(k)
        out[op] = len(pairs) / max(len(spans), 1)
    return out


def replay_pane_counts(app, *, batches: int, batch: int = 256,
                       seed: int = 0,
                       parallelism: Optional[Dict[str, int]] = None
                       ) -> Dict[str, int]:
    """Exact pane ledger for a deterministic replay (``max_batches`` mode).

    Replays every spout's seeded draws (replica ``i`` of a spout seeds
    ``seed + 7919*i + b``, exactly the runtime's enumeration) through the
    shared pane arithmetic and counts the non-empty panes each event-time
    windowed operator must fire by end of stream: distinct ``(key, span)``
    pairs for keyed pane groups, distinct spans otherwise.  Replication of
    the windowed operator shards panes without changing their union, so
    the ledger is the runtime's total ``panes_fired`` for any replica
    count — provided no tuple goes late (lateness >= the stream's skew;
    the benchmark sources guarantee it), since late rows never join a
    pane.  This is the DES-side ground truth the runtime==DES pane-count
    assertions compare against.
    """
    parallelism = parallelism or {}
    out: Dict[str, int] = {}
    routes = compile_routes(app)
    from .runtime import upstream_spouts
    for op, sspec in (getattr(app, "state", None) or {}).items():
        w = sspec.window
        if w is None or not w.time:
            continue
        key_by = routes.key_extractor(op) if w.keyed else None
        panes = set()
        for sp in upstream_spouts(app.graph, op):
            source = app.source_for(sp)
            for i in range(parallelism.get(sp, 1)):
                for b in range(batches):
                    arr = source(batch, seed + 7919 * i + b)
                    if not len(arr):
                        continue
                    ets = extract_event_times(arr, w.time_by)
                    keys = extract_keys(arr, key_by) if w.keyed \
                        else np.zeros(len(arr), np.int64)
                    k_lo, k_hi = pane_range(ets, w.size, w.slide)
                    for lo, hi, key in zip(k_lo, k_hi, keys):
                        for k in range(int(lo), int(hi) + 1):
                            panes.add((k, int(key)))
        out[op] = len(panes)
    return out


def des_simulate(graph: ExecutionGraph, machine: MachineSpec,
                 placement: List[int], input_rate,
                 batch: int = 64, horizon: float = 0.02,
                 queue_cap: int = 64, warmup_frac: float = 0.3,
                 seed: int = 0,
                 routes: Optional[RoutingTable] = None,
                 time_windows: Optional[Dict[str, WindowSpec]] = None,
                 et_spacing: Union[float, Mapping[str, float]] = 1.0,
                 pane_keys: Optional[Mapping[str, float]] = None
                 ) -> DesResult:
    """Simulate ``horizon`` seconds of plan execution.

    Jumbo tuples of ``batch`` tuples flow through bounded FCFS queues.  CPU
    contention is modelled as processor sharing sampled at service start:
    service stretches by (busy threads on socket / cores) when oversubscribed.
    Full queues drop the jumbo (a stand-in for backpressure; the reported R
    under drops equals the backpressured stable rate for these feed-forward
    graphs).

    Tuple delivery follows the compiled routing tables
    (:func:`repro_torch.streaming.routing.unit_delivery` — selectivity x partition
    strategy x fan-out), the same substrate the planner and the threaded
    runtime consume; ``routes`` defaults to the table the graph was compiled
    with.  ``input_rate`` is the external ingress rate: a float feeds every
    spout operator at that rate; a ``{spout_op: rate}`` mapping feeds each
    spout its own stream (multi-spout apps, e.g. Linear Road's
    historical-query source).

    Memory traffic is charged per processed tuple from the operator specs
    (``mem_bytes``, which topologies with declared state derive from their
    ``StateSpec``): when a socket's cumulative byte rate exceeds its local
    bandwidth, service times on that socket stretch by the oversubscription
    factor — the DES-side analogue of the fluid solver's ``mem_mult`` and
    the §3.3 constraint.

    ``time_windows`` (``{operator: WindowSpec(time=True)}``, what
    ``Plan.simulate`` passes from the app's declarations) turns on
    *watermark delivery*: each spout unit's low-watermark advances with its
    emitted tuples (``et_spacing`` event-time units per tuple — a float for
    every spout, or a ``{spout_op: spacing}`` mapping; ``Plan.simulate``
    passes the per-spout empirical mean from :func:`probe_et_spacing`,
    and the 1.0 default is the SD convention of one tick per reading),
    rides the same
    ``unit_delivery`` edges as the jumbo tuples (one hop per service
    completion), and is min-merged per consumer unit exactly like the
    threaded runtime's :class:`~.routing.WatermarkMerger`.  Windowed units
    fire panes on the same grid arithmetic the runtime uses
    (:func:`repro_torch.streaming.state.grid_pane_ends`), and
    ``DesResult.pane_latency_p50/p99`` report pane-end generation at the
    spout -> pane firing — the latency cost of waiting for completeness
    (batching + queueing + lateness wait), which no other layer models.
    Panes are paced on the dense grid (the DES tracks rates, not contents).

    ``pane_keys`` (``{operator: multiplicity}``, from
    :func:`probe_pane_keys`) corrects the grid walk for *keyed* pane
    groups: one grid span of a keyed window fires one pane per occupied
    key, so ``panes_fired`` and the ``pane_latency`` sample weights scale
    by the probed per-span multiplicity.  The multiplicity is divided
    across the operator's units — keys shard over replicas, the grid does
    not — so the op-level total matches the runtime's sharded-pane union
    instead of multiplying by the replica count.
    """
    rng = np.random.default_rng(seed)
    n = graph.n_units
    sock = list(placement)
    te = [r.spec.exec_s for r in graph.replicas]
    group = [r.group for r in graph.replicas]
    mbytes = [r.spec.mem_bytes for r in graph.replicas]
    sbytes = [r.spec.state_bytes for r in graph.replicas]
    delivery = unit_delivery(graph, routes)
    if isinstance(input_rate, dict):
        _validate_spout_rates(graph, input_rate)

    # -- event-time windows: watermark state (see docstring) ---------------
    win_units: Dict[int, WindowSpec] = {}
    if time_windows:
        unknown = sorted(set(time_windows) - set(graph.logical.operators))
        if unknown:
            raise ValueError(
                f"time_windows names unknown operators {unknown}")
        for op, wspec in time_windows.items():
            if not wspec.time:
                raise ValueError(
                    f"time_windows[{op!r}] is a count window; the DES "
                    "paces event-time panes only")
            for vi in graph.units_of(op):
                win_units[vi] = wspec
    unit_mult: Dict[int, float] = {}
    if pane_keys:
        unknown = sorted(set(pane_keys) - set(time_windows or {}))
        if unknown:
            raise ValueError(
                f"pane_keys names operators without a declared time "
                f"window: {unknown}")
        for op, mult in pane_keys.items():
            # keys shard over the op's units; the grid walk repeats per unit
            for vi in graph.units_of(op):
                unit_mult[vi] = float(mult) / graph.parallelism[op]
    track_wm = bool(win_units)
    unit_wm = [-math.inf] * n
    lane_wm: Dict[Tuple[int, int], float] = {}
    unit_producers = {v: sorted({u for u, _ in graph.in_edges[v]})
                      for v in range(n)}
    fired_bound = {v: -math.inf for v in win_units}
    spout_count = {v: 0 for v in graph.spout_units()}
    if isinstance(et_spacing, Mapping):
        unknown = sorted(set(et_spacing)
                         - set(graph.logical.spouts()))
        if unknown:
            raise ValueError(
                f"et_spacing names non-spout operators {unknown}")
        unit_spacing = {v: float(et_spacing.get(graph.replicas[v].op, 1.0))
                        for v in spout_count}
    else:
        unit_spacing = {v: float(et_spacing) for v in spout_count}
    et_log_e: Dict[int, List[float]] = {v: [] for v in spout_count}
    et_log_t: Dict[int, List[float]] = {v: [] for v in spout_count}
    pane_lat: List[float] = []
    panes_fired = 0
    pane_batches = 0
    anc: Dict[int, List[int]] = {}          # windowed unit -> spout units
    if track_wm:
        lg = graph.logical
        for vi in win_units:
            seen, frontier = set(), [graph.replicas[vi].op]
            while frontier:
                x = frontier.pop()
                if x in seen:
                    continue
                seen.add(x)
                frontier.extend(lg.producers(x))
            anc[vi] = [u for sp in lg.spouts() if sp in seen
                       for u in graph.units_of(sp)]

    def _complete_wall(vi: int, end: float, now: float) -> float:
        """Wall time the *slowest* ancestor source generated the pane-end
        event (the moment the pane was complete in the outside world)."""
        t = 0.0
        for s in anc[vi]:
            i = bisect.bisect_left(et_log_e[s], end - 1e-9)
            t = max(t, et_log_t[s][i] if i < len(et_log_t[s]) else now)
        return t

    def _propagate_wm(u: int, now: float) -> None:
        """One watermark hop along the same delivery edges as the jumbos:
        min-merge per consumer unit, fire pane *batches* the merged mark
        passed — every released pane of one advance is one unit of work
        (the segmented engine's stacked kernel call), which is what
        ``pane_batches`` counts against ``panes_fired``."""
        nonlocal panes_fired, pane_batches
        for cv, _ in delivery[u]:
            lane_wm[(u, cv)] = unit_wm[u]
            merged = min(lane_wm.get((p, cv), -math.inf)
                         for p in unit_producers[cv])
            if not merged > unit_wm[cv]:
                continue
            unit_wm[cv] = merged
            wspec = win_units.get(cv)
            if wspec is None:
                continue
            bound = merged - wspec.lateness
            ends = grid_pane_ends(fired_bound[cv], bound,
                                  wspec.size, wspec.slide)
            if len(ends) and now >= warm:
                # keyed pane groups: each grid span fires one pane per
                # occupied key (probed multiplicity), so counts and the
                # latency sample weights scale together
                mult = unit_mult.get(cv, 1.0)
                panes_fired += len(ends) * mult
                pane_batches += 1
                w = max(1, int(round(mult)))
                for e in ends:
                    pane_lat.extend([now - _complete_wall(cv, e, now)] * w)
            fired_bound[cv] = max(fired_bound[cv], bound)

    def spout_rate(v: int) -> float:
        op = graph.replicas[v].op
        rate = input_rate.get(op, 0.0) if isinstance(input_rate, dict) \
            else input_rate
        return rate * group[v] / graph.parallelism[op] / batch  # jumbos/sec

    tf = [[0.0] * n for _ in range(n)]
    for u, v, _ in graph.edges:
        su, sv = sock[u], sock[v]
        if su != UNPLACED and sv != UNPLACED and su != sv:
            tf[u][v] = machine.fetch_time(su, sv,
                                          graph.replicas[v].spec.tuple_bytes)

    queues: List[List[Tuple[float, int]]] = [[] for _ in range(n)]  # (t0, prod)
    busy = [0] * n                   # busy threads per unit (<= group)
    sock_busy = [0] * machine.n_sockets
    emit_acc: Dict[Tuple[int, int], float] = {}   # (u, v) -> fractional tuples
    emit_t0: Dict[Tuple[int, int], float] = {}
    lat: List[float] = []
    sink_count = 0.0
    drops = 0
    warm = horizon * warmup_frac

    heap: List[Tuple[float, int, str, int, float]] = []
    seq = 0

    def push(t, kind, unit, t0, prod=-1):
        nonlocal seq
        heapq.heappush(heap, (t, seq, kind, unit, t0, prod))
        seq += 1

    mem_acc = [0.0] * machine.n_sockets   # cumulative M bytes per socket
    state_total = 0.0

    def service_time(v: int, prod: int, now: float) -> float:
        s = sock[v]
        over = 1.0
        if s != UNPLACED:
            over = max(1.0, sock_busy[s] / machine.cores_per_socket)
            if now > 1e-6:
                # bandwidth contention: stretch by the socket's cumulative
                # memory-rate oversubscription (state + tuple traffic per
                # the specs), mirroring fluid_solve's mem_mult
                over *= max(1.0, mem_acc[s] / now / machine.local_bw)
        base = te[v] + (tf[prod][v] if prod >= 0 else 0.0)
        return batch * base * over

    busy_s = [0.0] * n
    unit_tuples = [0.0] * n

    def try_start(v: int, now: float):
        nonlocal state_total
        while busy[v] < group[v] and queues[v]:
            t0, prod = queues[v].pop(0)
            busy[v] += 1
            if sock[v] != UNPLACED:
                sock_busy[sock[v]] += 1
                mem_acc[sock[v]] += batch * mbytes[v]
            svc = service_time(v, prod, now)
            if now >= warm:
                busy_s[v] += svc
                unit_tuples[v] += batch
                state_total += batch * sbytes[v]
            push(now + svc, "done", v, t0, prod)

    def deliver(u: int, v: int, amount: float, t0: float, now: float):
        nonlocal drops
        key = (u, v)
        acc = emit_acc.get(key, 0.0) + amount
        if key not in emit_t0:
            emit_t0[key] = t0
        while acc >= batch:
            acc -= batch
            if len(queues[v]) >= queue_cap:
                drops += 1
            else:
                queues[v].append((emit_t0[key], u))
                try_start(v, now)
            emit_t0[key] = t0
        emit_acc[key] = acc

    # spout arrivals: deterministic at the per-spout ingress rate
    for v in graph.spout_units():
        rate = spout_rate(v)
        if rate > 0:
            push(rng.uniform(0, 1.0 / rate), "arrive", v, 0.0)

    while heap:
        now, _, kind, v, t0, prod = heapq.heappop(heap)
        if now > horizon:
            break
        if kind == "arrive":
            push(now + 1.0 / spout_rate(v), "arrive", v, 0.0)
            if track_wm:
                # the source generated `batch` more tuples: its event clock
                # (and low-watermark) advances whether or not the jumbo fits
                spout_count[v] += batch
                unit_wm[v] = spout_count[v] * unit_spacing[v]
                et_log_e[v].append(unit_wm[v])
                et_log_t[v].append(now)
            if len(queues[v]) >= queue_cap:
                drops += 1
            else:
                queues[v].append((now, v))
                try_start(v, now)
        else:                                         # done
            busy[v] -= 1
            if sock[v] != UNPLACED:
                sock_busy[sock[v]] -= 1
            if not delivery[v]:                       # sink
                if now >= warm:
                    sink_count += batch
                    lat.append(now - t0)
            for cv, w in delivery[v]:
                deliver(v, cv, batch * w, t0, now)
            if track_wm:
                _propagate_wm(v, now)
            try_start(v, now)

    span = max(horizon - warm, 1e-9)
    lat_arr = np.array(lat) if lat else np.array([0.0])
    pane_arr = np.array(pane_lat) if pane_lat else None
    return DesResult(
        R=sink_count / span,
        latency_p50=float(np.percentile(lat_arr, 50)),
        latency_p99=float(np.percentile(lat_arr, 99)),
        sim_time=horizon, sink_tuples=sink_count, queue_drops=drops,
        busy_s=np.array(busy_s), unit_tuples=np.array(unit_tuples),
        mem_rate=np.array(mem_acc) / horizon, state_bytes=state_total,
        pane_latency_p50=(math.nan if pane_arr is None else
                          float(np.percentile(pane_arr, 50))),
        pane_latency_p99=(math.nan if pane_arr is None else
                          float(np.percentile(pane_arr, 99))),
        panes_fired=int(round(panes_fired)), pane_batches=int(pane_batches))


def measure_capacity(graph: ExecutionGraph, machine: MachineSpec,
                     placement: List[int], batch: int = 64,
                     horizon: float = 0.02, seed: int = 0,
                     routes: Optional[RoutingTable] = None,
                     **des_kw) -> DesResult:
    """Paper §6.1 protocol: raise I to saturation and report the stable rate.

    The fluid solver gives the saturation estimate; the DES is then driven at
    1.05x that rate (slightly over-feeding, as the paper does) and the
    observed sink rate is the measured capacity.  Each spout operator is fed
    its *own* fluid saturation rate, so multi-spout apps (e.g. Linear Road's
    historical-query stream) are not cross-over-fed.
    """
    sat = fluid_solve(graph, machine, placement, input_rate=None)
    # convert sink rate back to required ingress via the fluid spout rates
    rates: Dict[str, float] = {}
    for v in graph.spout_units():
        op = graph.replicas[v].op
        rates[op] = rates.get(op, 0.0) + sat.processed[v] * 1.05
    if sum(rates.values()) <= 0:
        return des_simulate(graph, machine, placement, 1.0, batch, horizon,
                            seed=seed, routes=routes, **des_kw)
    return des_simulate(graph, machine, placement, rates, batch, horizon,
                        seed=seed, routes=routes, **des_kw)
