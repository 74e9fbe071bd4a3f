"""Machine topology specifications (paper Table 1, "machine specific" rows).

A :class:`MachineSpec` abstracts a set of *locality domains* ("sockets" in the
paper).  Each domain has compute capacity ``C`` (utilisation units — one unit is
one fully-busy execution context, i.e. a core on the paper's servers or a chip
in a TPU pod), local memory bandwidth ``B`` (bytes/s), and pairwise remote
channel bandwidth ``Q[i][j]`` (bytes/s) / worst-case access latency ``L[i][j]``
(seconds).  ``S`` is the transfer granule (cache-line bytes on CPU; DMA chunk
on TPU — see DESIGN.md §2 hardware-adaptation notes).

Two concrete families are provided:

* ``server_a()`` / ``server_b()`` — the paper's two eight-socket machines
  (Table 2), used by the reproduction benchmarks.
* ``tpu_pod_spec()`` — multi-pod TPU topologies where a "socket" is a pod (or
  an ICI sub-torus), used by :mod:`repro_torch.core.autoshard`.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

NS = 1e-9
GB = 1e9


@dataclasses.dataclass(frozen=True)
class MachineSpec:
    """Hardware model consumed by the performance model and the optimizer."""

    name: str
    n_sockets: int
    cores_per_socket: int          # C, in utilisation units per socket
    local_bw: float                # B, bytes/s attainable from local DRAM/HBM
    Q: np.ndarray                  # (n, n) remote channel bandwidth, bytes/s
    L: np.ndarray                  # (n, n) worst-case access latency, seconds
    cache_line: int = 64           # S, bytes per transfer granule
    ghz: float = 1.0               # clock, used only for cycle<->sec conversions

    def __post_init__(self):
        assert self.Q.shape == (self.n_sockets, self.n_sockets)
        assert self.L.shape == (self.n_sockets, self.n_sockets)

    @property
    def total_cores(self) -> int:
        return self.n_sockets * self.cores_per_socket

    def distance_tiers(self) -> np.ndarray:
        """Integer tier per socket pair (0=local) — used for symmetry collapse."""
        _, inv = np.unique(np.round(self.L / NS, 3), return_inverse=True)
        return inv.reshape(self.L.shape)

    def fetch_time(self, i: int, j: int, n_bytes: float) -> float:
        """T^f for one tuple of ``n_bytes`` fetched by a consumer on socket j
        from a producer on socket i (paper Formula 2)."""
        if i == j:
            return 0.0
        return float(np.ceil(n_bytes / self.cache_line) * self.L[i, j])


def _two_tray_matrices(n: int, local: float, one_hop: float, max_hop: float,
                       tray: int = 4) -> np.ndarray:
    """Paper servers: 8 sockets in 2 trays of 4; same-tray=1 hop, cross=max."""
    m = np.full((n, n), max_hop)
    for i in range(n):
        for j in range(n):
            if i == j:
                m[i, j] = local
            elif i // tray == j // tray:
                m[i, j] = one_hop
    return m


def server_a() -> MachineSpec:
    """HUAWEI KunLun (Server A, Table 2): 8x18 Xeon E7-8890 @1.2GHz."""
    L = _two_tray_matrices(8, 50 * NS, 307.7 * NS, 548.0 * NS)
    Q = _two_tray_matrices(8, 54.3 * GB, 13.2 * GB, 5.8 * GB)
    return MachineSpec("server_a", 8, 18, 54.3 * GB, Q, L, ghz=1.2)


def server_b() -> MachineSpec:
    """HP ProLiant DL980 G7 (Server B, Table 2): 8x8 Xeon E7-2860 @2.27GHz.

    The XNC node controller makes remote bandwidth nearly distance-invariant
    (10.6 vs 10.8 GB/s) — reproduced here.
    """
    L = _two_tray_matrices(8, 50 * NS, 185.2 * NS, 349.6 * NS)
    Q = _two_tray_matrices(8, 24.2 * GB, 10.6 * GB, 10.8 * GB)
    return MachineSpec("server_b", 8, 8, 24.2 * GB, Q, L, ghz=2.27)


def subset(spec: MachineSpec, n_sockets: int) -> MachineSpec:
    """Restrict a machine to its first ``n_sockets`` sockets (Fig. 9 scaling)."""
    assert 1 <= n_sockets <= spec.n_sockets
    return dataclasses.replace(
        spec, name=f"{spec.name}[{n_sockets}]", n_sockets=n_sockets,
        Q=spec.Q[:n_sockets, :n_sockets].copy(),
        L=spec.L[:n_sockets, :n_sockets].copy())


# --------------------------------------------------------------------------
# TPU multi-pod topologies (DESIGN.md §2).  A "socket" is a locality domain:
# a pod, or an ICI sub-torus within a pod when ``domains_per_pod > 1``.
# --------------------------------------------------------------------------

TPU_V5E_PEAK_FLOPS = 197e12     # bf16 FLOP/s per chip
TPU_V5E_HBM_BW = 819e9          # bytes/s per chip
TPU_ICI_BW = 50e9               # bytes/s per ICI link (per direction)
TPU_DCN_BW = 25e9               # bytes/s per pod-to-pod (DCN) connection
TPU_ICI_LAT = 1e-6              # ~1us per ICI hop
TPU_DCN_LAT = 10e-6             # ~10us across pods


def tpu_pod_spec(n_pods: int = 2, chips_per_pod: int = 256,
                 domains_per_pod: int = 1) -> MachineSpec:
    """Multi-pod TPU as a NUMA machine.

    Each locality domain contributes ``chips * 1.0`` utilisation units (a chip
    is a single execution context, like a core).  ``local_bw`` aggregates HBM
    over the domain; Q/L encode ICI (intra-pod) vs DCN (inter-pod) tiers.
    """
    n = n_pods * domains_per_pod
    chips = chips_per_pod // domains_per_pod
    Q = np.zeros((n, n))
    L = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if i == j:
                Q[i, j] = chips * TPU_V5E_HBM_BW
                L[i, j] = 0.0
            elif i // domains_per_pod == j // domains_per_pod:
                # sub-tori within one pod: full ICI bisection of the slice
                Q[i, j] = chips * TPU_ICI_BW
                L[i, j] = TPU_ICI_LAT
            else:
                Q[i, j] = TPU_DCN_BW * chips / 8  # DCN NICs are scarcer
                L[i, j] = TPU_DCN_LAT
    return MachineSpec(
        name=f"tpu_{n_pods}x{chips_per_pod}",
        n_sockets=n, cores_per_socket=chips,
        local_bw=chips * TPU_V5E_HBM_BW, Q=Q, L=L,
        cache_line=512,   # DMA granule; Formula 2's S analog
        ghz=0.94)
