"""RLAS: relative-location aware scheduling (the paper's core contribution).

Public API:
  topology.MachineSpec / server_a / server_b / tpu_pod_spec
  graph.LogicalGraph / OperatorSpec / ExecutionGraph
  perfmodel.evaluate / PlanEval
  placement.bnb_place / brute_force_place
  scaling.rlas_optimize
  baselines.ff_place / rr_place / random_plan
"""
from .graph import ExecutionGraph, LogicalGraph, OperatorSpec, Replica
from .perfmodel import UNPLACED, PlanEval, evaluate
from .placement import PlacementResult, bnb_place, brute_force_place
from .scaling import ScalingResult, rlas_optimize
from .topology import MachineSpec, server_a, server_b, subset, tpu_pod_spec
from . import baselines

__all__ = [
    "ExecutionGraph", "LogicalGraph", "OperatorSpec", "Replica",
    "UNPLACED", "PlanEval", "evaluate",
    "PlacementResult", "bnb_place", "brute_force_place",
    "ScalingResult", "rlas_optimize",
    "MachineSpec", "server_a", "server_b", "subset", "tpu_pod_spec",
    "baselines",
]
