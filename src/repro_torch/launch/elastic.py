"""Elastic scaling and fault recovery (paper §5.3).

Counterpart of the reference's ``launch/elastic.py``. On a change of
topology (a pod lost, a resize) recovery is:

1. :func:`replan`: the RLAS optimizer run again against the surviving
   topology (``core.autoshard.plan_stages`` on ``tpu_pod_spec``, as the
   reference's): pipeline-stage placement and the DP degree come from the
   same performance model, not from a hand edit;
2. :func:`reshard_checkpoint`: the last committed checkpoint restored with
   the new mesh's placements (``ckpt.restore(..., shardings=, mesh=)``:
   the checkpoint holds whole tensors, each rank takes its slice);
3. the data pipeline resumes from its checkpointed counter.

:func:`simulate_pod_failure` plans before and after a pod loss.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.core.autoshard import plan_stages
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class ElasticPlan:
    n_pods: int
    chips_per_pod: int
    stage_assignment: Dict[str, int]      # stage -> pod
    dp_degree: int
    est_throughput: float                 # microbatches/s (model estimate)


def replan(cfg: ModelConfig, n_pods: int, chips_per_pod: int = 256,
           microbatch: int = 16, seq: int = 4096) -> ElasticPlan:
    """RLAS re-optimization for the surviving topology."""
    result = plan_stages(cfg, n_pods=n_pods, chips_per_pod=chips_per_pod,
                         microbatch=microbatch, seq=seq)
    return ElasticPlan(n_pods=n_pods, chips_per_pod=chips_per_pod,
                       stage_assignment=result.assignment,
                       dp_degree=result.dp_degree,
                       est_throughput=result.throughput)


def reshard_checkpoint(ckpt_dir: str, step: int, target_tree,
                       new_shardings=None, mesh=None):
    """Restore checkpoint ``step`` of ``ckpt_dir`` laid out by
    ``new_shardings`` (placements on ``mesh``; None: whole tensors) into
    ``target_tree``'s structure, whose leaves are this rank's slices.
    Returns (tree, extra), as ``ckpt.restore``."""
    from repro_torch.ckpt import checkpoint as ckpt
    return ckpt.restore(ckpt_dir, step, target_tree, shardings=new_shardings,
                        mesh=mesh)


def simulate_pod_failure(cfg: ModelConfig, before_pods: int = 2,
                         after_pods: int = 1) -> Tuple[ElasticPlan, ElasticPlan]:
    """Plans before and after a pod loss; the throughput degrades
    gracefully."""
    return replan(cfg, before_pods), replan(cfg, after_pods)
