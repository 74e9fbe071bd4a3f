"""RLAS applied to the LM training pipeline (DESIGN.md §2 TPU adaptation).

The layer stack is a streaming pipeline: *operators* are stages (embed,
period-groups of layers, head+loss), *tuples* are microbatches of
activations, *sockets* are pods.  Stage service time T^e comes from the
stage's roofline (FLOPs / chip compute, parameter+activation bytes / HBM bw);
the fetch term T^f is the paper's Formula (2) with the DMA-granule/ICI-DCN
constants from ``topology.tpu_pod_spec``.

RLAS then *jointly* decides replication (how many chips process each stage —
data parallelism) and placement (which pod) under per-pod compute/bandwidth
constraints — exactly the paper's optimization, answering the multi-pod
question "replicate the pipeline per pod (DP over DCN) or split stages across
pods (PP over DCN)?" from the model rather than by convention.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.models.config import ModelConfig
from .graph import LogicalGraph
from .topology import TPU_V5E_PEAK_FLOPS, TPU_V5E_HBM_BW, tpu_pod_spec

MXU_EFFICIENCY = 0.5            # attainable fraction of peak on real kernels


@dataclasses.dataclass
class StagePlan:
    assignment: Dict[str, int]          # stage -> majority pod
    parallelism: Dict[str, int]         # stage -> chips (DP degree)
    dp_degree: int
    throughput: float                   # microbatches/sec (model estimate)
    crosses_pods: bool                  # True = pipeline split across pods
    result: object                      # ScalingResult for inspection
    plan: object = None                 # the api.Plan (estimate/simulate)


def _stage_flops_bytes(cfg: ModelConfig, tokens: int):
    """(flops, param_bytes, act_bytes) per microbatch for one period group."""
    total, active = cfg.param_count()
    per_layer_active = active / max(cfg.n_layers, 1)
    layers_per_stage = len(cfg.period)
    flops = 2 * per_layer_active * layers_per_stage * tokens
    bytes_params = per_layer_active * layers_per_stage * 2          # bf16
    bytes_acts = tokens * cfg.d_model * 2
    return flops, bytes_params, bytes_acts


def build_stage_topology(cfg: ModelConfig, microbatch: int, seq: int,
                         train: bool = True):
    """Declare the layer stack as a planning-only streaming Topology
    (stages have profiled specs but no runtime kernels)."""
    from repro_torch.streaming.api import Topology

    tokens = microbatch * seq
    mult = 3.0 if train else 1.0        # fwd+bwd
    act_bytes = tokens * cfg.d_model * 2
    peak = TPU_V5E_PEAK_FLOPS * MXU_EFFICIENCY

    embed_flops = 2 * cfg.vocab * cfg.d_model * 0 + tokens * cfg.d_model * 2
    # host feed: rate-limited stand-in (1e6 microbatches/s >> any stage),
    # NOT free — a 0-cost spout would saturate the model's bandwidth budget
    topo = (Topology(f"stages[{cfg.name}]")
            .spout("feed", exec_ns=1e3, tuple_bytes=tokens * 4)
            .op("embed", exec_ns=mult * embed_flops / peak * 1e9,
                tuple_bytes=tokens * 4, mem_bytes=act_bytes))
    for i in range(cfg.n_periods):
        flops, pbytes, abytes = _stage_flops_bytes(cfg, tokens)
        topo.op(f"stage{i}", exec_ns=mult * flops / peak * 1e9,
                tuple_bytes=abytes, mem_bytes=pbytes + abytes)
    head_flops = mult * 2 * cfg.vocab * cfg.d_model * tokens
    topo.op("head", exec_ns=head_flops / peak * 1e9,
            tuple_bytes=act_bytes, mem_bytes=act_bytes)
    return topo


def build_stage_graph(cfg: ModelConfig, microbatch: int, seq: int,
                      train: bool = True) -> LogicalGraph:
    return build_stage_topology(cfg, microbatch, seq, train).build_logical()


def plan_stages(cfg: ModelConfig, n_pods: int = 2, chips_per_pod: int = 256,
                microbatch: int = 16, seq: int = 4096,
                compress_ratio: int = 16, train: bool = True) -> StagePlan:
    from repro_torch.streaming.api import Job

    machine = tpu_pod_spec(n_pods=n_pods, chips_per_pod=chips_per_pod)
    plan = Job(build_stage_topology(cfg, microbatch, seq, train)).plan(
        machine, optimizer="rlas", compress_ratio=compress_ratio,
        bestfit=True, max_nodes=20_000, max_iters=400,
        bottleneck_rule="reverse_topo", max_threads=machine.total_cores)
    res = plan.result
    # majority pod per stage (replicas may be spread for DP across pods)
    votes: Dict[str, Dict[int, int]] = {}
    if plan.eval is not None:
        for idx, unit in enumerate(plan.graph.replicas):
            s = plan.placement[idx]
            if s >= 0:
                votes.setdefault(unit.op, {})
                votes[unit.op][int(s)] = votes[unit.op].get(int(s), 0) \
                    + unit.group
    assignment = {op: max(v, key=v.get) for op, v in votes.items()}
    # PP cut = adjacent stages whose majority pods differ
    stage_pods = {v for k, v in assignment.items() if k.startswith("stage")}
    return StagePlan(
        assignment=assignment,
        parallelism=dict(res.parallelism),
        dp_degree=min(res.parallelism.values()) if res.parallelism else 1,
        throughput=res.R,
        crosses_pods=len(stage_pods) > 1,
        result=res, plan=plan)
