"""Elastic replanning (``launch/elastic.py``) against the reference's.

``replan`` and ``simulate_pod_failure`` give the reference's plans for
every architecture: the same stage assignment and DP degree, and the
estimated throughput to 1e-9 relative (both run RLAS on ``tpu_pod_spec``).
``reshard_checkpoint`` restores a checkpoint that two gloo ranks saved
(ZeRO-3, ``train(mesh_shape=(2, 1))``) at one process, whole, and at four
ranks, each its slices under the (4, 1) placements.
"""
import dataclasses

import pytest
import torch

from repro.configs import all_archs, get as jget
from repro.launch import elastic as jelastic
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get as tget
from repro_torch.launch import elastic
from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import train
from repro_torch.layout import local_shard
from repro_torch.models import model_api
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.optim.optimizers import adamw
from test_torch_dist import _spawn


def _same(got, want):
    assert got.n_pods == want.n_pods
    assert got.chips_per_pod == want.chips_per_pod
    assert got.stage_assignment == want.stage_assignment
    assert got.dp_degree == want.dp_degree
    assert abs(got.est_throughput - want.est_throughput) <= \
        1e-9 * abs(want.est_throughput)


@pytest.mark.parametrize("arch", all_archs())
def test_pod_failure_plans_equal_the_reference(arch):
    got = elastic.simulate_pod_failure(tget(arch), 2, 1)
    want = jelastic.simulate_pod_failure(jget(arch), 2, 1)
    for g, w in zip(got, want):
        _same(g, w)


def test_replan_at_other_sizes_equals_the_reference():
    _same(elastic.replan(tget("smollm_360m"), 4, chips_per_pod=64,
                         microbatch=8, seq=2048),
          jelastic.replan(jget("smollm_360m"), 4, chips_per_pod=64,
                          microbatch=8, seq=2048))


CFG = dataclasses.replace(tget("smollm_360m", smoke=True), force_fsdp=True)


def _target():
    params = model_api(CFG).init(torch.Generator().manual_seed(0), CFG,
                                 device="cpu")
    return params, adamw(1e-3).init(params)


def _save(d):
    train("smollm_360m", steps=2, batch=8, seq=16, device="cpu",
          mesh_shape=(2, 1), overrides={"force_fsdp": True}, ckpt_dir=f"{d}/ck",
          ckpt_every=2, log_every=2)
    return {}


def _restore4(d):
    mesh = make_mesh((4, 1), ("data", "model"))
    whole = _target()
    p_shards = SH.param_shardings(CFG, whole[0], mesh, True)
    shards = (p_shards, {"mu": p_shards, "nu": p_shards, "step": None})
    target = SH.shard_tree(whole, shards, mesh)
    got, extra = elastic.reshard_checkpoint(f"{d}/ck", 2, target, shards, mesh)
    full, _ = elastic.reshard_checkpoint(f"{d}/ck", 2, whole)
    want = tree_map(lambda t, pl: t if pl is None else local_shard(t, pl, mesh),
                    full, shards)
    return {"got": tree_leaves(got), "want": tree_leaves(want),
            "sliced": sum(a.numel() < b.numel() for a, b in
                          zip(tree_leaves(got), tree_leaves(full)))}


JOBS = {"save": _save, "restore4": _restore4}


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic")
    _spawn(d, 2, ["save"], module=__name__)
    return d


def test_two_rank_checkpoint_restores_at_one(saved):
    assert ckpt.latest_step(f"{saved}/ck") == 2
    whole = _target()
    (params, state), extra = elastic.reshard_checkpoint(f"{saved}/ck", 2, whole)
    assert int(state["step"]) == 2
    for got, init in zip(tree_leaves(params), tree_leaves(whole[0])):
        assert got.shape == init.shape and got.dtype == init.dtype
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_leaves(params), tree_leaves(whole[0])))


def test_two_rank_checkpoint_restores_at_four(saved):
    ranks = _spawn(saved, 4, ["restore4"], module=__name__)
    for r in ranks:
        assert r["restore4"]["sliced"] >= 5
        for got, want in zip(r["restore4"]["got"], r["restore4"]["want"]):
            assert torch.equal(got, want)
