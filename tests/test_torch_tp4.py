"""Tensor parallelism over four gloo processes against one process, on the
CPU, and the families it does not split yet.

One ``mp.spawn`` of 4 ranks (:mod:`test_torch_dist`'s helpers) trains
h2o-danube SMOKE through ``launch.train.train``: at (2, 2), tensor
parallelism over 'model' beside data parallelism over 'data', with and
without ``force_fsdp`` (ZeRO-3 over 'data' too: a leaf split over both axes
is a quarter at rest); and at (1, 4), where its 2 kv heads do not split
over 4 ranks and every rank runs every head. DeepSeek-V3 SMOKE (MLA, one
head a rank, its dense prefix, MoE and MTP) and Jamba SMOKE (Mamba over
d_inner, ranks 0-1 holding in_proj's x columns and 2-3 its z columns; its
2 kv heads on every rank) train at (1, 4), and Jamba at (2, 2) with
ZeRO-3 over 'data'. The oracle is the one-process run on the same weights
and batches. ``mla_apply`` and ``mamba_apply`` at (1, 4) on each rank's
slices equal the whole layer, with the design's collectives, and MLA with
2 heads, which 4 ranks do not divide, runs every head on every rank.
"""
import dataclasses

import pytest

from repro_torch.configs import get
from repro_torch.launch.steps import make_train_step
from repro_torch.optim.optimizers import adamw
from test_torch_dist import _spawn
from test_torch_tp import (MIXERS, _mixer_paths, _train, _tp_run,
                           assert_mixer_collectives, assert_mixer_equal,
                           assert_same_run)

JOBS = {"tp_dp": lambda d: _tp_run("danube", (2, 2)),
        "tp_zero3": lambda d: _tp_run("danube", (2, 2),
                                      more={"force_fsdp": True}),
        "tp4": lambda d: _tp_run("danube", (1, 4)),
        "deepseek_tp4": lambda d: _tp_run("deepseek", (1, 4)),
        "jamba_tp4": lambda d: _tp_run("jamba", (1, 4)),
        # each 'data' rank routes its 8 x 16 tokens as one dispatch group
        "jamba_tp_zero3": lambda d: _tp_run("jamba", (2, 2),
                                            more={"force_fsdp": True}),
        "mixers": lambda d: _mixer_paths((1, 4), list(MIXERS))}
# the one-process run each training job is held against: (ARCHS key,
# ``_train``'s keywords); at 2 'data' ranks, one process with the dispatch
# groups doubled (MoE capacity is counted over a rank's tokens)
ORACLE = {"tp_dp": ("danube", {}), "tp_zero3": ("danube", {}),
          "tp4": ("danube", {}), "deepseek_tp4": ("deepseek", {}),
          "jamba_tp4": ("jamba", {}),
          "jamba_tp_zero3": ("jamba", {"more": {"moe_dispatch_groups": 2}})}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("tp4"), 4, list(JOBS),
                  module=__name__)


@pytest.fixture(scope="module")
def one():
    runs = {}
    for key, kw in ORACLE.values():
        if (key, str(kw)) not in runs:
            runs[key, str(kw)] = _train(key, **kw)
    return {job: runs[key, str(kw)] for job, (key, kw) in ORACLE.items()}


@pytest.mark.parametrize("job", list(ORACLE))
def test_four_ranks_equal_one_process(world4, one, job):
    assert_same_run([r[job] for r in world4], one[job])


@pytest.mark.parametrize("key", list(MIXERS))
def test_mixer_at_four_ranks_equals_the_whole_layer(world4, key):
    """``mla_apply`` (one of 4 heads a rank; and with 2 heads, every head
    on every rank) and ``mamba_apply`` (32 of 128 channels a rank) at (1,
    4) on each rank's slices: output and every gradient equal the whole
    layer's, with the collectives of the design."""
    for r in world4:
        assert_mixer_equal(r["mixers"][key])
        assert_mixer_collectives(r["mixers"][key], key)


def test_zero3_and_tensor_parallel_hold_quarters_at_rest(world4):
    """At (2, 2) with ``force_fsdp`` a matrix split over 'model' by one dim
    and over 'data' by the other is a quarter of the whole at rest, and so
    are its AdamW moments; without ``force_fsdp`` it is a half."""
    for r in world4:
        for job, parts in (("tp_zero3", 4), ("tp_dp", 2)):
            quarters = 0
            for pl, t, mu, nu in r[job]["at_rest"]:
                split = sum(p.is_shard() for p in pl)
                assert t.shape == mu.shape == nu.shape
                if split == 2:
                    quarters += 1
                    assert parts == 4
            assert quarters >= (7 if parts == 4 else 0)


@pytest.mark.parametrize("arch", ["xlstm_125m", "whisper_small",
                                  "llava_next_mistral_7b"])
def test_families_not_split_yet_raise(arch):
    """mLSTM / sLSTM, the encoder-decoder and the vlm under a 'model' axis
    of 2 without ``pure_dp`` raise, naming item 6e2b; with ``pure_dp`` the
    same mesh makes a step."""
    cfg = get(arch, smoke=True)
    mesh = {"data": 1, "model": 2}
    with pytest.raises(NotImplementedError, match="item 6e2b"):
        make_train_step(cfg, adamw(1e-3), device="cpu", mesh=mesh)
    make_train_step(dataclasses.replace(cfg, pure_dp=True), adamw(1e-3),
                    device="cpu", mesh=mesh)
