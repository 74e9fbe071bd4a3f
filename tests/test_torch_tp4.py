"""Tensor parallelism over four gloo processes against one process, on the
CPU, and that every family makes its tensor-parallel step.

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
xLSTM SMOKE (mLSTM over 32 of its 128 d_inner rows a rank, its 2 heads
whole on every rank; sLSTM's [i | f | z | o] columns a quarter a rank),
whisper SMOKE (one of its 4 heads a rank, in the encoder, the decoder and
cross attention) and llava SMOKE (its 2 kv heads on every rank; the text
lookup through the vocab split) train at (1, 4) and at (2, 2) with ZeRO-3
over 'data'; ``mlstm_apply``, ``slstm_apply`` and cross attention at (1, 4)
equal the whole layer, cross attention with 2 heads on every rank too; and
llava's text lookup at (2, 2) with ZeRO-3 (the rows' columns gathered over
'data') equals the whole table's rows.
"""
import dataclasses

import pytest

from repro_torch.configs import ARCHS, get
from repro_torch.launch.steps import make_train_step
from repro_torch.optim.optimizers import adamw
from test_torch_dist import _spawn
from test_torch_tp import (ARCHS as TP_ARCHS, BATCH, MIXERS, _mixer_paths,
                           _text_lookup, _train, _tp_run,
                           assert_design_collectives, assert_mixer_collectives,
                           assert_mixer_equal, assert_same_run,
                           assert_text_lookup)

JOBS = {"tp_dp": lambda d: _tp_run("danube", (2, 2)),
        "tp_zero3": lambda d: _tp_run("danube", (2, 2),
                                      more={"force_fsdp": True}),
        "tp4": lambda d: _tp_run("danube", (1, 4)),
        "deepseek_tp4": lambda d: _tp_run("deepseek", (1, 4)),
        "jamba_tp4": lambda d: _tp_run("jamba", (1, 4)),
        # each 'data' rank routes its 8 x 16 tokens as one dispatch group
        "jamba_tp_zero3": lambda d: _tp_run("jamba", (2, 2),
                                            more={"force_fsdp": True}),
        "mixers": lambda d: _mixer_paths((1, 4), list(MIXERS)),
        "lookup_zero3": lambda d: _text_lookup((2, 2), fsdp=True)}
# xLSTM, whisper and llava at (1, 4) and at (2, 2) with ZeRO-3 over 'data'
FAMILIES = ("xlstm", "whisper", "llava")
for _key in FAMILIES:
    JOBS[f"{_key}_tp4"] = lambda d, key=_key: _tp_run(key, (1, 4))
    JOBS[f"{_key}_tp_zero3"] = lambda d, key=_key: _tp_run(
        key, (2, 2), more={"force_fsdp": True})
# the one-process run each training job is held against: (ARCHS key,
# ``_train``'s keywords); at 2 'data' ranks, one process with the dispatch
# groups doubled (MoE capacity is counted over a rank's tokens)
ORACLE = {"tp_dp": ("danube", {}), "tp_zero3": ("danube", {}),
          "tp4": ("danube", {}), "deepseek_tp4": ("deepseek", {}),
          "jamba_tp4": ("jamba", {}),
          "jamba_tp_zero3": ("jamba", {"more": {"moe_dispatch_groups": 2}}),
          **{f"{key}_{job}": (key, {}) for key in FAMILIES
             for job in ("tp4", "tp_zero3")}}


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
    on every rank), ``mamba_apply`` and ``mlstm_apply`` (32 of 128 channels
    a rank), ``slstm_apply`` (64 of [i | f | z | o]'s 256 columns) and
    cross attention (one of 4 heads a rank; and with 2 heads, every head on
    every rank) at (1, 4) on each rank's slices: output and every gradient
    equal the whole layer's, with the collectives of the design."""
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


@pytest.mark.parametrize("job", [f"{key}_tp4" for key in FAMILIES])
def test_four_ranks_run_the_designs_collectives(world4, job):
    """xLSTM, whisper and llava at (1, 4) run the collectives over 'model'
    that ``tensor_parallel.collectives_per_step`` counts (llava's 2 kv heads
    on every rank: wq / wk / wv gathered)."""
    for r in world4:
        assert_design_collectives(r[job], job.split("_")[0])


def test_vlm_text_lookup_under_zero3(world4):
    """At (2, 2) with ZeRO-3 each rank holds a quarter of llava's
    embedding: the trainer looks the text rows up in its half of the vocab,
    sums them over 'model' and gathers their columns over 'data' (one
    all-reduce of half rows, one all-gather of whole ones), bit for bit the
    whole table's rows."""
    rows = BATCH * (TP_ARCHS["llava"][2] - 8) * 64 * 4
    for r in world4:
        assert_text_lookup(r["lookup_zero3"], (128, 32),
                           {"all_reduce": 1, "all_reduce_bytes": rows // 2,
                            "all_gather": 1, "all_gather_bytes": rows})


@pytest.mark.parametrize("arch", ARCHS)
def test_every_family_makes_its_tensor_parallel_step(arch):
    """Every arch of ``configs`` makes its tensor-parallel train step under
    a 'model' axis of 2 (no family raises); with ``pure_dp`` the same mesh
    makes a data-parallel one."""
    cfg = get(arch, smoke=True)
    mesh = {"data": 1, "model": 2}
    make_train_step(cfg, adamw(1e-3), device="cpu", mesh=mesh)
    make_train_step(dataclasses.replace(cfg, pure_dp=True), adamw(1e-3),
                    device="cpu", mesh=mesh)
