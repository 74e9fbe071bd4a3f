"""Training over ``torch.distributed`` against one process, on the CPU.

Two gloo processes (``torch.multiprocessing.spawn``, ``init_method`` a file
under the test's temporary directory, one thread each) train SMOKE configs
through ``launch.train.train`` on a ``(2, 1)`` mesh; the oracle is the
port's one-process run on the same weights (every rank draws them from the
seed) and the same global batches (every rank draws them and the step
takes its rows). The reference's own ``train()`` cannot be the oracle here
(it refuses its mesh on the installed JAX). Checked: data parallelism,
ZeRO-3 (``force_fsdp``: slices at rest, AdamW moments included), Qwen3-MoE
(against one process with ``moe_dispatch_groups`` doubled: capacity is
computed from a rank's tokens, so the runs agree when each rank holds
whole dispatch groups), a masked batch whose ranks hold unequal token
counts, ``partitioning.constrain`` on a DTensor, and a ZeRO-3 checkpoint
saved at world size 2 and resumed at 1. One spawn runs every job; each
test reads its results.
"""
import dataclasses
import importlib
import math
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import train
from repro_torch.layout import whole_shape
from repro_torch.models import model_api
from repro_torch.models import partitioning as part
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.optim.optimizers import adamw, warmup_cosine

STEPS, BATCH, SEQ, LR = 4, 8, 16, 3e-4
# losses and grad norms: float32 sums in another order
REL = 1e-4
# params after the last step: AdamW moves most weights by about lr a step,
# so a wrong or missing last update (which no loss sees) is 4x this; float32
# sums in another order leave 3.6e-6 here (Qwen3-MoE SMOKE) and 3.65e-5 on
# the card at full width (chip_smoke.py phase 32)
PARAM_TOL = LR / 4


def _train(arch, shape=None, over=None, steps=STEPS, **kw):
    return train(arch, steps=steps, batch=BATCH, seq=SEQ, lr=LR,
                 device="cpu", mesh_shape=shape, overrides=over,
                 log_every=steps, **kw)


def _run_train(arch, shape, over=None, **kw):
    """A mesh run's losses, grad norms, whole params (gathered) and, for
    each leaf, its elements at rest: (sharded, local, mu, nu, whole)."""
    r = _train(arch, shape, over, **kw)
    at_rest = []
    tree_map(lambda t, pl, mu, nu: at_rest.append((
        any(p.is_shard() for p in pl), t.numel(), mu.numel(), nu.numel(),
        math.prod(whole_shape(t.shape, pl, r["mesh"])))),
        r["params"], r["shardings"], r["opt_state"]["mu"],
        r["opt_state"]["nu"])
    return {"losses": r["losses"], "grad_norms": r["grad_norms"],
            "params": SH.gather_tree(r["params"], r["shardings"], r["mesh"]),
            "at_rest": at_rest}


def _masked_batch(cfg, seed=3):
    """A global batch whose first half of rows (rank 0's at world size 2)
    keeps 3 tokens a row and the second half all of them."""
    src = SyntheticLM(BATCH, SEQ, cfg.vocab, seed=seed)
    b = src.next_batch()
    mask = np.ones((BATCH, SEQ), np.float32)
    mask[:BATCH // 2, 3:] = 0.0
    b["mask"] = mask
    return b


def _steps(arch="smollm_360m", mesh=None, over=None, masked=True, n=2):
    """``n`` steps of ``make_train_step`` on SMOKE weights from seed 1 and
    batches of :func:`_masked_batch` (with or without the mask); the
    metrics of each step and the params after the last."""
    cfg = dataclasses.replace(get(arch, smoke=True), **(over or {}))
    params = model_api(cfg).init(torch.Generator().manual_seed(1), cfg,
                                 device="cpu")
    opt = adamw(LR)
    state = opt.init(params)
    step = make_train_step(cfg, opt, device="cpu", mesh=mesh)
    keys = {"losses": "loss", "grad_norms": "grad_norm", "tokens": "tokens",
            "aux": "aux"}
    out = {k: [] for k in keys}
    for i in range(n):
        b = _masked_batch(cfg, seed=i)
        if not masked:
            del b["mask"]
        params, state, m = step(params, state, b)
        for k, key in keys.items():
            out[k].append(float(m[key]))
    out["params"] = params
    return out


def _dtensor():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = make_mesh((2, 1), ("data", "model"))
    x = distribute_tensor(torch.arange(16.).reshape(4, 4), mesh,
                          (Replicate(), Replicate()))
    with part.use_mesh(mesh):
        rows = part.constrain(x, "BATCH", None)
        cols = part.constrain(rows, None, "data")
        same = part.constrain(x, ("data", "data"), None)
    return {"rows": (rows.placements, rows.to_local()),
            "cols": (cols.placements, cols.to_local()),
            "refused": same is x,
            "want": (Shard(0), Replicate(), Shard(1))}


JOBS = {
    "dp": lambda d: _run_train("smollm_360m", (2, 1)),
    "zero3": lambda d: _run_train("smollm_360m", (2, 1),
                                  {"force_fsdp": True}),
    "moe": lambda d: _run_train("qwen3_moe_235b_a22b", (2, 1)),
    "masked": lambda d: _steps(mesh=make_mesh((2, 1), ("data", "model"))),
    "moe_steps": lambda d: _steps("qwen3_moe_235b_a22b", masked=False,
                                  mesh=make_mesh((2, 1), ("data", "model"))),
    "dtensor": lambda d: _dtensor(),
    "ckpt": lambda d: _run_train("smollm_360m", (2, 1), {"force_fsdp": True},
                                 ckpt_dir=f"{d}/ckpt", ckpt_every=2),
    "dp4": lambda d: _run_train("smollm_360m", (4, 1)),
    "puredp": lambda d: _run_train("smollm_360m", (2, 2), {"pure_dp": True}),
    "zero3_4": lambda d: _run_train("smollm_360m", (4, 1),
                                    {"force_fsdp": True}),
}


def _child(rank, world, tmp, jobs, module=__name__):
    torch.set_num_threads(1)
    # torch 2.13 calls all_gather_into_tensor / reduce_scatter_tensor
    # deprecated; the card's torch has no replacement yet
    warnings.simplefilter("ignore", FutureWarning)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                            rank=rank, world_size=world)
    try:
        table = importlib.import_module(module).JOBS
        out = {name: table[name](tmp) for name in jobs}
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _spawn(tmp, world, jobs, module=__name__):
    """Each rank's results of ``jobs``, names in the ``JOBS`` table of the
    test module ``module`` (this one by default)."""
    mp.spawn(_child, args=(world, str(tmp), jobs, module), nprocs=world,
             join=True)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _close(got, want, rel=REL):
    return all(abs(g - w) <= rel * abs(w) for g, w in zip(got, want)) \
        and len(got) == len(want)


def _params_close(got, want):
    worst = max(float((a - b).abs().max()) for a, b in
                zip(tree_leaves(got), tree_leaves(want)))
    assert worst <= PARAM_TOL, worst


def _same_run(rank_results, one):
    for r in rank_results:       # every rank reports the global metrics
        assert _close(r["losses"], one["losses"]), (r["losses"], one["losses"])
        assert _close(r["grad_norms"], one["grad_norms"])
        _params_close(r["params"], one["params"])


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world2")
    return tmp, _spawn(tmp, 2, ["dp", "zero3", "moe", "moe_steps", "masked",
                                "dtensor", "ckpt"])


@pytest.fixture(scope="module")
def one_smollm(tmp_path_factory):
    """One process, saving a checkpoint every 2 steps."""
    d = tmp_path_factory.mktemp("one") / "ckpt"
    return dict(_train("smollm_360m", ckpt_dir=str(d), ckpt_every=2),
                ckpt_dir=str(d))


def test_data_parallel_equals_one_process(world2, one_smollm):
    _same_run([r["dp"] for r in world2[1]], one_smollm)


def test_zero3_equals_one_process(world2, one_smollm):
    _same_run([r["zero3"] for r in world2[1]], one_smollm)


def test_zero3_holds_slices_at_rest(world2):
    """Each leaf the rules shard over 'data' is held as half of the whole,
    and so are its AdamW moments; the norms stay whole."""
    for r in world2[1]:
        rest = r["zero3"]["at_rest"]
        assert sum(sharded for sharded, *_ in rest) >= 5
        for sharded, local, mu, nu, whole in rest:
            assert local == mu == nu == (whole // 2 if sharded else whole)


def test_moe_equals_one_process_with_doubled_groups(world2):
    """Qwen3-MoE SMOKE: each rank routes its 4 rows as one dispatch group;
    one process with 2 groups routes the same tokens with the same
    capacity, and the aux loss's token fractions are global in both."""
    one = _train("qwen3_moe_235b_a22b", over={"moe_dispatch_groups": 2})
    _same_run([r["moe"] for r in world2[1]], one)
    # the aux loss alone (a thousandth of the loss at this size)
    one = _steps("qwen3_moe_235b_a22b", over={"moe_dispatch_groups": 2},
                 masked=False)
    for r in world2[1]:
        got = r["moe_steps"]
        assert _close(got["aux"], one["aux"]), (got["aux"], one["aux"])
        assert _close(got["losses"], one["losses"])
        _params_close(got["params"], one["params"])


def test_unequal_token_counts_equal_one_process(world2):
    """Rank 0 holds 12 live tokens, rank 1 64: each rank's loss is weighted
    by its share of the 76, not by one half."""
    one = _steps()
    assert one["tokens"] == [76.0, 76.0]
    for r in world2[1]:
        got = r["masked"]
        assert got["tokens"] == one["tokens"]
        assert _close(got["losses"], one["losses"])
        assert _close(got["grad_norms"], one["grad_norms"])
        _params_close(got["params"], one["params"])


def test_constrain_redistributes_a_dtensor(world2):
    for rank, r in enumerate(world2[1]):
        d = r["dtensor"]
        whole = torch.arange(16.).reshape(4, 4)
        placements, local = d["rows"]
        assert tuple(placements) == d["want"][:1] + d["want"][1:2]
        assert torch.equal(local, whole[2 * rank:2 * rank + 2])
        placements, local = d["cols"]
        assert tuple(placements) == (d["want"][2], d["want"][1])
        assert torch.equal(local, whole[:, 2 * rank:2 * rank + 2])
        assert d["refused"]


def test_zero3_checkpoint_at_two_ranks_resumes_at_one(world2, one_smollm):
    """Two ZeRO-3 ranks trained 4 steps with a checkpoint every 2; rank 0
    saved whole tensors. One process restores step 2 into its unsharded
    tree: params and AdamW state equal those one process saved at step 2,
    and continuing on batches 2 and 3 gives the uninterrupted run's losses
    and params. ``train`` resumes from the two ranks' step 4."""
    tmp, ranks = world2
    d = str(tmp / "ckpt")
    assert ckpt.latest_step(d) == 4
    for r in ranks:
        _same_run([r["ckpt"]], one_smollm)
    cfg = one_smollm["cfg"]
    params = model_api(cfg).init(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    opt = adamw(warmup_cosine(LR, warmup=max(STEPS // 10, 1), total=STEPS))
    target = (params, opt.init(params))
    (params, state), _ = ckpt.restore(d, 2, target)
    (p_one, s_one), _ = ckpt.restore(one_smollm["ckpt_dir"], 2, target)
    assert int(state["step"]) == 2
    for got, want in ((params, p_one), (state["mu"], s_one["mu"]),
                      (state["nu"], s_one["nu"])):
        _params_close(got, want)
    src = SyntheticLM(BATCH, SEQ, cfg.vocab, seed=0)
    batches = [src.next_batch() for _ in range(STEPS)]
    step = make_train_step(cfg, opt, device="cpu")
    losses = [float(step(params, state, b)[2]["loss"]) for b in batches[2:]]
    assert _close(losses, one_smollm["losses"][2:])
    _params_close(params, one_smollm["params"])
    again = _train("smollm_360m", steps=STEPS + 2, ckpt_dir=d)
    assert again["start_step"] == STEPS and len(again["losses"]) == 2


@pytest.mark.parametrize("arch", ["smollm_360m", "deepseek_v3_671b",
                                  "qwen3_moe_235b_a22b", "whisper_small",
                                  "llava_next_mistral_7b"])
def test_one_rank_mesh_equals_no_mesh_bit_for_bit(arch, tmp_path):
    """In a process group of one rank the (1, 1) mesh's data-parallel and
    ZeRO-3 steps give the no-mesh run's losses, grad norms and params bit
    for bit (the token share is exactly 1, the collectives copy, the clip's
    partial sums keep their order): what ``chip_smoke.py`` phase 31 holds
    on the card over NCCL. DeepSeek SMOKE runs its MTP module, Qwen3-MoE its
    aux loss, whisper the encoder-decoder, llava the vlm frontend (under
    ZeRO-3 on the embedding gathered whole)."""
    want = _train(arch, steps=2)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        for over in ({}, {"force_fsdp": True}):
            got = _train(arch, over=over, steps=2)
            assert got["mesh"] is not None
            assert got["losses"] == want["losses"]
            assert got["grad_norms"] == want["grad_norms"]
            for a, b in zip(tree_leaves(got["params"]),
                            tree_leaves(want["params"])):
                assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


class _NoHostReads(TorchDispatchMode):
    """Raises where a tensor's value is read on the host, which a CUDA
    graph would freeze (as ``test_torch_graphs.NoHostReads``)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten._local_scalar_dense.default,
                    torch.ops.aten.nonzero.default):
            raise AssertionError(f"host read of a tensor value: {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["smollm_360m", "qwen3_moe_235b_a22b"])
def test_mesh_step_makes_no_host_read(arch, tmp_path):
    """The mesh step, data-parallel and ZeRO-3 (Qwen3-MoE: the token
    fractions' all-reduce), reads no tensor value on the host, so the card
    can capture it, collectives included, in one CUDA graph."""
    cfg = get(arch, smoke=True)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        for fsdp in (False, True):
            params = model_api(cfg).init(torch.Generator().manual_seed(0),
                                         cfg, device="cpu")
            shardings = SH.param_shardings(cfg, params, mesh, fsdp)
            params = SH.shard_tree(params, shardings, mesh)
            opt = adamw(LR)
            state = opt.init(params)
            step = make_train_step(cfg, opt, device="cpu", mesh=mesh,
                                   shardings=shardings)
            batch = {k: torch.as_tensor(v) for k, v in
                     _masked_batch(cfg).items()}
            with _NoHostReads():
                params, state, m = step(params, state, batch)
            assert torch.isfinite(m["loss"]) and int(state["step"]) == 1
    finally:
        dist.destroy_process_group()
