"""Training with the tokens over 'model' against the JAX reference, on the CPU.

One ``mp.spawn`` of 8 gloo ranks (:mod:`test_torch_dist`'s ``_spawn``)
runs every job of this file; the oracles run in the parent. The config is
h2o-danube SMOKE with ``pure_dp`` and ``seq_shard`` (h2o-danube-1.8b+seqp's
fields at SMOKE size; window 16), the batch 4 x 64 tokens with a mask:

* ``make_train_step`` at (1, 8) (rows whole, L 8, r 2) and at (2, 4) (rows
  over 'data', L 16, r 1), 3 steps from the reference's weights, against
  the reference's own jitted ``make_train_step`` on the whole batch with
  no mesh: on every rank the loss and grad norm of each step, and the
  params after it;
* the same at (2, 4) with ZeRO-3 over 'data' (the rules' 'data' dims of
  the config without ``pure_dp``, nothing over 'model': under ``pure_dp``
  the reference's rules, and so ``force_fsdp``, leave every param whole);
* ``launch.train.train(mesh_shape=(2, 4))``, 4 steps with a checkpoint
  every 2, against the port's one-process ``train()``; then a resume at
  step 2 of 4 (step 4's checkpoint removed) that equals the 4 straight
  steps;
* 8 rows at (2, 4), where the reference's input spec puts 'model' on the
  rows and on the tokens: the step raises ValueError on every rank.
"""
import dataclasses
import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get
from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import train
from repro_torch.layout import axis_names
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.optim.optimizers import adamw, warmup_cosine
from test_torch_dist import _spawn

WORLD = 8
ARCH = "h2o_danube_1_8b"
OVER = {"pure_dp": True, "seq_shard": True}
BATCH, SEQ, STEPS, LR = 4, 64, 3, 3e-4
SCHED = dict(base_lr=LR, warmup=1, total=STEPS)
# losses and grad norms: float32 sums in another order
REL = 1e-5
# params after each step against the reference: AdamW's first steps move a
# weight by about lr times the sign of its gradient, which summation order
# can flip where the gradient is near zero
REF_PARAM_TOL = 2 * LR + 1e-6
# params against the port's one-process train(): a missing last update
# moves most weights by about lr
PARAM_TOL = LR / 4
TRAIN_STEPS = 4


def _cfg():
    return dataclasses.replace(get(ARCH, smoke=True), **OVER)


def _batches():
    """STEPS global batches of BATCH x SEQ tokens, each with a mask that
    drops about a fifth of the tokens (so the ranks' counts differ)."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, _cfg().vocab, (BATCH, SEQ + 1), np.int32)
        mask = (rng.random((BATCH, SEQ)) > 0.2).astype(np.float32)
        out.append({"inputs": toks[:, :-1], "labels": toks[:, 1:],
                    "mask": mask})
    return out


def _zero3_over_data(cfg, params, mesh):
    """ZeRO-3 placements over 'data' alone: the rules' 'data' dims of
    ``cfg`` without ``pure_dp``, 'model' replicated."""
    from torch.distributed.tensor import Replicate
    m = axis_names(mesh).index("model")
    rules = SH.param_shardings(dataclasses.replace(cfg, pure_dp=False),
                               params, mesh, True)
    return tree_map(lambda _, pl: pl[:m] + (Replicate(),) + pl[m + 1:],
                    params, rules)


def _step_job(tmp, shape, zero3=False):
    """STEPS steps of ``make_train_step`` at ``shape`` on the reference's
    weights: each step's loss, grad norm and whole params."""
    cfg = _cfg()
    params = torch.load(f"{tmp}/params.pt", weights_only=False)
    mesh = make_mesh(shape, ("data", "model"))
    shards = _zero3_over_data(cfg, params, mesh) if zero3 else None
    if zero3:
        params = SH.shard_tree(params, shards, mesh)
    opt = adamw(warmup_cosine(**SCHED))
    state = opt.init(params)
    step = make_train_step(cfg, opt, device="cpu", mesh=mesh,
                           shardings=shards)
    out = {"losses": [], "grad_norms": [], "tokens": [], "params": [],
           "sharded": 0}
    for b in _batches():
        params, state, m = step(params, state, b)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        out["tokens"].append(float(m["tokens"]))
        whole = params if shards is None else SH.gather_tree(params, shards,
                                                             mesh)
        out["params"].append(tree_map(lambda a: a.detach().clone(), whole))
    if zero3:
        out["sharded"] = sum(tree_leaves(tree_map(
            lambda _, pl: int(any(p.is_shard() for p in pl)), params,
            shards)))
    return out


def _train(shape=None, **kw):
    return train(ARCH, steps=TRAIN_STEPS, batch=BATCH, seq=SEQ, lr=LR,
                 device="cpu", mesh_shape=shape, overrides=OVER,
                 log_every=TRAIN_STEPS, **kw)


def _train_job(tmp):
    """``train()`` at (2, 4), 4 steps with a checkpoint every 2, then a
    resume at step 2 of 4 with step 4's checkpoint removed."""
    ckpt_dir = f"{tmp}/ckpt"
    out = {}
    for label in ("straight", "resumed"):
        r = _train((2, 4), ckpt_dir=ckpt_dir, ckpt_every=2)
        out[label] = {"losses": r["losses"], "grad_norms": r["grad_norms"],
                      "start_step": r["start_step"], "params": r["params"]}
        if label == "straight":
            if dist.get_rank() == 0:
                shutil.rmtree(f"{ckpt_dir}/step_{TRAIN_STEPS:08d}")
            dist.barrier()
    return out


def _duplicate_job():
    """8 rows at (2, 4): the step's refusal, on a real mesh."""
    cfg = _cfg()
    step = make_train_step(cfg, adamw(LR), device="cpu",
                           mesh=make_mesh((2, 4), ("data", "model")))
    toks = np.zeros((8, SEQ), np.int32)
    try:
        step({"embed": torch.zeros(1)}, {}, {"inputs": toks, "labels": toks})
    except ValueError as e:
        return str(e)
    return None


JOBS = {"step18": lambda d: _step_job(d, (1, 8)),
        "step24": lambda d: _step_job(d, (2, 4)),
        "zero3": lambda d: _step_job(d, (2, 4), zero3=True),
        "train": _train_job,
        "duplicate": lambda d: _duplicate_job()}


def _reference(tmp):
    """The reference's SMOKE weights (seed 2), transplanted and written for
    the ranks, and its jitted ``make_train_step`` on the whole batches with
    no mesh: each step's loss, grad norm and params."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get as jget
    from repro.launch.steps import make_train_step as jmake_train_step
    from repro.models import model_api as jmodel_api
    from repro.optim import optimizers as jopt
    from repro_torch.weights import from_jax_params

    jcfg = dataclasses.replace(jget(ARCH, smoke=True), **OVER)
    jparams = jmodel_api(jcfg).init(jax.random.PRNGKey(2), jcfg)
    torch.save(from_jax_params(jax.tree.map(np.asarray, jparams), _cfg(),
                               device="cpu"), f"{tmp}/params.pt")
    jo = jopt.adamw(jopt.warmup_cosine(**SCHED))
    jstate = jo.init(jparams)
    jstep = jax.jit(jmake_train_step(jcfg, jo))
    out = {"losses": [], "grad_norms": [], "tokens": [], "params": []}
    for b in _batches():
        jparams, jstate, m = jstep(jparams, jstate,
                                   jax.tree.map(jnp.asarray, b))
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        out["tokens"].append(float(m["tokens"]))
        out["params"].append(jax.tree.map(np.asarray, jparams))
    return out


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cptrain8")
    ref = _reference(tmp)
    return _spawn(tmp, WORLD, list(JOBS), module=__name__), ref


@pytest.fixture(scope="module")
def one_process():
    """The port's ``train()`` in one process, no mesh."""
    r = _train()
    return {"losses": r["losses"], "grad_norms": r["grad_norms"],
            "params": r["params"]}


def _rel_close(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert abs(g - w) <= REL * abs(w), f"{what} step {i}: {g} vs {w}"


def _max_param_err(got, want) -> float:
    """The largest |got - want| over the leaves of a port tree ``got``;
    ``want`` a port tree, or a reference tree (numpy), matched by path."""
    if isinstance(want, dict) and all(
            isinstance(w, torch.Tensor) for w in tree_leaves(want)):
        pairs = list(zip(tree_leaves(got), tree_leaves(want)))
    else:
        import jax
        pairs = []
        for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
            g = got
            for k in path:
                g = g[k.key if hasattr(k, "key") else k.idx]
            pairs.append((g, torch.from_numpy(np.array(w))))
        assert len(pairs) == len(tree_leaves(got))
    assert all(g.shape == w.shape for g, w in pairs)
    return max(float((g - w).abs().max()) for g, w in pairs)


@pytest.mark.parametrize("job", ["step18", "step24", "zero3"])
def test_train_steps_match_the_reference(world8, job):
    """Each rank's 3 steps against the reference's jitted step on the whole
    batch: loss, grad norm and token count to 1e-5 relative, the params
    after each step to 2 lr + 1e-6. The ZeRO-3 run holds leaves sharded
    over 'data'."""
    ranks, ref = world8
    for rank, r in enumerate(ranks):
        got = r[job]
        _rel_close(got["losses"], ref["losses"], f"{job} rank {rank} loss")
        _rel_close(got["grad_norms"], ref["grad_norms"],
                   f"{job} rank {rank} grad norm")
        assert got["tokens"] == ref["tokens"]
        for i, (p, w) in enumerate(zip(got["params"], ref["params"])):
            err = _max_param_err(p, w)
            assert err <= REF_PARAM_TOL, (job, rank, i, err)
    assert (ranks[0][job]["sharded"] > 0) == (job == "zero3")


def test_train_over_a_mesh_equals_one_process(world8, one_process):
    """``train(mesh_shape=(2, 4))`` with the tokens over 'model': every
    rank's losses and grad norms to 1e-5 relative of the port's one-process
    ``train()``, and the params after the last step to lr / 4."""
    for rank, r in enumerate(world8[0]):
        got = r["train"]["straight"]
        assert got["start_step"] == 0
        _rel_close(got["losses"], one_process["losses"], f"rank {rank} loss")
        _rel_close(got["grad_norms"], one_process["grad_norms"],
                   f"rank {rank} grad norm")
        assert _max_param_err(got["params"], one_process["params"]) \
            <= PARAM_TOL


def test_resume_under_the_token_split_equals_straight_steps(world8):
    """Resumed at step 2 of 4 (the straight run's checkpoint, written whole
    by rank 0), every rank runs steps 2 and 3 with the straight run's
    losses, grad norms and final params, bit for bit."""
    for r in world8[0]:
        straight, resumed = r["train"]["straight"], r["train"]["resumed"]
        assert resumed["start_step"] == 2
        assert resumed["losses"] == straight["losses"][2:]
        assert resumed["grad_norms"] == straight["grad_norms"][2:]
        for a, b in zip(tree_leaves(resumed["params"]),
                        tree_leaves(straight["params"])):
            assert torch.equal(a, b)


def test_model_twice_in_the_batch_spec_raises_on_every_rank(world8):
    """8 rows at (2, 4): ``pure_dp``'s rows take every axis and the tokens
    'model'; each rank's step raises ValueError before any collective."""
    for r in world8[0]:
        assert r["duplicate"] is not None and "used twice" in r["duplicate"]


def test_prefetcher_state_is_the_last_batch_taken():
    """The state a checkpoint saves is the source's after the last batch
    taken, not after the batches the thread has drawn ahead: a source
    restored from it draws the batch the prefetcher hands out next."""
    import time

    from repro_torch.data.pipeline import Prefetcher, SyntheticLM

    src = SyntheticLM(2, 8, 64, seed=3)
    data = Prefetcher(src)
    try:
        assert data.state()["step"] == 0
        taken = [data.next_batch() for _ in range(2)]
        deadline = time.monotonic() + 10
        while not data.q.full() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert src.state()["step"] > 2          # the thread ran ahead
        assert data.state()["step"] == 2
        again = SyntheticLM(2, 8, 64, seed=3)
        again.restore(data.state())
        want, got = again.next_batch(), data.next_batch()
        assert all(np.array_equal(got[k], want[k]) for k in want)
        assert not np.array_equal(taken[1]["inputs"], got["inputs"])
    finally:
        data.close()
