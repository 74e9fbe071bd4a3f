"""Tensor parallelism over 'model' against one process, on the CPU.

Two gloo processes (one ``mp.spawn`` running every job of this file, as
:mod:`test_torch_dist`'s) train SMOKE configs through
``launch.train.train(mesh_shape=(1, 2))``: Megatron column / row splits of
attention and the SwiGLU, the vocab-parallel embedding and cross-entropy,
and Qwen3-MoE's experts over 'model'. The oracle is the port's one-process
run on the same weights (every rank draws them from the seed) and batches:

* smollm SMOKE: 3 / 1 heads do not split over 2 ranks, so every rank runs
  every head (the replicated attention); its vocab of 256 splits;
* h2o-danube SMOKE: 4 / 2 heads, each rank its 2 / 1 (head-aligned), with
  the window of 16 inside 32 positions;
* stablelm SMOKE: an untied head (vocab columns over 'model'), MHA;
* granite SMOKE with a vocab of 255, which 'model' does not divide: the
  embedding stays whole, and the lookup and the loss run replicated;
* Qwen3-MoE SMOKE: 8 experts, 4 a rank.

Also each rank's params and AdamW moments at rest against the rules'
slices of the one-process run's, the first step at rank 0 against the
reference's step (jitted, no mesh) on the same weights, both attention
paths by name, and a (1, 2) checkpoint resumed by one process and at
(2, 1).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import train
from repro_torch.layout import local_shard
from repro_torch.models import layers as tlayers
from repro_torch.models import model_api
from repro_torch.models import partitioning as part
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.optim.optimizers import Optimizer, adamw, warmup_cosine
from test_torch_dist import PARAM_TOL, _params_close, _spawn

STEPS, BATCH, LR = 4, 8, 3e-4
# losses and grad norms against one process: float32 sums in another order
# (2e-7 relative in the runs here)
REL = 1e-5
ARCHS = {"smollm": ("smollm_360m", {}, 16),
         "danube": ("h2o_danube_1_8b", {}, 32),
         "stablelm": ("stablelm_3b", {}, 16),
         "granite": ("granite_3_2b", {"vocab": 255}, 16),
         "qwen3": ("qwen3_moe_235b_a22b", {}, 16)}
# the reference's first step: a batch of REF_BATCH rows
REF_BATCH = 4


def _train(key, shape=None, steps=STEPS, more=None, **kw):
    """``train`` of ``ARCHS[key]``, its overrides updated by ``more``."""
    arch, over, seq = ARCHS[key]
    return train(arch, steps=steps, batch=BATCH, seq=seq, lr=LR, device="cpu",
                 mesh_shape=shape, overrides={**over, **(more or {})} or None,
                 log_every=steps, **kw)


def _tp_run(key, shape=(1, 2), **kw):
    """A mesh run's losses, grad norms, whole params (gathered), and at
    rest each leaf's placements with its slice and AdamW moments, and this
    rank's mesh coordinate."""
    r = _train(key, shape, **kw)
    rest = []
    tree_map(lambda t, pl, mu, nu: rest.append((tuple(pl), t, mu, nu)),
             r["params"], r["shardings"], r["opt_state"]["mu"],
             r["opt_state"]["nu"])
    return {"losses": r["losses"], "grad_norms": r["grad_norms"],
            "params": SH.gather_tree(r["params"], r["shardings"], r["mesh"]),
            "at_rest": rest, "coord": tuple(r["mesh"].get_coordinate()),
            "shape": tuple(r["mesh"].shape)}


def _capture():
    """An optimizer whose update leaves the params and returns the
    gradients it was given (scaled by the clip) as its state."""
    def update(grads, state, params, grad_scale=None):
        return params, tree_map(lambda g: g.clone(), grads)
    return Optimizer(lambda p: {}, update)


def _ref_step(key, tmp):
    """The first step at (1, 2) on the weights the parent transplanted from
    the reference (``ref_<key>.pt``): loss, grad norm and the whole
    gradient (gathered over 'model'), unclipped."""
    arch, over, _ = ARCHS[key]
    cfg = dataclasses.replace(get(arch, smoke=True), **over)
    params, batch = torch.load(f"{tmp}/ref_{key}.pt", weights_only=False)
    mesh = make_mesh((1, 2), ("data", "model"))
    shardings = SH.param_shardings(cfg, params, mesh, fsdp=False)
    params = SH.shard_tree(params, shardings, mesh)
    step = make_train_step(cfg, _capture(), clip_norm=1e30, device="cpu",
                           mesh=mesh, shardings=shardings)
    _, grads, m = step(params, {}, batch)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "grads": SH.gather_tree(grads, shardings, mesh)}


def _attn_paths(tmp):
    """``attn_apply`` on random whole weights with no mesh, and at (1, 2) on
    each rank's slices (wq / wk / wv by columns, wo by rows): outputs and
    gradients, gathered, and the all-gathers each path ran."""
    out = {}
    mesh = make_mesh((1, 2), ("data", "model"))
    gathers = []
    real = tp.gather_from_model

    def counted(x, dim):
        gathers.append(dim)
        return real(x, dim)

    tp.gather_from_model = counted
    try:
        for key in ("smollm", "danube"):
            arch, _, seq = ARCHS[key]
            cfg = get(arch, smoke=True)
            g = torch.Generator().manual_seed(5)
            whole = tlayers.attn_init(g, cfg, torch.float32)
            x = torch.randn(2, seq, cfg.d_model, generator=g)
            dy = torch.randn(2, seq, cfg.d_model, generator=g)
            pos = torch.arange(seq)

            def run(p):
                p = {k: v.detach().requires_grad_(True) for k, v in p.items()}
                xi = x.clone().requires_grad_(True)
                y = tlayers.attn_apply(p, xi, cfg, pos)
                y.backward(dy)
                return y.detach(), xi.grad, {k: v.grad for k, v in p.items()}

            want = run(whole)
            dims = {"wq": 1, "wk": 1, "wv": 1, "wo": 0}
            i = mesh.get_coordinate()[1]
            local = {k: torch.tensor_split(v, 2, dims[k])[i].contiguous()
                     for k, v in whole.items()}
            gathers.clear()
            with part.use_mesh(mesh):
                y, dx, dp = run(local)
            got_dp = {k: SH.gather_dim(v, dims[k], mesh.get_group("model"), 2)
                      for k, v in dp.items()}
            out[key] = {"want": want, "got": (y, dx, got_dp),
                        "gathers": list(gathers)}
    finally:
        tp.gather_from_model = real
    return out


JOBS = {key: (lambda d, key=key: _tp_run(key)) for key in ARCHS}
JOBS.update({f"ref_{key}": (lambda d, key=key: _ref_step(key, d))
             for key in ARCHS})
JOBS["ckpt"] = lambda d: _tp_run("smollm", ckpt_dir=f"{d}/ckpt", ckpt_every=2)
# after "ckpt": its last checkpoint resumed at (2, 1), two more steps
JOBS["resume"] = lambda d: {"losses": (r := _train(
    "smollm", (2, 1), steps=STEPS + 2, ckpt_dir=f"{d}/ckpt"))["losses"],
    "start_step": r["start_step"]}
JOBS["attn"] = _attn_paths


def _reference_weights(tmp, key):
    """The reference's SMOKE weights (seed 1) transplanted, and a batch;
    written for the ranks; returns the reference's first step on them:
    loss, grad norm and unclipped gradient (its jitted step, no mesh, with
    an optimizer that hands back the gradients)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get as jget
    from repro.launch.steps import make_train_step as jmake_train_step
    from repro.models import model_api as jmodel_api
    from repro.optim.optimizers import Optimizer as JOptimizer
    from repro_torch.weights import from_jax_params

    arch, over, seq = ARCHS[key]
    jcfg = dataclasses.replace(jget(arch, smoke=True), **over)
    tcfg = dataclasses.replace(get(arch, smoke=True), **over)
    jparams = jmodel_api(jcfg).init(jax.random.PRNGKey(1), jcfg)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab,
                                             (REF_BATCH, seq + 1), np.int32)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    torch.save((tparams, batch), f"{tmp}/ref_{key}.pt")
    capture = JOptimizer(lambda p: {}, lambda g, s, p: (p, g))
    step = jax.jit(jmake_train_step(jcfg, capture, clip_norm=1e30))
    _, grads, m = step(jparams, {}, jax.tree.map(jnp.asarray, batch))
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "grads": grads}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp2")
    ref = {key: _reference_weights(tmp, key) for key in ARCHS}
    return tmp, _spawn(tmp, 2, list(JOBS), module=__name__), ref


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    """The one-process runs (smollm saving a checkpoint every 2 steps)."""
    d = tmp_path_factory.mktemp("one_tp") / "ckpt"
    out = {key: _train(key) for key in ARCHS if key != "smollm"}
    out["smollm"] = dict(_train("smollm", ckpt_dir=str(d), ckpt_every=2),
                         ckpt_dir=str(d))
    return out


def _close(got, want, rel=REL):
    return len(got) == len(want) and all(
        abs(g - w) <= rel * abs(w) for g, w in zip(got, want))


def assert_same_run(ranks, one):
    """Every rank: the one-process run's losses and grad norms to ``REL``,
    its params to ``PARAM_TOL``."""
    for r in ranks:
        assert _close(r["losses"], one["losses"]), (r["losses"], one["losses"])
        assert _close(r["grad_norms"], one["grad_norms"]), \
            (r["grad_norms"], one["grad_norms"])
        _params_close(r["params"], one["params"])


@pytest.mark.parametrize("key", list(ARCHS))
def test_tensor_parallel_equals_one_process(world2, one, key):
    assert_same_run([r[key] for r in world2[1]], one[key])


class _Rank:
    """What ``layout.local_shard`` reads of a mesh: axis names and sizes,
    and a rank's coordinate."""
    mesh_dim_names = ("data", "model")

    def __init__(self, shape, coord):
        self.shape, self._coord = shape, coord

    def get_coordinate(self):
        return list(self._coord)


# leaves the rules split over 'model' at (1, 2), of each SMOKE tree
SPLIT = {"smollm": 8, "danube": 9, "stablelm": 9, "granite": 7, "qwen3": 9}


@pytest.mark.parametrize("key", list(ARCHS))
def test_slices_at_rest_are_the_rules(world2, one, key):
    """Each rank's params and AdamW moments at rest are ``local_shard`` of
    the one-process run's under ``param_shardings``: the same shapes, and
    values to ``PARAM_TOL`` (params) or 1e-4 of the leaf's largest moment.
    Granite's vocab of 255 leaves its embedding whole."""
    want = one[key]
    whole = []          # in the order of the ranks' lists (tree_map's)
    tree_map(lambda *leaves: whole.append(leaves), want["params"],
             want["opt_state"]["mu"], want["opt_state"]["nu"])
    for r in world2[1]:
        got = r[key]
        mesh = _Rank(got["shape"], got["coord"])
        assert len(got["at_rest"]) == len(whole)
        split = 0
        for (pl, t, mu, nu), wanted in zip(got["at_rest"], whole):
            split += any(p.is_shard() for p in pl)
            for a, b in zip((t, mu, nu), wanted):
                b = local_shard(b, pl, mesh)
                assert a.shape == b.shape
                tol = PARAM_TOL if a is t else 1e-4 * float(b.abs().max())
                assert float((a - b).abs().max()) <= tol
        assert split == SPLIT[key]
    if key == "granite":
        assert not any(p.is_shard() for p in world2[1][0][key]["at_rest"][0][0])


@pytest.mark.parametrize("key", list(ARCHS))
def test_first_step_matches_the_reference(world2, key):
    """Rank 0's first (1, 2) step on the reference's weights against the
    reference's jitted step with no mesh: the float32 loss to 1e-5
    relative, every leaf of the gathered gradient to 1e-4 max|g| + 1e-6."""
    import jax

    got, want = world2[1][0][f"ref_{key}"], world2[2][key]
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    assert abs(got["grad_norm"] - want["grad_norm"]) <= \
        1e-5 * abs(want["grad_norm"])
    flat = jax.tree_util.tree_flatten_with_path(want["grads"])[0]
    assert len(flat) == len(tree_leaves(got["grads"]))
    for path, w in flat:
        g = got["grads"]
        for p in path:
            g = g[p.key if hasattr(p, "key") else p.idx]
        w = np.asarray(w)
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        tol = 1e-4 * float(np.abs(w).max()) + 1e-6
        np.testing.assert_allclose(g.numpy(), w, atol=tol, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("key,gathers", [("smollm", [1, 1, 1]),
                                         ("danube", [])])
def test_attention_replicated_where_model_does_not_divide_the_heads(
        world2, key, gathers):
    """smollm's 3 / 1 heads do not split over 2 ranks: every rank gathers
    wq, wk and wv by columns and runs every head (GSPMD's layout for the
    reference), then its rows of wo; danube's 4 / 2 split, each rank runs
    its own and gathers nothing. Both equal the whole layer: output, input
    gradient and every weight's gradient to 1e-5 of its largest."""
    for r in world2[1]:
        rec = r["attn"][key]
        assert rec["gathers"] == gathers
        (y, dx, dp), (wy, wdx, wdp) = rec["got"], rec["want"]
        for a, b in [(y, wy), (dx, wdx)] + [(dp[k], wdp[k]) for k in wdp]:
            assert a.shape == b.shape
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_checkpoint_at_two_ranks_resumes_at_one(world2, one):
    """The (1, 2) run saved whole tensors every 2 steps (rank 0). One
    process restores step 2 into its unsharded tree: params and AdamW
    state equal what one process saved at step 2, and steps on batches 2
    and 3 give the uninterrupted run's losses and params. Its step 4
    resumes at one process and, in the same spawn, at (2, 1), with equal
    losses."""
    tmp, ranks, _ = world2
    d = str(tmp / "ckpt")
    assert ckpt.latest_step(d) == STEPS
    assert_same_run([r["ckpt"] for r in ranks], one["smollm"])
    cfg = one["smollm"]["cfg"]
    params = model_api(cfg).init(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    opt = adamw(warmup_cosine(LR, warmup=max(STEPS // 10, 1), total=STEPS))
    target = (params, opt.init(params))
    (params, state), _ = ckpt.restore(d, 2, target)
    (p_one, s_one), _ = ckpt.restore(one["smollm"]["ckpt_dir"], 2, target)
    assert int(state["step"]) == 2
    for got, want in ((params, p_one), (state["mu"], s_one["mu"]),
                      (state["nu"], s_one["nu"])):
        _params_close(got, want)
    src = SyntheticLM(BATCH, ARCHS["smollm"][2], cfg.vocab, seed=0)
    batches = [src.next_batch() for _ in range(STEPS)]
    step = make_train_step(cfg, opt, device="cpu")
    losses = [float(step(params, state, b)[2]["loss"]) for b in batches[2:]]
    assert _close(losses, one["smollm"]["losses"][2:])
    _params_close(params, one["smollm"]["params"])
    again = _train("smollm", steps=STEPS + 2, ckpt_dir=d)
    assert again["start_step"] == STEPS and len(again["losses"]) == 2
    for r in ranks:
        assert r["resume"]["start_step"] == STEPS
        assert _close(r["resume"]["losses"], again["losses"])
