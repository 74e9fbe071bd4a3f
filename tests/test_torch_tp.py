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
* Qwen3-MoE SMOKE: 8 experts, 4 a rank;
* DeepSeek-V3 SMOKE: MLA (wdq / wdkv / wuq / wukv by columns, wo by rows,
  2 of 4 heads a rank), its dense prefix, 4 of 8 experts a rank and the
  MTP module (``proj`` by its output columns);
* Jamba SMOKE: Mamba over d_inner (``in_proj``'s [x | z] columns split
  contiguously: rank 0 holds x's, rank 1 z's), attention with 2 / 1
  heads a rank, its real MoE layers and dense SwiGLUs;
* xLSTM SMOKE: mLSTM (``in_proj`` as Mamba's, conv / wq / wk / wv /
  out_proj by d_inner rows, the recurrence whole on every rank: its 2
  heads need not split) and sLSTM (``w``'s [i | f | z | o] columns split
  contiguously, ``out_proj`` by rows, the time loop whole);
* whisper SMOKE: the encoder's and the decoder's attention and MLPs, cross
  attention with 2 of 4 heads a rank (``cross_kv`` of this rank's heads),
  its tied vocab of 256 split; and with a vocab of 255, which stays whole;
* llava SMOKE: the dense backbone on ``embeds`` whose text rows the
  trainer looks up through the vocab split (never a gathered table).

Also each rank's params and AdamW moments at rest against the rules'
slices of the one-process run's, the first step at rank 0 against the
reference's step (jitted, no mesh) on the same weights, both attention
paths by name, ``mla_apply``, ``mamba_apply``, ``mlstm_apply``,
``slstm_apply`` and cross attention on each rank's slices against the
whole layer with the collectives each runs, each run's collectives over
'model' against ``tensor_parallel.collectives_per_step``, llava's text
lookup through the split against the whole table's rows, and a (1, 2)
checkpoint resumed by one process and at (2, 1).
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
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import batch_axes
from repro_torch.launch.train import train
from repro_torch.layout import local_shard
from repro_torch.models import encdec as tencdec
from repro_torch.models import layers as tlayers
from repro_torch.models import model_api
from repro_torch.models import partitioning as part
from repro_torch.models import ssm as tssm
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
         "qwen3": ("qwen3_moe_235b_a22b", {}, 16),
         "deepseek": ("deepseek_v3_671b", {}, 16),
         # a seq that Jamba SMOKE's mamba_chunk of 8 divides
         "jamba": ("jamba_1_5_large_398b", {}, 16),
         # two mLSTM chunks of 16
         "xlstm": ("xlstm_125m", {}, 32),
         # 16 decoder tokens beside 32 frames
         "whisper": ("whisper_small", {}, 16),
         "whisper255": ("whisper_small", {"vocab": 255}, 16),
         # 8 image patches and 8 text tokens
         "llava": ("llava_next_mistral_7b", {}, 16)}
# the seed of a config's weights and batches where it is not 0. DeepSeek
# SMOKE at seed 0: one element of the prefix's wdkv gradient is 3.9e-8 in
# one process and -3.6e-8 at (1, 4) (2.6e-7 of the leaf's largest, float32
# sums in another order), and AdamW's first update, lr g / (|g| + 1e-8),
# moves it by about lr either way, past PARAM_TOL; the moments of the
# leaves after it then differ by ~1e-4 of their largest. At seeds 1-3 the
# (1, 4) run's params are within 1.6e-5, 2.8e-6 and 4.0e-6
SEEDS = {"deepseek": 1}
# the reference's first step: a batch of REF_BATCH rows
REF_BATCH = 4


def _train(key, shape=None, steps=STEPS, more=None, **kw):
    """``train`` of ``ARCHS[key]`` (seed ``SEEDS[key]`` unless ``kw`` gives
    one), its overrides updated by ``more``."""
    arch, over, seq = ARCHS[key]
    kw.setdefault("seed", SEEDS.get(key, 0))
    return train(arch, steps=steps, batch=BATCH, seq=seq, lr=LR, device="cpu",
                 mesh_shape=shape, overrides={**over, **(more or {})} or None,
                 log_every=steps, **kw)


def _tp_run(key, shape=(1, 2), **kw):
    """A mesh run's losses, grad norms, whole params (gathered), and at
    rest each leaf's placements with its slice and AdamW moments, and this
    rank's mesh coordinate."""
    tp.counts.clear()
    r = _train(key, shape, **kw)
    counted = dict(tp.counts)
    rest = []
    tree_map(lambda t, pl, mu, nu: rest.append((tuple(pl), t, mu, nu)),
             r["params"], r["shardings"], r["opt_state"]["mu"],
             r["opt_state"]["nu"])
    return {"losses": r["losses"], "grad_norms": r["grad_norms"],
            "params": SH.gather_tree(r["params"], r["shardings"], r["mesh"]),
            "at_rest": rest, "coord": tuple(r["mesh"].get_coordinate()),
            "shape": tuple(r["mesh"].shape), "collectives": counted}


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


# the mixers split over d_inner or heads: (config, its overrides, init,
# apply, the dim of each leaf that 'model' splits; a leaf not named stays
# whole), and the collectives over 'model' that one call runs forward and
# backward on each rank
MIXERS = {
    # 'model' divides the heads: each rank its heads. Forward: the two
    # latents gathered, the output summed; backward: their reduce-scatters,
    # and the gradients of x, wkr, q_norm and kv_norm summed
    "mla": ("deepseek_v3_671b", {}, tlayers.mla_init,
            lambda p, x, cfg, pos: tlayers.mla_apply(p, x, cfg, pos),
            {"wdq": 1, "wdkv": 1, "wuq": 1, "wukv": 1, "wo": 0},
            {"all_gather": 2, "all_reduce": 1}, {"reduce_scatter": 2,
                                                 "all_reduce": 4}),
    # 2 heads over 4 ranks: wuq and wukv gathered too, every head on every
    # rank, then each rank's columns of the output into its rows of wo
    "mla_every_head": ("deepseek_v3_671b", {"n_heads": 2}, tlayers.mla_init,
                       lambda p, x, cfg, pos: tlayers.mla_apply(p, x, cfg, pos),
                       {"wdq": 1, "wdkv": 1, "wuq": 1, "wukv": 1, "wo": 0},
                       {"all_gather": 4, "all_reduce": 1},
                       {"reduce_scatter": 4, "all_reduce": 4}),
    # forward: x @ in_proj gathered, (dt_r, B, C) and the output summed;
    # backward: the reduce-scatter, and the gradients of x, of the summed
    # (dt_r, B, C) and of dt_bias summed
    "mamba": ("jamba_1_5_large_398b", {}, tssm.mamba_init,
              lambda p, x, cfg, pos: tssm.mamba_apply(p, x, cfg),
              {"in_proj": 1, "conv": 0, "x_proj": 0, "dt_proj": 1,
               "A_log": 0, "D": 0, "out_proj": 0},
              {"all_gather": 1, "all_reduce": 2}, {"reduce_scatter": 1,
                                                   "all_reduce": 3}),
    # forward: x @ in_proj gathered, the partial q / k / v (one tensor) and
    # the output summed; backward: the reduce-scatter, and the gradients of
    # x, of the summed q / k / v, of the norm's scale, w_gates and
    # gate_bias summed
    "mlstm": ("xlstm_125m", {}, tssm.mlstm_init,
              lambda p, x, cfg, pos: tssm.mlstm_apply(p, x, cfg),
              {"in_proj": 1, "conv": 0, "wq": 0, "wk": 0, "wv": 0,
               "out_proj": 0},
              {"all_gather": 1, "all_reduce": 2}, {"reduce_scatter": 1,
                                                   "all_reduce": 5}),
    # forward: x @ w gathered, the output summed; backward: the
    # reduce-scatter, and the gradients of x, r and b summed
    "slstm": ("xlstm_125m", {}, tssm.slstm_init,
              lambda p, x, cfg, pos: tssm.slstm_apply(p, x, cfg),
              {"w": 1, "out_proj": 0},
              {"all_gather": 1, "all_reduce": 1}, {"reduce_scatter": 1,
                                                   "all_reduce": 3}),
    # cross attention of x against itself as the encoder states, wk / wv
    # in the decoder's stacked layout (one layer): each rank its heads.
    # Forward: the output summed; backward: the gradients of x as the
    # queries' input and as the encoder states (cross_kv) summed
    "cross": ("whisper_small", {}, lambda g, cfg, dt: _stack_kv(
        tlayers.attn_init(g, cfg, dt)), lambda p, x, cfg, pos: _cross(p, x, cfg),
              {"wq": 1, "wk": 2, "wv": 2, "wo": 0},
              {"all_reduce": 1}, {"all_reduce": 2}),
    # 2 heads over 4 ranks: wq, wk and wv gathered too, every head on every
    # rank, then each rank's columns of the output into its rows of wo
    "cross_every_head": ("whisper_small", {"n_heads": 2, "n_kv_heads": 2},
                         lambda g, cfg, dt: _stack_kv(tlayers.attn_init(g, cfg, dt)),
                         lambda p, x, cfg, pos: _cross(p, x, cfg),
                         {"wq": 1, "wk": 2, "wv": 2, "wo": 0},
                         {"all_gather": 3, "all_reduce": 1},
                         {"reduce_scatter": 3, "all_reduce": 2}),
}
# the mixers run at (1, 2); at (1, 4) the "*_every_head" ones besides
MIXERS_AT_2 = ("mla", "mamba", "mlstm", "slstm", "cross")
MIXER_SEQ = 16


def _stack_kv(p):
    """Attention leaves with wk / wv in the decoder's stacked layout of one
    layer, (1, D, Hkv * hd), as ``encdec.cross_kv`` takes them."""
    return dict(p, wk=p["wk"][None], wv=p["wv"][None])


def _cross(p, x, cfg):
    """Cross attention of ``x`` against the K/V that ``cross_kv`` makes of
    ``x`` itself (one layer)."""
    k, v = tencdec.cross_kv({"decoder": {"cross": p}}, x, cfg)
    return tlayers.cross_attn_apply(p, x, (k[0], v[0]), cfg)


def _mixer_paths(shape, keys=MIXERS_AT_2):
    """The mixers ``keys`` of ``MIXERS`` (float32 SMOKE widths) on random
    whole weights with no mesh, and at ``shape`` on this rank's slices:
    outputs, input gradients and every weight's gradient (gathered over
    'model'), the collectives each pass ran (``tp.counts``), and this
    rank's ``in_proj`` slice."""
    out = {}
    mesh = make_mesh(shape, ("data", "model"))
    m, i = shape[1], mesh.get_coordinate()[1]
    for key in keys:
        arch, over, init, apply, dims, _, _ = MIXERS[key]
        cfg = dataclasses.replace(get(arch, smoke=True), **over)
        g = torch.Generator().manual_seed(7)
        whole = init(g, cfg, torch.float32)
        # A_log, D and dt_bias start at constants: draw them, so a rank on
        # the wrong channels shows
        for k in ("A_log", "D", "dt_bias"):
            if k in whole:
                whole[k] = whole[k] + 0.5 * torch.rand(whole[k].shape,
                                                       generator=g)
        x = torch.randn(2, MIXER_SEQ, cfg.d_model, generator=g)
        dy = torch.randn(2, MIXER_SEQ, cfg.d_model, generator=g)
        pos = torch.arange(MIXER_SEQ)
        counted = {}

        def run(p):
            p = {k: v.detach().requires_grad_(True) for k, v in p.items()}
            xi = x.clone().requires_grad_(True)
            tp.counts.clear()
            y = apply(p, xi, cfg, pos)
            counted["fwd"] = dict(tp.counts)
            tp.counts.clear()
            y.backward(dy)
            counted["bwd"] = dict(tp.counts)
            return y.detach(), xi.grad, {k: v.grad for k, v in p.items()}

        want = run(whole)
        local = {k: torch.tensor_split(v, m, dims[k])[i].contiguous()
                 if k in dims else v for k, v in whole.items()}
        with part.use_mesh(mesh):
            y, dx, dp = run(local)
        got_dp = {k: SH.gather_dim(v, dims[k], mesh.get_group("model"), m)
                  if k in dims else v for k, v in dp.items()}
        out[key] = {"want": want, "got": (y, dx, got_dp),
                    "counts": dict(counted), "local": local,
                    "whole": whole, "d_inner": cfg.d_inner}
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
JOBS["mixers"] = lambda d: _mixer_paths((1, 2))
JOBS["lookup"] = lambda d: _text_lookup((1, 2), fsdp=False)


def _text_lookup(shape, fsdp):
    """llava SMOKE's ``embeds`` as the trainer builds them (its
    ``_frontend_batch``) at a mesh of ``shape`` from this rank's slices of
    the embedding (ZeRO-3 over 'data' with ``fsdp``), and with no mesh from
    the whole table; the trainer's collectives (``frontend_counts``) and
    this rank's embedding shape."""
    arch, over, seq = ARCHS["llava"]
    cfg = get(arch, smoke=True)
    params = model_api(cfg).init(torch.Generator().manual_seed(3), cfg,
                                 device="cpu")
    mesh = make_mesh(shape, ("data", "model"))
    shardings = SH.param_shardings(cfg, params, mesh, fsdp)
    local = SH.shard_tree(params, shardings, mesh)
    raw = SyntheticLM(BATCH, seq, cfg.vocab, seed=3).next_batch()
    cpu = torch.device("cpu")
    want = train_mod._frontend_batch(cfg, params, raw, 3, 0, seq, cpu)
    train_mod.frontend_counts.clear()
    with part.use_mesh(mesh, batch_axes(mesh)):
        got = train_mod._frontend_batch(
            cfg, local, raw, 3, 0, seq, cpu,
            train_mod._text_gather(mesh, shardings))
    return {"want": want["embeds"], "got": got["embeds"],
            "counts": dict(train_mod.frontend_counts),
            "embed": tuple(local["embed"].shape)}


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
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab, (REF_BATCH, seq + 1), np.int32)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    if jcfg.family == "audio":
        batch["frames"] = (0.02 * rng.standard_normal(
            (REF_BATCH, jcfg.encoder_seq, jcfg.d_model))).astype(np.float32)
    elif jcfg.family == "vlm":
        # the trainer's batch: the fused embeds, data to the step
        from repro.models import frontends as jfrontends
        patches = (0.02 * rng.standard_normal(
            (REF_BATCH, jcfg.img_tokens, jcfg.d_model))).astype(np.float32)
        batch = {"embeds": np.asarray(jfrontends.fuse_vlm_inputs(
            jparams, jnp.asarray(patches), toks[:, :seq - jcfg.img_tokens],
            jcfg)), "labels": toks[:, 1:]}
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
SPLIT = {"smollm": 8, "danube": 9, "stablelm": 9, "granite": 7, "qwen3": 9,
         "deepseek": 33, "jamba": 79, "xlstm": 9, "whisper": 19,
         "whisper255": 18, "llava": 9}


@pytest.mark.parametrize("key", list(ARCHS))
def test_slices_at_rest_are_the_rules(world2, one, key):
    """Each rank's params and AdamW moments at rest are ``local_shard`` of
    the one-process run's under ``param_shardings``: the same shapes, and
    values to ``PARAM_TOL`` (params) or 1e-4 of the leaf's largest moment.
    Granite's and whisper's vocab of 255 leave the embedding whole."""
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
    if key in ("granite", "whisper255"):
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


def assert_mixer_equal(rec):
    """A mixer on this rank's slices against the whole layer: the output to
    1e-5 of its largest, the input's and every weight's gradient (gathered
    over 'model') to 1e-4 of its largest + 1e-6."""
    (y, dx, dp), (wy, wdx, wdp) = rec["got"], rec["want"]
    assert y.shape == wy.shape
    assert float((y - wy).abs().max()) <= 1e-5 * float(wy.abs().max())
    assert set(dp) == set(wdp)
    for name, a, b in [("x", dx, wdx)] + [(k, dp[k], wdp[k]) for k in wdp]:
        assert a.shape == b.shape, name
        tol = 1e-4 * float(b.abs().max()) + 1e-6
        assert float((a - b).abs().max()) <= tol, (name, a, b)


def assert_mixer_collectives(rec, key):
    """The collectives of one forward and one backward are the design's
    (``MIXERS``), and the backward reduce-scatters as many bytes as the
    forward gathered (none, for a mixer that gathers nothing)."""
    got = {d: {k: n for k, n in c.items() if not k.endswith("_bytes")}
           for d, c in rec["counts"].items()}
    assert got == {"fwd": MIXERS[key][5], "bwd": MIXERS[key][6]}
    gathered = rec["counts"]["fwd"].get("all_gather_bytes", 0)
    assert gathered == rec["counts"]["bwd"].get("reduce_scatter_bytes", 0)
    assert (gathered > 0) == ("all_gather" in MIXERS[key][5])


@pytest.mark.parametrize("key", MIXERS_AT_2)
def test_mixer_on_slices_equals_the_whole_layer(world2, key):
    """``mla_apply`` / ``mamba_apply`` / ``mlstm_apply`` / ``slstm_apply``
    and cross attention (``cross_kv`` + ``cross_attn_apply``) at (1, 2),
    each rank on its slices, equal the whole layer with no mesh: output and
    every gradient."""
    for r in world2[1]:
        assert_mixer_equal(r["mixers"][key])


@pytest.mark.parametrize("key", MIXERS_AT_2)
def test_mixer_collectives_are_the_designs(world2, key):
    """An MLA call gathers its two latents and sums its output (backward:
    two reduce-scatters, the sums of x's, wkr's and the norms'
    gradients); a Mamba call gathers x @ in_proj and sums (dt_r, B, C) and
    its output (backward: a reduce-scatter, the sums of x's, (dt_r, B,
    C)'s and dt_bias's gradients); an mLSTM call gathers x @ in_proj and
    sums q / k / v in one tensor and its output (backward: a
    reduce-scatter, the sums of x's, q / k / v's, the norm's, w_gates' and
    gate_bias' gradients); an sLSTM call gathers x @ w and sums its output
    (backward: a reduce-scatter, the sums of x's, r's and b's gradients);
    cross attention sums its output (backward: the sums of the queries'
    input's and the encoder states' gradients)."""
    for r in world2[1]:
        assert_mixer_collectives(r["mixers"][key], key)


def assert_design_collectives(run, key, steps=STEPS):
    """A run's collectives over 'model' (``tensor_parallel.counts``, every
    step of ``train()``, the vlm's text lookup included) are
    ``tensor_parallel.collectives_per_step`` of its config at its 'model'
    axis, a step at a time."""
    arch, over, seq = ARCHS[key]
    cfg = dataclasses.replace(get(arch, smoke=True), **over)
    m = run["shape"][1]
    want = {k: n * steps for k, n in
            tp.collectives_per_step(cfg, m, seq).items()}
    got = {k: n for k, n in run["collectives"].items()
           if not k.endswith("_bytes")}
    assert got == want, (key, m, got, want)


@pytest.mark.parametrize("key", list(ARCHS))
def test_collectives_a_step_are_the_designs(world2, key):
    """Each SMOKE run at (1, 2) runs the collectives over 'model' that
    ``tensor_parallel.collectives_per_step`` counts for it (phases 34, 37
    and 38 hold the card's runs to that count): remat's recompute, the
    encoder-decoder's blocks, cross attention and ``cross_kv``, a whole
    or split vocab, the vlm's text lookup outside the step."""
    for r in world2[1]:
        assert_design_collectives(r[key], key)


def assert_text_lookup(rec, embed, counts):
    """The embeds built from this rank's slices of the embedding equal the
    whole table's bit for bit (a sum of one row and zeros; a gather), the
    rank held ``embed`` of it, and the trainer counted ``counts``."""
    assert rec["embed"] == embed
    assert rec["got"].shape == rec["want"].shape
    assert torch.equal(rec["got"], rec["want"])
    assert rec["counts"] == counts


def test_vlm_text_lookup_through_the_vocab_split(world2):
    """At (1, 2) the trainer looks llava's text rows up in this rank's half
    of the vocab and sums them over 'model' (one all-reduce of the rows):
    it never gathers the table."""
    rows = BATCH * (ARCHS["llava"][2] - 8) * 64 * 4
    for r in world2[1]:
        assert_text_lookup(r["lookup"], (128, 64),
                           {"all_reduce": 1, "all_reduce_bytes": rows})


def test_mamba_rank_takes_its_channels_of_x_and_z(world2):
    """``in_proj``'s columns are [x | z] and the rules split them
    contiguously: at (1, 2) rank 0 holds x's columns of every channel and
    rank 1 z's. Each rank still runs its channels of both: its output
    equals the whole layer's (splitting its own product into halves would
    run rank 0 on x's channels twice)."""
    for i, r in enumerate(world2[1]):
        rec = r["mixers"]["mamba"]
        di = rec["d_inner"]
        whole, local = rec["whole"]["in_proj"], rec["local"]["in_proj"]
        assert torch.equal(local, whole[:, i * di:(i + 1) * di])
        y, wy = rec["got"][0], rec["want"][0]
        assert float((y - wy).abs().max()) <= 1e-5 * float(wy.abs().max())


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
