"""The port's training path on the CPU against the JAX reference.

Weights come from the reference's ``init`` and are transplanted with
``weights.from_jax_params``; batches from ``numpy.random.default_rng`` or
the data pipeline (both packages' ``SyntheticLM`` give the same batches).
The reference's train step is jitted with no mesh (its ``train()`` needs a
mesh that the installed JAX refuses; ROADMAP.md "not faults").
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs import get as jget
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import layers as jlayers
from repro.models import model_api as jmodel_api
from repro.optim import optimizers as jopt
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.configs import get as tget
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels.flash_attention import (flash_attention_bwd_plain,
                                                 flash_attention_plain)
from repro_torch.kernels.rmsnorm import rmsnorm_bwd_plain
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import train
from repro_torch.models import layers as tlayers
from repro_torch.models import model_api
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.optim import optimizers as topt
from repro_torch.weights import from_jax_opt_state, from_jax_params

# float32 losses of order 5 after two layers, summed in another order
LOSS_TOL = 2e-5
# danube's window of 16 inside the sequence; xLSTM's mLSTM chunk of 16
# must divide it
SEQ = {"h2o_danube_1_8b": 32, "xlstm_125m": 32}


def _pair(name, seed=0, **over):
    jcfg = dataclasses.replace(jget(name, smoke=True), **over)
    tcfg = dataclasses.replace(tget(name, smoke=True), **over)
    jparams = jmodel_api(jcfg).init(jax.random.PRNGKey(seed), jcfg)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def _batch(vocab, b, s, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1),
                                                dtype=np.int32)
    return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _port_grads(tcfg, tparams, batch):
    p = tree_map(lambda a: a.detach().requires_grad_(True), tparams)
    loss, metrics = model_api(tcfg).loss(
        p, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    loss.backward()
    return loss, metrics, tree_map(lambda a: a.grad, p)


@pytest.mark.parametrize("name", ["smollm_360m", "h2o_danube_1_8b",
                                  "granite_3_2b", "stablelm_3b",
                                  "deepseek_v3_671b"])
def test_lm_loss_matches_jax(name):
    """DeepSeek SMOKE runs with its MTP module: the loss is ce + mtp_weight
    * mtp + aux, and 'mtp' is compared too."""
    jcfg, jparams, tcfg, tparams = _pair(name)
    batch = _batch(jcfg.vocab, 2, SEQ.get(name, 24))
    # jitted: eager JAX takes ~3x as long on the MoE configs
    want, wm = jax.jit(jmodel_api(jcfg).loss, static_argnums=2)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    with torch.no_grad():
        got, gm = model_api(tcfg).loss(
            tparams, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    assert set(gm) == set(wm) == {"ce", "aux", "tokens"} | (
        {"mtp"} if tcfg.mtp else set())
    for key in wm:
        np.testing.assert_allclose(float(gm[key]), float(wm[key]),
                                   atol=LOSS_TOL, rtol=LOSS_TOL)


def test_lm_loss_with_a_mask_matches_jax():
    jcfg, jparams, tcfg, tparams = _pair("smollm_360m")
    batch = _batch(jcfg.vocab, 2, 24, seed=3)
    batch["mask"] = (np.random.default_rng(3).random((2, 24)) < 0.6
                     ).astype(np.float32)
    want, wm = jmodel_api(jcfg).loss(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    with torch.no_grad():
        got, gm = model_api(tcfg).loss(
            tparams, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    np.testing.assert_allclose(float(got), float(want), atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    assert float(gm["tokens"]) == float(wm["tokens"]) == batch["mask"].sum()


def _at(tree, path):
    """The leaf of a port tree at a JAX key path (dict keys and list
    indices: DeepSeek's dense prefix is a list)."""
    for p in path:
        tree = tree[p.key if hasattr(p, "key") else p.idx]
    return tree


# the MoE, MLA and MTP family (DeepSeek SMOKE with its MTP module), GQA MoE,
# Jamba with its real MoE layers (the plain scan on the CPU) and xLSTM
@pytest.mark.parametrize("name", ["smollm_360m", "h2o_danube_1_8b",
                                  "deepseek_v3_671b", "qwen3_moe_235b_a22b",
                                  "jamba_1_5_large_398b", "xlstm_125m"])
def test_every_gradient_leaf_matches_jax(name):
    """Every leaf of the port's autograd gradient against ``jax.grad`` of the
    reference loss (the blockwise jnp attention under ``jax.checkpoint``):
    |diff| <= 1e-4 max|g| + 1e-6 per leaf, the sums being taken in another
    order. The loss runs through ``torch.utils.checkpoint`` (cfg.remat);
    the stacked leaves' gradients come through ``unbind``."""
    jcfg, jparams, tcfg, tparams = _pair(name, seed=1)
    assert tcfg.remat
    batch = _batch(jcfg.vocab, 2, SEQ.get(name, 24), seed=1)
    jgrads = jax.jit(jax.grad(lambda p: jmodel_api(jcfg).loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)[0]))(jparams)
    _, _, tgrads = _port_grads(tcfg, tparams, batch)
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(flat) == len(tree_leaves(tgrads))
    for path, want in flat:
        got = _at(tgrads, path)
        want = np.asarray(want)
        assert got is not None and got.shape == want.shape
        tol = 1e-4 * float(np.abs(want).max()) + 1e-6
        np.testing.assert_allclose(_np(got), want, atol=tol, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", ["smollm_360m", "deepseek_v3_671b",
                                  "jamba_1_5_large_398b"])
def test_stacked_gradients_equal_per_layer_selects(name, monkeypatch):
    """``forward`` takes each stacked leaf apart with one ``unbind``; its
    gradients equal those of taking layer j with a ``select`` per layer and
    leaf (``_layer``), which the backward sums as zero stacks: each slot of
    either holds one layer's gradient, so they agree bit for bit."""
    from repro_torch.models import transformer
    _, _, tcfg, tparams = _pair(name, seed=2, n_layers=3 * len(
        tget(name, smoke=True).period) + tget(name, smoke=True).first_k_dense)
    assert tcfg.n_periods == 3
    batch = _batch(tcfg.vocab, 2, SEQ.get(name, 24), seed=2)
    loss, _, want = _port_grads(tcfg, tparams, batch)
    monkeypatch.setattr(transformer, "_unstack", lambda stacked, n: [
        transformer._layer(stacked, j) for j in range(n)])
    loss2, _, got = _port_grads(tcfg, tparams, batch)
    assert torch.equal(loss, loss2)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(g, w)


def _opt_tree(rng):
    """A numpy tree shaped like a model's: a stacked (n_periods, d) norm
    scale (2-D, so decayed), stacked matrices, a 1-D leaf, a bf16-able
    matrix."""
    return {"final_norm": rng.standard_normal(8).astype(np.float32),
            "stack": {"ln1": rng.standard_normal((2, 8)).astype(np.float32),
                      "wq": rng.standard_normal((2, 8, 6)).astype(np.float32)},
            "embed": rng.standard_normal((10, 8)).astype(np.float32)}


def _torch_tree(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_trees(got, want, tol=1e-6):
    jflat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(jflat) == len(tree_leaves(got))
    for path, w in jflat:
        g = got
        for p in path:
            g = g[p.key]
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32),
                                   atol=tol, rtol=tol,
                                   err_msg=jax.tree_util.keystr(path))


def test_schedule_and_clip_match_jax():
    sched_j = jopt.warmup_cosine(3e-4, warmup=3, total=20)
    sched_t = topt.warmup_cosine(3e-4, warmup=3, total=20)
    for step in range(25):
        want = float(sched_j(jnp.int32(step)))
        # an int step, and the optimizers' 0-d int32 step tensor: a float32
        # tensor on its device, as the reference's
        for arg in (step, torch.tensor(step, dtype=torch.int32)):
            got = sched_t(arg)
            assert got.dtype == torch.float32 and got.shape == ()
            np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-12)
    rng = np.random.default_rng(4)
    tree = _opt_tree(rng)
    for max_norm in (0.5, 1e3):
        jt, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, tree),
                                          max_norm)
        tt, tn = topt.clip_by_global_norm(_torch_tree(tree), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _assert_trees(tt, jt)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizers_match_jax(kind):
    """Four updates from the same params and gradients: params, moments or
    factored statistics, and step; weight decay on the stacked 2-D norm
    leaf included (adafactor with weight decay on). The port's step is a
    0-d int32 tensor, and each update writes params and state in place
    (the same tensors come back)."""
    rng = np.random.default_rng(5)
    params = _opt_tree(rng)
    sched = dict(base_lr=1e-2, warmup=2, total=10)
    if kind == "adamw":
        jo = jopt.adamw(jopt.warmup_cosine(**sched))
        to = topt.adamw(topt.warmup_cosine(**sched))
    else:
        jo = jopt.adafactor(jopt.warmup_cosine(**sched), weight_decay=0.1)
        to = topt.adafactor(topt.warmup_cosine(**sched), weight_decay=0.1)
    jp, tp = jax.tree.map(jnp.asarray, params), _torch_tree(params)
    js, ts = jo.init(jp), to.init(tp)
    leaves = tree_leaves((tp, ts))
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
    for _ in range(4):
        grads = _opt_tree(rng)
        jp, js = jo.update(jax.tree.map(jnp.asarray, grads), js, jp)
        tp, ts = to.update(_torch_tree(grads), ts, tp)
        assert all(a is b for a, b in zip(tree_leaves((tp, ts)), leaves))
    _assert_trees(tp, jp)
    assert ts["step"] == int(js["step"]) == 4
    _assert_trees({k: v for k, v in ts.items() if k != "step"},
                  {k: v for k, v in js.items() if k != "step"})
    # the quirk kept: the stacked (2, 8) norm scale decays, the 1-D one not
    assert kind != "adamw" or not np.allclose(_np(tp["stack"]["ln1"]),
                                              params["stack"]["ln1"])


def test_bf16_params_update_in_storage_dtype():
    p = {"w": torch.ones(3, 4, dtype=torch.bfloat16),
         "s": torch.ones(4, dtype=torch.float32)}
    opt = topt.adamw(1e-2)
    new, state = opt.update(tree_map(torch.ones_like, p), opt.init(p), p)
    assert new["w"].dtype == torch.bfloat16 and new["s"].dtype == torch.float32
    assert state["mu"]["w"].dtype == torch.float32 and state["step"] == 1
    assert topt.pick_optimizer(10 ** 9, 1e-3)[0] == "adamw"
    assert topt.pick_optimizer(10 ** 11, 1e-3)[0] == "adafactor"


def test_six_train_steps_match_jax():
    """Six steps of the port's ``make_train_step`` against the reference's,
    jitted with no mesh, from the same params and AdamW state on the same
    SyntheticLM batches: the loss at every step to 1e-4, the params after to
    1e-3 (~3 lr: AdamW's first steps move each weight by about lr times the
    sign of its gradient, which summation order can flip where a gradient
    is near zero)."""
    jcfg, jparams, tcfg, tparams = _pair("smollm_360m", seed=2)
    sched = dict(base_lr=3e-4, warmup=2, total=6)
    jo = jopt.adamw(jopt.warmup_cosine(**sched))
    to = topt.adamw(topt.warmup_cosine(**sched))
    jstate = jo.init(jparams)
    tstate = from_jax_opt_state(jax.tree.map(np.asarray, jstate), tparams,
                                device="cpu")
    jstep = jax.jit(jmake_train_step(jcfg, jo))
    tstep = make_train_step(tcfg, to, device="cpu")
    jsrc, tsrc = JSyntheticLM(2, 24, jcfg.vocab, seed=2), \
        SyntheticLM(2, 24, tcfg.vocab, seed=2)
    for step in range(6):
        jb, tb = jsrc.next_batch(), tsrc.next_batch()
        for key in jb:
            np.testing.assert_array_equal(jb[key], tb[key])
        jparams, jstate, jm = jstep(jparams, jstate,
                                    jax.tree.map(jnp.asarray, jb))
        tparams, tstate, tm = tstep(tparams, tstate, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=1e-4, rtol=1e-4, err_msg=f"step {step}")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-3)
    assert tstate["step"] == int(jstate["step"]) == 6
    _assert_trees(tparams, jparams, tol=1e-3)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", [
    (2, 6, 2, 24, 24, 64, True, None),      # GQA 3
    (1, 4, 2, 20, 40, 16, True, 8),         # window, offset 20
    (2, 3, 1, 17, 17, 20, True, None),      # smollm SMOKE's D 20, ragged
    (1, 4, 4, 16, 30, 16, False, None),     # full, MHA
])
@pytest.mark.parametrize("use_lse", [False, True])
def test_attention_bwd_plain_matches_jax_vjp(b, hq, hkv, sq, skv, d, causal,
                                             window, use_lse):
    """``flash_attention_bwd_plain`` against ``jax.vjp`` of the blockwise jnp
    attention the reference trains through (chunks of 16, so several kv
    blocks and, at 17, 20 and 30 rows, a padded tail); with ``use_lse`` it
    takes P from the plain forward's log-sum-exp, as the bf16 kernel does,
    and equals itself without it."""
    rng = np.random.default_rng(6)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    do = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    off = skv - sq

    def fwd(q, k, v):
        return jops.flash_attention(q, k, v, causal=causal, window=window,
                                    offset=off, impl="jnp", q_chunk=16,
                                    kv_chunk=16)

    o, vjp = jax.vjp(fwd, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    args = [torch.from_numpy(x) for x in (q, k, v, np.array(o), do)]
    lse = None
    if use_lse:
        _, lse = flash_attention_plain(*args[:3], causal, window, off,
                                       return_lse=True)
    got = flash_attention_bwd_plain(*args, causal, window, off, lse=lse)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=2e-5,
                                   rtol=2e-5)
    if use_lse:
        for g, w in zip(got, flash_attention_bwd_plain(*args, causal, window,
                                                       off)):
            np.testing.assert_allclose(_np(g), _np(w), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("shape", [(64, 128), (2, 7, 60), (8, 20)])
def test_rmsnorm_bwd_plain_matches_jax_vjp(shape):
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape).astype(np.float32)
    s = rng.standard_normal(shape[-1]).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    _, vjp = jax.vjp(lambda x, s: jref.rmsnorm_ref(x, s, 1e-5),
                     jnp.asarray(x), jnp.asarray(s))
    want_dx, want_ds = vjp(jnp.asarray(dy))
    dx, ds = rmsnorm_bwd_plain(torch.from_numpy(x), torch.from_numpy(s),
                               torch.from_numpy(dy), 1e-5)
    np.testing.assert_allclose(_np(dx), np.asarray(want_dx), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(_np(ds), np.asarray(want_ds), atol=2e-5,
                               rtol=2e-5)


def test_checkpoints_cross_between_reference_and_port(tmp_path):
    """A reference checkpoint of (params, AdamW state) restores into the
    port's tree, and the port's into the reference's: same leaves, same
    order, same bits; the port's step comes back as an int."""
    jcfg, jparams, tcfg, tparams = _pair("smollm_360m", seed=3)
    jo, to = jopt.adamw(1e-3), topt.adamw(1e-3)
    jstate = jo.init(jparams)
    jstate = dict(jstate, step=jnp.int32(7),
                  mu=jax.tree.map(lambda a: a + 0.5, jstate["mu"]))
    jckpt.save(str(tmp_path / "ref"), 7, (jparams, jstate),
               extra={"data": {"step": 7}})
    target = (tparams, to.init(tparams))
    assert tckpt.latest_step(str(tmp_path / "ref")) == 7
    (rp, rs), extra = tckpt.restore(str(tmp_path / "ref"), 7, target)
    assert extra == {"data": {"step": 7}} and rs["step"] == 7
    _assert_trees(rp, jparams, tol=0)
    _assert_trees(rs["mu"], jstate["mu"], tol=0)

    tstate = dict(to.init(tparams), step=5)
    tstate["nu"] = tree_map(lambda a: a + 2.0, tstate["nu"])
    tckpt.save(str(tmp_path / "port"), 5, (tparams, tstate), extra={"x": 1})
    (jp2, js2), jextra = jckpt.restore(str(tmp_path / "port"), 5,
                                       (jparams, jstate))
    assert jextra == {"x": 1} and int(js2["step"]) == 5
    _assert_trees(tparams, jp2, tol=0)
    _assert_trees(tstate["nu"], js2["nu"], tol=0)


def test_checkpoint_keeps_bf16_bits_and_refuses_corruption(tmp_path):
    tree = {"w": torch.randn(3, 5).to(torch.bfloat16), "n": 3,
            "s": torch.arange(4, dtype=torch.float32)}
    saver = tckpt.AsyncCheckpointer()
    saver.save(str(tmp_path), 1, tree)
    saver.join()
    got, _ = tckpt.restore(str(tmp_path), 1, tree)
    assert got["n"] == 3 and got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], tree["w"]) and torch.equal(got["s"], tree["s"])
    leaf = tmp_path / "step_00000001" / "leaf_00002.npy"   # sorted: n, s, w
    arr = np.load(leaf)
    arr.flat[0] ^= 1
    np.save(leaf, arr)
    with pytest.raises(ValueError, match="crc"):
        tckpt.restore(str(tmp_path), 1, tree)
    with pytest.raises(ValueError, match="uncommitted"):
        tckpt.restore(str(tmp_path), 2, tree)


def test_train_on_cpu_runs_and_resumes(tmp_path):
    """Six SMOKE steps through ``train()`` with finite losses and a
    checkpoint every 3; a second call with the same directory resumes at
    the last committed step (6) and runs the two steps left of 8."""
    out = train("smollm_360m", steps=6, batch=2, seq=16,
                ckpt_dir=str(tmp_path), ckpt_every=3, device="cpu")
    assert len(out["losses"]) == 6 and np.isfinite(out["losses"]).all()
    assert out["opt_state"]["step"] == 6 and out["start_step"] == 0
    assert tckpt.latest_step(str(tmp_path)) == 6
    again = train("smollm_360m", steps=8, batch=2, seq=16,
                  ckpt_dir=str(tmp_path), ckpt_every=3, device="cpu")
    assert again["start_step"] == 6 and len(again["losses"]) == 2
    assert again["opt_state"]["step"] == 8


def test_train_refuses_what_the_port_does_not_run():
    """A mesh still raises; whisper (the audio frontend and the
    encoder-decoder) trains."""
    with pytest.raises(NotImplementedError, match="item 6"):
        train("smollm_360m", mesh_shape=(2, 1), device="cpu")
    out = train("whisper_small", smoke=True, steps=2, batch=2, seq=16,
                device="cpu")
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()


@pytest.mark.parametrize("name", ["granite_3_2b", "stablelm_3b"])
def test_new_configs_are_copies(name):
    for smoke in (False, True):
        assert dataclasses.asdict(tget(name, smoke=smoke)) == \
            dataclasses.asdict(jget(name, smoke=smoke))


def test_synthetic_batches_equal_the_reference():
    j, t = JSyntheticLM(4, 16, 256, seed=9), SyntheticLM(4, 16, 256, seed=9)
    for _ in range(3):
        jb, tb = j.next_batch(), t.next_batch()
        for key in jb:
            np.testing.assert_array_equal(jb[key], tb[key])
    assert j.state() == t.state()


def test_seq_shard_without_a_mesh_runs_plain_attention():
    """``seq_shard`` asks for context-parallel attention, which needs a mesh;
    without one the port runs plain flash attention, as the reference does."""
    jcfg, jparams, tcfg, tparams = _pair("h2o_danube_1_8b", seed=4)
    jsh = dataclasses.replace(jcfg, seq_shard=True)
    tsh = dataclasses.replace(tcfg, seq_shard=True)
    x = np.random.default_rng(8).standard_normal((2, 32, 64)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["stack"]["pos0"]["mixer"])
    tp = tree_map(lambda a: a[0], tparams["stack"]["pos0"]["mixer"])
    pos = np.arange(32)
    want = jlayers.attn_apply(jp, jnp.asarray(x), jsh, jnp.asarray(pos))
    with torch.no_grad():
        got = tlayers.attn_apply(tp, torch.from_numpy(x), tsh,
                                 torch.from_numpy(pos))
        plain = tlayers.attn_apply(tp, torch.from_numpy(x), tcfg,
                                   torch.from_numpy(pos))
    assert torch.equal(got, plain)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
