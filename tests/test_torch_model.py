"""The port's models, on the CPU, against the JAX model.

JAX SMOKE parameters (``jax.random.PRNGKey``) are transplanted into the port
with ``from_jax_params``; prefill logits, decode-step logits and caches (past
the sliding window on h2o-danube, which wraps its ring buffer; the Mamba and
xLSTM recurrent states of jamba and xlstm) and greedy serving tokens must
match. Jamba runs with a dense SwiGLU in place of each MoE FFN, the same
replacement on both sides; its real MoE layers, DeepSeek's MLA and prefix
and Qwen3-MoE are held in ``tests/test_torch_moe.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.launch.serve import Request as JRequest
from repro.launch.serve import serve_batch as jserve_batch
from repro.launch.steps import make_prefill_step as jmake_prefill_step
from repro.models import model_api as jmodel_api
from repro_torch.configs import get as tget
from repro_torch.launch.serve import Request, serve_batch
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import encdec, model_api, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import param_count, tree_leaves, tree_map
from repro_torch.weights import from_jax_params

ARCHS = ["smollm_360m", "h2o_danube_1_8b", "jamba_1_5_large_398b",
         "xlstm_125m"]
# float32 logits of order 1 after two to eight layers; the two sides differ
# only in summation order (observed ~2e-6, ~8e-6 on jamba's 8 layers)
TOL = 5e-5
# prompt lengths: mLSTM's chunk (16 in xlstm SMOKE) must divide the prompt
SEQ = {"xlstm_125m": 32}


def _ported(name):
    """Overrides that keep ``name`` on ported blocks: Jamba's period with a
    dense SwiGLU in every FFN, one period deep (8 layers), no experts."""
    if name != "jamba_1_5_large_398b":
        return {}
    return dict(n_layers=8, n_experts=0, top_k=0, d_expert=0,
                period=tuple((m, "mlp") for m, _ in jget(name).period))


def _pair(name, seed=0, **over):
    over = {**_ported(name), **over}
    jcfg = dataclasses.replace(jget(name, smoke=True), **over)
    tcfg = dataclasses.replace(tget(name, smoke=True), **over)
    jparams = jmodel_api(jcfg).init(jax.random.PRNGKey(seed), jcfg)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.mark.parametrize("name", ARCHS)
def test_configs_are_copies(name):
    for smoke in (False, True):
        assert dataclasses.asdict(tget(name, smoke=smoke)) == \
            dataclasses.asdict(jget(name, smoke=smoke))


@pytest.mark.parametrize("name", ARCHS)
def test_init_matches_reference_tree(name):
    """Same keys, shapes, dtypes and scales as the reference's init."""
    cfg = dataclasses.replace(tget(name, smoke=True), **_ported(name))
    params = transformer.init(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    jcfg = dataclasses.replace(jget(name, smoke=True), **_ported(name))
    jparams = jmodel_api(jcfg).init(jax.random.PRNGKey(0), jcfg)
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat_j) == len(tree_leaves(params))
    for path, leaf in flat_j:
        t = params
        for p in path:
            t = t[p.key]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).split(".")[1] == str(leaf.dtype)
        np.testing.assert_allclose(float(t.float().std()),
                                   float(jnp.std(leaf)), rtol=0.25, atol=1e-6)
    assert param_count(params) == sum(x.size for x in jax.tree.leaves(jparams))


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_prefill_logits_match_jax(name, impl):
    jcfg, jparams, tcfg, tparams = _pair(name, attn_impl=impl)
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab, (2, SEQ.get(name, 24)), dtype=np.int32)
    want = jmake_prefill_step(jcfg)(jparams, {"inputs": jnp.asarray(toks)})
    got = make_prefill_step(tcfg, device="cpu")(tparams, {"inputs": toks})
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, jcfg.vocab)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_steps_match_jax(name):
    """24 teacher-forced decode steps; danube's window of 16 wraps its ring
    buffer. The position is a 0-d int32 tensor on both sides (the
    reference's traced ``jnp.int32(t)``), as the port's CUDA graph takes
    it. The port updates its cache in place: after each step every cache
    leaf (K/V, Mamba conv/h, mLSTM conv/C/n/m, sLSTM h/c/n/m) is compared
    with the reference's returned cache, and the old cache is snapshotted
    to check that only slot ``pos`` of each K/V cache changed."""
    jcfg, jparams, tcfg, tparams = _pair(name, seed=1)
    japi, tapi = jmodel_api(jcfg), model_api(tcfg)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 24),
                                             dtype=np.int32)
    jcache = japi.init_cache(jcfg, 2, max_len=32)
    tcache = tapi.init_cache(tcfg, 2, max_len=32, device="cpu")
    attn = [f"pos{i}" for i, (m, _) in enumerate(tcfg.period) if m == "attn"]
    c = 16 if jcfg.window else 32
    for key in attn:
        assert tcache["stack"][key]["k"].shape[3] == c
    for t in range(24):
        jlogits, jcache = japi.decode_step(jparams, jcache,
                                           jnp.asarray(toks[:, t]),
                                           jnp.int32(t), jcfg)
        before = tree_map(lambda a: a.clone(), tcache)
        with torch.no_grad():
            tlogits, out = tapi.decode_step(
                tparams, tcache, torch.from_numpy(toks[:, t]),
                torch.tensor(t, dtype=torch.int32), tcfg)
        assert out is tcache
        np.testing.assert_allclose(_np(tlogits), _np(jlogits), atol=TOL,
                                   rtol=TOL)
        slot = t % c if jcfg.window else t
        for key in attn:
            for kv in ("k", "v"):
                new = tcache["stack"][key][kv]
                old = before["stack"][key][kv]
                keep = torch.ones(c, dtype=torch.bool)
                keep[slot] = False
                assert torch.equal(new[:, :, :, keep], old[:, :, :, keep])
        for key, layer in tcache["stack"].items():
            assert set(layer) == set(jcache["stack"][key])
            for leaf, val in layer.items():
                np.testing.assert_allclose(
                    _np(val), _np(jcache["stack"][key][leaf]), atol=TOL,
                    rtol=TOL, err_msg=f"step {t}: cache {key}/{leaf}")


@pytest.mark.parametrize("name", ARCHS)
def test_serve_batch_greedy_tokens_match_jax(name):
    jcfg, jparams, tcfg, tparams = _pair(name, seed=2)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, jcfg.vocab, n, dtype=np.int32)
               for n in (5, 3, 7)]
    jreqs, _ = jserve_batch(jcfg, jparams,
                            [JRequest(i, p, 12) for i, p in enumerate(prompts)],
                            max_len=24)
    treqs, dt = serve_batch(tcfg, tparams,
                            [Request(i, p, 12) for i, p in enumerate(prompts)],
                            max_len=24, device="cpu")
    assert dt > 0
    for j, t in zip(jreqs, treqs):
        assert t.out.dtype == np.int32 and t.out.shape == (12,)
        np.testing.assert_array_equal(t.out, j.out)


def test_decode_step_returns_argmax_and_int32():
    _, _, tcfg, tparams = _pair("smollm_360m")
    step = make_decode_step(tcfg, device="cpu")
    cache = model_api(tcfg).init_cache(tcfg, 2, 8, device="cpu")
    nxt, logits, out = step(tparams, cache, np.array([1, 2], np.int32), 0)
    assert out is cache and nxt.dtype == torch.int32
    assert torch.equal(nxt, torch.argmax(logits, -1).to(torch.int32))


def test_from_jax_params_rejects_mismatch():
    jcfg = jget("smollm_360m", smoke=True)
    tcfg = tget("smollm_360m", smoke=True)
    tree = jax.tree.map(np.asarray, jmodel_api(jcfg).init(
        jax.random.PRNGKey(0), jcfg))
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="missing keys"):
        from_jax_params(missing, tcfg, device="cpu")
    extra = dict(tree, head=np.zeros((60, 256), np.float32))
    with pytest.raises(ValueError, match="unexpected keys"):
        from_jax_params(extra, tcfg, device="cpu")
    bad = jax.tree.map(lambda a: a, tree)
    bad["stack"]["pos0"]["mixer"]["wq"] = np.zeros((2, 60, 61), np.float32)
    with pytest.raises(ValueError, match="wq: shape"):
        from_jax_params(bad, tcfg, device="cpu")


def test_unported_blocks_raise():
    """What raises: an encoder-decoder config in the decoder-only
    transformer (``model_api`` sends it to ``models.encdec``). MoE and MLA
    blocks and the dense prefix build at full size, on the meta device (full Jamba and
    DeepSeek-V3 are hundreds of GB), with the leaves of the reference's init
    (its shapes, by ``jax.eval_shape``); DeepSeek-V3 cut to its dense prefix
    has an empty stack. The MTP branch of the loss is ported: it runs."""
    for name in ("jamba_1_5_large_398b", "deepseek_v3_671b",
                 "qwen3_moe_235b_a22b"):
        cfg = tget(name)
        params = transformer.init(torch.Generator(), cfg, device="meta")
        assert all(t.is_meta for t in tree_leaves(params))
        jcfg = jget(name)
        shapes = jax.eval_shape(lambda k: jmodel_api(jcfg).init(k, jcfg),
                                jax.random.PRNGKey(0))
        want = jax.tree_util.tree_flatten_with_path(shapes)[0]
        assert len(want) == len(tree_leaves(params))
        for path, leaf in want:
            t = params
            for p in path:
                t = t[p.idx if hasattr(p, "idx") else p.key]
            assert tuple(t.shape) == leaf.shape, path
        cache = transformer.init_cache(cfg, 2, 16, device="meta")
        assert len(cache.get("prefix", [])) == cfg.first_k_dense
    enc = dataclasses.replace(tget("smollm_360m", smoke=True),
                              encoder_layers=1)
    assert model_api(enc).init is encdec.init
    with pytest.raises(NotImplementedError, match="models.encdec"):
        transformer.init(torch.Generator(), enc, device="meta")
    prefix = dataclasses.replace(tget("deepseek_v3_671b"), n_layers=3, mtp=False)
    params = transformer.init(torch.Generator(), prefix, device="meta")
    assert params["stack"] == {} and len(params["prefix"]) == 3
    assert transformer.init_cache(prefix, 2, 16, device="meta")["stack"] == {}
    # the MTP branch of the loss runs (its module is a period[0] block)
    mtp = dataclasses.replace(tget("smollm_360m", smoke=True), mtp=True)
    p = transformer.init(torch.Generator().manual_seed(0), mtp, device="cpu")
    toks = torch.randint(0, mtp.vocab, (2, 9), generator=torch.Generator().manual_seed(1))
    loss, metrics = model_api(mtp).loss(p, {"inputs": toks[:, :-1],
                                            "labels": toks[:, 1:]}, mtp)
    assert set(metrics) == {"ce", "aux", "tokens", "mtp"}
    torch.testing.assert_close(loss, metrics["ce"] + mtp.mtp_weight * metrics["mtp"]
                               + metrics["aux"])


def test_mamba_float32_leaves_survive_a_bf16_transplant():
    """A_log, D and dt_bias are float32 in a bf16 model on both sides, so
    the transplant carries them over exactly (a bf16 A would be rounded)."""
    jcfg, jparams, tcfg, tparams = _pair("jamba_1_5_large_398b",
                                         dtype="bfloat16")
    mamba = tparams["stack"]["pos1"]["mixer"]
    jmamba = jparams["stack"]["pos1"]["mixer"]
    assert mamba["in_proj"].dtype == torch.bfloat16
    for key in ("A_log", "D", "dt_bias"):
        assert mamba[key].dtype == torch.float32
        np.testing.assert_array_equal(mamba[key].numpy(),
                                      np.asarray(jmamba[key]))
    assert tparams["stack"]["pos0"]["mixer"]["wq"].dtype == torch.bfloat16
