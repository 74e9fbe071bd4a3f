"""The port's MoE, MLA and DeepSeek prefix against the JAX package, on the
CPU.

The reference's functions run on numpy-seeded inputs (``default_rng``) and
on weights it initialises itself, transplanted into the port: the sorted
capacity dispatch (``_dispatch_group``) and ``moe_apply`` (one and two
dispatch groups, float32 and bf16 combine, a shared expert, an expert that
every token picks so that copies are dropped, the aux loss), MLA prefill and
both decode forms with their compressed caches, the flash-attention plain
version at MLA's head dims (24 and 192) against ``_flash_jnp`` and the
Pallas kernel in interpret mode, and the DeepSeek, Qwen3-MoE and Jamba (with
its real MoE layers) SMOKE models: init tree, prefill logits, 24 decode
steps with every cache leaf, and greedy serving tokens. Beside them: the
per-kernel head-dim sets, and the sliced draws and layer-by-layer stacking
that let the full-width init fit one card.

Top-k routing can flip on a near-tie between the two sides' rounding; every
MoE comparison first asserts that both chose the same experts and, if not,
reports the top-k margin of the token that flipped.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ops import _flash_jnp
from repro.launch.serve import Request as JRequest
from repro.launch.serve import serve_batch as jserve_batch
from repro.launch.steps import make_prefill_step as jmake_prefill_step
from repro.models import layers as jL
from repro.models import model_api as jmodel_api
from repro.models import moe as jM
from repro.models.config import ModelConfig as JConfig
from repro_torch.configs import get as tget
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.launch.serve import Request, serve_batch
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import layers as L
from repro_torch.models import model_api, moe, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import param_count, tree_leaves, tree_map
from repro_torch.weights import from_jax_params

ARCHS = ["deepseek_v3_671b", "qwen3_moe_235b_a22b", "jamba_1_5_large_398b"]
# models: float32 logits of order 1 after a few layers (summation order only)
TOL = 5e-5
# kernels' plain versions: float32 summation order; bf16 one rounding
KTOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _t(tree):
    """A JAX tree as torch CPU tensors of the same dtypes."""
    def conv(a):
        a = np.asarray(a)
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(a.astype(np.float32)).bfloat16()
        return torch.from_numpy(np.array(a))
    return jax.tree.map(conv, tree)


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol,
                               err_msg=msg)


def _same_choices(probs_t, probs_j, k):
    """Both sides route every token to the same top-k experts; on a flip,
    the message gives the token and its top-k margin."""
    pt, pj = _np(probs_t), _np(probs_j)
    it = np.sort(np.argsort(-pt, axis=-1, kind="stable")[:, :k], axis=-1)
    ij = np.sort(np.argsort(-pj, axis=-1, kind="stable")[:, :k], axis=-1)
    bad = np.nonzero((it != ij).any(-1))[0]
    if len(bad):
        s = -np.sort(-pj[bad[0]])
        pytest.fail(f"token {bad[0]}: experts {it[bad[0]]} against {ij[bad[0]]},"
                    f" top-{k} margin {s[k - 1] - s[k]:.3e}")


def _moe_cfg(**over):
    base = dict(name="moe-test", family="moe", n_layers=2, d_model=32,
                n_heads=2, n_kv_heads=2, d_ff=64, vocab=64,
                period=(("attn", "moe"),), n_experts=8, top_k=2, d_expert=16,
                dtype="float32")
    base.update(over)
    return JConfig(**base), ModelConfig(**base)


def _overload(p, x):
    """Expert 3 takes every token first: x gets a common positive offset and
    the router's column 3 a large weight along it."""
    p = dict(p)
    router = np.array(p["router"])
    router[:, 3] = 0.5
    p["router"] = router
    return p, x + 2.0


@pytest.mark.parametrize("overloaded", [False, True])
def test_dispatch_group_matches_jax(overloaded):
    jcfg, _ = _moe_cfg()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((12, 32), np.float32)
    p = jax.tree.map(np.asarray, jM.moe_init(jax.random.PRNGKey(0), jcfg,
                                             jnp.float32))
    if overloaded:
        p, x = _overload(p, x)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ p["router"], axis=-1))
    cap = moe.capacity(tget("qwen3_moe_235b_a22b", smoke=True), 12)
    assert cap == int(max(1, -(-12 * 2 * 1.25 // 8)))
    xg, tok, wgt = jM._dispatch_group(jnp.asarray(x), jnp.asarray(probs), 2,
                                      8, cap)
    txg, ttok, twgt, slot, w = moe._dispatch_group(
        torch.from_numpy(x), torch.from_numpy(probs.copy()), 2, 8, cap)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(tok))
    np.testing.assert_array_equal(_np(txg), _np(xg))
    np.testing.assert_array_equal(_np(twgt), _np(wgt))
    # every kept copy's slot holds its token, and its weight is the one the
    # window holds there; dropped copies weigh 0
    kept = w.numpy() > 0
    assert kept.sum() == int((np.asarray(wgt) > 0).sum())
    flat_tok = ttok.reshape(-1).numpy()[slot.numpy()]
    assert (flat_tok[kept] == np.repeat(np.arange(12)[:, None], 2, 1)[kept]).all()
    np.testing.assert_array_equal(
        twgt.reshape(-1).numpy()[slot.numpy()][kept], w.numpy()[kept])
    # copies beyond an expert's capacity are dropped
    chosen = np.argsort(-probs, axis=-1, kind="stable")[:, :2]
    sizes = np.bincount(chosen.reshape(-1), minlength=8)
    assert (~kept).sum() == np.maximum(sizes - cap, 0).sum()
    if overloaded:
        assert sizes[3] == 12 and (np.asarray(wgt)[3] > 0).sum() == cap < 12


@pytest.mark.parametrize("groups,combine,shared,overloaded", [
    (1, "float32", 0, False),
    (2, "float32", 0, False),
    (1, "bfloat16", 1, False),
    (2, "bfloat16", 1, False),
    (1, "float32", 1, True),
    (2, "float32", 0, True),
])
def test_moe_apply_matches_jax(groups, combine, shared, overloaded):
    jcfg, tcfg = _moe_cfg(moe_dispatch_groups=groups,
                          moe_combine_dtype=combine, n_shared_experts=shared)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 32), np.float32)
    p = jax.tree.map(np.asarray, jM.moe_init(jax.random.PRNGKey(1), jcfg,
                                             jnp.float32))
    if overloaded:
        p, x = _overload(p, x)
    want, aux = jM.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg)
    tp = _t(p)
    xt = torch.from_numpy(x)
    _same_choices(torch.softmax(xt.reshape(12, 32) @ tp["router"], -1),
                  jax.nn.softmax(jnp.asarray(x).reshape(12, 32) @ p["router"],
                                 axis=-1), 2)
    got, taux = moe.moe_apply(tp, xt, tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 6, 32)
    _close(got, want, KTOL["bfloat16"] if combine == "bfloat16" else TOL)
    assert taux.dtype == torch.float32 and taux.dim() == 0
    _close(taux, aux)
    if overloaded:
        # one expert at capacity: 12 - cap copies dropped in each group
        cap = moe.capacity(tcfg, 12)
        assert cap * groups < 12


def test_moe_apply_in_bf16_matches_jax():
    """A bf16 model (experts bf16, router float32): the expert products in
    bf16 on both sides."""
    jcfg, tcfg = _moe_cfg(dtype="bfloat16", n_shared_experts=1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 32), np.float32)
    p = jM.moe_init(jax.random.PRNGKey(2), jcfg, jnp.bfloat16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want, aux = jM.moe_apply(p, xj, jcfg)
    tp = _t(p)
    xt = torch.from_numpy(x).bfloat16()
    assert tp["experts"]["gate"].dtype == torch.bfloat16
    assert tp["router"].dtype == torch.float32
    _same_choices(torch.softmax(xt.float().reshape(8, 32) @ tp["router"], -1),
                  jax.nn.softmax(xj.astype(jnp.float32).reshape(8, 32)
                                 @ p["router"], axis=-1), 2)
    got, taux = moe.moe_apply(tp, xt, tcfg)
    assert got.dtype == torch.bfloat16
    _close(got, want, KTOL["bfloat16"])
    _close(taux, aux)


def test_moe_init_matches_reference_shapes():
    jcfg, tcfg = _moe_cfg(n_shared_experts=1)
    tp = moe.moe_init(torch.Generator().manual_seed(0), tcfg, torch.float32)
    jp = jM.moe_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        t = tp
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape and str(t.dtype)[6:] == str(leaf.dtype)
        np.testing.assert_allclose(float(t.std()), float(jnp.std(leaf)),
                                   rtol=0.25)


# --------------------------------------------------------------------------
# MLA
# --------------------------------------------------------------------------

def _mla_pair(seed=0, **over):
    jcfg = dataclasses.replace(jget("deepseek_v3_671b", smoke=True), **over)
    tcfg = dataclasses.replace(tget("deepseek_v3_671b", smoke=True), **over)
    jp = jL.mla_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jcfg, jp, tcfg, _t(jp)


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_mla_apply_matches_jax(impl):
    jcfg, jp, tcfg, tp = _mla_pair(attn_impl=impl)
    x = np.random.default_rng(3).standard_normal((2, 24, 64), np.float32)
    want = jL.mla_apply(jp, jnp.asarray(x), jcfg, jnp.arange(24))
    got = L.mla_apply(tp, torch.from_numpy(x), tcfg, torch.arange(24))
    _close(got, want)


@pytest.mark.parametrize("absorbed", [True, False])
def test_mla_decode_matches_jax(absorbed):
    """16 steps of one-token decode: output and both compressed cache
    leaves after each, the port's cache written in place at slot pos
    only."""
    jcfg, jp, tcfg, tp = _mla_pair(seed=4)
    x = np.random.default_rng(4).standard_normal((16, 2, 64), np.float32)
    jc = jL.mla_make_cache(jcfg, 2, 20, jnp.float32)
    tc = L.mla_make_cache(tcfg, 2, 20, torch.float32)
    for t in range(16):
        want, jc = jL.mla_decode(jp, jnp.asarray(x[t]), jc, jnp.int32(t), jcfg,
                                 absorbed=absorbed)
        before = tree_map(lambda a: a.clone(), tc)
        got, out = L.mla_decode(tp, torch.from_numpy(x[t]), tc,
                                torch.tensor(t, dtype=torch.int32), tcfg,
                                absorbed=absorbed)
        assert out is tc
        _close(got, want, msg=f"step {t}")
        for leaf in ("c_kv", "k_rope"):
            _close(tc[leaf], jc[leaf], msg=f"step {t}: {leaf}")
            keep = torch.ones(20, dtype=torch.bool)
            keep[t] = False
            assert torch.equal(tc[leaf][:, keep], before[leaf][:, keep])


def test_mla_absorbed_equals_decompressed():
    _, _, tcfg, tp = _mla_pair(seed=5)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (12, 3, 64), np.float32))
    caches = [L.mla_make_cache(tcfg, 3, 12, torch.float32) for _ in range(2)]
    for t in range(12):
        pos = torch.tensor(t)
        a, _ = L.mla_decode(tp, x[t], caches[0], pos, tcfg, absorbed=True)
        b, _ = L.mla_decode(tp, x[t], caches[1], pos, tcfg, absorbed=False)
        _close(a, b, msg=f"step {t}")
    for leaf in ("c_kv", "k_rope"):
        assert torch.equal(caches[0][leaf], caches[1][leaf])


def test_mla_decode_matches_its_prefill():
    """Prefill over S tokens and S decode steps give the same outputs (the
    decompressed flash path against the absorbed latent path)."""
    _, _, tcfg, tp = _mla_pair(seed=6)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 10, 64), np.float32))
    want = L.mla_apply(tp, x, tcfg, torch.arange(10))
    cache = L.mla_make_cache(tcfg, 2, 10, torch.float32)
    for t in range(10):
        got, cache = L.mla_decode(tp, x[:, t], cache, torch.tensor(t), tcfg)
        _close(got, want[:, t], msg=f"step {t}")


# --------------------------------------------------------------------------
# flash attention at MLA's head dims
# --------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,sq,skv,d,causal,window", [
    (2, 4, 24, 24, 24, True, None),          # DeepSeek SMOKE: 16 + 8
    (1, 2, 64, 64, 192, True, None),         # DeepSeek-V3: 128 + 64
    (1, 2, 32, 64, 192, True, 40),           # window and offset 32
    (1, 2, 64, 64, 24, False, None),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_at_mla_head_dims_matches_jax(b, h, sq, skv, d, causal,
                                                  window, dtype):
    rng = np.random.default_rng(7)
    arrs = [rng.standard_normal((b, h, s, d), np.float32)
            for s in (sq, skv, skv)]
    jt = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    off, scale = skv - sq, 192 ** -0.5
    want = _flash_jnp(*jt, causal, window, off, scale, 512, 1024)
    pallas = flash_attention_pallas(*jt, causal=causal, window=window,
                                    offset=off, scale=scale, q_blk=32,
                                    kv_blk=32)
    for got in (flash_attention_plain(*tt, causal, window, off, scale),
                ops.flash_attention(*tt, causal=causal, window=window,
                                    offset=off, scale=scale)):
        assert got.dtype == tt[0].dtype and got.shape == tt[0].shape
        _close(got, want, KTOL[dtype])
        _close(got, pallas, KTOL[dtype])


# --------------------------------------------------------------------------
# the SMOKE models
# --------------------------------------------------------------------------

def _pair(name, seed=0, **over):
    jcfg = dataclasses.replace(jget(name, smoke=True), **over)
    tcfg = dataclasses.replace(tget(name, smoke=True), **over)
    jparams = jax.jit(jmodel_api(jcfg).init, static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.mark.parametrize("name", ["deepseek_v3_671b", "qwen3_moe_235b_a22b"])
def test_configs_are_copies(name):
    for smoke in (False, True):
        assert dataclasses.asdict(tget(name, smoke=smoke)) == \
            dataclasses.asdict(jget(name, smoke=smoke))


@pytest.mark.parametrize("name", ARCHS)
def test_init_matches_reference_tree(name):
    """Same leaves (the DeepSeek prefix list and MTP module included),
    shapes, dtypes and scales as the reference's init."""
    cfg = tget(name, smoke=True)
    params = transformer.init(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    jcfg = jget(name, smoke=True)
    jparams = jax.jit(jmodel_api(jcfg).init, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat_j) == len(tree_leaves(params))
    for path, leaf in flat_j:
        t = params
        for p in path:
            t = t[p.idx if hasattr(p, "idx") else p.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).split(".")[1] == str(leaf.dtype), path
        np.testing.assert_allclose(float(t.float().std()),
                                   float(jnp.std(leaf)), rtol=0.25, atol=1e-6)
    assert param_count(params) == sum(x.size for x in jax.tree.leaves(jparams))
    if name == "deepseek_v3_671b":
        assert len(params["prefix"]) == cfg.first_k_dense and "mtp" in params


def test_from_jax_params_checks_the_prefix_list():
    jcfg, tcfg = jget("deepseek_v3_671b", smoke=True), \
        tget("deepseek_v3_671b", smoke=True)
    tree = jax.tree.map(np.asarray, jmodel_api(jcfg).init(
        jax.random.PRNGKey(0), jcfg))
    with pytest.raises(ValueError, match="prefix: expected a list of 1"):
        from_jax_params(dict(tree, prefix=tree["prefix"] * 2), tcfg,
                        device="cpu")
    with pytest.raises(ValueError, match="prefix: expected a list"):
        from_jax_params(dict(tree, prefix=tree["prefix"][0]), tcfg,
                        device="cpu")


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_prefill_logits_match_jax(name, impl):
    jcfg, jparams, tcfg, tparams = _pair(name, attn_impl=impl)
    toks = np.random.default_rng(8).integers(0, jcfg.vocab, (2, 24),
                                             dtype=np.int32)
    want = jmake_prefill_step(jcfg)(jparams, {"inputs": jnp.asarray(toks)})
    got = make_prefill_step(tcfg, device="cpu")(tparams, {"inputs": toks})
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, jcfg.vocab)
    _close(got, want)


def _cache_leaves(cache, path=""):
    if isinstance(cache, dict):
        for k in sorted(cache):
            yield from _cache_leaves(cache[k], f"{path}/{k}")
    elif isinstance(cache, (list, tuple)):
        for i, c in enumerate(cache):
            yield from _cache_leaves(c, f"{path}/{i}")
    else:
        yield path, cache


@pytest.mark.parametrize("name", ARCHS)
def test_decode_steps_match_jax(name):
    """24 teacher-forced decode steps (position a 0-d int32 tensor): logits
    and every cache leaf (the prefix's MLA caches, the stack's compressed,
    K/V and Mamba caches) after each step against the reference's."""
    jcfg, jparams, tcfg, tparams = _pair(name, seed=1)
    japi, tapi = jmodel_api(jcfg), model_api(tcfg)
    jstep = jax.jit(japi.decode_step, static_argnums=4)
    toks = np.random.default_rng(9).integers(0, jcfg.vocab, (2, 24),
                                             dtype=np.int32)
    jcache = japi.init_cache(jcfg, 2, max_len=32)
    tcache = tapi.init_cache(tcfg, 2, max_len=32, device="cpu")
    for t in range(24):
        jlogits, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, t]),
                                jnp.int32(t), jcfg)
        with torch.no_grad():
            tlogits, out = tapi.decode_step(
                tparams, tcache, torch.from_numpy(toks[:, t]),
                torch.tensor(t, dtype=torch.int32), tcfg)
        assert out is tcache
        _close(tlogits, jlogits, msg=f"step {t}")
        got, want = dict(_cache_leaves(tcache)), dict(_cache_leaves(jcache))
        assert set(got) == set(want)
        for path, val in want.items():
            _close(got[path], val, msg=f"step {t}: cache {path}")


@pytest.mark.parametrize("name", ARCHS)
def test_serve_batch_greedy_tokens_match_jax(name):
    jcfg, jparams, tcfg, tparams = _pair(name, seed=2)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, jcfg.vocab, n, dtype=np.int32)
               for n in (5, 3, 7)]
    jreqs, _ = jserve_batch(jcfg, jparams,
                            [JRequest(i, p, 12) for i, p in enumerate(prompts)],
                            max_len=24)
    treqs, _ = serve_batch(tcfg, tparams,
                           [Request(i, p, 12) for i, p in enumerate(prompts)],
                           max_len=24, device="cpu")
    for j, t in zip(jreqs, treqs):
        assert t.out.dtype == np.int32 and t.out.shape == (12,)
        np.testing.assert_array_equal(t.out, j.out)


def test_forward_sums_aux_over_every_moe_layer():
    """The aux loss of ``forward`` is the sum over the stack's MoE blocks,
    as the reference's (the prefix's FFNs are dense)."""
    jcfg, jparams, tcfg, tparams = _pair("deepseek_v3_671b", seed=3)
    x = np.random.default_rng(11).standard_normal((2, 8, 64), np.float32)
    from repro.models import transformer as jT
    _, jaux = jT.forward(jparams, jnp.asarray(x), jcfg, jnp.arange(8))
    with torch.no_grad():
        _, aux = transformer.forward(tparams, torch.from_numpy(x), tcfg,
                                     torch.arange(8))
    assert float(aux) > 0
    _close(aux, jaux)


def test_each_attention_kernel_has_its_own_head_dims():
    """MLA's head dims widen the flash forward and backward only: both get
    past the head dim at 24 (float32) and 192 to the device check (here on
    CPU tensors), a bf16 row of 20 or 24 has no instance in either and
    raises NotImplementedError before the device, and decode attention has
    no 192."""
    from repro_torch.kernels._checks import require_head_dim
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    n = flash_attention_bwd_cuda.launches, flash_attention_cuda.launches
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros(1, 2, 8, 192, dtype=dtype)
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention_bwd_cuda(q, q, q, q, q)
        with pytest.raises(NotImplementedError, match="head dim 192.*K2"):
            require_head_dim("decode_attention", 192, dtype)
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention_cuda(q, q, q)
    q = torch.zeros(1, 2, 8, 24)
    for fn in (flash_attention_cuda, flash_attention_bwd_cuda):
        args = (q,) * (5 if fn is flash_attention_bwd_cuda else 3)
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)
        for d in (20, 24):
            qb = torch.zeros(1, 2, 8, d, dtype=torch.bfloat16)
            with pytest.raises(NotImplementedError, match=f"head dim {d}.*K1"):
                fn(*(qb,) * len(args))
    assert (flash_attention_bwd_cuda.launches, flash_attention_cuda.launches) == n


def test_full_width_draws_keep_to_one_layer_at_a_time(monkeypatch):
    """What lets DeepSeek-V3's 26.6 B params be drawn on one card: a leaf
    above ``_DRAW_LIMIT`` elements is drawn a slice of its leading axis at a
    time (every slice drawn, the scale kept), and ``stack_init`` fills a
    preallocated stack layer by layer with the values ``torch.stack`` of the
    same draws would hold."""
    from repro_torch.models import module
    monkeypatch.setattr(module, "_DRAW_LIMIT", 1000)
    monkeypatch.setattr(module, "_DRAW_SLICE", 300)
    t = module.normal_init(torch.Generator().manual_seed(0), (16, 40, 5), 0.5,
                           torch.float32)
    assert t.shape == (16, 40, 5) and t.dtype == torch.float32
    assert bool((t.reshape(16, -1).abs().sum(-1) > 0).all())
    np.testing.assert_allclose(float(t.std()), 0.5, rtol=0.05)
    small = module.normal_init(torch.Generator().manual_seed(0), (8, 5), 0.5)
    assert small.dtype == torch.bfloat16 and small.shape == (8, 5)

    def layer(g):
        return {"w": module.normal_init(g, (3, 4), 1.0, torch.float32),
                "b": [module.normal_init(g, (2,), 1.0, torch.float32)]}

    got = module.stack_init(layer, torch.Generator().manual_seed(1), 3)
    g = torch.Generator().manual_seed(1)
    draws = [layer(g) for _ in range(3)]
    assert torch.equal(got["w"], torch.stack([d["w"] for d in draws]))
    assert torch.equal(got["b"][0], torch.stack([d["b"][0] for d in draws]))
