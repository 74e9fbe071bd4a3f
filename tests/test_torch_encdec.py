"""The port's encoder-decoder (whisper) and vlm (llava) paths on the CPU,
against the JAX reference.

Parameters come from the reference's ``init`` and are transplanted with
``weights.from_jax_params``; inputs (frames, patches, tokens) come from
``numpy.random.default_rng``. The reference runs jitted with no mesh; where
it reaches a Pallas kernel (``attn_impl="pallas"``) the kernel runs in
interpret mode, as the JAX package's own tests run it. Tolerances, as in
``tests/test_kernels_pallas.py`` and ``tests/test_torch_train.py``:
float32 activations, logits, losses and caches to 2e-5 (absolute and
relative: the two sides differ only in summation order); each gradient
leaf to 1e-4 max|g| + 1e-6; after two AdamW steps, each leaf's update
(params after less params before) to 1e-2 of its norm (a first update
moves each weight by about lr times the sign of its gradient, which
summation order can flip where a gradient is near zero) and its first
moment to 1e-4 max|mu|.
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
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import encdec as jencdec
from repro.models import frontends as jfrontends
from repro.models import layers as jlayers
from repro.models import model_api as jmodel_api
from repro.optim import optimizers as jopt
from repro_torch.configs import get as tget
from repro_torch.launch.serve import Request, serve_batch
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.launch.train import train
from repro_torch.models import encdec, frontends, layers, model_api
from repro_torch.models.module import param_count, tree_leaves, tree_map
from repro_torch.optim import optimizers as topt
from repro_torch.weights import from_jax_opt_state, from_jax_params

TOL = 2e-5
WHISPER, LLAVA = "whisper_small", "llava_next_mistral_7b"


def _pair(name, seed=0, **over):
    jcfg = dataclasses.replace(jget(name, smoke=True), **over)
    tcfg = dataclasses.replace(tget(name, smoke=True), **over)
    jparams = jax.jit(jmodel_api(jcfg).init, static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol,
                               err_msg=msg)


def _frames(cfg, b, seed=0):
    return (np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed + 100).integers(0, cfg.vocab, (b, s),
                                                      dtype=np.int32)


def _at(tree, path):
    for p in path:
        tree = tree[p.key if hasattr(p, "key") else p.idx]
    return tree


@pytest.mark.parametrize("name", [WHISPER, LLAVA])
def test_configs_are_copies(name):
    for smoke in (False, True):
        assert dataclasses.asdict(tget(name, smoke=smoke)) == \
            dataclasses.asdict(jget(name, smoke=smoke))
    assert tget(name).family == {WHISPER: "audio", LLAVA: "vlm"}[name]


def test_init_matches_reference_tree():
    """``model_api(cfg).init`` of whisper SMOKE: the reference's keys,
    shapes and dtypes with its scales; at full size (meta device) its leaf
    shapes by ``jax.eval_shape``."""
    cfg, jcfg = tget(WHISPER, smoke=True), jget(WHISPER, smoke=True)
    params = model_api(cfg).init(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    jparams = jmodel_api(jcfg).init(jax.random.PRNGKey(0), jcfg)
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == len(tree_leaves(params))
    for path, leaf in flat:
        t = _at(params, path)
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).split(".")[1] == str(leaf.dtype), path
        np.testing.assert_allclose(float(t.float().std()),
                                   float(jnp.std(leaf)), rtol=0.25, atol=1e-6)
    assert param_count(params) == sum(x.size for x in jax.tree.leaves(jparams))
    full, jfull = tget(WHISPER), jget(WHISPER)
    meta = model_api(full).init(torch.Generator(), full, device="meta")
    shapes = jax.eval_shape(lambda k: jmodel_api(jfull).init(k, jfull),
                            jax.random.PRNGKey(0))
    want = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert len(want) == len(tree_leaves(meta))
    for path, leaf in want:
        assert tuple(_at(meta, path).shape) == leaf.shape, path


def test_frontends_shapes_dtypes_and_scale():
    """The stubs' shapes and dtypes are the reference's, their scale 0.02;
    the same generator seed gives the same draws, another seed others."""
    for name, fn, jfn, n in ((WHISPER, frontends.audio_frames,
                              jfrontends.audio_frames, "encoder_seq"),
                             (LLAVA, frontends.image_patches,
                              jfrontends.image_patches, "img_tokens")):
        cfg = tget(name)
        got = fn(torch.Generator().manual_seed(3), cfg, 2, device="cpu")
        want = jax.eval_shape(lambda k: jfn(k, jget(name), 2),
                              jax.random.PRNGKey(0))
        assert tuple(got.shape) == want.shape == (2, getattr(cfg, n),
                                                  cfg.d_model)
        assert got.dtype == torch.float32 and str(want.dtype) == "float32"
        np.testing.assert_allclose(float(got.std()), 0.02, rtol=0.02)
        assert abs(float(got.mean())) < 1e-3
        again = fn(torch.Generator().manual_seed(3), cfg, 2, device="cpu")
        other = fn(torch.Generator().manual_seed(4), cfg, 2, device="cpu")
        assert torch.equal(got, again) and not torch.equal(got, other)


def test_fuse_vlm_inputs_matches_jax():
    jcfg, jparams, tcfg, tparams = _pair(LLAVA)
    patches = _frames(dataclasses.replace(tcfg, encoder_seq=tcfg.img_tokens),
                      2)
    toks = _tokens(tcfg, 2, 8)
    want = jfrontends.fuse_vlm_inputs(jparams, jnp.asarray(patches),
                                      jnp.asarray(toks), jcfg)
    got = frontends.fuse_vlm_inputs(tparams, torch.from_numpy(patches),
                                    torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_encode_matches_jax(impl):
    jcfg, jparams, tcfg, tparams = _pair(WHISPER, attn_impl=impl)
    frames = _frames(tcfg, 2)
    want = jax.jit(jencdec.encode, static_argnums=2)(
        jparams, jnp.asarray(frames), jcfg)
    with torch.no_grad():
        got = encdec.encode(tparams, torch.from_numpy(frames), tcfg)
    assert tuple(got.shape) == (2, tcfg.encoder_seq, tcfg.d_model)
    _close(got, want)


def test_cross_kv_and_cross_attn_apply_match_jax():
    """``cross_kv`` gives contiguous (L, B, Hkv, S_enc, hd) K/V, each
    layer's equal to the reference's; ``cross_attn_apply`` attends 24
    queries to 32 encoder states, every key visible."""
    jcfg, jparams, tcfg, tparams = _pair(WHISPER, seed=1)
    enc = _frames(tcfg, 2, seed=1) * 50
    jk, jv = jax.jit(jencdec.cross_kv, static_argnums=2)(
        jparams, jnp.asarray(enc), jcfg)
    tk, tv = encdec.cross_kv(tparams, torch.from_numpy(enc), tcfg)
    assert tk.shape == (tcfg.n_layers, 2, tcfg.n_kv_heads, tcfg.encoder_seq,
                        tcfg.hd) and tk.is_contiguous() and tv.is_contiguous()
    _close(tk, jk)
    _close(tv, jv)
    x = np.random.default_rng(2).standard_normal((2, 24, tcfg.d_model)
                                                 ).astype(np.float32)
    lp = jax.tree.map(lambda a: a[1], jparams["decoder"]["cross"])
    want = jlayers.cross_attn_apply(lp, jnp.asarray(x), (jk[1], jv[1]), jcfg)
    got = layers.cross_attn_apply(
        tree_map(lambda a: a[1], tparams["decoder"]["cross"]),
        torch.from_numpy(x), (tk[1], tv[1]), tcfg)
    assert tuple(got.shape) == (2, 24, tcfg.d_model)
    _close(got, want)


def test_decode_train_and_lm_loss_match_jax():
    jcfg, jparams, tcfg, tparams = _pair(WHISPER, seed=2)
    frames, toks = _frames(tcfg, 2, seed=2), _tokens(tcfg, 2, 25, seed=2)
    enc = jax.jit(jencdec.encode, static_argnums=2)(
        jparams, jnp.asarray(frames), jcfg)
    want = jax.jit(jencdec.decode_train, static_argnums=3)(
        jparams, enc, jnp.asarray(toks[:, :-1]), jcfg)
    batch = {"frames": frames, "inputs": toks[:, :-1], "labels": toks[:, 1:]}
    wl, wm = jax.jit(jencdec.lm_loss, static_argnums=2)(
        jparams, jax.tree.map(jnp.asarray, batch), jcfg)
    with torch.no_grad():
        got = encdec.decode_train(tparams, torch.from_numpy(np.array(enc)),
                                  torch.from_numpy(toks[:, :-1]), tcfg)
        gl, gm = model_api(tcfg).loss(
            tparams, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    _close(got, want)
    assert gl.dtype == torch.float32 and gl.shape == ()
    assert set(gm) == set(wm) == {"ce", "tokens"}
    _close(gl, wl)
    for key in wm:
        _close(gm[key], wm[key])


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("name", [WHISPER, LLAVA])
def test_prefill_matches_jax(name, impl):
    """``make_prefill_step``: whisper's enc-dec branch (frames + tokens) and
    llava's ``embeds`` branch (patches fused with the text's embedding)."""
    jcfg, jparams, tcfg, tparams = _pair(name, seed=3, attn_impl=impl)
    toks = _tokens(tcfg, 2, 12, seed=3)
    if name == WHISPER:
        batch = {"frames": _frames(tcfg, 2, seed=3), "inputs": toks}
    else:
        patches = np.random.default_rng(3).standard_normal(
            (2, tcfg.img_tokens, tcfg.d_model)).astype(np.float32) * 0.02
        fused = jfrontends.fuse_vlm_inputs(jparams, jnp.asarray(patches),
                                           jnp.asarray(toks), jcfg)
        batch = {"embeds": np.array(fused)}
    want = jax.jit(jmake_prefill_step(jcfg))(jparams,
                                            jax.tree.map(jnp.asarray, batch))
    got = make_prefill_step(tcfg, device="cpu")(tparams, batch)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, tcfg.vocab)
    _close(got, want)


@pytest.mark.parametrize("with_enc", [True, False])
def test_decode_steps_match_jax(with_enc):
    """24 teacher-forced decode steps from ``init_cache`` with the encoder
    states (real cross K/V) or without (zeros, as the server leaves them);
    the position a 0-d int32 tensor on both sides. After each step the
    logits and every cache leaf (self K/V of each layer, cross K/V) equal
    the reference's; the port writes its self caches in place, only at slot
    ``pos``, and leaves the cross K/V as they were."""
    jcfg, jparams, tcfg, tparams = _pair(WHISPER, seed=4)
    japi, tapi = jmodel_api(jcfg), model_api(tcfg)
    toks = _tokens(tcfg, 2, 24, seed=4)
    if with_enc:
        frames = _frames(tcfg, 2, seed=4)
        jenc = jencdec.encode(jparams, jnp.asarray(frames), jcfg)
        jcache = japi.init_cache(jcfg, 2, 32, jenc, jparams)
        with torch.no_grad():
            tenc = encdec.encode(tparams, torch.from_numpy(frames), tcfg)
        tcache = tapi.init_cache(tcfg, 2, 32, tenc, tparams, device="cpu")
    else:
        jcache = japi.init_cache(jcfg, 2, 32)
        tcache = tapi.init_cache(tcfg, 2, 32, device="cpu")
    jstep = jax.jit(japi.decode_step, static_argnums=4)
    cross = tuple(t.clone() for t in tcache["cross"])
    for t in range(24):
        jlogits, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, t]),
                                jnp.int32(t), jcfg)
        before = tree_map(lambda a: a.clone(), tcache["self"])
        with torch.no_grad():
            tlogits, out = tapi.decode_step(
                tparams, tcache, torch.from_numpy(toks[:, t]),
                torch.tensor(t, dtype=torch.int32), tcfg)
        assert out is tcache
        _close(tlogits, jlogits, msg=f"step {t}")
        keep = torch.ones(32, dtype=torch.bool)
        keep[t] = False
        for kv in ("k", "v"):
            assert torch.equal(tcache["self"][kv][:, :, :, keep],
                               before[kv][:, :, :, keep])
            _close(tcache["self"][kv], jcache["self"][kv],
                   msg=f"step {t}: self {kv}")
        for i in range(2):
            assert torch.equal(tcache["cross"][i], cross[i])
            _close(tcache["cross"][i], jcache["cross"][i],
                   msg=f"step {t}: cross {i}")


@pytest.mark.parametrize("name", [WHISPER, LLAVA])
def test_serve_batch_tokens_match_jax(name):
    jcfg, jparams, tcfg, tparams = _pair(name, seed=5)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab, n, dtype=np.int32)
               for n in (5, 3, 7)]
    jreqs, _ = jserve_batch(jcfg, jparams,
                            [JRequest(i, p, 10) for i, p in enumerate(prompts)],
                            max_len=24)
    treqs, _ = serve_batch(tcfg, tparams,
                           [Request(i, p, 10) for i, p in enumerate(prompts)],
                           max_len=24, device="cpu")
    for j, t in zip(jreqs, treqs):
        assert t.out.dtype == np.int32 and t.out.shape == (10,)
        np.testing.assert_array_equal(t.out, j.out)


def _batch(name, cfg, jparams, seed, b=2, s=16):
    """A training batch as the reference's ``train()`` builds it: whisper
    tokens, labels and frames; llava ``embeds`` = [patches; the embedding
    of the first s - img_tokens tokens] with s labels (numpy, so both sides
    take the same bits)."""
    toks = _tokens(cfg, b, s + 1, seed=seed)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    if name == WHISPER:
        batch["frames"] = _frames(cfg, b, seed=seed)
    else:
        patches = np.random.default_rng(seed).standard_normal(
            (b, cfg.img_tokens, cfg.d_model)).astype(np.float32) * 0.02
        batch = {"embeds": np.array(jfrontends.fuse_vlm_inputs(
            jparams, jnp.asarray(patches),
            jnp.asarray(batch["inputs"][:, :s - cfg.img_tokens]), cfg)),
            "labels": batch["labels"]}
    return batch


@pytest.mark.parametrize("name", [WHISPER, LLAVA])
def test_every_gradient_leaf_matches_jax(name):
    """Every leaf of the port's autograd gradient (remat on: the layers run
    under ``torch.utils.checkpoint``) against ``jax.grad`` of the reference
    loss: |diff| <= 1e-4 max|g| + 1e-6 per leaf. On llava's ``embeds``
    batch the embedding gets no gradient (it is data to the step; the head
    is untied): zero on both sides."""
    jcfg, jparams, tcfg, tparams = _pair(name, seed=6)
    assert tcfg.remat
    batch = _batch(name, jcfg, jparams, 6)
    jgrads = jax.jit(jax.grad(lambda p: jmodel_api(jcfg).loss(
        p, jax.tree.map(jnp.asarray, batch), jcfg)[0]))(jparams)
    p = tree_map(lambda a: a.detach().requires_grad_(True), tparams)
    loss, _ = model_api(tcfg).loss(
        p, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    loss.backward()
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(flat) == len(tree_leaves(p))
    for path, want in flat:
        got = _at(p, path).grad
        got = torch.zeros_like(_at(p, path)) if got is None else got
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        tol = 1e-4 * float(np.abs(want).max()) + 1e-6
        np.testing.assert_allclose(_np(got), want, atol=tol, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
    if name == LLAVA:
        assert p["embed"].grad is None
        assert not np.asarray(jgrads["embed"]).any()


@pytest.mark.parametrize("name", [WHISPER, LLAVA])
def test_two_train_steps_match_jax(name):
    """Two steps of the port's ``make_train_step`` against the reference's,
    jitted with no mesh, from the same params and AdamW state on the same
    batches: loss and grad norm at each step, then the two steps' update of
    each param leaf and the first moment."""
    jcfg, jparams, tcfg, tparams = _pair(name, seed=7)
    sched = dict(base_lr=3e-4, warmup=1, total=2)
    jo, to = (jopt.adamw(jopt.warmup_cosine(**sched)),
              topt.adamw(topt.warmup_cosine(**sched)))
    jstate = jo.init(jparams)
    tstate = from_jax_opt_state(jax.tree.map(np.asarray, jstate), tparams,
                                device="cpu")
    jstep = jax.jit(jmake_train_step(jcfg, jo))
    tstep = make_train_step(tcfg, to, device="cpu")
    before = jax.tree.map(np.asarray, jparams)
    for step in range(2):
        batch = _batch(name, jcfg, jparams, 10 + step)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    jax.tree.map(jnp.asarray, batch))
        tparams, tstate, tm = tstep(tparams, tstate, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=1e-4, rtol=1e-4, err_msg=f"step {step}")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-3)
    assert tstate["step"] == int(jstate["step"]) == 2
    # the update itself, p_after - p_before, each leaf to 1e-2 of its norm:
    # AdamW moves a weight by about lr whatever the size of its gradient,
    # so where a gradient is within summation noise of zero the two sides
    # may move it differently; the norm holds the rest of the leaf's update
    # (one that did nothing, or a wrong rate, is off by its whole size).
    # The first moment, a running sum of gradients, to 1e-4 max|mu| as the
    # gradient leaves (llava's embedding: zero on both sides).
    for path, want in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        ref = np.asarray(want) - _at(before, path)
        got = _np(_at(tparams, path)) - _at(before, path)
        assert np.linalg.norm(got - ref) <= 1e-2 * np.linalg.norm(ref), \
            jax.tree_util.keystr(path)
    for path, want in jax.tree_util.tree_flatten_with_path(jstate["mu"])[0]:
        ref = np.asarray(want)
        err = np.abs(_np(_at(tstate["mu"], path)) - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), jax.tree_util.keystr(path)


def test_train_feeds_the_frontends():
    """``train()`` of llava SMOKE: the vlm branch feeds ``embeds`` (patches
    drawn from a generator of (seed, step), then the text's embedding), and
    the embedding's AdamW moment stays zero (it takes no gradient); a seq
    shorter than the image tokens is refused. The frontends' draws differ
    from step to step and repeat from run to run."""
    out = train(LLAVA, smoke=True, steps=2, batch=2, seq=16, device="cpu")
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert not out["opt_state"]["mu"]["embed"].any()
    assert out["opt_state"]["mu"]["head"].abs().max() > 0
    again = train(LLAVA, smoke=True, steps=2, batch=2, seq=16, device="cpu")
    assert out["losses"] == again["losses"]
    with pytest.raises(ValueError, match="image tokens"):
        train(LLAVA, smoke=True, steps=1, batch=2, seq=4, device="cpu")
    from repro_torch.launch.train import _frontend_generator
    a, b = (frontends.audio_frames(_frontend_generator(0, s, "cpu"),
                                   tget(WHISPER, smoke=True), 1, device="cpu")
            for s in (0, 1))
    assert not torch.equal(a, b)


def test_encdec_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tget(WHISPER, smoke=True)
    api = model_api(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_prefill_step(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_decode_step(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(WHISPER, steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(LLAVA, steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        frontends.audio_frames(torch.Generator(), cfg, 1)
    params = api.init(torch.Generator(), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_batch(cfg, params, [Request(0, np.array([1, 2], np.int32), 2)],
                    max_len=8)
