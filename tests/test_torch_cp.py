"""Ring context-parallel attention against the JAX reference, on the CPU.

One ``mp.spawn`` of 8 gloo ranks (:mod:`test_torch_dist`'s ``_spawn``)
runs every job of this file; the oracles run in the parent:

* ``ops.cp_flash_attention`` on a (1, 8) mesh, the reference oracle's case
  (``test_launch_e2e.py::test_cp_attention_multishard_subprocess``): q, k,
  v (2, 4, 256, 32) float32, windows None / 64 / 100 (r 7 / 2 / 4 at L
  32). Each rank's output against its slice of ``attention_ref`` (JAX),
  its dq / dk / dv against ``jax.grad`` of sum(attention_ref · w);
* the same at (2, 4): rows over 'data', the ring over 'model', window 100
  (r 2 at L 64);
* ``lm_loss`` at (2, 4) with the tokens over 'model' (each rank its rows
  and its shard of the tokens, at their absolute positions): h2o-danube
  SMOKE with ``seq_shard`` (window 16, S 64, L 16, r 1) and smollm SMOKE
  with ``seq_shard`` (full causal, r 3), on the reference's weights. The
  ranks' losses sum to the reference's loss on the whole batch, and their
  gradients to ``jax.grad`` of it.

Each rank also records the K/V length and ``offset`` of its flash call:
rank i pulls the min(i, r) shards before its own and no others.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import collectives
from repro_torch.configs import get
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import layers as tlayers
from repro_torch.models import model_api
from repro_torch.models import partitioning as part
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.optim.optimizers import adamw
from test_torch_dist import _spawn

WORLD = 8
OP_SHAPE = (2, 4, 256, 32)
WINDOWS = (None, 64, 100)
# the reference oracle's tolerance on the output (float32 sums in another
# order); gradients as every gradient leaf: 1e-4 max|g| + 1e-6
OUT_TOL = 3e-5
GRAD_TOL = 1e-4
# the model's float32 loss against the reference's
LOSS_REL = 1e-5
MODELS = {"danube": "h2o_danube_1_8b", "smollm": "smollm_360m"}
MODEL_BATCH, MODEL_SEQ = 4, 64


def _op_inputs():
    """q, k, v and the output's weights w, (2, 4, 256, 32) float32."""
    rng = np.random.default_rng(5)
    return tuple(rng.standard_normal(OP_SHAPE).astype(np.float32)
                 for _ in range(4))


def _shard(mesh, rows: int, seq: int):
    """This rank's rows (over 'data') and tokens (over 'model') as slices."""
    d, m = mesh.get_coordinate()
    nd, nm = mesh.shape
    return (slice(d * rows // nd, (d + 1) * rows // nd),
            slice(m * seq // nm, (m + 1) * seq // nm))


def _recording_flash():
    """Replaces ``ops.flash_attention`` by a stand-in that records each
    call's (K/V length, offset); returns the list and the original."""
    calls, real = [], ops.flash_attention

    def call(q, k, v, causal=True, window=None, offset=0, scale=None):
        calls.append((k.shape[2], offset))
        return real(q, k, v, causal, window, offset, scale)
    ops.flash_attention = call
    return calls, real


def _op_job(shape, windows):
    """Each window's output and gradients of this rank's shard, its flash
    calls' (K/V length, offset), and its rows and tokens."""
    mesh = make_mesh(shape, ("data", "model"))
    rows, toks = _shard(mesh, OP_SHAPE[0], OP_SHAPE[2])
    q, k, v, w = (torch.from_numpy(a[rows, :, toks].copy())
                  for a in _op_inputs())
    out = {"rows": rows, "toks": toks, "model_index": mesh.get_coordinate()[1],
           "model_size": shape[1]}
    calls, real = _recording_flash()
    try:
        for window in windows:
            qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
            calls.clear()
            o = ops.cp_flash_attention(*qkv, mesh, window=window)
            (o * w).sum().backward()
            out[window] = {"out": o.detach(), "grads": [t.grad for t in qkv],
                           "calls": list(calls)}
    finally:
        ops.flash_attention = real
    return out


def _model_job(tmp, key):
    """This rank's loss and gradients of ``lm_loss`` at (2, 4) on its rows
    and tokens, on the weights and batch the parent wrote."""
    cfg = dataclasses.replace(get(MODELS[key], smoke=True), seq_shard=True)
    params, batch = torch.load(f"{tmp}/{key}.pt", weights_only=False)
    mesh = make_mesh((2, 4), ("data", "model"))
    rows, toks = _shard(mesh, MODEL_BATCH, MODEL_SEQ)
    b = {k: torch.from_numpy(v[rows, toks].copy()) for k, v in batch.items()}
    p = tree_map(lambda a: a.detach().requires_grad_(True), params)

    def total(n):
        n = n.clone()
        dist.all_reduce(n)
        return n

    staged = collectives.p2p.staged
    with part.use_mesh(mesh, ("data",), seq_axis="model"):
        loss, metrics = model_api(cfg).loss(p, b, cfg, total=total)
        loss.backward()
    return {"loss": float(loss), "tokens": float(metrics["tokens"]),
            "grads": tree_map(lambda a: a.grad, p),
            "staged": collectives.p2p.staged - staged}


JOBS = {"op18": lambda d: _op_job((1, 8), WINDOWS),
        "op24": lambda d: _op_job((2, 4), (100,))}
JOBS.update({key: (lambda d, key=key: _model_job(d, key)) for key in MODELS})


def _reference_model(tmp, key):
    """The reference's SMOKE weights (seed 2) with ``seq_shard``,
    transplanted and written with a batch for the ranks; returns the
    reference's loss and ``jax.grad`` on the whole batch, no mesh."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get as jget
    from repro.models import model_api as jmodel_api
    from repro_torch.weights import from_jax_params

    jcfg = dataclasses.replace(jget(MODELS[key], smoke=True), seq_shard=True)
    tcfg = dataclasses.replace(get(MODELS[key], smoke=True), seq_shard=True)
    jparams = jmodel_api(jcfg).init(jax.random.PRNGKey(2), jcfg)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab, (MODEL_BATCH, MODEL_SEQ + 1), np.int32)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    torch.save((tparams, batch), f"{tmp}/{key}.pt")
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jmodel_api(jcfg).loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)[0]))(jparams)
    return {"loss": float(loss), "grads": grads}


def _reference_op():
    """attention_ref's output and ``jax.grad`` of sum(attention_ref · w) on
    the whole sequence, for each window."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import ref as jref

    q, k, v, w = (jnp.asarray(a) for a in _op_inputs())
    out = {}
    for window in WINDOWS:
        def f(q, k, v, window=window):
            return jref.attention_ref(q, k, v, causal=True, window=window)
        grads = jax.grad(lambda q, k, v: jnp.sum(f(q, k, v) * w),
                         argnums=(0, 1, 2))(q, k, v)
        out[window] = (np.asarray(f(q, k, v)), [np.asarray(g) for g in grads])
    return out


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cp8")
    ref = {key: _reference_model(tmp, key) for key in MODELS}
    return _spawn(tmp, WORLD, list(JOBS), module=__name__), ref


@pytest.fixture(scope="module")
def ref_op():
    return _reference_op()


def _leaf_close(got, want, what):
    tol = GRAD_TOL * float(np.abs(want).max()) + 1e-6
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=what)


@pytest.mark.parametrize("job,window", [("op18", w) for w in WINDOWS]
                         + [("op24", 100)])
def test_ring_attention_matches_the_reference(world8, ref_op, job, window):
    """Each rank's output to 3e-5 of its slice of ``attention_ref`` on the
    whole sequence, its dq / dk / dv (dk and dv holding what the later
    ranks sent home) as gradient leaves; its one flash call on its own and
    the min(i, r) previous shards' K/V, its rows at ``offset`` min(i, r) L."""
    want, wgrads = ref_op[window]
    for r in world8[0]:
        got = r[job]
        rows, toks, idx = got["rows"], got["toks"], got["model_index"]
        n = got["model_size"]
        length = toks.stop - toks.start
        np.testing.assert_allclose(got[window]["out"].numpy(),
                                   want[rows, :, toks], atol=OUT_TOL,
                                   rtol=OUT_TOL)
        for g, w, name in zip(got[window]["grads"], wgrads, "qkv"):
            _leaf_close(g.numpy(), w[rows, :, toks], f"d{name} rank {idx}")
        ring = n - 1 if window is None else min(n - 1, -(-window // length))
        pulled = min(idx, ring)
        assert got[window]["calls"] == [((pulled + 1) * length,
                                         pulled * length)]


@pytest.mark.parametrize("key", list(MODELS))
def test_loss_on_token_shards_matches_the_reference(world8, key):
    """The 8 ranks' losses sum to the reference's loss on the whole batch
    to 1e-5 relative, their token count is the whole batch's, and their
    gradients summed match ``jax.grad`` leaf by leaf (1e-4 max|g| +
    1e-6). On the CPU the ring moves host tensors: nothing is staged."""
    import jax

    ranks, ref = world8
    want = ref[key]
    loss = sum(r[key]["loss"] for r in ranks)
    assert abs(loss - want["loss"]) <= LOSS_REL * abs(want["loss"])
    assert all(r[key]["tokens"] == MODEL_BATCH * MODEL_SEQ for r in ranks)
    assert all(r[key]["staged"] == 0 for r in ranks)
    summed = tree_map(lambda *g: sum(g[1:], g[0].clone()),
                      *[r[key]["grads"] for r in ranks])
    flat = jax.tree_util.tree_flatten_with_path(want["grads"])[0]
    assert len(flat) == len(tree_leaves(summed))
    for path, w in flat:
        g = summed
        for p in path:
            g = g[p.key if hasattr(p, "key") else p.idx]
        w = np.asarray(w)
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        _leaf_close(g.numpy(), w, jax.tree_util.keystr(path))


@pytest.mark.parametrize("mesh", [None, {"data": 2, "model": 1}])
@pytest.mark.parametrize("window", [None, 5])
def test_one_shard_is_flash_attention_bit_for_bit(mesh, window):
    """With no mesh, or a 'model' axis of 1, the ring is
    ``ops.flash_attention`` on the same tensors, with no collective (none
    is initialised here)."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 24, 16, generator=g)
    k, v = (torch.randn(2, 2, 24, 16, generator=g) for _ in range(2))
    assert torch.equal(ops.cp_flash_attention(q, k, v, mesh, window=window),
                       ops.flash_attention(q, k, v, causal=True, window=window))


def test_ring_refuses_what_it_does_not_define():
    """``causal=False`` raises (the reference would attend only to the
    earlier shards); ``seq_shard`` with projections split over 'model'
    raises before any collective; with ``seq_shard`` and no token split
    registered, attention under a 'model' axis of 2 is plain attention on
    whole sequences; the token split of a 'model' axis of 1 is no split."""
    q = torch.randn(1, 2, 8, 16)
    with pytest.raises(ValueError, match="causal"):
        ops.cp_flash_attention(q, q, q, None, causal=False)
    cfg = dataclasses.replace(get("h2o_danube_1_8b", smoke=True),
                              seq_shard=True)
    g = torch.Generator().manual_seed(1)
    whole = tlayers.attn_init(g, cfg, torch.float32)
    x, pos = torch.randn(2, 16, cfg.d_model, generator=g), torch.arange(16)
    split = {"wq": whole["wq"][:, :32], "wk": whole["wk"][:, :16],
             "wv": whole["wv"][:, :16], "wo": whole["wo"][:32]}
    with part.use_mesh({"data": 1, "model": 2}, seq_axis="model"):
        assert part.seq_axis() == "model"
        with pytest.raises(NotImplementedError, match="seq_shard"):
            tlayers.attn_apply(split, x, cfg, pos)
    with part.use_mesh({"data": 1, "model": 2}):
        assert part.seq_axis() is None and part.seq_index() == 0
        got = tlayers.attn_apply(whole, x, cfg, pos)
    assert torch.equal(got, tlayers.attn_apply(whole, x, cfg, pos))
    with part.use_mesh({"data": 2, "model": 1}, seq_axis="model"):
        assert part.seq_axis() is None
    assert part.seq_axis() is None


@pytest.mark.parametrize("mesh", [{"data": 1, "model": 2},
                                  {"data": 2, "model": 4}])
def test_training_with_the_tokens_over_model_builds(mesh):
    """``make_train_step`` for h2o-danube-1.8b+seqp makes a step under a
    'model' axis above 1 (and at (2, 1)); ``seq_shard`` without
    ``pure_dp`` there (a token split beside tensor parallelism, which the
    reference never trains) raises NotImplementedError when the step is
    made."""
    cfg = get("h2o_danube_1_8b_seqp")
    assert callable(make_train_step(cfg, adamw(1e-3), device="cpu",
                                    mesh=mesh))
    make_train_step(cfg, adamw(1e-3), device="cpu",
                    mesh={"data": 2, "model": 1})
    with pytest.raises(NotImplementedError, match="pure_dp only"):
        make_train_step(dataclasses.replace(cfg, pure_dp=False), adamw(1e-3),
                        device="cpu", mesh=mesh)


@pytest.mark.parametrize("rows", [8, 16])
def test_training_refuses_model_twice_before_any_collective(rows):
    """Where ``pure_dp``'s rows divide every axis of (2, 4), the reference's
    input spec puts 'model' on the rows and on the tokens and the reference
    refuses it (``DuplicateSpecError``); the port's step raises ValueError
    ("used twice") when it reads the batch, before any collective (the
    mesh is a ``{axis: size}`` mapping, which has no process groups)."""
    import jax
    from jax.sharding import AbstractMesh
    from repro.configs import get as jget
    from repro.launch import shardings as JSH

    mesh = {"data": 2, "model": 4}
    jb = {"inputs": jax.ShapeDtypeStruct((rows, MODEL_SEQ), np.int32)}
    with pytest.raises(Exception) as e:
        JSH.input_shardings(jget("h2o_danube_1_8b_seqp"), jb,
                            AbstractMesh((2, 4), ("data", "model")))
    assert type(e.value).__name__ == "DuplicateSpecError"
    step = make_train_step(get("h2o_danube_1_8b_seqp"), adamw(1e-3),
                           device="cpu", mesh=mesh)
    toks = np.zeros((rows, MODEL_SEQ), np.int32)
    with pytest.raises(ValueError, match="used twice"):
        step({"embed": torch.zeros(1)}, {}, {"inputs": toks, "labels": toks})


@pytest.mark.parametrize("arch,seq_shard", [
    ("h2o_danube_1_8b", False),         # attention, but no seq_shard
    ("jamba_1_5_large_398b", True),     # Mamba mixers, MoE
    ("deepseek_v3_671b", True),         # MLA, MoE, MTP
    ("qwen3_moe_235b_a22b", True),      # MoE routing and its aux loss
    ("xlstm_125m", True)])              # sLSTM / mLSTM mixers
def test_a_token_split_refuses_models_the_ring_does_not_cover(arch, seq_shard):
    """Under a registered token split a model other than a ``seq_shard``
    decoder of attention and dense FFN blocks without MTP raises in
    ``lm_loss`` and ``forward`` before they compute anything, rather than
    compute over the rank's shard alone; so does ``init_cache``. With no
    token split the same loss is computed."""
    from repro_torch.models import transformer

    cfg = dataclasses.replace(get(arch, smoke=True), seq_shard=seq_shard)
    params = transformer.init(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    toks = torch.zeros(2, 8, dtype=torch.long)
    batch = {"inputs": toks, "labels": toks}
    with part.use_mesh({"data": 1, "model": 2}, seq_axis="model"):
        with pytest.raises(NotImplementedError, match="token split"):
            transformer.lm_loss(params, batch, cfg)
        with pytest.raises(NotImplementedError, match="token split"):
            transformer.forward(params, torch.zeros(2, 8, cfg.d_model), cfg,
                                torch.arange(8))
        with pytest.raises(NotImplementedError, match="token split"):
            transformer.init_cache(cfg, 2, 8, device="cpu")
    assert torch.isfinite(transformer.lm_loss(params, batch, cfg)[0])


def test_a_token_split_refuses_attention_the_ring_does_not_run():
    """Under a registered token split, attention without ``seq_shard``, or
    not causal (an encoder's), raises rather than attend within the
    rank's shard; ``seq_shard`` causal attention is what the ring runs.
    The split is over 'model' only."""
    g = torch.Generator().manual_seed(4)
    base = get("h2o_danube_1_8b", smoke=True)
    p = tlayers.attn_init(g, base, torch.float32)
    x, pos = torch.randn(2, 16, base.d_model, generator=g), torch.arange(16)
    with part.use_mesh({"data": 1, "model": 2}, seq_axis="model"):
        with pytest.raises(NotImplementedError, match="seq_shard False"):
            tlayers.attn_apply(p, x, base, pos)
        with pytest.raises(NotImplementedError, match="causal False"):
            tlayers.attn_apply(p, x, dataclasses.replace(base, seq_shard=True),
                               pos, causal=False)
    with pytest.raises(ValueError, match="'model' only"):
        part.set_mesh({"data": 2, "model": 1}, seq_axis="data")
    assert part.current_mesh() is None and part.seq_axis() is None
