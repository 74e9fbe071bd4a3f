"""Serving under a mesh against one process and the reference, on the CPU.

Decode attention's log-sum-exp L (the plain version's against a JAX
log-sum-exp of the reference's scores), and the combine of partial results
over ranks that each hold a slice of the cache
(``tensor_parallel.combine_partials``) against ``decode_attention_ref`` on
the whole cache. Then prefill and decode steps under a mesh
(``launch.steps.make_prefill_step`` / ``make_decode_step`` with ``mesh=``,
``shardings=``, ``cache_shardings=``) in gloo processes (one
``mp.spawn`` a world size, every job of this file in it, as
:mod:`test_torch_dist`'s), each rank holding its slices of the params (the
rules' placements) and of the caches, in the three layouts of
``shardings.cache_pspec``:

* (a) the KV heads over 'model': h2o-danube SMOKE (2 KV heads) and
  Qwen3-MoE SMOKE (its experts over 'model' too) at (1, 2);
* (b) the length over 'model': smollm SMOKE (1 KV head) at (1, 2), (1, 4)
  and (2, 2), and h2o-danube SMOKE at (1, 4) with a window of 4 whose ring
  of 4 slots (one a rank) wraps twice in 8 steps;
* (c) batch 1, the length over every axis: smollm SMOKE at (2, 2);

and the other mixers, each at (1, 2) with batch 4 and at (2, 2) with batch
1 (the every-axis layouts): DeepSeek SMOKE (MLA's latent cache, its length
over 'model' or ('data', 'model'); the dense prefix and MoE), Jamba SMOKE
(attention, Mamba's conv and state over 'model' or every axis, MoE), xLSTM
SMOKE (mLSTM's conv and C, sLSTM's h and c) and whisper SMOKE (its self
caches in attention's layouts, the cross K/V by rows, from encoded
frames).

Each run's prefill logits and 8 decode steps' logits are held within 1e-5
of one process on the same weights, its tokens equal, its cache slices
against the one-process cache's; the one-process logits against the
reference's jitted ``decode_step`` on the same weights, and so are each
rank's rows. One decode step's collectives (``tensor_parallel.counts``)
equal ``collectives_per_decode_step``, the design's count. The four
mixers also decode a fresh SMOKE model under a 'model' axis of 2 at batch
2, a layout of none of the runs.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.models import encdec as jencdec
from repro.models import model_api as jmodel_api
from repro_torch.configs import get as tget
from repro_torch.kernels import ops
from repro_torch.kernels.ref import decode_attention_ref
from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.layout import coordinate, local_shard
from repro_torch.models import encdec, model_api
from repro_torch.models import partitioning as part
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.weights import from_jax_params
from test_torch_dist import _spawn

# float32 sums in another order (the combine, the split projections)
TOL = 1e-5
# the port's logits against the reference's: float32 sums in another order
REF_TOL = 1e-5
STEPS = 8
# name: (arch, overrides, mesh shape, batch, cache length)
RUNS = {
    "smollm_1x2": ("smollm_360m", {}, (1, 2), 4, 16),
    "smollm_1x4": ("smollm_360m", {}, (1, 4), 4, 16),
    "smollm_2x2": ("smollm_360m", {}, (2, 2), 4, 16),
    "smollm_b1": ("smollm_360m", {}, (2, 2), 1, 16),
    "danube_1x2": ("h2o_danube_1_8b", {}, (1, 2), 4, 16),
    "danube_ring": ("h2o_danube_1_8b", {"window": 4}, (1, 4), 4, 16),
    "qwen3_1x2": ("qwen3_moe_235b_a22b", {}, (1, 2), 4, 16),
    "deepseek_1x2": ("deepseek_v3_671b", {}, (1, 2), 4, 16),
    "deepseek_b1": ("deepseek_v3_671b", {}, (2, 2), 1, 16),
    "jamba_1x2": ("jamba_1_5_large_398b", {}, (1, 2), 4, 16),
    "jamba_b1": ("jamba_1_5_large_398b", {}, (2, 2), 1, 16),
    "xlstm_1x2": ("xlstm_125m", {}, (1, 2), 4, 16),
    "xlstm_b1": ("xlstm_125m", {}, (2, 2), 1, 16),
    "whisper_1x2": ("whisper_small", {}, (1, 2), 4, 16),
    "whisper_b1": ("whisper_small", {}, (2, 2), 1, 16),
}
# the archs whose mixers decode under a mesh since MLA, Mamba, mLSTM /
# sLSTM and whisper's decoder run split over 'model'
MIXERS = ("deepseek_v3_671b", "jamba_1_5_large_398b", "xlstm_125m",
          "whisper_small")
WORLD = {2: [k for k, r in RUNS.items() if r[2] == (1, 2)] + ["combine2",
                                                               "fresh"],
         4: [k for k, r in RUNS.items() if r[2] != (1, 2)] + ["combine4"]}


def _pair(arch, over):
    return _pair_of(arch, tuple(sorted(over.items())))


@functools.lru_cache(maxsize=None)
def _pair_of(arch, over):
    """The reference's SMOKE config and weights and the port's, once a
    process (the reference's init jitted: eager JAX compiles DeepSeek
    SMOKE's op by op, ~17 s)."""
    jcfg = dataclasses.replace(jget(arch, smoke=True), **dict(over))
    tcfg = dataclasses.replace(tget(arch, smoke=True), **dict(over))
    jparams = jax.jit(lambda key: jmodel_api(jcfg).init(key, jcfg))(
        jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(cfg, batch):
    return np.random.default_rng(1).integers(0, cfg.vocab, (batch, STEPS),
                                             dtype=np.int32)


def _frames(cfg, batch):
    """An encoder-decoder's stub frames (B, encoder_seq, D)."""
    return np.random.default_rng(3).standard_normal(
        (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _cache(cfg, params, batch, max_len):
    """The decode cache; an encoder-decoder's with the cross K/V of its
    encoded frames."""
    if not cfg.is_encdec:
        return model_api(cfg).init_cache(cfg, batch, max_len, device="cpu")
    with torch.no_grad():
        enc = encdec.encode(params, torch.from_numpy(_frames(cfg, batch)), cfg)
    return encdec.init_cache(cfg, batch, max_len, enc_states=enc,
                             params=params, device="cpu")


def _serve(cfg, params, batch, max_len, mesh=None):
    """Prefill logits of the tokens and ``STEPS`` teacher-forced decode
    steps: (prefill, [logits], [tokens], cache, the mesh's layouts, the
    collectives of the second step)."""
    toks = _tokens(cfg, batch)
    cache = _cache(cfg, params, batch, max_len)
    shardings = csh = None
    if mesh is not None:
        shardings = SH.param_shardings(cfg, params, mesh, False)
        csh = SH.cache_shardings(cfg, cache, mesh)
        params = SH.shard_tree(params, shardings, mesh)
        cache = SH.shard_tree(cache, csh, mesh)
    inputs = {"inputs": toks}
    if cfg.is_encdec:
        inputs["frames"] = _frames(cfg, batch)
    pre = make_prefill_step(cfg, device="cpu", mesh=mesh,
                            shardings=shardings)(params, inputs)
    step = make_decode_step(cfg, device="cpu", mesh=mesh, shardings=shardings,
                            cache_shardings=csh)
    logits, nxt = [], []
    for t in range(STEPS):
        tp.counts.clear()
        n, lg, cache = step(params, cache, toks[:, t],
                            torch.tensor(t, dtype=torch.int32))
        if t == 1:
            one_step = dict(tp.counts)
        logits.append(lg.clone())
        nxt.append(n.clone())
    return pre, logits, nxt, cache, csh, one_step


def _run(name, tmp):
    """One rank's run of ``RUNS[name]`` beside one process's, with this
    rank's rows and cache slices of the latter, on the port's weights that
    the parent saved to ``tmp``."""
    arch, over, shape, batch, max_len = RUNS[name]
    cfg = dataclasses.replace(tget(arch, smoke=True), **over)
    params = torch.load(f"{tmp}/{name}.pt")
    mesh = make_mesh(shape, ("data", "model"))
    pre, logits, nxt, cache, csh, counted = _serve(cfg, params, batch,
                                                   max_len, mesh)
    one_pre, one_logits, one_nxt, one_cache, _, _ = _serve(cfg, params,
                                                           batch, max_len)
    entry = SH.batch_pspec(mesh, batch, 0)[0]
    axes = () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)
    index, count = coordinate(mesh, axes) if axes else (0, 1)
    rows = slice(batch // count * index, batch // count * (index + 1))
    want_cache = tree_map(lambda t, pl: local_shard(t, pl, mesh), one_cache,
                          csh)
    from repro_torch.launch.steps import cache_length_axes
    return {"pre": pre, "logits": logits, "tokens": nxt,
            "cache": tree_leaves(cache), "want_cache": tree_leaves(want_cache),
            "one_pre": one_pre[rows], "one_logits": [x[rows] for x in one_logits],
            "one_tokens": [x[rows] for x in one_nxt],
            "rows": (rows.start, rows.stop),
            "heads": _kv_heads(cache),
            "length_axes": cache_length_axes(cache, csh, mesh),
            "counts": counted}


def _kv_heads(cache):
    """The KV heads of a rank's first attention cache, None without one."""
    found = []
    SH.map_with_path(lambda path, leaf: found.append(leaf.shape[-3])
                     if path[-1] == "k" else None, cache)
    return found[0] if found else None


def _combine(world):
    """Each rank's partial over its slice of a cache of 16 slots, combined
    over 'model' at (1, world), against the whole cache: row 0 holds 3
    valid slots (the ranks past the first hold none), row 1 a full ring."""
    mesh = make_mesh((1, world), ("data", "model"))
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((2, 4, 16), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, 16, 16), np.float32))
            for _ in range(2))
    length = torch.tensor([3, 16], dtype=torch.int32)
    want = decode_attention_ref(q, k, v, length)
    c = 16 // world
    with part.use_mesh(mesh, ("data",)):
        r = tp.model_index()
        local = torch.clamp(length - r * c, 0, c).to(torch.int32)
        out, lse = ops.decode_attention(q, k[:, :, r * c:(r + 1) * c],
                                        v[:, :, r * c:(r + 1) * c], local,
                                        return_lse=True)
        got = tp.combine_partials(out, lse, ("model",))
    return {"got": got, "want": want, "empty_rank": bool(local[0] == 0),
            "lse": lse}


def _fresh():
    """The four archs' SMOKE models (weights drawn by the port) served
    under a 'model' axis of 2 at batch 2, a step at a time: their logits'
    shapes and finiteness."""
    mesh = make_mesh((1, 2), ("data", "model"))
    out = {}
    for arch in MIXERS:
        cfg = tget(arch, smoke=True)
        api = model_api(cfg)
        params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
        shardings = SH.param_shardings(cfg, params, mesh, False)
        params = SH.shard_tree(params, shardings, mesh)
        cache = api.init_cache(cfg, 2, 8, device="cpu")
        csh = SH.cache_shardings(cfg, cache, mesh)
        cache = SH.shard_tree(cache, csh, mesh)
        step = make_decode_step(cfg, device="cpu", mesh=mesh,
                                shardings=shardings, cache_shardings=csh)
        logits = [step(params, cache, np.full(2, t, np.int32), t)[1]
                  for t in range(3)]
        out[arch] = (tuple(logits[-1].shape),
                     all(bool(torch.isfinite(x).all()) for x in logits))
    return out


JOBS = {name: (lambda d, name=name: _run(name, d)) for name in RUNS}
JOBS.update(combine2=lambda d: _combine(2), combine4=lambda d: _combine(4),
            fresh=lambda d: _fresh())


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every job's results on every rank, by world size."""
    out = {}
    for world, jobs in WORLD.items():
        tmp = tmp_path_factory.mktemp(f"serve{world}")
        for name in jobs:
            if name in RUNS:
                torch.save(_pair(*RUNS[name][:2])[3], tmp / f"{name}.pt")
        out[world] = _spawn(tmp, world, jobs, module=__name__)
    return out


def _results(ranks, name):
    for world, jobs in WORLD.items():
        if name in jobs:
            return [r[name] for r in ranks[world]]
    raise KeyError(name)


def test_plain_lse_equals_jax_logsumexp_of_the_reference_scores():
    """L of the plain version: the log-sum-exp of the scaled scores over
    each row's valid slots, -inf and output 0 for a row with none."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((3, 4, 16), np.float32)
    k = rng.standard_normal((3, 2, 12, 16), np.float32)
    v = rng.standard_normal((3, 2, 12, 16), np.float32)
    length = np.array([5, 12, 0], np.int32)
    out, lse = decode_attention_ref(*map(torch.from_numpy, (q, k, v, length)),
                                    return_lse=True)
    s = jnp.einsum("bhgd,bhkd->bhgk", q.reshape(3, 2, 2, 16), k) * 16 ** -0.5
    valid = jnp.arange(12)[None] < length[:, None]
    want = jax.nn.logsumexp(jnp.where(valid[:, None, None], s, -jnp.inf),
                            axis=-1).reshape(3, 4)
    np.testing.assert_allclose(lse[:2].numpy(), np.asarray(want)[:2],
                               rtol=1e-6, atol=1e-6)
    assert torch.isneginf(lse[2]).all() and not out[2].any()
    plain = decode_attention_ref(*map(torch.from_numpy, (q, k, v, length)))
    torch.testing.assert_close(out[:2], plain[:2], rtol=0, atol=0)


@pytest.mark.parametrize("world", [2, 4])
def test_partials_combine_to_the_whole_cache(ranks, world):
    for r in _results(ranks, f"combine{world}"):
        torch.testing.assert_close(r["got"], r["want"], rtol=TOL, atol=TOL)
    # a rank past the first holds no valid slot of row 0
    assert any(r["empty_rank"] for r in _results(ranks, f"combine{world}"))


@pytest.mark.parametrize("name", sorted(RUNS))
def test_decode_under_a_mesh_equals_one_process(ranks, name):
    """Prefill and decode logits of each rank's rows within TOL of one
    process, the greedy tokens equal, each cache slice equal to the
    one-process cache's slice."""
    for r in _results(ranks, name):
        torch.testing.assert_close(r["pre"], r["one_pre"], rtol=TOL, atol=TOL)
        for got, want in zip(r["logits"], r["one_logits"]):
            torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
        for got, want in zip(r["tokens"], r["one_tokens"]):
            assert torch.equal(got, want)
        for got, want in zip(r["cache"], r["want_cache"]):
            torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name, layout", [
    ("smollm_1x2", ("model",)), ("smollm_1x4", ("model",)),
    ("smollm_2x2", ("model",)), ("smollm_b1", ("data", "model")),
    ("danube_1x2", ()), ("danube_ring", ("model",)), ("qwen3_1x2", ()),
    ("deepseek_1x2", ("model",)), ("deepseek_b1", ("data", "model")),
    ("jamba_1x2", ()), ("jamba_b1", ("data", "model")), ("xlstm_1x2", ()),
    ("xlstm_b1", ()), ("whisper_1x2", ()), ("whisper_b1", ("data", "model"))])
def test_each_run_takes_its_layout(ranks, name, layout):
    """The caches' length axes as the rules give them ('k' and MLA's
    'c_kv' leaves); the heads layout holds a rank's share of the KV heads;
    every run sums over 'model' (the output projections' rows)."""
    cfg = tget(RUNS[name][0], smoke=True)
    for r in _results(ranks, name):
        assert r["length_axes"] == layout
        m = RUNS[name][2][1]
        if r["heads"] is not None:
            assert r["heads"] == (cfg.n_kv_heads // m if not layout
                                  else cfg.n_kv_heads)
        assert r["counts"]["all_reduce"] > 0


@pytest.mark.parametrize("name", sorted(RUNS))
def test_a_steps_collectives_are_the_designs(ranks, name):
    """One decode step's collectives on every rank: the design's count
    (``collectives_per_decode_step``); at batch 1 the every-axis layouts
    also gather over 'data', and the recurrent states exchange their
    chunks' rows of the per-channel weights."""
    arch, over, shape, batch, _ = RUNS[name]
    cfg = dataclasses.replace(tget(arch, smoke=True), **over)
    want = tp.collectives_per_decode_step(
        cfg, dict(zip(("data", "model"), shape)), batch)
    for r in _results(ranks, name):
        assert {k: v for k, v in r["counts"].items()
                if not k.endswith("_bytes")} == want


@pytest.mark.parametrize("name", sorted(RUNS))
def test_mesh_and_one_process_equal_the_reference_decode(ranks, name):
    """The port's one process and each rank's rows of the mesh run against
    the reference's jitted ``decode_step`` on the same weights: 8
    teacher-forced steps."""
    arch, over, _, batch, max_len = RUNS[name]
    jcfg, jparams, tcfg, tparams = _pair(arch, over)
    japi = jmodel_api(jcfg)
    toks = _tokens(jcfg, batch)
    if jcfg.is_encdec:
        enc = jencdec.encode(jparams, jnp.asarray(_frames(jcfg, batch)), jcfg)
        jcache = jencdec.init_cache(jcfg, batch, max_len, enc_states=enc,
                                    params=jparams)
    else:
        jcache = japi.init_cache(jcfg, batch, max_len=max_len)
    step = jax.jit(lambda p, c, t, pos: japi.decode_step(p, c, t, pos, jcfg))
    _, logits, _, _, _, _ = _serve(tcfg, tparams, batch, max_len)
    for t in range(STEPS):
        jl, jcache = step(jparams, jcache, jnp.asarray(toks[:, t]),
                          jnp.int32(t))
        np.testing.assert_allclose(logits[t].numpy(), np.asarray(jl),
                                   rtol=REF_TOL, atol=REF_TOL)
        for r in _results(ranks, name):
            np.testing.assert_allclose(r["logits"][t].numpy(),
                                       np.asarray(jl)[slice(*r["rows"])],
                                       rtol=REF_TOL, atol=REF_TOL)


def test_the_four_mixers_decode_under_a_model_axis(ranks):
    """DeepSeek, Jamba, xLSTM and whisper SMOKE with the port's own
    weights, under a 'model' axis of 2 at batch 2: finite logits of this
    rank's rows, whole over the vocab."""
    for r in _results(ranks, "fresh"):
        assert sorted(r) == sorted(MIXERS)
        for arch, (shape, finite) in r.items():
            assert shape == (2, tget(arch, smoke=True).vocab) and finite, arch
