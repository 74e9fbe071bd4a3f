"""The train step's clip and optimizer as the port runs them, on the CPU.

The port computes the global norm and the clip's scale once
(``kernels.adamw.global_norm_scale``) and hands the scale to the optimizer
(``update(..., grad_scale=scale)``), which applies it leaf by leaf with the
clip's storage round trip; on the card that is the fused kernels of
``csrc/adamw.cu``, here their plain versions. These tests hold that
composition against the reference's ``clip_by_global_norm`` followed by its
``update`` (JAX on the CPU), and against the port's own clip followed by its
update, over a SMOKE smollm tree with bf16 matrices and float32 norms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro_torch.configs import get
from repro_torch.kernels.adamw import adamw_update, global_norm_scale
from repro_torch.models import transformer
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.optim import optimizers as topt

B1 = 0.9
SCHED = dict(base_lr=1e-2, warmup=2, total=10)
# (max_norm, whether the clip bites): the gradients' norm is ~30
CLIPS = [(0.05, True), (1e6, False)]


def _tree(seed=0):
    """smollm SMOKE's params as numpy float32, and the dtype each leaf is
    stored in: bf16 for the embedding and the stacked matrices, float32 for
    the norm scales (the 1-d final norm, no decay; the stacked (n_periods,
    d) ln1 and ln2, decayed as the reference decays every ndim >= 2 leaf)."""
    cfg = get("smollm_360m", smoke=True)
    params = transformer.init(torch.Generator().manual_seed(seed), cfg, device="cpu")
    arrays = tree_map(lambda t: t.float().numpy(), params)

    def dtypes(tree, key=None):
        if isinstance(tree, dict):
            return {k: dtypes(v, k) for k, v in tree.items()}
        return "float32" if tree.ndim == 1 or key in ("ln1", "ln2") else "bfloat16"

    return arrays, dtypes(arrays)


def _as_jax(arrays, dtypes):
    return jax.tree.map(lambda a, d: jnp.asarray(a).astype(d), arrays, dtypes)


def _as_torch(arrays, dtypes):
    return tree_map(lambda a, d: torch.from_numpy(a.copy()).to(getattr(torch, d)),
                    arrays, dtypes)


def _grads(arrays, rng):
    return tree_map(lambda a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32),
                    arrays)


def _optimizers(kind):
    if kind == "adamw":
        return (jopt.adamw(jopt.warmup_cosine(**SCHED)),
                topt.adamw(topt.warmup_cosine(**SCHED)))
    return (jopt.adafactor(jopt.warmup_cosine(**SCHED), weight_decay=0.1),
            topt.adafactor(topt.warmup_cosine(**SCHED), weight_decay=0.1))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at each element of x (7 stored mantissa
    bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def _flat(tree):
    """(path, leaf) pairs of a JAX tree, the port's order."""
    return [(jax.tree_util.keystr(p), leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("max_norm,bites", CLIPS)
@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_grad_scale_update_matches_jax_clip_then_update(kind, max_norm, bites):
    """Three steps: the port's norm and scale, then ``update(grads, state,
    params, grad_scale=scale)``, against the reference's
    ``clip_by_global_norm`` then ``update``, each step from the same params,
    state and gradients (the port's trees take the reference's values after
    each comparison). The norm to 2e-5 relative (~7e5 squares summed in
    another order); float32 params to 2e-5; bf16 params within one bf16 ulp;
    optimizer state to 2e-5 of the leaf's largest value, and for a bf16 leaf
    within what one bf16 ulp of its clipped gradient moves it (the two
    frameworks' scales differ in their last bits, which can flip the bf16
    rounding of ``g * scale``)."""
    arrays, dtypes = _tree()
    dflat = dict(_flat(dtypes))
    jo, to = _optimizers(kind)
    jp, tp = _as_jax(arrays, dtypes), _as_torch(arrays, dtypes)
    js, ts = jo.init(jp), to.init(tp)
    names = ("mu", "nu") if kind == "adamw" else ("stats",)
    rng = np.random.default_rng(1)
    for _ in range(3):
        g = _grads(arrays, rng)
        jg, jnorm = jopt.clip_by_global_norm(_as_jax(g, dtypes), max_norm)
        jp, js = jo.update(jg, js, jp)
        tg = _as_torch(g, dtypes)
        tnorm, scale = global_norm_scale(tree_leaves(tg), max_norm)
        tp, ts = to.update(tg, ts, tp, grad_scale=scale)
        np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=2e-5)
        assert (float(scale) < 1) == bites
        assert int(ts["step"]) == int(js["step"])
        gmax = {path: float(jnp.abs(leaf.astype(jnp.float32)).max())
                for path, leaf in _flat(jg)}
        for (path, want), got in zip(_flat(jp), tree_leaves(tp)):
            want = np.array(want.astype(jnp.float32))
            if dflat[path] == "bfloat16":
                err = np.abs(_np(got) - want) / _bf16_ulp(want)
                assert err.max() <= 1, f"{path}: {err.max()} bf16 ulps"
            else:
                np.testing.assert_allclose(_np(got), want, atol=2e-5, rtol=2e-5,
                                           err_msg=path)
            got.copy_(torch.from_numpy(want))
        for name in names:
            for (path, want), got in zip(_flat(js[name]), tree_leaves(ts[name])):
                want = np.array(want)
                # the param leaf this state belongs to: the longest path prefix
                key = max((k for k in dflat if path.startswith(k)), key=len)
                atol = 2e-5 * float(np.abs(want).max())
                if dflat[key] == "bfloat16":
                    gm = gmax[key]
                    atol += max(1.0, 2 * gm) * float(_bf16_ulp(np.float32(gm)))
                np.testing.assert_allclose(_np(got), want, rtol=2e-5, atol=atol,
                                           err_msg=path)
                got.copy_(torch.from_numpy(want))


@pytest.mark.parametrize("max_norm,bites", CLIPS)
@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_grad_scale_update_equals_the_ports_clip_then_update(kind, max_norm, bites):
    """The composition the train step runs equals the port's own
    ``clip_by_global_norm`` followed by ``update`` bit for bit, step after
    step: one norm (the same sums in the same order), one scale, one
    storage round trip of each gradient."""
    arrays, dtypes = _tree(seed=2)
    _, to = _optimizers(kind)
    pa, pb = _as_torch(arrays, dtypes), _as_torch(arrays, dtypes)
    sa, sb = to.init(pa), to.init(pb)
    rng = np.random.default_rng(3)
    for _ in range(3):
        g = _as_torch(_grads(arrays, rng), dtypes)
        clipped, norm_a = topt.clip_by_global_norm(g, max_norm)
        to.update(clipped, sa, pa)
        norm_b, scale = global_norm_scale(tree_leaves(g), max_norm)
        to.update(g, sb, pb, grad_scale=scale)
        assert torch.equal(norm_a, norm_b) and (float(scale) < 1) == bites
    for a, b in zip(tree_leaves((pa, sa)), tree_leaves((pb, sb))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_update_decays_by_rank_and_clips_by_round_trip(dtype):
    """The plain version of the fused kernel, leaf by leaf: with a zero
    gradient only weight decay moves p, and it moves a 2-D leaf (the
    stacked norm scales' shape), not a 1-D one; a scale of 1 leaves the
    gradient as it is, and a scale below 1 rounds ``g * scale`` to the
    storage dtype before the moments see it."""
    f = lambda x: torch.tensor(x, dtype=torch.float32)
    lr, c1, c2 = f(0.1), f(1 - 0.9), f(1 - 0.95)
    for shape, moves in (((4, 8), True), ((8,), False)):
        p = torch.full(shape, 0.5, dtype=dtype)
        m, v = torch.zeros(shape), torch.zeros(shape)
        adamw_update(p, torch.zeros(shape, dtype=dtype), m, v, lr, c1, c2, f(0.3))
        assert bool((p != 0.5).all()) == moves and not bool(m.any())
    g = (torch.arange(1, 25, dtype=torch.float32) / 7).to(dtype).reshape(4, 6)
    outs = []
    for scale in (None, f(1.0), f(0.3)):
        p, m, v = torch.ones(4, 6, dtype=dtype), torch.zeros(4, 6), torch.zeros(4, 6)
        adamw_update(p, g, m, v, lr, c1, c2, scale)
        outs.append(m)
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[2], (1 - B1) * (g.float() * f(0.3)).to(dtype).float())


def test_non_cpu_leaves_never_take_the_plain_version():
    """Leaves that are not on the CPU go to the kernels' wrappers, which
    launch on CUDA or raise; nothing is computed by the plain versions."""
    from repro_torch.kernels import adamw as ka
    meta = lambda *shape: torch.empty(*shape, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        global_norm_scale([meta(4, 8), meta(8)], 1.0)
    one = meta(())
    with pytest.raises(ValueError, match="CUDA"):
        adamw_update(meta(4, 8), meta(4, 8), meta(4, 8), meta(4, 8), one, one, one)
    assert ka.sumsq_cuda.launches == ka.clip_finalize_cuda.launches == 0
    assert ka.adamw_update_cuda.launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_grids_follow_the_leaf_and_the_card(dtype):
    """The clip's workspace takes one partial sum per ``sumsq`` block: at
    least one a leaf, enough for every thread to have its vectors in flight,
    at most BLOCKS_PER_SM a SM, so fixed by the leaf's size and the card;
    the update runs a vector a thread up to the same cap; the RMSNorm
    backward's workspace takes at most two rows a SM and no more than the
    rows."""
    from repro_torch.kernels import adamw as ka
    from repro_torch.kernels.rmsnorm import BWD_BLOCKS_PER_SM, bwd_partial_rows
    vec = 16 // dtype.itemsize
    per = ka.THREADS * ka.SUMSQ_UNROLL * vec
    for numel, n_sm in ((1, 132), (per, 132), (per + 1, 132), (47185920, 132),
                        (47185920, 78)):
        blocks = ka.sumsq_blocks(numel, dtype, n_sm)
        assert blocks == min(-(-numel // per), ka.BLOCKS_PER_SM * n_sm) >= 1
        assert ka.update_blocks(numel, dtype, n_sm) == min(
            -(-numel // (ka.THREADS * vec)), ka.BLOCKS_PER_SM * n_sm)
    for rows in (1, 7, 4096):
        assert bwd_partial_rows(rows, 132) == min(rows, BWD_BLOCKS_PER_SM * 132)
