"""The selective scan's backward on the CPU: its plain version against
``jax.vjp`` of the reference scan and against torch autograd, the plain
forward that saves states, and ``_MambaScan``'s plumbing with its two
launchers replaced by the plain versions.

Inputs come from ``numpy.random.default_rng`` and go to both sides. The
CUDA kernels themselves are checked on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from repro.kernels import ref as jref
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels.mamba_scan import (BWD_BLOCKS_PER_SM, BWD_THREADS, STATE_EVERY,
                                            _MambaScan, bwd_blocks, mamba_scan_bwd_plain,
                                            mamba_scan_plain, mamba_scan_states_plain,
                                            n_states)

NAMES = ("du", "ddt", "dA", "dB", "dC", "dD", "dh0")
# the last three end in a padded stage of the kernel (T 9, 17, 513 against
# stages of 8 or 16 steps), on ragged widths (d_in 33, 40) and N 5
SHAPES = [(2, 37, 96, 4), (2, 64, 256, 16), (2, 9, 40, 5), (2, 17, 33, 16), (1, 513, 24, 4)]


def _inputs(bt, t, d_in, n, mamba_a, seed=0):
    """u, dt, A, B, C, D, h0, dy, dh_T as float32 numpy arrays; A as Mamba
    initialises it, -(1..N) on every channel, or drawn per (d, n)."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    u = f(bt, t, d_in)
    dt = np.log1p(np.exp(f(bt, t, d_in))).astype(np.float32)      # softplus
    A = (-np.tile(np.arange(1, n + 1, dtype=np.float32), (d_in, 1)) if mamba_a
         else -np.exp(f(d_in, n)))
    return (u, dt, A, f(bt, t, n), f(bt, t, n), f(d_in), f(bt, d_in, n),
            f(bt, t, d_in), f(bt, d_in, n))


def _close(name, got, want):
    """|diff| <= 1e-4 max|g| + 1e-6, as the gradient-leaf tests."""
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, name
    tol = 1e-4 * float(np.abs(want).max()) + 1e-6
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=name)


@pytest.fixture(scope="module")
def jax_vjp():
    """jax.vjp of the reference scan, jitted once per shape; h0 always given
    (zeros stand for none: the reference starts from zeros). The reference
    is a Python loop over steps, whose jit takes minutes to compile past a
    few hundred steps, so a longer scan is differentiated in segments of 32
    steps of the same function: the state carried forward segment by
    segment, then each segment's VJP from the last, its h0 gradient the
    next one's h_T cotangent."""
    def grads(u, dt, A, B, C, D, h0, dy, dh):
        _, vjp = jax.vjp(jref.mamba_scan_ref, u, dt, A, B, C, D, h0)
        return vjp((dy, dh))

    jgrads, fwd, seg = jax.jit(grads), jax.jit(jref.mamba_scan_ref), 32

    def chained(u, dt, A, B, C, D, h0, dy, dh):
        if u.shape[1] <= 64:
            return jgrads(u, dt, A, B, C, D, h0, dy, dh)
        cuts = [slice(t0, t0 + seg) for t0 in range(0, u.shape[1], seg)]
        starts = [h0]
        for sl in cuts[:-1]:
            starts.append(fwd(u[:, sl], dt[:, sl], A, B[:, sl], C[:, sl], D, starts[-1])[1])
        rows, dA, dD, g = [], 0.0, 0.0, dh
        for sl, h in zip(reversed(cuts), reversed(starts)):
            du, ddt, dA_s, dB, dC, dD_s, g = jgrads(u[:, sl], dt[:, sl], A, B[:, sl],
                                                    C[:, sl], D, h, dy[:, sl], g)
            rows.insert(0, (du, ddt, dB, dC))
            dA, dD = dA + dA_s, dD + dD_s
        du, ddt, dB, dC = (jnp.concatenate(x, 1) for x in zip(*rows))
        return du, ddt, dA, dB, dC, dD, g
    return chained


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("mamba_a", [True, False])
def test_bwd_plain_matches_jax_vjp(jax_vjp, shape, with_h0, mamba_a):
    u, dt, A, B, C, D, h0, dy, dh = _inputs(*shape, mamba_a)
    if not with_h0:
        h0 = np.zeros_like(h0)
    want = jax_vjp(*(jnp.asarray(x) for x in (u, dt, A, B, C, D, h0, dy, dh)))
    t = [torch.from_numpy(x) for x in (u, dt, A, B, C, D, h0, dy, dh)]
    got = mamba_scan_bwd_plain(*t[:6], t[7], t[6] if with_h0 else None, t[8])
    assert [g.dtype for g in got] == [torch.float32] * 7
    for name, g, w in zip(NAMES, got, want):
        _close(name, g, w)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("mamba_a", [True, False])
def test_bwd_plain_matches_torch_autograd(shape, with_h0, mamba_a):
    """Against autograd of the plain scan; without h0 the plain version's
    dh0 is the gradient of a zero initial state."""
    arrays = _inputs(*shape, mamba_a, seed=1)
    u, dt, A, B, C, D, h0, dy, dh = (torch.from_numpy(x) for x in arrays)
    h0 = h0 if with_h0 else torch.zeros_like(h0)
    leaves = [x.clone().requires_grad_(True) for x in (u, dt, A, B, C, D, h0)]
    y, h_t = mamba_scan_plain(*leaves)
    want = torch.autograd.grad((y, h_t), leaves, (dy, dh))
    got = mamba_scan_bwd_plain(u, dt, A, B, C, D, dy, h0 if with_h0 else None, dh)
    for name, g, w in zip(NAMES, got, want):
        _close(name, g, w.numpy())


def test_bwd_plain_keeps_the_dtypes_and_takes_no_dh_t():
    """bf16 u: du, dB, dC in bf16, the rest float32; no dh_T is zeros."""
    u, dt, A, B, C, D, h0, dy, _ = (torch.from_numpy(x)
                                    for x in _inputs(2, 20, 32, 4, False))
    ub, Bb, Cb, dyb = (x.bfloat16() for x in (u, B, C, dy))
    got = mamba_scan_bwd_plain(ub, dt, A, Bb, Cb, D, dyb, h0)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32, torch.float32,
                                      torch.bfloat16, torch.bfloat16, torch.float32,
                                      torch.float32]
    zero = mamba_scan_bwd_plain(ub, dt, A, Bb, Cb, D, dyb, h0,
                                torch.zeros((2, 32, 4)))
    for g, z in zip(got, zero):
        assert torch.equal(g, z)


@pytest.mark.parametrize("t", [1, 9, 15, 16, 17, 37, 64, 513])
@pytest.mark.parametrize("with_h0", [True, False])
def test_states_plain_saves_the_state_every_stage(t, with_h0):
    u, dt, A, B, C, D, h0, _, _ = (torch.from_numpy(x)
                                   for x in _inputs(2, t, 24, 4, False))
    h0 = h0 if with_h0 else None
    y, h_t, hs = mamba_scan_states_plain(u, dt, A, B, C, D, h0)
    y_ref, h_ref = mamba_scan_plain(u, dt, A, B, C, D, h0)
    assert torch.equal(y, y_ref) and torch.equal(h_t, h_ref)
    assert hs.shape == (2, n_states(t), 24, 4) and hs.dtype == torch.float32
    for k in range(n_states(t)):
        want = (torch.zeros((2, 24, 4)) if h0 is None and k == 0 else
                h0 if k == 0 else
                mamba_scan_plain(u[:, :k * STATE_EVERY], dt[:, :k * STATE_EVERY], A,
                                 B[:, :k * STATE_EVERY], C[:, :k * STATE_EVERY], D,
                                 h0)[1])
        assert torch.equal(hs[:, k], want), k


@pytest.mark.parametrize("d_in,n,blocks", [
    (16384, 16, 256),                  # Jamba: 64 channels a block
    (128, 4, 1), (257, 3, 2),          # the 4-wide instance: 256 channels
    (200, 5, 2), (65, 9, 2),           # the 8-wide instance: 128 channels
    (64, 16, 1), (129, 16, 3), (1, 1, 1)])
def test_backward_workspace_plan(d_in, n, blocks):
    """The backward's plan: blocks of 256 threads, four states a thread
    (1024 / NM channels a block), two blocks resident a SM (16 warps); the
    states saved every 16 steps; the blocks along d_in and the partial
    dB / dC rows they write."""
    assert (BWD_THREADS, BWD_BLOCKS_PER_SM, STATE_EVERY) == (256, 2, 16)
    assert n_states(512) == 32 and n_states(513) == 33 and n_states(1) == 1
    assert n_states(17) == 2 and n_states(16) == 1
    assert bwd_blocks(d_in, n) == blocks
    nm = 4 if n <= 4 else 8 if n <= 8 else 16
    assert (blocks - 1) * (1024 // nm) < d_in <= blocks * (1024 // nm)


def _staged_bwd(u, dt, A, B, C, D, dy, hs, dh_t, stride, stage):
    """The kernel's walk in float64 torch: T padded to whole stages of
    ``stride`` steps with dt = u = dy = B = C = 0; each stage recomputed from
    its saved state in sub-stages of ``stage`` steps (a later sub-stage
    advancing through the earlier ones first), every sub-stage's states and
    exponentials kept and walked back. Returns the seven gradients."""
    bt, t, d_in = u.shape
    n = A.shape[1]
    pad = -(-t // stride) * stride - t

    def padded(x):
        return torch.nn.functional.pad(x.double(), (0, 0, 0, pad))

    u, dt, dy, B, C = (padded(x) for x in (u, dt, dy, B, C))
    A, D = A.double(), D.double()
    g = torch.zeros((bt, d_in, n), dtype=torch.float64) if dh_t is None else dh_t.double()
    du, ddt = torch.zeros_like(u), torch.zeros_like(u)
    dB, dC, dA = torch.zeros_like(B), torch.zeros_like(C), torch.zeros_like(A)

    def step(h, i):
        e = torch.exp(dt[:, i, :, None] * A)
        return e, e * h + (dt[:, i, :, None] * B[:, i, None, :]) * u[:, i, :, None]

    for k in reversed(range(hs.shape[1])):
        for j in reversed(range(stride // stage)):
            t0 = k * stride + j * stage
            h = hs[:, k].double()
            for i in range(k * stride, t0):
                h = step(h, i)[1]
            hr, er = [h], []
            for i in range(t0, t0 + stage):
                e, h = step(h, i)
                hr.append(h)
                er.append(e)
            for tt in reversed(range(stage)):
                i = t0 + tt
                g = C[:, i, None, :] * dy[:, i, :, None] + g
                ge = g * (er[tt] * hr[tt])
                gB = (g * B[:, i, None, :]).sum(-1)
                du[:, i] = dt[:, i] * gB + D * dy[:, i]
                ddt[:, i] = (ge * A).sum(-1) + u[:, i] * gB
                dB[:, i] = (g * (dt[:, i] * u[:, i])[..., None]).sum(1)
                dC[:, i] = (dy[:, i, :, None] * hr[tt + 1]).sum(1)
                dA += (dt[:, i, :, None] * ge).sum(0)
                g = er[tt] * g
    return (du[:, :t], ddt[:, :t], dA, dB[:, :t], dC[:, :t], (dy * u).sum((0, 1)), g)


@pytest.mark.parametrize("t", [1, 9, 15, 17, 513])
@pytest.mark.parametrize("n", [5, 16])
def test_staged_walk_with_padded_stages(jax_vjp, t, n):
    """The kernel's stage arithmetic on the CPU: states saved every
    STATE_EVERY steps, walked in register sub-stages of 8 steps at N 16 and
    of 4 in the narrower instances (N 5 here), the last stage padded past T
    with zeros (e = 1, no input, g unchanged), against jax.vjp of the
    reference scan, with h0 and dh_T, on a ragged width (d_in 33)."""
    bt, d_in, stage = 2, 33, 8 if n > 8 else 4
    u, dt, A, B, C, D, h0, dy, dh = _inputs(bt, t, d_in, n, False, seed=4)
    want = jax_vjp(*(jnp.asarray(x) for x in (u, dt, A, B, C, D, h0, dy, dh)))
    tu, tdt, tA, tB, tC, tD, th0, tdy, tdh = (torch.from_numpy(x)
                                              for x in (u, dt, A, B, C, D, h0, dy, dh))
    hs = mamba_scan_states_plain(tu, tdt, tA, tB, tC, tD, th0)[2]
    assert hs.shape == (bt, n_states(t), d_in, n)
    got = _staged_bwd(tu, tdt, tA, tB, tC, tD, tdy, hs, tdh, STATE_EVERY, stage)
    for name, g, w in zip(NAMES, got, want):
        _close(name, g.float(), w)


class _Plain:
    """Stand-ins for the two launchers: the plain forward that saves states
    and the plain backward, which takes h0 from the saved states; each
    counts its calls."""

    def __init__(self):
        self.fwd = self.bwd = 0

    def train(self, u, dt, A, B, C, D, h0=None):
        self.fwd += 1
        return mamba_scan_states_plain(u, dt, A, B, C, D, h0)

    def backward(self, u, dt, A, B, C, D, hs, dy, dh_t=None):
        self.bwd += 1
        assert hs.shape[1] == n_states(u.shape[1])
        return mamba_scan_bwd_plain(u, dt, A, B, C, D, dy, hs[:, 0], dh_t)


@pytest.mark.parametrize("use_h_t", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
def test_mamba_scan_function_under_remat_with_column_slices(monkeypatch, use_h_t,
                                                            with_h0):
    """``_MambaScan`` with plain launchers: B and C column slices of one
    projection (strided over batch and time), the call inside a
    non-reentrant ``torch.utils.checkpoint`` as the model runs it. The
    gradients of u, dt, A, the projection, D and h0 equal autograd of the
    plain scan; the forward runs twice (remat), the backward once, and a
    dropped h_T reaches the backward as None."""
    plain = _Plain()
    seen = []

    def backward(*args):
        seen.append(args[-1] is None)
        return plain.backward(*args)

    monkeypatch.setattr(ms, "mamba_scan_train_cuda", plain.train)
    monkeypatch.setattr(ms, "mamba_scan_bwd_cuda", backward)
    bt, t, d_in, n = 2, 40, 48, 4
    u, dt, A, _, _, D, h0, dy, dh = (torch.from_numpy(x)
                                     for x in _inputs(bt, t, d_in, n, False, seed=2))
    proj = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (bt, t, 3 + 2 * n)).astype(np.float32))

    def run(scan, leaves):
        u_, dt_, A_, proj_, D_, h0_ = leaves
        h0_ = h0_ if with_h0 else None

        def body(u_, dt_, A_, proj_, D_):
            B, C = proj_[..., 3:3 + n], proj_[..., 3 + n:]
            assert not B.is_contiguous() and B.stride(1) == 3 + 2 * n
            return scan(u_, dt_, A_, B, C, D_, h0_)

        y, h_t = torch.utils.checkpoint.checkpoint(body, u_, dt_, A_, proj_, D_,
                                                   use_reentrant=False)
        loss = (y * dy).sum() + ((h_t * dh).sum() if use_h_t else 0.0)
        return torch.autograd.grad(loss, [x for x in leaves if x.requires_grad])

    def leaves():
        return [x.clone().requires_grad_(True) for x in (u, dt, A, proj, D)] + [
            h0.clone().requires_grad_(with_h0)]

    got = run(_MambaScan.apply, leaves())
    want = run(mamba_scan_plain, leaves())
    assert (plain.fwd, plain.bwd) == (2, 1)
    assert seen == [not use_h_t]
    assert len(got) == len(want) == 5 + with_h0
    for g, w in zip(got, want):
        _close("grad", g, w.numpy())
