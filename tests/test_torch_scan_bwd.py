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
from repro_torch.kernels.mamba_scan import (STATE_EVERY, _MambaScan, bwd_blocks,
                                            mamba_scan_bwd_plain, mamba_scan_plain,
                                            mamba_scan_states_plain, n_states)

NAMES = ("du", "ddt", "dA", "dB", "dC", "dD", "dh0")
SHAPES = [(2, 37, 96, 4), (2, 64, 256, 16)]


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
    (zeros stand for none: the reference starts from zeros)."""
    def grads(u, dt, A, B, C, D, h0, dy, dh):
        _, vjp = jax.vjp(jref.mamba_scan_ref, u, dt, A, B, C, D, h0)
        return vjp((dy, dh))
    return jax.jit(grads)


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


@pytest.mark.parametrize("t", [1, 15, 16, 37, 64])
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


def test_backward_workspace_plan():
    """The backward's blocks along d_in: 1024 / NM channels each."""
    assert n_states(512) == 32 and n_states(513) == 33 and n_states(1) == 1
    assert bwd_blocks(16384, 16) == 256
    assert bwd_blocks(128, 4) == 1 and bwd_blocks(257, 3) == 2
    assert bwd_blocks(200, 5) == 2 and bwd_blocks(64, 16) == 1 and bwd_blocks(65, 9) == 2


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
