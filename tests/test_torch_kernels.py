"""The port's kernel modules on the CPU against the JAX references.

Each plain version, and its ``ops`` entry point on CPU tensors, is held
against the JAX oracle in ``repro.kernels.ref`` and against the Pallas
kernel run in interpret mode, as ``tests/test_kernels_pallas.py`` runs it.
Inputs come from ``numpy.random.default_rng`` and go to both sides. The
CUDA kernels themselves are checked on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.mamba_scan import mamba_scan_pallas
from repro.kernels.rmsnorm import rmsnorm_pallas
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                 flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.mamba_scan import mamba_scan_cuda, mamba_scan_plain
from repro_torch.kernels.rmsnorm import rmsnorm_plain

# float32: the tolerance of test_kernels_pallas.py; bf16: one bf16 rounding
# of outputs of order 1 on either side
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def both(x: np.ndarray, dtype: str):
    """The same float32 numpy array as a JAX and a torch array of ``dtype``
    (both round to bf16 to nearest even)."""
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def close(t: torch.Tensor, j, dtype: str):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("rows,d", [(64, 128), (100, 256), (8, 60)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(rows, d, dtype):
    rng = np.random.default_rng(0)
    xj, xt = both(rng.standard_normal((rows, d), np.float32), dtype)
    s = rng.standard_normal(d).astype(np.float32)
    sj, st = jnp.asarray(s), torch.from_numpy(s)
    want = jref.rmsnorm_ref(xj, sj, 1e-5)
    pallas = rmsnorm_pallas(xj, sj, 1e-5, rows_blk=32)
    for got in (rmsnorm_plain(xt, st, 1e-5), ops.rmsnorm(xt, st, 1e-5),
                tref.rmsnorm_ref(xt, st, 1e-5)):
        assert got.dtype == xt.dtype and got.shape == xt.shape
        close(got, want, dtype)
        close(got, pallas, dtype)


FLASH_CASES = [
    # b, hq, hkv, sq, skv, d, causal, window
    (1, 6, 2, 64, 64, 32, True, None),      # GQA group 3, causal
    (2, 3, 1, 32, 64, 32, True, 16),        # group 3, window, offset 32
    (1, 4, 4, 64, 64, 16, False, None),     # full attention
    (1, 6, 2, 64, 128, 32, True, 48),       # group 3, window, offset 64
    (2, 4, 2, 64, 64, 16, False, 24),       # window without causal
]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax(b, hq, hkv, sq, skv, d, causal, window,
                                     dtype):
    rng = np.random.default_rng(1)
    qj, qt = both(rng.standard_normal((b, hq, sq, d), np.float32), dtype)
    kj, kt = both(rng.standard_normal((b, hkv, skv, d), np.float32), dtype)
    vj, vt = both(rng.standard_normal((b, hkv, skv, d), np.float32), dtype)
    offset = skv - sq
    want = jref.attention_ref(qj, kj, vj, causal, window, offset)
    pallas = flash_attention_pallas(qj, kj, vj, causal=causal, window=window,
                                    offset=offset, q_blk=32, kv_blk=32)
    for got in (flash_attention_plain(qt, kt, vt, causal, window, offset),
                ops.flash_attention(qt, kt, vt, causal=causal, window=window,
                                    offset=offset)):
        assert got.dtype == qt.dtype and got.shape == qt.shape
        close(got, want, dtype)
        close(got, pallas, dtype)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window,offset",
                         [c + (c[4] - c[3],) for c in FLASH_CASES] + [
    (1, 4, 2, 16, 24, 16, True, 4, 22),     # rows 5.. see no key: L = +inf
    (2, 6, 2, 20, 20, 32, False, 3, 30),    # not causal, every row empty
])
def test_flash_attention_lse_matches_jax(b, hq, hkv, sq, skv, d, causal, window,
                                         offset):
    """The plain version's log-sum-exp (what the bf16 forward kernel writes
    and its backward reads) against ``jax.nn.logsumexp`` of the scaled
    logits masked with jnp, float32 at 2e-5; +inf where a row sees no key,
    and the output unchanged by asking for L."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((b, hq, sq, d), np.float32)
    k = rng.standard_normal((b, hkv, skv, d), np.float32)
    v = rng.standard_normal((b, hkv, skv, d), np.float32)
    logits = jnp.einsum("bhgqd,bhkd->bhgqk",
                        jnp.asarray(q).reshape(b, hkv, hq // hkv, sq, d),
                        jnp.asarray(k)) * d ** -0.5
    m = jref._mask(sq, skv, causal, window, offset)
    lse = jax.nn.logsumexp(jnp.where(m, logits, -jnp.inf), axis=-1)
    want = np.asarray(jnp.where(m.any(axis=-1), lse, jnp.inf)).reshape(b, hq, sq)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    out, got = flash_attention_plain(qt, kt, vt, causal, window, offset,
                                     return_lse=True)
    assert got.dtype == torch.float32 and got.shape == (b, hq, sq)
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    assert torch.equal(out, flash_attention_plain(qt, kt, vt, causal, window,
                                                  offset))


def test_flash_attention_ragged_and_scale():
    """Ragged Sq (no tile multiple) and an explicit scale, vs the oracle."""
    rng = np.random.default_rng(2)
    qj, qt = both(rng.standard_normal((2, 6, 77, 32), np.float32), "float32")
    kj, kt = both(rng.standard_normal((2, 2, 77, 32), np.float32), "float32")
    vj, vt = both(rng.standard_normal((2, 2, 77, 32), np.float32), "float32")
    want = jref.attention_ref(qj, kj, vj, True, None, 0, scale=0.3)
    close(ops.flash_attention(qt, kt, vt, scale=0.3), want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_takes_strided_views(dtype):
    """q, k, v as the model passes them: (B, H, S, D) views of (B, S, H, D)
    tensors, GQA group 3 with a window and an offset."""
    rng = np.random.default_rng(3)
    b, hq, hkv, sq, skv, d, window = 2, 6, 2, 32, 64, 32, 40
    q = rng.standard_normal((b, sq, hq, d), np.float32)
    k = rng.standard_normal((b, skv, hkv, d), np.float32)
    v = rng.standard_normal((b, skv, hkv, d), np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (both(x.transpose(0, 2, 1, 3).copy(), dtype)
                                    for x in (q, k, v))
    views = [torch.from_numpy(x).to(getattr(torch, dtype)).transpose(1, 2)
             for x in (q, k, v)]
    assert not any(t.is_contiguous() for t in views)
    got = ops.flash_attention(*views, causal=True, window=window, offset=32)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    close(got, jref.attention_ref(qj, kj, vj, True, window, 32), dtype)
    close(got, flash_attention_pallas(qj, kj, vj, causal=True, window=window,
                                      offset=32, q_blk=32, kv_blk=32), dtype)


def test_flash_attention_wrapper_checks_strides_before_device():
    """The kernel wrapper refuses a last dim that is not contiguous, a stride
    or a pointer off 16 bytes and a scale that is not positive, before it
    looks for a CUDA device; it counts no launch."""
    q = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="last dim must be contiguous"):
        flash_attention_cuda(
            torch.zeros(1, 2, 8, 128, dtype=torch.bfloat16)[..., ::2], q, q)
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        flash_attention_cuda(torch.zeros(1, 2, 8, 68, dtype=torch.bfloat16)
                             [..., :64], q, q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_cuda(q, torch.zeros(1 + 2 * 8 * 64, dtype=torch.bfloat16)
                             [1:].view(1, 2, 8, 64), q)
    with pytest.raises(ValueError, match="must be positive"):
        flash_attention_cuda(q, q, q, scale=0.0)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q.transpose(1, 2).contiguous().transpose(1, 2),
                             q, q)
    with pytest.raises(ValueError, match="log-sum-exp"):
        flash_attention_cuda(q.float(), q.float(), q.float(), return_lse=True)
    assert flash_attention_cuda.launches == 0


@pytest.mark.parametrize("lse", [
    torch.zeros(1, 2, 7),                            # wrong shape
    torch.zeros(1, 2, 8, dtype=torch.bfloat16),      # wrong dtype
    torch.zeros(1, 2, 8, dtype=torch.float64),
    torch.zeros(1, 2, 16)[..., ::2],                 # not contiguous
])
def test_flash_attention_bwd_wrapper_checks_lse_before_device(lse):
    """The backward wrapper refuses an ``lse`` of the wrong shape, dtype or
    layout before it looks for a CUDA device, and counts nothing."""
    q = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="lse must be contiguous float32"):
        flash_attention_bwd_cuda(q, q, q, q, q, lse=lse)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_cuda(q, q, q, q, q, lse=torch.zeros(1, 2, 8))
    assert flash_attention_bwd_cuda.launches == 0
    assert flash_attention_bwd_cuda.lse_forwards == 0
    assert flash_attention_bwd_cuda.copies == 0


DECODE_CASES = [
    # b, hq, hkv, s, d
    (2, 6, 2, 40, 32),      # GQA group 3
    (3, 3, 1, 64, 16),      # MQA, group 3
    (1, 8, 8, 32, 64),
]


@pytest.mark.parametrize("b,hq,hkv,s,d", DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax(b, hq, hkv, s, d, dtype):
    rng = np.random.default_rng(3)
    qj, qt = both(rng.standard_normal((b, hq, d), np.float32), dtype)
    kj, kt = both(rng.standard_normal((b, hkv, s, d), np.float32), dtype)
    vj, vt = both(rng.standard_normal((b, hkv, s, d), np.float32), dtype)
    length = rng.integers(1, s + 1, b).astype(np.int32)      # ragged
    lj, lt = jnp.asarray(length), torch.from_numpy(length)
    want = jref.decode_attention_ref(qj, kj, vj, length=lj)
    pallas = decode_attention_pallas(qj, kj, vj, length=lj, kv_blk=8)
    for got in (decode_attention_plain(qt, kt, vt, lt),
                ops.decode_attention(qt, kt, vt, length=lt)):
        assert got.dtype == qt.dtype and got.shape == qt.shape
        close(got, want, dtype)
        close(got, pallas, dtype)


@pytest.mark.parametrize("window", [1, 5, 24])
def test_decode_attention_window_matches_ref(window):
    """``window`` as decode_attention_ref applies it (the Pallas kernel
    ignores it, so it is not a reference here)."""
    rng = np.random.default_rng(4)
    qj, qt = both(rng.standard_normal((3, 6, 32), np.float32), "float32")
    kj, kt = both(rng.standard_normal((3, 2, 40, 32), np.float32), "float32")
    vj, vt = both(rng.standard_normal((3, 2, 40, 32), np.float32), "float32")
    length = np.array([40, 17, 3], np.int32)
    want = jref.decode_attention_ref(qj, kj, vj, length=jnp.asarray(length),
                                     window=window)
    got = ops.decode_attention(qt, kt, vt, length=torch.from_numpy(length),
                               window=window)
    close(got, want, "float32")


def test_decode_attention_default_length_is_full_cache():
    rng = np.random.default_rng(5)
    qj, qt = both(rng.standard_normal((2, 4, 16), np.float32), "float32")
    kj, kt = both(rng.standard_normal((2, 2, 24, 16), np.float32), "float32")
    vj, vt = both(rng.standard_normal((2, 2, 24, 16), np.float32), "float32")
    close(ops.decode_attention(qt, kt, vt),
          jref.decode_attention_ref(qj, kj, vj), "float32")


@pytest.mark.parametrize("sq,skv,causal,window,offset", [
    (8, 8, True, None, 0), (4, 12, True, 3, 8), (6, 6, False, 2, 0)])
def test_mask_matches_jax(sq, skv, causal, window, offset):
    np.testing.assert_array_equal(
        tref._mask(sq, skv, causal, window, offset).numpy(),
        np.asarray(jref._mask(sq, skv, causal, window, offset)))


# the scan's float32 tolerance is that of test_kernels_pallas.py's Mamba test
SCAN_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _scan_inputs(seed, bt, t, d_in, n, with_h0=False):
    """u, dt = softplus(normal), A = -softplus(normal), B, C, D and h0 (or
    None) as float32 numpy arrays."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def softplus(x):
        return np.logaddexp(x, 0).astype(np.float32)

    return (normal(bt, t, d_in), softplus(normal(bt, t, d_in)),
            -softplus(normal(d_in, n)), normal(bt, t, n), normal(bt, t, n),
            normal(d_in), normal(bt, d_in, n) if with_h0 else None)


def _close_scan(got, want, dtype):
    (gy, gh), (wy, wh) = got, want
    np.testing.assert_allclose(gy.float().numpy(), np.asarray(wy, np.float32),
                               atol=SCAN_TOL[dtype], rtol=SCAN_TOL[dtype])
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh, np.float32),
                               atol=SCAN_TOL["float32"],
                               rtol=SCAN_TOL["float32"])


@pytest.mark.parametrize("bt,t,d_in,n,d_blk,with_h0", [
    (2, 16, 64, 8, 32, False),      # the shapes of test_kernels_pallas.py
    (1, 32, 128, 16, 64, False),
    (3, 8, 32, 4, 32, False),
    (2, 12, 64, 16, 64, True),      # a given initial state
    (2, 9, 100, 16, 100, False),    # ragged d_in
    (1, 1, 48, 4, 48, True),        # one step, batch 1
])
def test_mamba_scan_matches_jax(bt, t, d_in, n, d_blk, with_h0):
    arrays = _scan_inputs(7, bt, t, d_in, n, with_h0)
    jargs = [None if a is None else jnp.asarray(a) for a in arrays]
    targs = [None if a is None else torch.from_numpy(a) for a in arrays]
    want = jref.mamba_scan_ref(*jargs)
    pallas = mamba_scan_pallas(*jargs, d_blk=d_blk)
    for got in (mamba_scan_plain(*targs), ops.mamba_scan(*targs),
                tref.mamba_scan_ref(*targs)):
        assert got[0].dtype == torch.float32 and got[0].shape == (bt, t, d_in)
        assert got[1].dtype == torch.float32 and got[1].shape == (bt, d_in, n)
        _close_scan(got, want, "float32")
        _close_scan(got, pallas, "float32")


def test_mamba_scan_bf16_u_with_float32_dt():
    """The model's mix: u, B, C bf16, dt float32 (softplus promotes), A and
    D float32; y comes back bf16, h_T float32."""
    u, dt, A, B, C, D, h0 = _scan_inputs(8, 2, 20, 64, 16, with_h0=True)
    (uj, ut), (bj, bt), (cj, ct) = (both(a, "bfloat16") for a in (u, B, C))
    dtj, aj, dj, h0j = (jnp.asarray(a) for a in (dt, A, D, h0))
    want = jref.mamba_scan_ref(uj, dtj, aj, bj, cj, dj, h0j)
    pallas = mamba_scan_pallas(uj, dtj, aj, bj, cj, dj, h0j, d_blk=64)
    got = ops.mamba_scan(ut, *(torch.from_numpy(a) for a in (dt, A)), bt, ct,
                         *(torch.from_numpy(a) for a in (D, h0)))
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    _close_scan(got, want, "bfloat16")
    _close_scan(got, pallas, "bfloat16")


def test_mamba_step_matches_jax_and_the_scan():
    """One step against the reference's ``ops.mamba_step``, and T steps
    against one scan over the same T (how serving prefills a prompt)."""
    u, dt, A, B, C, D, h0 = _scan_inputs(9, 2, 6, 32, 8, with_h0=True)
    jy, jh = jops.mamba_step(*(jnp.asarray(a) for a in
                               (u[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], D,
                                h0)))
    tu, tdt, tA, tB, tC, tD, th0 = (torch.from_numpy(a)
                                    for a in (u, dt, A, B, C, D, h0))
    ty, th = ops.mamba_step(tu[:, 0], tdt[:, 0], tA, tB[:, 0], tC[:, 0], tD,
                            th0)
    _close_scan((ty, th), (jy, jh), "float32")
    h, ys = th0, []
    for i in range(u.shape[1]):
        y, h = ops.mamba_step(tu[:, i], tdt[:, i], tA, tB[:, i], tC[:, i], tD,
                              h)
        ys.append(y)
    sy, sh = ops.mamba_scan(tu, tdt, tA, tB, tC, tD, th0)
    _close_scan((torch.stack(ys, 1), h), (sy.numpy(), sh.numpy()), "float32")


def test_mamba_scan_wrapper_checks_shapes_before_device():
    """The kernel wrapper refuses mismatched shapes and, for well-shaped
    tensors that are not on a CUDA device, says so; it counts no launch."""
    u = torch.empty(2, 5, 16, device="meta")
    A, D = torch.empty(16, 4, device="meta"), torch.empty(16, device="meta")
    B = torch.empty(2, 5, 4, device="meta")
    with pytest.raises(ValueError, match="B has shape"):
        mamba_scan_cuda(u, u, A, B[:, :4], B, D)
    with pytest.raises(ValueError, match="h0 has shape"):
        mamba_scan_cuda(u, u, A, B, B, D, h0=torch.empty(2, 16, 5))
    with pytest.raises(ValueError, match="CUDA"):
        mamba_scan_cuda(u, u, A, B, B, D)
    assert mamba_scan_cuda.launches == 0
