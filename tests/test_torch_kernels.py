"""The port's kernel modules on the CPU against the JAX references.

Each plain version, and its ``ops`` entry point on CPU tensors, is held
against the JAX oracle in ``repro.kernels.ref`` and against the Pallas
kernel run in interpret mode, as ``tests/test_kernels_pallas.py`` runs it.
Inputs come from ``numpy.random.default_rng`` and go to both sides. The
CUDA kernels themselves are checked on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.rmsnorm import rmsnorm_pallas
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
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


def test_flash_attention_ragged_and_scale():
    """Ragged Sq (no tile multiple) and an explicit scale, vs the oracle."""
    rng = np.random.default_rng(2)
    qj, qt = both(rng.standard_normal((2, 6, 77, 32), np.float32), "float32")
    kj, kt = both(rng.standard_normal((2, 2, 77, 32), np.float32), "float32")
    vj, vt = both(rng.standard_normal((2, 2, 77, 32), np.float32), "float32")
    want = jref.attention_ref(qj, kj, vj, True, None, 0, scale=0.3)
    close(ops.flash_attention(qt, kt, vt, scale=0.3), want, "float32")


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
