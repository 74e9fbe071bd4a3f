"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where there is no CUDA device. On a machine
with one: ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
This file imports no JAX, so it runs where only PyTorch is installed.
"""
import dataclasses
import shutil

import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from repro_torch.configs import get
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                  decode_attention_plain,
                                                  split_plan)
from repro_torch.kernels.flash_attention import (INSTANCES,
                                                 flash_attention_bwd_cuda,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.mamba_scan import (BLOCKS_PER_SM, BWD_BLOCKS_PER_SM,
                                            CHANNELS_PER_BLOCK, blocks_per_sm,
                                            bwd_blocks_per_sm, mamba_scan_bwd_cuda,
                                            mamba_scan_bwd_plain, mamba_scan_cuda,
                                            mamba_scan_plain, mamba_scan_states_plain,
                                            mamba_scan_train_cuda)
from repro_torch.kernels.adamw import (adamw_update_cuda, adamw_update_plain,
                                       clip_finalize_cuda, clip_finalize_plain,
                                       global_norm_scale, global_norm_scale_cuda,
                                       global_norm_scale_plain, sumsq_blocks,
                                       sumsq_cuda, sumsq_plain)
from repro_torch.kernels.rmsnorm import (rmsnorm_bwd_cuda, rmsnorm_bwd_plain,
                                         rmsnorm_cuda, rmsnorm_plain)
from repro_torch.launch import serve
from repro_torch.launch.graphs import GraphedStep, StepGraph
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.launch.train import train
from repro_torch.models import frontends, model_api, transformer
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.optim.optimizers import adamw, warmup_cosine

pytestmark = pytest.mark.cuda

# float32: summation order only; bf16: one rounding of the output
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _close(got, want, dtype):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


# and row counts that are no multiple of the rows a block or a persistent
# grid takes, at widths of every path: warp per row (768, 960, 1536 in
# bf16), block per row (8192; 1536 in float32), scalar (20 and 1001 are no
# multiple of the vector width)
@pytest.mark.parametrize("rows,d", [(4096, 960), (8, 960), (3, 1001),
                                    (5, 8192), (7, 20)] + [
    (rows, d) for rows in (1, 3, 4097)
    for d in (20, 768, 960, 1001, 1536, 8192)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm(gen, rows, d, dtype):
    x = _randn(gen, (rows, d), dtype)
    s = _randn(gen, (d,), torch.float32)
    _close(rmsnorm_cuda(x, s, 1e-5), rmsnorm_plain(x, s, 1e-5), dtype)


@pytest.mark.parametrize("d", [960, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_unaligned_view_takes_the_scalar_path(gen, d, dtype):
    rows = 5
    buf = _randn(gen, (rows * d + 1,), dtype)
    x = buf[1:].view(rows, d)
    assert x.is_contiguous() and x.data_ptr() % 16
    s = _randn(gen, (d,), torch.float32)
    _close(rmsnorm_cuda(x, s, 1e-5), rmsnorm_plain(x, s, 1e-5), dtype)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", [
    (2, 15, 5, 512, 512, 64, True, None),
    (1, 6, 2, 77, 77, 64, True, None),
    (2, 32, 8, 100, 300, 80, True, 64),     # D 80, window, offset 200
    (1, 8, 2, 64, 200, 32, False, None),
    (1, 16, 2, 130, 130, 128, True, 40),
    (2, 4, 4, 1, 33, 64, True, None),       # Sq = 1
    (2, 15, 5, 2048, 2048, 64, True, None),  # 32 kv tiles: the stage ring wraps
    (1, 64, 8, 512, 512, 128, True, None),  # Jamba's G = 8, D = 128
    (2, 6, 2, 200, 300, 64, False, None),   # ragged Skv, not causal
    (1, 4, 1, 96, 160, 32, True, 48),       # D 32, window, offset 64
    (1, 5, 1, 70, 70, 128, True, None),     # G = 5: one q head per block
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention(gen, b, hq, hkv, sq, skv, d, causal, window, dtype):
    q = _randn(gen, (b, hq, sq, d), dtype)
    k = _randn(gen, (b, hkv, skv, d), dtype)
    v = _randn(gen, (b, hkv, skv, d), dtype)
    off = skv - sq
    _close(flash_attention_cuda(q, k, v, causal, window, off),
           flash_attention_plain(q, k, v, causal, window, off), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_takes_strided_views(gen, dtype):
    """(B, H, S, D) views of (B, S, H, D) tensors, as the model passes them;
    the output is laid out as q is, so its (B, S, H, D) view is contiguous."""
    q = _randn(gen, (2, 300, 15, 64), dtype).transpose(1, 2)
    kv = _randn(gen, (2, 300, 2, 5, 64), dtype)
    k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    got = flash_attention_cuda(q, k, v, True, None, 0)
    assert got.transpose(1, 2).is_contiguous()
    _close(got, flash_attention_plain(q, k, v, True, None, 0), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_fully_masked_rows_are_zero(gen, dtype):
    """A window shorter than the gap between the offset and Skv leaves rows
    with no key: the kernel's contract is 0 there (attention_ref would give
    the mean of V); every other row matches the plain version."""
    b, hq, hkv, sq, skv, d, window, offset = 2, 6, 2, 80, 100, 64, 8, 60
    q = _randn(gen, (b, hq, sq, d), dtype)
    k, v = _randn(gen, (b, hkv, skv, d), dtype), _randn(gen, (b, hkv, skv, d), dtype)
    want = flash_attention_plain(q, k, v, True, window, offset)
    empty = (torch.arange(sq, device="cuda") + offset - window + 1) >= skv
    assert 0 < int(empty.sum()) < sq
    want[:, :, empty] = 0
    _close(flash_attention_cuda(q, k, v, True, window, offset), want, dtype)


@pytest.mark.parametrize("b,hq,hkv,s,d,window", [
    (8, 15, 5, 129, 64, None), (3, 16, 2, 700, 128, None),
    (4, 32, 8, 50, 80, 16), (2, 4, 4, 64, 32, 1),
    (8, 64, 8, 129, 128, None),    # Jamba's G 8, D 128: two tiles of 4 rows
    (3, 16, 2, 300, 80, None),     # D 80: masked lanes in each row's group
    (2, 32, 2, 200, 128, None),    # G 16: four tiles
    (2, 10, 2, 90, 32, None)])     # G 5: tiles of 4 and 1 rows
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention(gen, b, hq, hkv, s, d, window, dtype):
    q = _randn(gen, (b, hq, d), dtype)
    k = _randn(gen, (b, hkv, s, d), dtype)
    v = _randn(gen, (b, hkv, s, d), dtype)
    length = torch.randint(1, s + 1, (b,), generator=gen, device="cuda",
                           dtype=torch.int32)
    _close(decode_attention_cuda(q, k, v, length, window),
           decode_attention_plain(q, k, v, length, window), dtype)


def _decode_inputs(gen, b, hq, hkv, s, d, dtype):
    q = _randn(gen, (b, hq, d), dtype)
    k = _randn(gen, (b, hkv, s, d), dtype)
    v = _randn(gen, (b, hkv, s, d), dtype)
    return q, k, v


def _lengths(*values):
    return torch.tensor(values, dtype=torch.int32, device="cuda")


@pytest.mark.parametrize("s", [700, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_long_cache(gen, s, dtype):
    """Caches cut into several splits: lengths of 1, S, inside the last
    split only, and ragged ones in between."""
    q, k, v = _decode_inputs(gen, 6, 15, 5, s, 64, dtype)
    n_split, chunk = split_plan(6, 5, 3, s, 132)
    assert n_split > 1
    length = _lengths(1, s, (n_split - 1) * chunk + 1, s - 1, s // 2, 37)
    _close(decode_attention_cuda(q, k, v, length),
           decode_attention_plain(q, k, v, length), dtype)


@pytest.mark.parametrize("window", [1, 40, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_window_crosses_splits(gen, window, dtype):
    s = 700
    q, k, v = _decode_inputs(gen, 4, 8, 2, s, 64, dtype)
    _, chunk = split_plan(4, 2, 4, s, 132)
    length = _lengths(chunk + window // 2, s, 2 * chunk + 3, window)
    _close(decode_attention_cuda(q, k, v, length, window),
           decode_attention_plain(q, k, v, length, window), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_zero_length_row_is_zero(gen, dtype):
    """A sequence with no valid key returns 0 (the plain version would give
    the mean of V); the other rows of the batch match the plain version."""
    q, k, v = _decode_inputs(gen, 3, 15, 5, 700, 64, dtype)
    length = _lengths(300, 0, 700)
    want = decode_attention_plain(q, k, v, length)
    want[1] = 0
    _close(decode_attention_cuda(q, k, v, length), want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_back_to_back_calls(gen, dtype):
    """Two calls in a row on one stream, with other lengths: the second
    sees nothing of the first (each cluster combines its own splits)."""
    q, k, v = _decode_inputs(gen, 8, 15, 5, 700, 64, dtype)
    first, second = _lengths(700, 1, 350, 5, 699, 64, 128, 600), \
        _lengths(3, 700, 1, 400, 2, 650, 700, 90)
    got1 = decode_attention_cuda(q, k, v, first)
    got2 = decode_attention_cuda(q, k, v, second)
    _close(got1, decode_attention_plain(q, k, v, first), dtype)
    _close(got2, decode_attention_plain(q, k, v, second), dtype)


def _scan_inputs(gen, bt, t, d_in, n, u_dtype, with_h0):
    """u, B, C in ``u_dtype``; dt, A, D, h0 float32, as the model has them."""
    u = _randn(gen, (bt, t, d_in), u_dtype)
    dt = torch.nn.functional.softplus(_randn(gen, (bt, t, d_in),
                                             torch.float32))
    A = -torch.nn.functional.softplus(_randn(gen, (d_in, n), torch.float32))
    B, C = _randn(gen, (bt, t, n), u_dtype), _randn(gen, (bt, t, n), u_dtype)
    D = _randn(gen, (d_in,), torch.float32)
    h0 = _randn(gen, (bt, d_in, n), torch.float32) if with_h0 else None
    return u, dt, A, B, C, D, h0


def _close_scan(got, want, u_dtype):
    torch.cuda.synchronize()
    tol = 1e-4 if u_dtype == torch.float32 else 3e-2
    assert got[0].dtype == u_dtype and got[1].dtype == torch.float32
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("bt,t,d_in,n,with_h0", [
    (2, 300, 512, 16, False), (2, 64, 256, 4, False),
    (3, 100, 100, 16, True),        # ragged d_in, initial state
    (1, 1, 64, 16, False),          # one step, batch 1
    (2, 70, 384, 8, True), (1, 33, 130, 5, False)])
@pytest.mark.parametrize("u_dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan(gen, bt, t, d_in, n, with_h0, u_dtype):
    args = _scan_inputs(gen, bt, t, d_in, n, u_dtype, with_h0)
    _close_scan(mamba_scan_cuda(*args), mamba_scan_plain(*args), u_dtype)


def test_mamba_scan_takes_column_slices(gen):
    """B and C as the model passes them: column slices of the x_proj
    output, strided over batch and time."""
    u, dt, A, _, _, D, h0 = _scan_inputs(gen, 2, 50, 256, 16, torch.bfloat16,
                                         True)
    proj = _randn(gen, (2, 50, 8 + 32), torch.bfloat16)
    B, C = proj[..., 8:24], proj[..., 24:]
    assert not B.is_contiguous()
    _close_scan(mamba_scan_cuda(u, dt, A, B, C, D, h0),
                mamba_scan_plain(u, dt, A, B, C, D, h0), torch.bfloat16)


# edges of the kernel's pipeline (stages of 16 time steps, blocks of 128
# channels; u and dt rows by bulk copy when d_in is a multiple of 8 for bf16
# or 4 for float32, else by the producer's element loads)
@pytest.mark.parametrize("bt,t,d_in,n,with_h0", [
    (1, 7, 256, 16, False),     # T shorter than one stage
    (1, 16, 128, 1, True),      # exactly one stage, N 1
    (2, 37, 200, 5, True),      # T past whole stages; last block of 72 channels
    (2, 49, 100, 16, True),     # d_in 100: bulk rows in float32, not in bf16
    (1, 33, 130, 1, False),     # d_in 130: element loads in both dtypes
    (3, 100, 384, 5, False),    # the ring wraps; N 5 in the 8-wide instance
])
@pytest.mark.parametrize("u_dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_pipeline_edges(gen, bt, t, d_in, n, with_h0, u_dtype):
    args = _scan_inputs(gen, bt, t, d_in, n, u_dtype, with_h0)
    _close_scan(mamba_scan_cuda(*args), mamba_scan_plain(*args), u_dtype)


@pytest.mark.parametrize("n", [1, 5, 16])
@pytest.mark.parametrize("u_dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_takes_unaligned_column_slices(gen, n, u_dtype):
    """B and C at an offset of 3 elements in rows of an odd width: neither
    their start nor their time stride is 16-byte aligned."""
    u, dt, A, _, _, D, h0 = _scan_inputs(gen, 2, 40, 256, n, u_dtype, True)
    proj = _randn(gen, (2, 40, 2 * n + 5), u_dtype)   # an odd width
    B, C = proj[..., 3:3 + n], proj[..., 3 + n:3 + 2 * n]
    assert B.data_ptr() % 16 and (B.stride(1) * B.element_size()) % 16
    _close_scan(mamba_scan_cuda(u, dt, A, B, C, D, h0),
                mamba_scan_plain(u, dt, A, B, C, D, h0), u_dtype)


@pytest.mark.parametrize("u_dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_unaligned_u_takes_element_loads(gen, u_dtype):
    """u and dt contiguous but one element past a 16-byte boundary."""
    bt, t, d_in, n = 2, 30, 256, 16
    _, _, A, B, C, D, h0 = _scan_inputs(gen, bt, t, d_in, n, u_dtype, True)
    u = _randn(gen, (bt * t * d_in + 1,), u_dtype)[1:].view(bt, t, d_in)
    dt = torch.nn.functional.softplus(_randn(gen, (bt * t * d_in + 1,),
                                             torch.float32))[1:].view(bt, t, d_in)
    assert u.data_ptr() % 16 and dt.data_ptr() % 16
    _close_scan(mamba_scan_cuda(u, dt, A, B, C, D, h0),
                mamba_scan_plain(u, dt, A, B, C, D, h0), u_dtype)


@pytest.mark.parametrize("n", [4, 8, 16])
@pytest.mark.parametrize("u_dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_plan_fits_the_card(gen, n, u_dtype):
    """Every instance holds at least the plan's blocks per SM, the forward's
    and the backward's; at N 16, Jamba's prefill (8 x 16384 channels)
    fills a whole number of waves to within 10%."""
    blocks = blocks_per_sm(n, u_dtype)
    assert blocks >= BLOCKS_PER_SM
    assert bwd_blocks_per_sm(n, u_dtype) >= BWD_BLOCKS_PER_SM
    if n == 16:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        waves = 8 * 16384 / CHANNELS_PER_BLOCK / (sms * blocks)
        assert waves - int(waves) >= 0.9 or waves == int(waves), waves


def _close_scan_bwd(got, want, u_dtype):
    """The backward's seven gradients: float32 ones (all of them for float32
    u; ddt, dA, dD, dh0 for bf16 u) as gradient leaves, |diff| <= 1e-4
    max|g| + 1e-6 (dA sums over every batch row and step: at 2 x 513 steps
    the plain version's own float32 error against float64 reaches 1.2x an
    elementwise 1e-4 + 1e-4 |g|); bf16 ones (du, dB, dC) per element to one
    bf16 ulp of the plain value plus 2^-5 rms(plain)."""
    torch.cuda.synchronize()
    for name, g, w in zip(("du", "ddt", "dA", "dB", "dC", "dD", "dh0"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if w.dtype == torch.bfloat16:
            _close_scaled(g, w)
        else:
            tol = 1e-4 * float(w.abs().max()) + 1e-6
            torch.testing.assert_close(g, w, atol=tol, rtol=0, msg=name)


@pytest.mark.parametrize("bt,t,d_in,n,with_h0,with_dh", [
    (2, 1, 64, 4, True, True),       # one step
    (2, 15, 200, 4, False, False),   # less than a stage; ragged d_in
    (2, 513, 256, 16, True, False),  # stages past 512; Jamba's N
    (1, 37, 100, 16, False, True),   # ragged d_in in the 16-wide instance
    (3, 70, 130, 5, True, True),     # N 5 in the 8-wide instance
    (2, 33, 300, 1, False, True),    # N 1; several blocks of 256 channels
    (2, 9, 64, 16, True, True),      # the last stage padded past T = 9
    (2, 17, 96, 16, False, True),    # one step into a second stage
    (2, 40, 129, 16, True, True),    # d_in 129 at N 16: a ragged last block
    (2, 23, 131, 5, False, True)])   # d_in odd at N 5: rows by plain loads
@pytest.mark.parametrize("u_dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_bwd(gen, bt, t, d_in, n, with_h0, with_dh, u_dtype):
    """The training forward against the plain forward that saves states, and
    the backward kernel on its states against the plain backward, with B
    and C column slices of one projection; two calls give the same bits."""
    u, dt, A, _, _, D, h0 = _scan_inputs(gen, bt, t, d_in, n, u_dtype, with_h0)
    proj = _randn(gen, (bt, t, 5 + 2 * n), u_dtype)
    B, C = proj[..., 5:5 + n], proj[..., 5 + n:]
    dy = _randn(gen, (bt, t, d_in), u_dtype)
    dh = _randn(gen, (bt, d_in, n), torch.float32) if with_dh else None
    y, h_t, hs = mamba_scan_train_cuda(u, dt, A, B, C, D, h0)
    y_p, h_p, hs_p = mamba_scan_states_plain(u, dt, A, B, C, D, h0)
    _close_scan((y, h_t), (y_p, h_p), u_dtype)
    torch.testing.assert_close(hs, hs_p, atol=1e-4, rtol=1e-4)
    got = mamba_scan_bwd_cuda(u, dt, A, B, C, D, hs, dy, dh)
    _close_scan_bwd(got, mamba_scan_bwd_plain(u, dt, A, B, C, D, dy, h0, dh), u_dtype)
    again = mamba_scan_bwd_cuda(u, dt, A, B, C, D, hs, dy, dh)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x = _randn(gen, (4, 64), torch.float16)
    with pytest.raises(TypeError):
        rmsnorm_cuda(x, torch.ones(64, device="cuda"))
    q = _randn(gen, (1, 2, 8, 48), torch.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        flash_attention_cuda(q, q, q)
    q = _randn(gen, (1, 2, 8, 64), torch.float32)
    with pytest.raises(ValueError, match="contiguous"):  # last dim strided
        flash_attention_cuda(q.transpose(2, 3).contiguous().transpose(2, 3),
                             q, q)
    with pytest.raises(ValueError, match="length"):
        decode_attention_cuda(q[:, :, 0], q, q,
                              torch.ones(1, dtype=torch.int64, device="cuda"))
    buf = _randn(gen, (1 * 2 * 64 + 1,), torch.float32)  # rows of 16-byte loads
    with pytest.raises(ValueError, match="aligned"):
        decode_attention_cuda(buf[1:].view(1, 2, 64), q, q)
    u, dt, A, B, C, D, _ = _scan_inputs(gen, 1, 4, 32, 17, torch.float32,
                                        False)
    with pytest.raises(NotImplementedError, match="state width"):
        mamba_scan_cuda(u, dt, A, B, C, D)
    with pytest.raises(TypeError, match="u's dtype"):
        mamba_scan_cuda(u, dt, A[:, :4], B[..., :4].bfloat16(), C[..., :4], D)
    with pytest.raises(TypeError, match="dt float32"):
        mamba_scan_cuda(u, dt.bfloat16(), A[:, :4], B[..., :4], C[..., :4], D)


# ---------------------------------------------------------------------------
# small head dims (the SMOKE configs'), backward kernels, autograd
# ---------------------------------------------------------------------------

# dq/dk/dv sum over more rows than the forward's outputs (every q row of G
# heads for dk/dv): float32 differs in summation order only; bf16 by one
# rounding of the output
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


def _close_tol(got, want, tol):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", [
    (2, 3, 1, 24, 24, 20, True, None),      # smollm SMOKE
    (2, 4, 2, 32, 32, 16, True, 16),        # danube SMOKE: window 16
    (1, 4, 2, 70, 150, 16, True, 33),       # ragged, window, offset 80
    (2, 6, 3, 65, 65, 20, False, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_small_head_dims(gen, b, hq, hkv, sq, skv, d, causal,
                                         window, dtype):
    if dtype == torch.bfloat16 and d == 20:
        pytest.skip("bf16 rows of 20 are not 16-byte multiples: no instance")
    q = _randn(gen, (b, hq, sq, d), dtype)
    k = _randn(gen, (b, hkv, skv, d), dtype)
    v = _randn(gen, (b, hkv, skv, d), dtype)
    off = skv - sq
    _close(flash_attention_cuda(q, k, v, causal, window, off),
           flash_attention_plain(q, k, v, causal, window, off), dtype)


@pytest.mark.parametrize("d", [16, 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_small_head_dims(gen, d, dtype):
    if dtype == torch.bfloat16 and d == 20:
        with pytest.raises(NotImplementedError, match="head dim 20"):
            decode_attention_cuda(*_decode_inputs(gen, 2, 3, 1, 40, d, dtype))
        return
    for b, hq, hkv, s in ((2, 3, 1, 40), (3, 4, 2, 129), (2, 4, 2, 16)):
        q, k, v = _decode_inputs(gen, b, hq, hkv, s, d, dtype)
        length = torch.randint(1, s + 1, (b,), generator=gen, device="cuda",
                               dtype=torch.int32)
        _close(decode_attention_cuda(q, k, v, length),
               decode_attention_plain(q, k, v, length), dtype)


def _bwd_case(gen, b, hq, hkv, sq, skv, d, dtype):
    q = _randn(gen, (b, hq, sq, d), dtype)
    k = _randn(gen, (b, hkv, skv, d), dtype)
    v = _randn(gen, (b, hkv, skv, d), dtype)
    do = _randn(gen, (b, hq, sq, d), dtype)
    return q, k, v, do


BWD_CASES = [
    # b, hq, hkv, sq, skv, d, causal, window: G 1, 3 and 8; D 16-128
    (2, 15, 5, 512, 512, 64, True, None),   # smollm's training shape, cut
    (1, 3, 1, 77, 77, 20, True, None),      # G 3, D 20, ragged
    (2, 4, 2, 32, 32, 16, True, 16),        # danube SMOKE, window
    (1, 8, 1, 100, 300, 32, True, 64),      # G 8, window, offset 200
    (1, 2, 2, 70, 130, 80, True, None),     # G 1, D 80, offset 60
    (1, 16, 2, 130, 130, 128, True, 40),    # G 8, D 128, window
    (2, 6, 2, 90, 200, 64, False, None),    # not causal, ragged Skv
    (1, 4, 4, 1, 33, 16, True, None),       # Sq 1
    (1, 6, 2, 64, 64, 20, False, 10),       # window without causal
]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd(gen, b, hq, hkv, sq, skv, d, causal, window,
                             dtype):
    if dtype == torch.bfloat16 and d == 20:
        pytest.skip("bf16 rows of 20 are not 16-byte multiples: no instance")
    q, k, v, do = _bwd_case(gen, b, hq, hkv, sq, skv, d, dtype)
    off = skv - sq
    o = flash_attention_cuda(q, k, v, causal, window, off)
    got = flash_attention_bwd_cuda(q, k, v, o, do, causal, window, off)
    want = flash_attention_bwd_plain(q, k, v, o, do, causal, window, off)
    for g, w in zip(got, want):
        _close_tol(g, w, BWD_TOL[dtype])


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", BWD_CASES)
def test_flash_attention_bwd_bf16_takes_the_forwards_lse(gen, b, hq, hkv, sq, skv,
                                                         d, causal, window):
    """bf16 runs the tensor-core kernel: with L from the forward (as
    ``_FlashAttention`` passes it) and without (the wrapper runs the forward
    once more for it, counted in ``lse_forwards``), both against the plain
    version at BWD_TOL, and both give the same bits, call after call (no
    atomics)."""
    if d == 20:
        pytest.skip("bf16 rows of 20 are not 16-byte multiples: no instance")
    dtype = torch.bfloat16
    assert INSTANCES[dtype] == "wgmma"
    q, k, v, do = _bwd_case(gen, b, hq, hkv, sq, skv, d, dtype)
    off = skv - sq
    o, lse = flash_attention_cuda(q, k, v, causal, window, off, return_lse=True)
    n = flash_attention_bwd_cuda.lse_forwards
    got = flash_attention_bwd_cuda(q, k, v, o, do, causal, window, off, lse=lse)
    assert flash_attention_bwd_cuda.lse_forwards == n
    want = flash_attention_bwd_plain(q, k, v, o, do, causal, window, off)
    for g, w in zip(got, want):
        _close_tol(g, w, BWD_TOL[dtype])
    again = flash_attention_bwd_cuda(q, k, v, o, do, causal, window, off, lse=lse)
    without = flash_attention_bwd_cuda(q, k, v, o, do, causal, window, off)
    assert flash_attention_bwd_cuda.lse_forwards == n + 1
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, without):
        assert torch.equal(g, a) and torch.equal(g, w)


def _no_key_rows(sq, skv, causal, window, offset):
    """The q rows that see no key: the kernels return 0 there (the plain
    version the mean of V)."""
    qp = torch.arange(sq, device="cuda") + offset
    hi = qp.clamp(max=skv - 1) if causal else torch.full_like(qp, skv - 1)
    lo = (qp - window + 1).clamp(min=0) if window is not None else torch.zeros_like(qp)
    return lo > hi


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window,offset", [
    (2, 15, 5, 512, 512, 64, True, None, 0),     # smollm's prefill
    (1, 16, 2, 130, 130, 128, True, 40, 0),      # G 8, D 128, window
    (1, 2, 2, 70, 130, 80, False, None, 60),     # D 80, offset, not causal
    (2, 6, 2, 80, 100, 16, True, 8, 60),         # rows with no key: L = +inf
    (1, 4, 4, 200, 200, 192, True, None, 0),     # MLA: D 192, G 1
    # MLA's plan takes two 64-row q tiles a block: the second of the last
    # block has no rows at Sq 64 and 192; Sq 1; a window whose lower edge
    # falls between the two tiles' kv ranges; an offset off the 64-key tiles;
    # rows with no key (O = 0, L = +inf)
    (2, 3, 3, 64, 64, 192, True, None, 0),
    (1, 2, 2, 192, 192, 192, True, None, 0),
    (2, 2, 2, 1, 1, 192, True, None, 0),
    (1, 2, 2, 300, 300, 192, True, 100, 0),
    (1, 2, 2, 100, 237, 192, True, None, 137),
    (2, 2, 2, 150, 140, 192, True, 30, 120),
])
def test_flash_attention_forward_writes_lse(gen, b, hq, hkv, sq, skv, d, causal,
                                            window, offset):
    """The bf16 forward with the L output gives the same bits of O as
    without it, an O that matches the plain version's (0 where a row sees
    no key), and an L that matches the plain version's (float32 on both
    sides from the same bf16 inputs: ex2/lg2 approximations and summation
    order, 1e-4), +inf where a row sees no key."""
    dtype = torch.bfloat16
    q = _randn(gen, (b, hq, sq, d), dtype)
    k, v = _randn(gen, (b, hkv, skv, d), dtype), _randn(gen, (b, hkv, skv, d), dtype)
    o = flash_attention_cuda(q, k, v, causal, window, offset)
    o2, lse = flash_attention_cuda(q, k, v, causal, window, offset, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(o, o2)
    want_o, want = flash_attention_plain(q, k, v, causal, window, offset, return_lse=True)
    want_o[:, :, _no_key_rows(sq, skv, causal, window, offset)] = 0
    _close(o, want_o, dtype)
    assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
    assert torch.equal(torch.isinf(lse), torch.isinf(want))
    torch.testing.assert_close(lse, want, atol=1e-4, rtol=1e-4)


def test_flash_attention_autograd_passes_the_forwards_lse(gen):
    """Through ``ops.flash_attention`` with grad (under remat too), the bf16
    backward reads the L its forward wrote: no forward runs again for it."""
    q, k, v, do = _bwd_case(gen, 2, 6, 2, 100, 100, 64, torch.bfloat16)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    n, f = flash_attention_bwd_cuda.lse_forwards, flash_attention_cuda.launches
    o = torch.utils.checkpoint.checkpoint(
        lambda *a: ops.flash_attention(*a, causal=True), *leaves, use_reentrant=False)
    o.backward(do)
    assert flash_attention_bwd_cuda.lse_forwards == n
    assert flash_attention_cuda.launches == f + 2      # the forward, and again under remat
    want = flash_attention_bwd_plain(q, k, v, o.detach(), do, True)
    for leaf, w in zip(leaves, want):
        _close_tol(leaf.grad, w, BWD_TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_takes_strided_and_broadcast_grads(gen, dtype):
    """q/k/v as the model passes them ((B, H, S, D) views of (B, S, H, D));
    dO transposed the same way is read through its strides with no copy,
    and dO of a ``sum()`` (every stride 0) takes one counted copy. dq, dk,
    dv come back in q's (B, S, H, D) order (``empty_like``; k and v, slices
    of one packed tensor, get dense strides of that order)."""
    q = _randn(gen, (2, 100, 6, 64), dtype).transpose(1, 2)
    kv = _randn(gen, (2, 100, 2, 2, 64), dtype)
    k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    o = flash_attention_cuda(q, k, v, True, None, 0)
    do = _randn(gen, (2, 100, 6, 64), dtype).transpose(1, 2)
    copies = flash_attention_bwd_cuda.copies
    got = flash_attention_bwd_cuda(q, k, v, o, do, True, None, 0)
    assert flash_attention_bwd_cuda.copies == copies
    assert got[0].stride() == q.stride()
    for g in got:
        assert g.transpose(1, 2).is_contiguous()
    for g, w in zip(got, flash_attention_bwd_plain(q, k, v, o, do, True,
                                                   None, 0)):
        _close_tol(g, w, BWD_TOL[dtype])
    ones = torch.ones((), dtype=dtype, device="cuda").expand(o.shape)
    got = flash_attention_bwd_cuda(q, k, v, o, ones, True, None, 0)
    assert flash_attention_bwd_cuda.copies == copies + 1
    for g, w in zip(got, flash_attention_bwd_plain(q, k, v, o, ones, True,
                                                   None, 0)):
        _close_tol(g, w, BWD_TOL[dtype])


# every path and instance: a warp per row (16 ... 2048 in bf16), a block per
# row (8192), the scalar path (20, 60, 1001: no multiple of the vector
# width); rows fewer than a block's 8 warps (1, 3, 5), and row counts that
# are no multiple of the 8 rows of a pass or of the grid (777, 1000, 4097)
@pytest.mark.parametrize("rows,d", [(4096, 960), (8, 960), (4096, 768),
                                    (4096, 1536), (5, 8192), (1, 20),
                                    (1000, 60), (777, 1001), (3, 960),
                                    (4097, 960), (4097, 768), (9, 2048),
                                    (5, 16), (3, 1000), (4097, 8192)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd(gen, rows, d, dtype):
    x = _randn(gen, (rows, d), dtype)
    s = _randn(gen, (d,), torch.float32)
    dy = _randn(gen, (rows, d), dtype)
    _check_rmsnorm_bwd(x, s, dy, dtype)


@pytest.mark.parametrize("d", [16, 20, 960, 1000, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_unaligned_view_takes_the_scalar_path(gen, d, dtype):
    """x, dy and scale as views one element into their buffers: no 16-byte
    alignment, so the scalar path runs, with the same results."""
    rows = 7

    def view(shape, dt):
        n = int(np.prod(shape))
        return _randn(gen, (n + 1,), dt)[1:].view(shape)

    x, dy, s = view((rows, d), dtype), view((rows, d), dtype), view((d,), torch.float32)
    assert x.data_ptr() % 16 and dy.data_ptr() % 16 and s.data_ptr() % 16
    _check_rmsnorm_bwd(x, s, dy, dtype)


def _check_rmsnorm_bwd(x, s, dy, dtype):
    d = x.shape[-1]
    dx, ds = rmsnorm_bwd_cuda(x, s, dy, 1e-5)
    want_dx, want_ds = rmsnorm_bwd_plain(x, s, dy, 1e-5)
    _close_tol(dx, want_dx, BWD_TOL[dtype])
    # dscale sums dy * x * r over every row, in float32 on both sides from
    # the same inputs: relative to its norm, the summation order only
    torch.cuda.synchronize()
    assert ds.dtype == torch.float32 and ds.shape == (d,)
    err = float((ds - want_ds).norm() / want_ds.norm())
    assert err <= 1e-4, err
    again = rmsnorm_bwd_cuda(x, s, dy, 1e-5)
    assert torch.equal(again[0], dx) and torch.equal(again[1], ds)


# AdamW: float32 to 2e-5; a bf16 param within one bf16 ulp; m and v 1e-6
# relative (the kernel rounds each step as the plain version does, so on the
# same scalars they agree to the bit or near it)
ADAMW_TOL = {torch.float32: 2e-5, torch.bfloat16: 2 ** -7}


def _adamw_leaf(gen, shape, dtype):
    p = _randn(gen, shape, dtype)
    g = _randn(gen, shape, dtype) * 0.1
    m = _randn(gen, shape, torch.float32) * 0.01
    v = _randn(gen, shape, torch.float32).abs() * 1e-3
    return p, g, m, v


def _adamw_scalars(step=3, lr=1e-3, scale=0.37):
    f = lambda x: torch.tensor(x, dtype=torch.float32, device="cuda")
    return f(lr), f(1 - 0.9 ** step), f(1 - 0.95 ** step), f(scale)


def _close_adamw(got, want, dtype):
    torch.cuda.synchronize()
    (p, m, v), (pw, mw, vw) = got, want
    assert p.dtype == pw.dtype and m.dtype == mw.dtype == torch.float32
    tol = ADAMW_TOL[dtype]
    torch.testing.assert_close(p.float(), pw.float(), atol=tol * (1 + float(pw.abs().max())),
                               rtol=tol)
    for a, b in ((m, mw), (v, vw)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("shape", [(960,), (32, 960), (1,), (7,), (13, 37),
                                   (3, 1000, 9), (49152, 960)])
@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_update(gen, shape, clip, dtype):
    """The fused update against its plain version on one leaf: 1-d leaves
    (weight decay off) and n-d leaves (on), numels that are no multiple of
    the vector width (1, 7, 13 x 37, 3 x 1000 x 9), smollm's embedding;
    with the clip's round trip (scale 0.37) and without (None). Two calls
    from the same state give the same bits."""
    p, g, m, v = _adamw_leaf(gen, shape, dtype)
    lr, c1, c2, scale = _adamw_scalars()
    scale = scale if clip else None
    want = [t.clone() for t in (p, m, v)]
    adamw_update_plain(want[0], g, want[1], want[2], lr, c1, c2, scale)
    got = [t.clone() for t in (p, m, v)]
    n = adamw_update_cuda.launches
    adamw_update_cuda(got[0], g, got[1], got[2], lr, c1, c2, scale)
    assert adamw_update_cuda.launches == n + 1
    _close_adamw(got, want, dtype)
    again = [t.clone() for t in (p, m, v)]
    adamw_update_cuda(again[0], g, again[1], again[2], lr, c1, c2, scale)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def test_adamw_kernels_refuse_what_they_do_not_take(gen):
    """A non-contiguous gradient, mismatched dtypes or shapes, host or
    wrongly typed scalars raise; nothing is launched."""
    p, g, m, v = _adamw_leaf(gen, (64, 48), torch.bfloat16)
    lr, c1, c2, scale = _adamw_scalars()
    n = adamw_update_cuda.launches, sumsq_cuda.launches
    for bad in (dict(g=g.t().contiguous().t()), dict(g=g.float()),
                dict(m=m.to(torch.bfloat16)), dict(v=v[:32]), dict(lr=lr.cpu()),
                dict(c1=c1.double())):
        args = dict(p=p, g=g, m=m, v=v, lr=lr, c1=c1, c2=c2, scale=scale)
        args.update(bad)
        with pytest.raises((ValueError, TypeError)):
            adamw_update_cuda(**args)
    with pytest.raises(ValueError, match="contiguous"):
        global_norm_scale_cuda([g.t()], 1.0)
    assert (adamw_update_cuda.launches, sumsq_cuda.launches) == n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sumsq_and_clip_finalize(gen, dtype):
    """sumsq's partial sums over each leaf equal the leaf's sum of squares
    (float32, summation order only); clip_finalize's norm and scale equal
    the plain version's from the same partials; global_norm_scale over
    smollm-like leaves (a single element, a ragged tail, the embedding)
    equals the plain version's, twice the same bits; a clip that bites
    (max_norm below the norm) and one that does not (scale 1)."""
    shapes = [(1,), (960,), (13, 37), (32, 960, 320), (49152, 960)]
    leaves = [_randn(gen, s, dtype) for s in shapes]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for g in leaves:
        partial = torch.empty(sumsq_blocks(g.numel(), g.dtype, n_sm), device="cuda")
        sumsq_cuda(g, partial)
        torch.testing.assert_close(partial.sum(), sumsq_plain(g), rtol=1e-5, atol=0)
        for max_norm in (0.5, 1e9):
            got = clip_finalize_cuda(partial, max_norm)
            for a, b in zip(got, clip_finalize_plain(partial, max_norm)):
                torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    for max_norm in (1.0, 1e9):
        n_s, n_f = sumsq_cuda.launches, clip_finalize_cuda.launches
        norm, scale = global_norm_scale_cuda(leaves, max_norm)
        assert (sumsq_cuda.launches, clip_finalize_cuda.launches) == (n_s + 5, n_f + 1)
        want = global_norm_scale_plain(leaves, max_norm)
        torch.testing.assert_close(norm, want[0], rtol=1e-5, atol=0)
        torch.testing.assert_close(scale, want[1], rtol=1e-5, atol=0)
        assert (float(scale) < 1) == (max_norm == 1.0)
        again = global_norm_scale_cuda(leaves, max_norm)
        assert torch.equal(again[0], norm) and torch.equal(again[1], scale)


def test_adamw_update_replays_in_a_graph(gen):
    """The clip and the update of a bf16 and a float32 leaf captured in one
    CUDA graph and replayed 3 times equal 3 eager steps bit for bit: lr,
    the bias corrections and the scale change every step and are read on
    the device, not frozen at capture."""
    params = {"w": _randn(gen, (96, 33), torch.bfloat16),
              "n": _randn(gen, (33,), torch.float32)}
    opt = adamw(warmup_cosine(1e-2, warmup=2, total=6))
    grads = [{k: _randn(gen, t.shape, t.dtype) for k, t in params.items()}
             for _ in range(3)]
    g_buf = {k: torch.empty_like(t) for k, t in params.items()}

    def step(p, state, g):
        norm, scale = global_norm_scale(tree_leaves(g), 0.5)
        opt.update(g, state, p, grad_scale=scale)
        return norm

    p_e = tree_map(lambda a: a.clone(), params)
    s_e = opt.init(p_e)
    norms_e = []
    for g in grads:
        norms_e.append(step(p_e, s_e, g).clone())
    p_g = tree_map(lambda a: a.clone(), params)
    s_g = opt.init(p_g)
    tree_map(lambda b, g: b.copy_(g), g_buf, grads[0])
    graph = StepGraph(step, p_g, s_g, g_buf, mutated=[p_g, s_g])
    for i, g in enumerate(grads):
        tree_map(lambda b, x: b.copy_(x), g_buf, g)
        assert torch.equal(graph.replay(), norms_e[i])
    assert graph.per_replay["adamw_update_cuda.launches"] == 2
    assert graph.per_replay["sumsq_cuda.launches"] == 2
    assert graph.per_replay["clip_finalize_cuda.launches"] == 1
    for a, b in zip(tree_leaves((p_e, s_e)), tree_leaves((p_g, s_g))):
        assert torch.equal(a, b)
    graph.release()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_gradients_go_through_the_backward_kernels(gen, dtype):
    """With inputs that require grad, ``ops`` routes through the autograd
    Functions: the gradients equal the backward kernels' and the plain
    versions', and each backward wrapper counts one launch per backward.
    Without grad (or under no_grad) the forward kernel runs alone."""
    q, k, v, do = _bwd_case(gen, 2, 6, 2, 50, 50, 64, dtype)
    x = _randn(gen, (2, 50, 64), dtype)
    s = _randn(gen, (64,), torch.float32)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, x, s)]
    n_f, n_b = flash_attention_bwd_cuda.launches, rmsnorm_bwd_cuda.launches
    o = ops.flash_attention(*leaves[:3], causal=True)
    y = ops.rmsnorm(leaves[3], leaves[4], 1e-5)
    assert o.grad_fn is not None and y.grad_fn is not None
    dy = _randn(gen, y.shape, dtype)
    torch.autograd.backward((o, y), (do, dy))
    assert flash_attention_bwd_cuda.launches == n_f + 1
    assert rmsnorm_bwd_cuda.launches == n_b + 1
    o_plain = flash_attention_plain(q, k, v, True)
    for g, w in zip((t.grad for t in leaves[:3]),
                    flash_attention_bwd_plain(q, k, v, o_plain, do, True)):
        _close_tol(g, w, BWD_TOL[dtype])
    dx, ds = rmsnorm_bwd_plain(x, s, dy, 1e-5)
    _close_tol(leaves[3].grad, dx, BWD_TOL[dtype])
    torch.testing.assert_close(leaves[4].grad, ds, atol=1e-2, rtol=1e-2)
    with torch.no_grad():
        assert ops.flash_attention(*leaves[:3]).grad_fn is None
        assert ops.rmsnorm(leaves[3], leaves[4], 1e-5).grad_fn is None


def test_kernels_without_backward_raise_for_a_gradient(gen):
    """decode attention has no backward kernel: asked for a gradient on the
    card it raises instead of returning an output cut off from the graph;
    under no_grad it runs. The scan has one: asked for a gradient it runs
    the training forward and the backward kernel, and its gradients equal
    autograd's of the plain scan; under no_grad it runs the serving kernel."""
    q, k, v = _decode_inputs(gen, 2, 6, 2, 40, 64, torch.float32)
    length = _lengths(40, 17)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.decode_attention(q.requires_grad_(True), k, v, length)
    with torch.no_grad():
        ops.decode_attention(q, k, v, length)
    u, dt, A, B, C, D, h0 = _scan_inputs(gen, 1, 8, 32, 4, torch.float32, True)
    dy = _randn(gen, u.shape, torch.float32)
    n = (mamba_scan_train_cuda.launches, mamba_scan_bwd_cuda.launches,
         mamba_scan_cuda.launches)
    leaves = [x.clone().requires_grad_(True) for x in (u, dt, A, B, C, D, h0)]
    y, _ = ops.mamba_scan(*leaves)
    got = torch.autograd.grad(y, leaves, dy)
    assert (mamba_scan_train_cuda.launches, mamba_scan_bwd_cuda.launches,
            mamba_scan_cuda.launches) == (n[0] + 1, n[1] + 1, n[2])
    plain = [x.clone().requires_grad_(True) for x in (u, dt, A, B, C, D, h0)]
    y_p, _ = mamba_scan_plain(*plain)
    for g, w in zip(got, torch.autograd.grad(y_p, plain, dy)):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
    with torch.no_grad():
        assert ops.mamba_scan(*leaves)[0].grad_fn is None
    assert mamba_scan_cuda.launches == n[2] + 1


def _loss_and_grads(cfg, params, batch, device):
    p = tree_map(lambda a: a.detach().to(device).requires_grad_(True), params)
    loss, _ = model_api(cfg).loss(
        p, {k: v.to(device) for k, v in batch.items()}, cfg)
    loss.backward()
    return float(loss.detach()), tree_map(lambda a: a.grad, p)


def _leaf_pairs(a, b, path=""):
    if isinstance(a, dict):
        for k in sorted(a):
            yield from _leaf_pairs(a[k], b[k], f"{path}/{k}")
    else:
        yield path, a, b


@pytest.mark.parametrize("name", ["smollm_360m", "h2o_danube_1_8b",
                                  "granite_3_2b", "stablelm_3b"])
def test_every_param_leaf_gets_the_cpu_gradient(gen, name):
    """The detachment guard: the SMOKE models' loss on the card, through the
    forward and backward kernels under remat, gives every param leaf a
    gradient equal to the CPU's (plain versions, autograd): |diff| <=
    1e-4 max|g| + 1e-6 per leaf, float32."""
    cfg = get(name, smoke=True)
    params = transformer.init(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 33), generator=torch.Generator()
                         .manual_seed(1))
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    n_f, n_b = flash_attention_bwd_cuda.launches, rmsnorm_bwd_cuda.launches
    loss_c, g_c = _loss_and_grads(cfg, params, batch, "cpu")
    loss_g, g_g = _loss_and_grads(cfg, params, batch, "cuda")
    n_attn = sum(m == "attn" for m, _ in cfg.blocks())
    assert flash_attention_bwd_cuda.launches - n_f == n_attn
    assert rmsnorm_bwd_cuda.launches - n_b == 1 + 2 * len(cfg.blocks())
    assert abs(loss_c - loss_g) <= 1e-4
    for path, gc, gg in _leaf_pairs(g_c, g_g):
        assert gg is not None and gg.is_cuda, path
        tol = 1e-4 * float(gc.abs().max()) + 1e-6
        torch.testing.assert_close(gg.cpu(), gc, atol=tol, rtol=0, msg=path)


def test_jamba_loss_refuses_a_gradient_through_the_scan(gen):
    """The scan now has a backward kernel: the same Jamba SMOKE loss (dense
    FFN) takes its gradient through it on the card, and every param leaf's
    gradient equals the CPU's (plain versions, autograd), |diff| <= 1e-4
    max|g| + 1e-6, float32; under remat each Mamba layer runs the training
    forward twice and the backward once."""
    cfg = dataclasses.replace(get("jamba_1_5_large_398b", smoke=True),
                              n_experts=0, top_k=0, d_expert=0,
                              period=(("attn", "mlp"),) + (("mamba", "mlp"),) * 7)
    params = transformer.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 41), generator=torch.Generator()
                         .manual_seed(1))
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    n_f, n_b = mamba_scan_train_cuda.launches, mamba_scan_bwd_cuda.launches
    loss_c, g_c = _loss_and_grads(cfg, params, batch, "cpu")
    loss_g, g_g = _loss_and_grads(cfg, params, batch, "cuda")
    assert (mamba_scan_train_cuda.launches - n_f, mamba_scan_bwd_cuda.launches - n_b) \
        == (14, 7)
    assert abs(loss_c - loss_g) <= 1e-4
    for path, gc, gg in _leaf_pairs(g_c, g_g):
        assert gg is not None and gg.is_cuda, path
        tol = 1e-4 * float(gc.abs().max()) + 1e-6
        torch.testing.assert_close(gg.cpu(), gc, atol=tol, rtol=0, msg=path)


# ---------------------------------------------------------------------------
# MLA's head dims (qk 16 + 8 = 24 at SMOKE size, 128 + 64 = 192 at
# DeepSeek-V3's): V padded to the qk width, G = 1, scale 192^-0.5
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,sq,skv,causal,window", [
    (2, 8, 512, 512, True, None),        # DeepSeek-V3 prefill, fewer heads
    (1, 4, 77, 77, True, None),          # ragged tail
    (1, 3, 96, 200, True, 64),           # window, offset 104
    (2, 2, 64, 130, False, None),        # full, ragged keys
    # the bf16 plan's two 64-row q tiles a block: no rows in the last
    # block's second at Sq 64 and 192
    (2, 3, 64, 64, True, None),
    (1, 3, 192, 192, True, None),
    (2, 4, 1, 1, True, None),            # Sq 1
    (1, 2, 1, 300, True, None),          # Sq 1 after 299 keys
    (1, 2, 300, 300, True, 100),         # a window edge between the two tiles
    (1, 2, 100, 237, True, None),        # offset 137, off the 64-key tiles
    (1, 2, 130, 203, False, 50),         # full with a window, offset 73
])
@pytest.mark.parametrize("d,dtype", [(192, torch.bfloat16), (192, torch.float32),
                                     (24, torch.float32)])
def test_flash_attention_mla_head_dims(gen, b, h, sq, skv, causal, window, d,
                                       dtype):
    """Against the plain version; bf16 gives O's bits with and without L."""
    q = _randn(gen, (b, h, sq, d), dtype)
    k, v = _randn(gen, (b, h, skv, d), dtype), _randn(gen, (b, h, skv, d), dtype)
    args = (q, k, v, causal, window, skv - sq, 192 ** -0.5)
    got = flash_attention_cuda(*args)
    _close(got, flash_attention_plain(*args), dtype)
    if dtype == torch.bfloat16:
        assert torch.equal(got, flash_attention_cuda(*args, return_lse=True)[0])


def test_flash_attention_mla_takes_the_models_views(gen):
    """mla_apply's layout: q, k from (B, S, H, 192) tensors and V padded
    from 128, all as (B, H, S, D) views; the padding columns of O are 0."""
    b, s, h = 2, 96, 4
    q = _randn(gen, (b, s, h, 192), torch.bfloat16)
    k = _randn(gen, (b, s, h, 192), torch.bfloat16)
    v = torch.nn.functional.pad(_randn(gen, (b, s, h, 128), torch.bfloat16),
                                (0, 64))
    views = [t.transpose(1, 2) for t in (q, k, v)]
    got = flash_attention_cuda(*views, True, None, 0, 192 ** -0.5)
    _close(got, flash_attention_plain(*views, True, None, 0, 192 ** -0.5),
           torch.bfloat16)
    assert not got[..., 128:].any()


MLA_BWD_CASES = [
    # b, h, sq, skv, causal, window, offset
    (2, 8, 512, 512, True, None, 0),     # DeepSeek-V3 training, fewer heads
    (1, 4, 77, 77, True, None, 0),       # ragged tail
    (1, 3, 96, 200, True, 64, 104),      # window, offset
    (2, 2, 64, 130, False, None, 66),    # full, ragged keys
    (2, 4, 1, 1, True, None, 0),         # Sq 1
    (1, 2, 130, 203, False, 50, 73),     # full with a window
    (1, 2, 64, 40, True, 30, 100),       # rows that see no key
    (1, 3, 200, 200, True, 70, 0),       # a window inside the kv tiles
]


@pytest.mark.parametrize("b,h,sq,skv,causal,window,offset", MLA_BWD_CASES)
@pytest.mark.parametrize("d,dtype", [(192, torch.bfloat16), (192, torch.float32),
                                     (24, torch.float32)])
def test_flash_attention_bwd_mla_head_dims(gen, b, h, sq, skv, causal, window, offset,
                                           d, dtype):
    """The backward at MLA's head dims against the plain version (G = 1,
    scale 192^-0.5): bf16 on the tensor cores with the forward's L, the
    same bits call after call; float32 on the CUDA cores."""
    q, k, v, do = _bwd_case(gen, b, h, h, sq, skv, d, dtype)
    args = (q, k, v, causal, window, offset, 192 ** -0.5)
    lse = None
    if dtype == torch.bfloat16:
        o, lse = flash_attention_cuda(*args, return_lse=True)
    else:
        o = flash_attention_cuda(*args)
    n = flash_attention_bwd_cuda.launches
    got = flash_attention_bwd_cuda(q, k, v, o, do, *args[3:], lse=lse)
    assert flash_attention_bwd_cuda.launches == n + 1
    want = flash_attention_bwd_plain(q, k, v, o, do, *args[3:])
    for g, w in zip(got, want):
        _close_tol(g, w, BWD_TOL[dtype])
    if dtype == torch.bfloat16:
        again = flash_attention_bwd_cuda(q, k, v, o, do, *args[3:], lse=lse)
        torch.cuda.synchronize()
        assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_takes_the_mla_layout(gen, dtype):
    """``mla_apply``'s layout under autograd: q and k (B, H, S, D) views of
    (B, S, H, 192) tensors, V padded from 128, through ``ops.flash_attention``
    (the backward kernel, one launch); the gradients of q, k and V's 128
    columns equal the plain version's through the same views and pad."""
    b, s, h = 2, 130, 4
    qs, ks = (_randn(gen, (b, s, h, 192), dtype) for _ in range(2))
    vs = _randn(gen, (b, s, h, 128), dtype)
    do = _randn(gen, (b, h, s, 192), dtype)

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (qs, ks, vs)]
        q, k = (t.transpose(1, 2) for t in leaves[:2])
        v = torch.nn.functional.pad(leaves[2], (0, 64)).transpose(1, 2)
        fn(q, k, v).backward(do)
        return [t.grad for t in leaves]

    n = flash_attention_bwd_cuda.launches
    got = grads(lambda q, k, v: ops.flash_attention(q, k, v, True, None, 0, 192 ** -0.5))
    assert flash_attention_bwd_cuda.launches == n + 1
    want = grads(lambda q, k, v: flash_attention_plain(q.float(), k.float(), v.float(),
                                                       True, None, 0, 192 ** -0.5))
    for g, w in zip(got, want):
        _close_tol(g, w.to(dtype), BWD_TOL[dtype])


@pytest.mark.parametrize("name", ["deepseek_v3_671b", "qwen3_moe_235b_a22b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_decode_step_is_the_same_every_call(gen, name, dtype):
    """The MoE decode step (top-k, sorted dispatch, expert products, the
    gather combine) from the same cache and tokens: the same logits, tokens
    and cache, bit for bit, on every call (a float scatter-add would add in
    the order its atomics land)."""
    cfg = dataclasses.replace(get(name, smoke=True), dtype=dtype)
    params = transformer.init(torch.Generator(device="cuda").manual_seed(0),
                              cfg, device="cuda")
    api = model_api(cfg)
    step = make_decode_step(cfg, graphs=False)
    cache = api.init_cache(cfg, 8, 16, device="cuda")
    toks = torch.randint(0, cfg.vocab, (8, 12), device="cuda", generator=gen)
    for t in range(12):
        snap = tree_map(lambda a: a.clone(), cache)
        outs = []
        for _ in range(3):
            tree_map(lambda a, b: a.copy_(b), cache, snap)
            nxt, logits, _ = step(params, cache, toks[:, t], t)
            outs.append((nxt.clone(), logits.clone(),
                         [a.clone() for a in tree_leaves(cache)]))
        for nxt, logits, leaves in outs[1:]:
            assert torch.equal(nxt, outs[0][0]) and torch.equal(logits, outs[0][1])
            assert all(torch.equal(a, b) for a, b in zip(leaves, outs[0][2]))


@pytest.mark.parametrize("arch", ["deepseek_v3_671b", "qwen3_moe_235b_a22b",
                                  "jamba_1_5_large_398b"])
def test_serve_main_serves_the_moe_smoke_configs(gen, arch, capsys):
    """``serve.main`` for the MoE SMOKE configs (Jamba with its real MoE
    layers), graphed and eager: the same tokens."""
    graphed = serve.main(["--arch", arch])
    eager = serve.main(["--arch", arch, "--eager"])
    assert "on cuda (graphed)" in capsys.readouterr().out
    for a, b in zip(graphed, eager):
        np.testing.assert_array_equal(a.out, b.out)


def test_serve_main_runs_with_its_defaults(gen, capsys):
    """``python -m repro_torch.launch.serve`` with no arguments: smollm SMOKE
    (head dim 20) on the card."""
    serve.main([])
    assert "[serve] smollm-smoke on cuda" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# CUDA graphs of the steps against the eager steps: the same kernels on the
# same inputs in the same order, so the same bits (cuBLAS picks its
# algorithm from the problem and the workspace size, which capture keeps)
# ---------------------------------------------------------------------------

GRAPH_ARCHS = ["smollm_360m", "h2o_danube_1_8b", "jamba_1_5_large_398b",
               "xlstm_125m", "deepseek_v3_671b", "qwen3_moe_235b_a22b"]


def _smoke(name):
    cfg = get(name, smoke=True)
    if name == "jamba_1_5_large_398b":     # dense FFN in place of MoE
        cfg = dataclasses.replace(cfg, n_experts=0, top_k=0, d_expert=0,
                                  period=tuple((m, "mlp") for m, _ in cfg.period))
    return cfg


def _only_graph(step):
    assert isinstance(step, GraphedStep)
    (g,) = step.graphs.values()
    return g


def _per_step(cfg):
    """RMSNorm and attention launches of one forward or decode step: MLA
    adds its q and kv norms, and one flash launch in a forward but no
    decode-attention launch in a decode step."""
    blocks = cfg.blocks()
    return {"rmsnorm_cuda.launches": 1 + sum(
                1 + (ffn is not None) + (m == "mlstm") + 2 * (m == "mla")
                for m, ffn in blocks),
            "attn": sum(m == "attn" for m, _ in blocks),
            "flash": sum(m in ("attn", "mla") for m, _ in blocks)}


@pytest.mark.parametrize("name", GRAPH_ARCHS)
def test_graphed_decode_matches_eager_bit_for_bit(gen, name):
    """24 teacher-forced decode steps of each SMOKE family, eager and from
    one CUDA graph (past h2o-danube's window of 16, where slot and length
    wrap): the same logits and tokens at every step and the same cache
    after, bit for bit; one capture, and the launches a replay adds are
    one step's."""
    cfg = _smoke(name)
    params = transformer.init(torch.Generator(device="cuda").manual_seed(0),
                              cfg, device="cuda")
    api = model_api(cfg)
    eager, graphed = make_decode_step(cfg, graphs=False), make_decode_step(cfg)
    assert not isinstance(eager, GraphedStep)
    c_e = api.init_cache(cfg, 2, 32, device="cuda")
    c_g = api.init_cache(cfg, 2, 32, device="cuda")
    toks = torch.randint(0, cfg.vocab, (2, 24), device="cuda", generator=gen)
    for t in range(24):
        n_e, l_e, _ = eager(params, c_e, toks[:, t], t)
        n_g, l_g, out = graphed(params, c_g, toks[:, t], t)
        assert out is c_g
        assert torch.equal(l_g, l_e) and torch.equal(n_g, n_e), f"step {t}"
    for a, b in zip(tree_leaves(c_e), tree_leaves(c_g)):
        assert torch.equal(a, b)
    g = _only_graph(graphed)
    per = _per_step(cfg)
    assert g.per_replay["rmsnorm_cuda.launches"] == per["rmsnorm_cuda.launches"]
    assert g.per_replay["decode_attention_cuda.launches"] == per["attn"]
    assert g.per_replay["flash_attention_cuda.launches"] == 0
    graphed.release()
    assert not graphed.graphs


@pytest.mark.parametrize("name", GRAPH_ARCHS)
def test_graphed_prefill_matches_eager_bit_for_bit(gen, name):
    """Two shapes (two captures), each called twice with other tokens (the
    second a replay on refilled buffers): the same logits as eager."""
    cfg = _smoke(name)
    params = transformer.init(torch.Generator(device="cuda").manual_seed(0),
                              cfg, device="cuda")
    eager, graphed = make_prefill_step(cfg, graphs=False), make_prefill_step(cfg)
    for shape in ((2, 32), (1, 16), (2, 32), (1, 16)):
        toks = torch.randint(0, cfg.vocab, shape, device="cuda", generator=gen)
        want = eager(params, {"inputs": toks})
        got = graphed(params, {"inputs": toks.cpu().numpy()})
        assert torch.equal(got, want), shape
    assert len(graphed.graphs) == 2
    for g in graphed.graphs.values():
        assert g.per_replay["flash_attention_cuda.launches"] == _per_step(cfg)["flash"]
    graphed.release()


@pytest.mark.parametrize("name", ["smollm_360m", "h2o_danube_1_8b",
                                  "jamba_1_5_large_398b", "xlstm_125m"])
def test_graphed_train_steps_match_eager_bit_for_bit(gen, name):
    """Three train steps (forward, backward under remat, clip, AdamW with
    warmup + cosine on the device-side step) eager and from one CUDA graph,
    from the same params and batches: the same losses, grad norms, params
    and optimizer state, bit for bit; params and state are written in
    place, and a replay adds one step's forward and backward launches."""
    cfg = _smoke(name)
    p_e = transformer.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                           device="cuda")
    p_g = tree_map(lambda a: a.clone(), p_e)
    opt = adamw(warmup_cosine(1e-3, warmup=1, total=3))
    s_e, s_g = opt.init(p_e), opt.init(p_g)
    leaves = tree_leaves((p_g, s_g))
    eager = make_train_step(cfg, opt, graphs=False)
    graphed = make_train_step(cfg, opt)
    rng = torch.Generator().manual_seed(1)
    for _ in range(3):
        toks = torch.randint(0, cfg.vocab, (2, 33), generator=rng).numpy()
        batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
        _, _, m_e = eager(p_e, s_e, batch)
        p, s, m_g = graphed(p_g, s_g, batch)
        assert all(a is b for a, b in zip(tree_leaves((p, s)), leaves))
        assert torch.equal(m_g["loss"], m_e["loss"])
        assert torch.equal(m_g["grad_norm"], m_e["grad_norm"])
    assert int(s_g["step"]) == 3
    for a, b in zip(tree_leaves((p_e, s_e)), tree_leaves((p_g, s_g))):
        assert torch.equal(a, b)
    g = _only_graph(graphed)
    n_attn = _per_step(cfg)["attn"]
    n_mamba = sum(m == "mamba" for m, _ in cfg.blocks())
    assert g.per_replay["flash_attention_bwd_cuda.launches"] == n_attn
    assert g.per_replay["flash_attention_cuda.launches"] == 2 * n_attn   # remat
    assert g.per_replay["rmsnorm_bwd_cuda.launches"] == _per_step(cfg)["rmsnorm_cuda.launches"]
    assert g.per_replay["mamba_scan_train_cuda.launches"] == 2 * n_mamba
    assert g.per_replay["mamba_scan_bwd_cuda.launches"] == n_mamba
    graphed.release()


def test_graphed_train_resumes_into_its_tensors(gen, tmp_path):
    """``train()`` on the card from its graph: 6 steps with a checkpoint
    every 2 equal 6 eager steps bit for bit. With the last checkpoint
    removed, a resume at step 4 copies the checkpoint into the tensors its
    new graph binds, and its two steps equal those of an eager resume from
    the same checkpoint (the saved data state depends on how far the
    prefetcher had read, so both resumes start from the one checkpoint)."""
    kw = dict(steps=6, batch=2, seq=16, device="cuda")
    full = train("smollm_360m", ckpt_dir=str(tmp_path / "a"), ckpt_every=2, **kw)
    eager = train("smollm_360m", graphs=False, **kw)
    assert full["losses"] == eager["losses"]
    shutil.rmtree(tmp_path / "a" / "step_00000006")
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    again = train("smollm_360m", ckpt_dir=str(tmp_path / "a"), ckpt_every=2, **kw)
    again_eager = train("smollm_360m", ckpt_dir=str(tmp_path / "b"), ckpt_every=2,
                        graphs=False, **kw)
    assert again["start_step"] == 4 and int(again["opt_state"]["step"]) == 6
    assert eager["capture"] is None
    assert again["capture"]["per_replay"]["flash_attention_bwd_cuda.launches"] > 0
    assert len(again["losses"]) == 2 and again["losses"] == again_eager["losses"]
    for a, b in zip(tree_leaves((again["params"], again["opt_state"])),
                    tree_leaves((again_eager["params"], again_eager["opt_state"]))):
        assert torch.equal(a, b)


def test_capture_keeps_the_saved_state_on_the_host(gen):
    """The state a step writes in place is saved for the restore after the
    warm-up on the host, not on the card: capturing a step that writes 256
    MiB in place raises the device's peak by far less than that, and the
    warm-up's and the capture's writes are undone."""
    state = torch.zeros(64 << 20, device="cuda")
    x = torch.ones(1, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    g = StepGraph(lambda s, x: s.add_(x), state, x, mutated=[state])
    assert torch.cuda.max_memory_allocated() - base < state.nbytes // 4
    assert int(torch.count_nonzero(state)) == 0
    g.replay()
    assert bool((state == 1).all())
    g.release()


def test_serve_batch_refuses_positions_past_the_cache(gen):
    """Positions past a KV cache without a window raise ValueError on the
    host before any step, and the card serves on: graphed tokens equal
    eager ones at a length that fits."""
    cfg = _smoke("smollm_360m")
    params = transformer.init(torch.Generator(device="cuda").manual_seed(0),
                              cfg, device="cuda")
    prompts = torch.randint(0, cfg.vocab, (2, 8), generator=gen,
                            device="cuda").int().cpu().numpy()

    def reqs():
        return [serve.Request(i, p, 12) for i, p in enumerate(prompts)]

    with pytest.raises(ValueError, match="20 KV cache slots"):
        serve.serve_batch(cfg, params, reqs(), max_len=16)
    graphed, _ = serve.serve_batch(cfg, params, reqs(), max_len=20)
    eager, _ = serve.serve_batch(cfg, params, reqs(), max_len=20,
                                 step_fn=make_decode_step(cfg, graphs=False))
    for a, b in zip(graphed, eager):
        assert np.array_equal(a.out, b.out)


def test_graph_launch_counts_match_the_profiler(gen):
    """The launches a replay adds to the wrappers' counters are the kernels
    the profiler sees in one replay."""
    from torch.profiler import ProfilerActivity, profile
    cfg = _smoke("smollm_360m")
    params = transformer.init(torch.Generator(device="cuda").manual_seed(0),
                              cfg, device="cuda")
    step = make_decode_step(cfg)
    cache = model_api(cfg).init_cache(cfg, 2, 16, device="cuda")
    tok = torch.zeros(2, dtype=torch.int32, device="cuda")
    step(params, cache, tok, 0)
    g = _only_graph(step)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            g.replay()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert round(sum("rmsnorm" in n for n in names) / 3) == \
        g.per_replay["rmsnorm_cuda.launches"]
    assert round(sum("decode_attention" in n for n in names) / 3) == \
        g.per_replay["decode_attention_cuda.launches"]
    step.release()


def test_streaming_inference_depths_agree_on_the_card(gen):
    """The inference app's predictor on the card: depths 1, 2 and 3 give
    the same score bit for bit (one stream per replica), every batch is
    scored on CUDA, and the score agrees with the CPU predictor's."""
    from repro_torch.streaming.apps import streaming_inference
    from repro_torch.streaming.runtime import run_app

    def run(device, depth):
        app = streaming_inference(model_versions=1, device=device)
        rt = run_app(app, {}, batch=16, max_batches=40, dispatch_depth=depth)
        pred = app.kernels["predictor"].predictor
        assert pred.batches == {device: 40}
        return rt.states["sink"][0]

    # the products are float32 whatever the global TF32 switch says
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        sinks = [run("cuda", d) for d in (1, 2, 3)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    cpu = run("cpu", 1)
    assert {s["seen"] for s in sinks} == {cpu["seen"]} == {40 * 16}
    assert len({s["score"].hex() for s in sinks}) == 1
    assert sinks[0]["score"] == pytest.approx(cpu["score"], rel=1e-5)


# ---------------------------------------------------------------------------
# The encoder-decoder's and the vlm backbone's shapes: whisper's encoder
# (not causal, G 1, D 64, 1,500 keys: no multiple of a 64-key tile), its
# cross attention (64 or 448 queries against the 1,500 encoder states), its
# cross decode (G 1 over 1,500 slots, no length), llava's prefill (bf16 D
# 128, G 4, causal, 2,880 patches + 64 tokens)
# ---------------------------------------------------------------------------

def _close_scaled(got, want):
    """bf16 outputs that sum over ~1,500 keys, whose typical |O| (~0.04) is
    about TOL itself: each element to one bf16 ulp of the plain value (both
    sides round a float32 result to bf16; ulp <= 2^-7 |x|) plus 2^-5
    rms(plain) for the kernels' bf16 P and dS before that rounding."""
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    w = want.float()
    limit = 2.0 ** -7 * w.abs() + 2.0 ** -5 * w.square().mean().sqrt()
    err = (got.float() - w).abs()
    assert bool((err <= limit).all()), float((err / limit).max())


def _close_encdec(got, want, dtype, tol):
    if dtype == torch.bfloat16:
        _close_scaled(got, want)
    else:
        _close_tol(got, want, tol)


ENCDEC_FLASH = [
    # b, hq, hkv, sq, skv, d
    (2, 12, 12, 1500, 1500, 64),     # whisper's encoder, batch cut to 2
    (2, 12, 12, 64, 1500, 64),       # cross attention of a 64-token prefill
    (1, 12, 12, 448, 1500, 64),      # cross attention of a 448-token step
]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", ENCDEC_FLASH)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_encdec_shapes(gen, b, hq, hkv, sq, skv, d, dtype):
    q = _randn(gen, (b, hq, sq, d), dtype)
    k, v = _randn(gen, (b, hkv, skv, d), dtype), _randn(gen, (b, hkv, skv, d), dtype)
    _close_encdec(flash_attention_cuda(q, k, v, False, None, 0),
                  flash_attention_plain(q, k, v, False, None, 0), dtype, TOL[dtype])


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", ENCDEC_FLASH)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_encdec_shapes(gen, b, hq, hkv, sq, skv, d, dtype):
    """Not causal: dK/dV sum over every q tile (Sq < Skv in cross
    attention); bf16 with the forward's L, as training passes it."""
    q, k, v, do = _bwd_case(gen, b, hq, hkv, sq, skv, d, dtype)
    lse = None
    if dtype == torch.bfloat16:
        o, lse = flash_attention_cuda(q, k, v, False, None, 0, return_lse=True)
    else:
        o = flash_attention_cuda(q, k, v, False, None, 0)
    got = flash_attention_bwd_cuda(q, k, v, o, do, False, None, 0, lse=lse)
    want = flash_attention_bwd_plain(q, k, v, o, do, False, None, 0)
    for g, w in zip(got, want):
        _close_encdec(g, w, dtype, BWD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_cross_cache(gen, dtype):
    """Whisper's cross decode: 8 x 12 heads of 64 at G 1 over 1,500 slots
    with no length (every slot valid), through ``ops`` as the model calls
    it; the split plan cuts the cache in three."""
    q, k, v = _decode_inputs(gen, 8, 12, 12, 1500, 64, dtype)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    assert split_plan(8, 12, 1, 1500, n_sm) == (3, 500)
    n = decode_attention_cuda.launches
    got = ops.decode_attention(q, k, v)
    assert decode_attention_cuda.launches == n + 1
    _close_encdec(got, decode_attention_plain(q, k, v), dtype, TOL[dtype])


def test_flash_attention_llava_prefill(gen):
    """bf16 D 128, G 4 (32 q / 8 kv heads), causal over 2,944 positions:
    llava's prefill of 2,880 image patches and 64 tokens, batch cut to 1."""
    dtype = torch.bfloat16
    q = _randn(gen, (1, 32, 2944, 128), dtype)
    k, v = _randn(gen, (1, 8, 2944, 128), dtype), _randn(gen, (1, 8, 2944, 128), dtype)
    _close(flash_attention_cuda(q, k, v, True, None, 0),
           flash_attention_plain(q, k, v, True, None, 0), dtype)


@pytest.mark.parametrize("name", ["whisper_small", "llava_next_mistral_7b"])
def test_graphed_frontend_steps_match_eager_bit_for_bit(gen, name):
    """SMOKE whisper and llava on the card: the prefill (frames + tokens;
    ``embeds``) and 24 decode steps (whisper from a cache of real cross
    K/V), eager and from their graphs, bit for bit; the launches a replay
    adds are one call's (whisper: every layer's self and cross attention,
    the encoder's norms in the prefill only)."""
    cfg = get(name, smoke=True)
    api = model_api(cfg)
    params = api.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                      device="cuda")
    fgen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 24), device="cuda", generator=gen)
    if cfg.is_encdec:
        from repro_torch.models import encdec
        batch = {"frames": frontends.audio_frames(fgen, cfg, 2), "inputs": toks}
        with torch.no_grad():
            enc = encdec.encode(params, batch["frames"], cfg)
        caches = [api.init_cache(cfg, 2, 32, enc, params, device="cuda")
                  for _ in range(2)]
        n_enc, n_dec = cfg.encoder_layers, cfg.n_layers
        per_fwd = {"rmsnorm_cuda.launches": 2 * n_enc + 1 + 3 * n_dec + 1,
                   "flash_attention_cuda.launches": n_enc + 2 * n_dec}
        per_dec = {"rmsnorm_cuda.launches": 3 * n_dec + 1,
                   "decode_attention_cuda.launches": 2 * n_dec}
    else:
        patches = frontends.image_patches(fgen, cfg, 2)
        batch = {"embeds": frontends.fuse_vlm_inputs(params, patches, toks, cfg)}
        caches = [api.init_cache(cfg, 2, 32, device="cuda") for _ in range(2)]
        per = _per_step(cfg)
        per_fwd = {"rmsnorm_cuda.launches": per["rmsnorm_cuda.launches"],
                   "flash_attention_cuda.launches": per["flash"]}
        per_dec = {"rmsnorm_cuda.launches": per["rmsnorm_cuda.launches"],
                   "decode_attention_cuda.launches": per["attn"]}
    eager, graphed = make_prefill_step(cfg, graphs=False), make_prefill_step(cfg)
    for _ in range(2):
        assert torch.equal(graphed(params, batch), eager(params, batch))
    g = _only_graph(graphed)
    assert {k: g.per_replay[k] for k in per_fwd} == per_fwd
    graphed.release()
    eager, graphed = make_decode_step(cfg, graphs=False), make_decode_step(cfg)
    for t in range(24):
        n_e, l_e, _ = eager(params, caches[0], toks[:, t], t)
        n_g, l_g, _ = graphed(params, caches[1], toks[:, t], t)
        assert torch.equal(l_g, l_e) and torch.equal(n_g, n_e), f"step {t}"
    for a, b in zip(tree_leaves(caches[0]), tree_leaves(caches[1])):
        assert torch.equal(a, b)
    g = _only_graph(graphed)
    assert {k: g.per_replay[k] for k in per_dec} == per_dec
    graphed.release()


@pytest.mark.parametrize("arch", ["whisper_small", "llava_next_mistral_7b"])
def test_serve_main_and_train_run_the_frontend_smoke_configs(gen, arch, capsys):
    """``serve.main`` graphed and eager with the same tokens, and three
    graphed train steps through ``train()`` with finite losses."""
    graphed = serve.main(["--arch", arch])
    eager = serve.main(["--arch", arch, "--eager"])
    assert "on cuda (graphed)" in capsys.readouterr().out
    for a, b in zip(graphed, eager):
        np.testing.assert_array_equal(a.out, b.out)
    out = train(arch, smoke=True, steps=3, batch=2, seq=16)
    assert np.isfinite(out["losses"]).all() and out["capture"] is not None
