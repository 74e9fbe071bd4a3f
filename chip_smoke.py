#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card: serving smollm-360M
(dense), Jamba (hybrid Mamba + attention), xlstm-125m and DeepSeek-V3 (MLA +
MoE), the SMOKE configs the server and trainer default to (and the MoE
ones), training smollm-360M, DeepSeek-V3's MLA prefix and Qwen3-MoE, the
paper's streaming apps with the inference app's predictor on the card,
serving and training whisper-small (encoder-decoder) and
llava-next-mistral-7b (a vlm backbone on image-patch embeddings), and
training Jamba (through the selective scan's backward kernel) and
xlstm-125m.

  python3 chip_smoke.py

Run from the root of a checkout: it builds the CUDA kernels from
``src/repro_torch/csrc`` and then, each phase on a line of its own with its
time,
  1. prints the card's name and power limit (nvidia-smi), the build time,
     ptxas's registers and spills for the instances of the bf16
     flash-attention forward and backward, decode-attention, RMSNorm
     (forward and backward), scan, clip and AdamW kernels, the HGMMA
     (tensor-core) instructions in the flash kernels' SASS (cuobjdump),
     failing if the forward has none (or its D-192 instance, MLA's, has
     none, spills, or its consumer warpgroups' setmaxnreg differs from its
     plan's; ptxas's registers and spills of the float32 instances too, D 24
     and 192 among them), if a bf16 backward instance has none,
     if the head-dim-64 or head-dim-192 backward instances spill (ptxas's
     report of the float32 backward at 24 and 192 too) or if the train step's
     RMSNorm-backward, sumsq or AdamW instance spills, and for each scan
     instance (serving, training: the one that saves states, backward) its SASS
     instructions, MUFU.EX2, SHFL and LDL/STL counts and resident blocks per
     SM (serving, backward), failing if one spills or holds fewer blocks than
     its launch plan;
  2. holds each kernel against its plain PyTorch version on the card, at the
     main paths' shapes (smollm and Jamba; xLSTM's RMSNorm widths), in bf16
     and float32, with its device time, the kernels one call runs (from
     the profiler; 1 for decode attention and RMSNorm, or the phase fails),
     back-to-back time, bound, the plain version's time and a library
     call's time as a yardstick where one PyTorch call computes the same
     function (flash rows also name the instance that ran: wgmma for bf16,
     simt for float32; bf16 decode rows add a sweep of the split count;
     the scan runs with Mamba's initial A and with a random A, and its
     timed rows add the SM clock while it runs back to back; the scan's
     training forward, which also saves the state every 16 steps, and its
     backward (``csrc/mamba_scan_bwd.cu``, two launches) at Jamba's training
     shape in bf16 with both A's, B and C column slices, and in float32 at a
     ragged SMOKE shape with h0 and dh_T, each backward call bit-equal to a
     second one, bf16 gradients held to SCALED_LIMIT); the SMOKE
     configs' head dims (16, 20) in the attention kernels; MLA's head dims
     in flash attention (bf16 q = k = v (8, 128, 512, 192) causal, without
     and with L, contiguous and in the model's layout; float32 at 192 and
     24; SDPA with the scale as yardstick);
     and the two
     backward kernels (flash attention at smollm's and, in bf16, Jamba's
     training shapes, with the forward's log-sum-exp as training passes
     it, and at SMOKE shapes with a window, an offset and ragged lengths;
     at MLA's head dims: bf16 q = k = v (8, 128, 512, 192) causal with the
     forward's L, contiguous and in the model's layout with V padded, and
     float32 at (2, 16, 512, 192) and (8, 4, 512, 24), SDPA's backward with
     the scale as yardstick; whisper's and llava's shapes: flash attention
     not causal at G 1, D 64 over 1,500 keys from 1,500, 448 and 64 queries
     (the encoder, cross attention) and its backward with L, decode attention
     at G 1 over 1,500 cross slots with no length (with the split sweep), and
     the bf16 forward at D 128, G 4, causal over 8 x 2,944 positions (llava's
     prefill), bf16 timed against SDPA and float32 checked;
     RMSNorm at d 960, 768, 1536), and the bf16 forward that also writes
     the log-sum-exp; the backward's library yardstick is the backward of
     ``scaled_dot_product_attention`` (``enable_gqa``) or ``F.rms_norm``:
     autograd forward + backward less the forward; and the train step's
     clip and AdamW kernels over smollm-360M's 11 leaves, bf16 and float32
     (``sumsq``, ``clip_finalize``, ``adamw_update``: each leaf timed alone
     and summed; params within one bf16 ulp, m and v to 1e-6 relative;
     yardsticks ``torch._foreach_norm`` and ``torch.optim.AdamW(fused=True)``
     on float32 copies);
  3. runs full-width smollm-360M prefill (bf16, 8 x 512 tokens) through
     ``make_prefill_step``, eagerly (``graphs=False``) and from its CUDA
     graph (the default on the card), on the same weights and tokens: each
     path's tokens/s, the graphed logits equal to the eager ones bit for
     bit, the graph's capture time (after its warm-up calls) and pool bytes,
     and the launches a replay adds against one forward's;
  4. serves 8 requests (64-token prompts, 64 new tokens) through
     ``serve_batch``, eagerly and from the decode step's graph: new tokens/s
     of each (the graphed one also after its capture), the graphed tokens
     equal to the eager ones, the launches per decode step and per replay;
  5. compares float32 logits, card against CPU (plain versions), at full
     width, for prefill and for teacher-forced decode steps;
  6. profiles one prefill and one decode step, eager and graphed: device
     busy time, idle share and the kernels that take the time; and for each
     graph, the kernels and copies of one replay against one eager call of
     the same step on the same tensors (equal, or the phase fails), and the
     launches the wrappers' counters add per replay against the kernels the
     profiler sees in it;
  7-10. the same for Jamba at its published widths, cut to one period of 8
     layers (attention + 7 Mamba) with a dense SwiGLU of Jamba's d_ff in
     every FFN (MoE is not ported): prefill, serving, a profile, and float32
     parity on a 2-layer cut (attention + Mamba);
  11. xlstm-125m at full width and depth: prefill and serving, eager and
     graphed (the sLSTM loop over time runs inside the graph);
  12. the SMOKE configs (head dims 16 and 20): ``serve.main([])`` with its
     defaults, graphed, and ``serve.main(["--eager"])``, with equal tokens;
     h2o-danube SMOKE served past its window of 16, eager and graphed, with
     equal tokens; and the float32 logits of smollm, h2o-danube and Jamba
     (dense FFN) SMOKE, card against CPU, as phase 5; then the same for the
     MoE SMOKE configs (DeepSeek with MLA at head dim 24, Qwen3-MoE, Jamba
     with its real MoE layers), whisper and llava SMOKE:
     ``serve.main(["--arch", ...])`` graphed and eager with equal tokens, and
     float32 logits card vs CPU (whisper's prefill on frames and its decode
     steps on the cross K/V of the encoded frames; llava's prefill on tokens
     and on ``embeds``);
  13. trains full-width smollm-360M (bf16, 8 x 512 tokens a step) through
     ``launch.train.train``, eagerly and from the train step's graph: step
     time, tokens/s, the 16 losses and grad norms (the graphed ones equal to
     the eager ones bit for bit; finite, falling), peak device memory of
     each, the launches per step of every forward and backward kernel and
     of the clip and AdamW kernels against the counts worked out from the
     config and the param tree (remat runs each period's forward twice; a
     ``sumsq`` and an ``adamw_update`` per leaf, one ``clip_finalize``), no
     extra forward for the backward's log-sum-exp, the graph's capture, a
     profile of one step eager and replayed with the flash backward's
     device time and share, and one eager step's device time by
     ``record_function`` range (``loss_fwd``, ``backward``, ``clip``,
     ``optimizer``), failing if the clip or the optimizer runs a full-size
     elementwise kernel (an aten op on a tensor of more than one element);
  14. float32 training parity, card against CPU, at full width cut to 2
     layers: the loss, the grad norm, every gradient leaf, and the params
     after one AdamW step (the fused kernels on the card); decode attention
     refuses a gradient, the scan's gradient through its kernels equals the
     plain scan's;
  15-19. DeepSeek-V3 at its published widths cut to 5 layers (the 3
     dense-FFN layers of its prefix + 2 MLA + MoE layers, 26.6 B params)
     without the MTP module, after every earlier model is freed: prefill 8 x
     512 and serving 8 x (64 + 64), each eager and graphed with equal
     logits / tokens, a profile of one prefill and one decode step, the
     peak device memory, and float32 parity of one full-width MLA block
     (``block_apply`` then 8 absorbed ``block_decode`` steps) card vs CPU;
  20. trains DeepSeek-V3 at its published widths cut to its 3 dense-FFN
     prefix layers (MLA + SwiGLU, ~3.6 B params, an empty stack) without
     MTP, 8 steps of 8 x 512 tokens through ``launch.train.train``, eagerly
     and from the train step's graph: step time, tokens/s, losses and grad
     norms (graphed = eager, bit for bit; finite, falling), peak memory,
     launches per step (the bf16 D-192 flash backward among them), the
     graph's capture, one eager step's device ms by range;
  21. the same for Qwen3-MoE at its published widths cut to one layer
     (~3.7 B params: the MoE dispatch's backward, flash at G 16, D 128);
  22. float32 training parity card vs CPU (phase 14's tolerances) of
     DeepSeek SMOKE with its MTP module (MLA at head dim 24) and Qwen3-MoE
     SMOKE, and every gradient of one full-width MLA + SwiGLU prefix block
     at 2 x 16 tokens (the float32 D-192 backward);
  23. streaming (the paper's own system, host NumPy): RLAS plans on
     server_a (the paper's settings, r = 5) of word count, fraud detection,
     spike detection and linear road, with the planner's seconds, each
     plan's parallelism, sockets and estimate; each plan executed on the
     threads backend at BENCH_streaming.json's batch (256; LR 1024), a
     replay whose sink counts must be what the app defines, and a 1 s run
     (tuples/s, beside the host CPU's model); then ``streaming_inference``
     with its predictor on the card at batch 16: depths 1, 2 and 3 over 200
     replayed batches give the same score bit for bit, every batch scored on
     cuda, within rel 1e-5 of the CPU plain predictor's; 1 s at depths 1 and
     2 with 8 live model versions (tuples/s, device ms a call from CUDA
     events, beside the declared 2500 ns a tuple); the processes backend
     refused in this CUDA parent; and in a fresh interpreter the processes
     backend equal to the threads backend;
  24. whisper-small at its published widths and depth (12 + 12 layers, d
     768, 12 heads of 64, 1,500 frames, vocab 51865), weights from seed 0:
     prefill of 8 x (1,500 frames + 64 tokens), 64 greedy decode steps from
     ``init_cache(..., enc_states, params)`` (the encoded frames' cross
     K/V), ``serve_batch`` 8 x (64 + 64) as the reference serves it (cross
     K/V zeros), each eager and graphed and equal, with launches from
     ``per_pass`` (36 flash calls and 62 RMSNorms a forward, 24
     decode-attention calls and 37 RMSNorms a step); a profile of one
     prefill and one decode step; peak memory; float32 logits card vs CPU
     on a 2 + 2-layer cut;
  25. trains whisper-small whole, 8 steps of 8 x (1,500 frames + 448
     tokens) through ``launch.train.train`` (the audio frontend's frames
     drawn each step), eagerly and graphed, as phase 20: bit-equal losses
     and grad norms, finite and falling, launches from ``per_train_step``,
     peak memory, one eager step by range;
  26. llava-next-mistral-7b at its published widths and depth (32 layers,
     ~7.2 B params): prefill of 8 x (2,880 image-patch embeddings + 64 text
     tokens) fused by ``fuse_vlm_inputs`` (the ``embeds`` branch), serving
     8 x (64 + 64), each eager and graphed and equal; peak memory;
  27. trains llava through the vlm branch of ``launch.train.train``, 8
     steps of 8 x 3,072 positions (2,880 patches + 192 tokens), cut to
     ``LLAVA_TRAIN_CUT`` layers so that AdamW fits, as phase 20, failing
     unless the embedding alone took no gradient (its AdamW moment stays
     zero, as the reference's gradient is);
  28. trains Jamba at its published widths cut to one attention and two
     Mamba layers with its dense SwiGLU (``JAMBA_TRAIN_CUT``, 3.88 B params),
     8 steps of 8 x 512 through ``launch.train.train``, eager and graphed, as
     phase 20 (launches from ``per_train_step``: the scan's training forward
     twice a Mamba layer under remat, its backward once); then Jamba's rate
     witness: ``JAMBA_WITNESS_CUT`` (attention + 1 Mamba layer) at 3e-4 in
     bf16 and in float32 (both loss and grad-norm curves), and 4 float32
     steps of Jamba SMOKE at 3e-4 on the card and the CPU in lockstep, at
     SMOKE's N 4 and at Jamba's N 16;
  29. float32 training parity card vs CPU (phase 14's tolerances): Jamba
     SMOKE with its real MoE layers, and every gradient of one full-width
     Mamba layer at 2 x 32 tokens;
  30. trains xlstm-125m whole, 4 steps of 8 x 512, eager and graphed, with
     bit-equal losses that fall, step time and peak memory;
Every path runs with the launch counts set to 0 just before it and read just
after; a graphed path's counts include its warm-up calls (``WARMUP`` eager
calls before capture), and a replay adds what the capture recorded. Then it prints the kernel table as one JSON line (the rows of
MLA's flash instances count the launches of the path that runs each:
DeepSeek-V3 prefill for bf16 D 192, the parity phases for float32 D 192
and 24; for the backward, DeepSeek-V3 training for bf16 D 192 and phase
22 for float32 D 192 and 24; whisper's and llava's shapes the launches of
phases 24-25 and 26-27; the scan's training forward and backward those of
phase 28) and, last,
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
with no CUDA device, or outside a checkout, it exits non-zero at once. The
full report goes to ``build/chip_smoke.json``, the compiler's output (ptxas
registers and spills) to ``build/kernels/build_<hash>.log``, the scan
instances' SASS to ``build/scan_sass.txt``.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
SEED = 0

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s; dense ops/s by
# input type (bf16 on the tensor cores, float32 on the CUDA cores).
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
# exponentials/s: 16 special-function results per SM per clock (Hopper
# white paper), 132 SMs at the 1.98 GHz boost clock
PEAK_EXP = 132 * 16 * 1.98e9

# |kernel - plain| <= TOL * (1 + |plain|): the kernels accumulate in float32
# like the plain versions, so float32 differs only in summation order; bf16
# differs by the rounding of the output to bf16.
TOL = {("rmsnorm", "float32"): 1e-5, ("rmsnorm", "bfloat16"): 2e-2,
       ("attn", "float32"): 2e-5, ("attn", "bfloat16"): 3e-2,
       # the scan: exp2f vs expf and FMA vs two roundings, over 512 steps
       # of a decaying state (the tolerance of the JAX package's own test)
       ("scan", "float32"): 1e-4, ("scan", "bfloat16"): 3e-2,
       # backward kernels: dq/dk/dv and dx sum over more terms than the
       # forward's outputs (dk/dv over every q row of G heads) in another
       # order; bf16 adds one rounding of each output
       ("attn_bwd", "float32"): 1e-4, ("attn_bwd", "bfloat16"): 5e-2,
       # the bf16 forward's log-sum-exp: float32 from the same bf16 inputs
       # on both sides (ex2/lg2 approximations, summation order); its O as
       # ("attn", "bfloat16")
       ("attn_lse", "float32"): 1e-4, ("attn_lse", "bfloat16"): 3e-2,
       ("rmsnorm_bwd", "float32"): 1e-4, ("rmsnorm_bwd", "bfloat16"): 2e-2,
       # AdamW's params: float32 summation-free arithmetic rounded as the
       # plain version's; a bf16 param within one bf16 ulp (2^-7 relative)
       ("adamw", "float32"): 2e-5, ("adamw", "bfloat16"): 2 ** -7,
       # the sums of squares and the norm: float32 in another order
       ("sumsq", "float32"): 1e-5, ("sumsq", "bfloat16"): 1e-5,
       # the scan's backward: float32 gradients (every one for float32 u;
       # ddt, dA, dD, dh0 for bf16 u) in another summation order with
       # ex2.approx, held as gradient leaves (1e-4 max|g| + 1e-6: dA sums
       # over every batch row and step, where the plain version's own
       # float32 error passes an elementwise 1e-4); its bf16 du, dB, dC are
       # held to SCALED_LIMIT
       ("scan_bwd", "float32"): 1e-4, ("scan_bwd", "bfloat16"): 3e-2}
# bf16 attention over 1,500 keys (whisper's rows): the outputs are sums over
# every key with a typical |O| of ~0.04, about TOL itself, so those rows are
# held per element to one bf16 ulp of the plain value (both sides round
# their float32 result to bf16; ulp <= 2^-7 |x|) plus a floor scaled to the
# output, BF16_RMS_SHARE * rms(plain), for the kernels' bf16 P and dS
# (2^-9 relative a term) before that rounding
BF16_ULP_SHARE = 2.0 ** -7
BF16_RMS_SHARE = 2.0 ** -5
SCALED_LIMIT = "2^-7 |plain| + 2^-5 rms(plain)"
# AdamW's moments m and v, float32 on both sides: relative
ADAMW_MV_TOL = 1e-6
# RMSNorm's dscale sums dy * x * r over every row, float32 on both sides:
# the norm of the difference over the norm of the plain version's
DSCALE_TOL = 1e-4
# training, float32, card vs CPU after one backward at full width (2 layers):
# each gradient leaf to GRAD_TOL * max|g| + 1e-6 (summation order), the
# loss to LOSS_TOL; the params after one AdamW step to 2 lr + 1e-6 (its first
# update is about lr * sign(g), and a near-zero gradient's sign may differ)
GRAD_TOL = 1e-4
LOSS_TOL = 1e-4
# float32 logits, card vs CPU, after 32 layers: the same arithmetic in a
# different accumulation order (cuBLAS vs CPU GEMMs, kernels vs einsum)
# drifts by ~1e-5; a wrong mask, scale or cache slot moves logits by >1e-1.
PARITY_TOL = 1e-3

KERNELS = {  # name: (source, TPU kernel it replaces, main-path case)
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:23", "4096x960"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention_sm90.cu",
                        "src/repro/kernels/flash_attention.py:84",
                        "causal 8x15/5x512x512x64"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:61",
                         "8x15/5x129x64 ragged length"),
    "mamba_scan": ("src/repro_torch/csrc/mamba_scan.cu",
                   "src/repro/kernels/mamba_scan.py:46",
                   "8x512x16384 N16 dt f32 random A"),
    # the scan's training instance (the same kernel, writing the state every
    # 16 steps) and its backward; the reference differentiates its jnp scan
    "mamba_scan_train": ("src/repro_torch/csrc/mamba_scan.cu",
                         "src/repro/kernels/mamba_scan.py:46",
                         "8x512x16384 N16 dt f32 random A, states every 16"),
    "mamba_scan_bwd": ("src/repro_torch/csrc/mamba_scan_bwd.cu",
                       "src/repro/kernels/mamba_scan.py:46",
                       "8x512x16384 N16 dt f32 random A"),
    "rmsnorm_bwd": ("src/repro_torch/csrc/rmsnorm_bwd.cu",
                    "src/repro/kernels/rmsnorm.py:23", "4096x960"),
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
                            "src/repro/kernels/flash_attention.py:84",
                            "causal 8x15/5x512x512x64"),
    # the clip and AdamW: no Pallas kernel; the reference leaves them to XLA
    "sumsq": ("src/repro_torch/csrc/adamw.cu", "src/repro/optim/optimizers.py:23",
              "smollm-360M 11 leaves"),
    "clip_finalize": ("src/repro_torch/csrc/adamw.cu",
                      "src/repro/optim/optimizers.py:28", "smollm-360M 11 leaves"),
    "adamw_update": ("src/repro_torch/csrc/adamw.cu",
                     "src/repro/optim/optimizers.py:62", "smollm-360M 11 leaves"),
}
# rows of the kernel table beside KERNELS: the flash instances of MLA's head
# dims, each counted on the path that runs it (name: (source, TPU kernel it
# replaces, phase-2 case, dtype, path))
MLA_CASE = "MLA causal 8x128/128x512x512x192"
# the same in mla_apply's layout: (B, H, S, D) views of (B, S, H, 192) q, k
# and of V padded from 128
MLA_MODEL_CASE = "MLA causal 8x128/128x512x512x192 model layout (B,S,H,D) views, V padded"
# the D-192 bf16 instance's device ms at MLA_CASE in PR 20 (<DP 192, NC 1>,
# NVIDIA H100 80GB HBM3, 700.00 W): printed beside this run's as a label only
MLA_PARENT_MS = 0.7329
MLA_ROWS = {
    "flash_attention_d192": ("src/repro_torch/csrc/flash_attention_sm90.cu",
                             "src/repro/kernels/flash_attention.py:84", MLA_CASE,
                             "bfloat16", "DeepSeek-V3 prefill (phases 15-17)"),
    "flash_attention_f32_d192": ("src/repro_torch/csrc/flash_attention.cu",
                                 "src/repro/kernels/flash_attention.py:84",
                                 "MLA causal 2x16/16x512x512x192", "float32",
                                 "MLA block parity (phase 19)"),
    "flash_attention_f32_d24": ("src/repro_torch/csrc/flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:84",
                                "DeepSeek SMOKE causal 8x4/4x512x512x24", "float32",
                                "DeepSeek SMOKE parity (phase 12)"),
}
# the flash backward at MLA's head dims, each counted on the training path
# that runs it (name: (source, TPU kernel it replaces, phase-2 case, dtype,
# path))
MLA_BWD_CASE = "MLA bwd causal 8x128/128x512x512x192 with L"
MLA_BWD_MODEL_CASE = ("MLA bwd causal 8x128/128x512x512x192 with L, model layout "
                      "(B,S,H,D) views, V padded")
MLA_BWD_ROWS = {
    "flash_attention_bwd_d192": ("src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
                                 "src/repro/kernels/flash_attention.py:84", MLA_BWD_CASE,
                                 "bfloat16", "DeepSeek-V3 training (phase 20)"),
    "flash_attention_bwd_f32_d192": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                                     "src/repro/kernels/flash_attention.py:84",
                                     "MLA bwd causal 2x16/16x512x512x192", "float32",
                                     "MLA block gradient parity (phase 22)"),
    "flash_attention_bwd_f32_d24": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                                    "src/repro/kernels/flash_attention.py:84",
                                    "DeepSeek SMOKE bwd causal 8x4/4x512x512x24", "float32",
                                    "DeepSeek SMOKE training parity (phase 22)"),
}
# the encoder-decoder's and the vlm backbone's attention shapes (phase 2),
# each a row of the kernel table counted on the path that runs it (name:
# (kernel, source, TPU kernel it replaces, phase-2 case, dtype, path))
WHISPER_ENC_CASE = "whisper encoder 8x12/12x1500x1500x64 not causal"
WHISPER_CROSS_CASE = "whisper cross 8x12/12x448x1500x64 not causal"
WHISPER_CROSS_PREFILL_CASE = "whisper cross 8x12/12x64x1500x64 not causal"
WHISPER_DECODE_CASE = "whisper cross 8x12/12x1500x64 every slot (no length)"
LLAVA_CASE = "llava prefill causal 8x32/8x2944x2944x128"
LLAVA_BWD_CASE = "llava training bwd causal 8x32/8x3072x3072x128 with L"
FRONTEND_ROWS = {
    "flash_attention_whisper": (
        "flash_attention", "src/repro_torch/csrc/flash_attention_sm90.cu",
        "src/repro/kernels/flash_attention.py:84", WHISPER_ENC_CASE, "bfloat16",
        "whisper serving and training (phases 24-25): encoder, self and cross attention"),
    "flash_attention_bwd_whisper": (
        "flash_attention_bwd", "src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
        "src/repro/kernels/flash_attention.py:84", WHISPER_ENC_CASE + " with L",
        "bfloat16", "whisper training (phase 25): encoder, self and cross attention"),
    "decode_attention_whisper": (
        "decode_attention", "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:61", WHISPER_DECODE_CASE, "bfloat16",
        "whisper serving (phase 24): self caches and cross K/V"),
    "flash_attention_llava": (
        "flash_attention", "src/repro_torch/csrc/flash_attention_sm90.cu",
        "src/repro/kernels/flash_attention.py:84", LLAVA_CASE, "bfloat16",
        "llava serving and training (phases 26-27)"),
    "flash_attention_bwd_llava": (
        "flash_attention_bwd", "src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
        "src/repro/kernels/flash_attention.py:84", LLAVA_BWD_CASE, "bfloat16",
        "llava training (phase 27)"),
}
# llava training at its published widths, cut to 16 of its 32 layers: 3.75 B
# params, 45 GB of bf16 params and grads and float32 AdamW moments, beside
# ~12 GB of activations at 8 x 3,072 positions (remat)
LLAVA_TRAIN_CUT = dict(n_layers=16)
# its AdamW base rate. train() warms up for steps // 10 steps (one of 8); at
# the trainer's 3e-4 default, AdamW's first steps, which move every weight by
# about the rate, overshoot at d 4096: the loss rises over the first steps
# and ends the 8 above where it began, which the phase's check refuses. The
# rate witness of phase 27 runs 3e-4 at these widths (2 layers, float32) on
# the card and the CPU in lockstep
LLAVA_TRAIN_LR = 1e-5
# training at full width, cut to what one card holds with AdamW's 12 bytes a
# param: DeepSeek-V3's 3 dense-FFN prefix layers (MLA + SwiGLU, ~3.6 B
# params; a MoE layer is 11.5 B) without the MTP module (an MLA + MoE block),
# and one Qwen3-MoE layer (~3.7 B params; two would be 6.2 B, 74.6 GB of
# state); steps of 8 x 512 tokens
DEEPSEEK_TRAIN_CUT = dict(n_layers=3, mtp=False)
QWEN_TRAIN_CUT = dict(n_layers=1)
MOE_TRAIN_STEPS = 8
# steps of phase 27's float32 card-vs-CPU lockstep (each ~20 s on the CPU)
RATE_LOCKSTEP_STEPS = 4
# smollm-360M training in phase 13: steps of 8 x 512 tokens
TRAIN_STEPS = 16

# Jamba at its published widths, cut to what the port runs: one period of 8
# layers (attention at 0, Mamba at 1-7) with a dense SwiGLU of Jamba's own
# d_ff in every FFN in place of the MoE layers (ROADMAP queue 1, item 3).
JAMBA_DENSE = dict(n_layers=8, n_experts=0, top_k=0, d_expert=0,
                   period=(("attn", "mlp"),) + (("mamba", "mlp"),) * 7)
# the float32 parity cut: one attention and one Mamba layer at full width
JAMBA_PARITY = dict(n_layers=2, dtype="float32",
                    period=(("attn", "mlp"), ("mamba", "mlp")))
# Jamba training at its published widths, cut to what one card holds with
# AdamW's 12 bytes a param: one attention and two Mamba layers with Jamba's
# dense SwiGLU (3.88 B params: embeddings 1.07 B, the attention layer 0.76 B,
# each Mamba layer 1.02 B); a MoE layer alone is 16 x 604 M params
JAMBA_TRAIN_CUT = dict(n_layers=3, n_experts=0, top_k=0, d_expert=0,
                       period=(("attn", "mlp"), ("mamba", "mlp"), ("mamba", "mlp")))
# Jamba's rate witness (phase 28): its published widths cut to one attention
# and one Mamba layer with the dense SwiGLU (2.85 B params: 45.6 GB of float32
# params, grads and AdamW moments), trained at the trainer's 3e-4 in bf16 and
# in float32; the card-vs-CPU lockstep runs Jamba SMOKE (its MoE layers),
# since the full-width cut's float32 AdamW state and per-step copies would
# take ~60 GB of the host's memory
JAMBA_WITNESS_CUT = dict(n_layers=2, n_experts=0, top_k=0, d_expert=0,
                         period=(("attn", "mlp"), ("mamba", "mlp")))
# xlstm-125m training in phase 30: steps of 8 x 512 tokens
XLSTM_TRAIN_STEPS = 4
# DeepSeek-V3 at its published widths, cut to what one 80 GB card holds: the
# 3 dense-FFN layers of its prefix and 2 MLA + MoE layers (26.6 B params,
# 53.2 GB bf16; a third MoE layer would not fit), without the MTP module,
# which only the training loss reads
DEEPSEEK_CUT = dict(n_layers=5, mtp=False)


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


# The tracer (CUPTI) now and then records no device activity, or drops a
# few events, for a spell of about a tenth of a second, into which several
# short sessions in a row can fall. A session that shows it is run again
# after a pause that doubles each time, up to PROFILER_ATTEMPTS sessions;
# PROFILER_RETRIES counts the sessions run again, by what they showed.
PROFILER_ATTEMPTS = 6
PROFILER_PAUSE_S = 0.1
PROFILER_RETRIES = collections.Counter()


def cuda_event_counts(prof) -> collections.Counter:
    return collections.Counter(e.name for e in prof.events()
                               if e.device_type == torch.autograd.DeviceType.CUDA)


def whole_session(seen: collections.Counter, iters: int) -> bool:
    """A session of ``iters`` calls that recorded every event: each kernel
    or copy seen a multiple of ``iters`` times."""
    if not seen:
        PROFILER_RETRIES["empty"] += 1
        return False
    if any(n % iters for n in seen.values()):
        PROFILER_RETRIES["partial"] += 1
        return False
    return True


def pause(attempt: int):
    if attempt + 1 < PROFILER_ATTEMPTS:
        time.sleep(PROFILER_PAUSE_S * 2 ** attempt)


def profiled(fn, iters: int = 1, whole: bool = False):
    """The profiler (CUPTI) around ``iters`` calls of ``fn``. A session
    with no device activity, or with ``whole`` one that dropped events
    (``whole_session``), is run again after a pause; if none was whole, the
    one with the most events is kept, and if none recorded any the phase
    fails."""
    best, most = None, 0
    for attempt in range(PROFILER_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        seen = cuda_event_counts(prof)
        if whole_session(seen, iters if whole else 1):
            return prof
        if sum(seen.values()) > most:
            best, most = prof, sum(seen.values())
        pause(attempt)
    if best is None:
        fail("the profiler recorded no device time")
    return best


def device_profile(fn, iters: int = 21):
    """(device ms per call, kernels and copies per call, device ms per call
    of each kernel by name), from the profiler
    (CUPTI), after a warm-up, over ``iters`` calls of ``fn``: for each
    kernel or copy (by name), the median of its durations times the times
    one call runs it (its events over ``iters``, rounded). Counting by name
    keeps both numbers right when a session drops events, which the
    profiler now and then does (up to a dozen of 42 seen in one session)."""
    fn()
    torch.cuda.synchronize()
    prof = profiled(fn, iters, whole=True)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.time_range.end - e.time_range.start)
    each = {}
    per = 0
    for name, durations in by_name.items():
        n = max(1, round(len(durations) / iters))
        each[name] = statistics.median(durations) * n / 1e3
        per += n
    return sum(each.values()), per, each


def device_ms(fn, iters: int = 21) -> float:
    return device_profile(fn, iters)[0]


def launch_ms(fn, reps: int = 7) -> float:
    """Time per call of back-to-back calls (CUDA events): the device time or,
    for small kernels, the host's launch rate, whichever is slower. Median
    over ``reps`` runs of ~2 ms or 200 calls."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    end.synchronize()
    iters = max(1, min(200, math.ceil(2.0 / max(start.elapsed_time(end), 1e-3))))
    times = []
    for _ in range(reps):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def event_ms(fn, iters: int = 3) -> float:
    """Device-timeline ms per call of ``iters`` back-to-back calls (CUDA
    events) after one unrecorded call. For a plain version that launches
    tens of thousands of kernels a call (the scan's backward: ~25 a step),
    whose profiler sessions would hold ~10^5 events each and come back
    partial, run after run."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def sm_clock_mhz(fn, seconds: float = 0.5):
    """The SM clock (MHz, median of nvidia-smi's samples every 20 ms) while
    ``fn`` runs back to back for about ``seconds``."""
    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(
        ["nvidia-smi", "-i", str(torch.cuda.current_device()),
         "--query-gpu=clocks.sm", "--format=csv,noheader,nounits", "-lms", "20"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate()
    mhz = [float(v) for v in out.split() if v.replace(".", "").isdigit()]
    return statistics.median(mhz) if mhz else None


def bound(nbytes: float, ops: float, dtype: str, exps: float = 0.0):
    """(least ms, "bytes" or "operations", each term in ms): bytes over the
    memory rate against operations of ``dtype`` over their peak, and
    exponentials over the special-function units' rate."""
    terms = {"bytes_ms": nbytes / PEAK_BYTES * 1e3,
             "ops_ms": ops / PEAK_OPS[dtype] * 1e3,
             "exp_ms": exps / PEAK_EXP * 1e3}
    t_ops = max(terms["ops_ms"], terms["exp_ms"])
    if terms["bytes_ms"] >= t_ops:
        return terms["bytes_ms"], "bytes", terms
    return t_ops, "operations", terms


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def compare(kernel, case, dtype, got, want, tol_key, run=None, plain=None,
            library=None, n_bytes=0, ops=0, exps=0, ops_dtype=None,
            plain_iters=21, library_fwd=None, scaled=False, leafwise=False,
            plain_events=False):
    """One row of phase 2. ``got``/``want`` are a tensor or a tuple of
    tensors, each held to the tolerance of its own dtype; with ``scaled`` a
    bf16 tensor is held per element to SCALED_LIMIT instead, and the row
    keeps rms(plain), max|plain| and the worst err / limit of each; with
    ``leafwise`` a float32 tensor is held as a gradient leaf, |diff| <=
    tol * max|plain| + 1e-6. With ``plain_events`` the plain version is
    timed by CUDA events (``event_ms``), not the profiler. The row keeps the
    profiler sessions its timing ran again (``profiler_retries``). With ``run`` it
    also times the kernel, its plain version and the library call (if any;
    less ``library_fwd``'s time where that is given, for a backward timed
    as autograd forward + backward) and states the bound from ``n_bytes``,
    ``ops`` of ``ops_dtype`` (default ``dtype``) and ``exps``
    exponentials; a backward row also keeps each kernel's device ms."""
    pieces = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    ok, max_err, held = True, 0.0, []
    for g, w in pieces:
        wf = w.float()
        err = (g.float() - wf).abs()
        if scaled and w.dtype == torch.bfloat16:
            rms = float(wf.square().mean().sqrt())
            ratio = float((err / (BF16_ULP_SHARE * wf.abs() + BF16_RMS_SHARE * rms)).max())
            ok = ok and ratio <= 1.0    # NaN fails
            held.append({"rms_plain": rms, "max_abs_plain": float(wf.abs().max()),
                         "max_abs_err": float(err.max()), "err_over_limit": ratio})
        elif leafwise and w.dtype == torch.float32:
            t = TOL[(tol_key, "float32")]
            ok = ok and bool((err <= t * float(wf.abs().max()) + 1e-6).all())
        else:
            t = TOL[(tol_key, str(w.dtype).split(".")[1])]
            ok = ok and bool((err <= t + t * wf.abs()).all())
        max_err = max(max_err, float(err.max()))
    row = dict(kernel=kernel, case=case, dtype=dtype, max_abs_err=max_err,
               tol=TOL[(tol_key, dtype)], ok=ok)
    if held:
        row.update(tol=SCALED_LIMIT, scaled=held)
    if leafwise:
        leaf = f"{TOL[(tol_key, 'float32')]:g} max|plain| + 1e-6 (float32)"
        row["tol"] = f"{row['tol']} (bf16), {leaf}" if held else leaf
    if run is not None:
        retries = sum(PROFILER_RETRIES.values())
        row["bound_ms"], row["bound_by"], row["bound_terms"] = bound(
            n_bytes, ops, ops_dtype or dtype, exps)
        row["ms"], row["kernels_per_call"], each = device_profile(run)
        if kernel.endswith("_bwd"):
            row["kernel_ms"] = {
                re.sub(r"^void |\(.*$", "", k.replace("(anonymous namespace)::", ""))[:60]: v
                for k, v in each.items()}
        lib_ms = None if library is None else device_ms(library)
        if library_fwd is not None:
            lib_ms -= device_ms(library_fwd)
        row.update(launch_ms=launch_ms(run), library_ms=lib_ms,
                   plain_ms=(event_ms(plain, plain_iters) if plain_events
                             else device_ms(plain, plain_iters)),
                   plain_timer="CUDA events" if plain_events else "profiler")
        row["profiler_retries"] = sum(PROFILER_RETRIES.values()) - retries
    return row


def phase_kernels(rms, fla, dec, scan):
    """Each kernel against its plain version on CUDA tensors, at the shapes
    of smollm-360M (d 960; 15 q / 5 kv heads of 64), Jamba (d 8192; 64 q /
    8 kv heads of 128; d_inner 16384, N 16) and xlstm-125m (d 768, 1536)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        # RMSNorm: prefill rows (8 x 512) and decode rows (8)
        for n, d in ((4096, 960), (8, 960), (4096, 8192), (8, 8192),
                     (4096, 768), (4096, 1536)):
            x, s = randn((n, d), dtype), randn((d,), torch.float32)
            sw = s.to(dtype)
            rows.append(compare(
                "rmsnorm", f"{n}x{d}", dn, rms.rmsnorm_cuda(x, s, 1e-5),
                rms.rmsnorm_plain(x, s, 1e-5), "rmsnorm",
                run=lambda x=x, s=s: rms.rmsnorm_cuda(x, s, 1e-5),
                plain=lambda x=x, s=s: rms.rmsnorm_plain(x, s, 1e-5),
                library=lambda x=x, sw=sw, d=d: F.rms_norm(x, (d,), sw, 1e-5),
                n_bytes=2 * nbytes(x) + nbytes(s), ops=4 * x.numel()))
        # flash attention: prefill causal, window + offset, ragged Sq
        for case, b, hq, hkv, sq, skv, hd, window in (
                ("causal 8x15/5x512x512x64", 8, 15, 5, 512, 512, 64, None),
                ("window256 offset384 8x15/5x128x512x64", 8, 15, 5, 128, 512,
                 64, 256),
                ("ragged 2x15/5x77x77x64", 2, 15, 5, 77, 77, 64, None),
                ("causal 8x64/8x512x512x128", 8, 64, 8, 512, 512, 128, None)):
            q = randn((b, hq, sq, hd), dtype)
            k, v = randn((b, hkv, skv, hd), dtype), randn((b, hkv, skv, hd), dtype)
            off = skv - sq
            pairs = int(fla_mask(sq, skv, window, off).sum())
            library = None
            if window is None:
                # yardstick: SDPA on K/V expanded to the q heads beforehand
                ke, ve = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))
                library = (lambda q=q, ke=ke, ve=ve:
                           F.scaled_dot_product_attention(q, ke, ve, is_causal=True))
            rows.append(compare(
                "flash_attention", case, dn,
                fla.flash_attention_cuda(q, k, v, True, window, off),
                fla.flash_attention_plain(q, k, v, True, window, off), "attn",
                run=lambda q=q, k=k, v=v, w=window, o=off:
                    fla.flash_attention_cuda(q, k, v, True, w, o),
                plain=lambda q=q, k=k, v=v, w=window, o=off:
                    fla.flash_attention_plain(q, k, v, True, w, o),
                library=library, n_bytes=2 * nbytes(q) + 2 * nbytes(k),
                ops=4 * b * hq * hd * pairs))
            rows[-1]["instance"] = fla.INSTANCES[dtype]
            if dtype == torch.bfloat16 and window is None and sq == 512:
                # the forward as training runs it: O and each row's L
                rows.append(compare(
                    "flash_attention", f"{case} with L", dn,
                    fla.flash_attention_cuda(q, k, v, True, None, off, return_lse=True),
                    fla.flash_attention_plain(q, k, v, True, None, off, return_lse=True),
                    "attn_lse",
                    run=lambda q=q, k=k, v=v, o=off:
                        fla.flash_attention_cuda(q, k, v, True, None, o, return_lse=True),
                    plain=lambda q=q, k=k, v=v, o=off:
                        fla.flash_attention_plain(q, k, v, True, None, o, return_lse=True),
                    library=library, n_bytes=2 * nbytes(q) + 2 * nbytes(k) + 4 * q.numel() // hd,
                    ops=4 * b * hq * hd * pairs))
                rows[-1]["instance"] = fla.INSTANCES[dtype]
        # decode attention: the serving cache (64 + 64 + 1 slots), ragged
        # length; and a long context (4096 slots), where the split pays
        for case, hq, hkv, s, hd in (
                ("8x15/5x129x64 ragged length", 15, 5, 129, 64),
                ("8x64/8x129x128 ragged length", 64, 8, 129, 128),
                ("8x15/5x4096x64 ragged length", 15, 5, 4096, 64)):
            q = randn((8, hq, hd), dtype)
            k, v = randn((8, hkv, s, hd), dtype), randn((8, hkv, s, hd), dtype)
            length = torch.randint(1, s + 1, (8,), generator=gen, device="cuda",
                                   dtype=torch.int32)
            valid = int(length.sum())
            mask = (torch.arange(s, device="cuda") < length[:, None])[:, None, None, :]
            ke, ve = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))
            rows.append(compare(
                "decode_attention", case, dn,
                dec.decode_attention_cuda(q, k, v, length),
                dec.decode_attention_plain(q, k, v, length), "attn",
                run=lambda q=q, k=k, v=v, n=length:
                    dec.decode_attention_cuda(q, k, v, n),
                plain=lambda q=q, k=k, v=v, n=length:
                    dec.decode_attention_plain(q, k, v, n),
                library=lambda q=q, ke=ke, ve=ve, m=mask:
                    F.scaled_dot_product_attention(q[:, :, None], ke, ve,
                                                   attn_mask=m),
                n_bytes=(2 * hkv * hd * valid + 2 * q.numel()) * q.element_size(),
                ops=4 * hq * hd * valid))
            if dtype == torch.bfloat16:
                rows[-1].update(split_sweep(dec, q, k, v, length))
        # the selective scan at Jamba's prefill shape: u, B, C in the model
        # dtype, dt float32 (softplus promotes), A and D float32; A both as
        # Mamba initialises it, -(1..N) on every channel, and drawn per (d, n)
        # so that the time is that of the general kernel
        bt, t, d_in, n = 8, 512, 16384, 16
        u = randn((bt, t, d_in), dtype)
        dt = F.softplus(randn((bt, t, d_in), torch.float32))
        Bm, Cm = randn((bt, t, n), dtype), randn((bt, t, n), dtype)
        D = randn((d_in,), torch.float32)
        elems = u.numel()
        y_bytes = nbytes(u) + 4 * bt * d_in * n       # y and h_T
        for a_case, A in (
                ("", -torch.arange(1, n + 1, device="cuda",
                                   dtype=torch.float32).repeat(d_in, 1)),
                (" random A", -torch.exp(randn((d_in, n), torch.float32)))):
            args = (u, dt, A, Bm, Cm, D)
            rows.append(compare(
                "mamba_scan", f"{bt}x{t}x{d_in} N{n} dt f32{a_case}", dn,
                scan.mamba_scan_cuda(*args), scan.mamba_scan_plain(*args), "scan",
                run=lambda args=args: scan.mamba_scan_cuda(*args),
                plain=lambda args=args: scan.mamba_scan_plain(*args), library=None,
                n_bytes=nbytes(*args) + y_bytes, ops=6 * elems * n + 3 * elems,
                exps=elems * n, ops_dtype="float32", plain_iters=3))
            rows[-1]["sm_clock_mhz"] = sm_clock_mhz(
                lambda args=args: scan.mamba_scan_cuda(*args))
        # with an initial state (and the random A), checked for agreement only
        h0 = randn((bt, d_in, n), torch.float32)
        rows.append(compare(
            "mamba_scan", f"h0 {bt}x{t}x{d_in} N{n} dt f32 random A check", dn,
            scan.mamba_scan_cuda(*args, h0), scan.mamba_scan_plain(*args, h0),
            "scan"))
    # decode with a sliding window that crosses the splits (of 33 keys at
    # S 129, of 512 at S 4096), checked for agreement only
    for s, window in ((129, 32), (4096, 600)):
        q = randn((8, 15, 64), torch.float32)
        k, v = randn((8, 5, s, 64), torch.float32), randn((8, 5, s, 64), torch.float32)
        length = torch.randint(1, s + 1, (8,), generator=gen, device="cuda",
                               dtype=torch.int32)
        rows.append(compare(
            "decode_attention", f"window{window} 8x15/5x{s}x64 check", "float32",
            dec.decode_attention_cuda(q, k, v, length, window=window),
            dec.decode_attention_plain(q, k, v, length, window=window), "attn"))
    rows += scan_train_rows(scan, randn)
    rows += smoke_head_dim_rows(fla, dec, randn, gen)
    rows += mla_rows(fla, randn)
    rows += backward_rows(rms, fla, randn)
    rows += mla_backward_rows(fla, randn)
    rows += frontend_rows(fla, dec, randn)
    rows += optimizer_rows(gen)
    return rows


def scan_train_rows(scan, randn):
    """The scan's training forward (the state every ``STATE_EVERY`` steps
    besides y and h_T) and its backward against their plain versions on the
    card: bf16 at Jamba's training shape (8 x 512 x 16384, N 16), the
    backward with Mamba's initial A and with a random A, B and C column
    slices of an x_proj output as the model passes them and no dh_T (the
    model drops h_T); float32 at a ragged SMOKE shape (N 4) with h0 and
    dh_T. The backward's bound counts u, dt and dy read and du and ddt
    written (and the small tensors), not the saved states it reads nor its
    partial sums. Each backward row also checks that two calls give the
    same bits."""
    rows = []
    for dtype, (bt, t, d_in, n, r), with_h in (
            (torch.bfloat16, (8, 512, 16384, 16, 512), False),
            (torch.float32, (2, 77, 200, 4, 4), True)):
        dn = str(dtype).split(".")[1]
        u = randn((bt, t, d_in), dtype)
        dt = F.softplus(randn((bt, t, d_in), torch.float32))
        proj = randn((bt, t, r + 2 * n), dtype)
        Bm, Cm = proj[..., r:r + n], proj[..., r + n:]
        D = randn((d_in,), torch.float32)
        h0 = randn((bt, d_in, n), torch.float32) if with_h else None
        dy = randn((bt, t, d_in), dtype)
        dh = randn((bt, d_in, n), torch.float32) if with_h else None
        extra = (h0, dh) if with_h else ()
        elems = u.numel()
        a_cases = [(" random A", -torch.exp(randn((d_in, n), torch.float32)))]
        if dtype == torch.bfloat16:
            a_cases.insert(0, ("", -torch.arange(1, n + 1, device="cuda",
                                                dtype=torch.float32).repeat(d_in, 1)))
        for a_case, A in a_cases:
            args = (u, dt, A, Bm, Cm, D, h0)
            case = f"{bt}x{t}x{d_in} N{n} dt f32{a_case}" + (" h0 dh_T" if with_h else "")
            if a_case == " random A":
                rows.append(compare(
                    "mamba_scan_train", f"{case}, states every {scan.STATE_EVERY}", dn,
                    scan.mamba_scan_train_cuda(*args), scan.mamba_scan_states_plain(*args),
                    "scan", run=lambda args=args: scan.mamba_scan_train_cuda(*args),
                    plain=lambda args=args: scan.mamba_scan_states_plain(*args),
                    library=None, n_bytes=nbytes(u, dt, A, Bm, Cm, D, u, *extra[:1])
                    + 4 * bt * d_in * n * (1 + scan.n_states(t)),
                    ops=6 * elems * n + 3 * elems, exps=elems * n, ops_dtype="float32",
                    plain_iters=3))
            _, _, hs = scan.mamba_scan_train_cuda(*args)
            bargs = (u, dt, A, Bm, Cm, D, hs, dy, dh)
            got = scan.mamba_scan_bwd_cuda(*bargs)
            again = scan.mamba_scan_bwd_cuda(*bargs)
            torch.cuda.synchronize()
            bit_equal = all(torch.equal(a, b) for a, b in zip(got, again))
            del again
            pargs = (u, dt, A, Bm, Cm, D, dy, h0, dh)
            row = compare(
                "mamba_scan_bwd", case, dn, got, scan.mamba_scan_bwd_plain(*pargs),
                "scan_bwd", run=lambda bargs=bargs: scan.mamba_scan_bwd_cuda(*bargs),
                plain=lambda pargs=pargs: scan.mamba_scan_bwd_plain(*pargs), library=None,
                n_bytes=nbytes(u, dt, dy, A, Bm, Cm, D, *extra, *got),
                ops=10 * elems * n, exps=elems * n, ops_dtype="float32", plain_iters=3,
                scaled=True, leafwise=True, plain_events=True)
            row.update(bit_equal=bit_equal, ok=row["ok"] and bit_equal,
                       saved_state_bytes=nbytes(hs),
                       sm_clock_mhz=sm_clock_mhz(lambda bargs=bargs:
                                                 scan.mamba_scan_bwd_cuda(*bargs)))
            rows.append(row)
            del got, hs
    return rows


def frontend_rows(fla, dec, randn):
    """The attention shapes of whisper-small and llava-next-mistral-7b, bf16
    timed (SDPA as the yardstick) and float32 checked: flash attention not
    causal at G 1, D 64 over 1,500 keys (the encoder; cross attention from
    448 and 64 queries), its backward with the forward's L (encoder, cross
    attention from 448 queries; SDPA's backward as in ``backward_rows``),
    decode attention at G 1 over 1,500 cross slots with no length, the bf16
    forward at D 128, G 4, causal over llava's 2,944-position prefill and
    its backward with L over the 3,072 positions of llava's training (bf16
    only; their plain versions a batch element at a time, ``per_batch``).
    Whisper's bf16 rows are held to SCALED_LIMIT (``compare``)."""
    rows = []
    d = 64
    for case, b, h, sq, skv in ((WHISPER_ENC_CASE, 8, 12, 1500, 1500),
                                (WHISPER_CROSS_CASE, 8, 12, 448, 1500),
                                (WHISPER_CROSS_PREFILL_CASE, 8, 12, 64, 1500)):
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            q, do = randn((b, h, sq, d), dtype), randn((b, h, sq, d), dtype)
            k, v = randn((b, h, skv, d), dtype), randn((b, h, skv, d), dtype)
            args = (q, k, v, False, None, 0)
            timed = {} if dtype == torch.float32 else dict(
                run=lambda a=args: fla.flash_attention_cuda(*a),
                plain=lambda a=args: fla.flash_attention_plain(*a),
                library=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(q, k, v),
                n_bytes=2 * nbytes(q) + 2 * nbytes(k), ops=4 * b * h * d * sq * skv,
                plain_iters=5)
            rows.append(compare("flash_attention", case, dn, fla.flash_attention_cuda(*args),
                                fla.flash_attention_plain(*args), "attn", scaled=True,
                                **timed))
            rows[-1]["instance"] = fla.INSTANCES[dtype]
            if case == WHISPER_CROSS_PREFILL_CASE:
                continue
            lse = None
            if dtype == torch.bfloat16:
                o, lse = fla.flash_attention_cuda(*args, return_lse=True)
            else:
                o = fla.flash_attention_cuda(*args)
            bargs = (q, k, v, o, do, False, None, 0)
            ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))

            def lib_f(ql=ql, kl=kl, vl=vl):
                return F.scaled_dot_product_attention(ql, kl, vl)

            timed = {} if dtype == torch.float32 else dict(
                run=lambda a=bargs, l=lse: fla.flash_attention_bwd_cuda(*a, lse=l),
                plain=lambda a=bargs: fla.flash_attention_bwd_plain(*a),
                library=lambda f=lib_f, ins=(ql, kl, vl), do=do:
                    torch.autograd.grad(f(), ins, do),
                library_fwd=lib_f, n_bytes=4 * nbytes(q) + 4 * nbytes(k),
                ops=10 * b * h * d * sq * skv, plain_iters=5)
            rows.append(compare(
                "flash_attention_bwd", case + (" with L" if lse is not None else ""), dn,
                fla.flash_attention_bwd_cuda(*bargs, lse=lse),
                fla.flash_attention_bwd_plain(*bargs), "attn_bwd", scaled=True, **timed))
            rows[-1]["instance"] = fla.INSTANCES[dtype]
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        q = randn((8, 12, d), dtype)
        k, v = randn((8, 12, 1500, d), dtype), randn((8, 12, 1500, d), dtype)
        timed = {} if dtype == torch.float32 else dict(
            run=lambda: dec.decode_attention_cuda(q, k, v),
            plain=lambda: dec.decode_attention_plain(q, k, v),
            library=lambda: F.scaled_dot_product_attention(q[:, :, None], k, v),
            n_bytes=nbytes(k, v) + 2 * nbytes(q), ops=4 * 12 * d * 1500 * 8)
        rows.append(compare("decode_attention", WHISPER_DECODE_CASE, dn,
                            dec.decode_attention_cuda(q, k, v),
                            dec.decode_attention_plain(q, k, v), "attn", scaled=True,
                            **timed))
        if dtype == torch.bfloat16:
            rows[-1].update(split_sweep(dec, q, k, v, None))
    b, hq, hkv, hd = 8, 32, 8, 128
    plain = per_batch(fla.flash_attention_plain, 3)
    plain_bwd = per_batch(fla.flash_attention_bwd_plain, 5)
    for case, s in ((LLAVA_CASE, 2944), (LLAVA_BWD_CASE, 3072)):
        q, do = randn((b, hq, s, hd), torch.bfloat16), randn((b, hq, s, hd), torch.bfloat16)
        k, v = randn((b, hkv, s, hd), torch.bfloat16), randn((b, hkv, s, hd), torch.bfloat16)
        args = (q, k, v, True, None, 0)
        pairs = s * (s + 1) // 2
        if case == LLAVA_CASE:
            ke, ve = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))
            rows.append(compare(
                "flash_attention", case, "bfloat16", fla.flash_attention_cuda(*args),
                plain(*args), "attn", run=lambda a=args: fla.flash_attention_cuda(*a),
                plain=lambda a=args: plain(*a),
                library=lambda q=q, ke=ke, ve=ve: F.scaled_dot_product_attention(
                    q, ke, ve, is_causal=True),
                n_bytes=2 * nbytes(q) + 2 * nbytes(k), ops=4 * b * hq * hd * pairs,
                plain_iters=3))
            del ke, ve
        else:
            o, lse = fla.flash_attention_cuda(*args, return_lse=True)
            bargs = (q, k, v, o, do, True, None, 0)
            ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))

            def lib_f(ql=ql, kl=kl, vl=vl):
                return F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                                      enable_gqa=True)

            rows.append(compare(
                "flash_attention_bwd", case, "bfloat16",
                fla.flash_attention_bwd_cuda(*bargs, lse=lse), plain_bwd(*bargs),
                "attn_bwd", run=lambda a=bargs, l=lse: fla.flash_attention_bwd_cuda(*a, lse=l),
                plain=lambda a=bargs: plain_bwd(*a),
                library=lambda f=lib_f, ins=(ql, kl, vl), do=do:
                    torch.autograd.grad(f(), ins, do),
                library_fwd=lib_f, n_bytes=4 * nbytes(q) + 4 * nbytes(k),
                ops=10 * b * hq * hd * pairs, plain_iters=3))
            del ql, kl, vl, o, lse
        rows[-1]["instance"] = fla.INSTANCES[torch.bfloat16]
        del q, k, v, do
        torch.cuda.empty_cache()
    return rows


def per_batch(fn, n_tensors: int):
    """``fn`` over one batch element at a time (its first ``n_tensors``
    arguments sliced, the rest passed whole), the results concatenated along
    the batch dim: a plain version at a shape whose float32 logits would not
    fit the card at once (llava's 8 x 32 x 2,944^2 would be 8.9 GB a copy)."""
    def run(*args):
        outs = [fn(*(a[i:i + 1] for a in args[:n_tensors]), *args[n_tensors:])
                for i in range(args[0].shape[0])]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(parts) for parts in zip(*outs))
        return torch.cat(outs)
    return run


def leaf_ms(calls, iters: int = 21) -> float:
    """Device ms of ``calls`` run one after another: each timed alone
    (``device_ms``) and summed, so that leaves of other sizes in one kernel's
    name do not share a median."""
    return sum(device_ms(c, iters) for c in calls)


def optimizer_rows(gen):
    """The clip's and AdamW's kernels against their plain versions over
    smollm-360M's 11 leaves (params and gradients drawn on the card, bf16,
    then float32 copies; m and v float32, v positive; the scalars of step 3
    of lr 1e-3 and a clip scale that bites): ``sumsq`` (each leaf's partial
    sums against its float32 sum of squares), ``clip_finalize`` (norm and
    scale from all the partials) and ``adamw_update`` (params to TOL, m and
    v to ADAMW_MV_TOL relative). Each leaf's kernel and plain version are
    timed alone and summed. Library yardsticks, never on the path:
    ``torch._foreach_norm`` over the gradients, and
    ``torch.optim.AdamW(fused=True).step()`` over float32 copies (its
    moments take the params' dtype, so bf16 params would have bf16
    moments: not the same function)."""
    from repro_torch.configs import get
    from repro_torch.kernels import _build
    from repro_torch.kernels import adamw as ka
    from repro_torch.models import transformer
    from repro_torch.models.module import tree_leaves

    rows = []
    case = KERNELS["adamw_update"][2]
    base = tree_leaves(transformer.init(gen, get("smollm_360m"), device="cuda"))
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device="cuda")
    lr, c1, c2 = f32(1e-3), f32(1 - 0.9 ** 3), f32(1 - 0.95 ** 3)
    n_sm = _build.sm_count(torch.cuda.current_device())
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        params = [t.to(dtype) for t in base]
        grads = [(torch.randn(t.shape, generator=gen, device="cuda") * 1e-3).to(dtype)
                 for t in params]
        # sumsq over each leaf into one workspace, then clip_finalize
        blocks = [ka.sumsq_blocks(g.numel(), g.dtype, n_sm) for g in grads]
        partial = torch.empty(sum(blocks), dtype=torch.float32, device="cuda")
        pieces = torch.split(partial, blocks)
        sums = [(g, piece) for g, piece in zip(grads, pieces)]
        for g, piece in sums:
            ka.sumsq_cuda(g, piece)
        got = tuple(piece.sum() for piece in pieces)
        want = tuple(ka.sumsq_plain(g) for g in grads)
        row = compare("sumsq", case, dn, got, want, "sumsq")
        row.update(_opt_timing(
            [lambda a=a: ka.sumsq_cuda(*a) for a in sums],
            [lambda g=g: ka.sumsq_plain(g) for g in grads],
            lambda: torch._foreach_norm(grads), nbytes(*grads) + nbytes(partial),
            2 * sum(g.numel() for g in grads)))
        rows.append(row)
        norm, scale = ka.clip_finalize_cuda(partial, 1.0)
        row = compare("clip_finalize", case, dn, (norm, scale),
                      ka.clip_finalize_plain(partial, 1.0), "sumsq")
        row.update(_opt_timing([lambda: ka.clip_finalize_cuda(partial, 1.0)],
                               [lambda: ka.clip_finalize_plain(partial, 1.0)], None,
                               nbytes(partial) + 8, partial.numel()))
        row["scale"] = float(scale)
        rows.append(row)
        # the update: the kernel and the plain version from the same state
        m = [torch.randn(t.shape, generator=gen, device="cuda") * 1e-4 for t in params]
        v = [torch.rand(t.shape, generator=gen, device="cuda") * 1e-6 for t in params]
        states = {k: ([t.clone() for t in params], [t.clone() for t in m],
                      [t.clone() for t in v]) for k in ("kernel", "plain")}
        for k, fn in (("kernel", ka.adamw_update_cuda), ("plain", ka.adamw_update_plain)):
            for leaf in zip(*states[k][:1], grads, *states[k][1:]):
                fn(*leaf, lr, c1, c2, scale)
        (pk, mk, vk), (pp, mp, vp) = states["kernel"], states["plain"]
        row = compare("adamw_update", case, dn, tuple(pk), tuple(pp), "adamw")
        mv_err = max(float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
                     for a, b in zip(mk + vk, mp + vp))
        ok = mv_err <= ADAMW_MV_TOL
        if dtype == torch.bfloat16:     # params within one bf16 ulp
            row["p_max_ulps"] = max(float(((a.float() - b.float()).abs() / bf16_ulp(b)).max())
                                    for a, b in zip(pk, pp))
            ok = ok and row["p_max_ulps"] <= 1
        else:
            ok = ok and row["ok"]
        row.update(mv_rel_err=mv_err, ok=ok,
                   bit_equal_share=sum(int((a == b).sum()) for a, b in zip(pk, pp))
                   / sum(t.numel() for t in pk))
        leaves = list(zip(pk, grads, mk, vk))
        lib_p = [t.detach().float().clone().requires_grad_(True) for t in params]
        for t, g in zip(lib_p, grads):
            t.grad = g.float()
        lib = torch.optim.AdamW(lib_p, lr=1e-3, betas=(0.9, 0.95), eps=1e-8,
                                weight_decay=0.1, fused=True)
        row.update(_opt_timing(
            [lambda a=a: ka.adamw_update_cuda(*a, lr, c1, c2, scale) for a in leaves],
            [lambda a=a: ka.adamw_update_plain(*a, lr, c1, c2, scale)
             for a in zip(pp, grads, mp, vp)],
            lib.step,
            # p read and written, g read, m and v read and written
            sum(2 * t.numel() * t.element_size() + g.numel() * g.element_size() + 16 * t.numel()
                for t, g in zip(params, grads)),
            20 * sum(t.numel() for t in params)))
        row["library"] = "torch.optim.AdamW(fused=True) on float32 copies"
        rows.append(row)
        del params, grads, m, v, states, leaves, lib_p, lib, partial, pieces, sums
        torch.cuda.empty_cache()
    return rows


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at each element of ``t`` (7 stored
    mantissa bits), as float32."""
    e = torch.floor(torch.log2(t.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _opt_timing(runs, plains, library, n_bytes, ops) -> dict:
    """The timing keys of a phase-2 row for the optimizer's kernels: each
    leaf's kernel call and plain version timed alone and summed
    (``leaf_ms``), the kernels one pass over the leaves runs, its
    back-to-back time, the bound (float32 operations) and the library
    call's device ms."""
    every = lambda fns: (lambda: [f() for f in fns])
    out = {"kernels_per_call": device_profile(every(runs))[1], "ms": leaf_ms(runs),
           "launch_ms": launch_ms(every(runs)), "plain_ms": leaf_ms(plains, 5),
           "library_ms": None if library is None else device_ms(library)}
    out["bound_ms"], out["bound_by"], out["bound_terms"] = bound(n_bytes, ops, "float32")
    return out


# the SMOKE configs' attention shapes (head dims 16 and 20): smollm (3 q / 1
# kv heads of 20), h2o-danube (4 / 2 of 16, window 16), and both with a
# window, an offset and ragged lengths
SMOKE_ATTN = (
    ("smollm SMOKE causal 2x3/1x32x32x20", 2, 3, 1, 32, 32, 20, None),
    ("danube SMOKE window16 2x4/2x32x32x16", 2, 4, 2, 32, 32, 16, 16),
    ("window24 offset30 ragged 2x3/1x70x100x20", 2, 3, 1, 70, 100, 20, 24),
    ("window16 offset45 ragged 2x4/2x83x128x16", 2, 4, 2, 83, 128, 16, 16))


def smoke_head_dim_rows(fla, dec, randn, gen):
    """Forward rows of the SMOKE head dims: flash attention (float32 16 and
    20, bf16 16) and decode attention over a ragged cache (the same), timed
    like the main paths' rows."""
    rows = []
    for case, b, hq, hkv, sq, skv, hd, window in SMOKE_ATTN:
        for dtype in (torch.float32, torch.bfloat16):
            if dtype == torch.bfloat16 and hd == 20:
                continue        # bf16 rows of 20 are 40 bytes: no instance
            q = randn((b, hq, sq, hd), dtype)
            k, v = randn((b, hkv, skv, hd), dtype), randn((b, hkv, skv, hd), dtype)
            off = skv - sq
            pairs = int(fla_mask(sq, skv, window, off).sum())
            args = (q, k, v, True, window, off)
            rows.append(compare(
                "flash_attention", case, str(dtype).split(".")[1],
                fla.flash_attention_cuda(*args), fla.flash_attention_plain(*args),
                "attn", run=lambda args=args: fla.flash_attention_cuda(*args),
                plain=lambda args=args: fla.flash_attention_plain(*args),
                n_bytes=2 * nbytes(q) + 2 * nbytes(k), ops=4 * b * hq * hd * pairs))
            rows[-1]["instance"] = fla.INSTANCES[dtype]
    for case, hq, hkv, s, hd in (("smollm SMOKE 8x3/1x48x20 ragged length", 3, 1, 48, 20),
                                 ("danube SMOKE 8x4/2x16x16 ragged length", 4, 2, 16, 16)):
        for dtype in (torch.float32, torch.bfloat16):
            if dtype == torch.bfloat16 and hd == 20:
                continue
            q = randn((8, hq, hd), dtype)
            k, v = randn((8, hkv, s, hd), dtype), randn((8, hkv, s, hd), dtype)
            length = torch.randint(1, s + 1, (8,), generator=gen, device="cuda",
                                   dtype=torch.int32)
            valid = int(length.sum())
            rows.append(compare(
                "decode_attention", case, str(dtype).split(".")[1],
                dec.decode_attention_cuda(q, k, v, length),
                dec.decode_attention_plain(q, k, v, length), "attn",
                run=lambda q=q, k=k, v=v, n=length: dec.decode_attention_cuda(q, k, v, n),
                plain=lambda q=q, k=k, v=v, n=length: dec.decode_attention_plain(q, k, v, n),
                n_bytes=(2 * hkv * hd * valid + 2 * q.numel()) * q.element_size(),
                ops=4 * hq * hd * valid))
    return rows


def mla_rows(fla, randn):
    """The flash instances of MLA's head dims (qk 128 + 64 = 192 at
    DeepSeek-V3's widths, 16 + 8 = 24 at SMOKE size; G = 1, causal, scale
    D^-0.5): bf16 at the DeepSeek prefill's shape, without and with L, on
    contiguous (B, H, S, D) tensors and in the model's layout (``mla_apply``
    passes (B, H, S, D) views of (B, S, H, 192) q and k and of V padded from
    128), and float32 at 192 and 24; SDPA (``scale`` given) as the
    yardstick. The bf16 D-192 rows carry PR 20's time as a label."""
    rows = []
    for (name, (_, _, case, dn, _)), (b, h, s, d) in zip(
            MLA_ROWS.items(), ((8, 128, 512, 192), (2, 16, 512, 192), (8, 4, 512, 24))):
        dtype = getattr(torch, dn)
        layouts = [(case, [randn((b, h, s, d), dtype) for _ in range(3)])]
        if dn == "bfloat16":
            v = F.pad(randn((b, s, h, 128), dtype), (0, d - 128))
            layouts.append((MLA_MODEL_CASE, [randn((b, s, h, d), dtype).transpose(1, 2),
                                             randn((b, s, h, d), dtype).transpose(1, 2),
                                             v.transpose(1, 2)]))
        scale = d ** -0.5
        pairs = s * (s + 1) // 2
        for lcase, (q, k, v) in layouts:
            library = (lambda q=q, k=k, v=v, sc=scale:
                       F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=sc))
            for lse in ((False, True) if dn == "bfloat16" else (False,)):
                args = (q, k, v, True, None, 0, scale)
                rows.append(compare(
                    "flash_attention", lcase + (" with L" if lse else ""), dn,
                    fla.flash_attention_cuda(*args, return_lse=lse),
                    fla.flash_attention_plain(*args, return_lse=lse),
                    "attn_lse" if lse else "attn",
                    run=lambda a=args, l=lse: fla.flash_attention_cuda(*a, return_lse=l),
                    plain=lambda a=args, l=lse: fla.flash_attention_plain(*a, return_lse=l),
                    library=library,
                    n_bytes=4 * nbytes(q) + (4 * b * h * s if lse else 0),
                    ops=4 * b * h * d * pairs, plain_iters=5))
                rows[-1]["instance"] = fla.INSTANCES[dtype]
                if dn == "bfloat16":
                    rows[-1]["label"] = f"PR 20 (contiguous): {MLA_PARENT_MS} ms"
    return rows


def backward_rows(rms, fla, randn):
    """The backward kernels against their plain versions: flash attention at
    smollm-360M's training shape (bf16 and float32), at Jamba's attention
    shape (bf16, head dim 128) and at the SMOKE shapes (float32), RMSNorm
    over rows of 960, 768 and 1536. The bf16 flash rows pass the forward's
    L, as training does (``instance`` names the kernel that ran). The library
    yardstick is autograd's forward + backward of one PyTorch call
    (``scaled_dot_product_attention`` with ``enable_gqa``, and a boolean
    mask where a window or an offset applies; ``F.rms_norm``) less its
    forward."""
    rows = []
    main = (KERNELS["flash_attention_bwd"][2], 8, 15, 5, 512, 512, 64, None)
    jamba = ("causal 8x64/8x512x512x128", 8, 64, 8, 512, 512, 128, None)
    for dtype, cases in ((torch.bfloat16, (main, jamba)),
                         (torch.float32, (main,) + SMOKE_ATTN)):
        dn = str(dtype).split(".")[1]
        for case, b, hq, hkv, sq, skv, hd, window in cases:
            q, do = randn((b, hq, sq, hd), dtype), randn((b, hq, sq, hd), dtype)
            k, v = randn((b, hkv, skv, hd), dtype), randn((b, hkv, skv, hd), dtype)
            off = skv - sq
            lse = None
            if dtype == torch.bfloat16:
                o, lse = fla.flash_attention_cuda(q, k, v, True, window, off,
                                                  return_lse=True)
            else:
                o = fla.flash_attention_cuda(q, k, v, True, window, off)
            mask = fla_mask(sq, skv, window, off)
            pairs = int(mask.sum())
            args = (q, k, v, o, do, True, window, off)
            ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
            lib_mask = None if window is None and off == 0 else mask.cuda()

            def lib_f(ql=ql, kl=kl, vl=vl, m=lib_mask):
                return F.scaled_dot_product_attention(
                    ql, kl, vl, attn_mask=m, is_causal=m is None, enable_gqa=True)

            rows.append(compare(
                "flash_attention_bwd", case, dn,
                fla.flash_attention_bwd_cuda(*args, lse=lse),
                fla.flash_attention_bwd_plain(*args), "attn_bwd",
                run=lambda args=args, lse=lse: fla.flash_attention_bwd_cuda(*args, lse=lse),
                plain=lambda args=args: fla.flash_attention_bwd_plain(*args),
                library=lambda f=lib_f, ins=(ql, kl, vl), do=do:
                    torch.autograd.grad(f(), ins, do),
                library_fwd=lib_f,
                # q, o, dO, dq and k, v, dk, dv once each; five products of
                # 2 D operations per (query, key) pair the mask keeps: S
                # again, dP, dV, dQ, dK (the bf16 kernel runs seven: S and
                # dP in each launch)
                n_bytes=4 * nbytes(q) + 4 * nbytes(k), ops=10 * b * hq * hd * pairs))
            rows[-1]["instance"] = fla.INSTANCES[dtype]
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        for n, d in ((4096, 960), (4096, 768), (4096, 1536)):
            x, dy = randn((n, d), dtype), randn((n, d), dtype)
            s = randn((d,), torch.float32)
            dx, ds = rms.rmsnorm_bwd_cuda(x, s, dy, 1e-5)
            dx_p, ds_p = rms.rmsnorm_bwd_plain(x, s, dy, 1e-5)
            xl = x.clone().requires_grad_(True)
            sl = s.to(dtype).clone().requires_grad_(True)

            def lib_f(xl=xl, sl=sl, d=d):
                return F.rms_norm(xl, (d,), sl, 1e-5)

            row = compare(
                "rmsnorm_bwd", f"{n}x{d}", dn, dx, dx_p, "rmsnorm_bwd",
                run=lambda a=(x, s, dy): rms.rmsnorm_bwd_cuda(*a, 1e-5),
                plain=lambda a=(x, s, dy): rms.rmsnorm_bwd_plain(*a, 1e-5),
                library=lambda f=lib_f, ins=(xl, sl), dy=dy:
                    torch.autograd.grad(f(), ins, dy),
                library_fwd=lib_f,
                # x and dy read, dx written, scale read and dscale written
                n_bytes=3 * nbytes(x) + 2 * nbytes(s), ops=8 * x.numel())
            row["dscale_rel_err"] = rel = float((ds - ds_p).norm() / ds_p.norm())
            row["ok"] = row["ok"] and rel <= DSCALE_TOL
            rows.append(row)
    return rows


def mla_backward_rows(fla, randn):
    """The flash backward at MLA's head dims against its plain version (G =
    1, causal, scale 192^-0.5): bf16 at DeepSeek-V3's training shape with
    the forward's L, on contiguous tensors and in the model's layout ((B,
    H, S, D) views of (B, S, H, 192) q, k, dO and of V padded from 128), and
    float32 at 192 and 24; SDPA's backward (``scale`` given) as the
    yardstick: autograd forward + backward less the forward."""
    rows = []
    for (name, (_, _, case, dn, _)), (b, h, s, d) in zip(
            MLA_BWD_ROWS.items(), ((8, 128, 512, 192), (2, 16, 512, 192), (8, 4, 512, 24))):
        dtype = getattr(torch, dn)
        layouts = [(case, [randn((b, h, s, d), dtype) for _ in range(4)])]
        if dn == "bfloat16":
            v = F.pad(randn((b, s, h, 128), dtype), (0, d - 128))
            layouts.append((MLA_BWD_MODEL_CASE, [
                randn((b, s, h, d), dtype).transpose(1, 2),
                randn((b, s, h, d), dtype).transpose(1, 2), v.transpose(1, 2),
                randn((b, s, h, d), dtype).transpose(1, 2)]))
        scale = d ** -0.5
        pairs = s * (s + 1) // 2
        for lcase, (q, k, v, do) in layouts:
            lse = None
            if dn == "bfloat16":
                o, lse = fla.flash_attention_cuda(q, k, v, True, None, 0, scale,
                                                  return_lse=True)
            else:
                o = fla.flash_attention_cuda(q, k, v, True, None, 0, scale)
            args = (q, k, v, o, do, True, None, 0, scale)
            ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))

            def lib_f(ql=ql, kl=kl, vl=vl, sc=scale):
                return F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, scale=sc)

            rows.append(compare(
                "flash_attention_bwd", lcase, dn,
                fla.flash_attention_bwd_cuda(*args, lse=lse),
                fla.flash_attention_bwd_plain(*args), "attn_bwd",
                run=lambda a=args, l=lse: fla.flash_attention_bwd_cuda(*a, lse=l),
                plain=lambda a=args: fla.flash_attention_bwd_plain(*a),
                library=lambda f=lib_f, ins=(ql, kl, vl), do=do:
                    torch.autograd.grad(f(), ins, do),
                library_fwd=lib_f,
                # q, k, v, o, dO, dq, dk, dv once each (L is 0.2% beside them);
                # five products of 2 D operations per (query, key) pair
                n_bytes=8 * nbytes(q), ops=10 * b * h * d * pairs, plain_iters=5))
            rows[-1]["instance"] = fla.INSTANCES[dtype]
    return rows


def split_sweep(dec, q, k, v, length, counts=(1, 2, 3, 4, 8)) -> dict:
    """Device ms of one decode-attention call with the cache cut into each
    of ``counts`` splits (``dec.split_plan`` replaced for the sweep), beside
    the plan's own choice."""
    b, hq, _ = q.shape
    _, hkv, s, _ = k.shape
    plan = dec.split_plan
    sweep = {}
    try:
        for n in counts:
            chunk = -(-s // n)
            if (n - 1) * chunk >= s:
                continue
            dec.split_plan = lambda *_, n=n, chunk=chunk: (n, chunk)
            sweep[n] = device_ms(lambda: dec.decode_attention_cuda(q, k, v, length))
    finally:
        dec.split_plan = plan
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    return {"split_plan": plan(b, hkv, hq // hkv, s, n_sm), "split_sweep_ms": sweep}


def fla_mask(sq, skv, window, offset):
    from repro_torch.kernels.ref import _mask
    return _mask(sq, skv, True, window, offset)


def per_pass(cfg) -> dict:
    """Kernel launches per forward (``rmsnorm``, ``flash``, ``mamba``) or
    decode step (``rmsnorm_step``, ``attn``) of ``cfg``. A decoder-only
    model: RMSNorm once per block (twice with an FFN, once more inside
    mLSTM, twice more in MLA: its q and kv norms) plus the final norm, in
    either; one flash-attention kernel per attention or MLA layer in a
    forward, one decode-attention kernel per attention layer in a decode
    step (MLA decodes by einsums); one scan per Mamba layer (prefill only).
    An encoder-decoder's forward: two norms per encoder layer and
    ``enc_norm``, three per decoder layer (self, cross, MLP) and the final
    norm; one flash kernel per encoder layer and two per decoder layer (self
    and cross attention). Its decode step: the decoder's norms, and two
    decode-attention kernels per layer (self cache and cross K/V)."""
    if cfg.is_encdec:
        return {"rmsnorm": 2 * cfg.encoder_layers + 1 + 3 * cfg.n_layers + 1,
                "rmsnorm_step": 3 * cfg.n_layers + 1, "attn": 2 * cfg.n_layers,
                "flash": cfg.encoder_layers + 2 * cfg.n_layers, "mamba": 0}
    blocks = cfg.blocks()
    norms = 1 + sum(1 + (ffn is not None) + (mixer == "mlstm") + 2 * (mixer == "mla")
                    for mixer, ffn in blocks)
    return {"rmsnorm": norms, "rmsnorm_step": norms,
            "attn": sum(mixer == "attn" for mixer, _ in blocks),
            "flash": sum(mixer in ("attn", "mla") for mixer, _ in blocks),
            "mamba": sum(mixer == "mamba" for mixer, _ in blocks)}


def per_train_step(cfg) -> dict:
    """Kernel launches per train step of ``cfg`` (attention, MLA, Mamba,
    dense and MoE blocks): with ``cfg.remat`` every
    period's forward runs twice (once in the forward pass, once again in
    the backward pass), the dense prefix, the final norm and the MTP module
    (its two input norms, its block and its final norm) once; each norm,
    attention and Mamba layer runs its backward once (a Mamba layer's
    forward is the scan's training instance, ``mamba_scan_train``); the clip one ``sumsq`` per
    leaf of the param tree and one ``clip_finalize``, AdamW one
    ``adamw_update`` per leaf. An encoder-decoder checkpoints each encoder
    and decoder layer (2 and 3 norms, 1 and 2 flash calls) and runs
    ``enc_norm`` and the final norm once."""
    from repro_torch.models import model_api, transformer
    from repro_torch.models.module import tree_leaves

    leaves = len(tree_leaves(model_api(cfg).init(torch.Generator(), cfg, device="meta")))
    opt = {"sumsq": leaves, "clip_finalize": 1, "adamw_update": leaves}
    if cfg.is_encdec:
        twice = 2 if cfg.remat else 1
        layer_norms = 2 * cfg.encoder_layers + 3 * cfg.n_layers
        layer_flash = cfg.encoder_layers + 2 * cfg.n_layers
        return {"rmsnorm": twice * layer_norms + 2, "rmsnorm_bwd": layer_norms + 2,
                "flash_attention": twice * layer_flash,
                "flash_attention_bwd": layer_flash, **opt}

    def norms(spec):
        mixer, ffn = spec
        return 1 + (ffn is not None) + (mixer == "mlstm") + 2 * (mixer == "mla")

    def attn(spec):
        return int(spec[0] in ("attn", "mla"))

    def mamba(spec):
        return int(spec[0] == "mamba")

    prefix = [transformer._prefix_spec(cfg)] * cfg.first_k_dense
    stack = list(cfg.period) * cfg.n_periods
    once = prefix + ([cfg.period[0]] if cfg.mtp else [])
    twice = 2 if cfg.remat else 1
    fwd_norms = (sum(map(norms, once)) + twice * sum(map(norms, stack)) + 1
                 + 3 * cfg.mtp)
    bwd_norms = sum(map(norms, once + stack)) + 1 + 3 * cfg.mtp
    return {"rmsnorm": fwd_norms, "rmsnorm_bwd": bwd_norms,
            "flash_attention": sum(map(attn, once)) + twice * sum(map(attn, stack)),
            "flash_attention_bwd": sum(map(attn, once + stack)),
            "mamba_scan_train": sum(map(mamba, once)) + twice * sum(map(mamba, stack)),
            "mamba_scan_bwd": sum(map(mamba, once + stack)), **opt}


# each wrapper's kernels in a profiler trace: (name pattern, kernels a call)
KERNEL_EVENTS = {"rmsnorm": (r"rmsnorm_(warp|block|scalar)_kernel", 1),
                 "flash_attention": (r"flash_attention_(wgmma|kernel)", 1),
                 "decode_attention": (r"decode_attention_kernel", 1),
                 # the serving and training instances: mamba_scan_kernel<T, NM,
                 # false> and <T, NM, true>
                 "mamba_scan": (r"mamba_scan_kernel<[^>]*(false|\(bool\)0)>", 1),
                 "mamba_scan_train": (r"mamba_scan_kernel<[^>]*(true|\(bool\)1)>", 1),
                 "mamba_scan_bwd": (r"mamba_scan_bwd_", 2),
                 "rmsnorm_bwd": (r"rmsnorm_bwd_", 2),
                 "flash_attention_bwd": (r"flash_bwd_", 2),
                 "sumsq": (r"sumsq_kernel", 1),
                 "clip_finalize": (r"clip_finalize_kernel", 1),
                 "adamw_update": (r"adamw_update_kernel", 1)}


def kernel_counts(fn, iters: int = 5, sessions: int = 3) -> dict:
    """Kernels and copies per call of ``fn`` by name (profiler, after a
    warm-up): each name's events over ``iters`` calls. Each session runs
    one call first that it does not record (a session can miss the device
    events of its first launches); a session that dropped events
    (``whole_session``) is run again after a pause, and the count of each
    name is the largest of ``sessions`` sessions (rounded, if none was
    whole)."""
    fn()
    torch.cuda.synchronize()
    best = collections.Counter()
    done = 0
    for attempt in range(PROFILER_ATTEMPTS + sessions - 1):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=torch.profiler.schedule(wait=0, warmup=1, active=iters),
                     acc_events=True) as prof:
            for _ in range(iters + 1):
                fn()
                torch.cuda.synchronize()
                prof.step()
        seen = cuda_event_counts(prof)
        for name, n in seen.items():
            best[name] = max(best[name], round(n / iters))
        if whole_session(seen, iters):
            done += 1
            if done == sessions:
                break
        else:
            pause(attempt - done)
    if not best:
        fail("the profiler recorded no device time")
    return {name: n for name, n in best.items() if n}


def wrapper_calls(counts: dict) -> dict:
    """The calls of each kernel wrapper that kernels by name show."""
    return {w: sum(n for name, n in counts.items() if re.search(pat, name)) // per
            for w, (pat, per) in KERNEL_EVENTS.items()}


def require_same(what, got, want) -> dict:
    """Graphed against eager: the same kernels on the same inputs in the same
    order, so the same bits (cuBLAS picks its algorithm from the problem and
    the workspace size, which capture keeps). Fails unless bit-identical."""
    diff = float((got.float() - want.float()).abs().max())
    if not torch.equal(got, want):
        fail(f"{what}: graphed differs from eager (max abs diff {diff})")
    return {"bit_equal": True, "max_abs_diff": diff}


def counts(kern):
    return {name: fn.launches for name, fn in kern.items()}


def reset_counts(kern):
    for fn in kern.values():
        fn.launches = 0


def drive(kern, totals, want, fn, what):
    """Run ``fn`` with every launch count at 0 and fail unless the counts
    after it equal ``want``; add them to ``totals``. Returns fn()."""
    reset_counts(kern)
    out = fn()
    got = counts(kern)
    if got != want:
        fail(f"{what}: launches {got}, expected {want}")
    for k, v in got.items():
        totals[k] += v
    return out


def profile_call(fn, top: int = 6, groups=()):
    """Wall time of one call (median of 3, unprofiled), its device busy time
    (profiled), the idle share between them, the kernels that took the
    most device time, and the device ms and launches of the kernels whose
    names contain each of ``groups``."""
    walls = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls[1:])
    prof = profiled(fn)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {e.key: e.self_device_time_total / 1e3 for e in events}
    busy = sum(by_name.values())
    tops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall, "device_busy_ms": busy,
            "device_ops": sum(e.count for e in events),
            "idle_share": max(0.0, 1 - busy / wall),
            "top": [{"kernel": k[:80], "ms": v} for k, v in tops],
            "groups": {g: {"ms": sum(e.self_device_time_total for e in events
                                     if g in e.key) / 1e3,
                           "launches": sum(e.count for e in events if g in e.key)}
                       for g in groups}}


# the train step's record_function ranges (launch/steps.py), in order
TRAIN_RANGES = ("loss_fwd", "backward", "clip", "optimizer")


def _numel(shape) -> int:
    """Elements of a recorded input shape (a list of ints; a list of such
    lists for a tensor list; [] for a 0-d tensor or a non-tensor)."""
    if shape and isinstance(shape[0], list):
        return max((_numel(s) for s in shape), default=1)
    return math.prod(shape)


def range_profile(fn, ranges=TRAIN_RANGES) -> dict:
    """Device ms of the kernels and copies launched inside each
    ``record_function`` range of one call of ``fn`` (profiler, CPU and CUDA
    activities, shapes recorded, after one unrecorded call). A device event
    counts toward the range whose host interval holds its launch, the
    runtime call with the same correlation id (on any thread: autograd runs
    the backward on its own thread while ``backward()`` waits). Per range:
    ms, kernels and copies, the three names that take the most time,
    ``full_size`` (the kernels whose launch lies in an aten op with a tensor
    input of more than one element, innermost op on the launching thread:
    op and kernel names, ms) and ``direct`` (kernels launched outside any
    aten op, as the port's ctypes wrappers launch theirs). ``other`` is what
    launched outside every range, ``unmatched`` what has no runtime call.
    A session without device events or a range is run again after a pause
    (``profiled``)."""
    fn()
    torch.cuda.synchronize()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    for attempt in range(PROFILER_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.events()
        windows = {e.name: (e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == cpu and e.name in ranges}
        devices = [e for e in events if e.device_type == cuda and e.name not in ranges]
        if len(windows) == len(ranges) and devices:
            break
        PROFILER_RETRIES["empty" if not devices else "range"] += 1
        pause(attempt)
    else:
        fail(f"the profiler recorded no device event or not every range: {sorted(windows)}")
    runtime, ops = {}, collections.defaultdict(list)
    for e in events:
        if e.device_type != cpu:
            continue
        if e.name.startswith("cu") and "::" not in e.name:
            runtime[e.id] = e
        elif e.name.startswith("aten::"):
            ops[e.thread].append(e)
    for lst in ops.values():
        lst.sort(key=lambda e: e.time_range.start)
    starts = {th: [e.time_range.start for e in lst] for th, lst in ops.items()}

    def aten_op(launch):
        """The innermost aten op whose interval holds ``launch``, on its thread."""
        t, lst = launch.time_range.start, ops.get(launch.thread, [])
        for i in range(bisect.bisect_right(starts.get(launch.thread, []), t) - 1, -1, -1):
            if lst[i].time_range.end >= t:
                return lst[i]
        return None

    out = {r: {"ms": 0.0, "kernels": 0, "by_name": collections.Counter(),
               "full_size": collections.Counter(), "direct": collections.Counter()}
           for r in (*ranges, "other", "unmatched")}
    for d in devices:
        launch = runtime.get(d.id)
        r = "unmatched" if launch is None else next(
            (r for r, (a, b) in windows.items() if a <= launch.time_range.start <= b), "other")
        ms = (d.time_range.end - d.time_range.start) / 1e3
        name = re.sub(r"^void |\(.*$|<.*$", "", d.name.replace("(anonymous namespace)::", ""))
        rec = out[r]
        rec["ms"] += ms
        rec["kernels"] += 1
        rec["by_name"][name[:60]] += ms
        op = None if launch is None else aten_op(launch)
        if op is None:
            rec["direct"][name[:60]] += 1
        elif any(_numel(s) > 1 for s in op.input_shapes or []):
            rec["full_size"][f"{op.name} {name[:40]}"] += ms
    for rec in out.values():
        rec["top"] = rec.pop("by_name").most_common(3)
        rec["full_size_ms"] = sum(rec["full_size"].values())
        rec["full_size"] = dict(rec["full_size"].most_common(8))
        rec["direct"] = dict(rec["direct"])
    out["total_ms"] = sum(rec["ms"] for rec in out.values())
    return out


def print_ranges(tag, rp):
    print(f"{tag} device ms by range (one eager step): " + "; ".join(
        f"{r} {v['ms']:.2f} ms over {v['kernels']} kernels and copies (full-size aten "
        f"{v['full_size_ms']:.2f} ms; launched outside aten ops: "
        + (", ".join(f"{n} x{c}" for n, c in v["direct"].items()) or "none") + "), top "
        + ", ".join(f"{n} {ms:.2f}" for n, ms in v["top"])
        for r, v in rp.items() if r != "total_ms" and (v["kernels"] or r in TRAIN_RANGES))
        + f"; total {rp['total_ms']:.2f} ms", flush=True)


def print_profile(tag, prof):
    """Each profiled call (wall, device busy, idle, the top kernel), then the
    kernels and copies of each replay against one eager call."""
    calls = {k: v for k, v in prof.items() if "wall_ms" in v}
    checks = prof.get("replay_check", {})
    print(f"{tag} " + "; ".join(
        f"{k}: wall {v['wall_ms']:.2f} ms, device busy {v['device_busy_ms']:.2f} ms "
        f"over {v['device_ops']} kernels and copies, "
        f"idle {v['idle_share']:.1%}, top " + ", ".join(
            f"{t['kernel'][:40]} {t['ms']:.2f} ms" for t in v["top"][:3])
        + "".join(f", {g} {x['ms']:.2f} ms ({x['ms'] / v['device_busy_ms']:.1%}) over "
                  f"{x['launches']} kernels" for g, x in v["groups"].items())
        for k, v in calls.items())
        + "".join(f"; {k} replay: {c['kernels_per_replay']} kernels and copies (eager "
                  f"call {c['kernels_per_eager_call']}), launches "
                  + ", ".join(f"{n} {m}" for n, m in c["launches_per_replay"].items() if m)
                  + " (counters = profiler)" for k, c in checks.items()), flush=True)


# mangled names of the kernel instances whose registers and spills phase 1
# prints: flash_attention_wgmma<DP, NH, NQ> (flash_attention_sm90.cu),
# flash_attention_kernel<D> (flash_attention.cu, float32),
# flash_bwd_{dq,dkdv}_wgmma<DP> (flash_attention_bwd_sm90.cu),
# decode_attention_kernel<T, D> (decode_attention.cu),
# rmsnorm_{warp,block}_kernel<T, NV> (rmsnorm.cu), mamba_scan_kernel<T, NM,
# kSave> (mamba_scan.cu: "train" where it saves states) and
# mamba_scan_bwd_kernel<T, NM> (mamba_scan_bwd.cu); T is f (float32) or
# 13__nv_bfloat16
WGMMA_NAME = r"flash_attention_wgmmaILi(\d+)ELi(\d+)ELi(\d+)E"
INSTANCE_NAMES = {
    "flash": (WGMMA_NAME, "DP{} NH{} NQ{}"),
    "flash_f32": (r"flash_attention_kernelILi(\d+)EE", "D{}"),
    "decode": (r"decode_attention_kernelI(f|13__nv_bfloat16)Li(\d+)EE", "{} D{}"),
    "rmsnorm": (r"rmsnorm_(warp|block)_kernelI(f|13__nv_bfloat16)Li(\d+)E",
                "{} {} NV{}"),
    "scan": (r"mamba_scan_kernelI(f|13__nv_bfloat16)Li(\d+)ELb([01])EE", "{} N{}{}"),
    "scan_bwd": (r"mamba_scan_bwd_kernelI(f|13__nv_bfloat16)Li(\d+)EE", "bwd {} N{}"),
    "flash_bwd": (r"flash_bwd_(dq|dkdv)_kernelI(f|13__nv_bfloat16)Li(\d+)EE",
                  "{} {} D{}"),
    # flash_bwd_dq_pair_wgmma and flash_bwd_dkdv_split_wgmma (DP 192, two
    # consumer warpgroups) are no templates: their labels are fixed
    "flash_bwd_wgmma": (r"flash_bwd_(dq|dkdv)_(?:wgmmaILi(\d+)E|pair_wgmma|split_wgmma)",
                        "{} DP{}"),
    "rmsnorm_bwd": (r"rmsnorm_bwd_(warp|block|scalar)_kernelI(f|13__nv_bfloat16)Li(\d+)E",
                    "{} {} NV{}"),
    "adamw": (r"(sumsq|adamw_update|clip_finalize)_kernel(?:I(f|13__nv_bfloat16)E)?",
              "{} {}"),
}
# the scan instances of the main paths (Jamba: bf16 u, N 16): serving,
# training forward, backward
SCAN_MAIN = "bf16 N16"
SCAN_TRAIN = ("bf16 N16 train", "bwd bf16 N16")
# MLA's bf16 flash instance (DeepSeek-V3 prefill: head dim 192, one head and
# two 64-row q tiles a block) and the registers its consumer warpgroups take
# with setmaxnreg: (entry budget x 3 warpgroups - the producer's 40) / 2, the
# entry budget 168 = 65536 / 384 threads in steps of 8 (Plan<192, 1, 2>)
MLA_INSTANCE = "DP192 NH1 NQ2"
MLA_CONSUMER_REGS = (65536 // 384 // 8 * 8 * 3 - 40) // 2 // 8 * 8
# the bf16 backward instances of the main path (smollm: head dim 64) and of
# MLA's (DeepSeek-V3 training: head dim 192), which must not spill
FLASH_BWD_MAIN = ("dq DP64", "dkdv DP64")
FLASH_BWD_MLA = ("dq DP192", "dkdv DP192")
# the float32 backward instances of MLA's head dims (the parity phases)
FLASH_BWD_F32_MLA = ("dq f32 D24", "dkdv f32 D24", "dq f32 D192", "dkdv f32 D192")
# the instances of smollm's train step that must not spill: the RMSNorm
# backward at d 960 (bf16, 4 vectors a lane), the clip and AdamW in bf16
TRAIN_MAIN = {"rmsnorm_bwd": ("warp bf16 NV4",),
              "adamw": ("sumsq bf16", "adamw_update bf16")}


def spill_bytes(ptxas_line: str) -> int:
    """Spill stores and loads, in bytes, of a ptxas report line."""
    return sum(int(b) for b in re.findall(r"(\d+) bytes spill (?:stores|loads)",
                                          ptxas_line))


def instance_label(family: str, name: str):
    pattern, fmt = INSTANCE_NAMES[family]
    m = re.search(pattern, name)
    if not m:
        return None
    if family == "flash_bwd_wgmma" and m.group(2) is None:
        return f"{m.group(1)} DP192"
    if family == "scan":
        return fmt.format("f32" if m.group(1) == "f" else "bf16", m.group(2),
                          " train" if m.group(3) == "1" else "")
    return fmt.format(*("f32" if g == "f" else "bf16" if g == "13__nv_bfloat16"
                        else g or "" for g in m.groups())).strip()


def kernel_build_report(build, lib_path: str) -> dict:
    """ptxas's registers and spills, from the build log, for each instance
    of the bf16 flash-attention kernel (head dim padded to DP, NH q heads and
    NQ 64-row q tiles a block), of decode attention (dtype, head dim D), of the vector
    RMSNorm paths (warp or block per row, NV vectors per thread) and of the
    scan (dtype of u, state width rounded up to NM), and of the bf16 flash
    backward's two kernels (head dim padded to DP), with their spill bytes;
    every compiler warning or ptxas performance-loss note; from the SASS
    (cuobjdump, beside nvcc), the HGMMA (tensor-core) instructions of the
    flash forward and backward kernels, each forward instance's setmaxnreg
    register counts and local-memory loads and stores, and, for each
    scan instance, its instructions, MUFU.EX2 and local-memory loads and
    stores (LDL/STL: spills). The scan instances' SASS goes to
    ``build/scan_sass.txt``."""
    lib = Path(lib_path)
    log = lib.parent / lib.name.replace("libreprotorch_", "build_").replace(".so", ".log")
    ptxas = {family: {} for family in INSTANCE_NAMES}
    spills, bwd_spills = {}, {}
    warnings, inst = [], None
    for line in log.read_text().splitlines():
        if "warning" in line or "Performance Loss" in line:
            warnings.append(line.strip())
        elif "Compiling entry function" in line:
            inst = next(((f, lab) for f in INSTANCE_NAMES
                         if (lab := instance_label(f, line))), None)
        elif inst and ("spill" in line or "Used" in line):
            fam, lab = inst
            ptxas[fam][lab] = (ptxas[fam].get(lab, "") + " "
                               + line.split(":")[-1].strip()).strip()
            if fam in ("scan", "scan_bwd", "flash_bwd_wgmma") and "spill" in line:
                (bwd_spills if fam == "flash_bwd_wgmma" else spills)[lab] = sum(
                    int(b) for b in re.findall(r"(\d+) bytes spill (?:stores|loads)", line))
    cuobjdump = Path(build._find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", lib_path], check=True,
                          capture_output=True, text=True).stdout
    hgmma, bwd_hgmma, scan_sass, scan_text, flash_sass = {}, {}, {}, [], {}
    sass_ops = r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split(None, 1)[0]
        lab = instance_label("flash", name)
        if lab:
            hgmma[lab] = chunk.count("HGMMA")
            # setmaxnreg's register counts (the operands up to the ';', not
            # the encoding comment after it) and local-memory traffic
            setmax = [line.split("SETMAXREG", 1)[1].split(";")[0]
                      for line in chunk.splitlines() if "SETMAXREG" in line]
            flash_sass[lab] = {
                "setmaxnreg": [int(v, 0) for ops in setmax
                               for v in re.findall(r"\b(0x[0-9a-f]+|\d+)\b", ops)],
                "setmaxnreg_sass": [" ".join(o.split()) for o in setmax],
                "ldl_stl": sum(op.split(".")[0] in ("LDL", "STL")
                               for op in re.findall(sass_ops, chunk))}
        lab = instance_label("flash_bwd_wgmma", name)
        if lab:
            bwd_hgmma[lab] = chunk.count("HGMMA")
        lab = instance_label("scan", name) or instance_label("scan_bwd", name)
        if lab:
            ops = re.findall(sass_ops, chunk)
            scan_sass[lab] = {
                "instructions": len(ops),
                "mufu_ex2": sum(op.startswith("MUFU.EX2") for op in ops),
                "shfl": sum(op.startswith("SHFL") for op in ops),
                "ldl_stl": sum(op.split(".")[0] in ("LDL", "STL") for op in ops),
                "spill_bytes": spills.get(lab)}
            scan_text.append(f"Function : {chunk}")
    (ROOT / "build" / "scan_sass.txt").write_text("".join(scan_text))
    return {"ptxas": ptxas["flash"], "ptxas_flash_f32": ptxas["flash_f32"],
            "ptxas_decode": ptxas["decode"],
            "ptxas_rmsnorm": ptxas["rmsnorm"], "ptxas_scan": ptxas["scan"],
            "ptxas_scan_bwd": ptxas["scan_bwd"],
            "ptxas_flash_bwd": ptxas["flash_bwd"],
            "ptxas_flash_bwd_wgmma": ptxas["flash_bwd_wgmma"],
            "flash_bwd_wgmma_spill_bytes": bwd_spills, "flash_bwd_wgmma_hgmma": bwd_hgmma,
            "ptxas_rmsnorm_bwd": ptxas["rmsnorm_bwd"], "ptxas_adamw": ptxas["adamw"],
            "scan_sass": scan_sass, "warnings": warnings,
            "hgmma": hgmma, "hgmma_total": sum(hgmma.values()), "flash_sass": flash_sass}


def train_parity(cfg, p_cpu, p_gpu, batch, loss_fn, make_train_step, adamw,
                 lr: float = 1e-3) -> dict:
    """Float32 training card vs CPU from the same params and batch: the loss,
    the global grad norm and every gradient leaf after one backward, then
    the params after one ``make_train_step`` (AdamW, lr ``lr``). A leaf the
    loss does not reach (llava's embedding on an ``embeds`` batch) must
    have no gradient on either side (``no_grad``); it counts as zero."""
    from repro_torch.models.module import tree_leaves, tree_map
    from repro_torch.optim.optimizers import global_norm

    def grads(params, dev):
        p = tree_map(lambda a: a.detach().requires_grad_(True), params)
        loss, _ = loss_fn(p, {k: v.to(dev) for k, v in batch.items()}, cfg)
        loss.backward()
        return float(loss.detach()), tree_map(lambda a: a.grad, p)

    loss_c, g_c = grads(p_cpu, "cpu")
    loss_g, g_g = grads(p_gpu, "cuda")
    out = {"params": sum(t.numel() for t in tree_leaves(p_cpu)), "loss_cpu": loss_c,
           "loss_err": abs(loss_c - loss_g), "leaves": 0, "worst_grad": None,
           "worst_grad_ratio": 0.0,
           "missing": [path for path, gc, gg in _paired_leaves(g_c, g_g)
                       if (gc is None) != (gg is None)],
           "no_grad": [path for path, gc, gg in _paired_leaves(g_c, g_g)
                       if gc is None and gg is None]}
    g_c, g_g = (tree_map(lambda g, a: torch.zeros_like(a) if g is None else g, grad, params)
                for grad, params in ((g_c, p_cpu), (g_g, p_gpu)))
    n_c, n_g = float(global_norm(g_c)), float(global_norm(g_g))
    out["grad_norm_rel_err"] = abs(n_c - n_g) / n_c
    for path, gc, gg in _paired_leaves(g_c, g_g):
        out["leaves"] += 1
        tol = GRAD_TOL * float(gc.abs().max()) + 1e-6
        ratio = float((gg.cpu() - gc).abs().max()) / tol
        if ratio >= out["worst_grad_ratio"]:
            out["worst_grad"], out["worst_grad_ratio"] = path, ratio
    opt = adamw(lr)
    new_c, _, _ = make_train_step(cfg, opt, device="cpu")(p_cpu, opt.init(p_cpu), batch)
    new_g, _, _ = make_train_step(cfg, opt, device="cuda")(p_gpu, opt.init(p_gpu), batch)
    errs = [(gg.cpu() - gc).abs() for _, gc, gg in _paired_leaves(new_c, new_g)]
    out["param_tol"] = 2 * lr + 1e-6
    out["param_max_err"] = max(float(e.max()) for e in errs)
    out["param_share_within_1e-6"] = (sum(int((e <= 1e-6).sum()) for e in errs)
                                      / sum(e.numel() for e in errs))
    out["ok"] = (not out["missing"] and out["loss_err"] <= LOSS_TOL
                 and out["worst_grad_ratio"] <= 1.0
                 and out["grad_norm_rel_err"] <= GRAD_TOL
                 and out["param_max_err"] <= out["param_tol"])
    return out


def lockstep_train(cfg, p_gpu, batch_of, steps, total, lr, make_train_step, adamw,
                   warmup_cosine) -> dict:
    """Float32 training card vs CPU in lockstep: the first ``steps`` eager
    AdamW steps on the card at base rate ``lr`` with the schedule ``train``
    gives a run of ``total`` steps (warm-up ``total // 10`` steps, then
    cosine), each also taken on the CPU from a
    copy of the card's params and AdamW state before it, on
    ``batch_of(params on the CPU, step)``. Each step's loss to LOSS_TOL and
    grad norm to GRAD_TOL relative, so the card's loss curve is the plain
    arithmetic's along the same path; the params after each step are
    reported. ``p_gpu`` is trained in place."""
    from repro_torch.models.module import tree_leaves, tree_map
    opt = adamw(warmup_cosine(lr, warmup=max(total // 10, 1), total=total))
    step_g = make_train_step(cfg, opt, device="cuda", graphs=False)
    step_c = make_train_step(cfg, opt, device="cpu")
    s_gpu = opt.init(p_gpu)
    out = {"lr": lr, "steps": steps, "losses": [], "losses_cpu": [], "grad_norms": [],
           "loss_err": [], "grad_norm_rel_err": [], "param_max_err": []}
    for t in range(steps):
        p_cpu = tree_map(lambda a: a.to("cpu", copy=True), p_gpu)
        s_cpu = tree_map(lambda a: a.to("cpu", copy=True), s_gpu)
        batch = batch_of(p_cpu, t)
        p_gpu, s_gpu, m_g = step_g(p_gpu, s_gpu, batch)
        p_cpu, s_cpu, m_c = step_c(p_cpu, s_cpu, batch)
        loss_g, loss_c = float(m_g["loss"]), float(m_c["loss"])
        n_g, n_c = float(m_g["grad_norm"]), float(m_c["grad_norm"])
        out["losses"].append(loss_g)
        out["losses_cpu"].append(loss_c)
        out["grad_norms"].append(n_g)
        out["loss_err"].append(abs(loss_g - loss_c))
        out["grad_norm_rel_err"].append(abs(n_g - n_c) / n_c)
        out["param_max_err"].append(max(float((a.cpu() - b).abs().max()) for a, b in zip(
            tree_leaves(p_gpu), tree_leaves(p_cpu))))
        del p_cpu, s_cpu
    out["ok"] = (all(math.isfinite(x) for x in out["losses"])
                 and max(out["loss_err"]) <= LOSS_TOL
                 and max(out["grad_norm_rel_err"]) <= GRAD_TOL)
    return out


def _paired_leaves(a, b, path=""):
    """(path, leaf of a, leaf of b) over two trees of nested dicts and lists
    (DeepSeek's dense prefix is a list)."""
    if isinstance(a, dict):
        for k in sorted(a):
            yield from _paired_leaves(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _paired_leaves(x, y, f"{path}/{i}")
    else:
        yield path, a, b


# phase 23: the paper's streaming apps, each planned by RLAS with the
# paper's settings (r = 5, best-fit, as the reference's bench plans them) and
# run at the batch BENCH_streaming.json ran it at
STREAM_APPS = {"word_count": 256, "fraud_detection": 256,
               "spike_detection": 256, "linear_road": 1024}
STREAM_RLAS = dict(compress_ratio=5, bestfit=True, max_nodes=5000)
STREAM_REPLAY = 20          # batches per spout replica of a replay
# the inference app at its own widths (32 features, 4 layers), batch 16 as
# the reference's bench runs it; the card's score against the CPU's
INF_BATCH, INF_REPLAY, INF_TOL = 16, 200, 1e-5
# the processes backend in a fresh interpreter, which has never initialised
# CUDA (forked workers of a CUDA parent cannot use the card): processes
# first, since the threads run initialises CUDA in that process
STREAM_CHILD = """
import json, torch
from repro_torch.streaming.apps import streaming_inference
from repro_torch.streaming.procexec import run_app_processes
from repro_torch.streaming.runtime import run_app
out = []
for runner in (run_app_processes, run_app):
    assert runner is run_app or not torch.cuda.is_initialized()
    r = runner(streaming_inference(model_versions=1, device="cuda"), {},
               batch=16, max_batches=10, dispatch_depth=2)
    s = r.states["sink"][0]
    out.append([r.spout_tuples, r.sink_tuples, int(s["seen"]),
                float(s["score"]).hex()])
print(json.dumps(out))
"""


def host_cpu() -> str:
    """The host CPU's model name and logical core count (host rates are
    the host's, not the card's)."""
    info = {}
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            key, _, value = line.partition(":")
            info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    model = info.get("model name", "unknown")
    if model == "unknown":      # a VM may hide the name: vendor, family, model
        model = (f"{info.get('vendor_id', '?')} family {info.get('cpu family', '?')} "
                 f"model {info.get('model', '?')}")
    return f"{model}, {os.cpu_count()} logical cores"


def stream_counts(name, rt, batch) -> dict:
    """A replay's tuple counts, failing unless the sink saw what the app
    defines: WC 10 words a sentence, FD and SD one row a transaction or
    reading, LR every history query (plus tolls and notifications, which
    depend on each batch's speeds) — per spout replica, ``batch`` rows a
    retired batch."""
    batches = collections.Counter()
    for uid, n in rt.spout_offsets.items():
        batches[uid.split("#")[0]] += n
    rows = batches["spout"] * batch
    seen = sum(st.get("seen", 0) for st in rt.states["sink"])
    queries = sum(st.get("queries", 0) for st in rt.states.get("toll_history", []))
    want = {"word_count": 10 * rows, "fraud_detection": rows,
            "spike_detection": rows}.get(name)
    ok = seen == rt.sink_tuples > 0 and (
        seen == want if want is not None else
        queries == batches["hist_spout"] * batch and seen > queries)
    out = {"spout_batches": dict(batches), "sink_tuples": rt.sink_tuples, "sink_seen": seen}
    if name == "linear_road":
        out["history_queries"] = queries
    if not ok:
        fail(f"{name}: the sink's counts {out} are not what the app defines")
    return out


def phase_streaming(kern, zero) -> dict:
    """Phase 23: RLAS plans and host runs of the paper's apps, and the
    ``streaming_inference`` predictor on the card (see the module doc)."""
    from repro_torch.core import server_a
    from repro_torch.streaming import apps
    from repro_torch.streaming.api import Job
    from repro_torch.streaming.procexec import run_app_processes
    from repro_torch.streaming.runtime import run_app

    out = {"host_cpu": host_cpu(), "apps": {}}
    for name, batch in STREAM_APPS.items():
        t = time.perf_counter()
        plan = Job(getattr(apps, name)()).plan(server_a(), optimizer="rlas", **STREAM_RLAS)
        plan_s = time.perf_counter() - t
        est = plan.estimate()
        if not (est.feasible and est.throughput > 0):
            fail(f"{name}: RLAS plan infeasible or empty: {est.summary()}")
        replay = stream_counts(name, plan.execute(batch=batch, batches=STREAM_REPLAY).raw,
                               batch)
        rt = plan.execute(batch=batch, duration=1.0).raw
        sockets = {}                # operator -> the sockets its units are on
        for unit, socket in zip(plan.graph.replicas, plan.placement):
            sockets.setdefault(unit.op, set()).add(int(socket))
        sockets = {op: sorted(v) for op, v in sockets.items()}
        out["apps"][name] = {
            "batch": batch, "planner_s": plan_s, "parallelism": plan.parallelism,
            "placement": plan.placement, "sockets": sockets,
            "estimate_tuples_per_s": est.throughput,
            "replay": replay, "duration_s": rt.duration,
            "sink_tuples_per_s": rt.throughput,
            "spout_tuples_per_s": rt.spout_tuples / rt.duration}
        print(f"[23 streaming] {name}: RLAS on server_a in {plan_s:.3f} s, parallelism "
              f"{plan.parallelism}, sockets {sockets}, estimate "
              f"{est.throughput:,.0f} tuples/s; replay at batch {batch} x {STREAM_REPLAY}: "
              f"{replay}, as the app defines them; 1 s run: {rt.throughput:,.0f} sink tuples/s, "
              f"{rt.spout_tuples / rt.duration:,.0f} spout tuples/s on the host "
              f"({out['host_cpu']})", flush=True)

    def inference(device, depth, versions=1, graphs=True, **kw):
        app = apps.streaming_inference(model_versions=versions, device=device,
                                       graphs=graphs)
        rt = run_app(app, {}, batch=INF_BATCH, dispatch_depth=depth, **kw)
        return rt, app.kernels["predictor"].predictor

    # deterministic replay: depths 1, 2, 3 on the card against the CPU's
    # plain predictor over the same seeded batches; the port's kernels run
    # nowhere on this path
    sinks = {}
    for depth in (1, 2, 3):
        rt, pred = drive(kern, {k: 0 for k in kern}, zero(),
                         lambda: inference("cuda", depth, max_batches=INF_REPLAY),
                         f"streaming inference depth {depth}")
        if pred.batches != {"cuda": INF_REPLAY} or pred.timed != INF_REPLAY \
                or pred.captures != 1:
            fail(f"inference depth {depth}: batches {dict(pred.batches)}, "
                 f"{pred.timed} timed, {pred.captures} graphs, expected "
                 f"{INF_REPLAY} on cuda from one graph")
        sinks[depth] = rt.states["sink"][0]
    cpu_rt, cpu_pred = inference("cpu", 1, max_batches=INF_REPLAY)
    cpu = cpu_rt.states["sink"][0]
    seen = {s["seen"] for s in sinks.values()}
    scores = {s["score"].hex() for s in sinks.values()}
    rel = abs(sinks[1]["score"] - cpu["score"]) / abs(cpu["score"])
    if seen != {cpu["seen"]} or seen != {INF_REPLAY * INF_BATCH}:
        fail(f"inference: seen {seen} on the card, {cpu['seen']} on the CPU")
    if len(scores) != 1:
        fail(f"inference: depths 1, 2, 3 give different scores {scores}")
    if not rel <= INF_TOL:
        fail(f"inference: card score {sinks[1]['score']!r} vs CPU {cpu['score']!r}, rel {rel}")
    out["inference"] = {"replay": {"batches": INF_REPLAY, "seen": seen.pop(),
                                   "score": sinks[1]["score"], "cpu_score": cpu["score"],
                                   "rel_err": rel, "tol": INF_TOL}}
    # one predictor alone, a call and its retirement at a time: host us and
    # device ms a call, graphed and plain (mlp_ref's kernels one by one)
    x = np.random.default_rng(SEED).normal(size=(INF_BATCH, apps.INF_FEATURES))
    x, w = x.astype(np.float32), apps.inf_model_weights(0)
    alone = {}
    for mode in ("plain", "graphed", "graphed", "plain"):
        pred = apps.InferencePredictor("cuda", graphs=mode == "graphed")
        for i in range(520):
            if i == 20:         # after the warm-up (and the graph's capture)
                pred.device_ms, pred.timed, t = 0.0, 0, time.perf_counter()
            np.asarray(pred(x, 0, w))
        alone.setdefault(mode, []).append({
            "host_us_per_call": (time.perf_counter() - t) / 500 * 1e6,
            "device_ms_per_call": pred.device_ms / pred.timed})
    out["inference"]["alone"] = alone
    # live model updates (8 versions), 1 s at depths 1 and 2, graphed and
    # plain in turns: tuples/s and the device time of a call (CUDA events
    # around its copies and replay)
    declared = apps.streaming_inference(device="cpu").graph.operators["predictor"].device_ns
    for depth in (1, 2):
        rec = out["inference"][f"depth{depth}"] = {"declared_device_ns_per_tuple": declared}
        for mode in ("plain", "graphed", "graphed", "plain"):
            rt, pred = inference("cuda", depth, versions=8, graphs=mode == "graphed",
                                 duration=1.0)
            if pred.batches["cpu"] or not pred.timed:
                fail(f"inference depth {depth} (8 versions): batches {dict(pred.batches)}")
            call_ms = pred.device_ms / pred.timed
            rec.setdefault(mode, []).append({
                "sink_tuples_per_s": rt.throughput, "calls": pred.timed,
                "graphs": pred.captures, "device_ms_per_call": call_ms,
                "device_ns_per_tuple": call_ms * 1e6 / INF_BATCH,
                "predictor_kernel_s": rt.exec_stats["predictor#0"]["kernel_s"],
                "duration_s": rt.duration})
    # the fork guard, in this process (CUDA is initialised here)
    try:
        run_app_processes(apps.streaming_inference(model_versions=1, device="cuda"), {},
                          batch=INF_BATCH, max_batches=2)
    except RuntimeError as e:
        if "CUDA-clean parent" not in str(e):
            raise
        out["inference"]["guard"] = str(e)
    else:
        fail("run_app_processes ran a device app in a CUDA-initialised parent")
    # the processes backend in a fresh interpreter, against its threads
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    child = subprocess.run([sys.executable, "-c", STREAM_CHILD], env=env, cwd=ROOT,
                           capture_output=True, text=True, timeout=300)
    if child.returncode != 0:
        fail(f"inference processes-backend child exited {child.returncode}: "
             f"{child.stderr[-3000:]}")
    procs, threads = json.loads(child.stdout.strip().splitlines()[-1])
    if procs != threads:
        fail(f"inference: processes {procs} != threads {threads}")
    out["inference"]["processes_vs_threads"] = {"processes": procs, "threads": threads}
    inf = out["inference"]

    def listed(rec, key, fmt):
        return " / ".join(format(r[key], fmt) for r in rec)

    print(f"[23 streaming] inference (32 features, 4 layers, batch {INF_BATCH}) on cuda: "
          f"depths 1/2/3 x {INF_REPLAY} batches seen {inf['replay']['seen']}, score "
          f"{inf['replay']['score']!r} equal bit for bit, CPU plain predictor rel err "
          f"{rel:.2e} (tol {INF_TOL:g}), every batch on cuda from one graph; one predictor "
          f"alone: graphed {listed(alone['graphed'], 'host_us_per_call', '.1f')} us a call "
          f"({listed(alone['graphed'], 'device_ms_per_call', '.4f')} ms on the card), plain "
          f"{listed(alone['plain'], 'host_us_per_call', '.1f')} us "
          f"({listed(alone['plain'], 'device_ms_per_call', '.4f')} ms); 8 versions, 1 s"
          + "".join(
              f"; depth {d}: graphed {listed(inf[f'depth{d}']['graphed'], 'sink_tuples_per_s', ',.0f')}"
              f" tuples/s, {listed(inf[f'depth{d}']['graphed'], 'device_ms_per_call', '.4f')} "
              f"ms a call, plain {listed(inf[f'depth{d}']['plain'], 'sink_tuples_per_s', ',.0f')}"
              f" tuples/s, {listed(inf[f'depth{d}']['plain'], 'device_ms_per_call', '.4f')} ms"
              for d in (1, 2))
          + f" (declared {declared:.0f} ns a tuple); the processes backend refused in this "
          f"CUDA parent; in a fresh process processes = threads {procs}", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get
    from repro_torch.kernels import _build
    from repro_torch.kernels import adamw as ka
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fla
    from repro_torch.kernels import mamba_scan as scan
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.graphs import WARMUP
    from repro_torch.launch.serve import Request, serve_batch
    from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                          make_train_step)
    from repro_torch.launch.train import _frontend_batch, train
    from repro_torch.models import encdec, frontends, model_api, transformer
    from repro_torch.optim.optimizers import adamw, warmup_cosine
    from repro_torch.models.module import param_bytes, param_count, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # each kernel's wrapper, which counts its launches
    kern = {"rmsnorm": rms.rmsnorm_cuda, "flash_attention": fla.flash_attention_cuda,
            "decode_attention": dec.decode_attention_cuda,
            "mamba_scan": scan.mamba_scan_cuda, "mamba_scan_train": scan.mamba_scan_train_cuda,
            "mamba_scan_bwd": scan.mamba_scan_bwd_cuda, "rmsnorm_bwd": rms.rmsnorm_bwd_cuda,
            "flash_attention_bwd": fla.flash_attention_bwd_cuda,
            "sumsq": ka.sumsq_cuda, "clip_finalize": ka.clip_finalize_cuda,
            "adamw_update": ka.adamw_update_cuda}
    totals = {name: 0 for name in kern}     # launches over every main path
    side = {name: 0 for name in kern}       # launches of the parity phases
    mla_totals = {name: 0 for name in MLA_ROWS}   # launches of MLA's instances
    mla_totals.update({name: 0 for name in MLA_BWD_ROWS})
    frontend_totals = {name: 0 for name in FRONTEND_ROWS}   # whisper's and llava's
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    report = {"phase_s": {}}
    clock = [time.perf_counter()]

    def took(phase):
        """Seconds since the previous phase ended; recorded in the report."""
        now = time.perf_counter()
        report["phase_s"][phase] = sec = now - clock[0]
        clock[0] = now
        return f"({sec:.1f} s)"

    def zero(**nonzero):
        return {name: nonzero.get(name, 0) for name in kern}

    def timed_prefill(prefill, params, batch, n_runs):
        times = []
        for _ in range(n_runs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits = prefill(params, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return logits, times

    def requests(cfg, rng):
        return [Request(i, torch.randint(0, cfg.vocab, (64,), generator=rng,
                                         dtype=torch.int32).numpy(), 64)
                for i in range(8)]

    def check_served(reqs, cfg, max_new):
        for r in reqs:
            if r.out.shape != (max_new,) or not ((0 <= r.out) & (r.out < cfg.vocab)).all():
                fail(f"{cfg.name} request {r.rid}: bad output {r.out}")

    def graph_of(step):
        (g,) = step.graphs.values()
        return g

    def launches_of(stats) -> dict:
        return {name: stats["per_replay"].get(f"{fn.__name__}.launches", 0)
                for name, fn in kern.items()}

    def capture_report(stats, want, what) -> dict:
        """A capture's cost, and the launches its replays add, which must be
        one step's (``want``)."""
        got = launches_of(stats)
        if got != want:
            fail(f"{what}: a replay launches {got}, one step {want}")
        return dict(stats, launches_per_replay=got)

    def replay_check(what, g, eager_fn, iters=5) -> dict:
        """The kernels and copies of one replay of ``g`` against one eager
        call of the same step on the same tensors (profiler), and the
        launches the wrappers' counters add per replay against the kernels
        the replay ran."""
        rc = kernel_counts(g.replay, iters)
        ec = kernel_counts(lambda: eager_fn(*g.args), iters)
        counted, seen = launches_of(g.stats), wrapper_calls(rc)
        if counted != seen:
            fail(f"{what}: the counters add {counted} a replay, the profiler sees {seen}")
        if rc != ec:
            fail(f"{what}: a replay runs other kernels than an eager call: "
                 f"{ {k: (rc.get(k), ec.get(k)) for k in set(rc) | set(ec) if rc.get(k) != ec.get(k)} }")
        return {"kernels_per_replay": sum(rc.values()),
                "kernels_per_eager_call": sum(ec.values()), "launches_per_replay": counted}

    def prefill_pair(what, cfg, params, batch, n_runs, n_tokens=None):
        """Eager and graphed prefill, ``n_runs`` calls each on the same
        weights and ``batch`` ({"inputs"}, {"embeds"} or an encoder-decoder's
        {"frames", "inputs"}; times: median after the first), tokens/s over
        ``n_tokens`` a call (default: the positions of the inputs or
        embeds); the graphed logits must equal the eager ones bit for bit.
        Returns (record, eager step, graphed step)."""
        per = per_pass(cfg)
        one = zero(rmsnorm=per["rmsnorm"], flash_attention=per["flash"],
                   mamba_scan=per["mamba"])
        eager = make_prefill_step(cfg, device="cuda", graphs=False)
        graphed = make_prefill_step(cfg, device="cuda")
        b, s = (batch["embeds"] if "embeds" in batch else batch["inputs"]).shape[:2]
        n_tokens = n_tokens or b * s
        rec = {"batch": b, "seq": s, "tokens_per_call": n_tokens,
               "launches_per_forward": one}
        logits = {}
        for mode, step, n in (("eager", eager, n_runs), ("graphed", graphed, n_runs + WARMUP)):
            lg, times = drive(kern, totals, {k: v * n for k, v in one.items()},
                              lambda: timed_prefill(step, params, batch, n_runs),
                              f"{what} ({mode})")
            if tuple(lg.shape) != (b, cfg.vocab) or not bool(torch.isfinite(lg).all()):
                fail(f"{what} ({mode}) logits shape {tuple(lg.shape)} or not finite")
            med = statistics.median(times[1:])
            rec[mode] = {"runs_s": times, "median_s": med, "tokens_per_s": n_tokens / med}
            logits[mode] = lg
        rec["graphed"]["capture"] = capture_report(graph_of(graphed).stats, one, what)
        rec["graphed_vs_eager"] = require_same(f"{what} logits", logits["graphed"],
                                               logits["eager"])
        return rec, eager, graphed

    def serve_pair(what, cfg, params, prompts, max_new):
        """``serve_batch`` eager and graphed on the same weights and prompts;
        the graphed tokens must equal the eager ones."""
        per = per_pass(cfg)
        one = zero(rmsnorm=per["rmsnorm_step"], decode_attention=per["attn"])
        n_steps = len(prompts[0]) + max_new
        new = len(prompts) * max_new
        rec = {"requests": len(prompts), "prompt": len(prompts[0]), "max_new": max_new,
               "launches_per_step": one}
        outs, steps = {}, {"eager": make_decode_step(cfg, device="cuda", graphs=False),
                           "graphed": make_decode_step(cfg, device="cuda")}
        for mode, n in (("eager", n_steps), ("graphed", n_steps + WARMUP)):
            reqs = [Request(i, p, max_new) for i, p in enumerate(prompts)]
            reqs, dt = drive(kern, totals, {k: v * n for k, v in one.items()},
                             lambda: serve_batch(cfg, params, reqs, max_len=n_steps + 1,
                                                 device="cuda", step_fn=steps[mode]),
                             f"{what} ({mode})")
            check_served(reqs, cfg, max_new)
            rec[mode] = {"seconds": dt, "new_tokens_per_s": new / dt,
                         "steps_per_s": n_steps / dt}
            outs[mode] = np.stack([r.out for r in reqs])
        cap = rec["graphed"]["capture"] = capture_report(graph_of(steps["graphed"]).stats,
                                                         one, what)
        steps["graphed"].release()
        rec["graphed"]["steady_new_tokens_per_s"] = new / (
            rec["graphed"]["seconds"] - cap["warmup_s"] - cap["capture_s"])
        if not np.array_equal(outs["graphed"], outs["eager"]):
            fail(f"{what}: graphed tokens differ from eager ones")
        rec["tokens_equal"] = True
        return rec

    def profile_pair(what, cfg, params, batch, tok, eager_prefill, prefill):
        """One prefill of ``batch`` and one decode step of the 8 tokens
        ``tok`` (position 64 of a cache of 129; an encoder-decoder's cross
        K/V zeros, as its server leaves them), eager and graphed, profiled;
        and each graph's replay against an eager call."""
        api = model_api(cfg)
        step_e = make_decode_step(cfg, device="cuda", graphs=False)
        step_g = make_decode_step(cfg, device="cuda")
        cache_e, cache_g = (api.init_cache(cfg, 8, 129, device="cuda") for _ in range(2))
        step_g(params, cache_g, tok, 64)
        out = {"prefill": profile_call(lambda: eager_prefill(params, batch)),
               "prefill_graphed": profile_call(lambda: prefill(params, batch)),
               "decode_step": profile_call(lambda: step_e(params, cache_e, tok, 64)),
               "decode_step_graphed": profile_call(lambda: step_g(params, cache_g, tok, 64)),
               "replay_check": {
                   "prefill": replay_check(f"{what} prefill", graph_of(prefill),
                                           eager_prefill),
                   "decode_step": replay_check(f"{what} decode step", graph_of(step_g),
                                               step_e)}}
        step_g.release()
        return out

    def train_pair(arch, over, what, seq=512, lr=3e-4, steps=MOE_TRAIN_STEPS,
                   ranges=True):
        """``launch.train.train`` of ``arch`` at its published widths cut by
        ``over``: ``steps`` steps of 8 x ``seq`` ``SyntheticLM``
        tokens (and the stub frontend's frames or patches, which ``train``
        draws), AdamW as phase 13 at base rate ``lr``, eagerly and from the
        train step's graph,
        each with the launch counts of ``per_train_step``; the graphed losses
        and grad norms must equal the eager ones bit for bit, and fall. Then,
        with ``ranges``, one eager step on the trained params, by
        ``record_function`` range, on the batch ``train`` would build for the
        next step (its ``_frontend_batch``, frontends included). Records the
        AdamW moments that stayed zero (leaves that took no gradient)."""
        cfg = dataclasses.replace(get(arch), **over)
        per_t = per_train_step(cfg)
        rec = {"cut": over, "steps": steps, "batch": 8, "seq": seq, "lr": lr,
               "launches_per_step": per_t}
        for mode, graphs_on, n in (("eager", False, steps),
                                   ("graphed", True, steps + WARMUP)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            fla.flash_attention_bwd_cuda.lse_forwards = 0
            out = drive(kern, totals, zero(**{k: v * n for k, v in per_t.items()}),
                        lambda: train(arch, smoke=False, steps=steps, batch=8,
                                      seq=seq, lr=lr, log_every=steps,
                                      device="cuda", graphs=graphs_on, overrides=over),
                        f"{what} ({mode})")
            run = rec[mode] = {
                "losses": out["losses"], "grad_norms": out["grad_norms"],
                "step_s": out["step_s"],
                "median_step_s": statistics.median(out["step_s"][1:]),
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "lse_forwards": fla.flash_attention_bwd_cuda.lse_forwards}
            run["tokens_per_s"] = 8 * seq / run["median_step_s"]
            losses = run["losses"]
            if run["lse_forwards"] != 0:
                fail(f"{what} ({mode}) ran {run['lse_forwards']} extra forwards for the "
                     "backward's log-sum-exp")
            if len(losses) != steps or not all(math.isfinite(x) for x in losses):
                fail(f"{what} ({mode}) losses not finite: {losses}")
            if not losses[-1] < losses[0]:
                fail(f"{what} ({mode}) loss did not fall: {losses}")
            if mode == "eager":
                del out
        rec["params"] = param_count(out["params"])
        rec["zero_moment_leaves"] = [path for path, m, _ in _paired_leaves(
            out["opt_state"]["mu"], out["opt_state"]["mu"]) if not bool(m.any())]
        rec["graphed"]["capture"] = capture_report(out["capture"], zero(**per_t), what)
        for key in ("losses", "grad_norms"):
            if rec["graphed"][key] != rec["eager"][key]:
                fail(f"{what}: graphed {key} {rec['graphed'][key]} differ from eager "
                     f"{rec['eager'][key]}")
        if ranges:
            opt = adamw(warmup_cosine(lr, warmup=1, total=steps))
            toks = torch.randint(0, cfg.vocab, (8, seq + 1),
                                 generator=torch.Generator().manual_seed(SEED + 4)).to("cuda")
            tb = _frontend_batch(out["cfg"], out["params"],
                                 {"inputs": toks[:, :-1], "labels": toks[:, 1:]},
                                 SEED, steps, seq, "cuda")
            step_e = make_train_step(out["cfg"], opt, device="cuda", graphs=False)
            rec["ranges"] = range_profile(lambda: step_e(out["params"], out["opt_state"], tb))
            full = {r: rec["ranges"][r]["full_size"] for r in ("clip", "optimizer")}
            if any(full.values()):
                fail(f"{what}: the clip or the optimizer ran full-size elementwise kernels "
                     f"beside csrc/adamw.cu's: {full}")
            del step_e
        del out
        torch.cuda.empty_cache()
        return rec

    def print_train(tag, rec, tail):
        e, g = rec["eager"], rec["graphed"]
        cap = g["capture"]
        print(f"{tag} ({rec['params'] / 1e9:.2f} B params), {rec['steps']} steps of "
              f"8x{rec['seq']} "
              f"through launch.train.train: median step eager {e['median_step_s'] * 1e3:.1f} "
              f"ms, graphed {g['median_step_s'] * 1e3:.1f} ms ({e['tokens_per_s']:.0f} -> "
              f"{g['tokens_per_s']:.0f} tokens/s); graphed losses and grad norms = eager "
              f"ones, bit for bit: loss {e['losses'][0]:.4f} -> {e['losses'][-1]:.4f}, "
              f"grad_norm {e['grad_norms'][0]:.3f} -> {e['grad_norms'][-1]:.3f}; peak device "
              f"memory eager {e['max_memory_allocated'] / 2**30:.2f} GiB, graphed "
              f"{g['max_memory_allocated'] / 2**30:.2f} GiB; capture {cap['capture_s']:.2f} s "
              f"after {cap['warmup_calls']} eager steps ({cap['warmup_s']:.2f} s), pool "
              f"{cap['pool_bytes'] / 2**30:.2f} GiB; launches per step and per replay: "
              + ", ".join(f"{k} {v}" for k, v in rec["launches_per_step"].items())
              + f"; losses {[round(x, 4) for x in e['losses']]} {tail}", flush=True)

    def print_pair(tag, rec, key, unit, tail):
        e, g = rec["eager"], rec["graphed"]
        cap = g["capture"]
        if "median_s" in e:
            extra = (f"median {e['median_s'] * 1e3:.1f} -> {g['median_s'] * 1e3:.1f} ms "
                     "after the first call; graphed logits = eager logits, bit for bit")
        else:
            extra = (f"{e['seconds']:.2f} -> {g['seconds']:.2f} s, graphed after its "
                     f"capture {g['steady_' + key]:.1f} {unit}; graphed tokens = eager tokens")
        print(f"{tag}: eager {e[key]:.1f}, graphed {g[key]:.1f} {unit} ({extra}); "
              f"capture {cap['capture_s'] * 1e3:.0f} ms after {cap['warmup_calls']} eager "
              f"calls ({cap['warmup_s'] * 1e3:.0f} ms), graph pool "
              f"{cap['pool_bytes'] / 2**20:.0f} MiB; launches per call and per replay: "
              + ", ".join(f"{k} {v}" for k, v in cap["launches_per_replay"].items() if v)
              + f" {tail}", flush=True)

    def parity(cfg32, p_cpu, p_gpu, rng, steps=8, frames=None):
        """Float32 logits card vs CPU: prefill (2 x 32 tokens; with the
        encoder-decoder's ``frames``; a vlm's also on ``embeds`` of image
        patches and the tokens) and teacher-forced decode steps (the
        encoder-decoder's from the cross K/V of its encoded frames)."""
        ptoks = torch.randint(0, cfg32.vocab, (2, 32), generator=rng)
        batch = {"inputs": ptoks} if frames is None else {"frames": frames, "inputs": ptoks}
        lg_cpu = make_prefill_step(cfg32, device="cpu")(p_cpu, batch)
        lg_gpu = make_prefill_step(cfg32, device="cuda")(p_gpu, batch).cpu()
        pre_err = float((lg_cpu - lg_gpu).abs().max())
        if cfg32.family == "vlm":
            patches = frontends.image_patches(rng, cfg32, 2, device="cpu")
            emb = {"embeds": frontends.fuse_vlm_inputs(p_cpu, patches, ptoks, cfg32)}
            e_cpu = make_prefill_step(cfg32, device="cpu")(p_cpu, emb)
            e_gpu = make_prefill_step(cfg32, device="cuda")(p_gpu, emb).cpu()
            pre_err = max(pre_err, float((e_cpu - e_gpu).abs().max()))
        api = model_api(cfg32)
        errs = []
        with torch.no_grad():
            if frames is None:
                c_cpu = api.init_cache(cfg32, 2, 16, device="cpu")
                c_gpu = api.init_cache(cfg32, 2, 16, device="cuda")
            else:
                c_cpu = api.init_cache(cfg32, 2, 16, encdec.encode(p_cpu, frames, cfg32),
                                       p_cpu, device="cpu")
                c_gpu = api.init_cache(cfg32, 2, 16, encdec.encode(
                    p_gpu, frames.cuda(), cfg32), p_gpu, device="cuda")
            for t in range(steps):
                a, c_cpu = api.decode_step(p_cpu, c_cpu, ptoks[:, t], t, cfg32)
                b, c_gpu = api.decode_step(p_gpu, c_gpu, ptoks[:, t].cuda(), t, cfg32)
                errs.append(float((a - b.cpu()).abs().max()))
        out = {"prefill_max_abs_err": pre_err, "decode_max_abs_err": errs,
               "tol": PARITY_TOL, "logit_abs_max": float(lg_cpu.abs().max())}
        if not (pre_err <= PARITY_TOL and max(errs) <= PARITY_TOL):
            fail(f"{cfg32.name} float32 card vs CPU logits differ: prefill "
                 f"{pre_err}, decode {errs}")
        return out

    def parity_launches(cfg, steps=8):
        """The launches of ``parity``: each prefill graphed (1 call +
        WARMUP; a vlm's twice: tokens and embeds), ``steps`` eager decode
        steps, and an encoder-decoder's encoder once more on the card for
        the cross K/V of its cache."""
        per = per_pass(cfg)
        n_pre = (1 + WARMUP) * (2 if cfg.family == "vlm" else 1)
        want = zero(rmsnorm=per["rmsnorm"] * n_pre + per["rmsnorm_step"] * steps,
                    flash_attention=per["flash"] * n_pre,
                    decode_attention=per["attn"] * steps, mamba_scan=per["mamba"] * n_pre)
        if cfg.is_encdec:
            want["rmsnorm"] += 2 * cfg.encoder_layers + 1
            want["flash_attention"] += cfg.encoder_layers
        return want

    def encdec_decode_pair(what, cfg, params, frames, first, n_steps):
        """Greedy decoding of ``n_steps`` tokens from ``first`` (B,) int32
        against the cross K/V of the encoded ``frames``
        (``init_cache(..., enc_states, params)``), eagerly and from the
        decode step's graph, each on a fresh cache: the same tokens; the
        launches of the encoder once and of ``per_pass`` each step. Seconds
        from the first step to the last token on the host, and from the end
        of the first step (which captures the graph, and first copies the
        cache it writes, cross K/V included, to pinned host memory) on."""
        api = model_api(cfg)
        per = per_pass(cfg)
        one = zero(rmsnorm=per["rmsnorm_step"], decode_attention=per["attn"])
        encoder = zero(rmsnorm=2 * cfg.encoder_layers + 1,
                       flash_attention=cfg.encoder_layers)
        rec = {"batch": len(first), "steps": n_steps, "launches_per_step": one}
        toks, steps = {}, {"eager": make_decode_step(cfg, device="cuda", graphs=False),
                           "graphed": make_decode_step(cfg, device="cuda")}

        def run(step):
            with torch.no_grad():
                enc = encdec.encode(params, frames, cfg)
            cache = api.init_cache(cfg, len(first), n_steps + 1, enc, params, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cur, out = first, []
            for t in range(n_steps):
                cur, _, _ = step(params, cache, cur, t)
                out.append(cur.cpu())
                if t == 0:
                    t1 = time.perf_counter()
            t_end = time.perf_counter()
            return torch.stack(out, 1), t_end - t0, t_end - t1

        for mode, n in (("eager", n_steps), ("graphed", n_steps + WARMUP)):
            want = {k: v * n + encoder[k] for k, v in one.items()}
            got, dt, dt_rest = drive(kern, totals, want, lambda: run(steps[mode]),
                                     f"{what} ({mode})")
            if tuple(got.shape) != (len(first), n_steps) or not bool(
                    ((0 <= got) & (got < cfg.vocab)).all()):
                fail(f"{what} ({mode}): bad tokens {got}")
            rec[mode] = {"seconds": dt, "new_tokens_per_s": got.numel() / dt,
                         "steps_per_s": n_steps / dt,
                         "steady_new_tokens_per_s": (n_steps - 1) * len(first) / dt_rest}
            toks[mode] = got
        cap = rec["graphed"]["capture"] = capture_report(graph_of(steps["graphed"]).stats,
                                                         one, what)
        steps["graphed"].release()
        if not torch.equal(toks["graphed"], toks["eager"]):
            fail(f"{what}: graphed tokens differ from eager ones")
        rec["tokens_equal"] = True
        return rec

    # 1. card and build
    card = subprocess.run(
        ["nvidia-smi", "-i", str(torch.cuda.current_device()),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    report.update(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                  build_s=build_s)
    report["kernel_build"] = sass = kernel_build_report(_build, _build.last_build["path"])
    if sass["hgmma_total"] == 0:
        fail(f"no HGMMA instruction in the bf16 flash-attention kernel: {sass}")
    # MLA's instances: bf16 DP 192 on the tensor cores (two consumer
    # warpgroups, registers moved to them by setmaxnreg), float32 24 and 192
    mla_inst = {MLA_INSTANCE: sass["ptxas"].get(MLA_INSTANCE),
                "f32 D24": sass["ptxas_flash_f32"].get("D24"),
                "f32 D192": sass["ptxas_flash_f32"].get("D192")}
    mla_sass = sass["flash_sass"].get(MLA_INSTANCE, {})
    if not sass["hgmma"].get(MLA_INSTANCE):
        fail(f"no HGMMA instruction in the bf16 D-192 flash instance: {sass['hgmma']}")
    if not all(mla_inst.values()):
        fail(f"no ptxas report of MLA's flash instances: {mla_inst}")
    if spill_bytes(mla_inst[MLA_INSTANCE]) or mla_sass.get("ldl_stl"):
        fail(f"the bf16 D-192 flash instance spills: ptxas {mla_inst[MLA_INSTANCE]}, "
             f"SASS {mla_sass}")
    if max(mla_sass.get("setmaxnreg") or [0]) != MLA_CONSUMER_REGS:
        fail(f"the bf16 D-192 flash instance's consumers do not take the plan's "
             f"{MLA_CONSUMER_REGS} registers with setmaxnreg: {mla_sass}")
    bwd_hgmma, bwd_spills = sass["flash_bwd_wgmma_hgmma"], sass["flash_bwd_wgmma_spill_bytes"]
    if len(bwd_hgmma) != 6 or not all(bwd_hgmma.values()):
        fail(f"a bf16 flash-backward instance has no HGMMA instruction: {bwd_hgmma}")
    if any(bwd_spills.get(lab) != 0 for lab in FLASH_BWD_MAIN + FLASH_BWD_MLA):
        fail(f"the DP 64 or DP 192 flash-backward instances spill: {bwd_spills}")
    bwd_f32_mla = {lab: sass["ptxas_flash_bwd"].get(lab) for lab in FLASH_BWD_F32_MLA}
    if not all(bwd_f32_mla.values()):
        fail(f"no ptxas report of the float32 backward at MLA's head dims: {bwd_f32_mla}")
    if not all(sass[k] for k in ("ptxas_decode", "ptxas_rmsnorm", "ptxas_scan",
                                 "ptxas_scan_bwd", "ptxas_flash_bwd", "ptxas_rmsnorm_bwd",
                                 "ptxas_adamw")):
        fail(f"no ptxas report of the decode, RMSNorm, scan, backward or AdamW "
             f"instances: {sass}")
    train_spills = {lab: sass[f"ptxas_{fam}"].get(lab) for fam, labs in TRAIN_MAIN.items()
                    for lab in labs}
    if any(v is None or spill_bytes(v) for v in train_spills.values()):
        fail(f"a train-step instance is missing or spills: {train_spills}")
    scan_sass = sass["scan_sass"]
    if any(lab not in scan_sass for lab in (SCAN_MAIN, *SCAN_TRAIN)) or any(
            v["spill_bytes"] is None for v in scan_sass.values()):
        fail(f"no SASS or spill report of the scan instances: {scan_sass}")
    spilled = {k: v for k, v in scan_sass.items()
               if v["spill_bytes"] or v["ldl_stl"]}
    # the scan's launch plan on this card: resident blocks per SM of each
    # instance, and the waves of Jamba's prefill (8 x 16384 channels)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    sass["scan_blocks_per_sm"] = occ = {
        f"{'bf16' if dt == torch.bfloat16 else 'f32'} N{n}": scan.blocks_per_sm(n, dt)
        for dt in (torch.bfloat16, torch.float32) for n in (4, 8, 16)}
    sass["scan_waves"] = waves = (8 * 16384 / scan.CHANNELS_PER_BLOCK
                                  / (n_sm * occ[SCAN_MAIN]))
    # the backward's: its plan is BWD_BLOCKS_PER_SM (16 warps an SM)
    sass["scan_bwd_blocks_per_sm"] = bwd_occ = {
        f"bwd {'bf16' if dt == torch.bfloat16 else 'f32'} N{n}": scan.bwd_blocks_per_sm(n, dt)
        for dt in (torch.bfloat16, torch.float32) for n in (4, 8, 16)}
    print(f"[1 card] {card} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | kernels built in {build_s:.1f} s (cached={_build.last_build['cached']})"
          f" | bf16 flash kernel, HGMMA instructions: {sass['hgmma_total']} "
          f"{sass['hgmma']}; ptxas: {sass['ptxas']}; MLA's instances (HGMMA "
          f"{sass['hgmma'][MLA_INSTANCE]} in {MLA_INSTANCE}, setmaxnreg "
          f"{mla_sass['setmaxnreg_sass']} (consumers: plan {MLA_CONSUMER_REGS}), LDL/STL "
          f"{mla_sass['ldl_stl']}): "
          + ", ".join(f"{k} {v}" for k, v in mla_inst.items())
          + f"; float32 flash ptxas: {sass['ptxas_flash_f32']}; decode attention ptxas: "
          f"{sass['ptxas_decode']}; RMSNorm ptxas: {sass['ptxas_rmsnorm']}; "
          f"scan ptxas: {sass['ptxas_scan']}; scan backward ptxas: "
          f"{sass['ptxas_scan_bwd']}; bf16 flash backward (wgmma) ptxas: "
          f"{sass['ptxas_flash_bwd_wgmma']}, HGMMA {bwd_hgmma}, spill bytes {bwd_spills} "
          f"(MLA's DP 192: " + ", ".join(f"{lab} {sass['ptxas_flash_bwd_wgmma'].get(lab)}, "
                                        f"HGMMA {bwd_hgmma.get(lab)}" for lab in FLASH_BWD_MLA)
          + "; float32 at MLA's head dims: " + ", ".join(
              f"{k} {v}" for k, v in bwd_f32_mla.items()) + "); "
          f"backward ptxas: flash (simt) "
          f"{sass['ptxas_flash_bwd']}, RMSNorm {sass['ptxas_rmsnorm_bwd']}; clip and "
          f"AdamW ptxas: {sass['ptxas_adamw']}; "
          f"scan SASS (instructions, "
          f"MUFU.EX2, SHFL, LDL/STL): " + ", ".join(
              f"{k} {v['instructions']}/{v['mufu_ex2']}/{v['shfl']}/{v['ldl_stl']}"
              for k, v in sorted(scan_sass.items()))
          + f"; scan blocks per SM {occ}, Jamba prefill {waves:.2f} waves on "
          f"{n_sm} SMs; scan backward blocks per SM {bwd_occ} (plan "
          f"{scan.BWD_BLOCKS_PER_SM}); compiler warnings: {sass['warnings'] or 'none'} "
          f"{took('1 card')}",
          flush=True)
    if spilled:
        fail(f"scan instances spill (the main paths' are {SCAN_MAIN}, {SCAN_TRAIN}): "
             f"{spilled}")
    if min(occ.values()) < scan.BLOCKS_PER_SM:
        fail(f"scan instances hold fewer than {scan.BLOCKS_PER_SM} blocks per SM: {occ}")
    if min(bwd_occ.values()) < scan.BWD_BLOCKS_PER_SM:
        fail(f"scan backward instances hold fewer than {scan.BWD_BLOCKS_PER_SM} blocks per "
             f"SM: {bwd_occ}")

    # 2. kernels against their plain versions
    rows = phase_kernels(rms, fla, dec, scan)
    report["kernels"] = rows
    for r in rows:
        timing = "" if "ms" not in r else (
            f" | device ms {r['ms']:.4f} over {r['kernels_per_call']:g} kernel(s) "
            f"a call (back-to-back {r['launch_ms']:.4f}) bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']}; "
            + ", ".join(f"{k} {v:.4f}" for k, v in r["bound_terms"].items())
            + f") plain {r['plain_ms']:.4f} library "
            f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)}")
        if "split_sweep_ms" in r:
            timing += (f" | splits (n_split, chunk) {tuple(r['split_plan'])}; device ms "
                       "by n_split " + ", ".join(f"{n}: {ms:.4f}" for n, ms
                                                 in r["split_sweep_ms"].items()))
        if r.get("sm_clock_mhz"):
            timing += f" | SM clock {r['sm_clock_mhz']:.0f} MHz back to back"
        if "kernel_ms" in r:
            timing += " | by kernel " + ", ".join(
                f"{k} {v:.4f}" for k, v in r["kernel_ms"].items())
        inst = f" ({r['instance']})" if "instance" in r else ""
        dscale = (f", dscale rel err {r['dscale_rel_err']:.2e} (tol {DSCALE_TOL:g})"
                  if "dscale_rel_err" in r else "")
        if "mv_rel_err" in r:
            dscale += (f", m/v rel err {r['mv_rel_err']:.2e} (tol {ADAMW_MV_TOL:g}), "
                       f"params bit-equal {r['bit_equal_share']:.4%}"
                       + (f", max {r['p_max_ulps']:.2f} bf16 ulp" if "p_max_ulps" in r else "")
                       + f"; library: {r['library']}")
        if "scale" in r:
            dscale += f", scale {r['scale']:.6f}"
        if "label" in r:
            dscale += f" [{r['label']}]"
        if "scaled" in r:
            dscale += "; per output, rms(plain) / max|plain| / max_abs_err / err over " \
                "limit: " + ", ".join(
                    f"{h['rms_plain']:.4f} / {h['max_abs_plain']:.4f} / "
                    f"{h['max_abs_err']:.3e} / {h['err_over_limit']:.3f}" for h in r["scaled"])
        tol = r["tol"] if isinstance(r["tol"], str) else f"{r['tol']:g}"
        print(f"[2 kernel] {r['kernel']}{inst} {r['case']} {r['dtype']}: max_abs_err "
              f"{r['max_abs_err']:.3e} (tol {tol}){dscale}{timing}", flush=True)
    bad = [f"{r['kernel']} {r['case']} {r['dtype']}" for r in rows if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    many = [f"{r['kernel']} {r['case']} {r['dtype']}: {r['kernels_per_call']}"
            for r in rows if "ms" in r and r["kernel"] in ("decode_attention", "rmsnorm")
            and r["kernels_per_call"] != 1]
    many += [f"{r['kernel']} {r['case']} {r['dtype']}: {r['kernels_per_call']}"
             for r in rows if "ms" in r and r["kernel"].endswith("_bwd")
             and r["kernels_per_call"] != 2]
    n_leaves = per_train_step(get("smollm_360m"))["adamw_update"]
    many += [f"{r['kernel']} {r['case']} {r['dtype']}: {r['kernels_per_call']}"
             for r in rows if "ms" in r
             and r["kernel"] in ("sumsq", "clip_finalize", "adamw_update")
             and r["kernels_per_call"] != (1 if r["kernel"] == "clip_finalize" else n_leaves)]
    if many:
        fail(f"a decode-attention or RMSNorm call ran other than one kernel, a "
             f"backward call other than two, or a pass of the clip or AdamW other than "
             f"one kernel a leaf (one finalize): {many}")
    print(f"[2 kernels] {len(rows)} rows agree {took('2 kernels')}", flush=True)

    # 3. smollm-360M: full-width prefill, bf16, eager and from its graph
    cfg = get("smollm_360m")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = transformer.init(gen, cfg, device="cuda")
    toks = torch.randint(0, cfg.vocab, (8, 512), generator=gen, device="cuda")
    report["prefill"], eager_prefill, prefill = prefill_pair(
        "smollm prefill", cfg, params, {"inputs": toks}, 4)
    print_pair("[3 prefill] smollm-360M bf16 8x512", report["prefill"], "tokens_per_s",
               "tokens/s", took("3 prefill"))

    # 4. smollm-360M: serving, bf16, eager and from the decode step's graph
    rng = torch.Generator().manual_seed(SEED + 1)
    steps = 64 + 64
    report["serve"] = serve_pair("smollm serving", cfg, params,
                                 [r.prompt for r in requests(cfg, rng)], 64)
    print_pair("[4 serve] smollm-360M bf16, 8 requests x (64 prompt + 64 new)",
               report["serve"], "new_tokens_per_s", "new tokens/s", took("4 serve"))

    # 5. smollm-360M: float32 parity, card against CPU, full width
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p_cpu = transformer.init(torch.Generator().manual_seed(SEED), cfg32,
                             device="cpu")
    p_gpu = tree_map(lambda a: a.to("cuda"), p_cpu)
    report["parity"] = par = parity(cfg32, p_cpu, p_gpu, rng)
    print(f"[5 parity] float32 full width, card vs CPU: prefill last-token logits"
          f" max_abs_err {par['prefill_max_abs_err']:.3e}, decode 8 steps "
          f"max_abs_err {max(par['decode_max_abs_err']):.3e} (tol {PARITY_TOL:g}; "
          f"|logits| up to {par['logit_abs_max']:.3f}) {took('5 parity')}",
          flush=True)
    del p_gpu, p_cpu

    # 6. smollm-360M: where the time goes, one prefill, one decode step (bf16),
    # eager and graphed; the kernels of one replay against one eager call
    report["profile"] = prof = profile_pair("smollm", cfg, params, {"inputs": toks},
                                            toks[:, 0], eager_prefill, prefill)
    print_profile(f"[6 profile] {took('6 profile')}", prof)
    prefill.release()
    del params, prefill, eager_prefill
    torch.cuda.empty_cache()

    # 7. Jamba (dense FFN, one period): full-width prefill, bf16
    jcfg = dataclasses.replace(get("jamba_1_5_large_398b"), **JAMBA_DENSE)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    jparams = transformer.init(gen, jcfg, device="cuda")
    n_params, p_bytes = param_count(jparams), param_bytes(jparams)
    jtoks = torch.randint(0, jcfg.vocab, (8, 512), generator=gen, device="cuda")
    report["jamba"] = {"cut": "8 layers (attn + 7 mamba), dense SwiGLU FFN of "
                              "d_ff 24576 for MoE; widths as published",
                       "params": n_params, "param_bytes": p_bytes}
    report["jamba"]["prefill"], jeager, jprefill = prefill_pair(
        "jamba prefill", jcfg, jparams, {"inputs": jtoks}, 3)
    print_pair(f"[7 jamba prefill] jamba-1.5-large widths, 8 layers, dense FFN "
               f"({n_params / 1e9:.2f} B params, {p_bytes / 1e9:.1f} GB bf16) 8x512",
               report["jamba"]["prefill"], "tokens_per_s", "tokens/s",
               took("7 jamba prefill"))

    # 8. Jamba: serving, bf16 (prompts prefill through decode steps, so the
    # Mamba layers take mamba_step and no scan)
    report["jamba"]["serve"] = serve_pair(
        "jamba serving", jcfg, jparams, [r.prompt for r in requests(jcfg, rng)], 64)
    print_pair("[8 jamba serve] 8 requests x (64 prompt + 64 new)",
               report["jamba"]["serve"], "new_tokens_per_s", "new tokens/s",
               took("8 jamba serve"))

    # 9. Jamba: where the time goes, one prefill, one decode step (bf16)
    report["jamba"]["profile"] = prof = profile_pair("jamba", jcfg, jparams,
                                                     {"inputs": jtoks}, jtoks[:, 0],
                                                     jeager, jprefill)
    print_profile(f"[9 jamba profile] {took('9 jamba profile')}", prof)
    jprefill.release()
    del jparams, jprefill, jeager
    torch.cuda.empty_cache()

    # 10. Jamba: float32 parity card vs CPU at full width, cut to 2 layers;
    # drawn on the card (fast) and copied to the CPU
    pcfg = dataclasses.replace(jcfg, **JAMBA_PARITY)
    p_gpu = transformer.init(torch.Generator(device="cuda").manual_seed(SEED),
                             pcfg, device="cuda")
    p_cpu = tree_map(lambda a: a.cpu(), p_gpu)
    report["jamba"]["parity"] = par = parity(pcfg, p_cpu, p_gpu, rng)
    par.update(cut="2 layers: (attn, mlp), (mamba, mlp)",
               params=param_count(p_gpu))
    print(f"[10 jamba parity] float32, full width cut to 2 layers (attention "
          f"+ Mamba, {par['params'] / 1e9:.2f} B params), card vs CPU: prefill"
          f" max_abs_err {par['prefill_max_abs_err']:.3e}, decode 8 steps "
          f"max_abs_err {max(par['decode_max_abs_err']):.3e} (tol {PARITY_TOL:g};"
          f" |logits| up to {par['logit_abs_max']:.3f}) {took('10 jamba parity')}",
          flush=True)
    del p_gpu, p_cpu
    torch.cuda.empty_cache()

    # 11. xlstm-125m: full width and depth, prefill and serving (bf16), eager
    # and graphed (the sLSTM loop over time runs inside the graph)
    xcfg = get("xlstm_125m")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    xparams = transformer.init(gen, xcfg, device="cuda")
    xtoks = torch.randint(0, xcfg.vocab, (8, 512), generator=gen, device="cuda")
    pre, _, xprefill = prefill_pair("xlstm prefill", xcfg, xparams, {"inputs": xtoks}, 2)
    xprefill.release()
    report["xlstm"] = {"params": param_count(xparams), "prefill": pre}
    report["xlstm"]["serve"] = serve_pair(
        "xlstm serving", xcfg, xparams, [r.prompt for r in requests(xcfg, rng)], 64)
    print_pair("[11 xlstm] xlstm-125m bf16: prefill 8x512", pre, "tokens_per_s",
               "tokens/s", "")
    print_pair("[11 xlstm] serving 8 x (64 + 64)", report["xlstm"]["serve"],
               "new_tokens_per_s", "new tokens/s", took("11 xlstm"))
    del xparams, xprefill
    torch.cuda.empty_cache()

    # 12. the SMOKE configs (head dims 16 and 20) on the card: the server's
    # defaults (smollm SMOKE: 8 requests x (16 prompt + 32 new)), graphed and
    # eager; h2o-danube SMOKE serving past its window of 16, graphed and
    # eager; then float32 logits card vs CPU for smollm, h2o-danube and Jamba
    # (dense FFN)
    scfg = get("smollm_360m", smoke=True)
    per = per_pass(scfg)
    n12 = 16 + 32
    one = zero(rmsnorm=per["rmsnorm_step"], decode_attention=per["attn"])
    served = {}
    for mode, argv, n in (("graphed", [], n12 + WARMUP), ("eager", ["--eager"], n12)):
        served[mode] = drive(kern, totals, {k: v * n for k, v in one.items()},
                             lambda: serve_mod.main(argv), f"serve.main({argv})")
    if not all(np.array_equal(a.out, b.out) for a, b in zip(served["graphed"],
                                                            served["eager"])):
        fail("serve.main([]): graphed tokens differ from eager ones")
    report["smoke"] = smoke = {"serve_main": "graphed tokens = eager tokens"}
    dcfg = get("h2o_danube_1_8b", smoke=True)
    dparams = transformer.init(torch.Generator(device="cuda").manual_seed(SEED),
                               dcfg, device="cuda")
    smoke["danube_serve"] = serve_pair(
        "danube SMOKE serving", dcfg, dparams,
        [torch.randint(0, dcfg.vocab, (16,), generator=rng, dtype=torch.int32).numpy()
         for _ in range(8)], 32)
    del dparams
    for name, over in (("smollm_360m", {}), ("h2o_danube_1_8b", {}),
                       ("jamba_1_5_large_398b", JAMBA_DENSE)):
        c = dataclasses.replace(get(name, smoke=True), **over)
        p_cpu = transformer.init(torch.Generator().manual_seed(SEED), c, device="cpu")
        smoke[name] = parity(c, p_cpu, tree_map(lambda a: a.to("cuda"), p_cpu), rng)
        smoke[name]["head_dim"] = c.hd
    # the MoE SMOKE configs (Jamba with its real MoE layers), whisper and
    # llava: serve.main graphed and eager with equal tokens, then float32
    # logits card vs CPU (whisper's with frames and real cross K/V, llava's
    # also on embeds); DeepSeek's prefill runs the float32 flash instance of
    # head dim 24
    for arch in ("deepseek_v3_671b", "qwen3_moe_235b_a22b", "jamba_1_5_large_398b",
                 "whisper_small", "llava_next_mistral_7b"):
        c = get(arch, smoke=True)
        per = per_pass(c)
        one = zero(rmsnorm=per["rmsnorm_step"], decode_attention=per["attn"])
        out = {}
        for mode, argv, n in (("graphed", ["--arch", arch], n12 + WARMUP),
                              ("eager", ["--arch", arch, "--eager"], n12)):
            out[mode] = drive(kern, totals, {k: v * n for k, v in one.items()},
                              lambda: serve_mod.main(argv), f"serve.main({argv})")
        if not all(np.array_equal(a.out, b.out) for a, b in zip(out["graphed"],
                                                                out["eager"])):
            fail(f"serve.main(['--arch', {arch!r}]): graphed tokens differ from eager ones")
        key = f"{arch} (MoE)" if arch.startswith("jamba") else arch
        p_cpu = model_api(c).init(torch.Generator().manual_seed(SEED), c, device="cpu")
        frames = (frontends.audio_frames(rng, c, 2, device="cpu") if c.is_encdec
                  else None)
        want = parity_launches(c)
        smoke[key] = drive(kern, side, want, lambda: parity(
            c, p_cpu, tree_map(lambda a: a.to("cuda"), p_cpu), rng, frames=frames),
            f"{key} SMOKE parity")
        smoke[key].update(head_dim=c.qk_nope_head_dim + c.qk_rope_head_dim
                          if c.mla else c.hd, serve_main="graphed tokens = eager tokens")
        if arch == "deepseek_v3_671b":
            mla_totals["flash_attention_f32_d24"] += want["flash_attention"]
    print(f"[12 smoke] serve.main([]) (smollm SMOKE, head dim 20, on cuda): graphed "
          f"tokens = eager tokens; h2o-danube SMOKE serving 8 x (16 + 32), past its "
          f"window of 16: graphed tokens = eager tokens, "
          f"{smoke['danube_serve']['graphed']['new_tokens_per_s']:.1f} against "
          f"{smoke['danube_serve']['eager']['new_tokens_per_s']:.1f} new tokens/s; "
          "serve.main graphed tokens = eager tokens for the DeepSeek, Qwen3-MoE, "
          "Jamba (real MoE), whisper and llava SMOKE configs; "
          "float32 SMOKE logits card vs CPU: " + "; ".join(
              f"{n} (hd {v['head_dim']}) prefill {v['prefill_max_abs_err']:.3e}, decode "
              f"{max(v['decode_max_abs_err']):.3e}" for n, v in smoke.items()
              if "prefill_max_abs_err" in v)
          + f" (tol {PARITY_TOL:g}) {took('12 smoke')}", flush=True)

    # 13. smollm-360M training at full width and depth, bf16, 8 x 512 tokens
    # a step, through the trainer's entry point: eager, then from its graph
    cfg = get("smollm_360m")
    per_t = per_train_step(cfg)       # 129 / 65 RMSNorm, 64 / 32 attention
    report["train"] = tr = {"steps": TRAIN_STEPS, "batch": 8, "seq": 512,
                            "launches_per_step": per_t}
    for mode, graphs_on, n in (("eager", False, TRAIN_STEPS),
                               ("graphed", True, TRAIN_STEPS + WARMUP)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fla.flash_attention_bwd_cuda.lse_forwards = 0
        out = drive(kern, totals, zero(**{k: v * n for k, v in per_t.items()}),
                    lambda: train("smollm_360m", smoke=False, steps=TRAIN_STEPS,
                                  batch=8, seq=512, log_every=TRAIN_STEPS // 2,
                                  device="cuda", graphs=graphs_on),
                    f"smollm training ({mode})")
        run = tr[mode] = {
            "losses": out["losses"], "grad_norms": out["grad_norms"],
            "step_s": out["step_s"], "median_step_s": statistics.median(out["step_s"][1:]),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "lse_forwards": fla.flash_attention_bwd_cuda.lse_forwards}
        run["tokens_per_s"] = 8 * 512 / run["median_step_s"]
        if run["lse_forwards"] != 0:
            fail(f"training ({mode}) ran {run['lse_forwards']} extra forwards for the "
                 "backward's log-sum-exp (the forward's L was not passed)")
        losses = run["losses"]
        if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
            fail(f"training ({mode}) losses not finite: {losses}")
        if not losses[-1] < losses[0]:
            fail(f"training ({mode}) loss did not fall: {losses}")
        if mode == "eager":
            del out
    tr["graphed"]["capture"] = capture_report(out["capture"], zero(**per_t),
                                              "smollm training")
    for key in ("losses", "grad_norms"):
        if tr["graphed"][key] != tr["eager"][key]:
            fail(f"training: graphed {key} {tr['graphed'][key]} differ from eager "
                 f"{tr['eager'][key]}")
    # one step, eager and replayed, profiled on the trained params
    opt = adamw(warmup_cosine(3e-4, warmup=max(TRAIN_STEPS // 10, 1), total=TRAIN_STEPS))
    src = torch.Generator().manual_seed(SEED + 2)
    toks = torch.randint(0, cfg.vocab, (8, 513), generator=src).to("cuda")
    tb = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    step_e = make_train_step(out["cfg"], opt, device="cuda", graphs=False)
    step_g = make_train_step(out["cfg"], opt, device="cuda")
    step_g(out["params"], out["opt_state"], tb)
    g = graph_of(step_g)
    groups = ("flash_bwd", "flash_attention_wgmma")
    tr["profile"] = {
        "eager": profile_call(lambda: step_e(*g.args), groups=groups),
        "graphed": profile_call(lambda: step_g(out["params"], out["opt_state"], tb),
                                groups=groups),
        "replay_check": {"train_step": replay_check("train step", g, step_e, iters=3)},
        "ranges": range_profile(lambda: step_e(*g.args))}
    step_g.release()
    del out, step_g, g
    torch.cuda.empty_cache()
    e, gr = tr["eager"], tr["graphed"]
    cap = gr["capture"]
    print(f"[13 train] smollm-360M bf16, {TRAIN_STEPS} steps of 8x512 through "
          f"launch.train.train: median step eager {e['median_step_s'] * 1e3:.1f} ms, "
          f"graphed {gr['median_step_s'] * 1e3:.1f} ms (after step 0; "
          f"{e['tokens_per_s']:.0f} -> {gr['tokens_per_s']:.0f} tokens/s); graphed "
          f"losses and grad norms = eager ones, bit for bit: loss {e['losses'][0]:.4f} -> "
          f"{e['losses'][-1]:.4f}, grad_norm {e['grad_norms'][0]:.3f} -> "
          f"{e['grad_norms'][-1]:.3f}; peak device memory eager "
          f"{e['max_memory_allocated'] / 2**30:.2f} GiB, graphed "
          f"{gr['max_memory_allocated'] / 2**30:.2f} GiB; capture {cap['capture_s']:.2f} s "
          f"after {cap['warmup_calls']} eager steps ({cap['warmup_s']:.2f} s), pool "
          f"{cap['pool_bytes'] / 2**30:.2f} GiB; launches per step and per replay: "
          + ", ".join(f"{k} {v}" for k, v in per_t.items())
          + f"; losses {[round(x, 4) for x in e['losses']]}; extra forwards for L 0 "
          f"{took('13 train')}", flush=True)
    print_profile("[13 train profile]", tr["profile"])
    print_ranges("[13 train ranges]", tr["profile"]["ranges"])
    full = {r: tr["profile"]["ranges"][r]["full_size"] for r in ("clip", "optimizer")}
    if any(full.values()):
        fail(f"the clip or the optimizer ran full-size elementwise kernels beside "
             f"csrc/adamw.cu's: {full}")

    # 14. float32 train-step parity, card vs CPU, full width cut to 2 layers
    pcfg = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    p_cpu = transformer.init(torch.Generator().manual_seed(SEED), pcfg, device="cpu")
    p_gpu = tree_map(lambda a: a.to("cuda"), p_cpu)
    toks = torch.randint(0, pcfg.vocab, (2, 129), generator=src)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    report["train_parity"] = tp = train_parity(
        pcfg, p_cpu, p_gpu, batch, model_api(pcfg).loss, make_train_step, adamw)
    if not tp["ok"]:
        fail(f"float32 training card vs CPU differs: {tp}")
    # decode attention, which has no backward kernel, refuses a gradient
    # rather than cut the graph; the scan's gradient goes through its
    # training forward and backward kernels and equals autograd's of the
    # plain scan (float32, 1e-4)
    q = torch.randn(2, 6, 64, device="cuda", requires_grad=True)
    kv = torch.randn(2, 2, 40, 64, device="cuda")
    try:
        ops.decode_attention(q, kv, kv)
    except NotImplementedError:
        tp["no_backward_raises"] = ["decode_attention"]
    else:
        fail("decode_attention ran with a gradient asked")
    sg = torch.Generator(device="cuda").manual_seed(SEED + 7)
    sargs = [torch.randn(shape, generator=sg, device="cuda")
             for shape in ((1, 40, 32), (1, 40, 32), (32, 4), (1, 40, 4), (1, 40, 4), (32,),
                           (1, 32, 4))]
    sargs[1], sargs[2] = F.softplus(sargs[1]), -torch.exp(sargs[2])
    sdy = torch.randn((1, 40, 32), generator=sg, device="cuda")
    scan_grads = {}
    for how, fn in (("kernel", ops.mamba_scan), ("plain", scan.mamba_scan_plain)):
        leaves = [x.clone().requires_grad_(True) for x in sargs]
        scan_grads[how] = torch.autograd.grad(fn(*leaves)[0], leaves, sdy)
    tp["scan_grad_max_abs_err"] = max(float((a - b).abs().max()) for a, b in zip(
        scan_grads["kernel"], scan_grads["plain"]))
    if not all(bool(((a - b).abs() <= 1e-4 + 1e-4 * b.abs()).all())
               for a, b in zip(scan_grads["kernel"], scan_grads["plain"])):
        fail(f"the scan's gradient on the card differs from the plain scan's: "
             f"{tp['scan_grad_max_abs_err']}")
    print(f"[14 train parity] float32, full width cut to 2 layers ({tp['params'] / 1e6:.1f}"
          f" M params), batch 2x128, card vs CPU: loss {tp['loss_cpu']:.6f} (err "
          f"{tp['loss_err']:.2e}, tol {LOSS_TOL:g}), grad_norm err {tp['grad_norm_rel_err']:.2e}"
          f" relative, {tp['leaves']} gradient leaves, worst {tp['worst_grad']} at "
          f"{tp['worst_grad_ratio']:.3f} of its tolerance ({GRAD_TOL:g} max|g| + 1e-6); "
          f"params after one AdamW step: max err {tp['param_max_err']:.2e} (tol "
          f"{tp['param_tol']:.2e}), {tp['param_share_within_1e-6']:.4%} within 1e-6; "
          f"decode_attention raises for a gradient; the scan's gradient through its "
          f"kernels max err {tp['scan_grad_max_abs_err']:.2e} (tol 1e-4) "
          f"{took('14 train parity')}",
          flush=True)
    del p_cpu, p_gpu
    torch.cuda.empty_cache()

    # 15. DeepSeek-V3 at its published widths, cut to 5 layers (3 dense-FFN
    # MLA layers + 2 MLA + MoE layers) without the MTP module: prefill 8 x
    # 512, bf16, eager and graphed. Every earlier model, graph and cached
    # block is released first: the weights take 53 GB of the card.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dcfg = dataclasses.replace(get("deepseek_v3_671b"), **DEEPSEEK_CUT)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t_init = time.perf_counter()
    dparams = transformer.init(gen, dcfg, device="cuda")
    torch.cuda.synchronize()
    report["deepseek"] = ds = {
        "cut": "5 layers (first_k_dense 3 + 2 MLA + MoE), mtp off; widths as published",
        "params": param_count(dparams), "param_bytes": param_bytes(dparams),
        "init_s": time.perf_counter() - t_init,
        "init_peak_bytes": torch.cuda.max_memory_allocated()}
    dtoks = torch.randint(0, dcfg.vocab, (8, 512), generator=gen, device="cuda")
    n_flash = totals["flash_attention"]
    ds["prefill"], deager, dprefill = prefill_pair("deepseek prefill", dcfg, dparams,
                                                   {"inputs": dtoks}, 3)
    print_pair(f"[15 deepseek prefill] deepseek-v3 widths, 5 layers, no MTP "
               f"({ds['params'] / 1e9:.2f} B params, {ds['param_bytes'] / 1e9:.1f} GB "
               f"bf16, drawn in {ds['init_s']:.1f} s, peak "
               f"{ds['init_peak_bytes'] / 2**30:.2f} GiB while drawn) 8x512",
               ds["prefill"], "tokens_per_s", "tokens/s", took("15 deepseek prefill"))

    # 16. DeepSeek-V3: serving 8 requests x (64 + 64), eager and graphed (a
    # decode step routes 8 tokens to capacity 1 per expert and multiplies
    # every expert, as the reference's dispatch does)
    ds["serve"] = serve_pair("deepseek serving", dcfg, dparams,
                             [r.prompt for r in requests(dcfg, rng)], 64)
    print_pair("[16 deepseek serve] 8 requests x (64 prompt + 64 new)", ds["serve"],
               "new_tokens_per_s", "new tokens/s", took("16 deepseek serve"))

    # 17. DeepSeek-V3: where the time goes, one prefill, one decode step
    ds["profile"] = prof = profile_pair("deepseek", dcfg, dparams, {"inputs": dtoks},
                                        dtoks[:, 0], deager, dprefill)
    print_profile(f"[17 deepseek profile] {took('17 deepseek profile')}", prof)
    dprefill.release()
    mla_totals["flash_attention_d192"] += totals["flash_attention"] - n_flash

    # 18. DeepSeek-V3: peak device memory of phases 15-17
    ds["peak_bytes"] = torch.cuda.max_memory_allocated()
    ds["card_bytes"] = torch.cuda.get_device_properties(0).total_memory
    print(f"[18 deepseek memory] peak allocated {ds['peak_bytes'] / 2**30:.2f} GiB of "
          f"{ds['card_bytes'] / 2**30:.2f} GiB (while the weights were drawn "
          f"{ds['init_peak_bytes'] / 2**30:.2f} GiB; weights "
          f"{ds['param_bytes'] / 2**30:.2f} GiB) {took('18 deepseek memory')}", flush=True)
    del dparams, dprefill, deager
    torch.cuda.empty_cache()

    # 19. float32 parity of one full-width MLA block (the dense prefix's:
    # MLA + SwiGLU of d_ff 18432), card vs CPU: block_apply over 2 x 16
    # tokens, then 8 teacher-forced block_decode steps (absorbed), each
    # step also against block_apply's output at its position
    bcfg = dataclasses.replace(dcfg, dtype="float32")
    spec = ("mla", "mlp")
    bp_gpu = transformer.block_init(torch.Generator(device="cuda").manual_seed(SEED),
                                    spec, bcfg, torch.float32, "cuda")
    bp_cpu = tree_map(lambda a: a.cpu(), bp_gpu)
    xb = torch.randn((2, 16, bcfg.d_model), generator=torch.Generator().manual_seed(SEED + 3))
    pos = torch.arange(16)
    mla = {"params": param_count(bp_cpu), "tol": PARITY_TOL}
    with torch.no_grad():
        y_cpu, _ = transformer.block_apply(bp_cpu, xb, spec, bcfg, pos)
        per_blk = {"rmsnorm": 4, "flash_attention": 1}       # ln1, q/kv norms, ln2
        want = zero(rmsnorm=per_blk["rmsnorm"] * 9, flash_attention=1)
        c_cpu = transformer.block_make_cache(spec, bcfg, 2, 16, torch.float32, "cpu")
        c_gpu = transformer.block_make_cache(spec, bcfg, 2, 16, torch.float32, "cuda")

        def card():
            y, _ = transformer.block_apply(bp_gpu, xb.cuda(), spec, bcfg, pos.cuda())
            steps = [transformer.block_decode(bp_gpu, xb[:, t].cuda(), c_gpu, spec, bcfg,
                                              torch.tensor(t, device="cuda"))[0]
                     for t in range(8)]
            return y.cpu(), [a.cpu() for a in steps]

        y_gpu, dec_gpu = drive(kern, side, want, card, "MLA block parity")
        mla_totals["flash_attention_f32_d192"] += want["flash_attention"]
        dec_cpu = [transformer.block_decode(bp_cpu, xb[:, t], c_cpu, spec, bcfg,
                                            torch.tensor(t))[0] for t in range(8)]
    mla["apply_max_abs_err"] = float((y_gpu - y_cpu).abs().max())
    mla["decode_max_abs_err"] = [float((a - b).abs().max()) for a, b in zip(dec_gpu, dec_cpu)]
    mla["decode_vs_apply"] = max(float((dec_gpu[t] - y_gpu[:, t]).abs().max())
                                 for t in range(8))
    mla["cache_max_abs_err"] = max(float((c_gpu[k].cpu() - c_cpu[k]).abs().max())
                                   for k in c_cpu)
    mla["out_abs_max"] = float(y_cpu.abs().max())
    ds["mla_parity"] = mla
    if not (mla["apply_max_abs_err"] <= PARITY_TOL
            and max(mla["decode_max_abs_err"]) <= PARITY_TOL
            and mla["cache_max_abs_err"] <= PARITY_TOL
            and mla["decode_vs_apply"] <= PARITY_TOL):
        fail(f"the full-width MLA block differs card vs CPU: {mla}")
    print(f"[19 mla parity] float32, one full-width MLA block (+ SwiGLU d_ff "
          f"{bcfg.d_ff}, {mla['params'] / 1e6:.1f} M params), card vs CPU: block_apply "
          f"2x16 max_abs_err {mla['apply_max_abs_err']:.3e}, 8 absorbed decode steps "
          f"{max(mla['decode_max_abs_err']):.3e}, compressed cache "
          f"{mla['cache_max_abs_err']:.3e}; decode against block_apply on the card "
          f"{mla['decode_vs_apply']:.3e} (tol {PARITY_TOL:g}; |out| up to "
          f"{mla['out_abs_max']:.3f}) {took('19 mla parity')}", flush=True)
    del bp_gpu, bp_cpu, c_gpu
    torch.cuda.empty_cache()

    # 20. DeepSeek-V3 training at its published widths, cut to its 3 dense
    # prefix layers (MLA + SwiGLU; n_periods 0, an empty stack) without the
    # MTP module: the bf16 D-192 flash backward on the train step's path
    report["moe_train"] = mt = {}
    n_bwd = totals["flash_attention_bwd"]
    mt["deepseek"] = train_pair("deepseek_v3_671b", DEEPSEEK_TRAIN_CUT,
                                "DeepSeek-V3 training")
    mla_totals["flash_attention_bwd_d192"] += totals["flash_attention_bwd"] - n_bwd
    print_train("[20 deepseek train] deepseek-v3 widths, 3 dense-prefix MLA layers, no MTP",
                mt["deepseek"], f"; D-192 flash backward launches "
                f"{mla_totals['flash_attention_bwd_d192']} {took('20 deepseek train')}")
    print_ranges("[20 deepseek train ranges]", mt["deepseek"]["ranges"])

    # 21. Qwen3-MoE training at its published widths, cut to one layer (GQA
    # attention at G 16, head dim 128; 128 experts top-8): the MoE dispatch's
    # backward and the bf16 D-128 flash backward
    mt["qwen3_moe"] = train_pair("qwen3_moe_235b_a22b", QWEN_TRAIN_CUT, "Qwen3-MoE training")
    print_train("[21 qwen3-moe train] qwen3-moe widths, 1 layer", mt["qwen3_moe"],
                took("21 qwen3-moe train"))
    print_ranges("[21 qwen3-moe train ranges]", mt["qwen3_moe"]["ranges"])

    # 22. float32 training parity, card vs CPU: DeepSeek SMOKE with its MTP
    # module (MLA at head dim 24, MoE, the MTP loss) and Qwen3-MoE SMOKE at
    # 2 x 128 tokens (loss, grad norm, every gradient leaf, params after one
    # AdamW step); then every gradient of one full-width MLA + SwiGLU prefix
    # block at 2 x 16 tokens (the float32 D-192 backward)
    tpm = report["moe_train_parity"] = {}
    for arch in ("deepseek_v3_671b", "qwen3_moe_235b_a22b"):
        c = get(arch, smoke=True)
        pt = per_train_step(c)
        p_cpu = transformer.init(torch.Generator().manual_seed(SEED), c, device="cpu")
        toks = torch.randint(0, c.vocab, (2, 129),
                             generator=torch.Generator().manual_seed(SEED + 5))
        batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
        # one backward, then one graphed train step (WARMUP eager calls,
        # the capture and a replay)
        step_keys = ("sumsq", "clip_finalize", "adamw_update")
        want = zero(**{k: v * (1 + WARMUP) if k in step_keys else v * (2 + WARMUP)
                       for k, v in pt.items()})
        tpm[arch] = drive(kern, side, want, lambda: train_parity(
            c, p_cpu, tree_map(lambda a: a.to("cuda"), p_cpu), batch, model_api(c).loss,
            make_train_step, adamw), f"{arch} SMOKE training parity")
        if not tpm[arch]["ok"]:
            fail(f"{arch} SMOKE float32 training card vs CPU differs: {tpm[arch]}")
        if arch == "deepseek_v3_671b":
            mla_totals["flash_attention_bwd_f32_d24"] += want["flash_attention_bwd"]
    bcfg = dataclasses.replace(get("deepseek_v3_671b"), dtype="float32", mtp=False)
    spec = ("mla", "mlp")
    bp_gpu = transformer.block_init(torch.Generator(device="cuda").manual_seed(SEED),
                                    spec, bcfg, torch.float32, "cuda")
    bp_cpu = tree_map(lambda a: a.cpu(), bp_gpu)
    bgen = torch.Generator().manual_seed(SEED + 6)
    xb = torch.randn((2, 16, bcfg.d_model), generator=bgen)
    dy = torch.randn((2, 16, bcfg.d_model), generator=bgen)

    def block_grads(bp, dev):
        p = tree_map(lambda a: a.detach().requires_grad_(True), bp)
        x = xb.to(dev).requires_grad_(True)
        y, _ = transformer.block_apply(p, x, spec, bcfg, torch.arange(16, device=dev))
        (y * dy.to(dev)).sum().backward()
        return {"x": x.grad, "params": tree_map(lambda a: a.grad, p)}

    g_gpu = drive(kern, side, zero(rmsnorm=4, rmsnorm_bwd=4, flash_attention=1,
                                   flash_attention_bwd=1),
                  lambda: block_grads(bp_gpu, "cuda"), "MLA block gradient parity")
    mla_totals["flash_attention_bwd_f32_d192"] += 1
    g_cpu = block_grads(bp_cpu, "cpu")
    blk = tpm["mla_block"] = {"params": param_count(bp_cpu), "leaves": 0,
                              "worst_grad": None, "worst_grad_ratio": 0.0}
    for path, gc, gg in _paired_leaves(g_cpu, g_gpu):
        blk["leaves"] += 1
        tol = GRAD_TOL * float(gc.abs().max()) + 1e-6
        ratio = float((gg.cpu() - gc).abs().max()) / tol
        if ratio >= blk["worst_grad_ratio"]:
            blk["worst_grad"], blk["worst_grad_ratio"] = path, ratio
    if blk["worst_grad_ratio"] > 1.0:
        fail(f"the full-width MLA block's gradients differ card vs CPU: {blk}")
    del bp_gpu, bp_cpu, g_gpu, g_cpu
    torch.cuda.empty_cache()
    print(f"[22 moe train parity] float32, card vs CPU: " + "; ".join(
        f"{a} SMOKE{' (MTP, MLA head dim 24)' if a.startswith('deepseek') else ''} 2x128: "
        f"loss {v['loss_cpu']:.6f} (err {v['loss_err']:.2e}, tol {LOSS_TOL:g}), grad_norm "
        f"err {v['grad_norm_rel_err']:.2e}, {v['leaves']} gradient leaves, worst "
        f"{v['worst_grad']} at {v['worst_grad_ratio']:.3f} of its tolerance, params after "
        f"one AdamW step max err {v['param_max_err']:.2e} (tol {v['param_tol']:.2e})"
        for a, v in tpm.items() if a != "mla_block")
        + f"; one full-width MLA + SwiGLU block ({blk['params'] / 1e6:.1f} M params) at "
        f"2x16: {blk['leaves']} gradients (x and every param), worst {blk['worst_grad']} at "
        f"{blk['worst_grad_ratio']:.3f} of its tolerance ({GRAD_TOL:g} max|g| + 1e-6) "
        f"{took('22 moe train parity')}", flush=True)

    report["streaming"] = phase_streaming(kern, zero)
    print(f"[23 streaming] {took('23 streaming')}", flush=True)

    # 24. whisper-small at its published widths and depth (12 + 12 layers, d
    # 768, 12 heads of 64, 1,500 frames, vocab 51865), bf16, weights from
    # seed 0: prefill of 8 x (1,500 frames + 64 tokens), 64 greedy decode
    # steps from the cross K/V of the encoded frames, and serve_batch 8 x (64
    # + 64) as the reference serves it (cross K/V zeros), each eager and
    # graphed and equal; a profile of one prefill and one decode step;
    # float32 logits card vs CPU on a 2 + 2-layer cut
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = dict(totals)
    wcfg = get("whisper_small")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    wparams = model_api(wcfg).init(gen, wcfg, device="cuda")
    wtoks = torch.randint(0, wcfg.vocab, (8, 64), generator=gen, device="cuda")
    wframes = frontends.audio_frames(gen, wcfg, 8, device="cuda")
    wbatch = {"frames": wframes, "inputs": wtoks}
    report["whisper"] = wr = {"params": param_count(wparams),
                              "param_bytes": param_bytes(wparams)}
    wr["prefill"], weager, wprefill = prefill_pair(
        "whisper prefill", wcfg, wparams, wbatch, 4,
        n_tokens=8 * (wcfg.encoder_seq + 64))
    print_pair(f"[24 whisper prefill] whisper-small bf16 ({wr['params'] / 1e6:.1f} M "
               "params), 8 x (1500 frames + 64 tokens), tokens/s counting frames and "
               "tokens", wr["prefill"], "tokens_per_s", "tokens/s", "")
    wr["decode"] = encdec_decode_pair("whisper decode", wcfg, wparams, wframes,
                                      wtoks[:, 0].to(torch.int32), 64)
    print_pair("[24 whisper decode] 8 x 64 greedy steps from the encoded frames' "
               "cross K/V", wr["decode"], "new_tokens_per_s", "new tokens/s", "")
    wr["serve"] = serve_pair("whisper serving", wcfg, wparams,
                             [r.prompt for r in requests(wcfg, rng)], 64)
    print_pair("[24 whisper serve] serve_batch 8 x (64 prompt + 64 new), cross K/V "
               "zeros", wr["serve"], "new_tokens_per_s", "new tokens/s", "")
    wr["profile"] = prof = profile_pair("whisper", wcfg, wparams, wbatch, wtoks[:, 0],
                                        weager, wprefill)
    print_profile("[24 whisper profile]", prof)
    wprefill.release()
    wr["peak_bytes"] = torch.cuda.max_memory_allocated()
    del wparams, wprefill, weager
    torch.cuda.empty_cache()
    pcfg = dataclasses.replace(wcfg, n_layers=2, encoder_layers=2, dtype="float32")
    p_gpu = model_api(pcfg).init(torch.Generator(device="cuda").manual_seed(SEED), pcfg,
                                 device="cuda")
    p_cpu = tree_map(lambda a: a.cpu(), p_gpu)
    frames = frontends.audio_frames(rng, pcfg, 2, device="cpu")
    wr["parity"] = par = drive(kern, side, parity_launches(pcfg), lambda: parity(
        pcfg, p_cpu, p_gpu, rng, frames=frames), "whisper parity")
    par["params"] = param_count(p_cpu)
    del p_gpu, p_cpu
    print(f"[24 whisper parity] float32, full width cut to 2 + 2 layers "
          f"({par['params'] / 1e6:.1f} M params), 2 x (1500 frames + 32 tokens), card vs "
          f"CPU: prefill max_abs_err {par['prefill_max_abs_err']:.3e}, 8 decode steps "
          f"from the encoded frames {max(par['decode_max_abs_err']):.3e} (tol "
          f"{PARITY_TOL:g}; |logits| up to {par['logit_abs_max']:.3f}); peak device "
          f"memory {wr['peak_bytes'] / 2**30:.2f} GiB {took('24 whisper serve')}",
          flush=True)

    # 25. whisper-small training at full width and depth: 8 steps of 8 x
    # (1,500 frames + 448 tokens) through launch.train.train (the audio
    # frontend's frames drawn per step), eager and graphed
    wr["train"] = train_pair("whisper_small", {}, "whisper training", seq=448)
    wr["train"]["frames_per_s"] = {
        m: 8 * wcfg.encoder_seq / wr["train"][m]["median_step_s"] for m in ("eager", "graphed")}
    print_train("[25 whisper train] whisper-small, 12 + 12 layers, 8 x (1500 frames + "
                "448 tokens)", wr["train"], f"; frames/s eager "
                f"{wr['train']['frames_per_s']['eager']:.0f}, graphed "
                f"{wr['train']['frames_per_s']['graphed']:.0f} {took('25 whisper train')}")
    print_ranges("[25 whisper train ranges]", wr["train"]["ranges"])
    for name, kernel in (("flash_attention_whisper", "flash_attention"),
                         ("flash_attention_bwd_whisper", "flash_attention_bwd"),
                         ("decode_attention_whisper", "decode_attention")):
        frontend_totals[name] = totals[kernel] - before[kernel]

    # 26. llava-next-mistral-7b at its published widths and depth (32
    # layers, d 4096, 32 / 8 heads of 128, ~7.2 B params), bf16: prefill of 8
    # x (2,880 image-patch embeddings + 64 text tokens) fused by
    # fuse_vlm_inputs through the embeds branch, and serving 8 x (64 + 64),
    # each eager and graphed and equal; peak device memory
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = dict(totals)
    lcfg = get("llava_next_mistral_7b")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    lparams = model_api(lcfg).init(gen, lcfg, device="cuda")
    ltoks = torch.randint(0, lcfg.vocab, (8, 64), generator=gen, device="cuda")
    with torch.no_grad():
        lbatch = {"embeds": frontends.fuse_vlm_inputs(
            lparams, frontends.image_patches(gen, lcfg, 8, device="cuda"), ltoks, lcfg)}
    report["llava"] = lv = {"params": param_count(lparams),
                            "param_bytes": param_bytes(lparams)}
    lv["prefill"], leager, lprefill = prefill_pair("llava prefill", lcfg, lparams, lbatch, 3)
    print_pair(f"[26 llava prefill] llava-next-mistral-7b bf16, 32 layers "
               f"({lv['params'] / 1e9:.2f} B params, {lv['param_bytes'] / 1e9:.1f} GB), "
               "8 x (2880 patches + 64 tokens) as embeds", lv["prefill"], "tokens_per_s",
               "tokens/s", "")
    lprefill.release()
    del lprefill, leager, lbatch
    lv["serve"] = serve_pair("llava serving", lcfg, lparams,
                             [r.prompt for r in requests(lcfg, rng)], 64)
    lv["peak_bytes"] = torch.cuda.max_memory_allocated()
    print_pair("[26 llava serve] 8 requests x (64 prompt + 64 new)", lv["serve"],
               "new_tokens_per_s", "new tokens/s",
               f"; peak device memory {lv['peak_bytes'] / 2**30:.2f} GiB "
               f"{took('26 llava serve')}")
    del lparams
    torch.cuda.empty_cache()

    # 27. llava training, the vlm branch of launch.train.train: 8 steps of 8 x
    # 3,072 positions (2,880 patches + 192 text tokens), at the published
    # widths cut to LLAVA_TRAIN_CUT layers so that AdamW's 12 bytes a param
    # fit; the embedding takes no gradient (its moment stays zero)
    lv["train"] = lt = train_pair("llava_next_mistral_7b", LLAVA_TRAIN_CUT,
                                  "llava training", seq=3072, lr=LLAVA_TRAIN_LR)
    if lt["zero_moment_leaves"] != ["/embed"]:
        fail(f"llava training: the leaves whose AdamW moment stayed zero are "
             f"{lt['zero_moment_leaves']}, not the embedding alone")
    print_train(f"[27 llava train] llava widths cut to {LLAVA_TRAIN_CUT['n_layers']} "
                f"layers, 8 x (2880 patches + 192 tokens), AdamW base rate {LLAVA_TRAIN_LR:g}",
                lt,
                f"; the embedding's gradient is zero (its moment alone stayed zero) "
                f"{took('27 llava train')}")
    print_ranges("[27 llava train ranges]", lt["ranges"])
    # float32 training card vs CPU at llava's full width cut to 2 layers, on
    # an embeds batch of 2 x (96 patches + 32 tokens): the loss, every
    # gradient (the embedding's none on either side), one AdamW step
    pcfg = dataclasses.replace(get("llava_next_mistral_7b"), n_layers=2, dtype="float32")
    p_gpu = model_api(pcfg).init(torch.Generator(device="cuda").manual_seed(SEED), pcfg,
                                 device="cuda")
    p_cpu = tree_map(lambda a: a.cpu(), p_gpu)
    pgen = torch.Generator().manual_seed(SEED + 9)
    toks = torch.randint(0, pcfg.vocab, (2, 129), generator=pgen)
    patches = frontends.image_patches(pgen, dataclasses.replace(pcfg, img_tokens=96), 2,
                                      device="cpu")
    batch = {"embeds": frontends.fuse_vlm_inputs(p_cpu, patches, toks[:, :32], pcfg),
             "labels": toks[:, 1:]}
    pt = per_train_step(pcfg)
    step_keys = ("sumsq", "clip_finalize", "adamw_update")
    want = zero(**{k: v * (1 + WARMUP) if k in step_keys else v * (2 + WARMUP)
                   for k, v in pt.items()})
    lt["parity"] = tp = drive(kern, side, want, lambda: train_parity(
        pcfg, p_cpu, p_gpu, batch, model_api(pcfg).loss, make_train_step, adamw),
        "llava training parity")
    if not tp["ok"] or tp["no_grad"] != ["/embed"]:
        fail(f"llava float32 training card vs CPU differs: {tp}")
    del p_gpu, p_cpu, batch
    torch.cuda.empty_cache()
    print(f"[27 llava train parity] float32, full width cut to 2 layers "
          f"({tp['params'] / 1e9:.2f} B params), 2 x (96 patches + 32 tokens) as embeds, "
          f"card vs CPU: loss {tp['loss_cpu']:.6f} (err {tp['loss_err']:.2e}), grad_norm "
          f"err {tp['grad_norm_rel_err']:.2e}, {tp['leaves']} gradient leaves, worst "
          f"{tp['worst_grad']} at {tp['worst_grad_ratio']:.3f} of its tolerance, no "
          f"gradient: {tp['no_grad']}; params after one AdamW step max err "
          f"{tp['param_max_err']:.2e} (tol {tp['param_tol']:.2e})", flush=True)
    # phase 27 trains at LLAVA_TRAIN_LR; at the trainer's 3e-4 the loss rises.
    # The rate witness: (1) the phase's batches, 8 x 3,072, at 3e-4 through
    # launch.train.train, cut to 2 layers, bf16 and then float32 (the
    # float32 kernels and GEMMs, none of the bf16 path): the two loss curves;
    # (2) float32 at 3e-4 with the trainer's 8-step schedule, its first
    # RATE_LOCKSTEP_STEPS steps on the card and on the CPU from the same
    # params and state, on 2 x (96 patches + 32 tokens)
    lt["rate_witness"] = wit = {"lr": 3e-4, "layers": 2}
    for dn in ("bfloat16", "float32"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = drive(kern, side, zero(**{k: v * MOE_TRAIN_STEPS for k, v in pt.items()}),
                    lambda: train("llava_next_mistral_7b", smoke=False,
                                  steps=MOE_TRAIN_STEPS, batch=8, seq=3072, lr=3e-4,
                                  log_every=MOE_TRAIN_STEPS, device="cuda", graphs=False,
                                  overrides=dict(n_layers=2, dtype=dn)),
                    f"llava rate witness ({dn})")
        if not all(math.isfinite(x) for x in out["losses"]):
            fail(f"llava rate witness ({dn}) losses not finite: {out['losses']}")
        wit[dn] = {"losses": out["losses"], "grad_norms": out["grad_norms"],
                   "max_memory_allocated": torch.cuda.max_memory_allocated()}
        del out
    torch.cuda.empty_cache()
    p_gpu = model_api(pcfg).init(torch.Generator(device="cuda").manual_seed(SEED), pcfg,
                                 device="cuda")

    def witness_batch(p_cpu, t):
        g = torch.Generator().manual_seed(SEED + 10 + t)
        toks = torch.randint(0, pcfg.vocab, (2, 129), generator=g)
        patches = frontends.image_patches(g, dataclasses.replace(pcfg, img_tokens=96), 2,
                                          device="cpu")
        return {"embeds": frontends.fuse_vlm_inputs(p_cpu, patches, toks[:, :32], pcfg),
                "labels": toks[:, 1:]}

    wit["lockstep"] = ls = drive(
        kern, side, zero(**{k: v * RATE_LOCKSTEP_STEPS for k, v in pt.items()}),
        lambda: lockstep_train(pcfg, p_gpu, witness_batch, RATE_LOCKSTEP_STEPS,
                               MOE_TRAIN_STEPS, 3e-4, make_train_step, adamw,
                               warmup_cosine),
        "llava rate witness (lockstep)")
    del p_gpu
    torch.cuda.empty_cache()
    if not ls["ok"]:
        fail(f"llava float32 lockstep training card vs CPU differs: {ls}")
    print(f"[27 llava rate witness] llava widths cut to 2 layers at the trainer's AdamW "
          f"3e-4, {MOE_TRAIN_STEPS} steps of 8 x (2880 patches + 192 tokens) through "
          f"launch.train.train: bf16 losses "
          f"{[round(x, 4) for x in wit['bfloat16']['losses']]}, float32 losses "
          f"{[round(x, 4) for x in wit['float32']['losses']]} (grad norms bf16 "
          f"{[round(x, 1) for x in wit['bfloat16']['grad_norms']]}, float32 "
          f"{[round(x, 1) for x in wit['float32']['grad_norms']]}); float32 card and CPU "
          f"in lockstep, {RATE_LOCKSTEP_STEPS} steps of 2 x (96 patches + 32 tokens) from "
          f"the same params and state: losses {[round(x, 4) for x in ls['losses']]} (max "
          f"err {max(ls['loss_err']):.2e}, tol {LOSS_TOL:g}), grad norm max rel err "
          f"{max(ls['grad_norm_rel_err']):.2e} (tol {GRAD_TOL:g}), params after each step "
          f"max err {[float(f'{x:.2e}') for x in ls['param_max_err']]} "
          f"{took('27 llava rate witness')}", flush=True)
    for name, kernel in (("flash_attention_llava", "flash_attention"),
                         ("flash_attention_bwd_llava", "flash_attention_bwd")):
        frontend_totals[name] = totals[kernel] - before[kernel]

    # 28. Jamba training at its published widths, cut to one attention and two
    # Mamba layers with its dense SwiGLU (JAMBA_TRAIN_CUT, 3.88 B params): 8
    # steps of 8 x 512 through launch.train.train, eager and graphed; the
    # scan's training forward (twice a step under remat) and its backward
    torch.cuda.empty_cache()
    report["jamba_train"] = jt = train_pair("jamba_1_5_large_398b", JAMBA_TRAIN_CUT,
                                            "Jamba training")
    print_train("[28 jamba train] jamba-1.5-large widths, attention + 2 Mamba layers, "
                "dense FFN", jt, took("28 jamba train"))
    print_ranges("[28 jamba train ranges]", jt["ranges"])

    # Jamba's rate witness: phase 28's loss at 3e-4 falls but not monotone.
    # (1) the witness cut, 8 x 512 through launch.train.train at 3e-4, in
    # bf16 and in float32 (the float32 kernels and GEMMs): the two loss and
    # grad-norm curves; (2) float32 at 3e-4 with the trainer's 8-step
    # schedule, its first RATE_LOCKSTEP_STEPS steps on the card and on the
    # CPU from the same params and state (Jamba SMOKE, 2 x 128 tokens), at
    # SMOKE's N 4 and at Jamba's N 16, whose backward instance alone keeps
    # its exponentials and walks 8-step sub-stages over four lanes a channel
    jw = report["jamba_rate_witness"] = {"lr": 3e-4, "cut": JAMBA_WITNESS_CUT}
    wpt = per_train_step(dataclasses.replace(get("jamba_1_5_large_398b"),
                                             **JAMBA_WITNESS_CUT))
    for dn in ("bfloat16", "float32"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = drive(kern, side, zero(**{k: v * MOE_TRAIN_STEPS for k, v in wpt.items()}),
                    lambda: train("jamba_1_5_large_398b", smoke=False,
                                  steps=MOE_TRAIN_STEPS, batch=8, seq=512, lr=3e-4,
                                  log_every=MOE_TRAIN_STEPS, device="cuda", graphs=False,
                                  overrides=dict(JAMBA_WITNESS_CUT, dtype=dn)),
                    f"Jamba rate witness ({dn})")
        if not all(math.isfinite(x) for x in out["losses"]):
            fail(f"Jamba rate witness ({dn}) losses not finite: {out['losses']}")
        jw[dn] = {"losses": out["losses"], "grad_norms": out["grad_norms"],
                  "params": param_count(out["params"]),
                  "max_memory_allocated": torch.cuda.max_memory_allocated()}
        del out
    for key, n_state in (("lockstep", 4), ("lockstep_n16", 16)):
        torch.cuda.empty_cache()
        jcfg_s = dataclasses.replace(get("jamba_1_5_large_398b", smoke=True), dtype="float32",
                                     ssm_state=n_state)
        jp_gpu = model_api(jcfg_s).init(torch.Generator(device="cuda").manual_seed(SEED),
                                        jcfg_s, device="cuda")

        def jamba_witness_batch(p_cpu, t, vocab=jcfg_s.vocab):
            toks = torch.randint(0, vocab, (2, 129),
                                 generator=torch.Generator().manual_seed(SEED + 20 + t))
            return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}

        jw[key] = jls = drive(
            kern, side, zero(**{k: v * RATE_LOCKSTEP_STEPS
                                for k, v in per_train_step(jcfg_s).items()}),
            lambda: lockstep_train(jcfg_s, jp_gpu, jamba_witness_batch, RATE_LOCKSTEP_STEPS,
                                   MOE_TRAIN_STEPS, 3e-4, make_train_step, adamw,
                                   warmup_cosine),
            f"Jamba rate witness (lockstep, N {n_state})")
        del jp_gpu
        torch.cuda.empty_cache()
        if not jls["ok"]:
            fail(f"Jamba SMOKE (N {n_state}) float32 lockstep training card vs CPU differs: "
                 f"{jls}")
    wl = {dn: jw[dn]["losses"] for dn in ("bfloat16", "float32")}
    jw["max_loss_gap"] = max(abs(a - b) for a, b in zip(wl["bfloat16"], wl["float32"]))
    print(f"[28 jamba rate witness] jamba-1.5-large widths, attention + 1 Mamba layer, "
          f"dense FFN ({jw['float32']['params'] / 1e9:.2f} B params) at the trainer's AdamW "
          f"3e-4, {MOE_TRAIN_STEPS} steps of 8 x 512 through launch.train.train: bf16 losses "
          f"{[round(x, 4) for x in wl['bfloat16']]}, float32 losses "
          f"{[round(x, 4) for x in wl['float32']]} (largest gap {jw['max_loss_gap']:.4f}; "
          f"grad norms bf16 {[round(x, 1) for x in jw['bfloat16']['grad_norms']]}, float32 "
          f"{[round(x, 1) for x in jw['float32']['grad_norms']]}; peak "
          f"{jw['bfloat16']['max_memory_allocated'] / 2**30:.2f} / "
          f"{jw['float32']['max_memory_allocated'] / 2**30:.2f} GiB); float32 card and CPU in "
          f"lockstep, Jamba SMOKE, {RATE_LOCKSTEP_STEPS} steps of 2 x 128 tokens from the "
          f"same params and state: "
          + "; ".join(f"N {n_state}: losses {[round(x, 4) for x in jw[key]['losses']]} (max "
                      f"err {max(jw[key]['loss_err']):.2e}, tol {LOSS_TOL:g}), grad norm max "
                      f"rel err {max(jw[key]['grad_norm_rel_err']):.2e} (tol {GRAD_TOL:g})"
                      for key, n_state in (("lockstep", 4), ("lockstep_n16", 16)))
          + f" {took('28 jamba rate witness')}", flush=True)

    # 29. float32 training parity, card vs CPU (phase 14's tolerances): Jamba
    # SMOKE with its real MoE layers at 2 x 128 tokens (loss, grad norm,
    # every gradient leaf, params after one AdamW step), then every gradient
    # of one full-width Mamba layer (d 8192, d_inner 16384, N 16) at 2 x 32
    # tokens (two stages of the float32 N-16 backward)
    tpj = report["jamba_train_parity"] = {}
    c = get("jamba_1_5_large_398b", smoke=True)
    pt = per_train_step(c)
    p_cpu = transformer.init(torch.Generator().manual_seed(SEED), c, device="cpu")
    toks = torch.randint(0, c.vocab, (2, 129), generator=torch.Generator().manual_seed(SEED + 8))
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    want = zero(**{k: v * (1 + WARMUP) if k in step_keys else v * (2 + WARMUP)
                   for k, v in pt.items()})
    tpj["smoke"] = drive(kern, side, want, lambda: train_parity(
        c, p_cpu, tree_map(lambda a: a.to("cuda"), p_cpu), batch, model_api(c).loss,
        make_train_step, adamw), "Jamba SMOKE training parity")
    if not tpj["smoke"]["ok"]:
        fail(f"Jamba SMOKE float32 training card vs CPU differs: {tpj['smoke']}")
    mcfg = dataclasses.replace(get("jamba_1_5_large_398b"), dtype="float32")
    spec = ("mamba", None)
    mp_gpu = transformer.block_init(torch.Generator(device="cuda").manual_seed(SEED),
                                    spec, mcfg, torch.float32, "cuda")
    mp_cpu = tree_map(lambda a: a.cpu(), mp_gpu)
    mgen = torch.Generator().manual_seed(SEED + 9)
    xm = torch.randn((2, 32, mcfg.d_model), generator=mgen)
    dym = torch.randn((2, 32, mcfg.d_model), generator=mgen)

    def mamba_grads(bp, dev):
        p = tree_map(lambda a: a.detach().requires_grad_(True), bp)
        x = xm.to(dev).requires_grad_(True)
        y, _ = transformer.block_apply(p, x, spec, mcfg, torch.arange(32, device=dev))
        (y * dym.to(dev)).sum().backward()
        return {"x": x.grad, "params": tree_map(lambda a: a.grad, p)}

    g_gpu = drive(kern, side, zero(rmsnorm=1, rmsnorm_bwd=1, mamba_scan_train=1,
                                   mamba_scan_bwd=1),
                  lambda: mamba_grads(mp_gpu, "cuda"), "Mamba layer gradient parity")
    g_cpu = mamba_grads(mp_cpu, "cpu")
    blk = tpj["mamba_layer"] = {"params": param_count(mp_cpu), "leaves": 0,
                                "worst_grad": None, "worst_grad_ratio": 0.0}
    for path, gc, gg in _paired_leaves(g_cpu, g_gpu):
        blk["leaves"] += 1
        tol = GRAD_TOL * float(gc.abs().max()) + 1e-6
        ratio = float((gg.cpu() - gc).abs().max()) / tol
        if ratio >= blk["worst_grad_ratio"]:
            blk["worst_grad"], blk["worst_grad_ratio"] = path, ratio
    if blk["worst_grad_ratio"] > 1.0:
        fail(f"the full-width Mamba layer's gradients differ card vs CPU: {blk}")
    del mp_gpu, mp_cpu, g_gpu, g_cpu, p_cpu
    torch.cuda.empty_cache()
    v = tpj["smoke"]
    print(f"[29 jamba train parity] float32, card vs CPU: Jamba SMOKE with its MoE layers "
          f"2x128: loss {v['loss_cpu']:.6f} (err {v['loss_err']:.2e}, tol {LOSS_TOL:g}), "
          f"grad_norm err {v['grad_norm_rel_err']:.2e}, {v['leaves']} gradient leaves, worst "
          f"{v['worst_grad']} at {v['worst_grad_ratio']:.3f} of its tolerance, params after "
          f"one AdamW step max err {v['param_max_err']:.2e} (tol {v['param_tol']:.2e}); one "
          f"full-width Mamba layer ({blk['params'] / 1e6:.1f} M params) at 2x32: "
          f"{blk['leaves']} gradients (x and every param), worst {blk['worst_grad']} at "
          f"{blk['worst_grad_ratio']:.3f} of its tolerance ({GRAD_TOL:g} max|g| + 1e-6) "
          f"{took('29 jamba train parity')}", flush=True)

    # 30. xlstm-125m training at full width and depth: XLSTM_TRAIN_STEPS steps
    # of 8 x 512, eager and graphed (the sLSTM loop over time inside the
    # train step's graph); no new kernel (its norms' backward)
    report["xlstm_train"] = xt = train_pair("xlstm_125m", {}, "xLSTM training",
                                            steps=XLSTM_TRAIN_STEPS, ranges=False)
    print_train("[30 xlstm train] xlstm-125m, whole", xt, took("30 xlstm train"))

    # the kernel table: main-path shapes, bf16; launches over every main path
    table = []
    for name, (source, replaces, case) in KERNELS.items():
        r = next(r for r in rows if r["kernel"] == name and r["case"] == case
                 and r["dtype"] == "bfloat16")
        if totals[name] == 0:
            fail(f"{name} was never launched on the main path")
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "case": case,
                      "launches": totals[name],
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # MLA's flash instances, forward and backward, and the encoder-decoder's
    # and llava's shapes, each with the launches of the path that runs it
    path_rows = {name: ("flash_attention_bwd" if name in MLA_BWD_ROWS else "flash_attention",
                        *row) for name, row in {**MLA_ROWS, **MLA_BWD_ROWS}.items()}
    path_rows.update(FRONTEND_ROWS)
    launched = {**mla_totals, **frontend_totals}
    for name, (kernel, source, replaces, case, dn, path) in path_rows.items():
        r = next(r for r in rows if r["kernel"] == kernel and r["case"] == case
                 and r["dtype"] == dn)
        if launched[name] == 0:
            fail(f"{name} was never launched on its path ({path})")
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "case": f"{case} {dn}", "path": path,
                      "launches": launched[name],
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    report["table"] = table
    report["profiler_retries"] = dict(PROFILER_RETRIES)
    print(f"[profiler] sessions run again: {dict(PROFILER_RETRIES) or 'none'}", flush=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
