#!/usr/bin/env python3
"""Drive the PyTorch port's serving path for smollm-360M on one CUDA card.

  python3 chip_smoke.py

Run from the root of a checkout: it builds the CUDA kernels from
``src/repro_torch/csrc`` and then, each phase on a line of its own,
  1. prints the card's name and power limit (nvidia-smi) and the build time;
  2. holds each kernel against its plain PyTorch version on the card, at the
     main path's shapes, in bf16 and float32, with its device time, bound,
     the plain version's time and a library call's time as a yardstick;
  3. runs full-width smollm-360M prefill (bf16, 8 x 512 tokens) through
     ``make_prefill_step`` and checks the kernels' launch counts;
  4. serves 8 requests (64-token prompts, 64 new tokens) through
     ``serve_batch`` and checks the launch counts per decode step;
  5. compares float32 logits, card against CPU (plain versions), at full
     width, for prefill and for teacher-forced decode steps;
  6. profiles one prefill and one decode step: device busy time, idle share
     and the kernels that take the time.
Then it prints the kernel table as one JSON line and, last,
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
with no CUDA device, or outside a checkout, it exits non-zero at once. The
full report goes to ``build/chip_smoke.json``, the compiler's output (ptxas
registers and spills) to ``build/kernels/build_<hash>.log``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
SEED = 0

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s; dense ops/s by
# input type (bf16 on the tensor cores, float32 on the CUDA cores).
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}

# |kernel - plain| <= TOL * (1 + |plain|): the kernels accumulate in float32
# like the plain versions, so float32 differs only in summation order; bf16
# differs by the rounding of the output to bf16.
TOL = {("rmsnorm", "float32"): 1e-5, ("rmsnorm", "bfloat16"): 2e-2,
       ("attn", "float32"): 2e-5, ("attn", "bfloat16"): 3e-2}
# float32 logits, card vs CPU, after 32 layers: the same arithmetic in a
# different accumulation order (cuBLAS vs CPU GEMMs, kernels vs einsum)
# drifts by ~1e-5; a wrong mask, scale or cache slot moves logits by >1e-1.
PARITY_TOL = 1e-3

KERNELS = {  # name: (source, TPU kernel it replaces, main-path case)
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:23", "4096x960"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:84",
                        "causal 8x15/5x512x512x64"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:61",
                         "8x15/5x129x64 ragged length"),
}


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def device_ms(fn, iters: int = 21) -> float:
    """Device time per call, from the profiler (CUPTI), after a warm-up: the
    median over ``iters`` calls of the summed duration of the kernels and
    copies each call launches (the mean, should the calls launch unequal
    numbers of them)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA),
                key=lambda e: e.time_range.start)
    if not ev:
        fail("the profiler recorded no device time")
    if len(ev) % iters:
        return sum(e.time_range.end - e.time_range.start for e in ev) / iters / 1e3
    per = len(ev) // iters
    calls = [sum(e.time_range.end - e.time_range.start
                 for e in ev[i * per:(i + 1) * per]) for i in range(iters)]
    return statistics.median(calls) / 1e3


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


def bound(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(kernel, case, dtype, got, want, tol_key, timed=None):
    """One row of phase 2; with ``timed = (run, plain, library, nbytes,
    ops)`` it also times the three calls and states the bound."""
    err = (got.float() - want.float()).abs()
    tol = TOL[(tol_key, dtype)]
    row = dict(kernel=kernel, case=case, dtype=dtype, max_abs_err=float(err.max()),
               tol=tol, ok=bool((err <= tol + tol * want.float().abs()).all()))
    if timed is not None:
        run, plain, library, nbytes, ops = timed
        row["bound_ms"], row["bound_by"] = bound(nbytes, ops, dtype)
        row.update(ms=device_ms(run), launch_ms=launch_ms(run),
                   plain_ms=device_ms(plain),
                   library_ms=None if library is None else device_ms(library))
    return row


def phase_kernels(rms, fla, dec):
    """Each kernel against its plain version on CUDA tensors."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        isz = torch.tensor([], dtype=dtype).element_size()
        # RMSNorm: prefill rows (8 x 512) and decode rows (8)
        for n in (4096, 8):
            x, s = randn((n, 960), dtype), randn((960,), torch.float32)
            sw = s.to(dtype)
            rows.append(compare(
                "rmsnorm", f"{n}x960", dn, rms.rmsnorm_cuda(x, s, 1e-5),
                rms.rmsnorm_plain(x, s, 1e-5), "rmsnorm",
                (lambda: rms.rmsnorm_cuda(x, s, 1e-5),
                 lambda: rms.rmsnorm_plain(x, s, 1e-5),
                 lambda: F.rms_norm(x, (960,), sw, 1e-5),
                 2 * x.numel() * isz + s.numel() * 4, 4 * x.numel())))
        # flash attention: prefill causal, window + offset, ragged Sq
        for case, b, sq, skv, window in (
                ("causal 8x15/5x512x512x64", 8, 512, 512, None),
                ("window256 offset384 8x15/5x128x512x64", 8, 128, 512, 256),
                ("ragged 2x15/5x77x77x64", 2, 77, 77, None)):
            q = randn((b, 15, sq, 64), dtype)
            k, v = randn((b, 5, skv, 64), dtype), randn((b, 5, skv, 64), dtype)
            off = skv - sq
            pairs = int(fla_mask(sq, skv, window, off).sum())
            library = None
            if window is None:
                # yardstick: SDPA on K/V expanded to the q heads beforehand
                ke, ve = (t.repeat_interleave(3, dim=1) for t in (k, v))
                library = (lambda q=q, ke=ke, ve=ve:
                           F.scaled_dot_product_attention(q, ke, ve, is_causal=True))
            rows.append(compare(
                "flash_attention", case, dn,
                fla.flash_attention_cuda(q, k, v, True, window, off),
                fla.flash_attention_plain(q, k, v, True, window, off), "attn",
                (lambda: fla.flash_attention_cuda(q, k, v, True, window, off),
                 lambda: fla.flash_attention_plain(q, k, v, True, window, off),
                 library, (2 * q.numel() + 2 * k.numel()) * isz,
                 4 * b * 15 * 64 * pairs)))
        # decode attention: the serving cache (64 + 64 + 1 slots), ragged length
        q = randn((8, 15, 64), dtype)
        k, v = randn((8, 5, 129, 64), dtype), randn((8, 5, 129, 64), dtype)
        length = torch.randint(1, 130, (8,), generator=gen, device="cuda",
                               dtype=torch.int32)
        valid = int(length.sum())
        mask = (torch.arange(129, device="cuda") < length[:, None])[:, None, None, :]
        ke, ve = (t.repeat_interleave(3, dim=1) for t in (k, v))
        rows.append(compare(
            "decode_attention", "8x15/5x129x64 ragged length", dn,
            dec.decode_attention_cuda(q, k, v, length),
            dec.decode_attention_plain(q, k, v, length), "attn",
            (lambda: dec.decode_attention_cuda(q, k, v, length),
             lambda: dec.decode_attention_plain(q, k, v, length),
             lambda: F.scaled_dot_product_attention(q[:, :, None], ke, ve,
                                                    attn_mask=mask),
             (2 * 5 * 64 * valid + 2 * q.numel()) * isz,
             4 * 15 * 64 * valid)))
    # decode with a sliding window, checked for agreement only
    q = randn((8, 15, 64), torch.float32)
    k, v = randn((8, 5, 129, 64), torch.float32), randn((8, 5, 129, 64), torch.float32)
    length = torch.randint(1, 130, (8,), generator=gen, device="cuda", dtype=torch.int32)
    rows.append(compare("decode_attention", "window32 check", "float32",
                        dec.decode_attention_cuda(q, k, v, length, window=32),
                        dec.decode_attention_plain(q, k, v, length, window=32),
                        "attn"))
    return rows


def fla_mask(sq, skv, window, offset):
    from repro_torch.kernels.ref import _mask
    return _mask(sq, skv, True, window, offset)


def counts(kern):
    return {name: getattr(mod, f"{name}_cuda").launches
            for name, mod in kern.items()}


def reset_counts(kern):
    for name, mod in kern.items():
        getattr(mod, f"{name}_cuda").launches = 0


def delta(after, before):
    return {k: after[k] - before[k] for k in after}


def profile_call(fn, top: int = 6):
    """Wall time of one call (median of 3, unprofiled), its device busy time
    (profiled), the idle share between them, and the kernels that took the
    most device time."""
    walls = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls[1:])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {e.key: e.self_device_time_total / 1e3 for e in events}
    busy = sum(by_name.values())
    tops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall, "device_busy_ms": busy,
            "device_ops": sum(e.count for e in events),
            "idle_share": max(0.0, 1 - busy / wall),
            "top": [{"kernel": k[:80], "ms": v} for k, v in tops]}


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
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fla
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.launch.serve import Request, serve_batch
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import model_api, transformer
    from repro_torch.models.module import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kern = {"rmsnorm": rms, "flash_attention": fla, "decode_attention": dec}
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    report = {}

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
    print(f"[1 card] {card} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | kernels built in {build_s:.1f} s (cached={_build.last_build['cached']})",
          flush=True)

    # 2. kernels against their plain versions
    rows = phase_kernels(rms, fla, dec)
    report["kernels"] = rows
    for r in rows:
        timing = "" if "ms" not in r else (
            f" | device ms {r['ms']:.4f} (back-to-back {r['launch_ms']:.4f}) bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']}) plain {r['plain_ms']:.4f} "
            f"library {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)}")
        print(f"[2 kernel] {r['kernel']} {r['case']} {r['dtype']}: max_abs_err "
              f"{r['max_abs_err']:.3e} (tol {r['tol']:g}){timing}", flush=True)
    bad = [f"{r['kernel']} {r['case']} {r['dtype']}" for r in rows if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")

    # 3. full-width prefill, bf16 (the main path: counts from 0)
    cfg = get("smollm_360m")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = transformer.init(gen, cfg, device="cuda")
    toks = torch.randint(0, cfg.vocab, (8, 512), generator=gen, device="cuda")
    prefill = make_prefill_step(cfg, device="cuda")
    reset_counts(kern)
    n_runs, times = 4, []
    for _ in range(n_runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits = prefill(params, {"inputs": toks})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    c1 = counts(kern)
    want = {"rmsnorm": 65 * n_runs, "flash_attention": 32 * n_runs,
            "decode_attention": 0}
    if c1 != want:
        fail(f"prefill launches {c1}, expected {want}")
    if tuple(logits.shape) != (8, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        fail(f"prefill logits shape {tuple(logits.shape)} or not finite")
    pre_s = statistics.median(times[1:])
    report["prefill"] = {"batch": 8, "seq": 512, "median_s": pre_s, "runs_s": times,
                         "tokens_per_s": 8 * 512 / pre_s, "launches": c1}
    print(f"[3 prefill] smollm-360M bf16 8x512: {pre_s * 1e3:.1f} ms median of "
          f"{n_runs - 1} (after 1 warm-up), {8 * 512 / pre_s:.0f} tokens/s; "
          f"launches per forward: rmsnorm 65, flash_attention 32", flush=True)

    # 4. serving, bf16
    rng = torch.Generator().manual_seed(SEED + 1)
    reqs = [Request(i, torch.randint(0, cfg.vocab, (64,), generator=rng,
                                     dtype=torch.int32).numpy(), 64)
            for i in range(8)]
    reqs, dt = serve_batch(cfg, params, reqs, max_len=64 + 64 + 1, device="cuda")
    main_counts = counts(kern)      # the main path: phases 3 and 4
    d = delta(main_counts, c1)
    steps = 64 + 64
    want = {"rmsnorm": 65 * steps, "flash_attention": 0,
            "decode_attention": 32 * steps}
    if d != want:
        fail(f"serving launches {d}, expected {want}")
    for r in reqs:
        if r.out.shape != (64,) or not ((0 <= r.out) & (r.out < cfg.vocab)).all():
            fail(f"request {r.rid}: bad output {r.out}")
    report["serve"] = {"requests": 8, "prompt": 64, "max_new": 64, "seconds": dt,
                       "new_tokens_per_s": 8 * 64 / dt,
                       "steps_per_s": steps / dt, "launches": d}
    print(f"[4 serve] smollm-360M bf16, 8 requests x (64 prompt + 64 new): "
          f"{dt:.2f} s, {8 * 64 / dt:.1f} new tokens/s, {steps / dt:.1f} "
          f"decode steps/s; launches per step: rmsnorm 65, decode_attention 32",
          flush=True)

    # 5. float32 parity, card against CPU, full width
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p_cpu = transformer.init(torch.Generator().manual_seed(SEED), cfg32,
                             device="cpu")
    p_gpu = tree_map(lambda a: a.to("cuda"), p_cpu)
    ptoks = torch.randint(0, cfg.vocab, (2, 32), generator=rng)
    lg_cpu = make_prefill_step(cfg32, device="cpu")(p_cpu, {"inputs": ptoks})
    lg_gpu = make_prefill_step(cfg32, device="cuda")(p_gpu, {"inputs": ptoks}).cpu()
    pre_err = float((lg_cpu - lg_gpu).abs().max())
    api = model_api(cfg32)
    errs = []
    with torch.no_grad():
        c_cpu = api.init_cache(cfg32, 2, 16, device="cpu")
        c_gpu = api.init_cache(cfg32, 2, 16, device="cuda")
        for t in range(8):
            a, c_cpu = api.decode_step(p_cpu, c_cpu, ptoks[:, t], t, cfg32)
            b, c_gpu = api.decode_step(p_gpu, c_gpu, ptoks[:, t].cuda(), t, cfg32)
            errs.append(float((a - b.cpu()).abs().max()))
    report["parity"] = {"prefill_max_abs_err": pre_err, "decode_max_abs_err": errs,
                        "tol": PARITY_TOL, "logit_abs_max": float(lg_cpu.abs().max())}
    print(f"[5 parity] float32 full width, card vs CPU: prefill last-token logits"
          f" max_abs_err {pre_err:.3e}, decode 8 steps max_abs_err "
          f"{max(errs):.3e} (tol {PARITY_TOL:g}; |logits| up to "
          f"{report['parity']['logit_abs_max']:.3f})", flush=True)
    if not (pre_err <= PARITY_TOL and max(errs) <= PARITY_TOL):
        fail(f"float32 card vs CPU logits differ: prefill {pre_err}, decode {errs}")
    del p_gpu, c_gpu

    # 6. where the time goes: one prefill, one decode step (bf16)
    step = make_decode_step(cfg, device="cuda")
    cache = model_api(cfg).init_cache(cfg, 8, 129, device="cuda")
    tok = toks[:, 0]
    prof = {"prefill": profile_call(lambda: prefill(params, {"inputs": toks})),
            "decode_step": profile_call(lambda: step(params, cache, tok, 64))}
    report["profile"] = prof
    print("[6 profile] " + "; ".join(
        f"{k}: wall {v['wall_ms']:.2f} ms, device busy {v['device_busy_ms']:.2f} ms "
        f"over {v['device_ops']} kernels and copies, "
        f"idle {v['idle_share']:.1%}, top {v['top'][0]['kernel'][:40]} "
        f"{v['top'][0]['ms']:.2f} ms" for k, v in prof.items()), flush=True)

    # the kernel table: main-path shapes, bf16
    table = []
    for name, (source, replaces, case) in KERNELS.items():
        r = next(r for r in rows if r["kernel"] == name and r["case"] == case
                 and r["dtype"] == "bfloat16")
        if main_counts[name] == 0:
            fail(f"{name} was never launched on the main path")
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": main_counts[name],
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    report["table"] = table
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
