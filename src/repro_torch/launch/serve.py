"""Batched decode server (example driver).

Counterpart of :mod:`repro.launch.serve`. A batch of requests is grouped
into fixed slots, prompts are prefilled token by token into per-slot caches
(KV caches, and the Mamba/xLSTM states, which therefore take the one-step
``mamba_step`` and never the prefill scan), then decode steps run the whole
batch in lockstep. Steps run eagerly on the device; copying each step's
next tokens to the host is the one sync per step.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m --full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm_125m --full
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get
from repro_torch.launch.steps import make_decode_step
from repro_torch.models import model_api


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (P,) int32
    max_new: int
    out: Optional[np.ndarray] = None
    latency_s: float = 0.0


def serve_batch(cfg, params, requests: List[Request], max_len: int = 256,
                device="cuda"):
    """Run one batch of requests to completion with greedy decoding;
    returns (requests, seconds)."""
    dev = resolve_device(device)
    api = model_api(cfg)
    b = len(requests)
    step_fn = make_decode_step(cfg, device=dev)
    cache = api.init_cache(cfg, b, max_len=max_len, device=dev)
    maxp = max(len(r.prompt) for r in requests)
    pad = np.zeros((b, maxp), np.int32)
    for i, r in enumerate(requests):
        pad[i, :len(r.prompt)] = r.prompt
    t0 = time.time()
    prompts = torch.as_tensor(pad, device=dev)
    outs = [[] for _ in range(b)]
    # prefill (token-by-token; each step also warms the caches)
    for t in range(maxp):
        nxt, _, cache = step_fn(params, cache, prompts[:, t], t)
    cur = nxt.cpu().numpy()
    max_new = max(r.max_new for r in requests)
    for t in range(maxp, maxp + max_new):
        for i in range(b):
            outs[i].append(int(cur[i]))
        nxt, _, cache = step_fn(params, cache, nxt, t)
        cur = nxt.cpu().numpy()
    dt = time.time() - t0
    for i, r in enumerate(requests):
        r.out = np.asarray(outs[i][:r.max_new], np.int32)
        r.latency_s = dt
    return requests, dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="full-size config (default: the SMOKE config)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get(args.arch, smoke=not args.full)
    api = model_api(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = api.init(gen, cfg, device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab, args.prompt_len,
                                    dtype=np.int32), args.max_new)
            for i in range(args.requests)]
    reqs, dt = serve_batch(cfg, params, reqs,
                           max_len=args.prompt_len + args.max_new + 1,
                           device=dev)
    toks = sum(r.max_new for r in reqs)
    print(f"[serve] {cfg.name} on {dev}: {len(reqs)} requests, {toks} tokens "
          f"in {dt:.2f}s ({toks / dt:.1f} tok/s batched)")
    for r in reqs[:2]:
        print(f"  req {r.rid}: {r.out[:10]}...")


if __name__ == "__main__":
    main()
