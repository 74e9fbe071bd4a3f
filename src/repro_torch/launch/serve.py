"""Batched decode server (example driver).

Counterpart of :mod:`repro.launch.serve`. A batch of requests is grouped
into fixed slots, prompts are prefilled token by token into per-slot caches
(KV caches, MLA's compressed caches, and the Mamba/xLSTM states, which
therefore take the one-step ``mamba_step`` and never the prefill scan),
then decode steps run the whole
batch in lockstep. An encoder-decoder (whisper) is served as the reference
serves it: its cross K/V caches are zeros (no audio is encoded), so the
decoder runs over them; a vlm backbone (llava) is served on text prompts.
On the card each step replays one CUDA graph of the decode step
(captured at the first step; the reference jits it): the step's tokens
and position are copied into the graph's buffers and the graph writes the
cache in place. Copying each step's next tokens to the host is
the one sync per step, as the reference's ``np.asarray(nxt)`` is.
``--eager`` (``serve_batch(..., step_fn=make_decode_step(cfg,
graphs=False))``) runs the same step eagerly, for comparison.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m --full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm_125m --full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek_v3_671b \
      --full --layers 5
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper_small --full
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch llava_next_mistral_7b --full

``--layers`` cuts the depth (DeepSeek-V3's 3 dense layers + 2 MoE layers
fit one 80 GB card; its 61 do not; an encoder-decoder's decoder only). The
server builds no MTP module: only the training loss reads it.
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
from repro_torch.launch.graphs import GraphedStep
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
                device="cuda", step_fn=None):
    """Run one batch of requests to completion with greedy decoding;
    returns (requests, seconds). The seconds include the decode step's
    capture (the reference's include its jit).

    ``step_fn`` is the decode step to run: by default
    ``make_decode_step(cfg)`` on ``device`` (graphed on the card), whose
    graphs are released on return. A step the caller passes (the eager
    one, or a graphed one whose ``StepGraph.stats`` it reads) stays the
    caller's to release.

    Positions run up to ``longest prompt + max_new - 1``. Unless the KV
    cache is a ring of the sliding window (a window of at most ``max_len``)
    they must fit its ``max_len`` slots, else ValueError, raised before any
    step: on the card an index past the cache would fail on the device,
    inside the replayed graph."""
    dev = resolve_device(device)
    api = model_api(cfg)
    b = len(requests)
    maxp = max(len(r.prompt) for r in requests)
    max_new = max(r.max_new for r in requests)
    ring = bool(cfg.window) and cfg.window <= max_len
    if (any(m in ("attn", "mla") for m, _ in cfg.period) and not ring
            and maxp + max_new > max_len):
        raise ValueError(
            f"serve_batch: prompts of up to {maxp} tokens and {max_new} new "
            f"ones need {maxp + max_new} KV cache slots, max_len is "
            f"{max_len} (window {cfg.window})")
    own = step_fn is None
    if own:
        step_fn = make_decode_step(cfg, device=dev)
    cache = api.init_cache(cfg, b, max_len=max_len, device=dev)
    pad = np.zeros((b, maxp), np.int32)
    for i, r in enumerate(requests):
        pad[i, :len(r.prompt)] = r.prompt
    t0 = time.time()
    prompts = torch.as_tensor(pad, device=dev)
    outs = [[] for _ in range(b)]
    try:
        # prefill (token-by-token; each step also warms the caches)
        for t in range(maxp):
            nxt, _, cache = step_fn(params, cache, prompts[:, t], t)
        cur = nxt.cpu().numpy()
        for t in range(maxp, maxp + max_new):
            for i in range(b):
                outs[i].append(int(cur[i]))
            nxt, _, cache = step_fn(params, cache, nxt, t)
            cur = nxt.cpu().numpy()
    finally:
        if own and isinstance(step_fn, GraphedStep):
            step_fn.release()
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
    ap.add_argument("--eager", action="store_true",
                    help="run the decode step eagerly, not from a CUDA graph")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    # serving never reads the MTP module: build none
    cfg = dataclasses.replace(get(args.arch, smoke=not args.full), mtp=False)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    api = model_api(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = api.init(gen, cfg, device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab, args.prompt_len,
                                    dtype=np.int32), args.max_new)
            for i in range(args.requests)]
    step_fn = (make_decode_step(cfg, device=dev, graphs=False)
               if args.eager else None)
    reqs, dt = serve_batch(cfg, params, reqs,
                           max_len=args.prompt_len + args.max_new + 1,
                           device=dev, step_fn=step_fn)
    toks = sum(r.max_new for r in reqs)
    mode = "eager" if args.eager or dev.type != "cuda" else "graphed"
    print(f"[serve] {cfg.name} on {dev} ({mode}): {len(reqs)} requests, "
          f"{toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s batched)")
    for r in reqs[:2]:
        print(f"  req {r.rid}: {r.out[:10]}...")
    return reqs


if __name__ == "__main__":
    main()
