"""End-to-end trainer (example entry point).

Counterpart of :mod:`repro.launch.train`: config -> params on the device ->
data pipeline -> train step (loss, backward through the CUDA kernels,
clip, AdamW with warmup + cosine) -> async checkpoints with resume. The port
has no mesh yet: it trains on one device. On the card the train step is one
CUDA graph (the reference jits it), captured at the first step and replayed
after: each step copies its batch into the graph's buffers, replays, and
reads the loss and the grad norm (one sync). Params and optimizer state are
the graph's own tensors, written in place; a resumed checkpoint is copied
into them. ``train(..., graphs=False)`` runs the step eagerly.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 6
  PYTHONPATH=src python -m repro_torch.launch.train --full --steps 10 \\
      --batch 8 --seq 512

``train(..., overrides={"n_layers": 3, "mtp": False})`` cuts a config:
DeepSeek-V3's 3 dense-FFN prefix layers without its MTP module, or one
layer of Qwen3-MoE, are what one 80 GB card trains with AdamW at the
published widths.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.launch.graphs import GraphedStep
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model_api
from repro_torch.models.module import tree_map
from repro_torch.optim.optimizers import adamw, warmup_cosine


def train(arch: str, smoke: bool = True, steps: int = 50, batch: int = 8,
          seq: int = 128, lr: float = 3e-4, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 25, mesh_shape=None, log_every: int = 10,
          width_mult: int = 1, seed: int = 0, device="cuda",
          graphs: bool = True, overrides: Optional[dict] = None):
    """Train ``arch`` for ``steps`` steps on ``device`` and return
    {'losses', 'grad_norms', 'step_s' (wall seconds of each step, ended by
    reading its loss; the first includes the capture on the card),
    'params', 'opt_state', 'cfg', 'start_step', 'capture' (the train
    step's ``StepGraph.stats``: warm-up and capture seconds, pool bytes,
    launches per replay; None when the step ran eagerly)}. With
    ``ckpt_dir`` it resumes from the last committed checkpoint there and
    saves every ``ckpt_every`` steps. ``overrides`` replaces config fields
    (``dataclasses.replace``), e.g. ``{"n_layers": 3, "mtp": False}``."""
    dev = resolve_device(device)
    if mesh_shape is not None and tuple(mesh_shape) != (1, 1):
        raise NotImplementedError(
            f"mesh_shape {mesh_shape}: the port trains on one device; meshes "
            "come with ROADMAP.md queue 1, item 6")
    cfg = dataclasses.replace(get(arch, smoke=smoke), **(overrides or {}))
    if cfg.family in ("vlm", "audio"):
        raise NotImplementedError(
            f"{cfg.name}: the vlm and audio frontends come with ROADMAP.md "
            "queue 1, item 4")
    if width_mult > 1:                          # scale toward ~100M on demand
        cfg = dataclasses.replace(
            cfg, d_model=cfg.d_model * width_mult,
            d_ff=cfg.d_ff * width_mult)
    api = model_api(cfg)
    optimizer = adamw(warmup_cosine(lr, warmup=max(steps // 10, 1),
                                    total=steps))
    params = api.init(torch.Generator(device=dev).manual_seed(seed), cfg,
                      device=dev)
    opt_state = optimizer.init(params)

    source = SyntheticLM(batch, seq, cfg.vocab, seed=seed)
    start_step = 0
    if ckpt_dir:
        last = ckpt.latest_step(ckpt_dir)
        if last is not None:
            loaded, extra = ckpt.restore(ckpt_dir, last, (params, opt_state))
            # into the tensors the step is bound to, not in their place
            tree_map(lambda dst, src: dst.copy_(src), (params, opt_state),
                     loaded)
            source.restore(extra["data"])
            start_step = last
            print(f"[train] resumed from step {last}")
    data = Prefetcher(source)
    saver = ckpt.AsyncCheckpointer()
    step_fn = make_train_step(cfg, optimizer, device=dev, graphs=graphs)
    losses, grad_norms, step_s = [], [], []
    capture = None
    t0 = time.time()
    try:
        for step in range(start_step, steps):
            raw = data.next_batch()
            ts = time.perf_counter()
            b = {"inputs": raw["inputs"], "labels": raw["labels"]}
            params, opt_state, metrics = step_fn(params, opt_state, b)
            losses.append(float(metrics["loss"]))
            step_s.append(time.perf_counter() - ts)
            grad_norms.append(float(metrics["grad_norm"]))
            if step % log_every == 0 or step == steps - 1:
                print(f"[train] step={step} loss={losses[-1]:.4f} "
                      f"grad_norm={grad_norms[-1]:.3f} "
                      f"({time.time() - t0:.1f}s)", flush=True)
            if ckpt_dir and (step + 1) % ckpt_every == 0:
                saver.save(ckpt_dir, step + 1, (params, opt_state),
                           extra={"data": source.state(),
                                  "loss": losses[-1]})
    finally:
        data.close()
        saver.join()
        if isinstance(step_fn, GraphedStep):
            capture = next((g.stats for g in step_fn.graphs.values()), None)
            step_fn.release()
    return {"losses": losses, "grad_norms": grad_norms, "step_s": step_s,
            "params": params, "opt_state": opt_state, "cfg": cfg,
            "start_step": start_step, "capture": capture}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--full", action="store_true",
                    help="full-size config (default: the SMOKE config)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--width-mult", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = train(args.arch, smoke=not args.full, steps=args.steps,
                batch=args.batch, seq=args.seq, lr=args.lr,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                width_mult=args.width_mult, device=args.device)
    first = np.mean(out["losses"][:5])
    last = np.mean(out["losses"][-5:])
    print(f"[train] loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")


if __name__ == "__main__":
    main()
