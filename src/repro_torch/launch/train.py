"""End-to-end trainer (example entry point).

Counterpart of :mod:`repro.launch.train`: config -> params on the device ->
data pipeline -> train step (loss, backward through the CUDA kernels,
clip, AdamW with warmup + cosine) -> async checkpoints with resume.

With no process group it trains on one device (``mesh_shape`` None or
(1, 1)). In a process group that the caller started (``torchrun``, or
``torch.multiprocessing.spawn`` and ``init_process_group``; NCCL on the
card, gloo on the CPU) it builds ``make_mesh(mesh_shape or (world, 1),
("data", "model"))``, registers it with ``partitioning.set_mesh`` and trains
data-parallel over the batch axes (every axis under ``cfg.pure_dp``), with
ZeRO-3 over 'data' for ``cfg.force_fsdp`` or above 8e9 params (the
reference dry-run's rule): params and AdamW moments held as this rank's
slices (``shardings.param_shardings``; a ``pure_dp`` config's are whole, as
the reference's rules place them). A ``seq_shard`` config
(``h2o_danube_1_8b_seqp``, or ``overrides={"pure_dp": True, "seq_shard":
True}``) at a ``mesh_shape`` whose 'model' axis is above 1, e.g. (2, 4),
trains with the tokens over 'model' as well (``make_train_step``: the
ring, every sum over every axis). Every rank draws the same global batch
and the step takes its rows (and its tokens); losses and grad norms are
the global ones. Rank 0 saves whole tensors, gathered, and every rank
waits for the commit, so a checkpoint saved at one world
size resumes at another. On the card the train step is one
CUDA graph (the reference jits it), captured at the first step and replayed
after: each step copies its batch into the graph's buffers, replays, and
reads the loss and the grad norm (one sync). Params and optimizer state are
the graph's own tensors, written in place; a resumed checkpoint is copied
into them. ``train(..., graphs=False)`` runs the step eagerly. The vlm and
audio families get the stub frontends' patches or frames each step, drawn
from a generator of the (seed, step) pair. Under a mesh the vlm's text rows
are looked up in each rank's slices of the embedding (vocab-parallel over
'model', the rows' columns gathered over the fsdp axis under ZeRO-3), never
in a gathered table; ``frontend_counts`` counts those collectives.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 6
  PYTHONPATH=src python -m repro_torch.launch.train --full --steps 10 \\
      --batch 8 --seq 512

``train(..., overrides={"n_layers": 3, "mtp": False})`` cuts a config:
DeepSeek-V3's 3 dense-FFN prefix layers without its MTP module, or one
layer of Qwen3-MoE, are what one 80 GB card trains with AdamW at the
published widths; whisper-small trains whole (``--arch whisper_small
--full --seq 448``), llava-next-mistral-7b cut in depth (``overrides=
{"n_layers": ...}``, ``--seq`` above its 2,880 image tokens).
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.launch import shardings as SH
from repro_torch.launch.graphs import GraphedStep
from repro_torch.launch.mesh import batch_axes, fsdp_axis, make_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.layout import mesh_shape, shard_dim
from repro_torch.models import frontends, model_api
from repro_torch.models import partitioning as part
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.module import param_count, tree_map
from repro_torch.optim.optimizers import adamw, warmup_cosine

# ZeRO-3 above this many params, as the reference's dry-run decides
FSDP_PARAMS = 8e9

# the collectives this process ran outside the train step to build the vlm's
# embeds: ``all_reduce`` (the vocab-parallel lookup's sum over 'model') and
# ``all_gather`` (the looked-up rows' columns over the fsdp axis under
# ZeRO-3), each beside ``<kind>_bytes`` (the whole tensor's). The caller
# resets it (``frontend_counts.clear()``)
frontend_counts = collections.Counter()


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
    launches per replay; None when the step ran eagerly), 'mesh' and
    'shardings' (the params' placements: 'params' and 'opt_state' hold
    this rank's slices; both None with no process group)}. With
    ``ckpt_dir`` it resumes from the last committed checkpoint there and
    saves every ``ckpt_every`` steps. ``overrides`` replaces config fields
    (``dataclasses.replace``), e.g. ``{"n_layers": 3, "mtp": False}``.
    ``mesh_shape`` other than None or (1, 1) needs a process group of
    its size."""
    dev = resolve_device(device)
    grouped = dist.is_available() and dist.is_initialized()
    if not grouped and mesh_shape is not None and tuple(mesh_shape) != (1, 1):
        raise RuntimeError(
            f"mesh_shape {tuple(mesh_shape)} needs an initialised process "
            "group of its size: start the ranks (torchrun, or "
            "torch.multiprocessing.spawn and init_process_group) first")
    mesh = make_mesh(mesh_shape or (dist.get_world_size(), 1),
                     ("data", "model"), device_type=dev.type) \
        if grouped else None
    part.set_mesh(mesh, batch_axes(mesh) if mesh is not None else ("data",))
    try:
        return _train(arch, smoke, steps, batch, seq, lr, ckpt_dir,
                      ckpt_every, log_every, width_mult, seed, dev, graphs,
                      overrides, mesh)
    finally:
        part.set_mesh(None)


def _train(arch, smoke, steps, batch, seq, lr, ckpt_dir, ckpt_every,
           log_every, width_mult, seed, dev, graphs, overrides, mesh):
    cfg = dataclasses.replace(get(arch, smoke=smoke), **(overrides or {}))
    if cfg.family == "vlm" and seq < cfg.img_tokens:
        raise ValueError(f"{cfg.name}: seq {seq} is shorter than its "
                         f"{cfg.img_tokens} image tokens")
    if width_mult > 1:                          # scale toward ~100M on demand
        cfg = dataclasses.replace(
            cfg, d_model=cfg.d_model * width_mult,
            d_ff=cfg.d_ff * width_mult)
    api = model_api(cfg)
    optimizer = adamw(warmup_cosine(lr, warmup=max(steps // 10, 1),
                                    total=steps))
    params = api.init(torch.Generator(device=dev).manual_seed(seed), cfg,
                      device=dev)
    p_shards = o_shards = None
    if mesh is not None:
        fsdp = cfg.force_fsdp or param_count(params) > FSDP_PARAMS
        p_shards = SH.param_shardings(cfg, params, mesh, fsdp)
        params = SH.shard_tree(params, p_shards, mesh)
        o_shards = {"mu": p_shards, "nu": p_shards, "step": None}
    opt_state = optimizer.init(params)
    step_fn = make_train_step(cfg, optimizer, device=dev, graphs=graphs,
                              mesh=mesh, shardings=p_shards)
    rank0 = mesh is None or dist.get_rank() == 0
    gather = None if mesh is None else _text_gather(mesh, p_shards)

    source = SyntheticLM(batch, seq, cfg.vocab, seed=seed)
    start_step = 0
    if ckpt_dir:
        last = ckpt.latest_step(ckpt_dir)
        if last is not None:
            loaded, extra = ckpt.restore(
                ckpt_dir, last, (params, opt_state),
                shardings=None if mesh is None else (p_shards, o_shards),
                mesh=mesh)
            # into the tensors the step is bound to, not in their place
            tree_map(lambda dst, src: dst.copy_(src), (params, opt_state),
                     loaded)
            source.restore(extra["data"])
            start_step = last
            if rank0:
                print(f"[train] resumed from step {last}")
    data = Prefetcher(source)
    saver = ckpt.AsyncCheckpointer()
    losses, grad_norms, step_s = [], [], []
    capture = None
    t0 = time.time()
    try:
        for step in range(start_step, steps):
            raw = data.next_batch()
            ts = time.perf_counter()
            b = _frontend_batch(cfg, params, raw, seed, step, seq, dev, gather)
            params, opt_state, metrics = step_fn(params, opt_state, b)
            losses.append(float(metrics["loss"]))
            step_s.append(time.perf_counter() - ts)
            grad_norms.append(float(metrics["grad_norm"]))
            if rank0 and (step % log_every == 0 or step == steps - 1):
                print(f"[train] step={step} loss={losses[-1]:.4f} "
                      f"grad_norm={grad_norms[-1]:.3f} "
                      f"({time.time() - t0:.1f}s)", flush=True)
            if ckpt_dir and (step + 1) % ckpt_every == 0:
                extra = {"data": data.state(), "loss": losses[-1]}
                # whole tensors (gathered under a mesh), written by rank 0
                whole = (params, opt_state) if mesh is None else \
                    SH.gather_tree((params, opt_state), (p_shards, o_shards),
                                   mesh)
                if rank0:
                    saver.save(ckpt_dir, step + 1, whole, extra)
                del whole
                if mesh is not None:        # every rank waits for the commit
                    saver.join()
                    dist.barrier()
    finally:
        data.close()
        saver.join()
        if isinstance(step_fn, GraphedStep):
            capture = next((g.stats for g in step_fn.graphs.values()), None)
            step_fn.release()
    return {"losses": losses, "grad_norms": grad_norms, "step_s": step_s,
            "params": params, "opt_state": opt_state, "cfg": cfg,
            "start_step": start_step, "capture": capture, "mesh": mesh,
            "shardings": p_shards}


def _frontend_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator of its own for each (seed, step), as the reference folds
    the step into its key (``jax.random.fold_in``)."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def _text_gather(mesh, shardings):
    """Where ZeRO-3 holds the embedding's columns over the fsdp axis (of
    more than one rank): the all-gather of looked-up rows' columns over it,
    counted in ``frontend_counts``; else None."""
    axis = fsdp_axis(mesh)
    dim = None if axis is None else shard_dim(shardings["embed"], mesh, axis)
    if dim is None or mesh_shape(mesh)[axis] == 1:
        return None
    group, size = mesh.get_group(axis), mesh_shape(mesh)[axis]

    def gather(rows):
        out = SH.gather_dim(rows, rows.dim() - 2 + dim, group, size)
        frontend_counts["all_gather"] += 1
        frontend_counts["all_gather_bytes"] += out.numel() * out.element_size()
        return out
    return gather


def _frontend_batch(cfg, params, raw, seed: int, step: int, seq: int, dev,
                    gather=None):
    """The step's batch: the data pipeline's tokens and labels, and for the
    modality families the stub frontend's output, as the reference builds
    it outside its jitted step. vlm: ``embeds`` = [image patches; the
    embedding of the first ``seq - img_tokens`` tokens] with all ``seq``
    labels, made with no gradient (data to the step, as in the reference:
    the embedding takes no gradient through it); ``params`` may hold this
    rank's slices of the embedding (``fuse_vlm_inputs``: the lookup's sum
    over 'model', and ``gather`` for its columns, counted in
    ``frontend_counts``). audio: ``frames`` beside the tokens."""
    b = {"inputs": raw["inputs"], "labels": raw["labels"]}
    if cfg.family == "vlm":
        with torch.no_grad():
            patches = frontends.image_patches(
                _frontend_generator(seed, step, dev), cfg, len(raw["inputs"]),
                device=dev)
            text = torch.as_tensor(raw["inputs"][:, :seq - cfg.img_tokens],
                                   device=dev)
            before = tp.counts.copy()
            embeds = frontends.fuse_vlm_inputs(params, patches, text, cfg,
                                               gather)
            frontend_counts.update(tp.counts - before)
            b = {"embeds": embeds, "labels": raw["labels"]}
    elif cfg.family == "audio":
        b["frames"] = frontends.audio_frames(
            _frontend_generator(seed, step, dev), cfg, len(raw["inputs"]),
            device=dev)
    return b


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
