"""Multi-pod dry-run: one rank's step at the production mesh, on fake tensors.

Counterpart of the reference's ``launch/dryrun.py``. For each (arch x input
shape x mesh) cell it runs **rank 0's program** of the port's
``make_train_step`` / ``make_prefill_step`` / ``make_decode_step`` on the
16x16 (or 2x16x16) mesh, under ``FakeTensorMode``: the tensors are fake CPU
tensors with this rank's shapes (params, optimizer state and caches laid
out by the sharding rules, ZeRO-3 above 8e9 params as the reference's),
nothing is allocated, and each kernel runs as its operator's shape-only
version (``kernels._checks``). The process group is
``torch.distributed``'s fake backend of 256 / 512 ranks, in which every
collective returns at once; it is started and destroyed by each cell (the
group is process-global, so a cell runs alone in its process). Where the
reference shards a jitted step with GSPMD, the port's rank runs its slice
of the step itself, so the collectives counted are the ones its layers run.

The record (:class:`CellResult`, the reference's fields and JSON):

* ``flops``: ``FlopCounterMode``'s total for one rank, each kernel counted
  by its operator's flop formula. The reference's ``flops`` is per device
  too (``benchmarks/roofline.py`` divides only ``extra_flops`` by the
  device count);
* ``bytes_accessed``: each operation's input plus output bytes (views and
  collectives left out), an unfused upper bound;
* ``coll``: bytes of each collective's result by kind, and ``count``,
  counted by a dispatch mode over the ``c10d`` operations (an all-reduce's
  tensors, an all-gather's gathered output, a reduce-scatter's shard, a
  send's or receive's tensor as ``collective-permute``);
* ``peak_bytes_per_device``: the peak of live fake storage
  (``torch.distributed._tools.mem_tracker.MemTracker``), the params,
  optimizer state and caches included, plus this rank's rows of the batch;
* ``param_bytes_per_device``, ``opt_bytes_per_device`` and
  ``cache_bytes_per_device``: from the rules, as the reference's
  ``_bytes_per_device`` computes them.

There is no scan-body correction and no sLSTM correction: the reference
lowers the period body again because XLA's cost analysis counts a
``while`` body once, and adds the sLSTM time scan's flops by formula for
the same reason. The port's layer loop is Python, so every layer is
counted as it runs: ``body_repeats`` records ``n_periods`` and
``extra_flops`` stays 0. The sLSTM time loop is Python too, and a step on
fake tensors passes through four dispatch modes, so a train or prefill
cell of a config with sLSTM layers would take an hour at 4k-32k tokens.
There the cell is measured twice, with the loop cut to
``CUT_STEPS`` = (2, 3) steps (:class:`CutLoop`, read by
``ssm.slstm_apply`` for fake tensors only), and each count is
extrapolated to the
whole sequence: every step of the loop, forward and backward, costs the
same, so flops, bytes, each collective's count and bytes, and every
operator's flops are affine in the steps run (the skipped steps' places
in the output are filled outside the count). The peak is not (it is a
maximum): the first run measures how much live memory each loop's step
adds (its saved tensors and its output), and the second holds an
uncounted stand-in of that much for each skipped step, for as long as the
loop's own steps hold theirs (to the end of the loop without grad; to the
loop's backward with it); its peak is the cell's.
``tests/test_torch_dryrun.py`` holds all of them equal to the whole
loop's at 32 and 64 tokens.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results.jsonl]
Cells already present in --out are skipped (a resumable sweep).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import all_archs, get
from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import (SHAPES, cell_plan, decode_input_specs,
                                      train_batch_specs)
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.layout import sharded_axes
from repro_torch.models import model_api, ssm
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.optim.optimizers import pick_optimizer

# the two lengths of the cut sLSTM loop whose counts are extrapolated
CUT_STEPS = (2, 3)

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# c10d operation -> (kind, index of the argument that holds its result)
_C10D = {
    "allreduce_": ("all-reduce", 0), "allreduce_coalesced_": ("all-reduce", 0),
    "_allgather_base_": ("all-gather", 0), "allgather_": ("all-gather", 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0),
    "allgather_coalesced_": ("all-gather", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 0),
    "reduce_scatter_": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0),
    "alltoall_": ("all-to-all", 0), "alltoall_base_": ("all-to-all", 0),
    "send": ("collective-permute", 0), "recv_": ("collective-permute", 0),
    "broadcast_": ("all-gather", 0),
}


def _nbytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


class OpCounter(TorchDispatchMode):
    """Bytes that operations read and write, and the collectives' result
    bytes by kind (``coll``) with their count, of what runs under it."""

    def __init__(self):
        super().__init__()
        self.bytes_accessed = 0
        self.coll: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
        self.coll["count"] = 0

    # set while the dry-run makes what it leaves out of the count
    paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if OpCounter.paused or func.namespace == "prim":
            pass                    # a tensor's metadata read: no access
        elif func.namespace == "c10d":
            name = func._schema.name.split("::")[1]
            if name in _C10D:
                kind, at = _C10D[name]
                self.coll[kind] += _nbytes(args[at])
                self.coll["count"] += 1
        elif not func.is_view:
            self.bytes_accessed += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def _bytes_per_device(tree, shards, mesh) -> float:
    """Bytes a device holds of ``tree`` laid out by ``shards`` (a tree of
    placements): each leaf's bytes over the sizes of the axes that shard
    it."""
    total = [0.0]

    def one(leaf, pl):
        frac = 1.0
        for _, _, n in sharded_axes(pl, mesh):
            frac /= n
        total[0] += leaf.numel() * leaf.element_size() * frac
    tree_map(one, tree, shards)
    return total[0]


def _local_fake(tree, shards, mesh, mode):
    """Fake CPU tensors of this rank's slices of ``tree`` (meta tensors of
    the whole shapes) under ``shards``."""
    def one(t, pl):
        shape = list(t.shape)
        for _, dim, n in sharded_axes(pl, mesh):
            shape[dim] //= n
        with mode:
            return torch.empty(shape, dtype=t.dtype, device="cpu")
    return tree_map(one, tree, shards)


def _fake(tree, mode):
    """Fake CPU tensors of ``tree``'s (meta) shapes, whole."""
    def one(t):
        with mode:
            return torch.empty(t.shape, dtype=t.dtype, device="cpu")
    return tree_map(one, tree)


@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    status: str                     # ok | skipped | error
    reason: str = ""
    wall_s: float = 0.0
    flops: float = 0.0              # one device's step
    bytes_accessed: float = 0.0
    coll: Optional[Dict[str, float]] = None
    peak_bytes_per_device: float = 0.0
    param_bytes_per_device: float = 0.0
    opt_bytes_per_device: float = 0.0
    cache_bytes_per_device: float = 0.0
    n_params: float = 0.0
    n_active: float = 0.0
    optimizer: str = ""
    body_repeats: int = 0
    extra_flops: float = 0.0        # none: every loop iteration runs

    def to_json(self):
        return json.dumps(dataclasses.asdict(self))


def _start_fake_group(world: int) -> None:
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("dry-run: a process group is already initialised; "
                           "run each cell in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             fsdp_threshold: float = 8e9, *, mesh_dims=None, seq=None,
             batch=None, cfg: Optional[ModelConfig] = None,
             detail: Optional[dict] = None,
             cut_loop: bool = True) -> CellResult:
    """The dry-run of one cell. ``mesh_dims`` ((data, model) or (pod,
    data, model)), ``seq``, ``batch`` and ``cfg`` replace the production
    mesh, the shape's sequence and batch and the arch's config (a smaller
    cell of the same kind). ``detail``, a dict, takes the flops by
    operator ('flops_by_op') and the collectives over 'model' that the
    layers counted ('tp_counts', ``tensor_parallel.counts``).
    ``cut_loop=False`` runs every step of the sLSTM loop (the measurement
    that the cut loop's extrapolation stands in for)."""
    shape = tuple(mesh_dims or ((2, 16, 16) if multi_pod else (16, 16)))
    mesh_name = "x".join(map(str, shape))
    cfg = cfg or get(arch)
    t0 = time.time()
    skip = cell_plan(cfg, shape_name)
    if skip:
        return CellResult(arch, shape_name, mesh_name, "skipped", skip)
    seq0, batch0, kind = SHAPES[shape_name]
    seq, batch = seq or seq0, batch or batch0
    n_params, n_active = cfg.param_count()
    res = CellResult(arch, shape_name, mesh_name, "ok",
                     n_params=float(n_params), n_active=float(n_active),
                     body_repeats=cfg.n_periods)
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    detail = {} if detail is None else detail
    fsdp = cfg.force_fsdp or n_params > fsdp_threshold
    cut = cut_loop and kind != "decode" and seq > CUT_STEPS[1] and \
        any(mixer == "slstm" for mixer, _ in cfg.period)
    _start_fake_group(math.prod(shape))
    try:
        mesh = make_mesh(shape, axes, device_type="cpu")
        if not cut:
            _run(res, cfg, mesh, kind, seq, batch, fsdp, detail)
        else:
            runs, grows = [], []
            for steps in CUT_STEPS:
                one, more = dataclasses.replace(res), {}
                with CutLoop(steps, grows, measure=not runs):
                    _run(one, cfg, mesh, kind, seq, batch, fsdp, more)
                runs.append((one, more))
            _extrapolate(res, detail, runs, seq)
    finally:
        dist.destroy_process_group()
    res.wall_s = time.time() - t0
    return res


class _Hold(torch.autograd.Function):
    """The identity on ``x`` that saves ``pad`` for its backward, which runs
    once every use of ``x`` has its gradient. ``pad`` is an empty view of
    the stand-in's storage: remat's recompute checks that it saves tensors
    of the shapes the forward saved, and :class:`OpCounter` counts a
    tensor's bytes wherever an operation reads its metadata."""

    @staticmethod
    def forward(ctx, x, pad):
        ctx.save_for_backward(pad)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class CutLoop:
    """The sLSTM time loop of fake tensors cut to ``steps`` steps
    (``ssm.CUT_LOOP`` while it is entered). With ``measure``, each loop
    appends to ``grows`` the live bytes that one of its steps adds (after
    the first: that one also holds the state's first values); otherwise
    each loop takes the next of ``grows``, in the same order of calls, and
    holds a stand-in of that many bytes for each step it skips, through
    ``wx``: the stand-in lives as long as the loop's inputs are needed
    (its output stacked, and, with grad, until the loop's backward is
    done), as the skipped steps' tensors would. The stand-in is made
    outside :class:`OpCounter`'s count."""

    def __init__(self, steps: int, grows: list, measure: bool):
        self.steps, self.grows, self.measure = steps, grows, measure
        self.calls = 0

    def __enter__(self):
        self.prev, ssm.CUT_LOOP = ssm.CUT_LOOP, self
        return self

    def __exit__(self, *exc):
        ssm.CUT_LOOP = self.prev

    def begin(self, wx, s: int):
        n = min(s, self.steps)
        if self.measure:
            self.live = []
            nbytes = 0
        else:
            nbytes = self.grows[self.calls] * (s - n)
        self.calls += 1
        OpCounter.paused = True
        try:
            self.pad = torch.empty((nbytes,), dtype=torch.uint8)[:0]
            wx = _Hold.apply(wx, self.pad)
        finally:
            OpCounter.paused = False
        return n, wx

    def after_step(self):
        if self.measure:
            self.live.append(sum(
                m["Total"] for m in
                self.tracker.get_tracker_snapshot("current").values()))

    def stack(self, hs, s: int):
        """The loop's (B, ``s``, D) output from the outputs ``hs`` of the
        steps it ran: their stack (counted: it is the whole loop's stack
        at ``s`` steps), then the last one's values, detached, in the
        skipped steps' places (uncounted, no gradient)."""
        h = torch.stack(hs, dim=1)
        if len(hs) == s:
            return h
        OpCounter.paused = True
        try:
            tail = hs[-1].detach()[:, None].expand(-1, s - len(hs), -1)
            return torch.cat([h, tail], dim=1)
        finally:
            OpCounter.paused = False

    def end(self):
        if self.measure:
            self.grows.append(self.live[1] - self.live[0])
        self.pad = None


def _extrapolate(res: CellResult, detail: dict, runs, seq: int) -> None:
    """``res`` and ``detail`` at ``seq`` steps of the sLSTM loop from the
    runs at ``CUT_STEPS`` steps, one step apart: each count at n + 1 steps
    is the one at n plus one step's."""
    (a, da), (b, db) = runs
    more = seq - CUT_STEPS[1]

    def line(x, y):
        return y + (y - x) * more

    def lines(x, y):
        return {k: line(x.get(k, 0), y.get(k, 0)) for k in {**x, **y}}

    for f in ("flops", "bytes_accessed"):
        setattr(res, f, float(line(getattr(a, f), getattr(b, f))))
    res.coll = lines(a.coll, b.coll)
    # the second run holds the skipped steps' stand-ins
    for f in ("peak_bytes_per_device", "param_bytes_per_device",
              "opt_bytes_per_device", "cache_bytes_per_device", "optimizer"):
        setattr(res, f, getattr(b, f))
    detail["flops_by_op"] = lines(da["flops_by_op"], db["flops_by_op"])
    detail["tp_counts"] = lines(da["tp_counts"], db["tp_counts"])


def _run(res: CellResult, cfg: ModelConfig, mesh, kind: str, seq: int,
         batch: int, fsdp: bool, detail: dict) -> None:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    api = model_api(cfg)
    meta = api.init(torch.Generator(), cfg, device="meta")
    p_shards = SH.param_shardings(cfg, meta, mesh, fsdp)
    res.param_bytes_per_device = _bytes_per_device(meta, p_shards, mesh)
    mode = FakeTensorMode()
    params = _local_fake(meta, p_shards, mesh, mode)
    held = tree_leaves(params)
    rows = 0
    if kind == "train":
        res.optimizer, optimizer = pick_optimizer(res.n_params, 1e-4)
        opt_meta = optimizer.init(meta)
        o_shards = SH.param_shardings(cfg, opt_meta, mesh, fsdp)
        res.opt_bytes_per_device = _bytes_per_device(opt_meta, o_shards, mesh)
        with mode:
            opt_state = optimizer.init(params)
        held += tree_leaves(opt_state)
    if kind in ("train", "prefill"):
        specs = train_batch_specs(cfg, seq, batch)
        data = _fake(specs, mode)
        b_shards = SH.input_shardings(cfg, specs, mesh)
        rows = _bytes_per_device(specs, b_shards, mesh)
    else:
        cache_meta, tok, _ = decode_input_specs(cfg, seq, batch)
        c_shards = SH.cache_shardings(cfg, cache_meta, mesh)
        res.cache_bytes_per_device = _bytes_per_device(cache_meta, c_shards,
                                                       mesh)
        cache = _local_fake(cache_meta, c_shards, mesh, mode)
        held += tree_leaves(cache)
        tokens, pos = _fake(tok, mode), _fake(torch.empty((), dtype=torch.int32,
                                                          device="meta"), mode)
    counter = OpCounter()
    flops = FlopCounterMode(display=False)
    tracker = MemTracker()
    tracker.track_external(*held)
    if ssm.CUT_LOOP is not None:
        ssm.CUT_LOOP.tracker = tracker
    tp.counts.clear()
    with mode, tracker, flops, counter:
        if kind == "train":
            make_train_step(cfg, optimizer, device="cpu", graphs=False,
                            mesh=mesh, shardings=p_shards)(params, opt_state, data)
        elif kind == "prefill":
            make_prefill_step(cfg, device="cpu", graphs=False, mesh=mesh,
                              shardings=p_shards)(params, data)
        else:
            make_decode_step(cfg, device="cpu", graphs=False, mesh=mesh,
                             shardings=p_shards,
                             cache_shardings=c_shards)(params, cache, tokens, pos)
    res.flops = float(flops.get_total_flops())
    detail["flops_by_op"] = {str(k): v for k, v in
                             flops.get_flop_counts()["Global"].items()}
    detail["tp_counts"] = dict(tp.counts)
    res.bytes_accessed = float(counter.bytes_accessed)
    res.coll = dict(counter.coll)
    peak = tracker.get_tracker_snapshot("peak")
    res.peak_bytes_per_device = float(max(v["Total"] for v in peak.values())
                                      + rows)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    archs = all_archs() if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    done = set()
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r["mesh"]))
                except (ValueError, KeyError):
                    pass

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "2x16x16" if mp else "16x16"
                key = (arch.replace("_", "-"), shape, mesh_name)
                norm_key = (get(arch).name, shape, mesh_name)
                if args.out and (key in done or norm_key in done):
                    print(f"[skip existing] {arch} {shape} {mesh_name}")
                    continue
                print(f"[dryrun] {arch} {shape} {mesh_name} ...", flush=True)
                try:
                    res = run_cell(arch, shape, mp)
                except Exception as e:
                    res = CellResult(arch, shape, mesh_name, "error",
                                     reason=f"{type(e).__name__}: {e}\n"
                                     + traceback.format_exc()[-2000:])
                res.arch = get(arch).name
                print(f"  -> {res.status} flops={res.flops:.3e} "
                      f"peak/dev={res.peak_bytes_per_device/2**30:.2f}GiB "
                      f"wall={res.wall_s:.1f}s "
                      f"{res.reason.splitlines()[0] if res.reason else ''}",
                      flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(res.to_json() + "\n")


if __name__ == "__main__":
    main()
