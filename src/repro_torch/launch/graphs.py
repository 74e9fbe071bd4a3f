"""CUDA graphs of the port's steps: the counterpart of ``jax.jit``.

The reference never runs a step eagerly: it jits its decode, prefill and
train steps. On the card the port captures a step once in a CUDA graph
(``torch.cuda.graph``) and replays it, so the host issues one graph launch
a step instead of every kernel and copy of it.

:class:`StepGraph` holds one captured call ``fn(*args)``:

* every tensor in ``args`` is bound by address: the params, the KV cache or
  the optimizer state, and the static input buffers that the caller refills
  with ``copy_`` before each replay;
* before capture the step runs ``WARMUP`` times eagerly on a side stream
  (the kernel library is built and loaded then, the kernels' one-time
  setups run, cuBLAS and the allocator warm up). The tensors the step
  writes in place (``mutated``) are copied to the host first (pinned
  memory, so the device's peak does not grow by their size) and restored
  after the warm-up and after capture, so the warm-up leaves nothing behind
  but its launches;
* capture goes into a private memory pool, which :meth:`release` frees;
* :meth:`replay` launches the graph and returns the step's outputs, the same
  tensors at every replay: the next replay overwrites them.

It runs on CUDA only: CPU tensors raise, and a capture that fails raises.
Nothing runs the step eagerly in its place.

The kernel wrappers count their launches on the host, and a replay does not
pass through them. Capture records kernels without running them, so it
takes back what the counters gained while it recorded; each replay adds
that amount, so a counter keeps meaning "kernels launched".

:class:`GraphedStep` is what ``launch.steps`` returns on the card: it keeps
one :class:`StepGraph` per binding (the addresses and shapes of the bound
tensors, the shapes and dtypes of the fed inputs), captured at the first
call that has it, and copies each call's fed inputs into that graph's
buffers before the replay.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import adamw, decode_attention, flash_attention
from repro_torch.kernels import mamba_scan, rmsnorm
from repro_torch.models.module import tree_leaves, tree_map

# eager calls on a side stream before capture
WARMUP = 2

# the host-side counters of the kernel wrappers, as (wrapper, attribute)
COUNTERS = (
    (rmsnorm.rmsnorm_cuda, "launches"),
    (rmsnorm.rmsnorm_bwd_cuda, "launches"),
    (flash_attention.flash_attention_cuda, "launches"),
    (flash_attention.flash_attention_bwd_cuda, "launches"),
    (flash_attention.flash_attention_bwd_cuda, "copies"),
    (flash_attention.flash_attention_bwd_cuda, "lse_forwards"),
    (decode_attention.decode_attention_cuda, "launches"),
    (mamba_scan.mamba_scan_cuda, "launches"),
    (mamba_scan.mamba_scan_train_cuda, "launches"),
    (mamba_scan.mamba_scan_bwd_cuda, "launches"),
    (adamw.sumsq_cuda, "launches"),
    (adamw.clip_finalize_cuda, "launches"),
    (adamw.adamw_update_cuda, "launches"),
)


def _read() -> Dict[str, int]:
    return {f"{fn.__name__}.{attr}": getattr(fn, attr) for fn, attr in COUNTERS}


def _add(counts: Dict[str, int], sign: int) -> None:
    for fn, attr in COUNTERS:
        n = counts.get(f"{fn.__name__}.{attr}", 0)
        if n:
            setattr(fn, attr, getattr(fn, attr) + sign * n)


def _require_cuda(tree) -> torch.device:
    """The one CUDA device of every tensor in ``tree``; raises ValueError for
    a tensor elsewhere or a tree without tensors."""
    tensors = [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]
    if not tensors:
        raise ValueError("StepGraph: the step takes no tensor to bind")
    dev = tensors[0].device
    where = sorted({str(t.device) for t in tensors})
    if dev.type != "cuda" or len(where) > 1:
        raise ValueError(f"StepGraph: a CUDA graph binds tensors on one CUDA "
                         f"device, got {where}")
    return dev


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``: pinned and ordered on the current stream for a
    CUDA tensor, so the step's later writes on the device wait for it."""
    if not t.is_cuda:
        return t.clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t, non_blocking=True)


def _warm_up(fn: Callable, args, n: int, device: torch.device) -> None:
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(n):
            fn(*args)
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)


def _capture(fn: Callable, args, device: torch.device):
    """(graph, outputs, bytes the capture's private pool reserved)."""
    torch.cuda.synchronize(device)
    # what torch.cuda.graph does on entry, done first so that the cached
    # blocks it frees do not count against the pool
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device), torch.cuda.graph(graph):
        out = fn(*args)
    torch.cuda.synchronize(device)
    return graph, out, torch.cuda.memory_reserved(device) - reserved


class StepGraph:
    """``fn(*args)`` captured in a CUDA graph; see the module docstring."""

    def __init__(self, fn: Callable, *args, mutated: Any = None,
                 name: str = "step"):
        self.device = _require_cuda((args, mutated))
        if not all(isinstance(t, torch.Tensor) for t in tree_leaves(mutated)
                   if t is not None):
            raise ValueError("StepGraph: what the step writes in place must "
                             "be tensors (a Python number would be frozen "
                             "into the graph)")
        # what the graph reads and writes: the bound tensors and the fed
        # buffers (holding them keeps that memory alive)
        self.args = args
        saved = tree_map(lambda t: _to_host(t) if isinstance(t, torch.Tensor)
                         else t, mutated)
        on_card = any(isinstance(t, torch.Tensor) and t.is_cuda
                      for t in tree_leaves(mutated))

        def restore():
            for dst, src in zip(tree_leaves(mutated), tree_leaves(saved)):
                if isinstance(dst, torch.Tensor):
                    dst.copy_(src, non_blocking=True)
            if on_card:
                torch.cuda.synchronize(self.device)

        t0 = time.perf_counter()
        _warm_up(fn, args, WARMUP, self.device)
        restore()
        t1 = time.perf_counter()
        before = _read()
        try:
            self._graph, self.outputs, pool_bytes = _capture(fn, args,
                                                             self.device)
        except BaseException:
            _add({k: v - before[k] for k, v in _read().items()}, -1)
            raise
        after = _read()
        restore()
        # capture ran nothing: take back what the wrappers counted, and add
        # it at every replay
        self.per_replay = {k: after[k] - before[k] for k in after}
        _add(self.per_replay, -1)
        self.stats = {
            "name": name, "warmup_calls": WARMUP, "warmup_s": t1 - t0,
            "capture_s": time.perf_counter() - t1, "pool_bytes": pool_bytes,
            "per_replay": {k: v for k, v in self.per_replay.items() if v}}

    def replay(self):
        """Launch the graph; returns the outputs of the captured call."""
        if self._graph is None:
            raise RuntimeError("StepGraph: replay after release()")
        self._graph.replay()
        _add(self.per_replay, 1)
        return self.outputs

    def release(self) -> None:
        """Free the graph and its memory pool (outputs included)."""
        if self._graph is not None:
            self._graph.reset()
        self._graph = self.outputs = self.args = None


def _signature(tree):
    """What a tree of fed inputs must keep for a graph to take it: its
    structure, and each leaf's shape and dtype."""
    if isinstance(tree, dict):
        return tuple((k, _signature(tree[k])) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return tuple(_signature(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), tree.dtype
    if isinstance(tree, np.ndarray):
        return tuple(tree.shape), torch.from_numpy(np.empty(0, tree.dtype)).dtype
    return (), torch.as_tensor(tree).dtype


def _binding(tree):
    """The addresses, shapes and dtypes of the bound tensors."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                 if isinstance(t, torch.Tensor) else t
                 for t in tree_leaves(tree))


def _fill(buf: torch.Tensor, value) -> None:
    """Copy one fed input into its static buffer. A Python number is
    written by a fill kernel, so no host-to-device copy waits on the
    stream."""
    if isinstance(value, torch.Tensor):
        buf.copy_(value)
    elif isinstance(value, np.ndarray):
        buf.copy_(torch.from_numpy(value))
    else:
        buf.fill_(value)


def _buffer(value, device) -> torch.Tensor:
    if isinstance(value, np.ndarray):
        value = torch.from_numpy(value)
    t = torch.as_tensor(value)
    return torch.empty(t.shape, dtype=t.dtype, device=device)


class GraphedStep:
    """``step(*bound, *fed)`` replayed from CUDA graphs.

    The first ``n_bound`` arguments are bound by address (params, cache,
    optimizer state); the rest are fed: tensors, numpy arrays or Python
    numbers, copied into the graph's static buffers before each replay. A
    call whose binding or fed shapes no graph has captures one (after
    ``WARMUP`` eager calls); ``mutates`` gives the positions of the bound
    arguments the step writes in place. Every graph is kept, and keeps its bound
    tensors alive, until :meth:`release`. Returns the graph's outputs,
    which the next replay of the same graph overwrites."""

    def __init__(self, step: Callable, n_bound: int, device: torch.device,
                 mutates: Tuple[int, ...] = (), name: str = "step"):
        if device.type != "cuda":
            raise ValueError(f"GraphedStep: CUDA graphs run on CUDA, not "
                             f"{device}")
        self.step, self.n_bound, self.device = step, n_bound, device
        self.mutates, self.name = mutates, name
        self.graphs: Dict[Any, StepGraph] = {}
        self._buffers: Dict[Any, Any] = {}

    def __call__(self, *args):
        bound, fed = args[:self.n_bound], args[self.n_bound:]
        key = (_binding(bound), _signature(fed))
        graph: Optional[StepGraph] = self.graphs.get(key)
        if graph is None:
            buffers = tree_map(lambda v: _buffer(v, self.device), fed)
            tree_map(_fill, buffers, fed)
            graph = StepGraph(self.step, *bound, *buffers,
                              mutated=[bound[i] for i in self.mutates],
                              name=self.name)
            self.graphs[key], self._buffers[key] = graph, buffers
        else:
            tree_map(_fill, self._buffers[key], fed)
        return graph.replay()

    def release(self) -> None:
        """Free every graph, its pool and its buffers."""
        for graph in self.graphs.values():
            graph.release()
        self.graphs.clear()
        self._buffers.clear()
