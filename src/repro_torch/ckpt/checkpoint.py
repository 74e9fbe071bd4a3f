"""Checkpoints with integrity checks and async save, in the reference's
on-disk format.

Counterpart of :mod:`repro.ckpt.checkpoint`: one ``.npy`` per leaf under
``<dir>/step_<8 digits>/leaf_<5 digits>.npy``, a ``manifest.json`` with
each leaf's shape, logical dtype and crc32, the user's ``extra`` (the data
pipeline's state), and a ``COMMIT`` marker written last; restore ignores a
checkpoint without it. Leaves are ordered as ``jax.tree_util.tree_flatten``
orders them (``module.tree_leaves``: dict keys sorted, tuples and lists in
order), so a checkpoint
of the reference restores into the port's tree of the same structure, and
the port's into the reference's. bf16 leaves are stored as their uint16 bits
under the logical dtype ``"bfloat16"`` and read back with torch. The
optimizers' ``step``, a 0-d int32 tensor, is stored as an int32 scalar, as
the reference stores its step; so is a Python int leaf.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models.module import tree_leaves


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken, in ``tree_leaves``'
    order, from the iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _describe(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "(" + ", ".join(_describe(v) for v in tree) + ")"
    return "*"


def _to_numpy(leaf):
    """(array as stored, logical dtype) of a tensor, numpy array or int."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    if isinstance(leaf, (int, np.integer)):
        return np.asarray(leaf, np.int32), "int32"
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(directory: str, step: int, tree: Any,
         extra: Optional[Dict] = None, keep: int = 3) -> str:
    """Synchronous checkpoint write; returns the checkpoint path."""
    return _write(directory, step, _describe(tree),
                  [_to_numpy(leaf) for leaf in tree_leaves(tree)], extra, keep)


def _write(directory: str, step: int, treedef: str, stored: list,
           extra: Optional[Dict], keep: int) -> str:
    """Write leaves already converted by :func:`_to_numpy`."""
    path = os.path.join(directory, f"step_{step:08d}")
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "treedef": treedef, "n_leaves": len(stored),
                "extra": extra or {}, "leaves": []}
    for i, (arr, logical) in enumerate(stored):
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
        manifest["leaves"].append({
            "shape": list(arr.shape), "dtype": logical,
            "crc32": zlib.crc32(arr.tobytes()) & 0xFFFFFFFF})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write("ok")
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    _gc(directory, keep)
    return path


class AsyncCheckpointer:
    """Snapshot to host memory, then write in a background thread; join()
    before exit. A failed write raises at the next save() or join()."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, directory: str, step: int, tree: Any,
             extra: Optional[Dict] = None, keep: int = 3):
        self.join()
        # copies, taken now: the writer must not see later changes to a CPU
        # tensor, nor the next train step, which writes params and optimizer
        # state in place (``.cpu()`` waits for the step that made them)
        stored = [(np.array(arr, copy=True), logical) for arr, logical
                  in map(_to_numpy, tree_leaves(tree))]
        self._thread = threading.Thread(
            target=self._run, args=(directory, step, _describe(tree), stored,
                                    extra, keep), daemon=True)
        self._thread.start()

    def _run(self, *args):
        try:
            _write(*args)
        except Exception as e:  # handed to the caller by join()
            self._error = e

    def join(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(directory, name, "COMMIT")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(directory: str, step: int, target_tree: Any,
            strict_crc: bool = True):
    """Restore into the structure of ``target_tree``: each leaf on the
    device of the target's leaf, in the checkpoint's dtype (which must be
    the target's); an int target leaf comes back as an int. Returns
    (tree, extra). Raises ValueError for a missing or uncommitted
    checkpoint, a leaf count, shape or dtype that does not match, or a
    crc32 that does not."""
    path = os.path.join(directory, f"step_{step:08d}")
    if not os.path.exists(os.path.join(path, "COMMIT")):
        raise ValueError(f"uncommitted or missing checkpoint {path}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    targets = tree_leaves(target_tree)
    if manifest["n_leaves"] != len(targets):
        raise ValueError(f"leaf count mismatch: checkpoint "
                         f"{manifest['n_leaves']}, target {len(targets)}")
    out = []
    for i, target in enumerate(targets):
        arr = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
        meta = manifest["leaves"][i]
        if strict_crc and zlib.crc32(arr.tobytes()) & 0xFFFFFFFF != meta["crc32"]:
            raise ValueError(f"{path}: leaf {i} corrupt (crc mismatch)")
        if list(arr.shape) != meta["shape"]:
            raise ValueError(f"{path}: leaf {i} shape {arr.shape}, manifest "
                             f"{meta['shape']}")
        if meta["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if isinstance(target, torch.Tensor):
            if tuple(t.shape) != tuple(target.shape) or t.dtype != target.dtype:
                raise ValueError(
                    f"{path}: leaf {i} is {meta['dtype']} {tuple(t.shape)}, "
                    f"the target {target.dtype} {tuple(target.shape)}")
            out.append(t.to(target.device))
        elif isinstance(target, (int, np.integer)):
            out.append(int(t))
        else:
            out.append(arr)
    return _unflatten(target_tree, iter(out)), manifest["extra"]


def _gc(directory: str, keep: int):
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(directory)
        if n.startswith("step_") and not n.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
