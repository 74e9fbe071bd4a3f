"""Device meshes over ``torch.distributed``.

Counterpart of the reference's ``launch/mesh.py``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over an initialised process
group (NCCL on the card, gloo on the CPU); this module starts no process
and no group: the caller does (``torchrun``, ``torch.multiprocessing.spawn``,
or ``init_process_group`` with a store of its own). Axis names are the
reference's, ``("data", "model")``, or ``("pod", "data", "model")`` multi-pod.

The sharding rules read a mesh's axis names and sizes only, through
:func:`~repro_torch.layout.mesh_shape`, which also takes a plain
``{axis: size}`` mapping, so the rules can be checked for meshes larger than
the processes that run them. ``mesh_shape`` and ``named`` live in
:mod:`repro_torch.layout`, which the models and the checkpoints read too;
``named`` is imported here, where the reference's module defines it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch.distributed as dist

from repro_torch.layout import axis_names, named  # noqa: F401


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over the
    initialised default process group, whose world size must be
    ``prod(shape)``. ``device_type``: "cuda" or "cpu"; by default "cuda"
    under NCCL, else "cpu"."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"make_mesh{shape}: no process group is initialised; start the "
            "processes (torchrun, torch.multiprocessing.spawn) and call "
            "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} holds {math.prod(shape)} "
                         f"ranks, the process group {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def batch_axes(mesh) -> Tuple[str, ...]:
    """Axes the global batch is sharded over."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def fsdp_axis(mesh) -> Optional[str]:
    """Axis parameters and optimizer state are fully sharded over (ZeRO-3)."""
    return "data" if "data" in axis_names(mesh) else None
