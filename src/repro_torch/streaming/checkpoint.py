"""Aligned-barrier checkpoints: consistent snapshots + offset replay.

The recovery contract (ROADMAP item 2, TStream 1904.03800's
transactional-state framing): a run killed mid-stream restores from its
latest completed checkpoint to **byte-identical** output versus an
uninterrupted run.  Exactly-once comes from two halves glued at one
consistent cut:

* **State snapshot** — every executor deposits a deep-copied
  :func:`repro_torch.streaming.state.state_payload` of its
  :class:`~repro_torch.streaming.state.OperatorState` (keyed/value/broadcast
  stores, count-window buffers, event-time pane buffers *and* the
  watermark frontier) the moment checkpoint barrier *n* has arrived on
  every producer lane — the Chandy-Lamport aligned cut.
* **Offset replay** — every spout deposits its retired batch offset for
  the same barrier, so a resumed run replays exactly the batches whose
  effects are *not* in the snapshot.  Deterministic sources
  (``source(batch, seed + b)``) make the replayed prefix byte-identical.

This module owns the bookkeeping around the cut, not the cut itself (the
runtime's barrier alignment does that): :class:`Checkpoint` is the
completed snapshot, :class:`CheckpointCoordinator` assembles per-replica
deposits into completed checkpoints (thread-safe — executors deposit from
their own threads; the process backend's parent deposits on behalf of
workers as pipe messages stream in), and :func:`save_checkpoint` /
:func:`restore_checkpoint` persist completed checkpoints atomically
(write-tmp-then-rename, so a kill mid-write never leaves a torn file) and
load the latest one back.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import re
import threading
from typing import Dict, List, Optional, Set

__all__ = [
    "Checkpoint", "CheckpointCoordinator", "checkpoint_uids",
    "save_checkpoint", "restore_checkpoint", "list_checkpoints",
]

_CKPT_RE = re.compile(r"^ckpt-(\d+)\.pkl$")

# The on-disk format is the reference package's: a pickle that names
# :class:`Checkpoint` by the reference's module path, so either package
# restores the other's files.  Only that path is translated, both ways;
# nothing of the reference is imported.
_OWN = "repro_torch.streaming."
_REF = "repro.streaming."


class _RefPathPickler(pickle._Pickler):
    """Pickles this package's classes under the reference's module path
    (protocol 4 and up: the module and name strings, then STACK_GLOBAL —
    what the reference's pickler writes for its own class)."""

    def save_global(self, obj, name=None):
        module = getattr(obj, "__module__", None) or ""
        if name is None and module.startswith(_OWN):
            self.save(_REF + module[len(_OWN):])
            self.save(obj.__qualname__)
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)


class _OwnPathUnpickler(pickle.Unpickler):
    """Resolves the reference's module path to this package's classes."""

    def find_class(self, module, name):
        if module.startswith(_REF):
            module = _OWN + module[len(_REF):]
        return super().find_class(module, name)


@dataclasses.dataclass
class Checkpoint:
    """One completed aligned snapshot.

    ``spout_offsets`` maps per-replica uids (``"spout#0"``) to the number
    of batches *retired into the snapshot* — the resume start offset.
    ``states`` maps every executor uid to its
    :func:`~repro_torch.streaming.state.state_payload`; ``aux`` carries the
    executor's watermark bookkeeping (merged-lane map, forwarded frontier,
    spout cadence counters) so a resumed run emits the exact mark sequence
    an uninterrupted run would have.
    """

    ckpt_id: int
    app: str
    parallelism: Dict[str, int]
    batch: int
    seed: int
    checkpoint_every: int
    spout_offsets: Dict[str, int] = dataclasses.field(default_factory=dict)
    states: Dict[str, dict] = dataclasses.field(default_factory=dict)
    aux: Dict[str, dict] = dataclasses.field(default_factory=dict)

    def describe(self) -> str:
        return (f"ckpt {self.ckpt_id} of {self.app!r} "
                f"(offsets {self.spout_offsets}, "
                f"{len(self.states)} state payloads)")


def checkpoint_uids(app, parallelism: Dict[str, int]) -> Set[str]:
    """The set of per-replica uids that must deposit for a checkpoint to
    be complete: every spout replica and every task replica."""
    return {f"{name}#{i}"
            for name in app.graph.operators
            for i in range(parallelism.get(name, 1))}


class CheckpointCoordinator:
    """Assembles per-replica deposits into completed checkpoints.

    A checkpoint is *complete* when every expected uid has deposited for
    its id; incomplete rounds at shutdown (the stream drained first, or
    the run was killed) are simply discarded — recovery only ever reads
    completed checkpoints.  Completion is detected under one lock, so
    exactly one depositor observes it and triggers persistence.
    """

    def __init__(self, app, parallelism: Dict[str, int], *, batch: int,
                 seed: int, every: int, directory: Optional[str] = None):
        self.app_name = app.name
        self.parallelism = dict(parallelism)
        self.batch = int(batch)
        self.seed = int(seed)
        self.every = int(every)
        self.directory = directory
        self.expected = checkpoint_uids(app, parallelism)
        self.completed: List[Checkpoint] = []
        self._open: Dict[int, Checkpoint] = {}
        self._lock = threading.Lock()

    def deposit(self, ckpt_id: int, uid: str, *, payload: dict,
                aux: Optional[dict] = None,
                offset: Optional[int] = None) -> Optional[Checkpoint]:
        """Record one replica's snapshot for checkpoint ``ckpt_id``.

        Returns the completed :class:`Checkpoint` when this deposit was
        the last one expected (having also persisted it when a directory
        is configured), else ``None``.
        """
        if uid not in self.expected:
            raise ValueError(f"unexpected checkpoint depositor {uid!r}")
        with self._lock:
            ck = self._open.get(ckpt_id)
            if ck is None:
                ck = self._open[ckpt_id] = Checkpoint(
                    ckpt_id=ckpt_id, app=self.app_name,
                    parallelism=dict(self.parallelism), batch=self.batch,
                    seed=self.seed, checkpoint_every=self.every)
            ck.states[uid] = payload
            if aux:
                ck.aux[uid] = aux
            if offset is not None:
                ck.spout_offsets[uid] = int(offset)
            if set(ck.states) != self.expected:
                return None
            del self._open[ckpt_id]
            self.completed.append(ck)
        if self.directory is not None:
            save_checkpoint(ck, self.directory)
        return ck

    @property
    def latest(self) -> Optional[Checkpoint]:
        with self._lock:
            return self.completed[-1] if self.completed else None


def save_checkpoint(ckpt: Checkpoint, directory: str) -> str:
    """Persist one completed checkpoint atomically.

    Pickles to ``ckpt-<id>.pkl.tmp.<pid>`` then ``os.replace``-renames
    into place: a reader (or a restore after a kill) either sees the
    complete file or no file — never a torn one.
    """
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt-{ckpt.ckpt_id}.pkl")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        _RefPathPickler(f, protocol=pickle.HIGHEST_PROTOCOL).dump(ckpt)
    os.replace(tmp, path)
    return path


def list_checkpoints(directory: str) -> List[int]:
    """Completed checkpoint ids present in ``directory``, ascending."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    ids = []
    for n in names:
        m = _CKPT_RE.match(n)
        if m:
            ids.append(int(m.group(1)))
    return sorted(ids)


def restore_checkpoint(directory: str,
                       ckpt_id: Optional[int] = None) -> Checkpoint:
    """Load a completed checkpoint from ``directory`` — the latest
    (highest id) by default, or a specific ``ckpt_id``.  Feed the result
    to ``run_app(from_checkpoint=...)`` / ``Plan.execute(
    from_checkpoint=...)`` to resume."""
    ids = list_checkpoints(directory)
    if not ids:
        raise FileNotFoundError(
            f"no completed checkpoints under {directory!r}")
    if ckpt_id is None:
        ckpt_id = ids[-1]
    elif ckpt_id not in ids:
        raise FileNotFoundError(
            f"checkpoint {ckpt_id} not found under {directory!r} "
            f"(have {ids})")
    path = os.path.join(directory, f"ckpt-{ckpt_id}.pkl")
    with open(path, "rb") as f:
        ck = _OwnPathUnpickler(f).load()
    if not isinstance(ck, Checkpoint):
        raise ValueError(f"{path!r} does not contain a Checkpoint")
    return ck
