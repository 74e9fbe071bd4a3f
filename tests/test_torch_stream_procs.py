"""The port's process backend against its threaded runtime: every paper app
(and the inference app, its predictor on the CPU) replays to the same
bytes on both, through shared-memory rings named with the port's own
``bst`` prefix, none of which outlives the run.  (The reference's rings are
``bsr``; its tests check that no ``bsr`` segment is left, so the port never
makes one.)"""
import os

import pytest

from repro_torch.streaming import apps, procexec
from repro_torch.streaming.runtime import run_app
from repro_torch.streaming.state import merge_keyed, state_payload
from test_torch_core import assert_same
from test_torch_streaming import APPS, RACY, fingerprint, rings  # noqa: F401


def _segments(prefix):
    return [f for f in os.listdir("/dev/shm") if f.startswith(prefix)]


@pytest.mark.parametrize("name", APPS + ["streaming_inference"])
def test_threads_vs_processes(name, rings):
    kw = {"model_versions": 1, "device": "cpu"} \
        if name == "streaming_inference" else {}
    batch = 16 if name == "streaming_inference" else 64
    racy = RACY.get(name, ())
    want = fingerprint(run_app(getattr(apps, name)(**kw), None, batch=batch,
                               max_batches=6, seed=2),
                       state_payload, merge_keyed, racy)
    got = fingerprint(procexec.run_app_processes(
        getattr(apps, name)(**kw), None, batch=batch, max_batches=6, seed=2,
        timeout=120), state_payload, merge_keyed, racy)
    assert_same(want, got)
    assert rings and all(n.startswith("bst") for n in rings), rings
    assert not [n for n in rings if os.path.exists(f"/dev/shm/{n}")]
    assert _segments("bst") == []
