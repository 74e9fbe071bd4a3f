"""``repro_torch.streaming`` against ``repro.streaming``: every paper app
replays, simulates, fuses and checkpoints to the same bytes in both
packages, a checkpoint written by either restores in the other, and the
``streaming_inference`` predictor's plain version on the CPU scores as the
reference's ``jax.jit(mlp_ref)`` does."""
import collections
import importlib

import numpy as np
import pytest
import torch

import repro.streaming as ref_streaming
import repro_torch.streaming as streaming
from repro.core import server_a as ref_server_a
from repro.kernels.ref import mlp_ref as ref_mlp_ref
from repro.streaming import apps as ref_apps
from repro.streaming import checkpoint as ref_checkpoint
from repro.streaming import runtime as ref_runtime
from repro.streaming.api import Job as RefJob
from repro.streaming.state import merge_keyed as ref_merge_keyed
from repro.streaming.state import state_payload as ref_state_payload
from repro_torch.core import server_a
from repro_torch.kernels.ref import mlp_ref
from repro_torch.streaming import apps, checkpoint, procexec, runtime
from repro_torch.streaming.api import Job
from repro_torch.streaming.state import merge_keyed, state_payload
from test_torch_core import RLAS, assert_same, same_plan

APPS = ["word_count", "fraud_detection", "spike_detection", "linear_road",
        "spike_detection_eventtime", "spike_detection_keyed",
        "chain_pipeline"]
# state that depends on the order in which two spouts' batches meet at one
# operator (FD scores a transaction with whichever model version arrived
# first), not on the code: left out of every comparison
RACY = {"fraud_detection": {("sink", "flagged")}}


def fingerprint(rt, payload, merge, racy=(), replicated=False):
    """What a deterministic replay must reproduce: counters, spout
    offsets, and each replica's state payload (managed tables, window
    buffers, scratch).  With ``replicated`` (several producers per
    replica, so arrival order varies) the keyed stores are merged and
    only integer scratch is summed, as the reference's backend tests do."""
    fp = {"counts": (rt.spout_tuples, rt.sink_tuples, rt.late_drops,
                     rt.panes_fired), "offsets": dict(rt.spout_offsets)}
    if replicated:
        fp["keyed"] = {op: merge([s.managed for s in reps]).tobytes()
                       for op, reps in rt.states.items()
                       if type(reps[0].managed).__name__ == "KeyedStore"}
        ints = collections.Counter()
        for op, reps in rt.states.items():
            for st in reps:
                for k, v in st.items():
                    if isinstance(v, (int, np.integer)) \
                            and (op, k) not in racy:
                        ints[(op, k)] += int(v)
        fp["ints"] = dict(sorted(ints.items()))
        return fp
    fp["states"] = {}
    for op, reps in rt.states.items():
        fp["states"][op] = []
        for st in reps:
            p = payload(st, copy=True)
            for rop, k in racy:
                if rop == op:
                    p["scratch"].pop(k, None)
            fp["states"][op].append(p)
    return fp


def ref_fp(rt, name, **kw):
    return fingerprint(rt, ref_state_payload, ref_merge_keyed,
                       RACY.get(name, ()), **kw)


def port_fp(rt, name, **kw):
    return fingerprint(rt, state_payload, merge_keyed, RACY.get(name, ()),
                       **kw)


def test_same_public_names():
    assert ref_streaming.__all__ == streaming.__all__
    for mod in ("api", "apps", "checkpoint", "procexec", "routing", "state",
                "fusion", "simulator", "runtime"):
        ref = importlib.import_module(f"repro.streaming.{mod}")
        port = importlib.import_module(f"repro_torch.streaming.{mod}")
        for name in getattr(ref, "__all__", ()):
            assert hasattr(port, name), f"{mod}.{name}"


@pytest.mark.parametrize("name", APPS)
def test_replay_fingerprint_equal(name):
    """``run_app(max_batches=)`` at one replica an operator (every state
    payload compared) and the RLAS plan's ``execute`` scaled to 8 threads
    (counters, merged keyed stores, integer scratch)."""
    ref = ref_runtime.run_app(getattr(ref_apps, name)(), None, batch=64,
                              max_batches=6, seed=3)
    port = runtime.run_app(getattr(apps, name)(), None, batch=64,
                           max_batches=6, seed=3)
    assert_same(ref_fp(ref, name), port_fp(port, name))
    assert port.sink_tuples > 0
    pr = RefJob(getattr(ref_apps, name)()).plan(ref_server_a(),
                                                optimizer="rlas", **RLAS)
    pp = Job(getattr(apps, name)()).plan(server_a(), optimizer="rlas",
                                         **RLAS)
    ex_ref = pr.execute(batch=64, batches=6, seed=5, max_threads=8).raw
    ex = pp.execute(batch=64, batches=6, seed=5, max_threads=8).raw
    assert_same({op: len(r) for op, r in ex_ref.states.items()},
                {op: len(r) for op, r in ex.states.items()})
    assert_same(ref_fp(ex_ref, name, replicated=True),
                port_fp(ex, name, replicated=True))


@pytest.mark.parametrize("name", APPS)
def test_simulations_equal(name):
    """The DES (seeded) and the fluid solve of the RLAS plan."""
    pr = RefJob(getattr(ref_apps, name)()).plan(ref_server_a(),
                                                optimizer="rlas", **RLAS)
    pp = Job(getattr(apps, name)()).plan(server_a(), optimizer="rlas",
                                         **RLAS)
    for seed in (0, 1):
        des_ref = pr.simulate("des", seed=seed, horizon=0.002)
        des = pp.simulate("des", seed=seed, horizon=0.002)
        assert_same(des_ref, des)
        assert des.throughput > 0
    assert_same(pr.simulate("fluid"), pp.simulate("fluid"))
    assert_same(pr.simulate("des", input_rate=2e5, seed=2, horizon=0.002),
                pp.simulate("des", input_rate=2e5, seed=2, horizon=0.002))


@pytest.mark.parametrize("name", APPS)
def test_fuse_auto_equal(name):
    """Fusion priced by the planner, and realized by the runtime."""
    pr = RefJob(getattr(ref_apps, name)()).plan(
        ref_server_a(), optimizer="rlas", fuse="auto", **RLAS)
    pp = Job(getattr(apps, name)()).plan(server_a(), optimizer="rlas",
                                         fuse="auto", **RLAS)
    same_plan(pr, pp)
    if name == "chain_pipeline":
        assert pp.chains
    ref = ref_runtime.run_app(getattr(ref_apps, name)(), None, batch=64,
                              max_batches=6, seed=1, fuse="auto")
    port = runtime.run_app(getattr(apps, name)(), None, batch=64,
                           max_batches=6, seed=1, fuse="auto")
    assert_same(ref_fp(ref, name), port_fp(port, name))


@pytest.mark.parametrize("name", APPS)
def test_checkpoints_cross_packages(name, tmp_path):
    """Each package restores the other's checkpoint files, and the four
    resumed runs (each package from its own and from the other's
    checkpoint) give the same output.  (The files themselves differ from
    run to run: snapshots hold ingest timestamps and arrive in thread
    order; ``test_checkpoint_files_are_the_reference_format`` holds the
    format.)"""
    total, every, cut, seed = 8, 2, 2, 4
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_runtime.run_app(getattr(ref_apps, name)(), None, batch=64,
                        max_batches=total, seed=seed, checkpoint_every=every,
                        checkpoint_dir=d_ref)
    runtime.run_app(getattr(apps, name)(), None, batch=64,
                    max_batches=total, seed=seed, checkpoint_every=every,
                    checkpoint_dir=d_port)
    ids = checkpoint.list_checkpoints(d_port)
    assert ids == ref_checkpoint.list_checkpoints(d_ref) and cut in ids
    in_ref = ref_checkpoint.restore_checkpoint(d_port, ckpt_id=cut)
    in_port = checkpoint.restore_checkpoint(d_ref, ckpt_id=cut)
    assert isinstance(in_ref, ref_checkpoint.Checkpoint)
    assert isinstance(in_port, checkpoint.Checkpoint)
    left = total - cut * every

    def resume_ref(ck):
        return ref_fp(ref_runtime.run_app(
            getattr(ref_apps, name)(), None, batch=64, seed=seed,
            max_batches=left, from_checkpoint=ck), name)

    def resume_port(ck):
        return port_fp(runtime.run_app(
            getattr(apps, name)(), None, batch=64, seed=seed,
            max_batches=left, from_checkpoint=ck), name)

    want = resume_ref(ref_checkpoint.restore_checkpoint(d_ref, ckpt_id=cut))
    assert_same(want, resume_ref(in_ref))
    assert_same(want, resume_port(in_port))
    assert_same(want, resume_port(
        checkpoint.restore_checkpoint(d_port, ckpt_id=cut)))
    assert want["offsets"] and all(v == total
                                   for v in want["offsets"].values())


def test_checkpoint_files_are_the_reference_format(tmp_path):
    """The same checkpoint, saved by each package, is the same file, byte
    for byte; each package reads it back as its own class."""
    rt = ref_runtime.run_app(ref_apps.spike_detection_keyed(), None,
                             batch=64, max_batches=6, seed=2,
                             checkpoint_every=2)
    ck_ref = rt.checkpoints[-1]
    ck = checkpoint.Checkpoint(**vars(ck_ref))
    p_ref = ref_checkpoint.save_checkpoint(ck_ref, str(tmp_path / "ref"))
    p = checkpoint.save_checkpoint(ck, str(tmp_path / "port"))
    with open(p_ref, "rb") as f_ref, open(p, "rb") as f:
        assert f.read() == f_ref.read()
    back = checkpoint.restore_checkpoint(str(tmp_path / "ref"))
    assert type(back) is checkpoint.Checkpoint
    assert_same(ck_ref, back)
    assert type(ref_checkpoint.restore_checkpoint(
        str(tmp_path / "port"))) is ref_checkpoint.Checkpoint


# ---------------------------------------------------------------------------
# the device seam, on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [1, 16, 64])
def test_mlp_ref_matches_reference(rows):
    for seed in range(3):
        x = np.random.default_rng(seed).normal(
            size=(rows, apps.INF_FEATURES)).astype(np.float32)
        w = apps.inf_model_weights(seed)
        got = mlp_ref(torch.from_numpy(x), torch.from_numpy(w))
        want = np.asarray(ref_mlp_ref(x, w))
        assert got.dtype == torch.float32 and got.shape == (rows,)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_streaming_inference_cpu_matches_reference():
    """``seen`` equal and ``score`` within rel 1e-6 of the reference's
    jitted predictor; the port's depths 1 and 3 byte-identical, every batch
    scored on the CPU."""
    ref = ref_runtime.run_app(ref_apps.streaming_inference(model_versions=1),
                              {}, batch=16, max_batches=25, dispatch_depth=1)
    runs = {}
    for depth in (1, 3):
        app = apps.streaming_inference(model_versions=1, device="cpu")
        runs[depth] = runtime.run_app(app, {}, batch=16, max_batches=25,
                                      dispatch_depth=depth)
        pred = app.kernels["predictor"].predictor
        assert pred.batches == collections.Counter(cpu=25)
        assert pred.timed == 0
    s_ref = ref.states["sink"][0]
    s1, s3 = runs[1].states["sink"][0], runs[3].states["sink"][0]
    assert s1["seen"] == s3["seen"] == s_ref["seen"] == 25 * 16
    assert s1["score"].hex() == s3["score"].hex()
    assert s1["score"] == pytest.approx(s_ref["score"], rel=1e-6)
    assert runs[1].spout_offsets == ref.spout_offsets


def test_streaming_inference_device_argument():
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        apps.streaming_inference(device="meta")
    app = apps.streaming_inference(device="cpu")
    assert app.device_ops() == {"predictor": 2}
    assert app.graph.operators["predictor"].device_ns == 2500.0


@pytest.fixture
def rings(monkeypatch):
    """The names of the shared-memory segments the port makes."""
    made = []
    real = procexec.shared_memory.SharedMemory

    def record(*a, **kw):
        if kw.get("create"):
            made.append(kw.get("name"))
        return real(*a, **kw)

    monkeypatch.setattr(procexec.shared_memory, "SharedMemory", record)
    return made


def test_fork_guard_refuses_a_cuda_parent(monkeypatch, rings):
    """Forked children of a parent that initialized CUDA cannot use the
    card: the processes backend refuses a device app up front, before any
    ring is made."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="CUDA-clean parent"):
        procexec.run_app_processes(
            apps.streaming_inference(model_versions=1, device="cpu"), {},
            batch=16, max_batches=2)
    assert rings == []


def test_host_device_env_sets_no_xla_flag():
    env = procexec.host_device_env(3, base={"A": "1"})
    assert env == {"A": "1",
                   "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "60000000000"}
