"""The port's steps as CUDA graphs take them, on the CPU.

A CUDA graph replays what it captured: a value the step read on the host
(``item()``, ``int()``, a Python branch on a tensor, a 0-d tensor used as
an index) is frozen at capture, and reading it would also sync the stream,
which capture refuses. So the decode, prefill and train steps and the
optimizers run here under :class:`NoHostReads`, which raises at any such
read; the decode step runs on position and token tensors refilled in place,
as a graph's buffers are, and must equal fresh calls. ``launch.graphs``
itself needs the card; its launch accounting is held here with a stand-in
step and stand-ins for its three CUDA calls. Graphed against eager on the
card: ``tests/test_torch_cuda.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get
from repro_torch.kernels import decode_attention, rmsnorm
from repro_torch.kernels.adamw import global_norm_scale
from repro_torch.launch import graphs, serve
from repro_torch.launch.graphs import GraphedStep, StepGraph
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import frontends, model_api
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.optim import optimizers as topt

ARCHS = ["smollm_360m", "h2o_danube_1_8b", "jamba_1_5_large_398b",
         "xlstm_125m", "deepseek_v3_671b", "qwen3_moe_235b_a22b",
         "whisper_small", "llava_next_mistral_7b"]


class NoHostReads(TorchDispatchMode):
    """Raises where a tensor's value is read on the host (``item``,
    ``int``, ``bool``, a 0-d tensor as an index or a Python scalar: all go
    through ``_local_scalar_dense``) or an output's size depends on values
    (``nonzero``)."""

    BANNED = (torch.ops.aten._local_scalar_dense.default,
              torch.ops.aten.nonzero.default)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.BANNED:
            raise AssertionError(f"host read of a tensor value: {func}")
        return func(*args, **(kwargs or {}))


def _cfg(name):
    """SMOKE config; Jamba with a dense FFN in place of MoE (its MoE layers
    run in the DeepSeek and Qwen3-MoE cases)."""
    cfg = get(name, smoke=True)
    if name == "jamba_1_5_large_398b":
        cfg = dataclasses.replace(cfg, n_experts=0, top_k=0, d_expert=0,
                                  period=tuple((m, "mlp") for m, _ in cfg.period))
    return cfg


def _params(cfg, seed=0):
    return model_api(cfg).init(torch.Generator().manual_seed(seed), cfg,
                               device="cpu")


def test_the_guard_catches_host_reads():
    t = torch.tensor(3)
    # the forms the eager decode step took for its Python-int position
    for read in (lambda: t.item(), lambda: int(t), lambda: bool(t > 1),
                 lambda: min(t + 1, 4), lambda: range(t),
                 lambda: torch.full((1,), t), lambda: torch.zeros(5)[t],
                 lambda: torch.zeros(2, 5).__setitem__((slice(None), t), 1.0),
                 lambda: torch.nonzero(torch.arange(5) > t)):
        with NoHostReads(), pytest.raises(AssertionError, match="host read"):
            read()
    with NoHostReads():
        torch.zeros(5).index_copy_(0, t.view(1), torch.ones(1))
        torch.clamp(t + 1, max=4).view(1).expand(2)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_step_on_refilled_buffers_matches_fresh_calls(name):
    """The decode step as its graph runs it: one token buffer and one 0-d
    position tensor, refilled in place before each call (twice per step,
    the second call on the same buffers after the first), with no host read
    of either; its logits, tokens and every cache leaf equal those of fresh
    calls with a new token tensor and a Python int position, step by step
    for 24 steps (past h2o-danube's window of 16, where the slot and the
    length both wrap)."""
    cfg = _cfg(name)
    params = _params(cfg, seed=1)
    api = model_api(cfg)
    step = make_decode_step(cfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 24),
                                             dtype=np.int32)
    buffered = api.init_cache(cfg, 2, max_len=32, device="cpu")
    fresh = api.init_cache(cfg, 2, max_len=32, device="cpu")
    tok, pos = torch.zeros(2, dtype=torch.int32), torch.zeros((), dtype=torch.int64)
    for t in range(24):
        want_nxt, want, _ = step(params, fresh, torch.from_numpy(toks[:, t].copy()), t)
        snapshot = tree_map(lambda a: a.clone(), buffered)
        for _ in range(2):          # the same step twice, from the same cache
            tree_map(lambda a, b: a.copy_(b), buffered, snapshot)
            tok.copy_(torch.from_numpy(toks[:, t]))
            pos.fill_(t)
            with NoHostReads():
                nxt, logits, out = step(params, buffered, tok, pos)
            assert out is buffered
            assert torch.equal(logits, want) and torch.equal(nxt, want_nxt)
        for a, b in zip(tree_leaves(buffered), tree_leaves(fresh)):
            assert torch.equal(a, b), f"step {t}"


@pytest.mark.parametrize("name", ["smollm_360m", "jamba_1_5_large_398b",
                                  "xlstm_125m", "deepseek_v3_671b",
                                  "qwen3_moe_235b_a22b"])
def test_prefill_step_makes_no_host_read(name):
    cfg = _cfg(name)
    params = _params(cfg)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 32),
                                             dtype=np.int32)
    with NoHostReads():
        logits = make_prefill_step(cfg, device="cpu")(
            params, {"inputs": torch.from_numpy(toks)})
    assert logits.shape == (2, cfg.vocab) and bool(torch.isfinite(logits).all())


def _frontend_batch(cfg, params, rng, b=2, s=16):
    """A train batch as ``launch.train`` builds it for the frontend
    families: whisper's tokens, labels and frames; llava's ``embeds`` of
    image patches and text, with s labels."""
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s + 1),
                                         dtype=np.int32))
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    gen = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
    if cfg.family == "audio":
        batch["frames"] = frontends.audio_frames(gen, cfg, b, device="cpu")
    else:
        patches = frontends.image_patches(gen, cfg, b, device="cpu")
        batch = {"embeds": frontends.fuse_vlm_inputs(
            params, patches, batch["inputs"][:, :s - cfg.img_tokens], cfg),
            "labels": batch["labels"]}
    return batch


@pytest.mark.parametrize("name", ["whisper_small", "llava_next_mistral_7b"])
def test_frontend_steps_make_no_host_read(name):
    """The encoder-decoder's prefill (frames and tokens) and llava's
    (``embeds``), and three train steps of each on the batches ``train()``
    feeds them, with no host read; the train step writes params and
    optimizer state in place."""
    cfg = _cfg(name)
    params = _params(cfg)
    rng = np.random.default_rng(5)
    batch = _frontend_batch(cfg, params, rng)
    with NoHostReads():
        logits = make_prefill_step(cfg, device="cpu")(
            params, {k: v for k, v in batch.items() if k != "labels"})
    assert logits.shape == (2, cfg.vocab) and bool(torch.isfinite(logits).all())
    opt = topt.adamw(topt.warmup_cosine(1e-2, warmup=2, total=10))
    state = opt.init(params)
    leaves = tree_leaves((params, state))
    step = make_train_step(cfg, opt, device="cpu")
    for _ in range(3):
        batch = _frontend_batch(cfg, params, rng)
        with NoHostReads():
            p, s, metrics = step(params, state, batch)
        assert all(a is b for a, b in zip(tree_leaves((p, s)), leaves))
        assert bool(torch.isfinite(metrics["loss"]))
    assert int(state["step"]) == 3


@pytest.mark.parametrize("name", ["smollm_360m", "deepseek_v3_671b",
                                  "qwen3_moe_235b_a22b"])
@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_train_step_makes_no_host_read_and_updates_in_place(kind, name):
    """Three train steps of smollm SMOKE and of the MoE SMOKE configs
    (DeepSeek with MLA, its dense prefix and the MTP loss; Qwen3-MoE):
    forward and backward under remat, the MoE dispatch's backward, clip,
    the optimizer with warmup + cosine on its step tensor, with no host
    read, writing params and optimizer state in place: the same tensors
    come back, changed, and the step tensor counts 3."""
    cfg = _cfg(name)
    params = _params(cfg)
    sched = topt.warmup_cosine(1e-2, warmup=2, total=10)
    opt = topt.adamw(sched) if kind == "adamw" else topt.adafactor(sched)
    state = opt.init(params)
    before = tree_map(lambda a: a.clone(), params)
    leaves = tree_leaves((params, state))
    step = make_train_step(cfg, opt, device="cpu")
    rng = np.random.default_rng(3)
    for _ in range(3):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 17), dtype=np.int32))
        with NoHostReads():
            p, s, metrics = step(params, state, {"inputs": toks[:, :-1],
                                                 "labels": toks[:, 1:]})
        assert all(a is b for a, b in zip(tree_leaves((p, s)), leaves))
        assert bool(torch.isfinite(metrics["loss"]))
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 3
    assert not torch.equal(params["embed"], before["embed"])


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_clip_and_update_make_no_host_read(kind):
    """The train step's clip and update as the fused kernels run them: the
    norm and the clip's scale once (``global_norm_scale``), then
    ``update(..., grad_scale=scale)``, on a SMOKE tree with a bf16 leaf,
    with a clip that bites and one that does not, under
    :class:`NoHostReads`: lr, the bias corrections, the norm and the scale
    stay 0-d tensors, and params and state are written in place."""
    cfg = _cfg("smollm_360m")
    params = _params(cfg)
    params["embed"] = params["embed"].to(torch.bfloat16)
    sched = topt.warmup_cosine(1e-2, warmup=2, total=10)
    opt = topt.adamw(sched) if kind == "adamw" else topt.adafactor(sched)
    state = opt.init(params)
    leaves = tree_leaves((params, state))
    before = tree_map(lambda a: a.clone(), params)
    rng = np.random.default_rng(4)
    for max_norm in (1e-3, 1e6):
        grads = tree_map(lambda a: torch.from_numpy(
            rng.standard_normal(a.shape).astype(np.float32)).to(a.dtype), params)
        with NoHostReads():
            norm, scale = global_norm_scale(tree_leaves(grads), max_norm)
            p, s = opt.update(grads, state, params, grad_scale=scale)
        assert norm.shape == scale.shape == ()
        assert all(a is b for a, b in zip(tree_leaves((p, s)), leaves))
        assert (float(scale) < 1) == (max_norm < 1)
    assert int(state["step"]) == 2
    assert not torch.equal(params["embed"], before["embed"])


def test_optimizer_refuses_a_python_step():
    p = {"w": torch.ones(2, 3)}
    opt = topt.adamw(1e-2)
    with pytest.raises(TypeError, match="step must be a 0-d int32 tensor"):
        opt.update({"w": torch.ones(2, 3)}, dict(opt.init(p), step=0), p)


def test_steps_on_the_cpu_stay_eager():
    cfg = _cfg("smollm_360m")
    for step in (make_decode_step(cfg, device="cpu"),
                 make_prefill_step(cfg, device="cpu"),
                 make_train_step(cfg, topt.adamw(1e-3), device="cpu")):
        assert not isinstance(step, GraphedStep) and callable(step)


@pytest.mark.parametrize("name, max_len, refused", [
    ("smollm_360m", 12, True),            # no window: 20 positions, 12 slots
    ("h2o_danube_1_8b", 12, True),        # a window of 16 cannot ring in 12
    ("h2o_danube_1_8b", 16, False),       # the ring of the window
    ("jamba_1_5_large_398b", 12, True),   # its attention layer
    ("xlstm_125m", 12, False),            # no KV cache
    ("deepseek_v3_671b", 12, True),       # MLA's compressed cache
])
def test_serve_batch_checks_positions_against_the_cache(name, max_len,
                                                        refused):
    """Prompts of 8 tokens and 12 new ones run positions 0-19. Where they do
    not fit the KV cache, ``serve_batch`` raises ValueError before any step
    (on the card the index would fail on the device); a window's ring and a
    model without a KV cache serve to the end."""
    cfg = _cfg(name)
    params = _params(cfg)
    rng = np.random.default_rng(4)
    reqs = [serve.Request(i, rng.integers(0, cfg.vocab, 8, dtype=np.int32), 12)
            for i in range(2)]
    if refused:
        def no_step(*args):
            raise AssertionError("a decode step ran")
        with pytest.raises(ValueError, match="20 KV cache slots"):
            serve.serve_batch(cfg, params, reqs, max_len=max_len,
                              device="cpu", step_fn=no_step)
    else:
        reqs, _ = serve.serve_batch(cfg, params, reqs, max_len=max_len,
                                    device="cpu")
        assert all(r.out.shape == (12,) for r in reqs)


def test_graphs_refuse_cpu_tensors():
    x = torch.zeros(3)
    with pytest.raises(ValueError, match="one CUDA device"):
        StepGraph(lambda a: a + 1, x)
    with pytest.raises(ValueError, match="one CUDA device"):
        StepGraph(lambda: None, mutated={"c": x})
    with pytest.raises(ValueError, match="no tensor"):
        StepGraph(lambda n: n, 3)
    with pytest.raises(ValueError, match="CUDA graphs run on CUDA"):
        GraphedStep(lambda a: a, 1, torch.device("cpu"))


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: counts replays."""

    def __init__(self):
        self.replays = 0
        self.freed = False

    def replay(self):
        self.replays += 1

    def reset(self):
        self.freed = True


@pytest.fixture
def fake_cuda(monkeypatch):
    """``launch.graphs`` without a card: its device check passes, the
    warm-up runs the step eagerly, and capture runs it once (recording, as
    a real capture does, what the wrappers count) into a stand-in graph."""
    made = []

    def capture(fn, args, device):
        out = fn(*args)
        made.append(_FakeGraph())
        return made[-1], out, 1 << 20

    monkeypatch.setattr(graphs, "_require_cuda", lambda tree: torch.device("cuda"))
    monkeypatch.setattr(graphs, "_warm_up",
                        lambda fn, args, n, device: [fn(*args) for _ in range(n)])
    monkeypatch.setattr(graphs, "_capture", capture)
    monkeypatch.setattr(rmsnorm.rmsnorm_cuda, "launches", 0)
    monkeypatch.setattr(decode_attention.decode_attention_cuda, "launches", 0)
    return made


def _stand_in(state, x):
    """A step that launches three RMSNorms and one decode attention (by the
    wrappers' counters) and writes ``state`` in place."""
    rmsnorm.rmsnorm_cuda.launches += 3
    decode_attention.decode_attention_cuda.launches += 1
    state.add_(x.sum())
    return state * 2


def _launches():
    return (rmsnorm.rmsnorm_cuda.launches,
            decode_attention.decode_attention_cuda.launches)


def test_capture_takes_back_its_counts_and_each_replay_adds_them(fake_cuda):
    state, x = torch.zeros(3), torch.ones(3)
    g = StepGraph(_stand_in, state, x, mutated=[state])
    # the two warm-ups launched; capture launched nothing; the warm-ups'
    # and the capture's writes are undone
    assert _launches() == (6, 2)
    assert torch.equal(state, torch.zeros(3))
    assert g.per_replay["rmsnorm_cuda.launches"] == 3
    assert g.per_replay["decode_attention_cuda.launches"] == 1
    assert g.stats["per_replay"] == {"rmsnorm_cuda.launches": 3,
                                     "decode_attention_cuda.launches": 1}
    assert g.stats["pool_bytes"] == 1 << 20
    for n in range(1, 6):
        out = g.replay()
        assert _launches() == (6 + 3 * n, 2 + n)
    assert out is g.outputs and fake_cuda[0].replays == 5
    g.release()
    assert fake_cuda[0].freed and g.outputs is None
    with pytest.raises(RuntimeError, match="after release"):
        g.replay()
    assert _launches() == (21, 7)


def test_a_failed_capture_raises_and_takes_back_its_counts(fake_cuda,
                                                          monkeypatch):
    def refuse(fn, args, device):
        fn(*args)
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(graphs, "_capture", refuse)
    state, x = torch.zeros(3), torch.ones(3)
    with pytest.raises(RuntimeError, match="capturing"):
        StepGraph(_stand_in, state, x, mutated=[state])
    assert _launches() == (6, 2)          # the two warm-ups only
    with pytest.raises(ValueError, match="frozen"):
        StepGraph(_stand_in, state, x, mutated={"step": 3})


def test_graphed_step_captures_per_binding_and_refills_its_buffers(fake_cuda):
    """One capture per (bound tensors, fed shapes); later calls copy their
    fed inputs (a tensor, a numpy array or a Python number) into the
    graph's buffers and replay."""
    state = torch.zeros(3)
    seen = []

    def step(state, x, n):
        seen.append((x.clone(), n.clone()))
        return _stand_in(state, x)

    g = GraphedStep(step, 1, torch.device("cuda"), mutates=(0,))
    g.device = torch.device("cpu")        # its buffers, here
    g(state, torch.ones(3), 5)
    assert len(g.graphs) == 1 and len(fake_cuda) == 1
    # warm-ups and capture saw the buffers filled from the first call
    assert all(torch.equal(x, torch.ones(3)) and int(n) == 5 for x, n in seen)
    for value, n in ((np.full(3, 2.0, np.float32), 6), (torch.full((3,), 3.0), 7)):
        g(state, value, n)
        (buf_x, buf_n), = g._buffers.values()
        assert torch.equal(buf_x, torch.as_tensor(value)) and int(buf_n) == n
    assert len(g.graphs) == 1 and fake_cuda[0].replays == 3
    assert _launches() == (6 + 3 * 3, 2 + 3)
    g(state, torch.ones(4), 5)                        # a new shape
    other = torch.zeros(3)
    g(other, torch.ones(3), 5)                        # a new binding
    assert len(g.graphs) == 3 and len(fake_cuda) == 3
    g.release()
    assert not g.graphs and all(f.freed for f in fake_cuda)


def test_graphed_step_binds_an_encdec_cache_and_feeds_a_batch_dict(fake_cuda):
    """The encoder-decoder's cache tree ({'self': {'k', 'v'}, 'cross': (k,
    v)}) binds like any other: one graph for it, whose warm-ups and capture
    leave the whole tree as it was; a fed dict of frames and tokens is
    copied into the graph's buffers each call, and a new frames shape
    captures again."""
    cache = {"self": {"k": torch.zeros(2, 3), "v": torch.zeros(2, 3)},
             "cross": (torch.ones(2, 4), torch.ones(2, 4))}

    def step(cache, batch):
        rmsnorm.rmsnorm_cuda.launches += 3
        cache["self"]["k"].add_(batch["frames"].sum())
        cache["cross"][0].add_(1.0)
        return batch["inputs"].float().sum() + cache["cross"][1].sum()

    g = GraphedStep(step, 1, torch.device("cuda"), mutates=(0,))
    g.device = torch.device("cpu")        # its buffers, here
    frames = torch.ones(2, 5)
    g(cache, {"frames": frames, "inputs": np.array([[1, 2]], np.int32)})
    assert len(g.graphs) == 1
    assert torch.equal(cache["self"]["k"], torch.zeros(2, 3))
    assert torch.equal(cache["cross"][0], torch.ones(2, 4))
    out = g(cache, {"frames": 2 * frames, "inputs": np.array([[3, 4]], np.int32)})
    ((bufs,),) = g._buffers.values()
    assert torch.equal(bufs["frames"], 2 * frames)
    assert bufs["inputs"].tolist() == [[3, 4]]
    assert len(g.graphs) == 1 and fake_cuda[0].replays == 2 and out is not None
    g(cache, {"frames": torch.ones(2, 6), "inputs": np.array([[1, 2]], np.int32)})
    assert len(g.graphs) == 2
    assert rmsnorm.rmsnorm_cuda.launches == 2 * (3 * 2) + 3 * 3
    g.release()
