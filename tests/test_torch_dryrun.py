"""The dry-run (``launch/specs.py``, ``launch/dryrun.py``) against the
reference's, on the CPU.

* ``input_specs`` over every (arch, shape) cell: the reference's leaves,
  in order, shape and dtype; ``cell_plan``'s skip reasons and the
  ``long_500k`` set.
* Param, optimizer and cache bytes per device at 16x16 and 2x16x16 for
  every arch: the reference's ``_bytes_per_device`` over its rules on an
  ``AbstractMesh`` (the port's rules read a ``{axis: size}`` mapping, so
  neither side starts a process).
* Cells on fake tensors, each in a process of its own (the fake process
  group is process-global): a (1, 1) SMOKE train cell's flops equal
  ``FlopCounterMode`` over the same step on real CPU tensors (through the
  same operators, ``kernels._checks.operators_on_cpu``); at (2, 1) and
  (4, 1) a rank's flops times the ranks equal the (1, 1) flops, but for
  the clip's and the optimizer's operators, which run on replicated
  state; at (1, 2) and (2, 2) the collectives counted over 'model'
  (``tensor_parallel.counts``) equal ``collectives_per_step``, and the
  collectives the dry-run counts equal those plus the data axis's (an
  all-reduce a gradient leaf, the token count and the metrics) and the
  clip's gather of partial sums over 'model'.
* The reference's XLA flops on the same one-device SMOKE cell beside the
  port's (``pytest -s`` prints the ratio).
* The CLI's ``smollm_360m decode_32k`` cell prints ``-> ok``.
* The sLSTM loop cut to two short lengths and extrapolated
  (``dryrun.CutLoop``) against every step run, on xlstm-125m cut to one
  sLSTM and one mLSTM layer at (2, 2), train and prefill cells at 32 and
  64 tokens: flops, flops by operator, bytes, the collectives (both
  counts) and the peak equal; and ``ssm.slstm_apply`` on real CPU tensors
  bit-equal, outputs and gradients, inside ``CutLoop`` and outside it.
* The decode cells of DeepSeek-V3, Jamba, xLSTM and whisper at 16x16 at a
  cut depth (``decode_32k``; ``long_500k``, batch 1, for Jamba and xLSTM),
  each in a process of its own: ``ok``, and the collectives over 'model'
  and the cache's axes those of ``collectives_per_decode_step``.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import AbstractMesh

from repro.configs import all_archs, get as jget
from repro.launch import shardings as JSH
from repro.launch import specs as jspecs
from repro.models import model_api as jmodel_api
from repro.optim.optimizers import pick_optimizer as jpick
from repro_torch.configs import get as tget
from repro_torch.launch import dryrun, specs
from repro_torch.launch import shardings as TSH
from repro_torch.models import model_api
from repro_torch.models.module import tree_leaves
from repro_torch.optim.optimizers import pick_optimizer

# the reference's dry-run module sets XLA_FLAGS for 512 host devices when
# imported; this process keeps its own
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdry  # noqa: E402
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [(a, s) for a in all_archs() for s in jspecs.SHAPES]
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
# the SMOKE train cell of the fake-tensor runs
SEQ, BATCH = 32, 8


@pytest.mark.parametrize("arch, shape", CELLS)
def test_input_specs_equal_the_reference(arch, shape):
    jcfg, tcfg = jget(arch), tget(arch)
    assert specs.cell_plan(tcfg, shape) == jspecs.cell_plan(jcfg, shape)
    if jspecs.cell_plan(jcfg, shape):
        return
    want = jax.tree.leaves(jspecs.input_specs(jcfg, shape))
    got = tree_leaves(specs.input_specs(tcfg, shape))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)


def test_long_500k_set_equals_the_reference():
    runs = {a for a in all_archs() if specs.long_ok(tget(a))}
    assert runs == {a for a in all_archs() if jspecs.long_ok(jget(a))}
    assert specs.SHAPES == jspecs.SHAPES
    assert specs.LONG_OK_FAMILIES == jspecs.LONG_OK_FAMILIES


def _ref_bytes(arch, mesh):
    """The reference's param, optimizer and decode-cache bytes a device."""
    cfg = jget(arch)
    am = AbstractMesh(tuple(mesh.values()), tuple(mesh))
    n_params, _ = cfg.param_count()
    fsdp = cfg.force_fsdp or n_params > 8e9
    api = jmodel_api(cfg)
    params = jax.eval_shape(lambda k: api.init(k, cfg), jax.random.PRNGKey(0))
    _, opt = jpick(n_params, 1e-4)
    opt_shapes = jax.eval_shape(opt.init, params)
    out = [jdry._bytes_per_device(
        t, JSH.param_shardings(cfg, t, am, fsdp), am)
        for t in (params, opt_shapes)]
    cache, _, _ = jspecs.input_specs(cfg, "decode_32k")
    out.append(jdry._bytes_per_device(
        cache, JSH.cache_shardings(cfg, cache, am), am))
    return out


def _port_bytes(arch, mesh):
    cfg = tget(arch)
    n_params, _ = cfg.param_count()
    fsdp = cfg.force_fsdp or n_params > 8e9
    params = model_api(cfg).init(torch.Generator(), cfg, device="meta")
    _, opt = pick_optimizer(n_params, 1e-4)
    out = [dryrun._bytes_per_device(t, TSH.param_shardings(cfg, t, mesh, fsdp),
                                    mesh) for t in (params, opt.init(params))]
    cache, _, _ = specs.input_specs(cfg, "decode_32k")
    out.append(dryrun._bytes_per_device(
        cache, TSH.cache_shardings(cfg, cache, mesh), mesh))
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", all_archs())
def test_bytes_per_device_equal_the_reference(arch, mesh):
    assert _port_bytes(arch, MESHES[mesh]) == _ref_bytes(arch, MESHES[mesh])


# --------------------------------------------------------------------------
# cells on fake tensors, each job in a process of its own
# --------------------------------------------------------------------------

def _smoke():
    return tget("smollm_360m", smoke=True)


def _cell(shape):
    detail = {}
    r = dryrun.run_cell("smollm_360m", "train_4k", mesh_dims=shape, seq=SEQ,
                        batch=BATCH, cfg=_smoke(), detail=detail)
    return dict(detail, res=r)


def _real_flops():
    """FlopCounterMode over one train step on real CPU tensors, every
    kernel through its operator; and the clip's and optimizer's share."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels._checks import operators_on_cpu
    from repro_torch.launch.steps import make_train_step
    cfg = _smoke()
    params = model_api(cfg).init(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    _, opt = pick_optimizer(cfg.param_count()[0], 1e-4)
    state = opt.init(params)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (BATCH, SEQ),
                                              dtype=np.int32))
             for k in ("inputs", "labels")}
    step = make_train_step(cfg, opt, device="cpu")
    with operators_on_cpu(), FlopCounterMode(display=False) as fc:
        step(params, state, batch)
    return {"flops": fc.get_total_flops(), "by_op": _by_op(fc)}


def _by_op(fc):
    return {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}


# F4: the cut xLSTM config of the sLSTM loop's comparison
XLSTM_CUT = dict(n_layers=2)
LOOP_SEQS = (32, 64)


def _loop_cells():
    """Each (shape, seq): the cell with the cut loop and with every step."""
    cfg = dataclasses.replace(tget("xlstm_125m"), **XLSTM_CUT)
    out = {}
    for shape in ("train_4k", "prefill_32k"):
        for seq in LOOP_SEQS:
            for cut in (True, False):
                detail = {}
                r = dryrun.run_cell("xlstm_125m", shape, mesh_dims=(2, 2),
                                    seq=seq, batch=8, cfg=cfg, detail=detail,
                                    cut_loop=cut)
                out[(shape, seq, cut)] = dict(detail, res=r)
    return out


# the decode cells at 16x16, each at a depth cut: (arch, shape, overrides)
DECODE_CUTS = {"deepseek_v3_671b": dict(n_layers=4),
               "jamba_1_5_large_398b": dict(n_layers=8),
               "xlstm_125m": dict(n_layers=2),
               "whisper_small": dict(n_layers=2, encoder_layers=2)}
DECODE_CELLS = [(a, "decode_32k") for a in DECODE_CUTS] + [
    ("jamba_1_5_large_398b", "long_500k"), ("xlstm_125m", "long_500k")]


def _decode_cell(arch, shape):
    cfg = dataclasses.replace(tget(arch), **DECODE_CUTS[arch])
    detail = {}
    r = dryrun.run_cell(arch, shape, cfg=cfg, detail=detail)
    return dict(detail, res=r)


JOBS = {"c11": lambda: _cell((1, 1)), "c21": lambda: _cell((2, 1)),
        "c41": lambda: _cell((4, 1)), "c12": lambda: _cell((1, 2)),
        "c22": lambda: _cell((2, 2)), "real": _real_flops,
        "loop": _loop_cells}
JOBS.update({f"{a} {s}": (lambda a=a, s=s: _decode_cell(a, s))
             for a, s in DECODE_CELLS})


def _child(_, tmp, jobs):
    torch.set_num_threads(1)
    out = {name: JOBS[name]() for name in jobs}
    torch.save(out, f"{tmp}/out.pt")


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = {}
    for name in JOBS:
        tmp = tmp_path_factory.mktemp(name)
        mp.spawn(_child, args=(str(tmp), [name]), nprocs=1, join=True)
        out.update(torch.load(tmp / "out.pt", weights_only=False))
    return out


# the clip's and the optimizer's operators: replicated work at (D, 1)
_REPLICATED = ("repro_torch.sumsq", "repro_torch.clip_finalize",
               "repro_torch.adamw_update")


def test_fake_flops_equal_real_cpu_flops(cells):
    r = cells["c11"]["res"]
    assert r.status == "ok", r.reason
    assert r.flops == cells["real"]["flops"] > 0
    assert cells["c11"]["flops_by_op"] == cells["real"]["by_op"]
    assert r.extra_flops == 0 and r.body_repeats == _smoke().n_periods


@pytest.mark.parametrize("d", [2, 4])
def test_a_ranks_flops_times_ranks_equal_one_rank(cells, d):
    rep = sum(v for k, v in cells["c11"]["flops_by_op"].items()
              if k in _REPLICATED)
    assert rep > 0
    one = cells["c11"]["res"].flops - rep
    got = cells[f"c{d}1"]["res"]
    assert got.status == "ok", got.reason
    assert (got.flops - rep) * d == one


@pytest.mark.parametrize("name, m", [("c12", 2), ("c22", 2)])
def test_counted_collectives(cells, name, m):
    from repro_torch.models.tensor_parallel import collectives_per_step
    cfg = _smoke()
    res, counted = cells[name]["res"], cells[name]["tp_counts"]
    want = collectives_per_step(cfg, m, SEQ)
    assert {k: v for k, v in counted.items() if not k.endswith("_bytes")} \
        == want
    n_leaves = len(tree_leaves(model_api(cfg).init(torch.Generator(), cfg,
                                                   device="meta")))
    data = n_leaves + 2              # gradients, the token count, the metrics
    clip = 1                         # the clip's partial sums over 'model'
    assert res.coll["count"] == sum(want.values()) + data + clip
    assert res.coll["all-reduce"] > 0 and res.coll["all-gather"] > 0


def test_reference_xla_flops_beside_the_ports(cells):
    """The reference's cost analysis of the same one-device SMOKE train
    cell, its layers unrolled (``scan_layers=False``: XLA counts a scan's
    body once) beside the port's flops; XLA counts elementwise work too,
    the port its operators' formulas and the products."""
    from repro.compat import compiled_flops
    from repro.launch.steps import make_train_step
    jcfg = dataclasses.replace(jget("smollm_360m", smoke=True),
                               scan_layers=False)
    api = jmodel_api(jcfg)
    _, opt = jpick(jcfg.param_count()[0], 1e-4)
    params = jax.eval_shape(lambda k: api.init(k, jcfg), jax.random.PRNGKey(0))
    state = jax.eval_shape(opt.init, params)
    batch = {k: jax.ShapeDtypeStruct((BATCH, SEQ), jnp.int32)
             for k in ("inputs", "labels")}
    xla = compiled_flops(jax.jit(make_train_step(jcfg, opt)).lower(
        params, state, batch).compile())
    port = cells["c11"]["res"].flops
    print(f"\nSMOKE smollm train {BATCH}x{SEQ}, one device: reference XLA "
          f"flops {xla:.6e}, port {port:.6e}, port / XLA {port / xla:.4f}")
    assert 0.25 < port / xla < 4


def test_cli_cell_prints_ok():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm_360m", "--shape", "decode_32k"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert "-> ok" in out.stdout, out.stdout + out.stderr


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
@pytest.mark.parametrize("seq", LOOP_SEQS)
def test_cut_slstm_loop_equals_every_step(cells, shape, seq):
    """The extrapolated counts of the cut loop equal the whole loop's."""
    cut, full = cells["loop"][(shape, seq, True)], cells["loop"][(shape, seq, False)]
    a, b = cut["res"], full["res"]
    assert a.status == b.status == "ok", (a.reason, b.reason)
    assert a.flops == b.flops > 0
    assert cut["flops_by_op"] == full["flops_by_op"]
    assert a.bytes_accessed == b.bytes_accessed
    assert a.coll == b.coll and cut["tp_counts"] == full["tp_counts"]
    assert a.peak_bytes_per_device == b.peak_bytes_per_device


def test_slstm_on_real_tensors_ignores_the_cut_loop():
    """``slstm_apply`` on real CPU tensors, inside ``CutLoop`` and outside
    it: the same outputs and gradients, bit for bit."""
    from repro_torch.models import ssm
    cfg = tget("xlstm_125m", smoke=True)
    p = ssm.slstm_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    x0 = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32))

    def run():
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in p.items()}
        x = x0.clone().requires_grad_(True)
        y = ssm.slstm_apply(leaves, x, cfg)
        y.square().sum().backward()
        return [y.detach(), x.grad] + [leaves[k].grad for k in sorted(leaves)]

    plain = run()
    with dryrun.CutLoop(2, [], measure=True):
        inside = run()
    for a, b in zip(plain, inside):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch, shape", DECODE_CELLS)
def test_decode_cells_of_the_split_mixers(cells, arch, shape):
    """Each decode cell runs (``ok``) and its collectives over 'model' and
    over the cache's axes are the design's for its mesh and batch."""
    from repro_torch.models.tensor_parallel import collectives_per_decode_step
    got = cells[f"{arch} {shape}"]
    assert got["res"].status == "ok", got["res"].reason
    cfg = dataclasses.replace(tget(arch), **DECODE_CUTS[arch])
    want = collectives_per_decode_step(cfg, MESHES["16x16"],
                                       specs.SHAPES[shape][1])
    assert {k: v for k, v in got["tp_counts"].items()
            if not k.endswith("_bytes")} == want
