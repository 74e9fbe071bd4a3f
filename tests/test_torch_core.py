"""``repro_torch.core`` against ``repro.core``: the same calls on the same
inputs give the same machine matrices, execution graphs, estimates, RLAS
plans, baselines and pipeline stage plans, byte for byte (the port's copy
runs the same NumPy)."""
import dataclasses
import math
import types

import numpy as np
import pytest

import repro.core as ref_core
import repro_torch.core as core
from repro.configs import get as ref_config
from repro.core import autoshard as ref_autoshard
from repro.core import baselines as ref_baselines
from repro.streaming import apps as ref_apps
from repro.streaming.api import Job as RefJob
from repro_torch.configs import get as port_config
from repro_torch.core import autoshard, baselines
from repro_torch.streaming import apps
from repro_torch.streaming.api import Job

# the paper's planner settings, as the reference's tests and bench run them
RLAS = dict(compress_ratio=5, bestfit=True, max_nodes=5000)
APPS = ["wc", "fd", "sd", "sd_et", "sd_key", "lr", "inference", "chain"]
# wall-clock fields: the only values two runs of one search may differ in
CLOCKS = {"wall_s"}


def make(name):
    """The app ``name`` from each package (the port's predictor on the
    CPU, where these tests run)."""
    kw = {"device": "cpu"} if name == "inference" else {}
    return ref_apps.ALL_APPS[name](), apps.ALL_APPS[name](**kw)


def assert_same(a, b, path="$", seen=None):
    """``a`` (the reference's) and ``b`` (the port's) hold the same values:
    arrays and scalars byte for byte, containers and objects field by
    field, classes by name; callables (kernels, sources) on both sides."""
    seen = set() if seen is None else seen
    if isinstance(a, (types.FunctionType, types.MethodType,
                      types.BuiltinFunctionType)):
        assert callable(b), path
        return
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        assert a.tobytes() == b.tobytes(), path
        return
    assert type(a).__qualname__ == type(b).__qualname__, \
        f"{path}: {type(a)} vs {type(b)}"
    if isinstance(a, float):
        assert a == b or (math.isnan(a) and math.isnan(b)), \
            f"{path}: {a!r} vs {b!r}"
    elif isinstance(a, (type(None), bool, int, str, bytes, np.generic)):
        assert a == b or (isinstance(a, np.floating) and np.isnan(a)
                          and np.isnan(b)), f"{path}: {a!r} vs {b!r}"
    elif isinstance(a, (set, frozenset)):
        assert a == b, path
    elif isinstance(a, dict):
        assert_same(list(a), list(b), f"{path}.keys()", seen)
        for (k, va), vb in zip(a.items(), b.values()):
            assert_same(va, vb, f"{path}[{k!r}]", seen)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), f"{path}: len {len(a)} vs {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]", seen)
    elif isinstance(a, type):
        return
    else:
        if id(a) in seen:
            return
        seen.add(id(a))
        names = list(getattr(a, "__dict__", {}))
        for cls in type(a).__mro__:
            names += [s for s in getattr(cls, "__slots__", ())
                      if s not in names and hasattr(a, s)]
        for n in names:
            if n not in CLOCKS:
                assert_same(getattr(a, n), getattr(b, n), f"{path}.{n}", seen)


def same_plan(pr, pp):
    """Two :class:`Plan` objects agree in everything the planner decided."""
    for field in ("placement", "parallelism", "optimizer", "input_rate",
                  "eval", "result", "chains", "options", "machine", "graph"):
        assert_same(getattr(pr, field), getattr(pp, field), f"plan.{field}")
    assert pr.R == pp.R


def test_same_public_names():
    assert ref_core.__all__ == core.__all__
    for name in ref_core.__all__:
        assert hasattr(core, name), name


MACHINES = {
    "server_a": lambda m: m.server_a(),
    "server_b": lambda m: m.server_b(),
    "server_a/1": lambda m: m.subset(m.server_a(), 1),
    "server_a/2": lambda m: m.subset(m.server_a(), 2),
    "server_b/4": lambda m: m.subset(m.server_b(), 4),
    "tpu_pod_spec": lambda m: m.tpu_pod_spec(n_pods=3, chips_per_pod=64),
}


@pytest.mark.parametrize("name", MACHINES)
def test_machine_specs_equal(name):
    a, b = MACHINES[name](ref_core), MACHINES[name](core)
    assert_same(a, b)
    assert a.total_cores == b.total_cores
    assert_same(a.distance_tiers(), b.distance_tiers())
    assert a.fetch_time(0, a.n_sockets - 1, 64.0) == \
        b.fetch_time(0, b.n_sockets - 1, 64.0)


@pytest.mark.parametrize("name", APPS)
def test_execution_graph_equal(name):
    ra, pa = make(name)
    assert_same(ra.graph, pa.graph, "logical")
    par = {op: 1 + i % 3 for i, op in enumerate(ra.graph.operators)}
    for ratio in (1, 2):
        g_ref = ref_core.ExecutionGraph(ra.graph, par, compress_ratio=ratio,
                                        routes=ra.routes())
        g = core.ExecutionGraph(pa.graph, par, compress_ratio=ratio,
                                routes=pa.routes())
        assert g.n_units == g_ref.n_units
        assert_same(g_ref, g, f"graph/{ratio}")


@pytest.mark.parametrize("name", APPS)
def test_estimate_equal(name):
    """The §3.1 rate model on a fixed placement, and ``Plan.estimate``."""
    ra, pa = make(name)
    par = {op: 2 for op in ra.graph.operators}
    m_ref, m = ref_core.server_a(), core.server_a()
    g_ref = ref_core.ExecutionGraph(ra.graph, par, routes=ra.routes())
    g = core.ExecutionGraph(pa.graph, par, routes=pa.routes())
    placement = [i % m.n_sockets for i in range(g.n_units)]
    for rate in (None, 1e5):
        assert_same(ref_core.evaluate(g_ref, m_ref, placement,
                                      input_rate=rate),
                    core.evaluate(g, m, placement, input_rate=rate))
    est_ref = RefJob(ra).plan(m_ref, optimizer="manual", parallelism=par,
                              placement=placement).estimate()
    est = Job(pa).plan(m, optimizer="manual", parallelism=par,
                       placement=placement).estimate()
    assert_same(est_ref, est)


@pytest.mark.parametrize("name,machine", [
    ("wc", "server_a"), ("fd", "server_a"), ("sd", "server_a"),
    ("lr", "server_a"), ("wc", "server_b"), ("lr", "server_b"),
    ("sd_et", "server_a"), ("inference", "server_a")])
def test_rlas_plans_equal(name, machine):
    ra, pa = make(name)
    pr = RefJob(ra).plan(getattr(ref_core, machine)(), optimizer="rlas",
                         **RLAS)
    pp = Job(pa).plan(getattr(core, machine)(), optimizer="rlas", **RLAS)
    same_plan(pr, pp)
    assert pp.eval.feasible and pp.R > 0


@pytest.mark.parametrize("name", ["wc", "lr", "fd"])
def test_baselines_equal(name):
    """First-fit, round-robin and seeded random plans, directly and through
    ``Job.plan``."""
    ra, pa = make(name)
    m_ref, m = ref_core.server_a(), core.server_a()
    par = {op: 2 for op in ra.graph.operators}
    g_ref = ref_core.ExecutionGraph(ra.graph, par, routes=ra.routes())
    g = core.ExecutionGraph(pa.graph, par, routes=pa.routes())
    for fn in ("ff_place", "rr_place"):
        for rate in (None, 2e5):
            assert_same(getattr(ref_baselines, fn)(g_ref, m_ref, rate),
                        getattr(baselines, fn)(g, m, rate), fn)
    for seed in (0, 7):
        assert_same(
            ref_baselines.random_plan(ra.graph, m_ref,
                                      np.random.default_rng(seed),
                                      routes=ra.routes()),
            baselines.random_plan(pa.graph, m, np.random.default_rng(seed),
                                  routes=pa.routes()), f"random/{seed}")
    for opt in ("ff", "rr", "random"):
        same_plan(RefJob(ra).plan(m_ref, optimizer=opt, seed=3),
                  Job(pa).plan(m, optimizer=opt, seed=3))


@pytest.mark.parametrize("kw", [
    dict(input_rate=None), dict(input_rate=5e5),
    dict(input_rate=None, tf_mode="worst"),
    dict(input_rate=None, tf_mode="zero"),
    dict(input_rate=None, bottleneck_rule="max_ratio", max_iters=20)],
    ids=["saturate", "rate", "fix-L", "fix-U", "max-ratio"])
def test_scaling_equal(kw):
    """``rlas_optimize`` (Alg. 1 + 2) on word count over 4 sockets."""
    ra, pa = make("wc")
    res_ref = ref_core.rlas_optimize(
        ra.graph, ref_core.subset(ref_core.server_a(), 4), routes=ra.routes(),
        compress_ratio=5, bestfit=True, max_nodes=5000, **kw)
    res = core.rlas_optimize(
        pa.graph, core.subset(core.server_a(), 4), routes=pa.routes(),
        compress_ratio=5, bestfit=True, max_nodes=5000, **kw)
    assert_same(res_ref, res)
    assert res.R == res_ref.R > 0


def test_bnb_matches_brute_force_in_both_packages():
    """Branch and bound against the exhaustive search, on a tiny graph."""
    ra, pa = make("sd")
    par = {op: 1 for op in ra.graph.operators}
    m_ref = ref_core.subset(ref_core.server_a(), 2)
    m = core.subset(core.server_a(), 2)
    g_ref = ref_core.ExecutionGraph(ra.graph, par, routes=ra.routes())
    g = core.ExecutionGraph(pa.graph, par, routes=pa.routes())
    bnb_ref = ref_core.bnb_place(g_ref, m_ref)
    bnb = core.bnb_place(g, m)
    assert_same(bnb_ref, bnb)
    brute_ref = ref_core.brute_force_place(g_ref, m_ref)
    brute = core.brute_force_place(g, m)
    assert_same(brute_ref, brute)
    assert bnb.R == pytest.approx(brute.R, rel=1e-9)


@pytest.mark.parametrize("arch", ["smollm_360m", "jamba_1_5_large_398b"])
def test_autoshard_plan_stages_equal(arch):
    """RLAS on the LM pipeline: the port's config plans the same stages as
    the reference's."""
    cfg_ref, cfg = ref_config(arch), port_config(arch)
    for f in ("n_layers", "d_model", "vocab", "name", "period"):
        assert getattr(cfg_ref, f) == getattr(cfg, f), f
    assert cfg_ref.n_periods == cfg.n_periods
    assert cfg_ref.param_count() == cfg.param_count()
    sp_ref = ref_autoshard.plan_stages(cfg_ref)
    sp = autoshard.plan_stages(cfg)
    for f in ("assignment", "parallelism", "dp_degree", "throughput",
              "crosses_pods"):
        assert_same(getattr(sp_ref, f), getattr(sp, f), f)
    same_plan(sp_ref.plan, sp.plan)
