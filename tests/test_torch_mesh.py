"""The port's mesh layer against the JAX package, with no processes: the
hillclimb variants, the sharding rules, ``partitioning`` and the raises.

The reference's ``param_pspec`` / ``cache_pspec`` / ``batch_pspec`` read a
mesh's axis sizes and names only, so a ``jax.sharding.AbstractMesh`` stands
in for meshes far larger than this host; the port's rules take the same
sizes as a ``{axis: size}`` mapping. Param trees are the SMOKE configs'
(the reference's shapes from ``jax.eval_shape``, the port's drawn on the
meta device), cache trees ``init_cache(cfg, B, max_len=8)`` at B 1 and 2.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS
from repro.configs import get as jget
from repro.configs import variants as jvariants
from repro.launch import shardings as JSH
from repro.models import model_api as jmodel_api
from repro_torch.configs import get as tget
from repro_torch.configs import variants as tvariants
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import shardings as TSH
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import train
from repro_torch.models import layers as tlayers
from repro_torch.models import model_api
from repro_torch.models import partitioning as part
from repro_torch.optim.optimizers import adamw

MESHES = [{"data": 1, "model": 1}, {"data": 2, "model": 2},
          {"data": 4, "model": 2}, {"data": 16, "model": 16},
          {"pod": 2, "data": 16, "model": 16}]
MESH_IDS = ["x".join(map(str, m.values())) for m in MESHES]


def _abstract(mesh):
    return AbstractMesh(tuple(mesh.values()), tuple(mesh))


@pytest.mark.parametrize("key", sorted(jvariants.VARIANTS))
def test_variant_resolves_to_the_reference_fields(key):
    """Each variant key and display-name alias resolves, in the port's
    ``configs.get`` as in the reference's, whatever ``smoke`` says, to a
    config whose every field is the reference's."""
    want = dataclasses.asdict(jget(key))
    assert key in tvariants.VARIANTS
    for smoke in (False, True):
        assert dataclasses.asdict(tget(key, smoke=smoke)) == want
    name = jvariants.VARIANTS[key].name
    assert dataclasses.asdict(tget(name)) == want


def test_variants_registered_and_distinct():
    """The port's counterpart of the reference's dry-run unit test."""
    assert len(set(map(id, tvariants.VARIANTS.values()))) == 10
    assert tget("smollm_360m_padheads").n_heads == 16
    assert tget("smollm_360m").n_heads == 15
    assert tget("qwen3_moe_235b_a22b_cap1").capacity_factor == 1.0
    assert tget("smollm_360m_padheads_fsdp").force_fsdp
    with pytest.raises(KeyError, match="variants"):
        tget("smollm_360m_nosuchvariant")


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """(reference param shapes, port params on meta, reference caches at B
    1 and 2, port caches at B 1 and 2)."""
    jcfg, tcfg = jget(arch, smoke=True), tget(arch, smoke=True)
    japi, tapi = jmodel_api(jcfg), model_api(tcfg)
    jparams = jax.eval_shape(lambda k: japi.init(k, jcfg),
                             jax.random.PRNGKey(0))
    tparams = tapi.init(torch.Generator(), tcfg, device="meta")
    jcache = {b: jax.eval_shape(lambda b=b: japi.init_cache(jcfg, b, max_len=8))
              for b in (1, 2)}
    tcache = {b: tapi.init_cache(tcfg, b, 8, device="cpu") for b in (1, 2)}
    return jparams, tparams, jcache, tcache


def _ref_specs(tree, fn):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(JSH._names(path)): tuple(fn(path, leaf))
            for path, leaf in flat}


def _port_specs(tree, fn):
    out = {}
    TSH.map_with_path(lambda path, leaf: out.__setitem__(
        tuple(TSH._names(path)), fn(path, leaf)), tree)
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh):
    """Every leaf's spec, fsdp on and off, and under ``pure_dp``."""
    jparams, tparams, _, _ = _trees(arch)
    am = _abstract(mesh)
    for pure_dp in (False, True):
        jcfg = dataclasses.replace(jget(arch, smoke=True), pure_dp=pure_dp)
        tcfg = dataclasses.replace(tget(arch, smoke=True), pure_dp=pure_dp)
        for fsdp in (False, True):
            want = _ref_specs(jparams, lambda p, l: JSH.param_pspec(
                p, l, jcfg, am, fsdp))
            got = _port_specs(tparams, lambda p, l: TSH.param_pspec(
                p, l, tcfg, mesh, fsdp))
            assert got == want, (arch, mesh, pure_dp, fsdp)
            placements = TSH.param_shardings(tcfg, tparams, mesh, fsdp)
            for leaf_path, spec in got.items():
                node = placements
                for name in leaf_path:
                    node = node[int(name[1:-1])] if name.startswith("[") \
                        else node[name]
                assert node == tmesh.named(mesh, *spec)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_reference(arch, mesh):
    _, _, jcache, tcache = _trees(arch)
    am = _abstract(mesh)
    jcfg, tcfg = jget(arch, smoke=True), tget(arch, smoke=True)
    for b in (1, 2):
        want = _ref_specs(jcache[b], lambda p, l: JSH.cache_pspec(
            p, l, jcfg, am))
        got = _port_specs(tcache[b], lambda p, l: TSH.cache_pspec(
            p, l, tcfg, mesh))
        assert got == want, (arch, mesh, b)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_batch_and_input_specs_equal_the_reference(mesh):
    """``batch_pspec`` over batch sizes that divide all, some or none of the
    axes, and ``input_shardings`` with and without ``pure_dp`` and
    ``seq_shard`` (tokens over 'model' where it divides the sequence)."""
    am = _abstract(mesh)
    for batch in (1, 2, 3, 4, 8, 16, 32, 256, 512, 1024):
        for pure_dp in (False, True):
            for extra in (0, 1, 2):
                assert TSH.batch_pspec(mesh, batch, extra, pure_dp) == \
                    tuple(JSH.batch_pspec(am, batch, extra, pure_dp))
    base = tget("h2o_danube_1_8b", smoke=True)
    for pure_dp in (False, True):
        for seq_shard in (False, True):
            jcfg = dataclasses.replace(jget("h2o_danube_1_8b", smoke=True),
                                       pure_dp=pure_dp, seq_shard=seq_shard)
            tcfg = dataclasses.replace(base, pure_dp=pure_dp,
                                       seq_shard=seq_shard)
            for b, s in ((32, 64), (8, 6), (512, 32), (3, 16)):
                jb = {"inputs": jax.ShapeDtypeStruct((b, s), np.int32),
                      "embeds": jax.ShapeDtypeStruct((b, s, 4), np.float32)}
                tb = {"inputs": torch.empty((b, s), device="meta"),
                      "embeds": torch.empty((b, s, 4), device="meta")}
                try:
                    want = JSH.input_shardings(jcfg, jb, am)
                except Exception as e:
                    # pure_dp puts 'model' in the batch's axes and seq_shard
                    # puts it on the tokens: both packages refuse the spec
                    assert type(e).__name__ == "DuplicateSpecError", e
                    with pytest.raises(ValueError, match="used twice"):
                        TSH.input_shardings(tcfg, tb, mesh)
                    continue
                got = TSH.input_shardings(tcfg, tb, mesh)
                for k in jb:
                    spec = tuple(want[k].spec)
                    assert TSH.input_pspec(tcfg, tb[k], mesh) == \
                        spec + (None,) * (tb[k].ndim - len(spec))
                    assert got[k] == tmesh.named(mesh, *TSH.input_pspec(
                        tcfg, tb[k], mesh))


def test_mesh_accessors_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    m = {"pod": 2, "data": 16, "model": 16}
    assert tmesh.axis_names(m) == ("pod", "data", "model")
    assert tmesh.batch_axes(m) == ("pod", "data")
    assert tmesh.batch_axes({"data": 2, "model": 1}) == ("data",)
    assert tmesh.fsdp_axis(m) == "data" and tmesh.fsdp_axis({"x": 1}) is None
    assert tmesh.named(m, ("pod", "data"), "model") == (Shard(0), Shard(0),
                                                         Shard(1))
    assert tmesh.named(m, None, "data") == (Replicate(), Shard(1),
                                            Replicate())
    for bad in (("nope",), ("data", "data")):
        with pytest.raises(ValueError):
            tmesh.named(m, *bad)
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh((2, 1), ("data", "model"))


def test_partitioning_state_and_constrain():
    """``constrain`` returns its argument with no mesh, and a plain tensor
    under a mesh (the port's data parallelism); ``use_mesh`` nests and
    restores; 'BATCH' expands to the registered batch axes; a spec it
    cannot apply does not raise."""
    x = torch.ones(4, 2)
    assert part.current_mesh() is None
    assert part.constrain(x, "BATCH", None) is x
    assert part.batch_mean(x) is x
    outer, inner = {"data": 2, "model": 1}, {"pod": 2, "data": 2, "model": 1}
    with part.use_mesh(outer):
        assert part.current_mesh() is outer
        assert part.resolve("BATCH", None) == (("data",), None)
        with part.use_mesh(inner, ("pod", "data")):
            assert part.current_mesh() is inner
            assert part.batch_axes() == ("pod", "data")
            assert part.resolve("model", "BATCH") == ("model", ("pod", "data"))
            assert part.constrain(x, "BATCH", "nosuchaxis") is x
        assert part.current_mesh() is outer and part.batch_axes() == ("data",)
        assert part.constrain(x, "model", "BATCH") is x
    assert part.current_mesh() is None


def test_the_port_refuses_what_it_does_not_run():
    """Tensor parallelism (a 'model' axis above 1 without ``pure_dp``)
    makes its step for every family: xLSTM (mLSTM / sLSTM), the dense
    decoders and Jamba (Mamba) make theirs; training ``seq_shard``
    under a 'model' axis above 1 makes its step (the tokens over 'model');
    attention with ``seq_shard`` under a 'model' axis above 1 but no token
    split registered runs plain attention on whole sequences (the
    reference's behaviour where 'model' does not divide S); a mesh shape
    other than (1, 1) with no process group raises."""
    cfg = tget("xlstm_125m", smoke=True)
    make_train_step(cfg, adamw(1e-3), device="cpu",
                    mesh={"data": 1, "model": 2})
    make_train_step(dataclasses.replace(cfg, pure_dp=True), adamw(1e-3),
                    device="cpu", mesh={"data": 1, "model": 2})
    for arch in ("smollm_360m", "jamba_1_5_large_398b"):
        make_train_step(tget(arch, smoke=True), adamw(1e-3), device="cpu",
                        mesh={"data": 1, "model": 2})
    dcfg = dataclasses.replace(tget("h2o_danube_1_8b", smoke=True),
                               seq_shard=True)
    p = {k: torch.randn(dcfg.d_model, dcfg.d_model) * 0.1
         for k in ("wq", "wo")}
    p.update({k: torch.randn(dcfg.d_model, dcfg.n_kv_heads * dcfg.hd) * 0.1
              for k in ("wk", "wv")})
    x, pos = torch.randn(2, 16, dcfg.d_model), torch.arange(16)
    make_train_step(tget("h2o_danube_1_8b_seqp", smoke=True), adamw(1e-3),
                    device="cpu", mesh={"data": 1, "model": 2})
    with part.use_mesh({"data": 1, "model": 2}):
        plain = tlayers.attn_apply(p, x, dcfg, pos)
    assert torch.equal(plain, tlayers.attn_apply(p, x, dcfg, pos))
    with part.use_mesh({"data": 2, "model": 1}):
        got = tlayers.attn_apply(p, x, dcfg, pos)
    assert torch.equal(got, tlayers.attn_apply(p, x, dcfg, pos))
    with pytest.raises(RuntimeError, match="process group"):
        train("smollm_360m", mesh_shape=(1, 2), device="cpu")
