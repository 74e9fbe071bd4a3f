"""Gradient compression (``optim/compress.py``) against the reference's.

``quantize_int8`` given the reference's own noise (``jax.random.uniform(key)
- 0.5`` through the private entry that takes it) gives the reference's q bit
for bit and its scale exactly; so does ``stochastic=False``. The bucket
keeps each leaf's dtype through a round trip; the mean of 256 draws is
unbiased. ``cross_pod_allreduce_int8`` on a (1, 1, 1) mesh passes the
reference's own test (within 2e-2 of the input), and over two gloo ranks
at (2, 1, 1) ``("pod", "data", "model")`` it gives the reference formula's
mean of the two pods' dequantized buffers, each element within one
quantization step of the exact mean. Without a 'pod' axis it is the
identity.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compress as jcompress
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.module import tree_leaves
from repro_torch.optim import compress
from test_torch_dist import _spawn


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.standard_normal((8, 8), np.float32)),
            "b": [torch.from_numpy(rng.standard_normal(5, np.float32))
                  .to(torch.bfloat16),
                  torch.from_numpy(rng.standard_normal((3, 2), np.float32))]}


@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_equals_the_reference_bit_for_bit(stochastic, seed):
    x = np.random.default_rng(seed).standard_normal((33, 17)).astype(np.float32)
    x[0, 0] = 7.25                      # a large value sets the scale
    key = jax.random.PRNGKey(seed)
    jq, js = jcompress.quantize_int8(jnp.asarray(x), key, stochastic=stochastic)
    if stochastic:
        noise = np.asarray(jax.random.uniform(key, x.shape, jnp.float32) - 0.5)
        q, s = compress._quantize(torch.from_numpy(x), torch.from_numpy(noise.copy()))
    else:
        q, s = compress.quantize_int8(torch.from_numpy(x), stochastic=False)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js)
    back = compress.dequantize_int8(q, s)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jcompress.dequantize_int8(jq, js)))


def test_bucket_round_trip_keeps_each_dtype():
    tree = _grads(3)
    flat, meta = compress.flatten_bucket(tree)
    assert flat.dtype == torch.float32 and flat.numel() == 64 + 5 + 6
    back = compress.unflatten_bucket(flat, meta)
    for got, want in zip(tree_leaves(back), tree_leaves(tree)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert list(back) == list(tree)


def test_stochastic_rounding_is_unbiased():
    x = torch.linspace(-1.0, 1.0, 1001)
    gen = torch.Generator().manual_seed(0)
    draws = [compress.dequantize_int8(*compress.quantize_int8(x, gen))
             for _ in range(256)]
    scale = float(x.abs().max()) / 127
    err = (torch.stack(draws).mean(0) - x).abs().max().item()
    assert err <= 4 * scale / 256 ** 0.5, err


def test_identity_without_a_pod_axis():
    grads = _grads(0)
    assert compress.cross_pod_allreduce_int8(grads, {"data": 1, "model": 1},
                                             torch.Generator()) is grads


def _exchange(world):
    mesh = make_mesh((world, 1, 1), ("pod", "data", "model"))
    rank = torch.distributed.get_rank()
    grads = _grads(10 + rank)
    out = compress.cross_pod_allreduce_int8(
        grads, mesh, torch.Generator().manual_seed(42))
    return {"grads": grads, "out": out}


def _reference_case():
    """The reference's test_gradient_int8_cross_pod_allreduce_single_device
    on the port: a (1, 1, 1) mesh, within 2e-2."""
    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"))
    grads = {"w": torch.linspace(-1, 1, 64).reshape(8, 8)}
    return {"grads": grads, "out": compress.cross_pod_allreduce_int8(
        grads, mesh, torch.Generator().manual_seed(0))}


JOBS = {"pod2": lambda d: _exchange(2), "reference": lambda d: _reference_case()}


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    one = _spawn(tmp_path_factory.mktemp("pod1"), 1, ["reference"],
                 module=__name__)
    two = _spawn(tmp_path_factory.mktemp("pod2"), 2, ["pod2"], module=__name__)
    return one[0]["reference"], [r["pod2"] for r in two]


def test_reference_single_device_case(pods):
    r = pods[0]
    np.testing.assert_allclose(r["out"]["w"].numpy(), r["grads"]["w"].numpy(),
                               atol=2e-2)


def test_two_pods_give_the_reference_formulas_mean(pods):
    ranks = pods[1]
    flats = [compress.flatten_bucket(r["grads"])[0] for r in ranks]
    # every pod draws the same noise: the generator is seeded alike
    deq = []
    for flat in flats:
        q, s = compress.quantize_int8(flat, torch.Generator().manual_seed(42))
        deq.append(q.float() * s)
    want_flat = torch.stack(deq).mean(0)
    exact = torch.stack(flats).mean(0)
    step = max(float(f.abs().max()) for f in flats) / 127
    _, meta = compress.flatten_bucket(ranks[0]["grads"])
    want = tree_leaves(compress.unflatten_bucket(want_flat, meta))
    near = tree_leaves(compress.unflatten_bucket(exact, meta))
    for r in ranks:
        for got, w, e in zip(tree_leaves(r["out"]), want, near):
            assert got.dtype == w.dtype and torch.equal(got, w)
            # one quantization step, and a bf16 leaf's own rounding
            ulp = 2.0 ** -8 * e.float().abs() if e.dtype == torch.bfloat16 else 0
            assert ((got.float() - e.float()).abs() <= step + ulp).all()
