"""Training over four gloo processes against one process, on the CPU.

The jobs and the oracle are :mod:`test_torch_dist`'s: smollm SMOKE through
``launch.train.train`` on a ``(4, 1)`` mesh (data parallelism, and ZeRO-3
with every sharded leaf a quarter at rest) and on a ``(2, 2)`` mesh with
``pure_dp`` (the batch over both axes: 4-way data parallelism, the params
replicated), each against the one-process run on the same weights and
global batches.
"""
import pytest

from test_torch_dist import _same_run, _spawn, _train


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("world4"), 4,
                  ["dp4", "puredp", "zero3_4"])


@pytest.fixture(scope="module")
def one_smollm():
    return _train("smollm_360m")


@pytest.mark.parametrize("job", ["dp4", "puredp", "zero3_4"])
def test_four_ranks_equal_one_process(world4, one_smollm, job):
    _same_run([r[job] for r in world4], one_smollm)


def test_zero3_holds_quarters_at_rest(world4):
    for r in world4:
        rest = r["zero3_4"]["at_rest"]
        assert sum(sharded for sharded, *_ in rest) >= 5
        for sharded, local, mu, nu, whole in rest:
            assert local == mu == nu == (whole // 4 if sharded else whole)
