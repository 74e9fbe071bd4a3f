"""The decode-attention kernel's split plan (pure Python, no card): how the
cache of each (batch, kv head) is cut into the blocks of one launch."""
import pytest

from repro_torch.kernels.decode_attention import (MAX_SPLITS, ROWS_PER_BLOCK,
                                                  split_plan)

H100_SMS = 132

SHAPES = [  # b, hkv, g, s
    (8, 5, 3, 129),      # smollm-360M serving: 15 q / 5 kv heads
    (8, 8, 8, 129),      # Jamba serving: 64 q / 8 kv heads
    (8, 5, 3, 4096),     # smollm-360M with a long context
    (1, 1, 1, 1), (1, 1, 1, 5), (2, 4, 1, 64), (3, 2, 8, 700),
    (64, 8, 8, 129), (1, 2, 16, 100000), (4, 8, 4, 33), (2, 2, 5, 257),
]


def _grid(b, hkv, g, n_split):
    return b * hkv * -(-g // ROWS_PER_BLOCK) * n_split


@pytest.mark.parametrize("b,hkv,g,s", SHAPES)
@pytest.mark.parametrize("n_sm", [1, 16, H100_SMS])
def test_split_plan_covers_every_key_once(b, hkv, g, s, n_sm):
    n_split, chunk = split_plan(b, hkv, g, s, n_sm)
    assert 1 <= n_split <= MAX_SPLITS
    covered = [0] * s
    for i in range(n_split):
        keys = range(i * chunk, min(s, (i + 1) * chunk))
        assert len(keys) > 0, f"split {i} of {n_split} is empty"
        for key in keys:
            covered[key] += 1
    assert covered == [1] * s


@pytest.mark.parametrize("b,hkv,g,s", [(8, 5, 3, 129), (8, 8, 8, 129),
                                       (8, 5, 3, 4096)])
def test_split_plan_fills_the_card_at_the_main_path_shapes(b, hkv, g, s):
    n_split, _ = split_plan(b, hkv, g, s, H100_SMS)
    assert _grid(b, hkv, g, n_split) >= H100_SMS


def test_split_plan_long_cache_takes_the_cap_and_short_chunks_stay_whole():
    assert split_plan(8, 5, 3, 4096, H100_SMS) == (MAX_SPLITS, 512)
    # a grid that already fills the card is not split further
    assert split_plan(64, 8, 8, 129, H100_SMS) == (1, 129)
    # no chunk shorter than MIN_CHUNK keys unless the cache is
    assert split_plan(1, 1, 1, 5, H100_SMS) == (1, 5)


@pytest.mark.parametrize("args", [(0, 1, 1, 1, 1), (1, 1, 1, 0, 1),
                                  (1, 1, 0, 5, 1), (1, 1, 1, 5, 0)])
def test_split_plan_refuses_empty_shapes(args):
    with pytest.raises(ValueError):
        split_plan(*args)
