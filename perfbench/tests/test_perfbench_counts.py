"""The operation and byte counts against shapes worked by hand."""

import pytest

from perfbench.yardstick.flops import band_attention_work, band_pairs, model_flops
from perfbench.yardstick.model_shapes import keep_lengths, layer_shapes, s_length

TINY = {"embed_dim": 8, "num_heads": 2, "ffn_dim": 16, "num_ns_tokens": 2,
        "pyramid_ratios": [0.5, 0.25], "sequence_features": ["a", "b"],
        "user_features": ["u"], "item_features": [], "context_features": [],
        "feature_embed_dim": 4, "seq_item_feature_dim": 4, "semantic_features": [],
        "task_head_hidden": 3, "tasks": ["ctr"]}


@pytest.mark.parametrize("keep,keys,pairs", [
    (1, 1, 1), (2, 2, 3), (2, 5, 2 * 3 + 3), (601, 1202, 601 * 601 + 601 * 602 // 2)])
def test_band_pairs(keep, keys, pairs):
    # query i of the tail sees keys - keep + i + 1 keys
    assert band_pairs(keep, keys) == pairs == sum(keys - keep + i + 1 for i in range(keep))


def test_pyramid_shapes():
    # S = 2 sequences of 3 + 1 [SEP] = 7, total 9: keep round(4.5) = 4, round(2.25) = 2
    assert s_length(TINY, 3) == 7
    assert keep_lengths(TINY, 9) == [4, 2]
    assert layer_shapes(TINY, 7) == [(4, 9), (2, 4)]


def test_the_cells_layers():
    l_cfg = {**TINY, "num_ns_tokens": 12, "sequence_features": ["a", "b", "c"],
             "pyramid_ratios": [0.5, 0.3, 0.2, 0.1, 0.05, 0.03, 0.02, 0.01]}
    assert s_length(l_cfg, 396) == 1190
    assert layer_shapes(l_cfg, 1190)[:4] == [(601, 1202), (361, 601), (240, 361), (120, 240)]
    assert layer_shapes(l_cfg, 1190)[-1] == (12, 24)


def test_model_flops_by_hand():
    d, f, s = 8, 16, 7
    macs = s * 4 * d + 4 * 2 * d  # S projection; NS projection (1 feature x 4 wide -> 2 x 8)
    for keep, keys in [(4, 9), (2, 4)]:
        pairs = keep * (keys - keep) + keep * (keep + 1) // 2
        macs += 2 * keys * d * d + keep * d * d + 2 * pairs * d + keep * d * d + 2 * keep * d * f
    macs += d * 3 + 3
    assert model_flops(TINY, s, training=False) == 2 * macs
    assert model_flops(TINY, s) == 6 * macs


def test_band_attention_work_by_hand():
    # Dh 4, 2 heads, batch 3; layer (4, 9): 6+7+8+9 = 30 pairs, layer (2, 4): 3 + 4 = 7
    w = band_attention_work(TINY, 7, 3)
    assert w["flops"] == 12 * 4 * (30 + 7) * 2 * 3
    assert w["bytes"] == ((4 * 4 + 4 * 9) + (4 * 2 + 4 * 4)) * 2 * 4 * 3 * 2
