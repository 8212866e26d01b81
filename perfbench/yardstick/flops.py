"""Operation and byte counts of the OneTrans training step, from shapes.

``model_flops`` counts a forward pass per example, two FLOPs per
multiply-add: the tokenizer's projections, per layer the K/V projections
over every token, Q, O and the FFN over the kept tokens, the attention
products over the (query, key) pairs that the causal band allows, and the
task heads. A training step counts three forwards (the backward is two).

``band_attention_work`` counts what the step's band attention needs,
whatever kernel computes it: 4·Dh FLOPs for each allowed pair forward
(Q·K and P·V) and 8·Dh backward (dV, dP, dQ, dK; nothing recomputed), and
Q, K, V, O and dO read once and dQ, dK, dV written once in the compute
dtype. Every layer's attention is counted.
"""

from __future__ import annotations

from typing import Dict, Mapping

from perfbench.yardstick.model_shapes import layer_shapes, non_seq_features


def band_pairs(keep: int, keys: int) -> int:
    """(query, key) pairs allowed when the ``keep`` queries are the tail of
    ``keys`` positions and each sees the keys at or before its own."""
    return keep * (keys - keep) + keep * (keep + 1) // 2


def model_flops(cfg: Mapping, s_len: int, training: bool = True) -> float:
    """FLOPs per example of a forward (``training``: of a step)."""
    d, f, n = cfg["embed_dim"], cfg["ffn_dim"], cfg["num_ns_tokens"]
    hd = (d // cfg["num_heads"]) * cfg["num_heads"]
    macs = s_len * cfg["seq_item_feature_dim"] * d
    ns_in = cfg["feature_embed_dim"] * len(non_seq_features(cfg)) + sum(
        dim for _, dim in cfg["semantic_features"])
    macs += ns_in * n * d
    for keep, keys in layer_shapes(cfg, s_len):
        macs += 2 * keys * d * hd  # K, V
        macs += keep * d * hd  # Q
        macs += 2 * band_pairs(keep, keys) * hd  # Q·K and P·V
        macs += keep * hd * d  # O
        macs += 2 * keep * d * f  # FFN
    th = cfg["task_head_hidden"]
    macs += len(cfg["tasks"]) * (d * th + th)
    return 2.0 * macs * (3.0 if training else 1.0)


def band_attention_work(cfg: Mapping, s_len: int, batch: int,
                        bytes_per_value: int = 2) -> Dict[str, float]:
    """FLOPs and bytes of one training step's band attention (forward and
    backward) over ``batch`` examples."""
    h = cfg["num_heads"]
    dh = cfg["embed_dim"] // h
    flops = nbytes = 0.0
    for keep, keys in layer_shapes(cfg, s_len):
        flops += (4 + 8) * dh * band_pairs(keep, keys) * h * batch
        # Q, O, dO read and dQ written; K, V read and dK, dV written
        nbytes += (4 * keep + 4 * keys) * h * dh * batch * bytes_per_value
    return {"flops": flops, "bytes": nbytes}
