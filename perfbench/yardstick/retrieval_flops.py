"""Operation and byte counts of the KuaiFormer seq2seq training step, from
shapes, with every history item valid (the traffic's full histories).

``attention_pairs`` lists, for each attention of a forward pass, its
(query, key) pairs that the masks allow: a compression group's
bidirectional encoder sees its whole group (the padding mask keeps every
valid key), and the main stack's interleaved sequence ``[items (T) ;
query groups (T·k)]`` lets item t see the items up to t, and query (t, j)
the items up to t and the k queries of its own group.

``model_flops`` counts a forward pass per example, two FLOPs per
multiply-add: the fusion MLP of every item embedded (the L history items
and the R next items), per block Q, K, V, O and the SwiGLU FFN over every
token and the attention products (Q·K and P·V) over the allowed pairs,
and the in-batch logits of the R positions (k interests against the
batch's columns). A training step counts three forwards.

``attention_work`` counts what the step's attention needs, whatever
computes it: 4·Dh FLOPs for each allowed pair forward and 8·Dh backward,
and Q, K, V, O and dO read once and dQ, dK, dV written once in the compute
dtype, for every attention of the compression and of the main stack.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple

from perfbench.yardstick.retrieval_shapes import compressed_tokens, raw_tail, schedule


class Attention(NamedTuple):
    """One attention layer of a forward pass: ``rows`` independent
    sequences per example, each of ``length`` tokens with ``pairs``
    allowed (query, key) pairs."""
    rows: int
    length: int
    pairs: int


def main_pairs(tokens: int, queries: int) -> int:
    """Allowed pairs of the interleaved causal mask over ``tokens`` items
    and ``queries`` query tokens after each."""
    items = tokens * (tokens + 1) // 2
    return items + queries * (items + tokens * queries)


def attention_pairs(cfg: Mapping) -> List[Attention]:
    """Every attention of a seq2seq forward pass, per example."""
    out = []
    for length, g in schedule(cfg):
        if g > 1:
            out += [Attention(length // g, g, g * g)] * cfg["compression_layers"]
    t, k = compressed_tokens(cfg), cfg["num_query_tokens"]
    out += [Attention(1, t * (1 + k), main_pairs(t, k))] * cfg["num_layers"]
    return out


def _check_mode(mode: str) -> None:
    if mode != "seq2seq":
        raise ValueError(f"the counts follow the seq2seq mode only, not {mode!r}")


def model_flops(cfg: Mapping, batch: int, mode: str = "seq2seq",
                training: bool = True) -> float:
    """FLOPs per example of a forward (``training``: of a step) at
    ``batch`` examples, whose items are every row's in-batch columns."""
    _check_mode(mode)
    d, f = cfg["embed_dim"], cfg["ffn_dim"]
    r, k = raw_tail(cfg), cfg["num_query_tokens"]
    macs = (cfg["max_seq_len"] + r) * (5 * d * 2 * d + 2 * d * d)  # fusion MLP
    for a in attention_pairs(cfg):
        macs += a.rows * a.length * (4 * d * d + 3 * d * f)  # Q, K, V, O; FFN
        macs += a.rows * 2 * a.pairs * d  # Q·K and P·V over every head
    macs += r * k * batch * d  # the in-batch logits
    return 2.0 * macs * (3.0 if training else 1.0)


def attention_work(cfg: Mapping, batch: int, mode: str = "seq2seq",
                   bytes_per_value: int = 2) -> Dict[str, float]:
    """FLOPs and bytes of one training step's attention (forward and
    backward) over ``batch`` examples."""
    _check_mode(mode)
    h = cfg["num_heads"]
    dh = cfg["embed_dim"] // h
    flops = nbytes = 0.0
    for a in attention_pairs(cfg):
        flops += (4 + 8) * dh * a.pairs * h * a.rows * batch
        # Q, O, dO read and dQ written; K, V read and dK, dV written
        nbytes += 8 * a.length * h * dh * a.rows * batch * bytes_per_value
    return {"flops": flops, "bytes": nbytes}
