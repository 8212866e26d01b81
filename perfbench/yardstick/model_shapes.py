"""Shapes of the OneTrans ranking model, derived from a configuration dict
(the ``config`` object of a file under ``configs/``).

Independent of the program: the parameter names follow the state-dict
layout that ``RankingTrainer.init_state(params=...)`` takes, and the
pyramid schedule is the paper's (tail ``round(total * ratio)`` queries, never
fewer than the NS tokens, never growing).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple, Tuple


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    init: str  # "normal" (std 0.02), "lecun" (truncated), "ones", "zeros", "const"
    fan_in: int = 0
    value: float = 0.0


def vocab(cfg: Mapping, feature: str) -> int:
    return dict((k, v) for k, v in cfg["feature_vocab_sizes"])[feature]


def non_seq_features(cfg: Mapping) -> List[str]:
    return list(cfg["user_features"]) + list(cfg["item_features"]) + list(cfg["context_features"])


def s_length(cfg: Mapping, seq_len: int) -> int:
    """S tokens of a batch whose every behaviour sequence has ``seq_len``
    positions: the sequences and one [SEP] between each two."""
    n_seq = len(cfg["sequence_features"])
    return n_seq * seq_len + max(n_seq - 1, 0)


def keep_lengths(cfg: Mapping, total: int) -> List[int]:
    """Kept (query) tokens per layer for a stream of ``total`` tokens."""
    out, cur = [], total
    for r in cfg["pyramid_ratios"]:
        keep = min(max(int(round(total * r)), cfg["num_ns_tokens"]), cur)
        out.append(keep)
        cur = keep
    return out


def layer_shapes(cfg: Mapping, s_len: int) -> List[Tuple[int, int]]:
    """(kept queries, keys) of each layer's attention over [S ; NS]."""
    total = s_len + cfg["num_ns_tokens"]
    out, cur = [], total
    for keep in keep_lengths(cfg, total):
        out.append((keep, cur))
        cur = keep
    return out


def param_specs(cfg: Mapping) -> Dict[str, ParamSpec]:
    """Every parameter of the model: name -> shape and initial rule (flax's
    defaults: lecun-normal kernels, zero biases, unit norm scales, N(0, 0.02)
    tables and [SEP]; an NS stack [n, in, out] counts n into its fan-in)."""
    d, n, f = cfg["embed_dim"], cfg["num_ns_tokens"], cfg["ffn_dim"]
    hd = (d // cfg["num_heads"]) * cfg["num_heads"]
    fe, sd, th = cfg["feature_embed_dim"], cfg["seq_item_feature_dim"], cfg["task_head_hidden"]
    feats = non_seq_features(cfg)
    ns_in = fe * len(feats) + sum(dim for _, dim in cfg["semantic_features"])
    specs: Dict[str, ParamSpec] = {}

    def linear(name, out_dim, in_dim, bias=0.0):
        specs[f"{name}.weight"] = ParamSpec((out_dim, in_dim), "lecun", in_dim)
        specs[f"{name}.bias"] = ParamSpec((out_dim,), "const" if bias else "zeros", 0, bias)

    for feat in feats:
        specs[f"tokenizer.embeds.{feat}.weight"] = ParamSpec((vocab(cfg, feat), fe), "normal")
    linear("tokenizer.ns_proj", n * d, ns_in)
    if cfg["sequence_features"]:
        specs["tokenizer.item_embed.weight"] = ParamSpec((vocab(cfg, "item_id"), sd), "normal")
        linear("tokenizer.seq_proj", d, sd)
        specs["tokenizer.sep_token"] = ParamSpec((d,), "normal")
    for i in range(cfg["num_layers"]):
        p = f"blocks.{i}."
        specs[p + "attn_norm.scale"] = ParamSpec((d,), "ones")
        specs[p + "ffn_norm.scale"] = ParamSpec((d,), "ones")
        for w in ("q_s", "k_s", "v_s"):
            linear(p + w, hd, d)
        for w in ("q_ns", "k_ns", "v_ns"):
            specs[p + w] = ParamSpec((n, d, hd), "lecun", n * d)
        linear(p + "o_proj", d, hd)
        linear(p + "ffn_s_in", f, d)
        linear(p + "ffn_s_out", d, f)
        specs[p + "ffn_ns_in"] = ParamSpec((n, d, f), "lecun", n * d)
        specs[p + "ffn_ns_in_b"] = ParamSpec((n, f), "zeros")
        specs[p + "ffn_ns_out"] = ParamSpec((n, f, d), "lecun", n * f)
        specs[p + "ffn_ns_out_b"] = ParamSpec((n, d), "zeros")
    specs["final_norm.scale"] = ParamSpec((d,), "ones")
    bias0 = cfg.get("task_logit_bias_init") or [0.0] * len(cfg["tasks"])
    for t, b0 in zip(cfg["tasks"], bias0):
        linear(f"heads.{t}.hidden", th, d)
        linear(f"heads.{t}.out", 1, th, float(b0))
    return specs


def table_names(cfg: Mapping) -> List[str]:
    """The id tables, which take the touched-row update."""
    names = [f"tokenizer.embeds.{f}.weight" for f in non_seq_features(cfg)]
    return names + (["tokenizer.item_embed.weight"] if cfg["sequence_features"] else [])
