"""Shapes of the KuaiFormer retrieval tower, derived from a configuration
dict (the ``config`` object of ``configs/kuaiformer_flagship.json``).

Independent of the program: the parameter names follow the state-dict
layout that ``RetrievalTrainer.init_state(params=...)`` takes (the tower's
``nn.Linear`` weights [out, in]), and the schedule is the paper's adaptive
compression: each segment of ``length`` items in groups of ``group_size``,
one token a group, a group of one kept raw.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

from perfbench.yardstick.model_shapes import ParamSpec

# the id features, whose tables take the touched-row update, and the
# bucketed ones, whose tables are dense parameters
ID_FEATURES = ("video_id", "category", "tag")
BUCKETED = ("duration", "timestamp")
FEATURES = ID_FEATURES + BUCKETED


def vocab(cfg: Mapping, feature: str) -> int:
    return {"video_id": cfg["video_vocab_size"], "category": cfg["category_vocab_size"],
            "tag": cfg["tag_vocab_size"], "duration": cfg["duration_buckets"],
            "timestamp": cfg["time_buckets"]}[feature]


def table(feature: str) -> str:
    """A feature's table parameter."""
    return f"embed.tables.{feature}.weight"


def table_names(cfg: Mapping) -> List[str]:
    """The tables the touched-row update trains (none without it)."""
    return [table(f) for f in ID_FEATURES] if cfg["use_sparse_embedding_updates"] else []


def schedule(cfg: Mapping) -> List[Tuple[int, int]]:
    """(length, group_size) of each compression segment, oldest first."""
    return [tuple(s) for s in cfg["compression_schedule"]]


def compressed_tokens(cfg: Mapping) -> int:
    """T: the tokens the compression makes of ``max_seq_len`` items."""
    return sum(length // g for length, g in schedule(cfg))


def raw_tail(cfg: Mapping) -> int:
    """R: the items of the newest segment when it is kept raw (0 otherwise):
    the positions the seq2seq mode supervises."""
    length, g = schedule(cfg)[-1]
    return length if g == 1 else 0


def _block(prefix: str, d: int, f: int) -> Dict[str, ParamSpec]:
    out = {}
    for n in ("q", "k", "v", "o"):
        out[f"{prefix}attn.{n}_proj.weight"] = ParamSpec((d, d), "lecun", d)
        out[f"{prefix}attn.{n}_proj.bias"] = ParamSpec((d,), "zeros")
    out[f"{prefix}attn_norm.scale"] = ParamSpec((d,), "ones")
    for n in ("gate", "up"):
        out[f"{prefix}ffn.{n}.weight"] = ParamSpec((f, d), "lecun", d)
        out[f"{prefix}ffn.{n}.bias"] = ParamSpec((f,), "zeros")
    out[f"{prefix}ffn.down.weight"] = ParamSpec((d, f), "lecun", f)
    out[f"{prefix}ffn.down.bias"] = ParamSpec((d,), "zeros")
    out[f"{prefix}ffn_norm.scale"] = ParamSpec((d,), "ones")
    return out


def param_specs(cfg: Mapping) -> Dict[str, ParamSpec]:
    """Every parameter of the tower, in its state dict's order: name ->
    shape and initial rule (N(0, 0.02) tables and query and [MASK] tokens,
    lecun-normal kernels, zero biases, unit norm scales)."""
    d, f = cfg["embed_dim"], cfg["ffn_dim"]
    out = {"query_tokens": ParamSpec((cfg["num_query_tokens"], d), "normal"),
           "mask_token": ParamSpec((d,), "normal")}
    for feat in FEATURES:
        out[table(feat)] = ParamSpec((vocab(cfg, feat), d), "normal")
    out["embed.fuse_hidden.weight"] = ParamSpec((2 * d, 5 * d), "lecun", 5 * d)
    out["embed.fuse_hidden.bias"] = ParamSpec((2 * d,), "zeros")
    out["embed.fuse_out.weight"] = ParamSpec((d, 2 * d), "lecun", 2 * d)
    out["embed.fuse_out.bias"] = ParamSpec((d,), "zeros")
    out["embed.fuse_norm.scale"] = ParamSpec((d,), "ones")
    for i, (_, g) in enumerate(schedule(cfg)):
        if g > 1:
            for j in range(cfg["compression_layers"]):
                out.update(_block(f"compress.segment_{i}.layers.{j}.", d, f))
    for i in range(cfg["num_layers"]):
        out.update(_block(f"blocks.{i}.", d, f))
    out["final_norm.scale"] = ParamSpec((d,), "ones")
    return out
