"""Ranking parameters: conversion from the flax tree, and a seeded initializer.

``params_from_flax`` maps the JAX package's ``RankingModel`` parameter tree
(nested dicts of numpy arrays, the ``params`` collection) to this package's
``RankingModel`` state dict. Flax ``Dense`` kernels are [in, out] and
``DenseGeneral`` kernels [d, h, dh] or [h, dh, d]; ``nn.Linear`` weights are
[out, in], so those are flattened and transposed. The dedicated NS stacks,
norm scales, tables and [SEP] token keep their layout.

``init_params`` draws a fresh state dict from a ``torch.Generator`` where no
JAX is at hand: lecun-normal projections, normal(0.02) tables and [SEP],
zero biases, unit norm scales, and the configured constant head bias. It
initializes ``DINRankingModel`` by the same rules (``model=``), and
``din_params_from_flax`` converts the JAX package's DIN tree.

The retrieval tower has its pair: ``retrieval_params_from_flax`` maps the
JAX package's ``RetrievalTower`` tree (flax ``DenseGeneral`` q/k/v kernels
[D, H, Dh] and output kernels [H, Dh, D] flattened as above), and
``init_retrieval_params`` draws one on the device.

The trainer's state carries across too: ``params_from_flax`` maps the
parameters, ``accums_from_flax`` the sparse-update accumulators (keyed by
the flax table names ``embed_<feature>`` / ``embed_seq_item`` there, by the
port's table parameter names here). The dense optimizer's moments start at
zero on both sides, so the two trainers start from one state. The retrieval
trainer's whole state carries over: ``retrieval_opt_state_from_flax`` maps
its optax adamw moments and count and its sparse accumulators, so a JAX run
continues in the port.

A mesh run's state starts from the same full tensors: a JAX mesh-sharded
array is whole under ``np.asarray``, so these converters take a JAX mesh
run's trees as they take a single-device run's, and each rank keeps its
blocks in ``init_state`` of a trainer given the ``mesh`` (which calls
``parallel.shard_params``; optimizer state and accumulators by name, as
``parallel.sharding.shard_state``).

The LLM4Rec semantic-distillation student has its pair too:
``semantic_distill_params_from_flax`` maps the JAX package's
``SemanticDistillModel`` tree, and ``init_semantic_distill_params`` draws
one as flax does.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from recommend_tpu_torch._device import resolve_device
from recommend_tpu_torch.config import RankingConfig, RetrievalConfig
from recommend_tpu_torch.llm4rec.semantic_distill import (
    SemanticDistillConfig,
    SemanticDistillModel,
)
from recommend_tpu_torch.models.ranking import RankingModel
from recommend_tpu_torch.models.retrieval import RetrievalTower

_BLOCK_STACKS = ("q_ns", "k_ns", "v_ns", "ffn_ns_in", "ffn_ns_in_b",
                 "ffn_ns_out", "ffn_ns_out_b")


def table_param_names(cfg: RankingConfig) -> Tuple[str, ...]:
    """The id tables' state-dict names: one per non-sequence feature, then
    the shared item table when the config has behavior sequences."""
    names = tuple(f"tokenizer.embeds.{f}.weight" for f in cfg.non_seq_features)
    return names + (("tokenizer.item_embed.weight",) if cfg.sequence_features else ())


def _flax_table_key(name: str) -> str:
    if name == "tokenizer.item_embed.weight":
        return "embed_seq_item"
    return "embed_" + name.split(".")[2]


def accums_from_flax(accums: Mapping, cfg: RankingConfig) -> Dict[str, torch.Tensor]:
    """The JAX trainer's sparse-update accumulators (``opt_state[1]``, keyed
    ``embed_<feature>`` / ``embed_seq_item``) -> the port trainer's, keyed by
    table parameter name."""
    return {name: _t(accums[_flax_table_key(name)]) for name in table_param_names(cfg)}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _linear(prefix: str, p: Mapping, sd: Dict[str, torch.Tensor]) -> None:
    """A flax Dense/DenseGeneral {kernel, bias}: the bias has the output
    shape and the kernel is [*inputs, *outputs] ([d, h, dh] for q/k/v_s,
    [h, dh, d] for o_proj), so flattening to [inputs, outputs] and
    transposing gives the ``nn.Linear`` weight."""
    kernel, bias = np.asarray(p["kernel"]), np.asarray(p["bias"])
    sd[f"{prefix}.weight"] = _t(kernel.reshape(-1, bias.size).T)
    sd[f"{prefix}.bias"] = _t(bias.reshape(-1))


def params_from_flax(tree: Mapping, cfg: RankingConfig) -> Dict[str, torch.Tensor]:
    """Flax ``RankingModel`` params (with or without the outer ``params``
    key) -> a state dict for ``RankingModel(cfg)``.

    Flax creates a submodule's parameters only when the initializing forward
    calls it, so a block whose kept S window was empty there has no
    ``q_s``/``ffn_s_*``. Those entries are filled with NaN: the same forward
    never reads them, and any forward that did would show it.
    """
    tree = tree.get("params", tree)
    sd: Dict[str, torch.Tensor] = {}
    tok = tree["tokenizer"]
    for f in cfg.non_seq_features:
        sd[f"tokenizer.embeds.{f}.weight"] = _t(tok[f"embed_{f}"]["embedding"])
    _linear("tokenizer.ns_proj", tok["ns_proj"], sd)
    if cfg.sequence_features:
        sd["tokenizer.item_embed.weight"] = _t(tok["embed_seq_item"]["embedding"])
        _linear("tokenizer.seq_proj", tok["seq_proj"], sd)
        sd["tokenizer.sep_token"] = _t(tok["sep_token"])
    for i in range(cfg.num_layers):
        blk = tree[f"block_{i}"]
        pre = f"blocks.{i}"
        for norm in ("attn_norm", "ffn_norm"):
            sd[f"{pre}.{norm}.scale"] = _t(blk[norm]["scale"])
        for name in ("q_s", "k_s", "v_s", "o_proj", "ffn_s_in", "ffn_s_out"):
            if name in blk:
                _linear(f"{pre}.{name}", blk[name], sd)
        for name in _BLOCK_STACKS:
            sd[f"{pre}.{name}"] = _t(blk[name])
    sd["final_norm.scale"] = _t(tree["final_norm"]["scale"])
    for t in cfg.tasks:
        _linear(f"heads.{t}.hidden", tree[f"head_{t}_hidden"], sd)
        _linear(f"heads.{t}.out", tree[f"head_{t}_out"], sd)

    with torch.device("meta"):
        shapes = RankingModel(cfg).state_dict()
    unknown = set(sd) - set(shapes)
    if unknown:
        raise KeyError(f"converted names the model does not have: {sorted(unknown)}")
    for name, ref in shapes.items():
        if name not in sd:
            sd[name] = torch.full(ref.shape, float("nan"), dtype=ref.dtype)
        elif sd[name].shape != ref.shape:
            raise ValueError(f"{name}: converted {tuple(sd[name].shape)}, "
                             f"model {tuple(ref.shape)}")
    return sd


def din_params_from_flax(tree: Mapping, cfg: RankingConfig) -> Dict[str, torch.Tensor]:
    """Flax ``DINRankingModel`` params -> a state dict for the port's
    ``DINRankingModel(cfg)``. The flax tokenizer's ``sep_token``, which DIN
    never reads, has no counterpart."""
    from recommend_tpu_torch.models.din import DINRankingModel

    tree = tree.get("params", tree)
    tok = tree["tokenizer"]
    sd: Dict[str, torch.Tensor] = {}
    for f in cfg.non_seq_features:
        sd[f"tokenizer.embeds.{f}.weight"] = _t(tok[f"embed_{f}"]["embedding"])
    if cfg.sequence_features:
        sd["tokenizer.item_embed.weight"] = _t(tok["embed_seq_item"]["embedding"])
        _linear("tokenizer.seq_proj", tok["seq_proj"], sd)
    _linear("query_proj", tree["query_proj"], sd)
    _linear("attn_hidden", tree["attn_hidden"], sd)
    _linear("attn_out", tree["attn_out"], sd)
    for name, sub in tree.items():
        for flax_prefix, port_prefix in (("cross_w_", "cross"), ("deep_", "deep")):
            if name.startswith(flax_prefix):
                _linear(f"{port_prefix}.{name[len(flax_prefix):]}", sub, sd)
    for t in cfg.tasks:
        _linear(f"heads.{t}.hidden", tree[f"head_{t}_hidden"], sd)
        _linear(f"heads.{t}.out", tree[f"head_{t}_out"], sd)
    with torch.device("meta"):
        shapes = {n: p.shape for n, p in DINRankingModel(cfg).named_parameters()}
    if set(sd) != set(shapes):
        raise KeyError(f"converted {sorted(set(sd) - set(shapes))} not in the model, "
                       f"model {sorted(set(shapes) - set(sd))} not converted")
    for name, shape in shapes.items():
        if sd[name].shape != shape:
            raise ValueError(f"{name}: converted {tuple(sd[name].shape)}, "
                             f"model {tuple(shape)}")
    return sd


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    # flax lecun_normal: truncated normal at +-2 std, variance 1/fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    torch.nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)


@torch.no_grad()
def init_params(cfg: RankingConfig, seed: int = 0, device=None,
                model: Optional[torch.nn.Module] = None) -> Dict[str, torch.Tensor]:
    """A fresh state dict for ``model`` (``RankingModel(cfg)`` by default;
    e.g. ``DINRankingModel(cfg)``, whose layers follow the same rules),
    drawn on ``device`` from a ``torch.Generator`` seeded with ``seed``.
    Only the model's parameter names and shapes are read, so it may sit on
    the meta device. ``device`` is CUDA unless the caller names another;
    with none named and no CUDA available it raises."""
    device = resolve_device(device, "init_params")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if model is None:
        with torch.device("meta"):
            model = RankingModel(cfg)
    bias0 = cfg.task_logit_bias_init or (0.0,) * len(cfg.tasks)
    head_bias = {f"heads.{t}.out.bias": b0 for t, b0 in zip(cfg.tasks, bias0)}
    out: Dict[str, torch.Tensor] = {}
    for name, ref in model.named_parameters():
        p = torch.empty(ref.shape, dtype=ref.dtype, device=device)
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith("norm.scale"):
            p.fill_(1.0)
        elif name in head_bias:
            p.fill_(head_bias[name])
        elif leaf in ("bias", "ffn_ns_in_b", "ffn_ns_out_b"):
            p.zero_()
        elif name.startswith("tokenizer.") and (
                leaf == "sep_token" or ".embeds." in name or "item_embed" in name):
            p.normal_(0.0, 0.02, generator=gen)
        else:  # nn.Linear [out, in] and the NS stacks [n, in, out]
            _lecun_normal_(p, p.shape[1], gen)
        out[name] = p
    return out


def _check_against(sd: Dict[str, torch.Tensor], model: torch.nn.Module) -> None:
    """Raise unless ``sd`` has exactly the model's names and shapes."""
    shapes = {n: t.shape for n, t in model.state_dict().items()}
    if set(sd) != set(shapes):
        raise KeyError(f"converted {sorted(set(sd) - set(shapes))} not in the model, "
                       f"model {sorted(set(shapes) - set(sd))} not converted")
    for name, shape in shapes.items():
        if sd[name].shape != shape:
            raise ValueError(f"{name}: converted {tuple(sd[name].shape)}, "
                             f"model {tuple(shape)}")


def _transformer_block(prefix: str, p: Mapping, sd: Dict[str, torch.Tensor]) -> None:
    for norm in ("attn_norm", "ffn_norm"):
        sd[f"{prefix}.{norm}.scale"] = _t(p[norm]["scale"])
    for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
        _linear(f"{prefix}.attn.{name}", p["attn"][name], sd)
    for name in ("gate", "up", "down"):
        _linear(f"{prefix}.ffn.{name}", p["ffn"][name], sd)


_RETRIEVAL_TABLES = ("video_id", "category", "tag", "duration", "timestamp")


def _retrieval_tree_to_sd(tree: Mapping, cfg: RetrievalConfig) -> Dict[str, torch.Tensor]:
    """A flax ``RetrievalTower`` tree, or one shaped like it (an optax
    moment), -> tensors under the port's names. Tables absent from the tree
    (the JAX trainer's sparse path splits the id tables out) are left out."""
    tree = tree.get("params", tree)
    sd: Dict[str, torch.Tensor] = {}
    emb = tree["embed"]
    for name in _RETRIEVAL_TABLES:
        if name in emb:
            sd[f"embed.tables.{name}.weight"] = _t(emb[name]["embedding"])
    _linear("embed.fuse_hidden", emb["fuse_hidden"], sd)
    _linear("embed.fuse_out", emb["fuse_out"], sd)
    sd["embed.fuse_norm.scale"] = _t(emb["fuse_norm"]["scale"])
    for i, spec in enumerate(cfg.schedule_specs()):
        if spec.group_size > 1:
            seg = tree["compress"][f"segment_{i}"]
            for j in range(cfg.compression_layers):
                _transformer_block(f"compress.segment_{i}.layers.{j}", seg[f"layer_{j}"], sd)
    sd["query_tokens"] = _t(tree["query_tokens"])
    sd["mask_token"] = _t(tree["mask_token"])
    for i in range(cfg.num_layers):
        _transformer_block(f"blocks.{i}", tree[f"block_{i}"], sd)
    sd["final_norm.scale"] = _t(tree["final_norm"]["scale"])
    return sd


def retrieval_params_from_flax(tree: Mapping, cfg: RetrievalConfig) -> Dict[str, torch.Tensor]:
    """Flax ``RetrievalTower`` params (with or without the outer ``params``
    key) -> a state dict for ``RetrievalTower(cfg)``. A segment kept raw
    (``group_size == 1``) has no parameters on either side."""
    sd = _retrieval_tree_to_sd(tree, cfg)
    with torch.device("meta"):
        _check_against(sd, RetrievalTower(cfg))
    return sd


def _find_adam_state(state):
    """The first node of an optax state tree with ``count``, ``mu`` and
    ``nu`` fields (optax's ``ScaleByAdamState``), or None."""
    fields = getattr(state, "_fields", None)
    if fields is not None and {"count", "mu", "nu"} <= set(fields):
        return state
    if isinstance(state, Mapping):
        children = state.values()
    elif fields is not None:
        children = [getattr(state, f) for f in fields]
    elif isinstance(state, (tuple, list)):
        children = state
    else:
        return None
    for child in children:
        found = _find_adam_state(child)
        if found is not None:
            return found
    return None


def retrieval_opt_state_from_flax(
    opt_state, cfg: RetrievalConfig,
) -> Tuple[dict, Optional[Dict[str, torch.Tensor]]]:
    """The JAX ``RetrievalTrainer``'s ``TrainState.opt_state`` (numpy
    leaves) -> (the port optimizer's state ``{"count", "mu", "nu"}``, the
    sparse-update accumulators by table parameter name, or None without
    sparse updates). With sparse updates the JAX state is ``(optax state,
    {table: accumulator})``; the adam moments are found inside the optax
    state, whatever wraps them (``multi_transform``, ``masked``)."""
    accums = None
    if cfg.use_sparse_embedding_updates:
        opt_state, jaccums = opt_state
        accums = {f"embed.tables.{k}.weight": _t(v) for k, v in jaccums.items()}
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no adam state (count, mu, nu) in the optax state")
    mu, nu = _retrieval_tree_to_sd(adam.mu, cfg), _retrieval_tree_to_sd(adam.nu, cfg)
    return {"count": int(np.asarray(adam.count)), "mu": mu, "nu": nu}, accums


@torch.no_grad()
def init_retrieval_params(cfg: RetrievalConfig, seed: int = 0,
                          device=None) -> Dict[str, torch.Tensor]:
    """A fresh state dict for ``RetrievalTower(cfg)``, drawn on ``device``
    from a ``torch.Generator`` seeded with ``seed`` (at the 10M-row video
    table a draw on the CPU would cost seconds): normal(0.02) tables, query
    and [MASK] tokens, lecun-normal dense kernels, zero biases, unit norm
    scales. ``device`` is CUDA unless the caller names another; with none
    named and no CUDA available it raises."""
    device = resolve_device(device, "init_retrieval_params")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    with torch.device("meta"):
        model = RetrievalTower(cfg)
    out: Dict[str, torch.Tensor] = {}
    for name, ref in model.named_parameters():
        p = torch.empty(ref.shape, dtype=ref.dtype, device=device)
        if name.endswith("norm.scale"):
            p.fill_(1.0)
        elif name.endswith(".bias"):
            p.zero_()
        elif name.startswith("embed.tables.") or name in ("query_tokens", "mask_token"):
            p.normal_(0.0, 0.02, generator=gen)
        else:  # nn.Linear [out, in]
            _lecun_normal_(p, p.shape[1], gen)
        out[name] = p
    return out


def semantic_distill_params_from_flax(tree: Mapping,
                                      cfg: SemanticDistillConfig) -> Dict[str, torch.Tensor]:
    """The JAX package's ``SemanticDistillModel`` tree (nested dicts of
    numpy arrays, with or without the ``params`` level) -> the state dict of
    ``SemanticDistillModel(cfg)``: flax ``Dense`` kernels [in, out] become
    ``nn.Linear`` weights [out, in]; the head stacks keep their layout."""
    p = tree.get("params", tree)
    sd: Dict[str, torch.Tensor] = {}
    for tower in ("user_tower", "item_tower"):
        for layer in ("enc1", "enc2"):
            _linear(f"{tower}.{layer}", p[tower][layer], sd)
        sd[f"{tower}.head_stack"] = _t(p[tower]["head_stack"])
    for proj in ("user_distill_proj", "item_distill_proj"):
        _linear(proj, p[proj], sd)
    with torch.device("meta"):
        _check_against(sd, SemanticDistillModel(cfg))
    return sd


@torch.no_grad()
def init_semantic_distill_params(cfg: SemanticDistillConfig, seed: int = 0,
                                 device=None) -> Dict[str, torch.Tensor]:
    """A fresh state dict for ``SemanticDistillModel(cfg)``, drawn on
    ``device`` from a ``torch.Generator`` seeded with ``seed`` as flax
    initializes the JAX model: lecun-normal kernels (the head stack's
    fan-in is num_heads x hidden, as flax counts a 3-D kernel's leading
    axis), zero biases. ``device`` is CUDA unless the caller names another;
    with none named and no CUDA available it raises."""
    device = resolve_device(device, "init_semantic_distill_params")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    with torch.device("meta"):
        model = SemanticDistillModel(cfg)
    out: Dict[str, torch.Tensor] = {}
    for name, ref in model.named_parameters():
        p = torch.empty(ref.shape, dtype=ref.dtype, device=device)
        if name.endswith(".bias"):
            p.zero_()
        elif name.endswith("head_stack"):
            _lecun_normal_(p, cfg.num_heads * cfg.hidden_dim, gen)
        else:  # nn.Linear [out, in]
            _lecun_normal_(p, p.shape[1], gen)
        out[name] = p
    return out
