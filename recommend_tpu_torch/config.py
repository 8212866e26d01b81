"""Configuration: the ranking and retrieval dataclasses, their JSON
round-trip and presets.

A copy of the JAX package's ``config.py``. The port keeps its own copy
instead of importing it, so that it runs where JAX does not; the tests hold
the two field for field (``to_dict``). ``save_config`` and ``load_config``
write and read the same plain JSON as the JAX package's, so a
``config.json`` that the JAX trainer wrote beside its checkpoints loads here.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple


def _asdict(cfg) -> Dict[str, Any]:
    d = dataclasses.asdict(cfg)
    d["__config_class__"] = type(cfg).__name__
    return d


def _fromdict(cls, d: Dict[str, Any]):
    d = dict(d)
    d.pop("__config_class__", None)
    names = {f.name for f in dataclasses.fields(cls)}
    known = {k: v for k, v in d.items() if k in names}
    # tuple-ify list-typed fields that were serialized as JSON arrays
    for f in dataclasses.fields(cls):
        if f.name in known and isinstance(known[f.name], list):
            known[f.name] = tuple(
                tuple(v) if isinstance(v, list) else v for v in known[f.name]
            )
    return cls(**known)


@dataclass(frozen=True)
class CompressionGroupSpec:
    """One segment of the adaptive item-compression schedule: ``length``
    items split into groups of ``group_size``, each group compressed to one
    token unless ``group_size == 1`` (kept raw)."""

    length: int
    group_size: int

    @property
    def num_tokens(self) -> int:
        assert self.length % self.group_size == 0
        return self.length // self.group_size


@dataclass(frozen=True)
class RetrievalConfig:
    """KuaiFormer-capability retrieval tower config (kuaiformer config.py:9-59)."""

    # architecture
    embed_dim: int = 128
    num_layers: int = 6
    num_heads: int = 8
    ffn_dim: int = 512
    max_seq_len: int = 256
    num_query_tokens: int = 4
    dropout_rate: float = 0.1
    use_causal_mask: bool = False  # bidirectional single-prediction by default

    # adaptive compression schedule: 256 = 128(->2x64) + 80(->5x16) + 48 raw,
    # 55 output tokens
    compression_schedule: Tuple[Tuple[int, int], ...] = ((128, 64), (80, 16), (48, 1))
    compression_layers: int = 1  # depth of the per-group bidirectional encoder

    # feature vocabularies
    video_vocab_size: int = 10_000_000
    category_vocab_size: int = 10_000
    tag_vocab_size: int = 50_000
    duration_buckets: int = 1000
    max_duration_s: float = 300.0
    time_buckets: int = 1000

    # training (used by the trainer, kept so the configs round-trip)
    learning_rate: float = 1e-3
    weight_decay: float = 0.01
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    warmup_steps: int = 10_000
    label_smoothing: float = 0.1
    batch_size: int = 256
    use_logq_correction: bool = True

    # inference
    top_k: int = 1000

    # system flags
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    use_remat: bool = False
    use_flash_attention: bool = False  # read by the ranking model only
    # touched-row-only updates for the big id tables (video/category/tag)
    use_sparse_embedding_updates: bool = False
    sparse_embedding_lr: float = 0.05
    # "exact" (dedup + per-coordinate adagrad) or "rowwise" (one
    # accumulator scalar per row)
    sparse_update_mode: str = "exact"
    # >0: compact history-grad rows to this static budget before the sparse
    # scatter; overflow rows are dropped and counted
    sparse_scatter_budget: int = 0

    def schedule_specs(self) -> List[CompressionGroupSpec]:
        return [CompressionGroupSpec(l, g) for l, g in self.compression_schedule]

    @property
    def num_compressed_tokens(self) -> int:
        return sum(s.num_tokens for s in self.schedule_specs())

    def __post_init__(self):
        assert sum(l for l, _ in self.compression_schedule) == self.max_seq_len, (
            "compression schedule must cover max_seq_len exactly"
        )
        assert self.sparse_update_mode in ("exact", "rowwise"), (
            self.sparse_update_mode
        )
        assert self.embed_dim % self.num_heads == 0

    to_dict = _asdict

    @classmethod
    def from_dict(cls, d):
        return _fromdict(cls, d)


@dataclass(frozen=True)
class RankingConfig:
    """OneTrans-capability ranking stack config (oneTrans config.py:9-117)."""

    # architecture
    embed_dim: int = 384
    num_layers: int = 8
    num_heads: int = 4
    ffn_dim: int = 1536
    max_seq_len: int = 2048
    num_ns_tokens: int = 12
    dropout_rate: float = 0.1

    # pyramid token-pruning keep ratios, one per layer (tail queries over
    # full K/V)
    pyramid_ratios: Tuple[float, ...] = (0.5, 0.3, 0.2, 0.1, 0.05, 0.03, 0.02, 0.01)

    # feature groups
    user_features: Tuple[str, ...] = ("user_id", "age_bucket", "gender", "city")
    item_features: Tuple[str, ...] = ("item_id", "category", "brand", "price_bucket")
    context_features: Tuple[str, ...] = ("hour", "weekday", "device")
    sequence_features: Tuple[str, ...] = ("click_seq", "cart_seq", "purchase_seq")
    feature_vocab_sizes: Tuple[Tuple[str, int], ...] = (
        ("user_id", 1_000_000),
        ("age_bucket", 16),
        ("gender", 4),
        ("city", 1024),
        ("item_id", 1_000_000),
        ("category", 10_000),
        ("brand", 100_000),
        ("price_bucket", 64),
        ("hour", 24),
        ("weekday", 7),
        ("device", 8),
    )
    feature_embed_dim: int = 64  # raw per-feature embedding before tokenizer
    seq_item_feature_dim: int = 64  # per-item input feature width for S-tokens

    # tasks
    tasks: Tuple[str, ...] = ("ctr", "cvr")
    task_head_hidden: int = 128
    # per-task output-bias init (same order as `tasks`), e.g. the label-prior
    # logit log(p/(1-p))
    task_logit_bias_init: Optional[Tuple[float, ...]] = None

    # precomputed dense side-features fed into the NS tokenizer, (name, dim)
    semantic_features: Tuple[Tuple[str, int], ...] = ()

    # dual optimizer (used by training, kept so the configs round-trip)
    dense_optimizer: str = "rmsprop"  # rmsprop | adam | adamw
    dense_weight_decay: float = 1e-4
    dense_lr: float = 0.005
    dense_lr_schedule: str = "constant"
    lr_warmup_steps: int = 0
    dense_momentum: float = 0.99999
    sparse_optimizer: str = "adagrad"
    sparse_lr: float = 0.1
    sparse_lr_init: float = 0.0
    sparse_lr_warmup_steps: int = 0
    gradient_clip_norm: float = 90.0
    batch_size: int = 256

    # system flags. use_kv_cache gates the serving engine's S-trunk KV cache
    # (on: S side encoded once per request, NS-only per candidate; off: full
    # forward per candidate batch).
    use_mixed_precision: bool = True
    use_kv_cache: bool = True
    use_flash_attention: bool = False
    use_remat: bool = False
    use_sparse_embedding_updates: bool = False
    sparse_update_mode: str = "exact"
    sparse_scatter_budget: int = 0
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # storage dtype of the big id-embedding tables
    embedding_table_dtype: str = "float32"

    def __post_init__(self):
        assert len(self.pyramid_ratios) == self.num_layers, (
            "one pyramid keep-ratio per layer"
        )
        assert self.embed_dim % self.num_heads == 0
        assert self.sparse_update_mode in ("exact", "rowwise"), (
            self.sparse_update_mode
        )

    def vocab_size(self, feature: str) -> int:
        return dict(self.feature_vocab_sizes)[feature]

    @property
    def active_compute_dtype(self) -> str:
        """compute_dtype when mixed precision is on, else float32."""
        return self.compute_dtype if self.use_mixed_precision else "float32"

    @property
    def non_seq_features(self) -> Tuple[str, ...]:
        return self.user_features + self.item_features + self.context_features

    to_dict = _asdict

    @classmethod
    def from_dict(cls, d):
        return _fromdict(cls, d)


def retrieval_base() -> RetrievalConfig:
    return RetrievalConfig()


def retrieval_flagship() -> RetrievalConfig:
    """The production-scale config: a 10M-video vocabulary, 256-item
    sequences compressed to 55 tokens, touched-row sparse updates with a
    16,384-row scatter budget."""
    return RetrievalConfig(
        use_sparse_embedding_updates=True,
        sparse_update_mode="rowwise",
        sparse_scatter_budget=16_384,
        use_flash_attention=False,
    )


def retrieval_small() -> RetrievalConfig:
    return RetrievalConfig(
        embed_dim=64,
        num_layers=2,
        num_heads=4,
        ffn_dim=128,
        max_seq_len=64,
        compression_schedule=((32, 16), (16, 8), (16, 1)),
        video_vocab_size=10_000,
        category_vocab_size=100,
        tag_vocab_size=500,
        warmup_steps=100,
        batch_size=64,
        top_k=100,
    )


def ranking_base() -> RankingConfig:
    return RankingConfig()


def ranking_small() -> RankingConfig:
    # mirrors OneTransSmallConfig (oneTrans config.py:85-95)
    return RankingConfig(
        embed_dim=128,
        num_layers=4,
        num_heads=4,
        ffn_dim=512,
        max_seq_len=256,
        num_ns_tokens=8,
        pyramid_ratios=(0.5, 0.25, 0.12, 0.05),
        feature_vocab_sizes=(
            ("user_id", 100_000),
            ("age_bucket", 16),
            ("gender", 4),
            ("city", 1024),
            ("item_id", 100_000),
            ("category", 1000),
            ("brand", 10_000),
            ("price_bucket", 64),
            ("hour", 24),
            ("weekday", 7),
            ("device", 8),
        ),
    )


def ranking_large() -> RankingConfig:
    # mirrors OneTransLargeConfig (oneTrans config.py:97-104): deeper/wider
    return RankingConfig(
        embed_dim=512,
        num_layers=12,
        num_heads=8,
        ffn_dim=2048,
        pyramid_ratios=(
            0.6, 0.45, 0.3, 0.2, 0.12, 0.08, 0.05, 0.03, 0.02, 0.015, 0.01, 0.01,
        ),
    )


_PRESETS = {
    "retrieval_base": retrieval_base,
    "retrieval_flagship": retrieval_flagship,
    "retrieval_small": retrieval_small,
    "ranking_base": ranking_base,
    "ranking_small": ranking_small,
    "ranking_large": ranking_large,
}


def get_config(name: str, **overrides):
    """Named preset registry with attribute overrides."""
    if name not in _PRESETS:
        raise KeyError(f"unknown config preset {name!r}; have {sorted(_PRESETS)}")
    cfg = _PRESETS[name]()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def save_config(cfg, path: str) -> None:
    with open(path, "w") as f:
        json.dump(cfg.to_dict(), f, indent=2)


def load_config(path: str):
    """The config a ``save_config`` (here or in the JAX package) wrote,
    rebuilt from the class its ``__config_class__`` names."""
    with open(path) as f:
        d = json.load(f)
    name = d.get("__config_class__")
    classes = {"RetrievalConfig": RetrievalConfig, "RankingConfig": RankingConfig}
    if name not in classes:
        raise ValueError(f"{path}: unknown __config_class__ {name!r}")
    return classes[name].from_dict(d)
