"""PyTorch/CUDA port of recommend_tpu for NVIDIA Hopper (H100).

The JAX package ``recommend_tpu`` is the reference; this package imports
nothing of it. Ported so far: ranking serving (config, tokenizer, ranking
model with its KV-cache decomposition, the inference engine with its
checkpoint loading, hot reload and incremental parameter push), ranking
training (data, sparse embedding updates, loss, optimizer, metrics,
checkpoints, ``training.ranking_trainer.RankingTrainer``), the DCNv2+DIN
baseline, offline evaluation, the band-attention kernels (four forwards in
``csrc/band_attention.cu`` and five backwards in
``csrc/band_attention_bwd.cu``), and retrieval serving: the
``models.retrieval.RetrievalTower``, its flat / int8 / IVF index and
real-time recommender (``serving.retrieval_service``) and its evaluator
(``evaluation.retrieval_eval``).
"""

from recommend_tpu_torch.config import RankingConfig, RetrievalConfig, get_config

__all__ = ["RankingConfig", "RetrievalConfig", "get_config"]
