"""PyTorch/CUDA port of recommend_tpu for NVIDIA Hopper (H100).

The JAX package ``recommend_tpu`` is the reference; this package imports
nothing of it. Ported so far: ranking serving (config, tokenizer, ranking
model with its KV-cache decomposition, the inference engine), ranking
training (data, sparse embedding updates, loss, optimizer, streaming AUC,
``training.ranking_trainer.RankingTrainer``), and the band-attention
kernels: four forwards in ``csrc/band_attention.cu`` and four backwards in
``csrc/band_attention_bwd.cu``.
"""

from recommend_tpu_torch.config import RankingConfig, get_config

__all__ = ["RankingConfig", "get_config"]
