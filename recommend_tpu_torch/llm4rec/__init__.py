"""LLM4Rec: semantic distillation, semantic ids, the intent cache and its
prompts (the port of the JAX package's ``llm4rec/``)."""

from recommend_tpu_torch.llm4rec.semantic_distill import (
    SemanticDistillConfig,
    SemanticDistillModel,
    semantic_distill_loss,
)
from recommend_tpu_torch.llm4rec.intent_cache import IntentCache
from recommend_tpu_torch.llm4rec.prompts import (
    INTENT_AXES,
    IntentPromptGenerator,
    PromptSpec,
    intent_specs,
)
from recommend_tpu_torch.llm4rec.semantic_ids import (
    SemanticIdMap,
    build_semantic_ids,
    remap_retrieval_data,
)
