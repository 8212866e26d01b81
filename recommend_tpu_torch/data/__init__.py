"""Host-side data: seeded synthetic data, the statistical replicas, the
open-dataset loaders, the batch pipelines (numpy, or the native C++
batcher) and the negative sampler, as the JAX package's ``data/``."""

from recommend_tpu_torch.data.synthetic import (
    SyntheticRetrievalData,
    SyntheticRankingData,
    make_retrieval_data,
    make_ranking_data,
)
from recommend_tpu_torch.data.sampler import NegativeSampler
from recommend_tpu_torch.data.pipeline import (
    retrieval_batches,
    ranking_batches,
)
