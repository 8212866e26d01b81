from recommend_tpu_torch.parallel.mesh import Mesh, make_mesh, multihost_init
from recommend_tpu_torch.parallel.sharding import (
    batch_sharding,
    gather_params,
    param_shardings,
    shard_batch,
    shard_params,
)
from recommend_tpu_torch.parallel.embedding_sharding import (
    shard_table,
    shard_table_column,
    sharded_lookup,
    sharded_lookup_a2a,
    sharded_lookup_column,
)
