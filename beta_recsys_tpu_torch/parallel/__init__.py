"""Device meshes, placement rules, sharded embeddings and the mesh train
step (counterpart of ``beta_recsys_tpu/parallel/``)."""

from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, make_mesh
from .sharding import (
    REPLICATED,
    ROW_SHARDED,
    default_param_rule,
    make_sharded_train_step,
    pad_to_multiple,
    shard_batch,
    shard_params,
)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "REPLICATED", "ROW_SHARDED", "default_param_rule",
           "make_mesh", "make_sharded_train_step", "pad_to_multiple", "shard_batch", "shard_params"]
