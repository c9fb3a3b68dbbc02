"""Multi-device training and serving over ``torch.distributed`` ranks: port
of ``composer_tpu/parallel``. See ``mesh.py``; ``launch.py`` starts the
ranks of one host."""

from composer_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    LOGICAL_AXIS_RULES,
    MODEL_AXIS,
    Mesh,
    copy_to_model,
    create_mesh,
    gather_params,
    gather_rows,
    initialize_multihost,
    local_rows,
    reduce_from_model,
    shard_params,
)

__all__ = ["DATA_AXIS", "LOGICAL_AXIS_RULES", "MODEL_AXIS", "Mesh", "copy_to_model",
           "create_mesh", "gather_params", "gather_rows", "initialize_multihost",
           "local_rows", "reduce_from_model", "shard_params"]
