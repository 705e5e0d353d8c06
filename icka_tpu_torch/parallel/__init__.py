from icka_tpu_torch.parallel.partitioning import (
    param_partition_specs,
    shard_params,
    shard_train_state,
    zero1_moment_specs,
)

__all__ = ["param_partition_specs", "shard_params", "shard_train_state",
           "zero1_moment_specs"]
