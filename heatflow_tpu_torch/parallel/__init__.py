"""Multi-device execution over ``torch.distributed`` (the twin of
``heatflow_tpu/parallel``): the ('config', 'z') mesh, config-sharded sweeps,
z-sharded problems, multi-process sweeps and the multi-device dry run."""

from heatflow_tpu_torch.parallel.sharding import (DeviceMesh,
                                                  batch_step_sharded,
                                                  config_mesh, shard_batch,
                                                  spawn)

__all__ = ["DeviceMesh", "config_mesh", "shard_batch", "batch_step_sharded",
           "spawn"]
