"""Mesh runtime of the port (counterpart of unet_tpu/parallel): data
parallelism over torch.distributed, one process per device; the spatial
axis is ROADMAP A15c."""
from unet_tpu_torch.parallel import multihost  # noqa: F401
from unet_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, SPATIAL_AXIS, Mesh, make_mesh, over, all_sum,
    shard_train_step, shard_eval_step, shard_pipeline_step, put_batch)
