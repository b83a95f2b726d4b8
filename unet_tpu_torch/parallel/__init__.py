"""Mesh runtime of the port (counterpart of unet_tpu/parallel): data
parallelism over torch.distributed, one process per device, and the
spatial axis, H stripes of the model (`spatial`)."""
from unet_tpu_torch.parallel import multihost, spatial  # noqa: F401
from unet_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, SPATIAL_AXIS, Mesh, make_mesh, mesh_device, over, all_sum,
    shard_train_step, shard_eval_step, shard_pipeline_step, put_batch)
