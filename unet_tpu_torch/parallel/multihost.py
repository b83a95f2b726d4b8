"""Process start-up, per-process data slices and the upload of a local slice
(counterpart of unet_tpu/parallel/multihost.py:29-117).

One process drives one device, as `torchrun` launches them:

    torchrun --nproc-per-node N -m unet_tpu_torch.cli train ...

Every process runs the same program and loads only its contiguous 1/W
slice of each global batch (`ProcessShardedLoader`); the data axis of the
mesh (`mesh.make_mesh`) then all-reduces what the global batch shares:

    from unet_tpu_torch import parallel
    parallel.multihost.initialize()          # no-op in one process
    mesh = parallel.make_mesh()              # all processes on the data axis
    loader = parallel.multihost.ProcessShardedLoader(base_loader)
    for images, labels in loader:            # this process's (B/W, ...) slice
        im, lb = parallel.put_batch(mesh, images, labels)
        state, metrics = sharded_train_step(state, im, lb)
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

_LAUNCHER_VARS = ("WORLD_SIZE", "RANK")


def launched() -> bool:
    """Whether a launcher (torchrun) set this process's rank and world size."""
    return all(v in os.environ for v in _LAUNCHER_VARS)


def local_rank() -> int:
    """The device index of this process on its node (torchrun's LOCAL_RANK)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: str = "nccl") -> Tuple[int, int]:
    """Start the default process group, from the arguments or from torchrun's
    MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK.

    * `coordinator_address` is "host:port" (a TCP store on that port) or an
      init method URL ("tcp://...", "file://...")
    * one process with nothing configured, or a group that already exists:
      a no-op (`mesh.make_mesh` then starts a one-rank group itself)

    Returns (rank, world size)."""
    if not dist.is_initialized():
        world = num_processes if num_processes is not None else (
            int(os.environ["WORLD_SIZE"]) if launched() else None)
        if coordinator_address or world is not None:
            rank = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
            if coordinator_address is None:
                method = "env://"
            elif "://" in coordinator_address:
                method = coordinator_address
            else:
                method = f"tcp://{coordinator_address}"
            dist.init_process_group(backend, init_method=method, world_size=world, rank=rank)
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


class ProcessShardedLoader:
    """Wraps a data.Loader so each process yields its contiguous 1/P slice of
    every GLOBAL batch. The index stream is identical on every process (the
    base loader's rng is seed-deterministic), so slice p of batch k holds the
    same samples everywhere; each process only pays decode and augment cost
    for its own slice via dataset indexing. A loader `with_indices` yields
    the slice's indices first, as it does.

    The base loader's batch_size is the GLOBAL batch; it must be divisible by
    process_count. Ragged final batches are dropped (shards must stay equal).

    A dataset whose augmentation draws from one generator in load order
    draws differently here than in one process, which loads every sample:
    runs over W processes equal the one-process run only with augmentation
    off (the JAX package's semantics too).
    """

    def __init__(self, loader, process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        on = dist.is_initialized()
        self.loader = loader
        self.pid = (dist.get_rank() if on else 0) if process_index is None else process_index
        self.pcount = (dist.get_world_size() if on else 1) if process_count is None \
            else process_count
        if loader.batch_size % self.pcount:
            raise ValueError(
                f"global batch {loader.batch_size} not divisible by "
                f"{self.pcount} processes")
        self.batch_size = loader.batch_size  # global, for schedule sizing
        self.local_batch = loader.batch_size // self.pcount
        self.dataset = getattr(loader, "dataset", None)
        self.rng = getattr(loader, "rng", None)

    def __len__(self):
        n = len(self.loader.dataset)
        return n // self.loader.batch_size  # drop_last semantics

    def __iter__(self):
        k = self.local_batch
        # replicate the base loader's index stream WITHOUT loading samples:
        # same rng consumption as Loader._indices on every process
        ld = self.loader
        idx = ld._indices()
        for s in range(0, len(idx), ld.batch_size):
            chunk = idx[s:s + ld.batch_size]
            if len(chunk) < ld.batch_size:
                return
            mine = chunk[self.pid * k:(self.pid + 1) * k]
            imgs, masks = zip(*(ld.dataset[int(i)] for i in mine))
            if getattr(ld, "with_indices", False):
                yield mine.copy(), np.stack(imgs), np.stack(masks)
            else:
                yield np.stack(imgs), np.stack(masks)


def _upload(x, device: torch.device) -> torch.Tensor:
    t = torch.as_tensor(np.ascontiguousarray(x) if isinstance(x, np.ndarray) else x)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def global_put_batch(mesh, images, labels=None):
    """This process's block of the batch on its device, as it is (its data
    slice, and with `mesh.put_batch(spatial=True)` its H stripe): with one
    process per device, the blocks of all processes make the global batch
    without a copy between them."""
    im = _upload(images, mesh.device)
    return im if labels is None else (im, _upload(labels, mesh.device))
