"""The device mesh of the port: data parallelism over torch.distributed
(counterpart of unet_tpu/parallel/mesh.py:30-99).

One process drives one device (`cuda:{LOCAL_RANK}`, or the CPU), as
`torchrun` launches them; the mesh is a `DeviceMesh` of shape (n_data,
n_spatial) named (`data`, `spatial`) over NCCL for CUDA tensors and gloo
for CPU ones. `make_mesh()` in a process without a group or a launcher
starts a one-rank group itself (an in-memory store, no network port), so
one device runs the same code as W of them, collectives included.

The JAX package jits its steps over a mesh and GSPMD gives them the
semantics of the global batch. Here each rank runs its slice and the
steps reduce explicitly what the global batch shares, so that a run over W
ranks equals the one-device run on the same global batch:
  * train-mode BatchNorm: the per-channel sums of x and x^2 are all-reduced
    (models.blocks.BatchNorm2d), with autograd through the reduction
  * every loss ratio whose terms sum over the batch: its partial sums
    (models.losses)
  * the gradients: averaged before accumulation, clipping and the update
    (train.trainer), so that the clip and `grad_norm` read the global one
  * the eval's confusion matrix: summed
  * the inspection step: each rank runs its contiguous slice and the
    outputs are all-gathered (`shard_pipeline_step`)
The steps find the mesh through `over(mesh)`, which the `shard_*` wrappers
enter; outside one, `all_sum` is the identity in the same autograd graph,
so the one-rank step and the step without a mesh compute the same thing.

The spatial axis (H sharding with halo exchanges in every conv, pool,
resize and B1's fixpoint) is ROADMAP A15c: `n_spatial > 1` and
`spatial=True` raise.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from unet_tpu_torch.parallel import multihost

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
_A15C = "spatial sharding is not ported to unet_tpu_torch yet, ROADMAP A15c"


def refuse_spatial(spatial: bool) -> None:
    if spatial:
        raise NotImplementedError(f"spatial=True: {_A15C}")


@dataclass(frozen=True, eq=False)
class Mesh:
    """A `DeviceMesh` of shape (n_data, n_spatial) over `ranks` and this
    process's device. A process outside `ranks` (`member` False) holds no
    part of it."""
    device_mesh: Optional["torch.distributed.device_mesh.DeviceMesh"]
    device: torch.device
    ranks: Tuple[int, ...]
    shape: Tuple[int, int]

    @property
    def member(self) -> bool:
        return dist.get_rank() in self.ranks

    @property
    def group(self):
        """The process group of the data axis."""
        return self.device_mesh.get_group(DATA_AXIS)

    @property
    def size(self) -> int:
        """n_data: the ranks over which the batch is split."""
        return self.shape[0]

    @property
    def rank(self) -> int:
        """This process's index on the data axis."""
        return self.ranks.index(dist.get_rank())


_own_group = False


def _ensure_group(device_type: str) -> None:
    """The default group: torchrun's (multihost.initialize), else a
    one-rank group of this process's own."""
    global _own_group
    backend = "cpu:gloo,cuda:nccl" if device_type == "cuda" else "gloo"
    multihost.initialize(backend=backend)
    if dist.is_initialized() and _own_group and device_type == "cuda" \
            and "nccl" not in dist.get_backend():
        dist.destroy_process_group()   # our one-rank CPU group cannot carry CUDA tensors
    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        _own_group = True


def make_mesh(n_data: Optional[int] = None, n_spatial: int = 1,
              devices: Optional[Sequence[int]] = None,
              device: Optional[str] = None) -> Mesh:
    """(data, spatial) mesh over the global ranks `devices` (all of them by
    default, all on the data axis) with this process's device: `device`
    "cuda" (the card `cuda:{LOCAL_RANK}`, the default unless a CPU-only
    group exists) or "cpu". A "cuda" mesh without a card raises; so does a
    shape that does not cover `devices`, and `n_spatial > 1` (A15c)."""
    if n_spatial != 1:
        raise NotImplementedError(f"n_spatial={n_spatial}: {_A15C}")
    if device is None:
        device = "cuda" if not dist.is_initialized() or "nccl" in dist.get_backend() else "cpu"
    device_type = torch.device(device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device='cuda') needs a CUDA device")
    _ensure_group(device_type)
    ranks = tuple(int(r) for r in (devices if devices is not None
                                   else range(dist.get_world_size())))
    if n_data is None:
        n_data = len(ranks) // n_spatial
    if n_data * n_spatial != len(ranks):
        raise ValueError(f"{n_data}x{n_spatial} mesh != {len(ranks)} ranks")
    from torch.distributed.device_mesh import DeviceMesh

    dm = DeviceMesh(device_type, torch.tensor(ranks).reshape(n_data, n_spatial),
                    mesh_dim_names=(DATA_AXIS, SPATIAL_AXIS))
    dev = torch.device("cpu")
    if device_type == "cuda":
        dev = torch.device("cuda", multihost.local_rank())
        torch.cuda.set_device(dev)
    return Mesh(device_mesh=dm if dist.get_rank() in ranks else None, device=dev,
                ranks=ranks, shape=(n_data, n_spatial))


# ---------------------------------------------------------------------------
# the mesh a step runs over, and its reductions
# ---------------------------------------------------------------------------

# process-wide, not per thread: autograd runs a CUDA backward (and the
# recompute of `models.blocks.remat`, whose BatchNorm reduces again) on its
# own device threads
_active: Optional[Mesh] = None


@contextlib.contextmanager
def over(mesh: Optional[Mesh]):
    """Run the enclosed step over `mesh`'s data axis (None: no mesh)."""
    global _active
    prev, _active = _active, mesh
    try:
        yield mesh
    finally:
        _active = prev


def active() -> Optional[Mesh]:
    return _active


def data_size() -> int:
    """The number of slices the global batch is split into (1 without a mesh)."""
    m = active()
    return 1 if m is None else m.size


class _AllSum(torch.autograd.Function):
    """Sum over the ranks of `group`, its gradient summed back (the identity
    where `group` is None, in the same place of the graph)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        if group is not None:
            dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        if ctx.group is not None:
            dist.all_reduce(g, group=ctx.group)
        return g, None


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the active mesh's data axis, with autograd: every
    rank that computes the same loss from the summed terms then gets W
    times its slice's share of the gradient, which the gradient mean
    (`mean_grads_`) divides out."""
    m = active()
    return _AllSum.apply(t, None if m is None else m.group)


def mean_grads_(grads: Sequence[torch.Tensor]) -> None:
    """Average `grads` in place over the active mesh's data axis (one
    all-reduce of all of them)."""
    m = active()
    if m is None or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=m.group)
    flat.div_(float(m.size))
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def all_gather_batch(mesh: Mesh, tree):
    """Every rank's (b, ...) leaves of `tree` (tensors in NamedTuples, None
    kept) concatenated in rank order: the global (W * b, ...) outputs. The
    leaves travel as the bytes of one (b, bytes a sample) buffer, in one
    all-gather: each collective has a fixed host cost, larger than that of
    moving a step's outputs."""
    leaves = []

    def flatten(t):
        if t is None:
            return None
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t), [flatten(v) for v in t]
        leaves.append(t.contiguous())
        return len(leaves) - 1

    spec = flatten(tree)
    if not leaves:
        return tree
    b = leaves[0].shape[0]
    rows = [t.reshape(b, -1).view(torch.uint8) for t in leaves]
    buf = torch.cat(rows, 1)
    parts = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather(parts, buf, group=mesh.group)
    gathered = torch.cat(parts)
    out, col = [], 0
    for t, r in zip(leaves, rows):
        out.append(gathered[:, col:col + r.shape[1]].contiguous().view(t.dtype)
                   .reshape((-1,) + t.shape[1:]))
        col += r.shape[1]

    def build(node):
        if node is None:
            return None
        if isinstance(node, int):
            return out[node]
        cls, kids = node
        return cls(*(build(k) for k in kids))

    return build(spec)


# ---------------------------------------------------------------------------
# the steps over the mesh
# ---------------------------------------------------------------------------

def shard_train_step(train_step, mesh: Mesh, spatial: bool = False):
    """The (state, images, labels) train step of `train.trainer.make_train_step`
    over the mesh: each rank passes its slice of the global batch and keeps
    a replica of the state; BN statistics, the loss and the gradients are
    those of the global batch (see the module's docstring)."""
    refuse_spatial(spatial)

    def step(state, images, labels):
        with over(mesh):
            return train_step(state, images, labels)

    return step


def shard_eval_step(eval_step, mesh: Mesh, spatial: bool = False):
    """The eval step over the mesh: each rank's slice, the confusion matrix
    summed over the data axis (the psum XLA inserts in the JAX package)."""
    refuse_spatial(spatial)

    def step(state, images, labels):
        with over(mesh):
            return eval_step(state, images, labels)

    return step


def shard_pipeline_step(step_fn, mesh: Mesh, spatial: bool = False):
    """The inspection step of `pipeline.stages.build_step` over the data axis
    (multi-stream serving). SPMD: every rank passes the same global frames,
    runs its contiguous slice and returns the global `FrameOutputs`. A
    slice's first frame diffs (quality statistics) against the global
    frame before it, slice 0's against `prev_frame_bgr`, as the unsharded
    step does. A batch that the data axis does not divide raises."""
    refuse_spatial(spatial)

    def step(frames_bgr, prev_frame_bgr=None):
        frames = torch.as_tensor(frames_bgr)
        b = frames.shape[0]
        if b % mesh.size:
            raise ValueError(f"batch {b} does not divide over the data axis of "
                             f"{mesh.size} ranks")
        k = b // mesh.size
        s = mesh.rank * k
        prev = prev_frame_bgr if s == 0 else frames[s - 1:s]
        return all_gather_batch(mesh, step_fn(frames[s:s + k], prev))

    return step


def put_batch(mesh: Mesh, images, labels=None, spatial: bool = False,
              local: Optional[bool] = None):
    """Host batch -> this rank's slice on its device, the arrays' layout
    unchanged. `local` None: a batch is this rank's own slice
    (`multihost.ProcessShardedLoader`) where the mesh has more than one
    rank, else the global batch; `local=False` takes this rank's slice of a
    global batch, which the data axis must divide."""
    refuse_spatial(spatial)
    if local is None:
        local = mesh.size > 1
    if not local:
        b = len(images)
        if b % mesh.size:
            raise ValueError(f"batch {b} does not divide over the data axis of "
                             f"{mesh.size} ranks")
        k = b // mesh.size
        sl = slice(mesh.rank * k, (mesh.rank + 1) * k)
        images = images[sl]
        labels = None if labels is None else labels[sl]
    return multihost.global_put_batch(mesh, images, labels)
