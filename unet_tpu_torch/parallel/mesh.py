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

The spatial axis (ROADMAP A15c, `parallel.spatial`): an (n_data,
n_spatial) mesh splits each data slice's model input into H stripes over
the spatial group. `shard_pipeline_step(spatial=True)` divides the slice's
frames among the group's ranks, runs everything before and after the
model on whole frames as `build_step` does, and the model itself on the
stripes between two re-splits (`pipeline.stages.striped_segment_forward`);
`shard_eval_step(spatial=True)` runs the eval forward on the stripes of
`put_batch(spatial=True)` and sums the confusion matrix over both axes.
The spatial train step (a halo exchange with a backward, stripe-aware
BatchNorm statistics, loss sums and gradients) is ROADMAP A15d:
`shard_train_step(spatial=True)` and `TrainRunCfg.n_spatial > 1` raise.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from unet_tpu_torch.parallel import multihost
from unet_tpu_torch.parallel import spatial as _sp

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
_A15D = "the spatial train step is not ported to unet_tpu_torch yet, ROADMAP A15d"


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
        return self.ranks.index(dist.get_rank()) // self.shape[1]

    @property
    def spatial_group(self):
        """The process group of the spatial axis."""
        return self.device_mesh.get_group(SPATIAL_AXIS)

    @property
    def spatial_size(self) -> int:
        """n_spatial: the ranks over which a slice's H is split."""
        return self.shape[1]

    @property
    def spatial_rank(self) -> int:
        """This process's index on the spatial axis."""
        return self.ranks.index(dist.get_rank()) % self.shape[1]


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


def mesh_device(device: str) -> torch.device:
    """The device of this process for a mesh on `device`: "cpu"; "cuda:N",
    the card N that the caller names (several ranks may share one card);
    "cuda", the card of torchrun's LOCAL_RANK."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", multihost.local_rank())
    return dev


def make_mesh(n_data: Optional[int] = None, n_spatial: int = 1,
              devices: Optional[Sequence[int]] = None,
              device: Optional[str] = None) -> Mesh:
    """(data, spatial) mesh over the global ranks `devices` (all of them by
    default, all on the data axis), rank r at (r // n_spatial, r %
    n_spatial) in the order of `devices`, with this process's device
    (`mesh_device`): `device` "cuda" (the default unless a CPU-only group
    exists), "cuda:N" or "cpu". A CUDA mesh without a card raises; so does
    a shape that does not cover `devices`. The group keeps the backend it
    was started with (a gloo group carries CUDA tensors too)."""
    if device is None:
        device = "cuda" if not dist.is_initialized() or "nccl" in dist.get_backend() else "cpu"
    dev = mesh_device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device='cuda') needs a CUDA device")
    _ensure_group(dev.type)
    ranks = tuple(int(r) for r in (devices if devices is not None
                                   else range(dist.get_world_size())))
    if n_data is None:
        n_data = len(ranks) // n_spatial
    if n_data * n_spatial != len(ranks):
        raise ValueError(f"{n_data}x{n_spatial} mesh != {len(ranks)} ranks")
    from torch.distributed.device_mesh import DeviceMesh

    dm = DeviceMesh(dev.type, torch.tensor(ranks).reshape(n_data, n_spatial),
                    mesh_dim_names=(DATA_AXIS, SPATIAL_AXIS))
    if dev.type == "cuda":
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
_spatial = False


@contextlib.contextmanager
def over(mesh: Optional[Mesh], spatial: bool = False):
    """Run the enclosed step over `mesh`'s data axis (None: no mesh), and
    with `spatial` on H stripes over its spatial axis."""
    global _active, _spatial
    prev, _active, _spatial = (_active, _spatial), mesh, spatial
    try:
        yield mesh
    finally:
        _active, _spatial = prev


def active() -> Optional[Mesh]:
    return _active


def active_spatial() -> Optional[Mesh]:
    """The active mesh where the step runs on H stripes over its spatial
    axis (more than one rank), else None."""
    return _active if _spatial and _active is not None and _active.spatial_size > 1 else None


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


def spatial_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the spatial axis of the active spatial mesh (`t`
    itself without one); no autograd."""
    m = active_spatial()
    if m is None:
        return t
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=m.spatial_group)
    return out


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
    kept) concatenated in data-axis order: the global (W * b, ...) outputs.
    The leaves travel as the bytes of one (b, bytes a sample) buffer, in one
    all-gather: each collective has a fixed host cost, larger than that of
    moving a step's outputs."""
    spec, buf = _sp.pack(tree)
    if buf is None:
        return tree
    return _sp.unpack(spec, _sp.all_gather(buf, mesh.group, mesh.size).flatten(0, 1))


# ---------------------------------------------------------------------------
# the steps over the mesh
# ---------------------------------------------------------------------------

def shard_train_step(train_step, mesh: Mesh, spatial: bool = False):
    """The (state, images, labels) train step of `train.trainer.make_train_step`
    over the mesh: each rank passes its slice of the global batch and keeps
    a replica of the state; BN statistics, the loss and the gradients are
    those of the global batch (see the module's docstring). `spatial=True`
    is ROADMAP A15d and raises."""
    if spatial:
        raise NotImplementedError(f"shard_train_step(spatial=True): {_A15D}")

    def step(state, images, labels):
        with over(mesh):
            return train_step(state, images, labels)

    return step


def shard_eval_step(eval_step, mesh: Mesh, spatial: bool = False):
    """The eval step over the mesh: each rank's slice (with `spatial`, its
    H stripe of the slice, from `put_batch(spatial=True)`, which the
    step's forward runs on), the confusion matrix summed over the mesh (the
    psum XLA inserts in the JAX package)."""

    def step(state, images, labels):
        with over(mesh, spatial):
            return eval_step(state, images, labels)

    return step


def _data_slice(b: int, mesh: Mesh) -> Tuple[int, int]:
    """(frames, first frame) of this rank's data slice of a batch of b."""
    if b % mesh.size:
        raise ValueError(f"batch {b} does not divide over the data axis of "
                         f"{mesh.size} ranks")
    k = b // mesh.size
    return k, mesh.rank * k


def shard_pipeline_step(step_fn, mesh: Mesh, spatial: bool = False):
    """The inspection step of `pipeline.stages.build_step` over the mesh
    (multi-stream serving, and with `spatial` the native-resolution path).
    SPMD: every rank passes the same global frames, runs its contiguous
    slice and returns the global `FrameOutputs`. A slice's first frame
    diffs (quality statistics) against the global frame before it, slice
    0's against `prev_frame_bgr`, as the unsharded step does. A batch that
    the data axis does not divide raises.

    With `spatial`, the slice's frames are divided among the spatial
    group's ranks (`parallel.spatial.frame_split`: contiguous, as even as
    possible); each rank runs `run_pipeline` on its whole frames, the model
    on H stripes of the whole slice (`stages.striped_segment_forward`),
    and the outputs are gathered over both axes. A rank without a frame
    launches nothing but the model's stripes. Only the custom-encoder
    NestedUNet runs on stripes (ROADMAP A15e for the others)."""
    if spatial:
        return _spatial_pipeline_step(step_fn, mesh)

    def step(frames_bgr, prev_frame_bgr=None):
        frames = torch.as_tensor(frames_bgr)
        k, s = _data_slice(frames.shape[0], mesh)
        prev = prev_frame_bgr if s == 0 else frames[s - 1:s]
        return all_gather_batch(mesh, step_fn(frames[s:s + k], prev))

    return step


def _spatial_pipeline_step(step_fn, mesh: Mesh):
    from unet_tpu_torch.pipeline import stages

    parts = getattr(step_fn, "parts", None)
    if parts is None:
        raise TypeError("shard_pipeline_step(spatial=True) takes a step of "
                        "pipeline.stages.build_step")
    model, cfg, device = parts
    forward = stages.striped_segment_forward(model, cfg, device)
    w, h = cfg.preprocess.model_size
    stripes = _sp.Stripes(_sp.stripe_bounds(h, mesh.spatial_size), mesh.spatial_rank,
                          mesh.spatial_group)

    def step(frames_bgr, prev_frame_bgr=None):
        frames = torch.as_tensor(frames_bgr)
        k, base = _data_slice(frames.shape[0], mesh)
        counts = _sp.frame_split(k, stripes.n)
        first, mine = counts[stripes.index]

        def fwd(x):
            return forward(x, counts, stripes)

        out = None
        with torch.inference_mode():
            if mine:
                g = base + first
                prev = prev_frame_bgr if g == 0 else frames[g - 1:g]
                out = stages.run_pipeline(fwd, frames[g:g + mine].to(device), cfg,
                                          None if prev is None else torch.as_tensor(prev).to(device))
            else:
                fwd(torch.zeros((0, h, w, 3), device=device))
            out = _sp.gather_frames(out, counts, stripes, device)
        return all_gather_batch(mesh, out)

    return step


def put_batch(mesh: Mesh, images, labels=None, spatial: bool = False,
              local: Optional[bool] = None):
    """Host batch -> this rank's block on its device, the arrays' layout
    unchanged. `local` None: a batch is this rank's own data slice
    (`multihost.ProcessShardedLoader`) where the data axis has more than
    one rank, else the global batch; `local=False` takes this rank's slice
    of a global batch, which the data axis must divide. With `spatial`,
    of the (B, H, ...) slice this rank's H stripe
    (`parallel._sp.stripe_bounds`), as `batch_sharding` places a block
    (unet_tpu/parallel/mesh.py:42-48)."""
    if local is None:
        local = mesh.size > 1
    if not local:
        k, s = _data_slice(len(images), mesh)
        images = images[s:s + k]
        labels = None if labels is None else labels[s:s + k]
    if spatial and mesh.spatial_size > 1:
        s, e = _sp.stripe_bounds(images.shape[1], mesh.spatial_size)[mesh.spatial_rank]
        images = images[:, s:e]
        labels = None if labels is None else labels[:, s:e]
    return multihost.global_put_batch(mesh, images, labels)
