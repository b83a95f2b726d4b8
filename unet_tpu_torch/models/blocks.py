"""Building blocks of the UNet family (counterpart of
unet_tpu/models/blocks.py), NCHW; `ComputeDtype`, the compute type of every
model of the port; `BatchNorm2d`, whose train mode is flax's; `remat`, the
recomputed block of `NestedUNet(remat=True)`; `fp32_convs`, the cuDNN
precision pin of the float32 forwards and train steps; and the forwards on
H stripes of the mesh's spatial axis (`ComputeDtype.forward(x, stripes)`,
`on_stripes`, `striped_op`)."""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from unet_tpu_torch.parallel import spatial
from unet_tpu_torch.parallel.mesh import all_sum, data_size


class ComputeDtype(nn.Module):
    """A model whose `dtype` is its compute type, as flax's `dtype` is: the
    parameters stay float32, and a forward in another type runs on copies of
    them cast to it, input included. The casts are part of the autograd
    graph, so that gradients reach the float32 parameters. In eval mode the
    BN statistics are cast too; in train mode BatchNorm's parameters and
    statistics stay float32, as flax keeps them (its statistics reduce in
    float32), and the statistics' updates land in the model's own buffers.
    Subclasses write `compute(x)`; `forward` casts and calls it.

    With `stripes` (parallel.spatial.Stripes), `forward` is the model on an
    H stripe, cast the same way: `x` (B, Cin, rows, W) holds the model
    input's rows [stripes.start, stripes.end), on bounds that are multiples
    of `stripe_unit`, and the outputs hold the same stripe at their own
    level (logits at 1/logits_stride of the input's side: rows [start / k,
    end / k)). A collective of the spatial group; subclasses write
    `striped_compute(x, stripes)`. In eval mode the logits equal the whole
    forward's on one device bit for bit on the CPU (at batch 1 the CPU's
    conv may sum a slab in another order: ROADMAP C8; cuDNN may pick
    another algorithm for a stripe's shape): every op with a window over
    rows runs on its halo slab (`on_stripes`), BatchNorm, activations,
    residual adds and channel ops are row-local, a global mean reads the
    gathered plane, and the upsamples read the global source rows of their
    taps. Train mode: the NestedUNet, `LightweightNestedUNet("custom")` and
    `SimpleUNet`, the models whose logits keep the input's size.

    `stripe_unit`: the model's total stride, the multiple of rows its
    stripes' bounds fall on; `logits_stride`: the input's side over the
    logits' (1 where the logits keep the input's size)."""

    dtype: torch.dtype = torch.float32
    stripe_unit: int = spatial.UNIT
    logits_stride: int = 1

    def forward(self, x: torch.Tensor, stripes: Optional[spatial.Stripes] = None):
        if next(self.parameters()).dtype != self.dtype:   # not yet inside the cast call
            return functional_call(self, self._cast_state(), (x.to(self.dtype),),
                                   {"stripes": stripes})
        return self.compute(x) if stripes is None else self.striped_compute(x, stripes)

    def _cast_state(self) -> dict:
        keep = set()
        if self.training:
            keep = {f"{name}.{k}" for name, m in self.named_modules()
                    if isinstance(m, nn.BatchNorm2d) for k in ("weight", "bias")}
        state = {k: p if k in keep else p.to(self.dtype) for k, p in self.named_parameters()}
        for k, b in self.named_buffers():
            state[k] = b.to(self.dtype) if b.is_floating_point() and not self.training else b
        return state

    def compute(self, x: torch.Tensor):
        raise NotImplementedError

    def striped_compute(self, x: torch.Tensor, stripes: spatial.Stripes):
        raise NotImplementedError


def striped_op(op: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
               stripes: spatial.Stripes, kernel: int = 1, stride: int = 1,
               padding: int = 0) -> torch.Tensor:
    """`op`, a window of `kernel` rows at `stride` with `padding` (a conv or
    a pool), on this rank's stripe of `x` (its layout `stripes.at`): on its
    halo slab (`spatial.conv_halo`), or on the stripe itself where the op
    is row-local (a 1x1 conv at any stride, a 2x2/2 pool)."""
    r = spatial.conv_halo(kernel, stride, padding)
    if r == 0:
        return op(x)
    return spatial.halo(op, [x], stripes.at(x.shape[2]), r, 2, stride)


def on_stripes(m: nn.Module, x: torch.Tensor, stripes: spatial.Stripes) -> torch.Tensor:
    """`m(x)` on this rank's stripe of `x`, `stripes` the model input's
    layout: a module with a `striped(x, stripes)` method runs it; a
    Sequential runs its modules in turn; a conv or max pool runs on its
    halo slab (`striped_op`); any other module (BatchNorm in eval mode, an
    activation) is row-local."""
    if hasattr(m, "striped"):
        return m.striped(x, stripes)
    if isinstance(m, nn.Sequential):
        for layer in m:
            x = on_stripes(layer, x, stripes)
        return x
    if isinstance(m, (nn.Conv2d, nn.MaxPool2d)):
        k, s, p = (v[0] if isinstance(v, tuple) else v
                   for v in (m.kernel_size, m.stride, m.padding))
        return striped_op(m, x, stripes, k, s, p)
    if isinstance(m, nn.BatchNorm2d) and m.training:
        raise RuntimeError("train-mode BatchNorm on H stripes runs inside a ConvBlock "
                           "(its statistics' rows)")
    return m(x)


_recompute = threading.local()


def _recomputing() -> bool:
    return getattr(_recompute, "active", False)


@contextlib.contextmanager
def _no_stat_updates():
    _recompute.active = True
    try:
        yield
    finally:
        _recompute.active = False


def remat(block: nn.Module, x: torch.Tensor, *args) -> torch.Tensor:
    """`block(x, *args)` with its activations recomputed in the backward pass
    (`torch.utils.checkpoint`, non-reentrant), the counterpart of flax's
    `nn.remat(ConvBlock)` (unet_tpu/models/unetpp.py:45-56). The recompute
    runs BatchNorm in train mode again; it leaves the running statistics as
    the first pass left them, as the JAX package's functional recompute
    does. The block's parameters are those of this forward (inside
    `ComputeDtype`'s cast call, the cast copies) and are passed to the
    recompute, which runs after the cast call has returned; train mode
    reads no BN statistic, which the first pass updates in place."""
    from torch.utils.checkpoint import checkpoint

    state = dict(block.named_parameters())
    names = list(state)

    def run(t, *tensors):
        return functional_call(block, dict(zip(names, tensors)), (t,) + args)

    return checkpoint(run, x, *state.values(), use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), _no_stat_updates()))


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d in eval mode. In train mode flax's BatchNorm
    (flax.linen.BatchNorm with use_running_average=False and its default
    use_fast_variance=True): in float32 at least whatever the input's type, the
    batch's mean and the variance max(0, E[x^2] - E[x]^2), from the sums
    of x and x^2 over the global batch under a mesh (parallel.mesh.all_sum,
    the identity without one; a one-rank mesh computes what no mesh
    does); the output
    (x - mean) * (rsqrt(var + eps) * weight) + bias, with autograd through
    that formula; the running statistics move to the same mean and variance
    at `momentum` (torch's convention: 0.1 is flax's 0.9). Where a channel's
    mean is large against its spread, this variance differs from the
    two-pass one of F.batch_norm, whose backward differs too.
    `momentum=None` keeps torch's cumulative average. The output has the
    input's type.

    `rows` (offset, count): the statistics take only those rows of x, the
    rank's own rows of an H stripe's halo slab (`ConvBlock.striped`),
    their count reduced with the sums (stripes may be uneven); every row is
    normalised with them."""

    def forward(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        own = xf if rows is None else xf.narrow(2, *rows)
        # sums of x and x^2, over the global batch under a mesh; squares as
        # jax's lax.square, whose derivative 2 * x * g is one product (x *
        # x's two paths add up in another order)
        sums = [own.sum(dim=(0, 2, 3)), torch.square(own).sum(dim=(0, 2, 3))]
        if rows is None:
            sums = all_sum(torch.stack(sums))
            n = float(xf.numel() // xf.shape[1] * data_size())
        else:
            sums = all_sum(torch.stack(sums + [torch.full_like(sums[0], own.numel() // own.shape[1])]))
            n = sums[2].detach()
        mean = sums[0] / n
        var = torch.clamp(sums[1] / n - torch.square(mean), min=0.0)
        if self.track_running_stats and not _recomputing():
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                m = (1.0 / float(self.num_batches_tracked) if self.momentum is None
                     else self.momentum)
                self.running_mean.mul_(1 - m).add_(mean, alpha=m)
                self.running_var.mul_(1 - m).add_(var, alpha=m)
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight.to(xf.dtype)
        y = (xf - mean[:, None, None]) * mul[:, None, None]
        if self.bias is not None:
            y = y + self.bias.to(xf.dtype)[:, None, None]
        return y.to(x.dtype)


class ConvBlock(nn.Module):
    """conv3x3 -> BN -> ReLU, twice — the reference's basic block
    (reference src/models/unetpp.py:13-26); BatchNorm eps 1e-5. `rows`:
    the train-mode statistics' rows (`BatchNorm2d`)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.bn1 = BatchNorm2d(cout, eps=1e-5)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.bn2 = BatchNorm2d(cout, eps=1e-5)

    def forward(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x), rows))
        return F.relu(self.bn2(self.conv2(x), rows))

    def striped(self, x: torch.Tensor, stripes: spatial.Stripes,
                recompute: bool = False) -> torch.Tensor:
        """The block on its halo slab, 2 rows each side (one exchange for
        both convs). Train mode: BatchNorm's statistics take the rank's own
        rows of the slab (`BatchNorm2d(rows=...)`) reduced over both axes,
        and normalise the halo rows with them; with `recompute`, the block
        (not its exchange) is recomputed in the backward (`remat`)."""
        level = stripes.at(x.shape[2])
        if not self.training:
            return spatial.halo(self, [x], level, 2, 2)
        rows = (level.start - max(level.start - 2, 0), level.rows)

        def op(slab):
            return remat(self, slab, rows) if recompute else self(slab, rows)

        return spatial.halo(op, [x], level, 2, 2)


class DoubleConv(nn.Sequential):
    """conv3x3 -> ReLU, twice, no BN: SimpleUNet's block (counterpart of
    unet_tpu/models/blocks.py:33-44; reference src/models/simple_unet.py:31-38),
    with the reference's keys `0` and `2`."""

    def __init__(self, cin: int, cout: int):
        super().__init__(nn.Conv2d(cin, cout, 3, padding=1), nn.ReLU(),
                         nn.Conv2d(cout, cout, 3, padding=1), nn.ReLU())

    def striped(self, x: torch.Tensor, stripes: spatial.Stripes) -> torch.Tensor:
        """Both convs on one halo slab, 2 rows each side (no BatchNorm: the
        same in train and eval mode)."""
        return spatial.halo(self, [x], stripes.at(x.shape[2]), 2, 2)


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool (torch nn.MaxPool2d(2, 2))."""
    return F.max_pool2d(x, 2, 2)


# the cuDNN conv precision is process-wide: one forward sets and restores it
# at a time, so that concurrent forwards cannot leave it set
_precision_lock = threading.Lock()


@contextlib.contextmanager
def fp32_convs():
    """Run cuDNN's float32 convolutions in full fp32 inside the block,
    whatever the process-wide setting, which is restored on exit. PyTorch's
    default runs them in TF32 (10-bit mantissa), outside the gates the fp32
    forwards are held to. Only the per-operator API is used: mixing it with
    the legacy `allow_tf32` flag can raise. Blocks from several threads run
    one at a time (their launches; the card's work stays asynchronous).
    bf16 and int8 work inside the block is unaffected."""
    conv = torch.backends.cudnn.conv
    with _precision_lock:
        old = conv.fp32_precision
        conv.fp32_precision = "ieee"
        try:
            yield
        finally:
            conv.fp32_precision = old
