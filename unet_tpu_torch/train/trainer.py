"""Training engine of the port (counterpart of unet_tpu/train/trainer.py:
36-215): the loss and optimizer configurations, optax's schedules as
functions of the optimizer step, the optimizer chain as `torch.optim`,
and the train and eval steps.

optax's chain, `MultiSteps(chain(clip_by_global_norm, adamw(schedule)))`,
becomes:
  * the schedule: optax's formulas evaluated in float32 (`build_schedule`),
    fed to the optimizer through a `LambdaLR` over a base lr of 1.0, so
    that the lr of optimizer step n is schedule(n) exactly. torch's
    `OneCycleLR` and `CosineAnnealingWarmRestarts` compute other formulas
  * AdamW: the port's own (`AdamW`), optax.adamw's arithmetic in optax's
    order (torch.optim.AdamW rounds otherwise: a lerp for the first
    moment, sqrt(v) / sqrt(bc2) for the denominator, the decay applied
    before the step); a parameter without a gradient gets a zero one, as
    in JAX
  * clipping: optax's rule, (g / |g|) * max_norm only where |g| >= max_norm
    (`clip_grad_norm_` divides by |g| + 1e-6 whenever it clips), |g| the
    square root of the sum of each tensor's sum of squares
  * accumulation (`OptimCfg.accum_steps` > 1): the running mean of optax's
    MultiSteps, acc + (g - acc) / (n + 1), clipped and applied once every k
    micro-steps; only that update advances the schedule

The step mutates the `TrainState` it is given (the model's parameters and
BN statistics, the optimizer, the scheduler, the accumulator) and returns
it with the metrics, device tensors: reading them synchronises.

BatchNorm trains as flax's does (models.blocks.BatchNorm2d: biased batch
variance into the running statistics). The float32 step runs forward and
backward with cuDNN's convs in full fp32 (models.blocks.fp32_convs), as
the inference forward does; bf16 models (`NestedUNet(dtype=torch.bfloat16)`)
keep float32 parameters and optimizer state, and the losses reduce in
float32.

Over a mesh (`mesh=`, parallel.mesh) each rank passes its block of the
global batch: its data slice, and on a mesh with a spatial axis its H
stripe of the slice (`parallel.put_batch`), the forward then running on
the stripes (`ComputeDtype.forward(x, stripes)`). BN statistics and the
losses are the global batch's, and every rank's gradient is the global
batch's (parallel.mesh's convention) before accumulation, clipping and the
update, as GSPMD's all-reduce gives it to optax in the JAX package.
`sample_loss` is per local sample, over its whole plane.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from unet_tpu_torch.models import losses as L
from unet_tpu_torch.models.blocks import ComputeDtype, fp32_convs
from unet_tpu_torch.ops import seg_metrics
from unet_tpu_torch.parallel import mesh as _mesh
from unet_tpu_torch.parallel import spatial


@dataclass(frozen=True)
class LossCfg:
    kind: str = "advanced"           # "advanced" | "combined" | "ce" | "dice"
    class_weights: Tuple[float, ...] = ()
    weight_focal: float = 0.35
    weight_tversky: float = 0.45
    weight_dice: float = 0.20
    focal_gamma: float = 2.0
    tversky_alpha: float = 0.25
    tversky_beta: float = 0.75
    weight_ce: float = 1.0           # combined
    ds_weights: Tuple[float, ...] = (0.1, 0.2, 0.3, 0.4)


@dataclass(frozen=True)
class OptimCfg:
    lr: float = 2e-4
    weight_decay: float = 1e-4
    schedule: str = "onecycle"       # "onecycle" | "cosine" | "cosine_restarts" | "constant"
    total_steps: int = 10_000
    pct_start: float = 0.1
    div_factor: float = 10.0
    final_div_factor: float = 100.0
    clip_norm: float = 1.0
    accum_steps: int = 1
    restart_period: int = 1000       # cosine_restarts (train_3class_ultra.py)


# ---------------------------------------------------------------------------
# optax's schedules, in float32 as jitted optax evaluates them
# ---------------------------------------------------------------------------

_F = np.float32


def _cos(x):
    return np.cos(_F(np.pi) * x, dtype=_F)


def cosine_decay_schedule(init_value: float, decay_steps: int) -> Callable[[int], float]:
    """optax.cosine_decay_schedule (alpha 0, exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule requires positive decay_steps, got "
                         f"{decay_steps}")

    def schedule(count: int) -> float:
        c = _F(min(count, decay_steps))
        decay = _F(0.5) * (_F(1) + _cos(c / _F(decay_steps)))
        return float(_F(init_value) * decay)

    return schedule


def cosine_onecycle_schedule(transition_steps: int, peak_value: float, pct_start: float,
                             div_factor: float, final_div_factor: float
                             ) -> Callable[[int], float]:
    """optax.cosine_onecycle_schedule: optax's piecewise cosine interpolation
    from peak/div up to peak at int(pct_start * steps), then down to
    peak / (div * final_div) at `transition_steps`. Where int(pct_start *
    steps) is 0 the warm-up interval is empty; optax's dot product over the
    intervals then turns its 0/0 into NaN at every step, here the empty
    interval is skipped."""
    if transition_steps <= 0:
        raise ValueError("a onecycle schedule needs positive transition_steps")
    scales = dict(sorted({int(pct_start * transition_steps): div_factor,
                          int(transition_steps): 1.0 / (div_factor * final_div_factor)
                          }.items()))
    bounds = np.array((0,) + tuple(scales), np.int64)
    values = np.cumprod(np.array((peak_value / div_factor,) + tuple(scales.values()))).astype(_F)

    def schedule(count: int) -> float:
        out = _F(0)
        for i in range(len(bounds) - 1):
            if bounds[i] <= count < bounds[i + 1]:
                pct = _F(count - bounds[i]) / _F(bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                out = end + (start - end) / _F(2) * (_cos(pct) + _F(1))
        if bounds[-1] <= count:
            out = values[-1]
        return float(out)

    return schedule


def join_schedules(schedules: Sequence[Callable[[int], float]],
                   boundaries: Sequence[int]) -> Callable[[int], float]:
    """optax.join_schedules: schedule i + 1 from boundaries[i], on the
    count past it."""
    def schedule(count: int) -> float:
        out = schedules[0](count)
        for b, s in zip(boundaries, schedules[1:]):
            if count >= b:
                out = s(count - b)
        return out

    return schedule


def build_schedule(cfg: OptimCfg) -> Callable[[int], float]:
    """The lr of optimizer step n (0-based), as the JAX package's
    `build_schedule` (unet_tpu/train/trainer.py:86-104) gives it."""
    if cfg.schedule == "onecycle":   # torch OneCycleLR(anneal='cos') in intent
        return cosine_onecycle_schedule(cfg.total_steps, cfg.lr, cfg.pct_start,
                                        cfg.div_factor, cfg.final_div_factor)
    if cfg.schedule == "cosine":
        return cosine_decay_schedule(cfg.lr, cfg.total_steps)
    if cfg.schedule == "cosine_restarts":   # CosineAnnealingWarmRestarts in intent
        n = max(cfg.total_steps // cfg.restart_period, 1)
        return join_schedules([cosine_decay_schedule(cfg.lr, cfg.restart_period)] * n,
                              [cfg.restart_period * (i + 1) for i in range(n - 1)])
    if cfg.schedule == "constant":
        return lambda count: float(_F(cfg.lr))
    raise ValueError(cfg.schedule)


class AdamW(torch.optim.Optimizer):
    """optax.adamw (unet_tpu/train/trainer.py:100-107) in optax's arithmetic,
    one float32 rounding after each of its operations:

        mu = (1 - b1) * g + b1 * mu;  nu = (1 - b2) * g^2 + b2 * nu
        u = (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps) + wd * p
        p = p + (-lr) * u

    with n the update's count and b^n float32 powers on the host, which
    needs no device sync. The state keeps torch.optim.AdamW's names
    (`step`, a float32 CPU tensor, `exp_avg`, `exp_avg_sq`), so that an
    AdamW state dict loads."""

    def __init__(self, params, lr: float = 1e-3, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 1e-4):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            states = [self.state[p] for p in params]
            for p, st in zip(params, states):
                if not st:
                    st["step"] = torch.tensor(0.0, dtype=torch.float32)
                    st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            grads = [p.grad for p in params]
            mus = [st["exp_avg"] for st in states]
            nus = [st["exp_avg_sq"] for st in states]
            b1, b2 = group["betas"]
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, torch._foreach_mul(grads, 1 - b1))
            torch._foreach_mul_(nus, b2)
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1 - b2)
            torch._foreach_add_(nus, sq)
            for st in states:
                st["step"] += 1
            n = np.float32(states[0]["step"])
            bc1 = float(np.float32(1) - np.float32(b1) ** n)
            bc2 = float(np.float32(1) - np.float32(b2) ** n)
            u = torch._foreach_div(mus, bc1)
            den = _sqrt(torch._foreach_div(nus, bc2))
            torch._foreach_add_(den, group["eps"])
            torch._foreach_div_(u, den)
            if group["weight_decay"]:
                torch._foreach_add_(u, torch._foreach_mul(params, group["weight_decay"]))
            torch._foreach_mul_(u, -group["lr"])
            torch._foreach_add_(params, u)


def _sqrt(ts: List[torch.Tensor]) -> List[torch.Tensor]:
    """Correctly rounded float32 square roots, as XLA's: CUDA's sqrt is;
    the CPU's vectorised one is not always, so there it is taken in float64
    (exact once rounded to float32)."""
    if ts[0].is_cuda:
        torch._foreach_sqrt_(ts)
        return ts
    return [torch.sqrt(t.double()).to(t.dtype) for t in ts]


def build_optimizer(params, cfg: OptimCfg):
    """(AdamW, LambdaLR) over `params`: optax.adamw at the lr of
    `build_schedule(cfg)`. Clipping and accumulation are `TrainState`'s."""
    opt = AdamW(params, lr=1.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, build_schedule(cfg))


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: the square root of the sum, in order, of each
    tensor's sum of squares, as a device scalar."""
    total = None
    for t in tensors:
        s = torch.square(t).sum()
        total = s if total is None else total + s
    return _sqrt([total])[0]


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: (g / |g|) * max_norm where |g| >=
    max_norm, g as it is below (no host sync)."""
    norm = global_norm(grads)
    clipped = torch._foreach_div(grads, norm)
    torch._foreach_mul_(clipped, max_norm)
    keep = norm < max_norm
    for g, c in zip(grads, clipped):
        g.copy_(torch.where(keep, g, c))


# ---------------------------------------------------------------------------
# state and steps
# ---------------------------------------------------------------------------

@dataclass
class TrainState:
    """The model (its parameters and BN statistics), the optimizer, the
    scheduler and the step count (micro-steps), with MultiSteps'
    accumulator (`acc_grads`, `mini_step`) where `accum_steps` > 1."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    clip_norm: float
    accum_steps: int = 1
    step: int = 0
    mini_step: int = 0
    acc_grads: Optional[List[torch.Tensor]] = None
    params: List[torch.Tensor] = field(default_factory=list)

    def apply_gradients(self, grads: List[torch.Tensor]) -> None:
        """One optimizer transform of `grads` (one micro-step's gradients,
        one per parameter, in `params`' order)."""
        if self.accum_steps > 1:
            if self.acc_grads is None:
                self.acc_grads = [torch.zeros_like(p) for p in self.params]
            n = self.mini_step
            delta = torch._foreach_sub(grads, self.acc_grads)
            torch._foreach_div_(delta, float(n + 1))
            torch._foreach_add_(self.acc_grads, delta)
            self.mini_step = (n + 1) % self.accum_steps
            if self.mini_step:
                return
            grads = [a.clone() for a in self.acc_grads]
            for a in self.acc_grads:
                a.zero_()
        clip_by_global_norm(grads, self.clip_norm)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.optimizer.step()
        self.scheduler.step()
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(), "step": self.step,
                "accum": {"mini_step": self.mini_step, "acc_grads": self.acc_grads}}

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.scheduler.load_state_dict(sd["scheduler"])
        self.step = int(sd["step"])
        self.mini_step = int(sd["accum"]["mini_step"])
        acc = sd["accum"]["acc_grads"]
        dev = self.params[0].device
        self.acc_grads = None if acc is None else [a.to(dev) for a in acc]


def flax_init(model: nn.Module, seed: int = 0) -> nn.Module:
    """flax's default initialisation, drawn from a torch generator seeded
    with `seed`: every conv kernel LeCun-normal (truncated at two standard
    deviations, variance 1 / fan-in, as `nn.initializers.lecun_normal`),
    biases 0, BatchNorm scale 1, bias 0 and statistics (0, 1). The JAX
    package's `create_train_state` starts from this distribution; the port
    cannot draw JAX's numbers, so parity tests carry weights across with
    models.convert instead."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                std = math.sqrt(1.0 / m.weight[0].numel()) / .87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std, generator=g)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model


def create_train_state(model: nn.Module, optim: OptimCfg,
                       device: str = "cuda") -> TrainState:
    """The model on `device` in train mode, with its optimizer chain (the
    JAX package's `create_train_state`, unet_tpu/train/trainer.py:144-152,
    initialises the variables; here the model comes with its weights)."""
    model = model.to(device).train()
    params = list(model.parameters())
    opt, sched = build_optimizer(params, optim)
    return TrainState(model=model, optimizer=opt, scheduler=sched, clip_norm=optim.clip_norm,
                      accum_steps=optim.accum_steps, params=params)


def upload(images: np.ndarray, labels: np.ndarray, device: str
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A loader's numpy batch, (B, H, W, 3) float32 images and (B, H, W)
    integer labels, on `device` as (B, 3, H, W) float32 and (B, H, W) int64;
    to a card from pinned memory without blocking the host."""
    im = torch.from_numpy(np.ascontiguousarray(images, np.float32))
    lb = torch.from_numpy(np.ascontiguousarray(labels)).long()
    if torch.device(device).type == "cuda":
        im, lb = im.pin_memory(), lb.pin_memory()
    im = im.to(device, non_blocking=True).permute(0, 3, 1, 2).contiguous()
    return im, lb.to(device, non_blocking=True)


def _f32(t: torch.Tensor) -> torch.Tensor:
    """`t` in float32, or in its own type where that is wider."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def make_loss_fn(cfg: LossCfg):
    """loss_fn(outputs, labels) -> (total, components): the configured loss
    of one output, or the deep-supervision sum over a list of them (the
    last len(outputs) weights of `ds_weights`), computed in float32 (in
    float64 for a float64 model)."""
    cw = tuple(cfg.class_weights) if cfg.class_weights else None
    if cfg.kind == "advanced":
        base = partial(L.advanced_combined_loss, weight_focal=cfg.weight_focal,
                       weight_tversky=cfg.weight_tversky, weight_dice=cfg.weight_dice,
                       focal_gamma=cfg.focal_gamma, tversky_alpha=cfg.tversky_alpha,
                       tversky_beta=cfg.tversky_beta, class_weights=cw)
    elif cfg.kind == "combined":
        base = partial(L.combined_loss, weight_ce=cfg.weight_ce,
                       weight_dice=cfg.weight_dice, class_weights=cw)
    elif cfg.kind == "ce":
        base = lambda lg, lb: (L.cross_entropy_loss(lg, lb, cw),)
    elif cfg.kind == "dice":
        base = lambda lg, lb: (L.dice_loss(lg, lb, class_weights=cw),)
    else:
        raise ValueError(cfg.kind)

    def loss_fn(outputs, labels):
        if isinstance(outputs, (list, tuple)):
            ws = cfg.ds_weights[-len(outputs):]
            return L.deep_supervision_loss([_f32(o) for o in outputs], labels, base, ws)
        res = base(_f32(outputs), labels)
        return res[0], res[1:]

    return loss_fn


def make_train_step(loss_cfg: LossCfg, track_sample_loss: bool = False, mesh=None):
    """train_step(state, images, labels) -> (state, metrics): one micro-step
    on (B, 3, H, W) float32 images and (B, H, W) int64 labels on the
    state's device. metrics: "loss", "grad_norm" (of this micro-step's
    gradients, before accumulation and clipping), the loss's components
    under the JAX package's names ("focal", "tversky", "dice", "extra" in
    order) and, with `track_sample_loss`, "sample_loss" (B,), the
    per-sample cross-entropy of the main output. With `mesh` the step runs
    over it (`parallel.shard_train_step`, its spatial axis included): B
    is this rank's slice and H its stripe, and everything but
    "sample_loss" is the global batch's; "sample_loss" is each sample of
    the slice's mean over its whole plane."""
    loss_fn = make_loss_fn(loss_cfg)

    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        model = state.model.train()
        for p in state.params:
            p.grad = None
        with fp32_convs():
            outs, height = _forward(model, images)
            total, comps = loss_fn(outs, labels)
            total.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in state.params]
        _mesh.mean_grads_(grads)
        metrics: Dict[str, torch.Tensor] = {"loss": total.detach(),
                                            "grad_norm": global_norm(grads)}
        if track_sample_loss:
            main = _f32((outs[0] if isinstance(outs, (list, tuple)) else outs).detach())
            nll = -torch.log_softmax(main, 1).gather(1, labels[:, None])[:, 0]
            if height is None:
                metrics["sample_loss"] = nll.mean(dim=(-2, -1))
            else:
                metrics["sample_loss"] = (_mesh.spatial_sum(nll.sum(dim=(-2, -1)))
                                          / float(height * nll.shape[-1]))
        for name, v in zip(("focal", "tversky", "dice", "extra"), comps or ()):
            metrics[name] = v.detach()
        state.apply_gradients(grads)
        state.step += 1
        return state, metrics

    return step if mesh is None else _mesh.shard_train_step(step, mesh)


def make_eval_step(num_classes: int, mesh=None):
    """eval_step(state, images, labels) -> (C, C) int64 confusion matrix on
    the device (`state` a TrainState or the model itself): the eval-mode
    forward (its first head), argmax, and `seg_metrics.confusion_matrix`,
    which drops labels >= num_classes (the loop's padding). With `mesh`,
    over it (`parallel.shard_eval_step`): each rank's slice, and on a mesh
    with a spatial axis its H stripe of the slice (`parallel.put_batch`):
    the forward on the stripes (`ComputeDtype.forward(x, stripes)`); the
    matrix summed over the mesh."""

    def step(state, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        model = getattr(state, "model", state).eval()
        with torch.no_grad(), fp32_convs():
            logits, _ = _forward(model, images)
        if isinstance(logits, (list, tuple)):
            logits = logits[0]
        cm = seg_metrics.confusion_matrix(logits.argmax(1), labels, num_classes)
        return _mesh.all_sum(cm)

    return step if mesh is None else _mesh.shard_eval_step(step, mesh)


def _forward(model: nn.Module, images: torch.Tensor):
    """(the model's outputs, None), or on the H stripes of the active
    spatial mesh where the step runs over one (`parallel.mesh.over(mesh,
    spatial=True)`), (the stripes' outputs, the model input's height). A
    model whose logits do not keep the input's size raises RuntimeError
    there, before any collective, as its one-process step raises where the
    loss or the confusion matrix meets the labels."""
    m = _mesh.active_spatial()
    if m is None:
        return model(images), None
    if not isinstance(model, ComputeDtype):
        raise NotImplementedError(f"{type(model).__name__} has no forward on H stripes")
    if model.logits_stride != 1:
        raise RuntimeError(f"{type(model).__name__}'s logits come out at "
                           f"1/{model.logits_stride} of the input's side: they do not match "
                           f"labels at the input's size")
    st = spatial.stripes_of(images.shape[2], m.spatial_rank, m.spatial_group, m.spatial_size,
                            images.device)
    return model(images, st), st.height
