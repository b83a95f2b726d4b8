"""Segmentation losses (counterpart of unet_tpu/models/losses.py:20-146;
reference src/models/losses.py:12-302): Dice, Focal, Tversky, cross-entropy
and their combinations, as functions.

  * logits are NCHW (B, C, H, W); labels are (B, H, W) int64
  * the combinations return (total, *components), components 0-d tensors
    (no host sync in the train step)
  * DiceLoss's fallback when no class is valid ("average all non-bg") is a
    select, as in the JAX package, so the loss has no data-dependent branch
  * every sum over the batch is a sum over the global batch under a mesh
    (parallel.mesh.all_sum; the identity without one): a ratio of such sums
    and Dice's fallback are the global batch's, as GSPMD gives the JAX
    package's jitted losses
  * on H stripes (a spatial mesh) Dice's and Tversky's per-(sample, class)
    sums are each sample's over its whole plane (`spatial_sum`) before
    their ratio, so that `skip_empty` and the fallback decide on whole
    samples; their mean over the samples sums over the data axis
    (`data_sum`); focal and cross-entropy divide by reduced counts.
    Without a spatial mesh every loss computes what it did without one
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from unet_tpu_torch.parallel.mesh import active_spatial, all_sum, data_size, data_sum, spatial_sum


def _flatten_probs(logits: torch.Tensor, labels: torch.Tensor):
    """softmax probabilities and one-hot labels, each (N, C, P)."""
    c = logits.shape[1]
    p = F.softmax(logits, dim=1).flatten(2)
    onehot = F.one_hot(labels.flatten(1), c).to(p.dtype).transpose(1, 2)
    return p, onehot


def _weights(w, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(w, dtype=like.dtype, device=like.device)


def dice_loss(logits: torch.Tensor, labels: torch.Tensor, smooth: float = 1e-5,
              ignore_bg: bool = True, skip_empty: bool = True,
              class_weights=None) -> torch.Tensor:
    """DiceLoss (reference losses.py:12-83): per-(sample, class) dice on the
    softmax probabilities, optional background exclusion, empty-class
    skipping and class weights, with the all-empty fallback."""
    p, t = _flatten_probs(logits, labels)
    # (N, C), each sample's over its whole plane
    inter, psum, tsum = spatial_sum(torch.stack([(p * t).sum(2), p.sum(2), t.sum(2)])).unbind(0)
    union = psum + tsum
    dice = (2 * inter + smooth) / (union + smooth)

    n, c = dice.shape
    valid = torch.ones((n, c), dtype=torch.bool, device=dice.device)
    nonbg = valid.clone()
    if ignore_bg and c > 0:
        valid[:, 0] = False
        nonbg[:, 0] = False
    if skip_empty:
        valid = valid & (tsum > 0)
    # the fallback (losses.py:69-73), where no sample of the global batch
    # has a valid class
    sel = torch.where(data_sum(valid.sum()) == 0, nonbg, valid)

    zero = torch.zeros((), dtype=dice.dtype, device=dice.device)
    if class_weights is not None:
        w = torch.where(sel, _weights(class_weights, dice)[None, :].expand(n, c), zero)
        s = data_sum(torch.stack([(dice * w).sum(), w.sum()]))
        mean = s[0] / (s[1] + 1e-6)
    else:
        s = data_sum(torch.stack([torch.where(sel, dice, zero).sum(),
                                  sel.sum().to(dice.dtype)]))
        mean = s[0] / s[1].clamp(min=1)
    return 1.0 - mean


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, gamma: float = 2.0,
               alpha=None, ignore_index: int = -100) -> torch.Tensor:
    """FocalLoss (reference losses.py:86-140)."""
    logp = F.log_softmax(logits, dim=1)
    safe = torch.where(labels == ignore_index, torch.zeros_like(labels), labels)
    logp_t = logp.gather(1, safe[:, None])[:, 0]
    p_t = logp_t.exp()
    w = (1.0 - p_t) ** gamma
    if alpha is not None:
        w = w * _weights(alpha, logp)[safe]
    loss = -w * logp_t
    mask = labels != ignore_index
    s = all_sum(torch.stack([torch.where(mask, loss, torch.zeros_like(loss)).sum(),
                             mask.sum().to(loss.dtype)]))
    return s[0] / s[1].clamp(min=1)


def tversky_loss(logits: torch.Tensor, labels: torch.Tensor, alpha: float = 0.3,
                 beta: float = 0.7, smooth: float = 1e-5,
                 ignore_bg: bool = True) -> torch.Tensor:
    """TverskyLoss (reference losses.py:143-200); unlike dice, empty classes
    are not skipped."""
    p, t = _flatten_probs(logits, labels)
    tp, fp, fn = spatial_sum(torch.stack([(p * t).sum(2), (p * (1 - t)).sum(2),
                                          ((1 - p) * t).sum(2)])).unbind(0)
    tv = (tp + smooth) / (tp + alpha * fn + beta * fp + smooth)
    if ignore_bg:
        tv = tv[:, 1:]
    return 1.0 - data_sum(tv.sum()) / float(tv.numel() * data_size())


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       class_weights=None) -> torch.Tensor:
    """nn.CrossEntropyLoss, its weighted mean included (normalised by the
    targets' summed weights, not the pixel count)."""
    logp = F.log_softmax(logits, dim=1)
    nll = -logp.gather(1, labels[:, None])[:, 0]
    if class_weights is None:
        if active_spatial() is not None:   # stripes may be uneven: the count reduced
            s = all_sum(torch.stack([nll.sum(), nll.new_tensor(float(nll.numel()))]))
            return s[0] / s[1]
        return all_sum(nll.sum()) / float(nll.numel() * data_size())
    w = _weights(class_weights, logp)[labels]
    s = all_sum(torch.stack([(nll * w).sum(), w.sum()]))
    return s[0] / s[1]


def combined_loss(logits, labels, weight_ce: float = 1.0, weight_dice: float = 1.0,
                  class_weights=None, dice_ignore_bg: bool = True,
                  dice_skip_empty: bool = True) -> Tuple[torch.Tensor, ...]:
    """CombinedLoss (reference losses.py:203-241): (total, ce, dice)."""
    ce = cross_entropy_loss(logits, labels, class_weights)
    d = dice_loss(logits, labels, ignore_bg=dice_ignore_bg, skip_empty=dice_skip_empty,
                  class_weights=class_weights)
    return weight_ce * ce + weight_dice * d, ce, d


def advanced_combined_loss(logits, labels, weight_focal: float = 0.4,
                           weight_tversky: float = 0.4, weight_dice: float = 0.2,
                           focal_gamma: float = 2.0, tversky_alpha: float = 0.3,
                           tversky_beta: float = 0.7, class_weights=None,
                           dice_ignore_bg: bool = True) -> Tuple[torch.Tensor, ...]:
    """AdvancedCombinedLoss (reference losses.py:244-302), the flagship
    training loss: (total, focal, tversky, dice)."""
    f = focal_loss(logits, labels, gamma=focal_gamma, alpha=class_weights)
    t = tversky_loss(logits, labels, alpha=tversky_alpha, beta=tversky_beta,
                     ignore_bg=dice_ignore_bg)
    d = dice_loss(logits, labels, ignore_bg=dice_ignore_bg, skip_empty=True,
                  class_weights=class_weights)
    return weight_focal * f + weight_tversky * t + weight_dice * d, f, t, d


def deep_supervision_loss(outputs, labels, loss_fn, weights=(0.1, 0.2, 0.3, 0.4)):
    """Weighted sum of `loss_fn` over the heads [out, out1, out2, out3], one
    weight per position (the main output first); returns (total, the first
    head's components or None)."""
    total = 0.0
    comps: Optional[tuple] = None
    for w, out in zip(weights, outputs):
        res = loss_fn(out, labels)
        main = res[0] if isinstance(res, tuple) else res
        total = total + w * main
        if comps is None and isinstance(res, tuple):
            comps = res[1:]
    return total, comps
