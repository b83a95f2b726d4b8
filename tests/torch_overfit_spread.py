"""The `overfit_test` recipe's spread: its train mIoU over several runs, in
the JAX package on the CPU and in the port on the CPU or the card, on the
labelled cable scenes that `chip_smoke.phase_train` writes (the first 10
of 40 `chip_smoke.train_scenes` at 800x448, seed 300).

Each run mirrors `train/loop.py:overfit_test` of its package: NestedUNet
3-class without deep supervision, 200 steps of the cross-entropy with adamw
at a constant 1e-3 and clipping at 10, then the eval-mode confusion matrix
on the same 10 samples. Run r draws the recipe's flip and brightness
augmentation from `np.random.default_rng(seed0 + r)`, so run r sees the
same 10 samples in either package. The JAX package starts every run from
`PRNGKey(0)`; the port from `flax_init(model, 0)`, or with `--init jax`
from the JAX package's `PRNGKey(0)` weights carried across (that needs
JAX, so the CPU only; `--save-init F.pth` keeps them for a run on the
card, `--init F.pth` loads them there).

    python tests/torch_overfit_spread.py --package jax --runs 5
    python tests/torch_overfit_spread.py --package torch --init jax --save-init build/init.pth
    python tests/torch_overfit_spread.py --package torch --device cuda --init build/init.pth

Prints one JSON object per run (its mIoU, the loss at a few steps, the
steps where a loss bump begins, and with `--curves` the loss and the
gradient norm at every step) and a summary line. A bump begins where the
loss first rises 5 % above its lowest value so far (from step 20 on) and
ends once it is back within 2.5 % of it (`bumps`); a bump in the last
steps leaves the eval's running statistics behind the weights.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

STEPS, LR, CLIP, N_SAMPLES = 200, 1e-3, 10.0, 10
AT = (0, 25, 50, 100, 150, 199)
LATE = 185   # a bump from here on is one the running statistics have not caught up with


def bumps(losses, rise: float = 0.05, start: int = 20) -> list:
    """The steps where a loss bump begins (see the module's docstring)."""
    out, low, inside = [], losses[0], False
    for i, v in enumerate(losses):
        if i >= start and v > (1 + rise) * low:
            if not inside:
                out.append(i)
                inside = True
        elif v <= (1 + rise / 2) * low:
            inside = False
        low = min(low, v)
    return out


def _samples(pkg: str, root: str, size: int, seed: int):
    """The recipe's 10 samples (`recipes._datasets(..., advanced=False,
    three_class=True)`'s train split) with the augmentation drawn from `seed`."""
    if pkg == "jax":
        from unet_tpu.data.dataset import REMAP_7_TO_3, SegmentationDataset
    else:
        from unet_tpu_torch.data.dataset import REMAP_7_TO_3, SegmentationDataset
    ds = SegmentationDataset(os.path.join(root, "train/images"), os.path.join(root, "train/masks"),
                             augment=True, target_size=(size, size), class_remap=REMAP_7_TO_3,
                             rng=np.random.default_rng(seed))
    pairs = [ds[i] for i in range(min(N_SAMPLES, len(ds)))]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def _jax_state(size: int):
    import jax

    from unet_tpu.models import NestedUNet
    from unet_tpu.train.trainer import OptimCfg, create_train_state

    return create_train_state(NestedUNet(num_classes=3, deep_supervision=False),
                              jax.random.PRNGKey(0), (1, size, size, 3),
                              OptimCfg(lr=LR, schedule="constant", total_steps=STEPS,
                                       clip_norm=CLIP))


def run_jax(images, labels, size: int):
    import jax

    from unet_tpu.ops.seg_metrics import metrics_from_confusion
    from unet_tpu.train.trainer import LossCfg, make_eval_step, make_train_step

    state = _jax_state(size)
    step = jax.jit(make_train_step(LossCfg(kind="ce")))
    ev = jax.jit(make_eval_step(3))
    losses, norms = [], []
    for _ in range(STEPS):
        state, metrics = step(state, images, labels)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    cm = np.asarray(ev(state, images, labels), np.int64)
    return float(metrics_from_confusion(cm)[0]), losses, norms


def run_torch(images, labels, size: int, device: str, init: str, save_init: str = ""):
    import torch

    from unet_tpu_torch.models import NestedUNet
    from unet_tpu_torch.ops.seg_metrics import metrics_from_confusion
    from unet_tpu_torch.train.trainer import (LossCfg, OptimCfg, create_train_state, flax_init,
                                              make_eval_step, make_train_step, upload)

    model = NestedUNet(3, deep_supervision=False)
    if init == "jax":
        from unet_tpu_torch.models.convert import state_dict_from_flax

        js = _jax_state(size)
        model.load_state_dict(state_dict_from_flax({"params": js.params,
                                                    "batch_stats": js.batch_stats}))
        if save_init:
            torch.save(model.state_dict(), save_init)
    elif init.endswith(".pth"):
        model.load_state_dict(torch.load(init, map_location="cpu"))
    else:
        flax_init(model, 0)
    state = create_train_state(model, OptimCfg(lr=LR, schedule="constant", total_steps=STEPS,
                                               clip_norm=CLIP), device)
    step = make_train_step(LossCfg(kind="ce"))
    im, lb = upload(images, labels, device)
    losses, norms = [], []
    for _ in range(STEPS):
        state, metrics = step(state, im, lb)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    cm = make_eval_step(3)(state, im, lb)
    return float(metrics_from_confusion(cm.cpu().numpy())[0]), losses, norms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--init", default="flax",
                    help="the port's start: flax (flax_init(model, 0)), jax (the JAX "
                         "package's PRNGKey(0) weights) or a .pth of them")
    ap.add_argument("--save-init", default="", help="with --init jax: save them here")
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--seed0", type=int, default=0)
    ap.add_argument("--curves", action="store_true", help="print every step's loss and norm")
    args = ap.parse_args(argv)
    if args.package == "jax" or args.init == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
    import chip_smoke

    mious, late = [], 0
    with tempfile.TemporaryDirectory(prefix="overfit_spread_") as tmp:
        root = chip_smoke.write_split(Path(tmp), 40, 1, 448, 800, seed=300)
        for r in range(args.runs):
            images, labels = _samples(args.package, root, args.size, args.seed0 + r)
            t = time.time()
            if args.package == "jax":
                miou, losses, norms = run_jax(images, labels, args.size)
            else:
                miou, losses, norms = run_torch(images, labels, args.size, args.device, args.init,
                                         args.save_init)
            mious.append(miou)
            found = bumps(losses)
            late += any(b >= LATE for b in found)
            curves = dict(losses=losses, grad_norms=norms) if args.curves else {}
            print(json.dumps(dict(package=args.package, device=args.device, init=args.init,
                                  size=args.size, seed=args.seed0 + r, miou=round(miou, 6),
                                  loss_at={s: round(losses[s], 6) for s in AT},
                                  bumps=found, seconds=round(time.time() - t, 1), **curves)),
                  flush=True)
    print(f"overfit_test {args.package} ({args.device}, init {args.init}) at {args.size}^2: "
          f"mIoU {[round(m, 4) for m in mious]}, {sum(m > 0.98 for m in mious)} of "
          f"{len(mious)} over the 0.98 gate; {late} with a loss bump from step {LATE}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
