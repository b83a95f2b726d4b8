"""Training recipes of the port (counterpart of unet_tpu/train/recipes.py:
16-269): the tools/train*.py family as named configurations.

Each recipe binds dataset construction + LossCfg/OptimCfg/TrainRunCfg with
the exact hyperparameters of its reference script, run through the one
train loop (train.loop) on `args.device` (the card unless the caller asks
for the CPU), over every rank that `torchrun` started (train.loop's mesh).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Callable, Dict

from unet_tpu_torch.train.loop import TrainRunCfg, train_model
from unet_tpu_torch.train.trainer import LossCfg, OptimCfg


def _datasets(args, image_size: int, advanced: bool, three_class: bool):
    import os

    from unet_tpu_torch.data.dataset import (AdvancedDataset, SegmentationDataset,
                                       REMAP_7_TO_3)
    root = args.data_root
    remap = REMAP_7_TO_3 if three_class else None
    tsize = (image_size, image_size)
    if advanced:
        train = AdvancedDataset(os.path.join(root, "train/images"),
                                os.path.join(root, "train/masks"),
                                augment=True, target_size=tsize, class_remap=remap)
    else:
        train = SegmentationDataset(os.path.join(root, "train/images"),
                                    os.path.join(root, "train/masks"),
                                    augment=True, target_size=tsize,
                                    class_remap=remap)
    val = SegmentationDataset(os.path.join(root, "val/images"),
                              os.path.join(root, "val/masks"),
                              augment=False, target_size=tsize, class_remap=remap)
    return train, val


def _report(result) -> None:
    """The best mIoU, from a rank that trained (an idle rank has none)."""
    if result["best_miou"] is not None:
        print(f"best mIoU: {result['best_miou']:.4f}")


def _run(args, run_cfg: TrainRunCfg, advanced: bool = True,
         three_class: bool = True, oversample: bool = False):
    from unet_tpu_torch.data.loader import make_train_val_loaders
    from unet_tpu_torch.models import NestedUNet

    if args.epochs:
        run_cfg = replace(run_cfg, epochs=args.epochs)
    if args.image_size:
        run_cfg = replace(run_cfg, image_size=args.image_size)
    run_cfg = replace(run_cfg, ckpt_dir=args.output, seed=args.seed)

    train_ds, val_ds = _datasets(args, run_cfg.image_size, advanced, three_class)
    train_loader, val_loader = make_train_val_loaders(
        train_ds, val_ds, args.batch, oversample_defects=oversample, seed=args.seed)
    model = NestedUNet(num_classes=run_cfg.num_classes, deep_supervision=True,
                       remat=getattr(args, "remat", False),
                       dtype=_train_dtype(args))
    result = train_model(model, train_loader, val_loader, run_cfg,
                         resume=args.resume, device=_device(args))
    _report(result)
    return 0


def recipe_basic(args):
    """Canonical trainer (reference tools/train.py): CE+Dice combo, cosine LR,
    defect oversampling x2, grad clip."""
    cfg = TrainRunCfg(
        epochs=100, num_classes=3, image_size=512, target_miou=None,
        loss=LossCfg(kind="combined", class_weights=(), weight_ce=1.0,
                     weight_dice=1.0),
        optim=OptimCfg(lr=1e-4, schedule="cosine", total_steps=0, clip_norm=1.0))
    return _run(args, cfg, advanced=False, oversample=True)


def recipe_3class_advanced(args):
    """Flagship run (reference tools/train_3class_advanced.py): Focal .35 /
    Tversky .45 (a .25 b .75) / Dice .20, weights [0.02, 1, 1], AdamW 2e-4 +
    OneCycle, accum 2, DS weights [0.1, 0.2, 0.3, 0.4], early stop 30,
    target mIoU 0.83."""
    cfg = TrainRunCfg(
        epochs=150, num_classes=3, image_size=512, early_stop_patience=30,
        target_miou=0.83,
        loss=LossCfg(kind="advanced", class_weights=(0.02, 1.0, 1.0),
                     weight_focal=0.35, weight_tversky=0.45, weight_dice=0.20,
                     tversky_alpha=0.25, tversky_beta=0.75,
                     ds_weights=(0.1, 0.2, 0.3, 0.4)),
        optim=OptimCfg(lr=2e-4, weight_decay=1e-4, schedule="onecycle",
                       total_steps=0, pct_start=0.1, div_factor=10,
                       final_div_factor=100, clip_norm=1.0, accum_steps=2))
    return _run(args, cfg)


def recipe_3class_ultra(args):
    """250-epoch cosine-restart run targeting 87% (reference
    tools/train_3class_ultra.py:1-11)."""
    cfg = TrainRunCfg(
        epochs=250, num_classes=3, image_size=512, target_miou=0.87,
        early_stop_patience=50,
        loss=LossCfg(kind="advanced", class_weights=(0.02, 1.0, 1.0)),
        optim=OptimCfg(lr=2e-4, schedule="cosine_restarts", total_steps=0,
                       restart_period=2000, accum_steps=2))
    return _run(args, cfg)


def recipe_3class_high_precision(args):
    """Dice-dominant precision run (reference tools/train_3class_high_precision.py)."""
    cfg = TrainRunCfg(
        epochs=150, num_classes=3, image_size=512, target_miou=None,
        loss=LossCfg(kind="advanced", class_weights=(0.02, 1.0, 1.0),
                     weight_focal=0.2, weight_tversky=0.3, weight_dice=0.5,
                     tversky_alpha=0.2, tversky_beta=0.8),
        optim=OptimCfg(lr=2e-4, schedule="onecycle", total_steps=0))
    return _run(args, cfg)


def recipe_3class_finetune(args):
    """Finetune-from-best at lr 1e-4 (reference tools/train_3class_finetune.py)."""
    cfg = TrainRunCfg(
        epochs=50, num_classes=3, image_size=512, target_miou=None,
        loss=LossCfg(kind="advanced", class_weights=(0.02, 1.0, 1.0)),
        optim=OptimCfg(lr=1e-4, schedule="cosine", total_steps=0))
    return _run(args, cfg)


def recipe_7class(args):
    """7-class training on the full label set (reference tools/train.py with
    num_classes=7 / train_v2.py family)."""
    cfg = TrainRunCfg(
        epochs=100, num_classes=7, image_size=256, target_miou=None,
        loss=LossCfg(kind="combined"),
        optim=OptimCfg(lr=1e-4, schedule="cosine", total_steps=0))
    return _run(args, cfg, three_class=False, oversample=True)


def recipe_overfit_test(args):
    """10-sample overfit sanity gate (reference tools/overfit_test.py)."""
    from unet_tpu_torch.models import NestedUNet
    from unet_tpu_torch.train.loop import overfit_test

    size = args.image_size or 128
    train_ds, _ = _datasets(args, size, advanced=False, three_class=True)
    model = NestedUNet(num_classes=3, deep_supervision=False)
    miou = overfit_test(model, train_ds, num_classes=3, image_size=size,
                        device=_device(args))
    ok = miou > 0.98
    print(f"overfit mIoU: {miou:.4f} -> {'PASS' if ok else 'FAIL'} "
          f"(expect > 0.98; failure suggests a data/label problem)")
    return 0 if ok else 1


RECIPES: Dict[str, Callable] = {
    "basic": recipe_basic,
    "3class_advanced": recipe_3class_advanced,
    "3class_ultra": recipe_3class_ultra,
    "3class_high_precision": recipe_3class_high_precision,
    "3class_finetune": recipe_3class_finetune,
    "7class": recipe_7class,
    "overfit_test": recipe_overfit_test,
}


def _train_dtype(args):
    """bf16 compute for training by default — the reference's AMP analogue
    (tools/train.py:115-136; params/optimizer stay f32). --train-dtype
    float32 opts out."""
    import torch
    return {"bfloat16": torch.bfloat16,
            "float32": torch.float32}[getattr(args, "train_dtype", "bfloat16")]


def _device(args) -> str:
    return getattr(args, "device", "cuda")


def run_recipe(args) -> int:
    if args.recipe not in RECIPES:
        raise SystemExit(f"unknown recipe {args.recipe!r}; "
                         f"available: {sorted(RECIPES)}")
    return RECIPES[args.recipe](args)


def recipe_with_monitoring(args):
    """Monitored trainer: loss-spike alarms + top-K worst-sample tracking
    (reference tools/train_with_monitoring.py)."""
    from unet_tpu_torch.data.loader import Loader
    from unet_tpu_torch.models import NestedUNet

    cfg = TrainRunCfg(
        epochs=args.epochs or 100, num_classes=3, image_size=args.image_size or 512,
        target_miou=None, ckpt_dir=args.output, seed=args.seed,
        track_worst_samples=10,
        loss=LossCfg(kind="combined"),
        optim=OptimCfg(lr=1e-4, schedule="cosine", total_steps=0))
    train_ds, val_ds = _datasets(args, cfg.image_size, advanced=False,
                                 three_class=True)
    train_loader = Loader(train_ds, args.batch, shuffle=True, drop_last=True,
                          seed=args.seed, with_indices=True)
    val_loader = Loader(val_ds, args.batch, prefetch=1)
    model = NestedUNet(num_classes=3, deep_supervision=True,
                       dtype=_train_dtype(args),
                       remat=getattr(args, "remat", False))
    result = train_model(model, train_loader, val_loader, cfg,
                         resume=args.resume, device=_device(args))
    _report(result)
    return 0


def recipe_binary_patch(args):
    """Binary defect patch training: defect-centred 50/50 sampling, 2-class
    (reference tools/train_binary_patch.py; inference side is
    pipeline.sliding_window)."""
    import os

    from unet_tpu_torch.data.dataset import PatchDefectDataset, SegmentationDataset
    from unet_tpu_torch.data.loader import Loader
    from unet_tpu_torch.models import NestedUNet

    size = args.image_size or 256
    root = args.data_root
    train_ds = PatchDefectDataset(os.path.join(root, "train/images"),
                                  os.path.join(root, "train/masks"),
                                  patch_size=size)
    val_ds = SegmentationDataset(os.path.join(root, "val/images"),
                                 os.path.join(root, "val/masks"),
                                 target_size=(size, size),
                                 class_remap={0: 0, 1: 0, 2: 0, 3: 1, 4: 1,
                                              5: 1, 6: 1})
    cfg = TrainRunCfg(epochs=args.epochs or 80, num_classes=2, image_size=size,
                      target_miou=None, ckpt_dir=args.output, seed=args.seed,
                      loss=LossCfg(kind="combined"),
                      optim=OptimCfg(lr=1e-4, schedule="cosine", total_steps=0))
    train_loader = Loader(train_ds, args.batch, shuffle=True, drop_last=True,
                          seed=args.seed)
    val_loader = Loader(val_ds, args.batch, prefetch=1)
    model = NestedUNet(num_classes=2, deep_supervision=True,
                       dtype=_train_dtype(args),
                       remat=getattr(args, "remat", False))
    result = train_model(model, train_loader, val_loader, cfg, resume=args.resume,
                         device=_device(args))
    _report(result)
    return 0


def recipe_inspection(args):
    """Lightweight-encoder trainer (reference tools/train_inspection.py):
    encoder selected via --encoder (stored on args by the CLI; default
    mobilenet_v3_small)."""
    from unet_tpu_torch.data.loader import make_train_val_loaders
    from unet_tpu_torch.models import LightweightNestedUNet

    size = args.image_size or 256
    cfg = TrainRunCfg(epochs=args.epochs or 100, num_classes=3, image_size=size,
                      target_miou=None, ckpt_dir=args.output, seed=args.seed,
                      loss=LossCfg(kind="combined"),
                      optim=OptimCfg(lr=1e-4, schedule="cosine", total_steps=0))
    train_ds, val_ds = _datasets(args, size, advanced=True, three_class=True)
    train_loader, val_loader = make_train_val_loaders(train_ds, val_ds,
                                                      args.batch, seed=args.seed)
    model = LightweightNestedUNet(
        num_classes=3, encoder=getattr(args, "encoder", "mobilenet_v3_small"),
        deep_supervision=True, dtype=_train_dtype(args))
    result = train_model(model, train_loader, val_loader, cfg, resume=args.resume,
                         device=_device(args))
    _report(result)
    return 0


RECIPES.update({
    "with_monitoring": recipe_with_monitoring,
    "binary_patch": recipe_binary_patch,
    "inspection": recipe_inspection,
})
