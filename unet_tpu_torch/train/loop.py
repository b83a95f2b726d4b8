"""The epoch loop of the port (counterpart of unet_tpu/train/loop.py:26-179):
train steps, eval, checkpoints, early stop, over the mesh (one device is a
1x1 mesh, as in the JAX package).

As the JAX package's loop: the schedule's length defaults to the run's
micro-steps; the eval pads a ragged last batch to the batch size with
label == num_classes, which the confusion matrix drops; `best`, periodic
`epoch_{n}` and `last` checkpoints with their sidecars; the history
(`training_history.json`), top-K worst samples (`worst_samples.json`),
target mIoU and early stop. A resume restores `last` and the data's host
generators, so that it goes on as the unbroken run would have.

Over W ranks (`torchrun --nproc-per-node W`, parallel.mesh) the data axis
is the largest divisor of the batch size that is at most W (ranks beyond
it idle); each rank loads only its slice of every train batch
(parallel.multihost.ProcessShardedLoader), and the steps are those of the
global batch, so that the logged losses and mIoU, early stop and the
target decide the same on every rank. The eval loads each global batch,
pads it, and runs its slice. Rank 0 writes the checkpoints, the history
and `worst_samples.json`; the others wait at a barrier. With augmentation
off the run equals the one-device run; with it on, each rank draws its
slice's augmentation from its own copy of the generator, in another order
than one process would. `n_spatial > 1` (the spatial train step) is
ROADMAP A15d.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from unet_tpu_torch import parallel
from unet_tpu_torch.core.checkpoint import restore_checkpoint, save_checkpoint
from unet_tpu_torch.ops.seg_metrics import metrics_from_confusion, print_metrics
from unet_tpu_torch.parallel.mesh import all_gather_batch
from unet_tpu_torch.train.monitor import EarlyStopping, SampleLossTracker, TrainingMonitor
from unet_tpu_torch.train.trainer import (LossCfg, OptimCfg, create_train_state, flax_init,
                                          make_eval_step, make_train_step, upload)


@dataclass
class TrainRunCfg:
    epochs: int = 150
    num_classes: int = 3
    image_size: int = 512
    early_stop_patience: int = 30
    target_miou: Optional[float] = 0.83     # stop when reached (:406-408)
    ckpt_dir: str = "checkpoints"
    save_every_epochs: int = 25             # periodic ckpts (:391-398)
    seed: int = 42
    n_spatial: int = 1
    track_worst_samples: int = 0            # top-K worst-loss samples per epoch
                                            # (train_with_monitoring.py:96-117)
    loss: LossCfg = field(default_factory=LossCfg)
    optim: OptimCfg = field(default_factory=OptimCfg)


def model_config(model: nn.Module, cfg: TrainRunCfg) -> dict:
    """What a checkpoint's sidecar records of the model: its `cli --arch`,
    classes, input size and compute type (cli.main.load_model reads it)."""
    from unet_tpu_torch.models import LightweightNestedUNet, NestedUNet, SimpleUNet

    if isinstance(model, NestedUNet):
        arch = "nested_unet_resnet50" if model.pretrained_encoder else "nested_unet"
    elif isinstance(model, LightweightNestedUNet):
        arch = f"lightweight:{model.encoder_name}"
    elif isinstance(model, SimpleUNet):
        arch = "simple_unet"
    else:
        arch = type(model).__name__
    return {"arch": arch, "num_classes": cfg.num_classes, "image_size": cfg.image_size,
            "dtype": str(getattr(model, "dtype", torch.float32)).replace("torch.", "")}


def _generators(loader) -> Dict[str, np.random.Generator]:
    """The host generators that decide a loader's batches: its own order
    and its dataset's draws (augmentation, crops, sampling)."""
    gens = {"loader": getattr(loader, "rng", None),
            "dataset": getattr(getattr(loader, "dataset", None), "rng", None)}
    return {k: g for k, g in gens.items() if isinstance(g, np.random.Generator)}


def train_mesh(batch_size: Optional[int], device: str) -> parallel.Mesh:
    """The data axis of a run: every rank (torchrun's, or this process
    alone), cut to the largest divisor of `batch_size` that is at most
    their number (unet_tpu/train/loop.py:45-55)."""
    mesh = parallel.make_mesh(device=device)
    n_data = mesh.size
    if batch_size:
        while n_data > 1 and batch_size % n_data != 0:
            n_data -= 1
    if n_data == mesh.size:
        return mesh
    return parallel.make_mesh(n_data=n_data, devices=mesh.ranks[:n_data], device=device)


def _to_step(images: torch.Tensor, labels: torch.Tensor):
    """A (B, H, W, 3) image and (B, H, W) label batch as the steps take it."""
    return images.float().permute(0, 3, 1, 2).contiguous(), labels.long()


def train_model(model: nn.Module, train_loader, val_loader, cfg: TrainRunCfg,
                resume: Optional[str] = None, device: str = "cuda") -> Dict[str, Any]:
    """Run the whole training on `device` ("cuda": this rank's card; see the
    module's docstring for several ranks); returns {best_miou, epochs_run,
    state, final_miou} (None and 0 on a rank outside the data axis). The
    model starts from flax's initialisation drawn with `cfg.seed`
    (train.trainer.flax_init), as the JAX package's `create_train_state`
    initialises it."""
    if cfg.n_spatial > 1:
        raise SystemExit(f"n_spatial={cfg.n_spatial}: the spatial train step is not ported "
                         f"to unet_tpu_torch yet, ROADMAP A15d")
    mesh = train_mesh(getattr(train_loader, "batch_size", None), device)
    if not mesh.member:
        print(f"rank {dist.get_rank()}: the batch size divides over {mesh.size} ranks; idle")
        return {"best_miou": None, "epochs_run": 0, "state": None, "final_miou": None}
    lead = mesh.rank == 0
    if mesh.size > 1:
        train_loader = parallel.multihost.ProcessShardedLoader(train_loader, mesh.rank,
                                                               mesh.size)
    device = mesh.device
    optim = cfg.optim
    if optim.total_steps <= 0:
        optim = replace(optim, total_steps=max(len(train_loader) * cfg.epochs, 1))
    state = create_train_state(flax_init(model, cfg.seed), optim, device)
    gens = _generators(train_loader)
    start_epoch, best_miou = 0, 0.0
    if resume:
        state, meta = restore_checkpoint(resume, state, name="last")
        start_epoch = int(meta.get("epoch", 0)) + 1
        best_miou = float(meta.get("best_miou", 0.0))
        for k, s in meta.get("rng", {}).items():
            if k in gens:
                gens[k].bit_generator.state = s
        if lead:
            print(f"resumed from {resume} at epoch {start_epoch} (best {best_miou:.4f})")

    track = cfg.track_worst_samples > 0
    train_step = make_train_step(cfg.loss, track_sample_loss=track, mesh=mesh)
    eval_step = make_eval_step(cfg.num_classes, mesh=mesh)
    monitor = TrainingMonitor(cfg.ckpt_dir) if lead else None
    stopper = EarlyStopping(cfg.early_stop_patience)
    tracker = SampleLossTracker(cfg.track_worst_samples) if track else None
    sample_names = getattr(getattr(train_loader, "dataset", None), "image_files", None)
    config = model_config(state.model, cfg)

    def save(name, epoch):
        if lead:
            save_checkpoint(cfg.ckpt_dir, state, epoch=epoch, best_miou=best_miou,
                            config=config, name=name,
                            rng={k: g.bit_generator.state for k, g in gens.items()})

    epochs_run = 0
    # defined even when the loop body never runs (resume past cfg.epochs)
    miou, precision, recall, ious = best_miou, {}, {}, {}
    for epoch in range(start_epoch, cfg.epochs):
        t0 = time.time()
        losses, gnorms = [], []
        if tracker:
            tracker.reset()
        for batch in train_loader:
            idx = None
            if len(batch) == 3:
                idx, images, labels = batch
            else:
                images, labels = batch
            state, metrics = train_step(state, *_to_step(*parallel.put_batch(mesh, images,
                                                                             labels)))
            losses.append(metrics["loss"])
            gnorms.append(metrics["grad_norm"])
            if tracker is not None and idx is not None:
                idx = all_gather_batch(mesh, torch.as_tensor(idx, device=device)).tolist()
                for i, l in zip(idx, all_gather_batch(mesh, metrics["sample_loss"]).tolist()):
                    name = (sample_names[int(i)] if sample_names is not None
                            else f"sample_{int(i)}")
                    tracker.record(float(l), name)
        train_loss = float(np.mean(torch.stack(losses).tolist())) if losses else 0.0
        gnorm = float(gnorms[-1]) if gnorms else 0.0

        cm = torch.zeros((cfg.num_classes, cfg.num_classes), dtype=torch.int64, device=device)
        val_batch = getattr(val_loader, "batch_size", None)
        for images, labels in val_loader:
            if val_batch and len(images) < val_batch:
                pad = val_batch - len(images)
                images = np.concatenate([images, np.repeat(images[-1:], pad, axis=0)], axis=0)
                labels = np.concatenate(
                    [labels, np.full((pad,) + labels.shape[1:], cfg.num_classes, labels.dtype)],
                    axis=0)
            cm += eval_step(state, *_to_step(*parallel.put_batch(mesh, images, labels,
                                                                  local=False)))
        miou, precision, recall, ious = metrics_from_confusion(cm.cpu().numpy())

        if lead:
            monitor.log_epoch(epoch, train_loss, miou, state.scheduler.get_last_lr()[0], gnorm)
            if tracker is not None and tracker.samples:
                (Path(cfg.ckpt_dir) / "worst_samples.json").write_text(
                    json.dumps({"epoch": epoch, "worst": tracker.worst()}, indent=2))
            print(f"epoch {epoch + 1}/{cfg.epochs}: loss {train_loss:.4f} "
                  f"mIoU {miou:.4f} ({time.time() - t0:.1f}s)")
        epochs_run += 1

        if miou > best_miou:
            best_miou = miou
            save("best", epoch)
            if lead:
                print(f"  new best mIoU {best_miou:.4f} -> saved")
        if (epoch + 1) % cfg.save_every_epochs == 0:
            save(f"epoch_{epoch + 1}", epoch)
        save("last", epoch)
        dist.barrier(group=mesh.group)

        if cfg.target_miou is not None and miou >= cfg.target_miou:
            if lead:
                print(f"target mIoU {cfg.target_miou} reached; stopping")
            break
        if stopper.step(miou):
            if lead:
                print(f"early stopping after {stopper.patience} stale epochs")
            break

    if lead:
        print_metrics(miou, precision, recall, ious)
    return {"best_miou": best_miou, "epochs_run": epochs_run, "state": state,
            "final_miou": miou}


def overfit_test(model: nn.Module, dataset, n_samples: int = 10, steps: int = 200,
                 num_classes: int = 3, image_size: int = 64, lr: float = 1e-3,
                 device: str = "cuda") -> float:
    """10-sample overfit sanity gate (reference tools/overfit_test.py:1-9):
    train mIoU should exceed ~0.98, which separates data and label faults
    from model faults. Returns the final train mIoU. (`image_size` sized
    the JAX package's init; the samples carry their own size.)"""
    idx = list(range(min(n_samples, len(dataset))))
    images = np.stack([dataset[i][0] for i in idx])
    labels = np.stack([dataset[i][1] for i in idx])
    state = create_train_state(
        flax_init(model, 0),
        OptimCfg(lr=lr, schedule="constant", total_steps=steps, clip_norm=10.0), device)
    step = make_train_step(LossCfg(kind="ce"))
    im, lb = upload(images, labels, device)
    for _ in range(steps):
        state, _ = step(state, im, lb)
    cm = make_eval_step(num_classes)(state, im, lb)
    miou, _, _, _ = metrics_from_confusion(cm.cpu().numpy())
    return float(miou)
