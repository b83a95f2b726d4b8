"""Two-rank runs of the port on the CPU for the mesh tests: `run_ranks` starts
W fresh processes (torch.multiprocessing, spawn) that join one gloo group
through a `file://` store under the test's tmp_path (no TCP port, so
parallel test workers cannot collide), calls one of this module's
functions on every rank and returns each rank's result. The functions
build what they drive from arguments saved with torch.save; this module
imports no jax, so that the ranks start quickly. The single-process
references call the same functions, with `mesh=None` or over one rank."""
import json
import time
from pathlib import Path

import torch
import torch.distributed as dist

# 3class_advanced's loss and optimizer (train.recipes.recipe_3class_advanced)
LOSS = dict(kind="advanced", class_weights=(0.02, 1.0, 1.0), weight_focal=0.35,
            weight_tversky=0.45, weight_dice=0.20, tversky_alpha=0.25, tversky_beta=0.75,
            ds_weights=(0.1, 0.2, 0.3, 0.4))
OPTIM = dict(lr=2e-4, weight_decay=1e-4, schedule="onecycle", total_steps=40, clip_norm=1.0,
             accum_steps=2)
SERVE_HW = (72, 96)


def _entry(rank, world, tmp, fn_name, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world)
    try:
        torch.save(globals()[fn_name](*args), f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_ranks(tmp_path, world: int, fn_name: str, *args):
    """[fn_name(*args) on rank r for r in range(world)], each in its own
    process of a `world`-rank gloo group."""
    import torch.multiprocessing as mp

    tmp = Path(tmp_path) / f"ranks_{fn_name}_{world}"
    tmp.mkdir()
    mp.start_processes(_entry, args=(world, str(tmp), fn_name, args), nprocs=world,
                       start_method="spawn")
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _mesh():
    from unet_tpu_torch.parallel import make_mesh

    return make_mesh(device="cpu")


# ---------------------------------------------------------------------------
# the train and eval steps
# ---------------------------------------------------------------------------

def train_case(variables, images, labels, mesh=None):
    """Two micro-steps of 3class_advanced's step (accumulation 2) on the
    NestedUNet with deep supervision and `variables`' weights, over
    `mesh`'s slice of the global (B, H, W, 3) batch (all of it without a
    mesh): each micro-step's metrics, the gradient of the first (MultiSteps'
    accumulator), the BN statistics after both, and the eval's confusion
    matrix on the same batch."""
    from unet_tpu_torch.models import NestedUNet
    from unet_tpu_torch.models.convert import state_dict_from_flax
    from unet_tpu_torch.parallel import put_batch
    from unet_tpu_torch.train import trainer as T

    model = NestedUNet(3, deep_supervision=True)
    model.load_state_dict(state_dict_from_flax(variables, "nested_unet"), strict=True)
    state = T.create_train_state(model, T.OptimCfg(**OPTIM), "cpu")
    step = T.make_train_step(T.LossCfg(**LOSS), mesh=mesh)
    if mesh is None:
        x, y = torch.from_numpy(images), torch.from_numpy(labels)
    else:
        x, y = put_batch(mesh, images, labels, local=False)
    x, y = x.float().permute(0, 3, 1, 2).contiguous(), y.long()
    names = [k for k, _ in model.named_parameters()]
    metrics, grads = [], None
    for i in range(2):
        state, m = step(state, x, y)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads = {k: g.clone() for k, g in zip(names, state.acc_grads)}
    stats = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    cm = T.make_eval_step(3, mesh=mesh)(state, x, y)
    return dict(metrics=metrics, grads=grads, stats=stats, cm=cm)


def train_ranks(path):
    """`train_case` over every rank of the group, for each case saved at
    `path` ({"variables", "cases": [(images, labels), ...]})."""
    inputs = torch.load(path, weights_only=False)
    mesh = _mesh()
    return [train_case(inputs["variables"], im, lb, mesh) for im, lb in inputs["cases"]]


# ---------------------------------------------------------------------------
# the inspection step
# ---------------------------------------------------------------------------

def pipeline_cfg(quality: bool):
    from unet_tpu_torch.pipeline import presets

    cfg = presets.two_stage().replace_in("preprocess", model_size=(64, 64))
    return cfg.replace_in("inspect", quality_stats=True) if quality else cfg


def outputs_numpy(out) -> dict:
    d = {k: getattr(out, k).cpu().numpy() for k in ("class_map", "cable_px", "tape_px",
                                                    "burr_px")}
    if out.quality is not None:
        d.update({f"quality.{k}": getattr(out.quality, k).cpu().numpy()
                  for k in out.quality._fields})
    return d


def pipeline_ranks(calls):
    """For each (frames, prev_frame_bgr, quality) of `calls`: `two_stage`
    (model 64^2, the colour->class model, quality statistics or not)
    sharded over every rank of the group on the same global frames; the
    step's ValueError where it raises one."""
    from chip_smoke import ColourClassModel
    from unet_tpu_torch.parallel import shard_pipeline_step
    from unet_tpu_torch.pipeline import stages

    mesh = _mesh()
    out = []
    for frames, prev, quality in calls:
        step = shard_pipeline_step(
            stages.build_step(ColourClassModel(), pipeline_cfg(quality), device="cpu"), mesh)
        try:
            out.append(outputs_numpy(step(frames, prev)))
        except ValueError as e:   # a batch the data axis does not divide
            out.append({"error": str(e)})
    return out


# ---------------------------------------------------------------------------
# the train loop
# ---------------------------------------------------------------------------

def loop_ranks(root: str, out: str, epochs: int, batch: int):
    """`train_model` of 3class_advanced's loss and optimizer at 32^2 over
    every rank of the group, augmentation off: the result, the history
    rank 0 logged, and how many checkpoints this rank wrote."""
    import os

    from unet_tpu_torch.data.dataset import REMAP_7_TO_3, SegmentationDataset
    from unet_tpu_torch.data.loader import Loader
    from unet_tpu_torch.models import NestedUNet
    from unet_tpu_torch.train import loop
    from unet_tpu_torch.train.trainer import LossCfg, OptimCfg

    saved = []
    save = loop.save_checkpoint
    loop.save_checkpoint = lambda *a, **kw: saved.append(kw["name"]) or save(*a, **kw)
    ds = [SegmentationDataset(os.path.join(root, f"{s}/images"), os.path.join(root, f"{s}/masks"),
                              augment=False, target_size=(32, 32), class_remap=REMAP_7_TO_3)
          for s in ("train", "val")]
    train = Loader(ds[0], batch, shuffle=True, drop_last=True, seed=3, with_indices=True)
    val = Loader(ds[1], batch, prefetch=1)
    cfg = loop.TrainRunCfg(epochs=epochs, num_classes=3, image_size=32, target_miou=None,
                           ckpt_dir=out, save_every_epochs=1, seed=5, track_worst_samples=3,
                           loss=LossCfg(**LOSS), optim=OptimCfg(**dict(OPTIM, total_steps=0)))
    torch.manual_seed(0)
    res = loop.train_model(NestedUNet(3, deep_supervision=True), train, val, cfg, device="cpu")
    hist = Path(out) / "training_history.json"
    return dict(best_miou=res["best_miou"], final_miou=res["final_miou"],
                epochs_run=res["epochs_run"], saved=saved,
                history=json.loads(hist.read_text())["history"] if hist.exists() else None,
                worst=json.loads((Path(out) / "worst_samples.json").read_text())
                if (Path(out) / "worst_samples.json").exists() else None)


# ---------------------------------------------------------------------------
# the multi-stream server
# ---------------------------------------------------------------------------

class WrapSource:
    """`n` wrap scenes of stream `sid`, frame ids 1..n."""

    def __init__(self, sid: int, n: int):
        self.sid, self.n = sid, n

    def frames(self):
        from chip_smoke import wrap_scenes

        for i in range(self.n):
            yield i + 1, wrap_scenes(1, *SERVE_HW, seed=100 * self.sid + i)[0]


def serve_results(n_streams: int, n_frames: int, mesh=None) -> dict:
    """{(stream, frame): (cable, tape, burr, dc, dt, class map)} of
    `MultiStreamServer` on wrap_uniformity at model 32^2 with the
    colour->class model, over `mesh` (rank 0's results; {} elsewhere)."""
    from chip_smoke import ColourClassModel
    from unet_tpu_torch.pipeline import presets
    from unet_tpu_torch.serve import MultiStreamServer

    cfg = presets.wrap_uniformity().replace_in("preprocess", model_size=(32, 32))
    server = MultiStreamServer(ColourClassModel(), cfg, mesh=mesh, return_class_map=True,
                               device="cpu")
    got = {}

    def sink(r):
        key = (r.stream_id, r.frame_id)
        assert key not in got, f"{key} processed twice"
        got[key] = (r.cable_px, r.tape_px, r.burr_px, r.dc_px, r.dt_px, r.class_map)

    t = time.time()
    stats = server.serve([WrapSource(i, n_frames) for i in range(n_streams)], sink)
    return dict(results=got, stats=stats, seconds=time.time() - t)


def serve_ranks(n_streams: int, n_frames: int) -> dict:
    return serve_results(n_streams, n_frames, _mesh())
