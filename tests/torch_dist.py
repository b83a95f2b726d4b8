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

def train_case(variables, images, labels, mesh=None, dtype=torch.float32):
    """Two micro-steps of 3class_advanced's step (accumulation 2) on the
    NestedUNet with deep supervision and `variables`' weights, over
    `mesh`'s block of the global (B, H, W, 3) batch (all of it without a
    mesh): each micro-step's metrics, the gradient of the first (MultiSteps'
    accumulator), the BN statistics after both, and the eval's confusion
    matrix on the same batch. `dtype` float64: the model, its parameters
    and the losses in float64."""
    from unet_tpu_torch.models import NestedUNet
    from unet_tpu_torch.models.convert import state_dict_from_flax
    from unet_tpu_torch.parallel import put_batch
    from unet_tpu_torch.train import trainer as T

    model = NestedUNet(3, deep_supervision=True)
    model.load_state_dict(state_dict_from_flax(variables, "nested_unet"), strict=True)
    model = model.to(dtype)
    model.dtype = dtype
    state = T.create_train_state(model, T.OptimCfg(**OPTIM), "cpu")
    step = T.make_train_step(T.LossCfg(**LOSS), mesh=mesh)
    if mesh is None:
        x, y = torch.from_numpy(images), torch.from_numpy(labels)
    else:
        x, y = put_batch(mesh, images, labels, local=False)
    x, y = x.to(dtype).permute(0, 3, 1, 2).contiguous(), y.long()
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

# the inspection recipe's loss and optimizer (train.recipes.recipe_inspection)
INSPECTION = dict(loss=dict(kind="combined"),
                  optim=dict(lr=1e-4, schedule="cosine", total_steps=0))


def loop_ranks(root: str, out: str, epochs: int, batch: int, n_spatial: int = 1,
               filters=None, arch: str = "nested_unet"):
    """`train_model` of 3class_advanced's loss and optimizer at 32^2 over
    every rank of the group (`TrainRunCfg.n_spatial`; the NestedUNet at
    `filters` widths, its own by default), augmentation off: the result,
    the history rank 0 logged, how many checkpoints this rank wrote, and
    the model's state after the run. `arch` "lightweight:custom": the
    inspection recipe's model (deep supervision), loss and optimizer."""
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
    lw = arch == "lightweight:custom"
    cfg = loop.TrainRunCfg(epochs=epochs, num_classes=3, image_size=32, target_miou=None,
                           ckpt_dir=out, save_every_epochs=1, seed=5, track_worst_samples=3,
                           n_spatial=n_spatial,
                           loss=LossCfg(**(INSPECTION["loss"] if lw else LOSS)),
                           optim=OptimCfg(**(INSPECTION["optim"] if lw else
                                             dict(OPTIM, total_steps=0))))
    torch.manual_seed(0)
    if lw:
        from unet_tpu_torch.models import LightweightNestedUNet

        model = LightweightNestedUNet(3, "custom", deep_supervision=True)
    else:
        model = NestedUNet(3, deep_supervision=True) if filters is None else train_net(filters)
    res = loop.train_model(model, train, val, cfg, device="cpu")
    hist = Path(out) / "training_history.json"
    return dict(best_miou=res["best_miou"], final_miou=res["final_miou"],
                epochs_run=res["epochs_run"], saved=saved,
                history=json.loads(hist.read_text())["history"] if hist.exists() else None,
                worst=json.loads((Path(out) / "worst_samples.json").read_text())
                if (Path(out) / "worst_samples.json").exists() else None,
                state=None if res["state"] is None else {
                    k: v.clone() for k, v in res["state"].model.state_dict().items()})


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


# ---------------------------------------------------------------------------
# the spatial axis
# ---------------------------------------------------------------------------

NARROW = (8, 16, 32, 64, 128)   # the NestedUNet's filters in the spatial tests


def nested_unet(num_classes: int = 3, filters=NARROW, state=None, seed: int = 0,
                dtype=torch.float32):
    """A NestedUNet of `filters` widths (the module constant patched while
    it is built), eval mode: `state`'s weights, else chip_smoke's seeded
    ones."""
    from chip_smoke import _seed_state
    from unet_tpu_torch.models import unetpp

    saved, unetpp.NB_FILTER = unetpp.NB_FILTER, tuple(filters)
    try:
        model = unetpp.NestedUNet(num_classes, deep_supervision=False, dtype=dtype)
    finally:
        unetpp.NB_FILTER = saved
    if state is None:
        return _seed_state(model, seed)
    model.load_state_dict(state)
    return model.eval()


def _whole(shape, dtype, seed: int) -> torch.Tensor:
    """The same tensor on every rank, from a seed."""
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(shape, generator=g) > 0.5
    if not dtype.is_floating_point:
        return torch.randint(-100, 100, shape, generator=g).to(dtype)
    return torch.randn(shape, generator=g).to(dtype)


def _box_rows(t: torch.Tensor, r: int, axis: int) -> torch.Tensor:
    """A same-padded box sum over 2r + 1 rows along `axis`, in float64 (an
    op whose rows read r rows each side, for `halo`)."""
    x = t.to(torch.float64).movedim(axis, 0)
    p = torch.nn.functional.pad(x.movedim(0, -1), (r, r)).movedim(-1, 0)
    return sum(p[d:d + x.shape[0]] for d in range(2 * r + 1)).movedim(0, axis)


def transport_checks(mesh) -> dict:
    """{check: bool} of parallel.spatial's transport on this rank of
    `mesh`'s spatial group, each against slicing the whole tensor: halo,
    exchange, fetch_rows, both re-splits, gather_frames and stripes_of, on
    even stripes and on stripes whose last one is shorter, in four dtypes
    and two layouts."""
    from unet_tpu_torch.parallel import spatial as sp
    from unet_tpu_torch.pipeline.stages import FrameOutputs, QualityStats

    n, i, group = mesh.spatial_size, mesh.spatial_rank, mesh.spatial_group
    out = {}
    for H in (32 * n, 16 * n + 16):      # even; the first stripe longer
        bounds = sp.stripe_bounds(H, n)
        st = sp.Stripes(bounds, i, group)
        s, e = st.start, st.end
        for k, (dtype, axis) in enumerate(((torch.float32, 2), (torch.bfloat16, 1),
                                           (torch.int8, 1), (torch.bool, 2))):
            shape = [3, 5, 7]
            shape.insert(axis, H)
            x = _whole(tuple(shape), dtype, seed=H + k)
            mine = x.narrow(axis, s, e - s)
            tag = f"H{H} {dtype} axis {axis}"
            for r in (1, 2, 5):
                got = sp.halo(lambda t: _box_rows(t, r, axis), [mine], st, r, axis)
                out[f"halo r{r} {tag}"] = torch.equal(got, _box_rows(x, r, axis).narrow(axis, s, e - s))
            wants = tuple((max(a - 3 - j, 0), min(b + 1 + j, H)) for j, (a, b) in enumerate(bounds))
            got = sp.exchange([mine, mine.clone()], st, wants, axis)
            lo, hi = wants[i]
            out[f"exchange {tag}"] = all(torch.equal(g, x.narrow(axis, lo, hi - lo)) for g in got)
            # any window, also one beyond the neighbours' rows or outside the stripe
            lo, hi = [(0, H), (H - 5, H), (1, 3), (s, e)][(i + k) % 4]
            out[f"fetch_rows {tag}"] = torch.equal(sp.fetch_rows(mine, lo, hi, st, axis),
                                                   x.narrow(axis, lo, hi - lo))
            for b in (3, 1):               # with one frame, a rank holds none
                counts = sp.frame_split(b, n)
                f0, c = counts[i]
                frames = _whole((b,) + tuple(shape[1:]), dtype, seed=7 * b + k)
                got = sp.frames_to_stripes(frames[f0:f0 + c], counts, st, axis)
                out[f"frames_to_stripes b{b} {tag}"] = torch.equal(got, frames.narrow(axis, s, e - s))
                got = sp.stripes_to_frames(frames.narrow(axis, s, e - s), counts, st, axis)
                out[f"stripes_to_frames b{b} {tag}"] = torch.equal(got, frames[f0:f0 + c])
        out[f"stripes_of H{H}"] = sp.stripes_of(e - s, i, group, n, "cpu") == st
    for b in (5, 1):
        counts = sp.frame_split(b, n)
        f0, c = counts[i]
        whole = FrameOutputs(class_map=_whole((b, 6, 4), torch.uint8, 1),
                             cable_px=_whole((b,), torch.int32, 2),
                             tape_px=_whole((b,), torch.int32, 3), burr_px=_whole((b,), torch.int32, 4),
                             quality=QualityStats(*(_whole((b,), torch.float32, 5 + j)
                                                    for j in range(3))))
        mine = None if c == 0 else type(whole)(*(
            None if v is None else (type(v)(*(u[f0:f0 + c] for u in v)) if isinstance(v, tuple)
                                    else v[f0:f0 + c]) for v in whole))
        got = sp.gather_frames(mine, counts, sp.Stripes(sp.stripe_bounds(16 * n, n), i, group),
                               torch.device("cpu"))
        out[f"gather_frames b{b}"] = (
            type(got) is FrameOutputs and got.diameters is None
            and all(torch.equal(a, w) for a, w in zip(got[:4], whole[:4]))
            and all(torch.equal(a, w) for a, w in zip(got.quality, whole.quality)))
    return out


def forward_checks(mesh, state, size: int) -> dict:
    """The striped fp32, bf16 and int8 NestedUNet forwards (NARROW filters,
    `state`'s weights) on this rank's stripe of a seeded (2, size, size, 3)
    input against the unsharded port forwards' rows: {check: bool}, and
    the fp32 logits' stripe under "fp32_stripe"."""
    import numpy as np

    from unet_tpu_torch.models import fast_forward as ff
    from unet_tpu_torch.models import quantized as q
    from unet_tpu_torch.parallel import spatial as sp

    model = nested_unet(state=state)
    x = torch.from_numpy(np.random.default_rng(size).random((2, size, size, 3), dtype=np.float32))
    st = sp.Stripes(sp.stripe_bounds(size, mesh.spatial_size), mesh.spatial_rank,
                    mesh.spatial_group)
    s, e = st.start, st.end
    xs = x[:, s:e].contiguous()
    out = {}
    with torch.inference_mode():
        nchw = lambda t: t.permute(0, 3, 1, 2).contiguous()
        got = model(nchw(xs), st)
        out["fp32"] = torch.equal(got, model(nchw(x))[:, :, s:e])
        out["fp32_stripe"] = got
        m16 = nested_unet(state=state, dtype=torch.bfloat16)
        out["bf16 model"] = torch.equal(m16(nchw(xs), st), m16(nchw(x))[:, :, s:e])
        fp = ff.prepare_fast_params(model.state_dict(), torch.bfloat16)
        out["bf16 fast"] = torch.equal(ff.nested_unet_forward_fast_striped(fp, xs, st),
                                       ff.nested_unet_forward_fast(fp, x)[:, s:e])
        qp = q.prepare_int8_params(model.state_dict(), q.calibrate(model.state_dict(), [x]))
        taps, want = {}, {}
        got = q.nested_unet_forward_int8_striped(qp, xs, st, taps=taps)
        out["int8 logits"] = torch.equal(got, q.nested_unet_forward_int8(qp, x, want)[:, s:e])
        out["int8 tensors"] = (sorted(taps) == sorted(q.TAP_NAMES) and all(
            torch.equal(taps[k], want[k].narrow(1, s * taps[k].shape[1] // (e - s),
                                                taps[k].shape[1])) for k in q.TAP_NAMES))
    return out


def leaves_numpy(out, prefix: str = "") -> dict:
    """{field path: numpy array} of every tensor of a step's outputs."""
    d = {}
    for name, v in out._asdict().items():
        if isinstance(v, torch.Tensor):
            d[prefix + name] = v.cpu().numpy()
        elif v is not None:
            d.update(leaves_numpy(v, f"{prefix}{name}."))
    return d


def zoo_net(arch: str, state, dtype: str = "float32"):
    """The 3-class model of `arch` (`cli --arch`, built by the CLI's
    `_build_model` without deep-supervision heads) with `state`'s weights,
    compute type `dtype`; eval mode."""
    from unet_tpu_torch.cli.main import _build_model

    with torch.device("meta"):   # no initialisation: the weights are loaded
        model = _build_model(3, arch, dtype, deep_supervision=False)
    model.to_empty(device="cpu").load_state_dict(state)
    return model.eval()


def spatial_step_runs(mesh, runs) -> list:
    """For each (model kwargs, cfg, frames, prev) of `runs`:
    `shard_pipeline_step(build_step(...), mesh, spatial=True)` on the CPU,
    its outputs as `leaves_numpy`; the model `zoo_net(**kwargs)` where the
    kwargs name an `arch`, else `nested_unet(**kwargs)`."""
    from unet_tpu_torch.parallel import shard_pipeline_step
    from unet_tpu_torch.pipeline import stages

    out = []
    for model_kw, cfg, frames, prev in runs:
        model = zoo_net(**model_kw) if "arch" in model_kw else nested_unet(**model_kw)
        step = shard_pipeline_step(stages.build_step(model, cfg, device="cpu"), mesh, spatial=True)
        out.append(leaves_numpy(step(frames, prev)))
    return out


def zoo_input(arch_unit: int, units: int, seed: int, width: int = 64):
    """(2, 3, units x arch_unit, width) uniform model input, the same on
    every rank."""
    g = torch.Generator().manual_seed(seed)
    return torch.rand((2, 3, units * arch_unit, width), generator=g)


def zoo_forward_checks(mesh, cases) -> list:
    """For each (arch, state, units, seed, width) of `cases`, in float32 and in
    bfloat16 (the model's compute dtype): the striped eval forward on this
    rank's stripe of `zoo_input` (units x the model's stripe unit rows)
    against the rows of the unsharded forward, {dtype: (bit for bit, the
    stripe's logits, the logits' stripe bounds)}. A width that the model's
    stride does not divide takes the lightweight decoder's general resize."""
    from unet_tpu_torch.parallel import spatial as sp

    out = []
    for arch, state, units, seed, width in cases:
        res = {}
        for dtype in ("float32", "bfloat16"):
            model = zoo_net(arch, state, dtype)
            x = zoo_input(model.stripe_unit, units, seed, width)
            st = sp.Stripes(sp.stripe_bounds(x.shape[2], mesh.spatial_size, model.stripe_unit),
                            mesh.spatial_rank, mesh.spatial_group)
            with torch.inference_mode():
                got = model(x[:, :, st.start:st.end].contiguous(), st)
                level = st.at(got.shape[2])
                want = model(x)[:, :, level.start:level.end]
            res[dtype] = (torch.equal(got, want), got, level.bounds)
        out.append(res)
    return out


def spatial_eval(mesh, model_kw, images, labels):
    """`shard_eval_step(make_eval_step(3), mesh, spatial=True)` on this
    rank's block of the global batch (`put_batch(spatial=True,
    local=False)`)."""
    from unet_tpu_torch.parallel import put_batch, shard_eval_step
    from unet_tpu_torch.train.trainer import make_eval_step

    im, lb = put_batch(mesh, images, labels, spatial=True, local=False)
    return shard_eval_step(make_eval_step(3), mesh, spatial=True)(
        nested_unet(**model_kw), im.float().permute(0, 3, 1, 2).contiguous(), lb.long())


def spatial_ranks(path):
    """Every spatial case saved at `path` on every rank of the group:
    {"transport": [n_spatial...], "forward": [(n_spatial, state, size)...],
    "steps": [(n_data, n_spatial, runs)...], "eval": [(n_data, n_spatial,
    model_kw, images, labels)...], "refuse": [(n_spatial, height)...]}; one
    mesh per shape, made once."""
    from unet_tpu_torch.parallel import make_mesh, shard_pipeline_step
    from unet_tpu_torch.pipeline import presets, stages

    cases = torch.load(path, weights_only=False)
    world = dist.get_world_size()
    meshes = {}

    def mesh(n_data, n_spatial):
        if (n_data, n_spatial) not in meshes:
            meshes[n_data, n_spatial] = make_mesh(n_data, n_spatial, device="cpu")
        return meshes[n_data, n_spatial]

    res = {"transport": [transport_checks(mesh(world // n, n)) for n in cases["transport"]],
           "forward": [forward_checks(mesh(world // n, n), state, size)
                       for n, state, size in cases["forward"]],
           "steps": [spatial_step_runs(mesh(d, n), runs) for d, n, runs in cases["steps"]],
           "eval": [spatial_eval(mesh(d, n), kw, im, lb) for d, n, kw, im, lb in cases["eval"]],
           "zoo_forward": [zoo_forward_checks(mesh(world // n, n), c)
                           for n, c in cases.get("zoo_forward", [])],
           "refuse": []}
    for n, height, arch in cases["refuse"]:
        cfg = presets.two_stage().replace_in("preprocess", model_size=(height, height))
        model = nested_unet() if arch == "nested_unet" else zoo_net(
            arch, _seeded_state(arch))
        try:
            shard_pipeline_step(stages.build_step(model, cfg, device="cpu"),
                                mesh(world // n, n), spatial=True)
            res["refuse"].append(None)
        except ValueError as e:
            res["refuse"].append(str(e))
    res["zoo"] = zoo_steps(mesh(world // n, n)) if cases["refuse"] else {}
    return res


def _seeded_state(arch: str) -> dict:
    from chip_smoke import seeded_model

    return seeded_model(arch).state_dict()


def zoo_batch(rows: int, seed: int):
    """A (2, rows, 32, 3) float32 batch and its (2, rows, 32) labels in 0..2."""
    import numpy as np

    r = np.random.default_rng(seed)
    return (r.random((2, rows, 32, 3), dtype=np.float32),
            r.integers(0, 3, (2, rows, 32)).astype(np.int64))


def zoo_steps(mesh=None, n_spatial: int = 1) -> dict:
    """The train and the eval step (`make_train_step`, `make_eval_step`,
    over `mesh` and its spatial axis on this rank's block of the global
    batch, `zoo_batch` of 16 rows a spatial rank; without a mesh the whole
    batch of `n_spatial` x 16 rows) on SimpleUNet (torch's initialisation from seed 0): one
    micro-step's loss and grad norm and the eval's confusion matrix; and
    on the ResNet50-encoder NestedUNet, whose logits are a quarter of the
    input's side, the error of each step: (type name, message)."""
    from unet_tpu_torch.models import NestedUNet, SimpleUNet
    from unet_tpu_torch.parallel import put_batch
    from unet_tpu_torch.train import trainer as T

    n = n_spatial if mesh is None else mesh.spatial_size
    images, labels = zoo_batch(16 * n, seed=n)
    if mesh is None:
        x, y = torch.from_numpy(images), torch.from_numpy(labels)
    else:
        x, y = put_batch(mesh, images, labels, local=False)
    x, y = x.permute(0, 3, 1, 2).contiguous(), y.long()
    torch.manual_seed(0)
    state = T.create_train_state(SimpleUNet(3), T.OptimCfg(**OPTIM), "cpu")
    _, m = T.make_train_step(T.LossCfg(kind="combined"), mesh=mesh)(state, x, y)
    out = {"simple_unet": dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                               cm=T.make_eval_step(3, mesh=mesh)(state, x, y))}
    resnet = T.create_train_state(NestedUNet(3, pretrained_encoder=True), T.OptimCfg(), "cpu")
    for name, step in (("train", T.make_train_step(T.LossCfg(), mesh=mesh)),
                       ("eval", T.make_eval_step(3, mesh=mesh))):
        try:
            step(resnet, x, y)
            out[f"resnet50 {name}"] = None
        except Exception as e:   # the type is what the caller compares
            out[f"resnet50 {name}"] = (type(e).__name__, str(e))
    return out


# ---------------------------------------------------------------------------
# the spatial train step
# ---------------------------------------------------------------------------

def transport_grad_checks(mesh) -> dict:
    """{check: max abs difference} of parallel.spatial's transport's
    backward on this rank of `mesh`'s spatial group, in float64: the
    gradient of a stripe's share of a weighted sum through `exchange` (two
    tensors, one collective), `halo` with one and two 3x3 convs, `up2x`
    and `resize_rows` (x2 and x4), against the rows of the unsharded op's
    gradient; even stripes and stripes whose last one is shorter."""
    import torch.nn.functional as F

    from unet_tpu_torch.models.unetpp import interpolate_rows, interpolate_slab
    from unet_tpu_torch.parallel import spatial as sp

    n, i, group = mesh.spatial_size, mesh.spatial_rank, mesh.spatial_group
    f64 = torch.float64
    out = {}

    def mine(t, s, e):
        return t[:, :, s:e].clone().requires_grad_(True)

    for H in (32 * n, 16 * n + 16):
        bounds = sp.stripe_bounds(H, n)
        st = sp.Stripes(bounds, i, group)
        s, e = st.start, st.end
        x, x2 = _whole((2, 3, H, 5), f64, H), _whole((2, 3, H, 5), f64, H + 1)
        w, w2 = _whole((2, 3, H, 5), f64, H + 2), _whole((2, 3, H, 5), f64, H + 3)
        wants = tuple((max(a - 3 - j, 0), min(b + 1 + j, H)) for j, (a, b) in enumerate(bounds))
        lo, hi = wants[i]
        xa, xb = mine(x, s, e), mine(x2, s, e)
        ga, gb = sp.exchange([xa, xb], st, wants, 2)
        ((ga * w[:, :, lo:hi]).sum() + (gb * w2[:, :, lo:hi]).sum()).backward()
        wa, wb = x.clone().requires_grad_(True), x2.clone().requires_grad_(True)
        sum((wa[:, :, l:h] * w[:, :, l:h]).sum() + (wb[:, :, l:h] * w2[:, :, l:h]).sum()
            for l, h in wants).backward()
        out[f"exchange H{H}"] = max(float((xa.grad - wa.grad[:, :, s:e]).abs().max()),
                                    float((xb.grad - wb.grad[:, :, s:e]).abs().max()))
        k1, k2 = _whole((4, 3, 3, 3), f64, H + 4), _whole((3, 4, 3, 3), f64, H + 5)
        for r, op in ((1, lambda t: F.conv2d(t, k1, padding=1)),
                      (2, lambda t: F.conv2d(F.conv2d(t, k1, padding=1), k2, padding=1))):
            xs = mine(x, s, e)
            y = sp.halo(op, [xs], st, r, 2)
            wy = _whole((2,) + tuple(y.shape[1:2]) + (H, 5), f64, H + 6 + r)
            (y * wy[:, :, s:e]).sum().backward()
            xw = x.clone().requires_grad_(True)
            (op(xw) * wy).sum().backward()
            out[f"halo conv r{r} H{H}"] = float((xs.grad - xw.grad[:, :, s:e]).abs().max())
        for name, k, fn in (("up2x", 2, lambda t: sp.up2x(t, st, 2, interpolate_rows)),
                            ("resize_rows x2", 2,
                             lambda t: sp.resize_rows(t, st, 2, 2, interpolate_slab)),
                            ("resize_rows x4", 4,
                             lambda t: sp.resize_rows(t, st, 4, 2, interpolate_slab))):
            xs = mine(x, s, e)
            y = fn(xs)
            wy = _whole((2, 3, k * H, k * 5), f64, H + 9 + k)
            (y * wy[:, :, k * s:k * e]).sum().backward()
            xw = x.clone().requires_grad_(True)
            whole = F.interpolate(xw, scale_factor=k, mode="bilinear", align_corners=True)
            (whole * wy).sum().backward()
            out[f"{name} H{H}"] = float((xs.grad - xw.grad[:, :, s:e]).abs().max())
            out[f"{name} forward H{H}"] = float((y - whole[:, :, k * s:k * e]).detach().abs().max())
    return out


def train_net(filters=NARROW, state=None, seed: int = 0, dtype=torch.float32,
              remat: bool = False, arch: str = "nested_unet"):
    """The 3-class NestedUNet with deep supervision at `filters` widths in
    train mode: `state`'s weights, else flax's initialisation drawn with
    `seed` (train.trainer.flax_init). `dtype` float64: the parameters too.
    `arch` "lightweight:custom" (deep supervision) or "simple_unet": that
    model of the zoo at its own widths instead."""
    from unet_tpu_torch.models import LightweightNestedUNet, SimpleUNet, unetpp
    from unet_tpu_torch.train.trainer import flax_init

    saved, unetpp.NB_FILTER = unetpp.NB_FILTER, tuple(filters)
    try:
        if arch == "simple_unet":
            model = SimpleUNet(3, dtype=dtype)
        elif arch == "lightweight:custom":
            model = LightweightNestedUNet(3, "custom", deep_supervision=True, dtype=dtype)
        else:
            model = unetpp.NestedUNet(3, deep_supervision=True, dtype=dtype, remat=remat)
    finally:
        unetpp.NB_FILTER = saved
    if state is None:
        flax_init(model, seed)
    else:
        model.load_state_dict(state)
    return model.double() if dtype == torch.float64 else model


def spatial_train_case(case: dict, mesh=None) -> dict:
    """Two micro-steps of the train step (td.OPTIM: accumulation 2, sample
    losses tracked) on `train_net(**case["net"])` with the loss
    `case["loss"]` (LossCfg kwargs), over this rank's block of the global
    (B, H, W, 3) batch (`put_batch(local=False)`; all of it without a mesh):
    each micro-step's metrics, the first one's gradient (MultiSteps'
    accumulator), the parameters and BN statistics after both, the eval's
    confusion matrix on the batch, and the Dice of the first micro-step's
    main logits against the labels of this block alone (no mesh: what a
    per-stripe Dice would give)."""
    from unet_tpu_torch.models import losses as L
    from unet_tpu_torch.parallel import put_batch
    from unet_tpu_torch.train import trainer as T

    model = train_net(**case["net"])
    state = T.create_train_state(model, T.OptimCfg(**OPTIM), "cpu")
    step = T.make_train_step(T.LossCfg(**case["loss"]), track_sample_loss=True, mesh=mesh)
    images, labels = case["images"], case["labels"]
    if mesh is None:
        x, y = torch.from_numpy(images), torch.from_numpy(labels)
    else:
        x, y = put_batch(mesh, images, labels, local=False)
    f64 = case["net"].get("dtype") == torch.float64
    x, y = x.to(torch.float64 if f64 else torch.float32).permute(0, 3, 1, 2).contiguous(), y.long()
    seen = []
    hook = model.final.register_forward_hook(lambda m, i, o: seen.append(o.detach()))
    names = [k for k, _ in model.named_parameters()]
    metrics, grads = [], None
    for i in range(2):
        state, m = step(state, x, y)
        metrics.append({k: v.clone() for k, v in m.items()})
        if i == 0:
            grads = {k: g.clone() for k, g in zip(names, state.acc_grads)}
    hook.remove()
    sd = model.state_dict()
    return dict(metrics=metrics, grads=grads,
                stats={k: v.clone() for k, v in sd.items() if "running" in k},
                params={k: v.clone() for k, v in model.named_parameters()},
                cm=T.make_eval_step(3, mesh=mesh)(state, x, y),
                local_dice=float(L.dice_loss(seen[0].float(), y)))


def _state_digest(tensors: dict) -> str:
    """sha256 of a dict of tensors' bytes, in key order."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def spatial_train_ranks(path):
    """Every case saved at `path` on every rank of the group, one mesh per
    shape: {"transport": [n_spatial...], "steps": [((n_data, n_spatial),
    case of spatial_train_case)...], "jax": [((n_data, n_spatial),
    (variables, images, labels))...] through `train_case` (the full-width
    model; the gradient on the mesh's first rank only, a digest of the
    parameters on every rank), "loop": [(root, out, epochs, batch,
    n_spatial, filters, arch)...] through `loop_ranks`, "mesh_of": [(batch,
    n_spatial)...] the shape `train.loop.train_mesh` picks, "digests": True
    for full-width models: each case's parameters and gradient as digests,
    the gradient whole on the group's first rank only}."""
    import hashlib

    from unet_tpu_torch.parallel import make_mesh
    from unet_tpu_torch.train.loop import train_mesh

    cases = torch.load(path, weights_only=False)
    world = dist.get_world_size()
    meshes = {}

    def mesh(shape):
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape, device="cpu")
        return meshes[shape]

    res = {"transport": [transport_grad_checks(mesh((world // n, n))) for n in cases["transport"]],
           "steps": [spatial_train_case(case, mesh(shape)) for shape, case in cases["steps"]],
           "jax": [], "loop": [], "mesh_of": []}
    if cases.get("digests"):   # full-width models: digests, the gradient whole on rank 0
        for r in res["steps"]:
            for k in ("params", "grads"):
                r[f"{k}_digest"] = _state_digest(r[k])
            r["params"] = None
            if dist.get_rank():
                r["grads"] = None
    for shape, (variables, images, labels) in cases.get("jax", []):
        r = train_case(variables, images, labels, mesh(shape))
        flat = torch.cat([v.reshape(-1) for v in r["grads"].values()])
        r["grads_digest"] = hashlib.sha256(flat.numpy().tobytes()).hexdigest()
        if dist.get_rank():
            r["grads"] = None
        res["jax"].append(r)
    for batch, n_spatial in cases.get("mesh_of", []):
        res["mesh_of"].append(train_mesh(batch, "cpu", n_spatial).shape)
    for args in cases.get("loop", []):
        res["loop"].append(loop_ranks(*args))
    return res

