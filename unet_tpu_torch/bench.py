"""The throughput benchmark of the port (counterpart of the repository's
root bench.py), run by `python -m unet_tpu_torch.cli bench`.

Default (no args) = config 2, the headline: the 800x448 two-stage step's
frames/s on one card against the reference's 14.59 frames/s, measured at
the JAX package's own fixed operating points (`FIXED_POINTS`). `--sweep`
re-maps the batch x mode x dtype surface (slow). `--config {1..6}` selects
the other configs: 1 is one 512x512 fp32 forward on the CPU (defined on the
CPU), 3 `enhanced`, 4 `high_res_roi` at 2448x2048, 5 `wrap_7class` (and the
multi-stream server), 6 the end-to-end engine loop (mp4 decode, upload,
step, download, overlay, mp4 write).

    python -m unet_tpu_torch.cli bench [--config N] [--int8] [--sweep]
                                       [--budget-s S] [--device cuda]

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...};
each measured point goes to stderr with its peak device memory. Configs
2-5 keep the frames on the device (one upload shared by every point) and
download each batch's px counts, so they measure the step, not the host's
upload. A point that runs out of device memory (`torch.OutOfMemoryError`)
is skipped and named on stderr and in the line's `skipped`; any other
error ends the run.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import tempfile
import time
from typing import Optional, Tuple

import numpy as np
import torch

BASELINE_FPS = 14.59  # the reference's own end-to-end measurement (its README)
FRAME_W, FRAME_H = 800, 448
# the model input (w, h) of every pipeline the bench builds; None keeps each
# preset's own. The tests set a small one.
MODEL_SIZE: Optional[Tuple[int, int]] = None
# each timed run of a point covers N_FRAMES frames (at least 4 calls); a
# point is timed REPEATS times
N_FRAMES, REPEATS = 128, 3

# Best-so-far state, so that a soft-budget stop or a SIGTERM from a timeout
# wrapper still emits the JSON line with the points that completed; and the
# points skipped for memory.
_PARTIAL = {"results": [], "stem": None, "skipped": []}


def _emit_partial_and_exit(signum, _frame):
    results = _PARTIAL["results"]
    if not results or _PARTIAL["stem"] is None:
        return os._exit(124)
    best, extra = _headline(results)
    tag = "_int8" if best["dtype"] == "int8" else ""
    # one os.write of a line that starts with a newline: the signal can land
    # in the middle of another stdout line, and the JSON stays parseable
    line = json.dumps({
        "metric": f"{_PARTIAL['stem']}{tag}_fps_per_chip(batch={best['batch']})",
        "value": round(best["fps"], 2),
        "unit": "frames/sec",
        "vs_baseline": round(best["fps"] / BASELINE_FPS, 2),
        "median_fps": round(best["median"], 2),
        "partial": f"signal {signum} after {len(results)} points",
        **extra,
    })
    os.write(1, ("\n" + line + "\n").encode())
    return os._exit(0)


def _synthetic_frames(rng, batch, h=FRAME_H, w=FRAME_W):
    """Cable-scene-shaped frames (a vertical cable strip and a tape band
    over a noisy background), the reference video's content class: frames
    of pure noise would make the edge and hysteresis stages pathological."""
    bgr = rng.uniform(40, 70, (batch, h, w, 3))
    x0 = int(w * 0.425)
    bgr[:, :, x0:x0 + 60] = (175.0, 180.0, 180.0)
    bgr[:, h // 3:2 * h // 3, x0 - 8:x0 + 68] = (60.0, 90.0, 200.0)
    bgr += rng.normal(0, 4, bgr.shape)
    return np.clip(bgr, 0, 255).astype(np.uint8)


def _throughput(step, frames, batch):
    """Steady-state frames/s of `step` on `frames`, which stay where they
    are (on the card: uploaded once), after one warm-up call. Each batch's
    cable, tape and burr px counts are downloaded, which is the sync.
    Returns the (best, median) frames/s over REPEATS runs of max(N_FRAMES /
    batch, 4) calls."""
    out = step(frames)
    _ = out.cable_px.cpu()
    n_iters = max(int(round(N_FRAMES / batch)), 4)
    times = []
    for _r in range(REPEATS):
        t0 = time.perf_counter()
        outs = [step(frames) for _ in range(n_iters)]
        for o in outs:
            _ = o.cable_px.cpu(), o.tape_px.cpu(), o.burr_px.cpu()
        times.append(time.perf_counter() - t0)
        del outs
    times.sort()
    frames_total = batch * n_iters
    return frames_total / times[0], frames_total / times[len(times) // 2]


def _preset(cfg_name, preset_kwargs, fast=True):
    from unet_tpu_torch.pipeline import get_preset

    cfg = get_preset(cfg_name, **preset_kwargs)
    if fast:  # the BN-folded forward (models/fast_forward.py)
        cfg = cfg.replace_in("segment", fast_forward=True)
    if MODEL_SIZE is not None:
        cfg = cfg.replace_in("preprocess", model_size=MODEL_SIZE)
    return cfg


def _seeded_model(num_classes: int, dtype=torch.bfloat16):
    """NestedUNet with deep supervision, computing in `dtype`, flax's
    default initialisation drawn from a generator seeded with 0."""
    from unet_tpu_torch.models import NestedUNet
    from unet_tpu_torch.train.trainer import flax_init

    return flax_init(NestedUNet(num_classes=num_classes, deep_supervision=True,
                                dtype=dtype), 0).eval()


def _build_pipeline(cfg_name, preset_kwargs, frame_hw, fast=True, device="cuda"):
    """The bench paths' shared set-up. Returns (model, cfg, cfg_for), where
    cfg_for("bf16" | "int8") builds the int8-calibrated config when a point
    first needs it (calibration is set-up, not step time)."""
    from unet_tpu_torch.pipeline import stages

    cfg = _preset(cfg_name, preset_kwargs, fast)
    model = _seeded_model(cfg.segment.num_classes)
    cfgs = {"bf16": cfg}

    def cfg_for(dtype):
        if dtype not in cfgs:  # calibrated int8 (models/quantized.py)
            calib = _synthetic_frames(np.random.default_rng(7), 8,
                                      h=frame_hw[0], w=frame_hw[1])
            cfgs[dtype] = stages.calibrate_int8(model, cfg, [calib], device=device)
        return cfgs[dtype]

    return model, cfg, cfg_for


def _reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak_gib(device) -> Optional[float]:
    """Peak device memory allocated since `_reset_peak`; None off the card."""
    if torch.device(device).type != "cuda":
        return None
    return round(torch.cuda.max_memory_allocated(device) / 2 ** 30, 3)


def _out_of_memory(what: str) -> None:
    """Names a point skipped for memory and frees the allocator's cache.
    Called after the except block, whose traceback holds the point's
    tensors until it ends."""
    print(f"# {what} skipped: out of device memory", file=sys.stderr)
    _PARTIAL["skipped"].append(what)
    torch.cuda.empty_cache()


def _fixed_points(cfg_name, preset_kwargs, points,
                  frame_hw=(FRAME_H, FRAME_W), chunk=4, budget_s=None, device="cuda"):
    """Measures the fixed operating points, one step built per point and
    one frame upload shared by all. `points` = (mode, batch, dtype) tuples,
    mode in {chunked, per_batch}, dtype in {bf16, int8}. Once `budget_s`
    of wall clock is spent the remaining points are skipped, so the JSON
    line is always emitted (the first point always runs).

    Returns a list of {mode, batch, dtype, fps, median, peak_gib} dicts
    (points out of device memory skipped)."""
    from unet_tpu_torch.pipeline import stages

    t_start = time.perf_counter()
    model, _cfg, cfg_for = _build_pipeline(cfg_name, preset_kwargs, frame_hw, device=device)
    max_frames = max((chunk * b if mode == "chunked" else b) for mode, b, _ in points)
    frames_dev = torch.from_numpy(_synthetic_frames(
        np.random.default_rng(0), max_frames, h=frame_hw[0], w=frame_hw[1])).to(device)

    results = _PARTIAL["results"] = []
    for i, (mode, batch, dtype) in enumerate(points):
        t0 = time.perf_counter()
        if budget_s is not None and i > 0 and t0 - t_start > budget_s:
            print(f"# soft budget {budget_s:.0f}s spent ({t0 - t_start:.0f}s); skipping "
                  f"remaining points {points[i:]}", file=sys.stderr)
            break
        c = cfg_for(dtype)
        _reset_peak(device)
        try:
            if mode == "chunked":
                step = stages.build_chunked_step(model, c, device=device)
                fr = frames_dev[:chunk * batch].reshape((chunk, batch) + frames_dev.shape[1:])
                fps, med = _throughput(step, fr, chunk * batch)
            else:
                step = stages.build_step(model, c, device=device)
                fps, med = _throughput(step, frames_dev[:batch], batch)
        except torch.OutOfMemoryError:
            oom = True
        else:
            oom = False
        step = None
        if oom:
            _out_of_memory(f"point {mode}/b{batch}/{dtype}")
            continue
        peak = _peak_gib(device)
        print(f"# point {mode}/b{batch}/{dtype}: {fps:.1f} FPS (median {med:.1f}; wall incl "
              f"set-up {time.perf_counter() - t0:.0f}s; peak {peak} GiB)", file=sys.stderr)
        results.append({"mode": mode, "batch": batch, "dtype": dtype,
                        "fps": fps, "median": med, "peak_gib": peak})
    return results


def _headline(results):
    """Best point + per-dtype extras from a _fixed_points result list."""
    best = max(results, key=lambda r: r["fps"])
    extra = {}
    for dtype in ("bf16", "int8"):
        pts = [r for r in results if r["dtype"] == dtype]
        if pts:
            extra[f"{dtype}_fps"] = round(max(p["fps"] for p in pts), 2)
    rt = [r for r in results if r["mode"] == "per_batch"]
    if rt:
        extra["realtime_per_batch_fps"] = round(max(p["fps"] for p in rt), 2)
    return best, extra


def _pipeline_bench(cfg_name, preset_kwargs, batches=(8, 16, 32, 96, 128),
                    chunked_only_from=96, frame_hw=(FRAME_H, FRAME_W), fast=True,
                    int8=False, device="cuda"):
    """The sweep of one preset and dtype: per-batch dispatch (the engine's
    real-time mode) below `chunked_only_from`, chunked dispatch (K=4
    batches a call, the offline and serving mode) at every batch. Returns
    (best frames/s, its batch, its median)."""
    from unet_tpu_torch.pipeline import stages

    model, _cfg, cfg_for = _build_pipeline(cfg_name, preset_kwargs, frame_hw, fast=fast,
                                           device=device)
    cfg = cfg_for("int8" if int8 else "bf16")
    chunk = 4
    step = stages.build_step(model, cfg, device=device)
    chunked = stages.build_chunked_step(model, cfg, device=device)
    rng = np.random.default_rng(0)
    best = (0.0, 0, 0.0)  # (best_fps, batch, median_fps at that config)
    for batch in batches:
        frames = torch.from_numpy(_synthetic_frames(rng, chunk * batch, h=frame_hw[0],
                                                    w=frame_hw[1])).to(device)
        what = f"{cfg_name} {'int8' if int8 else 'bf16'} b{batch}"
        try:
            if batch < chunked_only_from:
                fps, med = _throughput(step, frames[:batch], batch)
                print(f"# {what}: per-batch {fps:.1f} FPS", file=sys.stderr)
                if fps > best[0]:
                    best = (fps, batch, med)
            fps, med = _throughput(chunked, frames.reshape((chunk, batch) + frames.shape[1:]),
                                   chunk * batch)
        except torch.OutOfMemoryError:
            oom = True
        else:
            oom = False
        frames = None
        if oom:
            _out_of_memory(what)
            continue
        print(f"# {what}: chunked {fps:.1f} FPS", file=sys.stderr)
        if fps > best[0]:
            best = (fps, batch, med)
    return best


def _multistream_bench(streams=8, frames_per_stream=48, device="cuda"):
    """The port's MultiStreamServer (`cli serve`): N reader threads feeding
    one fixed-slot step. Unlike the device-resident points this includes
    the host's batch assembly and upload. Returns its frames/s."""
    from unet_tpu_torch.serve import MultiStreamServer

    cfg = _preset("wrap_7class", {})
    model = _seeded_model(cfg.segment.num_classes)
    w, h = cfg.preprocess.model_size
    frames = _synthetic_frames(np.random.default_rng(3), frames_per_stream, h=h, w=w)

    class MemSource:
        def __init__(self, n):
            self.n = n

        def frames(self):
            for i in range(self.n):
                yield i + 1, frames[i % len(frames)]

    server = MultiStreamServer(model, cfg, max_in_flight=4, device=device)
    sink = lambda r: None  # noqa: E731
    server.serve([MemSource(4) for _ in range(streams)], sink)  # warm-up
    summary = server.serve([MemSource(frames_per_stream) for _ in range(streams)], sink)
    return summary["fps"]


def config1(size=512):
    """One size x size 3-class fp32 forward on the CPU (the reference's
    infer_video_simple path): frames/s of forward and argmax."""
    model = _seeded_model(3, torch.float32)
    x = torch.from_numpy(np.random.default_rng(0).random((1, size, size, 3), np.float32))
    x = x.permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        _ = model(x).argmax(1)
        t0 = time.perf_counter()
        for _ in range(3):
            _ = model(x).argmax(1)
        dt = (time.perf_counter() - t0) / 3
    return {"metric": f"single_{size}_forward_cpu", "value": round(1 / dt, 3),
            "unit": "frames/sec", "vs_baseline": None}


def config6(device="cuda", n_frames=192, warm_frames=32, batch=16):
    """End-to-end engine throughput: mp4 decode -> upload -> step ->
    download -> overlay render -> mp4 write, the loop the reference's
    14.59 frames/s measures. `two_stage` fast bf16 at b=16 over an mp4 of
    `n_frames` synthetic frames, after a warm-up over its first
    `warm_frames`."""
    import cv2

    from unet_tpu_torch.pipeline import EngineConfig, InferenceEngine

    with tempfile.TemporaryDirectory(prefix="bench_e2e_") as tmp:
        video = f"{tmp}/in.mp4"
        wr = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 30, (FRAME_W, FRAME_H))
        for f in _synthetic_frames(np.random.default_rng(0), n_frames):
            wr.write(f)
        wr.release()

        cfg = _preset("two_stage", {})
        model = _seeded_model(3)
        engine = InferenceEngine(model, cfg, EngineConfig(
            batch=batch, write_video=True, output_dir=f"{tmp}/out",
            print_interval=10 ** 9), device=device)
        engine.process_video(video, max_frames=warm_frames)
        summary = engine.process_video(video)
    return {"metric": "two_stage_e2e_engine_fps(decode+upload+overlay+write)",
            "value": summary["fps"], "unit": "frames/sec",
            "vs_baseline": round(summary["fps"] / BASELINE_FPS, 2),
            "processed": summary["processed"],
            # the engine's legs: in steady state the rate is 1000 / max(leg) ms
            "legs_ms_per_frame": summary["legs_ms_per_frame"],
            "pipelined_fps_bound": summary["pipelined_fps_bound"],
            # per-batch dispatch -> consumed latency
            "batch_latency_ms": summary["batch_latency_ms"]}


# The JAX package's fixed operating points per config: chunked dispatch at
# b96/b128 for 800x448 and the per-batch b32 real-time engine mode. The
# default run measures only these; --sweep re-maps the surface.
FIXED_POINTS = {
    2: [("chunked", 96, "int8"), ("chunked", 128, "bf16"),
        ("per_batch", 32, "int8")],
    3: [("chunked", 96, "int8"), ("chunked", 128, "bf16")],
    4: [("chunked", 8, "bf16"), ("per_batch", 4, "bf16")],
    5: [("chunked", 96, "int8"), ("chunked", 96, "bf16")],
}


def _sweep(args):
    """The batch x dtype x dispatch-mode sweep of one config."""
    tag = "_int8" if args.int8 else ""
    extra = {}
    dev = args.device
    if args.config in (2, 3):
        preset, kwargs, fmt = {
            2: ("two_stage", {}, "two_stage_800x448{}_fps_per_chip(batch={})"),
            3: ("enhanced", {"enhance": True}, "enhanced_clahe_denoise{}_fps(batch={})"),
        }[args.config]
        fps, batch, med = _pipeline_bench(preset, kwargs, int8=args.int8, device=dev)
        name = fmt.format(tag, batch)
        extra[f"{'int8' if args.int8 else 'bf16'}_fps"] = round(fps, 2)
        if not args.int8:
            fps8, batch8, med8 = _pipeline_bench(preset, kwargs, int8=True, device=dev)
            extra["int8_fps"] = round(fps8, 2)
            if fps8 > fps:
                fps, batch, med = fps8, batch8, med8
                name = fmt.format("_int8", batch)
    elif args.config == 4:
        fps, batch, med = _pipeline_bench("high_res_roi", {}, batches=(2, 4, 8),
                                          frame_hw=(2448, 2048), int8=args.int8, device=dev)
        name = f"high_res_2448x2048{tag}_fps(batch={batch})"
    else:  # 5
        fps, batch, med = _pipeline_bench("wrap_7class", {}, batches=(8, 16, 32, 96),
                                          int8=args.int8, device=dev)
        name = f"wrap_7class_batched{tag}_fps(batch={batch})"
        extra["multistream_server_fps(streams=8)"] = round(_multistream_bench(device=dev), 2)
    return fps, med, name, extra


CONFIG_NAMES = {2: ("two_stage", {}, "two_stage_800x448", (FRAME_H, FRAME_W)),
                3: ("enhanced", {"enhance": True}, "enhanced_clahe_denoise",
                    (FRAME_H, FRAME_W)),
                4: ("high_res_roi", {}, "high_res_2448x2048", (2448, 2048)),
                5: ("wrap_7class", {}, "wrap_7class_batched", (FRAME_H, FRAME_W))}


def add_arguments(ap: argparse.ArgumentParser) -> None:
    """The bench's flags (bench.py's), shared with `cli bench`."""
    ap.add_argument("--config", type=int, default=2, choices=[1, 2, 3, 4, 5, 6],
                    help="1 one 512^2 fp32 forward on the CPU; 2 two_stage (default); "
                         "3 enhanced; 4 high_res_roi 2448x2048; 5 wrap_7class and the "
                         "multi-stream server; 6 the end-to-end engine loop (mp4 decode, "
                         "upload, overlay, mp4 write)")
    ap.add_argument("--int8", action="store_true",
                    help="with --sweep: sweep the calibrated int8 forward "
                         "(models/quantized.py) instead of bf16; the default "
                         "fixed-point run always measures both dtypes")
    ap.add_argument("--sweep", action="store_true",
                    help="batch x mode x dtype sweep instead of the fixed points (slow)")
    ap.add_argument("--budget-s", type=float, default=1080.0,
                    help="soft wall-clock budget for the fixed-point run: once spent, "
                         "remaining points are skipped and the headline is emitted "
                         "from the points measured so far (the first point always runs)")


def _device_name(device) -> str:
    d = torch.device(device)
    return torch.cuda.get_device_name(d) if d.type == "cuda" else "cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="unet_tpu_torch.bench")
    add_arguments(ap)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions of the kernels")
    args = ap.parse_args(argv)
    _PARTIAL["skipped"] = []

    if args.config == 1:
        print(json.dumps({**config1(), "device": "cpu"}))
        return 0
    if args.config == 6:
        print(json.dumps({**config6(device=args.device), "device": _device_name(args.device)}))
        return 0
    if args.sweep:
        fps, med, name, extra = _sweep(args)
    else:
        preset, kwargs, stem, frame_hw = CONFIG_NAMES[args.config]
        _PARTIAL["stem"] = stem
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, _emit_partial_and_exit)
            except (ValueError, OSError):
                pass  # not the main thread
        results = _fixed_points(preset, kwargs, FIXED_POINTS[args.config],
                                frame_hw=frame_hw, budget_s=args.budget_s, device=args.device)
        # measurement done: a late signal must not emit a second line
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, signal.SIG_DFL)
            except (ValueError, OSError):
                pass
        if not results:
            print(json.dumps({"metric": f"{stem}_fps", "value": 0.0, "unit": "frames/sec",
                              "vs_baseline": 0.0, "error": "all points skipped",
                              "skipped": _PARTIAL["skipped"]}))
            return 0
        best, extra = _headline(results)
        fps, med = best["fps"], best["median"]
        tag = "_int8" if best["dtype"] == "int8" else ""
        name = f"{stem}{tag}_fps_per_chip(batch={best['batch']})"
        extra["points"] = [dict(r, fps=round(r["fps"], 2), median=round(r["median"], 2))
                           for r in results]
        if args.config == 3:
            # the documented fast denoiser (bilateral) at the headline's point
            alt = _fixed_points("enhanced", {"enhance": True, "denoise": "bilateral"},
                                [(best["mode"], best["batch"], best["dtype"])],
                                frame_hw=frame_hw, budget_s=args.budget_s, device=args.device)
            if alt:
                extra["bilateral_fps"] = round(alt[0]["fps"], 2)
        if args.config == 5:
            extra["multistream_server_fps(streams=8)"] = round(
                _multistream_bench(device=args.device), 2)

    if _PARTIAL["skipped"]:
        extra["skipped"] = _PARTIAL["skipped"]
    print(json.dumps({
        "metric": name,
        "value": round(fps, 2),
        "unit": "frames/sec",
        "vs_baseline": round(fps / BASELINE_FPS, 2),
        "median_fps": round(med, 2),
        "device": _device_name(args.device),
        **extra,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
