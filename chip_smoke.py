"""Drive the PyTorch/CUDA port (unet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result line:
  1. device: needs CUDA (no CPU fallback); prints the card's name and power
     limit as nvidia-smi reports them
  2. build: compiles every kernel of the path from csrc/ with nvcc (one
     process per source, all started together)
  3. kernels: each kernel against its plain PyTorch version on the card, bit
     for bit, on the masks of tests/test_cc_pallas.py, on noise and
     serpentine masks at the main path's shapes, and on the inputs the main
     path gives it, at truncated and full `max_iters`; times each
  4. slice: the two_stage step at full width (NestedUNet 3-class, 512^2
     model input, 800x448 frames, fp32 without TF32, weights from a numpy
     seed); the main path with a fixed colour->class model, whose outputs
     must equal the same step on the CPU; launch counts; ms per batch and
     frames/s at b=8 and b=32
Then, on the last two lines, the kernels' JSON record and
{"ok": true, "device": {...}}.

The scene generator and the colour->class model live here so the CPU
tests (tests/test_torch_pipeline.py) drive the same inputs.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn as nn

MEM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
INT_OPS_PER_S = 67e12        # H100 SXM non-tensor-core fp32 peak, used for int32 min/compare


# ---------------------------------------------------------------------------
# inputs shared with the CPU tests
# ---------------------------------------------------------------------------

def synthetic_frames(batch: int, h: int, w: int, seed: int = 0,
                     patch: int = 16) -> np.ndarray:
    """(batch, h, w, 3) uint8 BGR cable scenes: textured background, a
    vertical cable strip inside the two_stage ROI, a tape band, and textured
    patches inside the cable that the burr stage finds (a fixed
    colour->class model reads them as holes, whose dense Canny edges survive
    close/open and the CC gates)."""
    out = np.empty((batch, h, w, 3), np.uint8)
    x1, x2 = int(w * 0.35), int(w * 0.45)
    for i in range(batch):
        r = np.random.default_rng(seed + i)
        bgr = r.uniform(40, 70, (h, w, 3))
        bgr[:, x1:x2] = (180, 180, 175)
        ty = (h // 3, h // 2)
        bgr[ty[0]:ty[1], x1 - 4:x2 + 4] = (60, 90, 200)
        yy, xx = np.mgrid[0:patch, 0:patch]
        checker = np.where((yy // 3 + xx // 3) % 2 == 0, 10, 150)[..., None]
        px = (x1 + x2 - patch) // 2
        for _ in range(4):
            py = int(r.integers(4, h - patch - 4))
            bgr[py:py + patch, px:px + patch] = checker
        bgr += r.normal(0, 6, (h, w, 3))
        out[i] = np.clip(bgr, 0, 255).astype(np.uint8)
    return out


class ColourClassModel(nn.Module):
    """Fabricated logits: a fixed colour -> class map on the model input
    (B, 3, h, w) RGB in [0, 1]. Bright grey is cable, red is tape; comparisons
    only, so the JAX twin in the tests gives the same classes bit for bit."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cable = (x[:, 0] > 0.6) & (x[:, 2] > 0.6)
        tape = (x[:, 0] > 0.6) & (x[:, 2] < 0.4) & ~cable
        cls = torch.where(tape, 2, torch.where(cable, 1, 0))
        return nn.functional.one_hot(cls, 3).permute(0, 3, 1, 2).float() * 10.0


def seeded_nested_unet(num_classes: int = 3, seed: int = 0) -> nn.Module:
    """NestedUNet with He-normal convs and non-trivial BN statistics, all
    drawn from numpy's generator with `seed`."""
    from unet_tpu_torch.models import NestedUNet

    model = NestedUNet(num_classes=num_classes, deep_supervision=False)
    r = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v
            continue
        if v.ndim == 4:
            a = r.normal(0, np.sqrt(2.0 / (v.shape[1] * v.shape[2] * v.shape[3])), v.shape)
        elif k.endswith("running_var"):
            a = r.uniform(0.5, 1.5, v.shape)
        elif k.endswith("running_mean") or k.endswith("bias"):
            a = r.normal(0, 0.1, v.shape)
        else:  # BN weight
            a = r.uniform(0.8, 1.2, v.shape)
        sd[k] = torch.from_numpy(a.astype(np.float32))
    model.load_state_dict(sd)
    return model.eval()


# ---------------------------------------------------------------------------
# chip phases
# ---------------------------------------------------------------------------

def _log(msg: str) -> None:
    print(msg, flush=True)


def _time_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _test_masks(rng):
    """The masks of tests/test_cc_pallas.py::_masks."""
    H, W = 64, 128
    noise = rng.random((2, H, W)) < 0.35
    snake = np.zeros((1, H, W), bool)
    snake[0, 10:12, 5:100] = True
    snake[0, 12:40, 98:100] = True
    snake[0, 40:42, 20:100] = True
    blobs = np.zeros((1, H, W), bool)
    blobs[0, 5:15, 5:25] = True
    blobs[0, 30:34, 60:90] = True
    blobs[0, 0:3, 125:128] = True
    return [noise, snake, blobs, np.zeros((1, H, W), bool)]


def _serpentine(b: int, h: int, w: int) -> np.ndarray:
    m = np.zeros((b, h, w), bool)
    for i, r in enumerate(range(1, h - 1, 4)):
        m[:, r, 1:w - 1] = True
        c = w - 2 if i % 2 == 0 else 1
        m[:, r:r + 4, c] = True
    return m


def _iterations(state0, fg, pool_iters, max_iters, connectivity=8) -> int:
    """Outer iterations the reference loop runs on these inputs: one more
    than the last iteration that changed anything, capped at max_iters
    (binary search with the plain version)."""
    from unet_tpu_torch.ops import cc_kernels
    kw = dict(pool_iters=pool_iters, connectivity=connectivity)
    final = cc_kernels.propagate_plain(state0, fg, max_iters=max_iters, **kw)
    lo, hi = 0, max_iters          # smallest k whose output equals final
    while lo < hi:
        mid = (lo + hi) // 2
        if torch.equal(cc_kernels.propagate_plain(state0, fg, max_iters=mid, **kw), final):
            hi = mid
        else:
            lo = mid + 1
    return min(max_iters, lo + 1)


def _bound_ms(state0, fg, pool_iters, iters):
    """Least time for the work, and what bounds it: each input read once and
    the output written once at the HBM rate, or the min/compare operations
    this run needs (8 per pixel per pool sweep, 4 per pixel for the run-min
    passes, per channel per iteration) at the card's non-tensor peak."""
    B, C, H, W = state0.shape
    bytes_ms = (2 * state0.numel() * 4 + fg.numel()) / MEM_BYTES_PER_S * 1e3
    ops_ms = B * C * H * W * (8 * pool_iters + 4) * iters / INT_OPS_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms > bytes_ms else (bytes_ms, "bytes")


def phase_kernels(recorded):
    """Kernel vs plain version, bit for bit; timing at the main path's
    inputs. `recorded` holds the (state0, fg, kwargs) of each main-path call.
    Returns (per-launch records, max abs error seen)."""
    from unet_tpu_torch.ops import cc, cc_kernels

    max_err = 0
    n = 0

    def check(state0, fg, what, **kw):
        nonlocal max_err, n
        got = cc_kernels.propagate(state0, fg, **kw)
        want = cc_kernels.propagate_plain(state0, fg, **kw)
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        max_err = max(max_err, err)
        n += 1
        if err:
            raise AssertionError(f"cc_propagate != plain on {what} {kw}: max abs err {err}")

    rng = np.random.default_rng(1234)
    for i, m in enumerate(_test_masks(rng) + [_serpentine(1, 64, 128)]):
        fg = torch.from_numpy(m).cuda()
        for mi in (1, 2, 64):
            check(cc._bbox_seed_state(fg), fg, f"test mask {i}", pool_iters=4, max_iters=mi)
    for name, m in (("noise", rng.random((8, 448, 384)) < 0.35),
                    ("serpentine", _serpentine(8, 448, 384))):
        fg = torch.from_numpy(m).cuda()
        seed = np.where(rng.random(m.shape) < 0.1, 0, 1).astype(np.int32)[:, None]
        for mi in (1, 2, 16):   # hysteresis shape: strong=0 / weak=1 seeds
            check(torch.from_numpy(seed).cuda(), fg, f"{name} (8,1,448,384)",
                  pool_iters=16, max_iters=mi)
        for mi in (1, 2, 64):   # CC filter shape: label/bbox seeds
            check(cc._bbox_seed_state(fg), fg, f"{name} (8,4,448,384)",
                  pool_iters=4, max_iters=mi)
    per_launch = []
    for site, (state0, fg, kw) in recorded.items():
        for mi in (1, 2, kw["max_iters"]):
            check(state0, fg, f"main-path {site}", **dict(kw, max_iters=mi))
        iters = _iterations(state0, fg, kw["pool_iters"], kw["max_iters"],
                            kw.get("connectivity", 8))
        ms = _time_ms(lambda: cc_kernels.propagate(state0, fg, **kw), reps=10)
        plain_ms = _time_ms(lambda: cc_kernels.propagate_plain(state0, fg, **kw), reps=3)
        bound, bound_by = _bound_ms(state0, fg, kw["pool_iters"], iters)
        per_launch.append(dict(site=site, shape=list(state0.shape), iterations=iters,
                               ms=ms, plain_ms=plain_ms, bound_ms=bound,
                               bound_by=bound_by, **kw))
        _log(f"kernel cc_propagate {site} {tuple(state0.shape)} pool {kw['pool_iters']} "
             f"max {kw['max_iters']} ({iters} iterations run): {ms:.4f} ms/launch, "
             f"plain {plain_ms:.4f} ms, bound {bound:.5f} ms ({bound_by})")
    _log(f"kernels: {n} comparisons with the plain version, all bit-identical")
    return per_launch, max_err


def _record_main_path_inputs(step, frames):
    """Run the step once, keeping a copy of every cc_propagate input."""
    from unet_tpu_torch.ops import cc_kernels

    recorded = {}
    real = cc_kernels.propagate

    def spy(state0, fg, **kw):
        site = "hysteresis" if state0.shape[1] == 1 else "cc_filter"
        recorded[site] = (state0.clone(), fg.clone(), kw)
        return real(state0, fg, **kw)

    cc_kernels.propagate = spy
    try:
        step(frames)
    finally:
        cc_kernels.propagate = real
    return recorded


def _check_outputs(out, b, h, w, what):
    if tuple(out.class_map.shape) != (b, h, w) or out.class_map.dtype != torch.uint8:
        raise AssertionError(f"{what}: class_map {tuple(out.class_map.shape)} {out.class_map.dtype}")
    if int(out.class_map.max()) > 3:
        raise AssertionError(f"{what}: class ids above 3")
    for name in ("cable_px", "tape_px", "burr_px"):
        v = getattr(out, name)
        if tuple(v.shape) != (b,) or int(v.min()) < 0 or int(v.max()) > h * w:
            raise AssertionError(f"{what}: {name} out of range: {v.tolist()}")


def _conv_gflop(model: nn.Module, hw) -> float:
    """GFLOP (2 x multiply-adds) of every convolution in one frame's forward
    at `hw`, counted from the layers' output shapes."""
    total = 0

    def hook(m, inp, out):
        nonlocal total
        total += (2 * out.numel() * (m.in_channels // m.groups)
                  * m.kernel_size[0] * m.kernel_size[1])

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, nn.Conv2d)]
    with torch.inference_mode():
        model(torch.zeros(1, 3, *hw, device=next(model.parameters()).device))
    for h in hooks:
        h.remove()
    return total / 1e9


def _profile_step(step, frames, step_ms: float) -> None:
    """Device busy time over one step (torch.profiler with CUDA activity),
    its share of `step_ms` (the same step timed without the profiler), and
    the kernels that take the time. Diagnostic only: a profiler that records
    no device time is reported, not treated as a fault of the port."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(frames)
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA")]
    dev = lambda e: getattr(e, "self_device_time_total", 0) or 0
    busy = sum(dev(e) for e in evts)
    if busy <= 0:
        _log("profile: the profiler recorded no device time")
        return
    _log(f"profile (one b={frames.shape[0]} step): device busy {busy / 1e3:.3f} ms of "
         f"{step_ms:.3f} ms per step, idle share {max(0.0, 1 - busy / 1e3 / step_ms):.4f}")
    for e in sorted(evts, key=dev, reverse=True)[:12]:
        _log(f"  {dev(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")


def main() -> int:
    t_start = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the GPU "
              "and this script has no CPU fallback", file=sys.stderr)
        return 1
    from unet_tpu_torch import _build
    from unet_tpu_torch.ops import cc_kernels
    from unet_tpu_torch.pipeline import presets, stages

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    _log(f"device: {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
         f"cuda {torch.version.cuda} | count {torch.cuda.device_count()}")
    _log(card)

    t = time.time()
    built = _build.build_all(["cc_propagate"])
    _log(f"build: {len(built)} kernel source(s) in {time.time() - t:.1f} s")
    for name, (path, log) in built.items():
        _log(f"  {name}: {path.name}\n" + "\n".join("    " + l for l in log.splitlines()))

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = presets.two_stage()
    H, W = 448, 800

    # -- the main path: fabricated logits so cable, tape and burr candidates exist
    colour_cuda = stages.build_step(ColourClassModel(), cfg, device="cuda")
    frames8 = torch.from_numpy(synthetic_frames(8, H, W, seed=0)).cuda()
    recorded = _record_main_path_inputs(colour_cuda, frames8)
    torch.cuda.synchronize()
    cc_kernels.launches = 0
    out = colour_cuda(frames8)
    torch.cuda.synchronize()
    launches = cc_kernels.launches
    _log(f"main path (two_stage, colour->class model, b=8, 800x448, model 512^2): "
         f"cc_propagate launches {launches}")
    if launches != 2:
        raise AssertionError(f"expected 2 cc_propagate launches per batch, got {launches}")
    _check_outputs(out, 8, H, W, "colour run")
    t = time.time()
    ref = stages.build_step(ColourClassModel(), cfg, device="cpu")(frames8.cpu())
    _log(f"  same step on the CPU (plain versions): {time.time() - t:.1f} s")
    for name in ("class_map", "cable_px", "tape_px", "burr_px"):
        if not torch.equal(getattr(out, name).cpu(), getattr(ref, name)):
            raise AssertionError(f"colour run: {name} differs between cuda and cpu")
    _log(f"  cuda == cpu for class_map and px counts; burr_px {out.burr_px.tolist()}, "
         f"cable_px {out.cable_px.tolist()}")
    if int(out.burr_px.sum()) == 0:
        raise AssertionError("colour run found no burr: the CC filter path was not exercised")

    # -- kernels against their plain versions, and their times
    per_launch, max_err = phase_kernels(recorded)

    # -- NestedUNet at full width
    model = seeded_nested_unet()
    x1 = stages.model_input(stages.geometric_preprocess(frames8[:1].cpu(), cfg),
                            cfg).permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        want = model(x1)
        got = model.cuda()(x1.cuda()).cpu()
    err = float((got - want).abs().max())
    agree = float((got.argmax(1) == want.argmax(1)).float().mean())
    _log(f"NestedUNet 512^2 logits cuda vs cpu: max abs err {err:.3e}, argmax agreement {agree:.6f}")
    if not torch.allclose(got, want, atol=1e-3, rtol=1e-3):
        raise AssertionError(f"NestedUNet cuda logits differ from cpu by {err}")
    step = stages.build_step(model, cfg, device="cuda")
    gflop = _conv_gflop(model, (512, 512))
    _log(f"NestedUNet 512^2 forward: {gflop:.2f} GFLOP per frame (convolutions)")
    timings = {}
    for b in (8, 32):
        frames = torch.from_numpy(synthetic_frames(b, H, W, seed=10)).cuda()
        torch.cuda.synchronize()
        cc_kernels.launches = 0
        outb = step(frames)
        torch.cuda.synchronize()
        unet_launches = cc_kernels.launches
        _log(f"main path (two_stage, NestedUNet 512^2, b={b}, 800x448): "
             f"cc_propagate launches {unet_launches}")
        if unet_launches != 2:
            raise AssertionError(f"NestedUNet b={b}: expected 2 cc_propagate launches, "
                                 f"got {unet_launches}")
        if b == 8:
            launches = unet_launches
        _check_outputs(outb, b, H, W, f"NestedUNet b={b}")
        reps = 5
        t = time.perf_counter()
        for _ in range(reps):
            outb = step(frames)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) / reps * 1e3
        x = stages.model_input(stages.geometric_preprocess(frames, cfg),
                               cfg).permute(0, 3, 1, 2).contiguous()
        with torch.inference_mode():
            fwd_ms = _time_ms(lambda: model(x), reps=reps)
        _log(f"two_stage NestedUNet fp32 b={b}: {ms:.3f} ms/batch, {b / ms * 1e3:.2f} frames/s; "
             f"forward alone {fwd_ms:.3f} ms = {gflop * b / fwd_ms:.2f} TFLOP/s "
             f"(device-resident frames; "
             f"cable_px {outb.cable_px[:4].tolist()}...) [{card}]")
        timings[b] = dict(ms=ms, forward_ms=fwd_ms)
    _profile_step(step, frames, timings[32]["ms"])

    total = {k: sum(p[k] for p in per_launch) for k in ("ms", "plain_ms", "bound_ms")}
    record = {"kernels": [{
        "name": "cc_propagate",
        "route": "cuda",
        "source": "unet_tpu_torch/csrc/cc_propagate.cu",
        "replaces": "unet_tpu/ops/cc_pallas.py:169",
        "launches": launches,
        "max_abs_err": max_err,
        # ms / plain_ms / bound_ms: both main-path launches of one b=8 batch
        "ms": total["ms"], "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
        "bound_by": max(per_launch, key=lambda p: p["bound_ms"])["bound_by"],
        "library_ms": None,
        "per_launch": per_launch,
    }], "slice_ms_per_batch": timings, "card": card,
        "seconds": round(time.time() - t_start, 1)}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
