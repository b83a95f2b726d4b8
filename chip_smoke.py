"""Drive the PyTorch/CUDA port (unet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result line:
  1. device: needs CUDA (no CPU fallback); prints the card's name and power
     limit as nvidia-smi reports them
  2. build: compiles every kernel of the paths from csrc/ with nvcc (one
     process per source, all started together): cc_propagate, nlm, qconv
  3. main paths, each driven once with every launch count set to 0 just
     before and read just after, with a fixed colour->class model:
     `two_stage` (b=8, 800x448; outputs equal to the same step on the CPU)
     and `enhanced` (b=8, 800x448 input turned to 448x800; class maps agree
     >= 0.999 with the CPU route at b=2). The bf16 and int8 `two_stage`
     paths are driven in phase 6. Then the geometry paths
     (`phase_geometry_paths`): `wrap_uniformity` (B1 labels the cable and
     tape at its model's 256x256, clusters of 8), `production` (two_stage
     with defect analysis: burr on its crop, then 5 label launches at
     448x800 on clusters of 16) and `three_class_full` (2 labels at
     448x800), b=8; class maps, px counts and every diameter and defect
     field against the same step on the CPU (integers equal, floats within
     1e-4); each step then timed in turns with the same config with
     geometry off, so that the difference is the geometry's cost on masks
     that hold cable and tape, and profiled. B1's sites are named by caller
     (`_cc_site`)
  4. kernels: B1 (cc_propagate) against its plain version bit for bit, on
     the masks of tests/test_cc_pallas.py, on noise and serpentine masks at
     both paths' crop shapes, on masks that cross the cluster route's stripe
     boundaries (`stripe_masks`), on a (1024, 1024) plane beyond the
     cluster's capacity (global route), and on the inputs each path gives
     it, at truncated and full `max_iters`, the global route there too; B2
     (nlm) against its plain version within rtol 2e-5 / atol 2e-3, on the
     test sizes, on every template at ragged tiles, on a noise stack with
     ragged tiles and on the three inputs the enhanced path gives it; times
     each at the main path's inputs beside its bound, B1 on both routes in
     turns, and B2 at search 1 (its fixed cost; the rest is per offset).
     B1 in label mode at 256x256 and 448x800 (noise, wrap tape, and a
     serpentine that `max_iters` 64 cuts short), each on its cluster size.
     Then B1's trace at the main-path inputs (`trace_cc`): per route, one
     and two iterations, the run-min passes alone, and the masks'
     foreground share; and the global route's sweep against the batch
     (`trace_cc_batches`)
  5. the NestedUNet (3-class, 512^2 model input, fp32, weights from a numpy
     seed): logits against the CPU through `stages.forward_logits`, which
     pins cuDNN's convs to full fp32 itself (this script sets no TF32 flag;
     the unpinned forward under PyTorch's defaults is printed beside it),
     then ms per batch and frames/s of both presets at b=8 and b=32, and a
     profile of one b=32 step of each; then `production` and
     `three_class_full` with the same weights and `wrap_uniformity` with a
     4-class NestedUNet (256^2), each at b=8 with its launch counts, ms per
     batch and a profile; then the wrap_uniformity server
     (`serve.MultiStreamServer`, `phase_serve`) at 8 and 32 streams of
     800x448 frames, with that NestedUNet and with the colour->class model
     (cable and tape on every frame): three serves of 2400 frames each,
     frames/s of each and their median, launch counts per batch, every
     (stream, frame) once and equal to the step's own result
  6. the bf16 and int8 forwards of `two_stage` with the same weights
     (`NestedUNet(dtype=bfloat16)`): `segment.fast_forward`, and the int8
     forward with scales from `stages.calibrate_int8` on the card; each
     driven at b=8 (launch counts: int8 18 qconv, 17 of them on the wgmma
     kernel and conv0_0.conv1 on the c3 kernel, + 2 cc_propagate; bf16 0 +
     2) and b=32, with ms per batch, frames/s, the forward alone and its
     TFLOP/s or TOP/s, and a profile of one b=32 step; the decoder's four
     upsamples of a b=8 forward timed alone (bf16 `upsample2x_align_corners`
     and int8 `_up_int8`, each with its device operations per call); `validate_int8`
     against the bf16 model's plain step and the int8 and bf16 class maps
     against the fp32 step's; bf16 logits against fp32 on one 512^2 frame;
     the int8 forward on the card against the CPU's (plain versions) on one
     512^2 frame, every one of its 19 int8 tensors bit for bit. Then qconv
     (`phase_qconv`) against its plain version bit for bit through the
     routed kernel (wgmma, c3 or mma.sync, each launch counted on the route
     `route` names) and the mma.sync kernel forced, on ragged, small and
     Cin-3 shapes, both forms and both compute types, and on every input
     the int8 path gave it at b=8, each timed on its route and on the
     mma.sync kernel in turns beside its bound, its plain version and
     torch._int_mm over an im2col of the same conv, with the sums over the
     wgmma route's 17 launches
Then, on the last two lines, the kernels' JSON record and
{"ok": true, "device": {...}}.

The scene generators and the colour->class model live here so the CPU
tests (tests/test_torch_pipeline.py and others) drive the same inputs.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn as nn

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and the non-tensor-core
# fp32 rate, used for fp32 arithmetic and for int32 min/compare alike
MEM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12
FP32_OPS_PER_S = 67e12
INT8_TENSOR_OPS_PER_S = 1979e12   # dense int8 tensor-core rate
SFU_PER_SM_PER_CLOCK = 16     # exp2 (MUFU) results per SM per clock on Hopper
NLM_TOL = dict(rtol=2e-5, atol=2e-3)   # the gate of tests/test_nlm_pallas.py


# ---------------------------------------------------------------------------
# inputs shared with the CPU tests
# ---------------------------------------------------------------------------

def synthetic_frames(batch: int, h: int, w: int, seed: int = 0,
                     patch: int = 16, texture: bool = True,
                     noise: float = 6.0) -> np.ndarray:
    """(batch, h, w, 3) uint8 BGR cable scenes: a background (textured, or
    flat at 55 with `texture=False`), a vertical cable strip inside the
    two_stage ROI, a tape band, textured patches inside the cable that the
    burr stage finds (a fixed colour->class model reads them as holes, whose
    dense edges survive close/open and the CC gates), and sensor noise of
    sigma `noise`. The enhanced preset's CLAHE stretches a textured, noisy
    background until every pixel is an edge; its scenes are flat with
    noise 2 (`enhanced_scenes`)."""
    out = np.empty((batch, h, w, 3), np.uint8)
    x1, x2 = int(w * 0.35), int(w * 0.45)
    for i in range(batch):
        r = np.random.default_rng(seed + i)
        bgr = r.uniform(40, 70, (h, w, 3)) if texture else np.full((h, w, 3), 55.0)
        bgr[:, x1:x2] = (180, 180, 175)
        ty = (h // 3, h // 2)
        bgr[ty[0]:ty[1], x1 - 4:x2 + 4] = (60, 90, 200)
        yy, xx = np.mgrid[0:patch, 0:patch]
        checker = np.where((yy // 3 + xx // 3) % 2 == 0, 10, 150)[..., None]
        px = (x1 + x2 - patch) // 2
        for _ in range(4):
            py = int(r.integers(4, h - patch - 4))
            bgr[py:py + patch, px:px + patch] = checker
        bgr += r.normal(0, noise, (h, w, 3))
        out[i] = np.clip(bgr, 0, 255).astype(np.uint8)
    return out


def wrap_scenes(batch: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """(batch, h, w, 3) uint8 BGR wrap scenes for the geometry presets: the
    vertical cable strip of `synthetic_frames` with tape standing out on
    both of its sides over the middle two thirds of the rows (a flank of
    25-35 % of the cable's width each side, drawn per frame), the flanks
    joined across the cable by a band of 4 % of the rows at the top, on a
    textured background with sensor noise. Rows holding both give the cable
    and tape diameters; no burr patches."""
    out = np.empty((batch, h, w, 3), np.uint8)
    x1, x2 = int(w * 0.35), int(w * 0.45)
    for i in range(batch):
        r = np.random.default_rng(seed + i)
        bgr = r.uniform(40, 70, (h, w, 3))
        bgr[:, x1:x2] = (180, 180, 175)
        t = max(2, int(round((x2 - x1) * r.uniform(0.25, 0.35))))
        y1, y2 = h // 6, 5 * h // 6
        bgr[y1:y2, x1 - t:x1] = (60, 90, 200)
        bgr[y1:y2, x2:x2 + t] = (60, 90, 200)
        bgr[y1:y1 + max(2, h // 25), x1 - t:x2 + t] = (60, 90, 200)
        bgr += r.normal(0, 6.0, (h, w, 3))
        out[i] = np.clip(bgr, 0, 255).astype(np.uint8)
    return out


def enhanced_scenes(batch: int, h: int, w: int, seed: int = 0,
                    patch: int = 16) -> np.ndarray:
    """Input of the enhanced preset, (batch, w, h, 3) uint8 BGR: the flat,
    low-noise scenes of `synthetic_frames` turned clockwise, so that the
    preset's counter-clockwise turn gives back an h x w frame with a
    vertical cable at x 0.35-0.45 w, inside its ROI (x 200-600 of 800)."""
    f = synthetic_frames(batch, h, w, seed=seed, patch=patch, texture=False, noise=2.0)
    return np.ascontiguousarray(np.rot90(f, k=-1, axes=(1, 2)))


def noisy_planes(shape, seed: int = 0) -> np.ndarray:
    """float32 planes on 0-255: a smooth pattern with a step edge plus
    sensor noise (sigma 6), so that many patches look alike and the NLM
    weights are far from 0 (on uniform noise every weight but the centre's
    underflows, and any denoiser passes)."""
    H, W = shape[-2:]
    yy, xx = np.mgrid[0:H, 0:W]
    base = 110 + 40 * np.sin(xx / 7.0) * np.cos(yy / 11.0) + 50 * (xx > W // 2)
    r = np.random.default_rng(seed)
    return np.clip(base + r.normal(0, 6, shape), 0, 255).astype(np.float32)


class ColourClassModel(nn.Module):
    """Fabricated logits: a fixed colour -> class map on the model input
    (B, 3, h, w) RGB in [0, 1]. Bright grey is cable, red is tape; comparisons
    only, so the JAX twin in the tests gives the same classes bit for bit."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cable = (x[:, 0] > 0.6) & (x[:, 2] > 0.6)
        tape = (x[:, 0] > 0.6) & (x[:, 2] < 0.4) & ~cable
        cls = torch.where(tape, 2, torch.where(cable, 1, 0))
        return nn.functional.one_hot(cls, 3).permute(0, 3, 1, 2).float() * 10.0


def seeded_nested_unet(num_classes: int = 3, seed: int = 0,
                       dtype: torch.dtype = torch.float32) -> nn.Module:
    """NestedUNet with He-normal convs and non-trivial BN statistics, all
    drawn from numpy's generator with `seed`; float32 parameters, compute
    type `dtype`."""
    from unet_tpu_torch.models import NestedUNet

    model = NestedUNet(num_classes=num_classes, deep_supervision=False, dtype=dtype)
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
    """Device ms per call of `fn`, from CUDA events around `reps` calls. A
    spin kernel of about 25 ms runs first, so that the host enqueues the
    calls while the card is busy and its per-call overhead is not timed
    (a function that synchronises, as the plain versions do, still is)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
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


def stripe_masks(seed: int = 7):
    """Masks that cross the B1 cluster route's stripe boundaries (stripes of
    ceil(H / 8) rows, 56 or 57 here): [(name, (2, H, W) bool)]. H and W are
    the crops' or off by one, so the last stripe is short and W is not
    always a multiple of 32."""
    rng = np.random.default_rng(seed)
    columns = np.zeros((2, 448, 512), bool)
    columns[:, :, ::5] = True          # runs over the whole height ...
    columns[:, -1] = True
    columns[:, 56, ::10] = False       # ... some cut on a stripe's first row
    columns[:, 111, 5::10] = False     # ... or on its last
    empty_stripe = rng.random((2, 449, 384)) < 0.8
    empty_stripe[:, 57:114] = False    # stripe 1 of 8 all background
    full_stripes = rng.random((2, 445, 384)) < 0.7
    full_stripes[:, 56:112] = True     # stripes 1 and 4 all foreground
    full_stripes[:, 224:280] = True
    return [("serpentine 448x384", _serpentine(2, 448, 384)),
            ("serpentine 445x383", _serpentine(2, 445, 383)),
            ("serpentine 449x512", _serpentine(2, 449, 512)),
            ("columns 448x512", columns),
            ("noise 0.9 445x383", rng.random((2, 445, 383)) < 0.9),
            ("noise 0.6 449x512", rng.random((2, 449, 512)) < 0.6),
            ("one stripe background 449x384", empty_stripe),
            ("two stripes foreground 445x384", full_stripes)]


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


def _nlm_weight_pairs(shape, search):
    """(pairs, updates) of NLM on a (B, H, W) stack: `updates` counts the
    pixel-offsets that update an output, B*H*W*(search^2 - 1), the centre
    left out (its weight is exp(0) = 1). Every other weight is symmetric:
    d2(p, o) sums the same squares as d2(p + o, -o), so one weight serves
    the unordered pair {p, p + o}. `pairs` counts those pairs: the
    (H - |dy|)(W - |dx|) pixel-offsets with both ends inside the plane come
    twice among the updates, the border ones whose other end lies in the
    reflect pad once."""
    B, H, W = shape
    r = search // 2
    updates = B * H * W * (search * search - 1)
    inside = B * ((search * H - r * (r + 1)) * (search * W - r * (r + 1)) - H * W)
    return updates - inside // 2, updates


def _nlm_bound_ms(x, template, search, sms, clock_hz):
    """Least time for one NLM launch on the (B, H, W) stack `x`, and what
    bounds it (`_nlm_weight_pairs` counts the work). Per weight pair: one
    exp at the SFU rate (16 per SM per clock at `clock_hz`) and 7 fp32
    operations (the difference, its square, a running box sum of one add
    and one subtract per axis, the scale); per update, 3 more (num += w * x
    as one FMA of 2 operations, den += w), all at the fp32 peak; each input
    byte read once and each output byte written once at the HBM rate.
    Returns (ms, "bytes" or "operations", the three times)."""
    pairs, updates = _nlm_weight_pairs(tuple(x.shape), search)
    parts = {
        "bytes": 2 * x.numel() * 4 / MEM_BYTES_PER_S * 1e3,
        "fp32": (7 * pairs + 3 * updates) / FP32_OPS_PER_S * 1e3,
        "exp": pairs / (sms * SFU_PER_SM_PER_CLOCK * clock_hz) * 1e3,
    }
    worst = max(parts, key=parts.get)
    return parts[worst], ("bytes" if worst == "bytes" else "operations"), parts


def phase_cc(recorded):
    """B1 against its plain version, bit for bit, on both routes; timing of
    both routes at the main paths' inputs. `recorded` maps a site
    ("two_stage/hysteresis", ...) to the (state0, fg, kwargs) of that
    main-path call. Returns (per-launch records, max abs error seen)."""
    from unet_tpu_torch.ops import cc, cc_kernels

    max_err = 0
    n = 0

    def check(state0, fg, what, fn=cc_kernels.propagate, **kw):
        nonlocal max_err, n
        got = fn(state0, fg, **kw)
        want = cc_kernels.propagate_plain(state0, fg, **kw)
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        max_err = max(max_err, err)
        n += 1
        if err:
            raise AssertionError(f"cc_propagate != plain on {what} {kw}: max abs err {err}")

    def both_callers(fg, what):
        # hysteresis shape (strong=0 / weak=1 seeds) and CC filter shape
        seed = np.where(rng.random(fg.shape) < 0.1, 0, 1).astype(np.int32)[:, None]
        for mi in (1, 2, 16):
            check(torch.from_numpy(seed).cuda(), fg, f"{what} C=1", pool_iters=16, max_iters=mi)
        for mi in (1, 2, 64):
            check(cc._bbox_seed_state(fg), fg, f"{what} C=4", pool_iters=4, max_iters=mi)

    rng = np.random.default_rng(1234)
    for i, m in enumerate(_test_masks(rng) + [_serpentine(1, 64, 128)]):
        fg = torch.from_numpy(m).cuda()
        for mi in (1, 2, 64):
            check(cc._bbox_seed_state(fg), fg, f"test mask {i}", pool_iters=4, max_iters=mi)
    for w in (384, 512):        # the two_stage and enhanced crop widths
        for name, m in (("noise", rng.random((8, 448, w)) < 0.35),
                        ("serpentine", _serpentine(8, 448, w))):
            both_callers(torch.from_numpy(m).cuda(), f"{name} (8,448,{w})")
    for name, m in stripe_masks():
        both_callers(torch.from_numpy(m).cuda(), f"stripe-boundary mask {name}")
    # a plane beyond the cluster's capacity takes the global route
    big = torch.from_numpy(rng.random((1, 1024, 1024)) < 0.5).cuda()
    before = cc_kernels.launches_global, cc_kernels.launches_cluster
    both_callers(big, "beyond-capacity plane (1,1024,1024)")
    if (cc_kernels.launches_global - before[0], cc_kernels.launches_cluster - before[1]) != (6, 0):
        raise AssertionError("the (1024, 1024) plane did not take the global route")
    # label mode (connected_components: C=1 linear-index seeds, pool 16) at
    # the geometry presets' planes, the wrap path's 256x256 on a cluster of
    # 8 and the frame-resolution 448x800 on a cluster of 16; the 448x800
    # serpentine needs more than 64 iterations, so max 64 truncates it
    for (H, W), K in (((256, 256), 8), ((448, 800), 16)):
        state0 = cc._label_seed(H, W, "cuda").expand(8, 1, H, W).contiguous()
        for name, m in (("noise", rng.random((8, H, W)) < 0.55),
                        ("wrap tape", wrap_scenes(8, H, W, seed=3)[..., 2] > 150),
                        ("serpentine", _serpentine(8, H, W))):
            fg = torch.from_numpy(m).cuda()
            before = cc_kernels.launches_per_cluster[K]
            for mi in (1, 2, 64):
                check(state0, fg, f"label mode {name} (8,{H},{W})", pool_iters=16, max_iters=mi)
            if cc_kernels.launches_per_cluster[K] - before != 3:
                raise AssertionError(f"label mode at {H}x{W} did not take a cluster of {K}")
        if H == 448 and torch.equal(
                cc_kernels.propagate_plain(state0, fg, pool_iters=16, max_iters=64),
                cc_kernels.propagate_plain(state0, fg, pool_iters=16, max_iters=256)):
            raise AssertionError("the 448x800 serpentine converged within 64 iterations")

    per_launch = []
    for site, (state0, fg, kw) in recorded.items():
        for mi in (1, 2, kw["max_iters"]):
            check(state0, fg, f"main-path {site}", **dict(kw, max_iters=mi))
        check(state0, fg, f"main-path {site}, global route", fn=cc_kernels.propagate_global, **kw)
        iters = _iterations(state0, fg, kw["pool_iters"], kw["max_iters"],
                            kw.get("connectivity", 8))
        which, K = cc_kernels.route(*state0.shape[-2:])
        new = lambda: cc_kernels.propagate(state0, fg, **kw)
        old = lambda: cc_kernels.propagate_global(state0, fg, **kw)
        # in turns, new old old new, on one card
        t = [_time_ms(fn, reps=10) for fn in (new, old, old, new)]
        ms, global_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        plain_ms = _time_ms(lambda: cc_kernels.propagate_plain(state0, fg, **kw), reps=3)
        bound, bound_by = _bound_ms(state0, fg, kw["pool_iters"], iters)
        per_launch.append(dict(site=site, shape=list(state0.shape), iterations=iters,
                               route=f"{which}{K or ''}", ms=ms, global_ms=global_ms,
                               plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by, **kw))
        _log(f"kernel cc_propagate {site} {tuple(state0.shape)} pool {kw['pool_iters']} "
             f"max {kw['max_iters']} ({iters} iterations run): route {which}{K or ''} "
             f"{ms:.4f} ms/launch [{t[0]:.4f}, {t[3]:.4f}], global route {global_ms:.4f} ms "
             f"[{t[1]:.4f}, {t[2]:.4f}], plain {plain_ms:.4f} ms, bound {bound:.5f} ms "
             f"({bound_by})")
    _log(f"kernels: cc_propagate, {n} comparisons with the plain version, all bit-identical")
    return per_launch, max_err


def trace_cc(recorded):
    """Where B1's time goes at each main-path input, on each route that
    takes the plane (global, cluster of 8, cluster of 16), from the
    wrapper's own arguments: the full call, `max_iters` 1 and 2 (their
    difference is one iteration), and `pool_iters=0, max_iters=1` (the two
    run-min passes alone). Also the mask's foreground share; the share of
    32-pixel chunks of the flat plane (one warp's pixels on one iteration of
    a global-route pool sweep, whose 1024-thread block walks the plane 1024
    pixels at a time) that hold a foreground pixel; and, for the busiest of
    the block's 32 warps, the share of the sweep's iterations on which it
    holds one (mean over planes). Returns {site: {"fg_share": x,
    "fg_chunk_share": y, "fg_busiest_warp_share": z, route: {label: ms}}}."""
    import functools

    from unet_tpu_torch.ops import cc_kernels

    out = {}
    for site, (state0, fg, kw) in recorded.items():
        H, W = state0.shape[-2:]
        P = kw["pool_iters"]
        routes = {"global": cc_kernels.propagate_global}
        for K in cc_kernels.CLUSTER_SIZES:
            if cc_kernels.cluster_fits(H, W, K):
                routes[f"cluster{K}"] = functools.partial(cc_kernels.propagate_cluster,
                                                          cluster=K)
        n = H * W
        flat = torch.zeros(fg.shape[0], -(-n // 1024) * 1024, dtype=torch.bool,
                           device=fg.device)
        flat[:, :n] = fg.reshape(fg.shape[0], -1)
        warps = flat.reshape(fg.shape[0], -1, 32, 32).any(-1)   # (plane, iteration, warp)
        rec = {"fg_share": float(fg.float().mean()),
               "fg_chunk_share": float(warps.float().mean()),
               "fg_busiest_warp_share": float(warps.float().mean(1).max(1).values.mean())}
        for name, fn in routes.items():
            t = {label: _time_ms(lambda: fn(state0, fg, **dict(kw, pool_iters=p, max_iters=m)),
                                 reps=5)
                 for label, (p, m) in (("full", (P, kw["max_iters"])), ("iter1", (P, 1)),
                                       ("iter2", (P, 2)), ("runmin1", (0, 1)))}
            t["per_iteration"] = t["iter2"] - t["iter1"]
            t["per_sweep"] = (t["iter1"] - t["runmin1"]) / P
            rec[name] = t
            _log(f"trace cc_propagate {site} {tuple(state0.shape)} fg share "
                 f"{rec['fg_share']:.4f}, chunk share {rec['fg_chunk_share']:.4f}, busiest "
                 f"warp {rec['fg_busiest_warp_share']:.4f}, {name}: full {t['full']:.4f} ms, 1 iteration "
                 f"{t['iter1']:.4f}, 2 iterations {t['iter2']:.4f} (one more: "
                 f"{t['per_iteration']:.4f}), run-min passes alone {t['runmin1']:.4f}, "
                 f"per pool sweep {t['per_sweep'] * 1e3:.2f} us")
        out[site] = rec
    return out


def trace_cc_batches(recorded):
    """The global route's pool sweep at each hysteresis site against the
    batch: the site's first b planes (b = 1, 2, 4, 8) and its batch twice
    (16). Planes run on different SMs and share only the L2, so a sweep that
    slows as the batch grows is paced by the L2 (working set: the plane, its
    ping-pong copy and the mask, 9 bytes a pixel). Returns {site: {b:
    (working set MB, us per sweep)}}."""
    from unet_tpu_torch.ops import cc_kernels

    out = {}
    for site, (state0, fg, kw) in recorded.items():
        if not site.endswith("/hysteresis"):
            continue
        P = kw["pool_iters"]
        rec = {}
        for b in (1, 2, 4, 8, 16):
            s, f = (state0[:b], fg[:b]) if b <= state0.shape[0] else (
                torch.cat([state0, state0]), torch.cat([fg, fg]))
            t = {m: _time_ms(lambda: cc_kernels.propagate_global(
                s, f, **dict(kw, pool_iters=p, max_iters=1)), reps=5)
                 for m, p in (("iter1", P), ("runmin1", 0))}
            rec[b] = (s.shape[0] * s.shape[-2] * s.shape[-1] * 9 / 1e6,
                      (t["iter1"] - t["runmin1"]) / P * 1e3)
        out[site] = rec
        _log(f"trace cc_propagate {site} global route, per pool sweep by batch: " + ", ".join(
            f"b={b} ({mb:.1f} MB) {us:.2f} us" for b, (mb, us) in rec.items()))
    return out


def phase_nlm(recorded, sms, clock_hz):
    """B2 against its plain version within NLM_TOL; timing at the enhanced
    path's inputs. `recorded` maps a site ("enhanced/nlm_L", ...) to the
    (x, h, template, search) of that main-path call. Returns (per-launch
    records, max abs error seen)."""
    from unet_tpu_torch.ops import nlm_kernels

    max_err = 0.0
    n = 0

    def check(x, h, template, search, what):
        nonlocal max_err, n
        got = nlm_kernels.nlm(x, h, template, search)
        want = nlm_kernels.nlm_plain(x, h, template, search)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        n += 1
        if not torch.allclose(got, want, **NLM_TOL):
            raise AssertionError(f"nlm != plain on {what} h={h} template={template} "
                                 f"search={search}: max abs err {err}")

    rng = np.random.default_rng(99)
    for search, template in ((9, 5), (21, 7)):       # tests/test_nlm_pallas.py sizes
        for img in ((rng.random((2, 40, 56)) * 255).astype(np.float32),
                    noisy_planes((2, 40, 56), seed=3)):
            check(torch.from_numpy(img).cuda(), 10.0, template, search,
                  "test size (2,40,56)")
    # partial tiles (64 - 2T columns by 64 rows) and strips on both axes
    ragged = torch.from_numpy(noisy_planes((2, 70, 130), seed=5)).cuda()
    for template in (1, 3, 5, 7, 9, 11):
        check(ragged, 10.0, template, 21, "noise stack (2,70,130)")
    # 474 x 826 leaves ragged tiles on both axes
    check(torch.from_numpy(noisy_planes((8, 474, 826), seed=4)).cuda(), 10.0, 7, 21,
          "noise stack (8,474,826)")
    per_launch = []
    for site, (x, h, template, search) in recorded.items():
        check(x, h, template, search, f"main-path {site} {tuple(x.shape)}")
        ms = _time_ms(lambda: nlm_kernels.nlm(x, h, template, search), reps=10)
        search1_ms = _time_ms(lambda: nlm_kernels.nlm(x, h, template, 1), reps=10)
        ns_per_offset = (ms - search1_ms) / (search * search - 1) * 1e6
        plain_ms = _time_ms(lambda: nlm_kernels.nlm_plain(x, h, template, search), reps=2)
        bound, bound_by, parts = _nlm_bound_ms(x, template, search, sms, clock_hz)
        per_launch.append(dict(site=site, shape=list(x.shape), h=h, template=template,
                               search=search, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                               bound_by=bound_by, bound_parts_ms=parts,
                               search1_ms=search1_ms, ns_per_offset=ns_per_offset))
        _log(f"kernel nlm {site} {tuple(x.shape)} h {h} template {template} search "
             f"{search}: {ms:.4f} ms/launch, plain {plain_ms:.4f} ms, bound {bound:.5f} ms "
             f"({bound_by}; exp {parts['exp']:.5f}, fp32 {parts['fp32']:.5f}, "
             f"bytes {parts['bytes']:.5f})")
        _log(f"split nlm {site}: search 1 {search1_ms:.4f} ms (staging, store, fixed cost), "
             f"search {search} {ms:.4f} ms: {ns_per_offset:.1f} ns per offset, "
             f"{ns_per_offset * 1e3 / x.numel():.4f} ps per pixel-offset")
    _log(f"kernels: nlm, {n} comparisons with the plain version, max abs err {max_err:.3e} "
         f"(gate rtol {NLM_TOL['rtol']}, atol {NLM_TOL['atol']})")
    return per_launch, max_err


_CC_CALLERS = {"hysteresis": "hysteresis", "filter_components_by_geometry": "cc_filter",
               "connected_components": "label"}
_LABEL_CALLERS = ("largest_component", "count_components", "analyze_defects")


def _cc_site(frame) -> str:
    """The B1 site a call of `cc_kernels.propagate` comes from, by its
    callers (the stack from `frame` outwards): "hysteresis" (Canny),
    "cc_filter" (the burr CC filter) or "label (<caller>)", the caller of
    `ops.cc.connected_components` being largest_component, count_components
    or analyze_defects."""
    site = None
    while frame is not None:
        name = frame.f_code.co_name
        if site is None and name in _CC_CALLERS:
            site = _CC_CALLERS[name]
            if site != "label":
                return site
        elif site == "label" and name in _LABEL_CALLERS:
            return f"label ({name})"
        frame = frame.f_back
    return site or "unknown"


def _record_main_path_inputs(step, frames, path: str):
    """Run the step once, keeping a copy of every kernel input: returns
    ({site: (state0, fg, kwargs)} for cc_propagate, sites named by caller
    (`_cc_site`) and numbered in call order where a name repeats,
    {site: (x, h, template, search)} for nlm, whose calls come as L, a, b,
    and {site: (x, wq, mult, bias)} for qconv, whose calls come as the
    blocks' conv1 and conv2 in BLOCK_NAMES order)."""
    from unet_tpu_torch.models.fast_forward import BLOCK_NAMES
    from unet_tpu_torch.ops import cc_kernels, nlm_kernels, qconv_kernels

    cc_rec, nlm_rec, q_rec = {}, {}, {}
    real_cc, real_nlm, real_q = cc_kernels.propagate, nlm_kernels.nlm, qconv_kernels.qconv

    def cc_spy(state0, fg, **kw):
        site = f"{path}/{_cc_site(sys._getframe(1))}"
        if site.startswith(f"{path}/label"):
            site = f"{path}/label {sum(k.startswith(f'{path}/label') for k in cc_rec) + 1} " \
                   + site.split("/label ")[1]
        cc_rec[site] = (state0.clone(), fg.clone(), kw)
        return real_cc(state0, fg, **kw)

    def nlm_spy(x, h, template=7, search=21):
        nlm_rec[f"{path}/nlm_{'Lab'[len(nlm_rec)]}"] = (x.clone(), h, template, search)
        return real_nlm(x, h, template, search)

    def q_spy(x, wq, mult, bias):
        i = len(q_rec)
        copy = tuple(t.clone() for t in x) if isinstance(x, tuple) else x.clone()
        q_rec[f"{path}/{BLOCK_NAMES[i // 2]}.conv{i % 2 + 1}"] = (copy, wq, mult, bias)
        return real_q(x, wq, mult, bias)

    cc_kernels.propagate, nlm_kernels.nlm, qconv_kernels.qconv = cc_spy, nlm_spy, q_spy
    try:
        step(frames)
    finally:
        cc_kernels.propagate, nlm_kernels.nlm, qconv_kernels.qconv = real_cc, real_nlm, real_q
    return cc_rec, nlm_rec, q_rec


def _drive(step, frames, expect, what):
    """One batch through `step` with every launch count set to 0 just
    before and read just after; fails unless each kernel launched exactly
    as `expect` says. Returns (outputs, counts)."""
    from unet_tpu_torch.ops import cc_kernels, nlm_kernels, qconv_kernels

    _zero_counts()
    out = step(frames)
    got = _read_counts()
    _log(f"main path ({what}): launches {got}")
    if got != expect:
        raise AssertionError(f"{what}: expected launches {expect}, got {got}")
    return out, got


def _zero_counts() -> None:
    """Every kernel wrapper's launch count set to 0 (after the card's queue
    has drained)."""
    from unet_tpu_torch.ops import cc_kernels, nlm_kernels, qconv_kernels

    torch.cuda.synchronize()
    cc_kernels.launches = cc_kernels.launches_cluster = cc_kernels.launches_global = 0
    for K in cc_kernels.launches_per_cluster:
        cc_kernels.launches_per_cluster[K] = 0
    nlm_kernels.launches = 0
    qconv_kernels.launches = qconv_kernels.launches_wgmma = qconv_kernels.launches_sync = 0
    qconv_kernels.launches_c3 = 0


def _read_counts() -> dict:
    """Every kernel wrapper's launch count, B1's also per route and per
    cluster size, qconv's per kernel."""
    from unet_tpu_torch.ops import cc_kernels, nlm_kernels, qconv_kernels

    torch.cuda.synchronize()
    return {"cc_propagate": cc_kernels.launches,
            "cc_propagate_cluster": cc_kernels.launches_cluster,
            "cc_propagate_global": cc_kernels.launches_global,
            **{f"cc_propagate_cluster{K}": n for K, n in cc_kernels.launches_per_cluster.items()},
            "nlm": nlm_kernels.launches, "qconv": qconv_kernels.launches,
            "qconv_wgmma": qconv_kernels.launches_wgmma,
            "qconv_sync": qconv_kernels.launches_sync, "qconv_c3": qconv_kernels.launches_c3}


def _check_outputs(out, b, h, w, what):
    if tuple(out.class_map.shape) != (b, h, w) or out.class_map.dtype != torch.uint8:
        raise AssertionError(f"{what}: class_map {tuple(out.class_map.shape)} {out.class_map.dtype}")
    if int(out.class_map.max()) > 3:
        raise AssertionError(f"{what}: class ids above 3")
    for name in ("cable_px", "tape_px", "burr_px"):
        v = getattr(out, name)
        if tuple(v.shape) != (b,) or int(v.min()) < 0 or int(v.max()) > h * w:
            raise AssertionError(f"{what}: {name} out of range: {v.tolist()}")


GEOMETRY_PATHS = ("wrap_uniformity", "production", "three_class_full")
GEOMETRY_ATOL = 1e-4   # float geometry fields, card vs CPU (tests/test_ops_clahe_geometry.py)


def geometry_scenes(path: str, b: int, h: int, w: int, seed: int) -> np.ndarray:
    """Frames for a geometry path: production's are two_stage's burr scenes,
    the others' wrap scenes."""
    if path == "production":
        return synthetic_frames(b, h, w, seed=seed)
    return wrap_scenes(b, h, w, seed=seed)


def _compare_outputs(got, want, what) -> float:
    """Card outputs against the CPU's: class map, px counts and every
    integer field of diameters and defects equal, every float field within
    GEOMETRY_ATOL. Returns the largest float difference."""
    err = 0.0
    for f in ("class_map", "cable_px", "tape_px", "burr_px"):
        if not torch.equal(getattr(got, f).cpu(), getattr(want, f).cpu()):
            raise AssertionError(f"{what}: {f} differs between the card and the CPU")
    for part in ("diameters", "defects"):
        g, w = getattr(got, part), getattr(want, part)
        if (g is None) != (w is None):
            raise AssertionError(f"{what}: {part} on one side only")
        for f in (g._fields if g is not None else ()):
            gv, wv = getattr(g, f).cpu(), getattr(w, f).cpu()
            if wv.is_floating_point():
                e = float((gv - wv).abs().max()) if wv.numel() else 0.0
                err = max(err, e)
                if not e <= GEOMETRY_ATOL:
                    raise AssertionError(f"{what}: {part}.{f} card vs CPU {e} > {GEOMETRY_ATOL}")
            elif not torch.equal(gv, wv):
                raise AssertionError(f"{what}: {part}.{f} differs between the card and the CPU")
    return err


def _time_in_turns(steps, frames, reps: int):
    """ms per batch of each step of `steps` ({name: step}) on the same
    frames, timed in turns a, b, b, a (`_time_step`): {name: [ms, ms]}."""
    runs = {name: [] for name in steps}
    for name in list(steps) + list(steps)[::-1]:
        runs[name].append(_time_step(steps[name], frames, reps))
    return runs


def phase_geometry_paths(cfgs, expect, H, W, device="cuda", reps=5):
    """The geometry paths with the colour->class model at b=8 on HxW frames,
    whose masks hold cable and tape: each step's B1 inputs recorded, one
    batch driven with launch counts checked (`_drive`), then the same batch
    on the CPU (plain versions): class maps, px counts and every field of
    diameters and defects held card against CPU. Then the step is timed in
    turns with the same config with geometry and defect analysis off, on
    the same frames, so that the difference is the geometry's cost on
    masks with cable and tape (and on the card, one step profiled).
    Returns (B1 inputs, {path: counts}, {check: value}, {path: times})."""
    from unet_tpu_torch.pipeline import stages

    cc_rec, counts, checks, timings = {}, {}, {}, {}
    for path in GEOMETRY_PATHS:
        cfg = cfgs[path]
        step = stages.build_step(ColourClassModel(), cfg, device=device)
        frames8 = torch.from_numpy(geometry_scenes(path, 8, H, W, seed=0)).to(device)
        cc_rec.update(_record_main_path_inputs(step, frames8, path)[0])
        out, counts[path] = _drive(step, frames8, expect[path],
                                   f"{path}, colour->class model, b=8, {W}x{H}")
        _check_outputs(out, 8, H, W, f"{path} colour run")
        d = out.diameters
        if path == "production":
            # two_stage's scenes: the tape band cuts the cable, so the
            # diameters are only held against the CPU; the burr must exist
            if int(out.burr_px.sum()) == 0:
                raise AssertionError("production colour run found no burr")
        elif not (bool((d.valid_rows >= cfg.geometry.min_valid_rows).all())
                  and bool((d.dt_px > d.dc_px).all()) and bool((d.dc_px > 0).all())):
            raise AssertionError(f"{path} colour run: no diameters ({d.dc_px.tolist()}, "
                                 f"{d.dt_px.tolist()})")
        t = time.time()
        ref = stages.build_step(ColourClassModel(), cfg, device="cpu")(frames8.cpu())
        cpu_s = time.time() - t
        checks[f"{path}_float_max_abs_err_card_vs_cpu"] = _compare_outputs(out, ref, path)
        _log(f"  {path}: card == CPU (CPU step {cpu_s:.1f} s): class_map, px counts, integer "
             f"geometry; floats within {checks[f'{path}_float_max_abs_err_card_vs_cpu']:.3e}; "
             f"dc_px {[round(v, 3) for v in d.dc_px.tolist()]}, dt_px "
             f"{[round(v, 3) for v in d.dt_px.tolist()]}"
             + (f", tape holes {out.defects.tape_num_holes.tolist()}, burr_px "
                f"{out.burr_px.tolist()}" if out.defects is not None else ""))
        bare = stages.build_step(ColourClassModel(), cfg.replace_in(
            "geometry", enabled=False, analyze_defects=False), device=device)
        runs = _time_in_turns({"with": step, "without": bare}, frames8, reps)
        ms, bare_ms = (float(np.mean(runs[k])) for k in ("with", "without"))
        timings[path] = {8: dict(ms=ms, ms_runs=runs["with"], frames_per_s=8 / ms * 1e3,
                                 without_geometry_ms=bare_ms,
                                 without_geometry_ms_runs=runs["without"],
                                 geometry_ms=ms - bare_ms)}
        _log(f"  {path} colour->class b=8: {ms:.3f} ms/batch {runs['with']}, without geometry "
             f"{bare_ms:.3f} {runs['without']}: the geometry takes {ms - bare_ms:.3f} ms "
             f"on masks with cable and tape")
        if torch.device(device).type == "cuda":
            _profile_step(step, frames8, ms, f"{path} colour->class b=8")
    return cc_rec, counts, checks, timings


class FrameListSource:
    """A stream of prepared frames for MultiStreamServer: .frames() yields
    (1-based frame id, frame)."""

    def __init__(self, frames):
        self.list = frames

    def frames(self):
        yield from enumerate(self.list, start=1)


def phase_serve(model, cfg, H, W, what, streams=(8, 32), frames_per_serve=2400, repeats=3,
                real_masks=False, device="cuda"):
    """The wrap_uniformity server (`serve.MultiStreamServer`) on `device`
    with `model` (`what` names it): for each stream count n,
    frames_per_serve // n frames a stream drawn from 8 prepared wrap scenes
    (made before the clock starts), one warm-up serve of one frame a
    stream, then `repeats` timed serves, each with every launch count set
    to 0 just before and read just after (B1: 2 launches a batch, both on a
    cluster of 8). At 2400 frames a serve lasts several seconds on the
    card. Each (stream, frame) must come back once, with finite diameters
    (with `real_masks`, a cable and a wider tape on every frame), and the
    first frames' results must equal the step's own on the same frames.
    Returns {streams: record}, with frames/s of each repeat and their
    median."""
    from unet_tpu_torch.serve import MultiStreamServer

    server = MultiStreamServer(model, cfg, device=device)
    pool = wrap_scenes(8, H, W, seed=50)
    out = {}
    for n in streams:
        per_stream = max(1, frames_per_serve // n)
        lists = [[pool[(s + i) % 8] for i in range(per_stream)] for s in range(n)]
        server.serve([FrameListSource(f[:1]) for f in lists], lambda r: None)
        first = server.step(np.stack([f[0] for f in lists]))
        runs, seconds = [], []
        for _ in range(repeats):
            results = []
            _zero_counts()
            t = time.perf_counter()
            summary = server.serve([FrameListSource(f) for f in lists], results.append)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t)
            got = _read_counts()
            b = summary["batches"]
            k = 2 * b if torch.device(device).type == "cuda" else 0   # no launch on the CPU
            want = dict({c: 0 for c in got}, cc_propagate=k, cc_propagate_cluster=k,
                        cc_propagate_cluster8=k)
            if got != want:
                raise AssertionError(f"wrap_uniformity server ({what}): expected launches "
                                     f"{want}, got {got}")
            keys = sorted((r.stream_id, r.frame_id) for r in results)
            if keys != [(s, i + 1) for s in range(n) for i in range(per_stream)]:
                raise AssertionError(f"wrap_uniformity server ({what}), {n} streams: frames "
                                     f"lost or repeated")
            if not all(np.isfinite([r.dc_px, r.dt_px]).all() for r in results):
                raise AssertionError(f"wrap_uniformity server ({what}), {n} streams: "
                                     f"non-finite diameters")
            if real_masks and not all(0 < r.dc_px < r.dt_px for r in results):
                raise AssertionError(f"wrap_uniformity server ({what}), {n} streams: a frame "
                                     f"without a cable and a wider tape")
            for r in results:
                i = r.stream_id
                if r.frame_id == 1 and (
                        (r.cable_px, r.tape_px) != (int(first.cable_px[i]), int(first.tape_px[i]))
                        or abs(r.dc_px - float(first.diameters.dc_px[i])) > GEOMETRY_ATOL
                        or abs(r.dt_px - float(first.diameters.dt_px[i])) > GEOMETRY_ATOL):
                    raise AssertionError(f"server result {r} differs from the step's")
            runs.append(n * per_stream / seconds[-1])
        _log(f"main path (wrap_uniformity server, {what}, {n} streams x {per_stream} frames, "
             f"{b} batches, last of {repeats} serves): launches {got}")
        fps = float(np.median(runs))
        out[n] = dict(streams=n, frames=n * per_stream, batches=b, seconds_runs=seconds,
                      frames_per_s=fps, frames_per_s_runs=runs, launches=got,
                      dc_px_first=[r.dc_px for r in results if r.frame_id == 1][:4])
        _log(f"wrap_uniformity server ({what}), {n} streams: {n * per_stream} frames in {b} "
             f"batches, {repeats} serves of {[round(v, 3) for v in seconds]} s, "
             f"{[round(v, 2) for v in runs]} frames/s, median {fps:.2f} (host clock, readers, "
             f"batch assembly, host-to-device copies and the step; frames made beforehand); "
             f"dc_px of the first frames {out[n]['dc_px_first']}")
    return out


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


def _profile_step(step, frames, step_ms: float, what: str) -> None:
    """Device busy time over one step (torch.profiler with CUDA activity),
    its share of `step_ms` (the same step timed without the profiler), the
    share of each hand-written kernel, and the kernels that take the time.
    Diagnostic only: a profiler that records no device time is reported,
    not treated as a fault of the port."""
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
        _log(f"profile ({what}): the profiler recorded no device time")
        return
    _log(f"profile ({what}, one b={frames.shape[0]} step): device busy {busy / 1e3:.3f} ms "
         f"of {step_ms:.3f} ms per step, idle share {max(0.0, 1 - busy / 1e3 / step_ms):.4f}")
    for name in ("nlm_kernel", "cc_propagate_cluster_kernel", "cc_propagate_global_kernel",
                 "qconv_wgmma_kernel", "qconv_c3_kernel", "qconv_sync_kernel"):
        t = sum(dev(e) for e in evts if name in e.key)
        calls = sum(e.count for e in evts if name in e.key)
        _log(f"  {name}: {t / 1e3:.3f} ms x{calls}, {t / busy:.4f} of device busy time")
    for e in sorted(evts, key=dev, reverse=True)[:12]:
        _log(f"  {dev(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")


def _time_step(step, frames, reps: int = 5) -> float:
    """ms per batch: host clock around `reps` steps ending in a synchronize."""
    step(frames)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        step(frames)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e3


def _qconv_bound_ms(x, wq, mult):
    """Least time for one qconv launch, and what bounds it: the 2 M N 9 C
    int8 operations at the dense int8 tensor rate, or the bytes (each input
    read once, the weights and the epilogue once, the int8 output written
    once) at the HBM rate."""
    srcs = x if isinstance(x, tuple) else (x,)
    B, H, W = srcs[0].shape[:3]
    N, cin = wq.shape[0], wq.shape[-1]
    ops = 2 * B * H * W * N * 9 * cin
    nbytes = (sum(t.numel() for t in srcs) + wq.numel() + B * H * W * N
              + 2 * N * mult.element_size())
    ops_ms, bytes_ms = ops / INT8_TENSOR_OPS_PER_S * 1e3, nbytes / MEM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms > bytes_ms else (bytes_ms, "bytes")


def _im2col_int8(x):
    """(B, H, W, C) int8 NHWC (a pair concatenated) -> (B H W, K) int8 with
    k = tap * C + c (the kernel's weight order), K padded to a multiple of
    8 for torch._int_mm."""
    xs = torch.cat(list(x), dim=-1) if isinstance(x, tuple) else x
    B, H, W, C = xs.shape
    xp = nn.functional.pad(xs, (0, 0, 1, 1, 1, 1))
    cols = torch.cat([xp[:, dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)],
                     dim=-1).reshape(B * H * W, 9 * C)
    return nn.functional.pad(cols, (0, -(9 * C) % 8))


def phase_qconv(recorded, device="cuda"):
    """qconv against its plain version, bit for bit, through two kernels:
    the routed call (`qconv`: wgmma for every source width a multiple of 32,
    c3 for one source of 3 channels whose rows are whole 16-byte chunks,
    else the sync kernel's byte path; each launch counted on the route that
    `route` names) and the mma.sync kernel forced (`qconv_sync`), on small
    and ragged shapes (every tile width of each, both forms, both compute
    types, Cin-3 shapes on the c3 route and off it), then at every input
    the int8 path gave it. At those inputs, each launch timed on its route
    and on the mma.sync kernel in turns (routed, sync, sync, routed) beside its bound,
    its plain version and torch._int_mm over an im2col of the same conv
    (the library yardstick; its accumulator, requantized by the plain
    epilogue, must give the kernel's output). Returns ({route: per-launch
    records of the launches the main path sends to it}, max abs error)."""
    from unet_tpu_torch.ops import qconv_kernels

    max_err, n = 0, 0
    counters = {"wgmma": "launches_wgmma", "c3": "launches_c3", "sync": "launches_sync"}

    def route_of(x, wq):
        srcs = x if isinstance(x, tuple) else (x,)
        aligned = all(t.data_ptr() % 16 == 0 for t in srcs + (wq,))
        return qconv_kernels.route(srcs[0].shape[-1], sum(t.shape[-1] for t in srcs[1:]),
                                   wq.shape[0], aligned, srcs[0].shape[2])

    def check(x, wq, mult, bias, what):
        nonlocal max_err, n
        want = qconv_kernels.qconv_plain(x, wq, mult, bias)
        kind = route_of(x, wq)[0]
        for name, fn in (("routed", qconv_kernels.qconv), ("sync", qconv_kernels.qconv_sync)):
            before = {k: getattr(qconv_kernels, c) for k, c in counters.items()}
            got = fn(x, wq, mult, bias)
            torch.cuda.synchronize()
            took = [k for k, c in counters.items() if getattr(qconv_kernels, c) != before[k]]
            if device == "cuda" and took != [kind if name == "routed" else "sync"]:
                raise AssertionError(f"qconv ({name}) on {what} launched {took}, route {kind}")
            err = int((got.int() - want.int()).abs().max()) if got.numel() else 0
            max_err, n = max(max_err, err), n + 1
            if err:
                raise AssertionError(f"qconv ({name}) != plain on {what}: max abs err {err}")

    rng = np.random.default_rng(77)
    for dtype in (torch.bfloat16, torch.float32):
        for shape, cin, cout, pair, signed in (
                ((2, 32, 32), 3, 32, False, True), ((1, 7, 9), 5, 10, False, True),
                ((2, 5, 3), 37, 33, True, False), ((1, 33, 65), 96, 32, True, False),
                ((2, 16, 16), 192, 64, True, False), ((1, 8, 8), 768, 256, True, False),
                ((3, 4, 4), 256, 512, False, False), ((1, 130, 3), 64, 128, False, False),
                ((1, 9, 15), 32, 32, False, True), ((1, 23, 29), 32, 64, False, True),
                ((1, 13, 11), 768, 256, True, True), ((1, 6, 10), 768, 512, True, False),
                # Cin 3: the c3 kernel across image borders, at a ragged last
                # row tile and in two N blocks; rows that end inside a
                # 16-byte chunk take the sync kernel by the route alone
                ((3, 512, 512), 3, 32, False, True), ((1, 33, 48), 3, 32, False, True),
                ((2, 17, 80), 3, 64, False, True), ((1, 9, 15), 3, 32, False, True)):
            cuts = (cin // 3, cin - cin // 3) if pair else (cin,)
            lo = -127 if signed else 0
            xs = tuple(torch.from_numpy(rng.integers(lo, 128, shape + (c,)).astype(np.int8)).to(device)
                       for c in cuts)
            wq = torch.from_numpy(rng.integers(-127, 128, (cout, 3, 3, cin)).astype(np.int8)).to(device)
            spread = np.sqrt(9 * cin) * 5340 / 40
            mult = torch.from_numpy(rng.uniform(0.5, 2, cout) / spread).float().to(dtype).to(device)
            bias = torch.from_numpy(rng.uniform(-20, 80, cout)).float().to(dtype).to(device)
            check(xs if pair else xs[0], wq, mult, bias, f"{shape} Cin {cin} Cout {cout} "
                  f"{'pair' if pair else 'single'} {dtype}")

    per_route = {"wgmma": [], "c3": [], "sync": []}
    for site, (x, wq, mult, bias) in recorded.items():
        check(x, wq, mult, bias, f"main-path {site}")
        srcs = x if isinstance(x, tuple) else (x,)
        shape = [list(t.shape) for t in srcs]
        kind, bn = route_of(x, wq)
        routed = lambda: qconv_kernels.qconv(x, wq, mult, bias)
        sync = lambda: qconv_kernels.qconv_sync(x, wq, mult, bias)
        ms_a = _time_ms(routed, reps=10)
        sync_a = _time_ms(sync, reps=10)
        sync_b = _time_ms(sync, reps=10)
        ms_b = _time_ms(routed, reps=10)
        ms, sync_ms = (ms_a + ms_b) / 2, (sync_a + sync_b) / 2
        plain_ms = _time_ms(lambda: qconv_kernels.qconv_plain(x, wq, mult, bias), reps=2)
        bound, bound_by = _qconv_bound_ms(x, wq, mult)
        B, H, W = srcs[0].shape[:3]
        N = wq.shape[0]
        cols = _im2col_int8(x)
        wmat = nn.functional.pad(wq.reshape(N, -1), (0, cols.shape[1] - wq[0].numel()))
        lib = lambda: torch._int_mm(cols, wmat.t())
        acc = lib().reshape(B, H, W, N)
        if not torch.equal(qconv_kernels.requant_plain(acc, mult, bias), routed()):
            raise AssertionError(f"torch._int_mm's accumulator disagrees with qconv at {site}")
        library_ms = _time_ms(lib, reps=10)
        ops = 2 * B * H * W * N * 9 * wq.shape[-1]
        extra = {}
        if kind == "c3":
            # the same launch with a float32 epilogue (3 conversions an output
            # byte against the bf16 chain's 6), to see what the epilogue costs
            m32, b32 = mult.float(), bias.float()
            extra["f32_epilogue_ms"] = _time_ms(lambda: qconv_kernels.qconv(x, wq, m32, b32),
                                                reps=10)
        per_route[kind].append(dict(
            site=site, shape=shape, cout=N, route=kind, bn=bn, ms=ms, ms_runs=[ms_a, ms_b],
            sync_ms=sync_ms, sync_ms_runs=[sync_a, sync_b], plain_ms=plain_ms, bound_ms=bound,
            bound_by=bound_by, library_ms=library_ms, tops=ops / ms / 1e9, **extra))
        _log(f"kernel qconv {site} {shape} -> {N}: {kind} BN {bn} {ms:.4f} ms/launch "
             f"({ops / ms / 1e9:.1f} TOP/s; runs {ms_a:.4f}, {ms_b:.4f}), mma.sync kernel "
             f"{sync_ms:.4f} ms ({sync_a:.4f}, {sync_b:.4f}), plain {plain_ms:.4f} ms, bound "
             f"{bound:.5f} ms ({bound_by}), torch._int_mm over an im2col {library_ms:.4f} ms")
    vec = per_route["wgmma"]
    if vec:
        tot = {k: sum(p[k] for p in vec) for k in ("ms", "sync_ms", "library_ms", "bound_ms")}
        _log(f"qconv sum over the {len(vec)} wgmma-route launches of one b=8 batch: wgmma "
             f"{tot['ms']:.4f} ms, mma.sync kernel {tot['sync_ms']:.4f} ms "
             f"({tot['sync_ms'] / tot['ms']:.2f}x), torch._int_mm {tot['library_ms']:.4f} ms, "
             f"bound {tot['bound_ms']:.5f} ms")
    for p in per_route["c3"]:
        _log(f"qconv c3 kernel at {p['site']}: {p['ms']:.4f} ms/launch against the mma.sync "
             f"kernel's {p['sync_ms']:.4f} ms ({p['sync_ms'] / p['ms']:.2f}x) and "
             f"torch._int_mm's {p['library_ms']:.4f} ms ({p['library_ms'] / p['ms']:.2f}x) in "
             f"this call; bound {p['bound_ms']:.5f} ms ({p['ms'] / p['bound_ms']:.2f}x); the "
             f"same launch with a float32 epilogue {p['f32_epilogue_ms']:.4f} ms")
    _log(f"kernels: qconv, {n} comparisons with the plain version, all bit-identical")
    return per_route, max_err


def _device_ops(fn) -> int:
    """Device operations (kernels and copies) that one call of `fn` runs, by
    torch.profiler; 0 when the profiler records none."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA"))


def time_upsamples(fwd, x, path: str):
    """The decoder's x2 upsamples of one forward `fwd(x)`, each timed alone
    at the input the forward gave it (`_time_ms`, 10 calls): the bf16
    `ops/image.upsample2x_align_corners` (through `fast_forward.up2x_nhwc`)
    or the int8 `models/quantized._up_int8`. Returns {"calls_per_forward":
    n, "per_call": [{shape, ms, device_ops}], "sum_ms": x}."""
    from unet_tpu_torch.models import fast_forward, quantized

    mod, name = (quantized, "_up_int8") if path.endswith("int8") else (fast_forward, "up2x_nhwc")
    real = getattr(mod, name)
    seen = []

    def spy(t, *args):
        seen.append((t.clone(), args))
        return real(t, *args)

    setattr(mod, name, spy)
    try:
        with torch.inference_mode():
            fwd(x)
    finally:
        setattr(mod, name, real)
    per_call = []
    with torch.inference_mode():
        for t, args in seen:
            call = lambda: real(t, *args)
            per_call.append(dict(shape=list(t.shape), dtype=str(t.dtype).replace("torch.", ""),
                                 ms=_time_ms(call, reps=10), device_ops=_device_ops(call)))
    total = sum(c["ms"] for c in per_call)
    _log(f"upsample {path} (b={x.shape[0]}): {len(per_call)} calls per forward, "
         + ", ".join(f"{tuple(c['shape'])} {c['ms']:.4f} ms ({c['device_ops']} device ops)"
                     for c in per_call)
         + f"; sum {total:.4f} ms per forward")
    return {"calls_per_forward": len(per_call), "per_call": per_call, "sum_ms": total}


def phase_low_precision(cfg, expect, counts, gflop, card, H, W, device="cuda"):
    """The bf16 fast forward and the calibrated int8 forward of `two_stage`,
    both with `seeded_nested_unet(dtype=bfloat16)`: calibration on the
    card, each path driven at b=8 (launch counts checked; the int8 path's
    qconv inputs recorded) and b=32, timed, profiled at b=32; agreement
    with the fp32 step; bf16 logits against fp32 and the int8 forward on
    the card against the CPU's on one 512^2 frame; the decoder's upsamples
    of a b=8 forward timed alone (`time_upsamples`). Returns ({path: {b:
    times}}, the qconv inputs, {check: value}, {path: upsample times})."""
    from unet_tpu_torch.models import quantized
    from unet_tpu_torch.pipeline import stages

    model = seeded_nested_unet(dtype=torch.bfloat16)
    model32 = seeded_nested_unet()
    t = time.time()
    calib = [synthetic_frames(8, H, W, seed=s) for s in (20, 28)]
    qcfg = stages.calibrate_int8(model, cfg, calib, device=device)
    _log(f"calibrate_int8 on the card: {len(qcfg.segment.int8_scales)} scales from 2 batches "
         f"of 8 in {time.time() - t:.1f} s; input {dict(qcfg.segment.int8_scales)['input']:.6f}, "
         f"conv0_4.relu2 {dict(qcfg.segment.int8_scales)['conv0_4.relu2']:.6f}")
    cfgs = {"two_stage_bf16": cfg.replace_in("segment", fast_forward=True),
            "two_stage_int8": qcfg}
    checks, timings, q_rec, up_inputs = {}, {}, {}, {}
    step32 = stages.build_step(model32, cfg, device=device)
    for path, pcfg in cfgs.items():
        step = stages.build_step(model, pcfg, device=device)
        fwd = stages.segment_forward(model, pcfg, device)
        unit, what = ("TOP/s", "int8") if path.endswith("int8") else ("TFLOP/s", "bf16")
        timings[path] = {}
        for b in (8, 32):
            frames = torch.from_numpy(synthetic_frames(b, H, W, seed=10)).to(device)
            if b == 8 and path.endswith("int8"):
                q_rec.update(_record_main_path_inputs(step, frames, path)[2])
            outb, got = _drive(step, frames, expect[path], f"{path}, NestedUNet 512^2, b={b}")
            if b == 8:
                counts[path] = got
            _check_outputs(outb, b, H, W, f"{path} b={b}")
            ms = _time_step(step, frames)
            x = stages.model_input(stages.preprocess_frames(frames, pcfg), pcfg)
            with torch.inference_mode():
                fwd_ms = _time_ms(lambda: fwd(x), reps=5)
                ref = step32(frames)
            if b == 8:
                up_inputs[path] = (fwd, x)
            agree = float((outb.class_map == ref.class_map).float().mean())
            _log(f"{path} NestedUNet {what} b={b}: {ms:.3f} ms/batch, {b / ms * 1e3:.2f} "
                 f"frames/s; forward alone {fwd_ms:.3f} ms = {gflop * b / fwd_ms:.2f} {unit} "
                 f"({gflop:.2f} G per frame); class maps vs the fp32 step {agree:.6f} "
                 f"(cable_px {outb.cable_px[:4].tolist()}...) [{card}]")
            timings[path][b] = dict(ms=ms, frames_per_s=b / ms * 1e3, forward_ms=fwd_ms,
                                    class_map_agreement_vs_fp32=agree)
            checks[f"{path}_b{b}_class_maps_vs_fp32"] = agree
        _profile_step(step, frames, timings[path][32]["ms"], f"{path} NestedUNet")

    frames = synthetic_frames(8, H, W, seed=40)
    checks["validate_int8"] = stages.validate_int8(model, cfg, qcfg, frames, device=device)
    _log(f"validate_int8 (int8 step against the bf16 model's plain step, b=8): "
         f"{checks['validate_int8']:.6f}")

    # one 512^2 frame: bf16 logits against fp32; the int8 forward on the card vs the CPU
    x1 = stages.model_input(stages.geometric_preprocess(
        torch.from_numpy(synthetic_frames(1, H, W, seed=0)), cfg), cfg)
    with torch.inference_mode():
        ff = stages.segment_forward(model, cfgs["two_stage_bf16"], device)(x1.to(device)).float().cpu()
        f32 = stages.forward_logits(model32.to(device), x1.permute(0, 3, 1, 2).contiguous().to(device)).cpu()
        checks["bf16_logits_max_abs_err_vs_fp32"] = float((ff - f32).abs().max())
        checks["bf16_argmax_agreement_vs_fp32"] = float((ff.argmax(1) == f32.argmax(1)).float().mean())
        sd, scales = model.state_dict(), qcfg.segment.int8_scales
        taps_cpu, taps_card = {}, {}
        t = time.time()
        want = quantized.nested_unet_forward_int8(
            quantized.prepare_int8_params(sd, scales, torch.bfloat16, "cpu"), x1, taps_cpu)
        cpu_s = time.time() - t
        got = quantized.nested_unet_forward_int8(
            quantized.prepare_int8_params(sd, scales, torch.bfloat16, device), x1.to(device), taps_card)
    for name in quantized.TAP_NAMES:
        if not torch.equal(taps_card[name].cpu(), taps_cpu[name]):
            raise AssertionError(f"int8 tap {name} differs between the card and the CPU")
    checks["int8_taps_bit_identical_card_vs_cpu"] = len(quantized.TAP_NAMES)
    checks["int8_argmax_agreement_card_vs_cpu"] = float(
        (got.float().cpu().argmax(-1) == want.float().argmax(-1)).float().mean())
    checks["int8_logits_max_abs_err_card_vs_cpu"] = float((got.float().cpu() - want.float()).abs().max())
    _log(f"bf16 fast forward vs fp32 logits (512^2): max abs err "
         f"{checks['bf16_logits_max_abs_err_vs_fp32']:.4e}, argmax agreement "
         f"{checks['bf16_argmax_agreement_vs_fp32']:.6f}")
    _log(f"int8 forward card vs CPU (512^2, plain versions on the CPU in {cpu_s:.1f} s): all "
         f"{len(quantized.TAP_NAMES)} int8 tensors bit-identical; logits max abs err "
         f"{checks['int8_logits_max_abs_err_card_vs_cpu']:.4e}, argmax agreement "
         f"{checks['int8_argmax_agreement_card_vs_cpu']:.6f}")
    # after the step profiles: a profiler run just before a step's
    # profile lost that profile its first kernels
    ups = {path: time_upsamples(fwd, x, path) for path, (fwd, x) in up_inputs.items()}
    return timings, q_rec, checks, ups


def main() -> int:
    t_start = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the GPU "
              "and this script has no CPU fallback", file=sys.stderr)
        return 1
    from unet_tpu_torch import _build
    from unet_tpu_torch.pipeline import presets, stages

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    _log(f"device: {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
         f"cuda {torch.version.cuda} | count {torch.cuda.device_count()} | "
         f"{sms} SMs, max SM clock {clock_mhz:.0f} MHz")
    _log(card)

    t = time.time()
    built = _build.build_all(["cc_propagate", "nlm", "qconv"])
    _log(f"build: {len(built)} kernel source(s) in {time.time() - t:.1f} s")
    for name, (path, log) in built.items():
        _log(f"  {name}: {path.name}\n" + "\n".join("    " + l for l in log.splitlines()))

    H, W = 448, 800
    cfgs = {"two_stage": presets.two_stage(), "enhanced": presets.enhanced(),
            **{p: presets.get_preset(p) for p in GEOMETRY_PATHS}}
    # every B1 launch of the paths takes the cluster route: burr crops and
    # the wrap path's 256x256 labels on clusters of 8, 448x800 labels of 16
    def b1(k8, k16=0):
        return {"cc_propagate": k8 + k16, "cc_propagate_cluster": k8 + k16,
                "cc_propagate_global": 0, "cc_propagate_cluster8": k8,
                "cc_propagate_cluster16": k16}
    # int8: 17 convs on qconv's wgmma route, conv0_0.conv1 (Cin 3) on the c3 kernel
    q0 = {"qconv": 0, "qconv_wgmma": 0, "qconv_sync": 0, "qconv_c3": 0}
    expect = {"two_stage": dict(b1(2), nlm=0, **q0), "enhanced": dict(b1(2), nlm=3, **q0),
              "two_stage_bf16": dict(b1(2), nlm=0, **q0),
              "two_stage_int8": dict(b1(2), nlm=0, qconv=18, qconv_wgmma=17, qconv_sync=0,
                                     qconv_c3=1),
              # labels of the cable and tape: at the model's 256x256 (wrap),
              # at 448x800 (three_class_full: 448 < its 512 model input)
              "wrap_uniformity": dict(b1(2), nlm=0, **q0),
              "three_class_full": dict(b1(0, 2), nlm=0, **q0),
              # burr (2 on its crop) + cable and tape labels + defect analysis
              # (holes, tape, cable count), all at 448x800
              "production": dict(b1(2, 5), nlm=0, **q0)}
    scenes = {"two_stage": lambda b, seed: synthetic_frames(b, H, W, seed=seed),
              "enhanced": lambda b, seed: enhanced_scenes(b, H, W, seed=seed)}

    # -- the main paths: fabricated logits so cable, tape and burr candidates exist
    cc_rec, nlm_rec, counts = {}, {}, {}
    for path, cfg in ((p, cfgs[p]) for p in ("two_stage", "enhanced")):
        colour_cuda = stages.build_step(ColourClassModel(), cfg, device="cuda")
        frames8 = torch.from_numpy(scenes[path](8, 0)).cuda()
        rec = _record_main_path_inputs(colour_cuda, frames8, path)
        cc_rec.update(rec[0])
        nlm_rec.update(rec[1])
        out, counts[path] = _drive(colour_cuda, frames8, expect[path],
                                   f"{path}, colour->class model, b=8, 800x448, model 512^2")
        _check_outputs(out, 8, H, W, f"{path} colour run")
        if int(out.burr_px.sum()) == 0:
            raise AssertionError(f"{path} colour run found no burr: the CC filter path "
                                 f"was not exercised")
        colour_cpu = stages.build_step(ColourClassModel(), cfg, device="cpu")
        if path == "two_stage":
            t = time.time()
            ref = colour_cpu(frames8.cpu())
            _log(f"  same step on the CPU (plain versions): {time.time() - t:.1f} s")
            for name in ("class_map", "cable_px", "tape_px", "burr_px"):
                if not torch.equal(getattr(out, name).cpu(), getattr(ref, name)):
                    raise AssertionError(f"{path} colour run: {name} differs between cuda and cpu")
            _log(f"  cuda == cpu for class_map and px counts; burr_px {out.burr_px.tolist()}, "
                 f"cable_px {out.cable_px.tolist()}")
        else:
            # the CPU's NLM is slow: compare the first two frames
            t = time.time()
            ref = colour_cpu(frames8[:2].cpu())
            _log(f"  same step on the CPU (plain versions), b=2: {time.time() - t:.1f} s")
            got = colour_cuda(frames8[:2])
            agree = float((got.class_map.cpu() == ref.class_map).float().mean())
            for name in ("cable_px", "tape_px", "burr_px"):
                _log(f"  {name}: cuda {getattr(got, name).tolist()} cpu "
                     f"{getattr(ref, name).tolist()}")
            _log(f"  class_map agreement cuda vs cpu (b=2): {agree:.6f}; b=8 burr_px "
                 f"{out.burr_px.tolist()}")
            if agree < 0.999:
                raise AssertionError(f"{path} colour run: class maps agree {agree} < 0.999")

    # -- the geometry paths: colour->class model, card against CPU
    geo_rec, geo_counts, geo_checks, geo_timings = phase_geometry_paths(cfgs, expect, H, W)
    cc_rec.update(geo_rec)
    counts.update(geo_counts)

    # -- kernels against their plain versions, and their times
    cc_launch, cc_err = phase_cc(cc_rec)
    cc_trace = trace_cc(cc_rec)
    cc_batches = trace_cc_batches(cc_rec)
    nlm_launch, nlm_err = phase_nlm(nlm_rec, sms, clock_mhz * 1e6)

    # -- NestedUNet at full width
    model = seeded_nested_unet()
    frames1 = torch.from_numpy(scenes["two_stage"](1, 0))
    x1 = stages.model_input(stages.geometric_preprocess(frames1, cfgs["two_stage"]),
                            cfgs["two_stage"]).permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        want = model(x1)
        got = stages.forward_logits(model.cuda(), x1.cuda()).cpu()
        unpinned = model(x1.cuda()).cpu()
    err = float((got - want).abs().max())
    agree = float((got.argmax(1) == want.argmax(1)).float().mean())
    _log(f"NestedUNet 512^2 logits cuda (stages.forward_logits) vs cpu: max abs err {err:.3e}, "
         f"argmax agreement {agree:.6f}; the bare forward under PyTorch's default flags "
         f"(TF32 convs): max abs err {float((unpinned - want).abs().max()):.3e}")
    if not torch.allclose(got, want, atol=1e-3, rtol=1e-3):
        raise AssertionError(f"NestedUNet cuda logits differ from cpu by {err}")
    gflop = _conv_gflop(model, (512, 512))
    _log(f"NestedUNet 512^2 forward: {gflop:.2f} GFLOP per frame (convolutions)")
    timings = {}
    for path in ("enhanced", "two_stage"):
        cfg = cfgs[path]
        step = stages.build_step(model, cfg, device="cuda")
        timings[path] = {}
        for b in (8, 32):
            frames = torch.from_numpy(scenes[path](b, 10)).cuda()
            outb, _ = _drive(step, frames, expect[path], f"{path}, NestedUNet 512^2, b={b}")
            _check_outputs(outb, b, H, W, f"{path} NestedUNet b={b}")
            ms = _time_step(step, frames)
            x = stages.model_input(stages.preprocess_frames(frames, cfg),
                                   cfg).permute(0, 3, 1, 2).contiguous()
            with torch.inference_mode():
                fwd_ms = _time_ms(lambda: stages.forward_logits(model, x), reps=5)
            _log(f"{path} NestedUNet fp32 b={b}: {ms:.3f} ms/batch, {b / ms * 1e3:.2f} frames/s; "
                 f"forward alone {fwd_ms:.3f} ms = {gflop * b / fwd_ms:.2f} TFLOP/s "
                 f"(device-resident frames; cable_px {outb.cable_px[:4].tolist()}...) [{card}]")
            timings[path][b] = dict(ms=ms, frames_per_s=b / ms * 1e3, forward_ms=fwd_ms)
        _profile_step(step, frames, timings[path][32]["ms"], f"{path} NestedUNet")

    # -- the geometry paths with NestedUNets at full width: production and
    # three_class_full (3 classes, 512^2) and the wrap step (4 classes, 256^2)
    # at b=8, then the wrap_uniformity server at 8 and 32 streams
    model4 = seeded_nested_unet(num_classes=4)
    for path, m in (("production", model), ("three_class_full", model),
                    ("wrap_uniformity", model4)):
        step = stages.build_step(m, cfgs[path], device="cuda")
        frames = torch.from_numpy(geometry_scenes(path, 8, H, W, seed=10)).cuda()
        outb, _ = _drive(step, frames, expect[path],
                         f"{path}, NestedUNet {cfgs[path].preprocess.model_size[0]}^2, b=8")
        _check_outputs(outb, 8, H, W, f"{path} NestedUNet b=8")
        for f in outb.diameters + (outb.defects or ()):
            if not bool(torch.isfinite(f.float()).all()):
                raise AssertionError(f"{path} NestedUNet b=8: non-finite geometry")
        ms = _time_step(step, frames)
        timings[path] = {8: dict(ms=ms, frames_per_s=8 / ms * 1e3)}
        _log(f"{path} NestedUNet fp32 b=8: {ms:.3f} ms/batch, {8 / ms * 1e3:.2f} frames/s "
             f"(device-resident frames; dc_px {[round(v, 2) for v in outb.diameters.dc_px[:4].tolist()]}"
             f"...) [{card}]")
        _profile_step(step, frames, ms, f"{path} NestedUNet b=8")
    serve = {"nested_unet": phase_serve(model4, cfgs["wrap_uniformity"], H, W,
                                        "4-class NestedUNet"),
             "colour_class": phase_serve(ColourClassModel(), cfgs["wrap_uniformity"], H, W,
                                         "colour->class model", real_masks=True)}

    # -- the bf16 and int8 forwards of two_stage
    low, q_rec, int8_checks, upsample = phase_low_precision(cfgs["two_stage"], expect, counts,
                                                            gflop, card, H, W)
    timings.update(low)
    q_launch, q_err = phase_qconv(q_rec)

    # the mma.sync kernel has no main-path launch (conv0_0.conv1 takes the c3
    # kernel): its entry holds its time forced at that site, the c3 kernel's
    # yardstick
    q_rows = dict(q_launch, sync=q_launch["sync"] or [
        {k: p[k] for k in ("site", "shape", "cout", "bn", "sync_ms", "plain_ms", "bound_ms",
                           "bound_by", "library_ms")}
        | dict(route="sync (forced)", ms=p["sync_ms"], ms_runs=p["sync_ms_runs"])
        for p in q_launch["c3"]])
    q_notes = {"wgmma": "the wgmma kernel, every source width a multiple of 32",
               "c3": "the c3 kernel, one source of 3 channels from a shared-memory halo tile",
               "sync": "the mma.sync kernel, the byte path of ragged or misaligned shapes; "
                       "no launch on the main path, timed at conv0_0.conv1 through qconv_sync"}

    def entry(name, source, replaces, per_launch, max_err, by_path, library_ms=None,
              **extra):
        # ms / plain_ms / bound_ms: every counted main-path launch of one b=8
        # batch per path, summed, to match `launches`
        keys = ("ms", "plain_ms", "bound_ms") + (("global_ms",) if "global_ms" in per_launch[0] else ())
        total = {k: sum(p[k] for p in per_launch) for k in keys}
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_per_path": by_path,
                "max_abs_err": max_err, **total,
                "bound_by": max(per_launch, key=lambda p: p["bound_ms"])["bound_by"],
                "library_ms": library_ms, "per_launch": per_launch, **extra}

    record = {"kernels": [
        entry("cc_propagate", "unet_tpu_torch/csrc/cc_propagate.cu",
              "unet_tpu/ops/cc_pallas.py:169", cc_launch, cc_err,
              {p: c["cc_propagate"] for p, c in counts.items()},
              launches_per_route={p: {r: c[f"cc_propagate_{r}"]
                                      for r in ("cluster", "global", "cluster8", "cluster16")}
                                  for p, c in counts.items()},
              trace=cc_trace, trace_global_by_batch=cc_batches),
        entry("nlm", "unet_tpu_torch/csrc/nlm.cu", "unet_tpu/ops/nlm_pallas.py:96",
              nlm_launch, nlm_err, {p: c["nlm"] for p, c in counts.items() if c["nlm"]}),
    ] + [
        entry(f"qconv_{r}", "unet_tpu_torch/csrc/qconv.cu", "unet_tpu/models/quantized.py:183",
              q_rows[r], q_err,
              {p: c[f"qconv_{r}"] for p, c in counts.items() if c[f"qconv_{r}"]},
              library_ms=sum(p["library_ms"] for p in q_rows[r]),
              library="torch._int_mm over an im2col (the conv's int32 accumulator only)",
              tpu_kernel=False, sync_ms=sum(p["sync_ms"] for p in q_rows[r]),
              note="not a TPU kernel: the JAX package's _qconv + _requant run as XLA ops; "
                   + q_notes[r])
        for r in ("wgmma", "c3", "sync")
    ], "slice_ms_per_batch": timings, "geometry_colour_ms_per_batch": geo_timings,
        "wrap_uniformity_server": serve,
        "geometry_checks": geo_checks, "upsample_b8": upsample, "int8_checks": int8_checks,
        "card": card, "seconds": round(time.time() - t_start, 1)}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
