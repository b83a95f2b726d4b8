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
     that hold cable and tape, and profiled. Then the eight presets of the
     threshold modes, the model-resolution and shape postprocess, the
     letterbox and dynamic ROI, the quality gate and the tracker
     (`phase_presets`: video_full, optimized, simple_7class, strict,
     v3_high_quality at 256^2, robust, spatial, roi_first at 512^2), b=8,
     each with its colour->class model (7 and 6 classes paint the defect
     colours of `defect_scenes`): launches per cluster size (PRESET_B1),
     cable and tape in every frame, and the batch against the same step
     on the CPU (integers equal, floats within 1e-4, quality
     statistics within 1e-4 relative); then each with a seeded full-width
     NestedUNet of its class count, ms per batch. B1's sites are named by
     caller (`_cc_site`)
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
     The presets' new sites too: 512x512 labels (spatial_strip_filter,
     refine_mask_by_geometry), the 448x800 hysteresis of
     detect_vertical_roi, robust's 448x800 labels and the tracker's.
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
  7. the product loop (`phase_engine`): 96 synthetic 800x448 frames a
     directory written as .bmp with numpy, run through the port's CLI
     (`cli.main.main`): `infer --preset two_stage` with a seeded NestedUNet
     saved as a .pth, bf16 fast forward and `--int8`, `infer --preset
     wrap_uniformity`, `infer --preset production` (window events, JPEG
     evidence) and `serve --preset wrap_7class` over two directories; each
     run's launch counts per batch (B1 2 a two_stage batch, qconv 18 an int8
     one) and every events.csv / results.csv row against `stages.build_step`
     on the same frames; the synchronising calls left in a bf16 and an int8
     two_stage step (`torch.cuda.set_sync_debug_mode("warn")`); the .bmp
     decode by the port's numpy decoder and by cv2.imread; the engine's
     frames/s, legs and batch latency at b=8 and b=32 over 2048 files, hard
     links to 256 other frames (median of two calls after a warm-up) beside
     the bare step's frames/s; the engine's launches per batch beside each
     kernel's `launches`, which count the step paths above; `infer --preset
     optimized` with a seeded 7-class NestedUNet; then `optimized` and
     `video_full` through `InferenceEngine` with the 7-class colour model
     over `gate_scenes` (`phase_inspect_engine`): every skipped.csv,
     events.csv and confirmed_defects.csv row against the step through the
     host's gate and tracker; then `cli infer --config` (`phase_config_runs`)
     with production's YAML (a seeded NestedUNet .pth), a legacy AppCfg
     layout (`--arch lightweight:mobilenet_v3_small`) and a legacy
     RefactorConfig layout with its event section (a seeded 7-class
     SimpleUNet .pth), each held as the engine runs above are
  8. the model zoo (`phase_models`, run after phase 3, before the kernels'
     comparisons): the ResNet50 NestedUNet, SimpleUNet and the lightweight
     UNet++ with each of its six encoders, built by the CLI's
     `_build_model` with seeded weights, through `two_stage` at 512^2 on
     b=8 800x448 frames in fp32 and bf16: B1's launches (2 a batch, cluster
     route) and inputs (into phase 4's comparisons), fp32 logits against
     the CPU's on 2 frames (atol/rtol 1e-3, 2e-3 for the resnet50 encoder),
     class maps and px counts against the CPU's but on tie pixels
     (`compare_with_ties`), bf16 class maps against fp32 at >= 0.995, ms per
     batch and the forward's ms and TFLOP/s; the resnet50 NestedUNet again
     with BN statistics from one train-mode pass over the frames
     (`calibrated_model`, `momentum=None`), its fp32 logits card vs CPU
     within atol/rtol 1e-3 unscaled (`_calibrated_check`); then one
     two_stage step inside `core.profiling.device_trace`, whose trace must
     name B1's kernel
  9. training (`phase_train`, after phase 7): the 3-class NestedUNet with
     deep supervision at full width, the `3class_advanced` loss and
     optimizer (accumulation 2), seeded weights: one micro-step at b=2,
     512^2, card against CPU (fp32 with TF32 pinned off: loss and its parts
     within 1e-4 relative, grad norm 1e-3, BN statistics 1e-5; bf16: the
     logits, gradient and BN statistics within twice the CPU's own
     bf16-vs-fp32 RMS distance, the scalars within 5e-2); ms per
     micro-step (median of 3 windows of 8 after two optimizer steps) and
     per optimizer step, train frames/s, TFLOP/s, the host's time to queue
     a micro-step and peak memory at b=8 in fp32, bf16 and bf16 with remat
     (no hand-written kernel launches);
     then the CLI over 40 + 8 labelled 800x448 scenes written as .png:
     `train --recipe 3class_advanced --epochs 2`, `evaluate` of its best
     checkpoint (the loop's logged mIoU within 1e-3), `infer --model
     best.pth --preset two_stage` (2 B1 launches a batch, events.csv
     against the step) and `train --recipe overfit_test --image-size 32`
     (its mIoU > 0.98 gate)
 10. export (`phase_export`, after phase 9): `.pt2` programs of the whole
     step through `export.AotRunner` against the live step on the same
     frames, class maps and px counts bit for bit and the same launches
     per batch: two_stage fp32 from `cli export --pipeline two_stage` of a
     seeded .pth (symbolic batch, b=8 and b=3; B1 2), two_stage int8
     (qconv 18), enhanced fp32 at a fixed b=8 (B2 3) and production (B1 7,
     diameters within rtol 1e-5) at 512^2, one two_stage program traced on
     the CPU and run on the card; `export_model`'s logits within 1e-5; `cli tools
     render-predictions` on the card
 11. the device mesh (`phase_mesh`, after phase 10) at world size 1 on NCCL
     (`parallel.make_mesh()` starts a one-rank group): `two_stage` fp32 (with
     the quality statistics) and int8 through `parallel.shard_pipeline_step`
     against `build_step` on b=8 frames with the seeded NestedUNet, every
     output tensor bit for bit and B1 2 (qconv 18) launches a batch;
     `make_train_step(mesh=...)` against `make_train_step`, two micro-steps
     of 3class_advanced at 512^2, b=2, bit for bit under torch's
     deterministic algorithms (metrics, gradients, parameters and BN
     statistics); `MultiStreamServer(mesh=...)` against
     the bare server over 8 streams of 48 frames; ms per batch, per
     micro-step and frames/s of each beside the bare one (the collectives'
     cost at one rank). Phase 9's `cli train` runs go through
     `train.loop.train_model`, and so over the mesh, too
 12. the spatial axis (`phase_spatial`, after phase 11): 2 and 4 ranks,
     each its own process, all on cuda:0 in one gloo group (NCCL takes no
     two ranks on one device), the kernels built before they start:
     `parallel.shard_pipeline_step(build_step(...), mesh, spatial=True)`
     with the seeded NestedUNet on high_res_roi fp32 (b=2 native
     2448x2048 frames, 1 x 2 and 1 x 4: two ranks hold no frame),
     two_stage fp32, bf16 and int8 (b=8, 2 x 2) and production and
     enhanced fp32 (b=8, 1 x 2), against build_step on the card: class
     maps and px counts equal, or differing only on tie pixels of the
     logits (top-2 gap < 1e-5 in fp32; in bf16 the stripes move the logits
     less than bf16 moves them from fp32, and flips lie under twice that
     move; counted, the flips at a gap >= 1e-3 apart), the int8
     forward's 19 int8 tensors bit for bit on every stripe, B1, B2 and
     qconv launches and peak memory per rank; ms per batch at S = 1, 2, 4
     and the
     transport's share (processes sharing one card: not a scaling figure)
 13. the spatial train step (`phase_spatial_train`, after phase 12), with
     phase 12's harness: the full-width 3-class NestedUNet with deep
     supervision, 3class_advanced (class weights, accumulation 2), one
     optimizer step of two micro-steps at 512^2 over 1 x 2 (global b=2) in
     fp32, bf16 and fp32 with remat and over 2 x 2 (global b=4) in fp32,
     through `make_train_step(mesh=...)` against `make_train_step` in the
     main process on the same card and batch: every rank's metrics and
     state equal; fp32 loss and parts within 1e-4 relative, grad norm
     1e-3, BN statistics 1e-5, the gradient as close to the float64 step's
     as twice the one-process fp32 step's own distance (each printed); bf16
     within twice the one-process step's own bf16-vs-fp32 distance; remat
     against no remat at the fp32 gates; ms per micro-step at S = 1 and 2,
     peak memory per rank against the one-process step, the collectives'
     share of a micro-step
 14. the model zoo on the spatial axis (`phase_spatial_zoo`, after phase
     13), with phase 12's harness: two_stage at 512^2 on b=4 800x448
     frames over 1 x 2 for every --arch but nested_unet (the eight of
     phase 8, seeded weights), in fp32 and bf16, and shufflenet over 1 x 4
     (128 rows a rank, b=2: two ranks hold no frame), against build_step
     on the card by phase 12's rules (fp32 ties: a top-2 gap under 1e-5
     times the largest logit where it passes 1); the train step of
     lightweight:custom and simple_unet (the inspection recipe's combined
     loss, one optimizer step of two fp32 micro-steps at 512^2, b=2) over
     1 x 2 against make_train_step by phase 13's gates; squeeze-excitation's
     gathered bytes per frame; ms per batch at S = 1 and 2, the transport's
     share, peak memory per rank against one process
     Phases 12-14 run their ranks in one spawn of 2 processes and one of 4
     (`run_spatial_phases`); each keeps its own record and seconds.
 15. the throughput bench (`phase_bench`, after phase 14): the chunked
     step (`stages.build_chunked_step`, K=4 batches of 8 in one call) of
     two_stage bf16 and int8 and enhanced bf16 against 4 calls of
     build_step, every output tensor bit for bit and exactly 4x the
     per-batch launches (B1 8, qconv 72, B2 12); the pairs the bench runs
     that no earlier phase holds against fp32 (enhanced bf16 and int8,
     high_res_roi bf16 on b=2 native 2448x2048 frames, wrap_7class bf16
     and int8), class maps at >= 0.995 of the fp32 step's; the bench's
     first fixed point (`bench._fixed_points`, two_stage int8 chunked
     4 x 96 at 800x448) with its frames/s, peak memory and launches, then
     B1 and qconv at b=96 on that step's inputs and B2 on 96 planes of
     448x800, each kernel's last 8 frames against its plain version
Then, on the last two lines, the kernels' JSON record and
{"ok": true, "device": {...}}.

The scene generators and the colour->class model live here so the CPU
tests (tests/test_torch_pipeline.py and others) drive the same inputs.
"""
from __future__ import annotations

import contextlib
import csv
import functools
import json
import os
import struct
import subprocess
import sys
import time
from pathlib import Path

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


def wrap_scenes(batch: int, h: int, w: int, seed: int = 0, band: bool = True) -> np.ndarray:
    """(batch, h, w, 3) uint8 BGR wrap scenes for the geometry presets: the
    vertical cable strip of `synthetic_frames` with tape standing out on
    both of its sides over the middle two thirds of the rows (a flank of
    25-35 % of the cable's width each side, drawn per frame), the flanks
    joined across the cable by a band of 4 % of the rows at the top (with
    `band`; without it the cable is one component), on a textured
    background with sensor noise. Rows holding both give the cable and tape
    diameters; no burr patches."""
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
        if band:
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


def high_res_scenes(batch: int, seed: int = 0, patch: int = 16) -> np.ndarray:
    """Input of the high_res_roi preset, (batch, 2048, 2448, 3) uint8 BGR:
    the 448x800 scenes of `synthetic_frames` enlarged by nearest neighbour
    to 2448x2048 and turned clockwise, so that the preset's counter-clockwise
    turn and its resize to 800x448 give back about the original scene, with
    the cable inside its ROI (x 250-550 of 800) and burr patches large
    enough to survive the resize."""
    f = synthetic_frames(batch, 448, 800, seed=seed, patch=patch)
    rows = np.arange(2448) * 448 // 2448
    cols = np.arange(2048) * 800 // 2048
    big = f[:, rows][:, :, cols]
    return np.ascontiguousarray(np.rot90(big, k=-1, axes=(1, 2)))


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


# defect colours of `defect_scenes` (BGR) and the classes `ColourDefectModel`
# reads them as, in channel order 3, 4, 5, 6: green, blue, yellow, magenta
DEFECT_BGR = ((30, 200, 30), (200, 40, 30), (30, 200, 200), (200, 30, 200))


class ColourDefectModel(nn.Module):
    """`ColourClassModel` with `num_classes` channels: channels 3 and up
    read the defect colours of `defect_scenes` (green, blue, yellow,
    magenta), which win over cable and tape; fabricated logits, one-hot
    times 10. The tests' JAX twin gives the same classes bit for bit."""

    def __init__(self, num_classes: int = 7):
        super().__init__()
        self.num_classes = num_classes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r, g, b = x[:, 0], x[:, 1], x[:, 2]
        hi, lo = (lambda c: c > 0.6), (lambda c: c < 0.4)
        cable = hi(r) & hi(b)
        tape = hi(r) & lo(b) & ~cable
        cls = torch.where(tape, 2, torch.where(cable, 1, 0))
        colours = (hi(g) & lo(r) & lo(b), hi(b) & lo(r) & lo(g),
                   hi(r) & hi(g) & lo(b), hi(r) & hi(b) & lo(g))
        for k in range(3, self.num_classes):
            cls = torch.where(colours[k - 3], k, cls)
        return nn.functional.one_hot(cls, self.num_classes).permute(0, 3, 1, 2).float() * 10.0


def defect_scenes(batch: int, h: int, w: int, seed: int = 0, classes: int = 4) -> np.ndarray:
    """`wrap_scenes` with `classes` defect patches on the cable, one of
    each colour of DEFECT_BGR in turn down the rows, each about a twelfth
    of the rows by half the cable's width, at the same place in every
    frame but for a jitter of one pixel drawn per frame: the tracker sees
    them persist."""
    out = wrap_scenes(batch, h, w, seed=seed)
    x1, x2 = int(w * 0.35), int(w * 0.45)
    ph, pw = max(4, h // 12), max(3, (x2 - x1) // 2)
    for i in range(batch):
        r = np.random.default_rng(seed + 1000 + i)
        for k in range(classes):
            y = (k + 1) * h // (classes + 2) + int(r.integers(-1, 2))
            x = x1 + (x2 - x1 - pw) // 2 + int(r.integers(-1, 2))
            out[i, y:y + ph, x:x + pw] = np.clip(
                np.asarray(DEFECT_BGR[k], np.float64) + r.normal(0, 6.0, (ph, pw, 3)), 0, 255)
    return out


def gate_scenes(n: int, h: int, w: int, seed: int = 0, classes: int = 4) -> np.ndarray:
    """n frames of `defect_scenes` in which the frame quality gate has work:
    every 7th frame flat grey with faint noise (std < 3: a glitch), every
    7th from the 3rd a 9x9 box blur of its scene brightened by 25 (low
    Laplacian variance and a large diff against the frame before: motion
    blur), every 7th from the 5th a copy of the frame before (frozen: no
    diff)."""
    f = defect_scenes(n, h, w, seed=seed, classes=classes)
    r = np.random.default_rng(seed + 77)
    for i in range(n):
        if i % 7 == 0:
            f[i] = np.clip(120 + r.normal(0, 1.0, (h, w, 3)), 0, 255).astype(np.uint8)
        elif i % 7 == 2:
            x = f[i].astype(np.float64)
            for ax in (0, 1):
                pad = [(0, 0)] * 3
                pad[ax] = (4, 4)
                xp = np.pad(x, pad, mode="edge")
                x = sum(np.take(xp, np.arange(k, k + x.shape[ax]), axis=ax) for k in range(9)) / 9
            f[i] = np.clip(x + 25, 0, 255).astype(np.uint8)
        elif i % 7 == 4:
            f[i] = f[i - 1]
    return f


def seeded_nested_unet(num_classes: int = 3, seed: int = 0,
                       dtype: torch.dtype = torch.float32) -> nn.Module:
    """NestedUNet with He-normal convs and non-trivial BN statistics, all
    drawn from numpy's generator with `seed`; float32 parameters, compute
    type `dtype`."""
    from unet_tpu_torch.models import NestedUNet

    return _seed_state(NestedUNet(num_classes=num_classes, deep_supervision=False, dtype=dtype),
                       seed)


def seeded_model(arch: str, num_classes: int = 3, seed: int = 0,
                 dtype: str = "float32") -> nn.Module:
    """The model of `arch` (`cli --arch`) built by the CLI's `_build_model`
    without deep-supervision heads, its weights drawn as seeded_nested_unet
    draws them (once per arch, classes and seed in a process); float32
    parameters, compute type `dtype`; eval mode."""
    from unet_tpu_torch.cli.main import _build_model

    with torch.device("meta"):   # no initialisation: the weights are loaded
        model = _build_model(num_classes, arch, dtype, deep_supervision=False)
    model.to_empty(device="cpu").load_state_dict(_seeded_weights(arch, num_classes, seed))
    return model.eval()


@functools.lru_cache(maxsize=16)
def _seeded_weights(arch: str, num_classes: int, seed: int) -> dict:
    from unet_tpu_torch.cli.main import _build_model

    return _seed_state(_build_model(num_classes, arch, "float32", deep_supervision=False),
                       seed).state_dict()


def _seed_state(model: nn.Module, seed: int) -> nn.Module:
    """Every floating tensor of `model`'s state drawn from numpy's generator
    with `seed`, in state-dict order: conv weights He-normal (fan-in from
    dims 1-3), BN running variances in [0.5, 1.5], running means and biases
    normal (0.1), BN weights in [0.8, 1.2]. Returns the model in eval mode."""
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
# the callers that name a site further: the first of these up the stack
_SITE_CALLERS = {"label": ("largest_component", "count_components", "analyze_defects",
                           "spatial_strip_filter", "refine_mask_by_geometry",
                           "filter_cable_by_shape", "defect_components"),
                 "hysteresis": ("detect_vertical_roi",)}


def _cc_site(frame) -> str:
    """The B1 site a call of `cc_kernels.propagate` comes from, by its
    callers (the stack from `frame` outwards): "hysteresis" (Canny; the
    dynamic ROI's Canny is "hysteresis (detect_vertical_roi)"), "cc_filter"
    (the burr CC filter) or "label (<caller>)", the caller of
    `ops.cc.connected_components` being one of _SITE_CALLERS["label"]."""
    site = None
    while frame is not None:
        name = frame.f_code.co_name
        if site is None and name in _CC_CALLERS:
            site = _CC_CALLERS[name]
        elif site is not None and name in _SITE_CALLERS.get(site, ()):
            return f"{site} ({name})"
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
            site = f"{path}/label {sum(k.startswith(f'{path}/label') for k in cc_rec) + 1}" \
                   + site[len(f"{path}/label"):]
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


QUALITY_RTOL = 1e-4   # quality statistics, card vs CPU (tests/test_torch_host.py)


def _compare_outputs(got, want, what) -> float:
    """Card outputs against the CPU's: class map, px counts and every
    integer field of diameters, defects and defect components equal, every
    float field within GEOMETRY_ATOL, the quality statistics within
    QUALITY_RTOL relative. Returns the largest float difference of the
    geometry."""
    err = 0.0
    for f in ("class_map", "cable_px", "tape_px", "burr_px"):
        if not torch.equal(getattr(got, f).cpu(), getattr(want, f).cpu()):
            raise AssertionError(f"{what}: {f} differs between the card and the CPU")
    for part in ("diameters", "defects", "defect_components", "quality"):
        g, w = getattr(got, part), getattr(want, part)
        if (g is None) != (w is None):
            raise AssertionError(f"{what}: {part} on one side only")
        for f in (g._fields if g is not None else ()):
            gv, wv = getattr(g, f).cpu(), getattr(w, f).cpu()
            if part == "quality":
                e = float(((gv - wv).abs() / wv.abs().clamp(min=1e-30)).max())
                if not e <= QUALITY_RTOL:
                    raise AssertionError(f"{what}: quality.{f} card vs CPU relative {e} > "
                                         f"{QUALITY_RTOL}")
            elif wv.is_floating_point():
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


# the eight presets of the threshold modes, the model-resolution and shape
# postprocess, the letterbox and dynamic ROI, the quality gate and the tracker
PRESET_PATHS = ("video_full", "optimized", "simple_7class", "strict", "v3_high_quality",
                "robust", "spatial", "roi_first")
# B1 launches of each one's step, on clusters of 8 (planes of 256^2 and
# 512^2) and of 16 (448x800): the 7-class presets label cable and tape at
# their model's 256^2, analyze_defects labels holes, tape and cable at the
# frame, the tracker its defect components; v3's close sends the cable and
# tape labels to the frame; robust labels cable, tape ring and both
# diameters at the frame; spatial and roi_first gate at their 512^2 and
# label the diameters at the frame, roi_first after the Canny hysteresis of
# its dynamic ROI on the frame
PRESET_B1 = {"video_full": (2, 3), "optimized": (2, 4), "simple_7class": (2, 0),
             "strict": (2, 0), "v3_high_quality": (0, 5), "robust": (0, 4), "spatial": (2, 2),
             "roi_first": (2, 3)}


def preset_colour_model(num_classes: int) -> nn.Module:
    """The colour->class model of a preset's class count."""
    return ColourDefectModel(num_classes) if num_classes > 3 else ColourClassModel()


def preset_scenes(name: str, b: int, h: int, w: int, seed: int) -> np.ndarray:
    """Frames for one of PRESET_PATHS: defect scenes with a patch of each
    defect class for the presets of more than 3 classes, wrap scenes for
    the others (roi_first's without the band across the cable, so that the
    cable in its crop is one tall component its aspect gate keeps)."""
    from unet_tpu_torch.pipeline import presets

    n = presets.get_preset(name).segment.num_classes
    if n > 3:
        return defect_scenes(b, h, w, seed=seed, classes=n - 3)
    return wrap_scenes(b, h, w, seed=seed, band=name != "roi_first")


def phase_presets(cfgs, expect, H, W, device="cuda", b=8, reps=5, models=True):
    """The eight PRESET_PATHS ({path: config} `cfgs`) on `device` at b on
    HxW frames, each at its own model size and class count. With its colour->class model: the B1
    inputs recorded, one batch driven with every launch count checked
    (`_drive`), cable and tape in every frame (and a defect component of
    each class, where the preset tracks them), the whole batch against the
    same step on the CPU (`_compare_outputs`), then ms per batch
    (`_time_step`) and, on the card, a profile (device busy time, idle
    share). With a
    seeded full-width NestedUNet (`models`): one batch driven, then ms per
    batch (`_time_step`). Returns (B1 inputs, {path: counts}, {check:
    value}, {path: record})."""
    from unet_tpu_torch.pipeline import presets, stages

    cc_rec, counts, checks, timings = {}, {}, {}, {}
    for name in PRESET_PATHS:
        cfg = cfgs[name]
        n, size = cfg.segment.num_classes, cfg.preprocess.model_size[0]
        frames = torch.from_numpy(preset_scenes(name, b, H, W, seed=0)).to(device)
        prev = frames[1:2] if cfg.inspect.quality_stats else None
        step = stages.build_step(preset_colour_model(n), cfg, device=device)
        rec = _record_main_path_inputs(lambda f: step(f, prev), frames, name)[0]
        cc_rec.update(rec)
        out, counts[name] = _drive(lambda f: step(f, prev), frames, expect[name],
                                   f"{name}, colour->class model, b={b}, {W}x{H}, model {size}^2")
        _check_outputs(out, b, H, W, f"{name} colour run")
        if int(out.cable_px.min()) == 0 or int(out.tape_px.min()) == 0:
            raise AssertionError(f"{name} colour run: a frame without cable or tape "
                                 f"({out.cable_px.tolist()}, {out.tape_px.tolist()})")
        comps = out.defect_components
        if comps is not None and int(comps.valid.sum(-1).min()) < n - 3:
            raise AssertionError(f"{name} colour run: defect components "
                                 f"{comps.valid.sum(-1).tolist()}")
        t = time.time()
        ref = stages.build_step(preset_colour_model(n), cfg, device="cpu")(
            frames.cpu(), None if prev is None else prev.cpu())
        cpu_s = time.time() - t
        checks[f"{name}_float_max_abs_err_card_vs_cpu"] = _compare_outputs(out, ref, name)
        sites = {k.split("/", 1)[1]: f"{tuple(v[0].shape)} {_route_name(v[0])}"
                 for k, v in rec.items()}
        _log(f"  {name}: card == CPU at b={b} (CPU step {cpu_s:.1f} s): class_map, px "
             f"counts, integer fields; floats within "
             f"{checks[f'{name}_float_max_abs_err_card_vs_cpu']:.3e}; cable_px "
             f"{out.cable_px.tolist()}, tape_px {out.tape_px.tolist()}"
             + (f", defect areas {out.defects.total_defect_area.tolist()}"
                if out.defects is not None else "")
             + (f", defect components {comps.valid.sum(-1).tolist()}" if comps is not None
                else "") + f"; B1 sites {sites}")
        colour = lambda f: step(f, prev)
        colour_ms = _time_step(colour, frames, reps)
        rec_t = dict(model_size=size, classes=n, b1_sites=sites, colour_cpu_seconds=cpu_s,
                     colour_ms=colour_ms)
        _log(f"  {name} colour->class b={b}: {colour_ms:.3f} ms/batch (masks with cable, tape "
             f"and defects)")
        if torch.device(device).type == "cuda":
            rec_t["colour_profile"] = _profile_step(colour, frames, colour_ms,
                                                    f"{name} colour->class b={b}")
        if models:
            model = seeded_nested_unet(num_classes=n)
            nstep = stages.build_step(model, cfg, device=device)
            nframes = torch.from_numpy(preset_scenes(name, b, H, W, seed=10)).to(device)
            outn, _ = _drive(nstep, nframes, expect[name],
                             f"{name}, NestedUNet {size}^2 {n} classes, b={b}")
            _check_outputs(outn, b, H, W, f"{name} NestedUNet")
            ms = _time_step(nstep, nframes, reps)
            rec_t.update(ms=ms, frames_per_s=b / ms * 1e3, cable_px=outn.cable_px.tolist())
            _log(f"{name} NestedUNet fp32 {size}^2 b={b}: {ms:.3f} ms/batch, "
                 f"{b / ms * 1e3:.2f} frames/s (device-resident frames; cable_px "
                 f"{outn.cable_px[:4].tolist()}...)")
            del model, nstep
        timings[name] = rec_t
    return cc_rec, counts, checks, timings


def _route_name(state0) -> str:
    """B1's route for the plane of `state0`: "cluster8", "cluster16" or
    "global"."""
    from unet_tpu_torch.ops import cc_kernels

    which, K = cc_kernels.route(*state0.shape[-2:])
    return f"{which}{K or ''}"


def _gate_rows(step, cfg, src, ecfg, batch):
    """skipped.csv, events.csv and confirmed_defects.csv rows of the engine
    over the image directory `src`, made from `step` directly: batches of
    `batch` as the reader gives them, each with the previous batch's last
    valid frame (the first batch's own first frame), through the host's
    FrameQualityGate and DefectTracker as the engine runs them."""
    from unet_tpu_torch.inspect import DefectTracker, FrameQualityGate
    from unet_tpu_torch.io.video import ImageDirReader
    from unet_tpu_torch.pipeline.engine import CLASS_NAMES

    gate = FrameQualityGate(True, ecfg.quality_blur_th, ecfg.quality_flat_th,
                            ecfg.quality_motion_th, ecfg.quality_glitch_flat_th)
    tracker = (DefectTracker(ecfg.tracker_confirm_frames, ecfg.tracker_iou,
                             ecfg.tracker_stale_frames, CLASS_NAMES)
               if ecfg.tracker_enabled else None)
    skipped, events, confirmed, prev_last = [], [], [], None
    for ids, frames, n_valid in ImageDirReader(src).batches(batch):
        prev = frames[:1] if prev_last is None else prev_last
        prev_last = frames[n_valid - 1:n_valid].copy()
        out = step(frames, prev)
        rows = _events_rows(out, ids, n_valid, cfg)
        q = [t.cpu().numpy() for t in out.quality]
        c = {f: getattr(out.defect_components, f).cpu().numpy()
             for f in out.defect_components._fields} if tracker else None
        for i in range(n_valid):
            r = gate.check(float(q[0][i]), float(q[1][i]), float(q[2][i]))
            if r.is_bad:
                skipped.append([str(ids[i]), r.reason, f"{r.lap_var:.2f}", f"{r.gray_std:.2f}",
                                f"{r.mad:.2f}"])
                continue
            events.append(rows[i])
            if tracker is not None:
                dets = [{"class_id": int(c["class_id"][i, k]),
                         "bbox": (float(c["left"][i, k]), float(c["top"][i, k]),
                                  float(c["left"][i, k] + c["width"][i, k]),
                                  float(c["top"][i, k] + c["height"][i, k])),
                         "area": int(c["area"][i, k])}
                        for k in range(c["valid"].shape[-1]) if c["valid"][i, k]]
                confirmed += [[str(d["defect_id"]), d["type"], str(d["class_id"]),
                               str(d["start_frame"]), str(d["duration"]), str(d["area"]),
                               f"{d['confidence']:.2f}"] for d in tracker.update(dets, ids[i])]
    return skipped, events, confirmed


def phase_inspect_engine(H=448, W=800, n_frames=48, batch=8, device="cuda"):
    """`optimized` and `video_full` through `InferenceEngine` on `device`
    with the 7-class colour->class model over `n_frames` HxW .bmp frames of
    `gate_scenes` (flat, blurred and frozen frames among scenes whose defect
    patches persist): each run counted alone (B1 as PRESET_B1 says for each
    batch), and every skipped.csv, events.csv and confirmed_defects.csv row
    equal to the step's own through the host's gate and tracker
    (`_gate_rows`), skipped.csv's numbers within 1e-4 relative or their
    last printed digit. Returns ({path: launch counts per batch}, record)."""
    import tempfile

    from unet_tpu_torch.pipeline import (EngineConfig, InferenceEngine, engine_hints, presets,
                                         stages)

    counts, record = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gate_") as tmp:
        tmp = Path(tmp)
        src = write_bmp_dir(tmp / "frames", gate_scenes(n_frames, H, W, seed=3))
        for name in ("optimized", "video_full"):
            cfg = presets.get_preset(name)
            ecfg = EngineConfig(**dict(engine_hints(name), batch=batch, write_video=False,
                                       print_interval=10 ** 6, output_dir=str(tmp / name)))
            eng = InferenceEngine(ColourDefectModel(7), cfg, ecfg, device=device)
            _zero_counts()
            summary = eng.process_video(src)
            got = _read_counts()
            nb = -(-summary["processed"] // batch)
            per = _per_batch(got, nb, f"engine {name}")
            k8, k16 = PRESET_B1[name] if torch.device(device).type == "cuda" else (0, 0)
            if (per["cc_propagate_cluster8"], per["cc_propagate_cluster16"]) != (k8, k16):
                raise AssertionError(f"engine {name}: launches per batch {per}, expected "
                                     f"{(k8, k16)} on clusters of 8 and 16")
            step = stages.build_step(eng.model, cfg, device=device)
            skipped, events, confirmed = _gate_rows(step, cfg, src, ecfg, batch)
            out = tmp / name
            got_sk = _read_csv(out / "skipped.csv")
            if [r[:2] for r in got_sk] != [r[:2] for r in skipped]:
                raise AssertionError(f"engine {name}: skipped.csv frames or reasons differ "
                                     f"from the step's: {got_sk} vs {skipped}")
            for g, w in zip(got_sk, skipped):
                for a, b in zip(g[2:], w[2:]):
                    if not abs(float(a) - float(b)) <= max(QUALITY_RTOL * abs(float(b)), 0.01):
                        raise AssertionError(f"engine {name}: skipped.csv row {g} vs {w}")
            if _read_csv(out / "events.csv") != events:
                raise AssertionError(f"engine {name}: events.csv differs from the step's")
            if ecfg.tracker_enabled and _read_csv(out / "confirmed_defects.csv") != confirmed:
                raise AssertionError(f"engine {name}: confirmed_defects.csv differs from the "
                                     f"step's")
            reasons = sorted({r[1] for r in skipped})
            if len(reasons) < 2 or (ecfg.tracker_enabled and len(confirmed) < 4):
                raise AssertionError(f"engine {name}: reasons {reasons}, {len(confirmed)} "
                                     f"confirmed defects")
            counts[f"engine_{name}"] = per
            record[name] = dict(launches=got, batches=nb, skipped=len(skipped),
                                reasons=reasons, confirmed=len(confirmed),
                                **{k: summary[k] for k in ("processed", "fps", "skipped_frames",
                                                           "confirmed_defects")})
            _log(f"main path (engine {name}, gate and tracker, {nb} batches of {batch}, "
                 f"{W}x{H}): launches {got}; {len(skipped)} frames skipped ({reasons}), "
                 f"{len(events)} events rows, {len(confirmed)} confirmed defects, all = the "
                 f"step's; {summary['fps']} frames/s")
    return counts, record


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


def write_bmp(path, img: np.ndarray) -> None:
    """(H, W, 3) uint8 BGR as an uncompressed 24-bit BMP with numpy, byte for
    byte what cv2.imwrite writes: bottom-up rows, each padded to 4 bytes."""
    h, w = img.shape[:2]
    stride = (3 * w + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = img[::-1].reshape(h, 3 * w)
    head = struct.pack("<2sIHHIIiiHHIIiiII", b"BM", 54 + rows.size, 0, 0, 54, 40, w, h,
                       1, 24, 0, 0, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(head)
        f.write(rows.tobytes())


def write_bmp_dir(path, frames: np.ndarray) -> str:
    """`frames` as f_0000.bmp, f_0001.bmp, ... in the new directory `path`."""
    path.mkdir(parents=True)
    for i, f in enumerate(frames):
        write_bmp(path / f"f_{i:04d}.bmp", f)
    return str(path)


# B1 and qconv launches per engine batch of each CLI path (chip_smoke.main's
# expectations per step): two_stage's hysteresis and CC filter; int8's 18
# convs; production's 2 + 5 labels; the wrap presets' cable and tape labels
ENGINE_PER_BATCH = {"two_stage_bf16": dict(cc_propagate=2, qconv=0),
                    "two_stage_int8": dict(cc_propagate=2, qconv=18),
                    "wrap_uniformity": dict(cc_propagate=2, qconv=0),
                    "production": dict(cc_propagate=7, qconv=0),
                    "serve_wrap_7class": dict(cc_propagate=2, qconv=0),
                    # ROADMAP A8: the burr crop of the turned frames; debug has no B1 site
                    "high_res_roi": dict(cc_propagate=2, qconv=0),
                    "debug": dict(cc_propagate=0, qconv=0),
                    "optimized": dict(cc_propagate=sum(PRESET_B1["optimized"]), qconv=0),
                    # `cli infer --config`: production's YAML as the preset; the
                    # AppCfg layout (ROI; burr on its crop, cable and tape labels
                    # at the frame); the RefactorConfig layout (laplacian burr:
                    # its CC filter; the shape postprocess' cable and tape
                    # labels; the diameters' two)
                    "config_production": dict(cc_propagate=7, qconv=0),
                    "config_app_cfg": dict(cc_propagate=4, qconv=0),
                    "config_refactor_cfg": dict(cc_propagate=5, qconv=0)}


def _events_rows(out, ids, n_valid, cfg):
    """events.csv rows of one step's outputs, as the engine formats them."""
    h, w = out.class_map.shape[-2:]
    area = h * w
    if cfg.roi is not None:
        r = cfg.roi.scaled((w, h)) if cfg.roi.space != (w, h) else cfg.roi
        area = (r.x2 - r.x1) * (r.y2 - r.y1)
    cable, tape, burr = (getattr(out, f).cpu().numpy() for f in ("cable_px", "tape_px", "burr_px"))
    return [[str(ids[i]), f"{cable[i] / area * 100:.2f}", f"{tape[i] / area * 100:.2f}",
             f"{burr[i] / area * 100:.2f}", str(int(burr[i])),
             "[BURR!]" if burr[i] > 0 else "[OK]"] for i in range(n_valid)]


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))[1:]


def _per_batch(got: dict, nb: int, what: str) -> dict:
    """Launch counts of a run of `nb` batches, per batch; every count must be
    an exact multiple of `nb`."""
    if any(v % nb for v in got.values()):
        raise AssertionError(f"{what}: launches {got} are not the same in each of {nb} batches")
    return {c: v // nb for c, v in got.items()}


def engine_run(path: str, src: str, pth: str, flags, out, device="cuda", batch: int = 8):
    """`cli infer` (`cli.main.main`) over the image directory `src` with the
    model `pth` (None: the CLI's seeded weights of `--arch` in `flags`) and
    `flags`, counted alone: every launch count set to 0 as
    `process_video` starts and read as it ends, B1 and qconv launched as
    ENGINE_PER_BATCH[path] says for each batch (none on the CPU); every
    events.csv row equal to the same frames through `stages.build_step` with
    the engine's own model and config, in the engine's batches. Returns
    (launch counts per batch, record with the whole run's counts)."""
    from unet_tpu_torch.cli import main as cli
    from unet_tpu_torch.io.video import ImageDirReader
    from unet_tpu_torch.pipeline import engine as engine_mod
    from unet_tpu_torch.pipeline import stages

    seen = {}
    real = engine_mod.InferenceEngine.process_video

    def counted(self, *a, **kw):
        _zero_counts()
        summary = real(self, *a, **kw)
        seen.update(engine=self, summary=summary, counts=_read_counts())
        return summary

    engine_mod.InferenceEngine.process_video = counted
    try:
        t = time.time()
        model = ["--model", pth] if pth else []
        rc = cli.main(["infer", "--video", src, "--output", str(out), *model,
                       "--no-video", "--batch", str(batch), "--device", device] + list(flags))
        seconds = time.time() - t
    finally:
        engine_mod.InferenceEngine.process_video = real
    eng, summary, got = seen["engine"], seen["summary"], seen["counts"]
    if rc != 0:
        raise AssertionError(f"cli infer {path}: exit code {rc}")
    nb = -(-summary["processed"] // batch)
    cuda = torch.device(device).type == "cuda"
    want = {c: n * nb if cuda else 0 for c, n in ENGINE_PER_BATCH[path].items()}
    if {c: got[c] for c in want} != want:
        raise AssertionError(f"cli infer {path}: launches {got}, expected {want} ({nb} batches)")
    step = stages.build_step(eng.model, eng.cfg, device=device)
    rows = []
    for ids, frames, n_valid in ImageDirReader(src).batches(batch):
        rows += _events_rows(step(frames), ids, n_valid, eng.cfg)
    if eng.quality_gate is not None:
        # the frames the gate skipped have no events row (phase_inspect_engine
        # holds the gate itself against the step)
        skipped = {r[0] for r in _read_csv(out / "skipped.csv")}
        rows = [r for r in rows if r[0] not in skipped]
    if _read_csv(out / "events.csv") != rows:
        raise AssertionError(f"cli infer {path}: events.csv differs from the step's")
    files = sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file())
    if eng.ecfg.wrap_monitor_enabled and "wrap_uniformity.csv" not in files:
        raise AssertionError(f"cli infer {path} wrote no wrap_uniformity.csv")
    # a window closes at the latest after window_max_frames frames (the
    # frames the gate skipped do not count)
    if (eng.ecfg.window_enabled and summary["total_windows"] == 0
            and summary["processed"] - summary["skipped_frames"] >= eng.ecfg.window_max_frames):
        raise AssertionError(f"cli infer {path} closed no window")
    _log(f"main path (engine, cli infer {' '.join(flags)}, {nb} batches of {batch}): "
         f"launches {got}; events.csv = the step's on {summary['processed']} frames; "
         f"{len(files)} files; {seconds:.1f} s with start-up, engine {summary['fps']} frames/s")
    return _per_batch(got, nb, f"cli infer {path}"), dict(
        seconds=seconds, launches=got, batches=nb, files=len(files),
        **{k: summary[k] for k in ("processed", "fps", "legs_ms_per_frame", "batch_latency_ms",
                                   "burr_frames", "total_windows", "ng_windows")})


def phase_engine(H=448, W=800, n_frames=96, timing_frames=2048, timing_distinct=256,
                 batches=(8, 32), timed_calls=2, model_size=None, device="cuda"):
    """The product loop through the port's CLI (`cli.main.main`) on `device`,
    on `n_frames` HxW frames written as .bmp files with numpy: `infer
    --preset two_stage` with a seeded 3-class NestedUNet saved as a .pth, in
    bf16 (the BN-folded fast forward) and with `--int8`; `infer --preset
    wrap_uniformity` (4 classes) on wrap scenes; `infer --preset production`
    (window events and NG evidence, JPEGs through OpenCV); and `serve
    --preset wrap_7class` (7 classes) over both directories. Each engine run
    is counted alone (every launch count set to 0 as `process_video` starts,
    read as it ends) and must launch B1 and qconv as ENGINE_PER_BATCH says
    for each batch; every events.csv and results.csv row must equal the same
    frames through `stages.build_step` with the engine's own model and
    config. Then the synchronising calls left in one bf16 and one int8
    two_stage step (`torch.cuda.set_sync_debug_mode`). Then, over a directory
    of `timing_frames` files, hard links to `timing_distinct` other frames in
    turn: the .bmp decode by `read_bmp` and by `cv2.imread`, and the engine's
    frames/s, legs and batch latency for bf16 and int8 at each batch size
    (one warm-up call, then the median of `timed_calls`; p99 only where a
    call has 100 batches or more), beside the bare step on the same frames
    already on the device. Returns ({path: launch counts per batch}, record)."""
    import tempfile

    from unet_tpu_torch.cli import main as cli
    from unet_tpu_torch.io.video import ImageDirReader
    from unet_tpu_torch.pipeline import presets, stages

    cuda = torch.device(device).type == "cuda"
    size = ["--model-size", str(model_size)] if model_size else []
    record, counts = {"runs": {}}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_engine_") as tmp:
        tmp = Path(tmp)
        t = time.time()
        two = write_bmp_dir(tmp / "two_stage", synthetic_frames(n_frames, H, W, seed=0))
        wrap = write_bmp_dir(tmp / "wrap", wrap_scenes(n_frames, H, W, seed=0))
        gate = write_bmp_dir(tmp / "gate", gate_scenes(n_frames // 2, H, W, seed=0))
        pth = {}
        for k in (3, 4, 7):
            pth[k] = str(tmp / f"nested_unet_{k}.pth")
            torch.save(seeded_nested_unet(num_classes=k).state_dict(), pth[k])
        _log(f"engine: {2 * n_frames + n_frames // 2} {W}x{H} .bmp frames and 3 seeded .pth written in "
             f"{time.time() - t:.1f} s")

        for path, (src, k, flags) in {
                "two_stage_bf16": (two, 3, ["--preset", "two_stage"]),
                "two_stage_int8": (two, 3, ["--preset", "two_stage", "--int8"]),
                "wrap_uniformity": (wrap, 4, ["--preset", "wrap_uniformity"]),
                "production": (two, 3, ["--preset", "production"]),
                "optimized": (gate, 7, ["--preset", "optimized"])}.items():
            counts[f"engine_{path}"], record["runs"][path] = engine_run(
                path, src, pth[k], flags + size, tmp / f"out_{path}", device)

        out = tmp / "out_serve"
        _zero_counts()
        rc = cli.main(["serve", "--videos", two, wrap, "--output", str(out), "--preset",
                       "wrap_7class", "--model", pth[7], "--device", device] + size)
        got = _read_counts()
        summary = json.loads((out / "serve_summary.json").read_text())
        want = {c: n * summary["batches"] if cuda else 0
                for c, n in ENGINE_PER_BATCH["serve_wrap_7class"].items()}
        if rc != 0 or {c: got[c] for c in want} != want:
            raise AssertionError(f"cli serve: exit code {rc}, launches {got}, expected {want}")
        counts["engine_serve_wrap_7class"] = _per_batch(got, summary["batches"], "cli serve")
        model7, _, _ = cli.load_model(pth[7], "nested_unet", "bfloat16", 7)
        cfg7 = presets.get_preset("wrap_7class").replace_in("segment", fast_forward=True)
        if model_size:
            cfg7 = cfg7.replace_in("preprocess", model_size=(model_size, model_size))
        step = stages.build_step(model7, cfg7, device=device)
        srcs = [list(ImageDirReader(d).frames()) for d in (two, wrap)]
        want_rows = [[], []]
        for (fid, a), (_, b) in zip(*srcs):
            o = step(np.stack([a, b]))
            for s in range(2):
                want_rows[s].append([str(fid)] + [str(int(getattr(o, f)[s])) for f in
                                                  ("cable_px", "tape_px", "burr_px")]
                                    + [f"{float(o.diameters.dc_px[s]):.2f}",
                                       f"{float(o.diameters.dt_px[s]):.2f}"])
        for s, name in enumerate(("two_stage", "wrap")):
            if _read_csv(out / f"stream_{s:02d}_{name}" / "results.csv") != want_rows[s]:
                raise AssertionError(f"cli serve: results.csv of stream {s} differs from the "
                                     f"step's")
        record["runs"]["serve_wrap_7class"] = dict(launches=got, **summary)
        _log(f"main path (engine, cli serve --preset wrap_7class, 2 streams, "
             f"{summary['batches']} batches): launches {got}; results.csv = the step's; "
             f"{summary['fps']} frames/s")

        # the synchronising calls left in the step; a .item() on its output
        # is the control that the detector sees one
        record["sync_debug"] = {}
        frames8 = torch.from_numpy(synthetic_frames(8, H, W, seed=3)).to(device)
        model = seeded_nested_unet(dtype=torch.bfloat16)
        base = presets.two_stage().replace_in("segment", fast_forward=True)
        if model_size:
            base = base.replace_in("preprocess", model_size=(model_size, model_size))
        qcfg = stages.calibrate_int8(model, base, [frames8.cpu().numpy()], device=device)
        for path, cfg in (("two_stage_bf16", base), ("two_stage_int8", qcfg)):
            step = stages.build_step(model, cfg, device=device)
            step(frames8)
            if cuda:
                sites = _sync_sites(lambda: step(frames8))
                control = _sync_sites(lambda: step(frames8).burr_px.sum().item())
                if sum(control.values()) <= sum(sites.values()):
                    raise AssertionError(f"sync debug mode did not see the control's .item(): "
                                         f"{control}")
                record["sync_debug"][path] = sites
                _log(f"sync debug ({path} step, b=8): {sum(sites.values())} synchronising "
                     f"calls" + "".join(f"\n  {n} x {k}" for k, n in sites.items())
                     + f"; the step and a .item() on its output (control): "
                     f"{sum(control.values())}")

        # the engine's throughput against the bare step, on other frames
        distinct = write_bmp_dir(tmp / "timing_distinct",
                                 synthetic_frames(timing_distinct, H, W, seed=1000))
        files = ImageDirReader(distinct).paths
        timing = tmp / "timing"
        timing.mkdir()
        for i in range(timing_frames):
            os.link(files[i % len(files)], timing / f"f_{i:05d}.bmp")
        timing = str(timing)
        record["decode_ms_per_frame"] = _decode_ms(files)
        _log(f"decode of {len(files)} {W}x{H} .bmp files, ms a frame (median of 3 passes): "
             f"{record['decode_ms_per_frame']}")
        frames_dev = torch.from_numpy(np.stack([f for _, f in ImageDirReader(distinct).frames()])
                                      ).to(device)
        passes = timing_frames // timing_distinct
        record["timing"] = {}
        for path, flags in (("two_stage_bf16", []), ("two_stage_int8", ["--int8"])):
            args = cli.build_parser().parse_args(
                ["infer", "--video", timing, "--output", str(tmp / f"time_{path}"), "--model",
                 pth[3], "--no-video", "--device", device, "--print-interval", "100000"]
                + flags + size)
            eng = cli.infer_engine(args)
            if flags and not eng.cfg.segment.int8_scales:
                raise AssertionError("engine timing: --int8 fell back to the bf16 forward")
            step = stages.build_step(eng.model, eng.cfg, device=device)
            for b in batches:
                eng.ecfg = eng.ecfg.merged(batch=b)
                eng.process_video(timing)     # warm-up
                calls = [eng.process_video(timing) for _ in range(timed_calls)]
                med = lambda f: float(np.median([f(c) for c in calls]))
                rec = dict(
                    engine_fps=med(lambda c: c["fps"]),
                    engine_fps_calls=[c["fps"] for c in calls],
                    legs_ms_per_frame={k: med(lambda c: c["legs_ms_per_frame"][k])
                                       for k in calls[0]["legs_ms_per_frame"]},
                    batches=-(-timing_frames // b),
                    batch_latency_ms={k: med(lambda c: c["batch_latency_ms"][k])
                                      if k != "p99" or timing_frames >= 100 * b else None
                                      for k in ("p50", "p99", "max")},
                    bare_step_fps=_bare_step_fps(step, frames_dev, b, passes))
                record["timing"][f"{path}_b{b}"] = rec
                _log(f"engine {path} b={b}, {timing_frames} {W}x{H} .bmp frames "
                     f"({rec['batches']} batches): "
                     f"{rec['engine_fps']:.2f} frames/s (median of {rec['engine_fps_calls']}), "
                     f"legs ms a frame {rec['legs_ms_per_frame']}, batch latency ms "
                     f"{rec['batch_latency_ms']} (medians); the bare step on the same frames "
                     f"on the device {rec['bare_step_fps']:.2f} frames/s")
    return counts, record


def _sync_sites(fn) -> dict:
    """{"file:line: message": count} of the synchronising CUDA calls that
    `fn` makes, as torch.cuda.set_sync_debug_mode("warn") reports them
    (without its own note that the mode is a prototype)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sites = {}
    for w in caught:
        if "prototype" in str(w.message):
            continue
        key = f"{Path(w.filename).name}:{w.lineno}: {str(w.message)[:80]}"
        sites[key] = sites.get(key, 0) + 1
    return sites


def _bare_step_fps(step, frames_dev, b: int, passes: int = 1) -> float:
    """frames/s of `step` over `passes` passes of device-resident frames in
    batches of `b` (the last one of a pass short), after one warm-up batch;
    host clock to a synchronize."""
    step(frames_dev[:b])
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(passes):
        for i in range(0, len(frames_dev), b):
            step(frames_dev[i:i + b])
    torch.cuda.synchronize()
    return passes * len(frames_dev) / (time.perf_counter() - t)


def _decode_ms(files) -> dict:
    """ms a frame to decode `files` by the port's numpy decoder and by
    cv2.imread, each the median of 3 passes after a warm-up pass, the two
    alternating; the two must give the same frames."""
    import cv2

    from unet_tpu_torch.io.video import read_bmp

    for f in files[:4]:
        if not np.array_equal(read_bmp(f), cv2.imread(str(f), cv2.IMREAD_COLOR)):
            raise AssertionError(f"read_bmp and cv2.imread differ on {f}")
    ways = {"read_bmp": read_bmp, "cv2.imread": lambda f: cv2.imread(str(f), cv2.IMREAD_COLOR)}
    runs = {k: [] for k in ways}
    for rep in range(4):
        for k, fn in ways.items():
            t = time.perf_counter()
            for f in files:
                fn(f)
            if rep:
                runs[k].append((time.perf_counter() - t) * 1e3 / len(files))
    return {k: float(np.median(v)) for k, v in runs.items()}


def _conv_gflop(model: nn.Module, hw) -> float:
    """GFLOP (2 x multiply-adds) of every convolution, transposed ones
    included, in one frame's forward at `hw`, counted from the layers'
    shapes."""
    total = 0

    def hook(m, inp, out):
        nonlocal total
        k = m.kernel_size[0] * m.kernel_size[1]
        if isinstance(m, nn.ConvTranspose2d):   # each input pixel meets Cout x k taps
            total += 2 * inp[0].numel() * (m.out_channels // m.groups) * k
        else:
            total += 2 * out.numel() * (m.in_channels // m.groups) * k

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
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
        return None
    idle = max(0.0, 1 - busy / 1e3 / step_ms)
    _log(f"profile ({what}, one b={frames.shape[0]} step): device busy {busy / 1e3:.3f} ms "
         f"of {step_ms:.3f} ms per step, idle share {idle:.4f}")
    for name in ("nlm_kernel", "cc_propagate_cluster_kernel", "cc_propagate_global_kernel",
                 "qconv_wgmma_kernel", "qconv_c3_kernel", "qconv_sync_kernel"):
        t = sum(dev(e) for e in evts if name in e.key)
        calls = sum(e.count for e in evts if name in e.key)
        _log(f"  {name}: {t / 1e3:.3f} ms x{calls}, {t / busy:.4f} of device busy time")
    for e in sorted(evts, key=dev, reverse=True)[:12]:
        _log(f"  {dev(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")
    return dict(busy_ms=busy / 1e3, idle_share=idle)


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


# ---------------------------------------------------------------------------
# the model zoo: the ResNet50 NestedUNet, SimpleUNet and the lightweight UNet++
# with its six encoders; `cli infer --config`; the device trace
# ---------------------------------------------------------------------------

MODEL_ARCHS = ("nested_unet_resnet50", "simple_unet") + tuple(
    f"lightweight:{e}" for e in ("custom", "resnet18", "resnet34", "mobilenet_v3_small",
                                 "mobilenet_v3_large", "shufflenet_v2_x1_0"))
# fp32 logits, card against the CPU: the gates of tests/test_models_parity.py
# (:42, and :125 for the resnet50 encoder's deeper stack), stated there for
# logits of order 1. The seeded residual encoders' logits reach 1e3 (no
# trained BN statistics hold their sums down), so the absolute part of the
# gate, and the tie gap, scale with the largest logit where it passes 1
MODEL_ATOL = {"nested_unet_resnet50": 2e-3}
TIE_GAP = 1e-3          # pixels whose two largest reference logits lie closer are ties
BF16_AGREE = 0.995      # bf16 class maps against the fp32 step's (PERF.md §2)


class LogitsTap(nn.Module):
    """`model`, keeping the logits (the first head) of its last forward."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model
        self.logits = None

    def forward(self, x):
        y = self.model(x)
        self.logits = (y[0] if isinstance(y, (list, tuple)) else y).detach()
        return y


def tie_pixels(logits: torch.Tensor, gap: float = TIE_GAP) -> torch.Tensor:
    """(B, h, w) bool: the pixels of (B, C, h, w) logits whose two largest
    values lie within `gap` of each other."""
    top2 = logits.float().topk(2, dim=1).values
    return (top2[:, 0] - top2[:, 1]) < gap


def compare_with_ties(got, want, got_logits, want_logits, what: str,
                      gap: float = TIE_GAP) -> dict:
    """A step's outputs `got` against the reference's `want` on the same
    frames (class_map, cable_px, tape_px, burr_px: tensors or arrays), given
    both steps' logits (B, C, h, w) and a step whose masks reach the frame
    by a nearest resize; the first B frames of each are compared, B being
    the reference logits'. The argmax may differ only on tie pixels of the
    reference logits (`tie_pixels` with `gap`); a frame with no argmax flip
    must give equal class maps and px counts; in a frame with a flip the
    class maps may differ only in the frame footprint of the tie pixels and
    where either side has burr (the burr stage reads the cable mask).
    Returns the counts of tie pixels, flips and differing class-map
    pixels."""
    from unet_tpu_torch.ops.image import resize_nearest

    n = want_logits.shape[0]
    def field(out, f):
        v = getattr(out, f)[:n]
        return v.cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))

    got_logits, want_logits = got_logits[:n].float().cpu(), want_logits.float().cpu()
    ties = tie_pixels(want_logits, gap)
    flips = got_logits.argmax(1) != want_logits.argmax(1)
    if bool((flips & ~ties).any()):
        raise AssertionError(f"{what}: the argmax differs off the tie pixels")
    gm, wm = field(got, "class_map"), field(want, "class_map")
    foot = resize_nearest(ties, gm.shape[-2:], channel_dim=False)
    diff = gm != wm
    px = {f: (field(got, f), field(want, f)) for f in ("cable_px", "tape_px", "burr_px")}
    for i in range(n):
        if not bool(flips[i].any()):
            if bool(diff[i].any()) or any(int(a[i]) != int(b[i]) for a, b in px.values()):
                raise AssertionError(f"{what}: frame {i} differs with no argmax flip")
        elif bool((diff[i] & ~(foot[i] | (gm[i] == 3) | (wm[i] == 3))).any()):
            raise AssertionError(f"{what}: frame {i} differs off its tie pixels and burr")
    return dict(tie_pixels=int(ties.sum()), flips=int(flips.sum()),
                class_map_diff=int(diff.sum()))


# the models whose BN statistics `calibrated_model` draws from their own
# activations, held card against CPU to the unscaled logits gate
CALIBRATED_ARCHS = ("nested_unet_resnet50",)
CALIBRATED_TOL = dict(atol=1e-3, rtol=1e-3)


def _calibrated_check(arch, frames, cfg, b_cpu, device) -> dict:
    """`calibrated_model(arch)` through the two_stage step, card against CPU
    on the first b_cpu frames: fp32 logits within CALIBRATED_TOL, unscaled."""
    import copy

    from unet_tpu_torch.pipeline import stages

    model = calibrated_model(arch, frames, cfg, device)
    taps = {"card": LogitsTap(model), "cpu": LogitsTap(copy.deepcopy(model).cpu())}
    stages.build_step(taps["card"], cfg, device=device)(frames[:b_cpu])
    stages.build_step(taps["cpu"], cfg, device="cpu")(frames[:b_cpu].cpu())
    got, want = taps["card"].logits.float().cpu(), taps["cpu"].logits.float()
    err = float((got - want).abs().max())
    peak = float(want.abs().max())
    _log(f"model {arch}, BN statistics from one train-mode pass over the frames: logits up to "
         f"{peak:.3f}, card vs cpu max abs err {err:.3e} (unscaled gate {CALIBRATED_TOL})")
    if not torch.allclose(got, want, **CALIBRATED_TOL):
        raise AssertionError(f"{arch} with calibrated BN statistics: card logits differ from "
                             f"the CPU's by {err} (unscaled {CALIBRATED_TOL})")
    return dict(logits_max_abs_err=err, logits_max_abs=peak, **CALIBRATED_TOL)


def phase_models(expect, H, W, archs=MODEL_ARCHS, device="cuda", b=8, b_cpu=2, reps=5,
                 model_size=None, card=""):
    """Every model of the zoo (`archs`, built by the CLI's `_build_model`
    with `seeded_model`'s weights) through the `two_stage` step on b HxW
    `synthetic_frames`, in fp32 and bf16, at the preset's model size (or
    `model_size`): B1's inputs of the fp32 step recorded, each step driven
    once with its launches held to `expect` (`_drive`); the fp32 logits of
    the first b_cpu frames against the same step on the CPU (plain
    versions) within MODEL_ATOL (rtol 1e-3; both scaled by the largest
    logit where it passes 1), its class maps and px counts with
    `compare_with_ties`; the bf16 class maps against the fp32 step's
    on all b frames at >= BF16_AGREE; ms per batch of each step and of its
    forward alone (CUDA events, fp32 and bf16 in turns), and the forward's
    GFLOP a frame. The small models' times are paced by the host's launches
    (the spin before `_time_ms` hides only 25 ms of them). Returns
    (B1 inputs by site, {path: launch counts}, checks, timings)."""
    from unet_tpu_torch.pipeline import presets, stages

    cfg = presets.two_stage()
    if model_size:
        cfg = cfg.replace_in("preprocess", model_size=(model_size, model_size))
    mw, mh = cfg.preprocess.model_size
    frames = torch.from_numpy(synthetic_frames(b, H, W, seed=20)).to(device)
    x = stages.model_input(stages.preprocess_frames(frames, cfg), cfg).permute(0, 3, 1, 2)
    x = x.contiguous()
    cc_rec, counts, checks, timings = {}, {}, {}, {}
    for arch in archs:
        t0 = time.time()
        tap = LogitsTap(seeded_model(arch))
        step = stages.build_step(tap, cfg, device=device)
        cc_rec.update(_record_main_path_inputs(step, frames, arch)[0])
        out, counts[arch] = _drive(step, frames, expect, f"two_stage {arch} fp32, b={b}, "
                                                         f"{W}x{H}, model {mw}x{mh}")
        _check_outputs(out, b, H, W, f"{arch} fp32")
        card_logits = tap.logits
        tap_cpu = LogitsTap(seeded_model(arch))
        t = time.time()
        ref = stages.build_step(tap_cpu, cfg, device="cpu")(frames[:b_cpu].cpu())
        cpu_s = time.time() - t
        got_l, want_l = card_logits[:b_cpu].float().cpu(), tap_cpu.logits.float()
        err = float((got_l - want_l).abs().max())
        scale = max(1.0, float(want_l.abs().max()))
        atol = MODEL_ATOL.get(arch, 1e-3)
        if not torch.allclose(got_l / scale, want_l / scale, atol=atol, rtol=1e-3):
            raise AssertionError(f"{arch}: fp32 logits differ from the CPU's by {err} "
                                 f"(atol {atol} x {scale:.1f}, rtol 1e-3)")
        ties = compare_with_ties(out, ref, got_l, want_l, f"{arch} fp32", gap=TIE_GAP * scale)
        calibrated = (_calibrated_check(arch, frames, cfg, b_cpu, device)
                      if arch in CALIBRATED_ARCHS else None)
        model16 = seeded_model(arch, dtype="bfloat16")
        step16 = stages.build_step(model16, cfg, device=device)
        out16, counts[f"{arch}_bf16"] = _drive(step16, frames, expect, f"two_stage {arch} bf16, "
                                                                       f"b={b}")
        _check_outputs(out16, b, H, W, f"{arch} bf16")
        agree = float((out16.class_map == out.class_map).float().mean())
        if agree < BF16_AGREE:
            raise AssertionError(f"{arch}: bf16 class maps agree with fp32 on {agree} < "
                                 f"{BF16_AGREE}")
        # in turns, fp32 bf16 bf16 fp32, each the mean of its two runs
        fns = {"fp32": (tap.model, step), "bf16": (model16, step16)}
        runs = {dt: {"forward_ms": [], "ms": []} for dt in fns}
        with torch.inference_mode():
            for dt in ("fp32", "bf16", "bf16", "fp32"):
                m, st = fns[dt]
                runs[dt]["forward_ms"].append(_time_ms(lambda: stages.forward_logits(m, x), reps))
            gflop = _conv_gflop(tap.model, (mh, mw))
        for dt in ("fp32", "bf16", "bf16", "fp32"):
            runs[dt]["ms"].append(_time_ms(lambda: fns[dt][1](frames), reps))
        fwd = {dt: float(np.mean(r["forward_ms"])) for dt, r in runs.items()}
        ms = {dt: float(np.mean(r["ms"])) for dt, r in runs.items()}
        checks[arch] = dict(logits_max_abs_err=err, logits_scale=scale, atol=atol,
                            cpu_frames=b_cpu, **ties, calibrated=calibrated,
                            bf16_agreement=agree, logits_hw=list(card_logits.shape[-2:]))
        timings[arch] = {dt: dict(ms=ms[dt], frames_per_s=b / ms[dt] * 1e3,
                                  forward_ms=fwd[dt], forward_tflops=gflop * b / fwd[dt],
                                  runs=runs[dt]) for dt in ms}
        timings[arch]["gflop_per_frame"] = gflop
        _log(f"model {arch}: logits {tuple(card_logits.shape[-2:])} for a {mh}x{mw} input; fp32 "
             f"card vs cpu (b={b_cpu}, {cpu_s:.1f} s on the CPU) max abs err {err:.3e}, "
             f"{ties['tie_pixels']} tie pixels, {ties['flips']} argmax flips, "
             f"{ties['class_map_diff']} class-map pixels differ (logits up to {scale:.2f}: gate "
             f"and tie gap x {scale:.2f}); bf16 class maps against fp32 "
             f"{agree:.6f}; {gflop:.2f} GFLOP a frame")
        for dt in ms:
            _log(f"model {arch} {dt} b={b}: {ms[dt]:.3f} ms/batch {runs[dt]['ms']}, "
                 f"{b / ms[dt] * 1e3:.2f} frames/s; forward alone {fwd[dt]:.3f} ms "
                 f"{runs[dt]['forward_ms']} = {gflop * b / fwd[dt]:.2f} TFLOP/s [{card}]")
        _log(f"  ({time.time() - t0:.1f} s for {arch})")
        del tap, tap_cpu, model16, step, step16
    return cc_rec, counts, checks, timings


def config_files(root: Path, H: int, W: int) -> dict:
    """Three `--config` files in `root`: production's PipelineCfg saved as
    YAML (`save_pipeline_yaml`), a legacy AppCfg layout (a 512x512 3-class
    model, the camera's ROI over the cable, the mm scale, and the MQTT and
    event sections the pipeline does not read) and a legacy RefactorConfig
    layout (its ROI, laplacian burr, shape postprocess and event section).
    Returns {path: file}."""
    import yaml

    from unet_tpu_torch.core.config import save_pipeline_yaml
    from unet_tpu_torch.pipeline import presets

    files = {name: root / f"{name}.yaml" for name in ("production", "app_cfg", "refactor_cfg")}
    save_pipeline_yaml(presets.get_preset("production"), str(files["production"]))
    app = {"camera": {"width": W, "height": H, "roi": {"enabled": True, "x": W * 7 // 40, "y": 0,
                                                         "w": W * 27 // 40, "h": H}},
           "model": {"input_size": [512, 512], "num_classes": 3, "weights": "best_model.pth"},
           "scale": {"mm_per_px": 0.04}, "mqtt": {"host": "localhost", "port": 1883},
           "event": {"burr_px": 50}}
    refactor = {"roi": {"x": W // 8, "y": 0, "w": W * 3 // 4, "h": H},
                "burr": {"band_out": 8, "laplacian_threshold": 30, "min_area": 10,
                         "max_area": 800},
                "postprocess": {"cable_min_area": 800, "cable_min_aspect": 1.2,
                                "cable_max_center_offset": 0.4, "tape_ring_dilate": 15,
                                "tape_ring_erode": 5},
                "event": {"ratio_min": 1.02, "ratio_max": 1.8, "burr_frames": 2,
                          "cooldown_frames": 10}}
    files["app_cfg"].write_text(yaml.safe_dump(app))
    files["refactor_cfg"].write_text(yaml.safe_dump(refactor))
    return files


def phase_config_runs(H=448, W=800, n_frames=24, model_size=None, device="cuda"):
    """`cli infer --config` through the engine (`engine_run`) over n_frames
    HxW `synthetic_frames` written as .bmp: production's YAML with a seeded
    NestedUNet .pth, the AppCfg layout with `--arch
    lightweight:mobilenet_v3_small` (the CLI's seeded weights), the
    RefactorConfig layout with a seeded 7-class SimpleUNet .pth (event
    detector on, from the file's event section). Each run's B1 launches per
    batch held to ENGINE_PER_BATCH, every events.csv row to the step's.
    Returns ({path: launch counts per batch}, record)."""
    import tempfile

    size = ["--model-size", str(model_size)] if model_size else []
    record, counts = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_config_") as tmp:
        tmp = Path(tmp)
        src = write_bmp_dir(tmp / "frames", synthetic_frames(n_frames, H, W, seed=4))
        files = config_files(tmp, H, W)
        pth = {"nested_unet": str(tmp / "nested_unet.pth"), "simple_unet": str(tmp / "simple.pth")}
        torch.save(seeded_nested_unet().state_dict(), pth["nested_unet"])
        torch.save(seeded_model("simple_unet", num_classes=7).state_dict(), pth["simple_unet"])
        for name, model, flags in (
                ("production", pth["nested_unet"], []),
                ("app_cfg", None, ["--arch", "lightweight:mobilenet_v3_small"]),
                ("refactor_cfg", pth["simple_unet"], [])):
            path = f"config_{name}"
            counts[f"engine_{path}"], record[path] = engine_run(
                path, src, model, ["--config", str(files[name])] + flags + size,
                tmp / f"out_{name}", device)
            detector = (tmp / f"out_{name}" / "detector_events.csv").exists()
            if detector != (name == "refactor_cfg"):
                raise AssertionError(f"cli infer --config {name}: event detector "
                                     f"{'on' if detector else 'off'}")
            record[path]["event_detector"] = detector
    return counts, record


def phase_trace(step, frames, log_dir) -> dict:
    """One step inside `core.profiling.device_trace(log_dir)`: the trace file
    must name B1's cluster kernel. Returns the file's size and the names of
    the hand-written kernels it holds."""
    from unet_tpu_torch.core.profiling import device_trace

    with device_trace(str(log_dir)):
        step(frames)
    files = sorted(Path(log_dir).glob("*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"device_trace wrote {len(files)} trace files in {log_dir}")
    text = files[0].read_text()
    names = [k for k in ("cc_propagate_cluster_kernel", "cc_propagate_global_kernel",
                         "nlm_kernel", "qconv_wgmma_kernel") if k in text]
    if "cc_propagate_cluster_kernel" not in names:
        raise AssertionError("the device trace does not name B1's cluster kernel")
    _log(f"device_trace: {files[0].name}, {len(text)} bytes, names {names}")
    return dict(bytes=len(text), kernels=names)


# ---------------------------------------------------------------------------
# training (phase 9)
# ---------------------------------------------------------------------------

TRAIN_RTOL = {"loss": 1e-4, "focal": 1e-4, "tversky": 1e-4, "dice": 1e-4, "grad_norm": 1e-3}
TRAIN_STATS_ATOL = 1e-5   # BN running statistics after the step, card vs CPU
TRAIN_BF16_RTOL = 5e-2    # bf16 scalars against the CPU's fp32: a guard against gross faults


def train_scenes(n: int, h: int, w: int, seed: int = 0):
    """n labelled cable scenes: (n, h, w, 3) uint8 BGR frames and (n, h, w)
    uint8 masks (0 background, 1 cable, 2 tape). A vertical cable strip of
    drawn position and width over a textured background, a tape band of
    drawn rows wider than the cable, sensor noise of sigma 6."""
    frames = np.empty((n, h, w, 3), np.uint8)
    masks = np.zeros((n, h, w), np.uint8)
    for i in range(n):
        r = np.random.default_rng(seed + i)
        bgr = r.uniform(40, 70, (h, w, 3))
        cw = max(4, int(w * r.uniform(0.08, 0.14)))
        x1 = int(r.integers(w // 5, 4 * w // 5 - cw))
        y1 = int(r.integers(h // 10, h // 2))
        y2 = y1 + max(4, int(h * r.uniform(0.25, 0.45)))
        t = max(1, cw // 2)
        masks[i, :, x1:x1 + cw] = 1
        bgr[:, x1:x1 + cw] = (180, 180, 175)
        masks[i, y1:y2, x1 - t:x1 + cw + t] = 2
        bgr[y1:y2, x1 - t:x1 + cw + t] = (60, 90, 200)
        bgr += r.normal(0, 6.0, (h, w, 3))
        frames[i] = np.clip(bgr, 0, 255).astype(np.uint8)
    return frames, masks


def write_split(root: Path, n_train: int, n_val: int, h: int, w: int, seed: int = 0) -> str:
    """`train_scenes` as a labelled split the datasets read:
    root/{train,val}/{images,masks}/scene_NNN.png."""
    import cv2

    for split, n, s in (("train", n_train, seed), ("val", n_val, seed + 1000)):
        frames, masks = train_scenes(n, h, w, s)
        for sub in ("images", "masks"):
            (root / split / sub).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            cv2.imwrite(str(root / split / "images" / f"scene_{i:03d}.png"), frames[i])
            cv2.imwrite(str(root / split / "masks" / f"scene_{i:03d}.png"), masks[i])
    return str(root)


def seeded_train_model(seed: int = 0, dtype: str = "float32", remat: bool = False,
                       arch: str = "nested_unet") -> nn.Module:
    """The 3-class NestedUNet with deep supervision at full width (32-512
    filters), its state drawn as `seeded_nested_unet` draws it; `arch`
    "lightweight:custom" (the inspection recipe's model, deep supervision)
    or "simple_unet": that model of the zoo instead."""
    from unet_tpu_torch.models import LightweightNestedUNet, NestedUNet, SimpleUNet

    dt = getattr(torch, dtype)
    if arch == "simple_unet":
        model = SimpleUNet(3, dtype=dt)
    elif arch == "lightweight:custom":
        model = LightweightNestedUNet(3, "custom", deep_supervision=True, dtype=dt)
    else:
        model = NestedUNet(3, deep_supervision=True, dtype=dt, remat=remat)
    return _seed_state(model, seed)


def _advanced_recipe():
    """The loss and optimizer of `cli train --recipe 3class_advanced`
    (train/recipes.py), the schedule's length set for a short run."""
    from unet_tpu_torch.train.trainer import LossCfg, OptimCfg

    loss = LossCfg(kind="advanced", class_weights=(0.02, 1.0, 1.0), weight_focal=0.35,
                   weight_tversky=0.45, weight_dice=0.20, tversky_alpha=0.25, tversky_beta=0.75,
                   ds_weights=(0.1, 0.2, 0.3, 0.4))
    optim = OptimCfg(lr=2e-4, weight_decay=1e-4, schedule="onecycle", total_steps=100,
                     pct_start=0.1, div_factor=10, final_div_factor=100, clip_norm=1.0,
                     accum_steps=2)
    return loss, optim


def _inspection_recipe():
    """The loss of `cli train --recipe inspection` (train/recipes.py: the
    combined loss, deep supervision's default weights) and its optimizer,
    the schedule's length set for a short run and two micro-steps an
    update."""
    from unet_tpu_torch.train.trainer import LossCfg, OptimCfg

    return LossCfg(kind="combined"), OptimCfg(lr=1e-4, schedule="cosine", total_steps=100,
                                              accum_steps=2)


def _train_batch(b: int, size: int, seed: int):
    frames, masks = train_scenes(b, size, size, seed)
    return frames[..., ::-1].astype(np.float32) / 255.0, masks.astype(np.int64)


def _one_step(model: nn.Module, images, labels, device: str) -> dict:
    """One micro-step of the 3class_advanced loss and optimizer on `device`:
    its metrics, and on the CPU the main head's logits, the gradient (all
    parameters, one vector) and the BN running statistics after it."""
    from unet_tpu_torch.train.trainer import create_train_state, make_train_step, upload

    loss, optim = _advanced_recipe()
    state = create_train_state(model, optim, device)
    seen = {}
    hook = model.register_forward_hook(
        lambda m, i, out: seen.update(logits=out[0].detach().float().cpu()))
    state, metrics = make_train_step(loss)(state, *upload(images, labels, device))
    hook.remove()
    out = {k: float(v) for k, v in metrics.items()}
    out["logits"] = seen["logits"]
    out["grads"] = torch.cat([g.detach().float().cpu().reshape(-1) for g in state.acc_grads])
    out["stats"] = torch.cat([v.detach().float().cpu().reshape(-1) for k, v in
                              state.model.state_dict().items() if "running" in k])
    return out


def _rms(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).square().mean().sqrt())


def _train_check(size: int, b: int, device: str) -> dict:
    """One micro-step card against CPU from the same seeded weights and batch.
    fp32: the loss and its parts within 1e-4 relative, the gradient norm
    within 1e-3, the BN statistics within 1e-5. bf16: the main head's
    logits, the gradient and the BN statistics each within twice the CPU's
    own bf16-vs-fp32 distance (RMS over the tensor); a scalar's bf16 error
    is one draw, and held to twice another draw it fails about 3 times in
    10 by chance, so the loss, its parts and the norm are held only within
    TRAIN_BF16_RTOL of the CPU's fp32 (a guard against gross faults), and
    printed beside the CPU's bf16."""
    images, labels = _train_batch(b, size, seed=90)
    t = time.time()
    cpu = {dt: _one_step(seeded_train_model(dtype=dt), images, labels, "cpu")
           for dt in ("float32", "bfloat16")}
    cpu_s = time.time() - t
    dev = {dt: _one_step(seeded_train_model(dtype=dt), images, labels, device)
           for dt in ("float32", "bfloat16")}
    f32, c32, d16, c16 = dev["float32"], cpu["float32"], dev["bfloat16"], cpu["bfloat16"]
    for k, rtol in TRAIN_RTOL.items():
        if abs(f32[k] - c32[k]) > rtol * abs(c32[k]):
            raise AssertionError(f"train step fp32 {k}: {device} {f32[k]} vs cpu {c32[k]} "
                                 f"(rtol {rtol})")
    stats = float((f32["stats"] - c32["stats"]).abs().max())
    if stats > TRAIN_STATS_ATOL:
        raise AssertionError(f"train step fp32: BN statistics differ by {stats} > "
                             f"{TRAIN_STATS_ATOL}")
    bf16 = {k: dict(card=_rms(d16[k], c32[k]), cpu=_rms(c16[k], c32[k]))
            for k in ("logits", "grads", "stats")}
    bf16.update({k: dict(card=abs(d16[k] - c32[k]), cpu=abs(c16[k] - c32[k]))
                 for k in TRAIN_RTOL})
    fmt = lambda d: ", ".join(f"{k} {v['card']:.3e} ({v['cpu']:.3e})" for k, v in d.items())
    _log(f"train step card vs cpu (NestedUNet 3-class DS, {size}^2, b={b}, 3class_advanced, "
         f"{cpu_s:.1f} s on the CPU): fp32 loss {f32['loss']:.7f} vs {c32['loss']:.7f}, "
         f"parts {[round(f32[k], 7) for k in ('focal', 'tversky', 'dice')]} vs "
         f"{[round(c32[k], 7) for k in ('focal', 'tversky', 'dice')]}, grad norm "
         f"{f32['grad_norm']:.6f} vs {c32['grad_norm']:.6f}, BN statistics {stats:.3e}; bf16 "
         f"distance from the CPU's fp32 (the CPU's bf16 in brackets): {fmt(bf16)}")
    for k, d in bf16.items():
        if k in TRAIN_RTOL and d["card"] > TRAIN_BF16_RTOL * abs(c32[k]):
            raise AssertionError(f"train step bf16 {k}: {device} {d16[k]} vs the CPU's fp32 "
                                 f"{c32[k]} (rtol {TRAIN_BF16_RTOL})")
        if k not in TRAIN_RTOL and d["card"] > 2 * d["cpu"]:
            raise AssertionError(f"train step bf16 {k}: {device} is {d['card']} (RMS) from the "
                                 f"CPU's fp32, more than twice the CPU's bf16 ({d['cpu']})")
    return dict(size=size, b=b, fp32={k: (f32[k], c32[k]) for k in TRAIN_RTOL},
                fp32_stats_max_abs_err=stats, bf16=bf16, cpu_seconds=cpu_s)


def _train_times(size: int, b: int, device: str, micro_steps: int, repeats: int,
                 card: str) -> dict:
    """ms per micro-step and per optimizer step (accumulation 2), train
    frames/s, TFLOP/s (3x the forward's convolutions) and peak memory of
    the 3class_advanced step at b x size^2, in fp32, bf16 and bf16 with
    remat. Two optimizer steps warm up (AdamW allocates its state at the
    first), then `repeats` windows of `micro_steps` micro-steps each, CUDA
    events around each window (the host clock on the CPU): the median
    window, and the fastest and slowest beside it. The host's own time to
    queue one micro-step (from a synchronized start to the step's return,
    the median of `micro_steps`) says how far the host paces the card. The
    peak is what the step allocates above what was live before it. Then a
    profile of one fp32 and one bf16 optimizer step (its two micro-steps):
    the device's busy time."""
    from unet_tpu_torch.train.trainer import create_train_state, make_train_step, upload

    loss, optim = _advanced_recipe()
    images, labels = _train_batch(b, size, seed=91)
    gflop = _conv_gflop(seeded_train_model().eval(), (size, size))
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = {}
    for name, dt, remat in (("fp32", "float32", False), ("bf16", "bfloat16", False),
                            ("bf16_remat", "bfloat16", True)):
        if cuda:   # the peak above what the script held before: the step's own
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        state = create_train_state(seeded_train_model(dtype=dt, remat=remat), optim, device)
        step = make_train_step(loss)
        x, y = upload(images, labels, device)
        for _ in range(2 * optim.accum_steps):
            state, _ = step(state, x, y)
        windows = []
        for _ in range(repeats):
            sync()
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t = time.perf_counter()
            for _ in range(micro_steps):
                state, metrics = step(state, x, y)
            if cuda:
                end.record()
                torch.cuda.synchronize()
                windows.append(start.elapsed_time(end) / micro_steps)
            else:
                windows.append((time.perf_counter() - t) * 1e3 / micro_steps)
        queue = []
        for _ in range(micro_steps):
            sync()
            t = time.perf_counter()
            state, _ = step(state, x, y)
            queue.append((time.perf_counter() - t) * 1e3)
        sync()
        if not np.isfinite(float(metrics["loss"])):
            raise AssertionError(f"train step {name}: loss {float(metrics['loss'])}")
        ms, host_ms = float(np.median(windows)), float(np.median(queue))
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30 if cuda else None
        out[name] = dict(ms_per_micro_step=ms, ms_windows=windows,
                         ms_per_optimizer_step=ms * optim.accum_steps,
                         frames_per_s=b / ms * 1e3, tflops=3 * gflop * b / ms,   # GFLOP/ms
                         host_queue_ms=host_ms, peak_gib=peak, loss=float(metrics["loss"]))
        _log(f"train step {name} (NestedUNet 3-class DS, {size}^2, b={b}, accumulation 2): "
             f"{ms:.3f} ms/micro-step (median of {repeats} windows of {micro_steps}: "
             f"{min(windows):.3f}-{max(windows):.3f}), {ms * optim.accum_steps:.3f} "
             f"ms/optimizer step, {b / ms * 1e3:.2f} train frames/s, "
             f"{3 * gflop * b / ms:.2f} TFLOP/s (3 x {gflop:.2f} GFLOP a frame); the host "
             f"queues a micro-step in {host_ms:.3f} ms; peak "
             f"{'not measured' if peak is None else f'{peak:.3f} GiB'} [{card}]")
        del state, step, x, y
    out["gflop_per_frame_forward"] = gflop
    # profiles after every timing: a profiled step slowed the steps timed
    # after it
    for name, dt in (("fp32", "float32"), ("bf16", "bfloat16")):
        if not cuda:
            break
        state = create_train_state(seeded_train_model(dtype=dt), optim, device)
        step = make_train_step(loss)
        x, y = upload(images, labels, device)
        for _ in range(2 * optim.accum_steps):
            step(state, x, y)
        out[name]["profile"] = _profile_step(
            lambda im: [step(state, im, y) for _ in range(optim.accum_steps)], x,
            out[name]["ms_per_optimizer_step"], f"train optimizer step {name}, b={b}")
        del state, step, x, y
    return out


def _cli(argv) -> int:
    from unet_tpu_torch.cli import main as cli

    t = time.time()
    rc = cli.main([str(a) for a in argv])
    _log(f"  cli {' '.join(str(a) for a in argv[:3])} ...: exit {rc}, {time.time() - t:.1f} s")
    return rc


def phase_train(device="cuda", size=512, b=8, b_check=2, micro_steps=8, repeats=3,
                split=(40, 8, 448, 800), image_size=None, cli_batch=4, overfit=True,
                card="") -> dict:
    """Training on the card (phase 9): `_train_check` (card against CPU at
    b_check x size^2), `_train_times` (b x size^2), then the CLI end to end
    over a labelled split of `train_scenes` written as .png (n_train, n_val,
    H, W = `split`): `train --recipe 3class_advanced --epochs 2` (best,
    last, their sidecars, training_history.json), `evaluate --model
    best.pth` in the dtype it trained in (the loop's logged mIoU for that
    epoch within 1e-3; metrics.json, confusion_matrix.csv), `infer --model
    best.pth --preset two_stage` (`engine_run`: 2 B1 launches a batch on the
    card, events.csv against the step), and `train --recipe overfit_test
    --image-size 32` (exit 0: the recipe's own mIoU > 0.98 gate).
    `image_size` sets every run's --image-size (None: 3class_advanced's
    own 512, evaluate's 512, overfit_test at 32). A train step launches no
    hand-written kernel: the counts stay 0 over the steps. Returns the
    record."""
    import tempfile

    rec = {"check": _train_check(size, b_check, device)}
    _zero_counts()
    rec["times"] = _train_times(size, b, device, micro_steps, repeats, card)
    counts = _read_counts()
    if any(counts.values()):
        raise AssertionError(f"train steps launched hand-written kernels: {counts}")

    n_train, n_val, H, W = split
    isz = ["--image-size", image_size] if image_size else []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        tmp = Path(tmp)
        root = write_split(tmp / "data", n_train, n_val, H, W, seed=300)
        out = tmp / "run"
        if _cli(["train", "--recipe", "3class_advanced", "--epochs", 2, "--data-root", root,
                 "--output", out, "--batch", cli_batch, "--device", device] + isz) != 0:
            raise AssertionError("cli train --recipe 3class_advanced failed")
        files = sorted(p.name for p in out.iterdir())
        want = {"best.pth", "best.meta.json", "last.pth", "last.meta.json",
                "training_history.json"}
        if not want <= set(files):
            raise AssertionError(f"cli train wrote {files}, not {sorted(want)}")
        meta = json.loads((out / "best.meta.json").read_text())
        hist = json.loads((out / "training_history.json").read_text())["history"]
        logged = hist["miou"][meta["epoch"]]
        ev = tmp / "eval"
        if _cli(["evaluate", "--model", out / "best.pth", "--dtype", meta["config"]["dtype"],
                 "--data-root", root, "--split", "val", "--image-size",
                 image_size or meta["config"]["image_size"], "--batch", 8, "--output", ev,
                 "--device", device]) != 0:
            raise AssertionError("cli evaluate failed")
        metrics = json.loads((ev / "metrics.json").read_text())
        if not (ev / "confusion_matrix.csv").is_file():
            raise AssertionError("cli evaluate wrote no confusion_matrix.csv")
        if abs(metrics["miou"] - logged) > 1e-3:
            raise AssertionError(f"cli evaluate mIoU {metrics['miou']} against the loop's "
                                 f"{logged} at epoch {meta['epoch']}")
        _log(f"cli train 3class_advanced: mIoU by epoch {hist['miou']}, loss {hist['loss']}; "
             f"best epoch {meta['epoch']} ({meta['config']}); cli evaluate mIoU "
             f"{metrics['miou']:.6f} vs logged {logged:.6f}")
        infer_counts, infer = engine_run("two_stage_bf16", str(tmp / "data" / "val" / "images"),
                                         str(out / "best.pth"), ["--preset", "two_stage"],
                                         tmp / "infer", device)
        rec["cli"] = dict(history=hist, best=meta, evaluate=metrics, logged_miou=logged,
                          files=files, infer=infer, infer_launches_per_batch=infer_counts)
        if overfit:
            # at 32^2: at the recipe's 128^2 the gate misses about one run
            # in ten, in the JAX package as in the port: Adam at a constant
            # 1e-3 bumps the loss now and then, and a bump in the last
            # steps leaves the eval's running statistics behind
            # (tests/torch_overfit_spread.py, ROADMAP C7)
            rc = _cli(["train", "--recipe", "overfit_test", "--data-root", root, "--output",
                       tmp / "overfit", "--image-size", image_size or 32, "--device", device])
            if rc != 0:
                raise AssertionError("cli train --recipe overfit_test: the mIoU > 0.98 gate "
                                     "failed")
            rec["cli"]["overfit_rc"] = rc
    return rec


def calibrated_model(arch: str, frames: torch.Tensor, cfg, device: str = "cuda") -> nn.Module:
    """`seeded_model(arch)` whose BN running statistics come from its own
    activations: one train-mode pass (the port's train-mode BatchNorm,
    `momentum=None`: the batch's mean and biased variance) over the model
    input of `frames`. Its logits stay near order 1. Eval mode, on `device`."""
    from unet_tpu_torch.models.blocks import fp32_convs
    from unet_tpu_torch.pipeline import stages

    model = seeded_model(arch).to(device)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.reset_running_stats()
            m.momentum = None
    x = stages.model_input(stages.preprocess_frames(frames, cfg), cfg).permute(0, 3, 1, 2)
    with torch.no_grad(), fp32_convs():
        model.train()(x.contiguous())
    return model.eval()


def expected_launches() -> dict:
    """{path: the launches of one batch of the main paths, per kernel,
    route and cluster size}, as `_read_counts` reads them."""
    # every B1 launch of the paths takes the cluster route: burr crops and
    # the wrap path's 256x256 labels on clusters of 8, 448x800 labels of 16
    def b1(k8, k16=0):
        return {"cc_propagate": k8 + k16, "cc_propagate_cluster": k8 + k16,
                "cc_propagate_global": 0, "cc_propagate_cluster8": k8,
                "cc_propagate_cluster16": k16}
    # int8: 17 convs on qconv's wgmma route, conv0_0.conv1 (Cin 3) on the c3 kernel
    q0 = {"qconv": 0, "qconv_wgmma": 0, "qconv_sync": 0, "qconv_c3": 0}
    return {"two_stage": dict(b1(2), nlm=0, **q0), "enhanced": dict(b1(2), nlm=3, **q0),
            "two_stage_bf16": dict(b1(2), nlm=0, **q0),
            "two_stage_int8": dict(b1(2), nlm=0, qconv=18, qconv_wgmma=17, qconv_sync=0,
                                   qconv_c3=1),
            # labels of the cable and tape: at the model's 256x256 (wrap),
            # at 448x800 (three_class_full: 448 < its 512 model input)
            "wrap_uniformity": dict(b1(2), nlm=0, **q0),
            "three_class_full": dict(b1(0, 2), nlm=0, **q0),
            # burr (2 on its crop) + cable and tape labels + defect analysis
            # (holes, tape, cable count), all at 448x800
            "production": dict(b1(2, 5), nlm=0, **q0),
            **{p: dict(b1(*PRESET_B1[p]), nlm=0, **q0) for p in PRESET_PATHS}}


def _runner_counts(fn, frames):
    """`fn(frames)` with every launch count set to 0 just before and read
    just after: (outputs, counts)."""
    _zero_counts()
    out = fn(frames)
    return out, _read_counts()


def _tree_equal(got: dict, want, what: str, fields=("class_map", "cable_px", "tape_px",
                                                    "burr_px")) -> None:
    for f in fields:
        w = getattr(want, f).cpu().numpy()
        if got[f].dtype != w.dtype or not np.array_equal(got[f], w):
            raise AssertionError(f"{what}: {f} of the artifact differs from the live step's")


def _graph_ops(program) -> dict:
    """{op: calls} of the custom ops (torch.ops.unet_tpu_torch.*) in an
    exported program's graph."""
    ops = {}
    for node in program.graph.nodes:
        name = str(node.target)
        if node.op == "call_function" and name.startswith("unet_tpu_torch."):
            op = name.split(".")[1]
            ops[op] = ops.get(op, 0) + 1
    return ops


def phase_export(expect, H=448, W=800, device="cuda", b=8, b_small=3, model_size=None,
                 card=""):
    """torch.export of the port (phase 10). Five pipeline artifacts, each
    loaded by `AotRunner` and run on `device` beside the live
    `stages.build_step`: class map and px counts equal, diameters within
    rtol 1e-5 (every integer field equal), the artifact's launches per
    batch equal to the live step's and to `expect`:
      two_stage fp32, the seeded 3-class NestedUNet saved as a .pth and
        exported by `cli export --pipeline two_stage` (its BN-folded fp32
        forward; symbolic batch, run at b and b_small);
      two_stage int8 (`calibrate_int8`, the bf16 NestedUNet), enhanced fp32
        and production (the colour->class model, whose frames give real
        diameters), by `export.export_pipeline` traced on `device`,
        enhanced at a fixed batch of b;
      two_stage of the colour->class model traced on the CPU and moved to
        `device` by `AotRunner` (B1 routed at run time).
    Then `export_model` with a symbolic batch, its logits within 1e-5 of
    `stages.forward_logits`, and `cli tools render-predictions` of the .pth
    over `write_split` scenes. `model_size` sets every model input (None:
    each preset's own; the CLI's artifact takes the preset's own, so with a
    `model_size` that one is traced by `export_pipeline` too). Returns the
    record: trace seconds, artifact bytes, the programs' custom-op calls,
    launches, checks."""
    import tempfile

    from unet_tpu_torch.cli.main import load_model
    from unet_tpu_torch.export import AotRunner, export_model, export_pipeline
    from unet_tpu_torch.pipeline import presets, stages

    def sized(cfg):
        return cfg if model_size is None else cfg.replace_in(
            "preprocess", model_size=(model_size, model_size))

    model16 = seeded_nested_unet(dtype=torch.bfloat16)
    two = sized(presets.two_stage())
    scenes = {"two_stage": synthetic_frames(b, H, W, seed=20),
              "enhanced": enhanced_scenes(b, H, W, seed=20),
              "production": geometry_scenes("production", b, H, W, seed=20)}
    t = time.time()
    qcfg = stages.calibrate_int8(model16, two, [synthetic_frames(b, H, W, seed=28)],
                                 device=device)
    _log(f"export: calibrate_int8 in {time.time() - t:.1f} s")
    rec = {"card": card, "pipelines": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as tmp:
        tmp = Path(tmp)
        pth = tmp / "m.pth"
        torch.save(seeded_nested_unet().state_dict(), pth)
        model, _, _ = load_model(str(pth), "nested_unet", "float32", 3)
        fast = two.replace_in("segment", fast_forward=True)

        def cli_export(art, cfg, m, hw):
            if model_size is not None:
                return export_pipeline(None, art, cfg=cfg, model=m, frame_hw=hw, device=device)
            if _cli(["export", "--model", pth, "--output", art, "--pipeline", "two_stage",
                     "--frame-hw", f"{hw[0]},{hw[1]}", "--device", device]) != 0:
                raise AssertionError("cli export --pipeline two_stage failed")
            return art

        def on(dev, batch=None):
            return lambda art, cfg, m, hw: export_pipeline(None, art, cfg=cfg, model=m,
                                                           batch=batch, frame_hw=hw, device=dev)

        enhanced = sized(presets.enhanced()).replace_in("preprocess", normalize_wh=(W, H))
        cases = (  # name, expected launches, scenes, cfg, model, export, batches
            ("two_stage_fp32_cli", "two_stage", "two_stage", fast, model, cli_export,
             (b, b_small)),
            ("two_stage_int8", "two_stage_int8", "two_stage", qcfg, model16, on(device), (b,)),
            # enhanced at a fixed batch: with a symbolic one its trace took
            # 27.8 s on the H100 machine's host, with a fixed one 15.5 s
            ("enhanced_fp32", "enhanced", "enhanced", enhanced, model, on(device, b), (b,)),
            ("production_colour", "production", "production", sized(presets.production()),
             ColourClassModel(), on(device), (b,)),
            ("two_stage_colour_traced_on_cpu", "two_stage", "two_stage", two,
             ColourClassModel(), on("cpu"), (b,)))
        for name, path, scene, cfg, m, make, batches in cases:
            t = time.time()
            art = make(str(tmp / f"{name}.pt2"), cfg, m, scenes[scene].shape[1:3])
            trace_s = time.time() - t
            t = time.time()
            runner = AotRunner(art, device=device)
            load_s = time.time() - t
            live = stages.build_step(m, cfg, device=device)
            r = dict(trace_s=trace_s, load_s=load_s, bytes=os.path.getsize(art),
                     graph_ops=_graph_ops(runner.program), runs={})
            for bb in batches:
                frames = torch.from_numpy(scenes[scene][:bb]).to(device)
                want, live_counts = _runner_counts(live, frames)
                got, counts = _runner_counts(runner.run_tree, frames)
                what = f"export {name}, b={bb}"
                if counts != live_counts or counts != expect[path]:
                    raise AssertionError(f"{what}: launches {counts}, the live step "
                                         f"{live_counts}, expected {expect[path]}")
                _tree_equal(got, want, what)
                if got["class_map"].shape != (bb, H, W):
                    raise AssertionError(f"{what}: class_map {got['class_map'].shape}")
                run = dict(launches=counts, cable_px=got["cable_px"].tolist(),
                           burr_px=got["burr_px"].tolist())
                if cfg.geometry.enabled:
                    run.update(_diameters_close(got["diameters"], want.diameters, what))
                r["runs"][bb] = run
                _log(f"{what}: equal to the live step; launches {counts}; exported in "
                     f"{trace_s:.1f} s, {r['bytes']} bytes, loaded in {load_s:.1f} s; "
                     f"burr_px {run['burr_px']} [{card}]")
            rec["pipelines"][name] = r
        if not sum(rec["pipelines"]["two_stage_colour_traced_on_cpu"]["runs"][b]["burr_px"]):
            raise AssertionError("export: no burr in the colour model's two_stage frames")

        # the bare forward, symbolic batch
        ms = two.preprocess.model_size[0]
        t = time.time()
        art = export_model(None, str(tmp / "model.pt2"), model=model, input_size=ms,
                           batch=None, device=device)
        trace_s = time.time() - t
        x = torch.from_numpy(np.random.default_rng(5).random((b_small, ms, ms, 3),
                                                             dtype=np.float32))
        got = AotRunner(art, device=device).run(x)
        with torch.no_grad():
            want = stages.forward_logits(model.to(device), x.to(device).permute(0, 3, 1, 2)
                                         ).permute(0, 2, 3, 1).cpu().numpy()
        err = float(np.abs(got - want).max())
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        rec["model"] = dict(trace_s=trace_s, bytes=os.path.getsize(art), b=b_small,
                            max_abs_err=err, max_abs_logit=float(np.abs(want).max()))
        _log(f"export_model NestedUNet {ms}^2, symbolic batch: b={b_small} logits against "
             f"the live forward max abs err {err:.3e} (largest logit "
             f"{rec['model']['max_abs_logit']:.3f}); exported in {trace_s:.1f} s, "
             f"{rec['model']['bytes']} bytes")

        root = write_split(tmp / "data", 3, 1, H, W, seed=40)
        isz = ["--image-size", model_size] if model_size else []
        if _cli(["tools", "render-predictions", "--images-dir", f"{root}/train/images",
                 "--mask-dir", f"{root}/train/masks", "--model", pth, "--out", tmp / "pred",
                 "--device", device] + isz) != 0:
            raise AssertionError("cli tools render-predictions failed")
        rec["render_predictions"] = sorted(os.listdir(tmp / "pred"))
        if len(rec["render_predictions"]) != 3:
            raise AssertionError(f"render-predictions wrote {rec['render_predictions']}")
    return rec


def _leaves(out, prefix="") -> dict:
    """{name: tensor} of every tensor in a step's (nested) outputs."""
    d = {}
    for name, v in out._asdict().items():
        if isinstance(v, torch.Tensor):
            d[prefix + name] = v
        elif v is not None:
            d.update(_leaves(v, f"{prefix}{name}."))
    return d


def _mesh_train_run(mesh, images, labels, device, steps: int = 2) -> dict:
    """`steps` micro-steps of the 3class_advanced loss and optimizer
    (accumulation 2) from `seeded_train_model`'s weights, over `mesh`
    (`parallel.shard_train_step`) or without one: each micro-step's metrics,
    the gradient of the first (MultiSteps' accumulator), the parameters and
    BN statistics after the last, on the CPU."""
    from unet_tpu_torch.parallel import put_batch
    from unet_tpu_torch.train.trainer import create_train_state, make_train_step

    loss, optim = _advanced_recipe()
    state = create_train_state(seeded_train_model(), optim, device)
    step = make_train_step(loss, mesh=mesh)
    if mesh is None:
        x, y = torch.from_numpy(images).to(device), torch.from_numpy(labels).to(device)
    else:
        x, y = put_batch(mesh, images, labels, local=False)
    x, y = x.permute(0, 3, 1, 2).contiguous(), y.long()
    metrics, grads = [], None
    for i in range(steps):
        state, m = step(state, x, y)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads = [g.detach().cpu().clone() for g in state.acc_grads]
    sd = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
    return dict(metrics=metrics, grads=grads, state=sd, train_step=step, train_state=state,
                x=x, y=y)


def phase_mesh(expect, H=448, W=800, device="cuda", b=8, train_size=512, train_b=2,
               time_b=8, streams=8, frames_per_stream=48, reps=5, repeats=3, model_size=None,
               card=""):
    """The device mesh (phase 11) at world size 1 (`parallel.make_mesh()`: NCCL
    on the card, gloo on the CPU), against the same work without a mesh:
      * `parallel.shard_pipeline_step(build_step(...), mesh)` against
        `build_step` on the same b frames: the seeded 3-class NestedUNet,
        `two_stage` fp32 with the quality statistics (and the previous
        batch's last frame) and `two_stage` int8 (`calibrate_int8`, the
        bf16 model); every output tensor bit for bit and each step's
        launches per batch equal to `expect`; ms per batch of both in turns
        (median of `reps`)
      * `make_train_step(mesh=...)` (`shard_train_step`) against
        `make_train_step`: two micro-steps of 3class_advanced (accumulation
        2) from the same seeded weights at `train_size`^2, b=`train_b`,
        with torch's deterministic algorithms (without them the card's
        backward does not repeat itself; how far the bare step strays from
        itself is recorded): loss, parts and grad norm, the first
        micro-step's gradient, and the parameters and BN statistics after
        the update, bit for bit; ms per micro-step of both at b=`time_b`,
        in turns (median of `reps`), with the default algorithms
      * `MultiStreamServer(mesh=...)` against the server without a mesh,
        wrap_uniformity with the colour->class model over `streams` streams
        of `frames_per_stream` frames: every (stream, frame) once, equal
        results, launches per batch, frames/s of both (median of `repeats`)
    These are the collectives' cost at one rank. `phase_train`'s CLI runs
    (`cli train`) also run over the mesh, through `train.loop.train_model`.
    Returns the record."""
    import torch.distributed as dist

    from unet_tpu_torch import parallel
    from unet_tpu_torch.pipeline import presets, stages
    from unet_tpu_torch.serve import MultiStreamServer

    def sized(cfg):
        return cfg if model_size is None else cfg.replace_in(
            "preprocess", model_size=(model_size, model_size))

    mesh = parallel.make_mesh(device=device)
    rec = dict(world_size=dist.get_world_size(), backend=str(dist.get_backend()),
               mesh_shape=list(mesh.shape), steps={})
    _log(f"mesh: {mesh.shape} over {rec['world_size']} rank(s), backend {rec['backend']}, "
         f"device {mesh.device}")

    # -- the sharded inspection step against build_step
    model, model16 = seeded_nested_unet(), seeded_nested_unet(dtype=torch.bfloat16)
    two = sized(presets.two_stage())
    t = time.time()
    qcfg = stages.calibrate_int8(model16, two, [synthetic_frames(b, H, W, seed=31)],
                                 device=device)
    _log(f"mesh: calibrate_int8 in {time.time() - t:.1f} s")
    frames = torch.from_numpy(synthetic_frames(b, H, W, seed=32)).to(device)
    prev = torch.from_numpy(synthetic_frames(1, H, W, seed=33)).to(device)
    for path, m, cfg, expect_path in (
            ("two_stage", model, two.replace_in("inspect", quality_stats=True), "two_stage"),
            ("two_stage_int8", model16, qcfg, "two_stage_int8")):
        bare = stages.build_step(m, cfg, device=device)
        sharded = parallel.shard_pipeline_step(bare, mesh)
        want, n_bare = _drive(lambda f: bare(f, prev), frames, expect[expect_path],
                              f"{path} without a mesh, b={b}")
        got, n_mesh = _drive(lambda f: sharded(f, prev), frames, expect[expect_path],
                             f"{path} over the mesh, b={b}")
        _check_outputs(got, b, H, W, f"{path} over the mesh")
        gl, wl = _leaves(got), _leaves(want)
        if set(gl) != set(wl):
            raise AssertionError(f"{path}: mesh outputs {sorted(gl)} vs {sorted(wl)}")
        for k in wl:
            if not torch.equal(gl[k], wl[k]):
                raise AssertionError(f"{path}: {k} differs between the mesh and the bare step")
        bare_ms, mesh_ms = [], []
        for _ in range(reps):
            bare_ms.append(_time_step(lambda f: bare(f, prev), frames, reps=3))
            mesh_ms.append(_time_step(lambda f: sharded(f, prev), frames, reps=3))
        rec["steps"][path] = dict(launches=n_mesh, fields=sorted(wl),
                                  bare_ms=float(np.median(bare_ms)),
                                  mesh_ms=float(np.median(mesh_ms)), bare_ms_runs=bare_ms,
                                  mesh_ms_runs=mesh_ms)
        _log(f"mesh {path} b={b}: {len(wl)} output tensors bit for bit with the bare step "
             f"(quality {'on' if cfg.inspect.quality_stats else 'off'}); launches {n_mesh}; "
             f"{rec['steps'][path]['mesh_ms']:.3f} ms/batch over the mesh vs "
             f"{rec['steps'][path]['bare_ms']:.3f} bare (median of {reps}, in turns) [{card}]")

    # -- the train step over the mesh against the step without one, with
    # deterministic algorithms: by default the card's backward does not
    # repeat itself (cuDNN's weight gradients and the upsample's atomics)
    images, labels = _train_batch(train_b, train_size, seed=91)
    with _deterministic():
        a = _mesh_train_run(mesh, images, labels, device)
        n = _mesh_train_run(None, images, labels, device)
    r1, r2 = (_mesh_train_run(None, images, labels, device) for _ in range(2))
    repeat = max(float((g - w).abs().max()) for g, w in zip(r1["grads"], r2["grads"]))
    del r1, r2
    if a["metrics"] != n["metrics"]:
        raise AssertionError(f"mesh train step metrics {a['metrics']} vs {n['metrics']}")
    for i, (g, w) in enumerate(zip(a["grads"], n["grads"])):
        if not torch.equal(g, w):
            raise AssertionError(f"mesh train step: gradient {i} differs")
    for k in n["state"]:
        if not torch.equal(a["state"][k], n["state"][k]):
            raise AssertionError(f"mesh train step: {k} differs after the update")
    t_mesh, t_bare = [], []
    images, labels = _train_batch(time_b, train_size, seed=92)
    runs = {}
    for key, m in (("mesh", mesh), ("bare", None)):
        r = _mesh_train_run(m, images, labels, device, steps=1)
        runs[key] = (r["train_step"], r["train_state"], r["x"], r["y"])

    def micro(key):
        step, state, x, y = runs[key]
        step(state, x, y)

    for _ in range(reps):
        for key, out in (("mesh", t_mesh), ("bare", t_bare)):
            micro(key)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(2):
                micro(key)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) / 2 * 1e3)
    rec["train"] = dict(size=train_size, b=train_b, metrics=a["metrics"],
                        default_repeat_grad_max_abs_diff=repeat,
                        n_tensors=len(n["state"]) + len(n["grads"]), time_b=time_b,
                        mesh_ms=float(np.median(t_mesh)), bare_ms=float(np.median(t_bare)),
                        mesh_ms_runs=t_mesh, bare_ms_runs=t_bare)
    _log(f"mesh train step ({train_size}^2, b={train_b}, 3class_advanced, accumulation 2, "
         f"deterministic algorithms; without them the bare step repeated itself within "
         f"{repeat:.3e} on the gradient): two micro-steps bit for bit with make_train_step (loss "
         f"{a['metrics'][0]['loss']:.7f}, {len(n['grads'])} gradients, {len(n['state'])} "
         f"parameters and statistics after the update); ms per micro-step at b={time_b}: "
         f"{rec['train']['mesh_ms']:.3f} over the mesh vs {rec['train']['bare_ms']:.3f} bare "
         f"(median of {reps}, in turns) [{card}]")
    del runs

    # -- the server over the mesh against the server without one
    cfg = presets.wrap_uniformity()
    pool = wrap_scenes(8, H, W, seed=51)
    lists = [[pool[(s + i) % 8] for i in range(frames_per_stream)] for s in range(streams)]
    servers = {"mesh": MultiStreamServer(ColourClassModel(), cfg, mesh=mesh, device=device),
               "bare": MultiStreamServer(ColourClassModel(), cfg, device=device)}
    results, fps, counts = {}, {k: [] for k in servers}, {}
    for key, server in servers.items():
        server.serve([FrameListSource(f[:1]) for f in lists], lambda r: None)
    for _ in range(repeats):
        for key, server in servers.items():
            got = []
            _zero_counts()
            t = time.perf_counter()
            summary = server.serve([FrameListSource(f) for f in lists], got.append)
            torch.cuda.synchronize()
            fps[key].append(len(got) / (time.perf_counter() - t))
            counts[key] = {k: v / summary["batches"] for k, v in _read_counts().items() if v}
            results[key] = {(r.stream_id, r.frame_id): (r.cable_px, r.tape_px, r.burr_px,
                                                        r.dc_px, r.dt_px) for r in got}
            if len(results[key]) != len(got) or sorted(results[key]) != [
                    (s, i + 1) for s in range(streams) for i in range(frames_per_stream)]:
                raise AssertionError(f"{key} server: frames lost or repeated")
    if results["mesh"] != results["bare"]:
        raise AssertionError("the mesh server's results differ from the bare server's")
    if counts["mesh"] != counts["bare"]:
        raise AssertionError(f"server launches per batch: mesh {counts['mesh']} vs bare "
                             f"{counts['bare']}")
    rec["server"] = dict(streams=streams, frames=streams * frames_per_stream,
                         launches_per_batch=counts["mesh"],
                         mesh_frames_per_s=float(np.median(fps["mesh"])),
                         bare_frames_per_s=float(np.median(fps["bare"])),
                         mesh_runs=fps["mesh"], bare_runs=fps["bare"])
    _log(f"mesh server (wrap_uniformity, colour->class model, {streams} streams x "
         f"{frames_per_stream} frames): every (stream, frame) once and equal to the bare "
         f"server's; launches per batch {counts['mesh']}; "
         f"{rec['server']['mesh_frames_per_s']:.2f} frames/s over the mesh vs "
         f"{rec['server']['bare_frames_per_s']:.2f} bare (median of {repeats}, host clock) "
         f"[{card}]")
    return rec


# ---------------------------------------------------------------------------
# phase 12: the spatial axis (ranks of one gloo group on one card)
# ---------------------------------------------------------------------------

SPATIAL_GAP = 1e-5   # fp32 tie pixels: the reference logits' top-2 gap below this


def spatial_plan(H=448, W=800, b=8, high_res_b=2, native=None, model_size=None):
    """The runs of `phase_spatial`: (name, (n_data, n_spatial), model dtype,
    cfg, frames) of high_res_roi fp32 on `high_res_b` native frames over 1 x
    2 and 1 x 4, two_stage fp32, bf16 and int8 on b frames over 2 x 2, and
    production and enhanced fp32 on b frames over 1 x 2. int8's scales come
    from `stages.calibrate_int8` on the CPU (the same scales on every
    rank). `native` replaces the 2448x2048 frames, `model_size` every
    model input (a rehearsal on the CPU)."""
    from unet_tpu_torch.pipeline import presets, stages

    def sized(cfg):
        return cfg if model_size is None else cfg.replace_in(
            "preprocess", model_size=(model_size, model_size))

    hi = native if native is not None else high_res_scenes(high_res_b, seed=61)
    two = sized(presets.two_stage())
    frames = synthetic_frames(b, H, W, seed=62)
    qcfg = stages.calibrate_int8(seeded_nested_unet(dtype=torch.bfloat16), two,
                                 [synthetic_frames(2, H, W, seed=63)], device="cpu")
    f32, b16 = torch.float32, torch.bfloat16
    return [("high_res_roi", (1, 2), f32, sized(presets.high_res_roi()), hi),
            ("high_res_roi", (1, 4), f32, sized(presets.high_res_roi()), hi),
            ("two_stage", (2, 2), f32, two, frames),
            ("two_stage_bf16", (2, 2), b16, two.replace_in("segment", fast_forward=True), frames),
            ("two_stage_int8", (2, 2), b16, qcfg, frames),
            ("production", (1, 2), f32, sized(presets.production()),
             geometry_scenes("production", b, H, W, seed=64)),
            ("enhanced", (1, 2), f32, sized(presets.enhanced()), enhanced_scenes(b, H, W, seed=65))]


def _logits_spy(captured: list):
    """Replace `stages.run_pipeline` by one whose forward keeps each batch's
    logits (on the CPU, in their dtype) in `captured`; returns the restore
    function."""
    from unet_tpu_torch.pipeline import stages

    real = stages.run_pipeline

    def spy(forward, frames, cfg, prev_frame_bgr=None):
        def fwd(x):
            y = forward(x)
            captured.append(y.cpu())
            return y
        return real(fwd, frames, cfg, prev_frame_bgr)

    stages.run_pipeline = spy
    return lambda: setattr(stages, "run_pipeline", real)


def _timed_collective(totals, name, module, attr: str):
    """Wrap `module.attr` (a collective) to add its host time, between two
    synchronizes, to totals[name]; returns the restore function."""
    real = getattr(module, attr)

    def timed(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(*a, **k)
        torch.cuda.synchronize()
        totals[name] += time.perf_counter() - t
        return out

    setattr(module, attr, timed)
    return lambda: setattr(module, attr, real)


def _timed_transport(totals: list):
    """Wrap `parallel.spatial.all_gather` to add its host time, between two
    synchronizes, to totals[0]; returns the restore function."""
    from unet_tpu_torch.parallel import spatial

    return _timed_collective(totals, 0, spatial, "all_gather")


def _int8_stripes_check(mesh, cfg, frames, device) -> int:
    """The int8 forward on this rank's H stripe of one frame's model input
    with its 19 int8 tensors tapped, against the unsharded forward's rows
    on the same card; raises unless every tensor is bit-identical. Returns
    the tensors' count."""
    from unet_tpu_torch.models import quantized as q
    from unet_tpu_torch.parallel import spatial
    from unet_tpu_torch.pipeline import stages

    model = seeded_nested_unet(dtype=torch.bfloat16)
    qp = q.prepare_int8_params(model.state_dict(), cfg.segment.int8_scales, model.dtype, device)
    x = stages.model_input(stages.preprocess_frames(frames[:1], cfg), cfg)
    st = spatial.Stripes(spatial.stripe_bounds(x.shape[1], mesh.spatial_size),
                         mesh.spatial_rank, mesh.spatial_group)
    got, want = {}, {}
    with torch.inference_mode():
        q.nested_unet_forward_int8_striped(qp, x[:, st.start:st.end].contiguous(), st, got)
        q.nested_unet_forward_int8(qp, x, want)
    for k in q.TAP_NAMES:
        level = x.shape[1] // want[k].shape[1]
        if not torch.equal(got[k], want[k][:, st.start // level:st.end // level]):
            raise AssertionError(f"int8 {k}: the stripe differs from the unsharded rows")
    return len(q.TAP_NAMES)


def _spatial_model(arch: str, dtype: torch.dtype) -> nn.Module:
    """The seeded 3-class model of `arch` with compute type `dtype`: the
    NestedUNet of `seeded_nested_unet`, or `seeded_model`'s zoo model."""
    if arch == "nested_unet":
        return seeded_nested_unet(dtype=dtype)
    return seeded_model(arch, dtype=str(dtype).replace("torch.", ""))


def _rank_setup(rank: int, world: int, store: str, path: str, mem_frac: float) -> dict:
    """A rank of a phase's gloo group on one card: its plan (saved at
    `path`), the card's memory cap (`mem_frac` of it: the rank's share of
    what was free when the ranks started, so that cuDNN takes an
    algorithm whose workspace fits), its threads, and the group."""
    import torch.distributed as dist

    plan = torch.load(path, weights_only=False)
    if plan["device"] == "cpu":   # a rehearsal: nothing to synchronize
        torch.cuda.synchronize = lambda *a, **k: None
    else:
        torch.cuda.set_per_process_memory_fraction(mem_frac, 0)
    torch.set_num_threads(plan["threads"])
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    return plan


def _spatial_run(plan: dict, mesh, name: str, shape, dtype, cfg, frames) -> dict:
    """One run of a spatial plan on this rank of `mesh`: the seeded model of
    the run's arch (`plan["archs"]`, the NestedUNet by default) through
    `shard_pipeline_step(build_step(...), mesh, spatial=True)` on the global
    frames; its outputs (CPU), the logits of its frames, its launches, ms
    per batch, the transport's host time and its peak memory."""
    import torch.distributed as dist

    from unet_tpu_torch import parallel
    from unet_tpu_torch.pipeline import stages

    t0, device, reps = time.time(), plan["device"], plan["reps"][name]
    model = _spatial_model(plan.get("archs", {}).get(name, "nested_unet"), dtype)
    step = parallel.shard_pipeline_step(stages.build_step(model, cfg, device=mesh.device),
                                        mesh, spatial=True)
    fr = torch.from_numpy(frames).to(mesh.device)
    if device != "cpu":   # a warm-up call first (cuDNN's algorithms, the tables)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step(fr)
    captured = []
    restore = _logits_spy(captured)
    try:
        _zero_counts()
        out = step(fr)
        counts = _read_counts()
    finally:
        restore()
    k = fr.shape[0] // mesh.size
    first, mine = parallel.spatial.frame_split(k, mesh.spatial_size)[mesh.spatial_rank]
    ms, transport = [], [0.0]
    for timed in (False, True):
        restore = _timed_transport(transport) if timed else (lambda: None)
        try:
            for _ in range(reps):
                dist.barrier()
                torch.cuda.synchronize()
                t = time.perf_counter()
                step(fr)
                torch.cuda.synchronize()
                if not timed:
                    ms.append((time.perf_counter() - t) * 1e3)
        finally:
            restore()
    r = dict(name=name, shape=shape,
             outputs={k_: v.cpu().clone() for k_, v in _leaves(out).items()},
             first=mesh.rank * k + first, logits=captured[0] if captured else None,
             counts=counts, frames=mine, ms=ms, transport_ms=transport[0] * 1e3 / reps,
             peak_gib=((torch.cuda.max_memory_allocated() - base) / 2 ** 30
                       if device != "cpu" else None))
    if name == "two_stage_int8":
        r["int8_tensors"] = _int8_stripes_check(mesh, cfg, fr, mesh.device)
    r["seconds"] = time.time() - t0
    return r


def _spatial_rank(rank: int, world: int, store: str, path: str, mem_frac: float) -> None:
    """One rank of `phase_spatial`'s or `phase_spatial_zoo`'s gloo group:
    every run of the plan at `path` whose mesh has `world` ranks
    (`_spatial_run`), then every train run of it (`plan["train_runs"]`,
    `_spatial_train_run`). Written to path.rank<r> as (runs, train runs)."""
    import torch.distributed as dist

    from unet_tpu_torch import parallel

    plan = _rank_setup(rank, world, store, path, mem_frac)
    try:
        meshes, res, train = {}, [], []

        def mesh_of(shape):
            if shape not in meshes:
                meshes[shape] = parallel.make_mesh(*shape, device=plan["mesh_device"])
            return meshes[shape]

        for name, shape, dtype, cfg, frames in plan["runs"]:
            if shape[0] * shape[1] == world:
                res.append(_spatial_run(plan, mesh_of(shape), name, shape, dtype, cfg, frames))
        for run in plan.get("train_runs", ()):
            if run[1][0] * run[1][1] == world:
                train.append(_spatial_train_run(plan, mesh_of(run[1]), rank, *run))
        torch.save((res, train), f"{path}.rank{rank}")
    finally:
        dist.destroy_process_group()


def _spawn_ranks(entry, plan: dict, tmp: str, worlds, device: str, what: str) -> dict:
    """{world: [each rank's result]}: `entry` on `world` ranks of one gloo
    group for each of `worlds`, the plan saved in `tmp`. On the card each
    rank may hold its share of 0.9 of the free memory."""
    import torch.multiprocessing as mp

    path = os.path.join(tmp, "plan.pt")
    torch.save(plan, path)
    ranks = {}
    for world in worlds:
        t, mem_frac = time.time(), 1.0
        if device != "cpu":
            torch.cuda.empty_cache()
            free, total = torch.cuda.mem_get_info()
            mem_frac = 0.9 * free / world / total
            _log(f"{what}: {free / 2 ** 30:.1f} of {total / 2 ** 30:.1f} GiB free; each of "
                 f"{world} ranks may hold {mem_frac * total / 2 ** 30:.1f} GiB")
        mp.start_processes(entry, args=(world, os.path.join(tmp, f"store{world}"), path,
                                        mem_frac), nprocs=world, start_method="spawn")
        ranks[world] = [torch.load(f"{path}.rank{r}", weights_only=False) for r in range(world)]
        for r in range(world):
            os.remove(f"{path}.rank{r}")
        _log(f"{what}: {world} ranks on {device} in {time.time() - t:.1f} s")
    return ranks


def phase_spatial(card="", device="cuda", **kw):
    """The spatial axis (phase 12): 2 and 4 ranks of one gloo group on one
    card (`cuda:0`: NCCL takes no two ranks on one device), each its own
    process, the kernels built before they start (`_build.build_all`). The
    runs of `spatial_plan`, each through `parallel.shard_pipeline_step(...,
    spatial=True)` against `stages.build_step` on the same card and frames
    (the seeded full-width 3-class NestedUNet): every rank's outputs equal;
    class maps and px counts equal to build_step's, or differing only on
    the tie pixels of the reference logits (the algorithm cuDNN picks for
    a stripe's shape sums in another order; the flips are counted): in
    fp32 a top-2 gap below SPATIAL_GAP; in bf16 (the fast and int8
    forwards' logits) the stripes may move the logits by less than bf16
    moves them from the fp32 step's on the same frames, and a flip must lie
    where the gap is under twice that move (one bf16 ulp, 0.0078 at a logit
    of 1 to 2, exceeds a gap of 1e-3: the flips at a gap >= 1e-3
    are counted apart); every other field equal where no pixel flips
    (integers; floats within 1e-4);
    the int8 forward's 19 int8 tensors on each rank's stripe bit for bit
    with the unsharded rows; the launches per rank: B1 and B2 as
    build_step's on a rank with frames and none on a rank without, qconv
    18 (17 wgmma, 1 c3) on every rank; each rank's peak memory (a rank may
    hold its share of what was free when the ranks started). ms per batch
    at S = 1 (build_step),
    2 and 4 (rank 0's median of `reps`) and the transport's share (host
    time inside the all-gathers, between synchronizes, in a second set of
    `reps`). Processes that share one card: not a scaling figure. Returns
    the record."""
    return run_spatial_phases([functools.partial(_spatial_part, card, device, **kw)],
                              device)[0]


def _spatial_part(card="", device="cuda", H=448, W=800, b=8, high_res_b=2, native=None,
                  model_size=None, reps=3) -> dict:
    """`phase_spatial`'s share of `run_spatial_phases` (its arguments): its
    runs and their references on `device`, and the check of its ranks'
    results."""
    t0 = time.time()
    runs = spatial_plan(H, W, b, high_res_b, native, model_size)
    want = _spatial_references(runs, {}, device, reps)
    rec = dict(backend="gloo", device=device, runs={})

    def finish(ranks):
        for per_rank in ranks.values():
            for i, r0 in enumerate(per_rank[0][0]):
                if r0["name"] in want:
                    key = f"{r0['name']} {r0['shape'][0]}x{r0['shape'][1]}"
                    rec["runs"][key] = _spatial_check([res[0][i] for res in per_rank], want,
                                                      r0["name"].rsplit("_", 1)[0], card)
        return rec

    return dict(runs=runs, reps={r[0]: reps for r in runs}, rec=rec, finish=finish,
                prep_s=time.time() - t0)


def run_spatial_phases(makers, device) -> list:
    """Phases 12 to 14 (or any of them) with one spawn of rank processes for
    each world size their runs need: `makers` build each phase's part (its
    inspection runs, train runs, batches, references in this process and
    the check of its results), after the kernels are built; the parts'
    runs go to the ranks in one plan (`_spatial_rank`; each rank capped at
    its share of the card's free memory, 2 threads; on the CPU the
    parent's thread count, whose convs sum in an order that depends on
    it). Returns each part's record, with its seconds: its preparation,
    its runs on the first rank and its check; the ranks' start-up, shared,
    under "spawn_overhead_s"."""
    import tempfile

    from unet_tpu_torch import _build

    if device != "cpu":
        _build.build_all(["cc_propagate", "nlm", "qconv"])
        torch.cuda.empty_cache()   # the card's memory for the ranks
    parts = [make() for make in makers]
    plan = dict(runs=[], archs={}, train_runs=[], batches={}, reps={}, device=device,
                threads=torch.get_num_threads() if device == "cpu" else 2,
                mesh_device="cpu" if device == "cpu" else "cuda:0")
    for part in parts:
        plan["runs"] += list(part.get("runs", ()))
        plan["train_runs"] += list(part.get("train_runs", ()))
        for k in ("archs", "batches", "reps"):
            plan[k].update(part.get(k, {}))
    worlds = sorted({shape[0] * shape[1] for shape in [r[1] for r in plan["runs"]]
                     + [r[1] for r in plan["train_runs"]]})
    t = time.time()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_spatial_") as tmp:
        ranks = _spawn_ranks(_spatial_rank, plan, tmp, worlds, device, "spatial phases")
    spawn_s = time.time() - t
    first = [r for per_rank in ranks.values() for r in per_rank[0][0] + per_rank[0][1]]
    out = []
    for part in parts:
        t = time.time()
        rec = part["finish"](ranks)
        # a train run's key in `reps` is (name, arch), an inspection run's its name
        own = sum(r["seconds"] for r in first
                  if ((r["name"], r["arch"]) if "arch" in r else r["name"]) in part["reps"])
        rec["seconds"] = round(part["prep_s"] + own + time.time() - t, 1)
        rec["spawn_overhead_s"] = round(spawn_s - sum(r["seconds"] for r in first), 1)
        out.append(rec)
    return out



def _spatial_references(runs, archs: dict, device, reps: int) -> dict:
    """{run name: (outputs, logits, launches, ms per batch)} of `build_step`
    on `device` (S = 1) for each run of a spatial plan, the seeded model of
    the run's arch (`archs`, the NestedUNet by default)."""
    from unet_tpu_torch.pipeline import stages

    want = {}
    for name, shape, dtype, cfg, frames in runs:
        if name in want:
            continue
        step = stages.build_step(_spatial_model(archs.get(name, "nested_unet"), dtype), cfg,
                                 device=device)
        fr = torch.from_numpy(frames).to(device)
        captured = []
        restore = _logits_spy(captured)
        cuda = torch.device(device).type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        try:
            _zero_counts()
            out = step(fr)
            counts = _read_counts()
        finally:
            restore()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30 if cuda else None
        want[name] = (out, captured[0], counts, _time_step(step, fr, reps=reps), peak)
    return want


def _spatial_check(per_rank: list, want: dict, fp32_name: str, card: str,
                   scale_gap: bool = False) -> dict:
    """One run of a spatial plan (`_spatial_run` on every rank) against
    `build_step`'s (`_spatial_references`): every rank's outputs equal;
    the launches per rank (B1 and B2 as build_step's on a rank with frames,
    none without; qconv as build_step's on every rank); class maps and px
    counts equal, or differing only on tie pixels of the reference logits
    (`compare_with_ties`): in fp32 a top-2 gap under SPATIAL_GAP (with
    `scale_gap`, times the largest logit where it passes 1, as
    `phase_models` scales its gates); in bf16 the stripes must move the
    logits by less than bf16 moves them from the fp32 run `fp32_name`'s on
    the same frames, and a flip must lie where the gap is under twice that
    move; every other field equal where no pixel flips (integers; floats
    within 1e-4). Logs and returns the record."""
    from types import SimpleNamespace

    r0 = per_rank[0]
    name, shape = r0["name"], r0["shape"]
    what = f"spatial {name} over {shape[0]} x {shape[1]}"
    out, want_logits, want_counts, ms1, peak1 = want[name]
    wl = {k: v.cpu() for k, v in _leaves(out).items()}
    for r, res in enumerate(per_rank):
        got = res["outputs"]
        if sorted(got) != sorted(wl) or any(not torch.equal(got[k], r0["outputs"][k])
                                           for k in got):
            raise AssertionError(f"{what}: rank {r}'s outputs differ from rank 0's")
        qk = {k: v for k, v in want_counts.items() if k.startswith("qconv")}
        other = {k: (v if res["frames"] else 0) for k, v in want_counts.items()
                 if not k.startswith("qconv")}
        if res["counts"] != {**other, **qk}:
            raise AssertionError(f"{what}: rank {r} ({res['frames']} frames) "
                                 f"launched {res['counts']}, expected {other | qk}")
    # one copy of each frame: ranks of the data axis's other slices
    # hold their own frames, the spatial group splits a slice
    seen, parts = set(), []
    for res in sorted(per_rank, key=lambda x: x["first"]):
        if res["frames"] and res["first"] not in seen:
            seen.add(res["first"])
            parts.append(res["logits"])
    logits = torch.cat(parts).float()
    g = r0["outputs"]
    wlf = want_logits.float()
    moved = float((logits - wlf).abs().max())
    scale = max(1.0, float(wlf.abs().max())) if scale_gap else 1.0
    gap, gap_text, own = SPATIAL_GAP * scale, f"{SPATIAL_GAP * scale:g}", None
    if want_logits.dtype == torch.bfloat16:
        # a stripe may move the bf16 logits (cuDNN's algorithm for its
        # shape rounds otherwise) by less than bf16 moves them from
        # the fp32 step's on the same frames; a pixel can flip only
        # where its gap is under twice the move
        own = float((wlf - want[fp32_name][1].float()).abs().max())
        if moved > own:
            raise AssertionError(f"{what}: the stripes move the logits by {moved:.3e}, "
                                 f"more than bf16 moves them from fp32 ({own:.3e})")
        gap, gap_text = 2 * moved, f"2 x the logits' move, {2 * moved:.3e}"
    flips = logits.argmax(1) != wlf.argmax(1)
    top2 = wlf.topk(2, dim=1).values
    flip_gaps = (top2[:, 0] - top2[:, 1])[flips]
    ties = compare_with_ties(SimpleNamespace(**g), out, logits, want_logits, what, gap)
    ties.update(largest_flip_gap=float(flip_gaps.max()) if len(flip_gaps) else 0.0,
                flips_gap_over_1e3=int((flip_gaps >= 1e-3).sum()),
                bf16_vs_fp32_max_abs_diff=own)
    if ties["flips"] == 0:
        for k, w in wl.items():
            if w.dtype.is_floating_point:
                if not torch.allclose(g[k], w, rtol=1e-4, atol=1e-4):
                    raise AssertionError(f"{what}: {k} differs")
            elif not torch.equal(g[k], w):
                raise AssertionError(f"{what}: {k} differs")
    rows = [dict(rank=r, frames=res["frames"], counts={
        k: v for k, v in res["counts"].items() if v}, ms=res["ms"],
        transport_ms=res["transport_ms"], peak_gib=res["peak_gib"])
        for r, res in enumerate(per_rank)]
    ms = float(np.median(r0["ms"]))
    rec = dict(ms=ms, ms_runs=r0["ms"], build_step_ms=ms1, build_step_peak_gib=peak1,
               transport_ms=r0["transport_ms"],
               transport_share=r0["transport_ms"] / ms, logits_max_abs_diff=moved,
               logits_max_abs=float(wlf.abs().max()), logits_hw=list(wlf.shape[-2:]),
               fields=len(wl), int8_tensors=r0.get("int8_tensors"), per_rank=rows, **ties)
    _log(f"{what}, b={g['class_map'].shape[0]}: {len(wl)} output fields as "
         f"build_step's; logits {tuple(wlf.shape[-2:])} up to {rec['logits_max_abs']:.3f}, max "
         f"abs diff {moved:.3e}, argmax flips "
         f"{ties['flips']} (all on tie pixels, top-2 gap < {gap_text}: "
         f"{ties['tie_pixels']} in the reference; largest gap of a flip "
         f"{ties['largest_flip_gap']:.3e}, {ties['flips_gap_over_1e3']} flips at a gap "
         f">= 1e-3), class-map pixels differing {ties['class_map_diff']}"
         + (f"; bf16 against fp32 {own:.3e}" if own is not None else "")
         + (f"; int8 tensors bit for bit on every stripe: {r0['int8_tensors']}"
            if "int8_tensors" in r0 else "")
         + f"; {ms:.3f} ms/batch (S=1 build_step {ms1:.3f}), transport "
           f"{r0['transport_ms']:.3f} ms = {r0['transport_ms'] / ms:.1%} (rank 0) [{card}]")
    for row in rows:
        _log(f"  rank {row['rank']}: {row['frames']} frame(s), launches {row['counts']}"
             + (f", peak {row['peak_gib']:.3f} GiB" if row["peak_gib"] is not None else ""))
    if peak1 is not None:
        _log(f"  build_step in one process: peak {peak1:.3f} GiB")
    return rec


# ---------------------------------------------------------------------------
# phase 13: the spatial train step (ranks of one gloo group on one card)
# ---------------------------------------------------------------------------

# (name, (n_data, n_spatial), model dtype, remat, arch): one optimizer step of
# two micro-steps each, the global batch 2 per data slice
SPATIAL_TRAIN_RUNS = (("fp32", (1, 2), "float32", False, "nested_unet"),
                      ("bf16", (1, 2), "bfloat16", False, "nested_unet"),
                      ("fp32_remat", (1, 2), "float32", True, "nested_unet"),
                      ("fp32", (2, 2), "float32", False, "nested_unet"))
# the fp32 gradient's gate, of its norm: the striped step's distance from the
# one-process step computed in float64 (its function, exactly) within twice
# the one-process fp32 step's own, and at least this. Two fp32 runs of the
# same step differ by about their own rounding (PERF.md §6): cuDNN's
# fp32 algorithms, and a ReLU or max-pool input within rounding of its kink
# switches its gradient
SPATIAL_TRAIN_GRAD = 1e-4


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().double().cpu().reshape(-1) for t in tensors])


def _digest(t: torch.Tensor) -> str:
    import hashlib

    return hashlib.sha256(t.detach().cpu().contiguous().view(torch.uint8).numpy()).hexdigest()


def _spatial_train_steps(mesh, images, labels, dtype: str, remat: bool, device, reps: int,
                         timed: bool = False, arch: str = "nested_unet") -> dict:
    """Two micro-steps (one optimizer step) of the 3class_advanced step on
    `seeded_train_model(dtype, remat)`, or for a zoo `arch` of the inspection
    recipe's step on `seeded_train_model(dtype, arch=arch)`, over `mesh`
    (its block of the global batch; None: the whole batch in this process,
    `dtype` float64 making the parameters float64 too): the metrics, the
    first micro-step's
    gradient (MultiSteps' accumulator) and the BN statistics after both,
    on the CPU in float64; the step's peak memory (above what was live
    before it); then ms per micro-step, the median of `reps` micro-steps
    each between synchronizes, and with `timed` `reps` more with the
    collectives' host time summed (`_timed_collective`): ms per micro-step
    in the all-gathers of the transport and in the all-reduces."""
    import torch.distributed as dist

    from unet_tpu_torch.parallel import spatial
    from unet_tpu_torch.parallel import put_batch
    from unet_tpu_torch.train.trainer import create_train_state, make_train_step

    loss, optim = _advanced_recipe() if arch == "nested_unet" else _inspection_recipe()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    f64 = dtype == "float64"
    model = seeded_train_model(dtype="float32" if f64 else dtype, remat=remat, arch=arch)
    if f64:
        model = model.double()
        model.dtype = torch.float64
    state = create_train_state(model, optim, device)
    step = make_train_step(loss, mesh=mesh)
    if mesh is None:
        x, y = torch.from_numpy(images).to(device), torch.from_numpy(labels).to(device)
    else:
        x, y = put_batch(mesh, images, labels, local=False)
    x, y = x.to(torch.float64 if f64 else torch.float32).permute(0, 3, 1, 2).contiguous(), y.long()
    metrics, grads = [], None
    for i in range(2):
        state, m = step(state, x, y)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads = _flat(state.acc_grads)
    stats = _flat([v for k, v in state.model.state_dict().items() if "running" in k]
                  or [torch.zeros(0)])
    params = _flat(state.params)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30 if cuda else None
    sync = torch.cuda.synchronize

    def micro_ms():
        if mesh is not None:
            dist.barrier()
        sync()
        t = time.perf_counter()
        step(state, x, y)
        sync()
        return (time.perf_counter() - t) * 1e3

    ms = [micro_ms() for _ in range(reps)]
    out = dict(metrics=metrics, grads=grads, stats=stats, params=params, peak_gib=peak, ms=ms)
    if timed:
        totals = {"all_gather (transport)": 0.0, "all_reduce": 0.0}
        restores = [_timed_collective(totals, "all_gather (transport)", spatial, "all_gather"),
                    _timed_collective(totals, "all_reduce", dist, "all_reduce")]
        try:
            for _ in range(reps):
                micro_ms()
        finally:
            for r in restores:
                r()
        out["collective_ms"] = {k: v * 1e3 / reps for k, v in totals.items()}
    del state, step, x, y
    return out


def _spatial_train_run(plan: dict, mesh, rank: int, name: str, shape, dtype: str,
                       remat: bool, arch: str) -> dict:
    """One train run of a plan on this rank of `mesh` (`_spatial_train_steps`
    on its block of the global batch): the gradient, parameters and
    statistics travel as digests, and whole from the group's first rank
    only."""
    t0 = time.time()
    images, labels = plan["batches"][arch, 2 * shape[0]]
    r = _spatial_train_steps(mesh, images, labels, dtype, remat, mesh.device,
                             plan["reps"][name, arch], timed=True, arch=arch)
    for k in ("grads", "params", "stats"):
        r[f"{k}_digest"] = _digest(r[k])
    if rank:
        r["grads"] = r["params"] = None
    return dict(r, name=name, shape=shape, dtype=dtype, remat=remat, arch=arch,
                seconds=time.time() - t0)


def _max_abs(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest absolute difference; 0 for empty tensors (a model
    without BatchNorm has no statistics)."""
    return float((got - want).abs().max()) if want.numel() else 0.0


def _train_dist(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / want.norm())


def phase_spatial_train(card="", device="cuda", **kw):
    """The spatial train step (phase 13): the full-width 3-class NestedUNet
    with deep supervision (`seeded_train_model`), 3class_advanced's loss and
    optimizer (class weights, accumulation 2), one optimizer step of two
    micro-steps at size^2, over 1 x 2 (global b=2) in fp32, bf16 and fp32
    with remat and over 2 x 2 (global b=4) in fp32: ranks of one gloo group
    on one card, each its own process capped at its share of the free
    memory, the kernels built before they start (the step launches none).
    Each run against `make_train_step` in this process on the same card and
    global batch:
      * every rank's metrics, gradient, parameters and BN statistics equal
        bit for bit (digests)
      * fp32: loss and parts within 1e-4 relative, grad norm 1e-3, BN
        statistics 1e-5; the gradient's distance from the one-process step
        in float64 within twice the one-process fp32 step's own (and at
        least `grad_gate` of its norm), printed beside its distance from
        the one-process fp32 step
      * bf16: the gradient and BN statistics within twice the one-process
        step's own bf16-vs-fp32 distance (RMS), the scalars within
        TRAIN_BF16_RTOL of the fp32 step
      * remat against the striped step without it, at the fp32 gates
    ms per micro-step at S = 1 (this process) and S = 2 (rank 0, median of
    `reps`, each micro-step between a barrier and synchronizes), the peak
    memory per rank against the one-process step's, and the collectives'
    share of a micro-step (host time inside the all-gathers of the
    transport and the all-reduces, between synchronizes, in `reps` more).
    Processes that share one card: not a scaling figure. Returns the
    record."""
    return run_spatial_phases([functools.partial(_spatial_train_part, card, device, **kw)],
                              device)[0]


def _own_train(ranks: dict, keys) -> dict:
    """{world: [each rank's train runs whose (name, arch) is in `keys`]}."""
    return {w: [[t for t in res[1] if (t["name"], t["arch"]) in keys] for res in per_rank]
            for w, per_rank in ranks.items()}


def _spatial_train_part(card="", device="cuda", size=512, reps=3,
                        grad_gate=SPATIAL_TRAIN_GRAD) -> dict:
    """`phase_spatial_train`'s share of `run_spatial_phases` (its
    arguments)."""
    t0 = time.time()
    batches = {("nested_unet", b): _train_batch(b, size, seed=95 + b) for b in (2, 4)}
    want = _spatial_train_references(SPATIAL_TRAIN_RUNS, batches, device, reps)
    rec = dict(backend="gloo", device=device, size=size, runs={})
    keys = {(r[0], r[4]) for r in SPATIAL_TRAIN_RUNS}

    def finish(ranks):
        rec["runs"] = _spatial_train_checks(_own_train(ranks, keys), want, size, card, grad_gate)
        return rec

    return dict(train_runs=SPATIAL_TRAIN_RUNS, batches=batches, reps=dict.fromkeys(keys, reps),
                rec=rec, finish=finish, prep_s=time.time() - t0)



def _spatial_train_references(runs, batches: dict, device, reps: int) -> dict:
    """{(arch, dtype, remat, b): `_spatial_train_steps` in this process (S =
    1) on batches[arch, b]} for each train run of a plan, with the fp32 step
    and its float64 twin (the fp32 step's function, exactly) beside it."""
    want = {}
    for name, shape, dtype, remat, arch in runs:
        b = 2 * shape[0]
        for key in ((arch, dtype, remat, b), (arch, "float32", False, b),
                    (arch, "float64", False, b)):
            if key not in want:
                want[key] = _spatial_train_steps(None, *batches[arch, b], *key[1:3], device,
                                                 0 if key[1] == "float64" else reps, arch=arch)
    return want


def _spatial_train_checks(ranks: dict, want: dict, size: int, card: str, grad_gate: float) -> dict:
    """The train runs of every rank (`{world: [each rank's train runs]}`)
    against the one-process steps (`_spatial_train_references`), by
    `phase_spatial_train`'s gates; logs them and returns {run: record}."""
    out = {}
    runs = {}
    for world, per_rank in ranks.items():
        for i, r0 in enumerate(per_rank[0]):
            name, shape = r0["name"], r0["shape"]
            what = f"spatial train {_train_label(r0)} over {shape[0]} x {shape[1]}"
            for r, res in enumerate(per_rank):
                got = res[i]
                if got["metrics"] != r0["metrics"] or any(
                        got[f"{k}_digest"] != r0[f"{k}_digest"] for k in ("grads", "params", "stats")):
                    raise AssertionError(f"{what}: rank {r}'s metrics or state differ from rank 0's")
            runs[f"{_train_label(r0)} {shape[0]}x{shape[1]}"] = (name, shape, i, per_rank)
    for key, (name, shape, i, per_rank) in runs.items():
        r0 = per_rank[0][i]
        what = f"spatial train {key}"
        dtype, remat, arch = r0["dtype"], r0["remat"], r0["arch"]
        b = 2 * shape[0]
        one = want[arch, dtype, remat, b]
        check = {}
        if dtype == "float32":
            exact = want[arch, "float64", False, b]["grads"]
            for m, (g, w) in enumerate(zip(r0["metrics"], one["metrics"])):
                for k, v in w.items():
                    tol = TRAIN_RTOL.get(k)
                    if tol is not None and abs(g[k] - v) > tol * abs(v):
                        raise AssertionError(f"{what}: micro-step {m} {k} {g[k]} vs one process "
                                             f"{v} (rtol {tol})")
            check = dict(grad=_train_dist(r0["grads"], one["grads"]),
                         grad_vs_float64=_train_dist(r0["grads"], exact),
                         one_process_grad_vs_float64=_train_dist(one["grads"], exact),
                         stats=_max_abs(r0["stats"], one["stats"]),
                         loss_rel=abs(r0["metrics"][0]["loss"] / one["metrics"][0]["loss"] - 1),
                         grad_norm_rel=abs(r0["metrics"][0]["grad_norm"]
                                           / one["metrics"][0]["grad_norm"] - 1))
            if check["stats"] > TRAIN_STATS_ATOL:
                raise AssertionError(f"{what}: BN statistics {check['stats']} > {TRAIN_STATS_ATOL}")
            gate = max(grad_gate, 2 * check["one_process_grad_vs_float64"])
            if check["grad_vs_float64"] > gate:
                raise AssertionError(f"{what}: gradient {check['grad_vs_float64']:.3e} of its norm "
                                     f"from the float64 step, over {gate:.3e} (twice the "
                                     f"one-process fp32's {check['one_process_grad_vs_float64']:.3e}"
                                     f", at least {grad_gate}); {check['grad']:.3e} from the "
                                     f"one-process fp32")
        else:
            f32 = want[arch, "float32", False, b]
            rms = lambda a, c: float((a - c).square().mean().sqrt())
            for k in ("grads", "stats"):
                check[k] = dict(stripes=rms(r0[k], f32[k]), one_process=rms(one[k], f32[k]))
                if check[k]["stripes"] > 2 * check[k]["one_process"]:
                    raise AssertionError(f"{what}: {k} {check[k]['stripes']:.3e} (RMS) from the "
                                         f"fp32 step, over twice the one-process bf16's "
                                         f"{check[k]['one_process']:.3e}")
            for k in TRAIN_RTOL:
                d = abs(r0["metrics"][0][k] - f32["metrics"][0][k])
                if d > TRAIN_BF16_RTOL * abs(f32["metrics"][0][k]):
                    raise AssertionError(f"{what}: {k} {r0['metrics'][0][k]} vs fp32 "
                                         f"{f32['metrics'][0][k]} (rtol {TRAIN_BF16_RTOL})")
        if name == "fp32_remat":
            _, _, j, plain_ranks = runs[f"{_train_label(dict(r0, name='fp32'))} "
                                        f"{shape[0]}x{shape[1]}"]
            plain = plain_ranks[0][j]
            check["vs_no_remat"] = dict(grad=_train_dist(r0["grads"], plain["grads"]),
                                        stats=_max_abs(r0["stats"], plain["stats"]))
            for k in TRAIN_RTOL:
                if abs(r0["metrics"][0][k] - plain["metrics"][0][k]) > TRAIN_RTOL[k] * abs(
                        plain["metrics"][0][k]):
                    raise AssertionError(f"{what}: {k} differs from the striped step without remat")
            if check["vs_no_remat"]["grad"] > grad_gate or \
                    check["vs_no_remat"]["stats"] > TRAIN_STATS_ATOL:
                raise AssertionError(f"{what}: against no remat {check['vs_no_remat']}")
        for m in r0["metrics"]:
            if not all(np.isfinite(v) for v in m.values()):
                raise AssertionError(f"{what}: non-finite metrics {m}")
        ms, ms1 = float(np.median(r0["ms"])), float(np.median(one["ms"]))
        coll = r0["collective_ms"]
        rows = [dict(rank=r, peak_gib=res[i]["peak_gib"], ms=float(np.median(res[i]["ms"])))
                for r, res in enumerate(per_rank)]
        out[key] = dict(ms_per_micro_step=ms, ms_runs=r0["ms"], one_process_ms=ms1,
                        collective_ms=coll, collective_share=sum(coll.values()) / ms,
                        one_process_peak_gib=one["peak_gib"], per_rank=rows,
                        loss=r0["metrics"][0]["loss"], **check)
        peaks = ", ".join("not measured" if row["peak_gib"] is None else f"{row['peak_gib']:.3f}"
                          for row in rows)
        one_peak = "not measured" if one["peak_gib"] is None else f"{one['peak_gib']:.3f}"
        model = ("NestedUNet 3-class DS, 3class_advanced" if arch == "nested_unet" else
                 f"{arch} 3-class, the inspection recipe's combined loss")
        _log(f"{what} ({model}, {size}^2, global b={b}, accumulation 2): loss {r0['metrics'][0]['loss']:.7f} vs one process "
             f"{one['metrics'][0]['loss']:.7f}; "
             + (f"gradient {check['grad']:.3e} of its norm from the one-process step "
                f"({check['grad_vs_float64']:.3e} from its float64, the one-process fp32 "
                f"{check['one_process_grad_vs_float64']:.3e}), BN statistics "
                f"{check['stats']:.3e}, grad norm {check['grad_norm_rel']:.3e} relative"
                if dtype == "float32" else
                f"gradient {check['grads']['stripes']:.3e} (RMS) from the fp32 step "
                f"(one-process bf16 {check['grads']['one_process']:.3e}), BN statistics "
                f"{check['stats']['stripes']:.3e} ({check['stats']['one_process']:.3e})")
             + (f"; against no remat: gradient {check['vs_no_remat']['grad']:.3e}, statistics "
                f"{check['vs_no_remat']['stats']:.3e}" if "vs_no_remat" in check else "")
             + f"; {ms:.3f} ms/micro-step (S=1 {ms1:.3f}); collectives "
             + ", ".join(f"{k} {v:.3f} ms" for k, v in coll.items())
             + f" = {sum(coll.values()) / ms:.1%} (rank 0); peak per rank {peaks} GiB, one "
               f"process {one_peak} GiB [{card}]")
    return out


def _train_label(run: dict) -> str:
    """A train run's name, prefixed with its arch where that is not the
    NestedUNet."""
    return run["name"] if run["arch"] == "nested_unet" else f"{run['arch']} {run['name']}"


# ---------------------------------------------------------------------------
# phase 14: the model zoo on the spatial axis (ranks of one gloo group on one card)
# ---------------------------------------------------------------------------

# the zoo's models whose logits keep the input's size: they train on stripes
SPATIAL_ZOO_TRAIN = ("lightweight:custom", "simple_unet")


def spatial_zoo_plan(H=448, W=800, b=4, model_size=None):
    """(runs, archs) of `phase_spatial_zoo`: `spatial_plan`'s run tuples of
    two_stage on b HxW `synthetic_frames`, every arch of MODEL_ARCHS in
    fp32 and bf16 over 1 x 2, and lightweight:shufflenet_v2_x1_0 in fp32
    over 1 x 4 on the first b // 2 frames (two ranks hold none); `archs`
    maps each run's name to its arch. `model_size` replaces the 512^2 model
    input (a rehearsal on the CPU), widened where it is under one stripe
    unit a rank."""
    from unet_tpu_torch.cli.main import _build_model
    from unet_tpu_torch.pipeline import presets

    frames = synthetic_frames(b, H, W, seed=66)
    runs, archs = [], {}

    def cfg(arch, n):
        if model_size is None:
            return presets.two_stage()
        with torch.device("meta"):
            m = max(model_size, n * _build_model(3, arch, "float32").stripe_unit)
        return presets.two_stage().replace_in("preprocess", model_size=(m, m))

    for arch in MODEL_ARCHS:
        for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
            archs[arch + suffix] = arch
            runs.append((arch + suffix, (1, 2), dtype, cfg(arch, 2), frames))
    arch = "lightweight:shufflenet_v2_x1_0"
    archs[f"{arch} b={b // 2}"] = arch
    runs.append((f"{arch} b={b // 2}", (1, 4), torch.float32, cfg(arch, 4), frames[:b // 2]))
    return runs, archs


def _se_plane_bytes(arch: str, dtype: torch.dtype, size: int, device) -> int:
    """Bytes per frame of the planes that squeeze-excitation's global means
    read in a forward of `arch` at size^2 (each rank of a spatial group
    gathers them whole, receiving (n - 1) / n of them); 0 without SE."""
    from unet_tpu_torch.models.mobilenet import _SE

    model = _spatial_model(arch, dtype).to(device)
    total = [0]
    hooks = [m.register_forward_hook(
        lambda m, i, o: total.__setitem__(0, total[0] + i[0].numel() * i[0].element_size()))
        for m in model.modules() if isinstance(m, _SE)]
    with torch.inference_mode():
        model(torch.zeros((1, 3, size, size), device=device))
    for h in hooks:
        h.remove()
    return total[0]


def phase_spatial_zoo(card="", device="cuda", **kw):
    """The model zoo on the spatial axis (phase 14), with phase 12's harness:
    ranks of one gloo group on one card, one spawn of 2 ranks for every 1 x
    2 run and one of 4 for the 1 x 4 run, the kernels built before they
    start, seeded weights at each model's full width (`seeded_model`). The
    runs of `spatial_zoo_plan` through `parallel.shard_pipeline_step(...,
    spatial=True)` against `build_step` on the same card and frames by
    `_spatial_check`'s rules, the fp32 tie gap scaled by the largest logit
    where it passes 1 (the seeded residual encoders' logits reach 1e3, as
    in `phase_models`); B1 twice per batch on a rank with frames, never on
    one without. The train step of SPATIAL_ZOO_TRAIN (the inspection
    recipe's combined loss, `seeded_train_model(arch=...)`, one optimizer
    step of two fp32 micro-steps at train_size^2, global b=2) over 1 x 2
    against `make_train_step` in this process by `phase_spatial_train`'s
    gates. Squeeze-excitation's gathered bytes per frame of each MobileNet.
    ms per batch at S = 1 and 2, the transport's share, peak memory per
    rank against one process (processes that share one card: not a scaling
    figure). Returns the record."""
    return run_spatial_phases([functools.partial(_spatial_zoo_part, card, device, **kw)],
                              device)[0]


def _spatial_zoo_part(card="", device="cuda", H=448, W=800, b=4, model_size=None,
                      train_size=512, reps=1, grad_gate=SPATIAL_TRAIN_GRAD) -> dict:
    """`phase_spatial_zoo`'s share of `run_spatial_phases` (its
    arguments)."""
    t0 = time.time()
    runs, archs = spatial_zoo_plan(H, W, b, model_size)
    want = _spatial_references(runs, archs, device, reps)
    batch = _train_batch(2, train_size, seed=97)
    batches = {(arch, 2): batch for arch in SPATIAL_ZOO_TRAIN}
    train_runs = tuple(("fp32", (1, 2), "float32", False, arch) for arch in SPATIAL_ZOO_TRAIN)
    twant = _spatial_train_references(train_runs, batches, device, reps)
    rec = dict(backend="gloo", device=device, runs={}, se_plane_bytes_per_frame={})
    for arch in MODEL_ARCHS:
        if "mobilenet" in arch:
            size = runs[[r[0] for r in runs].index(arch)][3].preprocess.model_size[0]
            got = {str(dt).replace("torch.", ""): _se_plane_bytes(arch, dt, size, device)
                   for dt in (torch.float32, torch.bfloat16)}
            rec["se_plane_bytes_per_frame"][arch] = got
            _log(f"spatial zoo {arch}: squeeze-excitation reads {got} bytes of planes a frame "
                 f"at {size}^2; each of n ranks gathers (n - 1) / n of them")
    keys = {(r[0], r[4]) for r in train_runs}

    def finish(ranks):
        for per_rank in ranks.values():
            for i, r0 in enumerate(per_rank[0][0]):
                if r0["name"] in want:
                    key = f"{r0['name']} {r0['shape'][0]}x{r0['shape'][1]}"
                    rec["runs"][key] = _spatial_check([res[0][i] for res in per_rank], want,
                                                      r0["name"].rsplit("_", 1)[0], card,
                                                      scale_gap=True)
        rec["train"] = _spatial_train_checks(_own_train(ranks, keys), twant, train_size, card,
                                             grad_gate)
        _log(f"spatial zoo: {len(rec['runs'])} inspection runs and {len(rec['train'])} train "
             f"runs")
        return rec

    return dict(runs=runs, archs=archs, train_runs=train_runs, batches=batches,
                reps={**{r[0]: reps for r in runs}, **dict.fromkeys(keys, reps)}, rec=rec,
                finish=finish, prep_s=time.time() - t0)



# ---------------------------------------------------------------------------
# the throughput bench (unet_tpu_torch.bench): the chunked step against
# per-batch steps, the bench's (preset, dtype) pairs against fp32, and its
# first fixed point at b=96
# ---------------------------------------------------------------------------

BENCH_CHUNKED = (("two_stage", "bf16"), ("two_stage", "int8"), ("enhanced", "bf16"))
# the pairs the bench runs that no earlier phase holds against fp32
BENCH_PAIRS = (("enhanced", "bf16"), ("enhanced", "int8"), ("high_res_roi", "bf16"),
               ("wrap_7class", "bf16"), ("wrap_7class", "int8"))
BENCH_AGREEMENT = 0.995   # validate_int8's fallback threshold (PERF.md §2)


def bench_scenes(preset: str, b: int, H: int, W: int, seed: int) -> np.ndarray:
    """Frames for a preset of the bench: enhanced's turned scenes,
    high_res_roi's 2448x2048 ones, wrap_7class's wrap scenes, else
    two_stage's burr scenes."""
    if preset == "enhanced":
        return enhanced_scenes(b, H, W, seed=seed)
    if preset == "high_res_roi":
        return high_res_scenes(b, seed=seed)
    if preset == "wrap_7class":
        return wrap_scenes(b, H, W, seed=seed)
    return synthetic_frames(b, H, W, seed=seed)


def phase_bench(expect, card="", device="cuda", H=448, W=800, b=8, chunk=4, high_res_b=2,
                first_point=("chunked", 96, "int8"), check_b=8, model_size=None,
                normalize_wh=None) -> dict:
    """Phase 15: (a) `stages.build_chunked_step` at K=`chunk`, b=`b`
    against `chunk` calls of `build_step` on the same frames, two_stage bf16
    and int8 and enhanced bf16 with the seeded NestedUNet: every output
    tensor bit for bit, launches exactly `chunk` times `expect`'s per batch
    on both sides; (b) the pairs of BENCH_PAIRS (high_res_roi on
    `high_res_b` native frames) against the fp32 step on the same frames,
    class maps at >= BENCH_AGREEMENT; (c) `bench._fixed_points` at
    `first_point` on 800x448 frames, its frames/s, peak memory and launches
    (exactly the calls times K times the per-batch counts), then at that
    batch the B1 and qconv inputs of the bench's int8 step, and B2 on as
    many (H, W) planes, each kernel's output on the last `check_b` frames
    against its plain version there. `model_size` and `normalize_wh`
    shrink the presets for a rehearsal on the CPU."""
    from unet_tpu_torch import bench
    from unet_tpu_torch.ops import cc_kernels, nlm_kernels, qconv_kernels
    from unet_tpu_torch.pipeline import presets, stages

    t_phase = time.time()
    torch.cuda.empty_cache()
    rec = {"chunked": {}, "pairs": {}, "seconds": {}}

    def preset(name):
        cfg = presets.get_preset(name)
        if model_size is not None:
            cfg = cfg.replace_in("preprocess", model_size=(model_size, model_size))
        if normalize_wh is not None and cfg.preprocess.normalize_wh:
            cfg = cfg.replace_in("preprocess", normalize_wh=normalize_wh)
        return cfg

    models = {}

    def model(n, dtype):
        if (n, dtype) not in models:
            models[n, dtype] = seeded_nested_unet(num_classes=n, dtype=dtype)
        return models[n, dtype]

    def low_cfg(name, dtype, calib):
        cfg = preset(name)
        if dtype == "bf16":
            return cfg.replace_in("segment", fast_forward=True)
        return stages.calibrate_int8(model(cfg.segment.num_classes, torch.bfloat16), cfg,
                                     [calib], device=device)

    # (a) the chunked step against per-batch steps
    t = time.time()
    for name, dtype in BENCH_CHUNKED:
        path = f"{name}_{dtype}"
        frames = torch.from_numpy(bench_scenes(name, chunk * b, H, W, seed=50)).to(device)
        frames = frames.reshape((chunk, b) + frames.shape[1:])
        cfg = low_cfg(name, dtype, bench_scenes(name, b, H, W, seed=58))
        m = model(3, torch.bfloat16)
        chunked = stages.build_chunked_step(m, cfg, device=device)
        step = stages.build_step(m, cfg, device=device)
        got, counts = _runner_counts(chunked, frames)
        want, counts_pb = _runner_counts(lambda f: [step(fb) for fb in f], frames)
        per_batch = expect[path if name == "two_stage" else name]
        times = {k: chunk * v for k, v in per_batch.items()}
        if counts != times or counts_pb != times:
            raise AssertionError(f"chunked {path}: launches {counts} and {counts_pb} per "
                                 f"{chunk} batches, expected {times}")
        g = _leaves(got)
        for k, w in enumerate(want):
            wl = _leaves(w)
            if set(wl) != set(g):
                raise AssertionError(f"chunked {path}: fields {sorted(g)} vs {sorted(wl)}")
            for f, wv in wl.items():
                if tuple(g[f].shape) != (chunk,) + tuple(wv.shape) or not torch.equal(g[f][k], wv):
                    raise AssertionError(f"chunked {path}: {f}[{k}] differs from build_step's")
        _check_outputs(stages.FrameOutputs(*(getattr(got, f).flatten(0, 1) for f in (
            "class_map", "cable_px", "tape_px", "burr_px"))), chunk * b,
            *got.class_map.shape[-2:], f"chunked {path}")
        rec["chunked"][path] = dict(launches=counts, tensors=len(g), batches=chunk, batch=b,
                                    cable_px=got.cable_px.sum().item())
        _log(f"bench chunked {path}: K={chunk} x b={b} in one call equals {chunk} build_step "
             f"calls bit for bit ({len(g)} tensors); launches {counts}")
    rec["seconds"]["chunked"] = round(time.time() - t, 1)

    # (b) the bench's new (preset, dtype) pairs against the fp32 step
    t = time.time()
    for name, dtype in BENCH_PAIRS:
        cfg32 = preset(name)
        n = cfg32.segment.num_classes
        bb = high_res_b if name == "high_res_roi" else b
        frames = torch.from_numpy(bench_scenes(name, bb, H, W, seed=60)).to(device)
        ref = stages.build_step(model(n, torch.float32), cfg32, device=device)(frames)
        cfg = low_cfg(name, dtype, bench_scenes(name, bb, H, W, seed=68))
        out, counts = _runner_counts(stages.build_step(model(n, torch.bfloat16), cfg,
                                                       device=device), frames)
        want_q = expect["two_stage_int8"]["qconv"] if dtype == "int8" else 0
        want_nlm = expect["enhanced"]["nlm"] if name == "enhanced" else 0
        if (counts["qconv"], counts["nlm"]) != (want_q, want_nlm):
            raise AssertionError(f"{name} {dtype}: launches {counts}")
        agree = float((out.class_map == ref.class_map).float().mean())
        rec["pairs"][f"{name}_{dtype}"] = dict(agreement_vs_fp32=agree, launches=counts, batch=bb)
        _log(f"bench pair {name} {dtype} (model {cfg.preprocess.model_size[0]}^2, b={bb}, "
             f"frames {tuple(frames.shape[1:3])}): class maps vs the fp32 step {agree:.6f}; "
             f"launches {counts}")
        if not agree >= BENCH_AGREEMENT:
            raise AssertionError(f"{name} {dtype}: class maps agree {agree} < {BENCH_AGREEMENT} "
                                 f"with the fp32 step")
    rec["seconds"]["pairs"] = round(time.time() - t, 1)

    # (c) the bench's first fixed point, then its kernels at that batch
    t = time.time()
    mode, pb, dtype = first_point
    K = 4   # bench._fixed_points' chunk
    _zero_counts()
    results = bench._fixed_points("two_stage", {}, [first_point], frame_hw=(H, W), device=device)
    counts = _read_counts()
    if not results:
        raise AssertionError(f"bench point {first_point} skipped: {bench._PARTIAL['skipped']}")
    r = results[0]
    calls = 1 + bench.REPEATS * max(int(round(bench.N_FRAMES / (K * pb))), 4)
    per_call = {k: v * (K if mode == "chunked" else 1)
                for k, v in expect[f"two_stage_{dtype}"].items()}
    if counts != {k: calls * v for k, v in per_call.items()}:
        raise AssertionError(f"bench point {first_point}: launches {counts} in {calls} calls, "
                             f"expected {per_call} a call")
    rec["point"] = dict(r, calls=calls, launches=counts, seconds=round(time.time() - t, 1))
    _log(f"bench point {mode}/b{pb}/{dtype} two_stage {W}x{H}: {r['fps']:.2f} frames/s (median "
         f"{r['median']:.2f}), peak {r['peak_gib']} GiB, {calls} calls, launches {counts} [{card}]")

    model96, _cfg, cfg_for = bench._build_pipeline("two_stage", {}, (H, W), device=device)
    frames = torch.from_numpy(bench._synthetic_frames(np.random.default_rng(0), pb, H, W)
                              ).to(device)
    cc_rec, _, q_rec = _record_main_path_inputs(
        stages.build_step(model96, cfg_for(dtype), device=device), frames, f"bench_b{pb}")
    n = min(check_b, pb)
    for site, (state0, fg, kw) in cc_rec.items():
        got = cc_kernels.propagate(state0, fg, **kw)[-n:]
        if not torch.equal(got, cc_kernels.propagate_plain(state0[-n:], fg[-n:], **kw)):
            raise AssertionError(f"cc_propagate at {site} {tuple(state0.shape)}: the last {n} "
                                 f"planes differ from the plain version")
    for site, (x, wq, mult, bias) in q_rec.items():
        tail = tuple(s[-n:] for s in x) if isinstance(x, tuple) else x[-n:]
        if not torch.equal(qconv_kernels.qconv(x, wq, mult, bias)[-n:],
                           qconv_kernels.qconv_plain(tail, wq, mult, bias)):
            raise AssertionError(f"qconv at {site}: the last {n} frames differ from the plain "
                                 f"version")
    planes = torch.from_numpy(noisy_planes((pb, H, W), seed=9)).to(device)
    got, want = nlm_kernels.nlm(planes, 10.0)[-n:], nlm_kernels.nlm_plain(planes[-n:], 10.0)
    nlm_err = float((got - want).abs().max())
    if not torch.allclose(got, want, **NLM_TOL):
        raise AssertionError(f"nlm on {tuple(planes.shape)} planes: the last {n} differ from "
                             f"the plain version by {nlm_err}")
    rec["b96_checks"] = dict(cc_sites=sorted(cc_rec), qconv_sites=len(q_rec),
                             shapes={s: list(v[0].shape) for s, v in cc_rec.items()},
                             nlm_planes=list(planes.shape), nlm_max_abs_err=nlm_err,
                             frames_checked=n)
    _log(f"bench b={pb}: B1 at {len(cc_rec)} sites {[tuple(v[0].shape) for v in cc_rec.values()]} "
         f"and qconv at {len(q_rec)} sites bit for bit with their plain versions on the last {n} "
         f"frames; B2 on {tuple(planes.shape)} planes within rtol 2e-5 / atol 2e-3 (max abs "
         f"err {nlm_err:.3e})")
    rec["seconds"]["point"] = round(time.time() - t, 1)
    rec["seconds"]["phase"] = round(time.time() - t_phase, 1)
    _log(f"phase bench: {rec['seconds']} s")
    return rec


@contextlib.contextmanager
def _deterministic():
    """torch's deterministic algorithms (and cuDNN's), restored on exit."""
    was = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark, os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = was[1], was[2]
        if was[3] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = was[3]



def _diameters_close(got: dict, want, what: str) -> dict:
    """An artifact's diameters against the live step's: float fields within
    rtol 1e-5 (tests/test_export.py's gate), integer fields equal, a cable
    diameter somewhere. Returns the largest relative error and dc_px."""
    err = 0.0
    for f, wv in want._asdict().items():
        wv, gv = wv.cpu().numpy(), got[f]
        if wv.dtype.kind == "f":
            np.testing.assert_allclose(gv, wv, rtol=1e-5, err_msg=what)
            err = max(err, float((np.abs(gv - wv) / np.maximum(np.abs(wv), 1e-30)).max()))
        elif not np.array_equal(gv, wv):
            raise AssertionError(f"{what}: diameters.{f} differs")
    if not float(np.abs(got["dc_px"]).max()) > 0:
        raise AssertionError(f"{what}: zero cable diameters, geometry untested")
    return dict(diameters_max_rel_err=err, dc_px=got["dc_px"].tolist())


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
    expect = expected_launches()
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

    # -- the eight presets of the threshold modes, the postprocess, the
    # letterbox and dynamic ROI, the quality gate and the tracker
    pre_rec, pre_counts, pre_checks, pre_timings = phase_presets(
        {p: presets.get_preset(p) for p in PRESET_PATHS}, expect, H, W)
    counts.update(pre_counts)
    # B1's new sites, one input each into the kernel-vs-plain comparisons
    new_sites = {k: v for k, v in pre_rec.items() if k in (
        "spatial/label 1 (spatial_strip_filter)", "roi_first/hysteresis (detect_vertical_roi)",
        "roi_first/label 1 (refine_mask_by_geometry)", "robust/label 1 (filter_cable_by_shape)",
        "robust/label 2 (largest_component)", "optimized/label 6 (defect_components)")}
    if len(new_sites) != 6:
        raise AssertionError(f"new B1 sites not recorded: {sorted(pre_rec)}")

    # -- the model zoo through two_stage, fp32 and bf16; one step traced
    mod_rec, mod_counts, mod_checks, mod_timings = phase_models(expect["two_stage"], H, W,
                                                                card=card)
    counts.update(mod_counts)
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as d:
        trace = phase_trace(stages.build_step(ColourClassModel(), cfgs["two_stage"], "cuda"),
                            torch.from_numpy(scenes["two_stage"](8, 0)).cuda(), d)

    # -- kernels against their plain versions, and their times
    cc_launch, cc_err = phase_cc({**cc_rec, **new_sites, **mod_rec})
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

    # -- the product loop: the port's CLI over .bmp directories, then the
    # quality gate and the defect tracker through the engine
    engine_counts, engine = phase_engine()
    gate_counts, gate_engine = phase_inspect_engine(H, W)
    engine_counts.update(gate_counts)
    config_counts, config_runs = phase_config_runs(H, W)
    engine_counts.update(config_counts)

    # -- training: the train step card against CPU, its times, cli train/evaluate
    train = phase_train(card=card)
    engine_counts["engine_train_best_two_stage"] = train["cli"]["infer_launches_per_batch"]

    # -- torch.export: the artifacts against the live steps, launches counted
    export = phase_export(expect, H, W, card=card)
    for name, r in export["pipelines"].items():
        engine_counts[f"export_{name}"] = r["runs"][8]["launches"]

    # -- the device mesh at world size 1: the sharded step, train step and
    # server against the same work without a mesh
    mesh = phase_mesh(expect, H, W, card=card)
    for name, r in mesh["steps"].items():
        engine_counts[f"mesh_{name}"] = r["launches"]

    # -- phases 12-14, one spawn of 2 ranks and one of 4 on the card (a gloo
    # group): the spatial axis, the striped steps against build_step; the
    # spatial train step against make_train_step; the model zoo on the
    # spatial axis, every --arch's inspection step over 1 x 2 (shufflenet
    # also 1 x 4) and the train step of the two models whose logits keep
    # the input's size
    spatial, spatial_train, spatial_zoo = run_spatial_phases(
        [functools.partial(part, card) for part in (_spatial_part, _spatial_train_part,
                                                    _spatial_zoo_part)], "cuda")

    # -- phase 15, the throughput bench: the chunked step against per-batch
    # steps, the bench's new (preset, dtype) pairs against fp32, its first
    # fixed point at b=96 and the kernels at that batch
    bench = phase_bench(expect, card=card)

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
        # batch per path, summed, to match `launches`; the engine's runs
        # beside them, per batch of each run (their whole-run counts are
        # under record["engine"]["runs"])
        keys = ("ms", "plain_ms", "bound_ms") + (("global_ms",) if "global_ms" in per_launch[0] else ())
        total = {k: sum(p[k] for p in per_launch) for k in keys}
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_per_path": by_path,
                "engine_launches_per_batch": {p: c[name] for p, c in engine_counts.items()
                                              if c[name]},
                "max_abs_err": max_err, **total,
                "bound_by": max(per_launch, key=lambda p: p["bound_ms"])["bound_by"],
                "library_ms": library_ms, "per_launch": per_launch,
                "spatial_launches_per_rank": {
                    k: [row["counts"].get(name, 0) for row in r["per_rank"]]
                    for k, r in spatial["runs"].items()},
                "spatial_zoo_launches_per_rank": {
                    k: [row["counts"].get(name, 0) for row in r["per_rank"]]
                    for k, r in spatial_zoo["runs"].items()},
                "bench_chunked_launches_per_call": {
                    k: r["launches"][name] for k, r in bench["chunked"].items()
                    if r["launches"][name]}, **extra}

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
        "presets_b8": pre_timings, "preset_checks": pre_checks,
        "engine": engine, "inspect_engine": gate_engine, "config_runs": config_runs,
        "models_b8": mod_timings, "model_checks": mod_checks, "device_trace": trace,
        "train": train, "export": export, "mesh": mesh, "spatial": spatial,
        "spatial_train": spatial_train, "spatial_zoo": spatial_zoo, "bench": bench,
        "card": card, "seconds": round(time.time() - t_start, 1)}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
