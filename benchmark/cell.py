"""One run of one cell: set-up, the measured window, the traced
sub-window, the check against the reference, and the metrics.

The program is `unet_tpu_torch`, reached through its public entry points
only: `models.NestedUNet`, `pipeline.get_preset` (with
`segment.fast_forward`, the BN-folded forward), `stages.calibrate_int8`,
`stages.build_chunked_step` and `stages.build_step`.
"""
from __future__ import annotations

import random
import subprocess
import sys
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from . import check, inputs, spec as spec_mod, trace as trace_mod, traffic
from .reference import pipeline as ref_pipeline

COMPUTE_DTYPE = torch.bfloat16   # the model's compute type at both precisions (the int8 requant)
CALIBRATION_FRAMES = 8     # int8 calibration runs on the seed's first frames


class Card(NamedTuple):
    platform: str
    kind: str
    count: int
    power_limit: str
    sms: int
    clock_hz: float


class Run(NamedTuple):
    """What a metric's reader sees."""
    spec: spec_mod.Spec
    card: Card
    setup_s: float
    window: traffic.Window
    peak_bytes: int
    trace: Optional[trace_mod.Trace]


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.splitlines()[0].strip()


def card(device: torch.device) -> Card:
    if device.type != "cuda":
        return Card("cpu", "cpu", 1, "none", 0, 0.0)
    props = torch.cuda.get_device_properties(device)
    clock_mhz = float(_smi("clocks.max.sm").split()[0])
    return Card("gpu", torch.cuda.get_device_name(device), 1, _smi("power.limit"),
                props.multi_processor_count, clock_mhz * 1e6)


def _port_step(sd, frames, sp: spec_mod.Spec, device):
    """The program's model, config and step for this cell."""
    from unet_tpu_torch.models import NestedUNet
    from unet_tpu_torch.pipeline import get_preset, stages

    m, wl, cf = sp.config["model"], sp.workload, sp.config
    with torch.device("meta"):
        model = NestedUNet(num_classes=m["num_classes"], input_channels=m["input_channels"],
                           deep_supervision=m["deep_supervision"], dtype=COMPUTE_DTYPE)
    model = model.to_empty(device=device)
    model.load_state_dict(sd)
    cfg = get_preset(cf["preset"], **cf["preset_kwargs"]).replace_in(
        "segment", fast_forward=True).replace_in(
        "preprocess", model_size=tuple(cf["pipeline"]["preprocess"]["model_size"]))
    if wl["precision"] == "int8":
        cfg = stages.calibrate_int8(model, cfg, [frames[:CALIBRATION_FRAMES]], device=device)
    build = stages.build_chunked_step if wl["step"] == "chunked" else stages.build_step
    return build(model, cfg, device=device)


class Setup(NamedTuple):
    sd: Dict[str, torch.Tensor]   # the weights both sides get
    frames: torch.Tensor          # (distinct * per_call, H, W, 3) uint8 on the device
    step: Callable
    inputs: List[torch.Tensor]    # each call's input
    per_call: int                 # frames a call


def _per_call(wl: dict) -> int:
    return wl["batch"] * (wl["chunks"] if wl["step"] == "chunked" else 1)


def prepare(sp: spec_mod.Spec, seed: int, device: torch.device) -> Setup:
    """Weights and frames from the seed, the head fitted, and the program's
    step at the cell's precision."""
    wl, cf = sp.workload, sp.config
    gen = torch.Generator(device).manual_seed(seed)
    sd = inputs.nested_unet_state(cf["model"], gen, device)
    per_call = _per_call(wl)
    frames = inputs.cable_scenes(wl["distinct"] * per_call, tuple(cf["frame_hw"]), cf["scene"],
                                 gen, device)
    pc = cf["pipeline"]
    fit = frames[:inputs.FIT_FRAMES]
    sd = inputs.fit_head(sd, ref_pipeline.model_input(ref_pipeline.conditioned(fit, pc), pc), gen)
    step = _port_step(sd, frames, sp, device)
    return Setup(sd, frames, step, _call_inputs(frames, wl, device), per_call)


def _call_inputs(frames: torch.Tensor, wl: dict, device: torch.device) -> List[torch.Tensor]:
    per_call = _per_call(wl)
    shape = ((wl["chunks"], wl["batch"]) if wl["step"] == "chunked" else (wl["batch"],)) \
        + tuple(frames.shape[1:])
    out = [frames[i * per_call:(i + 1) * per_call].reshape(shape) for i in range(wl["distinct"])]
    if wl["inputs"] == "pinned_host":
        out = [x.cpu().pin_memory() if device.type == "cuda" else x.clone() for x in out]
    return out


def _sample(seed: int, wl: dict, per_call: int):
    """The judged (call, frame in call) slots, drawn from the seed among
    the window's first `judge.calls` calls."""
    j = wl["judge"]
    slots = random.Random(seed).sample(range(j["calls"] * per_call), j["frames"])
    return sorted((s // per_call, s % per_call) for s in slots)


class Sample:
    """The judged slots of a run and what the program returned for them,
    kept as each call is issued (a copy of each judged frame's class map
    and counts, so that no call's outputs outlive it)."""

    def __init__(self, seed: int, wl: dict, per_call: int):
        self.wl, self.per_call = wl, per_call
        self.slots = _sample(seed, wl, per_call)
        self.kept: Dict[tuple, check.Judged] = {}

    def __call__(self, i: int, out) -> None:
        for c, f in self.slots:
            if c == i:
                idx = divmod(f, self.wl["batch"]) if self.wl["step"] == "chunked" else (f,)
                counts = torch.stack((out.cable_px[idx], out.tape_px[idx], out.burr_px[idx]))
                self.kept[(c, f)] = check.Judged(None, out.class_map[idx].clone(), counts)

    def items(self, frames: torch.Tensor) -> List[check.Judged]:
        """The kept outputs beside the frames they were made from."""
        n = self.wl["distinct"]
        return [j._replace(frame=frames[(c % n) * self.per_call + f])
                for (c, f), j in sorted(self.kept.items())]


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(sp: spec_mod.Spec, seed: int, seconds: float, traced: bool, device="cuda",
        t0: Optional[float] = None, wrap_step: Optional[Callable] = None) -> dict:
    """One run. `t0`: the host clock at the process's start, from which
    set-up is counted. `wrap_step(step) -> step` stands a broken program in
    the window's place (the fault tests). Returns the result line's
    fields, and under "check_lines" the checks for standard error."""
    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    wl = sp.workload
    the_card = card(device)
    s = prepare(sp, seed, device)
    step = s.step if wrap_step is None else wrap_step(s.step)
    loop = dict(inputs=s.inputs, frames_per_call=s.per_call, in_flight=wl["in_flight"],
                device=device)
    traffic.closed_loop(step, calls=wl["warm_calls"], **loop)
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0
    _log(f"set-up {setup_s:.3f} s")

    sample = Sample(seed, wl, s.per_call)
    window = traffic.closed_loop(step, seconds=seconds, on_call=sample, **loop)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    _log(f"window {window.seconds:.3f} s, {len(window.calls)} calls, {window.frames} frames")
    tr = None
    if traced:
        t = time.perf_counter()
        with trace_mod.profiled() as box:
            traffic.closed_loop(step, calls=wl["trace_calls"], **loop)
        tr = box[0]
        _log(f"traced {wl['trace_calls']} calls and read {len(tr.events)} events in "
             f"{time.perf_counter() - t:.3f} s")
    del step
    s = s._replace(step=None, inputs=None)     # the program's state goes before the check
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    numbers = check.judge(sample.items(s.frames), s.sd, sp.config["pipeline"],
                          planned=len(sample.slots))
    _log(f"check {time.perf_counter() - t:.3f} s")
    limits = wl["limits"]

    r = Run(sp, the_card, setup_s, window, peak, tr)
    metrics = {}
    for m in (sp.per_layer if traced else sp.end_to_end):
        value = spec_mod.reader(sp.root, m["name"])(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": the_card.platform, "kind": the_card.kind, "count": the_card.count,
           "memory_peak_bytes": peak}
    out = {"correct": check.verdict(numbers, limits), "attempted": window.frames,
           "failed": 0, "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = trace_mod.busy_s(tr)
        dev["window_s"] = tr.window_s
        ops = {k: v[0] for k, v in trace_mod.by_name(tr).items()}
        out["breakdown"] = {"device_ops": trace_mod.top(ops),
                            "idle_gaps": trace_mod.top(trace_mod.idle_gaps(tr))}
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in check.NUMBERS}
    out["check_lines"] = check.lines(numbers, limits)
    out["card_line"] = (f"card {the_card.kind} power.limit {the_card.power_limit} "
                        f"SMs {the_card.sms} max SM clock {the_card.clock_hz / 1e6:.0f} MHz")
    return out
