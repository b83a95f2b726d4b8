"""Readings for the limits of a cell's check: the program's numbers and
its control's, on several seeds in one process, at the cell's own sizes.

    python3 -m benchmark.control --workload <cell> --seeds <n> [<n> ...]

For each seed, set-up as a run makes it (weights and frames from the
seed, the head fitted, the program's step); the program's numbers are
those of the judged frames of the window's first calls, through the
window's own step; the control's are those of the same frames from the
reference computed one precision below the cell's, put in the program's
place: the forward in int4 (weights per output channel, activations per
tensor, scales from the reference's own calibration on the frames the
program calibrates on), one step below the cells' int8, and the float32
stages before it (resize, Lab, CLAHE, non-local means, sharpen) with their
planes kept in bfloat16. One JSON line a seed on standard output, with
each side's verdict under the cell's own limits (`check.verdict`).
"""
import argparse
import json
import sys
from pathlib import Path

import torch

from benchmark import cell, check, spec, traffic
from benchmark.reference import nested_unet, pipeline as ref_pipeline

ROOT = Path(__file__).resolve().parent.parent


def program_numbers(sp, s, seed, device):
    wl = sp.workload
    sample = cell.Sample(seed, wl, s.per_call)
    traffic.closed_loop(s.step, inputs=s.inputs, frames_per_call=s.per_call,
                        in_flight=wl["in_flight"], device=device, calls=wl["judge"]["calls"],
                        on_call=sample)
    return sample, check.judge(sample.items(s.frames), s.sd, sp.config["pipeline"],
                               planned=len(sample.slots))


PLANES = torch.bfloat16   # the control's planes between the float32 stages


def control_numbers(sp, s, sample, device, block=8):
    """The reference one precision below in the program's place, on the
    judged frames."""
    pc = sp.config["pipeline"]
    calib = ref_pipeline.conditioned(s.frames[:cell.CALIBRATION_FRAMES], pc, PLANES)
    quant = nested_unet.calibrate(s.sd, [ref_pipeline.model_input(calib, pc)], bits=4)
    judged = sample.items(s.frames)
    items = []
    for k in range(0, len(judged), block):
        part = judged[k:k + block]
        r = ref_pipeline.run(torch.stack([j.frame for j in part]), s.sd, pc, quant, PLANES)
        items += [check.Judged(j.frame, r.class_map[i],
                               torch.stack((r.cable_px[i], r.tape_px[i], r.burr_px[i])))
                  for i, j in enumerate(part)]
    return check.judge(items, s.sd, pc, planned=len(sample.slots))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sp = spec.load(ROOT, args.workload)
    device = torch.device(args.device)
    for seed in args.seeds:
        s = cell.prepare(sp, seed, device)
        traffic.closed_loop(s.step, inputs=s.inputs, frames_per_call=s.per_call,
                            in_flight=sp.workload["in_flight"], device=device,
                            calls=sp.workload["warm_calls"])
        if sp.workload["precision"] != "int8":
            raise SystemExit(f"{args.workload}: the control is defined for int8 cells only")
        sample, prog = program_numbers(sp, s, seed, device)
        ctrl = control_numbers(sp, s, sample, device)
        limits = sp.workload["limits"]
        print(json.dumps({"workload": args.workload, "seed": seed, "program": prog,
                          "control": ctrl, "control_is": "reference int4, bfloat16 planes",
                          "program_correct": check.verdict(prog, limits),
                          "control_correct": check.verdict(ctrl, limits)}), flush=True)
        del s
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
