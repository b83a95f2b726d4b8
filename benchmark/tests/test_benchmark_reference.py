"""The reference against the port's plain CPU route at a small model size
(64x64 model input, 64x112 frames), and a check that the reference loads
nothing of the port."""
import json
import subprocess
import sys

import pytest
import torch

from benchmark import inputs
from benchmark.reference import nested_unet, pipeline
from benchmark.tests.conftest import REPO


def _setup(config: str, seed: int, n: int = 3):
    cf = json.loads((REPO / f"benchmark/configs/{config}.json").read_text())
    cf["pipeline"]["preprocess"]["model_size"] = [64, 64]
    gen = torch.Generator().manual_seed(seed)
    sd = inputs.nested_unet_state(cf["model"], gen, "cpu")
    frames = inputs.cable_scenes(n, (64, 112), cf["scene"], gen, "cpu")
    pc = cf["pipeline"]
    sd = inputs.fit_head(sd, pipeline.model_input(pipeline.conditioned(frames, pc), pc), gen)
    return cf, sd, frames


def _port_fp32_step(cf, sd):
    from unet_tpu_torch.models import NestedUNet
    from unet_tpu_torch.pipeline import get_preset, stages

    m = cf["model"]
    model = NestedUNet(num_classes=m["num_classes"], deep_supervision=m["deep_supervision"])
    model.load_state_dict(sd)
    cfg = get_preset(cf["preset"], **cf["preset_kwargs"]).replace_in(
        "preprocess", model_size=tuple(cf["pipeline"]["preprocess"]["model_size"]))
    return model.eval(), stages.build_step(model, cfg, device="cpu")


@pytest.mark.parametrize("config,seed", [("nested_unet3-two_stage", 3),
                                         ("nested_unet3-enhanced", 4)])
def test_reference_equals_the_ports_fp32_step_on_the_cpu(config, seed):
    """Same weights, same frames: the reference's logits within float32
    rounding of the port's fp32 NestedUNet (both F.conv2d and F.batch_norm
    on the CPU), its class maps and counts those of the port's fp32 step."""
    cf, sd, frames = _setup(config, seed)
    model, step = _port_fp32_step(cf, sd)
    ref = pipeline.run(frames, sd, cf["pipeline"])
    with torch.inference_mode():
        x = pipeline.model_input(pipeline.conditioned(frames, cf["pipeline"]), cf["pipeline"])
        torch.testing.assert_close(nested_unet.forward(sd, x), model(x), rtol=1e-5, atol=1e-5)
    out = step(frames)
    assert torch.equal(out.class_map, ref.class_map)
    for k in ("cable_px", "tape_px", "burr_px"):
        assert torch.equal(getattr(out, k), getattr(ref, k)), k
    assert int((ref.class_map == 1).sum()) > 0 and int((ref.class_map == 2).sum()) > 0


def test_the_fitted_head_follows_the_scene():
    """The seed-fitted head makes the class map follow the frame: cable,
    tape and background each take a fair share, mostly where the colours
    put them."""
    cf, sd, frames = _setup("nested_unet3-two_stage", 7, n=4)
    x = pipeline.model_input(pipeline.conditioned(frames, cf["pipeline"]), cf["pipeline"])
    truth = inputs.colour_classes(x)
    pred = nested_unet.forward(sd, x).argmax(1)
    assert float((pred == truth).float().mean()) > 0.8
    assert all(int((pred == k).sum()) > 0.02 * pred.numel() for k in range(3))


def test_int4_control_differs_from_the_float32_reference():
    cf, sd, frames = _setup("nested_unet3-two_stage", 5)
    pc = cf["pipeline"]
    x = pipeline.model_input(pipeline.conditioned(frames, pc), pc)
    q = nested_unet.calibrate(sd, [x], bits=4)
    assert set(q.amax) == {f"{b}.conv{i}" for b, _, _ in inputs.BLOCKS for i in (1, 2)}
    diff = (nested_unet.forward(sd, x, q) - nested_unet.forward(sd, x)).abs().max()
    assert float(diff) > 0.1


_REF_ONLY = r"""
import sys, json, torch
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from benchmark import inputs
from benchmark.reference import pipeline
cf = json.loads(Path(sys.argv[2]).read_text())
cf["pipeline"]["preprocess"]["model_size"] = [64, 64]
g = torch.Generator().manual_seed(1)
sd = inputs.nested_unet_state(cf["model"], g, "cpu")
pipeline.run(inputs.cable_scenes(1, (64, 112), cf["scene"], g, "cpu"), sd, cf["pipeline"])
print(",".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


@pytest.mark.parametrize("config", ["nested_unet3-two_stage", "nested_unet3-enhanced"])
def test_the_reference_loads_nothing_of_the_port(config):
    out = subprocess.run([sys.executable, "-c", _REF_ONLY, str(REPO),
                          str(REPO / f"benchmark/configs/{config}.json")],
                         capture_output=True, text=True, timeout=600, check=True).stdout
    tops = set(out.strip().splitlines()[-1].split(","))
    assert "benchmark" in tops
    assert not tops & {"unet_tpu_torch", "unet_tpu", "jax", "jaxlib", "flax"}
