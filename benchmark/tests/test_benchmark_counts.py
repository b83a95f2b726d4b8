"""The benchmark's counts reproduce the port's recorded figures: the
NestedUNet's 111.6 GFLOP a 512x512 frame, qconv's bounds at b=8 (0.51814
ms for the 17 wgmma launches, 0.02191 ms for the c3 launch) and the NLM
bound of 0.15359 ms a (8, 448, 800) plane at 132 SMs and 1980 MHz."""
import json

import pytest

from benchmark.counts import bounds, nested_unet
from benchmark.tests.conftest import REPO


@pytest.fixture(scope="module")
def model():
    return json.loads((REPO / "benchmark/configs/nested_unet3-two_stage.json").read_text())["model"]


def test_nested_unet_flops_a_frame(model):
    convs, head = nested_unet.frame_ops(model, (512, 512))
    assert len([c for c in nested_unet.convs(model, (512, 512)) if c.k == 3]) == 18
    assert round(convs / 1e9, 1) == 111.6
    assert round((convs + head) / 1e9, 2) == 111.64


def test_qconv_bounds_at_b8(model):
    convs = [c for c in nested_unet.convs(model, (512, 512)) if c.k == 3]
    c3 = bounds.qconv_bound_ms(convs[0], 8)
    wgmma = sum(bounds.qconv_bound_ms(c, 8)[0] for c in convs[1:])
    assert c3[1] == "bytes" and round(c3[0], 5) == 0.02191
    assert round(wgmma, 5) == 0.51814


def test_nlm_pairs_and_bound():
    pairs, updates = bounds.nlm_weight_pairs((8, 448, 800), 21)
    assert updates == 8 * 448 * 800 * 440
    assert pairs == 642267120
    ms, by, parts = bounds.nlm_bound_ms((8, 448, 800), 21, 132, 1980e6)
    assert by == "operations" and max(parts, key=parts.get) == "exp"
    assert round(ms, 5) == 0.15359


def test_nlm_pairs_count_each_inside_pair_once():
    """On a plane whose every offset stays inside, each unordered pair is
    one weight: half of the updates."""
    pairs, updates = bounds.nlm_weight_pairs((1, 3, 3), 1)
    assert (pairs, updates) == (0, 0)
    pairs, updates = bounds.nlm_weight_pairs((2, 30, 40), 3)
    assert updates // 2 <= pairs <= updates
