"""A whole run on the CPU at a tiny size, the card's look skipped: sound,
`correct` comes out true; with the timed path broken underneath, false,
once for each fault a cell of this benchmark can have (one card, no
training state): half of each batch left out, an answer altered where it
is produced (a count, a block of the map, the burr mask flooding the
cable's band). And the control, the reference one precision
below the cell's put in the program's place, fails the cell's check."""
import json

import pytest
import torch

from benchmark import cell, check, control, spec
from benchmark.reference import morph
from benchmark.tests.conftest import TINY_LIMITS, tiny_root

CELLS = ["two_stage-int8-chunk96", "two_stage-int8-live8"]

SEED = 2 ** 31 + 99


def _half_left_out(step, pc):
    """Each batch's second half gets the first half's outputs: the work of
    half the batch is never done."""
    def halve(t, axis):
        t = t.clone()
        h = t.shape[axis] // 2
        t.narrow(axis, t.shape[axis] - h, h).copy_(t.narrow(axis, 0, h))
        return t

    def broken(frames):
        out = step(frames)
        cm = out.class_map
        return out._replace(class_map=halve(cm, cm.ndim - 3),
                            **{k: halve(getattr(out, k), cm.ndim - 3)
                               for k in ("cable_px", "tape_px", "burr_px")})
    return broken


def _count_altered(step, pc):
    def broken(frames):
        out = step(frames)
        return out._replace(burr_px=out.burr_px + 1)
    return broken


def _map_altered(step, pc):
    """A block of background in every frame's ROI called cable, its count
    with it: the answer changed where it is made, consistently."""
    def broken(frames):
        out = step(frames)
        cm = out.class_map.clone()
        cm[..., 20:40, 40:60] = 1
        return out._replace(class_map=cm,
                            cable_px=(cm == 1).sum(dim=(-2, -1), dtype=torch.int32))
    return broken


def _burr_flooded(step, pc):
    """The burr mask is the whole outer band of the cable, counted so."""
    def broken(frames):
        out = step(frames)
        cm = out.class_map
        band = morph.outer_band(cm == 1, morph.ellipse_kernel(pc["burr"]["band_px"]))
        cm = torch.where(band, 3, cm).to(torch.uint8)
        return out._replace(class_map=cm, burr_px=(cm == 3).sum(dim=(-2, -1), dtype=torch.int32))
    return broken


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("faults"), TINY_LIMITS)


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_sound_run_is_correct(root, cell_name):
    out = cell.run(spec.load(root, cell_name), SEED, 0.3, False, "cpu")
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("fault", [_half_left_out, _count_altered, _map_altered, _burr_flooded])
@pytest.mark.parametrize("cell_name", CELLS)
def test_a_broken_timed_path_is_not_correct(root, cell_name, fault):
    sp = spec.load(root, cell_name)
    wrap = lambda step: fault(step, sp.config["pipeline"])
    out = cell.run(sp, SEED, 0.3, False, "cpu", wrap_step=wrap)
    assert out["correct"] is False, out["checks"]


def _cell_limits(name):
    from benchmark.tests.conftest import REPO
    return json.loads((REPO / f"benchmark/workloads/{name}.json").read_text())["limits"]


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_int4_control_fails_the_int8_cells_check(root, cell_name):
    """At the tiny size, the reference one precision below (int4 forward,
    bfloat16 planes) in the program's place reads above the int8 cell's own
    limits."""
    sp = spec.load(root, cell_name)
    s = cell.prepare(sp, SEED, torch.device("cpu"))
    sample, _ = control.program_numbers(sp, s, SEED, torch.device("cpu"))
    numbers = control.control_numbers(sp, s, sample, torch.device("cpu"))
    assert not check.verdict(numbers, _cell_limits(cell_name)), numbers
