"""The port's config tree and presets equal the JAX package's."""
import dataclasses

import pytest

from unet_tpu.pipeline import config as jconfig
from unet_tpu.pipeline import presets as jpresets
from unet_tpu_torch.pipeline import config, presets


@pytest.mark.parametrize("name", sorted(jpresets.PRESETS))
def test_preset_equals_reference(name):
    assert set(presets.PRESETS) == set(jpresets.PRESETS)
    assert (dataclasses.asdict(presets.get_preset(name))
            == dataclasses.asdict(jpresets.get_preset(name)))


def test_defaults_replace_and_roi_scaling():
    assert dataclasses.asdict(config.PipelineCfg()) == dataclasses.asdict(jconfig.PipelineCfg())
    cfg = presets.two_stage().replace_in("segment", fast_forward=True).replace(batch=4)
    jcfg = jpresets.two_stage().replace_in("segment", fast_forward=True).replace(batch=4)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for wh in ((800, 448), (400, 224), (2448, 2048)):
        assert (dataclasses.asdict(config.ROI(140, 0, 270, 512).scaled(wh))
                == dataclasses.asdict(jconfig.ROI(140, 0, 270, 512).scaled(wh)))
