"""The port's sharded inspection step (parallel.shard_pipeline_step) over 2
gloo ranks on the CPU: `two_stage` with the colour->class model, with and
without the quality statistics, against `stages.build_step` on the same
global frames (class maps and px counts equal, the statistics within 1e-4
relative, the first frame of each slice diffed against the frame before
it, or against the previous batch's last frame) and against the JAX
package's shard_pipeline_step on a 2-device mesh; a batch that the data
axis does not divide raises."""
import jax
import jax.numpy as jnp
import numpy as np

from chip_smoke import ColourClassModel, synthetic_frames
from tests import torch_dist as td
from tests.torch_threads import one_intra_op_thread  # noqa: F401
from unet_tpu import parallel as jparallel
from unet_tpu.pipeline import presets as jpresets
from unet_tpu.pipeline import stages as jstages
from unet_tpu_torch.pipeline import stages

H, W = 224, 400
INTS = ("class_map", "cable_px", "tape_px", "burr_px")


class _JColourClassModel:
    """JAX twin of chip_smoke.ColourClassModel (NHWC)."""

    def apply(self, variables, x, train=False):
        cable = (x[..., 0] > 0.6) & (x[..., 2] > 0.6)
        tape = (x[..., 0] > 0.6) & (x[..., 2] < 0.4) & ~cable
        cls = jnp.where(tape, 2, jnp.where(cable, 1, 0))
        return jax.nn.one_hot(cls, 3) * 10.0


def _jax_sharded(frames, quality: bool) -> dict:
    cfg = jpresets.two_stage().replace_in("preprocess", model_size=(64, 64))
    if quality:
        cfg = cfg.replace_in("inspect", quality_stats=True)
    mesh = jparallel.make_mesh(n_data=2, n_spatial=1, devices=jax.devices()[:2])
    step = jparallel.shard_pipeline_step(
        lambda v, f: jstages.run_pipeline(v, f, model=_JColourClassModel(), cfg=cfg), mesh)
    out = step({}, jnp.asarray(frames))
    d = {k: np.asarray(getattr(out, k)) for k in INTS}
    if out.quality is not None:
        d.update({f"quality.{k}": np.asarray(getattr(out.quality, k))
                  for k in out.quality._fields})
    return d


def _assert_same(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for k, w in want.items():
        if k in INTS:
            assert got[k].dtype == w.dtype and np.array_equal(got[k], w), (what, k)
        else:
            np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-6, err_msg=f"{what} {k}")


def test_sharded_two_stage_matches_build_step_and_jax(tmp_path):
    frames = synthetic_frames(4, H, W, seed=3, patch=14)
    prev = synthetic_frames(1, H, W, seed=9, patch=14)
    calls = [(frames, None, False), (frames, None, True), (frames, prev, True),
             (frames[:3], None, False)]
    ranks = td.run_ranks(tmp_path, 2, "pipeline_ranks", calls)
    for i, (f, p, quality) in enumerate(calls[:3]):
        two = ranks[0][i]
        _assert_same(ranks[1][i], two, f"call {i}: rank 1 vs rank 0")
        one = td.outputs_numpy(stages.build_step(ColourClassModel(), td.pipeline_cfg(quality),
                                                 device="cpu")(f, p))
        _assert_same(two, one, f"call {i}: 2 ranks vs build_step")
        assert two["cable_px"].min() > 0 and two["burr_px"].sum() > 0
        if quality:
            # slice 1's first frame diffs against frame 1, not itself;
            # slice 0's against the previous batch's last frame where given
            assert two["quality.mad"][2] > 0
            assert (two["quality.mad"][0] > 0) == (p is not None)
        if p is None:
            _assert_same(two, _jax_sharded(f, quality), f"call {i}: 2 ranks vs JAX")
    for r in ranks:
        assert "does not divide over the data axis of 2 ranks" in r[3]["error"]
