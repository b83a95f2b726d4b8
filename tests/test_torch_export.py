"""The port's export (unet_tpu_torch.export: torch.export programs in a
.pt2 file) against its live step and the JAX package's
(unet_tpu/export/aot.py, tests/test_export.py): the fused pipeline step
with a symbolic batch served at two batch sizes from one artifact, bit for
bit; a geometry config's diameters; int8 and `enhanced` configs; the bare
forward's logits; and the three custom ops that carry the hand-written
kernels (`torch.library.opcheck`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ColourClassModel, synthetic_frames
from conftest import synthetic_cable_frame
from unet_tpu.models import NestedUNet as JNestedUNet
from unet_tpu.pipeline import GeometryCfg as JGeometryCfg
from unet_tpu.pipeline import PipelineCfg as JPipelineCfg
from unet_tpu.pipeline import PreprocessCfg as JPreprocessCfg
from unet_tpu.pipeline import ROI as JROI
from unet_tpu.pipeline import stages as jstages
from unet_tpu_torch.export import AotRunner, export_model, export_pipeline
from unet_tpu_torch.models import NestedUNet
from unet_tpu_torch.models.convert import state_dict_from_flax
from unet_tpu_torch.ops import cc, cc_kernels, nlm_kernels, qconv_kernels
from unet_tpu_torch.pipeline import GeometryCfg, PipelineCfg, PreprocessCfg, ROI, presets, stages
from tests.torch_threads import one_intra_op_thread  # noqa: F401

FIELDS = ("class_map", "cable_px", "tape_px", "burr_px")


def _models(size=32):
    """The JAX NestedUNet at PRNGKey(0) and the port's with its weights."""
    jm = JNestedUNet(num_classes=3, deep_supervision=True)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                                 jnp.zeros((1, size, size, 3)), train=False))
    tm = NestedUNet(num_classes=3, deep_supervision=False)   # flax's eval has no heads
    tm.load_state_dict(state_dict_from_flax(variables))
    return jm, variables, tm.eval()


def _frames(b, h=96, w=128, **kw):
    return np.stack([synthetic_cable_frame(h=h, w=w, seed=10 + b + i, **kw)[0]
                     for i in range(b)])


def _assert_equal(got: dict, want, fields=FIELDS):
    for k in fields:
        w = getattr(want, k).cpu().numpy() if isinstance(getattr(want, k), torch.Tensor) \
            else np.asarray(getattr(want, k))
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k


def test_pipeline_export_roundtrip_matches_live_and_jax(tmp_path):
    """tests/test_export.py's round trip: model 32², frames 96x128, the
    ROI, the fast forward; one artifact with a symbolic batch serves b=2
    and b=3, equal to the live step, whose class map and counts equal the
    JAX package's step."""
    jm, variables, tm = _models()
    jcfg = JPipelineCfg(preprocess=JPreprocessCfg(model_size=(32, 32)),
                        roi=JROI(16, 0, 112, 96, space=(128, 96))
                        ).replace_in("segment", fast_forward=True)
    cfg = PipelineCfg(preprocess=PreprocessCfg(model_size=(32, 32)),
                      roi=ROI(16, 0, 112, 96, space=(128, 96))
                      ).replace_in("segment", fast_forward=True)
    path = export_pipeline(None, str(tmp_path / "pipe.pt2"), cfg=cfg, model=tm, batch=None,
                           frame_hw=(96, 128), device="cpu")
    runner = AotRunner(path, device="cpu")
    live = stages.build_step(tm, cfg, device="cpu")
    jlive = jstages.build_step(jm, jcfg)
    for b in (2, 3):
        frames = _frames(b)
        got = runner.run_tree(frames)
        assert got["class_map"].shape == (b, 96, 128)
        assert set(got) == set(FIELDS)
        want = live(frames)
        _assert_equal(got, want)
        _assert_equal({k: getattr(want, k).numpy() for k in FIELDS},
                      jlive(variables, jnp.asarray(frames)))


def test_pipeline_export_burrs_launch_the_ops(tmp_path):
    """The colour->class two_stage step, whose frames hold cable, tape and
    burrs: the artifact equals the live step at b=1 and b=3, and calls the
    cc_propagate op twice a batch, as the live step does."""
    cfg = presets.two_stage().replace_in("preprocess", model_size=(64, 64))
    path = export_pipeline(None, str(tmp_path / "colour.pt2"), cfg=cfg,
                           model=ColourClassModel(), batch=None, frame_hw=(224, 400),
                           device="cpu")
    runner = AotRunner(path, device="cpu")
    calls = [n for n in runner.program.graph.nodes
             if n.op == "call_function" and "unet_tpu_torch" in str(n.target)]
    assert [str(n.target) for n in calls] == ["unet_tpu_torch.cc_propagate.default"] * 2
    live = stages.build_step(ColourClassModel(), cfg, device="cpu")
    for b in (1, 3):
        frames = synthetic_frames(b, 224, 400, seed=b, patch=14)
        got = runner.run_tree(frames)
        _assert_equal(got, live(frames))
        assert got["burr_px"].sum() > 0, "no burr: stage 2 untested"


def test_pipeline_export_geometry_matches_jax(tmp_path):
    """tests/test_export.py's geometry export: its DiameterMetrics subtree
    within rtol 1e-5 of the JAX step's, and equal to the live step's."""
    jm, variables, tm = _models()
    jcfg = JPipelineCfg(preprocess=JPreprocessCfg(model_size=(32, 32)),
                        geometry=JGeometryCfg(enabled=True))
    cfg = PipelineCfg(preprocess=PreprocessCfg(model_size=(32, 32)),
                      geometry=GeometryCfg(enabled=True))
    path = export_pipeline(None, str(tmp_path / "geo.pt2"), cfg=cfg, model=tm, batch=2,
                           frame_hw=(64, 64), device="cpu")
    frames = np.stack([synthetic_cable_frame(h=64, w=64, cable_x=(26, 38), seed=s)[0]
                       for s in range(2)])
    got = AotRunner(path, device="cpu").run_tree(frames)
    want = jstages.build_step(jm, jcfg)(variables, jnp.asarray(frames))
    live = stages.build_step(tm, cfg, device="cpu")(frames)
    for k in ("dc_px", "dt_px"):
        np.testing.assert_allclose(got["diameters"][k], np.asarray(getattr(want.diameters, k)),
                                   rtol=1e-5)
    for k, v in live.diameters._asdict().items():
        assert np.array_equal(got["diameters"][k], v.numpy()), k


def test_export_model_logits_match_the_live_forward(tmp_path):
    _, _, tm = _models()
    path = export_model(None, str(tmp_path / "model.pt2"), model=tm, input_size=32,
                        batch=None, device="cpu")
    runner = AotRunner(path, device="cpu")
    x = np.random.default_rng(0).random((3, 32, 32, 3), dtype=np.float32)
    got = runner.run(x)
    with torch.no_grad():
        want = stages.forward_logits(tm, torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (3, 32, 32, 3)
    np.testing.assert_allclose(got, want.permute(0, 2, 3, 1).numpy(), atol=1e-5, rtol=1e-5)


def _op_inputs():
    g = np.random.default_rng(0)
    fg = torch.from_numpy(g.random((2, 12, 20)) > 0.4)
    x = torch.from_numpy(g.random((2, 16, 18)).astype(np.float32) * 255)
    src = [torch.from_numpy(g.integers(-5, 6, (1, 6, 7, 32)).astype(np.int8)) for _ in range(2)]
    wq = torch.from_numpy(g.integers(-5, 6, (32, 3, 3, 64)).astype(np.int8))
    mult = torch.full((32,), 0.01, dtype=torch.bfloat16)
    return {"cc_propagate": (cc._bbox_seed_state(fg), fg, 4, 64, 8),
            "nlm": (x, 10.0, 3, 5),
            "qconv": (src, wq, mult, torch.zeros(32, dtype=torch.bfloat16))}


@pytest.mark.parametrize("op", ["cc_propagate", "nlm", "qconv"])
def test_custom_op_opcheck(op):
    """Schema, fake implementation, autograd registration and AOT dispatch
    with dynamic shapes, on CPU inputs; the op equals the plain version and
    returns a new tensor."""
    args = _op_inputs()[op]
    result = torch.library.opcheck(getattr(torch.ops.unet_tpu_torch, op).default, args)
    assert set(result.values()) == {"SUCCESS"}, result
    out = getattr(torch.ops.unet_tpu_torch, op)(*args)
    plain = {"cc_propagate": lambda s, f, p, m, c: cc_kernels.propagate_plain(
                 s, f, pool_iters=p, max_iters=m, connectivity=c),
             "nlm": nlm_kernels.nlm_plain,
             "qconv": lambda x, w, m, b: qconv_kernels.qconv_plain(tuple(x), w, m, b)}[op]
    assert torch.equal(out, plain(*args))
    assert all(out.data_ptr() != a.data_ptr() for a in args if isinstance(a, torch.Tensor))



def test_cli_export_pipeline_traces_on_the_cpu(tmp_path):
    """`cli export --pipeline two_stage --device cpu` of a seeded .pth: the
    program of the preset's fast forward (its weights constants, no
    parameters) calls cc_propagate twice. It is not run here (512² on the
    CPU); chip_smoke.phase_export runs it on the card."""
    import chip_smoke as cs
    from unet_tpu_torch.cli.main import main

    torch.save(cs.seeded_nested_unet().state_dict(), tmp_path / "m.pth")
    assert main(["export", "--model", str(tmp_path / "m.pth"), "--output",
                 str(tmp_path / "p.pt2"), "--pipeline", "two_stage", "--frame-hw", "96,160",
                 "--device", "cpu"]) == 0
    runner = AotRunner(str(tmp_path / "p.pt2"), device="cpu")
    assert cs._graph_ops(runner.program) == {"cc_propagate": 2}
    assert not runner.program.state_dict


@pytest.mark.parametrize("preset", ["robust", "roi_first", "optimized", "high_res_roi"])
def test_other_presets_export_and_serve_any_batch(tmp_path, preset):
    """Presets off the main path through `export_pipeline` with the
    colour->class models at 32²: the letterbox and shape postprocess
    (robust), the dynamic ROI crop (roi_first), the quality statistics and
    defect components (optimized), the 2448x2048 rotate (high_res_roi, cut
    to 153x128): one artifact serves b=1 and b=3, equal to the live step in
    every output."""
    import chip_smoke as cs

    cfg = presets.get_preset(preset).replace_in("preprocess", model_size=(32, 32))
    n = cfg.segment.num_classes
    model = ColourClassModel() if n == 3 else cs.ColourDefectModel(n)
    h, w = (128, 153) if preset == "high_res_roi" else (112, 200)
    frames = synthetic_frames(3, h, w, seed=1)
    path = export_pipeline(None, str(tmp_path / f"{preset}.pt2"), cfg=cfg, model=model,
                           frame_hw=(h, w), device="cpu")
    runner = AotRunner(path, device="cpu")
    live = stages.build_step(model, cfg, device="cpu")
    for b in (1, 3):
        got, want = runner.run_tree(frames[:b]), live(frames[:b])
        for part, v in want._asdict().items():
            if v is None:
                assert part not in got
            elif isinstance(v, torch.Tensor):
                assert np.array_equal(got[part], v.numpy()), part
            else:
                for f, t in v._asdict().items():
                    assert np.array_equal(got[part][f], t.numpy()), (part, f)


@pytest.mark.parametrize("start", ["both_apis", "conv_ieee"])
def test_export_whatever_the_cudnn_flags(tmp_path, start):
    """torch.export reads cuDNN's legacy TF32 flag, which raises once the
    flags were set through the legacy and the per-operator API (as
    tests/test_torch_pipeline.py's flag test leaves a process) or when only
    the conv precision was set; the export runs all the same and leaves the
    per-operator precisions as it found them."""
    b = torch.backends
    saved = (b.cudnn.conv.fp32_precision, b.cudnn.rnn.fp32_precision, b.cudnn.fp32_precision,
             b.cuda.matmul.fp32_precision, b.fp32_precision)
    try:
        if start == "both_apis":
            b.cudnn.allow_tf32 = False
            (b.cudnn.conv.fp32_precision, b.cudnn.rnn.fp32_precision, b.cudnn.fp32_precision,
             b.cuda.matmul.fp32_precision, b.fp32_precision) = saved
        else:
            b.cudnn.conv.fp32_precision = "ieee"
        before = (b.cudnn.conv.fp32_precision, b.cudnn.rnn.fp32_precision)
        _, _, tm = _models()
        export_model(None, str(tmp_path / "m.pt2"), model=tm, input_size=32, device="cpu")
        assert (b.cudnn.conv.fp32_precision, b.cudnn.rnn.fp32_precision) == before
    finally:
        (b.cudnn.conv.fp32_precision, b.cudnn.rnn.fp32_precision, b.cudnn.fp32_precision,
         b.cuda.matmul.fp32_precision, b.fp32_precision) = saved
