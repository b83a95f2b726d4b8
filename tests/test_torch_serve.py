"""The port's MultiStreamServer (unet_tpu_torch.serve.multistream) against
the JAX package's, on the wrap_uniformity preset at model 32x32 with the
colour->class model: every (stream, frame) gives the same result in both,
each frame is processed exactly once, with streams of unequal length and a
starved stream."""
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import ColourClassModel, wrap_scenes
from unet_tpu.pipeline import presets as jpresets
from unet_tpu.serve import MultiStreamServer as JMultiStreamServer
from unet_tpu_torch.pipeline import presets
from unet_tpu_torch.serve import MultiStreamServer, StreamResult

H, W = 72, 96


class _JColourClassModel:
    """JAX twin of chip_smoke.ColourClassModel (NHWC)."""

    def apply(self, variables, x, train=False):
        cable = (x[..., 0] > 0.6) & (x[..., 2] > 0.6)
        tape = (x[..., 0] > 0.6) & (x[..., 2] < 0.4) & ~cable
        cls = jnp.where(tape, 2, jnp.where(cable, 1, 0))
        return jax.nn.one_hot(cls, 3) * 10.0


class FakeSource:
    """`n` wrap scenes, frame ids 1..n, optionally `delay` s apart."""

    def __init__(self, sid, n, delay=0.0):
        self.sid, self.n, self.delay = sid, n, delay

    def frames(self):
        for i in range(self.n):
            if self.delay:
                time.sleep(self.delay)
            yield i + 1, wrap_scenes(1, H, W, seed=100 * self.sid + i)[0]


def _cfg(mod):
    return mod.wrap_uniformity().replace_in("preprocess", model_size=(32, 32))


@pytest.fixture(scope="module")
def servers():
    """One server of each package, reused across serve() calls (the JAX
    step compiles once for its fixed batch of 3 slots)."""
    return (MultiStreamServer(ColourClassModel(), _cfg(presets), return_class_map=True,
                              starvation_timeout=0.005, device="cpu"),
            JMultiStreamServer(_JColourClassModel(), {}, _cfg(jpresets),
                               return_class_map=True, starvation_timeout=0.005))


def _by_key(results):
    out = {}
    for r in results:
        key = (r.stream_id, r.frame_id)
        assert key not in out, f"{key} processed twice"
        out[key] = r
    return out


@pytest.mark.parametrize("case", ["unequal lengths", "starved stream"])
def test_multistream_matches_the_jax_server(servers, case):
    def sources():
        if case == "unequal lengths":
            return [FakeSource(0, 5), FakeSource(1, 3), FakeSource(2, 4)]
        return [FakeSource(0, 6), FakeSource(1, 2), FakeSource(2, 4, delay=0.03)]

    server, jserver = servers
    shapes = []
    step = server.step
    server.step = lambda batch: (shapes.append(batch.shape), step(batch))[1]
    try:
        got, want = [], []
        summary = server.serve(sources(), got.append)
    finally:
        server.step = step
    jsummary = jserver.serve(sources(), want.append)
    lengths = [s.n for s in sources()]
    assert summary["frames"] == jsummary["frames"] == sum(lengths)
    assert set(shapes) == {(3, H, W, 3)}      # one fixed slot per stream
    got, want = _by_key(got), _by_key(want)
    assert set(got) == set(want) == {(s, f + 1) for s, n in enumerate(lengths)
                                     for f in range(n)}
    for key, g in got.items():
        w = want[key]
        assert isinstance(g, StreamResult)
        assert (g.cable_px, g.tape_px, g.burr_px) == (w.cable_px, w.tape_px, w.burr_px), key
        assert np.array_equal(g.class_map, np.asarray(w.class_map)), key
        np.testing.assert_allclose([g.dc_px, g.dt_px], [w.dc_px, w.dt_px], atol=1e-4, rtol=0)
        assert g.dt_px > g.dc_px > 0, key
    order = {}
    for key in sorted(got):
        order.setdefault(key[0], []).append(key[1])
    assert order == {s: list(range(1, n + 1)) for s, n in enumerate(lengths)}


def test_multistream_sink_failure_and_max_batches_reap_readers(servers):
    """A sink that raises and a max_batches cut both stop the loop and
    reap every reader, also one blocked on a full queue."""
    server = servers[0]

    def sink(r):
        raise RuntimeError("sink failed")

    with pytest.raises(RuntimeError, match="sink failed"):
        server.serve([FakeSource(0, 40), FakeSource(1, 40), FakeSource(2, 40)], sink)
    assert not any(t.is_alive() for t in server._threads)

    got = []
    summary = server.serve([FakeSource(0, 40), FakeSource(1, 40), FakeSource(2, 40)],
                           got.append, max_batches=2)
    # a reader that has not delivered within starvation_timeout leaves its
    # slot padded, so a batch holds 1 to 3 fresh frames
    assert summary["batches"] == 2 and 2 <= summary["frames"] == len(_by_key(got)) <= 6
    assert not any(t.is_alive() for t in server._threads)


def test_multistream_refuses_a_mesh_and_cuda_without_a_card():
    with pytest.raises(NotImplementedError, match="A15"):
        MultiStreamServer(ColourClassModel(), _cfg(presets), mesh=object(), device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiStreamServer(ColourClassModel(), _cfg(presets))


def test_chip_smoke_geometry_phases_run_on_the_cpu(monkeypatch):
    """chip_smoke.py's geometry phases end to end on the CPU at a small size
    (plain versions, so zero launch counts; the card's synchronize
    stubbed): the colour runs held against the CPU step, B1's sites named
    by caller, and the server at two stream counts."""
    import chip_smoke as cs

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    zero = {k: 0 for k in ("cc_propagate", "cc_propagate_cluster", "cc_propagate_global",
                           "cc_propagate_cluster8", "cc_propagate_cluster16", "nlm", "qconv",
                           "qconv_wgmma", "qconv_sync", "qconv_c3")}
    cfgs = {"wrap_uniformity": presets.wrap_uniformity(),
            "production": presets.production(),
            "three_class_full": presets.three_class_full()}
    cfgs = {p: c.replace_in("preprocess", model_size=(64, 64) if p == "wrap_uniformity"
                            else (128, 128)) for p, c in cfgs.items()}
    rec, counts, checks, timings = cs.phase_geometry_paths(cfgs, {p: zero for p in cfgs},
                                                           96, 160, device="cpu", reps=1)
    assert set(counts) == set(cfgs)
    assert all(v == 0.0 for v in checks.values())
    assert set(timings) == set(cfgs) and all(
        len(t[8]["ms_runs"]) == len(t[8]["without_geometry_ms_runs"]) == 2
        for t in timings.values())
    assert {k: tuple(v[0].shape) for k, v in rec.items()} == {
        "wrap_uniformity/label 1 (largest_component)": (8, 1, 64, 64),
        "wrap_uniformity/label 2 (largest_component)": (8, 1, 64, 64),
        "production/hysteresis": (8, 1, 96, 128),    # the burr crop
        "production/cc_filter": (8, 4, 96, 128),
        "production/label 1 (largest_component)": (8, 1, 96, 160),
        "production/label 2 (largest_component)": (8, 1, 96, 160),
        "production/label 3 (analyze_defects)": (8, 1, 96, 160),
        "production/label 4 (analyze_defects)": (8, 1, 96, 160),
        "production/label 5 (count_components)": (8, 1, 96, 160),
        "three_class_full/label 1 (largest_component)": (8, 1, 96, 160),
        "three_class_full/label 2 (largest_component)": (8, 1, 96, 160)}
    assert all(kw == dict(pool_iters=16, max_iters=64, connectivity=8)
               for k, (_, _, kw) in rec.items() if "/label" in k)
    serve = cs.phase_serve(ColourClassModel(), cfgs["wrap_uniformity"], 96, 160,
                           "colour->class model", streams=(2, 3), frames_per_serve=6,
                           repeats=2, real_masks=True, device="cpu")
    assert {n: (r["frames"], r["launches"], len(r["frames_per_s_runs"]))
            for n, r in serve.items()} == {2: (6, zero, 2), 3: (6, zero, 2)}
