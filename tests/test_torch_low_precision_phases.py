"""chip_smoke.py's bf16/int8 and qconv phases rehearsed on the CPU. Moved
unchanged from tests/test_torch_pipeline.py, so that the quick lane's
workers spread the slow rehearsal."""
import time

import torch

from unet_tpu_torch.pipeline import presets
from tests.torch_threads import one_intra_op_thread  # noqa: F401


def test_chip_smoke_low_precision_phases_run_on_the_cpu(monkeypatch):
    """chip_smoke.py's bf16/int8 phase and qconv phase, end to end on the
    CPU at a small size (plain versions, so no kernel launches and zero
    counts; the card's timers replaced by host clocks): the rehearsal of the
    chip run's new code."""
    import chip_smoke as cs

    def host_ms(fn, reps=1, warmup=0):
        t = time.perf_counter()
        fn()
        return (time.perf_counter() - t) * 1e3

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "_time_ms", host_ms)
    monkeypatch.setattr(cs, "_time_step", lambda step, frames, reps=1: host_ms(lambda: step(frames)))
    monkeypatch.setattr(cs, "_profile_step", lambda *a, **k: None)
    monkeypatch.setattr(cs, "_device_ops", lambda fn: 0)
    zero = {"cc_propagate": 0, "cc_propagate_cluster": 0, "cc_propagate_global": 0,
            "cc_propagate_cluster8": 0, "cc_propagate_cluster16": 0,
            "nlm": 0, "qconv": 0, "qconv_wgmma": 0, "qconv_sync": 0, "qconv_c3": 0}
    expect = {"two_stage_bf16": zero, "two_stage_int8": zero}
    counts = {}
    cfg = presets.two_stage().replace_in("preprocess", model_size=(32, 32))
    timings, q_rec, checks, ups = cs.phase_low_precision(cfg, expect, counts, 1.0, "cpu", 112,
                                                         200, device="cpu")
    assert set(timings) == set(counts) == set(ups) == {"two_stage_bf16", "two_stage_int8"}
    for path, up in ups.items():
        assert up["calls_per_forward"] == 4
        assert [c["shape"][1] for c in up["per_call"]] == [2, 4, 8, 16]
        assert up["sum_ms"] == sum(c["ms"] for c in up["per_call"]) > 0
    assert checks["int8_taps_bit_identical_card_vs_cpu"] == 19
    assert len(q_rec) == 18
    per_route, max_err = cs.phase_qconv(q_rec, device="cpu")
    assert max_err == 0
    assert {r: len(v) for r, v in per_route.items()} == {"wgmma": 17, "c3": 1, "sync": 0}
    assert per_route["c3"][0]["site"] == "two_stage_int8/conv0_0.conv1"
    assert per_route["c3"][0]["f32_epilogue_ms"] > 0
    assert all(p["library_ms"] > 0 and p["sync_ms"] > 0 for v in per_route.values() for p in v)
