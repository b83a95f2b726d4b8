"""chip_smoke.phase_spatial_zoo rehearsed on the CPU: every run of the card's
phase (the eight zoo archs' two_stage over 1 x 2 in fp32 and bf16,
shufflenet over 1 x 4, the train step of lightweight:custom and
simple_unet over 1 x 2) at the smallest model input each arch's stripes
allow, the card's synchronize stubbed; the record's keys as on the card."""
import torch

import chip_smoke
from tests.torch_threads import one_intra_op_thread  # noqa: F401


def test_chip_smoke_spatial_zoo_phase_runs_on_the_cpu(monkeypatch):
    """No flips and equal class maps. The 1 x 2 runs stripe the slice's two
    frames: bit for bit here (no kernel launches: the plain versions). The
    1 x 4 run stripes one frame, and at batch 1 the CPU's conv sums some
    slabs in another order (ROADMAP C8,
    tests/test_torch_spatial_zoo.py::test_cpu_conv_sums_a_slab_in_another_order_at_batch_1):
    its logits within 1e-5 of their largest value. Three of its ranks hold
    no frame. The train runs within the phase's gates but the fp32
    gradient's, which is the card's at 512^2
    (tests/test_torch_spatial_train.py::test_chip_smoke_spatial_train_phase_runs_on_the_cpu)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    rec = chip_smoke.phase_spatial_zoo(device="cpu", H=32, W=48, b=2, model_size=16,
                                       train_size=32, reps=1, grad_gate=float("inf"))
    assert sorted(rec) == ["backend", "device", "runs", "se_plane_bytes_per_frame", "seconds",
                           "spawn_overhead_s", "train"]
    archs = chip_smoke.MODEL_ARCHS
    assert sorted(rec["runs"]) == sorted(
        [f"{a} 1x2" for a in archs] + [f"{a}_bf16 1x2" for a in archs]
        + ["lightweight:shufflenet_v2_x1_0 b=1 1x4"])
    for key, r in rec["runs"].items():
        assert r["flips"] == 0 and r["class_map_diff"] == 0, key
        gate = 1e-5 * r["logits_max_abs"] if "1x4" in key else 0.0
        assert r["logits_max_abs_diff"] <= gate, (key, r["logits_max_abs_diff"], gate)
        assert len(r["per_rank"]) == (4 if "1x4" in key else 2), key
    assert [row["frames"] for row in rec["runs"][
        "lightweight:shufflenet_v2_x1_0 b=1 1x4"]["per_rank"]] == [1, 0, 0, 0]
    assert sorted(rec["train"]) == ["lightweight:custom fp32 1x2", "simple_unet fp32 1x2"]
    for key, r in rec["train"].items():
        assert r["stats"] <= chip_smoke.TRAIN_STATS_ATOL and r["loss_rel"] <= 1e-4, key
        assert set(r["collective_ms"]) == {"all_gather (transport)", "all_reduce"}, key
    se = rec["se_plane_bytes_per_frame"]
    assert sorted(se) == ["lightweight:mobilenet_v3_large", "lightweight:mobilenet_v3_small"]
    assert all(v["float32"] == 2 * v["bfloat16"] > 0 for v in se.values())
