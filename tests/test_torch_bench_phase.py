"""chip_smoke.phase_bench end to end on the CPU at a small size (plain
versions, so zero launch counts; the card's synchronize stubbed): the
chunked step against per-batch steps bit for bit, the bench's (preset,
dtype) pairs against fp32, and the bench's first fixed point with its
kernel checks at that batch. The phase's model input is 128^2 (the bench point's 64^2): at 64^2 the 7-class
int8 forward's class maps agree 0.9934 with the fp32 step's on these
frames, under the phase's 0.995 gate (wrap_7class at its own 256^2 and
800x448, b=8, agrees 0.9972 on the CPU, whose int8 tensors equal the
card's)."""
import torch

import chip_smoke as cs
from tests.torch_threads import one_intra_op_thread  # noqa: F401
from unet_tpu_torch import bench


def test_chip_smoke_bench_phase_runs_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(bench, "MODEL_SIZE", (64, 64))
    monkeypatch.setattr(bench, "N_FRAMES", 1)
    monkeypatch.setattr(bench, "REPEATS", 1)
    expect = {p: dict.fromkeys(c, 0) for p, c in cs.expected_launches().items()}
    rec = cs.phase_bench(expect, H=112, W=200, device="cpu", b=2, chunk=2, high_res_b=1,
                         first_point=("chunked", 2, "int8"), check_b=1, model_size=128,
                         normalize_wh=(200, 112))
    assert set(rec["chunked"]) == {"two_stage_bf16", "two_stage_int8", "enhanced_bf16"}
    assert all(r["tensors"] >= 4 for r in rec["chunked"].values())
    assert set(rec["pairs"]) == {f"{n}_{d}" for n, d in cs.BENCH_PAIRS}
    assert all(r["agreement_vs_fp32"] >= cs.BENCH_AGREEMENT for r in rec["pairs"].values())
    assert rec["point"]["calls"] == 5 and rec["point"]["fps"] > 0
    assert rec["b96_checks"]["qconv_sites"] == 18 and len(rec["b96_checks"]["cc_sites"]) == 2
    assert rec["b96_checks"]["nlm_planes"] == [2, 112, 200]
    assert rec["b96_checks"]["frames_checked"] == 1
