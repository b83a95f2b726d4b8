"""chip_smoke.phase_export rehearsed on the CPU at a small size: every
artifact of the card's phase (two_stage fp32 with a symbolic batch, int8,
enhanced, production, one traced on the CPU for the card), the bare
forward and `cli tools render-predictions`; each artifact equal to its
live step and calling the custom ops as the card's launch counts expect.
On the card the two_stage fp32 artifact comes from `cli export`, which
takes the preset's own 512² model input; here, at 32², from
`export_pipeline` (tests/test_torch_export.py runs the CLI)."""
import torch

import chip_smoke as cs
from tests.torch_threads import one_intra_op_thread  # noqa: F401


def test_chip_smoke_export_phase_runs_on_the_cpu(monkeypatch):
    """The card's synchronize stubbed; no kernel launches, so every count
    is 0, and the programs' graphs hold the calls that launch on the card:
    B1 twice a two_stage batch (7 in production), qconv 18 times in int8,
    nlm 3 times in enhanced."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    zero = {k: 0 for k in cs._read_counts()}
    rec = cs.phase_export({p: zero for p in ("two_stage", "two_stage_int8", "enhanced",
                                             "production")},
                          H=112, W=200, device="cpu", b=3, b_small=2, model_size=32)
    ops = {k: r["graph_ops"] for k, r in rec["pipelines"].items()}
    assert ops == {
        "two_stage_fp32_cli": {"cc_propagate": 2},
        "two_stage_int8": {"cc_propagate": 2, "qconv": 18},
        "enhanced_fp32": {"cc_propagate": 2, "nlm": 3},
        "production_colour": {"cc_propagate": 7},
        "two_stage_colour_traced_on_cpu": {"cc_propagate": 2}}, ops
    assert set(rec["pipelines"]["two_stage_fp32_cli"]["runs"]) == {2, 3}
    assert all(r["bytes"] > 0 for r in rec["pipelines"].values())
    assert rec["model"]["max_abs_err"] <= 1e-5
    assert rec["render_predictions"] == [f"scene_{i:03d}.png" for i in range(3)]
