"""chip_smoke.phase_mesh end to end on the CPU at a small size (gloo, one
rank; plain versions, so zero launch counts; the card's synchronize
stubbed): the sharded steps, the train step and the server over the mesh
against the same work without one, bit for bit."""
import torch

import chip_smoke as cs
from tests.torch_threads import one_intra_op_thread  # noqa: F401


def test_chip_smoke_mesh_phase_runs_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    expect = {p: dict.fromkeys(c, 0) for p, c in cs.expected_launches().items()}
    rec = cs.phase_mesh(expect, H=224, W=400, device="cpu", b=2, train_size=32, train_b=2,
                        time_b=2, streams=2, frames_per_stream=3, reps=1, repeats=1,
                        model_size=64)
    assert rec["world_size"] == 1 and rec["mesh_shape"] == [1, 1]
    assert set(rec["steps"]) == {"two_stage", "two_stage_int8"}
    assert "quality.mad" in rec["steps"]["two_stage"]["fields"]
    assert rec["train"]["n_tensors"] > 100 and len(rec["train"]["metrics"]) == 2
    assert rec["server"]["frames"] == 6 and rec["server"]["launches_per_batch"] == {}
