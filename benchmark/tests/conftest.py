"""Shared fixtures of the benchmark's CPU tests: a checkout-like root that
holds the benchmark's files with every configuration cut to a tiny size
(a 64x64 model input, 64x112 frames) and every traffic mix to a few
frames, so that a whole run goes through on the CPU in seconds."""
import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
TINY_LIMITS = {"regret_max": 1.5, "regret_mean": 0.5, "flip_share": 0.15, "burr_diff": 0.5,
               "count_diff": 0.0, "roi_px": 0.0, "missing": 0.0}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_root(dst: Path, limits=None) -> Path:
    """A copy of BENCHMARK.json and the benchmark's data files under `dst`,
    cut to a tiny size; `limits`, where given, replace every cell's."""
    for d in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(REPO / "benchmark" / d, dst / "benchmark" / d)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    for c in bench["configs"]:
        p = dst / c["file"]
        d = json.loads(p.read_text())
        d["pipeline"]["preprocess"]["model_size"] = [64, 64]
        d["frame_hw"] = [64, 112]
        p.write_text(json.dumps(d))
    for p in (dst / "benchmark" / "traffic").glob("*.json"):
        d = json.loads(p.read_text())
        d.update(batch=2, chunks=2, trace_calls=2, warm_calls=1, distinct=min(d["distinct"], 2))
        d["judge"] = {"frames": d["batch"] * d.get("chunks", 1) if d["step"] == "chunked"
                      else d["batch"], "calls": 1}    # every frame of the first call
        p.write_text(json.dumps(d))
    if limits is not None:
        for p in (dst / "benchmark" / "workloads").glob("*.json"):
            d = json.loads(p.read_text())
            d["limits"] = dict(limits)
            p.write_text(json.dumps(d))
    return dst


@pytest.fixture
def tiny(tmp_path) -> Path:
    return tiny_root(tmp_path / "tiny", TINY_LIMITS)
