"""The train and eval steps of the two zoo models whose logits keep the
input's size, lightweight:custom and simple_unet, on the spatial axis of
the port's mesh, on gloo ranks on the CPU: each world (2 and 4 ranks) is
spawned once (`tests/torch_dist.spatial_train_ranks`) and runs every case:
  * two micro-steps (accumulation 2) of `make_train_step` on
    lightweight:custom (deep supervision, 3class_advanced's loss) and
    simple_unet (the inspection recipe's combined loss) over 1 x 2 at 48^2
    (stripes of 32 and 16 rows) and 2 x 2 at 32^2 against the one-process
    step on the global batch, and the eval's confusion matrix on it
  * lightweight:custom in bf16 over 1 x 2
  * `train_model(TrainRunCfg(n_spatial=2))` with the inspection recipe's
    model, loss and optimizer against one process

The gates are tests/test_torch_spatial_train.py's: in float64 every metric,
the per-sample losses, the BN statistics and the gradient within EXACT_GATE
of the one-process step; in float32 the loss and parts 1e-4 relative, grad
norm 1e-3, BN statistics 1e-5, the confusion matrix equal, the gradient
within GRAD_GUARD of the float64 one; bf16 within twice the one-process
step's own bf16-vs-fp32 distance. The six models whose logits are a quarter
or half of the input's side raise in these steps, as their one-process
steps do (tests/test_torch_spatial.py::test_spatial_refusals).
"""
import functools
import shutil

import numpy as np
import pytest
import torch

import chip_smoke as cs
from chip_smoke import write_split
from tests import torch_dist as td
from tests.test_torch_parallel import _assert_close, _grad_dist
from tests.test_torch_spatial_train import COMBINED, EXACT_GATE, F64, GRAD_GUARD, _case, _scalars
from tests.torch_threads import one_intra_op_thread  # noqa: F401

TRAIN = {"lightweight:custom": td.LOSS, "simple_unet": COMBINED}
LOOP = dict(epochs=2, batch=2)
STATS_REL = 1e-2    # the train loop's BN running statistics (see its test)


def _train_cases(shape, b, size, seed):
    cases = {}
    for i, (arch, loss) in enumerate(TRAIN.items()):
        for dtype in (torch.float32, torch.float64):
            name = f"{arch} {shape[0]}x{shape[1]}" + (F64 if dtype == torch.float64 else "")
            cases[name] = (shape, _case(loss, b, size, seed + i, arch=arch, dtype=dtype))
    return cases


TRAIN2 = dict(_train_cases((1, 2), 2, 48, 21), **{
    "lightweight:custom 1x2 bf16": ((1, 2), _case(td.LOSS, 2, 48, 21,
                                                  arch="lightweight:custom",
                                                  dtype=torch.bfloat16))})
TRAIN4 = _train_cases((2, 2), 4, 32, 23)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    return write_split(tmp_path_factory.mktemp("split") / "data", 6, 3, 40, 56)


def _spawn(tmp, world, cases):
    """The ranks' results; the full-width models' parameters and gradients
    travel as digests (the gradient whole from rank 0), and the files (the
    results, the loop's checkpoints) are removed once read."""
    torch.save(dict(transport=[], digests=True, **cases), tmp / "cases.pt")
    ranks = td.run_ranks(tmp, world, "spatial_train_ranks", str(tmp / "cases.pt"))
    shutil.rmtree(tmp)
    return ranks


def _same_on_every_rank(ranks, i, shape, what):
    """Metrics, parameters and gradients (digests), BN statistics and the
    matrix bit for bit on all ranks; the per-sample losses within each
    spatial group."""
    r0 = ranks[0]["steps"][i]
    for r, res in enumerate(ranks):
        got, lead = res["steps"][i], ranks[r - r % shape[1]]["steps"][i]
        for k in ("params_digest", "grads_digest"):
            assert got[k] == r0[k], (what, r, k)
        for k, v in r0["stats"].items():
            assert torch.equal(got["stats"][k], v), (what, r, k)
        assert torch.equal(got["cm"], r0["cm"]), (what, r)
        for m, (mg, m0) in enumerate(zip(got["metrics"], r0["metrics"])):
            for k, v in m0.items():
                want = lead["metrics"][m][k] if k == "sample_loss" else v
                assert torch.equal(mg[k], want), (what, r, m, k)


@pytest.fixture(scope="module")
def world2(tmp_path_factory, split):
    tmp = tmp_path_factory.mktemp("spatial_zoo_train2")
    loop = (split, str(tmp / "w2"), LOOP["epochs"], LOOP["batch"], 2, None, "lightweight:custom")
    return _spawn(tmp, 2, {"steps": list(TRAIN2.values()), "loop": [loop]})


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("spatial_zoo_train4"), 4,
                  {"steps": list(TRAIN4.values())})


def _train_ranks(name, world2, world4):
    ranks, cases = (world2, TRAIN2) if name in TRAIN2 else (world4, TRAIN4)
    return ranks, list(cases).index(name), cases[name][0], cases[name][1]


@functools.lru_cache(maxsize=None)
def _one(name):
    return td.spatial_train_case(dict(TRAIN2, **TRAIN4)[name][1])


@pytest.mark.parametrize("name", [n for n in list(TRAIN2) + list(TRAIN4) if n.endswith(F64)])
def test_zoo_striped_step_equals_one_process_in_float64(name, world2, world4):
    """In float64 the striped step of lightweight:custom and SimpleUNet
    equals the one-process step within EXACT_GATE: every metric, the
    per-sample losses, the BN statistics and the gradient; the eval's
    confusion matrix equal; every rank the same bit for bit."""
    ranks, i, shape, _ = _train_ranks(name, world2, world4)
    _same_on_every_rank(ranks, i, shape, name)
    got, want = ranks[0]["steps"][i], _one(name)
    for m in range(2):
        for k, v in want["metrics"][m].items():
            if k == "sample_loss":
                g = torch.cat([ranks[d * shape[1]]["steps"][i]["metrics"][m][k]
                               for d in range(shape[0])])
            else:
                g = got["metrics"][m][k]
            assert float((g - v).abs().max()) <= EXACT_GATE * float(v.abs().max()), (name, m, k)
    rel = _grad_dist(got["grads"], want["grads"])
    assert rel <= EXACT_GATE, (name, rel)
    stats = max((float((got["stats"][k] - v).abs().max()) for k, v in want["stats"].items()),
                default=0.0)
    assert stats <= EXACT_GATE, (name, stats)
    assert torch.equal(got["cm"], want["cm"]), name
    print(f"{name}: gradient {rel:.2e} of its norm from one process, BN statistics {stats:.2e}")


@pytest.mark.parametrize("name", [n for n in list(TRAIN2) + list(TRAIN4)
                                  if not n.endswith(F64) and "bf16" not in n])
def test_zoo_striped_step_matches_one_process_in_float32(name, world2, world4):
    """float32 at the gates of tests/test_torch_parallel.py (loss and parts
    1e-4, grad norm 1e-3, BN statistics 1e-5, the confusion matrix equal);
    the gradient within GRAD_GUARD of the one-process float64 step's."""
    ranks, i, shape, _ = _train_ranks(name, world2, world4)
    _same_on_every_rank(ranks, i, shape, name)
    got, want, exact = ranks[0]["steps"][i], _one(name), _one(name + F64)
    rel, stats = _assert_close(_scalars(got), _scalars(want), name, grad_gate=float("inf"))
    to64 = lambda g: {k: v.double() for k, v in g.items()}
    d_stripes = _grad_dist(to64(got["grads"]), to64(exact["grads"]))
    assert d_stripes <= GRAD_GUARD, (name, d_stripes)
    print(f"{name}: loss {float(got['metrics'][0]['loss']):.6f}; gradient {rel:.2e} of its norm "
          f"from one process's float32, {d_stripes:.2e} from its float64; BN statistics "
          f"{stats:.2e}")


def test_zoo_striped_step_bf16(world2):
    """lightweight:custom in bf16 over 1 x 2, at the NestedUNet's bf16 gate
    (tests/test_torch_spatial_train.py::test_striped_step_bf16): the
    gradient and BN statistics within twice the one-process step's own
    bf16-vs-fp32 distance (RMS), the scalars within TRAIN_BF16_RTOL of the
    fp32 step."""
    name = "lightweight:custom 1x2 bf16"
    ranks, i, shape, _ = _train_ranks(name, world2, None)
    _same_on_every_rank(ranks, i, shape, name)
    got, one16, one32 = ranks[0]["steps"][i], _one(name), _one("lightweight:custom 1x2")
    flat = lambda d: torch.cat([v.float().reshape(-1) for v in d.values()])
    rms = lambda a, b: float((a - b).square().mean().sqrt())
    for part in ("grads", "stats"):
        d_got, d_own = rms(flat(got[part]), flat(one32[part])), rms(flat(one16[part]),
                                                                   flat(one32[part]))
        assert d_got <= 2 * d_own, (part, d_got, d_own)
    for m in range(2):
        for k, v in one32["metrics"][m].items():
            if k != "sample_loss":
                assert abs(float(got["metrics"][m][k]) - float(v)) <= \
                    cs.TRAIN_BF16_RTOL * abs(float(v)), k


def test_train_model_lightweight_custom_with_n_spatial_2_equals_one_process(world2, split,
                                                                            tmp_path):
    """`train_model(TrainRunCfg(n_spatial=2))` with the inspection recipe's
    model (LightweightNestedUNet(encoder="custom"), deep supervision), loss
    and optimizer on 2 ranks (32^2 in stripes of 16 rows) against one
    process: the logged mIoU within 1e-3 and losses within 1e-4, the same
    files written once, both ranks' states bit for bit the same; the
    parameters within the optimizer's resolution of the one process's
    (twice the sum of the learning rates applied; tests/
    test_torch_spatial_train.py), the BN running statistics within
    STATS_REL of each tensor's largest value. The statistics integrate
    activations that every weight moves, and Adam moves a weight whose
    gradient is float32 noise by about the learning rate in either run, in
    either direction: measured 5e-3 of the scale at most here (the deepest
    blocks, 2 x 2 planes), the parameters 4e-4 against a bound of 7e-4."""
    lead, other = (res["loop"][0] for res in world2)
    one = td.loop_ranks(split, str(tmp_path / "w1"), LOOP["epochs"], LOOP["batch"], 1, None,
                        "lightweight:custom")
    shutil.rmtree(tmp_path / "w1")   # its checkpoints, once read
    h2, h1 = lead["history"], one["history"]
    np.testing.assert_allclose(h2["miou"], h1["miou"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(h2["loss"], h1["loss"], rtol=1e-4)
    assert lead["epochs_run"] == other["epochs_run"] == LOOP["epochs"]
    assert other["final_miou"] == lead["final_miou"] and other["saved"] == []
    assert lead["saved"] == one["saved"]
    for k, v in lead["state"].items():
        assert torch.equal(other["state"][k], v), k
    from unet_tpu_torch.train.trainer import OptimCfg, build_schedule

    steps = len(h1["loss"]) * 3                      # 3 micro-steps an epoch
    lr = build_schedule(OptimCfg(**dict(td.INSPECTION["optim"], total_steps=steps)))
    bound = 2 * sum(lr(n) for n in range(steps))
    diff = {k: float((v.double() - one["state"][k].double()).abs().max())
            for k, v in lead["state"].items() if "num_batches" not in k}
    worst = max(d for k, d in diff.items() if "running" not in k)
    assert worst <= bound, (worst, bound)
    stats = max(d / float(one["state"][k].abs().max()) for k, d in diff.items() if "running" in k)
    assert stats <= STATS_REL, stats
    print(f"lightweight:custom n_spatial=2 vs 1 process: mIoU {h2['miou']} vs {h1['miou']}, "
          f"loss {h2['loss']} vs {h1['loss']}; parameters {worst:.2e} (bound {bound:.2e}), "
          f"running statistics {stats:.2e} of their scale")
