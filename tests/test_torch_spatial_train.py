"""The spatial train step of the port (ROADMAP A15d) on gloo ranks on the
CPU: each world (2 and 4 ranks) is spawned once
(`tests/torch_dist.spatial_train_ranks`) and runs every case:
  * the transport's backward: the stripe gradients through `exchange`,
    `halo` with 3x3 convs, `up2x` and `resize_rows` against the rows of
    the unsharded op's gradient, over 2 and 4 stripes, float64, within
    TRANSPORT_GATE
  * two micro-steps (accumulation 2) of `make_train_step` over 1 x 2 at
    48^2 (uneven stripes: 32 and 16 rows), 2 x 2 at 32^2 and 1 x 4 at 64^2
    (narrow NestedUNets with deep supervision, flax's initialisation)
    against the one-process step on the global batch: the advanced loss
    with class weights and deep-supervision weights, combined, ce and
    dice, remat and bf16; every rank's metrics, parameters and statistics
    bit for bit the same
  * a class in one stripe only: the step's Dice is the whole sample's, not
    the stripe's
  * the full-width NestedUNet over (2, 2) against the JAX package's
    `shard_train_step` on a (2, 2) mesh of conftest's virtual devices
    (its default spatial=True), within twice the JAX package's own
    distance between one device and that mesh
  * `train_model` with `TrainRunCfg(n_spatial=2)` on 2 ranks against one
    process, and the mesh it picks where n_spatial does not divide the
    world

The gates. In float64 (parameters, activations and losses) the striped
step equals the one-process step within EXACT_GATE: every metric, the BN
statistics and the gradient (measured: 4e-15 of its norm). In float32 the
loss and its parts, the grad norm, the BN statistics and the confusion
matrix are held at tests/test_torch_parallel.py's gates (1e-4, 1e-3, 1e-5,
equal), bf16 as PERF.md's train row. The float32 gradient is held to the
float64 one within GRAD_GUARD, not to the one-process float32 one within
1e-5: two float32 runs of the step, in any two summation orders, differ by
their own rounding, and where a ReLU or max-pool input lies within that
rounding of its kink, the gradient through it switches. One such element
moves the gradient of these small batches by up to 1e-2 of its norm, in
either run: here the one-process float32 step lies 2e-6 to 9e-3 from the
float64 one, the striped 2e-6 to 6e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import TRAIN_BF16_RTOL, _train_batch, write_split
from tests import torch_dist as td
from tests import torch_zoo as zoo
from tests.test_torch_parallel import _assert_close, _grad_dist
from tests.torch_threads import one_intra_op_thread  # noqa: F401
from unet_tpu import parallel as jparallel
from unet_tpu.train import trainer as jt
from unet_tpu_torch.models.convert import state_dict_from_flax
from unet_tpu_torch.train.loop import train_mesh

TRANSPORT_GATE = 1e-12     # float64: the gradients' sums in another order
EXACT_GATE = 1e-10         # float64 steps: every metric, statistic and the gradient
GRAD_GUARD = 1e-2          # float32 gradient against the float64 one (see the module's docstring)
CE = dict(kind="ce")
DICE = dict(kind="dice")
COMBINED = dict(kind="combined", class_weights=(0.02, 1.0, 1.0), ds_weights=(0.1, 0.2, 0.3, 0.4))
F64 = " f64"


def _case(loss, b, size, seed, **net):
    images, labels = _train_batch(b, size, seed)
    return dict(loss=loss, net=dict(net, seed=seed), images=images, labels=labels)


def _one_class_in_one_stripe():
    """1 x 2 at 48^2 (stripes of 32 and 16 rows): in the first sample a
    cable in both stripes and tape (class 2) in rows 4..20 only, in the
    second both classes in the first stripe only, so that a per-stripe Dice
    on the second stripe skips the tape of the first sample and both
    classes of the second."""
    images, labels = _train_batch(2, 48, 71)
    labels[:] = 0
    labels[0, :, 10:18] = 1
    labels[0, 4:20, 6:30] = 2
    labels[1, 2:28, 20:26] = 1
    labels[1, 6:12, 14:34] = 2
    return dict(loss=td.LOSS, net=dict(seed=5), images=images, labels=labels)


def _with_f64(cases):
    """Each case, and its float64 twin (the same weights and batch)."""
    out = dict(cases)
    for name, (shape, case) in cases.items():
        if "dtype" not in case["net"]:
            out[name + F64] = (shape, dict(case, net=dict(case["net"], dtype=torch.float64)))
    return out


WORLD2 = _with_f64({
    "advanced": ((1, 2), _case(td.LOSS, 2, 48, 1)),
    "combined": ((1, 2), _case(COMBINED, 2, 48, 2)),
    "ce": ((1, 2), _case(CE, 2, 48, 3)),
    "dice": ((1, 2), _case(DICE, 2, 48, 4)),
    "advanced remat": ((1, 2), _case(td.LOSS, 2, 48, 1, remat=True)),
    "advanced bf16": ((1, 2), _case(td.LOSS, 2, 48, 1, dtype=torch.bfloat16)),
    "class in one stripe": ((1, 2), _one_class_in_one_stripe())})
WORLD4 = _with_f64({"advanced 2x2": ((2, 2), _case(td.LOSS, 4, 32, 6)),
                    "advanced 1x4": ((1, 4), _case(td.LOSS, 2, 64, 7))})
FP32 = [n for n in list(WORLD2) + list(WORLD4) if not n.endswith(F64) and "bf16" not in n]
LOOP = dict(epochs=2, batch=2, filters=td.NARROW)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    return write_split(tmp_path_factory.mktemp("split") / "data", 6, 3, 40, 56)


@pytest.fixture(scope="module")
def world2(tmp_path_factory, split):
    tmp = tmp_path_factory.mktemp("spatial_train2")
    loop = (split, str(tmp / "w2"), LOOP["epochs"], LOOP["batch"], 2, LOOP["filters"])
    torch.save({"transport": [2], "steps": list(WORLD2.values()),
                "loop": [loop], "mesh_of": [(2, 2), (2, 3), (3, 1)]}, tmp / "cases.pt")
    ranks = td.run_ranks(tmp, 2, "spatial_train_ranks", str(tmp / "cases.pt"))
    return dict(ranks=ranks, tmp=tmp)


def _jax_batch():
    r = np.random.default_rng(13)
    images = r.random((4, 32, 32, 3), dtype=np.float32)
    labels = r.integers(0, 3, (4, 32, 32)).astype(np.int32)
    labels[:, 8:20, 10:14] = 1
    return images, labels


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spatial_train4")
    variables = zoo.jax_variables("nested_unet", 3, size=32, seed=8, train=True)
    images, labels = _jax_batch()
    torch.save({"transport": [4], "steps": list(WORLD4.values()),
                "jax": [((2, 2), (variables, images, labels))]}, tmp / "cases.pt")
    ranks = td.run_ranks(tmp, 4, "spatial_train_ranks", str(tmp / "cases.pt"))
    return dict(ranks=ranks, variables=variables, batch=(images, labels))


def _world(name):
    return WORLD2 if name in WORLD2 else WORLD4


@functools.lru_cache(maxsize=None)
def _one(name):
    return td.spatial_train_case(_world(name)[name][1])


def _scalars(r):
    return dict(r, metrics=[{k: float(v) for k, v in m.items() if k != "sample_loss"}
                            for m in r["metrics"]])


def _same_on_every_rank(ranks, i, shape, what):
    """Metrics, parameters, BN statistics and the matrix bit for bit on all
    ranks; the per-sample losses within each spatial group."""
    r0 = ranks[0]["steps"][i]
    for r, res in enumerate(ranks):
        got, lead = res["steps"][i], ranks[r - r % shape[1]]["steps"][i]
        for part in ("params", "stats", "grads"):
            for k, v in r0[part].items():
                assert torch.equal(got[part][k], v), (what, r, part, k)
        assert torch.equal(got["cm"], r0["cm"]), (what, r)
        for m, (mg, m0) in enumerate(zip(got["metrics"], r0["metrics"])):
            for k, v in m0.items():
                want = lead["metrics"][m][k] if k == "sample_loss" else v
                assert torch.equal(mg[k], want), (what, r, m, k)


def _sample_losses(ranks, i, shape, m):
    """The global batch's per-sample losses of micro-step m: each data
    slice's from the first rank of its spatial group."""
    return torch.cat([ranks[d * shape[1]]["steps"][i]["metrics"][m]["sample_loss"]
                      for d in range(shape[0])])


def _ranks_of(name, world2, world4):
    w = world2 if name in WORLD2 else world4
    return w["ranks"], list(_world(name)).index(name), _world(name)[name][0]


def test_transport_backward_matches_the_unsharded_gradient(world2, world4):
    for w, n in ((world2, 2), (world4, 4)):
        for r, res in enumerate(w["ranks"]):
            checks = res["transport"][0]
            assert len(checks) == 18, (n, sorted(checks))
            bad = {k: v for k, v in checks.items() if not v <= TRANSPORT_GATE}
            assert not bad, (n, r, bad)


@pytest.mark.parametrize("name", [n + F64 for n in FP32])
def test_striped_step_equals_one_process_in_float64(name, world2, world4):
    """The striped step computes the one-process step's function: in
    float64 every metric, the per-sample losses, the BN statistics and the
    gradient within EXACT_GATE (relative; the statistics absolute), the
    confusion matrix equal, every rank the same bit for bit."""
    ranks, i, shape = _ranks_of(name, world2, world4)
    _same_on_every_rank(ranks, i, shape, name)
    got, want = ranks[0]["steps"][i], _one(name)
    for m in range(2):
        for k, v in want["metrics"][m].items():
            g = _sample_losses(ranks, i, shape, m) if k == "sample_loss" else got["metrics"][m][k]
            assert float((g - v).abs().max()) <= EXACT_GATE * float(v.abs().max()), (name, m, k)
    rel = _grad_dist(got["grads"], want["grads"])
    assert rel <= EXACT_GATE, (name, rel)
    stats = max(float((got["stats"][k] - v).abs().max()) for k, v in want["stats"].items())
    assert stats <= EXACT_GATE, (name, stats)
    assert torch.equal(got["cm"], want["cm"]), name
    print(f"{name} over {shape[0]} x {shape[1]}: gradient {rel:.2e} of its norm from one "
          f"process, BN statistics {stats:.2e}")


@pytest.mark.parametrize("name", FP32)
def test_striped_step_matches_one_process_in_float32(name, world2, world4):
    """float32 at the gates of tests/test_torch_parallel.py: loss and parts
    1e-4 relative, grad norm 1e-3, BN statistics 1e-5, the confusion matrix
    equal, the per-sample losses 1e-5; every rank the same bit for bit. The
    gradient is held to the one-process step's exact (float64) gradient
    within GRAD_GUARD, and its distances from both are printed (see the
    module's docstring)."""
    ranks, i, shape = _ranks_of(name, world2, world4)
    _same_on_every_rank(ranks, i, shape, name)
    got, want, exact = ranks[0]["steps"][i], _one(name), _one(name + F64)
    rel, stats = _assert_close(_scalars(got), _scalars(want), name, grad_gate=float("inf"))
    for m in range(2):
        np.testing.assert_allclose(_sample_losses(ranks, i, shape, m).numpy(),
                                   want["metrics"][m]["sample_loss"].numpy(), rtol=1e-5,
                                   err_msg=name)
    f64 = {k: v.double() for k, v in exact["grads"].items()}
    to64 = lambda g: {k: v.double() for k, v in g.items()}
    d_stripes, d_one = _grad_dist(to64(got["grads"]), f64), _grad_dist(to64(want["grads"]), f64)
    assert d_stripes <= GRAD_GUARD, (name, d_stripes)
    print(f"{name} over {shape[0]} x {shape[1]}: loss {float(got['metrics'][0]['loss']):.6f}; "
          f"gradient {rel:.2e} of its norm from one process's float32, {d_stripes:.2e} from its "
          f"float64 (one process's float32 {d_one:.2e}); BN statistics {stats:.2e}")


def test_striped_remat_equals_striped_without_remat(world2):
    """remat re-runs each block in the backward, not its exchange: the
    numbers of the striped step without it, within the float32 gates."""
    names = list(WORLD2)
    plain = world2["ranks"][0]["steps"][names.index("advanced")]
    rem = world2["ranks"][0]["steps"][names.index("advanced remat")]
    rel, _ = _assert_close(_scalars(rem), _scalars(plain), "remat vs no remat on stripes")
    print(f"remat vs no remat on 1 x 2: gradient {rel:.2e} of its norm")


def test_striped_step_bf16(world2):
    """bf16 as PERF.md's train row: the gradient and the BN statistics
    within twice the one-process step's own bf16-vs-fp32 distance (RMS),
    the scalars within TRAIN_BF16_RTOL of the fp32 step."""
    names = list(WORLD2)
    i = names.index("advanced bf16")
    _same_on_every_rank(world2["ranks"], i, (1, 2), "bf16 over 1 x 2")
    got, one16, one32 = world2["ranks"][0]["steps"][i], _one("advanced bf16"), _one("advanced")
    flat = lambda d: torch.cat([v.float().reshape(-1) for v in d.values()])
    rms = lambda a, b: float((a - b).square().mean().sqrt())
    for part in ("grads", "stats"):
        d_got, d_own = rms(flat(got[part]), flat(one32[part])), rms(flat(one16[part]),
                                                                   flat(one32[part]))
        assert d_got <= 2 * d_own, (part, d_got, d_own)
        print(f"bf16 over 1 x 2: {part} {d_got:.3e} (RMS) from the fp32 step; one process's "
              f"bf16 {d_own:.3e}")
    for m in range(2):
        for k, v in one32["metrics"][m].items():
            if k != "sample_loss":
                assert abs(float(got["metrics"][m][k]) - float(v)) <= TRAIN_BF16_RTOL * abs(float(v)), k


def test_losses_decide_on_whole_samples(world2):
    """The tape lies in the first stripe only: the step's Dice is the whole
    samples' (as the one process's), and differs from the Dice of the
    second stripe's logits and labels alone, which skips the classes that
    stripe lacks."""
    i = list(WORLD2).index("class in one stripe")
    step_dice = float(world2["ranks"][1]["steps"][i]["metrics"][0]["dice"])
    local = world2["ranks"][1]["steps"][i]["local_dice"]
    assert abs(step_dice - float(_one("class in one stripe")["metrics"][0]["dice"])) <= 1e-4 * step_dice
    assert abs(local - step_dice) > 1e-3, (local, step_dice)
    print(f"Dice: the step's {step_dice:.6f}, the second stripe's alone {local:.6f}")


@functools.lru_cache(maxsize=None)
def _jax_sharded(shape):
    """The JAX package's model, optimizer, and its train and eval steps over
    a (n_data, n_spatial) mesh with the default spatial=True."""
    jm = zoo.jax_model("nested_unet", 3, deep_supervision=True)
    tx = jt.build_optimizer(jt.OptimCfg(**td.OPTIM))
    n = shape[0] * shape[1]
    mesh = jparallel.make_mesh(n_data=shape[0], n_spatial=shape[1], devices=jax.devices()[:n])
    step = jparallel.shard_train_step(jt.make_train_step(jt.LossCfg(**td.LOSS)), mesh)
    return jm, tx, mesh, step, jparallel.shard_eval_step(jt.make_eval_step(3), mesh)


def _jax_steps(variables, images, labels, shape):
    """As tests/test_torch_parallel.py's `_jax_steps`, over a (n_data,
    n_spatial) mesh."""
    jm, tx, mesh, step, eval_step = _jax_sharded(shape)
    state = jt.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]), apply_fn=jm.apply, tx=tx)
    im, lb = jparallel.put_batch(mesh, images, labels)
    metrics, grads = [], None
    for i in range(2):
        state, m = step(state, im, lb)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads = {k: v for k, v in state_dict_from_flax(
                {"params": state.opt_state.acc_grads, "batch_stats": state.batch_stats},
                "nested_unet").items() if "running" not in k and "num_batches" not in k}
    stats = {k: v for k, v in state_dict_from_flax(
        {"params": state.params, "batch_stats": state.batch_stats}, "nested_unet").items()
        if "running" in k}
    cm = eval_step(state, im, lb)
    return dict(metrics=metrics, grads=grads, stats=stats, cm=torch.from_numpy(np.array(cm)))


def test_spatial_step_matches_the_jax_package_on_a_2x2_mesh(world4):
    ranks = [res["jax"][0] for res in world4["ranks"]]
    for r, res in enumerate(ranks):
        assert res["metrics"] == ranks[0]["metrics"], r
        assert res["grads_digest"] == ranks[0]["grads_digest"], r
        for k, v in ranks[0]["stats"].items():
            assert torch.equal(res["stats"][k], v), (r, k)
        assert torch.equal(res["cm"], ranks[0]["cm"]), r
    two = ranks[0]
    variables, (images, labels) = world4["variables"], world4["batch"]
    one = td.train_case(variables, images, labels)
    rel1, _ = _assert_close(two, one, "2 x 2 vs 1 process, full width", grad_gate=float("inf"))
    exact = td.train_case(variables, images, labels, None, torch.float64)["grads"]
    to64 = lambda g: {k: torch.as_tensor(v).double() for k, v in g.items()}
    d_two, d_one = _grad_dist(to64(two["grads"]), to64(exact)), _grad_dist(to64(one["grads"]),
                                                                          to64(exact))
    assert d_two <= GRAD_GUARD, d_two
    jax22 = _jax_steps(variables, images, labels, (2, 2))
    jax1 = _jax_steps(variables, images, labels, (1, 1))
    spread = _grad_dist(jax1["grads"], jax22["grads"])
    rel2, st2 = _assert_close(two, jax22, "2 x 2 vs the JAX package's 2 x 2",
                              grad_gate=max(2 * spread, 1e-5))
    print(f"2 x 2, full width, 32^2: gradient {rel1:.2e} from 1 process ({d_two:.2e} from its "
          f"float64, 1 process {d_one:.2e}), {rel2:.2e} from JAX's (2, 2) mesh (JAX 1 device vs "
          f"(2, 2): {spread:.2e}, JAX 1 device vs the port's float64: "
          f"{_grad_dist(to64(jax1['grads']), to64(exact)):.2e}); BN statistics {st2:.2e}")


def test_train_model_with_n_spatial_2_equals_one_process(world2, split, tmp_path):
    """`train_model(TrainRunCfg(n_spatial=2))` on 2 ranks (a 1 x 2 mesh, the
    32^2 inputs in stripes of 16 rows) against one process: the logged
    mIoU within 1e-3 and losses within 1e-4, the same files, written once;
    both ranks' states bit for bit the same, and within the optimizer's
    resolution of the one process's: twice the sum of the learning rates
    applied, as far as Adam's first updates move a parameter whose
    gradient is float32 noise in both runs (a conv bias before
    BatchNorm; the running means carry it)."""
    lead, other = (res["loop"][0] for res in world2["ranks"])
    one = td.loop_ranks(split, str(tmp_path / "w1"), LOOP["epochs"], LOOP["batch"], 1,
                        LOOP["filters"])
    h2, h1 = lead["history"], one["history"]
    np.testing.assert_allclose(h2["miou"], h1["miou"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(h2["loss"], h1["loss"], rtol=1e-4)
    assert lead["epochs_run"] == other["epochs_run"] == LOOP["epochs"]
    assert other["final_miou"] == lead["final_miou"] and other["saved"] == []
    assert lead["saved"] == one["saved"]
    for k, v in lead["state"].items():
        assert torch.equal(other["state"][k], v), k
    diff = {k: float((v.double() - one["state"][k].double()).abs().max())
            for k, v in lead["state"].items() if "num_batches" not in k}
    pre_bn = [k for k in diff if k.endswith(("conv1.bias", "conv2.bias"))]
    parts = {"running_var": [k for k in diff if "running_var" in k],
             "running_mean": [k for k in diff if "running_mean" in k], "pre-BN conv biases": pre_bn,
             "other parameters": [k for k in diff if "running" not in k and k not in pre_bn]}
    worst = {p: max(diff[k] for k in ks) for p, ks in parts.items()}
    from unet_tpu_torch.train.trainer import OptimCfg, build_schedule

    updates = len(h1["loss"]) * 3 // td.OPTIM["accum_steps"]   # 3 micro-steps an epoch
    lr = build_schedule(OptimCfg(**dict(td.OPTIM, total_steps=len(h1["loss"]) * 3)))
    bound = 2 * sum(lr(n) for n in range(updates))
    assert max(worst.values()) <= bound, (worst, bound)
    print(f"n_spatial=2 vs 1 process: mIoU {h2['miou']} vs {h1['miou']}, loss {h2['loss']} vs "
          f"{h1['loss']}; state max abs differences {worst} (bound {bound:.2e})")


def test_train_mesh_takes_n_spatial_where_it_divides_the_world(world2):
    """As unet_tpu/train/loop.py:46-55: n_spatial where it divides the world
    size, else 1; the data axis the largest divisor of the batch size among
    the rest (one process: n_spatial 2 falls back to 1)."""
    assert world2["ranks"][0]["mesh_of"] == [(1, 2), (2, 1), (1, 1)]
    assert world2["ranks"][1]["mesh_of"] == [(1, 2), (2, 1), (1, 1)]
    assert train_mesh(4, "cpu", 2).shape == (1, 1)


def test_chip_smoke_spatial_train_phase_runs_on_the_cpu(monkeypatch):
    """chip_smoke.phase_spatial_train end to end on the CPU at 32^2 (the
    card's synchronize stubbed): every run over 1 x 2 and 2 x 2 against the
    one-process step, with the phase's own gates but the fp32 gradient's,
    which is the card's at 512^2: at 32^2 one kink flip (a ReLU input or a
    max-pool pair within float32 rounding of a tie) moves the float32
    gradient by up to ~1e-2 of its norm, in either run (the float64 test
    above holds the step's function exactly)."""
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    rec = chip_smoke.phase_spatial_train(device="cpu", size=32, reps=1, grad_gate=float("inf"))
    assert sorted(rec["runs"]) == ["bf16 1x2", "fp32 1x2", "fp32 2x2", "fp32_remat 1x2"]
    for key, r in rec["runs"].items():
        assert len(r["per_rank"]) == (4 if "2x2" in key else 2), key
        assert set(r["collective_ms"]) == {"all_gather (transport)", "all_reduce"}, key
        if key.startswith("fp32"):
            assert r["stats"] <= chip_smoke.TRAIN_STATS_ATOL and r["loss_rel"] <= 1e-4, key
    assert rec["runs"]["fp32_remat 1x2"]["vs_no_remat"]["grad"] == 0.0
    assert rec["runs"]["fp32 1x2"]["grad"] <= chip_smoke.SPATIAL_TRAIN_GRAD
