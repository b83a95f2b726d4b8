"""The port's mesh (unet_tpu_torch.parallel) on the CPU: `make_mesh` shapes
and refusals, and the train and eval steps over 2 gloo ranks against the
one-process step on the same global batch and against the JAX package's
sharded step on a 2-device mesh of conftest's virtual devices: the
3class_advanced loss (class weights, deep supervision) and optimizer
(accumulation 2) on the NestedUNet at 32^2, with the gates of
tests/test_torch_train.py, also where a class that one rank's slice holds
is missing from the other's and where one slice holds no valid class at
all (Dice's fallback decides on the global batch). At one rank the mesh
step equals the step without a mesh bit for bit."""
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_dist as td
from tests import torch_zoo as zoo
from tests.torch_threads import one_intra_op_thread  # noqa: F401
from unet_tpu import parallel as jparallel
from unet_tpu.train import trainer as jt
from unet_tpu_torch import parallel
from unet_tpu_torch.models.convert import state_dict_from_flax

SIZE = 32


def test_make_mesh_shapes_and_refusals():
    mesh = parallel.make_mesh(device="cpu")
    assert (mesh.shape, mesh.size, mesh.rank, mesh.ranks) == ((1, 1), 1, 0, (0,))
    assert mesh.device_mesh.mesh_dim_names == (parallel.DATA_AXIS, parallel.SPATIAL_AXIS)
    assert mesh.device == torch.device("cpu") and mesh.member
    assert (mesh.spatial_size, mesh.spatial_rank) == (1, 0)
    with pytest.raises(ValueError, match="2x1 mesh != 1 ranks"):
        parallel.make_mesh(n_data=2, device="cpu")
    with pytest.raises(ValueError, match="0x2 mesh != 1 ranks"):
        parallel.make_mesh(n_spatial=2, device="cpu")
    # the spatial axis runs (tests/test_torch_spatial.py,
    # test_torch_spatial_train.py) and is the default of the train and eval
    # steps and put_batch, as in the JAX package; on a mesh of one spatial
    # rank the step runs over the data axis alone, on whole planes
    from unet_tpu_torch.parallel import mesh as pmesh

    for fn in (parallel.shard_train_step, parallel.shard_eval_step, parallel.put_batch):
        assert inspect.signature(fn).parameters["spatial"].default is True, fn.__name__
    assert inspect.signature(parallel.shard_pipeline_step).parameters["spatial"].default is False
    seen = parallel.shard_train_step(lambda *a: (pmesh.active(), pmesh.active_spatial()),
                                     mesh, spatial=True)(None, None, None)
    assert seen == (mesh, None)
    im = parallel.put_batch(mesh, np.ones((2, 32, 4, 3), np.float32), spatial=True)
    assert im.shape == (2, 32, 4, 3)
    # a batch that the data axis does not divide raises; a one-rank mesh
    # takes a global batch whole
    im, lb = parallel.put_batch(mesh, np.ones((3, 4, 4, 3), np.float32),
                                np.zeros((3, 4, 4), np.int32))
    assert im.shape == (3, 4, 4, 3) and lb.dtype == torch.int32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            parallel.make_mesh(device="cuda")


def test_mesh_device_takes_the_named_card(monkeypatch):
    """"cuda" is torchrun's LOCAL_RANK card, "cuda:N" the card the caller
    names (several ranks on one card), "cpu" the CPU."""
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert parallel.mesh_device("cuda") == torch.device("cuda", 3)
    assert parallel.mesh_device("cuda:0") == torch.device("cuda", 0)
    assert parallel.mesh_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            parallel.make_mesh(device="cuda:0")


def _cases():
    """Two global batches of 4 at 32^2: random labels with a cable strip in
    every frame; and one whose first half (rank 0's slice) holds only
    background, while the second holds classes 1 and 2."""
    r = np.random.default_rng(11)
    images = r.random((4, SIZE, SIZE, 3), dtype=np.float32)
    labels = r.integers(0, 3, (4, SIZE, SIZE)).astype(np.int32)
    labels[:, 8:20, 10:14] = 1
    skewed = np.zeros((4, SIZE, SIZE), np.int32)
    skewed[2:, 4:28, 8:16] = 1
    skewed[3, 10:14, 4:28] = 2
    return [(images, labels), (images, skewed)]


@functools.lru_cache(maxsize=None)
def _jax_sharded(n_data):
    """The JAX package's model, optimizer, and shard_train_step and
    shard_eval_step over an n_data-device data axis (jitted once)."""
    jm = zoo.jax_model("nested_unet", 3, deep_supervision=True)
    tx = jt.build_optimizer(jt.OptimCfg(**td.OPTIM))
    mesh = jparallel.make_mesh(n_data=n_data, n_spatial=1, devices=jax.devices()[:n_data])
    step = jparallel.shard_train_step(jt.make_train_step(jt.LossCfg(**td.LOSS)), mesh, False)
    return jm, tx, mesh, step, jparallel.shard_eval_step(jt.make_eval_step(3), mesh, False)


def _jax_steps(variables, images, labels, n_data):
    """The JAX package's sharded train and eval steps: as
    tests/torch_dist.train_case records the port's."""
    jm, tx, mesh, step, eval_step = _jax_sharded(n_data)
    state = jt.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]), apply_fn=jm.apply, tx=tx)
    im, lb = jparallel.put_batch(mesh, images, labels, spatial=False)
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


def _grad_dist(got, want) -> float:
    """|g - g_want| / |g_want| over all tensors."""
    diff = sum(float(((torch.as_tensor(got[k]) - torch.as_tensor(w)) ** 2).sum())
               for k, w in want.items())
    return (diff / sum(float((torch.as_tensor(w) ** 2).sum()) for w in want.values())) ** 0.5


def _assert_close(got, want, what, grad_gate=1e-5):
    """The gates of tests/test_torch_train.py: loss and parts 1e-4 relative,
    grad norm 1e-3, BN statistics 1e-5; the confusion matrix equal; the
    gradient within `grad_gate` of its norm."""
    for n, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        assert set(g) == set(w), (what, n)
        for k in w:
            tol = 1e-3 if k == "grad_norm" else 1e-4
            assert abs(g[k] - w[k]) <= tol * abs(w[k]), (what, n, k, g[k], w[k])
    assert set(got["grads"]) == set(want["grads"])
    rel = _grad_dist(got["grads"], want["grads"])
    assert rel <= grad_gate, (what, rel, grad_gate)
    stats = max((float((torch.as_tensor(got["stats"][k]) - torch.as_tensor(w)).abs().max())
                 for k, w in want["stats"].items()), default=0.0)   # none without BatchNorm
    assert stats <= 1e-5, (what, stats)
    assert torch.equal(got["cm"].long(), want["cm"].long()), what
    return rel, stats


def test_sharded_train_step_matches_one_process_and_jax(tmp_path):
    variables = zoo.jax_variables("nested_unet", 3, size=SIZE, seed=3, train=True)
    cases = _cases()
    torch.save({"variables": variables, "cases": cases}, tmp_path / "inputs.pt")
    ranks = td.run_ranks(tmp_path, 2, "train_ranks", str(tmp_path / "inputs.pt"))
    for case, (images, labels) in enumerate(cases):
        two, other = ranks[0][case], ranks[1][case]
        # every rank holds the same global metrics, state and matrix
        assert two["metrics"] == other["metrics"]
        for k in two["stats"]:
            assert torch.equal(two["stats"][k], other["stats"][k]), k
        assert torch.equal(two["cm"], other["cm"])
        one = td.train_case(variables, images, labels)
        rel1, st1 = _assert_close(two, one, f"case {case}: 2 ranks vs 1 process")
        # against the JAX package's sharded step: the gradient within twice
        # the distance between the JAX package's own sharded and
        # single-device gradients (2e-3 of the norm on the first batch:
        # float32 sums in another order through 26 train-mode BNs)
        jax2 = _jax_steps(variables, images, labels, 2)
        spread = _grad_dist(_jax_steps(variables, images, labels, 1)["grads"], jax2["grads"])
        rel2, st2 = _assert_close(two, jax2, f"case {case}: 2 ranks vs the JAX package's 2 "
                                             f"devices", grad_gate=max(2 * spread, 1e-5))
        print(f"case {case}: loss {two['metrics'][0]['loss']:.6f}; gradient {rel1:.2e} from "
              f"1 process, {rel2:.2e} from JAX on 2 devices (JAX 1 vs 2 devices {spread:.2e});"
              f" BN statistics {st1:.2e}, {st2:.2e}")
    # Dice's fallback and skip_empty decide on the global batch: rank 0's
    # slice alone (only background) would take the fallback
    local = td.train_case(variables, cases[1][0][:2], cases[1][1][:2])
    assert abs(local["metrics"][0]["dice"] - ranks[0][1]["metrics"][0]["dice"]) > 1e-3


def test_one_rank_mesh_equals_no_mesh_bit_for_bit():
    """What the card's run checks at world size 1: the mesh step (its
    collectives over one rank) and the step without a mesh compute the
    same numbers."""
    variables = zoo.jax_variables("nested_unet", 3, size=SIZE, seed=4, train=True)
    images, labels = _cases()[0]
    got = td.train_case(variables, images, labels, parallel.make_mesh(device="cpu"))
    want = td.train_case(variables, images, labels)
    assert got["metrics"] == want["metrics"]
    for part in ("grads", "stats"):
        for k in want[part]:
            assert torch.equal(got[part][k], want[part][k]), (part, k)
    assert torch.equal(got["cm"], want["cm"])
