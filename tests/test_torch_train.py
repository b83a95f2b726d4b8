"""The port's trainer (unet_tpu_torch.train.trainer) against the JAX package's
optax trainer: each schedule at every step of a short run; the optimizer
chain (clipping, AdamW, MultiSteps accumulation, onecycle) fed the same
gradients; one train step of NestedUNet (deep supervision, the
3class_advanced loss and optimizer) and of SimpleUNet from the same
weights (models.convert.state_dict_from_flax): loss, components,
gradients and BatchNorm statistics, in float32 and in bf16; remat; and the
bf16 gradients reaching the float32 parameters."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests import torch_zoo as zoo
from unet_tpu.train import trainer as jt
from unet_tpu_torch.cli.main import _build_model
from unet_tpu_torch.models import NestedUNet
from unet_tpu_torch.models.convert import state_dict_from_flax
from unet_tpu_torch.train import trainer as T
from tests.torch_threads import one_intra_op_thread  # noqa: F401

SIZE, B = 32, 2


@pytest.mark.parametrize("cfg", [
    dict(schedule="onecycle", total_steps=40),
    dict(schedule="onecycle", total_steps=57, pct_start=0.3, div_factor=25,
         final_div_factor=1e4),
    dict(schedule="cosine", total_steps=30),
    dict(schedule="cosine_restarts", total_steps=50, restart_period=12),
    dict(schedule="constant", total_steps=10)], ids=lambda c: f"{c['schedule']}-{c['total_steps']}")
def test_schedule_matches_optax_at_every_step(cfg):
    ocfg = T.OptimCfg(lr=2e-4, **cfg)
    want = jax.jit(jt.build_schedule(jt.OptimCfg(lr=2e-4, **cfg)))
    got = T.build_schedule(ocfg)
    for n in range(ocfg.total_steps + 5):
        assert abs(got(n) - float(want(jnp.int32(n)))) <= 1e-7, n


def test_onecycle_with_an_empty_warm_up_stays_finite():
    """int(pct_start * steps) == 0: optax's schedule is NaN at every step;
    the port's skips the empty interval."""
    s = T.build_schedule(T.OptimCfg(lr=2e-4, schedule="onecycle", total_steps=8))
    assert all(np.isfinite(s(n)) for n in range(10))
    assert abs(s(0) - 2e-4) < 1e-10 and s(7) < s(0)


def test_optimizer_chain_matches_optax():
    """Clipping active, accumulation 2, onecycle: 10 micro-steps (5 updates)
    of the same gradients give parameters within 1e-6."""
    cfg = dict(lr=1e-2, weight_decay=1e-2, schedule="onecycle", total_steps=12, clip_norm=1.0,
               accum_steps=2)
    r = np.random.default_rng(0)
    shapes = [(8, 3, 3, 3), (8,), (4, 8, 1, 1)]
    p0 = [r.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(r.normal(size=s) * r.uniform(0.5, 3)).astype(np.float32) for s in shapes]
             for _ in range(10)]
    tx = jt.build_optimizer(jt.OptimCfg(**cfg))
    params = [jnp.asarray(p) for p in p0]
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    module = torch.nn.Module()
    module.p = torch.nn.ParameterList([torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0])
    state = T.create_train_state(module, T.OptimCfg(**cfg), "cpu")
    clipped = 0
    for g in grads:
        clipped += float(optax.global_norm([jnp.asarray(x) for x in g])) > 1.0
        updates, opt_state = update([jnp.asarray(x) for x in g], opt_state, params)
        params = optax.apply_updates(params, updates)
        state.apply_gradients([torch.from_numpy(x.copy()) for x in g])
        for p, q in zip(state.params, params):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(q), rtol=0, atol=1e-6)
    assert clipped == 10 and state.scheduler.last_epoch == 5
    assert abs(max(float(np.abs(p.detach().numpy() - a).max()) for p, a in
                   zip(state.params, p0))) > 1e-3   # the parameters moved


def _batch(seed: int, num_classes: int):
    r = np.random.default_rng(seed)
    images = r.random((B, SIZE, SIZE, 3), dtype=np.float32)
    labels = r.integers(0, num_classes, (B, SIZE, SIZE)).astype(np.int32)
    labels[:, 8:20, 10:14] = 1
    return images, labels


STEPS = {
    # arch: (classes, loss, optimizer): NestedUNet as 3class_advanced trains it,
    # SimpleUNet as 7class (no BatchNorm, no heads)
    "nested_unet": (3, dict(kind="advanced", class_weights=(0.02, 1.0, 1.0),
                            weight_focal=0.35, weight_tversky=0.45, weight_dice=0.20,
                            tversky_alpha=0.25, tversky_beta=0.75,
                            ds_weights=(0.1, 0.2, 0.3, 0.4)),
                    dict(lr=2e-4, weight_decay=1e-4, schedule="onecycle", total_steps=40,
                         clip_norm=1.0, accum_steps=2)),
    "simple_unet": (7, dict(kind="combined"),
                    dict(lr=1e-4, schedule="cosine", total_steps=40, accum_steps=2)),
}


def _jax_step(arch, variables, images, labels, dtype):
    classes, loss, optim = STEPS[arch]
    jm = zoo.jax_model(arch, classes, deep_supervision=True, dtype=dtype)
    tx = jt.build_optimizer(jt.OptimCfg(**optim))
    state = jt.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                          batch_stats=variables.get("batch_stats", {}),
                          opt_state=tx.init(variables["params"]), apply_fn=jm.apply, tx=tx)
    state, metrics = jax.jit(jt.make_train_step(jt.LossCfg(**loss), track_sample_loss=True))(
        state, jnp.asarray(images), jnp.asarray(labels))
    metrics = dict(metrics)
    sample = np.asarray(metrics.pop("sample_loss"))
    # MultiSteps' first micro-step leaves acc = 0 + (g - 0) / 1 = g
    grads = state_dict_from_flax({"params": state.opt_state.acc_grads,
                                  "batch_stats": state.batch_stats}, arch)
    stats = state_dict_from_flax({"params": state.params, "batch_stats": state.batch_stats},
                                 arch)
    return ({k: float(v) for k, v in metrics.items()}, grads,
            {k: v for k, v in stats.items() if "running" in k}, sample)


def _port_step(arch, variables, images, labels, dtype, remat=False):
    classes, loss, optim = STEPS[arch]
    sd = state_dict_from_flax(variables, arch)
    if arch == "nested_unet":
        model = NestedUNet(classes, deep_supervision=True, dtype=dtype, remat=remat)
    else:
        model = _build_model(classes, arch, str(dtype).replace("torch.", ""))
    model.load_state_dict(sd, strict=True)
    state = T.create_train_state(model, T.OptimCfg(**optim), "cpu")
    x, y = T.upload(images, labels, "cpu")
    state, metrics = T.make_train_step(T.LossCfg(**loss), track_sample_loss=True)(state, x, y)
    sample = metrics.pop("sample_loss").numpy()
    names = [k for k, _ in model.named_parameters()]
    grads = dict(zip(names, state.acc_grads))
    stats = {k: v for k, v in model.state_dict().items() if "running" in k}
    return {k: float(v) for k, v in metrics.items()}, grads, stats, model, sample


def _dist(a, b, keys):
    return max(float((torch.as_tensor(a[k]).float() - torch.as_tensor(b[k]).float()).abs().max())
               for k in keys)


@pytest.mark.parametrize("arch", sorted(STEPS))
def test_train_step_matches_jax(arch):
    classes = STEPS[arch][0]
    variables = zoo.jax_variables(arch, classes, size=SIZE, seed=3, train=True)
    images, labels = _batch(5, classes)
    jm, jg, js, jsample = _jax_step(arch, variables, images, labels, jnp.float32)
    pm, pg, ps, _, psample = _port_step(arch, variables, images, labels, torch.float32)
    np.testing.assert_allclose(psample, jsample, rtol=1e-5)   # track_sample_loss
    assert set(pm) == set(jm)
    for k in jm:   # the loss, its components, the gradient norm
        assert abs(pm[k] - jm[k]) <= 1e-5 * abs(jm[k]), (k, pm[k], jm[k])
    assert set(pg) == {k for k in jg if "running" not in k and "num_batches" not in k}
    # one scale for every tensor: a conv bias before BatchNorm has a zero
    # gradient in exact arithmetic, rounding noise in both packages
    gmax = max(float(jg[k].abs().max()) for k in pg)
    worst = _dist(pg, jg, pg) / gmax
    assert worst <= 1e-4, worst
    assert set(ps) == set(js)
    stats_err = _dist(ps, js, js) if js else 0.0
    assert stats_err <= 1e-5
    print(f"{arch}: loss {pm['loss']:.6f} vs {jm['loss']:.6f}; grads worst {worst:.2e} of "
          f"max|g|; BN statistics {stats_err:.2e}")

    # bf16: the port's distance from flax's float32 step at most twice flax's own
    jm16, jg16, js16, _ = _jax_step(arch, variables, images, labels, jnp.bfloat16)
    pm16, pg16, ps16, _, _ = _port_step(arch, variables, images, labels, torch.bfloat16)
    for what, ours, theirs in (
            ("loss", abs(pm16["loss"] - jm["loss"]), abs(jm16["loss"] - jm["loss"])),
            ("grads", _dist(pg16, jg, pg), _dist(jg16, jg, pg)),
            ("stats", _dist(ps16, js, js) if js else 0.0, _dist(js16, js, js) if js else 0.0)):
        print(f"{arch} bf16 {what}: port {ours:.3e}, flax {theirs:.3e} from flax float32")
        assert ours <= 2 * theirs + 1e-12, (what, ours, theirs)


def test_remat_equals_remat_off_and_bf16_gradients_reach_the_parameters():
    """Remat on equals remat off bit for bit, in float32 and in bf16 (whose
    recompute runs on the bf16 copies of the float32 parameters): metrics,
    gradients, BN statistics and num_batches_tracked."""
    variables = zoo.jax_variables("nested_unet", 3, size=SIZE, seed=4, train=True)
    images, labels = _batch(6, 3)
    for dtype in (torch.float32, torch.bfloat16):
        base = _port_step("nested_unet", variables, images, labels, dtype)
        rem = _port_step("nested_unet", variables, images, labels, dtype, remat=True)
        assert base[0] == rem[0], dtype
        for k in base[1]:
            assert torch.equal(base[1][k], rem[1][k]), (dtype, k)
        sd, sd_r = base[3].state_dict(), rem[3].state_dict()
        for k in sd:   # statistics updated once, num_batches_tracked included
            assert torch.equal(sd[k], sd_r[k]), (dtype, k)
        assert int(sd["conv0_0.bn1.num_batches_tracked"]) == 1

    m16, g16, _, model16, _ = base
    assert all(p.dtype == torch.float32 for p in model16.parameters())
    assert all(float(g.abs().max()) > 0 for k, g in g16.items()), \
        [k for k, g in g16.items() if float(g.abs().max()) == 0]
    # the train-mode BN statistics are float32 and moved
    assert model16.conv0_0.bn1.running_var.dtype == torch.float32
    start = torch.from_numpy(variables["batch_stats"]["conv0_0"]["bn1"]["mean"])
    assert not torch.equal(model16.conv0_0.bn1.running_mean, start)


def _two_pass_bn(bn, x):
    """The port's train-mode BN before it took flax's variance: F.batch_norm's
    two-pass variance and its analytic backward (statistics not moved)."""
    import torch.nn.functional as F
    return F.batch_norm(x.float(), None, None, bn.weight, bn.bias, True, 0.0, bn.eps)


def test_train_bn_takes_flax_fast_variance():
    """A channel whose mean is about 100x its spread, where E[x^2] - E[x]^2
    and the two-pass variance part: the port's train-mode BatchNorm equals
    flax's (use_fast_variance, its default) in output, gradients and
    running statistics within 1e-6 relative, and the two-pass form misses.
    The inputs are dyadic with few bits, so the forward's sums are exact in
    float32 and the two packages' summation orders cannot differ; flax runs
    eagerly (its jitted gradient differs from its eager one by 2e-6 here:
    XLA reorders the sums of the input's gradient, whose terms are 100x
    their total)."""
    import flax.linen as fnn
    from unet_tpu_torch.models.blocks import BatchNorm2d

    rng = np.random.default_rng(7)
    n, c, h, w = 2, 3, 2, 4
    spread = rng.integers(-8, 9, size=(n, h, w, c)) / 8.0            # multiples of 1/8
    x = (np.array([100.0, 50.0, 0.0]) + spread).astype(np.float32)   # NHWC
    dy = (rng.integers(-4, 5, size=x.shape) / 4.0).astype(np.float32)
    scale = np.array([1.5, 0.75, 1.0], np.float32)
    bias = np.array([0.25, -0.5, 0.0], np.float32)
    ra_mean = np.array([1.0, 2.0, 0.5], np.float32)
    ra_var = np.array([2.0, 1.0, 0.5], np.float32)

    fbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    fvars = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
             "batch_stats": {"mean": jnp.asarray(ra_mean), "var": jnp.asarray(ra_var)}}

    def f(params, xx):
        y, upd = fbn.apply({"params": params, "batch_stats": fvars["batch_stats"]}, xx,
                           mutable=["batch_stats"])
        return jnp.sum(y * dy), (y, upd["batch_stats"])

    (_, (jy, jstats)), (jgp, jgx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        fvars["params"], jnp.asarray(x))

    bn = BatchNorm2d(c, eps=1e-5).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(ra_mean))
        bn.running_var.copy_(torch.from_numpy(ra_var))
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))

    def run(fn):
        xt = nchw(x).requires_grad_(True)
        for p in bn.parameters():
            p.grad = None
        y = fn(xt)
        (y * nchw(dy)).sum().backward()
        return (y.detach().permute(0, 2, 3, 1).numpy(), xt.grad.permute(0, 2, 3, 1).numpy(),
                bn.weight.grad.numpy().copy(), bn.bias.grad.numpy().copy())

    def rel(a, b):
        b = np.asarray(b)
        return float(np.abs(np.asarray(a) - b).max() / max(np.abs(b).max(), 1e-30))

    want = (jy, jgx, jgp["scale"], jgp["bias"])
    got = run(bn)
    errs = [rel(g, w_) for g, w_ in zip(got, want)]
    errs += [rel(bn.running_mean.numpy(), jstats["mean"]),
             rel(bn.running_var.numpy(), jstats["var"])]
    print("port vs flax (y, dx, dscale, dbias, running mean, running var):", errs)
    assert max(errs) <= 1e-6, errs

    two_pass = run(lambda t: _two_pass_bn(bn, t))
    misses = [rel(g, w_) for g, w_ in zip(two_pass, want)]
    print("two-pass vs flax (y, dx, dscale, dbias):", misses)
    assert misses[0] > 1e-6 and misses[1] > 1e-6, misses
