"""The port's AdamW (train.trainer.AdamW) after optax's clip_by_global_norm,
held bit for bit against un-jitted optax.chain(clip_by_global_norm, adamw)
over 200 steps of seeded float32 gradients, and its distance to the jitted
chain reported (XLA may contract products into sums there)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.torch_threads import one_intra_op_thread  # noqa: F401
from unet_tpu_torch.train import trainer as T

SHAPES = [(16, 3, 3, 3), (16,), (32, 16, 3, 3), (32,), (3, 32, 1, 1), (3,)]
STEPS = 200


def _grads(seed: int):
    """Gradients on a dyadic grid: k / 2^10 (steps that clip) or k / 2^12
    (steps that do not), |k| <= 64. Their squares sum exactly in any order,
    so the global norm is the correctly rounded square root whatever the
    reduction order (XLA's and torch's differ for general floats)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        scale = 2.0 ** -(10 if rng.random() < 0.5 else 12)
        out.append([(rng.integers(-64, 65, s) * scale).astype(np.float32) for s in SHAPES])
    return out


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max())


def _run(cfg: T.OptimCfg, grads, jit: bool):
    """(port parameters, optax parameters) after every step, and whether
    each step clipped."""
    rng = np.random.default_rng(7)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    sched = T.build_schedule(cfg)
    table = jnp.asarray(np.array([sched(n) for n in range(STEPS + 1)], np.float32))
    tx = optax.chain(optax.clip_by_global_norm(cfg.clip_norm),
                     optax.adamw(lambda c: table[c], weight_decay=cfg.weight_decay))
    jp = [jnp.asarray(p) for p in p0]
    st = tx.init(jp)

    def update(g, st, p):
        u, st = tx.update(g, st, p)
        return optax.apply_updates(p, u), st

    if jit:
        update = jax.jit(update)
    tp = [torch.from_numpy(p.copy()) for p in p0]
    opt, lr = T.build_optimizer(tp, cfg)
    pairs, clipped = [], []
    for g in grads:
        jp, st = update([jnp.asarray(x) for x in g], st, jp)
        tg = [torch.from_numpy(x.copy()) for x in g]
        clipped.append(float(T.global_norm(tg)) >= cfg.clip_norm)
        T.clip_by_global_norm(tg, cfg.clip_norm)
        for p, x in zip(tp, tg):
            p.grad = x
        opt.step()
        lr.step()
        pairs.append(([p.numpy().copy() for p in tp], [np.asarray(p) for p in jp]))
    return pairs, clipped


@pytest.mark.parametrize("schedule", ["constant", "onecycle"])
def test_adamw_is_optax_bit_for_bit(schedule):
    cfg = T.OptimCfg(lr=1e-3 if schedule == "constant" else 2e-4, weight_decay=1e-4,
                     schedule=schedule, total_steps=STEPS, clip_norm=1.0)
    pairs, clipped = _run(cfg, _grads(0), jit=False)
    assert 20 < sum(clipped) < STEPS - 20      # both branches of the clip
    for n, (ours, ref) in enumerate(pairs):
        for a, b in zip(ours, ref):
            assert np.array_equal(a, b), f"step {n}: {_ulps(a, b)} ulp"
    jitted = _run(cfg, _grads(0), jit=True)[0]
    d = [(_ulps(a, b), float(np.abs(a - b).max())) for (ours, _), (_, rs) in zip(pairs, jitted)
         for a, b in zip(ours, rs)]
    print(f"{schedule}: bit-identical to un-jitted optax over {STEPS} steps "
          f"({sum(clipped)} clipped); largest distance to the jitted chain "
          f"{max(u for u, _ in d)} ulp, {max(e for _, e in d):.3e} absolute")


def test_adamw_state_loads_a_torch_adamw_state():
    """A checkpoint written by torch.optim.AdamW resumes: the state keeps its
    names (`step`, `exp_avg`, `exp_avg_sq`)."""
    p = [torch.nn.Parameter(torch.ones(3))]
    old = torch.optim.AdamW(p, lr=1.0, weight_decay=1e-4)
    p[0].grad = torch.full((3,), 0.5)
    old.step()
    new = T.AdamW([p[0]], lr=1.0)
    new.load_state_dict(old.state_dict())
    st = new.state[p[0]]
    assert float(st["step"]) == 1.0 and st["exp_avg"].shape == (3,)
    new.step()
    assert float(new.state[p[0]]["step"]) == 2.0
