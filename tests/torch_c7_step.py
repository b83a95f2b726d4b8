"""ROADMAP C7, the comparison at one late step: both packages from the same
state, on the CPU. The JAX package runs `overfit_test`'s recipe (the
tests/torch_overfit_spread.py run: 10 samples at 128^2 with the flip and
brightness of `np.random.default_rng(seed)`, cross-entropy, adamw at a
constant 1e-3, clipping at 10) from `PRNGKey(0)` for `--at` steps; the port
takes that state (parameters, BatchNorm statistics, and Adam's moments and
count). Then, from the same state and the same batch:

  * the loss and its reduction: both forwards' logits, each package's mean
    of the per-pixel cross-entropy, and each package's mean of the SAME
    per-pixel values (the JAX package's), which isolates the reduction's
    order
  * the backward: each parameter's float32 gradient, its distance from the
    JAX package's relative to its norm, the global norm
  * the update: each package's parameters after the step (the conv
    biases before BatchNorm left out: their gradients are rounding noise,
    which Adam scales up to steps of the learning rate)
  * the next `--then` steps of both packages from there: the losses, a
    bump (tests/torch_overfit_spread.py `bumps`) in either, and each
    package's eval mIoU after them (the recipe's gate is 0.98 after 200)

    python tests/torch_c7_step.py --seed 18 --at 180 --then 20

Prints one JSON object per part and a summary line. The JAX run takes
about a second a step on 4 CPU cores.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm((a - b).ravel()) / max(np.linalg.norm(b.ravel()), 1e-30))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=18)
    ap.add_argument("--at", type=int, default=180)
    ap.add_argument("--then", type=int, default=20)
    ap.add_argument("--size", type=int, default=128)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import optax
    import torch

    import chip_smoke
    from tests import torch_overfit_spread as spread
    from unet_tpu.train import trainer as jt
    from unet_tpu_torch.models import NestedUNet
    from unet_tpu_torch.models.blocks import fp32_convs
    from unet_tpu_torch.models.convert import state_dict_from_flax
    from unet_tpu_torch.ops.seg_metrics import metrics_from_confusion
    from unet_tpu_torch.train import trainer as T

    with tempfile.TemporaryDirectory(prefix="c7_step_") as tmp:
        root = chip_smoke.write_split(Path(tmp), 40, 1, 448, 800, seed=300)
        images, labels = spread._samples("jax", root, args.size, args.seed)
        pimages, plabels = spread._samples("torch", root, args.size, args.seed)
    same_samples = bool(np.array_equal(images, pimages) and np.array_equal(labels, plabels))

    # -- the JAX package to step `at`
    state = spread._jax_state(args.size)
    jstep = jax.jit(jt.make_train_step(jt.LossCfg(kind="ce")))
    t = time.time()
    losses = []
    for _ in range(args.at):
        state, m = jstep(state, images, labels)
        losses.append(float(m["loss"]))
    print(json.dumps(dict(part="jax run", steps=args.at, seconds=round(time.time() - t, 1),
                          loss_at={s: losses[s] for s in (0, args.at // 2, args.at - 1)},
                          same_samples=same_samples)), flush=True)

    # -- the port from the same state
    model = NestedUNet(3, deep_supervision=False)
    model.load_state_dict(state_dict_from_flax({"params": state.params,
                                                "batch_stats": state.batch_stats}))
    adam = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    mu = state_dict_from_flax({"params": adam.mu, "batch_stats": state.batch_stats})
    nu = state_dict_from_flax({"params": adam.nu, "batch_stats": state.batch_stats})
    pstate = T.create_train_state(model, T.OptimCfg(lr=spread.LR, schedule="constant",
                                                    total_steps=spread.STEPS,
                                                    clip_norm=spread.CLIP), "cpu")
    names = [k for k, _ in model.named_parameters()]
    for name, p in zip(names, pstate.params):
        pstate.optimizer.state[p] = {"step": torch.tensor(float(adam.count), dtype=torch.float32),
                                     "exp_avg": mu[name].clone(), "exp_avg_sq": nu[name].clone()}
    im, lb = T.upload(images, labels, "cpu")

    # -- the forward, the loss and its reduction
    def jax_compute(params):
        outs, mut = state.apply_fn({"params": params, "batch_stats": state.batch_stats},
                                   jnp.asarray(images), train=True, mutable=["batch_stats"])
        return jt.make_loss_fn(jt.LossCfg(kind="ce"))(outs, jnp.asarray(labels))[0], outs

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(jax_compute, has_aux=True))(
        state.params)
    jlogits = np.asarray(jlogits).transpose(0, 3, 1, 2)
    model.train()
    for p in pstate.params:
        p.grad = None
    with fp32_convs():
        plogits = model(im)
        ploss, _ = T.make_loss_fn(T.LossCfg(kind="ce"))(plogits, lb)
        ploss.backward()
    nll = -np.take_along_axis(np.asarray(jax.nn.log_softmax(jnp.asarray(jlogits), axis=1)),
                              labels[:, None].astype(np.int64), axis=1)[:, 0]
    red = dict(jax_mean=float(jnp.mean(jnp.asarray(nll))),
               torch_mean=float(torch.from_numpy(nll).mean()),
               float64_mean=float(nll.astype(np.float64).mean()))
    print(json.dumps(dict(
        part="loss", jax=float(jloss), port=float(ploss.detach()),
        diff=float(ploss.detach()) - float(jloss),
        logits_max_abs_diff=float(np.abs(plogits.detach().numpy() - jlogits).max()),
        logits_rel=_rel(plogits.detach().numpy(), jlogits),
        reduction_of_the_same_values=red)), flush=True)

    # -- the backward's float32 gradients
    jg = state_dict_from_flax({"params": jgrads, "batch_stats": state.batch_stats})
    rows = {n: _rel(p.grad.numpy(), jg[n].numpy()) for n, p in zip(names, pstate.params)}
    # a conv's bias before BatchNorm has a zero gradient in exact arithmetic:
    # both packages' are rounding noise, left out of the per-tensor ranking
    ranked = {n: v for n, v in rows.items() if not re.fullmatch(r"conv\d_\d\.conv\d\.bias", n)}
    worst = sorted(ranked.items(), key=lambda kv: -kv[1])[:5]
    gp = float(np.sqrt(sum(float((p.grad.double() ** 2).sum()) for p in pstate.params)))
    gj = float(np.sqrt(sum(float((jg[n].double() ** 2).sum()) for n in names)))
    total = float(np.sqrt(sum(float(((p.grad.double() - jg[n].double()) ** 2).sum())
                              for n, p in zip(names, pstate.params)))) / gj
    print(json.dumps(dict(part="gradients", tensors=len(rows), global_rel=total,
                          median_rel=float(np.median(list(ranked.values()))), worst=worst,
                          norm_port=gp, norm_jax=gj)), flush=True)

    # -- the update, then `then` more steps of both
    pstep = T.make_train_step(T.LossCfg(kind="ce"))
    jl, pl = [], []
    for i in range(args.then):
        state, m = jstep(state, images, labels)
        jl.append(float(m["loss"]))
        pstate, pm = pstep(pstate, im, lb)
        pl.append(float(pm["loss"]))
        if i == 0:
            jp = state_dict_from_flax({"params": state.params, "batch_stats": state.batch_stats})
            upd = {n: _rel(p.detach().numpy(), jp[n].numpy())
                   for n, p in zip(names, pstate.params) if n in ranked}
            print(json.dumps(dict(part="update", params_rel_median=float(np.median(
                list(upd.values()))), worst=sorted(upd.items(), key=lambda kv: -kv[1])[:3])),
                  flush=True)
    full_j, full_p = losses + jl, losses + pl
    jcm = np.asarray(jax.jit(jt.make_eval_step(3))(state, images, labels), np.int64)
    pcm = T.make_eval_step(3)(pstate, im, lb).cpu().numpy()
    print(json.dumps(dict(part="next steps", jax=jl, port=pl,
                          rel_diff=[abs(a - b) / b for a, b in zip(pl, jl)],
                          bumps_jax=[b for b in spread.bumps(full_j) if b >= args.at],
                          bumps_port=[b for b in spread.bumps(full_p) if b >= args.at],
                          miou_jax=float(metrics_from_confusion(jcm)[0]),
                          miou_port=float(metrics_from_confusion(pcm)[0]))), flush=True)
    print(f"C7 at step {args.at} of seed {args.seed}: loss {float(jloss):.7f} (JAX) vs "
          f"{float(ploss.detach()):.7f} (port); gradients {total:.2e} apart relative to their norm")
    return 0


if __name__ == "__main__":
    sys.exit(main())
