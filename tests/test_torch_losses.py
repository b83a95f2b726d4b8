"""The port's losses (unet_tpu_torch.models.losses) and segmentation metrics
(unet_tpu_torch.ops.seg_metrics) against the JAX package's on the same
numpy draws: every loss's value and its gradient with respect to the
logits, at tests/test_losses.py's tolerances; the confusion matrix equal as
integers, the loop's padding label included; the host finalisation equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_tpu.models import losses as JL
from unet_tpu.ops import seg_metrics as jseg
from unet_tpu_torch.models import losses as L
from unet_tpu_torch.ops import seg_metrics as seg

W4 = np.array([0.02, 1.0, 1.0, 2.0], np.float32)
# name: (JAX loss of (logits NHWC, labels), port loss of (logits NCHW, labels), value tolerance)
CASES = {
    "dice": (lambda lg, lb: JL.dice_loss(lg, lb), lambda lg, lb: L.dice_loss(lg, lb), 1e-5),
    "dice_weighted": (lambda lg, lb: JL.dice_loss(lg, lb, class_weights=jnp.asarray(W4)),
                      lambda lg, lb: L.dice_loss(lg, lb, class_weights=W4), 1e-5),
    "dice_keep_bg": (lambda lg, lb: JL.dice_loss(lg, lb, ignore_bg=False, skip_empty=False),
                     lambda lg, lb: L.dice_loss(lg, lb, ignore_bg=False, skip_empty=False), 1e-5),
    "focal": (lambda lg, lb: JL.focal_loss(lg, lb), lambda lg, lb: L.focal_loss(lg, lb), 2e-5),
    "focal_alpha": (lambda lg, lb: JL.focal_loss(lg, lb, alpha=jnp.asarray(W4)),
                    lambda lg, lb: L.focal_loss(lg, lb, alpha=W4), 2e-5),
    "focal_ignore": (lambda lg, lb: JL.focal_loss(lg, lb, ignore_index=3),
                     lambda lg, lb: L.focal_loss(lg, lb, ignore_index=3), 2e-5),
    "tversky": (lambda lg, lb: JL.tversky_loss(lg, lb), lambda lg, lb: L.tversky_loss(lg, lb),
                2e-5),
    "cross_entropy": (lambda lg, lb: JL.cross_entropy_loss(lg, lb),
                      lambda lg, lb: L.cross_entropy_loss(lg, lb), 2e-5),
    "cross_entropy_weighted": (lambda lg, lb: JL.cross_entropy_loss(lg, lb, jnp.asarray(W4)),
                               lambda lg, lb: L.cross_entropy_loss(lg, lb, W4), 2e-5),
    "combined": (lambda lg, lb: JL.combined_loss(lg, lb, class_weights=jnp.asarray(W4))[0],
                 lambda lg, lb: L.combined_loss(lg, lb, class_weights=W4)[0], 2e-5),
    "advanced": (lambda lg, lb: JL.advanced_combined_loss(
                     lg, lb, weight_focal=0.35, weight_tversky=0.45, weight_dice=0.20,
                     tversky_alpha=0.25, tversky_beta=0.75, class_weights=jnp.asarray(W4))[0],
                 lambda lg, lb: L.advanced_combined_loss(
                     lg, lb, weight_focal=0.35, weight_tversky=0.45, weight_dice=0.20,
                     tversky_alpha=0.25, tversky_beta=0.75, class_weights=W4)[0], 2e-5),
    "deep_supervision": (
        lambda lg, lb: JL.deep_supervision_loss(
            [lg, lg * 0.5, lg * 0.2, lg * 0.1], lb, JL.advanced_combined_loss)[0],
        lambda lg, lb: L.deep_supervision_loss(
            [lg, lg * 0.5, lg * 0.2, lg * 0.1], lb, L.advanced_combined_loss)[0], 2e-5),
}


def _data(seed: int, empty: bool = False):
    r = np.random.default_rng(seed)
    logits = r.normal(size=(2, 16, 16, 4)).astype(np.float32)
    labels = (r.random((2, 16, 16)) * 4).astype(np.int64)
    if empty:    # all background: dice's all-empty fallback
        labels[:] = 0
    return logits, labels


@pytest.mark.parametrize("empty", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_value_and_gradient_match_jax(name, empty):
    jfn, fn, tol = CASES[name]
    logits, labels = _data(1234 + len(name), empty)
    want, jgrad = jax.value_and_grad(jfn)(jnp.asarray(logits), jnp.asarray(labels))
    x = torch.from_numpy(logits.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    got = fn(x, torch.from_numpy(labels))
    got.backward()
    got = got.detach()
    assert abs(float(got) - float(want)) < tol, (float(got), float(want))
    g, jg = x.grad.numpy().transpose(0, 2, 3, 1), np.asarray(jgrad)
    err = float(np.abs(g - jg).max())
    print(f"{name} empty={empty}: |loss diff| {abs(float(got) - float(want)):.2e}, "
          f"|grad diff| {err:.2e} of max {np.abs(jg).max():.2e}")
    assert err <= 1e-4 * np.abs(jg).max() + 1e-9


def test_combination_components_match_jax():
    logits, labels = _data(7)
    jl, jb = jnp.asarray(logits), jnp.asarray(labels)
    x, y = torch.from_numpy(logits.transpose(0, 3, 1, 2).copy()), torch.from_numpy(labels)
    for want, got in ((JL.combined_loss(jl, jb, 0.7, 1.3, jnp.asarray(W4)),
                       L.combined_loss(x, y, 0.7, 1.3, W4)),
                      (JL.advanced_combined_loss(jl, jb, tversky_alpha=0.25, tversky_beta=0.75),
                       L.advanced_combined_loss(x, y, tversky_alpha=0.25, tversky_beta=0.75))):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert abs(float(g) - float(w)) < 2e-5
    total, comps = L.deep_supervision_loss([x, x * 0.5], y, L.advanced_combined_loss,
                                           weights=(0.4, 0.6))
    jtotal, jcomps = JL.deep_supervision_loss([jl, jl * 0.5], jb, JL.advanced_combined_loss,
                                              weights=(0.4, 0.6))
    assert abs(float(total) - float(jtotal)) < 2e-5 and len(comps) == len(jcomps) == 3


@pytest.mark.parametrize("num_classes", [3, 7])
def test_confusion_matrix_equal_with_the_padding_label(num_classes):
    r = np.random.default_rng(num_classes)
    pred = r.integers(0, num_classes, (3, 24, 40))
    target = r.integers(0, num_classes, (3, 24, 40))
    target[2] = num_classes            # a padded sample, as the train loop pads the eval
    target[0, :4] = num_classes
    want = np.asarray(jseg.confusion_matrix(jnp.asarray(pred), jnp.asarray(target),
                                            num_classes))
    got = seg.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(target), num_classes)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == int((target < num_classes).sum())
    assert seg.compute_metrics(pred, target, num_classes) == jseg.compute_metrics(
        pred, target, num_classes)


def test_metrics_from_confusion_conventions_match_jax(capsys):
    # an absent class predicted (IoU 0) and an absent class not predicted (IoU 1)
    cm = np.array([[50, 3, 0, 2], [4, 40, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]], np.int64)
    cm[0, 3] = 0
    cm[1, 3] = 5
    assert seg.metrics_from_confusion(cm) == jseg.metrics_from_confusion(cm)
    seg.print_metrics(*seg.metrics_from_confusion(cm))
    ours = capsys.readouterr().out
    jseg.print_metrics(*jseg.metrics_from_confusion(cm))
    assert ours == capsys.readouterr().out
