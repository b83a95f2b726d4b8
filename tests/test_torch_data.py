"""The port's data layer (unet_tpu_torch.data: datasets, augment pipelines,
Loader) against the JAX package's on the same files and seeds: every
sample and batch bit-identical, the loaders' order included."""
import cv2
import numpy as np
import pytest

from unet_tpu.data import augment as jaug
from unet_tpu.data import dataset as jds
from unet_tpu.data import loader as jld
from unet_tpu_torch.data import augment as aug
from unet_tpu_torch.data import dataset as ds
from unet_tpu_torch.data import loader as ld

H, W = 40, 56


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A labelled split of 7 cable scenes (png and jpg) with 7-class masks,
    and two hard negatives."""
    root = tmp_path_factory.mktemp("split")
    for sub in ("images", "masks", "negatives"):
        (root / sub).mkdir()
    r = np.random.default_rng(0)
    for i in range(7):
        img = r.integers(30, 90, (H, W, 3)).astype(np.uint8)
        mask = np.zeros((H, W), np.uint8)
        x = int(r.integers(10, 30))
        mask[:, x:x + 12] = 1
        img[:, x:x + 12] = (175, 180, 180)
        mask[10:22, x - 2:x + 14] = 2
        img[10:22, x - 2:x + 14] = (200, 90, 60)
        if i % 2:
            mask[26:30, x + 3:x + 7] = 3 + i % 4
        cv2.imwrite(str(root / "images" / f"f{i}.{'png' if i % 3 else 'jpg'}"), img)
        cv2.imwrite(str(root / "masks" / f"f{i}.png"), mask)
    for i in range(2):
        cv2.imwrite(str(root / "negatives" / f"n{i}.png"),
                    r.integers(0, 255, (H, W, 3)).astype(np.uint8))
    return root


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _pair(cls_port, cls_jax, *args, **kw):
    return (cls_port(*args, rng=np.random.default_rng(5), **kw),
            cls_jax(*args, rng=np.random.default_rng(5), **kw))


@pytest.mark.parametrize("kind", ["plain", "augment", "remap", "advanced", "three_class",
                                  "patch"])
def test_datasets_match_jax(root, kind):
    im, mk = str(root / "images"), str(root / "masks")
    if kind == "advanced":
        a, b = _pair(ds.AdvancedDataset, jds.AdvancedDataset, im, mk, target_size=(32, 48),
                     tape_crop_prob=0.5, hard_negative_dir=str(root / "negatives"),
                     hard_negative_prob=0.3)
    elif kind == "three_class":
        a, b = (ds.three_class_dataset(im, mk, target_size=(32, 32),
                                       rng=np.random.default_rng(2)),
                jds.three_class_dataset(im, mk, target_size=(32, 32),
                                        rng=np.random.default_rng(2)))
    elif kind == "patch":
        a, b = _pair(ds.PatchDefectDataset, jds.PatchDefectDataset, im, mk, patch_size=24,
                     jitter=6)
    else:
        a, b = _pair(ds.SegmentationDataset, jds.SegmentationDataset, im, mk,
                     augment=kind == "augment", target_size=(32, 48),
                     class_remap=jds.REMAP_7_TO_3 if kind == "remap" else None)
    assert len(a) == len(b) and getattr(a, "image_files", None) == getattr(b, "image_files", None)
    for _ in range(3):
        for i in range(len(a)):
            _same(a[i], b[i])
    if kind in ("plain", "augment"):
        np.testing.assert_array_equal(a.sample_weights(boost=3.0), b.sample_weights(boost=3.0))


@pytest.mark.parametrize("name", ["AugmentationPipeline", "StrongAugmentationPipeline",
                                  "WeakAugmentationPipeline"])
def test_augment_pipelines_match_jax(name):
    r = np.random.default_rng(1)
    image = r.integers(0, 255, (H, W, 3)).astype(np.uint8)
    mask = r.integers(0, 7, (H, W)).astype(np.uint8)
    ours = getattr(aug, name)(rng=np.random.default_rng(9))
    theirs = getattr(jaug, name)(rng=np.random.default_rng(9))
    for _ in range(40):
        _same(ours(image, mask), theirs(image, mask))


def test_fog_and_rain_match_jax():
    image = np.random.default_rng(2).integers(0, 255, (64, 80, 3)).astype(np.uint8)
    for coef in (0.1, 0.3):
        _same([aug.random_fog(image, coef, np.random.default_rng(3))],
              [jaug.random_fog(image, coef, np.random.default_rng(3))])
    for slant in (-10, 0, 7):
        _same([aug.random_rain(image, slant, np.random.default_rng(4))],
              [jaug.random_rain(image, slant, np.random.default_rng(4))])


@pytest.mark.parametrize("kw", [dict(shuffle=True, drop_last=True),
                                dict(shuffle=False, prefetch=0),
                                dict(shuffle=True, with_indices=True, prefetch=1),
                                dict(weighted=True)], ids=str)
def test_loader_order_and_batches_match_jax(root, kw):
    kw = dict(kw)
    weighted = kw.pop("weighted", False)
    a, b = _pair(ds.SegmentationDataset, jds.SegmentationDataset, str(root / "images"),
                 str(root / "masks"), augment=True, target_size=(24, 24))
    w = a.sample_weights() if weighted else None
    la = ld.Loader(a, 3, seed=11, weights=w, **kw)
    lb = jld.Loader(b, 3, seed=11, weights=w, **kw)
    assert len(la) == len(lb)
    for _ in range(2):
        got, want = list(la), list(lb)
        assert len(got) == len(want)
        for x, y in zip(got, want):
            _same(x, y)


def test_train_val_loaders_match_jax(root):
    args = (str(root / "images"), str(root / "masks"))
    ours = ld.make_train_val_loaders(ds.SegmentationDataset(*args, target_size=(24, 24)),
                                     ds.SegmentationDataset(*args, target_size=(24, 24)),
                                     2, oversample_defects=True, seed=3)
    theirs = jld.make_train_val_loaders(jds.SegmentationDataset(*args, target_size=(24, 24)),
                                        jds.SegmentationDataset(*args, target_size=(24, 24)),
                                        2, oversample_defects=True, seed=3)
    for la, lb in zip(ours, theirs):
        assert (la.batch_size, la.drop_last, la.shuffle) == (lb.batch_size, lb.drop_last,
                                                             lb.shuffle)
        for x, y in zip(list(la), list(lb)):
            _same(x, y)
