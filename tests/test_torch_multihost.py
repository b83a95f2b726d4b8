"""The port's multi-process layer (unet_tpu_torch.parallel.multihost) on the
CPU: `ProcessShardedLoader` slices against the JAX package's for process 0
and 1 (explicit indices, no jax.distributed); `train_model` over 2 gloo
ranks against 1 rank, augmentation off (the logged mIoU within 1e-3 each
epoch, losses within 1e-4, the same best epoch and worst samples, files
written once, by rank 0); and `MultiStreamServer(mesh=...)` over 2 ranks and 4
streams against the server without a mesh (every (stream, frame) once,
the same result)."""
from pathlib import Path

import numpy as np
import pytest

from chip_smoke import write_split
from tests import torch_dist as td
from tests.torch_threads import one_intra_op_thread  # noqa: F401
from unet_tpu.data.loader import Loader as JLoader
from unet_tpu.parallel.multihost import ProcessShardedLoader as JProcessShardedLoader
from unet_tpu_torch.data.loader import Loader
from unet_tpu_torch.parallel import multihost


class _DS:
    def __len__(self):
        return 13

    def __getitem__(self, i):
        r = np.random.default_rng(i)
        return r.random((4, 4, 3), np.float32), (r.random((4, 4)) * 3).astype(np.int32)


@pytest.mark.parametrize("weighted", [False, True])
def test_process_sharded_loader_slices_equal_the_jax_package(weighted):
    w = np.linspace(1, 2, 13) / np.linspace(1, 2, 13).sum() if weighted else None
    for pid in (0, 1):
        ours = multihost.ProcessShardedLoader(
            Loader(_DS(), 4, shuffle=True, weights=w, seed=5, prefetch=0), pid, 2)
        theirs = JProcessShardedLoader(
            JLoader(_DS(), 4, shuffle=True, weights=w, seed=5, prefetch=0), pid, 2)
        assert (len(ours), ours.local_batch) == (len(theirs), theirs.local_batch) == (3, 2)
        for _ in range(2):   # two epochs: the index stream moves on alike
            got, want = list(ours), list(theirs)
            assert len(got) == len(want) == 3
            for (a, b), (c, d) in zip(got, want):
                assert np.array_equal(a, c) and np.array_equal(b, d)
    with pytest.raises(ValueError, match="not divisible"):
        multihost.ProcessShardedLoader(Loader(_DS(), 3), 0, 2)


def test_train_model_over_two_ranks_equals_one(tmp_path):
    """8 train scenes (2 global batches of 4 an epoch) and 3 val scenes (a
    ragged eval batch, padded), 2 epochs of 3class_advanced at 32^2."""
    root = write_split(tmp_path / "split", 8, 3, 40, 56)
    two = td.run_ranks(tmp_path, 2, "loop_ranks", root, str(tmp_path / "w2"), 2, 4)
    one = td.run_ranks(tmp_path, 1, "loop_ranks", root, str(tmp_path / "w1"), 2, 4)[0]
    lead, other = two
    h2, h1 = lead["history"], one["history"]
    # the logged mIoU within 1e-3: the models differ in the last bits of
    # their weights, which flips the argmax of a few near-tie pixels of a
    # barely trained model (about 1e-4 of mIoU here)
    np.testing.assert_allclose(h2["miou"], h1["miou"], rtol=0, atol=1e-3)
    assert abs(lead["best_miou"] - one["best_miou"]) <= 1e-3
    assert int(np.argmax(h2["miou"])) == int(np.argmax(h1["miou"]))
    np.testing.assert_allclose(h2["loss"], h1["loss"], rtol=1e-4)
    assert lead["epochs_run"] == other["epochs_run"] == 2
    assert other["final_miou"] == lead["final_miou"]
    # rank 0 writes every checkpoint, rank 1 none
    assert lead["saved"] == one["saved"] and "last" in lead["saved"] and other["saved"] == []
    assert sorted(p.name for p in Path(tmp_path / "w2").iterdir()) == \
        sorted(p.name for p in Path(tmp_path / "w1").iterdir())
    # the worst samples of the global batch, gathered from both ranks
    assert {name for _, name in lead["worst"]["worst"]} == \
        {name for _, name in one["worst"]["worst"]}
    print(f"2 ranks vs 1: mIoU {h2['miou']} vs {h1['miou']}; loss {h2['loss']} vs {h1['loss']}")


def test_multistream_server_over_two_ranks_equals_no_mesh(tmp_path):
    lead, other = td.run_ranks(tmp_path, 2, "serve_ranks", 4, 6)
    want = td.serve_results(4, 6)
    got = lead["results"]
    assert sorted(got) == sorted(want["results"]) and len(got) == 24
    for key, w in want["results"].items():
        g = got[key]
        assert g[:3] == w[:3], key
        np.testing.assert_allclose(g[3:5], w[3:5], rtol=1e-6, err_msg=str(key))
        assert np.array_equal(g[5], w[5]), key
    assert other["results"] == {} and other["stats"]["batches"] == lead["stats"]["batches"]
    assert lead["stats"]["frames"] == 24
