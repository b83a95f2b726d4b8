"""convert_orbax.py: orbax directories the JAX package writes
(`save_variables` of a NestedUNet and of a SimpleUNet, and `save_checkpoint`
of a NestedUNet train state with its deep-supervision heads) turned into
.pth files that the port's `cli.main.load_model` reads, its family found
from the arrays, with logits within the gate of tests/test_models_parity.py
(atol/rtol 1e-3) of the JAX package's `apply`."""
import jax.numpy as jnp
import numpy as np
import pytest

import convert_orbax
from tests import torch_zoo as zoo
from tests.torch_threads import one_intra_op_thread  # noqa: F401
from unet_tpu.core.checkpoint import save_checkpoint, save_variables
from unet_tpu.train import trainer as jt
from unet_tpu_torch.cli.main import load_model

SIZE = 32


def _x():
    return np.random.default_rng(2).random((2, SIZE, SIZE, 3), dtype=np.float32)


@pytest.mark.parametrize("arch,classes", [("nested_unet", 3), ("simple_unet", 7)])
def test_save_variables_directory_converts(tmp_path, arch, classes):
    variables = zoo.jax_variables(arch, classes, size=SIZE, seed=6)
    save_variables(str(tmp_path / "ckpt"), variables)
    out = tmp_path / "m.pth"
    assert convert_orbax.main([str(tmp_path / "ckpt"), str(out)]) == 0
    assert (tmp_path / "m.meta.json").is_file()
    model, n, kind = load_model(str(out), "lightweight", "float32", 99)
    assert (n, kind) == (classes, arch)
    np.testing.assert_allclose(zoo.port_logits(model, _x()),
                               zoo.jax_logits(arch, variables, _x(), classes),
                               atol=1e-3, rtol=1e-3)


def test_save_checkpoint_directory_converts(tmp_path):
    variables = zoo.jax_variables("nested_unet", 3, size=SIZE, seed=8, train=True)
    jm = zoo.jax_model("nested_unet", 3, deep_supervision=True)
    tx = jt.build_optimizer(jt.OptimCfg(accum_steps=2))
    state = jt.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]), apply_fn=jm.apply, tx=tx)
    save_checkpoint(str(tmp_path), state, epoch=3, best_miou=0.5, name="best")
    out = tmp_path / "conv" / "best.pth"
    assert convert_orbax.convert(str(tmp_path / "best"), str(out)) == {
        "arch": "nested_unet", "num_classes": 3}
    model, n, kind = load_model(str(out), "simple_unet", "float32", 99)
    assert (n, kind) == (3, "nested_unet") and model.deep_supervision
    np.testing.assert_allclose(zoo.port_logits(model, _x()),
                               zoo.jax_logits("nested_unet", variables, _x(), 3),
                               atol=1e-3, rtol=1e-3)
    with pytest.raises(SystemExit, match="not an orbax"):
        convert_orbax.convert(str(tmp_path / "missing"), str(out))
