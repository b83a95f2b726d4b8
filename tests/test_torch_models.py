"""The port's NestedUNet and weight converter against the JAX package:
flax weights carried across give the same logits (atol/rtol 1e-3, identical
argmax -- the gate of tests/test_models_parity.py), and a reference state
dict survives the round trip through both converters exactly."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from tests.torch_ref import TNestedUNet
from unet_tpu.models import NestedUNet as JNestedUNet
from unet_tpu.models import convert as jconvert
from unet_tpu_torch.models import NestedUNet
from unet_tpu_torch.models.convert import state_dict_from_flax


def test_nested_unet_flax_weights_parity():
    jm = JNestedUNet(num_classes=3, deep_supervision=True)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                                 jnp.zeros((1, 64, 64, 3)), train=False))
    r = np.random.default_rng(0)
    for node in variables["batch_stats"].values():   # exercise BN's statistics
        for bn in node.values():
            bn["mean"] = r.normal(0, 0.2, bn["mean"].shape).astype(np.float32)
            bn["var"] = r.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    x = r.normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))

    tm = NestedUNet(num_classes=3, deep_supervision=False).eval()
    tm.load_state_dict(state_dict_from_flax(variables))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    got = got.transpose(0, 2, 3, 1)
    # f32 conv accumulation order differs between XLA and torch: ~1e-3
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_state_dict_round_trip_exact():
    gen = torch.Generator().manual_seed(0)
    ref = TNestedUNet(num_classes=3, deep_supervision=True)
    for m in ref.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(torch.randn(m.num_features, generator=gen))
            m.running_var.copy_(torch.rand(m.num_features, generator=gen) + 0.5)
    sd = ref.state_dict()
    back = state_dict_from_flax(jconvert.convert_state_dict(
        {k: v.numpy() for k, v in sd.items()}))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k

    # the port's module has the reference's keys: the dict loads strictly and
    # both modules compute the same function
    port = NestedUNet(num_classes=3, deep_supervision=True)
    port.load_state_dict(back)
    x = torch.randn(1, 3, 32, 32, generator=gen)
    with torch.inference_mode():
        assert torch.equal(port.eval()(x), ref.eval()(x))
    port.train()
    ref.train()
    outs, wants = port(x), ref(x)
    assert len(outs) == 4
    for o, w in zip(outs, wants):
        assert torch.equal(o, w)
