"""Shared helpers of the model-zoo parity tests (tests/test_torch_models_zoo.py,
tests/test_torch_zoo_steps.py) and of tests/torch_zoo_bf16_agreement.py:
every `--arch` of the CLI built in both packages, the JAX package's
variables initialised under jit with BatchNorm statistics, scales and biases
drawn from a numpy seed, and carried into the port's model by
`state_dict_from_flax`."""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import torch

from unet_tpu.models import LightweightNestedUNet as JLightweight
from unet_tpu.models import NestedUNet as JNestedUNet
from unet_tpu.models import SimpleUNet as JSimpleUNet
from unet_tpu_torch.cli.main import _build_model
from unet_tpu_torch.models import LightweightNestedUNet
from unet_tpu_torch.models.convert import state_dict_from_flax

ENCODERS = ("custom", "resnet18", "resnet34", "mobilenet_v3_small", "mobilenet_v3_large",
            "shufflenet_v2_x1_0")
ARCHS = ("nested_unet_resnet50", "simple_unet") + tuple(f"lightweight:{e}" for e in ENCODERS)
# the logits gates of tests/test_models_parity.py (:42 and, for the resnet50
# encoder's deeper stack, :125)
ATOL = {"nested_unet_resnet50": 2e-3}


def jax_model(arch: str, num_classes: int = 3, deep_supervision: bool = False,
              dtype=jnp.float32):
    """The JAX package's model of `arch` (unet_tpu/cli/main.py:44-60)."""
    if arch in ("nested_unet", "nested_unet_resnet50"):
        return JNestedUNet(num_classes=num_classes, deep_supervision=deep_supervision,
                           pretrained_encoder=arch == "nested_unet_resnet50", dtype=dtype)
    if arch == "simple_unet":
        return JSimpleUNet(num_classes=num_classes, dtype=dtype)
    enc = arch.split(":", 1)[1]
    return JLightweight(num_classes=num_classes, encoder=enc,
                        deep_supervision=deep_supervision, dtype=dtype)


def jax_variables(arch: str, num_classes: int = 3, size: int = 64, seed: int = 0,
                  train: bool = False):
    """Variables of `jax_model(arch)` as numpy, in the tree that its `init`
    makes at a size^2 input (`train` adds the deep-supervision heads), taken
    from `jax.eval_shape` (no compile); the leaves drawn from numpy's
    generator with `seed`: kernels LeCun-normal (flax's default), BN
    statistics, scales and biases as
    tests/test_torch_fast_forward.py::randomised_variables draws them."""
    jm = jax_model(arch, num_classes, deep_supervision=train)
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((1, size, size, 3)), train=train),
                            jax.random.PRNGKey(0))
    r = np.random.default_rng(seed)
    out = {}
    for path, v in flax.traverse_util.flatten_dict(shapes).items():
        if path[-1] == "kernel":
            a = r.normal(0, np.sqrt(1.0 / np.prod(v.shape[:-1])), v.shape)
        elif path[0] == "batch_stats" and path[-1] == "mean":
            a = r.normal(0, 0.2, v.shape)
        elif path[0] == "batch_stats" and path[-1] == "var":
            a = r.uniform(0.5, 1.5, v.shape)
        elif path[-1] == "scale":
            a = 1.0 + r.normal(0, 0.1, v.shape)
        elif path[-1] == "bias":
            a = r.normal(0, 0.05, v.shape)
        else:
            raise ValueError(f"unexpected variable {path}")
        out[path] = np.asarray(a, np.float32)
    return flax.traverse_util.unflatten_dict(out)


def port_model(arch: str, variables, num_classes: int = 3, dtype: str = "float32"):
    """The port's model of `arch` through the CLI's `_build_model`, with the
    JAX package's `variables` loaded strictly; eval mode."""
    sd = state_dict_from_flax(variables, arch)
    ds = "ds1_3.weight" in sd
    if arch.startswith("lightweight:") and ds:   # the CLI builds it without heads
        model = LightweightNestedUNet(num_classes, arch.split(":", 1)[1], deep_supervision=True,
                                      dtype=getattr(torch, dtype))
    else:
        model = _build_model(num_classes, arch, dtype, deep_supervision=ds)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def jax_logits(arch: str, variables, x_nhwc: np.ndarray, num_classes: int = 3,
               dtype=jnp.float32) -> np.ndarray:
    """The JAX model's eval logits (jitted), NHWC, as float32 numpy."""
    jm = jax_model(arch, num_classes, dtype=dtype)
    y = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(x_nhwc))
    return np.asarray(y.astype(jnp.float32))


def port_logits(model, x_nhwc: np.ndarray) -> np.ndarray:
    with torch.inference_mode():
        y = model(torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2))))
    return y.float().numpy().transpose(0, 2, 3, 1)
