"""Tools of the port (counterpart of unet_tpu/tools/): `evaluate_dataset`.
The rest of tools/ and `cli tools` are ROADMAP A14b."""
from unet_tpu_torch.tools.evaluate import evaluate_dataset  # noqa: F401
