"""Export of the port (counterpart of unet_tpu/export/): torch.export
programs saved as `.pt2`, and their runner."""
from unet_tpu_torch.export.aot import AotRunner, export_model, export_pipeline  # noqa: F401
