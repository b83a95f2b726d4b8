"""Serving of the port (counterpart of unet_tpu/serve): the multi-stream
server, `cli serve`'s stream wiring (`open_sources`, `serve_streams`) and the
YAML-configured inspection system; `MultiStreamServer(mesh=...)` serves over
the data axis of a device mesh (parallel.mesh)."""
from unet_tpu_torch.serve.inspect_tool import (  # noqa: F401
    InspectionConfig, InspectionSystem, run_inspection)
from unet_tpu_torch.serve.multistream import MultiStreamServer, StreamResult  # noqa: F401
from unet_tpu_torch.serve.service import open_sources, serve_streams  # noqa: F401
