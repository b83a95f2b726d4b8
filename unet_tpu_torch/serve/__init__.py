"""Serving of the port (counterpart of unet_tpu/serve): the multi-stream
server. `serve/service.py` (`open_sources`, `serve_streams`), the inspection
tool and `cli serve` are not ported yet (ROADMAP A6)."""
from unet_tpu_torch.serve.multistream import MultiStreamServer, StreamResult  # noqa: F401
