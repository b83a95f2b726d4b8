"""Host I/O of the port (counterpart of unet_tpu/io): video and image-dir
sources, the video writer, GigE camera acquisition."""
from unet_tpu_torch.io.video import (  # noqa: F401
    ImageDirReader, VideoMeta, VideoReader, VideoWriter, read_bmp)
from unet_tpu_torch.io.camera import Frame, GigECameraHarvester  # noqa: F401
