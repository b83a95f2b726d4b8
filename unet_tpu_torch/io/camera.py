"""GigE Vision camera acquisition through GenICam's Harvester (counterpart
of unet_tpu/io/camera.py; reference src/camera/gige_harvester.py:15-129).

CTI producer load, device selection by serial, best-effort exposure, gain,
pixel-format and ROI node setup, Bayer->BGR demosaic, timestamped frames.
The `harvesters` SDK is optional and imported when a camera is built;
without it construction raises. `frames()` has the interface of
`io.video`'s sources, so the engine and the server take either.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclass
class Frame:
    image_bgr: np.ndarray
    timestamp_ns: int
    frame_id: int


class GigECameraHarvester:
    """Best-effort GenICam camera reader (reference gige_harvester.py)."""

    def __init__(self, cti_path: str, serial: Optional[str] = None,
                 exposure_us: Optional[float] = None, gain: Optional[float] = None,
                 pixel_format: str = "BayerRG8",
                 roi: Optional[Tuple[int, int, int, int]] = None):
        try:
            from harvesters.core import Harvester
        except ImportError as e:
            raise RuntimeError(
                "harvesters (GenICam) SDK not installed; GigE acquisition "
                "unavailable — use io.video.VideoReader for file sources") from e
        self.h = Harvester()
        self.h.add_file(cti_path)
        self.h.update()
        self.serial = serial
        self.exposure_us = exposure_us
        self.gain = gain
        self.pixel_format = pixel_format
        self.roi = roi
        self.ia = None
        self._frame_id = 0

    def open(self) -> None:
        """Select the device (by serial if given) and set its nodes, best
        effort (reference gige_harvester.py:40-76)."""
        index = 0
        if self.serial:
            for i, info in enumerate(self.h.device_info_list):
                if getattr(info, "serial_number", None) == self.serial:
                    index = i
                    break
        self.ia = self.h.create(index)
        node = self.ia.remote_device.node_map
        settings = [("ExposureTime", self.exposure_us), ("Gain", self.gain),
                    ("PixelFormat", self.pixel_format)]
        if self.roi is not None:
            settings += list(zip(("OffsetX", "OffsetY", "Width", "Height"), self.roi))
        for name, value in settings:
            if value is None:
                continue
            try:
                setattr(node, name, value)
            except Exception as e:  # a node a camera lacks: keep its default, as the reference
                print(f"camera: could not set {name}={value}: {e}")
        self.ia.start()

    def _to_bgr(self, component) -> np.ndarray:
        """Demosaic (Bayer) or pass through (reference gige_harvester.py:101-114)."""
        import cv2
        img = component.data.reshape(component.height, component.width)
        codes = {"BayerRG8": cv2.COLOR_BayerRG2BGR, "BayerGR8": cv2.COLOR_BayerGR2BGR,
                 "BayerGB8": cv2.COLOR_BayerGB2BGR, "BayerBG8": cv2.COLOR_BayerBG2BGR,
                 "Mono8": cv2.COLOR_GRAY2BGR}
        code = codes.get(self.pixel_format)
        return img if code is None else cv2.cvtColor(img, code)

    def read(self, timeout_s: float = 2.0) -> Optional[Frame]:
        """One timestamped frame (reference gige_harvester.py:116-129)."""
        if self.ia is None:
            raise RuntimeError("camera not opened")
        with self.ia.fetch(timeout=timeout_s) as buffer:
            bgr = self._to_bgr(buffer.payload.components[0])
            self._frame_id += 1
            ts = getattr(buffer, "timestamp_ns", None) or time.time_ns()
            return Frame(image_bgr=bgr, timestamp_ns=int(ts), frame_id=self._frame_id)

    def frames(self) -> Iterator[Tuple[int, np.ndarray]]:
        """(frame_id, BGR frame), as io.video's sources."""
        while True:
            f = self.read()
            if f is None:
                return
            yield f.frame_id, f.image_bgr

    def close(self) -> None:
        if self.ia is not None:
            self.ia.stop()
            self.ia.destroy()
            self.ia = None
        self.h.reset()
