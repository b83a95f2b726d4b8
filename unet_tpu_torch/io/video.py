"""Host video I/O: batched frame sources feeding the step (counterpart of
unet_tpu/io/video.py).

Decode stays on the host and overlaps the card's work through the engine's
threads. Video files, `.jpg` and `.png` frames go through OpenCV (`cv2`,
imported where it is used; without it they raise ImportError). `.bmp`
frames are decoded with numpy (`read_bmp`), so an image directory of
`.bmp` files runs without OpenCV.
"""
from __future__ import annotations

import itertools
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np


def _cv2(what: str):
    """OpenCV, or ImportError naming what needed it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{what} needs OpenCV (the cv2 module), which is not installed; "
                          f"image directories of .bmp frames decode without it") from e
    return cv2


_BMP_HEADER = struct.Struct("<2sIHHIIiiHHI")   # file header + the info header up to compression


def _bmp_header(data: bytes) -> Optional[Tuple[int, int, int]]:
    """(width, height, pixel offset) of an uncompressed 24-bit BMP, height
    negative for top-down rows; None when `data` is not a whole BMP file.
    Raises ValueError on a BMP of another kind."""
    if len(data) < _BMP_HEADER.size or data[:2] != b"BM":
        return None
    _, _, _, _, offset, info, w, h, planes, bpp, comp = _BMP_HEADER.unpack_from(data)
    if info < 40 or planes != 1 or bpp != 24 or comp != 0 or w <= 0 or h == 0:
        raise ValueError(f"unsupported BMP (info header {info} B, {bpp} bits a pixel, "
                         f"compression {comp}): only uncompressed 24-bit BGR is decoded")
    stride = (3 * w + 3) // 4 * 4
    if len(data) < offset + stride * abs(h):
        return None
    return w, h, offset


def read_bmp(path) -> Optional[np.ndarray]:
    """(H, W, 3) uint8 BGR of an uncompressed 24-bit BMP, the format that
    cv2.imwrite writes for a colour image: rows stored bottom-up (top-down
    when the height is negative), each padded to a multiple of 4 bytes.
    None where the file is not a whole BMP (as cv2.imdecode gives None)."""
    data = Path(path).read_bytes()
    head = _bmp_header(data)
    if head is None:
        return None
    w, h, offset = head
    stride = (3 * w + 3) // 4 * 4
    rows = np.frombuffer(data, np.uint8, stride * abs(h), offset).reshape(abs(h), stride)
    img = rows[:, :3 * w].reshape(abs(h), w, 3)
    return np.ascontiguousarray(img[::-1] if h > 0 else img)


def _read_image(path: Path) -> Optional[np.ndarray]:
    """BGR frame of an image file: .bmp by numpy, the rest by cv2.imdecode
    (from bytes, so that any path works)."""
    if path.suffix.lower() == ".bmp":
        return read_bmp(path)
    cv2 = _cv2(f"decoding {path.suffix} frames")
    return cv2.imdecode(np.fromfile(str(path), np.uint8), cv2.IMREAD_COLOR)


@dataclass
class VideoMeta:
    width: int
    height: int
    fps: float
    total_frames: int


def _batches(frames: Iterator[Tuple[int, np.ndarray]], batch: int
             ) -> Iterator[Tuple[List[int], np.ndarray, int]]:
    """(frame_ids, (B, H, W, 3) uint8, n_valid) batches of a frame stream.
    The final batch is padded by repeating its last frame, so that every
    batch has one shape."""
    while True:
        chunk = list(itertools.islice(frames, batch))
        if not chunk:
            return
        ids = [c[0] for c in chunk]
        imgs = [c[1] for c in chunk]
        n_valid = len(imgs)
        while len(imgs) < batch:
            imgs.append(imgs[-1])
            ids.append(ids[-1])
        yield ids, np.stack(imgs), n_valid


class VideoReader:
    """cv2.VideoCapture wrapper with frame-stride batching."""

    def __init__(self, path: str, frame_stride: int = 1, max_frames: Optional[int] = None):
        cv2 = _cv2("reading a video file")
        self.cap = cv2.VideoCapture(str(path))
        if not self.cap.isOpened():
            raise FileNotFoundError(f"cannot open video {path}")
        self.frame_stride = max(int(frame_stride), 1)
        self.max_frames = max_frames
        self.meta = VideoMeta(
            width=int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            height=int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            fps=float(self.cap.get(cv2.CAP_PROP_FPS) or 25.0),
            total_frames=int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT)),
        )

    def frames(self) -> Iterator[Tuple[int, np.ndarray]]:
        """(frame_id, BGR frame) honoring stride / max_frames."""
        fid = 0
        emitted = 0
        try:
            while True:
                ok, frame = self.cap.read()
                if not ok:
                    break
                fid += 1
                if fid % self.frame_stride != 0:
                    continue
                yield fid, frame
                emitted += 1
                if self.max_frames is not None and emitted >= self.max_frames:
                    break
        finally:
            # also on GeneratorExit: a consumer that abandons the stream
            # must not leave the capture open
            self.cap.release()

    def batches(self, batch: int) -> Iterator[Tuple[List[int], np.ndarray, int]]:
        """Yield (frame_ids, (B, H, W, 3) uint8, n_valid); the last batch is
        padded with its last frame."""
        return _batches(self.frames(), batch)


class ImageDirReader:
    """Image-directory source with the same batch interface (the reference's
    process_images path, tools/inspect_tool.py)."""

    EXTS = (".jpg", ".jpeg", ".png", ".bmp")

    def __init__(self, path: str, max_frames: Optional[int] = None):
        self.paths = sorted(p for p in Path(path).iterdir()
                            if p.suffix.lower() in self.EXTS)[:max_frames]
        if not self.paths:
            raise FileNotFoundError(f"no images under {path}")
        probe = _read_image(self.paths[0])
        if probe is None:
            raise ValueError(f"cannot decode {self.paths[0]}")
        self.meta = VideoMeta(width=probe.shape[1], height=probe.shape[0],
                              fps=25.0, total_frames=len(self.paths))

    def frames(self) -> Iterator[Tuple[int, np.ndarray]]:
        warned = False
        for i, p in enumerate(self.paths):
            img = _read_image(p)
            if img is None:
                continue
            if img.shape[:2] != (self.meta.height, self.meta.width):
                # batches are stacked into one array, so a mixed-size
                # directory is resized to the first image's size
                if not warned:
                    print(f"note: resizing mixed-size images to "
                          f"{self.meta.width}x{self.meta.height} (first image)")
                    warned = True
                cv2 = _cv2("resizing a mixed-size image directory")
                img = cv2.resize(img, (self.meta.width, self.meta.height))
            yield i + 1, img

    def batches(self, batch: int) -> Iterator[Tuple[List[int], np.ndarray, int]]:
        return _batches(self.frames(), batch)


class VideoWriter:
    """cv2.VideoWriter wrapper (mp4v), opened on the first frame."""

    def __init__(self, path: str, fps: float):
        self.path = str(path)
        self.fps = fps
        self.writer = None

    def write(self, frame_bgr: np.ndarray) -> None:
        cv2 = _cv2("writing result.mp4")
        if self.writer is None:
            Path(self.path).parent.mkdir(parents=True, exist_ok=True)
            fourcc = cv2.VideoWriter_fourcc(*"mp4v")
            h, w = frame_bgr.shape[:2]
            self.writer = cv2.VideoWriter(self.path, fourcc, self.fps, (w, h))
        self.writer.write(frame_bgr)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.release()
            self.writer = None
