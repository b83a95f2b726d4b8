"""Hard-negative mining from raw videos (counterpart of
unet_tpu/tools/hard_negatives.py): evenly-strided frames saved with empty
masks for background-robustness training
(reference src/data/advanced_dataset.py:297-367)."""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def create_hard_negative_dataset(raw_videos_dir: str, output_dir: str,
                                 num_frames: int = 200,
                                 frame_size: Tuple[int, int] = (512, 512)) -> int:
    import cv2
    os.makedirs(os.path.join(output_dir, "images"), exist_ok=True)
    os.makedirs(os.path.join(output_dir, "masks"), exist_ok=True)
    videos = [f for f in sorted(os.listdir(raw_videos_dir))
              if f.lower().endswith((".mp4", ".avi", ".mov"))]
    if not videos:
        print(f"no videos under {raw_videos_dir}")
        return 0
    per_video = max(num_frames // len(videos), 1)
    count = 0
    empty = np.zeros(frame_size, np.uint8)
    for vf in videos:
        if count >= num_frames:
            break
        cap = cv2.VideoCapture(os.path.join(raw_videos_dir, vf))
        if not cap.isOpened():
            print(f"failed to open {vf}")
            continue
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        skip = max(1, total // per_video)
        idx = 0
        while count < num_frames and idx < total:
            cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
            ok, frame = cap.read()
            if not ok:
                break
            frame = cv2.resize(frame, (frame_size[1], frame_size[0]))
            name = f"hn_{count:04d}.png"
            cv2.imwrite(os.path.join(output_dir, "images", name), frame)
            cv2.imwrite(os.path.join(output_dir, "masks", name), empty)
            count += 1
            idx += skip
        cap.release()
    print(f"extracted {count} hard-negative frames to {output_dir}")
    return count
