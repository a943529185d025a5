"""Video IO tools (the port's own copy of ``stif_tpu/utils/video.py``:
numpy, cv2 and the ``ffmpeg`` binary; no torch).

Parity targets: ffmpeg frame extraction / muxing (``codes/utils/util.py:
325-355``) and the cv2 VideoWriter muxer (``codes/utils/make_video.py:7-29``),
plus ``read_seq_imgs`` (``:260-270``). ffmpeg calls are gated on the binary
being present.
"""

from __future__ import annotations

import os
import os.path as osp
import shutil
import subprocess
from typing import Optional, Sequence

import numpy as np


def has_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def extract_frames(video_path: str, out_dir: str, fps: Optional[float] = None):
    """ffmpeg video -> PNG frames (reference ``extract_frames``)."""
    if not has_ffmpeg():
        raise RuntimeError("ffmpeg not available")
    os.makedirs(out_dir, exist_ok=True)
    cmd = ["ffmpeg", "-y", "-i", video_path]
    if fps:
        cmd += ["-vf", f"fps={fps}"]
    cmd += [osp.join(out_dir, "%06d.png")]
    subprocess.run(cmd, check=True, capture_output=True)


def create_video_ffmpeg(frame_dir: str, out_path: str, fps: float = 30,
                        pattern: str = "%06d.png"):
    if not has_ffmpeg():
        raise RuntimeError("ffmpeg not available")
    cmd = ["ffmpeg", "-y", "-framerate", str(fps), "-i",
           osp.join(frame_dir, pattern), "-pix_fmt", "yuv420p", out_path]
    subprocess.run(cmd, check=True, capture_output=True)


def create_video_cv2(frames: Sequence[np.ndarray], out_path: str,
                     fps: float = 30):
    """uint8 RGB frames -> mp4 via cv2 (reference ``make_video.py``)."""
    import cv2

    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(
        out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
    )
    for f in frames:
        writer.write(f[..., ::-1])  # RGB -> BGR
    writer.release()


def read_seq_imgs(img_dir: str) -> np.ndarray:
    """Folder of frames -> (T, H, W, 3) float32 RGB [0,1]."""
    import cv2

    names = sorted(
        n for n in os.listdir(img_dir)
        if n.lower().endswith((".png", ".jpg", ".jpeg", ".bmp"))
    )
    out = []
    for n in names:
        img = cv2.imread(osp.join(img_dir, n), cv2.IMREAD_UNCHANGED)
        out.append(img.astype(np.float32)[..., [2, 1, 0]] / 255.0)
    return np.stack(out)
