"""Video assembly (port of pixelsynth_tpu/utils/video.py; create_vid.py
:22-31 of the reference): an ffmpeg mp4 from the demo's frame sequence."""

from __future__ import annotations

import os
import subprocess


def create_video(frames_dir: str, out_path: str, fps: int = 10) -> bool:
    """Assemble <frames_dir>/%d.png into an mp4.  Returns False where
    ffmpeg is not installed or fails."""
    cmd = ["ffmpeg", "-y", "-framerate", str(fps),
           "-i", os.path.join(frames_dir, "%d.png"),
           "-pix_fmt", "yuv420p", "-crf", "17", out_path]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        return True
    except (FileNotFoundError, subprocess.CalledProcessError):
        return False
