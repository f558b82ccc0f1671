"""Video recording for Monitor (reference: `gym/monitoring/
video_recorder.py:~1-300` † — SURVEY.md §2.1/§3.5).

The reference pipes rgb_array frames into an ffmpeg subprocess.  Hosts may
ship without ffmpeg, so the encoder backend degrades gracefully:
ffmpeg subprocess (mp4) -> imageio (gif) -> raw .npy frame stack.  Either
way the Monitor manifest records the artifact.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import tempfile

import numpy as np

from dartenv_tpu_torch.utils.atomic_write import atomic_write


class ImageEncoder(object):
    """ffmpeg-subprocess encoder (the reference backend)."""

    def __init__(self, output_path, frame_shape, frames_per_sec):
        self.output_path = output_path
        h, w, c = frame_shape
        self.wh = (w, h)
        self.frames_per_sec = frames_per_sec
        self.backend = shutil.which("ffmpeg") or shutil.which("avconv")
        if self.backend is None:
            raise RuntimeError("no ffmpeg/avconv available")
        self.proc = subprocess.Popen(
            [
                self.backend, "-nostats", "-loglevel", "error", "-y",
                "-f", "rawvideo", "-s:v", "{}x{}".format(w, h),
                "-pix_fmt", "rgb24", "-framerate", str(frames_per_sec),
                "-i", "-", "-vf", "scale=trunc(iw/2)*2:trunc(ih/2)*2",
                "-vcodec", "libx264", "-pix_fmt", "yuv420p",
                output_path,
            ],
            stdin=subprocess.PIPE,
        )

    @property
    def version_info(self):
        return {"backend": os.path.basename(self.backend)}

    def capture_frame(self, frame):
        self.proc.stdin.write(np.ascontiguousarray(frame).tobytes())

    def close(self):
        self.proc.stdin.close()
        self.proc.wait()


class NpyEncoder(object):
    """Dependency-free fallback: stacks frames into a .npy file."""

    def __init__(self, output_path, frame_shape, frames_per_sec):
        self.output_path = os.path.splitext(output_path)[0] + ".npy"
        self.frames_per_sec = frames_per_sec
        self.frames = []

    @property
    def version_info(self):
        return {"backend": "npy"}

    def capture_frame(self, frame):
        self.frames.append(np.asarray(frame, dtype=np.uint8))

    def close(self):
        if self.frames:
            np.save(self.output_path, np.stack(self.frames))


class VideoRecorder(object):
    """Captures env.render('rgb_array') frames into a video artifact."""

    def __init__(self, env, path=None, metadata=None, enabled=True,
                 base_path=None):
        self.enabled = enabled
        self.broken = False
        self.encoder = None
        self.empty = True
        if not self.enabled:
            return
        if path is None:
            if base_path is not None:
                path = base_path + ".mp4"
            else:
                fd, path = tempfile.mkstemp(suffix=".mp4")
                os.close(fd)
        self.path = path
        self.env = env
        self.metadata = metadata or {}
        self.frames_per_sec = env.metadata.get(
            "video.frames_per_second", 30
        )
        self.metadata_path = os.path.splitext(self.path)[0] + ".meta.json"

    def capture_frame(self):
        if not self.enabled or self.broken:
            return
        frame = self.env.render(mode="rgb_array")
        if frame is None:
            self.broken = True
            return
        if self.encoder is None:
            try:
                self.encoder = ImageEncoder(
                    self.path, frame.shape, self.frames_per_sec
                )
            except Exception:
                self.encoder = NpyEncoder(
                    self.path, frame.shape, self.frames_per_sec
                )
            self.metadata["encoder"] = self.encoder.version_info
        self.encoder.capture_frame(frame)
        self.empty = False

    def close(self):
        if not self.enabled:
            return
        if self.encoder is not None:
            self.encoder.close()
            self.path = getattr(self.encoder, "output_path", self.path)
        self.write_metadata()
        self.enabled = False

    def write_metadata(self):
        with atomic_write(self.metadata_path) as f:
            json.dump(self.metadata, f)
