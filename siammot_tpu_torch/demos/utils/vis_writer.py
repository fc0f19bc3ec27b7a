"""The demo's output writer (counterpart of ``demos/utils/vis_writer.py``,
without ``cv2``).

With ``dump_video`` the frames go into ``<out_path>/<name>.mp4``; without
it each frame is ``<out_path>/<name>_frames/%06d.jpg``.  Frames are RGB
and encoded as JPEG at quality 95 (``cv2.imwrite``'s default) with 4:2:0
chroma, on ``device``'s route: libjpeg on the CPU (the bytes of
``cv2.imwrite``), nvJPEG on the card.

The video is Motion JPEG in an MP4 (``data/container.py:Mp4Writer``: an
``mp4v`` sample entry with the JPEG object type, as FFmpeg writes MJPEG
into an MP4), which ``cv2.VideoCapture`` and the port's own demuxer read.
The JAX demo writes MPEG-4 Part 2 through ``cv2.VideoWriter``; the port
has no encoder for it, so this is a known, intended difference.
"""

from __future__ import annotations

import os

from ...data import native
from ...data.container import Mp4Writer

QUALITY = 95


class VisWriter:
    def __init__(self, dump_video: bool = False, out_path: str = ".",
                 file_name: str = "demo", fps: float = 30.0, device="cpu"):
        self.dump_video = dump_video
        self.out_path = out_path
        self.file_name = os.path.splitext(os.path.basename(
            os.path.normpath(file_name)))[0]
        self.fps = fps
        self.device = device
        self._writer = None
        os.makedirs(out_path, exist_ok=True)
        if not dump_video:
            self.frame_dir = os.path.join(out_path, self.file_name + "_frames")
            os.makedirs(self.frame_dir, exist_ok=True)

    @property
    def video_path(self) -> str:
        return os.path.join(self.out_path, self.file_name + ".mp4")

    def dump_artifacts(self, frame, frame_id: int):
        """frame: RGB uint8."""
        data = native.encode_jpeg(frame, QUALITY, self.device)
        if self.dump_video:
            if self._writer is None:
                h, w = frame.shape[:2]
                self._writer = Mp4Writer(self.video_path, self.fps, w, h)
            self._writer.write(data)
        else:
            with open(os.path.join(self.frame_dir, f"{frame_id:06d}.jpg"),
                      "wb") as f:
                f.write(data)

    def close(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None
