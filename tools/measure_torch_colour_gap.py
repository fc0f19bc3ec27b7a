"""How far cv2's frames move from the port's conversions when a stream
signals a colour description.

    python tools/measure_torch_colour_gap.py

The port converts every P016 frame as BT.601 limited range with its
codec's default chroma siting (``siammot_tpu_torch/data/nvdec.py``), what
swscale takes for a stream that signals nothing.  cv2 (FFmpeg 8's
swscale) honours what a stream signals.  This encodes one lossless
10-bit 4:2:0 x265 frame of seeded noise (256x128) under each VUI below,
reads it with ``cv2.VideoCapture`` and prints the largest and mean byte
gap to ``nvdec.p016_to_rgb_plain`` of the same planes.  Needs ``cv2`` and
``libx265.so.199``; writes only to a temporary directory.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from siammot_tpu_torch.data import nvdec  # noqa: E402
from tools.make_torch_container_fixtures import \
    x265_encode_planes  # noqa: E402
from tools.make_torch_highbit_fixtures import x265_opts  # noqa: E402

W, H, DEPTH = 256, 128, 10
VUI = {"none": {},
       "BT.601 matrix (smpte170m)": {"colormatrix": "smpte170m"},
       "BT.709 matrix": {"colormatrix": "bt709"},
       "full range": {"range": "full"},
       "chroma siting top-left": {"chromaloc": "2"},
       "BT.2020 NCL matrix": {"colormatrix": "bt2020nc"},
       "BT.2020 primaries": {"colorprim": "bt2020"},
       "PQ transfer": {"transfer": "smpte2084"}}


def main():
    import cv2
    rng = np.random.RandomState(26)
    y = rng.randint(0, 1 << DEPTH, (H, W))
    u, v = (rng.randint(0, 1 << DEPTH, (H // 2, W // 2)) for _ in range(2))
    frame = np.zeros((nvdec.nv12_rows(H), W), np.uint16)
    frame[:H] = y << (16 - DEPTH)
    c0 = nvdec.chroma_row(H)
    frame[c0:c0 + H // 2] = np.stack([u, v], -1).reshape(H // 2, W) \
        << (16 - DEPTH)
    port = nvdec.p016_to_rgb_plain(torch.from_numpy(frame.view(np.int16)),
                                   W, H, DEPTH, nvdec.CHROMA_SITING["HEVC"])
    port = port.numpy().astype(np.int64)
    with tempfile.TemporaryDirectory() as tmp:
        for name, vui in VUI.items():
            opts = dict(x265_opts(W, H, False, lossless=True), **vui)
            packets, _ = x265_encode_planes(
                [[p.astype(np.uint16) for p in (y, u, v)]], opts, DEPTH)
            path = os.path.join(tmp, "s.hevc")
            with open(path, "wb") as f:
                f.write(b"".join(p["data"] for p in packets))
            ok, bgr = cv2.VideoCapture(path).read()
            if not ok:
                raise RuntimeError(f"cv2 read no frame ({name})")
            gap = np.abs(bgr[..., ::-1].astype(np.int64) - port)
            print(f"{name}: largest byte gap {gap.max()}, mean "
                  f"{gap.mean():.4f}")


if __name__ == "__main__":
    main()
