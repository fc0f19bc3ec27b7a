"""Write ``tests/fixtures/jpeg_roundtrip.npz``: the JAX augmentation's JPEG
round trip (``siammot_tpu.data.augmentation.JpegCompression``'s
``cv2.imencode`` + ``cv2.imdecode``) of four 64x64 crops of the committed
training stills at qualities 50, 75 and 100.  ``chip_smoke.py`` phase 9c
holds nvJPEG's round trip on the card against it (that machine has no
libjpeg or ``cv2``).  The round trips are stored as int8 differences
from their crops, which keeps the file under 200 KB.

    python tests/torch_jpeg_fixture.py
"""

import os

import cv2
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STILLS = os.path.join(REPO, "tests", "fixtures", "syncrowd_mini", "Images")
OUT = os.path.join(REPO, "tests", "fixtures", "jpeg_roundtrip.npz")
QUALITIES = (50, 75, 100)
# (still, top, left) of each crop
CROPS = ((1, 100, 200), (2, 30, 400), (3, 200, 50), (4, 150, 300))


def crops() -> np.ndarray:
    out = []
    for k, y, x in CROPS:
        img = cv2.imread(os.path.join(STILLS, f"train_{k:06d}.jpg"),
                         cv2.IMREAD_COLOR)[..., ::-1]
        out.append(img[y:y + 64, x:x + 64])
    return np.ascontiguousarray(np.stack(out))


def cv2_roundtrip(img: np.ndarray, quality: int) -> np.ndarray:
    ok, buf = cv2.imencode(".jpg", img[..., ::-1],
                           [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    return cv2.imdecode(buf, cv2.IMREAD_COLOR)[..., ::-1]


def main():
    c = crops()
    diffs = {}
    for q in QUALITIES:
        d = np.stack([cv2_roundtrip(x, q) for x in c]).astype(np.int16) - c
        assert np.abs(d).max() <= 127
        diffs[f"q{q}"] = d.astype(np.int8)
    np.savez_compressed(OUT, crops=c, **diffs)
    print(OUT, os.path.getsize(OUT))


if __name__ == "__main__":
    main()
