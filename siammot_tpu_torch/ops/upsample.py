"""Bicubic interpolation matrices (own numpy copy of
``siammot_tpu.ops.upsample.bicubic_matrix``).

Bicubic upsampling is linear in its input, so x``scale`` is ``U . X . U^T``
with a dense ``[in * scale, in]`` matrix that reproduces PyTorch's
``upsample_bicubic2d``: half-pixel source mapping (align_corners=False),
Keys cubic kernel a = -0.75, indices clamped at the borders.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


def _cubic_weights(t: float, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution weights for taps at offsets [-1, 0, 1, 2]."""
    def w1(x):  # |x| <= 1
        return ((a + 2) * x - (a + 3)) * x * x + 1

    def w2(x):  # 1 < |x| < 2
        return (((x - 5) * x + 8) * x - 4) * a

    return np.array([w2(t + 1.0), w1(t), w1(1.0 - t), w2(2.0 - t)],
                    np.float64)


@lru_cache(maxsize=None)
def bicubic_matrix(in_size: int, scale: int) -> np.ndarray:
    """[out, in] dense interpolation matrix, out = in * scale."""
    out_size = in_size * scale
    mat = np.zeros((out_size, in_size), np.float64)
    for o in range(out_size):
        src = (o + 0.5) / scale - 0.5
        base = int(np.floor(src))
        wts = _cubic_weights(src - base)
        for k in range(4):
            mat[o, min(max(base - 1 + k, 0), in_size - 1)] += wts[k]
    return mat.astype(np.float32)
