"""Feature Pyramid Network (port of ``siammot_tpu.models.fpn``).

Top-down pathway with bilinear resize to the lateral's shape
(half-pixel centres, ``align_corners=False``) and the LastLevelMaxPool
P6 (1x1 max pool, stride 2).  NCHW in and out.
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F


def resize_bilinear(x, out_hw):
    """Bilinear resize of NCHW maps with half-pixel centres
    (``jax.image.resize(method="bilinear")`` for the upsampling FPN
    does)."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=False)


class FPN(nn.Module):
    def __init__(self, in_channels, out_channels: int):
        super().__init__()
        for i, c in enumerate(in_channels):
            setattr(self, f"inner{i + 1}", nn.Conv2d(c, out_channels, 1))
            setattr(self, f"layer{i + 1}",
                    nn.Conv2d(out_channels, out_channels, 3, padding=1))
        self.n = len(in_channels)

    def forward(self, features):
        inner = [getattr(self, f"inner{i + 1}")(f)
                 for i, f in enumerate(features)]
        last = inner[-1]
        laterals = [last]
        for f in inner[-2::-1]:
            last = f + resize_bilinear(last, f.shape[2:])
            laterals.insert(0, last)
        outs = [getattr(self, f"layer{i + 1}")(l)
                for i, l in enumerate(laterals)]
        outs.append(outs[-1][:, :, ::2, ::2])
        return outs
