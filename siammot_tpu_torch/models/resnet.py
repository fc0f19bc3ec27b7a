"""ResNet-FPN bodies (port of ``siammot_tpu.models.resnet``):
ResNet-50, 101 and 152 in maskrcnn-benchmark's Caffe2 conventions.

  - Stem: 7x7/2 conv (no bias), FrozenBN, ReLU, then a 3x3/2 max pool
    with pad 1 (padded with -inf, as ``nn.max_pool`` pads).
  - ``ResNetBottleneck`` (maskrcnn ``BottleneckWithFixedBatchNorm``):
    1x1 -> 3x3 -> 1x1, the stage stride on the first 1x1 when
    ``stride_in_1x1`` (else on the 3x3), the 3x3 grouped by
    ``num_groups`` or deformable (kernel 9) on the stages
    ``stage_with_dcn`` names, and a 1x1 + FrozenBN projection shortcut
    where the block's input and output widths differ.
  - Four stages give C2..C5 at strides 4/8/16/32, widths
    ``res2_out_channels * 2^k``.

Module names follow the flax tree (``stem_conv1``, ``stem_bn1``,
``layer{s}_{b}`` with ``conv{1,2,3}``, ``bn{1,2,3}``,
``downsample_conv``, ``downsample_bn``), so ``utils/weights.py`` maps
every key by its path.  The convolutions are ``F.conv2d`` (cuDNN on the
card), as in the DLA port; the stages ``TPU.CONV_MATMUL_STAGES`` names
(the JAX package's im2col matmul form of each bottleneck's 3x3, exact on
the same parameters) run that same convolution.
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from .dla import DeformConv, FrozenBN, conv


class ResNetBottleneck(nn.Module):
    """maskrcnn ``BottleneckWithFixedBatchNorm`` (Caffe2 layout)."""

    def __init__(self, cin: int, out_channels: int, bottleneck_channels: int,
                 stride: int = 1, dilation: int = 1, num_groups: int = 1,
                 stride_in_1x1: bool = True, with_dcn: bool = False,
                 use_downsample: bool = False):
        super().__init__()
        mid = bottleneck_channels
        if use_downsample:
            # a dilated stage keeps stride 1 in the shortcut (maskrcnn's
            # down_stride rule)
            ds_stride = stride if dilation == 1 else 1
            self.downsample_conv = conv(cin, out_channels, 1, ds_stride)
            self.downsample_bn = FrozenBN(out_channels)
        else:
            self.downsample_conv = None
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = conv(cin, mid, 1, s1)
        self.bn1 = FrozenBN(mid)
        if with_dcn:
            self.conv2 = DeformConv(mid, mid, s3, dilation)
        else:
            self.conv2 = nn.Conv2d(mid, mid, 3, stride=s3, padding=dilation,
                                   dilation=dilation, groups=num_groups,
                                   bias=False)
        self.bn2 = FrozenBN(mid)
        self.conv3 = conv(mid, out_channels, 1)
        self.bn3 = FrozenBN(out_channels)

    def forward(self, x):
        identity = x if self.downsample_conv is None \
            else self.downsample_bn(self.downsample_conv(x))
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)


class ResNet(nn.Module):
    """ResNet body: NHWC image -> NCHW C2..C5 (strides 4/8/16/32)."""

    def __init__(self, stage_blocks, stem_channels: int = 64,
                 res2_out_channels: int = 256, num_groups: int = 1,
                 width_per_group: int = 64, stride_in_1x1: bool = True,
                 stage_with_dcn=(False,) * 4):
        super().__init__()
        self.stem_conv1 = conv(3, stem_channels, 7, 2)
        self.stem_bn1 = FrozenBN(stem_channels)
        self.stage_blocks = tuple(stage_blocks)
        self.stage_channels = []
        cin = stem_channels
        for stage, n_blocks in enumerate(self.stage_blocks, start=1):
            factor = 2 ** (stage - 1)
            cout = res2_out_channels * factor
            for b in range(n_blocks):
                setattr(self, f"layer{stage}_{b}", ResNetBottleneck(
                    cin if b == 0 else cout, cout,
                    num_groups * width_per_group * factor,
                    stride=(1 if stage == 1 else 2) if b == 0 else 1,
                    num_groups=num_groups, stride_in_1x1=stride_in_1x1,
                    with_dcn=stage_with_dcn[stage - 1],
                    use_downsample=b == 0 and cin != cout))
            cin = cout
            self.stage_channels.append(cout)

    def forward(self, x_nhwc):
        x = F.relu(self.stem_bn1(self.stem_conv1(x_nhwc.permute(0, 3, 1,
                                                                 2))))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for stage, n_blocks in enumerate(self.stage_blocks, start=1):
            for b in range(n_blocks):
                x = getattr(self, f"layer{stage}_{b}")(x)
            outs.append(x)
        return outs


# blocks per stage (torchvision/Caffe2 standard depths)
RESNET_VARIANTS = {
    "R-50-FPN": dict(stage_blocks=(3, 4, 6, 3)),
    "R-101-FPN": dict(stage_blocks=(3, 4, 23, 3)),
    "R-152-FPN": dict(stage_blocks=(3, 8, 36, 3)),
}


def build_resnet(conv_body: str, stage_with_dcn=(False,) * 4,
                 num_groups: int = 1, width_per_group: int = 64,
                 stride_in_1x1: bool = True, stem_channels: int = 64,
                 res2_out_channels: int = 256) -> ResNet:
    if conv_body not in RESNET_VARIANTS:
        raise KeyError(f"unknown backbone {conv_body}; "
                       f"choices: {sorted(RESNET_VARIANTS)}")
    return ResNet(stage_with_dcn=tuple(stage_with_dcn),
                  num_groups=num_groups, width_per_group=width_per_group,
                  stride_in_1x1=stride_in_1x1, stem_channels=stem_channels,
                  res2_out_channels=res2_out_channels,
                  **RESNET_VARIANTS[conv_body])
