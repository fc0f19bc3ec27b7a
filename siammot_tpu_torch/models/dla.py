"""DLA backbone (port of ``siammot_tpu.models.dla``: DLA-34 and DLA-MINI).

Module names and nesting follow the flax modules, so the JAX parameter
tree loads key by key (``utils/weights.py``).  Tensors run NCHW
internally (channels-last memory on the card); the convolutions are
``F.conv2d``, as the JAX package leaves them to XLA.  FrozenBN is a
per-channel affine ``x * scale + bias`` (maskrcnn FrozenBatchNorm2d with
the statistics folded in).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def conv(cin: int, cout: int, k: int, stride: int = 1, bias: bool = False,
         padding: int | None = None) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, bias=bias,
                     padding=(k - 1) // 2 if padding is None else padding)


class FrozenBN(nn.Module):
    """Per-channel affine with fixed statistics."""

    def __init__(self, c: int):
        super().__init__()
        self.register_buffer("scale", torch.ones(c))
        self.register_buffer("bias", torch.zeros(c))

    def forward(self, x):
        return x * self.scale[:, None, None] + self.bias[:, None, None]


class BasicBlock(nn.Module):
    """Two 3x3 convs + residual (reference dla.py:30-57)."""

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv(cin, planes, 3, stride)
        self.bn1 = FrozenBN(planes)
        self.conv2 = conv(planes, planes, 3)
        self.bn2 = FrozenBN(planes)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + residual)


class Root(nn.Module):
    """Aggregation node: 1x1 conv over concat(children)."""

    def __init__(self, cin: int, cout: int, residual: bool):
        super().__init__()
        self.conv = conv(cin, cout, 1)
        self.bn = FrozenBN(cout)
        self.residual = residual

    def forward(self, *children):
        x = self.bn(self.conv(torch.cat(children, dim=1)))
        if self.residual:
            x = x + children[0]
        return F.relu(x)


class Tree(nn.Module):
    """Recursive DLA tree (reference dla.py:192-239); BasicBlock leaves."""

    def __init__(self, levels: int, in_channels: int, out_channels: int,
                 stride: int = 1, level_root: bool = False,
                 root_dim: int = 0, root_residual: bool = False):
        super().__init__()
        if root_dim == 0:
            root_dim = 2 * out_channels
        if level_root:
            root_dim += in_channels
        self.levels = levels
        self.stride = stride
        self.level_root = level_root
        if in_channels != out_channels:
            self.project_conv = conv(in_channels, out_channels, 1)
            self.project_bn = FrozenBN(out_channels)
        else:
            self.project_conv = None
        if levels == 1:
            self.tree1 = BasicBlock(in_channels, out_channels, stride)
            self.tree2 = BasicBlock(out_channels, out_channels, 1)
            self.root = Root(root_dim, out_channels, root_residual)
        else:
            self.tree1 = Tree(levels - 1, in_channels, out_channels, stride,
                              root_residual=root_residual)
            self.tree2 = Tree(levels - 1, out_channels, out_channels, 1,
                              root_dim=root_dim + out_channels,
                              root_residual=root_residual)

    def forward(self, x, children=None):
        children = [] if children is None else children
        bottom = F.max_pool2d(x, self.stride) if self.stride > 1 else x
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            # a deeper tree holds project_* (the flax tree has them) but
            # never reads the projection, so only a leaf computes it
            residual = bottom if self.project_conv is None else \
                self.project_bn(self.project_conv(bottom))
            x1 = self.tree1(x, residual)
            x2 = self.tree2(x1)
            return self.root(x2, x1, *children)
        x1 = self.tree1(x)
        children.append(x1)
        return self.tree2(x1, children=children)


class S2DStem(nn.Module):
    """Space-to-depth stem: the phase-decomposed form of base(7x7) ->
    level0(3x3) -> level1(3x3 s2) that the JAX package trains.  A trained
    S2D stem has no exact plain-stem form (PARITY.md #13), so the port
    runs it as it is."""

    def __init__(self, c0: int, c1: int):
        super().__init__()
        self.s2d_base_conv = conv(12, 4 * c0, 5)
        self.s2d_base_bn = FrozenBN(4 * c0)
        self.s2d_level0_conv = conv(4 * c0, 4 * c0, 3)
        self.s2d_level0_bn = FrozenBN(4 * c0)
        # stride-2 conv -> 2x2 taps over phases, pad (1, 0) on each axis
        self.s2d_level1_conv = conv(4 * c0, c1, 2, padding=0)
        self.s2d_level1_bn = FrozenBN(c1)

    def forward(self, x_nhwc):
        b, h, w, c = x_nhwc.shape
        if h % 2 or w % 2:
            raise ValueError(f"S2D stem needs even input sizes, got {h}x{w}")
        # [B, H, W, C] -> [B, H/2, W/2, 4C], channel order (a, b, c)
        x = x_nhwc.reshape(b, h // 2, 2, w // 2, 2, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.s2d_base_bn(self.s2d_base_conv(x)))
        x = F.relu(self.s2d_level0_bn(self.s2d_level0_conv(x)))
        x = self.s2d_level1_conv(F.pad(x, (1, 0, 1, 0)))
        return F.relu(self.s2d_level1_bn(x))


DLA_VARIANTS = {
    "DLA-34-FPN": dict(levels=(1, 1, 1, 2, 2, 1),
                       channels=(16, 32, 64, 128, 256, 512)),
    "DLA-MINI-FPN": dict(levels=(1, 1, 1, 2, 2, 1),
                         channels=(8, 16, 16, 32, 64, 64)),
}


class DLA(nn.Module):
    """DLA feature extractor: NHWC image -> NCHW maps at strides 4..32."""

    def __init__(self, levels, channels, residual_root: bool = False):
        super().__init__()
        ch = channels
        if levels[0] != 1 or levels[1] != 1:
            raise ValueError("the S2D stem needs single-conv levels 0 and 1")
        self.stem = S2DStem(ch[0], ch[1])
        self.level2 = Tree(levels[2], ch[1], ch[2], 2,
                           root_residual=residual_root)
        self.level3 = Tree(levels[3], ch[2], ch[3], 2, level_root=True,
                           root_residual=residual_root)
        self.level4 = Tree(levels[4], ch[3], ch[4], 2, level_root=True,
                           root_residual=residual_root)
        self.level5 = Tree(levels[5], ch[4], ch[5], 2, level_root=True,
                           root_residual=residual_root)

    def forward(self, x_nhwc):
        x2 = self.level2(self.stem(x_nhwc))
        x3 = self.level3(x2)
        x4 = self.level4(x3)
        x5 = self.level5(x4)
        return [x2, x3, x4, x5]


def build_dla(conv_body: str) -> DLA:
    if conv_body not in DLA_VARIANTS:
        raise KeyError(f"backbone {conv_body} is not ported yet; "
                       f"choices: {sorted(DLA_VARIANTS)}")
    return DLA(**DLA_VARIANTS[conv_body])
