"""DLA backbone (port of ``siammot_tpu.models.dla``): DLA-34, DLA-MINI
and the Bottleneck bodies DLA-46-C, 46-XC, 60, 102 and 169, with
deformable 3x3s (kernel 9) on the stages ``stage_with_dcn`` names.

Module names and nesting follow the flax modules, so the JAX parameter
tree loads key by key (``utils/weights.py``).  Tensors run NCHW
internally (channels-last memory on the card); the convolutions are
``F.conv2d``, as the JAX package leaves them to XLA.  FrozenBN is a
per-channel affine ``x * scale + bias`` (maskrcnn FrozenBatchNorm2d with
the statistics folded in).  Res2Net bodies and the plain stem are not
ported.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.deform_conv import deform_conv2d


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


class DeformConv(nn.Module):
    """DCNv1 3x3 (``siammot_tpu.ops.deform_conv.DeformConv``): an offset
    conv with bias gives per-tap (dy, dx), then kernel 9 samples and
    multiplies.  The kernel stays HWIO under ``kernel``, the layout the
    CUDA kernel reads (and the flax leaf's)."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        self.offset = nn.Conv2d(cin, 18, 3, stride=stride, padding=dilation,
                                dilation=dilation, bias=True)
        self.kernel = nn.Parameter(torch.zeros(3, 3, cin, cout))

    def forward(self, x):
        off = self.offset(x)
        # NCHW in channels-last memory is NHWC-contiguous: no copy there
        out = deform_conv2d(x.permute(0, 2, 3, 1).contiguous(),
                            off.permute(0, 2, 3, 1).contiguous(),
                            self.kernel.contiguous(), self.stride,
                            self.dilation)
        return out.permute(0, 3, 1, 2)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 + residual (reference dla.py:60-105); the 3x3 is
    grouped by ``cardinality``, or deformable with ``with_dcn`` (whose
    kernel is dense, as in the JAX package)."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dilation: int = 1, cardinality: int = 1,
                 base_width: int = 64, expansion: int = 2,
                 with_dcn: bool = False):
        super().__init__()
        mid = int(math.floor(planes * (base_width / 64))
                  * cardinality) // expansion
        self.conv1 = conv(cin, mid, 1)
        self.bn1 = FrozenBN(mid)
        if with_dcn:
            self.conv2 = DeformConv(mid, mid, stride, dilation)
        else:
            self.conv2 = nn.Conv2d(mid, mid, 3, stride=stride,
                                   padding=dilation, dilation=dilation,
                                   groups=cardinality, bias=False)
        self.bn2 = FrozenBN(mid)
        self.conv3 = conv(mid, planes, 1)
        self.bn3 = FrozenBN(planes)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
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
    """Recursive DLA tree (reference dla.py:192-239) over ``block``
    leaves (BasicBlock or Bottleneck) built with ``block_kwargs``."""

    def __init__(self, levels: int, in_channels: int, out_channels: int,
                 stride: int = 1, level_root: bool = False,
                 root_dim: int = 0, root_residual: bool = False,
                 block=BasicBlock, block_kwargs: dict | None = None):
        super().__init__()
        bk = block_kwargs or {}
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
            self.tree1 = block(in_channels, out_channels, stride, **bk)
            self.tree2 = block(out_channels, out_channels, 1, **bk)
            self.root = Root(root_dim, out_channels, root_residual)
        else:
            self.tree1 = Tree(levels - 1, in_channels, out_channels, stride,
                              root_residual=root_residual, block=block,
                              block_kwargs=bk)
            self.tree2 = Tree(levels - 1, out_channels, out_channels, 1,
                              root_dim=root_dim + out_channels,
                              root_residual=root_residual, block=block,
                              block_kwargs=bk)

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


# variants (reference dla.py:307-374); Res2Net bodies are not ported
DLA_VARIANTS = {
    "DLA-34-FPN": dict(levels=(1, 1, 1, 2, 2, 1),
                       channels=(16, 32, 64, 128, 256, 512)),
    "DLA-MINI-FPN": dict(levels=(1, 1, 1, 2, 2, 1),
                         channels=(8, 16, 16, 32, 64, 64)),
    "DLA-46-C-FPN": dict(levels=(1, 1, 1, 2, 2, 1),
                         channels=(16, 32, 64, 64, 128, 256),
                         block=Bottleneck),
    "DLA-46-XC-FPN": dict(levels=(1, 1, 1, 2, 2, 1),
                          channels=(16, 32, 64, 64, 128, 256),
                          block=Bottleneck,
                          block_kwargs=dict(cardinality=32, base_width=4)),
    "DLA-60-FPN": dict(levels=(1, 1, 1, 2, 3, 1),
                       channels=(16, 32, 128, 256, 512, 1024),
                       block=Bottleneck),
    "DLA-102-FPN": dict(levels=(1, 1, 1, 3, 4, 1),
                        channels=(16, 32, 128, 256, 512, 1024),
                        block=Bottleneck, residual_root=True),
    "DLA-169-FPN": dict(levels=(1, 1, 2, 3, 5, 1),
                        channels=(16, 32, 128, 256, 512, 1024),
                        block=Bottleneck, residual_root=True),
}


class DLA(nn.Module):
    """DLA feature extractor: NHWC image -> NCHW maps at strides 4..32.

    ``stage_with_dcn`` turns the 3x3 of Bottleneck stages deformable; a
    BasicBlock body ignores it, as the JAX package does."""

    def __init__(self, levels, channels, block=BasicBlock,
                 residual_root: bool = False, block_kwargs=None,
                 stage_with_dcn=(False,) * 6):
        super().__init__()
        ch = channels
        if levels[0] != 1 or levels[1] != 1:
            raise ValueError("the S2D stem needs single-conv levels 0 and 1")

        def kwargs(stage):
            kw = dict(block_kwargs or {})
            if stage_with_dcn[stage] and block is Bottleneck:
                kw["with_dcn"] = True
            return kw

        self.stem = S2DStem(ch[0], ch[1])
        self.level2 = Tree(levels[2], ch[1], ch[2], 2,
                           root_residual=residual_root, block=block,
                           block_kwargs=kwargs(2))
        self.level3 = Tree(levels[3], ch[2], ch[3], 2, level_root=True,
                           root_residual=residual_root, block=block,
                           block_kwargs=kwargs(3))
        self.level4 = Tree(levels[4], ch[3], ch[4], 2, level_root=True,
                           root_residual=residual_root, block=block,
                           block_kwargs=kwargs(4))
        self.level5 = Tree(levels[5], ch[4], ch[5], 2, level_root=True,
                           root_residual=residual_root, block=block,
                           block_kwargs=kwargs(5))

    def forward(self, x_nhwc):
        x2 = self.level2(self.stem(x_nhwc))
        x3 = self.level3(x2)
        x4 = self.level4(x3)
        x5 = self.level5(x4)
        return [x2, x3, x4, x5]


def build_dla(conv_body: str, stage_with_dcn=(False,) * 6) -> DLA:
    if conv_body not in DLA_VARIANTS:
        raise KeyError(f"backbone {conv_body} is not ported yet; "
                       f"choices: {sorted(DLA_VARIANTS)}")
    return DLA(stage_with_dcn=tuple(stage_with_dcn),
               **DLA_VARIANTS[conv_body])
