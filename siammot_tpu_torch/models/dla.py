"""DLA backbone (port of ``siammot_tpu.models.dla``): DLA-34, DLA-MINI,
the Bottleneck bodies DLA-46-C, 46-XC, 60, 102 and 169, with deformable
3x3s (kernel 9) on the stages ``stage_with_dcn`` names, and the Res2Net
body DLA-60-RES2NET (``Bottle2neck``).

Module names and nesting follow the flax modules, so the JAX parameter
tree loads key by key (``utils/weights.py``).  Tensors run NCHW
internally (channels-last memory on the card); the convolutions are
``F.conv2d``, as the JAX package leaves them to XLA.  FrozenBN is a
per-channel affine ``x * scale + bias`` (maskrcnn FrozenBatchNorm2d with
the statistics folded in).  The stem is the space-to-depth form the JAX
package trains (``S2DStem``) or, with ``s2d_stem`` False, the plain one
(``base_conv`` 7x7, ``level0``, ``level1``), the reference ``.pth``'s.

``TPU.CONV_MATMUL_STAGES`` names the stages whose 3x3 convolutions the
JAX package computes as an explicit im2col matmul
(``siammot_tpu/models/dla.py:conv3x3_matmul``): the same taps on the same
parameters, an exact rewrite of the convolution for the TPU's matrix
unit.  The port computes those stages with the convolution it already
runs (cuDNN on the card), so the key takes no route of its own here.
"""

from __future__ import annotations

import math

import numpy as np
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


class Bottle2neck(nn.Module):
    """Res2Net bottleneck (reference ``DlaBottle2neck``, dla.py:108-170):
    a 1x1 to ``scale`` splits of ``mid`` channels; splits 0..scale-2 go
    through grouped 3x3s with a running-sum cascade (off on stride-2
    blocks, where the last split is average-pooled, padded zeros counted,
    instead of passed through); concat -> 1x1 -> residual."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dilation: int = 1, scale: int = 4, cardinality: int = 8,
                 base_width: int = 4, expansion: int = 2):
        super().__init__()
        mid = int(math.floor(planes * (base_width / 64))
                  * cardinality) // expansion
        self.mid, self.scale, self.stride = mid, scale, stride
        self.conv1 = conv(cin, mid * scale, 1)
        self.bn1 = FrozenBN(mid * scale)
        for i in range(max(1, scale - 1)):
            setattr(self, f"convs_{i}", nn.Conv2d(
                mid, mid, 3, stride=stride, padding=dilation,
                dilation=dilation, groups=cardinality, bias=False))
            setattr(self, f"bns_{i}", FrozenBN(mid))
        self.conv3 = conv(mid * scale, planes, 1)
        self.bn3 = FrozenBN(planes)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        is_first = self.stride > 1
        out = F.relu(self.bn1(self.conv1(x)))
        spx = torch.split(out, self.mid, dim=1)
        spo = []
        sp = None
        for i in range(max(1, self.scale - 1)):
            sp = spx[i] if i == 0 or is_first else sp + spx[i]
            sp = getattr(self, f"convs_{i}")(sp)
            sp = F.relu(getattr(self, f"bns_{i}")(sp))
            spo.append(sp)
        if self.scale > 1:
            last = spx[-1]
            if is_first:
                last = F.avg_pool2d(last, 3, self.stride, 1,
                                    count_include_pad=True)
            spo.append(last)
        out = self.bn3(self.conv3(torch.cat(spo, dim=1)))
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


# -- the plain stem's weights <-> the S2D stem's (own copies of
# ``siammot_tpu/models/dla.py:_phase_decompose``, ``stem_to_s2d`` and
# ``s2d_to_stem``; numpy, HWIO kernels, as the flax tree holds them) -------

def _phase_decompose(kernel: np.ndarray, pad: int, out_phases: bool):
    """Standard [kh, kw, ci, co] stride-1 kernel -> S2D kernel.

    S2D input channels are ordered (alpha, beta, c); output channels
    (a, b, o) when ``out_phases`` (stride-1 full-res output) else plain o
    (stride-2 output on the phase grid, i.e. a = b = 0).
    """
    kh, kw, ci, co = kernel.shape
    a_range = (0, 1) if out_phases else (0,)
    # tap index s = a + u - pad = 2U + alpha
    s_lo = min(a_range) - pad
    s_hi = max(a_range) + kh - 1 - pad
    u_lo, u_hi = s_lo >> 1, s_hi >> 1
    kh2 = u_hi - u_lo + 1
    n_out = 4 * co if out_phases else co
    out = np.zeros((kh2, kh2, 4 * ci, n_out), kernel.dtype)
    for a in a_range:
        for b_ in a_range:
            for u in range(kh):
                for v in range(kw):
                    sy, sx = a + u - pad, b_ + v - pad
                    uy, al = sy >> 1, sy & 1
                    ux, be = sx >> 1, sx & 1
                    oc = slice((a * 2 + b_) * co, (a * 2 + b_ + 1) * co) \
                        if out_phases else slice(0, co)
                    ic = slice((al * 2 + be) * ci, (al * 2 + be + 1) * ci)
                    out[uy - u_lo, ux - u_lo, ic, oc] = kernel[u, v]
    return out, (-u_lo, u_hi)


def stem_to_s2d(base_k, base_bn, l0_k, l0_bn, l1_k, l1_bn) -> dict:
    """Map standard stem weights (HWIO kernels + {scale, bias} FrozenBN
    pairs) onto the S2D stem's flax tree.  Exact."""

    def tile_bn(bn):
        return {"scale": np.tile(np.asarray(bn["scale"]), 4),
                "bias": np.tile(np.asarray(bn["bias"]), 4)}

    k_base, _ = _phase_decompose(np.asarray(base_k), pad=3, out_phases=True)
    k_l0, _ = _phase_decompose(np.asarray(l0_k), pad=1, out_phases=True)
    k_l1, _ = _phase_decompose(np.asarray(l1_k), pad=1, out_phases=False)
    return {
        "s2d_base_conv": {"kernel": k_base},
        "s2d_base_bn": tile_bn(base_bn),
        "s2d_level0_conv": {"kernel": k_l0},
        "s2d_level0_bn": tile_bn(l0_bn),
        "s2d_level1_conv": {"kernel": k_l1},
        "s2d_level1_bn": {"scale": np.asarray(l1_bn["scale"]),
                          "bias": np.asarray(l1_bn["bias"])},
    }


def s2d_to_stem(s2d: dict, c0: int, c1: int) -> dict:
    """Inverse of ``stem_to_s2d``: recover the standard stem weights.
    Every original tap appears once in each output-phase block, so the
    (a, b) = (0, 0) block suffices."""

    def un_phase(k2, kh, pad, ci, co):
        k = np.zeros((kh, kh, ci, co), np.asarray(k2).dtype)
        u_lo = (-pad) >> 1
        for u in range(kh):
            for v in range(kh):
                sy, sx = u - pad, v - pad
                uy, al = sy >> 1, sy & 1
                ux, be = sx >> 1, sx & 1
                ic = slice((al * 2 + be) * ci, (al * 2 + be + 1) * ci)
                k[u, v] = np.asarray(k2)[uy - u_lo, ux - u_lo, ic, :co]
        return k

    def untile_bn(bn, c):
        return {"scale": np.asarray(bn["scale"])[:c],
                "bias": np.asarray(bn["bias"])[:c]}

    return {
        "base_conv": {"kernel": un_phase(
            s2d["s2d_base_conv"]["kernel"], 7, 3, 3, c0)},
        "base_bn": untile_bn(s2d["s2d_base_bn"], c0),
        "level0_conv0": {"kernel": un_phase(
            s2d["s2d_level0_conv"]["kernel"], 3, 1, c0, c0)},
        "level0_bn0": untile_bn(s2d["s2d_level0_bn"], c0),
        "level1_conv0": {"kernel": un_phase(
            s2d["s2d_level1_conv"]["kernel"], 3, 1, c0, c1)},
        "level1_bn0": {"scale": np.asarray(s2d["s2d_level1_bn"]["scale"]),
                       "bias": np.asarray(s2d["s2d_level1_bn"]["bias"])},
    }


# variants (reference dla.py:307-374)
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
    "DLA-60-RES2NET-FPN": dict(levels=(1, 1, 1, 2, 3, 1),
                               channels=(16, 32, 128, 256, 512, 1024),
                               block=Bottle2neck,
                               block_kwargs=dict(cardinality=1,
                                                 base_width=28)),
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
    BasicBlock or Bottle2neck body ignores it, as the JAX package does.
    ``s2d_stem`` picks the space-to-depth stem, else the plain one."""

    def __init__(self, levels, channels, block=BasicBlock,
                 residual_root: bool = False, block_kwargs=None,
                 stage_with_dcn=(False,) * 6, s2d_stem: bool = True):
        super().__init__()
        ch = channels
        self.s2d_stem = s2d_stem
        self.stem_levels = tuple(levels[:2])

        def kwargs(stage):
            kw = dict(block_kwargs or {})
            if stage_with_dcn[stage] and block is Bottleneck:
                kw["with_dcn"] = True
            return kw

        if s2d_stem:
            if levels[0] != 1 or levels[1] != 1:
                raise ValueError("the S2D stem needs single-conv levels 0 "
                                 "and 1")
            self.stem = S2DStem(ch[0], ch[1])
        else:
            self.base_conv = conv(3, ch[0], 7)
            self.base_bn = FrozenBN(ch[0])
            for lvl, cin, cout in ((0, ch[0], ch[0]), (1, ch[0], ch[1])):
                for i in range(levels[lvl]):
                    setattr(self, f"level{lvl}_conv{i}",
                            conv(cin if i == 0 else cout, cout, 3,
                                 lvl + 1 if i == 0 else 1))
                    setattr(self, f"level{lvl}_bn{i}", FrozenBN(cout))
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

    def plain_stem(self, x_nhwc):
        """base(7x7) -> level0 (stride 1) -> level1 (stride 2)."""
        x = F.relu(self.base_bn(self.base_conv(x_nhwc.permute(0, 3, 1, 2))))
        for lvl, n in enumerate(self.stem_levels):
            for i in range(n):
                x = getattr(self, f"level{lvl}_conv{i}")(x)
                x = F.relu(getattr(self, f"level{lvl}_bn{i}")(x))
        return x

    def forward(self, x_nhwc):
        x1 = self.stem(x_nhwc) if self.s2d_stem else self.plain_stem(x_nhwc)
        x2 = self.level2(x1)
        x3 = self.level3(x2)
        x4 = self.level4(x3)
        x5 = self.level5(x4)
        return [x2, x3, x4, x5]


def build_dla(conv_body: str, stage_with_dcn=(False,) * 6,
              s2d_stem: bool = True) -> DLA:
    if conv_body not in DLA_VARIANTS:
        raise KeyError(f"unknown backbone {conv_body}; "
                       f"choices: {sorted(DLA_VARIANTS)}")
    return DLA(stage_with_dcn=tuple(stage_with_dcn), s2d_stem=s2d_stem,
               **DLA_VARIANTS[conv_body])
