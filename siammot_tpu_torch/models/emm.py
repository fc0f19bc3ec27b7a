"""EMM (Explicit Motion Model) Siamese track head
(port of ``siammot_tpu.models.emm``).

Inference, over K padded track slots: 15x15 template crops and 30x30
search-region crops from the windowed pool (kernel 1), masked depthwise
xcorr (kernel 2), the masked predictor towers (kernel 3, or kernel 8 with
``SIAMMOT_PREDICTOR_BLOCK``), and the fused response decode (kernel 4, or
kernel 5 past s_hi 512) whose box epilogue stays in plain torch.  Dead
slots ride along as masked lanes.  With ``TPU.MASKED_TRACK_KERNELS``
False (``valid`` None) the head runs the JAX package's unmasked route:
the unmasked xcorr (kernel 6's forward), the predictor over every slot
and the ungated decode (kernel 10, or kernel 5 ungated); dead slots then
carry the bias-derived maps of a zero response, and every consumer masks
them on occupancy.

Training, over sampled track pairs: the differentiable pool (kernels 1
and 7), the unmasked xcorr with its gradient kernels (kernel 6), the
predictor towers as ``F.conv2d`` + GroupNorm + ReLU with gradients (the
JAX training step runs flax convolutions there, not a Pallas kernel),
and the FCOS-style EMM loss (``siammot_tpu/models/emm.py:475-552``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core import boxes as box_ops
from ..ops.decode import decode_argmax
from ..ops.predictor import emm_predictor, emm_predictor_blocked
from ..ops.roi_align_windowed import windowed_pool
from ..ops.upsample import bicubic_matrix
from ..ops.xcorr import xcorr_depthwise_auto, xcorr_depthwise_masked


@dataclasses.dataclass(frozen=True)
class EMMConfig:
    resolution: int            # template size (15)
    scales: tuple              # pooler scales
    sampling_ratio: int
    search_region: float       # SR box = box extended by (search_region - 1)
    min_search_wh: float
    pad_pixels: int
    use_centerness: bool
    cosine_window_weight: float
    amodal: bool
    cls_pos_region: float = 0.8
    track_loss_weight: float = 1.0

    @property
    def sr_size(self) -> int:
        return int(self.resolution * self.search_region)

    @property
    def response_size(self) -> int:
        return self.sr_size - self.resolution + 1

    @staticmethod
    def from_cfg(cfg) -> "EMMConfig":
        t = cfg.MODEL.TRACK_HEAD
        return EMMConfig(
            resolution=t.POOLER_RESOLUTION,
            scales=tuple(t.POOLER_SCALES),
            sampling_ratio=t.POOLER_SAMPLING_RATIO,
            search_region=t.SEARCH_REGION,
            min_search_wh=t.MINIMUM_SREACH_REGION,
            pad_pixels=t.PAD_PIXELS,
            use_centerness=t.EMM.USE_CENTERNESS,
            cosine_window_weight=t.EMM.COSINE_WINDOW_WEIGHT,
            amodal=bool(cfg.INPUT.AMODAL),
            cls_pos_region=t.EMM.CLS_POS_REGION,
            track_loss_weight=t.EMM.TRACK_LOSS_WEIGHT)


class _Conv3x3(nn.Module):
    """3x3 conv parameters in HWIO, the layout kernel 3 reads."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(3, 3, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        """3x3 SAME conv of NCHW ``x`` (the training form)."""
        return F.conv2d(x, self.kernel.permute(3, 2, 0, 1), self.bias,
                        padding=1)


class _GroupNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x, groups: int = 32, eps: float = 1e-5):
        """GroupNorm of NCHW ``x`` as flax's: f32 statistics with
        ``var = E[x^2] - E[x]^2``, the affine in the input dtype."""
        n, c, h, w = x.shape
        xf = x.float().reshape(n, groups, c // groups, h, w)
        mean = xf.mean(dim=(2, 3, 4), keepdim=True)
        var = (xf * xf).mean(dim=(2, 3, 4), keepdim=True) - mean * mean
        y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(n, c, h, w)
        return (y.to(x.dtype) * self.scale[:, None, None]
                + self.bias[:, None, None])


def predictor_block(k: int):
    """The slot block of kernel 8, read where the JAX package reads it
    (``siammot_tpu/models/emm.py:180``): ``SIAMMOT_PREDICTOR_BLOCK`` = B
    with B > 1 and K % B == 0, else None (kernel 3).  JAX also checks a
    TPU VMEM estimate there; the port drops it: kernel 8 computes kernel
    3's function, so the choice moves no result."""
    blk = int(os.environ.get("SIAMMOT_PREDICTOR_BLOCK", "0"))
    return blk if blk > 1 and k % blk == 0 else None


class EMMPredictor(nn.Module):
    """cls/reg towers + heads (reference feature_extractor.py:43-68),
    computed by kernel 3 (or 8) with the tower conv bias (PARITY.md #12).
    At s = 61 (``SEARCH_REGION`` 5) JAX's predictor kernel fails its 10 MB
    VMEM gate and JAX takes the XLA form there; the port keeps kernel 3,
    the same function on the live slots."""

    def __init__(self, c: int):
        super().__init__()
        self.cls_tower_conv = _Conv3x3(c, c)
        self.cls_tower_gn = _GroupNorm(c)
        self.reg_tower_conv = _Conv3x3(c, c)
        self.reg_tower_gn = _GroupNorm(c)
        self.cls = _Conv3x3(c, 2)
        self.center = _Conv3x3(c, 1)
        self.reg = _Conv3x3(c, 4)

    def forward(self, x, valid):
        params = {n: p.detach() for n, p in self.named_parameters()}
        blk = predictor_block(x.shape[0])
        if blk is not None:
            return emm_predictor_blocked(x, valid, params, blk)
        return emm_predictor(x, valid, params)

    def forward_train(self, x):
        """Towers and heads with gradients over NHWC ``x`` [N, S, S, C];
        returns NHWC (cls, center, reg) in the parameters' dtype."""
        x = x.permute(0, 3, 1, 2)
        cls_x = F.relu(self.cls_tower_gn(self.cls_tower_conv(x)))
        reg_x = F.relu(self.reg_tower_gn(self.reg_tower_conv(x)))
        outs = (self.cls(cls_x), self.center(cls_x),
                F.relu(self.reg(reg_x)))
        return tuple(o.permute(0, 2, 3, 1) for o in outs)


class EMMHead(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.predictor = EMMPredictor(c)

    def forward(self, sr_features, template_features, valid):
        """Inference head; ``valid`` None is the unmasked route."""
        if valid is None:
            # the unmasked route: every slot through the xcorr and the
            # predictor.  JAX runs the predictor's XLA form here; the port
            # runs kernel 3 (or 8) over every slot, the same function: on
            # the card cuDNN's choice of f32 convolution algorithm moved
            # the decode's argmax against the JAX rows (PERF.md, section 6)
            response = xcorr_depthwise_auto(sr_features, template_features)
            every = torch.ones(response.shape[0], dtype=torch.bool,
                               device=response.device)
            return self.predictor(response.to(sr_features.dtype), every)
        response = xcorr_depthwise_masked(sr_features, template_features,
                                          valid)
        # the xcorr sums in f32; the predictor runs in the head dtype
        return self.predictor(response.to(sr_features.dtype), valid)

    def forward_train(self, sr_features, template_features):
        """Training head over every pair: kernel 6 and its gradient, then
        the predictor with gradients; outputs in the head dtype."""
        response = xcorr_depthwise_auto(sr_features, template_features)
        return self.predictor.forward_train(response.to(sr_features.dtype))


def pool_template(pack, boxes, ecfg: EMMConfig, window: int, valid,
                  img_idx=None):
    """15x15 template crops at track boxes (unpadded coords) of images
    ``img_idx`` (default 0); dead rows pool to zeros, and ``valid=None``
    is the differentiable training pool."""
    levels = box_ops.map_rois_to_levels(boxes, 2, 2 + len(ecfg.scales) - 1)
    if img_idx is None:
        img_idx = torch.zeros_like(levels)
    return windowed_pool(pack, boxes, img_idx, levels, ecfg.resolution,
                         ecfg.sampling_ratio, window, valid=valid)


def pool_search_region(pack, template_boxes, sr_boxes, ecfg: EMMConfig,
                       window: int, valid, img_idx=None):
    """30x30 SR crops: level from the template box, crop from the SR box
    in padded coords (reference sr_pool.py:64-74)."""
    levels = box_ops.map_rois_to_levels(template_boxes, 2,
                                        2 + len(ecfg.scales) - 1)
    if img_idx is None:
        img_idx = torch.zeros_like(levels)
    return windowed_pool(pack, sr_boxes, img_idx, levels, ecfg.sr_size,
                         ecfg.sampling_ratio, window,
                         pad_pixels=ecfg.pad_pixels, valid=valid)


def make_search_region(boxes: torch.Tensor, ecfg: EMMConfig) -> torch.Tensor:
    """Padded-coordinate SR boxes from track boxes (reference
    ``extract_cache``: shift by PAD_PIXELS, then ``extend_bbox``)."""
    return box_ops.extend_box(boxes + ecfg.pad_pixels,
                              ecfg.search_region - 1.0, ecfg.min_search_wh)


def _hann_window(size: int) -> np.ndarray:
    """Periodic Hann (torch.hann_window default), outer product, flat."""
    w = 0.5 * (1 - np.cos(2 * np.pi * np.arange(size) / size))
    return np.outer(w, w).reshape(-1).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _decode_constants(s_lo: int, up_scale: int, device: str):
    s_hi = s_lo * up_scale
    u = torch.tensor(bicubic_matrix(s_lo, up_scale), device=device)
    window = torch.as_tensor(_hann_window(s_hi).reshape(s_hi, s_hi),
                             device=device)
    return u, window


def decode_response_fused(cls_logits, center_logits, reg_logits, sr_boxes,
                          template_boxes, ecfg: EMMConfig, up_scale: int,
                          valid):
    """Upsample + decode, materialising only what the argmax needs.

    Bicubic upsampling is linear, so the 2-class softmax becomes a
    sigmoid of the logit difference and the scale penalty needs only
    l+r and t+b: the decode kernel (4, 10 with ``valid`` None, 5 past
    s_hi 512) upsamples those 4 channels, penalises and arg-maxes.  The
    regression vector and the image-space location are then evaluated at
    the argmax only.  Returns (boxes [K, 4], scores [K]).
    """
    k, s_lo = cls_logits.shape[:2]
    u, window = _decode_constants(s_lo, up_scale, str(cls_logits.device))
    s_hi = s_lo * up_scale

    x4 = torch.stack([cls_logits[..., 1] - cls_logits[..., 0],
                      center_logits[..., 0],
                      reg_logits[..., 0] + reg_logits[..., 2],
                      reg_logits[..., 1] + reg_logits[..., 3]],
                     dim=1).float().contiguous()
    wh = torch.stack([template_boxes[:, 2] - template_boxes[:, 0],
                      template_boxes[:, 3] - template_boxes[:, 1]],
                     dim=-1).contiguous()
    idx, score = decode_argmax(x4, wh, u, window, valid,
                               float(ecfg.cosine_window_weight),
                               bool(ecfg.use_centerness))
    idx = idx.long()
    iy = torch.div(idx, s_hi, rounding_mode="floor")
    ix = idx % s_hi

    # regression vector at the argmax only
    reg = torch.einsum("kh,khwc,kw->kc", u[iy], reg_logits.float(), u[ix])

    # image-space location of the argmax (response_locations math)
    border = int(math.floor(ecfg.resolution / 2)) * up_scale
    s_full = ecfg.sr_size * up_scale
    stride = (sr_boxes[:, 2:] - sr_boxes[:, :2]) / (s_full - 1)
    cx = sr_boxes[:, 0] + (border + ix) * stride[:, 0] - ecfg.pad_pixels
    cy = sr_boxes[:, 1] + (border + iy) * stride[:, 1] - ecfg.pad_pixels
    out = torch.stack([cx - reg[:, 0], cy - reg[:, 1],
                       cx + reg[:, 2], cy + reg[:, 3]], dim=-1)
    return out, score


# -- training targets and loss (reference EMM/track_loss.py:62-158) --------

def response_locations(sr_boxes: torch.Tensor, sr_size: int,
                       template_size: int, pad_pixels: int,
                       up_scale: int) -> torch.Tensor:
    """Image-space (x, y) of every response-map cell, [K, L, 2]: the SR
    grid spans the SR box with stride extent / (S*up - 1), the valid
    correlation drops floor(T/2)*up cells at each border, and coordinates
    shift back by PAD_PIXELS."""
    s = sr_size * up_scale
    border = int(math.floor(template_size / 2)) * up_scale
    idx = torch.arange(s, dtype=torch.float32,
                       device=sr_boxes.device)[border:s - border]
    stride = (sr_boxes[:, 2:] - sr_boxes[:, :2]) / (s - 1)
    xs = sr_boxes[:, 0:1] + idx[None, :] * stride[:, 0:1]
    ys = sr_boxes[:, 1:2] + idx[None, :] * stride[:, 1:2]
    n, m = xs.shape
    loc = torch.stack([xs[:, None, :].expand(n, m, m),
                       ys[:, :, None].expand(n, m, m)], dim=-1)
    return loc.reshape(n, m * m, 2) - pad_pixels


def emm_targets(locations, tar_boxes, pos_region: float):
    """FCOS-style targets: a cell is positive inside the central
    ``pos_region`` band of its target box in both axes.  Returns
    (labels [K, L] int32 in {0, 1}, reg_targets [K, L, 4] ltrb)."""
    xs, ys = locations[..., 0], locations[..., 1]
    l = xs - tar_boxes[:, None, 0]
    t = ys - tar_boxes[:, None, 1]
    r = tar_boxes[:, None, 2] - xs
    b = tar_boxes[:, None, 3] - ys
    half_w = (tar_boxes[:, None, 2] - tar_boxes[:, None, 0]) / 2.0
    half_h = (tar_boxes[:, None, 3] - tar_boxes[:, None, 1]) / 2.0
    pos = ((l > pos_region * half_w) & (r > pos_region * half_w)
           & (t > pos_region * half_h) & (b > pos_region * half_h))
    return pos.to(torch.int32), torch.stack([l, t, r, b], dim=-1)


def _centerness(reg):
    lr = torch.stack([reg[..., 0], reg[..., 2]], -1)
    tb = torch.stack([reg[..., 1], reg[..., 3]], -1)
    c = (lr.amin(-1) / lr.amax(-1).clamp(min=1e-10)) \
        * (tb.amin(-1) / tb.amax(-1).clamp(min=1e-10))
    return torch.sqrt(c.clamp(min=0.0))


def _iou_loss(pred, target):
    """-log IoU with +1 smoothing (reference IOULoss)."""
    t_area = (target[..., 0] + target[..., 2]) \
        * (target[..., 1] + target[..., 3])
    p_area = (pred[..., 0] + pred[..., 2]) * (pred[..., 1] + pred[..., 3])
    w_i = torch.minimum(pred[..., 0], target[..., 0]) \
        + torch.minimum(pred[..., 2], target[..., 2])
    h_i = torch.minimum(pred[..., 1], target[..., 1]) \
        + torch.minimum(pred[..., 3], target[..., 3])
    inter = w_i * h_i
    union = t_area + p_area - inter
    return -torch.log((inter + 1.0) / (union + 1.0))


def emm_loss(cls_logits, center_logits, reg_logits, locations, tar_boxes,
             slot_valid, ecfg: EMMConfig) -> dict:
    """Balanced class NLL + centerness-weighted IoU + centerness BCE, each
    times TRACK_LOSS_WEIGHT; ``slot_valid`` masks padded slots."""
    k, s = cls_logits.shape[:2]
    n_cells = s * s
    labels, reg_t = emm_targets(locations, tar_boxes, ecfg.cls_pos_region)
    labels = torch.where(slot_valid[:, None], labels,
                         torch.full_like(labels, -1))
    zero = cls_logits.new_zeros(())

    logp = F.log_softmax(cls_logits.reshape(k, n_cells, 2), dim=-1)
    pos = labels == 1
    neg = labels == 0
    n_pos = pos.sum()
    nll_pos = -torch.where(pos, logp[..., 1], zero).sum() / n_pos.clamp(min=1)
    nll_neg = -torch.where(neg, logp[..., 0], zero).sum() \
        / neg.sum().clamp(min=1)
    cls_loss = 0.5 * nll_pos + 0.5 * nll_neg

    one = torch.ones_like(reg_t)
    cness = _centerness(torch.where(pos[..., None], reg_t, one))
    w = torch.where(pos, cness, zero)
    # masked lanes are sanitised before the log, so neither the value nor
    # the gradient can turn NaN
    safe_pred = torch.where(pos[..., None],
                            reg_logits.reshape(k, n_cells, 4), one)
    iou_l = _iou_loss(safe_pred, torch.where(pos[..., None], reg_t, one))
    reg_loss = (w * iou_l).sum() / w.sum().clamp(min=1e-10)
    reg_loss = torch.where(n_pos > 0, reg_loss, zero)

    cl = center_logits.reshape(k, n_cells)
    bce = cl.clamp(min=0) - cl * cness + torch.log1p(torch.exp(-cl.abs()))
    center_loss = torch.where(pos, bce, zero).sum() / n_pos.clamp(min=1)
    center_loss = torch.where(n_pos > 0, center_loss, zero)

    lw = ecfg.track_loss_weight
    return {"loss_tracker_class": lw * cls_loss,
            "loss_tracker_motion": lw * reg_loss,
            "loss_tracker_center": lw * center_loss}
