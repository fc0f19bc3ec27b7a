"""EMM (Explicit Motion Model) Siamese track head, inference
(port of ``siammot_tpu.models.emm``).

Over K padded track slots: 15x15 template crops and 30x30 search-region
crops from the windowed pool (kernel 1), masked depthwise xcorr
(kernel 2), the masked predictor towers (kernel 3), and the fused
response decode (kernel 4) whose box epilogue stays in plain torch.
Dead slots ride along as masked lanes.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn as nn

from ..core import boxes as box_ops
from ..ops.decode import emm_decode
from ..ops.predictor import emm_predictor
from ..ops.roi_align_windowed import windowed_pool
from ..ops.upsample import bicubic_matrix
from ..ops.xcorr import xcorr_depthwise_masked


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
            amodal=bool(cfg.INPUT.AMODAL))


class _Conv3x3(nn.Module):
    """3x3 conv parameters in HWIO, the layout kernel 3 reads."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(3, 3, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))


class _GroupNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))


class EMMPredictor(nn.Module):
    """cls/reg towers + heads (reference feature_extractor.py:43-68),
    computed by kernel 3 with the tower conv bias (PARITY.md #12)."""

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
        return emm_predictor(x, valid, params)


class EMMHead(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.predictor = EMMPredictor(c)

    def forward(self, sr_features, template_features, valid):
        response = xcorr_depthwise_masked(sr_features, template_features,
                                          valid)
        # the xcorr sums in f32; the predictor runs in the head dtype
        return self.predictor(response.to(sr_features.dtype), valid)


def pool_template(pack, boxes, ecfg: EMMConfig, window: int, valid):
    """15x15 template crops at track boxes (unpadded coords); dead rows
    pool to zeros."""
    levels = box_ops.map_rois_to_levels(boxes, 2, 2 + len(ecfg.scales) - 1)
    return windowed_pool(pack, boxes, torch.zeros_like(levels), levels,
                         ecfg.resolution, ecfg.sampling_ratio, window,
                         valid=valid)


def pool_search_region(pack, template_boxes, sr_boxes, ecfg: EMMConfig,
                       window: int, valid):
    """30x30 SR crops: level from the template box, crop from the SR box
    in padded coords (reference sr_pool.py:64-74)."""
    levels = box_ops.map_rois_to_levels(template_boxes, 2,
                                        2 + len(ecfg.scales) - 1)
    return windowed_pool(pack, sr_boxes, torch.zeros_like(levels), levels,
                         ecfg.sr_size, ecfg.sampling_ratio, window,
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
    l+r and t+b: kernel 4 upsamples those 4 channels, penalises and
    arg-maxes.  The regression vector and the image-space location are
    then evaluated at the argmax only.  Returns (boxes [K, 4], scores [K]).
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
    idx, score = emm_decode(x4, wh, u, window, valid,
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
