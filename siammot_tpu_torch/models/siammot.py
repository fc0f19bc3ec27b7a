"""SiamMOT inference step (port of ``siammot_tpu.models.siammot``).

DLA-FPN backbone -> RPN -> shared box-head pass over proposals and
propagated tracks -> EMM track head over K padded slots -> track solver
-> next-frame TrackState, one frame per ``forward_inference`` call.  The
four kernels of the step (window pool, masked xcorr, masked predictor,
decode) are CUDA kernels on the card; the convolutions and matrix
products around them stay ``F.conv2d`` / ``torch.matmul``, as the JAX
package leaves them to XLA.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn

from ..core import boxes as box_ops
from ..core.structures import Boxes, concat_boxes
from .box_head import BoxHead, BoxHeadConfig, pool_levels, postprocess
from .dla import DLA_VARIANTS, build_dla
from .emm import (EMMConfig, EMMHead, decode_response_fused,
                  make_search_region, pool_search_region, pool_template)
from .fpn import FPN
from .rpn import (RPNConfig, RPNHead, base_anchors, grid_anchors,
                  select_proposals, topk)
from .track_solver import SolverConfig, solve
from .track_state import TrackState, rebuild_state
from ..ops.roi_align_windowed import pack_levels

UPSCALE = 16  # the reference upsamples response maps x16


def normalize_images(images: torch.Tensor, pixel_mean, pixel_std,
                     to_bgr255: bool = False, frame_sizes=None):
    """uint8 [B, H, W, 3] -> normalised f32, pad beyond ``frame_sizes``
    [B, 2] (w, h) re-zeroed after normalising (the reference pads after
    normalising).  Non-uint8 input passes through."""
    if images.dtype != torch.uint8:
        return images
    x = images.to(torch.float32)
    x = x.flip(-1) if to_bgr255 else x / 255.0
    mean = torch.tensor(pixel_mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(pixel_std, dtype=torch.float32, device=x.device)
    x = (x - mean) / std
    if frame_sizes is not None:
        h, w = x.shape[1:3]
        xs = torch.arange(w, device=x.device)[None, None, :, None]
        ys = torch.arange(h, device=x.device)[None, :, None, None]
        fs = frame_sizes.to(x.device)
        mask = (xs < fs[:, None, None, 0:1]) & (ys < fs[:, None, None, 1:2])
        x = torch.where(mask, x, torch.zeros((), device=x.device))
    return x


class SiamMOTNet(nn.Module):
    """Parameter container; names nest as the flax tree does."""

    def __init__(self, conv_body: str, channels: int, num_anchors: int,
                 box_resolution: int, box_sampling: int, mlp_dim: int,
                 num_classes: int, window_box: int):
        super().__init__()
        self.body = build_dla(conv_body)
        stage_channels = DLA_VARIANTS[conv_body]["channels"][2:6]
        self.fpn = FPN(stage_channels, channels)
        self.rpn = RPNHead(channels, num_anchors)
        self.box = BoxHead(channels, box_resolution, box_sampling, mlp_dim,
                           num_classes, window_box)
        self.emm = EMMHead(channels)


class SiamMOT:
    """Builder + per-frame inference for one configuration.

    ``device`` defaults to the card; a missing card raises.  Pass
    ``device="cpu"`` to run the kernels' plain versions on the CPU.
    """

    def __init__(self, cfg, device: str = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SiamMOT: no CUDA device (pass device='cpu' "
                               "for the plain CPU path)")
        tpu = cfg.TPU
        off = [k for k in ("USE_PALLAS", "POOLER_WINDOWED", "DECODE_PALLAS",
                           "MASKED_TRACK_KERNELS", "S2D_STEM") if not tpu[k]]
        if off:
            raise ValueError(f"the port implements only the default "
                             f"kernel path; TPU.{off} must stay True")
        if any(cfg.MODEL.DLA.STAGE_WITH_DCN):
            raise ValueError("deformable stages are not ported yet")
        body = cfg.MODEL.BACKBONE.CONV_BODY
        if body not in DLA_VARIANTS:
            raise KeyError(f"backbone {body} is not ported yet; "
                           f"choices: {sorted(DLA_VARIANTS)}")
        expect = tuple(DLA_VARIANTS[body]["channels"][2:6])
        got = tuple(getattr(cfg.MODEL.DLA, f"DLA_STAGE{i}_OUT_CHANNELS")
                    for i in (2, 3, 4, 5))
        if got != expect:
            raise ValueError(f"MODEL.DLA.DLA_STAGE*_OUT_CHANNELS {got} do "
                             f"not match {body}'s stage widths {expect}")
        self.channels = cfg.MODEL.DLA.BACKBONE_OUT_CHANNELS
        self.num_classes = cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES
        self.box_scales = tuple(cfg.MODEL.ROI_BOX_HEAD.POOLER_SCALES)
        self.ecfg = EMMConfig.from_cfg(cfg)
        self.hcfg = BoxHeadConfig.from_cfg(cfg)
        self.scfg = SolverConfig.from_cfg(cfg)
        self.rcfg = RPNConfig.from_cfg(cfg)
        self.max_tracks = tpu.MAX_TRACKS
        self.tracktor = cfg.MODEL.TRACK_HEAD.TRACKTOR
        self.window_sr = tpu.WINDOW_SR
        self.window_template = tpu.WINDOW_TEMPLATE
        self.compute_dtype = getattr(torch, tpu.COMPUTE_DTYPE)
        self.pooler_dtype = getattr(torch, tpu.POOLER_DTYPE)
        self._cell_anchors = [
            base_anchors(s, sz, tuple(cfg.MODEL.RPN.ASPECT_RATIOS))
            for s, sz in zip(cfg.MODEL.RPN.ANCHOR_STRIDE,
                             cfg.MODEL.RPN.ANCHOR_SIZES)]
        self._anchors = {}
        # Full-f32 matrix products and convolutions: a float32 config
        # means float32 on the card too (TF32 would keep ~3 digits)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # -- construction -------------------------------------------------------

    def build_net(self) -> SiamMOTNet:
        cfg = self.cfg
        return SiamMOTNet(
            conv_body=cfg.MODEL.BACKBONE.CONV_BODY,
            channels=self.channels,
            num_anchors=len(cfg.MODEL.RPN.ASPECT_RATIOS),
            box_resolution=cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION,
            box_sampling=cfg.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO,
            mlp_dim=cfg.MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM,
            num_classes=self.num_classes,
            window_box=cfg.TPU.WINDOW_BOX)

    def cast_params(self, params: dict) -> SiamMOTNet:
        """The network on the device in the compute dtype, loaded from a
        state dict (``utils.weights.jax_to_torch``); every key must match.
        Each float tensor is cast once, here, as the JAX engine pre-casts
        its tree once per stream."""
        net = self.build_net().to(device=self.device,
                                  dtype=self.compute_dtype)
        net.load_state_dict(params, strict=True)
        net.eval().requires_grad_(False)
        if self.device.type == "cuda":
            # NHWC convolutions for cuDNN; the EMM predictor keeps its
            # HWIO kernels as they are (kernel 3 reads them contiguous)
            for m in (net.body, net.fpn, net.rpn):
                m.to(memory_format=torch.channels_last)
        return net

    def empty_state(self) -> TrackState:
        return TrackState.empty(self.max_tracks, self.ecfg.resolution,
                                self.channels, self.device)

    def anchors_for(self, image_hw):
        """Per-level anchor tensors for a padded input size (cached)."""
        key = tuple(image_hw)
        if key not in self._anchors:
            h, w = key
            self._anchors[key] = [
                torch.as_tensor(grid_anchors((-(-h // s), -(-w // s)), s,
                                             cell), device=self.device)
                for s, cell in zip(self.cfg.MODEL.RPN.ANCHOR_STRIDE,
                                   self._cell_anchors)]
        return self._anchors[key]

    # -- inference step -----------------------------------------------------

    @torch.no_grad()
    def forward_inference(self, net: SiamMOTNet, images: torch.Tensor,
                          state: TrackState, image_size=None):
        """One frame: detect + propagate + solve + update memory.

        images: [1, H, W, 3] uint8 (normalised here, pad re-zeroed) or
        normalised f32, zero-padded to the size-divisible shape.
        image_size: (w, h) of the content, for clipping; defaults to the
        padded shape.  Returns (out: Boxes over all candidate rows,
        state': TrackState).
        """
        ecfg, hcfg = self.ecfg, self.hcfg
        dt = self.compute_dtype
        images = images.to(self.device)
        h, w = images.shape[1:3]
        image_size = tuple(image_size or (w, h))
        k = self.max_tracks
        x = normalize_images(
            images, self.cfg.INPUT.PIXEL_MEAN, self.cfg.INPUT.PIXEL_STD,
            self.cfg.INPUT.TO_BGR255,
            frame_sizes=torch.tensor([image_size], dtype=torch.int32))

        feats = net.fpn(net.body(x.to(dt)))                  # NCHW, dt
        feats_nhwc = [f.permute(0, 2, 3, 1).float() for f in feats]
        pack = pack_levels(feats_nhwc[:len(self.box_scales)],
                           self.box_scales, dtype=self.pooler_dtype)

        # ---- proposals
        logits, deltas = net.rpn(feats)
        pb, ps, pv = select_proposals(
            [l.float() for l in logits], [d.float() for d in deltas],
            self.anchors_for((h, w)), image_size, self.rcfg)
        n_prop = pb.shape[1]
        prop = Boxes(boxes=pb[0], scores=ps[0],
                     ids=torch.full((n_prop,), -1, dtype=torch.int32,
                                    device=self.device),
                     labels=torch.zeros((n_prop,), dtype=torch.int32,
                                        device=self.device),
                     valid=pv[0])

        # ---- track propagation (EMM) over K padded slots; dead slots
        # skip their work in every kernel
        occupied = state.occupied
        sr_feats = pool_search_region(pack, state.boxes, state.sr, ecfg,
                                      self.window_sr, occupied)
        cls_l, ctr_l, reg_l = net.emm(sr_feats.to(dt),
                                      state.template.to(dt), occupied)
        tboxes, tconf = decode_response_fused(
            cls_l, ctr_l, reg_l, state.sr, state.boxes, ecfg, UPSCALE,
            occupied)
        tvalid = occupied
        if not ecfg.amodal:
            tboxes = box_ops.clip_to_image(tboxes, image_size)
            tvalid = tvalid & box_ops.nonempty_mask(tboxes)

        # ---- one box-head pass over proposals + track refinement
        all_rois = torch.cat([prop.boxes, tboxes])
        all_valid = torch.cat([prop.valid, tvalid])
        levels = pool_levels(all_rois, len(self.box_scales))
        cl, bd = net.box(pack, all_rois, levels, all_valid)
        cl, bd = cl.float(), bd.float()
        detections = postprocess(cl[:n_prop], bd[:n_prop], prop, image_size,
                                 hcfg)

        t_prob = torch.softmax(cl[n_prop:], dim=-1)
        lab = state.labels.clamp(0, self.num_classes - 1).long()
        app_score = torch.gather(t_prob, 1, lab[:, None])[:, 0]
        dec = box_ops.decode(bd[n_prop:], tboxes, hcfg.reg_weights).reshape(
            k, self.num_classes, 4)
        rboxes = torch.gather(dec, 1, lab[:, None, None].expand(k, 1, 4))[:, 0]
        if not hcfg.amodal:
            rboxes = box_ops.clip_to_image(rboxes, image_size)
        rscores = app_score + 1.0 if self.tracktor \
            else (app_score + tconf) / 2.0 + 1.0
        tracks = Boxes(boxes=rboxes, scores=rscores, ids=state.ids,
                       labels=state.labels, valid=tvalid)

        # ---- solver
        out, row_is_active, upd = solve(state, concat_boxes(detections,
                                                            tracks),
                                        self.scfg)

        # ---- next-frame memory: compact actives to K, extract caches
        pri = torch.where(row_is_active, out.scores,
                          torch.full_like(out.scores, -np.inf))
        _, top = topk(pri, k)
        act = out.map(lambda t: t[top])
        act = dataclasses.replace(act, valid=row_is_active[top])
        fresh_template = pool_template(pack, act.boxes, ecfg,
                                       self.window_template, act.valid)
        fresh_sr = make_search_region(act.boxes, ecfg)
        new_state = rebuild_state(
            state.replace(active=upd["active_after"],
                          last_active=upd["last_active"],
                          ids=torch.where(upd["expired"],
                                          torch.full_like(state.ids, -1),
                                          state.ids)),
            act, act.valid, fresh_template, fresh_sr, upd["keep_dormant"],
            upd["next_id"], state.frame_idx)
        return out, new_state
