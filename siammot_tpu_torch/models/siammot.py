"""SiamMOT inference and training steps (port of
``siammot_tpu.models.siammot``).

Inference: DLA-FPN backbone -> RPN (or given public detections) ->
shared box-head pass over proposals and propagated tracks -> EMM track
head over K padded slots -> track solver -> next-frame TrackState, one
frame per ``forward_inference`` call.  Its kernels (window pool, masked
xcorr, masked or slot-blocked predictor, decode whole-map or striped; or,
with ``TPU.MASKED_TRACK_KERNELS`` False, the unmasked xcorr and decode)
are CUDA kernels on the card, and so is the deformable conv of a DCN
body (kernel 9; inference only: its backward is not ported).

Training: ``forward_train`` returns the seven reference losses of a batch
of frame pairs (RPN, box head, EMM), with the pool's backward (kernel 7)
and the unmasked xcorr and its gradients (kernel 6) as CUDA kernels.
The convolutions and matrix products around the kernels stay
``F.conv2d`` / ``torch.matmul``, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch
import torch.nn as nn

from ..core import boxes as box_ops
from ..core.structures import Boxes, concat_boxes
from .box_head import (BoxHead, BoxHeadConfig, box_head_loss, pool_levels,
                       postprocess, subsample_proposals)
from .dla import DLA_VARIANTS, DeformConv, build_dla
from .emm import (EMMConfig, EMMHead, decode_response_fused, emm_loss,
                  make_search_region, pool_search_region, pool_template,
                  response_locations)
from .emm_sampler import sample_track_pairs
from .fpn import FPN
from .rpn import (RPNConfig, RPNHead, base_anchors, grid_anchors, rpn_loss,
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
                 num_classes: int, window_box: int,
                 stage_with_dcn=(False,) * 6):
        super().__init__()
        self.body = build_dla(conv_body, stage_with_dcn)
        stage_channels = DLA_VARIANTS[conv_body]["channels"][2:6]
        self.fpn = FPN(stage_channels, channels)
        self.rpn = RPNHead(channels, num_anchors)
        self.box = BoxHead(channels, box_resolution, box_sampling, mlp_dim,
                           num_classes, window_box)
        self.emm = EMMHead(channels)

    def forward(self, fn, *args):
        """``fn(self, *args)``: lets ``torch.func.functional_call`` run a
        whole step with substituted (cast) parameters."""
        return fn(self, *args)


def _channels_last(net: SiamMOTNet) -> None:
    """On the card, NHWC convolutions for cuDNN.  The HWIO kernels that
    kernels 3 and 9 read (EMM predictor, deformable convs) stay
    contiguous as they are."""
    if next(net.parameters()).device.type != "cuda":
        return
    for m in (net.body, net.fpn, net.rpn):
        m.to(memory_format=torch.channels_last)
    for m in net.body.modules():
        if isinstance(m, DeformConv):
            m.kernel.data = m.kernel.data.contiguous()


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
                           "S2D_STEM") if not tpu[k]]
        if off:
            raise ValueError(f"the port implements only the Pallas kernel "
                             f"paths; TPU.{off} must stay True")
        # False: the unmasked EMM route (xcorr kernel 6, the predictor over
        # every slot, decode kernel 10), siammot_tpu/models/siammot.py:355
        self.masked_kernels = bool(tpu.MASKED_TRACK_KERNELS)
        if tpu.REMAT:
            raise ValueError("TPU.REMAT is not ported yet")
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
        self.rcfg_train = RPNConfig.from_cfg(cfg, is_train=True)
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
            window_box=cfg.TPU.WINDOW_BOX,
            stage_with_dcn=tuple(cfg.MODEL.DLA.STAGE_WITH_DCN))

    def cast_params(self, params: dict) -> SiamMOTNet:
        """The network on the device in the compute dtype, loaded from a
        state dict (``utils.weights.jax_to_torch``); every key must match.
        Each float tensor is cast once, here, as the JAX engine pre-casts
        its tree once per stream."""
        net = self.build_net().to(device=self.device,
                                  dtype=self.compute_dtype)
        net.load_state_dict(params, strict=True)
        net.eval().requires_grad_(False)
        _channels_last(net)
        return net

    def _check_train(self) -> None:
        """Training-only keys (``TPU.TRAIN_POOLER_WINDOWED`` only matters
        to the training step, ``siammot_tpu/configs/defaults.py:228``)."""
        if not self.cfg.TPU.TRAIN_POOLER_WINDOWED:
            raise ValueError("TPU.TRAIN_POOLER_WINDOWED False (the exact "
                             "gather pooler in training) is not ported")

    def build_master(self, params: dict) -> SiamMOTNet:
        """The network for training: f32 master parameters on the device,
        loaded from a state dict (every key must match), with gradients.
        FrozenBN statistics stay buffers, so nothing moves them."""
        self._check_train()
        net = self.build_net().to(device=self.device, dtype=torch.float32)
        net.load_state_dict(params, strict=True)
        _channels_last(net)
        return net.train().requires_grad_(True)

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
                          state: TrackState, image_size=None, given=None):
        """One frame: detect + propagate + solve + update memory.

        images: [1, H, W, 3] uint8 (normalised here, pad re-zeroed) or
        normalised f32, zero-padded to the size-divisible shape.
        image_size: (w, h) of the content, for clipping; defaults to the
        padded shape.  given: optional public detections (``Boxes`` in
        network-input coordinates, ``utils.entities.entities_to_boxes``)
        that replace the RPN proposals (MOT17 mode).  Returns (out: Boxes
        over all candidate rows, state': TrackState).
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

        # ---- proposals: the RPN's, or the given detections
        if given is None:
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
        else:
            prop = given.map(lambda t: t.to(self.device))
            n_prop = prop.capacity

        # ---- track propagation (EMM) over K padded slots; the SR pool
        # skips dead slots, and so does every EMM kernel when masked
        occupied = state.occupied
        occ_k = occupied if self.masked_kernels else None
        sr_feats = pool_search_region(pack, state.boxes, state.sr, ecfg,
                                      self.window_sr, occupied)
        cls_l, ctr_l, reg_l = net.emm(sr_feats.to(dt),
                                      state.template.to(dt), occ_k)
        tboxes, tconf = decode_response_fused(
            cls_l, ctr_l, reg_l, state.sr, state.boxes, ecfg, UPSCALE,
            occ_k)
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

    # -- training step ------------------------------------------------------

    def forward_train(self, net: SiamMOTNet, draws, images: torch.Tensor,
                      gt: Boxes, image_size=None, frame_sizes=None) -> dict:
        """Training forward pass -> dict of the seven reference losses
        (RPN objectness/box, box classifier/box, tracker class/motion/
        center), differentiable in ``net``'s f32 master parameters.

        images: [B, H, W, 3] uint8 (normalised here) in clip pairs
        (frame i pairs with i ^ 1); gt: Boxes with [B, G] fields and
        batch-unique ids; frame_sizes: [B, 2] (w, h) content extents whose
        pad is re-zeroed; draws: ``draw(shape)`` -> U[0, 1) priorities of
        the samplers (``core.matcher.uniform_draws``), called in a fixed
        order.  The forward runs in the compute dtype: each parameter and
        buffer is cast inside the graph (``functional_call``), so the
        gradients reach the f32 masters, as the JAX step's ``cast_params``
        inside the grad does.
        """
        self._check_train()
        b = images.shape[0]
        if b % 2:
            raise ValueError(f"training batch must be frame pairs, got {b}")
        dt = self.compute_dtype
        cast = {n: t.to(dt) if t.is_floating_point() else t
                for n, t in itertools.chain(net.named_parameters(),
                                            net.named_buffers())}
        return torch.func.functional_call(
            net, cast, (self._train_losses, draws, images, gt, image_size,
                        frame_sizes))

    def _train_losses(self, net, draws, images, gt, image_size,
                      frame_sizes):
        ecfg, hcfg = self.ecfg, self.hcfg
        t = self.cfg.MODEL.TRACK_HEAD
        dt = self.compute_dtype
        b, h, w = images.shape[:3]
        image_size = tuple(image_size or (w, h))
        x = normalize_images(images, self.cfg.INPUT.PIXEL_MEAN,
                             self.cfg.INPUT.PIXEL_STD,
                             self.cfg.INPUT.TO_BGR255,
                             frame_sizes=frame_sizes)
        feats = net.fpn(net.body(x.to(dt)))                    # NCHW, dt
        anchors = self.anchors_for((h, w))
        logits, deltas = net.rpn(feats)
        logits = [l.float() for l in logits]
        deltas = [d.float() for d in deltas]
        losses = rpn_loss(draws, logits, deltas, anchors, gt, image_size,
                          self.rcfg_train)

        # proposals are data, not a function of the RPN (the reference
        # builds them without gradients); gt boxes are appended
        with torch.no_grad():
            pb, ps, pv = select_proposals(
                [l.detach() for l in logits], [d.detach() for d in deltas],
                anchors, image_size, self.rcfg_train)
        g_cap = gt.boxes.shape[1]
        m = pb.shape[1] + g_cap
        props = Boxes(
            boxes=torch.cat([pb, gt.boxes], 1),
            scores=torch.cat([ps, torch.ones_like(gt.boxes[..., 0])], 1),
            ids=torch.full((b, m), -1, dtype=torch.int32,
                           device=self.device),
            labels=torch.zeros((b, m), dtype=torch.int32,
                               device=self.device),
            valid=torch.cat([pv, gt.valid], 1))

        # every training pool reads one f32 table (its gradient accumulates
        # there, then flows back to the FPN maps)
        feats_nhwc = [f.permute(0, 2, 3, 1).float() for f in feats]
        pack = pack_levels(feats_nhwc[:len(self.box_scales)],
                           self.box_scales, dtype=torch.float32)

        # ---- box head: balanced subsample -> pooled MLP -> loss
        sampled, labels, regs = subsample_proposals(
            draws, props, gt, hcfg, hcfg.batch_per_image)
        n_samp = sampled.boxes.shape[1]
        rois = sampled.boxes.reshape(-1, 4)
        img_idx = torch.arange(b, dtype=torch.int32,
                               device=self.device).repeat_interleave(n_samp)
        cl, bd = net.box(pack, rois, pool_levels(rois, len(self.box_scales)),
                         None, img_idx)
        losses.update(box_head_loss(cl.float(), bd.float(),
                                    labels.reshape(-1), regs.reshape(-1, 4),
                                    sampled.valid.reshape(-1)))

        # ---- track head: sample pairs, pool template and SR, EMM loss
        n_track = t.PROPOSAL_PER_IMAGE
        pair_perm = torch.arange(b, device=self.device) ^ 1
        tr = sample_track_pairs(
            draws, props, props.scores, gt, gt.map(lambda v: v[pair_perm]),
            n_track, t.EMM.POS_RATIO, t.EMM.HN_RATIO, t.FG_IOU_THRESHOLD,
            t.BG_IOU_THRESHOLD)
        src = tr["src_boxes"].reshape(-1, 4)
        tar = tr["tar_boxes"].reshape(-1, 4)
        valid = tr["valid"].reshape(-1)
        img_idx = torch.arange(b, dtype=torch.int32,
                               device=self.device).repeat_interleave(
                                   tr["valid"].shape[1])
        sr_boxes = make_search_region(tr["pair_boxes"].reshape(-1, 4), ecfg)
        templates = pool_template(pack, src, ecfg, self.window_template,
                                  None, img_idx)
        # SR crops pool from the paired frame; the level is still chosen by
        # the template box
        sr_feats = pool_search_region(pack, src, sr_boxes, ecfg,
                                      self.window_sr, None, img_idx ^ 1)
        cls_l, ctr_l, reg_l = net.emm.forward_train(sr_feats.to(dt),
                                                    templates.to(dt))
        locations = response_locations(sr_boxes, ecfg.sr_size,
                                       ecfg.resolution, ecfg.pad_pixels, 1)
        losses.update(emm_loss(cls_l.float(), ctr_l.float(), reg_l.float(),
                               locations, tar, valid, ecfg))
        return losses
