"""EMM training-pair sampler (port of ``siammot_tpu.models.emm_sampler``).

Per image pair, ``num_samples`` padded track samples (source box for the
template, pair box whose extension is the search region, target box in
the other frame for regression), batched over the leading dimension:

  * positives: proposals IoU-matched (FG .65 / BG .35) to a source gt id;
    target = the same id's box in the paired frame (a dummy box if absent);
  * hard negatives: (gt, proposal) pairs where the proposal carries a
    different id at a similar height (ratio in [0.5, 2]);
  * negatives: unmatched proposals with objectness >= 0.3 and >= 5 px.

Budgets: ``num_samples * POS_RATIO`` positives, ``* HN_RATIO`` hard
negatives, the rest negatives.  The JAX sampler splits its key into
(pos, hard negative, negative) draws; here ``draw`` is called in that
order, once per pool, for the whole batch.
"""

from __future__ import annotations

import torch

from ..core import boxes as box_ops
from ..core.matcher import match_targets, rank_sample
from ..core.structures import Boxes, take_rows

DUMMY_BOX = -1.0


def _sample_k(draw, mask: torch.Tensor, k):
    """Randomly keep at most ``k`` set entries of each row of ``mask``;
    returns (selected mask, count per row)."""
    sel = rank_sample(draw(mask.shape), mask, k)
    return sel, sel.sum(-1)


def sample_track_pairs(draw, proposals: Boxes, objectness: torch.Tensor,
                       gt_src: Boxes, gt_tar: Boxes, num_samples: int,
                       pos_ratio: float, hn_ratio: float, fg_iou: float,
                       bg_iou: float) -> dict:
    """[B] image pairs -> dict of src_boxes, pair_boxes, tar_boxes
    [B, num_samples, 4] and valid [B, num_samples]."""
    b, p = proposals.valid.shape
    g = gt_src.valid.shape[1]

    # ---- match proposals to source gt
    quality = box_ops.box_iou(gt_src.boxes, proposals.boxes)
    matches = match_targets(quality, gt_src.valid, proposals.valid,
                            fg_iou, bg_iou)
    matched_ids = take_rows(gt_src.ids, matches.clamp(min=0))
    prop_ids = torch.where(matches >= 0, matched_ids, matches)

    def tar_box_of_ids(ids):
        """id -> paired-frame box (dummy when absent there); ids [B, M]."""
        eq = ((ids[..., :, None] == gt_tar.ids[:, None, :])
              & gt_tar.valid[:, None, :] & (ids >= 0)[..., None])
        has = eq.any(-1)
        found = take_rows(gt_tar.boxes, eq.to(torch.uint8).argmax(-1))
        return torch.where(has[..., None], found,
                           torch.full_like(found, DUMMY_BOX))

    # ---- positives
    pos_cand = (prop_ids >= 0) & proposals.valid
    pos_sel, n_pos = _sample_k(draw, pos_cand, int(num_samples * pos_ratio))
    pos_tar = tar_box_of_ids(prop_ids)

    # ---- hard negatives over the (gt, proposal) grid
    prop_h = proposals.boxes[..., 3] - proposals.boxes[..., 1]
    gt_h = gt_src.boxes[..., 3] - gt_src.boxes[..., 1]
    scale = gt_h[:, :, None] / prop_h[:, None, :].clamp(min=1e-10)
    hn_cand = (gt_src.valid[:, :, None] & proposals.valid[:, None, :]
               & (prop_ids[:, None, :] >= 0)
               & (prop_ids[:, None, :] != gt_src.ids[:, :, None])
               & (scale >= 0.5) & (scale <= 2.0)).reshape(b, g * p)
    hn_sel, n_hn = _sample_k(draw, hn_cand, int(num_samples * hn_ratio))
    hn_src = gt_src.boxes[:, :, None, :].expand(b, g, p, 4).reshape(
        b, g * p, 4)
    hn_pair = proposals.boxes[:, None].expand(b, g, p, 4).reshape(b, g * p,
                                                                  4)
    hn_tar = tar_box_of_ids(gt_src.ids)[:, :, None].expand(
        b, g, p, 4).reshape(b, g * p, 4)

    # ---- negatives
    prop_w = proposals.boxes[..., 2] - proposals.boxes[..., 0]
    neg_cand = ((prop_ids == -1) & (objectness >= 0.3) & (prop_h >= 5)
                & (prop_w >= 5) & proposals.valid)
    neg_sel, _ = _sample_k(draw, neg_cand, num_samples - n_pos - n_hn)
    neg_tar = torch.full_like(proposals.boxes, DUMMY_BOX)

    # ---- compact the union to num_samples slots (selected first)
    all_valid = torch.cat([pos_sel, hn_sel, neg_sel], 1)
    order = torch.argsort((~all_valid).to(torch.int32), dim=-1,
                          stable=True)[:, :num_samples]
    return dict(
        src_boxes=take_rows(torch.cat([proposals.boxes, hn_src,
                                   proposals.boxes], 1), order),
        pair_boxes=take_rows(torch.cat([proposals.boxes, hn_pair,
                                    proposals.boxes], 1), order),
        tar_boxes=take_rows(torch.cat([pos_tar, hn_tar, neg_tar], 1), order),
        valid=take_rows(all_valid, order))
