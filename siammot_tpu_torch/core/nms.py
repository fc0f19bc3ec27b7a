"""Fixed-shape greedy NMS (port of ``siammot_tpu.core.nms``).

maskrcnn ``nms`` semantics (score-descending greedy suppression, +1 IoU
convention) over padded box sets, computed as the same round-based fixed
point as the JAX package: per round every box whose earlier overlapping
boxes are all decided becomes decided, and a box overlapping a kept
earlier box is killed.  Each round is one batched ``[2, N] @ [N, N]``
product.  ``FORI_ROUNDS`` rounds run without looking at the result; then
the loop checks convergence (one host sync) and runs on until every box
is decided, so the keep set always equals serial greedy NMS
(PARITY.md #14).  Sets with leading batch axes (levels, classes, video
streams) share one loop: the check covers them all, so a call makes one
host sync for any number of sets, plus one per round past
``FORI_ROUNDS`` that its slowest set needs; ``nms_mask.syncs`` and
``nms_mask.extra_rounds`` count both.
"""

from __future__ import annotations

import torch

from .boxes import box_iou

NEG_INF = -1e10
FORI_ROUNDS = 16


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float, max_out: int | None = None,
             presorted: bool = False) -> torch.Tensor:
    """Greedy NMS over padded sets with any leading batch dims.

    Args:
      boxes: [..., N, 4] xyxy; scores: [..., N]; valid: [..., N] bool.
      iou_threshold: IoU > threshold suppresses.
      max_out: keep only the top-k survivors by score.
      presorted: valid rows are already score-descending with padding at
        the tail (sets straight out of a top-k), so the sort is skipped.

    Returns keep: [..., N] bool in the original row order.
    """
    n = boxes.shape[-2]
    if presorted:
        sboxes, svalid, order = boxes, valid, None
    else:
        masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
        # stable: ties keep the original index order (jnp.argsort)
        order = torch.sort(masked, dim=-1, descending=True, stable=True)[1]
        sboxes = torch.gather(boxes, -2, order[..., None].expand(
            *order.shape, 4))
        svalid = torch.gather(valid, -1, order)

    iou = box_iou(sboxes, sboxes)
    later = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)
    # overlap[j, i]: earlier box j suppresses later box i
    overlap = ((iou > iou_threshold) & later).to(torch.float32)

    decided = ~svalid
    keep = torch.zeros_like(svalid)

    def round_(decided, keep):
        vec = torch.stack([~decided, keep], dim=-2).to(torch.float32)
        prods = torch.matmul(vec, overlap)              # [..., 2, N]
        blocked = prods[..., 0, :] > 0.5
        killed = prods[..., 1, :] > 0.5
        can_decide = ~decided & (~blocked | killed)
        return decided | can_decide, keep | (can_decide & ~killed)

    for _ in range(FORI_ROUNDS):
        decided, keep = round_(decided, keep)
    nms_mask.syncs += 1
    while not bool(decided.all()):
        nms_mask.syncs += 1
        nms_mask.extra_rounds += 1
        decided, keep = round_(decided, keep)

    if max_out is not None and max_out < n:
        rank = torch.cumsum(keep.to(torch.int32), dim=-1) - 1
        keep = keep & (rank < max_out)
    if order is None:
        return keep
    return torch.zeros_like(keep).scatter(-1, order, keep)


nms_mask.syncs = 0
nms_mask.extra_rounds = 0


def batched_nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
                     valid: torch.Tensor, idxs: torch.Tensor,
                     iou_threshold: float,
                     max_out: int | None = None) -> torch.Tensor:
    """Category-aware NMS over sets ``[..., N]``: boxes with different
    ``idxs`` never suppress each other (the torchvision offset trick, its
    offset taken from each set's own boxes)."""
    max_coord = torch.where(valid[..., None], boxes,
                            torch.zeros_like(boxes)).amax(dim=(-2, -1))
    offsets = idxs.to(boxes.dtype) * (max_coord[..., None] + 1024.0)
    return nms_mask(boxes + offsets[..., None], scores, valid, iou_threshold,
                    max_out)
