"""Online track solver (port of ``siammot_tpu.models.track_solver``).

Merges detections (score in (0, 1), id < 0) with propagated tracks
(score in (1, 2], id >= 0): active tracks get +1 so NMS ranks
active > dormant > detection; one NMS(0.5) over everything; scores are
shifted back into (0, 1]; then start / suspend / resume / expire as
masked vector operations on the TrackState.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.nms import nms_mask
from ..core.structures import Boxes
from .track_state import TrackState, rows_to_slots


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    track_thresh: float
    start_thresh: float
    resume_thresh: float
    max_dormant_frames: int
    nms_thresh: float = 0.5

    @staticmethod
    def from_cfg(cfg) -> "SolverConfig":
        t = cfg.MODEL.TRACK_HEAD
        return SolverConfig(track_thresh=t.TRACK_THRESH,
                            start_thresh=t.START_TRACK_THRESH,
                            resume_thresh=t.RESUME_TRACK_THRESH,
                            max_dormant_frames=t.MAX_DORMANT_FRAMES)


def solve(state: TrackState, rows: Boxes, scfg: SolverConfig):
    """Returns (out [M] Boxes with final ids and (0, 1] scores,
    row_is_active [M] bool, upd: dict of slot updates for
    ``rebuild_state``)."""
    slot, has_slot = rows_to_slots(rows.ids, rows.valid, state)
    row_from_active = has_slot & state.active[slot]

    scores = rows.scores + row_from_active.to(rows.scores.dtype)
    keep = nms_mask(rows.boxes, scores, rows.valid, scfg.nms_thresh)

    adj = torch.where(scores >= 2.0, scores - 2.0, scores)
    adj = torch.where(adj >= 1.0, adj - 1.0, adj)

    is_det = rows.ids < 0
    start = keep & is_det & (adj >= scfg.start_thresh)
    # new ids follow NMS score-descending order (the reference assigns
    # them over the kept boxlist, track_solver.py:96-97)
    m = rows.ids.shape[0]
    start_key = torch.where(start, -adj, torch.full_like(adj, float("inf")))
    start_order = torch.sort(start_key, stable=True)[1]
    start_rank = torch.zeros(m, dtype=torch.int32, device=adj.device)
    start_rank[start_order] = torch.arange(m, dtype=torch.int32,
                                           device=adj.device)
    new_ids = torch.where(start, state.next_id + start_rank, rows.ids)
    next_id = state.next_id + start.sum(dtype=torch.int32)

    low = keep & (rows.ids >= 0) & (adj < scfg.track_thresh)

    eq = (rows.ids[:, None] == state.ids[None, :]) & \
        state.occupied[None, :] & (rows.ids >= 0)[:, None]

    def slot_any(row_mask):
        return (eq & row_mask[:, None]).any(dim=0)

    kept_slot = slot_any(keep)
    low_slot = slot_any(low)
    # suspend on low score or NMS removal; a track absent from the rows
    # is suspended too (PARITY.md #3)
    inactive_slot = state.active & (low_slot | ~kept_slot)
    resume_slot = state.occupied & ~state.active & \
        slot_any(keep & (adj >= scfg.resume_thresh))
    active_after = (state.active & ~inactive_slot) | resume_slot
    last_active = torch.where(inactive_slot, state.frame_idx - 1,
                              state.last_active)
    dormant = state.occupied & ~active_after
    expired = dormant & (state.frame_idx - last_active
                         >= scfg.max_dormant_frames)

    out = Boxes(boxes=rows.boxes, scores=adj,
                ids=torch.where(low, torch.full_like(new_ids, -1),
                                new_ids).to(torch.int32),
                labels=rows.labels, valid=keep)
    row_slot_after, row_has_after = rows_to_slots(out.ids, out.valid, state)
    row_is_active = out.valid & (out.ids >= 0) & (
        start | (row_has_after & active_after[row_slot_after]))
    upd = dict(active_after=active_after, last_active=last_active,
               expired=expired, next_id=next_id,
               keep_dormant=dormant & ~expired)
    return out, row_is_active, upd
