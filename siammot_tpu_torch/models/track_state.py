"""Fixed-capacity track state (port of ``siammot_tpu.models.track_state``).

K padded slots carry the tracker's memory between frames:

  slot occupied   <=> ids[k] >= 0
  active slot     <=> occupied & active[k]
  dormant slot    <=> occupied & ~active[k]   (kept MAX_DORMANT_FRAMES)

The per-slot cache (template features, search region, box) is the slot
array; dormant slots keep the cache of their last active frame.  A state
may be stacked over S video streams (every field with a leading S axis,
``next_id`` and ``frame_idx`` one per stream); the functions below work
on either form, each stream on its own slots.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.structures import Boxes, take_rows


@dataclasses.dataclass
class TrackState:
    template: torch.Tensor     # [..., K, T, T, C] f32 cached templates
    boxes: torch.Tensor        # [..., K, 4] last known box (input coords)
    sr: torch.Tensor           # [..., K, 4] search region (padded coords)
    ids: torch.Tensor          # [..., K] int32; -1 = free slot
    labels: torch.Tensor       # [..., K] int32
    active: torch.Tensor       # [..., K] bool
    last_active: torch.Tensor  # [..., K] int32 frame of last activity
    next_id: torch.Tensor      # [...] int32
    frame_idx: torch.Tensor    # [...] int32

    @property
    def capacity(self) -> int:
        return self.ids.shape[-1]

    @property
    def occupied(self) -> torch.Tensor:
        return self.ids >= 0

    def replace(self, **kw) -> "TrackState":
        return dataclasses.replace(self, **kw)

    def map(self, fn) -> "TrackState":
        """Apply ``fn`` to every field."""
        return TrackState(*(fn(getattr(self, f.name))
                            for f in dataclasses.fields(self)))

    def lane(self, i: int) -> "TrackState":
        """Stream ``i`` of a stacked state."""
        return self.map(lambda t: t[i])

    @staticmethod
    def stack(states: list) -> "TrackState":
        """S states -> one state stacked over streams."""
        return TrackState(*(torch.stack([getattr(s, f.name) for s in states])
                            for f in dataclasses.fields(TrackState)))

    def numpy(self) -> dict:
        return {f.name: getattr(self, f.name).cpu().numpy()
                for f in dataclasses.fields(self)}

    @staticmethod
    def empty(capacity: int, template_size: int, channels: int,
              device) -> "TrackState":
        z = dict(device=device)
        return TrackState(
            template=torch.zeros((capacity, template_size, template_size,
                                  channels), dtype=torch.float32, **z),
            boxes=torch.zeros((capacity, 4), dtype=torch.float32, **z),
            sr=torch.zeros((capacity, 4), dtype=torch.float32, **z),
            ids=torch.full((capacity,), -1, dtype=torch.int32, **z),
            labels=torch.zeros((capacity,), dtype=torch.int32, **z),
            active=torch.zeros((capacity,), dtype=torch.bool, **z),
            last_active=torch.zeros((capacity,), dtype=torch.int32, **z),
            next_id=torch.zeros((), dtype=torch.int32, **z),
            frame_idx=torch.zeros((), dtype=torch.int32, **z))


def rows_to_slots(row_ids: torch.Tensor, row_valid: torch.Tensor,
                  state: TrackState):
    """Join solver rows to state slots by track id, per stream.

    Returns (slot_index [..., M] int64, has_slot [..., M] bool); rows
    without a slot point at slot 0.
    """
    eq = (row_ids[..., :, None] == state.ids[..., None, :]) & \
        state.occupied[..., None, :] & row_valid[..., :, None] & \
        (row_ids >= 0)[..., :, None]
    # first matching slot (jnp.argmax of a bool row)
    return torch.argmax(eq.to(torch.int8), dim=-1), eq.any(dim=-1)


def rebuild_state(state: TrackState, out: Boxes, row_active: torch.Tensor,
                  fresh_template: torch.Tensor, fresh_sr: torch.Tensor,
                  keep_dormant: torch.Tensor, next_id,
                  frame_idx) -> TrackState:
    """Assemble the next frame's TrackState.

    ``out`` holds the active-track candidates compacted to [..., K]
    (highest score first); ``row_active`` [..., K] marks the rows that
    are active tracks; ``keep_dormant`` [..., K] marks old dormant slots
    that survive.  Actives come first in row order, then dormant slots by
    recency of suspension; slots left over are zeroed in every lane
    (PARITY.md #11).
    """
    k = state.capacity
    a = state.ids.dim() - 1                      # the slot axis
    dev = state.ids.device
    frame = frame_idx[..., None]
    cand_valid = torch.cat([row_active, keep_dormant], a)
    pri_active = torch.arange(k, dtype=torch.float32,
                              device=dev).expand_as(row_active)
    pri_dormant = 2.0 * k + (frame - state.last_active).to(torch.float32)
    priority = torch.cat([pri_active, pri_dormant], a)
    priority = torch.where(cand_valid, priority,
                           torch.full_like(priority, float("inf")))
    order = torch.sort(priority, dim=-1, stable=True)[1][..., :k]
    valid = take_rows(cand_valid, order)

    def sel(fresh, old):
        both = take_rows(torch.cat([fresh, old], a), order)
        mask = valid.reshape(valid.shape + (1,) * (both.dim() - a - 1))
        return torch.where(mask, both, torch.zeros_like(both))

    ids = torch.where(valid, take_rows(torch.cat([out.ids, state.ids], a),
                                       order),
                      torch.full_like(valid, -1, dtype=torch.int32))
    active = take_rows(torch.cat([torch.ones_like(row_active),
                                  torch.zeros_like(row_active)], a), order)
    return TrackState(
        template=sel(fresh_template, state.template),
        boxes=sel(out.boxes, state.boxes),
        sr=sel(fresh_sr, state.sr),
        ids=ids.to(torch.int32),
        labels=sel(out.labels, state.labels).to(torch.int32),
        active=active & valid,
        last_active=sel(torch.zeros_like(state.last_active) + frame,
                        state.last_active).to(torch.int32),
        next_id=next_id,
        frame_idx=frame_idx + 1)
