"""Padded detection/track container (port of ``siammot_tpu.core.structures``).

A ``Boxes`` set is a padded ``[N, 4]`` xyxy tensor plus per-row fields
and a validity mask, so every stage works on static shapes.  ids follow
the reference: -1 = plain detection, >= 0 = track id; padding rows have
``valid == False``.  A set may carry leading batch axes (``[S, N, 4]``
and ``[S, N]``: one set per video stream); the row axis is then the last
axis of ``ids``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Boxes:
    boxes: torch.Tensor     # [..., N, 4] float32 xyxy
    scores: torch.Tensor    # [..., N] float32
    ids: torch.Tensor       # [..., N] int32
    labels: torch.Tensor    # [..., N] int32
    valid: torch.Tensor     # [..., N] bool

    @property
    def capacity(self) -> int:
        return self.ids.shape[-1]

    def map(self, fn) -> "Boxes":
        """Apply ``fn`` to every field (row selection, device moves)."""
        return Boxes(*(fn(getattr(self, f.name))
                       for f in dataclasses.fields(self)))

    def lane(self, i: int) -> "Boxes":
        """Set ``i`` of a stacked ``[S, N]`` batch."""
        return self.map(lambda t: t[i])

    def numpy(self) -> dict:
        return {f.name: getattr(self, f.name).cpu().numpy()
                for f in dataclasses.fields(self)}


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx[..., m], ...]`` for a batch of padded sets: x [..., N,
    ...], idx [..., M] with x's leading axes -> [..., M, ...]."""
    a = idx.dim() - 1
    idx = idx.long().reshape(*idx.shape, *([1] * (x.dim() - a - 1)))
    return torch.gather(x, a, idx.expand(*idx.shape[:a + 1],
                                         *x.shape[a + 1:]))


def concat_boxes(a: Boxes, b: Boxes) -> Boxes:
    """Concatenate two padded sets along the row axis (capacity = sum of
    capacities; leading batch axes must agree)."""
    axis = a.ids.dim() - 1
    return Boxes(*(torch.cat([getattr(a, f.name), getattr(b, f.name)], axis)
                   for f in dataclasses.fields(Boxes)))


def stack_boxes(sets: list) -> Boxes:
    """S padded sets of one capacity -> one ``[S, N]`` batch."""
    return Boxes(*(torch.stack([getattr(s, f.name) for s in sets])
                   for f in dataclasses.fields(Boxes)))
