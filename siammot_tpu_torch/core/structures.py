"""Padded detection/track container (port of ``siammot_tpu.core.structures``).

A ``Boxes`` set is a padded ``[N, 4]`` xyxy tensor plus per-row fields
and a validity mask, so every stage works on static shapes.  ids follow
the reference: -1 = plain detection, >= 0 = track id; padding rows have
``valid == False``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Boxes:
    boxes: torch.Tensor     # [N, 4] float32 xyxy
    scores: torch.Tensor    # [N] float32
    ids: torch.Tensor       # [N] int32
    labels: torch.Tensor    # [N] int32
    valid: torch.Tensor     # [N] bool

    @property
    def capacity(self) -> int:
        return self.boxes.shape[0]

    def map(self, fn) -> "Boxes":
        """Apply ``fn`` to every field (row selection, device moves)."""
        return Boxes(*(fn(getattr(self, f.name))
                       for f in dataclasses.fields(self)))

    def numpy(self) -> dict:
        return {f.name: getattr(self, f.name).cpu().numpy()
                for f in dataclasses.fields(self)}


def concat_boxes(a: Boxes, b: Boxes) -> Boxes:
    """Concatenate two padded sets (capacity = sum of capacities)."""
    return Boxes(*(torch.cat([getattr(a, f.name), getattr(b, f.name)])
                   for f in dataclasses.fields(Boxes)))

