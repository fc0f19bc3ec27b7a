"""Run-directory naming (own copy of ``siammot_tpu.utils.model_name``, the
reference's ``get_model_name``):
``<BACKBONE>_box_<TRACK_MODEL>_<datasets>_<suffix>``."""

from __future__ import annotations


def get_model_name(cfg, model_suffix: str = "") -> str:
    parts = [cfg.MODEL.BACKBONE.CONV_BODY.replace("-FPN", "").replace("-", "")]
    if cfg.MODEL.BOX_ON:
        parts.append("box")
    if cfg.MODEL.TRACK_ON:
        parts.append(cfg.MODEL.TRACK_HEAD.MODEL)
    parts.extend(cfg.DATASETS.TRAIN)
    if model_suffix:
        parts.append(model_suffix)
    return "_".join(parts)
