"""Frame-streaming tracker for the demo (counterpart of
``demos/demo_inference.py``).

The per-class configs are the port's own copies of the JAX demo's,
under ``siammot_tpu_torch/demos/configs/``, read by the port's yaml
reader.  ``model_path`` goes through ``utils/checkpoint.py:
load_model_file``: a port checkpoint, a reference ``.pth`` or a flax-tree
``.npz``; without one the network runs on a fresh initialisation drawn
from seed 0, as the JAX demo's smoke mode does.  Each frame runs
``SiamMOT.forward_inference`` on the model's device (the card unless
``device`` asks for the CPU); the track state starts empty at each
sequence and whenever the network's input size changes.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from ..configs.defaults import get_cfg
from ..data.transforms import EvalTransform
from ..models.siammot import SiamMOT
from ..utils.checkpoint import load_model_file

logger = logging.getLogger(__name__)

TRACK_CLASSES = ("person", "person_vehicle")
CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "configs")


class DemoInference:
    """``step_seconds`` sums each frame's step, from the upload of its input
    to its rows on the host."""

    def __init__(self, track_class: str = "person", model_path: str = None,
                 vis_generator=None, vis_writer=None,
                 config_file: str = None, device="cuda"):
        if track_class not in TRACK_CLASSES:
            raise ValueError(f"track_class must be one of {TRACK_CLASSES}")
        cfg = get_cfg()
        cfg.merge_from_file(config_file or os.path.join(
            CONFIG_DIR, f"DLA34_emm_{track_class}.yaml"))
        self.cfg = cfg
        self.track_class = track_class
        self.transform = EvalTransform(cfg)
        self.model = SiamMOT(cfg, device=device)
        if model_path:
            params = load_model_file(model_path, self.model)
        else:
            logger.warning("no model_path given: running with random "
                           "weights (smoke mode)")
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0)
                params = self.model.build_net().state_dict()
        self.net = self.model.cast_params(params)
        self.vis_generator = vis_generator
        self.vis_writer = vis_writer
        self._size = None
        self._state = None
        self.step_seconds = 0.0
        self.draw_seconds = 0.0

    def process(self, frame: np.ndarray):
        """One RGB frame -> (boxes xywh [N, 4], ids [N], labels [N],
        scores [N]) in original-frame coordinates (valid rows only)."""
        orig_h, orig_w = frame.shape[:2]
        x, (in_w, in_h) = self.transform(frame)
        if self._size != (in_w, in_h) or self._state is None:
            self._size = (in_w, in_h)
            self._state = self.model.empty_state()
        t0 = time.perf_counter()
        out, self._state = self.model.forward_inference(
            self.net, torch.as_tensor(x).to(self.model.device), self._state,
            (in_w, in_h))
        out = out.numpy()
        self.step_seconds += time.perf_counter() - t0

        valid = out["valid"]
        sx, sy = orig_w / in_w, orig_h / in_h
        boxes = out["boxes"] * np.array([sx, sy, sx, sy], np.float32)
        xywh = np.stack([boxes[:, 0], boxes[:, 1],
                         boxes[:, 2] - boxes[:, 0] + 1,
                         boxes[:, 3] - boxes[:, 1] + 1], axis=-1)
        return (xywh[valid], out["ids"][valid], out["labels"][valid],
                out["scores"][valid])

    def process_frame_sequence(self, frame_iterator):
        """Per-frame generator of ``(frame_id, rows)``; the track state
        starts empty.  With a generator and a writer, each frame's
        overlays are drawn and written."""
        self._state = None
        for frame_id, frame in frame_iterator:
            xywh, ids, labels, scores = self.process(frame)
            if self.vis_generator and self.vis_writer:
                t0 = time.perf_counter()
                xyxy = xywh.copy()
                xyxy[:, 2:] += xyxy[:, :2] - 1
                vis = self.vis_generator.frame_vis_generator(frame, xyxy, ids,
                                                             labels)
                self.vis_writer.dump_artifacts(vis, frame_id)
                self.draw_seconds += time.perf_counter() - t0
            yield frame_id, (xywh, ids, labels, scores)
