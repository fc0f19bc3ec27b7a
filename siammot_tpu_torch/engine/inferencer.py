"""Frame loop of the port (counterpart of the loop in
``siammot_tpu/engine/inferencer.py:do_inference``, without dataset I/O).

Cast the parameters once, start from an empty track state, step the
frames through ``SiamMOT.forward_inference`` (with each frame's public
detections in given-detection mode), then drain the outputs to the host.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..utils.entities import entities_to_boxes

GIVEN_DETECTION_CAPACITY = 128


@dataclasses.dataclass
class TrackResult:
    outputs: list          # per frame: dict of numpy arrays (Boxes fields)
    state: object          # TrackState after the last frame
    frame_seconds: list    # per frame: host time of the step, device done


def track_frames(model, params: dict, frames, image_size, given=None,
                 original_size=None) -> TrackResult:
    """Track a stream of frames.

    model: ``models.siammot.SiamMOT``; params: state dict
    (``utils.weights.jax_to_torch``); frames: iterable of uint8
    [1, H, W, 3] arrays or tensors; image_size: (w, h) of the content.
    given: per frame, a list of ``utils.entities.AnnoEntity`` public
    detections in original-resolution xywh (MOT17 mode), scaled to the
    input by ``image_size / original_size`` (``original_size`` defaults
    to ``image_size``) and padded to ``GIVEN_DETECTION_CAPACITY`` rows.
    A config with ``INFERENCE.USE_GIVEN_DETECTIONS`` needs them.
    Each frame's time runs from its upload to the end of its device
    work (the step synchronises the device at its end).
    """
    if given is None and model.cfg.INFERENCE.USE_GIVEN_DETECTIONS:
        raise ValueError("INFERENCE.USE_GIVEN_DETECTIONS is set: pass each "
                         "frame's public detections (given=...)")
    w0, h0 = original_size or image_size
    scale = (image_size[0] / w0, image_size[1] / h0)
    net = model.cast_params(params)
    state = model.empty_state()
    cuda = model.device.type == "cuda"
    dets = iter(given) if given is not None else None
    pending, seconds = [], []
    for frame in frames:
        boxes = None if dets is None else entities_to_boxes(
            next(dets), GIVEN_DETECTION_CAPACITY, scale)
        t0 = time.perf_counter()
        x = torch.as_tensor(frame).to(model.device)
        out, state = model.forward_inference(net, x, state, image_size,
                                             boxes)
        if cuda:
            torch.cuda.synchronize(model.device)
        seconds.append(time.perf_counter() - t0)
        pending.append(out)
    return TrackResult(outputs=[o.numpy() for o in pending], state=state,
                       frame_seconds=seconds)
