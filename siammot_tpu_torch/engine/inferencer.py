"""Frame loop of the port (counterpart of the loop in
``siammot_tpu/engine/inferencer.py:do_inference``, without dataset I/O).

Cast the parameters once, start from an empty track state, step the
frames through ``SiamMOT.forward_inference``, then drain the outputs to
the host.
"""

from __future__ import annotations

import dataclasses
import time

import torch


@dataclasses.dataclass
class TrackResult:
    outputs: list          # per frame: dict of numpy arrays (Boxes fields)
    state: object          # TrackState after the last frame
    frame_seconds: list    # per frame: host time of the step, device done


def track_frames(model, params: dict, frames, image_size) -> TrackResult:
    """Track a stream of frames.

    model: ``models.siammot.SiamMOT``; params: state dict
    (``utils.weights.jax_to_torch``); frames: iterable of uint8
    [1, H, W, 3] arrays or tensors; image_size: (w, h) of the content.
    Each frame's time runs from its upload to the end of its device
    work (the step synchronises the device at its end).
    """
    net = model.cast_params(params)
    state = model.empty_state()
    cuda = model.device.type == "cuda"
    pending, seconds = [], []
    for frame in frames:
        t0 = time.perf_counter()
        x = torch.as_tensor(frame).to(model.device)
        out, state = model.forward_inference(net, x, state, image_size)
        if cuda:
            torch.cuda.synchronize(model.device)
        seconds.append(time.perf_counter() - t0)
        pending.append(out)
    return TrackResult(outputs=[o.numpy() for o in pending], state=state,
                       frame_seconds=seconds)
