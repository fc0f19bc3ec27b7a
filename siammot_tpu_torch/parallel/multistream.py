"""Multi-stream batched inference and the clip loop (port of
``siammot_tpu.parallel.multistream``).

* :func:`empty_states` — S empty TrackStates stacked on a leading axis;
* :func:`build_multistream_step` — one frame of S independent video
  streams as lanes of one batched step (``SiamMOT.forward_streams``: the
  trunk, FPN, RPN and box head run once over the S images, each kernel
  launches once over all streams' slots and ROIs); where the JAX package
  ``vmap``s its frame step, the port writes the stream axis by hand;
* :func:`build_clip_scan` — a [T, 1, H, W, 3] clip stepped frame by frame
  with the outputs stacked on the device, no host read between frames
  (the JAX package's ``lax.scan``).

The JAX package's ``mesh=`` sharding of the stream axis over chips is not
ported: the port runs on one card.
"""

from __future__ import annotations

from ..core.structures import stack_boxes
from ..models.track_state import TrackState


def empty_states(model, n_streams: int) -> TrackState:
    """Stacked per-stream TrackStates, leading axis S."""
    return TrackState.stack([model.empty_state()] * n_streams)


def build_multistream_step(model, image_size=None, use_given: bool = False):
    """The batched step over stacked streams: ``(net, images [S, 1, H, W,
    3], states [S, ...]) -> (outputs [S, M], states' [S, ...])``.  With
    ``use_given``, a fourth argument carries each stream's public
    detections (a ``Boxes`` stacked over S, MOT17 mode) in place of its
    RPN proposals."""
    if use_given:
        def step(net, images, states, given):
            return model.forward_streams(net, images, states, image_size,
                                         given)
    else:
        def step(net, images, states):
            return model.forward_streams(net, images, states, image_size)
    return step


def build_clip_scan(model, clip_len: int, image_size=None):
    """``fn(net, frames [T, 1, H, W, 3], state) -> (outputs stacked over
    T, state')``: the frame step over a clip of one stream.  The outputs
    stay on the device until the clip ends; the step's own NMS
    convergence checks are its only host reads.  ``clip_len`` is carried
    by ``frames``; kept for the JAX signature."""
    del clip_len

    def scan(net, frames, state):
        outs = []
        for t in range(frames.shape[0]):
            out, state = model.forward_inference(net, frames[t], state,
                                                 image_size)
            outs.append(out)
        return stack_boxes(outs), state

    return scan
