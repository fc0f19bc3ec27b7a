"""Multi-stream batched inference and the clip loop (port of
``siammot_tpu.parallel.multistream``).

* :func:`empty_states` — S empty TrackStates stacked on a leading axis;
* :func:`build_multistream_step` — one frame of S independent video
  streams as lanes of one batched step (``SiamMOT.forward_streams``: the
  trunk, FPN, RPN and box head run once over the S images, each kernel
  launches once over all streams' slots and ROIs); where the JAX package
  ``vmap``s its frame step, the port writes the stream axis by hand.
  With ``devices``, the stream axis is split over them in contiguous
  blocks, as the JAX package's ``mesh=`` shards it over ``'data'``: each
  device runs its lanes through its own copy of the net, and the lanes'
  states stay there between frames (:class:`Sharded`).  The shards run
  one after another in the caller's thread, where JAX's runs them at
  once: a ``forward_streams`` step reads the device about a dozen times
  (host syncs), so device d + 1 gets its work only once device d's step
  is past them, and D cards give not much more than one card's frames a
  second until each shard runs in a host thread of its own;
* :func:`build_clip_scan` — a [T, 1, H, W, 3] clip stepped frame by frame
  with the outputs stacked on the device, no host read between frames
  (the JAX package's ``lax.scan``).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses

import torch

from ..core.structures import stack_boxes
from ..models.track_state import TrackState


class Sharded:
    """A ``Boxes`` or ``TrackState`` stacked over streams whose lanes lie
    in contiguous blocks on several devices, one shard a device (JAX's
    arrays sharded over ``'data'``).  Reading a field (``out.boxes``)
    gathers it onto the first shard's device; :meth:`gather` gives the
    whole stacked object there."""

    def __init__(self, shards):
        self.shards = list(shards)

    def __getattr__(self, name):
        if name.startswith("__") or "shards" not in self.__dict__:
            raise AttributeError(name)
        vals = [getattr(s, name) for s in self.shards]
        if not torch.is_tensor(vals[0]):
            return vals[0]                    # e.g. ``capacity``
        return torch.cat([v.to(vals[0].device) for v in vals])

    def gather(self):
        first = self.shards[0]
        return type(first)(*(getattr(self, f.name)
                             for f in dataclasses.fields(first)))

    def numpy(self) -> dict:
        return self.gather().numpy()


def empty_states(model, n_streams: int) -> TrackState:
    """Stacked per-stream TrackStates, leading axis S."""
    return TrackState.stack([model.empty_state()] * n_streams)


def build_multistream_step(model, image_size=None, use_given: bool = False,
                           devices=None):
    """The batched step over stacked streams: ``(net, images [S, 1, H, W,
    3], states [S, ...]) -> (outputs [S, M], states' [S, ...])``.  With
    ``use_given``, a fourth argument carries each stream's public
    detections (a ``Boxes`` stacked over S, MOT17 mode) in place of its
    RPN proposals.

    ``devices``: a list of D devices (the same one may appear more than
    once); S must divide by D.  Device d runs lanes [d S/D, (d+1) S/D)
    through its copy of ``net``, made at the first call with that net;
    ``states`` may be stacked on one device (the first frame's
    ``empty_states``) or the :class:`Sharded` states the step returned,
    and the outputs and states' come back :class:`Sharded`."""
    if devices is not None:
        return _sharded_step(model, image_size, [torch.device(d)
                                                 for d in devices])
    if use_given:
        def step(net, images, states, given):
            return model.forward_streams(net, images, states, image_size,
                                         given)
    else:
        def step(net, images, states):
            return model.forward_streams(net, images, states, image_size)
    return step


def _sharded_step(model, image_size, devices):
    """:func:`build_multistream_step` over ``devices``: the shards run
    serially in this thread (see the module docstring)."""
    d = len(devices)
    replicas = {}

    def copies(net):
        if replicas.get("net") is not net:
            replicas.update(net=net, models=[
                type(model)(model.cfg, device=dev) for dev in devices],
                nets=[copy.deepcopy(net).to(dev) for dev in devices])
        return replicas["models"], replicas["nets"]

    def step(net, images, states, given=None):
        s = images.shape[0]
        if s % d:
            raise ValueError(f"{s} streams do not split over {d} devices")
        per = s // d
        blocks = [slice(i * per, (i + 1) * per) for i in range(d)]
        if isinstance(states, Sharded):
            shards = states.shards
            if [sh.ids.shape[0] for sh in shards] != [per] * d:
                raise ValueError("the states' shards do not match the "
                                 "streams' split")
        else:
            shards = [states.map(lambda t, b=b, dev=dev: t[b].to(dev))
                      for b, dev in zip(blocks, devices)]
        models, nets = copies(net)
        outs, new = [], []
        for m, n, b, dev, st in zip(models, nets, blocks, devices, shards):
            g = None if given is None else given.map(
                lambda t, b=b, dev=dev: t[b].to(dev))
            ctx = torch.cuda.device(dev) if dev.type == "cuda" \
                else contextlib.nullcontext()
            with ctx:
                o, st = m.forward_streams(n, images[b], st, image_size, g)
            outs.append(o)
            new.append(st)
        return Sharded(outs), Sharded(new)

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
