"""Multi-video batched inference (counterpart of
``siammot_tpu/engine/multistream_inferencer.py``).

Independent videos run as lanes of one batched frame step
(``parallel/multistream.py``, ``SiamMOT.forward_streams``): videos are
grouped by padded network-input shape and run in waves of ``n_streams``,
each stream carrying its own TrackState on the device.  A stream that
ends early rides along as a lane that gets zero frames until the wave's
longest video finishes, and its outputs are dropped; a wave with fewer
videos than lanes fills the rest the same way.  In public-detection
(MOT17) mode each stream's given detections are stacked into one
``Boxes`` per frame, an all-invalid set for a lane without a frame.

Each lane equals its video's own sequential run (the states never
interact; ``tests/test_torch_multistream.py``).  The frames of step t+1
are read and uploaded by a worker thread while step t runs: on the card
into pinned host memory, copied on a side CUDA stream whose event the
step's stream waits for (``SIAMMOT_MS_PIPELINE=0`` waits for each upload
before the step, the A/B baseline).  Each step is timed as
``track_frames`` times a frame, from taking its uploaded batch to the
end of its device work; a wave's time is the sum, and each video is
charged the wave's time in proportion to its frames, so the "Speed"
lines and ``DatasetInference.speed`` read as the sequential engine's.
"""

from __future__ import annotations

import logging
import os
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core.structures import Boxes
from ..data.motion_dataset import DataSample
from ..data.transforms import EvalTransform
from ..data.video_loader import normalized_frame_source, resolve_data_path
from ..parallel.multistream import build_multistream_step, empty_states
from ..utils.entities import boxes_to_entities, entities_to_stacked_boxes

logger = logging.getLogger(__name__)


def pack_waves(group, n_streams):
    """Length-aware wave packing: each wave runs for the longest of its
    members (finished streams ride along as masked lanes), so pack
    longest with longest (``SIAMMOT_MS_PACK=0``: arrival order).
    Per-video outputs are unaffected."""
    if os.environ.get("SIAMMOT_MS_PACK", "1") != "0":
        group = sorted(group, key=lambda sv: len(sv[1]), reverse=True)
    return [group[i:i + n_streams]
            for i in range(0, len(group), n_streams)]


def wave_lane_steps(waves, n_streams):
    """Total batched lane-steps the schedule will execute (each wave
    steps n_streams lanes for its longest member's frames)."""
    return sum(max(len(s) for _, s in w) * n_streams for w in waves)


def do_inference_multistream(cfg, model, params, samples: list,
                             transforms=None, dataset_root: str = "",
                             n_streams: int = 4,
                             given_detections: dict = None):
    """Track a list of (sample_id, DataSample) videos.

    given_detections: {sample_id: DataSample} of public detections
    (MOT17 mode); a config with ``INFERENCE.USE_GIVEN_DETECTIONS`` needs
    them.  Returns ({sample_id: predictions as a DataSample},
    {sample_id: (frames, seconds)}).
    """
    if given_detections is None and cfg.INFERENCE.USE_GIVEN_DETECTIONS:
        raise ValueError("INFERENCE.USE_GIVEN_DETECTIONS is set: pass the "
                         "public detections (given_detections=...)")
    transforms = transforms or EvalTransform(cfg)
    net = model.cast_params(params)

    groups = defaultdict(list)
    for sid, sample in samples:
        in_w, in_h = transforms.input_size(sample.width, sample.height)
        pad_w = -(-in_w // transforms.divisor) * transforms.divisor
        pad_h = -(-in_h // transforms.divisor) * transforms.divisor
        groups[(pad_w, pad_h, in_w, in_h)].append((sid, sample))

    results, speed = {}, {}
    for (pad_w, pad_h, in_w, in_h), group in groups.items():
        step = build_multistream_step(model, (in_w, in_h),
                                      given_detections is not None)
        for wave in pack_waves(group, n_streams):
            res, spd = _run_wave(model, net, step, wave, transforms,
                                 dataset_root, n_streams, (pad_h, pad_w),
                                 (in_w, in_h), given_detections)
            results.update(res)
            speed.update(spd)
    return results, speed


def _run_wave(model, net, step, wave, transforms, dataset_root, n_streams,
              pad_hw, in_wh, given_detections=None):
    from .inferencer import GIVEN_DETECTION_CAPACITY

    dev = model.device
    cuda = dev.type == "cuda"
    use_given = given_detections is not None
    sources = [normalized_frame_source(resolve_data_path(s, dataset_root),
                                       transforms, device=dev)
               for _, s in wave]
    alive = [True] * len(sources)
    batch_dtype = np.uint8 if transforms.device_normalize else np.float32

    def assemble(fidx):
        """One frame per live stream, zeros elsewhere, and each lane's
        given detections; returns (host tensors, lanes that had a
        frame)."""
        batch = np.zeros((n_streams, 1) + tuple(pad_hw) + (3,), batch_dtype)
        ents, scales = [[]] * n_streams, [(1.0, 1.0)] * n_streams
        had = [False] * n_streams
        for i, src in enumerate(sources):
            item = next(src, None) if alive[i] else None
            if item is None:
                alive[i] = False
                continue
            batch[i] = item[0]
            had[i] = True
            if use_given:
                sid, sample = wave[i]
                pub = given_detections.get(sid)
                if pub is not None:
                    ents[i] = pub.get_entities_for_frame_num(fidx)
                scales[i] = (in_wh[0] / sample.width,
                             in_wh[1] / sample.height)
        host = [torch.from_numpy(batch)]
        if use_given:
            g = entities_to_stacked_boxes(ents, GIVEN_DETECTION_CAPACITY,
                                          scales)
            host += [g.boxes, g.scores, g.ids, g.labels, g.valid]
        return host, had

    side = torch.cuda.Stream(dev) if cuda else None

    def upload(fidx):
        """The worker's part: read, then (on the card) pin and copy on the
        side stream; returns (device tensors, event or None, had)."""
        host, had = assemble(fidx)
        if not any(had):
            return None
        if not cuda:
            return host, None, had
        with torch.cuda.stream(side):
            out = [t.pin_memory().to(dev, non_blocking=True) for t in host]
            done = torch.cuda.Event()
            done.record(side)
        return out, done, had

    pipelined = os.environ.get("SIAMMOT_MS_PIPELINE", "1") != "0"
    uploader = ThreadPoolExecutor(max_workers=1)
    states = empty_states(model, n_streams)
    steps, seconds = [], 0.0
    pending = uploader.submit(upload, 0)
    try:
        while True:
            item = pending.result()
            if item is None:
                break
            t0 = time.perf_counter()
            tensors, done, had = item
            if done is not None:
                cur = torch.cuda.current_stream(dev)
                cur.wait_event(done)
                for t in tensors:
                    t.record_stream(cur)
            pending = uploader.submit(upload, len(steps) + 1)
            if not pipelined:
                pending.result()
            given = Boxes(*tensors[1:]) if use_given else None
            out, states = step(net, tensors[0], states, given) \
                if use_given else step(net, tensors[0], states)
            if cuda:
                torch.cuda.synchronize(dev)
            seconds += time.perf_counter() - t0
            steps.append((out, had))
    finally:
        # an upload in flight finishes before the wave unwinds
        pending.cancel()
        uploader.shutdown(wait=True)

    t0 = time.perf_counter()
    results = {sid: DataSample(sid, metadata=dict(sample.metadata))
               for sid, sample in wave}
    frames = dict.fromkeys(results, 0)
    for fidx, (out, had) in enumerate(steps):
        host = out.numpy()
        for i, (sid, sample) in enumerate(wave):
            if not had[i]:
                continue
            frames[sid] += 1
            for e in boxes_to_entities(
                    {k: v[i] for k, v in host.items()}, fidx,
                    fidx * 1000.0 / sample.fps,
                    (sample.width / in_wh[0], sample.height / in_wh[1])):
                results[sid].add_entity(e)
    seconds += time.perf_counter() - t0

    n_frames = sum(frames.values())
    lane_steps = len(steps) * n_streams
    waste = lane_steps - n_frames
    logger.info(
        "wave of %d videos: %d frames in %.3f s (%.1f fps aggregate); "
        "masked-lane waste %d/%d lane-steps (%.1f%%)",
        len(wave), n_frames, seconds, n_frames / max(seconds, 1e-6), waste,
        lane_steps, 100.0 * waste / max(lane_steps, 1))
    speed = {sid: (n, seconds * n / max(n_frames, 1))
             for sid, n in frames.items()}
    return results, speed
