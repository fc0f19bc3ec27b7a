"""Inference engine of the port (counterpart of
``siammot_tpu/engine/inferencer.py``).

``track_frames`` is the frame loop: cast the parameters once, start from
an empty track state, step the frames through ``SiamMOT.
forward_inference`` (with each frame's public detections in
given-detection mode), then drain the outputs to the host.

``do_inference`` tracks one video of a dataset: its JPEG frames decoded
on a prefetch thread (``data/video_loader.py``; libjpeg when the model
runs on the CPU, nvJPEG when it runs on the card), the outputs as
``AnnoEntity`` records in the video's own resolution.
``DatasetInference`` runs it over a dataset with a per-video JSON cache
(the prediction before the post-filter, in the JAX package's layout;
with ``n_streams`` > 1 the uncached videos run first as lanes of one
batched step, ``engine/multistream_inferencer.py``),
drops short and unsure tracks (mean confidence >= 0.7 and length >= 5)
and evaluates CLEAR-MOT (``eval/clearmot.py``) and detection AP
(``eval/det_ap.py``).
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import os
import time

import numpy as np
import torch

from ..data.motion_dataset import DataSample
from ..data.transforms import EvalTransform
from ..data.video_loader import normalized_frame_source, resolve_data_path
from ..eval.clearmot import eval_clears_mot
from ..utils.entities import boxes_to_entities, entities_to_boxes

logger = logging.getLogger(__name__)

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
    given: per frame, a list of ``data.motion_dataset.AnnoEntity`` public
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


def track_video(cfg, model, params, sample: DataSample, transforms=None,
                given_detection: DataSample = None,
                dataset_root: str = "") -> tuple:
    """Track one video; returns (predictions as a DataSample, frames,
    seconds of the frame steps and of the outputs' conversion)."""
    transforms = transforms or EvalTransform(cfg)
    w0, h0 = sample.width, sample.height
    in_w, in_h = transforms.input_size(w0, h0)
    scale_back = (w0 / in_w, h0 / in_h)

    frames = normalized_frame_source(resolve_data_path(sample, dataset_root),
                                     transforms, device=model.device)
    given = None
    if given_detection is not None:
        given = (given_detection.get_entities_for_frame_num(i)
                 for i in itertools.count())
    res = track_frames(model, params, (x for x, _ in frames), (in_w, in_h),
                       given=given, original_size=(w0, h0))

    t0 = time.perf_counter()
    result = DataSample(sample.id, metadata=dict(sample.metadata))
    for frame_idx, out in enumerate(res.outputs):
        time_ms = frame_idx * 1000.0 / sample.fps
        for e in boxes_to_entities(out, frame_idx, time_ms, scale_back):
            result.add_entity(e)
    seconds = sum(res.frame_seconds) + time.perf_counter() - t0
    return result, len(res.outputs), seconds


def do_inference(cfg, model, params, sample: DataSample, transforms=None,
                 given_detection: DataSample = None,
                 dataset_root: str = "") -> DataSample:
    """Track one video; returns predictions as a DataSample."""
    result, n_frames, seconds = track_video(
        cfg, model, params, sample, transforms, given_detection,
        dataset_root)
    if n_frames:
        logger.info("Sample_id %s / Speed %.1f fps", sample.id,
                    n_frames / max(seconds, 1e-6))
    return result


class DatasetInference:
    """Inference over a dataset with a per-video cache, the track
    post-filter and CLEAR-MOT (the reference's ``DatasetInference``).
    ``speed`` holds each tracked (not cached) video's (frames, seconds);
    ``accs`` the CLEAR-MOT accumulators of the last evaluation."""

    def __init__(self, cfg, model, params, dataset, output_dir,
                 data_filter_fn=None, public_detection=None,
                 dataset_root: str = "", n_streams: int = 1):
        self._cfg = cfg
        self._model = model
        self._params = params
        self._dataset = dataset
        self._output_dir = output_dir
        self._data_filter_fn = data_filter_fn
        self._pub_detection = public_detection
        self._dataset_root = dataset_root
        self._transform = EvalTransform(cfg)
        self._track_conf = 0.7
        self._track_len = 5
        self._n_streams = max(int(n_streams), 1)
        self.results = {}
        self.speed = {}
        self.accs = {}

    def _inference_on_video(self, sample) -> DataSample:
        cache_path = os.path.join(self._output_dir, f"{sample.id}.json")
        if os.path.exists(cache_path):
            return DataSample.load(cache_path)
        given = None
        if self._pub_detection:
            given = self._pub_detection.get(sample.id)
        result, n, seconds = track_video(
            self._cfg, self._model, self._params, sample, self._transform,
            given, self._dataset_root)
        self.speed[sample.id] = (n, seconds)
        logger.info("Sample_id %s / Speed %.1f fps", sample.id,
                    n / max(seconds, 1e-6))
        result.dump(cache_path)
        return result

    def _postprocess_tracks(self, tracks: DataSample) -> DataSample:
        """Drop short and low-confidence tracks."""
        track_ids = {e.id for e in tracks.entities if e.id >= 0}
        out = tracks.get_copy_without_entities()
        for tid in track_ids:
            ents = tracks.get_entities_with_id(tid)
            conf = np.mean([e.confidence for e in ents])
            if len(ents) >= self._track_len and conf >= self._track_conf:
                for e in ents:
                    out.add_entity(e)
        return out

    def _run_multistream(self):
        """Track every uncached video through the multi-stream engine and
        write the per-video caches the sequential engine would write."""
        from .multistream_inferencer import do_inference_multistream

        todo = [(sid, s) for sid, s in self._dataset
                if not os.path.exists(
                    os.path.join(self._output_dir, f"{s.id}.json"))]
        if not todo:
            return
        preds, speed = do_inference_multistream(
            self._cfg, self._model, self._params, todo,
            transforms=self._transform, dataset_root=self._dataset_root,
            n_streams=self._n_streams,
            given_detections=self._pub_detection)
        for sid, sample in todo:
            n, seconds = speed[sid]
            self.speed[sample.id] = (n, seconds)
            logger.info("Sample_id %s / Speed %.1f fps", sample.id,
                        n / max(seconds, 1e-6))
            preds[sid].dump(os.path.join(self._output_dir,
                                         f"{sample.id}.json"))

    def __call__(self):
        if self._n_streams > 1:
            self._run_multistream()
        for _, sample in self._dataset:
            result = self._inference_on_video(sample)
            result = self._postprocess_tracks(result)
            self.results[sample.id] = result

        logger.info("---------------- Start evaluating ----------------")
        accs, summary = eval_clears_mot(
            self._dataset, self.results, data_filter_fn=self._data_filter_fn)
        self.accs = accs
        logger.info(summary)
        logger.info("---------------- Finish evaluating ----------------")
        return accs, summary

    def eval_det_ap(self):
        from ..eval.det_ap import eval_det_ap as _ap
        ap = _ap(self._dataset, self.results,
                 data_filter_fn=self._data_filter_fn)
        mean_ap = np.mean(ap, axis=0)
        txt = ("\nDetection AP @[ IoU=0.50:0.95 ] = {:.2f}\n"
               "Detection AP @[ IoU=0.50 ] = {:.2f}\n"
               "Detection AP @[ IoU=0.75 ] = {:.2f}\n").format(
            float(np.mean(mean_ap)) * 100, mean_ap[0] * 100, mean_ap[5] * 100)
        return mean_ap, txt
