"""Dataset inference's end-to-end check: the port's ``DatasetInference``
against what the JAX package's wrote over the same sequence.

The sequence is ``tests/fixtures/synmot_mini``: one 16-frame 640x384
test sequence of ``tools/make_synth_mot.py --preset hard`` (crowding,
camera motion, occlusions, simulated public detections in
``det/det.txt``), in the raw MOT layout, ingested by the JAX
``ingest_mot`` (``annotation/anno.json``, ``splits.json`` and
``anno_pub_detection.json``).  The dataset key is ``SYNMOT_MINI`` under
``DATASETS.ROOT_DIR`` ``tests/fixtures``; the recipe is
``configs/dla/DLA_34_FPN_EMM_SYNMOT_HARD.yaml``, whose 384/640 test size
leaves the frames at their own size (so no resize), on the bench weights
(``fixtures/bench_weights_f16.npz``).

``tests/torch_port_golden.py --dataset`` (which needs JAX) writes
``tests/fixtures/torch_golden_dataset.json.gz``: for each run of
:data:`RUNS` (public-detection and RPN mode, f32 and bf16), the JAX
``DatasetInference``'s per-video predictions before the post-filter (its
JSON cache), the post-filtered tracks and the CLEAR-MOT summaries; and
the sha256 of every frame as the JAX package decoded it, with its
decoder.
"""

from __future__ import annotations

import gzip
import hashlib
import json
import math
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIXTURE = os.path.join(REPO, "tests", "fixtures",
                       "torch_golden_dataset.json.gz")
ROOT_DIR = os.path.join(REPO, "tests", "fixtures")
DATASET = "SYNMOT_MINI"
VIDEO = "SYN-TE-01"
SEQUENCE = os.path.join(ROOT_DIR, "synmot_mini", "test", VIDEO, "img1")
RECIPE = os.path.join(REPO, "configs", "dla",
                      "DLA_34_FPN_EMM_SYNMOT_HARD.yaml")
WEIGHTS = os.path.join(REPO, "fixtures", "bench_weights_f16.npz")
MODES = {"given": [], "rpn": ["INFERENCE.USE_GIVEN_DETECTIONS", False]}
RUNS = {f"{mode}_{dt}": (mode, dtype) for mode in MODES
        for dt, dtype in (("f32", "float32"), ("bf16", "bfloat16"))}
# f32 on both sides, sums in other orders: entity ids, frames and labels
# exactly, boxes to 1e-2 px, confidences to 1e-4 (the frame golden's
# tolerances); the CLEAR-MOT summary's counts, MOTA and IDF1 (ratios of
# counts) to 1e-9.  MOTP is the mean 1 - IoU of the matched boxes, so it
# moves with the boxes themselves: 1e-6 (the CPU's f32 run lies 7.7e-8
# from JAX's at a 5.2e-4 px box gap)
BOX_ATOL = 1e-2
CONF_ATOL = 1e-4
SUMMARY_ATOL = 1e-9
MOTP_ATOL = 1e-6
# nvJPEG's frames (the card's decoder) differ from libjpeg's, the JAX
# package's, by up to 93 of 255 (mean 2.74, 86% of the bytes; an H100
# machine's nvJPEG 12.4): the rows then part at discrete choices, so a run
# on them is held to the CLEAR-MOT summary alone, MOTA and IDF1 within
# 0.02 of the JAX run's (0.0127 and 0.0069 apart there, in f32)
DECODED_ELSEWHERE_ATOL = 0.02
SUMMARY_FIELDS = ("num_frames", "mostly_tracked", "partially_tracked",
                  "mostly_lost", "num_switches", "num_false_positives",
                  "num_misses", "mota", "motp", "idf1")


def overrides(run: str) -> list:
    """``merge_from_list`` options of a run over the recipe."""
    mode, dtype = RUNS[run]
    return ["DATASETS.ROOT_DIR", ROOT_DIR, "TPU.COMPUTE_DTYPE", dtype,
            "TPU.POOLER_DTYPE", dtype] + MODES[mode]


def cli_args(run: str, output_dir: str, model_file: str = WEIGHTS,
                  device: str = "cuda") -> list:
    """The port's ``tools/test_net`` arguments of a run."""
    return ["--config-file", RECIPE, "--output-dir", output_dir,
            "--model-file", model_file, "--test-dataset", DATASET,
            "--set", "test", "--device", device] \
        + [str(v) for v in overrides(run)]


def load(path: str = FIXTURE) -> dict:
    with gzip.open(path, "rt") as f:
        return json.load(f)


def dump(data: dict, path: str = FIXTURE) -> None:
    with gzip.open(path, "wt") as f:
        json.dump(data, f, sort_keys=True)


def frame_digests(frames) -> list:
    """sha256 of each decoded frame (the bytes of a [1, H, W, 3] array)."""
    return [hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()
            for x in frames]


def summaries(accs: dict) -> dict:
    """Per video and ``OVERALL``: the CLEAR-MOT summary as floats (NaN as
    None)."""
    from ..eval.clearmot import merge_summaries

    def clean(s):
        return {k: None if (v is None or (isinstance(v, float)
                                          and math.isnan(v)))
                else float(v) for k, v in s.items()}

    out = {sid: clean(acc.summary()) for sid, acc in accs.items()}
    out["OVERALL"] = clean(merge_summaries(accs))
    return out


def compare_samples(got: dict, want: dict, what: str) -> dict:
    """Two DataSample dicts (``DataSample.to_dict``) entity by entity in
    order: ids, frames and labels exact, boxes and confidences within
    tolerance.  Returns the largest box and confidence errors; raises on
    a mismatch."""
    ge, we = got["entities"], want["entities"]
    if len(ge) != len(we):
        raise AssertionError(f"{what}: {len(ge)} entities, want {len(we)}")
    if got["metadata"] != want["metadata"]:
        raise AssertionError(f"{what}: metadata {got['metadata']} != "
                             f"{want['metadata']}")
    box_err = conf_err = 0.0
    for i, (g, w) in enumerate(zip(ge, we)):
        for key in ("id", "time", "blob"):
            if g.get(key) != w.get(key):
                raise AssertionError(f"{what} entity {i}: {key} "
                                     f"{g.get(key)} != {w.get(key)}")
        if list(g["labels"]) != list(w["labels"]):
            raise AssertionError(f"{what} entity {i}: labels {g['labels']} "
                                 f"!= {w['labels']}")
        box_err = max(box_err, float(np.abs(np.subtract(g["bbox"],
                                                        w["bbox"])).max()))
        conf_err = max(conf_err, abs(g["confidence"] - w["confidence"]),
                       *(abs(g["labels"][k] - w["labels"][k])
                         for k in g["labels"]))
    if box_err > BOX_ATOL or conf_err > CONF_ATOL:
        raise AssertionError(f"{what}: box error {box_err:.3g} px (limit "
                             f"{BOX_ATOL}), confidence error {conf_err:.3g} "
                             f"(limit {CONF_ATOL})")
    return {"box": box_err, "conf": conf_err}


def compare_summaries(got: dict, want: dict, what: str) -> float:
    """CLEAR-MOT summaries (:func:`summaries`) field by field; returns the
    largest difference, raises past :data:`SUMMARY_ATOL` (MOTP
    :data:`MOTP_ATOL`)."""
    if set(got) != set(want):
        raise AssertionError(f"{what}: videos {sorted(got)} != "
                             f"{sorted(want)}")
    worst = 0.0
    for sid in want:
        for k in SUMMARY_FIELDS:
            g, w = got[sid][k], want[sid][k]
            if (g is None) != (w is None):
                raise AssertionError(f"{what} {sid} {k}: {g} != {w}")
            if g is not None:
                worst = max(worst, abs(g - w))
                tol = MOTP_ATOL if k == "motp" else SUMMARY_ATOL
                if abs(g - w) > tol:
                    raise AssertionError(f"{what} {sid} {k}: {g} != {w} "
                                         f"(limit {tol})")
    return worst


def compare_summary_band(got: dict, want: dict, what: str) -> dict:
    """The ``OVERALL`` summaries of runs on frames from another decoder:
    the same frame count, MOTA and IDF1 within
    :data:`DECODED_ELSEWHERE_ATOL`; returns their differences."""
    g, w = got["OVERALL"], want["OVERALL"]
    diff = {k: abs(g[k] - w[k]) for k in ("mota", "idf1")}
    if g["num_frames"] != w["num_frames"] \
            or max(diff.values()) > DECODED_ELSEWHERE_ATOL:
        raise AssertionError(f"{what}: {summary_line(g)} against JAX's "
                             f"{summary_line(w)} (limit "
                             f"{DECODED_ELSEWHERE_ATOL} on MOTA and IDF1)")
    return diff


def summary_line(s: dict) -> str:
    return (f"MOTA {s['mota']:.6f} MOTP {s['motp']:.6f} IDF1 "
            f"{s['idf1']:.6f} MT {s['mostly_tracked']:.0f} PT "
            f"{s['partially_tracked']:.0f} ML {s['mostly_lost']:.0f} IDs "
            f"{s['num_switches']:.0f} FP {s['num_false_positives']:.0f} FN "
            f"{s['num_misses']:.0f}")
