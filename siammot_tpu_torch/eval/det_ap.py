"""Video detection AP evaluation (own copy of ``siammot_tpu.eval.det_ap``):
class-wise AP over IoU 0.5:0.95 using greedy
highest-score-first matching and the PR-curve AUC.
"""

from __future__ import annotations

import numpy as np

from ..data.filters import bbs_iou


def _greedy_match(gt_entities, pred_entities, iou_thresh):
    """Greedy match predictions (score-descending) to GT; returns tp flags
    aligned with the sorted predictions."""
    order = np.argsort([-p.confidence for p in pred_entities], kind="stable")
    taken = [False] * len(gt_entities)
    tp = np.zeros(len(pred_entities), bool)
    for rank, pi in enumerate(order):
        p = pred_entities[pi]
        best, best_iou = -1, iou_thresh
        for gi, g in enumerate(gt_entities):
            if taken[gi]:
                continue
            iou = bbs_iou(p, g)
            if iou >= best_iou:
                best, best_iou = gi, iou
        if best >= 0:
            taken[best] = True
            tp[rank] = True
    scores = np.asarray([pred_entities[i].confidence for i in order])
    return scores, tp


def eval_det_ap(samples, predicted_samples: dict, data_filter_fn=None,
                iou_threshold=None):
    """AP matrix [num_iou_thresholds] averaged over videos.

    Args mirror ``eval_clears_mot``; returns np.ndarray [T]."""
    if iou_threshold is None:
        # IoU .5:.95 in .05 steps — 10 thresholds (reference inferencer
        # passes np.arange(0.5, 1, 0.05), eval_det_ap.py:10 defaults [0.5])
        iou_threshold = np.arange(0.5, 1.0, 0.05).tolist()

    ap_rows = []
    for sample_id, sample in samples:
        pred = predicted_samples[sample_id]
        all_scores = {t: [] for t in iou_threshold}
        all_tp = {t: [] for t in iou_threshold}
        num_gt = 0
        for f in range(len(sample)):
            gt = sample.get_entities_for_frame_num(f)
            ignore_gt = []
            if data_filter_fn is not None:
                gt, ignore_gt = data_filter_fn(gt, meta_data=sample.metadata)
            pr = pred.get_entities_for_frame_num(f)
            if data_filter_fn is not None:
                pr, _ = data_filter_fn(pr, ignore_gt)
            num_gt += len(gt)
            for t in iou_threshold:
                s, tp = _greedy_match(gt, pr, t)
                all_scores[t].append(s)
                all_tp[t].append(tp)

        row = []
        for t in iou_threshold:
            s = np.concatenate(all_scores[t]) if all_scores[t] else np.zeros(0)
            tp = np.concatenate(all_tp[t]) if all_tp[t] else np.zeros(0, bool)
            row.append(average_precision(s, tp, num_gt))
        ap_rows.append(row)

    return np.asarray(ap_rows)


def average_precision(scores, tp, num_gt) -> float:
    """PR-curve AUC with score-descending cumulative precision/recall."""
    if num_gt == 0 or len(scores) == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tp = tp[order]
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(~tp)
    recall = cum_tp / num_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1)
    # trapezoidal AUC over (recall, precision)
    r = np.concatenate([[0.0], recall])
    p = np.concatenate([[1.0], precision])
    return float(np.sum((r[1:] - r[:-1]) * (p[1:] + p[:-1]) / 2.0))
