"""CLEAR-MOT + IDF1 evaluation (own copy of ``siammot_tpu.eval.clearmot``).

The reference delegates to ``motmetrics``; this module implements its
accumulator semantics with numpy and scipy:

  * per-frame correspondence: previous-frame matches are kept when still
    within the IoU gate (the MOTAccumulator continuation rule), remaining
    boxes matched by Hungarian assignment on IoU distance (1 - IoU,
    gated at ``1 - iou_thresh``);
  * events -> MOTA / MOTP (mean matched distance) / switches / FP / misses /
    MT-PT-ML trajectory coverage;
  * IDF1 via the Ristani global trajectory assignment (min-cost bipartite
    over per-id co-occurrence counts).
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def iou_distance_matrix(gt_boxes, pred_boxes, max_iou_dist: float):
    """1 - IoU (xywh), entries above the gate set to NaN."""
    g, p = len(gt_boxes), len(pred_boxes)
    d = np.full((g, p), np.nan)
    for i, a in enumerate(gt_boxes):
        ax, ay, aw, ah = a
        for j, b in enumerate(pred_boxes):
            bx, by, bw, bh = b
            x1, y1 = max(ax, bx), max(ay, by)
            x2, y2 = min(ax + aw, bx + bw), min(ay + ah, by + bh)
            inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
            union = aw * ah + bw * bh - inter
            iou = inter / union if union > 0 else 0.0
            dist = 1.0 - iou
            if dist <= max_iou_dist:
                d[i, j] = dist
    return d


class MOTAccumulator:
    """Frame-by-frame CLEAR event accumulator (motmetrics semantics)."""

    def __init__(self):
        self.last_match = {}        # gt_id -> pred_id
        self.num_frames = 0
        self.num_matches = 0
        self.num_switches = 0
        self.num_fp = 0
        self.num_misses = 0
        self.num_gt = 0
        self.dist_sum = 0.0
        self.gt_frames = {}         # gt_id -> #frames present
        self.gt_tracked = {}        # gt_id -> #frames matched
        self.pair_frames = {}       # (gt_id, pred_id) -> co-occur matched-able
        self.pred_frames = {}       # pred_id -> #frames present

    def update(self, gt_ids, pred_ids, dists: np.ndarray):
        self.num_frames += 1
        self.num_gt += len(gt_ids)
        for g in gt_ids:
            self.gt_frames[g] = self.gt_frames.get(g, 0) + 1
        for p in pred_ids:
            self.pred_frames[p] = self.pred_frames.get(p, 0) + 1
        # id-pair co-occurrence (within gate) for IDF1
        for i, g in enumerate(gt_ids):
            for j, p in enumerate(pred_ids):
                if not np.isnan(dists[i, j]):
                    self.pair_frames[(g, p)] = self.pair_frames.get((g, p), 0) + 1

        matches = {}
        unmatched_g = set(range(len(gt_ids)))
        unmatched_p = set(range(len(pred_ids)))

        # 1. continuation: keep previous correspondences still in gate
        pred_index = {p: j for j, p in enumerate(pred_ids)}
        for i, g in enumerate(gt_ids):
            p = self.last_match.get(g)
            if p is not None and p in pred_index:
                j = pred_index[p]
                if not np.isnan(dists[i, j]):
                    matches[i] = j
                    unmatched_g.discard(i)
                    unmatched_p.discard(j)

        # 2. Hungarian on the remainder
        gi = sorted(unmatched_g)
        pj = sorted(unmatched_p)
        if gi and pj:
            sub = dists[np.ix_(gi, pj)]
            cost = np.where(np.isnan(sub), 1e9, sub)
            rows, cols = linear_sum_assignment(cost)
            for r, c in zip(rows, cols):
                if not np.isnan(sub[r, c]):
                    matches[gi[r]] = pj[c]
                    unmatched_g.discard(gi[r])
                    unmatched_p.discard(pj[c])

        for i, j in matches.items():
            g, p = gt_ids[i], pred_ids[j]
            prev = self.last_match.get(g)
            if prev is not None and prev != p:
                self.num_switches += 1
            self.num_matches += 1
            self.dist_sum += dists[i, j]
            self.gt_tracked[g] = self.gt_tracked.get(g, 0) + 1
            self.last_match[g] = p

        self.num_misses += len(unmatched_g)
        self.num_fp += len(unmatched_p)

    # -- metrics -------------------------------------------------------------
    def mota(self):
        if self.num_gt == 0:
            return np.nan
        return 1.0 - (self.num_fp + self.num_misses + self.num_switches) \
            / self.num_gt

    def motp(self):
        return self.dist_sum / self.num_matches if self.num_matches else np.nan

    def mt_pt_ml(self):
        mt = pt = ml = 0
        for g, total in self.gt_frames.items():
            ratio = self.gt_tracked.get(g, 0) / total
            if ratio >= 0.8:
                mt += 1
            elif ratio <= 0.2:
                ml += 1
            else:
                pt += 1
        return mt, pt, ml

    def idf1(self):
        gts = sorted(self.gt_frames)
        preds = sorted(self.pred_frames)
        ng, np_ = len(gts), len(preds)
        if ng == 0 and np_ == 0:
            return np.nan
        size = ng + np_
        cost = np.zeros((size, size))
        big = 1e9
        cost[:ng, :np_] = 0.0
        for i, g in enumerate(gts):
            for j, p in enumerate(preds):
                m = self.pair_frames.get((g, p), 0)
                cost[i, j] = (self.gt_frames[g] - m) + (self.pred_frames[p] - m)
        # gt unmatched / pred unmatched blocks
        cost[:ng, np_:] = big
        for i, g in enumerate(gts):
            cost[i, np_ + i] = self.gt_frames[g]
        cost[ng:, :np_] = big
        for j, p in enumerate(preds):
            cost[ng + j, j] = self.pred_frames[p]
        rows, cols = linear_sum_assignment(cost)
        idtp = 0
        for r, c in zip(rows, cols):
            if r < ng and c < np_:
                idtp += self.pair_frames.get((gts[r], preds[c]), 0)
        total = sum(self.gt_frames.values()) + sum(self.pred_frames.values())
        return 2.0 * idtp / total if total else np.nan

    def summary(self) -> dict:
        mt, pt, ml = self.mt_pt_ml()
        return dict(
            num_frames=self.num_frames, mostly_tracked=mt,
            partially_tracked=pt, mostly_lost=ml,
            num_switches=self.num_switches,
            num_false_positives=self.num_fp, num_misses=self.num_misses,
            mota=self.mota(), motp=self.motp(), idf1=self.idf1(),
        )


def merge_summaries(summaries: dict) -> dict:
    """OVERALL row: event counts summed, rates recomputed from totals."""
    tot = dict(num_frames=0, mostly_tracked=0, partially_tracked=0,
               mostly_lost=0, num_switches=0, num_false_positives=0,
               num_misses=0)
    num_gt = num_matches = 0
    dist_sum = 0.0
    idtp_w = 0.0
    for acc in summaries.values():
        s = acc.summary()
        for k in tot:
            tot[k] += s[k]
        num_gt += acc.num_gt
        num_matches += acc.num_matches
        dist_sum += acc.dist_sum
        t = sum(acc.gt_frames.values()) + sum(acc.pred_frames.values())
        if t and not np.isnan(s["idf1"]):
            idtp_w += s["idf1"] * t / 2.0
    total_t = sum(sum(a.gt_frames.values()) + sum(a.pred_frames.values())
                  for a in summaries.values())
    tot["mota"] = 1.0 - (tot["num_false_positives"] + tot["num_misses"]
                         + tot["num_switches"]) / num_gt if num_gt else np.nan
    tot["motp"] = dist_sum / num_matches if num_matches else np.nan
    tot["idf1"] = 2.0 * idtp_w / total_t if total_t else np.nan
    return tot


def eval_clears_mot(samples, predicted_samples: dict, data_filter_fn=None,
                    iou_thresh: float = 0.5):
    """Evaluate predicted DataSamples against GT (the reference's
    ``eval_clears_mot.py:5-84``).

    Args:
      samples: iterable of (sample_id, DataSample) ground truth.
      predicted_samples: {sample_id: DataSample} predictions.

    Returns ({sample_id: MOTAccumulator}, printable summary string).
    """
    accs = {}
    for sample_id, sample in samples:
        pred = predicted_samples[sample_id]
        acc = MOTAccumulator()
        for f in range(len(sample)):
            gt = sample.get_entities_for_frame_num(f)
            ignore_gt = []
            if data_filter_fn is not None:
                gt, ignore_gt = data_filter_fn(gt, meta_data=sample.metadata)
            pr = pred.get_entities_for_frame_num(f)
            if data_filter_fn is not None:
                pr, _ = data_filter_fn(pr, ignore_gt)
            d = iou_distance_matrix([e.bbox for e in gt],
                                    [e.bbox for e in pr], 1.0 - iou_thresh)
            acc.update([e.id for e in gt], [e.id for e in pr], d)
        accs[sample_id] = acc

    header = (f"{'':24s} {'MOTA':>7s} {'MOTP':>7s} {'IDF1':>7s} {'MT':>5s} "
              f"{'PT':>5s} {'ML':>5s} {'IDs':>5s} {'FP':>7s} {'FN':>7s}")
    lines = [header]
    for sid, acc in accs.items():
        s = acc.summary()
        lines.append(
            f"{sid:24s} {s['mota']:7.3f} {s['motp']:7.3f} {s['idf1']:7.3f} "
            f"{s['mostly_tracked']:5d} {s['partially_tracked']:5d} "
            f"{s['mostly_lost']:5d} {s['num_switches']:5d} "
            f"{s['num_false_positives']:7d} {s['num_misses']:7d}")
    if accs:
        s = merge_summaries(accs)
        lines.append(
            f"{'OVERALL':24s} {s['mota']:7.3f} {s['motp']:7.3f} "
            f"{s['idf1']:7.3f} {s['mostly_tracked']:5d} "
            f"{s['partially_tracked']:5d} {s['mostly_lost']:5d} "
            f"{s['num_switches']:5d} {s['num_false_positives']:7d} "
            f"{s['num_misses']:7d}")
    return accs, "\n\n" + "\n".join(lines) + "\n\n"
