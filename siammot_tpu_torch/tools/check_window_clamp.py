"""The windowed pooler's clamp rate over a dataset's boxes (counterpart of
``tools/check_window_clamp.py``).

The windowed ROIAlign drops the bilinear taps that fall outside a static
per-ROI window (PARITY.md deviations 5 and 9);
``ops/roi_align_windowed.window_clamp_mask`` flags exactly the ROIs whose
windowed result differs from the exact gather pooler's.  This tool runs
it over an ingested dataset's ground truth and public detections at the
three pool sites (box head 7x7 in ``TPU.WINDOW_BOX``, EMM template in
``TPU.WINDOW_TEMPLATE``, EMM search region in ``TPU.WINDOW_SR`` with the
virtual pad), with the config's inference geometry, and prints one JSON
line of clamp rates, the JAX tool's line.

    python -m siammot_tpu_torch.tools.check_window_clamp \\
        --config-file configs/dla/DLA_34_FPN_EMM_SYNMOT_HARD.yaml \\
        --dataset SYNMOT_MINI --set test DATASETS.ROOT_DIR tests/fixtures

A diagnostic in plain PyTorch on the CPU: it pools nothing.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

SCALES = (0.25, 0.125, 0.0625, 0.03125)


def resize_factor(w, h, min_size, max_size):
    scale = min_size / min(w, h)
    if max(w, h) * scale > max_size:
        scale = max_size / max(w, h)
    return scale


def collect_boxes(samples, pub, cfg):
    """xyxy boxes in network-input coordinates: (ground truth, public
    detections), f32."""
    gt_boxes, det_boxes = [], []
    for vid, sample in samples:
        res = sample.metadata.get("resolution") or {}
        w, h = res.get("width", 640), res.get("height", 384)
        s = resize_factor(w, h, cfg.INPUT.MIN_SIZE_TEST,
                          cfg.INPUT.MAX_SIZE_TEST)
        for e in sample.entities:
            x, y, bw, bh = e.bbox
            gt_boxes.append([x * s, y * s, (x + bw) * s, (y + bh) * s])
        if pub and vid in pub:
            for e in pub[vid].entities:
                x, y, bw, bh = e.bbox
                det_boxes.append([x * s, y * s, (x + bw) * s,
                                  (y + bh) * s])
    return (np.asarray(gt_boxes, np.float32).reshape(-1, 4),
            np.asarray(det_boxes, np.float32).reshape(-1, 4))


def clamp_rate(boxes, heights, widths, out, ratio, window, pad_pixels=0,
               ecfg=None, chunk=65536):
    """(fraction, count) of the ROIs with a clamped (deviating) tap; with
    ``ecfg`` the search-region site: level by the box, crop by its search
    region."""
    from ..core.boxes import map_rois_to_levels
    from ..models.emm import make_search_region
    from ..ops.roi_align_windowed import window_clamp_mask

    scales = torch.tensor(SCALES, dtype=torch.float32)
    flags = []
    for i in range(0, len(boxes), chunk):
        b = torch.from_numpy(boxes[i:i + chunk])
        levels = map_rois_to_levels(b, 2, 5).long()
        rois = b if ecfg is None else make_search_region(b, ecfg)
        flags.append(window_clamp_mask(
            rois, scales[levels], heights, widths, levels, out, ratio,
            window, pad_pixels=pad_pixels).numpy())
    flags = np.concatenate(flags) if flags else np.zeros((0,), bool)
    return float(flags.mean()) if len(flags) else 0.0, int(flags.sum())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--set", default="test")
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    from ..configs.defaults import get_cfg
    from ..data.data_utils import load_dataset_anno, load_public_detection
    from ..models.emm import EMMConfig

    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)

    samples, _ = load_dataset_anno(cfg, args.dataset, set=args.set)
    pub = load_public_detection(cfg, args.dataset)
    gt, det = collect_boxes(samples, pub, cfg)
    print(f"{len(gt)} GT boxes, {len(det)} public detections "
          f"from {len(samples)} videos", file=sys.stderr)

    # inference feature geometry at the static input size
    ih = cfg.TPU.INPUT_HEIGHT or cfg.INPUT.MIN_SIZE_TEST
    iw = cfg.TPU.INPUT_WIDTH or cfg.INPUT.MAX_SIZE_TEST
    heights = [int(np.ceil(ih / (4 * 2 ** i))) for i in range(4)]
    widths = [int(np.ceil(iw / (4 * 2 ** i))) for i in range(4)]

    t = cfg.MODEL.TRACK_HEAD
    ecfg = EMMConfig(
        resolution=t.POOLER_RESOLUTION, scales=tuple(t.POOLER_SCALES),
        sampling_ratio=t.POOLER_SAMPLING_RATIO,
        search_region=t.SEARCH_REGION,
        min_search_wh=t.MINIMUM_SREACH_REGION,  # the reference's spelling
        pad_pixels=t.PAD_PIXELS, use_centerness=True,
        cosine_window_weight=0.0, amodal=cfg.INPUT.AMODAL)

    all_det = np.concatenate([gt, det], 0) if len(det) else gt
    report = {"dataset": args.dataset, "set": args.set,
              "n_gt": len(gt), "n_pub_det": len(det)}
    r, n = clamp_rate(all_det, heights, widths,
                      cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION,
                      cfg.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO,
                      cfg.TPU.WINDOW_BOX)
    report["box_head"] = {"clamp_rate": r, "clamped": n,
                          "window": cfg.TPU.WINDOW_BOX}
    r, n = clamp_rate(gt, heights, widths, t.POOLER_RESOLUTION,
                      t.POOLER_SAMPLING_RATIO, cfg.TPU.WINDOW_TEMPLATE)
    report["template"] = {"clamp_rate": r, "clamped": n,
                          "window": cfg.TPU.WINDOW_TEMPLATE}
    r, n = clamp_rate(gt, heights, widths, ecfg.sr_size,
                      t.POOLER_SAMPLING_RATIO, cfg.TPU.WINDOW_SR,
                      pad_pixels=t.PAD_PIXELS, ecfg=ecfg)
    report["search_region"] = {"clamp_rate": r, "clamped": n,
                               "window": cfg.TPU.WINDOW_SR}
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
