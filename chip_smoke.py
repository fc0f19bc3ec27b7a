#!/usr/bin/env python3
"""Cold smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as it finishes:
  0. the card (nvidia-smi name and power limit) and the torch/CUDA build;
  1. the build of every CUDA kernel from ``siammot_tpu_torch/ops/cuda``;
  2. each kernel against its plain PyTorch version on the card, at the
     shapes of the 720p main path with 37 of 128 track slots live (the
     occupancy of a crowded scene) and 300 + 37 live box-head ROIs of 428:
     errors within the stated tolerance, dead slots exactly zero, and the
     kernel's, the plain version's and, where one PyTorch call computes
     the same function, that call's time;
  3. the main path end to end: the repo's trained DLA-34-FPN-EMM weights
     (``fixtures/bench_weights_f16.npz``) in bf16, 40 frames of a crowded
     720p sprite scene through ``track_frames`` (10 warm-up, 30 timed);
     every kernel's launch count must rise in this phase (the window pool
     three times a frame), tracks must be live, and each kernel must agree
     with its plain version on the inputs it got at the last frame.

It prints a JSON line of per-kernel numbers, then, last,
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
so does a machine without a CUDA device, or a directory without the port.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, "fixtures", "bench_weights_f16.npz")
K, LIVE = 128, 37                 # track slots, live slots (crowded scene)
N_PROP = 300                      # box-head proposals
H, W = 720, 1280
HP = 736                          # padded to SIZE_DIVISIBILITY 32
FPN_HW = [(184, 320), (92, 160), (46, 80), (23, 40)]
C = 128
SCALES = (0.25, 0.125, 0.0625, 0.03125)
WARMUP, TIMED = 10, 30

# H100 SXM published peaks (dense): 3.35 TB/s HBM, 989 TFLOP/s bf16 tensor
# cores, 67 TFLOP/s f32 on the CUDA cores
HBM_BYTES_S = 3.35e12
BF16_TC_FLOPS = 989e12
F32_FLOPS = 67e12

# Tolerances, kernel against plain version on the card:
#  pool / xcorr: f32 sums in another order -> |d| <= 1e-4 + 1e-3 |plain|
#  predictor: the bf16 cast of the tower output can round either way,
#    which moves the f32 head logits -> |d| <= 3e-2
#  decode: idx exact unless the two cells' p_conf lie within 1e-6 (the
#    upsample's sums run in another order); score to 1e-5
POOL_ATOL, POOL_RTOL = 1e-4, 1e-3
PRED_ATOL = 3e-2
DECODE_TIE, DECODE_SCORE_ATOL = 1e-6, 1e-5


def log(*a):
    print(*a, flush=True)


def timed_ms(fn, iters=20, warmup=3):
    """Mean device time of one call, by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def close(kernel, plain, atol, rtol, what):
    err = (kernel - plain).abs()
    bad = err > atol + rtol * plain.abs()
    if not torch.isfinite(kernel).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    if bad.any():
        raise AssertionError(
            f"{what}: {int(bad.sum())} elements off (max abs err "
            f"{float(err.max()):.3g}, atol {atol}, rtol {rtol})")
    rel = (err / plain.abs().clamp(min=1e-6)).max()
    return float(err.max()), float(rel)


def dead_zero(t, valid, what):
    if (t[~valid] != 0).any():
        raise AssertionError(f"{what}: dead slots are not exactly zero")


# -- kernel checks -----------------------------------------------------------

def check_pool(args, what):
    from siammot_tpu_torch.ops.window_pool import (window_pool,
                                                   window_pool_plain)
    k = window_pool(*args)
    p = window_pool_plain(*args)
    torch.cuda.synchronize()
    dead_zero(k, args[4], what)
    return close(k, p, POOL_ATOL, POOL_RTOL, what)


def check_xcorr(args, what):
    from siammot_tpu_torch.ops.xcorr import (xcorr_depthwise_masked,
                                             xcorr_depthwise_plain)
    k = xcorr_depthwise_masked(*args)
    p = xcorr_depthwise_plain(*args)
    torch.cuda.synchronize()
    dead_zero(k, args[2], what)
    return close(k, p, POOL_ATOL, POOL_RTOL, what)


def check_predictor(args, what):
    from siammot_tpu_torch.ops.predictor import (emm_predictor,
                                                 emm_predictor_plain)
    ks = emm_predictor(*args)
    ps = emm_predictor_plain(*args)
    torch.cuda.synchronize()
    errs = []
    for name, k, p in zip(("cls", "ctr", "reg"), ks, ps):
        dead_zero(k, args[1], f"{what} {name}")
        errs.append(close(k, p, PRED_ATOL, 0.0, f"{what} {name}"))
    return max(e[0] for e in errs), max(e[1] for e in errs)


def check_decode(args, what):
    from siammot_tpu_torch.ops.decode import (emm_decode, emm_decode_plain,
                                              penalized_confidence)
    x4, wh, u, window, valid, sigma, use_c = args
    ki, ks = emm_decode(*args)
    pi, ps = emm_decode_plain(*args)
    torch.cuda.synchronize()
    if (ki[~valid] != 0).any() or (ks[~valid] != 0).any():
        raise AssertionError(f"{what}: dead slots are not (0, 0)")
    p_conf, _ = penalized_confidence(x4, wh, u, window, sigma, use_c)
    flat = p_conf.reshape(p_conf.shape[0], -1)
    diff = ki != pi
    if diff.any():
        rows = diff.nonzero()[:, 0]
        gap = (flat[rows, ki[rows].long()] - flat[rows, pi[rows].long()]).abs()
        if (gap > DECODE_TIE).any():
            raise AssertionError(f"{what}: argmax differs beyond a tie "
                                 f"({float(gap.max()):.3g})")
    same = ~diff
    err = (ks[same] - ps[same]).abs()
    if (err > DECODE_SCORE_ATOL).any() or not torch.isfinite(ks).all():
        raise AssertionError(f"{what}: score off by {float(err.max()):.3g}")
    log(f"    {what}: {int(diff.sum())} tie-swapped argmax of "
        f"{int(valid.sum())} live")
    rel = (err / ps[same].abs().clamp(min=1e-6)).max() if same.any() \
        else torch.zeros(())
    return float(err.max()) if same.any() else 0.0, float(rel)


# -- seeded inputs at the main path's shapes ---------------------------------

def live_mask(n, live, g, dev):
    v = torch.zeros(n, dtype=torch.bool)
    v[torch.randperm(n, generator=g)[:live]] = True
    return v.to(dev)


def track_boxes(n, g):
    w = 40 + 110 * torch.rand(n, generator=g)
    h = 80 + 220 * torch.rand(n, generator=g)
    x = (W - w) * torch.rand(n, generator=g)
    y = (H - h) * torch.rand(n, generator=g)
    return torch.stack([x, y, x + w, y + h], -1)


def pool_inputs(g, dev):
    """(table, {site: (origins, wy, wx, valid)}) for the three sites."""
    from siammot_tpu_torch.core.boxes import map_rois_to_levels
    from siammot_tpu_torch.models.emm import EMMConfig, make_search_region
    from siammot_tpu_torch.ops.roi_align_windowed import (pack_levels,
                                                          window_geometry)
    feats = [torch.randn(1, h, w, C, generator=g).to(dev) for h, w in FPN_HW]
    pack = pack_levels(feats, SCALES, dtype=torch.bfloat16)
    ecfg = EMMConfig(15, SCALES, 2, 2.0, 0, 512, True, 0.4, False)

    def geometry(rois, levels, size, window, pad):
        block = levels.to(dev)
        scales = torch.tensor(SCALES, device=dev)[block.long()]
        return window_geometry(pack.heights, pack.widths, pack.row_offsets,
                               rois.to(dev), block, scales, size, 2, window,
                               pad, 4)

    tb = track_boxes(K, g)
    tlev = map_rois_to_levels(tb, 2, 5)
    sites = {}
    sites["sr_pool"] = geometry(make_search_region(tb, ecfg), tlev, 30, 128,
                                512) + (live_mask(K, LIVE, g, dev),)
    sites["template_pool"] = geometry(tb, tlev, 15, 64, 0) \
        + (live_mask(K, LIVE, g, dev),)
    sz = 16 + 380 * torch.rand(N_PROP, 2, generator=g)
    xy = torch.rand(N_PROP, 2, generator=g) * (torch.tensor([W, H]) - sz)
    props = torch.cat([xy, xy + sz], -1)
    rois = torch.cat([props, tb])
    bvalid = torch.cat([torch.ones(N_PROP, dtype=torch.bool),
                        live_mask(K, LIVE, g, "cpu")]).to(dev)
    sites["box_pool"] = geometry(rois, map_rois_to_levels(rois, 2, 5), 7, 64,
                                 0) + (bvalid,)
    return pack.table, sites


def predictor_params(g, dev):
    from siammot_tpu_torch.ops.predictor import _NAMES
    out = {}
    for name in _NAMES:
        head = name.split(".")[0]
        if name.endswith("kernel"):
            cout = {"cls": 2, "center": 1, "reg": 4}.get(head, C)
            t = torch.randn(3, 3, C, cout, generator=g) * 0.03
        elif name.endswith("scale"):
            t = 1 + 0.1 * torch.randn(C, generator=g)
        else:
            n = {"cls": 2, "center": 1, "reg": 4}.get(head, C)
            t = 0.1 * torch.randn(n, generator=g)
        out[name] = t.to(dev, torch.bfloat16).contiguous()
    return out


# -- bounds ------------------------------------------------------------------

def pool_bound(table, origins, wy, wx, valid):
    """Bytes: the table cells under live taps (each once), live weights,
    all outputs; flops: two per live tap product."""
    live = valid.nonzero()[:, 0]
    n, s, win = wy.shape
    rows_nz = (wy[live] != 0).any(1)                  # [L, win]
    cols_nz = (wx[live] != 0).any(1)
    r, wmax, c = table.shape
    cover = torch.zeros(r, wmax, dtype=torch.bool, device=table.device)
    o = origins[live].long()
    ar = torch.arange(win, device=table.device)
    for i in range(len(live)):
        rr = (o[i, 0] + ar)[rows_nz[i]]
        cc = (o[i, 1] + ar)[cols_nz[i]]
        cover[rr[:, None], cc[None, :]] = True
    nbytes = (int(cover.sum()) * c * table.element_size()
              + len(live) * (2 * s * win * 4 + 8) + n
              + n * s * s * c * 4)
    nzy = (wy[live] != 0).sum(-1).float()             # [L, S]
    nzx = (wx[live] != 0).sum(-1).float()
    flops = float(c * (nzy.sum(1) * (2 * nzx + 2).sum(1)).sum())
    return bound(nbytes, flops, F32_FLOPS)


def bound(nbytes, flops, peak):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# -- phases ------------------------------------------------------------------

def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


KERNELS = {
    "window_pool": dict(source="siammot_tpu_torch/ops/cuda/window_pool.cu",
                        replaces="siammot_tpu/ops/pallas/window_pool.py:299"),
    "xcorr_masked": dict(source="siammot_tpu_torch/ops/cuda/xcorr.cu",
                         replaces="siammot_tpu/ops/pallas/xcorr.py:55"),
    "emm_predictor": dict(source="siammot_tpu_torch/ops/cuda/predictor.cu",
                          replaces="siammot_tpu/ops/pallas/predictor.py:309"),
    "emm_decode": dict(source="siammot_tpu_torch/ops/cuda/decode.cu",
                       replaces="siammot_tpu/ops/pallas/decode.py:174"),
}


def kernel_phase(dev, report):
    import torch.nn.functional as F

    from siammot_tpu_torch.models.emm import _decode_constants
    from siammot_tpu_torch.ops.decode import emm_decode, emm_decode_plain
    from siammot_tpu_torch.ops.predictor import (emm_predictor,
                                                 emm_predictor_plain)
    from siammot_tpu_torch.ops.window_pool import (window_pool,
                                                   window_pool_plain)
    from siammot_tpu_torch.ops.xcorr import (xcorr_depthwise_masked,
                                             xcorr_depthwise_plain)
    g = torch.Generator().manual_seed(0)
    for fn in (window_pool, xcorr_depthwise_masked, emm_predictor,
               emm_decode):
        fn.launches = 0

    # kernel 1 at its three sites
    table, sites = pool_inputs(g, dev)
    pool = report["window_pool"]
    pool.update(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None,
                max_abs_err=0.0, sites={})
    for site, (origins, wy, wx, valid) in sites.items():
        args = (table, origins, wy, wx, valid)
        err, rel = check_pool(args, site)
        ms = timed_ms(lambda: window_pool(*args))
        pms = timed_ms(lambda: window_pool_plain(*args), iters=3, warmup=1)
        bms, by = pool_bound(*args)
        log(f"  window_pool {site}: N={wy.shape[0]} live={int(valid.sum())} "
            f"S={wy.shape[1]} window={wy.shape[2]}: "
            f"{window_pool.launches} launches so far, kernel {ms:.4f} ms, "
            f"plain {pms:.4f} ms, bound {bms:.4f} ms ({by}), max abs err "
            f"{err:.3g}, max rel err {rel:.3g} (tol {POOL_ATOL} + "
            f"{POOL_RTOL}|x|)")
        pool["sites"][site] = dict(ms=ms, plain_ms=pms, bound_ms=bms,
                                   bound_by=by, max_abs_err=err)
        pool["ms"] += ms
        pool["plain_ms"] += pms
        pool["bound_ms"] += bms
        pool["max_abs_err"] = max(pool["max_abs_err"], err)
    pool["bound_by"] = max(pool["sites"].values(),
                           key=lambda s: s["bound_ms"])["bound_by"]

    # kernel 2
    valid = live_mask(K, LIVE, g, dev)
    search = torch.randn(K, 30, 30, C, generator=g).to(dev, torch.bfloat16)
    tmpl = (0.1 * torch.randn(K, 15, 15, C, generator=g)).to(
        dev, torch.bfloat16)
    args = (search, tmpl, valid)
    err, rel = check_xcorr(args, "xcorr_masked")
    ms = timed_ms(lambda: xcorr_depthwise_masked(*args))
    pms = timed_ms(lambda: xcorr_depthwise_plain(*args), iters=5)
    # the reference's own form: one groups=K*C convolution over all slots
    s_nchw = search.permute(0, 3, 1, 2).reshape(1, K * C, 30, 30)
    t_nchw = tmpl.permute(0, 3, 1, 2).reshape(K * C, 1, 15, 15)
    lms = timed_ms(lambda: F.conv2d(s_nchw, t_nchw, groups=K * C))
    live = int(valid.sum())
    nbytes = live * (30 * 30 + 15 * 15) * C * 2 + K * 16 * 16 * C * 4 + K
    bms, by = bound(nbytes, live * 16 * 16 * 15 * 15 * C * 2.0, F32_FLOPS)
    log(f"  xcorr_masked: K={K} live={live}: "
        f"{xcorr_depthwise_masked.launches} launches, kernel {ms:.4f} ms, "
        f"plain "
        f"{pms:.4f} ms, conv2d(groups) {lms:.4f} ms, bound {bms:.4f} ms "
        f"({by}), max abs err {err:.3g}, max rel err {rel:.3g} (tol "
        f"{POOL_ATOL} + {POOL_RTOL}|x|)")
    report["xcorr_masked"].update(ms=ms, plain_ms=pms, library_ms=lms,
                                  bound_ms=bms, bound_by=by, max_abs_err=err)

    # kernel 3
    valid = live_mask(K, LIVE, g, dev)
    x = torch.randn(K, 16, 16, C, generator=g).to(dev, torch.bfloat16)
    params = predictor_params(g, dev)
    args = (x, valid, params)
    err, rel = check_predictor(args, "emm_predictor")
    ms = timed_ms(lambda: emm_predictor(*args))
    pms = timed_ms(lambda: emm_predictor_plain(*args), iters=5)
    live = int(valid.sum())
    flops = live * (2 * 256 * C * C * 9 + 256 * 7 * C * 9) * 2.0
    nbytes = (live * 256 * C * 2 + sum(p.numel() * 2 for p in
                                       params.values())
              + K * 256 * 7 * 4 + K)
    bms, by = bound(nbytes, flops, BF16_TC_FLOPS)
    log(f"  emm_predictor: K={K} live={live}: {emm_predictor.launches} "
        f"launches, kernel {ms:.4f} ms, plain "
        f"{pms:.4f} ms, bound {bms:.4f} ms ({by}), max abs err {err:.3g}, "
        f"max rel err {rel:.3g} (tol {PRED_ATOL})")
    report["emm_predictor"].update(ms=ms, plain_ms=pms, library_ms=None,
                                   bound_ms=bms, bound_by=by,
                                   max_abs_err=err)

    # kernel 4
    valid = live_mask(K, LIVE, g, dev)
    u, window = _decode_constants(16, 16, str(dev))
    x4 = torch.stack([2 * torch.randn(K, 16, 16, generator=g),
                      torch.randn(K, 16, 16, generator=g),
                      60 + 20 * torch.randn(K, 16, 16, generator=g),
                      120 + 40 * torch.randn(K, 16, 16, generator=g)],
                     1).to(dev).contiguous()
    wh = torch.stack([40 + 110 * torch.rand(K, generator=g),
                      80 + 220 * torch.rand(K, generator=g)], -1).to(dev)
    args = (x4, wh, u, window, valid, 0.4, True)
    err, rel = check_decode(args, "emm_decode")
    ms = timed_ms(lambda: emm_decode(*args))
    pms = timed_ms(lambda: emm_decode_plain(*args), iters=5)
    live = int(valid.sum())
    flops = live * (4 * 256 * 16 * 16 * 2 + 4 * 256 * 256 * 16 * 2
                    + 256 * 256 * 30.0)
    nbytes = (live * 4 * 256 * 4 + u.numel() * 4 + window.numel() * 4
              + K * (8 + 1 + 8))
    bms, by = bound(nbytes, flops, F32_FLOPS)
    log(f"  emm_decode: K={K} live={live}: {emm_decode.launches} launches, "
        f"kernel {ms:.4f} ms, plain "
        f"{pms:.4f} ms, bound {bms:.4f} ms ({by}), max abs score err "
        f"{err:.3g}, max rel err {rel:.3g} (idx exact or p_conf tie within "
        f"{DECODE_TIE}; score tol {DECODE_SCORE_ATOL})")
    report["emm_decode"].update(ms=ms, plain_ms=pms, library_ms=None,
                                bound_ms=bms, bound_by=by, max_abs_err=err)


def end_to_end_phase(dev, report):
    import siammot_tpu_torch.models.emm as emm_mod
    import siammot_tpu_torch.ops.roi_align_windowed as rw_mod
    from siammot_tpu_torch.configs.defaults import get_cfg
    from siammot_tpu_torch.engine.inferencer import track_frames
    from siammot_tpu_torch.models.siammot import SiamMOT
    from siammot_tpu_torch.ops.decode import emm_decode
    from siammot_tpu_torch.ops.predictor import emm_predictor
    from siammot_tpu_torch.ops.window_pool import window_pool
    from siammot_tpu_torch.ops.xcorr import xcorr_depthwise_masked
    from siammot_tpu_torch.utils.synth import render_scene
    from siammot_tpu_torch.utils.weights import jax_to_torch, load_npz

    t0 = time.perf_counter()
    params = jax_to_torch(load_npz(FIXTURE))
    frames = render_scene(16, HP)
    log(f"  weights ({len(params)} tensors) and 16 frames ready in "
        f"{time.perf_counter() - t0:.1f} s")
    model = SiamMOT(get_cfg(), device=str(dev))

    # keep the inputs each kernel got at the last frame (by reference:
    # no copies inside the timed loop)
    captured = {"window_pool": [], "xcorr_masked": [], "emm_predictor": [],
                "emm_decode": []}

    def capture(name, fn, keep):
        def wrapped(*args):
            captured[name] = (captured[name] + [args])[-keep:]
            return fn(*args)
        return wrapped

    patches = [(rw_mod, "window_pool", capture("window_pool", window_pool,
                                              3)),
               (emm_mod, "xcorr_depthwise_masked",
                capture("xcorr_masked", xcorr_depthwise_masked, 1)),
               (emm_mod, "emm_predictor",
                capture("emm_predictor", emm_predictor, 1)),
               (emm_mod, "emm_decode", capture("emm_decode", emm_decode, 1))]
    originals = [(m, n, getattr(m, n)) for m, n, _ in patches]
    for m, n, f in patches:
        setattr(m, n, f)
    counters = {"window_pool": window_pool,
                "xcorr_masked": xcorr_depthwise_masked,
                "emm_predictor": emm_predictor, "emm_decode": emm_decode}
    try:
        for fn in counters.values():
            fn.launches = 0
        stream = [frames[i % len(frames)] for i in range(WARMUP + TIMED)]
        result = track_frames(model, params, stream, (W, H))
        launches = {n: fn.launches for n, fn in counters.items()}
    finally:
        for m, n, f in originals:
            setattr(m, n, f)

    n_frames = WARMUP + TIMED
    for name, count in launches.items():
        want = 3 * n_frames if name == "window_pool" else n_frames
        if count != want:
            raise AssertionError(f"{name}: {count} launches on the main "
                                 f"path, expected {want}")
        report[name]["launches"] = count
    sec = np.array(result.frame_seconds[WARMUP:])
    state = result.state
    occupied = int(state.occupied.sum())
    active = int(state.active.sum())
    log(f"  {n_frames} frames: {1e3 * sec.mean():.3f} ms/frame over the "
        f"last {TIMED} (median {1e3 * np.median(sec):.3f}, first frame "
        f"{1e3 * result.frame_seconds[0]:.1f} ms); live slots {occupied} of "
        f"{K} ({active} active); launches {launches}")
    if occupied == 0:
        raise AssertionError("no live track slot: the EMM kernels did no "
                             "work")
    last = result.outputs[-1]
    v = last["valid"]
    if v.sum() == 0 or not np.isfinite(last["boxes"][v]).all() \
            or not ((last["scores"][v] >= 0) & (last["scores"][v] <= 1)).all():
        raise AssertionError("last frame: no valid rows, or non-finite "
                             "boxes, or scores outside [0, 1]")
    ids = last["ids"][v & (last["ids"] >= 0)]
    if len(np.unique(ids)) != len(ids):
        raise AssertionError("last frame: a track id appears twice")

    # each kernel against its plain version on the main path's inputs
    for site, args in zip(("sr_pool", "box_pool", "template_pool"),
                          captured["window_pool"]):
        err, _ = check_pool(args, f"main-path {site}")
        report["window_pool"]["max_abs_err"] = max(
            report["window_pool"]["max_abs_err"], err)
    for name, check in (("xcorr_masked", check_xcorr),
                        ("emm_predictor", check_predictor),
                        ("emm_decode", check_decode)):
        err, _ = check(captured[name][0], f"main-path {name}")
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)
    log(f"  kernels agree with their plain versions on the last frame's "
        f"inputs ({int(captured['xcorr_masked'][0][2].sum())} live slots)")
    return 1e3 * float(sec.mean()), occupied


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    t_start = time.perf_counter()
    from siammot_tpu_torch.ops import cuda as cuda_lib
    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    log(f"[0] card: {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")

    t0 = time.perf_counter()
    cuda_lib.library()
    log(f"[1] built and loaded the CUDA kernels in "
        f"{time.perf_counter() - t0:.1f} s")

    report = {n: dict(name=n, route="cuda", **meta)
              for n, meta in KERNELS.items()}
    t0 = time.perf_counter()
    log("[2] kernels against their plain versions, main-path shapes:")
    kernel_phase(dev, report)
    log(f"[2] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[3] end to end: DLA-34-FPN-EMM, bench weights, 720p crowd:")
    ms_frame, occupied = end_to_end_phase(dev, report)
    log(f"[3] done in {time.perf_counter() - t0:.1f} s")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: r[k] for k in keys} | ({"sites": r["sites"]}
                                          if "sites" in r else {})
               for r in report.values()]
    log(f"total {time.perf_counter() - t_start:.1f} s; {ms_frame:.3f} "
        f"ms/frame; {occupied} live slots; card {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
