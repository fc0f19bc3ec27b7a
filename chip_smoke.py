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
  2b. the training kernels the same way at the training shapes (4 frames,
     1024 sampled pairs or ROIs per pool site, f32): the unmasked xcorr
     and its two gradient kernels (also through the autograd Function
     against autograd through the plain version), and the window pool's
     forward over live ROIs and its table gradient at the three sites on
     an f32 table of four 736x1280 frames' FPN levels;
  3. the main path end to end: the repo's trained DLA-34-FPN-EMM weights
     (``fixtures/bench_weights_f16.npz``) in bf16, 40 frames of a crowded
     720p sprite scene through ``track_frames`` (10 warm-up, 30 timed);
     every kernel's launch count must rise in this phase (the window pool
     three times a frame), tracks must be live, and each kernel must agree
     with its plain version on the inputs it got at the last frame;
  4. the training path end to end: the same weights as f32 masters, bf16
     compute, an f32 pool table, ``do_train`` over batches of two clips x
     two consecutive frames of the crowded scene (``MAX_GT`` 100) for 3
     warm-up + 10 timed SGD steps: every loss finite at every step, per
     step exactly 3 window-pool forward and 3 backward launches and one
     launch of each xcorr kernel (forward, template and search gradient),
     and each kernel in agreement with its plain version on the inputs
     and upstream gradients it got at the last step; ms/step and peak
     device memory.

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
TRAIN_WARMUP, TRAIN_TIMED = 3, 10
N_TRAIN = 1024                    # 4 frames x 256 samples per pool site
TRAIN_HW = [(184, 320), (92, 160), (46, 80), (23, 40)]

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
#  pool backward: the same, its atomics add in an order that changes
#    from run to run; on a real step's gradients, whose scale is set by
#    the loss, the absolute part is 1e-4 of the largest plain value
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
    kernel, plain = kernel.detach(), plain.detach()
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
    "xcorr": dict(source="siammot_tpu_torch/ops/cuda/xcorr.cu",
                  replaces="siammot_tpu/ops/pallas/xcorr.py:80"),
    "window_pool_bwd": dict(
        source="siammot_tpu_torch/ops/cuda/window_pool_bwd.cu",
        replaces="siammot_tpu/ops/pallas/window_pool.py:200"),
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
    frames = render_scene(16, HP)[0]
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


# -- training phases ---------------------------------------------------------

def close_scaled(kernel, plain, what):
    """Agreement on a real step's tensors: the absolute part of the
    tolerance is relative to the largest plain value."""
    scale = float(plain.detach().abs().max())
    err, rel = close(kernel, plain, POOL_ATOL * max(scale, 1e-30),
                     POOL_RTOL, what)
    return err, rel


def xcorr_passes():
    """(name, kernel wrapper, plain version) of kernel 6's three passes."""
    from siammot_tpu_torch.ops.xcorr import (xcorr_depthwise,
                                             xcorr_depthwise_plain,
                                             xcorr_grad_search,
                                             xcorr_grad_search_plain,
                                             xcorr_grad_template)
    return (("forward", xcorr_depthwise, xcorr_depthwise_plain),
            ("grad_template", xcorr_grad_template, xcorr_depthwise_plain),
            ("grad_search", xcorr_grad_search, xcorr_grad_search_plain))


def check_xcorr_autograd(search, template, grad, what, scaled=False):
    """The differentiable xcorr (kernel 6 and its gradient kernels)
    against autograd through the plain version: output and both input
    gradients, each in its input's dtype."""
    from siammot_tpu_torch.ops.xcorr import (xcorr_depthwise_auto,
                                             xcorr_depthwise_plain)
    res = []
    for fn in (xcorr_depthwise_auto, xcorr_depthwise_plain):
        s = search.detach().clone().requires_grad_(True)
        t = template.detach().clone().requires_grad_(True)
        out = fn(s, t)
        out.backward(grad)
        res.append((out.detach(), s.grad, t.grad))
    torch.cuda.synchronize()
    errs = []
    for name, k, p in zip(("output", "d_search", "d_template"), *res):
        if k.dtype != p.dtype:
            raise AssertionError(f"{what} {name}: dtype {k.dtype} != "
                                 f"{p.dtype}")
        atol = POOL_ATOL * (float(p.abs().max()) if scaled else 1.0)
        # bf16 gradients: both round f32 sums to bf16, at most one bf16
        # ulp (2^-8 of the value, 2^-7 at a binade's low end) apart
        rtol = 2 ** -7 if k.dtype == torch.bfloat16 else POOL_RTOL
        errs.append(close(k.float(), p.float(), max(atol, 1e-30), rtol,
                          f"{what} {name}"))
    return max(e[0] for e in errs)


def train_pool_inputs(g, dev):
    """(f32 table of 4 frames, {site: (origins, wy, wx)}) at the training
    sites: 4 x 256 sampled box-head ROIs, 4 x 256 template boxes and the
    search regions of their pair frames."""
    from siammot_tpu_torch.core.boxes import map_rois_to_levels
    from siammot_tpu_torch.models.emm import EMMConfig, make_search_region
    from siammot_tpu_torch.ops.roi_align_windowed import (pack_levels,
                                                          window_geometry)
    feats = [torch.randn(4, h, w, C, generator=g).to(dev)
             for h, w in TRAIN_HW]
    pack = pack_levels(feats, SCALES, dtype=torch.float32)
    del feats
    ecfg = EMMConfig(15, SCALES, 2, 2.0, 0, 512, True, 0.4, False)
    img = torch.arange(4).repeat_interleave(N_TRAIN // 4)

    def geometry(rois, level_rois, img_idx, size, window, pad):
        levels = map_rois_to_levels(level_rois, 2, 5)
        block = (img_idx * 4 + levels).to(dev, torch.int32)
        scales = torch.tensor(SCALES, device=dev)[levels.long().to(dev)]
        return window_geometry(pack.heights, pack.widths, pack.row_offsets,
                               rois.to(dev), block, scales, size, 2, window,
                               pad, 4)

    sz = 16 + 380 * torch.rand(N_TRAIN, 2, generator=g)
    xy = torch.rand(N_TRAIN, 2, generator=g) * (torch.tensor([W, H]) - sz)
    props = torch.cat([xy, xy + sz], -1)
    tb = track_boxes(N_TRAIN, g)
    sites = {"box_pool": geometry(props, props, img, 7, 64, 0),
             "template_pool": geometry(tb, tb, img, 15, 64, 0),
             "sr_pool": geometry(make_search_region(tb, ecfg), tb, img ^ 1,
                                 30, 128, 512)}
    return pack.table, sites


def pool_bwd_bound(table_shape, grad, wy, wx):
    """Bytes: g and the weights read once, the whole f32 table gradient
    written once; flops: two per (non-zero wy, non-zero wx, channel)."""
    r, wmax, c = table_shape
    n, s, win = wy.shape
    nbytes = (grad.numel() * 4 + 2 * n * s * win * 4 + n * 8
              + r * wmax * c * 4)
    nzy = (wy != 0).sum((1, 2)).double()
    nzx = (wx != 0).sum((1, 2)).double()
    flops = float(2 * c * (nzy * nzx).sum())
    return bound(nbytes, flops, F32_FLOPS)


def train_kernel_phase(dev, report):
    """Kernels 6 and 7 (and kernel 1 over live ROIs) at the training
    shapes against their plain versions, f32, seeded inputs."""
    import torch.nn.functional as F

    from siammot_tpu_torch.ops.window_pool import (window_pool,
                                                   window_pool_bwd,
                                                   window_pool_bwd_plain,
                                                   window_pool_plain)
    g = torch.Generator().manual_seed(1)

    # kernel 6: forward, template gradient, search gradient
    n = N_TRAIN
    search = torch.randn(n, 30, 30, C, generator=g).to(dev)
    tmpl = (0.1 * torch.randn(n, 15, 15, C, generator=g)).to(dev)
    up = torch.randn(n, 16, 16, C, generator=g).to(dev)
    s_nchw = search.permute(0, 3, 1, 2).reshape(1, n * C, 30, 30)
    t_w = tmpl.permute(0, 3, 1, 2).reshape(n * C, 1, 15, 15)
    up_nchw = up.permute(0, 3, 1, 2).reshape(1, n * C, 16, 16)
    up_w = up.permute(0, 3, 1, 2).reshape(n * C, 1, 16, 16)
    library = {"forward": lambda: F.conv2d(s_nchw, t_w, groups=n * C),
               "grad_template": lambda: F.conv2d(s_nchw, up_w,
                                                 groups=n * C),
               "grad_search": lambda: F.conv_transpose2d(up_nchw, t_w,
                                                         groups=n * C)}
    inputs = {"forward": (search, tmpl), "grad_template": (search, up),
              "grad_search": (up, tmpl)}
    macs = n * 16 * 16 * 15 * 15 * C        # each pass, taps inside g only
    in_bytes = {"forward": (900 + 225) * C * 4, "grad_template":
                (900 + 256) * C * 4, "grad_search": (256 + 225) * C * 4}
    out_elems = {"forward": 256, "grad_template": 225, "grad_search": 900}
    xc = report["xcorr"]
    xc.update(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
              max_abs_err=0.0, passes={})
    for name, fn, plain in xcorr_passes():
        args = inputs[name]
        k_out = fn(*args)
        p_out = plain(*args)
        torch.cuda.synchronize()
        err, rel = close(k_out, p_out, POOL_ATOL, POOL_RTOL,
                         f"xcorr {name}")
        del k_out, p_out
        ms = timed_ms(lambda: fn(*args))
        pms = timed_ms(lambda: plain(*args), iters=3, warmup=1)
        lms = timed_ms(library[name])
        bms, by = bound(n * (in_bytes[name] + out_elems[name] * C * 4),
                        2.0 * macs, F32_FLOPS)
        log(f"  xcorr {name}: N={n}: kernel {ms:.4f} ms, plain {pms:.4f} "
            f"ms, library {lms:.4f} ms, bound {bms:.4f} ms ({by}), max abs "
            f"err {err:.3g}, max rel err {rel:.3g} (tol {POOL_ATOL} + "
            f"{POOL_RTOL}|x|)")
        xc["passes"][name] = dict(ms=ms, plain_ms=pms, library_ms=lms,
                                  bound_ms=bms, bound_by=by,
                                  max_abs_err=err)
        for key, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                       ("bound_ms", bms)):
            xc[key] += v
        xc["max_abs_err"] = max(xc["max_abs_err"], err)
    xc["bound_by"] = "operations"
    err = check_xcorr_autograd(search, tmpl, up, "xcorr autograd")
    xc["max_abs_err"] = max(xc["max_abs_err"], err)
    log(f"  xcorr autograd Function against autograd through the plain "
        f"version: max abs err {err:.3g}")
    del search, tmpl, up, s_nchw, t_w, up_nchw, up_w, inputs

    # kernel 1 over live ROIs and kernel 7, the three training sites
    table, sites = train_pool_inputs(g, dev)
    shape = tuple(table.shape)
    log(f"  f32 training table {shape}, "
        f"{table.numel() * 4 / 2 ** 20:.1f} MiB")
    pool, bwd = report["window_pool"], report["window_pool_bwd"]
    pool["training_sites"] = {}
    bwd.update(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None,
               max_abs_err=0.0, sites={})
    for site, (origins, wy, wx) in sites.items():
        args = (table, origins, wy, wx, None)
        k_out = window_pool(*args)
        p_out = window_pool_plain(*args)
        torch.cuda.synchronize()
        err, _ = close(k_out, p_out, POOL_ATOL, POOL_RTOL, f"train {site}")
        del k_out, p_out
        ms = timed_ms(lambda: window_pool(*args))
        bms, by = pool_bound(table, origins, wy, wx,
                             torch.ones(len(wy), dtype=torch.bool,
                                        device=dev))
        pool["training_sites"][site] = dict(ms=ms, bound_ms=bms,
                                            bound_by=by, max_abs_err=err)
        pool["max_abs_err"] = max(pool["max_abs_err"], err)

        grad = torch.randn(len(wy), wy.shape[1], wy.shape[1], C,
                           generator=g).to(dev)
        bargs = (grad, origins, wy, wx, shape)
        k_out = window_pool_bwd(*bargs)
        p_out = window_pool_bwd_plain(*bargs)
        torch.cuda.synchronize()
        berr, brel = close(k_out, p_out, POOL_ATOL, POOL_RTOL,
                           f"window_pool_bwd {site}")
        touched = int((p_out != 0).any(-1).sum())
        del k_out, p_out
        bms_k = timed_ms(lambda: window_pool_bwd(*bargs))
        pms = timed_ms(lambda: window_pool_bwd_plain(*bargs), iters=2,
                       warmup=1)
        b_bms, b_by = pool_bwd_bound(shape, grad, wy, wx)
        log(f"  window_pool {site} (training, N={len(wy)}, S="
            f"{wy.shape[1]}, window={wy.shape[2]}): forward {ms:.4f} ms "
            f"(bound {bms:.4f}, {by}, err {err:.3g}); backward kernel "
            f"{bms_k:.4f} ms, plain {pms:.4f} ms, bound {b_bms:.4f} ms "
            f"({b_by}), {touched} table cells touched, max abs err "
            f"{berr:.3g}, max rel err {brel:.3g} (tol {POOL_ATOL} + "
            f"{POOL_RTOL}|x|)")
        bwd["sites"][site] = dict(ms=bms_k, plain_ms=pms, bound_ms=b_bms,
                                  bound_by=b_by, max_abs_err=berr)
        for key, v in (("ms", bms_k), ("plain_ms", pms),
                       ("bound_ms", b_bms)):
            bwd[key] += v
        bwd["max_abs_err"] = max(bwd["max_abs_err"], berr)
        del grad
    bwd["bound_by"] = max(bwd["sites"].values(),
                          key=lambda v: v["bound_ms"])["bound_by"]


def train_phase(dev, report, card):
    """The training path end to end at full width (phase 4)."""
    import itertools

    import siammot_tpu_torch.ops.window_pool as wp_mod
    import siammot_tpu_torch.ops.xcorr as xc_mod
    from siammot_tpu_torch.configs.defaults import get_cfg
    from siammot_tpu_torch.engine.solver import (build_train_step,
                                                 make_optimizer)
    from siammot_tpu_torch.engine.trainer import do_train
    from siammot_tpu_torch.models.siammot import SiamMOT
    from siammot_tpu_torch.ops.window_pool import (window_pool,
                                                   window_pool_bwd,
                                                   window_pool_bwd_plain,
                                                   window_pool_plain)
    from siammot_tpu_torch.utils.synth import train_batches
    from siammot_tpu_torch.utils.weights import jax_to_torch, load_npz

    t0 = time.perf_counter()
    cfg = get_cfg()
    model = SiamMOT(cfg, device=str(dev))
    net = model.build_master(jax_to_torch(load_npz(FIXTURE)))
    optimizer = make_optimizer(cfg, net)
    step = build_train_step(model, optimizer)
    steps = TRAIN_WARMUP + TRAIN_TIMED
    batches = list(itertools.islice(
        train_batches(7, HP, cfg.TPU.MAX_GT), steps))
    log(f"  f32 masters ({sum(p.numel() for p in net.parameters())} "
        f"parameters) and {steps} batches of 2 clips x 2 frames ready in "
        f"{time.perf_counter() - t0:.1f} s")

    # keep what each kernel got at the last step (by reference)
    captured = {"pool": [], "bwd": [], "forward": [], "grad_template": [],
                "grad_search": []}

    def capture(name, fn, keep):
        def wrapped(*args):
            captured[name] = (captured[name] + [args])[-keep:]
            return fn(*args)
        return wrapped

    passes = xcorr_passes()
    patches = [(wp_mod, "window_pool", capture("pool", window_pool, 3)),
               (wp_mod, "window_pool_bwd",
                capture("bwd", window_pool_bwd, 3))]
    patches += [(xc_mod, fn.__name__, capture(name, fn, 1))
                for name, fn, _ in passes]
    originals = [(m, n, getattr(m, n)) for m, n, _ in patches]
    metrics = []
    for m, n, f in patches:
        setattr(m, n, f)
    # these wrappers are patched in their own modules, where each counts
    # with ``<its name>.launches += 1``: while a capture wrapper holds that
    # name, the count lands on the wrapper, so read it there
    counters = {"window_pool": wp_mod.window_pool,
                "window_pool_bwd": wp_mod.window_pool_bwd,
                **{name: getattr(xc_mod, fn.__name__)
                   for name, fn, _ in passes}}
    try:
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        log_ = do_train(model, step, net, optimizer, iter(batches), None,
                        max_iter=steps, checkpoint_period=10 ** 9,
                        log_period=1,
                        tensorboard_writer=lambda it, m: metrics.append(m))
        launches = {n: fn.launches for n, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        for m, n, f in originals:
            setattr(m, n, f)

    if log_.iteration != steps or len(metrics) != steps:
        raise AssertionError(f"ran {log_.iteration} of {steps} steps")
    for i, m in enumerate(metrics):
        if len(m) != 8 or not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"step {i + 1}: losses {m}")
    per_step = {"window_pool": 3, "window_pool_bwd": 3, "forward": 1,
                "grad_template": 1, "grad_search": 1}
    for name, count in launches.items():
        if count != per_step[name] * steps:
            raise AssertionError(f"{name}: {count} launches in {steps} "
                                 f"training steps, expected "
                                 f"{per_step[name] * steps}")
    report["window_pool"]["launches_by_path"]["training"] = \
        launches["window_pool"]
    report["window_pool"]["launches"] += launches["window_pool"]
    report["window_pool_bwd"]["launches"] = launches["window_pool_bwd"]
    report["xcorr"]["launches"] = sum(launches[n] for n, _, _ in passes)
    for name, _, _ in passes:
        report["xcorr"]["passes"][name]["launches"] = launches[name]

    sec = np.array(log_.step_seconds[TRAIN_WARMUP:])
    first, last = metrics[0], metrics[-1]
    log(f"  {steps} SGD steps: {1e3 * sec.mean():.3f} ms/step over the last "
        f"{TRAIN_TIMED} (median {1e3 * np.median(sec):.3f}, first step "
        f"{1e3 * log_.step_seconds[0]:.1f} ms); peak device memory "
        f"{peak / 2 ** 30:.3f} GiB ({card}); launches {launches}")
    log("  losses, step 1 -> " + str(steps) + ": " + ", ".join(
        f"{k} {first[k]:.4f} -> {last[k]:.4f}" for k in sorted(first)))

    # each kernel against its plain version on the last step's inputs
    for site, args in zip(("box_pool", "template_pool", "sr_pool"),
                          captured["pool"]):
        k = window_pool(*args)
        p = window_pool_plain(*args)
        torch.cuda.synchronize()
        err, _ = close(k, p, POOL_ATOL, POOL_RTOL, f"step {site}")
        report["window_pool"]["max_abs_err"] = max(
            report["window_pool"]["max_abs_err"], err)
    for args in captured["bwd"]:
        site = {7: "box", 15: "template", 30: "sr"}[args[2].shape[1]]
        k = window_pool_bwd(*args)
        p = window_pool_bwd_plain(*args)
        torch.cuda.synchronize()
        err, rel = close_scaled(k, p, f"step {site} backward")
        log(f"    step {site} backward: max |plain| "
            f"{float(p.detach().abs().max()):.3g}, max abs err {err:.3g}")
        report["window_pool_bwd"]["max_abs_err"] = max(
            report["window_pool_bwd"]["max_abs_err"], err)
    for name, fn, plain in passes:
        args = captured[name][0]
        k = fn(*args)
        p = plain(*args)
        torch.cuda.synchronize()
        err, rel = close_scaled(k, p, f"step xcorr {name}")
        log(f"    step xcorr {name}: inputs "
            f"{[(tuple(a.shape), str(a.dtype)) for a in args]}, max |plain| "
            f"{float(p.detach().abs().max()):.3g}, max abs err {err:.3g}")
        report["xcorr"]["max_abs_err"] = max(report["xcorr"]["max_abs_err"],
                                             err)
    s_, t_ = captured["forward"][0]
    check_xcorr_autograd(s_, t_, captured["grad_search"][0][0],
                         "step xcorr autograd", scaled=True)
    log(f"  kernels agree with their plain versions on the last step's "
        f"inputs and upstream gradients")
    return 1e3 * float(sec.mean()), 1e3 * float(np.median(sec)), peak


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
    log("[2b] training kernels against their plain versions, training "
        "shapes:")
    train_kernel_phase(dev, report)
    log(f"[2b] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[3] end to end: DLA-34-FPN-EMM, bench weights, 720p crowd:")
    ms_frame, occupied = end_to_end_phase(dev, report)
    log(f"[3] done in {time.perf_counter() - t0:.1f} s")
    report["window_pool"]["launches_by_path"] = {
        "inference": report["window_pool"]["launches"]}

    t0 = time.perf_counter()
    log("[4] training end to end: DLA-34-FPN-EMM, f32 masters, bf16 "
        "compute, 2 clips x 2 frames of the 720p crowd:")
    ms_step, med_step, peak = train_phase(dev, report, card)
    log(f"[4] done in {time.perf_counter() - t0:.1f} s")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("sites", "training_sites", "passes", "launches_by_path")
    kernels = [{k: r[k] for k in keys} | {k: r[k] for k in extra if k in r}
               for r in report.values()]
    log(f"total {time.perf_counter() - t_start:.1f} s; {ms_frame:.3f} "
        f"ms/frame; {occupied} live slots; training {ms_step:.3f} ms/step "
        f"(median {med_step:.3f}), peak {peak / 2 ** 30:.3f} GiB; card "
        f"{card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
