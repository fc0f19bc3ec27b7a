#!/usr/bin/env python3
"""Cold smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as it finishes:
  0. the card (nvidia-smi name and power limit) and the torch/CUDA build;
  1. the build of every CUDA kernel from ``siammot_tpu_torch/ops/cuda``,
     the warpgroup MMA (HGMMA) instructions in the bf16 tower conv's
     (kernels 3 and 8) and deformable conv's machine code (each must have
     some; kernel 8's former FFMA tower and head pass must be gone), and the
     decode's per-cell math as it runs: the FP32-pipe and MUFU (ex2, rcp)
     instructions of one cell_value() in ``decode_cell_probe``'s machine
     code, which the decode's bound counts (beside the earlier 30 flops a
     cell);
  2. each kernel against its plain PyTorch version on the card, at the
     shapes of the 720p main path with 37 of 128 track slots live (the
     occupancy of a crowded scene) and 300 + 37 live box-head ROIs of 428,
     kernel 3 also with all 128 slots live and kernel 6's forward over
     128 slots (the unmasked route's shapes): errors within the stated
     tolerance, dead slots exactly zero, and the kernel's, the plain
     version's and, where one PyTorch call computes the same function,
     that call's time.  Every kernel is timed on the device
     (``device_ms``: a CUDA graph of the calls, replayed between events)
     beside the events around the wrapper calls, which include the
     host's work, and kernels 3, 8 and 9 by launch as well
     (``kernel_split_ms``: torch.profiler's CUDA trace), so the
     predictor's tower conv and head pass stand apart; kernels 3 and 8
     must give the same bits launched twice, and kernel 8 kernel 3's;
  2b. the training kernels the same way at the training shapes (4 frames,
     1024 sampled pairs or ROIs per pool site, f32): the unmasked xcorr
     and its two gradient kernels (also through the autograd Function
     against autograd through the plain version; the three passes also at
     SEARCH_REGION 5's 75x75 x 15x15 -> 61x61, N = 256), and the window
     pool's
     forward over live ROIs and its table gradient at the three sites on
     an f32 table of four 736x1280 frames' FPN levels (the gradient also
     bitwise the same in a second launch);
  3. the main path end to end: the repo's trained DLA-34-FPN-EMM weights
     (``fixtures/bench_weights_f16.npz``) in bf16, 40 frames of a crowded
     720p sprite scene through ``track_frames`` (10 warm-up, 30 timed);
     every kernel's launch count must rise in this phase (the window pool
     three times a frame), tracks must be live, and each kernel must agree
     with its plain version on the inputs it got at the last frame;
  2c. kernels 3 and 4 at the other shapes the JAX kernels take: the
     predictor at the f32 frame's [K, 16, 16, 128] (its FFMA tower conv)
     and the AOT recipe's [K, 29, 29, 128] (bf16 and f32), the decode at
     s_hi 464 (AOT) and 512 (JAX's whole-map limit), on the device;
  2d. kernel 9, the deformable conv, at DLA-102's stage shapes (stride 2
     and 1, offsets in and out of the window, bf16 and f32), with the
     plain version's time, a dense cuDNN 3x3 of the same shape for scale,
     and the bound of a frame's 26 launches;
  3b. the default configuration against the JAX step: four f32 DLA-34
     frames at 320x576 on the card against the rows and track-state
     lanes in ``tests/fixtures/torch_golden_dla34.npz`` (must match, see
     ``siammot_tpu_torch/utils/golden.py``), then the bf16 frames' gap
     (ids that differ, max box and score error, rows matched by IoU) to
     the JAX step's own bf16 rows (``tests/fixtures/
     torch_golden_dla34_bf16.npz``) and to its f32 rows;
  4. the training path end to end: the same weights as f32 masters, bf16
     compute, an f32 pool table, ``do_train`` over batches of two clips x
     two consecutive frames of the crowded scene (``MAX_GT`` 100) for 3
     warm-up + 10 timed SGD steps: every loss finite at every step, per
     step exactly 3 window-pool forward and 3 backward launches and one
     launch of each xcorr kernel (forward, template and search gradient),
     and each kernel in agreement with its plain version on the inputs
     and upstream gradients it got at the last step (the last step's
     three table gradients also bitwise the same launched again, and
     kernel 7 timed on those inputs); ms/step and peak device memory;
  4b. the same at ``MODEL.TRACK_HEAD.SEARCH_REGION`` 5 for 1 + 2 steps, at
     full width and depth (a 75x75 search region: kernel 6's three passes
     at 75 -> 61, the pools at S 75), every loss finite, the same launch
     counts and the same checks on the last step's inputs;
  5. the DCN slice end to end: DLA-102-DCN-FPN (``tools/bench_variants.py``
     widths, deformable stages 3-5) at 736x1280 in bf16 on seeded
     weights (offset convs calibrated so most layers stay in kernel 9's
     window and some leave it; box classifier biased to the foreground so
     tracks start), 6 warm-up + 10 timed frames of the crowded scene:
     26 kernel-9 launches a frame plus kernels 1-4's, live slots, and
     every kernel against its plain version on the last frame's inputs
     (all 26 deformable layers).

  2e. kernels 10, 5 and 8: the unmasked decode at [128, 4, 16, 16] over
     every slot; the striped decode at s_hi 976 (stripe 16) and 736
     (stripe 32), gated with 37 live slots and ungated (on the device),
     and with stripe 64
     forced at s_hi 256 bitwise against kernels 4 and 10; the slot-blocked
     predictor at [128, 16, 16, 128] bf16 and f32 and [128, 61, 61, 128]
     bf16, B = 8, 37 live slots at the front (one mixed group, eleven
     without a live slot), on the device and split into tower conv and
     head pass; and kernels
     1-3 at SEARCH_REGION 5's shapes (the SR pool at 75x75, the masked
     xcorr 75 -> 61, the predictor at 61x61 bf16);
  3c. three cuts of the configuration against the JAX step
     (``tests/fixtures/torch_golden_toggles.npz``): given public
     detections with the MOT17 recipe's overrides (also with
     ``SIAMMOT_PREDICTOR_BLOCK=8``: kernel 8), ``TPU.
     MASKED_TRACK_KERNELS`` False and ``SEARCH_REGION`` 5, each f32 on the
     card within ``utils/golden.py``'s tolerances, then each bf16 gap;
  6. the paths that select the new kernels, end to end on the bench
     weights in bf16, 4 warm-up + 12 timed frames each, every kernel
     checked on the last frame: (6a) the MOT17 public-detection recipe
     read by the port's YAML reader, 1920x1080 sized to 1422x800 content
     (padded 1440x800) with the scene's public detections and
     ``SIAMMOT_PREDICTOR_BLOCK=8`` for the run (kernel 8); (6b)
     ``TPU.MASKED_TRACK_KERNELS`` False at 720p (kernel 6's forward,
     kernel 10); (6c) ``SEARCH_REGION`` 5 at 720p (a 75x75 search region,
     kernel 2 at 75 -> 61, kernel 3 at 61x61, kernel 5 at
     s_hi 976);
  7. dataset inference through ``tools/test_net``'s main function over
     the committed 16-frame 640x384 sequence ``tests/fixtures/
     synmot_mini`` on the bench weights (``utils/dataset_golden.py``):
     (7a) the frames through the port's reader on the card (nvJPEG; the
     machine has no libjpeg) against the sha256 of the JAX package's
     decode, with the largest byte difference to Pillow's libjpeg decode
     where Pillow is there and hashes to the JAX package's; (7b) the
     bench weights saved as a port checkpoint from the card and read back
     bit for bit by ``--model-file``'s loader; (7c) bf16 in
     public-detection and RPN mode: the main path's four kernels'
     launches a frame, each kernel against its plain version on the
     last frame's inputs, a second call that reads the per-video JSON
     cache and runs no frame, the CLEAR-MOT summary beside the JAX
     golden's and the "Speed" in frames per second; (7d) the same two
     modes in f32, held to the JAX golden (``tests/fixtures/
     torch_golden_dataset.json.gz``): on libjpeg's frames per-video JSON,
     tracks and summary within the CPU's tolerances; on nvJPEG's the
     summary's MOTA and IDF1 within ``DECODED_ELSEWHERE_ATOL``, and the
     same runs on the JAX package's bytes (Pillow's decode) within the
     CPU's tolerances;
  8. multi-stream inference: S video streams as lanes of one batched
     frame step (``SiamMOT.forward_streams``) on the bench weights: (8a)
     four 720p crowd scenes (seeds 42-45) for 6 frames, each lane against
     its own ``forward_inference`` run, in f32 within ``utils/golden.py``'s
     tolerances with ids, masks and integer state lanes exact, and in
     bf16 with the gap printed; kernels 1-4 against their plain versions
     on the last bf16 step's 4 x 128-slot inputs; (8b) the bf16 step at
     S = 1, 2, 4, 8 and 16 after 3 warm-up steps: aggregate frames per
     second, ms per step, live slots and peak memory over 8 timed steps,
     each kernel's launches a step (the same at every S), and at S = 1
     and 8 the host synchronisations of one step
     (``torch.cuda.set_sync_debug_mode``), which may differ only by NMS
     convergence rounds past the first 16; (8c) ``tools/test_net
     --n-streams 2`` over ``tests/fixtures/synmot_multi`` (videos of 10, 7
     and 4 frames) in f32 in both modes, on the JAX package's bytes held
     to ``tests/fixtures/torch_golden_multistream.json.gz`` within the
     CPU's tolerances, and on nvJPEG's frames (one reader a stream) with
     MOTA and IDF1 within ``DECODED_ELSEWHERE_ATOL``.  Every batched run's
     launches count under the ``multistream`` path;
  9. training through ``tools/train_net``'s main function: (9a) the
     SYNMOT_HARD recipe (DLA-34 at full width, 2 clips a batch, 384x640
     static input, bf16 compute, f32 masters) over the committed training
     fixture (``tests/fixtures/synmot_multi`` as a train split and four
     crowded stills, ``tests/fixtures/syncrowd_mini``) from the bench
     weights, 12 iterations with checkpoints every 6: the losses in the
     run's event file (read by the port's own reader) finite, per step
     exactly 3 window-pool forward and backward launches and one of each
     xcorr pass, the checkpoints there, s/it, the loader wait a step and
     peak memory, each kernel against its plain version on the last
     step's inputs; (9b) the checkpoints past 6 deleted, a second call
     resumes at 6: its loader batches 7-12 hash (sha256) to 9a's, the
     losses printed beside 9a's; (9c) the loader alone at
     ``configs/dla/DLA_34_FPN_EMM.yaml``'s batch (16 clips, short side
     640-960, 8 workers) on nvJPEG's route: clips per second and ms a
     batch over 20 batches after 3, and nvJPEG's JPEG round trip against
     libjpeg's (``tests/fixtures/jpeg_roundtrip.npz``).  Both calls'
     launches count under the ``train_net`` path.

Each end-to-end phase sets every kernel's launch count to 0 just before
it drives its path and reads the counts just after.

It prints a JSON line of per-kernel numbers, then, last,
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
so does a machine without a CUDA device, or a directory without the port.
"""

import contextlib
import hashlib
import json
import os
import subprocess
import sys
import tempfile
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
WIDE_WARMUP, WIDE_TIMED = 1, 2    # training steps at SEARCH_REGION 5
N_TRAIN = 1024                    # 4 frames x 256 samples per pool site
TRAIN_HW = [(184, 320), (92, 160), (46, 80), (23, 40)]
DCN_WARMUP, DCN_TIMED = 6, 10

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
#  pool backward: the same (its sums run in ROI order, the plain
#    version's autograd in its own); on a real step's gradients, whose
#    scale is set by the loss, the absolute part is 1e-4 of the largest
#    plain value
PRED_ATOL = 3e-2
#  predictor in f32: sums in another order -> |d| <= 1e-4
PRED_F32_ATOL = 1e-4
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


def device_ms(fn, iters=20, warmup=3):
    """Device time of one call: ``iters`` calls captured in one CUDA graph
    and replayed between two CUDA events, so the host's work per call
    (shape checks, ctypes, allocation) is left out.  ``timed_ms`` keeps
    it in: once a kernel takes less device time than the wrapper's host
    work, the events there read the enqueue rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def kernel_split_ms(fn, iters=10):
    """Device time of one call by kernel name (torch.profiler's CUDA
    trace; template arguments and signature dropped)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.replace("(anonymous namespace)::", "")
        name = name.split("(")[0].split("<")[0].split()[-1].split("::")[-1]
        out[name] = out.get(name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3 / iters
    return out


def kernel_times(fn, iters=20):
    """(device ms by graph replay, host-inclusive ms by events around
    the wrapper calls, {kernel: device ms} by the profiler)."""
    return device_ms(fn, iters), timed_ms(fn, iters), kernel_split_ms(fn)


def split_text(split):
    return ", ".join(f"{k} {v:.4f}" for k, v in split.items())


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
    """Kernel 2 against its plain version; dead slots zero, live ones
    bitwise kernel 6's output on the same inputs."""
    from siammot_tpu_torch.ops.xcorr import (xcorr_depthwise,
                                             xcorr_depthwise_masked,
                                             xcorr_depthwise_plain)
    k = xcorr_depthwise_masked(*args)
    p = xcorr_depthwise_plain(*args)
    torch.cuda.synchronize()
    dead_zero(k, args[2], what)
    live = args[2]
    if not torch.equal(k[live], xcorr_depthwise(*args[:2])[live]):
        raise AssertionError(f"{what}: live slots differ from kernel 6's")
    return close(k, p, POOL_ATOL, POOL_RTOL, what)


def same_bits(a, b, what):
    """Two launches' outputs (tuples of tensors) must be bitwise equal."""
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{what}: two launches differ")


def check_predictor(args, what):
    """Kernel 3 against its plain version (tolerance by dtype), dead slots
    zero, a second launch bitwise the first."""
    from siammot_tpu_torch.ops.predictor import (emm_predictor,
                                                 emm_predictor_plain)
    ks = emm_predictor(*args)
    ps = emm_predictor_plain(*args)
    torch.cuda.synchronize()
    tol = PRED_ATOL if args[0].dtype == torch.bfloat16 else PRED_F32_ATOL
    errs = []
    for name, k, p in zip(("cls", "ctr", "reg"), ks, ps):
        dead_zero(k, args[1], f"{what} {name}")
        errs.append(close(k, p, tol, 0.0, f"{what} {name}"))
    same_bits(ks, emm_predictor(*args), what)
    return max(e[0] for e in errs), max(e[1] for e in errs)


def check_decode(args, what):
    """Kernel 4 against its plain version (:func:`compare_decode`);
    returns (max abs score err, max rel score err)."""
    from siammot_tpu_torch.ops.decode import emm_decode, emm_decode_plain
    got, want = emm_decode(*args), emm_decode_plain(*args)
    err = compare_decode(got, want, args, what)
    same = got[0] == want[0]
    rel = ((got[1] - want[1]).abs()[same]
           / want[1][same].abs().clamp(min=1e-6)).max() if same.any() \
        else torch.zeros(())
    return err, float(rel)


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


def predictor_params(g, dev, dtype=torch.bfloat16):
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
        out[name] = t.to(dev, dtype).contiguous()
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


def predictor_bound(x, params, live):
    """Kernels 3 and 8: (bound ms, by, two-pass floor ms).  The bound
    counts the live slots' towers and heads (2 flops a multiply-add, at
    the dtype's peak) and the bytes of the inputs (live responses, the
    weights) and the outputs.  The floor is the design's own: the f32
    scratch of both towers written once and read once."""
    k, s_ = x.shape[:2]
    c, isz = x.shape[-1], x.element_size()
    flops = live * (2 * s_ * s_ * c * c * 9 + s_ * s_ * 7 * c * 9) * 2.0
    nbytes = (live * s_ * s_ * c * isz
              + sum(p_.numel() * isz for p_ in params.values())
              + k * s_ * s_ * 7 * 4 + k)
    ms, by = bound(nbytes, flops, BF16_TC_FLOPS
                   if x.dtype == torch.bfloat16 else F32_FLOPS)
    return ms, by, 2 * 2 * live * s_ * s_ * c * 4 / HBM_BYTES_S * 1e3


# the decode's cell math as it runs: cell_value()'s instructions on the
# FP32 pipe and the special-function unit (MUFU: ex2, rcp), counted from
# the built library's machine code by phase 1 (cell_instructions)
CELL = {}
FP32_PIPE = ("FFMA", "FADD", "FMUL", "FMNMX", "FSEL", "FSETP", "FSET",
             "FCHK")
# MUFU results a clock per SM on Hopper: 16, an eighth of the 128 FP32
# lanes (CUDA C++ Programming Guide, arithmetic instruction throughput,
# compute capability 9.0); an FP32 instruction is one lane's FFMA, 2 flops
FP32_INSTR_S = F32_FLOPS / 2
MUFU_S = FP32_INSTR_S / 8


def cell_instructions(cuda_lib):
    """{"fp32": n, "mufu": n, "all": n, "ops": {...}}: the instructions of
    one cell_value() in ``decode_cell_probe`` (the main path's
    centerness), from ``cuobjdump -sass`` of the built library, along the
    path the kernel takes for finite inputs (up to the first EXIT: the
    IEEE division's slow paths it branches around are not counted; the
    probe's own loads, stores and index math are not FP32 or MUFU)."""
    nvcc = cuda_lib._nvcc()
    out = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"),
                          "-sass", cuda_lib.library()._name],
                         capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {out.stderr}")
    ops, inside = [], False
    for line in out.stdout.splitlines():
        if "Function :" in line:
            inside = "decode_cell_probe" in line
            continue
        code = line.split("*/", 1)[-1].split(";")[0].split()
        if not inside or "/*" not in line or not code:
            continue
        op = code[1] if code[0].startswith("@") else code[0]
        ops.append(op)
        if op == "EXIT":
            break
    if "EXIT" not in ops:
        raise AssertionError("decode_cell_probe: no machine code found")
    fp32 = sum(op.split(".")[0] in FP32_PIPE for op in ops)
    mufu = sum(op.startswith("MUFU") for op in ops)
    if fp32 == 0 or mufu == 0:
        raise AssertionError(f"decode_cell_probe: {fp32} FP32 and {mufu} "
                             f"MUFU instructions")
    hist = {}
    for op in ops:
        hist[op] = hist.get(op, 0) + 1
    return {"fp32": fp32, "mufu": mufu, "all": len(ops), "ops": hist}


def decode_bound(x4, u, window, n_decoded):
    """Operations: the decoded slots' upsample multiply-adds (FP32 pipe)
    and, per cell, cell_value()'s FP32 and MUFU instructions as counted
    from the machine code (``CELL``), each pipe at its own rate; bytes:
    their inputs, the constants, the outputs.  Returns (ms, by, the
    earlier figure in ms: 2 flops a multiply-add and 30 a cell)."""
    k, _, s_, _ = x4.shape
    sh = u.shape[0]
    fma = n_decoded * (4 * sh * s_ * s_ + 4 * sh * sh * s_)
    cells = n_decoded * sh * sh
    nbytes = (n_decoded * 4 * s_ * s_ * 4 + u.numel() * 4
              + window.numel() * 4 + k * 17)
    t_fp32 = (fma + cells * CELL["fp32"]) / FP32_INSTR_S
    t_mufu = cells * CELL["mufu"] / MUFU_S
    ms, by = bound(nbytes, max(t_fp32, t_mufu) * F32_FLOPS, F32_FLOPS)
    return ms, by, bound(nbytes, 2.0 * fma + 30.0 * cells, F32_FLOPS)[0]


# -- phases ------------------------------------------------------------------

WGMMA_KERNELS = ("tower_conv_wgmma", "deform_wgmma")
# kernel 8's FFMA tower and the per-slot head pass, replaced by kernel 3's
# kernels and heads_band
GONE_KERNELS = ("tower_conv_blocked", "heads_tiled")


def wgmma_instructions(cuda_lib):
    """HGMMA instructions in each bf16 kernel's machine code (cuobjdump
    -sass of the built library; ``tower_conv_wgmma`` runs the bf16 towers
    of kernels 3 and 8); raises if one has none, or if a kernel of
    ``GONE_KERNELS`` is still built."""
    nvcc = cuda_lib._nvcc()
    out = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"),
                          "-sass", cuda_lib.library()._name],
                         capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {out.stderr}")
    counts, name = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            gone = [k for k in GONE_KERNELS if k in line]
            if gone:
                raise AssertionError(f"{gone} is still in the library")
            name = next((k for k in WGMMA_KERNELS if k in line), None)
        elif name and "HGMMA" in line:
            counts[name] = counts.get(name, 0) + 1
    missing = [k for k in WGMMA_KERNELS if not counts.get(k)]
    if missing:
        raise AssertionError(f"no HGMMA in the machine code of {missing}")
    return counts


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
    "deform_conv": dict(source="siammot_tpu_torch/ops/cuda/deform.cu",
                        replaces="siammot_tpu/ops/pallas/deform.py:102"),
    "emm_decode_striped": dict(source="siammot_tpu_torch/ops/cuda/decode.cu",
                               replaces="siammot_tpu/ops/pallas/decode.py:78"),
    "emm_predictor_blocked": dict(
        source="siammot_tpu_torch/ops/cuda/predictor.cu",
        replaces="siammot_tpu/ops/pallas/predictor.py:239"),
    "emm_decode_unmasked": dict(
        source="siammot_tpu_torch/ops/cuda/decode.cu",
        replaces="siammot_tpu/ops/pallas/decode.py:236"),
}
# launches a frame of each inference path (kernels not listed: none)
MAIN_PATH = {"window_pool": 3, "xcorr_masked": 1, "emm_predictor": 1,
             "emm_decode": 1}


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
    pool.update(ms=0.0, host_ms=0.0, plain_ms=0.0, bound_ms=0.0,
                library_ms=None, max_abs_err=0.0, sites={})
    for site, (origins, wy, wx, valid) in sites.items():
        args = (table, origins, wy, wx, valid)
        err, rel = check_pool(args, site)
        ms, hms = device_ms(lambda: window_pool(*args)), \
            timed_ms(lambda: window_pool(*args))
        pms = timed_ms(lambda: window_pool_plain(*args), iters=3, warmup=1)
        bms, by = pool_bound(*args)
        log(f"  window_pool {site}: N={wy.shape[0]} live={int(valid.sum())} "
            f"S={wy.shape[1]} window={wy.shape[2]}: "
            f"{window_pool.launches} launches so far, kernel {ms:.4f} ms "
            f"device ({hms:.4f} ms with the host's enqueue), plain "
            f"{pms:.4f} ms, bound {bms:.4f} ms ({by}), max abs err "
            f"{err:.3g}, max rel err {rel:.3g} (tol {POOL_ATOL} + "
            f"{POOL_RTOL}|x|)")
        pool["sites"][site] = dict(ms=ms, host_ms=hms, plain_ms=pms,
                                   bound_ms=bms, bound_by=by,
                                   max_abs_err=err)
        pool["ms"] += ms
        pool["host_ms"] += hms
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
    ms = device_ms(lambda: xcorr_depthwise_masked(*args))
    hms = timed_ms(lambda: xcorr_depthwise_masked(*args))
    pms = timed_ms(lambda: xcorr_depthwise_plain(*args), iters=5)
    # the reference's own form: one groups=K*C convolution over all slots
    s_nchw = search.permute(0, 3, 1, 2).reshape(1, K * C, 30, 30)
    t_nchw = tmpl.permute(0, 3, 1, 2).reshape(K * C, 1, 15, 15)
    lms = timed_ms(lambda: F.conv2d(s_nchw, t_nchw, groups=K * C))
    live = int(valid.sum())
    nbytes = live * (30 * 30 + 15 * 15) * C * 2 + K * 16 * 16 * C * 4 + K
    bms, by = bound(nbytes, live * 16 * 16 * 15 * 15 * C * 2.0, F32_FLOPS)
    log(f"  xcorr_masked: K={K} live={live}: "
        f"{xcorr_depthwise_masked.launches} launches, kernel {ms:.4f} ms "
        f"device ({hms:.4f} ms with the host's enqueue), plain "
        f"{pms:.4f} ms, conv2d(groups) {lms:.4f} ms, bound {bms:.4f} ms "
        f"({by}), max abs err {err:.3g}, max rel err {rel:.3g} (tol "
        f"{POOL_ATOL} + {POOL_RTOL}|x|; live slots bitwise kernel 6's)")
    report["xcorr_masked"].update(ms=ms, host_ms=hms, plain_ms=pms,
                                  library_ms=lms, bound_ms=bms, bound_by=by,
                                  max_abs_err=err)

    # kernel 3, 37 live slots and (the unmasked route's shape) all 128
    x = torch.randn(K, 16, 16, C, generator=g).to(dev, torch.bfloat16)
    params = predictor_params(g, dev)
    row = report["emm_predictor"]
    row.setdefault("shapes", {})
    for live, valid in ((LIVE, live_mask(K, LIVE, g, dev)),
                        (K, torch.ones(K, dtype=torch.bool, device=dev))):
        args = (x, valid, params)
        err, rel = check_predictor(args, f"emm_predictor {live} live")
        ms, hms, split = kernel_times(lambda: emm_predictor(*args))
        pms = timed_ms(lambda: emm_predictor_plain(*args), iters=5)
        bms, by, floor = predictor_bound(x, params, live)
        log(f"  emm_predictor [{K}, 16, 16, {C}] bf16, {live} live: "
            f"{emm_predictor.launches} launches, kernel {ms:.4f} ms device "
            f"(graph replay; {hms:.4f} ms with the host's enqueue; by "
            f"kernel: {split_text(split)}), plain {pms:.4f} ms, bound "
            f"{bms:.4f} ms ({by}; the scratch's two passes {floor:.4f}), "
            f"max abs err {err:.3g}, max rel err {rel:.3g} (tol "
            f"{PRED_ATOL}; a second launch bitwise the first)")
        entry = dict(ms=ms, host_ms=hms, kernels=split, plain_ms=pms,
                     bound_ms=bms, bound_by=by, max_abs_err=err)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if live == LIVE:
            row.update(entry, library_ms=None)
        else:
            row["shapes"][f"16x16x{C} bfloat16, all {K} live (6b)"] = entry

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
    ms, hms, split = kernel_times(lambda: emm_decode(*args))
    pms = timed_ms(lambda: emm_decode_plain(*args), iters=5)
    live = int(valid.sum())
    bms, by, old = decode_bound(x4, u, window, live)
    log(f"  emm_decode: K={K} live={live}: {emm_decode.launches} launches, "
        f"kernel {ms:.4f} ms device ({hms:.4f} ms with the host's "
        f"enqueue; by kernel: {split_text(split)}), plain "
        f"{pms:.4f} ms, bound {bms:.4f} ms ({by}; {old:.4f} at 30 flops a "
        f"cell), max abs score err "
        f"{err:.3g}, max rel err {rel:.3g} (idx exact or p_conf tie within "
        f"{DECODE_TIE}; score tol {DECODE_SCORE_ATOL})")
    report["emm_decode"].update(ms=ms, host_ms=hms, kernels=split,
                                plain_ms=pms, library_ms=None, bound_ms=bms,
                                bound_by=by, max_abs_err=err)

    # kernel 6's forward at the unmasked route's shape (phase 6b)
    from siammot_tpu_torch.ops.xcorr import xcorr_depthwise
    search = torch.randn(K, 30, 30, C, generator=g).to(dev, torch.bfloat16)
    tmpl = (0.1 * torch.randn(K, 15, 15, C, generator=g)).to(
        dev, torch.bfloat16)
    err, _ = close(xcorr_depthwise(search, tmpl),
                   xcorr_depthwise_plain(search, tmpl), POOL_ATOL,
                   POOL_RTOL, "xcorr forward, 128 slots")
    ms, hms, _ = kernel_times(lambda: xcorr_depthwise(search, tmpl))
    pms = timed_ms(lambda: xcorr_depthwise_plain(search, tmpl), iters=5)
    s_nchw = search.permute(0, 3, 1, 2).reshape(1, K * C, 30, 30)
    t_nchw = tmpl.permute(0, 3, 1, 2).reshape(K * C, 1, 15, 15)
    lms = timed_ms(lambda: F.conv2d(s_nchw, t_nchw, groups=K * C))
    nbytes = K * (30 * 30 + 15 * 15) * C * 2 + K * 16 * 16 * C * 4
    bms, by = bound(nbytes, K * 16 * 16 * 15 * 15 * C * 2.0, F32_FLOPS)
    report["xcorr"].setdefault("shapes", {})[
        f"forward [{K}, 30, 30, {C}] x [{K}, 15, 15, {C}] bf16 (6b)"] = dict(
            ms=ms, host_ms=hms, plain_ms=pms, library_ms=lms, bound_ms=bms,
            bound_by=by, max_abs_err=err)
    log(f"  xcorr (kernel 6) forward, all {K} slots, bf16: kernel {ms:.4f} "
        f"ms device ({hms:.4f} ms with the host's enqueue), plain {pms:.4f} "
        f"ms, conv2d(groups) {lms:.4f} ms, bound {bms:.4f} ms ({by}), max "
        f"abs err {err:.3g}")


def _wrappers():
    """Every inference kernel's wrapper, by report name."""
    from siammot_tpu_torch.ops.decode import (emm_decode, emm_decode_striped,
                                              emm_decode_unmasked)
    from siammot_tpu_torch.ops.deform_conv import deform_conv2d
    from siammot_tpu_torch.ops.predictor import (emm_predictor,
                                                 emm_predictor_blocked)
    from siammot_tpu_torch.ops.window_pool import window_pool
    from siammot_tpu_torch.ops.xcorr import (xcorr_depthwise,
                                             xcorr_depthwise_masked)
    return {"window_pool": window_pool,
            "xcorr_masked": xcorr_depthwise_masked, "xcorr": xcorr_depthwise,
            "emm_predictor": emm_predictor,
            "emm_predictor_blocked": emm_predictor_blocked,
            "emm_decode": emm_decode,
            "emm_decode_unmasked": emm_decode_unmasked,
            "emm_decode_striped": emm_decode_striped,
            "deform_conv": deform_conv2d}


@contextlib.contextmanager
def kernel_capture():
    """Every kernel's count set to 0 on entry and read on exit into the
    yielded ``(captured, launches)``; meanwhile the inputs each stage got
    at the last frame are kept (by reference: no copies inside a timed
    loop): the pools, the xcorr (masked or unmasked), the predictor
    (per-slot or blocked), the decode's dispatch and the deformable
    convs."""
    import siammot_tpu_torch.models.dla as dla_mod
    import siammot_tpu_torch.models.emm as emm_mod
    import siammot_tpu_torch.ops.roi_align_windowed as rw_mod

    captured, launches = {}, {}

    def capture(name, fn, keep):
        def wrapped(*args):
            captured[name] = (captured.get(name, []) + [args])[-keep:]
            return fn(*args)
        return wrapped

    # each patched name is a module's import of a wrapper defined
    # elsewhere, so the wrapper's own count is untouched
    patches = [(rw_mod, "window_pool", "window_pool", 3),
               (emm_mod, "xcorr_depthwise_masked", "xcorr_masked", 1),
               (emm_mod, "xcorr_depthwise_auto", "xcorr", 1),
               (emm_mod, "emm_predictor", "emm_predictor", 1),
               (emm_mod, "emm_predictor_blocked", "emm_predictor_blocked", 1),
               (emm_mod, "decode_argmax", "decode", 1),
               (dla_mod, "deform_conv2d", "deform_conv", 26)]
    originals = [(m, n, getattr(m, n)) for m, n, _, _ in patches]
    for m, n, name, keep in patches:
        setattr(m, n, capture(name, getattr(m, n), keep))
    counters = _wrappers()
    try:
        for fn in counters.values():
            fn.launches = 0
        yield captured, launches
        launches.update({n: fn.launches for n, fn in counters.items()})
    finally:
        for m, n, f in originals:
            setattr(m, n, f)


def check_launches(launches, per_frame, n):
    """Each kernel's count must equal ``per_frame`` of it times the ``n``
    frames (0 if not listed); returns the kernels launched."""
    for name, count in launches.items():
        if count != per_frame.get(name, 0) * n:
            raise AssertionError(f"{name}: {count} launches over {n} frames, "
                                 f"expected {per_frame.get(name, 0) * n}")
    return {k: v for k, v in launches.items() if v}


def drive_frames(model, params, stream, image_size, per_frame, **track_kw):
    """``track_frames`` over ``stream`` inside :func:`kernel_capture`; each
    kernel's count must equal ``per_frame`` of it times the frames."""
    from siammot_tpu_torch.engine.inferencer import track_frames
    with kernel_capture() as (captured, launches):
        result = track_frames(model, params, stream, image_size, **track_kw)
    return result, check_launches(launches, per_frame, len(stream)), captured


def check_last_frame(result, k_slots):
    """Live tracks, finite rows, scores in [0, 1], unique ids."""
    state = result.state
    occupied = int(state.occupied.sum())
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
    return occupied, int(state.active.sum())


def check_decode_any(args, what):
    """The decode kernel the dispatch chose for ``args`` (those of
    ``decode_argmax``) against its plain version: returns (report name,
    max abs score err)."""
    from siammot_tpu_torch.ops.decode import (STRIPED_MAX, WHOLE_MAP_MAX,
                                              emm_decode, emm_decode_plain,
                                              emm_decode_striped,
                                              emm_decode_striped_plain,
                                              emm_decode_unmasked,
                                              pick_stripe)
    x4, wh, u, window, valid, sigma, use_c = args[:7]
    s_hi = u.shape[0]
    if s_hi > WHOLE_MAP_MAX:
        assert s_hi <= STRIPED_MAX
        st = pick_stripe(s_hi)
        name = "emm_decode_striped"
        kernel = lambda: emm_decode_striped(*args[:7], st)  # noqa: E731
        plain = lambda: emm_decode_striped_plain(*args[:7], st)  # noqa
    elif valid is None:
        name = "emm_decode_unmasked"
        kernel = lambda: emm_decode_unmasked(x4, wh, u, window, sigma,  # noqa
                                             use_c)
        plain = lambda: emm_decode_plain(*args[:7])  # noqa: E731
    else:
        name = "emm_decode"
        kernel = lambda: emm_decode(*args[:7])  # noqa: E731
        plain = lambda: emm_decode_plain(*args[:7])  # noqa: E731
    err = compare_decode(kernel(), plain(), args[:7], what)
    return name, err


def compare_decode(got, want, args, what):
    """Decode agreement: idx exact unless the two cells' p_conf lie within
    DECODE_TIE (the upsample's sums in another order), score to
    DECODE_SCORE_ATOL; gated dead slots (0, 0).  Returns the max abs score
    error."""
    from siammot_tpu_torch.ops.decode import penalized_confidence
    (ki, ks), (pi, ps) = got, want
    x4, wh, u, window, valid, sigma, use_c = args
    torch.cuda.synchronize()
    if valid is not None and ((ki[~valid] != 0).any()
                              or (ks[~valid] != 0).any()):
        raise AssertionError(f"{what}: dead slots are not (0, 0)")
    diff = ki != pi
    if diff.any():
        rows = diff.nonzero()[:, 0]
        p_conf, _ = penalized_confidence(x4[rows], wh[rows], u, window,
                                         sigma, use_c)
        flat = p_conf.reshape(len(rows), -1)
        r = torch.arange(len(rows), device=flat.device)
        gap = (flat[r, ki[rows].long()] - flat[r, pi[rows].long()]).abs()
        if (gap > DECODE_TIE).any():
            raise AssertionError(f"{what}: argmax differs beyond a tie "
                                 f"({float(gap.max()):.3g})")
    same = ~diff
    err = (ks[same] - ps[same]).abs()
    if (err > DECODE_SCORE_ATOL).any() or not torch.isfinite(ks).all():
        raise AssertionError(f"{what}: score off by {float(err.max()):.3g}")
    n = int(valid.sum()) if valid is not None else len(ki)
    log(f"    {what}: {int(diff.sum())} tie-swapped argmax of {n} decoded")
    return float(err.max()) if same.any() else 0.0


def check_blocked(args, what):
    """Kernel 8 against its plain version, dead slots zero, a second
    launch bitwise the first and kernel 3's bits on the same inputs (it
    launches kernel 3's kernels); returns the max abs err."""
    from siammot_tpu_torch.ops.predictor import (emm_predictor,
                                                 emm_predictor_blocked,
                                                 emm_predictor_blocked_plain)
    ks = emm_predictor_blocked(*args)
    ps = emm_predictor_blocked_plain(*args)
    torch.cuda.synchronize()
    tol = PRED_ATOL if args[0].dtype == torch.bfloat16 else PRED_F32_ATOL
    errs = []
    for name, k, p in zip(("cls", "ctr", "reg"), ks, ps):
        dead_zero(k, args[1], f"{what} {name}")
        errs.append(close(k, p, tol, 0.0, f"{what} {name}")[0])
    same_bits(ks, emm_predictor_blocked(*args), what)
    same_bits(ks, emm_predictor(*args[:3]), f"{what} against kernel 3")
    return max(errs)


def check_captured(captured, report, what):
    """Each kernel against its plain version on the last frame's inputs
    (the stages the path ran)."""
    from siammot_tpu_torch.ops.xcorr import (xcorr_depthwise,
                                             xcorr_depthwise_plain)

    def note(name, err):
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"] or 0.0,
                                          err)

    for site, args in zip(("sr_pool", "box_pool", "template_pool"),
                          captured["window_pool"]):
        note("window_pool", check_pool(args, f"{what} {site}")[0])
    if "xcorr_masked" in captured:
        note("xcorr_masked",
             check_xcorr(captured["xcorr_masked"][0], f"{what} xcorr")[0])
    if "xcorr" in captured:
        s_, t_ = captured["xcorr"][0]
        k_, p_ = xcorr_depthwise(s_, t_), xcorr_depthwise_plain(s_, t_)
        torch.cuda.synchronize()
        note("xcorr", close(k_, p_, POOL_ATOL, POOL_RTOL,
                            f"{what} unmasked xcorr")[0])
    if "emm_predictor" in captured:
        note("emm_predictor", check_predictor(captured["emm_predictor"][0],
                                              f"{what} emm_predictor")[0])
    if "emm_predictor_blocked" in captured:
        note("emm_predictor_blocked",
             check_blocked(captured["emm_predictor_blocked"][0],
                           f"{what} emm_predictor_blocked"))
    name, err = check_decode_any(captured["decode"][0], f"{what} decode")
    note(name, err)


def end_to_end_phase(dev, report):
    from siammot_tpu_torch.configs.defaults import get_cfg
    from siammot_tpu_torch.models.siammot import SiamMOT
    from siammot_tpu_torch.utils.synth import render_scene
    from siammot_tpu_torch.utils.weights import jax_to_torch, load_npz

    t0 = time.perf_counter()
    params = jax_to_torch(load_npz(FIXTURE))
    frames = render_scene(16, HP)[0]
    log(f"  weights ({len(params)} tensors) and 16 frames ready in "
        f"{time.perf_counter() - t0:.1f} s")
    model = SiamMOT(get_cfg(), device=str(dev))
    stream = [frames[i % len(frames)] for i in range(WARMUP + TIMED)]
    result, launches, captured = drive_frames(model, params, stream, (W, H),
                                              MAIN_PATH)
    for name in MAIN_PATH:
        report[name]["launches"] = launches[name]
        report[name]["launches_by_path"] = {"inference": launches[name]}
    sec = np.array(result.frame_seconds[WARMUP:])
    occupied, active = check_last_frame(result, K)
    log(f"  {len(stream)} frames: {1e3 * sec.mean():.3f} ms/frame over the "
        f"last {TIMED} (median {1e3 * np.median(sec):.3f}, first frame "
        f"{1e3 * result.frame_seconds[0]:.1f} ms); live slots {occupied} of "
        f"{K} ({active} active); launches {launches}")
    check_captured(captured, report, "main-path")
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

    from siammot_tpu_torch.ops.window_pool import (tile_counts,
                                                   touched_rects,
                                                   window_pool,
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
    xc.update(ms=0.0, host_ms=0.0, plain_ms=0.0, bound_ms=0.0,
              library_ms=0.0, max_abs_err=0.0, passes={})
    for name, fn, plain in xcorr_passes():
        args = inputs[name]
        k_out = fn(*args)
        p_out = plain(*args)
        torch.cuda.synchronize()
        err, rel = close(k_out, p_out, POOL_ATOL, POOL_RTOL,
                         f"xcorr {name}")
        del k_out, p_out
        ms = device_ms(lambda: fn(*args), iters=10)
        hms = timed_ms(lambda: fn(*args))
        pms = timed_ms(lambda: plain(*args), iters=3, warmup=1)
        lms = timed_ms(library[name])
        bms, by = bound(n * (in_bytes[name] + out_elems[name] * C * 4),
                        2.0 * macs, F32_FLOPS)
        log(f"  xcorr {name}: N={n}: kernel {ms:.4f} ms device ({hms:.4f} "
            f"ms with the host's enqueue), plain {pms:.4f} ms, library "
            f"{lms:.4f} ms, bound {bms:.4f} ms ({by}), max abs err "
            f"{err:.3g}, max rel err {rel:.3g} (tol {POOL_ATOL} + "
            f"{POOL_RTOL}|x|)")
        xc["passes"][name] = dict(ms=ms, host_ms=hms, plain_ms=pms,
                                  library_ms=lms, bound_ms=bms, bound_by=by,
                                  max_abs_err=err)
        for key, v in (("ms", ms), ("host_ms", hms), ("plain_ms", pms),
                       ("library_ms", lms), ("bound_ms", bms)):
            xc[key] += v
        xc["max_abs_err"] = max(xc["max_abs_err"], err)
    xc["bound_by"] = "operations"
    err = check_xcorr_autograd(search, tmpl, up, "xcorr autograd")
    xc["max_abs_err"] = max(xc["max_abs_err"], err)
    log(f"  xcorr autograd Function against autograd through the plain "
        f"version: max abs err {err:.3g}")
    del search, tmpl, up, s_nchw, t_w, up_nchw, up_w, inputs
    wide_sr_xcorr_passes(dev, report, g)

    # kernel 1 over live ROIs and kernel 7, the three training sites
    table, sites = train_pool_inputs(g, dev)
    shape = tuple(table.shape)
    log(f"  f32 training table {shape}, "
        f"{table.numel() * 4 / 2 ** 20:.1f} MiB")
    pool, bwd = report["window_pool"], report["window_pool_bwd"]
    pool["training_sites"] = {}
    bwd.update(ms=0.0, host_ms=0.0, plain_ms=0.0, bound_ms=0.0,
               library_ms=None, max_abs_err=0.0, sites={})
    for site, (origins, wy, wx) in sites.items():
        args = (table, origins, wy, wx, None)
        k_out = window_pool(*args)
        p_out = window_pool_plain(*args)
        torch.cuda.synchronize()
        err, _ = close(k_out, p_out, POOL_ATOL, POOL_RTOL, f"train {site}")
        del k_out, p_out
        ms = device_ms(lambda: window_pool(*args), iters=10)
        hms = timed_ms(lambda: window_pool(*args))
        bms, by = pool_bound(table, origins, wy, wx,
                             torch.ones(len(wy), dtype=torch.bool,
                                        device=dev))
        pool["training_sites"][site] = dict(ms=ms, host_ms=hms, bound_ms=bms,
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
        if not torch.equal(k_out, window_pool_bwd(*bargs)):
            raise AssertionError(f"window_pool_bwd {site}: a second launch "
                                 "gave other bits")
        touched = int((p_out != 0).any(-1).sum())
        per_tile = tile_counts(touched_rects(origins, wy, wx, shape), shape)
        del k_out, p_out
        bms_k = device_ms(lambda: window_pool_bwd(*bargs), iters=10)
        bhms = timed_ms(lambda: window_pool_bwd(*bargs))
        pms = timed_ms(lambda: window_pool_bwd_plain(*bargs), iters=2,
                       warmup=1)
        b_bms, b_by = pool_bwd_bound(shape, grad, wy, wx)
        log(f"  window_pool {site} (training, N={len(wy)}, S="
            f"{wy.shape[1]}, window={wy.shape[2]}): forward {ms:.4f} ms "
            f"device ({hms:.4f} with the host's enqueue; bound {bms:.4f}, "
            f"{by}, err {err:.3g}); backward kernel "
            f"{bms_k:.4f} ms device ({bhms:.4f} ms with the host's "
            f"enqueue), plain {pms:.4f} ms, bound {b_bms:.4f} ms "
            f"({b_by}), {touched} table cells touched, ROIs a table tile "
            f"mean {float(per_tile[per_tile > 0].float().mean()):.2f} max "
            f"{int(per_tile.max())}, max abs err {berr:.3g}, max rel err "
            f"{brel:.3g} (tol {POOL_ATOL} + {POOL_RTOL}|x|), a second "
            f"launch bitwise the same")
        bwd["sites"][site] = dict(ms=bms_k, host_ms=bhms, plain_ms=pms,
                                  bound_ms=b_bms, bound_by=b_by,
                                  max_abs_err=berr,
                                  rois_per_tile_max=int(per_tile.max()))
        for key, v in (("ms", bms_k), ("host_ms", bhms), ("plain_ms", pms),
                       ("bound_ms", b_bms)):
            bwd[key] += v
        bwd["max_abs_err"] = max(bwd["max_abs_err"], berr)
        del grad
    bwd["bound_by"] = max(bwd["sites"].values(),
                          key=lambda v: v["bound_ms"])["bound_by"]


N_WIDE = 256    # pairs of the SEARCH_REGION 5 shape check (a step has 1024)


def wide_sr_xcorr_passes(dev, report, g):
    """Kernel 6's three passes at SEARCH_REGION 5's 75x75 x 15x15 ->
    61x61 (f32, N_WIDE pairs): the forward (four 16-wide segments a row),
    the template gradient (61x61 taps: the banded fallback kernel) and the
    search gradient (75x75 output in bands of 32 rows and 16-wide column
    segments), each against its plain version, timed on the device."""
    import torch.nn.functional as F
    n = N_WIDE
    search = torch.randn(n, 75, 75, C, generator=g).to(dev)
    tmpl = (0.1 * torch.randn(n, 15, 15, C, generator=g)).to(dev)
    up = torch.randn(n, 61, 61, C, generator=g).to(dev)
    s_nchw = search.permute(0, 3, 1, 2).reshape(1, n * C, 75, 75)
    t_w = tmpl.permute(0, 3, 1, 2).reshape(n * C, 1, 15, 15)
    up_nchw = up.permute(0, 3, 1, 2).reshape(1, n * C, 61, 61)
    up_w = up.permute(0, 3, 1, 2).reshape(n * C, 1, 61, 61)
    library = {"forward": lambda: F.conv2d(s_nchw, t_w, groups=n * C),
               "grad_template": lambda: F.conv2d(s_nchw, up_w,
                                                 groups=n * C),
               "grad_search": lambda: F.conv_transpose2d(up_nchw, t_w,
                                                         groups=n * C)}
    inputs = {"forward": (search, tmpl), "grad_template": (search, up),
              "grad_search": (up, tmpl)}
    macs = n * 61 * 61 * 15 * 15 * C    # each pass, taps inside g only
    in_elems = {"forward": 75 * 75 + 225, "grad_template": 75 * 75 + 3721,
                "grad_search": 3721 + 225}
    out_elems = {"forward": 3721, "grad_template": 225, "grad_search": 5625}
    passes = {}
    for name, fn, plain in xcorr_passes():
        args = inputs[name]
        k_out = fn(*args)
        p_out = plain(*args)
        torch.cuda.synchronize()
        if k_out.shape != p_out.shape:
            raise AssertionError(f"xcorr {name} 75x75: shape "
                                 f"{tuple(k_out.shape)}")
        err, rel = close(k_out, p_out, POOL_ATOL, POOL_RTOL,
                         f"xcorr {name} 75x75")
        del k_out, p_out
        ms = device_ms(lambda: fn(*args), iters=3, warmup=1)
        pms = timed_ms(lambda: plain(*args), iters=1, warmup=0)
        lms = timed_ms(library[name], iters=3, warmup=1)
        bms, by = bound(n * (in_elems[name] + out_elems[name]) * C * 4,
                        2.0 * macs, F32_FLOPS)
        passes[name] = dict(ms=ms, plain_ms=pms, library_ms=lms,
                            bound_ms=bms, bound_by=by, max_abs_err=err)
        report["xcorr"]["max_abs_err"] = max(report["xcorr"]["max_abs_err"],
                                             err)
        log(f"  xcorr {name} 75x75 x 15x15 -> 61x61 (SEARCH_REGION 5), "
            f"N={n} f32: kernel {ms:.4f} ms device, plain {pms:.4f} ms, "
            f"library {lms:.4f} ms, bound {bms:.4f} ms ({by}), max abs err "
            f"{err:.3g}, max rel err {rel:.3g} (tol {POOL_ATOL} + "
            f"{POOL_RTOL}|x|)")
    report["xcorr"].setdefault("shapes", {})[
        f"75x75 x 15x15 -> 61x61 f32 N={n} (SEARCH_REGION 5)"] = passes


@contextlib.contextmanager
def train_kernel_capture(steps):
    """Count and capture the training kernels' launches while a training
    run of ``steps`` steps runs: kernel 1 (``window_pool``), kernel 7
    (``window_pool_bwd``) and kernel 6's three passes.  Yields (captured,
    launches): ``captured`` keeps by reference what each kernel got at the
    last step (and the bits of the last step's three table gradients),
    ``launches`` is filled with each wrapper's count on exit; the counts
    are set to 0 on entry."""
    import siammot_tpu_torch.ops.window_pool as wp_mod
    import siammot_tpu_torch.ops.xcorr as xc_mod

    captured = {"pool": [], "bwd": [], "forward": [], "grad_template": [],
                "grad_search": [], "bwd_bits": []}

    def capture(name, fn, keep):
        def wrapped(*args):
            out = fn(*args)
            captured[name] = (captured[name] + [args])[-keep:]
            if name == "bwd":  # the last step's table gradients' bits
                last = len(captured["bwd_bits"]) >= 3 * (steps - 1)
                captured["bwd_bits"].append(tensor_bits(out) if last
                                            else None)
            return out
        return wrapped

    passes = xcorr_passes()
    patches = [(wp_mod, "window_pool",
                capture("pool", wp_mod.window_pool, 3)),
               (wp_mod, "window_pool_bwd",
                capture("bwd", wp_mod.window_pool_bwd, 3))]
    patches += [(xc_mod, fn.__name__, capture(name, fn, 1))
                for name, fn, _ in passes]
    originals = [(m, n, getattr(m, n)) for m, n, _ in patches]
    for m, n, f in patches:
        setattr(m, n, f)
    # these wrappers are patched in their own modules, where each counts
    # with ``<its name>.launches += 1``: while a capture wrapper holds that
    # name, the count lands on the wrapper, so read it there
    counters = {"window_pool": wp_mod.window_pool,
                "window_pool_bwd": wp_mod.window_pool_bwd,
                **{name: getattr(xc_mod, fn.__name__)
                   for name, fn, _ in passes}}
    launches = {}
    try:
        for fn in counters.values():
            fn.launches = 0
        yield captured, launches
        launches.update({n: fn.launches for n, fn in counters.items()})
    finally:
        for m, n, f in originals:
            setattr(m, n, f)


def tensor_bits(t):
    """A fingerprint of a tensor's bits (their int32 sum, and the f64 sum
    of the values)."""
    return (int(t.view(torch.int32).sum(dtype=torch.int64)),
            float(t.sum(dtype=torch.float64)))


TRAIN_PER_STEP = {"window_pool": 3, "window_pool_bwd": 3, "forward": 1,
                  "grad_template": 1, "grad_search": 1}


def count_train_launches(launches, steps, report, path):
    """Each training kernel must have launched exactly its per-step count
    in ``steps`` steps; adds the counts to ``report`` under ``path``."""
    passes = xcorr_passes()
    for name, count in launches.items():
        if count != TRAIN_PER_STEP[name] * steps:
            raise AssertionError(f"{path} {name}: {count} launches in "
                                 f"{steps} training steps, expected "
                                 f"{TRAIN_PER_STEP[name] * steps}")
    for name, count in (("window_pool", launches["window_pool"]),
                        ("window_pool_bwd", launches["window_pool_bwd"]),
                        ("xcorr", sum(launches[n] for n, _, _ in passes))):
        by_path = report[name].setdefault("launches_by_path", {})
        by_path[path] = by_path.get(path, 0) + count
        report[name]["launches"] += count
    for name, _, _ in passes:
        row = report["xcorr"].setdefault("passes", {}).setdefault(name, {})
        row["launches"] = row.get("launches", 0) + launches[name]


def check_train_kernels(captured, report, path):
    """Each training kernel against its plain version on the inputs and
    upstream gradients it got at the last step of a run
    (:func:`train_kernel_capture`); the last step's table gradients must
    come back bitwise when launched again."""
    from siammot_tpu_torch.ops.window_pool import (tile_counts,
                                                   touched_rects,
                                                   window_pool,
                                                   window_pool_bwd,
                                                   window_pool_bwd_plain,
                                                   window_pool_plain)
    passes = xcorr_passes()
    # each kernel against its plain version on the last step's inputs
    for site, args in zip(("box_pool", "template_pool", "sr_pool"),
                          captured["pool"]):
        k = window_pool(*args)
        p = window_pool_plain(*args)
        torch.cuda.synchronize()
        err, _ = close(k, p, POOL_ATOL, POOL_RTOL, f"step {site}")
        report["window_pool"]["max_abs_err"] = max(
            report["window_pool"]["max_abs_err"], err)
    for args, step_bits in zip(captured["bwd"], captured["bwd_bits"][-3:]):
        site = {7: "box", 15: "template"}.get(args[2].shape[1], "sr")
        site = site if path == "training" else f"{path} {site}"
        k = window_pool_bwd(*args)
        p = window_pool_bwd_plain(*args)
        torch.cuda.synchronize()
        if tensor_bits(k) != step_bits:
            raise AssertionError(f"step {site} backward: launched again on "
                                 "the step's inputs, other bits")
        err, rel = close_scaled(k, p, f"step {site} backward")
        ms = device_ms(lambda: window_pool_bwd(*args), iters=5)
        per_tile = tile_counts(touched_rects(*args[1:4], args[4]), args[4])
        report["window_pool_bwd"].setdefault("step_sites", {})[site] = dict(
            ms=ms, max_abs_err=err, rois_per_tile_max=int(per_tile.max()))
        log(f"    step {site} backward: max |plain| "
            f"{float(p.detach().abs().max()):.3g}, max abs err {err:.3g}, "
            f"bitwise the step's own launch; kernel {ms:.4f} ms device on "
            f"these inputs, ROIs a table tile max {int(per_tile.max())}")
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


def train_phase(dev, report, card, path="training", overrides=(),
                warmup=TRAIN_WARMUP, timed=TRAIN_TIMED):
    """A training path end to end at full width: phase 4 (the default
    configuration, ``warmup`` + ``timed`` steps) and phase 4b (``overrides``
    ``SEARCH_REGION`` 5: a 75x75 search region, kernel 6's passes at 75
    -> 61).  Every loss finite at every step; per step exactly 3 window-pool
    forward and 3 backward launches and one of each xcorr pass, the counts
    set to 0 just before ``do_train`` and read just after; each kernel
    against its plain version on the last step's inputs.  Returns
    (mean ms/step, median, peak device bytes)."""
    import itertools

    from siammot_tpu_torch.configs.defaults import get_cfg
    from siammot_tpu_torch.engine.solver import (build_train_step,
                                                 make_optimizer)
    from siammot_tpu_torch.engine.trainer import do_train
    from siammot_tpu_torch.models.siammot import SiamMOT
    from siammot_tpu_torch.utils.synth import train_batches
    from siammot_tpu_torch.utils.weights import jax_to_torch, load_npz

    t0 = time.perf_counter()
    cfg = get_cfg()
    cfg.merge_from_list(list(overrides))
    model = SiamMOT(cfg, device=str(dev))
    net = model.build_master(jax_to_torch(load_npz(FIXTURE)))
    optimizer = make_optimizer(cfg, net)
    step = build_train_step(model, optimizer)
    steps = warmup + timed
    batches = list(itertools.islice(
        train_batches(7, HP, cfg.TPU.MAX_GT), steps))
    log(f"  f32 masters ({sum(p.numel() for p in net.parameters())} "
        f"parameters) and {steps} batches of 2 clips x 2 frames ready in "
        f"{time.perf_counter() - t0:.1f} s")

    metrics = []
    with train_kernel_capture(steps) as (captured, launches):
        torch.cuda.reset_peak_memory_stats(dev)
        log_ = do_train(model, step, net, optimizer, iter(batches), None,
                        max_iter=steps, checkpoint_period=10 ** 9,
                        log_period=1,
                        tensorboard_writer=lambda it, m: metrics.append(m))
        peak = torch.cuda.max_memory_allocated(dev)

    if log_.iteration != steps or len(metrics) != steps:
        raise AssertionError(f"ran {log_.iteration} of {steps} steps")
    for i, m in enumerate(metrics):
        if len(m) != 8 or not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"step {i + 1}: losses {m}")
    count_train_launches(launches, steps, report, path)

    sec = np.array(log_.step_seconds[warmup:])
    first, last = metrics[0], metrics[-1]
    log(f"  {steps} SGD steps: {1e3 * sec.mean():.3f} ms/step over the last "
        f"{timed} (median {1e3 * np.median(sec):.3f}, first step "
        f"{1e3 * log_.step_seconds[0]:.1f} ms); peak device memory "
        f"{peak / 2 ** 30:.3f} GiB ({card}); launches {launches}")
    log("  losses, step 1 -> " + str(steps) + ": " + ", ".join(
        f"{k} {first[k]:.4f} -> {last[k]:.4f}" for k in sorted(first)))

    check_train_kernels(captured, report, path)
    return 1e3 * float(sec.mean()), 1e3 * float(np.median(sec)), peak


# -- fault repairs and the DCN slice ----------------------------------------

def reshaped_kernel_phase(dev, report):
    """Kernels 3 and 4 at the shapes besides the main path's that the JAX
    kernels take: the f32 frame (predictor [K, 16, 16, 128] f32, FFMA
    tower conv) and the AOT recipe (template 7, SEARCH_REGION 5: [K, 29, 29,
    128] responses and s_hi 464), plus the decode's whole-map limit."""
    from siammot_tpu_torch.models.emm import _decode_constants
    from siammot_tpu_torch.ops.decode import emm_decode
    from siammot_tpu_torch.ops.predictor import emm_predictor
    g = torch.Generator().manual_seed(3)
    pred = report["emm_predictor"].setdefault("shapes", {})
    for s_, dtype in ((16, torch.float32), (29, torch.bfloat16),
                      (29, torch.float32)):
        valid = live_mask(K, LIVE, g, dev)
        x = torch.randn(K, s_, s_, C, generator=g).to(dev, dtype)
        params = predictor_params(g, dev, dtype)
        args = (x, valid, params)
        tol = PRED_ATOL if dtype == torch.bfloat16 else PRED_F32_ATOL
        errs = [check_predictor(args, f"predictor {s_} {dtype}")[0]]
        ms, hms, split = kernel_times(lambda: emm_predictor(*args))
        live = int(valid.sum())
        bms, by, floor = predictor_bound(x, params, live)
        key = f"{s_}x{s_}x{C} {str(dtype).split('.')[-1]}"
        pred[key] = dict(ms=ms, host_ms=hms, kernels=split, bound_ms=bms,
                         bound_by=by, max_abs_err=max(errs))
        log(f"  emm_predictor [{K}, {key}] live={live}: kernel {ms:.4f} ms "
            f"device ({hms:.4f} ms with the host's enqueue; by kernel: "
            f"{split_text(split)}), bound {bms:.4f} ms ({by}; the scratch's "
            f"two passes {floor:.4f}), max abs err {max(errs):.3g} (tol "
            f"{tol})")
        report["emm_predictor"]["max_abs_err"] = max(
            report["emm_predictor"]["max_abs_err"], max(errs))
    dec = report["emm_decode"].setdefault("shapes", {})
    for s_ in (29, 32):
        valid = live_mask(K, LIVE, g, dev)
        u, window = _decode_constants(s_, 16, str(dev))
        x4 = torch.stack([2 * torch.randn(K, s_, s_, generator=g),
                          torch.randn(K, s_, s_, generator=g),
                          60 + 20 * torch.randn(K, s_, s_, generator=g),
                          120 + 40 * torch.randn(K, s_, s_, generator=g)],
                         1).to(dev).contiguous()
        wh = torch.stack([40 + 110 * torch.rand(K, generator=g),
                          80 + 220 * torch.rand(K, generator=g)], -1).to(dev)
        args = (x4, wh, u, window, valid, 0.4, True)
        err, _ = check_decode(args, f"emm_decode s={s_} s_hi={16 * s_}")
        ms = device_ms(lambda: emm_decode(*args))
        hms = timed_ms(lambda: emm_decode(*args))
        live = int(valid.sum())
        sh = 16 * s_
        bms, by, old = decode_bound(x4, u, window, live)
        dec[f"s={s_} s_hi={sh}"] = dict(ms=ms, host_ms=hms, bound_ms=bms,
                                        bound_by=by, max_abs_err=err)
        log(f"  emm_decode s={s_} s_hi={sh} live={live}: kernel {ms:.4f} "
            f"ms device ({hms:.4f} ms with the host's enqueue), bound "
            f"{bms:.4f} ms ({by}; {old:.4f} at 30 flops a cell), max abs "
            f"score err {err:.3g}")
        report["emm_decode"]["max_abs_err"] = max(
            report["emm_decode"]["max_abs_err"], err)


# DLA-102-DCN-FPN at 736x1280: (stage, input HW, C = Co, layers a frame)
# of the stride-2 first layer and the stride-1 rest of stages 3, 4, 5
DCN_STAGES = [(3, (184, 320), 128, 1, 7), (4, (92, 160), 256, 1, 15),
              (5, (46, 80), 512, 1, 1)]
DCN_F32_ATOL = 2e-5          # of the output's largest magnitude
DCN_BF16_RTOL, DCN_BF16_ATOL = 2.0 ** -7, 2.0 ** -9


def check_deform(args, what):
    """Kernel 9 against its plain version: f32 to 2e-5 of the output's
    scale; bf16 one bf16 step plus 2^-9 of the scale (the same samples,
    f32 sums in another order, then one rounding)."""
    from siammot_tpu_torch.ops.deform_conv import (deform_conv2d,
                                                   deform_conv2d_plain)
    k_ = deform_conv2d(*args).float()
    p_ = deform_conv2d_plain(*args).float()
    torch.cuda.synchronize()
    scale = float(p_.abs().max())
    if args[0].dtype == torch.float32:
        err, _ = close(k_, p_, DCN_F32_ATOL * scale, 0.0, what)
    else:
        err, _ = close(k_, p_, DCN_BF16_ATOL * scale, DCN_BF16_RTOL, what)
    return err, scale


def deform_bound(args):
    x, off, w = args[:3]
    ho, wo = off.shape[1:3]
    c, co = w.shape[2:]
    n = x.shape[0] * ho * wo
    nbytes = (x.numel() + off.numel() + w.numel() + n * co) \
        * x.element_size()
    return bound(nbytes, 2.0 * 9 * c * co * n,
                 BF16_TC_FLOPS if x.dtype == torch.bfloat16 else F32_FLOPS)


def deform_kernel_phase(dev, report):
    """Kernel 9 at DLA-102's three stage shapes, stride 2 and stride 1,
    in-window (route A) and out-of-window (route B) offsets, bf16 and f32,
    against its plain version; the frame's 26 launches summed by shape
    (the main path's mix: stride 2 by route B, stride 1 by route A).  At
    each bf16 stride-1 in-window shape the kernel is also timed with its
    taps split over 1, 3 and 9 blocks, the evidence for ``tap_splits``."""
    import torch.nn.functional as F

    from siammot_tpu_torch.ops.deform_conv import (_launch, deform_conv2d,
                                                   deform_conv2d_plain,
                                                   in_window, tap_splits,
                                                   window_route_possible)
    g = torch.Generator().manual_seed(5)
    row = report["deform_conv"]
    row.update(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None,
               max_abs_err=0.0, launches=0, shapes={})
    frame_bytes = frame_ops = 0.0
    for stage, (h, w), c, n2, n1 in DCN_STAGES:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(1, h, w, c, generator=g).to(dev, dtype)
            wgt = (torch.randn(3, 3, c, c, generator=g) / (9 * c) ** 0.5).to(
                dev, dtype)
            xs = x[:, ::2, ::2].contiguous()          # the stride-1 input
            for stride, scale, xin, count in ((2, 0.8, x, n2),
                                              (1, 0.35, xs, n1),
                                              (1, 2.0, xs, 0)):
                ho, wo = (xin.shape[1] - 1) // stride + 1, \
                    (xin.shape[2] - 1) // stride + 1
                off = (scale * torch.randn(1, ho, wo, 18, generator=g)).to(
                    dev, dtype)
                args = (xin, off, wgt, stride)
                route = "A" if window_route_possible(
                    xin.shape, wgt.shape, stride, 1, xin.element_size()) \
                    and bool(in_window(off)) else "B"
                err, _ = check_deform(args, f"deform stage {stage} s{stride}"
                                      f" {route} {dtype}")
                ms, hms, split = kernel_times(lambda: deform_conv2d(*args))
                pms = timed_ms(lambda: deform_conv2d_plain(*args), iters=3,
                               warmup=1)
                xn = xin.permute(0, 3, 1, 2)
                wn = wgt.permute(3, 2, 0, 1).contiguous()
                dms = timed_ms(lambda: F.conv2d(xn, wn, stride=stride,
                                                padding=1))
                bms, by = deform_bound(args)
                key = (f"stage{stage} {xin.shape[1]}x{xin.shape[2]}x{c} s"
                       f"{stride} route {route} "
                       f"{str(dtype).split('.')[-1]}")
                row["shapes"][key] = dict(ms=ms, host_ms=hms, kernels=split,
                                          plain_ms=pms, bound_ms=bms,
                                          bound_by=by, max_abs_err=err,
                                          dense_conv_ms=dms,
                                          per_frame=count)
                row["max_abs_err"] = max(row["max_abs_err"], err)
                log(f"  deform_conv {key}: kernel {ms:.4f} ms device "
                    f"({hms:.4f} ms with the host's enqueue; by kernel: "
                    f"{split_text(split)}), plain "
                    f"{pms:.4f} ms, bound {bms:.4f} ms ({by}), dense "
                    f"cuDNN 3x3 of the same shape {dms:.4f} ms, max abs err "
                    f"{err:.3g}")
                if dtype == torch.bfloat16 and count and stride == 1:
                    sweep = {s_: device_ms(lambda: _launch(xin, off, wgt, 1,
                                                           1, s_))
                             for s_ in (1, 3, 9)}
                    row["shapes"][key]["splits_ms"] = sweep
                    log(f"    taps split over 1 / 3 / 9 blocks: "
                        + " / ".join(f"{v:.4f}" for v in sweep.values())
                        + f" ms device; tap_splits picks "
                        f"{tap_splits(ho * wo, c)}")
                if dtype == torch.bfloat16 and count:
                    row["ms"] += count * ms
                    row["host_ms"] = row.get("host_ms", 0.0) + count * hms
                    row["plain_ms"] += count * pms
                    frame_bytes += count * 2 * (xin.numel() + off.numel()
                                                + wgt.numel() + ho * wo * c)
                    frame_ops += count * 2.0 * 9 * c * c * ho * wo
            del x, xs
    row["bound_ms"], row["bound_by"] = bound(frame_bytes, frame_ops,
                                             BF16_TC_FLOPS)
    log(f"  deform_conv, one DLA-102 frame (26 launches, bf16): kernel "
        f"{row['ms']:.4f} ms device ({row['host_ms']:.4f} ms with the "
        f"host's enqueue), plain {row['plain_ms']:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']})")


def gap_text(gap):
    return (f"{gap['ids_differ']} ids differ, {gap['unmatched']} of "
            f"{gap['rows']} rows unmatched, max box err "
            f"{gap['box_err']:.4g} px, max score err {gap['score_err']:.4g}")


def bf16_yardstick(dev, what):
    """The port's bf16 DLA-34 frames on the card against the JAX step's
    own bf16 rows (``tests/fixtures/torch_golden_dla34_bf16.npz``) and
    its f32 rows, rows matched by IoU; and the JAX bf16 rows' gap to the
    JAX f32 rows, for scale.  Printed, not gated."""
    from siammot_tpu_torch.utils import golden
    got = golden.run(str(dev), "bfloat16")
    f32, bf16 = golden.load(), golden.load(golden.BF16_FIXTURE)
    gaps = {"jax_bf16": golden.matched_gap(got, bf16),
            "jax_f32": golden.matched_gap(got, f32),
            "jax_bf16_to_f32": golden.matched_gap(bf16, f32)}
    log(f"  {what}: the port's bf16 frames against the JAX bf16 rows: "
        f"{gap_text(gaps['jax_bf16'])}; against the JAX f32 rows: "
        f"{gap_text(gaps['jax_f32'])} (JAX's own bf16 rows against its f32 "
        f"rows: {gap_text(gaps['jax_bf16_to_f32'])})")
    return gaps


def golden_phase(dev):
    """The default configuration against the JAX step: the f32 frame on
    the card must match ``tests/fixtures/torch_golden_dla34.npz`` within
    ``utils/golden.py``'s tolerances; the bf16 frame's gap to the JAX
    bf16 and f32 rows is printed (:func:`bf16_yardstick`)."""
    from siammot_tpu_torch.utils import golden
    want = golden.load()
    got = golden.run(str(dev), "float32")
    r = golden.compare(got, want)
    log(f"  f32 DLA-34 frame on the card against the JAX fixture "
        f"({golden.N_FRAMES} frames, {golden.W}x{golden.H}, "
        f"{r['live_rows']} valid rows, {r['live_slots']} live slots): {r}")
    if not r["ok"]:
        raise AssertionError(f"f32 frame differs from the JAX step: {r}")
    log_races(dev, None)
    return r, bf16_yardstick(dev, "bf16 gap")


def log_races(dev, cut_name):
    """The f32 frames' two closest decode races on the card
    (``golden.decode_races``): how near a row sits to the first-index
    rule, which any change to the sums before the decode may tip."""
    from siammot_tpu_torch.utils import golden
    races = golden.decode_races(str(dev), "float32", cut_name, n=2)
    log(f"    closest decode races ({cut_name or 'default'}, f32): "
        + "; ".join(f"frame {r['frame']} slot {r['slot']} cells "
                    f"{r['cells']} p_conf {r['p_conf'][0]!r} vs "
                    f"{r['p_conf'][1]!r} ({r['ulps']:g} ulps)"
                    for r in races))


def dcn_phase(dev, report, card):
    """The slice's main path: DLA-102-DCN-FPN single-stream tracking at
    736x1280 in bf16, 6 warm-up + 10 timed frames of the crowded scene."""
    from siammot_tpu_torch.configs.defaults import dla_dcn_overrides, get_cfg
    from siammot_tpu_torch.models.siammot import SiamMOT
    from siammot_tpu_torch.ops.deform_conv import (in_window,
                                                   window_route_possible)
    from siammot_tpu_torch.utils.synth import render_scene
    from siammot_tpu_torch.utils.weights import seeded_params

    t0 = time.perf_counter()
    cfg = get_cfg()
    cfg.merge_from_list(dla_dcn_overrides("DLA-102-FPN"))
    model = SiamMOT(cfg, device=str(dev))
    frames = render_scene(16, HP)[0]
    params, n_dcn = seeded_params(model, frames[0])
    if n_dcn != 26:
        raise AssertionError(f"{n_dcn} deformable layers, expected 26")
    log(f"  DLA-102-DCN-FPN: {sum(v.numel() for v in params.values())} "
        f"parameters from a seed, offsets calibrated; ready in "
        f"{time.perf_counter() - t0:.1f} s")
    stream = [frames[i % len(frames)] for i in range(DCN_WARMUP + DCN_TIMED)]
    result, launches, captured = drive_frames(
        model, params, stream, (W, H), MAIN_PATH | {"deform_conv": 26})
    report["deform_conv"]["launches"] = launches["deform_conv"]
    for name in MAIN_PATH:
        report[name].setdefault("launches_by_path", {})["dcn_inference"] = \
            launches[name]
        report[name]["launches"] += launches[name]
    sec = np.array(result.frame_seconds[DCN_WARMUP:])
    occupied, active = check_last_frame(result, K)
    dcn_args = captured["deform_conv"]
    routes = ["A" if window_route_possible(a[0].shape, a[2].shape, a[3], 1,
                                           a[0].element_size())
              and bool(in_window(a[1])) else "B" for a in dcn_args]
    log(f"  {len(stream)} frames: {1e3 * sec.mean():.3f} ms/frame over the "
        f"last {DCN_TIMED} (median {1e3 * np.median(sec):.3f}, first frame "
        f"{1e3 * result.frame_seconds[0]:.1f} ms; {card}); live slots "
        f"{occupied} of {K} ({active} active); launches {launches} "
        f"({launches['deform_conv'] / len(stream):.0f} deform_conv a "
        f"frame); last frame's routes {''.join(routes)}")
    check_captured(captured, report, "dcn-path")
    err = rel = 0.0
    for i, args in enumerate(dcn_args):
        e, scale = check_deform(args, f"dcn-path deform layer {i} "
                                      f"(route {routes[i]})")
        err, rel = max(err, e), max(rel, e / max(scale, 1e-30))
    report["deform_conv"]["max_abs_err"] = max(
        report["deform_conv"]["max_abs_err"], err)
    log(f"  kernels agree with their plain versions on the last frame's "
        f"inputs (26 deformable layers, max abs err {err:.3g}, at most "
        f"{rel:.3g} of the layer's largest plain output)")
    return 1e3 * float(sec.mean()), occupied, routes


# -- the fourth slice: kernels 10, 5 and 8, the given and toggled paths ----

def decode_inputs(g, dev, s_, k=K):
    """Seeded decode inputs at response side ``s_`` (x4, wh, u, window)."""
    from siammot_tpu_torch.models.emm import _decode_constants
    u, window = _decode_constants(s_, 16, str(dev))
    x4 = torch.stack([2 * torch.randn(k, s_, s_, generator=g),
                      torch.randn(k, s_, s_, generator=g),
                      60 + 20 * torch.randn(k, s_, s_, generator=g),
                      120 + 40 * torch.randn(k, s_, s_, generator=g)],
                     1).to(dev).contiguous()
    wh = torch.stack([40 + 110 * torch.rand(k, generator=g),
                      80 + 220 * torch.rand(k, generator=g)], -1).to(dev)
    return x4, wh, u, window



def variants_kernel_phase(dev, report):
    """Kernels 10, 5 and 8 against their plain versions: kernel 10 at
    [128, 4, 16, 16] over every slot; kernel 5 at s_hi 976 (s 61, stripe
    16) and 736 (s 46, stripe 32), gated with 37 live slots and ungated,
    and with stripe 64 forced at s_hi 256, bitwise against kernels 4 and
    10; kernel 8 at [128, 16, 16, 128] bf16 and f32, B = 8, the 37 live
    slots compacted to the front (as the step's top-k leaves them), so
    blocks 0-3 are live, block 4 mixed and the rest without a live slot."""
    from siammot_tpu_torch.ops.decode import (emm_decode, emm_decode_plain,
                                              emm_decode_striped,
                                              emm_decode_striped_plain,
                                              emm_decode_unmasked)
    from siammot_tpu_torch.ops.predictor import (emm_predictor_blocked,
                                                 emm_predictor_blocked_plain)
    g = torch.Generator().manual_seed(7)
    for name in ("emm_decode_unmasked", "emm_decode_striped",
                 "emm_predictor_blocked"):
        report[name].update(library_ms=None, max_abs_err=0.0, shapes={})

    # kernel 10
    args = decode_inputs(g, dev, 16)
    row = report["emm_decode_unmasked"]
    got = emm_decode_unmasked(*args, 0.4, True)
    err = compare_decode(got, emm_decode_plain(*args, None, 0.4, True),
                         (*args, None, 0.4, True), "emm_decode_unmasked")
    ms, hms, _ = kernel_times(lambda: emm_decode_unmasked(*args, 0.4, True))
    pms = timed_ms(lambda: emm_decode_plain(*args, None, 0.4, True),
                   iters=5)
    bms, by, old = decode_bound(args[0], args[2], args[3], K)
    row.update(ms=ms, host_ms=hms, plain_ms=pms, bound_ms=bms, bound_by=by,
               max_abs_err=err)
    log(f"  emm_decode_unmasked [{K}, 4, 16, 16], all {K} slots: kernel "
        f"{ms:.4f} ms device ({hms:.4f} ms with the host's enqueue), plain "
        f"{pms:.4f} ms, bound {bms:.4f} ms ({by}; {old:.4f} at 30 flops a "
        f"cell), max abs score err {err:.3g}")

    # kernel 5: the striped form past s_hi 512, gated and ungated
    row = report["emm_decode_striped"]
    for s_, stripe in ((61, 16), (46, 32)):
        args = decode_inputs(g, dev, s_)
        for gated in (True, False):
            valid = live_mask(K, LIVE, g, dev) if gated else None
            a7 = (*args, valid, 0.4, True)
            got = emm_decode_striped(*a7, stripe)
            err = compare_decode(got, emm_decode_striped_plain(*a7, stripe),
                                 a7, f"emm_decode_striped s_hi={16 * s_}")
            ms = device_ms(lambda: emm_decode_striped(*a7, stripe),
                           iters=5)
            hms = timed_ms(lambda: emm_decode_striped(*a7, stripe), iters=5)
            pms = timed_ms(lambda: emm_decode_striped_plain(*a7, stripe),
                           iters=2, warmup=1)
            n = LIVE if gated else K
            bms, by, old = decode_bound(args[0], args[2], args[3], n)
            key = (f"s={s_} s_hi={16 * s_} stripe={stripe} "
                   f"{'gated' if gated else 'ungated'}")
            row["shapes"][key] = dict(ms=ms, host_ms=hms, plain_ms=pms,
                                      bound_ms=bms, bound_by=by,
                                      max_abs_err=err)
            row["max_abs_err"] = max(row["max_abs_err"], err)
            log(f"  emm_decode_striped {key}, {n} decoded: kernel {ms:.4f} "
                f"ms device ({hms:.4f} ms with the host's enqueue), plain "
                f"{pms:.4f} ms, bound {bms:.4f} ms ({by}; {old:.4f} at 30 "
                f"flops a cell), max abs score err {err:.3g}")
    main_key = "s=61 s_hi=976 stripe=16 gated"
    row.update({k: row["shapes"][main_key][k]
                for k in ("ms", "host_ms", "plain_ms", "bound_ms",
                          "bound_by")})
    # forced stripe at s_hi 256: bitwise the whole-map kernels' answers
    args = decode_inputs(g, dev, 16)
    valid = live_mask(K, LIVE, g, dev)
    for v, whole in ((valid, lambda: emm_decode(*args, valid, 0.4, True)),
                     (None, lambda: emm_decode_unmasked(*args, 0.4, True))):
        si, ss = emm_decode_striped(*args, v, 0.4, True, 64)
        wi, ws = whole()
        torch.cuda.synchronize()
        if not (torch.equal(si, wi) and torch.equal(ss, ws)):
            raise AssertionError("striped decode (stripe 64) differs from "
                                 "the whole-map kernel")
    log("  emm_decode_striped, stripe 64 forced at s_hi 256: (idx, score) "
        "bitwise equal to emm_decode (gated) and emm_decode_unmasked")

    # kernel 8, on the device and split by kernel (tower, heads) as
    # kernel 3 in phase 2
    row = report["emm_predictor_blocked"]
    valid = torch.zeros(K, dtype=torch.bool, device=dev)
    valid[:LIVE] = True
    for s_, dtype in ((16, torch.bfloat16), (16, torch.float32),
                      (61, torch.bfloat16)):
        x = torch.randn(K, s_, s_, C, generator=g).to(dev, dtype)
        params = predictor_params(g, dev, dtype)
        args = (x, valid, params, 8)
        err = check_blocked(args, f"emm_predictor_blocked {s_} {dtype}")
        ms, hms, split = kernel_times(lambda: emm_predictor_blocked(*args),
                                      iters=20 if s_ == 16 else 5)
        pms = timed_ms(lambda: emm_predictor_blocked_plain(*args), iters=3,
                       warmup=1)
        bms, by, floor = predictor_bound(x, params, LIVE)
        key = f"{s_}x{s_}x{C} {str(dtype).split('.')[-1]} B=8"
        row["shapes"][key] = dict(ms=ms, host_ms=hms, kernels=split,
                                  plain_ms=pms, bound_ms=bms, bound_by=by,
                                  max_abs_err=err)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        log(f"  emm_predictor_blocked [{K}, {key}], {LIVE} live (groups "
            f"0-3 live, 4 mixed, 5-15 without a live slot): kernel "
            f"{ms:.4f} ms device ({hms:.4f} ms with the host's enqueue; by "
            f"kernel: {split_text(split)}), plain {pms:.4f} ms, bound "
            f"{bms:.4f} ms ({by}; the scratch's two passes {floor:.4f}), "
            f"max abs err {err:.3g} (tol "
            f"{PRED_ATOL if dtype == torch.bfloat16 else PRED_F32_ATOL}; "
            f"bitwise kernel 3's)")
        del x, args
    row.update({k: row["shapes"][f"16x16x{C} bfloat16 B=8"][k]
                for k in ("ms", "host_ms", "kernels", "plain_ms", "bound_ms",
                          "bound_by")})

    # kernels 1-3 at the shapes SEARCH_REGION 5 gives them
    wide_sr_kernel_checks(dev, report, g)


def wide_sr_kernel_checks(dev, report, g):
    """Kernels 1, 2 and 3 at SEARCH_REGION 5's shapes (phase 6c): the SR
    pool at 75x75 (window 128, spans past it clamped as in the JAX
    package), the masked xcorr 75x75 x 15x15 -> 61x61
    and the predictor at [K, 61, 61, 128] bf16, 37 of 128
    slots live."""
    import torch.nn.functional as F

    from siammot_tpu_torch.core.boxes import map_rois_to_levels
    from siammot_tpu_torch.models.emm import EMMConfig, make_search_region
    from siammot_tpu_torch.ops.predictor import (emm_predictor,
                                                 emm_predictor_plain)
    from siammot_tpu_torch.ops.roi_align_windowed import (pack_levels,
                                                          window_geometry)
    from siammot_tpu_torch.ops.window_pool import (window_pool,
                                                   window_pool_plain)
    from siammot_tpu_torch.ops.xcorr import (xcorr_depthwise_masked,
                                             xcorr_depthwise_plain)
    feats = [torch.randn(1, h, w, C, generator=g).to(dev) for h, w in FPN_HW]
    pack = pack_levels(feats, SCALES, dtype=torch.bfloat16)
    ecfg = EMMConfig(15, SCALES, 2, 5.0, 0, 512, True, 0.4, False)
    tb = track_boxes(K, g)
    block = map_rois_to_levels(tb, 2, 5).to(dev)
    scales = torch.tensor(SCALES, device=dev)[block.long()]
    geo = window_geometry(pack.heights, pack.widths, pack.row_offsets,
                          make_search_region(tb, ecfg).to(dev), block,
                          scales, 75, 2, 128, 512, 4)
    args = (pack.table, *geo, live_mask(K, LIVE, g, dev))
    err, _ = check_pool(args, "sr_pool 75x75")
    ms = device_ms(lambda: window_pool(*args))
    hms = timed_ms(lambda: window_pool(*args))
    pms = timed_ms(lambda: window_pool_plain(*args), iters=3, warmup=1)
    bms, by = pool_bound(*args)
    report["window_pool"].setdefault("shapes", {})[
        "sr_pool 75x75 window 128 (SEARCH_REGION 5)"] = dict(
            ms=ms, host_ms=hms, plain_ms=pms, bound_ms=bms, bound_by=by,
            max_abs_err=err)
    log(f"  window_pool sr_pool 75x75 (SEARCH_REGION 5), {LIVE} live: "
        f"kernel {ms:.4f} ms device ({hms:.4f} ms with the host's enqueue), "
        f"plain {pms:.4f} ms, bound {bms:.4f} ms ({by}), max abs err "
        f"{err:.3g}")

    valid = live_mask(K, LIVE, g, dev)
    search = torch.randn(K, 75, 75, C, generator=g).to(dev, torch.bfloat16)
    tmpl = (0.1 * torch.randn(K, 15, 15, C, generator=g)).to(
        dev, torch.bfloat16)
    args = (search, tmpl, valid)
    err, _ = check_xcorr(args, "xcorr_masked 75->61")
    ms = device_ms(lambda: xcorr_depthwise_masked(*args))
    hms = timed_ms(lambda: xcorr_depthwise_masked(*args))
    pms = timed_ms(lambda: xcorr_depthwise_plain(*args), iters=3, warmup=1)
    s_nchw = search.permute(0, 3, 1, 2).reshape(1, K * C, 75, 75)
    t_nchw = tmpl.permute(0, 3, 1, 2).reshape(K * C, 1, 15, 15)
    lms = timed_ms(lambda: F.conv2d(s_nchw, t_nchw, groups=K * C))
    nbytes = LIVE * (75 * 75 + 15 * 15) * C * 2 + K * 61 * 61 * C * 4 + K
    bms, by = bound(nbytes, LIVE * 61 * 61 * 15 * 15 * C * 2.0, F32_FLOPS)
    report["xcorr_masked"].setdefault("shapes", {})[
        "75x75 x 15x15 -> 61x61 bf16 (SEARCH_REGION 5)"] = dict(
            ms=ms, host_ms=hms, plain_ms=pms, library_ms=lms, bound_ms=bms,
            bound_by=by, max_abs_err=err)
    log(f"  xcorr_masked 75x75 -> 61x61 (four 16-wide segments a row), "
        f"{LIVE} live: kernel {ms:.4f} ms device ({hms:.4f} ms with the "
        f"host's enqueue), plain {pms:.4f} ms, conv2d(groups) {lms:.4f} "
        f"ms, bound {bms:.4f} ms ({by}), max abs err {err:.3g}")
    del search, tmpl, s_nchw, t_nchw

    valid = live_mask(K, LIVE, g, dev)
    x = torch.randn(K, 61, 61, C, generator=g).to(dev, torch.bfloat16)
    params = predictor_params(g, dev)
    args = (x, valid, params)
    err, _ = check_predictor(args, "emm_predictor 61x61")
    ms, hms, split = kernel_times(lambda: emm_predictor(*args), iters=5)
    pms = timed_ms(lambda: emm_predictor_plain(*args), iters=2, warmup=1)
    bms, by, floor = predictor_bound(x, params, LIVE)
    report["emm_predictor"].setdefault("shapes", {})[
        f"61x61x{C} bfloat16 (SEARCH_REGION 5)"] = dict(
            ms=ms, host_ms=hms, kernels=split, plain_ms=pms, bound_ms=bms,
            bound_by=by, max_abs_err=err)
    log(f"  emm_predictor [{K}, 61, 61, {C}] bf16, {LIVE} live: kernel "
        f"{ms:.4f} ms device ({hms:.4f} ms with the host's enqueue; by "
        f"kernel: {split_text(split)}), plain {pms:.4f} ms, bound {bms:.4f} "
        f"ms ({by}; the scratch's two passes {floor:.4f}), max abs err "
        f"{err:.3g} (tol {PRED_ATOL})")


def golden_toggles_phase(dev):
    """The three cuts of ``tests/fixtures/torch_golden_toggles.npz`` (given
    detections, unmasked EMM route, SEARCH_REGION 5) on the card in f32:
    each must match the JAX rows, the given cut also with
    ``SIAMMOT_PREDICTOR_BLOCK=8`` (kernel 8, which computes kernel 3's
    function, held to the same rows and tolerances); the bf16 gap of each
    is printed."""
    from siammot_tpu_torch.ops.predictor import emm_predictor_blocked
    from siammot_tpu_torch.utils import golden
    want = golden.load(golden.TOGGLES_FIXTURE)
    out = {}
    for name in golden.CUTS:
        w = golden.cut(want, name)
        r = golden.compare(golden.run(str(dev), "float32", name), w)
        log(f"  cut {name}: f32 on the card against the JAX rows "
            f"({r['live_rows']} valid rows, {r['live_slots']} live slots): "
            f"{r}")
        if not r["ok"]:
            raise AssertionError(f"cut {name}: f32 frame differs from the "
                                 f"JAX step: {r}")
        log_races(dev, name)
        if name == "given":
            old = os.environ.get("SIAMMOT_PREDICTOR_BLOCK")
            os.environ["SIAMMOT_PREDICTOR_BLOCK"] = "8"
            before = emm_predictor_blocked.launches
            try:
                rb = golden.compare(golden.run(str(dev), "float32", name), w)
            finally:
                if old is None:
                    del os.environ["SIAMMOT_PREDICTOR_BLOCK"]
                else:
                    os.environ["SIAMMOT_PREDICTOR_BLOCK"] = old
            n8 = emm_predictor_blocked.launches - before
            log(f"  cut {name} with SIAMMOT_PREDICTOR_BLOCK=8 ({n8} kernel-8 "
                f"launches): f32 on the card against the JAX rows: {rb}")
            if not rb["ok"] or n8 != golden.N_FRAMES:
                raise AssertionError(f"cut {name} under kernel 8: {n8} "
                                     f"launches, {rb}")
            out["given_block8"] = rb
        gap = golden.matched_gap(golden.run(str(dev), "bfloat16", name), w)
        log(f"  cut {name}: bf16 gap {gap['ids_differ']} ids differ, "
            f"{gap['unmatched']} of {gap['rows']} rows unmatched, max box "
            f"err {gap['box_err']:.4g} px, max score err "
            f"{gap['score_err']:.4g}")
        out[name] = (r, gap)
    return out


MOT17_RECIPE = os.path.join(REPO, "configs", "dla",
                            "DLA_34_FPN_EMM_MOT17.yaml")
TOGGLE_WARMUP, TOGGLE_TIMED = 4, 12


def toggle_run(dev, report, card, what, cfg, per_frame, frames, image_size,
               **track_kw):
    """One phase-6 run: bench weights, bf16, ``TOGGLE_WARMUP`` +
    ``TOGGLE_TIMED`` frames through ``drive_frames``; launches recorded
    by path, the kernels checked on the last frame.  Returns ms/frame."""
    from siammot_tpu_torch.models.siammot import SiamMOT
    from siammot_tpu_torch.utils.weights import jax_to_torch, load_npz
    model = SiamMOT(cfg, device=str(dev))
    params = jax_to_torch(load_npz(FIXTURE))
    n = TOGGLE_WARMUP + TOGGLE_TIMED
    stream = [frames[i % len(frames)] for i in range(n)]
    kw = {k: (v * n)[:n] if isinstance(v, list) else v
          for k, v in track_kw.items()}
    result, launches, captured = drive_frames(model, params, stream,
                                              image_size, per_frame, **kw)
    for name, count in launches.items():
        report[name].setdefault("launches_by_path", {})[what] = count
        report[name]["launches"] = report[name].get("launches", 0) + count
    sec = np.array(result.frame_seconds[TOGGLE_WARMUP:])
    occupied, active = check_last_frame(result, K)
    h, w = frames[0].shape[1:3]
    log(f"  {what}: {n} frames at {w}x{h} (content {image_size[0]}x"
        f"{image_size[1]}): {1e3 * sec.mean():.3f} ms/frame over the last "
        f"{TOGGLE_TIMED} (median {1e3 * np.median(sec):.3f}; {card}); live "
        f"slots {occupied} of {K} ({active} active); launches {launches}")
    check_captured(captured, report, what)
    log(f"  {what}: kernels agree with their plain versions on the last "
        f"frame's inputs")
    return 1e3 * float(sec.mean()), occupied


def toggles_phase(dev, report, card):
    """Phase 6: the paths that select kernels 8, 6 (forward), 10 and 5 on
    the repo's trained DLA-34-FPN-EMM weights in bf16 at full width."""
    from siammot_tpu_torch.configs.defaults import get_cfg, resize_dims
    from siammot_tpu_torch.utils.synth import public_detections, render_scene
    out = {}

    # 6a: the MOT17 public-detection recipe, read by the port's reader,
    # with SIAMMOT_PREDICTOR_BLOCK=8 for the run (kernel 8)
    cfg = get_cfg()
    cfg.merge_from_file(MOT17_RECIPE)
    if not cfg.INFERENCE.USE_GIVEN_DETECTIONS:
        raise AssertionError("the MOT17 recipe did not set given mode")
    w0, h0 = 1920, 1080
    cw, ch = resize_dims(w0, h0, cfg.INPUT.MIN_SIZE_TEST,
                         cfg.INPUT.MAX_SIZE_TEST)
    div = cfg.DATALOADER.SIZE_DIVISIBILITY
    pw, ph = -(-cw // div) * div, -(-ch // div) * div
    t0 = time.perf_counter()
    frames, boxes, _ = render_scene(16, ph, 42, ch, cw)
    frames = [np.pad(f, ((0, 0), (0, 0), (0, pw - cw), (0, 0)))
              for f in frames]
    dets = public_detections(boxes, (cw, ch), seed=42,
                             scale_xy=(w0 / cw, h0 / ch))
    log(f"  6a: MOT17 recipe {os.path.relpath(MOT17_RECIPE, REPO)}: "
        f"{w0}x{h0} -> {cw}x{ch} content, {pw}x{ph} padded; 16 frames and "
        f"{sum(map(len, dets))} public detections ready in "
        f"{time.perf_counter() - t0:.1f} s")
    old = os.environ.get("SIAMMOT_PREDICTOR_BLOCK")
    os.environ["SIAMMOT_PREDICTOR_BLOCK"] = "8"
    try:
        out["6a"] = toggle_run(
            dev, report, card, "mot17_given", cfg,
            MAIN_PATH | {"emm_predictor": 0, "emm_predictor_blocked": 1},
            frames, (cw, ch), given=dets, original_size=(w0, h0))
    finally:
        if old is None:
            del os.environ["SIAMMOT_PREDICTOR_BLOCK"]
        else:
            os.environ["SIAMMOT_PREDICTOR_BLOCK"] = old
    del frames

    frames = render_scene(16, HP)[0]
    # 6b: TPU.MASKED_TRACK_KERNELS False (kernel 6's forward, kernel 10)
    cfg = get_cfg()
    cfg.merge_from_list(["TPU.MASKED_TRACK_KERNELS", False])
    out["6b"] = toggle_run(
        dev, report, card, "unmasked", cfg,
        {"window_pool": 3, "xcorr": 1, "emm_predictor": 1,
         "emm_decode_unmasked": 1}, frames,
        (W, H))
    # 6c: SEARCH_REGION 5 (75x75 SR pool, 61x61 response, kernel 5)
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.TRACK_HEAD.SEARCH_REGION", 5.0])
    out["6c"] = toggle_run(
        dev, report, card, "wide_sr", cfg,
        MAIN_PATH | {"emm_decode": 0, "emm_decode_striped": 1}, frames,
        (W, H))
    return out


# -- phase 7: dataset inference through tools/test_net -----------------------

def decode_phase(dev):
    """7a: the committed sequence's frames through the port's reader on
    the card against the digests of the JAX package's decode (libjpeg),
    and the largest byte difference where it can be measured."""
    from siammot_tpu_torch.configs.defaults import get_cfg
    from siammot_tpu_torch.data import native
    from siammot_tpu_torch.data.transforms import EvalTransform
    from siammot_tpu_torch.data.video_loader import normalized_frame_source
    from siammot_tpu_torch.utils import dataset_golden as dg
    t0 = time.perf_counter()
    reader = native.FrameReader(dev)
    built = time.perf_counter() - t0
    cfg = get_cfg()
    cfg.merge_from_file(dg.RECIPE)
    want = dg.load()
    frames = [x for x, _ in normalized_frame_source(
        dg.SEQUENCE, EvalTransform(cfg), device=dev)]
    got = dg.frame_digests(frames)
    ref = want["frames"][dg.VIDEO]
    same = sum(a == b for a, b in zip(got, ref))
    log(f"  decoder {reader.decoder} (built in {built:.1f} s); {same} of "
        f"{len(ref)} frames' sha256 equal to the JAX package's "
        f"({want['decoder']}) decode")
    if len(got) != len(ref):
        raise AssertionError(f"{len(got)} frames decoded, {len(ref)} "
                             f"expected")
    diff = libjpeg_byte_difference(frames, ref)
    if reader.decoder == "libjpeg" and same != len(ref):
        raise AssertionError(f"{len(ref) - same} of {len(ref)} frames decode "
                             f"to other bytes than the JAX package's")
    return reader.decoder, same, diff


def libjpeg_byte_difference(frames, ref):
    """The largest byte difference between the port's frames and libjpeg's
    decode of the same files, through Pillow's bundled libjpeg where this
    machine has Pillow and its decode hashes to the JAX package's (the
    JAX digests alone cannot give a difference).  None when not measured."""
    try:
        from PIL import Image
    except ImportError:
        log("  largest byte difference to libjpeg: not measured (no Pillow "
            "here)")
        return None
    from siammot_tpu_torch.data.video_loader import jpeg_files
    from siammot_tpu_torch.utils import dataset_golden as dg
    pil = [np.asarray(Image.open(f).convert("RGB"))[None]
           for f in jpeg_files(dg.SEQUENCE)]
    if dg.frame_digests(pil) != ref:
        log("  largest byte difference to libjpeg: not measured (Pillow's "
            "decode is not the JAX package's)")
        return None
    d = [np.abs(a.astype(np.int16) - b.astype(np.int16)) for a, b in
         zip(frames, pil)]
    worst = max(int(x.max()) for x in d)
    log(f"  Pillow's libjpeg decode hashes to the JAX package's; the port's "
        f"frames differ from it by at most {worst} (of 255), "
        f"{np.mean([(x > 0).mean() for x in d]):.4f} of the bytes differ, "
        f"mean |d| {np.mean([x.mean() for x in d]):.4f}")
    return worst


def checkpoint_phase(dev, out_dir):
    """7b: the bench weights as a port checkpoint (``Checkpointer.save``
    from the card) read back by ``load_model_file`` (what ``--model-file``
    calls), bit for bit.  Returns the checkpoint's path."""
    from siammot_tpu_torch.configs.defaults import get_cfg
    from siammot_tpu_torch.models.siammot import SiamMOT
    from siammot_tpu_torch.utils.checkpoint import (Checkpointer,
                                                    load_model_file)
    from siammot_tpu_torch.utils.dataset_golden import WEIGHTS
    from siammot_tpu_torch.utils.weights import jax_to_torch, load_npz
    sd = jax_to_torch(load_npz(WEIGHTS))
    path = Checkpointer(out_dir).save(0, {k: v.to(dev) for k, v in
                                          sd.items()})
    back = load_model_file(path, SiamMOT(get_cfg(), device=str(dev)))
    bad = [k for k in sd if k not in back or back[k].dtype != sd[k].dtype
           or not torch.equal(back[k], sd[k])]
    if bad or set(back) != set(sd):
        raise AssertionError(f"checkpoint round trip: {len(bad)} tensors "
                             f"differ, e.g. {bad[:3]}")
    log(f"  {len(sd)} tensors saved from the card to "
        f"{os.path.basename(path)} ({os.path.getsize(path)} B) and read "
        f"back bit for bit")
    return path


def dataset_run(dev, report, card, run, out_dir, model_file, check=True):
    """One run of ``utils/dataset_golden.RUNS`` through the port's
    ``tools/test_net`` main function on the card: 4 kernels' launches a
    frame, each kernel against its plain version on the last frame's
    inputs (with ``check``), then a second call that reads the per-video
    cache and runs no frame.  Returns (frames per second, the
    ``DatasetInference``)."""
    from siammot_tpu_torch.tools import test_net
    from siammot_tpu_torch.utils import dataset_golden as dg
    args = dg.cli_args(run, out_dir, model_file, device=str(dev))
    with kernel_capture() as (captured, launches):
        inf = test_net.main(args)
    what = f"dataset_{run}"
    n, seconds = inf.speed[dg.VIDEO]
    counts = check_launches(launches, MAIN_PATH, n)
    for name, count in counts.items():
        report[name].setdefault("launches_by_path", {})[what] = count
        report[name]["launches"] = report[name].get("launches", 0) + count
    if check:
        check_captured(captured, report, what)
    with kernel_capture() as (_, again):
        cached = test_net.main(args)
    if any(again.values()) or cached.speed \
            or dg.summaries(cached.accs) != dg.summaries(inf.accs):
        raise AssertionError(f"{run}: the second call did not read the "
                             f"cache ({again}, {cached.speed})")
    log(f"  {what}: {n} frames, Speed {n / seconds:.3f} fps ({card}; first "
        f"frame included); launches {counts}; cache read back with no "
        f"frame step")
    return n / seconds, inf


@contextlib.contextmanager
def jax_bytes_reader():
    """The frames as the JAX package decoded them, in place of the port's
    reader: Pillow's bundled libjpeg, whose digests of the committed
    sequence ``libjpeg_byte_difference`` checked against the JAX
    package's, resized (where needed) by the port's bilinear.  Only the
    check that separates the decoder from the rest of the path uses it."""
    from PIL import Image

    from siammot_tpu_torch.data import native

    class PillowReader:
        decoder = "Pillow's libjpeg"

        def __init__(self, device="cpu"):
            pass

        def decode(self, path, out_w, out_h):
            img = np.array(Image.open(path).convert("RGB"))
            if img.shape[:2] == (out_h, out_w):
                return img
            return native.resize_u8(img, out_w, out_h)

        def decode_normalize(self, path, out_w, out_h, mean, std):
            img = np.array(Image.open(path).convert("RGB"))
            return native.resize_normalize(img, out_w, out_h, mean, std)

    port_reader = native.FrameReader
    native.FrameReader = PillowReader
    try:
        yield
    finally:
        native.FrameReader = port_reader


def dataset_phase(dev, report, card):
    """Phase 7: dataset inference over ``tests/fixtures/synmot_mini``
    through ``tools/test_net`` on the card: 7a decode, 7b checkpoint, 7c
    the bf16 runs (each kernel against its plain version on the last
    frame's inputs; summaries beside the JAX golden's), 7d the f32 runs,
    held to the JAX golden (``utils/dataset_golden.py``): on libjpeg's
    frames (the JAX package's bytes) per-video JSON, tracks and summary
    within the CPU's tolerances; on nvJPEG's the summary within
    ``DECODED_ELSEWHERE_ATOL``, and then also on the JAX package's bytes
    (Pillow's libjpeg, where this machine has it) within the CPU's
    tolerances."""
    from siammot_tpu_torch.data.motion_dataset import DataSample
    from siammot_tpu_torch.tools import test_net
    from siammot_tpu_torch.utils import dataset_golden as dg
    golden = dg.load()["runs"]
    out = {}

    def hold_exact(run, inf, out_dir, what):
        pred = DataSample.load(os.path.join(out_dir,
                                            f"{dg.VIDEO}.json")).to_dict()
        err = dg.compare_samples(pred, golden[run]["predictions"][dg.VIDEO],
                                 what)
        terr = dg.compare_samples(inf.results[dg.VIDEO].to_dict(),
                                  golden[run]["tracks"][dg.VIDEO],
                                  f"{what} tracks")
        serr = dg.compare_summaries(dg.summaries(inf.accs),
                                    golden[run]["summary"], what)
        log(f"    {what} held to the JAX golden: {len(pred['entities'])} "
            f"entities, ids, frames and labels exact, max box err "
            f"{err['box']:.4g} px, max confidence err {err['conf']:.4g} "
            f"(tracks {terr['box']:.4g} px, {terr['conf']:.4g}); summary "
            f"max diff {serr:.3g}")

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        log("[7a] decode:")
        decoder, _, byte_diff = decode_phase(dev)
        log("[7b] checkpoint round trip on the card:")
        ckpt = checkpoint_phase(dev, os.path.join(tmp, "ckpt"))
        for step, dtype in (("7c", "bf16"), ("7d", "f32")):
            log(f"[{step}] {dtype}: public-detection and RPN mode "
                f"({decoder} frames):")
            for mode in dg.MODES:
                run = f"{mode}_{dtype}"
                out_dir = os.path.join(tmp, run)
                # the f32 runs are held to the JAX golden, which their rows
                # must meet, in place of the kernel checks
                fps, inf = dataset_run(dev, report, card, run, out_dir, ckpt,
                                       check=dtype == "bf16")
                got = dg.summaries(inf.accs)
                log(f"    port {dg.summary_line(got['OVERALL'])}")
                log(f"    JAX  "
                    f"{dg.summary_line(golden[run]['summary']['OVERALL'])}")
                out[run] = (fps, got["OVERALL"])
                if dtype == "bf16":
                    continue
                if decoder == "libjpeg":
                    hold_exact(run, inf, out_dir, run)
                    continue
                d = dg.compare_summary_band(got, golden[run]["summary"], run)
                log(f"    {run} on {decoder}'s frames (largest byte "
                    f"difference {byte_diff}): MOTA {d['mota']:.4f} and IDF1 "
                    f"{d['idf1']:.4f} from JAX's (limit "
                    f"{dg.DECODED_ELSEWHERE_ATOL})")
                if byte_diff is None:
                    log(f"    {run} on the JAX package's bytes: not measured "
                        f"(no Pillow whose decode is the JAX package's)")
                    continue
                jax_dir = os.path.join(tmp, f"{run}_jax_bytes")
                with jax_bytes_reader(), kernel_capture() as (_, launches):
                    jinf = test_net.main(dg.cli_args(run, jax_dir, ckpt,
                                                     device=str(dev)))
                counts = check_launches(launches, MAIN_PATH,
                                        jinf.speed[dg.VIDEO][0])
                for name, count in counts.items():
                    report[name]["launches_by_path"][f"dataset_{run}_jax"] = \
                        count
                    report[name]["launches"] += count
                hold_exact(run, jinf, jax_dir, f"{run} (JAX's bytes)")
        log(f"  phase 7 wall time {time.perf_counter() - t0:.1f} s")
    return out


# -- phase 8: multi-stream inference ----------------------------------------

MS_LANES, MS_FRAMES = 4, 6        # 8a: 720p crowd streams, frames each
MS_SWEEP = (1, 2, 4, 8, 16)       # 8b: streams a batched step
MS_WARMUP, MS_TIMED = 3, 8        # 8b: steps a stream count
MS_SCENES, MS_SCENE_FRAMES = 4, 16


def ms_scenes():
    """The crowd scene with seeds 42 + i, i < MS_SCENES, 16 frames each."""
    from siammot_tpu_torch.utils.synth import render_scene
    return [render_scene(MS_SCENE_FRAMES, HP, 42 + i)[0]
            for i in range(MS_SCENES)]


def ms_batch(scenes, n, t):
    """Step ``t``'s frames of ``n`` streams, uint8 [n, 1, HP, W, 3]: lane
    i shows scene i % MS_SCENES, shifted 3 frames a round of four."""
    return np.stack([scenes[i % MS_SCENES][(t + 3 * (i // MS_SCENES))
                                           % MS_SCENE_FRAMES]
                     for i in range(n)])


def ms_runs(model, net, scenes, dev):
    """MS_LANES streams of MS_FRAMES frames, each lane on its own through
    ``forward_inference`` and all as lanes of ``forward_streams`` (its
    kernels captured): per lane and frame (rows, state) as numpy, and the
    batched run's captured inputs and launch counts."""
    from siammot_tpu_torch.parallel.multistream import empty_states
    seq = []
    for i in range(MS_LANES):
        state, lane = model.empty_state(), []
        for t in range(MS_FRAMES):
            out, state = model.forward_inference(
                net, torch.as_tensor(scenes[i][t]).to(dev), state, (W, H))
            lane.append((out.numpy(), state.numpy()))
        seq.append(lane)
    states, batched = empty_states(model, MS_LANES), []
    with kernel_capture() as (captured, launches):
        for t in range(MS_FRAMES):
            out, states = model.forward_streams(
                net, torch.as_tensor(ms_batch(scenes, MS_LANES, t)).to(dev),
                states, (W, H))
            batched.append((out.numpy(), states.numpy()))
    return seq, batched, captured, launches


def ms_lane_gap(seq, batched):
    """Each lane of the batched run against its own run: mask and integer
    mismatches (rows and state lanes), the largest box and score errors
    on rows valid in both, the largest state box error; and, with rows
    matched by IoU as ``golden.matched_gap`` matches them (rows that move
    between lanes and runs: the bf16 gap), the rows without a match of
    IoU >= 0.5, the track ids that differ and the largest box error of
    the matched rows, on the first frame and over all."""
    from siammot_tpu_torch.utils import golden
    r = dict(valid_mismatch=0, int_mismatch=0, box_err=0.0, score_err=0.0,
             state_mismatch=0, state_box_err=0.0, rows=0)
    m = dict(unmatched=0, ids_differ=0, box_err=0.0, first_unmatched=0,
             first_ids_differ=0, first_box_err=0.0)
    for i, lane in enumerate(seq):
        for t, (o, st) in enumerate(lane):
            bo, bs = batched[t]
            g = {k: v[i] for k, v in bo.items()}
            r["valid_mismatch"] += int((g["valid"] != o["valid"]).sum())
            both = g["valid"] & o["valid"]
            r["rows"] += int(o["valid"].sum())
            r["int_mismatch"] += int(sum(
                (g[f][both] != o[f][both]).sum() for f in ("ids", "labels")))
            if both.any():
                r["box_err"] = max(r["box_err"], float(np.abs(
                    g["boxes"][both] - o["boxes"][both]).max()))
                r["score_err"] = max(r["score_err"], float(np.abs(
                    g["scores"][both] - o["scores"][both]).max()))
            r["state_mismatch"] += int(sum(
                np.sum(bs[f][i] != st[f]) for f in golden.STATE_EXACT))
            r["state_box_err"] = max(r["state_box_err"], *(float(np.abs(
                bs[f][i] - st[f]).max()) for f in ("boxes", "sr")))
            ov, gv = o["valid"].nonzero()[0], g["valid"].nonzero()[0]
            if not len(ov):
                continue
            unmatched, differ, err = len(ov), 0, 0.0
            if len(gv):
                iou = golden._iou(o["boxes"][ov], g["boxes"][gv])
                best = iou.argmax(1)
                ok = iou[np.arange(len(ov)), best] >= 0.5
                oi, gi = ov[ok], gv[best[ok]]
                unmatched = int((~ok).sum())
                tracked = (o["ids"][oi] >= 0) | (g["ids"][gi] >= 0)
                differ = int((o["ids"][oi] != g["ids"][gi])[tracked].sum())
                if len(oi):
                    err = float(np.abs(o["boxes"][oi]
                                       - g["boxes"][gi]).max())
            m["unmatched"] += unmatched
            m["ids_differ"] += differ
            m["box_err"] = max(m["box_err"], err)
            if t == 0:
                m["first_unmatched"] += unmatched
                m["first_ids_differ"] += differ
                m["first_box_err"] = max(m["first_box_err"], err)
    r["ok"] = (r["valid_mismatch"] == 0 and r["int_mismatch"] == 0
               and r["state_mismatch"] == 0
               and r["box_err"] <= golden.BOX_ATOL
               and r["score_err"] <= golden.SCORE_ATOL
               and r["state_box_err"] <= 2 * golden.BOX_ATOL)
    r["matched"] = m
    return r


def ms_count(report, launches, what):
    """Add a phase-8 run's launches to the ``multistream`` path."""
    for name in MAIN_PATH:
        by = report[name].setdefault("launches_by_path", {})
        by["multistream"] = by.get("multistream", 0) + launches[name]
        report[name]["launches"] += launches[name]
    log(f"    {what}: launches "
        + ", ".join(f"{n} {launches[n]}" for n in MAIN_PATH))


def ms_lanes_phase(dev, report, scenes, params):
    """8a: f32 lanes against their own runs within ``utils/golden.py``'s
    tolerances (ids and integer lanes exactly); the bf16 gap; kernels 1-4
    against their plain versions on the last bf16 batched step's
    S x 128-slot inputs."""
    from siammot_tpu_torch.configs.defaults import get_cfg
    from siammot_tpu_torch.models.siammot import SiamMOT
    from siammot_tpu_torch.utils import golden
    for dtype in ("float32", "bfloat16"):
        cfg = get_cfg()
        cfg.merge_from_list(golden.overrides(dtype))
        model = SiamMOT(cfg, device=str(dev))
        net = model.cast_params(params)
        seq, batched, captured, launches = ms_runs(model, net, scenes, dev)
        check_launches(launches, MAIN_PATH, MS_FRAMES)
        ms_count(report, launches, f"{dtype} batched run, {MS_LANES} "
                 f"streams x {MS_FRAMES} steps")
        gap = ms_lane_gap(seq, batched)
        live = int((batched[-1][1]["ids"] >= 0).sum())
        log(f"  {dtype}: {MS_LANES} streams x {MS_FRAMES} frames, {live} "
            f"live slots of {MS_LANES * K} at the end; each lane against "
            f"its own run: {gap}")
        if dtype == "float32" and not gap["ok"]:
            raise AssertionError(f"f32 lanes differ from their own runs "
                                 f"beyond utils/golden.py's tolerances: "
                                 f"{gap}")
    check_captured(captured, report, f"multistream bf16 ({MS_LANES} x {K} "
                   f"slots)")
    log(f"  kernels 1-4 agree with their plain versions on the last "
        f"batched step's inputs "
        f"({int(captured['xcorr_masked'][0][2].sum())} live of "
        f"{captured['xcorr_masked'][0][2].numel()} slots)")


def ms_sync_count(model, net, states, images):
    """Host synchronisations of one batched step, counted by
    ``torch.cuda.set_sync_debug_mode`` (one warning each) and by the
    Python line that made each; and the NMS convergence checks and
    extra rounds in it."""
    import warnings
    from collections import Counter

    from siammot_tpu_torch.core.nms import nms_mask
    syncs0, extra0 = nms_mask.syncs, nms_mask.extra_rounds
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            model.forward_streams(net, images, states, (W, H))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = Counter(f"{os.path.relpath(w.filename, REPO)}:{w.lineno}"
                    for w in caught if "called a synchronizing CUDA "
                    "operation" in str(w.message))
    return (sum(sites.values()), nms_mask.syncs - syncs0,
            nms_mask.extra_rounds - extra0, dict(sites))


def ms_sweep_phase(dev, report, card, scenes, params):
    """8b: the batched step at S = 1, 2, 4, 8, 16 streams, bf16, bench
    weights: MS_WARMUP + MS_TIMED steps each, the frames uploaded from
    pinned memory each step and the step timed to the end of its device
    work, as ``track_frames`` times a frame; kernel launches and host
    synchronisations per step."""
    from siammot_tpu_torch.configs.defaults import get_cfg
    from siammot_tpu_torch.core.nms import FORI_ROUNDS
    from siammot_tpu_torch.models.siammot import SiamMOT
    from siammot_tpu_torch.parallel.multistream import empty_states
    model = SiamMOT(get_cfg(), device=str(dev))
    net = model.cast_params(params)
    out, syncs = {}, {}
    for n in MS_SWEEP:
        batches = [torch.as_tensor(ms_batch(scenes, n, t)).pin_memory()
                   for t in range(MS_WARMUP + MS_TIMED + 1)]
        states = empty_states(model, n)
        for t in range(MS_WARMUP):
            _, states = model.forward_streams(
                net, batches[t].to(dev, non_blocking=True), states, (W, H))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sec = []
        with kernel_capture() as (_, launches):
            for t in range(MS_WARMUP, MS_WARMUP + MS_TIMED):
                t0 = time.perf_counter()
                _, states = model.forward_streams(
                    net, batches[t].to(dev, non_blocking=True), states,
                    (W, H))
                torch.cuda.synchronize()
                sec.append(time.perf_counter() - t0)
        check_launches(launches, MAIN_PATH, MS_TIMED)
        ms_count(report, launches, f"S = {n}, {MS_TIMED} timed steps")
        peak = torch.cuda.max_memory_allocated()
        ms = 1e3 * float(np.mean(sec))
        live = int(states.occupied.sum())
        out[n] = dict(fps=n * 1e3 / ms, ms_step=ms,
                      median_ms=1e3 * float(np.median(sec)), live=live,
                      peak_gib=peak / 2 ** 30)
        log(f"  S = {n:2d}: {out[n]['fps']:.3f} fps aggregate, "
            f"{ms:.3f} ms/step (median {out[n]['median_ms']:.3f}), "
            f"{ms / n:.3f} ms/frame, {live} live slots of {n * K}, peak "
            f"{peak / 2 ** 30:.3f} GiB ({card})")
        if n in (1, 8):
            images = batches[-1].to(dev, non_blocking=True)
            torch.cuda.synchronize()
            syncs[n] = ms_sync_count(model, net, states, images)
            log(f"    S = {n}: {syncs[n][0]} host synchronisations in one "
                f"step (set_sync_debug_mode), of which NMS convergence "
                f"checks {syncs[n][1]}, {syncs[n][2]} of them rounds past "
                f"the first {FORI_ROUNDS}; by line: {syncs[n][3]}")
    # none a stream: S = 8 may add only NMS rounds to S = 1's count
    if syncs[8][0] - syncs[8][2] > syncs[1][0] - syncs[1][2]:
        raise AssertionError(f"host synchronisations a step beyond the NMS "
                             f"rounds: {syncs[1][:3]} at S = 1, "
                             f"{syncs[8][:3]} at S = 8 (one a stream?)")
    return out, syncs


def ms_dataset_phase(dev, report, card):
    """8c: ``tools/test_net --n-streams 2`` over ``tests/fixtures/
    synmot_multi`` in f32, both modes: on the JAX package's bytes
    (Pillow's libjpeg, where its decode hashes to the JAX package's)
    held to ``tests/fixtures/torch_golden_multistream.json.gz`` within the
    CPU's tolerances; on nvJPEG's frames (one reader a stream) the
    CLEAR-MOT summary within ``DECODED_ELSEWHERE_ATOL``."""
    from siammot_tpu_torch.data.video_loader import jpeg_files
    from siammot_tpu_torch.engine.multistream_inferencer import (
        pack_waves, wave_lane_steps)
    from siammot_tpu_torch.tools import test_net
    from siammot_tpu_torch.utils import dataset_golden as dg
    want = dg.load(dg.MULTI_FIXTURE)
    n_frames = {v: len(d) for v, d in want["frames"].items()}
    waves = pack_waves([(v, range(n)) for v, n in n_frames.items()],
                       dg.MULTI_STREAMS)
    steps = wave_lane_steps(waves, dg.MULTI_STREAMS) // dg.MULTI_STREAMS
    try:
        from PIL import Image
        pil = {v: dg.frame_digests(
            np.asarray(Image.open(f).convert("RGB"))[None]
            for f in jpeg_files(os.path.join(dg.ROOT_DIR, "synmot_multi",
                                             "test", v, "img1")))
            for v in n_frames}
        jax_bytes = pil == want["frames"]
    except ImportError:
        jax_bytes = False
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for run in dg.MULTI_RUNS:
            golden = want["runs"][run]
            for reader in ("nvJPEG", "JAX bytes"):
                if reader == "JAX bytes" and not jax_bytes:
                    log(f"    {run} on the JAX package's bytes: not measured "
                        f"(no Pillow whose decode is the JAX package's)")
                    continue
                out_dir = os.path.join(tmp, f"{run}_{reader[:3]}")
                args = dg.cli_args(run, out_dir, dg.WEIGHTS, str(dev),
                                   dg.MULTI_STREAMS)
                ctx = jax_bytes_reader() if reader == "JAX bytes" \
                    else contextlib.nullcontext()
                with ctx, kernel_capture() as (_, launches):
                    inf = test_net.main(args)
                check_launches(launches, MAIN_PATH, steps)
                ms_count(report, launches, f"{run} ({reader}), {steps} "
                         f"steps of {dg.MULTI_STREAMS} streams")
                frames = sum(n for n, _ in inf.speed.values())
                seconds = sum(s_ for _, s_ in inf.speed.values())
                got = dg.summaries(inf.accs)
                log(f"    {run} ({reader}): {frames} frames in "
                    f"{seconds:.3f} s, {frames / seconds:.3f} fps ({card}); "
                    f"port {dg.summary_line(got['OVERALL'])}")
                log(f"    {' ' * len(run)}  JAX  "
                    f"{dg.summary_line(golden['summary']['OVERALL'])}")
                if frames != sum(n_frames.values()):
                    raise AssertionError(f"{run}: {frames} frames tracked")
                if reader == "nvJPEG":
                    d = dg.compare_summary_band(got, golden["summary"], run)
                    log(f"    MOTA {d['mota']:.4f} and IDF1 {d['idf1']:.4f} "
                        f"from JAX's (limit {dg.DECODED_ELSEWHERE_ATOL})")
                    out[run] = frames / seconds
                    continue
                for v in n_frames:
                    with open(os.path.join(out_dir, f"{v}.json")) as f:
                        pred = dg.compare_samples(
                            json.load(f), golden["predictions"][v],
                            f"{run} {v}")
                    dg.compare_samples(inf.results[v].to_dict(),
                                       golden["tracks"][v],
                                       f"{run} {v} tracks")
                    log(f"      {v}: {n_frames[v]} frames held to the JAX "
                        f"golden (max box err {pred['box']:.4g} px, "
                        f"confidence {pred['conf']:.4g})")
                serr = dg.compare_summaries(got, golden["summary"], run)
                log(f"    summary max diff {serr:.3g}")
    return out


def multistream_phase(dev, report, card):
    """Phase 8: 8a lanes, 8b the stream sweep, 8c dataset inference."""
    from siammot_tpu_torch.utils.weights import jax_to_torch, load_npz
    t0 = time.perf_counter()
    scenes = ms_scenes()
    params = jax_to_torch(load_npz(FIXTURE))
    log(f"  {MS_SCENES} scenes of {MS_SCENE_FRAMES} frames ready in "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"[8a] {MS_LANES} streams as lanes of one step against their own "
        f"runs (f32 gated, bf16 gap):")
    ms_lanes_phase(dev, report, scenes, params)
    log(f"[8b] the batched step at S = {MS_SWEEP}, bf16:")
    sweep, syncs = ms_sweep_phase(dev, report, card, scenes, params)
    log("[8c] tools/test_net --n-streams 2 over tests/fixtures/synmot_multi, "
        "f32:")
    dataset = ms_dataset_phase(dev, report, card)
    log(f"  phase 8 wall time {time.perf_counter() - t0:.1f} s")
    return sweep, syncs, dataset


# -- phase 9: training through tools/train_net --------------------------------

TRAIN_NET_ITERS, TRAIN_NET_PERIOD = 12, 6
TRAIN_KEYS = ("SYNMOT_MULTI_TRAIN", "SYNCROWD_MINI_train_fbox")
TRAIN_FIXTURES = os.path.join(REPO, "tests", "fixtures")
LOADER_WARMUP, LOADER_TIMED = 3, 20
JPEG_FIXTURE = os.path.join(TRAIN_FIXTURES, "jpeg_roundtrip.npz")
GT_FIELDS = ("boxes", "scores", "ids", "labels", "valid")


def batch_digest(batch) -> str:
    """sha256 of a loader batch: image bytes, gt fields and sizes."""
    images, gt, sizes = batch
    h = hashlib.sha256(images.numpy().tobytes())
    for f in GT_FIELDS:
        h.update(getattr(gt, f).numpy().tobytes())
    h.update(sizes.numpy().tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def digesting_loader(digests):
    """Record the digest of each batch ``tools/train_net``'s loader yields,
    by the iteration that consumes it, into ``digests``."""
    import siammot_tpu_torch.data.build as build_mod
    orig = build_mod.build_train_data_loader

    def wrapped(cfg, start_iter=0, **kw):
        loader = orig(cfg, start_iter=start_iter, **kw)

        class Digesting:
            def __iter__(self):
                for it, batch in enumerate(loader, start_iter + 1):
                    digests[it] = batch_digest(batch)
                    yield batch
        return Digesting()

    build_mod.build_train_data_loader = wrapped
    try:
        yield
    finally:
        build_mod.build_train_data_loader = orig


def train_net_args(train_dir, dev):
    """9a's command line: the SYNMOT_HARD recipe (2 clips a batch, 384x640
    static input, bf16 compute and f32 masters) over the committed
    training fixture, from the bench weights."""
    return ["--config-file", os.path.join(REPO, "configs", "dla",
                                          "DLA_34_FPN_EMM_SYNMOT_HARD.yaml"),
            "--train-dir", train_dir, "--device", str(dev),
            "DATASETS.ROOT_DIR", TRAIN_FIXTURES,
            "DATASETS.TRAIN", repr(TRAIN_KEYS), "MODEL.WEIGHT", FIXTURE,
            "SOLVER.MAX_ITER", str(TRAIN_NET_ITERS),
            "SOLVER.CHECKPOINT_PERIOD", str(TRAIN_NET_PERIOD),
            "SOLVER.WARMUP_ITERS", "2"]


@contextlib.contextmanager
def quiet_console():
    """The port's INFO lines (``train_net`` logs its whole configuration)
    go to the run's ``log.txt`` only, not to this script's output."""
    import logging
    root = logging.getLogger()
    added = logging.StreamHandler() if not root.handlers else None
    if added is not None:
        root.addHandler(added)
    levels = [(h, h.level) for h in root.handlers]
    for h, _ in levels:
        h.setLevel(logging.WARNING)
    try:
        yield
    finally:
        for h, level in levels:
            h.setLevel(level)
        if added is not None:
            root.removeHandler(added)


def train_net_run(dev, report, card, train_dir, steps, what):
    """One ``tools/train_net`` call with every training kernel counted;
    returns (run dir, TrainLog, loader digests by iteration, the losses
    logged at the last iteration, kernel captures)."""
    from siammot_tpu_torch.engine.tensorboard_writer import read_events
    from siammot_tpu_torch.tools import train_net

    digests = {}
    t0 = time.perf_counter()
    with quiet_console(), digesting_loader(digests), \
            train_kernel_capture(steps) as (captured, launches):
        torch.cuda.reset_peak_memory_stats(dev)
        out, tlog = train_net.main(train_net_args(train_dir, dev))
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
    wall = time.perf_counter() - t0
    ran = len(tlog.step_seconds)
    if tlog.iteration != TRAIN_NET_ITERS or ran != steps:
        raise AssertionError(f"{what}: ran {ran} steps to iteration "
                             f"{tlog.iteration}, expected {steps} to "
                             f"{TRAIN_NET_ITERS}")
    count_train_launches(launches, steps, report, "train_net")
    for f in (f"model_{TRAIN_NET_PERIOD:07d}.pth", "model_final.pth",
              "config.yaml", "log.txt"):
        if not os.path.exists(os.path.join(out, f)):
            raise AssertionError(f"{what}: no {f} in {out}")
    tb = [f for f in os.listdir(os.path.join(out, "tb"))
          if f.startswith("events.out.tfevents.")]
    losses = {}
    for f in tb:
        for ev in read_events(os.path.join(out, "tb", f)):
            for tag, v in ev["scalars"].items():
                if ev["step"] == TRAIN_NET_ITERS:
                    losses[tag] = v
    if len(losses) != 8 or not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"{what}: the event file's losses at iteration "
                             f"{TRAIN_NET_ITERS}: {losses}")
    sec = np.array(tlog.step_seconds[2:] if ran > 4 else tlog.step_seconds)
    log(f"  {what}: {ran} steps to iteration {tlog.iteration} in {wall:.1f} "
        f"s wall: {sec.mean():.4f} s/it (median {np.median(sec):.4f}, "
        f"{'after 2' if ran > 4 else 'all steps'}), loader wait a step "
        f"(data meter) median {1e3 * np.median(tlog.data_seconds):.3f} ms, "
        f"max {1e3 * max(tlog.data_seconds):.3f} ms; peak device memory "
        f"{peak / 2 ** 30:.3f} GiB ({card}); launches {launches}")
    return out, tlog, digests, losses, captured, peak


def jpeg_roundtrip_gap(dev):
    """nvJPEG's round trip (encode, decode) of the committed crops against
    libjpeg's, which ``tests/torch_jpeg_fixture.py`` stored from the JAX
    transform's ``cv2`` calls: per quality the largest byte difference, the
    share of bytes that differ, the mean difference, and each route's mean
    difference from the crop itself."""
    from siammot_tpu_torch.data import native
    z = np.load(JPEG_FIXTURE)
    crops = z["crops"]
    out = {}
    for q in (50, 75, 100):
        want = crops.astype(np.int16) + z[f"q{q}"]
        got = np.stack([native.jpeg_roundtrip(c, q, dev) for c in crops])
        again = np.stack([native.jpeg_roundtrip(c, q, dev) for c in crops])
        if not np.array_equal(got, again):
            raise AssertionError(f"nvJPEG's round trip at quality {q} is "
                                 f"not repeatable")
        d = np.abs(got.astype(np.int16) - want)
        # each route's own loss: its round trip against the crop
        loss = (float(np.abs(got.astype(np.int16) - crops).mean()),
                float(np.abs(z[f"q{q}"].astype(np.int16)).mean()))
        out[q] = (int(d.max()), float((d > 0).mean()), float(d.mean()), loss)
    return out


def loader_phase(dev, card):
    """9c: the loader alone under ``configs/dla/DLA_34_FPN_EMM.yaml``'s
    INPUT and batch (16 clips, short side 640-960, long side to 1280, 8
    workers) over the training fixture, decoding and compressing with
    nvJPEG: clips per second and ms a batch over ``LOADER_TIMED`` batches
    after ``LOADER_WARMUP``."""
    from siammot_tpu_torch.configs.defaults import get_cfg
    from siammot_tpu_torch.data.build import build_train_data_loader
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "dla",
                                     "DLA_34_FPN_EMM.yaml"))
    cfg.merge_from_list(["DATASETS.ROOT_DIR", TRAIN_FIXTURES,
                         "DATASETS.TRAIN", TRAIN_KEYS, "SOLVER.MAX_ITER",
                         LOADER_WARMUP + LOADER_TIMED])
    clips = cfg.SOLVER.VIDEO_CLIPS_PER_BATCH
    times, shapes = [], set()
    t = t0 = time.perf_counter()
    for images, gt, sizes in build_train_data_loader(cfg, device=dev):
        now = time.perf_counter()
        times.append(now - t)
        t = now
        shapes.add(tuple(images.shape))
        if dev.type == "cuda" and not images.is_pinned():
            raise AssertionError("9c: the loader's images are not pinned")
    if len(times) != LOADER_WARMUP + LOADER_TIMED:
        raise AssertionError(f"9c: {len(times)} batches")
    timed = np.array(times[LOADER_WARMUP:])
    out = dict(clips_per_s=clips * LOADER_TIMED / timed.sum(),
               ms_batch=1e3 * timed.mean(), ms_batch_median=1e3 * np.median(
                   timed), first_s=times[0])
    log(f"  {clips} clips a batch (MIN_SIZE_TRAIN "
        f"{tuple(cfg.INPUT.MIN_SIZE_TRAIN)}, MAX_SIZE_TRAIN "
        f"{cfg.INPUT.MAX_SIZE_TRAIN}), {cfg.DATALOADER.NUM_WORKERS} workers, "
        f"{os.cpu_count()} host cores: {out['clips_per_s']:.3f} clips/s, "
        f"{out['ms_batch']:.3f} ms a batch (median "
        f"{out['ms_batch_median']:.3f}) over {LOADER_TIMED} batches after "
        f"{LOADER_WARMUP} (first batch {times[0]:.2f} s, whole run "
        f"{time.perf_counter() - t0:.2f} s); padded shapes "
        f"{sorted(shapes)} ({card})")
    return out


def train_net_phase(dev, report, card):
    """Phase 9: 9a a training run through ``tools/train_net``'s main
    function, 9b its resume from iteration 6, 9c the loader alone."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        log(f"[9a] train_net: {TRAIN_NET_ITERS} iterations, checkpoints every "
            f"{TRAIN_NET_PERIOD}:")
        out, _, digests, losses, captured, peak = train_net_run(
            dev, report, card, tmp, TRAIN_NET_ITERS, "9a")
        log("  kernels against their plain versions on the last step's "
            "inputs:")
        check_train_kernels(captured, report, "train_net")
        log(f"[9b] resume at iteration {TRAIN_NET_PERIOD}:")
        for f in (f"model_{TRAIN_NET_ITERS:07d}.pth", "model_final.pth"):
            os.remove(os.path.join(out, f))
        out2, _, digests2, losses2, _, _ = train_net_run(
            dev, report, card, tmp, TRAIN_NET_ITERS - TRAIN_NET_PERIOD, "9b")
        if out2 != out:
            raise AssertionError(f"9b ran in {out2}, not {out}")
        resumed = list(range(TRAIN_NET_PERIOD + 1, TRAIN_NET_ITERS + 1))
        if sorted(digests2) != resumed:
            raise AssertionError(f"9b loaded iterations {sorted(digests2)}")
        same = [it for it in resumed if digests2[it] == digests[it]]
        if len(same) != len(resumed):
            raise AssertionError(f"9b: loader batches of iterations "
                                 f"{sorted(set(resumed) - set(same))} differ "
                                 f"from 9a's")
        log(f"  loader batches of iterations {resumed[0]}-{resumed[-1]}: "
            f"sha256 equal to 9a's ({len(same)} of {len(resumed)})")
        log(f"  losses at iteration {TRAIN_NET_ITERS}, 9a -> 9b (not gated: "
            f"cuDNN is not bitwise): " + ", ".join(
                f"{k} {losses[k]:.4f} -> {losses2[k]:.4f}"
                for k in sorted(losses)))
    log("[9c] the loader alone (nvJPEG decode and JPEG round trip):")
    loader = loader_phase(dev, card)
    gap = jpeg_roundtrip_gap(dev)
    log("  nvJPEG's JPEG round trip against libjpeg's (cv2's) on the "
        "committed crops: " + ", ".join(
            f"quality {q}: max byte difference {m}, {100 * f:.3f}% of bytes "
            f"differ, mean {a:.4f} (mean from the crop: nvJPEG {nl:.4f}, "
            f"libjpeg {ll:.4f})" for q, (m, f, a, (nl, ll)) in gap.items()))
    log(f"  phase 9 wall time {time.perf_counter() - t0:.1f} s")
    return dict(loader=loader, gap=gap, peak=peak)


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
    hgmma = wgmma_instructions(cuda_lib)
    log(f"  warpgroup MMA (HGMMA) instructions in the machine code: "
        f"{hgmma}")
    CELL.update(cell_instructions(cuda_lib))
    log(f"  the decode's cell_value() in the machine code: {CELL['fp32']} "
        f"FP32-pipe and {CELL['mufu']} MUFU instructions of {CELL['all']} "
        f"(decode_cell_probe up to its EXIT: {CELL['ops']})")

    report = {n: dict(name=n, route="cuda", launches=0, max_abs_err=0.0,
                      **meta)
              for n, meta in KERNELS.items()}
    t0 = time.perf_counter()
    log("[2] kernels against their plain versions, main-path shapes:")
    kernel_phase(dev, report)
    log(f"[2] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[2c] kernels 3 and 4 at the f32 and AOT-recipe shapes:")
    reshaped_kernel_phase(dev, report)
    log(f"[2c] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[2d] kernel 9 (deformable conv) at DLA-102's stage shapes:")
    deform_kernel_phase(dev, report)
    log(f"[2d] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[2e] kernels 10 (unmasked decode), 5 (striped decode) and 8 "
        "(slot-blocked predictor):")
    variants_kernel_phase(dev, report)
    log(f"[2e] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[2b] training kernels against their plain versions, training "
        "shapes:")
    train_kernel_phase(dev, report)
    log(f"[2b] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[3] end to end: DLA-34-FPN-EMM, bench weights, 720p crowd:")
    ms_frame, occupied = end_to_end_phase(dev, report)
    log(f"[3] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[3b] DLA-34 against the JAX step's rows (f32 on the card; bf16 "
        "gap):")
    golden_phase(dev)
    log(f"[3b] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[3c] the given, unmasked and SEARCH_REGION 5 cuts against the JAX "
        "step's rows (f32 on the card; bf16 gap):")
    golden_toggles_phase(dev)
    log(f"[3c] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[4] training end to end: DLA-34-FPN-EMM, f32 masters, bf16 "
        "compute, 2 clips x 2 frames of the 720p crowd:")
    ms_step, med_step, peak = train_phase(dev, report, card)
    log(f"[4] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log(f"[4b] training end to end at SEARCH_REGION 5 (a 75x75 search "
        f"region; full width and depth, {WIDE_WARMUP} + {WIDE_TIMED} steps):")
    ms_wide, _, peak_wide = train_phase(
        dev, report, card, path="wide_sr_training",
        overrides=("MODEL.TRACK_HEAD.SEARCH_REGION", 5.0),
        warmup=WIDE_WARMUP, timed=WIDE_TIMED)
    log(f"[4b] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[5] end to end: DLA-102-DCN-FPN, seeded weights, bf16, 720p "
        "crowd:")
    ms_dcn, occ_dcn, routes = dcn_phase(dev, report, card)
    log(f"[5] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log(f"[6] end to end, bench weights, bf16: the paths of kernels 8, 6, "
        f"10 and 5 ({card}):")
    toggles = toggles_phase(dev, report, card)
    log(f"[6] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log(f"[7] dataset inference through tools/test_net over "
        f"tests/fixtures/synmot_mini (DLA-34-FPN-EMM, bench weights; {card}):")
    dataset = dataset_phase(dev, report, card)
    log(f"[7] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log(f"[8] multi-stream inference: DLA-34-FPN-EMM, bench weights, "
        f"streams as lanes of one batched step ({card}):")
    sweep, syncs, ms_dataset = multistream_phase(dev, report, card)
    log(f"[8] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log(f"[9] training through tools/train_net: DLA-34-FPN-EMM, the "
        f"SYNMOT_HARD recipe over the committed training fixture ({card}):")
    trained = train_net_phase(dev, report, card)
    log(f"[9] done in {time.perf_counter() - t0:.1f} s")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("host_ms", "kernels", "sites", "training_sites", "passes",
             "launches_by_path", "shapes", "step_sites")
    kernels = [{k: r[k] for k in keys} | {k: r[k] for k in extra if k in r}
               for r in report.values()]
    log(f"total {time.perf_counter() - t_start:.1f} s; DLA-34 "
        f"{ms_frame:.3f} ms/frame, {occupied} live slots; training "
        f"{ms_step:.3f} ms/step (median {med_step:.3f}), peak "
        f"{peak / 2 ** 30:.3f} GiB; SEARCH_REGION 5 training "
        f"{ms_wide:.3f} ms/step, peak {peak_wide / 2 ** 30:.3f} GiB; "
        f"DLA-102-DCN {ms_dcn:.3f} ms/frame, "
        f"{occ_dcn} live slots, last frame's routes {''.join(routes)}; "
        f"MOT17 given {toggles['6a'][0]:.3f} ms/frame ({toggles['6a'][1]} "
        f"live), unmasked {toggles['6b'][0]:.3f} ({toggles['6b'][1]}), "
        f"SEARCH_REGION 5 {toggles['6c'][0]:.3f} ({toggles['6c'][1]}); "
        f"dataset Speed "
        + ", ".join(f"{run} {fps:.3f} fps (MOTA {s['mota']:.4f})"
                    for run, (fps, s) in dataset.items())
        + "; multi-stream "
        + ", ".join(f"S={n} {r['fps']:.3f} fps ({r['ms_step']:.3f} ms/step)"
                    for n, r in sweep.items())
        + f", host syncs a step {syncs[1][0]} at S=1, {syncs[8][0]} at S=8"
        + ", test_net --n-streams 2 "
        + ", ".join(f"{run} {fps:.3f} fps" for run, fps in ms_dataset.items())
        + f"; train_net loader {trained['loader']['clips_per_s']:.3f} clips/s "
        f"({trained['loader']['ms_batch']:.3f} ms a 16-clip batch), nvJPEG "
        f"round trip max byte gap "
        + ", ".join(f"q{q} {g[0]}" for q, g in trained["gap"].items())
        + f"; card {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
