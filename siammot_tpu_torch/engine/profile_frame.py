"""Where one 720p frame's time goes on the card.

    python -m siammot_tpu_torch.engine.profile_frame [--body DLA-102-FPN]
        [--opts MODEL.TRACK_HEAD.SEARCH_REGION 5.0] [--streams S]

Runs the main path (DLA-34-FPN-EMM, the repo's bench weights in bf16, the
crowded sprite scene) for 10 warm-up frames, then traces 10 frames with
``torch.profiler`` (CPU and CUDA activities).  With ``--body`` it runs
that Bottleneck body with deformable stages 3-5 (the model zoo's -DCN
detectors) on seeded weights (``utils.weights.seeded_params``) instead;
``--opts`` merges config overrides (key/value pairs) first.  With
``--streams S`` each step is the multi-stream batched step over S crowd
scenes (seeds 42 + i; ``SiamMOT.forward_streams``), and the times are
given per step and per frame (S frames a step).
Prints the host time per step, the device-busy time per step (the
union of kernel intervals) and its share, and the device time per step
of the heaviest operations, each of the port's kernels named.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FRAMES, TOP = 10, 25


def _busy_us(events) -> float:
    """Length of the union of the device kernels' intervals (us)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def main():
    from torch.profiler import ProfilerActivity, profile

    from ..configs.defaults import dla_dcn_overrides, get_cfg
    from ..models.siammot import SiamMOT
    from ..parallel.multistream import empty_states
    from ..utils.synth import render_scene
    from ..utils.weights import jax_to_torch, load_npz, seeded_params

    ap = argparse.ArgumentParser()
    ap.add_argument("--body", default=None,
                    help="a Bottleneck DLA body (e.g. DLA-102-FPN), run "
                         "with DCN stages on seeded weights")
    ap.add_argument("--opts", nargs="*", default=[],
                    help="config overrides as key/value pairs, e.g. "
                         "MODEL.TRACK_HEAD.SEARCH_REGION 5.0")
    ap.add_argument("--streams", type=int, default=1,
                    help="video streams a batched step")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame: no CUDA device")

    cfg = get_cfg()
    cfg.merge_from_list(args.opts)
    n = args.streams
    scenes = [render_scene(16, 736, 42 + i)[0] for i in range(min(n, 4))]
    # lane i: scene i % 4, its frames shifted by 3 per round of four
    steps = [torch.as_tensor(np.stack([
        scenes[i % 4][(t + 3 * (i // 4)) % 16] for i in range(n)]))
        .pin_memory() for t in range(16)]
    frames = scenes[0]
    if args.body:
        cfg.merge_from_list(dla_dcn_overrides(args.body))
        model = SiamMOT(cfg, device="cuda")
        params, _ = seeded_params(model, torch.as_tensor(frames[0]))
    else:
        model = SiamMOT(cfg, device="cuda")
        params = jax_to_torch(load_npz(
            os.path.join(REPO, "fixtures", "bench_weights_f16.npz")))
    net = model.cast_params(params)
    state = empty_states(model, n)

    def step(i):
        nonlocal state
        _, state = model.forward_streams(
            net, steps[i % len(steps)].cuda(non_blocking=True), state,
            (1280, 720))

    for i in range(10):
        step(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(10, 10 + FRAMES):
            step(i)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / FRAMES
    busy_ms = _busy_us(prof.events()) / 1e3 / FRAMES
    print(f"{torch.cuda.get_device_name(0)} ({cfg.MODEL.BACKBONE.CONV_BODY}"
          f"{' DCN' if args.body else ''}{''.join(' ' + o for o in args.opts)}"
          f", {n} stream{'s' if n > 1 else ''} a step): {FRAMES} traced "
          f"steps, {int(state.occupied.sum())} live slots; host "
          f"{host_ms:.3f} ms/step (traced), device busy {busy_ms:.3f} "
          f"ms/step ({100 * busy_ms / host_ms:.1f}%); per frame: host "
          f"{host_ms / n:.3f} ms, device busy {busy_ms / n:.3f} ms")
    rows = [(e.key, e.device_time_total / 1e3 / FRAMES, e.count)
            for e in prof.key_averages()
            if e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    print(f"{'device ms/step':>16}  {'calls/step':>11}  op")
    for key, ms, count in rows[:TOP]:
        print(f"{ms:16.4f}  {count / FRAMES:11.1f}  {key[:90]}")
    print(f"{sum(r[1] for r in rows):16.4f}  total over all device ops "
          f"(nested ops count twice)")
    print(f"{'':16}  kernels: " + ", ".join(
        f"{k}={ms:.4f}" for k, ms, _ in rows
        if any(n in k for n in ("window_pool_band", "xcorr6_kernel",
                                "tower_conv_", "heads_band", "decode_",
                                "deform_window", "deform_wgmma",
                                "deform_reduce", "deform_ffma"))))


if __name__ == "__main__":
    main()
