"""Where one 720p frame's time goes on the card.

    python -m siammot_tpu_torch.engine.profile_frame [--body DLA-102-FPN]

Runs the main path (DLA-34-FPN-EMM, the repo's bench weights in bf16, the
crowded sprite scene) for 10 warm-up frames, then traces 10 frames with
``torch.profiler`` (CPU and CUDA activities).  With ``--body`` it runs
that Bottleneck body with deformable stages 3-5 (the model zoo's -DCN
detectors) on seeded weights (``utils.weights.seeded_params``) instead.
Prints the host time per frame, the device-busy time per frame (the
union of kernel intervals) and its share, and the device time per frame
of the heaviest operations, each of the port's kernels named.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import os
import time

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
    from ..utils.synth import render_scene
    from ..utils.weights import jax_to_torch, load_npz, seeded_params

    ap = argparse.ArgumentParser()
    ap.add_argument("--body", default=None,
                    help="a Bottleneck DLA body (e.g. DLA-102-FPN), run "
                         "with DCN stages on seeded weights")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame: no CUDA device")

    cfg = get_cfg()
    frames = [torch.as_tensor(f) for f in render_scene(16, 736)[0]]
    if args.body:
        cfg.merge_from_list(dla_dcn_overrides(args.body))
        model = SiamMOT(cfg, device="cuda")
        params, _ = seeded_params(model, frames[0])
    else:
        model = SiamMOT(cfg, device="cuda")
        params = jax_to_torch(load_npz(
            os.path.join(REPO, "fixtures", "bench_weights_f16.npz")))
    net = model.cast_params(params)
    state = model.empty_state()

    def step(i):
        nonlocal state
        _, state = model.forward_inference(
            net, frames[i % len(frames)].cuda(), state, (1280, 720))

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
          f"{' DCN' if args.body else ''}): {FRAMES} traced frames, "
          f"{int(state.occupied.sum())} live slots; host {host_ms:.3f} "
          f"ms/frame (traced), device busy {busy_ms:.3f} ms/frame "
          f"({100 * busy_ms / host_ms:.1f}%)")
    rows = [(e.key, e.device_time_total / 1e3 / FRAMES, e.count)
            for e in prof.key_averages()
            if e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    print(f"{'device ms/frame':>16}  {'calls/frame':>11}  op")
    for key, ms, count in rows[:TOP]:
        print(f"{ms:16.4f}  {count / FRAMES:11.1f}  {key[:90]}")
    print(f"{sum(r[1] for r in rows):16.4f}  total over all device ops "
          f"(nested ops count twice)")
    print(f"{'':16}  kernels: " + ", ".join(
        f"{k}={ms:.4f}" for k, ms, _ in rows
        if any(n in k for n in ("window_pool_band", "xcorr6_kernel",
                                "tower_conv_", "heads_tiled", "decode_kernel",
                                "deform_window", "deform_wgmma",
                                "deform_reduce", "deform_ffma"))))


if __name__ == "__main__":
    main()
