"""Where one training step's time goes on the card.

    python -m siammot_tpu_torch.engine.profile_train_step

Runs the training step of the default configuration (DLA-34-FPN-EMM, the
repo's bench weights as f32 masters, bf16 compute) on batches of two
clips x two consecutive frames of the crowded 720p sprite scene: 3
warm-up steps, then 5 steps traced with ``torch.profiler`` (CPU and CUDA
activities).  Prints the host time per step, the device-busy time per
step (the union of kernel intervals) and its share, and the device time
per step of the heaviest operations, the port's training kernels named.
Needs a CUDA device.
"""

from __future__ import annotations

import itertools
import os
import time

import torch

from .profile_frame import REPO, TOP, _busy_us

WARMUP, STEPS = 3, 5
KERNELS = ("window_pool_band", "window_pool_bwd_kernel", "xcorr6_kernel")


def main():
    from torch.profiler import ProfilerActivity, profile

    from ..configs.defaults import get_cfg
    from ..core.matcher import uniform_draws
    from ..models.siammot import SiamMOT
    from ..utils.synth import train_batches
    from ..utils.weights import jax_to_torch, load_npz
    from .solver import build_train_step, make_optimizer

    if not torch.cuda.is_available():
        raise SystemExit("profile_train_step: no CUDA device")

    cfg = get_cfg()
    model = SiamMOT(cfg, device="cuda")
    net = model.build_master(jax_to_torch(load_npz(
        os.path.join(REPO, "fixtures", "bench_weights_f16.npz"))))
    opt = make_optimizer(cfg, net)
    train_step = build_train_step(model, opt)
    batches = [tuple(x.cuda() if torch.is_tensor(x) else
                     x.map(lambda v: v.cuda()) for x in b)
               for b in itertools.islice(
                   train_batches(WARMUP + STEPS + 1, 736, cfg.TPU.MAX_GT),
                   WARMUP + STEPS)]

    def step(i):
        images, gt, sizes = batches[i]
        return train_step(net, images, gt, sizes, uniform_draws("cuda", i))

    for i in range(WARMUP):
        step(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(WARMUP, WARMUP + STEPS):
            metrics = step(i)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    busy_ms = _busy_us(prof.events()) / 1e3 / STEPS
    print(f"{torch.cuda.get_device_name(0)}: {STEPS} traced training "
          f"steps (4 frames of 736x1280), loss {float(metrics['loss']):.4f};"
          f" host {host_ms:.3f} ms/step (traced), device busy "
          f"{busy_ms:.3f} ms/step ({100 * busy_ms / host_ms:.1f}%)")
    rows = [(e.key, e.device_time_total / 1e3 / STEPS, e.count)
            for e in prof.key_averages() if e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    print(f"{'device ms/step':>15}  {'calls/step':>10}  op")
    for key, ms, count in rows[:TOP]:
        print(f"{ms:15.4f}  {count / STEPS:10.1f}  {key[:90]}")
    print(f"{sum(r[1] for r in rows):15.4f}  total over all device ops "
          f"(nested ops count twice)")
    print(f"{'':15}  kernels: " + ", ".join(
        f"{k}={ms:.4f}" for k, ms, _ in rows
        if any(n in k for n in KERNELS)))


if __name__ == "__main__":
    main()
