"""Training loop (port of ``siammot_tpu/engine/trainer.py``: ``do_train``
and ``SmoothedValue``).

Iteration-based, with periodic smoothed-loss logging and optional
periodic checkpoints (``utils.checkpoint.Checkpointer``; ``utils.
checkpoint.resume`` loads the latest into the net and the optimizer and
gives ``start_iter``).  Each iteration's sampler draws come from a
generator seeded by (seed, iteration, rank) (``core/matcher.py:
draw_seed``), as the JAX loop folds the iteration and its step the
device into its key, so a run resumed at iteration k draws what the
uninterrupted run drew.  SIGTERM, or a stop file at a step boundary,
ends the loop cleanly after the current step (with a final checkpoint
when there is a checkpointer).

Under data parallelism (a ``parallel/mesh.py:Group``) only rank 0
writes checkpoints and events, each save followed by a barrier
(``torch.save`` is not collective, as orbax's save is), and the stop
request is all-reduced at each step boundary, so every rank stops at
the same step and none waits in a collective for one that left.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal
import time
from collections import deque

import numpy as np

from ..core.matcher import draw_seed, uniform_draws

logger = logging.getLogger(__name__)


class SmoothedValue:
    """Windowed median/avg meter (maskrcnn MetricLogger semantics)."""

    def __init__(self, window: int = 20):
        self.values = deque(maxlen=window)
        self.total = 0.0
        self.count = 0

    def update(self, v: float):
        self.values.append(v)
        self.total += v
        self.count += 1

    @property
    def median(self):
        return float(np.median(self.values)) if self.values else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)


@dataclasses.dataclass
class TrainLog:
    iteration: int        # last iteration run
    step_seconds: list    # host seconds per step, logged steps synchronised
    # host seconds per step spent waiting for the loader's batch
    data_seconds: list = dataclasses.field(default_factory=list)
    # (iteration, metrics read to the host) at each logged step
    logged: list = dataclasses.field(default_factory=list)


def do_train(model, train_step, net, optimizer, data_loader, checkpointer,
             max_iter: int, checkpoint_period: int, start_iter: int = 0,
             log_period: int = 20, tensorboard_writer=None, seed: int = 0,
             stop_file: str | None = None, group=None) -> TrainLog:
    """Run ``train_step`` over ``data_loader`` batches (uint8 images,
    gt Boxes, frame sizes) until ``max_iter``; ``net`` and ``optimizer``
    are updated in place.

    At each logged step (every ``log_period`` and the last) the metrics
    are read to the host, which waits for the device, and passed to
    ``tensorboard_writer(iteration, metrics)``.  ``stop_file`` (or the
    SIAMMOT_STOP_FILE environment variable): if that path exists at a step
    boundary, stop there.  ``group``: this rank's data-parallel group
    (None: one process); ranks other than 0 save nothing (their
    ``checkpointer`` may be None) but meet rank 0 at each save.
    """
    rank = group.rank if group is not None else 0
    many = group is not None and group.world > 1

    def save(iteration, tag=None):
        if checkpointer is not None and rank == 0:
            checkpointer.save(iteration, net, optimizer, tag=tag)
        if many:
            group.barrier()

    stop_file = stop_file or os.environ.get("SIAMMOT_STOP_FILE")
    stop_requested = []

    def _on_term(signum, frame):
        logger.warning("SIGTERM received: checkpointing and stopping")
        stop_requested.append(True)

    try:
        prev_handler = signal.signal(signal.SIGTERM, _on_term)
    except ValueError:  # not on the main thread
        prev_handler = None

    meters = {"loss": SmoothedValue(), "time": SmoothedValue(),
              "data": SmoothedValue()}
    log = TrainLog(iteration=start_iter, step_seconds=[])
    logger.info("Start training")
    start = end = time.time()
    iteration = start_iter
    try:
        for images, gt, frame_sizes in data_loader:
            if stop_file and os.path.exists(stop_file):
                logger.warning("stop file %s present: stopping at iter %d",
                               stop_file, iteration)
                stop_requested.append(True)
            if many and group.all_reduce_max(bool(stop_requested)):
                stop_requested.append(True)
            if iteration >= max_iter or stop_requested:
                break
            iteration += 1
            log.data_seconds.append(time.time() - end)
            meters["data"].update(log.data_seconds[-1])
            draws = uniform_draws(model.device,
                                  draw_seed(seed, iteration, rank))
            dev = model.device
            metrics = train_step(net, images.to(dev),
                                 gt.map(lambda v: v.to(dev)),
                                 frame_sizes.to(dev), draws)

            if iteration % log_period == 0 or iteration == max_iter:
                host = {k: float(v) for k, v in metrics.items()}
                log.logged.append((iteration, host))
                meters["loss"].update(host["loss"])
                eta = (time.time() - start) \
                    / max(iteration - start_iter, 1) * (max_iter - iteration)
                logger.info(
                    "iter %d/%d  loss %.4f (med %.4f)  %s  data %.3fs  "
                    "eta %.0fs", iteration, max_iter, host["loss"],
                    meters["loss"].median,
                    "  ".join(f"{k} {v:.4f}" for k, v in sorted(host.items())
                              if k != "loss"), meters["data"].median, eta)
                if tensorboard_writer is not None:
                    tensorboard_writer(iteration, host)

            if iteration % checkpoint_period == 0:
                save(iteration)

            log.step_seconds.append(time.time() - end)
            meters["time"].update(log.step_seconds[-1])
            end = time.time()
    finally:
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)

    save(iteration)
    save(iteration, tag="model_final")
    total = time.time() - start
    logger.info("Total training time: %.0fs (%.4f s/it)", total,
                total / max(iteration - start_iter, 1))
    log.iteration = iteration
    return log
