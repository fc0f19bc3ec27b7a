"""Optimizer, learning-rate schedule and the single-device train step
(port of ``siammot_tpu/parallel/mesh.py``: ``make_lr_schedule``,
``make_optimizer`` and ``build_train_step`` on one device).

SGD with momentum and maskrcnn's per-parameter policy: weight decay on
weights only; leaves named ``bias`` or ``scale`` (the EMM GroupNorm
scales among them) get ``BIAS_LR_FACTOR`` times the rate and
``WEIGHT_DECAY_BIAS``.  The FrozenBN statistics are buffers, so nothing
moves them (the JAX tree holds them as parameters whose gradient is
stopped).  ``torch.optim.SGD`` with ``dampening`` 0 computes what the
JAX chain ``add_decayed_weights`` -> ``sgd(momentum)`` does; the rate
comes from the schedule at the update count, starting at 0, as optax
counts.  ``MODEL.BACKBONE.FREEZE_CONV_BODY_AT`` freezes a ResNet body's
stem and its first stages (:func:`frozen`).
"""

from __future__ import annotations

import torch


def make_lr_schedule(cfg):
    """maskrcnn WarmupMultiStepLR: linear warmup from WARMUP_FACTOR over
    WARMUP_ITERS (factor 1 once reached), then x GAMMA at each step in
    SOLVER.STEPS.  Returns ``schedule(iteration) -> lr``."""
    s = cfg.SOLVER
    base, gamma = s.BASE_LR, s.GAMMA
    steps = sorted(s.STEPS)
    wf, wi = s.WARMUP_FACTOR, s.WARMUP_ITERS

    def schedule(it: int) -> float:
        alpha = min(max(it / max(wi, 1), 0.0), 1.0)
        warm = 1.0 if it >= wi else wf * (1 - alpha) + alpha
        return base * warm * gamma ** sum(it >= st for st in steps)

    return schedule


class ScheduledSGD:
    """SGD with momentum whose rate follows ``schedule`` at the update
    count; each param group scales it by its ``lr_factor``."""

    def __init__(self, groups: list, schedule, momentum: float):
        self.sgd = torch.optim.SGD(groups, lr=schedule(0),
                                   momentum=momentum)
        self.schedule = schedule
        self.count = 0

    def state_dict(self) -> dict:
        """The SGD state (momentum buffers, groups) and the update count:
        the schedule's place, so a resumed run does not warm up again."""
        return {"sgd": self.sgd.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.sgd.load_state_dict(state["sgd"])
        self.count = int(state["count"])

    def zero_grad(self) -> None:
        self.sgd.zero_grad(set_to_none=True)

    def step(self) -> float:
        """One update at ``schedule(count)``; returns that rate.  A
        parameter the step did not reach (a projection no tree level
        reads) counts as a zero gradient, so decay and momentum still move
        it, as optax moves every leaf."""
        lr = self.schedule(self.count)
        for g in self.sgd.param_groups:
            g["lr"] = lr * g["lr_factor"]
            for p in g["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self.sgd.step()
        self.count += 1
        return lr


def frozen(name: str, freeze_at: int) -> bool:
    """``siammot_tpu/parallel/mesh.py``'s ``_frozen`` rule (maskrcnn
    ``_freeze_backbone``): with ``freeze_at`` >= 1, a body child named
    ``stem_*`` or ``layer1_*`` .. ``layer{freeze_at-1}_*`` is frozen.
    Only ResNet bodies have such children, so a DLA body (whose S2D stem
    is ``stem``) is unaffected, as in the JAX package."""
    parts = name.split(".")
    if freeze_at <= 0 or parts[0] != "body" or len(parts) < 2:
        return False
    mod = parts[1]
    return mod.startswith("stem_") or any(
        mod.startswith(f"layer{s}_") for s in range(1, freeze_at))


def make_optimizer(cfg, net: torch.nn.Module) -> ScheduledSGD:
    """The reference's optimizer over ``net``'s parameters.  Frozen
    parameters (:func:`frozen`) get ``requires_grad`` False, so no
    gradient is computed for them, and stay out of the SGD groups: no
    update and no weight decay, as optax's ``set_to_zero`` leaves them."""
    s = cfg.SOLVER
    freeze_at = cfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT
    weights, biases = [], []
    for name, p in net.named_parameters():
        if frozen(name, freeze_at):
            p.requires_grad_(False)
        elif p.requires_grad:
            leaf = name.rsplit(".", 1)[-1]
            (biases if leaf in ("bias", "scale") else weights).append(p)
    groups = [dict(params=weights, lr_factor=1.0,
                   weight_decay=s.WEIGHT_DECAY),
              dict(params=biases, lr_factor=float(s.BIAS_LR_FACTOR),
                   weight_decay=s.WEIGHT_DECAY_BIAS)]
    return ScheduledSGD(groups, make_lr_schedule(cfg), s.MOMENTUM)


def build_train_step(model, optimizer: ScheduledSGD, accum_steps: int = 1,
                     image_size=None, reduce=None):
    """One optimizer step per batch.

    Returns ``step(net, images, gt, frame_sizes, draws) -> metrics``: the
    batch runs as ``accum_steps`` equal microbatches of whole frame pairs,
    their gradients averaged before the single update, as the JAX step's
    scan does.  ``image_size``: the static (w, h) input the step sees
    (``TPU.INPUT_WIDTH``, ``TPU.INPUT_HEIGHT``), as the JAX step takes it;
    None takes the padded batch's own.  ``metrics`` holds each loss
    averaged over the microbatches and their sum as ``loss`` (device
    scalars).  ``reduce(metrics) -> metrics``, called after the
    microbatches and before the update, averages the gradients and the
    metrics over data-parallel ranks (``parallel/mesh.py``).
    """

    def step(net, images, gt, frame_sizes, draws) -> dict:
        b = images.shape[0]
        mb = b // max(accum_steps, 1)
        if b % max(accum_steps, 1) or mb % 2:
            raise ValueError(f"batch {b} does not split into {accum_steps} "
                             f"pair-preserving microbatches")
        optimizer.zero_grad()
        metrics = {}
        for i in range(0, b, mb):
            losses = model.forward_train(
                net, draws, images[i:i + mb], gt.map(lambda v: v[i:i + mb]),
                image_size,
                None if frame_sizes is None else frame_sizes[i:i + mb])
            total = sum(losses.values())
            (total / (b // mb)).backward()
            for k, v in dict(losses, loss=total).items():
                metrics[k] = metrics.get(k, 0.0) + v.detach() / (b // mb)
        if reduce is not None:
            metrics = reduce(metrics)
        optimizer.step()
        return metrics

    return step
