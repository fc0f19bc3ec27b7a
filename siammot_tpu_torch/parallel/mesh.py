"""Data-parallel training over several devices (port of the multi-device
layer of ``siammot_tpu/parallel/mesh.py``).

The JAX package shards the batch over a ``Mesh(('data',))`` and takes a
``pmean`` of the gradients and losses inside one jitted step; with
several processes (``jax.distributed``) each loads its slice of the
global batch and process 0's restored state is broadcast to the others.
The port runs one process a device under ``torch.distributed``, as the
reference's NCCL DDP does (``python -m torch.distributed.run
--nproc-per-node N -m siammot_tpu_torch.tools.train_net ...``):

* :func:`init_process_group`: the group from the launcher's environment
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
  ``MASTER_PORT``), NCCL on the card and gloo on the CPU unless a
  backend is named; a rank's card is ``cuda:{LOCAL_RANK % count}``.
  Host-side flags (the stop flag, the restored state, barriers) go over
  gloo, a second group where the first is NCCL, so they never wait for
  the card;
* :func:`data_parallel_size`: ``TPU.DATA_PARALLEL`` against the world;
* :func:`sync_restored_state`: rank 0's net, optimizer state and
  ``start_iter`` on every rank (only rank 0 reads a checkpoint or
  ``MODEL.WEIGHT``, so the ranks need not share a file system);
* :func:`build_train_step`: each rank runs its microbatches as
  ``engine/solver.py:build_train_step`` does, then one all-reduce of the
  gradients, the losses and their total, averaged over the ranks (the
  ``pmean``), before the one update.  The step calls
  ``model.forward_train``, not a module's ``forward``, so
  ``DistributedDataParallel``'s hooks have nothing to attach to; the
  all-reduce after the microbatches is the ``pmean``'s counterpart.  A
  parameter no rank's graph reached (a projection no tree level reads)
  or only some ranks' reached has its gradient zero-filled on every rank
  first, so every rank reduces the same list; frozen parameters
  (``FREEZE_CONV_BODY_AT``) are in no optimizer group and stay out.

Each rank draws its samplers from a generator of its own
(``core/matcher.py:draw_seed``), as the JAX step folds the device index
into its key; ``engine/trainer.py:do_train`` writes checkpoints, events
and the log on rank 0 only and stops every rank at the same step.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..engine import solver


@dataclasses.dataclass(frozen=True)
class Group:
    """This process's place in the data-parallel group."""

    rank: int
    world: int
    device: torch.device
    control: Optional[object] = None   # gloo group for host-side flags

    def all_reduce_max(self, flag: bool) -> bool:
        """True on every rank if ``flag`` is True on any (host-side)."""
        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.control)
        return bool(t.item())

    def barrier(self) -> None:
        dist.barrier(group=self.control)


def launcher_env() -> tuple:
    """(rank, world size, local rank) as ``torch.distributed.run`` sets
    them; (0, 1, 0) outside a launcher."""
    return (int(os.environ.get("RANK", 0)),
            int(os.environ.get("WORLD_SIZE", 1)),
            int(os.environ.get("LOCAL_RANK", 0)))


def rank_device(device: str, local_rank: int) -> torch.device:
    """The rank's device: a card named with its index as named, else
    ``cuda:{local_rank % device_count}``; the CPU as it is."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass --device cpu for the CPU)")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def init_process_group(device: str = "cuda", backend: Optional[str] = None,
                       init_method: str = "env://") -> Group:
    """Join the launcher's group: NCCL for a card and gloo for the CPU
    unless ``backend`` names one (gloo also runs CUDA tensors: two ranks
    on one card, which NCCL refuses).  ``init_method``: ``env://`` reads
    ``MASTER_ADDR``/``MASTER_PORT``; a ``file://`` store needs no port."""
    rank, world, local = launcher_env()
    dev = rank_device(device, local)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    control = dist.new_group(backend="gloo") if backend != "gloo" else None
    return Group(rank, world, dev, control)


def destroy_process_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def data_parallel_size(cfg, world: int) -> int:
    """``TPU.DATA_PARALLEL``: 0 takes the launcher's world size; any other
    value must equal it."""
    n = cfg.TPU.DATA_PARALLEL
    if n and n != world:
        raise ValueError(f"TPU.DATA_PARALLEL={n} but the launcher started "
                         f"{world} process(es): launch with "
                         f"--nproc-per-node {n}, or set it to 0")
    return world


def sync_restored_state(group: Group, net, optimizer,
                        start_iter: int) -> int:
    """Rank 0's net state, optimizer state (momentum buffers, update
    count) and ``start_iter`` on every rank, loaded in place; returns the
    iteration (``siammot_tpu/parallel/mesh.py:sync_restored_state``)."""
    if group.world == 1:
        return int(start_iter)
    payload = [None]
    if group.rank == 0:
        # new dicts: ``state_dict`` hands out the optimizer's own per-
        # parameter state, whose buffers must stay where they are
        opt = optimizer.state_dict()
        sgd = dict(opt["sgd"], state={
            i: {k: v.detach().cpu() if torch.is_tensor(v) else v
                for k, v in st.items()}
            for i, st in opt["sgd"]["state"].items()})
        payload = [{"model": {k: v.detach().cpu()
                              for k, v in net.state_dict().items()},
                    "optimizer": dict(opt, sgd=sgd),
                    "iteration": int(start_iter)}]
    dist.broadcast_object_list(payload, src=0, group=group.control)
    state = payload[0]
    if group.rank != 0:
        with torch.no_grad():
            net.load_state_dict(state["model"], strict=True)
        optimizer.load_state_dict(state["optimizer"])
    return state["iteration"]


def all_reduce_mean(group: Group, optimizer, metrics: dict) -> dict:
    """Average every trainable parameter's gradient and the step's metrics
    over the ranks, in place, with one all-reduce of one flat buffer
    (missing gradients zero-filled first, on every rank); returns the
    averaged metrics."""
    params = [p for g in optimizer.sgd.param_groups for p in g["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    keys = sorted(metrics)
    flat = torch.cat([p.grad.reshape(-1) for p in params]
                     + [torch.stack([metrics[k].float() for k in keys])])
    dist.all_reduce(flat)
    flat /= group.world
    at = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[at:at + n].view(p.shape))
        at += n
    return {k: flat[at + i] for i, k in enumerate(keys)}


def build_train_step(model, optimizer, group: Group, accum_steps: int = 1,
                     image_size=None):
    """The data-parallel step: ``step(net, images, gt, frame_sizes, draws)
    -> metrics`` over this rank's share of the batch, the gradients and
    metrics averaged over the ranks (:func:`all_reduce_mean`) before the
    update, so every rank updates alike and logs the same metrics."""
    return solver.build_train_step(
        model, optimizer, accum_steps=accum_steps, image_size=image_size,
        reduce=lambda metrics: all_reduce_mean(group, optimizer, metrics))
