"""Rank functions that the data-parallel tests start with
``torch.multiprocessing.spawn``: gloo over a ``file://`` store (no port
for the test workers to fight over), one CPU thread a rank.

This module imports neither JAX nor a test file: each spawned child
imports it anew.  A job is a dict saved with ``torch.save`` by the
parent; each rank writes what it computed to ``<out>.rank<r>.pt``.
"""

import os
import time

import numpy as np
import torch
import torch.multiprocessing as mp


def spawn(fn, args, nprocs, timeout=300):
    """``mp.spawn`` whose ranks are killed, and a ``TimeoutError``
    raised, if they have not all ended within ``timeout`` seconds (a
    collective that one rank never joins would otherwise hang the
    test)."""
    ctx = mp.spawn(fn, args=args, nprocs=nprocs, join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{fn.__name__}: ranks still running after "
                               f"{timeout} s")


class Replay:
    """The port's ``draw(shape)`` over pre-drawn uniform blocks (as
    ``torch_port_util.Replay``, which imports JAX)."""

    def __init__(self, blocks):
        self.blocks = [np.asarray(b, np.float32) for b in blocks]

    def __call__(self, shape):
        arr = self.blocks.pop(0)
        assert arr.shape == tuple(shape), (arr.shape, tuple(shape))
        return torch.from_numpy(arr)


def _env(rank, world):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)


def _model(opts):
    from siammot_tpu_torch.configs.defaults import get_cfg
    from siammot_tpu_torch.models.siammot import SiamMOT
    cfg = get_cfg()
    cfg.merge_from_list(opts)
    return cfg, SiamMOT(cfg, device="cpu")


def _grads(net):
    return {n: (p.grad.clone() if p.grad is not None else None)
            for n, p in net.named_parameters()}


def _params(net):
    return {n: p.detach().clone() for n, p in net.named_parameters()}


def steps_job(rank, group, job):
    """Data-parallel steps of the port's step over this rank's share of
    each batch, with the replayed draws: metrics, the averaged gradients
    of the first step and the parameters after each step."""
    from siammot_tpu_torch.core.structures import Boxes
    from siammot_tpu_torch.engine.solver import make_optimizer
    from siammot_tpu_torch.parallel import mesh
    cfg, model = _model(job["opts"])
    net = model.build_master(job["params"])
    opt = make_optimizer(cfg, net)
    step = mesh.build_train_step(model, opt, group,
                                 accum_steps=job.get("accum", 1),
                                 image_size=job["image_size"])
    out = dict(metrics=[], params=[])
    for batch, draws in zip(job["batches"], job["draws"]):
        images, gt, sizes = batch[rank]
        gt = Boxes(**{k: torch.as_tensor(v) for k, v in gt.items()})
        metrics = step(net, torch.as_tensor(images), gt,
                       torch.as_tensor(sizes), Replay(draws[rank]))
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        out.setdefault("grads", _grads(net))
        out["params"].append(_params(net))
    return out


def none_grad_job(rank, group, job):
    """A branch that only rank 0 runs: rank 1's gradient of it is None
    until the all-reduce zero-fills it, on every rank alike."""
    from siammot_tpu_torch.engine.solver import ScheduledSGD
    from siammot_tpu_torch.parallel import mesh
    torch.manual_seed(0)
    trunk, branch = torch.nn.Linear(4, 4), torch.nn.Linear(4, 1)
    opt = ScheduledSGD([dict(params=list(trunk.parameters())
                             + list(branch.parameters()), lr_factor=1.0,
                             weight_decay=0.0)], lambda it: 0.1, 0.9)
    x = torch.full((2, 4), float(rank + 1))
    loss = trunk(x).square().mean()
    if rank == 0:
        loss = loss + branch(trunk(x)).mean()
    loss.backward()
    local = _grads(trunk) | {f"branch.{k}": v
                             for k, v in _grads(branch).items()}
    metrics = mesh.all_reduce_mean(group, opt, {"loss": loss.detach()})
    return dict(local=local, loss=float(metrics["loss"]),
                reduced={n: p.grad.clone() for n, p in
                         list(trunk.named_parameters())
                         + [(f"branch.{k}", v) for k, v in
                            branch.named_parameters()]})


def sync_job(rank, group, job):
    """Rank 0 resumes from ``job["dirs"][0]``; every other rank, whose
    directory is empty, starts from other weights and takes rank 0's."""
    from siammot_tpu_torch.engine.solver import make_optimizer
    from siammot_tpu_torch.parallel import mesh
    from siammot_tpu_torch.utils.checkpoint import Checkpointer, resume
    cfg, model = _model(job["opts"])
    torch.manual_seed(rank + 1)
    net = model.build_master(model.build_net().state_dict())
    opt = make_optimizer(cfg, net)
    ckpt = Checkpointer(job["dirs"][rank])
    start = resume(ckpt, net, opt) if rank == 0 else 0
    found = ckpt.latest()
    buffers = {id(p): st.get("momentum_buffer")
               for p, st in opt.sgd.state.items()}
    start = mesh.sync_restored_state(group, net, opt, start)
    # rank 0 keeps its own buffers (on its device), untouched
    kept = rank == 0 and len(buffers) > 0 and all(
        st["momentum_buffer"] is buffers[id(p)]
        for p, st in opt.sgd.state.items())
    return dict(start=start, found=found, model=net.state_dict(),
                optimizer=opt.state_dict(), kept=kept)


def world_of_one_job(rank, group, job):
    """The data-parallel step in a group of one against the plain step
    from the same weights and draws."""
    from siammot_tpu_torch.core.structures import Boxes
    from siammot_tpu_torch.engine import solver
    from siammot_tpu_torch.parallel import mesh
    cfg, model = _model(job["opts"])
    out = {}
    for name in ("plain", "group"):
        net = model.build_master(job["params"])
        opt = solver.make_optimizer(cfg, net)
        step = solver.build_train_step(model, opt,
                                       image_size=job["image_size"]) \
            if name == "plain" else mesh.build_train_step(
                model, opt, group, image_size=job["image_size"])
        images, gt, sizes = job["batches"][0][0]
        gt = Boxes(**{k: torch.as_tensor(v) for k, v in gt.items()})
        metrics = step(net, torch.as_tensor(images), gt,
                       torch.as_tensor(sizes), Replay(job["draws"][0][0]))
        out[name] = dict(metrics={k: v.clone() for k, v in metrics.items()},
                         params=_params(net), grads=_grads(net))
    return out


def stop_job(rank, group, job):
    """``do_train`` over six one-pixel batches with a step that does no
    work: rank 0 alone watches the stop file, which its second step
    writes; every rank must stop after iteration 2."""
    from types import SimpleNamespace
    from siammot_tpu_torch.core.structures import Boxes
    from siammot_tpu_torch.engine.trainer import do_train
    stop = job["stop_file"]

    def step(net, images, gt, sizes, draws):
        if rank == 0 and int(images.flatten()[0]) == 2:
            open(stop, "w").close()
        return {"loss": torch.tensor(float(rank))}

    z = torch.zeros(1, 1)
    gt = Boxes(boxes=torch.zeros(1, 1, 4), scores=z, ids=z.int(),
               labels=z.int(), valid=z.bool())
    batches = [(torch.full((1, 1, 1, 1), it + 1), gt, torch.zeros(1, 2))
               for it in range(6)]
    log = do_train(SimpleNamespace(device=torch.device("cpu")), step, None,
                   None, batches, None, max_iter=6, checkpoint_period=100,
                   stop_file=stop if rank == 0 else None, group=group)
    return dict(iteration=log.iteration, steps=len(log.step_seconds))


JOBS = dict(steps=steps_job, none_grad=none_grad_job, sync=sync_job,
            world_of_one=world_of_one_job, stop=stop_job)


def run_jobs(rank, world, store, job_path):
    """Spawned rank: join the group, run every job of the file in order,
    write each rank's results beside it."""
    from siammot_tpu_torch.parallel import mesh
    _env(rank, world)
    group = mesh.init_process_group("cpu", "gloo", f"file://{store}")
    try:
        jobs = torch.load(job_path, weights_only=False)
        results = {name: JOBS[job["kind"]](rank, group, job)
                   for name, job in jobs.items()}
        torch.save(results, f"{job_path}.rank{rank}.pt")
    finally:
        mesh.destroy_process_group()


def run_train_net(rank, world, store, argv, out_path):
    """Spawned rank: ``tools/train_net.main(argv)`` with its loader's
    batches recorded by iteration and its checkpoint saves counted;
    writes the run directory, the logged metrics, the step count, the
    saves and the batches to ``out_path.rank<r>.pt``."""
    import siammot_tpu_torch.data.build as build_mod
    from siammot_tpu_torch.tools import train_net
    from siammot_tpu_torch.utils.checkpoint import Checkpointer
    _env(rank, world)
    batches, saves = {}, []
    orig = build_mod.build_train_data_loader
    orig_save = Checkpointer.save

    def counted_save(self, iteration, *args, **kw):
        saves.append((iteration, kw.get("tag")))
        return orig_save(self, iteration, *args, **kw)

    def recording(cfg, start_iter=0, **kw):
        loader = orig(cfg, start_iter=start_iter, **kw)

        class Recording:
            def __iter__(self):
                for it, batch in enumerate(loader, start_iter + 1):
                    images, gt, sizes = batch
                    batches[it] = (images.clone(), gt.numpy(), sizes.clone())
                    yield batch
        return Recording()

    build_mod.build_train_data_loader = recording
    Checkpointer.save = counted_save
    try:
        out, log = train_net.main(["--dist-url", f"file://{store}"]
                                  + list(argv))
    finally:
        build_mod.build_train_data_loader = orig
        Checkpointer.save = orig_save
    torch.save(dict(out=out, logged=log.logged, iteration=log.iteration,
                    steps=len(log.step_seconds), batches=batches,
                    saves=saves), f"{out_path}.rank{rank}.pt")
