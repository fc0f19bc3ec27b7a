"""Training CLI of the port (counterpart of ``tools/train_net.py``).

    python -m siammot_tpu_torch.tools.train_net \\
        --config-file configs/dla/DLA_34_FPN_EMM_SYNMOT_HARD.yaml \\
        --train-dir runs/ [--model-suffix tag] [--device cpu] [KEY VALUE ...]

Writes ``<train-dir>/<model name>/`` (``utils/model_name.py``): the merged
``config.yaml``, ``log.txt``, ``tb/`` (TensorBoard scalars,
``engine/tensorboard_writer.py``) and ``model_{iteration:07d}.pth``
checkpoints every ``SOLVER.CHECKPOINT_PERIOD`` iterations and at the end
(with ``model_final.pth``).  The weights start, in this order, from the
directory's latest checkpoint (net, optimizer and iteration: a resumed
run continues where the saved one stopped), else a reference ``.pth``
(``utils/checkpoint.import_torch_checkpoint``), else ``MODEL.WEIGHT`` as
parameters only with a fresh optimizer (a port checkpoint, a directory of
them or a flax ``.npz``; a shape that differs from the configuration's
raises), else the network's seeded initialisation.  The loop is
``engine/trainer.py:do_train`` over ``data/build.py``'s loader at
``SOLVER.MAX_ITER``, ``CHECKPOINT_PERIOD`` and ``ACCUMULATION_STEPS``.

The model and the JPEG decoder run on the card unless ``--device cpu``
asks for the CPU.

Several devices: one process a device under ``torch.distributed.run``
(``parallel/mesh.py``), where the JAX tool runs one controller over a
device mesh (``jax.distributed.initialize`` for several hosts)::

    python -m torch.distributed.run --standalone --nproc-per-node N \
        -m siammot_tpu_torch.tools.train_net --config-file ... [KEY VALUE]

NCCL on the cards (rank r on ``cuda:{LOCAL_RANK % count}``), gloo with
``--device cpu`` or ``--dist-backend gloo``.  The group is set up
whenever the launcher's ``WORLD_SIZE`` is present, a world of one
included.  ``SOLVER.VIDEO_CLIPS_PER_BATCH``
is the global batch: each rank loads its contiguous share;
``TPU.DATA_PARALLEL`` 0 takes the world size, another value must equal
it.  Only rank 0 reads the checkpoint or ``MODEL.WEIGHT`` (the state is
broadcast to the others, :func:`parallel.mesh.sync_restored_state`) and
writes the run directory's files.
"""

from __future__ import annotations

import argparse
import logging
import os


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="SiamMOT training "
                                                 "(PyTorch port)")
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--train-dir", default="runs")
    parser.add_argument("--model-suffix", default="")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the model and the decoder "
                             "(default: the card; under a launcher, the "
                             "rank's card)")
    parser.add_argument("--dist-backend", default=None,
                        help="torch.distributed backend under a launcher "
                             "(default: nccl on the card, gloo on the CPU)")
    parser.add_argument("--dist-url", default="env://",
                        help="torch.distributed init method (default: the "
                             "launcher's MASTER_ADDR/MASTER_PORT)")
    parser.add_argument("opts", nargs=argparse.REMAINDER,
                        help="config overrides: KEY VALUE ...")
    return parser.parse_args(argv)


def initial_params(cfg, model, logger) -> dict:
    """The state dict training starts from when the run has no checkpoint
    of its own: ``MODEL.WEIGHT`` (a reference ``.pth``, a port checkpoint,
    a directory of them or a flax ``.npz``), else the seeded
    initialisation."""
    import torch

    from ..utils.checkpoint import load_model_file

    torch.manual_seed(0)
    fresh = model.build_net().state_dict()
    weight = cfg.MODEL.WEIGHT
    if not weight:
        return fresh
    params = load_model_file(weight, model)
    theirs = {k: tuple(v.shape) for k, v in params.items()}
    ours = {k: tuple(v.shape) for k, v in fresh.items()}
    if theirs != ours:
        raise ValueError(f"MODEL.WEIGHT {weight} is not shape-compatible "
                         f"with this config")
    logger.info("initialized params from %s", weight)
    return params


def train(cfg, output_dir: str, logger, device, group=None):
    """Build the model, its optimizer, the loader and the writer, resume
    or initialise, and run ``do_train``; returns its ``TrainLog``.
    ``group``: the data-parallel group (``parallel/mesh.py``) or None."""
    from ..data.build import build_train_data_loader
    from ..engine import solver
    from ..engine.tensorboard_writer import TensorboardWriter
    from ..engine.trainer import do_train
    from ..models.siammot import SiamMOT
    from ..parallel import mesh
    from ..utils.checkpoint import Checkpointer, resume

    rank, world = (group.rank, group.world) if group else (0, 1)
    model = SiamMOT(cfg, device=device)
    checkpointer = Checkpointer(output_dir) if rank == 0 else None
    start_iter = 0
    if rank != 0:       # rank 0's state arrives below
        net = model.build_master(model.build_net().state_dict())
        optimizer = solver.make_optimizer(cfg, net)
    elif checkpointer.latest() is not None:
        net = model.build_master(model.build_net().state_dict())
        optimizer = solver.make_optimizer(cfg, net)
        start_iter = resume(checkpointer, net, optimizer)
    else:
        net = model.build_master(initial_params(cfg, model, logger))
        optimizer = solver.make_optimizer(cfg, net)
    if group is not None:
        start_iter = mesh.sync_restored_state(group, net, optimizer,
                                              start_iter)

    static = None
    if cfg.TPU.INPUT_HEIGHT and cfg.TPU.INPUT_WIDTH:
        static = (cfg.TPU.INPUT_WIDTH, cfg.TPU.INPUT_HEIGHT)
    accum = cfg.SOLVER.ACCUMULATION_STEPS
    step = solver.build_train_step(model, optimizer, accum_steps=accum,
                                   image_size=static) if group is None \
        else mesh.build_train_step(model, optimizer, group,
                                   accum_steps=accum, image_size=static)
    loader = build_train_data_loader(cfg, start_iter=start_iter,
                                     device=device, process_index=rank,
                                     process_count=world)
    tb = TensorboardWriter(cfg, os.path.join(output_dir, "tb")) \
        if rank == 0 else None
    try:
        return do_train(model, step, net, optimizer, loader, checkpointer,
                        max_iter=cfg.SOLVER.MAX_ITER,
                        checkpoint_period=cfg.SOLVER.CHECKPOINT_PERIOD,
                        start_iter=start_iter, tensorboard_writer=tb,
                        group=group)
    finally:
        if tb is not None:
            tb.close()


def main(argv=None):
    """Run the CLI; returns (the run directory, ``do_train``'s
    ``TrainLog``)."""
    args = parse_args(argv)

    from ..configs.defaults import get_cfg
    from ..parallel import mesh
    from ..utils.model_name import get_model_name

    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    rank, world, local = mesh.launcher_env()
    mesh.data_parallel_size(cfg, world)
    output_dir = os.path.join(args.train_dir,
                              get_model_name(cfg, args.model_suffix))
    group = None
    if "WORLD_SIZE" in os.environ:
        group = mesh.init_process_group(args.device, args.dist_backend,
                                        args.dist_url)
    device = group.device if group else mesh.rank_device(args.device, local)
    logger = logging.getLogger("siammot_tpu_torch")
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: "
                            "%(message)s")
    handlers = []
    if rank == 0:
        os.makedirs(output_dir, exist_ok=True)
        handlers.append(logging.FileHandler(os.path.join(output_dir,
                                                         "log.txt")))
        if not logging.getLogger().handlers and not logger.handlers:
            handlers.append(logging.StreamHandler())
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    try:
        if rank == 0:
            logger.info("config:\n%s", cfg.dump())
            with open(os.path.join(output_dir, "config.yaml"), "w") as f:
                f.write(cfg.dump())
        if group is not None:
            logger.info("data parallel: rank 0 of %d on %s", group.world,
                        group.device)
        return output_dir, train(cfg, output_dir, logger, device, group)
    finally:
        for h in handlers:
            logger.removeHandler(h)
            h.close()
        if group is not None:
            mesh.destroy_process_group()


if __name__ == "__main__":
    main()
