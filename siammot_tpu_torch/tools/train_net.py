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
asks for the CPU.  The JAX tool's multi-host lines (``jax.distributed``,
the device mesh, replicating the state onto it and syncing a restored
state across processes) have no counterpart here: the port trains on one
card, process 0 of 1.
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
                             "(default: the card)")
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


def train(cfg, output_dir: str, logger, device: str):
    """Build the model, its optimizer, the loader and the writer, resume
    or initialise, and run ``do_train``; returns its ``TrainLog``."""
    from ..data.build import build_train_data_loader
    from ..engine.solver import build_train_step, make_optimizer
    from ..engine.tensorboard_writer import TensorboardWriter
    from ..engine.trainer import do_train
    from ..models.siammot import SiamMOT
    from ..utils.checkpoint import Checkpointer, resume

    model = SiamMOT(cfg, device=device)
    checkpointer = Checkpointer(output_dir)
    start_iter = 0
    if checkpointer.latest() is not None:
        net = model.build_master(model.build_net().state_dict())
        optimizer = make_optimizer(cfg, net)
        start_iter = resume(checkpointer, net, optimizer)
    else:
        net = model.build_master(initial_params(cfg, model, logger))
        optimizer = make_optimizer(cfg, net)

    static = None
    if cfg.TPU.INPUT_HEIGHT and cfg.TPU.INPUT_WIDTH:
        static = (cfg.TPU.INPUT_WIDTH, cfg.TPU.INPUT_HEIGHT)
    step = build_train_step(model, optimizer,
                            accum_steps=cfg.SOLVER.ACCUMULATION_STEPS,
                            image_size=static)
    loader = build_train_data_loader(cfg, start_iter=start_iter,
                                     device=device)
    tb = TensorboardWriter(cfg, os.path.join(output_dir, "tb"))
    try:
        return do_train(model, step, net, optimizer, loader, checkpointer,
                        max_iter=cfg.SOLVER.MAX_ITER,
                        checkpoint_period=cfg.SOLVER.CHECKPOINT_PERIOD,
                        start_iter=start_iter, tensorboard_writer=tb)
    finally:
        tb.close()


def main(argv=None):
    """Run the CLI; returns (the run directory, ``do_train``'s
    ``TrainLog``)."""
    args = parse_args(argv)

    from ..configs.defaults import get_cfg
    from ..utils.model_name import get_model_name

    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    if cfg.TPU.DATA_PARALLEL > 1:
        raise ValueError("TPU.DATA_PARALLEL > 1: the port trains on one "
                         "card")

    output_dir = os.path.join(args.train_dir,
                              get_model_name(cfg, args.model_suffix))
    os.makedirs(output_dir, exist_ok=True)
    logger = logging.getLogger("siammot_tpu_torch")
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: "
                            "%(message)s")
    handlers = [logging.FileHandler(os.path.join(output_dir, "log.txt"))]
    if not logging.getLogger().handlers and not logger.handlers:
        handlers.append(logging.StreamHandler())
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    try:
        logger.info("config:\n%s", cfg.dump())
        with open(os.path.join(output_dir, "config.yaml"), "w") as f:
            f.write(cfg.dump())
        return output_dir, train(cfg, output_dir, logger, args.device)
    finally:
        for h in handlers:
            logger.removeHandler(h)
            h.close()


if __name__ == "__main__":
    main()
