"""Dataset inference and evaluation CLI of the port (counterpart of
``tools/test_net.py``): build the model, load a checkpoint, load the test
dataset's annotations, its filter and (in given-detection mode) its
public detections, and run ``DatasetInference`` (per-video JSON cache,
track post-filter, CLEAR-MOT summary).

    python -m siammot_tpu_torch.tools.test_net \\
        --config-file configs/dla/DLA_34_FPN_EMM_SYNMOT_HARD.yaml \\
        --output-dir out/ --model-file fixtures/bench_weights_f16.npz \\
        --test-dataset SYNMOT_MINI --set test \\
        DATASETS.ROOT_DIR tests/fixtures

``--model-file`` takes a port checkpoint (a ``model_*.pth`` file, or a
directory whose latest is taken), a reference ``.pth`` or a flat
flax-tree ``.npz``; without it the network runs on its fresh
initialisation, as the JAX tool's does.  ``--n-streams S`` tracks S
videos at once as lanes of one batched frame step (the multi-stream
engine).  The model runs on the card unless ``--device cpu`` asks for
the CPU.
"""

from __future__ import annotations

import argparse
import logging
import os


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="SiamMOT inference "
                                                 "(PyTorch port)")
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--model-file", default=None,
                        help="port checkpoint (.pth, or a directory holding "
                             "model_*.pth), reference .pth, or flax-tree "
                             ".npz")
    parser.add_argument("--test-dataset", required=True)
    parser.add_argument("--set", default="test",
                        choices=("train", "val", "test"))
    parser.add_argument("--n-streams", type=int, default=1,
                        help="track this many videos at once, as lanes of "
                             "one batched frame step (each video's output "
                             "equals its own run with 1)")
    parser.add_argument("--eval-det-ap", action="store_true",
                        help="also report detection AP@[0.50:0.95] over the "
                             "post-filtered tracks")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the model (default: the card)")
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def main(argv=None):
    """Run the CLI; returns the ``DatasetInference`` after evaluation."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s: %(message)s")
    logger = logging.getLogger("siammot_tpu_torch")

    from ..configs.defaults import get_cfg
    from ..data.data_utils import load_dataset_anno, load_public_detection
    from ..data.filters import build_data_filter_fn
    from ..engine.inferencer import DatasetInference
    from ..models.siammot import SiamMOT
    from ..utils.checkpoint import load_model_file

    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)

    model = SiamMOT(cfg, device=args.device)
    if args.model_file:
        params = load_model_file(args.model_file, model)
    else:
        logger.warning("no --model-file: the network's fresh "
                       "initialisation")
        params = model.build_net().state_dict()

    dataset, info = load_dataset_anno(cfg, args.test_dataset, set=args.set)
    filter_fn = build_data_filter_fn(args.test_dataset)
    public_detection = None
    if cfg.INFERENCE.USE_GIVEN_DETECTIONS:
        public_detection = load_public_detection(cfg, args.test_dataset)

    os.makedirs(args.output_dir, exist_ok=True)
    inference = DatasetInference(cfg, model, params, dataset,
                                 args.output_dir, filter_fn,
                                 public_detection,
                                 dataset_root=info.get("dataset_root", ""),
                                 n_streams=args.n_streams)
    inference()
    if args.eval_det_ap:
        _, txt = inference.eval_det_ap()
        logger.info(txt)
    return inference


if __name__ == "__main__":
    main()
