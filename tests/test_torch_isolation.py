"""The port stands alone: with ``jax``, ``flax``, ``yaml``, ``siammot_tpu``,
``tests`` and ``tools`` unimportable (as on the machine with the card,
which has none of the first three), every module of ``siammot_tpu_torch``
and ``chip_smoke`` imports, two frames of ``track_frames`` run on the
CPU, and so does the training slice's code: a synthetic 720p training
batch (``utils/synth.train_batches``), the samplers (``core/matcher``,
``models/emm_sampler``), the optimizer (``engine/solver``) and two
iterations of ``engine/trainer.do_train``.  Also: no CUDA source includes
PyTorch's headers (they make the build take minutes instead of
seconds)."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys
    BLOCKED = ("jax", "flax", "yaml", "siammot_tpu", "tests", "tools")

    def blocked(name):
        return name.split(".")[0] in BLOCKED

    for name in [m for m in sys.modules if blocked(m)]:
        del sys.modules[name]

    class Block:
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError(f"blocked import: {name}")
            return None

    sys.meta_path.insert(0, Block())
    sys.path.insert(0, REPO)

    import numpy as np
    import torch
    import siammot_tpu_torch
    names = ["chip_smoke"] + [m.name for m in pkgutil.walk_packages(
        siammot_tpu_torch.__path__, "siammot_tpu_torch.")]
    for name in names:
        importlib.import_module(name)

    from siammot_tpu_torch.configs.defaults import get_cfg
    from siammot_tpu_torch.engine.inferencer import track_frames
    from siammot_tpu_torch.models.siammot import SiamMOT

    cfg = get_cfg()
    cfg.merge_from_list([
        "MODEL.BACKBONE.CONV_BODY", "DLA-MINI-FPN",
        "MODEL.DLA.DLA_STAGE2_OUT_CHANNELS", 16,
        "MODEL.DLA.DLA_STAGE3_OUT_CHANNELS", 32,
        "MODEL.DLA.DLA_STAGE4_OUT_CHANNELS", 64,
        "MODEL.DLA.DLA_STAGE5_OUT_CHANNELS", 64,
        "MODEL.DLA.BACKBONE_OUT_CHANNELS", 32,
        "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", 64,
        "TPU.MAX_TRACKS", 8,
        "TPU.COMPUTE_DTYPE", "float32", "TPU.POOLER_DTYPE", "float32"])
    model = SiamMOT(cfg, device="cpu")
    rng = np.random.RandomState(0)
    params = {k: torch.from_numpy(
                  (rng.randn(*v.shape) * 0.05
                   + (1.0 if k.endswith("scale") else 0.0)).astype(np.float32))
              for k, v in model.build_net().state_dict().items()}
    params["box.predictor.cls_score.bias"] = torch.tensor([-3.0, 3.0])
    frames = [rng.randint(0, 255, (1, 96, 128, 3)).astype(np.uint8)
              for _ in range(2)]
    result = track_frames(model, params, frames, (128, 96))
    assert len(result.outputs) == 2
    assert all(o["valid"].any() for o in result.outputs)
    assert not any(blocked(m) for m in sys.modules), sorted(
        m for m in sys.modules if blocked(m))

    # the training slice: a 720p batch of two clip pairs, then two steps
    from siammot_tpu_torch.core.structures import Boxes
    from siammot_tpu_torch.engine.solver import (build_train_step,
                                                 make_optimizer)
    from siammot_tpu_torch.engine.trainer import do_train
    from siammot_tpu_torch.utils.synth import train_batches
    images, gt, sizes = next(train_batches(3, 736, 100))
    assert images.shape == (4, 736, 1280, 3) and images.dtype == torch.uint8
    ids = gt.ids[gt.valid]
    assert gt.valid.sum() == 160 and len(ids.unique()) == 80
    assert torch.equal(gt.ids[0], gt.ids[1]) and not torch.equal(gt.ids[0],
                                                                  gt.ids[2])
    b = gt.boxes[gt.valid]
    assert (b[:, :2] >= 0).all() and (b[:, 2] <= 1279).all() \
        and (b[:, 3] <= 719).all() and (b[:, 2:] > b[:, :2]).all()

    cfg.merge_from_list(["MODEL.RPN.PRE_NMS_TOP_N_TRAIN", 32,
                         "MODEL.RPN.POST_NMS_TOP_N_TRAIN", 16,
                         "MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN", 16,
                         "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 16,
                         "MODEL.TRACK_HEAD.PROPOSAL_PER_IMAGE", 8,
                         "TPU.MAX_GT", 4])
    model = SiamMOT(cfg, device="cpu")
    net = model.build_master(params)
    opt = make_optimizer(cfg, net)
    small = torch.from_numpy(rng.randint(0, 255, (2, 64, 96, 3)).astype(
        np.uint8))
    boxes = torch.tensor([[[4., 6., 40., 50.], [30., 10., 70., 40.],
                           [50., 20., 90., 60.], [0., 0., 0., 0.]]] * 2)
    sgt = Boxes(boxes=boxes, scores=torch.ones(2, 4),
                ids=torch.tensor([[0, 1, 2, -1]] * 2, dtype=torch.int32),
                labels=torch.tensor([[1, 1, 1, 0]] * 2, dtype=torch.int32),
                valid=torch.tensor([[True, True, True, False]] * 2))
    seen = []
    log = do_train(model, build_train_step(model, opt), net, opt,
                   iter([(small, sgt, torch.tensor([[96, 64]] * 2))] * 3),
                   None, max_iter=2, checkpoint_period=10, log_period=1,
                   tensorboard_writer=lambda it, m: seen.append(m))
    assert log.iteration == 2 and opt.count == 2 and len(seen) == 2
    assert all(np.isfinite(v) for m in seen for v in m.values()), seen
    assert not any(blocked(m) for m in sys.modules), sorted(
        m for m in sys.modules if blocked(m))
    print("ISOLATED", len(names), int((result.state.ids >= 0).sum()))
""")


def test_port_runs_without_jax_yaml_or_the_jax_package():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "-c", f"REPO = {REPO!r}\n" + SCRIPT],
        capture_output=True, text=True, timeout=600, cwd="/", env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "ISOLATED" in res.stdout


def test_no_cuda_source_includes_torch_headers():
    src = os.path.join(REPO, "siammot_tpu_torch", "ops", "cuda")
    files = [f for f in os.listdir(src) if f.endswith((".cu", ".cuh"))]
    assert len(files) >= 4
    for f in files:
        with open(os.path.join(src, f)) as fh:
            text = fh.read()
        assert "torch/extension.h" not in text, f
        assert "#include <torch" not in text and "ATen" not in text, f
