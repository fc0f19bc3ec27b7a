"""The port stands alone: with ``jax``, ``flax``, ``yaml``, ``cv2``,
``PIL``, ``tensorboard``, ``siammot_tpu``, ``tests`` and ``tools``
unimportable (as on the machine with the card, which has none of the
first six), every module of
``siammot_tpu_torch`` and ``chip_smoke`` imports, two frames of
``track_frames`` run on the
CPU (and one frame of a DLA-46-C-FPN body with deformable stages), and
so does the training slice's code: a synthetic 720p training
batch (``utils/synth.train_batches``), the samplers (``core/matcher``,
``models/emm_sampler``), the optimizer (``engine/solver``) and two
iterations of ``engine/trainer.do_train``; the MOT17 public-detection
recipe is read without ``yaml`` and tracks a given-detection frame, and
a ``TPU.MASKED_TRACK_KERNELS`` False frame runs; and the dataset path: a
tiny MOT-layout sequence (rendered with ``cv2`` before the block) is
ingested, tracked by ``DatasetInference`` and evaluated, then run again
through ``tools/test_net``'s main function in public-detection mode from
a port checkpoint, once with one stream and once with two; and the
training CLI: two iterations of ``tools/train_net`` on DLA-MINI over the
committed training fixture (its loader, augmentation and event file),
the event file read back by the port's own reader.  Also: no CUDA source
includes PyTorch's headers (they make the build take minutes instead of
seconds)."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys
    BLOCKED = ("jax", "flax", "yaml", "cv2", "PIL", "tensorboard",
               "siammot_tpu", "tests", "tools")

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
    mini = ["MODEL.BACKBONE.CONV_BODY", "DLA-MINI-FPN",
            "MODEL.DLA.DLA_STAGE2_OUT_CHANNELS", 16,
            "MODEL.DLA.DLA_STAGE3_OUT_CHANNELS", 32,
            "MODEL.DLA.DLA_STAGE4_OUT_CHANNELS", 64,
            "MODEL.DLA.DLA_STAGE5_OUT_CHANNELS", 64,
            "MODEL.DLA.BACKBONE_OUT_CHANNELS", 32,
            "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", 64,
            "TPU.MAX_TRACKS", 8,
            "TPU.COMPUTE_DTYPE", "float32", "TPU.POOLER_DTYPE", "float32"]
    cfg.merge_from_list(mini)
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

    # a deformable body: DLA-46-C-FPN with DCN stages (kernel 9's plain
    # version on the CPU), one frame
    dcfg = cfg.clone()
    dcfg.merge_from_list([
        "MODEL.BACKBONE.CONV_BODY", "DLA-46-C-FPN",
        "MODEL.DLA.DLA_STAGE2_OUT_CHANNELS", 64,
        "MODEL.DLA.DLA_STAGE3_OUT_CHANNELS", 64,
        "MODEL.DLA.DLA_STAGE4_OUT_CHANNELS", 128,
        "MODEL.DLA.DLA_STAGE5_OUT_CHANNELS", 256,
        "MODEL.DLA.STAGE_WITH_DCN", (False, False, False, True, True, True)])
    dmodel = SiamMOT(dcfg, device="cpu")
    dparams = {k: torch.from_numpy(
                   (rng.randn(*v.shape) * 0.05
                    + (1.0 if k.endswith("scale") else 0.0)).astype(
                        np.float32))
               for k, v in dmodel.build_net().state_dict().items()}
    assert sum(k.endswith("conv2.offset.weight") for k in dparams) == 10
    dres = track_frames(dmodel, dparams, frames[:1], (128, 96))
    assert np.isfinite(dres.outputs[0]["boxes"]).all()

    # the MOT17 public-detection recipe, read without yaml, on the small
    # body: a given-detection frame (and a raise without detections), then
    # a frame of the unmasked EMM route (TPU.MASKED_TRACK_KERNELS False)
    import os
    from siammot_tpu_torch.utils.synth import public_detections
    mcfg = get_cfg()
    mcfg.merge_from_file(os.path.join(REPO, "configs", "dla",
                                      "DLA_34_FPN_EMM_MOT17.yaml"))
    assert mcfg.INFERENCE.USE_GIVEN_DETECTIONS is True
    assert mcfg.INPUT.AMODAL is True and mcfg.INPUT.MAX_SIZE_TEST == 1500
    for key in ("MODEL.BACKBONE.CONV_BODY", "MODEL.DLA.BACKBONE_OUT_CHANNELS",
                "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", "TPU.MAX_TRACKS",
                "TPU.COMPUTE_DTYPE", "TPU.POOLER_DTYPE") + tuple(
                    f"MODEL.DLA.DLA_STAGE{i}_OUT_CHANNELS" for i in range(2, 6)):
        node, leaf = mcfg, key.split(".")
        src = cfg
        for part in leaf[:-1]:
            node, src = node[part], src[part]
        node[leaf[-1]] = src[leaf[-1]]
    gmodel = SiamMOT(mcfg, device="cpu")
    try:
        track_frames(gmodel, params, frames[:1], (128, 96))
        raise AssertionError("given-detection recipe ran without detections")
    except ValueError:
        pass
    boxes = [np.array([[10, 8, 40, 80], [60, 20, 95, 90]], np.float32)] * 2
    dets = public_detections(boxes, (128, 96), seed=1, drop=0.0,
                             false_positives=1, scale_xy=(2.0, 2.0))
    gres = track_frames(gmodel, params, frames, (128, 96), given=dets,
                        original_size=(256, 192))
    assert gres.outputs[0]["valid"].any()
    assert gres.outputs[0]["boxes"][gres.outputs[0]["valid"]].max() < 200
    ucfg = cfg.clone()
    ucfg.merge_from_list(["TPU.MASKED_TRACK_KERNELS", False])
    ures = track_frames(SiamMOT(ucfg, device="cpu"), params, frames,
                        (128, 96))
    assert all(o["valid"].any() for o in ures.outputs)
    assert np.isfinite(ures.outputs[1]["boxes"]).all()

    # the dataset path over the sequence rendered before the block:
    # ingestion, DatasetInference with CLEAR-MOT, then test_net's main
    # function in public-detection mode from a port checkpoint
    import tempfile
    from siammot_tpu_torch.data.ingestion.ingest_mot import ingest_mot
    from siammot_tpu_torch.data.motion_dataset import MotionDataset
    from siammot_tpu_torch.engine.inferencer import DatasetInference
    from siammot_tpu_torch.tools import test_net
    from siammot_tpu_torch.utils.checkpoint import Checkpointer
    data = os.path.join(DATA, "synmot_mini")
    ingest_mot(data)
    ds = MotionDataset(root_path=data)
    assert [s for s, _ in ds.get_split("test")] == ["SEQ-01"]
    small = ["INPUT.MIN_SIZE_TEST", 96, "INPUT.MAX_SIZE_TEST", 128]
    icfg = cfg.clone()
    icfg.merge_from_list(small)
    out = tempfile.mkdtemp()
    inf = DatasetInference(icfg, SiamMOT(icfg, device="cpu"), params,
                           ds.get_split("test"), out,
                           dataset_root=ds.data_root_path)
    accs, text = inf()
    assert "OVERALL" in text and inf.speed["SEQ-01"][0] == 3
    assert os.path.exists(os.path.join(out, "SEQ-01.json"))
    ckpt = Checkpointer(os.path.join(out, "ckpt")).save(1, params)
    opts = [str(v) for v in mini + small + ["DATASETS.ROOT_DIR", DATA]]
    tinf = test_net.main(["--config-file", os.path.join(
        REPO, "configs", "dla", "DLA_34_FPN_EMM_SYNMOT_HARD.yaml"),
        "--output-dir", os.path.join(out, "given"), "--model-file", ckpt,
        "--test-dataset", "SYNMOT_MINI", "--device", "cpu"] + opts)
    assert tinf._cfg.INFERENCE.USE_GIVEN_DETECTIONS
    assert tinf.speed["SEQ-01"][0] == 3 and "SEQ-01" in tinf.accs
    # the multi-stream engine: the sequence beside an empty lane
    minf = test_net.main(["--config-file", os.path.join(
        REPO, "configs", "dla", "DLA_34_FPN_EMM_SYNMOT_HARD.yaml"),
        "--output-dir", os.path.join(out, "streams"), "--model-file", ckpt,
        "--test-dataset", "SYNMOT_MINI", "--device", "cpu",
        "--n-streams", "2"] + opts)
    assert minf.speed["SEQ-01"][0] == 3 and "SEQ-01" in minf.accs
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

    # the training CLI over the committed fixture: loader, augmentation,
    # checkpoints and the event file
    import glob
    from siammot_tpu_torch.engine.tensorboard_writer import read_events
    from siammot_tpu_torch.tools import train_net
    run_dir, tlog = train_net.main([
        "--config-file", os.path.join(REPO, "configs", "dla",
                                      "DLA_34_FPN_EMM_SYNMOT_HARD.yaml"),
        "--train-dir", tempfile.mkdtemp(), "--device", "cpu"]
        + [str(v) for v in mini] + [
        "DATASETS.ROOT_DIR", os.path.join(REPO, "tests", "fixtures"),
        "DATASETS.TRAIN", "('SYNMOT_MULTI_TRAIN', "
                          "'SYNCROWD_MINI_train_fbox')",
        "INPUT.MIN_SIZE_TRAIN", "(96,)", "INPUT.MAX_SIZE_TRAIN", "160",
        "TPU.INPUT_HEIGHT", "96", "TPU.INPUT_WIDTH", "160",
        "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", "32",
        "MODEL.RPN.POST_NMS_TOP_N_TRAIN", "16",
        "MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN", "16",
        "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "16",
        "MODEL.TRACK_HEAD.PROPOSAL_PER_IMAGE", "8",
        "SOLVER.MAX_ITER", "2", "SOLVER.CHECKPOINT_PERIOD", "1",
        "DATALOADER.NUM_WORKERS", "2"])
    assert tlog.iteration == 2
    assert os.path.exists(os.path.join(run_dir, "model_0000001.pth"))
    assert os.path.exists(os.path.join(run_dir, "model_final.pth"))
    events = read_events(glob.glob(os.path.join(run_dir, "tb",
                                                "events.out.tfevents.*"))[0])
    assert [e["step"] for e in events if "loss/total" in e["scalars"]] == [2]
    assert not any(blocked(m) for m in sys.modules), sorted(
        m for m in sys.modules if blocked(m))
    print("ISOLATED", len(names), int((result.state.ids >= 0).sum()))
""")


def _render_sequence(root, n_frames=3, w=128, h=96):
    """A MOT-layout test sequence (JPEG frames, gt, public detections)
    under ``root/synmot_mini``, written with cv2 before the block."""
    import cv2
    import numpy as np
    seq = root / "synmot_mini" / "test" / "SEQ-01"
    for d in ("img1", "gt", "det"):
        (seq / d).mkdir(parents=True)
    (seq / "seqinfo.ini").write_text(
        f"[Sequence]\nname=SEQ-01\nimDir=img1\nframeRate=10\n"
        f"seqLength={n_frames}\nimWidth={w}\nimHeight={h}\nimExt=.jpg\n")
    rng = np.random.RandomState(0)
    gt, det = [], []
    for t in range(n_frames):
        cv2.imwrite(str(seq / "img1" / f"{t + 1:06d}.jpg"),
                    rng.randint(0, 255, (h, w, 3)).astype(np.uint8))
        for k in range(2):
            gt.append(f"{t + 1},{k + 1},{10 + 50 * k + t},12,30,60,1,1,1.0")
            det.append(f"{t + 1},-1,{11 + 50 * k + t},13,29,58,0.9")
    (seq / "gt" / "gt.txt").write_text("\n".join(gt))
    (seq / "det" / "det.txt").write_text("\n".join(det))


def test_port_runs_without_jax_yaml_or_the_jax_package(tmp_path):
    _render_sequence(tmp_path)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "-c",
         f"REPO = {REPO!r}\nDATA = {str(tmp_path)!r}\n" + SCRIPT],
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
