"""The port stands alone: with ``jax``, ``flax``, ``yaml``, ``cv2``,
``PIL``, ``tensorboard``, ``matplotlib``, ``siammot_tpu``, ``demos``,
``tests`` and ``tools`` unimportable (as on the machine with the card,
which has none of the first seven), every module of
``siammot_tpu_torch`` and ``chip_smoke`` imports, two frames of
``track_frames`` run on the
CPU (and one frame of a DLA-46-C-FPN body with deformable stages), and
so does the training slice's code: a synthetic 720p training
batch (``utils/synth.train_batches``), the samplers (``core/matcher``,
``models/emm_sampler``), the optimizer (``engine/solver``) and two
iterations of ``engine/trainer.do_train``, then a frame and a training
step (stem and layer1 frozen, the trunk recomputed in the backward) of a
narrow ResNet-50 body; the MOT17 public-detection
recipe is read without ``yaml`` and tracks a given-detection frame, a
``TPU.MASKED_TRACK_KERNELS`` False frame runs, and so do two frames and
a training step with the exact gather pooler (``TPU.POOLER_WINDOWED``
and ``TRAIN_POOLER_WINDOWED`` False); and the dataset path: a
tiny MOT-layout sequence (rendered with ``cv2`` before the block) is
ingested, tracked by ``DatasetInference`` and evaluated, then run again
through ``tools/test_net``'s main function in public-detection mode from
a port checkpoint, once with one stream and once with two; and the
training CLI: two iterations of ``tools/train_net`` on DLA-MINI over the
committed training fixture (its loader, augmentation and event file),
the event file read back by the port's own reader; the several-device
layer: each ``SIAMMOT_DCN_IMPL`` form of the deformable conv forward and
backward, the multi-stream step with ``devices=["cpu", "cpu"]``,
``parallel/mesh.py``'s group of one, and ``tools/train_net`` under two
gloo ranks of ``torch.distributed.run``, whose processes block the same
imports (a ``sitecustomize`` on their path); the demo's CLI
(``siammot_tpu_torch.demos.demo``) over a JPEG folder and over an MJPEG
mp4 the port writes itself; the video readers (``data/container.py``,
``data/nvdec.py``): every committed H.264 and MPEG-4 Part 2 clip demuxes
and raises at a CPU decode, naming NVDEC, and the conversion of x264's
reconstruction is cv2's frames.  Also: no CUDA source
includes PyTorch's headers (they make the build take minutes instead of
seconds)."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys
    exec(BLOCK_SOURCE)
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
    # the exact gather pooler at inference (TPU.POOLER_WINDOWED False)
    wcfg = cfg.clone()
    wcfg.merge_from_list(["TPU.POOLER_WINDOWED", False])
    wres = track_frames(SiamMOT(wcfg, device="cpu"), params, frames,
                        (128, 96))
    assert all(o["valid"].any() for o in wres.outputs)
    assert np.isfinite(wres.outputs[1]["boxes"]).all()

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
    # one training step with the exact gather pooler
    # (TPU.TRAIN_POOLER_WINDOWED False)
    gcfg = cfg.clone()
    gcfg.merge_from_list(["TPU.TRAIN_POOLER_WINDOWED", False])
    gmodel = SiamMOT(gcfg, device="cpu")
    gnet = gmodel.build_master(params)
    gopt = make_optimizer(gcfg, gnet)
    gseen = []
    glog = do_train(gmodel, build_train_step(gmodel, gopt), gnet, gopt,
                    iter([(small, sgt, torch.tensor([[96, 64]] * 2))]),
                    None, max_iter=1, checkpoint_period=10, log_period=1,
                    tensorboard_writer=lambda it, m: gseen.append(m))
    assert glog.iteration == 1 and len(gseen) == 1
    assert all(np.isfinite(v) for v in gseen[0].values()), gseen

    # a narrow ResNet-50 body: a frame, then a training step with the stem
    # and layer1 frozen (FREEZE_CONV_BODY_AT 2) and the trunk recomputed
    # in the backward (TPU.REMAT)
    rcfg = cfg.clone()
    rcfg.merge_from_list(["MODEL.BACKBONE.CONV_BODY", "R-50-FPN",
                          "MODEL.RESNETS.STEM_OUT_CHANNELS", 8,
                          "MODEL.RESNETS.RES2_OUT_CHANNELS", 16,
                          "MODEL.RESNETS.WIDTH_PER_GROUP", 4,
                          "MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 32,
                          "MODEL.BACKBONE.FREEZE_CONV_BODY_AT", 2,
                          "TPU.REMAT", True])
    rmodel = SiamMOT(rcfg, device="cpu")
    rparams = {k: torch.from_numpy(
                   (rng.randn(*v.shape) * 0.05
                    + (1.0 if k.endswith("scale") else 0.0)).astype(
                        np.float32))
               for k, v in rmodel.build_net().state_dict().items()}
    rparams["box.predictor.cls_score.bias"] = torch.tensor([-3.0, 3.0])
    rres = track_frames(rmodel, rparams, frames[:1], (128, 96))
    assert np.isfinite(rres.outputs[0]["boxes"]).all()
    rnet = rmodel.build_master(rparams)
    ropt = make_optimizer(rcfg, rnet)
    before = {n: p.detach().clone() for n, p in rnet.named_parameters()}
    rseen = []
    rlog = do_train(rmodel, build_train_step(rmodel, ropt), rnet, ropt,
                    iter([(small, sgt, torch.tensor([[96, 64]] * 2))]),
                    None, max_iter=1, checkpoint_period=10, log_period=1,
                    tensorboard_writer=lambda it, m: rseen.append(m))
    assert rlog.iteration == 1 and len(rseen) == 1
    assert all(np.isfinite(v) for v in rseen[0].values()), rseen
    moved = {n: not torch.equal(p, before[n])
             for n, p in rnet.named_parameters()}
    frozen = [n for n in moved if n.startswith(("body.stem_",
                                                 "body.layer1_"))]
    assert len(frozen) == 11 and not any(moved[n] for n in frozen)
    assert sum(moved.values()) > 0.9 * (len(moved) - len(frozen))

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

    # the deformable conv's SIAMMOT_DCN_IMPL forms, forward and backward
    from siammot_tpu_torch.ops.deform_conv import deform_conv2d
    gen = torch.Generator().manual_seed(0)
    dx = torch.randn(1, 9, 13, 8, generator=gen)
    doff = 0.3 * torch.randn(1, 9, 13, 18, generator=gen)
    dk = torch.randn(3, 3, 8, 4, generator=gen)
    for impl in ("gather4", "patch", "shiftwin", "pallas"):
        os.environ["SIAMMOT_DCN_IMPL"] = impl
        leaves = [t.clone().requires_grad_() for t in (dx, doff, dk)]
        deform_conv2d(*leaves).sum().backward()
        assert all(torch.isfinite(t.grad).all() for t in leaves), impl
    del os.environ["SIAMMOT_DCN_IMPL"]

    # the multi-stream step sharded over two devices (the CPU twice)
    from siammot_tpu_torch.parallel.multistream import (
        Sharded, build_multistream_step, empty_states)
    smodel = SiamMOT(cfg.clone(), device="cpu")
    snet = smodel.cast_params(params)
    sstep = build_multistream_step(smodel, (128, 96), devices=["cpu", "cpu"])
    sstates = empty_states(smodel, 2)
    for f in frames:
        sout, sstates = sstep(snet, torch.as_tensor(np.stack([f, f])),
                              sstates)
    assert isinstance(sstates, Sharded) and sout.valid.shape[0] == 2

    # parallel/mesh.py in a group of one (gloo, a file store)
    from siammot_tpu_torch.parallel import mesh
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    group = mesh.init_process_group("cpu", None, "file://" + os.path.join(
        tempfile.mkdtemp(), "store"))
    assert group.world == 1 and not group.all_reduce_max(False)
    mesh.destroy_process_group()
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        del os.environ[k]

    # train_net under two gloo ranks of torch.distributed.run, every
    # process with the same imports blocked (``sitecustomize`` below)
    import subprocess
    block = tempfile.mkdtemp()
    with open(os.path.join(block, "sitecustomize.py"), "w") as fh:
        fh.write(BLOCK_SOURCE)
    env = dict(os.environ, PYTHONPATH=block + os.pathsep + REPO,
               OMP_NUM_THREADS="1")
    ddp_dir = tempfile.mkdtemp()
    res = subprocess.run([
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc-per-node", "2", "-m", "siammot_tpu_torch.tools.train_net",
        "--config-file", os.path.join(REPO, "configs", "dla",
                                      "DLA_34_FPN_EMM_SYNMOT_HARD.yaml"),
        "--train-dir", ddp_dir, "--device", "cpu"]
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
        "DATALOADER.NUM_WORKERS", "1"], capture_output=True, text=True,
        env=env, timeout=300, cwd=block)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    [ddp_run] = os.listdir(ddp_dir)
    ddp_files = os.listdir(os.path.join(ddp_dir, ddp_run))
    assert {"model_0000001.pth", "model_final.pth"} <= set(ddp_files)
    assert not any(blocked(m) for m in sys.modules), sorted(
        m for m in sys.modules if blocked(m))

    # the demo's CLI on the card's machine: the sequence's JPEG folder to
    # an mp4, then an MJPEG mp4 the port writes itself to JPEG frames
    import tempfile
    from siammot_tpu_torch.data.container import Mp4Writer
    from siammot_tpu_torch.demos import demo
    seq = os.path.join(DATA, "synmot_mini", "test", "SEQ-01", "img1")
    with tempfile.TemporaryDirectory() as tmp:
        tiny = os.path.join(tmp, "tiny.yaml")
        with open(tiny, "w") as f:
            f.write("INPUT:\\n  MIN_SIZE_TEST: 64\\n  MAX_SIZE_TEST: 96\\n"
                    "TPU:\\n  MAX_TRACKS: 4\\n")
        run = demo.main(["--demo-video", seq, "--config-file", tiny,
                         "--device", "cpu", "--output-path", tmp])
        assert len(run.rows) == 3 and os.path.isfile(run.output)
        mp4 = os.path.join(tmp, "clip.mp4")
        with Mp4Writer(mp4, 10.0, 128, 96) as wr:
            for name in sorted(os.listdir(seq)):
                with open(os.path.join(seq, name), "rb") as f:
                    wr.write(f.read())
        run = demo.main(["--demo-video", mp4, "--config-file", tiny,
                         "--device", "cpu", "--dump-video", "False",
                         "--output-path", tmp])
        assert len(os.listdir(run.output)) == 3
    assert not any(blocked(m) for m in sys.modules), sorted(
        m for m in sys.modules if blocked(m))

    # the video readers: every committed clip demuxes (AVI, MP4, Matroska,
    # WebM), its Motion JPEG decodes on the CPU, and its H.264, HEVC,
    # MPEG-4 Part 2, VP8, VP9 or AV1 decode on the CPU (8-bit 4:2:0, or
    # 10- and 12-bit and 4:4:4) raises naming NVDEC; the conversion of x264's reconstruction (on the CPU: the
    # plain version) is cv2's frames of the MP4
    import hashlib
    from siammot_tpu_torch.data.nvdec import nv12_to_rgb
    from siammot_tpu_torch.data.video_loader import video_frames
    vid = os.path.join(REPO, "tests", "fixtures", "video")
    clips = [n for n in sorted(os.listdir(vid)) if n.endswith((
        ".mp4", ".avi", ".mkv", ".webm"))]
    assert len(clips) == 23, clips
    for name in clips:
        if name.startswith("mjpeg"):
            next(iter(video_frames(os.path.join(vid, name))))
            continue
        try:
            next(iter(video_frames(os.path.join(vid, name))))
        except NotImplementedError as e:
            assert "NVDEC" in str(e), e
        else:
            raise AssertionError(f"{name} decoded on the CPU")
    rec = np.load(os.path.join(vid, "h264_small_ref.npz"))
    got = []
    for y, u, v in zip(rec["y"], rec["u"], rec["v"]):
        uv = np.stack([u, v], -1).reshape(len(u), -1)
        rgb = nv12_to_rgb(torch.from_numpy(np.concatenate([y, uv])), 200, 120)
        got.append(hashlib.sha256(rgb.numpy()).hexdigest())
    assert got == list(rec["cv2_sha256"])
    assert not any(blocked(m) for m in sys.modules), sorted(
        m for m in sys.modules if blocked(m))
    print("ISOLATED", len(names), int((result.state.ids >= 0).sum()))
""")

# what every process of the check runs first: the imports blocked
BLOCK = textwrap.dedent("""
    import sys
    BLOCKED = ("jax", "flax", "yaml", "cv2", "PIL", "tensorboard",
               "matplotlib", "siammot_tpu", "demos", "tests", "tools")

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
         f"REPO = {REPO!r}\nDATA = {str(tmp_path)!r}\n"
         f"BLOCK_SOURCE = {BLOCK!r}\n" + SCRIPT],
        capture_output=True, text=True, timeout=600, cwd="/", env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "ISOLATED" in res.stdout


def test_no_cuda_source_includes_torch_headers():
    pkg = os.path.join(REPO, "siammot_tpu_torch")
    files = [os.path.join(d, f) for d in ("ops/cuda", "data")
             for f in os.listdir(os.path.join(pkg, d))
             if f.endswith((".cu", ".cuh"))]
    assert len(files) >= 5 and "data/nvdec.cu" in files
    for f in files:
        with open(os.path.join(pkg, f)) as fh:
            text = fh.read()
        assert "torch/extension.h" not in text, f
        assert "#include <torch" not in text and "ATen" not in text, f
