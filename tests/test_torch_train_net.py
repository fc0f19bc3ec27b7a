"""The port's training CLI, ``python -m siammot_tpu_torch.tools.train_net``,
on the CPU.

``train_net.main`` with ``--device cpu`` trains DLA-MINI over the
committed training fixture (both modalities, the SYNMOT_HARD recipe's
augmentation) for 4 iterations with a checkpoint at 2: the run directory
holds ``config.yaml`` (which merges back into the same configuration),
``log.txt``, the checkpoints and a TensorBoard event file with a point
per loss tag at the last iteration (do_train logs every 20 and at the
end).  A second directory copied at iteration 2 (the later checkpoints
deleted) resumes there and ends bitwise where the uninterrupted run
ended, net and optimizer, on one CPU thread.  ``MODEL.WEIGHT`` initialises
the parameters (a shape that differs raises), the run directory's name is
the JAX package's, and the event file read back with ``tensorboard``'s
``EventAccumulator`` gives the tags, steps, values and image grid of the
JAX writer's file for the same calls.
"""

import glob
import io
import os
import shutil

import numpy as np
import pytest
import torch

from siammot_tpu.configs.defaults import get_cfg as jax_get_cfg
from siammot_tpu.core.structures import Boxes as JaxBoxes
from siammot_tpu.engine.tensorboard_writer import \
    TensorboardWriter as JaxWriter
from siammot_tpu.utils.model_name import get_model_name as jax_model_name
from siammot_tpu_torch.configs.defaults import get_cfg
from siammot_tpu_torch.core.structures import Boxes
from siammot_tpu_torch.engine.tensorboard_writer import (TensorboardWriter,
                                                         read_events)
from siammot_tpu_torch.models.siammot import SiamMOT
from siammot_tpu_torch.tools import train_net
from siammot_tpu_torch.utils.checkpoint import Checkpointer
from siammot_tpu_torch.utils.model_name import get_model_name
from siammot_tpu_torch.utils.weights import save_npz
from torch_port_util import MINI

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "configs", "dla",
                      "DLA_34_FPN_EMM_SYNMOT_HARD.yaml")
OPTS = [str(v) for v in MINI] + [
    "DATASETS.ROOT_DIR", os.path.join(REPO, "tests", "fixtures"),
    "DATASETS.TRAIN", "('SYNMOT_MULTI_TRAIN', 'SYNCROWD_MINI_train_fbox')",
    "INPUT.MIN_SIZE_TRAIN", "(96,)", "INPUT.MAX_SIZE_TRAIN", "160",
    "TPU.INPUT_HEIGHT", "96", "TPU.INPUT_WIDTH", "160",
    "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", "32",
    "MODEL.RPN.POST_NMS_TOP_N_TRAIN", "16",
    "MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN", "16",
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "16",
    "MODEL.TRACK_HEAD.PROPOSAL_PER_IMAGE", "8",
    "SOLVER.MAX_ITER", "4", "SOLVER.CHECKPOINT_PERIOD", "2",
    "SOLVER.WARMUP_ITERS", "2", "DATALOADER.NUM_WORKERS", "2"]
LOSSES = ("loss_box_reg", "loss_classifier", "loss_objectness",
          "loss_rpn_box_reg", "loss_tracker_center", "loss_tracker_class",
          "loss_tracker_motion")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread: the threaded CPU convolutions' weight gradients sum
    in a varying order, so a resumed run would differ in the last bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(train_dir, *extra):
    return train_net.main(["--config-file", RECIPE, "--train-dir",
                           str(train_dir), "--device", "cpu"]
                          + OPTS + list(extra))


@pytest.fixture(scope="module")
def first_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    out, log = run(root)
    return out, log


def test_cli_trains_and_writes_its_run_directory(first_run):
    out, log = first_run
    assert log.iteration == 4 and len(log.step_seconds) == 4
    assert len(log.data_seconds) == 4
    assert os.path.basename(out) == \
        "DLAMINI_box_EMM_SYNMOT_MULTI_TRAIN_SYNCROWD_MINI_train_fbox"
    for f in ("config.yaml", "log.txt", "model_0000002.pth",
              "model_0000004.pth", "model_final.pth"):
        assert os.path.exists(os.path.join(out, f)), f
    with open(os.path.join(out, "log.txt")) as f:
        text = f.read()
    assert "iter 4/4" in text and "Total training time" in text
    cfg = get_cfg()
    cfg.merge_from_file(RECIPE)
    cfg.merge_from_list(OPTS)
    back = get_cfg()
    back.merge_from_file(os.path.join(out, "config.yaml"))
    assert back == cfg
    files = glob.glob(os.path.join(out, "tb", "events.out.tfevents.*"))
    assert len(files) == 1
    events = read_events(files[0])
    assert events[0]["file_version"] == "brain.Event:2"
    scalars = {}
    for e in events[1:]:
        for tag, v in e["scalars"].items():
            scalars.setdefault(tag, []).append((e["step"], v))
    assert sorted(scalars) == sorted(["loss/total"]
                                     + [f"loss/{k}" for k in LOSSES])
    for tag, points in scalars.items():
        assert len(points) == 1 and points[0][0] == 4, tag
        assert np.isfinite(points[0][1])
    total = sum(scalars[f"loss/{k}"][0][1] for k in LOSSES)
    assert abs(total - scalars["loss/total"][0][1]) <= 1e-4 * abs(total)


def test_resume_ends_bitwise_where_the_uninterrupted_run_ends(first_run,
                                                              tmp_path):
    out, _ = first_run
    resumed = tmp_path / os.path.basename(out)
    shutil.copytree(out, resumed)
    os.remove(resumed / "model_0000004.pth")
    os.remove(resumed / "model_final.pth")
    assert Checkpointer(str(resumed)).latest().endswith("model_0000002.pth")
    out2, log = run(tmp_path)
    assert out2 == str(resumed) and log.iteration == 4
    assert len(log.step_seconds) == 2            # iterations 3 and 4 only
    want = torch.load(os.path.join(out, "model_final.pth"),
                      weights_only=True)
    got = torch.load(os.path.join(out2, "model_final.pth"),
                     weights_only=True)
    assert got["iteration"] == want["iteration"] == 4
    assert got["model"].keys() == want["model"].keys()
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    assert got["optimizer"]["count"] == want["optimizer"]["count"] == 4
    for k, st in want["optimizer"]["sgd"]["state"].items():
        assert torch.equal(got["optimizer"]["sgd"]["state"][k]
                           ["momentum_buffer"], st["momentum_buffer"]), k


def test_model_weight_initialises_and_a_mismatch_raises(tmp_path):
    cfg = get_cfg()
    cfg.merge_from_file(RECIPE)
    cfg.merge_from_list(OPTS)
    model = SiamMOT(cfg, device="cpu")
    torch.manual_seed(3)
    sd = model.build_net().state_dict()
    npz = str(tmp_path / "w.npz")
    save_npz(npz, sd)
    got = train_net.initial_params(cfg.clone(), model, _Log())
    assert any(not torch.equal(got[k], sd[k]) for k in sd)  # seeded init
    cfg.merge_from_list(["MODEL.WEIGHT", npz])
    got = train_net.initial_params(cfg, model, _Log())
    for k, v in sd.items():
        assert torch.equal(got[k].float(), v.float()), k
    other = get_cfg()
    other.merge_from_file(RECIPE)
    other.merge_from_list(OPTS + ["MODEL.DLA.BACKBONE_OUT_CHANNELS", 16,
                                  "MODEL.WEIGHT", npz])
    with pytest.raises(ValueError, match="shape-compatible"):
        train_net.initial_params(other, SiamMOT(other, device="cpu"), _Log())


class _Log:
    def info(self, *args):
        pass


def test_cli_defaults_and_run_names_match_jax():
    assert train_net.parse_args(["--config-file", RECIPE]).device == "cuda"
    for body, suffix, train in (("DLA-34-FPN", "", ("SYNMOT_HARD",)),
                                ("DLA-102-FPN", "tag", ("MOT17", "CRP"))):
        cfg, jcfg = get_cfg(), jax_get_cfg()
        for c in (cfg, jcfg):
            c.merge_from_list(["MODEL.BACKBONE.CONV_BODY", body,
                               "DATASETS.TRAIN", train])
        assert get_model_name(cfg, suffix) == jax_model_name(jcfg, suffix)


def test_event_file_reads_back_as_the_jax_writers(tmp_path):
    from PIL import Image
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator

    cfg = get_cfg()
    rng = np.random.RandomState(0)
    calls = [(20, {"loss": 1.5, "loss_objectness": 0.25}),
             (40, {"loss": 1.25, "loss_objectness": 0.125,
                   "loss_tracker_motion": 3.0}),
             (500, {"loss": 0.5, "loss_objectness": 1e-3})]
    images = rng.randint(0, 256, (3, 48, 64, 3)).astype(np.uint8)
    boxes = np.array([[[4, 5, 30, 40], [-3, 10, 70, 20], [0, 0, 0, 0]]] * 3,
                     np.float32)
    valid = np.array([[True, True, False]] * 3)
    fields = dict(scores=np.ones((3, 3), np.float32),
                  ids=np.zeros((3, 3), np.int32),
                  labels=np.ones((3, 3), np.int32))
    dirs = {}
    for name, writer, boxes_cls in (("port", TensorboardWriter, Boxes),
                                    ("jax", JaxWriter, JaxBoxes)):
        w = writer(cfg, str(tmp_path / name), image_period=500)
        gt = boxes_cls(boxes=boxes, valid=valid, **fields)
        for it, metrics in calls:
            w(it, metrics, images=images, gt=gt)
        w.write_image(7, images.astype(np.float32) / 255.0, gt)
        w.close()
        acc = EventAccumulator(str(tmp_path / name),
                               size_guidance={"images": 0, "scalars": 0})
        acc.Reload()
        dirs[name] = acc
    port, jax_acc = dirs["port"], dirs["jax"]
    assert sorted(port.Tags()["scalars"]) == sorted(jax_acc.Tags()["scalars"])
    for tag in jax_acc.Tags()["scalars"]:
        assert [(s.step, s.value) for s in port.Scalars(tag)] == \
            [(s.step, s.value) for s in jax_acc.Scalars(tag)], tag
    got, want = port.Images("train/gt"), jax_acc.Images("train/gt")
    assert [i.step for i in got] == [i.step for i in want] == [500, 7]
    for g, w in zip(got, want):
        assert (g.height, g.width) == (w.height, w.width)
        np.testing.assert_array_equal(
            np.asarray(Image.open(io.BytesIO(g.encoded_image_string))),
            np.asarray(Image.open(io.BytesIO(w.encoded_image_string))))
