"""Dataset inference of the port (``siammot_tpu_torch/data``,
``engine/inferencer.py``, ``tools/test_net.py``) against the JAX package.

* Frames: the port's libjpeg reader (``data/native.py``, its own build of
  its copy of ``frameio.cpp``) gives the bytes of the JAX package's native
  reader (``csrc/libframeio.so``, built as ``tests/test_native_frameio.py``
  builds it), at the file's size and resized, as uint8 and normalised
  float32; the port's ``EvalTransform`` resizes with that bilinear; the
  committed sequence's frames hash to what the JAX package decoded.
* Ingestion: ``ingest_mot``'s JSONs are byte-equal to the JAX ones.
* The committed sequence (``tests/fixtures/synmot_mini``, DLA-34-FPN-EMM
  on the bench weights, f32, on the CPU) through ``test_net``'s main
  function, in public-detection and RPN mode, against the JAX golden
  (``tests/fixtures/torch_golden_dataset.json.gz``): per-video JSON,
  post-filtered tracks and CLEAR-MOT summary within
  ``utils/dataset_golden.py``'s tolerances (ids, frames and labels exact,
  boxes 1e-2 px, confidences 1e-4, summary 1e-9, MOTP 1e-6); a second
  call reads the cache and runs no frame.
* A live JAX-vs-port ``DatasetInference`` on DLA-MINI with drawn weights
  over six frames rendered here, both modes: the same tolerances.  Drawn
  weights start a new id on every detection, so no track lasts the
  post-filter's five frames here; the golden runs above and
  ``tests/test_torch_eval.py`` hold the filter's rule.
"""

import configparser
import hashlib
import json
import os
import subprocess

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from siammot_tpu.configs.defaults import get_cfg as jax_get_cfg
from siammot_tpu.data import native as jax_native
from siammot_tpu.data.filters import build_data_filter_fn as jax_filter
from siammot_tpu.data.ingestion.ingest_mot import ingest_mot as jax_ingest
from siammot_tpu.data.motion_dataset import MotionDataset as JaxDataset
from siammot_tpu.data.transforms import EvalTransform as JaxTransform
from siammot_tpu.data.datasets import FrameReader as JaxFrameReader
from siammot_tpu.data.datasets import VideoDataset as JaxVideoDataset
from siammot_tpu.data.motion_dataset import DataSample as JaxSample
from siammot_tpu.data.video_loader import \
    video_metadata as jax_video_metadata
from siammot_tpu.data.video_loader import \
    normalized_frame_source as jax_source
from siammot_tpu.engine.inferencer import DatasetInference as JaxInference
from siammot_tpu.models.siammot import SiamMOT as JaxSiamMOT
from siammot_tpu_torch.configs.defaults import get_cfg
from siammot_tpu_torch.data import container, native
from siammot_tpu_torch.data.datasets import VideoDataset
from siammot_tpu_torch.data.filters import build_data_filter_fn
from siammot_tpu_torch.data.ingestion.ingest_mot import ingest_mot
from siammot_tpu_torch.data.motion_dataset import DataSample, MotionDataset
from siammot_tpu_torch.data.transforms import EvalTransform
from siammot_tpu_torch.data.video_loader import (normalized_frame_source,
                                                 video_metadata)
from siammot_tpu_torch.engine import inferencer
from siammot_tpu_torch.engine.inferencer import DatasetInference
from siammot_tpu_torch.models.siammot import SiamMOT
from siammot_tpu_torch.tools import test_net
from siammot_tpu_torch.utils import dataset_golden as dg
from siammot_tpu_torch.utils.weights import jax_to_torch
from torch_port_util import MINI, random_flax_params, unflatten_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two CPU threads for the port's f32 DLA-34 runs here: the suite runs
    several files at once on one machine, where a thread a core in every
    process oversubscribes it (these runs then took 30x their time
    alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jax_native_reader():
    if not jax_native.available():
        subprocess.run(["make", "-C", os.path.join(REPO, "csrc")],
                       check=True)
    assert jax_native.available()


def _jpegs(tmp_path, n=3, w=161, h=97):
    rng = np.random.RandomState(0)
    base = rng.randint(0, 255, (h // 4 + 1, w // 4 + 1, 3)).astype(np.uint8)
    paths = []
    for i in range(n):
        img = cv2.resize(np.roll(base, i, axis=1), (w, h),
                         interpolation=cv2.INTER_LINEAR)
        img = np.clip(img + rng.randn(h, w, 3) * 6, 0, 255).astype(np.uint8)
        p = str(tmp_path / f"{i + 1:06d}.jpg")
        cv2.imwrite(p, img, [cv2.IMWRITE_JPEG_QUALITY, 90])
        paths.append(p)
    return paths


@pytest.mark.parametrize("size", [(161, 97), (120, 72), (322, 194)])
def test_decode_is_byte_equal_to_the_jax_native_reader(tmp_path, size):
    paths = _jpegs(tmp_path)
    assert native.image_size(paths[0]) == jax_native.image_size(paths[0]) \
        == (161, 97)
    mean, std = np.array([0.485, 0.456, 0.406]), np.array([0.229, 0.224,
                                                          0.225])
    for p in paths:
        u8 = native.decode_resize(p, *size)
        np.testing.assert_array_equal(u8, jax_native.decode_resize(p, *size))
        np.testing.assert_array_equal(
            native.decode_resize_normalize(p, *size, mean, std),
            jax_native.decode_resize_normalize(p, *size, mean, std))
        # the transform's resize of a decoded frame is the decode's resize
        full = native.decode_resize(p, 161, 97)
        np.testing.assert_array_equal(native.resize_u8(full, *size), u8)


def test_image_size_reads_the_frame_header(tmp_path):
    img = np.random.RandomState(2).randint(0, 255, (53, 77, 3)).astype(
        np.uint8)
    for name, params in (("base.jpg", []),
                         ("prog.jpg", [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
                         ("q30.jpg", [cv2.IMWRITE_JPEG_QUALITY, 30])):
        p = str(tmp_path / name)
        cv2.imwrite(p, img, params)
        assert native.image_size(p) == jax_native.image_size(p) == (77, 53)
    (tmp_path / "x.jpg").write_bytes(b"\xff\xd8\xff\xe0\x00\x10JFIF")
    with pytest.raises(IOError, match="no JPEG frame header"):
        native.image_size(str(tmp_path / "x.jpg"))
    reader = native.FrameReader("cpu")
    assert reader.decoder == "libjpeg"
    np.testing.assert_array_equal(reader.decode(p, 40, 30),
                                  jax_native.decode_resize(p, 40, 30))


def test_eval_transform_and_frame_source_match_jax(tmp_path):
    _jpegs(tmp_path, n=2)
    for opts in ([], ["TPU.DEVICE_NORMALIZE", False],
                 ["INPUT.MIN_SIZE_TEST", 64, "INPUT.MAX_SIZE_TEST", 120]):
        cfg, jcfg = get_cfg(), jax_get_cfg()
        cfg.merge_from_list(opts)
        jcfg.merge_from_list(opts)
        tr, jtr = EvalTransform(cfg), JaxTransform(jcfg)
        assert tr.input_size(161, 97) == jtr.input_size(161, 97)
        got = list(normalized_frame_source(str(tmp_path), tr))
        want = list(jax_source(str(tmp_path), jtr))
        assert len(got) == len(want) == 2
        for (x, s), (y, t) in zip(got, want):
            assert s == t and x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    frame = native.decode_resize(str(tmp_path / "000001.jpg"), 161, 97)
    cfg = get_cfg()
    cfg.merge_from_list(["INPUT.MIN_SIZE_TEST", 64, "INPUT.MAX_SIZE_TEST",
                         120])
    x, (w, h) = EvalTransform(cfg)(frame)
    assert (w, h) == (106, 64) and x.shape == (1, 64, 128, 3)
    np.testing.assert_array_equal(x[0, :, :w], native.resize_u8(frame, w, h))
    assert not x[0, :, w:].any()
    assert video_metadata(str(tmp_path)) == dict(
        fps=30.0, number_of_frames=2,
        resolution={"width": 161, "height": 97})


def test_non_jpeg_sources_raise(tmp_path):
    """What the port cannot read raises, naming it; a PNG folder, which it
    now reads, gives the JAX package's metadata."""
    cfg = get_cfg()
    video = tmp_path / "clip.mp4"
    video.write_bytes(b"\0" * 16)
    with pytest.raises(NotImplementedError, match="MJPEG"):
        normalized_frame_source(str(video), EvalTransform(cfg))
    cv2.imwrite(str(tmp_path / "a.png"), np.zeros((8, 8, 3), np.uint8))
    assert video_metadata(str(tmp_path)) == jax_video_metadata(
        str(tmp_path)) == dict(fps=30.0, number_of_frames=1,
                               resolution={"width": 8, "height": 8})
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "000001.jpg").write_bytes(b"not a jpeg")
    with pytest.raises(IOError, match="not a JPEG"):
        list(normalized_frame_source(str(bad), EvalTransform(cfg)))
    # a frame header, then the file ends: libjpeg's error
    whole = (tmp_path / "whole.jpg")
    cv2.imwrite(str(whole), np.full((40, 60, 3), 90, np.uint8))
    (bad / "000001.jpg").write_bytes(whole.read_bytes()[:400])
    with pytest.raises(IOError, match="libjpeg"):
        list(normalized_frame_source(str(bad), EvalTransform(cfg)))


def test_video_dataset_on_png_folders_and_mjpeg_avi_matches_jax(
        tmp_path, monkeypatch):
    """The training clips of a committed sequence stored as a PNG folder
    and as an MJPEG AVI: the port's ``VideoDataset`` items (frames, gt
    boxes, ids, labels) equal the JAX package's byte for byte.  The JAX
    reader takes AVI frames from ``cv2.VideoCapture`` (FFmpeg's MJPEG
    decoder, a few byte values from libjpeg's, ``tests/
    test_torch_container.py``), so on that side each frame is
    ``cv2.imdecode`` of the same packet."""
    anno = os.path.join(REPO, "tests", "fixtures", "synmot_multi")
    with open(os.path.join(anno, "annotation", "anno.json")) as f:
        samples = json.load(f)["samples"]
    sid = "SYN-TE-01"
    src = os.path.join(anno, samples[sid]["metadata"]["data_path"])
    frames = [cv2.imread(os.path.join(src, n))
              for n in sorted(os.listdir(src))]
    png = tmp_path / "png"
    png.mkdir()
    for i, f in enumerate(frames):
        cv2.imwrite(str(png / f"{i + 1:06d}.png"), f)
    avi = str(tmp_path / "clip.avi")
    wr = cv2.VideoWriter(avi, cv2.VideoWriter_fourcc(*"MJPG"), 30.0,
                         (f.shape[1], f.shape[0]))
    for f in frames:
        wr.write(f)
    wr.release()
    video = container.open_video(avi)
    monkeypatch.setattr(
        JaxFrameReader, "__getitem__", lambda self, i: cv2.imdecode(
            np.frombuffer(video.packet(i), np.uint8),
            cv2.IMREAD_COLOR)[..., ::-1] if not self.is_dir
        else cv2.imread(self.files[i])[..., ::-1])
    for path in (str(png), avi):
        d = dict(samples[sid])
        d["metadata"] = dict(d["metadata"], data_path=path)
        port = VideoDataset([(sid, DataSample.from_dict(sid, d))])
        jax_ds = JaxVideoDataset([(sid, JaxSample.from_dict(sid, d))])
        assert len(port) == len(jax_ds) > 1
        for i in range(len(port)):
            (pf, pt, pid), (jf, jt, jid) = port[(i, i)], jax_ds[(i, i)]
            assert pid == jid == sid and len(pf) == len(jf) == 2
            for a, b, ta, tb in zip(pf, jf, pt, jt):
                np.testing.assert_array_equal(a, b)
                for field in ("boxes", "ids", "labels"):
                    np.testing.assert_array_equal(getattr(ta, field),
                                                  getattr(tb, field))


def test_committed_frames_decode_to_the_jax_bytes():
    want = dg.load()
    assert want["decoder"] == "libjpeg"
    cfg = get_cfg()
    cfg.merge_from_file(dg.RECIPE)
    got = dg.frame_digests(x for x, _ in normalized_frame_source(
        dg.SEQUENCE, EvalTransform(cfg)))
    assert got == want["frames"]["SYN-TE-01"] and len(got) == 16


def _mot_root(root, n_frames=6, w=128, h=96, with_seqinfo=True):
    """A MOT-layout root with one test sequence (and one train sequence
    without seqinfo.ini): textured frames, gt and public detections."""
    rng = np.random.RandomState(1)
    base = rng.randint(0, 255, (h // 8, w // 8, 3)).astype(np.float32)
    for split, name in (("test", "SYN-TE-01"), ("train", "SYN-TR-01")):
        seq = root / split / name
        (seq / "img1").mkdir(parents=True)
        (seq / "gt").mkdir()
        (seq / "det").mkdir()
        if split == "test" and with_seqinfo:
            cp = configparser.ConfigParser()
            cp["Sequence"] = dict(name=name, imDir="img1", frameRate=10,
                                  seqLength=n_frames, imWidth=w, imHeight=h,
                                  imExt=".jpg")
            with open(seq / "seqinfo.ini", "w") as f:
                cp.write(f)
        gt, det = [], []
        for t in range(n_frames):
            img = np.kron(np.roll(base, t, axis=1), np.ones((8, 8, 1)))
            img = np.clip(img + rng.randn(h, w, 3) * 8, 0, 255)
            cv2.imwrite(str(seq / "img1" / f"{t + 1:06d}.jpg"),
                        img.astype(np.uint8)[..., ::-1],
                        [cv2.IMWRITE_JPEG_QUALITY, 95])
            for k in range(3):
                x, y = 10 + 35 * k + 2 * t, 12 + 10 * k
                gt.append(f"{t + 1},{k + 1},{x},{y},24,40,1,1,0.9")
                det.append(f"{t + 1},-1,{x + 1.5:.2f},{y - 1.25:.2f},23.5,"
                           f"41.0,{0.9 - 0.1 * k:.3f}")
        (seq / "gt" / "gt.txt").write_text("\n".join(gt))
        (seq / "det" / "det.txt").write_text("\n".join(det))
    return str(root)


def test_ingest_writes_the_jax_jsons_byte_for_byte(tmp_path):
    a = _mot_root(tmp_path / "a")
    b = _mot_root(tmp_path / "b")
    jax_ingest(a)
    ingest_mot(b)
    names = sorted(os.listdir(os.path.join(a, "annotation")))
    assert names == ["anno.json", "anno_pub_detection.json", "splits.json"]
    assert sorted(os.listdir(os.path.join(b, "annotation"))) == names
    for n in names:
        with open(os.path.join(a, "annotation", n), "rb") as f:
            want = f.read()
        with open(os.path.join(b, "annotation", n), "rb") as f:
            assert f.read() == want, n
    # the sequence without seqinfo.ini: its size read by the port's reader
    tr = MotionDataset("anno.json", root_path=b).samples["SYN-TR-01"]
    assert (tr.width, tr.height) == (128, 96) and len(tr) == 6


def _digest(sample_dicts) -> str:
    return hashlib.sha256(repr(sample_dicts).encode()).hexdigest()


@pytest.mark.parametrize("mode", ["given", "rpn"])
def test_test_net_matches_the_jax_golden(tmp_path, monkeypatch, mode):
    run = f"{mode}_f32"
    want = dg.load()["runs"][run]
    inf = test_net.main(dg.cli_args(run, str(tmp_path), device="cpu"))
    assert set(inf.speed) == {"SYN-TE-01"} and inf.speed["SYN-TE-01"][0] == 16
    got = DataSample.load(str(tmp_path / "SYN-TE-01.json")).to_dict()
    dg.compare_samples(got, want["predictions"]["SYN-TE-01"], run)
    dg.compare_samples(inf.results["SYN-TE-01"].to_dict(),
                       want["tracks"]["SYN-TE-01"], f"{run} tracks")
    dg.compare_summaries(dg.summaries(inf.accs), want["summary"], run)

    # a second call reads the cache: no frame runs
    def no_frames(*a, **k):
        raise AssertionError("the cache was not read")

    monkeypatch.setattr(inferencer, "track_frames", no_frames)
    again = test_net.main(dg.cli_args(run, str(tmp_path), device="cpu"))
    assert again.speed == {}
    assert _digest({k: v.to_dict() for k, v in again.results.items()}) == \
        _digest({k: v.to_dict() for k, v in inf.results.items()})


LIVE_OPTS = MINI + ["MODEL.RPN.PRE_NMS_TOP_N_TEST", 50,
                    "MODEL.RPN.POST_NMS_TOP_N_TEST", 20,
                    "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", 20,
                    "TPU.MAX_TRACKS", 8, "INPUT.MIN_SIZE_TEST", 96,
                    "INPUT.MAX_SIZE_TEST", 128]


@pytest.mark.parametrize("given", [False, True])
def test_live_dataset_inference_matches_jax(tmp_path, given):
    """DLA-MINI, drawn weights, f32: the JAX and the port's
    DatasetInference over the same rendered sequence."""
    root = _mot_root(tmp_path / "data")
    jax_ingest(root)
    opts = LIVE_OPTS + ["INFERENCE.USE_GIVEN_DETECTIONS", given]
    jcfg, cfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_list(opts)
    cfg.merge_from_list(opts)
    jmodel = JaxSiamMOT(jcfg)
    flat = random_flax_params(jmodel, (96, 128), seed=0)
    flat["params/box/predictor/cls_score/bias"] = np.array([-3.0, 3.0],
                                                           np.float32)
    jds, ds = JaxDataset(root_path=root), MotionDataset(root_path=root)
    jpub = dict(JaxDataset("anno_pub_detection.json", root_path=root)) \
        if given else None
    pub = dict(MotionDataset("anno_pub_detection.json", root_path=root)) \
        if given else None
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jinf = JaxInference(jcfg, jmodel,
                        jax.tree.map(jnp.asarray, unflatten_params(flat)),
                        jds.get_split("test"), str(tmp_path / "jax"),
                        jax_filter("MOT17"), jpub,
                        dataset_root=jds.data_root_path)
    jaccs, _ = jinf()
    inf = DatasetInference(cfg, SiamMOT(cfg, device="cpu"),
                           jax_to_torch(flat), ds.get_split("test"),
                           str(tmp_path / "port"), build_data_filter_fn(
                               "MOT17"), pub,
                           dataset_root=ds.data_root_path)
    accs, _ = inf()
    with open(tmp_path / "jax" / "SYN-TE-01.json") as f:
        jpred = json.load(f)
    with open(tmp_path / "port" / "SYN-TE-01.json") as f:
        pred = json.load(f)
    assert pred["id"] == jpred["id"] == "SYN-TE-01"
    assert len(pred["entities"]) > 6
    dg.compare_samples(pred, jpred, "live")
    dg.compare_samples(inf.results["SYN-TE-01"].to_dict(),
                       jinf.results["SYN-TE-01"].to_dict(), "live tracks")
    dg.compare_summaries(dg.summaries(accs), dg.summaries(jaccs), "live")
