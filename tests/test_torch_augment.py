"""The port's training augmentation against the JAX package's, on the CPU.

Each transform of ``siammot_tpu_torch.data.augmentation`` runs beside its
``siammot_tpu.data.augmentation`` counterpart on the same frames and
``FrameTarget``s (made from numpy seeds) with a ``random.Random`` of the
same seed on each side.  After the call both generators must be in the
same state (the port consumed the JAX transform's draws, no more, no
fewer), and everything must be equal bit for bit: every frame byte, box,
id and label.  The JAX side's pixels come from ``cv2``; the port's from
``data/augment.cpp`` and the libjpeg round trip in ``data/frameio.cpp``,
so each of those is also held to the ``cv2`` call it replaces: the
resize, both HSV conversions (over every byte triple), the motion-blur
kernel (bitwise; the acceptance bound is 1e-6), ``filter2D``,
``GaussianBlur`` and the JPEG round trip at qualities 50-100.  All of
them are bitwise here.
"""

import random

import cv2
import numpy as np
import pytest
import torch

import siammot_tpu.data.augmentation as jaug
from siammot_tpu.configs.defaults import get_cfg as jax_get_cfg
from siammot_tpu.data.target import FrameTarget as JaxTarget
from siammot_tpu_torch.configs.defaults import get_cfg
from siammot_tpu_torch.data import augmentation as aug
from siammot_tpu_torch.data import native
from siammot_tpu_torch.data.target import FrameTarget

RECIPE = "configs/dla/DLA_34_FPN_EMM_SYNMOT_HARD.yaml"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread: the suite runs several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frame(seed, h=120, w=200):
    """A smooth random image with texture: a bicubic upsample of an 8x8
    grid plus noise, uint8 RGB."""
    rng = np.random.RandomState(seed)
    base = cv2.resize(rng.randint(0, 256, (8, 8, 3)).astype(np.uint8),
                      (w, h), interpolation=cv2.INTER_CUBIC)
    noise = rng.randint(-25, 26, base.shape)
    return np.clip(base.astype(np.int64) + noise, 0, 255).astype(np.uint8)


def targets(seed, w, h, n=6):
    """(port, JAX) FrameTargets of the same boxes, some past the border."""
    rng = np.random.RandomState(seed + 100)
    xywh = np.stack([rng.uniform(-20, w - 10, n), rng.uniform(-15, h - 10, n),
                     rng.uniform(8, w / 2, n), rng.uniform(8, h / 2, n)], -1)
    ids, labels = rng.randint(0, 50, n), np.ones(n, np.int64)
    return (FrameTarget.from_xywh(xywh, ids, labels, (w, h)),
            JaxTarget.from_xywh(xywh, ids, labels, (w, h)))


def assert_same_targets(got, want):
    assert len(got) == len(want)
    for g, t in zip(got, want):
        assert g.size == t.size
        np.testing.assert_array_equal(g.boxes, t.boxes)
        np.testing.assert_array_equal(g.ids, t.ids)
        np.testing.assert_array_equal(g.labels, t.labels)


def run_both(port_t, jax_t, seed, frames, n_targets=2):
    """Both transforms on copies of the same inputs and same-seeded
    generators; asserts equal draws, frames and targets."""
    h, w = frames[0].shape[:2]
    pt, jt = zip(*[targets(seed + i, w, h) for i in range(n_targets)])
    rp, rj = random.Random(seed), random.Random(seed)
    pf, pt = port_t([f.copy() for f in frames], list(pt), rp)
    jf, jt = jax_t([f.copy() for f in frames], list(jt), rj)
    assert rp.getstate() == rj.getstate(), "the draws differ"
    assert len(pf) == len(jf)
    for a, b in zip(pf, jf):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert_same_targets(pt, jt)
    return pf


# -- the cv2 calls ------------------------------------------------------------

RESIZES = [(200, 120, 400, 240), (640, 384, 1280, 768), (640, 384, 1066, 640),
           (600, 352, 640, 384), (640, 384, 320, 192), (577, 347, 640, 384),
           (33, 17, 64, 40), (200, 120, 200, 120), (1280, 768, 640, 384),
           (97, 61, 13, 9)]


@pytest.mark.parametrize("sw,sh,dw,dh", RESIZES)
def test_resize_is_cv2_inter_linear(sw, sh, dw, dh):
    img = frame(sw * 7 + dh, sh, sw)
    np.testing.assert_array_equal(
        native.cv_resize(img, dw, dh),
        cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR))


def _all_triples():
    a = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([(a >> 16) & 255, (a >> 8) & 255, a & 255],
                    -1).astype(np.uint8).reshape(4096, 4096, 3)


def test_hsv_conversions_are_cv2_on_every_byte_triple():
    rgb = _all_triples()
    np.testing.assert_array_equal(native.rgb_to_hsv(rgb),
                                  cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))
    hsv = rgb.reshape(256, -1, 3)[:180]          # OpenCV hues: [0, 180)
    np.testing.assert_array_equal(native.hsv_to_rgb(hsv),
                                  cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))
    # rows whose width leaves a tail that OpenCV converts without SIMD
    for w in (31, 33, 200):
        rows = hsv.reshape(-1, 3)[:hsv.size // 3 // w * w].reshape(-1, w, 3)
        np.testing.assert_array_equal(native.hsv_to_rgb(rows),
                                      cv2.cvtColor(rows, cv2.COLOR_HSV2RGB))


@pytest.mark.parametrize("seed", range(4))
def test_motion_kernel_filter2d_and_gaussian_are_cv2(seed):
    r = random.Random(seed)
    img = frame(seed, 90 + 17 * seed, 150 - 11 * seed)
    for _ in range(25):
        angle = r.uniform(-30, 30)
        k = aug.MotionBlur()._motion_kernel(angle)
        want = jaug.MotionBlur()._motion_kernel(angle)
        assert np.abs(k - want).max() <= 1e-6
        np.testing.assert_array_equal(k, want)
    # filter2D on cv2's own kernel: the filter alone
    np.testing.assert_array_equal(native.filter2d(img, want),
                                  cv2.filter2D(img, -1, want))
    for sigma in (0.2, 0.5, r.uniform(0, 2), 1.0, 1.999):
        np.testing.assert_array_equal(
            native.gaussian_blur(img, aug.gaussian_taps(sigma)),
            cv2.GaussianBlur(img, (0, 0), sigma))


@pytest.mark.parametrize("quality", [50, 63, 75, 90, 100])
def test_libjpeg_roundtrip_is_cv2(quality):
    img = frame(quality, 101, 171)
    ok, buf = cv2.imencode(".jpg", img[..., ::-1],
                           [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    np.testing.assert_array_equal(native.libjpeg_roundtrip(img, quality),
                                  cv2.imdecode(buf, cv2.IMREAD_COLOR)[..., ::-1])


def test_committed_jpeg_fixture_is_the_ports_libjpeg_roundtrip():
    """``tests/fixtures/jpeg_roundtrip.npz`` (``tests/torch_jpeg_fixture.py``:
    the JAX transform's cv2 round trips, against which the card's nvJPEG
    route is measured) is what the port's CPU route gives."""
    import os
    z = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "fixtures", "jpeg_roundtrip.npz"))
    crops = z["crops"]
    assert crops.shape == (4, 64, 64, 3)
    for q in (50, 75, 100):
        want = (crops.astype(np.int16) + z[f"q{q}"]).astype(np.uint8)
        got = np.stack([native.jpeg_roundtrip(c, q, "cpu") for c in crops])
        np.testing.assert_array_equal(got, want)


# -- FrameTarget ----------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_frame_target_matches_jax(seed):
    t, j = targets(seed, 200, 120, n=9)
    for got, want in [
            (t, j), (t.resize((333, 211)), j.resize((333, 211))),
            (t.hflip(), j.hflip()),
            (t.crop_shift(7, 5, 180, 110, True), j.crop_shift(7, 5, 180, 110,
                                                               True)),
            (t.crop_shift(7, 5, 180, 110, False),
             j.crop_shift(7, 5, 180, 110, False)),
            (t.clip_to_image(False), j.clip_to_image(False)),
            (t.clip_to_image(True), j.clip_to_image(True)),
            (t.select(t.ids > 20), j.select(j.ids > 20)),
            (FrameTarget.empty((5, 4)), JaxTarget.empty((5, 4)))]:
        assert_same_targets([got], [want])


# -- the transforms ---------------------------------------------------------------

JITTERS = [(0.1, 0.1, 0.1, 0.1), (0.0, 0.0, 0.0, 0.5), (0.4, 0.0, 0.3, 0.0),
           (0.0, 0.5, 0.0, 0.0)]


@pytest.mark.parametrize("jitter", JITTERS)
@pytest.mark.parametrize("seed", range(3))
def test_color_jitter_matches_jax(jitter, seed):
    frames = [frame(seed), frame(seed + 50)]
    run_both(aug.ColorJitter(*jitter), jaug.ColorJitter(*jitter), seed,
             frames)


@pytest.mark.parametrize("seed", range(8))
def test_motion_blur_matches_jax(seed):
    frames = [frame(seed), frame(seed + 50)]
    run_both(aug.MotionBlur(1.0 if seed % 4 else 0.5),
             jaug.MotionBlur(1.0 if seed % 4 else 0.5), seed, frames)


@pytest.mark.parametrize("seed", range(4))
def test_jpeg_compression_matches_jax(seed):
    frames = [frame(seed), frame(seed + 50)]
    run_both(aug.JpegCompression(50), jaug.JpegCompression(50), seed, frames)


@pytest.mark.parametrize("amodal", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_motion_augment_matches_jax(amodal, seed):
    frames = [frame(seed), frame(seed + 50)]
    run_both(aug.MotionAugment(0.1, amodal), jaug.MotionAugment(0.1, amodal),
             seed, frames)


@pytest.mark.parametrize("min_sizes,max_size", [((640, 720, 800, 880, 960),
                                                 1280), ((384,), 640),
                                                ((96,), 160)])
def test_clip_resize_and_dims_match_jax(min_sizes, max_size):
    for seed in range(3):
        frames = [frame(seed, 384, 640), frame(seed + 50, 384, 640)]
        run_both(aug.ClipResize(min_sizes, max_size, 32),
                 jaug.ClipResize(min_sizes, max_size, 32), seed, frames)
    for seed, (w, h) in enumerate([(640, 384), (1920, 1080), (384, 640),
                                   (1001, 999), (50, 500)]):
        rp, rj = random.Random(seed), random.Random(seed)
        assert aug.train_resize_dims(w, h, min_sizes, max_size, 32, rp) == \
            jaug.train_resize_dims(w, h, min_sizes, max_size, 32, rj)
        assert rp.getstate() == rj.getstate()


@pytest.mark.parametrize("seed", range(4))
def test_flip_and_normalize_match_jax(seed):
    frames = [frame(seed), frame(seed + 50)]
    run_both(aug.ClipHFlip(0.5), jaug.ClipHFlip(0.5), seed, frames)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    for bgr in (False, True):
        run_both(aug.Normalize(mean, std, bgr), jaug.Normalize(mean, std, bgr),
                 seed, frames)


@pytest.mark.parametrize("modality", ["video", "image"])
@pytest.mark.parametrize("seed", range(4))
def test_recipe_augmentation_matches_jax(modality, seed):
    """The SYNMOT_HARD recipe's whole chain (blur and JPEG on for stills)
    and, at seed 3, the host-normalising variant."""
    opts = ["TPU.DEVICE_NORMALIZE", seed != 3]
    cfg, jcfg = get_cfg(), jax_get_cfg()
    for c in (cfg, jcfg):
        c.merge_from_file(RECIPE)
        c.merge_from_list(opts)
    img = frame(seed, 384, 640)
    frames = [img, img] if modality == "image" \
        else [img, frame(seed + 50, 384, 640)]
    out = run_both(aug.build_siam_augmentation(cfg, True, modality),
                   jaug.build_siam_augmentation(jcfg, True, modality), seed,
                   frames)
    assert out[0].shape[:2] == (384, 640)
