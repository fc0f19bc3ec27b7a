"""The port's demo (``siammot_tpu_torch/demos``) against the JAX demo
(``demos/``), on the CPU.

* Drawing: ``VisGenerator.frame_vis_generator`` over a seeded sweep of
  frames and rows (boxes partly or wholly outside the frame, degenerate
  boxes, ids up to 5 digits and negative ones, labels past the class
  names, with and without ``vis_height``) gives the JAX generator's BGR
  frame with its channels reversed, bit for bit.  The 50 colours are
  ``get_n_colors``'s.
* Writing: the mp4 reads back through cv2 and the port with its frame
  count, size and fps; the JPEG frames are the bytes ``cv2.imwrite``
  writes.
* The CLI: ``main`` over a PNG folder and over an MJPEG AVI at
  ``tests/test_demo_e2e.py``'s tiny configuration in float32, on the JAX
  demo's drawn weights carried across as a flax-tree ``.npz``
  (``utils/weights.py``): every frame's rows (xywh, ids, labels, scores)
  equal ``DemoInference``'s, ids and labels exactly, boxes and scores
  within ``utils/golden.py``'s tolerances.  The JAX demo reads the AVI
  through FFmpeg's decoder, so it is handed ``cv2.imdecode`` of the same
  packets, the port's bytes.  The frames written are the overlays drawn
  on the port's rows.  Without ``--device cpu`` and without a card the
  CLI raises.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from demos.demo_inference import DemoInference as JaxDemoInference
from demos.utils.vis_generator import VisGenerator as JaxVisGenerator
from demos.utils.vis_generator import get_n_colors as jax_get_n_colors
from demos.video_iterator import ImageFolderIterator as JaxFolderIterator
from siammot_tpu_torch.data import container, native
from siammot_tpu_torch.demos import demo
from siammot_tpu_torch.demos.utils.colors import get_n_colors
from siammot_tpu_torch.demos.utils.vis_generator import VisGenerator
from siammot_tpu_torch.demos.utils.vis_writer import VisWriter
from siammot_tpu_torch.utils import golden
from torch_port_util import flatten_params

# tests/test_demo_e2e.py's tiny configuration, in float32
TINY = """\
INPUT:
  MIN_SIZE_TEST: 64
  MAX_SIZE_TEST: 96
MODEL:
  RPN:
    PRE_NMS_TOP_N_TEST: 64
    POST_NMS_TOP_N_TEST: 16
    FPN_POST_NMS_TOP_N_TEST: 16
  TRACK_HEAD:
    START_TRACK_THRESH: 0.01
    TRACK_THRESH: 0.005
TPU:
  MAX_TRACKS: 4
  COMPUTE_DTYPE: "float32"
  POOLER_DTYPE: "float32"
"""


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_colors_are_get_n_colors():
    np.testing.assert_array_equal(get_n_colors(50),
                                  jax_get_n_colors(50)[:, ::-1])
    np.testing.assert_array_equal(get_n_colors(7, seed=3),
                                  jax_get_n_colors(7, seed=3)[:, ::-1])


def random_rows(rng, h, w):
    n = int(rng.randint(0, 9))
    xy = rng.uniform(-80, max(h, w) + 40, (n, 2))
    wh = rng.uniform(-4, 160, (n, 2))
    wh[rng.rand(n) < 0.2] = 0                     # degenerate boxes
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    digits = rng.randint(1, 6, n)
    ids = np.array([rng.randint(0, 10 ** d) for d in digits])
    ids[rng.rand(n) < 0.2] = -1
    labels = rng.randint(0, 12, n)
    return boxes, ids, labels


@pytest.mark.parametrize("vis_height", [None, 150, 61])
def test_drawn_frames_equal_the_jax_generator(vis_height):
    rng = np.random.RandomState(0 if vis_height is None else vis_height)
    port, jax = VisGenerator(vis_height), JaxVisGenerator(vis_height)
    drawn = 0
    for _ in range(60):
        h, w = int(rng.randint(40, 220)), int(rng.randint(40, 320))
        frame = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        boxes, ids, labels = random_rows(rng, h, w)
        want = jax.frame_vis_generator(frame[:, :, ::-1], boxes, ids,
                                       labels)[:, :, ::-1]
        got = port.frame_vis_generator(frame, boxes, ids, labels)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        drawn += int((ids >= 0).sum())
    assert drawn > 100


def test_writer_video_and_frames(tmp_path):
    rng = np.random.RandomState(2)
    frames = [native.resize_u8(rng.randint(0, 256, (7, 9, 3))
                               .astype(np.uint8), 72, 40) for _ in range(5)]
    wr = VisWriter(dump_video=True, out_path=str(tmp_path),
                   file_name="clip.avi", fps=12.0)
    for i, f in enumerate(frames):
        wr.dump_artifacts(f, i)
    wr.close()
    path = str(tmp_path / "clip.mp4")
    cap = cv2.VideoCapture(path)
    assert (cap.get(cv2.CAP_PROP_FPS), cap.get(cv2.CAP_PROP_FRAME_COUNT),
            cap.get(cv2.CAP_PROP_FRAME_WIDTH),
            cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) == (12.0, 5, 72, 40)
    n = 0
    while cap.read()[0]:
        n += 1
    assert n == 5
    video = container.open_video(path)
    assert (video.fps, video.frame_count, video.width, video.height) == \
        (12.0, 5, 72, 40)
    for got, f in zip(video.frames(), frames):
        want = cv2.imdecode(cv2.imencode(".jpg", f[..., ::-1])[1],
                            cv2.IMREAD_COLOR)[..., ::-1]
        np.testing.assert_array_equal(got, want)
    wr = VisWriter(dump_video=False, out_path=str(tmp_path),
                   file_name="seq", fps=12.0)
    for i, f in enumerate(frames[:2]):
        wr.dump_artifacts(f, i)
        cv2.imwrite(str(tmp_path / f"want{i}.jpg"), f[..., ::-1])
        assert (tmp_path / "seq_frames" / f"{i:06d}.jpg").read_bytes() == \
            (tmp_path / f"want{i}.jpg").read_bytes()
    wr.close()


def scene(n, h, w, seed=0):
    """``tests/test_demo_e2e.py``'s frames: a dim texture and a moving red
    block."""
    rng = np.random.RandomState(seed)
    base = (rng.rand(h, w, 3) * 120).astype(np.uint8)
    out = []
    for t in range(n):
        f = base.copy()
        x = 10 + 3 * t
        f[20:44, x:x + 18] = (220, 40, 40)
        out.append(f)
    return out


@pytest.fixture(scope="module")
def jax_demo(tmp_path_factory):
    """The JAX demo on the tiny config with its drawn weights, and those
    weights as a flax-tree ``.npz`` for the port."""
    root = tmp_path_factory.mktemp("demo")
    cfg = root / "tiny.yaml"
    cfg.write_text(TINY)
    tracker = JaxDemoInference(track_class="person", config_file=str(cfg))
    weights = root / "weights.npz"
    np.savez(weights, **{k: np.asarray(v) for k, v in
                         flatten_params(tracker.params).items()})
    return tracker, str(cfg), str(weights)


def assert_rows_match(got, want):
    assert len(got) == len(want)
    live = 0
    for (fa, (xa, ia, la, sa)), (fb, (xb, ib, lb, sb)) in zip(got, want):
        assert fa == fb
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(la, lb)
        np.testing.assert_allclose(xa, xb, rtol=0, atol=golden.BOX_ATOL)
        np.testing.assert_allclose(sa, sb, rtol=0, atol=golden.SCORE_ATOL)
        live += int((ia >= 0).sum())
    assert live > 0, "no track on any frame"


def check_output(run, frames, video=True):
    """The written frames are the overlays drawn on the port's rows."""
    vis = VisGenerator()
    outs = list(container.open_video(run.output).frames()) if video else [
        native.decode_jpeg_bytes(open(os.path.join(run.output, n),
                                      "rb").read())
        for n in sorted(os.listdir(run.output))]
    assert len(outs) == len(frames)
    drawn = False
    for out, f, (_, (xywh, ids, labels, _)) in zip(outs, frames, run.rows):
        xyxy = xywh.copy()
        xyxy[:, 2:] += xyxy[:, :2] - 1
        want = vis.frame_vis_generator(f, xyxy, ids, labels)
        np.testing.assert_array_equal(out, native.decode_jpeg_bytes(
            native.encode_jpeg(want, 95)))
        drawn |= bool((ids >= 0).any()) and not np.array_equal(want, f)
    assert drawn


def test_demo_main_on_a_png_folder_matches_jax(tmp_path, jax_demo):
    tracker, cfg, weights = jax_demo
    frames = scene(6, 64, 96)
    clip = tmp_path / "clip"
    clip.mkdir()
    for i, f in enumerate(frames):
        cv2.imwrite(str(clip / f"{i:04d}.png"), f[:, :, ::-1])
    want = list(tracker.process_frame_sequence(iter(JaxFolderIterator(
        str(clip)))))
    run = demo.main(["--demo-video", str(clip), "--config-file", cfg,
                     "--model-file", weights, "--device", "cpu",
                     "--output-path", str(tmp_path / "out")])
    assert_rows_match(run.rows, want)
    assert run.output == str(tmp_path / "out" / "clip.mp4")
    check_output(run, frames)
    run = demo.main(["--demo-video", str(clip), "--config-file", cfg,
                     "--model-file", weights, "--device", "cpu",
                     "--dump-video", "False",
                     "--output-path", str(tmp_path / "frames")])
    assert_rows_match(run.rows, want)
    check_output(run, frames, video=False)


def test_demo_main_on_an_mjpeg_avi_matches_jax(tmp_path, jax_demo):
    tracker, cfg, weights = jax_demo
    path = str(tmp_path / "clip.avi")
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                         (96, 64))
    for f in scene(5, 64, 96, seed=3):
        wr.write(f[:, :, ::-1])
    wr.release()
    decoded = [cv2.imdecode(np.frombuffer(p, np.uint8), cv2.IMREAD_COLOR)
               [:, :, ::-1] for p in container.open_video(path).packets()]
    want = list(tracker.process_frame_sequence(enumerate(decoded)))
    run = demo.main(["--demo-video", path, "--config-file", cfg,
                     "--model-file", weights, "--device", "cpu",
                     "--output-path", str(tmp_path / "out")])
    assert_rows_match(run.rows, want)
    check_output(run, decoded)
    assert container.open_video(run.output).fps == 10.0


def test_demo_without_a_card_raises(tmp_path, jax_demo):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    _, cfg, weights = jax_demo
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(["--demo-video", str(tmp_path), "--config-file", cfg,
                   "--model-file", weights])
