"""Matroska and WebM in the port's readers (``siammot_tpu_torch/data/
matroska.py``), on the CPU, against cv2 and the JAX package, over
``tests/fixtures/video`` (written by ``python
tools/make_torch_container_fixtures.py``) and files its EBML writer makes
here:

* EBML: variable-length IDs and sizes of every length, unknown sizes (a
  Segment and Clusters as live recorders write them), Xiph, EBML and
  fixed lacing, header stripping, and the display order rebuilt from the
  block timestamps of an H.264 stream with B-frames;
* Motion JPEG in Matroska: each packet decodes bitwise as
  ``cv2.imdecode`` decodes it; count, order and every seek against
  ``cv2.VideoCapture`` (FFmpeg's MJPEG decoder differs from libjpeg by a
  bounded byte gap, as in ``test_torch_container.py``); metadata against
  the JAX package's ``video_metadata``, a WebM without ``Duration``
  included (OpenCV's frame-count estimate, reproduced);
* ``ProjectionPoseRoll`` as the rotation OpenCV reports;
* what raises: zlib compression and encryption, a DocType that is not
  Matroska;
* a ``.mkv`` read in a process with ``cv2``, JAX and the JAX package
  blocked.
"""

import hashlib
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from demos.video_iterator import Cv2VideoIterator
from demos.video_iterator import check_rotation as jax_check_rotation
from siammot_tpu.data.datasets import FrameReader as JaxFrameReader
from siammot_tpu.data.video_loader import \
    video_metadata as jax_video_metadata
from siammot_tpu_torch.data import container, matroska
from siammot_tpu_torch.data.datasets import FrameReader
from siammot_tpu_torch.data.video_loader import video_frames, video_metadata
from siammot_tpu_torch.demos.video_iterator import build_video_iterator
from test_torch_container import FFMPEG_GAP
from test_torch_isolation import BLOCK, REPO
from tools import make_torch_container_fixtures as fx

VIDEO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                     "video")
MJPEG = ["mjpeg_small.mkv", "mjpeg_laced.mkv"]
# the mean byte gap between cv2.VideoCapture's frames (FFmpeg's MJPEG
# decoder and swscale) and libjpeg's on the 200x120 sprite scene of the
# Motion JPEG fixtures: a CPU run measured 5.8707 (largest 52, within
# test_torch_container's FFMPEG_GAP)
SPRITE_MEAN_GAP = 6.0
MATROSKA = MJPEG + ["mpeg4_small.mkv", "vp9_small.webm", "vp8_small.webm",
                    "vp9_live.webm", "h264_opengop.mkv", "hevc_small.mkv",
                    "av1_small.mkv"]


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two CPU threads: the suite runs several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    cv2.setNumThreads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    with open(os.path.join(VIDEO, "containers_ref.json")) as f:
        return json.load(f)


def fixture(name):
    return os.path.join(VIDEO, name)


def sha(a):
    return hashlib.sha256(np.ascontiguousarray(a)).hexdigest()


def cv2_rgb(path):
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        out.append(np.ascontiguousarray(bgr[..., ::-1]))
    cap.release()
    return out


def imdecode(packet):
    return cv2.imdecode(np.frombuffer(packet, np.uint8),
                        cv2.IMREAD_COLOR)[..., ::-1]


def mjpeg_packets(n=4):
    """Four JPEG packets of a small moving scene, each its own size."""
    out = []
    for t in range(n):
        img = np.zeros((fx.H, fx.W, 3), np.uint8)
        img[:, :, 0] = np.arange(fx.W, dtype=np.uint8)[None] * (t + 1)
        img[20 + 5 * t:60 + 5 * t, 30:90] = (250, 40, 10 * t)
        ok, jpeg = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 80])
        out.append(dict(data=jpeg.tobytes(), pts=t, key=True))
    return out


# -- EBML ---------------------------------------------------------------------

@pytest.mark.parametrize("value", [0, 1, 126, 127, 128, 16382, 16383,
                                   2 ** 21, 2 ** 28 + 5, 2 ** 35 - 2,
                                   2 ** 42, 2 ** 49 - 2, 2 ** 56 - 2])
def test_variable_length_sizes(value):
    """Sizes of every length from 1 to 8 bytes, each all-ones pattern
    reserved for the unknown size."""
    data = fx.ebml_size(value)
    got, length, unknown = matroska._vint(data, 0, False)
    assert (got, length, unknown) == (value, len(data), False)
    ones = bytes([0xFF >> (length - 1) | 0x80 >> (length - 1)]) \
        + b"\xff" * (length - 1)
    assert matroska._vint(ones, 0, False)[2]
    assert matroska._vint(fx.UNKNOWN, 0, False)[1:] == (8, True)


def test_element_ids_keep_their_marker():
    for eid in (0xA3, 0x4489, 0x2AD7B1, 0x1A45DFA3):
        data = fx.el(eid, b"\x01\x02")
        assert matroska._element(data, 0) == (eid, len(data) - 2, 2)


@pytest.mark.parametrize("laced", [0, 2, 3])
@pytest.mark.parametrize("unknown", [False, True])
def test_lacing_unknown_sizes_and_header_stripping(tmp_path, laced, unknown):
    """JPEG packets laced (Xiph, EBML, fixed in turn), under header
    stripping, in unknown-size Clusters: the port gives each packet back
    whole, bitwise cv2.imdecode, and cv2 reads the same file."""
    packets = mjpeg_packets(7)
    strip = fx.common_prefix(packets)
    assert len(strip) >= 20
    path = str(tmp_path / "laced.mkv")
    fx.write_mkv(path, "V_MJPEG", b"", packets, laced=laced, strip=strip,
                 unknown=unknown, cues=not unknown, per_cluster=4)
    video = container.open_video(path)
    assert video.prefix == strip and video.frame_count == 7
    got = list(video.packets())
    if laced:
        # the fixed lace pads its frames to one size after their EOI
        for g, p in zip(got, packets):
            assert g.startswith(p["data"]) and not g[len(p["data"]):].strip(
                b"\0")
    else:
        assert got == [p["data"] for p in packets]
    frames = list(video.frames())
    for f, p in zip(frames, packets):
        np.testing.assert_array_equal(f, imdecode(p["data"]))
    assert len(cv2_rgb(path)) == 7
    assert video_metadata(path) == jax_video_metadata(path)


def test_first_video_track_among_others(tmp_path):
    """An audio track listed first, its blocks between the video's: the
    port takes the first track of TrackType 1 and its blocks alone, as
    cv2 does."""
    packets = mjpeg_packets(5)
    path = str(tmp_path / "av.mkv")
    fx.write_mkv(path, "V_MJPEG", b"", packets, audio=True)
    video = container.open_video(path)
    assert list(video.packets()) == [p["data"] for p in packets]
    assert len(cv2_rgb(path)) == 5
    assert video_metadata(path) == jax_video_metadata(path)


def bitmapinfoheader(fourcc: bytes, extra: bytes = b"") -> bytes:
    return np.array([40 + len(extra), fx.W, fx.H], "<i4").tobytes() \
        + np.array([1, 24], "<u2").tobytes() + fourcc \
        + np.array([fx.W * fx.H * 3, 0, 0, 0, 0], "<i4").tobytes() + extra


@pytest.mark.parametrize("fourcc", [b"MJPG", b"XVID"])
def test_vfw_fourcc_tracks(tmp_path, fourcc):
    """``V_MS/VFW/FOURCC``: the BITMAPINFOHEADER's ``biCompression``
    against the AVI fourcc tables; an MPEG-4 Part 2 track's VOL header
    follows the 40 bytes.  The MJPEG track decodes; the MPEG-4 stream the
    port makes decodes through cv2 to cv2's frames of the file."""
    path = str(tmp_path / "vfw.mkv")
    if fourcc == b"MJPG":
        packets = mjpeg_packets(3)
        fx.write_mkv(path, "V_MS/VFW/FOURCC", bitmapinfoheader(fourcc),
                     packets)
        video = container.open_video(path)
        assert (video.format, video.codec) == ("MJPEG", "MJPG")
        for f, p in zip(video.frames(), packets):
            np.testing.assert_array_equal(f, imdecode(p["data"]))
        return
    src = container.open_video(fixture("mpeg4_small.mkv"))
    fx.write_mkv(path, "V_MS/VFW/FOURCC",
                 bitmapinfoheader(fourcc, src.header),
                 fx.demuxed(fixture("mpeg4_small.mkv")))
    video = container.open_video(path)
    assert (video.format, video.codec, video.header) == (
        "MPEG-4 Part 2", "XVID", src.header)
    stream = tmp_path / "s.m4v"
    stream.write_bytes(video.elementary_stream())
    want = cv2_rgb(path)
    assert len(want) == 12
    assert [sha(f) for f in cv2_rgb(stream)] == [sha(f) for f in want]


def test_lace_sizes_of_each_kind():
    frames = [b"a" * 300, b"b" * 10, b"c" * 1000, b"d" * 7]
    for kind in (1, 3):
        flags, head = fx.lace(frames, kind)
        data = head + b"".join(frames)
        sizes, pos = matroska._lace_sizes(data, 0, len(data), flags >> 1)
        assert sizes == [len(f) for f in frames] and pos == len(head)
    data = bytes([3]) + b"x" * 40
    assert matroska._lace_sizes(data, 0, len(data), 2) == ([10] * 4, 1)


def test_unknown_size_cluster_ends_at_the_next_top_level_element():
    block = fx.el(0xA3, b"\x81\0\0\x80" + b"j")
    data = fx.el(0x1F43B675, fx.uint_el(0xE7, 0), block, unknown=True) \
        + fx.el(0x1C53BB6B, b"") + fx.el(0x1F43B675, fx.uint_el(0xE7, 40),
                                         block, unknown=True)
    kids = list(matroska._children(data, 0, len(data)))
    assert [k for k, _, _ in kids] == [0x1F43B675, 0x1C53BB6B, 0x1F43B675]
    first = kids[0]
    assert first[2] == data.index(fx.ebml_id(0x1C53BB6B))


def test_display_order_from_block_timestamps(ref):
    """x264's open-GOP stream, blocks in decode order stamped with
    presentation times: the display order sorts them by timestamp; ties
    (none here) would keep file order."""
    video = container.open_video(fixture("h264_opengop.mkv"))
    assert video.order[:4] == [0, 2, 3, 1]
    assert sorted(video.order) == list(range(24))
    assert video.rank()[7] == 8 and video.rank()[8] == 7   # a leading B
    assert video.sync == [0, 7, 16]
    assert ref["h264_opengop.mkv"]["frames"] == video.frame_count


def test_ties_keep_file_order(tmp_path):
    packets = mjpeg_packets(4)
    for p in packets:
        p["pts"] = 0
    path = str(tmp_path / "ties.mkv")
    fx.write_mkv(path, "V_MJPEG", b"", packets)
    data = open(path, "rb").read()
    video = matroska.open_matroska(path, data)
    assert list(video.packets()) == [p["data"] for p in packets]


@pytest.mark.parametrize("default_duration", [40000000, 41708333,
                                              33366667, 16683333, 33333333,
                                              1000000000, 1234567,
                                              500000, False])
def test_default_duration_gives_opencvs_fps(tmp_path, default_duration):
    """``CAP_PROP_FPS`` from ``DefaultDuration`` through FFmpeg's
    ``av_reduce(1e9, DefaultDuration, 30000)``, 1 to 2000 fps; without it
    (False) from the timestamps."""
    path = str(tmp_path / "rate.mkv")
    fx.write_mkv(path, "V_MJPEG", b"", mjpeg_packets(3),
                 default_duration=default_duration)
    cap = cv2.VideoCapture(path)
    assert container.open_video(path).fps == cap.get(cv2.CAP_PROP_FPS)
    cap.release()


# -- Motion JPEG ------------------------------------------------------------

@pytest.mark.parametrize("name", MJPEG)
def test_mjpeg_packets_decode_bitwise_as_cv2_imdecode(name, ref):
    video = container.open_video(fixture(name))
    assert (video.format, video.codec) == ("MJPEG", "V_MJPEG")
    packets = list(video.packets())
    assert len(packets) == ref[name]["frames"] == 6
    for i, p in enumerate(packets):
        np.testing.assert_array_equal(video.frame(i), imdecode(p))
    # the laced file holds the same JPEGs as the one FFmpeg muxed
    plain = list(container.open_video(fixture("mjpeg_small.mkv")).packets())
    for p, q in zip(packets, plain):
        assert p.rstrip(b"\0") == q.rstrip(b"\0")


@pytest.mark.parametrize("name", MJPEG)
def test_mjpeg_count_order_and_seeks_against_cv2(name, ref):
    """Frames in order and by index: each the port's decode of its packet,
    within FFmpeg's MJPEG decoder's byte gap of cv2's frame at that index
    and of the JAX ``FrameReader``'s (``CAP_PROP_POS_FRAMES``), which the
    fixture measured to be the sequential frame at every index."""
    path = fixture(name)
    seq = list(video_frames(path))
    want = cv2_rgb(path)
    assert len(seq) == len(want) == ref[name]["frames"]
    assert ref[name]["seek"] == list(range(len(want)))
    reader, jax_reader = FrameReader(path), JaxFrameReader(path)
    gaps = []
    for i in np.random.RandomState(0).permutation(len(want)):
        got = reader[int(i)]
        np.testing.assert_array_equal(got, seq[i])
        assert sha(want[i]) == ref[name]["sha256"][i]
        np.testing.assert_array_equal(jax_reader[int(i)], want[i])
        gaps.append(np.abs(got.astype(int) - want[i].astype(int)))
    assert max(int(g.max()) for g in gaps) <= FFMPEG_GAP
    assert float(np.mean(gaps)) <= SPRITE_MEAN_GAP


@pytest.mark.parametrize("name", MATROSKA)
def test_metadata_matches_jax_video_metadata(name, ref):
    """fps, ``CAP_PROP_FRAME_COUNT`` (Matroska's estimate from
    ``Duration``; without it OpenCV's INT64_MIN-based figure) and size, as
    the JAX package reads them; the demo iterator's as the JAX demo's."""
    path = fixture(name)
    meta = video_metadata(path)
    assert meta == jax_video_metadata(path)
    assert meta["number_of_frames"] == int(ref[name]["count"])
    assert meta["fps"] == ref[name]["fps"] == 25.0
    it, jit = build_video_iterator(path), Cv2VideoIterator(path)
    assert (it.fps, it.frame_count, it.rotation) == (
        jit.fps, jit.frame_count, jit.rotation)


def test_live_webm_without_duration(ref):
    """The unknown-size WebM of a live recorder: no Cues, no Duration, no
    DefaultDuration.  The fps comes from the timestamps; the frame count
    is OpenCV's estimate from an unset duration, INT64_MIN in the stream's
    millisecond time base, times 25 fps: the JAX package reports it, and
    so does the port.  Its frames are the sized WebM's."""
    live = container.open_video(fixture("vp9_live.webm"))
    sized = container.open_video(fixture("vp9_small.webm"))
    assert live.frame_total == int(np.floor(-2 ** 63 / 1000 * 25 + 0.5)) \
        == int(ref["vp9_live.webm"]["count"]) == -230584300921369408
    assert live.frame_count == sized.frame_count == 12
    assert list(live.packets()) == list(sized.packets())
    assert live.sync == sized.sync and live.fps == 25.0
    assert ref["vp9_live.webm"]["sha256"] == ref["vp9_small.webm"]["sha256"]


def test_live_webm_seeks_where_cv2_cannot(ref):
    """OpenCV clamps a seek to its frame-count estimate, negative here,
    so every ``CAP_PROP_POS_FRAMES`` seek of the live WebM (the JAX
    ``FrameReader``) gives frame 0; the port's seek plan gives frame i
    (a quirk of the reference not reproduced; ROADMAP.md section 3)."""
    assert ref["vp9_live.webm"]["seek"] == [0] * 12
    video = container.open_video(fixture("vp9_live.webm"))
    assert [video.plan(i) for i in range(12)] == [(0, i) for i in range(12)]


# -- the rotation -----------------------------------------------------------

@pytest.mark.parametrize("roll", [-90.0, 90.0, 180.0, -180.0, 270.0, 0.0])
def test_projection_roll_is_the_rotation_opencv_reports(tmp_path, roll):
    path = str(tmp_path / f"roll{roll}.mkv")
    packets = mjpeg_packets(2)
    fx.write_mkv(path, "V_MJPEG", b"", packets, roll=roll)
    video = container.open_video(path)
    assert video.rotation == jax_check_rotation(path)
    meta = video_metadata(path)
    assert meta == jax_video_metadata(path)
    up = list(video_frames(path))
    want = cv2_rgb(path)          # OpenCV turns the frames upright itself
    assert [f.shape for f in up] == [f.shape for f in want]
    if video.rotation % 180:
        assert meta["resolution"] == {"width": fx.H, "height": fx.W}
    gap = max(int(np.abs(a.astype(int) - b.astype(int)).max())
              for a, b in zip(up, want))
    assert gap <= FFMPEG_GAP


def test_display_matrix_of_a_roll():
    assert matroska.projection_rotation(0.0, 0.0, -90.0) == 90
    assert matroska.projection_rotation(0.0, 0.0, 90.0) == 270
    assert matroska.projection_rotation(0.0, 10.0, 90.0) == 0    # pitch
    assert matroska.projection_rotation(45.0, 0.0, 90.0) == 0    # yaw


# -- what raises --------------------------------------------------------------

def test_zlib_and_encryption_raise_naming_them(tmp_path):
    path = str(tmp_path / "zlib.mkv")
    fx.write_mkv(path, "V_MJPEG", b"", mjpeg_packets(2), zlib=True)
    with pytest.raises(NotImplementedError, match="zlib"):
        container.open_video(path)
    data = bytearray(open(path, "rb").read())
    at = data.index(bytes.fromhex("4254"))          # ContentCompAlgo 0
    data[at + 3] = 1
    (tmp_path / "bzlib.mkv").write_bytes(bytes(data))
    with pytest.raises(NotImplementedError, match="bzlib"):
        container.open_video(str(tmp_path / "bzlib.mkv"))
    at = data.index(bytes.fromhex("5033"))          # ContentEncodingType
    data[at + 3] = 1
    (tmp_path / "enc.mkv").write_bytes(bytes(data))
    with pytest.raises(NotImplementedError, match="encrypted"):
        container.open_video(str(tmp_path / "enc.mkv"))


def test_other_doc_types_and_codecs_raise(tmp_path):
    path = str(tmp_path / "x.mkv")
    fx.write_mkv(path, "V_MJPEG", b"", mjpeg_packets(1), doc_type="mka")
    with pytest.raises(NotImplementedError, match="DocType 'mka'"):
        container.open_video(path)
    fx.write_mkv(path, "V_THEORA", b"", mjpeg_packets(1))
    with pytest.raises(NotImplementedError, match="Theora"):
        container.open_video(path)


def test_dispatch_is_by_the_first_bytes(tmp_path):
    """A Matroska file named .mp4 reads as Matroska."""
    path = tmp_path / "named.mp4"
    path.write_bytes(open(fixture("mjpeg_small.mkv"), "rb").read())
    assert container.open_video(str(path)).codec == "V_MJPEG"


def test_mkv_reads_with_cv2_and_jax_blocked():
    """The Matroska demuxer and the MJPEG route in a process that cannot
    import cv2, JAX, the JAX package, the tests or the tools."""
    script = (f"BLOCK_SOURCE = {BLOCK!r}\nexec(BLOCK_SOURCE)\n"
              f"import sys\nsys.path.insert(0, {REPO!r})\n"
              "from siammot_tpu_torch.data.video_loader import "
              "video_frames, video_metadata\n"
              "import hashlib\n"
              f"p = {fixture('mjpeg_laced.mkv')!r}\n"
              "f = list(video_frames(p))\n"
              "print('MKV', len(f), video_metadata(p)['number_of_frames'],"
              " hashlib.sha256(f[-1].tobytes()).hexdigest())\n"
              "assert not any(blocked(m) for m in sys.modules)\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd="/", env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    last = list(container.open_video(fixture("mjpeg_laced.mkv")).frames())[-1]
    assert res.stdout.split() == ["MKV", "6", "6", sha(last)]
