"""The port's video demuxer and muxer (``siammot_tpu_torch/data/
container.py``) and the video routes built on them, on the CPU, against
cv2 (OpenCV's FFmpeg backend) and the JAX package.

* MJPEG in AVI and in MP4, written by ``cv2.VideoWriter``: every frame is
  bitwise ``cv2.imdecode`` of the same packet (the port decodes each
  packet with libjpeg, as ``cv2.imdecode`` does); fps, frame count and
  size equal cv2's ``CAP_PROP_*``.  ``cv2.VideoCapture``'s own frames go
  through FFmpeg's MJPEG decoder and swscale, not libjpeg: on the scene
  here they lie at most ``FFMPEG_GAP`` byte values from the port's, and
  ``FFMPEG_MEAN_GAP`` on average (asserted, and printed with ``-s``).
* The rotation: the same MP4 with ``tkhd``'s display matrix patched to
  90, 180 and 270 degrees against ``demos/video_iterator.check_rotation``;
  ``video_metadata`` and the frames of ``video_frames`` against the JAX
  package's, which cv2 turns upright by default; the demo's iterator.
* MPEG-4 Part 2 (``mp4v`` in an MP4, ``XVID`` and ``FMP4`` in an AVI) and
  H.264 raise ``NotImplementedError`` naming the codec.
* A packet without its Huffman tables (DHT) decodes to the bytes of the
  same packet with them, from an AVI written here without ``idx1`` (the
  ``movi`` scan).
* Motion JPEG format B (``mjpb``): fields written here from libjpeg's
  streams into a MOV, which cv2 (FFmpeg's mjpegb decoder) decodes to
  the very frames it decodes from the streams themselves; the port's
  frames are bitwise ``cv2.imdecode`` of the streams.
* ``Mp4Writer``'s file reads back through cv2 and the port.
* The training loader's frames by index (``datasets.FrameReader``) and
  ``normalized_frame_source`` over a video file and over a folder that
  mixes JPEG and PNG files.
"""

import struct

import cv2
import numpy as np
import pytest

from demos.video_iterator import Cv2VideoIterator
from demos.video_iterator import check_rotation as jax_check_rotation
from siammot_tpu.data.datasets import FrameReader as JaxFrameReader
from siammot_tpu.data.video_loader import video_frames as jax_video_frames
from siammot_tpu.data.video_loader import \
    video_metadata as jax_video_metadata
from siammot_tpu_torch.configs.defaults import get_cfg
from siammot_tpu_torch.data import container, native
from siammot_tpu_torch.data.datasets import FrameReader
from siammot_tpu_torch.data.transforms import EvalTransform
from siammot_tpu_torch.data.video_loader import (normalized_frame_source,
                                                 video_frames, video_metadata)
from siammot_tpu_torch.demos.video_iterator import (build_video_iterator,
                                                    check_rotation)

# the byte gap between cv2.VideoCapture's frames (FFmpeg's MJPEG decoder,
# its chroma upsampling and swscale's YUV to BGR) and the port's (libjpeg)
# on the scenes below: a CPU run measured at most 76 on the 160x96 scene
# (mean 5.2670) and 82 on the 96x64 one, the largest at the block's sharp
# red edges (MP4 and AVI alike)
FFMPEG_GAP = 88
FFMPEG_MEAN_GAP = 5.5


def scene(n=6, h=96, w=160):
    """Smooth RGB frames: an upsampled noise texture and a moving block."""
    rng = np.random.RandomState(3)
    base = native.resize_u8(rng.randint(0, 256, (h // 8 + 1, w // 8 + 1, 3))
                            .astype(np.uint8), w, h)
    out = []
    for t in range(n):
        f = base.copy()
        x = 4 + 5 * t
        f[h // 4:h // 2, x:x + w // 6] = (220, 40, 40)
        out.append(f)
    return out


def cv2_video(path, frames, fourcc, fps=12.5):
    h, w = frames[0].shape[:2]
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps,
                         (w, h))
    assert wr.isOpened(), fourcc
    for f in frames:
        wr.write(np.ascontiguousarray(f[..., ::-1]))
    wr.release()
    return str(path)


def cv2_props(path):
    cap = cv2.VideoCapture(path)
    props = (cap.get(cv2.CAP_PROP_FPS), int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
             int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
             int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f[..., ::-1])
    cap.release()
    return props, frames


def imdecode(packet):
    return cv2.imdecode(np.frombuffer(packet, np.uint8),
                        cv2.IMREAD_COLOR)[..., ::-1]


@pytest.mark.parametrize("ext", ["avi", "mp4"])
def test_mjpeg_frames_are_imdecode_of_their_packets(tmp_path, ext):
    frames = scene()
    path = cv2_video(tmp_path / f"clip.{ext}", frames, "MJPG")
    (fps, count, w, h), cv2_frames = cv2_props(path)
    video = container.open_video(path)
    assert video.codec == ("MJPG" if ext == "avi" else "mp4v")
    assert (video.fps, video.frame_count, video.width, video.height) == \
        (fps, count, w, h) == (12.5, 6, 160, 96)
    assert video_metadata(path) == jax_video_metadata(path)
    got = list(video.frames())
    assert len(got) == len(cv2_frames) == 6
    gaps = []
    for i, (frame, packet) in enumerate(zip(got, video.packets())):
        np.testing.assert_array_equal(frame, imdecode(packet))
        np.testing.assert_array_equal(video.frame(i), frame)
        gaps.append(np.abs(frame.astype(int) - cv2_frames[i].astype(int)))
    gap, mean = max(int(g.max()) for g in gaps), float(np.mean(gaps))
    print(f"{ext}: byte gap to cv2.VideoCapture's frames: largest {gap}, "
          f"mean {mean:.4f}")
    assert gap <= FFMPEG_GAP and mean <= FFMPEG_MEAN_GAP
    for got_f, want_f in zip(video_frames(path), jax_video_frames(path)):
        assert got_f.shape == want_f.shape


def patch_rotation(src, dst, matrix):
    data = bytearray(open(src, "rb").read())
    at = data.find(b"tkhd")
    version = data[at + 4]
    m = at + 4 + (52 if version == 1 else 40)
    data[m:m + 36] = struct.pack(">9i", *matrix)
    open(dst, "wb").write(bytes(data))
    return str(dst)


ROTATIONS = {90: (0, 0x10000, 0, -0x10000, 0, 0, 0, 0, 0x40000000),
             180: (-0x10000, 0, 0, 0, -0x10000, 0, 0, 0, 0x40000000),
             270: (0, -0x10000, 0, 0x10000, 0, 0, 0, 0, 0x40000000)}


def test_rotation_from_the_display_matrix(tmp_path):
    frames = scene(4, h=64, w=96)
    src = cv2_video(tmp_path / "clip.mp4", frames, "MJPG")
    assert check_rotation(src) == jax_check_rotation(src) == 0
    seen = set()
    for deg, matrix in ROTATIONS.items():
        path = patch_rotation(src, tmp_path / f"r{deg}.mp4", matrix)
        rotation = check_rotation(path)
        assert rotation == jax_check_rotation(path)
        seen.add(rotation)
        assert video_metadata(path) == jax_video_metadata(path)
        packets = list(container.open_video(path).packets())
        port = list(video_frames(path))
        jax = list(jax_video_frames(path))
        it = build_video_iterator(path)
        demo = [f for _, f in it]
        jdemo = [f for _, f in Cv2VideoIterator(path)]
        assert it.fps == 12.5 and it.frame_count == 4
        for p, j, d, jd, pk in zip(port, jax, demo, jdemo, packets):
            want = np.rot90(imdecode(pk), k=(-(rotation // 90)) % 4)
            np.testing.assert_array_equal(p, want)
            np.testing.assert_array_equal(d, want)
            assert p.shape == j.shape == jd.shape
    assert seen == {90, 180, 270}


@pytest.mark.parametrize("ext,fourcc,name", [
    ("mp4", "mp4v", "MPEG-4 Part 2"), ("avi", "XVID", "XVID"),
    ("avi", "FMP4", "FMP4")])
def test_other_codecs_raise_naming_the_codec(tmp_path, ext, fourcc, name):
    path = cv2_video(tmp_path / f"c.{ext}", scene(2, h=32, w=48), fourcc)
    for fn in (container.open_video, video_metadata, build_video_iterator,
               FrameReader):
        with pytest.raises(NotImplementedError, match=name) as err:
            fn(path)
        assert "Motion JPEG only" in str(err.value)


def test_h264_sample_entry_raises(tmp_path):
    # cv2 here has no H.264 encoder: the sample entry of an mp4v file is
    # renamed avc1, which is all the demuxer reads before it raises
    src = cv2_video(tmp_path / "c.mp4", scene(2, h=32, w=48), "mp4v")
    data = open(src, "rb").read().replace(b"mp4v", b"avc1", 1)
    (tmp_path / "h264.mp4").write_bytes(data)
    with pytest.raises(NotImplementedError, match="H.264"):
        container.open_video(str(tmp_path / "h264.mp4"))
    (tmp_path / "junk.mp4").write_bytes(b"\0" * 64)
    with pytest.raises(NotImplementedError, match="not an AVI, MP4 or MOV"):
        container.open_video(str(tmp_path / "junk.mp4"))


def strip_dht(packet):
    out, pos = packet[:2], 2
    while True:
        marker = packet[pos + 1]
        n = struct.unpack(">H", packet[pos + 2:pos + 4])[0]
        if marker == 0xDA:
            return out + packet[pos:]
        if marker != 0xC4:
            out += packet[pos:pos + 2 + n]
        pos += 2 + n


def write_avi(path, packets, w, h, fps=10):
    """A minimal MJPEG AVI (one video stream, ``00dc`` chunks, no idx1)."""
    def chunk(cc, body):
        return cc + struct.pack("<I", len(body)) + body + b"\0" * (
            len(body) & 1)

    def lst(kind, body):
        return chunk(b"LIST", kind + body)

    avih = struct.pack("<10I4I", 1000000 // fps, 0, 0, 0x10, len(packets),
                       0, 1, 0, w, h, 0, 0, 0, 0)
    strh = b"vidsMJPG" + struct.pack("<IHHIIIIIIIIhhhh", 0, 0, 0, 0, 1,
                                     fps, 0, len(packets), 0, 0xFFFFFFFF,
                                     0, 0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3,
                       0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih) + lst(
        b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    movi = lst(b"movi", b"".join(chunk(b"00dc", p) for p in packets))
    path.write_bytes(chunk(b"RIFF", b"AVI " + hdrl + movi))
    return str(path)


def test_packets_without_huffman_tables(tmp_path):
    frames = scene(3, h=48, w=64)
    packets = [native.encode_jpeg(f, 90) for f in frames]
    bare = [strip_dht(p) for p in packets]
    assert all(b"\xff\xc4" not in b[:b.find(b"\xff\xda")] for b in bare)
    for p, b in zip(packets, bare):
        fixed = container.with_huffman_tables(b)
        assert fixed != b and container.with_huffman_tables(p) is p
        np.testing.assert_array_equal(
            native.decode_jpeg_bytes(fixed), native.decode_jpeg_bytes(p))
    path = write_avi(tmp_path / "bare.avi", bare, 64, 48)
    video = container.open_video(path)
    assert (video.fps, video.frame_count, video.width, video.height) == \
        (10.0, 3, 64, 48)
    for got, p in zip(video.frames(), packets):
        np.testing.assert_array_equal(got, imdecode(p))


def to_mjpeg_b(stream):
    """A baseline JPEG stream as a Motion JPEG format B field: the 40-byte
    'mjpg' header, one DQT and one DHT segment holding all tables, SOF,
    SOS (no markers), then the scan with its stuffed bytes removed."""
    pos, seg = 2, {}
    while True:
        marker = stream[pos + 1]
        n = struct.unpack(">H", stream[pos + 2:pos + 4])[0]
        seg[marker] = seg.get(marker, b"") + stream[pos + 4:pos + 2 + n]
        pos += 2 + n
        if marker == 0xDA:
            break
    scan = stream[pos:stream.rindex(b"\xff\xd9")].replace(b"\xff\x00",
                                                           b"\xff")
    body, offsets = b"", []
    for marker in (0xDB, 0xC4, 0xC0, 0xDA):
        offsets.append(40 + len(body))
        body += struct.pack(">H", len(seg[marker]) + 2) + seg[marker]
    offsets.append(40 + len(body))
    size = 40 + len(body) + len(scan)
    return struct.pack(">I4s8I", 0, b"mjpg", size, size, 0, *offsets) \
        + body + scan


def test_motion_jpeg_b(tmp_path):
    frames = scene(3, h=48, w=64)
    streams = [native.encode_jpeg(f, 90) for f in frames]
    paths = {}
    for name, packets in (("jpeg", streams),
                          ("mjpb", [to_mjpeg_b(p) for p in streams])):
        path = str(tmp_path / f"{name}.mov")
        with container.Mp4Writer(path, 10.0, 64, 48) as wr:
            for p in packets:
                wr.write(p)
        paths[name] = path
    # the sample entry says mjpb, and no esds overrides it
    data = open(paths["mjpb"], "rb").read()
    open(paths["mjpb"], "wb").write(data.replace(b"mp4v", b"mjpb", 1)
                                    .replace(b"esds", b"free", 1))
    (_, count, w, h), ffmpeg_b = cv2_props(paths["mjpb"])
    _, ffmpeg = cv2_props(paths["jpeg"])
    assert (count, w, h) == (3, 64, 48) and len(ffmpeg_b) == 3
    for a, b in zip(ffmpeg_b, ffmpeg):
        np.testing.assert_array_equal(a, b)
    video = container.open_video(paths["mjpb"])
    assert video.codec == "mjpb" and video.frame_count == 3
    for got, p in zip(video.frames(), streams):
        np.testing.assert_array_equal(got, imdecode(p))


def test_mp4_writer_reads_back(tmp_path):
    frames = scene(5, h=48, w=80)
    packets = [native.encode_jpeg(f, 95) for f in frames]
    path = str(tmp_path / "out.mp4")
    with container.Mp4Writer(path, 29.97, 80, 48) as wr:
        for p in packets:
            wr.write(p)
    (fps, count, w, h), cv2_frames = cv2_props(path)
    assert (count, w, h, len(cv2_frames)) == (5, 80, 48, 5)
    assert abs(fps - 29.97) < 1e-9
    video = container.open_video(path)
    assert (video.frame_count, video.width, video.height, video.rotation) \
        == (5, 80, 48, 0) and abs(video.fps - 29.97) < 1e-12
    assert list(video.packets()) == packets


def test_training_reader_and_inference_source_on_files(tmp_path):
    frames = scene(6, h=64, w=96)
    path = cv2_video(tmp_path / "clip.avi", frames, "MJPG")
    video = container.open_video(path)
    port, jax = FrameReader(path), JaxFrameReader(path)
    for i in (4, 0, 5, 2):
        got = port[i]
        np.testing.assert_array_equal(got, imdecode(video.packet(i)))
        assert np.abs(got.astype(int) - jax[i].astype(int)).max() \
            <= FFMPEG_GAP
    with pytest.raises(IOError, match="cannot seek frame 6"):
        port[6]
    cfg = get_cfg()
    cfg.merge_from_list(["INPUT.MIN_SIZE_TEST", 48, "INPUT.MAX_SIZE_TEST",
                         80])
    tf = EvalTransform(cfg)
    got = list(normalized_frame_source(path, tf))
    assert len(got) == 6
    for (x, size), f in zip(got, video.frames()):
        y, want_size = tf(f)
        assert size == want_size == (72, 48)
        np.testing.assert_array_equal(x, y)
    # a folder mixing JPEG and PNG files: the JPEGs alone, as the JAX
    # package's native path takes them
    mixed = tmp_path / "mixed"
    mixed.mkdir()
    for i, f in enumerate(frames[:4]):
        ext = "jpg" if i % 2 == 0 else "png"
        cv2.imwrite(str(mixed / f"{i:06d}.{ext}"), f[..., ::-1])
    got = list(normalized_frame_source(str(mixed), tf))
    assert len(got) == 2
    for (x, size), name in zip(got, ("000000.jpg", "000002.jpg")):
        f = native.decode_resize(str(mixed / name), 72, 48)
        np.testing.assert_array_equal(x[0, :48, :72], f)
    assert video_metadata(str(mixed))["number_of_frames"] == 4
