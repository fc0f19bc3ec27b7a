"""H.264 and MPEG-4 Part 2 in the port's readers (``siammot_tpu_torch/
data/container.py`` and ``data/nvdec.py``), on the CPU, against cv2 and the
JAX package, over ``tests/fixtures/video`` (written by ``python
tools/make_torch_video_fixtures.py``).

The port decodes H.264 and MPEG-4 Part 2 on the card only (NVDEC), so
here the demuxer is held to cv2 through the elementary stream it makes:

* the stream from the MP4 and from the AVI, written to a ``.h264`` (or
  ``.m4v``) file, decodes through ``cv2.VideoCapture`` to the container's
  own frames, bitwise;
* frame count, fps and size equal cv2's ``CAP_PROP_*`` and the JAX
  package's ``video_metadata``;
* the seek plan of every index: the packets from its sync sample, as a
  stream through cv2, give the JAX ``FrameReader``'s frame at that index
  after the plan's skip; also under an edit list that hides the first
  frames (cv2 drops them too);
* the conversion: the plain NV12-to-RGB arithmetic on x264's
  reconstruction is the JAX package's ``video_frames`` of the MP4, bitwise
  (swscale's x86 route);
* a CPU decode of H.264 or MPEG-4 Part 2 raises, naming the codec and
  NVDEC; sample entries the port has no decoder for (ProRes, MPEG-2) and
  DivX packed B-frames raise naming what they are;
* the ctypes mirrors of the Video Codec SDK structs ``nvdec.cu`` declares
  by hand have SDK 12.x's sizes and field offsets.
"""

import hashlib
import os
import struct

import cv2
import numpy as np
import pytest
import torch

from demos.video_iterator import Cv2VideoIterator
from siammot_tpu.data.datasets import FrameReader as JaxFrameReader
from siammot_tpu.data.video_loader import video_frames as jax_video_frames
from siammot_tpu.data.video_loader import \
    video_metadata as jax_video_metadata
from siammot_tpu_torch.data import container, nvdec
from siammot_tpu_torch.data.datasets import FrameReader
from siammot_tpu_torch.data.video_loader import video_frames, video_metadata
from siammot_tpu_torch.demos.video_iterator import build_video_iterator
from tools.make_torch_video_fixtures import write_avi

VIDEO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                     "video")
W, H = 200, 120
H264 = ["h264_small.mp4", "h264_small.avi"]
MPEG4 = ["mpeg4_small.mp4", "mpeg4_small.avi"]
STREAM_EXT = {container.H264: ".h264", container.MPEG4: ".m4v"}


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
    return np.load(os.path.join(VIDEO, "h264_small_ref.npz"))


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


def stream_frames(video, tmp_path, start=0):
    """cv2's frames of the elementary stream from packet ``start`` on."""
    path = tmp_path / f"s{start}{STREAM_EXT[video.format]}"
    path.write_bytes(video.elementary_stream(start))
    return cv2_rgb(path)


def nv12(ref, i):
    """Frame i of x264's reconstruction as an NV12 tensor."""
    uv = np.stack([ref["u"][i], ref["v"][i]], -1).reshape(H // 2, W)
    return torch.from_numpy(np.concatenate([ref["y"][i], uv]))


# -- the demuxed elementary stream ------------------------------------------

@pytest.mark.parametrize("name", H264 + MPEG4)
def test_demuxed_stream_decodes_through_cv2_to_the_containers_frames(
        tmp_path, name, ref):
    video = container.open_video(fixture(name))
    got = stream_frames(video, tmp_path)
    want = cv2_rgb(fixture(name))
    assert len(got) == len(want) == video.frame_count
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if video.format == container.H264:
        assert [sha(f) for f in got] == list(ref["cv2_sha256"])
    else:
        rgb = np.load(fixture("mpeg4_small_ref.npz"))["rgb"]
        np.testing.assert_array_equal(np.stack(got), rgb)


def test_mp4_and_avi_streams_carry_the_same_pictures():
    """The MP4's length-prefixed samples as Annex B, each sync sample
    prefixed with avcC's parameter sets, hold the AVI's NAL units (which
    carry their parameter sets in band)."""
    mp4 = container.open_video(fixture("h264_small.mp4"))
    avi = container.open_video(fixture("h264_small.avi"))
    assert mp4.nal_length == 4 and avi.nal_length == 0
    assert mp4.sync == avi.sync == [0, 8, 16]
    assert mp4.header.startswith(b"\0\0\0\1\x67")      # the SPS, then PPS
    for i, (a, b) in enumerate(zip(mp4.packets(), avi.packets())):
        units = mp4.stream_packet(a, i, i == 0).split(b"\0\0\0\1")
        assert all(u in b for u in units if u), i


@pytest.mark.parametrize("name,sync", [("h264_small.avi", [0, 8, 16]),
                                       ("mpeg4_small.avi", [0])])
def test_avi_without_idx1_finds_keyframes_in_the_stream(tmp_path, name,
                                                        sync):
    """Without ``idx1`` the keyframes are the packets holding an IDR slice
    or an I-VOP: the same as ``idx1``'s ``AVIIF_KEYFRAME`` entries."""
    data = open(fixture(name), "rb").read()
    cut = data[:data.index(b"idx1")]
    path = tmp_path / "noidx.avi"
    path.write_bytes(cut[:4] + struct.pack("<I", len(cut) - 8) + cut[8:])
    with_index = container.open_video(fixture(name))
    without = container.open_video(str(path))
    assert with_index.sync == without.sync == sync
    assert with_index.spans == without.spans


@pytest.mark.parametrize("name", H264 + MPEG4)
def test_frame_count_order_and_metadata_match_cv2_and_jax(name, ref):
    path = fixture(name)
    video = container.open_video(path)
    cap = cv2.VideoCapture(path)
    assert video.frame_count == int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    assert video.fps == cap.get(cv2.CAP_PROP_FPS) == 25.0
    assert (video.width, video.height) == (
        int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
        int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))) == (W, H)
    cap.release()
    assert video_metadata(path) == jax_video_metadata(path)
    if name == "h264_small.mp4":
        # ctts: decode order I P B B ..., display order by composition time
        assert video.order[:4] == [0, 2, 3, 1]
        assert video.shown == list(range(24))
        assert ref["cv2_count"].tolist() == [24, 24]


# -- the seek plan -----------------------------------------------------------

def test_seek_plan_on_sample_tables():
    # decode order I0 P3 B1 B2 I4 P7 B5 B6 (display ranks), sync 0 and 4
    rank = [0, 3, 1, 2, 4, 7, 5, 6]
    assert [container.seek_plan([0, 4], rank, t) for t in range(8)] == [
        (0, 0), (0, 1), (0, 2), (0, 3), (4, 0), (4, 1), (4, 2), (4, 3)]
    # a sync sample whose display rank lies past the target is not used
    assert container.seek_plan([0, 1], [0, 5, 1, 2, 3, 4], 4) == (0, 4)
    with pytest.raises(IOError, match="no sync sample"):
        container.seek_plan([1], [1, 2, 0], 0)


@pytest.mark.parametrize("name", H264 + ["mpeg4_small.mp4"])
def test_seek_plan_gives_jax_frame_reader_frames(tmp_path, name, ref):
    """For every index: the packets from the plan's sync sample, as a
    stream through cv2, after the plan's skip, are the JAX
    ``FrameReader``'s frame (``CAP_PROP_POS_FRAMES``), which the fixture
    measured to be the sequential frame at every index."""
    path = fixture(name)
    video = container.open_video(path)
    jax_reader = JaxFrameReader(path)
    seq = cv2_rgb(path)
    by_start = {}
    for i in range(video.frame_count):
        start, skip = video.plan(i)
        if start not in by_start:
            by_start[start] = stream_frames(video, tmp_path, start)
        np.testing.assert_array_equal(by_start[start][skip], jax_reader[i])
        np.testing.assert_array_equal(seq[i], jax_reader[i])
        if name.startswith("h264"):
            assert ref["cv2_seek"][i] == i == ref["cv2_seek_avi"][i]
    assert sorted(by_start) == sorted(set(video.sync))


@pytest.mark.parametrize("media_time", [1536, 2048])
def test_edit_list_hides_frames_as_ffmpeg_does(tmp_path, media_time):
    """An ``elst`` that starts one or two frames late (or mid-frame): cv2
    drops the frames whose composition time lies before it; the port
    shows the same frames, seeks to them by plan, and counts every
    sample in the metadata as ``CAP_PROP_FRAME_COUNT`` does."""
    data = bytearray(open(fixture("h264_small.mp4"), "rb").read())
    at = data.index(b"elst") + 16          # entry 0's media time
    assert struct.unpack_from(">i", data, at)[0] == 1024
    struct.pack_into(">i", data, at, media_time)
    path = tmp_path / "late.mp4"
    path.write_bytes(bytes(data))
    video = container.open_video(str(path))
    want = cv2_rgb(path)
    hidden = (media_time - 1024 + 511) // 512      # 512 units a frame
    assert video.frame_count == len(want) == 24 - hidden
    assert video_metadata(str(path))["number_of_frames"] == 24 == int(
        cv2.VideoCapture(str(path)).get(cv2.CAP_PROP_FRAME_COUNT))
    for i in range(video.frame_count):
        start, skip = video.plan(i)
        got = stream_frames(video, tmp_path, start)[skip]
        np.testing.assert_array_equal(got, want[i])


class ReorderingDecoder:
    """Stands in for an NVDEC session on the CPU: takes the elementary
    stream's packets, knows each packet's display rank from the
    container's tables, and gives back cv2's frames in display order with
    the reordering delay of a B-frame decoder (a frame comes out once
    ``delay`` later packets are in, the rest at the end of the stream).
    Checks that every session starts at a sync sample with its
    parameter sets and counts its sessions."""

    sessions = 0

    def __init__(self, video, frames, delay=2):
        self.video, self.frames, self.delay = video, frames, delay
        self.index = {}
        for i, d in enumerate(video.packets()):
            for first in (False, True):
                self.index.setdefault(video.stream_packet(d, i, first), i)
        self.rank = video.rank()
        self.held = []
        self.next_rank = None
        ReorderingDecoder.sessions += 1

    def feed(self, packet):
        if packet is not None:
            i = self.index[packet]
            if self.next_rank is None:
                assert i in self.video.sync, i
                assert packet.startswith(self.video.header), i
                self.next_rank = self.rank[i]
            self.held.append(self.rank[i])
        out = []
        while self.next_rank in self.held and (
                packet is None or len(self.held) > self.delay):
            self.held.remove(self.next_rank)
            out.append(self.frames[self.next_rank])
            self.next_rank += 1
        return out

    def close(self):
        pass


def fake_sessions(monkeypatch, video, frames):
    ReorderingDecoder.sessions = 0
    monkeypatch.setattr(video, "session",
                        lambda device: ReorderingDecoder(video, frames))


@pytest.mark.parametrize("name", H264)
def test_stream_reading_in_order_and_by_index(monkeypatch, name):
    """``frames`` and ``frame`` over a decoder that reorders as a B-frame
    decoder does (the CPU has no H.264 decoder the port may use): cv2's
    frames in order; random access decodes forward within a GOP and
    starts a new session only to go back or to skip past a sync sample."""
    video = container.open_video(fixture(name))
    want = cv2_rgb(fixture(name))
    fake_sessions(monkeypatch, video, want)
    got = list(video.frames("cuda"))
    assert len(got) == 24 and ReorderingDecoder.sessions == 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    ReorderingDecoder.sessions = 0
    for i in range(24):                           # forward: one session
        np.testing.assert_array_equal(video.frame(i, "cuda"), want[i])
    assert ReorderingDecoder.sessions == 1
    for i, sessions in ((5, 2), (6, 2), (17, 3), (23, 3), (9, 4), (2, 5)):
        np.testing.assert_array_equal(video.frame(i, "cuda"), want[i])
        assert ReorderingDecoder.sessions == sessions, i
    order = np.random.RandomState(0).permutation(24)
    for i in order:
        np.testing.assert_array_equal(video.frame(int(i), "cuda"), want[i])


def test_stream_reading_under_an_edit_list(monkeypatch, tmp_path):
    """Frames an ``elst`` hides are decoded and dropped, as cv2 drops
    them; ``frame(i)`` is cv2's i-th frame."""
    data = bytearray(open(fixture("h264_small.mp4"), "rb").read())
    struct.pack_into(">i", data, data.index(b"elst") + 16, 2048)
    path = tmp_path / "late.mp4"
    path.write_bytes(bytes(data))
    video = container.open_video(str(path))
    want = cv2_rgb(path)
    full = cv2_rgb(fixture("h264_small.mp4"))   # every rank, for the fake
    fake_sessions(monkeypatch, video, full)
    got = list(video.frames("cuda"))
    assert len(got) == len(want) == 22
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for i in (21, 0, 7, 6, 13):
        np.testing.assert_array_equal(video.frame(i, "cuda"), want[i])


# -- the conversion ----------------------------------------------------------

def test_plain_conversion_of_the_reconstruction_is_jax_video_frames(ref):
    jax = list(jax_video_frames(fixture("h264_small.mp4")))
    assert len(jax) == len(ref["y"])
    for i, frame in enumerate(jax):
        x = nv12(ref, i)
        got = nvdec.nv12_to_rgb(x, W, H)           # a CPU tensor: plain
        np.testing.assert_array_equal(got.numpy(), frame)
        assert sha(frame) == ref["cv2_sha256"][i]
        # NVDEC's layout: a pitch past the width, padding bytes ignored
        padded = torch.full((x.shape[0], 256), 0xA5, dtype=torch.uint8)
        padded[:, :W] = x
        np.testing.assert_array_equal(
            nvdec.nv12_to_rgb_plain(padded, W, H).numpy(), frame)


def test_conversion_arithmetic_over_every_byte_triple():
    """The plain version against the formula in float-free numpy over
    every Y, U, V (so no tensor op rounds or wraps differently)."""
    y, u, v = np.meshgrid(np.arange(256), np.arange(256), np.arange(0, 256,
                          5), indexing="ij")
    y, u, v = y.ravel(), u.ravel(), v.ravel()
    n = y.size
    frame = np.zeros((3, 2 * n), np.uint8)          # 2 rows, chroma row
    frame[0, 0::2] = frame[0, 1::2] = y
    frame[2, 0::2], frame[2, 1::2] = u, v
    got = nvdec.nv12_to_rgb_plain(torch.from_numpy(frame), 2 * n, 1)
    yy = ((8 * y - 128) * 9539) >> 16
    uu, vv = 8 * u - 1024, 8 * v - 1024
    want = np.clip(np.stack([yy + ((vv * 13075) >> 16),
                             yy + ((uu * -3209) >> 16) + ((vv * -6660) >> 16),
                             yy + ((uu * 16525) >> 16)], -1), 0, 255)
    np.testing.assert_array_equal(got[0, 0::2].numpy(), want)
    np.testing.assert_array_equal(got[0, 1::2].numpy(), want)


@pytest.mark.parametrize("name", H264 + MPEG4 + ["h264_720p.mp4"])
def test_demo_iterator_reports_what_the_jax_demo_reads(name):
    """The demo's ``ContainerIterator`` gives the JAX demo's fps, frame
    count (``CAP_PROP_FRAME_COUNT``) and rotation."""
    path = fixture(name)
    it, jit = build_video_iterator(path), Cv2VideoIterator(path)
    assert (it.fps, it.frame_count, it.rotation) == (
        jit.fps, jit.frame_count, jit.rotation)


# -- what raises --------------------------------------------------------------

@pytest.mark.parametrize("name,codec", [
    ("h264_small.mp4", "H.264"), ("h264_small.avi", "H.264"),
    ("h264_720p.mp4", "H.264"), ("mpeg4_small.mp4", "MPEG-4 Part 2"),
    ("mpeg4_small.avi", "MPEG-4 Part 2")])
def test_cpu_decode_raises_naming_the_codec_and_nvdec(name, codec):
    path = fixture(name)
    video = container.open_video(path)
    assert video.format == codec
    for decode in (lambda: list(video_frames(path)),
                   lambda: FrameReader(path)[video.frame_count - 1],
                   lambda: list(build_video_iterator(path))):
        with pytest.raises(NotImplementedError, match=codec) as err:
            decode()
        assert "NVDEC" in str(err.value)


@pytest.mark.parametrize("entry,name", [
    (b"apcn", "ProRes"), (b"mp2v", "MPEG-2"), (b"apch", "ProRes")])
def test_other_sample_entries_raise_no_decoder(tmp_path, entry, name):
    data = bytearray(open(fixture("h264_small.mp4"), "rb").read())
    at = data.index(b"avc1", data.index(b"stsd"))   # the sample entry
    data[at:at + 4] = entry
    (tmp_path / "x.mp4").write_bytes(bytes(data))
    with pytest.raises(NotImplementedError, match=name) as err:
        container.open_video(str(tmp_path / "x.mp4"))
    assert "H.264, HEVC, MPEG-4 Part 2, VP8, VP9 and AV1 (NVDEC on the " \
        "card)" in str(err.value)


def test_divx_packed_b_frames_raise(tmp_path):
    """An XVID AVI whose first packet carries DivX user data ending in
    'p' (FFmpeg's ``divx_packed``) raises; without the 'p' it demuxes."""
    src = container.open_video(fixture("mpeg4_small.avi"))
    packets = list(src.packets())
    for tag, packed in ((b"DivX503b1393p", True), (b"DivX503b1393", False)):
        first = packets[0] + b"\0\0\1\xb2" + tag
        path = tmp_path / f"divx{packed}.avi"
        write_avi(str(path), [first] + packets[1:],
                  [True] + [False] * (len(packets) - 1), W, H, b"XVID")
        if packed:
            with pytest.raises(NotImplementedError, match="packed"):
                container.open_video(str(path))
        else:
            assert container.open_video(str(path)).frame_count == 12


class _Lib:
    """A stand-in for the built library's error text."""

    @staticmethod
    def nvd_error():
        return b"cuvidGetDecoderCaps: CUDA_ERROR_OUT_OF_MEMORY (2)"


@pytest.mark.parametrize("code", [2, -1])
def test_nvdec_errors_carry_the_drivers_code(code):
    """A failed NVDEC call raises ``NvdecError`` with the driver's
    ``CUresult`` (or -1 for the port's own step), which the card check
    reads to tell a machine that withholds NVDEC from a fault."""
    with pytest.raises(nvdec.NvdecError, match="OUT_OF_MEMORY") as err:
        nvdec._check(_Lib, code, "cuvidGetDecoderCaps for H.264")
    assert err.value.code == code
    assert isinstance(err.value, RuntimeError)
    nvdec._check(_Lib, 0, "no error")


# -- the hand-declared SDK structs ------------------------------------------

# Video Codec SDK 12.x on LP64 Linux (unsigned long is 8 bytes)
LAYOUTS = {
    "DecodeCaps": (88, {"eCodecType": 0, "eChromaFormat": 4,
                        "nBitDepthMinus8": 8, "bIsSupported": 24,
                        "nOutputFormatMask": 26, "nMaxWidth": 28,
                        "nMaxMBCount": 36, "nMinWidth": 40,
                        "reserved3": 48}),
    "DecodeCreateInfo": (176, {"ulNumDecodeSurfaces": 16, "CodecType": 24,
                               "ChromaFormat": 28, "ulCreationFlags": 32,
                               "bitDepthMinus8": 40,
                               "ulMaxWidth": 56, "display_area": 80,
                               "OutputFormat": 88, "DeinterlaceMode": 92,
                               "ulTargetWidth": 96,
                               "ulNumOutputSurfaces": 112, "vidLock": 120,
                               "target_rect": 128, "Reserved2": 144}),
    "ProcParams": (264, {"unpaired_field": 12, "raw_input_dptr": 24,
                         "raw_output_dptr": 40, "output_stream": 56,
                         "Reserved": 64, "histogram_dptr": 248}),
    "VideoFormat": (64, {"progressive_sequence": 12,
                         "bit_depth_luma_minus8": 13,
                         "bit_depth_chroma_minus8": 14,
                         "min_num_decode_surfaces": 15, "coded_width": 16,
                         "display_area": 24, "chroma_format": 40,
                         "video_signal_description": 56,
                         "seqhdr_data_length": 60}),
    "ParserDispInfo": (24, {"repeat_first_field": 12, "timestamp": 16}),
    "ParserParams": (136, {"ulMaxDisplayDelay": 16, "uReserved1": 24,
                           "pUserData": 40, "pfnSequenceCallback": 48,
                           "pfnDisplayPicture": 64, "pvReserved2": 88,
                           "pExtVideoInfo": 128}),
    "SourceDataPacket": (32, {"payload_size": 8, "payload": 16,
                              "timestamp": 24}),
}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_sdk_struct_layouts(name):
    import ctypes
    struct_ = getattr(nvdec, name)
    size, offsets = LAYOUTS[name]
    assert struct_ in nvdec.STRUCTS
    assert ctypes.sizeof(struct_) == size
    for field, at in offsets.items():
        assert getattr(struct_, field).offset == at, field
    # nvdec.cu asserts the same sizes at compile time
    src = open(os.path.join(os.path.dirname(nvdec.__file__),
                            "nvdec.cu")).read()
    c_name = {"DecodeCaps": "CUVIDDECODECAPS",
              "DecodeCreateInfo": "CUVIDDECODECREATEINFO",
              "ProcParams": "CUVIDPROCPARAMS", "VideoFormat": "CUVIDEOFORMAT",
              "ParserDispInfo": "CUVIDPARSERDISPINFO",
              "ParserParams": "CUVIDPARSERPARAMS",
              "SourceDataPacket": "CUVIDSOURCEDATAPACKET"}[name]
    assert f"static_assert(sizeof({c_name}) == {size}" in src
