"""HEVC, VP8, VP9 and AV1, and H.264 and MPEG-4 Part 2 in Matroska, in the
port's readers (``siammot_tpu_torch/data/container.py``, ``matroska.py``,
``codecs.py`` and ``nvdec.py``), on the CPU, against cv2 and the JAX
package, over ``tests/fixtures/video`` (written by ``python
tools/make_torch_container_fixtures.py``).

The port decodes these codecs on the card only (NVDEC), so here the
demuxer is held to a CPU decoder through the elementary stream it makes:

* each fixture's stream, written as Annex B (``.h264``, ``.hevc``), as
  ``.m4v``, or as VP8/VP9 frames wrapped in IVF, decodes through
  ``cv2.VideoCapture`` to cv2's own frames of the container, bitwise;
  AV1, which cv2's FFmpeg cannot decode in software (it reads no frame of
  these files), decodes through libaom to libaom's frames of the temporal
  units it wrote;
* the seek plan of every index, open GOPs included (x264's non-IDR
  I-frames with leading B-frames, x265's CRA pictures with RASL leading
  pictures): the packets from the plan's sync sample, decoded, give the
  sequential frame at that index after the plan's skip; cv2's own
  ``CAP_PROP_POS_FRAMES`` frame (the JAX ``FrameReader``'s) is printed and
  held to what the fixture recorded;
* counts, display order and every ``frame(i)`` through a stand-in for an
  NVDEC session that reorders as a B-frame decoder does;
* metadata against the JAX package's ``video_metadata`` and the demo
  iterator against the JAX demo's;
* what raises: a CPU decode, naming the codec and NVDEC; a 4:0:0 stream
  (``av1C``), naming its bit depth and chroma format before any driver
  call; a 10-bit stream (HEVC SPS, VP9 header, ``vpcC``, ``av1C``)
  reaches ``cuvidGetDecoderCaps`` at its own depth and chroma on a card
  device (the driver stood in); a codec the card's caps do not list,
  naming the codec, depth, chroma and the card;
* the NVDEC codec IDs of ``nvdec.py`` and ``nvdec.cu`` agree.
"""

import hashlib
import json
import os
import re
import struct

import cv2
import numpy as np
import pytest
import torch

from demos.video_iterator import Cv2VideoIterator
from siammot_tpu.data.video_loader import \
    video_metadata as jax_video_metadata
from siammot_tpu_torch.data import codecs, container, nvdec
from siammot_tpu_torch.data.datasets import FrameReader
from siammot_tpu_torch.data.video_loader import video_frames, video_metadata
from siammot_tpu_torch.demos.video_iterator import build_video_iterator
from tools import make_torch_container_fixtures as fx

VIDEO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                     "video")
CV2_STREAMS = ["h264_opengop.mkv", "mpeg4_small.mkv", "hevc_small.mp4",
               "hevc_hev1.mp4", "hevc_small.mkv", "vp9_small.webm",
               "vp8_small.webm", "vp9_small.mp4", "vp9_live.webm"]
AV1 = ["av1_small.mp4", "av1_small.mkv"]
STREAMS = CV2_STREAMS + AV1
FORMATS = {"h264_opengop.mkv": "H.264", "mpeg4_small.mkv": "MPEG-4 Part 2",
           "hevc_small.mp4": "HEVC", "hevc_hev1.mp4": "HEVC",
           "hevc_small.mkv": "HEVC", "vp9_small.webm": "VP9",
           "vp8_small.webm": "VP8", "vp9_small.mp4": "VP9",
           "vp9_live.webm": "VP9", "av1_small.mp4": "AV1",
           "av1_small.mkv": "AV1"}
EXT = {"H.264": ".h264", "HEVC": ".hevc", "MPEG-4 Part 2": ".m4v",
       "VP8": ".ivf", "VP9": ".ivf"}


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


def stream_packets(video, start=0):
    return [video.stream_packet(d, i, i == start)
            for i, d in enumerate(video.packets(start), start)]


def ivf(video, packets) -> bytes:
    """VP8 or VP9 frames in an IVF file (a 32-byte header, then each
    frame's size, timestamp and bytes)."""
    fourcc = b"VP80" if video.format == "VP8" else b"VP90"
    head = b"DKIF" + struct.pack("<HH4sHHIIII", 0, 32, fourcc, video.width,
                                 video.height, 25, 1, len(packets), 0)
    return head + b"".join(struct.pack("<IQ", len(p), k) + p
                           for k, p in enumerate(packets))


def decoded(video, tmp_path, start=0):
    """A CPU decoder's frames of the stream from packet ``start`` on: cv2's
    RGB frames' SHA-256 (libaom's planes' for AV1)."""
    packets = stream_packets(video, start)
    if video.format == "AV1":
        return [[sha(p) for p in f] for f in fx.aom_decode(packets)]
    path = tmp_path / f"s{start}{EXT[video.format]}"
    path.write_bytes(ivf(video, packets) if video.format in ("VP8", "VP9")
                     else b"".join(packets))
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        out.append(sha(bgr[..., ::-1]))
    cap.release()
    return out


def reference(ref, name):
    return ref[name]["aom_sha256" if name in AV1 else "sha256"]


# -- the elementary streams ---------------------------------------------------

@pytest.mark.parametrize("name", STREAMS)
def test_demuxed_stream_decodes_to_the_containers_frames(tmp_path, name, ref):
    video = container.open_video(fixture(name))
    assert video.format == FORMATS[name]
    got = decoded(video, tmp_path)
    assert got == reference(ref, name)
    assert len(got) == video.frame_count
    if name in AV1:
        # cv2's FFmpeg has only the hardware AV1 decoder: the JAX package
        # reads no frame of these files, though it reads their metadata
        assert ref[name]["frames"] == 0 and ref[name]["count"] == 24
    else:
        assert ref[name]["frames"] == video.frame_count


@pytest.mark.parametrize("name", STREAMS)
def test_seek_plan_gives_the_sequential_frame_at_every_index(tmp_path, name,
                                                             ref):
    """For every index: the packets from the plan's sync sample, decoded,
    after the plan's skip, are the sequential frame.  Open GOPs start at
    their I or CRA picture, whose leading pictures (which refer across
    it) the decoder drops; cv2's own seek (``CAP_PROP_POS_FRAMES``, the
    JAX ``FrameReader``) is what the fixture recorded: frame i, but frame
    0 throughout the live WebM, whose frame-count estimate is negative."""
    video = container.open_video(fixture(name))
    want = reference(ref, name)
    by_start = {}
    for i in range(video.frame_count):
        start, skip = video.plan(i)
        if start not in by_start:
            by_start[start] = decoded(video, tmp_path, start)
        assert by_start[start][skip] == want[i], (i, start, skip)
    assert sorted(by_start) == sorted(set(video.sync))
    seek = ref[name]["seek"]
    print(f"{name}: sync {video.sync}; cv2 CAP_PROP_POS_FRAMES frames {seek}")
    if name in AV1:
        assert seek == []
    elif name == "vp9_live.webm":
        assert seek == [0] * video.frame_count
    else:
        assert seek == list(range(video.frame_count))


@pytest.mark.parametrize("name", ["h264_opengop.mkv", "hevc_small.mp4",
                                  "hevc_hev1.mp4", "hevc_small.mkv"])
def test_open_gop_fixtures_have_leading_pictures(name):
    """The open-GOP fixtures do test leading pictures: a sync sample past
    the first is followed in decode order by pictures shown before it
    (for HEVC, RASL NAL units, types 8 and 9, after a CRA, type 21)."""
    video = container.open_video(fixture(name))
    rank = video.rank()
    lead = {s: [i for i in range(s + 1, len(rank)) if rank[i] < rank[s]]
            for s in video.sync[1:]}
    print(f"{name}: leading pictures of each sync sample {lead}")
    assert any(lead.values()), lead
    if video.format == "HEVC":
        kinds = [[codecs.nal_type("HEVC", u)
                  for u in codecs.nal_units(p, video.nal_length)]
                 for p in video.packets()]
        for s, leading in lead.items():
            assert 21 in kinds[s]
            assert all(set(kinds[i]) & {8, 9} for i in leading)


class StandIn:
    """Stands in for an NVDEC session on the CPU, as ``ReorderingDecoder``
    of ``test_torch_video_codecs.py`` does, for streams whose packets may
    repeat (AV1's ``show_existing_frame`` temporal units): the first
    packet must be a sync sample with its header; later ones follow in
    decode order.  Frames come out in display order once ``delay`` later
    packets are in (the rest at the end of the stream); a hidden packet
    gives none.  Frame r is filled with r, so a test reads its rank back
    (:func:`ranks`)."""

    sessions = 0

    def __init__(self, video, delay=3):
        self.video, self.delay = video, delay
        self.frames = [np.full((video.height, video.width, 3), r, np.uint8)
                       for r in range(video.frame_count)]
        self.rank = video.rank()
        self.first = {video.stream_packet(video.packet(i), i, True): i
                      for i in video.sync}
        self.last = None
        self.held = []
        self.next_rank = None
        StandIn.sessions += 1

    def feed(self, packet):
        if packet is not None:
            if self.last is None:
                self.last = self.first[packet]
                self.next_rank = self.rank[self.last]
            else:
                self.last += 1
                assert packet == self.video.stream_packet(
                    self.video.packet(self.last), self.last, False)
            if self.rank[self.last] is not None:
                self.held.append(self.rank[self.last])
        out = []
        while self.next_rank in self.held and (
                packet is None or len(self.held) > self.delay):
            self.held.remove(self.next_rank)
            out.append(self.frames[self.next_rank])
            self.next_rank += 1
        return out

    def close(self):
        pass


def ranks(frames):
    return [int(f[0, 0, 0]) for f in frames]


@pytest.mark.parametrize("name", STREAMS)
def test_stream_reading_in_order_and_by_index(monkeypatch, name, ref):
    """``frames`` and ``frame`` over the stand-in: every frame in order,
    random access forward within a GOP in one session, and every index in
    shuffled order."""
    video = container.open_video(fixture(name))
    n = video.frame_count
    assert n == len(reference(ref, name))
    StandIn.sessions = 0
    monkeypatch.setattr(video, "session", lambda device: StandIn(video))
    assert ranks(video.frames("cuda")) == list(range(n))
    StandIn.sessions = 0
    assert ranks(video.frame(i, "cuda") for i in range(n)) == list(range(n))
    assert StandIn.sessions == 1
    order = [int(i) for i in np.random.RandomState(1).permutation(n)]
    assert ranks(video.frame(i, "cuda") for i in order) == order


def test_hidden_vp8_frames_take_no_display_rank(tmp_path, monkeypatch, ref):
    """A VP8 alt-ref stored alone (``show_frame`` 0) outputs no frame: it is
    fed, has no display rank, and the count and the seeks skip it."""
    packets = fx.demuxed(fixture("vp8_small.webm"))
    hidden = bytearray(packets[3]["data"])
    hidden[0] &= ~0x10                          # show_frame = 0
    packets.insert(4, dict(data=bytes(hidden), pts=3.5, key=False))
    path = str(tmp_path / "hidden.webm")
    fx.write_mkv(path, "V_VP8", b"", packets, doc_type="webm")
    video = container.open_video(path)
    assert video.hidden == {4} and video.frame_count == 12
    assert video.rank()[4] is None and video.rank()[5] == 4
    monkeypatch.setattr(video, "session", lambda device: StandIn(video))
    assert ranks(video.frames("cuda")) == list(range(12))
    assert ranks(video.frame(i, "cuda") for i in (11, 4, 3)) == [11, 4, 3]


# -- metadata ----------------------------------------------------------------

@pytest.mark.parametrize("name", STREAMS)
def test_metadata_matches_cv2_and_jax(name, ref):
    path = fixture(name)
    video = container.open_video(path)
    meta = video_metadata(path)
    assert meta == jax_video_metadata(path)
    assert meta["fps"] == ref[name]["fps"] == video.fps == 25.0
    assert meta["number_of_frames"] == int(ref[name]["count"])
    assert meta["resolution"] == {"width": ref[name]["width"],
                                  "height": ref[name]["height"]} \
        == {"width": 200, "height": 120}
    it, jit = build_video_iterator(path), Cv2VideoIterator(path)
    assert (it.fps, it.frame_count, it.rotation) == (
        jit.fps, jit.frame_count, jit.rotation)
    assert video.decodable() == (8, "4:2:0")


# -- what raises --------------------------------------------------------------

@pytest.mark.parametrize("name", STREAMS)
def test_cpu_decode_raises_naming_the_codec_and_nvdec(name):
    path = fixture(name)
    codec = FORMATS[name]
    for decode in (lambda: list(video_frames(path)),
                   lambda: FrameReader(path)[0],
                   lambda: list(build_video_iterator(path))):
        with pytest.raises(NotImplementedError, match=re.escape(codec)) \
                as err:
            decode()
        assert "NVDEC" in str(err.value)


def no_driver(monkeypatch):
    """Any NVDEC call fails the test: a format check must come first."""
    def called(*a, **k):
        raise AssertionError("NVDEC was called")
    monkeypatch.setattr(nvdec, "Session", called)
    monkeypatch.setattr(nvdec, "library", called)


def caps_query(monkeypatch) -> list:
    """``cuvidGetDecoderCaps`` stood in: each query recorded, each answered
    "not supported" (so a session raises right after it); the card's name
    stood in."""
    calls = []

    def caps(codec, device, depth=8, chroma="4:2:0"):
        calls.append((codec, depth, chroma))
        return dict(supported=0, output_format_mask=0)
    monkeypatch.setattr(nvdec, "library", lambda: None)
    monkeypatch.setattr(nvdec, "decoder_caps", caps)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    return calls


def reaches_the_caps(monkeypatch, video, codec, what):
    """On a card device the session asks the caps at the stream's own
    depth and chroma (``what``) and raises naming them and the card; on
    the CPU it raises naming NVDEC, with no query."""
    calls = caps_query(monkeypatch)
    with pytest.raises(NotImplementedError) as err:
        video.session("cuda:0")
    depth, chroma = what.split("-bit ")
    assert calls == [(codec, int(depth), chroma)]
    assert f"{what} {codec}" in str(err.value)
    assert "NVIDIA H100 80GB HBM3" in str(err.value)
    with pytest.raises(NotImplementedError, match="NVDEC"):
        video.session("cpu")
    assert len(calls) == 1


def ue(v: int) -> str:
    bits = bin(v + 1)[2:]
    return "0" * (len(bits) - 1) + bits


def escape(rbsp: bytes) -> bytes:
    """Emulation prevention: a 3 after each 00 00 that precedes 0-3."""
    out, zeros = bytearray(), 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def deeper_sps(sps: bytes, depth: int) -> bytes:
    """An HEVC SPS NAL unit with its luma and chroma bit depths set to
    ``depth``: the bits before them kept, the rest after them kept."""
    r = codecs.BitReader(codecs.unescape(sps[2:]))
    r.u(4)
    sub = r.u(3)
    r.u(1)
    codecs._hevc_profile_tier_level(r, sub)
    r.ue()
    chroma = r.ue()
    if chroma == 3:
        r.u(1)
    r.ue(), r.ue()
    if r.u(1):
        for _ in range(4):
            r.ue()
    head = r.pos
    r.ue(), r.ue()
    bits = "".join(f"{b:08b}" for b in r.data)
    new = bits[:head] + ue(depth - 8) * 2 + bits[r.pos:]
    new += "0" * (-len(new) % 8)
    return sps[:2] + escape(int(new, 2).to_bytes(len(new) // 8, "big"))


def test_ten_bit_hevc_raises_before_the_driver(tmp_path, monkeypatch):
    src = container.open_video(fixture("hevc_small.mkv"))
    units = codecs.nal_units(src.header, 0)
    sps = next(u for u in units if codecs.nal_type("HEVC", u) == 33)
    assert codecs.hevc_sps_format(sps) == (8, "4:2:0")
    ten = deeper_sps(sps, 10)
    assert codecs.hevc_sps_format(ten) == (10, "4:2:0")
    units = [ten if u == sps else u for u in units]
    path = str(tmp_path / "ten.mkv")
    fx.write_mkv(path, "V_MPEGH/ISO/HEVC", fx.hvcc_record(units, True),
                 fx.demuxed(fixture("hevc_small.mkv")))
    video = container.open_video(path)
    assert video.decodable() == (10, "4:2:0")
    reaches_the_caps(monkeypatch, video, "HEVC", "10-bit 4:2:0")
    with pytest.raises(NotImplementedError, match="10-bit 4:2:0 HEVC"):
        list(video_frames(path, "cuda:0"))


def patched(tmp_path, name, at, mask, out):
    data = bytearray(open(fixture(name), "rb").read())
    data[at] |= mask
    path = str(tmp_path / out)
    with open(path, "wb") as f:
        f.write(bytes(data))
    return path


@pytest.mark.parametrize("name", ["vp9_small.webm", "vp9_small.mp4"])
def test_ten_bit_vp9_raises_before_the_driver(tmp_path, monkeypatch, name):
    """Profile 2 in the key frame's header (the WebM), or a bit depth of 10
    in ``vpcC`` (the MP4)."""
    video = container.open_video(fixture(name))
    if name.endswith(".webm"):
        at = video.spans[0][0]
        assert codecs.vp9_header(video.packet(0))["profile"] == 0
        path = patched(tmp_path, name, at, 0x10, "p2.webm")  # profile_high
    else:
        data = open(fixture(name), "rb").read()
        at = data.index(b"vpcC") + 4 + 6
        assert data[at] >> 4 == 8
        path = patched(tmp_path, name, at, 0x20, "ten.mp4")  # 8 | 2
    video = container.open_video(path)
    assert video.decodable() == (10, "4:2:0")
    reaches_the_caps(monkeypatch, video, "VP9", "10-bit 4:2:0")


@pytest.mark.parametrize("mask,what", [(0x40, "10-bit 4:2:0"),
                                       (0x10, "8-bit 4:0:0")])
def test_av1c_high_bitdepth_and_mono_chrome_raise(tmp_path, monkeypatch,
                                                  mask, what):
    data = open(fixture("av1_small.mkv"), "rb").read()
    at = data.index(bytes.fromhex("63a2")) + 3 + 2       # av1C's byte 2
    assert data[at - 2] == 0x81
    path = patched(tmp_path, "av1_small.mkv", at, mask, "av1.mkv")
    video = container.open_video(path)
    if what == "10-bit 4:2:0":
        reaches_the_caps(monkeypatch, video, "AV1", what)
        return
    no_driver(monkeypatch)                  # 4:0:0: before the driver
    for device in ("cuda:0", "cpu"):
        with pytest.raises(NotImplementedError, match=f"{what} AV1"):
            video.session(device)


@pytest.mark.parametrize("codec", ["VP8", "AV1", "HEVC", "VP9"])
def test_unsupported_caps_raise_naming_the_codec_and_the_card(monkeypatch,
                                                              codec):
    monkeypatch.setattr(nvdec, "library", lambda: None)
    monkeypatch.setattr(nvdec, "decoder_caps",
                        lambda c, d, depth, chroma: dict(
                            supported=0, max_width=0, output_format_mask=0))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    with pytest.raises(NotImplementedError) as err:
        nvdec.Session(codec, "cuda:0", "clip")
    assert f"does not decode 8-bit 4:2:0 {codec}" in str(err.value)
    assert "NVIDIA H100 80GB HBM3" in str(err.value)


def test_nvdec_codec_ids_agree_with_nvdec_cu():
    assert nvdec.CODEC_IDS == {"MPEG-4 Part 2": 2, "H.264": 4, "HEVC": 8,
                               "VP8": 9, "VP9": 10, "AV1": 11}
    src = open(os.path.join(os.path.dirname(nvdec.__file__),
                            "nvdec.cu")).read()
    enum = dict((k, int(v)) for k, v in re.findall(r"kCodec(\w+) = (\d+)",
                                                   src))
    names = {"MPEG4": "MPEG-4 Part 2", "H264": "H.264", "HEVC": "HEVC",
             "VP8": "VP8", "VP9": "VP9", "AV1": "AV1"}
    assert {names[k]: v for k, v in enum.items()} == nvdec.CODEC_IDS
    assert set(nvdec.CODEC_IDS) == {container.H264, container.HEVC,
                                    container.MPEG4, container.VP8,
                                    container.VP9, container.AV1}


def test_av1_temporal_units_get_their_delimiter_and_header():
    video = container.open_video(fixture("av1_small.mp4"))
    first = video.stream_packet(video.packet(0), 0, True)
    later = video.stream_packet(video.packet(1), 1, False)
    assert first.startswith(codecs.TEMPORAL_DELIMITER + video.header)
    assert later.startswith(codecs.TEMPORAL_DELIMITER)
    assert [k for k, _, _ in codecs.obus(later)].count(
        codecs.OBU_SEQUENCE_HEADER) == 0
    assert codecs.av1_temporal_unit(first, b"") == first   # no second TD
