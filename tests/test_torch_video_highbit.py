"""10- and 12-bit and 4:4:4 video in the port's readers
(``siammot_tpu_torch/data/container.py``, ``codecs.py`` and ``nvdec.py``),
on the CPU, against cv2 and the JAX package, over the fixtures ``python
tools/make_torch_highbit_fixtures.py`` writes into ``tests/fixtures/video``:
HEVC Main 10 (MP4) and Main 12 (MKV), HEVC 4:4:4 at 8 (MP4) and 10 bits
(MKV), VP9 profile 2 (WebM), and two lossless x265 sweeps of known planes.

NVDEC decodes these on the card only, into P016 and YUV444 surfaces, so
here:

* each clip's reference planes (x265's reconstruction, or libvpx's
  decoder's frames), laid out as NVDEC lays its surface (P016's samples in
  the top bits of 16-bit words, a pitch of 256 samples past the width,
  padding ignored), go through the plain conversion (the wrappers on a CPU
  tensor) to the JAX package's ``video_frames`` of the clip, bitwise, on
  every frame;
* the sweeps' planes, every code value of each plane and a quarter of
  seeded noise, go through the plain conversion to cv2's frames of the
  lossless streams, bitwise;
* the elementary streams the demuxer makes decode through cv2 to cv2's
  frames of the container;
* a session on a card device asks ``cuvidGetDecoderCaps`` for the stream's
  own codec, depth and chroma (the driver stood in), and raises naming
  them and the card where the answer is no; on the CPU it raises naming
  NVDEC;
* swscale's filters as ``nvdec.chroma_filters`` builds them, and the
  frames the conversions refuse.
"""

import hashlib
import json
import os
import struct

import cv2
import numpy as np
import pytest
import torch

from siammot_tpu.data.video_loader import video_frames as jax_video_frames
from siammot_tpu_torch.data import container, nvdec
from tools import make_torch_highbit_fixtures as fx

VIDEO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                     "video")
W, H = 200, 120
PITCH = 256                     # samples a row of the surfaces laid out here
CLIPS = sorted(fx.CLIPS)
SWEEPS = sorted(fx.SWEEPS)


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
    with open(os.path.join(VIDEO, "highbit_ref.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def planes():
    with np.load(os.path.join(VIDEO, "highbit_planes.npz")) as z:
        return {k: z[k] for k in z.files}


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


def surface(y, u, v, depth, full_chroma, pitch=PITCH):
    """Planes laid out as NVDEC's surface: P016 (the luma rows, then from
    ``chroma_row`` the interleaved Cb, Cr rows) or YUV444 (the three
    planes ``chroma_row`` rows apart), 16-bit words with the samples in
    their top bits above 8 bits, ``pitch`` samples a row, the padding
    0xA5."""
    h, w = y.shape
    wide = depth > 8
    dtype = np.uint16 if wide else np.uint8
    shift = (16 if wide else 8) - depth
    c0 = nvdec.chroma_row(h)
    rows = nvdec.yuv444_rows(h) if full_chroma else nvdec.nv12_rows(h)
    out = np.full((rows, pitch), 0xA5A5 if wide else 0xA5, dtype)
    if full_chroma:
        for k, p in enumerate((y, u, v)):
            out[k * c0:k * c0 + h, :w] = p.astype(np.int64) << shift
    else:
        out[:h, :w] = y.astype(np.int64) << shift
        uv = np.stack([u, v], -1).reshape(u.shape[0], -1).astype(np.int64)
        out[c0:c0 + uv.shape[0], :uv.shape[1]] = uv << shift
    return torch.from_numpy(out.view(np.int16) if wide else out)


def convert(frame, w, h, depth, full_chroma, siting):
    if full_chroma:
        return nvdec.yuv444_to_rgb(frame, w, h, depth)
    return nvdec.p016_to_rgb(frame, w, h, depth, siting)


# -- the conversions ----------------------------------------------------------

@pytest.mark.parametrize("name", CLIPS)
def test_plain_conversion_of_the_planes_is_jax_video_frames(name, ref,
                                                            planes):
    codec, depth, full = fx.CLIPS[name]
    key = fx.clip_key(name)
    ys, us, vs = planes[f"{key}_y"], planes[f"{key}_u"], planes[f"{key}_v"]
    jax = [sha(f) for f in jax_video_frames(fixture(name))]
    assert jax == ref[name]["sha256"] and len(jax) == len(ys) == fx.N
    launches = (nvdec.p016_to_rgb.launches, nvdec.yuv444_to_rgb.launches)
    for i in range(len(ys)):
        frame = surface(ys[i], us[i], vs[i], depth, full)
        got = convert(frame, W, H, depth, full, nvdec.CHROMA_SITING[codec])
        assert got.dtype == torch.uint8 and got.shape == (H, W, 3)
        assert sha(got.numpy()) == jax[i], f"{name} frame {i}"
    # a CPU tensor takes the plain version: no kernel launched
    assert launches == (nvdec.p016_to_rgb.launches,
                        nvdec.yuv444_to_rgb.launches)


@pytest.mark.parametrize("name", SWEEPS)
def test_plain_conversion_of_the_sweeps_is_cv2s_frames(name, ref):
    depth, full = fx.SWEEPS[name]
    want = cv2_rgb(fixture(name))
    made = fx.sweep_planes(depth, full)
    assert len(want) == len(made) == fx.SWEEP_N
    assert [sha(f) for f in want] == ref[name]["sha256"]
    for i, (f, (y, u, v)) in enumerate(zip(want, made)):
        codes = [np.unique(p).size for p in (y, u, v)]
        if i == 0:                       # the sweep: every code of a plane
            assert codes[0] == 1 << depth
        frame = surface(y, u, v, depth, full, pitch=fx.SWEEP_W + 8)
        got = convert(frame, fx.SWEEP_W, fx.SWEEP_H, depth, full,
                      nvdec.SITING_LEFT)
        np.testing.assert_array_equal(got.numpy(), f, err_msg=f"frame {i}")


def test_p016_siting_moves_the_chroma_as_swscale_does():
    """Left-sited chroma (HEVC) shifts each chroma column a quarter sample
    through the bicubic filter; centred chroma (VP9) takes the identity
    horizontally; both interpolate the rows."""
    hpos, hcoef, vpos, vcoef = nvdec.chroma_filters(W, H, nvdec.SITING_LEFT)
    assert hcoef.sum(1).tolist() == [1 << 14] * (W // 2)
    assert vcoef.sum(1).tolist() == [1 << 12] * H
    assert hcoef[W // 4].tolist() == [-1382, 14284, 3943, -461]
    assert vcoef[:4].tolist() == [[4432, -336, 0, 0], [3226, 985, -115, 0],
                                  [959, 3473, -336, 0],
                                  [-346, 3572, 985, -115]]
    assert (vpos >= 0).all() and (vpos + vcoef.shape[1] <= H // 2 + 2).all()
    hpos, hcoef, _, vc = nvdec.chroma_filters(W, H, nvdec.SITING_CENTER)
    weights = np.zeros((W // 2, W // 2 + hcoef.shape[1]), np.int64)
    for i, (at, row) in enumerate(zip(hpos, hcoef)):
        weights[i, at:at + len(row)] = row
    np.testing.assert_array_equal(weights[:, :W // 2],
                                  np.eye(W // 2, dtype=np.int64) << 14)
    np.testing.assert_array_equal(vc, vcoef)


def test_conversions_refuse_what_swscale_converts_otherwise():
    """Odd widths (each pixel its own chroma in swscale) and frames of
    fewer than 9 rows (a shorter vertical filter) take other swscale
    routes: refused, not converted differently."""
    c = np.zeros((H // 2, W // 2), np.uint16)
    frame = surface(np.zeros((H, W), np.uint16), c, c, 10, False)
    with pytest.raises(NotImplementedError, match="odd widths"):
        nvdec.p016_to_rgb(frame, W - 1, H, 10)
    with pytest.raises(NotImplementedError, match="8 rows high"):
        nvdec.p016_to_rgb(frame, W, 8, 10)
    assert nvdec.p016_to_rgb(frame, W, 9, 10).shape == (9, W, 3)
    with pytest.raises(ValueError, match="uint8 or 16-bit"):
        nvdec.yuv444_to_rgb(frame.float(), W, H, 10)


# -- the streams --------------------------------------------------------------

def ivf(video, packets) -> bytes:
    head = b"DKIF" + struct.pack("<HH4sHHIIII", 0, 32, b"VP90", video.width,
                                 video.height, 25, 1, len(packets), 0)
    return head + b"".join(struct.pack("<IQ", len(p), k) + p
                           for k, p in enumerate(packets))


@pytest.mark.parametrize("name", CLIPS)
def test_demuxed_stream_decodes_to_the_containers_frames(tmp_path, name,
                                                         ref):
    codec, depth, full = fx.CLIPS[name]
    video = container.open_video(fixture(name))
    assert video.format == codec and video.frame_count == fx.N
    assert video.decodable() == (depth, "4:4:4" if full else "4:2:0")
    assert (ref[name]["depth"], ref[name]["chroma"]) == video.decodable()
    packets = [video.stream_packet(d, i, i == 0)
               for i, d in enumerate(video.packets())]
    path = tmp_path / ("s.ivf" if codec == "VP9" else "s.hevc")
    path.write_bytes(ivf(video, packets) if codec == "VP9"
                     else b"".join(packets))
    assert [sha(f) for f in cv2_rgb(path)] == ref[name]["sha256"]
    assert ref[name]["seek"] == list(range(fx.N))


def caps_stand_in(monkeypatch, answer):
    """``nvdec.decoder_caps`` stood in: records each query, answers
    ``answer``; the card's name stood in."""
    calls = []

    def caps(codec, device, depth=8, chroma="4:2:0"):
        calls.append((codec, torch.device(device).type, depth, chroma))
        return dict(answer)
    monkeypatch.setattr(nvdec, "library", lambda: None)
    monkeypatch.setattr(nvdec, "decoder_caps", caps)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    return calls


@pytest.mark.parametrize("name", CLIPS)
def test_caps_are_queried_at_the_streams_depth_and_chroma(monkeypatch, name):
    codec, depth, full = fx.CLIPS[name]
    chroma = "4:4:4" if full else "4:2:0"
    video = container.open_video(fixture(name))
    calls = caps_stand_in(monkeypatch, dict(supported=0,
                                            output_format_mask=0))
    with pytest.raises(NotImplementedError) as err:
        video.session("cuda:0")
    assert calls == [(codec, "cuda", depth, chroma)]
    assert f"{depth}-bit {chroma} {codec}" in str(err.value)
    assert "NVIDIA H100 80GB HBM3" in str(err.value)
    # supported, but not to the surface format the conversions take
    surface_format = nvdec.surface_format(chroma, depth)
    calls = caps_stand_in(monkeypatch, dict(
        supported=1, output_format_mask=0xF & ~(1 << surface_format)))
    with pytest.raises(NotImplementedError, match=f"surface format "
                       f"{surface_format}"):
        video.session("cuda:0")
    # on the CPU: NVDEC named, no query
    calls = caps_stand_in(monkeypatch, dict(supported=1,
                                            output_format_mask=0xF))
    with pytest.raises(NotImplementedError, match="NVDEC"):
        video.session("cpu")
    with pytest.raises(NotImplementedError, match="NVDEC"):
        video.frame(0, "cpu")
    assert calls == []


def test_surface_formats_agree_with_nvdec_cu():
    src = open(os.path.join(os.path.dirname(nvdec.__file__),
                            "nvdec.cu")).read()
    for name, value in (("NV12", nvdec.NV12), ("P016", nvdec.P016),
                        ("YUV444", nvdec.YUV444),
                        ("YUV444_16Bit", nvdec.YUV444_16BIT)):
        assert f"kSurface{name} = {value}" in src
    assert "kChroma420 = 1, kChroma444 = 3" in src
    assert nvdec.CHROMA_IDS == {"4:2:0": 1, "4:4:4": 3}
    assert [nvdec.surface_format(c, d) for c, d in (
        ("4:2:0", 8), ("4:2:0", 10), ("4:2:0", 12), ("4:4:4", 8),
        ("4:4:4", 10), ("4:4:4", 12))] == [0, 1, 1, 2, 3, 3]
