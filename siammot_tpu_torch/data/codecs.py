"""What the port reads in a video stream's own headers, before any decoder
sees it: which packets are keyframes (a decoder may start there) and the
stream's bit depth and chroma format (the port's NVDEC route decodes 8-,
10- and 12-bit 4:2:0 and 4:4:4 HEVC, VP9 and AV1, and 8-bit 4:2:0 of the
others).

  * H.264 and HEVC: NAL units (Annex B, or length-prefixed as MP4 and
    Matroska store them).  A keyframe holds an IDR slice (H.264, NAL type
    5) or an IRAP picture (HEVC, NAL types 16-23: BLA, IDR and CRA); the
    bit depth and chroma format come from the sequence parameter set.
  * VP8: the frame tag's ``frame_type`` bit (0: a key frame); always 8-bit
    4:2:0.  A frame tag's ``show_frame`` bit 0 marks a hidden frame.
  * VP9: the uncompressed header of the packet's first frame (a
    superframe's index at the end of the packet gives each frame's size):
    ``frame_marker``, profile, ``show_existing_frame``, ``frame_type``;
    a key frame's ``color_config`` gives the bit depth (profiles 2 and 3:
    10 or 12) and the subsampling (profiles 1 and 3: not 4:2:0).
  * AV1: low-overhead OBUs (a temporal unit a packet).  The sequence
    header (``av1C``'s configOBUs, or in band) gives
    ``reduced_still_picture_header``; the first frame header OBU of the
    packet gives ``show_existing_frame``, ``frame_type`` and
    ``show_frame`` (a keyframe: a shown KEY_FRAME).  ``av1C``'s own
    bytes give ``high_bitdepth``, ``twelve_bit``, ``mono_chrome`` and the
    subsampling.
"""

from __future__ import annotations

import re

H264, HEVC, VP8, VP9, AV1 = "H.264", "HEVC", "VP8", "VP9", "AV1"
CHROMA = {0: "4:0:0", 1: "4:2:0", 2: "4:2:2", 3: "4:4:4"}


class BitReader:
    """MSB-first bits of ``data``; ``ue`` is an unsigned exp-Golomb code."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def u(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.pos >> 3
            if byte >= len(self.data):
                raise IOError("a header ends before its fields")
            v = v << 1 | (self.data[byte] >> (7 - (self.pos & 7))) & 1
            self.pos += 1
        return v

    def ue(self) -> int:
        zeros = 0
        while not self.u(1):
            zeros += 1
            if zeros > 31:
                raise IOError("an exp-Golomb code longer than 32 bits")
        return (1 << zeros) - 1 + self.u(zeros)


def unescape(nal: bytes) -> bytes:
    """A NAL unit's payload without its emulation-prevention bytes (the 3
    of each 00 00 03)."""
    return re.sub(b"\0\0\3", b"\0\0", nal)


def nal_units(sample: bytes, nal_length: int) -> list:
    """The NAL units of a sample: length-prefixed (``nal_length`` bytes a
    length) or, with ``nal_length`` 0, an Annex B byte stream."""
    out, n = [], len(sample)
    if nal_length:
        pos = 0
        while pos + nal_length <= n:
            size = int.from_bytes(sample[pos:pos + nal_length], "big")
            pos += nal_length
            out.append(sample[pos:pos + size])
            pos += size
        return out
    starts = [m.end() for m in re.finditer(b"\0\0\1", sample)]
    for k, s in enumerate(starts):
        e = starts[k + 1] - 3 if k + 1 < len(starts) else n
        while k + 1 < len(starts) and e > s and sample[e - 1] == 0:
            e -= 1                              # a 4-byte start code's zero
        out.append(sample[s:e])
    return out


def nal_type(fmt: str, nal: bytes) -> int:
    if not nal:
        return -1
    return nal[0] & 0x1F if fmt == H264 else nal[0] >> 1 & 0x3F


# -- H.264 and HEVC sequence parameter sets ----------------------------------

H264_HIGH = {100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135}


def h264_sps_format(sps: bytes) -> tuple:
    """(bit depth, chroma format) of an H.264 SPS NAL unit."""
    r = BitReader(unescape(sps[1:]))
    profile = r.u(8)
    r.u(16)                             # constraint flags, level
    r.ue()                              # seq_parameter_set_id
    chroma, depth = 1, 8
    if profile in H264_HIGH:
        chroma = r.ue()
        if chroma == 3:
            r.u(1)                      # separate_colour_plane_flag
        depth = 8 + r.ue()
    return depth, CHROMA.get(chroma, str(chroma))


def _hevc_profile_tier_level(r: BitReader, sub_layers: int) -> None:
    r.u(8 + 32 + 48 + 8)                # general profile, flags, level
    present = [(r.u(1), r.u(1)) for _ in range(sub_layers)]
    if sub_layers:
        r.u(2 * (8 - sub_layers))       # reserved_zero_2bits
    for profile, level in present:
        r.u(88 * profile + 8 * level)


def hevc_sps_format(sps: bytes) -> tuple:
    """(bit depth, chroma format) of an HEVC SPS NAL unit (H.265 7.3.2.2)."""
    r = BitReader(unescape(sps[2:]))
    r.u(4)                              # sps_video_parameter_set_id
    sub_layers = r.u(3)                 # sps_max_sub_layers_minus1
    r.u(1)
    _hevc_profile_tier_level(r, sub_layers)
    r.ue()                              # sps_seq_parameter_set_id
    chroma = r.ue()
    if chroma == 3:
        r.u(1)                          # separate_colour_plane_flag
    r.ue(), r.ue()                      # the picture's width and height
    if r.u(1):                          # conformance_window_flag
        for _ in range(4):
            r.ue()
    return 8 + r.ue(), CHROMA.get(chroma, str(chroma))


def hvcc(data: bytes) -> tuple:
    """(parameter sets as Annex B, NAL length size) of an ``hvcC`` body
    (ISO/IEC 14496-15 8.3.3): its arrays' NAL units in their order."""
    if len(data) < 23:
        raise IOError("an hvcC record shorter than 23 bytes")
    length = (data[21] & 3) + 1
    pos, units = 23, []
    for _ in range(data[22]):
        count = int.from_bytes(data[pos + 1:pos + 3], "big")
        pos += 3
        for _ in range(count):
            n = int.from_bytes(data[pos:pos + 2], "big")
            units.append(b"\0\0\0\1" + bytes(data[pos + 2:pos + 2 + n]))
            pos += 2 + n
    return b"".join(units), length


# -- VP8 and VP9 ------------------------------------------------------------

def vp9_frames(packet: bytes) -> list:
    """The frames of a VP9 packet: a superframe's (its index, the last
    ``2 + size bytes * frames`` bytes, framed by a marker byte 0b110xxxxx
    at both ends, gives their sizes), else the packet itself."""
    if not packet:
        return []
    marker = packet[-1]
    if marker & 0xE0 == 0xC0:
        n, size = (marker & 7) + 1, (marker >> 3 & 3) + 1
        index = 2 + size * n
        if len(packet) >= index and packet[-index] == marker:
            out, pos = [], 0
            for k in range(n):
                at = len(packet) - index + 1 + k * size
                length = int.from_bytes(packet[at:at + size], "little")
                out.append(packet[pos:pos + length])
                pos += length
            return out
    return [packet]


def vp9_header(frame: bytes) -> dict:
    """The start of a VP9 frame's uncompressed header (VP9 6.2):
    ``profile``, ``show_existing``, ``key``, ``show`` and, for a key
    frame, ``depth`` and ``chroma``."""
    r = BitReader(frame)
    if r.u(2) != 2:
        raise IOError("a VP9 frame without its frame_marker")
    low = r.u(1)
    profile = r.u(1) << 1 | low
    if profile == 3:
        r.u(1)
    out = dict(profile=profile, show_existing=bool(r.u(1)), key=False,
               show=True)
    if out["show_existing"]:
        return out
    key = r.u(1) == 0
    out.update(key=key, show=bool(r.u(1)))
    if key:
        r.u(1)                                  # error_resilient_mode
        if r.u(24) != 0x498342:
            raise IOError("a VP9 key frame without its sync code")
        depth = 8 if profile < 2 else (12 if r.u(1) else 10)
        chroma = "4:2:0"
        if r.u(3) != 7:                         # color_space: not sRGB
            r.u(1)                              # color_range
            if profile in (1, 3):
                sx, sy = r.u(1), r.u(1)
                chroma = {(1, 1): "4:2:0", (1, 0): "4:2:2",
                          (0, 1): "4:4:0", (0, 0): "4:4:4"}[(sx, sy)]
        elif profile in (1, 3):
            chroma = "4:4:4"
        else:
            raise IOError("a VP9 sRGB key frame in profile 0 or 2")
        out.update(depth=depth, chroma=chroma)
    return out


def vp8_header(frame: bytes) -> dict:
    """A VP8 frame tag (RFC 6386 9.1): ``key`` and ``show``."""
    if len(frame) < 3:
        raise IOError("a VP8 frame shorter than its frame tag")
    return dict(key=frame[0] & 1 == 0, show=bool(frame[0] >> 4 & 1))


# -- AV1 ---------------------------------------------------------------------

OBU_SEQUENCE_HEADER, OBU_TEMPORAL_DELIMITER = 1, 2
OBU_FRAME_HEADER, OBU_FRAME = 3, 6
TEMPORAL_DELIMITER = b"\x12\x00"


def leb128(data: bytes, pos: int) -> tuple:
    value = 0
    for i in range(8):
        if pos >= len(data):
            raise IOError("an AV1 size field runs past its packet")
        b = data[pos]
        pos += 1
        value |= (b & 0x7F) << (7 * i)
        if not b & 0x80:
            break
    return value, pos


def obus(data: bytes) -> list:
    """(type, whole OBU, payload) of each low-overhead OBU in ``data``
    (AV1 5.3; the last OBU may leave out its size field)."""
    out, pos = [], 0
    while pos < len(data):
        start = pos
        header = data[pos]
        kind = header >> 3 & 0xF
        pos += 1 + (header >> 2 & 1)            # obu_extension_flag
        if header & 2:                          # obu_has_size_field
            size, pos = leb128(data, pos)
        else:
            size = len(data) - pos
        if pos + size > len(data):
            raise IOError("an AV1 OBU runs past its packet")
        out.append((kind, data[start:pos + size], data[pos:pos + size]))
        pos += size
    return out


def av1c(data: bytes) -> dict:
    """An ``av1C`` body (AV1-ISOBMFF 2.3.3): ``depth``, ``chroma`` and
    ``obus``, the configOBUs (a sequence header OBU, where present)."""
    if len(data) < 4 or data[0] != 0x81:
        raise IOError("an av1C record without its marker and version 1")
    high, twelve, mono = data[2] >> 6 & 1, data[2] >> 5 & 1, data[2] >> 4 & 1
    sx, sy = data[2] >> 3 & 1, data[2] >> 2 & 1
    chroma = "4:0:0" if mono else {(1, 1): "4:2:0", (1, 0): "4:2:2",
                                   (0, 0): "4:4:4"}.get((sx, sy), "4:4:0")
    return dict(depth=12 if twelve else (10 if high else 8), chroma=chroma,
                obus=bytes(data[4:]))


def av1_reduced_still(sequence_header: bytes) -> bool:
    """``reduced_still_picture_header`` of a sequence header OBU payload."""
    return bool(sequence_header[0] >> 3 & 1)


def av1_header(packet: bytes, reduced_still: bool) -> dict:
    """The first frame header of an AV1 temporal unit (AV1 5.9.2):
    ``show_existing``, ``key`` and ``show``."""
    for kind, _, payload in obus(packet):
        if kind == OBU_SEQUENCE_HEADER:
            reduced_still = av1_reduced_still(payload)
        elif kind in (OBU_FRAME_HEADER, OBU_FRAME):
            if reduced_still:
                return dict(show_existing=False, key=True, show=True)
            r = BitReader(payload)
            if r.u(1):
                return dict(show_existing=True, key=False, show=True)
            key = r.u(2) == 0
            return dict(show_existing=False, key=key, show=bool(r.u(1)))
    raise IOError("an AV1 temporal unit without a frame header")


def av1_temporal_unit(packet: bytes, header: bytes) -> bytes:
    """A temporal unit as a decoder reads it in a stream: a temporal
    delimiter first (MP4 and Matroska leave it out), then ``header`` (the
    sequence header OBU, before a keyframe), then the packet's other
    OBUs."""
    body = b"".join(whole for kind, whole, _ in obus(packet)
                    if kind != OBU_TEMPORAL_DELIMITER)
    return TEMPORAL_DELIMITER + header + body
