"""Video files for the port, without ``cv2`` or FFmpeg: a demuxer for AVI
and ISO BMFF (MP4, MOV) that hands each frame's packet to a decoder on the
route of the device (Matroska and WebM: ``data/matroska.py``, into the same
:class:`Video`):

  * Motion JPEG, where every packet is a JPEG image: the port's JPEG
    decoder (``data/native.py``: libjpeg on the CPU, nvJPEG on the card).
  * H.264, HEVC, MPEG-4 Part 2 (Visual), VP8, VP9 and AV1: NVIDIA's
    hardware decoder on the card (``data/nvdec.py``), fed the elementary
    stream this module makes from the samples: HEVC, VP9 and AV1 at 8, 10
    or 12 bits, 4:2:0 or 4:4:4, the others at 8-bit 4:2:0 only (the
    stream's own headers say, ``data/codecs.py``; any other raises before
    a decoder opens).  The port has no CPU decoder for them: a decode on
    the CPU raises ``NotImplementedError`` naming the codec and NVDEC.

The containers:

  * AVI (RIFF ``AVI ``): ``avih`` and the video stream's ``strh`` and
    ``strf`` give the rate, frame count and size; the packets are the
    stream's ``##dc``/``##db`` chunks of ``movi``, in ``idx1`` order where
    that index is there (and the file holds one RIFF), else in file order
    over every ``movi`` list; the keyframes are ``idx1``'s
    ``AVIIF_KEYFRAME`` entries (without ``idx1``: the packets that hold an
    IDR slice or an I-VOP).  Codec: ``strf``'s ``biCompression`` against
    the fourccs FFmpeg's ``riff.c`` maps to its MJPEG, H.264 and MPEG-4
    decoders.  H.264 comes as Annex B with its parameter sets in band;
    an MPEG-4 ``strf`` may carry the VOL header after its 40 bytes.
  * MP4 and MOV: the first video track's ``stsd``, ``stsz``, ``stsc``,
    ``stco``/``co64`` and ``stts`` give the packets and their durations,
    ``mdhd`` the timescale, ``tkhd``'s display matrix the rotation (0, 90,
    180 or 270, as FFmpeg's ``av_display_rotation_get`` reads it),
    ``stss`` the sync samples, ``ctts`` the display order and ``elst``'s
    first edit which frames show (composition times in [media time,
    media time + duration), as FFmpeg's mov demuxer drops the rest).
    Codecs: the ``jpeg``, ``mjpa`` and ``mjpb`` sample entries (a Motion
    JPEG format B field, whose segments carry no markers and whose scan
    no stuffed bytes, is rebuilt as a JPEG stream first:
    :func:`mjpeg_b_to_jpeg`), ``mp4v`` whose ``esds`` object type is
    0x6C (JPEG, how FFmpeg, and so ``cv2.VideoWriter``, stores MJPEG in an
    MP4) or 0x20 (MPEG-4 Part 2: the DecoderSpecificInfo holds the VOL
    header), ``avc1``/``avc3`` (H.264: ``avcC`` gives the parameter
    sets and the NAL length size; each sample's length-prefixed NAL units
    become Annex B, and each sync sample is prefixed with the parameter
    sets), ``hvc1``/``hev1`` (HEVC: the same from ``hvcC``'s arrays, VPS,
    SPS and PPS), ``vp09`` (VP9: a sample a packet, a superframe whole)
    and ``av01`` (AV1: each temporal unit gets its temporal delimiter
    back, and ``av1C``'s sequence header OBU goes before each sync
    sample).  For HEVC, VP9 and AV1 a sync sample must also be a keyframe
    by its own header.

Frames come in display order and seek by :func:`seek_plan`: decoding
starts at the sync sample at or before the frame wanted and runs forward
until it comes out.  Any other codec (MPEG-2, ProRes, MPEG-4 Part 2 with
DivX packed B-frames, ...) raises ``NotImplementedError`` naming it.  Some
MJPEG packets leave out their Huffman tables (DHT) and rely on the
standard ones (JPEG Annex K.3, which libjpeg would also assume);
:func:`with_huffman_tables` inserts them before decoding, so nvJPEG reads
such packets too.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import mmap
import re
import struct
import threading

import numpy as np
import torch

from . import codecs, native, nvdec

# fourccs FFmpeg's AVI demuxer maps to its MJPEG decoder (libavformat
# riff.c), upper-cased
AVI_MJPEG = {"MJPG", "AVRN", "ACDV", "QIVG", "SLMJ", "CJPG", "IJPG", "AVMJ",
             "AVI1", "AVI2", "MTSJ", "ZJPG", "MMJP", "DMB1", "MJPA", "JPEG"}
# fourccs FFmpeg's AVI demuxer maps to its H.264 and MPEG-4 Part 2
# decoders (riff.c), upper-cased
AVI_H264 = {"H264", "X264", "AVC1", "DAVC", "SMV2", "VSSH", "Q264", "V264",
            "GAVC", "UMSV", "TSHD", "INMC"}
AVI_MPEG4 = {"FMP4", "DIVX", "DX50", "XVID", "MP4S", "M4S2", "ZMP4", "DIV1",
             "BLZ0", "MP4V", "UMP4", "WV1F", "SEDG", "RMP4",
             "3IV2", "WAWV", "FFDS", "FVFW", "DCOD", "MVXM", "PM4V", "SMP4",
             "DXGM", "VIDM", "M4T3", "GEOX", "G264", "HDX4", "DM4V", "DMK2",
             "DIGI", "EPHV", "EM4A", "M4CC", "SN40", "VSPX", "ULDX", "GEOV",
             "SIPP", "SM4V", "XVIX", "DREX", "QMP4", "PLV1", "GLV4", "GMP4",
             "MNM4", "GTM4"}
MP4_MJPEG = {"jpeg", "mjpa", "mjpb"}
MP4_H264 = {"avc1", "avc3"}
MP4_HEVC = {"hvc1", "hev1"}
OBJECT_JPEG = 0x6C
OBJECT_MPEG4 = 0x20
MJPEG, MPEG4 = "MJPEG", "MPEG-4 Part 2"
H264, HEVC, VP8, VP9, AV1 = (codecs.H264, codecs.HEVC, codecs.VP8,
                             codecs.VP9, codecs.AV1)
OBJECT_TYPES = {0x20: "MPEG-4 Part 2 (Visual)", 0x21: "H.264", 0x23: "HEVC",
                0x60: "MPEG-2 Video", 0x61: "MPEG-2 Video",
                0x6A: "MPEG-1 Video", 0x6C: "JPEG", 0x6D: "PNG",
                0x6E: "JPEG 2000"}
CODEC_NAMES = {"mp2v": "MPEG-2 Video", "apcn": "ProRes", "apch": "ProRes",
               "V_MPEG2": "MPEG-2 Video", "V_MPEG1": "MPEG-1 Video",
               "V_THEORA": "Theora", "V_PRORES": "ProRes", "V_FFV1": "FFV1",
               "V_UNCOMPRESSED": "uncompressed video", "V_REAL/RV40":
               "RealVideo 4", "HEVC": "HEVC", "H265": "HEVC"}


def no_decoder(path: str, codec: str) -> NotImplementedError:
    name = CODEC_NAMES.get(codec.strip(), "")
    return NotImplementedError(
        f"{path}: codec {codec!r}{' (' + name + ')' if name else ''}: the "
        f"port decodes Motion JPEG (libjpeg on the CPU, nvJPEG on the card), "
        f"H.264, HEVC, MPEG-4 Part 2, VP8, VP9 and AV1 (NVDEC on the card); "
        f"the card's machine has no decoder for other codecs")


# the formats NVDEC decodes past 8-bit 4:2:0, and the (bit depth, chroma
# format) pairs it takes of them (to NV12, P016 or YUV444 surfaces)
HIGH_BIT_FORMATS = (HEVC, VP9, AV1)
DECODABLE = {(d, c) for d in (8, 10, 12) for c in ("4:2:0", "4:4:4")}


def not_decodable(path: str, fmt: str, depth: int,
                  chroma: str) -> NotImplementedError:
    which = ("8-, 10- or 12-bit 4:2:0 or 4:4:4" if fmt in HIGH_BIT_FORMATS
             else "8-bit 4:2:0 only")
    return NotImplementedError(
        f"{path}: a {depth}-bit {chroma} {fmt} stream: the port decodes "
        f"{fmt} through NVDEC at {which} (NV12, P016 and YUV444 surfaces "
        f"and their conversions to RGB); this stream is {depth}-bit and "
        f"{chroma}")


def no_cpu_decoder(path: str, fmt: str, codec: str) -> NotImplementedError:
    return NotImplementedError(
        f"{path}: {fmt} ({codec!r}) decodes on the card only, through "
        f"NVIDIA's video decoder (NVDEC); the port has no CPU decoder for "
        f"it: pass a CUDA device")


# -- the standard Huffman tables (JPEG Annex K.3) -------------------------

def _dht(table_class: int, table_id: int, bits, values) -> bytes:
    return bytes([table_class << 4 | table_id, *bits, *values])


_AC_LUMA = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9"
    "fa")
_AC_CHROMA = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")
_TABLES = b"".join((
    _dht(0, 0, (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), range(12)),
    _dht(1, 0, (0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D),
         _AC_LUMA),
    _dht(0, 1, (0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), range(12)),
    _dht(1, 1, (0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77),
         _AC_CHROMA)))
STANDARD_DHT = b"\xff\xc4" + struct.pack(">H", 2 + len(_TABLES)) + _TABLES


def with_huffman_tables(packet: bytes) -> bytes:
    """``packet`` with the standard DHT segment inserted before its first
    scan if no DHT comes before it; else ``packet`` itself."""
    pos = 2
    while pos + 4 <= len(packet):
        if packet[pos] != 0xFF:
            break
        marker = packet[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker == 0xC4:
            return packet
        if marker == 0xDA:
            return packet[:pos] + STANDARD_DHT + packet[pos:]
        if marker == 0x01 or 0xD0 <= marker <= 0xD8:
            pos += 2
            continue
        pos += 2 + struct.unpack(">H", packet[pos + 2:pos + 4])[0]
    raise IOError("a video packet is not a JPEG image (no start of scan)")


def mjpeg_b_to_jpeg(field: bytes) -> bytes:
    """A Motion JPEG format B field (QuickTime's ``mjpb``) as a JPEG
    stream.  The field starts with a 40-byte header: 4 zero bytes,
    ``mjpg``, the field size, its padded size, the second field's offset,
    then the offsets of the DQT, DHT, SOF and SOS segments (each a 2-byte
    length and a body, no marker; 0 where absent) and of the scan data,
    which is not byte-stuffed.  A second field (an interlaced frame) is
    not decoded."""
    if len(field) < 40 or field[4:8] != b"mjpg":
        raise IOError("an mjpb packet without its 'mjpg' header")
    size, _, _, dqt, dht, sof, sos, sod = struct.unpack(">8I", field[8:40])
    out = [b"\xff\xd8"]
    for marker, at in ((0xDB, dqt), (0xC4, dht), (0xC0, sof), (0xDA, sos)):
        if at:
            n, = struct.unpack(">H", field[at:at + 2])
            out.append(bytes([0xFF, marker]) + field[at:at + n])
    end = min(size, len(field)) if size else len(field)
    out.append(field[sod:end].replace(b"\xff", b"\xff\x00"))
    out.append(b"\xff\xd9")
    return b"".join(out)


# -- elementary streams and the seek plan ---------------------------------

def annexb(sample: bytes, nal_length: int) -> bytes:
    """A sample of length-prefixed NAL units (``nal_length`` bytes each
    length, as ``avcC`` says) as an Annex B byte stream."""
    out, pos, n = [], 0, len(sample)
    while pos + nal_length <= n:
        size = int.from_bytes(sample[pos:pos + nal_length], "big")
        pos += nal_length
        if pos + size > n:
            raise IOError("a NAL unit runs past its sample")
        out.append(b"\0\0\0\1" + sample[pos:pos + size])
        pos += size
    return b"".join(out)


def seek_plan(sync, rank, target: int) -> tuple:
    """Where decoding starts to give the frame of display rank ``target``:
    ``(start, skip)``, the sync sample (a decode index of ``sync``) of the
    highest display rank at or before ``target`` (``rank[i]``: sample i's
    display rank), and how many frames come out before the one wanted.  A
    decoder fed the samples from ``start`` on gives the frames of display
    rank ``rank[start]``, ``rank[start] + 1``, ... (the GOPs are closed)."""
    best = None
    for s in sync:
        if rank[s] <= target and (best is None or rank[s] >= rank[best]):
            best = s
    if best is None:
        raise IOError(f"no sync sample at or before display rank {target}")
    return best, target - rank[best]


def _is_keyframe(fmt: str, packet: bytes, nal_length: int = 0,
                 reduced_still: bool = False) -> bool:
    """Whether a packet holds an IDR slice (H.264), an IRAP picture (HEVC,
    NAL types 16-23), an I-VOP (MPEG-4 Part 2), or a shown key frame (VP8,
    VP9, AV1) that starts it; NAL units length-prefixed (``nal_length``
    bytes) or, with 0, Annex B."""
    if fmt in (H264, HEVC):
        types = {codecs.nal_type(fmt, u)
                 for u in codecs.nal_units(packet, nal_length)}
        return 5 in types if fmt == H264 else bool(types & set(range(16, 24)))
    if fmt == VP8:
        return codecs.vp8_header(packet)["key"]
    if fmt == VP9:
        frames = codecs.vp9_frames(packet)
        return bool(frames) and codecs.vp9_header(frames[0])["key"]
    if fmt == AV1:
        h = codecs.av1_header(packet, reduced_still)
        return h["key"] and h["show"]
    i = packet.find(b"\0\0\1\xb6")
    return i >= 0 and i + 4 < len(packet) and packet[i + 4] >> 6 == 0


def _shows_frame(fmt: str, packet: bytes) -> bool:
    """Whether decoding a VP8 or VP9 packet outputs a frame: a hidden frame
    (an alt-ref stored alone) does not; every other packet does."""
    if fmt == VP8:
        return codecs.vp8_header(packet)["show"]
    if fmt == VP9:
        return any(h["show"] or h["show_existing"] for h in map(
            codecs.vp9_header, codecs.vp9_frames(packet)))
    return True


def stream_keys(path: str, fmt: str, read, n: int, keys,
                nal_length: int = 0, header: bytes = b""):
    """The sync packets of a stream of ``n`` packets (``read(i)``: packet
    i's bytes): those the container marks (``keys``, None: every packet)
    that, for HEVC, VP8, VP9 and AV1, are keyframes by their own headers;
    and the packets that output no frame (VP8 and VP9 only, whose every
    packet is read).  The packets are read one at a time."""
    reduced = False
    if fmt == AV1:
        for kind, _, payload in codecs.obus(header):
            if kind == codecs.OBU_SEQUENCE_HEADER:
                reduced = codecs.av1_reduced_still(payload)
    marked = range(n) if keys is None else sorted(keys)
    sync = [i for i in marked if fmt not in (HEVC, VP8, VP9, AV1)
            or _is_keyframe(fmt, read(i), nal_length, reduced)]
    hidden = {i for i in range(n) if not _shows_frame(fmt, read(i))} \
        if fmt in (VP8, VP9) else set()
    if not sync:
        raise IOError(f"{path}: no keyframe in the {fmt} stream")
    return sync, hidden


_DIVX = re.compile(rb"DivX(\d+)(?:Build|b)(\d+)(p?)")


class _Seek:
    """A session of :meth:`Video.frame`: where it stands in the stream."""

    def __init__(self, session, device, start, rank):
        self.session, self.device = session, device
        self.first = self.next_packet = start
        self.next_rank = rank           # of the next frame out
        self.last = rank - 1            # the rank of the last frame given
        self.pending = []               # frames out, not yet given
        self.ended = False


# -- the container -----------------------------------------------------------

class Video:
    """A demuxed video: ``fps``, ``frame_count``, ``width``, ``height``,
    ``rotation`` (degrees, 0/90/180/270), ``codec`` (the fourcc, sample
    entry or Matroska CodecID) and ``format`` (``MJPEG``, ``H.264``,
    ``HEVC``, ``MPEG-4 Part 2``, ``VP8``, ``VP9`` or ``AV1``); the packets
    in decode order (random access) as (file offset, size); ``sync``, the
    decode indices of the sync samples; ``order``, the decode indices in
    display order (None: the decode order); ``shown``, the display ranks
    of the frames the video shows (None: all); ``hidden``, the decode
    indices of packets that output no frame (a VP8 or VP9 alt-ref stored
    alone; they have no display rank); ``header``, the parameter sets
    (H.264, HEVC: Annex B), the VOL header (MPEG-4) or the sequence header
    OBU (AV1) that start a stream; ``nal_length``, the NAL length size of
    length-prefixed samples (0: Annex B); ``stream_format``, (bit depth,
    chroma format) where the container says (``vpcC``, ``av1C``), else
    read from the stream by :meth:`decodable`; ``frame_total``,
    ``CAP_PROP_FRAME_COUNT`` where it is not the packet count (Matroska's
    estimate); ``prefix``, bytes a container strips from every packet
    (Matroska's header stripping), put back as each packet is read."""

    def __init__(self, path: str, fps: float, width: int, height: int,
                 rotation: int, codec: str, spans: list, fmt: str = MJPEG,
                 sync=None, order=None, shown=None, header: bytes = b"",
                 nal_length: int = 0, hidden=(), stream_format=None,
                 frame_total=None, prefix: bytes = b""):
        self.path = path
        self.fps = fps
        self.width = width
        self.height = height
        self.rotation = rotation
        self.codec = codec
        self.spans = spans
        self.format = fmt
        self.sync = list(range(len(spans))) if sync is None else list(sync)
        self.order = order
        self.shown = shown
        self.hidden = set(hidden)
        self.header = header
        self.nal_length = nal_length
        self.stream_format = stream_format
        self.frame_total = frame_total
        self.prefix = prefix
        self._sync_set = set(self.sync)
        self._rank = None
        self._seek = None               # frame()'s session, one at a time
        self._seek_lock = threading.Lock()

    @property
    def frame_count(self) -> int:
        return len(self.spans) - len(self.hidden) if self.shown is None \
            else len(self.shown)

    def rank(self) -> list:
        """Each decode index's display rank (None: a hidden packet)."""
        if self._rank is None:
            self._rank = [None] * len(self.spans)
            order = range(len(self.spans)) if self.order is None \
                else self.order
            r = 0
            for i in order:
                if i not in self.hidden:
                    self._rank[i] = r
                    r += 1
        return self._rank

    def shown_rank(self, idx: int) -> int:
        """The display rank of frame ``idx`` (among the frames shown)."""
        return idx if self.shown is None else self.shown[idx]

    def plan(self, idx: int) -> tuple:
        """:func:`seek_plan` of frame ``idx``: ``(start, skip)``."""
        if not 0 <= idx < self.frame_count:
            raise IOError(f"{self.path}: no frame {idx} of "
                          f"{self.frame_count}")
        return seek_plan(self.sync, self.rank(), self.shown_rank(idx))

    def _read(self, f, idx: int) -> bytes:
        offset, size = self.spans[idx]
        f.seek(offset)
        data = f.read(size)
        if len(data) != size:
            raise IOError(f"{self.path}: packet {idx} ends past the file")
        return self.prefix + data if self.prefix else data

    def packet(self, idx: int) -> bytes:
        with open(self.path, "rb") as f:
            return self._read(f, idx)

    def packets(self, start: int = 0):
        with open(self.path, "rb") as f:
            for idx in range(start, len(self.spans)):
                yield self._read(f, idx)

    def stream_packet(self, data: bytes, idx: int, first: bool) -> bytes:
        """Packet ``idx`` as the elementary stream carries it: H.264 and
        HEVC as Annex B, a sync sample (or the ``first`` packet fed)
        prefixed with the parameter sets; the ``first`` MPEG-4 packet
        prefixed with the VOL header; an AV1 temporal unit with its
        temporal delimiter, and the sequence header before a sync sample
        or the ``first`` packet; VP8 and VP9 as stored."""
        key = first or idx in self._sync_set
        if self.format in (H264, HEVC):
            if self.nal_length:
                data = annexb(data, self.nal_length)
            if key:
                data = self.header + data
        elif self.format == MPEG4 and first:
            data = self.header + data
        elif self.format == AV1:
            data = codecs.av1_temporal_unit(data, self.header if key
                                            else b"")
        return data

    def decodable(self) -> tuple:
        """(bit depth, chroma format) of the stream, from the container's
        record or the stream's own headers; raises where the port's NVDEC
        route cannot decode it, before a session opens: HEVC, VP9 and AV1
        at 8, 10 or 12 bits, 4:2:0 or 4:4:4, decode; H.264, MPEG-4 Part 2
        and VP8 at 8-bit 4:2:0 only; 4:0:0 and 4:2:2 nowhere."""
        if self.stream_format is None:
            self.stream_format = self._read_format()
        depth, chroma = self.stream_format
        taken = DECODABLE if self.format in HIGH_BIT_FORMATS \
            else {(8, "4:2:0")}
        if (depth, chroma) not in taken:
            raise not_decodable(self.path, self.format, depth, chroma)
        return depth, chroma

    def _read_format(self) -> tuple:
        if self.format in (H264, HEVC):
            sps = 7 if self.format == H264 else 33
            read = codecs.h264_sps_format if self.format == H264 \
                else codecs.hevc_sps_format
            units = codecs.nal_units(self.header, 0)
            for idx in self.sync[:1]:
                units += codecs.nal_units(self.packet(idx), self.nal_length)
            for u in units:
                if codecs.nal_type(self.format, u) == sps:
                    return read(u)
            raise IOError(f"{self.path}: no {self.format} sequence parameter "
                          f"set before the first keyframe")
        if self.format == VP9:
            for idx in self.sync[:1]:
                h = codecs.vp9_header(codecs.vp9_frames(self.packet(idx))[0])
                return h["depth"], h["chroma"]
        if self.format == AV1:
            raise IOError(f"{self.path}: an AV1 track without av1C")
        # VP8, and MPEG-4 Part 2's Simple and Advanced Simple profiles
        return 8, "4:2:0"

    def elementary_stream(self, start: int = 0) -> bytes:
        """The elementary stream from packet ``start`` on (a ``.h264`` or
        ``.m4v`` file's bytes)."""
        return b"".join(self.stream_packet(d, i, i == start)
                        for i, d in enumerate(self.packets(start), start))

    def decode(self, packet: bytes, device="cpu", what=None) -> np.ndarray:
        """One MJPEG packet -> uint8 [h, w, 3] RGB as stored (no
        rotation)."""
        what = what or self.path
        if self.format != MJPEG:
            raise ValueError(f"{what}: {self.format} decodes as a stream "
                             f"(frames(), frame()), not a packet at a time")
        if self.codec == "mjpb":
            packet = mjpeg_b_to_jpeg(packet)
        img = native.decode_jpeg_bytes(with_huffman_tables(packet), device,
                                       what)
        if img.shape[:2] != (self.height, self.width):
            raise IOError(f"{what}: a {img.shape[1]}x{img.shape[0]} frame in "
                          f"a {self.width}x{self.height} stream (a packet of "
                          f"two interlaced fields?)")
        return img

    def session(self, device) -> nvdec.Session:
        """A new NVDEC session for this stream on ``device`` (a CUDA
        device; the CPU raises)."""
        depth, chroma = self.decodable()
        if torch.device(device).type != "cuda":
            raise no_cpu_decoder(self.path, self.format, self.codec)
        return nvdec.Session(self.format, device, self.path, depth, chroma)

    def _check_size(self, img: np.ndarray, what: str) -> np.ndarray:
        if img.shape[:2] != (self.height, self.width):
            raise IOError(f"{what}: NVDEC gives {img.shape[1]}x"
                          f"{img.shape[0]} frames in a {self.width}x"
                          f"{self.height} stream")
        return img

    def frame(self, idx: int, device="cpu") -> np.ndarray:
        """Frame ``idx`` (display order) as stored (no rotation).  A stream
        codec keeps one session a video and decodes forward when ``idx``
        comes after the last frame it gave and its sync sample has been
        fed; otherwise it starts again at :meth:`plan`'s sync sample."""
        if self.format == MJPEG:
            return self.decode(self.packet(idx), device,
                               f"{self.path} frame {idx}")
        with self._seek_lock:           # the loader's threads share a video
            return self._frame(idx, torch.device(device))

    def _frame(self, idx: int, device: torch.device) -> np.ndarray:
        start, _ = self.plan(idx)
        target = self.shown_rank(idx)
        st = self._seek
        if st is None or st.device != device or target <= st.last \
                or start >= st.next_packet:
            if st is not None:
                st.session.close()
            st = self._seek = _Seek(self.session(device), device, start,
                                    self.rank()[start])
        with open(self.path, "rb") as f:
            while True:
                while not st.pending:
                    if st.next_packet < len(self.spans):
                        i = st.next_packet
                        packet = self.stream_packet(self._read(f, i), i,
                                                    i == st.first)
                        st.next_packet += 1
                    elif not st.ended:
                        packet, st.ended = None, True
                    else:
                        raise IOError(f"{self.path}: the stream ended before "
                                      f"frame {idx}")
                    for img in st.session.feed(packet):
                        st.pending.append((st.next_rank, img))
                        st.next_rank += 1
                rank, img = st.pending.pop(0)
                if rank == target:
                    st.last = rank
                    return self._check_size(img, f"{self.path} frame {idx}")

    def frames(self, device="cpu"):
        """Yield every frame in display order, turned upright by the
        container's rotation (as OpenCV's FFmpeg backend turns them by
        default)."""
        if self.format == MJPEG:
            for i, data in enumerate(self.packets()):
                yield apply_rotation(
                    self.decode(data, device, f"{self.path} frame {i}"),
                    self.rotation)
            return
        session = self.session(device)
        shown = set(range(self.frame_count) if self.shown is None
                    else self.shown)
        rank = count = 0
        try:
            stream = (self.stream_packet(d, i, i == 0)
                      for i, d in enumerate(self.packets()))
            for packet in itertools.chain(stream, [None]):
                for img in session.feed(packet):
                    if rank in shown:
                        yield apply_rotation(self._check_size(
                            img, f"{self.path} frame {count}"),
                            self.rotation)
                        count += 1
                    rank += 1
        finally:
            session.close()
        if count != self.frame_count:
            raise IOError(f"{self.path}: NVDEC gave {count} frames of the "
                          f"{self.frame_count} the container holds")

    def metadata(self) -> dict:
        """The JAX package's ``video_metadata`` keys; the size upright.
        The frame count is ``CAP_PROP_FRAME_COUNT``'s: every sample, also
        those an edit list hides (which ``frames`` does not give, as
        ``cap.read()`` does not)."""
        w, h = (self.height, self.width) if self.rotation % 180 \
            else (self.width, self.height)
        count = len(self.spans) if self.frame_total is None \
            else self.frame_total
        return dict(fps=self.fps, number_of_frames=count,
                    resolution={"width": w, "height": h})


def apply_rotation(frame: np.ndarray, rotation: int) -> np.ndarray:
    """Turn a decoded frame upright: ``np.rot90(frame, k=(-(rotation //
    90)) % 4)``, a clockwise turn by ``rotation`` degrees (the JAX demo's
    rule, and OpenCV's automatic orientation)."""
    if rotation > 0:
        frame = np.ascontiguousarray(np.rot90(frame, k=(-(rotation // 90))
                                              % 4))
    return frame


def open_video(path: str) -> Video:
    """Demux ``path`` (AVI, MP4, MOV, Matroska or WebM, chosen by its first
    bytes, whatever the file's name)."""
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) == 12 and head[:4] == b"RIFF" \
                and head[8:12] == b"AVI ":
            demux = _open_avi
        elif len(head) == 12 and head[4:8] in (b"ftyp", b"moov", b"mdat",
                                                b"free", b"wide", b"skip"):
            demux = _open_mp4
        elif head[:4] == b"\x1a\x45\xdf\xa3":         # EBML
            from .matroska import open_matroska as demux
        else:
            raise NotImplementedError(
                f"{path}: not an AVI, MP4, MOV, Matroska or WebM file (first "
                f"bytes {head.hex()}); the port reads MJPEG, H.264, HEVC, "
                f"MPEG-4 Part 2, VP8, VP9 and AV1 in those containers")
        with contextlib.closing(mmap.mmap(f.fileno(), 0,
                                          access=mmap.ACCESS_READ)) as data:
            return demux(path, data)


# -- AVI ---------------------------------------------------------------------

def _riff_chunks(data, start, end):
    """Yield (fourcc, list type or None, body start, body end)."""
    pos = start
    while pos + 8 <= end:
        cc = data[pos:pos + 4]
        size, = struct.unpack("<I", data[pos + 4:pos + 8])
        body = pos + 8
        if cc in (b"RIFF", b"LIST"):
            yield cc, data[body:body + 4], body + 4, min(body + size, end)
        else:
            yield cc, None, body, min(body + size, end)
        pos = body + size + (size & 1)


def _open_avi(path: str, data) -> Video:
    n = len(data)
    riffs = [(s, e) for cc, kind, s, e in _riff_chunks(data, 0, n)
             if cc == b"RIFF" and kind in (b"AVI ", b"AVIX")]
    if not riffs:
        raise IOError(f"{path}: a truncated AVI file")
    first_s, first_e = riffs[0]
    stream, video, avih = 0, None, None
    movi, idx1 = [], None
    for cc, kind, s, e in _riff_chunks(data, first_s, first_e):
        if kind == b"hdrl":
            for cc2, kind2, s2, e2 in _riff_chunks(data, s, e):
                if cc2 == b"avih":
                    avih = struct.unpack("<10I", data[s2:s2 + 40])
                elif kind2 == b"strl":
                    strh = strf = None
                    for cc3, _, s3, e3 in _riff_chunks(data, s2, e2):
                        if cc3 == b"strh":
                            strh = bytes(data[s3:e3])
                        elif cc3 == b"strf":
                            strf = bytes(data[s3:e3])
                    if video is None and strh and strh[:4] == b"vids":
                        video = (stream, strh, strf)
                    stream += 1
        elif kind == b"movi":
            movi.append((s, e))
        elif cc == b"idx1":
            idx1 = (s, e)
    for s, e in riffs[1:]:
        movi += [(s2, e2) for _, kind, s2, e2 in _riff_chunks(data, s, e)
                 if kind == b"movi"]
    if video is None or not movi:
        raise IOError(f"{path}: an AVI file without a video stream or movi")
    index, strh, strf = video
    # the codec: strf's biCompression, as FFmpeg reads it
    codec = (strf[16:20] if strf and len(strf) >= 20 else strh[4:8]) \
        .decode("latin-1")
    fmt = {**dict.fromkeys(AVI_MJPEG, MJPEG), **dict.fromkeys(AVI_H264, H264),
           **dict.fromkeys(AVI_MPEG4, MPEG4)}.get(codec.upper())
    if fmt is None:
        raise no_decoder(path, codec)
    scale, rate = struct.unpack("<II", strh[20:28])
    if strf and len(strf) >= 12:
        width, height = struct.unpack("<ii", strf[4:12])
    else:
        width, height = avih[8], avih[9]
    ids = (f"{index:02d}dc".encode(), f"{index:02d}db".encode())
    spans = keys = None
    if idx1 is not None and len(riffs) == 1:
        spans, keys = _avi_index(data, idx1, movi[0][0] - 4, ids)
    if spans is None:
        spans = []
        for s, e in movi:
            _scan_movi(data, s, e, ids, spans)
    if scale:
        fps = rate / scale
    else:
        fps = 1e6 / avih[0] if avih and avih[0] else 30.0
    if fmt == MJPEG:
        return Video(path, float(fps), int(width), abs(int(height)), 0,
                     codec, spans)
    if keys is None:
        keys = [_is_keyframe(fmt, bytes(data[o:o + n])) for o, n in spans]
    head = [bytes(data[o:o + n]) for o, n in spans[:4]]
    if fmt == MPEG4:
        _refuse_packed(path, codec, head)
    # an MPEG-4 strf may hold the VOL header (FFmpeg's extradata) past its
    # BITMAPINFOHEADER; H.264 in AVI carries its parameter sets in band
    header = strf[40:] if fmt == MPEG4 and strf and len(strf) > 40 else b""
    return Video(path, float(fps), int(width), abs(int(height)), 0, codec,
                 spans, fmt, sync=[i for i, k in enumerate(keys) if k],
                 header=header)


def _refuse_packed(path, codec, packets) -> None:
    """MPEG-4 Part 2 whose DivX user data says its B-frames are packed two
    to a packet (FFmpeg's ``divx_packed``): NVDEC's parser does not unpack
    them."""
    for p in packets:
        m = _DIVX.search(p)
        if m and m.group(3):
            raise no_decoder(path, f"{codec}, DivX {m.group(1)} build "
                                   f"{m.group(2)} with packed B-frames")


def _avi_index(data, idx1, movi_fourcc, ids):
    """Packets and their ``AVIIF_KEYFRAME`` flags from ``idx1``, whose
    offsets count from the ``movi`` fourcc or from the start of the file;
    (None, None) if neither fits."""
    s, e = idx1
    entries = [struct.unpack("<4sIII", data[p:p + 16])
               for p in range(s, e - 15, 16)]
    video = [(off, size, bool(flags & 0x10))
             for cc, flags, off, size in entries if cc in ids and size]
    if not video:
        return None, None
    for base in (movi_fourcc, 0):
        off = video[0][0]
        if data[base + off:base + off + 4] in ids:
            return ([(base + off + 8, size) for off, size, _ in video],
                    [key for _, _, key in video])
    return None, None


def _scan_movi(data, s, e, ids, spans):
    for cc, kind, s2, e2 in _riff_chunks(data, s, e):
        if kind == b"rec ":
            _scan_movi(data, s2, e2, ids, spans)
        elif cc in ids and e2 > s2:
            spans.append((s2, e2 - s2))


# -- ISO BMFF ----------------------------------------------------------------

CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts", b"dinf",
              b"udta"}


def _boxes(data, start, end):
    """Yield (type, body start, body end) of the boxes in [start, end)."""
    pos = start
    while pos + 8 <= end:
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        head = 8
        if size == 1:
            size, = struct.unpack(">Q", data[pos + 8:pos + 16])
            head = 16
        elif size == 0:
            size = end - pos
        if size < head:
            break
        yield kind, pos + head, min(pos + size, end)
        pos += size


def _child(data, s, e, kind):
    for k, s2, e2 in _boxes(data, s, e):
        if k == kind:
            return s2, e2
    return None


def _descriptor(data, pos):
    """(tag, body start, body end) of an MPEG-4 descriptor at ``pos``."""
    tag = data[pos]
    pos += 1
    size = 0
    for _ in range(4):
        b = data[pos]
        pos += 1
        size = size << 7 | (b & 0x7F)
        if not b & 0x80:
            break
    return tag, pos, pos + size


def object_type(data, s, e):
    """The ``objectTypeIndication`` of an ``esds`` box's decoder config,
    or None."""
    tag, p, end = _descriptor(data, s + 4)      # past version and flags
    if tag != 0x03:
        return None
    flags = data[p + 2]
    p += 3
    if flags & 0x80:
        p += 2
    if flags & 0x40:
        p += 1 + data[p]
    if flags & 0x20:
        p += 2
    tag, p, _ = _descriptor(data, p)
    return data[p] if tag == 0x04 else None


def display_rotation(matrix) -> int:
    """The rotation of a ``tkhd`` display matrix as OpenCV's FFmpeg backend
    reports it (``CAP_PROP_ORIENTATION_META``): the angle of the matrix's
    first column, rounded, in [0, 360)."""
    a, b, _, c, d = (v / 65536.0 for v in matrix[:5])
    s0, s1 = math.hypot(a, c), math.hypot(b, d)
    if s0 == 0 or s1 == 0:
        return 0
    deg = math.atan2(b / s1, a / s0) * 180 / math.pi
    return int(np.rint(deg)) % 360


def _open_mp4(path: str, data) -> Video:
    moov = _child(data, 0, len(data), b"moov")
    if moov is None:
        raise IOError(f"{path}: an MP4/MOV file without moov")
    mvhd = _child(data, *moov, b"mvhd")
    movie_scale, = struct.unpack_from(
        ">I", data, mvhd[0] + (20 if data[mvhd[0]] == 1 else 12)) \
        if mvhd else (0,)
    for kind, s, e in _boxes(data, *moov):
        if kind != b"trak":
            continue
        mdia = _child(data, s, e, b"mdia")
        hdlr = mdia and _child(data, *mdia, b"hdlr")
        if not hdlr or data[hdlr[0] + 8:hdlr[0] + 12] != b"vide":
            continue
        return _mp4_track(path, data, (s, e), mdia, movie_scale)
    raise IOError(f"{path}: an MP4/MOV file without a video track")


def _full_table(data, box, fmt: str) -> list:
    """The entries of a full box's table: version and flags, a 32-bit
    count, then ``count`` records of ``fmt``."""
    s, _ = box
    n, = struct.unpack(">I", data[s + 4:s + 8])
    size = struct.calcsize(fmt)
    return [struct.unpack(fmt, data[s + 8 + size * i:s + 8 + size * (i + 1)])
            for i in range(n)]


def _avcc(data, s, e):
    """(parameter sets as Annex B, NAL length size) of an ``avcC`` body."""
    length = (data[s + 4] & 3) + 1
    pos, units = s + 5, []
    for mask in (0x1F, 0xFF):           # the SPS, then the PPS
        count = data[pos] & mask
        pos += 1
        for _ in range(count):
            n, = struct.unpack(">H", data[pos:pos + 2])
            units.append(b"\0\0\0\1" + bytes(data[pos + 2:pos + 2 + n]))
            pos += 2 + n
    return b"".join(units), length


def _decoder_info(data, s, e):
    """The DecoderSpecificInfo (tag 0x05) of an ``esds`` box's decoder
    config, or b""."""
    tag, p, _ = _descriptor(data, s + 4)
    flags = data[p + 2]
    p += 3
    if flags & 0x80:
        p += 2
    if flags & 0x40:
        p += 1 + data[p]
    if flags & 0x20:
        p += 2
    tag, p, end = _descriptor(data, p)
    if tag != 0x04 or p + 13 >= end:
        return b""
    tag, p, end = _descriptor(data, p + 13)
    return bytes(data[p:end]) if tag == 0x05 else b""


def _mp4_order(data, box, elst, n, timescale, movie_scale):
    """(display order, ranks shown) from ``stts``, ``ctts`` and the first
    edit of ``elst`` with media (None where the file has neither)."""
    if box[b"ctts"] is None and elst is None:
        return None, None
    dts, t = [], 0
    for count, delta in _full_table(data, box[b"stts"], ">II"):
        for _ in range(count):
            dts.append(t)
            t += delta
    offsets = []
    if box[b"ctts"] is not None:
        for count, off in _full_table(data, box[b"ctts"], ">Ii"):
            offsets += [off] * count
    offsets += [0] * (n - len(offsets))
    cts = [d + o for d, o in zip(dts, offsets[:n])]
    order = sorted(range(n), key=lambda i: (cts[i], i))
    shown = None
    if elst is not None:
        version = data[elst[0]]
        fmt = ">QqI" if version == 1 else ">IiI"
        edits = [e for e in _full_table(data, (elst[0], elst[1]), fmt)
                 if e[1] != -1]         # empty edits only delay the start
        if edits:
            duration, start, _ = edits[0]
            end = start + duration * timescale / movie_scale \
                if duration and movie_scale else math.inf
            shown = [r for r, i in enumerate(order) if start <= cts[i] < end]
    return order, shown


def _mp4_track(path, data, trak, mdia, movie_scale=0) -> Video:
    tkhd = _child(data, *trak, b"tkhd")
    version = data[tkhd[0]]
    mat_at = tkhd[0] + (52 if version == 1 else 40)
    matrix = struct.unpack(">9i", data[mat_at:mat_at + 36])
    mdhd = _child(data, *mdia, b"mdhd")
    timescale, = struct.unpack_from(
        ">I", data, mdhd[0] + (20 if data[mdhd[0]] == 1 else 12))
    minf = _child(data, *mdia, b"minf")
    stbl = _child(data, *minf, b"stbl")
    box = {k: _child(data, *stbl, k) for k in (
        b"stsd", b"stts", b"stsc", b"stsz", b"stco", b"co64", b"stss",
        b"ctts")}
    s, _ = box[b"stsd"]
    entry = s + 8                                   # version, flags, count
    size, fmt = struct.unpack(">I4s", data[entry:entry + 8])
    codec = fmt.decode("latin-1")
    width, height = struct.unpack(">HH", data[entry + 32:entry + 36])
    header, nal_length, fmt_info = b"", 0, None
    boxes = (entry + 86, entry + size)
    if codec == "mp4v":
        esds = _child(data, entry + 86, entry + size, b"esds")
        oti = object_type(data, *esds) if esds else None
        if oti not in (OBJECT_JPEG, OBJECT_MPEG4):
            name = OBJECT_TYPES.get(oti, "unknown")
            raise no_decoder(path, f"mp4v, object type "
                                   f"{'none' if oti is None else hex(oti)} "
                                   f"({name})")
        kind = MJPEG if oti == OBJECT_JPEG else MPEG4
        if kind == MPEG4:
            header = _decoder_info(data, *esds)
    elif codec in MP4_H264:
        kind = H264
        avcc = _child(data, entry + 86, entry + size, b"avcC")
        if avcc is None:
            raise IOError(f"{path}: an {codec} sample entry without avcC")
        header, nal_length = _avcc(data, *avcc)
    elif codec in MP4_HEVC:
        kind = HEVC
        hvcc = _child(data, *boxes, b"hvcC")
        if hvcc is None:
            raise IOError(f"{path}: an {codec} sample entry without hvcC")
        header, nal_length = codecs.hvcc(bytes(data[hvcc[0]:hvcc[1]]))
    elif codec == "vp09":
        kind = VP9
        vpcc = _child(data, *boxes, b"vpcC")
        if vpcc is not None:
            fmt_info = vpcc_format(bytes(data[vpcc[0]:vpcc[1]]))
    elif codec == "av01":
        kind = AV1
        av1c = _child(data, *boxes, b"av1C")
        if av1c is None:
            raise IOError(f"{path}: an av01 sample entry without av1C")
        config = codecs.av1c(bytes(data[av1c[0]:av1c[1]]))
        header, fmt_info = config["obus"], (config["depth"], config["chroma"])
    elif codec in MP4_MJPEG:
        kind = MJPEG
    else:
        raise no_decoder(path, codec)
    spans = _mp4_samples(data, box)
    runs = _full_table(data, box[b"stts"], ">II")
    total = sum(count * delta for count, delta in runs)
    count = sum(c for c, _ in runs)
    fps = timescale * count / total if total else 30.0
    if kind == MJPEG:
        return Video(path, float(fps), int(width), int(height),
                     display_rotation(matrix), codec, spans)
    edts = _child(data, *trak, b"edts")
    elst = edts and _child(data, *edts, b"elst")
    order, shown = _mp4_order(data, box, elst, len(spans), timescale,
                              movie_scale)
    sync = None if box[b"stss"] is None else \
        [i - 1 for i, in _full_table(data, box[b"stss"], ">I")]
    if kind == MPEG4:
        _refuse_packed(path, codec, [bytes(data[o:o + n])
                                     for o, n in spans[:4]])
    hidden = ()
    if kind in (HEVC, VP9, AV1):
        sync, hidden = stream_keys(
            path, kind, lambda i: bytes(data[spans[i][0]:sum(spans[i])]),
            len(spans), sync, nal_length, header)
    return Video(path, float(fps), int(width), int(height),
                 display_rotation(matrix), codec, spans, kind, sync=sync,
                 order=order, shown=shown, header=header,
                 nal_length=nal_length, hidden=hidden,
                 stream_format=fmt_info)


def vpcc_format(body: bytes) -> tuple:
    """(bit depth, chroma format) of a ``vpcC`` body (VP Codec ISO Media
    File Format Binding 2.2, version 1)."""
    if len(body) < 8:
        raise IOError("a vpcC record shorter than 8 bytes")
    depth, sub = body[6] >> 4, body[6] >> 1 & 7
    return depth, {0: "4:2:0", 1: "4:2:0", 2: "4:2:2", 3: "4:4:4"}.get(
        sub, str(sub))


def _mp4_samples(data, box) -> list:
    s, _ = box[b"stsz"]
    fixed, n = struct.unpack(">II", data[s + 4:s + 12])
    sizes = [fixed] * n if fixed else list(
        struct.unpack(f">{n}I", data[s + 12:s + 12 + 4 * n]))
    if box[b"co64"] is not None:
        s, _ = box[b"co64"]
        m, = struct.unpack(">I", data[s + 4:s + 8])
        chunks = struct.unpack(f">{m}Q", data[s + 8:s + 8 + 8 * m])
    else:
        s, _ = box[b"stco"]
        m, = struct.unpack(">I", data[s + 4:s + 8])
        chunks = struct.unpack(f">{m}I", data[s + 8:s + 8 + 4 * m])
    s, _ = box[b"stsc"]
    k, = struct.unpack(">I", data[s + 4:s + 8])
    runs = [struct.unpack(">III", data[s + 8 + 12 * i:s + 20 + 12 * i])
            for i in range(k)]
    spans, sample = [], 0
    for r, (first, per_chunk, _) in enumerate(runs):
        last = runs[r + 1][0] - 1 if r + 1 < k else m
        for chunk in range(first - 1, last):
            offset = chunks[chunk]
            for _ in range(per_chunk):
                if sample >= n:
                    return spans
                spans.append((offset, sizes[sample]))
                offset += sizes[sample]
                sample += 1
    if sample != n:
        raise IOError(f"the sample table places {sample} of {n} samples")
    return spans



# -- writing: MJPEG in an MP4 ------------------------------------------------

def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I4s", 8 + len(body), kind) + body


def _full(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack(">I", version << 24 | flags), *parts)


def _descr(tag: int, body: bytes) -> bytes:
    n = len(body)
    size = bytes([0x80 | (n >> 21 & 0x7F), 0x80 | (n >> 14 & 0x7F),
                  0x80 | (n >> 7 & 0x7F), n & 0x7F])
    return bytes([tag]) + size + body


IDENTITY = struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                       0x40000000)


class Mp4Writer:
    """Write JPEG packets as an MJPEG video in an MP4: one track, an
    ``mp4v`` sample entry whose ``esds`` object type is 0x6C (JPEG), as
    FFmpeg (and so ``cv2.VideoWriter``) stores MJPEG in an MP4; one sample
    a chunk, a constant frame duration.  The samples stream into ``mdat``
    (64-bit size) and ``moov`` follows at :meth:`close`."""

    def __init__(self, path: str, fps: float, width: int, height: int):
        self.path = path
        self.width, self.height = int(width), int(height)
        # fps as timescale / duration, to a thousandth of a frame a second
        self.timescale = max(1, int(round(fps * 1000)))
        self.delta = 1000
        self.sizes, self.offsets = [], []
        self._f = open(path, "wb")
        self._f.write(_box(b"ftyp", b"isom", struct.pack(">I", 0x200),
                           b"isomiso2mp41"))
        self._mdat = self._f.tell()
        self._f.write(struct.pack(">I4sQ", 1, b"mdat", 0))

    def write(self, packet: bytes) -> None:
        self.offsets.append(self._f.tell())
        self.sizes.append(len(packet))
        self._f.write(packet)

    def close(self) -> None:
        if self._f is None:
            return
        end = self._f.tell()
        self._f.seek(self._mdat + 8)
        self._f.write(struct.pack(">Q", end - self._mdat))
        self._f.seek(end)
        self._f.write(self._moov())
        self._f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _moov(self) -> bytes:
        n, w, h = len(self.sizes), self.width, self.height
        duration = n * self.delta                    # in the track's scale
        movie = int(round(duration * 1000 / self.timescale))   # in ms
        mvhd = _full(b"mvhd", 0, 0, struct.pack(
            ">IIIIIH10x", 0, 0, 1000, movie, 0x10000, 0x100), IDENTITY,
            bytes(24), struct.pack(">I", 2))
        tkhd = _full(b"tkhd", 0, 3, struct.pack(
            ">IIIII8xHHHxx", 0, 0, 1, 0, movie, 0, 0, 0), IDENTITY,
            struct.pack(">II", w << 16, h << 16))
        mdhd = _full(b"mdhd", 0, 0, struct.pack(
            ">IIIIHH", 0, 0, self.timescale, duration, 0x55C4, 0))
        hdlr = _full(b"hdlr", 0, 0, struct.pack(">I4s12x", 0, b"vide"),
                     b"VideoHandler\0")
        esds = _full(b"esds", 0, 0, _descr(0x03, struct.pack(">HB", 1, 0)
                     + _descr(0x04, struct.pack(
                         ">BB3sII", OBJECT_JPEG, 0x11, (0).to_bytes(3, "big"),
                         0, 0)) + _descr(0x06, b"\x02")))
        entry = _box(b"mp4v", bytes(6), struct.pack(">H", 1), bytes(16),
                     struct.pack(">HHIIIH", w, h, 0x480000, 0x480000, 0, 1),
                     bytes(32), struct.pack(">Hh", 24, -1), esds)
        co64 = bool(self.offsets) and self.offsets[-1] > 0xFFFFFFFF
        stbl = _box(
            b"stbl",
            _full(b"stsd", 0, 0, struct.pack(">I", 1), entry),
            _full(b"stts", 0, 0, struct.pack(">III", 1, n, self.delta)),
            _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1)),
            _full(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n, *self.sizes)),
            _full(b"co64", 0, 0, struct.pack(f">I{n}Q", n, *self.offsets))
            if co64 else
            _full(b"stco", 0, 0, struct.pack(f">I{n}I", n, *self.offsets)))
        minf = _box(b"minf", _full(b"vmhd", 0, 1, bytes(8)),
                    _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1),
                                        _full(b"url ", 0, 1))), stbl)
        trak = _box(b"trak", tkhd, _box(b"mdia", mdhd, hdlr, minf))
        return _box(b"moov", mvhd, trak)
