"""fdk-aac bindings through the COFF loader (codecs/aac/coff.py).

Runs the reference's prebuilt Windows fdk-aac library on Linux — the same
binary dependency model the reference uses (it links this exact archive;
IAMF_aac_decoder.c:83-161) — serving as the AAC test-vector encoder and the
decode oracle/backend until the from-scratch AAC-LC decoder replaces
the decode side.

Encoder/decoder API per dep_codecs/include/fdk-aac/aacenc_lib.h and
aacdecoder_lib.h (RAW transport, AudioSpecificConfig via ConfigRaw).
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from .coff import CoffImage

_LIB_PATH = "/root/reference/dep_codecs/lib/fdk-aac_x64.lib"
_IMG = None


def image() -> CoffImage:
    global _IMG
    if _IMG is None:
        _IMG = CoffImage(_LIB_PATH)
    return _IMG


def _addr(buf) -> int:
    return ctypes.addressof(buf) if not isinstance(buf, int) else buf


class _BufDesc(ctypes.Structure):
    _fields_ = [
        ("numBufs", ctypes.c_int), ("bufs", ctypes.POINTER(ctypes.c_void_p)),
        ("bufferIdentifiers", ctypes.POINTER(ctypes.c_int)),
        ("bufSizes", ctypes.POINTER(ctypes.c_int)),
        ("bufElSizes", ctypes.POINTER(ctypes.c_int)),
    ]


class _InArgs(ctypes.Structure):
    _fields_ = [("numInSamples", ctypes.c_int),
                ("numAncBytes", ctypes.c_int)]


class _OutArgs(ctypes.Structure):
    _fields_ = [("numOutBytes", ctypes.c_int),
                ("numInSamples", ctypes.c_int),
                ("numAncBytes", ctypes.c_int)]


class _EncInfo(ctypes.Structure):
    _fields_ = [
        ("maxOutBufBytes", ctypes.c_uint), ("maxAncBytes", ctypes.c_uint),
        ("inBufFillLevel", ctypes.c_uint), ("inputChannels", ctypes.c_uint),
        ("frameLength", ctypes.c_uint), ("nDelay", ctypes.c_uint),
        ("nDelayCore", ctypes.c_uint), ("confBuf", ctypes.c_ubyte * 64),
        ("confSize", ctypes.c_uint),
    ]


def _bufdesc(ptr, ident, size, elsize):
    d = _BufDesc()
    d.numBufs = 1
    d._b = (ctypes.c_void_p * 1)(ptr)
    d._i = (ctypes.c_int * 1)(ident)
    d._s = (ctypes.c_int * 1)(size)
    d._e = (ctypes.c_int * 1)(elsize)
    d.bufs = d._b
    d.bufferIdentifiers = d._i
    d.bufSizes = d._s
    d.bufElSizes = d._e
    return d


class FdkEncoder:
    """AAC-LC encoder (RAW access units + AudioSpecificConfig)."""

    def __init__(self, channels: int, sample_rate: int = 48000,
                 bitrate: int = 64000, frame_length: int = 1024):
        img = image()
        self.img = img
        self.channels = channels
        ph = ctypes.c_uint64(0)
        err = img.call(img.sym("aacEncOpen"),
                       [ctypes.addressof(ph), 0x01, channels])
        if err:
            raise RuntimeError(f"aacEncOpen 0x{err:x}")
        self.h = ph.value
        setp = img.sym("aacEncoder_SetParam")
        for param, val in [
            (0x0100, 2),            # AACENC_AOT: AAC-LC
            (0x0103, sample_rate),  # AACENC_SAMPLERATE
            (0x0106, channels),     # AACENC_CHANNELMODE (1=mono, 2=stereo)
            (0x0101, bitrate),      # AACENC_BITRATE
            (0x0300, 0),            # AACENC_TRANSMUX: TT_MP4_RAW
            (0x0105, frame_length),  # AACENC_GRANULE_LENGTH
        ]:
            e = img.call(setp, [self.h, param, val])
            if e:
                raise RuntimeError(f"SetParam 0x{param:x}={val}: 0x{e:x}")
        # init: encode call with NULL descriptors
        e = img.call(img.sym("aacEncEncode"), [self.h, 0, 0, 0, 0])
        if e:
            raise RuntimeError(f"aacEncEncode init 0x{e:x}")
        info = _EncInfo()
        e = img.call(img.sym("aacEncInfo"), [self.h, ctypes.addressof(info)])
        if e:
            raise RuntimeError(f"aacEncInfo 0x{e:x}")
        self.frame_length = info.frameLength
        self.delay = info.nDelay
        self.asc = bytes(info.confBuf[: info.confSize])

    def encode(self, pcm: np.ndarray):
        """pcm: [T, channels] int16 -> list of AU bytes (one per full frame)."""
        img = self.img
        pcm = np.ascontiguousarray(pcm, np.int16)
        out = []
        fl = self.frame_length
        outbuf = ctypes.create_string_buffer(8192)
        enc = img.sym("aacEncEncode")
        for f in range(len(pcm) // fl):
            chunk = np.ascontiguousarray(pcm[f * fl:(f + 1) * fl].reshape(-1))
            inb = _bufdesc(chunk.ctypes.data, 0, chunk.nbytes, 2)
            outb = _bufdesc(ctypes.addressof(outbuf), 3, 8192, 1)
            ia = _InArgs(numInSamples=fl * self.channels)
            oa = _OutArgs()
            e = img.call(enc, [self.h, ctypes.addressof(inb),
                               ctypes.addressof(outb), ctypes.addressof(ia),
                               ctypes.addressof(oa)])
            if e:
                raise RuntimeError(f"aacEncEncode 0x{e:x}")
            if oa.numOutBytes:
                out.append(outbuf.raw[: oa.numOutBytes])
        return out

    def close(self):
        ph = ctypes.c_uint64(self.h)
        self.img.call(self.img.sym("aacEncClose"), [ctypes.addressof(ph)])


class FdkDecoder:
    """AAC-LC decoder, RAW transport + ConfigRaw ASC (as the reference
    wrapper drives it, aac_multistream_decoder.c:82-101).

    limiter=None keeps fdk's default built-in PCM limiter (what the
    reference runs: 720-sample look-ahead delay @48 kHz, reported via
    CStreamInfo.outputDelay); False disables it for pure decoder-vs-decoder
    comparisons (AAC_PCM_LIMITER_ENABLE)."""

    def __init__(self, asc: bytes, max_channels: int = 2, limiter=None):
        img = image()
        self.img = img
        self.h = img.call(img.sym("aacDecoder_Open"), [0, 1])  # TT_MP4_RAW
        if not self.h:
            raise RuntimeError("aacDecoder_Open failed")
        conf = ctypes.create_string_buffer(bytes(asc), len(asc))
        pconf = (ctypes.c_void_p * 1)(ctypes.addressof(conf))
        lens = (ctypes.c_uint * 1)(len(asc))
        e = img.call(img.sym("aacDecoder_ConfigRaw"),
                     [self.h, ctypes.addressof(pconf), ctypes.addressof(lens)])
        if e:
            raise RuntimeError(f"aacDecoder_ConfigRaw 0x{e:x}")
        # AAC_CONCEAL_METHOD=1 (noise), as the reference sets
        img.call(img.sym("aacDecoder_SetParam"), [self.h, 0x0100, 1])
        if limiter is not None:  # AAC_PCM_LIMITER_ENABLE
            img.call(img.sym("aacDecoder_SetParam"),
                     [self.h, 0x0004, int(limiter)])
        self.maxch = max_channels
        self._out = np.zeros(2048 * 8, np.int16)

    @property
    def output_delay(self) -> int:
        """CStreamInfo.outputDelay (valid after the first decode)."""
        sinfo = self.img.call(
            self.img.sym("aacDecoder_GetStreamInfo"), [self.h])
        return struct.unpack_from("<i", ctypes.string_at(sinfo + 68, 4))[0]

    def decode(self, au: bytes):
        """-> [frameSize, numChannels] int16."""
        img = self.img
        buf = ctypes.create_string_buffer(bytes(au), len(au))
        pbuf = (ctypes.c_void_p * 1)(ctypes.addressof(buf))
        sizes = (ctypes.c_uint * 1)(len(au))
        valid = (ctypes.c_uint * 1)(len(au))
        e = img.call(img.sym("aacDecoder_Fill"),
                     [self.h, ctypes.addressof(pbuf), ctypes.addressof(sizes),
                      ctypes.addressof(valid)])
        if e:
            raise RuntimeError(f"aacDecoder_Fill 0x{e:x}")
        e = img.call(img.sym("aacDecoder_DecodeFrame"),
                     [self.h, self._out.ctypes.data, len(self._out), 0])
        if e:
            raise RuntimeError(f"aacDecoder_DecodeFrame 0x{e:x}")
        sinfo = img.call(img.sym("aacDecoder_GetStreamInfo"), [self.h])
        rate, fsz, nch = struct.unpack_from(
            "<iii", ctypes.string_at(sinfo, 12))
        return self._out[: fsz * nch].reshape(fsz, nch).copy(), rate

    def close(self):
        self.img.call(self.img.sym("aacDecoder_Close"), [self.h])
