"""Device-side CELT synthesis vs the host synthesis path, on real libopus
packets: the device pipeline (spectrum export -> batched IMDCT matmul -> comb
post-filter scan -> de-emphasis scan -> s16) must match the host decoder
to <=1 s16 LSB (the de-emphasis associative scan is the only permitted
rounding difference; see codecs/opus/tpu_synth.py)."""

import ctypes

import numpy as np
import pytest

from test_opus_entdec import ORACLE, _build
from test_opus_celt_e2e import encode_packets

from iamf_tpu.codecs.opus.decoder import OpusDecoder, TPUOpusStream
from opusenc import opus_decoder_conf


@pytest.fixture(scope="module")
def ref():
    _build()
    lib = ctypes.CDLL(ORACLE)
    lib.opus_encoder_create.restype = ctypes.c_void_p
    lib.opus_encode_float.restype = ctypes.c_int
    return lib


def music(n, channels=2, seed=7, transients=False):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 48000.0
    x = np.zeros((n, channels), np.float32)
    for c in range(channels):
        for k, f0 in enumerate([220.0, 440.0, 662.0, 881.0]):
            vib = 1.0 + 0.002 * np.sin(2 * np.pi * (1.3 + c) * t + k)
            x[:, c] += (0.22 / (k + 1)) * np.sin(
                2 * np.pi * f0 * vib * t + 0.3 * c).astype(np.float32)
    x += 0.01 * rng.standard_normal((n, channels)).astype(np.float32)
    if transients:
        for p in range(600, n - 600, 1900):
            x[p : p + 40] += (0.3 * rng.standard_normal(
                (40, channels))).astype(np.float32)
    # keep well below full scale: codec overshoot past |1.0| engages the
    # host's pcm_soft_clip, which the device path deliberately omits
    return np.clip(0.7 * x, -0.75, 0.75).astype(np.float32)


def _run_both(ref, pcm, channels, split, **enc_kw):
    packets = encode_packets(ref, pcm, channels, **enc_kw)
    conf = opus_decoder_conf(channels=channels)
    coupled = 1 if channels == 2 else 0
    host = OpusDecoder(conf, 1, coupled, 960)
    outs = [host.decode([p]) for p in packets]           # [ch, 960] each
    host_pcm = np.concatenate(outs, axis=1)              # planar [ch, T]

    dev = TPUOpusStream(conf, 1, coupled, 960)
    chunks = []
    for lo, hi in zip([0] + split, split + [len(packets)]):
        if hi > lo:
            out = dev.decode_frames([[p] for p in packets[lo:hi]])
            chunks.append(out.transpose(1, 0, 2).reshape(channels, -1))
    dev_pcm = np.concatenate(chunks, axis=1)
    return host_pcm, dev_pcm


def assert_lsb(host_pcm, dev_pcm, tol=1):
    diff = np.abs(host_pcm - dev_pcm) * 32768.0
    assert diff.max() <= tol + 1e-3, (diff.max(), np.unravel_index(
        diff.argmax(), diff.shape))


def test_stereo_music(ref):
    pcm = music(960 * 14)
    host_pcm, dev_pcm = _run_both(ref, pcm, 2, split=[6])
    assert_lsb(host_pcm, dev_pcm)


def test_transients_short_blocks(ref):
    pcm = music(960 * 12, transients=True)
    host_pcm, dev_pcm = _run_both(ref, pcm, 2, split=[5, 9])
    assert_lsb(host_pcm, dev_pcm)


def test_mono_low_bitrate(ref):
    pcm = music(960 * 10, channels=1, seed=3)
    host_pcm, dev_pcm = _run_both(ref, pcm, 1, split=[4], bitrate=32000)
    assert_lsb(host_pcm, dev_pcm)


def test_batch_boundary_of_one(ref):
    """Single-frame dispatches stress the carry (tail/hist/demem) chain."""
    pcm = music(960 * 5, seed=11)
    host_pcm, dev_pcm = _run_both(ref, pcm, 2, split=[1, 2, 3, 4])
    assert_lsb(host_pcm, dev_pcm)
