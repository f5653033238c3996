"""Binaural output tests: matrix path vs reference goldens (-sb) and the
HRTF convolution renderer (M2B/H2B, BASELINE config 5)."""

import numpy as np
import pytest

import vectors
from test_e2e_pcm import assert_bitexact, ours_decode, ref_decode
from test_e2e_scalable import assert_close
from iamf_tpu.constants import ChannelLayout


def ours_decode_hrm(stream, binaural=True, hrm=None):
    """Decode forcing a headphones_rendering_mode on all renderers."""
    from iamf_tpu.api import IAMFDecoder

    dec = IAMFDecoder()
    dec.set_binaural()
    pos = dec.configure(stream)
    if hrm is not None:
        for r in dec.renderers:
            r.headphones_rendering_mode = hrm
    chunks = []
    while pos < len(stream):
        consumed, pcm = dec.decode(stream[pos:])
        if consumed == 0 and pcm is None:
            break
        pos += consumed
        if pcm is not None and len(pcm):
            chunks.append(pcm)
    _, pcm = dec.decode(None)
    if pcm is not None and len(pcm):
        chunks.append(pcm)
    return np.concatenate(chunks, axis=0)


def test_binaural_matrix_path_51(tmp_path):
    """Reference default (-sb, binauralizer compiled out) = M2M matrix."""
    stream, _ = vectors.build_pcm_51_stream(n_frames=6)
    ref = ref_decode(stream, tmp_path, sound_system="b")
    ours = ours_decode(stream, binaural=True)
    assert_bitexact(ours, ref)


def test_binaural_matrix_path_foa(tmp_path):
    stream, _ = vectors.build_ambisonics_pcm_stream(
        order=1, n_frames=5, target_layouts=(0,)
    )
    ref = ref_decode(stream, tmp_path, sound_system="b")
    ours = ours_decode(stream, binaural=True)
    assert_close(ours, ref, max_lsb=1, frac=0)


def test_hrtf_m2b_renders():
    """HRTF conv binaural (headphones_rendering_mode=1): sane output —
    2 channels, energy present, L/R asymmetric for off-center content."""
    stream, src = vectors.build_pcm_51_stream(n_frames=6, amp=0.4)
    out = ours_decode_hrm(stream, hrm=1)
    assert out.shape[1] == 2
    e = (out.astype(np.float64) ** 2).mean(axis=0)
    assert e[0] > 0 and e[1] > 0
    # content is asymmetric multitone -> ears differ
    assert not np.array_equal(out[:, 0], out[:, 1])


def test_hrtf_h2b_renders():
    stream, _ = vectors.build_ambisonics_pcm_stream(
        order=1, n_frames=5, target_layouts=(0,)
    )
    out = ours_decode_hrm(stream, hrm=1)
    assert out.shape[1] == 2
    assert np.abs(out).max() > 0


def test_fft_conv_matches_direct_convolution():
    """Golden oracle: the streaming overlap FFT convolution must equal
    per-channel np.convolve summed over speakers, across frame boundaries
    (the [2, taps-1] overlap carry included)."""
    from iamf_tpu.dsp.binaural import HRTFRenderer, hrir_bank

    layout = ChannelLayout.L510
    T, n_frames = 480, 4
    rend = HRTFRenderer(layout, frame_size=T)
    bank = hrir_bank(layout)  # [2, C, taps]
    C = bank.shape[1]
    rng = np.random.RandomState(5)
    x = rng.randn(C, n_frames * T).astype(np.float32) * 0.3

    got = np.concatenate(
        [rend.render(x[:, f * T:(f + 1) * T]) for f in range(n_frames)],
        axis=1)
    want = np.zeros((2, n_frames * T))
    for e in range(2):
        for c in range(C):
            want[e] += np.convolve(x[c].astype(np.float64),
                                   bank[e, c])[: n_frames * T]
    err = np.abs(got - want).max()
    assert err < 1e-4, f"conv mismatch {err}"


def test_itd_matches_woodworth():
    """Measured inter-ear delay equals the Woodworth model's prediction
    (the HRIR generator's own parameters) within half a sample."""
    import math
    from iamf_tpu.dsp.binaural import (
        HEAD_RADIUS, SPEED_OF_SOUND, spherical_head_hrir)

    rate = 48000

    def woodworth_itd(az_deg):
        az = math.radians(az_deg)
        d = []
        for sign in (1.0, -1.0):  # left, right ear
            inc = math.acos(max(-1.0, min(1.0, math.sin(az * sign))))
            if inc <= math.pi / 2:
                dt = -HEAD_RADIUS / SPEED_OF_SOUND * math.cos(inc)
            else:
                dt = HEAD_RADIUS / SPEED_OF_SOUND * (inc - math.pi / 2)
            d.append(dt * rate)
        return d[1] - d[0]  # right minus left, samples

    for az in (30.0, 60.0, 90.0, 110.0):
        h = spherical_head_hrir(az, 0.0, taps=512, rate=rate)
        # group delay via cross-correlation peak with 16x oversampling
        n = 1 << 14
        X0 = np.fft.rfft(h[0], n)
        X1 = np.fft.rfft(h[1], n)
        xc = np.fft.irfft(X1 * np.conj(X0), 16 * n)
        lag = np.argmax(xc)
        if lag > 8 * n:
            lag -= 16 * n
        measured = lag / 16.0
        want = woodworth_itd(az)
        assert abs(measured - want) <= 0.5, (az, measured, want)
        assert measured > 0  # left source: left ear leads


def test_ild_by_direction():
    """ILD magnitude: lateral sources show a strong level difference with
    the correct sign; a frontal source is symmetric."""
    from iamf_tpu.dsp.binaural import spherical_head_hrir

    def ild_db(az):
        h = spherical_head_hrir(az, 0.0)
        el = (h[0].astype(np.float64) ** 2).sum()
        er = (h[1].astype(np.float64) ** 2).sum()
        return 10.0 * np.log10(el / er)

    assert abs(ild_db(0.0)) < 0.5
    assert ild_db(90.0) > 6.0
    assert ild_db(-90.0) < -6.0
    assert ild_db(30.0) > 1.0
    # monotone toward the side
    assert ild_db(90.0) > ild_db(45.0) > ild_db(15.0)


def test_measured_hrir_bank_loading(tmp_path):
    """A measured HRIR set (.npz) replaces the parametric model and the
    renderer convolves with exactly those impulse responses."""
    from iamf_tpu.dsp.binaural import HRTFRenderer, load_hrir_bank

    layout = ChannelLayout.STEREO
    rng = np.random.RandomState(9)
    taps = 64
    # per-direction keys (SADIE-style export): L2 az30, R2 az-30
    h30 = rng.randn(2, taps).astype(np.float32) * 0.1
    hm30 = rng.randn(2, taps).astype(np.float32) * 0.1
    p = tmp_path / "set.npz"
    np.savez(p, az30_el0=h30, **{"az-30_el0": hm30})
    bank = load_hrir_bank(str(p), layout)
    assert bank.shape == (2, 2, taps)

    T = 128
    rend = HRTFRenderer(layout, frame_size=T, bank=bank)
    x = rng.randn(2, T).astype(np.float32)
    got = rend.render(x)
    want = np.zeros((2, T))
    for e in range(2):
        for c in range(2):
            want[e] += np.convolve(x[c].astype(np.float64),
                                   bank[e, c])[:T]
    assert np.abs(got - want).max() < 1e-5


def test_hrir_bank_properties():
    from iamf_tpu.dsp.binaural import hrir_bank, spherical_head_hrir

    bank = hrir_bank(ChannelLayout.L510)
    assert bank.shape == (2, 6, 256)
    # left-side source louder in left ear
    h = spherical_head_hrir(90.0, 0.0)
    el = (h[0] ** 2).sum()
    er = (h[1] ** 2).sum()
    assert el > 2 * er
    # ITD: left ear leads for a left-side source
    pl = np.argmax(np.abs(h[0]))
    pr = np.argmax(np.abs(h[1]))
    assert pl < pr


# ---------------------------------------------------------------------------
# Batched-path binaural (VERDICT r2 missing #6): BatchedStreamDecoder must
# serve -sb through the fused device pipeline, matching the serial path.
# ---------------------------------------------------------------------------


def test_batched_binaural_matrix_matches_reference(tmp_path):
    """hrm=0 (reference default, binauralizer compiled out): the batched
    path renders via the M2M IAMF_BINAURAL matrix — ≤1 LSB vs -sb (the
    batched matmul render's usual accumulation-order tolerance)."""
    from iamf_tpu.core.batch_decoder import BatchedStreamDecoder

    stream, _ = vectors.build_pcm_51_stream(n_frames=6)
    ref = ref_decode(stream, tmp_path, sound_system="b")
    out = np.asarray(BatchedStreamDecoder(
        stream, binaural=True, batch_frames=4).decode_all())
    assert out.shape == ref.shape
    assert_close(out, ref, max_lsb=1, frac=0)


def test_batched_binaural_hrtf_m2b_matches_serial():
    """hrm=1 in the stream: the fused pipeline's whole-batch overlap-save
    HRTF conv must equal the serial per-frame HRTFRenderer (same bank,
    same overlap chaining) across batch boundaries."""
    from iamf_tpu.core.batch_decoder import BatchedStreamDecoder

    stream, _ = vectors.build_pcm_51_stream(n_frames=7, hrm=1)
    serial = ours_decode(stream, binaural=True)
    out = np.asarray(BatchedStreamDecoder(
        stream, binaural=True, batch_frames=3).decode_all())
    assert out.shape == serial.shape
    assert_close(out, serial, max_lsb=1, frac=0)


def test_batched_binaural_hrtf_h2b_matches_serial():
    """Scene-based hrm=1: HOA -> 7.1.2 virtual bed -> HRTF conv, fused."""
    from iamf_tpu.core.batch_decoder import BatchedStreamDecoder

    stream, _ = vectors.build_ambisonics_pcm_stream(
        order=1, n_frames=6, target_layouts=(0,), hrm=1)
    serial = ours_decode(stream, binaural=True)
    out = np.asarray(BatchedStreamDecoder(
        stream, binaural=True, batch_frames=4).decode_all())
    assert out.shape == serial.shape
    assert_close(out, serial, max_lsb=1, frac=0)


def test_batched_binaural_two_elements_m2b_h2b():
    """Mixed M2B (stereo bed) + H2B (FOA -> 7.1.2 bed) elements in ONE
    batched program: per-element HRIR banks/overlap carries, psum-style mix
    of the two [2, T] contributions — vs the serial path."""
    from iamf_tpu.core.batch_decoder import BatchedStreamDecoder

    stream, _, _ = vectors.build_two_element_stream(
        n_frames=7, gain2_q78=-(3 << 8), hrm=1)
    serial = ours_decode(stream, binaural=True)
    out = np.asarray(BatchedStreamDecoder(
        stream, binaural=True, batch_frames=3).decode_all())
    assert out.shape == serial.shape
    assert_close(out, serial, max_lsb=1, frac=0)


def test_fft_conv_len_properties():
    """5-smooth FFT padding: >= n, 2^a*3^b*5^c only, and tight (within 12%
    for conv-scale sizes) — a large prime factor leaves the FFT without
    fast radix stages (see dsp/binaural.py)."""
    from iamf_tpu.dsp.binaural import fft_conv_len

    for n in [1, 2, 7, 97, 960, 1215, 4097, 60013, 122880, 123135, 999999]:
        m = fft_conv_len(n)
        assert m >= n
        k = m
        for p in (2, 3, 5):
            while k % p == 0:
                k //= p
        assert k == 1, (n, m)
        if n >= 1000:
            assert m <= n * 1.12, (n, m)


def test_no_complex_device_params():
    """Every stream-param leaf the batched decoder puts must be
    real-valued: HRIR spectra ship as stacked float32 re/im and become
    complex only on the device."""
    import jax
    import numpy as np
    import vectors
    from iamf_tpu.constants import ChannelLayout
    from iamf_tpu.core.batch_decoder import BatchedStreamDecoder, _HostPlan

    stream = vectors.build_pcm_layout_stream(
        ChannelLayout.L510, n_frames=4, frame_size=960, amp=0.3, hrm=1)[0]
    dec = BatchedStreamDecoder(stream, binaural=True, batch_frames=4)
    plan = _HostPlan(dec)
    for leaf in jax.tree.leaves(plan.stream_params):
        assert not np.iscomplexobj(leaf), leaf.dtype
    plan.close()
