"""Binaural (HRTF-convolution) renderer, batched on the device.

The reference delegates binaural to external shared libraries (BEAR for
channel beds, m2b_rdr.c; Google Resonance for ambisonics, h2b_rdr.c), both
compiled out by default (DISABLE_BINAURALIZER=1, ae_rdr.h:67-69; the default
`-sb` path is then the M2M IAMF_BINAURAL gain matrix). This framework
replaces them with its own batched HRTF FFT-convolution op (BASELINE.json
north star):

  - an HRIR bank [2 ears, n_speakers, taps] — by default a parametric
    spherical-head model (Woodworth ITD + head-shadow lowpass + pinna notch)
    at each layout's BS.2051 speaker direction; measured HRIR sets (SADIE
    etc.) can be loaded in the same shape
  - streaming overlap-save convolution: rfft over the frame + tail, batched
    matmul across (ear, speaker) in the frequency domain,
    irfft, with a [2, taps-1] overlap carry

Scene-based content is first decoded to a 7.1.4 virtual loudspeaker bed via
the H2M matrix, then binauralized (virtual-speaker approach).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import CH, ChannelLayout, LAYOUT_CHANNELS_RENDER

SPEED_OF_SOUND = 343.0
HEAD_RADIUS = 0.0875  # m

# (azimuth degrees [left positive], elevation degrees) per channel identity;
# BS.2051 nominal positions.
CHANNEL_DIRECTIONS = {
    CH.MONO: (0.0, 0.0),
    CH.L2: (30.0, 0.0),
    CH.R2: (-30.0, 0.0),
    CH.L3: (30.0, 0.0),
    CH.R3: (-30.0, 0.0),
    CH.L7: (30.0, 0.0),
    CH.R7: (-30.0, 0.0),
    CH.C: (0.0, 0.0),
    CH.LFE: (0.0, -15.0),
    CH.SL5: (110.0, 0.0),
    CH.SR5: (-110.0, 0.0),
    CH.SL7: (90.0, 0.0),
    CH.SR7: (-90.0, 0.0),
    CH.BL7: (135.0, 0.0),
    CH.BR7: (-135.0, 0.0),
    CH.TL: (45.0, 35.0),
    CH.TR: (-45.0, 35.0),
    CH.HL: (45.0, 35.0),
    CH.HR: (-45.0, 35.0),
    CH.HFL: (45.0, 35.0),
    CH.HFR: (-45.0, 35.0),
    CH.HBL: (135.0, 35.0),
    CH.HBR: (-135.0, 35.0),
}


def spherical_head_hrir(
    azimuth_deg: float,
    elevation_deg: float,
    taps: int = 256,
    rate: int = 48000,
) -> np.ndarray:
    """[2, taps] HRIR pair from a parametric spherical-head model.

    Per ear: Woodworth ITD delay (fractional, windowed-sinc), a first-order
    head-shadow lowpass whose cutoff falls with incidence angle, and a mild
    elevation-dependent pinna notch.
    """
    az = math.radians(azimuth_deg)
    el = math.radians(elevation_deg)
    out = np.zeros((2, taps), dtype=np.float64)

    base_delay = 16  # samples of causal headroom
    for ear, sign in ((0, 1.0), (1, -1.0)):  # 0 = left ear
        # incidence angle between source and ear axis
        x = math.sin(az * sign) * math.cos(el)
        inc = math.acos(max(-1.0, min(1.0, x)))  # 0 = toward this ear
        # Woodworth: delay relative to head center
        if inc <= math.pi / 2:
            dt = -HEAD_RADIUS / SPEED_OF_SOUND * math.cos(inc)
        else:
            dt = HEAD_RADIUS / SPEED_OF_SOUND * (inc - math.pi / 2)
        delay = base_delay + dt * rate + HEAD_RADIUS / SPEED_OF_SOUND * rate

        # fractional-delay sinc impulse, windowed around the delay center
        n = np.arange(taps)
        sinc = np.sinc(n - delay)
        half_w = 32.0
        win = np.where(
            np.abs(n - delay) < half_w,
            0.5 * (1.0 + np.cos(np.pi * (n - delay) / half_w)),
            0.0,
        )
        h = sinc * win

        # head shadow: single-pole lowpass, stronger on the far side
        shadow = 0.5 * (1.0 + math.cos(inc))  # 1 near ear, 0 far
        fc = 1500.0 + 18000.0 * shadow  # Hz
        a = math.exp(-2.0 * math.pi * fc / rate)
        g = 1.0 - a
        y = np.zeros(taps)
        state = 0.0
        for i in range(taps):
            state = g * h[i] + a * state
            y[i] = state
        # near-ear gain boost / far-ear attenuation (ILD)
        y *= 0.7 + 0.3 * shadow

        # elevation pinna cue: small delayed negative reflection
        refl_delay = int(round((6.0 - 3.0 * math.sin(el)) * rate / 48000.0))
        refl = np.zeros(taps)
        if refl_delay + 1 < taps:
            refl[refl_delay] = -0.25 * (1.0 - 0.5 * math.sin(el))
        y = y + np.convolve(y, refl)[:taps]

        out[ear] = y
    return out.astype(np.float32)


@functools.lru_cache(maxsize=None)
def hrir_bank(layout: ChannelLayout, taps: int = 256, rate: int = 48000):
    """[2, n_speakers, taps] HRIR bank for a layout's rendering order."""
    chans = LAYOUT_CHANNELS_RENDER[layout]
    bank = np.stack(
        [
            spherical_head_hrir(*CHANNEL_DIRECTIONS[c], taps=taps, rate=rate)
            for c in chans
        ],
        axis=1,
    )
    # LFE: omnidirectional, reduced level
    for i, c in enumerate(chans):
        if c == CH.LFE:
            lfe = np.zeros((2, taps), dtype=np.float32)
            lfe[:, 16] = 0.5
            bank[:, i] = lfe
    return bank


def load_hrir_bank(path: str, layout: ChannelLayout) -> np.ndarray:
    """Load a measured HRIR set for a layout from an .npz file.

    Accepted forms (all [left, right] ear order, 48 kHz):
      - key "bank": [2, n_speakers, taps] already in the layout's rendering
        channel order (LAYOUT_CHANNELS_RENDER), used as-is;
      - per-direction keys "az<azimuth>_el<elevation>": [2, taps] pairs
        (e.g. "az30_el0"), gathered by each channel's BS.2051 nominal
        direction from CHANNEL_DIRECTIONS — the shape SADIE-style sets
        export to.
    Replaces the parametric spherical-head default (hrir_bank) without any
    renderer change: pass the result as HRTFRenderer(bank=...).
    """
    z = np.load(path)
    chans = LAYOUT_CHANNELS_RENDER[layout]
    if "bank" in z:
        bank = np.asarray(z["bank"], np.float32)
        if bank.ndim != 3 or bank.shape[0] != 2 or bank.shape[1] != len(chans):
            raise ValueError(
                f"bank shape {bank.shape} != [2, {len(chans)}, taps]")
        return bank
    rows = []
    for c in chans:
        az, el = CHANNEL_DIRECTIONS[c]
        key = f"az{int(round(az))}_el{int(round(el))}"
        if key not in z:
            raise ValueError(f"HRIR set missing direction {key} for {c}")
        rows.append(np.asarray(z[key], np.float32))
    taps = max(r.shape[1] for r in rows)
    bank = np.zeros((2, len(chans), taps), np.float32)
    for i, r in enumerate(rows):
        bank[:, i, : r.shape[1]] = r
    return bank


def fft_conv_len(n: int) -> int:
    """Smallest 5-smooth (2^a 3^b 5^c) length >= n.

    A length with a large prime factor has no fast radix stages, and some
    XLA backends lower such an FFT to a dense O(n^2) DFT matmul: a
    batch-length conv (128*960+255 = 123135 = 3*5*8209) would then need a
    ~60 GB f32 matrix.
    Padding the overlap-save FFT keeps the linear convolution exact (the
    zero-padded tail just extends the discarded region)."""
    best = 1
    while best < n:
        best *= 2
    m = best  # power of two always works; search smaller smooth sizes
    p5 = 1
    while p5 < best:
        p35 = p5
        while p35 < best:
            k = p35
            while k < max(n, 1):
                k *= 2
            if k >= n and k < m:
                m = k
            p35 *= 3
        p5 *= 5
    return m


def batch_seg_plan(B: int, T: int, taps: int) -> tuple[int, int, int]:
    """Segmented overlap-add plan for the batched HRTF conv:
    (seg, n_fft, n_segs) for a [*, B*T] timeline.

    One whole-batch overlap-save FFT (fft_conv_len(128*960+255) = 124416 =
    2^9*3^5) was the round-4 design point; the 3^5 radix stages and the
    single huge batch-1 transform make a poor FFT. Cutting
    the timeline into `n_segs` segments of `seg` samples convolved at
    n_fft = fft_conv_len(seg+taps-1) turns it into a BATCHED stack of
    small power-of-two-dominant FFTs (radix-2/4 friendly, small enough
    to stay in on-chip memory)
    with the same exact linear convolution: each segment's tail (taps-1
    samples) adds into the next segment, and the last tail is the carry —
    the identical [2, taps-1] overlap state the whole-batch formulation
    kept. seg is the largest multiple of T with at most 8 frames that
    divides B*T."""
    for g in (8, 4, 2, 1):
        if B % g == 0:
            seg = g * T
            return seg, fft_conv_len(seg + taps - 1), B // g


@functools.partial(jax.jit, static_argnums=(3,))
def _fft_conv_block(x, Hri, overlap, taps: int):
    """Overlap-save frequency-domain convolution of one frame.

    x: [C, T] speakers; Hri: [2(re/im), 2(ear), C, F] stacked-float rfft of
    the HRIRs padded to the 5-smooth fft_conv_len(T+taps-1), shipped as
    float32 re/im and viewed as complex on device; overlap: [2, taps-1]
    carry.
    Returns ([2, T], new overlap).
    """
    C, T = x.shape
    n = fft_conv_len(T + taps - 1)
    X = jnp.fft.rfft(x, n=n, axis=1)  # [C, F]
    H = jax.lax.complex(Hri[0], Hri[1])
    Y = jnp.einsum("ecf,cf->ef", H, X,
                   precision=jax.lax.Precision.HIGHEST)  # [2, F]
    y = jnp.fft.irfft(Y, n=n, axis=1)  # [2, n]
    out = y[:, :T].at[:, : taps - 1].add(overlap)
    new_overlap = y[:, T:T + taps - 1]
    return out, new_overlap


class HRTFRenderer:
    """Streaming binaural renderer for one element (M2B/H2B equivalent)."""

    def __init__(self, layout: ChannelLayout, frame_size: int,
                 taps: int = 256, rate: int = 48000,
                 bank: np.ndarray | None = None):
        self.layout = layout
        self.frame_size = frame_size
        if bank is None:
            bank = hrir_bank(layout, taps, rate)  # [2, C, taps]
        else:
            bank = np.asarray(bank, np.float32)  # measured set
        self.taps = taps = bank.shape[2]
        n = fft_conv_len(frame_size + taps - 1)
        h = np.fft.rfft(bank, n=n, axis=2)
        self.H = jnp.asarray(np.stack([h.real, h.imag]).astype(np.float32))
        self.overlap = jnp.zeros((2, taps - 1), jnp.float32)

    def render(self, x) -> np.ndarray:
        """x: [C, T] speaker feeds (rendering order) -> [2, T] binaural."""
        out, self.overlap = _fft_conv_block(
            jnp.asarray(x), self.H, self.overlap, self.taps
        )
        return np.asarray(out)

    def reset(self) -> None:
        self.overlap = jnp.zeros((2, self.taps - 1), jnp.float32)
