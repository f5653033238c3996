"""Device-side AAC-LC synthesis filterbank (ISO/IEC 14496-3 4.6.11).

The host native decoder (native/src/aac/aac_frame.cc) runs the bit-serial
layers (Huffman sections/scalefactors/spectral data, stereo tools, TNS) and
exports post-TNS spectra; this module evaluates the filterbank on the device,
batched over frames x channels:

- IMDCT: one matmul per window size over all frames at once —
  [B*L, 1024] x [1024, 2048] for long windows, [B*L*8, 128] x [128, 256]
  for the EIGHT_SHORT sequence (both evaluated, selected by mask: shapes
  stay static and the short path is 1/4 the FLOPs of the long one).
- Windowing: the four window sequences x two shapes (sine/KBD) are eight
  constant 1024-vectors per half; each frame gathers its left half by
  (sequence, prev_shape) and right half by (sequence, shape).
- Overlap-add: out[b] = first_half[b] + second_half[b-1] — a pure shift
  along the frame axis (no scan), with a [L, 1024] carry crossing batch
  (and shard) boundaries.

Parity: matches the host filterbank to float rounding (validated in
tests/test_aac_native.py), and the end-to-end batched path matches the
fdk oracle >70 dB (tests/test_pipeline.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

FRAME = 1024
ONLY_LONG, LONG_START, EIGHT_SHORT, LONG_STOP = 0, 1, 2, 3


def _kbd_half(n: int, alpha: float) -> np.ndarray:
    """Kaiser-Bessel derived window first half (14496-3 4.6.11.3.3)."""
    j = np.arange(n + 1)
    x = 2.0 * j / n - 1.0
    arg = np.pi * alpha * np.sqrt(np.maximum(1.0 - x * x, 0.0))
    kern = np.i0(arg)
    return np.sqrt(np.cumsum(kern[:n]) / kern.sum())


def _sine_half(n: int) -> np.ndarray:
    return np.sin(np.pi / (2 * n) * (np.arange(n) + 0.5))


@functools.lru_cache(maxsize=None)
def _tables():
    long_half = np.stack([_sine_half(1024), _kbd_half(1024, 4.0)])  # [2,1024]
    short_half = np.stack([_sine_half(128), _kbd_half(128, 6.0)])   # [2,128]

    # long-path half windows per (sequence, shape): [4][2][1024]
    wl = np.zeros((4, 2, 1024))
    wr = np.zeros((4, 2, 1024))
    for sh in range(2):
        wl[ONLY_LONG, sh] = wl[LONG_START, sh] = long_half[sh]
        wl[LONG_STOP, sh] = np.concatenate(
            [np.zeros(448), short_half[sh], np.ones(448)])
        wr[ONLY_LONG, sh] = wr[LONG_STOP, sh] = long_half[sh][::-1]
        wr[LONG_START, sh] = np.concatenate(
            [np.ones(448), short_half[sh][::-1], np.zeros(448)])

    def imdct_basis(N):
        n0 = (N / 2 + 1) / 2.0
        n = np.arange(N)[:, None]
        k = np.arange(N // 2)[None, :]
        return ((2.0 / N)
                * np.cos(2.0 * np.pi / N * (n + n0) * (k + 0.5)))  # [N, N/2]

    # numpy (not device) constants: jit traces convert them per-trace, so
    # nothing cached here can leak a tracer across jit calls
    return dict(
        wl=np.asarray(wl, np.float32),
        wr=np.asarray(wr, np.float32),
        short_half=np.asarray(short_half, np.float32),
        b_long=np.asarray(imdct_basis(2048).T, np.float32),   # [1024, 2048]
        b_short=np.asarray(imdct_basis(256).T, np.float32),   # [128, 256]
    )


class SynthParams(NamedTuple):
    spec: jax.Array        # [B, L, 1024] post-TNS spectra (s16 scale)
    win_seq: jax.Array     # [B, L] int32: window_sequence
    shape: jax.Array       # [B, L] int32: window_shape
    prev_shape: jax.Array  # [B, L] int32: previous frame's window_shape


def init_carry(lanes: int) -> jax.Array:
    return jnp.zeros((lanes, FRAME), jnp.float32)


def _windowed_frames(p: SynthParams) -> jax.Array:
    """Per-frame windowed 2048-sample IMDCT output (pre-OLA)."""
    t = _tables()
    B, L, _ = p.spec.shape

    # long path
    tl = jnp.matmul(p.spec.reshape(B * L, 1024), t["b_long"],
                    precision=jax.lax.Precision.HIGHEST).reshape(B, L, 2048)
    wl = jnp.asarray(t["wl"])[p.win_seq, p.prev_shape]  # [B, L, 1024]
    wr = jnp.asarray(t["wr"])[p.win_seq, p.shape]
    frame_long = jnp.concatenate(
        [tl[..., :1024] * wl, tl[..., 1024:] * wr], axis=-1)

    # short path: 8 x 128-line IMDCTs, intra-frame OLA at offsets 448+128j
    ts = jnp.matmul(p.spec.reshape(B * L * 8, 128), t["b_short"],
                    precision=jax.lax.Precision.HIGHEST).reshape(
        B, L, 8, 256)
    sh = jnp.asarray(t["short_half"])
    sh_l = sh[p.shape]                         # [B, L, 128]
    sh_l0 = sh[p.prev_shape]                   # window 0 left half
    sh_r = sh_l[..., ::-1]
    frame_short = jnp.zeros((B, L, 2048), jnp.float32)
    for j in range(8):
        left = ts[:, :, j, :128] * (sh_l0 if j == 0 else sh_l)
        right = ts[:, :, j, 128:] * sh_r
        blk = jnp.concatenate([left, right], -1)
        frame_short = frame_short.at[
            ..., 448 + 128 * j: 448 + 128 * j + 256].add(blk)

    is_short = (p.win_seq == EIGHT_SHORT)[..., None]
    return jnp.where(is_short, frame_short, frame_long)


def pack_params(d: dict) -> np.ndarray:
    """Pack win_seq/shape/prev_shape into ONE [B, L, 3] int32 buffer, so
    the batch loop ships one bulk host-to-device buffer instead of three
    tiny ones."""
    return np.stack(
        [d["win_seq"], d["shape"], d["prev_shape"]], axis=-1
    ).astype(np.int32)


@jax.jit
def synthesize_packed(buf, carry: jax.Array):
    """synthesize() with ONE [B, L, 1027] input buffer: post-TNS spectra
    concatenated with pack_params' 3 small per-frame ints (exact in f32) —
    a single bulk h2d transfer per batch."""
    packed = buf[..., FRAME:].astype(jnp.int32)
    p = SynthParams(spec=buf[..., :FRAME], win_seq=packed[..., 0],
                    shape=packed[..., 1], prev_shape=packed[..., 2])
    return _synthesize(p, carry)


def _synthesize(p: SynthParams, carry: jax.Array):
    frames = _windowed_frames(p)
    first, second = frames[..., :FRAME], frames[..., FRAME:]
    prev = jnp.concatenate([carry[None], second[:-1]], axis=0)
    out = first + prev
    s16 = jnp.rint(jnp.clip(out, -32768.0, 32767.0))
    return s16 * (1.0 / 32768.0), second[-1]


@jax.jit
def synthesize(p: SynthParams, carry: jax.Array):
    """[B, L, 1024] PCM (s16-quantized, /32768 float) + next carry.

    The batch axis is consecutive frames per lane; overlap-add reduces to a
    shift along it (out[b] = first[b] + second[b-1], second[-1] -> carry).
    """
    return _synthesize(p, carry)


def reference_filterbank(spec, win_seq, shape, prev_shape, carry):
    """Numpy mirror for single-frame testing: spec [C, 1024], carry
    [C, 1024] -> (out [C, 1024] float s16-scale, carry)."""
    p = SynthParams(
        spec=jnp.asarray(spec[None], jnp.float32),
        win_seq=jnp.full((1, spec.shape[0]), win_seq, jnp.int32),
        shape=jnp.full((1, spec.shape[0]), shape, jnp.int32),
        prev_shape=jnp.full((1, spec.shape[0]), prev_shape, jnp.int32),
    )
    frames = np.asarray(_windowed_frames(p))[0]
    out = frames[:, :FRAME] + carry
    return out, frames[:, FRAME:]
