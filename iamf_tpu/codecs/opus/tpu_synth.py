"""Device-side CELT synthesis: the time-domain half of the Opus decoder.

The host native decoder (native/src/opus/) runs the serial bitstream layers
(range coding, PVQ, allocation, energy) and exports denormalised spectra via
``iamf_opus_decode_spectrum_batch2``; this module evaluates everything after
that on the device, batched over frames x channels:

- IMDCT (reference: celt/mdct.c clt_mdct_backward): one big matmul
  ``t = freq @ basis^T`` over all frames at once ([B,L,N] x [N,N] for any
  CELT frame size N in {120,240,480,960}); transient frames use the
  120-point basis batched over N/120 short blocks.
- TDAC overlap (celt/mdct.c window loop): the mirror only mixes each
  block's first 60 raw samples with the previous block's last 60 raw
  samples, so the whole frame chain is a pure shift along the frame axis —
  no scan needed.
- Post-filter (celt/celt.c comb_filter, celt_decoder.c:1055-1073): an IIR
  comb with lag >= 15. Processed in causal chunks of ``chunk`` samples
  (chunk <= min_period-2 guarantees every read lands in already-final
  output), each chunk fully vectorized over lanes. The three parameter
  sets (old at frame start, current, newly decoded) reproduce the
  reference's two comb passes: [0,120) old->cur crossfade (the only pass
  for 2.5 ms frames), [120,240) cur->new crossfade, [240,N) new.
- De-emphasis (celt/celt_decoder.c deemphasis, coef 0.85): first-order
  linear recurrence evaluated as a blocked lower-triangular matmul.
- Hybrid mode: the host-decoded (bit-exact) SILK half ships at s16 value
  scale and adds AFTER de-emphasis, exactly where opus_decoder.c adds
  pcm_silk to the celt output.
- s16 conversion (opus float2int16): clip + round-half-even.

Parity: bit-exact with the host synthesis except (a) de-emphasis block
accumulation order can differ from the sequential host loop by <=1 LSB
after s16 quantization, and (b) opus_pcm_soft_clip is the identity for
in-range signals and is not replicated (|x|>1 inputs hit the downstream
IAMF limiter anyway).
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                     "opus_tables.npz")

HIST = 1032  # > COMBFILTER_MAXPERIOD (1024) + 2, comb look-back window
MINPERIOD = 15
FRAME = 960
N_PARAMS = 13  # transient + 3x(period) + 3x(gain*taps triple)


@functools.lru_cache(maxsize=None)
def _tables():
    z = np.load(_DATA)
    return np.asarray(z["window120"], np.float32), np.asarray(
        z["gains"], np.float32)


@functools.lru_cache(maxsize=None)
def _basis(n2: int) -> np.ndarray:
    """IMDCT basis: t[m] = sum_k X[k] cos(2pi/N (m+N/2+.5)(k+.5))."""
    n = 2 * n2
    m = np.arange(n2)[:, None]
    k = np.arange(n2)[None, :]
    ang = 2.0 * np.pi / n * (m + n / 2.0 + 0.5) * (k + 0.5)
    return np.cos(ang).astype(np.float32)


class SynthParams(NamedTuple):
    """Per-frame synthesis inputs, [B] opus frames x [L] channel lanes."""

    freq: jax.Array       # [B, L, N] denormalised spectra (32768 scale)
    transient: jax.Array  # [B, L] bool
    t_old: jax.Array      # [B, L] int32 comb period at frame start (>=15)
    t_cur: jax.Array      # [B, L] int32 comb period decoded last frame
    t_new: jax.Array      # [B, L] int32 comb period decoded this frame
    g_old: jax.Array      # [B, L, 3] gain*taps at frame start
    g_cur: jax.Array      # [B, L, 3] gain*taps decoded last frame
    g_new: jax.Array      # [B, L, 3] gain*taps decoded this frame


class SynthCarry(NamedTuple):
    tail: jax.Array   # [L, 60] previous block's raw MDCT tail
    hist: jax.Array   # [L, HIST] post-filtered output history
    demem: jax.Array  # [L] de-emphasis memory


def init_carry(lanes: int) -> SynthCarry:
    return SynthCarry(
        tail=jnp.zeros((lanes, 60), jnp.float32),
        hist=jnp.zeros((lanes, HIST), jnp.float32),
        demem=jnp.zeros((lanes,), jnp.float32),
    )


def _imdct_overlap(freq, transient, tail0):
    """All-frames IMDCT + TDAC overlap. Returns (y [B,L,N], tail [L,60])."""
    B, L, n = freq.shape
    M = n // 120  # short blocks per frame (2^LM)
    w = jnp.asarray(_tables()[0])
    b_long = jnp.asarray(_basis(n))

    t_long = jnp.einsum("blk,mk->blm", freq, b_long,
                        preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST)

    i = jnp.arange(60)
    wl, wr = w[119 - i], w[i]  # window halves for the mirror

    if M > 1:
        b120 = jnp.asarray(_basis(120))
        # short blocks interleave with stride M: block j holds freq[j+M*k]
        fs = freq.reshape(B, L, 120, M).transpose(0, 1, 3, 2)
        t_short = jnp.einsum("bljk,mk->bljm", fs, b120,
                             preferred_element_type=jnp.float32,
                             precision=jax.lax.Precision.HIGHEST)
        tails_out = jnp.where(transient[..., None],
                              t_short[:, :, M - 1, 60:], t_long[..., n - 60:])
    else:
        t_short = None
        tails_out = t_long[..., n - 60:]
    tail_in = jnp.concatenate([tail0[None], tails_out[:-1]], axis=0)

    # long: y[0:60)=mirror, y[60:120)=mirror reversed, y[120:N)=raw
    th_l = t_long[..., :60][..., ::-1]  # t[59-i]
    y0_l = wl * tail_in - wr * th_l
    y1_l = (wl * th_l + wr * tail_in)[..., ::-1]
    # y[0:60)=mirror, y[60:120)=mirror reversed, y[120:n)=raw t[60:n-60)
    # (the last 60 raw samples are the tail carried into the next frame)
    y_long = jnp.concatenate([y0_l, y1_l, t_long[..., 60:n - 60]], axis=-1)

    if M > 1:
        # short: M blocks, block j mirrors against block j-1's raw tail
        pt = jnp.concatenate(
            [tail_in[:, :, None, :], t_short[:, :, :-1, 60:]],
            axis=2)  # [B,L,M,60]
        th_s = t_short[..., :60][..., ::-1]
        y0_s = wl * pt - wr * th_s
        y1_s = (wl * th_s + wr * pt)[..., ::-1]
        y_short = jnp.concatenate([y0_s, y1_s], axis=-1).reshape(B, L, n)
        y = jnp.where(transient[..., None], y_short, y_long)
    else:
        y = y_long
    return y, tails_out[-1]


def _comb_coeffs(p: SynthParams):
    """Per-sample comb lags/coefficients, [B,L,N,...], reproducing the
    celt_decoder.c comb schedule: pass 1 over [0,120) crossfades the
    frame-start ("old") params into the "current" set (comb_filter with
    overlap=120 — constant when the sets are equal, which LM>0 frames
    guarantee via the state rollover); pass 2 over [120,N) crossfades
    "current" into the newly decoded set over [120,240). 2.5 ms frames
    (N=120) run only pass 1."""
    w = jnp.asarray(_tables()[0])
    B, L, n = p.freq.shape
    pf = jnp.arange(n)
    in_a = pf < 120                      # pass 1: old -> cur
    in_tr = (pf >= 120) & (pf < 240)     # pass 2 crossfade region
    eq_oc = (p.t_old == p.t_cur) & jnp.all(p.g_old == p.g_cur, axis=-1)
    eq_cn = (p.t_cur == p.t_new) & jnp.all(p.g_cur == p.g_new, axis=-1)

    f = w * w  # crossfade factor over the transition window
    fa = jnp.concatenate([f, jnp.zeros(n - 120)])[None, None, :]
    fb = jnp.concatenate([jnp.zeros(120), f,
                          jnp.zeros(max(n - 240, 0))])[None, None, :n]
    go = p.g_old[:, :, None, :]
    gc = p.g_cur[:, :, None, :]
    gn = p.g_new[:, :, None, :]
    cross_a = (in_a & ~eq_oc[..., None])[..., None]
    cross_b = (in_tr & ~eq_cn[..., None])[..., None]
    c1 = jnp.where(in_a[..., None],
                   jnp.where(cross_a, (1.0 - fa)[..., None] * go, gc),
                   jnp.where(cross_b, (1.0 - fb)[..., None] * gc, gn))
    c2 = jnp.where(cross_a, fa[..., None] * gc,
                   jnp.where(cross_b, fb[..., None] * gn,
                             jnp.zeros_like(gn)))
    to = p.t_old[..., None]
    tc = p.t_cur[..., None]
    tn = p.t_new[..., None]
    lag1 = jnp.where(in_a, jnp.where(in_a & ~eq_oc[..., None], to, tc),
                     jnp.where(in_tr & ~eq_cn[..., None], tc, tn))
    lag2 = jnp.where(in_a & ~eq_oc[..., None], tc,
                     jnp.where(in_tr & ~eq_cn[..., None], tn, lag1))
    return c1, c2, lag1, lag2


def _comb_filter(y, hist, c1, c2, lag1, lag2, chunk: int):
    """Chunked causal comb over the flattened signal. y:[L,T], hist:[L,HIST].
    chunk <= min(active lag)-2 so every read is from finalized output."""
    L, T = y.shape
    pad = (-T) % chunk
    if pad:
        zpadc = lambda a: jnp.pad(a, [(0, 0), (0, pad)] + [(0, 0)] *
                                  (a.ndim - 2))
        y, c1, c2 = jnp.pad(y, ((0, 0), (0, pad))), zpadc(c1), zpadc(c2)
        lag1 = jnp.pad(lag1, ((0, 0), (0, pad)), constant_values=FRAME)
        lag2 = jnp.pad(lag2, ((0, 0), (0, pad)), constant_values=FRAME)
    buf = jnp.concatenate([hist, y], axis=1)
    nchunks = y.shape[1] // chunk

    def body(s, buf):
        pos = s * chunk
        idx = HIST + pos + jnp.arange(chunk)[None, :]
        l1 = jax.lax.dynamic_slice(lag1, (0, pos), (L, chunk))
        l2 = jax.lax.dynamic_slice(lag2, (0, pos), (L, chunk))
        k1 = jax.lax.dynamic_slice(c1, (0, pos, 0), (L, chunk, 3))
        k2 = jax.lax.dynamic_slice(c2, (0, pos, 0), (L, chunk, 3))
        xi = jax.lax.dynamic_slice(buf, (0, HIST + pos), (L, chunk))
        g = lambda lag, d: jnp.take_along_axis(buf, idx - lag + d, axis=1)
        # term order matches comb_filter's summation exactly
        out = (xi + k1[..., 0] * g(l1, 0)
               + k1[..., 1] * (g(l1, 1) + g(l1, -1))
               + k1[..., 2] * (g(l1, 2) + g(l1, -2))
               + k2[..., 0] * g(l2, 0)
               + k2[..., 1] * (g(l2, 1) + g(l2, -1))
               + k2[..., 2] * (g(l2, 2) + g(l2, -2)))
        return jax.lax.dynamic_update_slice(buf, out, (0, HIST + pos))

    buf = jax.lax.fori_loop(0, nchunks, body, buf)
    return buf[:, HIST:HIST + T]


@functools.lru_cache(maxsize=None)
def _deemph_mats(K: int):
    """Blocked de-emphasis constants for block size K (float64 -> f32):
    PT[r, k] = 0.85^(k-r) for r <= k (transposed lower-tri power matrix),
    pw_shift[k] = 0.85^k, aK = 0.85^K (block-to-block memory weight)."""
    k = np.arange(K, dtype=np.float64)
    P = np.where(k[:, None] >= k[None, :],
                 0.85 ** (k[:, None] - k[None, :]), 0.0)
    return (np.ascontiguousarray(P.T).astype(np.float32),
            (0.85 ** k).astype(np.float32),
            float(np.float32(0.85 ** K)))


def _deemphasis(z, m0):
    """out[j] = z[j] + 1e-30 + m[j-1]; m[j] = 0.85*out[j].

    Linearized (as before): m[j] = b[j] + 0.85*m[j-1], b = 0.85*(z+1e-30).
    Evaluated as a blocked lower-triangular matmul (one einsum over
    [L, nb, K] blocks) instead of a length-N scan: a 122880-sample
    associative_scan made the fused decode program's XLA optimization
    blow up, and a per-sample scan is a sequential loop on any
    accelerator. With block size K = 960,
    0.85^K underflows float32 to exactly 0, so the block-entry memory
    chain degenerates to a shift — no sequential dependency remains.
    Rounding differs from the sequential host loop by the dot-product
    accumulation order; observed <= 1 LSB after s16 quantization (same
    class as the previous associative_scan)."""
    L, N = z.shape
    K = 960 if N % 960 == 0 else min(N, 960)
    b = 0.85 * (z + 1e-30)
    pad = (-N) % K
    if pad:
        b = jnp.pad(b, ((0, 0), (0, pad)))
    nb = b.shape[1] // K
    PT, pw_shift, aK = _deemph_mats(K)
    bb = b.reshape(L, nb, K)
    # u[i, k] = sum_{r<=k} 0.85^(k-r) b[i, r]  (zero-entry within-block m)
    u = jnp.einsum("lnr,rk->lnk", bb, jnp.asarray(PT),
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    u_last = u[:, :, K - 1]  # [L, nb]
    if aK == 0.0:
        # block memory e[i] = u_last[i-1] + aK*e[i-1] collapses to a shift
        e = jnp.concatenate([m0[:, None], u_last[:, :-1]], axis=1)
    else:
        # small-K path (short frames/signals): first-order recurrence over
        # nb block scalars — a tiny log-depth scan
        av = jnp.full((L, nb), aK, jnp.float32).at[:, 0].set(1.0)
        c = jnp.concatenate([m0[:, None], u_last[:, :-1]], axis=1)

        def op(x, yv):
            return (x[0] * yv[0], x[1] * yv[0] + yv[1])

        _, e = jax.lax.associative_scan(op, (av, c), axis=1)
    # out[i, k] = z + 1e-30 + m[i, k-1];  m[i, k-1] = u[i, k-1] + 0.85^k e[i]
    u_shift = jnp.concatenate(
        [jnp.zeros((L, nb, 1), jnp.float32), u[:, :, :-1]], axis=2)
    m_prev = u_shift + jnp.asarray(pw_shift)[None, None, :] * e[:, :, None]
    out = (z + 1e-30) + m_prev.reshape(L, nb * K)[:, :N]
    # final memory at the true last sample (pad rows are junk)
    i0, k0 = (N - 1) // K, (N - 1) % K
    demem = u[:, i0, k0] + np.float32(0.85 ** (k0 + 1)) * e[:, i0]
    return out, demem


# Packed-buffer column layout after the N spectrum columns (written by
# pack_params, read by _unpack, and used by the sharded decoder's neutral
# lane padding). Offsets are relative to the spectrum width N; the module
# constants give the absolute columns for the N=960 CELT layout the
# sharded decoder pins. Hybrid rows append N more columns of host-decoded
# SILK pcm (s16 value scale) after the parameter block.
PK_TRANSIENT = 0
PK_T_OLD = 1
PK_T_CUR = 2
PK_T_NEW = 3
PK_G_OLD = 4   # 3 columns
PK_G_CUR = 7   # 3 columns
PK_G_NEW = 10  # 3 columns
PACKED_TRANSIENT = FRAME + PK_TRANSIENT
PACKED_T_OLD = FRAME + PK_T_OLD
PACKED_T_CUR = FRAME + PK_T_CUR
PACKED_T_NEW = FRAME + PK_T_NEW
PACKED_G_OLD = FRAME + PK_G_OLD
PACKED_G_CUR = FRAME + PK_G_CUR
PACKED_G_NEW = FRAME + PK_G_NEW


def packed_width(n: int, hybrid: bool) -> int:
    """Total packed-row width for frame size n: spectrum + params
    (+ SILK pcm for hybrid)."""
    return n + N_PARAMS + (n if hybrid else 0)


def pack_params(d: dict) -> np.ndarray:
    """Pack the per-frame entropy outputs into ONE [B, L, 13] float32
    block (transient, t_old/cur/new, g_old/cur/new[3 each]), so the batch
    loop ships one bulk host-to-device buffer instead of several tiny ones.
    Periods are <= 1024 and
    gains are Q15-derived — exact in float32."""
    B, L = d["transient"].shape
    out = np.empty((B, L, N_PARAMS), np.float32)
    out[..., PK_TRANSIENT] = d["transient"]
    out[..., PK_T_OLD] = d["t_old"]
    out[..., PK_T_CUR] = d["t_cur"]
    out[..., PK_T_NEW] = d["t_new"]
    out[..., PK_G_OLD:PK_G_OLD + 3] = d["g_old"]
    out[..., PK_G_CUR:PK_G_CUR + 3] = d["g_cur"]
    out[..., PK_G_NEW:PK_G_NEW + 3] = d["g_new"]
    return out


def _unpack(buf, n: int):
    """[B, L, packed_width] buffer -> (SynthParams, silk | None)."""
    freq = buf[..., :n]
    pk = buf[..., n:n + N_PARAMS]
    p = SynthParams(
        freq=freq,
        transient=pk[..., PK_TRANSIENT] != 0,
        t_old=pk[..., PK_T_OLD].astype(jnp.int32),
        t_cur=pk[..., PK_T_CUR].astype(jnp.int32),
        t_new=pk[..., PK_T_NEW].astype(jnp.int32),
        g_old=pk[..., PK_G_OLD:PK_G_OLD + 3],
        g_cur=pk[..., PK_G_CUR:PK_G_CUR + 3],
        g_new=pk[..., PK_G_NEW:PK_G_NEW + 3],
    )
    silk = buf[..., n + N_PARAMS:] if buf.shape[-1] > n + N_PARAMS else None
    return p, silk


def unpack_buf(buf) -> SynthParams:
    """[B, L, 973] packed CELT-960 buffer -> SynthParams (sharded path)."""
    return _unpack(buf, FRAME)[0]


@functools.partial(jax.jit, static_argnames=("chunk", "n", "hybrid"))
def synthesize_packed(buf, carry: SynthCarry, chunk: int = 104,
                      n: int | None = None, hybrid: bool = False):
    """synthesize() with ONE packed input buffer per batch — a single bulk
    h2d transfer (see pack_params): [B, L, n+13] CELT or [B, L, 2n+13]
    hybrid (SILK pcm appended). n defaults to the CELT-only width
    (buf_width - 13); hybrid layouts must pass n explicitly — the width
    alone is ambiguous (CELT-960 and hybrid-480 are both 973 wide)."""
    if n is None:
        n = buf.shape[-1] - N_PARAMS
    p, silk = _unpack(buf, n)
    return _synthesize(p, carry, chunk, silk if hybrid else None)


@functools.partial(jax.jit, static_argnames=("chunk",))
def synthesize(p: SynthParams, carry: SynthCarry, chunk: int = 104):
    """Full device synthesis. Returns (pcm [B,L,N] float in [-1,1] at s16
    granularity, new carry).

    The comb always runs — zero coefficients are an exact identity — so the
    only compile variants are (B, L, N, chunk)."""
    return _synthesize(p, carry, chunk)


def _synthesize(p: SynthParams, carry: SynthCarry, chunk: int = 104,
                silk=None):
    B, L, n = p.freq.shape
    y, tail = _imdct_overlap(p.freq, p.transient, carry.tail)
    sig = y.transpose(1, 0, 2).reshape(L, B * n)
    c1, c2, lag1, lag2 = _comb_coeffs(p)
    flat = lambda a: a.transpose(1, 0, 2, *range(3, a.ndim)).reshape(
        (L, B * n) + a.shape[3:])
    z = _comb_filter(sig, carry.hist, flat(c1), flat(c2),
                     flat(lag1), flat(lag2), chunk)
    hist = z[:, -HIST:] if B * n >= HIST else jnp.concatenate(
        [carry.hist, z], axis=1)[:, -HIST:]
    out, demem = _deemphasis(z, carry.demem)
    if silk is not None:
        # hybrid: host-decoded SILK half (s16 value scale — the same scale
        # as the de-emphasis output) adds after the celt synthesis,
        # opus_decoder.c "pcm[i] += pcm_silk[i]"
        out = out + silk.transpose(1, 0, 2).reshape(L, B * n)
    s16 = jnp.rint(jnp.clip(out, -32768.0, 32767.0))
    pcm = (s16 * (1.0 / 32768.0)).reshape(L, B, n).transpose(1, 0, 2)
    return pcm, SynthCarry(tail=tail, hist=hist, demem=demem)


def shard_stages(buf, preroll: int):
    """Shard-parallel half of the synthesis (parallel/sharded_decoder.py).

    Runs the IMDCT + TDAC overlap on [preroll + F] frames and drops the
    preroll rows: the TDAC mirror only mixes a block's first 60 samples
    with the PREVIOUS block's raw tail, so one preroll frame makes every
    kept frame's overlap exact with a zero tail carry. Returns the kept
    frames' flattened signal [L, F*960] plus the comb coefficient tensors
    for those frames; the comb + de-emphasis IIRs carry state across the
    whole timeline and run in the sharded decoder's exact ppermute chain
    (comb_deemph below) — preroll re-decode does NOT converge them in
    general (the post-filter decay is g^(t/period); measured 462-LSB
    residual after 6 frames on period-652 content).
    """
    p = unpack_buf(buf)
    L = p.freq.shape[1]
    y, _ = _imdct_overlap(p.freq, p.transient,
                          jnp.zeros((L, 60), jnp.float32))
    y = y[preroll:]
    own = SynthParams(*(a[preroll:] for a in p))
    c1, c2, lag1, lag2 = _comb_coeffs(own)
    B = y.shape[0]
    sig = y.transpose(1, 0, 2).reshape(L, B * FRAME)
    flat = lambda a: a.transpose(1, 0, 2, *range(3, a.ndim)).reshape(
        (L, B * FRAME) + a.shape[3:])
    return sig, (flat(c1), flat(c2), flat(lag1), flat(lag2))


def comb_deemph(sig, coeffs, hist, demem, chunk: int):
    """Sequential tail of the synthesis for one shard's flattened signal:
    comb post-filter + de-emphasis, with explicit (hist, demem) carry.
    Returns (pcm [L, N] float at s16 granularity, hist', demem')."""
    c1, c2, lag1, lag2 = coeffs
    z = _comb_filter(sig, hist, c1, c2, lag1, lag2, chunk)
    N = z.shape[1]
    hist2 = z[:, -HIST:] if N >= HIST else jnp.concatenate(
        [hist, z], axis=1)[:, -HIST:]
    out, demem2 = _deemphasis(z, demem)
    s16 = jnp.rint(jnp.clip(out, -32768.0, 32767.0))
    return s16 * (1.0 / 32768.0), hist2, demem2


def pick_chunk(min_period: int) -> int:
    """Largest chunk <= min_period-2, capped at 104 so typical content maps
    to a single compile variant (each variant recompiles; see synthesize)."""
    lim = max(MINPERIOD, int(min_period)) - 2
    for c in (104, 52, 26, 13):
        if c <= lim:
            return c
    return 13
