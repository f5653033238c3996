"""Arbitrary-ratio polyphase sinc resampler, speexdsp-parity.

The reference vendors the public Speex/speexdsp resampler (resample.c) and
uses quality 4 whenever the stream rate differs from the requested output
rate (IAMF_decoder.c:57, :3193-3199). This is a faithful reimplementation of
that algorithm (same filter design, same streaming state machine), verified
output-for-output against the reference build in tests/test_resample.py:

- filter design (resample.c update_filter :530-610): Kaiser-windowed sinc,
  quality-mapped base length/oversample/bandwidth; direct mode (per-phase
  table) when den_rate is small, else interpolated mode (oversampled table
  + cubic interpolation, resampler_basic_interpolate :429-477).
- Kaiser window tables: analytic I0 Kaiser samples at k/oversample rounded
  to the published precision; speexdsp hand-smooths four tail entries
  (public speexdsp constants, patched below to match).
- streaming (speex_resampler_process_float :920-970): filt_len-1 samples of
  per-channel history, last_sample/samp_frac_num stepping, [-1,1] output
  clamp (FLTADJUST), skip_zeros initial latency drop (:1115-1119).

Device note: the inner product is a gathered-window matmul; the decoder calls
this on the host (it only runs when rates mismatch, a cold path), but the
same bank/gather formulation drops into the device pipeline if needed.
"""

from __future__ import annotations

import functools
import math

import numpy as np

import jax
import jax.numpy as jnp


def _i0(x):
    # numpy lacks scipy on some targets; np.i0 is fine (double precision)
    return np.i0(x)


def _kaiser_table(beta: float, n_entries: int, ovs: int) -> np.ndarray:
    t = np.zeros(n_entries, np.float64)
    for idx in range(n_entries):
        x = (idx - 1) / ovs
        if abs(x) <= 1.0:
            t[idx] = round(
                float(_i0(beta * math.sqrt(max(0.0, 1 - x * x))) / _i0(beta)),
                8,
            )
    return t


def _tables():
    k12 = _kaiser_table(12.0, 68, 64)
    k10 = _kaiser_table(10.0, 36, 32)
    k8 = _kaiser_table(8.0, 36, 32)
    k6 = _kaiser_table(6.0, 36, 32)
    # speexdsp hand-smooths the window tails (published speexdsp constants;
    # the analytic window is exactly 0 past x=1)
    k12[65] = 0.0000527734
    k12[66] = 0.00001
    k8[34] = 0.0005
    k6[34] = 0.00752
    return {"k12": (k12, 64), "k10": (k10, 32), "k8": (k8, 32),
            "k6": (k6, 32)}


_WINDOWS = None

# quality -> (base_length, oversample, downsample_bw, upsample_bw, window)
_QUALITY_MAP = {
    0: (8, 4, 0.830, 0.860, "k6"),
    1: (16, 4, 0.850, 0.880, "k6"),
    2: (32, 4, 0.882, 0.910, "k6"),
    3: (48, 8, 0.895, 0.917, "k8"),
    4: (64, 8, 0.921, 0.940, "k8"),
    5: (80, 16, 0.922, 0.940, "k10"),
    6: (96, 16, 0.940, 0.945, "k10"),
    7: (128, 16, 0.950, 0.950, "k10"),
    8: (160, 16, 0.960, 0.960, "k10"),
    9: (192, 32, 0.968, 0.968, "k12"),
    10: (256, 32, 0.975, 0.975, "k12"),
}


def _compute_func(x: float, table: np.ndarray, ovs: int) -> float:
    """Cubic interpolation over the window table (double precision)."""
    y = np.float32(x) * np.float32(ovs)
    ind = int(math.floor(y))
    frac = float(np.float32(y - ind))
    i3 = -0.1666666667 * frac + 0.1666666667 * frac ** 3
    i2 = frac + 0.5 * frac * frac - 0.5 * frac ** 3
    i0c = -0.3333333333 * frac + 0.5 * frac * frac - 0.1666666667 * frac ** 3
    i1 = 1.0 - i3 - i2 - i0c
    return (i0c * table[ind] + i1 * table[ind + 1] + i2 * table[ind + 2]
            + i3 * table[ind + 3])


def _sinc(cutoff: float, x: float, N: int, table, ovs) -> np.float32:
    xx = np.float32(x) * np.float32(cutoff)
    if abs(x) < 1e-6:
        return np.float32(cutoff)
    if abs(x) > 0.5 * N:
        return np.float32(0.0)
    return np.float32(
        cutoff * math.sin(math.pi * float(xx)) / (math.pi * float(xx))
        * _compute_func(abs(2.0 * np.float32(x) / N), table, ovs)
    )


def _cubic_coef(frac: np.ndarray):
    """resample.c cubic_coef (float32)."""
    f = frac.astype(np.float32)
    i0c = np.float32(-0.16667) * f + np.float32(0.16667) * f * f * f
    i1 = f + np.float32(0.5) * f * f - np.float32(0.5) * f * f * f
    i3 = (np.float32(-0.33333) * f + np.float32(0.5) * f * f
          - np.float32(0.16667) * f * f * f)
    i2 = (np.float64(1.0) - i0c - i1 - i3).astype(np.float32)
    return i0c, i1, i2, i3


class Resampler:
    """Streaming rational resampler, speexdsp-parity at a given quality."""

    def __init__(self, channels: int, in_rate: int, out_rate: int,
                 quality: int = 4):
        global _WINDOWS
        if _WINDOWS is None:
            _WINDOWS = _tables()
        self.channels = channels
        self.in_rate = in_rate
        self.out_rate = out_rate
        g = math.gcd(in_rate, out_rate)
        self.num = in_rate // g
        self.den = out_rate // g
        base_len, ovs, down_bw, up_bw, wname = _QUALITY_MAP[quality]
        table, wovs = _WINDOWS[wname]
        self.oversample = ovs
        if self.num > self.den:  # downsampling
            self.cutoff = float(
                np.float32(np.float32(down_bw) * self.den) / np.float32(self.num))
            fl = (base_len % self.den) * self.num // self.den + (
                base_len // self.den) * self.num
            self.filt_len = ((fl - 1) & ~0x7) + 8
            for k in (2, 4, 8, 16):
                if k * self.den < self.num:
                    self.oversample >>= 1
            self.oversample = max(self.oversample, 1)
        else:
            self.cutoff = up_bw
            self.filt_len = base_len
        N = self.filt_len
        self.direct = N * self.den <= N * self.oversample + 8
        if self.direct:
            bank = np.zeros((self.den, N), np.float32)
            for i in range(self.den):
                for j in range(N):
                    bank[i, j] = _sinc(
                        self.cutoff,
                        (j - N // 2 + 1) - np.float32(i) / self.den,
                        N, table, wovs)
            self.bank = bank
        else:
            n = self.oversample * N + 8
            tab = np.zeros(n, np.float32)
            for i in range(-4, self.oversample * N + 4):
                tab[i + 4] = _sinc(self.cutoff,
                                   i / np.float32(self.oversample) - N // 2,
                                   N, table, wovs)
            self.table = tab

        self.int_advance = self.num // self.den
        self.frac_advance = self.num % self.den
        self.mem = np.zeros((channels, N - 1), np.float32)
        # skip_zeros applied at open, as the decoder does (IAMF_decoder.c:1901)
        self.last_sample = N // 2
        self.samp_frac_num = 0

    @property
    def input_latency(self) -> int:
        return self.filt_len // 2

    @property
    def output_latency(self) -> int:
        return (self.input_latency * self.den + self.samp_frac_num
                ) // self.num

    def process(self, x: np.ndarray) -> np.ndarray:
        """x: [channels, T] float32 -> [channels, T_out] (FLTADJUST clamped)."""
        x = np.asarray(x, np.float32)
        T = x.shape[1]
        buf = np.concatenate([self.mem, x], axis=1)
        N = self.filt_len
        # step positions until last_sample >= T
        ls, frac = self.last_sample, self.samp_frac_num
        positions, fracs = [], []
        while ls < T:
            positions.append(ls)
            fracs.append(frac)
            ls += self.int_advance
            frac += self.frac_advance
            if frac >= self.den:
                frac -= self.den
                ls += 1
        if positions:
            pos = np.asarray(positions)
            idx = pos[:, None] + np.arange(N)[None, :]
            windows = buf[:, idx]  # [C, n, N]
            ph = np.asarray(fracs)
            if self.direct:
                # direct_single: float accumulation (float64 here; <=1 ulp)
                out = np.einsum("cnf,nf->cn", windows.astype(np.float64),
                                self.bank[ph].astype(np.float64))
                out = out.astype(np.float32)
            else:
                # interpolate_single: 4 double accumulators + cubic mix
                offs = ph * self.oversample // self.den
                fr = ((ph * self.oversample) % self.den).astype(
                    np.float32) / np.float32(self.den)
                j = np.arange(N)
                base = 4 + (j[None, :] + 1) * self.oversample - offs[:, None]
                acc = [
                    np.einsum("cnf,nf->cn", windows.astype(np.float64),
                              self.table[base + (k - 2)].astype(np.float64))
                    for k in range(4)
                ]
                c0, c1, c2, c3 = _cubic_coef(fr)
                out = (c0[None] * acc[0] + c1[None] * acc[1]
                       + c2[None] * acc[2] + c3[None] * acc[3]
                       ).astype(np.float32)
            out = np.clip(out, -1.0, 1.0)  # FLTADJUST
        else:
            out = np.zeros((self.channels, 0), np.float32)
        consumed = min(ls, T)
        self.last_sample = ls - consumed
        self.samp_frac_num = frac
        self.mem = buf[:, consumed:consumed + N - 1].copy()
        return out

    def drain(self) -> np.ndarray:
        """Flush latency with zero input (iamf_resample rest_flag==2 path,
        IAMF_decoder.c:3224-3247)."""
        zeros = np.zeros((self.channels, self.input_latency), np.float32)
        return self.process(zeros)


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def _resample_scan(N, n_in, n_keep, win_start, W, chunks):
    """One lax.scan over [n_steps, C, in_chunk] chunks -> [n_steps, C,
    out_chunk] blocks (block b emitted at step b+1); module-level jit so
    every instance for the same rate pair shares one compiled program."""

    def step(carry, x_t):
        buf = jnp.concatenate([carry, x_t], axis=1)
        idx = win_start[:, None] + jnp.arange(N)[None, :]
        windows = buf[:, idx]  # [C, out_chunk, N]
        y = jnp.einsum("cof,of->co", windows, W,
                       precision=jax.lax.Precision.HIGHEST)
        y = jnp.clip(y, -1.0, 1.0)  # FLTADJUST
        return buf[:, n_in:n_in + n_keep], y

    C = chunks.shape[1]
    init = jnp.zeros((C, n_keep), jnp.float32)
    return jax.lax.scan(step, init, chunks)[1]


class DeviceResampler:
    """Device streaming resampler: the polyphase FIR as a gathered-
    window einsum inside a lax.scan, with an overlap-save input carry
    (SURVEY §2.3.6: "Speex resampler -> polyphase FIR as strided conv with
    overlap-save").

    Structure: the output grid is affine in the output index j —
    window-end input position P(j) = N/2 + (num*j)//den with phase
    (num*j) % den — so a chunk of num*Q input samples always yields
    exactly den*Q outputs with chunk-invariant local indices/phases.
    The per-output filter row (direct-mode bank row, or the interpolated
    table rows pre-mixed with the cubic coefficients) is a host-
    precomputed [den*Q, N] constant; each scan step gathers [C, den*Q, N]
    windows from (carry ++ chunk) and contracts against it on device.
    Matches the host speexdsp-parity Resampler within float accumulation
    order (<= 1e-6 relative; quantized PCM <= 1 LSB), one compiled
    program per rate pair.
    """

    def __init__(self, channels: int, in_rate: int, out_rate: int,
                 quality: int = 4, target_chunk: int = 8192):
        host = Resampler(channels, in_rate, out_rate, quality)
        self.host_params = host
        self.channels = channels
        N = host.filt_len
        num, den = host.num, host.den
        self.num, self.den, self.N = num, den, N
        Q = max(1, target_chunk // num)
        self.in_chunk = num * Q
        self.out_chunk = den * Q

        l = np.arange(self.out_chunk)
        ph = (num * l) % den
        self.win_start = ((num * l) // den).astype(np.int32)  # [out_chunk]
        if host.direct:
            W = host.bank[ph]  # [out_chunk, N]
        else:
            offs = (ph * host.oversample // den).astype(np.int64)
            fr = ((ph * host.oversample) % den).astype(
                np.float32) / np.float32(den)
            j = np.arange(N)
            base = 4 + (j[None, :] + 1) * host.oversample - offs[:, None]
            c0, c1, c2, c3 = _cubic_coef(fr)
            t = host.table.astype(np.float64)
            W = (c0[:, None] * t[base - 2] + c1[:, None] * t[base - 1]
                 + c2[:, None] * t[base] + c3[:, None] * t[base + 1])
        self.W = np.asarray(W, np.float32)

        # carry covers the previous chunk plus the filter history the first
        # output window reaches back into (see window algebra above)
        self.carry_len = self.in_chunk + N - 1 - N // 2

        self._win_start = np.asarray(self.win_start)
        # module-level jit keyed on the static shape config so every
        # DeviceResampler instance for the same rate pair shares ONE
        # compiled program (a per-instance lambda would recompile per
        # decoder)
        self._scan = lambda chunks: _resample_scan(
            N, self.in_chunk, self.carry_len,
            jnp.asarray(self._win_start), jnp.asarray(self.W), chunks)

    def n_out(self, T: int) -> int:
        """Total outputs for T input samples + latency drain — identical to
        the host Resampler's process(x) + drain() output count."""
        return -(-T * self.den // self.num)

    def resample_stream(self, x) -> "jax.Array":
        """x: [C, T] float32 (device or host) -> [C, n_out(T)] on device,
        latency-compensated (skip_zeros head drop + zero-input drain) —
        the decoder-facing contract (iamf_resample + flush drain)."""
        import jax.numpy as jnp

        x = jnp.asarray(x, jnp.float32)
        T = x.shape[1]
        want = self.n_out(T)
        # output block b is emitted at scan step b+1 (its last windows read
        # a few samples into the next chunk), so scan one zero-padded chunk
        # past the last block; the zero tail doubles as the latency drain
        n_blocks = -(-want // self.out_chunk)
        n_steps = n_blocks + 1
        pad = n_steps * self.in_chunk - T
        x = jnp.pad(x, ((0, 0), (0, pad)))
        chunks = x.T.reshape(n_steps, self.in_chunk, self.channels
                             ).transpose(0, 2, 1)  # [n, C, in_chunk]
        ys = self._scan(chunks)  # [n, C, out_chunk]; step 0 emits nothing
        y = ys[1:].transpose(1, 0, 2).reshape(self.channels, -1)
        return y[:, :want]
