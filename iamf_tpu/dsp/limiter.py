"""Look-ahead peak limiter on the device (reference: audio_effect_peak_limiter.c).

Algorithm (process_block :94-201): per sample k,
  1. peak = max of the look-ahead peak ring buffer (windowed max over the
     last `delay_size` inserted channel-max magnitudes)
  2. gain = attack/release parabolic envelope state machine
     (compute_target_gain :237-265, curve_accel :267-271); a new peak above
     threshold retriggers the attack from the current gain
  3. output = delayed sample * gain; insert current sample into delay line
     and its channel-max magnitude into the peak ring
First call swallows `delay_size` padding samples (:185-201).

The recurrence is strictly sequential per sample -> `jax.lax.scan` with the
(gain state, rings, index) carry. Channels are vectorized inside the step.
A fast path skips the scan when the whole block + ring is below threshold and
the envelope is idle (gain == 1 passthrough of the delay line) — the common
case for normalized content, turning the limiter into a roll + max.

Defaults: threshold -1 dBTP, attack 1 ms, release 200 ms, look-ahead 240
samples (audio_defines.h:40-43).

True-peak mode (`USE_TRUEPEAK` compile gate, audio_effect_peak_limiter.h:38,
process_block :150-166): the only difference from the sample-peak mode is
that the per-channel magnitude fed into the look-ahead peak ring is
|audio_true_peak_meter_next_true_peak(x_k)| — a 4x-oversampled inter-sample
peak estimate of the incoming sample stream — instead of |x_k|. The
reference repo declares the meter (`#include "audio_true_peak_meter.h"`)
but ships NO implementation of it anywhere in the tree (and hardcodes the
gate to 0), so the branch is not buildable upstream; this module supplies a
BS.1770-4-style meter — a 48-tap 4-phase windowed-sinc interpolation FIR,
per-phase DC-normalized — and the differential oracle
(tests/test_limiter_truepeak.py) compiles the reference's
audio_effect_peak_limiter.c verbatim with the gate flipped on and a C meter
generated from THESE coefficients, pinning the integration semantics.

In this formulation the meter is a causal FIR over the input block, so it
vectorizes entirely outside the per-sample gain scan: peaks_in[t] =
max over channels and phases of |sum_i h_phase[i] * x[t-i]| with an
11-sample cross-block history carry; the scan itself is unchanged.
"""

from __future__ import annotations

import dataclasses
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

LIMITER_THRESHOLD_DB = -1.0
LIMITER_ATTACK_SEC = 0.001
LIMITER_RELEASE_SEC = 0.200
LIMITER_LOOKAHEAD = 240

TP_PHASES = 4    # 4x oversampling (BS.1770-4 Annex 2 true-peak design)
TP_TAPS = 12     # taps per phase (48-tap prototype)
TP_HIST = TP_TAPS - 1


@functools.lru_cache(maxsize=None)
def truepeak_filters() -> np.ndarray:
    """[TP_PHASES, TP_TAPS] float32 polyphase interpolation filters.

    Prototype: 48-tap Hann-windowed sinc at 1/4 band (the 4x-oversampling
    interpolator of a BS.1770-4-style true-peak meter). Phase j holds taps
    h[4i+j] applied to x[n-i]; each phase is normalized to unit DC gain so
    a full-scale DC input meters exactly full scale. The reference ships no
    meter source (see module docstring), so these coefficients are the
    repo's own design — the C differential oracle is generated from this
    exact table (emit_truepeak_c_table)."""
    L = TP_PHASES * TP_TAPS
    n = np.arange(L, dtype=np.float64)
    c = (L - 1) / 2.0
    proto = np.sinc((n - c) / TP_PHASES) * np.hanning(L)
    phases = np.empty((TP_PHASES, TP_TAPS), np.float64)
    for j in range(TP_PHASES):
        phases[j] = proto[j::TP_PHASES]
        phases[j] /= phases[j].sum()
    return phases.astype(np.float32)


def emit_truepeak_c_table() -> str:
    """C initializer for the phase table — the differential-test oracle
    compiles its meter from this string, guaranteeing identical constants
    on both sides of the diff."""
    h = truepeak_filters()
    rows = ",\n".join(
        "  {" + ", ".join(f"{v:.9e}f" for v in row) + "}" for row in h)
    return ("static const float TP_PHASES_TAB[%d][%d] = {\n%s\n};\n"
            % (TP_PHASES, TP_TAPS, rows))


@dataclasses.dataclass(frozen=True)
class LimiterConfig:
    threshold_db: float = LIMITER_THRESHOLD_DB
    sample_rate: int = 48000
    channels: int = 2
    attack_sec: float = LIMITER_ATTACK_SEC
    release_sec: float = LIMITER_RELEASE_SEC
    delay_size: int = LIMITER_LOOKAHEAD
    true_peak: bool = False  # USE_TRUEPEAK branch (see module docstring)

    @property
    def linear_threshold(self) -> float:
        return float(10.0 ** (self.threshold_db / 20.0))

    @property
    def inc_tc(self) -> float:
        return 1.0 / self.sample_rate


def init_state(cfg: LimiterConfig) -> dict:
    """Carry pytree. `init`/`padsize` (first-call swallow) are host-side."""
    state = {
        "current_gain": jnp.float32(1.0),
        "target_start_gain": jnp.float32(-1.0),
        "target_end_gain": jnp.float32(-1.0),
        "current_tc": jnp.float32(-1.0),
        "delay_data": jnp.zeros((cfg.channels, cfg.delay_size), jnp.float32),
        "peak_data": jnp.zeros((cfg.delay_size,), jnp.float32),
        "entry_index": jnp.int32(0),
    }
    if cfg.true_peak:
        # last TP_HIST input samples per channel (oldest first) — the
        # meter FIR's cross-block memory
        state["tp_hist"] = jnp.zeros((cfg.channels, TP_HIST), jnp.float32)
    return state


def input_peaks(cfg: LimiterConfig, state: dict, x):
    """Per-sample channel-max magnitudes feeding the look-ahead peak ring:
    |x| in sample-peak mode, the 4x polyphase meter in true-peak mode
    (process_block :150-166). x: [C, T] -> (peaks [T], state')."""
    if not cfg.true_peak:
        return jnp.max(jnp.abs(x), axis=0), state
    T = x.shape[1]
    h = jnp.asarray(truepeak_filters())
    xc = jnp.concatenate([state["tp_hist"], x], axis=1)  # [C, TP_HIST+T]
    # win[c, t, i] = x[c, t - i] (i = tap age), matching the C meter's
    # acc += h[p][i] * hist[i] with hist[0] = newest
    win = jnp.stack(
        [xc[:, TP_HIST - i:TP_HIST - i + T] for i in range(TP_TAPS)],
        axis=-1)
    ph = jnp.einsum("cti,pi->cpt", win, h,
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
    peaks = jnp.max(jnp.abs(ph), axis=(0, 1))
    return peaks, dict(state, tp_hist=xc[:, -TP_HIST:])


def _gain_step(cfg: LimiterConfig, state, peak):
    """compute_target_gain (audio_effect_peak_limiter.c:237-265)."""
    tc = state["current_tc"]
    atk = jnp.float32(cfg.attack_sec)
    rel = jnp.float32(cfg.release_sec)
    inc = jnp.float32(cfg.inc_tc)
    thr = jnp.float32(cfg.linear_threshold)

    def curve_accel(x):
        # reference: x>1 -> 1, x<0 -> 0, else 1-(x-1)^2 (:267-271)
        return jnp.where(
            x > 1.0, 1.0, jnp.where(x < 0.0, 0.0, 1.0 - (x - 1.0) ** 2)
        )

    in_attack = jnp.logical_and(tc != -1.0, tc < atk)
    in_release = jnp.logical_and(tc != -1.0, tc < rel + atk)

    tc_next = jnp.where(jnp.logical_or(in_attack, in_release), tc + inc, tc)
    atk_ratio = curve_accel(tc_next / atk)
    atk_gain = state["target_start_gain"] - atk_ratio * (
        state["target_start_gain"] - state["target_end_gain"]
    )
    rel_ratio = curve_accel((tc_next - atk) / rel)
    rel_gain = state["target_end_gain"] + rel_ratio * (1.0 - state["target_end_gain"])

    gain = jnp.where(in_attack, atk_gain, jnp.where(in_release, rel_gain, 1.0))

    # peak detect: retrigger attack from current gain
    trigger = peak * gain > thr
    target_start = jnp.where(trigger, gain, state["target_start_gain"])
    target_end = jnp.where(trigger, thr / peak, state["target_end_gain"])
    tc_out = jnp.where(trigger, 0.0, tc_next)

    new_state = dict(
        state,
        current_gain=gain,
        target_start_gain=target_start,
        target_end_gain=target_end,
        current_tc=tc_out,
    )
    return new_state, gain


def fast_pass(cfg: LimiterConfig, state: dict, x, peaks_in):
    """Below-threshold idle path for any block length: pure delay-line
    passthrough (gain 1), preserving ring phase. x: [C, N]."""
    D = cfg.delay_size
    N = x.shape[1]
    idx = state["entry_index"]
    ring_order = (idx + jnp.arange(D)) % D
    seq = jnp.concatenate([state["delay_data"][:, ring_order], x], axis=1)
    y = seq[:, :N]
    new_delay = jax.lax.dynamic_slice_in_dim(seq, N, D, axis=1)
    peaks_seq = jnp.concatenate([state["peak_data"][ring_order], peaks_in])
    new_peaks = jax.lax.dynamic_slice_in_dim(peaks_seq, N, D, axis=0)
    new_idx = (idx + N) % D
    inv = (jnp.arange(D) - new_idx) % D
    new_state = dict(
        state,
        delay_data=new_delay[:, inv],
        peak_data=new_peaks[inv],
        entry_index=new_idx,
    )
    return new_state, y


@partial(jax.jit, static_argnums=(0,))
def process_block(cfg: LimiterConfig, state: dict, x):
    """x: [channels, T] -> (new_state, y [channels, T]).

    Output is the delayed signal (look-ahead latency cfg.delay_size); the
    caller handles the first-call padding swallow.
    """
    D = cfg.delay_size
    T = x.shape[1]
    peaks_in, state = input_peaks(cfg, state, x)

    def step(carry, inp):
        xk, pk = inp
        idx = carry["entry_index"]
        peak = jnp.max(carry["peak_data"])
        carry, gain = _gain_step(cfg, carry, peak)
        out = carry["delay_data"][:, idx] * gain
        carry = dict(
            carry,
            delay_data=carry["delay_data"].at[:, idx].set(xk),
            peak_data=carry["peak_data"].at[idx].set(pk),
            entry_index=(idx + 1) % D,
        )
        return carry, out

    def slow(state):
        new_state, ys = jax.lax.scan(step, state, (x.T, peaks_in))
        return new_state, ys.T

    def fast(state):
        # Entire ring + block below threshold and envelope idle:
        # pure delay-line passthrough with gain 1.
        idx = state["entry_index"]
        # sequence: delay_data (ring order from idx) followed by x
        ring_order = (idx + jnp.arange(D)) % D
        seq = jnp.concatenate([state["delay_data"][:, ring_order], x], axis=1)
        y = seq[:, :T]
        new_delay = jax.lax.dynamic_slice_in_dim(seq, T, D, axis=1)
        peaks_seq = jnp.concatenate([state["peak_data"][ring_order], peaks_in])
        new_peaks = jax.lax.dynamic_slice_in_dim(peaks_seq, T, D, axis=0)
        # restore original ring phase (entry index advances by T mod D)
        new_idx = (idx + T) % D
        inv = (jnp.arange(D) - new_idx) % D
        new_state = dict(
            state,
            delay_data=new_delay[:, inv],
            peak_data=new_peaks[inv],
            entry_index=new_idx,
        )
        return new_state, y

    thr = jnp.float32(cfg.linear_threshold)
    can_fast = jnp.logical_and(
        state["current_tc"] == -1.0,
        jnp.logical_and(
            jnp.max(state["peak_data"]) <= thr, jnp.max(peaks_in) <= thr
        ),
    )
    return jax.lax.cond(can_fast, fast, slow, state)


class Limiter:
    """Host wrapper holding carry state + first-call padding swallow."""

    def __init__(self, cfg: LimiterConfig):
        self.cfg = cfg
        self.state = init_state(cfg)
        self.padsize = cfg.delay_size
        self.inited = False

    def reset(self) -> None:
        self.state = init_state(self.cfg)
        self.padsize = self.cfg.delay_size
        self.inited = False

    @property
    def delay(self) -> int:
        """audio_effect_peak_limiter_get_delay: delaySize - padsize."""
        return self.cfg.delay_size - self.padsize

    def process(self, x: np.ndarray) -> np.ndarray:
        """x: [channels, T] -> [channels, T'] (first call drops padding)."""
        self.state, y = process_block(self.cfg, self.state, jnp.asarray(x))
        y = np.asarray(y)
        if not self.inited:
            T = y.shape[1]
            if self.padsize >= T:
                self.padsize -= T
                return y[:, :0]
            y = y[:, self.padsize :]
            self.padsize = 0
            self.inited = True
        return y
