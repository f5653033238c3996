"""Batched, fused device decode pipeline.

The reference decodes frame-serially (one access unit per IAMF_decoder_decode
call). Here the pipeline is one jitted program over a *batch* of
frames per (mix presentation, output layout) specialization, with shape-
static [batch, channels, frame_size] inputs (SURVEY.md §7):

    per element:  demix chains (elementwise, vmapped over the batch)
                  -> render matmul (einsum, per-frame matrices)
                  -> element mix gain
    mix:          sum over elements
    output gain:  multiply
    limiter:      lax.scan over frames; per-sample gain recurrence inside,
                  with a below-threshold fast path per frame
    quantize:     round-half-even + interleave

Everything sequential-but-tiny (demix mode/w-index walk, recon-gain EMA,
mix-gain curve evaluation) runs on the host (core/timeline.py) and enters
as *scalar* per-frame tensors — factor pairs [B, 2, 5], recon EMA pairs
[B, n_rg, 3], render-matrix indices [B, 2] into a tiny constant matrix
table, gains [B] (or [B, T] only when a curve animates within a frame).
The per-sample vectors the demixer needs are rebuilt on device from these
scalars and the static skip/window constants, so the host->device traffic
per batch is dominated by the audio itself. The only true per-sample
recurrence on device is the limiter envelope.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..dsp.demix import DemixSpec, demix_frame, make_windows
from ..dsp.limiter import (LimiterConfig, _gain_step, init_state,
                           input_peaks as _input_peaks)
from ..dsp.quantize import quantize_interleave

FACTOR_KEYS = ("alpha", "beta", "gamma", "delta", "dw")


@dataclasses.dataclass(frozen=True)
class ElementSpec:
    """Static config of one element in the pipeline."""

    demix: Optional[DemixSpec]  # None => passthrough (scene-based pre-mixed)
    n_in: int  # decoded channels entering the pipeline
    n_rendered: int  # channels after demix/reorder (render matrix rows input)
    render_offset: int = 0  # DMRenderer offset split position (codec delay)
    input_scale: float = 1.0  # applied when x arrives as integers (device-
    #   side int->float conversion halves host->device transfer volume)
    skip: int = 0  # demix smoothing split (codec delay % frame_size):
    #   the first `skip` samples use the previous frame's factors
    #   (demixer_set_frame_offset, demixer.c:537-563)
    rg_index: tuple[int, ...] = ()  # recon-smoothed output-channel indices
    per_sample_gain: bool = False  # elem gain arrives [B, T] instead of [B]
    hrtf_taps: int = 0  # >0: binaural element — render_mat produces the
    #   virtual-speaker bed, then a streaming overlap-save HRTF FFT-conv
    #   (params['hrtf_H'][i], carry['hrtf'][i]) folds it to 2 ears across
    #   the whole batch timeline (M2B/H2B, dsp/binaural.py)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    frame_size: int
    out_channels: int
    bits: int
    elements: tuple[ElementSpec, ...]
    limiter: Optional[LimiterConfig]
    per_sample_out_gain: bool = False
    batch_frames: int = 128  # B: frames per decode_frames call
    head_trim: int = 0  # leading samples spliced out PRE-limiter: the
    #   reference trims per frame before mixing (iamf_frame_trim,
    #   IAMF_decoder.c:1361-1381), so trimmed samples never drive the
    #   limiter envelope. The splice delays output by one batch (the carry
    #   holds the previous batch's mixed samples); callers discard the
    #   first call's output. Only set when a limiter is active — without
    #   one, trimming after quantize is equivalent.
    emit_float: bool = False  # return mixed float32 [B*T, out] instead of
    #   quantized int PCM — the rate-mismatch path: the host resamples the
    #   device mix to the output rate, then normalizes/limits/quantizes
    #   (iamf_resample IAMF_decoder.c:3223-3248 runs between mix and
    #   loudness). Requires limiter=None and head_trim=0.


def _limiter_block(cfg: LimiterConfig, state: dict, x, peaks=None):
    """One frame through the limiter (shared with dsp.limiter.process_block
    but inline-able inside a scan). `peaks`: precomputed per-sample ring
    magnitudes (whose computation already advanced any meter history in
    `state`); None computes them here."""
    D = cfg.delay_size
    T = x.shape[1]
    if peaks is None:
        peaks_in, state = _input_peaks(cfg, state, x)
    else:
        peaks_in = peaks

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
        idx = state["entry_index"]
        ring_order = (idx + jnp.arange(D)) % D
        seq = jnp.concatenate([state["delay_data"][:, ring_order], x], axis=1)
        y = seq[:, :T]
        new_delay = jax.lax.dynamic_slice_in_dim(seq, T, D, axis=1)
        peaks_seq = jnp.concatenate([state["peak_data"][ring_order], peaks_in])
        new_peaks = jax.lax.dynamic_slice_in_dim(peaks_seq, T, D, axis=0)
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
        jnp.logical_and(jnp.max(state["peak_data"]) <= thr, jnp.max(peaks_in) <= thr),
    )
    return jax.lax.cond(can_fast, fast, slow, state)


def _element_frame(cfg: PipelineConfig, i: int, inputs: dict):
    """Demix + render for ONE element of ONE frame (pre-gain).

    Returns [out_channels, T] (or the virtual-speaker bed [n_bed, T] for a
    binaural element, which the caller folds to 2 ears by HRTF conv)."""
    es = cfg.elements[i]
    T = cfg.frame_size
    x = inputs["x"][i]
    if x.dtype != jnp.float32:
        x = x.astype(jnp.float32) * jnp.float32(es.input_scale)
    if es.demix is not None:
        fac = inputs["factors"][i]  # [2, 5]
        if es.skip:
            # first `skip` samples use the previous frame's factors
            mask = (jnp.arange(T) < es.skip).astype(jnp.float32)
            factors_t = {
                k: fac[0, j] * mask + fac[1, j] * (1.0 - mask)
                for j, k in enumerate(FACTOR_KEYS)
            }
        else:
            factors_t = {k: fac[1, j] for j, k in enumerate(FACTOR_KEYS)}
        if es.rg_index:
            start_w, stop_w = make_windows(T, es.skip)
            rg = inputs["rg"][i]  # [n_rg, 3]
            filt = (rg[:, 0:1] * jnp.asarray(stop_w)[None, :]
                    + rg[:, 1:2] * jnp.asarray(start_w)[None, :])
            # inactive rows (flags changed mid-stream) pass through
            filt = rg[:, 2:3] * filt + (1.0 - rg[:, 2:3])
        else:
            filt = None
        y = demix_frame(x, es.demix, factors_t, es.rg_index, filt)
    else:
        y = x
    # render: blend previous/current matrices across the offset split
    m_cur = inputs["m_cur"][i]
    r = jnp.einsum(
        "om,mt->ot", m_cur, y, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    if es.render_offset:
        m_prev = inputs["m_prev"][i]
        r_prev = jnp.einsum(
            "om,mt->ot", m_prev, y, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        mask = (jnp.arange(T) < es.render_offset).astype(jnp.float32)
        r = r_prev * mask[None, :] + r * (1.0 - mask[None, :])
    return r


def _frame_compute(cfg: PipelineConfig, inputs: dict):
    """Demix + render + gains + mix for ONE frame (no limiter).

    inputs (leading element axis handled by caller):
      x:        list of [C_in, T] per element
      factors:  list of [2, 5] per element (prev/cur x FACTOR_KEYS)
      rg:       list of [n_rg, 3] per element (last_sfavg, sfavg, active)
      m_prev/m_cur: list of [out, n_rendered] matrices per element
      elem_gain: scalar or [T] per element
      out_gain: scalar or [T]
    Returns mixed [out_channels, T] float32.
    """
    mixed = None
    for i, es in enumerate(cfg.elements):
        r = _element_frame(cfg, i, inputs)
        g = inputs["elem_gain"][i]
        r = r * g[None, :] if es.per_sample_gain else r * g
        mixed = r if mixed is None else mixed + r
    og = inputs["out_gain"]
    mixed = mixed * og[None, :] if cfg.per_sample_out_gain else mixed * og
    return mixed


@partial(jax.jit, static_argnums=(0,))
def decode_frames(cfg: PipelineConfig, carry: dict, params: dict, xs: list):
    """Decode one batch of B = cfg.batch_frames frames.

    `params` holds WHOLE-STREAM parameter tensors, device-resident and put
    exactly once per decode (no per-batch parameter puts); each call
    slices its batch window at the carry's frame position:
      factors:  list per element of [Np, 2, 5] float32
      rg:       list per element of [Np, n_rg, 3] float32
                (last_sfavg, sfavg, active mask; n_rg == len(es.rg_index))
      mats:     list per element of [M, out, n_rendered] float32 — the
                distinct render matrices this stream uses (downmix mode/w
                states; M == 1 for static M2M/H2M renders)
      mat_idx:  list per element of [Np, 2] int32 (prev, cur) into mats
      elem_gain: list per element of [Np] (or [Np, T] if per_sample_gain)
      out_gain: [Np] (or [Np, T] if per_sample_out_gain)
    (Np >= total frames, padded; rows past the stream are neutral.)

    xs: list per element of THIS batch's [B, C_in, T] samples/spectra
        (int dtype allowed; scaled on device by ElementSpec.input_scale).

    carry: {'limiter': limiter state, 'pos': int32 frame position}
    Returns (carry, pcm int [B * T, out_channels]); pos advances by B.
    """
    n_e = len(cfg.elements)
    B = cfg.batch_frames
    pos = carry["pos"]

    def sl(a):
        return jax.lax.dynamic_slice_in_dim(a, pos, B, axis=0)

    mat_idx = [sl(params["mat_idx"][i]) for i in range(n_e)]
    # per-frame render matrices: tiny gather outside the vmap
    m_prev = [params["mats"][i][mat_idx[i][:, 0]] for i in range(n_e)]
    m_cur = [params["mats"][i][mat_idx[i][:, 1]] for i in range(n_e)]

    per_frame_inputs = {
        "x": list(xs),
        "factors": [sl(params["factors"][i]) for i in range(n_e)],
        "rg": [sl(params["rg"][i]) for i in range(n_e)],
        "m_prev": m_prev,
        "m_cur": m_cur,
        "elem_gain": [sl(params["elem_gain"][i]) for i in range(n_e)],
        "out_gain": sl(params["out_gain"]),
    }
    carry = dict(carry, pos=pos + B)

    if any(es.hrtf_taps for es in cfg.elements):
        # binaural: each element renders to its virtual-speaker bed
        # per-frame, then ONE streaming overlap-save HRTF FFT-conv over the
        # whole batch timeline folds the bed to 2 ears (equivalent to the
        # serial per-frame conv: overlap-save chains across frames exactly
        # like convolving the concatenated signal). Element gains apply
        # per-frame AFTER the conv, matching the serial order (render ->
        # binaural -> gain, api._decode_frame).
        T = cfg.frame_size
        mixed = None
        new_hrtf = dict(carry.get("hrtf", {}))
        for i, es in enumerate(cfg.elements):
            r = jax.vmap(
                lambda inp, i=i: _element_frame(cfg, i, inp)
            )(per_frame_inputs)  # [B, C_i, T]
            if es.hrtf_taps:
                from ..dsp.binaural import batch_seg_plan

                taps = es.hrtf_taps
                C = r.shape[1]
                # segmented overlap-add (batch_seg_plan docstring): a
                # batched stack of small 5-smooth FFTs replaces the one
                # whole-batch transform; each segment's conv tail adds
                # into the next segment and the last tail is the same
                # [2, taps-1] carry as before. FFT lengths stay 5-smooth
                # (a large prime factor would make XLA lower the FFT to a
                # dense O(n^2) DFT matmul).
                seg, n, S = batch_seg_plan(B, T, taps)
                xs = r.transpose(1, 0, 2).reshape(C, S, seg).transpose(
                    1, 0, 2)  # [S, C, seg]
                X = jnp.fft.rfft(xs, n=n, axis=2)  # [S, C, F]
                # hrtf_H ships as stacked float32 re/im; the complex view
                # is formed here on device
                Hri = params["hrtf_H"][i]
                H = jax.lax.complex(Hri[0], Hri[1])
                Y = jnp.einsum("ecf,scf->sef", H, X,
                               precision=jax.lax.Precision.HIGHEST)
                y = jnp.fft.irfft(Y, n=n, axis=2)  # [S, 2, n]
                main = y[:, :, :seg]
                tails = y[:, :, seg:seg + taps - 1]  # [S, 2, taps-1]
                prev = jnp.concatenate(
                    [carry["hrtf"][i][None], tails[:-1]], axis=0)
                main = main.at[:, :, :taps - 1].add(prev)
                new_hrtf[i] = tails[-1]
                r = main.transpose(1, 0, 2).reshape(2, B, T).transpose(
                    1, 0, 2)  # [B, 2, T]
            g = per_frame_inputs["elem_gain"][i]
            r = r * g[:, None, :] if es.per_sample_gain else r * g[:, None, None]
            mixed = r if mixed is None else mixed + r
        og = per_frame_inputs["out_gain"]
        mixed = (mixed * og[:, None, :] if cfg.per_sample_out_gain
                 else mixed * og[:, None, None])
        carry = dict(carry, hrtf=new_hrtf)
    else:
        mixed = jax.vmap(
            lambda inp: _frame_compute(cfg, inp))(per_frame_inputs)

    if cfg.head_trim:
        # pre-limiter trim splice (see PipelineConfig.head_trim): delete the
        # stream's leading trimmed samples from the mixed timeline so the
        # limiter envelope never sees them, at a one-batch output latency
        Bc, C, Tc = mixed.shape
        flat0 = mixed.transpose(1, 0, 2).reshape(C, Bc * Tc)
        seq = jnp.concatenate([carry["splice"], flat0], axis=1)
        win = seq[:, cfg.head_trim: cfg.head_trim + Bc * Tc]
        carry = dict(carry, splice=flat0)
        mixed = win.reshape(C, Bc, Tc).transpose(1, 0, 2)

    if cfg.limiter is not None:
        lim = cfg.limiter
        B, C, T = mixed.shape
        thr = jnp.float32(lim.linear_threshold)
        state = carry["limiter"]
        flat = mixed.transpose(1, 0, 2).reshape(C, B * T)
        # channel-max magnitudes over the whole batch — sample peaks, or
        # the 4x-oversampled true-peak meter when lim.true_peak — computed
        # ONCE for both branches (the meter's FIR history advances here,
        # branch-independent)
        peaks_in, state = _input_peaks(lim, state, flat)
        batch_peak = jnp.max(peaks_in)

        def fast(state):
            # whole batch below threshold + idle envelope: one flattened
            # delay-line pass, no per-sample scan at all
            from ..dsp.limiter import fast_pass

            new_state, y = fast_pass(lim, state, flat, peaks_in)
            return new_state, y.reshape(C, B, T).transpose(1, 0, 2)

        def slow(state):
            pk = peaks_in.reshape(B, T)

            def lim_step(s, inp):
                frame, p = inp
                return _limiter_block(lim, s, frame, p)

            return jax.lax.scan(lim_step, state, (mixed, pk))

        can_fast = jnp.logical_and(
            state["current_tc"] == -1.0,
            jnp.logical_and(
                jnp.max(state["peak_data"]) <= thr, batch_peak <= thr
            ),
        )
        lim_state, limited = jax.lax.cond(can_fast, fast, slow, state)
        carry = dict(carry, limiter=lim_state)
        mixed = limited

    if cfg.emit_float:
        B = mixed.shape[0]
        return carry, mixed.transpose(0, 2, 1).reshape(
            B * cfg.frame_size, cfg.out_channels)

    pcm = jax.vmap(lambda m: quantize_interleave(m, cfg.bits))(mixed)
    # flatten to [B*T, out] ON DEVICE: callers consume the flat layout, and
    # one contiguous 2-D buffer is the cheapest device-to-host copy
    B = pcm.shape[0]
    return carry, pcm.reshape(B * cfg.frame_size, cfg.out_channels)


MIN_PUT_BYTES = 16384  # smallest host-to-device put (see put_padded)


def put_padded(a: np.ndarray):
    """device_put with axis-0 padding to at least MIN_PUT_BYTES. The
    padding was sized for a transfer path on which small puts were slow;
    whether it still pays is open (ROADMAP, design debt T1). The padded
    rows are junk; consumers slice within the real rows."""
    import jax

    if a.nbytes >= MIN_PUT_BYTES or a.ndim == 0:
        return jnp.asarray(a)
    row = max(a.nbytes // max(a.shape[0], 1), 1)
    need = -(-MIN_PUT_BYTES // row)
    if need > a.shape[0]:
        pad = np.zeros((need - a.shape[0],) + a.shape[1:], a.dtype)
        a = np.concatenate([a, pad])
    return jnp.asarray(a)


def put_stream_params(cfg: PipelineConfig, tl, n_padded: int) -> dict:
    """Upload the replayed timeline (core/timeline.TimelineParams) as the
    device-resident whole-stream parameter pytree for decode_frames. Each
    array is padded to n_padded frames with neutral values and to the bulk
    put_padded threshold."""

    def pad_frames(a, fill):
        if a.shape[0] >= n_padded:
            return a[:n_padded]
        tail = np.full((n_padded - a.shape[0],) + a.shape[1:], fill, a.dtype)
        return np.concatenate([a, tail])

    params = {"factors": [], "rg": [], "mats": [], "mat_idx": [],
              "elem_gain": []}
    for ep in tl.elements:
        params["factors"].append(put_padded(pad_frames(ep.factors, 1.0)))
        params["rg"].append(put_padded(pad_frames(ep.rg, 0.0)))
        params["mats"].append(put_padded(np.asarray(ep.mats, np.float32)))
        params["mat_idx"].append(put_padded(
            pad_frames(ep.mat_idx.astype(np.int32), 0)))
        params["elem_gain"].append(put_padded(
            pad_frames(ep.gain.astype(np.float32), 1.0)))
    params["out_gain"] = put_padded(
        pad_frames(tl.out_gain.astype(np.float32), 1.0))
    return params


def init_carry(cfg: PipelineConfig) -> dict:
    carry = {"pos": jnp.zeros((), jnp.int32)}
    if cfg.limiter is not None:
        carry["limiter"] = init_state(cfg.limiter)
    if cfg.head_trim:
        carry["splice"] = jnp.zeros(
            (cfg.out_channels, cfg.batch_frames * cfg.frame_size),
            jnp.float32)
    if any(es.hrtf_taps for es in cfg.elements):
        carry["hrtf"] = {
            i: jnp.zeros((2, es.hrtf_taps - 1), jnp.float32)
            for i, es in enumerate(cfg.elements) if es.hrtf_taps
        }
    return carry
