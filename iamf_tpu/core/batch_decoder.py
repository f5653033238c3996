"""Batched stream decoder: host parse/unpack feeding the fused device pipeline.

The throughput path: parses all OBUs up front (host, <1% of time), replays
the parameter timeline (core/timeline.py: mix-gain curves, demix mode /
w-index walk, recon-gain EMA — the reference's per-frame scalar state
machines, IAMF_decoder.c:639-982 / demixer.c:592-619), unpacks codec
payloads into [B, C, T] frame batches, and drives
core.pipeline.decode_frames in large batches — all elements of the selected
mix presentation decode/render in one jitted program and are mixed on
device. Channel-based elements demix/downmix as in the per-frame path;
scene-based (ambisonics) elements fold the mono-remap / projection
conversion into the H2M render matrix (one [out, lanes] matmul). Opus
elements run the host-entropy + device-synthesis split
(codecs/opus/tpu_synth.py). The batched path also covers resampling,
binaural rendering, and mp4 seek (from_mp4 start_sec); the per-frame
api.IAMFDecoder remains the fully general path (and the oracle the batched
suites diff against).
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..constants import (
    AmbisonicsMode, ElementType, LayoutType, SoundSystem,
    db_to_linear, q78_to_db,
)
from ..codecs.base import open_decoder
from ..dsp.demix import DemixSpec
from ..dsp.limiter import LimiterConfig
from ..dsp import render as rdr
from ..dsp.downmix import DownmixerState, can_downmix, downmix_matrix
from ..obu import parser
from . import timeline
from .database import Database, codec_config_sampling_rate
from .pipeline import (
    ElementSpec, PipelineConfig, decode_frames, init_carry, put_padded,
    put_stream_params,
)
from .stream import SS_TO_LAYOUT, Stream, OutputLayout


@dataclasses.dataclass
class _ElemCtx:
    stream: Stream
    codec: object
    substream_ids: list
    demix_spec: object  # DemixSpec | None
    render_mat: np.ndarray  # [out_channels, n_rendered]
    downmix: object  # DownmixerState | None (mode/w walk for the renderer)
    n_in: int
    input_scale: float
    raw_input: bool
    opus: bool
    aac: bool
    gain: float  # element default mix gain (linear)
    hrtf_bank: object = None  # np.ndarray [2, n_bed, taps] | None — HRIRs
    #   for the M2B/H2B binaural conv (render_mat then yields the bed)
    opus_cfg: tuple | None = None  # (opus frame n, frames/unit k, hybrid)
    #   from OpusDecoder.classify_packets for the device spectrum path


# The batched path pins the comb-filter chunk to 13 — safe for every legal
# period (>= MINPERIOD 15) — so ONE compiled program covers any content
# instead of one per chunk width (tpu_synth.pick_chunk). A wider chunk
# means fewer sequential loop steps per batch; whether that is worth the
# extra compiled variants on the GPU is open (ROADMAP, queue 1 item 2).
_BATCH_COMB_CHUNK = 13


def _fused_decode_body(cfg, kinds: tuple, carry, params, bufs):
    """Codec synthesis (opus CELT / AAC filterbank) fused with the decode
    pipeline — the traced body shared by the single-stream jit below and
    the vmapped multi-stream program (serving.MultiStreamServer)."""
    xs = []
    syn = []
    for i, kind in enumerate(kinds):
        if kind.startswith("opus"):
            from ..codecs.opus import tpu_synth

            # kind "opus" = CELT 960/1-frame; "opus:n:k:h" = general
            # operating point (opus frame size n, k frames per temporal
            # unit, hybrid SILK block appended)
            n, k, hyb = 960, 1, False
            if kind != "opus":
                _, a, b, c = kind.split(":")
                n, k, hyb = int(a), int(b), bool(int(c))
            x, s = tpu_synth.synthesize_packed(
                bufs[i], carry["syn"][i], chunk=_BATCH_COMB_CHUNK,
                n=n, hybrid=hyb)
            if k > 1:
                # regroup k opus frames into one temporal-unit row
                Bu, L = x.shape[0] // k, x.shape[1]
                x = x.reshape(Bu, k, L, n).transpose(0, 2, 1, 3).reshape(
                    Bu, L, k * n)
        elif kind == "aac":
            from ..codecs.aac import tpu_synth as aac_synth

            x, s = aac_synth.synthesize_packed(bufs[i], carry["syn"][i])
        else:
            x, s = bufs[i], carry["syn"][i]
        xs.append(x)
        syn.append(s)
    pipe, pcm = decode_frames(cfg, carry["pipe"], params, xs)
    return {"pipe": pipe, "syn": syn}, pcm


@partial(jax.jit, static_argnums=(0, 1))
def _fused_decode(cfg, kinds: tuple, carry, params, bufs):
    """ONE device dispatch per batch instead of one per stage.
    Module-level jit keyed on the static (cfg, kinds) so fresh decoder
    instances share the compiled program."""
    return _fused_decode_body(cfg, kinds, carry, params, bufs)


def plan_kinds(dec: "BatchedStreamDecoder") -> tuple:
    """Static per-element synthesis kinds for the fused program — part of
    the compiled-program key (with cfg), so also the serving bucket key."""

    def _kind(e):
        if e.opus:
            nf, kf, hyb = e.opus_cfg
            if (nf, kf, hyb) == (960, 1, False):
                return "opus"  # the flagship CELT-960 operating point
            return f"opus:{nf}:{kf}:{int(hyb)}"
        return "aac" if e.aac else "raw"

    return tuple(_kind(e) for e in dec.elems)


class _HostPlan:
    """Host-side decode plan for one stream: whole-stream parameter
    tensors, per-element unpack / prefetched entropy decode, initial
    carries, and the output call/trim bookkeeping. Shared by
    BatchedStreamDecoder.decode_all and serving.MultiStreamServer (which
    runs S plans against one vmapped device program)."""

    def __init__(self, dec: "BatchedStreamDecoder", rows: int | None = None):
        import concurrent.futures as _cf

        self.dec = dec
        B = self.B = dec.batch_frames
        T = dec.frame_size
        n = self.n = dec.n_frames
        self.n_batches = -(-n // B)
        # whole-stream parameter tensors: ONE bulk h2d put each (+1 batch
        # of neutral padding so the limiter drain can run past stream end).
        # `rows` overrides the padded length — the multi-stream server pads
        # every fleet member to the longest stream so the [S, ...] stacks
        # are rectangular (padding rows are neutral by construction).
        self.stream_params = put_stream_params(
            dec.cfg, dec.params, rows or (self.n_batches + 1) * B)
        if any(es.hrtf_taps for es in dec.cfg.elements):
            # HRIR spectra at the SEGMENT conv length (device-resident,
            # put once; 5-smooth FFT size — see pipeline.decode_frames /
            # dsp.binaural.batch_seg_plan). Shipped as a stacked float32
            # [2(re/im), 2(ear), C, F] pair; the complex view is formed on
            # device inside the jit.
            from ..dsp.binaural import batch_seg_plan

            def _spec(e):
                taps = e.hrtf_bank.shape[2]
                _, n, _ = batch_seg_plan(B, T, taps)
                h = np.fft.rfft(e.hrtf_bank, n=n, axis=2)
                return jnp.asarray(np.stack(
                    [h.real, h.imag]).astype(np.float32))

            self.stream_params["hrtf_H"] = {
                i: _spec(e)
                for i, e in enumerate(dec.elems)
                if e.hrtf_bank is not None
            }

        # per-element: one vectorized unpack for the whole stream (or, for
        # opus/aac, per-batch spectrum decode feeding device synthesis)
        self.elem_packets = []
        self.elem_all_x = []
        elem_syn_carry = []
        for e in dec.elems:
            packets = [dec.frames_per_substream[sid]
                       for sid in e.substream_ids]
            self.elem_packets.append(packets)
            if e.opus:
                self.elem_all_x.append(None)
                elem_syn_carry.append(dec.opus_synth.init_carry(
                    sum(ch for _, ch in e.codec._decoders)))
            elif e.aac:
                self.elem_all_x.append(None)
                elem_syn_carry.append(dec.aac_synth.init_carry(
                    sum(ch for _, ch in e.codec._decoders)))
            elif e.raw_input:
                self.elem_all_x.append(e.codec.decode_batch_raw(packets, T)[0])
                elem_syn_carry.append(None)
            elif hasattr(e.codec, "decode_batch"):
                self.elem_all_x.append(e.codec.decode_batch(packets, T))
                elem_syn_carry.append(None)
            else:
                self.elem_all_x.append(np.stack(
                    [e.codec.decode([p[k] for p in packets])
                     for k in range(n)]))
                elem_syn_carry.append(None)
        self.carry = {"pipe": init_carry(dec.cfg), "syn": elem_syn_carry}

        self.kinds = plan_kinds(dec)

        # Output bookkeeping. With the pre-limiter trim splice
        # (cfg.head_trim), every call's PCM is delayed one batch and the
        # first call emits only warmup zeros, so the kept stream starts at
        # call 1; enough zero-input flush calls are appended to surface the
        # spliced latency plus the limiter drain (all pure pad: padded
        # parameter rows are neutral and the limiter just drains).
        self.want = n * T - dec.lead - dec.tail
        self.k0 = 1 if dec.cfg.head_trim else 0
        if dec.cfg.limiter is not None:
            needed = self.want + dec.cfg.limiter.delay_size
            if not dec.cfg.head_trim:
                needed = n * T + dec.cfg.limiter.delay_size  # fallback
        else:
            needed = self.want + dec.lead
        self.total_calls = self.n_batches
        while (self.total_calls - self.k0) * B * T < needed:
            self.total_calls += 1

        # host entropy decode (opus/aac) prefetched one batch ahead so it
        # overlaps the previous batch's device compute and d2h fetches.
        # ONE worker: the codec's inter-frame state (CELT energy carry, AAC
        # window history) chains across batches, so they must decode in
        # submission order, never concurrently
        self.entropy_pool = _cf.ThreadPoolExecutor(1) if (
            dec.opus_synth or dec.aac_synth) else None
        self._pending = self._submit(0) if self.n_batches else None
        self._bi = 0

    def _host_batch(self, i, e, start, count):
        if e.opus:
            return self.dec._opus_entropy(
                e, self.elem_packets[i], start, count, self.B)
        if e.aac:
            return self.dec._aac_entropy(
                e, self.elem_packets[i], start, count, self.B)
        xs = self.elem_all_x[i][start:start + count]
        if count < self.B:
            xs = np.concatenate(
                [xs, np.zeros((self.B - count,) + xs.shape[1:], xs.dtype)])
        return xs, None

    def _submit(self, bi):
        start = bi * self.B
        count = min(self.B, self.n - start)
        futs = []
        for i, e in enumerate(self.dec.elems):
            if self.entropy_pool is not None and (e.opus or e.aac):
                futs.append(self.entropy_pool.submit(
                    self._host_batch, i, e, start, count))
            else:
                futs.append((i, e, start, count))
        return count, futs

    def next_bufs(self):
        """Numpy input buffers (padded to B frames) for the next decode
        call, or None for a trailing flush call (caller reuses zeros)."""
        bi = self._bi
        self._bi += 1
        if bi >= self.n_batches:
            return None
        _count, futs = self._pending
        self._pending = (self._submit(bi + 1)
                         if bi + 1 < self.n_batches else None)
        out = []
        for item in futs:
            if isinstance(item, tuple):
                xs_np, _aux = self._host_batch(*item)
            else:
                xs_np, _aux = item.result()
            out.append(xs_np)
        return out

    def close(self):
        if self.entropy_pool is not None:
            self.entropy_pool.shutdown(wait=False)


class BatchedStreamDecoder:
    """Decode a complete in-memory IAMF stream in frame batches."""

    @classmethod
    def from_mp4(cls, path: str, start_sec: float = 0.0, **kw
                 ) -> "BatchedStreamDecoder":
        """Open an IAMF-in-MP4 file on the batched throughput path
        (BASELINE config-4 class: `-i1` input, optional `-ts` seek).

        The mp4 track is demuxed to a raw descriptor+packet OBU stream
        (mp4_iamf_parser_read_packet re-glues descriptors on sample-
        description change, mp4iamfpar.c:111-189; seek walks sample deltas,
        :203-233) and decoded as one batched stream."""
        from ..mp4.iamf_track import MP4IAMFParser

        mp4 = MP4IAMFParser(path)
        if start_sec > 0:
            mp4.seek(start_sec)
        parts = [mp4.descriptors]
        for packet, new_descriptors in mp4.packets():
            if new_descriptors:
                parts.append(new_descriptors)
            parts.append(packet)
        return cls(b"".join(parts), **kw)

    def __init__(self, data: bytes, sound_system: int = 0, bits: int = 16,
                 batch_frames: int = 128, limiter: bool = True,
                 normalization_db: float | None = None,
                 peak_threshold_db: float | None = None,
                 binaural: bool = False,
                 mix_presentation_id: int | None = None):
        self.data = data
        self.bits = bits
        self.batch_frames = batch_frames
        self.db = Database()
        # kwargs for follow-on segment decoders (mid-stream reconfigure)
        self._init_kw = dict(
            sound_system=sound_system, bits=bits, batch_frames=batch_frames,
            limiter=limiter, normalization_db=normalization_db,
            peak_threshold_db=peak_threshold_db, binaural=binaural,
            mix_presentation_id=mix_presentation_id)
        self._next_data: bytes | None = None
        # decode-path visibility: which synthesis path each element took and
        # why a device path was rejected (a user benchmarking SILK content
        # must be able to see it measured the host path)
        self.stats: dict = {"elements": []}
        self.binaural = binaural
        if binaural:
            self.layout = OutputLayout(type=LayoutType.BINAURAL)
        else:
            self.layout = OutputLayout(
                type=LayoutType.SS_CONVENTION, sound_system=sound_system
            )

        off = parser.find_sequence_header(data)
        if off < 0:
            raise ValueError("no sequence header")
        # one native pass over the whole stream (obu_split.cc): the Python
        # per-OBU walk cost ~0.3 s on a 30 s stream — half the host side of
        # the batched decode; the record array is processed vectorized and
        # only descriptor/parameter OBUs become Python objects
        body = data[off:] if isinstance(data, bytes) else bytes(
            memoryview(data)[off:])
        recs = parser.split_records(body)
        # Mid-stream reconfigure: a NON-redundant Sequence Header after the
        # first flips the reference decoder to RECONFIGURE and the player
        # re-calls configure with the remaining bytes
        # (IAMF_decoder.c:2918-2921, iamfplayer.c:623-626); non-redundant
        # descriptor re-ingest rebuilds the streams. The batched timeline
        # segments at that point: this instance decodes up to the boundary
        # and decode_all() chains a follow-on decoder (fresh streams +
        # limiter re-init, exactly the serial path's semantics) over the
        # remainder, concatenating the PCM.
        seq = np.flatnonzero(
            (recs[:, 0] == 31) & ((recs[:, 1] & 1) == 0))  # SEQUENCE_HEADER
        if seq.size > 1:
            j = int(seq[1])
            self._next_data = body[int(recs[j, 2]):]
            recs = recs[:j]
        types = recs[:, 0]
        sids = recs[:, 7]
        self.frames_per_substream: dict[int, list[bytes]] = {}
        self.trims: list[tuple[int, int]] = []  # (start, end) per temporal unit
        frame_mask = sids >= 0
        self._frame_pos = {}  # record index of each substream's k-th frame
        for s in np.unique(sids[frame_mask]):
            idx = np.flatnonzero(sids == s)
            self._frame_pos[int(s)] = idx
            self.frames_per_substream[int(s)] = [
                body[recs[i, 3]: recs[i, 3] + recs[i, 4]] for i in idx]
        param_obus: list = []
        for i in np.flatnonzero((types >= 0) & (types <= 3)):
            obu = parser.split_obu(body, int(recs[i, 2]))
            if obu.type == 0:
                self.db.add_codec_config(parser.parse_codec_config(obu))
            elif obu.type == 1:
                self.db.add_element(parser.parse_audio_element(obu))
            elif obu.type == 2:
                self.db.add_mix_presentation(
                    parser.parse_mix_presentation(obu))
            else:
                param_obus.append((int(i), obu))

        from .presentation import best_loudness, best_mix_presentation

        mp = best_mix_presentation(self.db, self.layout, mix_presentation_id)
        if mp is None:
            raise ValueError("no mix presentation available")
        self.mix_presentation = mp
        sub = mp.sub_mixes[0]
        out_ch = self.layout.channels
        # rate mismatch => the device program emits the float mix, the
        # DEVICE resampler (dsp.resample.DeviceResampler) converts it to
        # 48 kHz, and the host tail normalizes/limits/quantizes in the
        # serial decoder's order (iamf_stream_resampler_open
        # IAMF_decoder.c:3193-3199; iamf_resample :3223-3248).
        self.stream_rate = int(codec_config_sampling_rate(
            self.db.elements[sub.elements[0].element_id].codec_config))
        self.needs_resample = self.stream_rate != 48000
        device_limiter = limiter and not self.needs_resample
        self._want_limiter = limiter
        self._peak_threshold_db = peak_threshold_db
        self.frame_size = None
        self.elems: list[_ElemCtx] = []
        self.opus_synth = None
        self.aac_synth = None
        for econf in sub.elements:
            item = self.db.elements[econf.element_id]
            ctx = self._open_element(item, econf, sound_system, out_ch)
            self.elems.append(ctx)
        out_gain_default = db_to_linear(
            q78_to_db(sub.output_mix_gain.default_mix_gain_q78))
        norm_gain = 1.0
        if normalization_db is not None:
            # loudness normalization: db2lin(norm - selected loudness)
            # applied to the mix (IAMF_decoder.c:3480-3484; selection
            # :3030-3059 picks the loudness of the best-scoring layout —
            # shared with the serial path, core/presentation.py)
            loud = best_loudness(mp, self.layout)
            norm_gain = db_to_linear(normalization_db - loud)
        self._norm_gain = 1.0
        if self.needs_resample:
            # the reference normalizes AFTER resampling (:3474 -> :3480);
            # keep the gain out of the device out-gain and apply it on the
            # host tail so the float order matches the serial path
            self._norm_gain, norm_gain = norm_gain, 1.0

        # temporal-unit events: a unit closes when every selected substream
        # has delivered one more packet (iamf_decoder_internal_parse_OBUs
        # runs the decode once all decoders report packet_ready, :2871-2932).
        # Vectorized: unit u closes at the max record index among the
        # required substreams' u-th frames; unit trims come from the first
        # selected substream's u-th frame.
        required = [sid for e in self.elems for sid in e.substream_ids]
        first_sid = self.elems[0].substream_ids[0]
        pos = [self._frame_pos.get(sid, np.empty(0, np.int64))
               for sid in required]
        units = min((len(p) for p in pos), default=0)
        self.events: list = []
        if units:
            close_pos = np.max(
                np.stack([p[:units] for p in pos]), axis=0)
            f0 = self._frame_pos[first_sid][:units]
            ts0 = recs[f0, 5]
            te0 = recs[f0, 6]
            self.trims = list(zip(ts0.tolist(), te0.tolist()))
            pi = 0
            for u in range(units):
                while (pi < len(param_obus)
                       and param_obus[pi][0] < close_pos[u]):
                    self.events.append(("param", param_obus[pi][1]))
                    pi += 1
                self.events.append(("unit", int(ts0[u]), int(te0[u])))
            for _, obu in param_obus[pi:]:
                self.events.append(("param", obu))
        else:
            self.events = [("param", obu) for _, obu in param_obus]

        # replay the parameter timeline (host scalar state machines)
        rate = codec_config_sampling_rate(
            self.db.elements[sub.elements[0].element_id].codec_config)
        self.params = timeline.replay(
            self.db, self.elems, sub.elements, sub, self.events,
            self.n_frames, self.frame_size, rate,
            out_gain_default, norm_gain,
        )

        # Edge-trim semantics (iamf_frame_trim, IAMF_decoder.c:1361-1381):
        # the reference deletes trimmed samples BEFORE the limiter. With a
        # limiter active, trimmed samples are zeroed via a per-sample
        # out-gain mask and the head total is spliced out of the mixed
        # timeline on device (PipelineConfig.head_trim), so the limiter
        # envelope matches the reference exactly even when it is engaged at
        # a trim boundary. Without a limiter, post-quantize slicing is
        # equivalent and cheaper.
        nf = self.n_frames
        self.lead = sum(t[0] for t in self.trims[:nf])
        self.tail = sum(t[1] for t in self.trims[:nf])
        T = self.frame_size
        head_trim = (self.lead if device_limiter
                     and 0 < self.lead <= batch_frames * T else 0)
        if head_trim:
            og = self.params.out_gain
            if og.ndim == 1:
                og = np.repeat(og[:, None], T, axis=1).astype(np.float32)
            else:
                og = og.copy()
            rem, u = head_trim, 0
            while rem > 0 and u < len(og):
                k = min(rem, T)
                og[u, :k] = 0.0
                rem -= k
                u += 1
            rem, u = self.tail, nf - 1
            while rem > 0 and u >= 0:
                k = min(rem, T)
                og[u, T - k:] = 0.0
                rem -= k
                u -= 1
            self.params.out_gain = og
            self.params.out_gain_per_sample = True

        self.cfg = PipelineConfig(
            frame_size=self.frame_size,
            out_channels=out_ch,
            bits=bits,
            elements=tuple(
                ElementSpec(
                    demix=e.demix_spec,
                    n_in=e.n_in,
                    n_rendered=e.render_mat.shape[1],
                    input_scale=e.input_scale,
                    render_offset=(int(getattr(e.codec, "delay", 0) or 0)
                                   if e.downmix is not None else 0),
                    skip=(int(getattr(e.codec, "delay", 0) or 0)
                          % self.frame_size if e.demix_spec is not None
                          else 0),
                    rg_index=ep.rg_index,
                    per_sample_gain=ep.gain_per_sample,
                    hrtf_taps=(e.hrtf_bank.shape[2]
                               if e.hrtf_bank is not None else 0),
                )
                for e, ep in zip(self.elems, self.params.elements)
            ),
            limiter=LimiterConfig(
                channels=out_ch,
                true_peak=os.environ.get("IAMF_TRUEPEAK") == "1",
                **({"threshold_db": peak_threshold_db}
                   if peak_threshold_db is not None else {}),
            ) if device_limiter else None,
            per_sample_out_gain=self.params.out_gain_per_sample,
            batch_frames=batch_frames,
            head_trim=head_trim,
            emit_float=self.needs_resample,
        )

    def _open_element(self, item, econf, sound_system, out_ch) -> _ElemCtx:
        stream = Stream(item, self.layout)
        el = item.element
        cc = item.codec_config
        if self.frame_size is None:
            self.frame_size = cc.nb_samples_per_frame
        elif self.frame_size != cc.nb_samples_per_frame:
            raise ValueError("batched path: mixed frame sizes")
        gain = db_to_linear(
            q78_to_db(econf.element_mix_gain.default_mix_gain_q78))

        downmix = None
        hrtf_bank = None
        if stream.scheme == ElementType.CHANNEL_BASED:
            s = stream
            codec = open_decoder(
                s.codec, cc.decoder_conf,
                sum(l.nb_substreams for l in s.layers[: s.layer + 1]),
                sum(l.nb_coupled_substreams for l in s.layers[: s.layer + 1]),
                self.frame_size,
            )
            order = s.channels_order[: s.selected_channels]
            demix_spec = DemixSpec(
                layout=s.selected_layout,
                channels_in=tuple(order),
                frame_size=self.frame_size,
                output_gains=(1.0,) * len(order),
            )
            in_layout = s.selected_layout
            tgt = (SS_TO_LAYOUT.get(SoundSystem(sound_system))
                   if self.layout.type == LayoutType.SS_CONVENTION else None)
            if (self.layout.type == LayoutType.BINAURAL
                    and econf.headphones_rendering_mode == 1):
                # M2B: the demixed channel bed convolves with the layout's
                # HRIR bank (serial path: StreamRenderer.render; the
                # reference delegates to BEAR, m2b_rdr.c:49-121)
                from ..dsp.binaural import hrir_bank

                render_mat = np.eye(len(order), dtype=np.float32)
                hrtf_bank = hrir_bank(in_layout, 256, 48000)
            elif (tgt is not None and s.dmx_default_mode >= 0
                    and can_downmix(in_layout, tgt)):
                mode = max(s.dmx_default_mode, 0)
                render_mat = downmix_matrix(
                    in_layout, tgt, mode, max(s.dmx_default_w_idx, 0))
                downmix = DownmixerState(in_layout, tgt)
                downmix.set_mode_weight(mode, s.dmx_default_w_idx)
            else:
                render_mat = rdr.m2m_matrix(
                    rdr.LAYER_IDS[in_layout], self.layout.render_id
                ).T.copy()
            n_in = len(order)
        else:
            # scene-based: fold mono-remap / projection into the H2M matrix
            codec = open_decoder(
                stream.codec, cc.decoder_conf,
                stream.nb_substreams, stream.nb_coupled_substreams,
                self.frame_size,
            )
            lanes = stream.nb_substreams + stream.nb_coupled_substreams
            n_amb = stream.nb_channels
            if stream.ambisonics_mode == AmbisonicsMode.PROJECTION:
                raw = stream.ambisonics_mapping
                vals = np.frombuffer(raw, dtype=">i2").astype(
                    np.float32) / 32768.0
                conv = vals.reshape(lanes, n_amb).T  # [n_amb, lanes]
            else:
                conv = np.zeros((n_amb, lanes), np.float32)
                for i, m in enumerate(stream.ambisonics_mapping[:n_amb]):
                    if m < lanes:
                        conv[i, m] = 1.0
            hoa_order = rdr.hoa_order_for_channels(n_amb)
            if (self.layout.type == LayoutType.BINAURAL
                    and econf.headphones_rendering_mode == 1):
                # H2B: HOA -> 7.1.2 virtual speaker bed -> HRTF conv
                # (serial path parity; replaces Resonance, h2b_rdr.c:48-128)
                from ..constants import ChannelLayout
                from ..dsp.binaural import hrir_bank

                virt = rdr.h2m_full_matrix(
                    hoa_order, 0x712, 10, self.layout.samsung_tv)
                render_mat = (virt @ conv).astype(np.float32)  # [10, lanes]
                hrtf_bank = hrir_bank(ChannelLayout.L712, 256, 48000)
            else:
                full = rdr.h2m_full_matrix(
                    hoa_order, self.layout.render_id, out_ch,
                    self.layout.samsung_tv)  # [out, n_amb]
                render_mat = (full @ conv).astype(np.float32)  # [out, lanes]
            demix_spec = None
            n_in = lanes

        input_scale = 1.0
        raw_input = hasattr(codec, "decode_batch_raw")
        if raw_input:
            input_scale = 1.0 / float(getattr(codec, "scale", 1.0))
        opus = False
        opus_cfg = None
        opus_mode = None
        if hasattr(codec, "classify_packets"):
            # TOC scan decides the decode split per element (every TOC is
            # served, mirroring opus_multistream2_decoder.c:125-165):
            # CELT/hybrid at any frame size and packing -> device spectrum
            # synthesis; SILK-only and mixed-mode -> native host decode
            # feeding the device pipeline (codec.decode_batch below).
            pkts = [self.frames_per_substream.get(sid) or []
                    for sid in el.substream_ids]
            opus_mode, n_f, k_f = codec.classify_packets(
                pkts, self.frame_size)
            if opus_mode in ("celt", "hybrid"):
                opus = True
                opus_cfg = (n_f, k_f, opus_mode == "hybrid")
        if opus and self.opus_synth is None:
            from ..codecs.opus import tpu_synth

            self.opus_synth = tpu_synth
        aac = (hasattr(codec, "decode_spectrum_batch") and not opus_mode
               and self.frame_size == 1024
               and getattr(codec, "backend", None) != "fdk")
        if aac and self.aac_synth is None:
            from ..codecs.aac import tpu_synth as aac_tpu_synth

            self.aac_synth = aac_tpu_synth
        self.stats["elements"].append({
            "element_id": el.element_id,
            "path": (f"opus_device_{opus_mode}" if opus else
                     "opus_host_pipeline" if opus_mode == "host" else
                     "aac_device" if aac else
                     "raw_device" if raw_input else "host"),
            **({"opus_cfg": opus_cfg} if opus_cfg else {}),
        })
        return _ElemCtx(
            stream=stream, codec=codec,
            substream_ids=list(el.substream_ids),
            demix_spec=demix_spec, render_mat=render_mat, downmix=downmix,
            n_in=n_in, input_scale=input_scale, raw_input=raw_input,
            opus=opus, aac=aac, gain=gain, hrtf_bank=hrtf_bank,
            opus_cfg=opus_cfg,
        )

    @property
    def n_frames(self) -> int:
        return min(
            len(self.frames_per_substream.get(sid, []))
            for e in self.elems for sid in e.substream_ids
        )

    def _opus_entropy(self, e: _ElemCtx, packets, start, count, B):
        """Host entropy decode for one opus batch -> ONE packed h2d buffer
        [B*k, L, packed_width] = spectra ++ params (++ hybrid SILK pcm),
        so everything ships in a single bulk transfer."""
        n, kf, hyb = e.opus_cfg
        blk = [[p[k] for p in packets] for k in range(start, start + count)]
        d = e.codec.decode_spectrum_batch(blk, n=n, k=kf, hybrid=hyb)
        buf = d["buf"]
        # pack the 13 per-frame values into the buffer's param columns:
        # one h2d buffer, zero re-copy of the wide spectra
        buf[..., n:n + self.opus_synth.N_PARAMS] = \
            self.opus_synth.pack_params(d)
        pad = B - count
        if pad:
            padbuf = np.zeros((pad * kf,) + buf.shape[1:], np.float32)
            # neutral rows: zero spectra/gains, legal comb periods
            for col in (self.opus_synth.PK_T_OLD, self.opus_synth.PK_T_CUR,
                        self.opus_synth.PK_T_NEW):
                padbuf[..., n + col] = 15
            buf = np.concatenate([buf, padbuf])
        return buf, self.opus_synth.pick_chunk(d["min_period"])

    def _aac_entropy(self, e: _ElemCtx, packets, start, count, B):
        """Host entropy decode for one AAC batch -> ONE packed h2d buffer
        [B, L, 1027] = spec ++ (win_seq, shape, prev_shape)."""
        blk = [[p[k] for p in packets] for k in range(start, start + count)]
        d = e.codec.decode_spectrum_batch(blk)
        pad = B - count
        if pad:
            d = {k: np.concatenate(
                [v, np.zeros((pad,) + v.shape[1:], v.dtype)])
                for k, v in d.items()}
        packed = self.aac_synth.pack_params(d).astype(np.float32)
        return np.concatenate(
            [d["spec"].astype(np.float32), packed], axis=-1), None

    def _resample_tail(self, full) -> np.ndarray:
        """Rate-mismatch output stage: resample the device float mix to
        48 kHz ON DEVICE (dsp.resample.DeviceResampler — the polyphase FIR
        as a gathered-window einsum with overlap-save carry, SURVEY
        §2.3.6), then normalize, limit, and quantize on the host in the
        serial decoder's order (iamf_resample IAMF_decoder.c:3223-3248 ->
        loudness :3480 -> limiter :3487; flush drain :3250-3301).

        full: [rows, C] float32 mix timeline (device array or numpy)."""
        import jax.numpy as jnp

        from ..dsp.limiter import Limiter, LimiterConfig as _LC
        from ..dsp.quantize import quantize_interleave
        from ..dsp.resample import DeviceResampler

        T = self.frame_size
        n = self.n_frames
        want = n * T - self.lead - self.tail
        x = jnp.asarray(full)[self.lead: self.lead + want].T  # [C, N]
        C = x.shape[0]
        rs = DeviceResampler(channels=int(C), in_rate=self.stream_rate,
                             out_rate=48000)
        y = np.array(rs.resample_stream(x))  # incl. latency drain tail
        if self._norm_gain != 1.0:
            # api parity: the serial path normalizes process() outputs but
            # not the drained latency tail — split at the host resampler's
            # pre-drain output count
            n_main = -(-(want - rs.host_params.input_latency)
                       * rs.den // rs.num)
            y[:, :n_main] *= np.float32(self._norm_gain)
        if not self._want_limiter:
            return np.asarray(quantize_interleave(y, self.bits))
        lim = Limiter(_LC(
            channels=int(C),
            **({"threshold_db": self._peak_threshold_db}
               if self._peak_threshold_db is not None else {}),
        ))
        out = lim.process(y)
        drain = lim.process(
            np.zeros((int(C), lim.cfg.delay_size), np.float32))
        out = np.concatenate([out, drain], axis=1)
        return np.asarray(quantize_interleave(out, self.bits))

    def decode_all(self, fetch: bool = True):
        """Decode everything (all reconfigure segments); returns
        [samples, out_channels] int PCM, or with fetch=False the on-device
        batch list."""
        out = self._decode_segment(fetch)
        if self._next_data is None:
            return out
        if self.cfg.limiter is not None:
            # the reference reconfigure re-inits the limiter WITHOUT
            # flushing its delay line (configure :3810; the player
            # reconfigures on INVALID_STATE with no data==NULL flush), so a
            # non-final segment's last delay_size delayed samples are never
            # emitted — drop our drained tail to match the serial path
            d = self.cfg.limiter.delay_size
            if fetch:
                out = out[:-d] if out.shape[0] > d else out[:0]
            elif out:
                out[-1] = out[-1][:-d]
        child = BatchedStreamDecoder(self._next_data, **self._init_kw)
        nxt = child.decode_all(fetch)
        self.stats.setdefault("segments", []).append(child.stats)
        if fetch:
            return np.concatenate([out, nxt], axis=0)
        return out + nxt

    def _decode_segment(self, fetch: bool = True):
        """Decode this segment; returns [samples, out_channels] int PCM.

        Host unpack is a single vectorized pass; device batches are enqueued
        asynchronously (JAX dispatch) and results fetched at the end, so
        host<->device transfers overlap with compute. fetch=False leaves the
        PCM on device (list of [B*T, ch] batches, synced) — used by the
        bench to separate decode throughput from host-transfer bandwidth.
        """
        B = self.batch_frames
        T = self.frame_size
        n = self.n_frames
        if self.needs_resample and not fetch:
            raise ValueError(
                f"stream rate {self.stream_rate} != 48000: the host "
                f"resample tail needs fetch=True")
        plan = _HostPlan(self)
        n_batches = plan.n_batches
        stream_params = plan.stream_params

        import concurrent.futures as _cf

        # Fetch policy: fetch NOTHING until every batch is dispatched, so
        # no device-to-host copy queues ahead of the next batches'
        # host-to-device puts; then 8 reader threads pull whole batch
        # buffers concurrently, overlapping the tail batches' device
        # compute. Whether overlapping the fetch with dispatch wins over
        # PCIe is open (ROADMAP, queue 1 item 5).
        fetch_pool = _cf.ThreadPoolExecutor(8) if (
            fetch and not self.needs_resample) else None
        device_outs = []
        kinds = plan.kinds
        step_carry = plan.carry
        lead = self.lead
        want = plan.want
        k0 = plan.k0

        zero_bufs = None
        for bi in range(plan.total_calls):
            np_bufs = plan.next_bufs()
            if np_bufs is not None:
                bufs = [jnp.asarray(b) for b in np_bufs]
                zero_bufs = [jnp.zeros(b.shape, b.dtype) for b in bufs]
            else:
                bufs = zero_bufs  # flush: zero input, neutral params
            step_carry, pcm = _fused_decode(
                self.cfg, kinds, step_carry, stream_params, bufs)
            device_outs.append(pcm)

        plan.close()
        if not fetch:
            if device_outs:
                device_outs[-1].block_until_ready()
            # strip the head-trim warm-up call and trailing flush batches so
            # device-resident callers get exactly the n_batches stream
            # outputs (same contract as before the pre-limiter trim splice)
            return device_outs[k0:k0 + n_batches]
        if self.needs_resample:
            # stay on device through the resampler; only the resampled
            # (smaller) float mix crosses to the host for the output tail
            dev = jnp.concatenate(device_outs[k0:], axis=0)
            return self._resample_tail(dev)
        # dispatches (and their h2d puts) are all enqueued: pull every
        # batch in parallel straight into one preallocated output, skipping
        # the first k0 warm-up batches (pure zeros under the head-trim
        # splice)
        to_fetch = device_outs[k0:]
        rows = B * T
        full = np.empty((len(to_fetch) * rows, int(to_fetch[0].shape[1])),
                        dtype=np.dtype(str(to_fetch[0].dtype)))

        def _pull(i):
            full[i * rows:(i + 1) * rows] = np.asarray(to_fetch[i])

        list(fetch_pool.map(_pull, range(len(to_fetch))))
        fetch_pool.shutdown()
        if self.cfg.limiter is not None:
            # limiter look-ahead: drop the first delay_size rows; the
            # trailing pad batches already pushed zeros through the delay
            # line (iamf_delay_buffer_handle IAMF_decoder.c:3250-3301)
            d = self.cfg.limiter.delay_size
            if self.cfg.head_trim:
                # head trim was spliced out pre-limiter, tail zeroed via
                # the out-gain mask: `full` IS the trimmed timeline
                return full[d: d + want]
            # fallback (head trim larger than a batch): trim after the
            # limiter — the pre-round-2 approximation
            out = full[d: d + n * T]
            return out[lead: lead + want]
        return full[lead: lead + want]
