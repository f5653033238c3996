"""Pipeline-parallel (PP) decode: stage split across two devices.

SURVEY §2.4's pipeline row — "stage split parse -> decode -> demix ->
render -> post across chips; stage-boundary activations are planar frame
tensors" — on the REAL decoder. Stage A (device 0) runs the codec
synthesis (the FLOP-heavy IMDCT/filterbank matmuls, opus comb +
de-emphasis); stage B (device 1) runs demix -> render -> mix -> limiter ->
quantize (which contains the SEQUENTIAL limiter recurrence). The stages
are separate jitted programs pinned to their device by input placement;
JAX's async dispatch pipelines the microbatches: while device 1
serializes the limiter for batch t-1, device 0 is already computing the
filterbank for batch t, with the [B, C, T] activation crossing between the
devices as the stage boundary.

Each stage keeps its own carry resident on its device (synthesis overlap/
comb history on A, limiter/pos/splice on B), so the only cross-device
traffic is the activation itself. Output is bit-identical to the
single-device BatchedStreamDecoder: the stages are the same compiled
functions the fused path uses, merely split at the synthesis boundary.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core.batch_decoder import BatchedStreamDecoder, _BATCH_COMB_CHUNK
from ..core.pipeline import decode_frames, init_carry, put_stream_params


class PipelinedStreamDecoder:
    """Two-stage pipelined decode of a complete in-memory IAMF stream."""

    def __init__(self, data: bytes, devices=None, sound_system: int = 0,
                 bits: int = 16, batch_frames: int = 128,
                 limiter: bool = True):
        if devices is None:
            devices = jax.devices()[:2]
        if len(devices) < 2:
            raise ValueError("pipeline parallelism needs 2 devices")
        self.dev_a, self.dev_b = devices[0], devices[1]
        self.base = BatchedStreamDecoder(
            data, sound_system=sound_system, bits=bits,
            batch_frames=batch_frames, limiter=limiter)
        if self.base.needs_resample:
            raise ValueError("use BatchedStreamDecoder for rate-mismatch "
                             "streams")

    def decode_all(self) -> np.ndarray:
        base = self.base
        cfg = base.cfg
        B, T, n = base.batch_frames, base.frame_size, base.n_frames
        n_batches = -(-n // B)

        # stage-B state: whole-stream params + pipeline carry on device B
        params = jax.device_put(
            put_stream_params(cfg, base.params, (n_batches + 1) * B),
            self.dev_b)
        pipe_carry = jax.device_put(init_carry(cfg), self.dev_b)

        # stage-A state: per-element synthesis carries on device A
        syn_carry = []
        elem_packets = []
        elem_all_x = []
        for e in base.elems:
            packets = [base.frames_per_substream[sid]
                       for sid in e.substream_ids]
            elem_packets.append(packets)
            if e.opus:
                syn_carry.append(jax.device_put(
                    base.opus_synth.init_carry(
                        sum(ch for _, ch in e.codec._decoders)), self.dev_a))
                elem_all_x.append(None)
            elif e.aac:
                syn_carry.append(jax.device_put(
                    base.aac_synth.init_carry(
                        sum(ch for _, ch in e.codec._decoders)), self.dev_a))
                elem_all_x.append(None)
            elif e.raw_input:
                syn_carry.append(None)
                elem_all_x.append(e.codec.decode_batch_raw(packets, T)[0])
            elif hasattr(e.codec, "decode_batch"):
                syn_carry.append(None)
                elem_all_x.append(e.codec.decode_batch(packets, T))
            else:
                syn_carry.append(None)
                elem_all_x.append(np.stack(
                    [e.codec.decode([p[k] for p in packets])
                     for k in range(n)]))

        # identical output bookkeeping to BatchedStreamDecoder.decode_all
        lead, tail = base.lead, base.tail
        want = n * T - lead - tail
        k0 = 1 if cfg.head_trim else 0
        if cfg.limiter is not None:
            needed = want + cfg.limiter.delay_size
            if not cfg.head_trim:
                needed = n * T + cfg.limiter.delay_size
        else:
            needed = want + lead
        total_calls = n_batches
        while (total_calls - k0) * B * T < needed:
            total_calls += 1

        outs = []
        zero_acts = None
        for bi in range(total_calls):
            if bi < n_batches:
                start = bi * B
                count = min(B, n - start)
                acts = []
                for i, e in enumerate(base.elems):
                    # host entropy/unpack, then stage A on device A
                    if e.opus:
                        nf, kf, hyb = e.opus_cfg
                        buf, _ = base._opus_entropy(
                            e, elem_packets[i], start, count, B)
                        buf = jax.device_put(buf, self.dev_a)
                        x, syn_carry[i] = base.opus_synth.synthesize_packed(
                            buf, syn_carry[i], chunk=_BATCH_COMB_CHUNK,
                            n=nf, hybrid=hyb)
                        if kf > 1:
                            Bu, L = x.shape[0] // kf, x.shape[1]
                            x = x.reshape(Bu, kf, L, nf).transpose(
                                0, 2, 1, 3).reshape(Bu, L, kf * nf)
                    elif e.aac:
                        buf, _ = base._aac_entropy(
                            e, elem_packets[i], start, count, B)
                        buf = jax.device_put(buf, self.dev_a)
                        x, syn_carry[i] = base.aac_synth.synthesize_packed(
                            buf, syn_carry[i])
                    else:
                        xs_np = elem_all_x[i][start:start + count]
                        if count < B:
                            xs_np = np.concatenate(
                                [xs_np, np.zeros((B - count,)
                                                 + xs_np.shape[1:],
                                                 xs_np.dtype)])
                        x = jax.device_put(xs_np, self.dev_a)
                    # stage boundary: the planar frame activation crosses
                    # to device B (async; overlaps A's next batch)
                    acts.append(jax.device_put(x, self.dev_b))
                zero_acts = [jnp.zeros(a.shape, a.dtype) for a in acts]
                zero_acts = [jax.device_put(z, self.dev_b)
                             for z in zero_acts]
            else:
                acts = zero_acts  # flush: zero input, neutral params
            pipe_carry, pcm = decode_frames(cfg, pipe_carry, params, acts)
            outs.append(pcm)

        full = np.concatenate([np.asarray(o) for o in outs[k0:]], axis=0)
        if cfg.limiter is not None:
            d = cfg.limiter.delay_size
            if cfg.head_trim:
                return full[d: d + want]
            out = full[d: d + n * T]
            return out[lead: lead + want]
        return full[lead: lead + want]
