"""Multi-stream batched serving: decode a fleet of IAMF streams in as few
device programs as possible.

The reference decoder is strictly single-stream (one `IAMF_DecoderHandle`
per stream, `IAMF_decoder_decode` one access unit at a time,
/root/reference/src/iamf_dec/IAMF_decoder.c:3935); serving N streams
means N independent handles on N cores. Here the decode step is vmapped
over a leading stream axis, so a bucket of streams costs ONE dispatch per
frame batch (with S thread-driven decoders the dispatch and the per-put
host-to-device queueing multiply by S; stacked, they are paid once) and
the device sees one big program with S times the parallel work.

Heterogeneous fleets: streams are BUCKETED by their compiled-program key
(pipeline cfg + synthesis kinds + parameter-bank shapes); each bucket runs
its own vmapped program. Within a bucket, streams of different lengths are
padded to the longest member — neutral parameter rows and zero input
batches past a stream's end (the extra outputs are dropped per stream), so
every stream's kept batches see exactly the inputs its own decode would.
Correctness bar: per-stream output identical to that stream's own
BatchedStreamDecoder.decode_all (test_serving.py, bit-exact, including
mixed-length and mixed-codec fleets)."""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .batch_decoder import (BatchedStreamDecoder, _fused_decode_body,
                            _HostPlan, plan_kinds)


@partial(jax.jit, static_argnums=(0, 1))
def _fused_decode_multi(cfg, kinds: tuple, carry, params, bufs):
    """The fused decode step vmapped over a leading stream axis: carry,
    params, and every input buffer are [S, ...]-stacked pytrees."""

    def step(c, p, *b):
        return _fused_decode_body(cfg, kinds, c, p, list(b))

    return jax.vmap(step)(carry, params, *bufs)


def _stack(*leaves):
    return jnp.stack(leaves)


def _shape_sig(tree) -> tuple:
    """Shape/dtype signature of a params pytree — part of the bucket key
    (e.g. demix-matrix bank sizes differ between streams with otherwise
    identical configs, and the [S, ...] stack must be rectangular)."""
    leaves = jax.tree.leaves(tree)
    return tuple((tuple(l.shape), str(l.dtype)) for l in leaves)


class MultiStreamServer:
    """Decode a fleet of complete IAMF streams concurrently on one chip.

    streams: list of in-memory IAMF byte streams. Decoder options
    (sound_system, batch_frames, ...) are shared. Streams may differ in
    length, codec, and content — same-program streams share one vmapped
    dispatch; the rest split into further buckets.
    """

    def __init__(self, streams, **kw):
        self.decs = [BatchedStreamDecoder(s, **kw) for s in streams]
        for d in self.decs:
            if d.needs_resample:
                raise ValueError("rate-mismatch streams need the host "
                                 "resample tail; serve them per-stream")
            if d._next_data is not None:
                raise ValueError("mid-stream reconfigure streams are not "
                                 "servable on the vmapped path")
        # program-level buckets; the final (param-shape) level needs built
        # plans, so it happens in decode_all
        self._groups: dict = {}
        for i, d in enumerate(self.decs):
            self._groups.setdefault((d.cfg, plan_kinds(d)), []).append(i)

    @property
    def n_buckets(self) -> int:
        return len(self._groups)

    def decode_all(self):
        """Decode every stream; returns a list (original stream order) of
        per-stream device-array lists ([B*T, ch] int PCM batches), the
        same device-resident contract as decode_all(fetch=False)."""
        results: list = [None] * len(self.decs)
        for (cfg, kinds), idxs in self._groups.items():
            decs = [self.decs[i] for i in idxs]
            B = decs[0].batch_frames
            max_nb = max(-(-d.n_frames // B) for d in decs)
            rows = (max_nb + 1) * B
            plans = [_HostPlan(d, rows=rows) for d in decs]
            # final bucket level: parameter-bank shapes must stack
            sub: dict = {}
            for i, p in zip(idxs, plans):
                sub.setdefault(_shape_sig(p.stream_params), []).append(
                    (i, p))
            for members in sub.values():
                self._decode_bucket(cfg, kinds,
                                    [m[1] for m in members], results,
                                    [m[0] for m in members])
        return results

    def _decode_bucket(self, cfg, kinds, plans, results, idxs):
        p0 = plans[0]
        total_calls = max(p.total_calls for p in plans)
        carry = jax.tree.map(_stack, *[p.carry for p in plans])
        params = jax.tree.map(_stack, *[p.stream_params for p in plans])

        device_outs = []
        zeros = None  # per-element zero input (shared: same shapes)
        for _ in range(total_calls):
            per_stream = [p.next_bufs() for p in plans]
            n_elems = len(plans[0].dec.elems)
            if any(nb is not None for nb in per_stream):
                if zeros is None:
                    ref = next(nb for nb in per_stream if nb is not None)
                    zeros = [jnp.zeros(a.shape, a.dtype) for a in ref]
                # per-stream h2d puts + a device-side stack: a host
                # np.stack would copy the whole bucket's input again
                # (~12 MB/batch) before the put. Exhausted (shorter)
                # streams feed zeros — their extra outputs are dropped.
                bufs = [
                    jnp.stack([jnp.asarray(nb[i]) if nb is not None
                               else zeros[i] for nb in per_stream])
                    for i in range(n_elems)
                ]
                zero_bufs = [jnp.zeros(b.shape, b.dtype) for b in bufs]
            else:
                bufs = zero_bufs  # flush calls: zero input, neutral params
            carry, pcm = _fused_decode_multi(cfg, kinds, carry, params,
                                             bufs)
            device_outs.append(pcm)  # [S, B*T, ch]
        for p in plans:
            p.close()
        if device_outs:
            device_outs[-1].block_until_ready()
        for s, (i, p) in enumerate(zip(idxs, plans)):
            kept = device_outs[p.k0:p.k0 + p.n_batches]
            results[i] = [batch[s] for batch in kept]
