"""Frame-parallel SPMD decode of a real IAMF stream over a device mesh.

This shards the ACTUAL decoder (the same host parse / timeline replay /
codec unpack as core.batch_decoder.BatchedStreamDecoder and the same device
compute as core.pipeline._frame_compute) across the `frames` axis of a
jax.sharding.Mesh — SURVEY.md §2.4's frame/data-parallel strategy — with
exact hand-off of every cross-frame recurrence, so the sharded output is
bit-identical to the single-device decode:

1. **Overlap prefix re-decode (the roll-distance idiom).** The codec
   filterbanks carry a one-frame overlap (CELT TDAC tail, AAC overlap-add
   half): a pure function of the neighbouring frame's spectra. Each shard
   receives ONE extra leading frame (IAMF's `audio_roll_distance` hook,
   reference IAMF_OBU.c:320 / mp4 `sgpd` mp4demux.c:88, exists for exactly
   this random-access prefix re-decode), reruns the filterbank, and drops
   the prefix row — exact, because the overlap depends only on that frame.

2. **Exact IIR carry chains via ppermute.** The remaining recurrences are
   IIRs over the whole timeline whose convergence under prefix re-decode
   is content-dependent (the CELT post-filter decays as gain^(t/period):
   a 462-LSB residual survives 6 frames of preroll on period-652 content,
   and the limiter envelope has no roll-in at all). These run as
   sequential shard chains: S `ppermute` hops carry (comb history,
   de-emphasis memory) — and later the limiter envelope (gain curve
   position + delay line + peak ring, compute_target_gain
   audio_effect_peak_limiter.c:237-265) — from shard k to k+1, each hop
   finalising one shard. The expensive stages (IMDCT/filterbank
   matmuls, demix chains, render matmuls, mixing) stay fully parallel;
   only the cheap elementwise IIRs serialize, costing the same wall time
   as the serial decode's own IIR pass.

All other sequential state (demix mode / w-index walk, recon-gain EMA,
mix-gain curves) is already replayed on the host into dense per-frame
tensors (core/timeline.py), so frame sharding just slices those tensors.

Multi-host: the same program runs unchanged over a mesh spanning processes
(jax.distributed); inputs are materialised per-process with
jax.device_put under a NamedSharding so each host touches only its own
shards (tests/test_multihost.py runs the fake-cluster recipe).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.batch_decoder import BatchedStreamDecoder
from ..core.pipeline import PipelineConfig, _element_frame, _frame_compute
from ..dsp.limiter import init_state, process_block
from ..dsp.quantize import quantize_interleave


def _pvary(tree, axes):
    if isinstance(axes, str):
        axes = (axes,)
    return jax.tree.map(
        lambda a: jax.lax.pcast(a, tuple(axes), to="varying"), tree)


def _limiter_shard_chain(cfg, flat, n_shards: int, axis: str,
                         vary_axes=("frames",)):
    """Sequential limiter chain across the mesh's shard axis.

    flat: this shard's mixed samples [out, F*T]. Runs S hops; at hop k,
    shard k holds the exact envelope state chained through shards 0..k-1,
    limits its own samples, and ppermutes its final state to shard k+1.
    Returns (y [out, F*T], final_state) — final_state is only meaningful
    on the last shard (the caller selects row S-1 for the flush drain).
    """
    lim = cfg.limiter
    idx = jax.lax.axis_index(axis)
    state0 = _pvary(init_state(lim), vary_axes)
    y0 = jnp.zeros_like(flat)
    perm = [(i, i + 1) for i in range(n_shards - 1)]

    def body(k, carry):
        state, y, final = carry
        new_state, yk = process_block(lim, state, flat)
        mine = (idx == k)
        y = jnp.where(mine, yk, y)
        final = jax.tree.map(
            lambda f, n: jnp.where(mine, n, f), final, new_state)
        state = jax.tree.map(
            lambda a: jax.lax.ppermute(a, axis, perm), new_state)
        return state, y, final

    _, y, final = jax.lax.fori_loop(0, n_shards, body, (state0, y0, state0))
    return y, final


class ShardedStreamDecoder:
    """Decode a complete in-memory IAMF stream sharded over a device mesh.

    Reuses BatchedStreamDecoder's host side (OBU parse, parameter-timeline
    replay, codec entropy/unpack) and shards the device pipeline over the
    mesh's 'frames' axis. Output is bit-identical to the single-device
    batched decode (tests/test_sharded_decoder.py pins this, including a
    limiter excursion crossing a shard boundary and CELT post-filter
    state crossing every boundary).
    """

    def __init__(self, data: bytes, mesh: Mesh | None = None,
                 n_devices: int | None = None, sound_system: int = 0,
                 bits: int = 16, limiter: bool = True,
                 element_axis: int = 1, substream_axis: int = 1):
        if element_axis > 1 and substream_axis > 1:
            raise ValueError("element_axis and substream_axis are "
                             "mutually exclusive (use a 2-D mesh)")
        if mesh is None:
            n = n_devices or len(jax.devices())
            if element_axis > 1 or substream_axis > 1:
                second = max(element_axis, substream_axis)
                name = "elements" if element_axis > 1 else "substreams"
                f = n // second
                if f < 1:
                    raise ValueError(
                        f"{name} axis of {second} needs >= that many "
                        f"devices, have {n}")
                mesh = Mesh(
                    np.array(jax.devices()[: f * second]).reshape(f, second),
                    axis_names=("frames", name))
            else:
                mesh = Mesh(np.array(jax.devices()[:n]),
                            axis_names=("frames",))
        self.mesh = mesh
        self.n_shards = mesh.shape["frames"]
        self.n_eshards = dict(mesh.shape).get("elements", 1)
        self.n_sshards = dict(mesh.shape).get("substreams", 1)
        self.base = BatchedStreamDecoder(
            data, sound_system=sound_system, bits=bits, limiter=limiter,
            batch_frames=128,  # only gates head_trim; we drive the pipeline
        )
        base = self.base
        # per-element overlap prefix: 1 frame for DEVICE filterbank carries
        # (host-decoded opus shapes ship final samples — no preroll)
        self.prerolls = tuple(
            1 if ((e.opus and e.opus_cfg == (960, 1, False)) or e.aac)
            else 0 for e in base.elems)
        # the stream's declared random-access prefix (informational; the
        # exact carry chains supersede deep preroll re-decode)
        self.roll_distance = max(
            (abs(int(base.db.elements[e.stream.element_id]
                     .codec_config.roll_distance)) for e in base.elems),
            default=0)
        self.preroll = max(self.prerolls)
        n = base.n_frames
        self.frames_per_shard = -(-n // self.n_shards)
        self.n_frames = n
        if base.cfg.head_trim > self.frames_per_shard * base.frame_size:
            # the head-trim halo shift only reaches one shard to the left;
            # a longer trim needs the batched decoder's post-limiter trim
            # fallback (head_trim=0), which this sharded path does not
            # replicate — fail loudly instead of corrupting the halo
            raise ValueError(
                f"trimming_start ({base.cfg.head_trim} samples) exceeds one "
                f"shard ({self.frames_per_shard * base.frame_size} samples); "
                f"use fewer shards or the single-device BatchedStreamDecoder")

    def _shard_rows(self, a: np.ndarray, fill, preroll: int) -> np.ndarray:
        """[N, ...] per-frame rows -> [S, preroll+F, ...] with the preroll
        rows duplicated from the left neighbour's region and out-of-range
        rows filled neutrally."""
        S, F, R = self.n_shards, self.frames_per_shard, preroll
        out = np.empty((S, R + F) + a.shape[1:], a.dtype)
        n = a.shape[0]
        for s in range(S):
            lo = s * F - R
            for j in range(R + F):
                i = lo + j
                if 0 <= i < n:
                    out[s, j] = a[i]
                else:
                    out[s, j] = fill
        return out

    def _put(self, a: np.ndarray, spec: P):
        return jax.device_put(a, NamedSharding(self.mesh, spec))

    @staticmethod
    def _fetch(arr) -> np.ndarray:
        """Materialise a (possibly multi-host) sharded array on every host.

        Single-process: plain d2h. Multi-process (jax.distributed over
        DCN): an ordered `process_allgather` — each host contributes its
        addressable PCM shards and receives the full timeline in order
        (SURVEY §2.4's 'ordered gather of PCM to host 0'; every host gets
        a copy, host 0 is the one that writes the WAV)."""
        if getattr(arr, "is_fully_addressable", True):
            return np.asarray(arr)
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(arr, tiled=True))

    def decode_all(self) -> np.ndarray:
        base = self.base
        cfg = base.cfg
        S, F = self.n_shards, self.frames_per_shard
        T = cfg.frame_size
        n = self.n_frames

        # ---- host: per-element whole-stream unpack (identical to the
        # batched path), then shard (+ overlap prefix row for filterbanks)
        xs_sharded = []
        chunks = []
        kinds = []
        lanes = []  # true per-element lane count (pre substream padding)
        for i, e in enumerate(base.elems):
            packets = [base.frames_per_substream[sid]
                       for sid in e.substream_ids]
            chunk = None
            if e.opus:
                if e.opus_cfg != (960, 1, False):
                    # the sharded preroll/carry machinery pins the flagship
                    # CELT-960 operating point; other opus shapes decode on
                    # the host and shard as raw frames
                    buf = e.codec.decode_batch(packets, T)[:n]
                    kinds.append("raw")
                    chunks.append(None)
                    buf = np.asarray(buf)
                    lanes.append(buf.shape[1])
                    xs_sharded.append(self._put(
                        self._shard_rows(buf, 0, self.prerolls[i]),
                        P("frames")))
                    continue
                buf, chunk = base._opus_entropy(e, packets, 0, n, n)
                kinds.append("opus")
            elif e.aac:
                buf, _ = base._aac_entropy(e, packets, 0, n, n)
                kinds.append("aac")
            elif e.raw_input:
                buf = e.codec.decode_batch_raw(packets, T)[0][:n]
                kinds.append("raw")
            elif hasattr(e.codec, "decode_batch"):
                buf = e.codec.decode_batch(packets, T)[:n]
                kinds.append("raw")
            else:
                buf = np.stack([
                    e.codec.decode([p[k] for p in packets])
                    for k in range(n)])
                kinds.append("raw")
            chunks.append(chunk)
            buf = np.asarray(buf)
            lanes.append(buf.shape[1])
            spec = P("frames")
            if self.n_sshards > 1:
                # substream-parallel (TP): shard the lane/channel axis;
                # pad to divisibility with neutral rows (zero spectra;
                # opus packed periods floored to MINPERIOD so the comb
                # gather stays in range — the padded lanes synthesize
                # silence and are sliced off after the all_gather)
                Ss = self.n_sshards
                Lp = -(-buf.shape[1] // Ss) * Ss
                if Lp != buf.shape[1]:
                    pad = np.zeros(
                        (buf.shape[0], Lp - buf.shape[1]) + buf.shape[2:],
                        buf.dtype)
                    if kinds[-1] == "opus":
                        from ..codecs.opus import tpu_synth

                        pad[..., tpu_synth.PACKED_T_OLD] = 15
                        pad[..., tpu_synth.PACKED_T_CUR] = 15
                        pad[..., tpu_synth.PACKED_T_NEW] = 15
                    buf = np.concatenate([buf, pad], axis=1)
                spec = P("frames", None, "substreams")
            xs_sharded.append(self._put(
                self._shard_rows(buf, 0, self.prerolls[i]), spec))

        # ---- host: shard the replayed parameter timeline (no preroll —
        # parameters are pure per-frame data)
        tl = base.params
        params = {
            "factors": [], "rg": [], "mats": [], "mat_idx": [],
            "elem_gain": [],
        }
        for ep in tl.elements:
            params["factors"].append(self._put(
                self._shard_rows(ep.factors, 1.0, 0), P("frames")))
            params["rg"].append(self._put(
                self._shard_rows(ep.rg, 0.0, 0), P("frames")))
            params["mats"].append(jnp.asarray(ep.mats))  # replicated, tiny
            params["mat_idx"].append(self._put(
                self._shard_rows(ep.mat_idx.astype(np.int32), 0, 0),
                P("frames")))
            params["elem_gain"].append(self._put(
                self._shard_rows(ep.gain.astype(np.float32), 1.0, 0),
                P("frames")))
        params["out_gain"] = self._put(
            self._shard_rows(tl.out_gain.astype(np.float32), 1.0, 0),
            P("frames"))

        pcm_shards, final_lim = _sharded_program(
            self.mesh, cfg, S, tuple(kinds), self.prerolls,
            tuple(chunks), self.n_eshards, self.n_sshards,
            tuple(lanes))(tuple(xs_sharded), params)

        pcm = self._fetch(pcm_shards).reshape(S * F * T, cfg.out_channels)

        # ---- host: limiter delay/drain + edge trims (same semantics as
        # BatchedStreamDecoder.decode_all). The trailing padded zero frames
        # already ran through the limiter chain, so the rows right after
        # the stream ARE the flush drain; only when the stream fills the
        # mesh exactly is an explicit drain step needed.
        lead, tail = base.lead, base.tail
        want = n * T - lead - tail
        if cfg.limiter is not None:
            d = cfg.limiter.delay_size
            # with the splice halo, pcm IS the trimmed timeline; otherwise
            # (head trim absent or too large) trim after the limiter
            start = d if cfg.head_trim else d + lead
            if start + want <= pcm.shape[0]:
                out = pcm[start: start + want]
            else:
                out = pcm[start:]
                missing = start + want - pcm.shape[0]
                state = jax.tree.map(
                    lambda a: jnp.asarray(self._fetch(a)[S - 1]), final_lim)
                _, drain = process_block(
                    cfg.limiter, state,
                    jnp.zeros((cfg.out_channels, d), jnp.float32))
                q = np.asarray(quantize_interleave(drain, cfg.bits))
                out = np.concatenate([out, q[:missing]], axis=0)
            return out
        return pcm[lead: lead + want]


def _comb_chain(cfg, opus_sig: dict, chunks: tuple, n_shards: int,
                vary_axes: tuple = ("frames",)):
    """Stage 2: the CELT comb post-filter + de-emphasis IIR chains across
    the 'frames' axis (exact ppermute hand-off; see module docstring).

    opus_sig: {elem index: (sig [L, N], coeff tensors)}. Returns
    {elem index: pcm [L, N]} (s16-granular float)."""
    from ..codecs.opus import tpu_synth

    idx = jax.lax.axis_index("frames")
    perm = [(i, i + 1) for i in range(n_shards - 1)]
    carry0 = {
        i: (_pvary(jnp.zeros((opus_sig[i][0].shape[0], tpu_synth.HIST),
                             jnp.float32), vary_axes),
            _pvary(jnp.zeros((opus_sig[i][0].shape[0],), jnp.float32),
                   vary_axes))
        for i in opus_sig
    }
    outs0 = {i: jnp.zeros_like(opus_sig[i][0]) for i in opus_sig}

    def body(k, c):
        carry, outs = c
        mine = (idx == k)
        new_carry = {}
        for i in opus_sig:
            sig, coeffs = opus_sig[i]
            hist, demem = carry[i]
            pcm, hist2, demem2 = tpu_synth.comb_deemph(
                sig, coeffs, hist, demem, chunks[i] or 104)
            outs[i] = jnp.where(mine, pcm, outs[i])
            new_carry[i] = (
                jax.lax.ppermute(
                    jnp.where(mine, hist2, hist), "frames", perm),
                jax.lax.ppermute(
                    jnp.where(mine, demem2, demem), "frames", perm),
            )
        return new_carry, outs

    _, outs = jax.lax.fori_loop(0, n_shards, body, (carry0, outs0))
    return outs


def _post_mix(cfg: PipelineConfig, flat, n_shards: int,
              vary_axes=("frames",)):
    """Stages after the element mix: head-trim splice halo, limiter chain,
    quantize. flat: [out, F*T] this shard's mixed samples."""
    if cfg.head_trim:
        # pre-limiter trim splice, sharded form: the stream's leading
        # trimmed samples (zeroed by the out-gain mask) are deleted from
        # the global timeline by shifting every shard left by head_trim —
        # one ppermute halo of the RIGHT neighbour's first samples (the
        # last shard backfills with zeros: pad region)
        h = cfg.head_trim
        halo = jax.lax.ppermute(
            flat[:, :h], "frames",
            [(i, i - 1) for i in range(1, n_shards)])
        flat = jnp.concatenate([flat[:, h:], halo], axis=1)

    if cfg.limiter is not None:
        y, final = _limiter_shard_chain(cfg, flat, n_shards, "frames",
                                        vary_axes)
    else:
        y = flat
        final = _pvary(jnp.zeros(()), vary_axes)

    pcm = quantize_interleave(y, cfg.bits)  # [F*T, out]
    return pcm, final


def _sharded_program(mesh: Mesh, cfg: PipelineConfig, n_shards: int,
                     kinds: tuple, prerolls: tuple, chunks: tuple,
                     n_eshards: int = 1, n_sshards: int = 1,
                     lanes: tuple = ()):
    """Build the jitted shard_map decode program.

    fn(xs: tuple of [S, R_e+F, ...] sharded over 'frames' (replicated over
       'elements' when that axis exists),
       params: pytree of [S, F, ...] sharded (+ replicated mats))
    -> (pcm [S, F*T, out] sharded, final limiter state stacked [S, ...]).

    With n_eshards > 1 the mesh is 2-D (frames, elements) and the per-
    element compute is sharded over the elements axis: element i belongs
    to element-shard i % n_eshards; each shard runs only its elements'
    filterbank/demix/render (jax.lax.switch on the axis index — every
    device runs the same program, the branch picks the owned subset), and
    the mix is a psum over 'elements' — the reference's mixer sum
    (iamf_mixer_mix, IAMF_decoder.c:2702-2733) as the collective. The
    cheap sequential IIR chains (comb/de-emphasis, limiter) run on every
    element row on the psum-replicated data, keeping all collectives
    outside the switch branches.
    """
    n_e = len(cfg.elements)
    T = cfg.frame_size
    opus_idx = [i for i, k in enumerate(kinds) if k == "opus"]
    perm = [(i, i + 1) for i in range(n_shards - 1)]

    def _stage12(xs, vary_axes=("frames",)):
        """Stage 1 (filterbanks / raw input) + stage 2 (comb/de-emphasis
        chains over 'frames') on this shard's lanes; returns x_list."""
        x_list = [None] * n_e
        opus_sig = {}
        for i in range(n_e):
            if kinds[i] == "opus":
                from ..codecs.opus import tpu_synth

                opus_sig[i] = tpu_synth.shard_stages(xs[i], prerolls[i])
            elif kinds[i] == "aac":
                from ..codecs.aac import tpu_synth as aac_synth

                nl = xs[i].shape[1]
                x, _ = aac_synth.synthesize_packed(
                    xs[i], aac_synth.init_carry(nl))
                x_list[i] = x[prerolls[i]:]
            else:
                x_list[i] = xs[i][prerolls[i]:]
        if opus_idx:
            outs = _comb_chain(cfg, opus_sig, chunks, n_shards, vary_axes)
            for i in opus_idx:
                L = outs[i].shape[0]
                x_list[i] = outs[i].reshape(L, -1, T).transpose(1, 0, 2)
        return x_list

    def _stage34(x_list, params, vary_axes=("frames",)):
        """Stage 3 (demix + render + gains + mix) + stage 4 (trim splice
        halo + limiter chain + quantize)."""
        pf = {
            "x": x_list,
            "factors": [params["factors"][i][0] for i in range(n_e)],
            "rg": [params["rg"][i][0] for i in range(n_e)],
            "m_prev": [params["mats"][i][params["mat_idx"][i][0][:, 0]]
                       for i in range(n_e)],
            "m_cur": [params["mats"][i][params["mat_idx"][i][0][:, 1]]
                      for i in range(n_e)],
            "elem_gain": [params["elem_gain"][i][0] for i in range(n_e)],
            "out_gain": params["out_gain"][0],
        }
        mixed = jax.vmap(lambda inp: _frame_compute(cfg, inp))(pf)
        Fl = mixed.shape[0]
        flat = mixed.transpose(1, 0, 2).reshape(cfg.out_channels, Fl * T)
        return _post_mix(cfg, flat, n_shards, vary_axes)

    def local(xs, params):
        # leading shard axis is size 1 locally under shard_map: drop it
        xs = [x[0] for x in xs]
        x_list = _stage12(xs)
        pcm, final = _stage34(x_list, params)
        return pcm[None], jax.tree.map(lambda a: a[None], final)

    def local_substreams(xs, params):
        """2-D (frames, substreams) variant — SURVEY §2.4 substream/TP:
        the lane (substream-channel) axis of each element's filterbank +
        comb/de-emphasis runs sharded over 'substreams' (independent by
        spec: entropy is per-substream, the IIRs are per-lane), then an
        all_gather reassembles the element's channels before the demix —
        exactly the SURVEY row's 'none during entropy decode; all-gather
        before demix'. The post-mix chains run on every substream row on
        gathered data."""
        xs = [x[0] for x in xs]
        x_list = _stage12(xs, vary_axes=("frames", "substreams"))
        si = jax.lax.axis_index("substreams")
        for i in range(n_e):
            # gather-as-psum: each row scatters its lane slab at its mesh
            # offset and the psum reassembles the full element on every
            # row. Unlike all_gather (whose output keeps the 'substreams'
            # varying tag the checker cannot discharge), psum provably
            # REMOVES the axis, so check_vma stays enabled for this
            # variant; the re-pvary below is the legal replicated->varying
            # cast for the downstream shared stages.
            loc = x_list[i]
            ll = loc.shape[1]
            full = jnp.zeros(
                loc.shape[:1] + (ll * n_sshards,) + loc.shape[2:],
                loc.dtype)
            full = jax.lax.dynamic_update_slice_in_dim(
                full, loc, si * ll, axis=1)
            g = jax.lax.psum(full, "substreams")
            x_list[i] = g[:, :lanes[i]]  # drop the divisibility padding
        # post-psum values are provably replicated over 'substreams', so
        # the shared stages run frames-varying only and the out_specs'
        # substreams replication type-checks
        pcm, final = _stage34(x_list, params)
        return pcm[None], jax.tree.map(lambda a: a[None], final)

    def local_elements(xs, params):
        """2-D (frames, elements) variant: per-element work sharded over
        the elements axis, psum mixer, IIR chains on replicated data."""
        from ..codecs.opus import tpu_synth

        xs = [x[0] for x in xs]
        ei = jax.lax.axis_index("elements")
        owner = [i % n_eshards for i in range(n_e)]
        Fl = params["out_gain"][0].shape[0]

        # ---- phase A (element-sharded): opus IMDCT filterbanks -> lane
        # slabs. Each branch computes shard_stages only for its owned
        # elements and zero-fills the rest; the psum over 'elements'
        # reassembles the full slab on every row (collective OUTSIDE the
        # switch, so every device always executes it).
        x_list = [None] * n_e
        opus_sig = {}
        if opus_idx:
            shapes = {
                i: jax.eval_shape(
                    lambda b, i=i: tpu_synth.shard_stages(b, prerolls[i]),
                    xs[i])
                for i in opus_idx
            }

            def make_branch(g):
                def fn(_):
                    parts = []
                    for i in opus_idx:
                        if owner[i] == g:
                            sig, cs = tpu_synth.shard_stages(
                                xs[i], prerolls[i])
                        else:
                            # zero lanes, marked varying over 'frames' to
                            # match the owned branch's output types
                            s_sig, s_cs = shapes[i]
                            sig = _pvary(
                                jnp.zeros(s_sig.shape, s_sig.dtype),
                                "frames")
                            cs = tuple(
                                _pvary(jnp.zeros(s.shape, s.dtype),
                                       "frames")
                                for s in s_cs)
                        parts.append((sig,) + cs)
                    return tuple(
                        jnp.concatenate([p[k] for p in parts], axis=0)
                        for k in range(5))
                return fn

            slabs = jax.lax.switch(
                ei, [make_branch(g) for g in range(n_eshards)], 0)
            slabs = jax.lax.psum(slabs, "elements")
            off = 0
            for i in opus_idx:
                L = shapes[i][0].shape[0]
                opus_sig[i] = (
                    slabs[0][off:off + L],
                    tuple(slabs[k][off:off + L] for k in range(1, 5)))
                off += L

            # ---- phase B (chain, replicated over element rows): comb +
            # de-emphasis IIRs with exact ppermute hand-off over 'frames'
            outs = _comb_chain(cfg, opus_sig, chunks, n_shards)
            for i in opus_idx:
                L = outs[i].shape[0]
                x_list[i] = outs[i].reshape(L, -1, T).transpose(1, 0, 2)

        # ---- phase C (element-sharded): AAC filterbank + demix + render
        # + element gain per owned element; psum over 'elements' IS the
        # reference's mixer sum (iamf_mixer_mix, IAMF_decoder.c:2702-2733)
        def elem_contrib(i):
            es = cfg.elements[i]
            if kinds[i] == "opus":
                x_i = x_list[i]
            elif kinds[i] == "aac":
                from ..codecs.aac import tpu_synth as aac_synth

                nl = xs[i].shape[1]  # nl, not `lanes`: don't shadow the
                #   per-element lane tuple local_substreams indexes
                x_a, _ = aac_synth.synthesize_packed(
                    xs[i], aac_synth.init_carry(nl))
                x_i = x_a[prerolls[i]:]
            else:
                x_i = xs[i][prerolls[i]:]
            mi = params["mat_idx"][i][0]
            pf = {
                "x": {i: x_i},
                "factors": {i: params["factors"][i][0]},
                "rg": {i: params["rg"][i][0]},
                "m_prev": {i: params["mats"][i][mi[:, 0]]},
                "m_cur": {i: params["mats"][i][mi[:, 1]]},
            }
            r = jax.vmap(
                lambda inp, i=i: _element_frame(cfg, i, inp))(pf)
            g = params["elem_gain"][i][0]
            return r * g[:, None, :] if es.per_sample_gain \
                else r * g[:, None, None]

        def make_render_branch(g):
            def fn(_):
                total = None
                for i in range(n_e):
                    if owner[i] != g:
                        continue
                    r = elem_contrib(i)
                    total = r if total is None else total + r
                if total is None:
                    total = _pvary(
                        jnp.zeros((Fl, cfg.out_channels, T), jnp.float32),
                        "frames")
                return total
            return fn

        contrib = jax.lax.switch(
            ei, [make_render_branch(g) for g in range(n_eshards)], 0)
        mixed = jax.lax.psum(contrib, "elements")
        og = params["out_gain"][0]
        mixed = (mixed * og[:, None, :] if cfg.per_sample_out_gain
                 else mixed * og[:, None, None])
        flat = mixed.transpose(1, 0, 2).reshape(cfg.out_channels, Fl * T)

        pcm, final = _post_mix(cfg, flat, n_shards)
        return pcm[None], jax.tree.map(lambda a: a[None], final)

    xs_spec = (P("frames", None, "substreams") if n_sshards > 1
               else P("frames"))
    in_specs = (
        tuple([xs_spec] * n_e),
        {
            "factors": [P("frames")] * n_e,
            "rg": [P("frames")] * n_e,
            "mats": [P()] * n_e,
            "mat_idx": [P("frames")] * n_e,
            "elem_gain": [P("frames")] * n_e,
            "out_gain": P("frames"),
        },
    )
    if cfg.limiter is not None:
        lim_spec = {k: P("frames") for k in (
            "current_gain", "target_start_gain", "target_end_gain",
            "current_tc", "delay_data", "peak_data", "entry_index")}
    else:
        lim_spec = P("frames")
    out_specs = (P("frames"), lim_spec)

    fn = (local_elements if n_eshards > 1
          else local_substreams if n_sshards > 1 else local)
    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs))
