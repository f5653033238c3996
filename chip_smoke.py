#!/usr/bin/env python3
"""Smoke test of the IAMF decode path on one GPU.

    python chip_smoke.py               # phases 0-9 on one card
    python chip_smoke.py --devices 4   # only the multi-device decoders

Drives the system's main path once, through the entry points a user calls
(``BatchedStreamDecoder``, ``MultiStreamServer``, the player CLI), at
deployment size: 30 s of 48 kHz 7.1.4 audio rendered to sound system J
(12 channels). Content is built from seeds in-process (LPCM) or looped
from the committed libopus sample (Opus). Every device result is checked
against an oracle that runs on the same process's CPU backend (the serial
``api.IAMFDecoder``, the host resampler, the filterbank reference), so the
comparison is independent of the card's numerics.

Each phase prints one ``PHASE {json}`` line: its first-call seconds
(compile included), its steady-state seconds, per-batch device-step
seconds where they apply, and its comparison against its tolerance. A
failed comparison raises, and the script exits non-zero. The last line of
standard output is ``{"ok": true, "device": {...}}``. Without a GPU, or
outside an iamf-tpu checkout, the script exits non-zero before any phase.

The phase functions take their sizes as arguments; tests/test_chip_smoke.py
runs each one at a tiny size on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
RATE = 48000
FRAME = 960
SS_J = 9  # sound system J (4+7+0): the 12-channel 7.1.4 output
OPUS_SAMPLE = os.path.join(REPO, "iamf_tpu", "data", "sample_opus_714.iamf")


def emit(name: str, **fields) -> dict:
    """Print one phase's result line and return it."""
    rec = {"phase": name, **fields}
    print("PHASE " + json.dumps(rec, default=float), flush=True)
    return rec


def frames_for(seconds: float) -> int:
    return max(1, int(round(seconds * RATE / FRAME)))


def max_lsb(a, b) -> int:
    """Largest sample difference of two int PCM arrays of equal shape."""
    import numpy as np

    assert a.shape == b.shape, (a.shape, b.shape)
    if a.size == 0:
        return 0
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


def check(name: str, diff, tol) -> None:
    if not diff <= tol:
        raise AssertionError(f"{name}: difference {diff} exceeds {tol}")


def cpu():
    """The CPU device that runs every oracle."""
    import jax

    return jax.devices("cpu")[0]


def twice(fn):
    """Run fn twice: (second result, first-call s, steady s). The first
    call compiles every program it needs; the second runs them warm."""
    t0 = time.perf_counter()
    fn()
    t1 = time.perf_counter()
    out = fn()
    t2 = time.perf_counter()
    return out, t1 - t0, t2 - t1


def median_seconds(fn, reps: int) -> float:
    """Median wall time of fn() (which blocks on its result) over reps
    warm calls, after one untimed call."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def step_seconds(dec, reps: int = 5) -> float:
    """Median device time of one fused decode step of ``dec`` (its first
    batch's inputs, the initial carry)."""
    import jax
    import jax.numpy as jnp

    from iamf_tpu.core.batch_decoder import _HostPlan, _fused_decode

    plan = _HostPlan(dec)
    bufs = [jnp.asarray(b) for b in plan.next_bufs()]
    plan.close()
    return median_seconds(lambda: jax.block_until_ready(_fused_decode(
        dec.cfg, plan.kinds, plan.carry, plan.stream_params, bufs)), reps)


def serial_decode(stream: bytes, sound_system: int = SS_J,
                  binaural: bool = False):
    """The serial api.IAMFDecoder, driven like the player's bitstream
    loop, on the CPU backend."""
    import jax

    from iamf_tpu.tools.player import decode_bitstream
    from iamf_tpu.api import IAMFDecoder

    with jax.default_device(cpu()), tempfile.TemporaryDirectory(
            dir=REPO, prefix=".smoke-") as d:
        path = os.path.join(d, "s.iamf")
        with open(path, "wb") as f:
            f.write(stream)
        dec = IAMFDecoder()
        if binaural:
            dec.set_binaural()
        else:
            dec.set_sound_system(sound_system)
        pcm, _, _ = decode_bitstream(dec, path)
    return pcm


def pcm_714(seconds: float, seed: int = 1, amp: float = 0.5, hrm: int = 0):
    """Seeded 48 kHz 7.1.4 LPCM stream."""
    import vectors
    from iamf_tpu.constants import ChannelLayout

    return vectors.build_pcm_layout_stream(
        ChannelLayout.L714, n_frames=frames_for(seconds), amp=amp,
        seed=seed, hrm=hrm)[0]


def opus_714(seconds: float) -> bytes:
    """The committed libopus 7.1.4 sample, its temporal units looped to
    ``seconds``."""
    import vectors

    with open(OPUS_SAMPLE, "rb") as f:
        return vectors.loop_units(f.read(), frames_for(seconds))


def batched(stream: bytes, batch_frames: int, **kw):
    from iamf_tpu.core.batch_decoder import BatchedStreamDecoder

    return BatchedStreamDecoder(stream, batch_frames=batch_frames, **kw)


# --------------------------------------------------------------------------
# phases


def phase_device() -> dict:
    """Phase 0: the accelerator, as JAX and nvidia-smi report it. Fails
    unless JAX's first device is a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke.py: needs a GPU; JAX's first device "
                         f"is {dev.platform} ({dev.device_kind})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        print(f"nvidia-smi: {line.strip()}", flush=True)
    return emit("device", platform=dev.platform, kind=dev.device_kind,
                count=len(jax.devices()), jax=jax.__version__,
                nvidia_smi=smi.stdout.strip().splitlines())


def phase_lpcm(seconds: float = 30.0, batch_frames: int = 128) -> dict:
    """Phase 1: 7.1.4 LPCM -> sound system J, bit-exact vs serial."""
    stream = pcm_714(seconds)
    make = lambda: batched(stream, batch_frames, sound_system=SS_J)
    out, first, steady = twice(lambda: make().decode_all(fetch=True))
    ref = serial_decode(stream)
    diff = max_lsb(out, ref)
    check("lpcm", diff, 0)
    return emit("lpcm", audio_s=seconds, first_s=first, steady_s=steady,
                step_s=step_seconds(make()), max_lsb=diff, tol_lsb=0)


def phase_opus(seconds: float = 30.0, batch_frames: int = 128,
               reps: int = 20) -> dict:
    """Phase 2: looped libopus 7.1.4, device CELT synthesis, <= 1 LSB vs
    the serial path's host synthesis. Also times the synthesis filterbank
    (IMDCT + TDAC) alone against the whole synthesis step on one real
    batch."""
    import jax
    import jax.numpy as jnp

    from iamf_tpu.codecs.opus import tpu_synth
    from iamf_tpu.core.batch_decoder import (_BATCH_COMB_CHUNK, _HostPlan)

    stream = opus_714(seconds)
    make = lambda: batched(stream, batch_frames, sound_system=SS_J)
    out, first, steady = twice(lambda: make().decode_all(fetch=True))
    ref = serial_decode(stream)
    diff = max_lsb(out, ref)
    check("opus", diff, 1)

    dec = make()
    plan = _HostPlan(dec)
    buf = jnp.asarray(plan.next_bufs()[0])
    syn0 = plan.carry["syn"][0]
    plan.close()
    p, _ = tpu_synth._unpack(buf, FRAME)
    fb = jax.jit(tpu_synth._imdct_overlap)
    fb_s = median_seconds(lambda: jax.block_until_ready(
        fb(p.freq, p.transient, syn0.tail)), reps)
    syn_s = median_seconds(lambda: jax.block_until_ready(
        tpu_synth.synthesize_packed(buf, syn0, chunk=_BATCH_COMB_CHUNK)),
        reps)
    return emit("opus", audio_s=seconds, first_s=first, steady_s=steady,
                step_s=step_seconds(dec), synth_step_s=syn_s,
                filterbank_s=fb_s, filterbank_share=fb_s / syn_s,
                batch_shape=list(buf.shape), max_lsb=diff, tol_lsb=1)


def phase_limiter(seconds: float = 10.0, batch_frames: int = 128) -> dict:
    """Phase 3: content above -1 dBFS, so the limiter's per-sample slow
    path runs; <= 1 LSB vs serial."""
    import numpy as np

    stream = pcm_714(seconds, seed=5, amp=0.9)
    make = lambda: batched(stream, batch_frames, sound_system=SS_J)
    out, first, steady = twice(lambda: make().decode_all(fetch=True))
    ref = serial_decode(stream)
    diff = max_lsb(out, ref)
    check("limiter", diff, 1)
    dec = make()
    thr = dec.cfg.limiter.linear_threshold * 32768
    # the burst exceeds the threshold at the input and not at the output
    peak_out = int(np.abs(out.astype(np.int64)).max())
    if not peak_out <= thr + 1:
        raise AssertionError(f"limiter: output peak {peak_out} > {thr:.0f}")
    return emit("limiter", audio_s=seconds, first_s=first, steady_s=steady,
                step_s=step_seconds(dec), out_peak=peak_out,
                threshold=thr, max_lsb=diff, tol_lsb=1)


# cuFFT and the CPU's FFT sum in different orders; before quantisation the
# two agree to float32 rounding, which can move a sample across a rounding
# boundary: one LSB, two where the ear feeds of two segments overlap-add.
BINAURAL_TOL = {0: 1, 1: 2}


def phase_binaural(seconds: float = 10.0, batch_frames: int = 128) -> dict:
    """Phase 4: binaural output, HRTF FFT convolution (hrm=1) and the
    matrix path (hrm=0), each vs serial."""
    res = {}
    for hrm in (1, 0):
        stream = pcm_714(seconds, seed=7, hrm=hrm)
        make = lambda: batched(stream, batch_frames, binaural=True)
        out, first, steady = twice(lambda: make().decode_all(fetch=True))
        ref = serial_decode(stream, binaural=True)
        diff = max_lsb(out, ref)
        check(f"binaural hrm={hrm}", diff, BINAURAL_TOL[hrm])
        res[f"hrm{hrm}"] = dict(first_s=first, steady_s=steady,
                                step_s=step_seconds(make()), max_lsb=diff,
                                tol_lsb=BINAURAL_TOL[hrm])
    return emit("binaural", audio_s=seconds, **res)


# The batched and serial paths are bit-exact on the CPU, but on the card the
# scalable stream's demix / recon-gain arithmetic differs by one LSB after
# quantisation (the GPU code generator may fuse a multiply and an add into
# one rounding): the repo's batched-vs-serial bar of 1 LSB.
MP4_SEEK_TOL = 1


def phase_mp4_seek(seconds: float = 10.0, start_sec: float = 1.0,
                   batch_frames: int = 128) -> dict:
    """Phase 5: scalable two-layer LPCM in MP4, decoded from a seek
    point, vs the serial player loop with the same seek."""
    import jax

    import vectors
    from iamf_tpu.api import IAMFDecoder
    from iamf_tpu.core.batch_decoder import BatchedStreamDecoder
    from iamf_tpu.tools.player import decode_mp4

    n = frames_for(seconds)
    stream, _ = vectors.build_scalable_pcm_stream(
        n_frames=n, demix_modes=[f % 3 for f in range(n)])
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".smoke-") as d:
        path = os.path.join(d, "s.mp4")
        with open(path, "wb") as f:
            f.write(vectors.build_mp4(stream))
        out, first, steady = twice(lambda: BatchedStreamDecoder.from_mp4(
            path, start_sec=start_sec, sound_system=1,
            batch_frames=batch_frames).decode_all(fetch=True))
        with jax.default_device(cpu()):
            dec = IAMFDecoder()
            dec.set_sound_system(1)
            ref, _, _ = decode_mp4(dec, path, start_sec=start_sec)
    diff = max_lsb(out, ref)
    check("mp4 seek", diff, MP4_SEEK_TOL)
    return emit("mp4_seek", audio_s=seconds, start_sec=start_sec,
                samples=int(out.shape[0]), first_s=first, steady_s=steady,
                max_lsb=diff, tol_lsb=MP4_SEEK_TOL)


def phase_serving(seconds: float = 30.0, n_pcm: int = 4,
                  batch_frames: int = 128) -> dict:
    """Phase 6: MultiStreamServer over n_pcm LPCM streams plus the looped
    Opus stream (two buckets); each stream bit-exact vs its own decode."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from iamf_tpu.core.batch_decoder import _HostPlan
    from iamf_tpu.core.serving import (MultiStreamServer, _fused_decode_multi,
                                       _stack)

    streams = [pcm_714(seconds, seed=11 + i) for i in range(n_pcm)]
    streams.append(opus_714(seconds))
    make = lambda: MultiStreamServer(streams, sound_system=SS_J,
                                     batch_frames=batch_frames)
    srv = make()
    assert srv.n_buckets == 2, srv.n_buckets
    outs, first, steady = twice(lambda: [
        np.concatenate([np.asarray(b) for b in o])
        for o in make().decode_all()])
    diffs = []
    for s, got in zip(streams, outs):
        own = batched(s, batch_frames, sound_system=SS_J).decode_all(
            fetch=False)
        diffs.append(max_lsb(got, np.concatenate(
            [np.asarray(b) for b in own])))
    check("serving", max(diffs), 0)

    # per-batch device time of each bucket's vmapped step
    buckets = {}
    for (cfg, kinds), idxs in srv._groups.items():
        decs = [srv.decs[i] for i in idxs]
        rows = (max(-(-d.n_frames // batch_frames) for d in decs) + 1) \
            * batch_frames
        plans = [_HostPlan(d, rows=rows) for d in decs]
        carry = jax.tree.map(_stack, *[p.carry for p in plans])
        params = jax.tree.map(_stack, *[p.stream_params for p in plans])
        per = [p.next_bufs() for p in plans]
        bufs = [jnp.stack([jnp.asarray(b[i]) for b in per])
                for i in range(len(per[0]))]
        for p in plans:
            p.close()
        buckets["+".join(kinds) + f"x{len(decs)}"] = median_seconds(
            lambda: jax.block_until_ready(_fused_decode_multi(
                cfg, kinds, carry, params, bufs)), 5)
    return emit("serving", audio_s=seconds, streams=len(streams),
                buckets=srv.n_buckets, first_s=first, steady_s=steady,
                bucket_step_s=buckets, max_lsb=max(diffs), tol_lsb=0)


def phase_aac_filterbank(frames: int = 128, lanes: int = 12,
                         seed: int = 3) -> dict:
    """Phase 7: the AAC-LC synthesis filterbank on seeded spectra that
    cover every window sequence and shape, vs reference_filterbank on the
    CPU. Tolerance 1 LSB at s16: cuBLAS and the CPU sum the IMDCT
    products in different orders, which moves a sample across a rounding
    boundary at most once."""
    import jax
    import numpy as np

    from iamf_tpu.codecs.aac import tpu_synth as aac

    rng = np.random.RandomState(seed)
    spec = (rng.randn(frames, lanes, aac.FRAME) * 40000).astype(np.float32)
    win_seq = np.arange(frames) % 4       # every sequence, in turn
    shape = rng.randint(0, 2, frames)     # sine or KBD
    shape[:2] = (0, 1)
    prev_shape = np.concatenate([[0], shape[:-1]])
    d = {k: np.repeat(v[:, None], lanes, axis=1).astype(np.int32)
         for k, v in (("win_seq", win_seq), ("shape", shape),
                      ("prev_shape", prev_shape))}
    buf = np.concatenate([spec, aac.pack_params(d).astype(np.float32)], -1)
    carry0 = aac.init_carry(lanes)
    run = lambda: jax.block_until_ready(aac.synthesize_packed(buf, carry0))
    (out, _), first, steady = twice(run)
    got = np.rint(np.asarray(out) * 32768.0).astype(np.int64)

    with jax.default_device(cpu()):
        carry = np.zeros((lanes, aac.FRAME), np.float32)
        want = np.empty((frames, lanes, aac.FRAME), np.int64)
        for b in range(frames):
            y, carry = aac.reference_filterbank(
                spec[b], int(win_seq[b]), int(shape[b]),
                int(prev_shape[b]), carry)
            want[b] = np.rint(np.clip(y, -32768.0, 32767.0))
    diff = max_lsb(got, want)
    check("aac filterbank", diff, 1)
    return emit("aac_filterbank", shape=[frames, lanes, aac.FRAME],
                first_s=first, steady_s=steady, max_lsb=diff, tol_lsb=1)


RESAMPLE_TOL = 1e-5  # float32 accumulation order of the FIR dot products


def phase_resampler(seconds: float = 10.0, channels: int = 12,
                    in_rate: int = 44100, seed: int = 4) -> dict:
    """Phase 8: DeviceResampler 44.1 -> 48 kHz vs the host Resampler."""
    import jax
    import numpy as np

    from iamf_tpu.dsp.resample import DeviceResampler, Resampler

    n = int(seconds * in_rate)
    rng = np.random.RandomState(seed)
    t = np.arange(n) / in_rate
    x = np.stack([0.4 * np.sin(2 * np.pi * (110.0 * (c + 1)) * t)
                  for c in range(channels)]).astype(np.float32)
    x += (0.02 * rng.randn(channels, n)).astype(np.float32)
    dev = DeviceResampler(channels, in_rate, RATE)
    got, first, steady = twice(lambda: np.asarray(dev.resample_stream(x)))
    host = Resampler(channels, in_rate, RATE)
    parts = [host.process(x[:, i:i + FRAME]) for i in range(0, n, FRAME)]
    parts.append(host.drain())
    want = np.concatenate(parts, axis=1)
    assert got.shape == want.shape, (got.shape, want.shape)
    diff = float(np.abs(got - want).max())
    check("resampler", diff, RESAMPLE_TOL)
    return emit("resampler", audio_s=seconds, channels=channels,
                rates=[in_rate, RATE], first_s=first, steady_s=steady,
                max_abs=diff, tol_abs=RESAMPLE_TOL)


def phase_player(seconds: float = 2.0, batch_frames: int = 128) -> dict:
    """Phase 9: ``python -m iamf_tpu.tools.player -o2 -s9``, run in this
    process; its wav equals the batched decode within 1 LSB."""
    from iamf_tpu.tools import player
    from iamf_tpu.utils.wav import read_wav

    stream = pcm_714(seconds, seed=9)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".smoke-") as d:
        with open(os.path.join(d, "p.iamf"), "wb") as f:
            f.write(stream)
        os.chdir(d)
        try:
            t0 = time.perf_counter()
            rc = player.main(["-o2", f"-s{SS_J}", "p.iamf"])
            wall = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        assert rc == 0, rc
        wav, rate, bits = read_wav(os.path.join(d, f"ss{SS_J}_p.wav"))
    assert (rate, bits) == (RATE, 16), (rate, bits)
    want = batched(stream, batch_frames, sound_system=SS_J).decode_all()
    diff = max_lsb(wav, want)
    check("player", diff, 1)
    return emit("player", audio_s=seconds, wall_s=wall, max_lsb=diff,
                tol_lsb=1)


def phase_multi_device(n_devices: int = 4, seconds: float = 30.0,
                       batch_frames: int = 128) -> dict:
    """--devices N: the looped Opus stream through ShardedStreamDecoder on
    the meshes frames=N, (frames, elements)=(N/2, 2) and (frames,
    substreams)=(N/2, 2), and through PipelinedStreamDecoder on 2 devices;
    each vs the one-device BatchedStreamDecoder (<= 1 LSB; the pipelined
    split runs the same programs and must be bit-exact)."""
    import jax

    from iamf_tpu.parallel.pp_decoder import PipelinedStreamDecoder
    from iamf_tpu.parallel.sharded_decoder import ShardedStreamDecoder

    devs = jax.devices()[:n_devices]
    if len(set(devs)) != n_devices:
        raise SystemExit(f"--devices {n_devices}: JAX has "
                         f"{len(jax.devices())} devices")
    stream = opus_714(seconds)
    with jax.default_device(devs[0]):
        want = batched(stream, batch_frames,
                       sound_system=SS_J).decode_all()
    res = {}
    for name, kw in (("frames", {}), ("frames_elements",
                                      {"element_axis": 2}),
                     ("frames_substreams", {"substream_axis": 2})):
        make = lambda: ShardedStreamDecoder(
            stream, n_devices=n_devices, sound_system=SS_J, **kw)
        dec = make()
        mesh_devs = set(dec.mesh.devices.flat)
        assert len(mesh_devs) == n_devices, mesh_devs
        got, first, steady = twice(lambda: make().decode_all())
        diff = max_lsb(got, want)
        check(f"sharded {name}", diff, 1)
        res[name] = dict(mesh=dict(dec.mesh.shape), first_s=first,
                         steady_s=steady, max_lsb=diff, tol_lsb=1)
    pp = lambda: PipelinedStreamDecoder(
        stream, devices=devs[:2], sound_system=SS_J,
        batch_frames=batch_frames)
    assert pp().dev_a != pp().dev_b
    got, first, steady = twice(lambda: pp().decode_all())
    diff = max_lsb(got, want)
    check("pipelined", diff, 0)
    res["pipelined"] = dict(devices=2, first_s=first, steady_s=steady,
                            max_lsb=diff, tol_lsb=0)
    return emit("multi_device", devices=sorted(str(d) for d in devs),
                audio_s=seconds, **res)


SINGLE_CARD = (phase_lpcm, phase_opus, phase_limiter, phase_binaural,
               phase_mp4_seek, phase_serving, phase_aac_filterbank,
               phase_resampler, phase_player)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="run only the multi-device decoders on this many "
                         "cards (default 1: every single-card phase)")
    args = ap.parse_args(argv)
    if not os.path.isfile(os.path.join(REPO, "iamf_tpu", "__init__.py")):
        raise SystemExit("chip_smoke.py: run it from the root of an "
                         "iamf-tpu checkout (no iamf_tpu package beside it)")
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

    import jax

    from iamf_tpu.utils.compile_cache import enable_compile_cache

    dev = phase_device()
    print(f"compile cache: {enable_compile_cache()}", flush=True)
    t0 = time.perf_counter()
    if args.devices > 1:
        phase_multi_device(args.devices)
    else:
        for phase in SINGLE_CARD:
            phase()
    print(f"total phase seconds: {time.perf_counter() - t0:.1f}",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
