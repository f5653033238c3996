"""Benchmark: realtime-x decoding 48 kHz 7.1.4 IAMF to sound system J.

Synthesizes 7.1.4 IAMF streams (PCM and Opus content), decodes them
end-to-end (host OBU parse + codec unpack/entropy + the batched device
pipeline: codec synthesis -> demix -> render matmul -> gains -> mix ->
limiter -> quantize), and reports realtime factors for both, plus the
aggregate N-stream serving throughput and the reference iamfplayer's rate
on the same streams.

A global deadline (BENCH_DEADLINE seconds, default 540) gates every stage;
stages degrade (fewer repeats) or are skipped rather than overrunning, and
the one JSON line always prints, even on exception.

device_only/aggregate realtime-x leave the PCM on the device (the serving
regime); e2e realtime-x (`value`) includes fetching it to the host.

Prints ONE JSON line.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

T0 = time.time()
DEADLINE = float(os.environ.get("BENCH_DEADLINE", "540"))


def remaining() -> float:
    return DEADLINE - (time.time() - T0)


def log(msg: str) -> None:
    print(f"[bench +{time.time() - T0:6.1f}s] {msg}", file=sys.stderr,
          flush=True)


def build_stream(seconds: float, content: str):
    from iamf_tpu.constants import ChannelLayout
    import vectors

    frame_size = 1024 if content == "aac" else 960
    n_frames = int(seconds * 48000 / frame_size)
    if content == "opus":
        # BASELINE config-1 class content on the 7.1.4 headline layout:
        # libopus-encoded substreams, decoded with the host entropy layers
        # + device CELT synthesis (codecs/opus/tpu_synth.py)
        return vectors.build_opus_layout_stream(
            ChannelLayout.L714, n_frames=n_frames, frame_size=frame_size,
            amp=0.4)[0]
    if content == "aac":
        return vectors.build_aac_layout_stream(
            ChannelLayout.L714, n_frames=n_frames, frame_size=frame_size)[0]
    if content == "flac":
        # BASELINE config 2: FLAC lossless 5.1 -> sound system B, bit-exact
        return vectors.build_flac_layout_stream(
            ChannelLayout.L510, n_frames=n_frames)[0]
    if content == "scalable_mp4":
        # BASELINE config 4: multi-layer scalable channel audio demixed
        # from mp4 input with seek (-i1 -ts)
        stream, _ = vectors.build_scalable_pcm_stream(
            n_frames=n_frames,
            demix_modes=[f % 3 for f in range(n_frames)])
        return vectors.build_mp4(stream)
    if content == "binaural":
        # BASELINE config 5: binaural output; headphones_rendering_mode=1
        # engages the batched HRTF overlap-save convolution path
        return vectors.build_pcm_layout_stream(
            ChannelLayout.L714, n_frames=n_frames, frame_size=frame_size,
            amp=0.5, hrm=1)[0]
    return vectors.build_pcm_layout_stream(
        ChannelLayout.L714, n_frames=n_frames, frame_size=frame_size,
        amp=0.5)[0]


def time_decodes(stream: bytes, sound_system: int, repeats: int,
                 fetch: bool, min_tail: float, **dec_kw):
    """Best-of-N full decodes (fresh decoder each time: host OBU routing +
    codec unpack included, stream synthesis excluded). Degrades the repeat
    count against the deadline; returns (best_seconds, audio_seconds) —
    audio_seconds is the TRUE stream duration (n_frames * frame_size), not
    the zero-padded device batch rows. dec_kw passes decoder options
    (binaural=True, mp4_path=..., start_sec=...) for the config stages."""
    from iamf_tpu.core.batch_decoder import BatchedStreamDecoder

    mp4_path = dec_kw.pop("mp4_path", None)
    start_sec = dec_kw.pop("start_sec", 0.0)
    times = []
    audio_s = 0.0
    for _ in range(repeats):
        if mp4_path is not None:
            d = BatchedStreamDecoder.from_mp4(
                mp4_path, start_sec=start_sec, sound_system=sound_system,
                batch_frames=128, **dec_kw)
        else:
            d = BatchedStreamDecoder(stream, sound_system=sound_system,
                                     batch_frames=128, **dec_kw)
        audio_s = d.n_frames * d.frame_size / 48000.0
        t0 = time.perf_counter()
        d.decode_all(fetch=fetch)
        times.append(time.perf_counter() - t0)
        if remaining() < min_tail:
            break
    return min(times), audio_s


def aggregate_decode(stream: bytes, sound_system: int, n_streams: int,
                     result=None, name: str = "pcm"):
    """N independent streams decoded concurrently on one chip, PCM left
    on device — the production serving regime. Primary path: the vmapped
    multi-stream program (serving.MultiStreamServer — one dispatch per
    frame batch for the whole fleet instead of N, bit-exact per stream
    vs its own decode, test_serving.py); falls back to N thread-driven
    decoders if the fleet can't share one program."""
    try:
        from iamf_tpu.core.serving import MultiStreamServer

        srv = MultiStreamServer([stream] * n_streams,
                                sound_system=sound_system, batch_frames=128)
        if any(e.opus or e.aac for e in srv.decs[0].elems):
            # entropy-bound fleets (opus/aac host range decode) gain
            # nothing from the one-dispatch program — the lockstep batch
            # just waits on the slowest stream's entropy; independent
            # thread-driven decoders pipeline better
            raise ValueError("entropy-bound content: threaded aggregate")
        srv.decode_all()  # warm: compile (cache-backed) + ramp
        t0 = time.perf_counter()
        srv.decode_all()
        return time.perf_counter() - t0
    except Exception as e:  # noqa: BLE001 — serving regime is optional
        log(f"vmapped aggregate unavailable ({e}); threaded fallback")
        if result is not None:
            result[f"{name}_aggregate_path"] = "threaded"
    import concurrent.futures as cf
    from iamf_tpu.core.batch_decoder import BatchedStreamDecoder

    # N concurrent decoders each carrying a cores-sized substream pool
    # oversubscribe the host N-fold: one entropy thread per decoder
    prev_threads = os.environ.get("IAMF_OPUS_THREADS")
    os.environ["IAMF_OPUS_THREADS"] = "1"
    try:
        best = None
        for rep in range(2):  # best-of-2, same convention as time_decodes
            decs = [BatchedStreamDecoder(stream, sound_system=sound_system,
                                         batch_frames=128)
                    for _ in range(n_streams)]
            t0 = time.perf_counter()
            with cf.ThreadPoolExecutor(n_streams) as ex:
                outs = list(ex.map(lambda dd: dd.decode_all(fetch=False),
                                   decs))
            for o in outs:
                o[-1].block_until_ready()
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
            if remaining() < 60:
                break
        return best
    finally:
        if prev_threads is None:
            os.environ.pop("IAMF_OPUS_THREADS", None)
        else:
            os.environ["IAMF_OPUS_THREADS"] = prev_threads


def run_codec_stage(result, name, stream, sound_system, n_streams):
    """Device-resident + aggregate numbers for one codec content type;
    returns the content's true audio seconds."""
    log(f"{name}: compile (cache-backed) + warm-up decode")
    time_decodes(stream, sound_system, 1, False, 30)
    log(f"{name}: timed decodes (device-resident)")
    dev_s, a_s = time_decodes(
        stream, sound_system, 3 if remaining() > 120 else 1, False, 60)
    result[f"{name}_device_only_realtime_x"] = round(a_s / dev_s, 2)
    if n_streams > 1 and remaining() > 90:
        agg_s = aggregate_decode(stream, sound_system, n_streams, result,
                                 name=name)
        result[f"{name}_aggregate_device_realtime_x"] = round(
            n_streams * a_s / agg_s, 2)
    log(f"{name}: device-only "
        f"{result.get(f'{name}_device_only_realtime_x')}x, aggregate "
        f"{result.get(f'{name}_aggregate_device_realtime_x')}x")
    return a_s


def aac_oracle_rate(stream: bytes, audio_seconds: float):
    """Time the fdk COFF oracle decoding the same AAC substream AUs.

    The environment's reference tree ships AAC only as a Windows COFF lib
    (no Linux .a), so reference iamfplayer builds here have NO AAC path and
    no same-window reference rate exists (BASELINE.md). The fdk oracle —
    the codec the reference would link — is the apples-to-apples
    comparison; it is timed on bare substream decode with parse/render
    excluded (a handicap in the oracle's favor)."""
    from iamf_tpu.obu import parser as _p

    prev = os.environ.get("IAMF_AAC_BACKEND")
    os.environ["IAMF_AAC_BACKEND"] = "fdk"
    try:
        from iamf_tpu.codecs.aac.decoder import AACDecoder

        body = stream[_p.find_sequence_header(stream):]
        recs = _p.split_records(body)
        frames: dict[int, list] = {}
        cc = el = None
        for i in range(len(recs)):
            if recs[i, 7] >= 0:
                frames.setdefault(int(recs[i, 7]), []).append(
                    body[recs[i, 3]:recs[i, 3] + recs[i, 4]])
            elif recs[i, 0] == 0:
                cc = _p.parse_codec_config(_p.split_obu(body, int(recs[i, 2])))
            elif recs[i, 0] == 1:
                el = _p.parse_audio_element(_p.split_obu(body, int(recs[i, 2])))
        nsub = len(el.substream_ids)
        coupled = (el.channels_config.layers[0].nb_coupled_substreams
                   if el.channels_config else 0)
        units = min(len(frames[s]) for s in el.substream_ids)
        dec = AACDecoder(cc.decoder_conf, nsub, coupled, 1024)
        packets = [[frames[s][u] for s in el.substream_ids]
                   for u in range(units)]
        t0 = time.perf_counter()
        for pkt in packets:
            dec.decode(pkt)
        return audio_seconds / (time.perf_counter() - t0)
    except Exception as e:  # noqa: BLE001 — oracle timing is best-effort
        log(f"aac oracle timing failed: {e}")
        return None
    finally:
        if prev is None:
            os.environ.pop("IAMF_AAC_BACKEND", None)
        else:
            os.environ["IAMF_AAC_BACKEND"] = prev


def reference_rate(stream: bytes, sound_system, audio_seconds: float,
                   mp4: bool = False, extra: tuple = ()):
    """Time the reference iamfplayer on the same stream (context: its
    implied design point is faster-than-realtime single-core decode)."""
    ref_bin = "/tmp/refplayer_std/iamfplayer"
    if not os.path.exists(ref_bin):
        return None
    import tempfile

    d = tempfile.mkdtemp()
    name = "bench.mp4" if mp4 else "bench.iamf"
    with open(os.path.join(d, name), "wb") as f:
        f.write(stream)
    # -o2 (wav output) is required: the reference player skips decoding
    # entirely for any other output mode (iamfplayer.c:908-918)
    cmd = [ref_bin] + (["-i1"] if mp4 else []) + [
        "-o2", f"-s{sound_system}", *extra, name]
    t0 = time.perf_counter()
    subprocess.run(cmd, cwd=d, capture_output=True, timeout=300)
    return audio_seconds / (time.perf_counter() - t0)


def run_config_stage(result, name, stream, sound_system, *, ref_kw=None,
                     **dec_kw):
    """BASELINE config coverage: device-resident realtime-x for one config
    class + the reference player's rate on the same content (when the
    reference supports it). One warm-up (compile, cache-backed) + up to 2
    timed decodes; every step deadline-gated."""
    log(f"{name}: compile (cache-backed) + warm-up decode")
    time_decodes(stream, sound_system, 1, False, 25, **dec_kw)
    reps = 2 if remaining() > 90 else 1
    dev_s, a_s = time_decodes(stream, sound_system, reps, False, 40,
                              **dec_kw)
    result[f"{name}_device_only_realtime_x"] = round(a_s / dev_s, 2)
    msg = f"{name}: device-only {result[f'{name}_device_only_realtime_x']}x"
    if ref_kw is not None and remaining() > 30:
        ref = reference_rate(stream, audio_seconds=a_s, **ref_kw)
        if ref:
            result[f"reference_player_{name}_realtime_x"] = round(ref, 2)
            result[f"{name}_speedup_vs_reference"] = round(
                result[f"{name}_device_only_realtime_x"] / ref, 2)
            msg += (f" (reference {ref:.1f}x -> "
                    f"{result[f'{name}_speedup_vs_reference']}x)")
    log(msg)


def main() -> None:
    seconds = float(os.environ.get("BENCH_SECONDS", "30"))
    n_streams = int(os.environ.get("BENCH_STREAMS", "4"))
    content = os.environ.get("BENCH_CONTENT", "")
    if "--seconds" in sys.argv:
        seconds = float(sys.argv[sys.argv.index("--seconds") + 1])
    if "--streams" in sys.argv:
        n_streams = int(sys.argv[sys.argv.index("--streams") + 1])
    if "--content" in sys.argv:
        content = sys.argv[sys.argv.index("--content") + 1]
    sound_system = 9  # J (4+7+0)

    result = {
        "metric": "realtime_x_decode_714_to_ssJ",
        "value": None,
        "unit": "x_realtime",
        "vs_baseline": None,
        "audio_seconds": seconds,
    }

    from iamf_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    log("building streams (host)")
    pcm_stream = build_stream(seconds, "pcm")
    opus_stream = None
    try:
        opus_stream = build_stream(seconds, "opus")
    except Exception as e:
        log(f"opus stream build failed: {e}")

    audio_s = seconds

    # ---- device-resident decode throughput (the serving regime) ----
    log("pcm: compile (cache-backed) + warm-up decode")
    time_decodes(pcm_stream, sound_system, 1, False, 30)
    log("pcm: timed decodes (device-resident)")
    reps = 4 if remaining() > 150 else 2
    dev_s, audio_s = time_decodes(pcm_stream, sound_system, reps, False, 60)
    result["audio_seconds"] = round(audio_s, 2)
    result["device_only_realtime_x"] = round(audio_s / dev_s, 2)
    log(f"pcm: device-only {result['device_only_realtime_x']}x")

    if n_streams > 1 and remaining() > 60:
        log(f"pcm: aggregate {n_streams}-stream decode")
        agg_s = aggregate_decode(pcm_stream, sound_system, n_streams,
                                 result)
        result["aggregate_streams"] = n_streams
        result["aggregate_device_realtime_x"] = round(
            n_streams * audio_s / agg_s, 2)
        log(f"pcm: aggregate {result['aggregate_device_realtime_x']}x")

    if n_streams > 1 and remaining() > 90:
        # heterogeneous fleet: mixed stream LENGTHS served in ONE vmapped
        # program (shorter members pad with neutral rows; test_serving.py
        # pins bit-exactness) — the production shape real fleets have
        try:
            from iamf_tpu.core.serving import MultiStreamServer

            het_secs = [seconds, seconds / 2, seconds / 2, seconds / 4]
            het = [pcm_stream] + [build_stream(s, "pcm") for s in
                                  het_secs[1:]]
            srv = MultiStreamServer(het, sound_system=sound_system,
                                    batch_frames=128)
            srv.decode_all()  # warm (compile cache-backed)
            t0 = time.perf_counter()
            outs = srv.decode_all()
            for o in outs:
                o[-1].block_until_ready()
            het_s = time.perf_counter() - t0
            result["hetero_aggregate_streams"] = len(het)
            result["hetero_aggregate_buckets"] = srv.n_buckets
            result["hetero_aggregate_device_realtime_x"] = round(
                sum(het_secs) / het_s, 2)
            log(f"pcm: heterogeneous {len(het)}-stream fleet "
                f"({srv.n_buckets} bucket) "
                f"{result['hetero_aggregate_device_realtime_x']}x")
        except Exception as e:
            log(f"hetero aggregate failed: {e}")
            result["hetero_aggregate_error"] = str(e)[:200]

    opus_audio_s = audio_s
    if opus_stream is not None and remaining() > 120:
        try:
            opus_audio_s = run_codec_stage(
                result, "opus", opus_stream, sound_system, n_streams)
        except Exception as e:
            log(f"opus stage failed: {e}")
            result["opus_error"] = str(e)[:200]
    if remaining() > 150:
        # BASELINE config 3 class: AAC-LC -> sound system J with the peak
        # limiter engaged (default) — device filterbank + host entropy
        try:
            aac_seconds = seconds if content == "aac" else min(seconds, 10)
            aac_stream = build_stream(aac_seconds, "aac")
            run_codec_stage(result, "aac", aac_stream, sound_system,
                            n_streams)
            if remaining() > 60:
                orc = aac_oracle_rate(aac_stream, aac_seconds)
                if orc:
                    result["aac_oracle_realtime_x"] = round(orc, 2)
                    if result.get("aac_device_only_realtime_x"):
                        result["aac_speedup_vs_oracle"] = round(
                            result["aac_device_only_realtime_x"] / orc, 2)
                    log(f"aac oracle {orc:.1f}x -> "
                        f"{result.get('aac_speedup_vs_oracle')}x")
        except Exception as e:
            log(f"aac stage failed: {e}")
            result["aac_error"] = str(e)[:200]

    # ---- remaining BASELINE config classes (2, 4, 5): device-resident
    # realtime-x + reference ratio each, short content, deadline-gated ----
    cfg_seconds = min(seconds, 10)
    if remaining() > 120:
        try:  # config 2: FLAC lossless 5.1 -> sound system B. Full-length
            # content: the native batch decode is ~3 ms/audio-second, so
            # longer streams amortize the per-batch dispatch RTTs that
            # dominate a 10 s run
            flac_stream = build_stream(seconds, "flac")
            run_config_stage(result, "flac", flac_stream, 1,
                             ref_kw={"sound_system": 1})
        except Exception as e:
            log(f"flac stage failed: {e}")
            result["flac_error"] = str(e)[:200]
    if remaining() > 100:
        try:  # config 4: scalable multi-layer from mp4 with -ts seek
            mp4_bytes = build_stream(cfg_seconds, "scalable_mp4")
            import tempfile

            mp4_path = os.path.join(tempfile.mkdtemp(), "bench.mp4")
            with open(mp4_path, "wb") as f:
                f.write(mp4_bytes)
            run_config_stage(
                result, "scalable_mp4_seek", mp4_bytes, 7,
                mp4_path=mp4_path, start_sec=1.0,
                ref_kw={"sound_system": 7, "mp4": True,
                        "extra": ("-ts", "1")})
        except Exception as e:
            log(f"scalable mp4 stage failed: {e}")
            result["scalable_mp4_error"] = str(e)[:200]
    if remaining() > 80:
        try:  # config 5: binaural (batched segmented HRTF conv path).
            # The reference build has the binauralizer compiled out
            # (DISABLE_BINAURALIZER=1) and renders -sb via the M2M matrix;
            # its rate is reported for the same content class.
            bin_stream = build_stream(cfg_seconds, "binaural")
            run_config_stage(result, "binaural", bin_stream, 0,
                             binaural=True,
                             ref_kw={"sound_system": "b"})
        except Exception as e:
            log(f"binaural stage failed: {e}")
            result["binaural_error"] = str(e)[:200]
    if remaining() > 60:
        try:
            # apples-to-apples with the reference's SHIPPED -sb: content
            # with headphones_rendering_mode=0 renders binaural through
            # the M2M IAMF_BINAURAL gain matrix on both sides (no HRTF
            # conv) — the fair like-for-like ratio next to the
            # conv-vs-matrix one above
            import vectors
            from iamf_tpu.constants import ChannelLayout

            mtx_stream = vectors.build_pcm_layout_stream(
                ChannelLayout.L714,
                n_frames=int(cfg_seconds * 48000 / 960), frame_size=960,
                amp=0.5, hrm=0)[0]
            run_config_stage(result, "binaural_matrix", mtx_stream, 0,
                             binaural=True,
                             ref_kw={"sound_system": "b"})
        except Exception as e:
            log(f"binaural matrix stage failed: {e}")
            result["binaural_matrix_error"] = str(e)[:200]

    profile_dir = os.environ.get("BENCH_PROFILE", "")
    if "--profile" in sys.argv:
        profile_dir = sys.argv[sys.argv.index("--profile") + 1]
    if profile_dir and remaining() > 60:
        # SURVEY §5 tracing: capture a jax.profiler trace of one
        # device-resident decode (viewable in TensorBoard / Perfetto)
        try:
            import jax

            log(f"profiler: tracing one pcm decode -> {profile_dir}")
            with jax.profiler.trace(profile_dir):
                time_decodes(pcm_stream, sound_system, 1, False, 45)
            result["profile_dir"] = profile_dir
        except Exception as e:
            log(f"profiler capture failed: {e}")
            result["profile_error"] = str(e)[:200]

    # ---- e2e: PCM fetched to the host ----
    if remaining() > 60:
        try:
            e2e_s, _ = time_decodes(
                pcm_stream, sound_system, 3 if remaining() > 90 else 1,
                True, 40)
            result["value"] = round(audio_s / e2e_s, 2)
            result["vs_baseline"] = result["value"]
            result["wall_seconds"] = round(e2e_s, 3)
            result["frames_per_s"] = round(
                (audio_s * 48000 / 960) / e2e_s, 1)
            log(f"pcm: e2e {result['value']}x")
            if opus_stream is not None and remaining() > 45:
                e2e_s, opus_audio_s = time_decodes(
                    opus_stream, sound_system, 1, True, 30)
                result["opus_realtime_x"] = round(opus_audio_s / e2e_s, 2)
                log(f"opus: e2e {result['opus_realtime_x']}x")
        except Exception as e:
            log(f"e2e stage failed: {e}")
            result["e2e_error"] = str(e)[:200]

    if result["value"] is None:  # e2e skipped/failed: report device rate
        result["value"] = result.get("device_only_realtime_x")
        result["vs_baseline"] = result["value"]
        result["value_is_device_only"] = True

    # ---- Reference player on the same streams ----
    if remaining() > 30:
        ref = reference_rate(pcm_stream, sound_system, audio_s)
        if ref:
            result["reference_player_realtime_x"] = round(ref, 2)
            result["speedup_vs_reference"] = round(result["value"] / ref, 2)
            if "device_only_realtime_x" in result:
                result["device_speedup_vs_reference"] = round(
                    result["device_only_realtime_x"] / ref, 2)
            if "aggregate_device_realtime_x" in result:
                result["aggregate_speedup_vs_reference"] = round(
                    result["aggregate_device_realtime_x"] / ref, 2)
    if remaining() > 30 and opus_stream is not None:
        ref_o = reference_rate(opus_stream, sound_system, opus_audio_s)
        if ref_o:
            result["reference_player_opus_realtime_x"] = round(ref_o, 2)
            if "opus_aggregate_device_realtime_x" in result:
                result["opus_aggregate_speedup_vs_reference"] = round(
                    result["opus_aggregate_device_realtime_x"] / ref_o, 2)

    result["bench_wall_seconds"] = round(time.time() - T0, 1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # noqa: BLE001 — the JSON line must ALWAYS print
        import traceback

        traceback.print_exc()
        print(json.dumps({
            "metric": "realtime_x_decode_714_to_ssJ",
            "value": None,
            "unit": "x_realtime",
            "vs_baseline": None,
            "error": f"{type(e).__name__}: {e}"[:300],
            "bench_wall_seconds": round(time.time() - T0, 1),
        }))
