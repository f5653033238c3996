"""Test-vector synthesis: complete IAMF streams built with the framework's
own muxer (iamf_tpu.tools.builder), decodable by the reference iamfplayer.

The reference repo ships no corpus (SURVEY.md §4); these generated vectors +
reference-decoded goldens are the conformance harness.
"""

from __future__ import annotations

import hashlib
import os
import subprocess

import numpy as np

from iamf_tpu.constants import ChannelLayout, ElementType, ParameterType
from iamf_tpu.tools import builder


def sine_pcm(n: int, channels: int, rate: int = 48000, amp: float = 0.5,
             freqs=None, bits: int = 16, seed: int = 0) -> np.ndarray:
    """Deterministic multitone int PCM [n, channels]."""
    if freqs is None:
        freqs = [220.0 * (k + 1) for k in range(channels)]
    t = np.arange(n) / rate
    rng = np.random.RandomState(seed)
    out = np.zeros((n, channels))
    for c in range(channels):
        phase = rng.uniform(0, 2 * np.pi)
        out[:, c] = amp * np.sin(2 * np.pi * freqs[c] * t + phase)
        out[:, c] += 0.1 * amp * np.sin(2 * np.pi * 3.1 * freqs[c] * t)
    scale = 2.0 ** (bits - 1) - 1
    return np.round(out * scale).astype(np.int64)


def build_pcm_stereo_stream(
    n_frames: int = 24,
    frame_size: int = 960,
    sample_size: int = 16,
    rate: int = 48000,
    mix_gain_q78: int = 0,
) -> tuple[bytes, np.ndarray]:
    """Simple-profile stereo ipcm stream -> (stream bytes, source [n,2] int)."""
    total = n_frames * frame_size
    pcm = sine_pcm(total, 2, rate, bits=sample_size)

    out = bytearray()
    out += builder.sequence_header_obu()
    out += builder.codec_config_obu(
        1, b"ipcm", frame_size, 0, builder.pcm_decoder_conf(sample_size, rate)
    )
    out += builder.audio_element_obu(
        element_id=1,
        element_type=ElementType.CHANNEL_BASED,
        codec_config_id=1,
        substream_ids=[0],
        layers=[builder.LayerSpec(ChannelLayout.STEREO, 1, 1)],
    )
    out += builder.mix_presentation_obu(
        mix_presentation_id=10,
        elements=[
            builder.MixElementSpec(
                element_id=1,
                mix_gain_param=builder.ParamDefinition(id=100),
                default_mix_gain_q78=mix_gain_q78,
            )
        ],
        layouts=[builder.LayoutSpec(sound_system=0)],
    )
    for f in range(n_frames):
        frame = pcm[f * frame_size : (f + 1) * frame_size]
        out += builder.audio_frame_obu(
            0, builder.pack_pcm_frame(frame, sample_size)
        )
    return bytes(out), pcm


def _layer_substreams(layout: int) -> tuple[int, int]:
    """(nb_substreams, nb_coupled) for a single-layer channel config."""
    from iamf_tpu.constants import LAYOUT_CHANNELS_CODEC, ChannelLayout

    n = len(LAYOUT_CHANNELS_CODEC[ChannelLayout(layout)])
    if n == 1:
        return 1, 0
    if n == 2:
        return 1, 1
    coupled = (n - 2) // 2
    return coupled + 2, coupled


def build_pcm_layout_stream(
    layout: int,
    n_frames: int = 8,
    frame_size: int = 960,
    sample_size: int = 16,
    rate: int = 48000,
    amp: float = 0.5,
    demix_mode: int = 0,
    seed: int = 1,
    pcm_override: np.ndarray | None = None,
    demix_modes=None,  # per-frame demixing_mode values (param blocks)
    mix_gain_segments=None,  # per-frame element mix-gain segment dicts
    out_gain_segments=None,  # per-frame output mix-gain segment dicts
    hrm: int = 0,  # headphones_rendering_mode (1 => HRTF conv binaural)
    layout_specs=None,  # override the sub-mix LayoutSpec list
) -> tuple[bytes, np.ndarray]:
    """Single-layer channel-based ipcm stream for any IA layout.

    Gain segment dicts follow builder.parameter_block_obu's mix-gain form:
    {"animation": AnimationType, "start": q78, "end": q78, ...}.
    Returns (stream, source PCM [n, nch] in codec channel order).
    """
    from iamf_tpu.constants import LAYOUT_CHANNELS_CODEC, ChannelLayout, ParameterType

    nch = len(LAYOUT_CHANNELS_CODEC[ChannelLayout(layout)])
    nsub, ncoupled = _layer_substreams(layout)
    total = n_frames * frame_size
    if pcm_override is not None:
        pcm = np.asarray(pcm_override)[:total]
    else:
        pcm = sine_pcm(total, nch, rate, amp=amp, bits=sample_size, seed=seed)

    out = bytearray()
    out += builder.sequence_header_obu()
    out += builder.codec_config_obu(
        1, b"ipcm", frame_size, 0, builder.pcm_decoder_conf(sample_size, rate)
    )
    demix = None
    if nch > 2:
        demix = builder.ParamDefinition(
            id=998, rate=rate, mode=0, duration=frame_size,
            constant_segment_interval=frame_size,
        )
    out += builder.audio_element_obu(
        element_id=1,
        element_type=ElementType.CHANNEL_BASED,
        codec_config_id=1,
        substream_ids=list(range(nsub)),
        layers=[builder.LayerSpec(layout, nsub, ncoupled)],
        demix_param=demix,
        default_demix_mode=demix_mode,
        default_demix_w=0,
    )
    out += builder.mix_presentation_obu(
        mix_presentation_id=10,
        elements=[
            builder.MixElementSpec(
                element_id=1, mix_gain_param=builder.ParamDefinition(id=100),
                headphones_rendering_mode=hrm,
            )
        ],
        layouts=(layout_specs if layout_specs is not None
                 else [builder.LayoutSpec(sound_system=0),
                       builder.LayoutSpec(sound_system=1)]),
    )
    for f in range(n_frames):
        if demix_modes is not None and demix is not None:
            out += builder.parameter_block_obu(
                998, ParameterType.DEMIXING, duration=frame_size,
                constant_segment_interval=frame_size, mode=0,
                segments=[{"mode": demix_modes[f % len(demix_modes)]}],
            )
        if mix_gain_segments is not None:
            out += builder.parameter_block_obu(
                100, ParameterType.MIX_GAIN, duration=frame_size,
                constant_segment_interval=frame_size, mode=1,
                segments=[mix_gain_segments[f % len(mix_gain_segments)]],
            )
        if out_gain_segments is not None:
            out += builder.parameter_block_obu(
                999, ParameterType.MIX_GAIN, duration=frame_size,
                constant_segment_interval=frame_size, mode=1,
                segments=[out_gain_segments[f % len(out_gain_segments)]],
            )
        frame = pcm[f * frame_size : (f + 1) * frame_size]
        ch = 0
        for s in range(ncoupled):
            out += builder.audio_frame_obu(
                s, builder.pack_pcm_frame(frame[:, ch : ch + 2], sample_size)
            )
            ch += 2
        for s in range(ncoupled, nsub):
            out += builder.audio_frame_obu(
                s, builder.pack_pcm_frame(frame[:, ch : ch + 1], sample_size)
            )
            ch += 1
    return bytes(out), pcm


def build_pcm_51_stream(n_frames: int = 8, amp: float = 0.5, **kw):
    from iamf_tpu.constants import ChannelLayout

    return build_pcm_layout_stream(
        ChannelLayout.L510, n_frames=n_frames, amp=amp, **kw
    )


def build_pcm_mono_stream(n_frames: int = 8, **kw):
    from iamf_tpu.constants import ChannelLayout

    return build_pcm_layout_stream(ChannelLayout.MONO, n_frames=n_frames, **kw)


def build_scalable_pcm_stream(
    n_frames: int = 8,
    frame_size: int = 960,
    sample_size: int = 16,
    rate: int = 48000,
    amp: float = 0.4,
    demix_modes=None,  # per-frame demixing_mode sequence (param blocks)
    recon_gains=None,  # per-frame (g_ls, g_rs) Q0.8 recon gains, or None
    default_demix_mode: int = 1,
    default_demix_w: int = 0,
    target_layouts=(1, 0),
    seed: int = 7,
    hrm: int = 0,  # headphones_rendering_mode (1 => HRTF conv binaural)
    layer2_output_gain=None,  # (flags 6-bit, gain q7.8) on the 5.1 layer
) -> tuple[bytes, np.ndarray]:
    """Two-layer scalable channel stream: stereo layer + 5.1 layer.

    Layer 1: 1 coupled substream (L2,R2). Layer 2 adds 3 substreams
    (coupled L5/R5 + mono C + mono LFE); SL5/SR5 are demixed by the decoder
    via the S3->5 chain, exercising demix modes, the w-index walk, and
    recon-gain RMS smoothing.
    """
    from iamf_tpu.constants import ChannelLayout, ParameterType

    nch = 6  # L2 R2 L5 R5 C LFE (codec order)
    total = n_frames * frame_size
    pcm = sine_pcm(total, nch, rate, amp=amp, bits=sample_size, seed=seed)

    out = bytearray()
    out += builder.sequence_header_obu()
    out += builder.codec_config_obu(
        1, b"ipcm", frame_size, 0, builder.pcm_decoder_conf(sample_size, rate)
    )
    demix = builder.ParamDefinition(
        id=998, rate=rate, mode=0, duration=frame_size,
        constant_segment_interval=frame_size,
    )
    recon = builder.ParamDefinition(
        id=997, rate=rate, mode=0, duration=frame_size,
        constant_segment_interval=frame_size,
    )
    out += builder.audio_element_obu(
        element_id=1,
        element_type=ElementType.CHANNEL_BASED,
        codec_config_id=1,
        substream_ids=[0, 1, 2, 3],
        layers=[
            builder.LayerSpec(ChannelLayout.STEREO, 1, 1),
            builder.LayerSpec(
                ChannelLayout.L510, 3, 1, recon_gain_flag=True,
                **(dict(output_gain_flags=layer2_output_gain[0],
                        output_gain_q78=layer2_output_gain[1])
                   if layer2_output_gain else {}),
            ),
        ],
        demix_param=demix,
        recon_param=recon if recon_gains is not None else None,
        default_demix_mode=default_demix_mode,
        default_demix_w=default_demix_w,
    )
    out += builder.mix_presentation_obu(
        mix_presentation_id=10,
        elements=[
            builder.MixElementSpec(
                element_id=1, mix_gain_param=builder.ParamDefinition(id=100),
                headphones_rendering_mode=hrm,
            )
        ],
        layouts=[builder.LayoutSpec(sound_system=ss) for ss in target_layouts],
    )
    for f in range(n_frames):
        if demix_modes is not None:
            out += builder.parameter_block_obu(
                998, ParameterType.DEMIXING, duration=frame_size,
                constant_segment_interval=frame_size, mode=0,
                segments=[{"mode": demix_modes[f % len(demix_modes)]}],
            )
        if recon_gains is not None:
            g = recon_gains[f % len(recon_gains)]
            # flags: RE_LS|RE_RS (bits 3,4); layer 1 (bit 1) present
            out += builder.parameter_block_obu(
                997, ParameterType.RECON_GAIN, duration=frame_size,
                constant_segment_interval=frame_size, mode=0,
                segments=[{"entries": [None, (0b11000, list(g))]}],
            )
        frame = pcm[f * frame_size : (f + 1) * frame_size]
        out += builder.audio_frame_obu(
            0, builder.pack_pcm_frame(frame[:, 0:2], sample_size)
        )
        out += builder.audio_frame_obu(
            1, builder.pack_pcm_frame(frame[:, 2:4], sample_size)
        )
        out += builder.audio_frame_obu(
            2, builder.pack_pcm_frame(frame[:, 4:5], sample_size)
        )
        out += builder.audio_frame_obu(
            3, builder.pack_pcm_frame(frame[:, 5:6], sample_size)
        )
    return bytes(out), pcm


def build_ambisonics_pcm_stream(
    order: int = 1,
    n_frames: int = 8,
    frame_size: int = 960,
    sample_size: int = 16,
    rate: int = 48000,
    amp: float = 0.4,
    projection: bool = False,
    seed: int = 11,
    target_layouts=(1, 0),
    hrm: int = 0,  # headphones_rendering_mode (1 => HRTF conv binaural)
) -> tuple[bytes, np.ndarray]:
    """Scene-based (ambisonics) ipcm stream: FOA/SOA/TOA ACN channels as
    mono substreams (mode=MONO) or coupled+mono with a Q15 demix matrix
    (mode=PROJECTION)."""
    nch = (order + 1) ** 2
    total = n_frames * frame_size

    out = bytearray()
    out += builder.sequence_header_obu()
    out += builder.codec_config_obu(
        1, b"ipcm", frame_size, 0, builder.pcm_decoder_conf(sample_size, rate)
    )
    if not projection:
        amb = {
            "mode": 0,
            "output_channel_count": nch,
            "substream_count": nch,
            "mapping": list(range(nch)),
        }
        nsub, ncoupled = nch, 0
        stream_ch = nch
    else:
        # projection: Q15 matrix [stream channels, ambisonics channels];
        # coupled substreams carry 2 channels each
        ncoupled = nch // 2
        nsub = nch - ncoupled
        stream_ch = nsub + ncoupled
        mat = np.zeros((stream_ch, nch), dtype=np.int64)
        for i in range(min(stream_ch, nch)):
            mat[i, i] = 16384  # 0.5 in Q15
        amb = {
            "mode": 1,
            "output_channel_count": nch,
            "substream_count": nsub,
            "coupled_substream_count": ncoupled,
            "mapping": mat.astype(">i2").tobytes(),
        }
    pcm = sine_pcm(total, stream_ch, rate, amp=amp, bits=sample_size, seed=seed)
    out += builder.audio_element_obu(
        element_id=1,
        element_type=ElementType.SCENE_BASED,
        codec_config_id=1,
        substream_ids=list(range(nsub)),
        ambisonics=amb,
    )
    out += builder.mix_presentation_obu(
        mix_presentation_id=10,
        elements=[
            builder.MixElementSpec(
                element_id=1, mix_gain_param=builder.ParamDefinition(id=100),
                headphones_rendering_mode=hrm,
            )
        ],
        layouts=[builder.LayoutSpec(sound_system=ss) for ss in target_layouts],
    )
    for f in range(n_frames):
        frame = pcm[f * frame_size : (f + 1) * frame_size]
        ch = 0
        for s in range(ncoupled):
            out += builder.audio_frame_obu(
                s, builder.pack_pcm_frame(frame[:, ch : ch + 2], sample_size)
            )
            ch += 2
        for s in range(ncoupled, nsub):
            out += builder.audio_frame_obu(
                s, builder.pack_pcm_frame(frame[:, ch : ch + 1], sample_size)
            )
            ch += 1
    return bytes(out), pcm


def build_opus_layout_stream(
    layout: int = 1,  # ChannelLayout.STEREO
    n_frames: int = 10,
    frame_size: int = 960,
    rate: int = 48000,
    amp: float = 0.4,
    bitrate: int = 96000,
    seed: int = 21,
    mode: str = "celt",  # "celt" | "silk" | "hybrid"
) -> tuple[bytes, np.ndarray]:
    """Channel-based Opus stream (BASELINE config 1 class): substreams
    encoded with libopus (forced CELT by default; SILK/hybrid selectable);
    pre-skip carried as trim_start."""
    from iamf_tpu.constants import LAYOUT_CHANNELS_CODEC, ChannelLayout
    from opusenc import encode_opus_stream, opus_decoder_conf

    nch = len(LAYOUT_CHANNELS_CODEC[ChannelLayout(layout)])
    nsub, ncoupled = _layer_substreams(layout)
    total = n_frames * frame_size
    src = sine_pcm(total, nch, rate, amp=amp, bits=16, seed=seed)
    pcm = src.astype(np.float32) / 32768.0

    all_packets = []
    pre_skip = 0
    ch = 0
    for s in range(nsub):
        want = 2 if s < ncoupled else 1
        pkts, look = encode_opus_stream(
            pcm[:, ch : ch + want], frame_size=frame_size, bitrate=bitrate,
            mode=mode,
        )
        all_packets.append(pkts)
        pre_skip = look
        ch += want

    out = bytearray()
    out += builder.sequence_header_obu()
    out += builder.codec_config_obu(
        1, b"Opus", frame_size, 4, opus_decoder_conf(2, pre_skip, rate)
    )
    demix = None
    if nch > 2:
        demix = builder.ParamDefinition(
            id=998, rate=rate, mode=0, duration=frame_size,
            constant_segment_interval=frame_size,
        )
    out += builder.audio_element_obu(
        element_id=1,
        element_type=ElementType.CHANNEL_BASED,
        codec_config_id=1,
        substream_ids=list(range(nsub)),
        layers=[builder.LayerSpec(layout, nsub, ncoupled)],
        demix_param=demix,
        default_demix_mode=0,
    )
    out += builder.mix_presentation_obu(
        mix_presentation_id=10,
        elements=[
            builder.MixElementSpec(
                element_id=1, mix_gain_param=builder.ParamDefinition(id=100)
            )
        ],
        layouts=[builder.LayoutSpec(sound_system=0),
                 builder.LayoutSpec(sound_system=1)],
    )
    for f in range(n_frames):
        trim = pre_skip if f == 0 else 0
        for s in range(nsub):
            out += builder.audio_frame_obu(
                s, all_packets[s][f], trim_start=trim
            )
    return bytes(out), src


def build_flac_layout_stream(
    layout: int,
    n_frames: int = 8,
    frame_size: int = 1024,
    bits: int = 16,
    rate: int = 48000,
    amp: float = 0.5,
    demix_mode: int = 0,
    seed: int = 2,
) -> tuple[bytes, np.ndarray]:
    """Single-layer channel-based FLAC stream (config 2 class).

    Substreams encoded with the prebuilt libFLAC encoder (tests/flacenc.py).
    """
    from iamf_tpu.constants import LAYOUT_CHANNELS_CODEC, ChannelLayout
    from flacenc import encode_flac_stream

    nch = len(LAYOUT_CHANNELS_CODEC[ChannelLayout(layout)])
    nsub, ncoupled = _layer_substreams(layout)
    total = n_frames * frame_size
    pcm = sine_pcm(total, nch, rate, amp=amp, bits=bits, seed=seed)

    metas = []
    frame_lists = []
    ch = 0
    for s in range(nsub):
        want = 2 if s < ncoupled else 1
        meta, frames = encode_flac_stream(
            pcm[:, ch : ch + want], bits=bits, rate=rate, block_size=frame_size
        )
        metas.append(meta)
        frame_lists.append(frames)
        ch += want
    assert all(len(f) == n_frames for f in frame_lists)

    out = bytearray()
    out += builder.sequence_header_obu()
    # decoder_conf: metadata blocks of substream 0 (channel count per stream
    # is patched by the decoder; reference uses stream 0's STREAMINFO)
    out += builder.codec_config_obu(1, b"fLaC", frame_size, 0, metas[0])
    demix = None
    if nch > 2:
        demix = builder.ParamDefinition(
            id=998, rate=rate, mode=0, duration=frame_size,
            constant_segment_interval=frame_size,
        )
    out += builder.audio_element_obu(
        element_id=1,
        element_type=ElementType.CHANNEL_BASED,
        codec_config_id=1,
        substream_ids=list(range(nsub)),
        layers=[builder.LayerSpec(layout, nsub, ncoupled)],
        demix_param=demix,
        default_demix_mode=demix_mode,
    )
    out += builder.mix_presentation_obu(
        mix_presentation_id=10,
        elements=[
            builder.MixElementSpec(
                element_id=1, mix_gain_param=builder.ParamDefinition(id=100)
            )
        ],
        layouts=[builder.LayoutSpec(sound_system=0),
                 builder.LayoutSpec(sound_system=1)],
    )
    for f in range(n_frames):
        for s in range(nsub):
            out += builder.audio_frame_obu(s, frame_lists[s][f])
    return bytes(out), pcm


def split_into_units(stream: bytes) -> tuple[bytes, list[bytes]]:
    """Split a bitstream into (descriptor OBUs, [temporal unit bytes]).

    A temporal unit = parameter blocks + one audio frame per substream; the
    unit closes when the substream count for the element is reached.
    """
    from iamf_tpu.obu import parser as p

    off = p.find_sequence_header(stream)
    descriptors = bytearray()
    units: list[bytes] = []
    nb_substreams = 0
    cur = bytearray()
    frames_in_unit = 0
    pos = off
    while pos < len(stream):
        obu = p.split_obu(stream, pos)
        if obu is None:
            break
        raw = stream[pos : pos + obu.size]
        if obu.is_descriptor:
            descriptors += raw
            if obu.type == 1:  # audio element: count substreams
                el = p.parse_audio_element(obu)
                nb_substreams = el.nb_substreams
        else:
            cur += raw
            if obu.is_audio_frame:
                frames_in_unit += 1
                if frames_in_unit >= nb_substreams:
                    units.append(bytes(cur))
                    cur = bytearray()
                    frames_in_unit = 0
        pos += obu.size
    if cur:
        units.append(bytes(cur))
    return bytes(descriptors), units


def loop_units(stream: bytes, n_units: int) -> bytes:
    """A stream of ``n_units`` temporal units: the first unit as it is
    (it carries the codec pre-skip trim), then units 1.. cycled, so that
    only the stream's head is trimmed."""
    descriptors, units = split_into_units(stream)
    body = units[1:] or units
    picked = [units[0]] + [body[i % len(body)] for i in range(n_units - 1)]
    return descriptors + b"".join(picked[:n_units])


def build_mp4(stream: bytes, frame_size: int = 960, media_time: int = 0,
              roll_distance: int = None) -> bytes:
    from iamf_tpu.tools.mp4builder import mux_iamf_mp4

    descriptors, units = split_into_units(stream)
    return mux_iamf_mp4(
        descriptors, units, frame_size=frame_size, media_time=media_time,
        roll_distance=roll_distance,
    )


def build_fmp4(stream: bytes, frame_size: int = 960, fragments: int = 2,
               base_data_offset: bool = False) -> bytes:
    from iamf_tpu.tools.mp4builder import mux_iamf_fmp4

    descriptors, units = split_into_units(stream)
    return mux_iamf_fmp4(
        descriptors, units, frame_size=frame_size, fragments=fragments,
        base_data_offset=base_data_offset,
    )


def decode_with_reference(
    player: str, stream: bytes, workdir: str, sound_system: str = "0",
    extra_args: tuple = (), name: str = "vec",
) -> str:
    """Run the reference iamfplayer on a stream; returns output wav path."""
    path = os.path.join(workdir, f"{name}.iamf")
    with open(path, "wb") as f:
        f.write(stream)
    cmd = [player, "-o2", f"-s{sound_system}", *extra_args, f"{name}.iamf"]
    res = subprocess.run(
        cmd, cwd=workdir, capture_output=True, text=True, timeout=300
    )
    if sound_system == "b":
        wav = os.path.join(workdir, f"binaural_{name}.wav")
    else:
        wav = os.path.join(workdir, f"ss{sound_system}_{name}.wav")
    if not os.path.exists(wav):
        raise RuntimeError(
            f"reference player produced no wav: {res.stdout}\n{res.stderr}"
        )
    return wav


def build_two_element_stream(
    n_frames: int = 8,
    frame_size: int = 960,
    sample_size: int = 16,
    rate: int = 48000,
    gain1_q78: int = 0,
    gain2_q78: int = 0,
    target_layouts=(0, 1),
    hrm: int = 0,  # headphones_rendering_mode for BOTH elements
) -> tuple[bytes, np.ndarray, np.ndarray]:
    """Base-profile mix: stereo channel element + FOA ambisonics element in
    one sub mix (the reference mixer path, IAMF_decoder.c:2702-2733)."""
    total = n_frames * frame_size
    pcm1 = sine_pcm(total, 2, rate, amp=0.3, bits=sample_size, seed=2)
    pcm2 = sine_pcm(total, 4, rate, amp=0.25, bits=sample_size, seed=9)

    out = bytearray()
    out += builder.sequence_header_obu(primary_profile=1, additional_profile=1)
    out += builder.codec_config_obu(
        1, b"ipcm", frame_size, 0, builder.pcm_decoder_conf(sample_size, rate)
    )
    out += builder.audio_element_obu(
        element_id=1,
        element_type=ElementType.CHANNEL_BASED,
        codec_config_id=1,
        substream_ids=[0],
        layers=[builder.LayerSpec(ChannelLayout.STEREO, 1, 1)],
    )
    out += builder.audio_element_obu(
        element_id=2,
        element_type=ElementType.SCENE_BASED,
        codec_config_id=1,
        substream_ids=[1, 2, 3, 4],
        ambisonics={
            "mode": 0,
            "output_channel_count": 4,
            "substream_count": 4,
            "mapping": [0, 1, 2, 3],
        },
    )
    out += builder.mix_presentation_obu(
        mix_presentation_id=10,
        elements=[
            builder.MixElementSpec(
                element_id=1,
                mix_gain_param=builder.ParamDefinition(id=100),
                default_mix_gain_q78=gain1_q78,
                headphones_rendering_mode=hrm,
            ),
            builder.MixElementSpec(
                element_id=2,
                mix_gain_param=builder.ParamDefinition(id=101),
                default_mix_gain_q78=gain2_q78,
                headphones_rendering_mode=hrm,
            ),
        ],
        layouts=[builder.LayoutSpec(sound_system=ss) for ss in target_layouts],
    )
    for f in range(n_frames):
        fr1 = pcm1[f * frame_size : (f + 1) * frame_size]
        fr2 = pcm2[f * frame_size : (f + 1) * frame_size]
        out += builder.audio_frame_obu(
            0, builder.pack_pcm_frame(fr1, sample_size)
        )
        for s in range(4):
            out += builder.audio_frame_obu(
                1 + s, builder.pack_pcm_frame(fr2[:, s : s + 1], sample_size)
            )
    return bytes(out), pcm1, pcm2


def aac_decoder_config(asc: bytes, avg_bitrate: int = 128000) -> bytes:
    """IAMF AAC decoder_config: FIXED-layout DecoderConfigDescriptor (no
    expandable lengths; IAMF_aac_decoder.c:83-96, IAMF_decoder.c:715-732):
    0x04, OTI 0x40, streamType, bufferSizeDB u24, maxBitrate u32,
    avgBitrate u32, 0x05, raw ASC."""
    return (
        bytes([0x04,
               0x40,          # objectTypeIndication: MPEG-4 audio
               0x15,          # streamType=audio(5)<<2 | reserved 1
               0, 0, 0])      # bufferSizeDB u24
        + (avg_bitrate * 2).to_bytes(4, "big")
        + avg_bitrate.to_bytes(4, "big")
        + bytes([0x05]) + asc
    )


def build_aac_layout_stream(
    layout: int = 1,
    n_frames: int = 10,
    frame_size: int = 1024,
    rate: int = 48000,
    amp: float = 0.4,
    bitrate: int = 128000,
    seed: int = 33,
    transients: bool = False,
) -> tuple[bytes, np.ndarray, list]:
    """Channel-based AAC-LC stream; substreams encoded with the reference's
    fdk-aac binary run through the COFF loader. Returns (stream, source,
    per-substream AU lists). transients=True adds clicks so the encoder
    emits EIGHT_SHORT window sequences."""
    from iamf_tpu.constants import LAYOUT_CHANNELS_CODEC, ChannelLayout
    from iamf_tpu.codecs.aac.fdk import FdkEncoder

    nch = len(LAYOUT_CHANNELS_CODEC[ChannelLayout(layout)])
    nsub, ncoupled = _layer_substreams(layout)
    total = n_frames * frame_size
    src = sine_pcm(total, nch, rate, amp=amp, bits=16, seed=seed)
    if transients:
        src = src.astype(np.int64)
        for k in range(3000, total - 200, 9000):
            src[k:k + 150] += (14000 * np.hanning(150))[:, None].astype(
                np.int64)
        src = np.clip(src, -32768, 32767).astype(np.int16)

    all_packets = []
    asc = None
    ch = 0
    for s in range(nsub):
        want = 2 if s < ncoupled else 1
        enc = FdkEncoder(want, rate, bitrate * want // 2,
                         frame_length=frame_size)
        pkts = enc.encode(src[:, ch : ch + want].astype(np.int16))
        all_packets.append(pkts)
        asc = enc.asc if want == 2 else (asc or enc.asc)
        ch += want
    n_frames = min(len(p) for p in all_packets)

    out = bytearray()
    out += builder.sequence_header_obu()
    out += builder.codec_config_obu(
        1, b"mp4a", frame_size, -1, aac_decoder_config(asc, bitrate)
    )
    demix = None
    if nch > 2:
        demix = builder.ParamDefinition(
            id=998, rate=rate, mode=0, duration=frame_size,
            constant_segment_interval=frame_size,
        )
    out += builder.audio_element_obu(
        element_id=1,
        element_type=ElementType.CHANNEL_BASED,
        codec_config_id=1,
        substream_ids=list(range(nsub)),
        layers=[builder.LayerSpec(layout, nsub, ncoupled)],
        demix_param=demix,
        default_demix_mode=0,
        default_demix_w=0,
    )
    out += builder.mix_presentation_obu(
        mix_presentation_id=10,
        elements=[
            builder.MixElementSpec(
                element_id=1, mix_gain_param=builder.ParamDefinition(id=100)
            )
        ],
        layouts=[builder.LayoutSpec(sound_system=0),
                 builder.LayoutSpec(sound_system=1)],
    )
    for f in range(n_frames):
        for s in range(nsub):
            out += builder.audio_frame_obu(s, all_packets[s][f])
    return bytes(out), src, all_packets
