"""Opus device-path coverage beyond CELT-960 (VERDICT r3 missing #1).

The reference decodes any TOC through one loop
(/root/reference/src/iamf_dec/opus/opus_multistream2_decoder.c:125-165).
The batched device path mirrors that with a static per-element split
(OpusDecoder.classify_packets): CELT at any frame size / packing and
hybrid run the device spectrum synthesis; SILK-only and mixed-mode
streams host-decode (bit-exact native path) and still flow through the
batched device pipeline. Every class must match the serial reference-
parity decoder within 1 LSB.
"""

import numpy as np

import vectors
from iamf_tpu.constants import ChannelLayout
from iamf_tpu.core.batch_decoder import BatchedStreamDecoder


def _serial(stream, ss=0):
    from test_e2e_pcm import ours_decode

    return ours_decode(stream, ss)


def _assert_close(stream, ss=0, batch_frames=3, tol=1):
    serial = _serial(stream, ss)
    dec = BatchedStreamDecoder(stream, sound_system=ss,
                               batch_frames=batch_frames)
    out = dec.decode_all()
    n = min(len(serial), len(out))
    assert n > 0 and len(serial) == len(out)
    diff = np.abs(serial[:n].astype(np.int64) - out[:n].astype(np.int64))
    assert diff.max() <= tol, f"batched differs: max {diff.max()} LSB"
    return dec


def test_silk_stream_host_pipeline():
    stream, _ = vectors.build_opus_layout_stream(
        ChannelLayout.STEREO, n_frames=9, mode="silk", amp=0.3)
    dec = _assert_close(stream)
    assert dec.stats["elements"][0]["path"] == "opus_host_pipeline"


def test_hybrid_stream_device_synthesis():
    stream, _ = vectors.build_opus_layout_stream(
        ChannelLayout.STEREO, n_frames=9, mode="hybrid", amp=0.3)
    dec = _assert_close(stream)
    st = dec.stats["elements"][0]
    assert st["path"] == "opus_device_hybrid"
    assert st["opus_cfg"] == (960, 1, True)


def test_hybrid_51_device_synthesis():
    """Multi-substream hybrid (coupled + mono lanes) through the demix/
    downmix pipeline."""
    stream, _ = vectors.build_opus_layout_stream(
        ChannelLayout.L510, n_frames=6, mode="hybrid", amp=0.3)
    dec = _assert_close(stream, ss=1)
    assert dec.stats["elements"][0]["path"] == "opus_device_hybrid"


def test_celt_10ms_device_synthesis():
    """480-sample (10 ms) CELT frames: the 480-point IMDCT variant."""
    stream, _ = vectors.build_opus_layout_stream(
        ChannelLayout.STEREO, n_frames=16, frame_size=480, mode="celt")
    dec = _assert_close(stream)
    st = dec.stats["elements"][0]
    assert st["path"] == "opus_device_celt"
    assert st["opus_cfg"] == (480, 1, False)


def _pack_code2(p1: bytes, p2: bytes) -> bytes:
    """Two equal-config opus frames -> one code-2 packet (RFC 6716 §3.2:
    TOC code 2 = two frames, first length signalled)."""
    assert p1[0] >> 2 == p2[0] >> 2, "same config required"
    toc = (p1[0] & 0xFC) | 2
    n1 = len(p1) - 1
    if n1 < 252:
        ln = bytes([n1])
    else:
        ln = bytes([252 + (n1 & 3), (n1 - 252 - (n1 & 3)) // 4])
    return bytes([toc]) + ln + p1[1:] + p2[1:]


def test_celt_multiframe_packet_device_synthesis():
    """One temporal unit = one code-2 packet of two 10 ms CELT frames
    (frame_size 960 = 2 x 480): the multi-frame packing path."""
    from iamf_tpu.tools import builder
    from iamf_tpu.constants import ElementType
    from opusenc import encode_opus_stream, opus_decoder_conf

    n_units = 8
    rate = 48000
    src = vectors.sine_pcm(n_units * 960, 2, rate, amp=0.4, bits=16, seed=5)
    pcm = src.astype(np.float32) / 32768.0
    pkts, pre_skip = encode_opus_stream(pcm, frame_size=480, mode="celt")
    units = [_pack_code2(pkts[2 * u], pkts[2 * u + 1])
             for u in range(n_units)]

    out = bytearray()
    out += builder.sequence_header_obu()
    out += builder.codec_config_obu(
        1, b"Opus", 960, 4, opus_decoder_conf(2, pre_skip, rate))
    out += builder.audio_element_obu(
        element_id=1, element_type=ElementType.CHANNEL_BASED,
        codec_config_id=1, substream_ids=[0],
        layers=[builder.LayerSpec(ChannelLayout.STEREO, 1, 1)])
    out += builder.mix_presentation_obu(
        mix_presentation_id=10,
        elements=[builder.MixElementSpec(
            element_id=1, mix_gain_param=builder.ParamDefinition(id=100))],
        layouts=[builder.LayoutSpec(sound_system=0)])
    for u, pkt in enumerate(units):
        out += builder.audio_frame_obu(
            0, pkt, trim_start=pre_skip if u == 0 else 0)
    stream = bytes(out)

    dec = _assert_close(stream)
    st = dec.stats["elements"][0]
    assert st["path"] == "opus_device_celt"
    assert st["opus_cfg"] == (480, 2, False)


def test_mixed_mode_stream_host_classification():
    """A stream that switches SILK -> CELT mid-way (transition redundancy
    territory) classifies to the host decode path and still matches the
    serial decoder through the batched pipeline."""
    silk_stream, _ = vectors.build_opus_layout_stream(
        ChannelLayout.STEREO, n_frames=10, mode="silk", amp=0.3, seed=7)
    celt_stream, _ = vectors.build_opus_layout_stream(
        ChannelLayout.STEREO, n_frames=10, mode="celt", amp=0.3, seed=7)

    # splice: descriptors + first 5 silk units + last 5 celt units
    from iamf_tpu.obu import parser as p

    def split_units(stream):
        pos = p.find_sequence_header(stream)
        desc = bytearray()
        units = []
        while pos < len(stream):
            obu = p.split_obu(stream, pos)
            if obu.type in (31, 0, 1, 2):  # seq header + descriptors
                desc += stream[pos:pos + obu.size]
            else:  # audio frames (+ any param blocks)
                units.append(stream[pos:pos + obu.size])
            pos += obu.size
        return bytes(desc), units

    desc, silk_units = split_units(silk_stream)
    _, celt_units = split_units(celt_stream)
    stream = desc + b"".join(silk_units[:5] + celt_units[5:])

    dec = _assert_close(stream)
    assert dec.stats["elements"][0]["path"] == "opus_host_pipeline"


def test_packet_loss_concealment_batched():
    """A lost packet (empty payload is not legal IAMF; loss modeled at the
    API level) conceals identically on serial and batched host paths."""
    stream, _ = vectors.build_opus_layout_stream(
        ChannelLayout.STEREO, n_frames=6, mode="silk", amp=0.3)
    # decode_batch with a None packet mid-stream
    from iamf_tpu.codecs.opus.decoder import OpusDecoder
    from opusenc import opus_decoder_conf

    dec_a = OpusDecoder(opus_decoder_conf(2), 1, 1, 960)
    dec_b = OpusDecoder(opus_decoder_conf(2), 1, 1, 960)
    pkts, _ = __import__("opusenc").encode_opus_stream(
        vectors.sine_pcm(6 * 960, 2, 48000, amp=0.3, bits=16,
                         seed=3).astype(np.float32) / 32768.0,
        frame_size=960, mode="silk")
    lossy = list(pkts)
    lossy[3] = None
    # serial per-frame decode
    serial = np.concatenate(
        [dec_a.decode([pkt]) for pkt in lossy], axis=1)
    # batched host decode (segmented native batch calls around the loss)
    batched = dec_b.decode_batch([lossy], 960)
    batched = batched.transpose(1, 0, 2).reshape(2, -1)
    np.testing.assert_array_equal(serial, batched)
