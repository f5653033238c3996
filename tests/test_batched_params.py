"""Dynamic parameter blocks through the batched device path.

The reference evaluates mix-gain curves (IAMF_decoder.c:639-664, :857-982),
demix-mode updates + w-index walk (demixer.c:592-619) and recon-gain
segments per PTS inside its hot loop. The batched decoder replays those
scalar state machines host-side (core/timeline.py) into dense per-frame
tensors; these tests pin the batched output against both the frame-serial
api decoder and the reference player on parameter-block content.
"""

import numpy as np
import pytest

import vectors
from iamf_tpu.constants import AnimationType, ChannelLayout
from iamf_tpu.core.batch_decoder import BatchedStreamDecoder
from test_e2e_pcm import ours_decode, ref_decode


def _check(stream, ss, tmp_path=None, max_lsb=1, batch_frames=4):
    serial = ours_decode(stream, ss)
    out = BatchedStreamDecoder(
        stream, sound_system=ss, batch_frames=batch_frames).decode_all()
    n = min(len(serial), len(out))
    assert n > 0 and len(out) == len(serial), (len(out), len(serial))
    diff = np.abs(serial[:n].astype(np.int64) - out[:n].astype(np.int64))
    assert diff.max() <= max_lsb, f"vs serial: max {diff.max()}"
    if tmp_path is not None:
        ref = ref_decode(stream, tmp_path, sound_system=str(ss))
        m = min(len(ref), len(out))
        d2 = np.abs(ref[:m].astype(np.int64) - out[:m].astype(np.int64))
        assert d2.max() <= max_lsb, f"vs reference: max {d2.max()}"
    return out


def test_batched_scalable_demix_mode_walk(tmp_path):
    """Per-frame demixing parameter blocks drive the demix chains' mode and
    w-index walk inside the batched pipeline (S3->5 reconstruction)."""
    stream, _ = vectors.build_scalable_pcm_stream(
        n_frames=10, demix_modes=[1, 1, 2, 4, 4, 5, 6, 0, 2, 1]
    )
    _check(stream, 1, tmp_path)


def test_batched_scalable_recon_gain(tmp_path):
    """Recon-gain blocks engage the RMS EMA + hanning window smoothing,
    rebuilt on device from the replayed (last_sfavg, sfavg) scalar pairs."""
    stream, _ = vectors.build_scalable_pcm_stream(
        n_frames=10,
        demix_modes=[1, 2, 4, 1, 5, 1, 6, 1, 0, 2],
        recon_gains=[(230, 240), (200, 210), (255, 255), (180, 190)],
    )
    _check(stream, 1, tmp_path)


def test_batched_scalable_default_recon(tmp_path):
    """Multi-layer stream with NO recon blocks: the default recon gains
    (all 1.0) still run the hanning-window smoothing in the reference
    (dmx_rms always runs for flagged channels) — the batched path must
    apply it too."""
    stream, _ = vectors.build_scalable_pcm_stream(n_frames=8)
    _check(stream, 1, tmp_path)


def test_batched_downmix_mode_walk(tmp_path):
    """Demix-mode blocks on a single-layer 7.1.4 stream rendered to ss A:
    the DMRenderer downmix matrix walks (mode, w) per frame — the batched
    path gathers per-frame matrices from the replayed index table."""
    stream, _ = vectors.build_pcm_layout_stream(
        ChannelLayout.L714, n_frames=12, amp=0.4,
        demix_modes=[0, 0, 1, 2, 2, 4, 5, 6, 1, 0, 3, 1],
    )
    _check(stream, 0, tmp_path)


def test_batched_element_mix_gain_step(tmp_path):
    segs = [
        {"animation": AnimationType.STEP, "start": -(6 << 8)},
        {"animation": AnimationType.STEP, "start": -(3 << 8)},
        {"animation": AnimationType.STEP, "start": 0},
        {"animation": AnimationType.STEP, "start": -(1 << 8)},
    ]
    stream, _ = vectors.build_pcm_layout_stream(
        ChannelLayout.STEREO, n_frames=8, amp=0.5, mix_gain_segments=segs)
    _check(stream, 0, tmp_path)


def test_batched_element_mix_gain_linear(tmp_path):
    """Linear gain ramps animate within the frame -> the batched path must
    widen the gain track to per-sample vectors."""
    segs = [
        {"animation": AnimationType.LINEAR, "start": -(12 << 8), "end": 0},
        {"animation": AnimationType.LINEAR, "start": 0, "end": -(12 << 8)},
    ]
    stream, _ = vectors.build_pcm_layout_stream(
        ChannelLayout.STEREO, n_frames=8, amp=0.5, mix_gain_segments=segs)
    dec = BatchedStreamDecoder(stream, sound_system=0, batch_frames=4)
    assert dec.cfg.elements[0].per_sample_gain
    _check(stream, 0, tmp_path)


def test_batched_element_mix_gain_bezier(tmp_path):
    segs = [
        {"animation": AnimationType.BEZIER, "start": -(9 << 8), "end": 0,
         "control": -(2 << 8), "control_time": 96},
        {"animation": AnimationType.BEZIER, "start": 0, "end": -(9 << 8),
         "control": -(7 << 8), "control_time": 160},
    ]
    stream, _ = vectors.build_pcm_layout_stream(
        ChannelLayout.STEREO, n_frames=8, amp=0.5, mix_gain_segments=segs)
    _check(stream, 0, tmp_path)


def test_batched_output_mix_gain(tmp_path):
    """Output mix-gain parameter blocks (sub-mix gain, param id from the
    mix presentation) through the batched path."""
    segs = [
        {"animation": AnimationType.STEP, "start": -(4 << 8)},
        {"animation": AnimationType.LINEAR, "start": -(4 << 8),
         "end": -(1 << 8)},
    ]
    stream, _ = vectors.build_pcm_layout_stream(
        ChannelLayout.STEREO, n_frames=8, amp=0.5, out_gain_segments=segs)
    dec = BatchedStreamDecoder(stream, sound_system=0, batch_frames=4)
    assert dec.cfg.per_sample_out_gain
    _check(stream, 0, tmp_path)


def test_batched_combined_params(tmp_path):
    """Everything at once on 5.1: demix walk + element gain animation +
    output gain steps, across an uneven final batch."""
    stream, _ = vectors.build_pcm_layout_stream(
        ChannelLayout.L510, n_frames=11, amp=0.4,
        demix_modes=[1, 2, 0, 4, 5, 6, 1, 0, 2, 1, 3],
        mix_gain_segments=[
            {"animation": AnimationType.LINEAR, "start": -(6 << 8),
             "end": -(2 << 8)},
            {"animation": AnimationType.STEP, "start": -(2 << 8)},
        ],
        out_gain_segments=[
            {"animation": AnimationType.STEP, "start": -(1 << 8)},
        ],
    )
    _check(stream, 0, tmp_path, batch_frames=3)


def test_batched_mp4_scalable_with_params(tmp_path):
    """The VERDICT's done-bar: a test_mp4-class scalable stream with
    parameter blocks decodes through BatchedStreamDecoder and matches the
    frame-serial path and the reference player."""
    stream, _ = vectors.build_scalable_pcm_stream(
        n_frames=12,
        demix_modes=[1, 2, 4, 5, 6, 0] * 2,
        recon_gains=[(240, 250), (210, 220)],
    )
    _check(stream, 1, tmp_path, batch_frames=5)
