"""Device PVQ leaf reconstruction (device_leaf.py) vs the host decoder.

Stage 2 of the on-device post-range CELT reconstruction: cwrsi pulses ->
alg_unquant normalization -> exp_rotation, validated against the host's
post-rotation vectors tapped from a real encoded stream (IAMF_LEAF_TAP=2).
Matrix-form rotation reorders float ops vs the sequential two-pass
rotation, so the bar is ~1e-5 relative (the opus path's SNR class), not
bit-exact like the integer pulse stage."""

import ctypes

import numpy as np
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

from iamf_tpu import native  # noqa: E402


def _capture_corpus():
    lib0 = native.load()
    lib0.iamf_leaf_tap_set(2)
    try:
        import vectors
        from iamf_tpu.constants import ChannelLayout
        from iamf_tpu.core.batch_decoder import (BatchedStreamDecoder,
                                                 _HostPlan)

        try:
            stream = vectors.build_opus_layout_stream(
                ChannelLayout.L510, n_frames=30, frame_size=960, amp=0.5)[0]
        except Exception as e:
            pytest.skip(f"opus encoder unavailable: {e}")
        lib = native.load()
        lib.iamf_leaf_tap_read2.restype = ctypes.c_longlong
        CAP = 1 << 20
        n = np.zeros(CAP, np.int32)
        k = np.zeros(CAP, np.int32)
        idx = np.zeros(CAP, np.uint32)
        gain = np.zeros(CAP, np.float32)
        spread = np.zeros(CAP, np.int32)
        blocks = np.zeros(CAP, np.int32)
        x = np.zeros((1 << 18, 32), np.float32)
        ip = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
        fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        up = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
        args = (ip(n), ip(k), up(idx), fp(gain), ip(spread), ip(blocks),
                fp(x))
        lib.iamf_leaf_tap_read2(*args, ctypes.c_longlong(CAP), 1)
        d = BatchedStreamDecoder(stream, sound_system=1, batch_frames=8)
        plan = _HostPlan(d)
        while plan.next_bufs() is not None:
            pass
        plan.close()
        cnt = int(lib.iamf_leaf_tap_read2(*args, ctypes.c_longlong(CAP), 0))
        assert cnt > 1000
        m = min(cnt, 1 << 18)
        return (n[:m], k[:m], idx[:m], gain[:m], spread[:m], blocks[:m],
                x[:m])
    finally:
        lib0.iamf_leaf_tap_set(0)


def test_device_leaf_reconstruction_matches_host():
    from iamf_tpu.codecs.opus import device_leaf as dl

    n, k, idx, gain, spread, blocks, xo = _capture_corpus()
    X = dl.reconstruct(n, k, idx, gain, spread, blocks)
    W = 32
    w = np.minimum(n, W)
    mask = np.arange(W)[None, :] < w[:, None]
    a = np.where(mask, xo[:, :W], 0)
    b = np.where(mask, X[:, :W], 0)
    d = np.abs(a - b)
    scale = np.maximum(np.abs(a).max(axis=1, keepdims=True), 1e-3)
    rel = (d / scale).max()
    rot = dl.needs_rotation(n, k, spread)
    assert rot.any() and (~rot).any()  # both paths exercised
    assert rel < 1e-5, rel


def test_rotation_matrix_matches_sequential():
    """Matrix form vs the native sequential rotation on random vectors."""
    from iamf_tpu.codecs.opus import device_leaf as dl

    rng = np.random.default_rng(5)
    lib = dl._native()
    for (n, k, spread, blocks) in ((44, 4, 1, 1), (18, 5, 2, 1),
                                   (8, 2, 3, 2), (96, 10, 1, 1)):
        m = dl.rotation_matrix(n, k, spread, blocks)
        v = rng.normal(0, 1, n).astype(np.float32)
        want = v.copy()
        lib.iamf_exp_rotation(
            want.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, -1, blocks, k, spread)
        got = m @ v
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def test_lcg_jump_ahead_bit_exact():
    """Stage-3 mechanism: the noise-fill LCG threaded across leaves via
    prefix jump-ahead (seed_after_j = A^j seed + B_j mod 2^32) must match
    the host's sequential celt_lcg_rand walk exactly — the draw counts
    are device data (collapse-mask dependent), so this is the sequential
    dependency stage 3 removes."""
    import jax.numpy as jnp
    from iamf_tpu.codecs.opus import device_leaf as dl

    def host_lcg(seed, n):
        out, s = [], int(seed)
        for _ in range(n):
            s = (1664525 * s + 1013904223) & 0xFFFFFFFF
            out.append(s)
        return np.array(out, np.uint32), np.uint32(s)

    rng = np.random.default_rng(9)
    draws = rng.choice([0, 0, 0, 4, 8, 16, 22, 176], size=40).astype(
        np.int32)
    frame_seed = np.uint32(0xDEADBEEF)
    seed, host_entry, host_vals = frame_seed, [], []
    for d in draws:
        host_entry.append(seed)
        v, seed = host_lcg(seed, int(d))
        host_vals.append(v)
    entry = np.asarray(dl.lcg_leaf_entry_seeds(
        jnp.uint32(frame_seed), jnp.asarray(draws)))
    np.testing.assert_array_equal(entry, np.array(host_entry, np.uint32))
    vals = np.asarray(dl.lcg_noise_fill(jnp.asarray(entry),
                                        jnp.asarray(draws), 176))
    for i, d in enumerate(draws):
        np.testing.assert_array_equal(vals[i, :d], host_vals[i])
