"""Device CWRS pulse decode vs the native host implementation.

cwrsi (PVQ index -> pulse vector) was the largest part of the Opus host
entropy decode on the round-5 content; codecs/opus/device_cwrsi.py
evaluates it as a batched gather-free device program. Must be BIT-EXACT vs
the host walk for every valid (n, k, index)."""

import numpy as np
import pytest

import jax.numpy as jnp

from iamf_tpu import native
from iamf_tpu.codecs.opus import device_cwrsi as dc


def _rand_leaves(rng, count):
    """Random valid leaves over the real operating range: n from the
    48 kHz band-size census, k <= 128, index uniform in [0, V(n,k))."""
    t = dc.u_table().astype(np.uint64)

    def V(n, k):
        a, b = max(n, k), min(n, k)
        a1, b1 = max(n, k + 1), min(n, k + 1)
        return int(t[a, b]) + int(t[a1, b1])

    ns = rng.choice([2, 3, 4, 6, 8, 12, 16, 18, 22, 24, 32, 44, 48, 64,
                     88, 96], size=count)
    ks = rng.integers(1, 129, size=count)
    idx = np.empty(count, np.uint32)
    for j in range(count):
        v = min(V(int(ns[j]), int(ks[j])), 1 << 32)
        idx[j] = rng.integers(0, max(v, 1))
    return ns.astype(np.int32), ks.astype(np.int32), idx


def _check(n, k, idx):
    ref = dc.host_reference(n, k, idx)
    got = np.asarray(dc.cwrsi_batch(jnp.asarray(n), jnp.asarray(k),
                                    jnp.asarray(idx)))
    bad = np.flatnonzero(np.any(ref != got, axis=1))
    assert len(bad) == 0, (
        f"{len(bad)} mismatches; first: n={n[bad[0]]} k={k[bad[0]]} "
        f"idx={idx[bad[0]]}\nref={ref[bad[0]][:n[bad[0]]]}\n"
        f"got={got[bad[0]][:n[bad[0]]]}")


def test_cwrsi_random_corpus():
    rng = np.random.default_rng(11)
    n, k, idx = _rand_leaves(rng, 4096)
    _check(n, k, idx)


def test_cwrsi_edges():
    cases = []
    t = dc.u_table().astype(np.uint64)
    for n in (2, 3, 4, 96):
        for k in (1, 2, 127, 128):
            a, b = max(n, k), min(n, k)
            a1, b1 = max(n, k + 1), min(n, k + 1)
            v = int(t[a, b]) + int(t[a1, b1])
            v = min(v, 1 << 32)
            for i in (0, 1, v - 1, v // 2):
                if 0 <= i < v:
                    cases.append((n, k, i))
    n = np.array([c[0] for c in cases], np.int32)
    k = np.array([c[1] for c in cases], np.int32)
    idx = np.array([c[2] for c in cases], np.uint32)
    _check(n, k, idx)


def test_cwrsi_real_stream_leaves():
    """Leaves tapped from a real encoded stream (IAMF_LEAF_TAP)."""
    import ctypes

    lib0 = native.load()
    lib0.iamf_leaf_tap_set(1)
    try:
        import vectors
        from iamf_tpu.constants import ChannelLayout
        from iamf_tpu.core.batch_decoder import (BatchedStreamDecoder,
                                                 _HostPlan)

        try:
            stream = vectors.build_opus_layout_stream(
                ChannelLayout.L510, n_frames=24, frame_size=960, amp=0.5)[0]
        except Exception as e:
            pytest.skip(f"opus encoder unavailable: {e}")
        lib = native.load()
        lib.iamf_leaf_tap_read.restype = ctypes.c_longlong
        cap = 1 << 20
        n = np.zeros(cap, np.int32)
        k = np.zeros(cap, np.int32)
        idx = np.zeros(cap, np.uint32)
        ip = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
        up = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
        lib.iamf_leaf_tap_read(ip(n), ip(k), up(idx),
                               ctypes.c_longlong(cap), 1)
        d = BatchedStreamDecoder(stream, sound_system=1, batch_frames=8)
        plan = _HostPlan(d)
        while plan.next_bufs() is not None:
            pass
        plan.close()
        cnt = lib.iamf_leaf_tap_read(ip(n), ip(k), up(idx),
                                     ctypes.c_longlong(cap), 0)
        assert cnt > 1000
        _check(n[:cnt], k[:cnt], idx[:cnt])
    finally:
        lib0.iamf_leaf_tap_set(0)
