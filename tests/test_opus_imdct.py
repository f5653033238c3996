"""CELT synthesis filterbank (tpu_synth._imdct_overlap) vs an independent
float64 model of the reference's IMDCT + TDAC window loop.

The model follows celt/mdct.c clt_mdct_backward as the C code runs it: per
block, the N2 raw IMDCT samples land after the previous block's 60-sample
tail, the 120-sample overlap region is mirrored in place with the CELT
window, the first N2 samples are final and the last 60 carry to the next
block. Transient frames run M = N/120 short blocks whose coefficients
interleave with stride M. It shares no code with the device path: the
window comes from its closed form and the IMDCT is a float64 sum.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from iamf_tpu.codecs.opus import tpu_synth

OVERLAP = 120


def celt_window() -> np.ndarray:
    """The CELT low-overlap window (power-complementary, Vorbis form)."""
    i = np.arange(OVERLAP)
    return np.sin(0.5 * np.pi * np.sin(0.5 * np.pi * (i + 0.5) / OVERLAP)
                  ** 2)


def imdct_raw(X: np.ndarray) -> np.ndarray:
    """t[m] = sum_k X[k] cos(pi/N2 (m + N2 + 1/2)(k + 1/2)), m < N2."""
    n2 = X.shape[0]
    m = np.arange(n2)[:, None]
    k = np.arange(n2)[None, :]
    return np.cos(np.pi / n2 * (m + n2 + 0.5) * (k + 0.5)) @ X


def reference(freq, transient, tail0):
    """freq [B, L, n] float64, transient [B, L] bool, tail0 [L, 60] ->
    (y [B, L, n], tail [L, 60]), frame by frame."""
    w = celt_window()
    B, L, n = freq.shape
    M = n // 120
    y = np.zeros((B, L, n))
    tail = np.array(tail0, np.float64)
    for b in range(B):
        for lane in range(L):
            if transient[b, lane] and M > 1:
                blocks = [freq[b, lane, j::M] for j in range(M)]
            else:
                blocks = [freq[b, lane]]
            carry, pos = tail[lane], 0
            for X in blocks:
                n2 = X.shape[0]
                region = np.concatenate([carry, imdct_raw(X)])
                for i in range(OVERLAP // 2):
                    j = OVERLAP - 1 - i
                    x1, x2 = region[j], region[i]
                    region[i] = w[j] * x2 - w[i] * x1
                    region[j] = w[i] * x2 + w[j] * x1
                y[b, lane, pos:pos + n2] = region[:n2]
                carry = region[n2:n2 + OVERLAP // 2]
                pos += n2
            tail[lane] = carry
    return y, tail


def _inputs(kind: str, n: int, B: int = 5, L: int = 3, seed: int = 0):
    rng = np.random.RandomState(seed)
    freq = rng.randn(B, L, n) * 3000.0
    if kind == "long":
        transient = np.zeros((B, L), bool)
    elif kind == "short":
        transient = np.ones((B, L), bool)
    else:
        transient = rng.rand(B, L) < 0.5
        transient[0, 0], transient[1, 0] = True, False
    tail0 = rng.randn(L, 60) * 500.0
    return freq, transient, tail0


def _device(freq, transient, tail0):
    y, tail = tpu_synth._imdct_overlap(
        jnp.asarray(freq, jnp.float32), jnp.asarray(transient),
        jnp.asarray(tail0, jnp.float32))
    return np.asarray(y, np.float64), np.asarray(tail, np.float64)


def _assert_close(got, want):
    # float32 products and sums over up to 960 terms of ~3000-scale inputs
    tol = 2e-6 * np.abs(want).max() + 1e-3
    assert np.abs(got - want).max() <= tol, np.abs(got - want).max()


def test_window_table_matches_closed_form():
    w = tpu_synth._tables()[0]
    assert np.abs(w - celt_window()).max() < 1e-7


@pytest.mark.parametrize("kind,n", [("long", 960), ("short", 960),
                                    ("mixed", 960), ("mixed", 480),
                                    ("mixed", 240), ("long", 120)])
def test_imdct_overlap_matches_reference(kind, n):
    freq, transient, tail0 = _inputs(kind, n)
    y, tail = _device(freq, transient, tail0)
    y_ref, tail_ref = reference(freq, transient, tail0)
    _assert_close(y, y_ref)
    _assert_close(tail, tail_ref)


def test_tail_chains_across_calls():
    """Two calls with the tail carried between them equal one call over
    all frames (the batch boundary of the decode loop)."""
    freq, transient, tail0 = _inputs("mixed", 960, B=6, seed=1)
    y1, t1 = _device(freq[:2], transient[:2], tail0)
    y2, t2 = _device(freq[2:], transient[2:], t1)
    y_ref, tail_ref = reference(freq, transient, tail0)
    _assert_close(np.concatenate([y1, y2]), y_ref)
    _assert_close(t2, tail_ref)
