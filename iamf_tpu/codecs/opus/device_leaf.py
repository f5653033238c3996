"""Device PVQ leaf reconstruction: pulses -> normalized, spread-rotated
leaf vectors (stage 2 of the on-device post-range CELT reconstruction;
stage 1 is the CWRS pulse decode in device_cwrsi.py).

Reference behavior: alg_unquant (celt_pvq.cc / libopus vq.c) scales the
decoded pulse vector to the unit sphere times the theta-path gain
(X = y * gain / sqrt(sum y^2)) and applies the spreading rotation
exp_rotation(X, N, -1, B, K, spread).

Device formulation, driven by a census of the leaves of real streams:
- normalization is a pure row op over the [L, N_MAX] pulse batch;
- 90.5% of real leaves skip rotation entirely (2K >= N or SPREAD_NONE),
  a host-known predicate of (N, K, spread);
- the rotating ~9.5% fall into a small set of distinct (N, K, spread, B)
  configs (~1000 per stream, most far rarer), and exp_rotation is a
  LINEAR map per config — so the host builds each config's dense matrix
  ONCE by pushing unit vectors through the exact native rotation
  (iamf_exp_rotation shim) and the device applies a gathered batched
  matvec. Matrix application reorders float ops vs the sequential
  two-pass rotation, so parity is ~1e-6 relative (validated against the
  host's post-rotation vectors tapped from real streams), well inside
  the opus SNR bar.
"""

from __future__ import annotations

import ctypes
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ... import native
from .device_cwrsi import N_MAX, cwrsi_batch

ROT_W = 96  # rotation matrix pad (largest rotating leaf dimension)


@functools.lru_cache(maxsize=None)
def _native():
    lib = native.load()
    lib.iamf_exp_rotation.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.iamf_exp_rotation.restype = None
    return lib


def needs_rotation(n, k, spread) -> np.ndarray:
    """exp_rotation's early-out predicate (host-known per leaf)."""
    return ~((2 * np.asarray(k) >= np.asarray(n)) | (np.asarray(spread) == 0))


@functools.lru_cache(maxsize=None)
def rotation_matrix(n: int, k: int, spread: int, blocks: int) -> np.ndarray:
    """[n, n] dense matrix of exp_rotation(X, n, -1, blocks, k, spread),
    built by pushing unit vectors through the exact native rotation."""
    lib = _native()
    m = np.zeros((n, n), np.float32)
    for j in range(n):
        v = np.zeros(n, np.float32)
        v[j] = 1.0
        lib.iamf_exp_rotation(
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, -1, blocks, k, spread)
        m[:, j] = v
    return m


def build_rotation_bank(configs) -> np.ndarray:
    """[n_cfg, ROT_W, ROT_W] padded matrix bank for a config list of
    (n, k, spread, blocks) tuples (identity outside each n x n block so
    padded lanes pass through)."""
    bank = np.tile(np.eye(ROT_W, dtype=np.float32),
                   (len(configs), 1, 1))
    for i, (n, k, spread, blocks) in enumerate(configs):
        bank[i, :n, :n] = rotation_matrix(int(n), int(k), int(spread),
                                          int(blocks))
    return bank


@jax.jit
def normalize_pulses(y, gain):
    """alg_unquant normalization: X = y * gain / sqrt(sum y^2).
    y: [L, N_MAX] int32 pulses (zero-padded), gain: [L] float32."""
    yf = y.astype(jnp.float32)
    ryy = jnp.sum(yf * yf, axis=1)
    return yf * (gain / jnp.sqrt(ryy))[:, None]


@jax.jit
def apply_rotations(X, cfg_idx, bank):
    """Gathered batched matvec: X [L, ROT_W], cfg_idx [L] int32 into
    bank [n_cfg, ROT_W, ROT_W]."""
    mats = bank[cfg_idx]  # [L, ROT_W, ROT_W]
    return jnp.einsum("lij,lj->li", mats, X,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)


def _pad_pow2(m: int, lo: int = 64) -> int:
    p = lo
    while p < m:
        p *= 2
    return p


def reconstruct(n, k, idx, gain, spread, blocks):
    """Full device leaf reconstruction for a batch of real leaves:
    cwrsi -> normalize -> rotation (rotating subset via the matrix bank).
    Returns [L, N_MAX] float32 leaf vectors (host orchestration around
    the jitted stages; the experiment's correctness entry point). Batch
    axes pad to power-of-two sizes so repeated calls with ragged leaf
    counts share compiled programs."""
    n = np.asarray(n, np.int32)
    k = np.asarray(k, np.int32)
    L = len(n)
    P = _pad_pow2(L)
    pn = np.full(P, 2, np.int32)
    pk = np.ones(P, np.int32)
    pi = np.zeros(P, np.uint32)
    pg = np.ones(P, np.float32)
    pn[:L], pk[:L] = n, k
    pi[:L] = np.asarray(idx, np.uint32)
    pg[:L] = np.asarray(gain, np.float32)
    rot = needs_rotation(n, k, spread)
    y = cwrsi_batch(jnp.asarray(pn), jnp.asarray(pk), jnp.asarray(pi))
    X = np.array(normalize_pulses(y, jnp.asarray(pg)))[:L]
    if rot.any():
        sel = np.flatnonzero(rot)
        cfgs, inv = np.unique(
            np.stack([n[sel], k[sel], np.asarray(spread)[sel],
                      np.asarray(blocks)[sel]], axis=1),
            axis=0, return_inverse=True)
        bank = build_rotation_bank([tuple(c) for c in cfgs])
        R = _pad_pow2(len(sel), 16)
        CB = _pad_pow2(len(cfgs), 8)
        bank = np.concatenate(
            [bank, np.tile(np.eye(ROT_W, dtype=np.float32),
                           (CB - len(cfgs), 1, 1))]) \
            if CB > len(cfgs) else bank
        Xr = np.zeros((R, ROT_W), np.float32)
        Xr[:len(sel), :N_MAX] = X[sel][:, :ROT_W]
        ci = np.zeros(R, np.int32)
        ci[:len(sel)] = inv
        out = np.asarray(apply_rotations(
            jnp.asarray(Xr), jnp.asarray(ci), jnp.asarray(bank)))
        X[sel] = out[:len(sel), :N_MAX]
    return X


# ---- stage 3 mechanism: the noise-fill LCG on device -------------------
# celt_lcg_rand (celt_energy.cc / libopus celt.h): seed' = 1664525*seed +
# 1013904223 (mod 2^32). Noise/fold leaves draw N values each, and the
# draw COUNT depends on device-resident collapse masks, so the seed that
# reaches a given leaf is device data. Jump-ahead makes it parallel:
# seed_after_j = A^j * seed + B_j (mod 2^32) with precomputed (A^j, B_j)
# tables — one u32 multiply-add per (leaf, position) instead of a scan.

LCG_A = np.uint32(1664525)
LCG_C = np.uint32(1013904223)
LCG_MAX = 4096  # >= max cumulative draws per frame (<= coded bins, 960)


@functools.lru_cache(maxsize=None)
def lcg_jump_tables() -> tuple[np.ndarray, np.ndarray]:
    """(A^j, B_j) for j = 0..LCG_MAX, u32: seed_after_j = A^j*seed + B_j."""
    a = np.empty(LCG_MAX + 1, np.uint32)
    b = np.empty(LCG_MAX + 1, np.uint32)
    aj, bj = 1, 0
    for j in range(LCG_MAX + 1):
        a[j], b[j] = aj, bj
        aj = (aj * 1664525) & 0xFFFFFFFF
        bj = (bj * 1664525 + 1013904223) & 0xFFFFFFFF
    return a, b


@functools.partial(jax.jit, static_argnames=("width",))
def lcg_noise_fill(seed0, draws, width: int):
    """Batched noise-fill draws: for each lane l, produce the LCG values
    v[l, j] = seed after (prefix_draws[l] + j + 1) steps from seed0[l's
    frame]... simplified to the per-leaf form used by the band decode:
    given each leaf's ENTRY seed (already jump-ahead-composed), emit its
    first `width` draws. seed0: [L] u32 entry seeds; draws: [L] int32
    actual counts (values beyond are junk); returns [L, width] u32."""
    a, b = lcg_jump_tables()
    aj = jnp.asarray(a[1:width + 1])  # draw j uses seed after j+1 steps
    bj = jnp.asarray(b[1:width + 1])
    del draws  # static width; callers mask by count
    return seed0[:, None] * aj[None, :] + bj[None, :]


@jax.jit
def lcg_leaf_entry_seeds(frame_seed, leaf_draws):
    """Seed threading ACROSS leaves of one frame (the sequential part of
    stage 3): leaf l's entry seed = frame_seed advanced by the total
    draws of earlier leaves. leaf_draws: [L] int32 (0 for non-noise
    leaves); cumulative prefix + jump-ahead gather. Returns [L] u32."""
    a, b = lcg_jump_tables()
    prefix = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32),
         jnp.cumsum(leaf_draws.astype(jnp.int32))[:-1]])
    prefix = jnp.clip(prefix, 0, LCG_MAX)
    aj = jnp.take(jnp.asarray(a), prefix)
    bj = jnp.take(jnp.asarray(b), prefix)
    return frame_seed * aj + bj
