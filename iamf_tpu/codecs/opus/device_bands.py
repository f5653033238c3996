"""Jitted device band-walk (spike): the packed band tables as a compiled
device program, for the long-block mono frame class.

Consumes band_pack's flattened representation — per-band leaf slots with
bit-matrix fill maps, cm shifts, LCG jump-ahead, fold gathers from the
norm-buffer carry — as ONE jitted program: a 21-step unrolled band loop
threading (collapse-mask vector, LCG seed, norm buffer) with all per-slot
work vectorized. Leaf placement uses jnp.roll by the (traced) offset;
noise values come from the jump-ahead tables with an intra-band masked
prefix; fold sources are dynamic slices of the norm carry.

Spike scope (asserted by the packer-side gate `packable`): C==1, LM==3,
every band cfg == (0 recombine, 0 time_divide, longBlocks, B0==1) — the
non-transient mono frame class. Transient/stereo frames use the numpy
packed executor (their machinery is the same flat tables plus per-band
linear transforms — the matrix treatment device_leaf already applies to
rotations). Validated frame-exact against packed_replay_frame /
the decoder tap (tests/test_band_replay.py::test_jit_band_walk)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .band_replay import EBANDS
from .device_leaf import lcg_jump_tables

NBANDS = 21
SLOTS = 16          # max leaves per band (census max for one band)
W = 176             # widest band at LM=3
NBINS = 800         # 8 * eBands[21]
M = 8               # LM=3


def band_sizes():
    return (M * (EBANDS[1:] - EBANDS[:-1])).astype(np.int32)  # [21]


def band_offsets():
    return (M * EBANDS[:-1]).astype(np.int32)


def packable(pf) -> bool:
    """True when the frame fits the jitted program's class (mono LM=3,
    long-block AND transient: per-band transforms come from the config
    matrix banks)."""
    if pf.C != 1 or pf.M != M or pf.norm_offset != 0:
        return False
    for b in pf.bands:
        if b.mode != 0 or b.avg:
            return False
    for lf in pf.leaves:
        if lf.k == -1 or lf.n > W:
            return False
    return True


# Per-band transform-config banks: at LM=3 mono, a band's upward X
# transform and its lowband pre-transform are linear maps determined by
# (B_in, tf) — a handful of combos. Matrices are built by pushing unit
# vectors through the exact numpy transforms (band_replay's
# haar/hadamard), the same treatment device_leaf gives rotations.
CFGS = []            # (B_in, tf) combos, index = cfg id
for _b in (1, 8):
    for _tf in (-3, -2, -1, 0, 1, 2, 3):
        CFGS.append((_b, _tf))
CFG_ID = {c: i for i, c in enumerate(CFGS)}


@functools.lru_cache(maxsize=None)
def _post_matrix(N: int, B_in: int, tf: int) -> np.ndarray:
    """[N, N] matrix of quant_band's upward X transforms
    (interleave_hadamard + time-divide haars + recombine haars)."""
    from .band_replay import haar1, interleave_hadamard

    recombine = tf if tf > 0 else 0
    B = B_in >> recombine
    nb = (N // B_in) << recombine
    tfc = tf
    td = 0
    while (nb & 1) == 0 and tfc < 0:
        B <<= 1
        nb >>= 1
        tfc += 1
        td += 1
    B0, N_B0 = B, nb
    longBlocks = int(B_in == 1)
    m = np.zeros((N, N), np.float32)
    for j in range(N):
        x = np.zeros(N, np.float32)
        x[j] = 1.0
        if B0 > 1:
            interleave_hadamard(x, N_B0 >> recombine, B0 << recombine,
                                longBlocks)
        tdB, tdN = B0, N_B0
        for _ in range(td):
            tdB >>= 1
            tdN <<= 1
            haar1(x, tdN, tdB)
        for kk in range(recombine):
            haar1(x, N >> kk, 1 << kk)
        m[:, j] = x
    return m


@functools.lru_cache(maxsize=None)
def _pre_matrix(N: int, B_in: int, tf: int) -> np.ndarray:
    """[N, N] matrix of the lowband pre-transforms (haar chain +
    deinterleave_hadamard)."""
    from .band_replay import deinterleave_hadamard, haar1

    recombine = tf if tf > 0 else 0
    B = B_in >> recombine
    nb = (N // B_in) << recombine
    tfc = tf
    td = 0
    while (nb & 1) == 0 and tfc < 0:
        B <<= 1
        nb >>= 1
        tfc += 1
        td += 1
    B0, N_B0 = B, nb
    longBlocks = int(B_in == 1)
    m = np.zeros((N, N), np.float32)
    for j in range(N):
        x = np.zeros(N, np.float32)
        x[j] = 1.0
        for kk in range(recombine):
            haar1(x, N >> kk, 1 << kk)
        tdB = B_in >> recombine
        tdN = (N // B_in) << recombine
        tfc2 = tf
        while (tdN & 1) == 0 and tfc2 < 0:
            haar1(x, tdN, tdB)
            tdB <<= 1
            tdN >>= 1
            tfc2 += 1
        if B0 > 1:
            deinterleave_hadamard(x, N_B0 >> recombine, B0 << recombine,
                                  longBlocks)
        m[:, j] = x
    return m


@functools.lru_cache(maxsize=None)
def cfg_banks():
    """Per-band matrix banks [n_cfg, N, N] (post and pre) + cm-map bank
    [n_cfg, 16] and final-B-mask bank [n_cfg] for every (B_in, tf)
    combo at each of the 21 static band sizes."""
    from .band_pack import _band_cm_cols

    sizes = band_sizes()
    post, pre, cmc, bmask = [], [], [], []
    for i in range(NBANDS):
        N = int(sizes[i])
        po = np.zeros((len(CFGS), N, N), np.float32)
        pr = np.zeros((len(CFGS), N, N), np.float32)
        cc = np.zeros((len(CFGS), 16), np.uint32)
        bm = np.zeros(len(CFGS), np.uint32)
        for ci, (B_in, tf) in enumerate(CFGS):
            if N % B_in:
                po[ci] = np.eye(N, dtype=np.float32)
                pr[ci] = np.eye(N, dtype=np.float32)
                bm[ci] = 1
                cc[ci] = 0
                continue
            po[ci] = _post_matrix(N, B_in, tf)
            pr[ci] = _pre_matrix(N, B_in, tf)
            recombine = tf if tf > 0 else 0
            B = B_in >> recombine
            nb = (N // B_in) << recombine
            tfc = tf
            td = 0
            while (nb & 1) == 0 and tfc < 0:
                B <<= 1
                nb >>= 1
                tfc += 1
                td += 1
            cc[ci] = _band_cm_cols(recombine, td, B)
            B_fin = (B >> td) << recombine
            bm[ci] = (1 << B_fin) - 1
        post.append(po)
        pre.append(pr)
        cmc.append(cc)
        bmask.append(bm)
    return post, pre, cmc, bmask


def pack_tensors(pf, leaf_vecs):
    """PackedFrame -> fixed-shape numpy tensors for the jitted program."""
    sizes = band_sizes()
    offs = band_offsets()
    bt = {
        "present": np.zeros(NBANDS, np.int32),
        "has_lb": np.zeros(NBANDS, np.int32),
        "eff": np.zeros(NBANDS, np.int32),
        "fs": np.zeros(NBANDS, np.int32),
        "fe": np.zeros(NBANDS, np.int32),
        "last": np.ones(NBANDS, np.int32),
        "B_in": np.ones(NBANDS, np.int32),
        "cfg_id": np.zeros(NBANDS, np.int32),
    }
    lt = {
        "n": np.zeros((NBANDS, SLOTS), np.int32),
        "k": np.full((NBANDS, SLOTS), -2, np.int32),
        "off": np.zeros((NBANDS, SLOTS), np.int32),
        "gain": np.zeros((NBANDS, SLOTS), np.float32),
        "b_leaf": np.ones((NBANDS, SLOTS), np.int32),
        "cm_shift": np.zeros((NBANDS, SLOTS), np.int32),
        "fill_cols": np.zeros((NBANDS, SLOTS, 16), np.uint32),
        "vec": np.zeros((NBANDS, SLOTS, W), np.float32),
    }
    counts = np.zeros(NBANDS, np.int32)
    for b in pf.bands:
        assert sizes[b.i] == b.N and offs[b.i] == b.offX + pf.norm_offset
        bt["present"][b.i] = 1
        bt["has_lb"][b.i] = int(b.has_lb)
        bt["eff"][b.i] = b.eff if b.has_lb else 0
        bt["fs"][b.i] = b.fs
        bt["fe"][b.i] = max(b.fe, b.fs + 1)
        bt["last"][b.i] = int(b.last)
        bt["B_in"][b.i] = b.B
        bt["cfg_id"][b.i] = CFG_ID[(b.B, max(min(b.tf, 3), -3))]
    for lf in pf.leaves:
        s = counts[lf.band]
        counts[lf.band] += 1
        assert s < SLOTS
        lt["n"][lf.band, s] = lf.n
        lt["k"][lf.band, s] = lf.k
        lt["off"][lf.band, s] = lf.off
        lt["gain"][lf.band, s] = lf.gain
        lt["b_leaf"][lf.band, s] = lf.b_leaf
        lt["cm_shift"][lf.band, s] = lf.cm_shift
        lt["fill_cols"][lf.band, s] = lf.fill_cols
        if lf.vec_idx >= 0:
            v = leaf_vecs[lf.vec_idx]
            lt["vec"][lf.band, s, :min(len(v), W)] = v[:W]
    return bt, lt


def _apply_cols16(cols, v):
    """OR-map apply: cols [.., 16] u32, v scalar u32 -> [..] u32."""
    out = jnp.zeros(cols.shape[:-1], jnp.uint32)
    for i in range(16):
        hit = ((v >> i) & 1) > 0
        out = out | jnp.where(hit, cols[..., i], jnp.uint32(0))
    return out


POST_BANK, PRE_BANK, CM_BANK, BM_BANK = None, None, None, None


def _ensure_banks():
    global POST_BANK, PRE_BANK, CM_BANK, BM_BANK
    if POST_BANK is None:
        POST_BANK, PRE_BANK, CM_BANK, BM_BANK = cfg_banks()


@jax.jit
def run_frame(bt, lt, seed0):
    """Execute one packed mono frame (long-block OR transient). Returns
    (spec [NBINS], seed_out, collapse [NBANDS])."""
    _ensure_banks()
    ja, jb = lcg_jump_tables()
    ja = jnp.asarray(ja)
    jb = jnp.asarray(jb)
    sizes = band_sizes()
    offs = band_offsets()
    jw = jnp.arange(W)

    norm = jnp.zeros(NBINS, jnp.float32)
    spec = jnp.zeros(NBINS, jnp.float32)
    collapse = jnp.zeros(NBANDS, jnp.uint32)
    seed = jnp.uint32(seed0)

    for i in range(NBANDS):
        N = int(sizes[i])
        a = int(offs[i])
        present = bt["present"][i] > 0
        # band entry fill: OR of collapse over the fold range, or full
        idxs = jnp.arange(NBANDS)
        in_rng = (idxs >= bt["fs"][i]) & (idxs < bt["fe"][i])
        masked = jnp.where(in_rng, collapse, jnp.uint32(0))
        cm_or = masked[0]
        for jj in range(1, NBANDS):
            cm_or = cm_or | masked[jj]
        full = (jnp.uint32(1) << bt["B_in"][i].astype(jnp.uint32)) - 1
        entry = jnp.where(bt["has_lb"][i] > 0, cm_or, full)
        # fold source window, through the band's lowband pre-transform
        # (haar chain + deinterleave) gathered from the config bank
        lb_raw = jax.lax.dynamic_slice(
            jnp.pad(norm, (0, W)), (bt["eff"][i],), (W,))
        pre_m = jnp.asarray(PRE_BANK[i])[bt["cfg_id"][i]]
        lb_t = jnp.matmul(pre_m, lb_raw[:N],
                          precision=jax.lax.Precision.HIGHEST)
        lb_full = jnp.zeros(W, jnp.float32).at[:N].set(lb_t)

        X = jnp.zeros(N, jnp.float32)
        cm_acc = jnp.uint32(0)
        # intra-band seed prefix: draws per slot = n if (q0 & f2 != 0)
        n_s = lt["n"][i]
        k_s = lt["k"][i]
        fill_s = _apply_cols16(lt["fill_cols"][i], entry)
        cmask_s = (jnp.uint32(1) << lt["b_leaf"][i].astype(jnp.uint32)) - 1
        f2_s = fill_s & cmask_s
        is_q0 = (k_s == 0)
        draws_s = jnp.where(is_q0 & (f2_s > 0), n_s, 0)
        prefix = jnp.concatenate(
            [jnp.zeros(1, jnp.int32), jnp.cumsum(draws_s)[:-1]])
        for s in range(SLOTS):
            active = k_s[s] > -2
            n = n_s[s]
            off = lt["off"][i, s]
            mask = jw < n
            # LCG values for this slot (draw j uses seed after prefix+j+1)
            steps = jnp.clip(prefix[s] + jw + 1, 0, 4096)
            vals = seed * jnp.take(ja, steps) + jnp.take(jb, steps)
            noise = jnp.float32(
                1.0) * (vals.astype(jnp.int32) >> 20).astype(jnp.float32)
            sgn = jnp.where((vals & 0x8000) > 0, jnp.float32(1 / 256),
                            jnp.float32(-1 / 256))
            fold_src = jax.lax.dynamic_slice(
                jnp.concatenate([lb_full, jnp.zeros(W, jnp.float32)]),
                (off,), (W,))
            q0_has_lb = bt["has_lb"][i] > 0
            q0v = jnp.where(
                f2_s[s] == 0, jnp.zeros(W, jnp.float32),
                jnp.where(q0_has_lb, fold_src + sgn, noise))
            q0v = jnp.where(mask, q0v, 0.0)
            e = jnp.float32(1e-15) + jnp.sum(q0v * q0v)
            q0v = q0v * (lt["gain"][i, s] / jnp.sqrt(e))
            v = jnp.where(k_s[s] > 0, lt["vec"][i, s], q0v)
            v = jnp.where(mask & active, v, 0.0)
            # placement: pad v to N-width then roll by off
            vpad = jnp.zeros(N, jnp.float32).at[:min(W, N)].set(
                v[:min(W, N)])
            X = X + jnp.roll(vpad, off)
            # collapse contribution: bit b set when block b has energy
            bl = lt["b_leaf"][i, s]
            blk = jnp.where(n > 0, (jw * bl) // jnp.maximum(n, 1), 0)
            nz = (v != 0) & mask
            cm_pvq = jnp.uint32(0)
            for bb in range(8):
                has = jnp.any(nz & (blk == bb))
                cm_pvq = cm_pvq | jnp.where(
                    has, jnp.uint32(1) << bb, jnp.uint32(0))
            cm_q0 = jnp.where(
                f2_s[s] == 0, jnp.uint32(0),
                jnp.where(q0_has_lb, f2_s[s], cmask_s[s]))
            cm = jnp.where(k_s[s] > 0,
                           jnp.where(lt["b_leaf"][i, s] > 1, cm_pvq,
                                     jnp.uint32(1)),
                           cm_q0)
            cm = jnp.where(active, cm, jnp.uint32(0))
            cm_acc = cm_acc | (cm << lt["cm_shift"][i, s].astype(
                jnp.uint32))
        # advance the seed by the band's total draws
        tot = jnp.clip(prefix[-1] + draws_s[-1], 0, 4096)
        seed = seed * jnp.take(ja, tot) + jnp.take(jb, tot)
        # upward transforms + cm post-map from the config banks
        post_m = jnp.asarray(POST_BANK[i])[bt["cfg_id"][i]]
        X = jnp.matmul(post_m, X, precision=jax.lax.Precision.HIGHEST)
        cmv = _apply_cols16(jnp.asarray(CM_BANK[i])[bt["cfg_id"][i]],
                            cm_acc) & jnp.asarray(BM_BANK[i])[
            bt["cfg_id"][i]]
        collapse = collapse.at[i].set(jnp.where(present, cmv,
                                                collapse[i]))
        spec = jax.lax.dynamic_update_slice(
            spec, jnp.where(present, X, spec[a:a + N]), (a,))
        sq = jnp.float32(np.sqrt(N))
        write_norm = present & (bt["last"][i] == 0)
        norm = jax.lax.dynamic_update_slice(
            norm, jnp.where(write_norm, sq * X, norm[a:a + N]), (a,))
    return spec, seed, collapse
