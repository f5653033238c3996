"""Batched CWRS index->pulse decode on the device (the round-5 entropy
experiment, SURVEY §2.3.1 / §7 hard-part 1).

On the round-5 bench content the cwrsi walk (PVQ codeword index -> pulse
vector; reference loop in libopus cwrs.c, our host port in
native/src/opus/celt_pvq.cc) was the largest single part of the Opus host
entropy decode, larger than the range-decoder reads themselves. Unlike
those reads, cwrsi is NOT
entropy-coupled: the (N, K, index) triple per leaf is known the moment the
range decoder consumed the index, and nothing downstream of the pulse
values feeds back into the bit consumption. It is therefore the natural
first stage of a device-side PVQ reconstruction.

Formulation (the trick that makes it a device program): the per-dimension
search `while U(k', n) > i: k'--` walks a row of the CWRS table that is
THE SAME for every leaf at the same dimension n. Batching leaves and
unrolling dimensions top-down, each step needs only
  - the constant row u_n[j] = U(j, n)  ([132] u32, precomputed), and
  - per-lane compares/reductions against it ([lanes, 132] broadcast),
i.e. pure elementwise work with NO gathers from the 2-D table; the two direct
row lookups (p = U(n, k+1), q = U(n, n)) read the same constant row.
Lanes with smaller N idle (masked) until the global dimension counter
drops into their range, then run the identical update; the closing n=2 /
n=1 forms are elementwise. Output pulses land in walk order and one final
gather re-aligns them per leaf.

Bit-exactness: validated against the host cwrsi on every leaf of real
bench content (tools/cwrsi_experiment.py; tests/test_device_cwrsi.py pins
a representative corpus).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

U_MAX_N = 212
U_MAX_K = 132
N_MAX = 96   # largest PVQ leaf dimension at 48 kHz (celt_pvq.cc census)
K_MAX = 128


@functools.lru_cache(maxsize=None)
def u_table() -> np.ndarray:
    """U(n,k) CWRS count table, identical to celt_pvq.cc u_table():
    u64 DP saturated to u32."""
    dp = np.zeros((U_MAX_N, U_MAX_K), np.uint64)
    for n in range(1, U_MAX_N):
        dp[n, 1] = 1
        for k in range(2, U_MAX_K):
            v = dp[n - 1, k] + dp[n, k - 1] + dp[n - 1, k - 1]
            dp[n, k] = min(v, 0xFFFFFFFF)
    return dp.astype(np.uint32)


@functools.lru_cache(maxsize=None)
def u_rows() -> np.ndarray:
    """[N_MAX + 1, U_MAX_K] u32: row d holds u_d[j] = U(j, d) (symmetric
    canonicalization of the 2-D table), the per-dimension constant the
    kernel broadcasts against. Saturated (overflow) entries stay huge so
    they never win a <=i compare."""
    t = u_table()
    rows = np.empty((N_MAX + 1, U_MAX_K), np.uint32)
    for d in range(N_MAX + 1):
        for j in range(U_MAX_K):
            a, b = max(j, d), min(j, d)
            rows[d, j] = t[a, b] if a < U_MAX_N else 0xFFFFFFFF
    return rows


def _search_le(u_row, i, upper):
    """max{k' <= upper : u_row[k'] <= i} — the do{p=U(--k,n)}while(p>i)
    loop as one broadcast compare. u_row is nondecreasing, so the <=i set
    is a prefix and count-1 is its max index. u_row[0] = 0 <= i always."""
    j = jnp.arange(U_MAX_K, dtype=jnp.int32)
    mask = (u_row[None, :] <= i[:, None]) & (j[None, :] <= upper[:, None])
    return jnp.sum(mask.astype(jnp.int32), axis=1) - 1


@functools.partial(jax.jit, static_argnames=("align", "n_max"))
def cwrsi_batch(n, k, idx, align: bool = True, n_max: int = N_MAX):
    """Decode a batch of PVQ leaves: (n, k, idx) int32/uint32 [L] ->
    pulses int32 [L, N_MAX].

    align=True places each leaf's coefficients at [0, n) (entries beyond
    are 0) — the layout the tests diff against the host walk. align=False
    returns the raw walk-ordered layout (leaf coefficient j at column
    N_MAX - n + j): the final re-alignment is a per-lane variable shift
    that XLA lowers to scalar-unit gathers, and an integrated device
    reconstruction consumes walk-ordered pulses + the (host-known) shift
    as metadata instead of paying it.

    Mirrors celt_pvq.cc cwrsi() exactly; dimensions unroll from N_MAX down
    to 3, then the closed n==2 / n==1 forms."""
    L = n.shape[0]
    rows = jnp.asarray(u_rows())
    i = idx.astype(jnp.uint32)
    kk = k.astype(jnp.int32)
    n0 = n.astype(jnp.int32)
    outs = []

    jidx = jnp.arange(U_MAX_K, dtype=jnp.int32)

    def step(d, kk, i):
        """One dimension of the walk (C loop body for current dim d).

        NO gathers anywhere: per-lane row lookups u_d[v] are evaluated as
        one-hot selects over the same [lanes, 132] broadcast the search
        uses. The form was chosen for a compiler that lowered small-table
        jnp.take to scalar gathers; whether a gather is faster on the GPU
        has not been measured."""
        u_d = rows[d]
        onehot = lambda v: jnp.sum(
            jnp.where(jidx[None, :] == v[:, None], u_d[None, :],
                      jnp.uint32(0)), axis=1)
        ge = kk >= d  # "lots of pulses" branch
        p_k1 = onehot(kk + 1)   # U(n, k+1) — shared by branch A and B
        p_k0 = onehot(kk)       # U(n, k)
        # ---- branch A (k >= n): p = U(n, k+1); s = i >= p; i -= p&s
        sA = ge & (i >= p_k1)
        iA = jnp.where(sA, i - p_k1, i)
        q = u_d[d]  # U(n, n)
        upperA = jnp.where(q > iA, d - 1, kk)
        kA = _search_le(u_d, iA, upperA)
        # ---- branch B (k < n)
        zero = (~ge) & (p_k0 <= i) & (i < p_k1)
        sB = (~ge) & ~zero & (i >= p_k1)
        iB = jnp.where(zero, i - p_k0, jnp.where(sB, i - p_k1, i))
        kB = _search_le(u_d, iB, kk - 1)
        # ---- merge, then ONE shared one-hot for p = u_d[k_new]
        s = jnp.where(ge, sA, sB)
        k_new = jnp.where(ge, kA, jnp.where(zero, kk, kB))
        p_new = onehot(k_new)
        i_new = jnp.where(ge, iA - p_new,
                          jnp.where(zero, iB, iB - p_new))
        si = jnp.where(s, jnp.int32(-1), jnp.int32(0))
        y = jnp.where(zero, 0, ((kk - k_new + si) ^ si))
        # inactive lanes (their walk hasn't started / already closed)
        act = (n0 >= d)
        return (jnp.where(act, k_new, kk), jnp.where(act, i_new, i),
                jnp.where(act, y, 0))

    # n_max: static unroll bound — callers bucketing leaves by dimension
    # (e.g. n <= 8 covers ~2/3 of real leaves) skip the idle top steps
    for d in range(n_max, 2, -1):
        kk, i, y = step(d, kk, i)
        outs.append(y)

    # n == 2 closing form
    p = (2 * kk.astype(jnp.uint32) + 1)
    s2 = i >= p
    i = jnp.where(s2, i - p, i)
    k0 = kk
    kk = ((i + 1) >> 1).astype(jnp.int32)
    i = jnp.where(kk > 0, i - (2 * kk.astype(jnp.uint32) - 1), i)
    si = jnp.where(s2, jnp.int32(-1), jnp.int32(0))
    outs.append((k0 - kk + si) ^ si)
    # n == 1 closing form (C: s = -(int)i — i is 0/1 in valid streams,
    # but mirror the arithmetic exactly)
    si = -(i.astype(jnp.int32))
    outs.append((kk + si) ^ si)

    walk = jnp.stack(outs, axis=0)  # [n_max, L] in walk (dim-desc) order
    if not align:
        return walk.T
    # leaf-local coefficient j was emitted at walk step (n_max - n0 + j)
    j = jnp.arange(n_max, dtype=jnp.int32)[None, :]
    src = jnp.clip(n_max - n0[:, None] + j, 0, n_max - 1)
    y = jnp.take_along_axis(walk.T, src, axis=1)
    return jnp.where(j < n0[:, None], y, 0)


def host_reference(n, k, idx) -> np.ndarray:
    """Host cwrsi via the native lib (the oracle for the kernel)."""
    import ctypes

    from ... import native

    lib = native.load()
    cnt = len(n)
    y = np.zeros((cnt, 208), np.int32)
    lib.iamf_cwrsi_bench.restype = ctypes.c_longlong
    ip = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
    lib.iamf_cwrsi_bench(
        ip(np.ascontiguousarray(n, np.int32)),
        ip(np.ascontiguousarray(k, np.int32)),
        np.ascontiguousarray(idx, np.uint32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint32)),
        int(cnt), 1, ip(y))
    return y[:, :N_MAX]
