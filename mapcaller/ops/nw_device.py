"""Batched gapped-extension (NW) kernel — plain JAX/XLA.

Device form of the reference's default aligner (ref:
src/nw_alignment.cpp:18-83; scoring contract in ops/nw_host.py: x2-scaled
integers, match +2 / mismatch -2, OPEN -2, EXTEND -1, NEW -3), producing
bit-identical traceback decisions.

The key vectorization: with E=EXTEND > NEW the coupled row recurrence
    r[j] = max(r[j-1]+E, s[j-1]+NEW)
    s[j] = max(diag[j], r[j], t[j])
collapses (substituting s[j-1] = max(r[j-1], c[j-1]),
c[j] = max(diag[j], t[j])) to a single affine max-plus chain
    r[j] = max_{k<j} (c[k] + NEW + (j-1-k)*E)
        = NEW + (j-1)*E + cummax_k (c[k] - k*E),
so every DP row is a handful of elementwise ops plus ONE cummax — no
sequential inner loop, no gathers. A `lax.scan` sweeps the rows over the
whole batch and emits 2-bit traceback directions (0=diag,
1=left/'-in-s1', 2=up/'-in-s2', with the reference's s==r, then s==t
priority); the traceback walks them on device too, so only packed ops
come back to the host.
"""
from __future__ import annotations

import functools

from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

MAXPEN = -131072
OPENG = -2
EXTG = -1
NEWG = -3


def _row_sweep(c1_row, c2, t_prev, s_prev, i):
    """One DP row (vectorized over the batch).
    c1_row: int32[B, 1] codes of s1[i-1]; c2: int32[B, N].
    Returns (t_cur, r_cur, s_cur, dirs) over columns 0..N."""
    B, N = c2.shape
    j = jax.lax.broadcasted_iota(jnp.int32, (B, N + 1), 1)
    # column-0 boundary (ref: nw_host.py:44-45)
    s_b0 = OPENG + i * EXTG
    match = jnp.where(c1_row == c2, 2, -2)
    # vertical-gap state (elementwise in j)
    t_cur = jnp.maximum(t_prev + EXTG, s_prev + NEWG)
    t_cur = jnp.where(j == 0, s_b0, t_cur)
    diag = s_prev[:, :-1] + match                       # [B, N] for j>=1
    # c[k]: the non-horizontal candidate at column k (c[0] = boundary s)
    c = jnp.concatenate(
        [jnp.full((B, 1), s_b0, dtype=t_cur.dtype),
         jnp.maximum(diag, t_cur[:, 1:])], axis=1)      # [B, N+1]
    cm = jax.lax.cummax(c - j * EXTG, axis=1)
    r_cur = NEWG + (j - 1) * EXTG + jnp.concatenate(
        [jnp.full((B, 1), 0, dtype=cm.dtype), cm[:, :-1]], axis=1)
    r_cur = jnp.where(j == 0, MAXPEN, r_cur)
    s_cur = jnp.maximum(r_cur, c)
    s_cur = jnp.where(j == 0, s_b0, s_cur)
    dirs = jnp.where(s_cur == r_cur, 1,
                     jnp.where(s_cur == t_cur, 2, 0)).astype(jnp.int8)
    return t_cur, r_cur, s_cur, dirs


def nw_fill(c1, c2, m, n):
    """c1 int32[B, M], c2 int32[B, N], m/n int32[B] ->
    (dirs int8[B, M+1, N+1], score int32[B])."""
    B, M = c1.shape
    N = c2.shape[1]
    j = jax.lax.broadcasted_iota(jnp.int32, (B, N + 1), 1)
    # row 0 (ref: nw_host.py:46-47): s = r = OPEN+j*EXT -> left
    t0 = jnp.where(j == 0, 0, MAXPEN)
    s0 = jnp.where(j == 0, 0, OPENG + j * EXTG)
    dirs0 = jnp.where(j > 0, 1, 0).astype(jnp.int8)

    def row(carry, xs):
        t_prev, s_prev, score = carry
        i, c1_row = xs
        t_cur, _, s_cur, dirs = _row_sweep(c1_row[:, None], c2, t_prev,
                                           s_prev, i)
        at_n = jnp.take_along_axis(s_cur, n[:, None], axis=1)[:, 0]
        score = jnp.where(i == m, at_n, score)
        return (t_cur, s_cur, score), dirs

    score0 = jnp.full((B,), MAXPEN, dtype=jnp.int32)
    (_, _, score), dirs = jax.lax.scan(
        row, (t0, s0, score0),
        (jnp.arange(1, M + 1, dtype=jnp.int32), c1.T))
    dirs = jnp.concatenate([dirs0[None], dirs], axis=0)  # [M+1, B, N+1]
    return jnp.transpose(dirs, (1, 0, 2)), score


def nw_traceback(dirs, m, n):
    """On-device traceback: walks the direction matrix per lane and
    returns 2-bit ops packed 16/int32 — ~1500x less device->host
    transfer than downloading the [B, M+1, N+1] direction matrix."""
    B, MP1, NP1 = dirs.shape
    ND = MP1 + NP1 - 2
    flat = dirs.reshape(B, -1)

    def body(carry, _):
        i, j = carry
        done = (i <= 0) & (j <= 0)
        d = jnp.take_along_axis(flat, (i * NP1 + j)[:, None],
                                axis=1)[:, 0].astype(jnp.int32)
        d = jnp.where(done, 3, d)
        ni = jnp.where(done | (d == 1), i, i - 1)
        nj = jnp.where(done | (d == 2), j, j - 1)
        return (ni, nj), d

    _, ops = jax.lax.scan(body, (m, n), None, length=ND)
    ops = ops.T.astype(jnp.uint32)                      # [B, ND]
    ops_p = ops.reshape(B, ND // 16, 16)
    sh = (jnp.arange(16, dtype=jnp.uint32) * 2)[None, None, :]
    return (ops_p << sh).sum(axis=2, dtype=jnp.uint32)  # [B, ND/16]


@jax.jit
def nw_ops(c1, c2, m, n):
    """DP fill + traceback in one dispatch: (ops uint32[B, (M+N)/16],
    score int32[B]); the direction matrix never leaves the device."""
    c1, c2 = c1.astype(jnp.int32), c2.astype(jnp.int32)
    m, n = m.astype(jnp.int32), n.astype(jnp.int32)
    dirs, score = nw_fill(c1, c2, m, n)
    return nw_traceback(dirs, m, n), score


def padded_batch(n: int) -> int:
    """Pad a DP batch to a power of two (>= 64): one compiled program
    per size class instead of one per distinct pair count."""
    return max(64, 1 << max(n - 1, 0).bit_length())


def _replay_ops(s1: str, s2: str, words: np.ndarray):
    """Host reconstruction of the '-'-padded strings from packed ops."""
    a1 = list(s1)
    a2 = list(s2)
    i, j = len(s1), len(s2)
    k = 0
    while i > 0 or j > 0:
        d = (int(words[k >> 4]) >> ((k & 15) * 2)) & 3
        if d == 1:
            a1.insert(i, "-")
            j -= 1
        elif d == 2:
            a2.insert(j, "-")
            i -= 1
        else:
            i -= 1
            j -= 1
        k += 1
    return "".join(a1), "".join(a2)


def _encode_side(strs: List[str], width: int, B: int, reverse: bool = False,
                 pad: int = 4):
    """Vectorized 2-bit encode of variable-length strings into a padded
    [B, width] code matrix (pad value 4) + int32 lengths — replaces the
    per-pair Python loop that dominated host time at production batch
    sizes."""
    from ..dna import NT4_TABLE
    bufs = [s.encode() for s in strs]
    lens = np.fromiter((len(b) for b in bufs), np.int32, len(bufs))
    out = np.full((B, width), pad, dtype=np.uint8)
    if bufs:
        codes = NT4_TABLE[np.frombuffer(b"".join(bufs), dtype=np.uint8)]
        row = np.repeat(np.arange(len(bufs)), lens)
        col = np.arange(codes.size) - np.repeat(
            np.cumsum(lens, dtype=np.int64) - lens, lens)
        if reverse:          # right-aligned, reversed (ksw2 query layout)
            out[row, width - 1 - col] = codes
        else:
            out[row, col] = codes
    m = np.zeros(B, dtype=np.int32)
    m[:len(bufs)] = lens
    return out, m


def nw_align_batch(pairs: List[Tuple[str, str]], M: int = 192, N: int = 192,
                   return_ops: bool = False):
    """Align a list of (s1, s2) pairs on device and return '-'-padded
    strings, bit-identical to ops/nw_host.nw_alignment. M + N must be a
    multiple of 16 (packed ops). Only packed 2-bit ops come back."""
    if (M + N) % 16:
        raise ValueError(f"M + N = {M + N} is not a multiple of 16")
    for s1, s2 in pairs:
        if len(s1) > M or len(s2) > N:
            raise ValueError(f"pair ({len(s1)}, {len(s2)}) exceeds "
                             f"the {M}x{N} kernel")
    B = padded_batch(len(pairs))
    c1, m = _encode_side([a for a, _ in pairs], M, B)
    c2, n = _encode_side([b for _, b in pairs], N, B)
    words, score = nw_ops(jnp.asarray(c1), jnp.asarray(c2),
                          jnp.asarray(m), jnp.asarray(n))
    words = np.asarray(words)[:len(pairs)]
    score = np.asarray(score)[:len(pairs)]
    if return_ops:
        return words, score
    return [_replay_ops(s1, s2, words[k])
            for k, (s1, s2) in enumerate(pairs)], score
