"""Batched ksw2 gapped aligner — device (plain JAX/XLA).

Device form of the `-alg ksw2` aligner (ref: src/ksw2_alignment.cpp:70-248
ksw_extz2_sse; host oracle in ops/ksw2_host.py). The SSE kernel's
anti-diagonal difference DP is already elementwise within a diagonal, so
the batched device version sweeps diagonals with int8 state arrays
[TB, NC] (JAX int8 arithmetic wraps exactly like the 16-lane SSE code)
and per-lane [st, en] windows expressed as masks. The signed/unsigned
max/min mix of the original is reproduced with bitcasts.

The reversed query is RIGHT-ALIGNED into a width-M buffer on the host
(qbuf[M-qlen+k] = query[qlen-1-k]), which makes the per-diagonal score
lookup index M-1-r+t lane-independent — one shared-index gather per
diagonal instead of per-lane shifts.

Direction flags stream out per diagonal at absolute target columns; the
host backtrack mirrors ksw_backtrack (ksw2_alignment.cpp:25-68).
"""
from __future__ import annotations

import functools

from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_Q = 2
_E = 1
_QE = _Q + _E
_QE2 = 2 * _QE
_MAX_SC = 1 + _QE2
_WILD = 4


def _bounds(qlen: int, tlen: int, r: int) -> Tuple[int, int, int, int]:
    """Per-diagonal window (ref: ksw2_alignment.cpp:140-158).
    Returns (st0, en0, st, en): logical and 16-aligned bounds."""
    w = max(qlen, tlen)
    st, en = 0, tlen - 1
    st = max(st, r - qlen + 1, (r - w + 1) >> 1)
    en = min(en, r, (r + w) >> 1)
    st0, en0 = st, en
    return st0, en0, st // 16 * 16, (en + 16) // 16 * 16 - 1


@functools.lru_cache(maxsize=None)
def build_ksw2_kernel(M: int, N: int):
    """Returns jitted fn(qbuf uint8[B,M], target uint8[B,NC], qlen, tlen
    int32[B]) -> p uint8[B, M+N-1, NC] direction flags. NC = padded N."""
    NC = ((N + 15) // 16 + 1) * 16
    ND = M + N - 1

    def fn(qbuf, target, qlen, tlen):
        B = qbuf.shape[0]
        idx = jnp.arange(NC, dtype=jnp.int32)[None, :]
        ql = qlen[:, None].astype(jnp.int32)
        tl = tlen[:, None].astype(jnp.int32)
        wband = jnp.maximum(ql, tl)
        i8 = jnp.int8
        z0 = jnp.zeros((B, NC), dtype=i8)

        def body(carry, r):
            u, v, x, y, s8, last_st, last_en = carry
            # per-lane window (ref: cpp:140-158)
            st0 = jnp.maximum(jnp.maximum(0, r - ql + 1), (r - wband + 1) >> 1)
            en0 = jnp.minimum(jnp.minimum(tl - 1, r), (r + wband) >> 1)
            st = st0 // 16 * 16
            en = (en0 + 16) // 16 * 16 - 1
            # boundary x1/v1 (ref: cpp:159-165): value at column st-1 from
            # the previous diagonal, if it was inside [last_st, last_en]
            stm1 = st - 1
            sel = (idx == stm1)
            x_at = jnp.sum(jnp.where(sel, x, i8(0)), axis=1, keepdims=True,
                           dtype=jnp.int32).astype(i8)
            v_at = jnp.sum(jnp.where(sel, v, i8(0)), axis=1, keepdims=True,
                           dtype=jnp.int32).astype(i8)
            inside = (last_st <= stm1) & (stm1 <= last_en)
            x1 = jnp.where(st > 0, jnp.where(inside, x_at, i8(0)), i8(0))
            v1 = jnp.where(st > 0, jnp.where(inside, v_at, i8(0)),
                           jnp.where(r > 0, i8(_Q), i8(0)))
            # if en >= r: y[r] = 0; u[r] = r ? Q : 0  (ref: cpp:163-165)
            set_r = (en >= r) & (idx == r)
            y = jnp.where(set_r, i8(0), y)
            u = jnp.where(set_r, jnp.where(r > 0, i8(_Q), i8(0)), u)
            # score fission over st0-aligned 16-blocks (ref: cpp:167-176).
            # s8 persists across diagonals: cells in [st, st0) read STALE
            # values exactly like the C array, so it is scan state.
            qidx = jnp.clip(M - 1 - r + idx, 0, M - 1)[0]
            stq = jnp.take(qbuf, qidx, axis=1)       # [B, NC], shared idx
            blk_end = st0 + ((en0 - st0) // 16 + 1) * 16
            blk = (idx >= st0) & (idx < blk_end) & (st0 <= en0)
            wild = (target == _WILD) | (stq == _WILD)
            sval = jnp.where(target == stq, i8(1), i8(-1))
            s8 = jnp.where(blk, jnp.where(wild, i8(0), sval), s8)
            # core recurrence over [st, en] (ref: cpp:184-199)
            # xt1/vt1: previous-column values with x1/v1 injected at st
            xs = jnp.concatenate([jnp.zeros((B, 1), i8), x[:, :-1]], axis=1)
            vs = jnp.concatenate([jnp.zeros((B, 1), i8), v[:, :-1]], axis=1)
            xt1 = jnp.where(idx == st, x1, xs)
            vt1 = jnp.where(idx == st, v1, vs)
            z = (s8 + i8(_QE2)).astype(i8)
            a = (xt1 + vt1).astype(i8)
            b = (y + u).astype(i8)
            d = (a > z).astype(jnp.uint8)
            z = jnp.maximum(z, a)
            d = jnp.where(b > z, jnp.uint8(2), d)
            bc = jax.lax.bitcast_convert_type
            zu = jnp.maximum(bc(z, jnp.uint8), bc(b, jnp.uint8))
            zu = jnp.minimum(zu, jnp.uint8(_MAX_SC))
            z = bc(zu, i8)
            u_new = (z - vt1).astype(i8)
            v_new = (z - u).astype(i8)
            z = (z - i8(_Q)).astype(i8)
            a = (a - z).astype(i8)
            b = (b - z).astype(i8)
            apos = a > 0
            bpos = b > 0
            x_new = jnp.where(apos, a, i8(0))
            y_new = jnp.where(bpos, b, i8(0))
            d = d | jnp.where(apos, jnp.uint8(0x08), jnp.uint8(0))
            d = d | jnp.where(bpos, jnp.uint8(0x10), jnp.uint8(0))
            m = (idx >= st) & (idx <= en)
            u = jnp.where(m, u_new, u)
            v = jnp.where(m, v_new, v)
            x = jnp.where(m, x_new, x)
            y = jnp.where(m, y_new, y)
            p_row = jnp.where(m, d, jnp.uint8(0))
            return (u, v, x, y, s8, st, en), p_row

        init = (z0, z0, z0, z0, z0,
                jnp.full((B, 1), -1, jnp.int32), jnp.full((B, 1), -1, jnp.int32))
        _, p = jax.lax.scan(body, init, jnp.arange(ND, dtype=jnp.int32))
        return jnp.transpose(p, (1, 0, 2))      # [B, ND, NC]

    return jax.jit(fn)


def _backtrack_abs(p: np.ndarray, qlen: int, tlen: int) -> str:
    """ksw_backtrack over absolute-column flags (ref: cpp:25-68)."""
    i, j = tlen - 1, qlen - 1
    state = 0
    cigar = []
    while i >= 0 and j >= 0:
        r = i + j
        st0, en0, st, en = _bounds(qlen, tlen, r)
        force_state = -1
        if i < st:
            force_state = 2
        if i > en:
            force_state = 1
        tmp = int(p[r, i]) if force_state < 0 else 0
        if state == 0:
            state = tmp & 7
        elif not (tmp >> (state + 2)) & 1:
            state = 0
        if state == 0:
            state = tmp & 7
        if force_state >= 0:
            state = force_state
        if state == 0:
            cigar.append("M")
            i -= 1
            j -= 1
        elif state in (1, 3):
            cigar.append("D")
            i -= 1
        else:
            cigar.append("I")
            j -= 1
    if i >= 0:
        cigar.append("D" * (i + 1))
    if j >= 0:
        cigar.append("I" * (j + 1))
    return "".join(cigar)


@functools.lru_cache(maxsize=None)
def build_ksw2_traceback(M: int, N: int):
    """On-device ksw_backtrack (ref: cpp:25-68): walks the flag planes
    per lane and returns 2-bit ops (0=M,1=D,2=I,3=pad) packed 16/int32 —
    the [B, M+N-1, NC] flag tensor never leaves the device."""
    NC = ((N + 15) // 16 + 1) * 16
    ND = M + N - 1
    STEPS = ((M + N) + 15) // 16 * 16

    def tb(p, qlen, tlen):
        B = p.shape[0]
        flat = p.reshape(B, -1).astype(jnp.int32)
        w = jnp.maximum(qlen, tlen)

        def body(carry, _):
            i, j, state = carry
            in_main = (i >= 0) & (j >= 0)
            active = (i >= 0) | (j >= 0)
            r = i + j
            st = jnp.maximum(jnp.maximum(0, r - qlen + 1), (r - w + 1) >> 1)
            en = jnp.minimum(jnp.minimum(tlen - 1, r), (r + w) >> 1)
            st_a = st // 16 * 16
            en_a = (en + 16) // 16 * 16 - 1
            force = jnp.where(i < st_a, 2, jnp.where(i > en_a, 1, -1))
            idx = jnp.clip(r * NC + i, 0, ND * NC - 1)
            tmp = jnp.where(force < 0,
                            jnp.take_along_axis(flat, idx[:, None],
                                                axis=1)[:, 0], 0)
            s = jnp.where(state == 0, tmp & 7,
                          jnp.where(((tmp >> (state + 2)) & 1) == 0, 0,
                                    state))
            s = jnp.where(s == 0, tmp & 7, s)
            s = jnp.where(force >= 0, force, s)
            # outside the main rectangle: drain remaining D's / I's
            s = jnp.where(in_main, s, jnp.where(i >= 0, 1, 2))
            op = jnp.where(~active, 3,
                           jnp.where(s == 0, 0,
                                     jnp.where((s == 1) | (s == 3), 1, 2)))
            ni = jnp.where(active & ((op == 0) | (op == 1)), i - 1, i)
            nj = jnp.where(active & ((op == 0) | (op == 2)), j - 1, j)
            ns = jnp.where(in_main, s, state)
            return (ni, nj, ns), op

        init = (tlen - 1, qlen - 1, jnp.zeros_like(qlen))
        _, ops = jax.lax.scan(body, init, None, length=STEPS)
        ops = ops.T.astype(jnp.uint32)
        ops_p = ops.reshape(B, STEPS // 16, 16)
        sh = (jnp.arange(16, dtype=jnp.uint32) * 2)[None, None, :]
        return (ops_p << sh).sum(axis=2, dtype=jnp.uint32)

    return jax.jit(tb)


def ksw2_align_batch(pairs: List[Tuple[str, str]], M: int = 192,
                     N: int = 192, return_ops: bool = False):
    """Align (s1=query, s2=target) pairs on device; '-'-padded strings
    bit-identical to ops/ksw2_host.ksw2_alignment. DP fill AND backtrack
    run on device; only packed 2-bit ops come back."""
    from .nw_device import _encode_side, padded_batch
    NC = ((N + 15) // 16 + 1) * 16
    for s1, s2 in pairs:
        if not (0 < len(s1) <= M and 0 < len(s2) <= N):
            raise ValueError(f"pair ({len(s1)}, {len(s2)}) outside "
                             f"the {M}x{N} kernel")
    # padding lanes align "A" to "A" (code 0); their ops are dropped
    B = padded_batch(len(pairs))
    qbuf, ql = _encode_side([a for a, _ in pairs], M, B, reverse=True, pad=0)
    tgt, tl = _encode_side([b for _, b in pairs], NC, B, pad=0)
    ql[len(pairs):] = 1
    tl[len(pairs):] = 1
    kern = build_ksw2_kernel(M, N)
    p = kern(jnp.asarray(qbuf), jnp.asarray(tgt),
             jnp.asarray(ql), jnp.asarray(tl))
    words = np.asarray(build_ksw2_traceback(M, N)(
        p, jnp.asarray(ql), jnp.asarray(tl)))[:len(pairs)]
    if return_ops:
        return words
    out = []
    for k, (s1, s2) in enumerate(pairs):
        i, j = len(s2) - 1, len(s1) - 1
        cigar = []
        kk = 0
        while i >= 0 or j >= 0:
            d = (int(words[k, kk >> 4]) >> ((kk & 15) * 2)) & 3
            cigar.append("MDI"[d])
            if d == 0:
                i -= 1
                j -= 1
            elif d == 1:
                i -= 1
            else:
                j -= 1
            kk += 1
        a1 = list(s1)
        a2 = list(s2)
        pos = 0
        for ch in reversed(cigar):
            if ch == "D":
                a1.insert(pos, "-")
            elif ch == "I":
                a2.insert(pos, "-")
            pos += 1
        out.append(("".join(a1), "".join(a2)))
    return out
