"""Exact VP8 token-grammar rate model in JAX (1/256-bit units).

Vectorized twin of the native `block_rate256` (entropy/native/
vp8_dec.cpp:1620-1643): the cost of coding one quantized block's zigzag
levels under fixed probability tables — EOB/continue bits, zero-run
bits, value tokens (sign as a flat bit).  Used by the device dense
encoders for the rate-aware i4-vs-i16 decision so their output is
bit-identical to the host encoder's.

The sequential grammar walk is re-expressed positionally: position n is
a "decision point" iff n == first or level[n-1] != 0; its context is
ctx0 at `first`, else 0 after a zero-run step, else 1/2 by the
magnitude of the preceding value.  All 16 positions are charged in
parallel and masked by n <= last_nonzero, with the end-of-block bit
gathered at last_nonzero + 1.

Feature parity target: libwebp's VP8GetCostLuma16/GetResidualCost
(reference: /root/reference/pkg/libwebp/dsp/cost.go:18-51), rebuilt as
a tensor program.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..models.vp8.tables import BANDS

I32 = jnp.int32

# NumPy constant (embeds as an HLO literal; a jnp constant would be a
# hoisted jit const uploaded on every launch).
import numpy as _np

_BANDS16 = _np.array(BANDS[:16], _np.int32)           # band of position n


def block_rate256(lv, tables, *, type: int, first: int, ctx0: int):
    """Token rate of zigzag levels (..., 16) in 1/256 bits → (...) int32.

    tables: (p0, p1, val) jnp arrays of shape (4,8,3,2), (4,8,3,2),
    (4,8,3,68).  type/first/ctx0 are static.
    """
    p0_t, p1_t, val_t = tables
    # Static per-position band reorder: tables indexed by position.
    band = _BANDS16
    p0_n = p0_t[type][band]                           # (16, 3, 2)
    p1_n = p1_t[type][band]
    val_n = val_t[type][band]                         # (16, 3, 68)

    lv = lv.astype(I32)
    nz = lv != 0
    v = jnp.minimum(jnp.abs(lv), 67)

    idx = jnp.arange(16, dtype=I32)
    pos_ok = idx >= first
    nz_eff = nz & pos_ok
    has = nz_eff.any(axis=-1)
    last = jnp.max(jnp.where(nz_eff, idx, -1), axis=-1)  # (-1 if empty)

    prev_nz = jnp.concatenate(
        [jnp.zeros_like(nz[..., :1]), nz_eff[..., :-1]], axis=-1)
    prev_v = jnp.concatenate(
        [jnp.zeros_like(v[..., :1]), v[..., :-1]], axis=-1)
    is_first = idx == first
    decision = is_first | prev_nz
    ctx = jnp.where(
        is_first, ctx0,
        jnp.where(prev_nz, jnp.where(prev_v == 1, 1, 2), 0),
    ).astype(I32)                                      # (..., 16)

    # Per-position charges under each position's own context.  ctx has
    # only 3 values, so table picks are selects (no gather).
    def by_ctx(tbl):                                   # tbl (16, 3)
        return jnp.where(
            ctx == 0, tbl[:, 0], jnp.where(ctx == 1, tbl[:, 1], tbl[:, 2])
        )

    p0_1 = by_ctx(p0_n[:, :, 1])
    p0_0 = by_ctx(p0_n[:, :, 0])
    p1_0 = by_ctx(p1_n[:, :, 0])
    p1_1 = by_ctx(p1_n[:, :, 1])
    # Value-token cost lookup as a fused one-hot reduce, not a gather:
    # the (v == k) * table broadcast-compare fuses into one elementwise
    # reduction loop.  The ctx select rides INSIDE the
    # single reduce (2 selects per lane-element) instead of running the
    # 68-wide reduce three times — this reduce is the i4 search's
    # biggest elementwise term (~10 candidates x 16 positions x 68 bins per MB).
    karr = _np.arange(68, dtype=_np.int32)
    onehot = (v[..., None] == karr)
    c0 = (ctx == 0)[..., None]
    c1 = (ctx == 1)[..., None]
    val_sel = jnp.where(c0, val_n[:, 0],
                        jnp.where(c1, val_n[:, 1], val_n[:, 2]))
    vcost = (onehot * val_sel).sum(-1)

    active = pos_ok & (idx <= last[..., None])
    charge = jnp.where(decision, p0_1, 0) + jnp.where(
        nz, p1_1 + vcost + 256, p1_0
    )
    r = jnp.sum(jnp.where(active, charge, 0).astype(I32), axis=-1)

    # End-of-block: p0(...,0) at position last+1 (skipped when last==15),
    # or at `first` with ctx0 for an empty block.
    eob_pos = jnp.clip(jnp.where(has, last + 1, first), first, 15)
    eob = (p0_0.astype(I32) * (idx == eob_pos[..., None])).sum(-1)
    eob = jnp.where(has & (last == 15), 0, eob)
    return r + eob


__all__ = ["block_rate256"]
