"""Batched VP8 transforms in JAX — exact int32 arithmetic.

All functions operate on arbitrarily-batched blocks (..., 4, 4) or
(..., 16) and are jit/vmap/shard_map compatible (static shapes, no
data-dependent control flow).  The butterflies are adds and small
constant multiplies — pure elementwise work that XLA vectorizes over
the batch; the batch dimension is where device parallelism comes from.

Golden-tested against gowebp_tpu/models/vp8/dsp_np.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..models.vp8.tables import ZIGZAG

# NumPy (not jnp!) constants: they embed as HLO literals.  A module-
# level jnp.array becomes a hoisted jit const — an extra executable
# parameter uploaded on every launch.
import numpy as _np

_ZIGZAG = _np.array(ZIGZAG, _np.int32)
_INV_ZIGZAG = _np.array([ZIGZAG.index(i) for i in range(16)], _np.int32)

# Permutations as one-hot f32 matmuls: (..., 16) @ (16, 16) select
# matrices.  Each output sums exactly one nonzero product, so the select
# is exact for |values| < 2^24 (true of all VP8 coefficients, which stay
# below 2^20) at Precision.HIGHEST.  The default precision may round
# operands to TF32 (or bf16), exact only below 2^11 (2^8), which
# corrupts dequantized coefficients.
_ZZ_SEL = _np.zeros((16, 16), _np.float32)
_ZZ_SEL[_ZIGZAG, _np.arange(16)] = 1.0             # out[i] = in[ZIGZAG[i]]
_INV_SEL = _ZZ_SEL.T                               # out[i] = in[INVZZ[i]]


def zigzag_fwd(flat: jnp.ndarray) -> jnp.ndarray:
    """(..., 16) raster → zigzag order (exact one-hot select)."""
    return jnp.matmul(flat.astype(jnp.float32), _ZZ_SEL,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST
                      ).astype(flat.dtype)


def zigzag_inv(zz: jnp.ndarray) -> jnp.ndarray:
    """(..., 16) zigzag → raster order (exact one-hot select)."""
    return jnp.matmul(zz.astype(jnp.float32), _INV_SEL,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST
                      ).astype(zz.dtype)


def _mul1(a):
    return a + ((a * 20091) >> 16)


def _mul2(a):
    return (a * 35468) >> 16


def idct4x4(coeffs: jnp.ndarray) -> jnp.ndarray:
    """(..., 4, 4) int32 coeffs → (..., 4, 4) int32 residual (pre-clip).

    Output is the (v >> 3) residual to be added to the prediction then
    clipped to [0, 255].
    """
    c = coeffs.astype(jnp.int32)
    # Vertical pass over columns: rows are c[..., r, :].
    a = c[..., 0, :] + c[..., 2, :]
    b = c[..., 0, :] - c[..., 2, :]
    cc = _mul2(c[..., 1, :]) - _mul1(c[..., 3, :])
    d = _mul1(c[..., 1, :]) + _mul2(c[..., 3, :])
    tmp = jnp.stack([a + d, b + cc, b - cc, a - d], axis=-2)  # (..., 4row, 4col)
    # Horizontal pass over rows.
    t0 = tmp[..., :, 0] + 4
    t1 = tmp[..., :, 1]
    t2 = tmp[..., :, 2]
    t3 = tmp[..., :, 3]
    a = t0 + t2
    b = t0 - t2
    cc = _mul2(t1) - _mul1(t3)
    d = _mul1(t1) + _mul2(t3)
    out = jnp.stack([a + d, b + cc, b - cc, a - d], axis=-1)
    return out >> 3


def idct_add_clip(coeffs: jnp.ndarray, pred: jnp.ndarray) -> jnp.ndarray:
    """pred (..., 4, 4) uint8-valued + iDCT(coeffs), clipped to [0,255]."""
    return jnp.clip(pred.astype(jnp.int32) + idct4x4(coeffs), 0, 255)


def fdct4x4(block: jnp.ndarray) -> jnp.ndarray:
    """(..., 4, 4) int32 residual → (..., 4, 4) int32 coefficients."""
    d = block.astype(jnp.int32)
    d0, d1, d2, d3 = d[..., :, 0], d[..., :, 1], d[..., :, 2], d[..., :, 3]
    a0 = d0 + d3
    a1 = d1 + d2
    a2 = d1 - d2
    a3 = d0 - d3
    t0 = (a0 + a1) * 8
    t1 = (a2 * 2217 + a3 * 5352 + 1812) >> 9
    t2 = (a0 - a1) * 8
    t3 = (a3 * 2217 - a2 * 5352 + 937) >> 9
    # Rows of tmp (pass 1 wrote per input row i → tmp[i, :]).
    tmp = jnp.stack([t0, t1, t2, t3], axis=-1)  # (..., row, col)
    p0, p1, p2, p3 = tmp[..., 0, :], tmp[..., 1, :], tmp[..., 2, :], tmp[..., 3, :]
    a0 = p0 + p3
    a1 = p1 + p2
    a2 = p1 - p2
    a3 = p0 - p3
    o0 = (a0 + a1 + 7) >> 4
    o1 = ((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a3 != 0).astype(jnp.int32)
    o2 = (a0 - a1 + 7) >> 4
    o3 = (a3 * 2217 - a2 * 5352 + 51000) >> 16
    return jnp.stack([o0, o1, o2, o3], axis=-2)


def fwht4x4(dcs: jnp.ndarray) -> jnp.ndarray:
    """(..., 4, 4) int32 per-block DCs → (..., 4, 4) WHT coefficients."""
    c = dcs.astype(jnp.int32)
    a0 = c[..., :, 0] + c[..., :, 3]
    a1 = c[..., :, 1] + c[..., :, 2]
    a2 = c[..., :, 1] - c[..., :, 2]
    a3 = c[..., :, 0] - c[..., :, 3]
    tmp = jnp.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], axis=-1)
    a0 = tmp[..., 0, :] + tmp[..., 3, :]
    a1 = tmp[..., 1, :] + tmp[..., 2, :]
    a2 = tmp[..., 1, :] - tmp[..., 2, :]
    a3 = tmp[..., 0, :] - tmp[..., 3, :]
    return jnp.stack(
        [(a0 + a1) >> 1, (a3 + a2) >> 1, (a0 - a1) >> 1, (a3 - a2) >> 1],
        axis=-2,
    )


def iwht4x4(coeffs: jnp.ndarray) -> jnp.ndarray:
    """(..., 4, 4) int32 Y2 coeffs → (..., 4, 4) per-block DC values."""
    c = coeffs.astype(jnp.int32)
    a0 = c[..., 0, :] + c[..., 3, :]
    a1 = c[..., 1, :] + c[..., 2, :]
    a2 = c[..., 1, :] - c[..., 2, :]
    a3 = c[..., 0, :] - c[..., 3, :]
    tmp = jnp.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], axis=-2)
    dc = tmp[..., :, 0] + 3
    a0 = dc + tmp[..., :, 3]
    a1 = tmp[..., :, 1] + tmp[..., :, 2]
    a2 = tmp[..., :, 1] - tmp[..., :, 2]
    a3 = dc - tmp[..., :, 3]
    return jnp.stack(
        [(a0 + a1) >> 3, (a3 + a2) >> 3, (a0 - a1) >> 3, (a3 - a2) >> 3],
        axis=-1,
    )


def quantize(coeffs: jnp.ndarray, dc_iq, dc_bias, ac_iq, ac_bias,
             first_ac: bool = False) -> jnp.ndarray:
    """(..., 4, 4) raster coeffs → (..., 16) zigzag levels (QUANTDIV)."""
    flat = coeffs.reshape(coeffs.shape[:-2] + (16,))
    zz = zigzag_fwd(flat)
    iq = jnp.full((16,), ac_iq, jnp.int32).at[0].set(dc_iq)
    bias = jnp.full((16,), ac_bias, jnp.int32).at[0].set(dc_bias)
    sign = zz < 0
    av = jnp.abs(zz)
    level = jnp.minimum((av * iq + bias) >> 17, 2047)
    if first_ac:
        level = level.at[..., 0].set(0)
    return jnp.where(sign, -level, level)


def dequantize(levels: jnp.ndarray, dc_q, ac_q) -> jnp.ndarray:
    """(..., 16) zigzag levels → (..., 4, 4) raster coefficients."""
    q = jnp.full((16,), ac_q, jnp.int32).at[0].set(dc_q)
    deq = levels.astype(jnp.int32) * q
    raster = zigzag_inv(deq)
    return raster.reshape(levels.shape[:-1] + (4, 4))


__all__ = [
    "idct4x4",
    "idct_add_clip",
    "fdct4x4",
    "fwht4x4",
    "iwht4x4",
    "quantize",
    "dequantize",
]
