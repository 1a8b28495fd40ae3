"""Batched YUV↔RGB + fancy upsampling in JAX (device post-processing).

Batch decode pipeline: host entropy/reconstruction → stacked YUV planes
→ device chroma upsample + color conversion for the whole batch at once.
Exact integer math, golden-tested against ops/yuv_np.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _mult_hi(v, coeff):
    return (v * coeff) >> 8

YUV_MASK2 = (256 << 6) - 1


def yuv_to_rgb(y: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """(..., H, W) int planes → (..., H, W, 3) uint8 RGB."""
    y = y.astype(jnp.int32)
    u = u.astype(jnp.int32)
    v = v.astype(jnp.int32)
    yy = _mult_hi(y, 19077)

    def clip8(x):
        return (jnp.clip(x, 0, YUV_MASK2) >> 6).astype(jnp.uint8)

    r = clip8(yy + _mult_hi(v, 26149) - 14234)
    g = clip8(yy - _mult_hi(u, 6419) - _mult_hi(v, 13320) + 8708)
    b = clip8(yy + _mult_hi(u, 33050) - 17685)
    return jnp.stack([r, g, b], axis=-1)


def rgb_to_yuv420(rgb: jnp.ndarray):
    """(..., H, W, 3) uint8 → (Y, U, V) int32 planes (H even, W even)."""
    r = rgb[..., 0].astype(jnp.int32)
    g = rgb[..., 1].astype(jnp.int32)
    b = rgb[..., 2].astype(jnp.int32)
    YUV_FIX = 16
    HALF = 1 << (YUV_FIX - 1)
    y = (16839 * r + 33059 * g + 6420 * b + HALF + (16 << YUV_FIX)) >> YUV_FIX

    def down(p):
        return (p[..., 0::2, 0::2] + p[..., 0::2, 1::2]
                + p[..., 1::2, 0::2] + p[..., 1::2, 1::2])

    rs, gs, bs = down(r), down(g), down(b)

    def clip_uv(uv):
        uv = (uv + (HALF << 2) + (128 << (YUV_FIX + 2))) >> (YUV_FIX + 2)
        return jnp.clip(uv, 0, 255)

    u = clip_uv(-9719 * rs - 19081 * gs + 28800 * bs)
    v = clip_uv(28800 * rs - 24116 * gs - 4684 * bs)
    return y, u, v


def fancy_upsample(chroma: jnp.ndarray, height: int, width: int) -> jnp.ndarray:
    """(..., H2, W2) chroma → (..., height, width) uint8, libwebp-exact."""
    ch = chroma.astype(jnp.int32)
    h2, w2 = ch.shape[-2:]

    def pair_rows(T, B):
        """Full-width interpolation between chroma rows T, B (..., w2)."""
        top = jnp.zeros(T.shape[:-1] + (width,), jnp.int32)
        bot = jnp.zeros_like(top)
        top = top.at[..., 0].set((3 * T[..., 0] + B[..., 0] + 2) >> 2)
        bot = bot.at[..., 0].set((3 * B[..., 0] + T[..., 0] + 2) >> 2)
        if w2 > 1:
            tl = T[..., :-1]
            t = T[..., 1:]
            l = B[..., :-1]
            c = B[..., 1:]
            avg = tl + t + l + c + 8
            d12 = (avg + 2 * (t + l)) >> 3
            d03 = (avg + 2 * (tl + c)) >> 3
            n = w2 - 1
            top = top.at[..., 1 : 2 * n : 2].set((d12 + tl) >> 1)
            top = top.at[..., 2 : 2 * n + 2 : 2].set((d03 + t) >> 1)
            bot = bot.at[..., 1 : 2 * n : 2].set((d03 + l) >> 1)
            bot = bot.at[..., 2 : 2 * n + 2 : 2].set((d12 + c) >> 1)
        if width % 2 == 0 and width > 1:
            top = top.at[..., width - 1].set(
                (3 * T[..., w2 - 1] + B[..., w2 - 1] + 2) >> 2
            )
            bot = bot.at[..., width - 1].set(
                (3 * B[..., w2 - 1] + T[..., w2 - 1] + 2) >> 2
            )
        return top, bot

    out = jnp.zeros(ch.shape[:-2] + (height, width), jnp.int32)
    row0, _ = pair_rows(ch[..., 0, :], ch[..., 0, :])
    out = out.at[..., 0, :].set(row0)
    if h2 > 1:
        T = ch[..., :-1, :]
        B = ch[..., 1:, :]
        tops, bots = pair_rows(T, B)          # (..., h2-1, width)
        out = out.at[..., 1 : 2 * h2 - 2 : 2, :].set(tops)
        out = out.at[..., 2 : 2 * h2 - 1 : 2, :].set(bots)
    if height % 2 == 0 and height > 1:
        last, _ = pair_rows(ch[..., h2 - 1, :], ch[..., h2 - 1, :])
        out = out.at[..., height - 1, :].set(last)
    return out.astype(jnp.uint8)


@jax.jit
def batch_yuv_to_rgba(y: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray):
    """(B, H, W) + (B, H2, W2) chroma → (B, H, W, 4) uint8 RGBA."""
    B, H, W = y.shape
    uf = fancy_upsample(u, H, W)
    vf = fancy_upsample(v, H, W)
    rgb = yuv_to_rgb(y, uf.astype(jnp.int32), vf.astype(jnp.int32))
    alpha = jnp.full((B, H, W, 1), 255, jnp.uint8)
    return jnp.concatenate([rgb, alpha], axis=-1)


__all__ = ["yuv_to_rgb", "rgb_to_yuv420", "fancy_upsample", "batch_yuv_to_rgba"]
