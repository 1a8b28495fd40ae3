"""YUV420 ↔ RGB conversion and the fancy (bilinear) chroma upsampler.

Exact integer NumPy reference, matching libwebp's BT.601 fixed-point math
(constants confirmed against /root/reference/pkg/color/yuv/conversion.go
and dsp/upsampling.c.go).  JAX versions live in ops/yuv_jax.py.
"""

from __future__ import annotations

import numpy as np

YUV_FIX = 16
YUV_HALF = 1 << (YUV_FIX - 1)
YUV_FIX2 = 6
YUV_MASK2 = (256 << YUV_FIX2) - 1


def _mult_hi(v, coeff):
    return (v * coeff) >> 8


def _clip8(v):
    # (v >> 6) when v in [0, 256<<6), else saturate.
    return np.clip(v, 0, YUV_MASK2) >> YUV_FIX2


def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Full-resolution Y/U/V planes (int arrays) → (H, W, 3) uint8 RGB."""
    y = y.astype(np.int32)
    u = u.astype(np.int32)
    v = v.astype(np.int32)
    yy = _mult_hi(y, 19077)
    out = np.empty(y.shape + (3,), np.uint8)
    out[..., 0] = _clip8(yy + _mult_hi(v, 26149) - 14234)
    out[..., 1] = _clip8(yy - _mult_hi(u, 6419) - _mult_hi(v, 13320) + 8708)
    out[..., 2] = _clip8(yy + _mult_hi(u, 33050) - 17685)
    return out


def rgb_to_y(r, g, b, rounding: int = YUV_HALF):
    return (16839 * r + 33059 * g + 6420 * b + rounding + (16 << YUV_FIX)) >> YUV_FIX


def _clip_uv(uv, rounding):
    uv = (uv + rounding + (128 << (YUV_FIX + 2))) >> (YUV_FIX + 2)
    return np.clip(uv, 0, 255)


def rgb_to_u(r, g, b, rounding: int = YUV_HALF << 2):
    return _clip_uv(-9719 * r - 19081 * g + 28800 * b, rounding)


def rgb_to_v(r, g, b, rounding: int = YUV_HALF << 2):
    return _clip_uv(28800 * r - 24116 * g - 4684 * b, rounding)


# ---------------------------------------------------------------------------
# Fancy upsampling (2x bilinear at half-sample offsets, exact shift order)
# ---------------------------------------------------------------------------


def _upsample_pair(T: np.ndarray, B: np.ndarray, width: int) -> tuple[np.ndarray, np.ndarray]:
    """One chroma row pair (T=row k, B=row k+1, both (W2,)) → two output rows.

    Replicates libwebp's UPSAMPLE_FUNC arithmetic including its double
    truncation: diag = (tl+t+l+c+8 + 2*(...)) >> 3 then (diag + near) >> 1.
    """
    T = T.astype(np.int64)
    B = B.astype(np.int64)
    w2 = len(T)
    top = np.empty(width, np.int64)
    bot = np.empty(width, np.int64)
    top[0] = (3 * T[0] + B[0] + 2) >> 2
    bot[0] = (3 * B[0] + T[0] + 2) >> 2
    if w2 > 1:
        tl = T[:-1]
        t = T[1:]
        l = B[:-1]
        c = B[1:]
        avg = tl + t + l + c + 8
        diag_12 = (avg + 2 * (t + l)) >> 3
        diag_03 = (avg + 2 * (tl + c)) >> 3
        odd_top = (diag_12 + tl) >> 1      # output x = 2i-1, i=1..w2-1
        even_top = (diag_03 + t) >> 1      # output x = 2i
        odd_bot = (diag_03 + l) >> 1
        even_bot = (diag_12 + c) >> 1
        # Odd outputs x=1..2(w2-1)-1, even outputs x=2..2(w2-1); with
        # width in {2*w2-1, 2*w2} these all fit exactly.
        n = w2 - 1
        top[1 : 2 * n : 2] = odd_top
        top[2 : 2 * n + 2 : 2] = even_top
        bot[1 : 2 * n : 2] = odd_bot
        bot[2 : 2 * n + 2 : 2] = even_bot
    if width % 2 == 0 and width > 1:
        top[width - 1] = (3 * T[w2 - 1] + B[w2 - 1] + 2) >> 2
        bot[width - 1] = (3 * B[w2 - 1] + T[w2 - 1] + 2) >> 2
    return top, bot


def fancy_upsample(chroma: np.ndarray, height: int, width: int) -> np.ndarray:
    """(H2, W2) chroma plane → (height, width) full-res plane (uint8).

    Fully vectorized: all row pairs are computed at once.
    """
    h2, w2 = chroma.shape
    out = np.empty((height, width), np.int32)
    ch = chroma.astype(np.int32)
    # Row 0: self-pair of chroma row 0 (pure horizontal interpolation).
    out[0], _ = _upsample_pair(chroma[0], chroma[0], width)
    if h2 > 1:
        T = ch[:-1]   # (h2-1, w2)
        B = ch[1:]
        top_rows = out[1 : 2 * h2 - 2 : 2]   # rows 2k+1, k=0..h2-2
        # Column 0.
        top_rows[:, 0] = (3 * T[:, 0] + B[:, 0] + 2) >> 2
        # Interior.
        if w2 > 1:
            tl = T[:, :-1]
            t = T[:, 1:]
            l = B[:, :-1]
            c = B[:, 1:]
            avg = tl + t + l + c + 8
            diag_12 = (avg + 2 * (t + l)) >> 3
            diag_03 = (avg + 2 * (tl + c)) >> 3
            n = w2 - 1
            top_rows[:, 1 : 2 * n : 2] = (diag_12 + tl) >> 1
            top_rows[:, 2 : 2 * n + 2 : 2] = (diag_03 + t) >> 1
        if width % 2 == 0 and width > 1:
            top_rows[:, width - 1] = (3 * T[:, w2 - 1] + B[:, w2 - 1] + 2) >> 2
        # Bottom rows of each pair (2k+2): may exclude the final row when
        # height is odd... 2k+2 <= 2*h2-2 <= height ✓ always in range for
        # height in {2*h2-1, 2*h2}.
        bot = out[2 : 2 * h2 - 1 : 2]
        bot[:, 0] = (3 * B[:, 0] + T[:, 0] + 2) >> 2
        if w2 > 1:
            bot[:, 1 : 2 * n : 2] = (diag_03 + l) >> 1
            bot[:, 2 : 2 * n + 2 : 2] = (diag_12 + c) >> 1
        if width % 2 == 0 and width > 1:
            bot[:, width - 1] = (3 * B[:, w2 - 1] + T[:, w2 - 1] + 2) >> 2
    if height % 2 == 0 and height > 1:
        last, _ = _upsample_pair(chroma[h2 - 1], chroma[h2 - 1], width)
        out[height - 1] = last
    return out.astype(np.uint8)


def simple_upsample(chroma: np.ndarray, height: int, width: int) -> np.ndarray:
    """Nearest-neighbor (non-fancy) chroma upsampling."""
    return np.repeat(np.repeat(chroma, 2, axis=0), 2, axis=1)[:height, :width]


__all__ = [
    "yuv_to_rgb",
    "rgb_to_y",
    "rgb_to_u",
    "rgb_to_v",
    "fancy_upsample",
    "simple_upsample",
    "YUV_FIX",
    "YUV_HALF",
]
