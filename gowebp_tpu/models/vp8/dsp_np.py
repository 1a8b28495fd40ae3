"""VP8 pixel kernels — exact integer NumPy reference implementations.

iDCT/WHT (RFC 6386 §14.3-14.4), intra predictors (§12.2-12.3), and the
in-loop deblocking filters (§15).  These are the golden references for the
JAX kernels in gowebp_tpu/ops/.

Feature parity target: /root/reference/pkg/libwebp/dsp/dec.c.go (kernels
behind the VP8Transform/VP8PredLuma*/VP8*Filter* dispatch tables).
"""

from __future__ import annotations

import numpy as np


def _mul1(a):
    return a + ((a * 20091) >> 16)


def _mul2(a):
    return (a * 35468) >> 16


def clip8(v):
    return np.clip(v, 0, 255)


# ---------------------------------------------------------------------------
# Transforms
# ---------------------------------------------------------------------------

def idct4x4_add(coeffs: np.ndarray, dst: np.ndarray) -> None:
    """dst (4,4 uint8-valued int array) += iDCT(coeffs (16,) int), clipped."""
    c = coeffs.astype(np.int64).reshape(4, 4)
    # Vertical pass (operate on columns).
    a = c[0] + c[2]
    b = c[0] - c[2]
    cc = _mul2(c[1]) - _mul1(c[3])
    d = _mul1(c[1]) + _mul2(c[3])
    tmp = np.stack([a + d, b + cc, b - cc, a - d])  # (4 rows, 4 cols)
    # Horizontal pass.
    t = tmp.T  # rows of tmp-transposed are the columns
    dc = t[0] + 4
    a = dc + t[2]
    b = dc - t[2]
    cc = _mul2(t[1]) - _mul1(t[3])
    d = _mul1(t[1]) + _mul2(t[3])
    out = np.stack([a + d, b + cc, b - cc, a - d]).T
    dst[:] = clip8(dst.astype(np.int64) + (out >> 3))


def idct_dc_add(dc: int, dst: np.ndarray) -> None:
    v = (int(dc) + 4) >> 3
    dst[:] = clip8(dst.astype(np.int64) + v)


def iwht4x4(coeffs: np.ndarray) -> np.ndarray:
    """Inverse Walsh-Hadamard for the Y2 DC block → 16 DC values."""
    c = coeffs.astype(np.int64).reshape(4, 4)
    a0 = c[0] + c[3]
    a1 = c[1] + c[2]
    a2 = c[1] - c[2]
    a3 = c[0] - c[3]
    tmp = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2])
    t = tmp.T
    dc = t[0] + 3
    a0 = dc + t[3]
    a1 = t[1] + t[2]
    a2 = t[1] - t[2]
    a3 = dc - t[3]
    out = np.stack([(a0 + a1) >> 3, (a3 + a2) >> 3, (a0 - a1) >> 3, (a3 - a2) >> 3]).T
    return out.reshape(16)


def fdct4x4(block: np.ndarray) -> np.ndarray:
    """Forward DCT (encoder), exact libwebp integer version.

    block: (4,4) int residual (src - pred, range [-255,255]) → (16,) int16
    in raster order (not zigzagged).
    """
    b = block.astype(np.int64)
    tmp = np.zeros((4, 4), np.int64)
    for i in range(4):
        d0, d1, d2, d3 = b[i]
        a0 = d0 + d3
        a1 = d1 + d2
        a2 = d1 - d2
        a3 = d0 - d3
        tmp[i, 0] = (a0 + a1) * 8
        tmp[i, 1] = (a2 * 2217 + a3 * 5352 + 1812) >> 9
        tmp[i, 2] = (a0 - a1) * 8
        tmp[i, 3] = (a3 * 2217 - a2 * 5352 + 937) >> 9
    out = np.zeros((4, 4), np.int64)
    for i in range(4):
        a0 = tmp[0, i] + tmp[3, i]
        a1 = tmp[1, i] + tmp[2, i]
        a2 = tmp[1, i] - tmp[2, i]
        a3 = tmp[0, i] - tmp[3, i]
        out[0, i] = (a0 + a1 + 7) >> 4
        out[1, i] = ((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (1 if a3 != 0 else 0)
        out[2, i] = (a0 - a1 + 7) >> 4
        out[3, i] = (a3 * 2217 - a2 * 5352 + 51000) >> 16
    return out.reshape(16).astype(np.int16)


def fwht4x4(dc_coeffs: np.ndarray) -> np.ndarray:
    """Forward WHT over the 16 per-block DC values (encoder side).

    dc_coeffs: (16,) DCs in block raster order (one per 4x4 luma block).
    """
    c = dc_coeffs.astype(np.int64).reshape(4, 4)
    tmp = np.zeros((4, 4), np.int64)
    # Self-inverse butterfly (the exact inverse pair of iwht4x4 up to >>4).
    for i in range(4):  # horizontal (within each block-row)
        a0 = c[i, 0] + c[i, 3]
        a1 = c[i, 1] + c[i, 2]
        a2 = c[i, 1] - c[i, 2]
        a3 = c[i, 0] - c[i, 3]
        tmp[i, 0] = a0 + a1
        tmp[i, 1] = a3 + a2
        tmp[i, 2] = a0 - a1
        tmp[i, 3] = a3 - a2
    out = np.zeros((4, 4), np.int64)
    for i in range(4):  # vertical
        a0 = tmp[0, i] + tmp[3, i]
        a1 = tmp[1, i] + tmp[2, i]
        a2 = tmp[1, i] - tmp[2, i]
        a3 = tmp[0, i] - tmp[3, i]
        out[0, i] = (a0 + a1) >> 1
        out[1, i] = (a3 + a2) >> 1
        out[2, i] = (a0 - a1) >> 1
        out[3, i] = (a3 - a2) >> 1
    return out.reshape(16).astype(np.int16)


# ---------------------------------------------------------------------------
# Intra predictors.  `buf` is the MB working array with 1 border row/col:
# buf[0,0]=top-left, buf[0,1:]=top (+top-right), buf[1:,0]=left.
# Block views are buf[1+y : 1+y+n, 1+x : 1+x+n].
# ---------------------------------------------------------------------------

def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def pred_dc(top: np.ndarray, left: np.ndarray, size: int) -> int:
    total = int(top.sum()) + int(left.sum())
    shift = 5 if size == 16 else 4
    return (total + size) >> shift


def pred_dc_no_top(left: np.ndarray, size: int) -> int:
    shift = 4 if size == 16 else 3
    return (int(left.sum()) + size // 2) >> shift


def pred_dc_no_topleft() -> int:
    return 0x80


def pred_tm(top: np.ndarray, left: np.ndarray, tl: int, size: int) -> np.ndarray:
    p = left.astype(np.int64)[:, None] + top.astype(np.int64)[None, :] - int(tl)
    return clip8(p)


def predict_block(buf: np.ndarray, x: int, y: int, size: int, mode: int,
                  have_top: bool, have_left: bool) -> None:
    """Apply a DC/TM/VE/HE prediction (modes 0-3) with edge fallbacks."""
    top = buf[y, x + 1 : x + 1 + size]
    left = buf[y + 1 : y + 1 + size, x]
    tl = int(buf[y, x])
    blk = buf[y + 1 : y + 1 + size, x + 1 : x + 1 + size]
    if mode == 0:  # DC with edge variants
        if have_top and have_left:
            blk[:] = pred_dc(top, left, size)
        elif have_left:
            blk[:] = pred_dc_no_top(left, size)
        elif have_top:
            blk[:] = pred_dc_no_top(top, size)
        else:
            blk[:] = pred_dc_no_topleft()
    elif mode == 1:  # TrueMotion
        blk[:] = pred_tm(top, left, tl, size)
    elif mode == 2:  # VE
        blk[:] = top[None, :]
    elif mode == 3:  # HE
        blk[:] = left[:, None]
    else:
        raise ValueError(f"bad 16x16/chroma mode {mode}")


def predict_luma4(buf: np.ndarray, x: int, y: int, mode: int) -> None:
    """4x4 predictors (modes 0-9, libwebp enum DC,TM,VE,HE,RD,VR,LD,VL,HD,HU).

    buf layout as in predict_block; borders are pre-filled (127/129) so no
    edge variants exist at the 4x4 level.
    """
    top = buf[y, x + 1 : x + 5].astype(np.int64)
    topr = buf[y, x + 5 : x + 9].astype(np.int64)
    left = buf[y + 1 : y + 5, x].astype(np.int64)
    tl = int(buf[y, x])
    blk = buf[y + 1 : y + 5, x + 1 : x + 5]
    A, B, C, D = top
    E, F, G, H = topr
    I, J, K, L = left
    X = tl
    o = np.zeros((4, 4), np.int64)
    if mode == 0:  # DC4
        o[:] = (int(top.sum()) + int(left.sum()) + 4) >> 3
    elif mode == 1:  # TM4
        o[:] = pred_tm(top, left, tl, 4)
    elif mode == 2:  # VE4 (smoothed vertical)
        vals = [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)]
        o[:] = np.array(vals)[None, :]
    elif mode == 3:  # HE4
        vals = [_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L), _avg3(K, L, L)]
        o[:] = np.array(vals)[:, None]
    elif mode == 4:  # RD4 (down-right)
        o[0, 3] = _avg3(D, C, B)
        o[0, 2] = o[1, 3] = _avg3(C, B, A)
        o[0, 1] = o[1, 2] = o[2, 3] = _avg3(B, A, X)
        o[0, 0] = o[1, 1] = o[2, 2] = o[3, 3] = _avg3(A, X, I)
        o[1, 0] = o[2, 1] = o[3, 2] = _avg3(X, I, J)
        o[2, 0] = o[3, 1] = _avg3(I, J, K)
        o[3, 0] = _avg3(J, K, L)
    elif mode == 5:  # VR4 (vertical-right)
        o[0, 0] = o[2, 1] = _avg2(X, A)
        o[0, 1] = o[2, 2] = _avg2(A, B)
        o[0, 2] = o[2, 3] = _avg2(B, C)
        o[0, 3] = _avg2(C, D)
        o[3, 0] = _avg3(K, J, I)
        o[2, 0] = _avg3(J, I, X)
        o[1, 0] = o[3, 1] = _avg3(I, X, A)
        o[1, 1] = o[3, 2] = _avg3(X, A, B)
        o[1, 2] = o[3, 3] = _avg3(A, B, C)
        o[1, 3] = _avg3(B, C, D)
    elif mode == 6:  # LD4 (down-left)
        o[0, 0] = _avg3(A, B, C)
        o[0, 1] = o[1, 0] = _avg3(B, C, D)
        o[0, 2] = o[1, 1] = o[2, 0] = _avg3(C, D, E)
        o[0, 3] = o[1, 2] = o[2, 1] = o[3, 0] = _avg3(D, E, F)
        o[1, 3] = o[2, 2] = o[3, 1] = _avg3(E, F, G)
        o[2, 3] = o[3, 2] = _avg3(F, G, H)
        o[3, 3] = _avg3(G, H, H)
    elif mode == 7:  # VL4 (vertical-left)
        o[0, 0] = _avg2(A, B)
        o[0, 1] = o[2, 0] = _avg2(B, C)
        o[0, 2] = o[2, 1] = _avg2(C, D)
        o[0, 3] = o[2, 2] = _avg2(D, E)
        o[1, 0] = _avg3(A, B, C)
        o[1, 1] = o[3, 0] = _avg3(B, C, D)
        o[1, 2] = o[3, 1] = _avg3(C, D, E)
        o[1, 3] = o[3, 2] = _avg3(D, E, F)
        o[2, 3] = _avg3(E, F, G)
        o[3, 3] = _avg3(F, G, H)
    elif mode == 8:  # HD4 (horizontal-down)
        o[0, 0] = o[1, 2] = _avg2(I, X)
        o[1, 0] = o[2, 2] = _avg2(J, I)
        o[2, 0] = o[3, 2] = _avg2(K, J)
        o[3, 0] = _avg2(L, K)
        o[0, 3] = _avg3(A, B, C)
        o[0, 2] = _avg3(X, A, B)
        o[0, 1] = o[1, 3] = _avg3(I, X, A)
        o[1, 1] = o[2, 3] = _avg3(X, I, J)
        o[2, 1] = o[3, 3] = _avg3(I, J, K)
        o[3, 1] = _avg3(J, K, L)
    elif mode == 9:  # HU4 (horizontal-up)
        o[0, 0] = _avg2(I, J)
        o[0, 2] = o[1, 0] = _avg2(J, K)
        o[1, 2] = o[2, 0] = _avg2(K, L)
        o[0, 1] = _avg3(I, J, K)
        o[0, 3] = o[1, 1] = _avg3(J, K, L)
        o[1, 3] = o[2, 1] = _avg3(K, L, L)
        o[2, 2] = o[2, 3] = o[3, 0] = o[3, 1] = o[3, 2] = o[3, 3] = L
    else:
        raise ValueError(f"bad 4x4 mode {mode}")
    blk[:] = o


# ---------------------------------------------------------------------------
# Loop filter primitives (operate along axis given by a (pixels, 8) window)
# ---------------------------------------------------------------------------

def _sclip1(v):
    return max(-128, min(127, v))


def _sclip2(v):
    return max(-16, min(15, v))


def _clip1(v):
    return max(0, min(255, v))


def needs_filter(p1, p0, q0, q1, thresh2) -> bool:
    return 4 * abs(p0 - q0) + abs(p1 - q1) <= thresh2


def needs_filter2(p, thresh2, ithresh) -> bool:
    p3, p2, p1, p0, q0, q1, q2, q3 = p
    if 4 * abs(p0 - q0) + abs(p1 - q1) > thresh2:
        return False
    return (
        abs(p3 - p2) <= ithresh and abs(p2 - p1) <= ithresh
        and abs(p1 - p0) <= ithresh and abs(q3 - q2) <= ithresh
        and abs(q2 - q1) <= ithresh and abs(q1 - q0) <= ithresh
    )


def hev(p1, p0, q0, q1, thresh) -> bool:
    return abs(p1 - p0) > thresh or abs(q1 - q0) > thresh


def do_filter2(px):
    """px = [p1,p0,q0,q1] → modifies p0,q0."""
    p1, p0, q0, q1 = px
    a = 3 * (q0 - p0) + _sclip1(p1 - q1)
    a1 = _sclip2((a + 4) >> 3)
    a2 = _sclip2((a + 3) >> 3)
    return p1, _clip1(p0 + a2), _clip1(q0 - a1), q1


def do_filter4(px):
    """px = [p2? not used.. actually [p1,p0,q0,q1]] → all four modified."""
    p1, p0, q0, q1 = px
    a = 3 * (q0 - p0)
    a1 = _sclip2((a + 4) >> 3)
    a2 = _sclip2((a + 3) >> 3)
    a3 = (a1 + 1) >> 1
    return (_clip1(p1 + a3), _clip1(p0 + a2), _clip1(q0 - a1), _clip1(q1 - a3))


def do_filter6(px):
    """px = [p2,p1,p0,q0,q1,q2] → all six modified."""
    p2, p1, p0, q0, q1, q2 = px
    a = _sclip1(3 * (q0 - p0) + _sclip1(p1 - q1))
    a1 = (27 * a + 63) >> 7
    a2 = (18 * a + 63) >> 7
    a3 = (9 * a + 63) >> 7
    return (
        _clip1(p2 + a3), _clip1(p1 + a2), _clip1(p0 + a1),
        _clip1(q0 - a1), _clip1(q1 - a2), _clip1(q2 - a3),
    )
