"""VP8 (WebP lossy) encoder.

Array-first split: RGB→YUV420, prediction-candidate evaluation, FDCT/
quantization and reconstruction are dense integer array math (NumPy
reference here; JAX versions in gowebp_tpu/ops/).  The boolean-coder
emission and header syntax are host-side.  Two-pass probability
adaptation: tokenize once collecting per-node bit statistics, finalize
probabilities, then emit.

Feature parity target: /root/reference/pkg/libwebp/enc (webp_encoder.go,
quant_enc.c.go mode search :840-1076, frame_enc.c.go residual coding
:218-290 + proba finalization :93-165, syntax_enc.c.go headers) — written
fresh from RFC 6386's decode semantics (the encoder mirrors our decoder).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...config import EncoderConfig
from ...constants import CHUNK_ALPHA, CHUNK_VP8
from ...container.riff import Chunk, assemble, assemble_simple, build_vp8x
from ...entropy.bool_coder import BoolEncoder
from ...errors import EncodeError
from ...ops import yuv_np
from . import dsp_np
from .tables import (
    AC_QUANT,
    BANDS,
    CAT_PROBAS,
    COEFF_PROBAS,
    COEFF_UPDATE_PROBAS,
    DC_QUANT,
    ZIGZAG,
    B_DC,
    B_TM,
    B_VE,
    B_HE,
)

MAX_LEVEL = 2047

# Trellis rate-distortion weight: lambda = (NUM * q_ac^2) >> SHIFT.
I4_LAMBDA_MULT = 4
TRELLIS_LAMBDA_NUM = 1
TRELLIS_LAMBDA_SHIFT = 10

# ---------------------------------------------------------------------------
# Color conversion + padding
# ---------------------------------------------------------------------------


def rgb_to_yuv420(rgba: np.ndarray):
    """(H, W, 3|4) uint8 → Y (H,W), U,V ((H+1)//2, (W+1)//2), int arrays.

    Matches libwebp's ImportYUVAFromRGBA: per-pixel Y, 2x2-accumulated
    chroma with the same fixed-point rounding.
    """
    h, w = rgba.shape[:2]
    from ...entropy.native_loader import get_lib

    lib = get_lib()
    if lib is not None and hasattr(lib, "wtpu_rgba_to_yuv420"):
        import ctypes

        if rgba.shape[2] == 3:
            rgba4 = np.empty((h, w, 4), np.uint8)
            rgba4[..., :3] = rgba
            rgba4[..., 3] = 255
        else:
            rgba4 = np.ascontiguousarray(rgba, np.uint8)
        yo = np.empty((h, w), np.uint8)
        uo = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
        vo = np.empty_like(uo)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.wtpu_rgba_to_yuv420(
            rgba4.ctypes.data_as(u8p), h, w,
            yo.ctypes.data_as(u8p), uo.ctypes.data_as(u8p),
            vo.ctypes.data_as(u8p),
        )
        return (yo.astype(np.int32), uo.astype(np.int32),
                vo.astype(np.int32))
    r = rgba[..., 0].astype(np.int32)
    g = rgba[..., 1].astype(np.int32)
    b = rgba[..., 2].astype(np.int32)
    y = yuv_np.rgb_to_y(r, g, b)
    # Pad to even dims by edge replication, then 2x2 sum.
    r2 = np.pad(r, ((0, h & 1), (0, w & 1)), mode="edge")
    g2 = np.pad(g, ((0, h & 1), (0, w & 1)), mode="edge")
    b2 = np.pad(b, ((0, h & 1), (0, w & 1)), mode="edge")
    rs = r2[0::2, 0::2] + r2[0::2, 1::2] + r2[1::2, 0::2] + r2[1::2, 1::2]
    gs = g2[0::2, 0::2] + g2[0::2, 1::2] + g2[1::2, 0::2] + g2[1::2, 1::2]
    bs = b2[0::2, 0::2] + b2[0::2, 1::2] + b2[1::2, 0::2] + b2[1::2, 1::2]
    u = yuv_np.rgb_to_u(rs, gs, bs)
    v = yuv_np.rgb_to_v(rs, gs, bs)
    return y.astype(np.int32), u.astype(np.int32), v.astype(np.int32)


def _vp8_random_stream(n: int, num_bits: int, amp: int) -> np.ndarray:
    """n centered VP8Random.bits2 draws, block-vectorized.

    The Knuth lagged-difference generator updates tab[i] from
    tab[(i+31) % 55]; within a 55-draw block the first 24 draws read
    original entries and the rest read entries updated earlier in the
    same block, so each block vectorizes as two spans.
    """
    from .decoder import _RANDOM_TABLE

    tab = np.array(_RANDOM_TABLE, np.int64)
    out = np.empty(n, np.int64)
    pos = 0
    while pos < n:
        k = min(55, n - pos)
        first = min(k, 24)
        d1 = tab[:first] - tab[31:31 + first]
        tab[:first] = np.where(d1 < 0, d1 + (1 << 31), d1)
        if k > 24:
            d2 = tab[24:k] - tab[:k - 24]
            tab[24:k] = np.where(d2 < 0, d2 + (1 << 31), d2)
        out[pos:pos + k] = tab[:k]
        pos += k
    v = (out.astype(np.uint32) << np.uint32(1)).astype(np.int32)
    v = v.astype(np.int64) >> (32 - num_bits)
    v = (v * amp) >> 8
    return v + (1 << (num_bits - 1))


def rgb_to_yuv420_dithered(rgba: np.ndarray, dithering: float):
    """RGB(A) → YUV420 with VP8Random-dithered fixed-point rounding.

    The ``preprocessing & 2`` path (reference ImportYUVAFromRGBA with
    dithering > 0, picture/conversions.go:93-167): every Y sample and
    every U/V sample gets its rounding term drawn from the bit-exact
    VP8Random stream instead of the constant half.  Draw order: all Y
    rounding values (row-major), then per chroma pixel U,V — a fixed,
    documented order (the reference interleaves by row pairs; only
    determinism matters since the choice is encoder-side).
    """
    h, w = rgba.shape[:2]
    amp = int(dithering * 256.0 + 0.5)
    r = rgba[..., 0].astype(np.int64)
    g = rgba[..., 1].astype(np.int64)
    b = rgba[..., 2].astype(np.int64)
    uv_h, uv_w = (h + 1) // 2, (w + 1) // 2
    stream_y = _vp8_random_stream(h * w, yuv_np.YUV_FIX, amp)
    stream_uv = _vp8_random_stream(2 * uv_h * uv_w, yuv_np.YUV_FIX + 2, amp)
    y = yuv_np.rgb_to_y(r, g, b, rounding=stream_y.reshape(h, w))
    r2 = np.pad(r, ((0, h & 1), (0, w & 1)), mode="edge")
    g2 = np.pad(g, ((0, h & 1), (0, w & 1)), mode="edge")
    b2 = np.pad(b, ((0, h & 1), (0, w & 1)), mode="edge")
    rs = r2[0::2, 0::2] + r2[0::2, 1::2] + r2[1::2, 0::2] + r2[1::2, 1::2]
    gs = g2[0::2, 0::2] + g2[0::2, 1::2] + g2[1::2, 0::2] + g2[1::2, 1::2]
    bs = b2[0::2, 0::2] + b2[0::2, 1::2] + b2[1::2, 0::2] + b2[1::2, 1::2]
    ru = stream_uv[0::2].reshape(uv_h, uv_w)
    rv = stream_uv[1::2].reshape(uv_h, uv_w)
    u = yuv_np.rgb_to_u(rs, gs, bs, rounding=ru)
    v = yuv_np.rgb_to_v(rs, gs, bs, rounding=rv)
    return (y.astype(np.int32), u.astype(np.int32), v.astype(np.int32))


def _smooth_segment_map(seg_map: np.ndarray, mb_w: int, mb_h: int
                        ) -> np.ndarray:
    """3x3 majority filter over interior MBs (reference SmoothSegmentMap,
    enc/analysis_enc.c.go:37-77, the ``preprocessing & 1`` tool)."""
    m = np.asarray(seg_map).reshape(mb_h, mb_w)
    if mb_h < 3 or mb_w < 3:
        return m.reshape(-1)
    out = m.copy()
    counts = np.zeros((4, mb_h - 2, mb_w - 2), np.int32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nb = m[1 + dy: mb_h - 1 + dy, 1 + dx: mb_w - 1 + dx]
            for s in range(4):
                counts[s] += nb == s
    maj = counts.argmax(axis=0)
    hit = counts.max(axis=0) >= 5
    inner = out[1:-1, 1:-1]
    out[1:-1, 1:-1] = np.where(hit, maj, inner)
    return out.reshape(-1)


def rgb_to_yuv420_sharp(rgba: np.ndarray, iterations: int = 4):
    """Sharp (iterative) RGB→YUV420: refine U/V so the upsampled
    reconstruction matches the source at chroma edges.

    Feature parity target: the use_sharp_yuv path
    (/root/reference/pkg/libwebp/enc/picture_csp_enc.c.go gamma-aware
    "smart" conversion) — re-done as a damped fixed-point descent on the
    chroma planes.
    """
    h, w = rgba.shape[:2]
    r = rgba[..., 0].astype(np.int64)
    g = rgba[..., 1].astype(np.int64)
    b = rgba[..., 2].astype(np.int64)
    y, u, v = rgb_to_yuv420(rgba)
    y = y.astype(np.int64)
    u = u.astype(np.int64)
    v = v.astype(np.int64)
    for _ in range(iterations):
        uf = yuv_np.fancy_upsample(np.clip(u, 0, 255), h, w).astype(np.int64)
        vf = yuv_np.fancy_upsample(np.clip(v, 0, 255), h, w).astype(np.int64)
        rec = yuv_np.yuv_to_rgb(np.clip(y, 0, 255), uf, vf).astype(np.int64)
        er = r - rec[..., 0]
        eg = g - rec[..., 1]
        eb = b - rec[..., 2]
        # Project the RGB error onto Y and (downsampled) U/V axes.
        dy = (16839 * er + 33059 * eg + 6420 * eb) >> 16
        du_full = (-9719 * er - 19081 * eg + 28800 * eb) >> 16
        dv_full = (28800 * er - 24116 * eg - 4684 * eb) >> 16
        du = _downsample2(du_full) // 4
        dv = _downsample2(dv_full) // 4
        y = np.clip(y + (dy * 3) // 4, 0, 255)
        u = np.clip(u + (du * 3) // 4, 0, 255)
        v = np.clip(v + (dv * 3) // 4, 0, 255)
    return y, u, v


def _downsample2(plane: np.ndarray) -> np.ndarray:
    h, w = plane.shape
    p = np.pad(plane, ((0, h & 1), (0, w & 1)), mode="edge")
    return p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]


def _pad_to_mb(plane: np.ndarray, mb_size: int) -> np.ndarray:
    h, w = plane.shape
    H = (h + mb_size - 1) // mb_size * mb_size
    W = (w + mb_size - 1) // mb_size * mb_size
    return np.pad(plane, ((0, H - h), (0, W - w)), mode="edge")


# ---------------------------------------------------------------------------
# Quantization
# ---------------------------------------------------------------------------


def quality_to_q(quality: float, *, emulate_jpeg_size: bool = False,
                 jpeg_alpha: float = 0.5) -> int:
    """Map quality 0..100 → quantizer index 0..127 (libwebp's power law).

    emulate_jpeg_size swaps in the libjpeg6b-matched compression curve
    (reference QualityToJPEGCompression, enc/quant_enc.c.go:215-232);
    jpeg_alpha is the image's normalized quantization susceptibility.
    """
    c = quality / 100.0
    if emulate_jpeg_size:
        amin, amax, exp_min, exp_max = 0.30, 0.85, 0.4, 0.9
        slope = (exp_min - exp_max) / (amax - amin)
        a = jpeg_alpha
        expn = (exp_min if a > amax else
                exp_max if a < amin else exp_max + slope * (a - amin))
        v = c ** expn
    else:
        linear_c = c * (2.0 / 3.0) if c < 0.75 else 2.0 * c - 1.0
        v = linear_c ** (1.0 / 3.0)
    return int(127.0 * (1.0 - v) + 0.5)


def _i4_penalty_scale(partition_limit: int) -> float | None:
    """partition_limit 0..100 → i4 score-penalty multiplier (None = i4 off).

    The reference shrinks the i4 header-bit budget quadratically with
    (100 - partition_limit) (MapConfigToTools, webp_encoder.go:82-98);
    with a score-based search the same pressure is an inverse-quadratic
    penalty scale on choosing i4 over i16.
    """
    limit = 100 - partition_limit
    if limit <= 0:
        return None
    return (100.0 * 100.0) / (limit * limit)


# _mul_shr16 (encode_wavefront_jax) and the native encoder's int64 score
# math are exact only for lambda < 2^19; a quadratically scaled
# partition_limit penalty can exceed that (and wrap through ctypes
# c_int), so every computed penalty is clamped to this ceiling.  Beyond
# it i4 effectively never wins, so the clamp is behaviour-preserving.
I4_PENALTY_MAX = (1 << 19) - 1

# Reference gate for UV DC error diffusion (encoder_iterator.go:57).
ERROR_DIFFUSION_QUALITY = 98


def _i4_config(q_ac: int, method: int, partition_limit: int):
    """(try_i4, clamped penalty) shared by host/JAX/pipelined encoders."""
    scale = _i4_penalty_scale(partition_limit)
    pen = int(I4_LAMBDA_MULT * q_ac * q_ac
              * (scale if scale is not None else 1.0))
    return (method >= 4 and scale is not None), min(pen, I4_PENALTY_MAX)


def _i4_config_seg(qsteps_rows, method: int, partition_limit: int):
    """(try_i4, (4,) int32 per-segment penalties).

    The RD lambda must follow each segment's own quantizer (the
    reference derives lambda per segment in SetupMatrices,
    quant_enc.c.go:125) — a single base-segment lambda over-weighs rate
    in low-q segments and under-weighs it in high-q ones, which is what
    made segmentation a net RD loss in round 2.
    qsteps_rows: (4, 6) rows of quant steps (column 1 = y1_ac).
    """
    scale = _i4_penalty_scale(partition_limit)
    pens = np.empty(4, np.int32)
    for s in range(4):
        q_ac = int(qsteps_rows[s][1])
        pens[s] = min(int(I4_LAMBDA_MULT * q_ac * q_ac
                          * (scale if scale is not None else 1.0)),
                      I4_PENALTY_MAX)
    return (method >= 4 and scale is not None), pens


@dataclass
class QuantPair:
    q: int      # quantizer step
    iq: int     # (1<<17)/q
    bias: int

    @classmethod
    def make(cls, q: int, bias8: int) -> "QuantPair":
        return cls(q=q, iq=(1 << 17) // q, bias=bias8 << 9)

    def quantize(self, v: int) -> int:
        """abs value → level (QUANTDIV semantics)."""
        return min((v * self.iq + self.bias) >> 17, MAX_LEVEL)


@dataclass
class SegmentQuant:
    y1_dc: QuantPair
    y1_ac: QuantPair
    y2_dc: QuantPair
    y2_ac: QuantPair
    uv_dc: QuantPair
    uv_ac: QuantPair


def make_quants(base_q: int) -> SegmentQuant:
    """Derive the per-type quant steps exactly as the decoder will."""
    q = base_q
    y1_dc = int(DC_QUANT[min(q, 127)])
    y1_ac = int(AC_QUANT[min(q, 127)])
    y2_dc = int(DC_QUANT[min(q, 127)]) * 2
    y2_ac = max(8, (int(AC_QUANT[min(q, 127)]) * 101581) >> 16)
    uv_dc = int(DC_QUANT[min(q, 117)])
    uv_ac = int(AC_QUANT[min(q, 127)])
    return SegmentQuant(
        y1_dc=QuantPair.make(y1_dc, 96),
        y1_ac=QuantPair.make(y1_ac, 110),
        y2_dc=QuantPair.make(y2_dc, 96),
        y2_ac=QuantPair.make(y2_ac, 96),
        uv_dc=QuantPair.make(uv_dc, 110),
        uv_ac=QuantPair.make(uv_ac, 110),
    )


def _quantize_block(coeffs: np.ndarray, dc: QuantPair, ac: QuantPair,
                    first: int = 0) -> np.ndarray:
    """Raster-order coeffs (16,) → zigzag-order levels (16,)."""
    levels = np.zeros(16, np.int32)
    for n in range(first, 16):
        j = ZIGZAG[n]
        v = int(coeffs[j])
        qp = dc if n == 0 else ac
        sign = v < 0
        level = qp.quantize(-v if sign else v)
        levels[n] = -level if sign else level
    return levels


def _dequant_block(levels: np.ndarray, dc_q: int, ac_q: int) -> np.ndarray:
    """Zigzag levels → raster-order dequantized coeffs."""
    out = np.zeros(16, np.int32)
    for n in range(16):
        out[ZIGZAG[n]] = int(levels[n]) * (dc_q if n == 0 else ac_q)
    return out


# ---------------------------------------------------------------------------
# Per-MB encoding (mode decision + transform + reconstruction)
# ---------------------------------------------------------------------------


@dataclass
class MBEnc:
    ymode: int = 0
    uvmode: int = 0
    # Levels in zigzag order: 16 luma AC blocks, 8 chroma, 1 Y2.
    y_levels: np.ndarray | None = None    # (16,16)
    uv_levels: np.ndarray | None = None   # (8,16)
    y2_levels: np.ndarray | None = None   # (16,)
    nz: np.ndarray | None = None          # per-block nz (24,)
    y2_nz: int = 0
    skip: bool = False


_SCAN = [(4 * (n >> 2), 4 * (n & 3)) for n in range(16)]


def _sse(a: np.ndarray, b: np.ndarray) -> int:
    d = a.astype(np.int64) - b.astype(np.int64)
    return int((d * d).sum())


def _encode_mb_luma(src: np.ndarray, ybuf: np.ndarray, q: SegmentQuant,
                    have_top: bool, have_left: bool, mb: MBEnc) -> None:
    """i16 mode search + transform + reconstruction into ybuf."""
    # Try the 4 16x16 modes on prediction alone (distortion only).
    best_mode, best_cost = 0, None
    trial = np.empty_like(ybuf)
    for mode in (B_DC, B_TM, B_VE, B_HE):
        trial[:] = ybuf
        dsp_np.predict_block(trial, 0, 0, 16, mode, have_top, have_left)
        cost = _sse(src, trial[1:17, 1:17])
        if best_cost is None or cost < best_cost:
            best_mode, best_cost = mode, cost
    mb.ymode = best_mode
    dsp_np.predict_block(ybuf, 0, 0, 16, best_mode, have_top, have_left)
    pred = ybuf[1:17, 1:17].copy()

    residual = src.astype(np.int64) - pred
    y_levels = np.zeros((16, 16), np.int32)
    dcs = np.zeros(16, np.int64)
    coeffs_list = []
    for n in range(16):
        r, c = _SCAN[n]
        blk = residual[r : r + 4, c : c + 4]
        coeffs = dsp_np.fdct4x4(blk)
        dcs[n] = coeffs[0]
        coeffs_list.append(coeffs)
        y_levels[n] = _quantize_block(coeffs, q.y1_dc, q.y1_ac, first=1)
    # WHT on the DCs.
    y2 = dsp_np.fwht4x4(dcs)
    y2_levels = _quantize_block(y2, q.y2_dc, q.y2_ac)
    mb.y_levels = y_levels
    mb.y2_levels = y2_levels

    # Reconstruction (must mirror the decoder exactly).
    y2_deq = _dequant_block(y2_levels, q.y2_dc.q, q.y2_ac.q)
    y2_nz_count = _nz_len(y2_levels)
    if y2_nz_count > 1:
        rec_dcs = dsp_np.iwht4x4(np.array(y2_deq, np.int32))
    else:
        dc0 = (int(y2_deq[0]) + 3) >> 3
        rec_dcs = np.full(16, dc0, np.int64)
    mb.y2_nz = int(y2_nz_count > 0)
    nz = np.zeros(24, np.int32)
    for n in range(16):
        r, c = _SCAN[n]
        deq = _dequant_block(y_levels[n], q.y1_dc.q, q.y1_ac.q)
        deq[0] = rec_dcs[n]
        dst = ybuf[r + 1 : r + 5, c + 1 : c + 5]
        # Decoder applies full iDCT whenever any coeff present.
        if (deq != 0).any():
            dsp_np.idct4x4_add(np.array(deq, np.int32), dst)
        nz[n] = _nz_len(y_levels[n], first=1)
    mb.nz = nz


def _encode_mb_chroma(usrc, vsrc, ubuf, vbuf, q: SegmentQuant,
                      have_top, have_left, mb: MBEnc) -> None:
    best_mode, best_cost = 0, None
    ut = np.empty_like(ubuf)
    vt = np.empty_like(vbuf)
    for mode in (B_DC, B_TM, B_VE, B_HE):
        ut[:] = ubuf
        vt[:] = vbuf
        dsp_np.predict_block(ut, 0, 0, 8, mode, have_top, have_left)
        dsp_np.predict_block(vt, 0, 0, 8, mode, have_top, have_left)
        cost = _sse(usrc, ut[1:9, 1:9]) + _sse(vsrc, vt[1:9, 1:9])
        if best_cost is None or cost < best_cost:
            best_mode, best_cost = mode, cost
    mb.uvmode = best_mode
    dsp_np.predict_block(ubuf, 0, 0, 8, best_mode, have_top, have_left)
    dsp_np.predict_block(vbuf, 0, 0, 8, best_mode, have_top, have_left)

    uv_levels = np.zeros((8, 16), np.int32)
    for ch, (srcp, buf) in enumerate(((usrc, ubuf), (vsrc, vbuf))):
        residual = srcp.astype(np.int64) - buf[1:9, 1:9]
        for k, (r, c) in enumerate([(0, 0), (0, 4), (4, 0), (4, 4)]):
            blk = residual[r : r + 4, c : c + 4]
            coeffs = dsp_np.fdct4x4(blk)
            idx = 4 * ch + k
            uv_levels[idx] = _quantize_block(coeffs, q.uv_dc, q.uv_ac)
            deq = _dequant_block(uv_levels[idx], q.uv_dc.q, q.uv_ac.q)
            dst = buf[r + 1 : r + 5, c + 1 : c + 5]
            if (deq != 0).any():
                dsp_np.idct4x4_add(np.array(deq, np.int32), dst)
            mb.nz[16 + idx] = _nz_len(uv_levels[idx])
    mb.uv_levels = uv_levels


def _nz_len(levels: np.ndarray, first: int = 0) -> int:
    nz = np.flatnonzero(levels[first:])
    return 0 if len(nz) == 0 else int(nz[-1]) + 1 + 0  # position count from `first`


# ---------------------------------------------------------------------------
# Token recording / emission
# ---------------------------------------------------------------------------


class TokenRecorder:
    """Records (type, band, ctx, proba_idx, bit) booleans + fixed-prob bits."""

    __slots__ = ("tokens", "stats")

    def __init__(self):
        self.tokens = []          # (t, b, c, p, bit) or (-1, prob, bit)
        self.stats = np.zeros((4, 8, 3, 11, 2), np.int64)

    def bit(self, t, b, c, p, bit):
        self.tokens.append((t, b, c, p, bit))
        self.stats[t, b, c, p, bit] += 1

    def fixed(self, prob, bit):
        self.tokens.append((-1, prob, bit))

    def emit(self, enc: BoolEncoder, probs: np.ndarray):
        for tok in self.tokens:
            if tok[0] == -1:
                enc.put_bit(tok[2], tok[1])
            else:
                t, b, c, p, bit = tok
                enc.put_bit(bit, int(probs[t, b, c, p]))


def _record_coeffs(rec: TokenRecorder, t: int, levels: np.ndarray,
                   ctx: int, first: int) -> int:
    """Record the token bits for one block; returns nz (last nonzero + 1)."""
    nzs = np.flatnonzero(levels[first:])
    if len(nzs) == 0:
        rec.bit(t, BANDS[first], ctx, 0, 0)
        return first  # "nz = n" means previous coeff was last nonzero
    last = int(nzs[-1]) + first
    n = first
    b = BANDS[n]
    c = ctx
    while n <= last:
        # EOB check says "more coeffs follow".
        rec.bit(t, b, c, 0, 1)
        # Zero run.
        while levels[n] == 0:
            rec.bit(t, b, c, 1, 0)
            n += 1
            b = BANDS[n]
            c = 0
        rec.bit(t, b, c, 1, 1)
        v = int(levels[n])
        sign = v < 0
        av = -v if sign else v
        if av == 1:
            rec.bit(t, b, c, 2, 0)
            next_c = 1
        else:
            rec.bit(t, b, c, 2, 1)
            _record_large(rec, t, b, c, av)
            next_c = 2
        rec.fixed(128, 1 if sign else 0)
        n += 1
        if n == 16:
            return 16
        b = BANDS[n]
        c = next_c
    # EOB.
    rec.bit(t, b, c, 0, 0)
    return last + 1


def _record_large(rec: TokenRecorder, t, b, c, v: int) -> None:
    if v <= 4:
        rec.bit(t, b, c, 3, 0)
        if v == 2:
            rec.bit(t, b, c, 4, 0)
        else:
            rec.bit(t, b, c, 4, 1)
            rec.bit(t, b, c, 5, v - 3)
        return
    rec.bit(t, b, c, 3, 1)
    if v <= 10:
        rec.bit(t, b, c, 6, 0)
        if v <= 6:
            rec.bit(t, b, c, 7, 0)
            rec.fixed(159, v - 5)
        else:
            rec.bit(t, b, c, 7, 1)
            rec.fixed(165, (v - 7) >> 1)
            rec.fixed(145, (v - 7) & 1)
        return
    rec.bit(t, b, c, 6, 1)
    for cat in range(4):
        base = 3 + (8 << cat)
        span = 1 << (len(CAT_PROBAS[cat]))
        if v < base + span or cat == 3:
            bit1 = cat >> 1
            bit0 = cat & 1
            rec.bit(t, b, c, 8, bit1)
            rec.bit(t, b, c, 9 + bit1, bit0)
            residue = min(v, MAX_LEVEL + 67) - base
            nbits = len(CAT_PROBAS[cat])
            for k in range(nbits - 1, -1, -1):
                rec.fixed(CAT_PROBAS[cat][nbits - 1 - k], (residue >> k) & 1)
            return
    raise AssertionError


def _record_mb_tokens(rec: TokenRecorder, mb: MBEnc, ctx_mb, ctx_left) -> bool:
    """Record all coefficient tokens of one MB with exact decoder contexts."""
    # Y2 (always coded for i16 MBs).
    ctx = ctx_mb[1] + ctx_left[1]
    nz = _record_coeffs(rec, 1, mb.y2_levels, ctx, 0)
    ctx_mb[1] = ctx_left[1] = int(nz > 0)
    first = 1
    t_ac = 0

    any_nz = nz > 0
    tnz = ctx_mb[0] & 0x0F
    lnz = ctx_left[0] & 0x0F
    for y in range(4):
        l = lnz & 1
        for x in range(4):
            ctx = l + (tnz & 1)
            nz = _record_coeffs(rec, t_ac, mb.y_levels[4 * y + x], ctx, first)
            l = int(nz > first)
            any_nz = any_nz or l
            tnz = (tnz >> 1) | (l << 7)
        tnz >>= 4
        lnz = (lnz >> 1) | (l << 7)
    out_t_nz = tnz
    out_l_nz = lnz >> 4

    for ch in range(0, 4, 2):
        tnz = (ctx_mb[0] >> (4 + ch)) & 0xFF
        lnz = (ctx_left[0] >> (4 + ch)) & 0xFF
        for y in range(2):
            l = lnz & 1
            for x in range(2):
                ctx = l + (tnz & 1)
                idx = 2 * ch + 2 * y + x
                nz = _record_coeffs(rec, 2, mb.uv_levels[idx], ctx, 0)
                l = int(nz > 0)
                any_nz = any_nz or l
                tnz = (tnz >> 1) | (l << 3)
            tnz >>= 2
            lnz = (lnz >> 1) | (l << 5)
        out_t_nz |= (tnz << 4) << ch
        out_l_nz |= (lnz & 0xF0) << ch
    ctx_mb[0] = out_t_nz
    ctx_left[0] = out_l_nz
    return not any_nz


# ---------------------------------------------------------------------------
# Probability finalization
# ---------------------------------------------------------------------------


def _bit_cost(n0: int, n1: int, prob: int) -> float:
    """Approximate cost in bits of coding n0 zeros/n1 ones at `prob`."""
    import math

    p = prob / 256.0
    cost = 0.0
    if n0:
        cost -= n0 * math.log2(max(p, 1e-9))
    if n1:
        cost -= n1 * math.log2(max(1.0 - p, 1e-9))
    return cost


def finalize_probas(stats: np.ndarray):
    """Choose updated probabilities where the saving beats the header cost.

    Fully vectorized over the (4,8,3,11) probability tree.
    """
    n0 = stats[..., 0].astype(np.float64)
    n1 = stats[..., 1].astype(np.float64)
    total = n0 + n1
    old = COEFF_PROBAS.astype(np.int64)
    new = np.clip((n0 * 255 / np.maximum(total, 1)).astype(np.int64), 1, 255)

    def cost(prob):
        p = prob / 256.0
        with np.errstate(divide="ignore", invalid="ignore"):
            inv_ln2 = 1.4426950408889634
            c = (-n0 * np.log(p + 1e-9)
                 - n1 * np.log(1.0 - p + 1e-9)) * inv_ln2
        return c

    old_cost = cost(old)
    new_cost = cost(new) + 8.0
    updates = (total > 0) & (new != old) & (old_cost - new_cost > 8.0)
    probs = np.where(updates, new, old).astype(np.uint8)
    return probs, updates


# ---------------------------------------------------------------------------
# Header + mode syntax
# ---------------------------------------------------------------------------


def _write_mode(enc: BoolEncoder, mb, use_skip: bool, skip_p: int,
                top4=None, left4=None, seg_probs=None) -> None:
    from .tables import BMODE_PATHS, KF_BMODE_PROBAS

    if seg_probs is not None:
        sid = getattr(mb, "segment", 0)
        if sid < 2:
            enc.put_bit(0, seg_probs[0])
            enc.put_bit(sid, seg_probs[1])
        else:
            enc.put_bit(1, seg_probs[0])
            enc.put_bit(sid - 2, seg_probs[2])
    if use_skip:
        enc.put_bit(1 if mb.skip else 0, skip_p)
    is_i4 = bool(getattr(mb, "is_i4", False))
    if not is_i4:
        enc.put_bit(1, 145)  # is_i4x4 = False → bit 1
        # 16x16 mode tree.
        m = mb.ymode
        if m == B_DC:
            enc.put_bit(0, 156)
            enc.put_bit(0, 163)
        elif m == B_VE:
            enc.put_bit(0, 156)
            enc.put_bit(1, 163)
        elif m == B_HE:
            enc.put_bit(1, 156)
            enc.put_bit(0, 128)
        else:  # TM
            enc.put_bit(1, 156)
            enc.put_bit(1, 128)
        if top4 is not None:
            top4[:] = m
            left4[:] = m
    else:
        enc.put_bit(0, 145)  # is_i4x4
        imodes = mb.imodes
        for yy in range(4):
            ymode = int(left4[yy])
            for xx in range(4):
                prob = KF_BMODE_PROBAS[int(top4[xx])][ymode]
                mode = int(imodes[4 * yy + xx])
                for prob_idx, bit in BMODE_PATHS[mode]:
                    enc.put_bit(bit, int(prob[prob_idx]))
                top4[xx] = mode
                ymode = mode
            left4[yy] = ymode
    # UV tree.
    m = mb.uvmode
    if m == B_DC:
        enc.put_bit(0, 142)
    elif m == B_VE:
        enc.put_bit(1, 142)
        enc.put_bit(0, 114)
    elif m == B_TM:
        enc.put_bit(1, 142)
        enc.put_bit(1, 114)
        enc.put_bit(1, 183)
    else:  # HE
        enc.put_bit(1, 142)
        enc.put_bit(1, 114)
        enc.put_bit(0, 183)


def filter_level_from_q(base_q: int, filter_strength: int, sharpness: int) -> int:
    """Loop-filter level heuristic (libwebp-style strength mapping)."""
    if filter_strength == 0:
        return 0
    level = base_q * filter_strength // 100
    return max(0, min(63, level >> 1))


def encode_vp8_frame(y, u, v, width, height, config: EncoderConfig,
                     base_q: int | None = None, stats=None) -> bytes:
    """Y/U/V planes (already MB-padded) → VP8 frame payload."""
    mb_w = y.shape[1] // 16
    mb_h = y.shape[0] // 16
    if base_q is None:
        if config.emulate_jpeg_size:
            # Normalized susceptibility analog of the reference's
            # enc.alpha (mean laplacian activity → [0, 1]).
            ya = np.asarray(y, np.int32)
            lap = np.abs(
                4 * ya[1:-1, 1:-1] - ya[:-2, 1:-1] - ya[2:, 1:-1]
                - ya[1:-1, :-2] - ya[1:-1, 2:]
            ).mean() if min(y.shape) > 2 else 0.0
            jpeg_alpha = float(lap / (lap + 40.0))
            base_q = quality_to_q(config.quality, emulate_jpeg_size=True,
                                  jpeg_alpha=jpeg_alpha)
        else:
            base_q = quality_to_q(config.quality)
    base_q = max(config.qmin * 127 // 100, min(config.qmax * 127 // 100, base_q))
    q = make_quants(base_q)

    seg = None
    if config.segments > 1:
        seg_map, deltas = analyze_segments(
            y, mb_w, mb_h, config.segments, config.sns_strength, base_q
        )
        if config.preprocessing & 1:
            seg_map = _smooth_segment_map(seg_map, mb_w, mb_h)
        if len(set(deltas[: config.segments])) > 1:
            seg = {
                "map": seg_map,
                "deltas": deltas,
                "probs": _segment_tree_probs(seg_map),
                "quants": [make_quants(max(0, min(127, base_q + d)))
                           for d in deltas],
            }
    # UV DC error diffusion at quality <= 98 (reference gate,
    # webp_encoder.go:145 / ERROR_DIFFUSION_QUALITY).
    use_derr = 1 if config.quality <= ERROR_DIFFUSION_QUALITY else 0
    native = _encode_frame_dense_native(y, u, v, mb_w, mb_h, q, config.method,
                                        seg=seg,
                                        partition_limit=config.partition_limit,
                                        use_derr=use_derr)
    if native is not None and config.method >= 6 and not config.low_memory:
        # Second dense pass with trellis quantization, rate-modeled on the
        # first pass's adapted probabilities (default-proba costs are far
        # too pessimistic once two-pass adaptation kicks in).
        first = _native_tokenizer_arrays(
            native["y2"], native["yl"], native["uvl"], native["is_i4"],
            mb_w, mb_h,
        )
        if first is not None:
            probs1, _ = finalize_probas(first["stats"])
            refined = _encode_frame_dense_native(
                y, u, v, mb_w, mb_h, q, config.method, seg=seg,
                trellis_probs=probs1,
                partition_limit=config.partition_limit,
                use_derr=use_derr,
            )
            if refined is not None:
                native = refined
    if native is not None:
        out = emit_frame_arrays(
            native["y2"], native["yl"], native["uvl"], native["is_i4"],
            native["ymode"], native["uvmode"],
            mb_w, mb_h, width, height, base_q, config,
            imodes=native["imodes"], stats=stats, seg=seg,
        )
        # low_memory mirrors the reference's use_tokens gate
        # (webp_encoder.go:106-111): skip the passes that hold extra
        # full-frame buffers (trellis re-pass above, decoded-PSNR
        # autofilter trials here) in exchange for a slightly worse file.
        if out is not None and config.autofilter and not config.low_memory:
            best = _autofilter(out, y, width, height, base_q, config)
            if best is not None:
                out = emit_frame_arrays(
                    native["y2"], native["yl"], native["uvl"],
                    native["is_i4"], native["ymode"], native["uvmode"],
                    mb_w, mb_h, width, height, base_q, config,
                    imodes=native["imodes"], stats=stats, seg=seg,
                    filter_level=best,
                )
        if out is not None:
            return out

    # Reconstruction planes (context for prediction).
    Y = np.zeros_like(y)
    U = np.zeros_like(u)
    V = np.zeros_like(v)
    mbs = [[MBEnc() for _ in range(mb_w)] for _ in range(mb_h)]

    for mb_y in range(mb_h):
        for mb_x in range(mb_w):
            mb = mbs[mb_y][mb_x]
            ybuf = np.empty((17, 21), np.int64)
            ubuf = np.empty((9, 9), np.int64)
            vbuf = np.empty((9, 9), np.int64)
            have_top = mb_y > 0
            have_left = mb_x > 0
            _fill_borders(Y, U, V, ybuf, ubuf, vbuf, mb_x, mb_y, mb_w)

            src_y = y[mb_y * 16 : mb_y * 16 + 16, mb_x * 16 : mb_x * 16 + 16]
            _encode_mb_luma(src_y, ybuf, q, have_top, have_left, mb)
            src_u = u[mb_y * 8 : mb_y * 8 + 8, mb_x * 8 : mb_x * 8 + 8]
            src_v = v[mb_y * 8 : mb_y * 8 + 8, mb_x * 8 : mb_x * 8 + 8]
            _encode_mb_chroma(src_u, src_v, ubuf, vbuf, q, have_top, have_left, mb)

            Y[mb_y * 16 : mb_y * 16 + 16, mb_x * 16 : mb_x * 16 + 16] = ybuf[1:17, 1:17]
            U[mb_y * 8 : mb_y * 8 + 8, mb_x * 8 : mb_x * 8 + 8] = ubuf[1:9, 1:9]
            V[mb_y * 8 : mb_y * 8 + 8, mb_x * 8 : mb_x * 8 + 8] = vbuf[1:9, 1:9]

    return emit_frame(mbs, mb_w, mb_h, width, height, base_q, config)


def emit_frame(mbs, mb_w: int, mb_h: int, width: int, height: int,
               base_q: int, config: EncoderConfig) -> bytes:
    """Headers + two-pass token emission from per-MB levels/modes."""
    total = mb_w * mb_h
    native = _native_tokenizer(mbs, mb_w, mb_h)

    if native is not None:
        stats, skip_flags = native["stats"], native["skip"]
        for my in range(mb_h):
            for mx in range(mb_w):
                mbs[my][mx].skip = bool(skip_flags[my * mb_w + mx])
    else:
        # Pass 1 in Python: tokenize with exact decoder contexts.
        rec = TokenRecorder()
        spans = []
        ctx_above = [[0, 0] for _ in range(mb_w)]
        for mb_y in range(mb_h):
            ctx_left = [0, 0]
            for mb_x in range(mb_w):
                mb = mbs[mb_y][mb_x]
                start = len(rec.tokens)
                empty = _record_mb_tokens(rec, mb, ctx_above[mb_x], ctx_left)
                mb.skip = empty
                spans.append((mb_y, mb_x, start, len(rec.tokens)))
        stats = rec.stats

    probs, updates = finalize_probas(stats)
    n_skip = sum(1 for row in mbs for mb in row if mb.skip)
    use_skip = n_skip > 0
    skip_p = max(1, min(255, ((total - n_skip) * 255) // total)) if use_skip else 0

    # Partition 0: headers + modes.
    p0 = BoolEncoder()
    p0.put_flag(0)  # color space
    p0.put_flag(0)  # clamp type
    p0.put_flag(0)  # no segmentation
    filter_level = filter_level_from_q(
        base_q, config.filter_strength, config.filter_sharpness
    )
    p0.put_flag(0 if config.filter_type else 1)  # simple filter?
    p0.put_literal(filter_level, 6)
    p0.put_literal(config.filter_sharpness, 3)
    p0.put_flag(0)  # no lf deltas
    p0.put_literal(0, 2)  # log2(partitions) = 0 -> 1 partition
    p0.put_literal(base_q, 7)
    for _ in range(5):  # y1dc/y2dc/y2ac/uvdc/uvac deltas = 0
        p0.put_flag(0)
    p0.put_flag(1)  # refresh entropy probs (ignored for keyframes)
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    if updates[t, b, c, p]:
                        p0.put_bit(1, int(COEFF_UPDATE_PROBAS[t, b, c, p]))
                        p0.put_literal(int(probs[t, b, c, p]), 8)
                    else:
                        p0.put_bit(0, int(COEFF_UPDATE_PROBAS[t, b, c, p]))
    p0.put_flag(1 if use_skip else 0)
    if use_skip:
        p0.put_literal(skip_p, 8)
    intra_t = np.zeros(4 * mb_w, np.int32)
    for mb_y in range(mb_h):
        intra_l = np.zeros(4, np.int32)
        for mb_x in range(mb_w):
            _write_mode(p0, mbs[mb_y][mb_x], use_skip, skip_p,
                        intra_t[4 * mb_x : 4 * mb_x + 4], intra_l)
    part0 = p0.finish()

    # Partition 1: tokens (this legacy path always writes one partition).
    if native is not None:
        part1 = b"".join(native["emit"](probs, use_skip, 1))
    else:
        p1 = BoolEncoder()
        for (mb_y, mb_x, start, end) in spans:
            mb = mbs[mb_y][mb_x]
            if use_skip and mb.skip:
                continue
            for tok in rec.tokens[start:end]:
                if tok[0] == -1:
                    p1.put_bit(tok[2], tok[1])
                else:
                    t, b, c, p, bit = tok
                    p1.put_bit(bit, int(probs[t, b, c, p]))
        part1 = p1.finish()

    # Frame tag.
    tag = (0) | (0 << 1) | (1 << 4) | (len(part0) << 5)
    header = bytes(
        (
            tag & 0xFF, (tag >> 8) & 0xFF, (tag >> 16) & 0xFF,
            0x9D, 0x01, 0x2A,
            width & 0xFF, (width >> 8) & 0x3F,
            height & 0xFF, (height >> 8) & 0x3F,
        )
    )
    return header + part0 + part1


_COST_TABLE_CACHE = None


def _default_cost_tables():
    """Token cost tables under the default coefficient probabilities."""
    global _COST_TABLE_CACHE
    if _COST_TABLE_CACHE is None:
        from .cost import trellis_cost_tables
        from .tables import COEFF_PROBAS

        tp0, tp1, tval = trellis_cost_tables(COEFF_PROBAS)
        _COST_TABLE_CACHE = (
            np.ascontiguousarray(tp0),
            np.ascontiguousarray(tp1),
            np.ascontiguousarray(tval),
        )
    return _COST_TABLE_CACHE


def _encode_frame_dense_native(y, u, v, mb_w, mb_h, q: SegmentQuant, method: int = 4, seg=None, trellis_probs=None, partition_limit: int = 0, use_derr: int = 0):
    """C++ closed-loop dense phase; returns level/mode arrays or None."""
    import ctypes

    from ...entropy.native_loader import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "wtpu_vp8_encode_frame"):
        return None
    total = mb_w * mb_h
    ys = np.ascontiguousarray(np.asarray(y), np.uint8)
    us = np.ascontiguousarray(np.asarray(u), np.uint8)
    vs = np.ascontiguousarray(np.asarray(v), np.uint8)
    def qrow(sq):
        return [sq.y1_dc.q, sq.y1_ac.q, sq.y2_dc.q, sq.y2_ac.q,
                sq.uv_dc.q, sq.uv_ac.q]

    if seg is not None:
        qsteps = np.array([qrow(s) for s in seg["quants"]], np.int32)
        seg_arr = np.ascontiguousarray(seg["map"], np.uint8)
    else:
        qsteps = np.array([qrow(q)] * 4, np.int32)
        seg_arr = None
    y2 = np.zeros((total, 16), np.int16)
    yl = np.zeros((total, 16, 16), np.int16)
    uvl = np.zeros((total, 8, 16), np.int16)
    ymode = np.zeros(total, np.uint8)
    uvmode = np.zeros(total, np.uint8)
    is_i4 = np.zeros(total, np.uint8)
    imodes = np.zeros((total, 16), np.uint8)
    yr = np.zeros_like(ys)
    ur = np.zeros_like(us)
    vr = np.zeros_like(vs)
    _try, i4_penalties = _i4_config_seg(qsteps, method, partition_limit)
    try_i4 = 1 if _try else 0
    # Note: with two-pass probability adaptation the marginal rate saved
    # by lowering a level is near zero, so trellis trades PSNR for very
    # few bits; it is reserved for the smallest-size method setting.
    use_trellis = method >= 6 and trellis_probs is not None
    if use_trellis:
        from .cost import trellis_cost_tables

        tp0, tp1, tval = trellis_cost_tables(trellis_probs)
        tp0 = np.ascontiguousarray(tp0)
        tp1 = np.ascontiguousarray(tp1)
        tval = np.ascontiguousarray(tval)
        qs_for_lam = (seg["quants"] if seg is not None else [q] * 4)
        lambdas = np.array(
            [max(1, (TRELLIS_LAMBDA_NUM * s.y1_ac.q * s.y1_ac.q)
                 >> TRELLIS_LAMBDA_SHIFT) for s in qs_for_lam],
            np.int32,
        )
    else:
        # Default-proba cost tables still drive the exact token-rate
        # model in the i4/i16 decision (no trellis without adaptation).
        tp0, tp1, tval = _default_cost_tables()

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    lib.wtpu_vp8_encode_frame(
        p(ys, ctypes.c_uint8), p(us, ctypes.c_uint8), p(vs, ctypes.c_uint8),
        mb_w, mb_h, p(qsteps, ctypes.c_int32),
        try_i4, p(np.ascontiguousarray(i4_penalties), ctypes.c_int32),
        int(use_derr),
        p(seg_arr, ctypes.c_uint8) if seg_arr is not None else None,
        p(tp0, ctypes.c_uint16),
        p(tp1, ctypes.c_uint16),
        p(tval, ctypes.c_uint16),
        p(lambdas, ctypes.c_int32) if use_trellis else None,
        p(y2, ctypes.c_int16), p(yl, ctypes.c_int16), p(uvl, ctypes.c_int16),
        p(ymode, ctypes.c_uint8), p(uvmode, ctypes.c_uint8),
        p(is_i4, ctypes.c_uint8), p(imodes, ctypes.c_uint8),
        p(yr, ctypes.c_uint8), p(ur, ctypes.c_uint8), p(vr, ctypes.c_uint8),
    )
    return {
        "y2": y2, "yl": yl, "uvl": uvl,
        "is_i4": is_i4, "imodes": imodes,
        "ymode": ymode, "uvmode": uvmode,
    }


def emit_frame_arrays(y2, yl, uvl, is_i4, ymodes, uvmodes,
                      mb_w: int, mb_h: int, width: int, height: int,
                      base_q: int, config: EncoderConfig,
                      imodes=None, stats=None, seg=None,
                      filter_level=None) -> bytes | None:
    """Array-driven emission via the native tokenizer (None w/o lib)."""
    from types import SimpleNamespace

    native = _native_tokenizer_arrays(y2, yl, uvl, is_i4, mb_w, mb_h)
    if native is None:
        return None
    skip_flags = native["skip"]
    ymodes_f = np.asarray(ymodes).reshape(-1)
    uvmodes_f = np.asarray(uvmodes).reshape(-1)
    is_i4_f = np.asarray(is_i4).reshape(-1)
    imodes_f = (np.asarray(imodes).reshape(-1, 16)
                if imodes is not None else None)
    fast = _finish_frame_native(
        native, y2, yl, uvl, is_i4, ymodes, uvmodes, imodes,
        mb_w, mb_h, width, height, base_q, config, stats, seg, filter_level,
    )
    if fast is not None:
        return fast
    seg_map = seg["map"] if seg is not None else None
    mbs = [
        [
            SimpleNamespace(
                skip=bool(skip_flags[my * mb_w + mx]),
                ymode=int(ymodes_f[my * mb_w + mx]),
                uvmode=int(uvmodes_f[my * mb_w + mx]),
                is_i4=bool(is_i4_f[my * mb_w + mx]),
                imodes=(imodes_f[my * mb_w + mx]
                        if imodes_f is not None else None),
                segment=(int(seg_map[my * mb_w + mx])
                         if seg_map is not None else 0),
            )
            for mx in range(mb_w)
        ]
        for my in range(mb_h)
    ]
    return _finish_frame(native, mbs, mb_w, mb_h, width, height, base_q,
                         config, stats=stats, seg=seg,
                         filter_level=filter_level)


def _finish_frame_native(native, y2, yl, uvl, is_i4, ymodes, uvmodes,
                         imodes, mb_w, mb_h, width, height, base_q, config,
                         stats, seg, filter_level):
    """All-native emission: headers (Python) + modes + tokens (C++)."""
    import ctypes

    from ...entropy.native_loader import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "wtpu_vp8_write_modes"):
        return None
    total = mb_w * mb_h
    skip_flags = np.ascontiguousarray(native["skip"], np.uint8)
    probs, updates = finalize_probas(native["stats"])
    n_skip = int(skip_flags.sum())
    use_skip = n_skip > 0
    skip_p = max(1, min(255, ((total - n_skip) * 255) // total)) if use_skip else 0

    num_parts = 1 << config.partitions
    p0 = BoolEncoder()
    _write_p0_headers(p0, base_q, config, probs, updates, use_skip, skip_p,
                      seg=seg, filter_level=filter_level)
    out_p = ctypes.POINTER(ctypes.c_uint8)()
    out_n = ctypes.c_uint64(0)
    prefix = bytes(p0._buf)

    def u8(a):
        return np.ascontiguousarray(np.asarray(a).reshape(-1), np.uint8)

    ym = u8(ymodes)
    um = u8(uvmodes)
    i4 = u8(is_i4)
    im = (u8(imodes) if imodes is not None else np.zeros(total * 16, np.uint8))
    seg_map = (u8(seg["map"]) if seg is not None else None)
    seg_probs = (np.array(seg["probs"], np.uint8) if seg is not None else None)

    def p8(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) if a is not None else None

    lib.wtpu_vp8_write_modes(
        (ctypes.c_uint8 * len(prefix)).from_buffer_copy(prefix) if prefix
        else None,
        len(prefix), p0.bottom, p0.range, p0.bit_count,
        p8(ym), p8(um), p8(i4), p8(im), p8(skip_flags), p8(seg_map),
        mb_w, mb_h, int(use_skip), skip_p, p8(seg_probs),
        ctypes.byref(out_p), ctypes.byref(out_n),
    )
    part0 = ctypes.string_at(out_p, out_n.value)
    lib.wtpu_free(out_p)
    parts = native["emit"](probs, use_skip, num_parts)

    if stats is not None:
        stats.block_count_skipped = n_skip
        n_i4 = int(i4.sum())
        stats.block_count_i4 = n_i4
        stats.block_count_i16 = total - n_i4
        stats.header_bytes = len(part0)
        stats.residual_bytes = sum(len(pp) for pp in parts)
        stats.quantizer = base_q
        stats.filter_level = filter_level if filter_level is not None else \
            filter_level_from_q(base_q, config.filter_strength,
                                config.filter_sharpness)
        stats.num_partitions = num_parts
        _fill_segment_stats(stats, seg, base_q, total, i4, skip_flags)
    return _frame_bytes(part0, parts, width, height)


def _fill_segment_stats(stats, seg, base_q, total, i4, skip_flags) -> None:
    """Per-segment arrays of WebPAuxStats (webp/stats.go:13-20):
    quantizer, block counts (i4/i16/skip) per segment."""
    if seg is not None:
        seg_flat = np.asarray(seg["map"]).reshape(-1)
        stats.segment_quant = [max(0, min(127, base_q + d))
                               for d in seg["deltas"]]
    else:
        seg_flat = np.zeros(total, np.uint8)
        stats.segment_quant = [base_q] * 4
    i4f = np.asarray(i4).reshape(-1).astype(bool)
    skf = np.asarray(skip_flags).reshape(-1).astype(bool)
    stats.segment_block_i4 = [0] * 4
    stats.segment_block_i16 = [0] * 4
    stats.segment_block_skipped = [0] * 4
    for s in range(4):
        m = seg_flat == s
        stats.segment_block_i4[s] = int((m & i4f).sum())
        stats.segment_block_i16[s] = int((m & ~i4f).sum())
        stats.segment_block_skipped[s] = int((m & skf).sum())


def _finish_frame(native, mbs, mb_w, mb_h, width, height, base_q, config, stats=None, seg=None, filter_level=None):
    """Shared tail: probability finalization, headers, partitions."""
    total = mb_w * mb_h
    probs, updates = finalize_probas(native["stats"])
    n_skip = sum(1 for row in mbs for mb in row if mb.skip)
    use_skip = n_skip > 0
    skip_p = max(1, min(255, ((total - n_skip) * 255) // total)) if use_skip else 0

    num_parts = 1 << config.partitions
    p0 = BoolEncoder()
    _write_p0_headers(p0, base_q, config, probs, updates, use_skip, skip_p,
                      seg=seg, filter_level=filter_level)
    intra_t = np.zeros(4 * mb_w, np.int32)
    seg_probs = seg["probs"] if seg is not None else None
    for mb_y in range(mb_h):
        intra_l = np.zeros(4, np.int32)
        for mb_x in range(mb_w):
            _write_mode(p0, mbs[mb_y][mb_x], use_skip, skip_p,
                        intra_t[4 * mb_x : 4 * mb_x + 4], intra_l,
                        seg_probs=seg_probs)
    part0 = p0.finish()
    parts = native["emit"](probs, use_skip, num_parts)
    if stats is not None:
        stats.block_count_skipped = n_skip
        n_i4 = sum(1 for row in mbs for mb in row if getattr(mb, "is_i4", False))
        stats.block_count_i4 = n_i4
        stats.block_count_i16 = total - n_i4
        stats.header_bytes = len(part0)
        stats.residual_bytes = sum(len(p) for p in parts)
        stats.quantizer = base_q
        stats.filter_level = filter_level_from_q(
            base_q, config.filter_strength, config.filter_sharpness
        )
        stats.num_partitions = num_parts
        i4_arr = np.array([[getattr(mb, "is_i4", False) for mb in row]
                           for row in mbs], np.uint8)
        _fill_segment_stats(stats, seg, base_q, total, i4_arr,
                            native["skip"])
    return _frame_bytes(part0, parts, width, height)


def _write_p0_headers(p0, base_q, config, probs, updates, use_skip, skip_p,
                      seg=None, filter_level=None):
    p0.put_flag(0)  # color space
    p0.put_flag(0)  # clamp type
    if seg is None:
        p0.put_flag(0)  # no segmentation
    else:
        p0.put_flag(1)  # use_segment
        p0.put_flag(1)  # update_map
        p0.put_flag(1)  # update data
        p0.put_flag(0)  # absolute_delta = 0 (deltas relative to base q)
        for s in range(4):
            d = seg["deltas"][s]
            if d:
                p0.put_flag(1)
                p0.put_signed_literal(d, 7)
            else:
                p0.put_flag(0)
        for s in range(4):  # filter strength deltas: none
            p0.put_flag(0)
        for pr in seg["probs"]:
            if pr != 255:
                p0.put_flag(1)
                p0.put_literal(pr, 8)
            else:
                p0.put_flag(0)
    if filter_level is None:
        filter_level = filter_level_from_q(
            base_q, config.filter_strength, config.filter_sharpness
        )
    p0.put_flag(0 if config.filter_type else 1)
    p0.put_literal(filter_level, 6)
    p0.put_literal(config.filter_sharpness, 3)
    p0.put_flag(0)  # no lf deltas
    p0.put_literal(config.partitions, 2)  # log2(token partitions)
    p0.put_literal(base_q, 7)
    for _ in range(5):
        p0.put_flag(0)
    p0.put_flag(1)  # refresh entropy probs
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    if updates[t, b, c, p]:
                        p0.put_bit(1, int(COEFF_UPDATE_PROBAS[t, b, c, p]))
                        p0.put_literal(int(probs[t, b, c, p]), 8)
                    else:
                        p0.put_bit(0, int(COEFF_UPDATE_PROBAS[t, b, c, p]))
    p0.put_flag(1 if use_skip else 0)
    if use_skip:
        p0.put_literal(skip_p, 8)


def _frame_bytes(part0, parts, width, height):
    if isinstance(parts, (bytes, bytearray)):
        parts = [parts]
    tag = (0) | (0 << 1) | (1 << 4) | (len(part0) << 5)
    sizes = b"".join(
        bytes((len(p) & 0xFF, (len(p) >> 8) & 0xFF, (len(p) >> 16) & 0xFF))
        for p in parts[:-1]
    )
    return bytes(
        (
            tag & 0xFF, (tag >> 8) & 0xFF, (tag >> 16) & 0xFF,
            0x9D, 0x01, 0x2A,
            width & 0xFF, (width >> 8) & 0x3F,
            height & 0xFF, (height >> 8) & 0x3F,
        )
    ) + part0 + sizes + b"".join(parts)


def _native_tokenizer(mbs, mb_w: int, mb_h: int):
    """Flatten MB levels and run the C++ stats pass; returns None w/o lib."""
    from ...entropy.native_loader import get_lib

    if get_lib() is None:
        return None
    total = mb_w * mb_h
    y2 = np.zeros((total, 16), np.int16)
    yl = np.zeros((total, 16, 16), np.int16)
    uvl = np.zeros((total, 8, 16), np.int16)
    is_i4 = np.zeros(total, np.uint8)
    for my in range(mb_h):
        for mx in range(mb_w):
            m = my * mb_w + mx
            mb = mbs[my][mx]
            if mb.y2_levels is not None:
                y2[m] = mb.y2_levels
            yl[m] = mb.y_levels
            uvl[m] = mb.uv_levels
            is_i4[m] = 0
    return _native_tokenizer_arrays(y2, yl, uvl, is_i4, mb_w, mb_h)


def _native_tokenizer_arrays(y2, yl, uvl, is_i4, mb_w: int, mb_h: int):
    import ctypes

    from ...entropy.native_loader import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "wtpu_vp8_token_stats"):
        return None
    total = mb_w * mb_h
    y2 = np.ascontiguousarray(np.asarray(y2).reshape(total, 16), np.int16)
    yl = np.ascontiguousarray(np.asarray(yl).reshape(total, 16, 16), np.int16)
    uvl = np.ascontiguousarray(np.asarray(uvl).reshape(total, 8, 16), np.int16)
    is_i4 = np.ascontiguousarray(np.asarray(is_i4).reshape(total), np.uint8)

    stats = np.zeros((4, 8, 3, 11, 2), np.int64)
    skip = np.zeros(total, np.uint8)

    def i16p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))

    def u8p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    lib.wtpu_vp8_token_stats(
        i16p(y2), i16p(yl), i16p(uvl), u8p(is_i4), mb_w, mb_h,
        stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), u8p(skip),
    )

    def emit(probs, use_skip, num_parts=1):
        probs_c = np.ascontiguousarray(probs, np.uint8)
        out_p = ctypes.POINTER(ctypes.c_uint8)()
        total = ctypes.c_uint64(0)
        sizes = np.zeros(num_parts, np.uint64)
        lib.wtpu_vp8_token_emit_multi(
            i16p(y2), i16p(yl), i16p(uvl), u8p(is_i4), mb_w, mb_h,
            u8p(probs_c), int(use_skip), u8p(skip), num_parts,
            ctypes.byref(out_p),
            sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ctypes.byref(total),
        )
        data = ctypes.string_at(out_p, total.value)
        lib.wtpu_free(out_p)
        parts = []
        off = 0
        for s in sizes:
            parts.append(data[off : off + int(s)])
            off += int(s)
        return parts

    return {"stats": stats, "skip": skip, "emit": emit}


def _fill_borders(Y, U, V, ybuf, ubuf, vbuf, mb_x, mb_y, mb_w):
    have_top = mb_y > 0
    have_left = mb_x > 0
    if have_top:
        ybuf[0, 1:17] = Y[mb_y * 16 - 1, mb_x * 16 : mb_x * 16 + 16]
        if mb_x < mb_w - 1:
            ybuf[0, 17:21] = Y[mb_y * 16 - 1, mb_x * 16 + 16 : mb_x * 16 + 20]
        else:
            ybuf[0, 17:21] = Y[mb_y * 16 - 1, mb_x * 16 + 15]
        ubuf[0, 1:9] = U[mb_y * 8 - 1, mb_x * 8 : mb_x * 8 + 8]
        vbuf[0, 1:9] = V[mb_y * 8 - 1, mb_x * 8 : mb_x * 8 + 8]
        if have_left:
            ybuf[0, 0] = Y[mb_y * 16 - 1, mb_x * 16 - 1]
            ubuf[0, 0] = U[mb_y * 8 - 1, mb_x * 8 - 1]
            vbuf[0, 0] = V[mb_y * 8 - 1, mb_x * 8 - 1]
        else:
            ybuf[0, 0] = 129
            ubuf[0, 0] = 129
            vbuf[0, 0] = 129
    else:
        ybuf[0, :] = 127
        ubuf[0, :] = 127
        vbuf[0, :] = 127
    if have_left:
        ybuf[1:17, 0] = Y[mb_y * 16 : mb_y * 16 + 16, mb_x * 16 - 1]
        ubuf[1:9, 0] = U[mb_y * 8 : mb_y * 8 + 8, mb_x * 8 - 1]
        vbuf[1:9, 0] = V[mb_y * 8 : mb_y * 8 + 8, mb_x * 8 - 1]
    else:
        ybuf[1:17, 0] = 129
        ubuf[1:9, 0] = 129
        vbuf[1:9, 0] = 129


def analyze_segments(y, mb_w: int, mb_h: int, num_segments: int,
                     sns_strength: int, base_q: int = 64):
    """Per-MB activity → segment map + quantizer deltas.

    The reference's VP8EncAnalyze/AssignSegments (analysis_enc.c.go:139,
    431): 1-D clustering of a susceptibility metric, re-done with a
    vectorized activity measure and quantile split.
    """
    ya = np.asarray(y, np.int32)
    H, W = mb_h * 16, mb_w * 16
    lap = np.abs(
        4 * ya[1:-1, 1:-1] - ya[:-2, 1:-1] - ya[2:, 1:-1]
        - ya[1:-1, :-2] - ya[1:-1, 2:]
    )
    lap = np.pad(lap, 1)[:H, :W]
    act = lap.reshape(mb_h, 16, mb_w, 16).mean(axis=(1, 3)).reshape(-1)
    return segments_from_activity(act, num_segments, sns_strength, base_q)


def segments_from_activity(act, num_segments: int, sns_strength: int,
                           base_q: int):
    """Per-MB activity vector (float64) → (seg_map, deltas).

    Split out of `analyze_segments` so the batch pipeline can feed it
    activity *sums* computed on-device (exact int32; act = sums / 256)
    and get bit-identical segmentation to the host path.
    """
    num_segments = max(1, int(num_segments))
    # 1-D k-means on activity (reference AssignSegments' centroid fit):
    # segments follow the actual activity clusters instead of fixed
    # population quartiles, so mostly-flat images put most MBs in the
    # cheap segment.
    qs = np.quantile(act, [(2 * s + 1) / (2 * num_segments)
                           for s in range(num_segments)])
    centers = np.unique(qs).astype(np.float64)
    for _ in range(8):
        assign = np.abs(act[:, None] - centers[None, :]).argmin(axis=1)
        new = np.array([
            act[assign == k].mean() if (assign == k).any() else centers[k]
            for k in range(len(centers))
        ])
        if np.allclose(new, centers):
            break
        centers = new
    order = np.argsort(centers)
    rank_of = np.empty_like(order)
    rank_of[order] = np.arange(len(order))
    seg_map = rank_of[assign].astype(np.uint8)
    centers = centers[order]

    # Asymmetric quantizer spread (reference SetSegmentParams shape):
    # flat segments get a deep discount (cheap PSNR on smooth areas),
    # busy segments a coarser step (masked detail, expensive bits).
    n = len(centers)
    if n > 1:
        a_norm = (centers - centers[0]) / max(1e-9, centers[-1] - centers[0])
    else:
        a_norm = np.zeros(1)
    # Scale the spread by how heterogeneous the image actually is: a
    # uniformly-textured photo keeps a near-flat quantizer, a graphics
    # image with flat fills + hard edges gets a wide one.
    rel = float((centers[-1] - centers[0]) / (centers[-1] + 8.0))
    s = min(100, sns_strength) / 50.0
    amp_lo = 0.45 * s * rel
    amp_hi = 0.50 * s * rel
    raw = np.array([
        base_q * (amp_hi * a - amp_lo * (1.0 - a)) for a in a_norm
    ])
    # Rate-neutral centering: shift the spread so the MB-population-
    # weighted mean quantizer stays at base_q.  Without it, whichever
    # side of the spread holds most MBs drags the whole image's rate
    # up or down (measured +3.5% size on a mid-activity corpus) —
    # segmentation should redistribute bits, not add them.
    counts = np.bincount(seg_map, minlength=n)[:n].astype(np.float64)
    raw -= float((counts * raw).sum() / max(1.0, counts.sum()))
    deltas = [int(round(d)) for d in raw]
    # Low relative activity spread = the quantiles split measurement
    # noise, not maskable structure (uniform-texture corpus: rel≈0.09
    # vs ≈0.8 for flat-fill graphics).  Masking noise costs PSNR and
    # the segment-id header (~2 bits/MB) with no rate win (measured
    # -0.4 dB / +1-3% size), so collapse to a single segment.
    if rel < 0.25 or max(deltas) - min(deltas) <= 2:
        deltas = [0] * n
    deltas += [0] * (4 - n)
    return seg_map, deltas


def _segment_tree_probs(seg_map: np.ndarray):
    counts = np.bincount(seg_map, minlength=4)
    total = counts.sum()
    lo = counts[0] + counts[1]
    p0 = int(np.clip(lo * 255 // max(1, total), 1, 255))
    p1 = int(np.clip(counts[0] * 255 // max(1, lo), 1, 255)) if lo else 255
    hi = counts[2] + counts[3]
    p2 = int(np.clip(counts[2] * 255 // max(1, hi), 1, 255)) if hi else 255
    return [p0, p1, p2]


def _autofilter(payload_webp_frame, y_src, width, height, base_q,
                config: EncoderConfig) -> int | None:
    """Pick the loop-filter level maximizing decoded luma PSNR.

    Reference: VP8AdjustFilterStrength's lf_stats trials
    (filter_enc.c.go:34-73) — here done against the actual decode.
    """
    from .decoder import decode_vp8_yuv

    base = filter_level_from_q(base_q, config.filter_strength,
                               config.filter_sharpness)
    cands = sorted({0, base // 2, base, min(63, base + base // 2 + 1),
                    min(63, 2 * base + 1)})
    best_level, best_err = None, None
    ref = np.asarray(y_src, np.float64)
    for lvl in cands:
        dy, _, _ = decode_vp8_yuv(payload_webp_frame,
                                  filter_level_override=lvl)
        err = ((dy[: height, : width] - ref[: height, : width]) ** 2).sum()
        if best_err is None or err < best_err:
            best_err, best_level = err, lvl
    return best_level


def _rate_controlled_encode(y, u, v, w, h, config: EncoderConfig) -> bytes:
    """Multi-pass quantizer search toward target_size / target_psnr.

    The reference's StatLoop/ComputeNextQ secant search (SURVEY.md §2.5
    "Multi-pass rate control"), re-done as bisection over the quantizer
    index with the fast native dense phase per trial.
    """
    lo = config.qmin * 127 // 100
    hi = max(lo + 1, config.qmax * 127 // 100)
    passes = max(4, config.passes)
    best_under = None          # (size, payload): largest size <= target
    best_any = None            # (score, payload): closest overall

    for _ in range(passes):
        q = (lo + hi) // 2
        payload = encode_vp8_frame(y, u, v, w, h, config, base_q=q)
        if config.target_size > 0:
            size = len(payload)
            if size <= config.target_size:
                if best_under is None or size > best_under[0]:
                    best_under = (size, payload)
                hi = q          # try finer quantization (bigger file)
            else:
                lo = q + 1      # too big: quantize harder
            if best_any is None or abs(size - config.target_size) < best_any[0]:
                best_any = (abs(size - config.target_size), payload)
        else:
            from .decoder import decode_vp8_yuv

            dy, du, dv = decode_vp8_yuv(payload)
            se = 0.0
            n = 0
            for dec, srcp in ((dy, y), (du, u), (dv, v)):
                ref = np.asarray(srcp[: dec.shape[0], : dec.shape[1]], np.float64)
                se += ((dec - ref) ** 2).sum()
                n += dec.size
            mse = max(se / n, 1e-9)
            m = 10.0 * np.log10(255.0**2 / mse)
            if m >= config.target_psnr:
                if best_under is None or len(payload) < best_under[0]:
                    best_under = (len(payload), payload)
                lo = q + 1      # quality met: try harder quantization
            else:
                hi = q
            if best_any is None or abs(m - config.target_psnr) < best_any[0]:
                best_any = (abs(m - config.target_psnr), payload)
        if lo >= hi:
            break
    if best_under is not None:
        return best_under[1]
    if best_any is not None:
        return best_any[1]
    return encode_vp8_frame(y, u, v, w, h, config)


def encode_vp8_frame_device(y, u, v, width, height,
                            config: EncoderConfig) -> bytes:
    """Dense phase on the device, emission on host.

    plane_backend "jax" uses the exact closed-loop wavefront engine
    (bit-identical to the sequential host encoder, including the i4
    mode search at method >= 4 and per-segment quantizers);
    "jax-openloop" uses the fully-parallel open-loop engine (fastest,
    slight drift).
    """
    base_q = quality_to_q(config.quality)
    base_q = max(config.qmin * 127 // 100, min(config.qmax * 127 // 100, base_q))
    q = make_quants(base_q)
    mb_w = y.shape[1] // 16
    mb_h = y.shape[0] // 16

    if config.plane_backend == "jax":
        import jax.numpy as jnp

        from ...ops.encode_wavefront_jax import encode_wavefront_core

        seg = None
        if config.segments > 1:
            seg_map, deltas = analyze_segments(
                y, mb_w, mb_h, config.segments, config.sns_strength, base_q
            )
            if len(set(deltas[: config.segments])) > 1:
                seg = {
                    "map": seg_map,
                    "deltas": deltas,
                    "probs": _segment_tree_probs(seg_map),
                    "quants": [make_quants(max(0, min(127, base_q + d)))
                               for d in deltas],
                }

        def qrow(sq):
            return (sq.y1_dc.q, sq.y1_ac.q, sq.y2_dc.q, sq.y2_ac.q,
                    sq.uv_dc.q, sq.uv_ac.q)

        if seg is not None:
            qsteps = np.array([qrow(s) for s in seg["quants"]], np.int32)
            seg_arr = np.asarray(seg["map"], np.int32).reshape(mb_h, mb_w)
        else:
            qsteps = np.array([qrow(q)] * 4, np.int32)
            seg_arr = np.zeros((mb_h, mb_w), np.int32)
        tp0, tp1, tval = _default_cost_tables()
        tables = tuple(jnp.asarray(t.astype(np.int32))
                       for t in (tp0, tp1, tval))
        _try_i4, _i4_pens = _i4_config_seg(qsteps, config.method,
                                           config.partition_limit)
        out = encode_wavefront_core(
            np.asarray(y, np.int32)[None],
            np.asarray(u, np.int32)[None],
            np.asarray(v, np.int32)[None],
            seg_arr[None], qsteps[None], tables,
            try_i4=_try_i4, i4_penalty=_i4_pens[None],
            use_derr=config.quality <= ERROR_DIFFUSION_QUALITY,
        )
        ymode = np.asarray(out["ymode"])[0]
        uvmode = np.asarray(out["uvmode"])[0]
        y_levels = np.asarray(out["y_levels"])[0].reshape(-1, 16, 16)
        y2_levels = np.asarray(out["y2_levels"])[0].reshape(-1, 16)
        uv_levels = np.asarray(out["uv_levels"])[0].reshape(-1, 8, 16)
        is_i4 = np.asarray(out["is_i4"])[0].reshape(-1)
        imodes = np.asarray(out["imodes"])[0].reshape(-1, 16)
        fast = emit_frame_arrays(
            y2_levels, y_levels, uv_levels, is_i4, ymode, uvmode,
            mb_w, mb_h, width, height, base_q, config,
            imodes=imodes, seg=seg,
        )
        if fast is not None and config.autofilter:
            best = _autofilter(fast, y, width, height, base_q, config)
            if best is not None:
                fast = emit_frame_arrays(
                    y2_levels, y_levels, uv_levels, is_i4, ymode, uvmode,
                    mb_w, mb_h, width, height, base_q, config,
                    imodes=imodes, seg=seg, filter_level=best,
                )
        if fast is not None:
            return fast
        # No native tokenizer: the legacy Python emitter below cannot
        # code i4/segment streams — take the host path instead.
        return encode_vp8_frame(y, u, v, width, height, config)

    from ...ops.encode_plane_jax import encode_plane_step as _step

    out = _step(
        np.asarray(y, np.int32)[None],
        np.asarray(u, np.int32)[None],
        np.asarray(v, np.int32)[None],
        y1_dc=q.y1_dc.q, y1_ac=q.y1_ac.q,
        y2_dc=q.y2_dc.q, y2_ac=q.y2_ac.q,
        uv_dc=q.uv_dc.q, uv_ac=q.uv_ac.q,
    )
    ymode = np.asarray(out["ymode"])[0]
    uvmode = np.asarray(out["uvmode"])[0]
    y_levels = np.asarray(out["y_levels"])[0]
    y2_levels = np.asarray(out["y2_levels"])[0]
    uv_levels = np.asarray(out["uv_levels"])[0]
    mb_h, mb_w = ymode.shape
    fast = emit_frame_arrays(
        y2_levels, y_levels, uv_levels,
        np.zeros(mb_h * mb_w, np.uint8), ymode, uvmode,
        mb_w, mb_h, width, height, base_q, config,
    )
    if fast is not None:
        return fast
    mbs = [[MBEnc() for _ in range(mb_w)] for _ in range(mb_h)]
    for my in range(mb_h):
        for mx in range(mb_w):
            mb = mbs[my][mx]
            mb.ymode = int(ymode[my, mx])
            mb.uvmode = int(uvmode[my, mx])
            mb.y_levels = y_levels[my, mx]
            mb.y2_levels = y2_levels[my, mx].reshape(16)
            mb.uv_levels = uv_levels[my, mx]
    return emit_frame(mbs, mb_w, mb_h, width, height, base_q, config)


def encode_vp8_webp(rgba: np.ndarray, config: EncoderConfig, stats=None) -> bytes:
    """(H, W, 3|4) uint8 → complete .webp bytes (lossy, + ALPH if needed)."""
    rgba = np.asarray(rgba)
    if rgba.ndim != 3 or rgba.shape[2] not in (3, 4):
        raise EncodeError("expected (H, W, 3|4) array")
    h, w = rgba.shape[:2]
    has_alpha = rgba.shape[2] == 4 and bool((rgba[..., 3] != 255).any())

    if config.use_sharp_yuv or (config.preprocessing & 4):
        y, u, v = rgb_to_yuv420_sharp(rgba)
    elif config.preprocessing & 2:
        # Dither amplitude: max at q0, 0.5 at q100 (webp_encoding.go:56-61).
        x = config.quality / 100.0
        y, u, v = rgb_to_yuv420_dithered(rgba, 1.0 - 0.5 * x ** 4)
    else:
        y, u, v = rgb_to_yuv420(rgba)
    y = _pad_to_mb(y, 16)
    u = _pad_to_mb(u, 8)
    v = _pad_to_mb(v, 8)
    if config.plane_backend in ("jax", "jax-openloop"):
        payload = encode_vp8_frame_device(y, u, v, w, h, config)
    elif config.target_size > 0 or config.target_psnr > 0:
        payload = _rate_controlled_encode(y, u, v, w, h, config)
    else:
        payload = encode_vp8_frame(y, u, v, w, h, config, stats=stats)
    if stats is not None:
        from .decoder import decode_vp8_yuv
        from ...utils.metrics import psnr as _psnr

        dy, du, dv = decode_vp8_yuv(payload)
        stats.psnr = {
            "y": _psnr(dy, np.asarray(y[: dy.shape[0], : dy.shape[1]])),
            "u": _psnr(du, np.asarray(u[: du.shape[0], : du.shape[1]])),
            "v": _psnr(dv, np.asarray(v[: dv.shape[0], : dv.shape[1]])),
        }

    if not has_alpha:
        return assemble_simple(Chunk(CHUNK_VP8, payload))
    from .alpha import encode_alpha

    alpha_payload = encode_alpha(
        rgba[..., 3],
        method=config.alpha_compression,
        quality=config.alpha_quality,
        filtering_level=config.alpha_filtering,
    )
    if stats is not None:
        stats.alpha_data_size = len(alpha_payload)
    return assemble(
        [
            build_vp8x(w, h, has_alpha=True),
            Chunk(CHUNK_ALPHA, alpha_payload),
            Chunk(CHUNK_VP8, payload),
        ]
    )


__all__ = ["encode_vp8_webp", "encode_vp8_frame", "rgb_to_yuv420", "quality_to_q"]
