"""VP8 (WebP lossy) decoder — spec-exact reference implementation.

Split per the array-first design (SURVEY.md §7): the *host phase* here runs
the sequential entropy decode (boolean coder) and produces dense per-MB
tensors — dequantized coefficients, modes, filter info.  The *plane phase*
(reconstruction, loop filter, upsampling) is pure array math; the NumPy
versions in this file are the golden reference for the JAX engine in
gowebp_tpu/ops/vp8_recon_jax.py.

Feature parity target: /root/reference/pkg/vp8/vp8_dec.go (headers
:362-484, residuals :485-705, frame loop :750-817) and
pkg/libwebp/decoder/frame_dec.c.go (ReconstructRow :69-197, filters
:204-261) — written from RFC 6386 with the reference as the spec oracle.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ...constants import VP8_SIGNATURE
from ...entropy.bool_coder import BoolDecoder
from ...errors import BitstreamError, UnsupportedFeature
from ...ops import yuv_np
from . import dsp_np
from .tables import (
    BANDS,
    BMODE_TREE,
    CAT_PROBAS,
    COEFF_PROBAS,
    COEFF_UPDATE_PROBAS,
    DC_QUANT,
    AC_QUANT,
    KF_BMODE_PROBAS,
    ZIGZAG,
    B_DC,
    B_TM,
    B_VE,
    B_HE,
)

# ---------------------------------------------------------------------------
# Headers
# ---------------------------------------------------------------------------


@dataclass
class SegmentHeader:
    use_segment: bool = False
    update_map: bool = False
    absolute_delta: bool = True
    quantizer: list = field(default_factory=lambda: [0] * 4)
    filter_strength: list = field(default_factory=lambda: [0] * 4)


@dataclass
class FilterHeader:
    simple: bool = False
    level: int = 0
    sharpness: int = 0
    use_lf_delta: bool = False
    ref_lf_delta: list = field(default_factory=lambda: [0] * 4)
    mode_lf_delta: list = field(default_factory=lambda: [0] * 4)


@dataclass
class QuantMatrix:
    y1_dc: int = 0
    y1_ac: int = 0
    y2_dc: int = 0
    y2_ac: int = 0
    uv_dc: int = 0
    uv_ac: int = 0
    uv_quant: int = 0   # unclamped uv AC index, for dithering strength


@dataclass
class FrameState:
    width: int = 0
    height: int = 0
    mb_w: int = 0
    mb_h: int = 0
    segment_hdr: SegmentHeader = field(default_factory=SegmentHeader)
    filter_hdr: FilterHeader = field(default_factory=FilterHeader)
    filter_type: int = 0            # 0=none, 1=simple, 2=complex
    dqm: list = field(default_factory=list)        # QuantMatrix per segment
    segment_probs: list = field(default_factory=lambda: [255] * 3)
    coeff_probs: np.ndarray | None = None           # (4,8,3,11)
    use_skip_proba: bool = False
    skip_p: int = 0
    partitions: list = field(default_factory=list)  # BoolDecoder per partition
    partition_bytes: list = field(default_factory=list)


def _clip(v, mx):
    return 0 if v < 0 else (mx if v > mx else v)


def parse_frame_header(payload: bytes) -> tuple[FrameState, BoolDecoder]:
    """Parse the uncompressed frame tag + first partition headers."""
    if len(payload) < 10:
        raise BitstreamError("VP8 payload too small")
    tag = payload[0] | (payload[1] << 8) | (payload[2] << 16)
    if tag & 1:
        raise UnsupportedFeature("not a key frame")
    show = (tag >> 4) & 1
    part0_len = tag >> 5
    if not show:
        raise UnsupportedFeature("non-displayable frame")
    if ((payload[3] << 16) | (payload[4] << 8) | payload[5]) != VP8_SIGNATURE:
        raise BitstreamError("bad VP8 start code")
    st = FrameState()
    st.width = (payload[6] | (payload[7] << 8)) & 0x3FFF
    st.height = (payload[8] | (payload[9] << 8)) & 0x3FFF
    if st.width == 0 or st.height == 0:
        raise BitstreamError("bad dimensions")
    st.mb_w = (st.width + 15) >> 4
    st.mb_h = (st.height + 15) >> 4

    body = payload[10:]
    if part0_len > len(body):
        raise BitstreamError("bad partition0 length")
    bd = BoolDecoder(body[:part0_len])

    bd.get_flag()  # color_space
    bd.get_flag()  # clamp_type

    # Segment header (RFC 9.3).
    sh = st.segment_hdr
    sh.use_segment = bool(bd.get_flag())
    if sh.use_segment:
        sh.update_map = bool(bd.get_flag())
        if bd.get_flag():  # update data
            sh.absolute_delta = bool(bd.get_flag())
            for s in range(4):
                sh.quantizer[s] = bd.get_signed_literal(7) if bd.get_flag() else 0
            for s in range(4):
                sh.filter_strength[s] = bd.get_signed_literal(6) if bd.get_flag() else 0
        if sh.update_map:
            for s in range(3):
                st.segment_probs[s] = bd.get_literal(8) if bd.get_flag() else 255

    # Filter header (RFC 9.4).
    fh = st.filter_hdr
    fh.simple = bool(bd.get_flag())
    fh.level = bd.get_literal(6)
    fh.sharpness = bd.get_literal(3)
    fh.use_lf_delta = bool(bd.get_flag())
    if fh.use_lf_delta:
        if bd.get_flag():
            for i in range(4):
                if bd.get_flag():
                    fh.ref_lf_delta[i] = bd.get_signed_literal(6)
            for i in range(4):
                if bd.get_flag():
                    fh.mode_lf_delta[i] = bd.get_signed_literal(6)
    st.filter_type = 0 if fh.level == 0 else (1 if fh.simple else 2)

    # Token partitions (RFC 9.5).
    rest = body[part0_len:]
    num_parts = 1 << bd.get_literal(2)
    sizes_bytes = 3 * (num_parts - 1)
    if len(rest) < sizes_bytes:
        raise BitstreamError("cannot read partition sizes")
    pos = sizes_bytes
    st.partitions = []
    for p in range(num_parts - 1):
        psz = rest[3 * p] | (rest[3 * p + 1] << 8) | (rest[3 * p + 2] << 16)
        psz = min(psz, len(rest) - pos)
        st.partition_bytes.append(rest[pos : pos + psz])
        st.partitions.append(BoolDecoder(rest[pos : pos + psz]))
        pos += psz
    st.partition_bytes.append(rest[pos:])
    st.partitions.append(BoolDecoder(rest[pos:]))

    # Quantizers (RFC 9.6).
    base_q0 = bd.get_literal(7)
    dqy1_dc = bd.get_signed_literal(4) if bd.get_flag() else 0
    dqy2_dc = bd.get_signed_literal(4) if bd.get_flag() else 0
    dqy2_ac = bd.get_signed_literal(4) if bd.get_flag() else 0
    dquv_dc = bd.get_signed_literal(4) if bd.get_flag() else 0
    dquv_ac = bd.get_signed_literal(4) if bd.get_flag() else 0
    st.dqm = []
    for s in range(4):
        if sh.use_segment:
            q = sh.quantizer[s] + (0 if sh.absolute_delta else base_q0)
        else:
            q = base_q0
        m = QuantMatrix()
        m.y1_dc = int(DC_QUANT[_clip(q + dqy1_dc, 127)])
        m.y1_ac = int(AC_QUANT[_clip(q, 127)])
        m.y2_dc = int(DC_QUANT[_clip(q + dqy2_dc, 127)]) * 2
        m.y2_ac = max(8, (int(AC_QUANT[_clip(q + dqy2_ac, 127)]) * 101581) >> 16)
        m.uv_dc = int(DC_QUANT[_clip(q + dquv_dc, 117)])
        m.uv_ac = int(AC_QUANT[_clip(q + dquv_ac, 127)])
        m.uv_quant = q + dquv_ac
        st.dqm.append(m)

    # Probability updates (RFC 9.8-9.11) — ~1100 boolean decisions;
    # the native twin parses them in ~10 us vs ~1 ms in Python (this
    # block used to GIL-serialize the batch decoder's thread pool).
    probs = COEFF_PROBAS.copy()
    if not _parse_probs_native(st, bd, probs):
        bd.get_flag()  # refresh_entropy_probs (always for keyframes)
        for t in range(4):
            for b in range(8):
                for c in range(3):
                    for p in range(11):
                        if bd.get_bit(int(COEFF_UPDATE_PROBAS[t, b, c, p])):
                            probs[t, b, c, p] = bd.get_literal(8)
        st.use_skip_proba = bool(bd.get_flag())
        if st.use_skip_proba:
            st.skip_p = bd.get_literal(8)
    st.coeff_probs = probs
    return st, bd


_UPDATE_PROBAS_U8 = None


def _parse_probs_native(st: FrameState, bd, probs: np.ndarray) -> bool:
    """Native coeff-proba block parse; syncs the bool decoder state."""
    import ctypes

    from ...entropy.native_loader import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "wtpu_vp8_parse_probs"):
        return False
    global _UPDATE_PROBAS_U8
    if _UPDATE_PROBAS_U8 is None:
        _UPDATE_PROBAS_U8 = np.ascontiguousarray(
            COEFF_UPDATE_PROBAS, np.uint8).reshape(-1)
    pflat = np.ascontiguousarray(probs, np.uint8).reshape(-1)
    state = np.array([bd.pos, bd.value, bd.range, bd.bit_count], np.uint64)
    data = bd.data if isinstance(bd.data, bytes) else bytes(bd.data)
    dview = np.frombuffer(data, np.uint8)   # zero-copy view
    rc = lib.wtpu_vp8_parse_probs(
        dview.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
        state.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        _UPDATE_PROBAS_U8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        pflat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc < 0:
        raise BitstreamError("truncated frame header")
    probs[...] = pflat.reshape(probs.shape)
    bd.pos, bd.value, bd.range, bd.bit_count = (
        int(state[0]), int(state[1]), int(state[2]), int(state[3]))
    st.use_skip_proba = bool(rc >> 8)
    st.skip_p = rc & 0xFF
    return True


# ---------------------------------------------------------------------------
# Symbol decoding (per-MB modes and coefficients)
# ---------------------------------------------------------------------------


def _parse_intra_mode(bd: BoolDecoder, st: FrameState, top4: np.ndarray,
                      left4: np.ndarray):
    """One MB's segment/skip/modes. Returns (segment, skip, is_i4, imodes, uv)."""
    segment = 0
    if st.segment_hdr.update_map:
        if not bd.get_bit(st.segment_probs[0]):
            segment = bd.get_bit(st.segment_probs[1])
        else:
            segment = 2 + bd.get_bit(st.segment_probs[2])
    skip = bd.get_bit(st.skip_p) if st.use_skip_proba else 0

    imodes = np.zeros(16, np.int32)
    is_i4 = not bd.get_bit(145)
    if not is_i4:
        # Hardcoded 16x16 mode tree (libwebp enum DC/TM/VE/HE).
        if bd.get_bit(156):
            ymode = B_TM if bd.get_bit(128) else B_HE
        else:
            ymode = B_VE if bd.get_bit(163) else B_DC
        imodes[:] = ymode
        top4[:] = ymode
        left4[:] = ymode
    else:
        for y in range(4):
            ymode = left4[y]
            for x in range(4):
                prob = KF_BMODE_PROBAS[top4[x]][ymode]
                i = BMODE_TREE[bd.get_bit(int(prob[0]))]
                while i > 0:
                    i = BMODE_TREE[2 * i + bd.get_bit(int(prob[i]))]
                ymode = -i
                top4[x] = ymode
                imodes[4 * y + x] = ymode
            left4[y] = ymode

    # UV mode tree.
    if not bd.get_bit(142):
        uvmode = B_DC
    elif not bd.get_bit(114):
        uvmode = B_VE
    elif bd.get_bit(183):
        uvmode = B_TM
    else:
        uvmode = B_HE
    return segment, skip, is_i4, imodes, uvmode


def _get_large_value(bd: BoolDecoder, p) -> int:
    if not bd.get_bit(int(p[3])):
        if not bd.get_bit(int(p[4])):
            return 2
        return 3 + bd.get_bit(int(p[5]))
    if not bd.get_bit(int(p[6])):
        if not bd.get_bit(int(p[7])):
            return 5 + bd.get_bit(159)
        return 7 + 2 * bd.get_bit(165) + bd.get_bit(145)
    bit1 = bd.get_bit(int(p[8]))
    bit0 = bd.get_bit(int(p[9 + bit1]))
    cat = 2 * bit1 + bit0
    v = 0
    for tab_p in CAT_PROBAS[cat]:
        v += v + bd.get_bit(tab_p)
    return v + 3 + (8 << cat)


def _get_coeffs(bd: BoolDecoder, probs_t, ctx: int, dq: tuple, first: int,
                out: np.ndarray) -> int:
    """Token-decode one 4x4 block; returns last-nonzero position + 1."""
    p = probs_t[BANDS[first]][ctx]
    n = first
    while n < 16:
        if not bd.get_bit(int(p[0])):
            return n
        while not bd.get_bit(int(p[1])):
            n += 1
            if n == 16:
                return 16
            p = probs_t[BANDS[n]][0]
        if not bd.get_bit(int(p[2])):
            v = 1
            next_ctx = 1
        else:
            v = _get_large_value(bd, p)
            next_ctx = 2
        out[ZIGZAG[n]] = bd.get_signed(v) * dq[n > 0]
        p = probs_t[BANDS[n + 1]][next_ctx]
        n += 1
    return 16


def _nz_code_bits(nz_coeffs: int, nz: int, dc_nz: int) -> int:
    nz_coeffs <<= 2
    nz_coeffs |= 3 if nz > 3 else (2 if nz > 1 else dc_nz)
    return nz_coeffs


@dataclass
class MBData:
    segment: int = 0
    skip: int = 0
    is_i4: bool = False
    imodes: np.ndarray | None = None
    uvmode: int = 0
    coeffs: np.ndarray | None = None     # (25, 16) int32, dequantized
    non_zero_y: int = 0
    non_zero_uv: int = 0
    dither: int = 0                      # 1 = flat chroma, dither-eligible


def _parse_residuals(bd: BoolDecoder, st: FrameState, mb: MBData,
                     ctx_mb, ctx_left) -> bool:
    """Decode all coefficients of one MB; updates nz contexts.

    ctx_mb/ctx_left are 2-element lists [nz, nz_dc] for above/left context.
    Returns True if the whole MB is empty (skippable).
    """
    probs = st.coeff_probs
    q = st.dqm[mb.segment]
    coeffs = np.zeros((25, 16), np.int32)
    first = 0
    if not mb.is_i4:
        dc = np.zeros(16, np.int32)
        ctx = ctx_mb[1] + ctx_left[1]
        nz = _get_coeffs(bd, probs[1], ctx, (q.y2_dc, q.y2_ac), 0, dc)
        ctx_mb[1] = ctx_left[1] = int(nz > 0)
        if nz > 1:
            coeffs[24] = dc
            dcs = dsp_np.iwht4x4(dc)
        else:
            dc0 = (int(dc[0]) + 3) >> 3
            dcs = np.full(16, dc0, np.int32)
        for i in range(16):
            coeffs[i, 0] = dcs[i]
        first = 1
        ac_probs = probs[0]
    else:
        ac_probs = probs[3]

    non_zero_y = 0
    tnz = ctx_mb[0] & 0x0F
    lnz = ctx_left[0] & 0x0F
    for y in range(4):
        l = lnz & 1
        nz_coeffs = 0
        for x in range(4):
            ctx = l + (tnz & 1)
            blk = coeffs[4 * y + x]
            nz = _get_coeffs(bd, ac_probs, ctx, (q.y1_dc, q.y1_ac), first, blk)
            l = int(nz > first)
            tnz = (tnz >> 1) | (l << 7)
            nz_coeffs = _nz_code_bits(nz_coeffs, nz, int(blk[0] != 0))
        tnz >>= 4
        lnz = (lnz >> 1) | (l << 7)
        non_zero_y = (non_zero_y << 8) | nz_coeffs
    out_t_nz = tnz
    out_l_nz = lnz >> 4

    non_zero_uv = 0
    for ch in range(0, 4, 2):
        nz_coeffs = 0
        tnz = (ctx_mb[0] >> (4 + ch)) & 0xFF
        lnz = (ctx_left[0] >> (4 + ch)) & 0xFF
        for y in range(2):
            l = lnz & 1
            for x in range(2):
                ctx = l + (tnz & 1)
                blk = coeffs[16 + 2 * ch + 2 * y + x]
                nz = _get_coeffs(bd, probs[2], ctx, (q.uv_dc, q.uv_ac), 0, blk)
                l = int(nz > 0)
                tnz = (tnz >> 1) | (l << 3)
                nz_coeffs = _nz_code_bits(nz_coeffs, nz, int(blk[0] != 0))
            tnz >>= 2
            lnz = (lnz >> 1) | (l << 5)
        non_zero_uv |= nz_coeffs << (4 * ch)
        out_t_nz |= ((tnz << 4) << ch) & 0xFFFFFFFF
        out_l_nz |= (lnz & 0xF0) << ch
    ctx_mb[0] = out_t_nz
    ctx_left[0] = out_l_nz

    mb.coeffs = coeffs
    mb.non_zero_y = non_zero_y
    mb.non_zero_uv = non_zero_uv
    # Dither only flat-chroma MBs: no uv block with coeffs beyond the
    # first (reference vp8_dec.go:693-699, mask 0xAAAA = code>=2 bits).
    mb.dither = 0 if (non_zero_uv & 0xAAAA) else 1
    return (non_zero_y | non_zero_uv) == 0


# ---------------------------------------------------------------------------
# Reconstruction (plane phase — NumPy reference)
# ---------------------------------------------------------------------------

# Position of the n-th luma 4x4 sub-block inside the MB.
_SCAN = [(4 * (n >> 2), 4 * (n & 3)) for n in range(16)]


def _reconstruct(st: FrameState, mbs: list[list[MBData]]):
    """Raster-order intra prediction + inverse transform (unfiltered)."""
    mb_w, mb_h = st.mb_w, st.mb_h
    W, H = mb_w * 16, mb_h * 16
    Y = np.zeros((H, W), np.int64)
    U = np.zeros((H // 2, W // 2), np.int64)
    V = np.zeros((H // 2, W // 2), np.int64)

    # Working buffers with a 1-px top/left border (plus 4 top-right for Y).
    for mb_y in range(mb_h):
        for mb_x in range(mb_w):
            mb = mbs[mb_y][mb_x]
            ybuf = np.empty((17, 21), np.int64)
            ubuf = np.empty((9, 9), np.int64)
            vbuf = np.empty((9, 9), np.int64)
            have_top = mb_y > 0
            have_left = mb_x > 0

            # Top border row (17.. incl 4 top-right) and left border col.
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

            coeffs = mb.coeffs
            if mb.is_i4:
                # Replicate top-right below row 0 (for right-column blocks).
                for r in (4, 8, 12):
                    ybuf[r, 17:21] = ybuf[0, 17:21]
                bits = mb.non_zero_y
                for n in range(16):
                    r, c = _SCAN[n]
                    dsp_np.predict_luma4(ybuf, c, r, int(mb.imodes[n]))
                    blkbits = (bits << (2 * n)) & 0xFFFFFFFF
                    _do_transform(blkbits >> 30, coeffs[n],
                                  ybuf[r + 1 : r + 5, c + 1 : c + 5])
            else:
                dsp_np.predict_block(ybuf, 0, 0, 16, int(mb.imodes[0]),
                                     have_top, have_left)
                bits = mb.non_zero_y
                if bits:
                    for n in range(16):
                        r, c = _SCAN[n]
                        blkbits = (bits << (2 * n)) & 0xFFFFFFFF
                        _do_transform(blkbits >> 30, coeffs[n],
                                      ybuf[r + 1 : r + 5, c + 1 : c + 5])
            # Chroma.
            dsp_np.predict_block(ubuf, 0, 0, 8, mb.uvmode, have_top, have_left)
            dsp_np.predict_block(vbuf, 0, 0, 8, mb.uvmode, have_top, have_left)
            _do_uv_transform(mb.non_zero_uv >> 0, coeffs[16:20], ubuf)
            _do_uv_transform(mb.non_zero_uv >> 8, coeffs[20:24], vbuf)

            Y[mb_y * 16 : mb_y * 16 + 16, mb_x * 16 : mb_x * 16 + 16] = ybuf[1:17, 1:17]
            U[mb_y * 8 : mb_y * 8 + 8, mb_x * 8 : mb_x * 8 + 8] = ubuf[1:9, 1:9]
            V[mb_y * 8 : mb_y * 8 + 8, mb_x * 8 : mb_x * 8 + 8] = vbuf[1:9, 1:9]
    return Y, U, V


def _do_transform(code: int, coeffs: np.ndarray, dst: np.ndarray) -> None:
    if code == 3:
        dsp_np.idct4x4_add(coeffs, dst)
    elif code == 2:
        # AC3 fast path decodes identically to the full transform.
        dsp_np.idct4x4_add(coeffs, dst)
    elif code == 1:
        dsp_np.idct_dc_add(coeffs[0], dst)


def _do_uv_transform(bits: int, coeffs, buf: np.ndarray) -> None:
    if bits & 0xFF:
        if bits & 0xAA:  # any AC
            for i, (r, c) in enumerate([(0, 0), (0, 4), (4, 0), (4, 4)]):
                dsp_np.idct4x4_add(coeffs[i], buf[r + 1 : r + 5, c + 1 : c + 5])
        else:
            for i, (r, c) in enumerate([(0, 0), (0, 4), (4, 0), (4, 4)]):
                if coeffs[i][0]:
                    dsp_np.idct_dc_add(coeffs[i][0], buf[r + 1 : r + 5, c + 1 : c + 5])


# ---------------------------------------------------------------------------
# Loop filter (NumPy reference, exact MB scan order)
# ---------------------------------------------------------------------------


def _precompute_filter_info(st: FrameState):
    """Per (segment, is_i4): (limit, ilevel, hev_thresh) or None."""
    fh = st.filter_hdr
    info = [[None, None] for _ in range(4)]
    if st.filter_type == 0:
        return info
    for s in range(4):
        if st.segment_hdr.use_segment:
            base = st.segment_hdr.filter_strength[s]
            if not st.segment_hdr.absolute_delta:
                base += fh.level
        else:
            base = fh.level
        for i4 in range(2):
            level = base
            if fh.use_lf_delta:
                level += fh.ref_lf_delta[0]
                if i4:
                    level += fh.mode_lf_delta[0]
            level = _clip(level, 63)
            if level > 0:
                ilevel = level
                if fh.sharpness > 0:
                    ilevel = ilevel >> 2 if fh.sharpness > 4 else ilevel >> 1
                    ilevel = min(ilevel, 9 - fh.sharpness)
                ilevel = max(1, ilevel)
                hev_t = 2 if level >= 40 else (1 if level >= 15 else 0)
                info[s][i4] = (2 * level + ilevel, ilevel, hev_t)
            else:
                info[s][i4] = None
    return info


def _filter_seg_h(plane, y0, y1, x, limit, ilevel, hev_t, edge):
    """Filter the vertical edge at column x, rows [y0,y1) (complex filter)."""
    thresh2 = 2 * limit + 1
    for y in range(y0, y1):
        row = plane[y]
        px = [int(row[x - 4 + k]) for k in range(8)]
        if dsp_np.needs_filter2(px, thresh2, ilevel):
            if dsp_np.hev(px[2], px[3], px[4], px[5], hev_t):
                p1, p0, q0, q1 = dsp_np.do_filter2(px[2:6])
                row[x - 2], row[x - 1], row[x], row[x + 1] = p1, p0, q0, q1
            elif edge:
                vals = dsp_np.do_filter6(px[1:7])
                for k, v in enumerate(vals):
                    row[x - 3 + k] = v
            else:
                vals = dsp_np.do_filter4(px[2:6])
                for k, v in enumerate(vals):
                    row[x - 2 + k] = v


def _filter_seg_v(plane, x0, x1, y, limit, ilevel, hev_t, edge):
    thresh2 = 2 * limit + 1
    for x in range(x0, x1):
        px = [int(plane[y - 4 + k, x]) for k in range(8)]
        if dsp_np.needs_filter2(px, thresh2, ilevel):
            if dsp_np.hev(px[2], px[3], px[4], px[5], hev_t):
                p1, p0, q0, q1 = dsp_np.do_filter2(px[2:6])
                plane[y - 2, x], plane[y - 1, x], plane[y, x], plane[y + 1, x] = p1, p0, q0, q1
            elif edge:
                vals = dsp_np.do_filter6(px[1:7])
                for k, v in enumerate(vals):
                    plane[y - 3 + k, x] = v
            else:
                vals = dsp_np.do_filter4(px[2:6])
                for k, v in enumerate(vals):
                    plane[y - 2 + k, x] = v


def _filter_simple_h(plane, y0, y1, x, limit):
    thresh2 = 2 * limit + 1
    for y in range(y0, y1):
        row = plane[y]
        p1, p0, q0, q1 = int(row[x - 2]), int(row[x - 1]), int(row[x]), int(row[x + 1])
        if dsp_np.needs_filter(p1, p0, q0, q1, thresh2):
            _, np0, nq0, _ = dsp_np.do_filter2((p1, p0, q0, q1))
            row[x - 1], row[x] = np0, nq0


def _filter_simple_v(plane, x0, x1, y, limit):
    thresh2 = 2 * limit + 1
    for x in range(x0, x1):
        p1, p0, q0, q1 = (int(plane[y - 2, x]), int(plane[y - 1, x]),
                          int(plane[y, x]), int(plane[y + 1, x]))
        if dsp_np.needs_filter(p1, p0, q0, q1, thresh2):
            _, np0, nq0, _ = dsp_np.do_filter2((p1, p0, q0, q1))
            plane[y - 1, x], plane[y, x] = np0, nq0


def _loop_filter(st: FrameState, mbs, Y, U, V):
    """In-place deblocking in libwebp's exact MB scan order."""
    if st.filter_type == 0:
        return
    finfo = _precompute_filter_info(st)
    for mb_y in range(st.mb_h):
        for mb_x in range(st.mb_w):
            mb = mbs[mb_y][mb_x]
            # Strength is chosen by is_i4; inner edges filter when the MB
            # is i4x4 OR has coefficients (libwebp f_inner |= !skip).
            inner = bool(mb.is_i4) or not mb.skip
            fi = finfo[mb.segment][1 if mb.is_i4 else 0]
            if fi is None:
                continue
            limit, ilevel, hev_t = fi
            y0, x0 = mb_y * 16, mb_x * 16
            if st.filter_type == 1:  # simple (luma only)
                if mb_x > 0:
                    _filter_simple_h(Y, y0, y0 + 16, x0, limit + 4)
                if inner:
                    for dx in (4, 8, 12):
                        _filter_simple_h(Y, y0, y0 + 16, x0 + dx, limit)
                if mb_y > 0:
                    _filter_simple_v(Y, x0, x0 + 16, y0, limit + 4)
                if inner:
                    for dy in (4, 8, 12):
                        _filter_simple_v(Y, x0, x0 + 16, y0 + dy, limit)
            else:  # complex (luma + chroma)
                cy0, cx0 = mb_y * 8, mb_x * 8
                if mb_x > 0:
                    _filter_seg_h(Y, y0, y0 + 16, x0, limit + 4, ilevel, hev_t, True)
                    _filter_seg_h(U, cy0, cy0 + 8, cx0, limit + 4, ilevel, hev_t, True)
                    _filter_seg_h(V, cy0, cy0 + 8, cx0, limit + 4, ilevel, hev_t, True)
                if inner:
                    for dx in (4, 8, 12):
                        _filter_seg_h(Y, y0, y0 + 16, x0 + dx, limit, ilevel, hev_t, False)
                    _filter_seg_h(U, cy0, cy0 + 8, cx0 + 4, limit, ilevel, hev_t, False)
                    _filter_seg_h(V, cy0, cy0 + 8, cx0 + 4, limit, ilevel, hev_t, False)
                if mb_y > 0:
                    _filter_seg_v(Y, x0, x0 + 16, y0, limit + 4, ilevel, hev_t, True)
                    _filter_seg_v(U, cx0, cx0 + 8, cy0, limit + 4, ilevel, hev_t, True)
                    _filter_seg_v(V, cx0, cx0 + 8, cy0, limit + 4, ilevel, hev_t, True)
                if inner:
                    for dy in (4, 8, 12):
                        _filter_seg_v(Y, x0, x0 + 16, y0 + dy, limit, ilevel, hev_t, False)
                    _filter_seg_v(U, cx0, cx0 + 8, cy0 + 4, limit, ilevel, hev_t, False)
                    _filter_seg_v(V, cx0, cx0 + 8, cy0 + 4, limit, ilevel, hev_t, False)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _decode_vp8_yuv_native(st: FrameState, bd: BoolDecoder,
                           dither_amps=None):
    """C++ full-frame decode (symbols + recon + filter); None if unavailable."""
    import ctypes

    from ...entropy.native_loader import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "wtpu_vp8_decode_frame"):
        return None
    mb_w, mb_h = st.mb_w, st.mb_h
    parts = b"".join(st.partition_bytes)
    offsets = np.zeros(len(st.partition_bytes) + 1, np.uint64)
    acc = 0
    for i, pb in enumerate(st.partition_bytes):
        offsets[i] = acc
        acc += len(pb)
    offsets[-1] = acc

    seg_probs = np.array(st.segment_probs, np.uint8)
    probs = np.ascontiguousarray(st.coeff_probs, np.uint8)
    quants = np.zeros((4, 6), np.int32)
    for s, m in enumerate(st.dqm):
        quants[s] = [m.y1_dc, m.y1_ac, m.y2_dc, m.y2_ac, m.uv_dc, m.uv_ac]
    finfo_py = _precompute_filter_info(st)
    finfo = np.full((4, 2, 3), -1, np.int32)
    for s in range(4):
        for i4 in range(2):
            fi = finfo_py[s][i4]
            if fi is not None:
                finfo[s, i4] = fi
    Y = np.zeros((mb_h * 16, mb_w * 16), np.uint8)
    U = np.zeros((mb_h * 8, mb_w * 8), np.uint8)
    V = np.zeros((mb_h * 8, mb_w * 8), np.uint8)

    def u8p(arr):
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    p0 = bd.data if isinstance(bd.data, bytes) else bytes(bd.data)
    p0_buf = (ctypes.c_uint8 * len(p0)).from_buffer_copy(p0) if p0 else None
    parts_buf = (ctypes.c_uint8 * max(1, len(parts))).from_buffer_copy(
        parts if parts else b"\x00"
    )
    # Overlapped symbol/recon pipeline for large images: a worker
    # thread parses tokens row by row while this thread reconstructs,
    # filters and dithers completed rows behind it — the reference's
    # 2-thread decode (frame_dec.c.go VP8GetThreadMethod, width >= 512
    # gate pkg/vp8/constants.go MIN_WIDTH_FOR_THREADS) re-expressed as
    # band pipelining over the output planes.  Bit-identical output.
    use_mt = (st.mb_w * 16 >= 512 and st.mb_h >= 8
              and hasattr(lib, "wtpu_vp8_decode_frame_mt")
              and os.environ.get("GOWEBP_DECODE_OVERLAP", "1") != "0")
    entry = (lib.wtpu_vp8_decode_frame_mt if use_mt
             else lib.wtpu_vp8_decode_frame)
    rc = entry(
        p0_buf, len(p0), bd.pos, bd.value, bd.range, bd.bit_count,
        parts_buf,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(st.partition_bytes),
        mb_w, mb_h,
        int(st.segment_hdr.update_map),
        seg_probs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(st.use_skip_proba), st.skip_p,
        probs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        quants.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        st.filter_type,
        finfo.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        u8p(Y), u8p(U), u8p(V),
        np.asarray(dither_amps or [0, 0, 0, 0], np.int32)
        .ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise BitstreamError(f"native vp8 decode failed (code {rc})")
    W, H = st.width, st.height
    return (
        Y[:H, :W],
        U[: (H + 1) // 2, : (W + 1) // 2],
        V[: (H + 1) // 2, : (W + 1) // 2],
    )


def recon_vp8_yuv_host(st: FrameState, coeffs: np.ndarray,
                       modes: np.ndarray):
    """Host reconstruction from symbol-engine arrays → cropped YUV planes.

    Pairs with :func:`decode_vp8_symbols_batch`: the interleaved
    multi-stream entropy engine produces (coeffs, modes) for many
    images at once, and this reconstructs each on the host (native
    recon + loop filter, GIL released) without touching a device.
    Bit-identical to :func:`decode_vp8_yuv`.  None if the native layer
    is unavailable.
    """
    import ctypes

    from ...entropy.native_loader import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "wtpu_vp8_recon_frame_arrays"):
        return None
    mb_w, mb_h = st.mb_w, st.mb_h
    finfo_py = _precompute_filter_info(st)
    finfo = np.full((4, 2, 3), -1, np.int32)
    for s in range(4):
        for i4 in range(2):
            fi = finfo_py[s][i4]
            if fi is not None:
                finfo[s, i4] = fi
    Y = np.zeros((mb_h * 16, mb_w * 16), np.uint8)
    U = np.zeros((mb_h * 8, mb_w * 8), np.uint8)
    V = np.zeros((mb_h * 8, mb_w * 8), np.uint8)
    cf = np.ascontiguousarray(coeffs.reshape(-1), np.int16)
    md = np.ascontiguousarray(modes.reshape(-1), np.uint8)

    def p(arr, t):
        return arr.ctypes.data_as(ctypes.POINTER(t))

    rc = lib.wtpu_vp8_recon_frame_arrays(
        p(cf, ctypes.c_int16), p(md, ctypes.c_uint8),
        mb_w, mb_h, st.filter_type,
        p(finfo, ctypes.c_int32), None,
        p(Y, ctypes.c_uint8), p(U, ctypes.c_uint8), p(V, ctypes.c_uint8))
    if rc != 0:
        raise BitstreamError(f"native vp8 recon failed (code {rc})")
    W, H = st.width, st.height
    return (Y[:H, :W], U[: (H + 1) // 2, : (W + 1) // 2],
            V[: (H + 1) // 2, : (W + 1) // 2])


def _bitpos(bd: BoolDecoder) -> int:
    """Monotone consumed-bits proxy for the boolean decoder."""
    return 8 * bd.pos + bd.bit_count


def _parse_frame_mbs(st: FrameState, bd: BoolDecoder,
                     trace: dict | None = None) -> list:
    """Pure-Python entropy decode: partition-0 modes + token residuals.

    Returns the mb_h x mb_w grid of MBData with dequantized coefficients
    (the host half of the host/device split; oracle for
    wtpu_vp8_decode_symbols).
    """
    mb_w, mb_h = st.mb_w, st.mb_h
    intra_t = np.full(4 * mb_w, B_DC, np.int32)
    mbs = [[MBData() for _ in range(mb_w)] for _ in range(mb_h)]
    ctx_above = [[0, 0] for _ in range(mb_w)]   # [nz, nz_dc] per column

    for mb_y in range(mb_h):
        intra_l = np.full(4, B_DC, np.int32)
        ctx_left = [0, 0]
        part_idx = mb_y & (len(st.partitions) - 1)
        token_bd = st.partitions[part_idx]
        if trace is not None:
            t0, p0 = _bitpos(bd), _bitpos(token_bd)
        for mb_x in range(mb_w):
            mb = mbs[mb_y][mb_x]
            (mb.segment, mb.skip, mb.is_i4, mb.imodes, mb.uvmode) = \
                _parse_intra_mode(bd, st, intra_t[4 * mb_x : 4 * mb_x + 4], intra_l)
        if trace is not None:
            trace["intra_modes"] += _bitpos(bd) - t0
        for mb_x in range(mb_w):
            mb = mbs[mb_y][mb_x]
            skip = mb.skip if st.use_skip_proba else 0
            if not skip:
                empty = _parse_residuals(token_bd, st, mb, ctx_above[mb_x], ctx_left)
                mb.skip = int(empty)
            else:
                ctx_above[mb_x][0] = 0
                ctx_left[0] = 0
                if not mb.is_i4:
                    ctx_above[mb_x][1] = 0
                    ctx_left[1] = 0
                mb.coeffs = np.zeros((25, 16), np.int32)
                mb.non_zero_y = 0
                mb.non_zero_uv = 0
                mb.skip = 1
            if token_bd.exhausted():
                raise BitstreamError("truncated token partition")
        if trace is not None:
            trace["residuals"][part_idx] += _bitpos(token_bd) - p0
    return mbs


def decode_vp8_symbols(payload: bytes, bypass_filtering: bool = False,
                       filter_level_override: int | None = None):
    """Host entropy phase → dense tensors for the device recon engine.

    Returns ``(st, coeffs, modes)`` where ``coeffs`` is int16
    (mb_h*mb_w, 24, 16) dequantized coefficients (luma DCs already
    inverse-WHT'd for i16 MBs) and ``modes`` is uint8 (mb_h*mb_w, 21):
    [is_i4, uvmode, segment, skip, dither, imodes x16].  This is the
    "bytes on host" half of the decode split (SURVEY.md §7); the arrays
    feed gowebp_tpu/ops/vp8_recon_jax.py.
    """
    st, bd = parse_frame_header(payload)
    if filter_level_override is not None:
        st.filter_hdr.level = filter_level_override
        st.filter_type = 0 if filter_level_override == 0 else (
            1 if st.filter_hdr.simple else 2
        )
    if bypass_filtering:
        st.filter_type = 0
    n = st.mb_w * st.mb_h
    coeffs = np.zeros((n, 24, 16), np.int16)
    modes = np.zeros((n, 21), np.uint8)

    native = _decode_vp8_symbols_native(st, bd, coeffs, modes)
    if not native:
        mbs = _parse_frame_mbs(st, bd)
        for mb_y in range(st.mb_h):
            for mb_x in range(st.mb_w):
                mb = mbs[mb_y][mb_x]
                i = mb_y * st.mb_w + mb_x
                coeffs[i] = mb.coeffs[:24].astype(np.int16)
                m = modes[i]
                m[0] = int(mb.is_i4)
                m[1] = mb.uvmode
                m[2] = mb.segment
                m[3] = mb.skip
                m[4] = mb.dither
                m[5:21] = mb.imodes.astype(np.uint8)
    return st, coeffs, modes


def _decode_vp8_symbols_native(st: FrameState, bd: BoolDecoder,
                               coeffs: np.ndarray, modes: np.ndarray) -> bool:
    """C++ entropy decode into the provided arrays; False if unavailable."""
    import ctypes

    from ...entropy.native_loader import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "wtpu_vp8_decode_symbols"):
        return False
    parts = b"".join(st.partition_bytes)
    offsets = np.zeros(len(st.partition_bytes) + 1, np.uint64)
    acc = 0
    for i, pb in enumerate(st.partition_bytes):
        offsets[i] = acc
        acc += len(pb)
    offsets[-1] = acc
    seg_probs = np.array(st.segment_probs, np.uint8)
    probs = np.ascontiguousarray(st.coeff_probs, np.uint8)
    quants = np.zeros((4, 6), np.int32)
    for s, m in enumerate(st.dqm):
        quants[s] = [m.y1_dc, m.y1_ac, m.y2_dc, m.y2_ac, m.uv_dc, m.uv_ac]
    p0 = bd.data if isinstance(bd.data, bytes) else bytes(bd.data)
    p0_buf = (ctypes.c_uint8 * len(p0)).from_buffer_copy(p0) if p0 else None
    parts_buf = (ctypes.c_uint8 * max(1, len(parts))).from_buffer_copy(
        parts if parts else b"\x00"
    )
    rc = lib.wtpu_vp8_decode_symbols(
        p0_buf, len(p0), bd.pos, bd.value, bd.range, bd.bit_count,
        parts_buf,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(st.partition_bytes),
        st.mb_w, st.mb_h,
        int(st.segment_hdr.update_map),
        seg_probs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(st.use_skip_proba), st.skip_p,
        probs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        quants.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        coeffs.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        modes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        raise BitstreamError(f"native vp8 symbol decode failed (code {rc})")
    return True


def decode_vp8_symbols_batch(payloads: list):
    """Interleaved multi-image entropy decode (one thread, many chains).

    Same per-image output contract as :func:`decode_vp8_symbols`, but
    all images' token partitions are decoded as round-robin interleaved
    bitstreams in ONE native call (entropy/native/vp8_dec_batch.cpp):
    the boolean decoder is a serial dependency chain, so interleaving
    N independent chains lets the out-of-order core overlap them —
    ~2.5-3x the single-stream symbol throughput.  Multi-partition
    files additionally interleave within the image (the format's
    parallel-decode hook, reference pkg/vp8/vp8_dec.go:293).

    Falls back to per-image :func:`decode_vp8_symbols` when the native
    layer is unavailable.
    """
    import ctypes

    from ...entropy.native_loader import get_lib

    lib = get_lib()
    if (lib is None or not hasattr(lib, "wtpu_vp8_decode_symbols_batch")
            or not lib.wtpu_vp8_batch_is_vectorized()):
        # scalar-fallback builds: the single-stream decoder is faster
        return [decode_vp8_symbols(p) for p in payloads]

    n = len(payloads)
    sts = []
    p0s, poss, vals, rngs, bcs = [], [], [], [], []
    parts_list, bounds_list, nparts = [], [], []
    dims, flags, segps, probs_l, quants_l = [], [], [], [], []
    for payload in payloads:
        st, bd = parse_frame_header(payload)
        sts.append(st)
        p0 = bd.data if isinstance(bd.data, bytes) else bytes(bd.data)
        p0s.append(np.frombuffer(p0, np.uint8))
        poss.append(bd.pos)
        vals.append(bd.value)
        rngs.append(bd.range)
        bcs.append(bd.bit_count)
        parts = b"".join(st.partition_bytes)
        parts_list.append(np.frombuffer(parts, np.uint8)
                          if parts else np.zeros(1, np.uint8))
        bounds = np.zeros(len(st.partition_bytes) + 1, np.uint64)
        acc = 0
        for i, pb in enumerate(st.partition_bytes):
            bounds[i] = acc
            acc += len(pb)
        bounds[-1] = acc
        bounds_list.append(bounds)
        nparts.append(len(st.partition_bytes))
        dims.append((st.mb_w, st.mb_h))
        flags.append((int(st.segment_hdr.update_map),
                      int(st.use_skip_proba), st.skip_p))
        segps.append(np.array(st.segment_probs, np.uint8))
        probs_l.append(np.ascontiguousarray(st.coeff_probs,
                                            np.uint8).reshape(-1))
        qr = np.zeros((4, 6), np.int32)
        for s, m in enumerate(st.dqm):
            qr[s] = [m.y1_dc, m.y1_ac, m.y2_dc, m.y2_ac, m.uv_dc, m.uv_ac]
        quants_l.append(qr.reshape(-1))

    def flat(arrs, dtype):
        off = np.zeros(len(arrs) + 1, np.uint64)
        off[1:] = np.cumsum([a.size for a in arrs])
        return np.ascontiguousarray(np.concatenate(arrs).astype(dtype)), off

    p0_all, p0_off = flat(p0s, np.uint8)
    parts_all, parts_off = flat(parts_list, np.uint8)
    bounds_all = np.concatenate(bounds_list).astype(np.uint64)
    bounds_off = np.zeros(n, np.int32)
    bounds_off[1:] = np.cumsum([b.size for b in bounds_list[:-1]])
    totals = np.array([w * h for w, h in dims], np.int64)
    coeffs_off = np.zeros(n + 1, np.uint64)
    coeffs_off[1:] = np.cumsum(totals * 24 * 16)
    modes_off = np.zeros(n + 1, np.uint64)
    modes_off[1:] = np.cumsum(totals * 21)
    coeffs_all = np.empty(int(coeffs_off[-1]), np.int16)
    modes_all = np.empty(int(modes_off[-1]), np.uint8)
    rc = np.zeros(n, np.int32)

    def cp(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    u8, i16, i32, u32, u64 = (ctypes.c_uint8, ctypes.c_int16, ctypes.c_int32,
                              ctypes.c_uint32, ctypes.c_uint64)
    nfail = lib.wtpu_vp8_decode_symbols_batch(
        n, cp(p0_all, u8), cp(p0_off, u64),
        cp(np.array(poss, np.uint64), u64),
        cp(np.array(vals, np.uint32), u32),
        cp(np.array(rngs, np.uint32), u32),
        cp(np.array(bcs, np.uint32), u32),
        cp(parts_all, u8), cp(parts_off, u64),
        cp(bounds_all, u64), cp(bounds_off, i32),
        cp(np.array(nparts, np.int32), i32),
        cp(np.array(dims, np.int32).reshape(-1), i32),
        cp(np.array(flags, np.int32).reshape(-1), i32),
        cp(np.concatenate(segps), u8),
        cp(np.concatenate(probs_l), u8),
        cp(np.concatenate(quants_l).astype(np.int32), i32),
        cp(coeffs_all, i16), cp(coeffs_off, u64),
        cp(modes_all, u8), cp(modes_off, u64),
        cp(rc, i32),
    )
    if nfail:
        bad = [i for i in range(n) if rc[i] != 0]
        raise BitstreamError(
            f"native batch vp8 symbol decode failed for images {bad}")
    out = []
    for i, st in enumerate(sts):
        t = int(totals[i])
        coeffs = coeffs_all[int(coeffs_off[i]):int(coeffs_off[i + 1])]
        modes = modes_all[int(modes_off[i]):int(modes_off[i + 1])]
        out.append((st, coeffs.reshape(t, 24, 16), modes.reshape(t, 21)))
    return out


def vp8_filter_params(st: FrameState, modes: np.ndarray) -> np.ndarray:
    """Per-MB loop-filter parameters for the device engine.

    Returns int32 (mb_h, mb_w, 4): [limit, ilevel, hev_thresh, inner];
    limit < 0 disables filtering for the MB (matches the reference's
    per-segment precompute, decoder/frame_dec.c.go PrecomputeFilterStrengths).
    """
    finfo = _precompute_filter_info(st)
    n = st.mb_w * st.mb_h
    out = np.full((n, 4), -1, np.int32)
    if st.filter_type == 0:
        return out.reshape(st.mb_h, st.mb_w, 4)
    is_i4 = modes[:, 0].astype(np.int64)
    seg = modes[:, 2].astype(np.int64)
    skip = modes[:, 3].astype(np.int64)
    for s in range(4):
        for i4 in range(2):
            fi = finfo[s][i4]
            if fi is None:
                continue
            sel = (seg == s) & (is_i4 == i4)
            out[sel, 0] = fi[0]
            out[sel, 1] = fi[1]
            out[sel, 2] = fi[2]
    inner = ((is_i4 != 0) | (skip == 0)).astype(np.int32)
    out[:, 3] = inner
    return out.reshape(st.mb_h, st.mb_w, 4)


def decode_vp8_yuv_jax(payload: bytes, bypass_filtering: bool = False,
                       filter_level_override: int | None = None):
    """Device decode path: host entropy decode → JAX reconstruction engine.

    Bit-identical to decode_vp8_yuv (dequant, iDCT, intra wavefront and
    loop filter run on-device, gowebp_tpu/ops/vp8_recon_jax.py).
    """
    from ...ops.vp8_recon_jax import recon_frame

    st, coeffs, modes = decode_vp8_symbols(
        payload, bypass_filtering=bypass_filtering,
        filter_level_override=filter_level_override)
    fp = vp8_filter_params(st, modes)
    Y, U, V = recon_frame(
        coeffs[None],
        modes[None, :, 0].astype(np.int32),
        modes[None, :, 5:21].astype(np.int32),
        modes[None, :, 1].astype(np.int32),
        fp[None],
        mb_w=st.mb_w, mb_h=st.mb_h, filter_type=st.filter_type)
    W, H = st.width, st.height
    return (
        np.asarray(Y[0])[:H, :W],
        np.asarray(U[0])[: (H + 1) // 2, : (W + 1) // 2],
        np.asarray(V[0])[: (H + 1) // 2, : (W + 1) // 2],
    )


def decode_vp8_yuv(payload: bytes, bypass_filtering: bool = False,
                   filter_level_override: int | None = None,
                   dithering_strength: int = 0,
                   trace: dict | None = None):
    """Decode a VP8 chunk payload → (Y, U, V) uint8 planes (cropped).

    With ``trace`` (a dict), per-syntax-class bit counts are accumulated
    into it (the reference's BITTRACE facility, SURVEY.md §5.1); tracing
    runs the instrumented pure-Python path.
    """
    st, bd = parse_frame_header(payload)
    if filter_level_override is not None:
        st.filter_hdr.level = filter_level_override
        st.filter_type = 0 if filter_level_override == 0 else (
            1 if st.filter_hdr.simple else 2
        )
    if bypass_filtering:
        st.filter_type = 0
    dither_amps = _dither_amps(st, dithering_strength)
    if trace is None:
        native = _decode_vp8_yuv_native(st, bd, dither_amps)
        if native is not None:
            return native
    else:
        trace["frame_header"] = _bitpos(bd)
        trace["intra_modes"] = 0
        trace["residuals"] = [0] * len(st.partitions)
    mbs = _parse_frame_mbs(st, bd, trace)
    Y, U, V = _reconstruct(st, mbs)
    _loop_filter(st, mbs, Y, U, V)
    if any(dither_amps):
        _apply_dithering(st, mbs, U, V, dither_amps)

    W, H = st.width, st.height
    y = Y[:H, :W].astype(np.uint8)
    u = U[: (H + 1) // 2, : (W + 1) // 2].astype(np.uint8)
    v = V[: (H + 1) // 2, : (W + 1) // 2].astype(np.uint8)
    return y, u, v


def yuv_planes_to_rgba(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                       fancy_upsampling: bool = True) -> np.ndarray:
    """Host YUV planes → (H, W, 4) RGBA (alpha 255).

    Native fused fancy-upsample + BT.601 conversion when available
    (entropy/native/vp8_dec.cpp wtpu_yuv_to_rgba_fancy), NumPy twin
    otherwise.
    """
    H, W = y.shape
    if fancy_upsampling:
        from ...entropy.native_loader import get_lib

        lib = get_lib()
        if lib is not None and hasattr(lib, "wtpu_yuv_to_rgba_fancy"):
            import ctypes

            yc = np.ascontiguousarray(y, np.uint8)
            uc = np.ascontiguousarray(u, np.uint8)
            vc = np.ascontiguousarray(v, np.uint8)
            out = np.empty((H, W, 4), np.uint8)

            def u8(a):
                return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

            lib.wtpu_yuv_to_rgba_fancy(
                u8(yc), u8(uc), u8(vc), W, H, yc.shape[1], uc.shape[1],
                u8(out))
            return out
        uf = yuv_np.fancy_upsample(u, H, W)
        vf = yuv_np.fancy_upsample(v, H, W)
    else:
        uf = yuv_np.simple_upsample(u, H, W)
        vf = yuv_np.simple_upsample(v, H, W)
    rgb = yuv_np.yuv_to_rgb(y.astype(np.int64), uf.astype(np.int64),
                            vf.astype(np.int64))
    out = np.empty((H, W, 4), np.uint8)
    out[..., :3] = rgb
    out[..., 3] = 255
    return out


def decode_vp8_rgba(payload: bytes, alpha_payload: bytes | None = None,
                    fancy_upsampling: bool = True,
                    bypass_filtering: bool = False,
                    dithering_strength: int = 0) -> np.ndarray:
    """Decode VP8 (+optional ALPH) → (H, W, 4) uint8 RGBA."""
    y, u, v = decode_vp8_yuv(payload, bypass_filtering=bypass_filtering,
                             dithering_strength=dithering_strength)
    H, W = y.shape
    out = yuv_planes_to_rgba(y, u, v, fancy_upsampling=fancy_upsampling)
    if alpha_payload is not None:
        from .alpha import decode_alpha

        out[..., 3] = decode_alpha(alpha_payload, W, H)
    else:
        out[..., 3] = 255
    return out


# ---------------------------------------------------------------------------
# Chroma dithering — bit-exact re-expression of the reference
# (frame_dec.c.go VP8InitDithering:323/DitherRow:364, pkg/vp8/random.go).
# ---------------------------------------------------------------------------

# Per-uv-quant dither amplitude (reference decoder/constants.go
# kQuantToDitherAmp — "roughly dqm.uv_mat[1]").
_QUANT_TO_DITHER_AMP = (8, 7, 6, 4, 4, 2, 2, 2, 1, 1, 1, 1)
_MIN_DITHER_AMP = 4

# libwebp's published VP8Random seed table (31-bit values); a format-
# behavior constant needed for bit-exact dithered output.
_RANDOM_TABLE = (
    0x0de15230, 0x03b31886, 0x775faccb, 0x1c88626a, 0x68385c55, 0x14b3b828,
    0x4a85fef8, 0x49ddb84b, 0x64fcf397, 0x5c550289, 0x4a290000, 0x0d7ec1da,
    0x5940b7ab, 0x5492577d, 0x4e19ca72, 0x38d38c69, 0x0c01ee65, 0x32a1755f,
    0x5437f652, 0x5abb2c32, 0x0faa57b1, 0x73f533e7, 0x685feeda, 0x7563cce2,
    0x6e990e83, 0x4730a7ed, 0x4fc0d9c6, 0x496b153c, 0x4f1403fa, 0x541afb0c,
    0x73990b32, 0x26d7cb1c, 0x6fcc3706, 0x2cbb77d8, 0x75762f2a, 0x6425ccdd,
    0x24b35461, 0x0a7d8715, 0x220414a8, 0x141ebf67, 0x56b41583, 0x73e502e3,
    0x44cab16f, 0x28264d42, 0x73baaefb, 0x0a50ebed, 0x1d6ab6fb, 0x0d3ad40b,
    0x35db3b68, 0x2b081e83, 0x77ce6b95, 0x5181e5f0, 0x78853bbc, 0x009f9494,
    0x27e5ed3c,
)


class VP8Random:
    """Knuth's subtractive lagged-Fibonacci generator (random.go)."""

    def __init__(self):
        self.tab = list(_RANDOM_TABLE)
        self.i1, self.i2 = 0, 31

    def bits2(self, num_bits: int, amp: int) -> int:
        diff = self.tab[self.i1] - self.tab[self.i2]
        if diff < 0:
            diff += 1 << 31
        self.tab[self.i1] = diff
        self.i1 = (self.i1 + 1) % 55
        self.i2 = (self.i2 + 1) % 55
        # sign-extend after <<1 (31-bit value in a 32-bit register)
        diff = (diff << 1) & 0xFFFFFFFF
        if diff & 0x80000000:
            diff -= 1 << 32
        diff >>= 32 - num_bits
        diff = (diff * amp) >> 8        # restrict range
        diff += 1 << (num_bits - 1)     # recenter
        return diff


def _dither_amps(st: FrameState, strength: int) -> list:
    """Per-segment dither amplitudes (VP8InitDithering)."""
    f = 0 if strength < 0 else (255 if strength > 100 else
                                strength * 255 // 100)
    amps = [0, 0, 0, 0]
    if f > 0:
        for s, m in enumerate(st.dqm):
            if m.uv_quant < len(_QUANT_TO_DITHER_AMP):
                idx = max(m.uv_quant, 0)
                amps[s] = (f * _QUANT_TO_DITHER_AMP[idx]) >> 3
    return amps


def _apply_dithering(st: FrameState, mbs, U, V, amps) -> None:
    """Raster-order 8x8 dither of flat-chroma MBs on the filtered planes."""
    rg = VP8Random()
    for mb_y in range(st.mb_h):
        for mb_x in range(st.mb_w):
            mb = mbs[mb_y][mb_x]
            amp = amps[mb.segment] if mb.dither else 0
            if amp < _MIN_DITHER_AMP:
                continue
            for plane in (U, V):
                blk = plane[8 * mb_y : 8 * mb_y + 8, 8 * mb_x : 8 * mb_x + 8]
                noise = np.array([rg.bits2(8, amp) for _ in range(64)],
                                 np.int32).reshape(8, 8)
                delta = (noise - 128 + 8) >> 4
                blk[:] = np.clip(blk + delta, 0, 255)


__all__ = ["decode_vp8_yuv", "decode_vp8_rgba", "parse_frame_header"]
