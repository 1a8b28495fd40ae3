"""Sparse/packed coefficient upload for device-resident VP8 decode.

The dense decode-to-device path uploads (B, N, 24, 16) int16
dequantized coefficients — 768 B per macroblock (~3 MB/MP), which is
the wire bound on the decode-to-device pipeline (BENCH r4
``to_device_true_sync_mps``).  The format itself never moves dense
coefficients (the token partitions ARE the sparse representation —
reference pkg/vp8/vp8_dec.go GetCoeffs stops at the EOB token), so the
device path has to earn its layout: this module re-compresses the host
symbol engine's dequantized output into

- ``lv8``: int8 quantization LEVELS, zigzag order, truncated to the
  first K positions (K in {4, 8, 16}, chosen per batch by measured
  byte cost).  Levels are recovered on the host by exact division
  (dequantized = level * q, so division by the per-segment quantizer
  reconstructs them losslessly; verified per lane);
- ``dc16``: the i16 macroblocks' luma DC lanes (inverse-WHT outputs,
  NOT level multiples) as a dense (B, N, 16) int16 side plane;
- ``tail``: a second-tier table for blocks whose nonzeros extend past
  position K: flat block index + the REMAINING 16-K int8 levels
  (4 + 16-K bytes instead of a fat raw row — eob tails are the common
  "exception" on textured content, ~15-35% of blocks at q75);
- ``exc``: a raw exception table (flat block index + int16 zigzag
  row) for the genuinely irregular blocks — |level| > 127 or a
  non-exact division (measured ~0 on natural content; the lossless
  safety net).  Capacities round up to powers of two so compilations
  stay bounded;
- per-image (4, 6) quantizer matrices + the per-MB segment map, which
  the device uses to re-dequantize with the same where-chain select
  the encoder's quant lanes use (no gathers).

The K chooser charges scattered rows a device penalty (row scatters
serialize on the device; the charge is a tuning constant), so textured
content lands on K=16
(~420 B/MB = 1.8x fewer wire bytes, zero scatters) and smooth content
on K=4/8 (up to 4x).  The pack itself runs native
(entropy/native/vp8_dec.cpp wtpu_vp8_pack_*, ~8 ms/MP; numpy
reference kept as oracle and fallback).  The unpack is a handful of
fused elementwise ops + a static-slice zigzag permutation (integer
slices are exact at any value; a one-hot f32 matmul is exact only at
full precision), bit-identical to the dense path
(tests/test_vp8_recon_jax.py).
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp


I32 = jnp.int32

# zigzag position n -> raster index (RFC 6386)
_ZZ = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15],
               np.int32)


def _pow2_cap(n: int, lo: int = 64) -> int:
    c = lo
    while c < n:
        c *= 2
    return c


_ROW_COST = 64      # device byte-equivalents charged per scattered row


def _choose_k(nblocks: int, n_base: int, n_t4: int, n_t8: int) -> int:
    """K by total cost: wire bytes (tail = 4 + 16-K, raw row = 36)
    plus a device scatter penalty per row (row scatters serialize, and
    the scatter-free K=16 layout carries only ~8% more payload)."""
    best_k = 16
    best = nblocks * 16 + n_base * (36 + _ROW_COST)
    for K, ntail in ((8, n_t8), (4, n_t4)):
        cost = (nblocks * K + ntail * (4 + 16 - K + _ROW_COST)
                + n_base * (36 + _ROW_COST))
        if cost < best:
            best_k, best = K, cost
    return best_k


def _pack_coeffs_native(c, seg, is_i4, qs, B, N):
    """C++ fast path of :func:`pack_coeffs` (bit-identical layout);
    None when the native layer is unavailable."""
    import ctypes

    from ..entropy.native_loader import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "wtpu_vp8_pack_emit"):
        return None
    seg8 = np.ascontiguousarray(seg, np.uint8)
    i48 = np.ascontiguousarray(is_i4, np.uint8)
    qsc = np.ascontiguousarray(qs, np.int32)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    counts3 = np.zeros(3, np.int32)
    lib.wtpu_vp8_pack_stats(p(c, ctypes.c_int16), p(seg8, ctypes.c_uint8),
                            p(i48, ctypes.c_uint8), p(qsc, ctypes.c_int32),
                            B, N, p(counts3, ctypes.c_int32))
    nblocks = B * N * 24
    K = _choose_k(nblocks, int(counts3[0]), int(counts3[1]),
                  int(counts3[2]))
    ntail0 = 0 if K == 16 else int(counts3[2] if K == 8 else counts3[1])
    tail_cap = _pow2_cap(ntail0, lo=16)
    cap = _pow2_cap(int(counts3[0]), lo=16)
    tw = max(1, 16 - K)
    while True:
        lv8 = np.empty((B, N, 24, K), np.int8)
        dc16 = np.empty((B, N, 16), np.int16)
        tail_idx = np.full(tail_cap, nblocks, np.int32)
        tail_val = np.zeros((tail_cap, tw), np.int8)
        exc_idx = np.full(cap, nblocks, np.int32)
        exc_val = np.zeros((cap, 16), np.int16)
        counts2 = np.zeros(2, np.int64)
        rc = lib.wtpu_vp8_pack_emit(
            p(c, ctypes.c_int16), p(seg8, ctypes.c_uint8),
            p(i48, ctypes.c_uint8), p(qsc, ctypes.c_int32), B, N, K,
            p(lv8, ctypes.c_int8), p(dc16, ctypes.c_int16),
            p(tail_idx, ctypes.c_int32), p(tail_val, ctypes.c_int8),
            tail_cap,
            p(exc_idx, ctypes.c_int32), p(exc_val, ctypes.c_int16), cap,
            p(counts2, ctypes.c_int64))
        if rc == 0:
            break
        tail_cap = _pow2_cap(int(counts2[0]), lo=16)
        cap = _pow2_cap(int(counts2[1]), lo=16)
    return {
        "lv8": lv8,
        "dc16": dc16,
        "tail_idx": tail_idx,
        "tail_val": tail_val,
        "exc_idx": exc_idx,
        "exc_val": exc_val,
        "seg": seg8,
        "is_i4": i48,
        "qmat": qsc,
    }, K, cap


def pack_coeffs(coeffs: np.ndarray, seg: np.ndarray, is_i4: np.ndarray,
                qmat: np.ndarray):
    """Host-side pack of dequantized coefficients into the wire layout.

    coeffs: (B, N, 24, 16) int16 raster (the symbol engines' output);
    seg/is_i4: (B, N) per-MB segment id / i4 flag; qmat: (B, 4, 6)
    int32 per-image per-segment (y1dc, y1ac, y2dc, y2ac, uvdc, uvac).

    Returns a dict of numpy arrays (the jit inputs of
    :func:`unpack_coeffs`) plus the static ints ``K`` and ``cap``.
    """
    B, N = coeffs.shape[:2]
    c = np.ascontiguousarray(coeffs, np.int16)
    seg = seg.astype(np.int64)
    qs = qmat.astype(np.int32)                          # (B, 4, 6)
    is_luma = np.arange(24) < 16                        # (24,)

    import os

    if os.environ.get("GOWEBP_PACK_NUMPY") != "1":
        native = _pack_coeffs_native(c, seg, is_i4, qs, B, N)
        if native is not None:
            return native

    # Per-image processing bounds host memory to ~10 MB of temporaries
    # per 1 MP image regardless of batch size.
    def per_image(b):
        zz = c[b][..., _ZZ].astype(np.int32)            # (N, 24, 16)
        sg = seg[b]
        q_ac = np.where(is_luma[None, :], qs[b, sg, 1][:, None],
                        qs[b, sg, 5][:, None]).astype(np.int32)
        q_dc = np.where(is_luma[None, :], qs[b, sg, 0][:, None],
                        qs[b, sg, 4][:, None]).astype(np.int32)
        q = np.empty((N, 24, 16), np.int32)
        q[..., 0] = q_dc
        q[..., 1:] = q_ac[..., None]
        # i16 luma DC lanes are inverse-WHT outputs: excluded from the
        # level math, carried in the dense dc16 side plane instead.
        i16mask = (is_i4[b].astype(np.int64) == 0)[:, None] & is_luma[None]
        dc16_b = np.where(i16mask, c[b][..., 0], 0)[:, :16].astype(np.int16)
        zz_lv = zz.copy()
        zz_lv[..., 0] = np.where(i16mask, 0, zz[..., 0])
        # exact level recovery: dequantized = level * q with
        # |level| < 2^12 and q < 2^9, so float32 division + rint is
        # exact; any lane failing the multiply-back check makes its
        # block an exception.
        lv = np.rint(zz_lv.astype(np.float32)
                     / q.astype(np.float32)).astype(np.int32)
        base = ((lv * q != zz_lv).any(axis=-1)
                | (np.abs(lv) > 127).any(axis=-1))      # (N, 24)
        nzpos = zz != 0                      # raw values decide the eob
        tail8 = nzpos[..., 8:].any(axis=-1)
        tail4 = tail8 | nzpos[..., 4:8].any(axis=-1)
        return zz, lv, base, tail4, tail8, dc16_b

    per = [per_image(b) for b in range(B)]
    dc16 = np.stack([p[5] for p in per])

    nblocks = B * N * 24
    n_base = sum(int(p[2].sum()) for p in per)
    n_t4 = sum(int((p[3] & ~p[2]).sum()) for p in per)
    n_t8 = sum(int((p[4] & ~p[2]).sum()) for p in per)
    K = _choose_k(nblocks, n_base, n_t4, n_t8)

    lv8 = np.empty((B, N, 24, K), np.int8)
    tidx_parts, tval_parts = [], []
    idx_parts, val_parts = [], []
    for b, (zz, lv, base, tail4, tail8, _) in enumerate(per):
        tail = (np.zeros_like(base) if K == 16
                else ((tail4 if K == 4 else tail8) & ~base))
        lv8[b] = np.where(base[..., None], 0, lv)[..., :K].astype(np.int8)
        ti = np.flatnonzero(tail.reshape(-1)).astype(np.int32)
        tidx_parts.append(ti + b * N * 24)
        tval_parts.append(lv.reshape(-1, 16)[ti, K:].astype(np.int8))
        fi = np.flatnonzero(base.reshape(-1)).astype(np.int32)
        idx_parts.append(fi + b * N * 24)
        val_parts.append(zz.reshape(-1, 16)[fi].astype(np.int16))

    def table(parts_i, parts_v, width, vdtype):
        flat_i = (np.concatenate(parts_i) if parts_i
                  else np.zeros(0, np.int32))
        cap = _pow2_cap(len(flat_i), lo=16)
        t_idx = np.full(cap, nblocks, np.int32)         # OOB rows drop
        t_idx[: len(flat_i)] = flat_i
        t_val = np.zeros((cap, width), vdtype)
        if len(flat_i):
            t_val[: len(flat_i)] = np.concatenate(parts_v)
        return t_idx, t_val, cap

    tail_idx, tail_val, _tcap = table(tidx_parts, tval_parts,
                                      max(1, 16 - K), np.int8)
    exc_idx, exc_val, cap = table(idx_parts, val_parts, 16, np.int16)

    return {
        "lv8": lv8,
        "dc16": dc16,
        "tail_idx": tail_idx,
        "tail_val": tail_val,
        "exc_idx": exc_idx,
        "exc_val": exc_val,
        "seg": seg.astype(np.uint8),
        "is_i4": is_i4.astype(np.uint8),
        "qmat": qs,
    }, K, cap


def packed_nbytes(packed) -> int:
    """Total wire bytes of a packed dict (telemetry)."""
    return sum(int(a.nbytes) for a in packed.values())


def unpack_coeffs(packed, *, K: int):
    """Device-side unpack: packed wire layout → (B, N, 24, 16) int32
    dequantized raster coefficients, bit-identical to the dense input
    of :func:`ops.vp8_recon_jax.recon_frame`.  Runs inside the caller's
    jit (recon_frame_packed)."""
    lv8 = packed["lv8"].astype(I32)                     # (B, N, 24, K)
    B, N = lv8.shape[:2]
    seg = packed["seg"].astype(I32)                     # (B, N)
    qs = packed["qmat"].astype(I32)                     # (B, 4, 6)

    def seg_sel(col):
        out = qs[:, 0, col][:, None]
        for k in (1, 2, 3):
            out = jnp.where(seg == k, qs[:, k, col][:, None], out)
        return out                                      # (B, N)

    is_luma = (jnp.arange(24) < 16)[None, None, :]
    q_ac = jnp.where(is_luma, seg_sel(1)[..., None], seg_sel(5)[..., None])
    q_dc = jnp.where(is_luma, seg_sel(0)[..., None], seg_sel(4)[..., None])

    if K < 16:
        lv8 = jnp.pad(lv8, ((0, 0),) * 3 + ((0, 16 - K),))
        # second-tier eob tails: scatter the remaining levels back in
        flat_lv = lv8.reshape(B * N * 24, 16)
        flat_lv = flat_lv.at[packed["tail_idx"], K:].set(
            packed["tail_val"].astype(I32), mode="drop")
        lv8 = flat_lv.reshape(B, N, 24, 16)
    pos0 = jnp.arange(16) == 0
    q = jnp.where(pos0, q_dc[..., None], q_ac[..., None])
    zz = lv8 * q                                        # (B, N, 24, 16)

    # i16 luma DC lanes from the dense side plane
    i16 = (packed["is_i4"].astype(I32) == 0)[:, :, None]
    dcl = jnp.where(i16, packed["dc16"].astype(I32), zz[:, :, :16, 0])
    zz = zz.at[:, :, :16, 0].set(dcl)

    # exception rows override whole blocks (raw int16 zigzag)
    flat = zz.reshape(B * N * 24, 16)
    flat = flat.at[packed["exc_idx"]].set(
        packed["exc_val"].astype(I32), mode="drop")
    zz = flat.reshape(B, N, 24, 16)
    # zigzag -> raster as a static slice permutation: dequantized values
    # reach ~2^19, and integer slices are exact at any value and any
    # matmul precision.
    inv = np.argsort(_ZZ)
    return jnp.stack([zz[..., int(inv[r])] for r in range(16)], axis=-1)


@partial(jax.jit, static_argnames=("K", "mb_w", "mb_h", "filter_type"))
def recon_frame_packed(packed, is_i4, imodes, uvmode, fparams, *,
                       K: int, mb_w: int, mb_h: int, filter_type: int):
    """recon_frame with the packed coefficient wire layout.

    Same contract as :func:`ops.vp8_recon_jax.recon_frame` but the
    coefficients arrive packed (see :func:`pack_coeffs`); the unpack
    runs fused at the head of the same compiled program.  The narrow
    mode/filter inputs (uint8/int16) are widened on device too, so the
    whole upload is the packed payload.
    """
    from .vp8_recon_jax import recon_frame

    coeffs = unpack_coeffs(packed, K=K)
    return recon_frame(coeffs, is_i4.astype(I32), imodes.astype(I32),
                       uvmode.astype(I32), fparams.astype(I32),
                       mb_w=mb_w, mb_h=mb_h, filter_type=filter_type)


__all__ = ["pack_coeffs", "unpack_coeffs", "recon_frame_packed",
           "packed_nbytes"]
