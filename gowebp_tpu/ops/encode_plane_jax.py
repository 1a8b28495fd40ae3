"""Open-loop encode plane engine: one jittable dense step.

Performs the entire dense phase of VP8 lossy encoding for a batch of
images in one jit region — mode search, FDCT/FWHT, quantization — in
"parallel-intra" (open-loop) form: prediction context comes from the
*source* planes instead of the reconstruction, which removes the
macroblock wavefront dependency entirely.  Every MB of every image is
processed simultaneously; this is what makes the encoder scale on a device
mesh (batch → data parallel, width tiles → model parallel with 1-column
halos; see gowebp_tpu/parallel/).

The sequential feedback-loop (closed-loop) encoder lives in
models/vp8/encoder.py; the host entropy coder consumes either's levels.

Feature parity target: the per-MB search/transform pipeline of
/root/reference/pkg/libwebp/enc/quant_enc.c.go:840-1076, re-designed as
a batched tensor program rather than an iterator loop.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import dct_jax

# Mode enum matches models/vp8/tables.py: DC=0, TM=1, VE=2, HE=3.


def _mb_context(plane: jnp.ndarray, mb: int, left_halo=None, leftmost=None):
    """Split (B, H, W) into MBs and build source-context tensors.

    Returns (blocks (B,mh,mw,mb,mb), top (B,mh,mw,mb), left (B,mh,mw,mb),
    topleft (B,mh,mw)) with the decoder's 127/129 edge fill values.

    For width-sharded execution, ``left_halo`` is the (B, H) source column
    just left of this shard and ``leftmost`` a traced bool — when False,
    MB-column 0 uses the halo instead of the 129 edge fill.
    """
    B, H, W = plane.shape
    mh, mw = H // mb, W // mb
    blocks = plane.reshape(B, mh, mb, mw, mb).transpose(0, 1, 3, 2, 4)

    top_rows = jnp.full((B, mh, W), 127, plane.dtype)
    top_rows = top_rows.at[:, 1:, :].set(plane[:, mb - 1 :: mb, :][:, :-1, :])
    top = top_rows.reshape(B, mh, mw, mb)

    left_cols = jnp.full((B, H, mw), 129, plane.dtype)
    left_cols = left_cols.at[:, :, 1:].set(plane[:, :, mb - 1 :: mb][:, :, :-1])
    if left_halo is not None:
        edge = jnp.where(leftmost, jnp.full_like(left_halo, 129), left_halo)
        left_cols = left_cols.at[:, :, 0].set(edge)
    left = left_cols.reshape(B, mh, mb, mw).transpose(0, 1, 3, 2)

    tl = jnp.full((B, mh, mw), 129, plane.dtype)
    tl = tl.at[:, 1:, 1:].set(plane[:, mb - 1 :: mb, mb - 1 :: mb][:, :-1, :-1])
    if left_halo is not None:
        halo_bottoms = left_halo[:, mb - 1 :: mb][:, :-1]  # (B, mh-1)
        tl_col0 = jnp.where(leftmost, jnp.full_like(halo_bottoms, 129),
                            halo_bottoms)
        tl = tl.at[:, 1:, 0].set(tl_col0)
    tl = jnp.where(jnp.arange(mh)[None, :, None] == 0, 127, tl)
    return blocks, top, left, tl


def _predict4(blocks, top, left, tl, mb: int, leftmost=None):
    """All four 16x16/8x8 predictions → (4, B, mh, mw, mb, mb)."""
    B, mh, mw = blocks.shape[:3]
    have_top = (jnp.arange(mh) > 0)[None, :, None]
    have_left = (jnp.arange(mw) > 0)[None, None, :]
    if leftmost is not None:
        have_left = have_left | ~leftmost
    shift = 5 if mb == 16 else 4

    sum_top = top.sum(axis=-1)
    sum_left = left.sum(axis=-1)
    dc_both = (sum_top + sum_left + mb) >> shift
    dc_left = (sum_left + mb // 2) >> (shift - 1)
    dc_top = (sum_top + mb // 2) >> (shift - 1)
    dc = jnp.where(
        have_top & have_left, dc_both,
        jnp.where(have_left, dc_left, jnp.where(have_top, dc_top, 0x80)),
    )
    pred_dc = jnp.broadcast_to(dc[..., None, None], blocks.shape)

    tm = left[..., :, None] + top[..., None, :] - tl[..., None, None]
    pred_tm = jnp.clip(tm, 0, 255)
    pred_ve = jnp.broadcast_to(top[..., None, :], blocks.shape)
    pred_he = jnp.broadcast_to(left[..., :, None], blocks.shape)
    return jnp.stack([pred_dc, pred_tm, pred_ve, pred_he])


def _search(blocks, preds):
    """SSE argmin over the 4 candidate modes → (modes, best_pred)."""
    diff = blocks[None].astype(jnp.int32) - preds.astype(jnp.int32)
    sse = (diff * diff).sum(axis=(-1, -2))       # (4, B, mh, mw)
    modes = jnp.argmin(sse, axis=0)              # (B, mh, mw)
    best = jnp.take_along_axis(
        preds, modes[None, ..., None, None], axis=0
    )[0]
    return modes.astype(jnp.int32), best


def encode_plane_core(y, u, v, *, y1_dc, y1_ac, y2_dc, y2_ac, uv_dc, uv_ac,
                      y_halo=None, u_halo=None, v_halo=None, leftmost=None):
    """Batched dense encode phase (optionally width-sharded with halos).

    y: (B, H16, W16) int32 luma (MB-padded); u, v: (B, H16//2, W16//2).
    *_halo: (B, H) source column left of this shard; leftmost: traced bool.

    Returns dict of per-MB tensors: ymode/uvmode (B,mh,mw),
    y_levels (B,mh,mw,16,16), y2_levels (B,mh,mw,16),
    uv_levels (B,mh,mw,8,16) — zigzag-ordered quantized levels ready for
    the host entropy coder.
    """
    def qp(q):
        return (1 << 17) // q

    yb, yt, yl, ytl = _mb_context(y, 16, y_halo, leftmost)
    ymode, ypred = _search(yb, _predict4(yb, yt, yl, ytl, 16, leftmost))
    yres = yb.astype(jnp.int32) - ypred.astype(jnp.int32)
    B, mh, mw = yres.shape[:3]
    # Split MB into 16 4x4 blocks: (B,mh,mw,4by,4bx,4,4).
    yblk = yres.reshape(B, mh, mw, 4, 4, 4, 4).transpose(0, 1, 2, 3, 5, 4, 6)
    coeffs = dct_jax.fdct4x4(yblk)               # (B,mh,mw,4,4,4,4)
    dcs = coeffs[..., 0, 0]                       # (B,mh,mw,4,4)
    y2 = dct_jax.fwht4x4(dcs)
    y2_levels = dct_jax.quantize(y2, qp(y2_dc), 96 << 9, qp(y2_ac), 96 << 9)
    y_levels = dct_jax.quantize(
        coeffs.reshape(B, mh, mw, 16, 4, 4),
        qp(y1_dc), 96 << 9, qp(y1_ac), 110 << 9, first_ac=True,
    )

    ub, ut, ul, utl = _mb_context(u, 8, u_halo, leftmost)
    vb, vt, vl, vtl = _mb_context(v, 8, v_halo, leftmost)
    upds = _predict4(ub, ut, ul, utl, 8, leftmost)
    vpds = _predict4(vb, vt, vl, vtl, 8, leftmost)
    diff = (
        (ub[None].astype(jnp.int32) - upds.astype(jnp.int32)) ** 2
    ).sum(axis=(-1, -2)) + (
        (vb[None].astype(jnp.int32) - vpds.astype(jnp.int32)) ** 2
    ).sum(axis=(-1, -2))
    uvmode = jnp.argmin(diff, axis=0).astype(jnp.int32)
    upred = jnp.take_along_axis(upds, uvmode[None, ..., None, None], axis=0)[0]
    vpred = jnp.take_along_axis(vpds, uvmode[None, ..., None, None], axis=0)[0]

    uv_levels = []
    for blocks, pred in ((ub, upred), (vb, vpred)):
        res = blocks.astype(jnp.int32) - pred.astype(jnp.int32)
        blk = res.reshape(B, mh, mw, 2, 4, 2, 4).transpose(0, 1, 2, 3, 5, 4, 6)
        cf = dct_jax.fdct4x4(blk)
        uv_levels.append(
            dct_jax.quantize(
                cf.reshape(B, mh, mw, 4, 4, 4),
                qp(uv_dc), 110 << 9, qp(uv_ac), 110 << 9,
            )
        )
    uv_levels = jnp.concatenate(uv_levels, axis=3)  # (B,mh,mw,8,16)

    return {
        "ymode": ymode.astype(jnp.uint8),
        "uvmode": uvmode.astype(jnp.uint8),
        "y_levels": y_levels.astype(jnp.int16),
        "y2_levels": y2_levels.astype(jnp.int16),
        "uv_levels": uv_levels.astype(jnp.int16),
    }


# ---------------------------------------------------------------------------
# Plane-layout engine (v2): identical integer semantics to
# encode_plane_core, restructured so the minor axis stays wide.  All work
# happens on (B, H, W) tensors whose minor axis stays image-width-sized;
# the 4x4 DCT butterflies become stride-4 plane slices
# instead of (..., 4, 4) micro-blocks, so XLA never materializes the
# tiny-minor-dim transposes that dominated the original formulation.
# One block/zigzag regroup gather runs at the very end.
# ---------------------------------------------------------------------------


def _fdct_plane(res: jnp.ndarray) -> jnp.ndarray:
    """fdct4x4 of every aligned 4x4 block of (B, H, W) int32, in place."""
    B, H, W = res.shape
    # Pass 1: horizontal, within each 4-column group.
    d0 = res[:, :, 0::4]
    d1 = res[:, :, 1::4]
    d2 = res[:, :, 2::4]
    d3 = res[:, :, 3::4]
    a0 = d0 + d3
    a1 = d1 + d2
    a2 = d1 - d2
    a3 = d0 - d3
    t0 = (a0 + a1) * 8
    t1 = (a2 * 2217 + a3 * 5352 + 1812) >> 9
    t2 = (a0 - a1) * 8
    t3 = (a3 * 2217 - a2 * 5352 + 937) >> 9
    tmp = jnp.stack([t0, t1, t2, t3], axis=-1).reshape(B, H, W)
    # Pass 2: vertical, within each 4-row group.
    p0 = tmp[:, 0::4, :]
    p1 = tmp[:, 1::4, :]
    p2 = tmp[:, 2::4, :]
    p3 = tmp[:, 3::4, :]
    a0 = p0 + p3
    a1 = p1 + p2
    a2 = p1 - p2
    a3 = p0 - p3
    o0 = (a0 + a1 + 7) >> 4
    o1 = ((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a3 != 0).astype(jnp.int32)
    o2 = (a0 - a1 + 7) >> 4
    o3 = (a3 * 2217 - a2 * 5352 + 51000) >> 16
    return jnp.stack([o0, o1, o2, o3], axis=-2).reshape(B, H, W)


def _fwht_grid(d: jnp.ndarray) -> jnp.ndarray:
    """fwht4x4 of every aligned 4x4 block of the DC grid (B, Hd, Wd)."""
    B, Hd, Wd = d.shape
    c0 = d[:, :, 0::4]
    c1 = d[:, :, 1::4]
    c2 = d[:, :, 2::4]
    c3 = d[:, :, 3::4]
    a0 = c0 + c3
    a1 = c1 + c2
    a2 = c1 - c2
    a3 = c0 - c3
    tmp = jnp.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2],
                    axis=-1).reshape(B, Hd, Wd)
    p0 = tmp[:, 0::4, :]
    p1 = tmp[:, 1::4, :]
    p2 = tmp[:, 2::4, :]
    p3 = tmp[:, 3::4, :]
    a0 = p0 + p3
    a1 = p1 + p2
    a2 = p1 - p2
    a3 = p0 - p3
    return jnp.stack(
        [(a0 + a1) >> 1, (a3 + a2) >> 1, (a0 - a1) >> 1, (a3 - a2) >> 1],
        axis=-2,
    ).reshape(B, Hd, Wd)


def _plane_context(plane, mb, left_halo=None, leftmost=None):
    """Per-MB top/left/topleft context in plane-aligned layouts.

    Returns top (B, mh, W), left (B, H, mw), tl (B, mh, mw) with the
    decoder's 127/129 edge fills (halo-aware at MB-column 0).
    """
    B, H, W = plane.shape
    mh, mw = H // mb, W // mb
    top = jnp.full((B, mh, W), 127, plane.dtype)
    top = top.at[:, 1:, :].set(plane[:, mb - 1 :: mb, :][:, :-1, :])
    left = jnp.full((B, H, mw), 129, plane.dtype)
    left = left.at[:, :, 1:].set(plane[:, :, mb - 1 :: mb][:, :, :-1])
    if left_halo is not None:
        edge = jnp.where(leftmost, jnp.full_like(left_halo, 129), left_halo)
        left = left.at[:, :, 0].set(edge)
    tl = jnp.full((B, mh, mw), 129, plane.dtype)
    tl = tl.at[:, 1:, 1:].set(plane[:, mb - 1 :: mb, mb - 1 :: mb][:, :-1, :-1])
    if left_halo is not None:
        halo_bottoms = left_halo[:, mb - 1 :: mb][:, :-1]
        tl_col0 = jnp.where(leftmost, jnp.full_like(halo_bottoms, 129),
                            halo_bottoms)
        tl = tl.at[:, 1:, 0].set(tl_col0)
    tl = jnp.where(jnp.arange(mh)[None, :, None] == 0, 127, tl)
    return top, left, tl


def _preds_and_sse(plane, mb, left_halo=None, leftmost=None):
    """All-mode plane predictions (4, B, H, W) + per-MB SSE (4, B, mh, mw)."""
    B, H, W = plane.shape
    mh, mw = H // mb, W // mb
    shift = 5 if mb == 16 else 4
    top, left, tl = _plane_context(plane, mb, left_halo, leftmost)

    have_top = (jnp.arange(mh) > 0)[None, :, None]
    have_left = (jnp.arange(mw) > 0)[None, None, :]
    if leftmost is not None:
        have_left = have_left | ~leftmost
    sum_top = top.reshape(B, mh, mw, mb).sum(axis=-1)
    sum_left = left.reshape(B, mh, mb, mw).sum(axis=-2)
    dc_both = (sum_top + sum_left + mb) >> shift
    dc_left = (sum_left + mb // 2) >> (shift - 1)
    dc_top = (sum_top + mb // 2) >> (shift - 1)
    dc = jnp.where(
        have_top & have_left, dc_both,
        jnp.where(have_left, dc_left, jnp.where(have_top, dc_top, 0x80)),
    )

    top_full = jnp.repeat(top, mb, axis=1)          # row above, repeated down
    left_full = jnp.repeat(left, mb, axis=2)        # col left, repeated right
    tl_full = jnp.repeat(jnp.repeat(tl, mb, axis=1), mb, axis=2)
    preds = jnp.stack([
        jnp.repeat(jnp.repeat(dc, mb, axis=1), mb, axis=2),
        jnp.clip(left_full + top_full - tl_full, 0, 255),
        top_full,
        left_full,
    ])                                               # (4, B, H, W)

    diff = plane[None].astype(jnp.int32) - preds.astype(jnp.int32)
    sse = (diff * diff).reshape(4, B, mh, mb, mw, mb).sum(axis=(3, 5))
    return preds, sse


def _select_pred(preds, modes, mb):
    """Gather the chosen mode's plane prediction via per-MB masks."""
    modes_full = jnp.repeat(jnp.repeat(modes, mb, axis=1), mb, axis=2)
    pred = jnp.zeros_like(preds[0])
    for m in range(4):
        pred = jnp.where(modes_full == m, preds[m], pred)
    return pred.astype(jnp.int32)


def _quant_plane(coef, iq_dc, bias_dc, iq_ac, bias_ac, zero_dc: bool):
    """QUANTDIV on a coefficient plane; DC slots are the (0,0) of each
    4x4 block (zeroed instead when zero_dc — the Y1/Y2 split)."""
    B, H, W = coef.shape
    is_dc = ((jnp.arange(H) % 4 == 0)[None, :, None]
             & (jnp.arange(W) % 4 == 0)[None, None, :])
    iq = jnp.where(is_dc, iq_dc, iq_ac)
    bias = jnp.where(is_dc, bias_dc, bias_ac)
    sign = coef < 0
    av = jnp.abs(coef)
    level = jnp.minimum((av * iq + bias) >> 17, 2047)
    if zero_dc:
        level = jnp.where(is_dc, 0, level)
    return jnp.where(sign, -level, level)


def _regroup_mb_blocks(levels, mb: int):
    """(B, H, W) levels → (B, mh, mw, nblocks, 16) zigzag block layout."""
    B, H, W = levels.shape
    mh, mw = H // mb, W // mb
    nb = mb // 4
    x = levels.reshape(B, mh, nb, 4, mw, nb, 4)
    x = x.transpose(0, 1, 4, 2, 5, 3, 6)            # (B,mh,mw,nby,nbx,4,4)
    x = x.reshape(B, mh, mw, nb * nb, 16)
    return jnp.take(x, dct_jax._ZIGZAG, axis=-1)


def encode_plane_core_v2(y, u, v, *, y1_dc, y1_ac, y2_dc, y2_ac,
                         uv_dc, uv_ac,
                         y_halo=None, u_halo=None, v_halo=None,
                         leftmost=None):
    """Plane-layout dense encode phase; bit-identical to
    encode_plane_core (same outputs) without tiny-minor-dim transposes."""
    def qp(q):
        return (1 << 17) // q

    y = y.astype(jnp.int32)
    ypreds, ysse = _preds_and_sse(y, 16, y_halo, leftmost)
    ymode = jnp.argmin(ysse, axis=0).astype(jnp.int32)
    ypred = _select_pred(ypreds, ymode, 16)
    coef = _fdct_plane(y - ypred)
    B, H, W = coef.shape
    mh, mw = H // 16, W // 16
    dcs = coef[:, 0::4, 0::4]                        # (B, H/4, W/4)
    y2 = _fwht_grid(dcs)
    y2_levels = _regroup_mb_blocks(
        _quant_plane(y2, qp(y2_dc), 96 << 9, qp(y2_ac), 96 << 9, False), 4
    )[:, :, :, 0, :]
    y_levels = _regroup_mb_blocks(
        _quant_plane(coef, qp(y1_dc), 96 << 9, qp(y1_ac), 110 << 9, True), 16
    )

    u = u.astype(jnp.int32)
    v = v.astype(jnp.int32)
    # Joint U+V SSE drives one shared chroma mode (decoder semantics).
    upreds, usse = _preds_and_sse(u, 8, u_halo, leftmost)
    vpreds, vsse = _preds_and_sse(v, 8, v_halo, leftmost)
    uvmode = jnp.argmin(usse + vsse, axis=0).astype(jnp.int32)

    uv_levels = []
    for plane, preds in ((u, upreds), (v, vpreds)):
        pred = _select_pred(preds, uvmode, 8)
        cf = _fdct_plane(plane - pred)
        uv_levels.append(_regroup_mb_blocks(
            _quant_plane(cf, qp(uv_dc), 110 << 9, qp(uv_ac), 110 << 9,
                         False), 8
        ))
    uv_levels = jnp.concatenate(uv_levels, axis=3)   # (B,mh,mw,8,16)

    return {
        "ymode": ymode.astype(jnp.uint8),
        "uvmode": uvmode.astype(jnp.uint8),
        "y_levels": y_levels.astype(jnp.int16),
        "y2_levels": y2_levels.astype(jnp.int16),
        "uv_levels": uv_levels.astype(jnp.int16),
    }


@partial(jax.jit, static_argnames=("y1_dc", "y1_ac", "y2_dc", "y2_ac",
                                   "uv_dc", "uv_ac"))
def encode_plane_step(y, u, v, *, y1_dc, y1_ac, y2_dc, y2_ac, uv_dc, uv_ac):
    """Single-device jitted entry (see encode_plane_core_v2)."""
    return encode_plane_core_v2(
        y, u, v,
        y1_dc=y1_dc, y1_ac=y1_ac, y2_dc=y2_dc, y2_ac=y2_ac,
        uv_dc=uv_dc, uv_ac=uv_ac,
    )


__all__ = ["encode_plane_step", "encode_plane_core", "encode_plane_core_v2"]
