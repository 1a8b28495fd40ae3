"""Sharded codec steps: shard_map + halo exchange over the device mesh.

The encode plane engine shards as:
  batch  → "data" axis (independent images, no communication)
  width  → "tile" axis (each shard encodes a vertical stripe of MBs;
           the only cross-shard dependency is the 1-pixel-wide source
           column of the left neighbor, exchanged with lax.ppermute
           before the dense phase runs)

This is the device-mesh re-expression of the reference's format-level
parallel hooks (VP8 token partitions / MB-row round-robin — SURVEY.md
§2.10 item 2): entropy coding stays per-stripe-local on the host while
the plane math scales over the mesh.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

from ..ops.encode_plane_jax import encode_plane_core_v2


def _shift_right(col: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Send each shard's column to its right neighbor (ring ppermute)."""
    n = jax.lax.axis_size(axis_name)
    perm = [(i, (i + 1) % n) for i in range(n)]
    return jax.lax.ppermute(col, axis_name, perm)


def sharded_encode_plane_step(mesh: Mesh, y, u, v, *, quants):
    """Run the dense encode phase sharded over (data, tile).

    y: (B, H16, W16) int32; u/v: (B, H16//2, W16//2) int32.
    quants: dict with y1_dc..uv_ac integer steps.
    Returns the same per-MB tensor dict as encode_plane_step, with MB-grid
    outputs sharded (B over data, mb-columns over tile).
    """

    def step(y, u, v):
        # Halo: last source column of this shard → right neighbor.
        y_halo = _shift_right(y[:, :, -1], "tile")
        u_halo = _shift_right(u[:, :, -1], "tile")
        v_halo = _shift_right(v[:, :, -1], "tile")
        leftmost = jax.lax.axis_index("tile") == 0
        return encode_plane_core_v2(
            y, u, v,
            y_halo=y_halo, u_halo=u_halo, v_halo=v_halo, leftmost=leftmost,
            **quants,
        )

    specs_in = (
        P("data", None, "tile"),
        P("data", None, "tile"),
        P("data", None, "tile"),
    )
    specs_out = {
        "ymode": P("data", None, "tile"),
        "uvmode": P("data", None, "tile"),
        "y_levels": P("data", None, "tile", None, None),
        "y2_levels": P("data", None, "tile", None),
        "uv_levels": P("data", None, "tile", None, None),
    }
    fn = shard_map(step, mesh=mesh, in_specs=specs_in,
                   out_specs=specs_out, check_vma=False)
    return jax.jit(fn)(y, u, v)


def sharded_wavefront_encode(mesh: Mesh, y, u, v, seg_map, qsteps, tables,
                             *, try_i4: bool, i4_penalty=0,
                             use_derr: bool = False):
    """The EXACT closed-loop wavefront tile-sharded over MB rows.

    Batch shards over "data"; the image's MB ROWS shard over "tile".
    Per diagonal step, the only cross-shard inputs are the row-shift
    context reads (one reconstructed MB edge strip: 16 px luma + 8 px
    chroma rows + the DC-diffusion pairs), exchanged with lax.ppermute
    inside the step — SURVEY §2.10's halo-exchange plan
    applied to the sequential-exact engine, so a single huge image can
    use every device on the mesh.  Bit-identical to the single-device
    `encode_wavefront_core` (asserted by tests and the multichip
    dryrun).
    """
    from ..ops.encode_wavefront_jax import _unskew_out, _wavefront_impl

    tile_n = mesh.devices.shape[mesh.axis_names.index("tile")]
    B, H, W = y.shape
    mh, mw = H // 16, W // 16
    if mh % tile_n:
        raise ValueError(f"mb_h={mh} not divisible by tile axis {tile_n}")

    def body(y, u, v, seg, qs, pen, t0, t1, t2):
        return _wavefront_impl(
            y, u, v, seg, qs, (t0, t1, t2), try_i4=try_i4, i4_penalty=pen,
            use_derr=use_derr, axis_name="tile", mb_h_global=mh,
            n_shards=tile_n)

    pen_arr = jnp.asarray(i4_penalty, jnp.int32)
    if pen_arr.ndim == 0:
        pen = jnp.full((B, 4), pen_arr, jnp.int32)
    elif pen_arr.ndim == 1:
        pen = jnp.broadcast_to(pen_arr[None], (B, 4))
    else:
        pen = pen_arr
    specs_in = (
        P("data", "tile", None),          # y (rows sharded)
        P("data", "tile", None),
        P("data", "tile", None),
        P("data", "tile", None),          # seg_map (mh, mw)
        P("data", None, None),            # qsteps
        P("data", None),                  # penalties
        P(), P(), P(),                    # tables replicated
    )
    sk = P("data", "tile", None)
    specs_out = {
        "ymode": sk, "uvmode": sk, "is_i4": sk,
        "imodes": P("data", "tile", None, None),
        "y_levels": P("data", "tile", None, None, None),
        "y2_levels": P("data", "tile", None, None),
        "uv_levels": P("data", "tile", None, None, None),
    }
    fn = shard_map(body, mesh=mesh, in_specs=specs_in,
                   out_specs=specs_out, check_vma=False)
    out = jax.jit(fn)(y, u, v, seg_map, qsteps, pen, *tables)
    return _unskew_out(out, mw, mh, want_recon=False)


def sharded_recon_frame(mesh: Mesh, coeffs, is_i4, imodes, uvmode, fparams,
                        *, mb_w, mb_h, filter_type):
    """The decode reconstruction + loop filter tile-sharded over MB rows.

    Same halo structure as sharded_wavefront_encode for the recon pass;
    the loop filter additionally sends each shard's filtered top-edge
    rows back to the shard above with a reverse ppermute.  Bit-identical
    to the single-device `recon_frame`.

    When mb_h is not a multiple of the tile axis, dead MB rows are
    appended and cut off again: no row reads context from the row below
    it, and a filter limit of -1 disables every edge a dead row owns
    (its top edge included), so the real rows are unchanged.
    """
    from ..ops.vp8_recon_jax import (
        I32, _unskew_plane, loop_filter_wavefront, recon_wavefront,
        residual_blocks)

    tile_n = mesh.devices.shape[mesh.axis_names.index("tile")]
    pad = -mb_h % tile_n
    mh_all = mb_h + pad
    mh_local = mh_all // tile_n

    def body(c3, is3, im3, uv3, fp):
        nl = mh_local * mb_w
        B_l = c3.shape[0]
        coeffs_l = c3.reshape(B_l, nl, 24, 16)
        Yres, Ures, Vres = residual_blocks(coeffs_l.astype(I32))
        sk = recon_wavefront(
            Yres, Ures, Vres,
            is3.reshape(B_l, nl).astype(I32),
            im3.reshape(B_l, nl, 16).astype(I32),
            uv3.reshape(B_l, nl).astype(I32),
            mb_w=mb_w, mb_h=mh_local,
            axis_name="tile", mb_h_global=mh_all, n_shards=tile_n)
        return loop_filter_wavefront(
            *sk, fp, mb_w=mb_w, mb_h=mh_local, filter_type=filter_type,
            axis_name="tile", mb_h_global=mh_all, n_shards=tile_n)

    row3 = P("data", "tile", None)
    specs_in = (row3, row3, row3, row3, P("data", "tile", None, None))
    sk_spec = P("data", "tile", None, None, None)
    specs_out = (sk_spec, sk_spec, sk_spec)
    fn = shard_map(body, mesh=mesh, in_specs=specs_in,
                   out_specs=specs_out, check_vma=False)
    B = coeffs.shape[0]

    def rows(a, per_row, fill=0):
        """Row-major N axis made explicit so rows shard over 'tile'."""
        a = jnp.asarray(a).reshape((B, mb_h) + per_row)
        if pad:
            a = jnp.concatenate(
                [a, jnp.full((B, pad) + per_row, fill, a.dtype)], axis=1)
        return a

    Sk_y, Sk_u, Sk_v = jax.jit(fn)(
        rows(coeffs, (mb_w * 24 * 16,)),
        rows(is_i4, (mb_w,)),
        rows(imodes, (mb_w * 16,)),
        rows(uvmode, (mb_w,)),
        rows(fparams, (mb_w, 4), fill=-1),
    )
    Y = _unskew_plane(Sk_y, mb_w, mh_all, 16)[:, :16 * mb_h]
    U = _unskew_plane(Sk_u, mb_w, mh_all, 8)[:, :8 * mb_h]
    V = _unskew_plane(Sk_v, mb_w, mh_all, 8)[:, :8 * mb_h]
    return Y.astype(jnp.uint8), U.astype(jnp.uint8), V.astype(jnp.uint8)


def _flat_batch_axes(mesh: Mesh) -> tuple:
    """All mesh axes as one flattened batch dimension."""
    return tuple(mesh.axis_names)


def sharded_recon_step(mesh: Mesh, coeffs, is_i4, imodes, uvmode, fparams,
                       *, mb_w: int, mb_h: int, filter_type: int):
    """VP8 decode reconstruction (dequant+iDCT, intra wavefront, loop
    filter) sharded batch-parallel over every device in the mesh.

    Decode has no cross-image dependency, so the batch axis shards over
    the flattened (data × tile) mesh — the device-mesh replacement for
    the reference's 2-thread decode pipeline (SURVEY §2.10 item 1).
    Returns uint8 Y/U/V planes with the same sharding.
    """
    from ..ops.vp8_recon_jax import recon_frame

    axes = _flat_batch_axes(mesh)

    def step(c, i4, im, uv, fp):
        return recon_frame(c, i4, im, uv, fp, mb_w=mb_w, mb_h=mb_h,
                           filter_type=filter_type)

    bspec = P(axes)
    in_specs = (bspec, bspec, bspec, bspec, bspec)
    out_specs = (bspec, bspec, bspec)
    fn = shard_map(step, mesh=mesh, in_specs=in_specs,
                   out_specs=out_specs, check_vma=False)
    return jax.jit(fn)(coeffs, is_i4, imodes, uvmode, fparams)


def sharded_lossless_inverse(mesh: Mesh, residuals, mode_img, *, bits: int):
    """VP8L inverse transforms (predictor-add + add-green) sharded
    batch-parallel over the full mesh.

    residuals: (B, h, w) uint32 predictor residual images; mode_img is
    shared (replicated) across the batch.  Mirrors the reference's
    per-tile independent entropy contexts (SURVEY §2.10 item 6) at
    batch granularity.
    """
    from ..ops.lossless_jax import add_green_inverse, predictor_inverse

    axes = _flat_batch_axes(mesh)

    def step(res, modes):
        out = jax.vmap(lambda r: predictor_inverse(r, modes, bits))(res)
        return jax.vmap(add_green_inverse)(out)

    fn = shard_map(step, mesh=mesh, in_specs=(P(axes), P()),
                   out_specs=P(axes), check_vma=False)
    return jax.jit(fn)(residuals, mode_img)


__all__ = [
    "sharded_encode_plane_step",
    "sharded_lossless_inverse",
    "sharded_recon_step",
]
