"""Exact closed-loop wavefront encoder: equality + stream validity."""

import numpy as np

from gowebp_tpu import decode_rgba
from gowebp_tpu.config import EncoderConfig
from gowebp_tpu.encode import encode_rgba

from util import make_test_images, pil_decode_rgba

RNG = np.random.default_rng(21)


def test_wavefront_equals_sequential():
    from gowebp_tpu.models.vp8.encoder import (
        _encode_frame_dense_native,
        make_quants,
    )
    from gowebp_tpu.ops.encode_wavefront_jax import encode_wavefront

    B, H, W = 2, 48, 80
    y = RNG.integers(0, 256, (B, H, W)).astype(np.int32)
    u = RNG.integers(0, 256, (B, H // 2, W // 2)).astype(np.int32)
    v = RNG.integers(0, 256, (B, H // 2, W // 2)).astype(np.int32)
    q = make_quants(40)
    out = encode_wavefront(
        y, u, v,
        y1_dc=q.y1_dc.q, y1_ac=q.y1_ac.q, y2_dc=q.y2_dc.q,
        y2_ac=q.y2_ac.q, uv_dc=q.uv_dc.q, uv_ac=q.uv_ac.q,
    )
    for b in range(B):
        nat = _encode_frame_dense_native(y[b], u[b], v[b], W // 16, H // 16,
                                         q, method=0)
        assert nat is not None, "native host layer did not build"
        for key, nk in (("ymode", "ymode"), ("uvmode", "uvmode"),
                        ("y2_levels", "y2"), ("y_levels", "yl"),
                        ("uv_levels", "uvl")):
            got = np.asarray(out[key][b]).reshape(np.asarray(nat[nk]).shape)
            np.testing.assert_array_equal(got, np.asarray(nat[nk]),
                                          err_msg=f"img {b} {key}")


def test_wavefront_i4_segments_equals_sequential():
    """Full engine (i4 search + per-segment quants) vs native host."""
    import jax.numpy as jnp

    from gowebp_tpu.models.vp8.encoder import (
        _default_cost_tables,
        _encode_frame_dense_native,
        _i4_config_seg,
        make_quants,
    )
    from gowebp_tpu.ops.encode_wavefront_jax import encode_wavefront_core

    B, H, W = 2, 48, 80
    mh, mw = H // 16, W // 16
    y = np.zeros((B, H, W), np.int32)
    for b in range(B):
        gy, gx = np.mgrid[0:H, 0:W]
        y[b] = (gy * 2 + gx + RNG.integers(0, 60, (H, W))) % 256
        y[b, :16, :16] = 128  # flat area -> i16 wins somewhere
    u = RNG.integers(0, 256, (B, H // 2, W // 2)).astype(np.int32)
    v = RNG.integers(0, 256, (B, H // 2, W // 2)).astype(np.int32)
    seg_np = RNG.integers(0, 4, (B, mh, mw)).astype(np.int32)

    base_q = 55
    quants = [make_quants(max(0, min(127, base_q + d)))
              for d in (-8, 0, 6, 14)]
    qsteps = np.array([(s.y1_dc.q, s.y1_ac.q, s.y2_dc.q, s.y2_ac.q,
                        s.uv_dc.q, s.uv_ac.q) for s in quants], np.int32)
    tp0, tp1, tval = _default_cost_tables()
    tables = tuple(jnp.asarray(t.astype(np.int32)) for t in (tp0, tp1, tval))
    q0 = quants[0]
    # Per-segment RD lambdas (each segment's own quantizer drives its
    # i4 penalty, matching the native engine).
    _, i4_pens = _i4_config_seg(qsteps, 4, 0)
    out = encode_wavefront_core(
        jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), jnp.asarray(seg_np),
        jnp.asarray(np.broadcast_to(qsteps, (B, 4, 6))), tables,
        try_i4=True, i4_penalty=np.broadcast_to(i4_pens, (B, 4)))
    adopted = 0
    for b in range(B):
        seg = {"map": seg_np[b].reshape(-1).astype(np.uint8),
               "quants": quants}
        nat = _encode_frame_dense_native(y[b], u[b], v[b], mw, mh, q0,
                                         method=4, seg=seg)
        assert nat is not None, "native host layer did not build"
        for key, nk in (("ymode", "ymode"), ("uvmode", "uvmode"),
                        ("is_i4", "is_i4"), ("imodes", "imodes"),
                        ("y2_levels", "y2"), ("y_levels", "yl"),
                        ("uv_levels", "uvl")):
            got = np.asarray(out[key][b]).reshape(np.asarray(nat[nk]).shape)
            np.testing.assert_array_equal(got, np.asarray(nat[nk]),
                                          err_msg=f"img {b} {key}")
        adopted += int(np.asarray(out["is_i4"][b]).sum())
    assert adopted > 0  # the search must actually trigger on this content


def test_dc_error_diffusion_on_and_bit_identical():
    """UV DC error diffusion (reference CorrectDCValues/
    StoreDiffusionErrors, quant_enc.c.go:732-780): active at
    quality <= 98, changes the UV levels on smooth gradients, and the
    JAX wavefront reproduces the native chain bit for bit (covered by
    the host==jax file assertions; here we check the feature actually
    fires)."""
    import jax.numpy as jnp

    from gowebp_tpu.models.vp8.encoder import (
        _default_cost_tables, make_quants)
    from gowebp_tpu.ops.encode_wavefront_jax import encode_wavefront_core

    # Smooth chroma gradient at low quality: DC quantization error is
    # systematic, so diffusion must alter some DC levels.
    H = W = 64
    yy, xx = np.mgrid[0:H, 0:W]
    y = np.full((1, H, W), 128, np.int32)
    u = (96 + (xx[::2, ::2] + yy[::2, ::2]) // 16).astype(np.int32)[None]
    v = (160 - (xx[::2, ::2]) // 20).astype(np.int32)[None]
    q = make_quants(100)     # coarse quantizer
    row = np.array([q.y1_dc.q, q.y1_ac.q, q.y2_dc.q, q.y2_ac.q,
                    q.uv_dc.q, q.uv_ac.q], np.int32)
    qs = np.broadcast_to(row, (1, 4, 6)).copy()
    seg = np.zeros((1, 4, 4), np.int32)
    tables = tuple(jnp.asarray(t.astype(np.int32))
                   for t in _default_cost_tables())
    off = encode_wavefront_core(y, u, v, seg, qs, tables, try_i4=False,
                                use_derr=False)
    on = encode_wavefront_core(y, u, v, seg, qs, tables, try_i4=False,
                               use_derr=True)
    assert not np.array_equal(np.asarray(off["uv_levels"]),
                              np.asarray(on["uv_levels"]))
    # Luma untouched by the UV-only diffusion.
    np.testing.assert_array_equal(np.asarray(off["y_levels"]),
                                  np.asarray(on["y_levels"]))


def test_wavefront_stream_matches_host_encoder_method4():
    """plane_backend=jax at method 4 (i4 on, 4 segments) == host file."""
    img = make_test_images()["photo"][..., :3].copy()
    cfg = dict(lossless=False, quality=70, method=4, segments=4)
    host = encode_rgba(img, config=EncoderConfig(**cfg))
    wave = encode_rgba(
        img, config=EncoderConfig(**cfg, plane_backend="jax"))
    assert host == wave
    np.testing.assert_array_equal(decode_rgba(wave), pil_decode_rgba(wave))


def test_wavefront_stream_matches_host_encoder():
    img = make_test_images()["photo"][..., :3].copy()
    # The wavefront backend must produce the same file as the host
    # closed-loop encoder in its i16 configuration.
    host = encode_rgba(
        img, config=EncoderConfig(lossless=False, quality=70, method=0,
                                  segments=1)
    )
    wave = encode_rgba(
        img, config=EncoderConfig(lossless=False, quality=70, method=0,
                                  segments=1, plane_backend="jax")
    )
    assert host == wave
    np.testing.assert_array_equal(decode_rgba(wave), pil_decode_rgba(wave))


def test_parallel_i4_search_fixed_point():
    """The plane-context parallel i4 search reproduces the exact
    engine's sub-block decisions when given the exact engine's own
    reconstruction as context: with converged ctx the plane pixels ARE
    the Gauss-Seidel scratch values, so costs — and argmins — match.
    (This is the fixed-point property the hybrid engine's refinement
    relies on, now pinned for the parallel search variant.)"""
    import numpy as np

    from gowebp_tpu.models.vp8.encoder import (
        _default_cost_tables, _i4_config, make_quants, quality_to_q)
    from gowebp_tpu.ops.encode_wavefront_jax import (
        encode_wavefront_core, openloop_mode_search)

    rng = np.random.default_rng(23)
    B, H, W = 2, 64, 80
    y = rng.integers(0, 256, (B, H, W)).astype(np.int32)
    u = rng.integers(0, 256, (B, H // 2, W // 2)).astype(np.int32)
    v = rng.integers(0, 256, (B, H // 2, W // 2)).astype(np.int32)
    q = make_quants(quality_to_q(75.0))
    row = np.array([q.y1_dc.q, q.y1_ac.q, q.y2_dc.q, q.y2_ac.q,
                    q.uv_dc.q, q.uv_ac.q], np.int32)
    qs = np.broadcast_to(row, (B, 4, 6)).copy()
    seg = np.zeros((B, H // 16, W // 16), np.int32)
    tables = tuple(t.astype(np.int32) for t in _default_cost_tables())
    _, pen = _i4_config(q.y1_ac.q, 4, 0)

    exact = encode_wavefront_core(y, u, v, seg, qs, tables, try_i4=True,
                                  i4_penalty=pen, want_recon=True)
    ctx = (exact["recon_y"], exact["recon_u"], exact["recon_v"])
    par = openloop_mode_search(y, u, v, seg, qs, tables, try_i4=True,
                               i4_penalty=pen, ctx=ctx, i4_parallel=True)
    ex_i4 = np.asarray(exact["is_i4"]).astype(bool)
    got_i4 = np.asarray(par["is_i4"]).astype(bool)
    # MBs the exact engine coded as i4 hold THEIR i4 reconstruction in
    # the context plane, so the parallel search sees the very pixels
    # the Gauss-Seidel walk produced: it must re-adopt i4 with the
    # same sub-block modes.  (i16-coded MBs' plane holds i16 recon, so
    # their *hypothetical* i4 score may legitimately differ.)
    assert got_i4[ex_i4].all(), "parallel search dropped a shipped i4 MB"
    np.testing.assert_array_equal(
        np.asarray(par["imodes"])[ex_i4], np.asarray(exact["imodes"])[ex_i4])
    # and overall adoption stays near-identical (i16 flips are rare)
    agree = (got_i4 == ex_i4).mean()
    assert agree >= 0.97, f"only {agree:.1%} i4-adoption agreement"
