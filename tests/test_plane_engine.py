"""Plain-XLA device programs vs their NumPy and native references.

The open-loop plane engine and the batch YUV→RGBA post-processing
against scalar NumPy references, and the hybrid engine's fixed-mode
wavefront (phase 2) against the native host encoder.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from gowebp_tpu.models.vp8 import dsp_np
from gowebp_tpu.models.vp8.tables import ZIGZAG
from gowebp_tpu.ops import yuv_np
from gowebp_tpu.ops.encode_plane_jax import encode_plane_core_v2
from gowebp_tpu.ops.yuv_jax import batch_yuv_to_rgba

RNG = np.random.default_rng(1234)

QUANTS = dict(y1_dc=8, y1_ac=17, y2_dc=16, y2_ac=34, uv_dc=8, uv_ac=17)
QUANTS2 = dict(y1_dc=24, y1_ac=40, y2_dc=48, y2_ac=80, uv_dc=20, uv_ac=35)


def _quant_zz(raster16, q_dc, bias_dc, q_ac, bias_ac, first_ac=False):
    """QUANTDIV of one block's raster coefficients → zigzag levels."""
    zz = np.asarray(raster16, np.int64)[list(ZIGZAG)]
    iq = np.array([(1 << 17) // q_dc] + [(1 << 17) // q_ac] * 15, np.int64)
    bias = np.array([bias_dc] + [bias_ac] * 15, np.int64)
    lv = np.minimum((np.abs(zz) * iq + bias) >> 17, 2047)
    if first_ac:
        lv[0] = 0
    return np.where(zz < 0, -lv, lv)


def _preds(plane, my, mx, n):
    """DC/TM/VE/HE predictions of MB (my, mx) from SOURCE context."""
    top = (plane[n * my - 1, n * mx:n * mx + n].astype(np.int64) if my
           else np.full(n, 127, np.int64))
    left = (plane[n * my:n * my + n, n * mx - 1].astype(np.int64) if mx
            else np.full(n, 129, np.int64))
    tl = 127 if my == 0 else (129 if mx == 0 else int(plane[n * my - 1,
                                                           n * mx - 1]))
    if my and mx:
        dc = dsp_np.pred_dc(top, left, n)
    elif mx:
        dc = dsp_np.pred_dc_no_top(left, n)
    elif my:
        dc = dsp_np.pred_dc_no_top(top, n)
    else:
        dc = dsp_np.pred_dc_no_topleft()
    return [np.full((n, n), dc, np.int64), dsp_np.pred_tm(top, left, tl, n),
            np.broadcast_to(top[None, :], (n, n)),
            np.broadcast_to(left[:, None], (n, n))]


def _openloop_ref(y, u, v, q):
    """Scalar NumPy open-loop encode of one image (the plane engine's
    semantics: every MB predicts from source pixels)."""
    mh, mw = y.shape[0] // 16, y.shape[1] // 16
    out = {"ymode": np.zeros((mh, mw), np.int64),
           "uvmode": np.zeros((mh, mw), np.int64),
           "y_levels": np.zeros((mh, mw, 16, 16), np.int64),
           "y2_levels": np.zeros((mh, mw, 16), np.int64),
           "uv_levels": np.zeros((mh, mw, 8, 16), np.int64)}
    for my in range(mh):
        for mx in range(mw):
            src = y[16 * my:16 * my + 16, 16 * mx:16 * mx + 16].astype(np.int64)
            preds = _preds(y, my, mx, 16)
            mode = int(np.argmin([((src - p) ** 2).sum() for p in preds]))
            res = src - preds[mode]
            coeffs = [dsp_np.fdct4x4(res[4 * by:4 * by + 4, 4 * bx:4 * bx + 4])
                      for by in range(4) for bx in range(4)]
            dcs = np.array([c[0] for c in coeffs])
            out["ymode"][my, mx] = mode
            out["y2_levels"][my, mx] = _quant_zz(
                dsp_np.fwht4x4(dcs), q["y2_dc"], 96 << 9, q["y2_ac"], 96 << 9)
            for b, c in enumerate(coeffs):
                out["y_levels"][my, mx, b] = _quant_zz(
                    c, q["y1_dc"], 96 << 9, q["y1_ac"], 110 << 9, True)
            csrc = [p[8 * my:8 * my + 8, 8 * mx:8 * mx + 8].astype(np.int64)
                    for p in (u, v)]
            cpreds = [_preds(p, my, mx, 8) for p in (u, v)]
            sse = [sum(((s - cp[m]) ** 2).sum() for s, cp in zip(csrc, cpreds))
                   for m in range(4)]
            cmode = int(np.argmin(sse))
            out["uvmode"][my, mx] = cmode
            k = 0
            for s, cp in zip(csrc, cpreds):
                r = s - cp[cmode]
                for by in range(2):
                    for bx in range(2):
                        out["uv_levels"][my, mx, k] = _quant_zz(
                            dsp_np.fdct4x4(r[4 * by:4 * by + 4,
                                             4 * bx:4 * bx + 4]),
                            q["uv_dc"], 110 << 9, q["uv_ac"], 110 << 9)
                        k += 1
    return out


def _planes(b, h, w):
    y = RNG.integers(0, 256, (b, h, w)).astype(np.int32)
    u = RNG.integers(0, 256, (b, h // 2, w // 2)).astype(np.int32)
    v = RNG.integers(0, 256, (b, h // 2, w // 2)).astype(np.int32)
    return y, u, v


def _check_plane_engine(shape, quants):
    y, u, v = _planes(*shape)
    got = encode_plane_core_v2(jnp.array(y), jnp.array(u), jnp.array(v),
                               **quants)
    for b in range(shape[0]):
        want = _openloop_ref(y[b], u[b], v[b], quants)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k][b]), want[k],
                                          err_msg=f"img {b} {k}")


@pytest.mark.parametrize("shape", [(1, 16, 16), (2, 64, 128), (1, 48, 256)])
def test_plane_engine_matches_numpy(shape):
    _check_plane_engine(shape, QUANTS)


def test_plane_engine_other_quants():
    _check_plane_engine((2, 32, 64), QUANTS2)


def _yuv_ref(y, u, v):
    h, w = y.shape
    rgb = yuv_np.yuv_to_rgb(y, yuv_np.fancy_upsample(u, h, w),
                            yuv_np.fancy_upsample(v, h, w))
    return np.concatenate([rgb, np.full((h, w, 1), 255, np.uint8)], axis=-1)


@pytest.mark.parametrize("shape", [(1, 16, 16), (2, 32, 64), (1, 48, 10)])
def test_batch_yuv_to_rgba_matches_numpy(shape):
    b, h, w = shape
    y = RNG.integers(0, 256, (b, h, w)).astype(np.int32)
    u = RNG.integers(0, 256, (b, (h + 1) // 2, (w + 1) // 2)).astype(np.int32)
    v = RNG.integers(0, 256, (b, (h + 1) // 2, (w + 1) // 2)).astype(np.int32)
    got = np.asarray(batch_yuv_to_rgba(y, u, v))
    for k in range(b):
        np.testing.assert_array_equal(got[k], _yuv_ref(y[k], u[k], v[k]))


def test_batch_yuv_to_rgba_alpha_plane():
    from gowebp_tpu.decode import _set_alpha_batch

    b, h, w = 1, 32, 32
    y, u, v = _planes(b, h, w)
    alpha = RNG.integers(0, 256, (b, h, w)).astype(np.uint8)
    got = np.asarray(_set_alpha_batch(batch_yuv_to_rgba(y, u, v), alpha))
    want = _yuv_ref(y[0], u[0], v[0])
    want[..., 3] = alpha[0]
    np.testing.assert_array_equal(got[0], want)


@pytest.mark.parametrize("use_derr", [False, True])
def test_fixed_mode_wavefront_matches_native(use_derr):
    """The hybrid engine's phase 2: given the native host encoder's own
    mode decisions, the fixed-mode wavefront emits its levels exactly
    (i16 and i4 MBs, per-segment quantizers, UV DC error diffusion)."""
    from gowebp_tpu.models.vp8.encoder import (
        _default_cost_tables, _encode_frame_dense_native, make_quants)
    from gowebp_tpu.ops.encode_wavefront_jax import encode_wavefront_core

    rng = np.random.default_rng(5 + use_derr)
    B, H, W = 2, 32, 64
    mh, mw = H // 16, W // 16
    yy, xx = np.mgrid[0:H, 0:W]
    y = np.stack([((yy * 3 + xx + rng.integers(0, 50, (H, W))) % 256)
                  for _ in range(B)]).astype(np.int32)
    y[:, :16, :32] = 128                 # flat MBs: i16 wins there
    u = rng.integers(0, 256, (B, H // 2, W // 2)).astype(np.int32)
    v = rng.integers(0, 256, (B, H // 2, W // 2)).astype(np.int32)
    seg = rng.integers(0, 4, (B, mh, mw)).astype(np.int32)
    quants = [make_quants(q) for q in (30, 40, 55, 70)]
    qs = np.array([(s.y1_dc.q, s.y1_ac.q, s.y2_dc.q, s.y2_ac.q, s.uv_dc.q,
                    s.uv_ac.q) for s in quants], np.int32)
    tables = tuple(t.astype(np.int32) for t in _default_cost_tables())
    nats = []
    for b in range(B):
        nat = _encode_frame_dense_native(
            y[b], u[b], v[b], mw, mh, quants[0], method=4,
            seg={"map": seg[b].reshape(-1).astype(np.uint8),
                 "quants": quants}, use_derr=int(use_derr))
        assert nat is not None, "native host layer did not build"
        nats.append(nat)
    modes = tuple(np.stack([np.asarray(n[k]).reshape(shape) for n in nats])
                  .astype(np.int32) for k, shape in
                  (("ymode", (mh, mw)), ("uvmode", (mh, mw)),
                   ("is_i4", (mh, mw)), ("imodes", (mh, mw, 16))))
    assert modes[2].any() and not modes[2].all(), "want i4 and i16 MBs"
    got = encode_wavefront_core(
        y, u, v, seg, np.broadcast_to(qs, (B, 4, 6)).copy(), tables,
        try_i4=True, modes=modes, use_derr=use_derr)
    for b, nat in enumerate(nats):
        for key, nk in (("y2_levels", "y2"), ("y_levels", "yl"),
                        ("uv_levels", "uvl")):
            want = np.asarray(nat[nk])
            np.testing.assert_array_equal(
                np.asarray(got[key][b]).reshape(want.shape), want,
                err_msg=f"img {b} {key}")
