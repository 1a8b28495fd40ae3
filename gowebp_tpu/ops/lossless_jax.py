"""VP8L transforms as JAX array programs (device plane engine).

Batched (…, H, W) uint32 ARGB pixels.  The encode-side transforms
(subtract-green, cross-color, predictor residuals, palette packing) are
fully parallel; the decode-side predictor inverse is a row scan
(`lax.scan`) with the in-row left dependency handled per predictor.

Golden-tested against models/vp8l/transforms_np.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax



# uint32 mask constants (plain Python ints overflow in 32-bit jax mode).
_M_AG = jnp.uint32(0xFF00FF00)
_M_RB = jnp.uint32(0x00FF00FF)
_M_GUARD = jnp.uint32(0x01000100)
_M_AVG = jnp.uint32(0xFEFEFEFE)
_BLACK = jnp.uint32(0xFF000000)
_FF = jnp.uint32(0xFF)


def _ch(v):
    v = v.astype(jnp.uint32)
    return (v >> 24) & _FF, (v >> 16) & _FF, (v >> 8) & _FF, v & _FF


def _pack(a, r, g, b):
    return ((a << 24) | (r << 16) | (g << 8) | b).astype(jnp.uint32)


def add_green_inverse(argb: jnp.ndarray) -> jnp.ndarray:
    g = (argb >> 8) & _FF
    r = (((argb >> 16) & _FF) + g) & _FF
    b = ((argb & _FF) + g) & _FF
    return ((argb & _M_AG) | (r << 16) | b).astype(jnp.uint32)


def subtract_green_forward(argb: jnp.ndarray) -> jnp.ndarray:
    g = (argb >> 8) & _FF
    r = (((argb >> 16) & _FF) - g) & _FF
    b = ((argb & _FF) - g) & _FF
    return ((argb & _M_AG) | (r << 16) | b).astype(jnp.uint32)


def _delta(t_u8, c_u8):
    t = t_u8.astype(jnp.int8).astype(jnp.int32)
    c = c_u8.astype(jnp.int8).astype(jnp.int32)
    return (t * c) >> 5


def _tile_gather(img: jnp.ndarray, h: int, w: int, bits: int) -> jnp.ndarray:
    ty = jnp.arange(h) >> bits
    tx = jnp.arange(w) >> bits
    return img[..., ty[:, None], tx[None, :]]


def color_transform_inverse(argb, transform_img, bits: int):
    h, w = argb.shape[-2:]
    tiles = _tile_gather(transform_img, h, w, bits)
    g2r = (tiles & _FF).astype(jnp.uint32)
    g2b = ((tiles >> 8) & _FF).astype(jnp.uint32)
    r2b = ((tiles >> 16) & _FF).astype(jnp.uint32)
    g = (argb >> 8) & _FF
    r = (argb >> 16) & _FF
    b = argb & _FF
    new_r = (r.astype(jnp.int32) + _delta(g2r, g)).astype(jnp.uint32) & _FF
    new_b = (
        b.astype(jnp.int32) + _delta(g2b, g) + _delta(r2b, new_r)
    ).astype(jnp.uint32) & _FF
    return ((argb & _M_AG) | (new_r << 16) | new_b).astype(jnp.uint32)


def color_transform_forward(argb, transform_img, bits: int):
    h, w = argb.shape[-2:]
    tiles = _tile_gather(transform_img, h, w, bits)
    g2r = (tiles & _FF).astype(jnp.uint32)
    g2b = ((tiles >> 8) & _FF).astype(jnp.uint32)
    r2b = ((tiles >> 16) & _FF).astype(jnp.uint32)
    g = (argb >> 8) & _FF
    r = (argb >> 16) & _FF
    b = argb & _FF
    new_r = (r.astype(jnp.int32) - _delta(g2r, g)).astype(jnp.uint32) & _FF
    # red_to_blue applies to the ORIGINAL red (decoder restores it first).
    new_b = (
        b.astype(jnp.int32) - _delta(g2b, g) - _delta(r2b, r)
    ).astype(jnp.uint32) & _FF
    return ((argb & _M_AG) | (new_r << 16) | new_b).astype(jnp.uint32)


def palette_inverse(idx: jnp.ndarray, palette: jnp.ndarray) -> jnp.ndarray:
    """idx: (..., H, W) int indices → ARGB via the (n,) palette."""
    safe = jnp.zeros(256, jnp.uint32).at[: len(palette)].set(palette)
    return safe[idx]


# ---------------------------------------------------------------------------
# Predictors (encode side: full-plane parallel; all 14 modes)
# ---------------------------------------------------------------------------


def _avg2(a, b):
    return (((a ^ b) & _M_AVG) >> 1) + (a & b)


def _clip255(v):
    return jnp.clip(v, 0, 255).astype(jnp.uint32)


def _select(l, t, tl):
    la, lr, lg, lb = _ch(l)
    ta, tr_, tg, tb = _ch(t)
    ca, cr, cg, cb = _ch(tl)

    def d(x, y):
        return jnp.abs(x.astype(jnp.int32) - y.astype(jnp.int32))

    p_l = d(ta, ca) + d(tr_, cr) + d(tg, cg) + d(tb, cb)
    p_t = d(la, ca) + d(lr, cr) + d(lg, cg) + d(lb, cb)
    return jnp.where(p_l < p_t, l, t)


def _casf(l, t, tl):
    la, lr, lg, lb = (c.astype(jnp.int32) for c in _ch(l))
    ta, tr_, tg, tb = (c.astype(jnp.int32) for c in _ch(t))
    ca, cr, cg, cb = (c.astype(jnp.int32) for c in _ch(tl))
    return _pack(
        _clip255(la + ta - ca), _clip255(lr + tr_ - cr),
        _clip255(lg + tg - cg), _clip255(lb + tb - cb),
    )


def _cash(l, t, tl):
    ave = _avg2(l, t)
    aa, ar, ag, ab = (c.astype(jnp.int32) for c in _ch(ave))
    ca, cr, cg, cb = (c.astype(jnp.int32) for c in _ch(tl))

    def half(a, b):
        d = a - b
        h = jnp.where(d >= 0, d // 2, -((-d) // 2))
        return _clip255(a + h)

    return _pack(half(aa, ca), half(ar, cr), half(ag, cg), half(ab, cb))


def apply_predictor(mode: int, l, t, tl, tr):
    if mode == 0:
        return jnp.full_like(l, _BLACK)
    if mode == 1:
        return l
    if mode == 2:
        return t
    if mode == 3:
        return tr
    if mode == 4:
        return tl
    if mode == 5:
        return _avg2(_avg2(l, tr), t)
    if mode == 6:
        return _avg2(l, tl)
    if mode == 7:
        return _avg2(l, t)
    if mode == 8:
        return _avg2(tl, t)
    if mode == 9:
        return _avg2(t, tr)
    if mode == 10:
        return _avg2(_avg2(l, tl), _avg2(t, tr))
    if mode == 11:
        return _select(l, t, tl)
    if mode == 12:
        return _casf(l, t, tl)
    if mode == 13:
        return _cash(l, t, tl)
    raise ValueError(mode)


def _neighbors(argb: jnp.ndarray):
    """L, T, TL, TR context planes (encode side, source context)."""
    z = jnp.zeros_like(argb[..., :1, :])
    L = jnp.concatenate([jnp.zeros_like(argb[..., :, :1]), argb[..., :, :-1]], axis=-1)
    T = jnp.concatenate([z, argb[..., :-1, :]], axis=-2)
    TL = jnp.concatenate(
        [jnp.zeros_like(argb[..., :, :1]), T[..., :, :-1]], axis=-1
    )
    TR = jnp.concatenate(
        [T[..., :, 1:], T[..., :, :1]], axis=-1
    )
    # TR of the last column wraps to current row's first pixel.
    TR = TR.at[..., 1:, -1].set(argb[..., 1:, 0])
    return L, T, TL, TR


def _sub_pixels(x, p):
    lo = ((x | _M_GUARD) - (p & _M_RB)) & _M_RB
    hi = (((x >> 8) | _M_GUARD) - ((p >> 8) & _M_RB)) & _M_RB
    return (lo | (hi << 8)).astype(jnp.uint32)


def predict_plane(argb: jnp.ndarray, mode: int) -> jnp.ndarray:
    """Full-plane prediction under `mode` with decoder edge semantics."""
    h = argb.shape[-2]
    w = argb.shape[-1]
    L, T, TL, TR = _neighbors(argb)
    pred = apply_predictor(mode, L, T, TL, TR)
    row_idx = jnp.arange(h)[:, None]
    col_idx = jnp.arange(w)[None, :]
    pred = jnp.where(row_idx == 0, L, pred)          # top row → Left
    pred = jnp.where(col_idx == 0, T, pred)          # left col → Top
    pred = pred.at[..., 0, 0].set(_BLACK)        # origin → black
    return pred


@partial(jax.jit, static_argnames=("bits",))
def predictor_search(argb: jnp.ndarray, bits: int):
    """Per-tile best-of-14 predictor by residual-cost proxy (device-shaped).

    Returns (mode_img uint32 ARGB tile pixels, residual image uint32).
    """
    h, w = argb.shape[-2:]
    tile = 1 << bits
    th = -(-h // tile)
    tw = -(-w // tile)
    cost_tab = _residual_cost_table()
    costs = []
    residuals = []
    for mode in range(14):
        pred = predict_plane(argb, mode)
        res = _sub_pixels(argb, pred)
        residuals.append(res)
        c = (
            cost_tab[(res >> 24) & _FF]
            + cost_tab[(res >> 16) & _FF]
            + cost_tab[(res >> 8) & _FF]
            + cost_tab[res & _FF]
        )
        cp = jnp.zeros((th * tile, tw * tile), c.dtype)
        cp = cp.at[:h, :w].set(c)
        costs.append(cp.reshape(th, tile, tw, tile).sum(axis=(1, 3)))
    costs = jnp.stack(costs)                       # (14, th, tw)
    modes = jnp.argmin(costs, axis=0).astype(jnp.uint32)
    mode_img = (_BLACK | (modes << 8)).astype(jnp.uint32)
    res_stack = jnp.stack(residuals)               # (14, h, w)
    mode_px = modes[jnp.arange(h)[:, None] >> bits, jnp.arange(w)[None, :] >> bits]
    residual = jnp.take_along_axis(
        res_stack, mode_px[None].astype(jnp.int32), axis=0
    )[0]
    # Edge pixels use the fixed edge predictors independent of tile mode;
    # every per-mode residual already encodes them identically.
    return mode_img, residual


def chosen_histogram(onehot_modes, histf):
    """(T, 14) one-hot tile modes × (14, T, 4, 256) tile histograms →
    (4, 256) histogram of the chosen residuals.

    The counts are integers below 2^24 (at most the image's pixel
    count), so every partial sum is exact in f32 at HIGHEST precision;
    TF32 operands would round tile counts above 2^11.
    """
    return jnp.einsum("tm,mtcb->cb", onehot_modes, histf,
                      precision=lax.Precision.HIGHEST)


def _residual_cost_table():
    import numpy as np

    v = np.arange(256)
    folded = np.minimum(v, 256 - v)
    return jnp.array((2 * np.ceil(np.log2(1 + folded)) + 1), jnp.int32)


@partial(jax.jit, static_argnames=("bits", "refine_iters"))
def predictor_search_entropy(argb: jnp.ndarray, bits: int,
                             refine_iters: int = 4) -> jnp.ndarray:
    """Per-tile best-of-14 predictor by residual-histogram ENTROPY.

    The device twin of the host chooser (`wtpu_vp8l_choose_predictors`,
    entropy/native/vp8l_dec.cpp:666; reference cost model:
    predictor_enc.go:227-716 GetBestPredictorsAndSubSampling): stage 1
    scores each tile by the Shannon entropy of its four per-channel
    residual-byte histograms plus the 0.04·folded magnitude bias;
    stage 2 refines against the global distribution of the currently
    chosen residuals with a mode-frequency prior.

    The pixel-rate work is ONE pass building a (14, T, 4, 256)
    histogram tensor (int8 one-hot chunks reduced on-device — no
    gathers/scatters); every refinement iteration then runs on that
    tensor alone, and only the (th, tw) mode map leaves the device.

    Scores use f32 (the host uses f64), so rare near-tie tiles may
    pick a different — equally priced — mode; the golden test pins
    tile agreement and output size, not bit equality of the mode map.
    Every contraction runs at HIGHEST precision: at the default one an
    H100 may round the f32 operands to TF32.

    Returns the mode map as (th, tw) int32.
    """
    h, w = argb.shape[-2:]
    tile = 1 << bits
    th = -(-h // tile)
    tw = -(-w // tile)
    T = th * tw
    P = tile * tile

    # Per-mode residual bytes, padded to full tiles with the sentinel
    # 256 (a 257th bin that never contributes to any real histogram).
    def tile_bytes(res):
        full = jnp.full((4, th * tile, tw * tile), 256, jnp.int32)
        by = jnp.stack([(res >> 24) & _FF, (res >> 16) & _FF,
                        (res >> 8) & _FF, res & _FF]).astype(jnp.int32)
        full = full.at[:, :h, :w].set(by)
        return full.reshape(4, th, tile, tw, tile).transpose(
            0, 1, 3, 2, 4).reshape(4, T, P)

    CHUNK = 64 if T >= 64 else T

    def hist_of(by):                    # (4, T, P) -> (T, 4, 256) i32
        Tp = -(-T // CHUNK) * CHUNK
        byp = jnp.full((4, Tp, P), 256, jnp.int32).at[:, :T].set(by)
        chunks = byp.reshape(4, Tp // CHUNK, CHUNK, P).transpose(
            1, 0, 2, 3)                 # (nc, 4, CHUNK, P)

        def one(c):
            oh = jax.nn.one_hot(c, 257, dtype=jnp.int8)
            return oh.sum(axis=2, dtype=jnp.int32)[..., :256]

        out = lax.map(one, chunks)      # (nc, 4, CHUNK, 256)
        return out.transpose(0, 2, 1, 3).reshape(Tp, 4, 256)[:T]

    hists = []
    for mode in range(14):
        pred = predict_plane(argb, mode)
        res = _sub_pixels(argb, pred)
        hists.append(hist_of(tile_bytes(res)))
    hist = jnp.stack(hists)             # (14, T, 4, 256) int32
    histf = hist.astype(jnp.float32)

    # stage 1: per-tile entropy + magnitude bias
    npx = histf[0, :, 0].sum(axis=-1)   # true pixels per tile
    n_log_n = 4.0 * npx * jnp.log2(jnp.maximum(npx, 1.0))
    v = jnp.arange(256)
    folded = jnp.minimum(v, 256 - v).at[0].set(0).astype(jnp.float32)
    ent = n_log_n[None] - (histf * jnp.log2(jnp.maximum(histf, 1.0))
                           ).sum(axis=(2, 3))
    bias = (histf * (0.04 * folded)).sum(axis=(2, 3))
    modes = jnp.argmin(ent + bias, axis=0).astype(jnp.int32)   # (T,)

    # stage 2: refinement against the global chosen-residual law
    def refine(_, modes):
        mh = jax.nn.one_hot(modes, 14, dtype=jnp.float32)      # (T, 14)
        glob = chosen_histogram(mh, histf)
        tot = glob.sum(axis=1, keepdims=True)
        logp = jnp.log2((glob + 0.1) / (tot + 25.6))
        cost = -jnp.einsum("mtcb,cb->mt", histf, logp,
                           precision=lax.Precision.HIGHEST)    # (14, T)
        mcount = mh.sum(axis=0)
        mode_cost = -jnp.log2((mcount + 0.1) / (T + 1.4))
        return jnp.argmin(cost + mode_cost[:, None],
                          axis=0).astype(jnp.int32)

    modes = lax.fori_loop(0, refine_iters, refine, modes)
    return modes.reshape(th, tw)


# ---------------------------------------------------------------------------
# Predictor inverse (decode side): row scan with in-row dependency
# ---------------------------------------------------------------------------


def predictor_inverse(residuals: jnp.ndarray, mode_img: jnp.ndarray,
                      bits: int) -> jnp.ndarray:
    """Exact inverse via lax.scan over rows, inner scan over columns.

    Correct but scalar-sequential in-row — the production decode path
    uses the native host kernel; this exists for an all-device pipeline.
    """
    h, w = residuals.shape
    modes = ((mode_img >> 8) & _FF).astype(jnp.int32)
    tile_row = jnp.arange(h) >> bits
    tile_col = (jnp.arange(w) >> bits).astype(jnp.int32)

    def row_step(prev_row, inputs):
        res_row, trow = inputs
        mode_row = modes[trow][tile_col]

        def col_step(carry, xs):
            left, x = carry, xs[0]
            res, mode = xs[1], xs[2]
            t = prev_row[x]
            tl = jnp.where(x > 0, prev_row[x - 1], 0)
            tr = jnp.where(x + 1 < w, prev_row[jnp.minimum(x + 1, w - 1)], left_of_row0)
            preds = [
                jnp.full((), _BLACK, jnp.uint32), left, t, tr, tl,
                _avg2(_avg2(left, tr), t), _avg2(left, tl), _avg2(left, t),
                _avg2(tl, t), _avg2(t, tr),
                _avg2(_avg2(left, tl), _avg2(t, tr)),
                _select(left, t, tl), _casf(left, t, tl), _cash(left, t, tl),
            ]
            pred = jnp.select([mode == m for m in range(14)], preds)
            pred = jnp.where(x == 0, t, pred)
            px = _add_pixels(res, pred)
            return px, px

        left_of_row0 = jnp.zeros((), jnp.uint32)

        xs = (
            jnp.arange(w, dtype=jnp.int32),
            res_row,
            mode_row,
        )
        # First pixel of the row: pred = T (above), handled inside.
        _, row = jax.lax.scan(
            lambda c, x: col_step(c, x), jnp.zeros((), jnp.uint32),
            xs=jnp.stack([xs[0].astype(jnp.uint32), xs[1], xs[2].astype(jnp.uint32)], axis=-1).astype(jnp.uint32),
        )
        # TR wrap for the last column needs row[0]; re-run the final pixel.
        last_res = res_row[w - 1]
        lmode = mode_row[w - 1]
        t = prev_row[w - 1]
        tl = prev_row[w - 2] if w > 1 else jnp.zeros((), jnp.uint32)
        tr = row[0]
        left = row[w - 2] if w > 1 else jnp.zeros((), jnp.uint32)
        preds = [
            jnp.full((), _BLACK, jnp.uint32), left, t, tr, tl,
            _avg2(_avg2(left, tr), t), _avg2(left, tl), _avg2(left, t),
            _avg2(tl, t), _avg2(t, tr),
            _avg2(_avg2(left, tl), _avg2(t, tr)),
            _select(left, t, tl), _casf(left, t, tl), _cash(left, t, tl),
        ]
        pred = jnp.select([lmode == m for m in range(14)], preds)
        pred = jnp.where(w == 1, t, pred)
        row = row.at[w - 1].set(_add_pixels(last_res, pred))
        return row, row

    # Row 0 is a plain left-to-right cumulative add (pred = Left).
    def row0(res_row):
        def step(left, res):
            px = _add_pixels(res, left)
            return px, px

        first = _add_pixels(res_row[0], jnp.asarray(_BLACK, jnp.uint32))
        _, rest = jax.lax.scan(step, first, res_row[1:])
        return jnp.concatenate([first[None], rest])

    r0 = row0(residuals[0])
    _, rows = jax.lax.scan(
        row_step, r0, (residuals[1:], tile_row[1:])
    )
    return jnp.concatenate([r0[None], rows], axis=0)


def _add_pixels(x, p):
    lo = ((x & _M_RB) + (p & _M_RB)) & _M_RB
    hi = (((x >> 8) & _M_RB) + ((p >> 8) & _M_RB)) & _M_RB
    return (lo | (hi << 8)).astype(jnp.uint32)


__all__ = [
    "add_green_inverse",
    "subtract_green_forward",
    "color_transform_inverse",
    "color_transform_forward",
    "palette_inverse",
    "predict_plane",
    "predictor_search",
    "predictor_inverse",
]
