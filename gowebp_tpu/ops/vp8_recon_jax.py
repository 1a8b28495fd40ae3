"""VP8 decode reconstruction engine on the accelerator (JAX/XLA).

The host entropy phase (models/vp8/decoder.decode_vp8_symbols) ships dense
per-MB tensors; everything pixel-shaped runs here as batched integer ops:

- iDCT of all residual blocks at once (fully parallel),
- intra prediction as an MB anti-diagonal wavefront (slope 2:
  t = 2*mb_y + mb_x, honouring the top-right dependency) with the 16
  luma sub-blocks of i4 MBs scanned by an inner fori_loop,
- the in-loop deblocking filter re-running the same wavefront schedule
  in place after reconstruction (prediction context is *unfiltered*
  reconstruction, so the filter pass can safely mutate).

The planes live in a **skewed tile layout** during the wavefronts:
tile (mb_y, mb_x) is stored at column 2*mb_y + mb_x (+3 lead padding) of
a (B, mb_h, T+3, 16, 16) array, so one anti-diagonal is one column and
every per-step access is a lax.dynamic_slice / dynamic_update_slice of
3-4 adjacent columns — no gather/scatter in the hot loop (slices update
the loop state in place).  The skew/unskew are single one-time gathers
outside the loop.

All arithmetic is exact int32; outputs are bit-identical to the NumPy
reference in models/vp8/decoder.py and therefore to libwebp.

Feature parity target: /root/reference/pkg/libwebp/decoder/frame_dec.c.go
(ReconstructRow :69-197, DoFilter :204-251) and dsp/dec.c.go kernels
(:49-140 transforms, :198-420 predictors) — re-designed as tensor ops,
not a translation.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as _np
from jax import lax

I32 = jnp.int32


def _clip8(x):
    return jnp.clip(x, 0, 255)


def _switch(idx, branches, expand: int):
    """branches[idx] per element — a where-chain instead of a gather.

    A K-way select chain fuses with its elementwise neighbours.
    idx (...) int; each branch broadcastable to the output; ``expand``
    trailing dims are appended to idx for the compare.
    """
    out = branches[-1]
    for k in range(len(branches) - 2, -1, -1):
        cond = (idx == k).reshape(idx.shape + (1,) * expand)
        out = jnp.where(cond, branches[k], out)
    return out


def _avg2(a, b):
    return (a + b + 1) >> 1


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


# ---------------------------------------------------------------------------
# Inverse DCT (RFC 6386 §14.4) — batched
# ---------------------------------------------------------------------------

def _mul1(a):
    return a + ((a * 20091) >> 16)


def _mul2(a):
    return (a * 35468) >> 16


def idct4x4_batch(coeffs):
    """(..., 16) int32 dequantized coefficients → (..., 4, 4) residual.

    The residual is the value added to the prediction (already includes
    the +4 rounding and >>3).  A zero block yields a zero residual, so
    the engine applies it unconditionally (no has_nz bookkeeping).
    """
    c = coeffs.reshape(coeffs.shape[:-1] + (4, 4)).astype(I32)
    c0, c1, c2, c3 = c[..., 0, :], c[..., 1, :], c[..., 2, :], c[..., 3, :]
    a = c0 + c2
    b = c0 - c2
    cc = _mul2(c1) - _mul1(c3)
    d = _mul1(c1) + _mul2(c3)
    tmp = jnp.stack([a + d, b + cc, b - cc, a - d], axis=-2)
    t = tmp.swapaxes(-1, -2)
    t0, t1, t2, t3 = t[..., 0, :], t[..., 1, :], t[..., 2, :], t[..., 3, :]
    dc = t0 + 4
    a = dc + t2
    b = dc - t2
    cc = _mul2(t1) - _mul1(t3)
    d = _mul1(t1) + _mul2(t3)
    out = jnp.stack([a + d, b + cc, b - cc, a - d], axis=-2).swapaxes(-1, -2)
    return out >> 3


def residual_blocks(coeffs):
    """(B, N, 24, 16) int coeffs → per-MB residual blocks.

    Returns (Yres (B,N,16,16), Ures (B,N,8,8), Vres (B,N,8,8)) int32.
    Luma sub-block n sits at rows 4*(n>>2), cols 4*(n&3); chroma blocks
    are the raster 2x2 grid (matches decoder._SCAN).
    """
    B, N = coeffs.shape[0], coeffs.shape[1]
    res = idct4x4_batch(coeffs)                      # (B, N, 24, 4, 4)
    ly = res[:, :, :16].reshape(B, N, 4, 4, 4, 4)
    Yres = ly.transpose(0, 1, 2, 4, 3, 5).reshape(B, N, 16, 16)
    cu = res[:, :, 16:20].reshape(B, N, 2, 2, 4, 4)
    Ures = cu.transpose(0, 1, 2, 4, 3, 5).reshape(B, N, 8, 8)
    cv = res[:, :, 20:24].reshape(B, N, 2, 2, 4, 4)
    Vres = cv.transpose(0, 1, 2, 4, 3, 5).reshape(B, N, 8, 8)
    return Yres, Ures, Vres


# ---------------------------------------------------------------------------
# Intra predictors — vectorized over (B, mb_h) wavefront slots
# ---------------------------------------------------------------------------

def _pred16(top, left, tl, res, ymode, ht, hl, size):
    """DC/TM/VE/HE block prediction + residual add for an NxN block.

    top (B,M,N), left (B,M,N), tl (B,M), res (B,M,N,N), ymode (B,M),
    ht/hl (M,) bool.  Returns clipped (B,M,N,N).
    """
    sum_t = top.sum(-1)
    sum_l = left.sum(-1)
    if size == 16:
        dc_both = (sum_t + sum_l + 16) >> 5
        dc_one_l = (sum_l + 8) >> 4
        dc_one_t = (sum_t + 8) >> 4
    else:
        dc_both = (sum_t + sum_l + 8) >> 4
        dc_one_l = (sum_l + 4) >> 3
        dc_one_t = (sum_t + 4) >> 3
    ht = ht[None, :]
    hl = hl[None, :]
    dc = jnp.where(
        ht & hl, dc_both,
        jnp.where(hl, dc_one_l, jnp.where(ht, dc_one_t, 128)))
    p_dc = jnp.broadcast_to(dc[..., None, None], res.shape)
    p_tm = _clip8(left[..., :, None] + top[..., None, :] - tl[..., None, None])
    p_ve = jnp.broadcast_to(top[..., None, :], res.shape)
    p_he = jnp.broadcast_to(left[..., :, None], res.shape)
    pred = _switch(ymode.astype(I32), [p_dc, p_tm, p_ve, p_he], 2)
    return _clip8(pred + res)


def _b4_index_tables():
    """Static lookup tables for the 8 shift-composable B-mode predictors.

    Context vector Z = [L, L, K, J, I, X, A, B, C, D, E, F, G, H, H]
    (15 entries; the duplicated L/H endpoints make every avg3 the
    predictors use a *consecutive* triple).  The feature vector is
    [Z (15) | avg2 of consecutive pairs (14) | avg3 of consecutive
    triples (13)] = 42 entries; each predictor's 16 output pixels are a
    static index into it, so all 8 predictions reduce to one gather.
    """
    import numpy as _np

    Zi = {"L": 1, "K": 2, "J": 3, "I": 4, "X": 5, "A": 6, "B": 7,
          "C": 8, "D": 9, "E": 10, "F": 11, "G": 12, "H": 13}

    def z(n):
        return Zi[n]

    def a2(n1, n2):
        i, j = sorted((Zi[n1], Zi[n2]))
        assert j == i + 1, (n1, n2)
        return 15 + i

    def a3(n1, n2, n3):
        c = Zi[n2]
        lo, hi = sorted((Zi[n1], Zi[n3]))
        # duplicated endpoints: avg3(K,L,L) = triple (0,1,2), avg3(G,H,H)
        # = triple (12,13,14)
        assert (lo, hi) == (c - 1, c + 1) or \
            (n3 == n2 and Zi[n1] in (c - 1, c + 1)), (n1, n2, n3)
        return 15 + 14 + (c - 1)

    ve = [a3("X", "A", "B"), a3("A", "B", "C"), a3("B", "C", "D"),
          a3("C", "D", "E")]
    p_ve = [ve, ve, ve, ve]
    he = [a3("X", "I", "J"), a3("I", "J", "K"), a3("J", "K", "L"),
          a3("K", "L", "L")]
    p_he = [[h] * 4 for h in he]

    dcb = a3("D", "C", "B")
    cba = a3("C", "B", "A")
    bax = a3("B", "A", "X")
    axi = a3("A", "X", "I")
    xij = a3("X", "I", "J")
    ijk = a3("I", "J", "K")
    jkl = a3("J", "K", "L")
    p_rd = [[axi, bax, cba, dcb],
            [xij, axi, bax, cba],
            [ijk, xij, axi, bax],
            [jkl, ijk, xij, axi]]

    xa, ab, bc, cd, de = (a2("X", "A"), a2("A", "B"), a2("B", "C"),
                          a2("C", "D"), a2("D", "E"))
    kji = a3("K", "J", "I")
    jix = a3("J", "I", "X")
    ixa = a3("I", "X", "A")
    xab = a3("X", "A", "B")
    abc = a3("A", "B", "C")
    bcd = a3("B", "C", "D")
    p_vr = [[xa, ab, bc, cd],
            [ixa, xab, abc, bcd],
            [jix, xa, ab, bc],
            [kji, ixa, xab, abc]]

    cde = a3("C", "D", "E")
    def_ = a3("D", "E", "F")
    efg = a3("E", "F", "G")
    fgh = a3("F", "G", "H")
    ghh = a3("G", "H", "H")
    p_ld = [[abc, bcd, cde, def_],
            [bcd, cde, def_, efg],
            [cde, def_, efg, fgh],
            [def_, efg, fgh, ghh]]

    p_vl = [[ab, bc, cd, de],
            [abc, bcd, cde, def_],
            [bc, cd, de, efg],
            [bcd, cde, def_, fgh]]

    ix, ji, kj, lk = (a2("I", "X"), a2("J", "I"), a2("K", "J"),
                      a2("L", "K"))
    p_hd = [[ix, ixa, xab, abc],
            [ji, xij, ix, ixa],
            [kj, ijk, ji, xij],
            [lk, jkl, kj, ijk]]

    ij, jk, kl = a2("I", "J"), a2("J", "K"), a2("K", "L")
    jkl3 = a3("J", "K", "L")
    kll = a3("K", "L", "L")
    Lz = z("L")
    p_hu = [[ij, ijk, jk, jkl3],
            [jk, jkl3, kl, kll],
            [kl, kll, Lz, Lz],
            [Lz, Lz, Lz, Lz]]

    return _np.array([p_ve, p_he, p_rd, p_vr, p_ld, p_vl, p_hd, p_hu],
                     _np.int32)


_B4_IDX = _b4_index_tables()                       # (8, 4, 4)
_B4_SEL = _np.zeros((42, 128), _np.float32)        # one-hot select matrix
_B4_SEL[_B4_IDX.reshape(-1), _np.arange(128)] = 1.0


def _pred_luma4_all(tl, top, tr, left):
    """All 10 B-mode predictions of a 4x4 block.

    tl (B,M), top/tr/left (B,M,4) → (B,M,10,4,4) int32.  Mirrors
    dsp_np.predict_luma4 exactly (libwebp enum DC,TM,VE,HE,RD,VR,LD,VL,
    HD,HU).  The 8 shift-composable modes come from one static gather
    over the shared [Z | avg2 | avg3] feature vector; DC and TM are
    computed directly.
    """
    lead = tl.shape
    # Z = [L, L, K, J, I, X, A, B, C, D, E, F, G, H, H]
    Z = jnp.concatenate(
        [left[..., 3:4], left[..., ::-1], tl[..., None], top, tr,
         tr[..., 3:4]], axis=-1)                    # (B,M,15)
    a2 = _avg2(Z[..., :-1], Z[..., 1:])             # (B,M,14)
    a3 = _avg3(Z[..., :-2], Z[..., 1:-1], Z[..., 2:])  # (B,M,13)
    feat = jnp.concatenate([Z, a2, a3], axis=-1)    # (B,M,42)
    # Static index selection as a one-hot f32 matmul: each output sums
    # exactly one nonzero product, so it is exact for features below
    # 2^24 at HIGHEST precision (they are pixels and pixel averages,
    # 0..255).  The default precision may run in TF32, exact only below
    # 2^11.
    preds8 = jnp.matmul(
        feat.astype(jnp.float32), _B4_SEL, preferred_element_type=jnp.float32,
        precision=lax.Precision.HIGHEST,
    ).astype(I32).reshape(lead + (8, 4, 4))

    dc = (top.sum(-1) + left.sum(-1) + 4) >> 3
    p_dc = jnp.broadcast_to(dc[..., None, None], lead + (4, 4))
    p_tm = _clip8(left[..., :, None] + top[..., None, :] - tl[..., None, None])
    return jnp.concatenate(
        [p_dc[..., None, :, :], p_tm[..., None, :, :], preds8], axis=-3)


# ---------------------------------------------------------------------------
# Skewed layout helpers
# ---------------------------------------------------------------------------

def num_diagonals(mb_w: int, mb_h: int) -> int:
    return (mb_w - 1) + 2 * (mb_h - 1) + 1


def _skew_index(mb_w: int, mb_h: int):
    """(mb_h, T) flat MB index per skewed column + validity mask."""
    T = num_diagonals(mb_w, mb_h)
    my = jnp.arange(mb_h, dtype=I32)[:, None]
    c = jnp.arange(T, dtype=I32)[None, :]
    mx = c - 2 * my
    valid = (mx >= 0) & (mx < mb_w)
    flat = my * mb_w + jnp.clip(mx, 0, mb_w - 1)
    return flat, valid


def _shift_down(x, fill):
    """Row my reads row my-1: shift along the mb_h axis, pad with fill."""
    pad = jnp.full_like(x[:, :1], fill)
    return jnp.concatenate([pad, x[:, :-1]], axis=1)


def _unskew_plane(Sk, mb_w, mb_h, size):
    """(B, mb_h, T+3, s, s) skewed tiles → (B, mb_h*s, mb_w*s) plane."""
    B = Sk.shape[0]
    my = jnp.arange(mb_h, dtype=I32)[:, None]
    mx = jnp.arange(mb_w, dtype=I32)[None, :]
    col = 2 * my + mx + 3
    tiles = Sk[:, my, col]                         # (B, mb_h, mb_w, s, s)
    return tiles.transpose(0, 1, 3, 2, 4).reshape(
        B, mb_h * size, mb_w * size)


# ---------------------------------------------------------------------------
# Reconstruction wavefront (skewed)
# ---------------------------------------------------------------------------

def _halo_shifts(axis_name, n_shards):
    """(shift_down, shift_up) row-shift helpers; ppermute halos under
    shard_map along ``axis_name`` (MB-row sharding), plain shifts
    otherwise."""
    if axis_name is None:
        def shift_up(x, last_rows):
            return jnp.concatenate([x[:, 1:], last_rows], axis=1)

        return _shift_down, shift_up

    down_perm = [(i, i + 1) for i in range(n_shards - 1)]
    up_perm = [(i + 1, i) for i in range(n_shards - 1)]

    def shift_down(x, fill):
        shifted = _shift_down(x, fill)
        prev_last = lax.ppermute(x[:, -1:], axis_name, down_perm)
        first = lax.axis_index(axis_name) == 0
        row0 = jnp.where(first, jnp.full_like(prev_last, fill), prev_last)
        return shifted.at[:, 0:1].set(row0)

    def shift_up(x, last_rows):
        next_first = lax.ppermute(x[:, :1], axis_name, up_perm)
        last = lax.axis_index(axis_name) == n_shards - 1
        tail = jnp.where(last, last_rows, next_first)
        return jnp.concatenate([x[:, 1:], tail], axis=1)

    return shift_down, shift_up


def _skew_rows(arr, mb_w, mh_local, T, row_offset):
    """(B, mh_local*mb_w, ...) per-MB tensors → (B, mh_local, T, ...)
    with GLOBAL diagonal columns (col = 2*(my+row_offset) + mx)."""
    my = jnp.arange(mh_local, dtype=I32)[:, None]
    mx = jnp.clip(jnp.arange(T, dtype=I32)[None, :]
                  - 2 * (my + row_offset), 0, mb_w - 1)
    return arr.reshape((arr.shape[0], mh_local, mb_w)
                       + arr.shape[2:])[:, my, mx]


def _recon_wavefront_steps(Yres, Ures, Vres, is_i4, imodes, uvmode, *,
                           mb_w, mb_h, axis_name=None, mb_h_global=None,
                           n_shards=1):
    """Factory form of :func:`recon_wavefront`: returns
    (init_carry, step, T) so callers can drive the diagonal loop
    themselves — the fused recon+filter path interleaves this step
    with the loop filter's at a 2-diagonal lag."""
    B = Yres.shape[0]
    M = mb_h
    mhg = mb_h_global if mb_h_global is not None else mb_h
    T = num_diagonals(mb_w, mhg)
    if axis_name is not None:
        row_offset = lax.axis_index(axis_name).astype(I32) * mb_h
    else:
        row_offset = jnp.int32(0)
    _shift, _ = _halo_shifts(axis_name, n_shards)

    # One-time skew of all per-MB inputs (parallel gathers).
    sk = lambda a: _skew_rows(a, mb_w, M, T, row_offset)
    Yres_sk = sk(Yres)                             # (B, M, T, 16, 16)
    Ures_sk = sk(Ures)
    Vres_sk = sk(Vres)
    is4_sk = sk(is_i4)                             # (B, M, T)
    im_sk = sk(imodes)                             # (B, M, T, 16)
    uv_sk = sk(uvmode)

    Sk_y = jnp.zeros((B, M, T + 3, 16, 16), I32)
    Sk_u = jnp.zeros((B, M, T + 3, 8, 8), I32)
    Sk_v = jnp.zeros((B, M, T + 3, 8, 8), I32)

    myv = jnp.arange(M, dtype=I32) + row_offset
    htv = myv > 0                                   # (M,)

    def step(t, carry):
        Sk_y, Sk_u, Sk_v = carry
        mxv = t - 2 * myv                           # (M,)
        hlv = mxv > 0
        lastv = mxv == (mb_w - 1)

        # Logical columns t-3(TL), t-2(top), t-1(left/TR) = array t..t+2.
        win = lax.dynamic_slice(Sk_y, (0, 0, t, 0, 0), (B, M, 3, 16, 16))
        tl_t = _shift(win[:, :, 0], 0)              # TL tile at row my-1
        top_t = _shift(win[:, :, 1], 0)             # top tile at row my-1
        left_t = win[:, :, 2]                       # left tile at row my
        tr_t = _shift(win[:, :, 2], 0)              # top-right tile (my-1)

        ht3 = htv[None, :, None]
        hl3 = hlv[None, :, None]
        top16 = jnp.where(ht3, top_t[:, :, 15, :], 127)            # (B,M,16)
        tr4 = tr_t[:, :, 15, 0:4]
        tr4 = jnp.where(lastv[None, :, None], top16[:, :, 15:16], tr4)
        tr4 = jnp.where(ht3, tr4, 127)
        left16 = jnp.where(hl3, left_t[:, :, :, 15], 129)
        tlpx = jnp.where(htv[None, :],
                         jnp.where(hlv[None, :], tl_t[:, :, 15, 15], 129),
                         127)

        yres = lax.dynamic_slice(Yres_sk, (0, 0, t, 0, 0),
                                 (B, M, 1, 16, 16))[:, :, 0]
        is4 = lax.dynamic_slice(is4_sk, (0, 0, t), (B, M, 1))[:, :, 0]
        im = lax.dynamic_slice(im_sk, (0, 0, t, 0), (B, M, 1, 16))[:, :, 0]
        uvm = lax.dynamic_slice(uv_sk, (0, 0, t), (B, M, 1))[:, :, 0]

        # --- i16 prediction for the whole MB, written into the scratch ---
        blk16 = _pred16(top16, left16, tlpx, yres, im[..., 0], htv, hlv, 16)
        scr = jnp.zeros((B, M, 17, 21), I32)
        scr = scr.at[:, :, 0, 0].set(tlpx)
        scr = scr.at[:, :, 0, 1:17].set(top16)
        scr = scr.at[:, :, 0, 17:21].set(tr4)
        scr = scr.at[:, :, 1:17, 0].set(left16)
        scr = scr.at[:, :, 1:17, 1:17].set(blk16)

        # --- i4: 16 sub-blocks in raster order (masked writes keep i16
        # MBs' interior intact) ---
        def sub(n, scr):
            gy, gx = n >> 2, n & 3
            r, c = 4 * gy, 4 * gx
            row = lax.dynamic_slice(scr, (0, 0, r, c), (B, M, 1, 9))
            tl = row[..., 0, 0]
            top = row[..., 0, 1:5]
            tr_in = row[..., 0, 5:9]
            tr = jnp.where(jnp.equal(gx, 3), scr[:, :, 0, 17:21], tr_in)
            left = lax.dynamic_slice(scr, (0, 0, r + 1, c),
                                     (B, M, 4, 1))[..., 0]
            mode = lax.dynamic_slice(im, (0, 0, n), (B, M, 1))[..., 0]
            res4 = lax.dynamic_slice_in_dim(
                lax.dynamic_slice_in_dim(yres, r, 4, axis=2), c, 4, axis=3)
            preds = _pred_luma4_all(tl, top, tr, left)     # (B,M,10,4,4)
            pred = _switch(mode.astype(I32),
                           [preds[:, :, k] for k in range(10)], 2)
            blk = _clip8(pred + res4)
            cur = lax.dynamic_slice(scr, (0, 0, r + 1, c + 1), (B, M, 4, 4))
            blk = jnp.where(is4[..., None, None] > 0, blk, cur)
            return lax.dynamic_update_slice(scr, blk, (0, 0, r + 1, c + 1))

        scr = lax.fori_loop(0, 16, sub, scr)

        # --- chroma (U and V stacked on the batch axis: one op set) ---
        uwin = lax.dynamic_slice(Sk_u, (0, 0, t, 0, 0), (B, M, 3, 8, 8))
        vwin = lax.dynamic_slice(Sk_v, (0, 0, t, 0, 0), (B, M, 3, 8, 8))
        ures = lax.dynamic_slice(Ures_sk, (0, 0, t, 0, 0),
                                 (B, M, 1, 8, 8))[:, :, 0]
        vres = lax.dynamic_slice(Vres_sk, (0, 0, t, 0, 0),
                                 (B, M, 1, 8, 8))[:, :, 0]
        cwin = jnp.concatenate([uwin, vwin], axis=0)
        cres = jnp.concatenate([ures, vres], axis=0)
        tl_c = _shift(cwin[:, :, 0], 0)
        top_c = _shift(cwin[:, :, 1], 0)
        left_c = cwin[:, :, 2]
        top8 = jnp.where(ht3, top_c[:, :, 7, :], 127)
        left8 = jnp.where(hl3, left_c[:, :, :, 7], 129)
        tlc = jnp.where(htv[None, :],
                        jnp.where(hlv[None, :], tl_c[:, :, 7, 7], 129),
                        127)
        uvm2 = jnp.concatenate([uvm, uvm], axis=0)
        cblk = _pred16(top8, left8, tlc, cres, uvm2, htv, hlv, 8)
        ublk, vblk = cblk[:B], cblk[B:]

        # --- write column t+3 (each column is written exactly once, and
        # invalid-slot tiles are never read, so no masking needed) ---
        Sk_y = lax.dynamic_update_slice(
            Sk_y, scr[:, :, None, 1:17, 1:17], (0, 0, t + 3, 0, 0))
        Sk_u = lax.dynamic_update_slice(
            Sk_u, ublk[:, :, None], (0, 0, t + 3, 0, 0))
        Sk_v = lax.dynamic_update_slice(
            Sk_v, vblk[:, :, None], (0, 0, t + 3, 0, 0))
        return Sk_y, Sk_u, Sk_v

    return (Sk_y, Sk_u, Sk_v), step, T


def recon_wavefront(Yres, Ures, Vres, is_i4, imodes, uvmode, *, mb_w, mb_h,
                    axis_name=None, mb_h_global=None, n_shards=1):
    """Intra-predict + add residuals over the MB anti-diagonal wavefront.

    Inputs are per-MB tensors (B, N, ...); returns skewed tile arrays
    (Sk_y (B,mb_h,T+3,16,16), Sk_u, Sk_v (…,8,8)) int32.

    With ``axis_name`` (inside shard_map over MB-row shards) the
    row-shift context reads become ppermute halo exchanges; columns are
    global diagonals so every shard runs the same program.
    """
    init, step, T = _recon_wavefront_steps(
        Yres, Ures, Vres, is_i4, imodes, uvmode, mb_w=mb_w, mb_h=mb_h,
        axis_name=axis_name, mb_h_global=mb_h_global, n_shards=n_shards)
    return lax.fori_loop(0, T, step, init)


# ---------------------------------------------------------------------------
# Loop filter (RFC 6386 §15) — skewed wavefront with static window stencils
# ---------------------------------------------------------------------------

def _lanes_complex(S, thresh2, it, hev_t, edge):
    """Complex filter on (..., L, 8) strips across an edge.

    thresh2/it/hev_t broadcast over the lane axis; ``edge`` is static
    (True = macroblock edge: hev ? filter2 : filter6; False = inner:
    hev ? filter2 : filter4).
    """
    p3, p2, p1, p0 = S[..., 0], S[..., 1], S[..., 2], S[..., 3]
    q0, q1, q2, q3 = S[..., 4], S[..., 5], S[..., 6], S[..., 7]

    t2 = thresh2[..., None]
    itl = it[..., None]
    hv_t = hev_t[..., None]

    nf = (4 * jnp.abs(p0 - q0) + jnp.abs(p1 - q1)) <= t2
    nf &= (jnp.abs(p3 - p2) <= itl) & (jnp.abs(p2 - p1) <= itl)
    nf &= (jnp.abs(p1 - p0) <= itl) & (jnp.abs(q3 - q2) <= itl)
    nf &= (jnp.abs(q2 - q1) <= itl) & (jnp.abs(q1 - q0) <= itl)
    hv = (jnp.abs(p1 - p0) > hv_t) | (jnp.abs(q1 - q0) > hv_t)

    sclip1 = lambda v: jnp.clip(v, -128, 127)
    sclip2 = lambda v: jnp.clip(v, -16, 15)

    # filter2 (hev path): modifies p0, q0.
    a = 3 * (q0 - p0) + sclip1(p1 - q1)
    a1 = sclip2((a + 4) >> 3)
    a2 = sclip2((a + 3) >> 3)
    f2_p0 = _clip8(p0 + a2)
    f2_q0 = _clip8(q0 - a1)

    if edge:
        # filter6: modifies p2..q2.
        w = sclip1(3 * (q0 - p0) + sclip1(p1 - q1))
        b1 = (27 * w + 63) >> 7
        b2 = (18 * w + 63) >> 7
        b3 = (9 * w + 63) >> 7
        n_p2 = _clip8(p2 + b3)
        n_p1 = _clip8(p1 + b2)
        n_p0 = _clip8(p0 + b1)
        n_q0 = _clip8(q0 - b1)
        n_q1 = _clip8(q1 - b2)
        n_q2 = _clip8(q2 - b3)
    else:
        # filter4: modifies p1..q1.
        w = 3 * (q0 - p0)
        b1 = sclip2((w + 4) >> 3)
        b2 = sclip2((w + 3) >> 3)
        b3 = (b1 + 1) >> 1
        n_p2 = p2
        n_p1 = _clip8(p1 + b3)
        n_p0 = _clip8(p0 + b2)
        n_q0 = _clip8(q0 - b1)
        n_q1 = _clip8(q1 - b3)
        n_q2 = q2

    o_p2 = jnp.where(nf, jnp.where(hv, p2, n_p2), p2)
    o_p1 = jnp.where(nf, jnp.where(hv, p1, n_p1), p1)
    o_p0 = jnp.where(nf, jnp.where(hv, f2_p0, n_p0), p0)
    o_q0 = jnp.where(nf, jnp.where(hv, f2_q0, n_q0), q0)
    o_q1 = jnp.where(nf, jnp.where(hv, q1, n_q1), q1)
    o_q2 = jnp.where(nf, jnp.where(hv, q2, n_q2), q2)
    return jnp.stack([p3, o_p2, o_p1, o_p0, o_q0, o_q1, o_q2, q3], axis=-1)


def _lanes_simple(S, thresh2):
    """Simple filter on (..., L, 4) strips [p1,p0,q0,q1] (luma only)."""
    p1, p0, q0, q1 = S[..., 0], S[..., 1], S[..., 2], S[..., 3]
    t2 = thresh2[..., None]
    nf = (4 * jnp.abs(p0 - q0) + jnp.abs(p1 - q1)) <= t2
    sclip1 = lambda v: jnp.clip(v, -128, 127)
    sclip2 = lambda v: jnp.clip(v, -16, 15)
    a = 3 * (q0 - p0) + sclip1(p1 - q1)
    a1 = sclip2((a + 4) >> 3)
    a2 = sclip2((a + 3) >> 3)
    o_p0 = jnp.where(nf, _clip8(p0 + a2), p0)
    o_q0 = jnp.where(nf, _clip8(q0 - a1), q0)
    return jnp.stack([p1, o_p0, o_q0, q1], axis=-1)


def _edge_h(w, col, r0, r1, params, mask, edge, simple):
    """Filter the vertical edge at window column `col` (static indices).

    w: (B,M,R,C) window; lanes are rows r0:r1.  Returns updated window.
    """
    thresh2, it, hev_t = params
    K = 2 if simple else 4
    S = w[:, :, r0:r1, col - K:col + K]
    out = (_lanes_simple(S, thresh2) if simple
           else _lanes_complex(S, thresh2, it, hev_t, edge))
    out = jnp.where(mask[..., None, None], out, S)
    return w.at[:, :, r0:r1, col - K:col + K].set(out)


def _edge_v(w, row, c0, c1, params, mask, edge, simple):
    """Filter the horizontal edge at window row `row` (static indices)."""
    thresh2, it, hev_t = params
    K = 2 if simple else 4
    S = w[:, :, row - K:row + K, c0:c1].swapaxes(-1, -2)
    out = (_lanes_simple(S, thresh2) if simple
           else _lanes_complex(S, thresh2, it, hev_t, edge))
    out = jnp.where(mask[..., None, None], out, S)
    return w.at[:, :, row - K:row + K, c0:c1].set(out.swapaxes(-1, -2))


def _filter_wavefront_steps(B, fparams, *, mb_w, mb_h, filter_type,
                            axis_name=None, mb_h_global=None, n_shards=1):
    """Factory form of :func:`loop_filter_wavefront`: returns
    (step, T) with step(t, (Sk_y, Sk_u, Sk_v)) filtering diagonal t."""
    M = mb_h
    mhg = mb_h_global if mb_h_global is not None else mb_h
    T = num_diagonals(mb_w, mhg)
    simple = filter_type == 1
    if axis_name is not None:
        row_offset = lax.axis_index(axis_name).astype(I32) * mb_h
    else:
        row_offset = jnp.int32(0)
    _shift, _shift_up = _halo_shifts(axis_name, n_shards)
    fp_sk = _skew_rows(fparams.reshape(B, mb_h * mb_w, 4), mb_w, M, T,
                       row_offset)                           # (B,M,T,4)

    myv = jnp.arange(M, dtype=I32) + row_offset
    htv = myv > 0

    def step(t, carry):
        Sk_y, Sk_u, Sk_v = carry
        mxv = t - 2 * myv
        activev = (mxv >= 0) & (mxv < mb_w)
        hlv = mxv > 0

        par = lax.dynamic_slice(fp_sk, (0, 0, t, 0), (B, M, 1, 4))[:, :, 0]
        limit = par[..., 0]
        il = par[..., 1]
        hev_t = par[..., 2]
        inner = par[..., 3] > 0
        on = activev[None, :] & (limit >= 0)                 # (B,M)
        m_left = on & hlv[None, :]
        m_top = on & htv[None, :]
        m_inner = on & inner
        pe = lambda lim: (2 * lim + 1, il, hev_t)
        pl4 = lambda lim: (2 * (lim + 4) + 1, il, hev_t)

        # ---- luma: window (B,M,20,20); tile at [4:20, 4:20] ----
        win = lax.dynamic_slice(Sk_y, (0, 0, t + 1, 0, 0), (B, M, 3, 16, 16))
        top_t = _shift(win[:, :, 0], 0)                      # col t+1, row my-1
        left_t = win[:, :, 1]                                # col t+2, row my
        self_t = win[:, :, 2]                                # col t+3, row my
        w = jnp.zeros((B, M, 20, 20), I32)
        w = w.at[:, :, 4:20, 4:20].set(self_t)
        w = w.at[:, :, 0:4, 4:20].set(top_t[:, :, 12:16, :])
        w = w.at[:, :, 4:20, 0:4].set(left_t[:, :, :, 12:16])

        if simple:
            # Raster-exact edge order: left H, inner H x3, top V,
            # inner V x3 (simple filter is luma-only).
            w = _edge_h(w, 4, 4, 20, pl4(limit), m_left, True, True)
            for dx in (8, 12, 16):
                w = _edge_h(w, dx, 4, 20, pe(limit), m_inner, False, True)
            w = _edge_v(w, 4, 4, 20, pl4(limit), m_top, True, True)
            for dy in (8, 12, 16):
                w = _edge_v(w, dy, 4, 20, pe(limit), m_inner, False, True)
            Sk_y = lax.dynamic_update_slice(
                Sk_y, w[:, :, None, 4:20, 4:20], (0, 0, t + 3, 0, 0))
            Sk_y = lax.dynamic_update_slice(
                Sk_y, w[:, :, None, 4:20, 0:4], (0, 0, t + 2, 0, 12))
            bot = _shift_up(w[:, :, 0:4, 4:20], win[:, -1:, 0, 12:16, :])
            Sk_y = lax.dynamic_update_slice(
                Sk_y, bot[:, :, None], (0, 0, t + 1, 12, 0))
            return Sk_y, Sk_u, Sk_v

        # ---- complex: luma + chroma, the independent planes' edge
        # filters SHARE _lanes_complex calls on the lane axis (the MB
        # edges ride together, the chroma inners hitch onto the first
        # luma inner) — 8 filter calls per step instead of 12, each
        # with 32 lanes instead of 16, on this dispatch-bound loop. ----
        cwu = lax.dynamic_slice(Sk_u, (0, 0, t + 1, 0, 0), (B, M, 3, 8, 8))
        cwv = lax.dynamic_slice(Sk_v, (0, 0, t + 1, 0, 0), (B, M, 3, 8, 8))

        def cwin(cw):
            v = jnp.zeros((B, M, 12, 12), I32)
            v = v.at[:, :, 4:12, 4:12].set(cw[:, :, 2])
            v = v.at[:, :, 0:4, 4:12].set(_shift(cw[:, :, 0], 0)[:, :, 4:8])
            v = v.at[:, :, 4:12, 0:4].set(cw[:, :, 1][:, :, :, 4:8])
            return v

        vu = cwin(cwu)
        vv = cwin(cwv)

        def merged_h(w, vu, vv, params, mask, edge):
            thresh2, it_, hv_ = params
            Sy = w[:, :, 4:20, 0:8]
            Su = vu[:, :, 4:12, 0:8]
            Sv = vv[:, :, 4:12, 0:8]
            S = jnp.concatenate([Sy, Su, Sv], axis=2)      # (B,M,32,8)
            out = _lanes_complex(S, thresh2, it_, hv_, edge)
            out = jnp.where(mask[..., None, None], out, S)
            w = w.at[:, :, 4:20, 0:8].set(out[:, :, :16])
            vu = vu.at[:, :, 4:12, 0:8].set(out[:, :, 16:24])
            vv = vv.at[:, :, 4:12, 0:8].set(out[:, :, 24:32])
            return w, vu, vv

        def merged_v(w, vu, vv, params, mask, edge):
            thresh2, it_, hv_ = params
            Sy = w[:, :, 0:8, 4:20].swapaxes(-1, -2)
            Su = vu[:, :, 0:8, 4:12].swapaxes(-1, -2)
            Sv = vv[:, :, 0:8, 4:12].swapaxes(-1, -2)
            S = jnp.concatenate([Sy, Su, Sv], axis=2)
            out = _lanes_complex(S, thresh2, it_, hv_, edge)
            out = jnp.where(mask[..., None, None], out, S)
            w = w.at[:, :, 0:8, 4:20].set(out[:, :, :16].swapaxes(-1, -2))
            vu = vu.at[:, :, 0:8, 4:12].set(
                out[:, :, 16:24].swapaxes(-1, -2))
            vv = vv.at[:, :, 0:8, 4:12].set(
                out[:, :, 24:32].swapaxes(-1, -2))
            return w, vu, vv

        def merged_inner_h(w, vu, vv, params, mask):
            # luma inner dx=8 + both chroma inners (col 8) together
            thresh2, it_, hv_ = params
            Sy = w[:, :, 4:20, 4:12]
            Su = vu[:, :, 4:12, 4:12]
            Sv = vv[:, :, 4:12, 4:12]
            S = jnp.concatenate([Sy, Su, Sv], axis=2)
            out = _lanes_complex(S, thresh2, it_, hv_, False)
            out = jnp.where(mask[..., None, None], out, S)
            w = w.at[:, :, 4:20, 4:12].set(out[:, :, :16])
            vu = vu.at[:, :, 4:12, 4:12].set(out[:, :, 16:24])
            vv = vv.at[:, :, 4:12, 4:12].set(out[:, :, 24:32])
            return w, vu, vv

        def merged_inner_v(w, vu, vv, params, mask):
            thresh2, it_, hv_ = params
            Sy = w[:, :, 4:12, 4:20].swapaxes(-1, -2)
            Su = vu[:, :, 4:12, 4:12].swapaxes(-1, -2)
            Sv = vv[:, :, 4:12, 4:12].swapaxes(-1, -2)
            S = jnp.concatenate([Sy, Su, Sv], axis=2)
            out = _lanes_complex(S, thresh2, it_, hv_, False)
            out = jnp.where(mask[..., None, None], out, S)
            w = w.at[:, :, 4:12, 4:20].set(out[:, :, :16].swapaxes(-1, -2))
            vu = vu.at[:, :, 4:12, 4:12].set(
                out[:, :, 16:24].swapaxes(-1, -2))
            vv = vv.at[:, :, 4:12, 4:12].set(
                out[:, :, 24:32].swapaxes(-1, -2))
            return w, vu, vv

        # Raster-exact per plane: left, inners, top, inners.  Luma and
        # chroma are independent planes, so their interleaving is free.
        w, vu, vv = merged_h(w, vu, vv, pl4(limit), m_left, True)
        w, vu, vv = merged_inner_h(w, vu, vv, pe(limit), m_inner)
        for dx in (12, 16):
            w = _edge_h(w, dx, 4, 20, pe(limit), m_inner, False, False)
        w, vu, vv = merged_v(w, vu, vv, pl4(limit), m_top, True)
        w, vu, vv = merged_inner_v(w, vu, vv, pe(limit), m_inner)
        for dy in (12, 16):
            w = _edge_v(w, dy, 4, 20, pe(limit), m_inner, False, False)

        # Write back: own tile, left tile's right 4 cols, top tile's
        # bottom 4 rows (shifted back up; last row keeps current values).
        Sk_y = lax.dynamic_update_slice(
            Sk_y, w[:, :, None, 4:20, 4:20], (0, 0, t + 3, 0, 0))
        Sk_y = lax.dynamic_update_slice(
            Sk_y, w[:, :, None, 4:20, 0:4], (0, 0, t + 2, 0, 12))
        bot = _shift_up(w[:, :, 0:4, 4:20], win[:, -1:, 0, 12:16, :])
        Sk_y = lax.dynamic_update_slice(
            Sk_y, bot[:, :, None], (0, 0, t + 1, 12, 0))

        def cwrite(Sk, v, cw):
            Sk = lax.dynamic_update_slice(
                Sk, v[:, :, None, 4:12, 4:12], (0, 0, t + 3, 0, 0))
            Sk = lax.dynamic_update_slice(
                Sk, v[:, :, None, 4:12, 0:4], (0, 0, t + 2, 0, 4))
            cbot = _shift_up(v[:, :, 0:4, 4:12], cw[:, -1:, 0, 4:8, :])
            return lax.dynamic_update_slice(
                Sk, cbot[:, :, None], (0, 0, t + 1, 4, 0))

        Sk_u = cwrite(Sk_u, vu, cwu)
        Sk_v = cwrite(Sk_v, vv, cwv)
        return Sk_y, Sk_u, Sk_v

    return step, T


def loop_filter_wavefront(Sk_y, Sk_u, Sk_v, fparams, *,
                          mb_w, mb_h, filter_type,
                          axis_name=None, mb_h_global=None, n_shards=1):
    """In-loop deblocking over the same slope-2 wavefront, in place.

    fparams: int32 (B, mb_h, mb_w, 4) = [limit, ilevel, hev_t, inner];
    limit < 0 disables the MB.  filter_type: 1 = simple (luma only),
    2 = complex (luma + chroma).

    Under MB-row sharding the filtered bottom rows of each shard's top
    tile flow back to the shard above with a reverse ppermute (the
    filter's only up-going write), and the context reads use the same
    down-halo as reconstruction.
    """
    if filter_type == 0:
        return Sk_y, Sk_u, Sk_v
    step, T = _filter_wavefront_steps(
        Sk_y.shape[0], fparams, mb_w=mb_w, mb_h=mb_h,
        filter_type=filter_type, axis_name=axis_name,
        mb_h_global=mb_h_global, n_shards=n_shards)
    return lax.fori_loop(0, T, step, (Sk_y, Sk_u, Sk_v))


# ---------------------------------------------------------------------------
# Full frame entry
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("mb_w", "mb_h", "filter_type"))
def recon_frame(coeffs, is_i4, imodes, uvmode, fparams, *,
                mb_w, mb_h, filter_type):
    """Dequantized symbols → reconstructed + filtered YUV planes.

    coeffs (B, N, 24, 16) int16/int32; is_i4/uvmode (B, N) int;
    imodes (B, N, 16) int; fparams (B, mb_h, mb_w, 4) int32.
    Returns uint8 planes (B, 16*mb_h, 16*mb_w), (B, 8*mb_h, 8*mb_w) x2.
    """
    # Two loops, not one: fusing the loop filter into the recon
    # wavefront at a 2-diagonal lag is bit-exact (a tile's own filter
    # writes stop at row/col 13 and every boundary pixel the filter
    # touches is read by its recon consumers strictly earlier), but the
    # fused body reads state columns t..t+2 while writing t-1..t+1, so
    # XLA cannot prove the in-place update safe and copies the whole
    # skewed state every step.  The two-phase form keeps each loop's
    # dynamic-update-slices trivially in place.
    Yres, Ures, Vres = residual_blocks(coeffs.astype(I32))
    Sk_y, Sk_u, Sk_v = recon_wavefront(
        Yres, Ures, Vres, is_i4.astype(I32), imodes.astype(I32),
        uvmode.astype(I32), mb_w=mb_w, mb_h=mb_h)
    Sk_y, Sk_u, Sk_v = loop_filter_wavefront(
        Sk_y, Sk_u, Sk_v, fparams, mb_w=mb_w, mb_h=mb_h,
        filter_type=filter_type)
    Y = _unskew_plane(Sk_y, mb_w, mb_h, 16).astype(jnp.uint8)
    U = _unskew_plane(Sk_u, mb_w, mb_h, 8).astype(jnp.uint8)
    V = _unskew_plane(Sk_v, mb_w, mb_h, 8).astype(jnp.uint8)
    return Y, U, V
