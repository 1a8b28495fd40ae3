"""VP8L (WebP lossless) encoder.

Array-first split (SURVEY.md §7): entropy analysis, transforms, and the
per-tile predictor search are dense array ops (NumPy reference here, JAX
versions in gowebp_tpu/ops/lossless_jax.py); backward-reference detection
is vectorized run-finding; only the final bit emission is a sequential
host loop (with a native C++ twin planned in entropy/native/).

Feature parity target: /root/reference/pkg/vp8/vp8l_encoder.go (stream
layout :1459-1591, huffman storage :467-569, emission :583-640) and
enc/predictor_enc.go (per-tile predictor search :227-716) — written fresh
from the lossless bitstream spec.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...constants import (
    CODE_LENGTH_CODE_ORDER,
    NUM_CODE_LENGTH_CODES,
    NUM_DISTANCE_CODES,
    NUM_LENGTH_CODES,
    NUM_LITERAL_CODES,
    VP8L_SIGNATURE,
)
from ...entropy.bitio import BitWriter
from ...entropy.huffman import build_code_lengths, canonical_codes
from ...errors import EncodeError
from . import transforms_np as tnp

# ---------------------------------------------------------------------------
# Prefix (length/distance) encoding
# ---------------------------------------------------------------------------



_INV_LN2 = 1.0 / np.log(2.0)


def _log2f(x):
    """np.log2 replacement: this numpy build's log2 ufunc lacks the SIMD
    path and is ~90x slower than log; glibc's log() additionally takes a
    ~35x slow branch on inputs equal to exactly 1.0, so callers bias
    count/probability arrays by a tiny epsilon.  Cost estimates don't
    need exactly-rounded-at-powers-of-two semantics."""
    return np.log(x) * _INV_LN2


def prefix_encode(value: int) -> tuple[int, int, int]:
    """1-based value → (code, extra_bits_count, extra_bits_value)."""
    u = value - 1
    if u < 4:
        return u, 0, 0
    e = u.bit_length() - 2
    if u < (3 << e):
        return 2 * e + 2, e, u - (2 << e)
    return 2 * e + 3, e, u - (3 << e)


def _reverse_bits(v: int, n: int) -> int:
    r = 0
    for _ in range(n):
        r = (r << 1) | (v & 1)
        v >>= 1
    return r


# ---------------------------------------------------------------------------
# Huffman code storage
# ---------------------------------------------------------------------------


class HuffmanWriteCode:
    """Canonical code ready for emission: lengths + LSB-first reversed bits."""

    __slots__ = ("lengths", "bits")

    def __init__(self, lengths: np.ndarray):
        self.lengths = lengths.astype(np.int32)
        codes = canonical_codes(lengths)
        self.bits = np.array(
            [_reverse_bits(int(c), int(l)) for c, l in zip(codes, lengths)],
            dtype=np.uint32,
        )

    def write_symbol(self, bw: BitWriter, sym: int) -> None:
        bw.put_bits(int(self.bits[sym]), int(self.lengths[sym]))


def _tokenize_code_lengths(lengths: np.ndarray):
    """RLE-tokenize per the 16/17/18 repeat scheme → [(sym, extra_bits, extra)]."""
    tokens = []
    n = len(lengths)
    i = 0
    while i < n:
        v = int(lengths[i])
        run = 1
        while i + run < n and int(lengths[i + run]) == v:
            run += 1
        if v == 0:
            r = run
            while r >= 11:
                k = min(r, 138)
                tokens.append((18, 7, k - 11))
                r -= k
            while r >= 3:
                k = min(r, 10)
                tokens.append((17, 3, k - 3))
                r -= k
            tokens.extend([(0, 0, 0)] * r)
        else:
            # First occurrence written literally; 16 repeats the previous
            # nonzero length, so it also works right after it.
            tokens.append((v, 0, 0))
            r = run - 1
            while r >= 3:
                k = min(r, 6)
                tokens.append((16, 2, k - 3))
                r -= k
            tokens.extend([(v, 0, 0)] * r)
        i += run
    return tokens


def store_huffman_code(bw: BitWriter, lengths: np.ndarray) -> HuffmanWriteCode:
    """Write one prefix-code description; returns the emission code."""
    used = np.flatnonzero(lengths > 0)
    if len(used) == 0:
        # Unused tree: store as trivial simple code (symbol 0).
        bw.put_bits(1, 1)   # simple
        bw.put_bits(0, 1)   # num_symbols - 1 = 0
        bw.put_bits(0, 1)   # is_8bit = 0 (1-bit symbol)
        bw.put_bits(0, 1)   # symbol 0
        out = np.zeros_like(lengths)
        out[0] = 1
        code = HuffmanWriteCode(out)
        code.lengths[0] = 0  # zero-bit single-symbol code (never emitted)
        return code

    if len(used) <= 2 and used[-1] < 256:
        # Simple code.
        bw.put_bits(1, 1)
        bw.put_bits(len(used) - 1, 1)
        first = int(used[0])
        if first <= 1:
            bw.put_bits(0, 1)       # 1-bit first symbol
            bw.put_bits(first, 1)
        else:
            bw.put_bits(1, 1)
            bw.put_bits(first, 8)
        if len(used) == 2:
            bw.put_bits(int(used[1]), 8)
        # Decoder assigns length-1 codes (or 0 bits when single).
        out = np.zeros_like(lengths)
        if len(used) == 1:
            out[used[0]] = 1
            code = HuffmanWriteCode(out)
            code.lengths[used[0]] = 0   # single symbol: zero bits on emit
            return code
        out[used] = 1
        return HuffmanWriteCode(out)

    bw.put_bits(0, 1)  # not simple
    tokens = _tokenize_code_lengths(lengths)
    # Histogram of code-length symbols → code-length code.
    cl_hist = np.zeros(NUM_CODE_LENGTH_CODES, np.int64)
    for sym, _, _ in tokens:
        cl_hist[sym] += 1
    cl_lengths = build_code_lengths(cl_hist, max_depth=7)
    if cl_lengths.max(initial=0) == 0:
        cl_lengths[0] = 1
    cl_code = HuffmanWriteCode(cl_lengths)
    # Single-symbol cl code still needs nonzero length in the header.
    # (The decoder's table build treats it as zero-bit; emission below
    # writes zero bits for it, which is consistent.)
    used_cl = np.flatnonzero(cl_lengths > 0)
    if len(used_cl) == 1:
        cl_code.lengths[used_cl[0]] = 0

    # Trim trailing zeros in the CODE_LENGTH_CODE_ORDER listing (min 4).
    order_lengths = [int(cl_lengths[CODE_LENGTH_CODE_ORDER[i]])
                     for i in range(NUM_CODE_LENGTH_CODES)]
    num_codes = NUM_CODE_LENGTH_CODES
    while num_codes > 4 and order_lengths[num_codes - 1] == 0:
        num_codes -= 1
    bw.put_bits(num_codes - 4, 4)
    for i in range(num_codes):
        bw.put_bits(order_lengths[i], 3)
    bw.put_bits(0, 1)  # no max_symbol trick
    for sym, ebits, extra in tokens:
        cl_code.write_symbol(bw, sym)
        if ebits:
            bw.put_bits(extra, ebits)
    return HuffmanWriteCode(lengths)


# ---------------------------------------------------------------------------
# Backward references (vectorized run detection: dist 1 and dist width)
# ---------------------------------------------------------------------------

MIN_COPY_LEN = 4
MAX_COPY_LEN = 4095


@dataclass
class RefStream:
    """Tensorized symbol stream: parallel arrays of ops.

    op 0 = literal (argb), op 1 = copy (length, dist).
    """

    ops: np.ndarray        # (n,) uint8
    argb: np.ndarray       # (n,) uint32 (literals; undefined for copies)
    lengths: np.ndarray    # (n,) int32
    dists: np.ndarray      # (n,) int32


def build_backward_refs(argb: np.ndarray, width: int) -> RefStream:
    """Greedy run-based LZ77 over the flattened image.

    Finds maximal runs matching at distance 1 (left) and `width` (above) —
    the two dominant distances in natural/graphic images.  Native C++
    walk when available, NumPy otherwise.
    """
    native = _build_backward_refs_native(argb, width)
    if native is not None:
        return native
    flat = argb.reshape(-1)
    n = len(flat)
    eq1 = np.zeros(n, bool)
    eqw = np.zeros(n, bool)
    eq1[1:] = flat[1:] == flat[:-1]
    if n > width:
        eqw[width:] = flat[width:] == flat[:-width]

    ops, argbs, lens, dists = [], [], [], []
    pos = 0
    # Run-length helper arrays: length of the eq-run starting at each pos.
    run1 = _forward_run_lengths(eq1)
    runw = _forward_run_lengths(eqw)
    while pos < n:
        l1 = run1[pos] if pos > 0 else 0
        lw = runw[pos] if pos >= width else 0
        best_len = max(l1, lw)
        if best_len >= MIN_COPY_LEN:
            dist = 1 if l1 >= lw else width
            length = min(best_len, MAX_COPY_LEN)
            ops.append(1)
            argbs.append(0)
            lens.append(length)
            dists.append(dist)
            pos += length
        else:
            ops.append(0)
            argbs.append(int(flat[pos]))
            lens.append(1)
            dists.append(0)
            pos += 1
    return RefStream(
        np.array(ops, np.uint8),
        np.array(argbs, np.uint32),
        np.array(lens, np.int32),
        np.array(dists, np.int32),
    )


def _greedy_refs_from_best(flat: np.ndarray, best_len: np.ndarray,
                           best_dist: np.ndarray) -> RefStream:
    """Greedy left-to-right parse given per-position best matches.

    Literal stretches between viable copies are emitted in bulk, so the
    Python loop runs once per op-run, not per pixel.
    """
    n = len(flat)
    cand = np.flatnonzero(best_len >= MIN_COPY_LEN)
    ops_l, argb_l, len_l, dist_l = [], [], [], []
    i = 0
    while i < n:
        ci = np.searchsorted(cand, i)
        j = int(cand[ci]) if ci < len(cand) else n
        if j > i:
            seg = flat[i:j]
            ops_l.append(np.zeros(j - i, np.uint8))
            argb_l.append(seg.astype(np.uint32))
            len_l.append(np.ones(j - i, np.int32))
            dist_l.append(np.zeros(j - i, np.int32))
            i = j
            continue
        length = min(int(best_len[i]), MAX_COPY_LEN)
        ops_l.append(np.ones(1, np.uint8))
        argb_l.append(np.zeros(1, np.uint32))
        len_l.append(np.array([length], np.int32))
        dist_l.append(np.array([int(best_dist[i])], np.int32))
        i += length
    return RefStream(
        np.concatenate(ops_l) if ops_l else np.zeros(0, np.uint8),
        np.concatenate(argb_l) if argb_l else np.zeros(0, np.uint32),
        np.concatenate(len_l) if len_l else np.zeros(0, np.int32),
        np.concatenate(dist_l) if dist_l else np.zeros(0, np.int32),
    )


def build_refs_box(argb: np.ndarray, width: int) -> RefStream:
    """2D-locality ("box") LZ77: matches only at the 120 plane-coded
    neighbour distances (reference BackwardReferencesLz77Box,
    backward_references_enc.c.go:427-677 — the variant that wins on
    hard-edged/palettized graphics, where short 2D-local distances get
    the cheap single-symbol distance codes)."""
    flat = np.ascontiguousarray(argb.reshape(-1), np.uint32)
    n = flat.size
    best_len = np.zeros(n, np.int32)
    best_dist = np.zeros(n, np.int32)
    from .decoder import DIST_MAP

    dists = sorted({max(1, dy * width + dx) for dx, dy in DIST_MAP
                    if 1 <= dy * width + dx < n})
    eq = np.empty(n, bool)
    for d in dists:
        eq[:d] = False
        np.equal(flat[d:], flat[:-d], out=eq[d:])
        rl = _forward_run_lengths_fast(eq).astype(np.int32)
        better = rl > best_len
        np.copyto(best_len, rl, where=better)
        np.copyto(best_dist, np.int32(d), where=better)
    return _greedy_refs_from_best(flat, best_len, best_dist)


def _build_backward_refs_native(argb: np.ndarray, width: int) -> RefStream | None:
    import ctypes

    from ...entropy.native_loader import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "wtpu_vp8l_greedy_refs"):
        return None
    flat = np.ascontiguousarray(argb.reshape(-1), np.uint32)
    n = len(flat)
    ops = np.zeros(n, np.uint8)
    argbs = np.zeros(n, np.uint32)
    lens = np.zeros(n, np.int32)
    dists = np.zeros(n, np.int32)
    n_ops = lib.wtpu_vp8l_greedy_refs(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        n, width, MIN_COPY_LEN, MAX_COPY_LEN,
        ops.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        argbs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dists.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return RefStream(ops[:n_ops], argbs[:n_ops], lens[:n_ops], dists[:n_ops])


def _forward_run_lengths(eq: np.ndarray) -> np.ndarray:
    """run[i] = number of consecutive True starting at i."""
    n = len(eq)
    run = np.zeros(n + 1, np.int64)
    for i in range(n - 1, -1, -1):
        run[i] = run[i + 1] + 1 if eq[i] else 0
    return run[:n]


def _forward_run_lengths_fast(eq: np.ndarray) -> np.ndarray:
    """Vectorized version of _forward_run_lengths."""
    n = len(eq)
    if n == 0:
        return np.zeros(0, np.int64)
    idx = np.arange(n)
    # For each i, distance to the next False at or after i.
    false_pos = np.flatnonzero(~eq)
    next_false = np.full(n, n, np.int64)
    if len(false_pos):
        ins = np.searchsorted(false_pos, idx, side="left")
        valid = ins < len(false_pos)
        next_false[valid] = false_pos[ins[valid]]
    return next_false - idx


# Use the vectorized version.
_forward_run_lengths = _forward_run_lengths_fast


# ---------------------------------------------------------------------------
# Distance → plane-code mapping (inverse of decoder's DIST_MAP)
# ---------------------------------------------------------------------------


def _build_dist_code_lut(width: int) -> dict[int, int]:
    from .decoder import DIST_MAP

    lut = {}
    for code in range(120, 0, -1):
        dx, dy = DIST_MAP[code - 1]
        d = dy * width + dx
        if d >= 1:
            lut[d] = code  # smaller codes win (iterate descending)
    return lut


def dist_to_plane_code(width: int, dist: int, lut: dict[int, int]) -> int:
    return lut.get(dist, dist + 120)


# ---------------------------------------------------------------------------
# Histograms + emission
# ---------------------------------------------------------------------------


def prefix_encode_vec(values: np.ndarray):
    """Vectorized prefix_encode → (codes, extra_bit_counts, extra_values)."""
    u = values.astype(np.int64) - 1
    small = u < 4
    # bit_length via frexp (exact for the 1..2^20 range used here).
    _, e = np.frexp(np.maximum(u, 1).astype(np.float64))
    bl = e.astype(np.int64)
    eb = np.maximum(bl - 2, 0)
    hi = u >= (3 << eb)
    code = np.where(small, u, 2 * eb + 2 + hi)
    nbits = np.where(small, 0, eb)
    base = np.where(hi, (3 << eb), (2 << eb))
    extra = np.where(small, 0, u - base)
    return code.astype(np.int64), nbits.astype(np.int64), extra.astype(np.int64)


def _build_dist_lut_array(width: int) -> np.ndarray:
    """dist → plane code (0 where the far-code d+120 applies)."""
    from .decoder import DIST_MAP

    size = 7 * width + 9
    lut = np.zeros(size, np.int32)
    for code in range(120, 0, -1):
        dx, dy = DIST_MAP[code - 1]
        d = dy * width + dx
        if 1 <= d < size:
            lut[d] = code
    return lut


def _build_histograms(refs: RefStream, width: int, lut,
                      cache_bits: int = 0) -> list[np.ndarray]:
    cache_size = (1 << cache_bits) if cache_bits else 0
    green = np.zeros(NUM_LITERAL_CODES + NUM_LENGTH_CODES + cache_size, np.int64)
    red = np.zeros(256, np.int64)
    blue = np.zeros(256, np.int64)
    alpha = np.zeros(256, np.int64)
    dist = np.zeros(NUM_DISTANCE_CODES, np.int64)

    lit_mask = refs.ops == 0
    lits = refs.argb[lit_mask]
    if len(lits):
        green[:256] += np.bincount((lits >> 8) & 0xFF, minlength=256).astype(np.int64)[:256]
        red += np.bincount((lits >> 16) & 0xFF, minlength=256).astype(np.int64)[:256]
        blue += np.bincount(lits & 0xFF, minlength=256).astype(np.int64)[:256]
        alpha += np.bincount((lits >> 24) & 0xFF, minlength=256).astype(np.int64)[:256]
    cache_mask = refs.ops == 2
    if cache_mask.any():
        idxs = refs.lengths[cache_mask]
        green[280:] += np.bincount(idxs, minlength=cache_size).astype(np.int64)[:cache_size]
    copies = refs.ops == 1
    if copies.any():
        lcodes, _, _ = prefix_encode_vec(refs.lengths[copies])
        green[NUM_LITERAL_CODES : NUM_LITERAL_CODES + NUM_LENGTH_CODES] += (
            np.bincount(lcodes, minlength=NUM_LENGTH_CODES)[:NUM_LENGTH_CODES]
        )
        ds = refs.dists[copies].astype(np.int64)
        lut_arr = _build_dist_lut_array(width)
        planes = np.where(
            (ds < len(lut_arr)) & (lut_arr[np.minimum(ds, len(lut_arr) - 1)] > 0),
            lut_arr[np.minimum(ds, len(lut_arr) - 1)],
            ds + 120,
        )
        dcodes, _, _ = prefix_encode_vec(planes)
        dist += np.bincount(dcodes, minlength=NUM_DISTANCE_CODES)[:NUM_DISTANCE_CODES]
    return [green, red, blue, alpha, dist]


def _emit_refs_native(bw: BitWriter, refs: RefStream, codes, width: int) -> bool:
    """C++ emission of the op stream; False if the lib is unavailable."""
    import ctypes

    from ...entropy.native_loader import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "wtpu_vp8l_emit"):
        return False
    bits_cat = []
    lens_cat = []
    offsets = np.zeros(5, np.int32)
    off = 0
    for i, code in enumerate(codes):
        offsets[i] = off
        bits_cat.append(code.bits.astype(np.uint16))
        lens_cat.append(code.lengths.astype(np.uint8))
        off += len(code.bits)
    bits_all = np.ascontiguousarray(np.concatenate(bits_cat))
    lens_all = np.ascontiguousarray(np.concatenate(lens_cat))
    lut_arr = _build_dist_lut_array(width)

    out_p = ctypes.POINTER(ctypes.c_uint8)()
    out_n = ctypes.c_uint64(0)
    acc_out = ctypes.c_uint32(0)
    used_out = ctypes.c_int(0)
    ops = np.ascontiguousarray(refs.ops, np.uint8)
    argbs = np.ascontiguousarray(refs.argb, np.uint32)
    lens = np.ascontiguousarray(refs.lengths, np.int32)
    dists = np.ascontiguousarray(refs.dists, np.int32)
    lib.wtpu_vp8l_emit(
        ops.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        argbs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dists.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(ops), width,
        bits_all.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        lens_all.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lut_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(lut_arr),
        bw._acc & 0xFFFFFFFF, bw._used,
        ctypes.byref(out_p), ctypes.byref(out_n),
        ctypes.byref(acc_out), ctypes.byref(used_out),
    )
    data = ctypes.string_at(out_p, out_n.value)
    lib.wtpu_free(out_p)
    bw._buf.extend(data)
    bw._acc = int(acc_out.value)
    bw._used = int(used_out.value)
    return True


def _emit_refs(bw: BitWriter, refs: RefStream, codes, width: int, lut) -> None:
    if _emit_refs_native(bw, refs, codes, width):
        return
    green, red, blue, alpha, dist = codes
    g_bits, g_lens = green.bits, green.lengths
    r_bits, r_lens = red.bits, red.lengths
    b_bits, b_lens = blue.bits, blue.lengths
    a_bits, a_lens = alpha.bits, alpha.lengths
    put = bw.put_bits
    for op, argb, length, d in zip(refs.ops, refs.argb, refs.lengths, refs.dists):
        if op == 0:
            a = int(argb)
            g = (a >> 8) & 0xFF
            put(int(g_bits[g]), int(g_lens[g]))
            r = (a >> 16) & 0xFF
            put(int(r_bits[r]), int(r_lens[r]))
            b = a & 0xFF
            put(int(b_bits[b]), int(b_lens[b]))
            al = (a >> 24) & 0xFF
            put(int(a_bits[al]), int(a_lens[al]))
        elif op == 2:
            sym = NUM_LITERAL_CODES + NUM_LENGTH_CODES + int(length)
            put(int(g_bits[sym]), int(g_lens[sym]))
        else:
            lcode, lext, lval = prefix_encode(int(length))
            sym = NUM_LITERAL_CODES + lcode
            put(int(g_bits[sym]), int(g_lens[sym]))
            if lext:
                put(lval, lext)
            dcode, dext, dval = prefix_encode(
                dist_to_plane_code(width, int(d), lut)
            )
            dist.write_symbol(bw, dcode)
            if dext:
                put(dval, dext)


# ---------------------------------------------------------------------------
# Transforms (encoder side)
# ---------------------------------------------------------------------------


def _choose_predictors_auto(argb: np.ndarray, bits: int,
                            refine_iters: int, row_step: int = 1,
                            device: bool | None = None,
                            stats=None) -> np.ndarray:
    """Run the predictor analysis on the device for large images.

    The per-tile entropy chooser is the pixel-rate part of VP8L
    analysis (SURVEY.md §7 step 4).  ``device=None`` decides from the
    input: when the JAX default backend is an accelerator and the image
    is big enough to amortize the transfer (≥1 MP), run
    `ops.lossless_jax.predictor_search_entropy` — the same
    histogram-entropy cost + global refinement, one device pass — and
    the host chooser otherwise.  ``device=True``/``False`` forces one
    side.  Device errors propagate.  f32-vs-f64 scoring can flip rare
    near-tie tiles; both maps price within a fraction of a percent
    (golden-tested).  ``stats.predictor_chooser`` records the side."""
    import jax

    if device is None:
        device = (argb.shape[0] * argb.shape[1] >= (1 << 20)
                  and jax.default_backend() != "cpu")
    if stats is not None:
        stats.predictor_chooser = "device" if device else "host"
    if device:
        from ...ops.lossless_jax import predictor_search_entropy

        # (the device pass is fast enough to score every row;
        # row_step only throttles the host chooser)
        modes = np.asarray(predictor_search_entropy(
            jax.device_put(np.ascontiguousarray(argb, np.uint32)),
            bits, refine_iters=refine_iters)).astype(np.uint32)
        return (0xFF000000 | (modes << 8)).astype(np.uint32)
    return _choose_predictors(argb, bits, refine_iters=refine_iters,
                              row_step=row_step)


def _choose_predictors(argb: np.ndarray, bits: int,
                       refine_iters: int = 4,
                       row_step: int = 1) -> np.ndarray:
    """Per-tile best predictor by residual-histogram entropy.

    Evaluates all 14 predictors over the whole image at once (this is the
    array-shaped part — a (14, H, W) residual tensor reduced per tile).
    The cost per tile is the Shannon entropy of the four per-channel
    residual-byte histograms plus a small magnitude bias — the cost model
    of the reference's per-tile predictor search
    (vp8l_transforms.go predictor selection), rather than a pure
    magnitude proxy: entropy correctly prefers a *constant* residual
    (e.g. TOP on a vertical gradient) over a mostly-zero-but-ragged one,
    which also LZ77-compresses far better.  A raster re-pick pass then
    biases ties toward the left/top neighbor's mode for cross-tile
    consistency.
    """
    h, w = argb.shape
    th = tnp.subsample_size(h, bits)
    tw = tnp.subsample_size(w, bits)
    T = th * tw
    tile_sz = 1 << bits

    # Native fast path (same algorithm in C++; ~10x the numpy cost).
    from ...entropy.native_loader import get_lib

    lib = get_lib()
    if lib is not None and hasattr(lib, "wtpu_vp8l_choose_predictors"):
        import ctypes

        flat = np.ascontiguousarray(argb, np.uint32)
        out = np.empty(T, np.uint8)
        lib.wtpu_vp8l_choose_predictors(
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            h, w, bits, refine_iters, row_step,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        modes = out.reshape(th, tw).astype(np.uint32)
        return (0xFF000000 | (modes << 8)).astype(np.uint32)

    # row_step > 1: score on every row_step'th row only (residuals are
    # still exact — they read true neighbours from the full plane).
    rsel = np.arange(0, h, max(1, row_step))
    # Per-pixel tile id over the scored rows, flattened once.
    ty = rsel >> bits
    tx = np.arange(w) >> bits
    tile_id = (ty[:, None] * tw + tx[None, :]).ravel()
    # Combined bin index base: tile*1024 + channel*256 (+ byte).
    base = tile_id * 1024

    # Per-tile per-channel pixel counts (edge tiles are smaller).
    npx = np.bincount(tile_id, minlength=T).astype(np.float64)
    n_log_n = 4.0 * npx * _log2f(npx + 1e-9)

    folded = np.minimum(np.arange(256), np.arange(256)[::-1] + 1)
    mag_bias = (0.04 * folded).astype(np.float64)

    costs = np.empty((14, T), np.float64)
    for mode in range(14):
        pred = _predict_plane(argb, mode)
        res = _sub_pixels_vec(argb, pred)[rsel].ravel()
        hist = np.zeros(T * 1024, np.int64)
        for ch, shift in enumerate((24, 16, 8, 0)):
            b = (res >> shift) & 0xFF
            hist += np.bincount(base + ch * 256 + b, minlength=T * 1024)
        hh = hist.reshape(T, 1024).astype(np.float64)
        # Shannon: 4*N*log2(N) - sum n_i*log2(n_i), channels disjoint bins.
        ent = n_log_n - (hh * _log2f(hh + 1e-9)).sum(axis=1)
        bias = hh @ np.tile(mag_bias, 4)
        costs[mode] = ent + bias

    modes = costs.argmin(axis=0).reshape(th, tw)

    # Refinement: per-tile entropy is locally greedy but all tiles share
    # Huffman trees, so diverse modes can *raise* the global entropy.
    # Iterate: build the global residual-byte distribution under the
    # current picks, then re-pick each tile by its cross-entropy under
    # that shared distribution plus the mode symbol's own cost (the
    # accumulated-histogram bias of the reference's per-tile search,
    # made parallel: a fixed-point iteration instead of a raster scan).
    cache_bytes = h * w <= (1 << 22)
    res_bytes = None
    if cache_bytes:
        res_bytes = np.empty((14, 4, h, w), np.uint8)
        for mode in range(14):
            pred = _predict_plane(argb, mode)
            res = _sub_pixels_vec(argb, pred)
            for ch, shift in enumerate((24, 16, 8, 0)):
                res_bytes[mode, ch] = (res >> shift) & 0xFF

    tile_2d = tile_id.reshape(len(rsel), w)
    for _ in range(refine_iters):
        # Global per-channel byte distribution under current modes
        # (scored rows only, matching stage 1).
        mode_px = np.repeat(np.repeat(modes, tile_sz, 0), tile_sz, 1)[
            :h, :w][rsel]
        glob = np.zeros((4, 256), np.float64)
        if cache_bytes:
            pick = res_bytes[mode_px, :, rsel[:, None], np.arange(w)]
            # pick: (len(rsel), w, 4)
            for ch in range(4):
                glob[ch] = np.bincount(pick[..., ch].ravel(), minlength=256)
        else:
            for mode in range(14):
                sel = mode_px == mode
                if not sel.any():
                    continue
                pred = _predict_plane(argb, mode)
                res = _sub_pixels_vec(argb, pred)[rsel][sel]
                for ch, shift in enumerate((24, 16, 8, 0)):
                    glob[ch] += np.bincount((res >> shift) & 0xFF,
                                            minlength=256)
        logp = _log2f((glob + 0.1) / (glob.sum(axis=1, keepdims=True) + 25.6))
        mcount = np.bincount(modes.ravel(), minlength=14).astype(np.float64)
        mode_cost = -_log2f((mcount + 0.1) / (mcount.sum() + 1.4))

        new_costs = np.empty((14, T), np.float64)
        for mode in range(14):
            if cache_bytes:
                per_px = (logp[0][res_bytes[mode, 0][rsel]]
                          + logp[1][res_bytes[mode, 1][rsel]]
                          + logp[2][res_bytes[mode, 2][rsel]]
                          + logp[3][res_bytes[mode, 3][rsel]])
            else:
                pred = _predict_plane(argb, mode)
                res = _sub_pixels_vec(argb, pred)[rsel]
                per_px = (logp[0][(res >> 24) & 0xFF]
                          + logp[1][(res >> 16) & 0xFF]
                          + logp[2][(res >> 8) & 0xFF]
                          + logp[3][res & 0xFF])
            new_costs[mode] = np.bincount(
                tile_2d.ravel(), weights=-per_px.ravel(), minlength=T
            ) + mode_cost[mode]
        new_modes = new_costs.argmin(axis=0).reshape(th, tw)
        if np.array_equal(new_modes, modes):
            break
        modes = new_modes

    return (0xFF000000 | (modes.astype(np.uint32) << 8)).astype(np.uint32)


def _residual_cost_table() -> np.ndarray:
    """Approximate bit cost of a residual byte (symmetric around 0/256)."""
    v = np.arange(256)
    folded = np.minimum(v, 256 - v)
    return (2 * np.ceil(np.log2(1 + folded)) + 1).astype(np.int64)


def _predict_plane(argb: np.ndarray, mode: int) -> np.ndarray:
    """Vectorized predictor over the full plane (encode-side context).

    Matches decoder edge semantics: row 0 → Left, col 0 → Top, (0,0) →
    black; TR of the last column wraps to current row's first pixel.
    """
    h, w = argb.shape
    L = np.empty_like(argb)
    T = np.empty_like(argb)
    TL = np.empty_like(argb)
    TR = np.empty_like(argb)
    L[:, 1:] = argb[:, :-1]
    L[:, 0] = 0
    T[1:] = argb[:-1]
    T[0] = 0
    TL[1:, 1:] = argb[:-1, :-1]
    TL[0] = 0
    TL[:, 0] = 0
    TR[1:, :-1] = argb[:-1, 1:]
    TR[1:, -1] = argb[1:, 0]   # wrap: current row's first pixel
    TR[0] = 0

    pred = _apply_predictor_vec(mode, L, T, TL, TR)
    # Edge overrides.
    if h > 0:
        pred[0, 1:] = L[0, 1:]          # top row: Left
    pred[1:, 0] = T[1:, 0]              # left col: Top
    pred[0, 0] = 0xFF000000             # origin: black
    return pred


def _avg2_vec(a, b):
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _sub_pixels_vec(x, p):
    lo = ((x | 0x01000100) - (p & 0x00FF00FF)) & 0x00FF00FF
    hi = (((x >> 8) | 0x01000100) - ((p >> 8) & 0x00FF00FF)) & 0x00FF00FF
    return (lo | (hi << 8)).astype(np.uint32)


def _add_pixels_vec(x, p):
    lo = ((x & 0x00FF00FF) + (p & 0x00FF00FF)) & 0x00FF00FF
    hi = (((x >> 8) & 0x00FF00FF) + ((p >> 8) & 0x00FF00FF)) & 0x00FF00FF
    return (lo | (hi << 8)).astype(np.uint32)


def _channels(v):
    return (v >> 24) & 0xFF, (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF


def _pack(a, r, g, b):
    return ((a.astype(np.uint64) << 24) | (r.astype(np.uint64) << 16)
            | (g.astype(np.uint64) << 8) | b.astype(np.uint64)).astype(np.uint32)


def _clip255_vec(v):
    return np.clip(v, 0, 255)


def _apply_predictor_vec(mode, L, T, TL, TR):
    if mode == 0:
        return np.full_like(L, 0xFF000000)
    if mode == 1:
        return L
    if mode == 2:
        return T
    if mode == 3:
        return TR
    if mode == 4:
        return TL
    if mode == 5:
        return _avg2_vec(_avg2_vec(L, TR), T)
    if mode == 6:
        return _avg2_vec(L, TL)
    if mode == 7:
        return _avg2_vec(L, T)
    if mode == 8:
        return _avg2_vec(TL, T)
    if mode == 9:
        return _avg2_vec(T, TR)
    if mode == 10:
        return _avg2_vec(_avg2_vec(L, TL), _avg2_vec(T, TR))
    if mode == 11:  # Select
        la, lr, lg, lb = _channels(L.astype(np.int64))
        ta, tr_, tg, tb = _channels(T.astype(np.int64))
        tla, tlr, tlg, tlb = _channels(TL.astype(np.int64))
        p_l = (np.abs(ta - tla) + np.abs(tr_ - tlr)
               + np.abs(tg - tlg) + np.abs(tb - tlb))
        p_t = (np.abs(la - tla) + np.abs(lr - tlr)
               + np.abs(lg - tlg) + np.abs(lb - tlb))
        return np.where(p_l < p_t, L, T)
    if mode == 12:  # ClampedAddSubtractFull
        la, lr, lg, lb = _channels(L.astype(np.int64))
        ta, tr_, tg, tb = _channels(T.astype(np.int64))
        tla, tlr, tlg, tlb = _channels(TL.astype(np.int64))
        return _pack(
            _clip255_vec(la + ta - tla), _clip255_vec(lr + tr_ - tlr),
            _clip255_vec(lg + tg - tlg), _clip255_vec(lb + tb - tlb),
        )
    if mode == 13:  # ClampedAddSubtractHalf
        ave = _avg2_vec(L, T).astype(np.int64)
        aa, ar, ag, ab = _channels(ave)
        tla, tlr, tlg, tlb = _channels(TL.astype(np.int64))

        def half(a, b):
            d = a - b
            h = np.where(d >= 0, d // 2, -((-d) // 2))
            return _clip255_vec(a + h)

        return _pack(half(aa, tla), half(ar, tlr), half(ag, tlg), half(ab, tlb))
    raise ValueError(mode)


def _apply_predictor_transform(argb: np.ndarray, bits: int,
                               mode_img: np.ndarray) -> np.ndarray:
    """Residual = pixel - pred(mode per tile), vectorized per mode."""
    h, w = argb.shape
    from ...entropy.native_loader import get_lib

    lib = get_lib()
    if lib is not None and hasattr(lib, "wtpu_vp8l_predictor_residual"):
        import ctypes

        u32p = ctypes.POINTER(ctypes.c_uint32)
        flat = np.ascontiguousarray(argb, np.uint32)
        modes = np.ascontiguousarray(mode_img, np.uint32)
        out = np.empty((h, w), np.uint32)
        lib.wtpu_vp8l_predictor_residual(
            flat.ctypes.data_as(u32p), h, w, bits,
            modes.ctypes.data_as(u32p), modes.shape[1],
            out.ctypes.data_as(u32p),
        )
        return out
    ty = np.arange(h) >> bits
    tx = np.arange(w) >> bits
    modes = ((mode_img[np.ix_(ty, tx)] >> 8) & 0xFF).astype(np.int32)
    out = np.zeros_like(argb)
    for mode in np.unique(modes):
        pred = _predict_plane(argb, int(mode))
        mask = modes == mode
        out[mask] = _sub_pixels_vec(argb[mask], pred[mask])
    # Edge pixels use fixed predictors regardless of tile mode.
    pred_edge = _predict_plane(argb, 1)  # any mode; edges overridden inside
    out[0, :] = _sub_pixels_vec(argb[0, :], pred_edge[0, :])
    out[:, 0] = _sub_pixels_vec(argb[:, 0], pred_edge[:, 0])
    return out


def _residual_mag(argb: np.ndarray) -> int:
    """Folded-magnitude proxy for residual cost (smaller = better)."""
    total = 0
    for shift in (16, 0):
        ch = ((argb >> shift) & 0xFF).astype(np.int64)
        total += int(np.minimum(ch, 256 - ch).sum())
    return total


def _probe_rows(argb: np.ndarray) -> np.ndarray:
    """Row subsample for transform-trial cost probes.

    Trial scoring only needs the *relative* ordering of candidates, so on
    tall images three 128-row slabs (top/middle/bottom) stand in for the
    full image; matches within a slab are intact, dist-width matches
    cross slab seams harmlessly (same estimate noise for every
    candidate).  ≤400-row images are probed exactly.
    """
    h = argb.shape[0]
    if h <= 400:
        return argb
    slabs = [argb[r0:r0 + 128]
             for r0 in (0, (h - 128) * 2 // 5, (h - 128) * 4 // 5)]
    return np.ascontiguousarray(np.concatenate(slabs, axis=0))


def _refs_cost_bits(argb: np.ndarray, width: int, quality: int) -> float:
    """Estimated body cost: LZ77 refs + histogram entropy (no emission).

    Used to gate the cross-color transform: unlike raw literal entropy,
    this accounts for LZ77 — on highly repetitive residuals the copy
    stream dominates and a transform that lowers literal entropy may
    save nothing in the actual bitstream.
    """
    refs = build_refs_lz77(argb, width, quality, 0)
    if refs is None:
        refs = build_backward_refs(argb, width)
    lut = _build_dist_code_lut(width)
    return _entropy_bits(_build_histograms(refs, width, lut, 0))


_CC_NEAR_W = None


def _cc_cost_rows(hist: np.ndarray) -> np.ndarray:
    """(T, 256) residual-byte histograms → per-tile cross-color cost.

    Shannon bits minus a near-zero concentration bonus: the coder pays
    entropy, and residual mass concentrated around 0 additionally helps
    the shared global trees (cross-tile consistency).  Same formula as
    the native twin (cc_hist_cost in entropy/native/vp8l_dec.cpp).
    """
    global _CC_NEAR_W
    if _CC_NEAR_W is None:
        wv = np.zeros(256)
        wv[0] = 3.0
        e = 2.4
        for i in range(1, 16):
            wv[i] += e
            wv[256 - i] += e
            e *= 0.6
        _CC_NEAR_W = wv
    h = hist.astype(np.float64)
    tot = h.sum(axis=1)
    ent = tot * _log2f(tot + 1e-12) - (h * _log2f(h + 1e-12)).sum(axis=1)
    return ent - 0.1 * (hist @ _CC_NEAR_W)


def _choose_cross_color(argb: np.ndarray, bits: int) -> np.ndarray | None:
    return _choose_cross_color_scored(argb, bits)[0]


def _choose_cross_color_scored(
        argb: np.ndarray, bits: int, row_step: int = 1
) -> tuple[np.ndarray | None, float]:
    """Per-tile g→r / g→b / r→b multipliers by ENTROPY descent.

    Returns (transform_image | None, gain_bits): the summed cost saved
    versus the zero transform — lets the caller decide cross-color
    on/off without a trial probe.  row_step > 1 subsamples the scoring
    rows (the transform itself stays exact).

    Least squares minimizes residual variance, but the coder pays
    Shannon bits; on photographic content the entropy objective is
    worth ~1.5-2% of the whole file (it closed the VP8L natural-corpus
    gap vs libwebp from 1.016x to 0.993x, round 5).  Each 3.5-bit
    fixed-point multiplier is found by a coarse-to-fine descent
    (deltas 32..1; the blue pair moves along 8 joint directions), all
    tiles advancing together in the vectorized fallback.  Returns the
    transform image, or None when every tile stays at 0.  Reference:
    GetBestGreenToRed/GetBestGreenRedToBlue (predictor_enc.go:759-877).
    """
    h, w = argb.shape
    th = tnp.subsample_size(h, bits)
    tw = tnp.subsample_size(w, bits)
    from ...entropy.native_loader import get_lib

    lib = get_lib()
    if lib is not None and hasattr(lib, "wtpu_vp8l_cross_color_fit"):
        import ctypes

        flat = np.ascontiguousarray(argb, np.uint32)
        out = np.empty(th * tw * 3, np.int8)
        gain_c = ctypes.c_double(0.0)
        lib.wtpu_vp8l_cross_color_fit(
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            h, w, bits, row_step,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            ctypes.byref(gain_c),
        )
        mults = out.reshape(th, tw, 3).astype(np.int64)
        g2r, g2b, r2b = mults[..., 0], mults[..., 1], mults[..., 2]
        if not (g2r.any() or g2b.any() or r2b.any()):
            return None, 0.0
        return (
            0xFF000000
            | ((r2b & 0xFF).astype(np.uint32) << 16)
            | ((g2b & 0xFF).astype(np.uint32) << 8)
            | (g2r & 0xFF).astype(np.uint32)
        ).astype(np.uint32), float(gain_c.value)

    T = th * tw
    rsel = np.arange(0, h, max(1, row_step))
    ty = rsel >> bits
    tx = np.arange(w) >> bits
    tile_id = (ty[:, None] * tw + tx[None, :]).ravel()
    base = tile_id * 256

    def signed(shift):
        return ((argb[rsel] >> shift) & 0xFF).astype(np.uint8).astype(
            np.int8).astype(np.int32).ravel()

    g = signed(8)
    r = signed(16)
    b = signed(0)

    def cost_red(m_t):
        mp = m_t[tile_id].astype(np.int8).astype(np.int32)
        res = (r - ((mp * g) >> 5)) & 0xFF
        hist = np.bincount(base + res, minlength=T * 256).reshape(T, 256)
        return _cc_cost_rows(hist)

    def cost_blue(mg_t, mr_t):
        mg = mg_t[tile_id].astype(np.int8).astype(np.int32)
        mr = mr_t[tile_id].astype(np.int8).astype(np.int32)
        res = (b - ((mg * g) >> 5) - ((mr * r) >> 5)) & 0xFF
        hist = np.bincount(base + res, minlength=T * 256).reshape(T, 256)
        return _cc_cost_rows(hist)

    g2r = np.zeros(T, np.int32)
    zero_red = cost_red(g2r)
    bcost = zero_red
    for delta in (32, 16, 8, 4, 2, 1):
        for sgn in (-1, 1):
            cand = np.clip(g2r + sgn * delta, -128, 127)
            c = cost_red(cand)
            take = c < bcost
            g2r = np.where(take, cand, g2r)
            bcost = np.where(take, c, bcost)
    gain = float((zero_red - bcost).sum())

    g2b = np.zeros(T, np.int32)
    r2b = np.zeros(T, np.int32)
    zero_blue = cost_blue(g2b, r2b)
    bcost = zero_blue
    for delta in (32, 16, 8, 4, 2, 1):
        for dg, dr in ((0, 1), (0, -1), (1, 0), (-1, 0),
                       (1, 1), (1, -1), (-1, 1), (-1, -1)):
            cg = np.clip(g2b + dg * delta, -128, 127)
            cr = np.clip(r2b + dr * delta, -128, 127)
            c = cost_blue(cg, cr)
            take = c < bcost
            g2b = np.where(take, cg, g2b)
            r2b = np.where(take, cr, r2b)
            bcost = np.where(take, c, bcost)
    gain += float((zero_blue - bcost).sum())
    gain *= max(1, row_step)

    if not (g2r.any() or g2b.any() or r2b.any()):
        return None, 0.0
    timg = (
        0xFF000000
        | ((r2b.astype(np.int64) & 0xFF).astype(np.uint32) << 16)
        | ((g2b.astype(np.int64) & 0xFF).astype(np.uint32) << 8)
        | (g2r.astype(np.int64) & 0xFF).astype(np.uint32)
    ).astype(np.uint32).reshape(th, tw)
    return timg, gain


# ---------------------------------------------------------------------------
# Stream assembly
# ---------------------------------------------------------------------------


def _write_image_stream(bw: BitWriter, argb: np.ndarray, width: int) -> None:
    """Entropy-coded image (no transforms): cache bit, codes, pixels."""
    bw.put_bits(0, 1)  # no color cache
    refs = build_backward_refs(argb, width)
    lut = _build_dist_code_lut(width)
    hists = _build_histograms(refs, width, lut)
    codes = [store_huffman_code(bw, build_code_lengths(h)) for h in hists]
    _emit_refs(bw, refs, codes, width, lut)


def build_refs_lz77(argb: np.ndarray, width: int, quality: int,
                    cache_bits: int) -> RefStream | None:
    """Native hash-chain LZ77 (+color cache); None without the lib."""
    import ctypes

    from ...entropy.native_loader import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "wtpu_vp8l_hashchain_refs"):
        return None
    flat = np.ascontiguousarray(argb.reshape(-1), np.uint32)
    n = len(flat)
    ops = np.zeros(n, np.uint8)
    argbs = np.zeros(n, np.uint32)
    lens = np.zeros(n, np.int32)
    dists = np.zeros(n, np.int32)
    depth = 8 + quality // 5         # chain-walk budget
    n_ops = lib.wtpu_vp8l_hashchain_refs(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        n, width, depth, cache_bits,
        ops.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        argbs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dists.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return RefStream(ops[:n_ops], argbs[:n_ops], lens[:n_ops], dists[:n_ops])


def _pick_cache_bits(refs: RefStream, argb: np.ndarray,
                     max_bits: int = 10) -> int | None:
    """Best cache_bits (0..max) by native one-pass simulation; None w/o lib."""
    import ctypes

    from ...entropy.native_loader import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "wtpu_vp8l_cache_score"):
        return None
    flat = np.ascontiguousarray(argb.reshape(-1), np.uint32)
    scores = np.zeros(max_bits + 1, np.float64)
    lib.wtpu_vp8l_cache_score(
        refs.ops.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        refs.argb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        refs.lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(refs.ops),
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        max_bits,
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return int(np.argmin(scores))


def _apply_cache_native(refs: RefStream, argb: np.ndarray,
                        cache_bits: int) -> None:
    """In-place literal→cache-hit rewrite of a cache-less refs stream."""
    import ctypes

    from ...entropy.native_loader import get_lib

    lib = get_lib()
    flat = np.ascontiguousarray(argb.reshape(-1), np.uint32)
    lib.wtpu_vp8l_cache_apply(
        refs.ops.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        refs.argb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        refs.lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(refs.ops),
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        cache_bits,
    )


def _symbol_costs(h: np.ndarray) -> np.ndarray:
    """-log2 probability per symbol (bits), smoothed for unseen symbols."""
    tot = float(h.sum())
    if tot <= 0:
        return np.full(len(h), 8.0, np.float32)
    p = (h.astype(np.float64) + 0.2) / (tot + 0.2 * len(h))
    return (-_log2f(p + 1e-12)).astype(np.float32)


def build_refs_optimal(argb: np.ndarray, width: int, quality: int,
                       cache_bits: int,
                       seed: RefStream | None = None) -> RefStream | None:
    """Cost-model optimal parse (native DP); None without the lib.

    A greedy pass supplies the symbol-cost model (the reference's
    TraceBackwards strategy); the C++ DP then finds the cheapest path
    over pixel positions and rewrites literals as color-cache hits.
    Pass ``seed`` to reuse an existing greedy parse for the cost model
    instead of re-parsing.
    """
    import ctypes

    from ...entropy.native_loader import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "wtpu_vp8l_optimal_refs"):
        return None
    if seed is None:
        seed = build_refs_lz77(argb, width, quality, cache_bits)
    if seed is None:
        return None
    lut = _build_dist_code_lut(width)
    g, r, b, a, d = _build_histograms(seed, width, lut, cache_bits)
    gc = _symbol_costs(g[:280])
    costs = [np.ascontiguousarray(cst, np.float32) for cst in
             (gc, _symbol_costs(r), _symbol_costs(b), _symbol_costs(a),
              _symbol_costs(d))]
    lut_arr = _build_dist_lut_array(width).astype(np.int32)

    flat = np.ascontiguousarray(argb.reshape(-1), np.uint32)
    n = len(flat)
    ops = np.zeros(n, np.uint8)
    argbs = np.zeros(n, np.uint32)
    lens = np.zeros(n, np.int32)
    dists = np.zeros(n, np.int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    n_ops = lib.wtpu_vp8l_optimal_refs(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        n, width, 8 + quality // 5, cache_bits,
        *(cst.ctypes.data_as(f32p) for cst in costs),
        lut_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(lut_arr),
        ops.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        argbs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dists.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return RefStream(ops[:n_ops], argbs[:n_ops], lens[:n_ops], dists[:n_ops])


def _entropy_bits(hists) -> float:
    total_bits = 0.0
    for h in hists:
        tot = int(h.sum())
        if tot == 0:
            continue
        nz = h[h > 0].astype(np.float64)
        total_bits += float((nz * (np.log2(tot) - _log2f(nz + 1e-9))).sum())
        # Rough header cost per used symbol.
        total_bits += 6.0 * len(nz)
    return total_bits


def _op_start_positions(refs: RefStream) -> np.ndarray:
    counts = np.where(refs.ops == 1, refs.lengths, 1).astype(np.int64)
    starts = np.zeros(len(counts), np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    return starts


def _green_symbols(refs: RefStream, width: int) -> np.ndarray:
    """Vectorized green-tree symbol per op."""
    syms = np.zeros(len(refs.ops), np.int64)
    lit = refs.ops == 0
    syms[lit] = (refs.argb[lit] >> 8) & 0xFF
    cp = refs.ops == 1
    if cp.any():
        lut_arr = _build_dist_lut_array(width)
        lcodes, _, _ = prefix_encode_vec(refs.lengths[cp])
        syms[cp] = NUM_LITERAL_CODES + lcodes
    ca = refs.ops == 2
    syms[ca] = NUM_LITERAL_CODES + NUM_LENGTH_CODES + refs.lengths[ca]
    return syms


def _tile_histograms(refs: RefStream, width: int, height: int, bits: int,
                     cache_bits: int):
    """Per-tile 5-tree histograms as one (T, S) matrix + tree slices."""
    cache_size = (1 << cache_bits) if cache_bits else 0
    g_n = NUM_LITERAL_CODES + NUM_LENGTH_CODES + cache_size
    slices = [
        (0, g_n),
        (g_n, g_n + 256),
        (g_n + 256, g_n + 512),
        (g_n + 512, g_n + 768),
        (g_n + 768, g_n + 768 + NUM_DISTANCE_CODES),
    ]
    S = slices[-1][1]
    tw = tnp.subsample_size(width, bits)
    th = tnp.subsample_size(height, bits)
    T = tw * th
    starts = _op_start_positions(refs)
    tile = ((starts // width) >> bits) * tw + ((starts % width) >> bits)
    H = np.zeros((T, S), np.int64)
    gsym = _green_symbols(refs, width)
    np.add.at(H, (tile, gsym), 1)
    lit = refs.ops == 0
    if lit.any():
        lits = refs.argb[lit]
        tl = tile[lit]
        np.add.at(H, (tl, g_n + ((lits >> 16) & 0xFF)), 1)
        np.add.at(H, (tl, g_n + 256 + (lits & 0xFF)), 1)
        np.add.at(H, (tl, g_n + 512 + ((lits >> 24) & 0xFF)), 1)
    cp = refs.ops == 1
    if cp.any():
        lut_arr = _build_dist_lut_array(width)
        ds = refs.dists[cp].astype(np.int64)
        planes = np.where(
            (ds < len(lut_arr)) & (lut_arr[np.minimum(ds, len(lut_arr) - 1)] > 0),
            lut_arr[np.minimum(ds, len(lut_arr) - 1)],
            ds + 120,
        )
        dcodes, _, _ = prefix_encode_vec(planes)
        np.add.at(H, (tile[cp], g_n + 768 + dcodes), 1)
    return H, slices, tile, tw, th


def _entropy_of_rows(H: np.ndarray, slices) -> np.ndarray:
    """Shannon bits per histogram row (summed over the 5 trees)."""
    out = np.zeros(len(H), np.float64)
    for a, b in slices:
        sub = H[:, a:b].astype(np.float64)
        tot = sub.sum(axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            p = sub / np.maximum(tot[:, None], 1)
            bits = -np.where(sub > 0, sub * _log2f(p + 1e-12), 0.0)
        out += bits.sum(axis=1)
    return out


GROUP_HEADER_BITS = 1500.0   # approx cost of one extra group's 5 codes


def _tree_entropy(H: np.ndarray, a: int, b: int) -> np.ndarray:
    """Shannon bits of one tree's sub-histogram per row."""
    sub = H[:, a:b].astype(np.float64)
    tot = sub.sum(axis=1)
    n_log_n = tot * _log2f(tot + 1e-9)
    return n_log_n - (sub * _log2f(sub + 1e-9)).sum(axis=1)


def _stochastic_merge(rows, cost, group_of, alive, slices,
                      down_to: int, seed: int = 7):
    """Reference-style stochastic pair merging (HistogramCombineStochastic,
    enc/histogram_enc.go:941-1051): sample random live pairs, vectorized
    savings evaluation, apply the best beneficial merge; give up after a
    streak of fruitless rounds.  Reduces ~1000 groups to a size the
    exact greedy stage can afford (O(G²))."""
    rng = np.random.default_rng(seed)
    fails = 0
    while int(alive.sum()) > down_to and fails < 8:
        live = np.flatnonzero(alive)
        n = len(live)
        if n <= 1:
            break
        k = min(max(16, 4 * int(np.sqrt(n))), n * (n - 1) // 2)
        ii = rng.integers(0, n, k)
        jj = (ii + 1 + rng.integers(0, n - 1, k)) % n
        i_idx, j_idx = live[ii], live[jj]
        merged = rows[i_idx] + rows[j_idx]
        ent = _entropy_of_rows(merged, slices)
        sav = cost[i_idx] + cost[j_idx] - ent
        b = int(np.argmax(sav))
        # A merge removes one group header; accept anything cheaper
        # than that (matches the greedy stage's stop criterion).
        if sav[b] > -GROUP_HEADER_BITS or int(alive.sum()) > 4 * down_to:
            i, j = int(i_idx[b]), int(j_idx[b])
            rows[i] += rows[j]
            cost[i] = float(_entropy_of_rows(rows[i][None, :], slices)[0])
            alive[j] = False
            group_of[group_of == j] = i
            fails = 0
        else:
            fails += 1


def _cluster_histograms(H: np.ndarray, slices, max_groups: int = 256,
                        refine_iters: int = 2):
    """Tile-histogram clustering → (group_map, merged_rows).

    Four stages, all vectorized (the array-shaped re-expression of the
    reference's histogram_enc.go combine path):
      1. entropy-bin preclustering — tiles whose (literal, red, blue
         [, distance]) entropy signature lands in the same discretized
         bin share a group; the signature resolution scales with the
         tile count so large heterogeneous images keep ≥several hundred
         initial groups instead of being crushed into 64 bins;
      2. stochastic pair merging down to a greedy-affordable count
         (the reference's HistogramCombineStochastic);
      3. exact greedy pairwise merging with an incrementally-maintained
         savings matrix, stopping when the best merge loses more than a
         group's header cost;
      4. k-means-style refinement: reassign every tile to the group
         whose code distribution codes it cheapest, then rebuild.
    """
    T = len(H)
    if T <= 1:
        return np.zeros(T, np.int32), [H[i] for i in range(T)]
    H = H.astype(np.int64)

    # --- Stage 1: precluster by discretized entropy signature. ---
    levels = 4 if T <= 256 else 6
    comps = (slices[0], slices[1], slices[2]) + (
        (slices[4],) if T > 256 and len(slices) > 4 else ())
    sig = []
    for a, b in comps:
        e = _tree_entropy(H, a, b)
        hi = e.max()
        q = np.minimum((e / max(hi, 1e-9) * levels).astype(np.int64),
                       levels - 1)
        sig.append(q)
    bin_id = sig[0]
    for s in sig[1:]:
        bin_id = bin_id * levels + s
    uniq, bin_of = np.unique(bin_id, return_inverse=True)
    G = len(uniq)
    rows = np.zeros((G, H.shape[1]), np.int64)
    np.add.at(rows, bin_of, H)
    group_of = bin_of.astype(np.int64)

    cost = _entropy_of_rows(rows, slices)

    # --- Stage 2: stochastic merge while the pair matrix is too big. ---
    if G > 96:
        alive0 = np.ones(G, bool)
        _stochastic_merge(rows, cost, group_of, alive0, slices, down_to=96)
        live_idx = np.flatnonzero(alive0)
        remap = np.full(G, -1, np.int64)
        remap[live_idx] = np.arange(len(live_idx))
        group_of = remap[group_of]
        rows = rows[live_idx].copy()
        cost = cost[live_idx]
        G = len(live_idx)

    # --- Stage 3: exact greedy merging with incremental savings. ---

    def pair_savings(i, rows, cost, alive_mask):
        merged = rows[i][None, :] + rows
        ent = _entropy_of_rows(merged, slices)
        s = cost[i] + cost - ent
        s[~alive_mask] = -np.inf
        s[i] = -np.inf
        return s

    alive = np.ones(G, bool)
    M = np.full((G, G), -np.inf)
    for i in range(G):
        M[i] = pair_savings(i, rows, cost, alive)
    while alive.sum() > 1:
        flat = np.argmax(M)
        i, j = divmod(int(flat), G)
        saving = M[i, j]
        n_alive = int(alive.sum())
        if saving <= -GROUP_HEADER_BITS and n_alive <= max_groups:
            break
        if saving <= 0 and n_alive <= 2:
            break
        rows[i] += rows[j]
        cost[i] = float(_entropy_of_rows(rows[i][None, :], slices)[0])
        alive[j] = False
        group_of[group_of == j] = i
        M[j, :] = -np.inf
        M[:, j] = -np.inf
        M[i, :] = pair_savings(i, rows, cost, alive)
        M[:, i] = M[i, :]

    live_idx = np.flatnonzero(alive)
    remap = np.full(G, -1, np.int64)
    remap[live_idx] = np.arange(len(live_idx))
    group_of = remap[group_of]
    rows = rows[live_idx]

    # --- Stage 3: refinement (cheapest-group reassignment). ---
    for _ in range(refine_iters):
        if len(rows) <= 1:
            break
        # log2 of per-tree code distributions, epsilon-smoothed.
        logp = np.empty(rows.shape, np.float64)
        for a, b in slices:
            sub = rows[:, a:b].astype(np.float64) + 0.04
            logp[:, a:b] = _log2f(sub / sub.sum(axis=1, keepdims=True) + 1e-12)
        bits = -(H @ logp.T)            # (T, G) cross-entropy bits
        new_assign = bits.argmin(axis=1)
        if np.array_equal(new_assign, group_of):
            break
        group_of = new_assign
        used, group_of = np.unique(group_of, return_inverse=True)
        rows = np.zeros((len(used), H.shape[1]), np.int64)
        np.add.at(rows, group_of, H)

    return group_of.astype(np.int32), [rows[i] for i in range(len(rows))]


def _emit_refs_grouped_native(bw, refs, codes_flat, groups_per_op, width,
                              num_groups) -> bool:
    import ctypes

    from ...entropy.native_loader import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "wtpu_vp8l_emit_grouped"):
        return False
    bits_cat, lens_cat = [], []
    offsets = np.zeros(num_groups * 5, np.int32)
    off = 0
    for i, code in enumerate(codes_flat):
        offsets[i] = off
        bits_cat.append(code.bits.astype(np.uint16))
        lens_cat.append(code.lengths.astype(np.uint8))
        off += len(code.bits)
    bits_all = np.ascontiguousarray(np.concatenate(bits_cat))
    lens_all = np.ascontiguousarray(np.concatenate(lens_cat))
    lut_arr = _build_dist_lut_array(width)
    out_p = ctypes.POINTER(ctypes.c_uint8)()
    out_n = ctypes.c_uint64(0)
    acc_out = ctypes.c_uint32(0)
    used_out = ctypes.c_int(0)
    ops = np.ascontiguousarray(refs.ops, np.uint8)
    argbs = np.ascontiguousarray(refs.argb, np.uint32)
    lens = np.ascontiguousarray(refs.lengths, np.int32)
    dists = np.ascontiguousarray(refs.dists, np.int32)
    gidx = np.ascontiguousarray(groups_per_op, np.int32)
    lib.wtpu_vp8l_emit_grouped(
        ops.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        argbs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dists.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        gidx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(ops), width,
        bits_all.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        lens_all.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), num_groups,
        lut_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(lut_arr),
        bw._acc & 0xFFFFFFFF, bw._used,
        ctypes.byref(out_p), ctypes.byref(out_n),
        ctypes.byref(acc_out), ctypes.byref(used_out),
    )
    data = ctypes.string_at(out_p, out_n.value)
    lib.wtpu_free(out_p)
    bw._buf.extend(data)
    bw._acc = int(acc_out.value)
    bw._used = int(used_out.value)
    return True


def _write_spatial_stream(bw: BitWriter, argb: np.ndarray, width: int,
                          quality: int = 75, stats=None,
                          method: int = 4, is_palette: bool = False) -> None:
    """Top-level spatially-coded image body (after transform headers)."""
    height = argb.shape[0]
    lut = _build_dist_code_lut(width)
    best = None
    if quality >= 20:
        # LZ77 variant trials (reference GetBackwardReferences,
        # backward_references_enc.c.go:427-677): the standard hash-chain
        # parse always competes against the RLE parse (distances 1 and
        # width only — wins on vertical/horizontal fills), and palette
        # streams additionally try the 2D-locality "box" parse.  Each
        # candidate is scored cache-less by total histogram entropy.
        refs = build_refs_lz77(argb, width, quality, 0)
        cand_refs = [refs] if refs is not None else []
        if quality >= 25 and refs is not None:
            cand_refs.append(build_backward_refs(argb, width))
        if is_palette and method >= 2:
            cand_refs.append(build_refs_box(argb, width))
        scored = []
        for r in cand_refs:
            h = _build_histograms(r, width, lut, 0)
            scored.append((_entropy_bits(h), r))
        refs = min(scored, key=lambda sr: sr[0])[1] if scored else None
        if refs is not None:
            # All cache sizes 0..10 scored by native single-pass
            # simulation over the winning refs (the reference's
            # CalculateBestCacheSize strategy) and the winner applied
            # by an in-place literal→cache rewrite — no re-parsing.
            cb = _pick_cache_bits(refs, argb)
            if cb is None:
                # Native scorer unavailable: fall back to two trials.
                for cand in (0, 8):
                    r2 = build_refs_lz77(argb, width, quality, cand)
                    if r2 is None:
                        continue
                    h2 = _build_histograms(r2, width, lut, cand)
                    c2 = _entropy_bits(h2)
                    if best is None or c2 < best[0]:
                        best = (c2, cand, r2, h2)
                if best is None:
                    hists = _build_histograms(refs, width, lut, 0)
                    best = (_entropy_bits(hists), 0, refs, hists)
            else:
                if cb:
                    _apply_cache_native(refs, argb, cb)
                hists = _build_histograms(refs, width, lut, cb)
                best = (_entropy_bits(hists), cb, refs, hists)
        # The cost-model DP only pays when there are real matches to
        # re-arrange; on photographic (near-all-literal) streams it
        # burns a full parse to reshuffle nothing.  Gate on the pixel
        # *coverage* of copies, not the op count: graphics rows are a
        # few whole-row copies (tiny op count, ~100% coverage) and the
        # DP is worth -15% there.
        if best is not None:
            r0 = best[2]
            covered = int(r0.lengths[r0.ops == 1].sum())
        else:
            covered = 0
        # At quality >= 90 the user opted into exhaustive search: always
        # run the DP, even on mostly-literal streams.
        if (best is not None and quality >= 25
                and (quality >= 90 or covered * 20 >= argb.size)):
            cb = best[1]
            refs = build_refs_optimal(argb, width, quality, cb,
                                      seed=best[2])
            if refs is not None:
                hists = _build_histograms(refs, width, lut, cb)
                cost = _entropy_bits(hists)
                if cost < best[0]:
                    best = (cost, cb, refs, hists)
    if best is None:
        refs = build_backward_refs(argb, width)
        best = (0.0, 0, refs, _build_histograms(refs, width, lut, 0))
    _, cache_bits, refs, hists = best

    if cache_bits:
        bw.put_bits(1, 1)
        bw.put_bits(cache_bits, 4)
    else:
        bw.put_bits(0, 1)
    if stats is not None:
        stats.cache_bits = cache_bits

    # Meta-huffman: tile histograms + stochastic clustering when the
    # image is big enough for spatial adaptivity to pay.
    use_meta = quality >= 30 and width * height >= (1 << 12)
    if use_meta:
        # Histogram tile bits scale with method and content class
        # (reference GetHistoBits, vp8l_encoder.go:167-199:
        # (palette ? 9 : 7) - method), then grow while the tile grid
        # stays too large to cluster (grid cap ~2600).
        bits = max(2, min(9, (9 if is_palette else 7) - method))
        while bits < 9 and tnp.subsample_size(width, bits) * tnp.subsample_size(
            height, bits
        ) > 2600:
            bits += 1
        tw = tnp.subsample_size(width, bits)
        th = tnp.subsample_size(height, bits)
        if tw * th <= 1:
            use_meta = False
    if use_meta:
        H, slices, tile_of_op, tw, th = _tile_histograms(
            refs, width, height, bits, cache_bits
        )
        group_map, merged = _cluster_histograms(H, slices)
        num_groups = len(merged)
        # Only take the meta path when it actually wins the header bet.
        if num_groups > 1:
            est_meta = (
                float(_entropy_of_rows(np.stack(merged), slices).sum())
                + num_groups * GROUP_HEADER_BITS
                + tw * th * 4.0
            )
            est_single = _entropy_bits(hists) + GROUP_HEADER_BITS
            if est_meta >= est_single:
                num_groups = 1
        if num_groups > 1:
            if stats is not None:
                stats.num_huffman_groups = num_groups
            bw.put_bits(1, 1)              # meta-huffman present
            bw.put_bits(bits - 2, 3)
            himg = (0xFF000000
                    | (group_map.astype(np.uint32).reshape(th, tw) << 8))
            _write_image_stream(bw, himg.astype(np.uint32), tw)
            codes_flat = []
            for row in merged:
                for a, b in slices:
                    codes_flat.append(
                        store_huffman_code(bw, build_code_lengths(row[a:b]))
                    )
            groups_per_op = group_map[tile_of_op]
            if not _emit_refs_grouped_native(
                bw, refs, codes_flat, groups_per_op, width, num_groups
            ):
                _emit_refs_grouped_python(
                    bw, refs, codes_flat, groups_per_op, width, lut
                )
            return
    bw.put_bits(0, 1)  # no meta-huffman
    codes = [store_huffman_code(bw, build_code_lengths(h)) for h in hists]
    _emit_refs(bw, refs, codes, width, lut)


def _emit_refs_grouped_python(bw, refs, codes_flat, groups_per_op, width, lut):
    for i in range(len(refs.ops)):
        g = int(groups_per_op[i])
        green = codes_flat[g * 5 + 0]
        op = refs.ops[i]
        if op == 0:
            a = int(refs.argb[i])
            green.write_symbol(bw, (a >> 8) & 0xFF)
            codes_flat[g * 5 + 1].write_symbol(bw, (a >> 16) & 0xFF)
            codes_flat[g * 5 + 2].write_symbol(bw, a & 0xFF)
            codes_flat[g * 5 + 3].write_symbol(bw, (a >> 24) & 0xFF)
        elif op == 1:
            lcode, lext, lval = prefix_encode(int(refs.lengths[i]))
            green.write_symbol(bw, NUM_LITERAL_CODES + lcode)
            if lext:
                bw.put_bits(lval, lext)
            dcode, dext, dval = prefix_encode(
                dist_to_plane_code(width, int(refs.dists[i]), lut)
            )
            codes_flat[g * 5 + 4].write_symbol(bw, dcode)
            if dext:
                bw.put_bits(dval, dext)
        else:
            green.write_symbol(
                bw, NUM_LITERAL_CODES + NUM_LENGTH_CODES + int(refs.lengths[i])
            )


def rgba_to_argb(rgba: np.ndarray) -> np.ndarray:
    rgba = rgba.astype(np.uint32)
    return ((rgba[..., 3] << 24) | (rgba[..., 0] << 16)
            | (rgba[..., 1] << 8) | rgba[..., 2])


def _palette_of(argb: np.ndarray) -> np.ndarray | None:
    uniq = np.unique(argb)
    if len(uniq) <= 256:
        return uniq.astype(np.uint32)
    return None


def _pack_palette_indices(argb: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """Map pixels → palette indices, bundled into green channel pixels."""
    h, w = argb.shape
    n = len(palette)
    order = np.argsort(palette)
    idx = order[np.searchsorted(palette, argb.reshape(-1), sorter=order)]
    idx = idx.reshape(h, w).astype(np.uint32)
    xbits = 0 if n > 16 else (1 if n > 4 else (2 if n > 2 else 3))
    if xbits == 0:
        packed = idx
    else:
        per = 1 << xbits
        bw_ = 8 >> xbits
        pw = tnp.subsample_size(w, xbits)
        padded = np.zeros((h, pw * per), np.uint32)
        padded[:, :w] = idx
        packed = np.zeros((h, pw), np.uint32)
        for k in range(per):
            packed |= padded[:, k::per] << (k * bw_)
    return (0xFF000000 | (packed << 8)).astype(np.uint32)


def encode_vp8l_stream(argb: np.ndarray, *, quality: int = 75,
                       method: int = 4,
                       use_predictor: bool | None = None,
                       bw: BitWriter | None = None, stats=None,
                       hint: int = 0,
                       device_chooser: bool | None = None) -> BitWriter:
    """Encode the image-stream portion (after the 5-byte header).

    Crunch choice (reference EncoderAnalyze/CrunchConfig,
    vp8l_encoder.go:220-320): paletted images normally take the
    color-indexing path, but mid/large palettes also try the photo path
    (subtract-green/predictor) and the smaller stream wins.  ``method``
    scales trial effort like the reference's method→crunch mapping.
    ``device_chooser`` picks where the predictor analysis runs (see
    `_choose_predictors_auto`; None decides from the input).
    """
    h, w = argb.shape
    if bw is None:
        bw = BitWriter()

    palette = _palette_of(argb)
    if palette is not None and hint == 2 and len(palette) > 64:
        # ImageHint.PHOTO: large palettes are almost never the right
        # tool for photographic content — skip the double encode
        # (reference uses the hint the same way to prune crunch
        # configs, vp8l_encoder.go EncoderAnalyze).
        palette = None
    if palette is not None:
        if len(palette) > 64 and quality >= 50:
            pal_bw = BitWriter()
            _encode_stream_palette(pal_bw, argb, palette, quality, None,
                                   method=method)
            photo_bw = BitWriter()
            _encode_stream_photo(photo_bw, argb, quality, method,
                                 use_predictor, None, hint=hint,
                                 device_chooser=device_chooser)
            if stats is None:
                bw.append_writer(pal_bw if pal_bw.bit_count
                                 <= photo_bw.bit_count else photo_bw)
            elif pal_bw.bit_count <= photo_bw.bit_count:
                _encode_stream_palette(bw, argb, palette, quality, stats,
                                       method=method)
            else:
                _encode_stream_photo(bw, argb, quality, method,
                                     use_predictor, stats, hint=hint,
                                     device_chooser=device_chooser)
        else:
            _encode_stream_palette(bw, argb, palette, quality, stats,
                                   method=method)
    else:
        _encode_stream_photo(bw, argb, quality, method, use_predictor, stats,
                             hint=hint, device_chooser=device_chooser)
    return bw


def _palette_orderings(palette: np.ndarray, argb: np.ndarray,
                       quality: int) -> list[np.ndarray]:
    """Candidate palette orders (reference palette.go's sort strategies:
    lexicographic, luminance, and a Zeng-style co-occurrence chain,
    re-done as a greedy nearest-neighbor walk in RGB space)."""
    cands = [palette]
    if quality < 40 or len(palette) <= 4:
        return cands
    a = (palette >> 24) & 0xFF
    r = (palette >> 16) & 0xFF
    g = (palette >> 8) & 0xFF
    b = palette & 0xFF
    lum = 299 * r + 587 * g + 114 * b + 1000 * a
    cands.append(palette[np.argsort(lum, kind="stable")])

    # Greedy chain: start from the most frequent color, repeatedly hop to
    # the nearest unvisited color (small index deltas between spatially
    # adjacent pixels compress better).
    vals, counts = np.unique(argb, return_counts=True)
    freq = dict(zip(vals.tolist(), counts.tolist()))
    cols = np.stack([a, r, g, b], axis=1).astype(np.int64)
    n = len(palette)
    used = np.zeros(n, bool)
    cur = int(np.argmax([freq.get(int(p), 0) for p in palette]))
    order = [cur]
    used[cur] = True
    for _ in range(n - 1):
        d = np.abs(cols - cols[order[-1]]).sum(axis=1)
        d[used] = 1 << 30
        cur = int(np.argmin(d))
        order.append(cur)
        used[cur] = True
    cands.append(palette[np.array(order)])
    return cands


def _choose_palette_order(palette: np.ndarray, argb: np.ndarray,
                          quality: int, method: int = 4) -> np.ndarray:
    cands = _palette_orderings(palette, argb, quality)
    if len(cands) == 1:
        return cands[0]
    best = None
    for cand in cands:
        packed = _pack_palette_indices(argb, cand)
        if method >= 6 and quality >= 90:
            # m6/q100 brute force (reference CrunchConfig,
            # vp8l_encoder.go:220-320): every ordering gets a FULL
            # scratch emission — the probe estimate cannot see cache /
            # meta-huffman / LZ77-variant interactions.
            sbw = BitWriter()
            _write_spatial_stream(sbw, packed, packed.shape[1], quality,
                                  method=method, is_palette=True)
            cost = float(sbw.bit_count)
        else:
            cost = _refs_cost_bits(packed, packed.shape[1], 25)
        if best is None or cost < best[0]:
            best = (cost, cand)
    return best[1]


def _encode_stream_palette(bw: BitWriter, argb: np.ndarray, palette,
                           quality: int, stats, method: int = 4) -> None:
    palette = _choose_palette_order(palette, argb, quality, method)
    bw.put_bits(1, 1)
    bw.put_bits(3, 2)              # COLOR_INDEXING_TRANSFORM
    bw.put_bits(len(palette) - 1, 8)
    # Palette stored delta-coded as a (n,1) entropy image.
    deltas = np.zeros(len(palette), np.uint32)
    prev = 0
    for i, c in enumerate(palette):
        deltas[i] = _sub_scalar(int(c), prev)
        prev = int(c)
    _write_image_stream(bw, deltas.reshape(1, -1), len(palette))
    packed = _pack_palette_indices(argb, palette)
    bw.put_bits(0, 1)  # end of transforms
    if stats is not None:
        stats.palette_size = len(palette)
        stats.transforms.append("color-indexing")
    _write_spatial_stream(bw, packed, packed.shape[1], quality, stats=stats,
                          method=method, is_palette=True)


def _crunch_params(quality: int, method: int, n_pixels: int,
                   hint: int = 0) -> dict:
    """Method/quality → trial breadth for the photo path.

    Analog of the reference's EncoderAnalyze/CrunchConfig matrix
    (vp8l_encoder.go:201-320): one cheap config at low methods, the
    full brute-force set at method 6 / q100.  ``rescore`` is how many
    top probe-ranked candidates get a full scratch emission.
    """
    if method >= 6 and quality >= 90:
        bit_cands: tuple = (3, 4, 5)
    elif method >= 5 and quality >= 50:
        bit_cands = (4, 5)
    elif method <= 2:
        # Low effort: coarse tiles (reference GetTransformBits allows
        # up to 6 below method 4) — 4x fewer tiles to score; bits=5
        # measured best on the natural corpus (0.999 vs libwebp m1).
        bit_cands = (5,)
    else:
        bit_cands = (4,)
    # Trying both subtract-green settings is the single highest-value
    # trial (measured -4.5% on 512px photo at method 4) and costs only
    # one extra probe, so it is on from method 3 up.
    sg_opts = ((True, False) if quality >= 75 and method >= 3
               else (True,))
    refine_iters = 4 if method >= 6 and quality >= 90 else 2
    if quality >= 75 and method >= 5:
        rescore = 4 if method >= 6 else 2
    else:
        rescore = 0
    if hint == 3:   # ImageHint.GRAPH: full-emission rescoring always
        rescore = max(rescore, 2)
        sg_opts = (True, False)
    return dict(bit_cands=bit_cands, sg_opts=sg_opts,
                refine_iters=refine_iters, rescore=rescore)


def _bits_entropy(h: np.ndarray) -> float:
    tot = float(h.sum())
    if tot <= 0:
        return 0.0
    p = h[h > 0].astype(np.float64) / tot
    return float(-(p * np.log2(p)).sum() * tot)


def analyze_entropy(argb: np.ndarray, row_step: int = 1) -> str:
    """One-pass entropy-mode analysis (reference AnalyzeEntropy,
    vp8l_encoder.go:56-164): score kDirect / kSpatial / kSubGreen /
    kSpatialSubGreen from per-channel histograms of the raw pixels and
    their left-neighbour deltas, all gathered in a single sweep.

    Used to pick the transform set directly at low effort (method ≤ 2)
    instead of running trial encodes.  ``row_step`` subsamples the
    scored rows — a ranking heuristic, so sampling every 2nd/4th row
    changes decisions only on near-ties (ratio-gated).
    """
    if row_step > 1:
        argb = argb[::row_step]
    flat = argb.reshape(-1).astype(np.uint32)
    prev = np.concatenate([flat[:1], flat[:-1]])
    diff = _sub_pixels_vec(flat, prev)

    def chans(v):
        return ((v >> 24) & 0xFF, (v >> 16) & 0xFF,
                (v >> 8) & 0xFF, v & 0xFF)

    def ent4(a, r, g, b):
        return sum(_bits_entropy(np.bincount(x, minlength=256))
                   for x in (a, r, g, b))

    a, r, g, b = chans(flat)
    da, dr, dg, db = chans(diff)
    direct = ent4(a, r, g, b)
    spatial = ent4(da, dr, dg, db)
    subgreen = ent4(a, (r - g) & 0xFF, g, (b - g) & 0xFF)
    sg_flat = ((flat & 0xFF00FF00)
               | (((r - g) & 0xFF) << 16) | ((b - g) & 0xFF))
    sgd = _sub_pixels_vec(sg_flat.astype(np.uint32), np.concatenate(
        [sg_flat[:1], sg_flat[:-1]]).astype(np.uint32))
    sa, sr, sgc, sb = chans(sgd)
    spatial_subgreen = ent4(sa, sr, sgc, sb)
    # Spatial modes pay for the predictor mode image; sub-green is a
    # 2-bit signal (the reference charges analogous overheads).
    n = flat.size
    overhead = max(64.0, n / 256.0)
    scores = {
        "direct": direct,
        "subgreen": subgreen + 2,
        "spatial": spatial + overhead,
        "spatial-subgreen": spatial_subgreen + overhead + 2,
    }
    return min(scores, key=scores.get)


def _encode_stream_photo(bw: BitWriter, argb: np.ndarray, quality: int,
                         method: int, use_predictor, stats,
                         hint: int = 0,
                         device_chooser: bool | None = None) -> None:
    w = argb.shape[1]
    h = argb.shape[0]

    analysis_mode = None
    if method <= 2 and use_predictor is None and quality >= 10:
        # Low effort: one-pass 13-histogram analysis picks the
        # transform set outright — no trial encodes (reference
        # EncoderAnalyze at low method).
        analysis_mode = analyze_entropy(
            argb, row_step=2 if h * w >= (1 << 17) else 1)
        use_predictor = analysis_mode in ("spatial", "spatial-subgreen")
    if use_predictor is None:
        use_predictor = quality >= 10
    if use_predictor:
        # Joint trial over {subtract-green} × {predictor candidates} ×
        # {cross-color}, scored by LZ77+histogram entropy plus the
        # actual tile-stream headers.  Predictor candidates are the
        # per-tile entropy chooser at several tile sizes PLUS forced
        # globally-uniform TOP/LEFT modes: mod-256 arithmetic makes a
        # coherent single-mode residual exactly periodic on synthetic
        # gradients — something the per-tile entropy metric (which sees
        # "few symbols" either way) cannot distinguish from clamped
        # modes whose wrap seams break long LZ77 matches.
        # Trial breadth follows the reference's method→crunch mapping.
        crunch = _crunch_params(quality, method, h * w, hint=hint)
        bit_cands = crunch["bit_cands"]
        sg_opts = crunch["sg_opts"]
        if analysis_mode is not None:
            sg_opts = ((analysis_mode == "spatial-subgreen"),)
        # NOTE an experiment that looked obvious and failed: pruning
        # the sg sweep by the one-pass left-delta entropy margin (the
        # reference's own analysis) flips sg=True on the natural photo
        # corpus where the TRIAL discovers sg=False wins through the
        # predictor+LZ77 pipeline — that sweep is exactly where the
        # ~3% size advantage over libwebp comes from.  Keep the sweep.
        iters = crunch["refine_iters"]
        use_cross = quality >= 50
        cc_bits = 5 if method <= 2 else 4
        # Low methods trade analysis precision for speed: score the
        # choosers on every 2nd row (the transforms stay exact).
        # (Extending this to m3/m4 measured ~0 wall-clock — the native
        # scorers have fixed floors — while nudging 256px images over
        # the ratio gate; keep it at <= 2.)
        speed_step = 2 if method <= 2 else 1
        # The uniform/no-predictor extras only need to run under ONE
        # subtract-green setting: the one-pass entropy analysis ranks
        # sg-vs-not reliably for those (their whole point is the LZ77
        # periodicity the analysis can't see, which sg doesn't change).
        # Halves the extra probe chains at method >= 3.
        sg_extra = True
        if len(sg_opts) > 1 and quality >= 50 and method >= 3:
            am = analysis_mode or analyze_entropy(
                argb, row_step=2 if h * w >= (1 << 17) else 1)
            sg_extra = am in ("subgreen", "spatial-subgreen")
        # The per-(sg, bits) predictor choosers are the priciest serial
        # analysis step (~100 ms each at 512px); they are independent
        # and the native chooser releases the GIL, so run them in one
        # small pool instead of back to back.
        sg_bases = {sg: (tnp.subtract_green_forward(argb) if sg else argb)
                    for sg in sg_opts}
        chooser_keys = [(sg, bits) for sg in sg_opts for bits in bit_cands]
        if len(chooser_keys) > 1:
            import concurrent.futures as _cf

            with _cf.ThreadPoolExecutor(min(4, len(chooser_keys))) as ex:
                chosen = dict(zip(chooser_keys, ex.map(
                    lambda k: _choose_predictors_auto(
                        sg_bases[k[0]], k[1], iters, row_step=speed_step,
                        device=device_chooser, stats=stats),
                    chooser_keys)))
        else:
            chosen = {k: _choose_predictors_auto(
                sg_bases[k[0]], k[1], iters, row_step=speed_step,
                device=device_chooser, stats=stats)
                for k in chooser_keys}

        jobs = []
        for sg in sg_opts:
            base = sg_bases[sg]
            cand_imgs = [(bits, chosen[(sg, bits)]) for bits in bit_cands]
            if quality >= 50 and method >= 3 and (sg == sg_extra
                                                  or len(sg_opts) == 1):
                th5 = tnp.subsample_size(h, 5)
                tw5 = tnp.subsample_size(w, 5)
                for um in (2, 1):      # uniform TOP, uniform LEFT
                    uni = np.full((th5, tw5),
                                  0xFF000000 | (um << 8), np.uint32)
                    cand_imgs.append((5, uni))
                # kDirect / kSubGreen entropy modes (reference
                # AnalyzeEntropy, vp8l_encoder.go:56-164): no predictor
                # at all.  Periodic content (tiled textures, screenshots)
                # LZ77-compresses better unfiltered — the predictor
                # residual breaks long self-matches.
                cand_imgs.append((0, None))
            jobs.extend((sg, base, bits, mode_img)
                        for bits, mode_img in cand_imgs)

        # With one job and no rescore stage, ranking probes decide
        # nothing — the single candidate ships regardless.
        fast_single = len(jobs) == 1 and crunch["rescore"] <= 1
        # Measured dead end kept for the record: deferring the
        # per-trial cross-color descent (fit once on the winner)
        # saves only ~3% wall — the native scorer has a ~13 ms floor
        # independent of row subsampling — while costing 0.6% size,
        # because cc and subtract-green decorrelate the same r/g/b
        # redundancy and a cc-blind ranking mis-ranks the sg sweep.

        def _trial(job):
            sg, base, bits, mode_img = job
            if mode_img is None:       # direct / subtract-green-only
                res = base
                phdr = 0
            else:
                res = _apply_predictor_transform(base, bits, mode_img)
                scratch = BitWriter()
                _write_image_stream(scratch, mode_img, mode_img.shape[1])
                phdr = scratch.bit_count + 6   # + transform signal bits
            cc_img, cc_gain = (
                _choose_cross_color_scored(res, cc_bits,
                                           row_step=speed_step)
                if use_cross else (None, 0.0))
            chdr = 0
            if cc_img is not None:
                s2 = BitWriter()
                _write_image_stream(s2, cc_img, cc_img.shape[1])
                chdr = s2.bit_count + 6
                # Decisive entropy-gain bands skip the cc-vs-none probe
                # pair; only the ambiguous middle still pays for it.
                if cc_gain <= chdr:
                    cc_img = None
                    chdr = 0
                elif not (fast_single or cc_gain >= 4 * chdr):
                    cc_res = tnp.color_transform_forward(
                        res, cc_img, cc_bits)
                    out = []
                    for cimg, cres, ch in ((None, res, 0),
                                           (cc_img, cc_res, chdr)):
                        cost = (_refs_cost_bits(_probe_rows(cres), w, 25)
                                + phdr + ch)
                        out.append((cost, sg, bits, mode_img, cimg, cres,
                                    phdr + ch))
                    return out
            cres = (tnp.color_transform_forward(res, cc_img, cc_bits)
                    if cc_img is not None else res)
            cost = 0.0 if fast_single else (
                _refs_cost_bits(_probe_rows(cres), w, 25) + phdr + chdr)
            return [(cost, sg, bits, mode_img, cc_img, cres, phdr + chdr)]

        # The heavy probe work is native (GIL released); run trials
        # concurrently — the codec analog of the reference's side-worker
        # crunch-config split (vp8l_encoder.go:1492).
        if len(jobs) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=min(len(jobs), 6)) as ex:
                results = list(ex.map(_trial, jobs))
        else:
            results = [_trial(job) for job in jobs]
        entries = [e for out in results for e in out]
        entries.sort(key=lambda e: e[0])
        emitted = None
        if crunch["rescore"] > 1 and len(entries) > 1:
            # The LZ77+single-histogram estimate ignores color-cache and
            # meta-huffman effects; rescore the closest candidates with
            # a full scratch emission of the spatial stream (kept and
            # spliced below so the winner is not re-encoded).
            pool = list(entries[: crunch["rescore"]])
            # The single-histogram probe systematically over-ranks
            # predictor residuals on self-similar content (it cannot
            # see the long LZ77 matches the predictor destroys), so the
            # best no-predictor candidate always gets a rescore slot.
            direct = [e for e in entries if e[3] is None]
            n_direct = len(direct) if h * w < (1 << 18) else 2
            ids = {id(e) for e in pool}
            pool.extend(e for e in direct[:n_direct]
                        if id(e) not in ids)
            rescored = []
            for e in pool:
                sbw = BitWriter()
                _write_spatial_stream(sbw, e[5], w, quality, method=method)
                rescored.append((sbw.bit_count + e[6], sbw, e))
            rescored.sort(key=lambda t: t[0])
            best = rescored[0][2]
            if stats is None:
                emitted = rescored[0][1]
        else:
            best = entries[0]
        _, use_sg, bits, mode_img, cc_img, work = best[:6]
        if use_sg:
            bw.put_bits(1, 1)
            bw.put_bits(2, 2)          # SUBTRACT_GREEN
        if mode_img is not None:
            bw.put_bits(1, 1)
            bw.put_bits(0, 2)          # PREDICTOR_TRANSFORM
            bw.put_bits(bits - 2, 3)
            _write_image_stream(bw, mode_img, mode_img.shape[1])
        else:
            use_predictor = False      # kDirect/kSubGreen won the trial
        if cc_img is not None:
            bw.put_bits(1, 1)
            bw.put_bits(1, 2)          # COLOR_TRANSFORM
            bw.put_bits(cc_bits - 2, 3)
            _write_image_stream(bw, cc_img, cc_img.shape[1])
            if stats is not None:
                stats.transforms.append("cross-color")
    elif quality >= 50 and analysis_mode != "direct":
        # No predictor: subtract-green (unless the one-pass analysis
        # picked kDirect), then gated cross-color.
        use_sg = True
        work = tnp.subtract_green_forward(argb)
        bw.put_bits(1, 1)
        bw.put_bits(2, 2)              # SUBTRACT_GREEN
        cc_bits = 4
        cc_img, cc_gain = _choose_cross_color_scored(
            work, cc_bits, row_step=2 if method <= 2 else 1)
        if cc_img is not None:
            scratch = BitWriter()
            _write_image_stream(scratch, cc_img, cc_img.shape[1])
            # header-vs-entropy-savings test (the descent's own gain
            # replaces the old double LZ77 probe)
            if cc_gain > scratch.bit_count + 6:
                bw.put_bits(1, 1)
                bw.put_bits(1, 2)      # COLOR_TRANSFORM
                bw.put_bits(cc_bits - 2, 3)
                _write_image_stream(bw, cc_img, cc_img.shape[1])
                work = tnp.color_transform_forward(work, cc_img, cc_bits)
                if stats is not None:
                    stats.transforms.append("cross-color")
    else:
        use_sg = True
        work = tnp.subtract_green_forward(argb)
        bw.put_bits(1, 1)
        bw.put_bits(2, 2)              # SUBTRACT_GREEN

    bw.put_bits(0, 1)  # end of transforms
    if stats is not None:
        if use_sg:
            stats.transforms.append("subtract-green")
        if use_predictor:
            stats.transforms.append("predictor")
    if use_predictor and emitted is not None:
        bw.append_writer(emitted)
    else:
        _write_spatial_stream(bw, work, w, quality, stats=stats,
                              method=method)


def _sub_scalar(pixel: int, pred: int) -> int:
    out = 0
    for shift in (24, 16, 8, 0):
        out |= (((pixel >> shift) - (pred >> shift)) & 0xFF) << shift
    return out


def encode_vp8l(rgba: np.ndarray, *, quality: int = 75, method: int = 4,
                stats=None, hint: int = 0,
                device_chooser: bool | None = None) -> bytes:
    """(H, W, 4) uint8 RGBA → VP8L chunk payload.

    ``device_chooser`` picks where the predictor analysis runs: None
    decides from the input (an accelerator backend and ≥1 MP), True and
    False force the device or the host."""
    if rgba.ndim != 3 or rgba.shape[2] not in (3, 4):
        raise EncodeError("expected (H, W, 3|4) array")
    if rgba.shape[2] == 3:
        rgba = np.concatenate(
            [rgba, np.full(rgba.shape[:2] + (1,), 255, np.uint8)], axis=-1
        )
    h, w = rgba.shape[:2]
    if not (1 <= w <= 1 << 14 and 1 <= h <= 1 << 14):
        raise EncodeError("dimensions out of range")
    argb = rgba_to_argb(rgba)
    has_alpha = bool((rgba[..., 3] != 255).any())

    bw = BitWriter()
    bw.put_bits(VP8L_SIGNATURE, 8)
    bw.put_bits(w - 1, 14)
    bw.put_bits(h - 1, 14)
    bw.put_bits(1 if has_alpha else 0, 1)
    bw.put_bits(0, 3)  # version
    encode_vp8l_stream(argb, quality=quality, method=method, bw=bw,
                       stats=stats, hint=hint, device_chooser=device_chooser)
    return bw.getvalue()


def encode_vp8l_alpha(plane: np.ndarray) -> bytes:
    """8-bit plane → headerless VP8L stream (values in green channel)."""
    argb = (0xFF000000 | (plane.astype(np.uint32) << 8)).astype(np.uint32)
    bw = BitWriter()
    bw.put_bits(0, 1)  # no transforms
    _write_spatial_stream(bw, argb, argb.shape[1], 75)
    return bw.getvalue()


__all__ = [
    "encode_vp8l",
    "encode_vp8l_stream",
    "encode_vp8l_alpha",
    "prefix_encode",
    "build_backward_refs",
    "store_huffman_code",
]
