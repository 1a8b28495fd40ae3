// VP8 lossy decode — native host layer (symbols + reconstruction + filter).
//
// Python parses the frame headers (cold path) and hands over the
// boolean-decoder state plus finalized probability/quant tables; this
// file runs the per-MB hot loops: intra-mode parsing, coefficient token
// decode, intra prediction + iDCT reconstruction, and the in-loop
// deblocking filter — producing the padded Y/U/V planes.
//
// Written from RFC 6386; the Python reference (models/vp8/decoder.py,
// bit-exact vs libwebp) is the correctness oracle.

#if defined(__SSE2__)
#include <immintrin.h>
#endif
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "vp8_tables.h"

namespace {

// ----------------------------------------------------------------------
// Boolean decoder (RFC 6386 convention, 8-bit window).
// ----------------------------------------------------------------------
struct BoolDec {
  const uint8_t* data;
  uint64_t size;
  uint64_t pos;
  uint32_t value;
  uint32_t range;
  int bit_count;

  void init(const uint8_t* d, uint64_t n) {
    data = d; size = n; pos = 0; value = 0; range = 255; bit_count = 0;
    value = (uint32_t)next_byte() << 8;
    value |= next_byte();
  }
  inline uint32_t next_byte() {
    uint32_t b = pos < size ? data[pos] : 0;
    pos++;
    return b;
  }
  inline int get(int prob) {
    uint32_t split = 1 + (((range - 1) * (uint32_t)prob) >> 8);
    uint32_t big = split << 8;
    int ret;
    if (value >= big) {
      ret = 1;
      range -= split;
      value -= big;
    } else {
      ret = 0;
      range = split;
    }
    while (range < 128) {
      value <<= 1;
      range <<= 1;
      if (++bit_count == 8) {
        bit_count = 0;
        value |= next_byte();
      }
    }
    return ret;
  }
  inline int flag() { return get(128); }
  inline int signed_value(int v) { return get(128) ? -v : v; }
  inline bool exhausted() const { return pos > size + 4; }
};

// ----------------------------------------------------------------------
// Fast boolean decoder: 56-bit prefetch, branchless CLZ renormalization
// (libwebp's classic representation: range stored as range-1; the RFC
// arithmetic maps 1:1 — split_stored = split_rfc - 1).
// Used for the token partitions (initialized fresh from raw bytes).
// ----------------------------------------------------------------------
struct FastBoolDec {
  const uint8_t* buf;
  const uint8_t* buf_end;
  uint64_t value;
  uint32_t range;   // stored as real_range - 1, in [126, 253]
  int bits;         // current bit position; < 0 means "needs load"
  int eof;
  int virtual_bytes;

  void init(const uint8_t* d, uint64_t n) {
    buf = d;
    buf_end = d + n;
    value = 0;
    range = 254;
    bits = -8;
    eof = 0;
    virtual_bytes = 0;
  }
  inline void load() {
    if (buf + 8 <= buf_end) {
      uint64_t in;
      std::memcpy(&in, buf, 8);
      buf += 7;
      value = (__builtin_bswap64(in) >> 8) | (value << 56);
      bits += 56;
    } else {
      // Final bytes, one at a time; then virtual zeros.
      while (bits < 0) {
        if (buf < buf_end) {
          value = (value << 8) | *buf++;
        } else {
          value <<= 8;
          if (++virtual_bytes > 4) eof = 1;
        }
        bits += 8;
      }
    }
  }
  inline int get(int prob) {
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (range * (uint32_t)prob) >> 8;
    const uint32_t v = (uint32_t)(value >> pos) & 0xff;
    // Branchless select: the (v > split) outcome is data-random, so a
    // conditional branch here mispredicts ~50% of the time and costs
    // ~15-20 cycles per token.  cmov/setcc + multiply-by-bit keep the
    // pipeline full (measured ~1.6x on the symbol phase).
    const int bit = v > split;
    const uint32_t r_sel = bit ? range - split : split + 1;
    value -= (uint64_t)(bit ? split + 1 : 0) << pos;
    const int shift = 7 ^ (31 - __builtin_clz(r_sel));
    bits -= shift;
    range = (r_sel << shift) - 1;
    return bit;
  }
  inline int signed_value(int v) { return get(128) ? -v : v; }
  inline bool exhausted() const { return eof; }
};

// ----------------------------------------------------------------------
// Frame state
// ----------------------------------------------------------------------
struct MB {
  uint8_t segment;
  uint8_t skip;       // skip flag from stream; updated to "empty" result
  uint8_t is_i4;
  uint8_t ymode;
  uint8_t uvmode;
  uint8_t dither;     // 1 = flat chroma (no uv AC), eligible for dithering
  uint8_t imodes[16];
  uint8_t has_nz[24];         // per 4x4 block: any dequantized coeff != 0
  int16_t coeffs[25][16];     // dequantized, raster order within block
};

// ----------------------------------------------------------------------
// Chroma dithering (reference decoder/frame_dec.c.go VP8InitDithering/
// DitherRow + pkg/vp8/random.go VP8Random — Knuth's subtractive lagged
// Fibonacci generator; table is libwebp's published constant set,
// required for bit-exact output parity).
// ----------------------------------------------------------------------
static const uint32_t kRandomTable[55] = {
    0x0de15230, 0x03b31886, 0x775faccb, 0x1c88626a, 0x68385c55, 0x14b3b828,
    0x4a85fef8, 0x49ddb84b, 0x64fcf397, 0x5c550289, 0x4a290000, 0x0d7ec1da,
    0x5940b7ab, 0x5492577d, 0x4e19ca72, 0x38d38c69, 0x0c01ee65, 0x32a1755f,
    0x5437f652, 0x5abb2c32, 0x0faa57b1, 0x73f533e7, 0x685feeda, 0x7563cce2,
    0x6e990e83, 0x4730a7ed, 0x4fc0d9c6, 0x496b153c, 0x4f1403fa, 0x541afb0c,
    0x73990b32, 0x26d7cb1c, 0x6fcc3706, 0x2cbb77d8, 0x75762f2a, 0x6425ccdd,
    0x24b35461, 0x0a7d8715, 0x220414a8, 0x141ebf67, 0x56b41583, 0x73e502e3,
    0x44cab16f, 0x28264d42, 0x73baaefb, 0x0a50ebed, 0x1d6ab6fb, 0x0d3ad40b,
    0x35db3b68, 0x2b081e83, 0x77ce6b95, 0x5181e5f0, 0x78853bbc, 0x009f9494,
    0x27e5ed3c};

struct VP8Random {
  uint32_t tab[55];
  int i1 = 0, i2 = 31;
  VP8Random() { std::memcpy(tab, kRandomTable, sizeof(tab)); }
  // Centered pseudo-random with num_bits amplitude, amp in 8-bit fixpoint.
  int bits2(int num_bits, int amp) {
    int32_t diff = (int32_t)tab[i1] - (int32_t)tab[i2];
    if (diff < 0) diff += (int32_t)1 << 31;
    tab[i1] = (uint32_t)diff;
    if (++i1 == 55) i1 = 0;
    if (++i2 == 55) i2 = 0;
    diff = (int32_t)((uint32_t)diff << 1) >> (32 - num_bits);
    diff = (diff * amp) >> 8;     // restrict range
    diff += 1 << (num_bits - 1);  // shift back to 0.5-center
    return diff;
  }
};

// 8x8 dither of one chroma block: draw 64 values, combine with
// descale 4 (reference dsp/dec.c.go DitherCombine8x8_C).
static void dither8x8(VP8Random& rg, uint8_t* dst, int stride, int amp) {
  uint8_t dither[64];
  for (int i = 0; i < 64; i++) dither[i] = (uint8_t)rg.bits2(8, amp);
  for (int j = 0; j < 8; j++) {
    for (int i = 0; i < 8; i++) {
      const int delta0 = dither[8 * j + i] - 128;
      const int delta1 = (delta0 + 8) >> 4;
      const int v = dst[(std::ptrdiff_t)j * stride + i] + delta1;
      dst[(std::ptrdiff_t)j * stride + i] =
          (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

struct Ctx {
  uint32_t nz = 0;
  uint32_t nz_dc = 0;
};

inline int clip255i(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

// ----------------------------------------------------------------------
// Coefficient decode
// ----------------------------------------------------------------------
template <typename BD>
static int get_large_value(BD& bd, const uint8_t* p) {
  int v;
  if (!bd.get(p[3])) {
    if (!bd.get(p[4])) v = 2;
    else v = 3 + bd.get(p[5]);
  } else if (!bd.get(p[6])) {
    if (!bd.get(p[7])) v = 5 + bd.get(159);
    else { v = 7 + 2 * bd.get(165); v += bd.get(145); }
  } else {
    int bit1 = bd.get(p[8]);
    int bit0 = bd.get(p[9 + bit1]);
    int cat = 2 * bit1 + bit0;
    v = 0;
    const uint8_t* tab = kCatProbas[cat];
    for (int i = 0; i < kCatBits[cat]; i++) v += v + bd.get(tab[i]);
    v += 3 + (8 << cat);
  }
  return v;
}

// probs_t: [8][3][11] for this block type; dq = {dc, ac}.
template <typename BD>
static int get_coeffs(BD& bd, const uint8_t* probs_t, int ctx,
                      int dq_dc, int dq_ac, int first, int16_t* out) {
  const uint8_t* p = probs_t + (kBands[first] * 3 + ctx) * 11;
  int n = first;
  while (n < 16) {
    if (!bd.get(p[0])) return n;
    while (!bd.get(p[1])) {
      n++;
      if (n == 16) return 16;
      p = probs_t + (kBands[n] * 3 + 0) * 11;
    }
    int v, next_ctx;
    if (!bd.get(p[2])) { v = 1; next_ctx = 1; }
    else { v = get_large_value(bd, p); next_ctx = 2; }
    out[kZigzag[n]] = (int16_t)(bd.signed_value(v) * (n > 0 ? dq_ac : dq_dc));
    p = probs_t + (kBands[n + 1] * 3 + next_ctx) * 11;
    n++;
  }
  return 16;
}

static void iwht4x4(const int16_t* in, int32_t* out) {
  int32_t tmp[16];
  for (int i = 0; i < 4; i++) {
    int32_t a0 = in[0 + i] + in[12 + i];
    int32_t a1 = in[4 + i] + in[8 + i];
    int32_t a2 = in[4 + i] - in[8 + i];
    int32_t a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[4 + i] = a3 + a2;
    tmp[8 + i] = a0 - a1;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; i++) {
    int32_t dc = tmp[0 + i * 4] + 3;
    int32_t a0 = dc + tmp[3 + i * 4];
    int32_t a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    int32_t a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    int32_t a3 = dc - tmp[3 + i * 4];
    out[i * 4 + 0] = (a0 + a1) >> 3;
    out[i * 4 + 1] = (a3 + a2) >> 3;
    out[i * 4 + 2] = (a0 - a1) >> 3;
    out[i * 4 + 3] = (a3 - a2) >> 3;
  }
}

// ----------------------------------------------------------------------
// iDCT (adds into dst with stride)
// ----------------------------------------------------------------------
static inline int mul1(int a) { return a + ((a * 20091) >> 16); }
static inline int mul2(int a) { return (a * 35468) >> 16; }

#ifdef __SSE4_1__
// 4 int32 lanes carry one column (pass 1) / one row (pass 2) each;
// bit-identical to the scalar butterflies below (same >>16 fixed-point
// products, same +4 >>3 rounding, saturating pack for the clip).
static inline __m128i mul1_v(__m128i a) {
  return _mm_add_epi32(a,
      _mm_srai_epi32(_mm_mullo_epi32(a, _mm_set1_epi32(20091)), 16));
}
static inline __m128i mul2_v(__m128i a) {
  return _mm_srai_epi32(_mm_mullo_epi32(a, _mm_set1_epi32(35468)), 16);
}

static void idct_add(const int16_t* in, uint8_t* dst, int stride) {
  // Rows of `in` are the four frequency lines; lanes are columns i.
  __m128i r0 = _mm_cvtepi16_epi32(_mm_loadl_epi64((const __m128i*)(in + 0)));
  __m128i r1 = _mm_cvtepi16_epi32(_mm_loadl_epi64((const __m128i*)(in + 4)));
  __m128i r2 = _mm_cvtepi16_epi32(_mm_loadl_epi64((const __m128i*)(in + 8)));
  __m128i r3 = _mm_cvtepi16_epi32(_mm_loadl_epi64((const __m128i*)(in + 12)));
  __m128i a = _mm_add_epi32(r0, r2);
  __m128i b = _mm_sub_epi32(r0, r2);
  __m128i c = _mm_sub_epi32(mul2_v(r1), mul1_v(r3));
  __m128i d = _mm_add_epi32(mul1_v(r1), mul2_v(r3));
  __m128i C0 = _mm_add_epi32(a, d);            // C[0*4+i]
  __m128i C1 = _mm_add_epi32(b, c);
  __m128i C2 = _mm_sub_epi32(b, c);
  __m128i C3 = _mm_sub_epi32(a, d);
  // Transpose so lanes become rows: Vk[r] = C[r*4+k].
  __m128i t0 = _mm_unpacklo_epi32(C0, C1), t1 = _mm_unpackhi_epi32(C0, C1);
  __m128i t2 = _mm_unpacklo_epi32(C2, C3), t3 = _mm_unpackhi_epi32(C2, C3);
  __m128i V0 = _mm_unpacklo_epi64(t0, t2);
  __m128i V1 = _mm_unpackhi_epi64(t0, t2);
  __m128i V2 = _mm_unpacklo_epi64(t1, t3);
  __m128i V3 = _mm_unpackhi_epi64(t1, t3);
  __m128i dc = _mm_add_epi32(V0, _mm_set1_epi32(4));
  a = _mm_add_epi32(dc, V2);
  b = _mm_sub_epi32(dc, V2);
  c = _mm_sub_epi32(mul2_v(V1), mul1_v(V3));
  d = _mm_add_epi32(mul1_v(V1), mul2_v(V3));
  __m128i o0 = _mm_srai_epi32(_mm_add_epi32(a, d), 3);   // col 0, rows 0..3
  __m128i o1 = _mm_srai_epi32(_mm_add_epi32(b, c), 3);
  __m128i o2 = _mm_srai_epi32(_mm_sub_epi32(b, c), 3);
  __m128i o3 = _mm_srai_epi32(_mm_sub_epi32(a, d), 3);
  // Transpose back: lanes become columns within each output row.
  t0 = _mm_unpacklo_epi32(o0, o1); t1 = _mm_unpackhi_epi32(o0, o1);
  t2 = _mm_unpacklo_epi32(o2, o3); t3 = _mm_unpackhi_epi32(o2, o3);
  __m128i row0 = _mm_unpacklo_epi64(t0, t2);
  __m128i row1 = _mm_unpackhi_epi64(t0, t2);
  __m128i row2 = _mm_unpacklo_epi64(t1, t3);
  __m128i row3 = _mm_unpackhi_epi64(t1, t3);
  const __m128i rows[4] = {row0, row1, row2, row3};
  for (int r = 0; r < 4; r++) {
    uint8_t* o = dst + r * stride;
    int32_t w;
    std::memcpy(&w, o, 4);
    __m128i px = _mm_cvtepu8_epi32(_mm_cvtsi32_si128(w));
    __m128i s = _mm_add_epi32(px, rows[r]);
    __m128i p16 = _mm_packs_epi32(s, s);
    __m128i p8 = _mm_packus_epi16(p16, p16);
    w = _mm_cvtsi128_si32(p8);
    std::memcpy(o, &w, 4);
  }
}
#else
static void idct_add(const int16_t* in, uint8_t* dst, int stride) {
  int32_t C[16];
  for (int i = 0; i < 4; i++) {
    int32_t a = in[i] + in[8 + i];
    int32_t b = in[i] - in[8 + i];
    int32_t c = mul2(in[4 + i]) - mul1(in[12 + i]);
    int32_t d = mul1(in[4 + i]) + mul2(in[12 + i]);
    C[0 * 4 + i] = a + d;
    C[1 * 4 + i] = b + c;
    C[2 * 4 + i] = b - c;
    C[3 * 4 + i] = a - d;
  }
  for (int r = 0; r < 4; r++) {
    int32_t dc = C[r * 4 + 0] + 4;
    int32_t a = dc + C[r * 4 + 2];
    int32_t b = dc - C[r * 4 + 2];
    int32_t c = mul2(C[r * 4 + 1]) - mul1(C[r * 4 + 3]);
    int32_t d = mul1(C[r * 4 + 1]) + mul2(C[r * 4 + 3]);
    uint8_t* o = dst + r * stride;
    o[0] = (uint8_t)clip255i(o[0] + ((a + d) >> 3));
    o[1] = (uint8_t)clip255i(o[1] + ((b + c) >> 3));
    o[2] = (uint8_t)clip255i(o[2] + ((b - c) >> 3));
    o[3] = (uint8_t)clip255i(o[3] + ((a - d) >> 3));
  }
}
#endif  // __SSE4_1__

// ----------------------------------------------------------------------
// Intra predictors on a bordered working buffer.
// buf stride BUFS; (0,0) = top-left corner; data block at (1,1).
// ----------------------------------------------------------------------
constexpr int BUFS = 24;

static inline uint8_t* at(uint8_t* buf, int r, int c) { return buf + r * BUFS + c; }

static void pred_dc(uint8_t* buf, int x, int y, int size, bool ht, bool hl) {
  int v;
  if (ht && hl) {
    int s = 0;
    for (int i = 0; i < size; i++) s += buf[y * BUFS + x + 1 + i] + buf[(y + 1 + i) * BUFS + x];
    v = (s + size) >> (size == 16 ? 5 : 4);
  } else if (hl) {
    int s = 0;
    for (int i = 0; i < size; i++) s += buf[(y + 1 + i) * BUFS + x];
    v = (s + size / 2) >> (size == 16 ? 4 : 3);
  } else if (ht) {
    int s = 0;
    for (int i = 0; i < size; i++) s += buf[y * BUFS + x + 1 + i];
    v = (s + size / 2) >> (size == 16 ? 4 : 3);
  } else {
    v = 0x80;
  }
  for (int r = 0; r < size; r++)
    std::memset(buf + (y + 1 + r) * BUFS + x + 1, v, size);
}

static void pred_tm(uint8_t* buf, int x, int y, int size) {
  int tl = buf[y * BUFS + x];
  for (int r = 0; r < size; r++) {
    int l = buf[(y + 1 + r) * BUFS + x];
    uint8_t* o = buf + (y + 1 + r) * BUFS + x + 1;
    const uint8_t* t = buf + y * BUFS + x + 1;
    for (int c = 0; c < size; c++) o[c] = (uint8_t)clip255i(l + t[c] - tl);
  }
}

static void pred_ve(uint8_t* buf, int x, int y, int size) {
  for (int r = 0; r < size; r++)
    std::memcpy(buf + (y + 1 + r) * BUFS + x + 1, buf + y * BUFS + x + 1, size);
}

static void pred_he(uint8_t* buf, int x, int y, int size) {
  for (int r = 0; r < size; r++)
    std::memset(buf + (y + 1 + r) * BUFS + x + 1,
                buf[(y + 1 + r) * BUFS + x], size);
}

static void predict_block(uint8_t* buf, int x, int y, int size, int mode,
                          bool ht, bool hl) {
  switch (mode) {
    case 0: pred_dc(buf, x, y, size, ht, hl); break;
    case 1: pred_tm(buf, x, y, size); break;
    case 2: pred_ve(buf, x, y, size); break;
    case 3: pred_he(buf, x, y, size); break;
  }
}

#define AVG3(a, b, c) (((a) + 2 * (b) + (c) + 2) >> 2)
#define AVG2(a, b) (((a) + (b) + 1) >> 1)

static void predict_luma4(uint8_t* buf, int x, int y, int mode) {
  // Context: top at row y, cols x+1..x+8 (incl. TR), left col x, TL at (y,x).
  const int A = buf[y * BUFS + x + 1], B = buf[y * BUFS + x + 2],
            C = buf[y * BUFS + x + 3], D = buf[y * BUFS + x + 4];
  const int E = buf[y * BUFS + x + 5], F = buf[y * BUFS + x + 6],
            G = buf[y * BUFS + x + 7], H = buf[y * BUFS + x + 8];
  const int I = buf[(y + 1) * BUFS + x], J = buf[(y + 2) * BUFS + x],
            K = buf[(y + 3) * BUFS + x], L = buf[(y + 4) * BUFS + x];
  const int X = buf[y * BUFS + x];
  uint8_t o[4][4];
  switch (mode) {
    case 0: {  // DC4
      int v = (A + B + C + D + I + J + K + L + 4) >> 3;
      std::memset(o, v, 16);
      break;
    }
    case 1: {  // TM4
      for (int r = 0; r < 4; r++) {
        int l = buf[(y + 1 + r) * BUFS + x];
        for (int c = 0; c < 4; c++)
          o[r][c] = (uint8_t)clip255i(l + buf[y * BUFS + x + 1 + c] - X);
      }
      break;
    }
    case 2: {  // VE4
      uint8_t v[4] = {(uint8_t)AVG3(X, A, B), (uint8_t)AVG3(A, B, C),
                      (uint8_t)AVG3(B, C, D), (uint8_t)AVG3(C, D, E)};
      for (int r = 0; r < 4; r++) std::memcpy(o[r], v, 4);
      break;
    }
    case 3: {  // HE4
      uint8_t v[4] = {(uint8_t)AVG3(X, I, J), (uint8_t)AVG3(I, J, K),
                      (uint8_t)AVG3(J, K, L), (uint8_t)AVG3(K, L, L)};
      for (int r = 0; r < 4; r++) std::memset(o[r], v[r], 4);
      break;
    }
    case 4: {  // RD4
      o[3][0] = (uint8_t)AVG3(J, K, L);
      o[2][0] = o[3][1] = (uint8_t)AVG3(I, J, K);
      o[1][0] = o[2][1] = o[3][2] = (uint8_t)AVG3(X, I, J);
      o[0][0] = o[1][1] = o[2][2] = o[3][3] = (uint8_t)AVG3(A, X, I);
      o[0][1] = o[1][2] = o[2][3] = (uint8_t)AVG3(B, A, X);
      o[0][2] = o[1][3] = (uint8_t)AVG3(C, B, A);
      o[0][3] = (uint8_t)AVG3(D, C, B);
      break;
    }
    case 5: {  // VR4
      o[0][0] = o[2][1] = (uint8_t)AVG2(X, A);
      o[0][1] = o[2][2] = (uint8_t)AVG2(A, B);
      o[0][2] = o[2][3] = (uint8_t)AVG2(B, C);
      o[0][3] = (uint8_t)AVG2(C, D);
      o[3][0] = (uint8_t)AVG3(K, J, I);
      o[2][0] = (uint8_t)AVG3(J, I, X);
      o[1][0] = o[3][1] = (uint8_t)AVG3(I, X, A);
      o[1][1] = o[3][2] = (uint8_t)AVG3(X, A, B);
      o[1][2] = o[3][3] = (uint8_t)AVG3(A, B, C);
      o[1][3] = (uint8_t)AVG3(B, C, D);
      break;
    }
    case 6: {  // LD4
      o[0][0] = (uint8_t)AVG3(A, B, C);
      o[0][1] = o[1][0] = (uint8_t)AVG3(B, C, D);
      o[0][2] = o[1][1] = o[2][0] = (uint8_t)AVG3(C, D, E);
      o[0][3] = o[1][2] = o[2][1] = o[3][0] = (uint8_t)AVG3(D, E, F);
      o[1][3] = o[2][2] = o[3][1] = (uint8_t)AVG3(E, F, G);
      o[2][3] = o[3][2] = (uint8_t)AVG3(F, G, H);
      o[3][3] = (uint8_t)AVG3(G, H, H);
      break;
    }
    case 7: {  // VL4
      o[0][0] = (uint8_t)AVG2(A, B);
      o[0][1] = o[2][0] = (uint8_t)AVG2(B, C);
      o[0][2] = o[2][1] = (uint8_t)AVG2(C, D);
      o[0][3] = o[2][2] = (uint8_t)AVG2(D, E);
      o[1][0] = (uint8_t)AVG3(A, B, C);
      o[1][1] = o[3][0] = (uint8_t)AVG3(B, C, D);
      o[1][2] = o[3][1] = (uint8_t)AVG3(C, D, E);
      o[1][3] = o[3][2] = (uint8_t)AVG3(D, E, F);
      o[2][3] = (uint8_t)AVG3(E, F, G);
      o[3][3] = (uint8_t)AVG3(F, G, H);
      break;
    }
    case 8: {  // HD4
      o[0][0] = o[1][2] = (uint8_t)AVG2(I, X);
      o[1][0] = o[2][2] = (uint8_t)AVG2(J, I);
      o[2][0] = o[3][2] = (uint8_t)AVG2(K, J);
      o[3][0] = (uint8_t)AVG2(L, K);
      o[0][3] = (uint8_t)AVG3(A, B, C);
      o[0][2] = (uint8_t)AVG3(X, A, B);
      o[0][1] = o[1][3] = (uint8_t)AVG3(I, X, A);
      o[1][1] = o[2][3] = (uint8_t)AVG3(X, I, J);
      o[2][1] = o[3][3] = (uint8_t)AVG3(I, J, K);
      o[3][1] = (uint8_t)AVG3(J, K, L);
      break;
    }
    case 9: {  // HU4
      o[0][0] = (uint8_t)AVG2(I, J);
      o[0][2] = o[1][0] = (uint8_t)AVG2(J, K);
      o[1][2] = o[2][0] = (uint8_t)AVG2(K, L);
      o[0][1] = (uint8_t)AVG3(I, J, K);
      o[0][3] = o[1][1] = (uint8_t)AVG3(J, K, L);
      o[1][3] = o[2][1] = (uint8_t)AVG3(K, L, L);
      o[2][2] = o[2][3] = o[3][0] = o[3][1] = o[3][2] = o[3][3] = (uint8_t)L;
      break;
    }
  }
  for (int r = 0; r < 4; r++)
    std::memcpy(buf + (y + 1 + r) * BUFS + x + 1, o[r], 4);
}

// ----------------------------------------------------------------------
// Loop filter
// ----------------------------------------------------------------------
static inline int sclip1(int v) { return v < -128 ? -128 : (v > 127 ? 127 : v); }
static inline int sclip2(int v) { return v < -16 ? -16 : (v > 15 ? 15 : v); }
static inline int iabs(int v) { return v < 0 ? -v : v; }

static inline bool needs_filter(const uint8_t* p, int step, int thresh2) {
  int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * iabs(p0 - q0) + iabs(p1 - q1) <= thresh2;
}
static inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * iabs(p0 - q0) + iabs(p1 - q1) > t) return false;
  return iabs(p3 - p2) <= it && iabs(p2 - p1) <= it && iabs(p1 - p0) <= it &&
         iabs(q3 - q2) <= it && iabs(q2 - q1) <= it && iabs(q1 - q0) <= it;
}
static inline bool hev(const uint8_t* p, int step, int thresh) {
  return iabs(p[-2 * step] - p[-step]) > thresh || iabs(p[step] - p[0]) > thresh;
}
static inline void do_filter2(uint8_t* p, int step) {
  int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  int a1 = sclip2((a + 4) >> 3);
  int a2 = sclip2((a + 3) >> 3);
  p[-step] = (uint8_t)clip255i(p0 + a2);
  p[0] = (uint8_t)clip255i(q0 - a1);
}
static inline void do_filter4(uint8_t* p, int step) {
  int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  int a = 3 * (q0 - p0);
  int a1 = sclip2((a + 4) >> 3);
  int a2 = sclip2((a + 3) >> 3);
  int a3 = (a1 + 1) >> 1;
  p[-2 * step] = (uint8_t)clip255i(p1 + a3);
  p[-step] = (uint8_t)clip255i(p0 + a2);
  p[0] = (uint8_t)clip255i(q0 - a1);
  p[step] = (uint8_t)clip255i(q1 - a3);
}
static inline void do_filter6(uint8_t* p, int step) {
  int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  int a1 = (27 * a + 63) >> 7;
  int a2 = (18 * a + 63) >> 7;
  int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = (uint8_t)clip255i(p2 + a3);
  p[-2 * step] = (uint8_t)clip255i(p1 + a2);
  p[-step] = (uint8_t)clip255i(p0 + a1);
  p[0] = (uint8_t)clip255i(q0 - a1);
  p[step] = (uint8_t)clip255i(q1 - a2);
  p[2 * step] = (uint8_t)clip255i(q2 - a3);
}

// Edge filtering runs lane-parallel: the 8 pixels across the edge
// (p3..q3) for all 16 lanes along it are gathered into a contiguous
// local buffer, a fixed-trip branchless core processes the 16 lanes
// (int16 arithmetic, mask-blended stores — the scalar-host analog of
// the SIMD deblocking paths in the reference's dsp layer), and the
// touched rows are scattered back.  Chroma edges (8 lanes each) are
// paired: U in lanes 0-7, V in lanes 8-15, one core call for both.
typedef uint8_t EdgeBuf[8][16];

static inline void edge_gather(const uint8_t* p, int hstride, int vstride,
                               int n, int lane0, EdgeBuf b) {
  if (vstride == 1) {  // lanes contiguous (horizontal edges)
    for (int r = 0; r < 8; r++)
      std::memcpy(&b[r][lane0], p + (std::ptrdiff_t)(r - 4) * hstride, n);
    return;
  }
  for (int r = 0; r < 8; r++) {
    const uint8_t* src = p + (std::ptrdiff_t)(r - 4) * hstride;
    for (int j = 0; j < n; j++) b[r][lane0 + j] = src[(std::ptrdiff_t)j * vstride];
  }
}
static inline void edge_scatter(uint8_t* p, int hstride, int vstride, int n,
                                int lane0, const EdgeBuf b, int r0, int r1) {
  if (vstride == 1) {
    for (int r = r0; r <= r1; r++)
      std::memcpy(p + (std::ptrdiff_t)(r - 4) * hstride, &b[r][lane0], n);
    return;
  }
  for (int r = r0; r <= r1; r++) {
    uint8_t* dst = p + (std::ptrdiff_t)(r - 4) * hstride;
    for (int j = 0; j < n; j++) dst[(std::ptrdiff_t)j * vstride] = b[r][lane0 + j];
  }
}

#if defined(__SSE2__)
// Vertical edges: each lane's 8 pixels across the edge are contiguous.
// Load 16 rows x 8 bytes and byte-transpose into the 8x16 lane buffer
// (and back).  rows[j] points at pixel p3 of lane j.
static inline void tr_gather(const uint8_t* const rows[16], EdgeBuf b) {
  __m128i t[8];
  for (int k = 0; k < 8; k++) {
    __m128i a = _mm_loadl_epi64((const __m128i*)rows[2 * k]);
    __m128i c = _mm_loadl_epi64((const __m128i*)rows[2 * k + 1]);
    t[k] = _mm_unpacklo_epi8(a, c);  // col c of rows (2k,2k+1) at u16 slot c
  }
  __m128i w[4][2];  // [row group of 4][cols 0-3 | 4-7]
  for (int m = 0; m < 4; m++) {
    w[m][0] = _mm_unpacklo_epi16(t[2 * m], t[2 * m + 1]);
    w[m][1] = _mm_unpackhi_epi16(t[2 * m], t[2 * m + 1]);
  }
  for (int h = 0; h < 2; h++) {
    __m128i a01 = _mm_unpacklo_epi32(w[0][h], w[1][h]);  // cols 4h+0,4h+1 rows0-7
    __m128i b01 = _mm_unpackhi_epi32(w[0][h], w[1][h]);  // cols 4h+2,4h+3 rows0-7
    __m128i a23 = _mm_unpacklo_epi32(w[2][h], w[3][h]);  // rows8-15
    __m128i b23 = _mm_unpackhi_epi32(w[2][h], w[3][h]);
    _mm_storeu_si128((__m128i*)b[4 * h + 0], _mm_unpacklo_epi64(a01, a23));
    _mm_storeu_si128((__m128i*)b[4 * h + 1], _mm_unpackhi_epi64(a01, a23));
    _mm_storeu_si128((__m128i*)b[4 * h + 2], _mm_unpacklo_epi64(b01, b23));
    _mm_storeu_si128((__m128i*)b[4 * h + 3], _mm_unpackhi_epi64(b01, b23));
  }
}
static inline void tr_scatter(const EdgeBuf b, uint8_t* const rows[16]) {
  __m128i y[8];
  for (int r = 0; r < 8; r++) y[r] = _mm_loadu_si128((const __m128i*)b[r]);
  for (int half = 0; half < 2; half++) {
    __m128i t[4];  // rows (2k,2k+1) interleaved, lanes 8*half..8*half+7
    for (int k = 0; k < 4; k++)
      t[k] = half ? _mm_unpackhi_epi8(y[2 * k], y[2 * k + 1])
                  : _mm_unpacklo_epi8(y[2 * k], y[2 * k + 1]);
    __m128i ua = _mm_unpacklo_epi16(t[0], t[1]);  // lanes +0..3, rows0-3
    __m128i ub = _mm_unpackhi_epi16(t[0], t[1]);  // lanes +4..7, rows0-3
    __m128i uc = _mm_unpacklo_epi16(t[2], t[3]);  // lanes +0..3, rows4-7
    __m128i ud = _mm_unpackhi_epi16(t[2], t[3]);  // lanes +4..7, rows4-7
    __m128i v0 = _mm_unpacklo_epi32(ua, uc);      // lanes +0,+1 full
    __m128i v1 = _mm_unpackhi_epi32(ua, uc);      // lanes +2,+3
    __m128i v2 = _mm_unpacklo_epi32(ub, ud);      // lanes +4,+5
    __m128i v3 = _mm_unpackhi_epi32(ub, ud);      // lanes +6,+7
    uint8_t* const* rr = rows + 8 * half;
    _mm_storel_epi64((__m128i*)rr[0], v0);
    _mm_storel_epi64((__m128i*)rr[1], _mm_srli_si128(v0, 8));
    _mm_storel_epi64((__m128i*)rr[2], v1);
    _mm_storel_epi64((__m128i*)rr[3], _mm_srli_si128(v1, 8));
    _mm_storel_epi64((__m128i*)rr[4], v2);
    _mm_storel_epi64((__m128i*)rr[5], _mm_srli_si128(v2, 8));
    _mm_storel_epi64((__m128i*)rr[6], v3);
    _mm_storel_epi64((__m128i*)rr[7], _mm_srli_si128(v3, 8));
  }
}
#endif  // __SSE2__

#if defined(__AVX2__)
// 16 filter lanes as one 16x int16 vector (exact same arithmetic as the
// portable loop below; all intermediates fit in int16).
static inline __m256i lf_load(const uint8_t* p) {
  return _mm256_cvtepu8_epi16(_mm_loadu_si128((const __m128i*)p));
}
static inline void lf_store(uint8_t* p, __m256i x) {
  __m128i lo = _mm256_castsi256_si128(x);
  __m128i hi = _mm256_extracti128_si256(x, 1);
  _mm_storeu_si128((__m128i*)p, _mm_packus_epi16(lo, hi));
}
static inline __m256i lf_sclip1(__m256i x) {
  return _mm256_max_epi16(_mm256_min_epi16(x, _mm256_set1_epi16(127)),
                          _mm256_set1_epi16(-128));
}
static inline __m256i lf_sclip2(__m256i x) {
  return _mm256_max_epi16(_mm256_min_epi16(x, _mm256_set1_epi16(15)),
                          _mm256_set1_epi16(-16));
}
static inline __m256i lf_clip255(__m256i x) {
  return _mm256_max_epi16(_mm256_min_epi16(x, _mm256_set1_epi16(255)),
                          _mm256_setzero_si256());
}
static inline __m256i lf_ad(__m256i a, __m256i b) {  // |a-b| (epi16)
  return _mm256_abs_epi16(_mm256_sub_epi16(a, b));
}
static inline __m256i lf_le(__m256i a, __m256i b) {  // a <= b (epi16 mask)
  return _mm256_cmpeq_epi16(_mm256_cmpgt_epi16(a, b),
                            _mm256_setzero_si256());
}
// Shared mask + f2 computation: nf (needs_filter2), hv (high edge
// variance), and the 2-tap filter outputs applied to p0/q0 under hev.
struct LfCommon {
  __m256i nf, hv, a2c, f2p0, f2q0;
};
static inline LfCommon lf_common(__m256i p3, __m256i p2, __m256i p1,
                                 __m256i p0, __m256i q0, __m256i q1,
                                 __m256i q2, __m256i q3, int thresh2,
                                 int it, int hev_t) {
  LfCommon c;
  const __m256i vit = _mm256_set1_epi16((short)it);
  __m256i sum = _mm256_add_epi16(
      _mm256_slli_epi16(lf_ad(p0, q0), 2), lf_ad(p1, q1));
  c.nf = lf_le(sum, _mm256_set1_epi16((short)thresh2));
  c.nf = _mm256_and_si256(c.nf, lf_le(lf_ad(p3, p2), vit));
  c.nf = _mm256_and_si256(c.nf, lf_le(lf_ad(p2, p1), vit));
  c.nf = _mm256_and_si256(c.nf, lf_le(lf_ad(p1, p0), vit));
  c.nf = _mm256_and_si256(c.nf, lf_le(lf_ad(q3, q2), vit));
  c.nf = _mm256_and_si256(c.nf, lf_le(lf_ad(q2, q1), vit));
  c.nf = _mm256_and_si256(c.nf, lf_le(lf_ad(q1, q0), vit));
  const __m256i vhev = _mm256_set1_epi16((short)hev_t);
  c.hv = _mm256_or_si256(_mm256_cmpgt_epi16(lf_ad(p1, p0), vhev),
                         _mm256_cmpgt_epi16(lf_ad(q1, q0), vhev));
  __m256i d = _mm256_sub_epi16(q0, p0);
  c.a2c = _mm256_add_epi16(
      _mm256_add_epi16(d, _mm256_add_epi16(d, d)),
      lf_sclip1(_mm256_sub_epi16(p1, q1)));
  __m256i f2a1 = lf_sclip2(_mm256_srai_epi16(
      _mm256_add_epi16(c.a2c, _mm256_set1_epi16(4)), 3));
  __m256i f2a2 = lf_sclip2(_mm256_srai_epi16(
      _mm256_add_epi16(c.a2c, _mm256_set1_epi16(3)), 3));
  c.f2p0 = lf_clip255(_mm256_add_epi16(p0, f2a2));
  c.f2q0 = lf_clip255(_mm256_sub_epi16(q0, f2a1));
  return c;
}
static inline __m256i lf_sel(__m256i nf, __m256i hv, __m256i orig,
                             __m256i on_hev, __m256i on_nohev) {
  __m256i inner = _mm256_blendv_epi8(on_nohev, on_hev, hv);
  return _mm256_blendv_epi8(orig, inner, nf);
}
#endif  // __AVX2__

static void lane_core26(EdgeBuf b, int thresh2, int it, int hev_t) {
#if defined(__AVX2__)
  __m256i p3 = lf_load(b[0]), p2 = lf_load(b[1]), p1 = lf_load(b[2]),
          p0 = lf_load(b[3]), q0 = lf_load(b[4]), q1 = lf_load(b[5]),
          q2 = lf_load(b[6]), q3 = lf_load(b[7]);
  LfCommon c = lf_common(p3, p2, p1, p0, q0, q1, q2, q3, thresh2, it, hev_t);
  __m256i a6 = lf_sclip1(c.a2c);
  const __m256i v63 = _mm256_set1_epi16(63);
  __m256i b1 = _mm256_srai_epi16(
      _mm256_add_epi16(_mm256_mullo_epi16(a6, _mm256_set1_epi16(27)), v63), 7);
  __m256i b2 = _mm256_srai_epi16(
      _mm256_add_epi16(_mm256_mullo_epi16(a6, _mm256_set1_epi16(18)), v63), 7);
  __m256i b3 = _mm256_srai_epi16(
      _mm256_add_epi16(_mm256_mullo_epi16(a6, _mm256_set1_epi16(9)), v63), 7);
  lf_store(b[1], lf_sel(c.nf, c.hv, p2, p2,
                        lf_clip255(_mm256_add_epi16(p2, b3))));
  lf_store(b[2], lf_sel(c.nf, c.hv, p1, p1,
                        lf_clip255(_mm256_add_epi16(p1, b2))));
  lf_store(b[3], lf_sel(c.nf, c.hv, p0, c.f2p0,
                        lf_clip255(_mm256_add_epi16(p0, b1))));
  lf_store(b[4], lf_sel(c.nf, c.hv, q0, c.f2q0,
                        lf_clip255(_mm256_sub_epi16(q0, b1))));
  lf_store(b[5], lf_sel(c.nf, c.hv, q1, q1,
                        lf_clip255(_mm256_sub_epi16(q1, b2))));
  lf_store(b[6], lf_sel(c.nf, c.hv, q2, q2,
                        lf_clip255(_mm256_sub_epi16(q2, b3))));
#else
  for (int j = 0; j < 16; j++) {
    int p3 = b[0][j], p2 = b[1][j], p1 = b[2][j], p0 = b[3][j];
    int q0 = b[4][j], q1 = b[5][j], q2 = b[6][j], q3 = b[7][j];
    int nf = (4 * iabs(p0 - q0) + iabs(p1 - q1) <= thresh2) &
             (iabs(p3 - p2) <= it) & (iabs(p2 - p1) <= it) &
             (iabs(p1 - p0) <= it) & (iabs(q3 - q2) <= it) &
             (iabs(q2 - q1) <= it) & (iabs(q1 - q0) <= it);
    int hv = (iabs(p1 - p0) > hev_t) | (iabs(q1 - q0) > hev_t);
    int a2c = 3 * (q0 - p0) + sclip1(p1 - q1);
    int f2a1 = sclip2((a2c + 4) >> 3);
    int f2a2 = sclip2((a2c + 3) >> 3);
    int f2p0 = clip255i(p0 + f2a2), f2q0 = clip255i(q0 - f2a1);
    int a6 = sclip1(a2c);
    int b1 = (27 * a6 + 63) >> 7;
    int b2 = (18 * a6 + 63) >> 7;
    int b3 = (9 * a6 + 63) >> 7;
    int f6p2 = clip255i(p2 + b3), f6p1 = clip255i(p1 + b2);
    int f6p0 = clip255i(p0 + b1), f6q0 = clip255i(q0 - b1);
    int f6q1 = clip255i(q1 - b2), f6q2 = clip255i(q2 - b3);
    b[1][j] = (uint8_t)(nf ? (hv ? p2 : f6p2) : p2);
    b[2][j] = (uint8_t)(nf ? (hv ? p1 : f6p1) : p1);
    b[3][j] = (uint8_t)(nf ? (hv ? f2p0 : f6p0) : p0);
    b[4][j] = (uint8_t)(nf ? (hv ? f2q0 : f6q0) : q0);
    b[5][j] = (uint8_t)(nf ? (hv ? q1 : f6q1) : q1);
    b[6][j] = (uint8_t)(nf ? (hv ? q2 : f6q2) : q2);
  }
#endif
}
static void lane_core24(EdgeBuf b, int thresh2, int it, int hev_t) {
#if defined(__AVX2__)
  __m256i p3 = lf_load(b[0]), p2 = lf_load(b[1]), p1 = lf_load(b[2]),
          p0 = lf_load(b[3]), q0 = lf_load(b[4]), q1 = lf_load(b[5]),
          q2 = lf_load(b[6]), q3 = lf_load(b[7]);
  LfCommon c = lf_common(p3, p2, p1, p0, q0, q1, q2, q3, thresh2, it, hev_t);
  __m256i d = _mm256_sub_epi16(q0, p0);
  __m256i a4 = _mm256_add_epi16(d, _mm256_add_epi16(d, d));
  __m256i f4a1 = lf_sclip2(_mm256_srai_epi16(
      _mm256_add_epi16(a4, _mm256_set1_epi16(4)), 3));
  __m256i f4a2 = lf_sclip2(_mm256_srai_epi16(
      _mm256_add_epi16(a4, _mm256_set1_epi16(3)), 3));
  __m256i f4a3 = _mm256_srai_epi16(
      _mm256_add_epi16(f4a1, _mm256_set1_epi16(1)), 1);
  lf_store(b[2], lf_sel(c.nf, c.hv, p1, p1,
                        lf_clip255(_mm256_add_epi16(p1, f4a3))));
  lf_store(b[3], lf_sel(c.nf, c.hv, p0, c.f2p0,
                        lf_clip255(_mm256_add_epi16(p0, f4a2))));
  lf_store(b[4], lf_sel(c.nf, c.hv, q0, c.f2q0,
                        lf_clip255(_mm256_sub_epi16(q0, f4a1))));
  lf_store(b[5], lf_sel(c.nf, c.hv, q1, q1,
                        lf_clip255(_mm256_sub_epi16(q1, f4a3))));
#else
  for (int j = 0; j < 16; j++) {
    int p3 = b[0][j], p2 = b[1][j], p1 = b[2][j], p0 = b[3][j];
    int q0 = b[4][j], q1 = b[5][j], q2 = b[6][j], q3 = b[7][j];
    int nf = (4 * iabs(p0 - q0) + iabs(p1 - q1) <= thresh2) &
             (iabs(p3 - p2) <= it) & (iabs(p2 - p1) <= it) &
             (iabs(p1 - p0) <= it) & (iabs(q3 - q2) <= it) &
             (iabs(q2 - q1) <= it) & (iabs(q1 - q0) <= it);
    int hv = (iabs(p1 - p0) > hev_t) | (iabs(q1 - q0) > hev_t);
    int a2c = 3 * (q0 - p0) + sclip1(p1 - q1);
    int f2a1 = sclip2((a2c + 4) >> 3);
    int f2a2 = sclip2((a2c + 3) >> 3);
    int f2p0 = clip255i(p0 + f2a2), f2q0 = clip255i(q0 - f2a1);
    int a4 = 3 * (q0 - p0);
    int f4a1 = sclip2((a4 + 4) >> 3);
    int f4a2 = sclip2((a4 + 3) >> 3);
    int f4a3 = (f4a1 + 1) >> 1;
    int f4p1 = clip255i(p1 + f4a3), f4p0 = clip255i(p0 + f4a2);
    int f4q0 = clip255i(q0 - f4a1), f4q1 = clip255i(q1 - f4a3);
    b[2][j] = (uint8_t)(nf ? (hv ? p1 : f4p1) : p1);
    b[3][j] = (uint8_t)(nf ? (hv ? f2p0 : f4p0) : p0);
    b[4][j] = (uint8_t)(nf ? (hv ? f2q0 : f4q0) : q0);
    b[5][j] = (uint8_t)(nf ? (hv ? q1 : f4q1) : q1);
  }
#endif
}

// Luma edge (16 lanes).  For vertical edges (hstride == 1) the lanes'
// across-edge pixels are contiguous: SIMD-transpose in and out.
static void filter_loop26(uint8_t* p, int hstride, int vstride, int n,
                          int thresh, int it, int hev_t) {
  EdgeBuf b;
#if defined(__SSE2__)
  if (hstride == 1 && n == 16) {
    uint8_t* rows[16];
    for (int j = 0; j < 16; j++)
      rows[j] = p + (std::ptrdiff_t)j * vstride - 4;
    tr_gather(rows, b);
    lane_core26(b, 2 * thresh + 1, it, hev_t);
    tr_scatter(b, rows);
    return;
  }
#endif
  edge_gather(p, hstride, vstride, n, 0, b);
  if (n < 16)  // lone chroma edge (fallback callers): mirror into top lanes
    edge_gather(p, hstride, vstride, n, 16 - n, b);
  lane_core26(b, 2 * thresh + 1, it, hev_t);
  edge_scatter(p, hstride, vstride, n, 0, b, 1, 6);
}
static void filter_loop24(uint8_t* p, int hstride, int vstride, int n,
                          int thresh, int it, int hev_t) {
  EdgeBuf b;
#if defined(__SSE2__)
  if (hstride == 1 && n == 16) {
    uint8_t* rows[16];
    for (int j = 0; j < 16; j++)
      rows[j] = p + (std::ptrdiff_t)j * vstride - 4;
    tr_gather(rows, b);
    lane_core24(b, 2 * thresh + 1, it, hev_t);
    tr_scatter(b, rows);
    return;
  }
#endif
  edge_gather(p, hstride, vstride, n, 0, b);
  if (n < 16)
    edge_gather(p, hstride, vstride, n, 16 - n, b);
  lane_core24(b, 2 * thresh + 1, it, hev_t);
  edge_scatter(p, hstride, vstride, n, 0, b, 2, 5);
}
// Paired chroma edge: U lanes 0-7, V lanes 8-15, one core call.
static void filter_loop26_uv(uint8_t* up, uint8_t* vp, int hstride,
                             int vstride, int thresh, int it, int hev_t) {
  EdgeBuf b;
#if defined(__SSE2__)
  if (hstride == 1) {
    uint8_t* rows[16];
    for (int j = 0; j < 8; j++) {
      rows[j] = up + (std::ptrdiff_t)j * vstride - 4;
      rows[8 + j] = vp + (std::ptrdiff_t)j * vstride - 4;
    }
    tr_gather(rows, b);
    lane_core26(b, 2 * thresh + 1, it, hev_t);
    tr_scatter(b, rows);
    return;
  }
#endif
  edge_gather(up, hstride, vstride, 8, 0, b);
  edge_gather(vp, hstride, vstride, 8, 8, b);
  lane_core26(b, 2 * thresh + 1, it, hev_t);
  edge_scatter(up, hstride, vstride, 8, 0, b, 1, 6);
  edge_scatter(vp, hstride, vstride, 8, 8, b, 1, 6);
}
static void filter_loop24_uv(uint8_t* up, uint8_t* vp, int hstride,
                             int vstride, int thresh, int it, int hev_t) {
  EdgeBuf b;
#if defined(__SSE2__)
  if (hstride == 1) {
    uint8_t* rows[16];
    for (int j = 0; j < 8; j++) {
      rows[j] = up + (std::ptrdiff_t)j * vstride - 4;
      rows[8 + j] = vp + (std::ptrdiff_t)j * vstride - 4;
    }
    tr_gather(rows, b);
    lane_core24(b, 2 * thresh + 1, it, hev_t);
    tr_scatter(b, rows);
    return;
  }
#endif
  edge_gather(up, hstride, vstride, 8, 0, b);
  edge_gather(vp, hstride, vstride, 8, 8, b);
  lane_core24(b, 2 * thresh + 1, it, hev_t);
  edge_scatter(up, hstride, vstride, 8, 0, b, 2, 5);
  edge_scatter(vp, hstride, vstride, 8, 8, b, 2, 5);
}
static void filter_simple(uint8_t* p, int hstride, int vstride, int n,
                          int thresh) {
  int thresh2 = 2 * thresh + 1;
  uint8_t lanes[4][16];
  for (int r = 0; r < 4; r++) {
    const uint8_t* src = p + (std::ptrdiff_t)(r - 2) * hstride;
    for (int j = 0; j < n; j++) lanes[r][j] = src[(std::ptrdiff_t)j * vstride];
  }
  for (int j = 0; j < 16; j++) {
    int p1 = lanes[0][j], p0 = lanes[1][j], q0 = lanes[2][j], q1 = lanes[3][j];
    int nf = 4 * iabs(p0 - q0) + iabs(p1 - q1) <= thresh2;
    int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    int a1 = sclip2((a + 4) >> 3);
    int a2 = sclip2((a + 3) >> 3);
    int fp0 = clip255i(p0 + a2), fq0 = clip255i(q0 - a1);
    lanes[1][j] = (uint8_t)(nf ? fp0 : p0);
    lanes[2][j] = (uint8_t)(nf ? fq0 : q0);
  }
  for (int r = 1; r < 3; r++) {
    uint8_t* dst = p + (std::ptrdiff_t)(r - 2) * hstride;
    for (int j = 0; j < n; j++) dst[(std::ptrdiff_t)j * vstride] = lanes[r][j];
  }
}

// Shared entropy-decode phase: partition-0 mode parse + token-partition
// residual decode into dequantized per-MB coefficient blocks (the host
// half of the host/device split, SURVEY.md Â§7).  Returns 0 on success.
static int parse_frame_mbs(
    const uint8_t* p0, uint64_t p0_size, uint64_t p0_pos, uint32_t p0_value,
    uint32_t p0_range, uint32_t p0_bitcount,
    const uint8_t* parts, const uint64_t* part_offsets, int num_parts,
    int mb_w, int mb_h,
    int update_map, const uint8_t* segment_probs,
    int use_skip, int skip_p,
    const uint8_t* coeff_probs, const int32_t* quants,
    std::vector<MB>& mbs, std::atomic<int>* row_progress = nullptr) {
  BoolDec bd;
  bd.data = p0; bd.size = p0_size; bd.pos = p0_pos;
  bd.value = p0_value; bd.range = p0_range; bd.bit_count = (int)p0_bitcount;

  std::vector<FastBoolDec> tparts(num_parts);
  for (int i = 0; i < num_parts; i++)
    tparts[i].init(parts + part_offsets[i],
                   part_offsets[i + 1] - part_offsets[i]);

  // mbs is pre-assigned by the caller (the overlapped entry reads it
  // from a second thread, so the storage must exist before parsing).
  std::vector<uint8_t> intra_t((size_t)4 * mb_w, 0);
  std::vector<Ctx> ctx_above(mb_w);

  for (int mb_y = 0; mb_y < mb_h; mb_y++) {
    uint8_t intra_l[4] = {0, 0, 0, 0};
    Ctx ctx_left;
    FastBoolDec& tb = tparts[mb_y & (num_parts - 1)];
    // --- mode parsing for the row (partition 0) ---
    for (int mb_x = 0; mb_x < mb_w; mb_x++) {
      MB& mb = mbs[(size_t)mb_y * mb_w + mb_x];
      std::memset(mb.coeffs, 0, sizeof(mb.coeffs));
      std::memset(mb.has_nz, 0, sizeof(mb.has_nz));
      mb.segment = 0;
      if (update_map) {
        if (!bd.get(segment_probs[0])) mb.segment = (uint8_t)bd.get(segment_probs[1]);
        else mb.segment = (uint8_t)(2 + bd.get(segment_probs[2]));
      }
      mb.skip = use_skip ? (uint8_t)bd.get(skip_p) : 0;
      mb.is_i4 = (uint8_t)(!bd.get(145));
      uint8_t* top4 = intra_t.data() + 4 * mb_x;
      if (!mb.is_i4) {
        int ymode;
        if (bd.get(156)) ymode = bd.get(128) ? 1 : 3;   // TM : HE
        else ymode = bd.get(163) ? 2 : 0;               // VE : DC
        mb.ymode = (uint8_t)ymode;
        for (int i = 0; i < 16; i++) mb.imodes[i] = (uint8_t)ymode;
        std::memset(top4, ymode, 4);
        std::memset(intra_l, ymode, 4);
      } else {
        for (int yy = 0; yy < 4; yy++) {
          int ymode = intra_l[yy];
          for (int xx = 0; xx < 4; xx++) {
            const uint8_t* prob = kBModeProbas + (top4[xx] * 10 + ymode) * 9;
            int i = kBModeTree[bd.get(prob[0])];
            while (i > 0) i = kBModeTree[2 * i + bd.get(prob[i])];
            ymode = -i;
            top4[xx] = (uint8_t)ymode;
            mb.imodes[4 * yy + xx] = (uint8_t)ymode;
          }
          intra_l[yy] = (uint8_t)ymode;
        }
      }
      if (!bd.get(142)) mb.uvmode = 0;
      else if (!bd.get(114)) mb.uvmode = 2;
      else mb.uvmode = bd.get(183) ? 1 : 3;
    }
    // --- residuals (token partition) ---
    for (int mb_x = 0; mb_x < mb_w; mb_x++) {
      MB& mb = mbs[(size_t)mb_y * mb_w + mb_x];
      Ctx& above = ctx_above[mb_x];
      const int32_t* q = quants + mb.segment * 6;
      int skip = use_skip ? mb.skip : 0;
      if (skip) {
        above.nz = 0;
        ctx_left.nz = 0;
        if (!mb.is_i4) { above.nz_dc = 0; ctx_left.nz_dc = 0; }
        mb.skip = 1;
        mb.dither = 0;  // explicitly skipped MBs are never dithered
      } else {
        const uint8_t* probs0 = coeff_probs + 0 * 8 * 3 * 11;
        const uint8_t* probs1 = coeff_probs + 1 * 8 * 3 * 11;
        const uint8_t* probs2 = coeff_probs + 2 * 8 * 3 * 11;
        const uint8_t* probs3 = coeff_probs + 3 * 8 * 3 * 11;
        int first;
        const uint8_t* ac_probs;
        uint32_t any_nz = 0;
        if (!mb.is_i4) {
          int16_t dc[16] = {0};
          int ctx = (int)(above.nz_dc + ctx_left.nz_dc);
          int nz = get_coeffs(tb, probs1, ctx, q[2], q[3], 0, dc);
          above.nz_dc = ctx_left.nz_dc = (nz > 0);
          any_nz |= (nz > 0);
          int32_t dcs[16];
          if (nz > 1) {
            iwht4x4(dc, dcs);
          } else {
            int32_t dc0 = (dc[0] + 3) >> 3;
            for (int i = 0; i < 16; i++) dcs[i] = dc0;
          }
          for (int i = 0; i < 16; i++) mb.coeffs[i][0] = (int16_t)dcs[i];
          first = 1;
          ac_probs = probs0;
        } else {
          first = 0;
          ac_probs = probs3;
        }
        uint32_t tnz = above.nz & 0x0f, lnz = ctx_left.nz & 0x0f;
        for (int yy = 0; yy < 4; yy++) {
          uint32_t l = lnz & 1;
          for (int xx = 0; xx < 4; xx++) {
            int ctx = (int)(l + (tnz & 1));
            int bi = 4 * yy + xx;
            int nz = get_coeffs(tb, ac_probs, ctx, q[0], q[1], first,
                                mb.coeffs[bi]);
            l = nz > first;
            tnz = (tnz >> 1) | (l << 7);
            // has_nz: any dequantized coefficient present (incl. WHT dc).
            bool has = nz > first || mb.coeffs[bi][0] != 0;
            mb.has_nz[bi] = has;
            any_nz |= (uint32_t)has;
          }
          tnz >>= 4;
          lnz = (lnz >> 1) | (l << 7);
        }
        uint32_t out_t = tnz, out_l = lnz >> 4;
        bool uv_ac = false;  // any chroma block with a coeff beyond index 0
        for (int ch = 0; ch < 4; ch += 2) {
          tnz = (above.nz >> (4 + ch)) & 0xff;
          lnz = (ctx_left.nz >> (4 + ch)) & 0xff;
          uint32_t l = 0;
          for (int yy = 0; yy < 2; yy++) {
            l = lnz & 1;
            for (int xx = 0; xx < 2; xx++) {
              int ctx = (int)(l + (tnz & 1));
              int bi = 16 + 2 * ch + 2 * yy + xx;
              int nz = get_coeffs(tb, probs2, ctx, q[4], q[5], 0,
                                  mb.coeffs[bi]);
              l = nz > 0;
              tnz = (tnz >> 1) | (l << 3);
              mb.has_nz[bi] = nz > 0;
              any_nz |= (uint32_t)(nz > 0);
              uv_ac |= nz > 1;
            }
            tnz >>= 2;
            lnz = (lnz >> 1) | (l << 5);
          }
          out_t |= (tnz << 4) << ch;
          out_l |= (lnz & 0xf0) << ch;
        }
        above.nz = out_t;
        ctx_left.nz = out_l;
        mb.skip = !any_nz;
        // Reference vp8_dec.go:693-699: dither only flat-chroma MBs.
        mb.dither = uv_ac ? 0 : 1;
        if (tb.exhausted()) return 1;
      }
    }
    if (bd.exhausted()) return 2;
    if (row_progress)
      row_progress->store(mb_y + 1, std::memory_order_release);
  }
  return 0;
}

}  // namespace

extern "C" {

// Reconstruction + loop filter + chroma dither from a parsed MB list;
// shared by the single-stream frame decoder and the array-driven entry
// (batch symbol engine output -> host planes).
// Reconstruction of MB rows [row0, row1).  Context comes straight from
// the output planes (the row above must already be reconstructed and
// still UNFILTERED at its bottom row — which filter_rows guarantees:
// filtering row F only touches luma rows 16F-3..16F+13, never a row's
// bottom two), so the frame can be produced in bands while the symbol
// parser is still working on later rows (the reference's 2-thread
// pipeline, frame_dec.c.go:493-536, re-expressed as band pipelining).
static void recon_rows(
    std::vector<MB>& mbs, int mb_w, int row0, int row1,
    uint8_t* y_out, uint8_t* u_out, uint8_t* v_out) {
  const int ys = mb_w * 16;          // luma stride
  const int cs = mb_w * 8;           // chroma stride
  std::vector<uint8_t> ybuf(17 * BUFS), ubuf(9 * BUFS), vbuf(9 * BUFS);
  for (int mb_y = row0; mb_y < row1; mb_y++) {
    for (int mb_x = 0; mb_x < mb_w; mb_x++) {
      MB& mb = mbs[(size_t)mb_y * mb_w + mb_x];
      bool ht = mb_y > 0, hl = mb_x > 0;
      // Fill borders.
      if (ht) {
        const uint8_t* yt = y_out + (size_t)(mb_y * 16 - 1) * ys + mb_x * 16;
        std::memcpy(&ybuf[1], yt, 16);
        if (mb_x < mb_w - 1) std::memcpy(&ybuf[17], yt + 16, 4);
        else std::memset(&ybuf[17], yt[15], 4);
        const uint8_t* ut = u_out + (size_t)(mb_y * 8 - 1) * cs + mb_x * 8;
        const uint8_t* vt = v_out + (size_t)(mb_y * 8 - 1) * cs + mb_x * 8;
        std::memcpy(&ubuf[1], ut, 8);
        std::memcpy(&vbuf[1], vt, 8);
        ybuf[0] = hl ? yt[-1] : 129;
        ubuf[0] = hl ? ut[-1] : 129;
        vbuf[0] = hl ? vt[-1] : 129;
      } else {
        std::memset(&ybuf[0], 127, 21);
        std::memset(&ubuf[0], 127, 9);
        std::memset(&vbuf[0], 127, 9);
      }
      for (int r = 0; r < 16; r++)
        ybuf[(1 + r) * BUFS] = hl
            ? y_out[(size_t)(mb_y * 16 + r) * ys + mb_x * 16 - 1] : 129;
      for (int r = 0; r < 8; r++) {
        ubuf[(1 + r) * BUFS] = hl
            ? u_out[(size_t)(mb_y * 8 + r) * cs + mb_x * 8 - 1] : 129;
        vbuf[(1 + r) * BUFS] = hl
            ? v_out[(size_t)(mb_y * 8 + r) * cs + mb_x * 8 - 1] : 129;
      }
      if (mb.is_i4) {
        // Replicate TR below row 0 for right-column blocks.
        for (int rr = 4; rr <= 12; rr += 4)
          std::memcpy(&ybuf[rr * BUFS + 17], &ybuf[17], 4);
        for (int n = 0; n < 16; n++) {
          int r = 4 * (n >> 2), c = 4 * (n & 3);
          predict_luma4(ybuf.data(), c, r, mb.imodes[n]);
          if (mb.has_nz[n])
            idct_add(mb.coeffs[n], &ybuf[(r + 1) * BUFS + c + 1], BUFS);
        }
      } else {
        predict_block(ybuf.data(), 0, 0, 16, mb.ymode, ht, hl);
        for (int n = 0; n < 16; n++) {
          int r = 4 * (n >> 2), c = 4 * (n & 3);
          if (mb.has_nz[n])
            idct_add(mb.coeffs[n], &ybuf[(r + 1) * BUFS + c + 1], BUFS);
        }
      }
      predict_block(ubuf.data(), 0, 0, 8, mb.uvmode, ht, hl);
      predict_block(vbuf.data(), 0, 0, 8, mb.uvmode, ht, hl);
      for (int n = 0; n < 4; n++) {
        int r = 4 * (n >> 1), c = 4 * (n & 1);
        if (mb.has_nz[16 + n])
          idct_add(mb.coeffs[16 + n], &ubuf[(r + 1) * BUFS + c + 1], BUFS);
        if (mb.has_nz[20 + n])
          idct_add(mb.coeffs[20 + n], &vbuf[(r + 1) * BUFS + c + 1], BUFS);
      }
      // Store.
      for (int r = 0; r < 16; r++)
        std::memcpy(y_out + (size_t)(mb_y * 16 + r) * ys + mb_x * 16,
                    &ybuf[(1 + r) * BUFS + 1], 16);
      for (int r = 0; r < 8; r++) {
        std::memcpy(u_out + (size_t)(mb_y * 8 + r) * cs + mb_x * 8,
                    &ubuf[(1 + r) * BUFS + 1], 8);
        std::memcpy(v_out + (size_t)(mb_y * 8 + r) * cs + mb_x * 8,
                    &vbuf[(1 + r) * BUFS + 1], 8);
      }
    }
  }
}

// Loop filter for MB rows [row0, row1).  Filtering row F requires
// recon of rows <= F+1: its column edges (left + inner vertical)
// modify every row of F including the bottom one, which row F+1's
// intra prediction reads unfiltered — so a banded caller keeps the
// filter one reconstructed row behind (libwebp's 1-MB filter lag).
static void filter_rows(
    std::vector<MB>& mbs, int mb_w, int row0, int row1,
    int filter_type, const int32_t* finfo,
    uint8_t* y_out, uint8_t* u_out, uint8_t* v_out) {
  const int ys = mb_w * 16;
  const int cs = mb_w * 8;
  if (filter_type > 0) {
    for (int mb_y = row0; mb_y < row1; mb_y++) {
      for (int mb_x = 0; mb_x < mb_w; mb_x++) {
        MB& mb = mbs[(size_t)mb_y * mb_w + mb_x];
        const int32_t* fi = finfo + (mb.segment * 2 + (mb.is_i4 ? 1 : 0)) * 3;
        int limit = fi[0], il = fi[1], hv = fi[2];
        if (limit < 0) continue;
        bool inner = mb.is_i4 || !mb.skip;
        uint8_t* yp = y_out + (size_t)mb_y * 16 * ys + mb_x * 16;
        if (filter_type == 1) {
          if (mb_x > 0) filter_simple(yp, 1, ys, 16, limit + 4);
          if (inner)
            for (int dx = 4; dx <= 12; dx += 4)
              filter_simple(yp + dx, 1, ys, 16, limit);
          if (mb_y > 0) filter_simple(yp, ys, 1, 16, limit + 4);
          if (inner)
            for (int dy = 4; dy <= 12; dy += 4)
              filter_simple(yp + (size_t)dy * ys, ys, 1, 16, limit);
        } else {
          uint8_t* up = u_out + (size_t)mb_y * 8 * cs + mb_x * 8;
          uint8_t* vp = v_out + (size_t)mb_y * 8 * cs + mb_x * 8;
          if (mb_x > 0) {
            filter_loop26(yp, 1, ys, 16, limit + 4, il, hv);
            filter_loop26_uv(up, vp, 1, cs, limit + 4, il, hv);
          }
          if (inner) {
            for (int dx = 4; dx <= 12; dx += 4)
              filter_loop24(yp + dx, 1, ys, 16, limit, il, hv);
            filter_loop24_uv(up + 4, vp + 4, 1, cs, limit, il, hv);
          }
          if (mb_y > 0) {
            filter_loop26(yp, ys, 1, 16, limit + 4, il, hv);
            filter_loop26_uv(up, vp, cs, 1, limit + 4, il, hv);
          }
          if (inner) {
            for (int dy = 4; dy <= 12; dy += 4)
              filter_loop24(yp + (size_t)dy * ys, ys, 1, 16, limit, il, hv);
            filter_loop24_uv(up + (size_t)4 * cs, vp + (size_t)4 * cs,
                             cs, 1, limit, il, hv);
          }
        }
      }
    }
  }

}

// Chroma dithering for MB rows [row0, row1) (after filtering, raster
// order; reference frame_dec.c.go FinishRow: FilterRow then DitherRow).
// The RNG state threads across calls.  Dithering row D touches chroma
// rows 8D..8D+7, which row D+1's top-edge filter also modifies — so a
// banded caller must keep dither one filtered row behind.
static void dither_rows(
    VP8Random& rg, std::vector<MB>& mbs, int mb_w, int row0, int row1,
    const int32_t* dither_amps, uint8_t* u_out, uint8_t* v_out) {
  const int cs = mb_w * 8;
  if (dither_amps != nullptr &&
      (dither_amps[0] | dither_amps[1] | dither_amps[2] | dither_amps[3])) {
    for (int mb_y = row0; mb_y < row1; mb_y++) {
      for (int mb_x = 0; mb_x < mb_w; mb_x++) {
        const MB& mb = mbs[(size_t)mb_y * mb_w + mb_x];
        const int amp = mb.dither ? dither_amps[mb.segment] : 0;
        if (amp >= 4) {  // MIN_DITHER_AMP
          uint8_t* up = u_out + (size_t)mb_y * 8 * cs + mb_x * 8;
          uint8_t* vp = v_out + (size_t)mb_y * 8 * cs + mb_x * 8;
          dither8x8(rg, up, cs, amp);
          dither8x8(rg, vp, cs, amp);
        }
      }
    }
  }
}

static void recon_filter_dither(
    std::vector<MB>& mbs, int mb_w, int mb_h,
    int filter_type, const int32_t* finfo,
    uint8_t* y_out, uint8_t* u_out, uint8_t* v_out,
    const int32_t* dither_amps) {
  recon_rows(mbs, mb_w, 0, mb_h, y_out, u_out, v_out);
  filter_rows(mbs, mb_w, 0, mb_h, filter_type, finfo, y_out, u_out, v_out);
  VP8Random rg;
  dither_rows(rg, mbs, mb_w, 0, mb_h, dither_amps, u_out, v_out);
}

extern "C" int wtpu_vp8_decode_frame(
    const uint8_t* p0, uint64_t p0_size, uint64_t p0_pos, uint32_t p0_value,
    uint32_t p0_range, uint32_t p0_bitcount,
    const uint8_t* parts, const uint64_t* part_offsets, int num_parts,
    int mb_w, int mb_h,
    int update_map, const uint8_t* segment_probs,
    int use_skip, int skip_p,
    const uint8_t* coeff_probs,          // [4][8][3][11]
    const int32_t* quants,               // [4][6]
    int filter_type,
    const int32_t* finfo,                // [4][2][3] limit/ilevel/hev; limit<0=off
    uint8_t* y_out, uint8_t* u_out, uint8_t* v_out,
    const int32_t* dither_amps /* [4] per-segment, NULL = off */) {
  std::vector<MB> mbs((size_t)mb_w * mb_h);
  int rc = parse_frame_mbs(p0, p0_size, p0_pos, p0_value, p0_range,
                           p0_bitcount, parts, part_offsets, num_parts,
                           mb_w, mb_h, update_map, segment_probs,
                           use_skip, skip_p, coeff_probs, quants, mbs);
  if (rc != 0) return rc;
  recon_filter_dither(mbs, mb_w, mb_h, filter_type, finfo,
                      y_out, u_out, v_out, dither_amps);
  return 0;
}

// Overlapped single-image decode: the symbol parse runs on a worker
// thread publishing a per-MB-row progress watermark; this thread
// reconstructs, loop-filters and dithers completed rows behind it.
// The band lags encode the data dependencies proven above recon_rows /
// filter_rows / dither_rows: filter <= recon, dither <= filter - 1.
// Output is bit-identical to wtpu_vp8_decode_frame (same math, same
// order within each band).  This is the re-expression of libwebp's
// 2-thread MT pipeline for a foreign single-partition file
// (reference frame_dec.c.go:493-536, VP8GetThreadMethod :655).
extern "C" int wtpu_vp8_decode_frame_mt(
    const uint8_t* p0, uint64_t p0_size, uint64_t p0_pos, uint32_t p0_value,
    uint32_t p0_range, uint32_t p0_bitcount,
    const uint8_t* parts, const uint64_t* part_offsets, int num_parts,
    int mb_w, int mb_h,
    int update_map, const uint8_t* segment_probs,
    int use_skip, int skip_p,
    const uint8_t* coeff_probs,
    const int32_t* quants,
    int filter_type,
    const int32_t* finfo,
    uint8_t* y_out, uint8_t* u_out, uint8_t* v_out,
    const int32_t* dither_amps) {
  std::vector<MB> mbs((size_t)mb_w * mb_h);
  std::atomic<int> progress{0};
  std::atomic<int> parse_rc{INT32_MIN};
  std::thread parser([&] {
    int rc = parse_frame_mbs(p0, p0_size, p0_pos, p0_value, p0_range,
                             p0_bitcount, parts, part_offsets, num_parts,
                             mb_w, mb_h, update_map, segment_probs,
                             use_skip, skip_p, coeff_probs, quants, mbs,
                             &progress);
    parse_rc.store(rc, std::memory_order_release);
  });
  int recon_done = 0, filt_done = 0, dith_done = 0;
  VP8Random rg;
  for (;;) {
    const int rc_now = parse_rc.load(std::memory_order_acquire);
    const int p = progress.load(std::memory_order_acquire);
    if (p > recon_done) {
      recon_rows(mbs, mb_w, recon_done, p, y_out, u_out, v_out);
      recon_done = p;
      // filter lags recon by one row (column edges touch row F's
      // bottom row, which recon of F+1 reads unfiltered); dither lags
      // the filter by one more (row F+1's chroma top edge).
      const int f = recon_done == mb_h ? mb_h : recon_done - 1;
      if (f > filt_done) {
        filter_rows(mbs, mb_w, filt_done, f, filter_type, finfo,
                    y_out, u_out, v_out);
        filt_done = f;
      }
      const int d = filt_done == mb_h ? mb_h : filt_done - 1;
      if (d > dith_done) {
        dither_rows(rg, mbs, mb_w, dith_done, d, dither_amps,
                    u_out, v_out);
        dith_done = d;
      }
    } else if (rc_now != INT32_MIN) {
      break;                       // parser finished (ok or error)
    } else {
      std::this_thread::yield();
    }
    if (recon_done == mb_h) break;
  }
  parser.join();
  const int rc = parse_rc.load(std::memory_order_acquire);
  if (rc != 0) return rc;
  if (recon_done < mb_h) {         // parser outran the loop's last look
    recon_rows(mbs, mb_w, recon_done, mb_h, y_out, u_out, v_out);
    filter_rows(mbs, mb_w, filt_done, mb_h, filter_type, finfo,
                y_out, u_out, v_out);
    filt_done = mb_h;
  }
  if (dith_done < mb_h)
    dither_rows(rg, mbs, mb_w, dith_done, mb_h, dither_amps, u_out, v_out);
  return 0;
}

// Reconstruct host planes from the batch symbol engine's output arrays
// (decoder.py decode_vp8_symbols_batch): coeffs (N,24,16) dequantized
// int16, modes (N,21) = [is_i4, uvmode, segment, skip, dither,
// imodes[16]].  Lets the interleaved multi-stream entropy engine feed
// the host reconstruction path.
extern "C" int wtpu_vp8_recon_frame_arrays(
    const int16_t* coeffs, const uint8_t* modes,
    int mb_w, int mb_h, int filter_type, const int32_t* finfo,
    const int32_t* dither_amps,
    uint8_t* y_out, uint8_t* u_out, uint8_t* v_out) {
  const size_t n = (size_t)mb_w * mb_h;
  std::vector<MB> mbs(n);
  for (size_t i = 0; i < n; i++) {
    MB& mb = mbs[i];
    const uint8_t* m = modes + i * 21;
    mb.is_i4 = m[0]; mb.uvmode = m[1]; mb.segment = m[2];
    mb.skip = m[3]; mb.dither = m[4];
    std::memcpy(mb.imodes, m + 5, 16);
    mb.ymode = mb.imodes[0];
    const int16_t* c = coeffs + i * 24 * 16;
    std::memcpy(mb.coeffs, c, 24 * 16 * sizeof(int16_t));
    for (int b = 0; b < 24; b++) {
      const int16_t* q = c + b * 16;
      int16_t any = 0;
      for (int k = 0; k < 16; k++) any |= q[k];
      mb.has_nz[b] = (uint8_t)(any != 0);
    }
  }
  recon_filter_dither(mbs, mb_w, mb_h, filter_type, finfo,
                      y_out, u_out, v_out, dither_amps);
  return 0;
}

// ----------------------------------------------------------------------
// Fused fancy upsample + BT.601 YUV→RGBA (libwebp's EmitFancyRGB math).
// ----------------------------------------------------------------------
static inline void yuv2rgba_px(int y, int u, int v, uint8_t* o) {
  const int yy = (y * 19077) >> 8;
  int r = yy + ((v * 26149) >> 8) - 14234;
  int g = yy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708;
  int b = yy + ((u * 33050) >> 8) - 17685;
  const int M = (256 << 6) - 1;
  r = r < 0 ? 0 : (r > M ? M : r);
  g = g < 0 ? 0 : (g > M ? M : g);
  b = b < 0 ? 0 : (b > M ? M : b);
  o[0] = (uint8_t)(r >> 6);
  o[1] = (uint8_t)(g >> 6);
  o[2] = (uint8_t)(b >> 6);
  o[3] = 255;
}

// One interpolated chroma row pair: T = chroma row k, B = row k+1.
// Note 2*i < width always holds for 1 <= i < w2 (w2 = ceil(width/2)),
// so the pairwise writes are unconditional and the loop is
// lane-parallel over i; an AVX2 path computes 16 i's per step.
static void fancy_row(const uint8_t* T, const uint8_t* B, int w2, int width,
                      uint8_t* out_top /* len width */, bool is_top) {
  // is_top: produce the "top" output row of the pair, else the bottom.
  if (is_top) out_top[0] = (uint8_t)((3 * T[0] + B[0] + 2) >> 2);
  else out_top[0] = (uint8_t)((3 * B[0] + T[0] + 2) >> 2);
  int i = 1;
#if defined(__AVX2__)
  for (; i + 16 <= w2; i += 16) {
    const __m256i tl = lf_load(T + i - 1), t = lf_load(T + i);
    const __m256i l = lf_load(B + i - 1), c = lf_load(B + i);
    const __m256i avg = _mm256_add_epi16(
        _mm256_add_epi16(_mm256_add_epi16(tl, t), _mm256_add_epi16(l, c)),
        _mm256_set1_epi16(8));
    const __m256i d12 = _mm256_srai_epi16(
        _mm256_add_epi16(avg, _mm256_slli_epi16(_mm256_add_epi16(t, l), 1)),
        3);
    const __m256i d03 = _mm256_srai_epi16(
        _mm256_add_epi16(avg, _mm256_slli_epi16(_mm256_add_epi16(tl, c), 1)),
        3);
    __m256i odd, evn;  // out[2i-1], out[2i]
    if (is_top) {
      odd = _mm256_srai_epi16(_mm256_add_epi16(d12, tl), 1);
      evn = _mm256_srai_epi16(_mm256_add_epi16(d03, t), 1);
    } else {
      odd = _mm256_srai_epi16(_mm256_add_epi16(d03, l), 1);
      evn = _mm256_srai_epi16(_mm256_add_epi16(d12, c), 1);
    }
    const __m128i o8 = _mm_packus_epi16(_mm256_castsi256_si128(odd),
                                        _mm256_extracti128_si256(odd, 1));
    const __m128i e8 = _mm_packus_epi16(_mm256_castsi256_si128(evn),
                                        _mm256_extracti128_si256(evn, 1));
    _mm_storeu_si128((__m128i*)(out_top + 2 * i - 1),
                     _mm_unpacklo_epi8(o8, e8));
    _mm_storeu_si128((__m128i*)(out_top + 2 * i + 15),
                     _mm_unpackhi_epi8(o8, e8));
  }
#endif
  for (; i < w2; i++) {
    const int tl = T[i - 1], t = T[i], l = B[i - 1], c = B[i];
    const int avg = tl + t + l + c + 8;
    const int d12 = (avg + 2 * (t + l)) >> 3;
    const int d03 = (avg + 2 * (tl + c)) >> 3;
    if (is_top) {
      out_top[2 * i - 1] = (uint8_t)((d12 + tl) >> 1);
      if (2 * i < width) out_top[2 * i] = (uint8_t)((d03 + t) >> 1);
    } else {
      out_top[2 * i - 1] = (uint8_t)((d03 + l) >> 1);
      if (2 * i < width) out_top[2 * i] = (uint8_t)((d12 + c) >> 1);
    }
  }
  if (width % 2 == 0 && width > 1) {
    if (is_top)
      out_top[width - 1] = (uint8_t)((3 * T[w2 - 1] + B[w2 - 1] + 2) >> 2);
    else
      out_top[width - 1] = (uint8_t)((3 * B[w2 - 1] + T[w2 - 1] + 2) >> 2);
  }
}

#if defined(__AVX2__)
// 16 pixels of BT.601 YUV→RGBA per step, exact same fixed-point math as
// yuv2rgba_px: (x*k)>>8 == mulhi_epu16(x<<8, k); the one sum that can
// exceed int16 (yy + ub) saturates at 32767 which the >>6 clamp to
// 16383 makes exact.
static void yuv2rgba_row_avx2(const uint8_t* y, const uint8_t* u,
                              const uint8_t* v, int width, uint8_t* o) {
  const __m256i k19077 = _mm256_set1_epi16(19077);
  const __m256i k26149 = _mm256_set1_epi16((short)26149);
  const __m256i k6419 = _mm256_set1_epi16(6419);
  const __m256i k13320 = _mm256_set1_epi16(13320);
  const __m256i k33050 = _mm256_set1_epi16((short)33050);
  const __m256i c14234 = _mm256_set1_epi16(14234);
  const __m256i c8708 = _mm256_set1_epi16(8708);
  const __m256i c17685 = _mm256_set1_epi16(17685);
  const __m256i vmax = _mm256_set1_epi16((256 << 6) - 1);
  const __m256i zero = _mm256_setzero_si256();
  const __m128i a8 = _mm_set1_epi8((char)255);
  int x = 0;
  for (; x + 16 <= width; x += 16) {
    const __m256i y8 = _mm256_slli_epi16(lf_load(y + x), 8);
    const __m256i u8v = _mm256_slli_epi16(lf_load(u + x), 8);
    const __m256i v8v = _mm256_slli_epi16(lf_load(v + x), 8);
    const __m256i yy = _mm256_mulhi_epu16(y8, k19077);
    __m256i rr = _mm256_adds_epi16(
        yy, _mm256_sub_epi16(_mm256_mulhi_epu16(v8v, k26149), c14234));
    __m256i gg = _mm256_sub_epi16(
        _mm256_sub_epi16(_mm256_add_epi16(yy, c8708),
                         _mm256_mulhi_epu16(u8v, k6419)),
        _mm256_mulhi_epu16(v8v, k13320));
    __m256i bb = _mm256_adds_epi16(
        yy, _mm256_sub_epi16(_mm256_mulhi_epu16(u8v, k33050), c17685));
    rr = _mm256_srai_epi16(_mm256_max_epi16(_mm256_min_epi16(rr, vmax), zero), 6);
    gg = _mm256_srai_epi16(_mm256_max_epi16(_mm256_min_epi16(gg, vmax), zero), 6);
    bb = _mm256_srai_epi16(_mm256_max_epi16(_mm256_min_epi16(bb, vmax), zero), 6);
    const __m128i r8 = _mm_packus_epi16(_mm256_castsi256_si128(rr),
                                        _mm256_extracti128_si256(rr, 1));
    const __m128i g8 = _mm_packus_epi16(_mm256_castsi256_si128(gg),
                                        _mm256_extracti128_si256(gg, 1));
    const __m128i b8 = _mm_packus_epi16(_mm256_castsi256_si128(bb),
                                        _mm256_extracti128_si256(bb, 1));
    const __m128i rg0 = _mm_unpacklo_epi8(r8, g8);
    const __m128i rg1 = _mm_unpackhi_epi8(r8, g8);
    const __m128i ba0 = _mm_unpacklo_epi8(b8, a8);
    const __m128i ba1 = _mm_unpackhi_epi8(b8, a8);
    uint8_t* op = o + 4 * (size_t)x;
    _mm_storeu_si128((__m128i*)(op + 0), _mm_unpacklo_epi16(rg0, ba0));
    _mm_storeu_si128((__m128i*)(op + 16), _mm_unpackhi_epi16(rg0, ba0));
    _mm_storeu_si128((__m128i*)(op + 32), _mm_unpacklo_epi16(rg1, ba1));
    _mm_storeu_si128((__m128i*)(op + 48), _mm_unpackhi_epi16(rg1, ba1));
  }
  for (; x < width; x++) yuv2rgba_px(y[x], u[x], v[x], o + 4 * (size_t)x);
}
#endif  // __AVX2__

// Fused RGBA→YUV420 import (reference ImportYUVAFromRGBA fixed-point
// math, picture conversions.go): per-pixel Y, 2x2-accumulated chroma
// with edge replication for odd dimensions.
void wtpu_rgba_to_yuv420(const uint8_t* rgba, int h, int w,
                         uint8_t* yo, uint8_t* uo, uint8_t* vo) {
  constexpr int FIX = 16;
  constexpr int HALF = 1 << (FIX - 1);
  for (int r = 0; r < h; r++) {
    const uint8_t* row = rgba + (size_t)r * w * 4;
    uint8_t* yr = yo + (size_t)r * w;
    for (int c = 0; c < w; c++) {
      int rr = row[4 * c], gg = row[4 * c + 1], bb = row[4 * c + 2];
      yr[c] = (uint8_t)((16839 * rr + 33059 * gg + 6420 * bb + HALF +
                         (16 << FIX)) >> FIX);
    }
  }
  const int ch = (h + 1) >> 1, cw = (w + 1) >> 1;
  for (int r = 0; r < ch; r++) {
    int r0 = 2 * r, r1 = r0 + 1 < h ? r0 + 1 : r0;
    const uint8_t* rowa = rgba + (size_t)r0 * w * 4;
    const uint8_t* rowb = rgba + (size_t)r1 * w * 4;
    uint8_t* ur = uo + (size_t)r * cw;
    uint8_t* vr = vo + (size_t)r * cw;
    for (int c = 0; c < cw; c++) {
      int c0 = 2 * c, c1 = c0 + 1 < w ? c0 + 1 : c0;
      int rs = rowa[4 * c0] + rowa[4 * c1] + rowb[4 * c0] + rowb[4 * c1];
      int gs = rowa[4 * c0 + 1] + rowa[4 * c1 + 1] + rowb[4 * c0 + 1] +
               rowb[4 * c1 + 1];
      int bs = rowa[4 * c0 + 2] + rowa[4 * c1 + 2] + rowb[4 * c0 + 2] +
               rowb[4 * c1 + 2];
      int64_t uu = ((int64_t)-9719 * rs - 19081 * gs + 28800 * bs +
                    ((int64_t)HALF << 2) + ((int64_t)128 << (FIX + 2))) >>
                   (FIX + 2);
      int64_t vv = ((int64_t)28800 * rs - 24116 * gs - 4684 * bs +
                    ((int64_t)HALF << 2) + ((int64_t)128 << (FIX + 2))) >>
                   (FIX + 2);
      ur[c] = (uint8_t)(uu < 0 ? 0 : (uu > 255 ? 255 : uu));
      vr[c] = (uint8_t)(vv < 0 ? 0 : (vv > 255 ? 255 : vv));
    }
  }
}

void wtpu_yuv_to_rgba_fancy(const uint8_t* yp, const uint8_t* up,
                            const uint8_t* vp, int width, int height,
                            int y_stride, int uv_stride, uint8_t* out) {
  const int w2 = (width + 1) >> 1;
  const int h2 = (height + 1) >> 1;
  std::vector<uint8_t> urow(width), vrow(width);

  auto emit_row = [&](int r) {
    const uint8_t* y = yp + (int64_t)r * y_stride;
    uint8_t* o = out + (int64_t)r * width * 4;
#if defined(__AVX2__)
    yuv2rgba_row_avx2(y, urow.data(), vrow.data(), width, o);
#else
    for (int x = 0; x < width; x++)
      yuv2rgba_px(y[x], urow[x], vrow[x], o + 4 * x);
#endif
  };

  // Row 0: self-pair of chroma row 0.
  fancy_row(up, up, w2, width, urow.data(), true);
  fancy_row(vp, vp, w2, width, vrow.data(), true);
  emit_row(0);
  for (int k = 0; k + 1 < h2; k++) {
    const uint8_t* uT = up + (int64_t)k * uv_stride;
    const uint8_t* uB = uT + uv_stride;
    const uint8_t* vT = vp + (int64_t)k * uv_stride;
    const uint8_t* vB = vT + uv_stride;
    if (2 * k + 1 < height) {
      fancy_row(uT, uB, w2, width, urow.data(), true);
      fancy_row(vT, vB, w2, width, vrow.data(), true);
      emit_row(2 * k + 1);
    }
    if (2 * k + 2 < height) {
      fancy_row(uT, uB, w2, width, urow.data(), false);
      fancy_row(vT, vB, w2, width, vrow.data(), false);
      emit_row(2 * k + 2);
    }
  }
  if (height % 2 == 0 && height > 1) {
    const uint8_t* uL = up + (int64_t)(h2 - 1) * uv_stride;
    const uint8_t* vL = vp + (int64_t)(h2 - 1) * uv_stride;
    fancy_row(uL, uL, w2, width, urow.data(), true);
    fancy_row(vL, vL, w2, width, vrow.data(), true);
    emit_row(height - 1);
  }
}

// Host half of the decode split (SURVEY.md §7 "arrays on the device,
// bytes on host"): entropy decode only, exporting dense per-MB tensors for the
// JAX reconstruction engine (gowebp_tpu/ops/vp8_recon_jax.py).
//
// coeffs_out: int16 [mb_h*mb_w][24][16] dequantized coefficients in
//   raster order within each 4x4 block; for i16 MBs the luma DC slots
//   already hold the inverse-WHT result (blocks 0-15 luma, 16-19 U,
//   20-23 V).
// modes_out: uint8 [mb_h*mb_w][21]: [0]=is_i4, [1]=uvmode, [2]=segment,
//   [3]=skip (1 = MB fully empty), [4]=dither-eligible, [5..20]=imodes
//   (i16 MBs: ymode replicated).
// Coefficient-probability update block (RFC 6386 9.8-9.11): the
// ~1100-decision tail of the frame header.  Pure-Python parsing of
// this block costs ~1 ms per image and serializes the batch decoder's
// thread pool on the GIL; this native twin runs it in ~10 us.
// state: in/out [pos, value, range, bit_count]; returns use_skip<<8 |
// skip_p packed, or -1 on exhaustion.
int wtpu_vp8_parse_probs(
    const uint8_t* data, uint64_t size, uint64_t* state,
    const uint8_t* update_probs,      // [1056]
    uint8_t* probs /* inout [1056] */) {
  BoolDec bd;
  bd.data = data; bd.size = size; bd.pos = state[0];
  bd.value = (uint32_t)state[1]; bd.range = (uint32_t)state[2];
  bd.bit_count = (int)state[3];
  bd.flag();   // refresh_entropy_probs (always set for keyframes)
  for (int i = 0; i < 1056; i++) {
    if (bd.get(update_probs[i])) {
      int v = 0;
      for (int b = 0; b < 8; b++) v = (v << 1) | bd.flag();
      probs[i] = (uint8_t)v;
    }
  }
  int use_skip = bd.flag();
  int skip_p = 0;
  if (use_skip) {
    for (int b = 0; b < 8; b++) skip_p = (skip_p << 1) | bd.flag();
  }
  if (bd.exhausted()) return -1;
  state[0] = bd.pos;
  state[1] = bd.value;
  state[2] = bd.range;
  state[3] = (uint64_t)bd.bit_count;
  return (use_skip << 8) | skip_p;
}

int wtpu_vp8_decode_symbols(
    const uint8_t* p0, uint64_t p0_size, uint64_t p0_pos, uint32_t p0_value,
    uint32_t p0_range, uint32_t p0_bitcount,
    const uint8_t* parts, const uint64_t* part_offsets, int num_parts,
    int mb_w, int mb_h,
    int update_map, const uint8_t* segment_probs,
    int use_skip, int skip_p,
    const uint8_t* coeff_probs,          // [4][8][3][11]
    const int32_t* quants,               // [4][6]
    int16_t* coeffs_out, uint8_t* modes_out) {
  std::vector<MB> mbs((size_t)mb_w * mb_h);
  int rc = parse_frame_mbs(p0, p0_size, p0_pos, p0_value, p0_range,
                           p0_bitcount, parts, part_offsets, num_parts,
                           mb_w, mb_h, update_map, segment_probs,
                           use_skip, skip_p, coeff_probs, quants, mbs);
  if (rc != 0) return rc;
  const size_t n = (size_t)mb_w * mb_h;
  for (size_t i = 0; i < n; i++) {
    const MB& mb = mbs[i];
    std::memcpy(coeffs_out + i * 24 * 16, mb.coeffs, 24 * 16 * sizeof(int16_t));
    uint8_t* m = modes_out + i * 21;
    m[0] = mb.is_i4;
    m[1] = mb.uvmode;
    m[2] = mb.segment;
    m[3] = mb.skip;
    m[4] = mb.dither;
    std::memcpy(m + 5, mb.imodes, 16);
  }
  return 0;
}

}  // extern "C"

// ----------------------------------------------------------------------
// Closed-loop i16 encoder dense phase (mode search + FDCT/FWHT + quant +
// exact decoder-mirror reconstruction).  Host production path; the device
// plane engine (ops/encode_plane_jax.py) is the batched open-loop twin.
// ----------------------------------------------------------------------

namespace {

static void fdct4x4(const int16_t* src, const uint8_t* pred, int src_stride,
                    int pred_stride, int16_t* out) {
  int32_t tmp[16];
  for (int i = 0; i < 4; i++) {
    int d0 = src[i * src_stride + 0] - pred[i * pred_stride + 0];
    int d1 = src[i * src_stride + 1] - pred[i * pred_stride + 1];
    int d2 = src[i * src_stride + 2] - pred[i * pred_stride + 2];
    int d3 = src[i * src_stride + 3] - pred[i * pred_stride + 3];
    int a0 = d0 + d3, a1 = d1 + d2, a2 = d1 - d2, a3 = d0 - d3;
    tmp[i * 4 + 0] = (a0 + a1) * 8;
    tmp[i * 4 + 1] = (a2 * 2217 + a3 * 5352 + 1812) >> 9;
    tmp[i * 4 + 2] = (a0 - a1) * 8;
    tmp[i * 4 + 3] = (a3 * 2217 - a2 * 5352 + 937) >> 9;
  }
  for (int i = 0; i < 4; i++) {
    int32_t a0 = tmp[0 + i] + tmp[12 + i];
    int32_t a1 = tmp[4 + i] + tmp[8 + i];
    int32_t a2 = tmp[4 + i] - tmp[8 + i];
    int32_t a3 = tmp[0 + i] - tmp[12 + i];
    out[0 + i] = (int16_t)((a0 + a1 + 7) >> 4);
    out[4 + i] = (int16_t)(((a2 * 2217 + a3 * 5352 + 12000) >> 16) +
                           (a3 != 0));
    out[8 + i] = (int16_t)((a0 - a1 + 7) >> 4);
    out[12 + i] = (int16_t)((a3 * 2217 - a2 * 5352 + 51000) >> 16);
  }
}

static void fwht4x4(const int16_t* dcs, int16_t* out) {
  int32_t tmp[16];
  for (int i = 0; i < 4; i++) {
    int32_t a0 = dcs[i * 4 + 0] + dcs[i * 4 + 3];
    int32_t a1 = dcs[i * 4 + 1] + dcs[i * 4 + 2];
    int32_t a2 = dcs[i * 4 + 1] - dcs[i * 4 + 2];
    int32_t a3 = dcs[i * 4 + 0] - dcs[i * 4 + 3];
    tmp[i * 4 + 0] = a0 + a1;
    tmp[i * 4 + 1] = a3 + a2;
    tmp[i * 4 + 2] = a0 - a1;
    tmp[i * 4 + 3] = a3 - a2;
  }
  for (int i = 0; i < 4; i++) {
    int32_t a0 = tmp[0 + i] + tmp[12 + i];
    int32_t a1 = tmp[4 + i] + tmp[8 + i];
    int32_t a2 = tmp[4 + i] - tmp[8 + i];
    int32_t a3 = tmp[0 + i] - tmp[12 + i];
    out[0 + i] = (int16_t)((a0 + a1) >> 1);
    out[4 + i] = (int16_t)((a3 + a2) >> 1);
    out[8 + i] = (int16_t)((a0 - a1) >> 1);
    out[12 + i] = (int16_t)((a3 - a2) >> 1);
  }
}

struct QP {
  int q, iq, bias;
  void set(int q_, int b8) { q = q_; iq = (1 << 17) / q_; bias = b8 << 9; }
  inline int quantize(int v) const {
    int sign = v < 0;
    int av = sign ? -v : v;
    int lvl = (int)(((int64_t)av * iq + bias) >> 17);
    if (lvl > 2047) lvl = 2047;
    return sign ? -lvl : lvl;
  }
};

// ----------------------------------------------------------------------
// Trellis quantization: exact token-grammar DP over {l0, l0-1} per coeff.
// Cost tables in 1/256-bit units, layout [4][8][3][...] (see cost.py).
// ----------------------------------------------------------------------
struct TrellisTables {
  const uint16_t* p0;    // [4][8][3][2]
  const uint16_t* p1;    // [4][8][3][2]
  const uint16_t* val;   // [4][8][3][68]
};

static inline int tt_p0(const TrellisTables& tt, int t, int b, int c, int bit) {
  return tt.p0[((t * 8 + b) * 3 + c) * 2 + bit];
}
static inline int tt_p1(const TrellisTables& tt, int t, int b, int c, int bit) {
  return tt.p1[((t * 8 + b) * 3 + c) * 2 + bit];
}
static inline int tt_val(const TrellisTables& tt, int t, int b, int c, int v) {
  if (v > 67) v = 67;  // extra-bit tail beyond the table is ~flat
  return tt.val[((t * 8 + b) * 3 + c) * 68 + v];
}

// Exact token-grammar rate of one quantized block (zigzag levels), in
// 1/256-bit units: EOB/continue bits, zero-run bits, value tokens (incl.
// sign as a flat bit).  Neighbor nz contexts are approximated by the
// caller-supplied ctx for the first position and the grammar's own
// value-driven contexts after that.
static int64_t block_rate256(const int16_t* lv, int type, int first, int ctx,
                             const TrellisTables& tt) {
  int64_t r = 0;
  int n = first, c = ctx;
  while (n <= 15) {
    bool more = false;
    for (int z = n; z < 16; z++)
      if (lv[z]) { more = true; break; }
    r += tt_p0(tt, type, kBands[n], c, more ? 1 : 0);
    if (!more) return r;
    while (!lv[n]) {
      r += tt_p1(tt, type, kBands[n], c, 0);
      n++;
      c = 0;
    }
    int v = lv[n] < 0 ? -lv[n] : lv[n];
    r += tt_p1(tt, type, kBands[n], c, 1) + tt_val(tt, type, kBands[n], c, v)
         + 256;
    c = v == 1 ? 1 : 2;
    n++;
  }
  return r;
}

// levels: zigzag in/out; coeffs raster.  Refines nonzero levels in place
// over candidates {l0, max(1, l0-1)} with the exact token-grammar rate.
static void trellis_refine(int16_t* levels, const int16_t* coeffs, int type,
                           int first, int ctx0, int dc_q, int ac_q,
                           int64_t lambda, const TrellisTables& tt) {
  int nz_pos[16], n_nz = 0;
  for (int n = first; n < 16; n++) if (levels[n]) nz_pos[n_nz++] = n;
  if (n_nz == 0) return;

  constexpr int64_t INF = (int64_t)1 << 60;
  struct Node { int64_t score; int prev_cand; };
  Node dp[16][2];
  int cand_level[16][2];

  int64_t start_cost =
      (int64_t)tt_p0(tt, type, kBands[first], ctx0, 1) * lambda;

  for (int k = 0; k < n_nz; k++) {
    int n = nz_pos[k];
    int sign = levels[n] < 0;
    int v0 = sign ? -levels[n] : levels[n];
    int q = n == 0 ? dc_q : ac_q;
    int raw = coeffs[kZigzag[n]];
    int araw = raw < 0 ? -raw : raw;
    for (int cand = 0; cand < 2; cand++) {
      int v = cand == 0 ? v0 : (v0 > 1 ? v0 - 1 : -1);
      dp[k][cand].score = INF;
      dp[k][cand].prev_cand = -1;
      cand_level[k][cand] = 0;
      if (v < 1) continue;
      cand_level[k][cand] = sign ? -v : v;
      int64_t d = (int64_t)(araw - v * q) * (araw - v * q);
      if (k == 0) {
        int64_t rate = 0;
        for (int z = first; z < n; z++)
          rate += tt_p1(tt, type, kBands[z], z == first ? ctx0 : 0, 0);
        int vc = n == first ? ctx0 : 0;
        rate += tt_p1(tt, type, kBands[n], vc, 1)
                + tt_val(tt, type, kBands[n], vc, v) + 256;
        dp[k][cand].score = start_cost + d + rate * lambda;
      } else {
        for (int pc = 0; pc < 2; pc++) {
          if (dp[k - 1][pc].score >= INF) continue;
          int pav = cand_level[k - 1][pc];
          if (pav < 0) pav = -pav;
          int nctx = pav == 1 ? 1 : 2;
          int pn = nz_pos[k - 1];
          int64_t rate = tt_p0(tt, type, kBands[pn + 1], nctx, 1);
          for (int z = pn + 1; z < n; z++)
            rate += tt_p1(tt, type, kBands[z], z == pn + 1 ? nctx : 0, 0);
          int vc = n == pn + 1 ? nctx : 0;
          rate += tt_p1(tt, type, kBands[n], vc, 1)
                  + tt_val(tt, type, kBands[n], vc, v) + 256;
          int64_t s = dp[k - 1][pc].score + d + rate * lambda;
          if (s < dp[k][cand].score) {
            dp[k][cand].score = s;
            dp[k][cand].prev_cand = pc;
          }
        }
      }
    }
  }
  int best_cand = -1;
  int64_t best_end = INF;
  int last_n = nz_pos[n_nz - 1];
  for (int cand = 0; cand < 2; cand++) {
    if (dp[n_nz - 1][cand].score >= INF) continue;
    int64_t s = dp[n_nz - 1][cand].score;
    if (last_n < 15) {
      int av = cand_level[n_nz - 1][cand];
      if (av < 0) av = -av;
      s += (int64_t)tt_p0(tt, type, kBands[last_n + 1], av == 1 ? 1 : 2, 0)
           * lambda;
    }
    if (s < best_end) { best_end = s; best_cand = cand; }
  }
  if (best_cand < 0) return;
  int cand = best_cand;
  for (int k = n_nz - 1; k >= 0; k--) {
    levels[nz_pos[k]] = (int16_t)cand_level[k][cand];
    cand = dp[k][cand].prev_cand;
  }
}

// Quantize raster coeffs to zigzag levels; returns nonzero count.
static int quant_block(const int16_t* coeffs, const QP& dc, const QP& ac,
                       int first, int16_t* levels) {
  int nz = 0;
  for (int n = first; n < 16; n++) {
    int j = kZigzag[n];
    const QP& qp = n == 0 ? dc : ac;
    int lvl = qp.quantize(coeffs[j]);
    levels[n] = (int16_t)lvl;
    nz |= lvl;
  }
  return nz != 0;
}

static void dequant_block(const int16_t* levels, int dc_q, int ac_q,
                          int16_t* out) {
  for (int n = 0; n < 16; n++)
    out[kZigzag[n]] = (int16_t)(levels[n] * (n == 0 ? dc_q : ac_q));
}

}  // namespace

extern "C" {

// Closed-loop dense encode: source planes → levels/modes.
// try_i4: 0 = i16 only; >0 = evaluate 4x4 modes per MB with the
// per-segment mode-bits penalties (distortion units, one RD lambda per
// segment — libwebp derives lambda from each segment's quantizer,
// quant_enc.c.go SetupMatrices) and pick the better of i16/i4.
// imodes_out: mbs*16 sub-block modes (i16 MBs: replicated ymode).
// Layouts match wtpu_vp8_token_stats.  rec planes are scratch outputs.
int wtpu_vp8_encode_frame(
    const uint8_t* y_src, const uint8_t* u_src, const uint8_t* v_src,
    int mb_w, int mb_h, const int32_t* qsteps,  // [4][6]: y1dc..uvac per seg
    int try_i4, const int32_t* i4_penalty,      // [4] per-segment lambda
    int use_derr,                               // UV DC error diffusion
    const uint8_t* segments,                    // per-MB segment id or NULL
    const uint16_t* t_p0, const uint16_t* t_p1, const uint16_t* t_val,
    const int32_t* lambdas,                     // per segment; NULL = no trellis
    int16_t* y2_out, int16_t* yl_out, int16_t* uvl_out,
    uint8_t* ymode_out, uint8_t* uvmode_out, uint8_t* is_i4_out,
    uint8_t* imodes_out,
    uint8_t* y_rec, uint8_t* u_rec, uint8_t* v_rec) {
  const int ys = mb_w * 16, cs = mb_w * 8;
  QP seg_q[4][6];
  for (int s = 0; s < 4; s++) {
    const int32_t* qs = qsteps + s * 6;
    seg_q[s][0].set(qs[0], 96);
    seg_q[s][1].set(qs[1], 110);
    seg_q[s][2].set(qs[2], 96);
    seg_q[s][3].set(qs[3], 96);
    seg_q[s][4].set(qs[4], 110);
    seg_q[s][5].set(qs[5], 110);
  }

  std::vector<uint8_t> ybuf(17 * BUFS), ubuf(9 * BUFS), vbuf(9 * BUFS);
  std::vector<uint8_t> trial(17 * BUFS);
  int16_t src16[16 * 16];
  // UV DC error diffusion state (reference CorrectDCValues /
  // StoreDiffusionErrors, quant_enc.c.go:732-780): per-MB-column top
  // errors [mb_w][ch][2] and the running left errors [ch][2].
  std::vector<int8_t> top_derr((size_t)mb_w * 4, 0);
  int8_t left_derr[4] = {0, 0, 0, 0};

  for (int my = 0; my < mb_h; my++) {
    left_derr[0] = left_derr[1] = left_derr[2] = left_derr[3] = 0;
    for (int mx = 0; mx < mb_w; mx++) {
      size_t m = (size_t)my * mb_w + mx;
      int seg = segments ? segments[m] : 0;
      TrellisTables tt{t_p0, t_p1, t_val};
      int64_t lam = lambdas ? lambdas[seg] : 0;
      bool use_trellis = lambdas != nullptr;
      const QP& y1dc = seg_q[seg][0];
      const QP& y1ac = seg_q[seg][1];
      const QP& y2dc = seg_q[seg][2];
      const QP& y2ac = seg_q[seg][3];
      const QP& uvdc = seg_q[seg][4];
      const QP& uvac = seg_q[seg][5];
      bool ht = my > 0, hl = mx > 0;
      // Borders from the reconstruction planes.
      if (ht) {
        const uint8_t* yt = y_rec + (size_t)(my * 16 - 1) * ys + mx * 16;
        std::memcpy(&ybuf[1], yt, 16);
        if (mx < mb_w - 1) std::memcpy(&ybuf[17], yt + 16, 4);
        else std::memset(&ybuf[17], yt[15], 4);
        const uint8_t* ut = u_rec + (size_t)(my * 8 - 1) * cs + mx * 8;
        const uint8_t* vt = v_rec + (size_t)(my * 8 - 1) * cs + mx * 8;
        std::memcpy(&ubuf[1], ut, 8);
        std::memcpy(&vbuf[1], vt, 8);
        ybuf[0] = hl ? yt[-1] : 129;
        ubuf[0] = hl ? ut[-1] : 129;
        vbuf[0] = hl ? vt[-1] : 129;
      } else {
        std::memset(&ybuf[0], 127, 21);
        std::memset(&ubuf[0], 127, 9);
        std::memset(&vbuf[0], 127, 9);
      }
      for (int r = 0; r < 16; r++)
        ybuf[(1 + r) * BUFS] = hl ? y_rec[(size_t)(my * 16 + r) * ys + mx * 16 - 1] : 129;
      for (int r = 0; r < 8; r++) {
        ubuf[(1 + r) * BUFS] = hl ? u_rec[(size_t)(my * 8 + r) * cs + mx * 8 - 1] : 129;
        vbuf[(1 + r) * BUFS] = hl ? v_rec[(size_t)(my * 8 + r) * cs + mx * 8 - 1] : 129;
      }

      const uint8_t* src = y_src + (size_t)my * 16 * ys + mx * 16;
      std::vector<uint8_t> ybase(ybuf);   // bordered, unpredicted

      // ---- i16 candidate ----
      int best_mode = 0;
      int64_t best_cost = -1;
      for (int mode = 0; mode < 4; mode++) {
        std::memcpy(trial.data(), ybuf.data(), trial.size());
        predict_block(trial.data(), 0, 0, 16, mode, ht, hl);
        int64_t cost = 0;
        for (int r = 0; r < 16; r++)
          for (int ccol = 0; ccol < 16; ccol++) {
            int d = (int)src[r * ys + ccol] - trial[(1 + r) * BUFS + 1 + ccol];
            cost += d * d;
          }
        if (best_cost < 0 || cost < best_cost) { best_cost = cost; best_mode = mode; }
      }
      ymode_out[m] = (uint8_t)best_mode;
      predict_block(ybuf.data(), 0, 0, 16, best_mode, ht, hl);

      for (int r = 0; r < 16; r++)
        for (int cc = 0; cc < 16; cc++) src16[r * 16 + cc] = src[r * ys + cc];

      int16_t coeffs[16][16];
      int16_t dcs[16];
      int16_t* yl = yl_out + m * 256;
      for (int n = 0; n < 16; n++) {
        int r = 4 * (n >> 2), cc = 4 * (n & 3);
        fdct4x4(src16 + r * 16 + cc, &ybuf[(1 + r) * BUFS + 1 + cc], 16, BUFS,
                coeffs[n]);
        dcs[n] = coeffs[n][0];
        for (int k = 0; k < 16; k++) yl[n * 16 + k] = 0;
        quant_block(coeffs[n], y1dc, y1ac, 1, yl + n * 16);
        if (use_trellis)
          trellis_refine(yl + n * 16, coeffs[n], 0, 1, 1,
                         y1dc.q, y1ac.q, lam, tt);
      }
      int16_t y2c[16];
      fwht4x4(dcs, y2c);
      int16_t* y2l = y2_out + m * 16;
      for (int k = 0; k < 16; k++) y2l[k] = 0;
      quant_block(y2c, y2dc, y2ac, 0, y2l);
      if (use_trellis)
        trellis_refine(y2l, y2c, 1, 0, 1, y2dc.q, y2ac.q, lam, tt);

      // Reconstruction (i16).
      int16_t y2_deq[16];
      dequant_block(y2l, y2dc.q, y2ac.q, y2_deq);
      int y2_nz = 0;
      for (int k = 1; k < 16; k++) y2_nz |= y2l[k];
      int32_t rdcs[16];
      if (y2_nz) {
        iwht4x4(y2_deq, rdcs);
      } else {
        int32_t dc0 = (y2_deq[0] + 3) >> 3;
        for (int k = 0; k < 16; k++) rdcs[k] = dc0;
      }
      for (int n = 0; n < 16; n++) {
        int r = 4 * (n >> 2), cc = 4 * (n & 3);
        int16_t deq[16];
        dequant_block(yl + n * 16, y1dc.q, y1ac.q, deq);
        deq[0] = (int16_t)rdcs[n];
        bool any = false;
        for (int k = 0; k < 16; k++) if (deq[k]) { any = true; break; }
        if (any) idct_add(deq, &ybuf[(1 + r) * BUFS + 1 + cc], BUFS);
      }
      is_i4_out[m] = 0;
      for (int n = 0; n < 16; n++) imodes_out[m * 16 + n] = (uint8_t)best_mode;

      // ---- i4 candidate (optional) ----
      if (try_i4) {
        int64_t d16 = 0;
        for (int r = 0; r < 16; r++)
          for (int cc = 0; cc < 16; cc++) {
            int d = (int)src[r * ys + cc] - ybuf[(1 + r) * BUFS + 1 + cc];
            d16 += d * d;
          }
        const bool have_tt = t_p0 != nullptr;
        // i16 luma rate: exact token costs when tables are present,
        // else the flat per-nonzero model.
        int64_t rate16_256 = 0;
        int nz16 = 0;
        if (have_tt) {
          rate16_256 = block_rate256(y2l, 1, 0, 1, tt);
          for (int n = 0; n < 16; n++)
            rate16_256 += block_rate256(yl + n * 16, 0, 1, 1, tt);
        } else {
          for (int k = 0; k < 16; k++) nz16 += y2l[k] != 0;
          for (int n = 0; n < 16; n++)
            for (int k = 1; k < 16; k++) nz16 += yl[n * 16 + k] != 0;
        }
        std::vector<uint8_t> yb4(ybase);
        // Top-right replication for right-column sub-blocks.
        if (!ht) { /* row of 127s already covers 17..20 */ }
        for (int rr = 4; rr <= 12; rr += 4)
          std::memcpy(&yb4[rr * BUFS + 17], &yb4[17], 4);
        int16_t yl4[16][16];
        uint8_t modes4[16];
        // Per-block rate-aware RD: score = dist + lam*(20*nz + mode_bits)
        // >> 11, with approximate per-mode header bits (DC is near-free
        // in the kf bmode trees; diagonal modes cost the most).  The
        // same scores accumulate into the i4-vs-i16 comparison, so the
        // selection and the final decision optimize the same objective.
        static const int kMode4Bits[10] = {8, 22, 24, 24, 30, 32, 30, 32,
                                           32, 30};
        // 1/256-bit header-cost estimates of the 10 kf bmode symbols
        // (DC near-free under the default trees; diagonals the dearest).
        static const int kMode4Bits256[10] = {256, 704, 768, 768, 960, 1024,
                                              960, 1024, 1024, 960};
        int64_t lamq = i4_penalty[seg];
        int64_t s4 = 0;
        int64_t s16 = have_tt
            ? d16 + ((lamq * rate16_256) >> 16)
            : d16 + ((lamq * (int64_t)(nz16 * 20)) >> 11);
        int blocks_done = 0;
        for (int n = 0; n < 16 && s4 < s16; n++, blocks_done++) {
          int r = 4 * (n >> 2), cc = 4 * (n & 3);
          int64_t bcost = -1;
          int bmode = 0;
          int16_t blevels[16];
          uint8_t brecon[16];
          for (int mode = 0; mode < 10; mode++) {
            predict_luma4(yb4.data(), cc, r, mode);
            // Transform/quant/recon on a copy of the predicted block.
            uint8_t blk[16];
            for (int k = 0; k < 4; k++)
              std::memcpy(blk + 4 * k, &yb4[(r + 1 + k) * BUFS + cc + 1], 4);
            int16_t cf[16], lv[16], dq[16];
            fdct4x4(src16 + r * 16 + cc, blk, 16, 4, cf);
            for (int k = 0; k < 16; k++) lv[k] = 0;
            quant_block(cf, y1dc, y1ac, 0, lv);
            if (use_trellis)
              trellis_refine(lv, cf, 3, 0, 1, y1dc.q, y1ac.q, lam, tt);
            dequant_block(lv, y1dc.q, y1ac.q, dq);
            bool any = false;
            int nzb = 0;
            for (int k = 0; k < 16; k++) nzb += lv[k] != 0;
            for (int k = 0; k < 16; k++) if (dq[k]) { any = true; break; }
            uint8_t rec[16];
            std::memcpy(rec, blk, 16);
            if (any) idct_add(dq, rec, 4);
            int64_t dist = 0;
            for (int k = 0; k < 16; k++) {
              int d = (int)src16[(r + (k >> 2)) * 16 + cc + (k & 3)] - rec[k];
              dist += d * d;
            }
            int64_t cost = have_tt
                ? dist + ((lamq * (block_rate256(lv, 3, 0, 1, tt)
                                   + kMode4Bits256[mode])) >> 16)
                : dist + ((lamq * (int64_t)(20 * nzb + kMode4Bits[mode]))
                          >> 11);
            if (bcost < 0 || cost < bcost) {
              bcost = cost;
              bmode = mode;
              std::memcpy(blevels, lv, sizeof(lv));
              std::memcpy(brecon, rec, 16);
            }
          }
          // Commit best mode's reconstruction as context for the next block.
          for (int k = 0; k < 4; k++)
            std::memcpy(&yb4[(r + 1 + k) * BUFS + cc + 1], brecon + 4 * k, 4);
          modes4[n] = (uint8_t)bmode;
          std::memcpy(yl4[n], blevels, sizeof(blevels));
          s4 += bcost;
        }
        if (blocks_done == 16 && s4 < s16) {
          // Adopt the i4 candidate.
          is_i4_out[m] = 1;
          for (int k = 0; k < 16; k++) y2l[k] = 0;
          for (int n = 0; n < 16; n++) {
            imodes_out[m * 16 + n] = modes4[n];
            std::memcpy(yl + n * 16, yl4[n], sizeof(yl4[n]));
          }
          std::memcpy(ybuf.data(), yb4.data(), ybuf.size());
        }
      }

      // Chroma.
      const uint8_t* us = u_src + (size_t)my * 8 * cs + mx * 8;
      const uint8_t* vs = v_src + (size_t)my * 8 * cs + mx * 8;
      best_mode = 0;
      best_cost = -1;
      for (int mode = 0; mode < 4; mode++) {
        std::memcpy(trial.data(), ubuf.data(), 9 * BUFS);
        predict_block(trial.data(), 0, 0, 8, mode, ht, hl);
        int64_t cost = 0;
        for (int r = 0; r < 8; r++)
          for (int cc = 0; cc < 8; cc++) {
            int d = (int)us[r * cs + cc] - trial[(1 + r) * BUFS + 1 + cc];
            cost += d * d;
          }
        std::memcpy(trial.data(), vbuf.data(), 9 * BUFS);
        predict_block(trial.data(), 0, 0, 8, mode, ht, hl);
        for (int r = 0; r < 8; r++)
          for (int cc = 0; cc < 8; cc++) {
            int d = (int)vs[r * cs + cc] - trial[(1 + r) * BUFS + 1 + cc];
            cost += d * d;
          }
        if (best_cost < 0 || cost < best_cost) { best_cost = cost; best_mode = mode; }
      }
      uvmode_out[m] = (uint8_t)best_mode;
      predict_block(ubuf.data(), 0, 0, 8, best_mode, ht, hl);
      predict_block(vbuf.data(), 0, 0, 8, best_mode, ht, hl);
      int16_t* uvl = uvl_out + m * 128;
      for (int half = 0; half < 2; half++) {
        const uint8_t* cp = half == 0 ? us : vs;
        uint8_t* cb = half == 0 ? ubuf.data() : vbuf.data();
        int8_t* dtop = &top_derr[((size_t)mx * 2 + half) * 2];
        int8_t* dleft = &left_derr[half * 2];
        int e0 = 0, e1 = 0, e2 = 0, e3 = 0;
        int16_t csrc[64];
        for (int r = 0; r < 8; r++)
          for (int cc = 0; cc < 8; cc++) csrc[r * 8 + cc] = cp[r * cs + cc];
        for (int n = 0; n < 4; n++) {
          int r = 4 * (n >> 1), cc = 4 * (n & 1);
          int16_t cf[16];
          fdct4x4(csrc + r * 8 + cc, &cb[(1 + r) * BUFS + 1 + cc], 8, BUFS, cf);
          if (use_derr) {
            // Diffuse quantization error of earlier DCs into this DC
            // (weights 7/16 from above, 8/16 from the left; the
            // missing 1/16 damps chessboard artefacts at q~0).
            int corr;
            if (n == 0)      corr = (7 * dtop[0] + 8 * dleft[0]) >> 3;
            else if (n == 1) corr = (7 * dtop[1] + 8 * e0) >> 3;
            else if (n == 2) corr = (7 * e0 + 8 * dleft[1]) >> 3;
            else             corr = (7 * e1 + 8 * e2) >> 3;
            cf[0] = (int16_t)(cf[0] + corr);
            int V = cf[0];
            int sgn = V < 0;
            if (sgn) V = -V;
            int lvl = (int)(((int64_t)V * uvdc.iq + uvdc.bias) >> 17);
            if (lvl > 2047) lvl = 2047;
            int err = V - lvl * uvdc.q;
            if (sgn) err = -err;
            err >>= 1;                 // DSCALE
            (n == 0 ? e0 : n == 1 ? e1 : n == 2 ? e2 : e3) = err;
          }
          int16_t* lv = uvl + (half * 4 + n) * 16;
          for (int k = 0; k < 16; k++) lv[k] = 0;
          quant_block(cf, uvdc, uvac, 0, lv);
          if (use_trellis)
            trellis_refine(lv, cf, 2, 0, 1, uvdc.q, uvac.q, lam, tt);
          int16_t deq[16];
          dequant_block(lv, uvdc.q, uvac.q, deq);
          bool any = false;
          for (int k = 0; k < 16; k++) if (deq[k]) { any = true; break; }
          if (any) idct_add(deq, &cb[(1 + r) * BUFS + 1 + cc], BUFS);
        }
        if (use_derr) {
          // StoreDiffusionErrors: split err3 between left and top.
          int lv1 = (3 * e3) >> 2;
          dleft[0] = (int8_t)e1;
          dleft[1] = (int8_t)lv1;
          dtop[0] = (int8_t)e2;
          dtop[1] = (int8_t)(e3 - lv1);
        }
      }

      // Store reconstruction.
      for (int r = 0; r < 16; r++)
        std::memcpy(y_rec + (size_t)(my * 16 + r) * ys + mx * 16,
                    &ybuf[(1 + r) * BUFS + 1], 16);
      for (int r = 0; r < 8; r++) {
        std::memcpy(u_rec + (size_t)(my * 8 + r) * cs + mx * 8,
                    &ubuf[(1 + r) * BUFS + 1], 8);
        std::memcpy(v_rec + (size_t)(my * 8 + r) * cs + mx * 8,
                    &vbuf[(1 + r) * BUFS + 1], 8);
      }
    }
  }
  return 0;
}

}  // extern "C"

// ----------------------------------------------------------------------
// Sparse coefficient-upload pack (ops/coeff_pack.py's native twin).
// Re-compresses the symbol engines' dequantized (N, 24, 16) int16
// coefficients into int8 zigzag levels + i16-DC side plane + tail /
// raw-exception tables for the device-resident decode path.  Bit-exact
// with the numpy reference (suite-pinned); ~7x its host cost.
// ----------------------------------------------------------------------

namespace {
static const int kPackZZ[16] = {0, 1, 4, 8, 5, 2, 3, 6,
                                9, 12, 13, 10, 7, 11, 14, 15};

struct PackBlockInfo {
  int16_t lv[16];   // zigzag-order levels (valid when ok)
  int eob;          // last nonzero zigzag position + 1 (0 = empty)
  bool ok;          // divisible and |level| <= 127
};

static inline void pack_block(const int16_t* c, int q_dc, int q_ac,
                              bool drop_dc, PackBlockInfo& out) {
  out.eob = 0;
  out.ok = true;
  for (int n = 0; n < 16; n++) {
    int32_t v = c[kPackZZ[n]];
    if (n == 0 && drop_dc) v = 0;
    if (v == 0) {
      out.lv[n] = 0;
      continue;
    }
    const int32_t q = n == 0 ? q_dc : q_ac;
    const int32_t lvl = v / q;
    if (lvl * q != v || lvl > 127 || lvl < -127) out.ok = false;
    out.lv[n] = (int16_t)lvl;
    out.eob = n + 1;
  }
}
}  // namespace

// First pass: exception/tail counts for the K chooser.
// out_counts = [n_base, n_tail4, n_tail8] (tails exclude base blocks).
extern "C" void wtpu_vp8_pack_stats(
    const int16_t* coeffs, const uint8_t* seg, const uint8_t* is_i4,
    const int32_t* qmat /* [B][4][6] */, int B, int N,
    int32_t* out_counts) {
  int64_t n_base = 0, n_t4 = 0, n_t8 = 0;
  for (int b = 0; b < B; b++) {
    const int32_t* qm = qmat + (size_t)b * 24;
    for (int i = 0; i < N; i++) {
      const size_t mb = (size_t)b * N + i;
      const int32_t* q = qm + seg[mb] * 6;
      const bool i16 = is_i4[mb] == 0;
      const int16_t* c = coeffs + mb * 24 * 16;
      for (int blk = 0; blk < 24; blk++, c += 16) {
        const bool luma = blk < 16;
        PackBlockInfo bi;
        pack_block(c, luma ? q[0] : q[4], luma ? q[1] : q[5],
                   luma && i16, bi);
        // eob from RAW values (matches the numpy reference, which
        // ranks truncation by the raw nonzero pattern incl. WHT DCs)
        int raw_eob = 0;
        for (int n = 0; n < 16; n++)
          if (c[kPackZZ[n]] != 0) raw_eob = n + 1;
        if (!bi.ok) {
          n_base++;
        } else {
          if (raw_eob > 8) n_t8++;
          if (raw_eob > 4) n_t4++;
        }
      }
    }
  }
  out_counts[0] = (int32_t)n_base;
  out_counts[1] = (int32_t)n_t4;
  out_counts[2] = (int32_t)n_t8;
}

// Second pass: emit the wire layout for a chosen K.  Returns 0 on
// success; 1 when a table overflowed its capacity (counts_out then
// holds the required sizes and the caller re-calls with larger caps).
extern "C" int wtpu_vp8_pack_emit(
    const int16_t* coeffs, const uint8_t* seg, const uint8_t* is_i4,
    const int32_t* qmat, int B, int N, int K,
    int8_t* lv8 /* [B*N][24][K] */, int16_t* dc16 /* [B*N][16] */,
    int32_t* tail_idx, int8_t* tail_val /* [tail_cap][16-K] */,
    int64_t tail_cap,
    int32_t* exc_idx, int16_t* exc_val /* [exc_cap][16] */,
    int64_t exc_cap, int64_t* counts_out /* [ntail, nexc] */) {
  const int tw = 16 - K;
  int64_t ntail = 0, nexc = 0;
  for (int b = 0; b < B; b++) {
    const int32_t* qm = qmat + (size_t)b * 24;
    for (int i = 0; i < N; i++) {
      const size_t mb = (size_t)b * N + i;
      const int32_t* q = qm + seg[mb] * 6;
      const bool i16 = is_i4[mb] == 0;
      const int16_t* c = coeffs + mb * 24 * 16;
      int16_t* dcrow = dc16 + mb * 16;
      for (int blk = 0; blk < 24; blk++, c += 16) {
        const bool luma = blk < 16;
        if (luma) dcrow[blk] = (i16 ? c[0] : 0);
        PackBlockInfo bi;
        pack_block(c, luma ? q[0] : q[4], luma ? q[1] : q[5],
                   luma && i16, bi);
        int raw_eob = 0;
        for (int n = 0; n < 16; n++)
          if (c[kPackZZ[n]] != 0) raw_eob = n + 1;
        int8_t* out = lv8 + (mb * 24 + blk) * K;
        if (!bi.ok) {
          std::memset(out, 0, K);
          if (nexc < exc_cap) {
            exc_idx[nexc] = (int32_t)(mb * 24 + blk);
            int16_t* ev = exc_val + nexc * 16;
            for (int n = 0; n < 16; n++) {
              int32_t v = c[kPackZZ[n]];
              ev[n] = (int16_t)v;
            }
          }
          nexc++;
          continue;
        }
        for (int n = 0; n < K; n++) out[n] = (int8_t)bi.lv[n];
        if (K < 16 && raw_eob > K) {
          if (ntail < tail_cap) {
            tail_idx[ntail] = (int32_t)(mb * 24 + blk);
            int8_t* tv = tail_val + ntail * tw;
            for (int n = K; n < 16; n++) tv[n - K] = (int8_t)bi.lv[n];
          }
          ntail++;
        }
      }
    }
  }
  counts_out[0] = ntail;
  counts_out[1] = nexc;
  return (ntail > tail_cap || nexc > exc_cap) ? 1 : 0;
}
