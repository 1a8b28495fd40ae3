// Native encode emission: VP8 boolean-coded token streams and VP8L
// LSB-first Huffman emission, driven from per-MB/per-op tensors produced
// by the (NumPy or device) dense phase.
//
// Mirrors the decode semantics in vp8_dec.cpp exactly (same contexts,
// same token tree); the Python emitter (models/vp8/encoder.py) is the
// correctness oracle.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>

extern "C" {
static void prefix_encode_c(int value, int* code, int* nbits, int* bits);
}

#include "vp8_tables.h"

namespace {

// ----------------------------------------------------------------------
// Boolean encoder (RFC 6386, carry-propagating).
// ----------------------------------------------------------------------
struct BoolEnc {
  std::vector<uint8_t> buf;
  uint64_t bottom = 0;
  uint32_t range = 255;
  int bit_count = 24;

  inline void carry() {
    int i = (int)buf.size() - 1;
    while (i >= 0 && buf[i] == 0xff) buf[i--] = 0;
    if (i >= 0) buf[i]++;
  }
  inline void put(int bit, int prob) {
    uint32_t split = 1 + (((range - 1) * (uint32_t)prob) >> 8);
    if (bit) {
      bottom += split;
      if (bottom >> 32) { carry(); bottom &= 0xffffffffull; }
      range -= split;
    } else {
      range = split;
    }
    while (range < 128) {
      range <<= 1;
      if (bottom & 0x80000000ull) carry();
      bottom = (bottom << 1) & 0xffffffffull;
      if (--bit_count == 0) {
        buf.push_back((uint8_t)(bottom >> 24));
        bottom &= 0xffffff;
        bit_count = 8;
      }
    }
  }
  void finish() {
    for (int i = 0; i < 32; i++) {
      if (bottom & 0x80000000ull) carry();
      bottom = (bottom << 1) & 0xffffffffull;
      if (--bit_count == 0) {
        buf.push_back((uint8_t)(bottom >> 24));
        bottom &= 0xffffff;
        bit_count = 8;
      }
    }
  }
};

// ----------------------------------------------------------------------
// Token walk over one 4x4 block of levels (zigzag order).
// Sink: either count stats or emit bits.
// ----------------------------------------------------------------------
struct StatsSink {
  int64_t* stats;  // [4][8][3][11][2]
  inline void bit(int t, int b, int c, int p, int v) {
    stats[(((t * 8 + b) * 3 + c) * 11 + p) * 2 + v]++;
  }
  inline void fixed(int, int) {}
};

struct EmitSink {
  BoolEnc* enc;
  const uint8_t* probs;  // [4][8][3][11]
  inline void bit(int t, int b, int c, int p, int v) {
    enc->put(v, probs[((t * 8 + b) * 3 + c) * 11 + p]);
  }
  inline void fixed(int prob, int v) { enc->put(v, prob); }
};

template <typename Sink>
static void record_large(Sink& s, int t, int b, int c, int v) {
  if (v <= 4) {
    s.bit(t, b, c, 3, 0);
    if (v == 2) s.bit(t, b, c, 4, 0);
    else { s.bit(t, b, c, 4, 1); s.bit(t, b, c, 5, v - 3); }
    return;
  }
  s.bit(t, b, c, 3, 1);
  if (v <= 10) {
    s.bit(t, b, c, 6, 0);
    if (v <= 6) { s.bit(t, b, c, 7, 0); s.fixed(159, v - 5); }
    else {
      s.bit(t, b, c, 7, 1);
      s.fixed(165, (v - 7) >> 1);
      s.fixed(145, (v - 7) & 1);
    }
    return;
  }
  s.bit(t, b, c, 6, 1);
  for (int cat = 0; cat < 4; cat++) {
    int base = 3 + (8 << cat);
    int span = 1 << kCatBits[cat];
    if (v < base + span || cat == 3) {
      int bit1 = cat >> 1, bit0 = cat & 1;
      s.bit(t, b, c, 8, bit1);
      s.bit(t, b, c, 9 + bit1, bit0);
      int residue = v - base;
      if (residue >= span) residue = span - 1;
      for (int k = kCatBits[cat] - 1; k >= 0; k--)
        s.fixed(kCatProbas[cat][kCatBits[cat] - 1 - k], (residue >> k) & 1);
      return;
    }
  }
}

// Returns nz (last nonzero position + 1, or `first` when empty).
template <typename Sink>
static int record_coeffs(Sink& s, int t, const int16_t* levels, int ctx,
                         int first) {
  int last = -1;
  for (int n = 15; n >= first; n--)
    if (levels[n]) { last = n; break; }
  if (last < 0) {
    s.bit(t, kBands[first], ctx, 0, 0);
    return first;
  }
  int n = first;
  int b = kBands[n], c = ctx;
  while (n <= last) {
    s.bit(t, b, c, 0, 1);
    while (levels[n] == 0) {
      s.bit(t, b, c, 1, 0);
      n++;
      b = kBands[n];
      c = 0;
    }
    s.bit(t, b, c, 1, 1);
    int v = levels[n];
    int sign = v < 0;
    int av = sign ? -v : v;
    int next_c;
    if (av == 1) { s.bit(t, b, c, 2, 0); next_c = 1; }
    else { s.bit(t, b, c, 2, 1); record_large(s, t, b, c, av); next_c = 2; }
    s.fixed(128, sign);
    n++;
    if (n == 16) return 16;
    b = kBands[n];
    c = next_c;
  }
  s.bit(t, b, c, 0, 0);
  return last + 1;
}

struct Ctx2 { uint32_t nz = 0, nz_dc = 0; };

// Walk one MB; returns true if the MB is entirely empty.
template <typename Sink>
static bool walk_mb(Sink& s, const int16_t* y2, const int16_t* yl,
                    const int16_t* uvl, int is_i4, Ctx2& above, Ctx2& left,
                    bool emit_tokens) {
  // Compute emptiness up-front (decides skip).
  bool empty = true;
  if (!is_i4) {
    for (int i = 0; i < 16 && empty; i++) if (y2[i]) empty = false;
  }
  int first = is_i4 ? 0 : 1;
  for (int bi = 0; bi < 16 && empty; bi++)
    for (int n = first; n < 16; n++)
      if (yl[bi * 16 + n]) { empty = false; break; }
  for (int bi = 0; bi < 8 && empty; bi++)
    for (int n = 0; n < 16; n++)
      if (uvl[bi * 16 + n]) { empty = false; break; }

  if (!emit_tokens || empty) {
    // Context update mirrors the decoder's skip path.
    above.nz = 0;
    left.nz = 0;
    if (!is_i4) { above.nz_dc = 0; left.nz_dc = 0; }
    return empty;
  }

  int t_ac;
  if (!is_i4) {
    int ctx = (int)(above.nz_dc + left.nz_dc);
    int nz = record_coeffs(s, 1, y2, ctx, 0);
    above.nz_dc = left.nz_dc = (nz > 0);
    t_ac = 0;
  } else {
    t_ac = 3;
  }
  uint32_t tnz = above.nz & 0x0f, lnz = left.nz & 0x0f;
  for (int yy = 0; yy < 4; yy++) {
    uint32_t l = lnz & 1;
    for (int xx = 0; xx < 4; xx++) {
      int ctx = (int)(l + (tnz & 1));
      int nz = record_coeffs(s, t_ac, yl + (4 * yy + xx) * 16, ctx, first);
      l = nz > first;
      tnz = (tnz >> 1) | (l << 7);
    }
    tnz >>= 4;
    lnz = (lnz >> 1) | (l << 7);
  }
  uint32_t out_t = tnz, out_l = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    tnz = (above.nz >> (4 + ch)) & 0xff;
    lnz = (left.nz >> (4 + ch)) & 0xff;
    uint32_t l = 0;
    for (int yy = 0; yy < 2; yy++) {
      l = lnz & 1;
      for (int xx = 0; xx < 2; xx++) {
        int ctx = (int)(l + (tnz & 1));
        int nz = record_coeffs(s, 2, uvl + (2 * ch + 2 * yy + xx) * 16, ctx, 0);
        l = nz > 0;
        tnz = (tnz >> 1) | (l << 3);
      }
      tnz >>= 2;
      lnz = (lnz >> 1) | (l << 5);
    }
    out_t |= (tnz << 4) << ch;
    out_l |= (lnz & 0xf0) << ch;
  }
  above.nz = out_t;
  left.nz = out_l;
  return false;
}

}  // namespace

extern "C" {

// Pass 1: statistics + skip flags.  Layouts (per MB, raster):
//   y2:  mbs*16 int16   yl: mbs*16*16   uvl: mbs*8*16
int wtpu_vp8_token_stats(const int16_t* y2, const int16_t* yl,
                         const int16_t* uvl, const uint8_t* is_i4,
                         int mb_w, int mb_h,
                         int64_t* stats, uint8_t* skip_out) {
  StatsSink sink{stats};
  std::vector<Ctx2> above(mb_w);
  for (int my = 0; my < mb_h; my++) {
    Ctx2 left;
    for (int mx = 0; mx < mb_w; mx++) {
      size_t m = (size_t)my * mb_w + mx;
      bool empty = walk_mb(sink, y2 + m * 16, yl + m * 256, uvl + m * 128,
                           is_i4[m], above[mx], left, true);
      skip_out[m] = empty;
    }
  }
  return 0;
}

// Pass 2: emit the token partition with finalized probabilities.
// skip_flags: from pass 1; use_skip: whether skipped MBs are elided.
int wtpu_vp8_token_emit(const int16_t* y2, const int16_t* yl,
                        const int16_t* uvl, const uint8_t* is_i4,
                        int mb_w, int mb_h, const uint8_t* probs,
                        int use_skip, const uint8_t* skip_flags,
                        uint8_t** out_data, uint64_t* out_size) {
  BoolEnc enc;
  EmitSink sink{&enc, probs};
  std::vector<Ctx2> above(mb_w);
  for (int my = 0; my < mb_h; my++) {
    Ctx2 left;
    for (int mx = 0; mx < mb_w; mx++) {
      size_t m = (size_t)my * mb_w + mx;
      bool emit = !(use_skip && skip_flags[m]);
      walk_mb(sink, y2 + m * 16, yl + m * 256, uvl + m * 128, is_i4[m],
              above[mx], left, emit);
    }
  }
  enc.finish();
  uint8_t* out = (uint8_t*)std::malloc(enc.buf.size());
  std::memcpy(out, enc.buf.data(), enc.buf.size());
  *out_data = out;
  *out_size = enc.buf.size();
  return 0;
}

// Multi-partition emit: MB row r goes to partition (r & (num_parts-1)).
// out_data receives one malloc'd buffer of all partitions concatenated;
// out_sizes[i] = byte size of partition i.
int wtpu_vp8_token_emit_multi(const int16_t* y2, const int16_t* yl,
                              const int16_t* uvl, const uint8_t* is_i4,
                              int mb_w, int mb_h, const uint8_t* probs,
                              int use_skip, const uint8_t* skip_flags,
                              int num_parts,
                              uint8_t** out_data, uint64_t* out_sizes,
                              uint64_t* total_size) {
  std::vector<BoolEnc> encs(num_parts);
  std::vector<Ctx2> above(mb_w);
  for (int my = 0; my < mb_h; my++) {
    Ctx2 left;
    EmitSink sink{&encs[my & (num_parts - 1)], probs};
    for (int mx = 0; mx < mb_w; mx++) {
      size_t m = (size_t)my * mb_w + mx;
      bool emit = !(use_skip && skip_flags[m]);
      walk_mb(sink, y2 + m * 16, yl + m * 256, uvl + m * 128, is_i4[m],
              above[mx], left, emit);
    }
  }
  uint64_t total = 0;
  for (int i = 0; i < num_parts; i++) {
    encs[i].finish();
    out_sizes[i] = encs[i].buf.size();
    total += encs[i].buf.size();
  }
  uint8_t* out = (uint8_t*)std::malloc(total ? total : 1);
  uint64_t off = 0;
  for (int i = 0; i < num_parts; i++) {
    std::memcpy(out + off, encs[i].buf.data(), encs[i].buf.size());
    off += encs[i].buf.size();
  }
  *out_data = out;
  *total_size = total;
  return 0;
}

// Partition-0 mode syntax: segment ids, skip flags, intra modes for all
// MBs, continuing a boolean-encoder state handed over from Python.
// Returns the complete partition-0 byte buffer (prefix + modes), WITHOUT
// the final flush (Python finishes remaining headers? no - this is the
// tail, so we flush here).
int wtpu_vp8_write_modes(
    const uint8_t* prefix, uint64_t prefix_size,
    uint64_t bottom, uint32_t range, int bit_count,
    const uint8_t* ymodes, const uint8_t* uvmodes, const uint8_t* is_i4,
    const uint8_t* imodes, const uint8_t* skips, const uint8_t* segments,
    int mb_w, int mb_h,
    int use_skip, int skip_p, const uint8_t* seg_probs,
    uint8_t** out_data, uint64_t* out_size) {
  BoolEnc enc;
  enc.buf.assign(prefix, prefix + prefix_size);
  enc.bottom = bottom;
  enc.range = range;
  enc.bit_count = bit_count;

  std::vector<uint8_t> intra_t((size_t)4 * mb_w, 0);
  // Tree paths for the 10 bmodes through kBModeTree.
  // path[m] = list of (prob_idx, bit); precomputed once.
  static int path_len[10];
  static int path_prob[10][8];
  static int path_bit[10][8];
  static bool init_done = false;
  if (!init_done) {
    for (int m = 0; m < 10; m++) path_len[m] = 0;
    // DFS over the tree.
    struct Walk {
      static void go(int pair, int prob, int* stack_p, int* stack_b, int d) {
        for (int bit = 0; bit < 2; bit++) {
          int nxt = kBModeTree[pair + bit];
          stack_p[d] = prob;
          stack_b[d] = bit;
          if (nxt <= 0) {
            int m = -nxt;
            path_len[m] = d + 1;
            for (int i = 0; i <= d; i++) {
              path_prob[m][i] = stack_p[i];
              path_bit[m][i] = stack_b[i];
            }
          } else {
            go(2 * nxt, nxt, stack_p, stack_b, d + 1);
          }
        }
      }
    };
    int sp[8], sb[8];
    Walk::go(0, 0, sp, sb, 0);
    init_done = true;
  }

  for (int my = 0; my < mb_h; my++) {
    uint8_t intra_l[4] = {0, 0, 0, 0};
    for (int mx = 0; mx < mb_w; mx++) {
      size_t m = (size_t)my * mb_w + mx;
      if (seg_probs) {
        int sid = segments ? segments[m] : 0;
        if (sid < 2) {
          enc.put(0, seg_probs[0]);
          enc.put(sid, seg_probs[1]);
        } else {
          enc.put(1, seg_probs[0]);
          enc.put(sid - 2, seg_probs[2]);
        }
      }
      if (use_skip) enc.put(skips[m] ? 1 : 0, skip_p);
      uint8_t* top4 = intra_t.data() + 4 * mx;
      if (!is_i4[m]) {
        enc.put(1, 145);
        int mode = ymodes[m];
        if (mode == 0) { enc.put(0, 156); enc.put(0, 163); }
        else if (mode == 2) { enc.put(0, 156); enc.put(1, 163); }
        else if (mode == 3) { enc.put(1, 156); enc.put(0, 128); }
        else { enc.put(1, 156); enc.put(1, 128); }
        std::memset(top4, mode, 4);
        std::memset(intra_l, mode, 4);
      } else {
        enc.put(0, 145);
        for (int yy = 0; yy < 4; yy++) {
          int ymode = intra_l[yy];
          for (int xx = 0; xx < 4; xx++) {
            const uint8_t* prob = kBModeProbas + (top4[xx] * 10 + ymode) * 9;
            int mode = imodes[m * 16 + 4 * yy + xx];
            for (int i = 0; i < path_len[mode]; i++)
              enc.put(path_bit[mode][i], prob[path_prob[mode][i]]);
            top4[xx] = (uint8_t)mode;
            ymode = mode;
          }
          intra_l[yy] = (uint8_t)ymode;
        }
      }
      int uv = uvmodes[m];
      if (uv == 0) enc.put(0, 142);
      else if (uv == 2) { enc.put(1, 142); enc.put(0, 114); }
      else if (uv == 1) { enc.put(1, 142); enc.put(1, 114); enc.put(1, 183); }
      else { enc.put(1, 142); enc.put(1, 114); enc.put(0, 183); }
    }
  }
  enc.finish();
  uint8_t* out = (uint8_t*)std::malloc(enc.buf.size());
  std::memcpy(out, enc.buf.data(), enc.buf.size());
  *out_data = out;
  *out_size = enc.buf.size();
  return 0;
}

void wtpu_free(void* p) { std::free(p); }

// Hash-chain LZ77 with optional color cache (the reference's
// VP8LHashChainFill + BackwardReferencesLz77 + local-cache rewrite,
// re-implemented fresh; SURVEY.md §2.6).
int64_t wtpu_vp8l_hashchain_refs(const uint32_t* flat, int64_t n, int width,
                                 int depth, int cache_bits,
                                 uint8_t* ops, uint32_t* argbs,
                                 int32_t* lengths, int32_t* dists) {
  constexpr int HASH_BITS = 18;
  constexpr int64_t WINDOW = (1 << 20) - 126;
  constexpr int MAX_LEN = 4095;
  std::vector<int32_t> head((size_t)1 << HASH_BITS, -1);
  std::vector<int32_t> prev(n, -1);
  const int cache_size = cache_bits > 0 ? 1 << cache_bits : 0;
  std::vector<uint32_t> cache(cache_size, 0);
  const int cache_shift = cache_bits > 0 ? 32 - cache_bits : 0;

  auto hash_at = [&](int64_t i) -> uint32_t {
    uint64_t v = ((uint64_t)flat[i + 1] << 32) | flat[i];
    return (uint32_t)((v * 0x1e35a7bd1e35a7bdull) >> (64 - HASH_BITS));
  };
  auto insert = [&](int64_t i) {
    if (i + 1 >= n) return;
    uint32_t h = hash_at(i);
    prev[i] = head[h];
    head[h] = (int32_t)i;
  };
  auto match_len = [&](int64_t a, int64_t b) -> int {
    int len = 0;
    int64_t maxl = n - b;
    if (maxl > MAX_LEN) maxl = MAX_LEN;
    while (len < maxl && flat[a + len] == flat[b + len]) len++;
    return len;
  };

  // depth encodes quality (8 + quality/5); at quality >= 90 the caller
  // asked for maximum effort, so disable the good-enough cutoffs and
  // drought decay and search full chains up to MAX_LEN.
  const bool exhaustive = depth >= 26;
  const int good_enough = exhaustive ? MAX_LEN : 64;
  const int lazy_threshold = exhaustive ? 128 : 32;

  int64_t n_ops = 0;
  int64_t pos = 0;
  int64_t last_match = 0;
  while (pos < n) {
    int best_len = 0;
    int64_t best_dist = 0;
    // Always consider dist 1 and dist width (cheap, common, small codes).
    if (pos >= 1) {
      int l = match_len(pos - 1, pos);
      if (l > best_len) { best_len = l; best_dist = 1; }
    }
    if (pos >= width) {
      int l = match_len(pos - width, pos);
      if (l > best_len) { best_len = l; best_dist = width; }
    }
    if (pos + 1 < n && best_len < good_enough) {
      // good_enough cutoff (fast modes only): beyond 64 the copy spans a
      // whole length-prefix bucket and further chain walking buys
      // little (the cost-model DP refines the parse at q>=65 anyway).
      // Long match droughts (noisy photographic content) decay the
      // chain-walk budget — the reference's quality-scaled iteration
      // budget, made adaptive.  Both disabled in exhaustive mode.
      int32_t cand = head[hash_at(pos)];
      int tries = (!exhaustive && pos - last_match > 4096)
                      ? (depth < 4 ? depth : 4) : depth;
      while (cand >= 0 && tries-- > 0) {
        int64_t d = pos - cand;
        if (d > WINDOW) break;
        if (best_len == 0 ||
            (pos + best_len < n && flat[cand + best_len] == flat[pos + best_len])) {
          int l = match_len(cand, pos);
          if (l > best_len || (l == best_len && d < best_dist)) {
            best_len = l;
            best_dist = d;
            if (best_len >= good_enough) break;
          }
        }
        cand = prev[cand];
      }
    }
    if (best_len >= 4) {
      // Lazy matching: if starting one pixel later yields a clearly
      // longer match, emit a literal instead and take it next round.
      if (best_len < lazy_threshold && pos + 2 < n) {
        int32_t cand = head[hash_at(pos + 1)];
        int tries = depth >> 1;
        int next_best = 0;
        while (cand >= 0 && tries-- > 0) {
          int64_t d = pos + 1 - cand;
          if (d > WINDOW) break;
          if (pos + 1 + next_best < n &&
              flat[cand + next_best] == flat[pos + 1 + next_best]) {
            int l = match_len(cand, pos + 1);
            if (l > next_best) next_best = l;
          }
          cand = prev[cand];
        }
        if (next_best > best_len + 1) {
          uint32_t px = flat[pos];
          if (cache_size) {
            uint32_t idx = (uint32_t)(0x1e35a7bdu * px) >> cache_shift;
            if (cache[idx] == px) {
              ops[n_ops] = 2;
              argbs[n_ops] = px;
              lengths[n_ops] = (int32_t)idx;
              dists[n_ops] = 0;
            } else {
              cache[idx] = px;
              ops[n_ops] = 0;
              argbs[n_ops] = px;
              lengths[n_ops] = 1;
              dists[n_ops] = 0;
            }
          } else {
            ops[n_ops] = 0;
            argbs[n_ops] = px;
            lengths[n_ops] = 1;
            dists[n_ops] = 0;
          }
          n_ops++;
          insert(pos);
          pos++;
          continue;
        }
      }
      ops[n_ops] = 1;
      argbs[n_ops] = 0;
      lengths[n_ops] = best_len;
      dists[n_ops] = (int32_t)best_dist;
      n_ops++;
      last_match = pos;
      // Insert hashes for covered positions (sparse for long matches).
      int64_t end = pos + best_len;
      int step = best_len > 64 ? 4 : 1;
      for (int64_t i = pos; i < end; i += step) insert(i);
      if (cache_size) {
        for (int64_t i = pos; i < end; i++) {
          uint32_t px = flat[i];
          cache[(uint32_t)(0x1e35a7bdu * px) >> cache_shift] = px;
        }
      }
      pos = end;
    } else {
      uint32_t px = flat[pos];
      if (cache_size) {
        uint32_t idx = (uint32_t)(0x1e35a7bdu * px) >> cache_shift;
        if (cache[idx] == px) {
          ops[n_ops] = 2;
          argbs[n_ops] = px;
          lengths[n_ops] = (int32_t)idx;
          dists[n_ops] = 0;
        } else {
          cache[idx] = px;
          ops[n_ops] = 0;
          argbs[n_ops] = px;
          lengths[n_ops] = 1;
          dists[n_ops] = 0;
        }
      } else {
        ops[n_ops] = 0;
        argbs[n_ops] = px;
        lengths[n_ops] = 1;
        dists[n_ops] = 0;
      }
      n_ops++;
      insert(pos);
      pos++;
    }
  }
  return n_ops;
}

// Estimated body bits per color-cache size, from one cache-less greedy
// parse (the reference's CalculateBestCacheSize strategy: simulate every
// cache size in a single pass over the refs instead of re-parsing,
// backward_references_enc.c.go:696).  out_bits[k] = estimated bits with
// cache_bits=k, for k in 0..max_bits.
void wtpu_vp8l_cache_score(const uint8_t* ops, const uint32_t* argbs,
                           const int32_t* lengths, int64_t n_ops,
                           const uint32_t* flat, int max_bits,
                           double* out_bits) {
  const int K = max_bits + 1;
  // Per-k histograms: literal green/r/b/a (256 each) + cache hits (2^k).
  std::vector<uint32_t> lit((size_t)K * 4 * 256, 0);
  std::vector<std::vector<uint32_t>> hits(K);
  std::vector<std::vector<uint32_t>> cache(K);
  for (int k = 1; k < K; k++) {
    hits[k].assign((size_t)1 << k, 0);
    cache[k].assign((size_t)1 << k, 0);
  }
  uint32_t len_hist[24] = {0};
  int64_t pos = 0;
  for (int64_t i = 0; i < n_ops; i++) {
    if (ops[i] == 1) {
      int code, nb, bits;
      prefix_encode_c(lengths[i], &code, &nb, &bits);
      len_hist[code]++;
      int64_t end = pos + lengths[i];
      for (; pos < end; pos++) {
        uint32_t px = flat[pos];
        uint32_t hsh = 0x1e35a7bdu * px;
        for (int k = 1; k < K; k++) cache[k][hsh >> (32 - k)] = px;
      }
    } else {
      uint32_t px = argbs[i];
      uint32_t hsh = 0x1e35a7bdu * px;
      uint32_t* l0 = lit.data();  // k = 0: always literal
      l0[(px >> 8) & 0xff]++;
      l0[256 + ((px >> 16) & 0xff)]++;
      l0[512 + (px & 0xff)]++;
      l0[768 + (px >> 24)]++;
      for (int k = 1; k < K; k++) {
        uint32_t idx = hsh >> (32 - k);
        if (cache[k][idx] == px) {
          hits[k][idx]++;
        } else {
          cache[k][idx] = px;
          uint32_t* lk = lit.data() + (size_t)k * 1024;
          lk[(px >> 8) & 0xff]++;
          lk[256 + ((px >> 16) & 0xff)]++;
          lk[512 + (px & 0xff)]++;
          lk[768 + (px >> 24)]++;
        }
      }
      pos++;
    }
  }
  // Entropy + ~6 bits/used-symbol header proxy (matches the Python
  // _entropy_bits estimate used elsewhere for trial scoring).
  auto ent_of = [](const uint32_t* h, size_t n, double& tot_out,
                   double& sum_nlogn, int& used) {
    for (size_t i = 0; i < n; i++) {
      if (h[i]) {
        tot_out += h[i];
        sum_nlogn += (double)h[i] * std::log2((double)h[i]);
        used++;
      }
    }
  };
  for (int k = 0; k < K; k++) {
    double bits = 0.0;
    // Green tree: literal greens + length codes + cache symbols share
    // one distribution.
    {
      double tot = 0.0, s = 0.0;
      int used = 0;
      ent_of(lit.data() + (size_t)k * 1024, 256, tot, s, used);
      ent_of(len_hist, 24, tot, s, used);
      if (k > 0) ent_of(hits[k].data(), (size_t)1 << k, tot, s, used);
      if (tot > 0) bits += tot * std::log2(tot) - s + 6.0 * used;
    }
    for (int ch = 1; ch < 4; ch++) {
      double tot = 0.0, s = 0.0;
      int used = 0;
      ent_of(lit.data() + (size_t)k * 1024 + ch * 256, 256, tot, s, used);
      if (tot > 0) bits += tot * std::log2(tot) - s + 6.0 * used;
    }
    out_bits[k] = bits;
  }
}

// Rewrite a cache-less refs stream for a given cache_bits: literals that
// hit the simulated cache become cache ops (in place; match structure is
// untouched, the greedy parser's decisions do not depend on the cache).
void wtpu_vp8l_cache_apply(uint8_t* ops, const uint32_t* argbs,
                           int32_t* lengths, int64_t n_ops,
                           const uint32_t* flat, int cache_bits) {
  if (cache_bits <= 0) return;
  const int shift = 32 - cache_bits;
  std::vector<uint32_t> cache((size_t)1 << cache_bits, 0);
  int64_t pos = 0;
  for (int64_t i = 0; i < n_ops; i++) {
    if (ops[i] == 1) {
      int64_t end = pos + lengths[i];
      for (; pos < end; pos++) {
        uint32_t px = flat[pos];
        cache[(0x1e35a7bdu * px) >> shift] = px;
      }
    } else {
      uint32_t px = argbs[i];
      uint32_t idx = (0x1e35a7bdu * px) >> shift;
      if (cache[idx] == px) {
        ops[i] = 2;
        lengths[i] = (int32_t)idx;
      } else {
        cache[idx] = px;
        ops[i] = 0;
        lengths[i] = 1;
      }
      pos++;
    }
  }
}

// Greedy run-based LZ77 (dist 1 / dist width) over the flat ARGB image.
// Returns op count; arrays must be sized n (worst case all literals).
int64_t wtpu_vp8l_greedy_refs(const uint32_t* flat, int64_t n, int width,
                              int min_len, int max_len,
                              uint8_t* ops, uint32_t* argbs,
                              int32_t* lengths, int32_t* dists) {
  // run1[i]/runw[i] = run of equality starting at i vs i-1 / i-width.
  std::vector<int32_t> run1(n + 1, 0), runw(n + 1, 0);
  for (int64_t i = n - 1; i >= 1; i--)
    run1[i] = flat[i] == flat[i - 1] ? run1[i + 1] + 1 : 0;
  if (width < n)
    for (int64_t i = n - 1; i >= width; i--)
      runw[i] = flat[i] == flat[i - width] ? runw[i + 1] + 1 : 0;
  int64_t n_ops = 0;
  int64_t pos = 0;
  while (pos < n) {
    int32_t l1 = run1[pos], lw = runw[pos];
    int32_t best = l1 > lw ? l1 : lw;
    if (best >= min_len) {
      int dist = l1 >= lw ? 1 : width;
      int len = best < max_len ? best : max_len;
      ops[n_ops] = 1;
      argbs[n_ops] = 0;
      lengths[n_ops] = len;
      dists[n_ops] = dist;
      pos += len;
    } else {
      ops[n_ops] = 0;
      argbs[n_ops] = flat[pos];
      lengths[n_ops] = 1;
      dists[n_ops] = 0;
      pos++;
    }
    n_ops++;
  }
  return n_ops;
}

// ----------------------------------------------------------------------
// VP8L emission: write the op stream with prebuilt canonical codes.
// ----------------------------------------------------------------------

struct LBitWriter {
  std::vector<uint8_t> buf;
  uint64_t acc = 0;
  int used = 0;
  inline void put(uint32_t v, int n) {
    acc |= (uint64_t)(v & ((1u << n) - 1)) << used;
    used += n;
    while (used >= 8) {
      buf.push_back((uint8_t)(acc & 0xff));
      acc >>= 8;
      used -= 8;
    }
  }
};

static void prefix_encode_c(int value, int* code, int* nbits, int* bits) {
  int u = value - 1;
  if (u < 4) { *code = u; *nbits = 0; *bits = 0; return; }
  int e = 0;
  { int x = u; while (x >= 4) { x >>= 1; e++; } }
  if (u < (3 << e)) { *code = 2 * e + 2; *nbits = e; *bits = u - (2 << e); }
  else { *code = 2 * e + 3; *nbits = e; *bits = u - (3 << e); }
}

// Grouped (meta-huffman) emission: per-op group index selects the code
// tables.  code tables laid out per (group, tree): offsets[g*5+t].
int wtpu_vp8l_emit_grouped(
    const uint8_t* ops, const uint32_t* argbs, const int32_t* lengths,
    const int32_t* dists, const int32_t* groups, int64_t n_ops, int width,
    const uint16_t* code_bits, const uint8_t* code_lens,
    const int32_t* code_offsets, int num_groups,
    const int32_t* dist_lut, int dist_lut_size,
    uint32_t acc_in, int used_in,
    uint8_t** out_data, uint64_t* out_size, uint32_t* acc_out, int* used_out) {
  LBitWriter bw;
  bw.acc = acc_in;
  bw.used = used_in;
  for (int64_t i = 0; i < n_ops; i++) {
    int g = groups[i];
    const uint16_t* gb = code_bits + code_offsets[g * 5 + 0];
    const uint8_t* gl = code_lens + code_offsets[g * 5 + 0];
    if (ops[i] == 0) {
      uint32_t a = argbs[i];
      uint32_t gr = (a >> 8) & 0xff;
      bw.put(gb[gr], gl[gr]);
      const uint16_t* rb = code_bits + code_offsets[g * 5 + 1];
      const uint8_t* rl = code_lens + code_offsets[g * 5 + 1];
      uint32_t r = (a >> 16) & 0xff;
      bw.put(rb[r], rl[r]);
      const uint16_t* bb = code_bits + code_offsets[g * 5 + 2];
      const uint8_t* bl = code_lens + code_offsets[g * 5 + 2];
      uint32_t b = a & 0xff;
      bw.put(bb[b], bl[b]);
      const uint16_t* ab = code_bits + code_offsets[g * 5 + 3];
      const uint8_t* al = code_lens + code_offsets[g * 5 + 3];
      uint32_t al_ = (a >> 24) & 0xff;
      bw.put(ab[al_], al[al_]);
    } else if (ops[i] == 1) {
      int code, nbits, bits;
      prefix_encode_c(lengths[i], &code, &nbits, &bits);
      bw.put(gb[256 + code], gl[256 + code]);
      if (nbits) bw.put((uint32_t)bits, nbits);
      int d = dists[i];
      int plane = (d < dist_lut_size && dist_lut[d]) ? dist_lut[d] : d + 120;
      prefix_encode_c(plane, &code, &nbits, &bits);
      const uint16_t* db = code_bits + code_offsets[g * 5 + 4];
      const uint8_t* dl = code_lens + code_offsets[g * 5 + 4];
      bw.put(db[code], dl[code]);
      if (nbits) bw.put((uint32_t)bits, nbits);
    } else {
      uint32_t idx = (uint32_t)lengths[i];
      bw.put(gb[280 + idx], gl[280 + idx]);
    }
  }
  uint8_t* out = (uint8_t*)std::malloc(bw.buf.size() ? bw.buf.size() : 1);
  std::memcpy(out, bw.buf.data(), bw.buf.size());
  *out_data = out;
  *out_size = bw.buf.size();
  *acc_out = (uint32_t)bw.acc;
  *used_out = bw.used;
  return 0;
}

// Continue an existing partial-byte bitstream: pass in trailing bits.
int wtpu_vp8l_emit(
    const uint8_t* ops, const uint32_t* argbs, const int32_t* lengths,
    const int32_t* dists, int64_t n_ops, int width,
    const uint16_t* code_bits,   // 5 concatenated code tables (bits)
    const uint8_t* code_lens,    // same layout (lengths)
    const int32_t* code_offsets, // [5] offsets into the tables
    const int32_t* dist_lut, int dist_lut_size,   // dist -> plane code (or 0)
    uint32_t acc_in, int used_in,
    uint8_t** out_data, uint64_t* out_size, uint32_t* acc_out, int* used_out) {
  LBitWriter bw;
  bw.acc = acc_in;
  bw.used = used_in;
  const uint16_t* gb = code_bits + code_offsets[0];
  const uint8_t* gl = code_lens + code_offsets[0];
  const uint16_t* rb = code_bits + code_offsets[1];
  const uint8_t* rl = code_lens + code_offsets[1];
  const uint16_t* bb = code_bits + code_offsets[2];
  const uint8_t* bl = code_lens + code_offsets[2];
  const uint16_t* ab = code_bits + code_offsets[3];
  const uint8_t* al = code_lens + code_offsets[3];
  const uint16_t* db = code_bits + code_offsets[4];
  const uint8_t* dl = code_lens + code_offsets[4];

  for (int64_t i = 0; i < n_ops; i++) {
    if (ops[i] == 0) {
      uint32_t a = argbs[i];
      uint32_t g = (a >> 8) & 0xff;
      bw.put(gb[g], gl[g]);
      uint32_t r = (a >> 16) & 0xff;
      bw.put(rb[r], rl[r]);
      uint32_t b = a & 0xff;
      bw.put(bb[b], bl[b]);
      uint32_t al_ = (a >> 24) & 0xff;
      bw.put(ab[al_], al[al_]);
    } else if (ops[i] == 1) {
      int code, nbits, bits;
      prefix_encode_c(lengths[i], &code, &nbits, &bits);
      bw.put(gb[256 + code], gl[256 + code]);
      if (nbits) bw.put((uint32_t)bits, nbits);
      int d = dists[i];
      int plane = (d < dist_lut_size && dist_lut[d]) ? dist_lut[d] : d + 120;
      prefix_encode_c(plane, &code, &nbits, &bits);
      bw.put(db[code], dl[code]);
      if (nbits) bw.put((uint32_t)bits, nbits);
    } else {  // cache index
      uint32_t idx = (uint32_t)lengths[i];
      bw.put(gb[280 + idx], gl[280 + idx]);
    }
  }
  uint8_t* out = (uint8_t*)std::malloc(bw.buf.size() ? bw.buf.size() : 1);
  std::memcpy(out, bw.buf.data(), bw.buf.size());
  *out_data = out;
  *out_size = bw.buf.size();
  *acc_out = (uint32_t)bw.acc;
  *used_out = bw.used;
  return 0;
}

// ----------------------------------------------------------------------
// Cost-model optimal LZ77 parse (shortest path over pixel positions).
//
// The re-expression of the reference's TraceBackwards pass
// (backward-references cost model, SURVEY.md §2.6): symbol costs come
// from a greedy first-pass histogram; edges are literals plus, per
// position, the best hash-chain match evaluated at every length-prefix
// *bucket end* (the cost of a copy is constant within a bucket, so only
// bucket boundaries can be optimal).  A final pass converts literals to
// color-cache hits.
// ----------------------------------------------------------------------
int64_t wtpu_vp8l_optimal_refs(
    const uint32_t* flat, int64_t n, int width, int depth, int cache_bits,
    const float* g_cost,   // [280] green-tree symbol cost (bits)
    const float* r_cost, const float* b_cost, const float* a_cost,  // [256]
    const float* d_cost,   // [40] distance prefix symbol cost
    const int32_t* dist_lut, int dist_lut_size,
    uint8_t* ops, uint32_t* argbs, int32_t* lengths, int32_t* dists) {
  constexpr int HASH_BITS = 18;
  constexpr int64_t WINDOW = (1 << 20) - 126;
  constexpr int MAX_LEN = 4095;

  // Per-length copy-symbol cost (green length symbol + extra bits).
  std::vector<float> len_cost(MAX_LEN + 1, 1e30f);
  // Bucket-end lengths: the largest length mapping to each prefix code.
  std::vector<int> bucket_ends;
  {
    int prev_code = -1;
    for (int l = 2; l <= MAX_LEN; l++) {
      int code, nb, bits;
      prefix_encode_c(l, &code, &nb, &bits);
      len_cost[l] = g_cost[256 + code] + nb;
      if (code != prev_code && l > 2) bucket_ends.push_back(l - 1);
      prev_code = code;
    }
    bucket_ends.push_back(MAX_LEN);
  }
  auto dist_cost_of = [&](int64_t d) -> float {
    int plane = (d < dist_lut_size && dist_lut[d]) ? dist_lut[d]
                                                   : (int)(d + 120);
    int code, nb, bits;
    prefix_encode_c(plane, &code, &nb, &bits);
    return d_cost[code] + nb;
  };
  auto lit_cost_of = [&](uint32_t px) -> float {
    return g_cost[(px >> 8) & 0xff] + r_cost[(px >> 16) & 0xff] +
           b_cost[px & 0xff] + a_cost[(px >> 24) & 0xff];
  };

  std::vector<int32_t> head((size_t)1 << HASH_BITS, -1);
  std::vector<int32_t> prev(n, -1);
  auto hash_at = [&](int64_t i) -> uint32_t {
    uint64_t v = ((uint64_t)flat[i + 1] << 32) | flat[i];
    return (uint32_t)((v * 0x1e35a7bd1e35a7bdull) >> (64 - HASH_BITS));
  };
  auto match_len = [&](int64_t a, int64_t b) -> int {
    int len = 0;
    int64_t maxl = n - b;
    if (maxl > MAX_LEN) maxl = MAX_LEN;
    while (len < maxl && flat[a + len] == flat[b + len]) len++;
    return len;
  };

  std::vector<float> cost(n + 1, 1e30f);
  std::vector<int32_t> from_len(n + 1, 0);
  std::vector<int32_t> from_dist(n + 1, 0);
  cost[0] = 0.0f;

  // O(1) per-position match lengths for the trivial distances (the DP
  // visits every pixel, so per-position match_len scans of long
  // constant runs would be quadratic).
  std::vector<int32_t> run1(n + 1, 0), runw(n + 1, 0);
  for (int64_t i = n - 1; i >= 1; i--)
    run1[i] = flat[i] == flat[i - 1] ? run1[i + 1] + 1 : 0;
  if (width < n)
    for (int64_t i = n - 1; i >= width; i--)
      runw[i] = flat[i] == flat[i - width] ? runw[i + 1] + 1 : 0;

  for (int64_t i = 0; i < n; i++) {
    const float c0 = cost[i];
    // Literal edge.
    {
      float c = c0 + lit_cost_of(flat[i]);
      if (c < cost[i + 1]) { cost[i + 1] = c; from_len[i + 1] = 1;
                             from_dist[i + 1] = 0; }
    }
    // Candidate matches: dist 1, dist width, best hash-chain match.
    int64_t cand_d[3];
    int cand_l[3];
    int n_cand = 0;
    if (i >= 1) {
      int l = run1[i] > MAX_LEN ? MAX_LEN : run1[i];
      if (l >= 2) { cand_d[n_cand] = 1; cand_l[n_cand++] = l; }
    }
    if (i >= width) {
      int l = runw[i] > MAX_LEN ? MAX_LEN : runw[i];
      if (l >= 2) { cand_d[n_cand] = width; cand_l[n_cand++] = l; }
    }
    // Skip the chain when a trivial candidate already hit the cap
    // (constant runs would otherwise rescan ~MAX_LEN pixels per chain
    // entry at every position).
    int have_max = (n_cand > 0 && cand_l[0] >= MAX_LEN) ||
                   (n_cand > 1 && cand_l[1] >= MAX_LEN);
    if (i + 1 < n && !have_max) {
      int32_t c = head[hash_at(i)];
      int tries = depth;
      int best_len = 0;
      int64_t best_dist = 0;
      // Trivial-distance lengths already known: the chain only has to
      // beat them (64 = same good-enough cutoff as the greedy pass).
      int floor_len = 0;
      for (int k = 0; k < n_cand; k++)
        if (cand_l[k] > floor_len) floor_len = cand_l[k];
      while (c >= 0 && tries-- > 0 && best_len < 64 && floor_len < 64) {
        int64_t d = i - c;
        if (d > WINDOW) break;
        if (best_len == 0 ||
            (i + best_len < n && flat[c + best_len] == flat[i + best_len])) {
          int l = match_len(c, i);
          if (l > best_len || (l == best_len && d < best_dist)) {
            best_len = l;
            best_dist = d;
          }
        }
        c = prev[c];
      }
      if (best_len >= 2 && best_dist != 1 && best_dist != width) {
        cand_d[n_cand] = best_dist;
        cand_l[n_cand++] = best_len;
      }
    }
    for (int k = 0; k < n_cand; k++) {
      const float dc = c0 + dist_cost_of(cand_d[k]);
      const int lmax = cand_l[k];
      // Bucket-end lengths only (equal copy cost within a bucket, so the
      // longest length in each bucket dominates shorter ones), plus lmax.
      for (int bi = 0; ; bi++) {
        int l = bucket_ends[bi];
        if (l >= lmax) l = lmax;
        float c = dc + len_cost[l];
        if (c < cost[i + l]) { cost[i + l] = c; from_len[i + l] = l;
                               from_dist[i + l] = (int32_t)cand_d[k]; }
        if (l == lmax) break;
      }
    }
    // Insert into the hash chain (every position — DP visits them all).
    if (i + 1 < n) {
      uint32_t h = hash_at(i);
      prev[i] = head[h];
      head[h] = (int32_t)i;
    }
  }

  // Backward trace, then forward emission with cache conversion.
  std::vector<int64_t> cuts;
  for (int64_t p = n; p > 0; p -= from_len[p]) cuts.push_back(p);
  const int cache_size = cache_bits > 0 ? 1 << cache_bits : 0;
  std::vector<uint32_t> cache(cache_size, 0);
  const int cache_shift = cache_bits > 0 ? 32 - cache_bits : 0;
  int64_t n_ops = 0;
  int64_t pos = 0;
  for (int64_t ci = (int64_t)cuts.size() - 1; ci >= 0; ci--) {
    int64_t end = cuts[ci];
    int32_t l = from_len[end];
    if (from_dist[end] == 0) {
      uint32_t px = flat[pos];
      if (cache_size) {
        uint32_t idx = (uint32_t)(0x1e35a7bdu * px) >> cache_shift;
        if (cache[idx] == px) {
          ops[n_ops] = 2; argbs[n_ops] = px;
          lengths[n_ops] = (int32_t)idx; dists[n_ops] = 0;
        } else {
          cache[idx] = px;
          ops[n_ops] = 0; argbs[n_ops] = px;
          lengths[n_ops] = 1; dists[n_ops] = 0;
        }
      } else {
        ops[n_ops] = 0; argbs[n_ops] = px;
        lengths[n_ops] = 1; dists[n_ops] = 0;
      }
      n_ops++;
      pos++;
    } else {
      ops[n_ops] = 1; argbs[n_ops] = 0;
      lengths[n_ops] = l; dists[n_ops] = from_dist[end];
      n_ops++;
      if (cache_size) {
        for (int64_t p = pos; p < pos + l; p++) {
          uint32_t px = flat[p];
          cache[(uint32_t)(0x1e35a7bdu * px) >> cache_shift] = px;
        }
      }
      pos += l;
    }
  }
  return n_ops;
}

}  // extern "C"
