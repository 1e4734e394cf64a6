// See dsp.h. C++ twins of hevc_tpu/ops/{transform,quant,interp,intra_np}.py.
#include "dsp.h"

#include <algorithm>
#include <limits>
#include <cstring>

namespace hevctpu {
namespace dsp {

namespace {

// 33 distinct transform coefficients fixed by spec 8.6.4.2 (magnitudes for
// angle m*pi/64, m in [0,32]; hand-tuned by the standard for orthogonality).
const int32_t kDctCoef[33] = {
    64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67,
    64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9, 4, 0};

const int32_t kDst4[16] = {29, 55, 74, 84,  74, 74, 0, -74,
                           84, -29, -74, 55, 55, -84, 74, -29};

// spec 8.4.4.2.3 filtering thresholds per log2 size (index 2..5)
const int kIntraFilterThresh[6] = {0, 0, 10, 7, 1, 0};

const int kIntraAngle[35 - 2] = {  // modes 2..34
    32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26, -32,
    -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32};
const int kIntraInvAngle[35 - 11] = {  // modes 11..34 (angle < 0 region)
    -4096, -1638, -910, -630, -482, -390, -315, -256, -315, -390, -482,
    -630, -910, -1638, -4096, 0, 0, 0, 0, 0, 0, 0, 0, 0};

int ilog2(int n) {
  int k = 0;
  while ((1 << k) < n) ++k;
  return k;
}

struct DctTables {
  int32_t t4[16], t8[64], t16[256], t32[1024];
  DctTables() {
    build(t4, 4);
    build(t8, 8);
    build(t16, 16);
    build(t32, 32);
  }
  static void build(int32_t* t, int n) {
    int step = 32 / n;
    for (int k = 0; k < n; ++k)
      for (int col = 0; col < n; ++col) {
        int m = (k * (2 * col + 1) * step) % 128;
        int s = 1;
        if (m > 64) m = 128 - m;
        if (m > 32) { m = 64 - m; s = -1; }
        t[k * n + col] = s * kDctCoef[m];
      }
  }
};
const DctTables g_dct;

const int32_t kLumaFilters[4][8] = {
    {0, 0, 0, 64, 0, 0, 0, 0},
    {-1, 4, -10, 58, 17, -5, 1, 0},
    {-1, 4, -11, 40, 40, -11, 4, -1},
    {0, 1, -5, 17, 58, -10, 4, -1}};
const int32_t kChromaFilters[8][4] = {
    {0, 64, 0, 0},  {-2, 58, 10, -2}, {-4, 54, 16, -2}, {-6, 46, 28, -4},
    {-4, 36, 36, -4}, {-4, 28, 46, -6}, {-2, 16, 54, -4}, {-2, 10, 58, -2}};

// normative default quantization matrices (spec Table 7-5/7-6)
const int32_t kQuantIntraDef8[64] = {
    16, 16, 16, 16, 17, 18, 21, 24, 16, 16, 16, 16, 17, 19, 22, 25,
    16, 16, 17, 18, 20, 22, 25, 29, 16, 16, 18, 21, 24, 27, 31, 36,
    17, 17, 20, 24, 30, 35, 41, 47, 18, 19, 22, 27, 35, 44, 54, 65,
    21, 22, 25, 31, 41, 54, 70, 88, 24, 25, 29, 36, 47, 65, 88, 115};
const int32_t kQuantInterDef8[64] = {
    16, 16, 16, 16, 17, 18, 20, 24, 16, 16, 16, 17, 18, 20, 24, 25,
    16, 16, 17, 18, 20, 24, 25, 28, 16, 17, 18, 20, 24, 25, 28, 33,
    17, 18, 20, 24, 25, 28, 33, 41, 18, 20, 24, 25, 28, 33, 41, 54,
    20, 24, 25, 28, 33, 41, 54, 71, 24, 25, 28, 33, 41, 54, 71, 91};

struct ScalingTables {
  int32_t m[2][3][32 * 32];  // [intra][log2n-3]
  ScalingTables() {
    for (int ii = 0; ii < 2; ++ii) {
      const int32_t* base = ii ? kQuantIntraDef8 : kQuantInterDef8;
      for (int lg = 3; lg <= 5; ++lg) {
        int n = 1 << lg, sh = lg - 3;
        for (int y = 0; y < n; ++y)
          for (int x = 0; x < n; ++x)
            m[ii][lg - 3][y * n + x] = base[(y >> sh) * 8 + (x >> sh)];
        // DC coefficient: scaling_list_dc default 16 for 16x16/32x32
        if (lg > 3) m[ii][lg - 3][0] = 16;
      }
    }
  }
};
const ScalingTables g_scaling;

}  // namespace

const int32_t kQuantScales[6] = {26214, 23302, 20560, 18396, 16384, 14564};
const int32_t kInvQuantScales[6] = {40, 45, 51, 57, 64, 72};

const int32_t* default_scaling_matrix(int n, bool intra) {
  if (n < 8) return nullptr;  // 4x4 default is flat
  int lg = 3;
  while ((1 << lg) < n) ++lg;
  return g_scaling.m[intra ? 1 : 0][lg - 3];
}

const int32_t* dct_matrix(int n) {
  switch (n) {
    case 4: return g_dct.t4;
    case 8: return g_dct.t8;
    case 16: return g_dct.t16;
    default: return g_dct.t32;
  }
}
const int32_t* dst4_matrix() { return kDst4; }

void fwd_xform(const int32_t* resi, int n, int bd, bool dst, int32_t* out) {
  const int32_t* t = dst ? kDst4 : dct_matrix(n);
  int log2n = ilog2(n);
  int s1 = log2n + bd - 9, s2 = log2n + 6;
  int32_t r1 = 1 << (s1 - 1), r2 = 1 << (s2 - 1);
  // int32 accumulation is exact: stage 1 |sum| <= 32 * 90 * 65535 < 2^31
  // even at 16-bit depth; stage-1 outputs are <= 90 << 9 after the s1
  // shift, so stage 2 |sum| <= 32 * 90 * 46080 < 2^31 — every dot
  // product below stays in SIMD int32 lanes.
  int32_t tmp[32 * 32];
  // stage 1 stored TRANSPOSED (tmp[k][i] = resi_row_i . t_row_k) so that
  // stage 2 reads stride-1 rows from both operands
  for (int i = 0; i < n; ++i) {
    const int32_t* rr = resi + i * n;
    for (int k = 0; k < n; ++k) {
      const int32_t* tk = t + k * n;
      int32_t acc = 0;
      for (int j = 0; j < n; ++j) acc += rr[j] * tk[j];
      tmp[k * n + i] = (acc + r1) >> s1;
    }
  }
  // out[k][c] = t_row_k . tmp_row_c (both stride-1)
  for (int k = 0; k < n; ++k) {
    const int32_t* tk = t + k * n;
    for (int c = 0; c < n; ++c) {
      const int32_t* tc = tmp + c * n;
      int32_t acc = 0;
      for (int i = 0; i < n; ++i) acc += tk[i] * tc[i];
      out[k * n + c] = (acc + r2) >> s2;
    }
  }
}

void inv_xform(const int32_t* coef, int n, int bd, bool dst, int32_t* out) {
  const int32_t* t = dst ? kDst4 : dct_matrix(n);
  int s2 = 20 - bd;
  int32_t r2 = 1 << (s2 - 1);
  // int32 accumulation exact (coeffs clip to 16 bits, stage-1 output
  // clips to 16 bits): |sum| <= 32 * 90 * 32768 < 2^31
  int32_t tmp[32 * 32];
  // tmp[i][c] = clip16((sum_k t[k][i] * coef[k][c] + 64) >> 7), built as
  // rank-1 updates over k so both streams are stride-1
  for (int i = 0; i < n * n; ++i) tmp[i] = 64;
  for (int k = 0; k < n; ++k) {
    const int32_t* tk = t + k * n;
    const int32_t* ck = coef + k * n;
    for (int i = 0; i < n; ++i) {
      const int32_t tv = tk[i];
      int32_t* ti = tmp + i * n;
      for (int c = 0; c < n; ++c) ti[c] += tv * ck[c];
    }
  }
  for (int i = 0; i < n * n; ++i)
    tmp[i] = std::min(32767, std::max(-32768, tmp[i] >> 7));
  // out = clip_pel((tmp @ T + r2) >> s2), rank-1 updates over c
  for (int i = 0; i < n; ++i) {
    int32_t acc32[32];
    for (int j = 0; j < n; ++j) acc32[j] = r2;
    const int32_t* ti = tmp + i * n;
    for (int c = 0; c < n; ++c) {
      const int32_t tv = ti[c];
      const int32_t* tc = t + c * n;
      for (int j = 0; j < n; ++j) acc32[j] += tv * tc[j];
    }
    for (int j = 0; j < n; ++j) {
      int64_t v = acc32[j] >> s2;
      // second-stage clip = Pel-type protection, not normative (reference
      // TComTrQuant.cpp:966): +-32767 for int16 samples, no-op at pel32
      out[i * n + j] = (int32_t)std::min<int64_t>(
          std::numeric_limits<pel_t>::max(),
          std::max<int64_t>(std::numeric_limits<pel_t>::min(), v));
    }
  }
}

int quant(const int32_t* coef, int n, int qp, int bd, bool intra,
          int32_t* level, const int32_t* m) {
  qp += 6 * (bd - 8);
  int log2n = ilog2(n);
  int tshift = 15 - bd - log2n;
  int qbits = 14 + qp / 6 + tshift;
  int64_t scale = kQuantScales[qp % 6];
  int64_t offset = (int64_t)(intra ? 171 : 85) << (qbits - 9);
  int nz = 0;
  for (int i = 0; i < n * n; ++i) {
    int64_t c = coef[i];
    int64_t sc = m ? (scale * 16) / m[i] : scale;
    int64_t l = ((c < 0 ? -c : c) * sc + offset) >> qbits;
    if (l > 32767) l = 32767;
    level[i] = (int32_t)(c < 0 ? -l : l);
    nz += level[i] != 0;
  }
  return nz;
}

void dequant(const int32_t* level, int n, int qp, int bd, int32_t* coef,
             const int32_t* m) {
  qp += 6 * (bd - 8);
  int log2n = ilog2(n);
  int bd_shift = bd + log2n - 5;
  int64_t ls = (int64_t)kInvQuantScales[qp % 6] << (qp / 6);
  int64_t r = 1ll << (bd_shift - 1);
  for (int i = 0; i < n * n; ++i) {
    // spec 8.6.3: d = (level * m[i] * levScale[rem] << per + r) >> bdShift
    int64_t mi = m ? m[i] : 16;
    int64_t c = ((int64_t)level[i] * mi * ls + r) >> bd_shift;
    coef[i] =
        (int32_t)std::min<int64_t>(32767, std::max<int64_t>(-32768, c));
  }
}

namespace {
int64_t had4(const int32_t d[16]) {
  int32_t m[16];
  for (int i = 0; i < 4; ++i) {  // rows
    int32_t a = d[i * 4] + d[i * 4 + 3], b = d[i * 4 + 1] + d[i * 4 + 2];
    int32_t c = d[i * 4] - d[i * 4 + 3], e = d[i * 4 + 1] - d[i * 4 + 2];
    m[i * 4] = a + b; m[i * 4 + 1] = a - b;
    m[i * 4 + 2] = c + e; m[i * 4 + 3] = c - e;
  }
  int64_t s = 0;
  for (int j = 0; j < 4; ++j) {  // cols
    int32_t a = m[j] + m[12 + j], b = m[4 + j] + m[8 + j];
    int32_t c = m[j] - m[12 + j], e = m[4 + j] - m[8 + j];
    s += std::abs(a + b) + std::abs(a - b) + std::abs(c + e) + std::abs(c - e);
  }
  return s;
}

// 8-lane int32 SIMD Hadamard: GCC vector extensions, lowered to the
// best ISA -march=native provides. One vector per row; the butterfly
// stage is elementwise across row-vectors, the second stage runs after
// an in-register 8x8 transpose. Values stay within int32: |input| <
// 2^16 gains at most 64x through H(.)H, and the 64-term |.| sum tops
// out below 2^29.
typedef int32_t v8si __attribute__((vector_size(32)));

static inline void had8_stage(v8si r[8]) {
  v8si a0 = r[0] + r[4], a1 = r[1] + r[5], a2 = r[2] + r[6],
       a3 = r[3] + r[7];
  v8si b0 = r[0] - r[4], b1 = r[1] - r[5], b2 = r[2] - r[6],
       b3 = r[3] - r[7];
  v8si c0 = a0 + a2, c1 = a1 + a3, c2 = a0 - a2, c3 = a1 - a3;
  v8si e0 = b0 + b2, e1 = b1 + b3, e2 = b0 - b2, e3 = b1 - b3;
  r[0] = c0 + c1; r[1] = c0 - c1; r[2] = c2 + c3; r[3] = c2 - c3;
  r[4] = e0 + e1; r[5] = e0 - e1; r[6] = e2 + e3; r[7] = e2 - e3;
}

static inline void transpose8(v8si r[8]) {
  v8si a0 = __builtin_shufflevector(r[0], r[1], 0, 8, 1, 9, 4, 12, 5, 13);
  v8si a1 = __builtin_shufflevector(r[0], r[1], 2, 10, 3, 11, 6, 14, 7, 15);
  v8si a2 = __builtin_shufflevector(r[2], r[3], 0, 8, 1, 9, 4, 12, 5, 13);
  v8si a3 = __builtin_shufflevector(r[2], r[3], 2, 10, 3, 11, 6, 14, 7, 15);
  v8si a4 = __builtin_shufflevector(r[4], r[5], 0, 8, 1, 9, 4, 12, 5, 13);
  v8si a5 = __builtin_shufflevector(r[4], r[5], 2, 10, 3, 11, 6, 14, 7, 15);
  v8si a6 = __builtin_shufflevector(r[6], r[7], 0, 8, 1, 9, 4, 12, 5, 13);
  v8si a7 = __builtin_shufflevector(r[6], r[7], 2, 10, 3, 11, 6, 14, 7, 15);
  v8si b0 = __builtin_shufflevector(a0, a2, 0, 1, 8, 9, 4, 5, 12, 13);
  v8si b1 = __builtin_shufflevector(a0, a2, 2, 3, 10, 11, 6, 7, 14, 15);
  v8si b2 = __builtin_shufflevector(a1, a3, 0, 1, 8, 9, 4, 5, 12, 13);
  v8si b3 = __builtin_shufflevector(a1, a3, 2, 3, 10, 11, 6, 7, 14, 15);
  v8si b4 = __builtin_shufflevector(a4, a6, 0, 1, 8, 9, 4, 5, 12, 13);
  v8si b5 = __builtin_shufflevector(a4, a6, 2, 3, 10, 11, 6, 7, 14, 15);
  v8si b6 = __builtin_shufflevector(a5, a7, 0, 1, 8, 9, 4, 5, 12, 13);
  v8si b7 = __builtin_shufflevector(a5, a7, 2, 3, 10, 11, 6, 7, 14, 15);
  r[0] = __builtin_shufflevector(b0, b4, 0, 1, 2, 3, 8, 9, 10, 11);
  r[4] = __builtin_shufflevector(b0, b4, 4, 5, 6, 7, 12, 13, 14, 15);
  r[1] = __builtin_shufflevector(b1, b5, 0, 1, 2, 3, 8, 9, 10, 11);
  r[5] = __builtin_shufflevector(b1, b5, 4, 5, 6, 7, 12, 13, 14, 15);
  r[2] = __builtin_shufflevector(b2, b6, 0, 1, 2, 3, 8, 9, 10, 11);
  r[6] = __builtin_shufflevector(b2, b6, 4, 5, 6, 7, 12, 13, 14, 15);
  r[3] = __builtin_shufflevector(b3, b7, 0, 1, 2, 3, 8, 9, 10, 11);
  r[7] = __builtin_shufflevector(b3, b7, 4, 5, 6, 7, 12, 13, 14, 15);
}

int64_t had8(const int32_t d[64]) {
  v8si r[8];
  std::memcpy(r, d, sizeof(r));
  had8_stage(r);        // columns (elementwise across row-vectors)
  transpose8(r);
  had8_stage(r);        // rows (same stage on the transposed block)
  v8si s = r[0] - r[0];
  for (int i = 0; i < 8; ++i) {
    v8si m = r[i] >> 31;            // arithmetic: -1 where negative
    s += (r[i] ^ m) - m;            // |r[i]|
  }
  int64_t t = 0;
  for (int j = 0; j < 8; ++j) t += s[j];
  return t;
}
}  // namespace

// NOTE: the Hadamard here is the standard fast transform, which matches the
// matrix product H d H of intra_frame.satd_many up to a row/col permutation
// (sum of |.| is permutation-invariant).
int64_t satd(const pel_t* org, int so, const int32_t* pred, int sp, int n) {
  return satd_rect(org, so, pred, sp, n, n);
}

int64_t satd_rect(const pel_t* org, int so, const int32_t* pred, int sp,
                  int w, int h) {
  int t = (w >= 8 && h >= 8) ? 8 : 4;
  int64_t total = 0;
  int32_t d[64];
  for (int by = 0; by < h; by += t)
    for (int bx = 0; bx < w; bx += t) {
      for (int y = 0; y < t; ++y)
        for (int x = 0; x < t; ++x)
          d[y * t + x] = (int32_t)org[(by + y) * so + bx + x] -
                         pred[(by + y) * sp + bx + x];
      int64_t s = (t == 8) ? had8(d) : had4(d);
      total += (s + (t == 8 ? 2 : 1)) >> (t == 8 ? 2 : 1);
    }
  return total;
}

int64_t satd_bounded(const pel_t* org, int so, const int32_t* pred, int sp,
                     int n, int64_t bound) {
  // SATD with early exit: candidate screens keep a running best cost;
  // once the partial sum passes `bound` the candidate has already lost,
  // so any value >= bound may be returned (most screen candidates lose,
  // typically within the first rows). Exact (== satd) whenever the true
  // value is below the bound.
  if (n < 8) return satd_rect(org, so, pred, sp, n, n);
  int64_t total = 0;
  int32_t d[64];
  for (int by = 0; by < n; by += 8) {
    for (int bx = 0; bx < n; bx += 8) {
      for (int y = 0; y < 8; ++y)
        for (int x = 0; x < 8; ++x)
          d[y * 8 + x] = (int32_t)org[(by + y) * so + bx + x] -
                         pred[(by + y) * sp + bx + x];
      total += (had8(d) + 2) >> 2;
    }
    if (total >= bound) return total;
  }
  return total;
}

void mc_block(const pel_t* ref, int rw, int pad, int x, int y, int w,
              int h, int fx, int fy, int bd, bool is_luma, bool raw14,
              int32_t* out) {
  int nt = is_luma ? 8 : 4;
  int off = nt / 2 - 1;
  int maxv = (1 << bd) - 1;
  // headroom floor of 2 (reference TComInterpolationFilter
  // std::max<Int>(2, IF_INTERNAL_PREC - bitDepth)): 14-bit video runs
  // the MC intermediate at 16-bit precision
  int hr = std::max(2, 14 - bd);
  int shift1 = 6 - hr;
  int shift_u = hr;
  int off_u = 1 << (shift_u - 1);
  int px = x + pad, py = y + pad;
  const int32_t* fh = is_luma ? kLumaFilters[fx] : kChromaFilters[fx];
  const int32_t* fv = is_luma ? kLumaFilters[fy] : kChromaFilters[fy];
  if (fx == 0 && fy == 0) {
    for (int yy = 0; yy < h; ++yy)
      for (int xx = 0; xx < w; ++xx) {
        int32_t v = ref[(py + yy) * rw + px + xx];
        out[yy * w + xx] = raw14 ? (v << shift_u) : v;
      }
    return;
  }
  // int32 accumulation throughout (HM's own path: Short samples, Int
  // sums — TComInterpolationFilter::filter). Worst case |sample| < 2^16
  // (hbd build), sum|taps| <= 112 (half-pel luma): horizontal sums
  // < 2^23; after >>shift1 (>= 4 whenever bd > 12) the mid values stay
  // < 2^19, so the vertical pass tops out below 2^26. int32 halves the
  // SIMD element width vs the previous int64 accumulators and lets GCC
  // vectorize both tap loops.
  // Tap loops run k-outer so the contiguous xx loop autovectorizes
  // (the k-inner form left GCC an 8-element reduction it would not
  // vectorize: measured 0.65 MAC/cycle; k-outer reaches the SIMD width).
  int32_t tmp[(64 + 8) * 64];
  auto hrow = [&](const pel_t* r, int32_t* t, int n_out, int shift) {
    int32_t f0 = fh[0];
    for (int xx = 0; xx < n_out; ++xx) t[xx] = f0 * (int32_t)r[xx];
    for (int k = 1; k < nt; ++k) {
      int32_t f = fh[k];
      const pel_t* rk = r + k;
      for (int xx = 0; xx < n_out; ++xx) t[xx] += f * (int32_t)rk[xx];
    }
    for (int xx = 0; xx < n_out; ++xx) t[xx] >>= shift;
  };
  if (fy == 0) {
    for (int yy = 0; yy < h; ++yy)
      hrow(ref + (py + yy) * rw + px - off, tmp + yy * w, w, shift1);
  } else if (fx == 0) {
    for (int yy = 0; yy < h; ++yy) {
      const pel_t* r = ref + (py - off + yy) * rw + px;
      int32_t* t = tmp + yy * w;
      int32_t f0 = fv[0];
      for (int xx = 0; xx < w; ++xx) t[xx] = f0 * (int32_t)r[xx];
      for (int k = 1; k < nt; ++k) {
        int32_t f = fv[k];
        const pel_t* rk = r + k * rw;
        for (int xx = 0; xx < w; ++xx) t[xx] += f * (int32_t)rk[xx];
      }
      for (int xx = 0; xx < w; ++xx) t[xx] >>= shift1;
    }
  } else {
    int32_t mid[(64 + 8) * 64];
    for (int yy = 0; yy < h + nt - 1; ++yy)
      hrow(ref + (py - off + yy) * rw + px - off, mid + yy * w, w, shift1);
    for (int yy = 0; yy < h; ++yy) {
      int32_t* t = tmp + yy * w;
      const int32_t* m0 = mid + yy * w;
      int32_t f0 = fv[0];
      for (int xx = 0; xx < w; ++xx) t[xx] = f0 * m0[xx];
      for (int k = 1; k < nt; ++k) {
        int32_t f = fv[k];
        const int32_t* mk = mid + (yy + k) * w;
        for (int xx = 0; xx < w; ++xx) t[xx] += f * mk[xx];
      }
      for (int xx = 0; xx < w; ++xx) t[xx] >>= 6;
    }
  }
  for (int i = 0; i < w * h; ++i) {
    if (raw14) {
      out[i] = tmp[i];
    } else {
      int32_t v = (tmp[i] + off_u) >> shift_u;
      out[i] = std::min(maxv, std::max(0, v));
    }
  }
}

void mc_predict(const pel_t* ref, int rw, int pad, int mvx, int mvy,
                int x0, int y0, int w, int h, int bd, bool is_luma,
                int32_t* out) {
  int ix, fx, iy, fy;
  if (is_luma) {
    ix = mvx >> 2; fx = mvx & 3; iy = mvy >> 2; fy = mvy & 3;
  } else {
    ix = mvx >> 3; fx = mvx & 7; iy = mvy >> 3; fy = mvy & 7;
  }
  mc_block(ref, rw, pad, x0 + ix, y0 + iy, w, h, fx, fy, bd, is_luma, false,
           out);
}

void mc_predict_wp(const pel_t* ref, int rw, int pad, int mvx, int mvy,
                   int x0, int y0, int w, int h, int bd, bool is_luma,
                   int wgt, int off, int denom, int32_t* out) {
  int ix, fx, iy, fy;
  if (is_luma) {
    ix = mvx >> 2; fx = mvx & 3; iy = mvy >> 2; fy = mvy & 3;
  } else {
    ix = mvx >> 3; fx = mvx & 7; iy = mvy >> 3; fy = mvy & 7;
  }
  int32_t raw[64 * 64];
  mc_block(ref, rw, pad, x0 + ix, y0 + iy, w, h, fx, fy, bd, is_luma, true,
           raw);
  int log2wd = denom + std::max(2, 14 - bd);
  int maxv = (1 << bd) - 1;
  off <<= bd - 8;   // WpOffsetBdShift (spec 7.4.7.3 / 8.5.3.3.4.3)
  int64_t rnd = log2wd >= 1 ? (1ll << (log2wd - 1)) : 0;
  for (int i = 0; i < w * h; ++i) {
    int64_t v;
    if (log2wd >= 1)
      v = (((int64_t)raw[i] * wgt + rnd) >> log2wd) + off;
    else
      v = (int64_t)raw[i] * wgt + off;
    out[i] = (int32_t)std::min<int64_t>(maxv, std::max<int64_t>(0, v));
  }
}

void mc_predict_bi(const pel_t* r0, const pel_t* r1, int rw, int pad,
                   int mv0x, int mv0y, int mv1x, int mv1y, int x0, int y0,
                   int w, int h, int bd, bool is_luma, int32_t* out) {
  int32_t a[64 * 64], b[64 * 64];
  auto raw = [&](const pel_t* r, int mvx, int mvy, int32_t* o) {
    int ix, fx, iy, fy;
    if (is_luma) {
      ix = mvx >> 2; fx = mvx & 3; iy = mvy >> 2; fy = mvy & 3;
    } else {
      ix = mvx >> 3; fx = mvx & 7; iy = mvy >> 3; fy = mvy & 7;
    }
    mc_block(r, rw, pad, x0 + ix, y0 + iy, w, h, fx, fy, bd, is_luma, true,
             o);
  };
  raw(r0, mv0x, mv0y, a);
  raw(r1, mv1x, mv1y, b);
  int shift2 = std::max(2, 14 - bd) + 1;
  int off2 = 1 << (shift2 - 1);
  int maxv = (1 << bd) - 1;
  for (int i = 0; i < w * h; ++i) {
    int32_t v = (a[i] + b[i] + off2) >> shift2;
    out[i] = std::min(maxv, std::max(0, v));
  }
}

void mc_predict_bi_wp(const pel_t* r0, const pel_t* r1, int rw, int pad,
                      int mv0x, int mv0y, int mv1x, int mv1y, int x0,
                      int y0, int w, int h, int bd, bool is_luma,
                      int w0, int o0, int w1, int o1, int denom,
                      int32_t* out) {
  int32_t a[64 * 64], b[64 * 64];
  auto raw = [&](const pel_t* r, int mvx, int mvy, int32_t* o) {
    int ix, fx, iy, fy;
    if (is_luma) {
      ix = mvx >> 2; fx = mvx & 3; iy = mvy >> 2; fy = mvy & 3;
    } else {
      ix = mvx >> 3; fx = mvx & 7; iy = mvy >> 3; fy = mvy & 7;
    }
    mc_block(r, rw, pad, x0 + ix, y0 + iy, w, h, fx, fy, bd, is_luma, true,
             o);
  };
  raw(r0, mv0x, mv0y, a);
  raw(r1, mv1x, mv1y, b);
  // spec 8.5.3.3.4.3: log2Wd = denom + shift1; explicit bi combine is
  // (p0*w0 + p1*w1 + ((o0+o1+1) << log2Wd)) >> (log2Wd + 1). Offsets
  // scale by the WpOffsetBdShift (bd - 8) like the uni path.
  int log2wd = denom + std::max(2, 14 - bd);
  o0 <<= bd - 8;
  o1 <<= bd - 8;
  int64_t rnd = ((int64_t)(o0 + o1 + 1)) << log2wd;
  int maxv = (1 << bd) - 1;
  for (int i = 0; i < w * h; ++i) {
    int64_t v = ((int64_t)a[i] * w0 + (int64_t)b[i] * w1 + rnd)
                >> (log2wd + 1);
    out[i] = (int32_t)std::min<int64_t>(maxv, std::max<int64_t>(0, v));
  }
}

bool intra_filter_flag(int mode, int n, bool smooth_like_luma) {
  if (!smooth_like_luma || n == 4 || mode == 1) return false;
  int min_dist =
      mode == 0 ? 10 : std::min(std::abs(mode - 26), std::abs(mode - 10));
  return min_dist > kIntraFilterThresh[ilog2(n)];
}

bool intra_strong_smoothing(const int32_t* f, int n, int bd) {
  // spec 8.4.4.2.3 bi-linearity test (nTbS == 32 only)
  if (n != 32) return false;
  int n2 = 2 * n;
  int thr = 1 << (bd - 5);
  int corner = f[n2];
  int topmid = f[n2 + n], topend = f[n2 + 2 * n];
  int leftmid = f[n2 - n], leftend = f[0];
  bool top_ok = std::abs(corner + topend - 2 * topmid) < thr;
  bool left_ok = std::abs(corner + leftend - 2 * leftmid) < thr;
  return top_ok && left_ok;
}

void intra_filter_refs(const int32_t* f, int n, int /*bd*/, bool strong,
                       int32_t* ff) {
  int nn = 4 * n + 1;
  int n2 = 2 * n;
  if (strong) {
    // linear interpolation between corners (spec 8.4.4.2.3)
    int corner = f[n2], topend = f[4 * n], leftend = f[0];
    int sh = ilog2(n) + 1;
    for (int i = 0; i < nn; ++i) ff[i] = f[i];
    for (int x = 1; x < 2 * n; ++x) {
      ff[n2 + x] = ((2 * n - x) * corner + x * topend + n) >> sh;
      ff[n2 - x] = ((2 * n - x) * corner + x * leftend + n) >> sh;
    }
    return;
  }
  for (int i = 0; i < nn; ++i) {
    if (i == 0 || i == nn - 1) {
      ff[i] = f[i];
    } else {
      ff[i] = (f[i - 1] + 2 * f[i] + f[i + 1] + 2) >> 2;
    }
  }
}

int64_t tb_writeback(const int32_t* lev, int tz, int16_t* lv_out,
                     int lv_stride, const int32_t* pred, int pstride,
                     const int32_t* res, const int32_t* ccp,
                     const pel_t* org, int ostride, pel_t* rec,
                     int rstride, int maxv) {
  // One fused pass per row: this loop is memory-bound on the target
  // hosts (recon/coeff planes stream through cache), so a single pass
  // beats split per-type vectorizable loops measured 1.5x slower.
  int64_t isse = 0;
  for (int i = 0; i < tz; ++i) {
    const int32_t* lv = lev + i * tz;
    int16_t* lo = lv_out + (long)i * lv_stride;
    const int32_t* pi = pred + (long)i * pstride;
    const int32_t* ri = res + i * tz;
    const int32_t* ci = ccp ? ccp + i * tz : nullptr;
    pel_t* rc = rec + (long)i * rstride;
    const pel_t* oi = org + (long)i * ostride;
    int64_t s = 0;
    for (int j = 0; j < tz; ++j) {
      lo[j] = (int16_t)lv[j];
      int32_t v = pi[j] + ri[j] + (ci ? ci[j] : 0);
      pel_t rv = (pel_t)(v < 0 ? 0 : (v > maxv ? maxv : v));
      rc[j] = rv;
      int e = (int)oi[j] - (int)rv;
      s += (int64_t)e * e;
    }
    isse += s;
  }
  return isse;
}

int64_t sse_pred(const pel_t* org, int ostride, const int32_t* pred,
                 int pstride, int w, int h) {
  int64_t isse = 0;
  for (int i = 0; i < h; ++i) {
    const pel_t* oi = org + (long)i * ostride;
    const int32_t* pi = pred + (long)i * pstride;
    int64_t s = 0;
    for (int j = 0; j < w; ++j) {
      int e = (int)oi[j] - pi[j];
      s += (int64_t)e * e;
    }
    isse += s;
  }
  return isse;
}

void intra_predict(const int32_t* f_sel, const int32_t* fu, int mode, int n,
                   int bd, bool is_luma, int32_t* out) {
  int n2 = 2 * n;
  int maxv = (1 << bd) - 1;
  const int32_t* f = f_sel;
  // top[x] = f[n2+1+x]; left[y] = f[n2-1-y]; corner = f[n2]
  if (mode == 0) {  // planar
    int lg = ilog2(n);
    for (int y = 0; y < n; ++y)
      for (int x = 0; x < n; ++x) {
        int64_t v = (int64_t)(n - 1 - x) * f[n2 - 1 - y] +
                    (int64_t)(x + 1) * f[n2 + 1 + n] +
                    (int64_t)(n - 1 - y) * f[n2 + 1 + x] +
                    (int64_t)(y + 1) * f[n2 - 1 - n] + n;
        out[y * n + x] = (int32_t)(v >> (lg + 1));
      }
    return;
  }
  if (mode == 1) {  // DC (always from unfiltered refs)
    int64_t s = 0;
    for (int i = 0; i < n; ++i) s += fu[n2 + 1 + i] + fu[n2 - 1 - i];
    int dc = (int)((s + n) >> (ilog2(n) + 1));
    for (int i = 0; i < n * n; ++i) out[i] = dc;
    if (is_luma && n < 32) {
      for (int x = 1; x < n; ++x)
        out[x] = (fu[n2 + 1 + x] + 3 * dc + 2) >> 2;
      for (int y = 1; y < n; ++y)
        out[y * n] = (fu[n2 - 1 - y] + 3 * dc + 2) >> 2;
      out[0] = (fu[n2 - 1] + 2 * dc + fu[n2 + 1] + 2) >> 2;
    }
    return;
  }
  int angle = kIntraAngle[mode - 2];
  bool vertical = mode >= 18;
  // main reference ref[j], j in [-n, 2n] at offset +n
  int32_t ref[3 * 32 + 1];
  for (int j = 0; j <= 3 * n; ++j) ref[j] = 0;
  ref[n] = f[n2];
  for (int i = 0; i < 2 * n; ++i)
    ref[n + 1 + i] = vertical ? f[n2 + 1 + i] : f[n2 - 1 - i];
  if (angle < 0 && ((n * angle) >> 5) < -1) {
    int inv = kIntraInvAngle[mode - 11];
    for (int xi = -1; xi > ((n * angle) >> 5) - 1; --xi) {
      int q = (xi * inv + 128) >> 8;
      ref[xi + n] = (q == 0) ? f[n2]
                             : (vertical ? f[n2 - 1 - (q - 1 < 0 ? 0 : q - 1)]
                                         : f[n2 + 1 + (q - 1 < 0 ? 0 : q - 1)]);
    }
  }
  for (int y = 1; y <= n; ++y) {
    int ii = (y * angle) >> 5;
    int fa = (y * angle) & 31;
    for (int x = 0; x < n; ++x) {
      int j1 = x + ii + 1 + n;
      int32_t r1 = ref[j1];
      int32_t r2 = ref[std::min(j1 + 1, 3 * n)];
      int32_t v = fa ? (((32 - fa) * r1 + fa * r2 + 16) >> 5) : r1;
      if (vertical)
        out[(y - 1) * n + x] = v;
      else
        out[x * n + (y - 1)] = v;
    }
  }
  if (is_luma && n < 32) {
    if (mode == 26) {
      for (int y = 0; y < n; ++y) {
        int32_t v = fu[n2 + 1] + ((fu[n2 - 1 - y] - fu[n2]) >> 1);
        out[y * n] = std::min(maxv, std::max(0, v));
      }
    } else if (mode == 10) {
      for (int x = 0; x < n; ++x) {
        int32_t v = fu[n2 - 1] + ((fu[n2 + 1 + x] - fu[n2]) >> 1);
        out[x] = std::min(maxv, std::max(0, v));
      }
    }
  }
}

}  // namespace dsp
}  // namespace hevctpu
