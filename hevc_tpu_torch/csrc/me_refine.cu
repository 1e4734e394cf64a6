// The two options of the integer motion search that have kernels of their
// own (hevc_tpu_torch/ops/me_ssd.py wp_apply_multi and refine_tables).
//
// wp_apply replaces hevc_tpu/ops/me_mxu.py wp_apply, an elementwise XLA
// program that the reference maps over every reference of a picture
// (lax.map): per sample of a padded reference plane
//   clip(((s * w + rnd) >> d) + (o << max(depth - 8, 0)), 0, 2^depth - 1)
// in int32 with arithmetic shifts, into a new plane (the cached reference
// is shared by other frames). One launch transforms up to kWpMax planes:
// their pointers and triples travel by value in the argument struct, and a
// grid-stride loop walks the concatenation of their 16-byte words (then
// the samples one by one: the tail of each plane, and every sample of a
// plane that is not 16-byte aligned), a thread a unit up to one wave of
// resident thread blocks, and past that up to kWpUnroll loads a thread
// issued before it transforms and stores them. Bound: bytes, one read and
// one write of every plane.
//
// refine_tables replaces me_mxu.py _build_phases, _satd_of_tiles and
// _refine_direct: the host's half- then quarter-pel SATD refinement around
// every grid block's integer MV. One thread block (size 32, 128 threads)
// or one warp (size 16, two a thread block) takes a search block, with one
// lane per column of each 8x8 Hadamard tile:
//  1. stage the (size + 8)^2 reference window of integer shifts -1 and 0
//     in shared memory, and the lane's 8 original samples in registers;
//  2. a phase cache, built once: the horizontal intermediates
//     H_f = acc_f >> s1 of the three fractional phases over (size + 8) x
//     (size + 1) outputs, a lane taking a run of RL outputs of a row from
//     one load of its RL + 7 window samples (RL = 11 for 32x32, 17 for
//     16x16: one round of jobs); then the half phases
//     P20 = finish(V2(window) >> s1) and P22 = finish(V2(H_2) >> 6), a
//     lane a run down a column;
//  3. the nine half-stage tiles are reads (P02 = finish(H_2) at read);
//     each quarter candidate's tile is one vertical pass of the lane's
//     column over H_fx (or over the window, or a read of H_fx), its taps
//     compile-time constants: a switch on the block-uniform phase picks
//     the instance. No quarter phase is written;
//  4. the SATD: the lane's column through an 8-point Hadamard in
//     registers, a transpose through a per-warp scratch (two 16-byte
//     stores between two __syncwarp, eight loads), the row transform with
//     its last stage folded (|a + b| + |a - b| = 2 max(|a|, |b|)); the
//     tiles' (s + 2) >> 2 and their sums by shuffles after each stage, off
//     the candidates' path;
//  5. the host's strict-< orders replayed on the gathered costs. Barriers:
//     five a 32x32 search block (after the window, the H caches, the P
//     caches and each stage's costs); warp barriers only for 16x16.
// The arithmetic runs in float32 on the FMA pipes: every value is an
// integer below 2^24 (|H_f| <= 112 * 16383, a vertical sum over H below
// 1.3e7, a tile's sum of |coefficient| at most 64 * 8 * 16383), so each sum
// and product is exact, and each of the reference's shifts is one fma
// rounded down onto a 2^23 offset (kMagic). The shift order is the
// reference's: finish(acc >> s1) = clip((acc + 32) >> 6) and
// finish(V >> 6) = clip((V + (32 << hr)) >> (hr + 6)); prediction samples
// are clipped to 2^depth - 1. Bound: operations, the interpolation's
// multiply-adds and the Hadamard's additions over the 67 T/s float32 rate.
// nvcc 12.8 for sm_90a: 56-64 registers, no spills; 40272 bytes of dynamic
// shared memory a 32x32 thread block, 24992 a 16x16 one (two search
// blocks), 122832 and 75296 with WIDE (chip_smoke.py prints them).
//
// The tile starts follow the reference's lax.dynamic_slice: a negative
// start counts from the end of the phase plane, and a start is clamped so
// that the tile fits. That happens only for r > pad - 4; the host then
// launches the WIDE variant, whose window and caches hold the row ranges
// and the column ranges of integer shifts -1 and 0 apart.
#include <algorithm>
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------- wp_apply
constexpr int kWpMax = 8;
constexpr int kWpUnroll = 4;
constexpr int kWpThreads = 256;

struct WpArgs {
  int w, rnd, d, off, maxv;
};

struct WpPlanes {
  const void* in[kWpMax];
  void* out[kWpMax];
  long long start[kWpMax + 1];  // first unit of each plane; start[count]
  long long nvec[kWpMax];       // the plane's 16-byte words (0: unaligned)
  int w[kWpMax], rnd[kWpMax], d[kWpMax], off[kWpMax];
  int count, maxv;
};

__device__ __forceinline__ int wp_sample(int s, const WpArgs& a) {
  const int v = add_wrap(mul_wrap(s, a.w), a.rnd) >> a.d;
  return min(max(add_wrap(v, a.off), 0), a.maxv);
}

// The samples of one 32-bit word of T (uint8_t or int16_t), transformed.
template <typename T>
__device__ __forceinline__ unsigned wp_word(unsigned x, const WpArgs& a) {
  constexpr int BITS = 8 * sizeof(T);
  constexpr unsigned MASK = (1u << BITS) - 1u;
  unsigned y = 0;
#pragma unroll
  for (int k = 0; k < 32 / BITS; ++k) {
    const int s = static_cast<T>((x >> (BITS * k)) & MASK);
    y |= (static_cast<unsigned>(wp_sample(s, a)) & MASK) << (BITS * k);
  }
  return y;
}

// Units of the concatenated space: plane p's 16-byte words, then its
// remaining samples one by one.
template <typename T>
__global__ void __launch_bounds__(kWpThreads)
    wp_apply_kernel(const WpPlanes a) {
  constexpr long long PER = 16 / sizeof(T);
  const long long total = a.start[a.count];
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g0 =
           static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       g0 < total; g0 += kWpUnroll * step) {
    uint4 v[kWpUnroll];
    int pl[kWpUnroll];
    long long li[kWpUnroll];
#pragma unroll
    for (int u = 0; u < kWpUnroll; ++u) {
      const long long g = g0 + u * step;
      pl[u] = -1;
      if (g < total) {
        int p = 0;
        while (p + 1 < a.count && g >= a.start[p + 1]) ++p;
        pl[u] = p;
        li[u] = g - a.start[p];
        if (li[u] < a.nvec[p])
          v[u] = __ldg(static_cast<const uint4*>(a.in[p]) + li[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kWpUnroll; ++u) {
      const int p = pl[u];
      if (p < 0) continue;
      const WpArgs w{a.w[p], a.rnd[p], a.d[p], a.off[p], a.maxv};
      if (li[u] < a.nvec[p]) {
        uint4 x = v[u];
        x.x = wp_word<T>(x.x, w);
        x.y = wp_word<T>(x.y, w);
        x.z = wp_word<T>(x.z, w);
        x.w = wp_word<T>(x.w, w);
        static_cast<uint4*>(a.out[p])[li[u]] = x;
      } else {
        const long long e = a.nvec[p] * PER + li[u] - a.nvec[p];
        static_cast<T*>(a.out[p])[e] = static_cast<T>(
            wp_sample(static_cast<int>(static_cast<const T*>(a.in[p])[e]),
                      w));
      }
    }
  }
}

// A thread a unit, up to one wave of resident thread blocks (measured on
// an H100 against a quarter of the threads, each with four units: faster
// at 1, 2 and 4 padded 1080p planes); past that each thread takes up to
// kWpUnroll units of a pass before it transforms them.
template <typename T>
cudaError_t launch_wp(const WpPlanes& a, long long total,
                      cudaStream_t stream) {
  static int wave = 0;
  if (wave == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, wp_apply_kernel<T>, kWpThreads, 0);
    if (e != cudaSuccess) return e;
    wave = std::max(1, sms * per_sm);
  }
  const long long blocks =
      std::min<long long>((total + kWpThreads - 1) / kWpThreads, wave);
  wp_apply_kernel<T><<<blocks, kWpThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// ----------------------------------------------------------- refine_tables
struct RefineArgs {
  const void* orig;
  long long ostride;
  const void* ref;  // padded reference plane [ref_h, ref_w]
  long long rstride;
  int ref_h, ref_w;
  const int* gidx;  // flat (dy, dx) argmin index per block
  int r, ny, nx, pad;
  // the bit depth's interpolation: the first pass's scale 2^-s1, finish's
  // offset 2^(hr-1) and scale 2^-hr, finish(V >> 6) as (V + rnd2) * 2^-sh2
  float s1_scale, off_u, hr_scale, rnd2, sh2_scale, maxv;
  int* off;
  int* half;
};

// lax.dynamic_slice's start on an axis of the phase planes (dim = padded
// extent - 7): negative counts from the end, then clamped to fit SIZE.
template <int SIZE>
__device__ __forceinline__ int slice_start(int s, int dim) {
  return min(max(s < 0 ? s + dim : s, 0), dim - SIZE);
}

// The arithmetic runs in float32 on integers below 2^24, so every sum and
// product is exact in any order. A float in [2^23, 2^24) is an integer
// plus kMagic's 2^23 offset: floor(x * scale) + kMagic is one fma rounded
// down (exact for |x * scale| < 2^22), and prediction samples are kept
// in that form, clipped to [kMagic, kMagic + maxv].
constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23

__device__ __forceinline__ float floor_m(float x, float scale) {
  return __fmaf_rd(x, scale, kMagic);
}

__device__ __forceinline__ float clip_m(float x, float maxv) {
  return fminf(fmaxf(x, kMagic), kMagic + maxv);
}

// init + the HEVC luma interpolation (TComInterpolationFilter) of phase
// F = 1, 2, 3 at v[i .. i + 7]; the half filter is symmetric.
template <int F, int N>
__device__ __forceinline__ float filt(const float (&v)[N], int i,
                                      float init) {
  if constexpr (F == 1)
    return init - v[i] + 4.f * v[i + 1] - 10.f * v[i + 2] + 58.f * v[i + 3] +
           17.f * v[i + 4] - 5.f * v[i + 5] + v[i + 6];
  else if constexpr (F == 2)
    return init + 40.f * (v[i + 3] + v[i + 4]) - 11.f * (v[i + 2] + v[i + 5]) +
           4.f * (v[i + 1] + v[i + 6]) - (v[i] + v[i + 7]);
  else
    return init + v[i + 1] - 5.f * v[i + 2] + 17.f * v[i + 3] +
           58.f * v[i + 4] - 10.f * v[i + 5] + 4.f * v[i + 6] - v[i + 7];
}

// Shared-memory layout of one search block, in 32-bit words (floats).
// Rows and columns of integer shift -1 start at 0, those of shift 0 at
// the second offset (1 when the two ranges overlap; apart for WIDE).
template <int SIZE, bool WIDE>
struct RefineLayout {
  static constexpr int T = SIZE / 8;         // tiles a side
  static constexpr int LANES = T * T * 8;    // one lane a tile column
  static constexpr int WARPS = LANES / 32;
  static constexpr int SPAN = SIZE + 7;      // rows a tile's taps read
  // window and H-cache rows (R1 = 1 mod 4: the quarter loads' offset)
  static constexpr int R1 = WIDE ? ((SPAN + 3) & ~3) + 1 : 1;
  static constexpr int ROWS = R1 + SPAN;
  // window columns; odd pitch, so a column read spreads over the banks
  static constexpr int C1 = WIDE ? SPAN : 1;
  static constexpr int WCOLS = C1 + SPAN;
  static constexpr int WP = WCOLS | 1;
  // H caches, column-major: HCOLS phase columns of HP rows (HP = 4 mod 8:
  // the 8 lanes of a tile read 16-byte words in 8 distinct bank groups)
  static constexpr int HC1 = WIDE ? SIZE : 1;
  static constexpr int HCOLS = HC1 + SIZE;
  static constexpr int HP = (ROWS + 3) / 8 * 8 + 4;
  // P caches, column-major: PROWS rows of pitch PP (room for 12-word reads)
  static constexpr int PR1 = WIDE ? SIZE : 1;
  static constexpr int PROWS = PR1 + SIZE;
  static constexpr int PP = (PROWS + 6) / 8 * 8 + 4;
  // outputs a lane takes in a cache pass: RL divides HCOLS and PROWS
  // (33 = 3 x 11 and 17), so one round of jobs covers a 32x32 block's H
  // pass (120 jobs) and its P pass (99), and a 16x16 block's (24, 17); with
  // WIDE 8, so that a run stays in one range
  static constexpr int RL = WIDE ? 8 : (SIZE == 32 ? 11 : 17);
  // transpose scratch: per warp 4 tiles x 8 columns; column pitch 12, tile
  // pitch 104 (both conflict-free)
  static constexpr int TP = 104;
  static constexpr int SCR = 4 * TP;
  // word offsets; the quarter stage's lane sums ([8][LANES], O_QS) take
  // the P caches' place, which the half stage leaves free
  static constexpr int O_H = (ROWS * WP + 3) & ~3;
  static constexpr int O_P20 = O_H + 3 * HCOLS * HP;
  static constexpr int O_P22 = O_P20 + SIZE * PP;
  static constexpr int O_SCR = O_P22 + HCOLS * PP;
  static constexpr int O_QS = O_P20;
  static constexpr int O_RED = O_SCR + WARPS * SCR;  // [WARPS][9 + 8]
  static constexpr int WORDS = (O_RED + WARPS * 17 + 3) & ~3;
  static_assert(8 * LANES <= O_SCR - O_P20, "lane sums outgrow the P caches");
};

// search blocks a thread block: one of 32x32 (its warps meet at
// __syncthreads), two of 16x16 (a warp each, warp barriers only)
template <int SIZE>
__host__ __device__ constexpr int refine_sb() { return SIZE == 32 ? 1 : 2; }

template <int SIZE>
__host__ __device__ constexpr int refine_threads() {
  return (SIZE / 8) * (SIZE / 8) * 8 * refine_sb<SIZE>();
}

template <int SIZE>
__device__ __forceinline__ void refine_sync() {
  if constexpr (SIZE == 32)
    __syncthreads();
  else
    __syncwarp();
}

// v[k] = p[k], k < N <= 15, where p - M is 16-byte aligned
template <int M, int N>
__device__ __forceinline__ void load_col(const float* p, float (&v)[N]) {
  constexpr int W = (N + M + 3) / 4;
  const float4* q = reinterpret_cast<const float4*>(p - M);
  float t[4 * W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const float4 x = q[w];
    t[4 * w] = x.x;
    t[4 * w + 1] = x.y;
    t[4 * w + 2] = x.z;
    t[4 * w + 3] = x.w;
  }
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = t[k + M];
}

// the same where the offset m (0 or 1) is known at run time only
template <int N>
__device__ __forceinline__ void load_col(const float* p, int m,
                                         float (&v)[N]) {
  if (m)
    load_col<1>(p, v);
  else
    load_col<0>(p, v);
}

// One search block's view of shared memory and of its lane.
template <int SIZE, bool WIDE>
struct RefineLane {
  using L = RefineLayout<SIZE, WIDE>;
  const float* win;
  const float* hc;  // H_1, H_2, H_3
  float* scr;       // this tile's scratch
  int ty, tx, j;
  float om[8];      // the lane's original samples + kMagic
  float off_u, hr_scale, rnd2, sh2_scale, maxv;

  // the 8 prediction samples of the lane's tile column at quarter phase
  // (FY, FX), integer shifts sy, sx (0: shift -1, 1: shift 0), subtracted
  // from the originals; SY is sy, known at compile time for 2-D phases
  template <int FY, int FX, int SY = -1>
  __device__ __forceinline__ void quarter(int sy, int sx,
                                          float (&d)[8]) const {
    const int hcol = (sx ? L::HC1 : 0) + 8 * tx + j;
    const int rb = (sy ? L::R1 : 0) + 8 * ty;
    if constexpr (FY == 0 && FX == 0) {
      const float* s =
          win + (L::R1 + 3 + 8 * ty) * L::WP + L::C1 + 3 + 8 * tx + j;
#pragma unroll
      for (int i = 0; i < 8; ++i) d[i] = (om[i] - kMagic) - s[i * L::WP];
      return;
    }
    float p[8];
    if constexpr (FY == 0) {  // finish(H_fx) on the integer row
      float v[8];
      load_col<0>(hc + (FX - 1) * L::HCOLS * L::HP + hcol * L::HP + L::R1 +
                      3 + 8 * ty,
                  v);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        p[i] = clip_m(floor_m(v[i] + off_u, hr_scale), maxv);
    } else if constexpr (FX == 0) {  // finish(V(window) >> s1)
      const float* s = win + rb * L::WP + L::C1 + 3 + 8 * tx + j;
      float v[15];
#pragma unroll
      for (int t = 0; t < 15; ++t) v[t] = s[t * L::WP];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        p[i] = clip_m(floor_m(filt<FY>(v, i, 32.f), 1.f / 64), maxv);
    } else {  // finish(V(H_fx) >> 6); R1 = 1 mod 4, so the offset is sy
      static_assert(SY == 0 || SY == 1, "a 2-D phase needs sy at compile "
                                        "time");
      float v[15];
      load_col<SY>(hc + (FX - 1) * L::HCOLS * L::HP + hcol * L::HP + rb, v);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        p[i] = clip_m(floor_m(filt<FY>(v, i, rnd2), sh2_scale), maxv);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) d[i] = om[i] - p[i];
  }

  // a half-phase tile read from a P cache
  __device__ __forceinline__ void cached(const float* pc, int col, int sy,
                                         float (&d)[8]) const {
    float p[8];
    load_col(pc + col * L::PP + (sy ? L::PR1 : 0) + 8 * ty, WIDE ? 0 : sy, p);
#pragma unroll
    for (int i = 0; i < 8; ++i) d[i] = om[i] - p[i];
  }

  // quarter() at a block-uniform phase known at run time: a switch on fy,
  // then on fx, and for the two-dimensional phases on sy
  template <int FY>
  __device__ __forceinline__ void dispatch_fx(int fx, int sy, int sx,
                                              float (&d)[8]) const {
    if constexpr (FY == 0) {
      if (fx == 1)
        quarter<0, 1>(sy, sx, d);
      else if (fx == 2)
        quarter<0, 2>(sy, sx, d);
      else
        quarter<0, 3>(sy, sx, d);
    } else {
      switch (fx) {
        case 0: quarter<FY, 0>(sy, sx, d); break;
        case 1: sy ? quarter<FY, 1, 1>(sy, sx, d)
                   : quarter<FY, 1, 0>(sy, sx, d); break;
        case 2: sy ? quarter<FY, 2, 1>(sy, sx, d)
                   : quarter<FY, 2, 0>(sy, sx, d); break;
        default: sy ? quarter<FY, 3, 1>(sy, sx, d)
                    : quarter<FY, 3, 0>(sy, sx, d); break;
      }
    }
  }

  __device__ __forceinline__ void dispatch(int fy, int fx, int sy, int sx,
                                           float (&d)[8]) const {
    switch (fy) {
      case 0: dispatch_fx<0>(fx, sy, sx, d); break;
      case 1: dispatch_fx<1>(fx, sy, sx, d); break;
      case 2: dispatch_fx<2>(fx, sy, sx, d); break;
      default: dispatch_fx<3>(fx, sy, sx, d); break;
    }
  }

  // The lane's share of dsp::satd of its tile, given its column of
  // differences: half the sum of |coefficient| over one row of the
  // transform.
  __device__ __forceinline__ float satd(float (&d)[8]) const {
#pragma unroll
    for (int h = 1; h < 8; h <<= 1)
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (!(k & h)) {
          const float u = d[k], v = d[k + h];
          d[k] = u + v;
          d[k + h] = u - v;
        }
    __syncwarp();  // the previous candidate's rows are read
    float4* w = reinterpret_cast<float4*>(scr + j * 12);
    w[0] = make_float4(d[0], d[1], d[2], d[3]);
    w[1] = make_float4(d[4], d[5], d[6], d[7]);
    __syncwarp();
    float e[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) e[k] = scr[k * 12 + j];
#pragma unroll
    for (int h = 1; h < 4; h <<= 1)
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (!(k & h)) {
          const float u = e[k], v = e[k + h];
          e[k] = u + v;
          e[k + h] = u - v;
        }
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) s += fmaxf(fabsf(e[k]), fabsf(e[k + 4]));
    return s;
  }
};

// dsp::satd's (s + 2) >> 2 of each 8x8 tile (s twice the sum of its 8
// lanes' shares), summed over the warp's four tiles; every lane gets it.
__device__ __forceinline__ int warp_tiles(float s) {
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  int c = __float_as_int(floor_m(s + 1.f, 0.5f)) - __float_as_int(kMagic);
  c += __shfl_xor_sync(0xffffffffu, c, 8);
  c += __shfl_xor_sync(0xffffffffu, c, 16);
  return c;
}

template <typename T, int SIZE, bool WIDE, bool HALF_ONLY>
__global__ void __launch_bounds__(refine_threads<SIZE>())
    refine_tables_kernel(RefineArgs a) {
  using L = RefineLayout<SIZE, WIDE>;
  constexpr int SB = refine_sb<SIZE>();
  extern __shared__ __align__(16) float smem[];
  const int sb = threadIdx.x / L::LANES, lt = threadIdx.x % L::LANES;
  const int n = a.ny * a.nx;
  const int b = blockIdx.x * SB + sb;
  if (b >= n) return;  // a whole warp of a 16x16 thread block
  float* base = smem + sb * L::WORDS;
  float* win = base;
  float* hc = base + L::O_H;
  float* p20 = base + L::O_P20;
  float* p22 = base + L::O_P22;
  float* qs = base + L::O_QS;
  int* red = reinterpret_cast<int*>(base + L::O_RED);  // [WARPS][9 + 8]
  const int warp = lt >> 5;

  const int by = (b / a.nx) * SIZE, bx = (b % a.nx) * SIZE;
  const int nyx = 2 * a.r + 1;
  const int g = a.gidx[b];
  // plane (y', x') of a phase is padded (y' + 3, x' + 3): the tile of
  // integer shift s starts at plane row pad + by + mvy - 3 + s
  const int base_r = a.pad + by + g / nyx - a.r - 3;
  const int base_c = a.pad + bx + g % nyx - a.r - 3;
  const int h2 = a.ref_h - 7, w2 = a.ref_w - 7;
  const int tr0 = slice_start<SIZE>(base_r - 1, h2);
  const int tr1 = slice_start<SIZE>(base_r, h2);
  const int tc0 = slice_start<SIZE>(base_c - 1, w2);
  const int tc1 = slice_start<SIZE>(base_c, w2);

  // 1. the window (without WIDE tr1 = tr0 + 1, tc1 = tc0 + 1, one block
  // at (tr0, tc0)): a lane issues a batch of loads before it stores them
  {
    constexpr int TOTAL = L::ROWS * L::WCOLS;
    constexpr int PER = (TOTAL + L::LANES - 1) / L::LANES;
    constexpr int BATCH = PER < 18 ? PER : 18;
    const int rs = static_cast<int>(a.rstride);
    const T* ref = static_cast<const T*>(a.ref) +
                   (WIDE ? 0 : static_cast<long long>(tr0) * rs + tc0);
    for (int k0 = lt; k0 < TOTAL; k0 += BATCH * L::LANES) {
      float v[BATCH];
#pragma unroll
      for (int q = 0; q < BATCH; ++q) {
        const int k = k0 + q * L::LANES;
        const int wr = k / L::WCOLS, wc = k - wr * L::WCOLS;
        int at = wr * rs + wc;
        bool live = k < TOTAL;
        if constexpr (WIDE) {
          live = live && (wr < L::SPAN || wr >= L::R1);
          at = (wr < L::R1 ? tr0 + wr : tr1 + wr - L::R1) * rs +
               (wc < L::C1 ? tc0 + wc : tc1 + wc - L::C1);
        }
        v[q] = live ? static_cast<float>(ref[at]) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < BATCH; ++q) {
        const int k = k0 + q * L::LANES;
        const int wr = k / L::WCOLS;
        if (k < TOTAL) win[wr * L::WP + k - wr * L::WCOLS] = v[q];
      }
    }
  }
  RefineLane<SIZE, WIDE> ln;
  {
    const int tile = lt >> 3;
    ln.j = lt & 7;
    ln.ty = tile / L::T;
    ln.tx = tile % L::T;
    const T* orig = static_cast<const T*>(a.orig) +
                    (by + 8 * ln.ty) * a.ostride + bx + 8 * ln.tx + ln.j;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      ln.om[i] = static_cast<float>(orig[i * a.ostride]) + kMagic;
    ln.scr = base + L::O_SCR + warp * L::SCR + (tile & 3) * L::TP;
  }
  ln.win = win;
  ln.hc = hc;
  ln.off_u = a.off_u;
  ln.hr_scale = a.hr_scale;
  ln.rnd2 = a.rnd2;
  ln.sh2_scale = a.sh2_scale;
  ln.maxv = a.maxv;
  refine_sync<SIZE>();

  // 2a. H_1, H_2, H_3 = acc >> s1: a lane takes RL outputs of a row from
  // one load of its RL + 7 window samples
  {
    constexpr int RUNS = L::HCOLS / L::RL;
    constexpr int HS = L::HCOLS * L::HP;
    for (int k = lt; k < L::ROWS * RUNS; k += L::LANES) {
      const int u = k / RUNS, c0 = k % RUNS * L::RL;
      if (WIDE && u >= L::SPAN && u < L::R1) continue;  // the gap rows
      const float* s =
          win + u * L::WP + (c0 < L::HC1 ? c0 : L::C1 + c0 - L::HC1);
      float w[L::RL + 7];
#pragma unroll
      for (int t = 0; t < L::RL + 7; ++t) w[t] = s[t];
      float* h = hc + c0 * L::HP + u;
#pragma unroll
      for (int i = 0; i < L::RL; ++i) {
        h[i * L::HP] = floor_m(filt<1>(w, i, 0.f), a.s1_scale) - kMagic;
        h[HS + i * L::HP] = floor_m(filt<2>(w, i, 0.f), a.s1_scale) - kMagic;
        h[2 * HS + i * L::HP] =
            floor_m(filt<3>(w, i, 0.f), a.s1_scale) - kMagic;
      }
    }
  }
  refine_sync<SIZE>();

  // 2b. P22 = finish(V2(H_2) >> 6) over HCOLS columns and P20 =
  // finish(V2(window) >> s1) over the first SIZE, kept with the kMagic
  // offset: a lane takes RL rows of a column of both
  {
    constexpr int RUNS = L::PROWS / L::RL;
    const float* h2c = hc + L::HCOLS * L::HP;
    for (int k = lt; k < L::HCOLS * RUNS; k += L::LANES) {
      const int c = k / RUNS, u0 = k % RUNS * L::RL;
      const int sr = u0 < L::PR1 ? u0 : L::R1 + u0 - L::PR1;
      float v[L::RL + 7];
      const float* s = h2c + c * L::HP + sr;
#pragma unroll
      for (int t = 0; t < L::RL + 7; ++t) v[t] = s[t];
      float* out = p22 + c * L::PP + u0;
#pragma unroll
      for (int i = 0; i < L::RL; ++i)
        out[i] = clip_m(floor_m(filt<2>(v, i, a.rnd2), a.sh2_scale), a.maxv);
      if (c < SIZE) {
        s = win + sr * L::WP + L::C1 + 3 + c;
#pragma unroll
        for (int t = 0; t < L::RL + 7; ++t) v[t] = s[t * L::WP];
        out = p20 + c * L::PP + u0;
#pragma unroll
        for (int i = 0; i < L::RL; ++i)
          out[i] = clip_m(floor_m(filt<2>(v, i, 32.f), 1.f / 64), a.maxv);
      }
    }
  }
  refine_sync<SIZE>();

  // 3. half stage: the 9 candidates (dy outer, dx inner) as reads, with
  // no barrier between them; their costs gathered after
  {
    float hs[9];
    const int col = 8 * ln.tx + ln.j;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int sy = k / 3 != 0, sx = k % 3 != 0;  // dy, dx = -2: shift -1
      float d[8];
      if (k == 4)
        ln.template quarter<0, 0>(sy, sx, d);
      else if (k == 3 || k == 5)  // P02 = finish(H_2)
        ln.template quarter<0, 2>(sy, sx, d);
      else if (k == 1 || k == 7)
        ln.cached(p20, col, sy, d);
      else
        ln.cached(p22, (sx ? L::HC1 : 0) + col, sy, d);
      hs[k] = ln.satd(d);
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int c = warp_tiles(hs[k]);
      if ((lt & 31) == 0) red[warp * 9 + k] = c;
    }
  }
  refine_sync<SIZE>();
  int bc = 0, cy = 0, cx = 0, hmin = 0;
  {
    int hv[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      hv[k] = 0;
#pragma unroll
      for (int w = 0; w < L::WARPS; ++w) hv[k] += red[w * 9 + k];
    }
    bc = hv[4];
    hmin = hv[4];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      hmin = min(hmin, hv[k]);
      if (k != 4 && hv[k] < bc) {
        bc = hv[k];
        cy = (k / 3 - 1) * 2;
        cx = (k % 3 - 1) * 2;
      }
    }
  }
  int qby = cy, qbx = cx;
  if constexpr (!HALF_ONLY) {
    // 4. quarter stage: the 8 candidates around the half winner; each
    // phase once, picked by a switch on the block-uniform (fy, fx); a
    // lane keeps its shares in its own slots of qs
    int* redq = red + L::WARPS * 9;
#pragma unroll 1
    for (int k = 0; k < 8; ++k) {
      const int kk = k < 4 ? k : k + 1;
      const int qy = cy + kk / 3 - 1, qx = cx + kk % 3 - 1;
      const int sy = (qy >> 2) + 1, sx = (qx >> 2) + 1;
      float d[8];
      ln.dispatch(qy & 3, qx & 3, sy, sx, d);
      qs[k * L::LANES + lt] = ln.satd(d);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = warp_tiles(qs[k * L::LANES + lt]);
      if ((lt & 31) == 0) redq[warp * 8 + k] = c;
    }
    refine_sync<SIZE>();
#pragma unroll 1
    for (int k = 0; k < 8; ++k) {
      int c = 0;
#pragma unroll
      for (int w = 0; w < L::WARPS; ++w) c += redq[w * 8 + k];
      if (c < bc) {
        bc = c;
        const int kk = k < 4 ? k : k + 1;
        qby = cy + kk / 3 - 1;
        qbx = cx + kk % 3 - 1;
      }
    }
  }
  if (lt == 0) {
    a.off[b] = (qby + 3) * 7 + (qbx + 3);
    a.half[b] = hmin;
  }
}

template <typename T, int SIZE, bool WIDE, bool HALF_ONLY>
cudaError_t launch_refine_one(const RefineArgs& a, int n,
                              cudaStream_t stream) {
  using L = RefineLayout<SIZE, WIDE>;
  constexpr int SB = refine_sb<SIZE>();
  constexpr size_t bytes = 4u * SB * L::WORDS;
  auto kernel = refine_tables_kernel<T, SIZE, WIDE, HALF_ONLY>;
  static const cudaError_t attr = allow_smem(kernel, bytes);
  if (attr != cudaSuccess) return attr;
  kernel<<<(n + SB - 1) / SB, SB * L::LANES, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <bool HALF_ONLY>
int refine_entry(const void* orig, long long ostride, const void* ref,
                 long long rstride, int ref_h, int ref_w, int elem_bytes,
                 const int* gidx, int size, int r, int ny, int nx, int pad,
                 int depth, int* off, int* half, cudaStream_t stream) {
  const int n = ny * nx;
  if (n <= 0 || (elem_bytes != 1 && elem_bytes != 2) ||
      (size != 16 && size != 32) || depth < 8 || depth > 14 ||
      ref_h < size + 8 || ref_w < size + 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hr = depth > 12 ? 2 : 14 - depth;
  const RefineArgs a{orig, ostride, ref, rstride, ref_h, ref_w, gidx,
                     r, ny, nx, pad,
                     std::ldexp(1.f, hr - 6),
                     static_cast<float>(1 << (hr - 1)),
                     std::ldexp(1.f, -hr),
                     static_cast<float>(1 << (hr + 5)),
                     std::ldexp(1.f, -(hr + 6)),
                     static_cast<float>((1 << depth) - 1), off, half};
  // every tile start inside the phase planes, for every MV within +-r:
  // the window of shifts -1 and 0 is one (size + 8)^2 block
  const bool wide = pad - r - 4 < 0 ||
                    pad + (ny - 1) * size + r - 3 > ref_h - 7 - size ||
                    pad + (nx - 1) * size + r - 3 > ref_w - 7 - size;
#define HEVC_REFINE_CASE(T, S)                                            \
  return static_cast<int>(                                                \
      wide ? launch_refine_one<T, S, true, HALF_ONLY>(a, n, stream)       \
           : launch_refine_one<T, S, false, HALF_ONLY>(a, n, stream))
  if (elem_bytes == 1) {
    if (size == 32) HEVC_REFINE_CASE(uint8_t, 32);
    HEVC_REFINE_CASE(uint8_t, 16);
  }
  if (size == 32) HEVC_REFINE_CASE(int16_t, 32);
  HEVC_REFINE_CASE(int16_t, 16);
#undef HEVC_REFINE_CASE
}

}  // namespace

// desc: six rows of count int64 each: the planes' input and output
// pointers, their sample counts, and w, d, off of each. One launch over
// all of them.
extern "C" int hevc_wp_apply_multi(const long long* desc, int count,
                                   int elem_bytes, int depth,
                                   cudaStream_t stream) {
  if (count <= 0 || count > kWpMax || (elem_bytes != 1 && elem_bytes != 2) ||
      depth < 1 || depth > 14)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long *in = desc, *out = desc + count, *n = desc + 2 * count;
  const long long *w = desc + 3 * count, *d = desc + 4 * count,
                  *off = desc + 5 * count;
  WpPlanes a{};
  const long long per = 16 / elem_bytes;
  a.count = count;
  a.maxv = (1 << depth) - 1;
  a.start[0] = 0;
  for (int p = 0; p < count; ++p) {
    if (n[p] < 0 || d[p] < 0 || d[p] > 30)
      return static_cast<int>(cudaErrorInvalidValue);
    a.in[p] = reinterpret_cast<const void*>(in[p]);
    a.out[p] = reinterpret_cast<void*>(out[p]);
    a.w[p] = static_cast<int>(w[p]);
    a.d[p] = static_cast<int>(d[p]);
    a.rnd[p] = d[p] > 0 ? 1 << (d[p] - 1) : 0;
    a.off[p] = static_cast<int>(off[p]);
    const bool vec = in[p] % 16 == 0 && out[p] % 16 == 0;
    a.nvec[p] = vec ? n[p] / per : 0;
    a.start[p + 1] = a.start[p] + a.nvec[p] + n[p] - a.nvec[p] * per;
  }
  const long long total = a.start[count];
  if (total == 0) return 0;
  return static_cast<int>(
      elem_bytes == 1 ? launch_wp<uint8_t>(a, total, stream)
                      : launch_wp<int16_t>(a, total, stream));
}

extern "C" int hevc_refine_tables(const void* orig, long long ostride,
                                  const void* ref, long long rstride,
                                  int ref_h, int ref_w, int elem_bytes,
                                  const int* gidx, int size, int r, int ny,
                                  int nx, int pad, int depth, int* off,
                                  int* half, cudaStream_t stream) {
  return refine_entry<false>(orig, ostride, ref, rstride, ref_h, ref_w,
                             elem_bytes, gidx, size, r, ny, nx, pad, depth,
                             off, half, stream);
}

// The probe of chip_smoke.py: the same launch stopped after the half
// stage (off holds the half winner's offset). No encoder path calls it.
extern "C" int hevc_refine_tables_half(const void* orig, long long ostride,
                                       const void* ref, long long rstride,
                                       int ref_h, int ref_w, int elem_bytes,
                                       const int* gidx, int size, int r,
                                       int ny, int nx, int pad, int depth,
                                       int* off, int* half,
                                       cudaStream_t stream) {
  return refine_entry<true>(orig, ostride, ref, rstride, ref_h, ref_w,
                            elem_bytes, gidx, size, r, ny, nx, pad, depth,
                            off, half, stream);
}

// Dynamic shared memory of a refine_tables thread block (bytes), for the
// build report of chip_smoke.py; 0 for a size the kernel does not take.
extern "C" int hevc_refine_tables_smem(int size, int wide) {
  if (size == 32)
    return 4 * refine_sb<32>() *
           (wide ? RefineLayout<32, true>::WORDS
                 : RefineLayout<32, false>::WORDS);
  if (size == 16)
    return 4 * refine_sb<16>() *
           (wide ? RefineLayout<16, true>::WORDS
                 : RefineLayout<16, false>::WORDS);
  return 0;
}
