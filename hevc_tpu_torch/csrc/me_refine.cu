// The two options of the integer motion search that have kernels of their
// own (hevc_tpu_torch/ops/me_ssd.py wp_apply and refine_tables).
//
// wp_apply replaces hevc_tpu/ops/me_mxu.py wp_apply, an elementwise XLA
// program: per sample of a padded reference plane
//   clip(((s * w + rnd) >> d) + (o << max(depth - 8, 0)), 0, 2^depth - 1)
// in int32 with arithmetic shifts, into a new plane (the cached reference
// is shared by other frames). Bound: bytes, one read and one write of the
// plane; each thread moves 16 bytes a step.
//
// refine_tables replaces me_mxu.py _build_phases, _satd_of_tiles and
// _refine_direct. The XLA program writes 16 interpolated phase planes of the
// whole reference and gathers a tile from them for every block and
// candidate. Here one thread block (size 32) or one warp (size 16) takes a
// search block: it stages in shared memory the reference window its
// integer MV needs ((size + 8)^2 samples), interpolates only the tile each
// of its 17 candidates reads (9 half-pel around the integer MV, then 8
// quarter-pel around the half winner; no phase plane is written), takes the
// SATD with one lane per Hadamard row of each 8x8 tile (butterflies along
// the row in registers, down the columns by shuffles) and replays the
// host's strict-< orders. Bound: operations (the interpolation's
// multiply-adds and the Hadamard butterflies, 32-bit integer).
//
// The tile starts follow the reference's lax.dynamic_slice: a negative
// start counts from the end of the phase plane, and a start is clamped so
// that the tile fits. That happens only for r > pad - 4; the host then
// launches the WIDE variant, whose window holds the two row ranges and the
// two column ranges of integer shifts -1 and 0 apart.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------- wp_apply
struct WpArgs {
  int w, rnd, d, off, maxv;
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

// vec: both planes 16-byte aligned, so the body moves uint4 words; the
// samples past the last whole word (all of them when !vec) go one by one.
template <typename T>
__global__ void wp_apply_kernel(const T* __restrict__ in, T* __restrict__ out,
                                long long n, bool vec, WpArgs a) {
  constexpr long long PER = 16 / sizeof(T);
  const long long nvec = vec ? n / PER : 0;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t0 =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const uint4* in4 = reinterpret_cast<const uint4*>(in);
  uint4* out4 = reinterpret_cast<uint4*>(out);
  for (long long i = t0; i < nvec; i += step) {
    uint4 v = __ldg(in4 + i);
    v.x = wp_word<T>(v.x, a);
    v.y = wp_word<T>(v.y, a);
    v.z = wp_word<T>(v.z, a);
    v.w = wp_word<T>(v.w, a);
    out4[i] = v;
  }
  for (long long i = nvec * PER + t0; i < n; i += step)
    out[i] = static_cast<T>(wp_sample(static_cast<int>(in[i]), a));
}

// ----------------------------------------------------------- refine_tables
// HEVC luma interpolation taps per quarter phase (TComInterpolationFilter).
__constant__ int kLumaTaps[4][8] = {{0, 0, 0, 64, 0, 0, 0, 0},
                                    {-1, 4, -10, 58, 17, -5, 1, 0},
                                    {-1, 4, -11, 40, 40, -11, 4, -1},
                                    {0, 1, -5, 17, 58, -10, 4, -1}};

struct RefineArgs {
  const void* orig;
  long long ostride;
  const void* ref;  // padded reference plane [ref_h, ref_w]
  long long rstride;
  int ref_h, ref_w;
  const int* gidx;  // flat (dy, dx) argmin index per block
  int r, ny, nx, pad;
  int hr, s1, off_u, maxv;  // interpolation shifts of the bit depth
  int* off;
  int* half;
};

// lax.dynamic_slice's start on an axis of the phase planes (dim = padded
// extent - 7): negative counts from the end, then clamped to fit SIZE.
template <int SIZE>
__device__ __forceinline__ int slice_start(int s, int dim) {
  return min(max(s < 0 ? s + dim : s, 0), dim - SIZE);
}

constexpr int kRefineThreads = 128;

template <typename T, int SIZE, bool WIDE>
__global__ void __launch_bounds__(kRefineThreads)
    refine_tables_kernel(RefineArgs a) {
  constexpr int TILES_1D = SIZE / 8;
  constexpr int LANES = TILES_1D * TILES_1D * 8;  // one lane a tile row
  constexpr int SB = kRefineThreads / LANES;      // search blocks a CTA
  constexpr int SPAN = SIZE + 7;  // rows (columns) one tile's taps read
  constexpr int WIN = WIDE ? 2 * SPAN : SIZE + 8;
  constexpr int WP = WIN | 1;  // odd pitches: a warp's rows hit 8 banks
  constexpr int HP = SIZE + 1;
  __shared__ int win_s[SB][WIN * WP];
  __shared__ int hbuf_s[SB][SPAN * HP];
  __shared__ int red_s[SB][4];

  const int sb = threadIdx.x / LANES, lt = threadIdx.x % LANES;
  const int tile = lt >> 3, ri = lt & 7;
  const int i = (tile / TILES_1D) * 8 + ri;  // this lane's block row
  const int j0 = (tile % TILES_1D) * 8;      // its first block column
  const int n = a.ny * a.nx;
  const int b_raw = blockIdx.x * SB + sb;
  const int b = min(b_raw, n - 1);  // a tail lane computes a copy, unstored
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
  // local window offsets of shifts -1 and 0 (without WIDE the two ranges
  // overlap: tr1 = tr0 + 1, tc1 = tc0 + 1)
  const int lr1 = WIDE ? SPAN : 1, lc1 = WIDE ? SPAN : 1;

  int* win = win_s[sb];
  int* hb = hbuf_s[sb];
  const T* ref = static_cast<const T*>(a.ref);
  for (int k = lt; k < WIN * WIN; k += LANES) {
    const int wr = k / WIN, wc = k % WIN;
    const int sr = WIDE && wr >= SPAN ? tr1 + wr - SPAN : tr0 + wr;
    const int sc = WIDE && wc >= SPAN ? tc1 + wc - SPAN : tc0 + wc;
    win[wr * WP + wc] = static_cast<int>(ref[sr * a.rstride + sc]);
  }
  const T* orig = static_cast<const T*>(a.orig) + (by + i) * a.ostride + bx +
                  j0;
  int o[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) o[k] = static_cast<int>(orig[k]);
  __syncthreads();

  auto finish = [&](int v) {
    return min(max((v + a.off_u) >> a.hr, 0), a.maxv);
  };
  // dsp::satd of the tile at quarter offset (qy, qx) from the integer MV,
  // summed over the search block; every lane of it gets the sum
  auto cost = [&](int qy, int qx) -> int {
    const int fy = qy & 3, fx = qx & 3;
    const int ly = (qy >> 2) < 0 ? 0 : lr1;
    const int lx = (qx >> 2) < 0 ? 0 : lc1;
    if (fy && fx) {  // the first (horizontal) pass, shifted by 6 - hr
      for (int k = lt; k < SPAN * SIZE; k += LANES) {
        const int rr = k / SIZE, cc = k % SIZE;
        const int* src = win + (ly + rr) * WP + lx + cc;
        int acc = 0;
#pragma unroll
        for (int t = 0; t < 8; ++t) acc += kLumaTaps[fx][t] * src[t];
        hb[rr * HP + cc] = acc >> a.s1;
      }
    }
    __syncthreads();
    int d[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = lx + j0 + k;
      int p;
      if (!fy && !fx) {
        p = win[(ly + i + 3) * WP + c + 3];
      } else if (!fy) {
        int acc = 0;
#pragma unroll
        for (int t = 0; t < 8; ++t)
          acc += kLumaTaps[fx][t] * win[(ly + i + 3) * WP + c + t];
        p = finish(acc >> a.s1);
      } else if (!fx) {
        int acc = 0;
#pragma unroll
        for (int t = 0; t < 8; ++t)
          acc += kLumaTaps[fy][t] * win[(ly + i + t) * WP + c + 3];
        p = finish(acc >> a.s1);
      } else {
        int acc = 0;
#pragma unroll
        for (int t = 0; t < 8; ++t)
          acc += kLumaTaps[fy][t] * hb[(i + t) * HP + j0 + k];
        p = finish(acc >> 6);
      }
      d[k] = o[k] - p;
    }
    // 8-point Hadamard along the row, then down the tile's 8 lanes
#pragma unroll
    for (int h = 1; h < 8; h <<= 1)
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (!(k & h)) {
          const int u = d[k], v = d[k + h];
          d[k] = u + v;
          d[k + h] = u - v;
        }
#pragma unroll
    for (int m = 1; m < 8; m <<= 1)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int t = __shfl_xor_sync(0xffffffffu, d[k], m);
        d[k] = (ri & m) ? t - d[k] : d[k] + t;
      }
    int s = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) s += abs(d[k]);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    int total = (s + 2) >> 2;  // this tile's
    total += __shfl_xor_sync(0xffffffffu, total, 8);
    total += __shfl_xor_sync(0xffffffffu, total, 16);  // the warp's 4 tiles
    if (LANES > 32) {
      if ((lt & 31) == 0) red_s[sb][lt >> 5] = total;
      __syncthreads();
      total = red_s[sb][0] + red_s[sb][1] + red_s[sb][2] + red_s[sb][3];
    }
    __syncthreads();  // hb and red_s are free for the next candidate
    return total;
  };

  // half stage: the 9 candidates (dy outer, dx inner), strict < against
  // the integer centre in that order; the minimum of all 9 is the split
  // screen's
  int hv[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) hv[k] = cost((k / 3 - 1) * 2, (k % 3 - 1) * 2);
  int bc = hv[4], cy = 0, cx = 0, hmin = hv[4];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    hmin = min(hmin, hv[k]);
    if (k != 4 && hv[k] < bc) {
      bc = hv[k];
      cy = (k / 3 - 1) * 2;
      cx = (k % 3 - 1) * 2;
    }
  }
  // quarter stage: the 8 candidates around the half winner
  int qby = cy, qbx = cx;
#pragma unroll 1
  for (int k = 0; k < 9; ++k) {
    if (k == 4) continue;
    const int qy = cy + k / 3 - 1, qx = cx + k % 3 - 1;
    const int c = cost(qy, qx);
    if (c < bc) {
      bc = c;
      qby = qy;
      qbx = qx;
    }
  }
  if (b_raw < n && lt == 0) {
    a.off[b] = (qby + 3) * 7 + (qbx + 3);
    a.half[b] = hmin;
  }
}

template <typename T, int SIZE>
cudaError_t launch_refine(const RefineArgs& a, bool wide, int n,
                          cudaStream_t stream) {
  constexpr int SB = kRefineThreads / ((SIZE / 8) * (SIZE / 8) * 8);
  const int grid = (n + SB - 1) / SB;
  if (wide)
    refine_tables_kernel<T, SIZE, true>
        <<<grid, kRefineThreads, 0, stream>>>(a);
  else
    refine_tables_kernel<T, SIZE, false>
        <<<grid, kRefineThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int hevc_wp_apply(const void* in, void* out, long long n,
                             int elem_bytes, int w, int d, int off, int depth,
                             cudaStream_t stream) {
  if (n <= 0) return 0;
  if ((elem_bytes != 1 && elem_bytes != 2) || d < 0 || d > 30 || depth < 1 ||
      depth > 14)
    return static_cast<int>(cudaErrorInvalidValue);
  const WpArgs a{w, d > 0 ? 1 << (d - 1) : 0, d, off, (1 << depth) - 1};
  const bool vec = reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long per = 16 / elem_bytes;
  const long long work = vec ? n / per + n % per : n;
  const int threads = 256;
  const long long blocks =
      std::min<long long>((work + threads - 1) / threads, 1 << 16);
  if (elem_bytes == 1)
    wp_apply_kernel<uint8_t><<<blocks, threads, 0, stream>>>(
        static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), n, vec,
        a);
  else
    wp_apply_kernel<int16_t><<<blocks, threads, 0, stream>>>(
        static_cast<const int16_t*>(in), static_cast<int16_t*>(out), n, vec,
        a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hevc_refine_tables(const void* orig, long long ostride,
                                  const void* ref, long long rstride,
                                  int ref_h, int ref_w, int elem_bytes,
                                  const int* gidx, int size, int r, int ny,
                                  int nx, int pad, int depth, int* off,
                                  int* half, cudaStream_t stream) {
  const int n = ny * nx;
  if (n <= 0 || (elem_bytes != 1 && elem_bytes != 2) ||
      (size != 16 && size != 32) || depth < 1 || depth > 14 ||
      ref_h < size + 8 || ref_w < size + 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hr = depth > 12 ? 2 : 14 - depth;
  const RefineArgs a{orig, ostride, ref, rstride, ref_h, ref_w, gidx,
                     r, ny, nx, pad, hr, 6 - hr, 1 << (hr - 1),
                     (1 << depth) - 1, off, half};
  // every tile start inside the phase planes, for every MV within +-r:
  // the window of shifts -1 and 0 is one (size + 8)^2 block
  const bool wide = pad - r - 4 < 0 ||
                    pad + (ny - 1) * size + r - 3 > ref_h - 7 - size ||
                    pad + (nx - 1) * size + r - 3 > ref_w - 7 - size;
  cudaError_t e;
  if (elem_bytes == 1)
    e = size == 32 ? launch_refine<uint8_t, 32>(a, wide, n, stream)
                   : launch_refine<uint8_t, 16>(a, wide, n, stream);
  else
    e = size == 32 ? launch_refine<int16_t, 32>(a, wide, n, stream)
                   : launch_refine<int16_t, 16>(a, wide, n, stream);
  return static_cast<int>(e);
}
