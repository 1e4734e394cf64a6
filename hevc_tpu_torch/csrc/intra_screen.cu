// The whole-frame 35-mode intra prescreen of one block size.
//
// intra_screen replaces hevc_tpu/ops/intra_screen.py `_screen_chunk` (with
// ops/intra.py `predict_all_modes` and ops/satd.py `satd_batch`), which the
// reference ran as XLA programs over int64 gather tables. For every aligned
// N x N luma block (N = 4, 8, 16, 32; ny = h / N rows, nx = w / N columns)
// of the padded int16 plane P [h + 1, w + 1] (P[y + 1][x + 1] = orig[y][x],
// row 0 and column 0 hold 1 << (bit_depth - 1)) it
//   - gathers the 4N + 1 reference samples f (f[2N] = P[y0][x0], top
//     f[2N + 1 + x] = P[y0][min(x0 + 1 + x, w)], left
//     f[2N - 1 - y] = P[min(y0 + 1 + y, h)][x0]) and their [1 2 1] smoothing
//     ff with copied ends (no strong smoothing);
//   - predicts all 35 modes (planar, DC with its edge filter for N < 32,
//     angular with the 10/26 boundary terms for N < 32, clipped; angular
//     values are not clipped) from f or ff as spec 8.4.4.2.3 selects;
//   - takes the Hadamard SATD against the source block: (sum|T| + 2) >> 2
//     per 8 x 8 tile, (sum|T| + 1) >> 1 per 4 x 4 tile, summed over tiles;
//   - adds lam_tab[mode] and writes the per-block minimum (int32) and the k
//     cheapest modes (uint8), ordered by (cost, mode) ascending.
// Every address is computed from the block position: no gather table is
// read (the reference's 4x4 table alone is about 34 MB at 1080p).
//
// What bounds it: operations. At 1080p each size predicts and transforms
// up to 35 x 1920 x 1080 samples (its grid's blocks), 13-15 integer
// operations each: about 4.2 G operations for the four sizes, against a
// 4 MB plane.
//
// Design: one thread block takes kBlocks blocks of one size (256 threads). It
// stages both reference vectors and the source blocks in shared memory;
// each thread then owns one (mode, block, Hadamard tile) at a time,
// predicts the tile into registers, runs the butterflies there and adds its
// rounded tile SATD to the block's cost with a shared-memory atomic (exact,
// so the order does not matter). Horizontal modes are computed transposed:
// H D^T H = (H D H)^T has the same absolute sum, so a horizontal mode runs
// the vertical formula on the left reference against the transposed source.
// Work items are ordered mode-major, so the lanes of a warp share a code
// path. Last, a thread per (block, mode) ranks its mode among the 35 by
// (cost, mode) and writes it if its rank is below k.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kModes = 35;

// intraPredAngle of modes 2..34 and invAngle = round(8192 / angle) of the
// negative angles (spec 8.4.4.2.6)
__constant__ int c_angle[33] = {32,  26,  21,  17,  13,  9,   5,  2,   0,
                                -2,  -5,  -9,  -13, -17, -21, -26, -32, -26,
                                -21, -17, -13, -9,  -5,  -2,  0,   2,   5,
                                9,   13,  17,  21,  26,  32};
__constant__ int c_inv_angle[33] = {
    0,    0,    0,    0,    0,    0,    0,     0,     0,    -4096, -1638,
    -910, -630, -482, -390, -315, -256, -315,  -390,  -482, -630,  -910,
    -1638, -4096, 0,   0,    0,    0,    0,     0,     0,    0,     0};

template <int N>
struct Size {
  static constexpr int kLog2 = N == 4 ? 2 : N == 8 ? 3 : N == 16 ? 4 : 5;
  static constexpr int kTile = N >= 8 ? 8 : 4;
  static constexpr int kTilesX = N / kTile;
  static constexpr int kTiles = kTilesX * kTilesX;
  // luma blocks per thread block: 35 * kBlocks * kTiles work items
  static constexpr int kBlocks = N == 4 ? 64 : N == 8 ? 32 : N == 16 ? 8 : 2;
  static constexpr int kRef = 4 * N + 1;
  // smoothing threshold of spec 8.4.4.2.3 (none at 4x4)
  static constexpr int kThresh = N == 8 ? 7 : N == 16 ? 1 : 0;
};

// Index into the reference vector of main-reference position j (j in
// [-N, 2N]) for an angular mode; s = 1 for vertical modes (main reference
// the top row), -1 for horizontal ones (the left column).
template <int N>
__device__ __forceinline__ int ref_index(int j, int s, int inv) {
  if (j >= 0) return 2 * N + s * j;
  const int step = (j * inv + 128) >> 8;
  return min(max(2 * N - s * step, 0), 4 * N);
}

// SATD of one T x T tile of the difference pred - src for one mode.
template <int N>
__device__ int tile_satd(int mode, int ty, int tx, const int* f,
                         const int* ff, const int16_t* src, int dc,
                         int maxval) {
  using S = Size<N>;
  constexpr int T = S::kTile;
  constexpr int N2 = 2 * N;
  const int y0 = ty * T, x0 = tx * T;
  int d[T][T];
  if (mode == 0) {
    // planar, from ff from 8x8 up (its distance 10 exceeds every threshold)
    const int* p = N >= 8 ? ff : f;
    const int tr = p[N2 + 1 + N], bl = p[N2 - 1 - N];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const int y = y0 + i;
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const int x = x0 + j;
        const int pred = ((N - 1 - x) * p[N2 - 1 - y] + (x + 1) * tr +
                          (N - 1 - y) * p[N2 + 1 + x] + (y + 1) * bl + N) >>
                         (S::kLog2 + 1);
        d[i][j] = pred - src[y * N + x];
      }
    }
  } else if (mode == 1) {
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const int y = y0 + i;
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const int x = x0 + j;
        int pred = dc;
        if (N < 32) {
          if (y == 0 && x == 0)
            pred = (f[N2 - 1] + 2 * dc + f[N2 + 1] + 2) >> 2;
          else if (y == 0)
            pred = (f[N2 + 1 + x] + 3 * dc + 2) >> 2;
          else if (x == 0)
            pred = (f[N2 - 1 - y] + 3 * dc + 2) >> 2;
        }
        d[i][j] = pred - src[y * N + x];
      }
    }
  } else {
    // angular, in main-axis coordinates (yy along the prediction
    // direction's driver, xx along the main reference); horizontal modes
    // read the source transposed
    const bool vert = mode >= 18;
    const int s = vert ? 1 : -1;
    const int angle = c_angle[mode - 2], inv = c_inv_angle[mode - 2];
    const int dist = min(abs(mode - 26), abs(mode - 10));
    const int* ref = (N > 4 && dist > S::kThresh) ? ff : f;
    const bool edge = N < 32 && (mode == 10 || mode == 26);
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const int yy = y0 + i;
      const int pos = (yy + 1) * angle;
      const int iidx = pos >> 5, fact = pos & 31;
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const int xx = x0 + j;
        const int j1 = xx + iidx + 1;
        const int j2 = min(j1 + 1, N2);
        const int r1 = ref[ref_index<N>(j1, s, inv)];
        const int r2 = ref[ref_index<N>(j2, s, inv)];
        int pred = ((32 - fact) * r1 + fact * r2 + 16) >> 5;
        if (edge && xx == 0)
          pred = min(max(f[N2 + s] + ((f[N2 - s * (yy + 1)] - f[N2]) >> 1), 0),
                     maxval);
        d[i][j] = pred - src[vert ? yy * N + xx : xx * N + yy];
      }
    }
  }
  // 2-D Walsh-Hadamard butterflies: rows, then columns
#pragma unroll
  for (int h = 1; h < T; h <<= 1) {
#pragma unroll
    for (int i = 0; i < T; ++i) {
#pragma unroll
      for (int j = 0; j < T; ++j) {
        if ((j & h) == 0) {
          const int a = d[i][j], b = d[i][j + h];
          d[i][j] = a + b;
          d[i][j + h] = a - b;
        }
      }
    }
  }
#pragma unroll
  for (int h = 1; h < T; h <<= 1) {
#pragma unroll
    for (int i = 0; i < T; ++i) {
      if ((i & h) == 0) {
#pragma unroll
        for (int j = 0; j < T; ++j) {
          const int a = d[i][j], b = d[i + h][j];
          d[i][j] = a + b;
          d[i + h][j] = a - b;
        }
      }
    }
  }
  int sum = 0;
#pragma unroll
  for (int i = 0; i < T; ++i) {
#pragma unroll
    for (int j = 0; j < T; ++j) sum += abs(d[i][j]);
  }
  return T == 8 ? (sum + 2) >> 2 : (sum + 1) >> 1;
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    intra_screen_kernel(const int16_t* __restrict__ plane, long long stride,
                        int h, int w, const int* __restrict__ lam_tab,
                        int maxval, int ny, int nx, int k,
                        uint8_t* __restrict__ cands, int* __restrict__ costs) {
  using S = Size<N>;
  constexpr int B = S::kBlocks, R = S::kRef, N2 = 2 * N;
  __shared__ int f_s[B][2][R];  // [block][unfiltered, filtered][4N + 1]
  __shared__ int16_t src_s[B][N * N];
  __shared__ int cost_s[B][kModes];
  __shared__ int dc_s[B];
  const int tid = threadIdx.x;
  const int nblk = ny * nx;
  const int g0 = blockIdx.x * B;

  for (int i = tid; i < B * R; i += kThreads) {
    const int b = i / R, e = i - b * R, g = g0 + b;
    int v = 0;
    if (g < nblk) {
      const int by = g / nx;
      const int y0 = by * N, x0 = (g - by * nx) * N;
      int r = y0, c = x0;
      if (e > N2)
        c = min(x0 + e - N2, w);
      else if (e < N2)
        r = min(y0 + N2 - e, h);
      v = plane[r * stride + c];
    }
    f_s[b][0][e] = v;
  }
  for (int i = tid; i < B * N * N; i += kThreads) {
    const int b = i / (N * N), e = i - b * (N * N), g = g0 + b;
    int16_t v = 0;
    if (g < nblk) {
      const int by = g / nx;
      const int y0 = by * N, x0 = (g - by * nx) * N;
      const int y = e / N, x = e - y * N;
      v = plane[(y0 + 1 + y) * stride + x0 + 1 + x];
    }
    src_s[b][e] = v;
  }
  for (int i = tid; i < B * kModes; i += kThreads) {
    const int b = i / kModes, m = i - b * kModes;
    cost_s[b][m] = lam_tab[m];
  }
  __syncthreads();
  for (int i = tid; i < B * R; i += kThreads) {
    const int b = i / R, e = i - b * R;
    const int* f = f_s[b][0];
    f_s[b][1][e] = (e == 0 || e == R - 1)
                       ? f[e]
                       : (f[e - 1] + 2 * f[e] + f[e + 1] + 2) >> 2;
  }
  for (int b = tid; b < B; b += kThreads) {
    const int* f = f_s[b][0];
    int sum = 0;
    for (int x = 0; x < N; ++x) sum += f[N2 + 1 + x] + f[N2 - 1 - x];
    dc_s[b] = (sum + N) >> (S::kLog2 + 1);
  }
  __syncthreads();

  constexpr int kPerMode = B * S::kTiles;
  for (int it = tid; it < kModes * kPerMode; it += kThreads) {
    const int mode = it / kPerMode, rem = it - mode * kPerMode;
    const int b = rem / S::kTiles, tile = rem - b * S::kTiles;
    if (g0 + b >= nblk) continue;
    const int ty = tile / S::kTilesX, tx = tile - ty * S::kTilesX;
    const int satd = tile_satd<N>(mode, ty, tx, f_s[b][0], f_s[b][1],
                                  src_s[b], dc_s[b], maxval);
    atomicAdd(&cost_s[b][mode], satd);
  }
  __syncthreads();

  for (int i = tid; i < B * kModes; i += kThreads) {
    const int b = i / kModes, m = i - b * kModes, g = g0 + b;
    if (g >= nblk) continue;
    const int c = cost_s[b][m];
    int rank = 0;
    for (int m2 = 0; m2 < kModes; ++m2) {
      const int c2 = cost_s[b][m2];
      rank += (c2 < c) || (c2 == c && m2 < m);
    }
    if (rank == 0) costs[g] = c;
    if (rank < k) cands[static_cast<long long>(g) * k + rank] =
        static_cast<uint8_t>(m);
  }
}

template <int N>
int launch_intra_screen(const void* plane, long long stride, int h, int w,
                        const void* lam_tab, int maxval, int ny, int nx,
                        int k, void* cands, void* costs, cudaStream_t s) {
  const int nblk = ny * nx;
  if (nblk > 0)
    intra_screen_kernel<N>
        <<<(nblk + Size<N>::kBlocks - 1) / Size<N>::kBlocks, kThreads, 0,
           s>>>(static_cast<const int16_t*>(plane), stride, h, w,
                static_cast<const int*>(lam_tab), maxval, ny, nx, k,
                static_cast<uint8_t*>(cands), static_cast<int*>(costs));
  return cudaGetLastError();
}

}  // namespace

// plane: int16 [h + 1, w + 1] (row stride `stride` elements); lam_tab: int32
// [35]; cands: uint8 [ny * nx, k]; costs: int32 [ny * nx]; all on the card.
extern "C" int hevc_intra_screen(const void* plane, long long stride, int h,
                                 int w, const void* lam_tab, int bit_depth,
                                 int size, int ny, int nx, int k, void* cands,
                                 void* costs, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bit_depth < 8 || bit_depth > 14 || k < 0 || k > kModes ||
      ny * size > h || nx * size > w)
    return cudaErrorInvalidValue;
  const int maxval = (1 << bit_depth) - 1;
  switch (size) {
    case 4:
      return launch_intra_screen<4>(plane, stride, h, w, lam_tab, maxval, ny,
                                    nx, k, cands, costs, s);
    case 8:
      return launch_intra_screen<8>(plane, stride, h, w, lam_tab, maxval, ny,
                                    nx, k, cands, costs, s);
    case 16:
      return launch_intra_screen<16>(plane, stride, h, w, lam_tab, maxval, ny,
                                     nx, k, cands, costs, s);
    case 32:
      return launch_intra_screen<32>(plane, stride, h, w, lam_tab, maxval, ny,
                                     nx, k, cands, costs, s);
    default:
      return cudaErrorInvalidValue;
  }
}
