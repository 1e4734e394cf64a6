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
// 4 MB plane. Integer adds, shifts and logic issue at half the float32 FMA
// rate the bound is stated against, so about half that bound is the most
// this kernel can reach.
//
// Design: one thread block (256 threads, 8 warps) takes kBlocks blocks of
// one size, chosen so that its tiles hold exactly one row per thread: a
// T x T Hadamard tile (T = 8, or 4 for 4x4 blocks) is owned by T
// consecutive lanes, lane i its row i. Each thread keeps its (block, tile,
// row) for the whole kernel and walks the 35 modes, so all lanes of a warp
// share a mode and its code path. Per mode a lane
//   - predicts its row's T samples into registers. Angular modes run in
//     main-axis coordinates (a horizontal mode is the vertical formula on
//     the left reference against the transposed source: H D^T H =
//     (H D H)^T has the same absolute sum), where the row fixes iidx and
//     fact, so the row blends T + 1 neighbouring reference entries: fixed
//     offsets from one address for angles >= 0, through the projection
//     for the 15 negative ones;
//   - subtracts its source row, read once before the mode loop from shared
//     memory with one vector load (16 bytes for T = 8, 8 for T = 4) from
//     the staged block and one from its staged transposed copy, and kept
//     unpacked in registers;
//   - runs the column butterflies across its tile's T lanes with
//     __shfl_xor_sync (offsets 1, 2, 4), then the row butterflies in
//     registers, the last stage fused with the absolute sum
//     (|a + b| + |a - b| = 2 max(|a|, |b|)), and reduces the tile sum over
//     the T lanes by shuffles.
// A block of 8x8 or less is one tile, so its cost is written by one lane;
// a 16x16 block is the warp's four tiles, reduced by two more shuffles; a
// 32x32 block spans four warps (each a 2 x 2 square of tiles), which add
// their sums with one shared atomic each. Last, a thread per (block, mode)
// ranks its mode among the 35 by (cost, mode) and writes it if its rank is
// below k, straight into the packed outputs.
//
// What holds it back: instruction issue, about 25-30 instructions a
// predicted sample (the blend, the negative angles' index projection, a
// shuffle and a multiply-add per sample and column stage). Neither
// occupancy (32 registers a thread, 8 thread blocks an SM, ran no faster)
// nor the integer pipe (the transform in float32 ran no faster) is the
// limit; 4x4 pays each mode's set-up over 4 samples a lane, not 8.
//
// Shared-memory bank conflicts (wavefronts per warp request):
//   - source and transposed source: the per-sample reads are register
//     reads. The one vector load per thread is conflict-free: the padded
//     row stride (N + 8 int16 from 16x16 up) is an odd number of 16-byte
//     segments, so the 8 lanes of a quarter-warp phase hit 8 distinct
//     segments (for 4x4, a half-warp's 16 rows are 128 contiguous bytes).
//     Staging writes the transposed copy once per sample: conflict-free
//     for 4x4 and 8x8, 2-way at 16x16 and 4-way at 32x32.
//   - f / ff: blocks sit kRefPad * 2 ints apart (36, 72 for 4x4, 8x8, so a
//     warp's 8 or 4 blocks start in distinct banks), and a 32x32 warp's
//     tiles form a 2 x 2 square. Over the angular modes' load steps a
//     request is nearly always conflict-free and at most 2-way; the planar
//     and DC reads are broadcasts or conflict-free.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kModes = 35;
constexpr unsigned kFull = 0xffffffffu;

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
  // luma blocks per thread block: one tile row per thread
  static constexpr int kBlocks = kThreads * kTile / (N * N);
  static constexpr int kRef = 4 * N + 1;
  // f / ff row stride in ints (block stride twice that)
  static constexpr int kRefPad = N == 4 ? 18 : N == 8 ? 36 : kRef;
  // source row stride in int16: an odd number of 16-byte segments
  static constexpr int kSrcPad = N >= 16 ? N + 8 : N;
  // smoothing threshold of spec 8.4.4.2.3 (none at 4x4)
  static constexpr int kThresh = N == 8 ? 7 : N == 16 ? 1 : 0;
};

// Index into the reference vector of main-reference position j (j in
// [-N, N]) for a negative angle; S = 1 for vertical modes (main reference
// the top row), -1 for horizontal ones (the left column). j < 0 projects
// onto the side reference at step = (j * inv + 128) >> 8 >= 0, clamped to
// the vector as the reference's gather map is.
template <int N, int S>
__device__ __forceinline__ int neg_index(int j, int inv) {
  if (j >= 0) return 2 * N + S * j;
  const int step = (j * inv + 128) >> 8;
  return S > 0 ? max(2 * N - step, 0) : min(2 * N + step, 4 * N);
}

// T int16 of shared memory (16- or 8-byte aligned) into T ints.
template <int T>
__device__ __forceinline__ void load_row(const int16_t* p, int (&v)[T]) {
  uint32_t w[T / 2];
  if constexpr (T == 8) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
  } else {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    w[0] = q.x; w[1] = q.y;
  }
#pragma unroll
  for (int k = 0; k < T / 2; ++k) {
    v[2 * k] = static_cast<int16_t>(w[k] & 0xffffu);
    v[2 * k + 1] = static_cast<int16_t>(w[k] >> 16);
  }
}

// The difference pred - src of one lane's row for angular mode 2..34, in
// main-axis coordinates (VERT: modes 18..34, main reference the top row;
// else the left column against the transposed source `src`). The row fixes
// iidx and fact, so it blends T + 1 consecutive main-reference entries:
// pred = r[t] + ((fact * (r[t + 1] - r[t]) + 16) >> 5), which equals
// ((32 - fact) * r[t] + fact * r[t + 1] + 16) >> 5. Positions j >= 0 are
// fixed offsets from one address for angles >= 0; negative angles take
// every index through neg_index (projecting j < 0).
template <int N, bool VERT>
__device__ __forceinline__ void angular_row(int mode, int yy, int x0,
                                            const int* f, const int* ff,
                                            int maxval,
                                            const int (&src)[Size<N>::kTile],
                                            int (&d)[Size<N>::kTile]) {
  using S = Size<N>;
  constexpr int T = S::kTile;
  constexpr int N2 = 2 * N;
  constexpr int s = VERT ? 1 : -1;
  const int angle = c_angle[mode - 2];
  const int dist = min(abs(mode - 26), abs(mode - 10));
  const int* ref = (N > 4 && dist > S::kThresh) ? ff : f;
  const int pos = (yy + 1) * angle;
  const int fact = pos & 31;
  const int jb = x0 + (pos >> 5) + 1;
  // sample t blends j1 = jb + t and j2 = min(j1 + 1, 2N). j1 never exceeds
  // 2N (x <= N - 1, iidx <= N), so only the last entry is clamped; with a
  // negative angle iidx < 0 and no entry exceeds N.
  int r[T + 1];
  if (angle >= 0) {
    const int* main = ref + N2 + s * jb;
#pragma unroll
    for (int t = 0; t < T; ++t) r[t] = main[s * t];
    r[T] = ref[N2 + s * min(jb + T, N2)];
  } else {
    const int inv = c_inv_angle[mode - 2];
#pragma unroll
    for (int t = 0; t <= T; ++t) r[t] = ref[neg_index<N, s>(jb + t, inv)];
  }
#pragma unroll
  for (int t = 0; t < T; ++t)
    d[t] = r[t] - src[t] + ((fact * (r[t + 1] - r[t]) + 16) >> 5);
  if (N < 32 && (mode == 10 || mode == 26) && x0 == 0)
    d[0] = min(max(f[N2 + s] + ((f[N2 - s * (yy + 1)] - f[N2]) >> 1), 0),
               maxval) -
           src[0];
}

// The difference pred - src of one lane's row of one tile for one mode.
// yy: the row (main-axis row for angular modes), x0: the tile's first
// column; srow / scol: the lane's source row and transposed source row.
template <int N>
__device__ __forceinline__ void predict_row(int mode, int yy, int x0,
                                            const int* f, const int* ff,
                                            int dc, int maxval,
                                            const int (&srow)[Size<N>::kTile],
                                            const int (&scol)[Size<N>::kTile],
                                            int (&d)[Size<N>::kTile]) {
  using S = Size<N>;
  constexpr int T = S::kTile;
  constexpr int N2 = 2 * N;
  if (mode == 0) {
    // planar, from ff from 8x8 up (its distance 10 exceeds every threshold)
    const int* p = N >= 8 ? ff : f;
    const int tr = p[N2 + 1 + N], bl = p[N2 - 1 - N], left = p[N2 - 1 - yy];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int x = x0 + t;
      const int pred = ((N - 1 - x) * left + (x + 1) * tr +
                        (N - 1 - yy) * p[N2 + 1 + x] + (yy + 1) * bl + N) >>
                       (S::kLog2 + 1);
      d[t] = pred - srow[t];
    }
  } else if (mode == 1) {
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int x = x0 + t;
      int pred = dc;
      if (N < 32) {
        if (yy == 0 && x == 0)
          pred = (f[N2 - 1] + 2 * dc + f[N2 + 1] + 2) >> 2;
        else if (yy == 0)
          pred = (f[N2 + 1 + x] + 3 * dc + 2) >> 2;
        else if (x == 0)
          pred = (f[N2 - 1 - yy] + 3 * dc + 2) >> 2;
      }
      d[t] = pred - srow[t];
    }
  } else if (mode >= 18) {
    angular_row<N, true>(mode, yy, x0, f, ff, maxval, srow, d);
  } else {
    angular_row<N, false>(mode, yy, x0, f, ff, maxval, scol, d);
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads, 4)
    intra_screen_kernel(const int16_t* __restrict__ plane, long long stride,
                        int h, int w, const int* __restrict__ lam_tab,
                        int maxval, int ny, int nx, int k,
                        uint8_t* __restrict__ cands, int* __restrict__ costs) {
  using S = Size<N>;
  constexpr int T = S::kTile, B = S::kBlocks, R = S::kRef;
  constexpr int RP = S::kRefPad, SP = S::kSrcPad, N2 = 2 * N;
  static_assert(B * S::kTiles * T == kThreads, "one tile row per thread");
  __shared__ int f_s[B][2][RP];  // [block][unfiltered, filtered][4N + 1]
  // [source, transposed source][block][row][column]
  __shared__ __align__(16) int16_t src_s[2][B][N][SP];
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
    const int y = e / N, x = e - y * N;
    int16_t v = 0;
    if (g < nblk) {
      const int by = g / nx;
      const int y0 = by * N, x0 = (g - by * nx) * N;
      v = plane[(y0 + 1 + y) * stride + x0 + 1 + x];
    }
    src_s[0][b][y][x] = v;
    src_s[1][b][x][y] = v;
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

  // this thread's block, tile and row, fixed for all 35 modes. Tiles of a
  // warp lie in 2 x 2 squares where a block has more than one tile.
  const int lane = tid & 31;
  const int tw = (tid >> 5) * (32 / T) + lane / T;
  const int b = tw / S::kTiles, q = tw - b * S::kTiles;
  int ty = 0, tx = 0;
  if (S::kTilesX > 1) {
    constexpr int QX = S::kTilesX / 2;
    const int quad = q >> 2;
    ty = (quad / QX) * 2 + ((q >> 1) & 1);
    tx = (quad % QX) * 2 + (q & 1);
  }
  const int i = lane & (T - 1);
  const int yy = ty * T + i, x0 = tx * T;
  int srow[T], scol[T];
  load_row<T>(&src_s[0][b][yy][x0], srow);
  load_row<T>(&src_s[1][b][yy][x0], scol);
  // keep them unpacked in registers across the mode loop (else the
  // compiler sign-extends the packed words again for every mode)
#pragma unroll
  for (int t = 0; t < T; ++t) asm volatile("" : "+r"(srow[t]), "+r"(scol[t]));
  const int* f = f_s[b][0];
  const int* ff = f_s[b][1];
  const int dc = dc_s[b];

  for (int mode = 0; mode < kModes; ++mode) {
    int d[T];
    predict_row<N>(mode, yy, x0, f, ff, dc, maxval, srow, scol, d);
    // 2-D Walsh-Hadamard transform. Its butterfly stages commute, so the
    // columns go first, across the tile's T lanes, then the row in
    // registers, whose last stage is fused with the absolute sum:
    // |a + b| + |a - b| = 2 max(|a|, |b|).
#pragma unroll
    for (int hh = 1; hh < T; hh <<= 1) {
      // (a, b) -> (a + b, a - b): the lane holding b takes a - b
      const int sg = (i & hh) ? -1 : 1;
#pragma unroll
      for (int j = 0; j < T; ++j)
        d[j] = __shfl_xor_sync(kFull, d[j], hh) + sg * d[j];
    }
#pragma unroll
    for (int hh = 1; hh < T / 2; hh <<= 1) {
#pragma unroll
      for (int j = 0; j < T; ++j) {
        if ((j & hh) == 0) {
          const int a = d[j], c = d[j + hh];
          d[j] = a + c;
          d[j + hh] = a - c;
        }
      }
    }
    int half = 0;  // half the tile's sum of |coefficients|
#pragma unroll
    for (int j = 0; j < T / 2; ++j) half += max(abs(d[j]), abs(d[j + T / 2]));
#pragma unroll
    for (int hh = 1; hh < T; hh <<= 1)
      half += __shfl_xor_sync(kFull, half, hh);
    // (sum + 2) >> 2 for 8x8 tiles, (sum + 1) >> 1 for 4x4
    int satd = T == 8 ? (half + 1) >> 1 : half;
    if (N >= 16) {
      satd += __shfl_xor_sync(kFull, satd, 8);
      satd += __shfl_xor_sync(kFull, satd, 16);
      if (lane == 0) {
        if (N == 32)
          atomicAdd(&cost_s[b][mode], satd);
        else
          cost_s[b][mode] += satd;
      }
    } else if (i == 0) {
      cost_s[b][mode] += satd;
    }
  }
  __syncthreads();

  for (int it = tid; it < B * kModes; it += kThreads) {
    const int bb = it / kModes, m = it - bb * kModes, g = g0 + bb;
    if (g >= nblk) continue;
    const int c = cost_s[bb][m];
    int rank = 0;
    for (int m2 = 0; m2 < kModes; ++m2) {
      const int c2 = cost_s[bb][m2];
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
