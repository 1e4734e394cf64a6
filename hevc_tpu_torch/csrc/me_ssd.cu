// Integer motion search of the main path: window energies, SSD tables and
// the two-pass argmin.
//
// ssd_table replaces hevc_tpu/ops/me_mxu.py `_ssd_table` (with
// `_corr_grouped`): for the aligned size x size block grid of a frame,
//   ssd[n, dy, dx] = win[n, dy, dx] + sum(b^2) - 2 * corr[n, dy, dx],
// where b is the block centred on 128 (int8), corr is its correlation with
// its own centred (2r + size)^2 window of the reference, and win is the
// window energy sum(a^2), read from the box-sum plane that box_energies
// writes (replacing the XLA integral image of `_window_energies`). All
// exact in int32.
//
// The correlation runs on the int8 tensor cores (mma.sync m16n8k32, s8 x s8
// into s32), as the reference ran it as an int8 convolution on the MXU. Per
// block row i it is a matrix product:
//   corr[dy, dx] += sum_x W[dy + i, x] * T_i[x, dx],
//   T_i[x, dx] = b[i, x - dx] for 0 <= x - dx < size, else 0,
// W the centred window (int8, shared memory), T_i a banded Toeplitz matrix.
// For a tile of TN offsets dx0 .. dx0 + TN - 1 only the window columns
// dx0 .. dx0 + TN + size - 2 meet a non-zero T_i, so the product depth is
// TN + size - 1 rounded up to 32 (64 for size 32 at TN 32). T_i restricted
// to the tile depends only on x - dx, so one set of B fragments per row i
// serves every tile: each fragment register is four consecutive bytes of
// the zero-extended block row, and the kernel keeps, per row i, the word
// starting at every byte offset (92 words for size 32) in shared memory.
// A fragments come from the window with ldmatrix. |corr| <= 1024 * 128^2 <
// 2^31: exact. Padding of M (offsets dy, to 16) and N (dx, to TN) is
// computed and masked in the epilogue, which adds win and sum(b^2).
//
// What bounds it: operations. At 1080p the 32-grid at r = 64 is 1980 blocks
// of 144 x 160 padded offsets x 64-deep products over 32 rows: 93.4 G int8
// multiply-adds per reference, against a 131.8 MB int32 table. One thread
// block per search block; its window arrives by cp.async. A warp owns three
// m16 tiles by one N tile and keeps the B fragments of row i in registers
// across the three, so each m16n8k32 product costs about 1.7 shared-memory
// wavefronts (ldmatrix for A, one word load per B register). The window
// row stride is an odd multiple of 16 bytes, so ldmatrix rows do not
// conflict. Three thread blocks share an SM (80 registers a thread).
//
// ssd_table_deep replaces `_ssd_table_deep` (me_mxu.py:142, with
// `_split128` and three `_corr_grouped` calls): the same table for 9-14-bit
// samples (int16). Each sample is shifted to at most 10 effective bits and
// centred, a' = (a >> shift) - mid in [-512, 511], and split as
// a' = 128 hi + lo, lo = ((a' + 64) & 127) - 64 in [-64, 63], hi in [-4, 4],
// so that the correlation is three int8 ones: c_hh, c_ll and c_ss of
// s = hi + lo, combined as corr = (c_hh << 14) + ((c_ss - c_hh - c_ll) << 7)
// + c_ll = 16256 c_hh + 128 c_ss - 127 c_ll, formed in unsigned (wrapping)
// 32-bit arithmetic: the same bits as XLA's int32. What bounds it:
// operations (at 1080p 202 G int8 operations a reference on the 32-grid at
// r = 64, 13.4 G on the 16-grid at r = 16, unpadded). The design:
// - Offsets in m16 tiles of dy by n8 tiles of dx. An n8 tile's band of taps
//   (8 + size - 1 window columns) lies in H = 3 (32x32) or 2 (16x16, 8x8)
//   16-byte k segments from the 16-byte column at or below its first
//   offset, and a k-step of m16n8k32 takes its two halves from any two of
//   them, across block rows (ldmatrix takes a row address from each lane):
//   1.59x the unpadded multiply-adds at 32x32, r = 64, and 2.82x at 16x16,
//   r = 16 (whole 32-byte k-steps of one block row would issue 2.77x and
//   4.2x).
// - The B fragments come from a table of B words per part and block row,
//   the word at every byte offset of the zero-extended row: for a k half
//   (segment k, n8 tile of parity par) lane (g, t) reads word
//   16 k - 8 par + 4 t - g + 15; a row's six words serve every n8 tile.
// - Only the hi and lo windows are staged, biased to unsigned bytes
//   hi' = hi + 4 in [0, 8] and lo' = lo + 64 in [0, 127], so that
//   s' = hi' + lo' <= 135 is one 32-bit add a register (no carry between
//   bytes of real samples) and the three products, u8 x s8, share every
//   A load. The bias adds 576 sum(b) to the fold: a constant of the block,
//   taken out in the epilogue beside sum(b^2). Window bytes past aw are
//   never written: they meet zero taps or feed offsets past nyx.
// - At r = 64 and 16 the last m16 tile holds one row of offsets; it is
//   packed: its 16 rows take (that row, 16-column group) pairs, two n8
//   tiles wide (each lane's ldmatrix row address is its own).
// - A warp's work item is an m16 tile by NV n8 tiles (4 at 32x32, 6 below)
//   with the three accumulator sets; each block row's A segments
//   (ldmatrix.x4) and B words are loaded just before the k-steps that use
//   them. The item body is a template on its count of live n8 tiles, so a
//   short item (the last group, the packed tile) loads only what it uses
//   and no tile loop tests a runtime count.
// - Staging: the block's taps are loaded first, the int16 window with
//   16-byte loads (4 in flight a thread) split in registers, the B words
//   made by a shuffle and funnel shifts; one barrier. Two thread blocks of
//   eight warps share an SM at 32x32 (121 registers, 82.7 KB of shared
//   memory at r = 64), so one block's staging runs under the other's
//   products; five blocks of three warps at 16x16 (125 registers, 18.1 KB
//   at r = 16). No spills (the -Xptxas -v log of the build).

// argmin_two_pass replaces `_argmin_two_pass` (LOCAL_W = 8):
//   pass 1: argmin of the 3x3-neighbourhood sum of
//           cost1 = ssd + ((lam * bits0) >> 8) (zero outside the grid);
//   pass 2: cost2 = ssd + ((lam * bits2) >> 8), bits2 rated against the
//           pass-1 MV; the local argmin within +-8 of it (1 << 30 outside)
//           and the global argmin; the global one wins only if
//           c_g + (c_loc >> 3) < c_loc.
// Every argmin takes the first minimum in row-major order; sums wrap in
// int32 as XLA's do. What bounds it: bytes. One thread block owns a 2 x 4
// tile of grid blocks, a warp per block, two thread blocks an SM. In pass
// 1 each warp takes every 8th run of 32 offsets and loads, per offset, the
// 4 x 6 neighbourhood of tables (the tile and a one-block halo; loads
// coalesced across the warp, none outside the grid), forms the 8 3x3 sums
// separably and keeps a first minimum per block; no barrier until the end
// of the pass. In pass 2 each warp reads its block's own table once in
// 16-byte loads, 8 in flight per lane, from the end backwards (the end
// was read last in pass 1 and may still be in L2), for the global minimum;
// the local minimum reads only the 17 x 17 window. Each table is read
// 24/8 + 1 = 4 times, the halo reads mostly from L2, instead of ten times.
// (A 4 x 4 tile reads less, 36/16 + 1, but at 1080p its 135 thread blocks
// of 16 warps, one an SM, run the 32x32 grid in two waves.)

// box_energies replaces the integral image of `_window_energies`
// (me_mxu.py:124): the box-sum plane of the centred squares. What bounds
// it: bytes (it reads the uint8 plane and writes the int32 plane once; at
// 1080p the 32-grid's 2.4 MB in and 8.7 MB out take 3.4 us at 3.35 TB/s),
// and, for a simple design, the latency of its dependent row steps. Each
// warp is independent (no shared memory, no barrier): it owns a strip of
// 128 input columns, 4 adjacent ones a lane read as one word a row (two
// aligned word loads and a funnel shift, as the plane may start at any
// byte), over a band of 16 output rows. It keeps running column sums of
// the squares in registers (add the entering row, subtract the leaving
// one; the loads of the size - 1 first rows, then of eight rows at a time,
// in flight at once, none behind a branch), forms each row's box sums from
// shuffles (a doubling window sum over size / 4 lanes plus the partial
// column sums of two lanes) and writes them with 16-byte stores into rows
// padded to a multiple of 4 int32. No branch separates the eight rows of
// a whole batch, so their shuffle chains interleave. The size - 1 halo
// rows are read once a band, the halo columns (size of 128) once a strip.
// What holds it back: about 11 warps an SM at 1080p, each a chain of
// dependent load rounds and shuffles, so latency rather than bytes.
// box_energies_deep is the same kernel on int16 samples (the deep path's
// `_window_energies` of rc * rc, me_mxu.py:176): a lane reads its four
// samples with four 2-byte loads and keeps them centred, (a >> shift) -
// mid, two to a word; columns past the row read as 0. Every window sum is
// below 1024 * 512^2 < 2^31. Bound: bytes (2.4 MB more in than the 8-bit
// plane at 1080p).
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// ------------------------------------------------------------ ssd_table

constexpr int kSsdMaxWarps = 8;
constexpr int kMTiles = 3;  // m16 tiles a warp owns (one N tile wide)

// N tile width TN and product depth 32 * KS per block size (TN + size - 1
// <= 32 * KS; TN a multiple of 16 so ldmatrix rows stay 16-byte aligned).
template <int SIZE>
struct SsdTile;
template <>
struct SsdTile<8> {
  static constexpr int TN = 16, KS = 1;
};
template <>
struct SsdTile<16> {
  static constexpr int TN = 16, KS = 1;
};
template <>
struct SsdTile<32> {
  static constexpr int TN = 32, KS = 2;
};

// Shared-memory layout of one ssd_table thread block.
template <int SIZE>
struct SsdLayout {
  static constexpr int TN = SsdTile<SIZE>::TN, KS = SsdTile<SIZE>::KS;
  static constexpr int BW = 32 * KS + TN - 4;  // B words per block row
  int nyx, aw, mt_n, nt_n, rows, stride;
  __host__ __device__ explicit SsdLayout(int r) {
    nyx = 2 * r + 1;
    aw = 2 * r + SIZE;
    mt_n = (nyx + 15) / 16;
    nt_n = (nyx + TN - 1) / TN;
    rows = mt_n * 16 + SIZE - 1;
    const int cols = (nt_n - 1) * TN + 32 * KS;
    stride = (cols + 15) & ~15;
    if (((stride >> 4) & 1) == 0) stride += 16;  // odd multiple of 16 B
  }
  __host__ __device__ size_t window_bytes() const {
    return static_cast<size_t>(rows) * stride;
  }
  __host__ __device__ size_t bytes() const {
    return window_bytes() + static_cast<size_t>(SIZE) * BW * 4 + SIZE * SIZE;
  }
  __host__ __device__ int items() const {
    return (mt_n + kMTiles - 1) / kMTiles * nt_n;
  }
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& a0,
                                            uint32_t& a1, uint32_t& a2,
                                            uint32_t& a3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a0), "=r"(a1), "=r"(a2), "=r"(a3)
      : "r"(addr));
}

// c += A(16x32, s8, row) * B(32x8, s8, col), exact in s32
__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc[mt][ns] += the correlation of one work item's first mcount m16 tiles
// of window rows with every block row's B words (swb: [SIZE][BW]); a_base
// is this lane's ldmatrix address of the item's first window row and
// column (see ssd_table_kernel).
template <int SIZE, int UNROLL>
__device__ __forceinline__ void correlate_item(
    int (&acc)[kMTiles][SsdTile<SIZE>::TN / 8][4], uint32_t a_base,
    const uint32_t* swb, int S, int mcount, int g, int t) {
  using L = SsdLayout<SIZE>;
  constexpr int TN = L::TN, KS = L::KS, NS = TN / 8, BW = L::BW;
#pragma unroll (UNROLL)
  for (int i = 0; i < SIZE; ++i) {
    // B fragment (ks, ns, h): k = 32 ks + 16 h + 4 t + q, n = 8 ns + g,
    // T = b[i][k - n]: the word at offset 32 ks + 16 h - 8 ns + 4 t - g
    const uint32_t* wb = swb + i * BW + (TN - 1) + 4 * t - g;
    uint32_t bf[KS][NS][2];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int ns = 0; ns < NS; ++ns)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          bf[ks][ns][h] = wb[32 * ks + 16 * h - 8 * ns];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
      if (mt < mcount) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t a0, a1, a2, a3;
          ldmatrix_x4(a_base + (mt * 16 + i) * S + 32 * ks, a0, a1, a2, a3);
#pragma unroll
          for (int ns = 0; ns < NS; ++ns)
            mma_s8(acc[mt][ns], a0, a1, a2, a3, bf[ks][ns][0],
                   bf[ks][ns][1]);
        }
      }
    }
  }
}

template <int SIZE>
__global__ void __launch_bounds__(kSsdMaxWarps * 32, 3)
ssd_table_kernel(const uint8_t* __restrict__ roi, long long roi_stride,
                 const uint8_t* __restrict__ orig, long long orig_stride,
                 const int* __restrict__ box, long long box_stride,
                 int* __restrict__ out, int r, int nx) {
  using L = SsdLayout<SIZE>;
  constexpr int TN = L::TN, NS = TN / 8, BW = L::BW;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int b2_warp[kSsdMaxWarps];
  const L lay(r);
  const int nyx = lay.nyx, aw = lay.aw, S = lay.stride;
  uint8_t* sw = smem;                                           // [rows][S]
  uint32_t* sw32 = reinterpret_cast<uint32_t*>(sw);
  uint32_t* swb = reinterpret_cast<uint32_t*>(smem + lay.window_bytes());
  uint8_t* sb = reinterpret_cast<uint8_t*>(swb + SIZE * BW);  // [SIZE][SIZE]
  const int n = blockIdx.x;
  const int by = n / nx, bx = n - (n / nx) * nx;

  // the window: word-aligned rows stream in with cp.async; other words
  // (the plane's unaligned case, the row tail, rows and columns past aw)
  // are assembled byte by byte, zero past aw
  const uint8_t* ga = roi + (static_cast<long long>(by) * SIZE) * roi_stride +
                      static_cast<long long>(bx) * SIZE;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(ga) | static_cast<uintptr_t>(roi_stride)) &
       3) == 0;
  const int s4 = S >> 2;
  for (int k = threadIdx.x; k < lay.rows * s4; k += blockDim.x) {
    const int y = k / s4, x = (k - y * s4) << 2;
    const uint8_t* row = ga + y * roi_stride;
    if (aligned && y < aw && x + 4 <= aw) {
      cp_async4(sw32 + k, row + x);
    } else {
      uint32_t w = 0;
      if (y < aw) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (x + q < aw) w |= static_cast<uint32_t>(row[x + q]) << (8 * q);
      }
      sw32[k] = w;
    }
  }
  const uint8_t* gb = orig + (static_cast<long long>(by) * SIZE) * orig_stride +
                      static_cast<long long>(bx) * SIZE;
  int b2 = 0;
  for (int k = threadIdx.x; k < SIZE * SIZE; k += blockDim.x) {
    const int y = k / SIZE, x = k - (k / SIZE) * SIZE;
    const int v = static_cast<int>(gb[y * orig_stride + x]) - 128;
    sb[k] = static_cast<uint8_t>(v);
    b2 += v * v;
  }
  for (int off = 16; off > 0; off >>= 1)
    b2 += __shfl_xor_sync(0xffffffffu, b2, off);
  if ((threadIdx.x & 31) == 0) b2_warp[threadIdx.x >> 5] = b2;
  cp_async_wait_all();
  __syncthreads();
  // centre the samples (v - 128 as int8 is v ^ 0x80) and build the B
  // words: swb[i][w] holds bytes b[i][o .. o+3], o = w - (TN - 1), of the
  // block row zero-extended on both sides
  for (int k = threadIdx.x; k < lay.rows * s4; k += blockDim.x) {
    const int y = k / s4, x = (k - y * s4) << 2;
    const int m = aw - x;  // real samples in this word (if y < aw)
    if (y < aw && m > 0)
      sw32[k] ^= m >= 4 ? 0x80808080u : 0x80808080u & ((1u << (8 * m)) - 1);
  }
  for (int k = threadIdx.x; k < SIZE * BW; k += blockDim.x) {
    const int i = k / BW, o = k - (k / BW) * BW - (TN - 1);
    uint32_t w = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (o + q >= 0 && o + q < SIZE)
        w |= static_cast<uint32_t>(sb[i * SIZE + o + q]) << (8 * q);
    swb[k] = w;
  }
  b2 = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) b2 += b2_warp[w];
  __syncthreads();

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // this lane's ldmatrix row and byte column within a 16 x 32 A tile
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 16;
  const uint32_t sw_base = static_cast<uint32_t>(__cvta_generic_to_shared(sw));
  int* o = out + static_cast<long long>(n) * nyx * nyx;
  const int* bw = box + (static_cast<long long>(by) * SIZE) * box_stride +
                  static_cast<long long>(bx) * SIZE;
  const int items = lay.items();
  for (int item = threadIdx.x >> 5; item < items; item += blockDim.x >> 5) {
    const int mg = item / lay.nt_n, nt = item - mg * lay.nt_n;
    const int m0 = mg * kMTiles * 16, dx0 = nt * TN;
    const int mcount = min(kMTiles, lay.mt_n - mg * kMTiles);
    int acc[kMTiles][NS][4];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int ns = 0; ns < NS; ++ns)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][ns][c] = 0;
    correlate_item<SIZE, 4>(acc, sw_base + (m0 + a_row) * S + dx0 + a_col,
                            swb, S, mcount, g, t);
    // epilogue: c0, c1 at (row g, cols 2t, 2t+1); c2, c3 at row g + 8
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
      if (mt < mcount) {
#pragma unroll
        for (int ns = 0; ns < NS; ++ns)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int dy = m0 + mt * 16 + g + 8 * (c >> 1);
            const int dx = dx0 + 8 * ns + 2 * t + (c & 1);
            if (dy < nyx && dx < nyx)
              o[dy * nyx + dx] =
                  bw[dy * box_stride + dx] + b2 - 2 * acc[mt][ns][c];
          }
      }
    }
  }
}

template <int SIZE>
int launch_ssd_table(const void* roi, long long roi_stride, const void* orig,
                     long long orig_stride, const void* box,
                     long long box_stride, void* out, int r, int ny, int nx,
                     cudaStream_t stream) {
  const SsdLayout<SIZE> lay(r);
  const size_t smem = lay.bytes();
  cudaError_t e = allow_smem(ssd_table_kernel<SIZE>, smem);
  if (e != cudaSuccess) return e;
  const int warps = std::min(kSsdMaxWarps, lay.items());
  if (ny > 0 && nx > 0)
    ssd_table_kernel<SIZE><<<ny * nx, warps * 32, smem, stream>>>(
        static_cast<const uint8_t*>(roi), roi_stride,
        static_cast<const uint8_t*>(orig), orig_stride,
        static_cast<const int*>(box), box_stride, static_cast<int*>(out), r,
        nx);
  return cudaGetLastError();
}

// ------------------------------------------------------- ssd_table_deep

// Tiling of the deep kernel per block size (see the header comment):
// H 16-byte k segments a block row and n8 tile, RP block rows a pass of
// the k loop (RP * H even: whole k-steps), NV n8 tiles a work item, WARPS
// warps a thread block, MINB thread blocks an SM (so at most
// 65536 / (MINB * WARPS * 32) registers a thread).
template <int SIZE>
struct DeepTile;
template <>
struct DeepTile<32> {
  static constexpr int H = 3, RP = 2, NV = 4, WARPS = 8, MINB = 2;
};
template <>
struct DeepTile<16> {
  static constexpr int H = 2, RP = 1, NV = 6, WARPS = 3, MINB = 5;
};
template <>
struct DeepTile<8> {
  static constexpr int H = 2, RP = 1, NV = 6, WARPS = 3, MINB = 5;
};
constexpr int kDeepParts = 3;  // hi, lo and s = hi + lo

// Shared-memory layout of one search block of ssd_table_deep: the biased
// hi and lo windows [rows][stride] (uint8) and the B words [3][SIZE][BW].
template <int SIZE>
struct DeepLayout {
  using T = DeepTile<SIZE>;
  static constexpr int H = T::H, NV = T::NV;
  static constexpr int SEGS = NV / 2 + H - 1;  // k segments of a full item
  static constexpr int BW = 16 * (H - 1) + 28;  // B words a block row
  int nyx, aw, mt_n, nv_n, ng_n, tail, rows, stride;
  bool packed;
  __host__ __device__ explicit DeepLayout(int r) {
    nyx = 2 * r + 1;
    aw = 2 * r + SIZE;
    mt_n = (nyx + 15) / 16;
    nv_n = (nyx + 7) / 8;
    ng_n = (nv_n + NV - 1) / NV;
    // the last m16 tile holds `tail` rows of offsets; when tail rows of
    // mt_n 16-column groups fit its 16 rows (and save n8 tiles), it is
    // packed: row m is offset row m0 + m / mt_n at columns
    // 16 (m % mt_n) .. + 15, two n8 tiles wide
    tail = nyx - 16 * (mt_n - 1);
    packed = tail * mt_n <= 16 && nv_n > 2;
    rows = mt_n * 16 + SIZE - 1;
    // the end of the columns an item reads (an item with `live` n8 tiles
    // reads ((live - 1) >> 1) + H k segments): the last group, a full
    // group, the packed tile (two n8 tiles)
    int cols = (ng_n - 1) * 8 * NV +
               16 * (((nv_n - (ng_n - 1) * NV - 1) >> 1) + H);
    if (ng_n > 1 && (ng_n - 2) * 8 * NV + 16 * SEGS > cols)
      cols = (ng_n - 2) * 8 * NV + 16 * SEGS;
    if (packed && 16 * (mt_n - 1 + H) > cols) cols = 16 * (mt_n - 1 + H);
    stride = (cols + 15) & ~15;
    if (((stride >> 4) & 1) == 0) stride += 16;  // odd multiple of 16 B
  }
  __host__ __device__ size_t window_bytes() const {
    return static_cast<size_t>(rows) * stride;
  }
  __host__ __device__ size_t words_offset() const {
    return 2 * window_bytes();
  }
  __host__ __device__ size_t bytes() const {  // a multiple of 16
    return words_offset() + kDeepParts * SIZE * BW * 4;
  }
  // m16 tiles of one offset row a tile row, and the work items
  __host__ __device__ int mt_rows() const { return packed ? mt_n - 1 : mt_n; }
  __host__ __device__ int items() const { return mt_rows() * ng_n + packed; }
};

__device__ __forceinline__ void ldmatrix_x2(uint32_t addr, uint32_t& a0,
                                            uint32_t& a1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(a0), "=r"(a1)
               : "r"(addr));
}

// c += A(16x32, u8, row) * B(32x8, s8, col), exact in s32
__device__ __forceinline__ void mma_u8s8(int (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Two window samples (int16 halves of w) -> their biased bytes
// e = (a >> shift) + 576 - mid in [64, 1087]: lo' = e & 127 and
// hi' = e >> 7, as two 16-bit lanes each.
__device__ __forceinline__ void split_pair(uint32_t w, int shift,
                                           uint32_t bias2, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t e = ((w >> shift) & ((0xffffu >> shift) * 0x10001u)) + bias2;
  lo = e & 0x007f007fu;
  hi = (e >> 7) & 0x000f000fu;
}

// The products and epilogue of one work item with LIVE n8 tiles (LIVE a
// compile-time count, so that an item with fewer tiles than NV loads only
// the k segments and B words it uses and holds only its accumulators).
// a_hi, a_lo: this lane's ldmatrix address of segment 0 of the hi and lo
// windows at block row 0; wb: its B-word pointer; e0, e1: the offset row
// and first column of tile rows g and g + 8; b2c: sum(b^2) + 1152 sum(b);
// o, bwin: the block's table and box plane.
template <int SIZE, int LIVE>
__device__ __forceinline__ void deep_item(uint32_t a_hi, uint32_t a_lo,
                                          int S, const uint32_t* wb,
                                          int2 e0, int2 e1, int nyx, int t,
                                          uint32_t b2c, int* o,
                                          const int* bwin,
                                          long long box_stride) {
  using T = DeepTile<SIZE>;
  constexpr int H = T::H, RP = T::RP, BW = DeepLayout<SIZE>::BW;
  constexpr int KP = RP * H / 2;          // mma k-steps a pass and n8 tile
  constexpr int NSEG = ((LIVE - 1) >> 1) + H;  // k segments the tiles read
  int acc[LIVE][kDeepParts][4] = {};
#pragma unroll 1
  for (int i = 0; i < SIZE; i += RP) {
    // block row by block row: its A segments and B words, then the k-steps
    // whose second half lies in it (a k-step may take its first half from
    // the row before, whose registers stay live till then)
    uint32_t ah[RP][NSEG][2], al[RP][NSEG][2];
    uint32_t bw[RP][2][H][kDeepParts];
#pragma unroll
    for (int rr = 0; rr < RP; ++rr) {
      // A: the k segments 0 .. NSEG - 1 of the tile rows' window rows
      // + i + rr, in pairs (ldmatrix.x4) and an odd last one (x2)
#pragma unroll
      for (int u = 0; u < NSEG; u += 2) {
        const uint32_t off = (i + rr) * S + 16 * u;
        if (u + 1 < NSEG) {
          ldmatrix_x4(a_hi + off, ah[rr][u][0], ah[rr][u][1],
                      ah[rr][u + 1][0], ah[rr][u + 1][1]);
          ldmatrix_x4(a_lo + off, al[rr][u][0], al[rr][u][1],
                      al[rr][u + 1][0], al[rr][u + 1][1]);
        } else {  // lanes 0-15 give the rows
          ldmatrix_x2(a_hi + off, ah[rr][u][0], ah[rr][u][1]);
          ldmatrix_x2(a_lo + off, al[rr][u][0], al[rr][u][1]);
        }
      }
      // n8 tiles of one parity at a time, with that parity's B words of
      // this row (the same for every tile of the parity)
#pragma unroll
      for (int par = 0; par < 2 && par < LIVE; ++par) {
#pragma unroll
        for (int k = 0; k < H; ++k)
#pragma unroll
          for (int p = 0; p < kDeepParts; ++p)
            bw[rr][par][k][p] =
                wb[(p * SIZE + i + rr) * BW + 16 * k - 8 * par];
#pragma unroll
        for (int v = par; v < LIVE; v += 2) {
          const int u0 = v >> 1;
#pragma unroll
          for (int kp = 0; kp < KP; ++kp) {
            // the two k segments (row i + r, segment u0 + k) of a step
            const int r0 = 2 * kp / H, k0 = 2 * kp % H;
            const int r1 = (2 * kp + 1) / H, k1 = (2 * kp + 1) % H;
            if (r1 != rr) continue;
            const uint32_t h0 = ah[r0][u0 + k0][0], h1 = ah[r0][u0 + k0][1];
            const uint32_t h2 = ah[r1][u0 + k1][0], h3 = ah[r1][u0 + k1][1];
            const uint32_t l0 = al[r0][u0 + k0][0], l1 = al[r0][u0 + k0][1];
            const uint32_t l2 = al[r1][u0 + k1][0], l3 = al[r1][u0 + k1][1];
            const uint32_t(&b0)[kDeepParts] = bw[r0][par][k0];
            const uint32_t(&b1)[kDeepParts] = bw[r1][par][k1];
            mma_u8s8(acc[v][0], h0, h1, h2, h3, b0[0], b1[0]);
            mma_u8s8(acc[v][1], l0, l1, l2, l3, b0[1], b1[1]);
            // s' = hi' + lo' <= 135 a byte: no carry between bytes
            mma_u8s8(acc[v][2], h0 + l0, h1 + l1, h2 + l2, h3 + l3, b0[2],
                     b1[2]);
          }
        }
      }
    }
  }
  // epilogue: c0, c1 at (tile row g, cols 2t, 2t+1); c2, c3 at g + 8.
  // corr = fold - 576 sum(b), so ssd = win + b2 + 1152 sum(b) - 2 fold
#pragma unroll
  for (int v = 0; v < LIVE; ++v) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int2 e = c < 2 ? e0 : e1;
      const int dy = e.x, dx = e.y + 8 * v + 2 * t + (c & 1);
      if (dy < nyx && dx < nyx) {
        const uint32_t fold = 16256u * static_cast<uint32_t>(acc[v][0][c]) -
                              127u * static_cast<uint32_t>(acc[v][1][c]) +
                              128u * static_cast<uint32_t>(acc[v][2][c]);
        o[dy * nyx + dx] = static_cast<int>(
            static_cast<uint32_t>(bwin[dy * box_stride + dx]) + b2c -
            2u * fold);
      }
    }
  }
}

// deep_item<SIZE, live> for a runtime live in 1 .. LIVE.
template <int SIZE, int LIVE, typename... Args>
__device__ __forceinline__ void deep_item_of(int live, Args... args) {
  if constexpr (LIVE > 1) {
    if (live < LIVE) {
      deep_item_of<SIZE, LIVE - 1>(live, args...);
      return;
    }
  }
  deep_item<SIZE, LIVE>(args...);
}

template <int SIZE, bool STAGE_ONLY>
__global__ void __launch_bounds__(DeepTile<SIZE>::WARPS * 32,
                                  DeepTile<SIZE>::MINB)
ssd_table_deep_kernel(const int16_t* __restrict__ roi, long long roi_stride,
                      const int16_t* __restrict__ orig, long long orig_stride,
                      const int* __restrict__ box, long long box_stride,
                      int* __restrict__ out, int r, int nx, int shift,
                      int mid) {
  using L = DeepLayout<SIZE>;
  using T = DeepTile<SIZE>;
  constexpr int NV = L::NV, BW = L::BW;
  static_assert(NV % 2 == 0, "an item starts at a 16-byte column");
  static_assert(T::RP * T::H % 2 == 0 && SIZE % T::RP == 0,
                "whole k-steps a pass");
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int red[T::WARPS][2];  // sum(b^2), sum(b) per warp
  const L lay(r);
  const int nyx = lay.nyx, aw = lay.aw, S = lay.stride;
  constexpr int TB = T::WARPS * 32;         // threads (blockDim.x)
  constexpr int WB = 4;                     // window chunks in flight a thread
  constexpr int NBT = (SIZE * 16 + TB - 1) / TB;  // B-word tasks a thread
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t bias2 = static_cast<uint32_t>(576 - mid) * 0x10001u;

  // staging. B words: word w of (part, row i) holds taps w - 15 .. w - 12
  // of the zero-extended block row. Lane (i, q) of a 16-lane row group
  // reads taps 4q - 15 .. 4q - 12 (their loads issued first), splits them
  // into three words, takes lane q + 1's by a shuffle and writes words
  // 4q .. 4q + 3 by funnel shifts. The window: 8-sample chunks split into
  // the biased hi and lo bytes (16-byte loads, WB in flight a thread,
  // where the plane allows).
  const int n = blockIdx.x;
  const int by = n / nx, bx = n - (n / nx) * nx;
  const int16_t* gb = orig + (static_cast<long long>(by) * SIZE) * orig_stride +
                      static_cast<long long>(bx) * SIZE;
  int tap[NBT][4];
#pragma unroll
  for (int it = 0; it < NBT; ++it) {
    const int k = tid + it * TB, i = k >> 4, q = k & 15;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = 4 * q - 15 + u;
      tap[it][u] = k < SIZE * 16 && j >= 0 && j < SIZE
                       ? static_cast<int>(gb[i * orig_stride + j])
                       : -1;
    }
  }
  {
    // only the aw x aw samples are staged: window bytes past aw (rows
    // and columns) meet zero B taps or feed offsets past nyx, never
    // stored, so they may hold anything
    const int16_t* ga = roi +
                        (static_cast<long long>(by) * SIZE) * roi_stride +
                        static_cast<long long>(bx) * SIZE;
    const bool aligned = ((reinterpret_cast<uintptr_t>(ga) |
                           static_cast<uintptr_t>(roi_stride * 2)) &
                          15) == 0;
    const int cwa = (aw + 7) >> 3;  // 8-sample chunks of a window row
    const int ys = TB / cwa, cs = TB - ys * cwa;  // a step of TB chunks
    int y = tid / cwa, c = tid - y * cwa;         // this thread's chunk
    uint2* hw = reinterpret_cast<uint2*>(smem);
    uint2* lw = reinterpret_cast<uint2*>(smem + lay.window_bytes());
    while (y < aw) {
      int yc[WB], xc[WB];
      int4 v[WB];
      bool vec[WB];
#pragma unroll
      for (int u = 0; u < WB; ++u) {
        yc[u] = y;
        xc[u] = c << 3;
        vec[u] = aligned && y < aw && xc[u] + 8 <= aw;
        if (vec[u])
          v[u] = __ldg(
              reinterpret_cast<const int4*>(ga + y * roi_stride + xc[u]));
        c += cs;
        y += ys + (c >= cwa);
        if (c >= cwa) c -= cwa;
      }
#pragma unroll
      for (int u = 0; u < WB; ++u) {
        if (yc[u] >= aw) break;
        uint32_t hp[4], lp[4];
        if (vec[u]) {
          split_pair(static_cast<uint32_t>(v[u].x), shift, bias2, hp[0],
                     lp[0]);
          split_pair(static_cast<uint32_t>(v[u].y), shift, bias2, hp[1],
                     lp[1]);
          split_pair(static_cast<uint32_t>(v[u].z), shift, bias2, hp[2],
                     lp[2]);
          split_pair(static_cast<uint32_t>(v[u].w), shift, bias2, hp[3],
                     lp[3]);
        } else {  // the unaligned plane, the row's last partial chunk
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            hp[q] = lp[q] = 0;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int xx = xc[u] + 2 * q + h;
              if (xx < aw) {
                const uint32_t e = static_cast<uint32_t>(
                    (static_cast<int>(ga[yc[u] * roi_stride + xx]) >>
                     shift) +
                    576 - mid);
                lp[q] |= (e & 127u) << (16 * h);
                hp[q] |= (e >> 7) << (16 * h);
              }
            }
          }
        }
        const int k = yc[u] * (S >> 3) + (xc[u] >> 3);
        hw[k] = make_uint2(__byte_perm(hp[0], hp[1], 0x6420),
                           __byte_perm(hp[2], hp[3], 0x6420));
        lw[k] = make_uint2(__byte_perm(lp[0], lp[1], 0x6420),
                           __byte_perm(lp[2], lp[3], 0x6420));
      }
    }
  }
  int b2 = 0, bs = 0;
  uint32_t* wb_out = reinterpret_cast<uint32_t*>(smem + lay.words_offset());
#pragma unroll
  for (int it = 0; it < NBT; ++it) {
    const int k = tid + it * TB, i = k >> 4, q = k & 15;
    if (k >= SIZE * 16) break;  // whole warps (SIZE * 16 % 32 == 0)
    uint32_t w[kDeepParts] = {0, 0, 0};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (tap[it][u] >= 0) {
        const int c = (tap[it][u] >> shift) - mid;
        const int lo = ((c + 64) & 127) - 64, hi = (c - lo) >> 7;
        w[0] |= (static_cast<uint32_t>(hi) & 0xffu) << (8 * u);
        w[1] |= (static_cast<uint32_t>(lo) & 0xffu) << (8 * u);
        w[2] |= (static_cast<uint32_t>(hi + lo) & 0xffu) << (8 * u);
        b2 += c * c;
        bs += c;
      }
    }
#pragma unroll
    for (int p = 0; p < kDeepParts; ++p) {
      const uint32_t next = __shfl_down_sync(0xffffffffu, w[p], 1);
      if (4 * q < BW)
        *reinterpret_cast<uint4*>(wb_out + (p * SIZE + i) * BW + 4 * q) =
            make_uint4(w[p], __funnelshift_r(w[p], next, 8),
                       __funnelshift_r(w[p], next, 16),
                       __funnelshift_r(w[p], next, 24));
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    b2 += __shfl_xor_sync(0xffffffffu, b2, off);
    bs += __shfl_xor_sync(0xffffffffu, bs, off);
  }
  if (lane == 0) {
    red[warp][0] = b2;
    red[warp][1] = bs;
  }
  __syncthreads();
  if constexpr (STAGE_ONLY) {  // the staging probe: one word a thread out
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(smem);
    if (tid < nyx * nyx)
      out[static_cast<long long>(n) * nyx * nyx + tid] = static_cast<int>(
          sw[tid] ^ reinterpret_cast<const uint32_t*>(
                        smem + lay.words_offset())[tid]) +
          red[0][0];
    return;
  }

  // products: item = (m16 tile, group of NV n8 tiles); the groups with
  // fewer live n8 tiles, then the packed tile, last
  const int g = lane >> 2, t = lane & 3;
  // this lane's ldmatrix row and segment within a pair of k segments
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_seg = lane >> 4;
  int b2s = 0, bss = 0;
#pragma unroll
  for (int w = 0; w < T::WARPS; ++w) {
    b2s += red[w][0];
    bss += red[w][1];
  }
  const uint32_t b2c =
      static_cast<uint32_t>(b2s) + 1152u * static_cast<uint32_t>(bss);
  const int mtr = lay.mt_rows();
  const int full = (lay.ng_n - 1) * mtr;  // items of full groups
  for (int item = warp; item < lay.items(); item += T::WARPS) {
    const bool pk = item >= mtr * lay.ng_n;  // the packed tile
    const bool last = item >= full;
    const int mt = pk ? lay.mt_n - 1 : last ? item - full
                                            : item / (lay.ng_n - 1);
    const int ng = pk || last ? lay.ng_n - 1 : item - mt * (lay.ng_n - 1);
    const int m0 = mt * 16, dx0 = pk ? 0 : ng * 8 * NV;
    const int live = pk ? 2 : min(NV, lay.nv_n - ng * NV);  // in the table
    // tile row m: offset row dy and first column cx (rows of the packed
    // tile past its tail * mt_n get dy = nyx: computed, never stored)
    auto tile_row = [&](int m, int& dy, int& cx) {
      if (pk) {
        const int q = m / lay.mt_n;
        dy = m0 + min(q, lay.tail);
        cx = 16 * (m - q * lay.mt_n);
      } else {
        dy = m0 + m;
        cx = dx0;
      }
    };
    int a_dy, a_cx, g_dy, g_cx, h_dy, h_cx;
    tile_row(a_row, a_dy, a_cx);
    tile_row(g, g_dy, g_cx);
    tile_row(g + 8, h_dy, h_cx);
    const uint32_t a_hi =
        static_cast<uint32_t>(__cvta_generic_to_shared(smem)) + a_dy * S +
        a_cx + 16 * a_seg;
    // B word (part p, row i, parity par, segment k) of this lane: taps
    // 16 k - 8 par + 4 t - g .. + 3, at word 16 k - 8 par + 4 t - g + 15
    deep_item_of<SIZE, NV>(
        live, a_hi, a_hi + static_cast<uint32_t>(lay.window_bytes()), S,
        reinterpret_cast<const uint32_t*>(smem + lay.words_offset()) +
            (4 * t - g + 15),
        make_int2(g_dy, g_cx), make_int2(h_dy, h_cx), nyx, t, b2c,
        out + static_cast<long long>(n) * nyx * nyx,
        box + (static_cast<long long>(by) * SIZE) * box_stride +
            static_cast<long long>(bx) * SIZE,
        box_stride);
  }
}

template <int SIZE, bool STAGE_ONLY>
int launch_ssd_table_deep(const void* roi, long long roi_stride,
                          const void* orig, long long orig_stride,
                          const void* box, long long box_stride, void* out,
                          int r, int ny, int nx, int shift, int mid,
                          cudaStream_t stream) {
  const DeepLayout<SIZE> lay(r);
  const size_t smem = lay.bytes();
  cudaError_t e = allow_smem(ssd_table_deep_kernel<SIZE, STAGE_ONLY>, smem);
  if (e != cudaSuccess) return e;
  if (ny > 0 && nx > 0)
    ssd_table_deep_kernel<SIZE, STAGE_ONLY>
        <<<ny * nx, DeepTile<SIZE>::WARPS * 32, smem, stream>>>(
            static_cast<const int16_t*>(roi), roi_stride,
            static_cast<const int16_t*>(orig), orig_stride,
            static_cast<const int*>(box), box_stride, static_cast<int*>(out),
            r, nx, shift, mid);
  return cudaGetLastError();
}

// The mma.sync rate probe (chip_smoke.py times it): each warp runs 8
// independent chains of m16n8k32 u8 x s8 products on register operands,
// the deep kernel's instruction without its loads.
__global__ void __launch_bounds__(256) mma_probe_kernel(int* __restrict__ out,
                                                         int iters) {
  int acc[8][4] = {};
  const uint32_t a = threadIdx.x * 2654435761u, b = blockIdx.x * 40503u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      mma_u8s8(acc[k], a + k, a ^ k, a + 2 * k, a, b + it, b ^ it);
  }
  int r = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    r += acc[k][0] + acc[k][1] + acc[k][2] + acc[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = r;
}

// ---------------------------------------------------------- box_energies

constexpr int kBoxWarps = 4;   // adjacent strips of one thread block
constexpr int kBoxRows = 16;   // output rows of a band
constexpr int kBoxBatch = 8;   // rows whose loads are in flight at once
constexpr unsigned kFull = 0xffffffffu;

// A lane's four samples of one row: four bytes of 8-bit samples, or four
// centred deep samples, two int16 halves a word.
template <typename T>
struct BoxWord;
template <>
struct BoxWord<uint8_t> {
  using type = uint32_t;
};
template <>
struct BoxWord<int16_t> {
  using type = uint2;
};

// col[k] += sign * (byte k of v - 128)^2
template <int SIGN>
__device__ __forceinline__ void add_sq(uint32_t v, int (&col)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int x = static_cast<int>((v >> (8 * k)) & 0xffu) - 128;
    col[k] += SIGN * x * x;
  }
}

// col[k] += sign * (centred sample k)^2
template <int SIGN>
__device__ __forceinline__ void add_sq(uint2 v, int (&col)[4]) {
  const int x[4] = {static_cast<int16_t>(v.x & 0xffffu),
                    static_cast<int16_t>(v.x >> 16),
                    static_cast<int16_t>(v.y & 0xffffu),
                    static_cast<int16_t>(v.y >> 16)};
#pragma unroll
  for (int k = 0; k < 4; ++k) col[k] += SIGN * x[k] * x[k];
}

// box[y, x] = sum of (roi - 128)^2 over the SIZE x SIZE square at (y, x),
// for y < out_h, x < out_w (roi holds out_h + SIZE - 1 rows and
// out_w + SIZE - 1 columns). A warp owns a strip of 128 input columns (4
// a lane) and 128 - SIZE output columns over a band of kBoxRows rows; it
// walks the band keeping each lane's 4 column sums of the window's SIZE
// rows (add the entering row, subtract the leaving one). Per row, the
// window sum of lanes l .. l + SIZE/4 - 1 comes from log2(SIZE/4) doubling
// shuffles, and output column 4l + k corrects it by the first k column
// sums of lane l and of lane l + SIZE/4, and stores 16 bytes (box is
// 16-byte aligned and box_stride a multiple of 4).
// T is uint8_t (8-bit samples, centred on 128; shift and mid unused) or
// int16_t (deep samples, centred as (a >> shift) - mid).
template <int SIZE, typename T>
__global__ void __launch_bounds__(32 * kBoxWarps)
box_energies_kernel(const T* __restrict__ roi, long long roi_stride,
                    int out_h, int out_w, int* __restrict__ box,
                    long long box_stride, int shift, int mid) {
  using Word = typename BoxWord<T>::type;
  constexpr int kOut = 128 - SIZE;  // output columns of a strip
  constexpr int kLanes = SIZE / 4;  // lanes a window spans
  const int lane = threadIdx.x & 31;
  const int x0 = (blockIdx.x * kBoxWarps + (threadIdx.x >> 5)) * kOut;
  if (x0 >= out_w) return;
  const int y0 = blockIdx.y * kBoxRows;
  const int y1 = min(y0 + kBoxRows, out_h);
  const int in_w = out_w + SIZE - 1;
  const int c = x0 + 4 * lane;
  const bool out_lane = lane < 32 - kLanes;
  // A lane reads the word of columns cl .. cl + 3, all inside the row, and
  // shifts it down by the dd of its columns c .. c + 3 that lie beyond the
  // row; those bytes read as 128 (a zero square).
  const int cl = min(c, in_w - 4);
  const int dd = min(c - cl, 4);
  const unsigned dsh = 8 * min(dd, 3);
  const uint32_t keep = dd >= 4 ? 0u : 0xffffffffu >> (8 * dd);
  const uint32_t fill = 0x80808080u & ~keep;
  auto load = [&](int y) -> Word {
    if constexpr (sizeof(T) == 1) {
      // row y's word: two aligned word loads and a funnel shift, as the row
      // may start at any byte (the shift is the same for every lane)
      const uintptr_t p =
          reinterpret_cast<uintptr_t>(roi + y * roi_stride + cl);
      const uint32_t* a =
          reinterpret_cast<const uint32_t*>(p & ~static_cast<uintptr_t>(3));
      const unsigned sh = static_cast<unsigned>(p & 3) * 8;
      const uint32_t w = __funnelshift_r(__ldg(a), __ldg(a + (sh != 0)), sh);
      return ((w >> dsh) & keep) | fill;
    } else {
      // samples c .. c + 3 are cl + dd .. cl + dd + 3; those past the row
      // (k + dd >= 4) read as 0, a zero square
      const T* p = roi + y * roi_stride + cl + dd;
      uint32_t h[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        h[k] = k + dd < 4 ? static_cast<uint32_t>(
                                (static_cast<int>(__ldg(p + k)) >> shift) -
                                mid) & 0xffffu
                          : 0u;
      return make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
    }
  };
  int col[4] = {0, 0, 0, 0};
  // the window's first SIZE - 1 rows, all loads issued before their sums
  {
    Word v[SIZE - 1];
#pragma unroll
    for (int r = 0; r < SIZE - 1; ++r) v[r] = load(y0 + r);
#pragma unroll
    for (int r = 0; r < SIZE - 1; ++r) add_sq<1>(v[r], col);
  }
  // the stores of a lane: 16 bytes, or the columns before out_w one by one
  const bool vec = out_lane && c + 4 <= out_w;
  const int nsc = out_lane && !vec ? out_w - c : 0;
  // one output row from the column sums of its window
  auto row = [&](int y) {
    int g = col[0] + col[1] + col[2] + col[3];
#pragma unroll
    for (int s = 1; s < kLanes; s <<= 1) g += __shfl_down_sync(kFull, g, s);
    const int p1 = col[0], p2 = p1 + col[1], p3 = p2 + col[2];
    const int q1 = __shfl_down_sync(kFull, p1, kLanes);
    const int q2 = __shfl_down_sync(kFull, p2, kLanes);
    const int q3 = __shfl_down_sync(kFull, p3, kLanes);
    const int o[4] = {g, g - p1 + q1, g - p2 + q2, g - p3 + q3};
    int* dst = box + static_cast<long long>(y) * box_stride + c;
    if (vec) {
      *reinterpret_cast<int4*>(dst) = int4{o[0], o[1], o[2], o[3]};
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < nsc) dst[k] = o[k];
    }
  };
  for (int y = y0; y < y1; y += kBoxBatch) {
    if (y + kBoxBatch <= y1) {
      // a whole batch: no branch between its rows, so their shuffle
      // chains can interleave
      Word e[kBoxBatch], l[kBoxBatch];
#pragma unroll
      for (int u = 0; u < kBoxBatch; ++u) {
        e[u] = load(y + u + SIZE - 1);
        l[u] = load(y + u);
      }
#pragma unroll
      for (int u = 0; u < kBoxBatch; ++u) {
        add_sq<1>(e[u], col);
        row(y + u);
        add_sq<-1>(l[u], col);
      }
    } else {
      for (int yy = y; yy < y1; ++yy) {
        add_sq<1>(load(yy + SIZE - 1), col);
        row(yy);
        add_sq<-1>(load(yy), col);
      }
    }
  }
}

template <int SIZE, typename T>
int launch_box_energies(const void* roi, long long roi_stride, int out_h,
                        int out_w, void* box, long long box_stride, int shift,
                        int mid, cudaStream_t stream) {
  constexpr int kOut = 128 - SIZE;
  const int strips = (out_w + kOut - 1) / kOut;
  const dim3 grid((strips + kBoxWarps - 1) / kBoxWarps,
                  (out_h + kBoxRows - 1) / kBoxRows);
  if (out_h > 0 && out_w > 0)
    box_energies_kernel<SIZE, T><<<grid, 32 * kBoxWarps, 0, stream>>>(
        static_cast<const T*>(roi), roi_stride, out_h, out_w,
        static_cast<int*>(box), box_stride, shift, mid);
  return cudaGetLastError();
}

template <typename T>
int box_energies_entry(const void* roi, long long roi_stride, int out_h,
                       int out_w, int size, int shift, int mid, void* box,
                       long long box_stride, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (box_stride % 4 != 0 || reinterpret_cast<uintptr_t>(box) % 16 != 0)
    return cudaErrorInvalidValue;
  switch (size) {
    case 8:
      return launch_box_energies<8, T>(roi, roi_stride, out_h, out_w, box,
                                       box_stride, shift, mid, s);
    case 16:
      return launch_box_energies<16, T>(roi, roi_stride, out_h, out_w, box,
                                        box_stride, shift, mid, s);
    case 32:
      return launch_box_energies<32, T>(roi, roi_stride, out_h, out_w, box,
                                        box_stride, shift, mid, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------ argmin_two_pass

constexpr int kLocalW = 8;
constexpr int kTileY = 2, kTileX = 4;    // grid blocks of one tile
constexpr int kHaloY = kTileY + 2, kHaloX = kTileX + 2;
constexpr int kWarps = kTileY * kTileX;   // one per block of the tile
constexpr int kArgminThreads = kWarps * 32;
constexpr int kVec = 8;                   // pass-2 int4 loads in flight a lane

__device__ __forceinline__ void warp_argmin(int& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    argmin_take(v, i, ov, oi);
  }
}

__global__ void __launch_bounds__(kArgminThreads, 2)
argmin_two_pass_kernel(const int* __restrict__ ssd,
                       const int* __restrict__ bits0, int lam, int r, int ny,
                       int nx, int local_only, int* __restrict__ idx) {
  __shared__ int s_v[kWarps][kWarps], s_i[kWarps][kWarps];
  const int nyx = 2 * r + 1;
  const int npos = nyx * nyx;
  const int ty0 = blockIdx.y * kTileY, tx0 = blockIdx.x * kTileX;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // pass 1. Warp w takes the offsets p = 32 c + lane for c = w, w + kWarps,
  // ... and, for each, loads that offset of the tables of the tile and a
  // one-block halo (coalesced across the warp; none outside the grid),
  // forms the tile's 3x3 sums separably and keeps a first minimum per
  // block of the tile.
  unsigned long long inside = 0;  // halo cell hy * kHaloX + hx in the grid
  for (int h = 0; h < kHaloY * kHaloX; ++h) {
    const int gy = ty0 - 1 + h / kHaloX, gx = tx0 - 1 + h % kHaloX;
    if (gy >= 0 && gy < ny && gx >= 0 && gx < nx) inside |= 1ull << h;
  }
  // in-grid neighbours of block (y, x): cy[y] * cx[x] rate terms
  unsigned cy[kTileY], cx[kTileX];
#pragma unroll
  for (int k = 0; k < kTileY; ++k)
    cy[k] = min(ty0 + k + 1, ny - 1) - max(ty0 + k - 1, 0) + 1;
#pragma unroll
  for (int k = 0; k < kTileX; ++k)
    cx[k] = min(tx0 + k + 1, nx - 1) - max(tx0 + k - 1, 0) + 1;
  const long long row_step = static_cast<long long>(nx) * npos;
  const long long t00 =
      (static_cast<long long>(ty0 - 1) * nx + (tx0 - 1)) * npos;
  int best[kTileY][kTileX], bidx[kTileY][kTileX];
#pragma unroll
  for (int y = 0; y < kTileY; ++y)
#pragma unroll
    for (int x = 0; x < kTileX; ++x) {
      best[y][x] = 0x7fffffff;
      bidx[y][x] = 0x7fffffff;
    }
  for (int p = 32 * warp + lane; p - lane < npos; p += 32 * kWarps) {
    const bool live = p < npos;
    int v[kHaloY][kHaloX];
#pragma unroll
    for (int hy = 0; hy < kHaloY; ++hy)
#pragma unroll
      for (int hx = 0; hx < kHaloX; ++hx)
        v[hy][hx] = live && ((inside >> (hy * kHaloX + hx)) & 1)
                        ? __ldg(ssd + t00 + hy * row_step + hx * npos + p)
                        : 0;
    if (!live) continue;
    const unsigned rate = static_cast<unsigned>(mul_wrap(lam, bits0[p]) >> 8);
    unsigned hs[kHaloY][kTileX];  // horizontal 3-sums
#pragma unroll
    for (int hy = 0; hy < kHaloY; ++hy)
#pragma unroll
      for (int x = 0; x < kTileX; ++x)
        hs[hy][x] = static_cast<unsigned>(v[hy][x]) +
                    static_cast<unsigned>(v[hy][x + 1]) +
                    static_cast<unsigned>(v[hy][x + 2]);
#pragma unroll
    for (int y = 0; y < kTileY; ++y)
#pragma unroll
      for (int x = 0; x < kTileX; ++x) {
        const unsigned s =
            hs[y][x] + hs[y + 1][x] + hs[y + 2][x] + cy[y] * cx[x] * rate;
        argmin_take(best[y][x], bidx[y][x], static_cast<int>(s), p);
      }
  }
  // per block: the warp's minimum, then block (y, x)'s warp takes the
  // minimum over the kWarps (8) warps
#pragma unroll
  for (int y = 0; y < kTileY; ++y)
#pragma unroll
    for (int x = 0; x < kTileX; ++x) {
      warp_argmin(best[y][x], bidx[y][x]);
      if (lane == 0) {
        s_v[y * kTileX + x][warp] = best[y][x];
        s_i[y * kTileX + x][warp] = bidx[y][x];
      }
    }
  __syncthreads();
  int pv = lane < kWarps ? s_v[warp][lane] : 0x7fffffff;
  int pi = lane < kWarps ? s_i[warp][lane] : 0x7fffffff;
  warp_argmin(pv, pi);
  const int pny = pi / nyx - r, pnx = pi % nyx - r;

  // pass 2: warp `warp` rates its own block's table against the pass-1 MV
  // in 16-byte loads, kVec in flight per lane, from the end of the table
  // backwards: its last offsets, read last in pass 1, may still be in L2
  const int gy = ty0 + warp / kTileX, gx = tx0 + warp % kTileX;
  if (gy >= ny || gx >= nx) return;
  const int n = gy * nx + gx;
  const long long start = static_cast<long long>(n) * npos;
  const long long total = static_cast<long long>(ny) * nx * npos;
  const long long base = start & ~3LL;  // 16-byte aligned (ssd is)
  const int nvec = static_cast<int>((start + npos - base + 3) >> 2);
  auto rate2 = [&](int by, int dx) {  // by = mv_bits of the row's dy
    return mul_wrap(lam, by + mv_bits(4 * (dx - r - pnx))) >> 8;
  };
  int bg = 0x7fffffff, ig = 0x7fffffff;  // global minimum
  // (dy, dx) of the first offset of int4 k0, kept without division as k0
  // steps down by 32 (offset by 128)
  int ry = -1, rx = 0;
  {
    const int p = static_cast<int>(base + 4LL * (nvec - 1 - lane) - start);
    if (p >= 0) {
      ry = p / nyx;
      rx = p - ry * nyx;
    } else {
      rx = p + nyx;
    }
  }
  for (int k0 = nvec - 1 - lane; k0 >= 0; k0 -= 32 * kVec) {
    int4 v[kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int k = k0 - 32 * u;
      const long long e = base + 4LL * k;
      if (k >= 0 && e + 4 <= total) {
        v[u] = __ldg(reinterpret_cast<const int4*>(ssd + e));
      } else {  // the last table's tail: no read past the tables
        v[u].x = k >= 0 && e < total ? ssd[e] : 0;
        v[u].y = k >= 0 && e + 1 < total ? ssd[e + 1] : 0;
        v[u].z = k >= 0 && e + 2 < total ? ssd[e + 2] : 0;
        v[u].w = 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int k = k0 - 32 * u;
      if (k < 0) break;
      int p = static_cast<int>(base + 4LL * k - start);  // may be -3 .. -1
      int dy = ry, dx = rx;
      rx -= 128;  // to the next int4 of this lane, 128 offsets earlier
      while (rx < 0) {
        rx += nyx;
        --ry;
      }
      int by = mv_bits(4 * (dy - r - pny));
      const int vals[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (p >= 0 && p < npos)
          argmin_take(bg, ig, add_wrap(vals[q], rate2(by, dx)), p);
        ++p;
        if (++dx == nyx) {
          dx = 0;
          by = mv_bits(4 * (++dy - r - pny));
        }
      }
    }
  }
  warp_argmin(bg, ig);

  // local minimum: the window within +-kLocalW of the pass-1 MV; every
  // other offset counts 1 << 30, of which the first in row-major order
  // is the only candidate
  const int rl = max(0, pny + r - kLocalW);
  const int rh = min(nyx - 1, pny + r + kLocalW);
  const int cl = max(0, pnx + r - kLocalW);
  const int ch = min(nyx - 1, pnx + r + kLocalW);
  const int wc = ch - cl + 1;
  const int* own = ssd + start;
  int bl = 0x7fffffff, il = 0x7fffffff;
  for (int k = lane; k < (rh - rl + 1) * wc; k += 32) {
    const int ly = rl + k / wc, lx = cl + k % wc;
    const int p = ly * nyx + lx;
    argmin_take(bl, il,
                add_wrap(own[p], rate2(mv_bits(4 * (ly - r - pny)), lx)), p);
  }
  warp_argmin(bl, il);
  int p_out = -1;  // first offset outside the window
  if (rl > 0 || cl > 0)
    p_out = 0;
  else if (ch < nyx - 1)
    p_out = ch + 1;
  else if (rh < nyx - 1)
    p_out = (rh + 1) * nyx;
  if (p_out >= 0) argmin_take(bl, il, 1 << 30, p_out);
  if (lane == 0)
    idx[n] = (local_only || !(add_wrap(bg, bl >> 3) < bl)) ? il : ig;
}

}  // namespace

extern "C" int hevc_ssd_table(const void* roi, long long roi_stride,
                              const void* orig, long long orig_stride,
                              const void* box, long long box_stride, void* out,
                              int size, int r, int ny, int nx, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (size) {
    case 8:
      return launch_ssd_table<8>(roi, roi_stride, orig, orig_stride, box,
                                 box_stride, out, r, ny, nx, s);
    case 16:
      return launch_ssd_table<16>(roi, roi_stride, orig, orig_stride, box,
                                  box_stride, out, r, ny, nx, s);
    case 32:
      return launch_ssd_table<32>(roi, roi_stride, orig, orig_stride, box,
                                  box_stride, out, r, ny, nx, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The mma.sync probe: blocks thread blocks of 256 threads, each warp
// 8 * iters m16n8k32 products; out holds blocks * 256 int32.
extern "C" int hevc_mma_probe(void* out, int blocks, int iters,
                              void* stream) {
  if (blocks > 0)
    mma_probe_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<int*>(out), iters);
  return cudaGetLastError();
}

// ssd: [ny * nx, 2r+1, 2r+1] int32, contiguous and 16-byte aligned.
extern "C" int hevc_argmin_two_pass(const void* ssd, const void* bits0,
                                    int lam_q8, int r, int ny, int nx,
                                    int local_only, void* idx, void* stream) {
  const dim3 grid((nx + kTileX - 1) / kTileX, (ny + kTileY - 1) / kTileY);
  if (ny > 0 && nx > 0)
    argmin_two_pass_kernel<<<grid, kArgminThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(ssd), static_cast<const int*>(bits0), lam_q8,
        r, ny, nx, local_only, static_cast<int*>(idx));
  return cudaGetLastError();
}

// box: [out_h, out_w] int32 (16-byte aligned, row stride box_stride a
// multiple of 4) of the uint8 plane
// roi ([out_h + size - 1, out_w + size - 1], row stride roi_stride, any
// alignment); size 8, 16 or 32.
extern "C" int hevc_box_energies(const void* roi, long long roi_stride,
                                 int out_h, int out_w, int size, void* box,
                                 long long box_stride, void* stream) {
  return box_energies_entry<uint8_t>(roi, roi_stride, out_h, out_w, size, 0,
                                     128, box, box_stride, stream);
}

// The same of an int16 plane (row stride roi_stride in samples, 9-14-bit
// samples) with the squares of (a >> shift) - mid.
extern "C" int hevc_box_energies_deep(const void* roi, long long roi_stride,
                                      int out_h, int out_w, int size,
                                      int shift, int mid, void* box,
                                      long long box_stride, void* stream) {
  return box_energies_entry<int16_t>(roi, roi_stride, out_h, out_w, size,
                                     shift, mid, box, box_stride, stream);
}

template <bool STAGE_ONLY>
int ssd_table_deep_entry(const void* roi, long long roi_stride,
                         const void* orig, long long orig_stride,
                         const void* box, long long box_stride, void* out,
                         int size, int r, int ny, int nx, int shift, int mid,
                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (size) {
    case 8:
      return launch_ssd_table_deep<8, STAGE_ONLY>(
          roi, roi_stride, orig, orig_stride, box, box_stride, out, r, ny, nx,
          shift, mid, s);
    case 16:
      return launch_ssd_table_deep<16, STAGE_ONLY>(
          roi, roi_stride, orig, orig_stride, box, box_stride, out, r, ny, nx,
          shift, mid, s);
    case 32:
      return launch_ssd_table_deep<32, STAGE_ONLY>(
          roi, roi_stride, orig, orig_stride, box, box_stride, out, r, ny, nx,
          shift, mid, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// ssd_table of int16 planes (row strides in samples) for 9-14-bit samples,
// each centred as (a >> shift) - mid; box is box_energies_deep's plane.
extern "C" int hevc_ssd_table_deep(const void* roi, long long roi_stride,
                                   const void* orig, long long orig_stride,
                                   const void* box, long long box_stride,
                                   void* out, int size, int r, int ny, int nx,
                                   int shift, int mid, void* stream) {
  return ssd_table_deep_entry<false>(roi, roi_stride, orig, orig_stride, box,
                                     box_stride, out, size, r, ny, nx, shift,
                                     mid, stream);
}

// The staging probe of ssd_table_deep (chip_smoke.py times it): the same
// launch, which stages its windows and B words and returns; it writes
// garbage into the first words of each table.
extern "C" int hevc_ssd_table_deep_stage(const void* roi, long long roi_stride,
                                         const void* orig,
                                         long long orig_stride,
                                         const void* box, long long box_stride,
                                         void* out, int size, int r, int ny,
                                         int nx, int shift, int mid,
                                         void* stream) {
  return ssd_table_deep_entry<true>(roi, roi_stride, orig, orig_stride, box,
                                    box_stride, out, size, r, ny, nx, shift,
                                    mid, stream);
}
