// Full-search SAD tables and their lambda*mv-bits first-minimum argmin.
//
// sad_table replaces hevc_tpu/ops/sad_pallas.py `_sad_kernel` / `sad_table`
// (the Pallas TPU kernel): for int32 blocks [N, h, w] against their own
// int32 search areas [N, h+ny-1, w+nx-1],
//   out[n, dy, dx] = sum_{i<h, j<w} |area[n, dy+i, dx+j] - blk[n, i, j]|
// with int32 wrap, as the reference sums. sad_table_planes and me_planes
// replace the planes-in variants `sad_table_from_planes` / `me_from_planes`
// (sad_pallas.py): each thread block reads its block and its (2r + size)^2
// window straight from the two planes (uint8, int16 or int32 samples); the
// reference materialised every window as an [N, aw, aw] int32 tensor first
// (210 MB at 1080p). Block k = by * nx + bx takes the window whose top-left
// is (pad - r + by * size, pad - r + bx * size) of the padded reference.
// Rows of the power-of-two bucket past ny * nx are a zero block against a
// zero window: SAD 0. me_planes fuses the sweep with cost = sad +
// ((lam_fp * bits) >> 16) (int32 wrap) and the block-wide first-minimum
// argmin, writing one index per block and no table. full_search replaces
// hevc_tpu/ops/me.py `full_search_batch_pallas` (the Pallas table and its
// XLA cost + argmin epilogue) the same way: one launch, the sweep's emit
// folding the cost and the argmin, the four [N] results and no table.
// sad_cost_argmin is that epilogue alone, over a table already written.
//
// What bounds the sweep: instruction issue, not bytes. At the fallback
// path's 1080p shape (N = 2048 blocks of 32 x 32, 129 x 129 offsets) the
// tables are 34.9 G absolute differences against 354 MB of int32 input and
// output (0.11 ms at 3.35 TB/s). A scalar difference is a subtract, an abs
// and an add on the integer pipe, whose 16 lanes a scheduler serve half the
// float32 rate. One thread block per search block stages its area and its
// block in shared memory once; then two barrier votes over the staged
// samples choose one of three sweeps, uniform across the thread block:
//
// - 8-bit path (every sample in [0, 255]; h and w multiples of 4): samples
//   packed four to a 32-bit word, and the difference of four byte pairs
//   summed into an accumulator by one instruction, PTX
//   `vabsdiff4.u32.u32.u32.add`, which sm_90a runs as one SASS
//   VABSDIFF4.U8.ACC at 64 a clock an SM, the CUDA programming guide's
//   rate (__vsadu4 adds an IADD3; max - min + dp4a is a sequence of
//   several instructions). The bound is a quarter of the differences over
//   that rate: 0.52 ms at 1080p on 132 SMs at 1.98 GHz. A
//   thread owns a 4 dy x 4 dx tile of offsets (16 accumulators) and walks
//   the block by word columns: it keeps the four byte-shifted words of
//   four consecutive area rows in registers
//   (two aligned word loads and three funnel shifts a new row; the shifts
//   run on another pipe than VABSDIFF4), so one new
//   area row and one block word (four rows of a column in one 16-byte
//   load from a transposed copy) feed 16 VABSDIFF4: about 0.35 issued
//   instructions a difference, against 3.5 for the scalar sweep.
// - float path (every sample in [0, M] with h * w * M < 2^24: 14 bits at
//   32 x 32, 12 at 64 x 64): s += fabsf(a - b) is two FADDs on the
//   full-width float32 pipes (|t| is an operand modifier), exact because
//   every partial sum is an integer below 2^24. The same 4 x 4 tile, four
//   columns at a time: two 16-byte loads a new area row, one for the block.
//   Bound: 2 operations a difference at 67 T/s. (vabsdiff2, the packed
//   16-bit form, is not one instruction on sm_90a.)
// - int32 path (anything else: negative or wider samples, other shapes):
//   the scalar sweep, one area sample in a register for four vertically
//   adjacent offsets, with int32 wrap as the reference has.
//
// Staging reads the area from global memory as the 8-bit layout while every
// thread ORs its samples (four int32 or int16 samples a load where the rows
// are aligned for it); only when the vote rejects it is the area read a
// second time (mostly from L2) into the float or int32 layout. The dynamic
// shared memory covers the widest layout the launch may need (the float
// one, 111 KB at 32 x 32, R = 64: two thread blocks of 384 threads an SM,
// full_search's 1 KB of rates after it included); uint8 planes take the
// 8-bit path at compile time and need only 28 KB.
// uint8 windows may start at any byte: each word is two aligned word loads
// and a funnel shift, never reaching past the plane.
//
// The rate: bits = mv_bits(4 (mv_min_y + dy) - pred_qy) +
// mv_bits(4 (mv_min_x + dx) - pred_qx) is separable, so a thread block
// stages the ny + nx terms once in shared memory and a position's cost is
// two shared loads, an add, a multiply, a shift and an add; its first
// minimum in row-major (dy, dx) order (reference compareSAD strict '<') is
// a running minimum a thread and one block reduction. The thread whose own
// minimum wins writes the results, the SAD from its registers.
//
// full_search: the table kernel's work (0.52 ms of VABSDIFF4 at 8 bits at
// 1080p) plus about 8 integer operations a position (0.004 ms at 67 T/s);
// it writes no 136 MB table and reads none back.
//
// sad_cost_argmin: bytes-bound, one read of the [N, ny, nx] table (136 MB
// at 1080p: 0.041 ms at 3.35 TB/s). Each thread keeps four 16-byte loads
// in flight (a scalar head and tail cover a block's table, which starts at
// n ny nx ints and so is 16-byte aligned only when that is a multiple of
// 4) and walks its positions by a stepped (dy, dx), without a division.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;       // sad_cost_argmin, the probe
constexpr int kSweepThreads = 384;  // the table kernels: 3 x 384 = 1152
                                    // slots for the 1089 tiles at R = 64
// largest exact float32 integer sum bound: h * w * max sample < 2^24
constexpr int kF32Exact = (1 << 24) - 1;

// Visits (y, x) over a rows x cols grid in row-major order, threads
// striding by blockDim.x, without a division per item.
template <class F>
__device__ __forceinline__ void for_grid(int rows, int cols, F f) {
  const int sy = blockDim.x / cols, sx = blockDim.x - sy * cols;
  int y = threadIdx.x / cols, x = threadIdx.x - y * cols;
  while (y < rows) {
    f(y, x);
    x += sx;
    y += sy;
    if (x >= cols) {
      x -= cols;
      ++y;
    }
  }
}

// Samples of a row-major array with row stride `stride`, as int.
template <typename T>
struct Rows {
  const T* p;
  long long stride;
  __device__ __forceinline__ int operator()(int y, int x) const {
    return static_cast<int>(p[y * stride + x]);
  }
  // whether every row's groups of four at multiples of 4 are aligned for
  // one vector load (16 bytes of int32, 8 of int16)
  __device__ __forceinline__ bool vec() const {
    return sizeof(T) > 1 && (stride & 3) == 0 &&
           (reinterpret_cast<uintptr_t>(p) & (4 * sizeof(T) - 1)) == 0;
  }
  // samples x .. x + 3 of row y (x a multiple of 4); only the first n are
  // read, the others are 0. One vector load when vec() and n == 4.
  __device__ __forceinline__ int4 quad(int y, int x, int n, bool v) const {
    const T* q = p + y * stride + x;
    if constexpr (sizeof(T) == 4) {
      if (v && n == 4) return *reinterpret_cast<const int4*>(q);
    } else if constexpr (sizeof(T) == 2) {
      if (v && n == 4) {
        const uint2 u = *reinterpret_cast<const uint2*>(q);
        return int4{static_cast<T>(u.x & 0xffff), static_cast<T>(u.x >> 16),
                    static_cast<T>(u.y & 0xffff), static_cast<T>(u.y >> 16)};
      }
    }
    return int4{n > 0 ? static_cast<int>(q[0]) : 0,
                n > 1 ? static_cast<int>(q[1]) : 0,
                n > 2 ? static_cast<int>(q[2]) : 0,
                n > 3 ? static_cast<int>(q[3]) : 0};
  }
};

// the low bytes of four samples as one word, the first lowest
__device__ __forceinline__ uint32_t pack4(int4 s) {
  return (s.x & 0xff) | (s.y & 0xff) << 8 | (s.z & 0xff) << 16 |
         static_cast<uint32_t>(s.w & 0xff) << 24;
}

// The four bytes at p .. p + 3 (any alignment) as one little-endian word:
// two aligned word loads and a funnel shift; the second load is skipped
// when p is aligned, so no byte outside [p, p + 4) is read from a word
// that holds none of them.
__device__ __forceinline__ uint32_t load4(const uint8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint32_t* w =
      reinterpret_cast<const uint32_t*>(a & ~static_cast<uintptr_t>(3));
  const unsigned sh = static_cast<unsigned>(a & 3) * 8;
  return __funnelshift_r(__ldg(w), __ldg(w + (sh != 0)), sh);
}

// sum of |a_k - b_k| over the four byte pairs, plus c: one VABSDIFF4
__device__ __forceinline__ uint32_t vabsdiff4_acc(uint32_t a, uint32_t b,
                                                  uint32_t c) {
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(c));
  return d;
}

// Shared-memory geometry of one search block: area rows ah (the real
// ah_in = h + ny - 1 rounded up so that every 4-row tile of offsets reads
// zero rows past it), area width aw, and the tile columns tnx = ceil(nx/4).
struct Geom {
  int h, w, ny, nx, aw, ah, ah_in, tnx;
  __host__ __device__ Geom(int h_, int w_, int ny_, int nx_)
      : h(h_), w(w_), ny(ny_), nx(nx_), aw(w_ + nx_ - 1),
        ah(((ny_ + 3) & ~3) + h_ - 1), ah_in(h_ + ny_ - 1),
        tnx((nx_ + 3) >> 2) {}
  // the 8-bit and float sweeps need h and w to be multiples of 4
  __host__ __device__ bool packable() const { return ((h | w) & 3) == 0; }
  // 8-bit layout: area [ah][sw] words, then the block [w/4][h] words
  __host__ __device__ int sw() const { return tnx + (w >> 2); }
  __host__ __device__ int blk8() const { return (ah * sw() + 3) & ~3; }
  // float layout: area [ah][sfw], then the block [h][w]
  __host__ __device__ int sfw() const { return 4 * tnx + w; }
  __host__ __device__ size_t bytes8() const {
    return (static_cast<size_t>(blk8()) + (h * w >> 2)) * 4;
  }
  __host__ __device__ size_t bytes_wide() const {
    const size_t i32 = static_cast<size_t>(ah) * aw + h * w;
    const size_t f32 = static_cast<size_t>(ah) * sfw() + h * w;
    return (i32 > f32 ? i32 : f32) * 4;
  }
};

// Dynamic shared memory of a table kernel: the widest layout it may take
// (`wide`: the samples' range is known only after staging), or the 8-bit
// one alone.
__host__ __device__ inline size_t sweep_smem(const Geom& g, bool wide) {
  if (!g.packable()) return g.bytes_wide();
  const size_t b8 = g.bytes8();
  if (!wide) return b8;
  const size_t bw = g.bytes_wide();
  return bw > b8 ? bw : b8;
}

// ---- staging ------------------------------------------------------------

// The 8-bit layout from int16 or int32 samples: area word (y, q) holds
// samples 4q .. 4q + 3 of row y (low byte first; zero past aw and past
// ah_in), block word (j4, i) samples 4 j4 .. 4 j4 + 3 of block row i.
// Returns the OR of every sample this thread read (not 8-bit iff a bit
// above 7 is set).
template <class Src>
__device__ __forceinline__ int stage_u8(const Geom& g, Src area, Src blk,
                                        uint32_t* sa, uint32_t* sbt) {
  int o = 0;
  const int sw = g.sw();
  const bool av = area.vec(), bv = blk.vec();
  for_grid(g.ah, sw, [&](int y, int q) {
    uint32_t v = 0;
    const int n = min(4, g.aw - 4 * q);
    if (y < g.ah_in && n > 0) {
      const int4 s = area.quad(y, 4 * q, n, av);
      o |= s.x | s.y | s.z | s.w;
      v = pack4(s);
    }
    sa[y * sw + q] = v;
  });
  for_grid(g.w >> 2, g.h, [&](int j4, int i) {
    const int4 s = blk.quad(i, 4 * j4, 4, bv);
    o |= s.x | s.y | s.z | s.w;
    sbt[j4 * g.h + i] = pack4(s);
  });
  return o;
}

// The 8-bit layout straight from uint8 planes (rows at any byte offset):
// whole words by load4, the last partial word of a row from a load that
// ends at the row's last byte, shifted down.
__device__ __forceinline__ void stage_u8_bytes(const Geom& g,
                                               Rows<uint8_t> area,
                                               Rows<uint8_t> blk,
                                               uint32_t* sa, uint32_t* sbt) {
  const int sw = g.sw();
  for_grid(g.ah, sw, [&](int y, int q) {
    uint32_t v = 0;
    const int x = 4 * q;
    if (y < g.ah_in && x < g.aw) {
      const uint8_t* row = area.p + y * area.stride;
      if (x + 4 <= g.aw)
        v = load4(row + x);
      else  // g.aw >= w >= 4
        v = load4(row + g.aw - 4) >> (8 * (x + 4 - g.aw));
    }
    sa[y * sw + q] = v;
  });
  for_grid(g.w >> 2, g.h, [&](int j4, int i) {
    sbt[j4 * g.h + i] = load4(blk.p + i * blk.stride + 4 * j4);
  });
}

// The float layout: area [ah][sfw] (zero past aw and ah_in), block [h][w],
// four samples a thread and step, stored as one float4.
template <class Src>
__device__ __forceinline__ void stage_f32(const Geom& g, Src area, Src blk,
                                          float* sa, float* sb) {
  const int sfw = g.sfw();
  const bool av = area.vec(), bv = blk.vec();
  auto f4 = [](int4 s) {
    return float4{static_cast<float>(s.x), static_cast<float>(s.y),
                  static_cast<float>(s.z), static_cast<float>(s.w)};
  };
  for_grid(g.ah, sfw >> 2, [&](int y, int q) {
    const int n = min(4, g.aw - 4 * q);
    const int4 s = y < g.ah_in && n > 0 ? area.quad(y, 4 * q, n, av)
                                        : int4{0, 0, 0, 0};
    *reinterpret_cast<float4*>(sa + y * sfw + 4 * q) = f4(s);
  });
  for_grid(g.h, g.w >> 2, [&](int i, int q) {
    *reinterpret_cast<float4*>(sb + i * g.w + 4 * q) =
        f4(blk.quad(i, 4 * q, 4, bv));
  });
}

// The int32 layout: area [ah][aw] (rows past ah_in zero), block [h][w].
template <class Src>
__device__ __forceinline__ void stage_i32(const Geom& g, Src area, Src blk,
                                          int* sa, int* sb) {
  for_grid(g.ah, g.aw, [&](int y, int x) {
    sa[y * g.aw + x] = y < g.ah_in ? area(y, x) : 0;
  });
  for_grid(g.h, g.w, [&](int i, int j) { sb[i * g.w + j] = blk(i, j); });
}

// ---- sweeps: emit(dy, dx, sad) for every dy < ny, dx < nx ----------------

// 8-bit: a thread's tile is offsets (4ty + t, 4tx + k), t, k < 4. R[m & 3]
// holds the four words of area row 4ty + m starting at bytes 4(tx + j4) + k.
template <class Emit>
__device__ __forceinline__ void sweep_u8(const Geom& g, const uint32_t* sa,
                                         const uint32_t* sbt, Emit emit) {
  const int sw = g.sw();
  const int items = g.tnx * ((g.ny + 3) >> 2);
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int ty = it / g.tnx, tx = it - ty * g.tnx;
    uint32_t acc[4][4] = {};
    for (int j4 = 0; j4 < (g.w >> 2); ++j4) {
      const uint32_t* col = sa + 4 * ty * sw + tx + j4;
      const uint4* bcol = reinterpret_cast<const uint4*>(sbt + j4 * g.h);
      uint32_t R[4][4];
      auto row = [&](uint32_t* d, int r) {
        const uint32_t w0 = col[r * sw], w1 = col[r * sw + 1];
        d[0] = w0;
        d[1] = __funnelshift_r(w0, w1, 8);
        d[2] = __funnelshift_r(w0, w1, 16);
        d[3] = __funnelshift_r(w0, w1, 24);
      };
      row(R[0], 0);
      row(R[1], 1);
      row(R[2], 2);
      for (int i = 0; i < g.h; i += 4) {
        const uint4 b4 = bcol[i >> 2];
        const uint32_t b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          row(R[(u + 3) & 3], i + u + 3);
#pragma unroll
          for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int k = 0; k < 4; ++k)
              acc[t][k] = vabsdiff4_acc(R[(u + t) & 3][k], b[u], acc[t][k]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * ty + t < g.ny && 4 * tx + k < g.nx)
          emit(4 * ty + t, 4 * tx + k, static_cast<int>(acc[t][k]));
  }
}

// float: the same tile, four block columns (4 jc .. 4 jc + 3) at a time;
// R[m & 3] holds area row 4ty + m, columns 4(tx + jc) .. + 7.
template <class Emit>
__device__ __forceinline__ void sweep_f32(const Geom& g, const float* sa,
                                          const float* sb, Emit emit) {
  const int sfw = g.sfw();
  const int items = g.tnx * ((g.ny + 3) >> 2);
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int ty = it / g.tnx, tx = it - ty * g.tnx;
    float acc[4][4] = {};
    for (int jc = 0; jc < (g.w >> 2); ++jc) {
      const float* col = sa + 4 * ty * sfw + 4 * (tx + jc);
      float R[4][8];
      auto row = [&](float* d, int r) {
        const float4 p = *reinterpret_cast<const float4*>(col + r * sfw);
        const float4 q = *reinterpret_cast<const float4*>(col + r * sfw + 4);
        d[0] = p.x, d[1] = p.y, d[2] = p.z, d[3] = p.w;
        d[4] = q.x, d[5] = q.y, d[6] = q.z, d[7] = q.w;
      };
      row(R[0], 0);
      row(R[1], 1);
      row(R[2], 2);
      for (int i = 0; i < g.h; i += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          row(R[(u + 3) & 3], i + u + 3);
          const float4 b4 =
              *reinterpret_cast<const float4*>(sb + (i + u) * g.w + 4 * jc);
          const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
              for (int m = 0; m < 4; ++m)
                acc[t][k] += fabsf(R[(u + t) & 3][k + m] - b[m]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * ty + t < g.ny && 4 * tx + k < g.nx)
          emit(4 * ty + t, 4 * tx + k, static_cast<int>(acc[t][k]));
  }
}

// int32: sa is the [ah][aw] area, sb the [h][w] block; one area sample in a
// register serves four vertically adjacent offsets.
template <class Emit>
__device__ __forceinline__ void sweep_i32(const Geom& g, const int* sa,
                                          const int* sb, Emit emit) {
  const int h = g.h, w = g.w, ny = g.ny, nx = g.nx, aw = g.aw;
  const int items = nx * (((ny + 3) & ~3) >> 2);
  for (int t = threadIdx.x; t < items; t += blockDim.x) {
    const int dx = t % nx;
    const int dy0 = (t / nx) << 2;
    int s0 = 0, s1 = 0, s2 = 0, s3 = 0;
    for (int j = 0; j < w; ++j) {
      const int* col = sa + dy0 * aw + dx + j;
      int a0 = col[0], a1 = col[aw], a2 = col[2 * aw];
      for (int i = 0; i < h; ++i) {
        const int a3 = col[(i + 3) * aw];
        const int b = sb[i * w + j];
        s0 += abs(a0 - b);
        s1 += abs(a1 - b);
        s2 += abs(a2 - b);
        s3 += abs(a3 - b);
        a0 = a1;
        a1 = a2;
        a2 = a3;
      }
    }
    const int s[4] = {s0, s1, s2, s3};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (dy0 + k < ny) emit(dy0 + k, dx, s[k]);
  }
}

// One search block: stage, choose the path by two votes over the staged
// samples (uniform across the thread block), sweep. Every thread reaches
// every barrier.
template <class Src, class Emit>
__device__ __forceinline__ void sad_block(const Geom& g, Src area, Src blk,
                                          unsigned char* smem, Emit emit) {
  if (g.packable()) {
    uint32_t* sa8 = reinterpret_cast<uint32_t*>(smem);
    uint32_t* sb8 = sa8 + g.blk8();
    const int o = stage_u8(g, area, blk, sa8, sb8);
    if (!__syncthreads_or(o & ~0xff)) {
      sweep_u8(g, sa8, sb8, emit);
      return;
    }
    if (!__syncthreads_or(o < 0 || o > kF32Exact / (g.h * g.w))) {
      float* saf = reinterpret_cast<float*>(smem);
      float* sbf = saf + g.ah * g.sfw();
      stage_f32(g, area, blk, saf, sbf);
      __syncthreads();
      sweep_f32(g, saf, sbf, emit);
      return;
    }
  }
  int* sai = reinterpret_cast<int*>(smem);
  int* sbi = sai + g.ah * g.aw;
  stage_i32(g, area, blk, sai, sbi);
  __syncthreads();
  sweep_i32(g, sai, sbi, emit);
}

// A planes search block: uint8 planes take the 8-bit path without a vote.
template <typename T, class Emit>
__device__ __forceinline__ void planes_block(const Geom& g, Rows<T> area,
                                             Rows<T> blk, unsigned char* smem,
                                             Emit emit) {
  if constexpr (std::is_same<T, uint8_t>::value) {
    if (g.packable()) {
      uint32_t* sa8 = reinterpret_cast<uint32_t*>(smem);
      uint32_t* sb8 = sa8 + g.blk8();
      stage_u8_bytes(g, area, blk, sa8, sb8);
      __syncthreads();
      sweep_u8(g, sa8, sb8, emit);
      return;
    }
  }
  sad_block(g, area, blk, smem, emit);
}

__global__ void __launch_bounds__(kSweepThreads, 2)
sad_table_kernel(const int* __restrict__ blks, const int* __restrict__ areas,
                 int* __restrict__ out, int h, int w, int ny, int nx) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Geom g(h, w, ny, nx);
  const long long n = blockIdx.x;
  const Rows<int> area{areas + n * g.ah_in * static_cast<long long>(g.aw),
                       g.aw};
  const Rows<int> blk{blks + n * h * static_cast<long long>(w), w};
  int* o = out + n * ny * static_cast<long long>(nx);
  sad_block(g, area, blk, smem,
            [&](int dy, int dx, int s) { o[dy * nx + dx] = s; });
}

// Block n = blockIdx.x of the aligned size x size grid (nxb blocks a row)
// and its (2r + size)^2 window in the planes.
template <typename T>
__device__ __forceinline__ void plane_sources(
    const T* __restrict__ ref, long long ref_stride, const T* __restrict__ org,
    long long org_stride, int size, int r, int nxb, int pad, Rows<T>& area,
    Rows<T>& blk) {
  const int n = blockIdx.x;
  const int by = n / nxb, bx = n - by * nxb;
  area = Rows<T>{ref + static_cast<long long>(pad - r + by * size) *
                           ref_stride + (pad - r + bx * size),
                 ref_stride};
  blk = Rows<T>{org + static_cast<long long>(by * size) * org_stride +
                    bx * size,
                org_stride};
}

template <typename T>
__global__ void __launch_bounds__(kSweepThreads, 2)
sad_planes_kernel(const T* __restrict__ ref, long long ref_stride,
                  const T* __restrict__ org, long long org_stride,
                  int* __restrict__ out, int size, int r, int nxb, int n_real,
                  int pad) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nyx = 2 * r + 1;
  const Geom g(size, size, nyx, nyx);
  const int n = blockIdx.x;
  int* o = out + static_cast<long long>(n) * nyx * nyx;
  if (n >= n_real) {  // bucket padding: a zero table
    for (int k = threadIdx.x; k < nyx * nyx; k += blockDim.x) o[k] = 0;
    return;
  }
  Rows<T> area, blk;
  plane_sources(ref, ref_stride, org, org_stride, size, r, nxb, pad, area,
                blk);
  planes_block(g, area, blk, smem,
               [&](int dy, int dx, int s) { o[dy * nyx + dx] = s; });
}

template <typename T>
__global__ void __launch_bounds__(kSweepThreads, 2)
me_planes_kernel(const T* __restrict__ ref, long long ref_stride,
                 const T* __restrict__ org, long long org_stride,
                 const int* __restrict__ bits, int lam_fp, int size, int r,
                 int nxb, int n_real, int pad, int* __restrict__ idx) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int scratch[64];
  const int nyx = 2 * r + 1;
  const Geom g(size, size, nyx, nyx);
  int best = 0x7fffffff, bi = 0x7fffffff;
  auto take = [&](int dy, int dx, int s) {
    const int p = dy * nyx + dx;
    argmin_take(best, bi, add_wrap(s, mul_wrap(lam_fp, bits[p]) >> 16), p);
  };
  const int n = blockIdx.x;
  if (n >= n_real) {  // bucket padding: SAD 0, the rate alone
    for (int p = threadIdx.x; p < nyx * nyx; p += blockDim.x)
      take(p / nyx, p - (p / nyx) * nyx, 0);
  } else {
    Rows<T> area, blk;
    plane_sources(ref, ref_stride, org, org_stride, size, r, nxb, pad, area,
                  blk);
    planes_block(g, area, blk, smem, take);
  }
  block_argmin(best, bi, scratch);
  if (threadIdx.x == 0) idx[n] = bi;
}

// ---- cost + first-minimum argmin ----------------------------------------

// The rate bits of every row and column offset of search block n:
// rates[dy] = mv_bits(4 (mv_min_y + dy) - pred_qy) for dy < ny, then
// rates[ny + dx] likewise in x; int32 wrap, as XLA computes them.
__device__ __forceinline__ void stage_rates(int ny, int nx, int my, int mx,
                                            int py, int px, int* rates) {
  for (int k = threadIdx.x; k < ny + nx; k += blockDim.x) {
    const bool row = k < ny;
    const unsigned m = row ? my : mx, q = row ? py : px;
    const unsigned o = row ? k : k - ny;
    rates[k] = mv_bits(static_cast<int>((m + o) * 4u - q));
  }
}

// A thread's running first minimum of the cost over the positions it
// visits, with the SAD there.
struct BestCost {
  int cost = 0x7fffffff, idx = 0x7fffffff, sad = 0;
  __device__ __forceinline__ void take(int c, int p, int s) {
    if (c < cost || (c == cost && p < idx)) {
      cost = c;
      idx = p;
      sad = s;
    }
  }
};

// The block's first minimum; the thread that holds it writes the four
// results of search block n. Every thread of the block calls this.
__device__ __forceinline__ void write_winner(
    const BestCost& b, int* scratch, int n, int nx, int my, int mx,
    int* __restrict__ mv_y, int* __restrict__ mv_x, int* __restrict__ cost,
    int* __restrict__ sad) {
  int v = b.cost, i = b.idx;
  block_argmin(v, i, scratch);
  if (i == b.idx) {  // positions are unique to a thread: exactly one
    const int dy = i / nx;
    mv_y[n] = add_wrap(my, dy);
    mv_x[n] = add_wrap(mx, i - dy * nx);
    cost[n] = v;
    sad[n] = b.sad;
  }
}

__global__ void __launch_bounds__(kSweepThreads, 2)
full_search_kernel(const int* __restrict__ blks, const int* __restrict__ areas,
                   const int* __restrict__ mv_min_y,
                   const int* __restrict__ mv_min_x,
                   const int* __restrict__ pred_qy,
                   const int* __restrict__ pred_qx, int lam_fp, int h, int w,
                   int ny, int nx, int* __restrict__ mv_y,
                   int* __restrict__ mv_x, int* __restrict__ cost,
                   int* __restrict__ sad) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int scratch[64];
  const Geom g(h, w, ny, nx);
  const int n = blockIdx.x;
  const Rows<int> area{
      areas + static_cast<long long>(n) * g.ah_in * g.aw, g.aw};
  const Rows<int> blk{blks + static_cast<long long>(n) * h * w, w};
  const int my = mv_min_y[n], mx = mv_min_x[n];
  // past every sweep layout; sad_block's first barrier orders these
  // stores before the sweep reads them
  int* rates = reinterpret_cast<int*>(smem + sweep_smem(g, true));
  stage_rates(ny, nx, my, mx, pred_qy[n], pred_qx[n], rates);
  BestCost b;
  sad_block(g, area, blk, smem, [&](int dy, int dx, int s) {
    b.take(add_wrap(s, mul_wrap(lam_fp, rates[dy] + rates[ny + dx]) >> 16),
           dy * nx + dx, s);
  });
  write_winner(b, scratch, n, nx, my, mx, mv_y, mv_x, cost, sad);
}

// 16-byte loads a thread keeps in flight in sad_cost_argmin
constexpr int kCostLoads = 4;

__global__ void __launch_bounds__(kThreads)
sad_cost_argmin_kernel(const int* __restrict__ sads,
                       const int* __restrict__ mv_min_y,
                       const int* __restrict__ mv_min_x,
                       const int* __restrict__ pred_qy,
                       const int* __restrict__ pred_qx, int lam_fp, int ny,
                       int nx, int* __restrict__ mv_y, int* __restrict__ mv_x,
                       int* __restrict__ cost_out, int* __restrict__ sad_out) {
  extern __shared__ int rates[];  // [ny + nx]
  __shared__ int scratch[64];
  const int n = blockIdx.x;
  const int npos = ny * nx;
  const int* s = sads + static_cast<long long>(n) * npos;
  const int my = mv_min_y[n], mx = mv_min_x[n];
  stage_rates(ny, nx, my, mx, pred_qy[n], pred_qx[n], rates);
  __syncthreads();
  BestCost b;
  auto take = [&](int p, int dy, int dx, int sad) {
    b.take(add_wrap(sad, mul_wrap(lam_fp, rates[dy] + rates[ny + dx]) >> 16),
           p, sad);
  };
  // positions before the table's first 16-byte boundary, and after its
  // last: at most three each, one thread a position
  const int head =
      min(npos,
          static_cast<int>((16 - (reinterpret_cast<uintptr_t>(s) & 15)) & 15)
              >> 2);
  const int nvec = (npos - head) >> 2;
  const int tail = head + 4 * nvec;
  const int t = threadIdx.x;
  const int pe = t < 4 ? t : tail + t - 4;
  if (t < 4 ? t < head : pe < npos) {
    const int dy = pe / nx;
    take(pe, dy, pe - dy * nx, s[pe]);
  }
  // the body: vector k holds positions head + 4k .. + 3; a thread takes
  // k = t, t + B, ... (B threads), kCostLoads of them loaded at once
  const int4* v = reinterpret_cast<const int4*>(s + head);
  const int step = 4 * blockDim.x;  // positions between a thread's vectors
  const int sy = step / nx, sx = step - sy * nx;
  int p = head + 4 * t;
  int dy = p / nx, dx = p - dy * nx;
  for (int k = t; k < nvec; k += kCostLoads * blockDim.x) {
    int4 q[kCostLoads];
#pragma unroll
    for (int u = 0; u < kCostLoads; ++u)
      q[u] = k + u * blockDim.x < nvec ? __ldg(v + k + u * blockDim.x)
                                       : int4{0, 0, 0, 0};
#pragma unroll
    for (int u = 0; u < kCostLoads; ++u) {
      if (k + u * blockDim.x < nvec) {
        const int e[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
        int y = dy, x = dx;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          take(p + j, y, x, e[j]);
          if (++x == nx) {
            x = 0;
            ++y;
          }
        }
      }
      p += step;
      dx += sx;
      dy += sy;
      if (dx >= nx) {
        dx -= nx;
        ++dy;
      }
    }
  }
  write_winner(b, scratch, n, nx, my, mx, mv_y, mv_x, cost_out, sad_out);
}

// The rate probe of the 8-bit path's instruction: 16 independent
// VABSDIFF4 accumulations a thread and iteration, nothing else in the loop
// but its counter and one add. chip_smoke.py prints its rate beside the
// published one that the 8-bit bound divides by.
__global__ void __launch_bounds__(kThreads)
vabsdiff4_probe_kernel(uint32_t* __restrict__ out, int iters) {
  uint32_t a[16], s[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    a[k] = (threadIdx.x + 1u) * (2654435761u + 40503u * k);
    s[k] = 0;
  }
  uint32_t b = blockIdx.x * 0x9e3779b9u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 16; ++k) s[k] = vabsdiff4_acc(a[k], b, s[k]);
    b += 0x01010101u;
  }
  uint32_t r = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) r += s[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = r;
}

}  // namespace

extern "C" int hevc_sad_table(const void* blks, const void* areas, void* out,
                              int n, int h, int w, int ny, int nx,
                              void* stream) {
  const size_t smem = sweep_smem(Geom(h, w, ny, nx), true);
  cudaError_t e = allow_smem(sad_table_kernel, smem);
  if (e != cudaSuccess) return e;
  if (n > 0)
    sad_table_kernel<<<n, kSweepThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(blks), static_cast<const int*>(areas),
        static_cast<int*>(out), h, w, ny, nx);
  return cudaGetLastError();
}

extern "C" int hevc_sad_cost_argmin(const void* sads, const void* mv_min_y,
                                    const void* mv_min_x, const void* pred_qy,
                                    const void* pred_qx, int lam_fp, int n,
                                    int ny, int nx, void* mv_y, void* mv_x,
                                    void* cost, void* sad, void* stream) {
  const size_t smem = (static_cast<size_t>(ny) + nx) * sizeof(int);
  cudaError_t e = allow_smem(sad_cost_argmin_kernel, smem);
  if (e != cudaSuccess) return e;
  if (n > 0)
    sad_cost_argmin_kernel<<<n, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(sads), static_cast<const int*>(mv_min_y),
        static_cast<const int*>(mv_min_x), static_cast<const int*>(pred_qy),
        static_cast<const int*>(pred_qx), lam_fp, ny, nx,
        static_cast<int*>(mv_y), static_cast<int*>(mv_x),
        static_cast<int*>(cost), static_cast<int*>(sad));
  return cudaGetLastError();
}

// blks [n, h, w] and areas [n, h+ny-1, w+nx-1] int32; mv_min_y/x and
// pred_qy/qx [n] int32; outputs mv_y, mv_x, cost, sad [n] int32.
extern "C" int hevc_full_search(const void* blks, const void* areas,
                                const void* mv_min_y, const void* mv_min_x,
                                const void* pred_qy, const void* pred_qx,
                                int lam_fp, int n, int h, int w, int ny,
                                int nx, void* mv_y, void* mv_x, void* cost,
                                void* sad, void* stream) {
  const size_t smem = sweep_smem(Geom(h, w, ny, nx), true) +
                      (static_cast<size_t>(ny) + nx) * sizeof(int);
  cudaError_t e = allow_smem(full_search_kernel, smem);
  if (e != cudaSuccess) return e;
  if (n > 0)
    full_search_kernel<<<n, kSweepThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(blks), static_cast<const int*>(areas),
        static_cast<const int*>(mv_min_y), static_cast<const int*>(mv_min_x),
        static_cast<const int*>(pred_qy), static_cast<const int*>(pred_qx),
        lam_fp, h, w, ny, nx, static_cast<int*>(mv_y),
        static_cast<int*>(mv_x), static_cast<int*>(cost),
        static_cast<int*>(sad));
  return cudaGetLastError();
}

// out: [blocks * 256] uint32; 16 * iters VABSDIFF4 a thread.
extern "C" int hevc_vabsdiff4_probe(void* out, int blocks, int iters,
                                    void* stream) {
  if (blocks > 0)
    vabsdiff4_probe_kernel<<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint32_t*>(out), iters);
  return cudaGetLastError();
}

namespace {

template <typename T>
int launch_sad_planes(const void* ref, long long ref_stride, const void* org,
                      long long org_stride, void* out, int size, int r,
                      int ny, int nx, int pad, int bucket,
                      cudaStream_t stream) {
  const int nyx = 2 * r + 1;
  const size_t smem = sweep_smem(Geom(size, size, nyx, nyx),
                                 !std::is_same<T, uint8_t>::value);
  cudaError_t e = allow_smem(sad_planes_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  if (bucket > 0)
    sad_planes_kernel<T><<<bucket, kSweepThreads, smem, stream>>>(
        static_cast<const T*>(ref), ref_stride, static_cast<const T*>(org),
        org_stride, static_cast<int*>(out), size, r, nx, ny * nx, pad);
  return cudaGetLastError();
}

template <typename T>
int launch_me_planes(const void* ref, long long ref_stride, const void* org,
                     long long org_stride, const void* bits, int lam_fp,
                     void* idx, int size, int r, int ny, int nx, int pad,
                     int bucket, cudaStream_t stream) {
  const int nyx = 2 * r + 1;
  const size_t smem = sweep_smem(Geom(size, size, nyx, nyx),
                                 !std::is_same<T, uint8_t>::value);
  cudaError_t e = allow_smem(me_planes_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  if (bucket > 0)
    me_planes_kernel<T><<<bucket, kSweepThreads, smem, stream>>>(
        static_cast<const T*>(ref), ref_stride, static_cast<const T*>(org),
        org_stride, static_cast<const int*>(bits), lam_fp, size, r, nx,
        ny * nx, pad, static_cast<int*>(idx));
  return cudaGetLastError();
}

}  // namespace

// ref_padded and orig share one sample type, `sample`: 0 = uint8,
// 1 = int16, 2 = int32; each is row-major with unit column stride.
// out: [bucket, 2r+1, 2r+1] int32.
extern "C" int hevc_sad_table_planes(const void* ref, long long ref_stride,
                                     const void* org, long long org_stride,
                                     int sample, void* out, int size, int r,
                                     int ny, int nx, int pad, int bucket,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (sample) {
    case 0:
      return launch_sad_planes<uint8_t>(ref, ref_stride, org, org_stride, out,
                                        size, r, ny, nx, pad, bucket, s);
    case 1:
      return launch_sad_planes<int16_t>(ref, ref_stride, org, org_stride, out,
                                        size, r, ny, nx, pad, bucket, s);
    case 2:
      return launch_sad_planes<int32_t>(ref, ref_stride, org, org_stride, out,
                                        size, r, ny, nx, pad, bucket, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// bits: [2r+1, 2r+1] int32; idx: [bucket] int32 first-minimum indices.
extern "C" int hevc_me_planes(const void* ref, long long ref_stride,
                              const void* org, long long org_stride,
                              int sample, const void* bits, int lam_fp,
                              void* idx, int size, int r, int ny, int nx,
                              int pad, int bucket, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (sample) {
    case 0:
      return launch_me_planes<uint8_t>(ref, ref_stride, org, org_stride, bits,
                                       lam_fp, idx, size, r, ny, nx, pad,
                                       bucket, s);
    case 1:
      return launch_me_planes<int16_t>(ref, ref_stride, org, org_stride, bits,
                                       lam_fp, idx, size, r, ny, nx, pad,
                                       bucket, s);
    case 2:
      return launch_me_planes<int32_t>(ref, ref_stride, org, org_stride, bits,
                                       lam_fp, idx, size, r, ny, nx, pad,
                                       bucket, s);
    default:
      return cudaErrorInvalidValue;
  }
}
