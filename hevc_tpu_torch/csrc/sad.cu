// Full-search SAD tables and their lambda*mv-bits first-minimum argmin.
//
// Replaces: hevc_tpu/ops/sad_pallas.py `_sad_kernel` / `sad_table` (the
// Pallas TPU kernel), the XLA cost + argmin epilogue of
// hevc_tpu/ops/me.py `full_search_batch_pallas`, and the planes-in variants
// `sad_table_from_planes` / `me_from_planes` (sad_pallas.py).
//
// sad_table: out[n, dy, dx] = sum_{i<h, j<w} |area[n, dy+i, dx+j] - blk[n, i, j]|
// for int32 blocks [N, h, w] against their own int32 search areas
// [N, h+ny-1, w+nx-1]. One thread block per search block: the area
// (160 x 160 int32 = 100 KB at 32x32, R = 64) and the block go to shared
// memory once and every (dy, dx) reads them from there.
//
// What bounds it: operations. At the fallback path's 1080p shape (N = 2048,
// 32 x 32, 129 x 129 offsets) the table is 34.9 G abs-differences against
// 136 MB of output; each difference is a sub + abs + add on the int32 ALUs,
// and a shared-memory load. The design keeps each loaded area sample in a
// register for four vertically adjacent offsets (a sliding window down the
// block column), so one shared load and one broadcast block load feed four
// accumulators. Threads of a warp take neighbouring dx, i.e. neighbouring
// words of a row: no bank conflicts. No tensor-core path exists for |a-b|.
//
// sad_cost_argmin: cost = sad + (lam_fp * bits) >> 16 over the table with
// bits = mv_bits(4*mv_y - pred_qy) + mv_bits(4*mv_x - pred_qx), then the
// first minimum in row-major (dy, dx) order per block (reference compareSAD
// strict '<'). It reads the table once: bytes-bound, small next to the SAD.
//
// sad_table_planes / me_planes: the same sweep, with each thread block
// reading its block and its (2r + size)^2 window straight from the two
// planes (uint8, int16 or int32 samples) into shared memory. The reference
// materialised every window as an [N, aw, aw] int32 tensor first (210 MB at
// 1080p); here only the planes are read. Block k = by * nx + bx takes the
// window whose top-left is (pad - r + by * size, pad - r + bx * size) of
// the padded reference. Rows of the power-of-two bucket past ny * nx are a
// zero block against a zero window: SAD 0. me_planes fuses the sweep with
// cost = sad + ((lam_fp * bits) >> 16) (int32 wrap) and the block-wide
// first-minimum argmin, writing one index per block and no table.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// The SAD sweep shared by the table kernels: sa is the [ah][aw] search
// area (rows past the real area zero, ah = ceil4(ny) + h - 1), sb the
// [h][w] block, both in shared memory; emit(dy, dx, sad) gets every
// offset with dy < ny, dx < nx.
template <class Emit>
__device__ __forceinline__ void sad_sweep(const int* sa, const int* sb, int h,
                                          int w, int ny, int nx, Emit emit) {
  const int aw = w + nx - 1;
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

// Shared-memory bytes of the sweep's area and block (int32).
inline size_t sweep_smem(int h, int w, int ny, int nx) {
  const int ny4 = (ny + 3) & ~3;
  return (static_cast<size_t>(ny4 + h - 1) * (w + nx - 1) + h * w) *
         sizeof(int);
}

__global__ void __launch_bounds__(kThreads)
sad_table_kernel(const int* __restrict__ blks, const int* __restrict__ areas,
                 int* __restrict__ out, int h, int w, int ny, int nx) {
  extern __shared__ int smem[];
  const int aw = w + nx - 1;
  const int ah_in = h + ny - 1;
  const int ah = ((ny + 3) & ~3) + h - 1;
  int* sa = smem;              // [ah][aw], rows past ah_in zero
  int* sb = smem + ah * aw;    // [h][w]
  const long long n = blockIdx.x;
  const int* ga = areas + n * ah_in * static_cast<long long>(aw);
  for (int k = threadIdx.x; k < ah * aw; k += blockDim.x)
    sa[k] = k < ah_in * aw ? ga[k] : 0;
  const int* gb = blks + n * h * static_cast<long long>(w);
  for (int k = threadIdx.x; k < h * w; k += blockDim.x) sb[k] = gb[k];
  __syncthreads();

  int* o = out + n * ny * static_cast<long long>(nx);
  sad_sweep(sa, sb, h, w, ny, nx,
            [&](int dy, int dx, int s) { o[dy * nx + dx] = s; });
}

// Loads block n = blockIdx.x of the aligned size x size grid (nxb blocks
// a row) and its (2r + size)^2 window from the planes into the sweep's
// shared layout (sa rows past the window zero).
template <typename T>
__device__ __forceinline__ void load_planes(
    const T* __restrict__ ref, long long ref_stride, const T* __restrict__ org,
    long long org_stride, int size, int r, int nxb, int pad, int* sa,
    int* sb) {
  const int aw = 2 * r + size;
  const int ah = ((2 * r + 1 + 3) & ~3) + size - 1;
  const int n = blockIdx.x;
  const int by = n / nxb, bx = n - (n / nxb) * nxb;
  const T* ga = ref + static_cast<long long>(pad - r + by * size) * ref_stride +
                (pad - r + bx * size);
  for (int k = threadIdx.x; k < ah * aw; k += blockDim.x) {
    const int y = k / aw, x = k - (k / aw) * aw;
    sa[k] = y < aw ? static_cast<int>(ga[y * ref_stride + x]) : 0;
  }
  const T* gb =
      org + static_cast<long long>(by * size) * org_stride + bx * size;
  for (int k = threadIdx.x; k < size * size; k += blockDim.x) {
    const int y = k / size, x = k - (k / size) * size;
    sb[k] = static_cast<int>(gb[y * org_stride + x]);
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sad_planes_kernel(const T* __restrict__ ref, long long ref_stride,
                  const T* __restrict__ org, long long org_stride,
                  int* __restrict__ out, int size, int r, int nxb, int n_real,
                  int pad) {
  extern __shared__ int smem[];
  const int nyx = 2 * r + 1;
  int* sa = smem;
  int* sb = smem + (((nyx + 3) & ~3) + size - 1) * (2 * r + size);
  const int n = blockIdx.x;
  int* o = out + static_cast<long long>(n) * nyx * nyx;
  if (n >= n_real) {  // bucket padding: a zero table
    for (int k = threadIdx.x; k < nyx * nyx; k += blockDim.x) o[k] = 0;
    return;
  }
  load_planes(ref, ref_stride, org, org_stride, size, r, nxb, pad, sa, sb);
  sad_sweep(sa, sb, size, size, nyx, nyx,
            [&](int dy, int dx, int s) { o[dy * nyx + dx] = s; });
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
me_planes_kernel(const T* __restrict__ ref, long long ref_stride,
                 const T* __restrict__ org, long long org_stride,
                 const int* __restrict__ bits, int lam_fp, int size, int r,
                 int nxb, int n_real, int pad, int* __restrict__ idx) {
  extern __shared__ int smem[];
  __shared__ int scratch[64];
  const int nyx = 2 * r + 1;
  int* sa = smem;
  int* sb = smem + (((nyx + 3) & ~3) + size - 1) * (2 * r + size);
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
    load_planes(ref, ref_stride, org, org_stride, size, r, nxb, pad, sa, sb);
    sad_sweep(sa, sb, size, size, nyx, nyx, take);
  }
  block_argmin(best, bi, scratch);
  if (threadIdx.x == 0) idx[n] = bi;
}

__global__ void __launch_bounds__(kThreads)
sad_cost_argmin_kernel(const int* __restrict__ sads,
                       const int* __restrict__ mv_min_y,
                       const int* __restrict__ mv_min_x,
                       const int* __restrict__ pred_qy,
                       const int* __restrict__ pred_qx, int lam_fp, int ny,
                       int nx, int* __restrict__ mv_y, int* __restrict__ mv_x,
                       int* __restrict__ cost_out, int* __restrict__ sad_out) {
  __shared__ int scratch[64];
  const int n = blockIdx.x;
  const int npos = ny * nx;
  const int* s = sads + static_cast<long long>(n) * npos;
  const int my = mv_min_y[n], mx = mv_min_x[n];
  const int py = pred_qy[n], px = pred_qx[n];
  int best = 0x7fffffff, bi = 0x7fffffff;
  for (int p = threadIdx.x; p < npos; p += blockDim.x) {
    const int dy = p / nx, dx = p - (p / nx) * nx;
    const int bits =
        mv_bits(4 * (my + dy) - py) + mv_bits(4 * (mx + dx) - px);
    argmin_take(best, bi, s[p] + (mul_wrap(lam_fp, bits) >> 16), p);
  }
  block_argmin(best, bi, scratch);
  if (threadIdx.x == 0) {
    mv_y[n] = my + bi / nx;
    mv_x[n] = mx + bi % nx;
    cost_out[n] = best;
    sad_out[n] = s[bi];
  }
}

}  // namespace

extern "C" int hevc_sad_table(const void* blks, const void* areas, void* out,
                              int n, int h, int w, int ny, int nx,
                              void* stream) {
  const size_t smem = sweep_smem(h, w, ny, nx);
  cudaError_t e = allow_smem(sad_table_kernel, smem);
  if (e != cudaSuccess) return e;
  if (n > 0)
    sad_table_kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(blks), static_cast<const int*>(areas),
        static_cast<int*>(out), h, w, ny, nx);
  return cudaGetLastError();
}

extern "C" int hevc_sad_cost_argmin(const void* sads, const void* mv_min_y,
                                    const void* mv_min_x, const void* pred_qy,
                                    const void* pred_qx, int lam_fp, int n,
                                    int ny, int nx, void* mv_y, void* mv_x,
                                    void* cost, void* sad, void* stream) {
  if (n > 0)
    sad_cost_argmin_kernel<<<n, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(sads), static_cast<const int*>(mv_min_y),
        static_cast<const int*>(mv_min_x), static_cast<const int*>(pred_qy),
        static_cast<const int*>(pred_qx), lam_fp, ny, nx,
        static_cast<int*>(mv_y), static_cast<int*>(mv_x),
        static_cast<int*>(cost), static_cast<int*>(sad));
  return cudaGetLastError();
}

namespace {

template <typename T>
int launch_sad_planes(const void* ref, long long ref_stride, const void* org,
                      long long org_stride, void* out, int size, int r,
                      int ny, int nx, int pad, int bucket,
                      cudaStream_t stream) {
  const int nyx = 2 * r + 1;
  const size_t smem = sweep_smem(size, size, nyx, nyx);
  cudaError_t e = allow_smem(sad_planes_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  if (bucket > 0)
    sad_planes_kernel<T><<<bucket, kThreads, smem, stream>>>(
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
  const size_t smem = sweep_smem(size, size, nyx, nyx);
  cudaError_t e = allow_smem(me_planes_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  if (bucket > 0)
    me_planes_kernel<T><<<bucket, kThreads, smem, stream>>>(
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
