// Shared device helpers of the hevc_tpu_torch kernels.
#pragma once

#include <cuda_runtime.h>

// Exp-Golomb-style signed MV component length (reference TComRdCost bit
// counting; hevc_tpu/ops/me.py mv_bits): t = -2v+1 for v <= 0, 2v else,
// bits = 2 * floor(log2 t) + 1.
__device__ __forceinline__ int mv_bits(int v) {
  const unsigned t = v <= 0 ? (static_cast<unsigned>(-v) << 1) + 1u
                            : static_cast<unsigned>(v) << 1;
  return 2 * (31 - __clz(t)) + 1;
}

// int32 product with two's-complement wrap, as XLA's int32 multiply.
__device__ __forceinline__ int mul_wrap(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// int32 sum with two's-complement wrap, as XLA's int32 add.
__device__ __forceinline__ int add_wrap(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// (value, index) pair minimum; equal values keep the smaller index, so a
// reduction returns the first minimum in index order (jnp.argmin's rule).
__device__ __forceinline__ void argmin_take(int& v, int& i, int ov, int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// Block-wide first-minimum reduction; every thread gets the result.
// `scratch` holds 2 * 32 ints of shared memory. blockDim.x % 32 == 0.
__device__ __forceinline__ void block_argmin(int& v, int& i, int* scratch) {
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    argmin_take(v, i, ov, oi);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  __syncthreads();  // scratch may still be read by a previous reduction
  if (lane == 0) {
    scratch[warp] = v;
    scratch[32 + warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < nwarps ? scratch[lane] : 0x7fffffff;
    i = lane < nwarps ? scratch[32 + lane] : 0x7fffffff;
    for (int off = 16; off > 0; off >>= 1) {
      const int ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, i, off);
      argmin_take(v, i, ov, oi);
    }
    if (lane == 0) {
      scratch[0] = v;
      scratch[32] = i;
    }
  }
  __syncthreads();
  v = scratch[0];
  i = scratch[32];
}

// Opt a kernel into more than 48 KB of dynamic shared memory when needed.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

extern "C" const char* hevc_kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
