// Helpers shared by the FAVOR+ kernels (favor_fwd.cu, favor_bwd.cu).
//
// Each .cu file builds into its own library, so these live in an anonymous
// namespace: every library gets its own copy.  ops/_build.py hashes this
// header with each source, so an edit here rebuilds both.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int C = 64;          // rows per chunk
constexpr int THREADS = 256;

template <class T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <class T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// a dot-product operand as the TPU kernel feeds it: bf16 under bf16 inputs
template <class T> __device__ __forceinline__ float rnd(float x) {
  return to_f<T>(from_f<T>(x));
}

// acc[r][c] += sum_k A(it + r*RT, k) * B(k, jt + c*NT)
// with A(i, k) = A[i*ai + k*ak] and B(k, j) = B[k*bk + j*bj] in shared memory.
template <class T, bool RA, bool RB>
__device__ __forceinline__ void mma4x4(float acc[4][4], const float* A, int ai, int ak,
                                       int it, int RT, const float* B, int bk, int bj,
                                       int jt, int NT, int K) {
  for (int k = 0; k < K; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[r] = A[(it + r * RT) * ai + k * ak];
      if (RA) a[r] = rnd<T>(a[r]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      b[c] = B[k * bk + (jt + c * NT) * bj];
      if (RB) b[c] = rnd<T>(b[c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

__device__ __forceinline__ void zero4x4(float acc[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Where row `row` = b * H + h of the batch*head rows starts in a tensor whose
// positions are `H * D` values apart: at (b L) (H D) + h D.  H = 1 is the
// head-major [BH, L, D] layout (row L D); H = n_head the heads-last
// [B, L, H * D] layout, whose head h is the D columns from h D.
__device__ __forceinline__ size_t row_base(int row, int H, int L, int D) {
  return (size_t)(row / H) * L * ((size_t)H * D) + (size_t)(row % H) * D;
}

// xs[i][d] = x[i * ld + d] * scale for i < n, 0 for the ragged tail; then
// sq[i] = ||xs_i||^2 / 2.
template <class T>
__device__ void load_scaled(float* xs, float* sq, const T* x, int n, int D, int ld,
                            float scale) {
  for (int idx = threadIdx.x; idx < C * D; idx += blockDim.x) {
    int i = idx / D, d = idx - i * D;
    xs[i * (D + 1) + d] = i < n ? to_f<T>(x[(size_t)i * ld + d]) * scale : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(xs[i * (D + 1) + d], xs[i * (D + 1) + d], s);
    sq[i] = 0.5f * s;
  }
  __syncthreads();
}

// d^-1/4, rounded once from double as the reference computes it
float feature_scale(int Dh) { return (float)pow((double)Dh, -0.25); }

template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace
