// Causal softmax attention, forward, float32, for Hopper (sm_90a).
//
// Replaces the TPU kernel that emo_disentanger_tpu/models/gpt2.py:68-79 calls
// for its deterministic full-window forwards (GPT-2 eval, decode prefill and
// window re-anchor): the library flash_attention of
// jax/experimental/pallas/ops/tpu/flash_attention.py (flash_attention :140 ->
// _flash_attention_kernel :331, pallas_call :758), with causal=True,
// sm_scale = 1/sqrt(Dh) and f32 q, k, v  ->  flash_attn_fwd_kernel.
//
// Function, per (batch, head) row, q/k/v/o [L, Dh] f32:
//   o_i = sum_{j<=i} exp(s_ij - m_i) v_j / sum_{j<=i} exp(s_ij - m_i),
//   s_ij = sm_scale * q_i . k_j,   m_i = max_{j<=i} s_ij.
//
// Bound on the H100: the causal products q k^T and p v take 4 Dh L(L+1)/2
// flop per row, all f32 (67 TFLOP/s outside the tensor cores), against
// 4 L Dh floats of traffic.  At the re-anchor shape (B=16, H=8, L=2048,
// Dh=64) that is 68.7 GFLOP, ~1.03 ms, against 268 MB, ~0.08 ms: the kernel
// is bounded by operations.
//
// Design (simple first): one block of 256 threads per (row, 64-query tile),
// 1-d grid.  The block keeps its q tile in shared memory and walks the key
// tiles 0..its own, so the tiles above the diagonal are never touched; only
// the diagonal tile is masked.  Per key tile it stages k (transposed) and v
// in shared memory, each thread computes a 4 x 4 micro-tile of the scores
// with f32 FMAs from float4 reads (one of q rows, one of k columns per
// depth step), updates the online-softmax running max and sum of its four
// rows in registers (a 16-lane shuffle reduces each row), rescales its
// 4 x 4 slice of the output accumulator, and writes its probabilities
// transposed to shared memory for the p v product.  The output is divided
// by the running sum once, at the end.  Query tiles are handed out longest
// first (the first blocks take the last tiles, which loop over the most key
// tiles), so the causal imbalance does not leave SMs idle at the tail.
// Shared memory: 67 KB a block, three blocks an SM.  No tensor cores (TF32
// would change the f32 results), TMA or pipelining yet.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int T = 64;           // query rows and keys per tile
constexpr int D = 64;           // head width, the only one taken
constexpr int P = T + 4;        // row pitch of a transposed tile (float4-aligned)
constexpr int THREADS = 256;    // 16 x 16 threads, a 4 x 4 micro-tile each
constexpr size_t SMEM_BYTES = sizeof(float) * (2 * D * P + T * P + T * D);

// src [T][D] row-major -> dst[d * P + r].  Lanes take consecutive rows, so the
// shared-memory stores are conflict free; each lane reads 16 bytes.
__device__ __forceinline__ void load_transposed(float* __restrict__ dst,
                                                const float* __restrict__ src, int tid) {
#pragma unroll
  for (int i = 0; i < T * D / 4 / THREADS; ++i) {
    const int idx = tid + i * THREADS, r = idx % T, c = (idx / T) * 4;
    const float4 f = *reinterpret_cast<const float4*>(src + r * D + c);
    dst[(c + 0) * P + r] = f.x;
    dst[(c + 1) * P + r] = f.y;
    dst[(c + 2) * P + r] = f.z;
    dst[(c + 3) * P + r] = f.w;
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(THREADS)
flash_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, int BH, int L,
                      float sm_scale) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // [D][P]  q tile, qt[d][r]
  float* kt = qt + D * P;                        // [D][P]  k tile, kt[d][c]
  float* pt = kt + D * P;                        // [T][P]  probabilities, pt[c][r]
  float* vs = pt + T * P;                        // [T][D]  v tile

  const int blk = blockIdx.x;
  const int qtile = L / T - 1 - blk / BH;  // longest first
  const int bh = blk % BH;
  const size_t row0 = (size_t)bh * L;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  load_transposed(qt, q + (row0 + (size_t)qtile * T) * D, tid);

  float acc[4][4], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int kb = 0; kb <= qtile; ++kb) {
    __syncthreads();                 // the previous tile's pt and vs are consumed
    const size_t t0 = (row0 + (size_t)kb * T) * D;
    load_transposed(kt, k + t0, tid);
    const float4* v4 = reinterpret_cast<const float4*>(v + t0);
    float4* vs4 = reinterpret_cast<float4*>(vs);
#pragma unroll
    for (int i = 0; i < T * D / 4 / THREADS; ++i) vs4[tid + i * THREADS] = v4[tid + i * THREADS];
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * P + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(kt + d * P + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    const bool diag = kb == qtile;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] *= sm_scale;
        if (diag && tx * 4 + j > ty * 4 + i) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // every row has an unmasked key in its first tile, so m_new is finite
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
        acc[i][j] *= alpha;
      }
      l[i] = l[i] * alpha + row_sum16(rs);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tx * 4 + j) * P + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < T; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(pt + c * P + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(vs + c * D + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.f / l[i];
    const size_t r = row0 + (size_t)qtile * T + ty * 4 + i;
    *reinterpret_cast<float4*>(o + r * D + tx * 4) =
        make_float4(acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv, acc[i][3] * inv);
  }
}

}  // namespace

extern "C" {

const char* emodis_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// q, k, v [BH, L, Dh] f32, contiguous, Dh == 64, L a positive multiple of 64
// -> o [BH, L, Dh] f32: causal softmax attention with scores sm_scale q.k.
int flash_attn_fwd(const float* q, const float* k, const float* v, float* o, int BH, int L,
                   int Dh, float sm_scale, void* stream) {
  if (Dh != D || L <= 0 || L % T || BH <= 0 || (long long)BH * (L / T) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  flash_attn_fwd_kernel<<<BH * (L / T), THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, o, BH, L, sm_scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
