// One Performer decode layer for one token per batch element, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _kernel of
// emo_disentanger_tpu/ops/performer_decode.py:59 (via fused_decode_layer :154):
//   q, k, v = x Wq + bq, x Wk + bk, x Wv + bv            (per head, Dh = D / H)
//   phi_q   = exp(h(q) - max_m h(q)) / sqrt(M),  phi_k = mask * exp(h(k)) / sqrt(M)
//   S      += v phi_k^T,  z += phi_k                      (in place, 'dm' layout)
//   attn    = S phi_q / (phi_q . z + 1e-6)
//   x1      = x + attn Wo + bo;  y = LN1(x1)
//   out     = LN2(y + relu(y W1 + b1) W2 + b2)            (LayerNorm eps 1e-5)
// with f32 accumulation; the matrix operands are taken in the weights'
// stored dtype (bf16 serving weights round their activations to bf16), as
// the TPU kernel does.  S is carried as [B, H, Dh, M] f32 ('dm'), z as
// [B, H, M] f32.
//
// Bound on the H100: at serving batches the step moves the layer's weights
// once (3,145,728 parameters; 6.29 MB in bf16) and reads and writes S
// (B x 512 x 128 x 4 bytes each way, 4.19 MB at B = 16): ~14.7 MB, ~4.4 us
// at 3.35 TB/s.  Its ~0.1 GFLOP is negligible, so it is bounded by bytes.
//
// Design (simple first): seven launches on the caller's stream, each
// bandwidth-friendly on its own -- a GEMV with bias / ReLU / residual
// epilogue (one launch computes q, k and v; a warp owns 4 output rows and
// reads them once for 8 batch rows at a time, lanes striding the input
// dimension so weight reads coalesce), a per-(b, h) FAVOR state kernel
// (one thread per feature m, so the S read-modify-write is coalesced along
// M), and a residual LayerNorm kernel.  Intermediates (q, k, v, attn, x1, y,
// FF hidden) round-trip through a small scratch buffer the caller
// allocates.  Fusing the layer into one persistent launch is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int GEMV_THREADS = 256;
constexpr int ROWS = 4;    // output rows per warp
constexpr int BT = 8;      // batch rows per pass; ROWS * BT == 32 lanes
constexpr int LN_THREADS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <class T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// an activation as a matrix operand in the weights' dtype
template <class TW> __device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<TW>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// block-wide sum / max; red holds >= 32 floats; every thread gets the result
__device__ float block_sum(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = (blockDim.x + 31) >> 5;
  x = warp_sum(x);
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < nw ? red[lane] : 0.f;
  return warp_sum(x);
}

__device__ float block_max(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = (blockDim.x + 31) >> 5;
  x = warp_max(x);
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < nw ? red[lane] : -INFINITY;
  return warp_max(x);
}

struct GemvJob {
  const void* W;       // [N, K] in TW (torch Linear layout)
  const void* bias;    // [N] in TW
  float* y;            // [B, N]
};
struct GemvJobs {
  GemvJob job[3];
};

// y[b][n] = act(sum_k rnd(x[b][k]) W[n][k] + bias[n]) (+ res[b][n]); blockIdx.y picks the job
template <class TW, class TX, class TR>
__global__ void gemv_kernel(GemvJobs jobs, const TX* __restrict__ x, const TR* __restrict__ res,
                            int B, int K, int N, int relu) {
  const GemvJob job = jobs.job[blockIdx.y];
  const TW* __restrict__ W = static_cast<const TW*>(job.W);
  const TW* __restrict__ bias = static_cast<const TW*>(job.bias);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = (blockIdx.x * (blockDim.x >> 5) + warp) * ROWS;
  if (n0 >= N) return;
  for (int b0 = 0; b0 < B; b0 += BT) {
    float acc[ROWS][BT];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int bb = 0; bb < BT; ++bb) acc[r][bb] = 0.f;
    for (int k = lane; k < K; k += 32) {
      float w[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) w[r] = n0 + r < N ? to_f(W[(size_t)(n0 + r) * K + k]) : 0.f;
#pragma unroll
      for (int bb = 0; bb < BT; ++bb) {
        if (b0 + bb < B) {
          const float xv = rnd<TW>(to_f(x[(size_t)(b0 + bb) * K + k]));
#pragma unroll
          for (int r = 0; r < ROWS; ++r) acc[r][bb] = fmaf(w[r], xv, acc[r][bb]);
        }
      }
    }
    // after the xor reduction every lane holds every sum; lane r*BT+bb writes (r, bb)
    float mine = 0.f;
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int bb = 0; bb < BT; ++bb) {
        const float s = warp_sum(acc[r][bb]);
        if (lane == r * BT + bb) mine = s;
      }
    const int r = lane / BT, bb = lane % BT, n = n0 + r, b = b0 + bb;
    if (n < N && b < B) {
      float yv = mine + to_f(bias[n]);
      if (relu) yv = fmaxf(yv, 0.f);
      if (res) yv += to_f(res[(size_t)b * N + n]);
      job.y[(size_t)b * N + n] = yv;
    }
  }
}

// one block per (b, h), one thread per feature m
__global__ void favor_state_kernel(const float* __restrict__ qkv, const float* __restrict__ omega,
                                   const float* __restrict__ mask, float* __restrict__ S,
                                   float* __restrict__ z, float* __restrict__ attn, int B, int H,
                                   int Dh, int M, float scale, float rsqm, float eps) {
  extern __shared__ float smem[];
  float* xq = smem;                  // [Dh]
  float* xk = xq + Dh;               // [Dh]
  float* vh = xk + Dh;               // [Dh]
  float* red = vh + Dh;              // [32]
  float* part = red + 32;            // [M/32][Dh]
  const int b = blockIdx.x / H, h = blockIdx.x - b * H, D = H * Dh;
  const int m = threadIdx.x, lane = m & 31, warp = m >> 5;
  const float* q = qkv;
  const float* k = qkv + (size_t)B * D;
  const float* v = qkv + (size_t)2 * B * D;
  for (int d = m; d < Dh; d += blockDim.x) {
    xq[d] = q[(size_t)b * D + h * Dh + d] * scale;
    xk[d] = k[(size_t)b * D + h * Dh + d] * scale;
    vh[d] = v[(size_t)b * D + h * Dh + d];
  }
  __syncthreads();
  float sqq = 0.f, sqk = 0.f, uq = 0.f, uk = 0.f;
  for (int d = 0; d < Dh; ++d) {
    sqq = fmaf(xq[d], xq[d], sqq);
    sqk = fmaf(xk[d], xk[d], sqk);
    const float w = omega[d * M + m];
    uq = fmaf(xq[d], w, uq);
    uk = fmaf(xk[d], w, uk);
  }
  const float hq = uq - 0.5f * sqq;
  const float pq = expf(hq - block_max(hq, red)) * rsqm;
  const float pk = expf(uk - 0.5f * sqk) * rsqm * (mask ? mask[b] : 1.f);

  const size_t bh = (size_t)b * H + h;
  const float zn = z[bh * M + m] + pk;
  z[bh * M + m] = zn;
  const float den = block_sum(pq * zn, red);
  float* Sb = S + bh * Dh * M;
  for (int d = 0; d < Dh; ++d) {
    const float s = Sb[(size_t)d * M + m] + vh[d] * pk;
    Sb[(size_t)d * M + m] = s;
    const float p = warp_sum(pq * s);
    if (lane == 0) part[warp * Dh + d] = p;
  }
  __syncthreads();
  for (int d = m; d < Dh; d += blockDim.x) {
    float num = 0.f;
    for (int w = 0; w < (M >> 5); ++w) num += part[w * Dh + d];
    attn[(size_t)b * D + h * Dh + d] = num / (den + eps);
  }
}

// out[b] = LN(a[b]) * g + beta over D features
template <class TW, class TO>
__global__ void layernorm_kernel(const float* __restrict__ a, const TW* __restrict__ g,
                                 const TW* __restrict__ beta, TO* __restrict__ out, int D,
                                 float eps) {
  __shared__ float red[32];
  const float* row = a + (size_t)blockIdx.x * D;
  float s = 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) s += row[d];
  const float mu = block_sum(s, red) / D;
  float s2 = 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) s2 = fmaf(row[d] - mu, row[d] - mu, s2);
  const float inv = 1.f / sqrtf(block_sum(s2, red) / D + eps);
  for (int d = threadIdx.x; d < D; d += blockDim.x)
    out[(size_t)blockIdx.x * D + d] = from_f<TO>((row[d] - mu) * inv * to_f(g[d]) + to_f(beta[d]));
}

template <class TW, class TX, class TR>
void launch_gemv(const GemvJobs& jobs, int njobs, const void* x, const void* res, int B, int K,
                 int N, int relu, cudaStream_t s) {
  const int rows_per_block = (GEMV_THREADS / 32) * ROWS;
  dim3 grid((N + rows_per_block - 1) / rows_per_block, njobs);
  gemv_kernel<TW, TX, TR><<<grid, GEMV_THREADS, 0, s>>>(
      jobs, static_cast<const TX*>(x), static_cast<const TR*>(res), B, K, N, relu);
}

template <class TW>
void gemv(const GemvJobs& jobs, int njobs, const void* x, bool x_bf16, const void* res,
          bool res_bf16, int B, int K, int N, int relu, cudaStream_t s) {
  using bf = __nv_bfloat16;
  if (x_bf16) {
    if (res_bf16) launch_gemv<TW, bf, bf>(jobs, njobs, x, res, B, K, N, relu, s);
    else launch_gemv<TW, bf, float>(jobs, njobs, x, res, B, K, N, relu, s);
  } else {
    if (res_bf16) launch_gemv<TW, float, bf>(jobs, njobs, x, res, B, K, N, relu, s);
    else launch_gemv<TW, float, float>(jobs, njobs, x, res, B, K, N, relu, s);
  }
}

enum { WQ, BQ, WK, BK, WV, BV, WO, BO, W1, B1, W2, B2, G1, BE1, G2, BE2, NPARAM };

template <class TW>
int decode_layer(const void* x, bool x_bf16, const void* const* p, const float* omega,
                 const float* mask, float* S, float* z, void* out, float* scratch, int B, int D,
                 int H, int M, int F, float scale, float rsqm, float eps, float ln_eps,
                 cudaStream_t s) {
  using bf = __nv_bfloat16;
  const int Dh = D / H;
  float* qkv = scratch;                  // [3][B][D]
  float* attn = qkv + 3 * B * D;         // [B][D]
  float* x1 = attn + B * D;              // [B][D]
  float* y = x1 + B * D;                 // [B][D]
  float* h2 = y + B * D;                 // [B][D]
  float* h1 = h2 + B * D;                // [B][F]

  GemvJobs jobs = {{{p[WQ], p[BQ], qkv}, {p[WK], p[BK], qkv + B * D},
                    {p[WV], p[BV], qkv + 2 * B * D}}};
  gemv<TW>(jobs, 3, x, x_bf16, nullptr, false, B, D, D, 0, s);

  const size_t smem = sizeof(float) * (3 * Dh + 32 + (M / 32) * Dh);
  favor_state_kernel<<<B * H, M, smem, s>>>(qkv, omega, mask, S, z, attn, B, H, Dh, M, scale,
                                            rsqm, eps);

  jobs.job[0] = {p[WO], p[BO], x1};
  gemv<TW>(jobs, 1, attn, false, x, x_bf16, B, D, D, 0, s);
  layernorm_kernel<TW, float><<<B, LN_THREADS, 0, s>>>(
      x1, static_cast<const TW*>(p[G1]), static_cast<const TW*>(p[BE1]), y, D, ln_eps);

  jobs.job[0] = {p[W1], p[B1], h1};
  gemv<TW>(jobs, 1, y, false, nullptr, false, B, D, F, 1, s);
  jobs.job[0] = {p[W2], p[B2], h2};
  gemv<TW>(jobs, 1, h1, false, y, false, B, F, D, 0, s);
  if (x_bf16)
    layernorm_kernel<TW, bf><<<B, LN_THREADS, 0, s>>>(
        h2, static_cast<const TW*>(p[G2]), static_cast<const TW*>(p[BE2]),
        static_cast<bf*>(out), D, ln_eps);
  else
    layernorm_kernel<TW, float><<<B, LN_THREADS, 0, s>>>(
        h2, static_cast<const TW*>(p[G2]), static_cast<const TW*>(p[BE2]),
        static_cast<float*>(out), D, ln_eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* emodis_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// x [B, D] (f32, or bf16 when x_bf16); p: the 16 parameters in the order
// wq bq wk bk wv bv wo bo w1 b1 w2 b2 g1 be1 g2 be2, weights [out, in], all f32
// or all bf16 (w_bf16); omega [D/H, M] f32; mask [B] f32 or null (all ones);
// S [B, H, D/H, M] and z [B, H, M] f32, updated in place; out [B, D] in x's
// dtype; scratch B * (7 D + F) floats.
int performer_decode_layer(const void* x, int x_bf16, const void* const* p, int w_bf16,
                           const float* omega, const float* mask, float* S, float* z,
                           void* out, float* scratch, int B, int D, int H, int M, int F,
                           float eps, float ln_eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = (float)pow((double)(D / H), -0.25);
  const float rsqm = (float)(1.0 / sqrt((double)M));
  return w_bf16 ? decode_layer<__nv_bfloat16>(x, x_bf16, p, omega, mask, S, z, out, scratch, B,
                                               D, H, M, F, scale, rsqm, eps, ln_eps, s)
                : decode_layer<float>(x, x_bf16, p, omega, mask, S, z, out, scratch, B, D, H, M,
                                      F, scale, rsqm, eps, ln_eps, s);
}

}  // extern "C"
