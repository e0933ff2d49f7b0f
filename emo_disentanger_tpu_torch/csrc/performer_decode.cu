// One Performer decode layer for one token per batch element, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _kernel of
// emo_disentanger_tpu/ops/performer_decode.py:59 (via fused_decode_layer :154):
//   q, k, v = x Wq + bq, x Wk + bk, x Wv + bv            (per head, Dh = D / H)
//   phi_q   = exp(h(q) - max_m h(q)) / sqrt(M),  phi_k = mask * exp(h(k)) / sqrt(M)
//   S      += v phi_k^T,  z += phi_k                      (in place)
//   attn    = S phi_q / (phi_q . z + 1e-6)
//   x1      = x + attn Wo + bo;  y = LN1(x1)
//   out     = LN2(y + relu(y W1 + b1) W2 + b2)            (LayerNorm eps 1e-5)
// with f32 accumulation; the matrix operands are taken in the weights'
// stored dtype (bf16 serving weights round their activations to bf16), as
// the TPU kernel does.  S is carried in f32 as [B, H, Dh, M] ('dm') or
// [B, H, M, Dh] ('md', the TPU kernel's layout), z as [B, H, M] f32.
//
// Bound on the H100: at serving batches the step moves the layer's weights
// once (3,145,728 parameters; 6.29 MB in bf16) and reads and writes S
// (B x 512 x 128 x 4 bytes each way, 4.19 MB at B = 16): ~14.7 MB, ~4.4 us
// at 3.35 TB/s.  Its ~0.1 GFLOP is negligible, so it is bounded by bytes.
//
// Design: five launches on the caller's stream.
// * gemv_kernel (four launches: q/k/v together, Wo, W1, W2).  A block owns
//   8 output rows, split over its 8 warps along K, and launches start at
//   64 blocks (Wo, W2) and reach 256 (W1).  Each warp puts all its weight
//   loads in flight first (16 bytes a lane, L1 bypassed), then the block
//   stages the 16 batch rows of x in shared memory, rounded to the weights'
//   dtype, so the two latencies overlap.  Each lane's 16 bytes of one
//   weight row and the matching x values go to the tensor cores as the B
//   and A operands of mma.sync (bf16: m16n8k16; f32: m16n8k8 in 3xTF32 --
//   hi/lo split, hi*hi + hi*lo + lo*hi -- so f32 weights keep ~f32
//   accuracy).  The 16 batch rows are exactly one M tile.  The K order
//   inside a step is permuted the same way for both operands, so a lane's
//   16-byte load is its fragment as loaded.  The warps' partial sums are
//   reduced in shared memory in a fixed order, so results do not vary from
//   run to run; the epilogue adds the bias, ReLU and residual.  For Wo and
//   W2 the last block to finish (a __threadfence and an atomic counter,
//   which that block resets) applies LN1 or LN2 to the 16 rows, holding
//   each row in registers.  The FF hidden layer is stored in the weights'
//   dtype, the form W2 reads it in.
// * favor_state_kernel: one block per (b, h) of M x DS threads, DS of them
//   per feature m, each taking Dh / DS values of d: the features' dot
//   products are summed across the DS threads in shared memory, and the
//   S read-modify-write has all of a thread's d in flight at once.  S
//   phi_q is reduced along M through shared memory, with no dependent
//   shuffle chain.  The state's layout is a template parameter that only
//   moves S's index (d M + m in 'dm', coalesced along M; m Dh + d in 'md',
//   a stride of Dh across a warp's lanes): the arithmetic and its order are
//   the same, so an 'md' step is bit for bit the 'dm' step on the
//   transposed state.
// Intermediates (q, k, v, attn, x1, y, FF hidden) go through scratch the
// caller allocates (performer_decode_scratch_floats).  Batches above 16 run
// as chunks of 16 rows.
//
// Widths.  The designs above take D and F in whole 16-byte steps for the 8
// warps (multiples of 256 for bf16 weights, 128 for f32), K small enough
// for x in shared memory, N <= 1024 for the register LayerNorm and an
// (Dh, M) that state_split can place.  Every other width in the envelope
// (D = H Dh <= 2048, Dh <= 256, F <= 8192, 1 <= M <= 512) takes a tail
// form of the same launch, chosen per launch so that the aligned shapes
// run the code they ran before:
// * gemv_kernel<GEN>: K rounded up to the warps' steps, each lane's x
//   fragments read from global memory (no staging, so any K fits) and its
//   weight vector loaded whole where it lies inside the row on a 16-byte
//   boundary, else value by value with zeros past K; rows past N load
//   zeros and store nothing; ceil(N / 8) blocks a job.
// * layernorm_rows_loop for N > 1024: three passes over the row in global
//   memory (sum, squared deviations, output), a warp a row.
// * favor_state_gen: one block of 256 threads per (b, h) loops over the
//   features (a thread a feature, omega read along M) and then over d (a
//   warp a d, the lanes along M), for any (Dh, M).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;        // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int BM = 16;              // batch rows per M tile
constexpr int NT = 8;               // output rows per block (one n8 tile)
constexpr int U = 8;                // weight loads in flight per lane
constexpr int LN_PER = 32;          // LayerNorm values per lane: N <= 1024
constexpr int STATE_PER = 32;       // d per thread of the state kernel
constexpr int STATE_THREADS = 512;  // the state kernel's block, at most
constexpr int STATE_GEN_THREADS = 256;  // favor_state_gen's block
constexpr size_t GEMV_SMEM_MAX = 200 * 1024;  // x staged in shared memory up to this
// the envelope the entry point takes
constexpr int MAX_D = 2048, MAX_F = 8192, MAX_DH = 256, MAX_M = 512;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <class T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float load_act(const void* p, bool bf16, size_t i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
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

// a weight vector read once: bypass L1
__device__ __forceinline__ uint4 load_stream(const void* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B over 4 f32 values of K: A = {a0, a1, a2, a3} as the m16n8k8 A
// fragment, B = {b0, b1}; 3xTF32 (the lo*lo term, ~2^-22 relative, dropped)
__device__ __forceinline__ void mma_3xtf32(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint32_t b0, uint32_t b1) {
  const uint32_t a[4] = {a0, a1, a2, a3};
  uint32_t ah[4], al[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x = __uint_as_float(a[i]);
    ah[i] = tf32(x);
    al[i] = tf32(x - __uint_as_float(ah[i]));
  }
  const uint32_t bh0 = tf32(__uint_as_float(b0)), bh1 = tf32(__uint_as_float(b1));
  const uint32_t bl0 = tf32(__uint_as_float(b0) - __uint_as_float(bh0));
  const uint32_t bl1 = tf32(__uint_as_float(b1) - __uint_as_float(bh1));
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// One step of 16 bytes of K per lane.  Lane (g = lane / 4, t = lane % 4)
// holds w = W[n0 + g][k + 4 t .. ] (16 bytes), x0 = x[g][same k], x8 =
// x[g + 8][same k].  The fragments' K slots are a permutation of these
// values, the same for A and B, so the products sum the right pairs.
template <class TW> struct Step;
template <> struct Step<__nv_bfloat16> {
  static constexpr int K = 32;   // 4 lanes x 8 bf16
  __device__ __forceinline__ static void run(float* d, uint4 x0, uint4 x8, uint4 w) {
    mma_bf16(d, x0.x, x8.x, x0.y, x8.y, w.x, w.y);
    mma_bf16(d, x0.z, x8.z, x0.w, x8.w, w.z, w.w);
  }
};
template <> struct Step<float> {
  static constexpr int K = 16;   // 4 lanes x 4 f32
  __device__ __forceinline__ static void run(float* d, uint4 x0, uint4 x8, uint4 w) {
    mma_3xtf32(d, x0.x, x8.x, x0.y, x8.y, w.x, w.y);
    mma_3xtf32(d, x0.z, x8.z, x0.w, x8.w, w.z, w.w);
  }
};

struct Gemv {
  const void* W[3];      // [N, K] in TW (torch Linear layout), one per job
  const void* bias[3];   // [N] in TW
  void* y[3];            // [B, N] f32, or TW when y_tw
  int njobs, K, N, B;
  const void* x;         // [B, K], f32 or bf16
  int x_bf16;
  const void* res;       // [B, N] residual or null
  int res_bf16, relu, y_tw;
  // LayerNorm of y[0] (f32) by the launch's last block (null: none)
  int* done_cnt;         // zero between launches
  const void* gamma;
  const void* beta;
  void* ln_out;          // [B, N] f32, or bf16 when ln_bf16
  int ln_bf16;
  float ln_eps;
};

// x [B, K] (f32 or bf16) -> xs [BM][pitch] in TW, rows from B on zero;
// 16-byte chunks of x (8 bf16 or 4 f32 values), SB of them a thread in flight
template <class TW>
__device__ void stage_x(TW* xs, const Gemv& p, int pitch) {
  constexpr int SB = 8;
  const int epc = p.x_bf16 ? 8 : 4;
  const int per_row = p.K / epc, total = BM * per_row;
  const char* x = static_cast<const char*>(p.x);
  for (int i0 = threadIdx.x; i0 < total; i0 += SB * THREADS) {
    uint4 raw[SB];
#pragma unroll
    for (int u = 0; u < SB; ++u) {
      const int i = i0 + u * THREADS, b = i / per_row;
      raw[u] = make_uint4(0, 0, 0, 0);
      if (i < total && b < p.B)
        raw[u] = *reinterpret_cast<const uint4*>(x + ((size_t)b * per_row + (i - b * per_row)) * 16);
    }
#pragma unroll
    for (int u = 0; u < SB; ++u) {
      const int i = i0 + u * THREADS, b = i / per_row;
      if (i >= total) break;
      const uint32_t w[4] = {raw[u].x, raw[u].y, raw[u].z, raw[u].w};
      float v[8];
      if (p.x_bf16) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[j]);
          v[2 * j] = __low2float(h);
          v[2 * j + 1] = __high2float(h);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = __uint_as_float(w[j]);
        v[4] = v[5] = v[6] = v[7] = 0.f;
      }
      TW* dst = xs + b * pitch + (i - b * per_row) * epc;
      if constexpr (sizeof(TW) == 2) {
        uint32_t o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
          o[j] = *reinterpret_cast<const uint32_t*>(&h);
        }
        if (epc == 8)
          *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
        else
          *reinterpret_cast<uint2*>(dst) = make_uint2(o[0], o[1]);
      } else {
        float4* f = reinterpret_cast<float4*>(dst);
        f[0] = make_float4(v[0], v[1], v[2], v[3]);
        if (epc == 8) f[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
  }
}

// the launch's LayerNorm: warp w takes rows w and w + 8, held in registers
template <class TW>
__device__ void layernorm_rows(const Gemv& p) {
  const TW* g = static_cast<const TW*>(p.gamma);
  const TW* be = static_cast<const TW*>(p.beta);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, N = p.N;
  const float* y = static_cast<const float*>(p.y[0]);
  float v[2][LN_PER], gv[LN_PER], bv[LN_PER];
#pragma unroll
  for (int i = 0; i < LN_PER; ++i) {
    const int n = lane + 32 * i;
    gv[i] = n < N ? to_f(g[n]) : 0.f;
    bv[i] = n < N ? to_f(be[n]) : 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int b = warp + r * WARPS;
      v[r][i] = b < p.B && n < N ? __ldcg(y + (size_t)b * N + n) : 0.f;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int b = warp + r * WARPS;
    if (b >= p.B) break;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < LN_PER; ++i) s += v[r][i];
    const float mu = warp_sum(s) / N;
    float s2 = 0.f;
#pragma unroll
    for (int i = 0; i < LN_PER; ++i)
      if (lane + 32 * i < N) s2 = fmaf(v[r][i] - mu, v[r][i] - mu, s2);
    const float inv = 1.f / sqrtf(warp_sum(s2) / N + p.ln_eps);
#pragma unroll
    for (int i = 0; i < LN_PER; ++i) {
      const int n = lane + 32 * i;
      if (n >= N) break;
      const float o = (v[r][i] - mu) * inv * gv[i] + bv[i];
      if (p.ln_bf16)
        static_cast<__nv_bfloat16*>(p.ln_out)[(size_t)b * N + n] = __float2bfloat16(o);
      else
        static_cast<float*>(p.ln_out)[(size_t)b * N + n] = o;
    }
  }
}

// the LayerNorm of layernorm_rows for N > 32 LN_PER: three passes over
// each row in global memory, warp w taking rows w and w + 8
template <class TW>
__device__ void layernorm_rows_loop(const Gemv& p) {
  const TW* g = static_cast<const TW*>(p.gamma);
  const TW* be = static_cast<const TW*>(p.beta);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, N = p.N;
  const float* y = static_cast<const float*>(p.y[0]);
  for (int b = warp; b < p.B; b += WARPS) {
    const float* yb = y + (size_t)b * N;
    float s = 0.f;
    for (int n = lane; n < N; n += 32) s += __ldcg(yb + n);
    const float mu = warp_sum(s) / N;
    float s2 = 0.f;
    for (int n = lane; n < N; n += 32) {
      const float d = __ldcg(yb + n) - mu;
      s2 = fmaf(d, d, s2);
    }
    const float inv = 1.f / sqrtf(warp_sum(s2) / N + p.ln_eps);
    for (int n = lane; n < N; n += 32) {
      const float o = (__ldcg(yb + n) - mu) * inv * to_f(g[n]) + to_f(be[n]);
      if (p.ln_bf16)
        static_cast<__nv_bfloat16*>(p.ln_out)[(size_t)b * N + n] = __float2bfloat16(o);
      else
        static_cast<float*>(p.ln_out)[(size_t)b * N + n] = o;
    }
  }
}

// 16 bytes of TW from EPV f32 values (bf16: rounded to nearest even, the
// first value in the low half, as stage_x stores them)
template <class TW>
__device__ __forceinline__ uint4 pack16(const float* v) {
  if constexpr (sizeof(TW) == 2) {
    uint32_t o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      o[j] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(o[0], o[1], o[2], o[3]);
  } else {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
}

// the tail form's A fragment: x[b][k .. k + EPV) rounded to TW, zero past
// K or for rows from B on
template <class TW>
__device__ __forceinline__ uint4 load_x_gen(const Gemv& p, int b, int k) {
  constexpr int EPV = 16 / sizeof(TW);
  float v[EPV];
#pragma unroll
  for (int e = 0; e < EPV; ++e)
    v[e] = b < p.B && k + e < p.K ? load_act(p.x, p.x_bf16, (size_t)b * p.K + k + e) : 0.f;
  return pack16<TW>(v);
}

// the tail form's B fragment: W[n][k .. k + EPV), one 16-byte load where
// it lies inside the row on a 16-byte boundary, else value by value with
// zeros past K; zeros for rows from N on
template <class TW>
__device__ __forceinline__ uint4 load_w_gen(const TW* W, int n, int k, int N, int K) {
  constexpr int EPV = 16 / sizeof(TW);
  if (n >= N) return make_uint4(0, 0, 0, 0);
  const TW* row = W + (size_t)n * K;
  if (K % EPV == 0 && k + EPV <= K) return load_stream(row + k);
  uint32_t o[4] = {0, 0, 0, 0};
  if constexpr (sizeof(TW) == 2) {
    const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
#pragma unroll
    for (int e = 0; e < EPV; ++e)
      if (k + e < K) o[e / 2] |= (uint32_t)r[k + e] << (16 * (e & 1));
  } else {
    const uint32_t* r = reinterpret_cast<const uint32_t*>(row);
#pragma unroll
    for (int e = 0; e < EPV; ++e)
      if (k + e < K) o[e] = r[k + e];
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// grid njobs * ceil(N / NT), THREADS threads.  LN: 0 none, 1 the register
// LayerNorm (N <= 32 LN_PER), 2 the looping one; p.done_cnt is set for
// both.  GEN: the tail form (note at the top), any K and N.
template <class TW, int LN, bool GEN>
__global__ void __launch_bounds__(THREADS) gemv_kernel(const Gemv p) {
  extern __shared__ uint4 smem_u4[];
  constexpr int EPV = 16 / sizeof(TW);   // elements per 16-byte vector
  constexpr int KSTEP = Step<TW>::K;
  __shared__ float red[WARPS][BM][NT];
  __shared__ int s_last;

  const int tiles_per_job = GEN ? (p.N + NT - 1) / NT : p.N / NT;
  const int tile = blockIdx.x;
  const int job = tile / tiles_per_job, n0 = (tile % tiles_per_job) * NT;
  const int pitch = p.K + EPV;           // +16 bytes a row: conflict-free reads
  TW* xs = reinterpret_cast<TW*>(smem_u4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // the tail form rounds K up to whole steps for the 8 warps
  const int KP = GEN ? (p.K + WARPS * KSTEP - 1) / (WARPS * KSTEP) * (WARPS * KSTEP) : p.K;
  const int KW = KP / WARPS, kw0 = warp * KW, steps = KW / KSTEP;
  const TW* W = static_cast<const TW*>(p.W[job]);
  const TW* wrow = W + (size_t)(n0 + g) * p.K + kw0 + EPV * t;
  const int kl = kw0 + EPV * t;          // the tail form's first k of this lane

  // threads < BM * NT own one output (b, n0 + n); its bias and residual,
  // and the first U weight vectors, are in flight while x is staged
  const int b = tid / NT, n = tid % NT, nn = n0 + n;
  const bool owner = tid < BM * NT && b < p.B && (!GEN || nn < p.N);
  float bias = 0.f, res = 0.f;
  if (owner) {
    bias = to_f(static_cast<const TW*>(p.bias[job])[nn]);
    if (p.res) res = load_act(p.res, p.res_bf16, (size_t)b * p.N + nn);
  }
  uint4 w[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (u < steps)
      w[u] = GEN ? load_w_gen<TW>(W, n0 + g, kl + u * KSTEP, p.N, p.K)
                 : load_stream(wrow + u * KSTEP);
  if constexpr (!GEN) {
    stage_x<TW>(xs, p, pitch);
    __syncthreads();
  }

  const TW* x0 = xs + g * pitch + kw0 + EPV * t;
  const TW* x8 = x0 + 8 * pitch;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s0 = 0; s0 < steps; s0 += U) {
    if (s0)
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (s0 + u < steps)
          w[u] = GEN ? load_w_gen<TW>(W, n0 + g, kl + (s0 + u) * KSTEP, p.N, p.K)
                     : load_stream(wrow + (s0 + u) * KSTEP);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (s0 + u < steps) {
        const int o = (s0 + u) * KSTEP;
        if constexpr (GEN)
          Step<TW>::run(acc, load_x_gen<TW>(p, g, kl + o), load_x_gen<TW>(p, g + 8, kl + o),
                        w[u]);
        else
          Step<TW>::run(acc, *reinterpret_cast<const uint4*>(x0 + o),
                        *reinterpret_cast<const uint4*>(x8 + o), w[u]);
      }
  }
  // C fragment: acc[0..1] = C[g][2t, 2t+1], acc[2..3] = C[g+8][2t, 2t+1]
  red[warp][g][2 * t] = acc[0];
  red[warp][g][2 * t + 1] = acc[1];
  red[warp][g + 8][2 * t] = acc[2];
  red[warp][g + 8][2 * t + 1] = acc[3];
  __syncthreads();

  if (owner) {
    float yv = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < WARPS; ++w8) yv += red[w8][b][n];
    yv += bias;
    if (p.relu) yv = fmaxf(yv, 0.f);
    yv += res;
    const size_t at = (size_t)b * p.N + nn;
    if (p.y_tw)
      static_cast<TW*>(p.y[job])[at] = from_f<TW>(yv);
    else
      static_cast<float*>(p.y[job])[at] = yv;
  }
  if constexpr (LN != 0) {
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(p.done_cnt, 1) == (int)gridDim.x - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    if constexpr (LN == 1)
      layernorm_rows<TW>(p);
    else
      layernorm_rows_loop<TW>(p);
    if (tid == 0) *p.done_cnt = 0;
  }
}

// S's offset of (d, m) inside one (b, h): 'dm' [Dh][M], 'md' [M][Dh]
template <bool MD>
__device__ __forceinline__ size_t state_at(int d, int m, int Dh, int M) {
  return MD ? (size_t)m * Dh + d : (size_t)d * M + m;
}

// one block per (b, h); thread (j, m) takes feature m and the d of
// {j, j + DS, ...}, DS = blockDim.x / M
template <bool MD>
__global__ void favor_state_kernel(const float* __restrict__ qkv, const float* __restrict__ omega,
                                   const float* __restrict__ mask, float* __restrict__ S,
                                   float* __restrict__ z, float* __restrict__ attn, int B, int H,
                                   int Dh, int M, float scale, float rsqm, float eps) {
  extern __shared__ float smem[];
  const int T = blockDim.x, DS = T / M, P = T / Dh;
  float* xq = smem;                  // [Dh]
  float* xk = xq + Dh;               // [Dh]
  float* vh = xk + Dh;               // [Dh]
  float* red = vh + Dh;              // [32]
  float* dots = red + 32;            // [4][DS][M]: uq, uk, |xq|^2, |xk|^2 partials
  float* prod = dots + 4 * T;        // [M][Dh + 1]: pq * S_new[d][m]
  float* part = prod + M * (Dh + 1); // [P][Dh]
  const int b = blockIdx.x / H, h = blockIdx.x - b * H, D = H * Dh;
  const int tid = threadIdx.x, m = tid % M, j = tid / M;
  const int nd = Dh / DS;            // this thread's d: j + DS * i, i < nd
  // the state's and omega's loads go out first, beside q, k and v's
  const size_t bh = (size_t)b * H + h;
  float* Sb = S + bh * Dh * M;
  float s[STATE_PER], om[STATE_PER];
#pragma unroll
  for (int i = 0; i < STATE_PER; ++i)
    if (i < nd) {
      s[i] = Sb[state_at<MD>(j + DS * i, m, Dh, M)];
      om[i] = omega[(j + DS * i) * M + m];
    }
  const float z0 = j == 0 ? z[bh * M + m] : 0.f;
  const float* q = qkv;
  const float* k = qkv + (size_t)B * D;
  const float* v = qkv + (size_t)2 * B * D;
  for (int d = tid; d < Dh; d += T) {
    xq[d] = q[(size_t)b * D + h * Dh + d] * scale;
    xk[d] = k[(size_t)b * D + h * Dh + d] * scale;
    vh[d] = v[(size_t)b * D + h * Dh + d];
  }
  __syncthreads();
  float sqq = 0.f, sqk = 0.f, uq = 0.f, uk = 0.f;
#pragma unroll
  for (int i = 0; i < STATE_PER; ++i) {
    if (i >= nd) break;
    const int d = j + DS * i;
    sqq = fmaf(xq[d], xq[d], sqq);
    sqk = fmaf(xk[d], xk[d], sqk);
    uq = fmaf(xq[d], om[i], uq);
    uk = fmaf(xk[d], om[i], uk);
  }
  dots[(0 * DS + j) * M + m] = uq;
  dots[(1 * DS + j) * M + m] = uk;
  dots[(2 * DS + j) * M + m] = sqq;
  dots[(3 * DS + j) * M + m] = sqk;
  __syncthreads();
  uq = uk = sqq = sqk = 0.f;
  for (int i = 0; i < DS; ++i) {
    uq += dots[(0 * DS + i) * M + m];
    uk += dots[(1 * DS + i) * M + m];
    sqq += dots[(2 * DS + i) * M + m];
    sqk += dots[(3 * DS + i) * M + m];
  }
  const float hq = uq - 0.5f * sqq;
  const float pq = expf(hq - block_max(hq, red)) * rsqm;
  // a masked row adds exactly 0 to S and z, so they keep their bits
  const float pk = expf(uk - 0.5f * sqk) * rsqm * (mask ? mask[b] : 1.f);

  float zn = 0.f;
  if (j == 0) {
    zn = z0 + pk;
    z[bh * M + m] = zn;
  }
  const float den = block_sum(pq * zn, red) + eps;
#pragma unroll
  for (int i = 0; i < STATE_PER; ++i) {
    if (i >= nd) break;
    const int d = j + DS * i;
    s[i] += vh[d] * pk;
    Sb[state_at<MD>(d, m, Dh, M)] = s[i];
    prod[m * (Dh + 1) + d] = pq * s[i];
  }
  __syncthreads();
  // attn[d] = sum_m prod[m][d] / den: thread (r, d) sums m = r, r + P, ...
  if (tid < P * Dh) {
    const int d = tid % Dh, r = tid / Dh;
    float acc = 0.f;
    for (int mm = r; mm < M; mm += P) acc += prod[mm * (Dh + 1) + d];
    part[r * Dh + d] = acc;
  }
  __syncthreads();
  if (tid < Dh) {
    float num = 0.f;
    for (int r = 0; r < P; ++r) num += part[r * Dh + tid];
    attn[(size_t)b * D + h * Dh + tid] = num / den;
  }
}

// favor_state_kernel's function for any (Dh, M): one block of
// STATE_GEN_THREADS per (b, h); a thread a feature m (its h(q), h(k) summed
// over d in order, omega read along M), then a warp a d (the lanes along M,
// S read, updated and written in either layout, S phi_q summed by the warp)
template <bool MD>
__global__ void favor_state_gen(const float* __restrict__ qkv, const float* __restrict__ omega,
                                const float* __restrict__ mask, float* __restrict__ S,
                                float* __restrict__ z, float* __restrict__ attn, int B, int H,
                                int Dh, int M, float scale, float rsqm, float eps) {
  extern __shared__ float smem[];
  float* xq = smem;                  // [Dh]
  float* xk = xq + Dh;               // [Dh]
  float* vh = xk + Dh;               // [Dh]
  float* pq = vh + Dh;               // [M]  h(q), then phi_q
  float* pk = pq + M;                // [M]  phi_k
  float* red = pk + M;               // [32]
  const int b = blockIdx.x / H, h = blockIdx.x - b * H, D = H * Dh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, T = blockDim.x;
  const size_t bh = (size_t)b * H + h;
  float* Sb = S + bh * Dh * M;
  const float* q = qkv;
  const float* k = qkv + (size_t)B * D;
  const float* v = qkv + (size_t)2 * B * D;
  for (int d = tid; d < Dh; d += T) {
    xq[d] = q[(size_t)b * D + h * Dh + d] * scale;
    xk[d] = k[(size_t)b * D + h * Dh + d] * scale;
    vh[d] = v[(size_t)b * D + h * Dh + d];
  }
  __syncthreads();
  float sqq = 0.f, sqk = 0.f;
  for (int d = 0; d < Dh; ++d) {
    sqq = fmaf(xq[d], xq[d], sqq);
    sqk = fmaf(xk[d], xk[d], sqk);
  }
  const float mk = mask ? mask[b] : 1.f;
  float mx = -INFINITY;
  for (int m = tid; m < M; m += T) {
    float uq = 0.f, uk = 0.f;
    for (int d = 0; d < Dh; ++d) {
      const float o = omega[(size_t)d * M + m];
      uq = fmaf(xq[d], o, uq);
      uk = fmaf(xk[d], o, uk);
    }
    const float hq = uq - 0.5f * sqq;
    pq[m] = hq;
    mx = fmaxf(mx, hq);
    // a masked row adds exactly 0 to S and z, so they keep their bits
    pk[m] = expf(uk - 0.5f * sqk) * rsqm * mk;
  }
  mx = block_max(mx, red);
  float part = 0.f;
  for (int m = tid; m < M; m += T) {
    const float p = expf(pq[m] - mx) * rsqm;
    pq[m] = p;
    const float zn = z[bh * M + m] + pk[m];
    z[bh * M + m] = zn;
    part = fmaf(p, zn, part);
  }
  const float den = block_sum(part, red) + eps;   // its barriers publish pq
  for (int d = warp; d < Dh; d += T >> 5) {
    const float vd = vh[d];
    float num = 0.f;
    for (int m = lane; m < M; m += 32) {
      float* sp = Sb + state_at<MD>(d, m, Dh, M);
      const float sn = *sp + vd * pk[m];
      *sp = sn;
      num = fmaf(pq[m], sn, num);
    }
    num = warp_sum(num);
    if (lane == 0) attn[(size_t)b * D + h * Dh + d] = num / den;
  }
}

template <class TW>
size_t gemv_smem(int K) {
  return sizeof(TW) * (size_t)BM * (K + 16 / sizeof(TW));
}

template <class TW, bool GEN>
cudaError_t launch_gemv_as(const Gemv& p, size_t smem, cudaStream_t s) {
  const auto kernel = !p.done_cnt ? gemv_kernel<TW, 0, GEN>
                      : p.N <= 32 * LN_PER ? gemv_kernel<TW, 1, GEN>
                                           : gemv_kernel<TW, 2, GEN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.njobs * ((p.N + NT - 1) / NT), THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

// the aligned design where K is whole steps for the 8 warps, N whole
// tiles and x fits in shared memory; the tail form otherwise
template <class TW>
cudaError_t launch_gemv(const Gemv& p, cudaStream_t s) {
  const size_t smem = gemv_smem<TW>(p.K);
  if (p.K % (Step<TW>::K * WARPS) || p.N % NT || smem > GEMV_SMEM_MAX)
    return launch_gemv_as<TW, true>(p, 0, s);
  return launch_gemv_as<TW, false>(p, smem, s);
}

// the state kernel's threads per feature: Dh / DS d each, at most
// STATE_PER, at most STATE_THREADS threads in all; 0 if none fits
int state_split(int Dh, int M) {
  for (int ds = 4; ds >= 1; ds /= 2)
    if (M * ds <= STATE_THREADS && Dh % ds == 0 && Dh / ds <= STATE_PER && M * ds >= Dh)
      return ds;
  return 0;
}

// favor_state_kernel's shapes: M a multiple of 16 in [32, 512] that
// state_split places; favor_state_gen takes the rest
bool state_aligned(int Dh, int M) {
  return M % 16 == 0 && M >= 32 && M <= STATE_THREADS && state_split(Dh, M);
}

enum { WQ, BQ, WK, BK, WV, BV, WO, BO, W1, B1, W2, B2, G1, BE1, G2, BE2, NPARAM };

// scratch floats: qkv 3 BM D, attn, x1, y, h2 BM D each, h1 BM F
size_t scratch_floats(int D, int F) { return (size_t)BM * (7 * D + F); }

template <class TW>
cudaError_t decode_chunk(const void* x, bool x_bf16, const void* const* p, const float* omega,
                         const float* mask, float* S, bool s_md, float* z, void* out,
                         float* scratch,
                         int* counters, int B, int D, int H, int M, int F, float scale,
                         float rsqm, float eps, float ln_eps, cudaStream_t s) {
  const int Dh = D / H;
  float* qkv = scratch;                   // [3][B][D]
  float* attn = qkv + 3 * BM * D;         // [B][D]
  float* x1 = attn + BM * D;              // [B][D]
  float* y = x1 + BM * D;                 // [B][D]
  float* h2 = y + BM * D;                 // [B][D]
  float* h1 = h2 + BM * D;                // [B][F] in TW

  Gemv g = {};
  g.B = B;
  g.njobs = 3;
  g.K = D;
  g.N = D;
  g.x = x;
  g.x_bf16 = x_bf16;
  const int wi[3] = {WQ, WK, WV};
  for (int j = 0; j < 3; ++j) {
    g.W[j] = p[wi[j]];
    g.bias[j] = p[wi[j] + 1];
    g.y[j] = qkv + (size_t)j * B * D;
  }
  cudaError_t err = launch_gemv<TW>(g, s);
  if (err != cudaSuccess) return err;

  if (state_aligned(Dh, M)) {
    const int T = M * state_split(Dh, M);
    const size_t smem = sizeof(float) * (3 * Dh + 32 + 4 * T + M * (Dh + 1) + (T / Dh) * Dh);
    const auto state_kernel = s_md ? favor_state_kernel<true> : favor_state_kernel<false>;
    err = cudaFuncSetAttribute(state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    state_kernel<<<B * H, T, smem, s>>>(qkv, omega, mask, S, z, attn, B, H, Dh, M, scale, rsqm,
                                        eps);
  } else {
    const size_t smem = sizeof(float) * (3 * Dh + 2 * M + 32);
    const auto state_kernel = s_md ? favor_state_gen<true> : favor_state_gen<false>;
    state_kernel<<<B * H, STATE_GEN_THREADS, smem, s>>>(qkv, omega, mask, S, z, attn, B, H, Dh,
                                                        M, scale, rsqm, eps);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // x1 = x + attn Wo + bo, then y = LN1(x1)
  Gemv o = {};
  o.B = B;
  o.njobs = 1;
  o.K = D;
  o.N = D;
  o.W[0] = p[WO];
  o.bias[0] = p[BO];
  o.y[0] = x1;
  o.x = attn;
  o.res = x;
  o.res_bf16 = x_bf16;
  o.done_cnt = counters;
  o.gamma = p[G1];
  o.beta = p[BE1];
  o.ln_out = y;
  o.ln_eps = ln_eps;
  if ((err = launch_gemv<TW>(o, s)) != cudaSuccess) return err;

  // h1 = relu(y W1 + b1), kept in TW
  Gemv f1 = {};
  f1.B = B;
  f1.njobs = 1;
  f1.K = D;
  f1.N = F;
  f1.W[0] = p[W1];
  f1.bias[0] = p[B1];
  f1.y[0] = h1;
  f1.y_tw = 1;
  f1.x = y;
  f1.relu = 1;
  if ((err = launch_gemv<TW>(f1, s)) != cudaSuccess) return err;

  // h2 = y + h1 W2 + b2, then out = LN2(h2)
  Gemv f2 = {};
  f2.B = B;
  f2.njobs = 1;
  f2.K = F;
  f2.N = D;
  f2.W[0] = p[W2];
  f2.bias[0] = p[B2];
  f2.y[0] = h2;
  f2.x = h1;
  f2.x_bf16 = sizeof(TW) == 2;
  f2.res = y;
  f2.done_cnt = counters + 1;
  f2.gamma = p[G2];
  f2.beta = p[BE2];
  f2.ln_out = out;
  f2.ln_bf16 = x_bf16;
  f2.ln_eps = ln_eps;
  return launch_gemv<TW>(f2, s);
}

template <class TW>
int decode_layer(const void* x, bool x_bf16, const void* const* p, const float* omega,
                 const float* mask, float* S, bool s_md, float* z, void* out, float* scratch,
                 int* counters,
                 int B, int D, int H, int M, int F, float eps, float ln_eps, cudaStream_t s) {
  const float scale = (float)pow((double)(D / H), -0.25);
  const float rsqm = (float)(1.0 / sqrt((double)M));
  const size_t xb = x_bf16 ? 2 : 4;
  for (int b0 = 0; b0 < B; b0 += BM) {
    const int nb = B - b0 < BM ? B - b0 : BM;
    const size_t sb = (size_t)b0 * H;
    cudaError_t err = decode_chunk<TW>(
        static_cast<const char*>(x) + b0 * D * xb, x_bf16, p, omega, mask ? mask + b0 : nullptr,
        S + sb * (D / H) * M, s_md, z + sb * M, static_cast<char*>(out) + b0 * D * xb, scratch,
        counters, nb, D, H, M, F, scale, rsqm, eps, ln_eps, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

const char* emodis_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Floats of scratch and ints of zeroed counters that performer_decode_layer
// needs for weights of this shape (any batch, either dtype).
int performer_decode_scratch_floats(int D, int F) { return (int)scratch_floats(D, F); }
int performer_decode_counter_ints() { return 2; }

// x [B, D] (f32, or bf16 when x_bf16); p: the 16 parameters in the order
// wq bq wk bk wv bv wo bo w1 b1 w2 b2 g1 be1 g2 be2, weights [out, in], all f32
// or all bf16 (w_bf16); omega [D/H, M] f32; mask [B] f32 or null (all ones);
// S [B, H, D/H, M] ('dm'; [B, H, M, D/H] 'md' when s_md) and z [B, H, M] f32,
// updated in place; out [B, D] in x's
// dtype; scratch and counters as sized above, the counters zero before the
// first call (each launch leaves them zero).  D = H Dh <= 2048, Dh <= 256,
// 1 <= F <= 8192, 1 <= M <= 512, any of them off the aligned designs' steps
// (the note at the top).  One stream at a time may use one counters buffer.
int performer_decode_layer(const void* x, int x_bf16, const void* const* p, int w_bf16,
                           const float* omega, const float* mask, float* S, int s_md,
                           float* z, void* out, float* scratch, int* counters, int B, int D,
                           int H, int M, int F, float eps, float ln_eps, void* stream) {
  if (B <= 0 || H <= 0 || D % H || D > MAX_D || D / H > MAX_DH || F <= 0 || F > MAX_F ||
      M <= 0 || M > MAX_M)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w_bf16 ? decode_layer<__nv_bfloat16>(x, x_bf16, p, omega, mask, S, s_md != 0, z, out,
                                               scratch, counters, B, D, H, M, F, eps, ln_eps, s)
                : decode_layer<float>(x, x_bf16, p, omega, mask, S, s_md != 0, z, out, scratch,
                                      counters, B, D, H, M, F, eps, ln_eps, s);
}

}  // extern "C"
