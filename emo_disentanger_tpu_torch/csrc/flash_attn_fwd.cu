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
// flop per row.  They run on the tensor cores in 3xTF32, three TF32 products
// per f32 product, so the floor is 3 x that at 495 TFLOP/s: 0.4166 ms at the
// re-anchor shape (B=16, H=8, L=2048, Dh=64), against 268 MB of traffic,
// ~0.08 ms.  The kernel is bounded by operations.  (On the CUDA cores in
// f32, 67 TFLOP/s, the same products would take 1.0262 ms.)
//
// Accuracy: TF32 keeps 10 mantissa bits, ~5e-4 relative per operand, too
// coarse for f32 attention.  Each operand x is split into hi = rna_tf32(x)
// and lo = rna_tf32(x - hi); hi*hi + hi*lo + lo*hi (the lo*lo term is ~2^-22
// relative and dropped) is accumulated in f32, which keeps the error near
// f32's (~1e-6 against the f32 reference).
//
// Design: one block of 8 warps per (row, 128-query tile), 1-d grid.  Each
// warp owns 16 query rows and keeps their q fragments (hi and lo) in
// registers for the whole loop.  Key and value tiles of 64 rows arrive by
// cp.async into two stages of shared memory, the next tile loading while
// the current one is used.  When a tile has arrived the block splits it
// once, for all 8 warps: k into hi (in place) and lo, v into hi and lo
// transposed to [dh][key].  Per key tile a warp runs s = q k^T with
// mma.sync.m16n8k8 tf32, its k fragments loaded by ldmatrix (four 8x4
// blocks of 32-bit values an instruction), rescales in the log2 domain
// (scores times sm_scale * log2 e, then exp2f), keeps the online-softmax
// running max and sum of its rows in registers, and runs o += p v with p
// straight from the score accumulators as the A operand.  For that the k
// rows of each 8-key group are read in the order 0 4 1 5 2 6 3 7, so the
// accumulator's columns (2t, 2t+1) hold keys (t, t+4): exactly the A
// fragment's K slots, which meet the transposed v's ldmatrix fragments.
// Tiles above the diagonal are never touched, a warp skips a tile all of
// whose keys lie after its rows, and only the diagonal tiles are masked.
// The output is divided by the running sum once, at the end.  Query tiles
// are handed out longest first (the first blocks take the last tiles,
// which loop over the most key tiles), so the causal imbalance does not
// leave SMs idle at the tail.  Shared memory: 119 KB a block.  The pitch of
// 68 floats keeps the tile copies, the split and the ldmatrix reads free of
// bank conflicts.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;          // query rows per block
constexpr int BK = 64;           // keys per tile
constexpr int D = 64;            // head width, the only one taken
constexpr int WARPS = BQ / 16;   // 16 query rows a warp
constexpr int THREADS = WARPS * 32;
constexpr int PITCH = D + 4;     // floats per shared row (BK == D: one pitch)
constexpr int TILE = BK * PITCH;
// two stages of raw k (hi after the split) and raw v; k lo; v hi, lo transposed
constexpr size_t SMEM_BYTES = sizeof(float) * 7 * TILE;

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B in 3xTF32 from split fragments (the lo*lo term dropped)
__device__ __forceinline__ void mma3(float* d, const uint32_t* ah, const uint32_t* al,
                                     uint32_t bh0, uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

// four 8x4 blocks of 32-bit values; lane l gives the address of row l % 8
// of block l / 8 and receives element (l / 4, l % 4) of each block
__device__ __forceinline__ void ldsm_x4(uint32_t* d, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const float* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(smem)), "l"(gmem));
}

// k and v rows [r0, r0 + BK) of one (batch, head) row into a stage
__device__ __forceinline__ void load_tile(float* ks, float* vs, const float* k, const float* v,
                                          size_t r0, int tid) {
#pragma unroll
  for (int i = 0; i < BK * D / 4 / THREADS; ++i) {
    const int idx = tid + i * THREADS, r = idx / (D / 4), c = (idx % (D / 4)) * 4;
    cp_async16(ks + r * PITCH + c, k + (r0 + r) * D + c);
    cp_async16(vs + r * PITCH + c, v + (r0 + r) * D + c);
  }
  asm volatile("cp.async.commit_group;");
}

// k -> hi in place and lo; v [key][dh] -> hi and lo as [dh][key]
__device__ __forceinline__ void split_tile(float* ks, float* klo, const float* vs, float* vth,
                                           float* vtl, int tid) {
#pragma unroll
  for (int i = 0; i < BK * D / 4 / THREADS; ++i) {
    const int idx = tid + i * THREADS, r = idx / (D / 4), c = (idx % (D / 4)) * 4;
    float4* kp = reinterpret_cast<float4*>(ks + r * PITCH + c);
    const float4 x = *kp;
    uint32_t h[4], l[4];
    split(x.x, h[0], l[0]);
    split(x.y, h[1], l[1]);
    split(x.z, h[2], l[2]);
    split(x.w, h[3], l[3]);
    *kp = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                      __uint_as_float(h[3]));
    *reinterpret_cast<float4*>(klo + r * PITCH + c) =
        make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                    __uint_as_float(l[3]));
  }
#pragma unroll
  for (int i = 0; i < BK * D / 4 / THREADS; ++i) {
    // keys fastest across lanes: conflict-free transposed stores
    const int idx = tid + i * THREADS, r = idx % BK, c = (idx / BK) * 4;
    const float4 x = *reinterpret_cast<const float4*>(vs + r * PITCH + c);
    const float e[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t h, l;
      split(e[j], h, l);
      vth[(c + j) * PITCH + r] = __uint_as_float(h);
      vtl[(c + j) * PITCH + r] = __uint_as_float(l);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
flash_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, int BH, int L,
                      float scale_log2) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);   // stage s: k at 2s, v at 2s + 1
  float* klo = smem + 4 * TILE;
  float* vth = klo + TILE;
  float* vtl = vth + TILE;

  const int blk = blockIdx.x;
  const int qtile = L / BQ - 1 - blk / BH;   // longest first
  const int bh = blk % BH;
  const size_t row0 = (size_t)bh * L;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qr0 = qtile * BQ + warp * 16;    // this warp's first query row
  const int nkb = (qtile + 1) * (BQ / BK);

  load_tile(smem, smem + TILE, k, v, row0, tid);

  // q fragments for the 8 depth steps: a0 (g, 8j+t), a1 (g+8, 8j+t),
  // a2 (g, 8j+t+4), a3 (g+8, 8j+t+4)
  uint32_t qh[D / 8][4], ql[D / 8][4];
  {
    const float* qp = q + (row0 + qr0) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split(qp[(g + 8 * (i & 1)) * D + 8 * j + t + 4 * (i >> 1)], qh[j][i], ql[j][i]);
  }

  // ldmatrix rows of this lane: block i = lane / 8 covers n-tile i / 2 of a
  // pair, columns 4 (i % 2) .. + 4; k rows in the order 0 4 1 5 2 6 3 7
  const int bi = lane >> 3, br = lane & 7;
  const int k_off = ((bi >> 1) * 8 + (br >> 1) + 4 * (br & 1)) * PITCH + 4 * (bi & 1);
  const int v_off = ((bi >> 1) * 8 + br) * PITCH + 4 * (bi & 1);

  float acc[D / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int kb = 0; kb < nkb; ++kb) {
    asm volatile("cp.async.wait_group 0;");
    __syncthreads();                         // tile kb is in; tile kb - 1 is done with
    if (kb + 1 < nkb) {
      float* next = smem + ((kb + 1) & 1) * 2 * TILE;
      load_tile(next, next + TILE, k, v, row0 + (size_t)(kb + 1) * BK, tid);
    }
    float* ks = smem + (kb & 1) * 2 * TILE;
    split_tile(ks, klo, ks + TILE, vth, vtl, tid);
    __syncthreads();
    const int key0 = kb * BK;
    if (key0 > qr0 + 15) continue;           // every key of the tile is after these rows

    // s = q k^T; column 2t + c of n-tile n holds key 8n + t + 4c
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
    const uint32_t kh_a = smem_addr(ks + k_off), kl_a = smem_addr(klo + k_off);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t fh[4], fl[4];
        const uint32_t off = 4 * (np * 16 * PITCH + 8 * j);
        ldsm_x4(fh, kh_a + off);
        ldsm_x4(fl, kl_a + off);
        mma3(s[2 * np], qh[j], ql[j], fh[0], fh[1], fl[0], fl[1]);
        mma3(s[2 * np + 1], qh[j], ql[j], fh[2], fh[3], fl[2], fl[3]);
      }

    // log2-domain scores; mask keys after the row on the diagonal tiles
    const bool diag = key0 + BK - 1 > qr0;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[n][i] * scale_log2;
        if (diag && key0 + n * 8 + t + 4 * (i & 1) > qr0 + g + 8 * (i >> 1)) x = -INFINITY;
        s[n][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // every row sees key 0 in tile 0, so m is finite from then on
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = exp2f(s[n][i] - m[i >> 1]);
        rs[i >> 1] += s[n][i];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // o += p v over 8 keys a step: p's K slots t and t + 4 are keys t and
    // t + 4 (the accumulator's columns 2t, 2t + 1), as are the transposed
    // v's ldmatrix fragments
    const uint32_t vh_a = smem_addr(vth + v_off), vl_a = smem_addr(vtl + v_off);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      uint32_t ph[4], pl[4];
      split(s[j][0], ph[0], pl[0]);
      split(s[j][2], ph[1], pl[1]);
      split(s[j][1], ph[2], pl[2]);
      split(s[j][3], ph[3], pl[3]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t fh[4], fl[4];
        const uint32_t off = 4 * (np * 16 * PITCH + 8 * j);
        ldsm_x4(fh, vh_a + off);
        ldsm_x4(fl, vl_a + off);
        mma3(acc[2 * np], ph, pl, fh[0], fh[1], fl[0], fl[1]);
        mma3(acc[2 * np + 1], ph, pl, fh[2], fh[3], fl[2], fl[3]);
      }
    }
  }

  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
  float* op = o + (row0 + qr0 + g) * D + 2 * t;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<float2*>(op + n * 8) = make_float2(acc[n][0] * inv0, acc[n][1] * inv0);
    *reinterpret_cast<float2*>(op + 8 * D + n * 8) =
        make_float2(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

}  // namespace

extern "C" {

const char* emodis_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// q, k, v [BH, L, Dh] f32, contiguous, Dh == 64, L a positive multiple of 128
// -> o [BH, L, Dh] f32: causal softmax attention with scores sm_scale q.k.
int flash_attn_fwd(const float* q, const float* k, const float* v, float* o, int BH, int L,
                   int Dh, float sm_scale, void* stream) {
  if (Dh != D || L <= 0 || L % BQ || BH <= 0 || (long long)BH * (L / BQ) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2 = (float)((double)sm_scale * 1.4426950408889634);
  flash_attn_fwd_kernel<<<BH * (L / BQ), THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, o, BH, L, scale_log2);
  return (int)cudaGetLastError();
}

}  // extern "C"
