// FAVOR+ causal linear attention, forward, for Hopper (sm_90a).
//
// Replaces four Pallas TPU kernels of emo_disentanger_tpu/ops/linear_attention.py:
//   _kmax_kernel         (:487, via _fused_key_max)  -> favor_kmax_kernel
//   _fused_fwd_kernel    (:533, via _fused_fwd_impl) -> favor_fwd_kernel
//   _kmax_kernel_hl      (:955, via _hl_key_max)     -> favor_kmax_kernel
//   _fused_fwd_kernel_hl (:977, via _hl_fwd_impl)    -> favor_fwd_kernel
// The entry points favor_kmax / favor_fwd take head-major [BH, L, Dh] rows;
// favor_kmax_hl / favor_fwd_hl take the heads-last [B, L, H * Dh]
// activations and share the same kernel bodies: a row (b, h) reads head h's
// Dh columns in place, rows H * Dh apart (row_base in favor_common.cuh), so
// no head-split copy is made.  The TPU kernels looped over the heads inside
// one block to keep Mosaic's blocks lane-dense; here each (b, h) row keeps
// its own block, as in the head-major layout.  The layout is a template
// flag (HL): the head-major instances fold H = 1 at compile time, so their
// addressing, and their code, is what it was before the heads-last form.
//
// Function (per batch*head row, q/k [L, Dh], v [L, Dv], omega [Dh, M]):
//   h(x)   = (x d^-1/4) . omega - ||x d^-1/4||^2 / 2
//   phi_q  = exp(h(q) - max_m h(q)) / sqrt(M)        (per-position stabilizer)
//   phi_k  = exp(h(k) - max_{L,M} h(k)) / sqrt(M)    (one stabilizer per row)
//   out_i  = phi_q_i . S_i / (phi_q_i . z_i + eps),  S_i = sum_{j<=i} phi_k_j v_j^T,
//                                                    z_i = sum_{j<=i} phi_k_j
// The key max is taken over the true L; the TPU path also covered its
// zero-padded rows when L % 128 != 0, which changes the result only at the
// level of eps.
//
// Bound on the H100: at the serving shapes (Dh = Dv = 64, M = 128) each row
// reads q, k, v once (3 x L x 64 elements) and does ~66k flop per position:
// the two feature maps ~33k in f32 (67 TFLOP/s on the CUDA cores; under
// bf16 in 3xTF32 on the tensor cores, 495 TFLOP/s a pass) and the causal
// products ~33k as the per-position recurrence counts them (bf16 under bf16
// inputs).  So the kernel is bounded by operations, not by its few MB of
// traffic.
//
// Design (simple first): the TPU grid's sequential chunk axis becomes a loop
// inside one thread block per row, with the running (S [M, Dv], z [M])
// state, omega and the chunk's phi_q / phi_k / scores in shared memory
// (~183 KB at the serving shapes, so 64-row chunks).  The key maxima come
// from a separate chunk-parallel launch (favor_kmax_kernel writes one max
// per 64-row chunk; favor_fwd_kernel reduces them), so the stabilizer pass
// is not serialized behind the row.  In f32 the small products are 4x4
// register micro-tiles over shared memory (mma4x4), columns strided across
// lanes so reads are bank-conflict free or broadcast.  Under bf16 inputs,
// the operands of the chunk products (phi_q, phi_k, scores, S, z) are
// rounded to bf16 with f32 accumulation, as the TPU kernel does (its
// _dot_dtype_for); f32 inputs stay exact.
//
// favor_fwd_kernel under bf16 runs on the tensor cores with the backward
// passes' helpers (favor_tc.cuh): the two feature maps in 3xTF32
// (features_tc, omega padded to [Dh][M+1]), the scores phi_q phi_k^T, the
// numerator sc v + phi_q S and the state update S += phi_k^T v on bf16
// mma.sync (tc_mma), the groups above the diagonal skipped and the
// numerator's K run only to the group's last row; q, k and v by 16-byte
// loads (so Dh, Dv and M multiples of 16 and the inputs 16-byte aligned,
// which the wrappers check); ||x||^2 and the denominator a warp a row, the
// z update four lanes a feature, the output stored two bf16 values a lane.
// Rows past L are zero in phi_q, phi_k and v, so every product runs K to a
// multiple of 16.  No TMA, wgmma or pipelining yet.
//
// favor_kmax_kernel under bf16 computes h = xs . omega - ||xs||^2/2 as
// the forward's features_tc does (the same 3xTF32 split, K order and
// accumulation on mma.sync, ||xs||^2 summed as row_sq_tc sums it) with a
// max for the exp, so its stabilizer is the max of exactly the h that the
// bf16 forward and both backward passes exponentiate (phi_k <= 1/sqrt(M)
// holds exactly).  Bound by operations (at B=16 L=3072: 6.5 GFLOP, 0.039 ms
// in 3xTF32 at the tensor cores' peak, against 0.015 ms to read k).  Its
// first cut copied all of omega (32 KB) into shared memory for each 64-row
// chunk and ran the product on 4x4 f32 tiles, bound by shared-memory loads.
// Now a block takes several consecutive chunks of a row (launch_kmax's
// rule), each still writing its own partial max, and at the model's widths
// (Dh <= 64, M <= 128: kmax_chunks_regs) each warp keeps its 16 columns of
// omega split to TF32 in registers for all of them; each chunk's rows come
// in by cp.async while the previous chunk computes, are split to TF32 once
// for all eight warps, and each warp runs its four row groups' products at
// once.  Other widths take the forward's helpers as they are
// (kmax_chunks_smem: omega in shared memory, load_rows_tc, row_sq_tc,
// tc_mma_f32), with the same bits.  The f32 instantiation keeps the first
// cut, one chunk a block, bit for bit.

#include <type_traits>

#include "favor_common.cuh"
#include "favor_tc.cuh"

namespace {

// The bf16 key max keeps omega's TF32 split in registers, a warp's 16
// columns, when each of the THREADS / 32 warps has at most one 16-column
// slab (M <= 128) and Dh <= 64 (KMAX_STEPS steps of 8 in K: 64 registers
// a thread); other widths read omega from shared memory through
// tc_mma_f32.  One rule, for the kernel and its launch's shared memory.
constexpr int KMAX_STEPS = 8;
__host__ __device__ constexpr bool kmax_omega_in_registers(int Dh, int M) {
  return Dh <= 8 * KMAX_STEPS && M <= 16 * (THREADS / 32);
}

// cp.async the n rows of D bf16 values at src, ld apart, into raw [C][D]
// (D a multiple of 8, src 16-byte aligned, as the wrappers check), one
// commit group; rows past n are not fetched
__device__ __forceinline__ void fetch_rows_async(__nv_bfloat16* raw, const __nv_bfloat16* src,
                                                 int n, int D, int ld) {
  const int V = D / 8;
  for (int idx = threadIdx.x; idx < n * V; idx += blockDim.x) {
    const int i = idx / V, v = idx - i * V;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(raw + i * D + 8 * v)),
                 "l"(src + (size_t)i * ld + 8 * v));
  }
  asm volatile("cp.async.commit_group;");
}

// The chunk's rows for the key max's register path (Dh <= 64): x = raw
// [C][Dh] times scale as load_rows_tc makes it (0 for rows i >= n), split
// to TF32 once into xh, xl [C][Dh+1] for every warp's product, and sq[i] =
// ||x_i||^2 / 2 as row_sq_tc sums it (lane l takes d = l, then l + 32,
// then warp_sum's butterfly), each warp's C / 8 rows at once: one pass, no
// f32 copy of the rows.  Ends with __syncthreads().
__device__ __forceinline__ void kmax_rows_tc(uint32_t* xh, uint32_t* xl, float* sq,
                                             const __nv_bfloat16* raw, int n, int Dh,
                                             float scale) {
  constexpr int NW = THREADS / 32, R = C / NW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float sum[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = warp + r * NW;
    sum[r] = 0.f;
#pragma unroll
    for (int d = lane; d < 8 * KMAX_STEPS; d += 32)
      if (d < Dh) {
        const float x = i < n ? __bfloat162float(raw[i * Dh + d]) * scale : 0.f;
        split_tf32(x, xh[i * (Dh + 1) + d], xl[i * (Dh + 1) + d]);
        sum[r] = fmaf(x, x, sum[r]);
      }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r) sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], o);
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < R; ++r) sq[warp + r * NW] = 0.5f * sum[r];
  __syncthreads();
}

// the block's max of each thread's mx, stored by thread 0 at *dst
__device__ __forceinline__ void store_block_max(float mx, float* red, float* dst) {
  mx = warp_max(mx);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x < 32) {
    mx = threadIdx.x < (blockDim.x >> 5) ? red[threadIdx.x] : -INFINITY;
    mx = warp_max(mx);
    if (threadIdx.x == 0) *dst = mx;
  }
}

// The bf16 key max of chunks [c0, c1) of one row (k at the row's first
// position, partial at its first chunk's max), omega's columns in
// registers (kmax_omega_in_registers): warp w keeps its 16 columns split to
// TF32 for all the chunks, as tc_mma_f32 would split them at each use; the
// rows come in by cp.async, the next chunk's while this one computes.
template <bool MASK>
__device__ void kmax_chunks_regs(float* smem, const __nv_bfloat16* k, const float* omega,
                                 float* partial, int c0, int c1, int L, int Dh, int M,
                                 int ld, float scale) {
  const int Mt = true_features<MASK>(M);
  __nv_bfloat16* raw = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][C][Dh]
  uint32_t* xh = reinterpret_cast<uint32_t*>(smem + C * Dh);     // [C][Dh+1]
  uint32_t* xl = xh + C * (Dh + 1);                              // [C][Dh+1]
  float* sq = reinterpret_cast<float*>(xl + C * (Dh + 1));       // [C]
  float* red = sq + C;                                           // [32]
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int j0 = 16 * (threadIdx.x >> 5), steps = Dh / 8;
  uint32_t bh[KMAX_STEPS][2][2], bl[KMAX_STEPS][2][2];
  if (j0 < M) {
#pragma unroll
    for (int s = 0; s < KMAX_STEPS; ++s)
      if (s < steps)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            split_tf32(omega[(tf32_k(s, Dh, t) + e) * M + j0 + 8 * nt + g], bh[s][nt][e],
                       bl[s][nt][e]);
  }
  fetch_rows_async(raw, k + (size_t)c0 * C * ld, min(C, L - c0 * C), Dh, ld);
  for (int c = c0; c < c1; ++c) {
    const int r0 = c * C, n = min(C, L - r0);
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    if (c + 1 < c1)
      fetch_rows_async(raw + ((c + 1 - c0) & 1) * C * Dh, k + (size_t)(r0 + C) * ld,
                       min(C, L - r0 - C), Dh, ld);
    kmax_rows_tc(xh, xl, sq, raw + ((c - c0) & 1) * C * Dh, n, Dh, scale);
    // tc_mma_f32's steps on the split rows and registers, the warp's C / 16
    // row groups at once (independent accumulators)
    float mx = -INFINITY;
    if (j0 < M) {
      constexpr int G = C / 16;
      float acc[G][2][4] = {};
#pragma unroll
      for (int s = 0; s < KMAX_STEPS; ++s)
        if (s < steps) {
          const int kk = tf32_k(s, Dh, t);
#pragma unroll
          for (int q = 0; q < G; ++q) {
            const int a0 = (16 * q + g) * (Dh + 1) + kk, a1 = a0 + 8 * (Dh + 1);
            const uint32_t ah[4] = {xh[a0], xh[a1], xh[a0 + 1], xh[a1 + 1]};
            const uint32_t al[4] = {xl[a0], xl[a1], xl[a0 + 1], xl[a1 + 1]};
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              mma_tf32(acc[q][nt], al, bh[s][nt]);
              mma_tf32(acc[q][nt], ah, bl[s][nt]);
              mma_tf32(acc[q][nt], ah, bh[s][nt]);
            }
          }
        }
#pragma unroll
      for (int q = 0; q < G; ++q)
        tc_each<2>(acc[q], 16 * q, j0, [&](int i, int m, float x) {
          if (i < n && (!MASK || m < Mt)) mx = fmaxf(mx, x - sq[i]);
        });
    }
    store_block_max(mx, red, partial + c);
  }
}

// The same at other widths: omega padded to [Dh][M+1] in shared memory,
// the rows by load_rows_tc, the product through tc_mma_f32.
template <bool MASK>
__device__ void kmax_chunks_smem(float* smem, const __nv_bfloat16* k, const float* omega,
                                 float* partial, int c0, int c1, int L, int Dh, int M,
                                 int ld, float scale) {
  const int Mt = true_features<MASK>(M);
  float* om = smem;                    // [Dh][M+1]
  float* xs = om + Dh * (M + 1);       // [C][Dh+1]
  float* sq = xs + C * (Dh + 1);       // [C]
  float* red = sq + C;                 // [32]
  omega_padded(om, omega, Dh, M);      // once for the block's chunks
  for (int c = c0; c < c1; ++c) {
    const int r0 = c * C, n = min(C, L - r0);
    load_rows_tc(xs, k + (size_t)r0 * ld, n, Dh, ld, scale);
    __syncthreads();
    row_sq_tc(sq, xs, Dh);
    float mx = -INFINITY;
    tc_groups(C, M, [&](float (*acc)[4], int i0, int j0) {
      tc_mma_f32<2>(acc, xs, Dh + 1, 1, i0, om, M + 1, 1, j0, Dh);
      tc_each<2>(acc, i0, j0, [&](int i, int m, float x) {
        if (i < n && (!MASK || m < Mt)) mx = fmaxf(mx, x - sq[i]);
      });
    });
    store_block_max(mx, red, partial + c);
  }
}

template <class T, bool HL, int MODE>
__global__ void favor_kmax_kernel(const T* __restrict__ k, const float* __restrict__ omega,
                                  float* __restrict__ partial, int L, int Dh, int M,
                                  int n_head, float scale, int per_block) {
  // bf16: h on the tensor cores, per_block consecutive chunks of the row a
  // block (Dh and M multiples of 16 and k 16-byte aligned, which the
  // wrappers see to); f32: one chunk a block on 4x4 tiles (WORKSPACE: a
  // block loops over the row's chunks, one workspace slice a row)
  constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
  constexpr bool MASK = MODE != ALIGNED, BIG = MODE == WORKSPACE;
  const int H = HL ? n_head : 1;
  extern __shared__ float smem_[];
  const int row = blockIdx.y, nch = (L + C - 1) / C;
  float* smem = smem_;
  if constexpr (MODE == WORKSPACE) smem = g_width.ws + (size_t)row * g_width.ws_floats;

  if constexpr (TC) {
    // either path computes h bit for bit as features_tc does (the note at
    // the top)
    const int c0 = blockIdx.x * per_block, c1 = min(nch, c0 + per_block);
    k += row_base(row, H, L, Dh);
    partial += (size_t)row * nch;
    if (!BIG && kmax_omega_in_registers(Dh, M))
      kmax_chunks_regs<MASK>(smem, k, omega, partial, c0, c1, L, Dh, M, H * Dh, scale);
    else
      kmax_chunks_smem<MASK>(smem, k, omega, partial, c0, c1, L, Dh, M, H * Dh, scale);
  } else {
    float* om = smem;                    // [Dh][M]
    float* xs = om + Dh * M;             // [C][Dh+1]
    float* sq = xs + C * (Dh + 1);       // [C]
    float* red = sq + C;                 // [32]
    const int Mt = true_features<MASK>(M);
    auto one_chunk = [&](int chunk) {
      const int r0 = chunk * C, n = min(C, L - r0);
      for (int i = threadIdx.x; i < Dh * M; i += blockDim.x) om[i] = omega[i];
      // the head-major address keeps its original form: through row_base this
      // short kernel measured 4.6% slower on the H100 (kernel_ab.py)
      load_scaled<T>(xs, sq,
                     HL ? k + row_base(row, H, L, Dh) + (size_t)r0 * H * Dh
                        : k + ((size_t)row * L + r0) * Dh,
                     n, Dh, H * Dh, scale);

      float mx = -INFINITY;
      const int RT = C / 4, NT = M / 4;
      for (int t = threadIdx.x; t < RT * NT; t += blockDim.x) {
        const int it = t / NT, jt = t - it * NT;
        float acc[4][4];
        zero4x4(acc);
        mma4x4<float, false, false>(acc, xs, Dh + 1, 1, it, RT, om, M, 1, jt, NT, Dh);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = it + r * RT;
          if (i < n)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (!MASK || jt + c * NT < Mt) mx = fmaxf(mx, acc[r][c] - sq[i]);
        }
      }
      store_block_max(mx, red, partial + (size_t)row * nch + chunk);
    };
    if constexpr (BIG) {
      for (int chunk = 0; chunk < nch; ++chunk) {
        one_chunk(chunk);
        __syncthreads();
      }
    } else {
      one_chunk(blockIdx.x);
    }
  }
}

template <class T, bool HL, int MODE>
__global__ void favor_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                 const T* __restrict__ v, const float* __restrict__ omega,
                                 const float* __restrict__ partial, T* __restrict__ out,
                                 int L, int Dh, int Dv, int M, int n_head, float scale,
                                 float rsqm, float eps) {
  // bf16: the chunk products on the tensor cores (Dh, Dv, M multiples of
  // 16, which the wrappers see to)
  constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
  constexpr bool MASK = MODE != ALIGNED;
  const int H = HL ? n_head : 1, Mt = true_features<MASK>(M);
  extern __shared__ float smem_[];
  float* smem = smem_;
  if constexpr (MODE == WORKSPACE) smem = g_width.ws + (size_t)blockIdx.x * g_width.ws_floats;
  const int MP = M + 1, DVP = Dv + 1, CP = C + 1;
  float* om = smem;                    // [Dh][M] ([Dh][M+1] under TC)
  float* S = om + Dh * (TC ? MP : M);  // [M][Dv+1]   running sum phi_k v^T
  float* z = S + M * DVP;              // [M]         running sum phi_k
  float* pq = z + M;                   // [C][M+1]    phi_q (f32: dot operands)
  float* pk = pq + C * MP;             // [C][M+1]    phi_k
  float* vv = pk + C * MP;             // [C][Dv+1]
  float* xs = vv + C * DVP;            // [C][Dh+1]
  float* sc = xs + C * (Dh + 1);       // [C][C+1]    masked intra-chunk scores
  float* sq = sc + C * CP;             // [C]
  float* den = sq + C;                 // [C]
  const int row = blockIdx.x, nch = (L + C - 1) / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarp = blockDim.x >> 5;

  float kmax = -INFINITY;
  if constexpr (TC) {
    kmax = setup(om, omega, S, z, partial, Dh, Dv, M, nch);
  } else {
    for (int i = tid; i < Dh * M; i += blockDim.x) om[i] = omega[i];
    for (int i = tid; i < M * DVP; i += blockDim.x) S[i] = 0.f;
    for (int i = tid; i < M; i += blockDim.x) z[i] = 0.f;
    for (int c = 0; c < nch; ++c) kmax = fmaxf(kmax, partial[(size_t)row * nch + c]);
    __syncthreads();
  }

  const int ldx = H * Dh, ldv = H * Dv;
  q += row_base(row, H, L, Dh);        // this row's first position
  k += row_base(row, H, L, Dh);
  v += row_base(row, H, L, Dv);
  out += row_base(row, H, L, Dv);
  for (int r0 = 0; r0 < L; r0 += C) {
    const int n = min(C, L - r0);

    if constexpr (TC) {
      // phi_k and the v rows, then phi_q
      load_rows_tc(xs, k + (size_t)r0 * ldx, n, Dh, ldx, scale);
      load_rows_tc(vv, v + (size_t)r0 * ldv, n, Dv, ldv, 1.f);
      __syncthreads();
      row_sq_tc(sq, xs, Dh);
      features_tc<false, MASK>(pk, xs, sq, om, n, Dh, M, kmax, rsqm);
      load_rows_tc(xs, q + (size_t)r0 * ldx, n, Dh, ldx, scale);
      __syncthreads();
      row_sq_tc(sq, xs, Dh);
      features_tc<true, MASK>(pq, xs, sq, om, n, Dh, M, kmax, rsqm);

      // sc = phi_q phi_k^T, masked to j <= i
      tc_groups(C, C, [&](float (*acc)[4], int i0, int j0) {
        if (j0 <= i0) tc_mma<2>(acc, pq, MP, 1, i0, pk, 1, MP, j0, M);
        tc_each<2>(acc, i0, j0,
                   [&](int i, int j, float x) { sc[i * CP + j] = j <= i ? x : 0.f; });
      });
      __syncthreads();

      // den_i = sum_{j<=i} sc_ij + phi_q_i . z, a warp per row
      for (int i = warp; i < C; i += nwarp) {
        float s = 0.f, t = 0.f;
        for (int j = lane; j < C; j += 32) s += sc[i * CP + j];
        for (int m = lane; m < M; m += 32) t = fmaf(rnd<T>(pq[i * MP + m]), rnd<T>(z[m]), t);
        s = warp_sum(s);
        t = warp_sum(t);
        if (lane == 0) den[i] = s + t;
      }
      __syncthreads();

      // out_i = (sc_i . v + phi_q_i . S) / (den_i + eps) for rows i < n,
      // each lane storing two adjacent bf16 values at once
      tc_groups(C, Dv, [&](float (*acc)[4], int i0, int d0) {
        tc_mma<2>(acc, sc, CP, 1, i0, vv, DVP, 1, d0, i0 + 16);
        tc_mma<2>(acc, pq, MP, 1, i0, S, DVP, 1, d0, M);
        const int g = lane >> 2, t = lane & 3;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = i0 + g + 8 * h;
          if (i < n) {
            const float dn = den[i] + eps;
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
              *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(r0 + i) * ldv + d0 + 8 * nt +
                                                 2 * t) =
                  __floats2bfloat162_rn(acc[nt][2 * h] / dn, acc[nt][2 * h + 1] / dn);
          }
        }
      });
      __syncthreads();

      // S += phi_k^T v (phi_k read transposed), z += sum_j phi_k_j
      tc_groups(M, Dv, [&](float (*acc)[4], int m0, int d0) {
        tc_mma<2>(acc, pk, 1, MP, m0, vv, DVP, 1, d0, C);
        tc_each<2>(acc, m0, d0, [&](int m, int d, float x) { S[m * DVP + d] += x; });
      });
      add_col_sums_tc(z, pk, M);
    } else {
      // phi_q: h into pq, then the per-position max and exp (a warp per row)
      load_scaled<T>(xs, sq, q + (size_t)r0 * ldx, n, Dh, ldx, scale);
      for (int t = tid; t < (C / 4) * (M / 4); t += blockDim.x) {
        const int it = t / (M / 4), jt = t - it * (M / 4);
        float acc[4][4];
        zero4x4(acc);
        mma4x4<float, false, false>(acc, xs, Dh + 1, 1, it, C / 4, om, M, 1, jt, M / 4, Dh);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = it + r * (C / 4), m = jt + c * (M / 4);
            pq[i * MP + m] = acc[r][c] - sq[i];
          }
      }
      __syncthreads();
      for (int i = warp; i < C; i += nwarp) {
        float mx = -INFINITY;
        for (int m = lane; m < (MASK ? Mt : M); m += 32) mx = fmaxf(mx, pq[i * MP + m]);
        mx = warp_max(mx);
        for (int m = lane; m < M; m += 32)
          pq[i * MP + m] =
              i < n && (!MASK || m < Mt) ? rnd<T>(expf(pq[i * MP + m] - mx) * rsqm) : 0.f;
      }
      __syncthreads();

      // phi_k with the row's stabilizer; v rows
      load_scaled<T>(xs, sq, k + (size_t)r0 * ldx, n, Dh, ldx, scale);
      for (int t = tid; t < (C / 4) * (M / 4); t += blockDim.x) {
        const int it = t / (M / 4), jt = t - it * (M / 4);
        float acc[4][4];
        zero4x4(acc);
        mma4x4<float, false, false>(acc, xs, Dh + 1, 1, it, C / 4, om, M, 1, jt, M / 4, Dh);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = it + r * (C / 4), m = jt + c * (M / 4);
            pk[i * MP + m] =
                i < n && (!MASK || m < Mt) ? expf(acc[r][c] - sq[i] - kmax) * rsqm : 0.f;
          }
      }
      for (int idx = tid; idx < C * Dv; idx += blockDim.x) {
        const int i = idx / Dv, d = idx - i * Dv;
        vv[i * DVP + d] = i < n ? to_f<T>(v[(size_t)(r0 + i) * ldv + d]) : 0.f;
      }
      __syncthreads();

      // sc[i][j] = phi_q_i . phi_k_j for j <= i
      for (int t = tid; t < (C / 4) * (C / 4); t += blockDim.x) {
        const int it = t / (C / 4), jt = t - it * (C / 4);
        float acc[4][4];
        zero4x4(acc);
        mma4x4<T, false, true>(acc, pq, MP, 1, it, C / 4, pk, 1, MP, jt, C / 4, M);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = it + r * (C / 4), j = jt + c * (C / 4);
            sc[i * CP + j] = j <= i ? acc[r][c] : 0.f;
          }
      }
      __syncthreads();

      // den_i = sum_j sc[i][j] + phi_q_i . z
      for (int i = tid; i < C; i += blockDim.x) {
        float s = 0.f, t = 0.f;
        for (int j = 0; j <= i; ++j) s += sc[i * CP + j];
        for (int m = 0; m < M; ++m) t = fmaf(pq[i * MP + m], rnd<T>(z[m]), t);
        den[i] = s + t;
      }
      __syncthreads();

      // out_i = (sc_i . v + phi_q_i . S) / (den_i + eps)
      for (int t = tid; t < (C / 4) * (Dv / 4); t += blockDim.x) {
        const int it = t / (Dv / 4), jt = t - it * (Dv / 4);
        float acc[4][4];
        zero4x4(acc);
        mma4x4<T, true, false>(acc, sc, CP, 1, it, C / 4, vv, DVP, 1, jt, Dv / 4, n);
        mma4x4<T, false, true>(acc, pq, MP, 1, it, C / 4, S, DVP, 1, jt, Dv / 4, M);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = it + r * (C / 4);
          if (i < n)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int d = jt + c * (Dv / 4);
              out[(size_t)(r0 + i) * ldv + d] = from_f<T>(acc[r][c] / (den[i] + eps));
            }
        }
      }
      __syncthreads();

      // S += phi_k^T v, z += sum_j phi_k_j
      for (int t = tid; t < (M / 4) * (Dv / 4); t += blockDim.x) {
        const int it = t / (Dv / 4), jt = t - it * (Dv / 4);
        float acc[4][4];
        zero4x4(acc);
        mma4x4<T, true, false>(acc, pk, 1, MP, it, M / 4, vv, DVP, 1, jt, Dv / 4, n);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            S[(it + r * (M / 4)) * DVP + jt + c * (Dv / 4)] += acc[r][c];
      }
      for (int m = tid; m < M; m += blockDim.x) {
        float s = 0.f;
        for (int j = 0; j < n; ++j) s += pk[j * MP + m];
        z[m] += s;
      }
    }
    __syncthreads();
  }
}

// floats of a kmax block's tiles: f32 omega [Dh][M] and the rows [C][Dh+1];
// bf16 the same with omega [Dh][M+1], or two chunks' raw rows and their
// TF32 split (kmax_omega_in_registers)
size_t kmax_floats(int Dh, int M, bool tc) {
  const size_t rows = !tc ? (size_t)Dh * M + C * (Dh + 1)
                      : kmax_omega_in_registers(Dh, M) ? (size_t)C * Dh + 2 * C * (Dh + 1)
                                                       : (size_t)Dh * (M + 1) + C * (Dh + 1);
  return rows + C + 32;
}

// floats of a forward block's tiles (omega padded to [Dh][M+1] under bf16,
// favor_tc.cuh's features_tc)
size_t fwd_floats(int Dh, int Dv, int M, bool tc) {
  const int om_cols = tc ? M + 1 : M;
  return (size_t)Dh * om_cols + (size_t)M * (Dv + 1) + M + 2 * C * (M + 1) + C * (Dv + 1) +
         C * (Dh + 1) + C * (C + 1) + 2 * C + 32;
}

template <class T, bool HL>
int launch_kmax(const void* k, const float* omega, float* partial, int BH, int H, int L,
                int Dh, int M, int Dt, int Mt, float* ws, long long ws_floats,
                cudaStream_t stream) {
  // bf16: per consecutive chunks a block, so that omega is read and split
  // once for them and the next chunk's rows load while one computes: the
  // most of 8, 4 and 2 that still leaves 512 blocks, about two waves at
  // two blocks an SM, else 1 (kernel_sections.py --kmax: 8 fastest at B=16
  // L=2048 and 3072, 1 and 2 at the serving path's 256 chunks)
  constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
  const int nch = (L + C - 1) / C;
  const size_t floats = kmax_floats(Dh, M, TC);
  const int mode = width_mode(floats, M, Mt);
  if (mode == WORKSPACE && (!ws || ws_floats < (long long)BH * (long long)floats))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_width_args(mode, Mt, ws, floats, stream);
  if (err != cudaSuccess) return (int)err;
  if (mode == WORKSPACE) {
    // a block a row, over all its chunks, its tiles in the workspace
    favor_kmax_kernel<T, HL, WORKSPACE><<<dim3(1, BH), THREADS, 0, stream>>>(
        static_cast<const T*>(k), omega, partial, L, Dh, M, H, feature_scale(Dt), nch);
    return (int)cudaGetLastError();
  }
  int per = 1;
  while (TC && per < 8 && BH * nch / (2 * per) >= 512) per *= 2;
  const size_t smem = sizeof(float) * floats;
  const auto kernel =
      mode == MASKED ? favor_kmax_kernel<T, HL, MASKED> : favor_kmax_kernel<T, HL, ALIGNED>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nch + per - 1) / per, BH);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(k), omega, partial, L, Dh, M,
                                          H, feature_scale(Dt), per);
  return (int)cudaGetLastError();
}

template <class T, bool HL>
int launch_fwd(const void* q, const void* k, const void* v, const float* omega,
               const float* partial, void* out, int BH, int H, int L, int Dh, int Dv, int M,
               int Dt, int Mt, float eps, float* ws, long long ws_floats, cudaStream_t stream) {
  const size_t floats = fwd_floats(Dh, Dv, M, std::is_same<T, __nv_bfloat16>::value);
  const int mode = width_mode(floats, M, Mt);
  if (mode == WORKSPACE && (!ws || ws_floats < (long long)BH * (long long)floats))
    return (int)cudaErrorInvalidValue;
  const auto kernel = mode == WORKSPACE ? favor_fwd_kernel<T, HL, WORKSPACE>
                      : mode == MASKED  ? favor_fwd_kernel<T, HL, MASKED>
                                        : favor_fwd_kernel<T, HL, ALIGNED>;
  const size_t smem = mode == WORKSPACE ? 0 : sizeof(float) * floats;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess) err = set_width_args(mode, Mt, ws, floats, stream);
  if (err != cudaSuccess) return (int)err;
  kernel<<<BH, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), omega,
      partial, static_cast<T*>(out), L, Dh, Dv, M, H, feature_scale(Dt),
      (float)(1.0 / sqrt((double)Mt)), eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* emodis_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Every entry point takes Dh, Dv and M at the instantiation's tile (16
// under bf16, 4 in f32; the wrappers zero-pad other widths), the true head
// width Dt and feature count Mt (the note in favor_common.cuh), and a
// workspace of ws_floats floats, used (and then required: the launch
// refuses less) only when a block's tiles exceed shared memory, one slice
// of kmax_floats / fwd_floats a row (ops/linear_attention.py
// _favor_workspace computes the same).

// k [BH, L, Dh] (f32, or bf16 when bf16 != 0), omega [Dh, M] f32 ->
// partial [BH, ceil(L/64)] f32: the key max of each 64-row chunk.
int favor_kmax(const void* k, const float* omega, float* partial, int BH, int L, int Dh,
               int M, int bf16, int Dt, int Mt, float* ws, long long ws_floats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_kmax<__nv_bfloat16, false>(k, omega, partial, BH, 1, L, Dh, M, Dt, Mt,
                                                  ws, ws_floats, s)
              : launch_kmax<float, false>(k, omega, partial, BH, 1, L, Dh, M, Dt, Mt, ws,
                                          ws_floats, s);
}

// heads-last: k [B, L, H * Dh] -> partial [B * H, ceil(L/64)] f32, row b * H + h.
int favor_kmax_hl(const void* k, const float* omega, float* partial, int B, int H, int L,
                  int Dh, int M, int bf16, int Dt, int Mt, float* ws, long long ws_floats,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_kmax<__nv_bfloat16, true>(k, omega, partial, B * H, H, L, Dh, M, Dt, Mt,
                                                 ws, ws_floats, s)
              : launch_kmax<float, true>(k, omega, partial, B * H, H, L, Dh, M, Dt, Mt, ws,
                                         ws_floats, s);
}

// q, k [BH, L, Dh], v [BH, L, Dv] (one dtype), omega [Dh, M] f32, partial from
// favor_kmax -> out [BH, L, Dv] in the inputs' dtype.
int favor_fwd(const void* q, const void* k, const void* v, const float* omega,
              const float* partial, void* out, int BH, int L, int Dh, int Dv, int M, int bf16,
              float eps, int Dt, int Mt, float* ws, long long ws_floats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<__nv_bfloat16, false>(q, k, v, omega, partial, out, BH, 1, L, Dh,
                                                 Dv, M, Dt, Mt, eps, ws, ws_floats, s)
              : launch_fwd<float, false>(q, k, v, omega, partial, out, BH, 1, L, Dh, Dv, M, Dt,
                                         Mt, eps, ws, ws_floats, s);
}

// heads-last: q, k, v [B, L, H * Dh] (one dtype), omega [Dh, M] f32, partial
// from favor_kmax_hl -> out [B, L, H * Dh] in the inputs' dtype.
int favor_fwd_hl(const void* q, const void* k, const void* v, const float* omega,
                 const float* partial, void* out, int B, int H, int L, int Dh, int M, int bf16,
                 float eps, int Dt, int Mt, float* ws, long long ws_floats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<__nv_bfloat16, true>(q, k, v, omega, partial, out, B * H, H, L,
                                                Dh, Dh, M, Dt, Mt, eps, ws, ws_floats, s)
              : launch_fwd<float, true>(q, k, v, omega, partial, out, B * H, H, L, Dh, Dh, M,
                                        Dt, Mt, eps, ws, ws_floats, s);
}

}  // extern "C"
