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

#include <type_traits>

#include "favor_common.cuh"
#include "favor_tc.cuh"

namespace {

template <class T, bool HL>
__global__ void favor_kmax_kernel(const T* __restrict__ k, const float* __restrict__ omega,
                                  float* __restrict__ partial, int L, int Dh, int M,
                                  int n_head, float scale) {
  const int H = HL ? n_head : 1;
  extern __shared__ float smem[];
  float* om = smem;                    // [Dh][M]
  float* xs = om + Dh * M;             // [C][Dh+1]
  float* sq = xs + C * (Dh + 1);       // [C]
  float* red = sq + C;                 // [32]
  const int chunk = blockIdx.x, row = blockIdx.y, nch = gridDim.x;
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
        for (int c = 0; c < 4; ++c) mx = fmaxf(mx, acc[r][c] - sq[i]);
    }
  }
  mx = warp_max(mx);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x < 32) {
    mx = threadIdx.x < (blockDim.x >> 5) ? red[threadIdx.x] : -INFINITY;
    mx = warp_max(mx);
    if (threadIdx.x == 0) partial[(size_t)row * nch + chunk] = mx;
  }
}

template <class T, bool HL>
__global__ void favor_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                 const T* __restrict__ v, const float* __restrict__ omega,
                                 const float* __restrict__ partial, T* __restrict__ out,
                                 int L, int Dh, int Dv, int M, int n_head, float scale,
                                 float rsqm, float eps) {
  // bf16: the chunk products on the tensor cores (Dh, Dv, M multiples of
  // 16, which the wrappers check)
  constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
  const int H = HL ? n_head : 1;
  extern __shared__ float smem[];
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
      features_tc<false>(pk, xs, sq, om, n, Dh, M, kmax, rsqm);
      load_rows_tc(xs, q + (size_t)r0 * ldx, n, Dh, ldx, scale);
      __syncthreads();
      row_sq_tc(sq, xs, Dh);
      features_tc<true>(pq, xs, sq, om, n, Dh, M, kmax, rsqm);

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
        for (int m = lane; m < M; m += 32) mx = fmaxf(mx, pq[i * MP + m]);
        mx = warp_max(mx);
        for (int m = lane; m < M; m += 32)
          pq[i * MP + m] = i < n ? rnd<T>(expf(pq[i * MP + m] - mx) * rsqm) : 0.f;
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
            pk[i * MP + m] = i < n ? expf(acc[r][c] - sq[i] - kmax) * rsqm : 0.f;
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

template <class T, bool HL>
int launch_kmax(const void* k, const float* omega, float* partial, int BH, int H, int L,
                int Dh, int M, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (Dh * M + C * (Dh + 1) + C + 32);
  cudaError_t err = allow_smem(favor_kmax_kernel<T, HL>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + C - 1) / C, BH);
  favor_kmax_kernel<T, HL><<<grid, THREADS, smem, stream>>>(static_cast<const T*>(k), omega,
                                                        partial, L, Dh, M, H,
                                                        feature_scale(Dh));
  return (int)cudaGetLastError();
}

template <class T, bool HL>
int launch_fwd(const void* q, const void* k, const void* v, const float* omega,
               const float* partial, void* out, int BH, int H, int L, int Dh, int Dv, int M,
               float eps, cudaStream_t stream) {
  // omega padded to [Dh][M+1] under bf16 (favor_tc.cuh's features_tc)
  const int om_cols = std::is_same<T, __nv_bfloat16>::value ? M + 1 : M;
  const size_t smem = sizeof(float) * (Dh * om_cols + M * (Dv + 1) + M + 2 * C * (M + 1) +
                                       C * (Dv + 1) + C * (Dh + 1) + C * (C + 1) + 2 * C + 32);
  cudaError_t err = allow_smem(favor_fwd_kernel<T, HL>, smem);
  if (err != cudaSuccess) return (int)err;
  favor_fwd_kernel<T, HL><<<BH, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), omega,
      partial, static_cast<T*>(out), L, Dh, Dv, M, H, feature_scale(Dh),
      (float)(1.0 / sqrt((double)M)), eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* emodis_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// k [BH, L, Dh] (f32, or bf16 when bf16 != 0), omega [Dh, M] f32 ->
// partial [BH, ceil(L/64)] f32: the key max of each 64-row chunk.
int favor_kmax(const void* k, const float* omega, float* partial, int BH, int L, int Dh,
               int M, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_kmax<__nv_bfloat16, false>(k, omega, partial, BH, 1, L, Dh, M, s)
              : launch_kmax<float, false>(k, omega, partial, BH, 1, L, Dh, M, s);
}

// heads-last: k [B, L, H * Dh] -> partial [B * H, ceil(L/64)] f32, row b * H + h.
int favor_kmax_hl(const void* k, const float* omega, float* partial, int B, int H, int L,
                  int Dh, int M, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_kmax<__nv_bfloat16, true>(k, omega, partial, B * H, H, L, Dh, M, s)
              : launch_kmax<float, true>(k, omega, partial, B * H, H, L, Dh, M, s);
}

// q, k [BH, L, Dh], v [BH, L, Dv] (one dtype), omega [Dh, M] f32, partial from
// favor_kmax -> out [BH, L, Dv] in the inputs' dtype.
int favor_fwd(const void* q, const void* k, const void* v, const float* omega,
              const float* partial, void* out, int BH, int L, int Dh, int Dv, int M, int bf16,
              float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<__nv_bfloat16, false>(q, k, v, omega, partial, out, BH, 1, L, Dh,
                                                 Dv, M, eps, s)
              : launch_fwd<float, false>(q, k, v, omega, partial, out, BH, 1, L, Dh, Dv, M,
                                         eps, s);
}

// heads-last: q, k, v [B, L, H * Dh] (one dtype), omega [Dh, M] f32, partial
// from favor_kmax_hl -> out [B, L, H * Dh] in the inputs' dtype.
int favor_fwd_hl(const void* q, const void* k, const void* v, const float* omega,
                 const float* partial, void* out, int B, int H, int L, int Dh, int M, int bf16,
                 float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<__nv_bfloat16, true>(q, k, v, omega, partial, out, B * H, H, L,
                                                Dh, Dh, M, eps, s)
              : launch_fwd<float, true>(q, k, v, omega, partial, out, B * H, H, L, Dh, Dh, M,
                                        eps, s);
}

}  // extern "C"
