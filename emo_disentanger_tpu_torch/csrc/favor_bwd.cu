// FAVOR+ causal linear attention, backward, for Hopper (sm_90a).
//
// Replaces four Pallas TPU kernels of emo_disentanger_tpu/ops/linear_attention.py:
//   _fused_bwd_a_kernel    (:578, via _fused_bwd_impl :789) -> favor_bwd_a_kernel
//   _fused_bwd_b_kernel    (:644, via _fused_bwd_impl :803) -> favor_bwd_b_kernel
//   _fused_bwd_a_kernel_hl (:1027, via _hl_bwd_impl :1239)  -> favor_bwd_a_kernel
//   _fused_bwd_b_kernel_hl (:1099, via _hl_bwd_impl :1253)  -> favor_bwd_b_kernel
// favor_bwd_a / favor_bwd_b take head-major [BH, L, Dh] rows; favor_bwd_a_hl /
// favor_bwd_b_hl take the heads-last [B, L, H * Dh] tensors (q, k, v, g, u, dq,
// dk, dv) and share the kernel bodies, each (b, h) row addressing head h's
// columns in place (row_base in favor_common.cuh).  w stays [B * H, L] and
// the key maxima [B * H, n] in both layouts.  The TPU's (u, w) residual of
// the heads-last kernels packs [B, L, H * 128]; here u is [B, L, H * Dh] and
// w its own tensor, in the same bf16 rounding.  The layout is a template flag
// (HL), so the head-major instances fold H = 1 at compile time and keep the
// code they had before the heads-last form.
//
// Function (per batch*head row; phi_q, phi_k the feature maps of favor_fwd.cu,
// out_i = N_i / D_i with N_i = phi_q_i . S_i, D_i = phi_q_i . z_i + eps and the
// causal prefix states S_i = sum_{j<=i} phi_k_j v_j^T, z_i = sum_{j<=i} phi_k_j;
// g = dL/dout):
//   pass A, chunks in order, carrying (S, z):
//     u_i = g_i / D_i,  w_i = -(g_i . out_i) / D_i       (the residual for pass B)
//     dphi_q_i = sum_{j<=i} a_ij phi_k_j + S_prev u_i + w_i z_prev,
//                a_ij = u_i . v_j + w_i   (j in the chunk)
//   pass B, chunks in reverse, carrying the suffix states
//     R = sum_{i>=j} phi_q_i u_i^T [M, Dv],  r = sum_{i>=j} w_i phi_q_i [M]:
//     dv_j = sum_{i>=j} p_ij u_i + R_next^T phi_k_j,  p_ij = phi_q_i . phi_k_j
//     dphi_k_j = sum_{i>=j} a_ij phi_q_i + R_next v_j + r_next
//   both: dx = d^-1/4 ((dphi * phi) . omega^T - rowsum(dphi * phi) xs), the chain
//   rule through phi = exp(xs . omega - ||xs||^2/2) with the stabilizers held
//   constant (xs = x d^-1/4).
// The key stabilizer is the forward's: the favor_kmax partial maxima, reduced
// here as favor_fwd does.  Rows past L (the ragged last chunk) are masked to
// zero, so they add nothing to any state or product.
//
// Bound on the H100: each row reads q, k, v, g (pass A) or q, k, v, u, w
// (pass B) once and writes dq, u, w or dk, dv: a few MB at the training
// shapes.  Each pass recomputes both feature maps and the chain rule in f32
// (67 TFLOP/s on the CUDA cores; under bf16 3xTF32 on the tensor cores,
// 495 TFLOP/s a pass) and runs about twice the forward's chunk products,
// so both passes are bounded by operations, like favor_fwd.
//
// Design (simple first, as favor_fwd): one thread block per row loops over
// 64-row chunks, the TPU grid's sequential chunk axis.  The carried state,
// omega and the chunk's tiles live in shared memory, rows padded +1 against
// bank conflicts (omega too, as it is read both along M and along Dh).  At
// Dh = Dv = 64, M = 128 pass A holds 217 KB and pass B 200 KB of the 227 KB
// a block may use; that fits by reusing tiles in place: the scores become
// the a matrix once they are consumed, g becomes u, and phi becomes
// dphi * phi (which is all that dx needs), so dphi itself is never stored.
// Products are 4x4 register micro-tiles (mma4x4) in f32; under bf16, both
// passes run on the tensor cores (below).  No TMA or pipelining yet, and
// one block per row leaves SMs idle below B*H = 132.
//
// Both passes under bf16 run on the tensor cores with the helpers of
// favor_tc.cuh (its note has the fragments and the bank map): the five
// products of each pass whose operands the TPU rounds to bf16 on tc_mma,
// the omega products (the two feature maps and the chain rule) in 3xTF32
// on tc_mma_f32.  Pass A's are the scores phi_q phi_k^T, the numerator
// sc v + phi_q S, the a matrix u v^T, dphi_q = a phi_k + u S^T and the
// state update S += phi_k^T v; pass B's the scores, dv = p^T u + phi_k R,
// the a matrix, dphi_k = a^T phi_q + v R^T and the state update R +=
// phi_q^T u.  A pass's 200-217 KB of shared memory allow one block an SM,
// and B*H = 128 rows already take 128 of the 132 SMs, so more blocks per
// row cannot help: the lever is the work inside the SM.  The causal
// products skip the groups above the diagonal and run K only to the
// group's last row, and pass B's suffix products start K at the group's
// first row j0 (tc_mma on pointers offset by j0 rows, K = C - j0), the
// masked zeros of sc covering i < j inside the diagonal group; pass B's
// p^T and a^T read sc[i][j] with k = i, each step of k moving CP = 65 = 1
// mod 32 banks.  The q, k, v and g (pass B: u) rows come in by 16-byte
// loads.  The denominator and ||x||^2 are a warp a row, the z and r
// updates four lanes a feature.  The f32 instantiations keep the mma4x4
// path, bit for bit.
//
// bf16: under bf16 inputs the operands the TPU kernels round are rounded
// (_dot_dtype_for): phi_q, phi_k, the scores, a, u, S and R, with f32
// accumulation; z is rounded as an operand of the denominator's product
// (phi_q . z), as the TPU kernel does, and kept f32 in the w z term;
// omega's product, w and r stay f32.  u and w are stored
// in bf16 (the TPU's bf16 uw residual), and pass B reads them back rounded.

#include <type_traits>

#include "favor_common.cuh"
#include "favor_tc.cuh"

namespace {

// phi[i][m] = exp(h_im - stab_i) / sqrt(M) for rows i < n and 0 beyond, with
// h = xs . omega - sq and stab_i = max_m h_im (queries) or kmax (keys).
// omega is [Dh][M+1] in shared memory.  Ends with __syncthreads().
template <bool QUERY>
__device__ void features(float* phi, const float* xs, const float* sq, const float* om,
                         int n, int Dh, int M, float kmax, float rsqm) {
  const int MP = M + 1, NT = M / 4;
  for (int t = threadIdx.x; t < (C / 4) * NT; t += blockDim.x) {
    const int it = t / NT, jt = t - it * NT;
    float acc[4][4];
    zero4x4(acc);
    mma4x4<float, false, false>(acc, xs, Dh + 1, 1, it, C / 4, om, MP, 1, jt, NT, Dh);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = it + r * (C / 4), m = jt + c * NT;
        const float h = acc[r][c] - sq[i];
        phi[i * MP + m] = QUERY ? h : (i < n ? expf(h - kmax) * rsqm : 0.f);
      }
  }
  __syncthreads();
  if (QUERY) {
    const int lane = threadIdx.x & 31, nwarp = blockDim.x >> 5;
    for (int i = threadIdx.x >> 5; i < C; i += nwarp) {
      float mx = -INFINITY;
      for (int m = lane; m < M; m += 32) mx = fmaxf(mx, phi[i * MP + m]);
      mx = warp_max(mx);
      for (int m = lane; m < M; m += 32)
        phi[i * MP + m] = i < n ? expf(phi[i * MP + m] - mx) * rsqm : 0.f;
    }
    __syncthreads();
  }
}

// sc[i][j] = phi_q_i . phi_k_j for j <= i, else 0 (dot operands rounded)
template <class T>
__device__ void causal_scores(float* sc, const float* pq, const float* pk, int M) {
  const int MP = M + 1, CP = C + 1;
  for (int t = threadIdx.x; t < (C / 4) * (C / 4); t += blockDim.x) {
    const int it = t / (C / 4), jt = t - it * (C / 4);
    float acc[4][4];
    zero4x4(acc);
    mma4x4<T, true, true>(acc, pq, MP, 1, it, C / 4, pk, 1, MP, jt, C / 4, M);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = it + r * (C / 4), j = jt + c * (C / 4);
        sc[i * CP + j] = j <= i ? acc[r][c] : 0.f;
      }
  }
}

// sc[i][j] = u_i . v_j + w_i for j <= i, else 0 (u rounded, v from the inputs)
__device__ void a_matrix(float* sc, const float* uu, const float* vv, const float* wv,
                         int Dv) {
  const int DVP = Dv + 1, CP = C + 1;
  for (int t = threadIdx.x; t < (C / 4) * (C / 4); t += blockDim.x) {
    const int it = t / (C / 4), jt = t - it * (C / 4);
    float acc[4][4];
    zero4x4(acc);
    mma4x4<float, false, false>(acc, uu, DVP, 1, it, C / 4, vv, 1, DVP, jt, C / 4, Dv);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = it + r * (C / 4), j = jt + c * (C / 4);
        sc[i * CP + j] = j <= i ? acc[r][c] + wv[i] : 0.f;
      }
  }
}

// rs[i] = sum_m t[i][m], then dx[i * ld + d] = scale * (t_i . omega_d - rs[i] xs[i][d])
// for rows i < n.  t [C][M+1] and omega [Dh][M+1] in shared memory.
template <class T>
__device__ void chain_rule(T* dx, const float* t, const float* xs, const float* om, float* rs,
                           int n, int Dh, int ld, int M, float scale) {
  const int MP = M + 1, XP = Dh + 1, lane = threadIdx.x & 31, nwarp = blockDim.x >> 5;
  for (int i = threadIdx.x >> 5; i < C; i += nwarp) {
    float s = 0.f;
    for (int m = lane; m < M; m += 32) s += t[i * MP + m];
    s = warp_sum(s);
    if (lane == 0) rs[i] = s;
  }
  __syncthreads();
  for (int u = threadIdx.x; u < (C / 4) * (Dh / 4); u += blockDim.x) {
    const int it = u / (Dh / 4), jt = u - it * (Dh / 4);
    float acc[4][4];
    zero4x4(acc);
    mma4x4<float, false, false>(acc, t, MP, 1, it, C / 4, om, 1, MP, jt, Dh / 4, M);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = it + r * (C / 4);
      if (i < n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int d = jt + c * (Dh / 4);
          dx[(size_t)i * ld + d] = from_f<T>(scale * (acc[r][c] - rs[i] * xs[i * XP + d]));
        }
    }
  }
}

// chain_rule's function for the bf16 instantiations, t . omega^T in
// 3xTF32 (tc_mma_f32)
__device__ void chain_rule_tc(__nv_bfloat16* dx, const float* t, const float* xs,
                              const float* om, float* rs, int n, int Dh, int ld, int M,
                              float scale) {
  const int MP = M + 1, XP = Dh + 1, lane = threadIdx.x & 31, nwarp = blockDim.x >> 5;
  for (int i = threadIdx.x >> 5; i < C; i += nwarp) {
    float s = 0.f;
    for (int m = lane; m < M; m += 32) s += t[i * MP + m];
    s = warp_sum(s);
    if (lane == 0) rs[i] = s;
  }
  __syncthreads();
  tc_groups(C, Dh, [&](float (*acc)[4], int i0, int j0) {
    tc_mma_f32<2>(acc, t, MP, 1, i0, om, 1, MP, j0, M);
    tc_each<2>(acc, i0, j0, [&](int i, int d, float x) {
      if (i < n) dx[(size_t)i * ld + d] = __float2bfloat16(scale * (x - rs[i] * xs[i * XP + d]));
    });
  });
}

template <class T, bool HL>
__global__ void favor_bwd_a_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                   const T* __restrict__ v, const T* __restrict__ g,
                                   const float* __restrict__ omega,
                                   const float* __restrict__ partial, T* __restrict__ dq,
                                   T* __restrict__ u_out, T* __restrict__ w_out, int L,
                                   int Dh, int Dv, int M, int n_head, int np, float scale,
                                   float rsqm, float eps) {
  // bf16: the bf16-operand products on the tensor cores (Dh, Dv, M
  // multiples of 16, which the wrappers check)
  constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ float smem[];
  const int H = HL ? n_head : 1;
  const int MP = M + 1, DVP = Dv + 1, XP = Dh + 1, CP = C + 1;
  float* om = smem;                    // [Dh][M+1]
  float* S = om + Dh * MP;             // [M][Dv+1]   running sum phi_k v^T
  float* z = S + M * DVP;              // [M]         running sum phi_k
  float* pq = z + M;                   // [C][M+1]    phi_q, then dphi_q * phi_q
  float* pk = pq + C * MP;             // [C][M+1]    phi_k
  float* xs = pk + C * MP;             // [C][Dh+1]   scaled k, then scaled q
  float* vv = xs + C * XP;             // [C][Dv+1]
  float* gu = vv + C * DVP;            // [C][Dv+1]   g, then u (rounded)
  float* go = gu + C * DVP;            // [C][Dv+1]   g * out
  float* sc = go + C * DVP;            // [C][C+1]    masked scores, then a
  float* sq = sc + C * CP;             // [C]
  float* den = sq + C;                 // [C]
  float* wv = den + C;                 // [C]
  float* rs = wv + C;                  // [C]
  const int tid = threadIdx.x, lane = tid & 31, nwarp = blockDim.x >> 5;
  const float kmax = setup(om, omega, S, z, partial, Dh, Dv, M, np);
  const int ldx = H * Dh, ldv = H * Dv;
  const size_t xb = row_base(blockIdx.x, H, L, Dh), vb = row_base(blockIdx.x, H, L, Dv);
  q += xb;                             // this row's first position
  k += xb;
  dq += xb;
  v += vb;
  g += vb;
  u_out += vb;
  w_out += (size_t)blockIdx.x * L;

  for (int r0 = 0; r0 < L; r0 += C) {
    const int n = min(C, L - r0);

    // phi_k, the v and g rows, then phi_q (xs keeps the scaled q for dq)
    if constexpr (TC) {
      load_rows_tc(xs, k + (size_t)r0 * ldx, n, Dh, ldx, scale);
      load_rows_tc(vv, v + (size_t)r0 * ldv, n, Dv, ldv, 1.f);
      load_rows_tc(gu, g + (size_t)r0 * ldv, n, Dv, ldv, 1.f);
      __syncthreads();
      row_sq_tc(sq, xs, Dh);
      features_tc<false>(pk, xs, sq, om, n, Dh, M, kmax, rsqm);
      load_rows_tc(xs, q + (size_t)r0 * ldx, n, Dh, ldx, scale);
      __syncthreads();
      row_sq_tc(sq, xs, Dh);
      features_tc<true>(pq, xs, sq, om, n, Dh, M, kmax, rsqm);
    } else {
      load_scaled<T>(xs, sq, k + (size_t)r0 * ldx, n, Dh, ldx, scale);
      features<false>(pk, xs, sq, om, n, Dh, M, kmax, rsqm);
      for (int idx = tid; idx < C * Dv; idx += blockDim.x) {
        const int i = idx / Dv, d = idx - i * Dv;
        const size_t at = (size_t)(r0 + i) * ldv + d;
        vv[i * DVP + d] = i < n ? to_f<T>(v[at]) : 0.f;
        gu[i * DVP + d] = i < n ? to_f<T>(g[at]) : 0.f;
      }
      load_scaled<T>(xs, sq, q + (size_t)r0 * ldx, n, Dh, ldx, scale);
      features<true>(pq, xs, sq, om, n, Dh, M, kmax, rsqm);
    }

    if constexpr (TC) {
      // sc = phi_q phi_k^T, masked to j <= i
      tc_groups(C, C, [&](float (*acc)[4], int i0, int j0) {
        if (j0 <= i0) tc_mma<2>(acc, pq, MP, 1, i0, pk, 1, MP, j0, M);
        tc_each<2>(acc, i0, j0,
                   [&](int i, int j, float x) { sc[i * CP + j] = j <= i ? x : 0.f; });
      });
      __syncthreads();

      // den_i = sum_{j<=i} sc_ij + phi_q_i . z + eps, a warp per row
      for (int i = tid >> 5; i < C; i += nwarp) {
        float s = 0.f, t = 0.f;
        for (int j = lane; j < C; j += 32) s += sc[i * CP + j];
        for (int m = lane; m < M; m += 32) t = fmaf(rnd<T>(pq[i * MP + m]), rnd<T>(z[m]), t);
        s = warp_sum(s);
        t = warp_sum(t);
        if (lane == 0) den[i] = s + t + eps;
      }
      __syncthreads();

      // out_i = (sc_i . v + phi_q_i . S) / den_i; go = g * out; u = g / den
      tc_groups(C, Dv, [&](float (*acc)[4], int i0, int j0) {
        tc_mma<2>(acc, sc, CP, 1, i0, vv, DVP, 1, j0, i0 + 16);
        tc_mma<2>(acc, pq, MP, 1, i0, S, DVP, 1, j0, M);
        tc_each<2>(acc, i0, j0, [&](int i, int d, float x) {
          const float gv = gu[i * DVP + d], u = gv / den[i];
          go[i * DVP + d] = gv * (x / den[i]);
          gu[i * DVP + d] = rnd<T>(u);
          if (i < n) u_out[(size_t)(r0 + i) * ldv + d] = from_f<T>(u);
        });
      });
      __syncthreads();
    } else {
      causal_scores<T>(sc, pq, pk, M);
      __syncthreads();

      // den_i = sum_{j<=i} sc_ij + phi_q_i . z + eps
      for (int i = tid; i < C; i += blockDim.x) {
        float s = 0.f, t = 0.f;
        for (int j = 0; j <= i; ++j) s += sc[i * CP + j];
        for (int m = 0; m < M; ++m) t = fmaf(rnd<T>(pq[i * MP + m]), rnd<T>(z[m]), t);
        den[i] = s + t + eps;
      }
      __syncthreads();

      // out_i = (sc_i . v + phi_q_i . S) / den_i; go = g * out; u = g / den
      for (int t = tid; t < (C / 4) * (Dv / 4); t += blockDim.x) {
        const int it = t / (Dv / 4), jt = t - it * (Dv / 4);
        float acc[4][4];
        zero4x4(acc);
        mma4x4<T, true, false>(acc, sc, CP, 1, it, C / 4, vv, DVP, 1, jt, Dv / 4, n);
        mma4x4<T, true, true>(acc, pq, MP, 1, it, C / 4, S, DVP, 1, jt, Dv / 4, M);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = it + r * (C / 4);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int d = jt + c * (Dv / 4);
            const float gv = gu[i * DVP + d], u = gv / den[i];
            go[i * DVP + d] = gv * (acc[r][c] / den[i]);
            gu[i * DVP + d] = rnd<T>(u);
            if (i < n) u_out[(size_t)(r0 + i) * ldv + d] = from_f<T>(u);
          }
        }
      }
      __syncthreads();
    }

    // w_i = -(g_i . out_i) / den_i, a warp per row
    for (int i = tid >> 5; i < C; i += nwarp) {
      float s = 0.f;
      for (int d = lane; d < Dv; d += 32) s += go[i * DVP + d];
      s = warp_sum(s);
      if (lane == 0) {
        const float w = -s / den[i];
        wv[i] = w;
        if (i < n) w_out[r0 + i] = from_f<T>(w);
      }
    }
    __syncthreads();

    // dphi_q = a . phi_k + u . S^T + w z, kept as dphi_q * phi_q in pq
    if constexpr (TC) {
      // a_ij = u_i . v_j + w_i for j <= i, into sc
      tc_groups(C, C, [&](float (*acc)[4], int i0, int j0) {
        if (j0 <= i0) tc_mma<2>(acc, gu, DVP, 1, i0, vv, 1, DVP, j0, Dv);
        tc_each<2>(acc, i0, j0,
                   [&](int i, int j, float x) { sc[i * CP + j] = j <= i ? x + wv[i] : 0.f; });
      });
      __syncthreads();
      tc_groups(C, M, [&](float (*acc)[4], int i0, int j0) {
        tc_mma<2>(acc, sc, CP, 1, i0, pk, MP, 1, j0, i0 + 16);
        tc_mma<2>(acc, gu, DVP, 1, i0, S, 1, DVP, j0, Dv);
        tc_each<2>(acc, i0, j0,
                   [&](int i, int m, float x) { pq[i * MP + m] *= x + wv[i] * z[m]; });
      });
    } else {
      a_matrix(sc, gu, vv, wv, Dv);
      __syncthreads();
      for (int t = tid; t < (C / 4) * (M / 4); t += blockDim.x) {
        const int it = t / (M / 4), jt = t - it * (M / 4);
        float acc[4][4];
        zero4x4(acc);
        mma4x4<T, true, true>(acc, sc, CP, 1, it, C / 4, pk, MP, 1, jt, M / 4, n);
        mma4x4<T, false, true>(acc, gu, DVP, 1, it, C / 4, S, 1, DVP, jt, M / 4, Dv);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = it + r * (C / 4), m = jt + c * (M / 4);
            pq[i * MP + m] *= acc[r][c] + wv[i] * z[m];
          }
      }
    }
    __syncthreads();

    // dq through the feature map, then S += phi_k^T v, z += sum_j phi_k_j
    // (chain_rule reads neither)
    if constexpr (TC) {
      chain_rule_tc(dq + (size_t)r0 * ldx, pq, xs, om, rs, n, Dh, ldx, M, scale);
      tc_groups(M, Dv, [&](float (*acc)[4], int i0, int j0) {
        tc_mma<2>(acc, pk, 1, MP, i0, vv, DVP, 1, j0, C);
        tc_each<2>(acc, i0, j0, [&](int m, int d, float x) { S[m * DVP + d] += x; });
      });
      add_col_sums_tc(z, pk, M);
    } else {
      chain_rule<T>(dq + (size_t)r0 * ldx, pq, xs, om, rs, n, Dh, ldx, M, scale);
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
__global__ void favor_bwd_b_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                   const T* __restrict__ v, const T* __restrict__ u,
                                   const T* __restrict__ w, const float* __restrict__ omega,
                                   const float* __restrict__ partial, T* __restrict__ dk,
                                   T* __restrict__ dv, int L, int Dh, int Dv, int M,
                                   int n_head, int np, float scale, float rsqm) {
  // bf16: pass A's tensor-core design (Dh, Dv, M multiples of 16, which
  // the wrappers check)
  constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ float smem[];
  const int H = HL ? n_head : 1;
  const int MP = M + 1, DVP = Dv + 1, XP = Dh + 1, CP = C + 1;
  float* om = smem;                    // [Dh][M+1]
  float* R = om + Dh * MP;             // [M][Dv+1]   suffix sum phi_q u^T
  float* r = R + M * DVP;              // [M]         suffix sum w phi_q
  float* pq = r + M;                   // [C][M+1]    phi_q
  float* pk = pq + C * MP;             // [C][M+1]    phi_k, then dphi_k * phi_k
  float* xs = pk + C * MP;             // [C][Dh+1]   scaled q, then scaled k
  float* vv = xs + C * XP;             // [C][Dv+1]
  float* uu = vv + C * DVP;            // [C][Dv+1]
  float* sc = uu + C * DVP;            // [C][C+1]    p, then a
  float* sq = sc + C * CP;             // [C]
  float* wv = sq + C;                  // [C]
  float* rs = wv + C;                  // [C]
  const int tid = threadIdx.x, lane = tid & 31;
  const float kmax = setup(om, omega, R, r, partial, Dh, Dv, M, np);
  const int ldx = H * Dh, ldv = H * Dv;
  const size_t xb = row_base(blockIdx.x, H, L, Dh), vb = row_base(blockIdx.x, H, L, Dv);
  q += xb;                             // this row's first position
  k += xb;
  dk += xb;
  v += vb;
  u += vb;
  dv += vb;
  w += (size_t)blockIdx.x * L;

  for (int r0 = ((L - 1) / C) * C; r0 >= 0; r0 -= C) {
    const int n = min(C, L - r0);

    // phi_q, then phi_k (xs keeps the scaled k for dk), the v, u and w rows
    if constexpr (TC) {
      load_rows_tc(xs, q + (size_t)r0 * ldx, n, Dh, ldx, scale);
      load_rows_tc(vv, v + (size_t)r0 * ldv, n, Dv, ldv, 1.f);
      load_rows_tc(uu, u + (size_t)r0 * ldv, n, Dv, ldv, 1.f);
      for (int i = tid; i < C; i += blockDim.x) wv[i] = i < n ? to_f<T>(w[r0 + i]) : 0.f;
      __syncthreads();
      row_sq_tc(sq, xs, Dh);
      features_tc<true>(pq, xs, sq, om, n, Dh, M, kmax, rsqm);
      load_rows_tc(xs, k + (size_t)r0 * ldx, n, Dh, ldx, scale);
      __syncthreads();
      row_sq_tc(sq, xs, Dh);
      features_tc<false>(pk, xs, sq, om, n, Dh, M, kmax, rsqm);

      // sc = phi_q phi_k^T, masked to j <= i
      tc_groups(C, C, [&](float (*acc)[4], int i0, int j0) {
        if (j0 <= i0) tc_mma<2>(acc, pq, MP, 1, i0, pk, 1, MP, j0, M);
        tc_each<2>(acc, i0, j0,
                   [&](int i, int j, float x) { sc[i * CP + j] = j <= i ? x : 0.f; });
      });
      __syncthreads();

      // dv_j = sum_{i>=j} p_ij u_i + phi_k_j . R: the suffix product reads
      // sc transposed from the group's first row j0 on (the masked zeros of
      // sc cover i < j), each lane storing two adjacent bf16 values at once
      tc_groups(C, Dv, [&](float (*acc)[4], int j0, int d0) {
        tc_mma<2>(acc, sc + j0 * CP, 1, CP, j0, uu + j0 * DVP, DVP, 1, d0, C - j0);
        tc_mma<2>(acc, pk, MP, 1, j0, R, DVP, 1, d0, M);
        const int g = lane >> 2, t = lane & 3;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = j0 + g + 8 * h, d = d0 + 8 * nt + 2 * t;
            if (j < n)
              *reinterpret_cast<__nv_bfloat162*>(dv + (size_t)(r0 + j) * ldv + d) =
                  __floats2bfloat162_rn(acc[nt][2 * h], acc[nt][2 * h + 1]);
          }
      });
      __syncthreads();

      // a_ij = u_i . v_j + w_i for j <= i, into sc
      tc_groups(C, C, [&](float (*acc)[4], int i0, int j0) {
        if (j0 <= i0) tc_mma<2>(acc, uu, DVP, 1, i0, vv, 1, DVP, j0, Dv);
        tc_each<2>(acc, i0, j0,
                   [&](int i, int j, float x) { sc[i * CP + j] = j <= i ? x + wv[i] : 0.f; });
      });
      __syncthreads();

      // dphi_k_j = sum_{i>=j} a_ij phi_q_i + v_j . R^T + r, kept as
      // dphi_k * phi_k in pk
      tc_groups(C, M, [&](float (*acc)[4], int j0, int m0) {
        tc_mma<2>(acc, sc + j0 * CP, 1, CP, j0, pq + j0 * MP, MP, 1, m0, C - j0);
        tc_mma<2>(acc, vv, DVP, 1, j0, R, 1, DVP, m0, Dv);
        tc_each<2>(acc, j0, m0, [&](int j, int m, float x) { pk[j * MP + m] *= x + r[m]; });
      });
      __syncthreads();

      // dk through the key feature map, then R += phi_q^T u, r += sum_i
      // w_i phi_q_i (chain_rule_tc reads neither)
      chain_rule_tc(dk + (size_t)r0 * ldx, pk, xs, om, rs, n, Dh, ldx, M, scale);
      tc_groups(M, Dv, [&](float (*acc)[4], int m0, int d0) {
        tc_mma<2>(acc, pq, 1, MP, m0, uu, DVP, 1, d0, C);
        tc_each<2>(acc, m0, d0, [&](int m, int d, float x) { R[m * DVP + d] += x; });
      });
      add_wcol_sums_tc(r, pq, wv, M);
    } else {
      load_scaled<T>(xs, sq, q + (size_t)r0 * ldx, n, Dh, ldx, scale);
      features<true>(pq, xs, sq, om, n, Dh, M, kmax, rsqm);
      load_scaled<T>(xs, sq, k + (size_t)r0 * ldx, n, Dh, ldx, scale);
      features<false>(pk, xs, sq, om, n, Dh, M, kmax, rsqm);
      for (int idx = tid; idx < C * Dv; idx += blockDim.x) {
        const int i = idx / Dv, d = idx - i * Dv;
        const size_t at = (size_t)(r0 + i) * ldv + d;
        vv[i * DVP + d] = i < n ? to_f<T>(v[at]) : 0.f;
        uu[i * DVP + d] = i < n ? to_f<T>(u[at]) : 0.f;
      }
      for (int i = tid; i < C; i += blockDim.x) wv[i] = i < n ? to_f<T>(w[r0 + i]) : 0.f;
      causal_scores<T>(sc, pq, pk, M);
      __syncthreads();

      // dv_j = sum_{i>=j} p_ij u_i + phi_k_j . R
      for (int t = tid; t < (C / 4) * (Dv / 4); t += blockDim.x) {
        const int it = t / (Dv / 4), jt = t - it * (Dv / 4);
        float acc[4][4];
        zero4x4(acc);
        mma4x4<T, true, false>(acc, sc, 1, CP, it, C / 4, uu, DVP, 1, jt, Dv / 4, n);
        mma4x4<T, true, true>(acc, pk, MP, 1, it, C / 4, R, DVP, 1, jt, Dv / 4, M);
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int j = it + rr * (C / 4);
          if (j < n)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int d = jt + c * (Dv / 4);
              dv[(size_t)(r0 + j) * ldv + d] = from_f<T>(acc[rr][c]);
            }
        }
      }
      __syncthreads();

      a_matrix(sc, uu, vv, wv, Dv);
      __syncthreads();

      // dphi_k_j = sum_{i>=j} a_ij phi_q_i + v_j . R^T + r, kept as
      // dphi_k * phi_k in pk
      for (int t = tid; t < (C / 4) * (M / 4); t += blockDim.x) {
        const int it = t / (M / 4), jt = t - it * (M / 4);
        float acc[4][4];
        zero4x4(acc);
        mma4x4<T, true, true>(acc, sc, 1, CP, it, C / 4, pq, MP, 1, jt, M / 4, n);
        mma4x4<T, false, true>(acc, vv, DVP, 1, it, C / 4, R, 1, DVP, jt, M / 4, Dv);
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = it + rr * (C / 4), m = jt + c * (M / 4);
            pk[j * MP + m] *= acc[rr][c] + r[m];
          }
      }
      __syncthreads();

      chain_rule<T>(dk + (size_t)r0 * ldx, pk, xs, om, rs, n, Dh, ldx, M, scale);

      // R += phi_q^T u, r += sum_i w_i phi_q_i (chain_rule reads neither)
      for (int t = tid; t < (M / 4) * (Dv / 4); t += blockDim.x) {
        const int it = t / (Dv / 4), jt = t - it * (Dv / 4);
        float acc[4][4];
        zero4x4(acc);
        mma4x4<T, true, false>(acc, pq, 1, MP, it, M / 4, uu, DVP, 1, jt, Dv / 4, n);
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            R[(it + rr * (M / 4)) * DVP + jt + c * (Dv / 4)] += acc[rr][c];
      }
      for (int m = tid; m < M; m += blockDim.x) {
        float s = 0.f;
        for (int i = 0; i < n; ++i) s = fmaf(wv[i], pq[i * MP + m], s);
        r[m] += s;
      }
    }
    __syncthreads();
  }
}

template <class T, bool HL>
int launch_bwd_a(const void* q, const void* k, const void* v, const void* g,
                 const float* omega, const float* partial, void* dq, void* u, void* w, int BH,
                 int H, int L, int Dh, int Dv, int M, int np, float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (Dh * (M + 1) + M * (Dv + 1) + M + 2 * C * (M + 1) +
                                       C * (Dh + 1) + 3 * C * (Dv + 1) + C * (C + 1) + 4 * C);
  cudaError_t err = allow_smem(favor_bwd_a_kernel<T, HL>, smem);
  if (err != cudaSuccess) return (int)err;
  favor_bwd_a_kernel<T, HL><<<BH, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), omega, partial, static_cast<T*>(dq), static_cast<T*>(u),
      static_cast<T*>(w), L, Dh, Dv, M, H, np, feature_scale(Dh),
      (float)(1.0 / sqrt((double)M)), eps);
  return (int)cudaGetLastError();
}

template <class T, bool HL>
int launch_bwd_b(const void* q, const void* k, const void* v, const void* u, const void* w,
                 const float* omega, const float* partial, void* dk, void* dv, int BH, int H,
                 int L, int Dh, int Dv, int M, int np, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (Dh * (M + 1) + M * (Dv + 1) + M + 2 * C * (M + 1) +
                                       C * (Dh + 1) + 2 * C * (Dv + 1) + C * (C + 1) + 3 * C);
  cudaError_t err = allow_smem(favor_bwd_b_kernel<T, HL>, smem);
  if (err != cudaSuccess) return (int)err;
  favor_bwd_b_kernel<T, HL><<<BH, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(u), static_cast<const T*>(w), omega, partial,
      static_cast<T*>(dk), static_cast<T*>(dv), L, Dh, Dv, M, H, np, feature_scale(Dh),
      (float)(1.0 / sqrt((double)M)));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* emodis_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// q, k [BH, L, Dh], v, g [BH, L, Dv] (one dtype: f32, or bf16 when bf16 != 0),
// omega [Dh, M] f32, partial [BH, np] f32 from favor_kmax ->
// dq [BH, L, Dh], u [BH, L, Dv], w [BH, L] in the inputs' dtype.
int favor_bwd_a(const void* q, const void* k, const void* v, const void* g,
                const float* omega, const float* partial, void* dq, void* u, void* w, int BH,
                int L, int Dh, int Dv, int M, int np, int bf16, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd_a<__nv_bfloat16, false>(q, k, v, g, omega, partial, dq, u, w, BH, 1,
                                                   L, Dh, Dv, M, np, eps, s)
              : launch_bwd_a<float, false>(q, k, v, g, omega, partial, dq, u, w, BH, 1, L, Dh,
                                           Dv, M, np, eps, s);
}

// heads-last: q, k, v, g [B, L, H * Dh] (one dtype), omega [Dh, M] f32, partial
// [B * H, np] f32 from favor_kmax_hl -> dq, u [B, L, H * Dh] and w [B * H, L] in
// the inputs' dtype.
int favor_bwd_a_hl(const void* q, const void* k, const void* v, const void* g,
                   const float* omega, const float* partial, void* dq, void* u, void* w, int B,
                   int H, int L, int Dh, int M, int np, int bf16, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd_a<__nv_bfloat16, true>(q, k, v, g, omega, partial, dq, u, w, B * H,
                                                  H, L, Dh, Dh, M, np, eps, s)
              : launch_bwd_a<float, true>(q, k, v, g, omega, partial, dq, u, w, B * H, H, L,
                                          Dh, Dh, M, np, eps, s);
}

// q, k, v as for favor_bwd_a, u [BH, L, Dv] and w [BH, L] from it ->
// dk [BH, L, Dh], dv [BH, L, Dv] in the inputs' dtype.
int favor_bwd_b(const void* q, const void* k, const void* v, const void* u, const void* w,
                const float* omega, const float* partial, void* dk, void* dv, int BH, int L,
                int Dh, int Dv, int M, int np, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd_b<__nv_bfloat16, false>(q, k, v, u, w, omega, partial, dk, dv, BH, 1,
                                                   L, Dh, Dv, M, np, s)
              : launch_bwd_b<float, false>(q, k, v, u, w, omega, partial, dk, dv, BH, 1, L, Dh,
                                           Dv, M, np, s);
}

// heads-last: q, k, v, u [B, L, H * Dh] and w [B * H, L] as favor_bwd_a_hl gives
// them -> dk, dv [B, L, H * Dh] in the inputs' dtype.
int favor_bwd_b_hl(const void* q, const void* k, const void* v, const void* u, const void* w,
                   const float* omega, const float* partial, void* dk, void* dv, int B, int H,
                   int L, int Dh, int M, int np, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd_b<__nv_bfloat16, true>(q, k, v, u, w, omega, partial, dk, dv, B * H,
                                                  H, L, Dh, Dh, M, np, s)
              : launch_bwd_b<float, true>(q, k, v, u, w, omega, partial, dk, dv, B * H, H, L,
                                          Dh, Dh, M, np, s);
}

}  // extern "C"
