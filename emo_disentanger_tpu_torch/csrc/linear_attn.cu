// Causal linear attention over precomputed features, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of emo_disentanger_tpu/ops/linear_attention.py
// behind its composed op causal_linear_attention (:413):
//   _pallas_kernel (:152, via _pallas_impl :208)       -> cla_fwd_kernel
//   _bwd_a_kernel  (:245, via _pallas_bwd :341, :353)  -> cla_bwd_a_kernel
//   _bwd_b_kernel  (:295, via _pallas_bwd :341, :367)  -> cla_bwd_b_kernel
// Unlike favor_fwd.cu / favor_bwd.cu they take the feature maps phi_q, phi_k
// [BH, L, M] as inputs: no omega, no key stabilizer, no chain rule, and the
// backward ends at dphi.
//
// Function (per batch*head row; phi_q, phi_k [L, M] non-negative, v [L, Dv]):
//   out_i = phi_q_i . S_i / D_i,  D_i = phi_q_i . z_i + eps,
//   S_i = sum_{j<=i} phi_k_j v_j^T,  z_i = sum_{j<=i} phi_k_j
// and, with g = dL/dout:
//   pass A, chunks in order, carrying the prefix (S, z):
//     u_i = g_i / D_i,  w_i = -(g_i . out_i) / D_i
//     dphi_q_i = sum_{j<=i} a_ij phi_k_j + S_prev u_i + w_i z_prev,
//                a_ij = u_i . v_j + w_i   (j in the chunk)
//   pass B, chunks in reverse, carrying the suffix states
//     R = sum_{i>=j} phi_q_i u_i^T [M, Dv],  r = sum_{i>=j} w_i phi_q_i [M]:
//     dv_j = sum_{i>=j} p_ij u_i + R_next^T phi_k_j,  p_ij = phi_q_i . phi_k_j
//     dphi_k_j = sum_{i>=j} a_ij phi_q_i + R_next v_j + r_next
// The forward reads phi_q, phi_k and v each in f32 or bf16, widened to f32 on
// load as the TPU kernel widens each input, and writes f32.  The backward
// passes read f32 (the wrapper casts first, as JAX does before _pallas_bwd)
// and write f32: dphi_q, u and w [BH, L] (pass A), dphi_k and dv (pass B).  Rows past L, in the ragged
// last chunk, load as zero: they add nothing to a state or a product, their
// denominator is eps alone, and nothing is stored for them.
//
// Bound on the H100: at BH = 128, L = 3072, M = 128, Dv = 64 the forward
// moves (2 M + Dv) in_bytes + 4 Dv bytes a position, 604 MB in f32 (352 MB
// with bf16 inputs), and needs 13.1 GFLOP; each backward pass moves 907 MB
// and needs 19.5-19.7 GFLOP (the per-position recurrence's products,
// counted by chip_smoke.py's cla_fwd_bound / cla_bwd_bound; the chunk
// triangles below are this kernel's overhead).  All three run their
// products in 3xTF32, three TF32 passes at 495 TFLOP/s: 0.079 ms forward,
// 0.12 ms a pass, so bytes at 3.35 TB/s bound them: 0.180 ms forward (0.105
// ms with bf16 inputs), 0.27 ms a pass.  The same products in f32 on the
// CUDA cores (67 TFLOP/s) would bound the forward at 0.195 ms and a pass at
// 0.29 ms.
//
// Design: one thread block per row loops over 64-row chunks, the TPU grid's
// sequential chunk axis.  The carried state and the chunk's tiles live in
// shared memory, rows padded +1 against bank conflicts: 130 KB forward, 163
// KB pass A and 147 KB pass B at the shapes above, so one block an SM, run
// at 16 warps.  All three kernels run on the tensor cores with the helpers
// of favor_tc.cuh, the fused kernels' design (favor_fwd.cu, favor_bwd.cu)
// without the feature maps and the chain rule.  Every product (forward:
// the scores phi_q phi_k^T, the numerator sc v + phi_q S and the update
// S += phi_k^T v; pass A: those and the a matrix u v^T and dphi_q = a phi_k
// + u S^T; pass B: the scores, dv = p^T u + phi_k R, the a matrix, dphi_k =
// a^T phi_q + v R^T and the update R += phi_q^T u) runs in 3xTF32 on
// mma.sync.m16n8k8, as the arithmetic is f32 and one TF32 pass errs ~1e-3;
// bf16 inputs widen exactly and take the same path.  M and Dv are padded
// to the next multiple of 16 in shared memory (pad16), with pad columns
// loaded as zero and never stored.  The causal products skip the groups
// above the diagonal and run K only to the group's last row; pass B's
// suffix products start K at the group's first row.  Rows come in by
// vector loads of four values in each input's type (load_rows4_tc: 16
// bytes of f32, 8 of bf16), widened to f32 in shared memory; the
// denominator and w are a warp a row, z and r four lanes a feature, and
// the outputs leave as 8-byte pairs.  No TMA or pipelining yet, and one
// block per row leaves SMs idle below BH = 132.

#include "favor_common.cuh"
#include "favor_tc.cuh"

namespace {

// the carried state [M][Dv+1] and its vector [M] to zero
__device__ void zero_state(float* state, float* vec, int M, int Dv) {
  for (int i = threadIdx.x; i < M * (Dv + 1); i += blockDim.x) state[i] = 0.f;
  for (int i = threadIdx.x; i < M; i += blockDim.x) vec[i] = 0.f;
}

// M and Dv are padded to the next multiple of 16 in shared memory, with pad
// columns loaded as zero and never stored, so the rows stay odd-strided
// (favor_tc.cuh's bank map) and every width the wrappers take (multiples of
// 4) runs.
__host__ __device__ __forceinline__ int pad16(int x) { return (x + 15) & ~15; }

// Their shared memory allows one block an SM, so the three kernels run 16
// warps a block, not THREADS' 8: more mma.sync chains and row loads in
// flight, the same bits (kernel_sections.py --cla times 8, 16 and 24 warps
// in turns).
constexpr int CLA_THREADS = 512;

// The forward is pass A's first half: the scores, the denominator, the
// numerator and the state update, each input read in its own type.
template <class TQ, class TK, class TV>
__global__ void cla_fwd_kernel(const TQ* __restrict__ q, const TK* __restrict__ k,
                               const TV* __restrict__ v, float* __restrict__ out, int L, int M,
                               int Dv, float eps) {
  extern __shared__ float smem[];
  const int M16 = pad16(M), D16 = pad16(Dv);
  const int MP = M16 + 1, DVP = D16 + 1, CP = C + 1;
  float* S = smem;                     // [M16][D16+1] running sum phi_k v^T
  float* z = S + M16 * DVP;            // [M16]        running sum phi_k
  float* pq = z + M16;                 // [C][M16+1]
  float* pk = pq + C * MP;             // [C][M16+1]
  float* vv = pk + C * MP;             // [C][D16+1]
  float* sc = vv + C * DVP;            // [C][C+1]     masked scores
  float* den = sc + C * CP;            // [C]
  const int tid = threadIdx.x, lane = tid & 31, nwarp = blockDim.x >> 5;
  const size_t row = blockIdx.x;
  q += row * L * M;                    // this row's first position
  k += row * L * M;
  v += row * L * Dv;
  out += row * L * Dv;
  zero_state(S, z, M16, D16);

  for (int r0 = 0; r0 < L; r0 += C) {
    const int n = min(C, L - r0);

    // this chunk's phi_q, phi_k and v rows, widened to f32
    load_rows4_tc(pq, q + (size_t)r0 * M, pk, k + (size_t)r0 * M, n, M, M16);
    load_rows4_tc(vv, v + (size_t)r0 * Dv, n, Dv, D16);
    __syncthreads();

    // sc = phi_q phi_k^T, masked to j <= i
    tc_groups(C, C, [&](float (*acc)[4], int i0, int j0) {
      if (j0 <= i0) tc_mma_f32<2>(acc, pq, MP, 1, i0, pk, 1, MP, j0, M16);
      tc_each<2>(acc, i0, j0, [&](int i, int j, float x) { sc[i * CP + j] = j <= i ? x : 0.f; });
    });
    __syncthreads();

    // den_i = sum_{j<=i} sc_ij + phi_q_i . z + eps, a warp per row
    for (int i = tid >> 5; i < C; i += nwarp) {
      float s = 0.f;
      for (int j = lane; j < C; j += 32) s += sc[i * CP + j];
      for (int m = lane; m < M16; m += 32) s = fmaf(pq[i * MP + m], z[m], s);
      s = warp_sum(s);
      if (lane == 0) den[i] = s + eps;
    }
    __syncthreads();

    // out_i = (sc_i . v + phi_q_i . S) / den_i
    tc_groups(C, D16, [&](float (*acc)[4], int i0, int d0) {
      tc_mma_f32<2>(acc, sc, CP, 1, i0, vv, DVP, 1, d0, i0 + 16);
      tc_mma_f32<2>(acc, pq, MP, 1, i0, S, DVP, 1, d0, M16);
      tc_each2<2>(acc, i0, d0, [&](int i, int d, float x0, float x1) {
        if (i < n && d < Dv)
          *reinterpret_cast<float2*>(out + (size_t)(r0 + i) * Dv + d) =
              make_float2(x0 / den[i], x1 / den[i]);
      });
    });
    __syncthreads();                   // the products above read S

    // S += phi_k^T v, z += sum_j phi_k_j
    tc_groups(M16, D16, [&](float (*acc)[4], int m0, int d0) {
      tc_mma_f32<2>(acc, pk, 1, MP, m0, vv, DVP, 1, d0, C);
      tc_each<2>(acc, m0, d0, [&](int m, int d, float x) { S[m * DVP + d] += x; });
    });
    add_col_sums_tc(z, pk, M16);
    __syncthreads();
  }
}

__global__ void cla_bwd_a_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const float* __restrict__ g,
                                 float* __restrict__ dq, float* __restrict__ u_out,
                                 float* __restrict__ w_out, int L, int M, int Dv, float eps) {
  extern __shared__ float smem[];
  const int M16 = pad16(M), D16 = pad16(Dv);
  const int MP = M16 + 1, DVP = D16 + 1, CP = C + 1;
  float* S = smem;                     // [M16][D16+1] running sum phi_k v^T
  float* z = S + M16 * DVP;            // [M16]        running sum phi_k
  float* pq = z + M16;                 // [C][M16+1]
  float* pk = pq + C * MP;             // [C][M16+1]
  float* vv = pk + C * MP;             // [C][D16+1]
  float* gu = vv + C * DVP;            // [C][D16+1]   g, then u
  float* go = gu + C * DVP;            // [C][D16+1]   g * out
  float* sc = go + C * DVP;            // [C][C+1]     masked scores, then a
  float* den = sc + C * CP;            // [C]
  float* wv = den + C;                 // [C]
  const int tid = threadIdx.x, lane = tid & 31, nwarp = blockDim.x >> 5;
  const size_t row = blockIdx.x;
  q += row * L * M;                    // this row's first position
  k += row * L * M;
  dq += row * L * M;
  v += row * L * Dv;
  g += row * L * Dv;
  u_out += row * L * Dv;
  w_out += row * L;
  zero_state(S, z, M16, D16);

  for (int r0 = 0; r0 < L; r0 += C) {
    const int n = min(C, L - r0);

    // this chunk's phi_q, phi_k, v and g rows
    load_rows4_tc(pq, q + (size_t)r0 * M, pk, k + (size_t)r0 * M, n, M, M16);
    load_rows4_tc(vv, v + (size_t)r0 * Dv, gu, g + (size_t)r0 * Dv, n, Dv, D16);
    __syncthreads();

    // sc = phi_q phi_k^T, masked to j <= i
    tc_groups(C, C, [&](float (*acc)[4], int i0, int j0) {
      if (j0 <= i0) tc_mma_f32<2>(acc, pq, MP, 1, i0, pk, 1, MP, j0, M16);
      tc_each<2>(acc, i0, j0, [&](int i, int j, float x) { sc[i * CP + j] = j <= i ? x : 0.f; });
    });
    __syncthreads();

    // den_i = sum_{j<=i} sc_ij + phi_q_i . z + eps, a warp per row
    for (int i = tid >> 5; i < C; i += nwarp) {
      float s = 0.f;
      for (int j = lane; j < C; j += 32) s += sc[i * CP + j];
      for (int m = lane; m < M16; m += 32) s = fmaf(pq[i * MP + m], z[m], s);
      s = warp_sum(s);
      if (lane == 0) den[i] = s + eps;
    }
    __syncthreads();

    // out_i = (sc_i . v + phi_q_i . S) / den_i; go = g * out; u = g / den
    tc_groups(C, D16, [&](float (*acc)[4], int i0, int d0) {
      tc_mma_f32<2>(acc, sc, CP, 1, i0, vv, DVP, 1, d0, i0 + 16);
      tc_mma_f32<2>(acc, pq, MP, 1, i0, S, DVP, 1, d0, M16);
      tc_each2<2>(acc, i0, d0, [&](int i, int d, float x0, float x1) {
        float* gi = gu + i * DVP + d;
        const float2 uu = make_float2(gi[0] / den[i], gi[1] / den[i]);
        go[i * DVP + d] = gi[0] * (x0 / den[i]);
        go[i * DVP + d + 1] = gi[1] * (x1 / den[i]);
        if (i < n && d < Dv) *reinterpret_cast<float2*>(u_out + (size_t)(r0 + i) * Dv + d) = uu;
        gi[0] = uu.x;
        gi[1] = uu.y;
      });
    });
    __syncthreads();

    // w_i = -(g_i . out_i) / den_i, a warp per row
    for (int i = tid >> 5; i < C; i += nwarp) {
      float s = 0.f;
      for (int d = lane; d < D16; d += 32) s += go[i * DVP + d];
      s = warp_sum(s);
      if (lane == 0) {
        const float w = -s / den[i];
        wv[i] = w;
        if (i < n) w_out[r0 + i] = w;
      }
    }
    __syncthreads();

    // a_ij = u_i . v_j + w_i for j <= i, into sc
    tc_groups(C, C, [&](float (*acc)[4], int i0, int j0) {
      if (j0 <= i0) tc_mma_f32<2>(acc, gu, DVP, 1, i0, vv, 1, DVP, j0, D16);
      tc_each<2>(acc, i0, j0,
                 [&](int i, int j, float x) { sc[i * CP + j] = j <= i ? x + wv[i] : 0.f; });
    });
    __syncthreads();

    // dphi_q = a . phi_k + u . S^T + w z
    tc_groups(C, M16, [&](float (*acc)[4], int i0, int m0) {
      tc_mma_f32<2>(acc, sc, CP, 1, i0, pk, MP, 1, m0, i0 + 16);
      tc_mma_f32<2>(acc, gu, DVP, 1, i0, S, 1, DVP, m0, D16);
      tc_each2<2>(acc, i0, m0, [&](int i, int m, float x0, float x1) {
        if (i < n && m < M)
          *reinterpret_cast<float2*>(dq + (size_t)(r0 + i) * M + m) =
              make_float2(x0 + wv[i] * z[m], x1 + wv[i] * z[m + 1]);
      });
    });
    __syncthreads();                   // the products above read S and z

    // S += phi_k^T v, z += sum_j phi_k_j
    tc_groups(M16, D16, [&](float (*acc)[4], int m0, int d0) {
      tc_mma_f32<2>(acc, pk, 1, MP, m0, vv, DVP, 1, d0, C);
      tc_each<2>(acc, m0, d0, [&](int m, int d, float x) { S[m * DVP + d] += x; });
    });
    add_col_sums_tc(z, pk, M16);
    __syncthreads();
  }
}

__global__ void cla_bwd_b_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const float* __restrict__ u,
                                 const float* __restrict__ w, float* __restrict__ dk,
                                 float* __restrict__ dv, int L, int M, int Dv) {
  extern __shared__ float smem[];
  const int M16 = pad16(M), D16 = pad16(Dv);
  const int MP = M16 + 1, DVP = D16 + 1, CP = C + 1;
  float* R = smem;                     // [M16][D16+1] suffix sum phi_q u^T
  float* r = R + M16 * DVP;            // [M16]        suffix sum w phi_q
  float* pq = r + M16;                 // [C][M16+1]
  float* pk = pq + C * MP;             // [C][M16+1]
  float* vv = pk + C * MP;             // [C][D16+1]
  float* uu = vv + C * DVP;            // [C][D16+1]
  float* sc = uu + C * DVP;            // [C][C+1]     p, then a
  float* wv = sc + C * CP;             // [C]
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  q += row * L * M;                    // this row's first position
  k += row * L * M;
  dk += row * L * M;
  v += row * L * Dv;
  u += row * L * Dv;
  dv += row * L * Dv;
  w += row * L;
  zero_state(R, r, M16, D16);

  for (int r0 = ((L - 1) / C) * C; r0 >= 0; r0 -= C) {
    const int n = min(C, L - r0);

    // this chunk's phi_q, phi_k, v, u rows and w
    load_rows4_tc(pq, q + (size_t)r0 * M, pk, k + (size_t)r0 * M, n, M, M16);
    load_rows4_tc(vv, v + (size_t)r0 * Dv, uu, u + (size_t)r0 * Dv, n, Dv, D16);
    for (int i = tid; i < C; i += blockDim.x) wv[i] = i < n ? w[r0 + i] : 0.f;
    __syncthreads();

    // sc = phi_q phi_k^T, masked to j <= i
    tc_groups(C, C, [&](float (*acc)[4], int i0, int j0) {
      if (j0 <= i0) tc_mma_f32<2>(acc, pq, MP, 1, i0, pk, 1, MP, j0, M16);
      tc_each<2>(acc, i0, j0, [&](int i, int j, float x) { sc[i * CP + j] = j <= i ? x : 0.f; });
    });
    __syncthreads();

    // dv_j = sum_{i>=j} p_ij u_i + phi_k_j . R: the suffix product reads sc
    // transposed from the group's first row j0 on (the masked zeros of sc
    // cover i < j)
    tc_groups(C, D16, [&](float (*acc)[4], int j0, int d0) {
      tc_mma_f32<2>(acc, sc + j0 * CP, 1, CP, j0, uu + j0 * DVP, DVP, 1, d0, C - j0);
      tc_mma_f32<2>(acc, pk, MP, 1, j0, R, DVP, 1, d0, M16);
      tc_each2<2>(acc, j0, d0, [&](int j, int d, float x0, float x1) {
        if (j < n && d < Dv)
          *reinterpret_cast<float2*>(dv + (size_t)(r0 + j) * Dv + d) = make_float2(x0, x1);
      });
    });
    __syncthreads();

    // a_ij = u_i . v_j + w_i for j <= i, into sc
    tc_groups(C, C, [&](float (*acc)[4], int i0, int j0) {
      if (j0 <= i0) tc_mma_f32<2>(acc, uu, DVP, 1, i0, vv, 1, DVP, j0, D16);
      tc_each<2>(acc, i0, j0,
                 [&](int i, int j, float x) { sc[i * CP + j] = j <= i ? x + wv[i] : 0.f; });
    });
    __syncthreads();

    // dphi_k_j = sum_{i>=j} a_ij phi_q_i + v_j . R^T + r
    tc_groups(C, M16, [&](float (*acc)[4], int j0, int m0) {
      tc_mma_f32<2>(acc, sc + j0 * CP, 1, CP, j0, pq + j0 * MP, MP, 1, m0, C - j0);
      tc_mma_f32<2>(acc, vv, DVP, 1, j0, R, 1, DVP, m0, D16);
      tc_each2<2>(acc, j0, m0, [&](int j, int m, float x0, float x1) {
        if (j < n && m < M)
          *reinterpret_cast<float2*>(dk + (size_t)(r0 + j) * M + m) =
              make_float2(x0 + r[m], x1 + r[m + 1]);
      });
    });
    __syncthreads();                   // the products above read R and r

    // R += phi_q^T u, r += sum_i w_i phi_q_i
    tc_groups(M16, D16, [&](float (*acc)[4], int m0, int d0) {
      tc_mma_f32<2>(acc, pq, 1, MP, m0, uu, DVP, 1, d0, C);
      tc_each<2>(acc, m0, d0, [&](int m, int d, float x) { R[m * DVP + d] += x; });
    });
    add_wcol_sums_tc(r, pq, wv, M16);
    __syncthreads();
  }
}

template <class TQ, class TK, class TV>
int launch_fwd(const void* q, const void* k, const void* v, float* out, int BH, int L, int M,
               int Dv, float eps, cudaStream_t stream) {
  const int M16 = pad16(M), D16 = pad16(Dv);
  const size_t smem = sizeof(float) * (M16 * (D16 + 1) + M16 + 2 * C * (M16 + 1) +
                                       C * (D16 + 1) + C * (C + 1) + C);
  cudaError_t err = allow_smem(cla_fwd_kernel<TQ, TK, TV>, smem);
  if (err != cudaSuccess) return (int)err;
  cla_fwd_kernel<TQ, TK, TV><<<BH, CLA_THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(k), static_cast<const TV*>(v), out, L,
      M, Dv, eps);
  return (int)cudaGetLastError();
}

// launch_fwd with v's element type picked by its flag, then phi_k's
template <class TQ, class TK>
int launch_fwd_v(const void* q, const void* k, const void* v, float* out, int BH, int L, int M,
                 int Dv, int v_bf16, float eps, cudaStream_t s) {
  return v_bf16 ? launch_fwd<TQ, TK, __nv_bfloat16>(q, k, v, out, BH, L, M, Dv, eps, s)
                : launch_fwd<TQ, TK, float>(q, k, v, out, BH, L, M, Dv, eps, s);
}

template <class TQ>
int launch_fwd_kv(const void* q, const void* k, const void* v, float* out, int BH, int L, int M,
                  int Dv, int k_bf16, int v_bf16, float eps, cudaStream_t s) {
  return k_bf16
             ? launch_fwd_v<TQ, __nv_bfloat16>(q, k, v, out, BH, L, M, Dv, v_bf16, eps, s)
             : launch_fwd_v<TQ, float>(q, k, v, out, BH, L, M, Dv, v_bf16, eps, s);
}

}  // namespace

extern "C" {

const char* emodis_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// phi_q, phi_k [BH, L, M], v [BH, L, Dv], each f32, or bf16 when its flag
// (q_bf16, k_bf16, v_bf16) is set -> out [BH, L, Dv] f32.
int cla_fwd(const void* q, const void* k, const void* v, float* out, int BH, int L, int M,
            int Dv, int q_bf16, int k_bf16, int v_bf16, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return q_bf16
             ? launch_fwd_kv<__nv_bfloat16>(q, k, v, out, BH, L, M, Dv, k_bf16, v_bf16, eps, s)
             : launch_fwd_kv<float>(q, k, v, out, BH, L, M, Dv, k_bf16, v_bf16, eps, s);
}

// phi_q, phi_k [BH, L, M], v, g [BH, L, Dv], all f32 ->
// dphi_q [BH, L, M], u [BH, L, Dv], w [BH, L] f32.
int cla_bwd_a(const float* q, const float* k, const float* v, const float* g, float* dq,
              float* u, float* w, int BH, int L, int M, int Dv, float eps, void* stream) {
  const int M16 = pad16(M), D16 = pad16(Dv);
  const size_t smem = sizeof(float) * (M16 * (D16 + 1) + M16 + 2 * C * (M16 + 1) +
                                       3 * C * (D16 + 1) + C * (C + 1) + 2 * C);
  cudaError_t err = allow_smem(cla_bwd_a_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cla_bwd_a_kernel<<<BH, CLA_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, g, dq, u, w, L, M, Dv, eps);
  return (int)cudaGetLastError();
}

// phi_q, phi_k, v as for cla_bwd_a, u [BH, L, Dv] and w [BH, L] from it (f32)
// -> dphi_k [BH, L, M], dv [BH, L, Dv] f32.
int cla_bwd_b(const float* q, const float* k, const float* v, const float* u, const float* w,
              float* dk, float* dv, int BH, int L, int M, int Dv, void* stream) {
  const int M16 = pad16(M), D16 = pad16(Dv);
  const size_t smem = sizeof(float) * (M16 * (D16 + 1) + M16 + 2 * C * (M16 + 1) +
                                       2 * C * (D16 + 1) + C * (C + 1) + C);
  cudaError_t err = allow_smem(cla_bwd_b_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cla_bwd_b_kernel<<<BH, CLA_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, u, w, dk, dv, L, M, Dv);
  return (int)cudaGetLastError();
}

}  // extern "C"
