// Tensor-core helpers shared by the bf16 instantiations of the FAVOR+
// kernels, the key max and the forward (favor_fwd.cu) and both backward
// passes (favor_bwd.cu), and by the composed op's forward and f32 backward
// passes (linear_attn.cu).  Like favor_common.cuh, they live in an anonymous
// namespace, so each library gets its own copy; ops/_build.py hashes every
// header with each source, so an edit here rebuilds all three.
//
// The products whose operands the TPU kernels round to bf16 run as
// mma.sync.m16n8k16 bf16 with f32 accumulation (tc_mma), which is exactly
// what the TPU's bf16 dot with f32 accumulation computes; the omega
// products, which the TPU keeps in f32, and every product of the composed
// op, whose arithmetic is f32, run in 3xTF32 on mma.sync.m16n8k8 (tc_mma_f32),
// f32-accurate to ~1e-6.  Each warp builds its fragments
// from the kernels' f32 tiles in shared memory with scalar shared loads,
// rounding two values into one register (__floats2bfloat162_rn, round to
// nearest even, as rnd<T>).  The K slots of a 16-wide step are permuted
// (the product does not depend on the order of K, only on A and B
// agreeing): lane t takes the four consecutive k = k0 + 8t + 4s + {0..3}
// in step s of each 32-wide pair (of a 16-wide tail, k0 + 4t + {0..3}).
// Every tile has an odd row stride (the +1 padding of a width that is a
// multiple of 16, so 1 mod 32 at widths that are multiples of 32), so the
// 32 lanes (g = lane/4, t) of a load hit the banks g * stride + 8t + const:
// conflict-free, where the usual (2t, 2t+1) slots would meet 4-way.  The
// same holds for an operand read transposed (k stepping a padded row):
// each step of k moves an odd stride of banks.  The block's warps
// share each product's 16 x 16 output groups (tc_groups: two 16x8 tiles,
// one A fragment); tc_each runs an elementwise epilogue on the
// accumulators, tc_each2 on each lane's pairs of adjacent columns (for
// 8-byte stores).  The rows come in by vector loads: 16 bytes of bf16, four
// in flight a thread (load_rows_tc), or four values of f32 or bf16 widened
// to f32, eight in flight for two tiles at once (load_rows4_tc); ||x||^2 is a
// warp a row (row_sq_tc) and column sums four lanes a feature
// (add_col_sums_tc, add_wcol_sums_tc weighted).

#pragma once

#include <stdint.h>

#include "favor_common.cuh"

namespace {

// omega [Dh][M] -> shared [Dh][M+1], the layout features_tc reads
__device__ __forceinline__ void omega_padded(float* om, const float* omega, int Dh, int M) {
  for (int i = threadIdx.x; i < Dh * M; i += blockDim.x) {
    const int d = i / M, m = i - d * M;
    om[d * (M + 1) + m] = omega[i];
  }
}

// omega_padded; the state and its vector to zero; returns the row's key
// stabilizer, the max of favor_kmax's partial maxima.
__device__ float setup(float* om, const float* omega, float* state, float* vec,
                       const float* partial, int Dh, int Dv, int M, int np) {
  omega_padded(om, omega, Dh, M);
  for (int i = threadIdx.x; i < M * (Dv + 1); i += blockDim.x) state[i] = 0.f;
  for (int i = threadIdx.x; i < M; i += blockDim.x) vec[i] = 0.f;
  float kmax = -INFINITY;
  for (int c = 0; c < np; ++c) kmax = fmaxf(kmax, partial[(size_t)blockIdx.x * np + c]);
  __syncthreads();
  return kmax;
}

// two f32 values -> one register of two bf16 (lo in the low half), rounded
// to nearest even as rnd<__nv_bfloat16> rounds
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// d (16x8 f32) += a (16x16 bf16) b (16x8 bf16)
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp: acc[nt] (the 16x8 tile at rows i0.., columns j0 + 8 nt..) +=
// sum_{k<K} A(i, k) B(k, j), operands rounded to bf16, with A(i, k) =
// A[i*ai + k*ak] and B(k, j) = B[k*bk + j*bj] f32 in shared memory; K a
// multiple of 16.  Fragments as the PTX ISA's m16n8k16 figures (g = lane/4,
// t = lane%4): A regs (g, s0 s1), (g+8, s0 s1), (g, s2 s3), (g+8, s2 s3),
// B regs (s0 s1, n = g), (s2 s3, n = g), C (g, 2t 2t+1), (g+8, 2t 2t+1),
// with the K slots s0..s3 of lane t at k = kk..kk+3 (the note at the top).
template <int NT>
__device__ __forceinline__ void tc_mma(float (*acc)[4], const float* A, int ai, int ak, int i0,
                                       const float* B, int bk, int bj, int j0, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a0 = A + (i0 + g) * ai;
  const float* a1 = a0 + 8 * ai;
  const float* b0 = B + (j0 + g) * bj;
  auto step = [&](int kk) {
    const float* x0 = a0 + kk * ak;
    const float* x1 = a1 + kk * ak;
    const uint32_t a[4] = {pack_bf16(x0[0], x0[ak]), pack_bf16(x1[0], x1[ak]),
                           pack_bf16(x0[2 * ak], x0[3 * ak]),
                           pack_bf16(x1[2 * ak], x1[3 * ak])};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* y = b0 + nt * 8 * bj + kk * bk;
      const uint32_t b[2] = {pack_bf16(y[0], y[bk]), pack_bf16(y[2 * bk], y[3 * bk])};
      mma_bf16(acc[nt], a, b);
    }
  };
  int k0 = 0;
  for (; k0 + 32 <= K; k0 += 32) {
    step(k0 + 8 * t);
    step(k0 + 8 * t + 4);
  }
  if (k0 < K) step(k0 + 4 * t);
}

// f(i, j, value) for each accumulator of tc_mma<NT>'s tiles at (i0, j0)
template <int NT, class F>
__device__ __forceinline__ void tc_each(float (*acc)[4], int i0, int j0, F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      f(i0 + g + 8 * (r >> 1), j0 + 8 * nt + 2 * t + (r & 1), acc[nt][r]);
}

// f(i, j, x_j, x_j+1) for each lane's pair of adjacent columns (j even) of
// tc_mma<NT>'s tiles at (i0, j0)
template <int NT, class F>
__device__ __forceinline__ void tc_each2(float (*acc)[4], int i0, int j0, F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      f(i0 + g + 8 * h, j0 + 8 * nt + 2 * t, acc[nt][2 * h], acc[nt][2 * h + 1]);
}

// The block's warps share the R x N output of a product as (R/16) x (N/16)
// groups of two 16x8 tiles; body(acc, i0, j0) for each group of this warp,
// acc zeroed.  R and N multiples of 16.
template <class F>
__device__ __forceinline__ void tc_groups(int R, int N, F body) {
  const int ng = N / 16, nwarp = blockDim.x >> 5;
  for (int grp = threadIdx.x >> 5; grp < (R / 16) * ng; grp += nwarp) {
    float acc[2][4] = {};
    body(acc, (grp / ng) * 16, (grp % ng) * 16);
  }
}

// x -> TF32 hi, x truncated to TF32's 10 mantissa bits (one logic op), and
// the rest x - hi (exact in f32) rounded to TF32 as lo: hi + lo is x to
// ~2^-21 relative.  One conversion a value, where rounding hi too took two
// and cost pass A 6% (kernel_sections.py).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// d (16x8 f32) += a (16x8 tf32) b (8x8 tf32)
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// tc_mma's product in f32 accuracy, for the omega products: 3xTF32 on
// mma.sync.m16n8k8, each operand split into TF32 hi and lo, and lo hi +
// hi lo + hi hi accumulated in f32 (lo lo, ~2^-20 relative, dropped), as
// flash_attn_fwd.cu does.  Fragments as the PTX ISA's m16n8k8 .tf32
// figures: A regs (g, s0), (g+8, s0), (g, s1), (g+8, s1), B regs (s0, n = g),
// (s1, n = g); lane t's K slots s0, s1 at k = kk, kk+1, with kk = k0 + 8t + 2s
// in step s of each 32-wide run (conflict-free, as in tc_mma), k0 + 4t and
// k0 + 4t + 2 in a 16-wide tail.  K a multiple of 16.
template <int NT>
__device__ __forceinline__ void tc_mma_f32(float (*acc)[4], const float* A, int ai, int ak,
                                           int i0, const float* B, int bk, int bj, int j0,
                                           int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a0 = A + (i0 + g) * ai;
  const float* a1 = a0 + 8 * ai;
  const float* b0 = B + (j0 + g) * bj;
  auto step = [&](int kk) {
    uint32_t ah[4], al[4];
    split_tf32(a0[kk * ak], ah[0], al[0]);
    split_tf32(a1[kk * ak], ah[1], al[1]);
    split_tf32(a0[(kk + 1) * ak], ah[2], al[2]);
    split_tf32(a1[(kk + 1) * ak], ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* y = b0 + nt * 8 * bj + kk * bk;
      uint32_t bh[2], bl[2];
      split_tf32(y[0], bh[0], bl[0]);
      split_tf32(y[bk], bh[1], bl[1]);
      mma_tf32(acc[nt], al, bh);
      mma_tf32(acc[nt], ah, bl);
      mma_tf32(acc[nt], ah, bh);
    }
  };
  int k0 = 0;
  for (; k0 + 32 <= K; k0 += 32)
#pragma unroll
    for (int s = 0; s < 4; ++s) step(k0 + 8 * t + 2 * s);
  for (; k0 < K; k0 += 16) {
    step(k0 + 4 * t);
    step(k0 + 4 * t + 2);
  }
}

// lane t's first K slot in step s of tc_mma_f32 over K (the slots kk and
// kk + 1), for a caller that holds an operand's fragments itself: kk = k0 +
// 8t + 2s' in a 32-wide run, k0 + 4t + 2s' in a 16-wide tail (s' = s % 4)
__device__ __forceinline__ int tf32_k(int s, int K, int t) {
  const int k0 = 32 * (s / 4);
  return k0 + (k0 + 32 <= K ? 8 * t : 4 * t) + 2 * (s % 4);
}

// features' function for the bf16 instantiations, its h = xs . omega in
// 3xTF32 (tc_mma_f32).  Ends with __syncthreads().
template <bool QUERY>
__device__ void features_tc(float* phi, const float* xs, const float* sq, const float* om, int n,
                            int Dh, int M, float kmax, float rsqm) {
  const int MP = M + 1;
  tc_groups(C, M, [&](float (*acc)[4], int i0, int j0) {
    tc_mma_f32<2>(acc, xs, Dh + 1, 1, i0, om, MP, 1, j0, Dh);
    tc_each<2>(acc, i0, j0, [&](int i, int m, float x) {
      const float h = x - sq[i];
      phi[i * MP + m] = QUERY ? h : (i < n ? expf(h - kmax) * rsqm : 0.f);
    });
  });
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

// dst[i][d] = src[i * ld + d] * mul for rows i < n, 0 for the ragged tail:
// C rows of D bf16 values (D a multiple of 8, src 16-byte aligned, as the
// wrappers check) into f32 rows D + 1 apart.  16-byte loads, four of them
// in flight a thread before any is stored.
__device__ __forceinline__ void load_rows_tc(float* dst, const __nv_bfloat16* src, int n, int D,
                                             int ld, float mul) {
  constexpr int U = 4;
  const int V = D / 8;
  for (int base = threadIdx.x; base < C * V; base += U * blockDim.x) {
    uint4 raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * blockDim.x, i = idx / V;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < C * V && i < n)
        raw[u] = __ldg(reinterpret_cast<const uint4*>(src + (size_t)i * ld + (idx - i * V) * 8));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * blockDim.x, i = idx / V;
      if (idx < C * V) {
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw[u]);
        float* p = dst + i * (D + 1) + (idx - i * V) * 8;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h[e]);
          p[2 * e] = f.x * mul;
          p[2 * e + 1] = f.y * mul;
        }
      }
    }
  }
}

// Four consecutive values of T by one load, stored widened to f32: a 16-byte
// float4 for f32, an 8-byte pair of bf16 pairs for bf16.
template <class T> struct Vec4;
template <> struct Vec4<float> {
  using Raw = float4;
  static __device__ __forceinline__ Raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void store(float* p, Raw r) {
    p[0] = r.x;
    p[1] = r.y;
    p[2] = r.z;
    p[3] = r.w;
  }
};
template <> struct Vec4<__nv_bfloat16> {
  using Raw = uint2;
  static __device__ __forceinline__ Raw zero() { return make_uint2(0u, 0u); }
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ void store(float* p, Raw r) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
    p[0] = a.x;
    p[1] = a.y;
    p[2] = b.x;
    p[3] = b.y;
  }
};

// d0[i][c] = s0[i * D + c] (and, with TWO, d1[i][c] = s1[i * D + c]) widened
// to f32 for rows i < n and columns c < D, 0 for the ragged tail and the pad
// columns up to DP: C rows into rows DP + 1 apart (D and DP multiples of 4,
// each source on a boundary of four of its values, as the wrappers check).
// Four values a load, four loads a tile in flight a thread before any is
// stored.
template <bool TWO, class T0, class T1>
__device__ __forceinline__ void load_tiles4(float* d0, const T0* s0, float* d1, const T1* s1,
                                            int n, int D, int DP) {
  constexpr int U = 4;
  const int V = DP / 4, VD = D / 4;
  for (int base = threadIdx.x; base < C * V; base += U * blockDim.x) {
    // r1 is declared and zeroed before r0: the compiler numbers registers in
    // this order, and this order gives the f32 passes (#6/#7) the SASS they
    // had before the loader took the element type (kernel_ab.py --compare)
    typename Vec4<T1>::Raw r1[U];
    typename Vec4<T0>::Raw r0[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * blockDim.x, i = idx / V, c = idx - i * V;
      if constexpr (TWO) r1[u] = Vec4<T1>::zero();
      r0[u] = Vec4<T0>::zero();
      if (idx < C * V && i < n && c < VD) {
        r0[u] = Vec4<T0>::load(s0 + (size_t)i * D + c * 4);
        if constexpr (TWO) r1[u] = Vec4<T1>::load(s1 + (size_t)i * D + c * 4);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * blockDim.x, i = idx / V;
      if (idx < C * V) {
        const int at = i * (DP + 1) + (idx - i * V) * 4;
        Vec4<T0>::store(d0 + at, r0[u]);
        if constexpr (TWO) Vec4<T1>::store(d1 + at, r1[u]);
      }
    }
  }
}

// two tiles of a width at once, eight loads in flight a thread
template <class T0, class T1>
__device__ __forceinline__ void load_rows4_tc(float* d0, const T0* s0, float* d1, const T1* s1,
                                              int n, int D, int DP) {
  load_tiles4<true>(d0, s0, d1, s1, n, D, DP);
}

// one tile
template <class T>
__device__ __forceinline__ void load_rows4_tc(float* d, const T* s, int n, int D, int DP) {
  load_tiles4<false>(d, s, d, s, n, D, DP);
}

// sq[i] = ||xs_i||^2 / 2, a warp a row (xs [C][D+1]); ends with __syncthreads()
__device__ __forceinline__ void row_sq_tc(float* sq, const float* xs, int D) {
  const int lane = threadIdx.x & 31, nwarp = blockDim.x >> 5;
  for (int i = threadIdx.x >> 5; i < C; i += nwarp) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s = fmaf(xs[i * (D + 1) + d], xs[i * (D + 1) + d], s);
    s = warp_sum(s);
    if (lane == 0) sq[i] = 0.5f * s;
  }
  __syncthreads();
}

// z[m] += sum_{j<C} x[j][m] (x [C][M+1] in shared memory), four lanes a
// feature, lane p of them summing the rows j with (j / 8) % 4 == p: the
// warp's loads hit 32 distinct banks.  M a multiple of 8.
__device__ __forceinline__ void add_col_sums_tc(float* z, const float* x, int M) {
  const int MP = M + 1, lane = threadIdx.x & 31;
  for (int idx = threadIdx.x; idx < 4 * M; idx += blockDim.x) {
    const int p = lane >> 3, m = (idx >> 5) * 8 + (lane & 7);
    float s = 0.f;
    for (int r = 0; r < C; r += 32)
#pragma unroll
      for (int e = 0; e < 8; ++e) s += x[(r + 8 * p + e) * MP + m];
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    if (p == 0) z[m] += s;
  }
}

// r[m] += sum_{i<C} wts[i] x[i][m], add_col_sums_tc's lanes and order
__device__ __forceinline__ void add_wcol_sums_tc(float* r, const float* x, const float* wts,
                                                 int M) {
  const int MP = M + 1, lane = threadIdx.x & 31;
  for (int idx = threadIdx.x; idx < 4 * M; idx += blockDim.x) {
    const int p = lane >> 3, m = (idx >> 5) * 8 + (lane & 7);
    float s = 0.f;
    for (int i0 = 0; i0 < C; i0 += 32)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = i0 + 8 * p + e;
        s = fmaf(wts[i], x[i * MP + m], s);
      }
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    if (p == 0) r[m] += s;
  }
}

}  // namespace
