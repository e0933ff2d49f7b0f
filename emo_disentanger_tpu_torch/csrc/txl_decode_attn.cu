// The stage-1 Transformer-XL's decode attention with a clock per slot, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: JAX's full_decode_attention_pe
// (emo_disentanger_tpu/ops/attention.py) is jnp, and the port ran it as two
// row writes and einsums over the whole cache.  Over the default 'khd' cache
// [B, K, H, Dh] each einsum first copied every layer's whole k or v cache
// into a batched-matrix form: those copies were 81% of the device time of a
// stage-1 serving step at 256 slots and 1,536 rows, where the slots hold
// ~200 live rows.  This kernel reads each slot's live prefix where it lies.
//
// For each slot b with clock t_b >= 0 and each head h, one launch:
//   writes k_new, v_new at row w = min(t_b, K - 1) of k and v, in place;
//   s_j = ((q + r_w) . k_j + (q + r_r) . r[min(t_b, R - 1) - j]) * scale
//         for j = 0 .. w (the row just written included);
//   out = sum_j softmax(s)_j v_j, in q's dtype.
// The clamps are the plain version's (ops/attention.py
// full_decode_attention_pe): the write clamp, the clamp of the distance
// window's start and the mask past the clock, so a dead slot whose clock ran
// past the cache reads all K rows at distances R - 1 - j, as there.  No row
// past w is read or written.  Scores, the relative term, the softmax and the
// value sum are float32, and the probabilities are not rounded before the
// value product.
//
// Bound on the H100: the live rows' bytes.  A row of one slot is H Dh values
// (1 KB in bf16 at H 8, Dh 64) of k and as many of v, read once; the
// position heads r [R, H, Dh] of a layer (1.5 MB) stay in the 50 MB L2 and
// are read by distance.  At ~1 flop a byte the work is GEMVs, far below the
// tensor cores' line, so the design is about bytes in flight and balance:
// * a thread holds 8 consecutive d of one head (one 16-byte load of bf16, two
//   of f32); the 8 threads of a head at Dh 64 reduce a row's two dot products
//   by shuffles, and a row group of H x 8 threads reads a whole 'khd' row,
//   1 KB contiguous, coalesced.  A block holds 256 / (H x 8) row groups; each
//   takes U rows a step (two in bf16, one in f32) with all their loads
//   issued before any is used, k and v streamed past L1 (__ldcs), r through
//   the read-only path;
// * a slot's live rows are split into S contiguous ranges, one block each
//   (grid S x B; S from the batch and the card's SMs, chosen by the caller),
//   so that 256 slots of 0 to ~500 rows fill the 132 SMs in several waves and
//   no long slot sets a layer's time.  Each block keeps an online softmax per
//   group, merges its groups in shared memory, and writes its (max, sum, acc)
//   to scratch; the last block of a slot (a __threadfence and an atomic
//   counter, which it resets) merges the S partials and writes the output;
// * the row just written is taken from k_new and v_new, never read back from
//   the cache, so no block waits on the block that writes it.
// Strides of k, v (the same for both) and r are arguments, so JAX's three
// layouts run the same code: 'khd' ([B, K, H, Dh], r [R, H, Dh]) takes the
// 16-byte loads; the head-major 'hkd' and 'dk' (r [H, Dh, R]) load value by
// value.  Any Dh <= 256 with H x threads a head <= 256 (threads a head:
// ceil(Dh / 8) rounded up to a power of two), f32 or bf16 throughout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int VEC = 8;             // d values a thread holds of a head
constexpr int THREADS = 256;       // a block's row groups, at most
constexpr int MAX_DH = 256;
constexpr float NEG_BIG = -1e30f;  // the running max before any row

struct Args {
  const void* q;        // [B, H, Dh], batch stride qb, (H, Dh) contiguous
  const void* k_new;    // like q, batch stride knb
  const void* v_new;    // like q, batch stride vnb
  const void* r_w;      // [H, Dh] contiguous
  const void* r_r;      // [H, Dh] contiguous
  void* k;              // cache, element (b, j, h, d) at b sb + j sk + h sh + d sd
  void* v;              // strides of k
  const void* r;        // position heads, (dist, h, d) at dist rs + h rh + d rd
  const long long* t;   // [B] clocks
  void* out;            // [B, H, Dh] contiguous
  float* part;          // [B, S, H (Dh + 2)]: a block's acc, then max, then sum
  int* cnt;             // [B] zero before the launch; the last block resets it
  long long qb, knb, vnb, sb, sk, sh, sd, rs, rh, rd;
  int B, K, R, H, Dh, S;
  int tph;              // threads a head: a power of two, >= ceil(Dh / VEC)
  int groups;           // row groups a block
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <class T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// A thread's VEC values of one head's row.  VECTOR: kept as loaded, in
// 16-byte words of T (one for bf16, two for f32), and converted where used;
// else loaded value by value at stride sd into floats, zeros past nd.
template <class T, bool VECTOR> struct Vals;

template <class T> struct Vals<T, true> {
  static constexpr int N = (int)sizeof(T) * VEC / 16;
  uint4 u[N];
  template <bool STREAM>
  __device__ __forceinline__ void load(const T* src, long long, int) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
    for (int i = 0; i < N; ++i) u[i] = STREAM ? __ldcs(s + i) : __ldg(s + i);
  }
  __device__ __forceinline__ float at(int e) const {
    const uint4& w = u[N == 1 ? 0 : e / 4];
    const int i = N == 1 ? e / 2 : e % 4;
    const uint32_t x = i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
    if constexpr (N == 1)        // a bf16 is the high half of its float
      return __uint_as_float(e % 2 ? x & 0xffff0000u : x << 16);
    else
      return __uint_as_float(x);
  }
};

template <class T> struct Vals<T, false> {
  float f[VEC];
  template <bool STREAM>
  __device__ __forceinline__ void load(const T* src, long long sd, int nd) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) f[e] = e < nd ? to_f(src[e * sd]) : 0.f;
  }
  __device__ __forceinline__ float at(int e) const { return f[e]; }
};

// VECTOR: k, v and r take 16-byte loads (unit d stride, every other stride
// and the bases on 16-byte boundaries, Dh a multiple of VEC)
template <class T, bool VECTOR>
__global__ void __launch_bounds__(THREADS, 3) txl_decode_attn_kernel(const Args a) {
  constexpr int U = sizeof(T) == 2 ? 2 : 1;   // rows a group takes a step
  extern __shared__ float smem[];
  __shared__ int s_last;
  const int b = blockIdx.y, split = blockIdx.x, tid = threadIdx.x;
  const int RG = a.H * a.tph;
  const int g = tid / RG;              // == groups for a spare thread of the last warp
  const int li = tid - g * RG;
  const int h = li / a.tph, d0 = (li % a.tph) * VEC;
  const bool in_group = g < a.groups;
  const int nd = in_group ? max(0, min(VEC, a.Dh - d0)) : 0;   // d values held
  const bool head0 = in_group && d0 == 0;                      // writes the head's max, sum

  const long long t_b = a.t[b];
  const int w = (int)min(max(t_b, 0LL), (long long)a.K - 1);  // the row written
  const int n = t_b < 0 ? 0 : w + 1;                           // rows read
  const int tr = (int)min(t_b, (long long)a.R - 1);           // distance of row 0

  const T* qp = static_cast<const T*>(a.q) + b * a.qb + h * a.Dh + d0;
  const T* knp = static_cast<const T*>(a.k_new) + b * a.knb + h * a.Dh + d0;
  const T* vnp = static_cast<const T*>(a.v_new) + b * a.vnb + h * a.Dh + d0;
  const T* rwp = static_cast<const T*>(a.r_w) + h * a.Dh + d0;
  const T* rrp = static_cast<const T*>(a.r_r) + h * a.Dh + d0;
  float qw[VEC], qr[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float qe = e < nd ? to_f(qp[e]) : 0.f;
    qw[e] = e < nd ? qe + to_f(rwp[e]) : 0.f;
    qr[e] = e < nd ? qe + to_f(rrp[e]) : 0.f;
  }
  const long long off = h * a.sh + d0 * a.sd;
  T* kb = static_cast<T*>(a.k) + b * a.sb + off;
  T* vb = static_cast<T*>(a.v) + b * a.sb + off;
  const T* rb = static_cast<const T*>(a.r) + h * a.rh + d0 * a.rd;

  if (split == 0 && g == 0) {          // the new row, where the plain write puts it
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      if (e < nd) {
        kb[w * a.sk + e * a.sd] = knp[e];
        vb[w * a.sk + e * a.sd] = vnp[e];
      }
  }

  const int chunk = (n + a.S - 1) / a.S;
  const int j0 = min(n, split * chunk), j1 = min(n, j0 + chunk);
  const int step = a.groups * U;
  const int iters = (j1 - j0 + step - 1) / step;   // the same for every thread of the block

  float m = NEG_BIG, l = 0.f, acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  for (int it = 0; it < iters; ++it) {
    const int jb = j0 + it * step + g * U;
    Vals<T, VECTOR> kv[U], vv[U], rv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {      // every load of the step in flight first
      const int j = jb + u;
      if (nd > 0 && j < j1) {
        const bool fresh = j == w;     // the row just written: from k_new, v_new
        kv[u].template load<true>(fresh ? knp : kb + j * a.sk, fresh ? 1 : a.sd, nd);
        vv[u].template load<true>(fresh ? vnp : vb + j * a.sk, fresh ? 1 : a.sd, nd);
        rv[u].template load<false>(rb + (tr - j) * a.rs, a.rd, nd);
      }
    }
    float s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = jb + u;
      float dot = 0.f;
      if (nd > 0 && j < j1) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot += qw[e] * kv[u].at(e) + qr[e] * rv[u].at(e);
      }
      for (int o = a.tph / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      s[u] = in_group && j < j1 ? dot * a.scale : -INFINITY;
    }
    float mx = m;
#pragma unroll
    for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u]);
    const float corr = expf(m - mx);
    l *= corr;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] *= corr;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (nd > 0 && jb + u < j1) {
        const float p = expf(s[u] - mx);
        l += p;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += p * vv[u].at(e);
      }
    }
    m = mx;
  }

  // the block's groups, merged in shared memory by group 0
  float* s_acc = smem;                                  // [blockDim][VEC]
  float* s_m = smem + blockDim.x * VEC;                 // [groups][H]
  float* s_l = s_m + a.groups * a.H;
  if (in_group) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) s_acc[tid * VEC + e] = acc[e];
    if (d0 == 0) {
      s_m[g * a.H + h] = m;
      s_l[g * a.H + h] = l;
    }
  }
  __syncthreads();
  const bool merger = in_group && g == 0;
  float M = NEG_BIG, L = 0.f, A[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) A[e] = 0.f;
  if (merger) {
    for (int gg = 0; gg < a.groups; ++gg) M = fmaxf(M, s_m[gg * a.H + h]);
    for (int gg = 0; gg < a.groups; ++gg) {
      const float c = expf(s_m[gg * a.H + h] - M);
      L += c * s_l[gg * a.H + h];
#pragma unroll
      for (int e = 0; e < VEC; ++e) A[e] += c * s_acc[(gg * RG + li) * VEC + e];
    }
  }

  T* op = static_cast<T*>(a.out) + ((long long)b * a.H + h) * a.Dh + d0;
  if (a.S == 1) {
    if (merger) {
      const float inv = L > 0.f ? 1.f / L : 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (e < nd) op[e] = from_f<T>(A[e] * inv);
    }
    return;
  }

  // the slot's S blocks: each writes its partial, the last one merges them
  const int stride = a.H * (a.Dh + 2);
  float* pb = a.part + (long long)b * a.S * stride;
  if (merger) {
    float* pp = pb + split * stride;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      if (e < nd) pp[h * a.Dh + d0 + e] = A[e];
    if (head0) {
      pp[a.H * a.Dh + h] = M;
      pp[a.H * a.Dh + a.H + h] = L;
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(a.cnt + b, 1) == a.S - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (merger) {
    float M2 = NEG_BIG, L2 = 0.f, A2[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) A2[e] = 0.f;
    for (int sp = 0; sp < a.S; ++sp) M2 = fmaxf(M2, __ldcg(pb + sp * stride + a.H * a.Dh + h));
    for (int sp = 0; sp < a.S; ++sp) {
      const float* pp = pb + sp * stride;
      const float c = expf(__ldcg(pp + a.H * a.Dh + h) - M2);
      L2 += c * __ldcg(pp + a.H * a.Dh + a.H + h);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (e < nd) A2[e] += c * __ldcg(pp + h * a.Dh + d0 + e);
    }
    const float inv = L2 > 0.f ? 1.f / L2 : 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      if (e < nd) op[e] = from_f<T>(A2[e] * inv);
  }
  if (tid == 0) a.cnt[b] = 0;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <class T, bool VECTOR>
cudaError_t launch_as(const Args& a, int threads, size_t smem, cudaStream_t s) {
  txl_decode_attn_kernel<T, VECTOR><<<dim3(a.S, a.B), threads, smem, s>>>(a);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch(Args& a, cudaStream_t s) {
  int tph = 1;
  while (tph * VEC < a.Dh) tph *= 2;
  a.tph = tph;
  a.groups = THREADS / (a.H * tph);
  const int threads = (a.groups * a.H * tph + 31) / 32 * 32;
  const size_t smem = sizeof(float) * ((size_t)threads * VEC + 2 * a.groups * a.H);
  const long long m = VEC;   // 16 bytes of bf16; f32 needs 4, so 8 is enough for both
  const bool vector = a.sd == 1 && a.rd == 1 && a.Dh % VEC == 0 && a.sb % m == 0 &&
                      a.sk % m == 0 && a.sh % m == 0 && a.rs % m == 0 && a.rh % m == 0 &&
                      a.knb % m == 0 && a.vnb % m == 0 && aligned16(a.k) && aligned16(a.v) &&
                      aligned16(a.r) && aligned16(a.k_new) && aligned16(a.v_new);
  return vector ? launch_as<T, true>(a, threads, smem, s) : launch_as<T, false>(a, threads, smem, s);
}

}  // namespace

extern "C" {

const char* emodis_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// ptrs: q, k_new, v_new, r_w, r_r, k, v, r, t, out, part, cnt (Args' fields,
// all on one device; t int64, part f32, cnt int32, the rest of one dtype:
// bf16 when bf16, else f32); dims: B, K, R, H, Dh, S, then the strides qb,
// knb, vnb, sb, sk, sh, sd, rs, rh, rd in elements.  part holds B S H (Dh + 2)
// floats and cnt B zeroed ints (S > 1; each launch leaves them zero); one
// stream at a time may use one cnt.  Needs 1 <= Dh <= 256, H x tph <= 256,
// R >= K >= 1, S >= 1 and every clock >= 0.
int txl_decode_attn(void* const* ptrs, const long long* dims, int bf16, float scale,
                    void* stream) {
  Args a;
  a.q = ptrs[0];
  a.k_new = ptrs[1];
  a.v_new = ptrs[2];
  a.r_w = ptrs[3];
  a.r_r = ptrs[4];
  a.k = ptrs[5];
  a.v = ptrs[6];
  a.r = ptrs[7];
  a.t = static_cast<const long long*>(ptrs[8]);
  a.out = ptrs[9];
  a.part = static_cast<float*>(ptrs[10]);
  a.cnt = static_cast<int*>(ptrs[11]);
  a.B = (int)dims[0];
  a.K = (int)dims[1];
  a.R = (int)dims[2];
  a.H = (int)dims[3];
  a.Dh = (int)dims[4];
  a.S = (int)dims[5];
  a.qb = dims[6];
  a.knb = dims[7];
  a.vnb = dims[8];
  a.sb = dims[9];
  a.sk = dims[10];
  a.sh = dims[11];
  a.sd = dims[12];
  a.rs = dims[13];
  a.rh = dims[14];
  a.rd = dims[15];
  a.scale = scale;
  int tph = 1;
  while (tph * VEC < a.Dh) tph *= 2;
  if (a.B <= 0 || a.B > 65535 || a.K <= 0 || a.R < a.K || a.H <= 0 || a.Dh <= 0 ||
      a.Dh > MAX_DH || a.H * tph > THREADS || a.S <= 0 || a.S > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? (int)launch<__nv_bfloat16>(a, s) : (int)launch<float>(a, s);
}

}  // extern "C"
