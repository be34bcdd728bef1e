// Paged decode attention for Hopper (sm_90a), split over pages
// (flash-decoding): the block table's lba -> pba walk fused into the
// attention gather, one decode step.
//
// Replaces src/repro/kernels/paged_attention.py:paged_attention_pallas
// (kernel body _paged_kernel).  Same contract: q (B, H, hd); K/V pools
// (P, page, Hkv, hd) in f32 or bf16; block_table (B, max_pages) int32;
// seq_lens (B,) int32 -> out (B, H, hd) in q's dtype.  Online softmax in
// f32 with scale 1/sqrt(hd); q head h reads kv head h / n_rep; tokens at
// or past len are never read, so len == 0 gives zeros.  A table entry
// below ceil(len / page) that names no page of the pool traps.
//
// Two launches.  The partition kernel, grid (B, Hkv, n_split), 128
// threads: split s of row b covers table entries [s * pps, (s + 1) * pps),
// clipped to ceil(len_b / page) and max_pages; the block reads and checks
// its table entries once, into shared memory.  Lanes work in groups of G
// (a power of two up to 32, G * NC * 16 bytes >= hd): lane j of a group
// holds dims [(j + c G) E, (j + c G) E + E) for c < NC of one token's K
// and V row, E = 16 bytes of the dtype, loaded with 16-byte loads
// straight into registers, so no K or V tile passes through shared
// memory.  NC is 1 for rows up to 512 bytes and 2 for f32 at hd 129..256
// (a whole warp on one token, 32 bytes a lane); hd <= PA_MAX_HD.  A warp holds 32 / G tokens
// at once and the block's 4 warps take the split's tokens in turn; the
// next token's K and V are loaded before the current one is used.  Per
// token, the dots of all n_rep query rows of the kv head are summed over
// the group with shuffles, all rows at each shuffle step so that they
// overlap; each group keeps its own online-softmax state in
// f32 (log2 domain: q is pre-scaled by log2(e) / sqrt(hd)), merged across
// the groups of a warp by shuffles and across warps in shared memory at
// the end.  It writes (m, l, acc[hd]) per (b, query head, split) to f32
// scratch; a split wholly past the length writes m = NEG_INF and l = 0.
// The combine kernel, grid (B, H), 256 threads, weighs the splits that
// hold tokens by w_s = exp2(m_s - max m), its warps taking the splits 4
// at a time: out = sum w_s acc_s / max(sum w_s l_s, 1e-30).  Where the
// caller asks for it, it also writes each row's log-sum-exp of the scaled
// scores, ln 2 (max m + log2 sum w_s l_s), -inf for a row of length 0
// (whose output is 0): what a caller needs to merge rows that hold
// disjoint parts of one sequence.
// It reads only the splits below ceil(ceil(len / page) / pps), so an
// empty split never enters a sum and no exp of NEG_INF - NEG_INF occurs.
//
// Bound: the bytes it reads, sum_b ceil(len_b / page) * page * Hkv * hd *
// 2 * sizeof(dtype), at 3.35 TB/s; at decode sizes that is a few
// microseconds at most, so latency bounds it.  The design spreads a
// sequence over n_split blocks (the wrapper picks n_split so B * Hkv *
// n_split reaches 2 x 132 blocks where the table allows), keeps many
// 16-byte loads in flight per SM, and reads each live page once per kv
// head for all n_rep rows.  What holds it back: a lane group walks its
// tokens one after another, each behind the last one's softmax update,
// so a warp is latency-bound at a few tokens a microsecond; a block's
// fixed work (length, table, q, the merge) is as long as a few tokens;
// and the combine is a second launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PA_THREADS = 128;
constexpr int PA_WARPS = PA_THREADS / 32;
constexpr int PA_MAX_REP = 8;      // query rows per kv head
constexpr int PA_MAX_HD = 256;     // MAX_HD in paged_attention.py
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <typename T> struct Vec;        // dims one lane holds: 16 bytes
template <> struct Vec<float> {
  static constexpr int E = 4;
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void unpack(const uint4& x, float* o, float) {
  o[0] = __uint_as_float(x.x); o[1] = __uint_as_float(x.y);
  o[2] = __uint_as_float(x.z); o[3] = __uint_as_float(x.w);
}
__device__ __forceinline__ void unpack(const uint4& x, float* o, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// E elements of one row from dims [d0, d0 + E): one 16-byte load when
// ``vec``, else element by element with the dims past hd read as 0.
template <typename T>
__device__ __forceinline__ void load_row(const T* p, int d0, int hd, bool vec,
                                         float* o) {
  constexpr int E = Vec<T>::E;
  if (vec) {
    if (d0 < hd) {
      unpack(__ldg(reinterpret_cast<const uint4*>(p + d0)), o, T());
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) o[e] = 0.f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) o[e] = d0 + e < hd ? to_f32(p[d0 + e]) : 0.f;
  }
}

// One online-softmax state: NR rows, E dims each.
template <int NR, int E>
struct State {
  float m[NR], l[NR], acc[NR][E];
};

template <typename T, int NR, int NC>
__global__ void __launch_bounds__(PA_THREADS)
paged_attention_split_kernel(const T* __restrict__ q,
                             const T* __restrict__ k_pool,
                             const T* __restrict__ v_pool,
                             const int32_t* __restrict__ table,
                             const int32_t* __restrict__ lens,
                             float* __restrict__ ml,     // (B, H, n_split, 2)
                             float* __restrict__ acc_out,  // (B, H, n_split, hd)
                             int H, int Hkv, int hd, int P, int page,
                             int max_pages, int pps, int G, float qscale,
                             bool vec) {
  constexpr int E = Vec<T>::E;
  constexpr int EL = E * NC;          // dims a lane holds
  // (PA_WARPS, NR, 2 + hd) f32 for the merge, then this split's pps
  // table entries
  extern __shared__ float smem[];
  const int b = blockIdx.x, g = blockIdx.y, s = blockIdx.z;
  const int n_split = gridDim.z;
  const int n_rep = H / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = lane & (G - 1);                 // lane within its group
  const int grp = lane / G, n_grp = 32 / G;     // groups of this warp
  // dims of chunk c: [d0 + c * G * E, + E)
  const int d0 = j * E;
  auto load_lane = [&](const T* p, float (&o)[EL]) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      load_row(p, d0 + c * G * E, hd, vec, o + c * E);
  };

  const int seq_len = lens[b];
  const int n_pages = min((seq_len + page - 1) / page, max_pages);
  const int p_lo = s * pps, p_hi = min(p_lo + pps, n_pages);
  const int t_lo = p_lo * page, t_hi = min(p_hi * page, seq_len);
  const size_t row_base = ((size_t)b * H + (size_t)g * n_rep) * n_split + s;
  if (t_lo >= t_hi) {                 // wholly past the length
    if (threadIdx.x < n_rep) {
      ml[(row_base + (size_t)threadIdx.x * n_split) * 2] = NEG_INF;
      ml[(row_base + (size_t)threadIdx.x * n_split) * 2 + 1] = 0.f;
    }
    return;
  }

  float qr[NR][EL];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    if (r < n_rep) {
      load_lane(q + ((size_t)b * H + g * n_rep + r) * hd, qr[r]);
#pragma unroll
      for (int e = 0; e < EL; ++e) qr[r][e] *= qscale;
    } else {
#pragma unroll
      for (int e = 0; e < EL; ++e) qr[r][e] = 0.f;
    }
  }
  State<NR, EL> st;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    st.m[r] = NEG_INF;
    st.l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EL; ++e) st.acc[r][e] = 0.f;
  }

  // this split's table entries, checked once: a corrupt table is loud
  int* tbl = reinterpret_cast<int*>(smem + PA_WARPS * NR * (2 + hd));
  for (int i = threadIdx.x; i < p_hi - p_lo; i += PA_THREADS) {
    const int ppage = table[(size_t)b * max_pages + p_lo + i];
    if (ppage < 0 || ppage >= P) __trap();
    tbl[i] = ppage;
  }
  __syncthreads();
  const size_t tok_stride = (size_t)Hkv * hd;
  // In step i group grp of warp w holds token t_lo + i * stride + w *
  // n_grp + grp; the loop runs while the warp's first token is live, so
  // every shuffle sees the whole warp.  The next step's rows are loaded
  // before this step's are used.
  const int stride = PA_WARPS * n_grp;
  auto load = [&](int t, float (&k)[EL], float (&v)[EL]) {
    if (t < t_hi) {
      const int pi = t / page;
      const size_t row = ((size_t)tbl[pi - p_lo] * page + (t - pi * page))
                         * tok_stride + (size_t)g * hd;
      load_lane(k_pool + row, k);
      load_lane(v_pool + row, v);
    }
  };
  float kc[EL] = {}, vc[EL] = {};
  int tw = t_lo + warp * n_grp;
  load(tw + grp, kc, vc);
  while (tw < t_hi) {
    float kn[EL] = {}, vn[EL] = {};
    load(tw + stride + grp, kn, vn);      // in flight during this step
    // the n_rep dots, their sums over the group, then the softmax updates,
    // each stage over all rows at once so the shuffles and exponentials of
    // different rows overlap instead of waiting on each other
    float dot[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      dot[r] = 0.f;
#pragma unroll
      for (int e = 0; e < EL; ++e) dot[r] = fmaf(qr[r][e], kc[e], dot[r]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      if (off < G) {
#pragma unroll
        for (int r = 0; r < NR; ++r)
          dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], off);
      }
    }
    if (tw + grp < t_hi) {
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const float m = fmaxf(st.m[r], dot[r]);
        const float corr = exp2f(st.m[r] - m), p = exp2f(dot[r] - m);
        st.m[r] = m;
        st.l[r] = st.l[r] * corr + p;
#pragma unroll
        for (int e = 0; e < EL; ++e)
          st.acc[r][e] = fmaf(st.acc[r][e], corr, p * vc[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < EL; ++e) {
      kc[e] = kn[e];
      vc[e] = vn[e];
    }
    tw += stride;
  }

  // merge the groups of this warp, row by row (partners hold the same dims)
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    for (int off = G; off < 32; off <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, st.m[r], off);
      const float ol = __shfl_xor_sync(0xffffffffu, st.l[r], off);
      const float m = fmaxf(st.m[r], om);
      const float ca = exp2f(st.m[r] - m), cb = exp2f(om - m);
      st.m[r] = m;
      st.l[r] = st.l[r] * ca + ol * cb;
#pragma unroll
      for (int e = 0; e < EL; ++e) {
        const float oa = __shfl_xor_sync(0xffffffffu, st.acc[r][e], off);
        st.acc[r][e] = st.acc[r][e] * ca + oa * cb;
      }
    }
  }
  // then the warps, in shared memory: warp w, row r at (w * NR + r) * (2 + hd)
  const int ld = 2 + hd;
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      float* row = smem + (warp * NR + r) * ld;
      if (j == 0) {
        row[0] = st.m[r];
        row[1] = st.l[r];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int d = d0 + c * G * E + e;
          if (d < hd) row[2 + d] = st.acc[r][c * E + e];
        }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n_rep * hd; e += PA_THREADS) {
    const int r = e / hd, d = e % hd;
    float m = NEG_INF;
#pragma unroll
    for (int w = 0; w < PA_WARPS; ++w) m = fmaxf(m, smem[(w * NR + r) * ld]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < PA_WARPS; ++w) {
      const float* row = smem + (w * NR + r) * ld;
      const float c = exp2f(row[0] - m);   // a warp with no token: l = 0
      l += row[1] * c;
      a += row[2 + d] * c;
    }
    const size_t o = row_base + (size_t)r * n_split;
    acc_out[o * hd + d] = a;
    if (d == 0) {
      ml[o * 2] = m;
      ml[o * 2 + 1] = l;
    }
  }
}

// One block per (b, query head), CB_THREADS threads: the max of m over
// the splits that hold tokens, then each warp sums w_s * acc_s (a lane on
// dims lane + 32 j) and w_s * l_s over its share of the splits, and the
// warps' sums meet in shared memory.
constexpr int CB_THREADS = 256;
constexpr int CB_WARPS = CB_THREADS / 32;

template <typename T>
__global__ void __launch_bounds__(CB_THREADS)
paged_attention_combine_kernel(const float* __restrict__ ml,
                               const float* __restrict__ acc,
                               const int32_t* __restrict__ lens,
                               T* __restrict__ out, float* __restrict__ lse,
                               int H, int hd, int page, int max_pages,
                               int pps, int n_split) {
  extern __shared__ float part[];          // (CB_WARPS, hd + 1)
  __shared__ float wmax[CB_WARPS];
  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_pages = min((lens[b] + page - 1) / page, max_pages);
  const int n_used = (n_pages + pps - 1) / pps;   // splits that hold tokens
  const size_t base = ((size_t)b * H + h) * n_split;

  float m = NEG_INF;
  for (int s = threadIdx.x; s < n_used; s += CB_THREADS)
    m = fmaxf(m, ml[(base + s) * 2]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) wmax[warp] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < CB_WARPS; ++w) m = fmaxf(m, wmax[w]);

  constexpr int J = PA_MAX_HD / 32;        // dims a lane sums
  constexpr int K = 4;                     // splits a warp reads at once
  float num[J] = {}, den = 0.f;
  for (int s0 = warp; s0 < n_used; s0 += K * CB_WARPS) {
    float w[K], a[K][J];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = s0 + k * CB_WARPS;
      const bool ok = s < n_used;
      w[k] = ok ? exp2f(ml[(base + s) * 2] - m) : 0.f;
      den += ok ? w[k] * ml[(base + s) * 2 + 1] : 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j)
        a[k][j] = ok && lane + 32 * j < hd
                      ? acc[(base + s) * hd + lane + 32 * j] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < J; ++j) num[j] += w[k] * a[k][j];
  }
  float* row = part + warp * (hd + 1);
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (lane + 32 * j < hd) row[lane + 32 * j] = num[j];
  if (lane == 0) row[hd] = den;
  __syncthreads();
  for (int d = threadIdx.x; d < hd; d += CB_THREADS) {
    float n = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < CB_WARPS; ++w) {
      n += part[w * (hd + 1) + d];
      l += part[w * (hd + 1) + hd];
    }
    from_f32(n / fmaxf(l, 1e-30f), &out[((size_t)b * H + h) * hd + d]);
  }
  if (lse != nullptr && threadIdx.x == 0) {
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < CB_WARPS; ++w) l += part[w * (hd + 1) + hd];
    lse[(size_t)b * H + h] =
        l > 0.f ? (m + log2f(l)) * LN2 : __int_as_float(0xff800000);
  }
}

size_t paged_attention_smem_bytes(int rows, int hd, int pps) {
  return (size_t)PA_WARPS * rows * (2 + hd) * sizeof(float)
         + (size_t)pps * sizeof(int);
}

template <typename T, int NR, int NC>
int launch_rows(const void* q, const void* k_pool, const void* v_pool,
                const void* table, const void* lens, void* out, float* ml,
                float* acc, float* lse, int B, int H, int Hkv, int hd, int P, int page,
                int max_pages, int pps, int n_split, float scale,
                cudaStream_t stream) {
  constexpr int E = Vec<T>::E;
  int G = 1;
  while (G * E * NC < hd) G <<= 1;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q)
      | reinterpret_cast<uintptr_t>(k_pool) | reinterpret_cast<uintptr_t>(v_pool);
  const bool vec = addr % 16 == 0 && hd % E == 0;
  const size_t smem = paged_attention_smem_bytes(NR, hd, pps);
  paged_attention_split_kernel<T, NR, NC>
      <<<dim3(B, Hkv, n_split), PA_THREADS, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k_pool),
          static_cast<const T*>(v_pool), static_cast<const int32_t*>(table),
          static_cast<const int32_t*>(lens), ml, acc, H, Hkv, hd, P, page,
          max_pages, pps, G, scale * LOG2E, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  paged_attention_combine_kernel<T>
      <<<dim3(B, H), CB_THREADS, CB_WARPS * (hd + 1) * sizeof(float),
         stream>>>(ml, acc, static_cast<const int32_t*>(lens),
                   static_cast<T*>(out), lse, H, hd, page, max_pages, pps,
                   n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* table, const void* lens, void* out, float* ml,
           float* acc, float* lse, int B, int H, int Hkv, int hd, int P, int page,
           int max_pages, int pps, int n_split, float scale,
           cudaStream_t stream) {
  const int n_rep = H / Hkv;
  // a row in one 16-byte chunk a lane (NC 1), or two: f32 past hd 128
  constexpr int NC = sizeof(T) == 4 ? 2 : 1;
  const bool wide = NC == 2 && hd * (int)sizeof(T) > 32 * 16;
#define PA_ROWS(NR)                                                          \
  return wide ? launch_rows<T, NR, NC>(q, k_pool, v_pool, table, lens, out, \
                                       ml, acc, lse, B, H, Hkv, hd, P,      \
                                       page, max_pages, pps, n_split,       \
                                       scale, stream)                       \
              : launch_rows<T, NR, 1>(q, k_pool, v_pool, table, lens, out,  \
                                      ml, acc, lse, B, H, Hkv, hd, P, page, \
                                      max_pages, pps, n_split, scale,       \
                                      stream)
  if (hd > PA_MAX_HD) return (int)cudaErrorInvalidValue;
  if (n_rep <= 1) PA_ROWS(1);
  if (n_rep <= 2) PA_ROWS(2);
  if (n_rep <= 4) PA_ROWS(4);
  if (n_rep <= PA_MAX_REP) PA_ROWS(PA_MAX_REP);
#undef PA_ROWS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  ml: (B, H, n_split, 2) and acc:
// (B, H, n_split, hd) f32 scratch.  lse: (B, H) f32, or null for none.
// n_rep <= PA_MAX_REP and hd <=
// PA_MAX_HD (the wrapper checks).  Returns cudaGetLastError() of the first
// launch that failed, else of the second; cudaErrorInvalidValue for
// n_rep > PA_MAX_REP or hd > PA_MAX_HD.
int paged_attention_launch(const void* q, const void* k_pool,
                           const void* v_pool, const void* table,
                           const void* lens, void* out, void* ml, void* acc,
                           void* lse, int B, int H, int Hkv, int hd, int P, int page,
                           int max_pages, int pps, int n_split, float scale,
                           int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mlf = static_cast<float*>(ml);
  float* accf = static_cast<float*>(acc);
  float* lsef = static_cast<float*>(lse);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, table, lens, out, mlf, accf, lsef,
                         B, H, Hkv, hd, P, page, max_pages, pps, n_split,
                         scale, s);
  return launch<__nv_bfloat16>(q, k_pool, v_pool, table, lens, out, mlf, accf,
                               lsef, B, H, Hkv, hd, P, page, max_pages, pps,
                               n_split, scale, s);
}

}  // extern "C"
