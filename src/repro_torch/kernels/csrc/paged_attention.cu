// Paged decode attention for Hopper (sm_90a): the block table's
// lba -> pba walk fused into the attention gather, one decode step.
//
// Replaces src/repro/kernels/paged_attention.py:paged_attention_pallas
// (kernel body _paged_kernel).  Same contract: q (B, H, hd); K/V pools
// (P, page, Hkv, hd) in f32 or bf16; block_table (B, max_pages) int32;
// seq_lens (B,) int32 -> out (B, H, hd) in q's dtype.  Online softmax in
// f32 with scale 1/sqrt(hd); q head h reads kv head h / n_rep; tokens at
// or past len are masked (NEG_INF = -1e30, l clamped at 1e-30), so
// len == 0 gives zeros.
//
// Grid (B, Hkv): one block owns one sequence's kv head and the n_rep query
// rows that read it, so each K/V page is read from device memory once per
// block and used by all n_rep rows.  The block loads its own table row
// and length, and walks ceil(len / page) pages, staging one (page, hd) K
// and V tile in shared memory as f32.  The running max and sum of row r
// stay in the registers of thread r; the (n_rep, hd) accumulator is spread
// over the block's registers, PA_MAX_ELEMS values per thread.
//
// Bound: the bytes it reads, sum_b ceil(len_b / page) * page * Hkv * hd *
// 2 * sizeof(dtype), at 3.35 TB/s.  At decode sizes (a few sequences of a
// few hundred tokens) that is well under a microsecond, so launch time
// bounds it; the design keeps to one launch per layer and reads each page
// once, and leaves split-K over pages and wide vector loads to later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PA_THREADS = 128;
constexpr int PA_MAX_ELEMS = 8;   // n_rep * hd <= PA_THREADS * PA_MAX_ELEMS
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(PA_THREADS)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int32_t* __restrict__ table,
                       const int32_t* __restrict__ lens, T* __restrict__ out,
                       int H, int Hkv, int hd, int P, int page, int max_pages,
                       float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int n_rep = H / Hkv;
  const int tid = threadIdx.x;
  float* k_t = smem;                    // (page, hd)
  float* v_t = k_t + page * hd;         // (page, hd)
  float* q_s = v_t + page * hd;         // (n_rep, hd), pre-scaled
  float* p_s = q_s + n_rep * hd;        // (n_rep, page) scores -> probs
  float* row_s = p_s + n_rep * page;    // (n_rep,) corr, then final l

  const int rows_hd = n_rep * hd;
  for (int e = tid; e < rows_hd; e += PA_THREADS) {
    const int r = e / hd, d = e % hd;
    q_s[e] = to_f32(q[((size_t)b * H + g * n_rep + r) * hd + d]) * scale;
  }
  const int seq_len = lens[b];
  int n_pages = (seq_len + page - 1) / page;
  if (n_pages > max_pages) n_pages = max_pages;

  float acc[PA_MAX_ELEMS];
#pragma unroll
  for (int j = 0; j < PA_MAX_ELEMS; ++j) acc[j] = 0.f;
  float m_run = NEG_INF, l_run = 0.f;   // meaningful in threads r < n_rep

  const size_t tok_stride = (size_t)Hkv * hd;
  for (int pi = 0; pi < n_pages; ++pi) {
    const int ppage = table[(size_t)b * max_pages + pi];
    if (ppage < 0 || ppage >= P) __trap();   // a corrupt table is loud
    const size_t base = (size_t)ppage * page * tok_stride + (size_t)g * hd;
    __syncthreads();   // previous tile fully consumed (and q_s written)
    for (int e = tid; e < page * hd; e += PA_THREADS) {
      const int t = e / hd, d = e % hd;
      k_t[e] = to_f32(k_pool[base + t * tok_stride + d]);
      v_t[e] = to_f32(v_pool[base + t * tok_stride + d]);
    }
    __syncthreads();
    for (int e = tid; e < n_rep * page; e += PA_THREADS) {
      const int r = e / page, t = e % page;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s += q_s[r * hd + d] * k_t[t * hd + d];
      p_s[e] = (pi * page + t < seq_len) ? s : NEG_INF;
    }
    __syncthreads();
    if (tid < n_rep) {
      float* s_row = p_s + tid * page;
      float m_cur = NEG_INF;
      for (int t = 0; t < page; ++t) m_cur = fmaxf(m_cur, s_row[t]);
      const float m_new = fmaxf(m_run, m_cur);
      float psum = 0.f;
      for (int t = 0; t < page; ++t) {
        const float p = (pi * page + t < seq_len) ? expf(s_row[t] - m_new) : 0.f;
        s_row[t] = p;
        psum += p;
      }
      const float corr = expf(m_run - m_new);
      l_run = l_run * corr + psum;
      m_run = m_new;
      row_s[tid] = corr;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PA_MAX_ELEMS; ++j) {
      const int e = tid + j * PA_THREADS;
      if (e < rows_hd) {
        const int r = e / hd, d = e % hd;
        const float* p_row = p_s + r * page;
        float pv = 0.f;
        for (int t = 0; t < page; ++t) pv += p_row[t] * v_t[t * hd + d];
        acc[j] = acc[j] * row_s[r] + pv;
      }
    }
  }
  __syncthreads();
  if (tid < n_rep) row_s[tid] = fmaxf(l_run, 1e-30f);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < PA_MAX_ELEMS; ++j) {
    const int e = tid + j * PA_THREADS;
    if (e < rows_hd) {
      const int r = e / hd, d = e % hd;
      from_f32(acc[j] / row_s[r], &out[((size_t)b * H + g * n_rep + r) * hd + d]);
    }
  }
}

template <typename T>
void launch(const void* q, const void* k_pool, const void* v_pool,
            const void* table, const void* lens, void* out, int B, int H,
            int Hkv, int hd, int P, int page, int max_pages, float scale,
            size_t smem, cudaStream_t stream) {
  dim3 grid(B, Hkv);
  paged_attention_kernel<T><<<grid, PA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(lens), static_cast<T*>(out), H, Hkv, hd, P,
      page, max_pages, scale);
}

}  // namespace

extern "C" {

// Largest n_rep * hd one block holds in registers.
int paged_attention_max_rows_hd() { return PA_THREADS * PA_MAX_ELEMS; }

// Shared memory one block needs, in bytes.
long long paged_attention_smem_bytes(int n_rep, int hd, int page) {
  return (long long)(2 * page * hd + n_rep * hd + n_rep * page + n_rep) * 4;
}

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
int paged_attention_launch(const void* q, const void* k_pool,
                           const void* v_pool, const void* table,
                           const void* lens, void* out, int B, int H, int Hkv,
                           int hd, int P, int page, int max_pages, float scale,
                           int dtype, void* stream) {
  const size_t smem = (size_t)paged_attention_smem_bytes(H / Hkv, hd, page);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(q, k_pool, v_pool, table, lens, out, B, H, Hkv, hd, P, page,
                  max_pages, scale, smem, s);
  else
    launch<__nv_bfloat16>(q, k_pool, v_pool, table, lens, out, B, H, Hkv, hd,
                          P, page, max_pages, scale, smem, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
