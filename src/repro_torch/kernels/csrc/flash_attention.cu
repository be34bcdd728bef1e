// Blocked flash attention for Hopper (sm_90a): the serving prefill's
// attention (causal, sliding-window or non-causal, GQA), online softmax.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention_pallas
// (kernel body _attn_kernel).  Same contract: q (B, T, H, hd); k, v
// (B, S, Hkv, hd), all f32 or all bf16, contiguous -> out (B, T, H, hd) in
// q's dtype.  Online softmax in f32 with scale 1/sqrt(hd); q head h reads
// kv head h / (H / Hkv).  Key positions start at 0, query positions at
// q_off (0 but for a shard of the query rows, T != S allowed): causal
// keeps k_pos <= q_pos, window > 0 keeps q_pos - k_pos < window.  Masked scores are NEG_INF = -1e30 and get
// probability 0, and the sum is clamped at 1e-30, so a row with no valid
// key gives 0.  Unlike the TPU kernel, T and S take any length: the block
// masks the ragged edge of both itself.
//
// Grid (ceil(T / 64), H, B), 256 threads.  One block owns 64 query rows
// of one head and walks the key/value tiles of 64 tokens that some row of
// it can see: tiles above the diagonal (causal) and below the window are
// never loaded, as the TPU kernel bounds its loop.  The q-tile index runs
// backwards over blockIdx.x so the longest causal rows start first.  Each
// tile is staged in shared memory as f32: Q (pre-scaled) and K with each
// row padded by one float, so the 16 keys a half-warp reads in one step
// fall in 16 different banks; V unpadded, read along hd.  Thread (tr, tc)
// = (tid / 16, tid % 16) holds the scores of rows tr + 16 i and keys
// tc + 16 j (4 x 4), and the output of rows tr + 16 i and dims tc + 16 c
// (4 x DPT): the softmax of a row is reduced over the 16 lanes of one
// half-warp with shuffles, and the running max, sum and correction stay
// in registers.  DPT is 8 for hd <= 128 and 16 for hd <= 256 (an instance
// each, so the narrower heads keep their registers); at hd 256 the tiles
// take 209 KB of shared memory, one block an SM.  Loads from device
// memory are 16 bytes a thread when hd and the pointers allow it.
//
// Bound: causal prefill at serving widths is bound by operations, 4 * hd
// flops per valid (query head, q, k) pair; this kernel runs them on the
// f32 FMA units (67 TFLOP/s), not the bf16 tensor cores (989).  It takes
// what the tensor-core kernel (flash_attention_sm90.cu) cannot: f32, which
// must not round to TF32, and bf16 with hd % 8 != 0, which TMA cannot map.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FA_TILE = 64;            // tokens per Q and per K/V tile
constexpr int FA_BQ = FA_TILE;
constexpr int FA_BK = FA_TILE;
constexpr int FA_THREADS = 256;
constexpr int FA_MAX_HD = 16 * 16;   // 16 lanes x 16 dims; MAX_HD in .py
constexpr int FA_RPT = FA_BQ / 16;      // query rows per thread
constexpr int FA_KPT = FA_BK / 16;      // keys per thread
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

// 16 bytes from device memory as f32: 4 floats or 8 bf16 values.
__device__ __forceinline__ void load16(const float* p, float* o) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* o) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// Stage rows [t0, t0 + 64) of one head into dst (row pitch ld floats),
// times mul; rows at or past n_tok are zeros.  src points at token 0 of
// the head, tok_stride elements between tokens.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      size_t tok_stride, int t0, int n_tok,
                                      int hd, float mul, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int per_row = hd / V;
    for (int c = threadIdx.x; c < FA_TILE * per_row; c += FA_THREADS) {
      const int r = c / per_row, d0 = (c % per_row) * V;
      float x[V];
      if (t0 + r < n_tok) {
        load16(src + (size_t)(t0 + r) * tok_stride + d0, x);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) x[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < V; ++i) dst[r * ld + d0 + i] = x[i] * mul;
    }
  } else {
    for (int e = threadIdx.x; e < FA_TILE * hd; e += FA_THREADS) {
      const int r = e / hd, d = e % hd;
      dst[r * ld + d] = t0 + r < n_tok
          ? to_f32(src[(size_t)(t0 + r) * tok_stride + d]) * mul : 0.f;
    }
  }
}

// DPT: output dims per thread, hd <= 16 * DPT.
template <typename T, int DPT>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int T_len, int S, int H, int Hkv, int hd, float scale,
                       int causal, int window, int q_off, bool vec) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* q_s = smem;                   // (BQ, hd + 1), pre-scaled
  float* k_s = q_s + FA_BQ * ld;       // (BK, hd + 1)
  float* v_s = k_s + FA_BK * ld;       // (BK, hd)
  float* p_s = v_s + FA_BK * hd;       // (BQ, BK + 1) probabilities

  const int q0 = (gridDim.x - 1 - blockIdx.x) * FA_BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / Hkv);
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;

  stage(q_s, ld, q + ((size_t)b * T_len * H + h) * hd, (size_t)H * hd, q0,
        T_len, hd, scale, vec);
  const size_t kv_stride = (size_t)Hkv * hd;
  const T* k_head = k + ((size_t)b * S * Hkv + g) * hd;
  const T* v_head = v + ((size_t)b * S * Hkv + g) * hd;

  float m_run[FA_RPT], l_run[FA_RPT], acc[FA_RPT][DPT];
#pragma unroll
  for (int i = 0; i < FA_RPT; ++i) {
    m_run[i] = NEG_INF;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  // Keys some row of this block can see: [lo, hi); its rows' positions
  // start at p0.
  const int p0 = q_off + q0;
  const int hi = causal ? min(S, p0 + FA_BQ) : S;
  const int lo = window > 0 ? max(0, p0 - window + 1) : 0;
  const int kt_hi = (hi + FA_BK - 1) / FA_BK;
  for (int kt = lo / FA_BK; kt < kt_hi; ++kt) {
    const int k0 = kt * FA_BK;
    __syncthreads();   // the previous tile is consumed (and q_s written)
    stage(k_s, ld, k_head, kv_stride, k0, S, hd, 1.f, vec);
    stage(v_s, hd, v_head, kv_stride, k0, S, hd, 1.f, vec);
    __syncthreads();

    float s[FA_RPT][FA_KPT];
#pragma unroll
    for (int i = 0; i < FA_RPT; ++i)
#pragma unroll
      for (int j = 0; j < FA_KPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float qv[FA_RPT], kv[FA_KPT];
#pragma unroll
      for (int i = 0; i < FA_RPT; ++i) qv[i] = q_s[(tr + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < FA_KPT; ++j) kv[j] = k_s[(tc + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < FA_RPT; ++i)
#pragma unroll
        for (int j = 0; j < FA_KPT; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < FA_RPT; ++i) {
      const int qp = p0 + tr + 16 * i;
      bool ok[FA_KPT];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < FA_KPT; ++j) {
        const int kp = k0 + tc + 16 * j;
        ok[j] = kp < S && (!causal || kp <= qp)
                && (window <= 0 || qp - kp < window);
        s[i][j] = ok[j] ? s[i][j] : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < FA_KPT; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[(tr + 16 * i) * (FA_BK + 1) + tc + 16 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float corr = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * corr + psum;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    const int n_t = min(FA_BK, S - k0);
    for (int t = 0; t < n_t; ++t) {
      float pv[FA_RPT];
#pragma unroll
      for (int i = 0; i < FA_RPT; ++i)
        pv[i] = p_s[(tr + 16 * i) * (FA_BK + 1) + t];
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int d = tc + 16 * c;
        if (d < hd) {
          const float vv = v_s[t * hd + d];
#pragma unroll
          for (int i = 0; i < FA_RPT; ++i) acc[i][c] += pv[i] * vv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < FA_RPT; ++i) {
    const int qp = q0 + tr + 16 * i;
    if (qp < T_len) {
      const float l = fmaxf(l_run[i], 1e-30f);
      T* o = out + (((size_t)b * T_len + qp) * H + h) * hd;
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int d = tc + 16 * c;
        if (d < hd) from_f32(acc[i][c] / l, o + d);
      }
    }
  }
}

size_t smem_bytes(int hd) {
  return (size_t)(2 * FA_BQ * (hd + 1) + FA_BK * hd + FA_BQ * (FA_BK + 1))
         * sizeof(float);
}

template <typename T, int DPT>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int T_len, int S, int H, int Hkv, int hd, float scale, int causal,
           int window, int q_off, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, DPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q)
      | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  const bool vec = addr % 16 == 0 && hd % (16 / sizeof(T)) == 0;
  const dim3 grid((T_len + FA_BQ - 1) / FA_BQ, H, B);
  flash_attention_kernel<T, DPT><<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), T_len, S, H, Hkv, hd,
      scale, causal, window, q_off, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; hd <= FA_MAX_HD; q_off the position
// of query row 0.  Returns
// cudaGetLastError() (or the error of raising the block's shared-memory
// limit), cudaErrorInvalidValue for a wider head.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int T_len, int S, int H, int Hkv,
                           int hd, float scale, int causal, int window,
                           int q_off, int dtype, void* stream) {
  if (hd > FA_MAX_HD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA_LAUNCH(T, DPT)                                                   \
  return launch<T, DPT>(q, k, v, out, B, T_len, S, H, Hkv, hd, scale,       \
                        causal, window, q_off, s)
  if (dtype == 0) {
    if (hd <= 128) FA_LAUNCH(float, 8);
    FA_LAUNCH(float, 16);
  }
  if (hd <= 128) FA_LAUNCH(__nv_bfloat16, 8);
  FA_LAUNCH(__nv_bfloat16, 16);
#undef FA_LAUNCH
}

}  // extern "C"
