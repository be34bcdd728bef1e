// Block transit codec for Hopper (sm_90a): the KV page spill and restore
// passes, with the wire checksum fused into the same traversal.
//
// Replaces, in src/repro/kernels/block_transit.py:
//   gather_quantize_crc_pallas   (_gather_q_crc_kernel, _page_adler32)
//   gather_quantize_pallas       (_gather_q_kernel)       WITH_CRC = false
//   scatter_dequantize_crc_pallas (_scatter_dq_crc_kernel)
//   scatter_dequantize_pallas    (_scatter_dq_kernel)    WITH_CRC = false
//
// gather: for page i, x = pool[ids[i]] (page_sz, F) as f32; per row
//   scale = amax / 127 + eps and q = clip(rint(x / scale), -127, 127) as
//   int8; with WITH_CRC the Adler-32 of the page's int8 bytes (row-major,
//   read as uint8).  rintf rounds half to even and '/' is IEEE division
//   (the build uses no fast-math), so q and the scales are bit-identical to
//   the plain PyTorch version and the crc equals zlib.adler32.
// scatter: pool[ids[i]] = (q[i] as f32 * scale[i][:, None]) in the pool's
//   dtype, in place; only the pages named by ids are written, and ids are
//   unique within one call.  With WITH_CRC the Adler-32 of the int8 payload
//   as received.
//
// One block per page.  Adler-32 is two sums: S1 = 1 + sum(d) and
// S2 = n + sum((n - i) * d_i) over the n bytes; each thread accumulates
// its bytes' terms in 64 bits, the block reduces them, and thread 0 takes
// both mod 65521 and writes S2 << 16 | S1 as an int64.
//
// Bound: bytes, one read of the page and one write of its other form
// (page_sz * F * (sizeof(dtype) + 1) plus the scales), at 3.35 TB/s: a few
// nanoseconds for one 16 x 256 page, so a launch costs far more than its
// data.  The serving path launches once per layer, for K and for V, with
// n = 1; batching pages and layers into one launch is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BT_THREADS = 256;
constexpr int BT_WARPS = BT_THREADS / 32;
constexpr unsigned long long ADLER_MOD = 65521ull;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

// Block-wide sum of both Adler partial sums; result valid in thread 0.
__device__ __forceinline__ void block_sum2(unsigned long long& a,
                                           unsigned long long& b) {
  __shared__ unsigned long long red[2][BT_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = 0;
    b = 0;
    for (int w = 0; w < BT_WARPS; ++w) {
      a += red[0][w];
      b += red[1][w];
    }
  }
}

__device__ __forceinline__ int64_t adler_finish(unsigned long long s1,
                                                unsigned long long s2,
                                                unsigned long long n) {
  const unsigned long long a = (1ull + s1) % ADLER_MOD;
  const unsigned long long b = (n + s2) % ADLER_MOD;
  return (int64_t)((b << 16) | a);
}

template <typename T, bool WITH_CRC>
__global__ void __launch_bounds__(BT_THREADS)
gather_quantize_kernel(const T* __restrict__ pool,
                       const int32_t* __restrict__ ids,
                       int8_t* __restrict__ q_out, float* __restrict__ scales,
                       int64_t* __restrict__ crcs, int P, int page_sz, int F,
                       float eps) {
  const int i = blockIdx.x;
  const int page = ids[i];
  if (page < 0 || page >= P) __trap();     // an id out of range is loud
  const T* x = pool + (size_t)page * page_sz * F;
  int8_t* q = q_out + (size_t)i * page_sz * F;
  const unsigned long long n = (unsigned long long)page_sz * F;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long s1 = 0, s2 = 0;
  for (int r = warp; r < page_sz; r += BT_WARPS) {
    const T* row = x + (size_t)r * F;
    float amax = 0.f;
    for (int c = lane; c < F; c += 32) amax = fmaxf(amax, fabsf(to_f32(row[c])));
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float scale = amax / 127.0f + eps;
    for (int c = lane; c < F; c += 32) {
      const float v = fminf(fmaxf(rintf(to_f32(row[c]) / scale), -127.f), 127.f);
      const int8_t qv = (int8_t)v;
      q[(size_t)r * F + c] = qv;
      if (WITH_CRC) {
        const unsigned long long d = (unsigned long long)(uint8_t)qv;
        s1 += d;
        s2 += (n - ((unsigned long long)r * F + c)) * d;
      }
    }
    if (lane == 0) scales[(size_t)i * page_sz + r] = scale;
  }
  if (WITH_CRC) {
    block_sum2(s1, s2);
    if (threadIdx.x == 0) crcs[i] = adler_finish(s1, s2, n);
  }
}

template <typename T, bool WITH_CRC>
__global__ void __launch_bounds__(BT_THREADS)
scatter_dequantize_kernel(T* __restrict__ pool, const int32_t* __restrict__ ids,
                          const int8_t* __restrict__ q_in,
                          const float* __restrict__ scales,
                          int64_t* __restrict__ crcs, int P, int page_sz,
                          int F) {
  const int i = blockIdx.x;
  const int page = ids[i];
  if (page < 0 || page >= P) __trap();
  T* x = pool + (size_t)page * page_sz * F;
  const int8_t* q = q_in + (size_t)i * page_sz * F;
  const float* sc = scales + (size_t)i * page_sz;
  const unsigned long long n = (unsigned long long)page_sz * F;
  unsigned long long s1 = 0, s2 = 0;
  for (unsigned long long e = threadIdx.x; e < n; e += BT_THREADS) {
    const int8_t qv = q[e];
    from_f32((float)qv * sc[e / F], &x[e]);
    if (WITH_CRC) {
      const unsigned long long d = (unsigned long long)(uint8_t)qv;
      s1 += d;
      s2 += (n - e) * d;
    }
  }
  if (WITH_CRC) {
    block_sum2(s1, s2);
    if (threadIdx.x == 0) crcs[i] = adler_finish(s1, s2, n);
  }
}

template <typename T>
void gather_launch(const void* pool, const void* ids, void* q, void* scales,
                   void* crcs, int n, int P, int page_sz, int F, float eps,
                   cudaStream_t s) {
  const T* p = static_cast<const T*>(pool);
  const int32_t* id = static_cast<const int32_t*>(ids);
  int8_t* qo = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(scales);
  int64_t* co = static_cast<int64_t*>(crcs);
  if (crcs)
    gather_quantize_kernel<T, true><<<n, BT_THREADS, 0, s>>>(p, id, qo, so, co, P,
                                                             page_sz, F, eps);
  else
    gather_quantize_kernel<T, false><<<n, BT_THREADS, 0, s>>>(p, id, qo, so, co,
                                                              P, page_sz, F, eps);
}

template <typename T>
void scatter_launch(void* pool, const void* ids, const void* q,
                    const void* scales, void* crcs, int n, int P, int page_sz,
                    int F, cudaStream_t s) {
  T* p = static_cast<T*>(pool);
  const int32_t* id = static_cast<const int32_t*>(ids);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const float* si = static_cast<const float*>(scales);
  int64_t* co = static_cast<int64_t*>(crcs);
  if (crcs)
    scatter_dequantize_kernel<T, true><<<n, BT_THREADS, 0, s>>>(p, id, qi, si, co,
                                                                P, page_sz, F);
  else
    scatter_dequantize_kernel<T, false><<<n, BT_THREADS, 0, s>>>(p, id, qi, si,
                                                                 co, P, page_sz, F);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  crcs == NULL selects the instance
// without the checksum.  Each returns cudaGetLastError().
int gather_quantize_launch(const void* pool, const void* ids, void* q,
                           void* scales, void* crcs, int n, int P, int page_sz,
                           int F, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    gather_launch<float>(pool, ids, q, scales, crcs, n, P, page_sz, F, eps, s);
  else
    gather_launch<__nv_bfloat16>(pool, ids, q, scales, crcs, n, P, page_sz, F,
                                 eps, s);
  return (int)cudaGetLastError();
}

int scatter_dequantize_launch(void* pool, const void* ids, const void* q,
                              const void* scales, void* crcs, int n, int P,
                              int page_sz, int F, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    scatter_launch<float>(pool, ids, q, scales, crcs, n, P, page_sz, F, s);
  else
    scatter_launch<__nv_bfloat16>(pool, ids, q, scales, crcs, n, P, page_sz, F,
                                  s);
  return (int)cudaGetLastError();
}

}  // extern "C"
