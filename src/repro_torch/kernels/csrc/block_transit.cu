// Block transit codec for Hopper (sm_90a): the KV page spill and restore
// passes, with the wire checksum fused into the same traversal, over a
// batch of units in one launch.
//
// Replaces, in src/repro/kernels/block_transit.py:
//   gather_quantize_crc_pallas   (_gather_q_crc_kernel, _page_adler32)
//   gather_quantize_pallas       (_gather_q_kernel)       WITH_CRC = false
//   scatter_dequantize_crc_pallas (_scatter_dq_crc_kernel)
//   scatter_dequantize_pallas    (_scatter_dq_kernel)    WITH_CRC = false
//
// The pools are one stack (S, P, page_sz, F): S slots (the KV cache's
// layer x {K, V}), each a pool of P pages.  A unit is one (slot, page)
// pair from the (n, 2) int32 unit list, and the TPU kernel's page is one
// unit: its data start at ((slot * P) + page) * page_sz * F.
//
// gather: for unit i, x = stack[slot][page] (page_sz, F) as f32; per row
//   scale = amax / 127 + eps and q = clip(rint(x / scale), -127, 127) as
//   int8; with WITH_CRC the Adler-32 of the unit's int8 bytes (row-major,
//   read as uint8).  rintf rounds half to even and '/' is IEEE division
//   (the build uses no fast-math), so q and the scales are bit-identical to
//   the plain PyTorch version and the crc equals zlib.adler32.
// scatter: stack[slot][page] = (q[i] as f32 * scale[i][:, None]) in the
//   pool's dtype, in place; only the units named are written, and units are
//   unique within one call.  With WITH_CRC the Adler-32 of the int8 payload
//   as received.
//
// One block per unit: a serving page-out is 2 x n_layers units per page
// (72 for qwen2.5-3b, 64 for phi3-mini-3.8b), so a launch holds hundreds to
// tens of thousands of blocks and fills the 132 SMs.  Each thread moves
// V = 16 elements at a time (16-byte loads of the pool, one 16-byte int8
// store) when F % 16 == 0 and the pointers are 16-byte aligned, else one.
// gather: a row is split over LPR lanes (the largest power of two <= 32
// that F / V chunks fill), so a warp holds 32 / LPR rows; the row's absmax
// is reduced with xor shuffles inside its lane group.  Adler-32 is two
// sums: S1 = 1 + sum(d) and S2 = n + sum((n - e) * d_e) over the n bytes;
// each thread accumulates its bytes' terms in 64 bits, the block reduces
// them once, and thread 0 takes both mod 65521 and writes S2 << 16 | S1 as
// an int64.  Offsets are 64-bit: a 4000-token qwen2.5-3b sequence is
// 18072 units, 74 MB of int8.
//
// Bound: bytes, one read of each unit and one write of its other form
// (page_sz * F * (sizeof(dtype) + 1) plus the scales and the unit list),
// at 3.35 TB/s: 0.27 us for a qwen2.5-3b page of 72 units, 2.8 us for a
// phi3-mini-3.8b page of 64.
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

// V consecutive elements of type T at p, as f32 (V == 16: 16-byte loads).
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* out) {
  if constexpr (V == 1) {
    out[0] = to_f32(*p);
  } else {
    alignas(16) T buf[V];
#pragma unroll
    for (int i = 0; i < V * (int)sizeof(T) / 16; ++i)
      reinterpret_cast<uint4*>(buf)[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = to_f32(buf[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float* x) {
  if constexpr (V == 1) {
    from_f32(x[0], p);
  } else {
    alignas(16) T buf[V];
#pragma unroll
    for (int i = 0; i < V; ++i) from_f32(x[i], &buf[i]);
#pragma unroll
    for (int i = 0; i < V * (int)sizeof(T) / 16; ++i)
      reinterpret_cast<uint4*>(p)[i] = reinterpret_cast<const uint4*>(buf)[i];
  }
}

// The Adler terms of V bytes starting at byte e0 of an n-byte unit:
// s1 += sum(d), s2 += sum((n - e0 - i) * d_i).
template <int V>
__device__ __forceinline__ void adler_add(const int8_t* q, unsigned long long e0,
                                          unsigned long long n,
                                          unsigned long long& s1,
                                          unsigned long long& s2) {
  unsigned int sd = 0, sid = 0;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const unsigned int d = (uint8_t)q[i];
    sd += d;
    sid += (unsigned int)i * d;
  }
  s1 += sd;
  s2 += (n - e0) * sd - sid;
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

// The unit's offset in the stack, in elements; a unit out of range is loud.
__device__ __forceinline__ size_t unit_base(const int32_t* __restrict__ units,
                                            int S, int P, int page_sz, int F) {
  const int slot = units[2 * (size_t)blockIdx.x];
  const int page = units[2 * (size_t)blockIdx.x + 1];
  if (slot < 0 || slot >= S || page < 0 || page >= P) __trap();
  return ((size_t)slot * P + page) * page_sz * F;
}

template <typename T, int V, bool WITH_CRC>
__global__ void __launch_bounds__(BT_THREADS)
gather_quantize_kernel(const T* __restrict__ stack,
                       const int32_t* __restrict__ units,
                       int8_t* __restrict__ q_out, float* __restrict__ scales,
                       int64_t* __restrict__ crcs, int S, int P, int page_sz,
                       int F, int lpr, float eps) {
  const size_t i = blockIdx.x;
  const T* x = stack + unit_base(units, S, P, page_sz, F);
  int8_t* q = q_out + i * page_sz * F;
  const unsigned long long n = (unsigned long long)page_sz * F;
  const int chunks = F / V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rpw = 32 / lpr, sub = lane % lpr;
  unsigned long long s1 = 0, s2 = 0;
  // every lane of a warp runs the same trips, so the shuffles are full
  for (int r0 = warp * rpw; r0 < page_sz; r0 += BT_WARPS * rpw) {
    const int r = r0 + lane / lpr;
    const bool live = r < page_sz;
    const T* row = x + (size_t)r * F;
    float v[V];
    float amax = 0.f;
    if (live)
      for (int c = sub; c < chunks; c += lpr) {
        load_vec<T, V>(row + (size_t)c * V, v);
#pragma unroll
        for (int k = 0; k < V; ++k) amax = fmaxf(amax, fabsf(v[k]));
      }
    for (int off = lpr / 2; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (!live) continue;
    const float scale = amax / 127.0f + eps;
    int8_t* qrow = q + (size_t)r * F;
    for (int c = sub; c < chunks; c += lpr) {
      load_vec<T, V>(row + (size_t)c * V, v);
      alignas(16) int8_t qv[V];
#pragma unroll
      for (int k = 0; k < V; ++k)
        qv[k] = (int8_t)fminf(fmaxf(rintf(v[k] / scale), -127.f), 127.f);
      if constexpr (V == 1)
        qrow[c] = qv[0];
      else
        *reinterpret_cast<uint4*>(qrow + (size_t)c * V) =
            *reinterpret_cast<const uint4*>(qv);
      if (WITH_CRC)
        adler_add<V>(qv, (unsigned long long)r * F + (unsigned long long)c * V,
                     n, s1, s2);
    }
    if (sub == 0) scales[i * page_sz + r] = scale;
  }
  if (WITH_CRC) {
    block_sum2(s1, s2);
    if (threadIdx.x == 0) crcs[i] = adler_finish(s1, s2, n);
  }
}

template <typename T, int V, bool WITH_CRC>
__global__ void __launch_bounds__(BT_THREADS)
scatter_dequantize_kernel(T* __restrict__ stack,
                          const int32_t* __restrict__ units,
                          const int8_t* __restrict__ q_in,
                          const float* __restrict__ scales,
                          int64_t* __restrict__ crcs, int S, int P,
                          int page_sz, int F) {
  const size_t i = blockIdx.x;
  T* x = stack + unit_base(units, S, P, page_sz, F);
  const int8_t* q = q_in + i * page_sz * F;
  const float* sc = scales + i * page_sz;
  const unsigned long long n = (unsigned long long)page_sz * F;
  unsigned long long s1 = 0, s2 = 0;
  // a chunk of V elements never straddles a row: F % V == 0
  for (unsigned long long e = (unsigned long long)threadIdx.x * V; e < n;
       e += (unsigned long long)BT_THREADS * V) {
    alignas(16) int8_t qv[V];
    if constexpr (V == 1)
      qv[0] = q[e];
    else
      *reinterpret_cast<uint4*>(qv) = __ldg(reinterpret_cast<const uint4*>(q + e));
    const float s = sc[e / F];
    float v[V];
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = (float)qv[k] * s;
    store_vec<T, V>(x + e, v);
    if (WITH_CRC) adler_add<V>(qv, e, n, s1, s2);
  }
  if (WITH_CRC) {
    block_sum2(s1, s2);
    if (threadIdx.x == 0) crcs[i] = adler_finish(s1, s2, n);
  }
}

// 16 elements a thread where the rows and pointers allow 16-byte accesses.
bool vector_ok(int F, const void* a, const void* b) {
  return F % 16 == 0 &&
         ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
}

// Lanes a gather row is split over: the largest power of two <= 32 that
// does not exceed the row's chunks.
int lanes_per_row(int chunks) {
  int l = 32;
  while (l > 1 && l > chunks) l >>= 1;
  return l;
}

template <typename T, int V, bool C>
void gather_launch(const void* stack, const void* units, void* q, void* scales,
                   void* crcs, int n, int S, int P, int page_sz, int F,
                   float eps, cudaStream_t s) {
  gather_quantize_kernel<T, V, C><<<n, BT_THREADS, 0, s>>>(
      static_cast<const T*>(stack), static_cast<const int32_t*>(units),
      static_cast<int8_t*>(q), static_cast<float*>(scales),
      static_cast<int64_t*>(crcs), S, P, page_sz, F, lanes_per_row(F / V), eps);
}

template <typename T, int V, bool C>
void scatter_launch(void* stack, const void* units, const void* q,
                    const void* scales, void* crcs, int n, int S, int P,
                    int page_sz, int F, cudaStream_t s) {
  scatter_dequantize_kernel<T, V, C><<<n, BT_THREADS, 0, s>>>(
      static_cast<T*>(stack), static_cast<const int32_t*>(units),
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<int64_t*>(crcs), S, P, page_sz, F);
}

template <typename T>
void gather_dispatch(const void* stack, const void* units, void* q,
                     void* scales, void* crcs, int n, int S, int P,
                     int page_sz, int F, float eps, cudaStream_t s) {
  const bool vec = vector_ok(F, stack, q);
  if (crcs && vec)
    gather_launch<T, 16, true>(stack, units, q, scales, crcs, n, S, P, page_sz, F, eps, s);
  else if (crcs)
    gather_launch<T, 1, true>(stack, units, q, scales, crcs, n, S, P, page_sz, F, eps, s);
  else if (vec)
    gather_launch<T, 16, false>(stack, units, q, scales, crcs, n, S, P, page_sz, F, eps, s);
  else
    gather_launch<T, 1, false>(stack, units, q, scales, crcs, n, S, P, page_sz, F, eps, s);
}

template <typename T>
void scatter_dispatch(void* stack, const void* units, const void* q,
                      const void* scales, void* crcs, int n, int S, int P,
                      int page_sz, int F, cudaStream_t s) {
  const bool vec = vector_ok(F, stack, q);
  if (crcs && vec)
    scatter_launch<T, 16, true>(stack, units, q, scales, crcs, n, S, P, page_sz, F, s);
  else if (crcs)
    scatter_launch<T, 1, true>(stack, units, q, scales, crcs, n, S, P, page_sz, F, s);
  else if (vec)
    scatter_launch<T, 16, false>(stack, units, q, scales, crcs, n, S, P, page_sz, F, s);
  else
    scatter_launch<T, 1, false>(stack, units, q, scales, crcs, n, S, P, page_sz, F, s);
}

}  // namespace

extern "C" {

// stack: (S, P, page_sz, F); units: (n, 2) int32 (slot, page).
// dtype: 0 = float32, 1 = bfloat16.  crcs == NULL selects the instance
// without the checksum.  Each returns cudaGetLastError().
int gather_quantize_launch(const void* stack, const void* units, void* q,
                           void* scales, void* crcs, int n, int S, int P,
                           int page_sz, int F, float eps, int dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    gather_dispatch<float>(stack, units, q, scales, crcs, n, S, P, page_sz, F,
                           eps, s);
  else
    gather_dispatch<__nv_bfloat16>(stack, units, q, scales, crcs, n, S, P,
                                   page_sz, F, eps, s);
  return (int)cudaGetLastError();
}

int scatter_dequantize_launch(void* stack, const void* units, const void* q,
                              const void* scales, void* crcs, int n, int S,
                              int P, int page_sz, int F, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    scatter_dispatch<float>(stack, units, q, scales, crcs, n, S, P, page_sz, F,
                            s);
  else
    scatter_dispatch<__nv_bfloat16>(stack, units, q, scales, crcs, n, S, P,
                                    page_sz, F, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
