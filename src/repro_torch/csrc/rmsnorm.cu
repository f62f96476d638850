// RMSNorm for Hopper (sm_90a): out = x * rsqrt(mean(x^2) + eps) * w.
//
// Replaces the Pallas kernel `rms_norm` (src/repro/kernels/rmsnorm.py).
// The op is bound by memory: it reads x and w once and writes out once,
// a handful of flops per byte.  One block of 256 threads owns one row.
// Each thread loads its share of the row as 16-byte vectors and keeps
// them in registers, so x is read from device memory exactly once; the
// sum of squares is reduced in fp32 across the warp (shuffles) and then
// across the block (shared memory), and each element is scaled and
// written once in x's dtype.
//
// Plain C interface, bound from Python with ctypes; the wrapper checks
// shapes, dtypes, contiguity and 16-byte alignment before calling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVecs = 8;  // 16-byte vectors a thread keeps in registers

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w,
               T* __restrict__ out, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const int nvec = d / VEC;
  const size_t row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  uint4* orow = reinterpret_cast<uint4*>(out + row * d);

  uint4 cache[kMaxVecs];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int v = threadIdx.x + i * kThreads;
    if (v < nvec) {
      cache[i] = xr[v];
      const T* e = reinterpret_cast<const T*>(&cache[i]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = to_float(e[j]);
        ss += f * f;
      }
    }
  }

  __shared__ float partial[kThreads / 32];
  __shared__ float inv_rms;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kThreads / 32 ? partial[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) inv_rms = rsqrtf(t / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float inv = inv_rms;

#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int v = threadIdx.x + i * kThreads;
    if (v < nvec) {
      const T* e = reinterpret_cast<const T*>(&cache[i]);
      uint4 res;
      T* r = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        r[j] = from_float<T>(to_float(e[j]) * inv * to_float(w[v * VEC + j]));
      }
      orow[v] = res;
    }
  }
}

template <typename T, typename W>
int launch(const void* x, const void* w, void* out, int rows, int d,
           float eps, cudaStream_t stream) {
  rmsnorm_kernel<T, W><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<T*>(out), d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.
extern "C" int repro_rmsnorm_max_dim(int x_dtype) {
  return kThreads * kMaxVecs * (x_dtype == 1 ? 8 : 4);
}

extern "C" int repro_rmsnorm(const void* x, const void* w, void* out,
                             int rows, int d, float eps, int x_dtype,
                             int w_dtype, void* stream) {
  if (rows <= 0) return 0;
  const int vec = x_dtype == 1 ? 8 : 4;
  if (d <= 0 || d % vec != 0 || d > repro_rmsnorm_max_dim(x_dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1 && w_dtype == 1) {
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, d, eps, s);
  }
  if (x_dtype == 1 && w_dtype == 0) {
    return launch<__nv_bfloat16, float>(x, w, out, rows, d, eps, s);
  }
  if (x_dtype == 0 && w_dtype == 0) {
    return launch<float, float>(x, w, out, rows, d, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
