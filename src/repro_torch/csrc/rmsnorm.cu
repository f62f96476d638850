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
// The backward (training) is two kernels.  The first gives each block a
// run of rows; per row it keeps x and dy in registers as 16-byte vectors,
// reduces sum(x^2) and sum(x * w * dy) in fp32 in one pass over the
// block, writes dx = inv * (w * dy - xhat * mean(xhat * w * dy)) in x's
// dtype, and adds dy * xhat into the block's fp32 partial of dw, which
// each thread holds for its own columns.  Each block writes its partial
// to a [blocks, D] fp32 scratch the wrapper allocates; the second kernel
// sums the scratch over the blocks, one thread per column, in a fixed
// order, and writes dw in w's dtype: deterministic, with no atomics.  Like
// the forward it is bound by memory: x and dy read once, dx written once.
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

// dx and the per-block partials of dw for rows [row0, row1) of a block;
// MAXV 16-byte vectors of a row per thread (the fewest that cover d, so
// the registers held across rows stay few)
template <typename T, typename W, int MAXV>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   float* __restrict__ dw_part, int rows, int d,
                   int rows_per_block, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const int nvec = d / VEC;
  const int row0 = blockIdx.x * rows_per_block;
  const int row1 = min(rows, row0 + rows_per_block);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __shared__ float partial[2][kThreads / 32];
  __shared__ float stats[2];

  float part[MAXV][VEC];
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) part[i][j] = 0.f;
  }

  for (size_t row = row0; row < static_cast<size_t>(row1); ++row) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
    const uint4* dyr = reinterpret_cast<const uint4*>(dy + row * d);
    uint4 xc[MAXV], gc[MAXV];
    float ss = 0.f, sg = 0.f;  // sum x^2, sum x * w * dy
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int v = threadIdx.x + i * kThreads;
      if (v < nvec) {
        xc[i] = xr[v];
        gc[i] = dyr[v];
        const T* xe = reinterpret_cast<const T*>(&xc[i]);
        const T* ge = reinterpret_cast<const T*>(&gc[i]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float f = to_float(xe[j]);
          ss += f * f;
          sg += f * to_float(w[v * VEC + j]) * to_float(ge[j]);
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      sg += __shfl_xor_sync(0xffffffffu, sg, o);
    }
    if (lane == 0) {
      partial[0][warp] = ss;
      partial[1][warp] = sg;
    }
    __syncthreads();
    if (warp == 0) {
      float a = lane < kThreads / 32 ? partial[0][lane] : 0.f;
      float g = lane < kThreads / 32 ? partial[1][lane] : 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        g += __shfl_xor_sync(0xffffffffu, g, o);
      }
      if (lane == 0) {
        const float inv = rsqrtf(a / static_cast<float>(d) + eps);
        stats[0] = inv;
        // mean(xhat * w * dy) = inv * sum(x * w * dy) / d
        stats[1] = inv * g / static_cast<float>(d);
      }
    }
    __syncthreads();
    const float inv = stats[0], mean = stats[1];

    uint4* dxr = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int v = threadIdx.x + i * kThreads;
      if (v < nvec) {
        const T* xe = reinterpret_cast<const T*>(&xc[i]);
        const T* ge = reinterpret_cast<const T*>(&gc[i]);
        uint4 res;
        T* r = reinterpret_cast<T*>(&res);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xh = to_float(xe[j]) * inv;
          const float g = to_float(ge[j]);
          r[j] = from_float<T>(inv * (to_float(w[v * VEC + j]) * g - xh * mean));
          part[i][j] += g * xh;
        }
        dxr[v] = res;
      }
    }
    __syncthreads();  // stats are rewritten by the next row
  }

  float* prow = dw_part + static_cast<size_t>(blockIdx.x) * d;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int v = threadIdx.x + i * kThreads;
    if (v < nvec) {
#pragma unroll
      for (int j = 0; j < VEC; j += 4) {
        *reinterpret_cast<float4*>(prow + v * VEC + j) =
            make_float4(part[i][j], part[i][j + 1], part[i][j + 2],
                        part[i][j + 3]);
      }
    }
  }
}

// dw[c] = sum over blocks of dw_part[blk][c], in block order
template <typename W>
__global__ void __launch_bounds__(kThreads)
rmsnorm_dw_kernel(const float* __restrict__ dw_part, W* __restrict__ dw,
                  int blocks, int d) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  float acc = 0.f;
  for (int b = 0; b < blocks; ++b) acc += dw_part[static_cast<size_t>(b) * d + c];
  dw[c] = from_float<W>(acc);
}

template <typename T, typename W, int MAXV>
void launch_bwd_rows(const void* x, const void* w, const void* dy, void* dx,
                     float* dw_part, int rows, int d, int blocks, float eps,
                     cudaStream_t stream) {
  const int per_block = (rows + blocks - 1) / blocks;
  rmsnorm_bwd_kernel<T, W, MAXV><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<const T*>(dy), static_cast<T*>(dx), dw_part, rows, d,
      per_block, eps);
}

template <typename T, typename W>
int launch_bwd(const void* x, const void* w, const void* dy, void* dx,
               void* dw, float* dw_part, int rows, int d, int blocks,
               float eps, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int per_thread = (d / VEC + kThreads - 1) / kThreads;
  if (per_thread <= 1) {
    launch_bwd_rows<T, W, 1>(x, w, dy, dx, dw_part, rows, d, blocks, eps,
                             stream);
  } else if (per_thread <= 2) {
    launch_bwd_rows<T, W, 2>(x, w, dy, dx, dw_part, rows, d, blocks, eps,
                             stream);
  } else if (per_thread <= 4) {
    launch_bwd_rows<T, W, 4>(x, w, dy, dx, dw_part, rows, d, blocks, eps,
                             stream);
  } else {
    launch_bwd_rows<T, W, kMaxVecs>(x, w, dy, dx, dw_part, rows, d, blocks,
                                    eps, stream);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  rmsnorm_dw_kernel<W><<<(d + kThreads - 1) / kThreads, kThreads, 0,
                         stream>>>(dw_part, static_cast<W*>(dw), blocks, d);
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

// The backward: dx [rows, d] in x's dtype and dw [d] in w's dtype from x,
// w and dy; dw_part is fp32 scratch of [blocks, d] (blocks >= 1; each
// block takes ceil(rows / blocks) rows).
extern "C" int repro_rmsnorm_bwd(const void* x, const void* w, const void* dy,
                                 void* dx, void* dw, void* dw_part, int rows,
                                 int d, int blocks, float eps, int x_dtype,
                                 int w_dtype, void* stream) {
  const int vec = x_dtype == 1 ? 8 : 4;
  if (rows <= 0 || blocks <= 0 || d <= 0 || d % vec != 0 ||
      d > repro_rmsnorm_max_dim(x_dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(dw_part);
  if (x_dtype == 1 && w_dtype == 1) {
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, w, dy, dx, dw, part,
                                                    rows, d, blocks, eps, s);
  }
  if (x_dtype == 1 && w_dtype == 0) {
    return launch_bwd<__nv_bfloat16, float>(x, w, dy, dx, dw, part, rows, d,
                                            blocks, eps, s);
  }
  if (x_dtype == 0 && w_dtype == 0) {
    return launch_bwd<float, float>(x, w, dy, dx, dw, part, rows, d, blocks,
                                    eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
