// Paged flash-decode for Hopper (sm_90a): one query row per (slot, head)
// against the slot's K/V, read through its block table.
//
// Replaces the Pallas kernel `flash_decode` (src/repro/kernels/
// flash_decode.py) and the gathered jnp `plain_cache_attention` that the
// reference's decode step actually runs.  Decode attention does ~2 flops
// per byte of cache it reads, far below the card's ~295 flops/byte ridge,
// so it is bound by the bytes of K and V it must stream.  The design
// keeps those bytes to the minimum:
//   * K/V are read in place through the block table: no gathered copy
//     of the logical view is built (the reference rebuilds it in full,
//     max_seq positions per slot, on every step);
//   * only positions < length are read, so a short sequence costs only
//     its own length;
//   * each K/V row is read once per query head as coalesced vectors
//     (a warp covers one head_dim row), and the online softmax keeps
//     m, l and the output accumulator in fp32 registers.
// One block of 8 warps per (head, slot).  Each warp walks its own
// groups of U keys, issuing all U rows' loads before any arithmetic so
// several rows are in flight, and the warps' partial (m, l, acc) are
// merged through shared memory at the end.  GQA: query head h reads kv
// head h / (H / Kv).  An optional per-position mask (uint8) serves the
// contiguous [N, S, D] entry with the reference's validity argument.
//
// Masked or absent keys contribute 0; a row with no valid key returns 0
// (finite), matching the reference's 1e-30 floor on the normaliser.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;

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

// one lane's share of a head_dim row; aligned to at most the 16 bytes
// the wrapper guarantees (a 32-byte chunk loads as two 16-byte vectors)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC > 16 ? 16 : sizeof(T) * VEC) Chunk {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load_chunk(const T* p, float (&f)[VEC]) {
  const Chunk<T, VEC> c = *reinterpret_cast<const Chunk<T, VEC>*>(p);
#pragma unroll
  for (int i = 0; i < VEC; ++i) f[i] = to_float(c.v[i]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// VEC = head_dim / 32 elements per lane.
template <typename T, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q,          // [B, H, D]
                    const T* __restrict__ kpool,      // [P, Kv, D]
                    const T* __restrict__ vpool,      // [P, Kv, D]
                    const int* __restrict__ table,    // [B, MB]
                    const int* __restrict__ lengths,  // [B]
                    const uint8_t* __restrict__ mask, // [B, mask_stride] | null
                    T* __restrict__ out,              // [B, H, D]
                    int H, int Kv, int MB, int block_size, int mask_stride,
                    float scale, float cap) {
  constexpr int D = VEC * 32;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (H / Kv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int len = min(lengths[b], MB * block_size);
  const int* trow = table + static_cast<size_t>(b) * MB;
  const uint8_t* mrow =
      mask ? mask + static_cast<size_t>(b) * mask_stride : nullptr;

  float qf[VEC];
  load_chunk<T, VEC>(q + (static_cast<size_t>(b) * H + h) * D + lane * VEC,
                     qf);

  float m = -INFINITY;
  float l = 0.f;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  for (int base = warp * kUnroll; base < len; base += kWarps * kUnroll) {
    float kf[kUnroll][VEC];
    float vf[kUnroll][VEC];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = base + u;
      ok[u] = s < len && (mrow == nullptr || mrow[s] != 0);
      if (ok[u]) {
        const int phys = trow[s / block_size] * block_size + s % block_size;
        const size_t off =
            (static_cast<size_t>(phys) * Kv + kvh) * D + lane * VEC;
        load_chunk<T, VEC>(kpool + off, kf[u]);
        load_chunk<T, VEC>(vpool + off, vf[u]);
      }
    }
    float sc[kUnroll];
    float mx = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float dot = 0.f;
      if (ok[u]) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) dot += qf[i] * kf[u][i];
      }
      dot = warp_sum(dot) * scale;
      if (cap > 0.f) dot = tanhf(dot / cap) * cap;
      sc[u] = dot;
      if (ok[u]) mx = fmaxf(mx, dot);
    }
    if (mx == -INFINITY) continue;  // no valid key in this group
    const float corr = expf(m - mx);  // m = -inf gives 0
    l *= corr;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] *= corr;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (ok[u]) {
        const float p = expf(sc[u] - mx);
        l += p;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] += p * vf[u][i];
      }
    }
    m = mx;
  }

  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][D];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) sm_acc[warp][lane * VEC + i] = acc[i];
  __syncthreads();

  for (int d = threadIdx.x; d < D; d += kWarps * 32) {
    float mmax = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mmax = fmaxf(mmax, sm_m[w]);
    float res = 0.f;
    if (mmax != -INFINITY) {
      float lsum = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float c = expf(sm_m[w] - mmax);
        lsum += sm_l[w] * c;
        a += sm_acc[w][d] * c;
      }
      res = a / fmaxf(lsum, 1e-30f);
    }
    out[(static_cast<size_t>(b) * H + h) * D + d] = from_float<T>(res);
  }
}

template <typename T>
int dispatch(int head_dim, dim3 grid, cudaStream_t s, const void* q,
             const void* k, const void* v, const int* table,
             const int* lengths, const uint8_t* mask, void* out, int H,
             int Kv, int MB, int block_size, int mask_stride, float scale,
             float cap) {
  const dim3 block(kWarps * 32);
#define REPRO_LAUNCH(VEC)                                                   \
  paged_decode_kernel<T, VEC><<<grid, block, 0, s>>>(                       \
      static_cast<const T*>(q), static_cast<const T*>(k),                   \
      static_cast<const T*>(v), table, lengths, mask, static_cast<T*>(out), \
      H, Kv, MB, block_size, mask_stride, scale, cap)
  switch (head_dim) {
    case 32: REPRO_LAUNCH(1); break;
    case 64: REPRO_LAUNCH(2); break;
    case 128: REPRO_LAUNCH(4); break;
    case 256: REPRO_LAUNCH(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  mask may be null.
extern "C" int repro_paged_decode(const void* q, const void* k_pool,
                                  const void* v_pool, const void* table,
                                  const void* lengths, const void* mask,
                                  void* out, int B, int H, int Kv, int D,
                                  int MB, int block_size, int mask_stride,
                                  float scale, float cap, int dtype,
                                  void* stream) {
  if (B <= 0) return 0;
  if (H <= 0 || Kv <= 0 || H % Kv != 0 || MB <= 0 || block_size <= 0 ||
      H > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(D, grid, s, q, k_pool, v_pool, tb, ln, mk,
                                   out, H, Kv, MB, block_size, mask_stride,
                                   scale, cap);
  }
  if (dtype == 0) {
    return dispatch<float>(D, grid, s, q, k_pool, v_pool, tb, ln, mk, out, H,
                           Kv, MB, block_size, mask_stride, scale, cap);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
