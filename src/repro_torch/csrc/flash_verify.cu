// Paged flash-verify for Hopper (sm_90a): T query rows per (slot, head)
// against the slot's K/V, read through its block table, each row with
// its own causal limit.  The one kernel behind chunked prefill (T = the
// prefill chunk) and speculative verify (T = k + 1).
//
// Replaces the Pallas kernel `flash_verify` (src/repro/kernels/
// flash_decode.py:92) and the gathered jnp `_sdpa_ref` that the
// reference's `gqa_prefill_chunk` actually runs: that path gathers
// max_seq positions of K and V per slot and builds an fp32 score tensor
// [B, Kv, G, T, max_seq] per layer.
//
// Query t < count[b] of slot b sits at position start[b] + t and attends
// logical positions 0 .. start[b] + t (clamped to the table's MB *
// block_size positions).  Rows t >= count[b] (chunk padding, idle slots)
// write zeros and read nothing.  GQA: query head h reads kv head
// h / (H / Kv).  Scores take the scale, then the optional tanh softcap;
// the softmax is an fp32 online softmax and a row with no valid key
// returns 0, as the reference's 1e-30 floor on the normaliser does.
// An optional uint8 mask [B, T, mask_stride] further restricts validity
// (the contiguous entry with the reference's [N, T, S] argument).
//
// What bounds it on this card (bf16, D = 128, H = Kv = 32): each row
// does 4 * D flops per key it attends, and each K/V row is 2 * D * 2
// bytes.  At verify (T = 5) that is ~5 flops per byte of K/V: far below
// the ~295 flops/byte ridge, so the bytes of K/V bound it.  At prefill
// (T = 128 rows sharing each key) it is ~128 flops per byte: still
// under the tensor-core ridge, so bytes bound it there too, but this
// kernel computes on the CUDA cores (fp32 FMA, 67 TFLOP/s), whose ridge
// is ~20 flops/byte, so at prefill its real limit is arithmetic.
//
// Design: one block of 4 warps per (tile of query rows, head, slot).
//   * The block stages a tile of 32 K/V rows from the table's physical
//     blocks into shared memory (fp32) once and every query row of the
//     tile reuses it: the Pallas design point, the whole span shares
//     each streamed KV tile.  K/V are read in place through the table;
//     no gathered view and no score tensor exist in device memory.
//   * The key loop stops at the tile's last valid row's causal limit,
//     so short rows and padding cost nothing.
//   * Scores: lane j holds key j of the tile and computes its dot with
//     each of the warp's R rows (K row from shared memory, padded so
//     lanes hit distinct banks; q rows as broadcasts).  PV: each lane
//     owns D/32 output columns for its R rows and reads the weights of
//     4 keys at a time from shared memory as broadcasts.
//   * Rows per block: 4 * R, with R = 8 for a prefill-sized T and R = 2
//     for a verify-sized T, so T = 5 fills one block without 27 idle
//     rows and T = 128 shares each K/V tile across 32 rows.
// Tensor-core mma / wgmma and TMA staging are left for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = 32;  // keys per staged tile: one per lane

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

// 16 bytes of T: the unit of every global load (the wrapper guarantees
// 16-byte aligned rows)
template <typename T>
struct alignas(16) Vec16 {
  T v[16 / sizeof(T)];
};

// a 16-byte vector of T as fp32 into 16-byte aligned shared memory
template <typename T>
__device__ __forceinline__ void store_floats(float* dst, const Vec16<T>& x) {
  constexpr int NV = 16 / sizeof(T);
#pragma unroll
  for (int e = 0; e < NV; e += 4) {
    *reinterpret_cast<float4*>(dst + e) =
        make_float4(to_float(x.v[e]), to_float(x.v[e + 1]),
                    to_float(x.v[e + 2]), to_float(x.v[e + 3]));
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int D, int R>
constexpr size_t smem_bytes() {
  // q rows [4R][D], K tile [32][D + 4], V tile [32][D], weights [4][R][32]
  return sizeof(float) * (static_cast<size_t>(kWarps) * R * D +
                          kKeys * (D + 4) + kKeys * D + kWarps * R * kKeys);
}

template <typename T, int D, int R>
__global__ void __launch_bounds__(kThreads)
paged_verify_kernel(const T* __restrict__ q,          // [B, T, H, D]
                    const T* __restrict__ kpool,      // [P, Kv, D]
                    const T* __restrict__ vpool,      // [P, Kv, D]
                    const int* __restrict__ table,    // [B, MB]
                    const int* __restrict__ start,    // [B]
                    const int* __restrict__ count,    // [B]
                    const uint8_t* __restrict__ mask, // [B, T, mask_stride]
                    T* __restrict__ out,              // [B, T, H, D]
                    int Tq, int H, int Kv, int MB, int block_size,
                    int mask_stride, float scale, float cap) {
  constexpr int TQ = kWarps * R;      // query rows per block
  constexpr int KS = D + 4;           // padded K row (floats)
  constexpr int NV = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int VPR = D / NV;         // vectors per K/V row
  constexpr int PER_THREAD = kKeys * VPR / kThreads;
  constexpr int GROUP = PER_THREAD < 4 ? PER_THREAD : 4;
  constexpr int NC = D / 32;          // output columns per lane
  static_assert(kKeys * VPR % kThreads == 0, "tile must split evenly");
  static_assert(PER_THREAD % GROUP == 0, "load groups must split evenly");

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [TQ][D]
  float* ks = qs + TQ * D;                      // [kKeys][KS]
  float* vs = ks + kKeys * KS;                  // [kKeys][D]
  float* ps = vs + kKeys * D;                   // [kWarps][R][kKeys]

  const int tile0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Kv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int L = MB * block_size;  // logical positions the table covers
  const int cnt = max(0, min(count[b], Tq));
  const int st = start[b];
  const int* trow = table + static_cast<size_t>(b) * MB;

  // the tile's last valid row bounds the key loop for the whole block
  const int t_last = min(tile0 + TQ, cnt) - 1;
  const int hi = t_last >= tile0 ? min(st + t_last, L - 1) : -1;

  // stage the tile's query rows (zeros for rows past count)
  for (int i = threadIdx.x; i < TQ * VPR; i += kThreads) {
    const int row = i / VPR;
    const int col = (i % VPR) * NV;
    const int t = tile0 + row;
    Vec16<T> x;
    if (t < cnt) {
      x = *reinterpret_cast<const Vec16<T>*>(
          q + ((static_cast<size_t>(b) * Tq + t) * H + h) * D + col);
    } else {
#pragma unroll
      for (int e = 0; e < NV; ++e) x.v[e] = from_float<T>(0.f);
    }
    store_floats(qs + row * D + col, x);
  }

  // this warp's rows: local row warp + kWarps * r
  int lim[R];
  float m[R], l[R], acc[R][NC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t = tile0 + warp + kWarps * r;
    lim[r] = t < cnt ? min(st + t, L - 1) : -1;
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = 0.f;
  }
  float* wps = ps + warp * R * kKeys;

  for (int k0 = 0; k0 <= hi; k0 += kKeys) {
    __syncthreads();  // the previous tile is consumed (and q is staged)
#pragma unroll
    for (int g = 0; g < PER_THREAD; g += GROUP) {
      Vec16<T> kx[GROUP], vx[GROUP];
#pragma unroll
      for (int u = 0; u < GROUP; ++u) {
        const int i = threadIdx.x + (g + u) * kThreads;
        const int s = k0 + i / VPR;
        if (s <= hi) {
          const int phys = trow[s / block_size] * block_size + s % block_size;
          const size_t off = (static_cast<size_t>(phys) * Kv + kvh) * D +
                             (i % VPR) * NV;
          kx[u] = *reinterpret_cast<const Vec16<T>*>(kpool + off);
          vx[u] = *reinterpret_cast<const Vec16<T>*>(vpool + off);
        } else {  // past the limit: zeros, never stale shared memory
#pragma unroll
          for (int e = 0; e < NV; ++e) {
            kx[u].v[e] = from_float<T>(0.f);
            vx[u].v[e] = from_float<T>(0.f);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < GROUP; ++u) {
        const int i = threadIdx.x + (g + u) * kThreads;
        const int row = i / VPR;
        const int col = (i % VPR) * NV;
        store_floats(ks + row * KS + col, kx[u]);
        store_floats(vs + row * D + col, vx[u]);
      }
    }
    __syncthreads();

    // scores: lane j <-> key k0 + j, for each of the warp's R rows
    float dot[R];
#pragma unroll
    for (int r = 0; r < R; ++r) dot[r] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(ks + lane * KS + c);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(
            qs + (warp + kWarps * r) * D + c);
        dot[r] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
      }
    }
    const int s = k0 + lane;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      bool ok = s <= lim[r];
      if (ok && mask != nullptr) {
        const int t = tile0 + warp + kWarps * r;
        ok = mask[(static_cast<size_t>(b) * Tq + t) * mask_stride + s] != 0;
      }
      float sc = dot[r] * scale;
      if (cap > 0.f) sc = tanhf(sc / cap) * cap;
      const float mx = warp_max(ok ? sc : -INFINITY);
      float p = 0.f;
      if (mx != -INFINITY) {  // warp-uniform: some key of the tile is valid
        const float mnew = fmaxf(m[r], mx);
        const float corr = expf(m[r] - mnew);  // m = -inf gives 0
        p = ok ? expf(sc - mnew) : 0.f;
        l[r] = l[r] * corr + warp_sum(p);
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[r][i] *= corr;
        m[r] = mnew;
      }
      wps[r * kKeys + lane] = p;
    }
    __syncwarp();

    // PV: acc[r][:] += sum_j p[r][j] * V[j][:], 4 keys at a time
    const int nkeys = min(kKeys, hi - k0 + 1);
    for (int j0 = 0; j0 < nkeys; j0 += 4) {
      float vv[4][NC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          vv[jj][i] = vs[(j0 + jj) * D + lane + 32 * i];
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 pw =
            *reinterpret_cast<const float4*>(wps + r * kKeys + j0);
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          acc[r][i] += pw.x * vv[0][i] + pw.y * vv[1][i] + pw.z * vv[2][i] +
                       pw.w * vv[3][i];
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t = tile0 + warp + kWarps * r;
    if (t >= Tq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);  // no valid key: acc = 0
    T* orow = out + ((static_cast<size_t>(b) * Tq + t) * H + h) * D;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      orow[lane + 32 * i] = from_float<T>(acc[r][i] * inv);
    }
  }
}

template <typename T, int D, int R>
int launch(dim3 grid, cudaStream_t stream, const void* q, const void* k,
           const void* v, const int* table, const int* start,
           const int* count, const uint8_t* mask, void* out, int Tq, int H,
           int Kv, int MB, int block_size, int mask_stride, float scale,
           float cap) {
  constexpr size_t smem = smem_bytes<D, R>();
  // above 48 KB a block's shared memory must be opted into, once
  static bool opted = false;
  if (smem > 48 * 1024 && !opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_verify_kernel<T, D, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = true;
  }
  paged_verify_kernel<T, D, R><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), table, start, count, mask,
      static_cast<T*>(out), Tq, H, Kv, MB, block_size, mask_stride, scale,
      cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int R>
int dispatch_dim(int D, int Tq, int B, int H, cudaStream_t s, const void* q,
                 const void* k, const void* v, const int* table,
                 const int* start, const int* count, const uint8_t* mask,
                 void* out, int Kv, int MB, int block_size, int mask_stride,
                 float scale, float cap) {
  const dim3 grid((Tq + kWarps * R - 1) / (kWarps * R), H, B);
#define REPRO_LAUNCH(DIM)                                                    \
  return launch<T, DIM, R>(grid, s, q, k, v, table, start, count, mask, out, \
                           Tq, H, Kv, MB, block_size, mask_stride, scale,    \
                           cap)
  switch (D) {
    case 32: REPRO_LAUNCH(32);
    case 64: REPRO_LAUNCH(64);
    case 128: REPRO_LAUNCH(128);
    case 256: REPRO_LAUNCH(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_LAUNCH
}

template <typename T>
int dispatch(int D, int Tq, int B, int H, cudaStream_t s, const void* q,
             const void* k, const void* v, const int* table, const int* start,
             const int* count, const uint8_t* mask, void* out, int Kv, int MB,
             int block_size, int mask_stride, float scale, float cap) {
  // 32 rows a block for prefill-sized spans, 8 for verify-sized ones
  if (Tq > 16) {
    return dispatch_dim<T, 8>(D, Tq, B, H, s, q, k, v, table, start, count,
                              mask, out, Kv, MB, block_size, mask_stride,
                              scale, cap);
  }
  return dispatch_dim<T, 2>(D, Tq, B, H, s, q, k, v, table, start, count,
                            mask, out, Kv, MB, block_size, mask_stride, scale,
                            cap);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  mask may be null.
extern "C" int repro_paged_verify(const void* q, const void* k_pool,
                                  const void* v_pool, const void* table,
                                  const void* start, const void* count,
                                  const void* mask, void* out, int B, int T,
                                  int H, int Kv, int D, int MB,
                                  int block_size, int mask_stride,
                                  float scale, float cap, int dtype,
                                  void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (H <= 0 || Kv <= 0 || H % Kv != 0 || MB <= 0 || block_size <= 0 ||
      H > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* st = static_cast<const int*>(start);
  const int* ct = static_cast<const int*>(count);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(D, T, B, H, s, q, k_pool, v_pool, tb, st,
                                   ct, mk, out, Kv, MB, block_size,
                                   mask_stride, scale, cap);
  }
  if (dtype == 0) {
    return dispatch<float>(D, T, B, H, s, q, k_pool, v_pool, tb, st, ct, mk,
                           out, Kv, MB, block_size, mask_stride, scale, cap);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
