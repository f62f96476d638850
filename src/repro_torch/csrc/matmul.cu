// Tiled matrix product for Hopper (sm_90a): C = A @ B with fp32
// accumulation across K, rounded once to the output dtype.
//
// Replaces the Pallas kernel `matmul` (src/repro/kernels/matmul.py:47,
// body `_matmul_kernel` :31), which `PallasBackend.matmul` runs for every
// `ops.matmul` under `session(backend="pallas")`.  Here `HopperBackend`
// runs it for every float32 / bfloat16 `ops.matmul`: the core stack's
// Linear layers, its attention products and the tape's two backward
// products of each.
//
// Operands: A [batch..., M, K] and B [batch..., K, N], each read through
// its element strides (row, column and up to three batch strides; a
// stride of 0 broadcasts a batch dimension), so the tape's transposed
// views (g @ B^T, A^T @ g) and broadcast batches need no copy.  C is a
// contiguous [batch..., M, N].  Ragged edges are masked: any M, N, K.
//
// Two kernels:
//   * fp32 (and mixed fp32 / bf16, which promotes to fp32): fp32 FMAs on
//     the CUDA cores, no TF32, so the product is the fp32 function the
//     reference computes.  128 x 128 output tile per block of 256
//     threads, 8 x 8 outputs per thread (two 4 x 4 quadrants, so the
//     shared-memory reads of a warp are conflict-free float4s), K tiles of
//     16, double-buffered in shared memory with the next tile's loads in
//     registers while the current one computes.
//   * bf16 x bf16: mma.sync m16n8k16 tensor-core tiles (bf16 inputs, fp32
//     accumulation, the fragment layout of csrc/flash_attention.cu), 128 x
//     128 per block of 8 warps (64 x 32 each), K tiles of 32, double-
//     buffered likewise; output rounded once to bf16.
//
// What bounds it on this card: at the core stack's shapes (M = 4096, K
// and N of 768, 3072 or 30522) a product does 2 M N K flops on 4 (M K +
// K N + M N) bytes, ~300-700 flops per byte, so it is bound by
// arithmetic: the CUDA cores' fp32 rate (67 TFLOP/s on the H100 SXM) for
// fp32 and the tensor cores' bf16 rate (989 TFLOP/s) for bf16.  The
// tiles keep each loaded element in shared memory for 128 outputs; the
// loads are scalar (any stride and alignment) with a warp's addresses
// consecutive along the operand's contiguous dimension.  wgmma, TMA and a
// deeper pipeline are left for a later version.
//
// Plain C interface, bound from Python with ctypes; the wrapper
// (repro_torch/kernels/ops.py) checks dtypes, shapes and the grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxBatchDims = 3;

// One operand: a [batch..., rows, cols] matrix by element strides.
struct Operand {
  const void* ptr;
  long long s_row, s_col;
  long long s_batch[kMaxBatchDims];
};

// Sizes of the (up to three) batch dimensions, 1 where unused.
struct Batch {
  int n[kMaxBatchDims];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// Offsets of batch index z (grid.z) into A, B and the contiguous C.
__device__ __forceinline__ void batch_offsets(const Operand& a,
                                              const Operand& b,
                                              const Batch& bt, long long* oa,
                                              long long* ob) {
  int z = blockIdx.z;
  long long offa = 0, offb = 0;
#pragma unroll
  for (int i = kMaxBatchDims - 1; i >= 0; --i) {
    const int zi = z % bt.n[i];
    z /= bt.n[i];
    offa += zi * a.s_batch[i];
    offb += zi * b.s_batch[i];
  }
  *oa = offa;
  *ob = offb;
}

// --------------------------------------------------------------- fp32 FMA

constexpr int kBM = 128, kBN = 128, kBK = 16;
constexpr int kPad = 4;                 // keeps float4 rows 16-byte aligned
constexpr int kALoads = kBM * kBK / kThreads;   // 8
constexpr int kBLoads = kBK * kBN / kThreads;   // 8

// Element i of this thread's share of the A tile [kBM x kBK]: (m, k)
// placed so that consecutive threads read consecutive addresses along
// the operand's contiguous dimension.
template <bool KCONT>
__device__ __forceinline__ void a_coord(int idx, int* m, int* k) {
  if (KCONT) {
    *m = idx / kBK;
    *k = idx % kBK;
  } else {
    *m = idx % kBM;
    *k = idx / kBM;
  }
}

// Element i of the B tile [kBK x kBN]: (k, n).
template <bool NCONT>
__device__ __forceinline__ void b_coord(int idx, int* k, int* n) {
  if (NCONT) {
    *k = idx / kBN;
    *n = idx % kBN;
  } else {
    *k = idx % kBK;
    *n = idx / kBK;
  }
}

template <typename TA, typename TB, bool A_KCONT, bool B_NCONT>
__global__ void __launch_bounds__(kThreads)
mm_f32_kernel(Operand a, Operand b, float* __restrict__ c, int M, int N,
              int K, Batch bt) {
  __shared__ __align__(16) float as[2][kBK][kBM + kPad];
  __shared__ __align__(16) float bs[2][kBK][kBN + kPad];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  long long offa, offb;
  batch_offsets(a, b, bt, &offa, &offb);
  const TA* pa = static_cast<const TA*>(a.ptr) + offa;
  const TB* pb = static_cast<const TB*>(b.ptr) + offb;

  float ra[kALoads], rb[kBLoads];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kALoads; ++i) {
      int m, k;
      a_coord<A_KCONT>(tid + i * kThreads, &m, &k);
      const int gm = m0 + m, gk = k0 + k;
      ra[i] = (gm < M && gk < K) ? to_f32(pa[gm * a.s_row + gk * a.s_col])
                                 : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBLoads; ++i) {
      int k, n;
      b_coord<B_NCONT>(tid + i * kThreads, &k, &n);
      const int gk = k0 + k, gn = n0 + n;
      rb[i] = (gk < K && gn < N) ? to_f32(pb[gk * b.s_row + gn * b.s_col])
                                 : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kALoads; ++i) {
      int m, k;
      a_coord<A_KCONT>(tid + i * kThreads, &m, &k);
      as[buf][k][m] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < kBLoads; ++i) {
      int k, n;
      b_coord<B_NCONT>(tid + i * kThreads, &k, &n);
      bs[buf][k][n] = rb[i];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int tiles = (K + kBK - 1) / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < tiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < tiles) load((t + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[cur][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&as[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[cur][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&bs[cur][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (t + 1 < tiles) store(cur ^ 1);
    __syncthreads();
  }

  float* cb = c + static_cast<long long>(blockIdx.z) * M * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (gn < N) cb[static_cast<long long>(gm) * N + gn] = acc[i][j];
    }
  }
}

// ------------------------------------------------------- bf16 tensor cores

constexpr int kTBM = 128, kTBN = 128, kTBK = 32;
constexpr int kLd = kTBK + 8;           // padded rows: conflict-free frags
constexpr int kTALoads = kTBM * kTBK / kThreads;   // 16
constexpr int kTBLoads = kTBK * kTBN / kThreads;   // 16

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of the 16 x 16 tile at `p` of a row-major matrix (stride ld):
// rows g and g + 8, columns 2c, 2c + 1, 2c + 8, 2c + 9.
__device__ __forceinline__ void load_a(uint32_t f[4], const bf16* p, int ld,
                                       int g, int c) {
  f[0] = ld32(p + g * ld + 2 * c);
  f[1] = ld32(p + (g + 8) * ld + 2 * c);
  f[2] = ld32(p + g * ld + 8 + 2 * c);
  f[3] = ld32(p + (g + 8) * ld + 8 + 2 * c);
}

// B fragment of the 16 x 8 tile B[k][n] = T[n][k], T row-major at `p`.
__device__ __forceinline__ void load_b(uint32_t f[2], const bf16* p, int ld,
                                       int g, int c) {
  f[0] = ld32(p + g * ld + 2 * c);
  f[1] = ld32(p + g * ld + 8 + 2 * c);
}

__device__ __forceinline__ void mma(float d[4], const uint32_t a[4],
                                    const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool KCONT>
__device__ __forceinline__ void ta_coord(int idx, int* m, int* k) {
  if (KCONT) {
    *m = idx / kTBK;
    *k = idx % kTBK;
  } else {
    *m = idx % kTBM;
    *k = idx / kTBM;
  }
}

template <bool NCONT>
__device__ __forceinline__ void tb_coord(int idx, int* k, int* n) {
  if (NCONT) {
    *k = idx / kTBN;
    *n = idx % kTBN;
  } else {
    *k = idx % kTBK;
    *n = idx / kTBK;
  }
}

template <bool A_KCONT, bool B_NCONT>
__global__ void __launch_bounds__(kThreads)
mm_bf16_kernel(Operand a, Operand b, bf16* __restrict__ c, int M, int N,
               int K, Batch bt) {
  // both tiles k-contiguous: A as [m][k], B as [n][k]
  __shared__ __align__(16) bf16 as[2][kTBM * kLd];
  __shared__ __align__(16) bf16 bs[2][kTBN * kLd];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, cc = lane % 4;
  const int wm = warp / 4, wn = warp % 4;    // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * kTBM, n0 = blockIdx.x * kTBN;
  long long offa, offb;
  batch_offsets(a, b, bt, &offa, &offb);
  const bf16* pa = static_cast<const bf16*>(a.ptr) + offa;
  const bf16* pb = static_cast<const bf16*>(b.ptr) + offb;
  const bf16 zero = __float2bfloat16(0.f);

  bf16 ra[kTALoads], rb[kTBLoads];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kTALoads; ++i) {
      int m, k;
      ta_coord<A_KCONT>(tid + i * kThreads, &m, &k);
      const int gm = m0 + m, gk = k0 + k;
      ra[i] = (gm < M && gk < K) ? pa[gm * a.s_row + gk * a.s_col] : zero;
    }
#pragma unroll
    for (int i = 0; i < kTBLoads; ++i) {
      int k, n;
      tb_coord<B_NCONT>(tid + i * kThreads, &k, &n);
      const int gk = k0 + k, gn = n0 + n;
      rb[i] = (gk < K && gn < N) ? pb[gk * b.s_row + gn * b.s_col] : zero;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kTALoads; ++i) {
      int m, k;
      ta_coord<A_KCONT>(tid + i * kThreads, &m, &k);
      as[buf][m * kLd + k] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < kTBLoads; ++i) {
      int k, n;
      tb_coord<B_NCONT>(tid + i * kThreads, &k, &n);
      bs[buf][n * kLd + k] = rb[i];
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int tiles = (K + kTBK - 1) / kTBK;
  load(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < tiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < tiles) load((t + 1) * kTBK);
#pragma unroll
    for (int kk = 0; kk < kTBK; kk += 16) {
      uint32_t fa[4][4], fb[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        load_a(fa[i], &as[cur][(wm * 64 + i * 16) * kLd + kk], kLd, g, cc);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        load_b(fb[j], &bs[cur][(wn * 32 + j * 8) * kLd + kk], kLd, g, cc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma(acc[i][j], fa[i], fb[j]);
    }
    if (t + 1 < tiles) store(cur ^ 1);
    __syncthreads();
  }

  bf16* cb = c + static_cast<long long>(blockIdx.z) * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + wm * 64 + i * 16 + g + 8 * h;
      if (gm >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gn = n0 + wn * 32 + j * 8 + 2 * cc + e;
          if (gn < N) {
            cb[static_cast<long long>(gm) * N + gn] =
                __float2bfloat16(acc[i][j][2 * h + e]);
          }
        }
      }
    }
  }
}

template <typename TA, typename TB>
int launch_f32(const Operand& a, const Operand& b, void* c, int M, int N,
               int K, const Batch& bt, dim3 grid, cudaStream_t s) {
  float* out = static_cast<float*>(c);
  const bool ak = a.s_col == 1 || (a.s_row != 1 && a.s_col <= a.s_row);
  const bool bn = b.s_col == 1 || (b.s_row != 1 && b.s_col <= b.s_row);
  if (ak && bn) {
    mm_f32_kernel<TA, TB, true, true><<<grid, kThreads, 0, s>>>(a, b, out, M, N, K, bt);
  } else if (ak) {
    mm_f32_kernel<TA, TB, true, false><<<grid, kThreads, 0, s>>>(a, b, out, M, N, K, bt);
  } else if (bn) {
    mm_f32_kernel<TA, TB, false, true><<<grid, kThreads, 0, s>>>(a, b, out, M, N, K, bt);
  } else {
    mm_f32_kernel<TA, TB, false, false><<<grid, kThreads, 0, s>>>(a, b, out, M, N, K, bt);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const Operand& a, const Operand& b, void* c, int M, int N,
                int K, const Batch& bt, dim3 grid, cudaStream_t s) {
  bf16* out = static_cast<bf16*>(c);
  const bool ak = a.s_col == 1 || (a.s_row != 1 && a.s_col <= a.s_row);
  const bool bn = b.s_col == 1 || (b.s_row != 1 && b.s_col <= b.s_row);
  if (ak && bn) {
    mm_bf16_kernel<true, true><<<grid, kThreads, 0, s>>>(a, b, out, M, N, K, bt);
  } else if (ak) {
    mm_bf16_kernel<true, false><<<grid, kThreads, 0, s>>>(a, b, out, M, N, K, bt);
  } else if (bn) {
    mm_bf16_kernel<false, true><<<grid, kThreads, 0, s>>>(a, b, out, M, N, K, bt);
  } else {
    mm_bf16_kernel<false, false><<<grid, kThreads, 0, s>>>(a, b, out, M, N, K, bt);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C [batch, M, N] (contiguous, dtype promote(A, B)) = A @ B.
// a_strides / b_strides: {row, col, batch0, batch1, batch2} element
// strides; batch: the three batch sizes (1 where unused), their product
// the grid's z.  Dtype codes: 0 float32, 1 bfloat16.
extern "C" int repro_matmul(const void* a, const long long* a_strides,
                            int a_dtype, const void* b,
                            const long long* b_strides, int b_dtype, void* c,
                            int M, int N, int K, const int* batch,
                            void* stream) {
  if (M <= 0 || N <= 0 || batch[0] <= 0 || batch[1] <= 0 || batch[2] <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Operand oa{a, a_strides[0], a_strides[1],
             {a_strides[2], a_strides[3], a_strides[4]}};
  Operand ob{b, b_strides[0], b_strides[1],
             {b_strides[2], b_strides[3], b_strides[4]}};
  Batch bt{{batch[0], batch[1], batch[2]}};
  const long long nz = static_cast<long long>(batch[0]) * batch[1] * batch[2];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_dtype == 1 && b_dtype == 1) {
    const dim3 grid((N + kTBN - 1) / kTBN, (M + kTBM - 1) / kTBM, nz);
    if (grid.y > 65535 || nz > 65535) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    return launch_bf16(oa, ob, c, M, N, K, bt, grid, s);
  }
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, nz);
  if (grid.y > 65535 || nz > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (a_dtype == 0 && b_dtype == 0) {
    return launch_f32<float, float>(oa, ob, c, M, N, K, bt, grid, s);
  }
  if (a_dtype == 0 && b_dtype == 1) {
    return launch_f32<float, bf16>(oa, ob, c, M, N, K, bt, grid, s);
  }
  if (a_dtype == 1 && b_dtype == 0) {
    return launch_f32<bf16, float>(oa, ob, c, M, N, K, bt, grid, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
