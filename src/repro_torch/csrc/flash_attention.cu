// Flash attention for Hopper (sm_90a): full-sequence causal / sliding-
// window / tanh-softcap attention, forward and backward, for training.
//
// Replaces the Pallas kernel `flash_attention` (src/repro/kernels/
// flash_attention.py:204), which the JAX trainer runs inside
// `gqa_attention` under `attention_impl="pallas"`.  The Pallas kernel has
// no backward (its gradient is autodiff of the same function); here the
// gradient is three kernels in FlashAttention-2's recompute scheme from
// the saved log-sum-exp, so training never builds a [B, H, S, S] tensor.
//
// Layout: q [B, S, H, D], k and v [B, S, Kv, D], read with the strides
// the caller passes (the model's layout, no transpose copies); the last
// dimension is contiguous and every row 16-byte aligned.  GQA: query head
// h reads kv head h / (H / Kv), no repeat.  Query row t attends key s
// where s <= t (causal) and t - s < window (window > 0).  Scores take the
// scale, then the optional tanh softcap; the softmax is fp32.  Outputs: o
// [B, S, H, D] in q's dtype and the fp32 log-sum-exp lse [B, H, S] of the
// capped scores, which the backward reads.
//
// What bounds it on this card (bf16, B=4, S=2048, H=Kv=32, D=128,
// causal): the forward does 4 * D flops per (row, attended key), ~137
// GFLOP against 268 MB of q/k/v/o, ~500 flops per byte, so it is bound by
// the tensor cores' arithmetic (0.139 ms at 989 TFLOP/s); the backward
// does 10 * D per pair (S, dP, dV, dK, dQ), 0.348 ms.  The kernels take
// bf16 only (the model's training dtype) and run on the tensor cores with
// mma.sync m16n8k16 tiles (fp32 accumulation); fp32 tensors on the card
// are refused by the wrapper.  Every staged K/V (or Q/dO) tile stays in
// shared memory for all the rows that use it, and the tiles that the
// causal or window limit masks out entirely are skipped.
//
// Design (4 warps a block, 16 rows of each product per warp):
//   * forward, one block per (64 query rows, head, batch): the warp's Q
//     rows stay in registers as mma operands; K and V^T tiles of 64 keys
//     are staged in shared memory; S = QK^T in fp32, an online softmax per
//     row, P rounded to bf16 (as the reference rounds it to v's dtype)
//     and O += PV, all in registers;
//   * backward preprocess: Di = rowsum(dO * O) per (row, head), fp32;
//   * dK/dV, one block per (64 keys, kv head, batch): loops over every
//     32-row query tile that can see its keys and over the H/Kv query
//     heads of its group, recomputes P^T = exp(s - lse) and dS^T = P^T *
//     (dP^T - Di) (times 1 - tanh^2 under a softcap), and sums dV += P^T
//     dO and dK += dS^T Q in registers, so GQA gradients are summed inside
//     the block, deterministically, with no atomics;
//   * dQ, one block per (64 query rows, head, batch): the forward's key
//     loop over 32-key tiles, recomputing dS and summing dQ += dS K.
// wgmma, TMA staging and a pipelined tile ring are left for a later
// version.
//
// Plain C interface, bound from Python with ctypes; the wrapper
// (repro_torch/kernels/ops.py) checks dtypes, shapes, strides and
// alignment before calling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A [B, S, heads, D] tensor addressed by its element strides.
struct Strided {
  const void* ptr;
  long long sb, ss, sh;
};

struct Mask {
  int S, causal, window;
  __device__ __forceinline__ bool ok(int t, int s) const {
    return s < S && (!causal || s <= t) && (window <= 0 || t - s < window);
  }
  // first and last key any row of [t0, t1] may attend
  __device__ __forceinline__ int key_lo(int t0) const {
    return window > 0 ? max(0, t0 - window + 1) : 0;
  }
  __device__ __forceinline__ int key_hi(int t1) const {
    return causal ? min(S - 1, t1) : S - 1;
  }
  // first and last query row that may attend any key of [s0, s1]
  __device__ __forceinline__ int row_lo(int s0) const {
    return causal ? s0 : 0;
  }
  __device__ __forceinline__ int row_hi(int s1) const {
    return window > 0 ? min(S - 1, s1 + window - 1) : S - 1;
  }
};

// ----------------------------------------------------- backward: Di = dO.O

// one warp per (b, t, h) row; o and do are contiguous [B, S, H, D]
template <int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_pre_kernel(const __nv_bfloat16* __restrict__ o,
                  const __nv_bfloat16* __restrict__ dout,
                  float* __restrict__ di, int rows, int S, int H) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const __nv_bfloat16* orow = o + static_cast<size_t>(row) * D;
  const __nv_bfloat16* drow = dout + static_cast<size_t>(row) * D;
  float acc = 0.f;
#pragma unroll
  for (int i = lane; i < D; i += 32) acc += to_float(orow[i]) * to_float(drow[i]);
  acc = warp_sum(acc);
  if (lane == 0) {  // row = (b * S + t) * H + h  ->  di[b, h, t]
    const int h = row % H;
    const int t = (row / H) % S;
    const int b = row / (H * S);
    di[(static_cast<size_t>(b) * H + h) * S + t] = acc;
  }
}

// ============================================================ tensor cores
// The three functions on mma.sync.m16n8k16 tiles (bf16 inputs, fp32
// accumulation), one warp per 16 rows of a product.
// Operand layouts (g = lane / 4, c = lane % 4): an A fragment holds rows
// g and g + 8, columns 2c, 2c + 1, 2c + 8, 2c + 9 of a 16 x 16 tile; a B
// fragment holds column g, rows 2c, 2c + 1, 2c + 8, 2c + 9 of a 16 x 8
// tile; an accumulator holds rows g and g + 8, columns 2c and 2c + 1 of a
// 16 x 8 tile.  Two adjacent accumulators, rounded to bf16, are the A
// fragment of the next product (P into PV, dS into dS K), as in
// FlashAttention-2.  Every B operand is read from shared memory as 32-bit
// pairs along its k dimension: K and V rows serve QK^T and dO V^T as
// they are, and the transposed copies V^T, Q^T, dO^T and K^T that the
// other products need are written once per tile when it is staged.  Row
// strides are padded by 8 elements, so a warp's 32-bit fragment loads
// hit 32 distinct banks.

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A fragment of the 16 x 16 tile at `p` of a row-major matrix (stride ld)
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* p, int ld,
                                       int g, int c) {
  a[0] = ld32(p + g * ld + 2 * c);
  a[1] = ld32(p + (g + 8) * ld + 2 * c);
  a[2] = ld32(p + g * ld + 8 + 2 * c);
  a[3] = ld32(p + (g + 8) * ld + 8 + 2 * c);
}

// B fragment of the 16 x 8 tile B[k][n] = M[n][k], M row-major at `p`
__device__ __forceinline__ void load_b(uint32_t b[2], const bf16* p, int ld,
                                       int g, int c) {
  b[0] = ld32(p + g * ld + 2 * c);
  b[1] = ld32(p + g * ld + 8 + 2 * c);
}

__device__ __forceinline__ void mma(float d[4], const uint32_t a[4],
                                    const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage `rows` rows [r0, r0 + rows) of head h into shared memory as bf16:
// row-major with stride ld (when dst is set) and / or transposed, [D][ldt]
// (when dst_t is set); rows past S are zeros.
template <int D>
__device__ __forceinline__ void stage_bf16(bf16* dst, int ld, bf16* dst_t,
                                           int ldt, int rows,
                                           const Strided& src, int b, int r0,
                                           int h, int S) {
  constexpr int VPR = D / 8;
  const bf16* base = static_cast<const bf16*>(src.ptr) + b * src.sb + h * src.sh;
  for (int i = threadIdx.x; i < rows * VPR; i += kThreads) {
    const int row = i / VPR;
    const int col = (i % VPR) * 8;
    const int r = r0 + row;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < S) x = *reinterpret_cast<const uint4*>(base + r * src.ss + col);
    if (dst != nullptr) *reinterpret_cast<uint4*>(dst + row * ld + col) = x;
    if (dst_t != nullptr) {
      const bf16* e = reinterpret_cast<const bf16*>(&x);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst_t[(col + j) * ldt + row] = e[j];
    }
  }
}

// The capped, scaled score and d(capped)/d(raw score) / scale.
__device__ __forceinline__ float cap_score(float raw, float scale, float cap,
                                           float* dcap) {
  float x = raw * scale;
  if (cap > 0.f) {
    const float th = tanhf(x / cap);
    x = th * cap;
    *dcap = 1.f - th * th;
  } else {
    *dcap = 1.f;
  }
  return x;
}

constexpr int kMmaRows = 64;   // forward and dQ: 16 query rows per warp
constexpr int kMmaKeys = 64;   // forward: keys per staged tile

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_fwd_mma_kernel(Strided q, Strided k, Strided v, bf16* __restrict__ out,
                  float* __restrict__ lse, int H, int Kv, Mask mask,
                  float scale, float cap) {
  constexpr int KLD = D + 8;          // K tile [keys][KLD]
  constexpr int VLD = kMmaKeys + 8;   // V^T tile [D][VLD]
  constexpr int NT = kMmaKeys / 8;    // score accumulators per row block
  __shared__ __align__(16) bf16 ks[kMmaKeys * KLD];
  __shared__ __align__(16) bf16 vt[D * VLD];

  const int t0 = blockIdx.x * kMmaRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Kv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int S = mask.S;
  const int rw = t0 + warp * 16;      // the warp's first row
  const int rows[2] = {rw + g, rw + g + 8};

  // the warp's Q rows as A fragments, straight from device memory
  uint32_t qa[D / 16][4];
  {
    const bf16* qb = static_cast<const bf16*>(q.ptr) + b * q.sb + h * q.sh;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rows[i & 1];
        const int col = kk * 16 + 2 * c + (i >= 2 ? 8 : 0);
        qa[kk][i] = r < S ? ld32(qb + r * q.ss + col) : 0u;
      }
    }
  }

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int lo = mask.key_lo(t0) / kMmaKeys * kMmaKeys;
  const int hi = mask.key_hi(min(t0 + kMmaRows, S) - 1);

  for (int k0 = lo; k0 <= hi; k0 += kMmaKeys) {
    __syncthreads();  // the previous tile is consumed
    stage_bf16<D>(ks, KLD, nullptr, 0, kMmaKeys, k, b, k0, kvh, S);
    stage_bf16<D>(nullptr, 0, vt, VLD, kMmaKeys, v, b, k0, kvh, S);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bk[2];
        load_b(bk, ks + j * 8 * KLD + kk * 16, KLD, g, c);
        mma(s[j], qa[kk], bk);
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = rows[e / 2];
        const int key = k0 + j * 8 + 2 * c + (e & 1);
        float dcap;
        const float x = cap_score(s[j][e], scale, cap, &dcap);
        s[j][e] = (t < S && mask.ok(t, key)) ? x : -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // row max over the quad's 4 lanes
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float mnew = fmaxf(m[i], mx[i]);
      const float corr = mnew == -INFINITY ? 1.f : expf(m[i] - mnew);
      m[i] = mnew;
      l[i] *= corr;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][2 * i] *= corr;
        o[n][2 * i + 1] *= corr;
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float p = x == -INFINITY ? 0.f : expf(x - m[e / 2]);
        s[j][e] = p;
        l[e / 2] += p;
      }
    }

    // PV: P (rounded to bf16, as the reference rounds it to v's dtype)
#pragma unroll
    for (int kt = 0; kt < kMmaKeys / 16; ++kt) {
      const uint32_t pa[4] = {pack2(s[2 * kt][0], s[2 * kt][1]),
                              pack2(s[2 * kt][2], s[2 * kt][3]),
                              pack2(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                              pack2(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bv[2];
        load_b(bv, vt + n * 8 * VLD + kt * 16, VLD, g, c);
        mma(o[n], pa, bv);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int t = rows[i];
    if (t >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    bf16* orow = out + ((static_cast<size_t>(b) * S + t) * H + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * c) =
          pack2(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    }
    if (c == 0) {
      lse[(static_cast<size_t>(b) * H + h) * S + t] =
          m[i] + logf(fmaxf(l[i], 1e-30f));
    }
  }
}

constexpr int kMmaBwdKeys = 64;   // dK/dV: 16 keys per warp
constexpr int kMmaBwdRows = 32;   // dK/dV: query rows per staged tile
constexpr int kMmaDqKeys = 32;    // dQ: keys per staged tile

template <int D>
constexpr size_t dkdv_mma_smem() {
  // K, V [64][D + 8]; Q, dO [32][D + 8]; Q^T, dO^T [D][32 + 8]; lse, Di
  return sizeof(bf16) * (2 * kMmaBwdKeys * (D + 8) +
                         2 * kMmaBwdRows * (D + 8) +
                         2 * D * (kMmaBwdRows + 8)) +
         sizeof(float) * 2 * kMmaBwdRows;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv_mma_kernel(Strided q, Strided k, Strided v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ di, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int H, int Kv, Mask mask,
                       float scale, float cap) {
  constexpr int LD = D + 8;
  constexpr int TLD = kMmaBwdRows + 8;
  constexpr int NT = kMmaBwdRows / 8;   // accumulators over a row tile
  extern __shared__ float4 smem4[];
  bf16* ks = reinterpret_cast<bf16*>(smem4);   // [64][LD]
  bf16* vs = ks + kMmaBwdKeys * LD;            // [64][LD]
  bf16* qs = vs + kMmaBwdKeys * LD;            // [32][LD]
  bf16* dos = qs + kMmaBwdRows * LD;           // [32][LD]
  bf16* qt = dos + kMmaBwdRows * LD;           // [D][TLD]
  bf16* dot = qt + D * TLD;                    // [D][TLD]
  float* lses = reinterpret_cast<float*>(dot + D * TLD);  // [32]
  float* dis = lses + kMmaBwdRows;                        // [32]

  const int s0 = blockIdx.x * kMmaBwdKeys;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Kv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int S = mask.S;
  const int kw = warp * 16;   // the warp's first key in the tile
  const Strided dsrc{dout, static_cast<long long>(S) * H * D,
                     static_cast<long long>(H) * D, D};

  stage_bf16<D>(ks, LD, nullptr, 0, kMmaBwdKeys, k, b, s0, kvh, S);
  stage_bf16<D>(vs, LD, nullptr, 0, kMmaBwdKeys, v, b, s0, kvh, S);

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  }
  const int keys[2] = {s0 + kw + g, s0 + kw + g + 8};
  const int r_lo = mask.row_lo(s0) / kMmaBwdRows * kMmaBwdRows;
  const int r_hi = mask.row_hi(min(s0 + kMmaBwdKeys, S) - 1);

  for (int hh = kvh * G; hh < (kvh + 1) * G; ++hh) {
    for (int t0 = r_lo; t0 <= r_hi; t0 += kMmaBwdRows) {
      __syncthreads();  // the previous tile is consumed
      stage_bf16<D>(qs, LD, qt, TLD, kMmaBwdRows, q, b, t0, hh, S);
      stage_bf16<D>(dos, LD, dot, TLD, kMmaBwdRows, dsrc, b, t0, hh, S);
      if (threadIdx.x < kMmaBwdRows) {
        const int t = t0 + threadIdx.x;
        const size_t idx = (static_cast<size_t>(b) * H + hh) * S + t;
        lses[threadIdx.x] = t < S ? lse[idx] : 0.f;
        dis[threadIdx.x] = t < S ? di[idx] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x 32 rows
      float st[NT][4], dpt[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        load_a(ak, ks + kw * LD + kk * 16, LD, g, c);
        load_a(av, vs + kw * LD + kk * 16, LD, g, c);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t bq[2], bd[2];
          load_b(bq, qs + j * 8 * LD + kk * 16, LD, g, c);
          load_b(bd, dos + j * 8 * LD + kk * 16, LD, g, c);
          mma(st[j], ak, bq);
          mma(dpt[j], av, bd);
        }
      }
      // P^T = exp(s - lse), dS^T = P^T (dP^T - Di) d(cap)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = j * 8 + 2 * c + (e & 1);
          const int t = t0 + rl;
          float dcap;
          const float x = cap_score(st[j][e], scale, cap, &dcap);
          const bool ok = t < S && mask.ok(t, keys[e / 2]);
          const float p = ok ? expf(x - lses[rl]) : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - dis[rl]) * dcap;
        }
      }
      // dV += P^T dO, dK += dS^T Q over the tile's 32 rows
#pragma unroll
      for (int kt = 0; kt < kMmaBwdRows / 16; ++kt) {
        const uint32_t pa[4] = {pack2(st[2 * kt][0], st[2 * kt][1]),
                                pack2(st[2 * kt][2], st[2 * kt][3]),
                                pack2(st[2 * kt + 1][0], st[2 * kt + 1][1]),
                                pack2(st[2 * kt + 1][2], st[2 * kt + 1][3])};
        const uint32_t da[4] = {pack2(dpt[2 * kt][0], dpt[2 * kt][1]),
                                pack2(dpt[2 * kt][2], dpt[2 * kt][3]),
                                pack2(dpt[2 * kt + 1][0], dpt[2 * kt + 1][1]),
                                pack2(dpt[2 * kt + 1][2], dpt[2 * kt + 1][3])};
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          uint32_t bo[2], bq[2];
          load_b(bo, dot + n * 8 * TLD + kt * 16, TLD, g, c);
          load_b(bq, qt + n * 8 * TLD + kt * 16, TLD, g, c);
          mma(dva[n], pa, bo);
          mma(dka[n], da, bq);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] >= S) continue;
    const size_t off = ((static_cast<size_t>(b) * S + keys[i]) * Kv + kvh) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8 + 2 * c) =
          pack2(dka[n][2 * i] * scale, dka[n][2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8 + 2 * c) =
          pack2(dva[n][2 * i], dva[n][2 * i + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_mma_kernel(Strided q, Strided k, Strided v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, bf16* __restrict__ dq,
                     int H, int Kv, Mask mask, float scale, float cap) {
  constexpr int LD = D + 8;
  constexpr int TLD = kMmaDqKeys + 8;
  constexpr int NT = kMmaDqKeys / 8;
  __shared__ __align__(16) bf16 ks[kMmaDqKeys * LD];
  __shared__ __align__(16) bf16 vs[kMmaDqKeys * LD];
  __shared__ __align__(16) bf16 kt_s[D * TLD];

  const int t0 = blockIdx.x * kMmaRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Kv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int S = mask.S;
  const int rw = t0 + warp * 16;
  const int rows[2] = {rw + g, rw + g + 8};

  // the warp's Q and dO rows as A fragments; lse and Di of its rows
  uint32_t qa[D / 16][4], da[D / 16][4];
  {
    const bf16* qb = static_cast<const bf16*>(q.ptr) + b * q.sb + h * q.sh;
    const bf16* db = dout + static_cast<size_t>(b) * S * H * D + h * D;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rows[i & 1];
        const int col = kk * 16 + 2 * c + (i >= 2 ? 8 : 0);
        qa[kk][i] = r < S ? ld32(qb + r * q.ss + col) : 0u;
        da[kk][i] = r < S ? ld32(db + static_cast<size_t>(r) * H * D + col)
                          : 0u;
      }
    }
  }
  float lr[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t idx = (static_cast<size_t>(b) * H + h) * S + rows[i];
    lr[i] = rows[i] < S ? lse[idx] : 0.f;
    dr[i] = rows[i] < S ? di[idx] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int lo = mask.key_lo(t0) / kMmaDqKeys * kMmaDqKeys;
  const int hi = mask.key_hi(min(t0 + kMmaRows, S) - 1);

  for (int k0 = lo; k0 <= hi; k0 += kMmaDqKeys) {
    __syncthreads();
    stage_bf16<D>(ks, LD, kt_s, TLD, kMmaDqKeys, k, b, k0, kvh, S);
    stage_bf16<D>(vs, LD, nullptr, 0, kMmaDqKeys, v, b, k0, kvh, S);
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bk[2], bv[2];
        load_b(bk, ks + j * 8 * LD + kk * 16, LD, g, c);
        load_b(bv, vs + j * 8 * LD + kk * 16, LD, g, c);
        mma(s[j], qa[kk], bk);
        mma(dp[j], da[kk], bv);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = rows[e / 2];
        const int key = k0 + j * 8 + 2 * c + (e & 1);
        float dcap;
        const float x = cap_score(s[j][e], scale, cap, &dcap);
        const bool ok = t < S && mask.ok(t, key);
        const float p = ok ? expf(x - lr[e / 2]) : 0.f;
        s[j][e] = p * (dp[j][e] - dr[e / 2]) * dcap;   // dS
      }
    }
#pragma unroll
    for (int kt = 0; kt < kMmaDqKeys / 16; ++kt) {
      const uint32_t sa[4] = {pack2(s[2 * kt][0], s[2 * kt][1]),
                              pack2(s[2 * kt][2], s[2 * kt][3]),
                              pack2(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                              pack2(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bk[2];
        load_b(bk, kt_s + n * 8 * TLD + kt * 16, TLD, g, c);
        mma(acc[n], sa, bk);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= S) continue;
    bf16* row = dq + ((static_cast<size_t>(b) * S + rows[i]) * H + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(row + n * 8 + 2 * c) =
          pack2(acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
    }
  }
}

// --------------------------------------------------------------- launches

// above 48 KB a block's shared memory must be opted into, once per kernel
template <typename K>
int opt_in(K kernel, size_t smem, bool& done) {
  if (smem <= 48 * 1024 || done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  done = e == cudaSuccess;
  return static_cast<int>(e);
}

struct Args {
  Strided q, k, v;
  int B, S, H, Kv, D;
  Mask mask;
  float scale, cap;
  cudaStream_t stream;
};

template <int D>
int fwd_mma(const Args& a, void* out, float* lse) {
  const dim3 grid((a.S + kMmaRows - 1) / kMmaRows, a.H, a.B);
  fa_fwd_mma_kernel<D><<<grid, kThreads, 0, a.stream>>>(
      a.q, a.k, a.v, static_cast<bf16*>(out), lse, a.H, a.Kv, a.mask,
      a.scale, a.cap);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd_mma(const Args& a, const void* o, const void* dout, const float* lse,
            float* di, void* dq, void* dk, void* dv) {
  const int rows = a.B * a.S * a.H;
  fa_bwd_pre_kernel<D><<<(rows + kWarps - 1) / kWarps, kThreads, 0,
                         a.stream>>>(static_cast<const bf16*>(o),
                                     static_cast<const bf16*>(dout), di, rows,
                                     a.S, a.H);
  int e = static_cast<int>(cudaGetLastError());
  if (e) return e;

  constexpr size_t smem_kv = dkdv_mma_smem<D>();
  static bool opted_kv = false;
  e = opt_in(fa_bwd_dkdv_mma_kernel<D>, smem_kv, opted_kv);
  if (e) return e;
  const dim3 grid_kv((a.S + kMmaBwdKeys - 1) / kMmaBwdKeys, a.Kv, a.B);
  fa_bwd_dkdv_mma_kernel<D><<<grid_kv, kThreads, smem_kv, a.stream>>>(
      a.q, a.k, a.v, static_cast<const bf16*>(dout), lse, di,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), a.H, a.Kv, a.mask,
      a.scale, a.cap);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;

  const dim3 grid_q((a.S + kMmaRows - 1) / kMmaRows, a.H, a.B);
  fa_bwd_dq_mma_kernel<D><<<grid_q, kThreads, 0, a.stream>>>(
      a.q, a.k, a.v, static_cast<const bf16*>(dout), lse, di,
      static_cast<bf16*>(dq), a.H, a.Kv, a.mask, a.scale, a.cap);
  return static_cast<int>(cudaGetLastError());
}

bool valid_args(const Args& a) {
  return a.B > 0 && a.S > 0 && a.H > 0 && a.Kv > 0 && a.H % a.Kv == 0 &&
         a.H <= 65535 && a.B <= 65535;
}

Args make_args(const void* q, const long long* qs, const void* k,
               const long long* kst, const void* v, const long long* vs,
               int B, int S, int H, int Kv, int D, int causal, int window,
               float scale, float cap, void* stream) {
  Args a;
  a.q = Strided{q, qs[0], qs[1], qs[2]};
  a.k = Strided{k, kst[0], kst[1], kst[2]};
  a.v = Strided{v, vs[0], vs[1], vs[2]};
  a.B = B;
  a.S = S;
  a.H = H;
  a.Kv = Kv;
  a.D = D;
  a.mask = Mask{S, causal, window};
  a.scale = scale;
  a.cap = cap;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

#define REPRO_BY_DIM(FN, ...)                                      \
  switch (a.D) {                                                   \
    case 32: return FN<32>(a, __VA_ARGS__);                        \
    case 64: return FN<64>(a, __VA_ARGS__);                        \
    case 128: return FN<128>(a, __VA_ARGS__);                      \
    default: return static_cast<int>(cudaErrorInvalidValue);       \
  }

}  // namespace

// dtype code 1 = bfloat16, the one dtype the kernels take.  Strides are
// in elements, (batch, sequence, head) for each of q, k, v.
extern "C" int repro_flash_attention_fwd(
    const void* q, const long long* q_strides, const void* k,
    const long long* k_strides, const void* v, const long long* v_strides,
    void* out, float* lse, int B, int S, int H, int Kv, int D, int causal,
    int window, float scale, float cap, int dtype, void* stream) {
  const Args a = make_args(q, q_strides, k, k_strides, v, v_strides, B, S, H,
                           Kv, D, causal, window, scale, cap, stream);
  if (dtype != 1 || !valid_args(a))
    return static_cast<int>(cudaErrorInvalidValue);
  REPRO_BY_DIM(fwd_mma, out, lse)
}

// o and dout contiguous [B, S, H, D]; di is fp32 scratch [B, H, S]; dq
// [B, S, H, D], dk and dv [B, S, Kv, D], contiguous, bf16.
extern "C" int repro_flash_attention_bwd(
    const void* q, const long long* q_strides, const void* k,
    const long long* k_strides, const void* v, const long long* v_strides,
    const void* o, const void* dout, const float* lse, float* di, void* dq,
    void* dk, void* dv, int B, int S, int H, int Kv, int D, int causal,
    int window, float scale, float cap, int dtype, void* stream) {
  const Args a = make_args(q, q_strides, k, k_strides, v, v_strides, B, S, H,
                           Kv, D, causal, window, scale, cap, stream);
  if (dtype != 1 || !valid_args(a))
    return static_cast<int>(cudaErrorInvalidValue);
  REPRO_BY_DIM(bwd_mma, o, dout, lse, di, dq, dk, dv)
}
