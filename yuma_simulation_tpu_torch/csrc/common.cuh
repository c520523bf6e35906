// Shared device code of the port's CUDA kernels: float helpers with the
// JAX package's NaN/inf semantics, a block reduction in a fixed order, and
// the consensus bisection kernel itself (K1's body, also the consensus
// phase of the case and varying scans).
//
// Determinism: every float reduction here runs in a fixed order (each
// thread a strided sequential sum, then a fixed shuffle tree), never with
// float atomics, so a run is reproducible bit for bit. The bisection's
// support is an int32 sum, exact in any order.
#pragma once

#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace yuma {

// 2^-30: the fixed-point scale of the canonical stake encoding
// (ops/consensus.py::support_fixed_stakes).
constexpr float kInvFixed = 1.0f / 1073741824.0f;
constexpr float kFixed = 1073741824.0f;
// float32(1/65535): the u16 grid value k / 65535 is computed as k * kU16Inv,
// the multiply XLA compiles the JAX package's divide by 65535 into
// (ops/consensus.py::U16_INV).
constexpr float kU16Inv = 1.0f / 65535.0f;

// jnp.nan_to_num / torch.nan_to_num: NaN -> 0, +-inf -> +-FLT_MAX.
__device__ __forceinline__ float nan_to_num(float x) {
  if (x != x) return 0.0f;
  if (x == INFINITY) return FLT_MAX;
  if (x == -INFINITY) return -FLT_MAX;
  return x;
}

// jnp.minimum / jnp.maximum: a NaN operand gives NaN (fminf would drop it).
__device__ __forceinline__ float min_nan(float a, float b) {
  if (a != a || b != b) return __int_as_float(0x7fc00000);
  return a < b ? a : b;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a || b != b) return __int_as_float(0x7fc00000);
  return a > b ? a : b;
}

// Sum of one value per thread over the whole block, returned to every
// thread. blockDim.x must be a multiple of 32 (at most 1024) and every
// thread must call it. The order is fixed: a shuffle tree inside each
// warp, then the warp partials by a second shuffle tree.
template <typename T>
__device__ T block_sum(T v) {
  __shared__ T red[33];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // the previous call's readers are done with red
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    v = lane < nw ? red[lane] : T(0);
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

// Consensus bisection of one `[V, TM]` miner tile of one slab (a slab is
// one (epoch, scenario) `[V, M]` matrix). Block = (TM miner columns) x
// (VS validator lanes). With STAGED, the tile of W_n is copied to dynamic
// shared memory once and all halvings read it there; otherwise every
// halving reads W_n from global memory (large V).
//
// Each halving: every thread sums the fixed-point stakes of its validator
// lane whose weight is strictly above the midpoint (int32, exact), the VS
// partials of a column are added (exact), and the sum rounded once to
// float32 is compared strictly with kappa (ops/consensus.py::
// support_rounded). Returns the final c_high per miner.
template <bool STAGED>
__global__ void k_bisect(const float* __restrict__ wn,
                         const int* __restrict__ sint,
                         const float* __restrict__ kappa, int kappa_stride,
                         int B, float* __restrict__ chi, int V, int M,
                         int iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int TM = blockDim.x, VS = blockDim.y;
  const int s = blockIdx.y;
  const float kap = kappa[(s % B) * kappa_stride];
  const float* W = wn + (size_t)s * V * M;
  const int* Si = sint + (size_t)s * V;
  int* part = reinterpret_cast<int*>(smem);  // [VS][TM]
  int* dec = part + VS * TM;                 // [TM]
  int* Ss = dec + TM;                        // [V]
  float* Ws = reinterpret_cast<float*>(Ss + V);  // [V][TM] when STAGED
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TM + tx, nt = TM * VS;
  const int m0 = blockIdx.x * TM, m = m0 + tx;
  for (int v = tid; v < V; v += nt) Ss[v] = Si[v];
  if (STAGED) {
    for (int i = tid; i < V * TM; i += nt) {
      const int v = i / TM, c = i - v * TM;
      Ws[i] = (m0 + c < M) ? W[(size_t)v * M + m0 + c] : 0.0f;
    }
  }
  __syncthreads();
  float lo = 0.0f, hi = 1.0f;
  for (int it = 0; it < iters; ++it) {
    const float mid = (hi + lo) * 0.5f;
    int acc = 0;
    if (STAGED || m < M) {
      for (int v = ty; v < V; v += VS) {
        const float w = STAGED ? Ws[v * TM + tx] : W[(size_t)v * M + m];
        acc += (w > mid) ? Ss[v] : 0;
      }
    }
    part[tid] = acc;
    __syncthreads();
    if (ty == 0) {
      int tot = 0;
      for (int j = 0; j < VS; ++j) tot += part[j * TM + tx];
      dec[tx] = (__int2float_rn(tot) * kInvFixed) > kap;
    }
    __syncthreads();
    const bool above = dec[tx] != 0;
    lo = above ? mid : lo;
    hi = above ? hi : mid;
  }
  if (ty == 0 && m < M) chi[(size_t)s * M + m] = hi;
}

// K4 - the same bisection with the support sum on the tensor cores.
//
// Replaces: the mxu=True form of the JAX package's Pallas kernels
//   (ops/pallas_epoch.py :: _stake_limb_split, _support_limbs_mxu, used in
//   _consensus_phase): the int32 support sum as an exact matrix product.
//
// Exact by construction: S_int < 2^31 is cut into four u8 limbs, and each
// halving contracts the limb rows [4, V] with the u8 0/1 mask
// [W_n > mid] [V, M] on the tensor cores (mma.sync m16n8k32, u8 x u8 ->
// s32). Every product is exact and an s32 partial sum of limbs stays
// below V * 255 < 2^31, so each limb sum is the exact integer; shifting
// the four sums back together in int32 gives the VPU path's support bit
// for bit (the TPU needed a bf16 head/residual split because its dot
// rounds operands to bf16; u8 operands need no such split).
//
// What bounds it: like K1, reading W_n once (bytes); the contraction is
// 2 * 4 * V * M int8 operations per halving, nothing at 1,979 TOPS. The
// tensor cores replace the int adds, not the traversal: every halving
// still reads the staged [V, TM] tile from shared memory once.
//
// Layout: one warp per 8-miner group. A (16 x 32, row-major) holds the 4
// limb rows of 32 validators (rows 4..15 zero); B (32 x 8, column-major)
// the mask of those validators for the warp's 8 miners. Lane (g, t) =
// (lane / 4, lane % 4) feeds A row g, k = 4t..4t+3 and 16+4t..16+4t+3,
// and B column g at the same k; it gets D[g][2t], D[g][2t+1] back, so
// lanes g < 4 hold limb g's sums of miners 2t and 2t+1. The W_n tile is
// staged with a row stride of TM + 2, which makes the 32 lanes' loads of
// one B fragment fall in 32 distinct banks.
__device__ __forceinline__ void mma_u8_m16n8k32(int (&d)[4], unsigned a0,
                                                unsigned a2, unsigned b0,
                                                unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

constexpr int kLimbs = 4;

// One byte per validator: (w > mid), lowest k in the lowest byte.
__device__ __forceinline__ unsigned mask4(float w0, float w1, float w2,
                                          float w3, float mid) {
  return (unsigned)(w0 > mid) | ((unsigned)(w1 > mid) << 8) |
         ((unsigned)(w2 > mid) << 16) | ((unsigned)(w3 > mid) << 24);
}

template <bool STAGED>
__global__ void k_bisect_mma(const float* __restrict__ wn,
                             const int* __restrict__ sint,
                             const float* __restrict__ kappa, int kappa_stride,
                             int B, float* __restrict__ chi, int V, int M,
                             int iters, int TM) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int VP = (V + 31) & ~31, TS = TM + 2;
  float* lo = reinterpret_cast<float*>(smem);            // [TM]
  float* hi = lo + TM;                                   // [TM]
  unsigned char* limb = reinterpret_cast<unsigned char*>(hi + TM);  // [4][VP]
  float* Ws = reinterpret_cast<float*>(limb + kLimbs * VP);  // [VP][TS]
  const int s = blockIdx.y;
  const float kap = kappa[(s % B) * kappa_stride];
  const float* W = wn + (size_t)s * V * M;
  const int* Si = sint + (size_t)s * V;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, nw = nt >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * TM;
  for (int v = tid; v < VP; v += nt) {
    const unsigned x = v < V ? (unsigned)Si[v] : 0u;
    for (int j = 0; j < kLimbs; ++j) limb[j * VP + v] = (x >> (8 * j)) & 255u;
  }
  for (int c = tid; c < TM; c += nt) {
    lo[c] = 0.0f;
    hi[c] = 1.0f;
  }
  if (STAGED) {
    for (int i = tid; i < VP * TM; i += nt) {
      const int v = i / TM, c = i - v * TM;
      Ws[v * TS + c] = (v < V && m0 + c < M) ? W[(size_t)v * M + m0 + c] : 0.0f;
    }
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    for (int grp = warp; grp < (TM >> 3); grp += nw) {
      const int n0 = grp * 8, col = n0 + g;
      const float mid = (hi[col] + lo[col]) * 0.5f;
      const bool live = STAGED || m0 + col < M;
      int acc[4] = {0, 0, 0, 0};
      for (int k0 = 0; k0 < VP; k0 += 32) {
        float w[8];
        for (int i = 0; i < 8; ++i) {
          const int v = k0 + t * 4 + (i & 3) + (i >> 2) * 16;
          if (STAGED) {
            w[i] = Ws[v * TS + col];
          } else {
            w[i] = (live && v < V) ? W[(size_t)v * M + m0 + col] : 0.0f;
          }
        }
        const unsigned b0 = mask4(w[0], w[1], w[2], w[3], mid);
        const unsigned b1 = mask4(w[4], w[5], w[6], w[7], mid);
        unsigned a0 = 0u, a2 = 0u;
        if (g < kLimbs) {
          a0 = *reinterpret_cast<const unsigned*>(limb + g * VP + k0 + t * 4);
          a2 = *reinterpret_cast<const unsigned*>(limb + g * VP + k0 + 16 + t * 4);
        }
        mma_u8_m16n8k32(acc, a0, a2, b0, b1);
      }
      // Recombine the limb sums of miners n0 + 2t and n0 + 2t + 1, most
      // significant limb first (every partial is <= the exact support,
      // which fits int32).
      unsigned s0 = 0u, s1 = 0u;
      for (int j = kLimbs - 1; j >= 0; --j) {
        s0 = (s0 << 8) + (unsigned)__shfl_sync(0xffffffffu, acc[0], j * 4 + t);
        s1 = (s1 << 8) + (unsigned)__shfl_sync(0xffffffffu, acc[1], j * 4 + t);
      }
      __syncwarp();  // every lane has read its mid before lanes 0..3 move it
      if (g == 0) {
        for (int h = 0; h < 2; ++h) {
          const int c = n0 + 2 * t + h;
          const float m = (hi[c] + lo[c]) * 0.5f;
          const int tot = (int)(h ? s1 : s0);
          if ((__int2float_rn(tot) * kInvFixed) > kap) {
            lo[c] = m;
          } else {
            hi[c] = m;
          }
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int c = tid; c < TM; c += nt) {
    if (m0 + c < M) chi[(size_t)s * M + m0 + c] = hi[c];
  }
}

// Launch k_bisect (mma = 0) or k_bisect_mma (mma = 1, V <= 2^14) over
// `nslab` slabs. The miner tile is the widest of 128/64/32 whose W_n
// block fits the shared-memory budget (128 columns at V <= ~380); larger
// V reads W_n from global memory.
inline cudaError_t launch_bisect(const float* wn, const int* sint,
                                 const float* kappa, int kappa_stride, int B,
                                 int nslab, float* chi, int V, int M,
                                 int iters, cudaStream_t st, int mma = 0) {
  constexpr size_t kBudget = 200 * 1024;
  constexpr int kThreads = 512;
  const size_t VP = (size_t)((V + 31) & ~31);
  if (mma && V > (1 << 14)) return cudaErrorInvalidValue;
  auto need = [&](int tm, bool staged) -> size_t {
    if (mma)
      return 2 * sizeof(float) * tm + kLimbs * VP +
             (staged ? sizeof(float) * VP * (tm + 2) : 0);
    return sizeof(int) * (kThreads + tm + (size_t)V) +
           (staged ? sizeof(float) * (size_t)V * tm : 0);
  };
  int TM = 128;
  bool staged = false;
  for (int tm = 128; tm >= 32; tm >>= 1) {
    if (need(tm, true) <= kBudget) {
      TM = tm;
      staged = true;
      break;
    }
  }
  const size_t smem = need(TM, staged);
  if (smem > kBudget) return cudaErrorInvalidValue;
  const dim3 grid((M + TM - 1) / TM, nslab);
  auto go = [&](auto kernel, dim3 block, auto... args) -> cudaError_t {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, block, smem, st>>>(wn, sint, kappa, kappa_stride, B, chi, V,
                                      M, iters, args...);
    return cudaGetLastError();
  };
  if (mma) {
    return staged ? go(k_bisect_mma<true>, dim3(kThreads), TM)
                  : go(k_bisect_mma<false>, dim3(kThreads), TM);
  }
  const dim3 block(TM, kThreads / TM);
  return staged ? go(k_bisect<true>, block) : go(k_bisect<false>, block);
}

}  // namespace yuma
