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

// Launch k_bisect over `nslab` slabs. The miner tile is the widest of
// 128/64/32 whose W_n block fits the shared-memory budget (128 columns
// at V <= 390); larger V reads W_n from global memory.
inline cudaError_t launch_bisect(const float* wn, const int* sint,
                                 const float* kappa, int kappa_stride, int B,
                                 int nslab, float* chi, int V, int M,
                                 int iters, cudaStream_t st) {
  constexpr size_t kBudget = 200 * 1024;
  constexpr int kThreads = 512;
  int TM = 128;
  bool staged = false;
  size_t smem = 0;
  for (int tm = 128; tm >= 32; tm >>= 1) {
    smem = sizeof(int) * (kThreads + tm + (size_t)V) + sizeof(float) * (size_t)V * tm;
    if (smem <= kBudget) {
      TM = tm;
      staged = true;
      break;
    }
  }
  if (!staged) {
    TM = 128;
    smem = sizeof(int) * (kThreads + TM + (size_t)V);
    if (smem > kBudget) return cudaErrorInvalidValue;
  }
  const dim3 grid((M + TM - 1) / TM, nslab), block(TM, kThreads / TM);
  if (staged) {
    cudaError_t err = cudaFuncSetAttribute(
        k_bisect<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    k_bisect<true><<<grid, block, smem, st>>>(wn, sint, kappa, kappa_stride, B,
                                              chi, V, M, iters);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        k_bisect<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    k_bisect<false><<<grid, block, smem, st>>>(wn, sint, kappa, kappa_stride,
                                               B, chi, V, M, iters);
  }
  return cudaGetLastError();
}

}  // namespace yuma
