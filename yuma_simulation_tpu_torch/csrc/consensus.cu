// K1 - the consensus bisection kernel.
//
// Replaces: yuma_simulation_tpu/ops/pallas_consensus.py ::
//   stake_weighted_median_pallas (the Pallas body _consensus_kernel), the
//   17-halving stake-weighted median per miner over a [V, M] weight block.
//
// What bounds it on the H100: one call must read W_n once (4 MiB at the
// 256 x 4096 flagship shape, ~1.25 us at 3.35 TB/s); the 17 halvings are
// ~36 M int32 compare-adds (~0.5 us at the 67 T/s vector rate). So it is
// bound by bytes, IF the 17 traversals do not go back to device memory.
//
// What the design does about it: the TPU kernel keeps a whole [V, 512]
// block in VMEM; an SM has 227 KB of shared memory, so each block here
// stages a [V, 128] miner tile of W_n (128 KB at V = 256) into dynamic
// shared memory once and runs all halvings from there: W_n is read from
// device memory exactly once. 4 validator lanes per column (512 threads)
// share each column's support sum; the int32 sum is exact, so the result
// is bitwise the plain version's for any thread layout
// (ops/consensus.py). The body lives in common.cuh, shared with the
// scans' consensus phase.
//
// With mma set, the same entry runs K4 (k_bisect_mma, common.cuh): the
// support sums of every halving on the tensor cores, bitwise the same.
#include "common.cuh"

namespace {

// Canonical fixed-point stakes round(S * 2^30), half to even.
__global__ void k_stake_int(const float* __restrict__ s, int* __restrict__ sint,
                            size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) sint[i] = __float2int_rn(s[i] * yuma::kFixed);
}

}  // namespace

// c_hi [nslab, M] of W_n [nslab, V, M] and normalized stakes S_n
// [nslab, V]; `sint` is [nslab, V] int32 scratch; `kappa` one float on
// the device; `mma` selects K4. Launches on `stream`, allocates nothing,
// and returns the launch status (cudaGetLastError()).
extern "C" int yuma_bisect(const float* wn, const float* sn, int* sint,
                           const float* kappa, float* chi, int nslab, int V,
                           int M, int iters, int mma, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = (size_t)nslab * V;
  k_stake_int<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(sn, sint, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)yuma::launch_bisect(wn, sint, kappa, 0, 1, nslab, chi, V, M,
                                  iters, st, mma);
}
