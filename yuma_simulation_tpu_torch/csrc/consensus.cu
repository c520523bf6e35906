// K1 - the consensus bisection kernel, and K4's standalone entry.
//
// Replaces: yuma_simulation_tpu/ops/pallas_consensus.py ::
//   stake_weighted_median_pallas (the Pallas body _consensus_kernel), the
//   17-halving stake-weighted median per miner over a [V, M] weight block;
//   with mma set, the tensor-core support of the JAX package's mxu=True
//   scans (ops/pallas_epoch.py :: _stake_limb_split, _support_limbs_mxu).
//
// What bounds it on the H100: one call must read W_n once (4 MiB at the
// 256 x 4096 flagship shape, ~1.25 us at 3.35 TB/s); the 17 halvings are
// ~36 M int32 compare-adds (~0.5 us at the 67 T/s vector rate), and a
// chain: each halving waits for the one before it.
//
// What the design does about it: the TPU kernel keeps a whole [V, 512]
// block in VMEM. Here each thread loads its share of W_n into registers
// once and every halving runs from there, in blocks small enough that one
// slab at 4096 miners fills 128 of them (k_bisect, k_bisect_mma and their
// layout are in common.cuh, shared with the scans' consensus phase). The
// support is an exact int32 sum, so the result is bitwise the plain
// version's (ops/consensus.py) for any thread layout. The stakes are
// rounded to fixed point as they are loaded and kappa is passed by value,
// so a call is one launch with no copies.
#include "common.cuh"

// c_hi [nslab, M] of W_n [nslab, V, M], normalized stakes S_n [nslab, V]
// and `kappa`; `mma` selects K4. Launches on `stream`, allocates nothing,
// and returns the launch status (cudaErrorInvalidValue for a shape
// launch_bisect does not take).
extern "C" int yuma_bisect(const float* wn, const float* sn, float kappa,
                           float* chi, int nslab, int V, int M, int iters,
                           int mma, void* stream) {
  yuma::BisectArgs a{};
  a.wn = wn;
  a.sn = sn;
  a.kappa0 = kappa;
  a.chi = chi;
  a.nslab = nslab;
  a.V = V;
  a.M = M;
  a.iters = iters;
  return (int)yuma::launch_bisect(a, static_cast<cudaStream_t>(stream), mma);
}

// out[i] = fmaf(a[i], b[i], c[i]), rounded once (__fmaf_rn): the card's
// multiply-add that ops/fma.py::fma reproduces on any device, and the
// yardstick it is held to.
__global__ void k_fmaf(const float* a, const float* b, const float* c, float* out,
                       long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __fmaf_rn(a[i], b[i], c[i]);
}

extern "C" int yuma_fmaf(const float* a, const float* b, const float* c, float* out,
                         long long n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  k_fmaf<<<(unsigned)((n + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, c, out, n);
  return (int)cudaGetLastError();
}
