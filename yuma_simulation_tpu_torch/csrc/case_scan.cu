// K2 - the case scan, and K3 - the varying (epoch-tiled) scan.
//
// Replaces: yuma_simulation_tpu/ops/pallas_epoch.py :: fused_case_scan
//   (Pallas body _fused_case_scan_kernel) and fused_varying_scan (body
//   _fused_varying_scan_kernel): the whole epoch loop over per-epoch
//   weights W[B, E, V, M] and stakes S[B, E, V] - reset injection, row
//   normalization, the 17-halving consensus bisection, the u16 quantize,
//   clip / rank / incentive, liquid alpha, the five bond models and the
//   normalized dividends - with the bond state carried across epochs. With
//   mxu set, the bisection's support sum runs on the tensor cores (K4,
//   common.cuh), the port of their mxu=True form.
//
// What bounds it on the H100: each epoch must read W[e] once (4 MiB at
// 256 x 4096: ~1.25 us at 3.35 TB/s); the bisection's ~36 M int32
// compare-adds take ~0.5 us at the vector rate. Bytes bound it, and only
// if W_n is not re-read from device memory on every halving. The TPU
// kernels keep the whole [V, M] block in VMEM; 4 MiB is far beyond one
// SM's 227 KB of shared memory, but inside the 50 MB L2.
//
// What the design does about it: the epoch is split into phase kernels
// (scan_phases.cuh), each sized to its own parallelism. Phases 2-6 do not
// read the bond state, so both scans run them once per tile of epochs
// with the tile as a grid dimension: a tile's row sums pay their chain
// once and its bisections (128 blocks an epoch at 256 x 4096, common.cuh)
// run side by side; one epoch alone reaches at most 32 of the 132 SMs in
// most of those phases. Only the bond update and the dividends (phases 7
// and 8, one launch) run epoch by epoch. The TPU kernel's case scan steps
// one epoch at a time because one epoch is what fits its VMEM; here the
// case scan takes the largest tile up to 16 whose scratch fits
// (ops/cuda_epoch.py::case_scan_epoch_tile), the last tile taking what is
// left, and the varying scan the tile it is given, which divides E as in
// the JAX package. The phase kernels are shared and compute each epoch
// alike at any tile, so the two scans agree bitwise on the consensus and
// the incentives.
#include "scan_phases.cuh"

// K2: phases 2-6 over tiles of up to T epochs; the last tile may be shorter.
extern "C" int yuma_case_scan(const ScanArgs* a) {
  if (a->T < 1 || !a->cprev) return (int)cudaErrorInvalidValue;
  return run_scan(*a, a->T);
}

// K3: phases 2-6 batched over a T-epoch tile; T divides E.
extern "C" int yuma_varying_scan(const ScanArgs* a) {
  if (a->T < 1 || a->E % a->T != 0 || !a->cprev) return (int)cudaErrorInvalidValue;
  return run_scan(*a, a->T);
}
