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
// (scan_phases.cuh), each sized to its own parallelism. The case scan runs
// phases 2-6 for one epoch at a time; the varying scan runs them once per
// T-epoch tile with the tile as a grid dimension, so a tile's row sums
// pay their chain once and its bisections (128 blocks an epoch at 256 x
// 4096, common.cuh) run side by side. The phase kernels are shared, so
// the two scans agree bitwise.
#include "scan_phases.cuh"

// K2: one epoch per step (phases 2-6 with a tile of 1).
extern "C" int yuma_case_scan(const ScanArgs* a) { return run_scan(*a, 1); }

// K3: phases 2-6 batched over a T-epoch tile; T divides E.
extern "C" int yuma_varying_scan(const ScanArgs* a) {
  if (a->T < 1 || a->E % a->T != 0) return (int)cudaErrorInvalidValue;
  return run_scan(*a, a->T);
}
