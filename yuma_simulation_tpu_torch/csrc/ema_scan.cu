// K5 - the scaled scan, and K6 - one fused EMA-family epoch.
//
// Replaces: yuma_simulation_tpu/ops/pallas_epoch.py :: fused_ema_scan
//   (Pallas body _fused_ema_scan_kernel): the whole scan of W * scales[e]
//   over E epochs, all five bond models and liquid alpha, for one [V, M]
//   base matrix or a scenario batch [Bb, V, M] sharing `scales`, returning
//   the final bonds and the sum over epochs of the normalized dividends;
//   and fused_ema_epoch (body _fused_ema_epoch_kernel): one EMA-family
//   epoch of W * w_scale with a carried bond state, a first-epoch flag, an
//   optional clip base for EMA_PREV and m_real, returning the new bonds,
//   D_n and the incentive.
//
// What bounds K5 on the H100: W and S are read once per call and the
// bonds written once (~8 MiB at 256 x 4096), a few microseconds; the work
// is the epochs' arithmetic: per epoch 17 halvings of V * M compare-adds
// plus about ten elementwise passes over [V, M]. So the operations bound
// it, at the vector rate. The TPU kernel keeps W and the bonds resident
// in VMEM across its grid; here W (4 MiB) and the bond state stay in the
// 50 MB L2 between the phase kernels.
//
// What the design does about it: K5 and K6 are launch sequences of the
// same phase kernels as K2 and K3 (scan_phases.cuh): W and the stakes are
// stored once and read at every epoch (their epoch stride is 0), phase 3
// multiplies by scales[e] before the row sum, the stakes come in already
// normalized, no per-epoch output is written, and phase 8 adds D_n into a
// float32 sum in epoch order. K5 runs phases 2-6 once per T-epoch tile,
// as K3 does: the weights of every epoch are known up front. With mxu the
// bisection runs on the tensor cores (K4, common.cuh), bitwise the same.
//
// K6 is one epoch, called once per epoch from Python, so what its caller
// waits for is the host as much as the card. Its launch sequence is eight
// phase kernels and a memset: the hyperparameters and resets come by value
// in ScanArgs (one pinned copy a call measured ~0.05 ms slower, PERF.md),
// the old bonds are read where they lie (bonds_in) and the new ones
// written to a fresh buffer, no consensus is carried, and phase 8 runs
// inside phase 7's launch. Nothing in the call waits for the card.
#include "scan_phases.cuh"

// K5: the scaled scan over a T-epoch tile; T divides E.
extern "C" int yuma_ema_scan(const ScanArgs* a) {
  if (a->T < 1 || a->E % a->T != 0 || a->w_epochs != 1 || !a->scales ||
      !a->dacc)
    return (int)cudaErrorInvalidValue;
  return run_scan(*a, a->T);
}

// K6: one epoch (E = T = 1, one scenario).
extern "C" int yuma_ema_epoch(const ScanArgs* a) {
  if (a->E != 1 || a->B != 1 || !a->scales) return (int)cudaErrorInvalidValue;
  return run_scan(*a, 1);
}
