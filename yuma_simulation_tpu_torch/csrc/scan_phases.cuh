// The phase kernels of the port's epoch scans and the host loop that
// launches them (run_scan). Included by case_scan.cu (K2, K3) and
// ema_scan.cu (K5, K6), which differ only in what they feed run_scan.
//
// The epoch is split into phase kernels, each sized to its own
// parallelism, launched on one stream by a host loop with no Python per
// epoch, each with programmatic dependent launch (common.cuh::
// launch_kernel: it is scheduled while the kernel before it finishes, and
// waits for it before touching memory):
//   1 reset injection           one block per scenario
//   2 stake normalization       one block per (epoch, scenario)
//   3 row normalization         sums: one block per (epoch, scenario, 8
//                               rows); divide: one block per row
//   4 bisection (K1's body, or  one block of 4 warps per (epoch, scenario,
//     K4's with mxu)            32 miners), W_n held in registers
//                               (common.cuh)
//   5 quantize denominator      one block per (epoch, scenario), int32 sum
//   6 clip / rank               one block per (epoch, scenario, 32
//                               miners), 32 validator slices over its warps
//     incentive, liquid         one block per (epoch, scenario)
//     counting bisection
//   7 bond update and the       one block of 32 warps per (scenario, 32
//     dividend partials         miners), a validator slice per warp
//   8 dividend normalization    in the next epoch's phase-7 launch, one
//                               extra block per scenario; a tile's last
//                               epoch: its own launch's last blocks
// Phases 2-6 run once per tile of up to T epochs with the tile as a grid
// dimension, then phases 1, 7 and 8 epoch by epoch in order. Phases 2-6 do
// not read the bond state, so any tiling gives the same results; the last
// tile may be shorter than T (K2 takes the largest T that fits, K3 and K5
// a T that divides E).
//
// What bounds phases 3, 6 and 7, and what their design does about it:
// - Phase 3's row sum feeds the consensus, so each row is one chain of M
//   dependent float32 adds (~8-9 us at M = 4096): no tree, no split. The
//   floor is that chain, run for every row of the launch at once, so
//   k_rowsum gives each row its own adding lane, only 8 rows per block
//   (a slab's 256 rows spread over 32 blocks), and keeps the adder off
//   device memory: the block's producer warp fills a 4-stage ring of
//   256-column chunks in shared memory with 16-byte cp.async copies, and
//   the adder reads one float4 per four in-order adds. A tile of 16
//   epochs pays the chain once; K6, one epoch a call, pays it every epoch
//   (PERF.md).
// - Phase 6's rank reads the clip base once (4 MiB a slab at 256 x 4096,
//   ~1.25 us at 3.35 TB/s): bytes bound it, and only if enough loads are in
//   flight. k_rank is laid out as k_bond: a block per (slab, 32-miner
//   tile), lane = miner, the validators cut into 32 contiguous slices
//   whose sums are added in slice order, kRankCache rows loaded at once.
//   One slab (K6) takes 32 warps a block, a slice each, so its 128 blocks
//   hold the whole slab's loads in flight (one thread per miner column
//   over all V filled 32 blocks); a tile of many slabs takes 8 warps a
//   block, four slices each, so several blocks share an SM. The slices fix
//   the order, so both layouts give the same bits.
// - Phase 7 must read W_n (or EMA_PREV's clip base) and the bonds once and
//   write the bonds once: ~12 MB per epoch at 256 x 4096, ~3.6 us at
//   3.35 TB/s. Bytes bound it, and only if enough loads are in flight.
//   k_bond gives each (scenario, 32-miner tile) one block of 32 warps,
//   each warp a contiguous validator slice with lane = miner, so every
//   load is 128 contiguous bytes and a warp's whole slice (up to 8
//   validators) is loaded at once into registers: at 256 x 4096 the 128
//   blocks hold all 8 MB of the epoch's reads in flight. (8 warps x 32
//   validators, at 255 registers a thread, measured twice as slow; 16
//   warps x 16 in between: PERF.md.) The column sums run from
//   registers and combine the 32 warp partials in warp order; the update,
//   EMA_RUST's second sum and the dividend partials (sum over the tile's
//   miners of B_next * incentive, in miner order) run from the same
//   registers, so the bonds are read and written once and no second
//   kernel re-reads them. A slice longer than the register cache
//   (V > 256) re-reads its tail from device memory.
// - Phase 8 reads only the dividend partials (V x M / 32 floats, 128 KB at
//   256 x 4096) and normalizes V values: less work than a launch costs,
//   but work that must wait for every block of phase 7. So no launch of
//   its own: epoch e's phase 8 runs in one extra block of epoch e+1's
//   k_bond launch, beside its bond blocks, from partials double-buffered
//   by the epoch's parity, and costs no time of its own. A tile's last
//   epoch cannot wait (the next tile's phases overwrite its stakes), so
//   its own k_bond launch runs it, in two levels so that no block reads
//   all the partials: a block publishes its partials (a barrier, then a
//   device-scope fence) and takes a ticket (an integer atomicAdd) of its
//   group of 16 tiles before it stores its bonds; the group's last block
//   sums the group's partials and takes a ticket of the scenario; the last
//   group adds the group sums, normalizes, and resets the tickets. Both
//   add the partials in the same order (PERF.md has what each piece
//   costs).
//
// What the scans take: W [B, EW, V, M] and S [B, ES, V] with EW, ES the
// epochs stored (E, or 1 for epoch-constant inputs); an optional per-epoch
// weight scale (epoch e reads W * scales[e], before the row sum); stakes
// raw (normalized in phase 2) or already normalized; the hyperparameters
// per scenario, or one row by value shared by all; per-epoch outputs each
// optional, and an optional in-kernel f32 sum of D_n over epochs.
//
// Numerics: the row and stake sums add strictly left to right, as the
// plain PyTorch version does (and XLA's CPU backend for short rows), so the
// consensus, which depends only on W_n and the fixed-point stakes, is
// bitwise the plain version's on any device. Every other float reduction
// runs in a fixed order with no float atomics (the tickets are integers),
// so a run is reproducible bit for bit, and every launch of a phase
// computes each slab alike whatever the tile: K2 and K3 agree bitwise on
// consensus and incentives. Built with --fmad=false: no multiply-add is
// contracted, each operation rounds as the plain version's does.
//
// The bond state lives in one device buffer [B, V, M] that the bond phase
// updates in place (each thread owns one column of one validator slice);
// the first epoch may read its old bonds from another buffer (bonds_in,
// so the wrapper need not copy the carried bonds). The carry buffers
// (bonds, previous consensus, previous W_n) are seeded by the wrapper, so
// the carry / epoch_offset contract of pallas_epoch.py:1566-1575 holds.
#pragma once

#include "common.cuh"

namespace {

enum Mode { EMA_RUST = 0, EMA = 1, EMA_PREV = 2, CAPACITY = 3, RELATIVE = 4 };
enum Reset { RESET_NONE = 0, RESET_ALWAYS = 1, RESET_CONDITIONAL = 2 };
// Columns of the per-scenario hyperparameter rows hp[B, NHP].
enum Hp { KAPPA = 0, BETA, ALPHA, CAP_ALPHA, DECAY, LOGIT_LOW, LOGIT_NUM, ALO, AHI, NHP };
// Where EMA_PREV clips against: the scan rule (this epoch's W_n at global
// epoch 0, else the previous epoch's), the given wprev always, or this
// epoch's W_n always.
enum ClipSrc { CLIP_SCAN = 0, CLIP_GIVEN = 1, CLIP_OWN = 2 };

constexpr float kMaxInt = 18446744073709551616.0f;  // float32(2^64 - 1)

// Phase 3a (k_rowsum): rows per block (one adding lane each), columns per
// ring stage, ring depth, and the padded row stride in floats (= 4 mod 32,
// so the 8 adders' float4 reads fall in 32 distinct banks).
constexpr int kSumRows = 8;
constexpr int kSumCols = 256;
constexpr int kSumStages = 4;
constexpr int kSumStride = kSumCols + 4;
// Phase 7 (k_bond): miners per block (one warp width; ops/cuda_epoch.py::
// BOND_TILE sizes the dividend-partial scratch with it), warps per block,
// and validators per thread held in registers.
constexpr int kBondTM = 32;
constexpr int kBondWarps = 32;
constexpr int kBondThreads = 32 * kBondWarps;
constexpr int kBondCache = 8;
static_assert(kBondTM == 32 && kBondCache <= 32, "lane = miner; one partial per lane");
// Phase 8: k_bond's blocks in groups of kDnormGroup miner tiles; the last
// block of a group sums the group's dividend partials, the last group of a
// scenario the group sums.
constexpr int kDnormGroup = 16;
// Phase 6a (k_rank): the validator slices whose partial sums make R (they
// fix its order), validators a thread loads at once, and the warps per
// block (a slice or more each, lane = miner): kRankWarpsFew while the
// launch has fewer than kRankBlocksPerSM blocks an SM, else kRankWarpsMany.
constexpr int kRankSlices = 32;
constexpr int kRankCache = 8;
constexpr int kRankWarpsFew = 32;
constexpr int kRankWarpsMany = 8;
constexpr int kRankBlocksPerSM = 2;

}  // namespace

// The static liquid-alpha selection (ops/cuda_epoch.py::_liquid_spec):
// the ranks the 0.75 / 0.25 / 0.99 quantiles need and how to combine them.
struct LiquidSpec {
  int K;              // number of ranks selected jointly (<= 6)
  int thresh[6];      // rank + 1 per selected rank
  int q_lo[3];        // per quantile (0.75, 0.25, 0.99): index of the floor
  int q_hi[3];        // and ceil order statistic in the rank list, -1 unused
  double q_wlo[3];    // 1 - frac, float64 (jnp.quantile's weights)
  double q_whi[3];    // frac
  int regime;         // 0 no override, 1 one override, 2 both, 3 both equal
  int has_high, has_low;
  float ov_high, ov_low;
};

struct ScanArgs {
  const float* W;        // [B, w_epochs, V, M] raw weights
  const float* S;        // [B, s_epochs, V] stakes (raw or normalized)
  const float* hp;       // [B, NHP] hyperparameters, or null: hpv for all
  const int* reset_index;  // [B], or null: reset_index0 for all
  const int* reset_epoch;  // [B], or null: reset_epoch0 for all
  float* bonds;          // [B, V, M] bond state, in/out (carry)
  const float* bonds_in; // [B, V, M] the bonds before epoch 0, or null: bonds
  float* cprev;          // [B, M] previous consensus, in/out (carry), or null
  float* wprev;          // [B, V, M] previous W_n, in/out (EMA_PREV carry)
  float* dn;             // [B, E, V] normalized dividends or null
  float* bonds_out;      // [B, E, V, M] or null
  float* inc_out;        // [B, E, M] or null
  float* cons_out;       // [B, E, M] or null
  float* wn;             // [T, B, V, M] scratch
  float* sn;             // [T, B, V] scratch
  int* sint;             // [T, B, V] scratch
  float* chi;            // [T, B, M] scratch
  float* C;              // [T, B, M] scratch
  float* inc;            // [T, B, M] scratch
  float* rate;           // [T, B, M] scratch
  float* dsum;           // [B, V] scratch
  float* dpart;          // [2, B, ceil(M / kBondTM), V] scratch: dividend partials
                         // (by the parity of the epoch's slot in its tile)
  float* dgroup;         // [B, groups, V] scratch: their sums by kDnormGroup tiles
  float* rden;           // [T, B, V] scratch: row denominators
  float* pden;           // [B, V] scratch: recomputed previous row denominators
  int* ticket;           // [B, groups + 1] scratch: phase 8's tickets (run_scan zeroes)
  float* dtot;           // [2, B] scratch: one bond tile's fused dividend total (by parity)
  const float* scales;   // [E] per-epoch weight scale or null
  float* dacc;           // [B, V] sum over epochs of D_n (seeded 0) or null
  void* stream;
  int B, E, V, M, T;
  int mode, reset_mode, iters, rust64, liquid, epoch_offset;
  int w_epochs, s_epochs;  // epochs stored in W / S: E, or 1 (constant)
  int s_normalized;        // S is already normalized (skip phase 2's divide)
  int m_real;              // miners < m_real enter the quantize sum
  int clip_src;            // ClipSrc
  int recompute_prev;      // EMA_PREV: re-derive the previous W_n per tile
  int mxu;                 // phase 4 on the tensor cores (K4)
  int reset_index0, reset_epoch0;
  float hpv[9];            // [NHP]
  LiquidSpec liq;
};
static_assert(NHP == 9, "ScanArgs::hpv holds one hyperparameter row");

namespace {

// Offset of epoch e's [rows] slice of an input that stores `stored`
// epochs (1 = the same slice for every epoch).
__host__ __device__ __forceinline__ size_t epoch_slice(int b, int stored, int e,
                                                       size_t rows) {
  return ((size_t)b * stored + (stored == 1 ? 0 : e)) * rows;
}

__device__ __forceinline__ float epoch_scale(const float* scales, int e) {
  return scales ? scales[e] : 1.0f;
}

// Hyperparameter k of scenario b.
__device__ __forceinline__ float hparam(const ScanArgs& a, int b, int k) {
  return a.hp ? a.hp[(size_t)b * NHP + k] : a.hpv[k];
}

// Phase 2: S_n = S / sum(S) (or S as given) and the fixed-point stakes.
// One block per slab s = t * B + b. The sum feeds the consensus, so it
// adds left to right (ops/normalize.py::sequential_sum), in one thread:
// V is small.
__global__ void k_stake(const float* __restrict__ S, float* __restrict__ sn,
                        int* __restrict__ sint, int B, int SE, int e0, int V,
                        int normalized) {
  yuma::wait_for_prior_grid();
  __shared__ float tot;
  const int s = blockIdx.x, t = s / B, b = s % B;
  const float* row = S + epoch_slice(b, SE, e0 + t, V);
  if (threadIdx.x == 0 && !normalized) {
    float acc = 0.0f;
    for (int v = 0; v < V; ++v) acc += row[v];
    tot = acc;
  }
  __syncthreads();
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    const float x = normalized ? row[v] : row[v] / tot;
    sn[(size_t)s * V + v] = x;
    sint[(size_t)s * V + v] = __float2int_rn(x * yuma::kFixed);
  }
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Phase 3a: the row denominators sum(W * scale) + 1e-6 of slab s = t * B
// + b at epoch e0 + t. The row sum feeds the consensus, so it adds left
// to right (ops/normalize.py::sequential_sum). One block of two warps per
// kSumRows rows: warp 1 keeps a kSumStages-deep ring of [rows x kSumCols]
// chunks in flight with cp.async (16-byte copies when VEC: M % 4 == 0 and
// W 16-byte aligned; else 4-byte), and lane r of warp 0 adds row r's
// values in order, one float4 per four adds, each value multiplied by the
// epoch's scale just before its add. One barrier per chunk: the chunk the
// adder takes has landed, and the stage the producer refills was read in
// the previous step.
template <bool VEC>
__global__ void __launch_bounds__(64) k_rowsum(const float* __restrict__ W,
                                               const float* __restrict__ scales,
                                               float* __restrict__ den,
                                               int B, int WE, int e0, int V, int M) {
  yuma::wait_for_prior_grid();
  __shared__ __align__(16) float ring[kSumStages][kSumRows][kSumStride];
  const int v0 = blockIdx.x * kSumRows, s = blockIdx.y, t = s / B, b = s % B;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rows = min(kSumRows, V - v0);
  const int nchunks = (M + kSumCols - 1) / kSumCols;
  const float sc = epoch_scale(scales, e0 + t);
  const float* Wb = W + epoch_slice(b, WE, e0 + t, (size_t)V * M) + (size_t)v0 * M;
  // Producer: chunk k into stage k % kSumStages, one commit group per
  // chunk (an empty one past the end keeps the group count uniform).
  auto produce = [&](int k) {
    if (k < nchunks) {
      const int m0 = k * kSumCols, cols = min(kSumCols, M - m0);
      float(*dst)[kSumStride] = ring[k % kSumStages];
      if (VEC) {
        constexpr int kQuads = kSumCols / 4;
        for (int i = lane; i < kSumRows * kQuads; i += 32) {
          const int r = i / kQuads, c = (i - r * kQuads) * 4;
          if (r < rows && c < cols) cp_async16(&dst[r][c], Wb + (size_t)r * M + m0 + c);
        }
      } else {
        for (int i = lane; i < kSumRows * kSumCols; i += 32) {
          const int r = i / kSumCols, c = i - r * kSumCols;
          if (r < rows && c < cols) cp_async4(&dst[r][c], Wb + (size_t)r * M + m0 + c);
        }
      }
    }
    cp_async_commit();
  };
  if (warp == 1) {
    for (int k = 0; k < kSumStages - 1; ++k) produce(k);
  }
  float acc = 0.0f;
  for (int k = 0; k < nchunks; ++k) {
    if (warp == 1) cp_async_wait<kSumStages - 2>();  // chunk k has landed
    __syncthreads();
    if (warp == 1) {
      produce(k + kSumStages - 1);
    } else if (lane < rows) {
      const float* row = ring[k % kSumStages][lane];
      const int cols = min(kSumCols, M - k * kSumCols);
      int c = 0;
#pragma unroll 8
      for (; c + 4 <= cols; c += 4) {
        const float4 x = *reinterpret_cast<const float4*>(row + c);
        acc += x.x * sc;
        acc += x.y * sc;
        acc += x.z * sc;
        acc += x.w * sc;
      }
      for (; c < cols; ++c) acc += row[c] * sc;
    }
  }
  if (warp == 0 && lane < rows) den[(size_t)s * V + v0 + lane] = acc + 1e-6f;
}

// Phase 3b: W_n = (W * scale) / den, one block per (slab, validator) row.
__global__ void k_rowdiv(const float* __restrict__ W, const float* __restrict__ scales,
                         const float* __restrict__ den,
                         float* __restrict__ wn, int B, int WE, int e0, int V, int M) {
  yuma::wait_for_prior_grid();
  const size_t row = blockIdx.x;  // s * V + v
  const int s = (int)(row / V), v = (int)(row % V), t = s / B, b = s % B;
  const float sc = epoch_scale(scales, e0 + t);
  const float* src = W + epoch_slice(b, WE, e0 + t, (size_t)V * M) + (size_t)v * M;
  float* dst = wn + row * M;
  const float d = den[row];
  for (int m = threadIdx.x; m < M; m += blockDim.x) dst[m] = (src[m] * sc) / d;
}

// Phase 5: the truncating u16 quantize of c_hi; miners >= m_real are
// excluded (their c_hi counts as 0). The f32 denominator is the exact
// int32 sum of the dyadic grid ints (ops/consensus.py::dyadic_grid_denom)
// while m_real * 2^iters < 2^31, else a plain sum; under rust64 (Yuma 0,
// x64) the divide runs in native f64, as the JAX XLA rung.
__global__ void k_quantize(const float* __restrict__ chi, float* __restrict__ C,
                           float* __restrict__ cons_out, int B, int E, int e0,
                           int M, int m_real, int iters, int fits, int rust64) {
  yuma::wait_for_prior_grid();
  const int s = blockIdx.x, t = s / B, b = s % B;
  const float* ch = chi + (size_t)s * M;
  float* out = C + (size_t)s * M;
  float* cons = cons_out ? cons_out + ((size_t)b * E + e0 + t) * M : nullptr;
  auto c_hi = [&](int m) { return m < m_real ? ch[m] : 0.0f; };
  if (rust64) {
    double acc = 0.0;
    for (int m = threadIdx.x; m < M; m += blockDim.x) acc += (double)c_hi(m);
    const double den = yuma::block_sum(acc);
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
      const double x = (double)c_hi(m) / den * 65535.0;
      const float c = (float)__double2int_rz(x) * yuma::kU16Inv;
      out[m] = c;
      if (cons) cons[m] = c;
    }
    return;
  }
  float den;
  if (fits) {
    const float scale = ldexpf(1.0f, iters);
    int acc = 0;
    for (int m = threadIdx.x; m < M; m += blockDim.x)
      acc += __float2int_rn(c_hi(m) * scale);
    den = __int2float_rn(yuma::block_sum(acc)) * ldexpf(1.0f, -iters);
  } else {  // left to right, as the plain version (beyond the int32 bound)
    __shared__ float tot;
    if (threadIdx.x == 0) {
      float acc = 0.0f;
      for (int m = 0; m < M; ++m) acc += c_hi(m);
      tot = acc;
    }
    __syncthreads();
    den = tot;
  }
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const float x = c_hi(m) / den * 65535.0f;
    const float c = (float)__float2int_rz(x) * yuma::kU16Inv;
    out[m] = c;
    if (cons) cons[m] = c;
  }
}

// The clip base of slab (t, b): this epoch's W_n, or for EMA_PREV by
// clip_src: the scan rule (the carried wprev at the tile's first epoch,
// W_n[t-1] inside the tile, this epoch's at global epoch 0), the given
// wprev, or this epoch's W_n.
__device__ __forceinline__ const float* clip_base(const ScanArgs& a, int t,
                                                  int b, int eg) {
  const size_t vm = (size_t)a.V * a.M;
  const float* own = a.wn + ((size_t)t * a.B + b) * vm;
  if (a.mode != EMA_PREV || a.clip_src == CLIP_OWN) return own;
  if (a.clip_src == CLIP_GIVEN) return a.wprev + (size_t)b * vm;
  if (eg == 0) return own;
  if (t == 0) return a.wprev + (size_t)b * vm;
  return a.wn + ((size_t)(t - 1) * a.B + b) * vm;
}

// Phase 6a: R[m] = sum_v S_n[v] * min(clip_base[v, m], C[m]) into the
// incentive buffer. One block of NW warps per (slab, 32-miner tile), lane
// = miner. The validators are cut into kRankSlices contiguous slices; warp
// w adds slices w, w + NW, ... each in validator order, kRankCache rows
// loaded at once, and warp 0 adds the slice sums in slice order. The order
// depends only on V, never on NW or the tile, so every scan ranks alike
// whichever layout its launch takes.
template <int NW>
__global__ void __launch_bounds__(32 * NW) k_rank(ScanArgs a, int e0) {
  yuma::wait_for_prior_grid();
  static_assert(kRankSlices % NW == 0, "whole slices per warp");
  __shared__ float part[kRankSlices][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s = blockIdx.y, t = s / a.B, b = s % a.B;
  const int m = blockIdx.x * 32 + lane;
  const int mc = m < a.M ? m : a.M - 1;  // a lane past M reads column M - 1
  const int per = (a.V + kRankSlices - 1) / kRankSlices;
  const int eg = e0 + t + a.epoch_offset;
  const float* base = clip_base(a, t, b, eg) + mc;
  const float* sn = a.sn + (size_t)s * a.V;
  const float c = a.C[(size_t)s * a.M + mc];
  for (int q = warp; q < kRankSlices; q += NW) {
    const int v0 = min(a.V, q * per), n = min(a.V, v0 + per) - v0;
    float r = 0.0f;
    for (int i0 = 0; i0 < n; i0 += kRankCache) {
      float x[kRankCache];
#pragma unroll
      for (int j = 0; j < kRankCache; ++j) {
        if (i0 + j < n) x[j] = base[(size_t)(v0 + i0 + j) * a.M];
      }
#pragma unroll
      for (int j = 0; j < kRankCache; ++j) {
        if (i0 + j < n) r += yuma::min_nan(x[j], c) * sn[v0 + i0 + j];
      }
    }
    part[q][lane] = r;
  }
  __syncthreads();
  if (warp == 0 && m < a.M) {
    float tot = 0.0f;
#pragma unroll
    for (int q = 0; q < kRankSlices; ++q) tot += part[q][lane];
    a.inc[(size_t)s * a.M + m] = tot;
  }
}

__device__ __forceinline__ float stat(const int* sel, int i) {
  return (float)sel[i] * yuma::kU16Inv;
}

// jnp.quantile's interpolation as XLA:CPU compiles it in parity mode: in
// float64, the low product fused into the add, rounded once to float32.
__device__ float quant(const LiquidSpec& q, const int* sel, int i) {
  const float v_lo = stat(sel, q.q_lo[i]);
  if (q.q_hi[i] == q.q_lo[i]) return v_lo;
  const double hi = (double)stat(sel, q.q_hi[i]) * q.q_whi[i];
  return (float)__fma_rn((double)v_lo, q.q_wlo[i], hi);
}

// Phase 6b: incentive = nan_to_num(R / sum(R)); with liquid alpha, the
// per-miner EMA rate from the quantized consensus. The quantiles are order
// statistics on the u16 grid, selected by a 16-halving integer counting
// bisection over C_int = round(C * 65535), all ranks jointly
// (pallas_epoch.py::_liquid_rate_on_grid). One block per slab.
__global__ void k_incentive(ScanArgs a, int e0) {
  yuma::wait_for_prior_grid();
  const int s = blockIdx.x, t = s / a.B, b = s % a.B;
  const int M = a.M;
  float* inc = a.inc + (size_t)s * M;
  float acc = 0.0f;
  for (int m = threadIdx.x; m < M; m += blockDim.x) acc += inc[m];
  const float tot = yuma::block_sum(acc);
  float* out = a.inc_out ? a.inc_out + ((size_t)b * a.E + e0 + t) * M : nullptr;
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const float x = yuma::nan_to_num(inc[m] / tot);
    inc[m] = x;
    if (out) out[m] = x;
  }
  if (!a.liquid || a.mode == CAPACITY) return;

  const LiquidSpec& q = a.liq;
  const float* C = a.C + (size_t)s * M;
  int lo[6], hi[6], sel[6];
  for (int k = 0; k < q.K; ++k) {
    lo[k] = 0;
    hi[k] = 65535;
  }
  for (int it = 0; it < 16; ++it) {
    for (int k = 0; k < q.K; ++k) {
      const int mid = (lo[k] + hi[k]) / 2;
      int cnt = 0;
      for (int m = threadIdx.x; m < M; m += blockDim.x)
        cnt += __float2int_rn(C[m] * 65535.0f) <= mid;
      const bool ok = yuma::block_sum(cnt) >= q.thresh[k];
      lo[k] = ok ? lo[k] : mid + 1;
      hi[k] = ok ? mid : hi[k];
    }
  }
  for (int k = 0; k < q.K; ++k) sel[k] = hi[k];

  float c_low, c_high;
  if (q.regime >= 2) {  // both overridden: decided on the host
    c_low = q.ov_low;
    c_high = q.regime == 3 ? quant(q, sel, 2) : q.ov_high;
  } else {
    const float c_high0 = q.has_high ? q.ov_high : quant(q, sel, 0);
    c_low = q.has_low ? q.ov_low : quant(q, sel, 1);
    const bool degenerate = q.regime == 0 ? sel[q.q_hi[0]] == sel[q.q_lo[1]]
                                          : c_high0 == c_low;
    c_high = degenerate ? quant(q, sel, 2) : c_high0;
  }
  const float al = hparam(a, b, ALO), ah = hparam(a, b, AHI);
  const float aa = hparam(a, b, LOGIT_NUM) / (c_low - c_high);
  // The intercept is one FMA, and the exponent -aa * C + bb runs on the
  // grid integers k with the u16 constant folded into the slope, as
  // XLA:CPU compiles the JAX package's fit (ops/liquid.py).
  const float bb = __fmaf_rn(aa, c_low, hparam(a, b, LOGIT_LOW));
  const float slope = -aa * yuma::kU16Inv;
  const float e = 2.71828182845904523536f;
  float* rate = a.rate + (size_t)s * M;
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const float k = (float)__float2int_rn(C[m] * 65535.0f);
    const float sig = 1.0f / (1.0f + powf(e, __fmaf_rn(k, slope, bb)));
    rate[m] = 1.0f - yuma::min_nan(yuma::max_nan(sig, al), ah);
  }
}

// Phase 1: zero scenario b's reset-miner bond column when its rule fires
// (reference simulation_utils.py:62-88): at the reset epoch, from epoch 1
// on, and for CONDITIONAL only if that miner's previous consensus was
// exactly 0. `cp` is the previous epoch's consensus [B, M].
__global__ void k_reset(ScanArgs a, const float* __restrict__ cp, int eg) {
  yuma::wait_for_prior_grid();
  const int b = blockIdx.x;
  const int ri = a.reset_index ? a.reset_index[b] : a.reset_index0;
  const int re = a.reset_epoch ? a.reset_epoch[b] : a.reset_epoch0;
  bool fire = eg == re && eg > 0 && ri >= 0;
  if (a.reset_mode == RESET_CONDITIONAL) {
    const int idx = ri < 0 ? 0 : (ri > a.M - 1 ? a.M - 1 : ri);
    fire = fire && cp[(size_t)b * a.M + idx] == 0.0f;
  }
  if (!fire || ri >= a.M) return;
  for (int v = threadIdx.x; v < a.V; v += blockDim.x)
    a.bonds[((size_t)b * a.V + v) * a.M + ri] = 0.0f;
}

constexpr int kBondProd = kBondWarps * kBondCache * (kBondTM + 1);
struct BondShared {
  float col[kBondWarps][kBondTM];  // per-warp column partials
  union {
    float prod[kBondWarps][kBondCache][kBondTM + 1];  // B_next, for the partials
    float dv[kBondProd];                              // phase 8: D[v], V <= kBondProd
  };
  int last;                        // this block took its group's / scenario's last ticket
  float den;                       // phase 8: the dividend total, summed by one thread
};

// Whether the epoch's dividend total is one chain of FMAs, as the XLA rung
// compiles it where the port follows its chains (ops/normalize.py::
// xla_chains: at most 16 validators, fewer than 16 miners, so one bond
// tile): Yuma 4's of S_n[v] * D[v] over validators, the others' over every
// (validator, miner) product, which phase 7 chains into `a.dtot`. Wider
// epochs take a block sum, and the serial chains stay at most 240 FMAs.
__device__ __forceinline__ bool xla_chains(const ScanArgs& a) {
  return a.V <= 16 && a.M < 16;
}

// Within xla_chains, at 4 or 8 validators XLA holds D in one vector
// register and sums it by halves (ops/normalize.py::fold_sum), not by
// phase 7's chain; at 2 validators the EMA modes' total is D[0] + D[1]
// too (ops/normalize.py::EMA_FOLD_VALIDATORS).
__device__ __forceinline__ bool fold_validators(const ScanArgs& a) {
  return a.V == 4 || a.V == 8 || (a.V == 2 && a.mode <= EMA_PREV);
}

// Sum over the block's warps of one partial per (warp, column), added in
// warp order; every thread must call it.
__device__ __forceinline__ float column_sum(BondShared& sh, int warp, int lane,
                                            float part) {
  __syncthreads();  // the previous call's readers are done
  sh.col[warp][lane] = part;
  __syncthreads();
  float tot = 0.0f;
#pragma unroll
  for (int w = 0; w < kBondWarps; ++w) tot += sh.col[w][lane];
  return tot;
}

// Whether this block is the last of its group of kDnormGroup tiles to
// publish its dividend partials. Every thread must call it: the barrier
// orders the block's writes before thread 0's fence and ticket (the
// pattern of a grid sync), and the acquire fence of the group's last block
// orders the other blocks' writes before its reads.
__device__ __forceinline__ bool take_ticket(int* ticket, int members, BondShared& sh) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    sh.last = atomicAdd(ticket, 1) == members - 1;
    if (sh.last) __threadfence();
  }
  __syncthreads();
  return sh.last;
}

// ops/normalize.py::ema_target_columns: at V = 8 with M <= 8 and a rate
// shared by the miners, XLA:CPU fuses rate * B_t into the EMA's add in these
// columns (four at a time, then the first two of a remainder of three), and
// keep * old everywhere else.
__device__ __forceinline__ bool ema_fuses_target(int V, int M, int m) {
  if (V != 8 || M > 8) return false;
  const int q = M / 4 * 4;
  return m < q || (M - q == 3 && m < q + 2);
}

// Phase 7 for bond model MODE: the bond update of slot t / epoch e of the
// tile for the block's (scenario b, kBondTM-miner tile), old bonds from
// `bin` (a.bonds but at a call's first epoch), new ones to a.bonds; and the
// tile's dividend partials dpart[t & 1, b, tile, v] = sum over the tile's
// miners, in order, of B_next[v, m] * incentive[m]. Warp w owns validators
// [w * per, (w + 1) * per), lane the miner; column sums add each warp's
// slice in validator order, then the warp partials in warp order. With
// `now`, the block takes its group's ticket once its partials are out and
// before it stores its register-cached bonds; returns whether it took the
// group's last one.
template <int MODE>
__device__ __forceinline__ bool bond_tile(const ScanArgs& a, const float* bin, int t,
                                          int e, int eg, int ntiles, bool now,
                                          BondShared& sh) {
  using yuma::max_nan;
  using yuma::min_nan;
  using yuma::nan_to_num;
  constexpr bool kEma = MODE == EMA_RUST || MODE == EMA || MODE == EMA_PREV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = blockIdx.x, b = blockIdx.y;
  const int V = a.V, M = a.M, s = t * a.B + b;
  const int m = tile * kBondTM + lane;
  const bool live = m < M;
  const int mc = live ? m : M - 1;  // a lane past M reads column M - 1, writes nothing
  const int per = (V + kBondWarps - 1) / kBondWarps;
  const int v0 = min(V, warp * per), n = min(V, v0 + per) - v0;
  const size_t vm = (size_t)V * M;
  // The bond target's weights: this epoch's W_n, or EMA_PREV's clip base
  // (which is also its bond base); CAPACITY and RELATIVE read W_n.
  const float* X = clip_base(a, t, b, eg) + mc;
  const float* sn = a.sn + (size_t)s * V;
  float* bc = a.bonds + (size_t)b * vm + mc;
  const float* bo = bin + (size_t)b * vm + mc;
  float* bout = a.bonds_out ? a.bonds_out + ((size_t)b * a.E + e) * vm + mc : nullptr;
  const float c = a.C[(size_t)s * M + mc];
  const float inc = a.inc[(size_t)s * M + mc];
  const bool per_miner = a.liquid && MODE != CAPACITY;  // liquid alpha's rate
  const float rate = per_miner ? a.rate[(size_t)s * M + mc] : hparam(a, b, ALPHA);
  const float keep = 1.0f - rate;
  const bool fuse_target = !per_miner && ema_fuses_target(V, M, mc);
  const bool first = eg == 0;
  const float beta = hparam(a, b, BETA), omb = 1.0f - beta;
  const float omd = 1.0f - hparam(a, b, DECAY), cap_alpha = hparam(a, b, CAP_ALPHA);

  // EMA families: B_t = nan_to_num(S * W_x / colsum), W_x the clipped
  // weights (Yuma 0) or the beta-blend of the bond base and them.
  auto target = [&](int v, float x) {
    const float wc = min_nan(x, c);
    if (MODE == EMA_RUST) return sn[v] * wc;
    return sn[v] * __fmaf_rn(omb, x, beta * wc);  // XLA contracts omb * x
  };
  auto direct = [&](int v, float x, float old) {  // CAPACITY, RELATIVE
    if (MODE == CAPACITY) {
      const float cap = sn[v] * kMaxInt;
      const float remaining = max_nan(cap - old, 0.0f);
      const float purchase = min_nan(cap_alpha * cap, remaining) * x;
      return min_nan(__fmaf_rn(omd, old, purchase), cap);  // as XLA contracts it
    }
    const float dec = old * keep;
    const float remaining = max_nan(1.0f - dec, 0.0f);
    const float purchase = min_nan(rate * x, remaining);
    return min_nan(dec + purchase, 1.0f);
  };

  // Load the slice's first kBondCache validators at once.
  float xr[kBondCache], ob[kBondCache];
#pragma unroll
  for (int i = 0; i < kBondCache; ++i) {
    if (i < n) {
      const size_t o = (size_t)(v0 + i) * M;
      xr[i] = X[o];
      ob[i] = bo[o];
    }
  }
  float den = 0.0f, den2 = 0.0f;
  auto next = [&](float tg, float old) {
    const float bt = nan_to_num(tg / den);
    // XLA's CPU backend contracts one product into the add
    // (ops/normalize.py::ema_blend).
    const float ema =
        fuse_target ? __fmaf_rn(rate, bt, keep * old) : __fmaf_rn(keep, old, rate * bt);
    return first ? bt : ema;  // a select, never a blend
  };
  if (kEma) {
    float col = 0.0f;
#pragma unroll
    for (int i = 0; i < kBondCache; ++i) {
      if (i < n) {
        xr[i] = target(v0 + i, xr[i]);
        col += xr[i];
      }
    }
    for (int i = kBondCache; i < n; ++i) col += target(v0 + i, X[(size_t)(v0 + i) * M]);
    den = column_sum(sh, warp, lane, col);
    if (MODE == EMA_RUST) den = den + 1e-6f;
    float col2 = 0.0f;
#pragma unroll
    for (int i = 0; i < kBondCache; ++i) {
      if (i < n) {
        xr[i] = next(xr[i], ob[i]);
        col2 += xr[i];
      }
    }
    if (MODE == EMA_RUST) {
      for (int i = kBondCache; i < n; ++i) {
        const size_t o = (size_t)(v0 + i) * M;
        col2 += next(target(v0 + i, X[o]), bo[o]);
      }
      den2 = column_sum(sh, warp, lane, col2) + 1e-6f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kBondCache; ++i) {
      if (i < n) xr[i] = direct(v0 + i, xr[i], ob[i]);
    }
  }
  auto finish = [&](float bn) { return MODE == EMA_RUST ? nan_to_num(bn / den2) : bn; };
  // Validators past the register cache: their inputs again from device
  // memory (each is written only below, after its last read).
  auto tail = [&](int i) {
    const int v = v0 + i;
    const size_t o = (size_t)v * M;
    const float x = X[o], old = bo[o];
    return kEma ? finish(next(target(v, x), old)) : direct(v, x, old);
  };

  // The dividend partials, kBondCache validators at a time: lane j of the
  // warp adds validator j's kBondTM products in miner order, each fused
  // into the sum (fmaf, as XLA's reduce of B * incentive). Then each bond
  // is written once (and its saved copy): the register-cached ones after
  // the block has published its partials and taken its ticket, so the
  // ticket waits for the partials alone, not for the bond stores.
  float(*prod)[kBondTM + 1] = sh.prod[warp];
  float* dp = a.dpart + (((size_t)(t & 1) * a.B + b) * ntiles + tile) * V + v0;
  auto store = [&](int i, float bn) {
    if (live) {
      const size_t o = (size_t)(v0 + i) * M;
      bc[o] = bn;
      if (bout) bout[o] = bn;
    }
  };
  const float incl = live ? inc : 0.0f;
  auto flush = [&](int i0, int cnt) {
    __syncwarp();
    const float* row = prod[lane < cnt ? lane : 0];  // every lane shuffles
    float d = 0.0f;
#pragma unroll
    for (int k = 0; k < kBondTM; ++k) {
      d = __fmaf_rn(row[k], __shfl_sync(0xffffffffu, incl, k), d);
    }
    if (lane < cnt) dp[i0 + lane] = d;
    __syncwarp();
  };
#pragma unroll
  for (int i = 0; i < kBondCache; ++i) {
    if (i < n) {
      xr[i] = finish(xr[i]);
      prod[i][lane] = live ? xr[i] : 0.0f;
    }
  }
  flush(0, min(n, kBondCache));
  for (int i0 = kBondCache; i0 < n; i0 += kBondCache) {
    const int cnt = min(kBondCache, n - i0);
    for (int j = 0; j < cnt; ++j) {
      const float bn = tail(i0 + j);
      store(i0 + j, bn);
      prod[j][lane] = live ? bn : 0.0f;
    }
    flush(i0, cnt);
  }
  const int group = tile / kDnormGroup, groups = (ntiles + kDnormGroup - 1) / kDnormGroup;
  const bool last = now && take_ticket(a.ticket + (size_t)b * (groups + 1) + group,
                                        min(kDnormGroup, ntiles - group * kDnormGroup), sh);
#pragma unroll
  for (int i = 0; i < kBondCache; ++i) {
    if (i < n) store(i, xr[i]);
  }
  // The dividend total as one chain of FMAs over (validator, miner), from
  // the bonds this block just stored (xla_chains).
  if (xla_chains(a) && a.mode != RELATIVE && !fold_validators(a)) {
    __syncthreads();
    if (threadIdx.x == 0) {
      const float* bb = a.bonds + (size_t)b * vm;
      const float* ii = a.inc + (size_t)s * M;
      float acc = 0.0f;
      for (int v = 0; v < V; ++v) {
        for (int k = 0; k < M; ++k) acc = __fmaf_rn(bb[(size_t)v * M + k], ii[k], acc);
      }
      a.dtot[(size_t)(t & 1) * a.B + b] = acc;
    }
  }
  return last;
}

// Phase 8. D[v] = the sum of validator v's dividend partials (times
// S_n[v] for RELATIVE), then D_n = D / (sum(D) + 1e-6), stored per epoch
// and/or added to the running epoch sum (epoch order, float32). The
// partials are added in groups of kDnormGroup tiles, each in tile order,
// then the group sums in group order, whichever block adds them. Partials
// written by other blocks of the same launch are read through L2
// (ld.global.cg), never from this SM's L1.

// n values at stride `stride` from p, added in order, loaded all at once.
__device__ __forceinline__ float sum_in_order(const float* p, size_t stride, int n) {
  float y[kDnormGroup];
#pragma unroll
  for (int j = 0; j < kDnormGroup; ++j) {
    if (j < n) y[j] = __ldcg(p + (size_t)j * stride);
  }
  float x = 0.0f;
#pragma unroll
  for (int j = 0; j < kDnormGroup; ++j) {
    if (j < n) x += y[j];
  }
  return x;
}

// The dividend partials of slot t of the tile, scenario b.
__device__ __forceinline__ const float* partials(const ScanArgs& a, int t, int b,
                                                 int ntiles) {
  return a.dpart + ((size_t)(t & 1) * a.B + b) * ntiles * a.V;
}

// Group g's sum of validator v's partials.
__device__ __forceinline__ float group_sum(const float* dp, int V, int v, int g,
                                           int ntiles) {
  const int k0 = g * kDnormGroup;
  return sum_in_order(dp + (size_t)k0 * V + v, V, min(kDnormGroup, ntiles - k0));
}

// D_n of scenario b = blockIdx.y at slot t / epoch e from each validator's
// D before the stake factor, dof(v). Every thread of the block calls it.
// The total: where xla_chains, Yuma 4's is a chain of FMAs of S_n[v] * D[v]
// in validator order and the others' is phase 7's (where fold_validators,
// D's halves added lane by lane); else a block sum.
template <class DOf>
__device__ __forceinline__ void normalize_dividends(const ScanArgs& a, int t, int e,
                                                    BondShared& sh, DOf dof) {
  const int b = blockIdx.y, s = t * a.B + b, V = a.V;
  const bool rel = a.mode == RELATIVE;
  const float* sn = a.sn + (size_t)s * V;
  float* d = V <= kBondProd ? sh.dv : a.dsum + (size_t)b * V;
  float acc = 0.0f;
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    const float x = dof(v);
    d[v] = x;
    acc += rel ? sn[v] * x : x;
  }
  float den;
  if (!xla_chains(a)) {
    den = yuma::block_sum(acc) + 1e-6f;
  } else if (rel) {
    __syncthreads();
    if (threadIdx.x == 0) {
      float tot = 0.0f;
      for (int v = 0; v < V; ++v) tot = __fmaf_rn(sn[v], d[v], tot);
      sh.den = tot;
    }
    __syncthreads();
    den = sh.den + 1e-6f;
  } else if (fold_validators(a)) {
    __syncthreads();
    if (threadIdx.x == 0) {  // the halves added lane by lane, written out
      sh.den = V == 2   ? d[0] + d[1]
               : V == 4 ? (d[0] + d[2]) + (d[1] + d[3])
                        : ((d[0] + d[4]) + (d[2] + d[6])) + ((d[1] + d[5]) + (d[3] + d[7]));
    }
    __syncthreads();
    den = sh.den + 1e-6f;
  } else {
    den = __ldcg(a.dtot + (size_t)(t & 1) * a.B + b) + 1e-6f;
  }
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    const float x = (rel ? sn[v] * d[v] : d[v]) / den;
    if (a.dn) a.dn[((size_t)b * a.E + e) * V + v] = x;
    if (a.dacc) a.dacc[(size_t)b * V + v] += x;
  }
}

// Phase 8 of slot t / epoch e in one block, from the partials alone: the
// group sums one after another.
__device__ __forceinline__ void dividends_alone(const ScanArgs& a, int t, int e,
                                                int ntiles, BondShared& sh) {
  const int groups = (ntiles + kDnormGroup - 1) / kDnormGroup;
  const float* dp = partials(a, t, blockIdx.y, ntiles);
  normalize_dividends(a, t, e, sh, [&](int v) {
    float x = 0.0f;
    for (int g0 = 0; g0 < groups; g0 += kDnormGroup) {
      float z = 0.0f;
      for (int g = g0; g < min(groups, g0 + kDnormGroup); ++g) {
        z += group_sum(dp, a.V, v, g, ntiles);
      }
      x += z;
    }
    return x;
  });
}

// Phase 8 of slot t / epoch e by the blocks that finish last, the same
// sums split in two levels: the last block of its group of tiles sums the
// group's partials and takes a ticket of the scenario; the last group
// adds the group sums, after phase 8 of the slot before (`prev`: its
// dividends go first into the running sum), and resets the tickets.
__device__ __forceinline__ void dividends_last(const ScanArgs& a, int t, int e,
                                               int ntiles, bool prev, BondShared& sh) {
  const int b = blockIdx.y, V = a.V;
  const int groups = (ntiles + kDnormGroup - 1) / kDnormGroup, g = blockIdx.x / kDnormGroup;
  const float* dp = partials(a, t, b, ntiles);
  float* dg = a.dgroup + (size_t)b * groups * V;
  int* ticket = a.ticket + (size_t)b * (groups + 1);
  for (int v = threadIdx.x; v < V; v += blockDim.x) dg[(size_t)g * V + v] = group_sum(dp, V, v, g, ntiles);
  if (!take_ticket(ticket + groups, groups, sh)) return;
  if (prev) dividends_alone(a, t - 1, e - 1, ntiles, sh);
  normalize_dividends(a, t, e, sh, [&](int v) {
    float x = 0.0f;
    for (int g0 = 0; g0 < groups; g0 += kDnormGroup) {
      x += sum_in_order(dg + (size_t)g0 * V + v, V, min(kDnormGroup, groups - g0));
    }
    return x;
  });
  for (int i = threadIdx.x; i <= groups; i += blockDim.x) ticket[i] = 0;
}

// Phases 7 and 8 of epoch e, slot t of its tile. Grid (ntiles [+ 1], B).
// Where phase 8 runs (`phase8`): kPhase8Now, this epoch's in the blocks
// that finish last (a tile's last epoch: the next launch may overwrite its
// stakes and partials); kPhase8PrevExtra, the previous slot's in one extra
// block (blockIdx.x == ntiles) beside the bond blocks, where it costs no
// time of its own; kPhase8PrevLast, the previous slot's in the blocks that
// finish last, first (so that the running sum adds the epochs in order).
constexpr int kPhase8Now = 1, kPhase8PrevExtra = 2, kPhase8PrevLast = 4;
__global__ void __launch_bounds__(kBondThreads) k_bond(ScanArgs a, const float* bin,
                                                       int t, int e, int eg, int ntiles,
                                                       int phase8) {
  yuma::wait_for_prior_grid();
  __shared__ BondShared sh;
  const bool now = phase8 & kPhase8Now, prev = phase8 & kPhase8PrevLast;
  if (blockIdx.x == ntiles) {
    dividends_alone(a, t - 1, e - 1, ntiles, sh);
    return;
  }
  bool last;
  switch (a.mode) {
    case EMA_RUST: last = bond_tile<EMA_RUST>(a, bin, t, e, eg, ntiles, now, sh); break;
    case EMA: last = bond_tile<EMA>(a, bin, t, e, eg, ntiles, now, sh); break;
    case EMA_PREV: last = bond_tile<EMA_PREV>(a, bin, t, e, eg, ntiles, now, sh); break;
    case CAPACITY: last = bond_tile<CAPACITY>(a, bin, t, e, eg, ntiles, now, sh); break;
    default: last = bond_tile<RELATIVE>(a, bin, t, e, eg, ntiles, now, sh); break;
  }
  if (last) dividends_last(a, t, e, ntiles, prev, sh);
}

// Launch a phase kernel (yuma::launch_kernel); return its error.
#define LAUNCH(...)                                     \
  do {                                                  \
    cudaError_t err_ = yuma::launch_kernel(__VA_ARGS__); \
    if (err_ != cudaSuccess) return (int)err_;          \
  } while (0)

// Row-normalize the `nslab` slabs of epochs e0 .. e0 + nslab/B - 1 into
// `out` [nslab, V, M], with `den` [nslab, V] scratch.
int normalize_rows(const ScanArgs& a, int e0, int nslab, float* den, float* out,
                   cudaStream_t st) {
  const dim3 grid((a.V + kSumRows - 1) / kSumRows, nslab);
  const bool vec = a.M % 4 == 0 && reinterpret_cast<uintptr_t>(a.W) % 16 == 0;
  LAUNCH(vec ? k_rowsum<true> : k_rowsum<false>, grid, 64, st, a.W, a.scales, den,
         a.B, a.w_epochs, e0, a.V, a.M);
  LAUNCH(k_rowdiv, nslab * a.V, 256, st, a.W, a.scales, den, out, a.B,
         a.w_epochs, e0, a.V, a.M);
  return 0;
}

// The whole scan: phases 2-6 once per tile of up to T epochs (the last
// tile takes what is left), then phases 1, 7 and 8 epoch by epoch.
int run_scan(const ScanArgs& args, int T) {
  ScanArgs a = args;
  cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  const int B = a.B, V = a.V, M = a.M;
  if (T < 1 || a.E < 1 || B < 1 || !a.ticket) return (int)cudaErrorInvalidValue;
  const int fits = ((long long)a.m_real << a.iters) < (1LL << 31);
  const size_t bm = (size_t)B * M, bvm = (size_t)B * V * M;
  const int rank_tiles = (M + 31) / 32;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return (int)err;
  const int bond_tiles = (M + kBondTM - 1) / kBondTM;
  const bool scan_prev = a.mode == EMA_PREV && a.clip_src == CLIP_SCAN;
  const int dgroups = (bond_tiles + kDnormGroup - 1) / kDnormGroup;
  err = cudaMemsetAsync(a.ticket, 0, (size_t)B * (dgroups + 1) * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  // A reset may zero a column of the bonds before epoch 0's update: start
  // from a copy of bonds_in then.
  if (a.bonds_in && a.reset_mode != RESET_NONE) {
    err = cudaMemcpyAsync(a.bonds, a.bonds_in, bvm * sizeof(float),
                          cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return (int)err;
    a.bonds_in = nullptr;
  }
  for (int e0 = 0; e0 < a.E; e0 += T) {
    const int tt = std::min(T, a.E - e0), nslab = tt * B;
    int rc;
    // EMA_PREV, recompute spelling: the previous epoch's W_n re-derived
    // from its weights (the same ops as its own phase 3), not carried.
    if (scan_prev && a.recompute_prev && e0 > 0) {
      if ((rc = normalize_rows(a, e0 - 1, B, a.pden, a.wprev, st))) return rc;
    }
    // Phases 2-6, once for the whole tile.
    LAUNCH(k_stake, nslab, 256, st, a.S, a.sn, a.sint, B, a.s_epochs, e0, V,
           a.s_normalized);
    if ((rc = normalize_rows(a, e0, nslab, a.rden, a.wn, st))) return rc;
    yuma::BisectArgs ba{};
    ba.wn = a.wn;
    ba.sint = a.sint;
    ba.sn = a.sn;
    ba.kappa = a.hp ? a.hp + KAPPA : nullptr;
    ba.kappa0 = a.hpv[KAPPA];
    ba.kappa_stride = NHP;
    ba.B = B;
    ba.chi = a.chi;
    ba.nslab = nslab;
    ba.V = V;
    ba.M = M;
    ba.iters = a.iters;
    err = yuma::launch_bisect(ba, st, a.mxu);
    if (err != cudaSuccess) return (int)err;
    LAUNCH(k_quantize, nslab, 1024, st, a.chi, a.C, a.cons_out, B, a.E, e0, M, a.m_real,
           a.iters, fits, a.rust64);
    const dim3 rank_grid(rank_tiles, nslab);
    if ((long long)rank_tiles * nslab < (long long)kRankBlocksPerSM * sms) {
      LAUNCH(k_rank<kRankWarpsFew>, rank_grid, 32 * kRankWarpsFew, st, a, e0);
    } else {
      LAUNCH(k_rank<kRankWarpsMany>, rank_grid, 32 * kRankWarpsMany, st, a, e0);
    }
    LAUNCH(k_incentive, nslab, 1024, st, a, e0);
    // Phases 1, 7, 8, epoch by epoch.
    for (int t = 0; t < tt; ++t) {
      const int e = e0 + t, eg = e + a.epoch_offset;
      if (a.reset_mode != RESET_NONE) {
        const float* cp = t == 0 ? a.cprev : a.C + (size_t)(t - 1) * bm;
        LAUNCH(k_reset, B, 256, st, a, cp, eg);
      }
      const float* bin = e == 0 && a.bonds_in ? a.bonds_in : a.bonds;
      // Phase 8 of slot t runs in the next launch's extra block, but that
      // of the tile's last slot, which runs here; with a running sum (or D
      // in dsum, V > kBondProd), after the slot before, in the same block.
      int phase8 = t == tt - 1 ? kPhase8Now : 0;
      const bool in_order = a.dacc || V > kBondProd;
      if (t > 0) phase8 |= phase8 && in_order ? kPhase8PrevLast : kPhase8PrevExtra;
      const dim3 grid(bond_tiles + (phase8 & kPhase8PrevExtra ? 1 : 0), B);
      LAUNCH(k_bond, grid, kBondThreads, st, a, bin, t, e, eg, bond_tiles, phase8);
    }
    // Carry the tile's last consensus (and W_n) into the next tile.
    if (a.cprev) {
      err = cudaMemcpyAsync(a.cprev, a.C + (size_t)(tt - 1) * bm, bm * sizeof(float),
                            cudaMemcpyDeviceToDevice, st);
      if (err != cudaSuccess) return (int)err;
    }
    if (scan_prev && !a.recompute_prev) {
      err = cudaMemcpyAsync(a.wprev, a.wn + (size_t)(tt - 1) * bvm,
                            bvm * sizeof(float), cudaMemcpyDeviceToDevice, st);
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace
