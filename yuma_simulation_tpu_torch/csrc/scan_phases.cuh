// The phase kernels of the port's epoch scans and the host loop that
// launches them (run_scan). Included by case_scan.cu (K2, K3) and
// ema_scan.cu (K5, K6), which differ only in what they feed run_scan.
//
// The epoch is split into phase kernels, each sized to its own
// parallelism, launched on one stream by a host loop with no Python per
// epoch:
//   1 reset injection           one block per scenario
//   2 stake normalization       one block per (epoch, scenario)
//   3 row normalization         sums: one block per (epoch, scenario, 8
//                               rows); divide: one block per row
//   4 bisection (K1's body, or  one block of 4 warps per (epoch, scenario,
//     K4's with mxu)            32 miners), W_n held in registers
//                               (common.cuh)
//   5 quantize denominator      one block per (epoch, scenario), int32 sum
//   6 clip / rank, incentive,   one thread per miner column; one block
//     liquid counting bisection per (epoch, scenario)
//   7 bond update and the       one block of 32 warps per (scenario, 32
//     dividend partials         miners), a validator slice per warp
//   8 dividend normalization    one block per scenario
// Phases 2-6 run once per T-epoch tile with the tile as a grid dimension
// (T = 1 is one epoch per step), then phases 1, 7 and 8 T times in order.
//
// What bounds phases 3 and 7, and what their design does about it:
// - Phase 3's row sum feeds the consensus, so each row is one chain of M
//   dependent float32 adds (~8-9 us at M = 4096): no tree, no split. The
//   floor is that chain, run for every row of the launch at once, so
//   k_rowsum gives each row its own adding lane, only 8 rows per block
//   (K2's and K6's 256 rows per epoch spread over 32 blocks), and keeps
//   the adder off device memory: the block's producer warp fills a
//   4-stage ring of 256-column chunks in shared memory with 16-byte
//   cp.async copies, and the adder reads one float4 per four in-order
//   adds. K3 and K5 run 16 epochs' rows per launch and pay the chain once
//   per tile; K2 and K6 pay it every epoch, at about twice the chain
//   (PERF.md).
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
//   256 x 4096) and normalizes V values: its time is about one small
//   launch. k_dnorm sums each validator's partials in contiguous tile
//   groups, one thread per group, so its loads are not one serial chain.
//
// What the scans take: W [B, EW, V, M] and S [B, ES, V] with EW, ES the
// epochs stored (E, or 1 for epoch-constant inputs); an optional per-epoch
// weight scale (epoch e reads W * scales[e], before the row sum); stakes
// raw (normalized in phase 2) or already normalized; per-epoch outputs
// each optional, and an optional in-kernel f32 sum of D_n over epochs.
//
// Numerics: the row and stake sums add strictly left to right, as the
// plain PyTorch version does (and XLA's CPU backend for short rows), so the
// consensus, which depends only on W_n and the fixed-point stakes, is
// bitwise the plain version's on any device. Every other float reduction
// runs in a fixed order with no float atomics, so a run is reproducible
// bit for bit. Built with --fmad=false: no multiply-add is contracted,
// each operation rounds as the plain version's does.
//
// The bond state lives in one device buffer [B, V, M] that the bond phase
// updates in place (each thread owns one column of one validator slice);
// the carry buffers
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

}  // namespace

// The static liquid-alpha selection (ops/cuda_epoch.py::_liquid_spec):
// the ranks the 0.75 / 0.25 / 0.99 quantiles need and how to combine them.
struct LiquidSpec {
  int K;              // number of ranks selected jointly (<= 6)
  int thresh[6];      // rank + 1 per selected rank
  int q_lo[3];        // per quantile (0.75, 0.25, 0.99): index of the floor
  int q_hi[3];        // and ceil order statistic in the rank list, -1 unused
  float q_wlo[3];     // float32(1 - frac)
  float q_whi[3];     // float32(frac)
  int regime;         // 0 no override, 1 one override, 2 both, 3 both equal
  int has_high, has_low;
  float ov_high, ov_low;
};

struct ScanArgs {
  const float* W;        // [B, w_epochs, V, M] raw weights
  const float* S;        // [B, s_epochs, V] stakes (raw or normalized)
  const float* hp;       // [B, NHP] hyperparameters
  const int* reset_index;  // [B]
  const int* reset_epoch;  // [B]
  float* bonds;          // [B, V, M] bond state, in/out (carry)
  float* cprev;          // [B, M] previous consensus, in/out (carry)
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
  float* dpart;          // [B, ceil(M / kBondTM), V] scratch: dividend partials
  float* rden;           // [T, B, V] scratch: row denominators
  float* pden;           // [B, V] scratch: recomputed previous row denominators
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
  LiquidSpec liq;
};

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

// Phase 2: S_n = S / sum(S) (or S as given) and the fixed-point stakes.
// One block per slab s = t * B + b. The sum feeds the consensus, so it
// adds left to right (ops/normalize.py::sequential_sum), in one thread:
// V is small.
__global__ void k_stake(const float* __restrict__ S, float* __restrict__ sn,
                        int* __restrict__ sint, int B, int SE, int e0, int V,
                        int normalized) {
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
                                               float* __restrict__ den, int B,
                                               int WE, int e0, int V, int M) {
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
                         const float* __restrict__ den, float* __restrict__ wn,
                         int B, int WE, int e0, int V, int M) {
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

// Phase 6a: R[m] = sum_v S_n[v] * min(clip_base[v, m], C[m]), one thread
// per miner column, validators in order. R goes to the incentive buffer.
__global__ void k_rank(ScanArgs a, int e0) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y, t = s / a.B, b = s % a.B;
  if (m >= a.M) return;
  const int eg = e0 + t + a.epoch_offset;
  const float* base = clip_base(a, t, b, eg);
  const float* sn = a.sn + (size_t)s * a.V;
  const float c = a.C[(size_t)s * a.M + m];
  float r = 0.0f;
#pragma unroll 8
  for (int v = 0; v < a.V; ++v)
    r += yuma::min_nan(base[(size_t)v * a.M + m], c) * sn[v];
  a.inc[(size_t)s * a.M + m] = r;
}

__device__ __forceinline__ float stat(const int* sel, int i) {
  return (float)sel[i] * yuma::kU16Inv;
}

__device__ float quant(const LiquidSpec& q, const int* sel, int i) {
  const float v_lo = stat(sel, q.q_lo[i]);
  if (q.q_hi[i] == q.q_lo[i]) return v_lo;
  return v_lo * q.q_wlo[i] + stat(sel, q.q_hi[i]) * q.q_whi[i];
}

// Phase 6b: incentive = nan_to_num(R / sum(R)); with liquid alpha, the
// per-miner EMA rate from the quantized consensus. The quantiles are order
// statistics on the u16 grid, selected by a 16-halving integer counting
// bisection over C_int = round(C * 65535), all ranks jointly
// (pallas_epoch.py::_liquid_rate_on_grid). One block per slab.
__global__ void k_incentive(ScanArgs a, int e0) {
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
  const float* hp = a.hp + (size_t)b * NHP;
  const float al = hp[ALO], ah = hp[AHI];
  const float aa = hp[LOGIT_NUM] / (c_low - c_high);
  const float bb = hp[LOGIT_LOW] + aa * c_low;
  const float e = 2.71828182845904523536f;
  float* rate = a.rate + (size_t)s * M;
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const float sig = 1.0f / (1.0f + powf(e, -aa * C[m] + bb));
    rate[m] = 1.0f - yuma::min_nan(yuma::max_nan(sig, al), ah);
  }
}

// Phase 1: zero scenario b's reset-miner bond column when its rule fires
// (reference simulation_utils.py:62-88): at the reset epoch, from epoch 1
// on, and for CONDITIONAL only if that miner's previous consensus was
// exactly 0. `cp` is the previous epoch's consensus [B, M].
__global__ void k_reset(ScanArgs a, const float* __restrict__ cp, int eg) {
  const int b = blockIdx.x;
  const int ri = a.reset_index[b];
  bool fire = eg == a.reset_epoch[b] && eg > 0 && ri >= 0;
  if (a.reset_mode == RESET_CONDITIONAL) {
    const int idx = ri < 0 ? 0 : (ri > a.M - 1 ? a.M - 1 : ri);
    fire = fire && cp[(size_t)b * a.M + idx] == 0.0f;
  }
  if (!fire || ri >= a.M) return;
  for (int v = threadIdx.x; v < a.V; v += blockDim.x)
    a.bonds[((size_t)b * a.V + v) * a.M + ri] = 0.0f;
}

struct BondShared {
  float col[kBondWarps][kBondTM];               // per-warp column partials
  float prod[kBondWarps][kBondCache][kBondTM + 1];  // B_next * incentive
};

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

// Phase 7 for bond model MODE: the bond update of epoch t of the tile, in
// place, for the block's (scenario b, kBondTM-miner tile), and the tile's
// dividend partials dpart[b, tile, v] = sum over the tile's miners, in
// order, of B_next[v, m] * incentive[m]. Warp w owns validators [w * per,
// (w + 1) * per), lane the miner; column sums add each warp's slice in
// validator order, then the warp partials in warp order.
template <int MODE>
__device__ __forceinline__ void bond_tile(const ScanArgs& a, int t, int e, int eg,
                                          BondShared& sh) {
  using yuma::max_nan;
  using yuma::min_nan;
  using yuma::nan_to_num;
  constexpr bool kEma = MODE == EMA_RUST || MODE == EMA || MODE == EMA_PREV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = blockIdx.x, ntiles = gridDim.x, b = blockIdx.y;
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
  float* bout = a.bonds_out ? a.bonds_out + ((size_t)b * a.E + e) * vm + mc : nullptr;
  const float* hp = a.hp + (size_t)b * NHP;
  const float c = a.C[(size_t)s * M + mc];
  const float inc = a.inc[(size_t)s * M + mc];
  const float rate =
      (a.liquid && MODE != CAPACITY) ? a.rate[(size_t)s * M + mc] : hp[ALPHA];
  const float keep = 1.0f - rate;
  const bool first = eg == 0;
  const float beta = hp[BETA], omb = 1.0f - beta;
  const float omd = 1.0f - hp[DECAY], cap_alpha = hp[CAP_ALPHA];

  // EMA families: B_t = nan_to_num(S * W_x / colsum), W_x the clipped
  // weights (Yuma 0) or the beta-blend of the bond base and them.
  auto target = [&](int v, float x) {
    const float wc = min_nan(x, c);
    if (MODE == EMA_RUST) return sn[v] * wc;
    return sn[v] * (omb * x + beta * wc);
  };
  auto direct = [&](int v, float x, float old) {  // CAPACITY, RELATIVE
    if (MODE == CAPACITY) {
      const float cap = sn[v] * kMaxInt;
      const float remaining = max_nan(cap - old, 0.0f);
      const float purchase = min_nan(cap_alpha * cap, remaining) * x;
      return min_nan(omd * old + purchase, cap);
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
      ob[i] = bc[o];
    }
  }
  float den = 0.0f, den2 = 0.0f;
  auto next = [&](float tg, float old) {
    const float bt = nan_to_num(tg / den);
    const float ema = rate * bt + keep * old;
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
        col2 += next(target(v0 + i, X[o]), bc[o]);
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
    const float x = X[o], old = bc[o];
    return kEma ? finish(next(target(v, x), old)) : direct(v, x, old);
  };

  // Write each bond once (and its saved copy), and the dividend partials,
  // kBondCache validators at a time: lane j of the warp adds validator
  // j's kBondTM products in miner order.
  float(*prod)[kBondTM + 1] = sh.prod[warp];
  float* dp = a.dpart + ((size_t)b * ntiles + tile) * V + v0;
  auto put = [&](int j, int i, float bn) {
    if (live) {
      const size_t o = (size_t)(v0 + i) * M;
      bc[o] = bn;
      if (bout) bout[o] = bn;
    }
    prod[j][lane] = live ? bn * inc : 0.0f;
  };
  auto flush = [&](int i0, int cnt) {
    __syncwarp();
    if (lane < cnt) {
      float d = 0.0f;
#pragma unroll
      for (int k = 0; k < kBondTM; ++k) d += prod[lane][k];
      dp[i0 + lane] = d;
    }
    __syncwarp();
  };
#pragma unroll
  for (int i = 0; i < kBondCache; ++i) {
    if (i < n) put(i, i, finish(xr[i]));
  }
  flush(0, min(n, kBondCache));
  for (int i0 = kBondCache; i0 < n; i0 += kBondCache) {
    const int cnt = min(kBondCache, n - i0);
    for (int j = 0; j < cnt; ++j) put(j, i0 + j, tail(i0 + j));
    flush(i0, cnt);
  }
}

__global__ void __launch_bounds__(kBondThreads) k_bond(ScanArgs a, int t, int e, int eg) {
  __shared__ BondShared sh;
  switch (a.mode) {
    case EMA_RUST: bond_tile<EMA_RUST>(a, t, e, eg, sh); break;
    case EMA: bond_tile<EMA>(a, t, e, eg, sh); break;
    case EMA_PREV: bond_tile<EMA_PREV>(a, t, e, eg, sh); break;
    case CAPACITY: bond_tile<CAPACITY>(a, t, e, eg, sh); break;
    default: bond_tile<RELATIVE>(a, t, e, eg, sh); break;
  }
}

// Phase 8: D[v] = the sum of validator v's `ntiles` dividend partials
// (times S_n[v] for RELATIVE), then D_n = D / (sum(D) + 1e-6), one block
// of kDnormThreads per scenario; stored per epoch and/or added to the
// running epoch sum (epoch order, float32). While V <= kDnormThreads / 2,
// each validator's tiles are cut into G contiguous groups, one thread each
// (neighbouring threads on neighbouring validators), each group summed in
// tile order and the G group sums added in group order.
constexpr int kDnormThreads = 1024;
__global__ void __launch_bounds__(kDnormThreads) k_dnorm(ScanArgs a, int t, int e,
                                                         int ntiles) {
  __shared__ float part[kDnormThreads];
  const int b = blockIdx.x, s = t * a.B + b, V = a.V;
  const float* dp = a.dpart + (size_t)b * ntiles * V;
  float* d = a.dsum + (size_t)b * V;
  const int G = max(1, min(ntiles, kDnormThreads / V));
  const int per = (ntiles + G - 1) / G;
  auto tiles = [&](int v, int k0, int k1) {
    float x = 0.0f;
#pragma unroll 8
    for (int k = k0; k < k1; ++k) x += dp[(size_t)k * V + v];
    return x;
  };
  if (G > 1) {
    const int g = threadIdx.x / V, v = threadIdx.x - g * V;
    if (g < G) part[threadIdx.x] = tiles(v, min(ntiles, g * per), min(ntiles, (g + 1) * per));
    __syncthreads();
  }
  float acc = 0.0f;
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    float x = 0.0f;
    if (G > 1) {
      for (int g = 0; g < G; ++g) x += part[g * V + v];
    } else {
      x = tiles(v, 0, ntiles);
    }
    if (a.mode == RELATIVE) x = a.sn[(size_t)s * V + v] * x;
    d[v] = x;
    acc += x;
  }
  const float den = yuma::block_sum(acc) + 1e-6f;
  for (int v = threadIdx.x; v < a.V; v += blockDim.x) {
    const float x = d[v] / den;
    if (a.dn) a.dn[((size_t)b * a.E + e) * a.V + v] = x;
    if (a.dacc) a.dacc[(size_t)b * a.V + v] += x;
  }
}

#define CHECK_LAUNCH()                              \
  do {                                              \
    cudaError_t err_ = cudaGetLastError();          \
    if (err_ != cudaSuccess) return (int)err_;      \
  } while (0)

// Row-normalize the `nslab` slabs of epochs e0 .. e0 + nslab/B - 1 into
// `out` [nslab, V, M], with `den` [nslab, V] scratch.
int normalize_rows(const ScanArgs& a, int e0, int nslab, float* den, float* out,
                   cudaStream_t st) {
  const dim3 grid((a.V + kSumRows - 1) / kSumRows, nslab);
  const bool vec = a.M % 4 == 0 && reinterpret_cast<uintptr_t>(a.W) % 16 == 0;
  if (vec) {
    k_rowsum<true><<<grid, 64, 0, st>>>(a.W, a.scales, den, a.B, a.w_epochs, e0, a.V, a.M);
  } else {
    k_rowsum<false><<<grid, 64, 0, st>>>(a.W, a.scales, den, a.B, a.w_epochs, e0, a.V, a.M);
  }
  CHECK_LAUNCH();
  k_rowdiv<<<nslab * a.V, 256, 0, st>>>(a.W, a.scales, den, out, a.B, a.w_epochs,
                                        e0, a.V, a.M);
  CHECK_LAUNCH();
  return 0;
}

int run_scan(const ScanArgs& a, int T) {
  cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  const int B = a.B, V = a.V, M = a.M;
  const int fits = ((long long)a.m_real << a.iters) < (1LL << 31);
  const size_t bm = (size_t)B * M, bvm = (size_t)B * V * M;
  const int col_blocks = (M + 127) / 128;
  const int bond_tiles = (M + kBondTM - 1) / kBondTM;
  const bool scan_prev = a.mode == EMA_PREV && a.clip_src == CLIP_SCAN;
  for (int e0 = 0; e0 < a.E; e0 += T) {
    const int nslab = T * B;
    int rc;
    // EMA_PREV, recompute spelling: the previous epoch's W_n re-derived
    // from its weights (the same ops as its own phase 3), not carried.
    if (scan_prev && a.recompute_prev && e0 > 0) {
      if ((rc = normalize_rows(a, e0 - 1, B, a.pden, a.wprev, st))) return rc;
    }
    // Phases 2-6, once for the whole tile.
    k_stake<<<nslab, 256, 0, st>>>(a.S, a.sn, a.sint, B, a.s_epochs, e0, V,
                                   a.s_normalized);
    CHECK_LAUNCH();
    if ((rc = normalize_rows(a, e0, nslab, a.rden, a.wn, st))) return rc;
    yuma::BisectArgs ba{};
    ba.wn = a.wn;
    ba.sint = a.sint;
    ba.kappa = a.hp + KAPPA;
    ba.kappa_stride = NHP;
    ba.B = B;
    ba.chi = a.chi;
    ba.nslab = nslab;
    ba.V = V;
    ba.M = M;
    ba.iters = a.iters;
    cudaError_t err = yuma::launch_bisect(ba, st, a.mxu);
    if (err != cudaSuccess) return (int)err;
    k_quantize<<<nslab, 1024, 0, st>>>(a.chi, a.C, a.cons_out, B, a.E, e0, M,
                                       a.m_real, a.iters, fits, a.rust64);
    CHECK_LAUNCH();
    k_rank<<<dim3(col_blocks, nslab), 128, 0, st>>>(a, e0);
    CHECK_LAUNCH();
    k_incentive<<<nslab, 1024, 0, st>>>(a, e0);
    CHECK_LAUNCH();
    // Phases 1, 7, 8, epoch by epoch.
    for (int t = 0; t < T; ++t) {
      const int e = e0 + t, eg = e + a.epoch_offset;
      if (a.reset_mode != RESET_NONE) {
        const float* cp = t == 0 ? a.cprev : a.C + (size_t)(t - 1) * bm;
        k_reset<<<B, 256, 0, st>>>(a, cp, eg);
        CHECK_LAUNCH();
      }
      k_bond<<<dim3(bond_tiles, B), kBondThreads, 0, st>>>(a, t, e, eg);
      CHECK_LAUNCH();
      k_dnorm<<<B, kDnormThreads, 0, st>>>(a, t, e, bond_tiles);
      CHECK_LAUNCH();
    }
    // Carry the tile's last consensus (and W_n) into the next tile.
    err = cudaMemcpyAsync(a.cprev, a.C + (size_t)(T - 1) * bm,
                          bm * sizeof(float), cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return (int)err;
    if (scan_prev && !a.recompute_prev) {
      err = cudaMemcpyAsync(a.wprev, a.wn + (size_t)(T - 1) * bvm,
                            bvm * sizeof(float), cudaMemcpyDeviceToDevice, st);
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace
