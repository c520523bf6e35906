// The phase kernels of the port's epoch scans and the host loop that
// launches them (run_scan). Included by case_scan.cu (K2, K3) and
// ema_scan.cu (K5, K6), which differ only in what they feed run_scan.
//
// The epoch is split into phase kernels, each sized to its own
// parallelism, launched on one stream by a host loop with no Python per
// epoch:
//   1 reset injection           one block per scenario
//   2 stake normalization       one block per (epoch, scenario)
//   3 row normalization         sums: one block per (epoch, scenario, 32
//                               rows); divide: one block per row
//   4 bisection (K1's body, or  one block per (epoch, scenario, 128 miners),
//     K4's with mxu)            the W_n tile staged in shared memory
//   5 quantize denominator      one block per (epoch, scenario), int32 sum
//   6 clip / rank, incentive,   one thread per miner column; one block
//     liquid counting bisection per (epoch, scenario)
//   7 bond update               one thread per (scenario, miner) column
//   8 dividends, normalization  one block per (scenario, validator)
// Phases 2-6 run once per T-epoch tile with the tile as a grid dimension
// (T = 1 is one epoch per step), then phases 1, 7 and 8 T times in order.
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
// updates in place (each thread owns one column); the carry buffers
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

// Phase 3a: the row denominators sum(W * scale) + 1e-6 of slab s = t * B
// + b at epoch e0 + t. The row sum feeds the consensus, so it adds left
// to right (ops/normalize.py::sequential_sum). One block of 8 warps per
// 32 rows: all warps stage [32 x 128] column chunks of the scaled weights
// into shared memory (coalesced, double-buffered, so the next chunk's
// loads overlap this chunk's adds), and lane r of warp 0 adds row r's
// values in order.
__global__ void k_rowsum(const float* __restrict__ W, const float* __restrict__ scales,
                         float* __restrict__ den, int B, int WE, int e0, int V,
                         int M) {
  constexpr int kRows = 32, kCols = 128;
  __shared__ float tile[2][kRows][kCols + 1];
  const int v0 = blockIdx.x * kRows, s = blockIdx.y, t = s / B, b = s % B;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = min(kRows, V - v0);
  const float sc = epoch_scale(scales, e0 + t);
  const float* Wb = W + epoch_slice(b, WE, e0 + t, (size_t)V * M) + (size_t)v0 * M;
  auto stage = [&](int buf, int m0) {
    const int cols = min(kCols, M - m0);
    for (int i = tid; i < kRows * kCols; i += blockDim.x) {
      const int r = i / kCols, c = i - r * kCols;
      if (r < rows && c < cols) tile[buf][r][c] = Wb[(size_t)r * M + m0 + c] * sc;
    }
  };
  float acc = 0.0f;
  int buf = 0;
  stage(0, 0);
  __syncthreads();
  for (int m0 = 0; m0 < M; m0 += kCols) {
    if (m0 + kCols < M) stage(buf ^ 1, m0 + kCols);
    if (warp == 0 && lane < rows) {
      const int cols = min(kCols, M - m0);
      for (int c = 0; c < cols; ++c) acc += tile[buf][lane][c];
    }
    __syncthreads();
    buf ^= 1;
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

// Phase 7: the bond update of epoch t of the tile, in place, one thread
// per (scenario, miner) column; column sums run over validators in order.
__global__ void k_bond(ScanArgs a, int t, int eg) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x, b = blockIdx.y;
  if (m >= a.M) return;
  const int V = a.V, M = a.M;
  const int s = t * a.B + b;
  const float* wn = a.wn + (size_t)s * V * M + m;
  const float* base = clip_base(a, t, b, eg) + m;
  const float* sn = a.sn + (size_t)s * V;
  const float c = a.C[(size_t)s * M + m];
  const float* hp = a.hp + (size_t)b * NHP;
  float* bc = a.bonds + (size_t)b * V * M + m;
  const bool liquid_rate = a.liquid && a.mode != CAPACITY;
  const float rate = liquid_rate ? a.rate[(size_t)s * M + m] : hp[ALPHA];
  const bool first = eg == 0;
  using yuma::max_nan;
  using yuma::min_nan;
  using yuma::nan_to_num;

  if (a.mode == CAPACITY) {
    const float omd = 1.0f - hp[DECAY], cap_alpha = hp[CAP_ALPHA];
#pragma unroll 8
    for (int v = 0; v < V; ++v) {
      const size_t i = (size_t)v * M;
      const float cap = sn[v] * kMaxInt;
      const float old = bc[i];
      const float remaining = max_nan(cap - old, 0.0f);
      const float purchase = min_nan(cap_alpha * cap, remaining) * wn[i];
      bc[i] = min_nan(omd * old + purchase, cap);
    }
    return;
  }
  if (a.mode == RELATIVE) {
    const float keep = 1.0f - rate;
#pragma unroll 8
    for (int v = 0; v < V; ++v) {
      const size_t i = (size_t)v * M;
      const float dec = bc[i] * keep;
      const float remaining = max_nan(1.0f - dec, 0.0f);
      const float purchase = min_nan(rate * wn[i], remaining);
      bc[i] = min_nan(dec + purchase, 1.0f);
    }
    return;
  }
  // EMA families: B_t = nan_to_num(S * W_x / colsum), W_x the clipped
  // weights (Yuma 0) or the beta-blend of the bond base and them.
  const float beta = hp[BETA], omb = 1.0f - beta;
  const float* bond_base = a.mode == EMA ? wn : base;
  auto target = [&](int v) {
    const size_t i = (size_t)v * M;
    const float wc = min_nan(base[i], c);
    if (a.mode == EMA_RUST) return sn[v] * wc;
    return sn[v] * (omb * bond_base[i] + beta * wc);
  };
  float col = 0.0f;
#pragma unroll 8
  for (int v = 0; v < V; ++v) col += target(v);
  const float den = a.mode == EMA_RUST ? col + 1e-6f : col;
  const float keep = 1.0f - rate;
  float col2 = 0.0f;
#pragma unroll 8
  for (int v = 0; v < V; ++v) {
    const size_t i = (size_t)v * M;
    const float bt = nan_to_num(target(v) / den);
    const float ema = rate * bt + keep * bc[i];
    const float bn = first ? bt : ema;  // a select, never a blend
    bc[i] = bn;
    col2 += bn;
  }
  if (a.mode == EMA_RUST) {
    const float den2 = col2 + 1e-6f;
#pragma unroll 8
    for (int v = 0; v < V; ++v) {
      const size_t i = (size_t)v * M;
      bc[i] = nan_to_num(bc[i] / den2);
    }
  }
}

// Phase 8a: D[v] = sum_m B[v, m] * incentive[m] (times S_n[v] for RELATIVE);
// also copies the bond row into the per-epoch output when it is saved.
__global__ void k_dividend(ScanArgs a, int t, int e) {
  const int v = blockIdx.x, b = blockIdx.y, s = t * a.B + b;
  const int M = a.M;
  const float* row = a.bonds + ((size_t)b * a.V + v) * M;
  const float* inc = a.inc + (size_t)s * M;
  float* out = a.bonds_out
                   ? a.bonds_out + (((size_t)b * a.E + e) * a.V + v) * M
                   : nullptr;
  float acc = 0.0f;
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const float x = row[m];
    acc += x * inc[m];
    if (out) out[m] = x;
  }
  float d = yuma::block_sum(acc);
  if (a.mode == RELATIVE) d = a.sn[(size_t)s * a.V + v] * d;
  if (threadIdx.x == 0) a.dsum[(size_t)b * a.V + v] = d;
}

// Phase 8b: D_n = D / (sum(D) + 1e-6), one block per scenario; stored per
// epoch and/or added to the running epoch sum (epoch order, float32).
__global__ void k_dnorm(ScanArgs a, int e) {
  const int b = blockIdx.x;
  const float* d = a.dsum + (size_t)b * a.V;
  float acc = 0.0f;
  for (int v = threadIdx.x; v < a.V; v += blockDim.x) acc += d[v];
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
  k_rowsum<<<dim3((a.V + 31) / 32, nslab), 256, 0, st>>>(a.W, a.scales, den, a.B,
                                                        a.w_epochs, e0, a.V, a.M);
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
    cudaError_t err = yuma::launch_bisect(a.wn, a.sint, a.hp + KAPPA, NHP, B,
                                          nslab, a.chi, V, M, a.iters, st, a.mxu);
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
      k_bond<<<dim3(col_blocks, B), 128, 0, st>>>(a, t, eg);
      CHECK_LAUNCH();
      k_dividend<<<dim3(V, B), 256, 0, st>>>(a, t, e);
      CHECK_LAUNCH();
      k_dnorm<<<B, 256, 0, st>>>(a, e);
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
