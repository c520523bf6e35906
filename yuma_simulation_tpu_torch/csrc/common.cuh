// Shared device code of the port's CUDA kernels: float helpers with the
// JAX package's NaN/inf semantics, a block reduction in a fixed order, and
// the consensus bisection kernels themselves (K1 and K4, also the
// consensus phase of every scan).
//
// Determinism: every float reduction here runs in a fixed order (each
// thread a strided sequential sum, then a fixed shuffle tree), never with
// float atomics, so a run is reproducible bit for bit. The bisection's
// support is an int32 sum, exact in any order.
#pragma once

#include <algorithm>
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

// Programmatic dependent launch (Hopper): a kernel launched by
// launch_kernel may be scheduled while the kernel before it on the stream
// is still finishing, so every such kernel first waits here until that
// kernel has completed and its writes are visible; it reads and writes
// nothing before. (Launched without the attribute, this is a no-op.)
__device__ __forceinline__ void wait_for_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Whether launch_kernel asks for programmatic dependent launch
// (scripts/torch_phase_variants.py times the scans without it).
constexpr bool kProgrammaticLaunch = true;

// Launch `kernel` on `st`; returns the launch status.
template <typename... P, typename... A>
inline cudaError_t launch_kernel(void (*kernel)(P...), dim3 grid, dim3 block,
                                 cudaStream_t st, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kProgrammaticLaunch ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
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


// ---------------------------------------------------------------------------
// The consensus bisection: K1 (k_bisect), K4 (k_bisect_mma), and
// launch_bisect, which picks between them. K1's body is also phase 4 of
// every scan (scan_phases.cuh::run_scan), K4's with mxu.
//
// Replaces: the Pallas body _consensus_kernel of the JAX package's
//   ops/pallas_consensus.py :: stake_weighted_median_pallas (K1), and the
//   mxu=True support of its scans, ops/pallas_epoch.py :: _stake_limb_split
//   / _support_limbs_mxu (K4).
//
// Contract (ops/consensus.py::stake_weighted_median): per miner, `iters`
// halvings of [0, 1] (17 at the default precision); mid = (hi + lo) * 0.5
// in float32; the support is the int32 sum of the fixed-point stakes
// S_int[v] whose weight is strictly above mid (a NaN weight never is),
// rounded once to float32, times 2^-30, compared strictly with kappa; the
// result is the final hi. The support is an exact integer, so any thread
// layout and any order of the partial sums gives the plain version's
// result bit for bit.
//
// What bounds both on the H100: a launch must read W_n once, 4 MiB a slab
// at 256 x 4096 (~1.25 us at 3.35 TB/s); the halvings are 17 compares and
// adds per cell (~0.5 us a slab at the 67 T/s vector rate). Besides, the
// halvings are a chain: each needs the one before it decided, so a slab
// takes at least 17 halvings' latency (K1: one block barrier each).
//
// What both designs do about it: W_n is loaded into registers once, every
// load of a thread issued before the first halving, and never staged in a
// per-block [V, TM] tile, so a block needs a few KB of shared memory at
// most and one slab at 4096 miners fills 128 blocks (the staged tile of
// earlier versions allowed 32 blocks, one per SM). Each halving then runs
// from registers.

// What one bisection launch reads and writes. A slab is one (epoch,
// scenario) [V, M] matrix.
struct BisectArgs {
  const float* wn;     // [nslab, V, M] row-normalized weights
  const int* sint;     // [nslab, V] fixed-point stakes, or null: then
  const float* sn;     // [nslab, V] normalized stakes, rounded on load
  const float* kappa;  // slab s reads kappa[(s % B) * kappa_stride]; or
  float kappa0;        // null: this kappa for every slab
  int kappa_stride, B;
  float* chi;          // [nslab, M] the final c_high
  int nslab, V, M, iters;
};

__device__ __forceinline__ float bisect_kappa(const BisectArgs& a, int s) {
  return a.kappa ? a.kappa[(size_t)(s % a.B) * a.kappa_stride] : a.kappa0;
}

// The fixed-point stake of validator v of slab s, 0 past V:
// round(S * 2^30), half to even (ops/consensus.py::support_fixed_stakes).
__device__ __forceinline__ int bisect_stake(const BisectArgs& a, int s, int v) {
  if (v >= a.V) return 0;
  const size_t i = (size_t)s * a.V + v;
  return a.sint ? a.sint[i] : __float2int_rn(a.sn[i] * kFixed);
}

// One halving's decision for one miner (ops/consensus.py::support_rounded).
__device__ __forceinline__ void bisect_decide(int support, float kap, float mid,
                                              float& lo, float& hi) {
  const bool above = (__int2float_rn(support) * kInvFixed) > kap;
  lo = above ? mid : lo;
  hi = above ? hi : mid;
}

// K1's layout: miners per block, row steps a lane holds in registers, and
// the most warps a block has. A lane holds 4 adjacent miners; kBisectQuads
// lanes span the tile and kBisectSub lanes share a warp's rows, so a warp
// holds kBisectSub * kBisectRows validators (64 at the committed 16 x 4).
constexpr int kBisectTM = 32;
constexpr int kBisectRows = 16;
constexpr int kBisectWarps = 4;
constexpr int kBisectQuads = kBisectTM / 4;
constexpr int kBisectSub = 32 / kBisectQuads;
static_assert(kBisectTM == 32 || kBisectTM == 64 || kBisectTM == 128,
              "4 miners a lane, at most one warp across the tile");
// Whether K1 loads W_n 16 bytes at a time where M % 4 == 0 and W_n is
// 16-byte aligned (scripts/torch_phase_variants.py times 4-byte loads
// against it).
constexpr bool kBisectVecLoads = true;

// Weights m .. m+3 of one row, 0 past M: one 16-byte load with VEC (M % 4
// == 0 and 16-byte aligned rows, so the four are all in or all out), else
// four.
template <bool VEC>
__device__ __forceinline__ float4 load_quad(const float* row, int m, int M) {
  if (VEC) {
    return m < M ? *reinterpret_cast<const float4*>(row + m)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  return make_float4(m < M ? row[m] : 0.0f, m + 1 < M ? row[m + 1] : 0.0f,
                     m + 2 < M ? row[m + 2] : 0.0f, m + 3 < M ? row[m + 3] : 0.0f);
}

// acc += st where w > mid (ordered: a NaN never is), as a compare and a
// predicated add: two instructions (the compiler's select-and-add takes
// two and a half).
__device__ __forceinline__ void add_if_above(int& acc, float w, float mid, int st) {
  asm("{\n .reg .pred p;\n setp.gt.f32 p, %1, %2;\n @p add.s32 %0, %0, %3;\n}"
      : "+r"(acc)
      : "f"(w), "f"(mid), "r"(st));
}

__device__ __forceinline__ void add_above(int (&acc)[4], float4 w, int st,
                                          const float (&mid)[4]) {
  add_if_above(acc[0], w.x, mid[0], st);
  add_if_above(acc[1], w.y, mid[1], st);
  add_if_above(acc[2], w.z, mid[2], st);
  add_if_above(acc[3], w.w, mid[3], st);
}

// K1 - the consensus bisection. One block of nw warps per (slab,
// kBisectTM-miner tile): at 256 x 4096, 128 blocks a slab. Lane (sub, q)
// holds miners m .. m+3 (m = tile + 4q; the kBisectQuads lanes of one row
// read 128 contiguous bytes) and row steps r = 0 .. rw-1 of its warp's
// contiguous validator slice, validator v0 + r * kBisectSub. The first
// kBisectRows steps and their stakes are loaded into registers once; a
// longer slice (V > kBisectWarps * kBisectSub * kBisectRows) re-reads its
// tail from L2 every halving. Each halving: compares and predicated adds
// from registers, a shuffle sum over the kBisectSub row lanes, one int4 partial
// per (warp, quad) into shared memory double-buffered by the halving's
// parity (a warp rewrites a buffer only after the next barrier, when every
// warp has read it), one barrier, and every warp adds the nw partials of
// its miners in warp order and decides in registers: no second barrier.
template <bool VEC>
__global__ void __launch_bounds__(32 * kBisectWarps)
    k_bisect(const BisectArgs a, int rw) {
  wait_for_prior_grid();
  __shared__ __align__(16) int part[2][kBisectWarps][kBisectTM];
  const int tiles = (a.M + kBisectTM - 1) / kBisectTM;
  const int s = blockIdx.x / tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int q = lane % kBisectQuads, sub = lane / kBisectQuads;
  const int m = (blockIdx.x - s * tiles) * kBisectTM + 4 * q;
  const float* W = a.wn + (size_t)s * a.V * a.M;
  const int v0 = warp * rw * kBisectSub + sub;
  float4 w[kBisectRows];
  int st[kBisectRows];
#pragma unroll
  for (int r = 0; r < kBisectRows; ++r) {
    const int v = v0 + r * kBisectSub;
    const bool in = r < rw && v < a.V;
    w[r] = in ? load_quad<VEC>(W + (size_t)v * a.M, m, a.M)
              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    st[r] = in ? bisect_stake(a, s, v) : 0;
  }
  const float kap = bisect_kappa(a, s);
  float lo[4] = {0.0f, 0.0f, 0.0f, 0.0f}, hi[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  for (int it = 0; it < a.iters; ++it) {
    float mid[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) mid[j] = (hi[j] + lo[j]) * 0.5f;
    int acc[4] = {0, 0, 0, 0};
#pragma unroll
    for (int r = 0; r < kBisectRows; ++r) add_above(acc, w[r], st[r], mid);
    for (int r = kBisectRows; r < rw; ++r) {
      const int v = v0 + r * kBisectSub;
      if (v < a.V) {
        add_above(acc, load_quad<VEC>(W + (size_t)v * a.M, m, a.M),
                  bisect_stake(a, s, v), mid);
      }
    }
#pragma unroll
    for (int o = kBisectQuads; o < 32; o <<= 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
    }
    int(*p)[kBisectTM] = part[it & 1];
    if (sub == 0) {
      *reinterpret_cast<int4*>(&p[warp][4 * q]) = make_int4(acc[0], acc[1], acc[2], acc[3]);
    }
    __syncthreads();
    int tot[4] = {0, 0, 0, 0};
#pragma unroll
    for (int u = 0; u < kBisectWarps; ++u) {
      if (u >= nw) break;
      const int4 x = *reinterpret_cast<const int4*>(&p[u][4 * q]);
      tot[0] += x.x;
      tot[1] += x.y;
      tot[2] += x.z;
      tot[3] += x.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) bisect_decide(tot[j], kap, mid[j], lo[j], hi[j]);
  }
  if (warp == 0 && sub == 0) {
    float* out = a.chi + (size_t)s * a.M;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (m + j < a.M) out[m + j] = hi[j];
    }
  }
}

// K4 - the same bisection with the support sum on the tensor cores.
//
// Exact by construction: S_int < 2^31 is cut into four u8 limbs, and each
// halving contracts the limb rows [4, V] with the s8 mask -128 [W_n > mid]
// [V, M] (0 or -128: a byte of what one compare gives) on the tensor cores
// (mma.sync m16n8k32, u8 x s8 -> s32). Every product is exact and an s32
// partial sum stays within 128 * 255 * V <= 2^29 (V <= 2^14), so each limb
// sum is the exact integer times -128; shifting the four sums back
// together in int32 gives K1's support bit for bit
// (the TPU needed a bf16 head/residual split because its dot rounds
// operands to bf16; u8 operands need no such split).
//
// What bounds it: as K1, reading W_n once and the halving chain; the
// contraction is 2 * 4 * V * M int8 operations a halving, nothing at
// 1,979 TOPS. A halving's chain is the mask build (one compare a weight,
// three byte permutes per four), kMmaSteps / kMmaChains dependent mmas
// and 8 shuffles.
//
// Design: one warp owns 8 miners over all V; a block is kMmaWarps warps
// (at 256 x 4096, 128 blocks a slab). Lane (g, t) = (lane / 4, lane % 4)
// feeds A row g, k = 4t..4t+3 and 16+4t..16+4t+3 (rows 4..15 zero), and B
// column g at the same k; it gets D[g][2t], D[g][2t+1] back, so lanes
// g < 4 hold limb g's sums of miners 2t and 2t+1. Before the first
// halving each lane loads, for the first kMmaSteps 32-validator k-steps,
// its 8 B-fragment weights of miner n0 + g and its two A-fragment limb
// words into registers. A halving then builds the masks from registers,
// issues one mma per k-step, gathers miner g's four limb sums by shuffles
// and decides: no shared memory and no barrier in the loop; lo and hi
// live in registers (the 4 lanes of a miner hold the same copy). k-steps
// past kMmaSteps (V > 256) are re-read from L2 every halving. A lane reads
// its fragments from global memory 4 bytes at a time: a block staging its
// [256, 32] tile by 16-byte cp.async measured no faster (PERF.md).

// D += A * B with A u8 (the limbs) and B s8 (the mask bytes, 0 or -128),
// so every limb sum comes back times -128.
__device__ __forceinline__ void mma_u8s8_m16n8k32(int (&d)[4], unsigned a0,
                                                  unsigned a2, unsigned b0,
                                                  unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

constexpr int kLimbs = 4;
// K4's layout: warps per block (8 miners each), and the 32-validator
// k-steps a lane holds in registers (V <= 256).
constexpr int kMmaWarps = 4;
constexpr int kMmaSteps = 8;
constexpr int kMmaChains = 4;  // accumulator chains a halving (divides kMmaSteps)
// Blocks an SM must hold at once: caps K4 at 128 registers a thread, so
// four blocks (16 warps) share an SM when a launch has enough of them.
constexpr int kMmaMinBlocks = 4;

// 1.0f (0x3f800000) where w > mid (ordered: a NaN never is), else 0.0f,
// as its bits: one instruction.
__device__ __forceinline__ unsigned gt_one(float w, float mid) {
  float r;
  asm("set.gt.f32.f32 %0, %1, %2;" : "=f"(r) : "f"(w), "f"(mid));
  return __float_as_uint(r);
}

// One byte per validator, lowest k in the lowest byte: byte 2 of the
// compare's 1.0f, 0x80 (-128 as s8) where w > mid, else 0. Four compares
// and three byte permutes.
__device__ __forceinline__ unsigned mask4(float w0, float w1, float w2,
                                          float w3, float mid) {
  const unsigned lo = __byte_perm(gt_one(w0, mid), gt_one(w1, mid), 0x0062);
  const unsigned hi = __byte_perm(gt_one(w2, mid), gt_one(w3, mid), 0x0062);
  return __byte_perm(lo, hi, 0x5410);
}

// Lane (g, t)'s two A-fragment words of one k-step, from that k-step's
// stakes one a lane (lane l holds S_int of validator 32 ks + l): byte i of
// a0 is limb g of lane 4t + i's stake, of a2 of lane 16 + 4t + i's; both
// 0 on lanes g >= 4, which feed the zero rows. Every lane must call it.
__device__ __forceinline__ void limb_words(int sv, int g, int t, unsigned& a0,
                                           unsigned& a2) {
  unsigned x[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[i] = (unsigned)__shfl_sync(0xffffffffu, sv, 4 * t + i);
    x[4 + i] = (unsigned)__shfl_sync(0xffffffffu, sv, 16 + 4 * t + i);
  }
  const unsigned sel = (unsigned)(g | ((g + 4) << 4));  // byte g of x, of y
  a0 = __byte_perm(__byte_perm(x[0], x[1], sel), __byte_perm(x[2], x[3], sel), 0x5410);
  a2 = __byte_perm(__byte_perm(x[4], x[5], sel), __byte_perm(x[6], x[7], sel), 0x5410);
  if (g >= kLimbs) a0 = a2 = 0u;
}

// The k index of B-fragment element i of lane (g, t) within its k-step.
__device__ __forceinline__ int frag_k(int t, int i) {
  return 4 * t + (i & 3) + 16 * (i >> 2);
}

// Lane (g, t)'s B-fragment weights of the first kMmaSteps k-steps, miner
// n0 + g: w[ks][i] = W[32 ks + frag_k(t, i)][n0 + g], 0 past V or M, read
// from global memory 4 bytes at a time (each warp-wide load takes 4 rows
// x 32 bytes).
__device__ __forceinline__ void load_fragments(const float* W, int V, int M,
                                               int n0, int ksteps,
                                               float (&w)[kMmaSteps][8]) {
  const int lane = threadIdx.x & 31, t = lane & 3, col = n0 + (lane >> 2);
#pragma unroll
  for (int ks = 0; ks < kMmaSteps; ++ks) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int v = 32 * ks + frag_k(t, i);
      w[ks][i] = (ks < ksteps && v < V && col < M) ? W[(size_t)v * M + col] : 0.0f;
    }
  }
}

constexpr int kMmaTile = 8 * kMmaWarps;  // miners a block

__global__ void __launch_bounds__(32 * kMmaWarps, kMmaMinBlocks)
    k_bisect_mma(const BisectArgs a) {
  wait_for_prior_grid();
  const int groups = (a.M + 7) / 8;
  const int per_slab = (groups + kMmaWarps - 1) / kMmaWarps;
  const int s = blockIdx.x / per_slab;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = (blockIdx.x - s * per_slab) * kMmaWarps + warp;
  if (grp >= groups) return;  // the whole warp; nothing below waits for it
  const int g = lane >> 2, t = lane & 3, n0 = grp * 8, col = n0 + g;
  const int ksteps = (a.V + 31) / 32;
  const float* W = a.wn + (size_t)s * a.V * a.M;
  // The weights' loads go out first; the limb words are built from one
  // coalesced stake load a k-step while they are in flight.
  float w[kMmaSteps][8];
  load_fragments(W, a.V, a.M, n0, ksteps, w);
  int sv[kMmaSteps];
#pragma unroll
  for (int ks = 0; ks < kMmaSteps; ++ks) {
    sv[ks] = ks < ksteps ? bisect_stake(a, s, 32 * ks + lane) : 0;
  }
  unsigned la[kMmaSteps][2];
#pragma unroll
  for (int ks = 0; ks < kMmaSteps; ++ks) limb_words(sv[ks], g, t, la[ks][0], la[ks][1]);
  const float kap = bisect_kappa(a, s);
  const int src = g >> 1;  // lanes 4j + src hold limb j's sums of miner g
  float lo = 0.0f, hi = 1.0f;
  for (int it = 0; it < a.iters; ++it) {
    const float mid = (hi + lo) * 0.5f;
    // Every register k-step, unguarded (past V its weights and limbs are
    // 0 and add 0), so the mask builds interleave; kMmaChains accumulator
    // chains shorten the dependent mma latency a halving waits for, and
    // their sum is exact.
    int part[kMmaChains][4] = {};
#pragma unroll
    for (int ks = 0; ks < kMmaSteps; ++ks) {
      mma_u8s8_m16n8k32(part[ks % kMmaChains], la[ks][0], la[ks][1],
                        mask4(w[ks][0], w[ks][1], w[ks][2], w[ks][3], mid),
                        mask4(w[ks][4], w[ks][5], w[ks][6], w[ks][7], mid));
    }
    int acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[j] = part[0][j];
#pragma unroll
      for (int c = 1; c < kMmaChains; ++c) acc[j] += part[c][j];
    }
    for (int ks = kMmaSteps; ks < ksteps; ++ks) {
      float x[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int v = 32 * ks + frag_k(t, i);
        x[i] = (v < a.V && col < a.M) ? W[(size_t)v * a.M + col] : 0.0f;
      }
      unsigned a0, a2;
      limb_words(bisect_stake(a, s, 32 * ks + lane), g, t, a0, a2);
      mma_u8s8_m16n8k32(acc, a0, a2, mask4(x[0], x[1], x[2], x[3], mid),
                        mask4(x[4], x[5], x[6], x[7], mid));
    }
    // Miner g's support from its limb sums (each came back times -128),
    // most significant limb first (every partial is <= the exact support,
    // which fits int32).
    unsigned tot = 0u;
#pragma unroll
    for (int j = kLimbs - 1; j >= 0; --j) {
      const int x0 = __shfl_sync(0xffffffffu, acc[0], 4 * j + src);
      const int x1 = __shfl_sync(0xffffffffu, acc[1], 4 * j + src);
      tot = (tot << 8) + ((unsigned)(-((g & 1) ? x1 : x0)) >> 7);
    }
    bisect_decide((int)tot, kap, mid, lo, hi);
  }
  if (t == 0 && col < a.M) a.chi[(size_t)s * a.M + col] = hi;
}

// Launch K1 (mma = 0) or K4 (mma = 1) over a.nslab slabs on `st`, with a
// one-dimensional grid, the miner tiles of a slab adjacent. K1: blocks of
// nw warps, nw the fewest whose register slices cover V (at most
// kBisectWarps), each warp's slice rw row steps a lane. K4: blocks of
// kMmaWarps warps. K1 takes 16-byte loads when M % 4 == 0 and W_n is
// 16-byte aligned. Refuses (cudaErrorInvalidValue) empty shapes, K4
// past V = 2^14 (ops/consensus.py::MXU_MAX_VALIDATORS) and grids past
// 2^31 - 1 blocks; returns the launch status.
inline cudaError_t launch_bisect(const BisectArgs& a, cudaStream_t st, int mma = 0) {
  if (a.nslab < 1 || a.V < 1 || a.M < 1 || a.iters < 0 || (a.kappa && a.B < 1)) {
    return cudaErrorInvalidValue;
  }
  if (mma && a.V > (1 << 14)) return cudaErrorInvalidValue;
  const int tm = mma ? kMmaTile : kBisectTM;
  const long long blocks = (long long)a.nslab * ((a.M + tm - 1) / tm);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (mma) return launch_kernel(k_bisect_mma, (unsigned)blocks, 32 * kMmaWarps, st, a);
  const bool vec = kBisectVecLoads && a.M % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(a.wn) % 16 == 0;
  const int per_warp = kBisectSub * kBisectRows;
  const int nw = std::min(kBisectWarps, (a.V + per_warp - 1) / per_warp);
  const int rw = (a.V + nw * kBisectSub - 1) / (nw * kBisectSub);
  return launch_kernel(vec ? k_bisect<true> : k_bisect<false>, (unsigned)blocks, 32 * nw,
                       st, a, rw);
}

}  // namespace yuma
