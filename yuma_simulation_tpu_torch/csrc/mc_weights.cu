// K7 - the Monte-Carlo weight slab: JAX's threefry normal draws, bit for bit.
//
// Replaces no TPU kernel. The JAX package makes this slab in XLA
// (yuma_simulation_tpu/parallel/sharded.py :: _montecarlo_weight_slab):
//   W[b, e, v, m] = relu(base[v, m] + p * normal(fold_in(key_b, lo + e), (V, M)))
// which XLA:CPU compiles as max(fma(erf_inv(u), p * sqrt(2), base), 0), u the
// uniform of jax.random.normal. Its plain version is
// yuma_simulation_tpu_torch/random.py :: perturbed_weights, a composition of
// some twenty int64 tensor operations per threefry round and an exact-FMA
// emulation of each multiply-add: at 8 x 16 x 256 x 4096 that is several GB of
// temporaries a slab. This kernel writes each element once.
//
// What bounds it on the H100: 4 bytes written an element (537 MB for the
// [8, 16, 256, 4096] slab, ~0.16 ms at 3.35 TB/s) against ~130 integer and
// float operations an element (the 20 threefry rounds, the uniform, XLA's
// log1p / log and the erf_inv polynomial), ~70 G operations, ~1 ms at the
// 67 T/s vector rate: operations bind it.
//
// What the design does about it: one thread per 8 elements of one epoch's
// [V, M] draw; a block's threads compute their epoch's fold_in key once and
// keep it in registers, so each element costs one threefry block, not two.
// Consecutive threads write consecutive elements. Every rounding is the plain
// version's: the sources are built with --fmad=false, and the multiply-adds
// XLA:CPU contracts are __fmaf_rn at exactly the plain version's sites; the
// square root and the division are IEEE (__fsqrt_rn, __fdiv_rn). Only the
// branch that XLA's select keeps is evaluated.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds (jax/_src/prng.py :: _threefry2x32_lowering).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const uint32_t ks[3] = {k0, k1, k2};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

__device__ __forceinline__ float min_normal() { return __int_as_float(0x00800000); }

// XLA:CPU's log_f32 (random.py :: xla_log).
__device__ float xla_log(float u) {
  const float uc = u > min_normal() ? u : min_normal();
  const int bits = __float_as_int(uc);
  const float m = __int_as_float((bits & 0x7FFFFF) | 0x3F000000);
  float e = __fadd_rn((float)((bits >> 23) - 127), 1.0f);
  const bool small = m < 0.707106781186547524f;  // sqrt(1/2)
  const float x = __fadd_rn(__fadd_rn(m, -1.0f), small ? m : 0.0f);
  e = __fsub_rn(e, small ? 1.0f : 0.0f);
  const float x2 = __fmul_rn(x, x);
  const float x3 = __fmul_rn(x2, x);
  const float y0 = __fmaf_rn(__fmaf_rn(x, 7.0376836292e-2f, -1.1514610310e-1f), x,
                             1.1676998740e-1f);
  const float y1 = __fmaf_rn(__fmaf_rn(x, -1.2420140846e-1f, 1.4249322787e-1f), x,
                             -1.6668057665e-1f);
  const float y2 = __fmaf_rn(__fmaf_rn(x, 2.0000714765e-1f, -2.4999993993e-1f), x,
                             3.3333331174e-1f);
  const float t = __fmaf_rn(__fmaf_rn(__fmaf_rn(y0, x3, y1), x3, y2), x3,
                            __fmul_rn(e, -2.12194440e-4f));
  float r = __fmaf_rn(e, 0.693359375f, __fadd_rn(__fmaf_rn(-x2, 0.5f, x), t));
  if (u < 0.0f || u != u) r = __int_as_float(0x7FC00000);
  if (u == 0.0f) r = -__int_as_float(0x7F800000);
  if (u == __int_as_float(0x7F800000)) r = u;
  return r;
}

// XLA:CPU's log1p_f32 (random.py :: xla_log1p).
__device__ float xla_log1p(float x) {
  if (fabsf(x) < min_normal()) x = __fmul_rn(x, 0.0f);
  // sqrt(2) - 1: the rational form below it, log(1 + x) above.
  if (!(fabsf(x) < 0.41421356237309504880f)) return xla_log(__fadd_rn(x, 1.0f));
  const float x2 = __fmul_rn(x, x);
  float den = __fadd_rn(x, 1.5062909083469192043167e1f);
  den = __fmaf_rn(den, x, 8.3047565967967209469434e1f);
  den = __fmaf_rn(den, x, 2.2176239823732856465394e2f);
  den = __fmaf_rn(den, x, 3.0909872225312059774938e2f);
  den = __fmaf_rn(den, x, 2.1642788614495947685003e2f);
  den = __fmaf_rn(den, x, 6.0118660497603843919306e1f);
  float num = __fmaf_rn(4.5270000862445199635215e-5f, x, 4.9854102823193375972212e-1f);
  num = __fmaf_rn(num, x, 6.5787325942061044846969e0f);
  num = __fmaf_rn(num, x, 2.9911919328553073277375e1f);
  num = __fmaf_rn(num, x, 6.0949667980987787057556e1f);
  num = __fmaf_rn(num, x, 5.7112963590585538103336e1f);
  num = __fmaf_rn(num, x, 2.0039553499201281259648e1f);
  const float q = __fdiv_rn(num, den);
  return __fadd_rn(x, __fmaf_rn(x2, -0.5f, __fmul_rn(__fmul_rn(x, x2), q)));
}

// XLA's ErfInv32 as XLA:CPU compiles it (random.py :: erf_inv).
__device__ float erf_inv(float x) {
  const float w0 = -xla_log1p(__fmul_rn(x, -x));
  const bool lt = w0 < 5.0f;
  float w, p;
  if (lt) {
    w = __fsub_rn(w0, 2.5f);
    p = 2.81022636e-08f;
    p = __fmaf_rn(p, w, 3.43273939e-07f);
    p = __fmaf_rn(p, w, -3.5233877e-06f);
    p = __fmaf_rn(p, w, -4.39150654e-06f);
    p = __fmaf_rn(p, w, 0.00021858087f);
    p = __fmaf_rn(p, w, -0.00125372503f);
    p = __fmaf_rn(p, w, -0.00417768164f);
    p = __fmaf_rn(p, w, 0.246640727f);
    p = __fmaf_rn(p, w, 1.50140941f);
  } else {
    w = __fsub_rn(__fsqrt_rn(w0), 3.0f);
    p = -0.000200214257f;
    p = __fmaf_rn(p, w, 0.000100950558f);
    p = __fmaf_rn(p, w, 0.00134934322f);
    p = __fmaf_rn(p, w, -0.00367342844f);
    p = __fmaf_rn(p, w, 0.00573950773f);
    p = __fmaf_rn(p, w, -0.0076224613f);
    p = __fmaf_rn(p, w, 0.00943887047f);
    p = __fmaf_rn(p, w, 1.00167406f);
    p = __fmaf_rn(p, w, 2.83297682f);
  }
  if (fabsf(x) == 1.0f) return __fmul_rn(x, __int_as_float(0x7F800000));
  return __fmul_rn(p, x);
}

// out [nslab = B * CH, VM]: slab s = b * CH + e draws with fold_in(keys[b],
// lo + e); keys [B, 2] as uint32 words.
__global__ void __launch_bounds__(kThreads)
    k_mc_weights(const uint32_t* __restrict__ keys, const float* __restrict__ base,
                 float* __restrict__ out, int nslab, int CH, long long VM, uint32_t lo,
                 float p_sqrt2) {
  const float normal_lo = -0.999999940395355224609375f;  // nextafter(-1, 0)
  const long long first = (long long)blockIdx.x * (kThreads * kItems) + threadIdx.x;
  for (int s = blockIdx.y; s < nslab; s += gridDim.y) {
    const int b = s / CH;
    uint32_t ek0 = 0u, ek1 = lo + (uint32_t)(s - b * CH);  // fold_in(key_b, lo + e)
    threefry2x32(keys[2 * b], keys[2 * b + 1], ek0, ek1);
    float* dst = out + (long long)s * VM;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long i = first + (long long)k * kThreads;
      if (i >= VM) break;
      uint32_t c0 = (uint32_t)((unsigned long long)i >> 32), c1 = (uint32_t)i;
      threefry2x32(ek0, ek1, c0, c1);
      const uint32_t bits = c0 ^ c1;
      const float f = __fsub_rn(__int_as_float((int)((bits >> 9) | 0x3F800000u)), 1.0f);
      float u = __fmaf_rn(f, 2.0f, normal_lo);
      u = u > normal_lo ? u : normal_lo;
      const float v = __fmaf_rn(erf_inv(u), p_sqrt2, base[i]);
      dst[i] = v < 0.0f ? 0.0f : v;
    }
  }
}

}  // namespace

// Fills out [B, CH, V, M] (contiguous float32 on the card) from keys [B, 2]
// (uint32 words), base [V, M] and p * sqrt(2) rounded to float32. Launches on
// `stream`, allocates nothing, and returns the launch status.
extern "C" int yuma_mc_weights(const void* keys, const float* base, float* out, int B,
                               int CH, long long VM, unsigned int lo, float p_sqrt2,
                               void* stream) {
  if (B < 1 || CH < 1 || VM < 1) return (int)cudaErrorInvalidValue;
  const int nslab = B * CH;
  const long long per_block = (long long)kThreads * kItems;
  const long long gx = (VM + per_block - 1) / per_block;
  if (gx > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)gx, (unsigned)(nslab < 65535 ? nslab : 65535));
  k_mc_weights<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), base, out, nslab, CH, VM, (uint32_t)lo,
      p_sqrt2);
  return (int)cudaGetLastError();
}
