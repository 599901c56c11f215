// Shared per-particle arithmetic of the windowed TSC kernels (K1-K4).
//
// One particle sits in each Lagrangian cell q = (qx, qy, qz); `pos` holds its
// Eulerian position, laid out (C, 3, N1, N2, N3) float32 with chains C
// leading.  Every quantity below reproduces, operation for operation, the
// float32 arithmetic of the JAX package's phase A
// (barcode_tpu/forward/pallas_deposit.py:_phase_a): u = pos / d with an IEEE
// division (build without fast-math), base = floor(u), frac = u - base - 0.5,
// and the x/y base unwrapped to the particle's own row by the min-image
// offset, so the kernels see the same cells and weights as the TPU kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tsc {

// floor division / modulo for a positive divisor
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int pos_mod(int a, int b) {
  int r = a % b;
  return r < 0 ? r + b : r;
}

// TSC weight of offset s in {-1, 0, 1}; dx = distance from the containing
// cell's centre in cell units (assign.py:_tsc_axis_weight).  Rounded as
// written (no fused multiply-add), so every kernel that includes this
// header, and the plain versions, get the same bits.
__device__ __forceinline__ float tsc_w(float dx, int s) {
  if (s == 0) return __fsub_rn(0.75f, __fmul_rn(dx, dx));
  float a = 1.5f - fabsf(dx - (float)s);
  return 0.5f * (a * a);
}

// d/d(dx) of tsc_w (pallas_deposit.py:_tsc_dw); callers divide by the cell
__device__ __forceinline__ float tsc_dw(float dx, int s) {
  if (s == 0) return -2.0f * dx;
  float r = dx - (float)s;
  float sgn = (float)((r > 0.0f) - (r < 0.0f));
  return -(1.5f - fabsf(r)) * sgn;
}

// base cell and fraction of one coordinate in cell units u = p / d
__device__ __forceinline__ void base_frac_u(float u, int* b, float* f) {
  float fb = floorf(u);
  *b = (int)fb;
  *f = u - fb - 0.5f;
}

// base cell and fraction of one coordinate
__device__ __forceinline__ void base_frac(float p, float d, int* b, float* f) {
  base_frac_u(p / d, b, f);
}

// base cell unwrapped to Lagrangian row q: q + min-image(b - q), the
// integer form of mod(b - q + n/2, n) - n/2 (exact for even and odd n)
__device__ __forceinline__ int unwrap(int b, int q, int n) {
  int off = b - q;
  return q + off - n * floor_div(2 * off + n, 2 * n);
}

// x rounded to bfloat16, round to nearest even, and back to float32 when
// BF16 (the TPU kernels' bf16 operands, pallas_deposit.py:230-233 and
// :349, :398-401); x itself otherwise.  A product of two rounded values is
// exact in float32 (8-bit significands).
template <bool BF16>
__device__ __forceinline__ float bf16_round(float x) {
  if (BF16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

// The gather's per-particle arithmetic (K2, K4): the TSC weights and their
// derivatives from the fractions; the nine z-sums s (value) and sd (z
// derivative) in k order; val, gx, gy, gz accumulated over (a, b) in that
// order, rows outside the window (mx, my) skipped; the derivatives divided
// by the cell size.  `tap(a, b, k)` reads the field at offset (a-1, b-1,
// k-1).  Every rounding is pinned (__fmaf_rn, __fmul_rn; the IEEE division
// of a build without fast-math), so each call site gets the same bits
// whatever its context lets the compiler contract.  With BF16 the z
// weights, their derivatives and the field's taps are rounded to bfloat16
// before the z contraction, as the TPU's z-first body rounds its MXU
// operands (pallas_deposit.py:349, :398-401); everything after it stays
// float32.
struct Gathered {
  float val, gx, gy, gz;
};

template <bool BF16, class Tap>
__device__ __forceinline__ Gathered gather_taps(float fx, float fy, float fz,
                                                const bool (&mx)[3],
                                                const bool (&my)[3], float d1,
                                                float d2, float d3,
                                                const Tap& tap) {
  float wx[3], wy[3], wz[3], dwx[3], dwy[3], dwz[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int o = k - 1;
    wx[k] = tsc_w(fx, o);
    wy[k] = tsc_w(fy, o);
    wz[k] = bf16_round<BF16>(tsc_w(fz, o));
    dwx[k] = tsc_dw(fx, o);
    dwy[k] = tsc_dw(fy, o);
    dwz[k] = bf16_round<BF16>(tsc_dw(fz, o));
  }
  float val = 0.0f, gx = 0.0f, gy = 0.0f, gz = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (!mx[a]) continue;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      if (!my[b]) continue;
      float s = 0.0f, sd = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float v = bf16_round<BF16>(tap(a, b, k));
        s = __fmaf_rn(wz[k], v, s);
        sd = __fmaf_rn(dwz[k], v, sd);
      }
      const float wxy = __fmul_rn(wx[a], wy[b]);
      val = __fmaf_rn(wxy, s, val);
      gx = __fmaf_rn(__fmul_rn(dwx[a], wy[b]), s, gx);
      gy = __fmaf_rn(__fmul_rn(wx[a], dwy[b]), s, gy);
      gz = __fmaf_rn(wxy, sd, gz);
    }
  }
  return Gathered{val, gx / d1, gy / d2, gz / d3};
}

}  // namespace tsc
