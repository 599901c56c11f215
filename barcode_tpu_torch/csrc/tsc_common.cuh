// Shared per-particle arithmetic of the windowed TSC kernels (K1, K2).
//
// One particle sits in each Lagrangian cell q = (qx, qy, qz); `pos` holds its
// Eulerian position, laid out (C, 3, N1, N2, N3) float32 with chains C
// leading.  Every quantity below reproduces, operation for operation, the
// float32 arithmetic of the JAX package's phase A
// (barcode_tpu/forward/pallas_deposit.py:_phase_a): u = pos / d with an IEEE
// division (build without fast-math), base = floor(u), frac = u - base - 0.5,
// and the x/y base unwrapped to the particle's own row by the min-image
// offset, so both kernels see the same cells and weights as the TPU kernels.
#pragma once

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

// base cell and fraction of one coordinate
__device__ __forceinline__ void base_frac(float p, float d, int* b, float* f) {
  float u = p / d;
  float fb = floorf(u);
  *b = (int)fb;
  *f = u - fb - 0.5f;
}

// base cell unwrapped to Lagrangian row q: q + min-image(b - q), the
// integer form of mod(b - q + n/2, n) - n/2 (exact for even and odd n)
__device__ __forceinline__ int unwrap(int b, int q, int n) {
  int off = b - q;
  return q + off - n * floor_div(2 * off + n, 2 * n);
}

// One axis of the DEPOSIT window rule (K1).  Output block I owns cells
// [I*B, I*B + B) and sums the particles whose (periodic copy of the)
// Lagrangian row lies in [I*B - h, I*B + B + h).  For the target X = bu + o,
// the copy shifted by s = wrap(X) - X is the one that lands in range, so the
// tap counts iff q + s lies in the window of the block owning wrap(X).
__device__ __forceinline__ void deposit_axis(int bu, int q, int n, int B,
                                             int h, int o, int* target,
                                             bool* in_window) {
  int X = bu + o;
  int Xw = pos_mod(X, n);
  int qq = q + (Xw - X);
  int lo = (Xw / B) * B - h;
  *target = Xw;
  *in_window = (qq >= lo) && (qq < lo + B + 2 * h);
}

// One axis of the GATHER window rule (K2): the particle's own block
// I = q / B reads the field window [I*B - h, I*B + B + h) (unwrapped).
__device__ __forceinline__ void gather_axis(int bu, int q, int n, int B,
                                            int h, int o, int* target,
                                            bool* in_window) {
  int X = bu + o;
  int lo = (q / B) * B - h;
  *target = pos_mod(X, n);
  *in_window = (X >= lo) && (X < lo + B + 2 * h);
}

}  // namespace tsc
