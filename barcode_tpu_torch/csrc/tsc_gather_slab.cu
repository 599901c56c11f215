// K4: windowed TSC gather of an extended-slab field and its three position
// derivatives at one x-slab of particles.
//
// Replaces the TPU kernel barcode_tpu/forward/pallas_deposit.py:
// tsc_gather_grads_pallas_slab (z-first body _make_gather_kernel_zfirst).
// It is the exact adjoint of K3 (csrc/tsc_deposit_slab.cu) with respect to
// the extended buffer: the backward of the sharded deposit.  For each
// particle it returns sum_o dw_o/dx_i f(base + o) / d_i for i = x, y, z (and
// with want_value the value sum_o w_o f(base + o)), counting only the taps
// inside the field window of the particle's own (BX, BY) block:
//   * x: the particle's slab-local base (own row + min-image offset), with
//     the window [I*BX - h, I*BX + BX + h) around its block I = r / BX; the
//     tap reads extended row X + h, which always lies in [0, n1_loc + 2h);
//   * y: K2's gather window rule with halo h, wrapping periodically (the
//     TPU kernel's padded copies, pallas_deposit.py:761-762);
//   * z wraps.
// The derivatives are divided by the cell size at the end (:786).
//
// What bounds it on an H100: memory, as K2.  Design: K2's, one thread per
// particle and no shared memory; each output is written by one thread, so
// the result is deterministic.  The tiled gather
// (csrc/tsc_gather_tiled.cu, slab geometry) serves K4 on every path; this
// kernel stays built as its witness, reached only with `impl="thread"`.
#include "tsc_common.cuh"

namespace {

__global__ void tsc_gather_grads_slab_kernel(
    const float* __restrict__ field, const float* __restrict__ pos,
    float* __restrict__ out, int C, int n1_loc, int N1, int N2, int N3,
    float d1, float d2, float d3, int start, int BX, int BY, int h,
    int want_value) {
  const long long N = (long long)n1_loc * N2 * N3;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)C * N) return;
  const int c = (int)(t / N);
  const long long i = t - (long long)c * N;
  const int qy = (int)((i / N3) % N2);
  const int r = (int)(i / ((long long)N2 * N3));

  const float* p = pos + (long long)c * 3 * N;
  int bx, by, bz;
  float fx, fy, fz;
  tsc::base_frac(p[i], d1, &bx, &fx);
  tsc::base_frac(p[N + i], d2, &by, &fy);
  tsc::base_frac(p[2 * N + i], d3, &bz, &fz);
  const int bl = tsc::unwrap(bx, start + r, N1) - start;  // slab-local
  by = tsc::unwrap(by, qy, N2);
  bz = tsc::pos_mod(bz, N3);

  const int lo = (r / BX) * BX - h;
  int tx[3], ty[3], tz[3];
  bool mx[3], my[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int o = k - 1;
    const int X = bl + o;
    mx[k] = X >= lo && X < lo + BX + 2 * h;
    tx[k] = X + h;
    tsc::gather_axis(by, qy, N2, BY, h, o, &ty[k], &my[k]);
    tz[k] = tsc::pos_mod(bz + o, N3);
  }

  const long long n_ext = (long long)(n1_loc + 2 * h) * N2 * N3;
  const float* f = field + (long long)c * n_ext;
  const tsc::Gathered res = tsc::gather_taps(
      fx, fy, fz, mx, my, d1, d2, d3, [&](int a, int b, int k) {
        return __ldg(f + ((long long)tx[a] * N2 + ty[b]) * N3 + tz[k]);
      });

  float* o = out + (long long)c * (want_value ? 4 : 3) * N;
  if (want_value) {
    o[i] = res.val;
    o += N;
  }
  o[i] = res.gx;
  o[N + i] = res.gy;
  o[2 * N + i] = res.gz;
}

}  // namespace

// field: (C, n1_loc+2h, N2, N3) float32; pos: (C, 3, n1_loc, N2, N3); out:
// (C, want_value ? 4 : 3, n1_loc, N2, N3).  `start` is the slab's first
// global row.  Returns cudaGetLastError() after the launch.
extern "C" int tsc_gather_grads_slab_launch(
    const float* field, const float* pos, float* out, int C, int n1_loc,
    int N1, int N2, int N3, float d1, float d2, float d3, int start, int BX,
    int BY, int h, int want_value, void* stream) {
  const long long n = (long long)C * n1_loc * N2 * N3;
  const int threads = 256;
  tsc_gather_grads_slab_kernel<<<(unsigned)((n + threads - 1) / threads),
                                 threads, 0, (cudaStream_t)stream>>>(
      field, pos, out, C, n1_loc, N1, N2, N3, d1, d2, d3, start, BX, BY, h,
      want_value);
  return (int)cudaGetLastError();
}
