// K2: windowed TSC gather of a field and its three position derivatives.
//
// Replaces the TPU kernel barcode_tpu/forward/pallas_deposit.py:
// tsc_gather_grads_pallas (bodies _make_gather_kernel_zfirst and
// _make_gather_kernel, which compute the same function).  For each particle
// it returns sum_o dw_o/dx_i f(base + o) / d_i for i = x, y, z (and, with
// want_value, the value sum_o w_o f(base + o)), counting only the taps inside
// the field window of the particle's Lagrangian block (gather_axis in
// tsc_common.cuh).  It is the position adjoint of K1: the backward of the
// deposit.
//
// What bounds it on an H100: memory.  It must read pos (12 B) and the field
// (4 B) and write 3 gradients (12 B) per particle — 28 B against ~235
// flops, below the card's float32 balance point of ~20 flop/B.
//
// Design: one thread per particle, no shared memory.  The 27 field taps of a
// warp fall on a few neighbouring z rows, so they are served from L1/L2
// after the first touch; the nine z-sums per particle are formed once and
// reused by all channels.  Each output is written by exactly one thread, so
// the result is deterministic.
//
// Every path on the card runs the tiled gather (csrc/tsc_gather_tiled.cu);
// this kernel stays built as its witness, the bit-for-bit yardstick reached
// only with `impl="thread"`.  Both take their per-particle arithmetic from
// tsc::gather_taps.
#include "tsc_common.cuh"

namespace {

__global__ void tsc_gather_grads_window_kernel(
    const float* __restrict__ field, const float* __restrict__ pos,
    float* __restrict__ out, int C, int N1, int N2, int N3, float d1,
    float d2, float d3, int BX, int BY, int hx, int hy, int want_value) {
  const long long N = (long long)N1 * N2 * N3;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)C * N) return;
  const int c = (int)(t / N);
  const long long i = t - (long long)c * N;
  const int qy = (int)((i / N3) % N2);
  const int qx = (int)(i / ((long long)N2 * N3));

  const float* p = pos + (long long)c * 3 * N;
  int bx, by, bz;
  float fx, fy, fz;
  tsc::base_frac(p[i], d1, &bx, &fx);
  tsc::base_frac(p[N + i], d2, &by, &fy);
  tsc::base_frac(p[2 * N + i], d3, &bz, &fz);
  bx = tsc::unwrap(bx, qx, N1);
  by = tsc::unwrap(by, qy, N2);
  bz = tsc::pos_mod(bz, N3);

  int tx[3], ty[3], tz[3];
  bool mx[3], my[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int o = k - 1;
    tsc::gather_axis(bx, qx, N1, BX, hx, o, &tx[k], &mx[k]);
    tsc::gather_axis(by, qy, N2, BY, hy, o, &ty[k], &my[k]);
    tz[k] = tsc::pos_mod(bz + o, N3);
  }

  const float* f = field + (long long)c * N;
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

// out holds C * (want_value ? 4 : 3) * N1*N2*N3 floats, laid out
// (C, channels, N1, N2, N3).  Returns cudaGetLastError() after the launch.
extern "C" int tsc_gather_grads_window_launch(
    const float* field, const float* pos, float* out, int C, int N1, int N2,
    int N3, float d1, float d2, float d3, int BX, int BY, int hx, int hy,
    int want_value, void* stream) {
  const long long n = (long long)C * N1 * N2 * N3;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  tsc_gather_grads_window_kernel<<<(unsigned)blocks, threads, 0,
                                   (cudaStream_t)stream>>>(
      field, pos, out, C, N1, N2, N3, d1, d2, d3, BX, BY, hx, hy, want_value);
  return (int)cudaGetLastError();
}
