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
  float wx[3], wy[3], wz[3], dwx[3], dwy[3], dwz[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int o = k - 1;
    tsc::gather_axis(bx, qx, N1, BX, hx, o, &tx[k], &mx[k]);
    tsc::gather_axis(by, qy, N2, BY, hy, o, &ty[k], &my[k]);
    tz[k] = tsc::pos_mod(bz + o, N3);
    wx[k] = tsc::tsc_w(fx, o);
    wy[k] = tsc::tsc_w(fy, o);
    wz[k] = tsc::tsc_w(fz, o);
    dwx[k] = tsc::tsc_dw(fx, o);
    dwy[k] = tsc::tsc_dw(fy, o);
    dwz[k] = tsc::tsc_dw(fz, o);
  }

  const float* f = field + (long long)c * N;
  float val = 0.0f, gx = 0.0f, gy = 0.0f, gz = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (!mx[a]) continue;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      if (!my[b]) continue;
      const float* row = f + ((long long)tx[a] * N2 + ty[b]) * N3;
      float s = 0.0f, sd = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float v = __ldg(row + tz[k]);
        s += wz[k] * v;
        sd += dwz[k] * v;
      }
      val += wx[a] * wy[b] * s;
      gx += dwx[a] * wy[b] * s;
      gy += wx[a] * dwy[b] * s;
      gz += wx[a] * wy[b] * sd;
    }
  }

  float* o = out + (long long)c * (want_value ? 4 : 3) * N;
  if (want_value) {
    o[i] = val;
    o += N;
  }
  o[i] = gx / d1;
  o[N + i] = gy / d2;
  o[2 * N + i] = gz / d3;
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
