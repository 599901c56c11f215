// K1: windowed 27-point TSC deposit, one particle per Lagrangian cell.
//
// Replaces the TPU kernel barcode_tpu/forward/pallas_deposit.py:
// tsc_deposit_pallas (body _make_kernel + _deposit_rows).  It computes the
// same function, not plain TSC: each output xy block sums only the
// particles of its Lagrangian window (deposit_axis in tsc_common.cuh), so a
// particle that breaks the halo contract deposits PARTIAL mass exactly as
// on the TPU; z wraps periodically.  An optional per-particle weight
// multiplies every tap (the tail split zeroes contract violators with it).
//
// What bounds it on an H100: memory.  The function must read pos (12 B) and
// the weight (4 B) and write rho (4 B) per particle — 20 B against ~120
// flops, far below the card's 20 flop/B balance point in float32.
//
// Design: push, deterministic.  One thread per particle (chains are the
// slow part of the flat index, so one launch covers all chains) computes
// its base cells, fractions and window masks once, then adds up to 27
// contributions into a 64-bit fixed-point accumulator with integer
// atomicAdd.  Integer addition is associative, so the sums do not depend
// on the order the atomics land in: rho is bit-identical from run to run,
// as the JAX deposit is.  The fixed-point scale 2^e is chosen by the caller
// from max|weight| so that no cell can overflow (|sum| <= N max|w| <=
// 2^62); contributions are rounded to 2^-e (2^-41 for unit masses at
// 128^3), far below float32 resolution.  A second pass converts the
// accumulator to float32.  A particle with a non-finite position or weight
// marks its chain, whose whole rho then reads NaN (the float sum would be
// NaN in that particle's cells; psi is NaN either way).  Consecutive threads
// are consecutive z cells, so their loads coalesce and most of their
// atomics land on neighbouring addresses of the same rows.  Zero-weight
// particles return early.
#include "tsc_common.cuh"

namespace {

__global__ void tsc_deposit_window_kernel(
    const float* __restrict__ pos, const float* __restrict__ weights,
    const double* __restrict__ scale_p, unsigned long long* __restrict__ acc,
    int* __restrict__ bad, int C, int N1, int N2, int N3, float d1, float d2,
    float d3, int BX, int BY, int hx, int hy) {
  const long long N = (long long)N1 * N2 * N3;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)C * N) return;
  const float wm = weights != nullptr ? weights[t] : 1.0f;
  if (wm == 0.0f) return;
  const double scale = *scale_p;
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
  if (!(isfinite(fx) && isfinite(fy) && isfinite(fz) && isfinite(wm))) {
    bad[c] = 1;
    return;
  }

  int tx[3], ty[3], tz[3];
  bool mx[3], my[3];
  float wx[3], wy[3], wz[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int o = k - 1;
    tsc::deposit_axis(bx, qx, N1, BX, hx, o, &tx[k], &mx[k]);
    tsc::deposit_axis(by, qy, N2, BY, hy, o, &ty[k], &my[k]);
    tz[k] = tsc::pos_mod(bz + o, N3);
    wx[k] = tsc::tsc_w(fx, o);
    wy[k] = tsc::tsc_w(fy, o);
    wz[k] = wm * tsc::tsc_w(fz, o);
  }

  unsigned long long* out = acc + (long long)c * N;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (!mx[a]) continue;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      if (!my[b]) continue;
      const float wxy = wx[a] * wy[b];
      unsigned long long* row = out + ((long long)tx[a] * N2 + ty[b]) * N3;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const long long q = __double2ll_rn((double)(wxy * wz[k]) * scale);
        atomicAdd(row + tz[k], (unsigned long long)q);
      }
    }
  }
}

// fixed point (two's complement in the unsigned accumulator) -> float32
__global__ void fixed_to_float_kernel(const unsigned long long* __restrict__ acc,
                                      const double* __restrict__ scale_p,
                                      const int* __restrict__ bad,
                                      float* __restrict__ rho, long long N,
                                      long long n) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  rho[t] = bad[t / N] ? __int_as_float(0x7fc00000)
                      : (float)((double)(long long)acc[t] / *scale_p);
}

}  // namespace

// acc must hold C*N1*N2*N3 zeros (the 64-bit fixed-point accumulator)
// and bad C int zeros; scale_p is one double 2^e on the device; rho
// (C*N1*N2*N3 floats) receives the result.  weights may be null (unit
// masses).  Returns cudaGetLastError() after the launches.
extern "C" int tsc_deposit_window_launch(
    const float* pos, const float* weights, const double* scale_p,
    unsigned long long* acc, int* bad, float* rho, int C, int N1, int N2,
    int N3, float d1, float d2, float d3, int BX, int BY, int hx, int hy,
    void* stream) {
  const long long n = (long long)C * N1 * N2 * N3;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  tsc_deposit_window_kernel<<<(unsigned)blocks, threads, 0, s>>>(
      pos, weights, scale_p, acc, bad, C, N1, N2, N3, d1, d2, d3, BX, BY, hx,
      hy);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fixed_to_float_kernel<<<(unsigned)blocks, threads, 0, s>>>(
      acc, scale_p, bad, rho, (long long)N1 * N2 * N3, n);
  return (int)cudaGetLastError();
}

// Name of a CUDA error code returned by a launch function.
extern "C" const char* tsc_cuda_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
