// K3: windowed 27-point TSC deposit of one x-slab of particles into its
// extended buffer [h + n1_loc + h, N2, N3].
//
// Replaces the TPU kernel barcode_tpu/forward/pallas_deposit.py:
// tsc_deposit_pallas_slab, both of its bodies (the block body _make_kernel
// and the streamed body _make_kernel_dma compute one function; the second
// exists only because of the TPU's VMEM budget).  The sharded forward model
// deposits each device's slab of particles into a buffer with h margin rows
// on either side in x and folds the margins into the neighbouring slabs
// afterwards (parallel/sharded_forward.py: _halo_exchange_add).
//
// Geometry, reproduced exactly from the TPU kernel's particle stack
// (pallas_deposit.py:_slab_channels and :688-704):
//   * a particle lives in local row r of the slab (global row start + r);
//     its x base cell is unwrapped to that row by the min-image offset and
//     made slab-local, then shifted by +h into extended coordinates;
//   * output block I (rows [I*BX, I*BX + BX) of the extended buffer) sums
//     only the particles whose extended row r + h lies in its window
//     [I*BX - h, I*BX + BX + h); taps outside [0, n1_ext) in x are dropped
//     (the TPU stack's dead rows), so nothing wraps in x;
//   * y is periodic through copies with +-N2 (K1's deposit window rule with
//     halo h); z wraps.
// A particle that breaks the halo contract therefore deposits PARTIAL mass,
// as on the TPU; the sharded deposit zero-weights such particles with the
// optional weight and deposits them exactly through its tail path.
//
// What bounds it on an H100: memory, as K1: it reads pos (12 B) and the
// weight (4 B) per particle and writes the extended buffer once.
//
// Design: K1's push design.  One thread per particle adds its up to 27 taps
// into a 64-bit fixed-point accumulator with integer atomics at the scale
// 2^e chosen by the caller (tsc_kernels._fixed_point_scale), so the result
// does not depend on the order the atomics land in: the same bits on every
// call.  A second pass converts to float32; a chain with a non-finite
// particle reads NaN.  Zero-weight particles return early.
#include "tsc_common.cuh"

namespace {

__global__ void tsc_deposit_slab_kernel(
    const float* __restrict__ pos, const float* __restrict__ weights,
    const double* __restrict__ scale_p, unsigned long long* __restrict__ acc,
    int* __restrict__ bad, int C, int n1_loc, int N1, int N2, int N3,
    float d1, float d2, float d3, int start, int BX, int BY, int h) {
  const long long N = (long long)n1_loc * N2 * N3;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)C * N) return;
  const float wm = weights != nullptr ? weights[t] : 1.0f;
  if (wm == 0.0f) return;
  const double scale = *scale_p;
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
  // slab-local x base, then extended coordinates
  const int bu = tsc::unwrap(bx, start + r, N1) - start + h;
  by = tsc::unwrap(by, qy, N2);
  bz = tsc::pos_mod(bz, N3);
  if (!(isfinite(fx) && isfinite(fy) && isfinite(fz) && isfinite(wm))) {
    bad[c] = 1;
    return;
  }

  const int n1_ext = n1_loc + 2 * h;
  const int q = r + h;  // the particle's extended row
  int tx[3], ty[3], tz[3];
  bool mx[3], my[3];
  float wx[3], wy[3], wz[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int o = k - 1;
    const int X = bu + o;
    const int lo = X >= 0 ? (X / BX) * BX - h : 0;
    tx[k] = X;
    mx[k] = X >= 0 && X < n1_ext && q >= lo && q < lo + BX + 2 * h;
    tsc::deposit_axis(by, qy, N2, BY, h, o, &ty[k], &my[k]);
    tz[k] = tsc::pos_mod(bz + o, N3);
    wx[k] = tsc::tsc_w(fx, o);
    wy[k] = tsc::tsc_w(fy, o);
    wz[k] = wm * tsc::tsc_w(fz, o);
  }

  unsigned long long* out = acc + (long long)c * n1_ext * N2 * N3;
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
        const long long v = __double2ll_rn((double)(wxy * wz[k]) * scale);
        atomicAdd(row + tz[k], (unsigned long long)v);
      }
    }
  }
}

// fixed point (two's complement in the unsigned accumulator) -> float32
__global__ void slab_fixed_to_float_kernel(
    const unsigned long long* __restrict__ acc,
    const double* __restrict__ scale_p, const int* __restrict__ bad,
    float* __restrict__ out, long long n_ext, long long n) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  out[t] = bad[t / n_ext] ? __int_as_float(0x7fc00000)
                          : (float)((double)(long long)acc[t] / *scale_p);
}

}  // namespace

// pos: (C, 3, n1_loc, N2, N3) float32; weights: (C, n1_loc, N2, N3) or
// null; acc: C*(n1_loc+2h)*N2*N3 zeros (int64); bad: C int zeros; scale_p:
// one double 2^e on the device; out: C*(n1_loc+2h)*N2*N3 floats.  `start`
// is the slab's first global row.  Returns cudaGetLastError() after the
// launches.
extern "C" int tsc_deposit_slab_launch(
    const float* pos, const float* weights, const double* scale_p,
    unsigned long long* acc, int* bad, float* out, int C, int n1_loc, int N1,
    int N2, int N3, float d1, float d2, float d3, int start, int BX, int BY,
    int h, void* stream) {
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)C * n1_loc * N2 * N3;
  tsc_deposit_slab_kernel<<<(unsigned)((n + threads - 1) / threads), threads,
                            0, s>>>(pos, weights, scale_p, acc, bad, C,
                                    n1_loc, N1, N2, N3, d1, d2, d3, start, BX,
                                    BY, h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n_ext = (long long)(n1_loc + 2 * h) * N2 * N3;
  const long long m = (long long)C * n_ext;
  slab_fixed_to_float_kernel<<<(unsigned)((m + threads - 1) / threads),
                               threads, 0, s>>>(acc, scale_p, bad, out, n_ext,
                                                m);
  return (int)cudaGetLastError();
}
