// Shared pieces of the tiled kernels (csrc/tsc_deposit_tiled.cu: K1, K1s,
// K3; csrc/tsc_gather_tiled.cu: K2, K4): the exact integer helpers without a
// division, the block's Lagrangian tile, and the box of cells it stages in
// shared memory.
//
// `wrap` and `unwrap` give the result of tsc_common.cuh's forms for every
// input: a fast path where the argument lies near the grid, as every finite
// particle's does, and that form as the fallback elsewhere.
#pragma once

#include <cuda_runtime.h>

#include <climits>

#include "tsc_common.cuh"

namespace tsc {
namespace fast {

// pos_mod(x, n)
__device__ __forceinline__ int wrap(int x, int n) {
  if (x >= 0 && x < n) return x;
  if (x < 0 && x >= -n) return x + n;
  if (x >= n && x - n < n) return x - n;
  return tsc::pos_mod(x, n);
}

// tsc::unwrap(b, q, n): for |b - q| < n the min-image correction is -n, 0
// or +n
__device__ __forceinline__ int unwrap(int b, int q, int n) {
  const int off = b - q;
  if (off >= -n && off < n) {
    const int t = 2 * off + n;
    return t < 0 ? b + n : (t >= 2 * n ? b - n : b);
  }
  return tsc::unwrap(b, q, n);
}

// n / d for 0 <= n, d < 2^16 (box cells and extents), m = 2^32 / d + 1:
// n * m / 2^32 exceeds n / d by less than 2^-16, less than the distance of
// n / d from the next integer, so the floor is exact
__device__ __forceinline__ int div16(int n, unsigned long long m) {
  return (int)(((unsigned long long)n * m) >> 32);
}

// (x / B) * B for x >= 0; B a power of two takes a mask
__device__ __forceinline__ int block_start(int x, int B, bool pow2) {
  return pow2 ? (x & -B) : (x / B) * B;
}

// One axis of the DEPOSIT window rule (K1).  Output block I owns cells
// [I*B, I*B + B) and sums the particles whose (periodic copy of the)
// Lagrangian row lies in [I*B - h, I*B + B + h).  For the target X = bu + o,
// the copy shifted by s = wrap(X) - X is the one that lands in range, so the
// tap counts iff q + s lies in the window of the block owning wrap(X).
__device__ __forceinline__ bool deposit_axis(int bu, int q, int n, int B,
                                             bool pow2, int h, int o,
                                             int* target) {
  const int X = bu + o;
  const int Xw = wrap(X, n);
  const int qq = q + (Xw - X);
  const int lo = block_start(Xw, B, pow2) - h;
  *target = Xw;
  return qq >= lo && qq < lo + B + 2 * h;
}

// One axis of the GATHER window rule (K2): the particle's own block
// I = q / B reads the field window [I*B - h, I*B + B + h) (unwrapped);
// whether the tap at bu + o lies in it
__device__ __forceinline__ bool gather_window(int bu, int q, int B, bool pow2,
                                              int h, int o) {
  const int X = bu + o;
  const int lo = block_start(q, B, pow2) - h;
  return X >= lo && X < lo + B + 2 * h;
}

// ... and the tap's wrapped target
__device__ __forceinline__ bool gather_axis(int bu, int q, int n, int B,
                                            bool pow2, int h, int o,
                                            int* target) {
  *target = wrap(bu + o, n);
  return gather_window(bu, q, B, pow2, h, o);
}

}  // namespace fast

// A fixed Lagrangian tile of TX x TY x TZ particles of one chain (tile t:
// z tiles fastest, then y, then x), and this thread's particles in it:
// particle j of the thread is the tile's particle threadIdx.x + j *
// THREADS, z fastest, so consecutive threads read consecutive z.
template <int THREADS, int TX, int TY, int TZ>
struct Tile {
  static constexpr int PER = TX * TY * TZ / THREADS;  // particles a thread
  int x0, y0, z0;
  __device__ Tile(int t, int N2, int N3) {
    const int ntz = (N3 + TZ - 1) / TZ, nty = (N2 + TY - 1) / TY;
    z0 = t % ntz * TZ;
    y0 = t / ntz % nty * TY;
    x0 = t / (ntz * nty) * TX;
  }
  // the tile's particle i (0 <= i < TX * TY * TZ)
  __device__ __forceinline__ void at(int i, int& qx, int& qy, int& qz) const {
    const unsigned u = (unsigned)i;  // no sign fix-ups
    qz = z0 + (int)(u % TZ);
    qy = y0 + (int)(u / TZ % TY);
    qx = x0 + (int)(u / (TZ * TY));
  }
  __device__ __forceinline__ void coords(int j, int& qx, int& qy,
                                         int& qz) const {
    at((int)threadIdx.x + j * THREADS, qx, qy, qz);
  }
};

// min, max and sum of the base cells, and the count, over a warp
__device__ __forceinline__ void warp_reduce(int* mn, int* mx, long long* sm,
                                            int& cnt) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      mn[a] = min(mn[a], __shfl_xor_sync(0xffffffffu, mn[a], s));
      mx[a] = max(mx[a], __shfl_xor_sync(0xffffffffu, mx[a], s));
      sm[a] += __shfl_xor_sync(0xffffffffu, sm[a], s);
    }
    cnt += __shfl_xor_sync(0xffffffffu, cnt, s);
  }
}

// The block's box of cells, from each thread's min, max and sum of its
// particles' base cells and their count: [min - 1, max + 1] per axis over
// the block.  If that exceeds `cap` cells, the longest axis is cut by an
// eighth until it fits, and a cut axis is centred on the mean.  With
// zalign > 1 (a power of two) the z range is then widened to whole
// multiples of zalign, and x or y cut by one cell at a time until the box
// fits again.  Every thread of the block calls it; it returns the box's
// origin `lo` and extents `E` (0 when no particle was counted) to all of
// them.
template <int WARPS>
__device__ __forceinline__ void block_box(int* mn, int* mx, long long* sm,
                                          int cnt, int cap, int* lo, int* E,
                                          int zalign = 1) {
  __shared__ int s_min[WARPS][3], s_max[WARPS][3];
  __shared__ long long s_sum[WARPS][3];
  __shared__ int s_cnt[WARPS];
  __shared__ int s_lo[3], s_ext[3];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_reduce(mn, mx, sm, cnt);
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      s_min[warp][a] = mn[a];
      s_max[warp][a] = mx[a];
      s_sum[warp][a] = sm[a];
    }
    s_cnt[warp] = cnt;
  }
  __syncthreads();
  // warp 0 reduces the warps' partials across its lanes and picks the box
  if (warp == 0) {
    const bool has = lane < WARPS;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      mn[a] = has ? s_min[lane][a] : INT_MAX;
      mx[a] = has ? s_max[lane][a] : INT_MIN;
      sm[a] = has ? s_sum[lane][a] : 0;
    }
    cnt = has ? s_cnt[lane] : 0;
    warp_reduce(mn, mx, sm, cnt);
    if (lane == 0) {
      long long ext[3], full[3];
      for (int a = 0; a < 3; ++a) {
        full[a] = cnt > 0 ? (long long)mx[a] - mn[a] + 3 : 0;
        ext[a] = min(full[a], (long long)cap);
      }
      while (ext[0] * ext[1] * ext[2] > cap) {
        const int a = ext[0] >= ext[1] ? (ext[0] >= ext[2] ? 0 : 2)
                                       : (ext[1] >= ext[2] ? 1 : 2);
        ext[a] -= max(1ll, ext[a] / 8);
      }
      for (int a = 0; a < 3; ++a) {
        long long l = (long long)mn[a] - 1;
        if (ext[a] < full[a]) {  // cut: centre on the mean, inside the range
          l = sm[a] / cnt - ext[a] / 2;
          l = max((long long)mn[a] - 1, min(l, (long long)mx[a] + 2 - ext[a]));
        }
        s_lo[a] = (int)l;
        s_ext[a] = (int)ext[a];
      }
      if (zalign > 1 && s_ext[2] > 0) {
        const int l2 = s_lo[2] & -zalign;
        s_ext[2] = (s_lo[2] + s_ext[2] - l2 + zalign - 1) & -zalign;
        s_lo[2] = l2;
        while (s_ext[0] * s_ext[1] * s_ext[2] > cap)
          --s_ext[s_ext[0] >= s_ext[1] ? 0 : 1];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = s_lo[a];
    E[a] = s_ext[a];
  }
}

}  // namespace tsc
