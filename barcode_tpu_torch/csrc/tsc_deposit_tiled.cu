// K1 / K1s / K3: windowed 27-point TSC deposit, one kernel for the dense
// grid and for the extended x-slab, accumulated in shared memory.
//
// Replaces the TPU kernels barcode_tpu/forward/pallas_deposit.py:
// tsc_deposit_pallas (both bodies: the blocked one, call :848, and the
// streamed one, _make_kernel_dma, call :829; the TPU picks the second only
// when its VMEM budget overflows, so on Hopper one kernel serves both) and
// tsc_deposit_pallas_slab (both bodies, calls :716 and :734).
//
// The function: the phase-A arithmetic of tsc_common.cuh, the TPU kernels'
// window rule per tap, the per-tap rounding __double2ll_rn((double)(wxy *
// wz) * scale) into a 64-bit fixed point at the caller's scale, integer sums
// (so the order of the additions does not matter), the float conversion,
// NaN for a chain with a non-finite particle, and zero-weight particles
// skipped.  With BF16 (the TPU kernels' `bf16` option, pallas_deposit.py:
// 230-233) the tap weight is bf16(wx * wy) * bf16(wm * wz), each factor
// rounded to bfloat16 (round to nearest even) and the product, exact, taken
// in float32, as the TPU's bf16 MXU dot forms it.  The two geometries
// differ only in x, so the kernel is a template over an x rule:
//   * DenseX: periodic x through K1's deposit window rule (deposit_axis);
//   * SlabX: extended rows [0, n1_loc + 2h), the particle's row unwrapped
//     to the slab and shifted by +h, the block window in extended rows,
//     taps outside the buffer dropped (K3's geometry).
// y follows K1's copy rule and z wraps in both.
//
// What bounds it on an H100: memory, as K1 — the function must read pos
// (12 B) and the weight (4 B) and write the output (4 B) per particle.  The
// push designs it replaced spent 27 global 64-bit atomics per particle,
// which run at the L2's atomic rate, not at the memory's.
//
// Design: one block of 512 threads takes a fixed Lagrangian tile of 16^3
// particles of one chain (z fastest, so loads coalesce), so every block does
// the same work however the field has collapsed.
//   0. The block zeroes its box while its particles' loads are in flight.
//   1. Each thread computes its particles' base cells (x/y/z unwrapped to
//      the particle's own row, so a tile's cells are contiguous across the
//      periodic seam) and the block reduces their min, max and mean.
//   2. The block anchors an int64 box in shared memory on [min - 1, max + 1]
//      per axis (tsc_tiled.cuh's block_box).  If that box exceeds `cap`
//      cells, the longest axis is cut by an eighth until it fits, and a cut
//      axis is centred on the mean.
//   3. Every tap that passes the window rule goes into the box with a
//      shared-memory atomic add, or, outside the box (a far-flung particle
//      or a cut axis), straight into the global accumulator: the result is
//      exact for any displacement.  A particle whose 27 cells all lie in
//      the box takes a path without the per-tap test.
//   4. The box is flushed once: one global atomic per nonzero cell, at the
//      cell's wrapped (dense) or extended (slab) target.
// A second pass converts the global accumulator to float32, as K1's.
//
// Measured on the card, the kernel is bound by instruction issue, not by
// bytes: the hot loops take no integer division where the arguments lie
// near the grid (tsc_tiled.cuh's exact fast paths, tsc_common.cuh's forms
// elsewhere), the per-tap rounding takes one conversion (`fixed`), the
// flush divides by multiplication (`div16`), and each thread's loads are
// issued before its arithmetic.
#include <cuda_runtime.h>

#include <climits>

#include "tsc_common.cuh"
#include "tsc_tiled.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int TX = 16, TY = 16, TZ = 16;  // a block's tile of particles

using tsc::fast::block_start;
using tsc::fast::deposit_axis;
using tsc::fast::div16;
using tsc::fast::unwrap;
using tsc::fast::wrap;

// the dense grid's x: unwrapped to the row, K1's deposit window rule
struct DenseX {
  int N1, BX, hx;
  __device__ __forceinline__ int base(int bx, int r) const {
    return unwrap(bx, r, N1);
  }
  __device__ __forceinline__ bool tap(int bu, int r, int o, bool pow2,
                                      int* t) const {
    return deposit_axis(bu, r, N1, BX, pow2, hx, o, t);
  }
  __device__ __forceinline__ int target(int X) const { return wrap(X, N1); }
};

// the slab's x (K3): extended rows, nothing wraps
struct SlabX {
  int N1, start, h, BX, n1_ext;
  __device__ __forceinline__ int base(int bx, int r) const {
    return unwrap(bx, start + r, N1) - start + h;
  }
  __device__ __forceinline__ bool tap(int bu, int r, int o, bool pow2,
                                      int* t) const {
    const int X = bu + o;
    const int lo = X >= 0 ? block_start(X, BX, pow2) - h : 0;
    const int q = r + h;
    *t = X;
    return X >= 0 && X < n1_ext && q >= lo && q < lo + BX + 2 * h;
  }
  __device__ __forceinline__ int target(int X) const { return X; }
};

// Adds v into a cell of the shared-memory box.  A 64-bit shared-memory
// atomic add compiles to a compare-and-swap loop on sm_90a
// (ATOMS.CAST.SPIN.64), much slower here, so the cell is two 32-bit words
// (little endian: the 8 bytes read back as the sum) added with native
// 32-bit atomics: the low word's old value gives the carry into the high
// word exactly, so the pair holds the 64-bit sum modulo 2^64 in any order
// of the additions.  The high add is issued even when it adds 0: a branch
// around it measured slower.
__device__ __forceinline__ void box_add(unsigned long long* cell,
                                        unsigned long long v) {
  unsigned* w = reinterpret_cast<unsigned*>(cell);
  const unsigned lo = (unsigned)v;
  const unsigned old = atomicAdd(w, lo);
  atomicAdd(w + 1, (unsigned)(v >> 32) + (old + lo < old ? 1u : 0u));
}

// K1's per-tap rounding __double2ll_rn((double)p * scale).  For a scale
// 2^e with 0 <= e <= 126, p * 2^e is exact in float32 as in float64, so
// rounding the float gives the same integer with one conversion fewer.
template <bool FLOAT_SCALE>
__device__ __forceinline__ long long fixed(float p, double scale,
                                           float scalef) {
  if (FLOAT_SCALE) return __float2ll_rn(p * scalef);
  return __double2ll_rn((double)p * scale);
}

// A particle's position and weight, as loaded; w = 0 outside the grid
struct Particle {
  float x, y, z, w;
};

// One particle's phase A (tsc_common.cuh): false for a zero-weight particle
// (skipped) and for a non-finite one (which marks its chain).  The x/y/z
// bases come back unwrapped to the particle's own row.
template <class XRule>
__device__ __forceinline__ bool phase_a(const Particle& pt, const XRule& xr,
                                        int qx, int qy, int qz, int N2,
                                        int N3, float d1, float d2, float d3,
                                        int& b0, int& b1, int& b2, float& f0,
                                        float& f1, float& f2, int& bad) {
  if (pt.w == 0.0f) return false;
  int bx, by, bz;
  tsc::base_frac(pt.x, d1, &bx, &f0);
  tsc::base_frac(pt.y, d2, &by, &f1);
  tsc::base_frac(pt.z, d3, &bz, &f2);
  if (!(isfinite(f0) && isfinite(f1) && isfinite(f2) && isfinite(pt.w))) {
    bad = 1;
    return false;
  }
  b0 = xr.base(bx, qx);
  b1 = unwrap(by, qy, N2);
  b2 = unwrap(bz, qz, N3);  // congruent to K1's wrapped z base
  return true;
}

using Tile = tsc::Tile<THREADS, TX, TY, TZ>;
constexpr int PER = Tile::PER;

// particle j's position and weight (weight 0 outside the grid); the weight
// does not gate the position loads, so all four are in flight together
__device__ __forceinline__ Particle load(const Tile& tile, const float* p,
                                         const float* w, long long N, int R,
                                         int N2, int N3, int j) {
  int qx, qy, qz;
  tile.coords(j, qx, qy, qz);
  if (qx >= R || qy >= N2 || qz >= N3) return Particle{0.0f, 0.0f, 0.0f, 0.0f};
  const long long gi = ((long long)qx * N2 + qy) * N3 + qz;
  return Particle{p[gi], p[N + gi], p[2 * N + gi],
                  w != nullptr ? w[gi] : 1.0f};
}

// 3. the taps of the block's particles, into the box or, outside it, into
// the global accumulator; with BF16 each tap weighs bf16(wx * wy) *
// bf16(wm * wz)
template <bool FLOAT_SCALE, bool BF16, class XRule>
__device__ __forceinline__ void deposit_taps(
    const float* p, const float* w, long long N, const XRule& xr,
    const Tile& tile, int R, int N2, int N3, float d1, float d2, float d3,
    int BY, int hy, bool pow2x, bool pow2y, double scale,
    unsigned long long* box, unsigned long long* out, int lo0, int lo1,
    int lo2, int E0, int E1, int E2) {
  const float scalef = (float)scale;
  int flag = 0;
  Particle next = load(tile, p, w, N, R, N2, N3, 0);
#pragma unroll 1
  for (int j = 0; j < PER; ++j) {
    const Particle pt = next;
    if (j + 1 < PER) next = load(tile, p, w, N, R, N2, N3, j + 1);
    int qx, qy, qz;
    tile.coords(j, qx, qy, qz);
    int b0, b1, b2;
    float f0, f1, f2;
    if (!phase_a(pt, xr, qx, qy, qz, N2, N3, d1, d2, d3, b0, b1, b2, f0, f1,
                 f2, flag))
      continue;
    const float wm = pt.w;
    int gx[3], gy[3], gz[3];
    bool mx[3], my[3], ix[3], iy[3], iz[3];
    float wx[3], wy[3], wz[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int o = k - 1;
      mx[k] = xr.tap(b0, qx, o, pow2x, &gx[k]);
      my[k] = deposit_axis(b1, qy, N2, BY, pow2y, hy, o, &gy[k]);
      gz[k] = wrap(b2 + o, N3);
      // box coordinates, unsigned so that any base compares safely
      ix[k] = (unsigned)(b0 + o) - (unsigned)lo0 < (unsigned)E0;
      iy[k] = (unsigned)(b1 + o) - (unsigned)lo1 < (unsigned)E1;
      iz[k] = (unsigned)(b2 + o) - (unsigned)lo2 < (unsigned)E2;
      wx[k] = tsc::tsc_w(f0, o);
      wy[k] = tsc::tsc_w(f1, o);
      wz[k] = tsc::bf16_round<BF16>(wm * tsc::tsc_w(f2, o));
    }
    const int rx = b0 - 1 - lo0, ry = b1 - 1 - lo1, rz = b2 - 1 - lo2;
    // the whole 3 x 3 x 3 stencil inside the box: no per-tap test (on an
    // H100, 17% faster on the 256^3 path's own positions, 3% slower on the
    // truth's clustered ones)
    if (rx >= 0 && rx < E0 - 2 && ry >= 0 && ry < E1 - 2 && rz >= 0 &&
        rz < E2 - 2) {
      unsigned long long* cell = box + (rx * E1 + ry) * E2 + rz;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        if (!mx[a]) continue;
#pragma unroll
        for (int bb = 0; bb < 3; ++bb) {
          if (!my[bb]) continue;
          const float wxy = tsc::bf16_round<BF16>(wx[a] * wy[bb]);
          unsigned long long* row = cell + (a * E1 + bb) * E2;
#pragma unroll
          for (int k = 0; k < 3; ++k)
            box_add(row + k, (unsigned long long)fixed<FLOAT_SCALE>(
                                 wxy * wz[k], scale, scalef));
        }
      }
      continue;
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      if (!mx[a]) continue;
#pragma unroll
      for (int bb = 0; bb < 3; ++bb) {
        if (!my[bb]) continue;
        const float wxy = tsc::bf16_round<BF16>(wx[a] * wy[bb]);
        const bool in_xy = ix[a] && iy[bb];
        const int row = ((rx + a) * E1 + (ry + bb)) * E2 + rz;
        unsigned long long* grow =
            out + ((long long)gx[a] * N2 + gy[bb]) * N3;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const unsigned long long v = (unsigned long long)fixed<FLOAT_SCALE>(
              wxy * wz[k], scale, scalef);
          if (in_xy && iz[k])
            box_add(box + row + k, v);
          else
            atomicAdd(grow + gz[k], v);
        }
      }
    }
  }
}

// blockIdx.x = tile (z fastest, then y, then x), blockIdx.y = chain.  R is
// the particle grid's x extent (N1 dense, n1_loc slab), out_rows the
// output's (N1 dense, n1_loc + 2h slab).
template <class XRule, bool BF16>
__global__ void __launch_bounds__(THREADS, 2) tsc_deposit_tiled_kernel(
    const float* __restrict__ pos, const float* __restrict__ weights,
    const double* __restrict__ scale_p, unsigned long long* __restrict__ acc,
    int* __restrict__ bad, const XRule xr, int R, int N2, int N3,
    int out_rows, float d1, float d2, float d3, int BX, int BY, int hy,
    int cap) {
  extern __shared__ unsigned long long box[];

  const int c = blockIdx.y;
  const Tile tile((int)blockIdx.x, N2, N3);
  const long long N = (long long)R * N2 * N3;
  const float* p = pos + (long long)c * 3 * N;
  const float* w = weights != nullptr ? weights + (long long)c * N : nullptr;

  // 0. the box's cells to zero (all `cap`, while the loads are in flight)
  for (int i = threadIdx.x; i < cap; i += THREADS) box[i] = 0ull;

  // 1. the tile's range of base cells
  int mn[3] = {INT_MAX, INT_MAX, INT_MAX}, mx[3] = {INT_MIN, INT_MIN, INT_MIN};
  long long sm[3] = {0, 0, 0};
  int cnt = 0, flag = 0;
  Particle pts[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) pts[j] = load(tile, p, w, N, R, N2, N3, j);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    int qx, qy, qz, b[3];
    float f0, f1, f2;
    tile.coords(j, qx, qy, qz);
    if (!phase_a(pts[j], xr, qx, qy, qz, N2, N3, d1, d2, d3, b[0], b[1],
                 b[2], f0, f1, f2, flag))
      continue;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      mn[a] = min(mn[a], b[a]);
      mx[a] = max(mx[a], b[a]);
      sm[a] += b[a];
    }
    ++cnt;
  }
  if (flag) bad[c] = 1;

  // 2. the box
  int lo[3], E[3];
  tsc::block_box<WARPS>(mn, mx, sm, cnt, cap, lo, E);
  const int lo0 = lo[0], lo1 = lo[1], lo2 = lo[2];
  const int E0 = E[0], E1 = E[1], E2 = E[2];

  // 3. the taps
  unsigned long long* out = acc + (long long)c * out_rows * N2 * N3;
  const double scale = *scale_p;
  const bool pow2x = (BX & (BX - 1)) == 0, pow2y = (BY & (BY - 1)) == 0;
  if (scale >= 1.0 && scale <= 0x1p126)
    deposit_taps<true, BF16>(p, w, N, xr, tile, R, N2, N3, d1, d2, d3, BY, hy,
                       pow2x, pow2y, scale, box, out, lo0, lo1, lo2, E0, E1,
                       E2);
  else
    deposit_taps<false, BF16>(p, w, N, xr, tile, R, N2, N3, d1, d2, d3, BY, hy,
                        pow2x, pow2y, scale, box, out, lo0, lo1, lo2, E0, E1,
                        E2);
  __syncthreads();

  // 4. the flush: one global atomic per nonzero cell
  const int n_box = E0 * E1 * E2;
  const unsigned long long m2 = n_box ? (1ull << 32) / E2 + 1 : 0,
                           m1 = n_box ? (1ull << 32) / E1 + 1 : 0;
  for (int i = threadIdx.x; i < n_box; i += THREADS) {
    const unsigned long long v = box[i];
    if (v == 0ull) continue;
    const int r = div16(i, m2), z = i - r * E2;
    const int x = div16(r, m1), y = r - x * E1;
    atomicAdd(out + ((long long)xr.target(lo0 + x) * N2 + wrap(lo1 + y, N2)) *
                        N3 + wrap(lo2 + z, N3),
              v);
  }
}

// fixed point (two's complement in the unsigned accumulator) -> float32;
// blockIdx.y is the chain, whose cells read NaN if it holds a non-finite
// particle
__global__ void tiled_fixed_to_float_kernel(
    const unsigned long long* __restrict__ acc,
    const double* __restrict__ scale_p, const int* __restrict__ bad,
    float* __restrict__ out, long long n_chain) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_chain) return;
  const long long i = blockIdx.y * n_chain + t;
  out[i] = bad[blockIdx.y] ? __int_as_float(0x7fc00000)
                           : (float)((double)(long long)acc[i] / *scale_p);
}

// the kernel's attributes: `cap` cells of dynamic shared memory, and the
// whole of the SM's unified L1/shared memory given to shared memory (the
// runtime's default carveout may leave room for one block only)
template <class XRule, bool BF16>
cudaError_t configure(int cap) {
  auto kernel = tsc_deposit_tiled_kernel<XRule, BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      cap * (int)sizeof(unsigned long long));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <class XRule, bool BF16>
cudaError_t launch(const float* pos, const float* weights,
                   const double* scale_p, unsigned long long* acc, int* bad,
                   const XRule& xr, int C, int R, int N2, int N3,
                   int out_rows, float d1, float d2, float d3, int BX, int BY,
                   int hy, int cap, cudaStream_t s) {
  cudaError_t err = configure<XRule, BF16>(cap);
  if (err != cudaSuccess) return err;
  const unsigned tiles = (unsigned)(((R + TX - 1) / TX) *
                                    ((N2 + TY - 1) / TY) *
                                    ((N3 + TZ - 1) / TZ));
  tsc_deposit_tiled_kernel<XRule, BF16>
      <<<dim3(tiles, (unsigned)C), THREADS,
         cap * sizeof(unsigned long long), s>>>(
          pos, weights, scale_p, acc, bad, xr, R, N2, N3, out_rows, d1, d2,
          d3, BX, BY, hy, cap);
  return cudaGetLastError();
}

// Launches the (XRule, BF16) instance; `bf16` picks BF16 at run time.
template <class XRule>
cudaError_t launch_any(bool bf16, const float* pos, const float* weights,
                       const double* scale_p, unsigned long long* acc,
                       int* bad, const XRule& xr, int C, int R, int N2,
                       int N3, int out_rows, float d1, float d2, float d3,
                       int BX, int BY, int hy, int cap, cudaStream_t s) {
  return bf16 ? launch<XRule, true>(pos, weights, scale_p, acc, bad, xr, C, R,
                                    N2, N3, out_rows, d1, d2, d3, BX, BY, hy,
                                    cap, s)
              : launch<XRule, false>(pos, weights, scale_p, acc, bad, xr, C,
                                     R, N2, N3, out_rows, d1, d2, d3, BX, BY,
                                     hy, cap, s);
}

// resident blocks an SM of the (XRule, BF16) instance, or a negative CUDA
// error code
template <class XRule, bool BF16>
int blocks_per_sm(int cap) {
  cudaError_t err = configure<XRule, BF16>(cap);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, tsc_deposit_tiled_kernel<XRule, BF16>, THREADS,
        cap * sizeof(unsigned long long));
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

// pos: (C, 3, R, N2, N3) float32; weights: (C, R, N2, N3) or null; acc:
// C*out_rows*N2*N3 int64 zeros; bad: C int zeros; scale_p: one double 2^e
// on the device (tsc_kernels._fixed_point_scale); out: C*out_rows*N2*N3
// floats.  slab = 0: the dense grid (R = out_rows = N1; `start` unused);
// slab = 1: slab rows [start, start + R) into out_rows = R + 2*hx extended
// rows, with hx = hy = h.  bf16 = 1: the bfloat16 tap weights.  `cap` is
// the box's cells (cap * 8 bytes of dynamic shared memory, cap < 2^16).
// One block takes TX x TY x TZ particles.  Returns the first CUDA error of
// the launches.
extern "C" int tsc_deposit_tiled_launch(
    const float* pos, const float* weights, const double* scale_p,
    unsigned long long* acc, int* bad, float* out, int C, int R, int N1,
    int N2, int N3, float d1, float d2, float d3, int start, int BX, int BY,
    int hx, int hy, int slab, int bf16, int cap, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int out_rows = slab ? R + 2 * hx : N1;
  cudaError_t err;
  if (slab) {
    const SlabX xr{N1, start, hx, BX, out_rows};
    err = launch_any(bf16 != 0, pos, weights, scale_p, acc, bad, xr, C, R,
                     N2, N3, out_rows, d1, d2, d3, BX, BY, hy, cap, s);
  } else {
    const DenseX xr{N1, BX, hx};
    err = launch_any(bf16 != 0, pos, weights, scale_p, acc, bad, xr, C, R,
                     N2, N3, out_rows, d1, d2, d3, BX, BY, hy, cap, s);
  }
  if (err != cudaSuccess) return (int)err;
  const long long n_chain = (long long)out_rows * N2 * N3;
  const int threads = 256;
  tiled_fixed_to_float_kernel<<<
      dim3((unsigned)((n_chain + threads - 1) / threads), (unsigned)C),
      threads, 0, s>>>(acc, scale_p, bad, out, n_chain);
  return (int)cudaGetLastError();
}

// Blocks of the dense (slab = 0) or slab kernel, float32 (bf16 = 0) or
// bfloat16 taps, resident on one SM at a box of `cap` cells, as the
// occupancy calculator reports it; a negative CUDA error code on failure.
extern "C" int tsc_deposit_tiled_blocks_per_sm(int cap, int slab, int bf16) {
  if (slab)
    return bf16 ? blocks_per_sm<SlabX, true>(cap)
                : blocks_per_sm<SlabX, false>(cap);
  return bf16 ? blocks_per_sm<DenseX, true>(cap)
              : blocks_per_sm<DenseX, false>(cap);
}

// Name of a CUDA error code returned by a launch function.
extern "C" const char* tsc_cuda_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
