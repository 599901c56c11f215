// K2 / K4: windowed TSC gather of a field and its three position
// derivatives, one kernel for the dense grid and for the extended x-slab,
// with the field staged in shared memory.
//
// Replaces the TPU kernels barcode_tpu/forward/pallas_deposit.py:
// tsc_gather_grads_pallas (call :572; bodies _make_gather_kernel_zfirst and
// _make_gather_kernel, which compute one function) and
// tsc_gather_grads_pallas_slab (call :770).
//
// The function: the phase A of tsc_common.cuh, the TPU kernels' window rule
// per tap, and the per-particle arithmetic of tsc::gather_taps, every
// rounding pinned, so each particle's outputs are the same bits whichever
// path (box or device memory) reads its taps.  With BF16 (the TPU kernels'
// `bf16` option) gather_taps rounds the field's taps, the z weights and
// their derivatives to bfloat16 before the z contraction, as the TPU's
// z-first body rounds its MXU operands (pallas_deposit.py:349, :398-401).
// The two geometries differ only in x, so the kernel is a template over an
// x rule:
//   * DenseX: periodic x, K2's gather window rule (the particle's own block
//     I = q / BX reads the window [I*BX - h, I*BX + BX + h));
//   * SlabX: the particle's row unwrapped to the slab, the window around
//     its block in slab rows, the tap reading extended row X + h; nothing
//     wraps in x (K4's geometry; a tap inside the window never leaves the
//     buffer).
// y follows K2's gather rule and z wraps in both.
//
// What bounds it on an H100: bytes in principle — pos (12 B), the field
// (4 B) and 3 gradients (12 B) a particle.  The one-thread-a-particle
// kernels it replaced were bound by their instruction count: a 64-bit
// division per index, about fifteen 32-bit divisions or modulos a particle
// in the window rules, and 27 scattered loads, each behind its mask.  This kernel runs
// at about 4x its bytes bound on an H100 (PERF.md): its taps are bound by
// issue, and its barrier phases (positions, box, fill) and the particles
// outside the box add to them, with two blocks an SM to overlap them.
// What measured faster on the card: the box and the positions staged by
// 16-byte cp.async (4-byte cp.async copies are bound by the load-store
// unit; plain loads stall on each other), the particles outside the box
// deferred to a packed second pass (inside a warp they made every lane
// wait for the slowest path), one tile a block (a persistent block walking
// tiles kept its two blocks an SM in step).
//
// Design: one block of 512 threads (two an SM) takes a fixed Lagrangian
// tile of 16^3 particles of one chain (tsc_tiled.cuh's Tile: coordinates
// from blockIdx and threadIdx, no division), so every block does the same
// work however the field has collapsed.
//   0. The tile's positions are copied into shared memory by cp.async, 16
//      bytes a copy where the rows allow it.
//   1. Each thread divides its 8 particles' by the cell (u = pos / d, kept
//      in place for steps 3 and 4) and finds their base cells, x and y
//      unwrapped to the particle's row (tsc::unwrap), z
//      likewise; the block reduces the cells of its finite, near particles
//      into a box [min - 1, max + 1] per axis, cut to `cap` cells
//      (tsc_tiled.cuh's block_box), its z range in whole 16-byte chunks.
//   2. The box is filled with the field's cells by cp.async, 16 bytes a copy
//      where the rows allow it: dense rows wrap in x, y and z; slab rows are
//      the extended buffer's own.
//   3. A particle whose 3 x 3 x 3 stencil lies in the box reads its taps
//      from shared memory with no per-tap test, under the window masks (no
//      wrapped targets needed).  Any other (far flung, a cut box,
//      non-finite) is put on a list.
//   4. The listed particles, packed into whole warps instead of diverging
//      inside them, read their taps from device memory at their wrapped
//      targets.
// Every integer helper is exact for every input (tsc_tiled.cuh), and each
// output is written by one thread, so the result is deterministic.  With
// `taps` non-null, the kernel also counts the taps inside the windows and
// those read from device memory.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "tsc_common.cuh"
#include "tsc_tiled.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int TX = 16, TY = 16, TZ = 16;  // a tile of particles
constexpr int TILE = TX * TY * TZ;

using Tile = tsc::Tile<THREADS, TX, TY, TZ>;
constexpr int PER = Tile::PER;

using tsc::fast::block_start;
using tsc::fast::div16;
using tsc::fast::gather_axis;
using tsc::fast::gather_window;
using tsc::fast::unwrap;
using tsc::fast::wrap;

// the dense grid's x: the base unwrapped to the row, K2's gather window rule
struct DenseX {
  int N1, BX, hx;
  __device__ __forceinline__ int base(int bx, int r) const {
    return unwrap(bx, r, N1);
  }
  __device__ __forceinline__ bool window(int bu, int r, int o,
                                         bool pow2) const {
    return gather_window(bu, r, BX, pow2, hx, o);
  }
  __device__ __forceinline__ int target(int bu, int o) const {
    return wrap(bu + o, N1);
  }
  // the field row of box row x
  __device__ __forceinline__ int row(int x) const { return wrap(x, N1); }
};

// the slab's x (K4): the base's extended row (the
// slab-local base, own row + min-image offset, shifted by +h)
struct SlabX {
  int N1, start, h, BX, n1_ext;
  __device__ __forceinline__ int base(int bx, int r) const {
    return unwrap(bx, start + r, N1) - start + h;
  }
  __device__ __forceinline__ bool window(int bu, int r, int o,
                                         bool pow2) const {
    const int X = bu - h + o;  // the slab-local tap row
    const int lo = block_start(r, BX, pow2) - h;
    return X >= lo && X < lo + BX + 2 * h;
  }
  __device__ __forceinline__ int target(int bu, int o) const {
    return bu + o;
  }
  // the buffer row of box row x, -1 outside the buffer (no tap inside a
  // window reads it)
  __device__ __forceinline__ int row(int x) const {
    return x >= 0 && x < n1_ext ? x : -1;
  }
};

// an asynchronous copy of V floats (1 or 4; 4 needs 16-byte alignment on
// both sides) from device memory into shared memory
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// The box's cells [lo, lo + E) from the field by cp.async, V floats a copy
// (E[2] and lo[2] multiples of V): dense rows wrap in x, y and z, slab rows
// outside the buffer are skipped (no tap inside a window reads them)
template <int V, class XRule>
__device__ __forceinline__ void fill_box(float* box, const float* f,
                                         const XRule& xr, const int* lo,
                                         const int* E, int N2, int N3) {
  const int Q = E[2] / V, n = E[0] * E[1] * Q;
  if (n == 0) return;
  const unsigned long long mq = (1ull << 32) / Q + 1,
                           m1 = (1ull << 32) / E[1] + 1;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int r = div16(i, mq), z = (i - r * Q) * V;
    const int x = div16(r, m1), y = r - x * E[1];
    const int X = xr.row(lo[0] + x);
    if (X < 0) continue;
    cp_async<V>(box + r * E[2] + z,
                f + ((long long)X * N2 + wrap(lo[1] + y, N2)) * N3 +
                    wrap(lo[2] + z, N3));
  }
}

// A particle's cells from u = pos / d: the fractions, the wrapped z base
// `bz`, and the box coordinates (b0, b1, b2): x and y unwrapped to the row
// (tsc::unwrap), z unwrapped likewise (congruent to
// bz).  `near`: finite, with |u| < 2^30 in x and y, where no base overflows
// and the unwrapped cells lie within half a grid of the particle's row.
struct Cell {
  int b0, b1, b2, bz;
  float f0, f1, f2;
  bool near;
};

template <class XRule>
__device__ __forceinline__ Cell phase_a(float u0, float u1, float u2,
                                        const XRule& xr, int qx, int qy,
                                        int qz, int N2, int N3) {
  Cell c;
  int bx, by, bz;
  tsc::base_frac_u(u0, &bx, &c.f0);
  tsc::base_frac_u(u1, &by, &c.f1);
  tsc::base_frac_u(u2, &bz, &c.f2);
  c.b0 = xr.base(bx, qx);
  c.b1 = unwrap(by, qy, N2);
  c.bz = wrap(bz, N3);
  c.b2 = unwrap(c.bz, qz, N3);
  c.near = fabsf(u0) < 0x1p30f && fabsf(u1) < 0x1p30f && isfinite(u2);
  return c;
}

// [value,] d/dx, d/dy, d/dz of one particle, N apart
__device__ __forceinline__ void store(const tsc::Gathered& res, float* o,
                                      long long N, int want_value) {
  if (want_value) {
    o[0] = res.val;
    o += N;
  }
  o[0] = res.gx;
  o[N] = res.gy;
  o[2 * N] = res.gz;
}

// blockIdx.x = tile (z fastest, then y, then x), blockIdx.y = chain.  R is
// the particle grid's x extent (N1 dense, n1_loc slab), field_rows the
// field's (N1 dense, n1_loc + 2h slab).  vec: 16-byte copies of the
// positions and the box's cells.  BF16: the bfloat16 z contraction.
template <class XRule, bool BF16>
__global__ void __launch_bounds__(THREADS, 2) tsc_gather_tiled_kernel(
    const float* __restrict__ field, const float* __restrict__ pos,
    float* __restrict__ out, unsigned long long* __restrict__ taps,
    const XRule xr, int R, int N2, int N3, int field_rows, float d1,
    float d2, float d3, int BY, int hy, int want_value, int cap, int vec) {
  extern __shared__ float smem[];
  float* box = smem;       // `cap` cells
  float* us = smem + cap;  // the tile's positions, then u: 3 x TILE
  // the tile's particles whose stencil leaves the box (tile indices)
  unsigned short* far = reinterpret_cast<unsigned short*>(us + 3 * TILE);
  __shared__ int n_far;

  const int c = blockIdx.y;
  const Tile tile((int)blockIdx.x, N2, N3);
  const long long N = (long long)R * N2 * N3;
  const float* p = pos + (long long)c * 3 * N;
  const float* f = field + (long long)c * field_rows * N2 * N3;
  float* oc = out + (long long)c * (want_value ? 4 : 3) * N;
  const bool pow2x = (xr.BX & (xr.BX - 1)) == 0, pow2y = (BY & (BY - 1)) == 0;
  unsigned n_out = 0, n_all = 0;

  // 0. the tile's positions into shared memory by cp.async: with vec, 16
  // bytes a copy (whole z rows: TZ divides N3), else one float a copy
  if (vec) {
    constexpr int CHUNKS = TILE / 4;  // of one coordinate
    static_assert(3 * CHUNKS % THREADS == 0, "whole chunks a thread");
#pragma unroll
    for (int t = 0; t < 3 * CHUNKS / THREADS; ++t) {
      const int k = threadIdx.x + t * THREADS;
      const int a = k / CHUNKS, i = (k - a * CHUNKS) * 4;
      int qx, qy, qz;
      tile.at(i, qx, qy, qz);
      if (qx < R && qy < N2)
        cp_async<4>(us + a * TILE + i,
                    p + a * N + ((long long)qx * N2 + qy) * N3 + qz);
    }
  } else {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      int qx, qy, qz;
      tile.coords(j, qx, qy, qz);
      if (qx >= R || qy >= N2 || qz >= N3) continue;
      const int i = threadIdx.x + j * THREADS;
      const float* pi = p + ((long long)qx * N2 + qy) * N3 + qz;
      cp_async<1>(us + i, pi);
      cp_async<1>(us + TILE + i, pi + N);
      cp_async<1>(us + 2 * TILE + i, pi + 2 * N);
    }
  }
  if (threadIdx.x == 0) n_far = 0;
  cp_async_wait_all();
  __syncthreads();

  // 1. the particles' cells and the tile's box
  int mn[3] = {INT_MAX, INT_MAX, INT_MAX};
  int mx[3] = {INT_MIN, INT_MIN, INT_MIN};
  long long sm[3] = {0, 0, 0};
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * THREADS;
    int qx, qy, qz;
    tile.coords(j, qx, qy, qz);
    if (qx >= R || qy >= N2 || qz >= N3) continue;
    const float u0 = us[i] / d1, u1 = us[TILE + i] / d2,
                u2 = us[2 * TILE + i] / d3;
    us[i] = u0;
    us[TILE + i] = u1;
    us[2 * TILE + i] = u2;
    const Cell cl = phase_a(u0, u1, u2, xr, qx, qy, qz, N2, N3);
    if (!cl.near) continue;
    const int b[3] = {cl.b0, cl.b1, cl.b2};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      mn[a] = min(mn[a], b[a]);
      mx[a] = max(mx[a], b[a]);
      sm[a] += b[a];
    }
    ++cnt;
  }
  int lo[3], E[3];
  tsc::block_box<WARPS>(mn, mx, sm, cnt, cap, lo, E, vec ? 4 : 1);

  // 2. the box's cells
  if (vec)
    fill_box<4>(box, f, xr, lo, E, N2, N3);
  else
    fill_box<1>(box, f, xr, lo, E, N2, N3);
  cp_async_wait_all();
  __syncthreads();

  // 3. the taps from the box
#pragma unroll 1
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * THREADS;
    int qx, qy, qz;
    tile.coords(j, qx, qy, qz);
    if (qx >= R || qy >= N2 || qz >= N3) continue;
    const Cell cl = phase_a(us[i], us[TILE + i], us[2 * TILE + i], xr, qx,
                            qy, qz, N2, N3);
    const int rx = cl.b0 - 1 - lo[0], ry = cl.b1 - 1 - lo[1],
              rz = cl.b2 - 1 - lo[2];
    if (!(rx >= 0 && rx < E[0] - 2 && ry >= 0 && ry < E[1] - 2 &&
          rz >= 0 && rz < E[2] - 2)) {
      far[atomicAdd(&n_far, 1)] = (unsigned short)i;  // for step 4
      continue;
    }
    bool mxk[3], myk[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      mxk[k] = xr.window(cl.b0, qx, k - 1, pow2x);
      myk[k] = gather_window(cl.b1, qy, BY, pow2y, hy, k - 1);
    }
    const float* cell = box + (rx * E[1] + ry) * E[2] + rz;
    const int e1 = E[1], e2 = E[2];
    store(tsc::gather_taps<BF16>(cl.f0, cl.f1, cl.f2, mxk, myk, d1, d2, d3,
                           [&](int a, int b, int k) {
                             return cell[(a * e1 + b) * e2 + k];
                           }),
          oc + ((long long)qx * N2 + qy) * N3 + qz, N, want_value);
    if (taps != nullptr)
      n_all += 3u * (mxk[0] + mxk[1] + mxk[2]) * (myk[0] + myk[1] + myk[2]);
  }
  __syncthreads();

  // 4. the listed particles, packed into whole warps: their taps from
  // device memory
  const int nf = n_far;
#pragma unroll 1
  for (int m = threadIdx.x; m < nf; m += THREADS) {
    const int i = far[m];
    int qx, qy, qz;
    tile.at(i, qx, qy, qz);
    const Cell cl = phase_a(us[i], us[TILE + i], us[2 * TILE + i], xr, qx,
                            qy, qz, N2, N3);
    int tx[3], ty[3], tz[3];
    bool mxk[3], myk[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int o = k - 1;
      mxk[k] = xr.window(cl.b0, qx, o, pow2x);
      tx[k] = xr.target(cl.b0, o);
      myk[k] = gather_axis(cl.b1, qy, N2, BY, pow2y, hy, o, &ty[k]);
      tz[k] = wrap(cl.bz + o, N3);
    }
    const tsc::Gathered res = tsc::gather_taps<BF16>(
        cl.f0, cl.f1, cl.f2, mxk, myk, d1, d2, d3, [&](int a, int b, int k) {
          return __ldg(f + ((long long)tx[a] * N2 + ty[b]) * N3 + tz[k]);
        });
    store(res, oc + ((long long)qx * N2 + qy) * N3 + qz, N, want_value);
    if (taps != nullptr) {
      const unsigned n =
          3u * (mxk[0] + mxk[1] + mxk[2]) * (myk[0] + myk[1] + myk[2]);
      n_all += n;
      n_out += n;
    }
  }
  if (taps != nullptr) {
    n_out = __reduce_add_sync(0xffffffffu, n_out);
    n_all = __reduce_add_sync(0xffffffffu, n_all);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(taps, (unsigned long long)n_out);
      atomicAdd(taps + 1, (unsigned long long)n_all);
    }
  }
}

// dynamic shared memory of a block: the box, the tile's positions (then u)
// and the list of far particles
size_t smem_bytes(int cap) {
  return sizeof(float) * ((size_t)cap + 3 * TILE) +
         sizeof(unsigned short) * TILE;
}

// the kernel's attributes: its dynamic shared memory, and the whole of the
// SM's unified L1/shared memory given to shared memory
template <class XRule, bool BF16>
cudaError_t configure(int cap) {
  auto kernel = tsc_gather_tiled_kernel<XRule, BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(cap));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// resident blocks an SM, or a negative CUDA error code
template <class XRule, bool BF16>
int blocks_per_sm(int cap) {
  cudaError_t err = configure<XRule, BF16>(cap);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, tsc_gather_tiled_kernel<XRule, BF16>, THREADS, smem_bytes(cap));
  return err == cudaSuccess ? n : -(int)err;
}

template <class XRule, bool BF16>
cudaError_t launch(const float* field, const float* pos, float* out,
                   unsigned long long* taps, const XRule& xr, int C, int R,
                   int N2, int N3, int field_rows, float d1, float d2,
                   float d3, int BY, int hy, int want_value, int cap, int vec,
                   cudaStream_t s) {
  cudaError_t err = configure<XRule, BF16>(cap);
  if (err != cudaSuccess) return err;
  const unsigned tiles = (unsigned)(((R + TX - 1) / TX) *
                                    ((N2 + TY - 1) / TY) *
                                    ((N3 + TZ - 1) / TZ));
  tsc_gather_tiled_kernel<XRule, BF16>
      <<<dim3(tiles, (unsigned)C), THREADS, smem_bytes(cap), s>>>(
          field, pos, out, taps, xr, R, N2, N3, field_rows, d1, d2, d3, BY,
          hy, want_value, cap, vec);
  return cudaGetLastError();
}

// Launches the (XRule, BF16) instance; `bf16` picks BF16 at run time.
template <class XRule>
cudaError_t launch_any(bool bf16, const float* field, const float* pos,
                       float* out, unsigned long long* taps, const XRule& xr,
                       int C, int R, int N2, int N3, int field_rows,
                       float d1, float d2, float d3, int BY, int hy,
                       int want_value, int cap, int vec, cudaStream_t s) {
  return bf16 ? launch<XRule, true>(field, pos, out, taps, xr, C, R, N2, N3,
                                    field_rows, d1, d2, d3, BY, hy,
                                    want_value, cap, vec, s)
              : launch<XRule, false>(field, pos, out, taps, xr, C, R, N2, N3,
                                     field_rows, d1, d2, d3, BY, hy,
                                     want_value, cap, vec, s);
}

}  // namespace

// field: (C, N1, N2, N3) dense or (C, R + 2*hx, N2, N3) slab; pos: (C, 3, R,
// N2, N3) float32; out: (C, want_value ? 4 : 3, R, N2, N3).  slab = 0: the
// dense grid (R = N1; `start` unused); slab = 1: slab rows [start, start +
// R) of the extended buffer, with hx = hy = h.  bf16 = 1: the bfloat16 z
// contraction.  `cap` is the box's cells (cap < 2^16).  `taps` is null, or
// two zeroed counters: the taps inside the windows read from device memory,
// and all taps inside the windows.  A tile is TX x TY x TZ particles.
// Returns the launch's CUDA error.
extern "C" int tsc_gather_tiled_launch(
    const float* field, const float* pos, float* out,
    unsigned long long* taps, int C, int R, int N1, int N2, int N3, float d1,
    float d2, float d3, int start, int BX, int BY, int hx, int hy, int slab,
    int bf16, int want_value, int cap, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  // 16-byte copies where every row of the field and the positions is
  // 16-byte aligned and the tiles hold whole z rows
  const int vec = N3 % TZ == 0 && cap % 4 == 0 &&
                  (uintptr_t)field % 16 == 0 && (uintptr_t)pos % 16 == 0;
  if (slab) {
    const SlabX xr{N1, start, hx, BX, R + 2 * hx};
    return (int)launch_any(bf16 != 0, field, pos, out, taps, xr, C, R, N2,
                           N3, R + 2 * hx, d1, d2, d3, BY, hy, want_value,
                           cap, vec, s);
  }
  const DenseX xr{N1, BX, hx};
  return (int)launch_any(bf16 != 0, field, pos, out, taps, xr, C, R, N2, N3,
                         N1, d1, d2, d3, BY, hy, want_value, cap, vec, s);
}

// Blocks of the dense (slab = 0) or slab kernel, float32 (bf16 = 0) or
// bfloat16 z contraction, resident on one SM at a box of `cap` cells, as
// the occupancy calculator reports it; a negative CUDA error code on
// failure.
extern "C" int tsc_gather_tiled_blocks_per_sm(int cap, int slab, int bf16) {
  if (slab)
    return bf16 ? blocks_per_sm<SlabX, true>(cap)
                : blocks_per_sm<SlabX, false>(cap);
  return bf16 ? blocks_per_sm<DenseX, true>(cap)
              : blocks_per_sm<DenseX, false>(cap);
}
