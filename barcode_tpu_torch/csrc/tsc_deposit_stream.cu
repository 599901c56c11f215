// K1s: windowed 27-point TSC deposit, pull design, window streamed through
// shared memory.
//
// Replaces the TPU kernel barcode_tpu/forward/pallas_deposit.py:
// tsc_deposit_pallas(stream=True) (body _make_kernel_dma, call :826-845).
// On the TPU that body computes the same function as K1 and differs only in
// its memory schedule: the particle stack stays in HBM and x-row chunks of
// the block's Lagrangian window are copied by DMA into two VMEM slots, the
// copy of chunk c+1 overlapping the accumulation of chunk c.  So does this
// kernel, with shared memory for VMEM and cp.async for the DMA.
//
// The function (K1's, bit for bit): each output (BX, BY) block sums only
// the particles of its Lagrangian window [I*BX - hx, I*BX + BX + hx) x
// [J*BY - hy, J*BY + BY + hy), periodic in x and y; z wraps; a particle
// that breaks the halo contract deposits partial mass; an optional weight
// multiplies every tap.
//
// Design: pull, one owner per output cell.  The output column of one chain
// and one (BX, BY) block (I, J) is too large for one block's shared memory
// in K1's int64 fixed point (512 KB at (16, 16, 256)), so it is cut into
// z tiles of TZ cells, and the blocks of those tiles form one thread-block
// cluster (at most 8).  Each block holds its tile's accumulator in its own
// shared memory.  The cluster scans its window, WX x WY x N3 particles,
// once: its blocks take turns over chunks of CHUNK particles, each block
// streaming its chunks through two shared-memory stages by cp.async (the
// next chunk in flight while the current one is consumed).  A tap is added
// into the tile of the block that owns its z cell, through distributed
// shared memory.  The accumulator is K1's 64-bit fixed point with K1's
// per-tap rounding __double2ll_rn((double)(wxy * wz) * scale); integer
// atomics do not depend on the order, so K1s equals K1 exactly on equal
// inputs and from call to call.  Each tile is written once, as float32.  No
// global atomics, no global accumulator.
//
// The window rule from the pulling side: the block scans the unwrapped
// window row qw; the particle there is q = qw mod N seen through the
// periodic copy shifted by s = qw - q, and a tap counts iff its target
// X + s lies in the tile.  This is deposit_axis (tsc_common.cuh) read the
// other way round.  When the window is wider than the grid (WX > N, e.g.
// 32^3 with block 16 and hx 12) a particle is met through two copies; the
// tile is narrower than the grid, so each tap still lands through at most
// one of them, as in the JAX package's padded stack and in K1.
//
// What bounds it on an H100: memory, as K1 — the function must read pos
// (12 B) and the weight (4 B) and write rho (4 B) per particle.  This design
// reads each particle (WX*WY)/(BX*BY) times, once per window that holds it
// (about 15x at 256^3 with hx 24, hy 22), mostly from L2, and spends
// integer index arithmetic and three divisions on every visit; most visits
// end at the x/y test.  A first form without clusters read every window
// once per z tile, 8x more at 256^3.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tsc_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 1024;  // particles per shared-memory stage

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned saddr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(saddr),
                 "l"(src)
                 : "memory");
  }
}

// the accumulator's bytes, rounded up so the stages start 16-byte aligned
__host__ __device__ __forceinline__ size_t acc_bytes(int BX, int BY, int TZ) {
  return ((size_t)BX * BY * TZ * sizeof(unsigned long long) + 15) & ~(size_t)15;
}

// blockIdx.x = z tile + nzt * (J + nJ * I), blockIdx.y = chain; the nzt z
// tiles of one (I, J) form one cluster, in which block rank = z tile.
template <int VEC, bool WEIGHTED>
__global__ void __launch_bounds__(THREADS) tsc_deposit_stream_kernel(
    const float* __restrict__ pos, const float* __restrict__ weights,
    const double* __restrict__ scale_p, int* __restrict__ bad,
    float* __restrict__ rho, int N1, int N2, int N3, float d1, float d2,
    float d3, int BX, int BY, int hx, int hy, int TZ) {
  constexpr int NCH = WEIGHTED ? 4 : 3;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(smem);
  float* stage = reinterpret_cast<float*>(smem + acc_bytes(BX, BY, TZ));

  cg::cluster_group cluster = cg::this_cluster();
  const int nzt = (N3 + TZ - 1) / TZ;  // the cluster's size
  const int nJ = N2 / BY;
  const int zt = (int)cluster.block_rank();
  const int b = blockIdx.x / nzt;
  const int J = b % nJ;
  const int I = b / nJ;
  const int c = blockIdx.y;
  const int X0 = I * BX, Y0 = J * BY, Z0 = zt * TZ;
  const int TZL = min(TZ, N3 - Z0);
  const int WX = BX + 2 * hx, WY = BY + 2 * hy;
  const int total = WX * WY * N3;  // particles in the window
  const int n_chunks = (total + CHUNK - 1) / CHUNK;
  const long long N = (long long)N1 * N2 * N3;
  const float* pc = pos + (long long)c * 3 * N;
  const float* wc = WEIGHTED ? weights + (long long)c * N : nullptr;
  const double scale = *scale_p;

  for (int i = threadIdx.x; i < BX * BY * TZ; i += THREADS) acc[i] = 0ull;
  cluster.sync();  // every tile is zero before any block adds into it

  // window particle w = (xr * WY + yr) * N3 + z: z runs fastest, so VEC
  // consecutive particles (N3 % VEC == 0) are one aligned global segment
  auto load = [&](int chunk, int slot) {
    float* dst = stage + slot * NCH * CHUNK;
    const int w0 = chunk * CHUNK;
    for (int v = threadIdx.x; v < NCH * (CHUNK / VEC); v += THREADS) {
      const int ch = v / (CHUNK / VEC);
      const int e = (v - ch * (CHUNK / VEC)) * VEC;
      const int w = w0 + e;
      if (w >= total) continue;
      const int col = w / N3;
      const int z = w - col * N3;
      const int xr = col / WY;
      const int yr = col - xr * WY;
      const int qx = tsc::pos_mod(X0 - hx + xr, N1);
      const int qy = tsc::pos_mod(Y0 - hy + yr, N2);
      const long long gi = ((long long)qx * N2 + qy) * N3 + z;
      const float* src = ch < 3 ? pc + ch * N + gi : wc + gi;
      cp_async<VEC>(dst + ch * CHUNK + e, src);
    }
  };

  // this block's chunks: zt, zt + nzt, zt + 2 nzt, ...
  const int my_chunks = zt < n_chunks ? (n_chunks - zt + nzt - 1) / nzt : 0;
  if (my_chunks > 0) load(zt, 0);
  cp_async_commit();
  for (int i = 0; i < my_chunks; ++i) {
    const int k = zt + i * nzt;
    if (i + 1 < my_chunks) load(k + nzt, (i + 1) & 1);
    cp_async_commit();  // possibly empty: keeps "all but the newest" exact
    cp_async_wait_1();
    __syncthreads();
    const float* s = stage + (i & 1) * NCH * CHUNK;
    const int w0 = k * CHUNK;
    for (int e = threadIdx.x; e < CHUNK && w0 + e < total; e += THREADS) {
      const float wm = WEIGHTED ? s[3 * CHUNK + e] : 1.0f;
      if (wm == 0.0f) continue;
      const int w = w0 + e;
      const int col = w / N3;
      const int xr = col / WY;
      const int yr = col - xr * WY;
      // the copy of particle q = qw mod N shifted by s = qw - q
      const int qwx = X0 - hx + xr, qwy = Y0 - hy + yr;
      const int qx = tsc::pos_mod(qwx, N1), qy = tsc::pos_mod(qwy, N2);
      int bx, by, bz;
      float fx, fy, fz;
      tsc::base_frac(s[e], d1, &bx, &fx);
      tsc::base_frac(s[CHUNK + e], d2, &by, &fy);
      tsc::base_frac(s[2 * CHUNK + e], d3, &bz, &fz);
      // every particle is in its own block's window, so each non-finite
      // one marks its chain somewhere, as in K1
      if (!(isfinite(fx) && isfinite(fy) && isfinite(fz) && isfinite(wm))) {
        bad[c] = 1;
        continue;
      }
      const int lx0 = tsc::unwrap(bx, qx, N1) + (qwx - qx) - X0;
      const int ly0 = tsc::unwrap(by, qy, N2) + (qwy - qy) - Y0;
      if (lx0 + 1 < 0 || lx0 - 1 >= BX || ly0 + 1 < 0 || ly0 - 1 >= BY)
        continue;
      bz = tsc::pos_mod(bz, N3);

      // the z column of each tap in the tile of the block that owns it
      unsigned long long* zcol[3];
      float wx[3], wy[3], wz[3];
#pragma unroll
      for (int o = 0; o < 3; ++o) {
        int t = bz + o - 1;
        t = t < 0 ? t + N3 : (t >= N3 ? t - N3 : t);
        const int owner = t / TZ;
        zcol[o] = cluster.map_shared_rank(acc, owner) + (t - owner * TZ);
        wx[o] = tsc::tsc_w(fx, o - 1);
        wy[o] = tsc::tsc_w(fy, o - 1);
        wz[o] = wm * tsc::tsc_w(fz, o - 1);
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int lx = lx0 + a - 1;
        if (lx < 0 || lx >= BX) continue;
#pragma unroll
        for (int bb = 0; bb < 3; ++bb) {
          const int ly = ly0 + bb - 1;
          if (ly < 0 || ly >= BY) continue;
          const float wxy = wx[a] * wy[bb];
          const int cell = (lx * BY + ly) * TZ;
#pragma unroll
          for (int o = 0; o < 3; ++o) {
            const long long q = __double2ll_rn((double)(wxy * wz[o]) * scale);
            atomicAdd(zcol[o] + cell, (unsigned long long)q);
          }
        }
      }
    }
    __syncthreads();  // stage (i & 1) is refilled in the next iteration
  }
  cluster.sync();  // every tap of the cluster has landed

  // the tile, once, as float32 (z fastest: TZL consecutive floats per row)
  float* out = rho + (long long)c * N;
  const int n_tile = BX * BY * TZL;
  for (int i = threadIdx.x; i < n_tile; i += THREADS) {
    const int x = i / (BY * TZL);
    const int r = i - x * BY * TZL;
    const int y = r / TZL;
    const int z = r - y * TZL;
    const long long v = (long long)acc[(x * BY + y) * TZ + z];
    out[((long long)(X0 + x) * N2 + (Y0 + y)) * N3 + Z0 + z] =
        (float)((double)v / scale);
  }
}

// chains with a non-finite particle read NaN, as in K1's fixed_to_float
__global__ void nan_bad_chains_kernel(const int* __restrict__ bad,
                                      float* __restrict__ rho, long long N,
                                      long long n) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n && bad[t / N]) rho[t] = __int_as_float(0x7fc00000);
}

template <int VEC, bool WEIGHTED>
cudaError_t launch(const float* pos, const float* weights,
                   const double* scale_p, int* bad, float* rho, int C, int N1,
                   int N2, int N3, float d1, float d2, float d3, int BX,
                   int BY, int hx, int hy, int TZ, cudaStream_t s) {
  constexpr int NCH = WEIGHTED ? 4 : 3;
  const size_t smem =
      acc_bytes(BX, BY, TZ) + 2 * (size_t)NCH * CHUNK * sizeof(float);
  auto kernel = tsc_deposit_stream_kernel<VEC, WEIGHTED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nzt = (N3 + TZ - 1) / TZ;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((N1 / BX) * (N2 / BY) * nzt), (unsigned)C);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)nzt;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, pos, weights, scale_p, bad, rho, N1,
                           N2, N3, d1, d2, d3, BX, BY, hx, hy, TZ);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// bad must hold C int zeros; scale_p is one double 2^e on the device (the
// caller's rule, as K1's); rho (C*N1*N2*N3 floats) receives the result.
// weights may be null (unit masses).  vec is 4 when N3 % 4 == 0 and pos and
// weights are 16-byte aligned (16-byte copies), else 1.  BX*BY*TZ*8 bytes
// of accumulator plus the two stages must fit the block's shared memory,
// and ceil(N3 / TZ) (the cluster's size) must be at most 8.
// Returns the first CUDA error of the launches (cudaGetLastError()).
extern "C" int tsc_deposit_stream_launch(
    const float* pos, const float* weights, const double* scale_p, int* bad,
    float* rho, int C, int N1, int N2, int N3, float d1, float d2, float d3,
    int BX, int BY, int hx, int hy, int TZ, int vec, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  const bool w = weights != nullptr;
  if (vec == 4) {
    err = w ? launch<4, true>(pos, weights, scale_p, bad, rho, C, N1, N2, N3,
                              d1, d2, d3, BX, BY, hx, hy, TZ, s)
            : launch<4, false>(pos, weights, scale_p, bad, rho, C, N1, N2, N3,
                               d1, d2, d3, BX, BY, hx, hy, TZ, s);
  } else {
    err = w ? launch<1, true>(pos, weights, scale_p, bad, rho, C, N1, N2, N3,
                              d1, d2, d3, BX, BY, hx, hy, TZ, s)
            : launch<1, false>(pos, weights, scale_p, bad, rho, C, N1, N2, N3,
                               d1, d2, d3, BX, BY, hx, hy, TZ, s);
  }
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)C * N1 * N2 * N3;
  const int threads = 256;
  nan_bad_chains_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                          s>>>(bad, rho, (long long)N1 * N2 * N3, n);
  return (int)cudaGetLastError();
}
