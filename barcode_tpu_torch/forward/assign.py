"""Mass assignment on the main path: TSC deposits, the halo-tail split and
the sph_ft Fourier kernel.

Port of barcode_tpu/forward/assign.py (main-path subset).  Two TSC deposits
live here and must not be confused:

  * `tsc_deposit` — the plain windowless 27-point scatter, the XLA-tier
    deposit of the JAX package (assign.py:174).  The mock data and the
    mass-2/3 likelihood force use it; the tail particles use its 27-tap
    arithmetic.  Both sum in 64-bit fixed point (`_exact_scatter`), so they
    are bit-identical from call to call on every device, as the JAX
    deposit is: a float `index_add_` on a CUDA tensor sums with atomics in
    an order that changes from run to run.
  * `make_tsc_deposit_fast` — the sampler's deposit: a
    `torch.autograd.Function` whose forward is kernel K1
    (`tsc_kernels.tsc_deposit_window`) and whose backward is kernel K2
    (`tsc_kernels.tsc_gather_grads_window`), with the optional halo-tail
    split (assign.py:441-516).

Positions are (3,) + grid or (C, 3) + grid for C chains.  NGP/CIC/SPH
deposits wait for a later slice (ROADMAP A.3).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.grid import fourier
from barcode_tpu_torch.forward import tsc_kernels as tk

_OFFSETS = (-1, 0, 1)
_TSC_OFFSETS = [(i, j, k) for i in _OFFSETS for j in _OFFSETS for k in _OFFSETS]


# ---------------------------------------------------------------------------
# TSC weights and the windowless deposit (assign.py:149-187)
# ---------------------------------------------------------------------------

def _tsc_axis_weight(dx, s):
    """TSC per-axis weight for offset s in {-1,0,1}; dx = distance from the
    containing cell's centre in cell units, |dx| <= 1/2."""
    if s == 0:
        return 0.75 - dx * dx
    return 0.5 * (1.5 - torch.abs(dx - s)) ** 2


def _tsc_axis_dweight(dx, s, d):
    """d/dpos of the per-axis TSC weight (1/d from dx = pos/d - ...)."""
    if s == 0:
        return -2.0 * dx / d
    return -(1.5 - torch.abs(dx - s)) * torch.sign(dx - s) / d


def _cell(g: GridSpec, like, ndim: int):
    return torch.tensor(g.cell, dtype=like.dtype,
                        device=like.device).reshape((3,) + (1,) * ndim)


def _tsc_base_frac(pos, g: GridSpec):
    """Wrapped base cells (int64, (..., 3) + grid) and fractions."""
    u = pos / _cell(g, pos, 3)
    base = torch.floor(u)
    n = torch.tensor(g.shape, device=pos.device).reshape(3, 1, 1, 1)
    return torch.remainder(base.long(), n), u - base - 0.5


def _tsc_weights(dx):
    w = [{s: _tsc_axis_weight(dx.select(-4, a), s) for s in _OFFSETS}
         for a in range(3)]
    return [w[0][ox] * w[1][oy] * w[2][oz] for ox, oy, oz in _TSC_OFFSETS]


def _batch_flat_offsets(batch: tuple, n: int, device, ndim: int):
    """Flat offset of each batch element into a flattened batch + (n,),
    shaped to broadcast against batch + `ndim` trailing axes."""
    if not batch:
        return 0
    return (torch.arange(math.prod(batch), device=device) * n).reshape(
        batch + (1,) * ndim)


class _ExactScatter(torch.autograd.Function):
    """out[idx_k] += src_k over k, summed in 64-bit fixed point.

    Each contribution is rounded to a multiple of 1/scale (K1's rule,
    `tsc_kernels._fixed_point_scale`) and added with an integer
    `index_add_`.  Integer addition does not depend on the order, so the
    result is bit-identical on every call and every device.  A cell that
    receives a non-finite contribution reads NaN.  The backward is the
    gather of the cotangent at each contribution's cell."""

    @staticmethod
    def forward(ctx, index, n_out: int, scale, *srcs):
        acc = torch.zeros(n_out, dtype=torch.int64, device=scale.device)
        n_bad = torch.zeros(n_out, dtype=torch.int32, device=scale.device)
        for k, src in enumerate(srcs):
            idx = index(k)
            finite = torch.isfinite(src)
            fixed = torch.round(torch.where(finite, src, 0.0).double() * scale)
            acc.index_add_(0, idx, fixed.long())
            n_bad.index_add_(0, idx, (~finite).int())
        ctx.index = index
        out = (acc.double() / scale).to(srcs[0].dtype)
        return out.masked_fill_(n_bad > 0, float("nan"))

    @staticmethod
    def backward(ctx, cot):
        return (None, None, None) + tuple(
            cot[ctx.index(k)] for k in range(len(ctx.needs_input_grad) - 3))


def _exact_scatter(index, n_out: int, srcs, max_sum_per_weight: int,
                   weights=None):
    """Deterministic sum of the flat contributions `srcs` into n_out cells;
    `index(k)` gives the flat cells of srcs[k].  No cell's sum exceeds
    max_sum_per_weight * max|weights| (1 for unit weights)."""
    w = None if weights is None else weights.detach()
    scale = tk._fixed_point_scale(w, max_sum_per_weight, srcs[0].device)
    return _ExactScatter.apply(index, n_out, scale, *srcs)


def tsc_deposit(pos, g: GridSpec, weights=None):
    """Windowless 27-point TSC deposit (getDensity_TSC), one scatter per
    stencil offset, summed exactly (`_exact_scatter`); differentiable
    through the positions and the weights."""
    base, dx = _tsc_base_frac(pos, g)
    ws = _tsc_weights(dx)
    if weights is not None:
        ws = [w * weights for w in ws]
    batch = tuple(pos.shape[:-4])
    c0 = _batch_flat_offsets(batch, g.N, pos.device, 3)
    bx, by, bz = base.unbind(-4)

    def index(k):
        ox, oy, oz = _TSC_OFFSETS[k]
        ix = torch.remainder(bx + ox, g.N1)
        iy = torch.remainder(by + oy, g.N2)
        iz = torch.remainder(bz + oz, g.N3)
        return (c0 + (ix * g.N2 + iy) * g.N3 + iz).reshape(-1)

    # each particle's 27 TSC weights sum to 1: a cell's total is at most
    # g.N * max|weight|
    out = _exact_scatter(index, math.prod(batch) * g.N,
                         [w.reshape(-1) for w in ws], g.N, weights)
    return out.reshape(batch + g.shape)


def auto_block_dep(g: GridSpec, halo, block: tuple) -> tuple:
    """Deposit block of the JAX package (assign.py:224-243): (16,16) when
    the grid divides it and its TPU working set fits, else `block`.  Kept
    so both packages use the same windows."""
    if g.N1 % 16 or g.N2 % 16:
        return block
    if tk.deposit_working_set_bytes(g, halo, (16, 16)) <= tk.DEP_VMEM_BUDGET:
        return (16, 16)
    if tk.deposit_working_set_bytes(g, halo, (16, 16),
                                    streamed=True) <= tk.DEP_VMEM_BUDGET:
        return (16, 16)
    return block


# ---------------------------------------------------------------------------
# Halo-tail split (assign.py:246-353)
# ---------------------------------------------------------------------------

def _halo_excess(pos, g: GridSpec, hx: int, hy: int):
    """Per-particle violation excess of the x/y contract |base - q| <= h-1
    (min-image, cells): > 0 iff the particle breaks it on either axis."""
    base = torch.floor(pos / _cell(g, pos, 3))
    qx = torch.arange(g.N1, dtype=pos.dtype, device=pos.device).reshape(g.N1, 1, 1)
    qy = torch.arange(g.N2, dtype=pos.dtype, device=pos.device).reshape(1, g.N2, 1)
    offx = torch.remainder(base.select(-4, 0) - qx + g.N1 / 2.0, g.N1) - g.N1 / 2.0
    offy = torch.remainder(base.select(-4, 1) - qy + g.N2 / 2.0, g.N2) - g.N2 / 2.0
    return torch.maximum(offx.abs() - (hx - 1), offy.abs() - (hy - 1))


def _compact_topk(m, k: int):
    """Exact top-k rows of the excess along the last axis.  The JAX package
    approximates this for its backend (assign.py:270-301); the two agree
    whenever the violators fit the capacity."""
    return torch.topk(m, min(k, m.shape[-1]), dim=-1)


def _tail_base_weights(pos_k, valid, g: GridSpec):
    """Wrapped flat cell indices (..., 27, K), TSC weights (..., 27, K) and
    fractions (..., 3, K) of K explicit tail particles pos_k (..., 3, K);
    invalid rows carry zero weight."""
    u = pos_k / _cell(g, pos_k, 1)
    base = torch.floor(u)
    fr = u - base - 0.5
    n = torch.tensor(g.shape, device=pos_k.device).reshape(3, 1)
    base = torch.remainder(base.long(), n)
    w = [{s: _tsc_axis_weight(fr.select(-2, a), s) for s in _OFFSETS}
         for a in range(3)]
    v = valid.to(pos_k.dtype)
    idx, wt = [], []
    for ox, oy, oz in _TSC_OFFSETS:
        ix = torch.remainder(base.select(-2, 0) + ox, g.N1)
        iy = torch.remainder(base.select(-2, 1) + oy, g.N2)
        iz = torch.remainder(base.select(-2, 2) + oz, g.N3)
        idx.append((ix * g.N2 + iy) * g.N3 + iz)
        wt.append(w[0][ox] * w[1][oy] * w[2][oz] * v)
    return torch.stack(idx, -2), torch.stack(wt, -2), fr


def _tail_deposit(pos_k, valid, g: GridSpec):
    """Exact 27-point TSC deposit of K tail particles per chain, summed in
    fixed point (`_exact_scatter`)."""
    idx, w, _ = _tail_base_weights(pos_k, valid, g)
    batch = tuple(pos_k.shape[:-2])
    c0 = _batch_flat_offsets(batch, g.N, pos_k.device, 2)
    flat = (idx + c0).reshape(-1)
    out = _exact_scatter(lambda k: flat, math.prod(batch) * g.N,
                         [w.reshape(-1)], pos_k.shape[-1])
    return out.reshape(batch + g.shape)


def _tail_weight_grad(cot, pos_k, valid, g: GridSpec):
    """(..., 3, K) position gradients of the tail deposit: the cotangent
    gathered at the 27 taps, contracted with the TSC weight derivatives."""
    idx, _, fr = _tail_base_weights(pos_k, valid, g)
    c = torch.gather(cot.flatten(-3), -1, idx.flatten(-2)).reshape(idx.shape)
    w = [{s: _tsc_axis_weight(fr.select(-2, a), s) for s in _OFFSETS}
         for a in range(3)]
    dw = [{s: _tsc_axis_dweight(fr.select(-2, a), s, g.cell[a])
           for s in _OFFSETS} for a in range(3)]
    out = [torch.zeros_like(c.select(-2, 0)) for _ in range(3)]
    for k, (ox, oy, oz) in enumerate(_TSC_OFFSETS):
        ck = c.select(-2, k)
        out[0] = out[0] + dw[0][ox] * w[1][oy] * w[2][oz] * ck
        out[1] = out[1] + w[0][ox] * dw[1][oy] * w[2][oz] * ck
        out[2] = out[2] + w[0][ox] * w[1][oy] * dw[2][oz] * ck
    return torch.stack(out, -2) * valid.to(cot.dtype).unsqueeze(-2)


class _WindowedDeposit(torch.autograd.Function):
    """Unit-mass TSC deposit: K1 forward, K2 backward, optional tail split.

    With tail_k > 0 the particles that break the (small, quantile) halo
    contract get weight 0 in K1 and a masked gradient from K2; up to tail_k
    of them per chain are compacted and deposited / differentiated exactly
    through the 27-point tail path (assign.py:482-516)."""

    @staticmethod
    def forward(ctx, pos, g, halo, block, block_dep, tail_k):
        ctx.g, ctx.halo, ctx.block, ctx.tail_k = g, halo, block, tail_k
        if tail_k == 0:
            ctx.save_for_backward(pos)
            return tk.tsc_deposit_window(pos, g, halo, block_dep)
        hx, hy = tk._halo_pair(halo)
        excess = _halo_excess(pos, g, hx, hy)
        ok = (excess <= 0.0).to(pos.dtype)
        rho = tk.tsc_deposit_window(pos, g, halo, block_dep, weights=ok)
        vals, idx = _compact_topk(excess.flatten(-3), tail_k)
        pos_k = torch.gather(pos.flatten(-3), -1,
                             idx.unsqueeze(-2).expand(idx.shape[:-1] + (3, -1)))
        valid = vals > 0.0
        ctx.save_for_backward(pos, ok, idx, pos_k, valid)
        return rho + _tail_deposit(pos_k, valid, g)

    @staticmethod
    def backward(ctx, cot):
        g = ctx.g
        cot = cot.contiguous()
        if ctx.tail_k == 0:
            (pos,) = ctx.saved_tensors
            out = tk.tsc_gather_grads_window(cot, pos, g, ctx.halo, ctx.block,
                                             want_value=False)
            return out, None, None, None, None, None
        pos, ok, idx, pos_k, valid = ctx.saved_tensors
        out = tk.tsc_gather_grads_window(cot, pos, g, ctx.halo, ctx.block,
                                         want_value=False)
        vk = _tail_weight_grad(cot, pos_k, valid, g)
        outf = (out * ok.unsqueeze(-4)).flatten(-3)
        outf = outf.scatter_add(-1, idx.unsqueeze(-2).expand_as(vk), vk)
        return outf.reshape(out.shape), None, None, None, None, None


def make_tsc_deposit_fast(g: GridSpec, halo: int = 8, block: tuple = (8, 8),
                          block_dep: tuple | None = None, tail_k: int = 0):
    """pos -> rho through the kernel deposit (assign.py:441-516).  `block`
    feeds the gather (K2), `block_dep` the deposit (K1; default from
    `auto_block_dep`).  Requires the halo contract |base - q| <= halo - 1
    in x/y, or tail_k > 0 for the exact tail split."""
    if block_dep is None:
        block_dep = auto_block_dep(g, halo, block)
    block, block_dep = tuple(block), tuple(block_dep)

    def dep(pos):
        return _WindowedDeposit.apply(pos, g, halo, block, block_dep, tail_k)

    return dep


# ---------------------------------------------------------------------------
# sph_ft kernel and overdensity
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _w4_fourier_host(g: GridSpec, h: float):
    """Closed-form 3D Fourier transform of the normalized W4 kernel on the
    half-complex grid, 1 at k=0, evaluated in float64 on the host because
    its numerator cancels to O(kappa^6) (assign.py:580-613):
        W4_hat = 24/kappa^6 (3 + cos 2kappa - kappa sin kappa
                             + cos kappa (kappa sin kappa - 4))."""
    def freqs(n, L):
        return 2.0 * np.pi * np.fft.fftfreq(n, d=L / n)

    kx = freqs(g.N1, g.L1)[:, None, None]
    ky = freqs(g.N2, g.L2)[None, :, None]
    kz = (2.0 * np.pi * np.fft.rfftfreq(g.N3, d=g.L3 / g.N3))[None, None, :]
    kap = np.sqrt(kx * kx + ky * ky + kz * kz) * h
    kap_safe = np.where(kap > 1e-8, kap, 1.0)
    ksink = kap_safe * np.sin(kap_safe)
    W = 24.0 * (3.0 + np.cos(2 * kap_safe) - ksink
                + np.cos(kap_safe) * (ksink - 4.0)) / kap_safe**6
    W = np.where(kap > 1e-8, W, 1.0)
    return np.asarray(W, np.float32)


@functools.lru_cache(maxsize=32)
def _w4_fourier_device(g: GridSpec, h: float, device: str):
    return torch.from_numpy(_w4_fourier_host(g, h)).to(device)


def w4_fourier(g: GridSpec, h: float, device=None):
    """The W4 transform as a float32 tensor (cached per grid, h, device)."""
    return _w4_fourier_device(g, float(h), str(torch.device(device or "cpu")))


def sph_ft_deposit(pos, g: GridSpec, h: float, weights=None):
    """TSC deposit convolved with the closed-form W4 transform."""
    rho = tsc_deposit(pos, g, weights)
    return fourier.irfft3(w4_fourier(g, h, pos.device) * fourier.rfft3(rho), g)


def deposit(pos, g: GridSpec, masskernel, h: float = 0.0, weights=None):
    """masskernel: 2/'tsc' or 'sph_ft' (the others wait for a later slice)."""
    mk = {0: "ngp", 1: "cic", 2: "tsc", 3: "sph"}.get(masskernel, masskernel)
    if mk == "tsc":
        return tsc_deposit(pos, g, weights)
    if mk == "sph_ft":
        return sph_ft_deposit(pos, g, h, weights)
    raise NotImplementedError(f"masskernel {masskernel!r} is not ported yet")


def overdens(rho):
    """delta = rho/mean(rho) - 1 per field (overdens, massFunctions.cc:30-47)."""
    return rho / rho.mean(dim=(-3, -2, -1), keepdim=True) - 1.0
