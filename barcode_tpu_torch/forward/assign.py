"""Mass assignment: the NGP, CIC, TSC and SPH deposits, their gathers, the
halo-tail split and the sph_ft Fourier kernel.

Port of barcode_tpu/forward/assign.py.  Two kinds of deposit live here:

  * the windowless stencil deposits of the XLA tier (assign.py:43-221,
    :523-578): `ngp_deposit`, `cic_deposit`, `tsc_deposit`, `sph_deposit`
    and `sph_ft_deposit`, dispatched by `deposit`, and the gathers
    `cic_gather`, `tsc_gather` and `tsc_weight_grad_gather`.  Stencil
    offset k is one scatter at the wrapped base cell + offset k (index
    arithmetic with `remainder`; the TPU's roll trick is not needed).
    Every scatter sums in 64-bit fixed point (`_exact_scatter`), so a
    deposit has the same bits on every call and every device, as the JAX
    deposits do: a float `index_add_` on a CUDA tensor sums with atomics
    in an order that changes from run to run.  The SPH deposit is a
    `torch.autograd.Function` that keeps only its inputs and recomputes
    each offset's W4 slope in its backward.  The mock data, the mass-2/3
    likelihood force and every sampler deposit but the kernel one use
    these; the tail particles use the TSC deposit's 27-tap arithmetic.
  * `make_tsc_deposit_fast` — the sampler's kernel deposit: a
    `torch.autograd.Function` whose forward is kernel K1
    (`tsc_kernels.tsc_deposit_window`) and whose backward is kernel K2
    (`tsc_kernels.tsc_gather_grads_window`), with the optional halo-tail
    split (assign.py:441-516).

Positions are (3,) + grid or (C, 3) + grid for C chains.  They may lie
outside the box (radial RSD does not wrap them): the base cells wrap.  The
slab variants of the tail split (`_slab_halo_excess`, `_tail_deposit_slab`,
`_tail_weight_grad_slab`, assign.py:355-449) serve the sharded deposit
(parallel/sharded_forward).
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
# TSC weights (assign.py:149-180)
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
    return _wrap_base(base.long(), g), u - base - 0.5


def _tsc_weights(dx):
    w = [{s: _tsc_axis_weight(dx.select(-4, a), s) for s in _OFFSETS}
         for a in range(3)]
    return [w[0][ox] * w[1][oy] * w[2][oz] for ox, oy, oz in _TSC_OFFSETS]


# ---------------------------------------------------------------------------
# The exact scatter and the stencil helpers (assign.py:43-90)
# ---------------------------------------------------------------------------

def _batch_flat_offsets(batch: tuple, n: int, device, ndim: int):
    """Flat offset of each batch element into a flattened batch + (n,),
    shaped to broadcast against batch + `ndim` trailing axes."""
    if not batch:
        return 0
    return (torch.arange(math.prod(batch), device=device) * n).reshape(
        batch + (1,) * ndim)


def _fixed_point_sum(index, n_out: int, scale, srcs, dtype):
    """Sum the flat contributions `srcs` (any iterable: srcs[k] goes to the
    cells index(k)) in 64-bit fixed point.  Each is rounded to a multiple
    of 1/scale and added with an integer `index_add_`, whose result does
    not depend on the order.  A cell that receives a non-finite
    contribution reads NaN."""
    acc = torch.zeros(n_out, dtype=torch.int64, device=scale.device)
    n_bad = torch.zeros(n_out, dtype=torch.int32, device=scale.device)
    for k, src in enumerate(srcs):
        idx = index(k)
        finite = torch.isfinite(src)
        fixed = torch.round(torch.where(finite, src, 0.0).double() * scale)
        acc.index_add_(0, idx, fixed.long())
        n_bad.index_add_(0, idx, (~finite).int())
    out = (acc.double() / scale).to(dtype)
    return out.masked_fill_(n_bad > 0, float("nan"))


class _ExactScatter(torch.autograd.Function):
    """out[idx_k] += src_k over k, summed in 64-bit fixed point
    (`_fixed_point_sum` at K1's scale, `tsc_kernels._fixed_point_scale`),
    so the result is bit-identical on every call and every device.  The
    backward is the gather of the cotangent at each contribution's cell."""

    @staticmethod
    def forward(ctx, index, n_out: int, scale, *srcs):
        ctx.index = index
        return _fixed_point_sum(index, n_out, scale, srcs, srcs[0].dtype)

    @staticmethod
    def backward(ctx, cot):
        return (None, None, None) + tuple(
            cot[ctx.index(k)] for k in range(len(ctx.needs_input_grad) - 3))


def _exact_scatter(index, n_out: int, srcs, max_sum_per_weight: float,
                   weights=None):
    """Deterministic sum of the flat contributions `srcs` into n_out cells;
    `index(k)` gives the flat cells of srcs[k].  No cell's sum exceeds
    max_sum_per_weight * max|weights| (1 for unit weights)."""
    w = None if weights is None else weights.detach()
    scale = tk._fixed_point_scale(w, max_sum_per_weight, srcs[0].device)
    return _ExactScatter.apply(index, n_out, scale, *srcs)


def _wrap_base(base, g: GridSpec):
    """Base cells (int64, (..., 3) + particle shape) wrapped into the grid."""
    n = torch.tensor(g.shape, device=base.device).reshape(3, 1, 1, 1)
    return torch.remainder(base, n)


def _stencil_index(base, offsets, g: GridSpec):
    """index(k): the flat cells (batch elements laid end to end) that
    offset k of every particle reaches from its wrapped base cell."""
    c0 = _batch_flat_offsets(tuple(base.shape[:-4]), g.N, base.device, 3)
    bx, by, bz = base.unbind(-4)

    def index(k):
        ox, oy, oz = offsets[k]
        ix = torch.remainder(bx + ox, g.N1)
        iy = torch.remainder(by + oy, g.N2)
        iz = torch.remainder(bz + oz, g.N3)
        return (c0 + (ix * g.N2 + iy) * g.N3 + iz).reshape(-1)

    return index


def _n_particles(x) -> int:
    """Particles per chain of a position or particle-shaped tensor."""
    return math.prod(x.shape[-3:])


def _stencil_deposit(base, channel_weights, offsets, g: GridSpec,
                     max_sum_per_weight: float, weights=None):
    """sum over k of channel_weights[k] scattered at base + offsets[k],
    summed exactly (`_exact_scatter`), differentiable through the channel
    weights.  max_sum_per_weight bounds one cell's sum per unit of
    max|weights|."""
    shape = base.shape[:-4] + base.shape[-3:]
    out = _exact_scatter(_stencil_index(base, offsets, g),
                         math.prod(base.shape[:-4]) * g.N,
                         [w.expand(shape).reshape(-1) for w in channel_weights],
                         max_sum_per_weight, weights)
    return out.reshape(base.shape[:-4] + g.shape)


def _stencil_gather_multi(field, base, weight_sets, offsets, g: GridSpec):
    """out_m(p) = sum_k weight_sets[m][k](p) * field(base_p + offsets[k])
    for each weight set m, the K cells gathered once.  The particles need
    not be laid out like the grid; `field` is grid-shaped per batch element
    of `base` (or one grid for all)."""
    batch = tuple(base.shape[:-4])
    flat = field.expand(batch + g.shape).reshape(-1)
    index = _stencil_index(base, offsets, g)
    picked = [flat[index(k)].reshape(batch + base.shape[-3:])
              for k in range(len(offsets))]
    return [sum(w * p for w, p in zip(ws, picked)) for ws in weight_sets]


def _stencil_gather(field, base, channel_weights, offsets, g: GridSpec):
    """Mirror of _stencil_deposit: out(p) = sum_k w_k(p) field(base_p + o_k)."""
    return _stencil_gather_multi(field, base, [channel_weights], offsets, g)[0]


# ---------------------------------------------------------------------------
# NGP, CIC and TSC (assign.py:92-219)
# ---------------------------------------------------------------------------

def ngp_deposit(pos, g: GridSpec, weights=None):
    """Nearest grid point (getDensity_NGP, massFunctions.cc:49-98)."""
    base = _wrap_base(torch.floor(pos / _cell(g, pos, 3)).long(), g)
    w = torch.ones((), dtype=pos.dtype, device=pos.device) \
        if weights is None else weights
    return _stencil_deposit(base, [w], [(0, 0, 0)], g, _n_particles(pos),
                            weights)


_CIC_OFFSETS = [(i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1)]


def _cic_base_frac(pos, g: GridSpec):
    """Cell convention of getCICcells: base = floor(x/d - 1/2)
    (interpolate_grid.cpp:27-79)."""
    v = pos / _cell(g, pos, 3) - 0.5
    base = torch.floor(v)
    return _wrap_base(base.long(), g), v - base


def _cic_weights(frac):
    f = frac.unbind(-4)
    out = []
    for off in _CIC_OFFSETS:
        w = 1.0
        for a in range(3):
            w = w * (1.0 - f[a] if off[a] == 0 else f[a])
        out.append(w)
    return out


def cic_deposit(pos, g: GridSpec, weights=None):
    """Cloud-in-cell, 8-point (getDensity_CIC, massFunctions.cc:100-164)."""
    base, frac = _cic_base_frac(pos, g)
    ws = _cic_weights(frac)
    if weights is not None:
        ws = [w * weights for w in ws]
    # each particle's 8 weights sum to 1
    return _stencil_deposit(base, ws, _CIC_OFFSETS, g, _n_particles(pos),
                            weights)


def cic_gather(field, pos, g: GridSpec):
    """CIC interpolation of a grid field at particle positions
    (interpolate_CIC, interpolate_grid.cpp:82-120)."""
    base, frac = _cic_base_frac(pos, g)
    return _stencil_gather(field, base, _cic_weights(frac), _CIC_OFFSETS, g)


def tsc_deposit(pos, g: GridSpec, weights=None):
    """Windowless 27-point TSC deposit (getDensity_TSC,
    massFunctions.cc:167-364), differentiable through the positions and the
    weights."""
    base, dx = _tsc_base_frac(pos, g)
    ws = _tsc_weights(dx)
    if weights is not None:
        ws = [w * weights for w in ws]
    # each particle's 27 TSC weights sum to 1
    return _stencil_deposit(base, ws, _TSC_OFFSETS, g, _n_particles(pos),
                            weights)


def tsc_gather(field, pos, g: GridSpec):
    """TSC interpolation at particle positions (interpolate_TSC,
    interpolate_grid.cpp:134-202, with the wx[2]/wy[2] dz bug fixed)."""
    base, dx = _tsc_base_frac(pos, g)
    return _stencil_gather(field, base, _tsc_weights(dx), _TSC_OFFSETS, g)


def tsc_weight_grad_gather(cot, pos, g: GridSpec):
    """V_i(p) = sum_o d(w_o)/d(pos_i) * cot(base_p + o), stacked on the
    component axis -4: the position-adjoint of the TSC deposit, its 27
    cells gathered once for the three derivative weight sets."""
    base, dx = _tsc_base_frac(pos, g)
    f = dx.unbind(-4)
    weight_sets = []
    for i in range(3):
        ws = []
        for off in _TSC_OFFSETS:
            w = 1.0
            for a in range(3):
                w = w * (_tsc_axis_dweight(f[a], off[a], g.cell[a]) if a == i
                         else _tsc_axis_weight(f[a], off[a]))
            ws.append(w)
        weight_sets.append(ws)
    return torch.stack(_stencil_gather_multi(cot, base, weight_sets,
                                             _TSC_OFFSETS, g), dim=-4)


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


def _slab_halo_excess(pos, g: GridSpec, n1_loc: int, dev: int, h: int):
    """Per-particle excess of the SLAB kernel-halo contract |off| <= h - 1
    (assign.py:355-367): x relative to the particle's own row of slab
    `dev`, y global min-image, as in tsc_kernels._slab_channels."""
    base = torch.floor(pos / _cell(g, pos, 3))
    qx = torch.arange(n1_loc, dtype=pos.dtype,
                      device=pos.device).reshape(n1_loc, 1, 1)
    qy = torch.arange(g.N2, dtype=pos.dtype, device=pos.device).reshape(1, g.N2, 1)
    offx = torch.remainder(base.select(-4, 0) - (dev * n1_loc + qx)
                           + g.N1 / 2.0, g.N1) - g.N1 / 2.0
    offy = torch.remainder(base.select(-4, 1) - qy + g.N2 / 2.0, g.N2) - g.N2 / 2.0
    return torch.maximum(offx.abs() - (h - 1), offy.abs() - (h - 1))


def _tail_base_weights_slab(pos_k, row_k, valid, g: GridSpec, n1_loc: int,
                            h_x: int, slab_start: int):
    """Extended-buffer flat indices (..., 27, K), TSC weights (..., 27, K),
    fractions (..., 3, K) and x base rows (..., K) of K slab tail particles
    (assign.py:370-403): x is the own local row + min-image offset + h_x
    with no wrap (taps leaving [0, n1_loc + 2 h_x) get weight 0), y and z
    wrap."""
    n1_ext = n1_loc + 2 * h_x
    u = pos_k / _cell(g, pos_k, 1)
    base = torch.floor(u)
    fr = u - base - 0.5
    row = row_k.to(pos_k.dtype)
    offx = torch.remainder(base.select(-2, 0) - (slab_start + row)
                           + g.N1 / 2.0, g.N1) - g.N1 / 2.0
    bx = (row + offx).long() + h_x
    by = torch.remainder(base.select(-2, 1).long(), g.N2)
    bz = torch.remainder(base.select(-2, 2).long(), g.N3)
    w = [{s: _tsc_axis_weight(fr.select(-2, a), s) for s in _OFFSETS}
         for a in range(3)]
    v = valid.to(pos_k.dtype)
    idx, wt = [], []
    for ox, oy, oz in _TSC_OFFSETS:
        ix = bx + ox
        in_range = ((ix >= 0) & (ix < n1_ext)).to(pos_k.dtype)
        ix = torch.clamp(ix, 0, n1_ext - 1)
        iy = torch.remainder(by + oy, g.N2)
        iz = torch.remainder(bz + oz, g.N3)
        idx.append((ix * g.N2 + iy) * g.N3 + iz)
        wt.append(w[0][ox] * w[1][oy] * w[2][oz] * v * in_range)
    return torch.stack(idx, -2), torch.stack(wt, -2), fr, bx


def _tail_deposit_slab(pos_k, row_k, valid, g: GridSpec, n1_loc: int,
                       h_x: int, slab_start: int):
    """Exact 27-point TSC deposit of K slab tail particles per chain into
    the (..., n1_loc + 2 h_x, N2, N3) extended buffer, summed in fixed point
    (`_exact_scatter`)."""
    idx, w, _, _ = _tail_base_weights_slab(pos_k, row_k, valid, g, n1_loc,
                                           h_x, slab_start)
    n_ext = (n1_loc + 2 * h_x) * g.N2 * g.N3
    batch = tuple(pos_k.shape[:-2])
    c0 = _batch_flat_offsets(batch, n_ext, pos_k.device, 2)
    flat = (idx + c0).reshape(-1)
    out = _exact_scatter(lambda k: flat, math.prod(batch) * n_ext,
                         [w.reshape(-1)], pos_k.shape[-1])
    return out.reshape(batch + (n1_loc + 2 * h_x, g.N2, g.N3))


def _tail_weight_grad_slab(cot_ext, pos_k, row_k, valid, g: GridSpec,
                           n1_loc: int, h_x: int, slab_start: int):
    """(..., 3, K) position gradients of the slab tail deposit against the
    extended-buffer cotangent (assign.py:424-449)."""
    idx, _, fr, bx = _tail_base_weights_slab(pos_k, row_k, valid, g, n1_loc,
                                             h_x, slab_start)
    n1_ext = n1_loc + 2 * h_x
    c = torch.gather(cot_ext.flatten(-3), -1, idx.flatten(-2)).reshape(
        idx.shape)
    w = [{s: _tsc_axis_weight(fr.select(-2, a), s) for s in _OFFSETS}
         for a in range(3)]
    dw = [{s: _tsc_axis_dweight(fr.select(-2, a), s, g.cell[a])
           for s in _OFFSETS} for a in range(3)]
    out = [torch.zeros_like(c.select(-2, 0)) for _ in range(3)]
    for k, (ox, oy, oz) in enumerate(_TSC_OFFSETS):
        in_r = ((bx + ox >= 0) & (bx + ox < n1_ext)).to(cot_ext.dtype)
        ck = c.select(-2, k) * in_r
        out[0] = out[0] + dw[0][ox] * w[1][oy] * w[2][oz] * ck
        out[1] = out[1] + w[0][ox] * dw[1][oy] * w[2][oz] * ck
        out[2] = out[2] + w[0][ox] * w[1][oy] * dw[2][oz] * ck
    return torch.stack(out, -2) * valid.to(cot_ext.dtype).unsqueeze(-2)


class _WindowedDeposit(torch.autograd.Function):
    """Unit-mass TSC deposit: K1 forward, K2 backward, optional tail split.

    With tail_k > 0 the particles that break the (small, quantile) halo
    contract get weight 0 in K1 and a masked gradient from K2; up to tail_k
    of them per chain are compacted and deposited / differentiated exactly
    through the 27-point tail path (assign.py:482-516), in float32 whatever
    `bf16_fwd` and `bf16_bwd` select for K1 and K2."""

    @staticmethod
    def forward(ctx, pos, g, halo, block, block_dep, tail_k, bf16_fwd,
                bf16_bwd):
        ctx.g, ctx.halo, ctx.block, ctx.tail_k = g, halo, block, tail_k
        ctx.bf16_bwd = bf16_bwd
        if tail_k == 0:
            ctx.save_for_backward(pos)
            return tk.tsc_deposit_window(pos, g, halo, block_dep,
                                         bf16=bf16_fwd)
        hx, hy = tk._halo_pair(halo)
        excess = _halo_excess(pos, g, hx, hy)
        ok = (excess <= 0.0).to(pos.dtype)
        rho = tk.tsc_deposit_window(pos, g, halo, block_dep, weights=ok,
                                    bf16=bf16_fwd)
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
        nones = (None,) * 7
        if ctx.tail_k == 0:
            (pos,) = ctx.saved_tensors
            out = tk.tsc_gather_grads_window(cot, pos, g, ctx.halo, ctx.block,
                                             want_value=False,
                                             bf16=ctx.bf16_bwd)
            return (out,) + nones
        pos, ok, idx, pos_k, valid = ctx.saved_tensors
        out = tk.tsc_gather_grads_window(cot, pos, g, ctx.halo, ctx.block,
                                         want_value=False, bf16=ctx.bf16_bwd)
        vk = _tail_weight_grad(cot, pos_k, valid, g)
        outf = (out * ok.unsqueeze(-4)).flatten(-3)
        outf = outf.scatter_add(-1, idx.unsqueeze(-2).expand_as(vk), vk)
        return (outf.reshape(out.shape),) + nones


def make_tsc_deposit_fast(g: GridSpec, halo: int = 8, block: tuple = (8, 8),
                          block_dep: tuple | None = None, tail_k: int = 0,
                          bf16_fwd: bool = False, bf16_bwd: bool = False):
    """pos -> rho through the kernel deposit (assign.py:441-516).  `block`
    feeds the gather (K2), `block_dep` the deposit (K1; default from
    `auto_block_dep`).  Requires the halo contract |base - q| <= halo - 1
    in x/y, or tail_k > 0 for the exact tail split.  `bf16_fwd` and
    `bf16_bwd` select the TPU kernels' bf16 option for K1 and K2 (input.par's
    `pallas_bf16_dep` and `pallas_bf16_grad`)."""
    if block_dep is None:
        block_dep = auto_block_dep(g, halo, block)
    block, block_dep = tuple(block), tuple(block_dep)

    def dep(pos):
        return _WindowedDeposit.apply(pos, g, halo, block, block_dep, tail_k,
                                      bool(bf16_fwd), bool(bf16_bwd))

    return dep


# ---------------------------------------------------------------------------
# SPH: the Monaghan W4 cubic spline, kernel radius 2h (assign.py:519-578)
# ---------------------------------------------------------------------------

def w4(q):
    """Monaghan W4 spline (unnormalized; callers apply the 1/(pi h^3) norm),
    SPH_kernel_3D, massFunctions.cc:366-385."""
    q = torch.abs(q)
    inner = 1.0 - 1.5 * q * q + 0.75 * q * q * q
    outer = 0.25 * torch.clamp(2.0 - q, min=0.0) ** 3
    return torch.where(q <= 1.0, inner, torch.where(q <= 2.0, outer, 0.0))


def _w4_slope(q):
    """dW4/dq for q >= 0: -3q + 2.25q^2 inside, -0.75(2 - q)^2 out to 2."""
    return torch.where(q <= 1.0, -3.0 * q + 2.25 * q * q,
                       torch.where(q <= 2.0, -0.75 * (2.0 - q) ** 2, 0.0))


def sph_stencil(g: GridSpec, h: float):
    """The cell offsets within kernel reach 2h (+ a half-cell margin), as
    SPH_kernel_3D_cells (SPH_kernel.cpp:62-102)."""
    d1, d2, d3 = g.cell
    reach = 2.0 * h
    r1 = int(reach / d1) + 1
    r2 = int(reach / d2) + 1
    r3 = int(reach / d3) + 1
    out = []
    for i in range(-r1, r1 + 1):
        for j in range(-r2, r2 + 1):
            for k in range(-r3, r3 + 1):
                dx = (abs(i) - 0.5) * d1
                dy = (abs(j) - 0.5) * d2
                dz = (abs(k) - 0.5) * d3
                if dx * dx + dy * dy + dz * dz <= reach * reach:
                    out.append((i, j, k))
    return out


def sph_max_sum_per_weight(g: GridSpec, h: float, n_part: int) -> float:
    """Bound on one cell's SPH sum per unit of max|weight|: every particle
    adds at most its largest tap, norm * W4(0), as often as its stencil
    reaches that cell (more than once per axis where the stencil is wider
    than the grid)."""
    offsets = sph_stencil(g, h)
    hits = 1
    for a, n in enumerate(g.shape):
        span = max(o[a] for o in offsets) - min(o[a] for o in offsets) + 1
        hits *= -(-span // n)
    return n_part * hits / (math.pi * h**3)


def _sph_taps(pos, g: GridSpec, h: float):
    """Wrapped base cells, the stencil, and a function of offset k giving
    (diff, r2, r): the particle's distance from that offset's cell centre,
    measured from its unwrapped base as in the JAX package."""
    d = _cell(g, pos, 3)
    base_f = torch.floor(pos / d)
    offsets = sph_stencil(g, h)
    # one host-to-device copy of the stencil, not one per offset
    offs = torch.tensor(offsets, dtype=pos.dtype, device=pos.device)

    def dist(k):
        diff = pos - (base_f + offs[k].reshape(3, 1, 1, 1) + 0.5) * d
        dx, dy, dz = diff.unbind(-4)
        r2 = dx * dx + dy * dy + dz * dz
        # sqrt's slope is undefined at 0, where W4's is 0: guard the branch
        # (a particle sits exactly on a cell centre wherever it is not
        # displaced)
        pos_r2 = r2 > 0
        r = torch.where(pos_r2, torch.sqrt(torch.where(pos_r2, r2, 1.0)), 0.0)
        return diff, r2, r

    return _wrap_base(base_f.long(), g), offsets, dist


class _SPHDeposit(torch.autograd.Function):
    """rho(c) = sum_p w_p W4(|x_p - x_c|/h)/(pi h^3) over the static
    stencil, summed exactly (`_fixed_point_sum`).  Only the positions and
    weights are kept: the backward recomputes each offset's distance and
    W4 slope, gathers the cotangent at that offset's cell and accumulates
    the position gradient (W4'(r/h)/h * diff/r * norm, 0 at r = 0 as the
    JAX guard gives) and the weights' gradient (W4 * norm)."""

    @staticmethod
    def forward(ctx, pos, weights, g, h):
        ctx.g, ctx.h = g, h
        ctx.save_for_backward(pos, weights)
        base, offsets, dist = _sph_taps(pos, g, h)
        norm = 1.0 / (math.pi * h**3)
        batch = tuple(pos.shape[:-4])
        shape = batch + pos.shape[-3:]

        def taps():
            for k in range(len(offsets)):
                w = w4(dist(k)[2] / h) * norm
                if weights is not None:
                    w = w * weights
                yield w.expand(shape).reshape(-1)

        scale = tk._fixed_point_scale(
            weights, sph_max_sum_per_weight(g, h, _n_particles(pos)),
            pos.device)
        out = _fixed_point_sum(_stencil_index(base, offsets, g),
                               math.prod(batch) * g.N, scale, taps(),
                               pos.dtype)
        return out.reshape(batch + g.shape)

    @staticmethod
    def backward(ctx, cot):
        pos, weights = ctx.saved_tensors
        g, h = ctx.g, ctx.h
        need_pos, need_w = ctx.needs_input_grad[:2]
        base, offsets, dist = _sph_taps(pos, g, h)
        index = _stencil_index(base, offsets, g)
        norm = 1.0 / (math.pi * h**3)
        batch = tuple(pos.shape[:-4])
        flat = cot.contiguous().reshape(-1)
        g_pos = torch.zeros_like(pos) if need_pos else None
        g_w = 0.0
        for k in range(len(offsets)):
            diff, r2, r = dist(k)
            c = flat[index(k)].reshape(batch + pos.shape[-3:])
            if need_pos:
                slope = norm * _w4_slope(r / h) / h
                coef = torch.where(r2 > 0, slope / torch.where(r2 > 0, r, 1.0),
                                   0.0) * c
                if weights is not None:
                    coef = coef * weights
                g_pos = g_pos + coef.unsqueeze(-4) * diff
            if need_w:
                g_w = g_w + norm * w4(r / h) * c
        if need_w:
            g_w = g_w.sum_to_size(weights.shape)
        return g_pos, (g_w if need_w else None), None, None


def sph_deposit(pos, g: GridSpec, h: float, weights=None):
    """Exact SPH scatter rho(c) = sum_p m_p W4(|x_p - x_c|/h)/(pi h^3) over
    the static stencil (getDensity_SPH, massFunctions.cc:391-495); no cell's
    fixed-point sum can overflow (`sph_max_sum_per_weight`)."""
    return _SPHDeposit.apply(pos, weights, g, float(h))


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
    """masskernel: 0/'ngp', 1/'cic', 2/'tsc', 3/'sph' or 'sph_ft'."""
    mk = {0: "ngp", 1: "cic", 2: "tsc", 3: "sph"}.get(masskernel, masskernel)
    if mk == "ngp":
        return ngp_deposit(pos, g, weights)
    if mk == "cic":
        return cic_deposit(pos, g, weights)
    if mk == "tsc":
        return tsc_deposit(pos, g, weights)
    if mk == "sph":
        return sph_deposit(pos, g, h, weights)
    if mk == "sph_ft":
        return sph_ft_deposit(pos, g, h, weights)
    raise ValueError(f"unknown masskernel {masskernel!r}")


def overdens(rho):
    """delta = rho/mean(rho) - 1 per field (overdens, massFunctions.cc:30-47)."""
    return rho / rho.mean(dim=(-3, -2, -1), keepdim=True) - 1.0
