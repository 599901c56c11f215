"""Slab-sharded forward model + posterior for grids that exceed one card.

Port of barcode_tpu/parallel/sharded_forward.py:1-449.  Every rank of a
'grid' process group holds one x-slab of every field: slab-local FFT
stages with all-to-all transposes (`sharded_fft`), slab-local particles, a
halo-exchange deposit (neighbour ring), all-reduced sums for the mean
density and the energies.  Fields may carry a leading chain dimension (the
rank's local chain batch); every collective covers the whole batch.

Gradients: each rank backpropagates its *local* partial psi_prior +
psi_like.  The collectives inside the graph (the FFT transposes, the ring
shifts, the all-reduced mean) are autograd Functions whose backward is the
adjoint collective, so the gradient a rank gets for its slab is that of the
global psi.  The all-reduce of the reported values stays out of the graph.

Options: `check_sharded_options` refuses what the slab posterior does not
compute as `model/posterior.make_psi_force` does (masskernel 0/1/3, radial
or non-periodic RSD, finite-difference 2LPT); every other option of the
ModelConfig reaches it, as in the dense posterior.

Halo contract: a particle's deposit support must stay within `halo` cells
of its home slab in x; `suggest_halo` picks a safe value from the box, and
`slab_violations` counts the particles that break it on the windowless
path.  With
`pallas_deposit` the deposit runs through kernels K3 (forward) and K4
(backward) at the (quantile) kernel halo, with the halo-tail split of the
JAX package; otherwise it is a plain windowless scatter summed in fixed
point (`assign._exact_scatter`).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.forward import assign
from barcode_tpu_torch.forward import tsc_kernels as tk
from barcode_tpu_torch.forward.lag2eul import (ForwardConfig, GrowthParams,
                                               kernel_h)
from barcode_tpu_torch.model import likelihoods
from barcode_tpu_torch.model.likelihoods import ObsData
from barcode_tpu_torch.model.posterior import ModelConfig, force_factors
from barcode_tpu_torch.parallel import sharded_fft as sf

AXIS = "grid"
_GRID = (-3, -2, -1)


def suggest_halo(g: GridSpec, sigma_psi: float = 6.0,
                 nsigma: float = 4.0) -> int:
    """Halo cells covering nsigma * sigma_psi of displacement + TSC reach."""
    return int(np.ceil(nsigma * sigma_psi / g.cell[0])) + 2


def _local_positions_x(g: GridSpec, n_dev: int, dev: int,
                       dtype=torch.float32, device=None):
    """Slab-local Lagrangian cell-centre positions (x in global
    coordinates), (3, n1_loc, N2, N3)."""
    n1_loc = g.N1 // n_dev
    d1, d2, d3 = g.cell
    x = (dev * n1_loc + torch.arange(n1_loc, dtype=dtype, device=device)
         + 0.5) * d1
    y = (torch.arange(g.N2, dtype=dtype, device=device) + 0.5) * d2
    z = (torch.arange(g.N3, dtype=dtype, device=device) + 0.5) * d3
    return torch.stack(torch.meshgrid(x, y, z, indexing="ij"))


# ---------------------------------------------------------------------------
# Collectives with their adjoints
# ---------------------------------------------------------------------------

def _shift_comm(x, layout, step: int):
    """Send x to the grid neighbour at +step, receive the one from -step."""
    D, d = layout.n_grid, layout.col
    x = x.contiguous()
    if D == 1:
        return x.clone()
    m = x.numel()
    send_sizes = [m if q == (d + step) % D else 0 for q in range(D)]
    recv_sizes = [m if p == (d - step) % D else 0 for p in range(D)]
    out = torch.empty_like(x)
    dist.all_to_all_single(out.reshape(-1), x.reshape(-1),
                           output_split_sizes=recv_sizes,
                           input_split_sizes=send_sizes,
                           group=layout.grid_group)
    return out


class _Shift(torch.autograd.Function):
    """Ring shift over the grid group: each rank receives the x of its
    neighbour at -step; the adjoint shifts back.  At one rank it is the
    identity, with no send to the own rank (which NCCL refuses)."""

    @staticmethod
    def forward(ctx, x, layout, step: int):
        ctx.layout, ctx.step = layout, step
        return _shift_comm(x, layout, step)

    @staticmethod
    def backward(ctx, g):
        return _shift_comm(g, ctx.layout, -ctx.step), None, None


class _AllReduce(torch.autograd.Function):
    """Sum over the grid group; every rank uses the sum, so the adjoint
    sums the cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


def _halo_exchange_add(ext, halo: int, layout):
    """Fold the x margins of an extended slab (..., H + n_loc + H, N2, N3)
    into the neighbours' interiors (a ring); returns the interior.  The
    right neighbour's head is added before the left neighbour's tail, as
    in the JAX package (sharded_forward.py:55-68)."""
    interior = ext[..., halo:-halo, :, :]
    n = interior.shape[-3]
    from_right = _Shift.apply(ext[..., :halo, :, :], layout, -1)
    from_left = _Shift.apply(ext[..., -halo:, :, :], layout, 1)
    pad = torch.nn.functional.pad
    out = interior + pad(from_right, (0, 0, 0, 0, n - halo, 0))
    return out + pad(from_left, (0, 0, 0, 0, 0, n - halo))


def _roll_x1(v, layout):
    """roll(+1) along the slab-sharded x axis (-3): each rank's last x row
    becomes its right neighbour's first row."""
    recv = _Shift.apply(v[..., -1:, :, :], layout, 1)
    return torch.cat([recv, v[..., :-1, :, :]], dim=-3)


# ---------------------------------------------------------------------------
# Deposits
# ---------------------------------------------------------------------------

def _deposit_local(pos, g: GridSpec, halo: int, layout):
    """Windowless TSC deposit of slab-local particles into an extended x
    buffer, summed in fixed point, then folded by the halo exchange
    (sharded_forward.py:71-109): base rows beyond the margin are clipped,
    taps leaving the extended buffer dropped, y and z periodic."""
    n_dev, dev = layout.n_grid, layout.col
    n1_loc = g.N1 // n_dev
    n1_ext = n1_loc + 2 * halo
    d = torch.tensor(g.cell, dtype=pos.dtype, device=pos.device
                     ).reshape(3, 1, 1, 1)
    u = pos / d
    fl = torch.floor(u)
    u0, u1, u2 = u.unbind(-4)
    b0, b1, b2 = fl.unbind(-4)
    qx = torch.arange(n1_loc, dtype=pos.dtype, device=pos.device
                      ).reshape(-1, 1, 1)
    offq = torch.remainder(b0 - (dev * n1_loc + qx) + g.N1 / 2.0,
                           g.N1) - g.N1 / 2.0
    bx = torch.clamp(qx + offq + halo, 0, n1_ext - 1).long()
    by = torch.remainder(b1.long(), g.N2)
    bz = torch.remainder(b2.long(), g.N3)
    frac = torch.stack([u0 - b0 - 0.5, u1 - b1 - 0.5, u2 - b2 - 0.5], dim=-4)
    ws = assign._tsc_weights(frac)
    batch = tuple(pos.shape[:-4])
    n_ext = n1_ext * g.N2 * g.N3
    c0 = assign._batch_flat_offsets(batch, n_ext, pos.device, 3)
    srcs = []
    for w, (ox, oy, oz) in zip(ws, assign._TSC_OFFSETS):
        ok = (bx + ox >= 0) & (bx + ox < n1_ext)
        srcs.append(torch.where(ok, w, 0.0).reshape(-1))

    def index(k):
        ox, oy, oz = assign._TSC_OFFSETS[k]
        x = torch.clamp(bx + ox, 0, n1_ext - 1)
        return (c0 + (x * g.N2 + torch.remainder(by + oy, g.N2)) * g.N3
                + torch.remainder(bz + oz, g.N3)).reshape(-1)

    out = assign._exact_scatter(index, math.prod(batch) * n_ext, srcs,
                                n1_loc * g.N2 * g.N3)
    ext = out.reshape(batch + (n1_ext, g.N2, g.N3))
    return _halo_exchange_add(ext, halo, layout)


def slab_violations(pos, g: GridSpec, halo: int, n_dev: int):
    """Particles whose mass `_deposit_local` misplaces, one count per chain
    of the full-grid positions `pos` (..., 3, N1, N2, N3): a TSC support
    leaving the slab's rows +- `halo` in x, where the base row is clamped
    into the edge row and taps beyond it are dropped (y and z wrap)."""
    n1_loc = g.N1 // n_dev
    b0 = torch.floor(pos.select(-4, 0) / g.cell[0])
    q = torch.arange(g.N1, dtype=pos.dtype, device=pos.device
                     ).reshape(-1, 1, 1)
    off = torch.remainder(b0 - q + g.N1 / 2.0, g.N1) - g.N1 / 2.0
    row = torch.remainder(q, n1_loc) + off
    bad = (row < 1 - halo) | (row > n1_loc - 2 + halo)
    return bad.sum(dim=_GRID)


class _SlabDeposit(torch.autograd.Function):
    """Unit-mass slab deposit into the extended buffer: K3 forward, K4
    backward, with the halo-tail split (sharded_forward.py:118-202)."""

    @staticmethod
    def forward(ctx, pos, spec):
        g, n1_loc, dev, h_k4, h_x, block, tail_k, split, bf16_fwd, _ = spec
        ctx.spec = spec
        if not split:
            ctx.save_for_backward(pos)
            return tk.tsc_deposit_slab(pos, g, n1_loc, dev, h_k4, block,
                                       bf16=bf16_fwd)
        excess = assign._slab_halo_excess(pos, g, n1_loc, dev, h_k4)
        ok = (excess <= 0.0).to(pos.dtype)
        ext_k = tk.tsc_deposit_slab(pos, g, n1_loc, dev, h_k4, block,
                                    weights=ok, bf16=bf16_fwd)
        pad = h_x - h_k4
        ext = torch.nn.functional.pad(ext_k, (0, 0, 0, 0, pad, pad))
        vals, idx = assign._compact_topk(excess.flatten(-3), tail_k)
        pos_k = torch.gather(pos.flatten(-3), -1,
                             idx.unsqueeze(-2).expand(idx.shape[:-1]
                                                      + (3, -1)))
        row_k = torch.div(idx, g.N2 * g.N3, rounding_mode="floor")
        valid = vals > 0.0
        ctx.save_for_backward(pos, ok, idx, pos_k, row_k, valid)
        return ext + assign._tail_deposit_slab(pos_k, row_k, valid, g, n1_loc,
                                               h_x, dev * n1_loc)

    @staticmethod
    def backward(ctx, cot):
        g, n1_loc, dev, h_k4, h_x, block, tail_k, split, _, bf16_bwd = \
            ctx.spec
        cot = cot.contiguous()
        if not split:
            (pos,) = ctx.saved_tensors
            out = tk.tsc_gather_grads_slab(cot, pos, g, n1_loc, dev, h_k4,
                                           block, want_value=False,
                                           bf16=bf16_bwd)
            return out, None
        pos, ok, idx, pos_k, row_k, valid = ctx.saved_tensors
        pad = h_x - h_k4
        cot_k = cot[..., pad:pad + n1_loc + 2 * h_k4, :, :].contiguous()
        out = tk.tsc_gather_grads_slab(cot_k, pos, g, n1_loc, dev, h_k4, block,
                                       want_value=False, bf16=bf16_bwd)
        vk = assign._tail_weight_grad_slab(cot, pos_k, row_k, valid, g,
                                           n1_loc, h_x, dev * n1_loc)
        outf = (out * ok.unsqueeze(-4)).flatten(-3)
        outf = outf.scatter_add(-1, idx.unsqueeze(-2).expand_as(vk), vk)
        return outf.reshape(out.shape), None


def _make_pallas_slab_deposit(g: GridSpec, halo: int, n_dev: int,
                              block: tuple = (8, 8),
                              kernel_halo: int | None = None,
                              tail_k: int = 0, bf16_fwd: bool = False,
                              bf16_bwd: bool = False):
    """(dep, h_x): dep(pos, dev) deposits slab `dev`'s particles into the
    extended buffer (..., n1_loc + 2*h_x, N2, N3) through K3 (backward K4).

    Halo-tail split: with tail_k > 0 and kernel_halo < halo the kernels run
    at kernel_halo rounded up to a multiple of 4 (h_k4) while the exchange
    margin h_x stays at the worst-case `halo`; contract violators of the
    kernel halo get weight 0 in K3 and a masked K4 gradient, and up to
    tail_k of them per chain go through the exact 27-point slab tail
    (sharded_forward.py:118-202, its rounding kept exactly).  `bf16_fwd`
    and `bf16_bwd` select the TPU kernels' bf16 option for K3 and K4; the
    tail stays float32."""
    n1_loc = g.N1 // n_dev
    h_k = halo if (tail_k <= 0 or kernel_halo is None) else min(kernel_halo,
                                                                halo)
    h_k4 = -(-h_k // 4) * 4
    h_x = max(halo, h_k4)
    split = tail_k > 0 and h_k4 < h_x
    if not split:
        h_x = h_k4
    if h_x > n1_loc:
        raise ValueError(
            f"slab exchange halo ({h_x}) must not exceed the slab width "
            f"({n1_loc}): the ring exchange only reaches adjacent slabs")
    block = tuple(block)

    def dep(pos, dev: int):
        spec = (g, n1_loc, int(dev), h_k4, h_x, block, int(tail_k), split,
                bool(bf16_fwd), bool(bf16_bwd))
        return _SlabDeposit.apply(pos, spec)

    dep.h_k4 = h_k4
    return dep, h_x


def _w4_sharded(g: GridSpec, n_dev: int, dev: int, h: float, device=None):
    """Closed-form W4 transform on the sharded Fourier layout, float32-safe
    (small-kappa Taylor limit below kappa = 1; sharded_forward.py:410-431)."""
    kx, ky, kz = sf.kvec_sharded(g, n_dev, dev, device=device)
    kap = torch.sqrt(kx * kx + ky * ky + kz * kz) * h
    safe = torch.where(kap > 1.0, kap, 2.0)
    ksink = safe * torch.sin(safe)
    closed = 24.0 * (3.0 + torch.cos(2 * safe) - ksink
                     + torch.cos(safe) * (ksink - 4.0)) / safe**6
    k2 = kap * kap
    taylor = 1.0 - 0.15 * k2 + 0.0101190 * k2 * k2 - 4.1005e-4 * k2 * k2 * k2
    return torch.where(kap > 1.0, closed, taylor)


# ---------------------------------------------------------------------------
# The slab-local posterior
# ---------------------------------------------------------------------------

def _make_psi_local(g: GridSpec, mc: ModelConfig, gp: GrowthParams,
                    halo: int, layout):
    """psi_local(delta, obs) -> (psi_prior, psi_like): this rank's partial
    sums, one per chain of the local batch (sharded_forward.py:205-306).
    delta is (C, n1_loc, N2, N3), obs this rank's slabs (`shard_obs`) with
    the full model's scalars.  As in `posterior.make_psi`, likelihood 3
    reads the Lagrangian delta (no forward model) and the forward model
    sees deltaQ_factor * delta.  The slab deposit is TSC or 'sph_ft'
    (`check_sharded_options` refuses the others)."""
    fc = mc.forward
    n_dev, dev, group = layout.n_grid, layout.col, layout.grid_group
    device = layout.device
    h = kernel_h(fc, g)
    mk = _mass_kernel(fc)
    use_pallas = bool(fc.pallas_deposit)
    if use_pallas:
        pallas_dep, halo = _make_pallas_slab_deposit(
            g, halo, n_dev, block=tuple(fc.pallas_block),
            kernel_halo=fc.pallas_halo or None, tail_k=fc.pallas_tail_k,
            bf16_fwd=fc.pallas_bf16_dep, bf16_bwd=fc.pallas_bf16_grad)
    (kx, ky, kz), inv_k2, nyq = sf.inv_k2_and_mask(g, n_dev, dev, device)
    k2 = kx * kx + ky * ky + kz * kz
    q_pos = _local_positions_x(g, n_dev, dev, device=device)
    L = torch.tensor([g.L1, g.L2, g.L3], device=device).reshape(3, 1, 1, 1)
    w4 = _w4_sharded(g, n_dev, dev, h, device) if mk == "sph_ft" else None
    dq = float(mc.deltaQ_factor)
    rfft = lambda x: sf._rfft3_local(x, group)
    irfft = lambda F: sf._irfft3_local(F, g.N3, group)

    def forward(delta, Fd):
        """Slab of the Eulerian overdensity of delta (spectrum Fd)."""
        # --- LPT divergence (mirrors lpt.py on the sharded layout) ---
        if fc.sfmodel == 1:
            div_C = -gp.D1 * Fd
        else:
            b2 = Fd * inv_k2
            pairs = ((kx, kx), (ky, ky), (kz, kz), (kx, ky), (kx, kz),
                     (ky, kz))
            pxx, pyy, pzz, pxy, pxz, pyz = irfft(torch.stack(
                [ka * kb * b2 for ka, kb in pairs], dim=-4)).unbind(-4)
            m2v = (pxx * pyy - pxy * pxy + pxx * pzz - pxz * pxz
                   + pyy * pzz - pyz * pyz)
            div2 = -gp.D1 * delta + gp.D2 * m2v
            if fc.sfmodel == 2:
                div_C = rfft(div2)
            else:  # ALPT long/short blend (lpt.alpt_psi)
                arg = 1.0 + (2.0 / 3.0) * (-gp.D1 * delta)
                pos_arg = arg > 0.0
                safe_arg = torch.where(pos_arg, arg, 1.0)
                div_sc = torch.where(pos_arg,
                                     3.0 * (torch.sqrt(safe_arg) - 1.0), -3.0)
                K = torch.exp(-k2 * (fc.slength * fc.slength) / 2.0)
                f2, fsc = rfft(torch.stack([div2, div_sc], dim=-4)).unbind(-4)
                div_C = K * f2 + (1.0 - K) * fsc
        base = (-1j) * div_C * inv_k2 * nyq
        psi = irfft(torch.stack([base * kx, base * ky, base * kz], dim=-4))
        if fc.sfmodel == 3:
            # cellbound half-cell average; the +1 x-roll crosses slabs
            psi = 0.5 * (psi + _roll_x1(torch.roll(psi, (1, 1), (-2, -1)),
                                        layout))
        # --- particles + optional plane-parallel RSD (periodic in z) ---
        pos = torch.remainder(q_pos + psi, L)
        if fc.rsd:
            f1 = gp.cpecvel / (gp.hubble * gp.ascale)
            pz = torch.remainder(pos.select(-4, 2) + f1 * psi.select(-4, 2),
                                 g.L3)
            pos = torch.stack([pos.select(-4, 0), pos.select(-4, 1), pz],
                              dim=-4)
        # --- halo deposit ---
        if use_pallas:
            rho = _halo_exchange_add(pallas_dep(pos.contiguous(), dev), halo,
                                     layout)
        else:
            rho = _deposit_local(pos, g, halo, layout)
        if w4 is not None:
            rho = irfft(w4 * rfft(rho))
        # --- overdensity with the global mean ---
        mean = _AllReduce.apply(rho.mean(dim=_GRID), group) / n_dev
        return rho / mean.reshape(mean.shape + (1, 1, 1)) - 1.0

    def psi_local(delta, obs: ObsData):
        Fd = rfft(delta)
        if mc.likelihood == 3:
            psi_like = likelihoods.grf_psi(delta, obs)
        else:
            d, F = (delta, Fd) if dq == 1.0 else (dq * delta, dq * Fd)
            psi_like = likelihoods.likelihood_psi(mc.likelihood,
                                                  forward(d, F), obs)
        # --- prior (this rank's partial sum) ---
        inv_p = torch.where(obs.power > 0,
                            (g.vol / g.N) / torch.where(obs.power > 0,
                                                        obs.power, 1.0), 0.0)
        Sinv_d = irfft(inv_p * Fd)
        psi_prior = 0.5 * torch.sum(delta * Sinv_d, dim=_GRID)
        return psi_prior, psi_like

    return psi_local


def _global_sums(pp, pl, group):
    """All-reduced (psi_prior, psi_like) over the grid group, outside the
    graph; every rank of the group gets the same bits."""
    both = torch.stack([pp.detach(), pl.detach()])
    dist.all_reduce(both, group=group)
    return both[0], both[1]


def _mass_kernel(fc: ForwardConfig):
    return {0: "ngp", 1: "cic", 2: "tsc", 3: "sph"}.get(fc.masskernel,
                                                       fc.masskernel)


def check_sharded_options(mc: ModelConfig) -> None:
    """Raise ValueError, naming the input.par key, for every option the slab
    posterior does not compute as `posterior.make_psi_force` does: its
    deposit is TSC or 'sph_ft' only, its RSD shifts z inside the periodic
    box, and its 2LPT source takes FFT derivatives.  Radial RSD moves x
    and finite differences reach across slabs, so either would need
    another slab geometry (the JAX package has the same gaps and no check,
    barcode_tpu/parallel/sharded_forward.py:294-335)."""
    fc = mc.forward
    if mc.likelihood not in (0, 1, 2, 3):
        raise ValueError(f"unknown likelihood {mc.likelihood}")
    if fc.sfmodel not in (1, 2, 3):
        raise ValueError(f"unknown sfmodel {fc.sfmodel}")
    where = "--sharded computes "
    if _mass_kernel(fc) not in ("tsc", "sph_ft"):
        raise ValueError(
            f"masskernel = {fc.masskernel}: {where}the TSC (2) and sph_ft "
            "deposits only")
    if fc.rsd and not fc.rsd_planepar:
        raise ValueError(
            f"planepar = false (radial RSD): {where}plane-parallel RSD "
            "only; radial RSD moves particles across slabs in x")
    if fc.rsd and not fc.periodic:
        raise ValueError(
            f"periodic = false with rsd_model: {where}periodic "
            "plane-parallel RSD only")
    if fc.deriv_scheme != "fft" and fc.sfmodel != 1:
        raise ValueError(
            f"deriv_scheme = {fc.deriv_scheme} with sfmodel = "
            f"{fc.sfmodel}: {where}FFT derivatives of the 2LPT source "
            "only; finite differences reach across slabs")


def _check_halo(g: GridSpec, mc: ModelConfig, n_dev: int, halo):
    check_sharded_options(mc)
    halo = halo if halo is not None else suggest_halo(g)
    if halo > g.N1 // n_dev:
        raise ValueError(
            f"halo ({halo}) must not exceed the slab width "
            f"({g.N1 // n_dev}): the ring exchange only reaches adjacent "
            "slabs")
    return halo


def _value_and_grad(psi_local, mc: ModelConfig, gp: GrowthParams,
                    obs: ObsData, group):
    """delta (C, n1_loc, N2, N3) -> ((psi, (pp, pl)), grad), psi and its
    parts global per chain, grad this rank's slab of the force: the
    gradient of f_p * pp + f_l * pl (`posterior.force_factors`) while psi
    stays exact, as `posterior.make_psi_force`."""
    f_p, f_l = force_factors(mc, gp)

    def vag(delta):
        with torch.enable_grad():
            d = delta.detach().requires_grad_(True)
            pp, pl = psi_local(d, obs)
            obj = pp + pl if f_p == 1.0 and f_l == 1.0 else \
                f_p * pp + f_l * pl
            (grad,) = torch.autograd.grad(obj.sum(), d)
        pp, pl = _global_sums(pp, pl, group)
        return (pp + pl, (pp, pl)), grad

    return vag


def make_sharded_psi(g: GridSpec, mc: ModelConfig, gp: GrowthParams, layout,
                     halo: int | None = None):
    """(psi_fn, grad_fn) over this rank's slab: psi_fn(delta_slab, obs) ->
    global psi (a float), grad_fn(delta_slab, obs) -> this rank's slab of
    the force (grad psi at the default factors).  delta and the obs fields
    are this rank's x-slabs, obs.power the ky-slab of the sharded Fourier
    layout (power_to_sharded_layout).  Every rank of the grid group calls
    them together."""
    halo = _check_halo(g, mc, layout.n_grid, halo)
    psi_local = _make_psi_local(g, mc, gp, halo, layout)

    def psi_fn(delta, obs: ObsData):
        with torch.no_grad():
            pp, pl = psi_local(delta[None], obs)
        pp, pl = _global_sums(pp, pl, layout.grid_group)
        return float((pp + pl)[0])

    def grad_fn(delta, obs: ObsData):
        return _value_and_grad(psi_local, mc, gp, obs, layout.grid_group)(
            delta[None])[1][0]

    return psi_fn, grad_fn


def make_sharded_psi_vg_chains(g: GridSpec, mc: ModelConfig,
                               gp: GrowthParams, layout,
                               halo: int | None = None):
    """Per-chain (psi values, forces) over a (chains, grid) layout:
    vg(delta_batch, obs) -> ((vals, (pp, pl)), grads) for this rank's local
    chains, delta_batch (C_loc, n1_loc, N2, N3)
    (sharded_forward.py:336-381)."""
    halo = _check_halo(g, mc, layout.n_grid, halo)
    psi_local = _make_psi_local(g, mc, gp, halo, layout)

    def vg(delta_batch, obs: ObsData):
        return _value_and_grad(psi_local, mc, gp, obs, layout.grid_group)(
            delta_batch)

    return vg


# ---------------------------------------------------------------------------
# Observation layouts
# ---------------------------------------------------------------------------

def _as_tensor(x, device):
    return torch.as_tensor(x if torch.is_tensor(x) else np.array(x),
                           device=device)


def power_to_sharded_layout(power_rfft_full, layout):
    """This rank's ky-slab (N1, N2/D, N3h) of a full half-complex grid."""
    p = _as_tensor(power_rfft_full, layout.device)
    n2 = p.shape[-2] // layout.n_grid
    return p[..., layout.col * n2:(layout.col + 1) * n2, :].contiguous()


def shard_obs(obs: ObsData, layout) -> ObsData:
    """This rank's x-slabs of the observation fields; power in the sharded
    Fourier layout.  obs holds full fields (tensors or numpy)."""
    def xs(x):
        return sf.shard_real(_as_tensor(x, layout.device), layout).contiguous()

    return dataclasses.replace(
        obs, nobs=xs(obs.nobs), window=xs(obs.window), noise=xs(obs.noise),
        power=power_to_sharded_layout(obs.power, layout))


def shard_obs_chains(obs: ObsData, layout) -> ObsData:
    """Observation layout of a (chains, grid) layout: slabs over 'grid',
    the same on every chain row."""
    return shard_obs(obs, layout)
