"""Hand-assembled likelihood gradient: the reference's analytic h-term.

Port of barcode_tpu/model/adjoint.py:1-166.  The sampler's gradient is
torch autograd of the discrete psi (model/posterior.py); this module
re-derives the chain-rule adjoint the way the reference does
(likelihood_grad_log_like + likelihood_calc_h_SPH, fast calc_h=3 variant,
HMC_models.cc:312-471, HMC_models_testing.cpp:54-188) for sfmodels 1-3:

    h(q) = adj(sfmodel chain) . adj(TSC deposit) [W4 (*) dL/ddelta_x]

with the overdensity normalisation differentiated through and the discrete
TSC weights differentiated, as in the JAX package, so it equals the
autograd gradient to float tolerance and cross-checks it.  The TRANSF
kernels (real multipliers, hence self-adjoint) enter as in
`lpt.alpt_psi`/`lpt.two_lpt_div_C`.  Inputs may carry a leading chain
dimension.
"""
from __future__ import annotations

import torch

from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.grid import fourier
from barcode_tpu_torch.forward import assign, lpt, particles
from barcode_tpu_torch.forward.lag2eul import (ForwardConfig, GrowthParams,
                                               kernel_h)
from barcode_tpu_torch.model import likelihoods
from barcode_tpu_torch.model.likelihoods import ObsData

_GRID = (-3, -2, -1)


def _inv_k2(g: GridSpec, device, eps: float = 0.0):
    kx, ky, kz = fourier.kvec(g, device=device)
    k2 = kx * kx + ky * ky + kz * kz
    guard = k2 > eps
    return (kx, ky, kz), torch.where(guard, 1.0 / torch.where(guard, k2, 1.0),
                                     0.0)


def _adj_m2v(u, delta_lag, g: GridSpec):
    """Adjoint of the 2LPT source m2v(delta) ('fft' scheme): dm2v/dp_aa =
    sum_{b != a} p_bb, dm2v/dp_ab = -2 p_ab (a < b), each p_ab = irfft[(k_a
    k_b / k^2) rfft delta] a real-symmetric, self-adjoint multiplier
    (adjoint.py:82-103)."""
    (kx, ky, kz), inv_k2 = _inv_k2(g, u.device)
    base = fourier.rfft3(delta_lag) * inv_k2
    Ms = (kx * kx, ky * ky, kz * kz, kx * ky, kx * kz, ky * kz)
    pxx, pyy, pzz, pxy, pxz, pyz = fourier.irfft3(
        torch.stack([M * base for M in Ms], dim=-4), g).unbind(-4)
    S = torch.stack([u * (pyy + pzz), u * (pxx + pzz), u * (pxx + pyy),
                     -2.0 * u * pxy, -2.0 * u * pxz, -2.0 * u * pyz], dim=-4)
    SC = fourier.rfft3(S).unbind(-4)
    acc = sum(M * c for M, c in zip(Ms, SC)) * inv_k2
    return fourier.irfft3(acc, g)


def grad_log_like_analytic(delta_lag, g: GridSpec, fc: ForwardConfig,
                           gp: GrowthParams, obs: ObsData, likelihood: int,
                           transfer=None):
    """d psi_like / d delta_lag for sfmodel 1/2/3 ('fft' derivatives),
    masskernel 'sph_ft', optional plane-parallel RSD and TRANSF kernels
    (adjoint.py:106-166)."""
    if not (fc.sfmodel in (1, 2, 3) and fc.masskernel == "sph_ft"
            and fc.deriv_scheme == "fft" and (not fc.rsd or fc.rsd_planepar)):
        raise ValueError("the analytic adjoint covers sfmodel 1-3, 'sph_ft', "
                         "'fft' derivatives and plane-parallel RSD only")
    t_zeld, t_2lpt = transfer if transfer is not None else (None, None)
    if fc.sfmodel == 1:
        t_zeld = t_2lpt = None  # TRANSF acts on the non-Zel'dovich paths
    h = kernel_h(fc, g)
    dev = delta_lag.device

    # forward (the residuals the adjoint needs, the reference's Lag2Eul rerun)
    psi = lpt.lpt_psi(delta_lag, g, fc.sfmodel, gp.D1, gp.D2, fc.slength,
                      transfer=transfer)
    pos = particles.displace(psi, g)
    if fc.rsd:
        f1 = gp.cpecvel / (gp.hubble * gp.ascale)  # == fgrow (rsd.cc:40-57)
        x, y, z = pos.unbind(-4)
        z = torch.remainder(z + f1 * psi.select(-4, 2), g.L3)
        pos = torch.stack([x, y, z], dim=-4)
    rho = assign.tsc_deposit(pos, g)
    W4 = assign.w4_fourier(g, h, dev)
    rho_s = fourier.irfft3(W4 * fourier.rfft3(rho), g)
    rho_mean = rho_s.mean(dim=_GRID, keepdim=True)
    delta_x = rho_s / rho_mean - 1.0

    # adjoint
    # 1. dL/ddelta_x (partial_f_delta_x_log_like)
    part = likelihoods.partial_f_delta_x(likelihood, delta_x, obs)
    # 2. through overdens: g_rho = p/m - (sum p*rho_s)/(m^2 N)
    g_rho = part / rho_mean - torch.sum(part * rho_s, dim=_GRID,
                                        keepdim=True) / (rho_mean**2 * g.N)
    # 3. through the W4 convolution (a self-adjoint real multiplier)
    g_tsc = fourier.irfft3(W4 * fourier.rfft3(g_rho), g)
    # 4. through the TSC deposit: the per-particle force V_i
    V = assign.tsc_weight_grad_gather(g_tsc, pos, g)
    if fc.rsd:
        # z-position got (1 + f1) psi_z (likelihood_calc_V_SPH:295-301)
        V = torch.cat([V[..., :2, :, :, :],
                       (1.0 + f1) * V[..., 2:, :, :, :]], dim=-4)
    if fc.sfmodel == 3:
        # cellbound C = 0.5 (I + roll(+1)) -> C^T = 0.5 (I + roll(-1))
        V = 0.5 * (V + torch.roll(V, (-1, -1, -1), _GRID))
    # 5. through Psi = irfft[-i k/k^2 rfft(div)]: the conjugate multiplier
    #    g_div(k) = sum_i (+i k_i/k^2) V_i(k)
    (kx, ky, kz), inv_k2 = _inv_k2(g, dev, 1e-14)
    VC = fourier.rfft3(V).unbind(-4)
    gdiv_C = (1j * inv_k2 * fourier.nyquist_mask(g, device=dev)
              * (kx * VC[0] + ky * VC[1] + kz * VC[2]))

    def transferred(X, t):
        return fourier.irfft3(X if t is None else t * X, g)

    # 6. through the model's divergence
    if fc.sfmodel == 1:  # div = -D1 delta
        return -gp.D1 * fourier.irfft3(gdiv_C, g)
    if fc.sfmodel == 2:  # div = -D1 t_z delta + D2 t_2 m2v(delta)
        return (-gp.D1 * transferred(gdiv_C, t_zeld)
                + gp.D2 * _adj_m2v(transferred(gdiv_C, t_2lpt), delta_lag, g))
    # ALPT: div = K o div_2LPT + (1 - K) o div_SC(t_z delta); the Gaussian
    # blend is a real-symmetric multiplier
    K = torch.exp(-fourier.k_squared(g, device=dev)
                  * (fc.slength * fc.slength) / 2.0)
    g2_C, gsc = K * gdiv_C, fourier.irfft3((1.0 - K) * gdiv_C, g)
    delta_t = delta_lag if t_zeld is None else \
        fourier.irfft3(t_zeld * fourier.rfft3(delta_lag), g)
    # div_SC = f(psilin), psilin = -D1 delta_t; f'(a) = 1/sqrt(1 + 2a/3) on
    # the live branch, 0 where collapsed (lpt.spherical_collapse_div_psi)
    arg = 1.0 + (2.0 / 3.0) * (-gp.D1 * delta_t)
    live = arg > 0.0
    fprime = torch.where(live, 1.0 / torch.sqrt(torch.where(live, arg, 1.0)),
                         0.0)
    g_sc = -gp.D1 * fprime * gsc
    if t_zeld is not None:
        g_sc = fourier.irfft3(t_zeld * fourier.rfft3(g_sc), g)
    return (-gp.D1 * transferred(g2_C, t_zeld)
            + gp.D2 * _adj_m2v(transferred(g2_C, t_2lpt), delta_lag, g)
            + g_sc)
