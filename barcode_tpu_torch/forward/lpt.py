"""Lagrangian perturbation theory displacement fields.

Port of barcode_tpu/forward/lpt.py:40-218: sfmodel 1 (Zel'dovich), 2 (2LPT)
and 3 (ALPT), with spectral ('fft') or 4th-order finite-difference
('findif') second derivatives in the 2LPT source, and the TRANSF kernels
(`transfer=(t_zeld, t_2lpt)`, rfft-layout multipliers) on the
non-Zel'dovich paths.  Inputs have shape (...,) + grid shape;
displacements come back as (..., 3) + grid shape.  Sign conventions follow
the JAX package (standard Bouchet et al. 1995 signs; see its module
docstring).
"""
from __future__ import annotations

import torch

from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.grid import fourier


def _psi_from_div_C(div_C, g: GridSpec):
    """Potential flow with the given (half-complex) divergence:
    Psi_k = -i k (div)_k / k^2, DC and Nyquist zeroed (lpt.py:40-53)."""
    dev = div_C.device
    kx, ky, kz = fourier.kvec(g, device=dev)
    k2 = kx * kx + ky * ky + kz * kz
    guard = k2 > 1e-14
    inv_k2 = torch.where(guard, 1.0 / torch.where(guard, k2, 1.0), 0.0)
    base = (-1j) * div_C * (inv_k2 * fourier.nyquist_mask(g, device=dev))
    # one batched irfft over the 3 components
    return fourier.irfft3(torch.stack([kx * base, ky * base, kz * base],
                                      dim=-4), g)


def zeldovich_psi(delta1, g: GridSpec, D1: float, delta_C=None):
    """Psi with div Psi = -D1 delta1 (lpt.py:56-67).  `delta_C` = optional
    precomputed rfft3(delta1)."""
    if delta_C is None:
        delta_C = fourier.rfft3(delta1)
    return _psi_from_div_C(-D1 * delta_C, g)


def _second_order_source(delta_C, g: GridSpec, deriv_scheme: str = "fft"):
    """m2v = sum_{i<j} (phi,ii phi,jj - phi,ij^2) with lap phi = delta
    (lpt.py:70-103): spectral second derivatives phi,ij =
    IFFT[(k_i k_j / k^2) delta_k] ('fft'), or nested 4th-order
    finite-difference gradients of the Poisson solution ('findif')."""
    kx, ky, kz = fourier.kvec(g, device=delta_C.device)
    k2 = kx * kx + ky * ky + kz * kz
    inv_k2 = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0), 0.0)
    if deriv_scheme == "findif":
        phi = fourier.irfft3(-delta_C * inv_k2, g)
        grads = [fourier.gradfindif(phi, g, a) for a in range(3)]
        p = {(a, b): fourier.gradfindif(grads[a], g, b)
             for a in range(3) for b in range(a, 3)}
        return (p[0, 0] * p[1, 1] - p[0, 1] ** 2
                + p[0, 0] * p[2, 2] - p[0, 2] ** 2
                + p[1, 1] * p[2, 2] - p[1, 2] ** 2)
    if deriv_scheme != "fft":
        raise ValueError(f"unknown deriv_scheme {deriv_scheme!r}")
    base = delta_C * inv_k2
    # the cross terms are odd in one axis, so on the self-paired z planes
    # their Nyquist rows are not Hermitian: project them (as the CPU FFT of
    # the JAX package does implicitly) so every device computes one field
    cross = fourier.hermitian_part(
        torch.stack([kx * ky * base, kx * kz * base, ky * kz * base], dim=-4), g)
    stack = torch.cat([torch.stack([kx * kx * base, ky * ky * base,
                                    kz * kz * base], dim=-4), cross], dim=-4)
    pxx, pyy, pzz, pxy, pxz, pyz = fourier.irfft3(stack, g).unbind(-4)
    return pxx * pyy - pxy * pxy + pxx * pzz - pxz * pxz + pyy * pzz - pyz * pyz


def two_lpt_div_C(delta1, g: GridSpec, D1: float, D2: float,
                  deriv_scheme: str = "fft", transfer=None, delta_C=None):
    """Half-complex div Psi_2LPT = -D1 delta1_C + D2 rfft(m2v), D2 < 0, the
    TRANSF kernels multiplying the linear field and the source in place
    (lpt.py:106-127)."""
    t_zeld, t_2lpt = transfer if transfer is not None else (None, None)
    if delta_C is None:
        delta_C = fourier.rfft3(delta1)
    m2v_C = fourier.rfft3(_second_order_source(delta_C, g, deriv_scheme))
    lin_C = delta_C if t_zeld is None else t_zeld * delta_C
    if t_2lpt is not None:
        m2v_C = t_2lpt * m2v_C
    return -D1 * lin_C + D2 * m2v_C


def two_lpt_div_psi(delta1, g: GridSpec, D1: float, D2: float,
                    deriv_scheme: str = "fft", transfer=None):
    """Real-space div Psi_2LPT (lpt.py:130-135)."""
    return fourier.irfft3(
        two_lpt_div_C(delta1, g, D1, D2, deriv_scheme, transfer), g)


def two_lpt_psi(delta1, g: GridSpec, D1: float, D2: float,
                deriv_scheme: str = "fft", transfer=None, delta_C=None):
    return _psi_from_div_C(
        two_lpt_div_C(delta1, g, D1, D2, deriv_scheme, transfer, delta_C), g)


def spherical_collapse_div_psi(delta1, g: GridSpec, D1: float):
    """div Psi_SC = 3(sqrt(1 + 2/3 psi_lin) - 1) clipped at -3,
    psi_lin = -D1 delta1 (lpt.py:138-148)."""
    arg = 1.0 + (2.0 / 3.0) * (-D1 * delta1)
    # double-where: the masked branch must never see sqrt(<=0), or its NaN
    # cotangent (0/sqrt(0)) poisons the gradient at collapsed cells —
    # torch.where has the same trap as jnp.where
    pos = arg > 0.0
    safe = torch.where(pos, arg, 1.0)
    return torch.where(pos, 3.0 * (torch.sqrt(safe) - 1.0), -3.0)


def cellbound(v):
    """Half-cell diagonal average 0.5*(v + v shifted by (+1,+1,+1))
    (lpt.py:151-155)."""
    return 0.5 * (v + torch.roll(v, (1, 1, 1), (-3, -2, -1)))


def alpt_psi(delta1, g: GridSpec, D1: float, D2: float, slength: float,
             apply_cellbound: bool = True, deriv_scheme: str = "fft",
             transfer=None, delta_C=None):
    """ALPT: Gaussian long/short-range split at `slength` of the 2LPT and
    spherical-collapse divergences, then one displacement solve
    (lpt.py:158-199).  With TRANSF the transferred linear field feeds both
    terms, while m2v comes from the raw field (Lag2Eul.cc:156-226)."""
    t_zeld, t_2lpt = transfer if transfer is not None else (None, None)
    if delta_C is None:
        delta_C = fourier.rfft3(delta1)
    m2v = _second_order_source(delta_C, g, deriv_scheme)
    if t_zeld is None:
        lin_C, delta1_t = delta_C, delta1
    else:
        lin_C = t_zeld * delta_C
        delta1_t = fourier.irfft3(lin_C, g)
    div_sc = spherical_collapse_div_psi(delta1_t, g, D1)
    K = torch.exp(-fourier.k_squared(g, device=delta_C.device)
                  * (slength * slength) / 2.0)
    m2v_C, divsc_C = fourier.rfft3(torch.stack([m2v, div_sc], dim=-4)
                                   ).unbind(-4)
    if t_2lpt is not None:
        m2v_C = t_2lpt * m2v_C
    div2lpt_C = -D1 * lin_C + D2 * m2v_C
    div_C = K * div2lpt_C + (1.0 - K) * divsc_C
    psi = _psi_from_div_C(div_C, g)
    if apply_cellbound:
        psi = cellbound(psi)
    return psi


def lpt_psi(delta1, g: GridSpec, sfmodel: int, D1: float, D2: float,
            slength: float, deriv_scheme: str = "fft", transfer=None,
            delta_C=None):
    """Dispatch like Lag2Eul (lpt.py:202-218).  `transfer` acts on the
    non-Zel'dovich paths only, as in the reference; `delta_C` = optional
    precomputed rfft3(delta1) shared with the prior energy."""
    if sfmodel == 1:
        return zeldovich_psi(delta1, g, D1, delta_C)
    if sfmodel == 2:
        return two_lpt_psi(delta1, g, D1, D2, deriv_scheme, transfer, delta_C)
    if sfmodel == 3:
        return alpt_psi(delta1, g, D1, D2, slength, deriv_scheme=deriv_scheme,
                        transfer=transfer, delta_C=delta_C)
    raise ValueError(f"unknown sfmodel {sfmodel}")
