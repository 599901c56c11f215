"""HMC mass matrices (momentum preconditioners).

Port of barcode_tpu/hmc/mass.py (parity: Hamiltonian_mass,
reference HMC_mass.cc:315-368):
  0: real-space ones (no preconditioning)
  1: FS inverse power spectrum
  2: FS inverse P + likelihood-force spectrum (likeli_force_mass :127)
  3: FS inverse P + *mean* likelihood force (Wang+13, :145)
  4: FS P(k) itself
  5/6/60: Jasche+13 first-order real-space expansion, in the JAX
  package's single-convolution form (`jasche_diagonal_mass`); 60 is type 0
  until burn-in.

Which side (FS/RS) each type uses follows struct_hamil.h:270-310.  Fields
may carry a leading chain dimension; the mass is shared by the chains.
"""
from __future__ import annotations

import math

import torch

from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.grid import fourier
from barcode_tpu_torch import random_fields
from barcode_tpu_torch.hmc.state import MassState

FS_TYPES = {1, 2, 3, 4, 5}
RS_TYPES = {0, 5, 6, 60}
_GRID = (-3, -2, -1)


def mass_flags(mass_type: int):
    return mass_type in FS_TYPES, mass_type in RS_TYPES


def jasche_response_kernel(g: GridSpec, h: float, device=None):
    """G(q) = IFFT[ sum_a (-i k_a / k^2) FFT(grad_a W4) ](q): the response
    of the h-assembly to a unit particle at lattice offset q
    (mass.py:29-72)."""
    def centered(n, dd):
        i = torch.arange(n, device=device)
        return torch.where(i <= n // 2, i, i - n).to(torch.float32) * dd

    rx = centered(g.N1, g.cell[0])[:, None, None]
    ry = centered(g.N2, g.cell[1])[None, :, None]
    rz = centered(g.N3, g.cell[2])[None, None, :]
    r = torch.sqrt(rx * rx + ry * ry + rz * rz)
    q = r / h
    # dW4/dr / r, norm 1/(pi h^4) (grad_SPH_kernel_3D_h_units,
    # SPH_kernel.cpp:148-208)
    norm = 1.0 / (math.pi * h**4)
    q_safe = torch.where(q > 1e-12, q, 1.0)
    partial = torch.where(
        q > 2.0, 0.0,
        torch.where(q > 1.0, -0.75 * (q_safe - 2.0) ** 2 / q_safe,
                    2.25 * q_safe - 3.0)) * norm / h
    r_safe = torch.where(r > 0, r, 1.0)
    grads = [partial * torch.where(r > 0, c / r_safe, 0.0)
             for c in (rx, ry, rz)]

    kx, ky, kz = fourier.kvec(g, device=device)
    k2 = kx * kx + ky * ky + kz * kz
    guard = k2 > 0
    inv_k2 = torch.where(guard, 1.0 / torch.where(guard, k2, 1.0), 0.0)
    mask = fourier.nyquist_mask(g, device=device)
    hC = 0.0
    for comp, kl in zip(grads, (kx, ky, kz)):
        hC = hC + (-1j) * kl * inv_k2 * mask * fourier.rfft3(comp)
    return fourier.irfft3(hC, g)


def jasche_diagonal_mass(g: GridSpec, window, noise, h: float,
                         rho_c: float = 1.0):
    """First-order diagonal likelihood-force mass (Jasche+13) as one
    convolution, C = (w / sigma^2) * G^2 (mass.py:75-101)."""
    G2 = jasche_response_kernel(g, h, window.device) ** 2
    f = window / (noise * noise)
    C = fourier.irfft3(fourier.rfft3(f) * fourier.rfft3(G2), g)
    scale = (rho_c * g.vol / g.N) ** 2
    return torch.clamp(C * scale, min=0.0)


def _inv_power(power_rfft):
    pos = power_rfft > 0.0
    return torch.where(pos, 1.0 / torch.where(pos, power_rfft, 1.0), 0.0)


def _spectrum_to_grid(g: GridSpec, kmode, power, nbin: int):
    """A binned spectrum on the rfft |k| grid, zero at DC
    (Hamiltonian_mass_likeli_force, HMC_mass.cc:372-407)."""
    kk = torch.sqrt(fourier.k_squared(g, device=power.device))
    dk = g.kmax / nbin
    bins = torch.clamp(torch.floor(kk / dk).to(torch.int64), max=nbin - 1)
    return torch.where(kk > 0.0, power[bins], 0.0)


def compute_mass(g: GridSpec, mass_type: int, power_rfft, nbin: int = 200,
                 likeli_force=None, mass_factor: float = 1.0,
                 window=None, noise=None, kernel_h: float = 0.0,
                 burned_in: bool = True) -> MassState:
    """The MassState of `mass_type` (mass.py:115-160).  `likeli_force`
    (grad of -log L at the current signal, grid shape) is required for
    types 2 and 3; `window`, `noise` and `kernel_h` for 5/6/60."""
    mass_f = torch.zeros_like(power_rfft)
    mass_r = 0.0
    if mass_type == 0:
        mass_r = 1.0
    elif mass_type == 1:
        mass_f = _inv_power(power_rfft)
    elif mass_type in (5, 6, 60):
        if mass_type == 5:
            mass_f = _inv_power(power_rfft)
        if mass_type == 60 and not burned_in:
            mass_r = 1.0  # type 0 until burn-in (HMC_mass.cc:346-356)
        else:
            if window is None or noise is None or kernel_h <= 0:
                raise ValueError(
                    f"mass_type {mass_type} needs window/noise/kernel_h")
            mass_r = jasche_diagonal_mass(g, window, noise, kernel_h)
    elif mass_type in (2, 3):
        if likeli_force is None:
            raise ValueError(
                f"mass_type {mass_type} needs the likelihood force")
        kmode, power, _ = fourier.measure_spectrum(likeli_force, g, nbin)
        invP = _inv_power(power_rfft)
        if mass_type == 2:
            force = _spectrum_to_grid(g, kmode, power, nbin)
        else:
            # mean force over k, volume-weighted (HMC_mass.cc:145-160)
            w = 4.0 * math.pi * kmode * kmode * (g.kmax / nbin)
            force = torch.sum(w * power) / torch.sum(w)
        mass_f = 2.0 * invP + torch.sqrt(invP * force)
    elif mass_type == 4:
        mass_f = power_rfft
    else:
        raise ValueError(f"mass_type {mass_type} not implemented")
    fs, rs = mass_flags(mass_type)
    if fs:
        mass_f = mass_f * mass_factor  # testing knob (HMC_mass.cc:357-359)
    return MassState(mass_f=mass_f if fs else torch.zeros_like(power_rfft),
                     mass_r=mass_r if rs else 0.0)


def _inv_mass_r(mass_r, like):
    m = torch.as_tensor(mass_r, dtype=like.dtype, device=like.device)
    pos = m > 0.0
    return torch.where(pos, 1.0 / torch.where(pos, m, 1.0), 0.0)


def apply_minv(p, g: GridSpec, mass_type: int, mass: MassState):
    """M^-1 p: FS part IFFT[(V/N)/mass_f FFT(p)] plus RS part p/mass_r
    (Hamiltonian_EoM step 2a, HMC.cc:298-327 + HMC_help.cc:16-64)."""
    fs, rs = mass_flags(mass_type)  # every type has one part or both
    out = fourier.convolve_inv_corr(p, g, mass.mass_f) if fs else None
    if rs:
        part = _inv_mass_r(mass.mass_r, p) * p
        out = part if out is None else out + part
    return out


def kinetic(p, g: GridSpec, mass_type: int, mass: MassState):
    """1/2 p . M^-1 p per chain (kinetic_term, HMC.cc:64-121)."""
    return 0.5 * torch.sum(p * apply_minv(p, g, mass_type, mass), dim=_GRID)


def momenta_from_white(white_f, white_r, g: GridSpec, mass_type: int,
                       mass: MassState):
    """p ~ N(0, M) from unit white noise: FS mass -> `white_f` coloured to
    the spectrum mass_f (create_GARFIELD(mass_f), HMC_momenta.cc:52-54);
    RS mass -> sqrt(mass_r) * `white_r` per cell (:77-92); the sum if both.
    The noise of a part the type lacks is not read (pass None)."""
    fs, rs = mass_flags(mass_type)  # every type has one part or both
    p = random_fields.grf_from_white(white_f, g, mass.mass_f) if fs else None
    if rs:
        m = torch.as_tensor(mass.mass_r, dtype=white_r.dtype,
                            device=white_r.device)
        part = torch.sqrt(m) * white_r
        p = part if p is None else p + part
    return p


def draw_momenta(generator: torch.Generator, g: GridSpec, mass_type: int,
                 mass: MassState, batch: tuple = (), dtype=torch.float32):
    """p ~ N(0, M) from `generator`: the FS part's noise first, then the RS
    part's (`momenta_from_white`).  The samplers draw each chain's noise
    from its own generators (`sampler.draw_randoms`); this one-generator
    draw stays as the twin of the JAX package's public `draw_momenta`."""
    fs, rs = mass_flags(mass_type)
    noise = lambda: random_fields.white_noise(generator, g, batch, dtype)
    white_f = noise() if fs else None
    white_r = noise() if rs else None
    return momenta_from_white(white_f, white_r, g, mass_type, mass)
