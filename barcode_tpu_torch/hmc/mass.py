"""HMC mass matrix, type 1: the Fourier-space inverse power spectrum.

Port of barcode_tpu/hmc/mass.py:115-196 for mass_type 1 (the headline
configuration's).  The other types wait for a later slice.
"""
from __future__ import annotations

import torch

from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.grid import fourier
from barcode_tpu_torch import random_fields
from barcode_tpu_torch.hmc.state import MassState

_GRID = (-3, -2, -1)


def _require_type1(mass_type: int):
    if mass_type != 1:
        raise NotImplementedError(
            f"mass_type {mass_type} is not ported yet (type 1 is)")


def compute_mass(g: GridSpec, mass_type: int, power_rfft,
                 mass_factor: float = 1.0) -> MassState:
    """Type 1: mass_f = 1/P(k) (0 where P <= 0), times the testing knob
    mass_factor (HMC_mass.cc:315-368)."""
    _require_type1(mass_type)
    pos = power_rfft > 0.0
    inv = torch.where(pos, 1.0 / torch.where(pos, power_rfft, 1.0), 0.0)
    return MassState(mass_f=inv * mass_factor, mass_r=0.0)


def apply_minv(p, g: GridSpec, mass_type: int, mass: MassState):
    """M^-1 p = IFFT[(V/N)/mass_f FFT(p)] (HMC.cc:298-327)."""
    _require_type1(mass_type)
    return fourier.convolve_inv_corr(p, g, mass.mass_f)


def kinetic(p, g: GridSpec, mass_type: int, mass: MassState):
    """1/2 p . M^-1 p per chain (kinetic_term, HMC.cc:64-121)."""
    return 0.5 * torch.sum(p * apply_minv(p, g, mass_type, mass), dim=_GRID)


def draw_momenta(generator: torch.Generator, g: GridSpec, mass_type: int,
                 mass: MassState, batch: tuple = (), dtype=torch.float32):
    """p ~ N(0, M): a GRF with spectrum mass_f (HMC_momenta.cc:52-54)."""
    _require_type1(mass_type)
    return random_fields.grf(generator, g, mass.mass_f, batch, dtype)
