"""Density-field transfer functions: rank-order mappings and tabulated
Fourier-space transfer multipliers.

Port of barcode_tpu/forward/transfer.py:1-57: the Leclercq+13 ZA/2LPT ->
N-body rank-order density mappings (rankorder.cc:17-60), the nonlinear
scale of a tabulated spectrum (transf.cpp:76-97, numpy float64) and the
isotropic transfer T(|k|) interpolated from a table (the convcompb
pattern, convolution.cpp:380-403), which builds the TRANSF kernels that
`lpt.lpt_psi(transfer=...)` takes.
"""
from __future__ import annotations

import numpy as np
import torch

from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.grid import fourier


def rankorder_leclercq_za(delta_za):
    """delta_ZA -> delta_Nbody (Leclercq+13), piecewise power law
    (rankorder.cc:17-27)."""
    delta_th = (0.610 / 0.371) ** (1.0 / (1.752 - 1.424))
    x = torch.clamp(delta_za + 1.0, min=0.0)
    return torch.where(delta_za < delta_th, 0.610 * x**1.424 - 1.0,
                       0.371 * x**1.752 - 1.0)


def rankorder_leclercq_2lpt(delta_2lpt):
    """delta_2LPT -> delta_Nbody (rankorder.cc:29-39)."""
    delta_th = (0.642 / 0.257) ** (1.0 / (1.922 - 1.401))
    x = torch.clamp(delta_2lpt + 1.0, min=0.0)
    return torch.where(delta_2lpt < delta_th, 0.642 * x**1.401 - 1.0,
                       0.257 * x**1.922 - 1.0)


def k_nonlinear(k_table, p_table) -> float:
    """kNL where the integrated dimensionless variance reaches 1
    (transf.cpp:76-97: sum 4 pi dk k^2 P/(4 pi) over the table)."""
    k = np.asarray(k_table, np.float64)
    p = np.asarray(p_table, np.float64)
    dk = np.diff(k, prepend=k[0])
    cum = np.cumsum(dk * k * k * p)
    ix = np.searchsorted(cum, 1.0)
    return float(k[min(ix, len(k) - 1)])


def transfer_on_grid(g: GridSpec, k_table, t_table, device=None):
    """T(|k|) on the half-complex grid, linearly interpolated from the
    table (float32, end values held), as a TRANSF kernel."""
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                     device=device)
    kk = torch.sqrt(fourier.k_squared(g, device=device))
    return fourier.interp(kk, as_t(k_table), as_t(t_table))


def apply_transfer_table(x, g: GridSpec, k_table, t_table):
    """Multiply a field by a tabulated isotropic transfer function T(|k|)."""
    T = transfer_on_grid(g, k_table, t_table, x.device)
    return fourier.irfft3(T * fourier.rfft3(x), g)
