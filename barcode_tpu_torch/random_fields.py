"""Gaussian random fields with a prescribed power spectrum.

Port of barcode_tpu/random_fields.py:34-51 (`white_noise`,
`grf_from_white`, `grf`).  rfftn of white real-space noise is Hermitian
with E|X_k|^2 = N for every mode, so scaling by sqrt(P * N / V) gives
E|delta_k|^2 = N^2 P / V — the reference's target amplitude.

Draws come from an explicit `torch.Generator`; its stream differs from
JAX's threefry, so parity tests hand the same white noise to both packages.
The resolution-independent variant of the JAX package waits for a later
slice.
"""
from __future__ import annotations

import torch

from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.grid import fourier


def white_noise(generator: torch.Generator, g: GridSpec, batch: tuple = (),
                dtype=torch.float32):
    """Unit normal noise of shape batch + grid shape, on the generator's
    device."""
    return torch.randn(tuple(batch) + g.shape, generator=generator,
                       dtype=dtype, device=generator.device)


def grf_from_white(white, g: GridSpec, power_rfft):
    """Color real-space white noise to the target spectrum (half-complex P)."""
    amp = torch.sqrt(power_rfft * (g.N / g.vol))
    return fourier.irfft3(amp * fourier.rfft3(white), g)


def grf(generator: torch.Generator, g: GridSpec, power_rfft, batch: tuple = (),
        dtype=torch.float32):
    """delta ~ GRF with spectrum P(k); E[measure_spectrum(delta)] = P."""
    return grf_from_white(white_noise(generator, g, batch, dtype), g,
                          power_rfft)
