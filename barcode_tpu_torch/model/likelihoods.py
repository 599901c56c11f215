"""Statistical models: Gaussian prior and the likelihoods.

Port of barcode_tpu/model/likelihoods.py.  All functions return
psi = -log p (up to constants), summed over the last three (grid) axes, so a
batch of chains gives one value per chain.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.grid import fourier

_GRID = (-3, -2, -1)


@dataclasses.dataclass(frozen=True)
class ObsData:
    """Observed tracer grid + window + noise + prior spectrum (tensors of
    grid shape; power in the half-complex layout), as the JAX ObsData."""

    nobs: Any
    window: Any
    noise: Any
    power: Any  # P(k) on the rfft grid (prior covariance spectrum)
    rho_c: float = 1.0
    biasP: float = 1.0
    biasE: float = 1.0
    delta_min: float = -0.999  # log-normal clip

    def to(self, device) -> "ObsData":
        """The same data with every tensor moved to `device`."""
        return dataclasses.replace(
            self, nobs=self.nobs.to(device), window=self.window.to(device),
            noise=self.noise.to(device), power=self.power.to(device))


def prior_psi(delta_lag, g: GridSpec, obs: ObsData):
    """psi_prior = 1/2 s . IFFT[(V/N)/P(k) FFT(s)] (likelihoods.py:48-52)."""
    Sinv_s = fourier.convolve_inv_corr(delta_lag, g, obs.power)
    return 0.5 * torch.sum(delta_lag * Sinv_s, dim=_GRID)


def prior_grad(delta_lag, g: GridSpec, obs: ObsData):
    """d psi_prior / d s = S^-1 s (likelihoods.py:62-64)."""
    return fourier.convolve_inv_corr(delta_lag, g, obs.power)


def prior_psi_C(delta_C, g: GridSpec, obs: ObsData):
    """psi_prior = 1/2 s . S^-1 s from the half-complex spectrum of s via
    Parseval (likelihoods.py:51-56)."""
    return fourier.inv_corr_quadratic_C(delta_C, g, obs.power)


def _lambda_powerlaw(delta_x, obs: ObsData):
    """Lambda = w * rho_c * (1 + biasP*delta)^biasE with positivity masks."""
    dens = 1.0 + obs.biasP * delta_x
    lam = obs.window * obs.rho_c * torch.clamp(dens, min=1e-30) ** obs.biasE
    return lam, dens


def poisson_psi(delta_x, obs: ObsData):
    """-log L = sum Lambda - nobs*log(Lambda) over valid cells."""
    lam, _ = _lambda_powerlaw(delta_x, obs)
    valid = (obs.window > 0.0) & (lam > 0.0)
    term = lam - obs.nobs * torch.log(torch.where(valid, lam, 1.0))
    return torch.sum(torch.where(valid, term, 0.0), dim=_GRID)


def gaussian_psi(delta_x, obs: ObsData):
    """-log L = 1/2 sum ((Lambda - nobs)/sigma)^2 (likelihoods.py:86-92)."""
    lam, _ = _lambda_powerlaw(delta_x, obs)
    valid = (obs.window > 0.0) & (lam > 0.0)
    resid = (lam - obs.nobs) / obs.noise
    return torch.sum(torch.where(valid, 0.5 * resid * resid, 0.0), dim=_GRID)


def lognormal_psi(delta_x, obs: ObsData):
    """-log L = 1/2 sum ((log rho_c(1+max(delta,delta_min)) - nobs)/sigma)^2."""
    lam = torch.log(obs.rho_c * (1.0 + torch.clamp(delta_x, min=obs.delta_min)))
    resid = (lam - obs.nobs) / obs.noise
    return torch.sum(torch.where(obs.window > 0.0, 0.5 * resid * resid, 0.0),
                     dim=_GRID)


def grf_psi(delta_lag, obs: ObsData):
    """GRF likelihood on the Lagrangian field directly, no dynamics."""
    resid = (delta_lag - obs.nobs) / obs.noise
    return torch.sum(torch.where(obs.window > 0.0, 0.5 * resid * resid, 0.0),
                     dim=_GRID)


def likelihood_psi(likelihood: int, delta_field, obs: ObsData):
    """Dispatch on the likelihood id; `delta_field` is delta_eul for 0..2
    and delta_lag for 3."""
    if likelihood == 0:
        return poisson_psi(delta_field, obs)
    if likelihood == 1:
        return gaussian_psi(delta_field, obs)
    if likelihood == 2:
        return lognormal_psi(delta_field, obs)
    if likelihood == 3:
        return grf_psi(delta_field, obs)
    raise ValueError(f"unknown likelihood {likelihood}")


def partial_f_delta_x(likelihood: int, delta_x, obs: ObsData):
    """d(-log L)/d delta_x elementwise, the reference's
    partial_f_delta_x_log_like (likelihoods.py:130-160), for the analytic
    adjoint (model/adjoint.py): 0 Poisson, 1 Gaussian, 2 log-normal."""
    if likelihood in (0, 1):
        lam, dens = _lambda_powerlaw(delta_x, obs)
        slope = obs.rho_c * obs.biasE * obs.biasP \
            * torch.clamp(dens, min=1e-30) ** (obs.biasE - 1.0)
        if likelihood == 0:
            valid = (obs.window > 0.0) & (dens > 0.0)
            out = (1.0 - obs.nobs / torch.where(lam > 0, lam, 1.0)) * slope
        else:
            valid = (obs.window > 0.0) & (lam > 0.0)
            out = (lam - obs.nobs) / (obs.noise * obs.noise) \
                * (obs.window * slope)
        return torch.where(valid, out, 0.0)
    if likelihood == 2:
        dclip = torch.clamp(delta_x, min=obs.delta_min)
        lam = torch.log(obs.rho_c * (1.0 + dclip))
        out = (lam - obs.nobs) / (obs.noise * obs.noise) / (1.0 + dclip)
        out = torch.where(delta_x > obs.delta_min, out, 0.0)
        return torch.where(obs.window > 0.0, out, 0.0)
    raise ValueError(f"partial_f_delta_x undefined for likelihood {likelihood}")
