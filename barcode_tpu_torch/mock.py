"""Mock-data generation (the reference's random_test mode).

Port of barcode_tpu/mock.py (setup_random_test, barcoderunner.cc:42-205):
GRF truth -> forward model (optionally RSD) -> window -> observed tracer
field under the chosen noise model.  Draws come from a `torch.Generator`.
The truth is the resolution-independent draw by default, as in the JAX
package (one seed gives the same large-scale modes at N and 2N), or the
plain `grf` with resolution_independent=False; the noise continues the
same generator.  The two packages' mocks agree in distribution, not in
value.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch import random_fields
from barcode_tpu_torch.config import MockConfig
from barcode_tpu_torch.forward.lag2eul import ForwardConfig, GrowthParams, lag2eul
from barcode_tpu_torch.model.likelihoods import ObsData


@dataclasses.dataclass
class MockData:
    truth_lag: Any
    truth_eul: Any
    obs: ObsData


def make_window(window_type: int, delta_eul, g: GridSpec):
    """1 all ones; 10 half ones half zeros; 23 ones where delta_eul > 3
    (barcoderunner.cc:91-113)."""
    dev = delta_eul.device
    if window_type == 1:
        return torch.ones(g.shape, device=dev)
    if window_type == 10:
        w = torch.ones(g.N, device=dev)
        w[: g.N // 2] = 0.0
        return w.reshape(g.shape)
    if window_type == 23:
        return (delta_eul > 3.0).to(torch.float32)
    raise ValueError(f"window_type {window_type} is not a valid choice")


def generate(generator: torch.Generator, g: GridSpec, mock: MockConfig,
             fc: ForwardConfig, gp: GrowthParams, power_rfft, likelihood: int,
             rho_c: float = 1.0, delta_min: float = -0.999,
             resolution_independent: bool = True) -> MockData:
    """One mock on the generator's device (mock.py:44-88)."""
    if resolution_independent:
        truth = random_fields.grf_resolution_independent(generator, g,
                                                         power_rfft)
    else:
        truth = random_fields.grf(generator, g, power_rfft)
    fc_mock = dataclasses.replace(fc, rsd=mock.random_test_rsd)
    with torch.no_grad():
        d_eul = lag2eul(truth, g, fc_mock, gp)
    window = make_window(mock.window_type, d_eul, g)

    def normal():
        return torch.randn(g.shape, generator=generator,
                           device=generator.device)

    if mock.data_model == 0:  # linear / additive error
        lam = rho_c * (1.0 + d_eul)
        if likelihood == 0:
            nobs = torch.poisson(torch.clamp(lam, min=0.0), generator=generator)
            noise = torch.ones(g.shape, device=lam.device)
        elif likelihood == 1:
            noise = mock.sigma_min + mock.sigma_fac * lam
            nobs = lam + noise * normal()
            if not mock.negative_obs:
                nobs = torch.clamp(nobs, min=0.0)
        elif likelihood == 3:
            noise = mock.sigma_min + mock.sigma_fac * truth**2
            nobs = truth + noise * normal()
        else:
            raise ValueError("linear data model is incompatible with likelihood "
                             f"{likelihood} (init check, barcoderunner.cc:160-165)")
    elif mock.data_model == 1:  # log-normal / multiplicative
        lam = torch.log(rho_c * (1.0 + torch.clamp(d_eul, min=delta_min)))
        noise = torch.full(g.shape, mock.sigma_fac, device=lam.device)
        nobs = lam + noise * normal()
    else:
        raise ValueError(f"data_model {mock.data_model} is not a valid choice")

    nobs = torch.where(window > 0, nobs, 0.0)
    obs = ObsData(nobs=nobs, window=window, noise=noise, power=power_rfft,
                  rho_c=rho_c, delta_min=delta_min)
    return MockData(truth_lag=truth, truth_eul=d_eul, obs=obs)


def validate(md: MockData, likelihood: int) -> None:
    """Zero noise inside the window NaNs the Gaussian/GRF likelihoods
    (barcoderunner.cc:190-198)."""
    if likelihood in (1, 3):
        if bool((md.obs.noise[md.obs.window > 0] <= 0.0).any()):
            raise ValueError("noise = 0 found inside the window "
                             "(guard of barcoderunner.cc:190-198)")
