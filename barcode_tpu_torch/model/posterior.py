"""The target density: psi(delta_lag) = psi_prior + psi_likelihood(forward).

Port of barcode_tpu/model/posterior.py:43-124.  The gradient is torch
autograd of the discrete psi — the exact adjoint of the forward model, with
the kernel deposit's backward (K2) inside it.  One rfft3(delta) serves the
prior energy and the LPT solve, as in the JAX package.

`delta_lag` may carry a leading chain dimension; psi and its parts are then
one value per chain and the gradient has the shape of `delta_lag` (chains
are independent, so the gradient of the summed psi is each chain's own).
"""
from __future__ import annotations

import dataclasses

import torch

from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.grid import fourier
from barcode_tpu_torch.forward.lag2eul import ForwardConfig, GrowthParams, lag2eul
from barcode_tpu_torch.model import likelihoods
from barcode_tpu_torch.model.likelihoods import ObsData


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static statistical-model selection (input.par likelihood/prior/sfmodel
    block), as the JAX ModelConfig."""

    likelihood: int = 1     # 0 poisson, 1 gaussian, 2 lognormal, 3 grf
    prior: int = 0          # 0 gaussian (the only one, like the reference)
    forward: ForwardConfig = ForwardConfig()
    deltaQ_factor: float = 1.0  # test knob: forward model sees deltaQ_factor * s
    grad_prior_factor: float = 1.0   # input.par grad_psi_prior_factor
    grad_likeli_factor: float = 1.0  # input.par grad_psi_likeli_factor
    correct_delta: bool = False      # x D1 on the likelihood force
    calc_h: int = 3  # parsed for input.par compatibility; the gradient is
                     # always the exact autograd adjoint


def make_psi(g: GridSpec, mc: ModelConfig, gp: GrowthParams, obs: ObsData):
    """psi(delta_lag) -> (psi_total, (psi_prior, psi_likeli))."""

    def psi(delta_lag):
        delta_lag_C = fourier.rfft3(delta_lag)
        psi_prior = likelihoods.prior_psi_C(delta_lag_C, g, obs)
        if mc.likelihood == 3:
            psi_like = likelihoods.grf_psi(delta_lag, obs)
        else:
            delta_x = lag2eul(mc.deltaQ_factor * delta_lag, g, mc.forward, gp,
                              delta_C=mc.deltaQ_factor * delta_lag_C)
            psi_like = likelihoods.likelihood_psi(mc.likelihood, delta_x, obs)
        return psi_prior + psi_like, (psi_prior, psi_like)

    return psi


def _value_and_grad(target):
    """delta -> ((psi, (pp, pl)), grad of the first output of `target`)."""

    def vag(delta_lag):
        with torch.enable_grad():
            d = delta_lag.detach().requires_grad_(True)
            obj, (psi, (pp, pl)) = target(d)
            (grad,) = torch.autograd.grad(obj.sum(), d)
        return (psi.detach(), (pp.detach(), pl.detach())), grad

    return vag


def make_psi_value_and_grad(g: GridSpec, mc: ModelConfig, gp: GrowthParams,
                            obs: ObsData):
    """delta -> ((psi, (psi_prior, psi_likeli)), grad psi): one forward and
    one backward pass."""
    psi_fn = make_psi(g, mc, gp, obs)

    def target(d):
        psi, aux = psi_fn(d)
        return psi, (psi, aux)

    return _value_and_grad(target)


def make_psi_force(g: GridSpec, mc: ModelConfig, gp: GrowthParams,
                   obs: ObsData):
    """Like make_psi_value_and_grad, but the gradient is of the scaled target
    f_p*prior + f_l*like (the reference's gradient test factors;
    correct_delta folds x D1 into f_l) while psi stays exact
    (posterior.py:97-124).  Default factors give make_psi_value_and_grad."""
    f_p = float(mc.grad_prior_factor)
    f_l = float(mc.grad_likeli_factor) * (gp.D1 if mc.correct_delta else 1.0)
    if f_p == 1.0 and f_l == 1.0:
        return make_psi_value_and_grad(g, mc, gp, obs)
    psi_fn = make_psi(g, mc, gp, obs)

    def target(d):
        _, (pp, pl) = psi_fn(d)
        return f_p * pp + f_l * pl, (pp + pl, (pp, pl))

    return _value_and_grad(target)
