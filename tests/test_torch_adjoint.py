"""Port parity: the analytic likelihood adjoint (model/adjoint.py) against
the port's autograd gradient and against the JAX package's analytic
adjoint, parametrised as tests/test_adjoint.py:22 (12^3, box 120, flat
P = 30, sph_ft).

Tolerances: 2e-3 * max|grad| against autograd, the JAX test's own anchor
(two derivations of ~20 float32 transforms that round differently); 1e-4
* max|grad| against the JAX adjoint (the same derivation, float32 FFTs of
two libraries).  With TRANSF kernels only autograd is compared: the JAX
adjoint takes none.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from barcode_tpu.grid.spec import GridSpec as JGridSpec
from barcode_tpu.forward.lag2eul import (ForwardConfig as JForwardConfig,
                                         GrowthParams as JGrowthParams)
from barcode_tpu.model import adjoint as jadjoint
from barcode_tpu.model.likelihoods import ObsData as JObsData

from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch import random_fields
from barcode_tpu_torch.forward import transfer as tr
from barcode_tpu_torch.forward.lag2eul import (ForwardConfig, GrowthParams,
                                               lag2eul)
from barcode_tpu_torch.model import adjoint, likelihoods
from barcode_tpu_torch.model.likelihoods import ObsData

N, L = 12, 120.0
G, JG = GridSpec.cube(N, L), JGridSpec.cube(N, L)
GPD = dict(D1=0.9, D2=-0.4, ascale=1.0, cpecvel=52.85, hubble=100.0)
GP, JGP = GrowthParams(**GPD), JGrowthParams(**GPD)


def problem(sfmodel, rsd, likelihood, seed=0):
    """(fc, obs, s) of tests/test_adjoint.py, from numpy draws."""
    rng = np.random.default_rng(seed)
    fc = ForwardConfig(sfmodel=sfmodel, masskernel="sph_ft", rsd=rsd)
    P = torch.full(G.rshape, 30.0)
    P[0, 0, 0] = 0.0
    truth = random_fields.grf_from_white(
        torch.from_numpy(rng.standard_normal(G.shape).astype(np.float32)),
        G, P)
    with torch.no_grad():
        d_eul = lag2eul(truth, G, fc, GP)
    if likelihood == 0:
        nobs = torch.from_numpy(rng.poisson(
            np.maximum(1.0 + d_eul.numpy(), 0.0)).astype(np.float32))
    else:
        nobs = 1.0 + d_eul + 0.3 * torch.from_numpy(
            rng.standard_normal(G.shape).astype(np.float32))
    obs = ObsData(nobs=nobs, window=torch.ones(G.shape),
                  noise=torch.full(G.shape, 0.5), power=P)
    return fc, obs, 0.7 * truth


def autograd_like(s, fc, obs, likelihood, transfer=None):
    s = s.clone().requires_grad_(True)
    psi = likelihoods.likelihood_psi(
        likelihood, lag2eul(s, G, fc, GP, transfer=transfer), obs)
    (grad,) = torch.autograd.grad(psi.sum(), s)
    return grad


def assert_close(out, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref,
                               atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("likelihood", [0, 1])
@pytest.mark.parametrize("rsd", [False, True])
@pytest.mark.parametrize("sfmodel", [1, 2, 3])
def test_analytic_adjoint_matches_autograd_and_jax(likelihood, rsd, sfmodel):
    fc, obs, s = problem(sfmodel, rsd, likelihood)
    ana = adjoint.grad_log_like_analytic(s, G, fc, GP, obs, likelihood)
    assert_close(ana, autograd_like(s, fc, obs, likelihood), 2e-3)
    jobs = JObsData(nobs=jnp.asarray(obs.nobs.numpy()),
                    window=jnp.ones(JG.shape), noise=jnp.full(JG.shape, 0.5),
                    power=jnp.asarray(obs.power.numpy()))
    jfc = JForwardConfig(sfmodel=sfmodel, masskernel="sph_ft", rsd=rsd)
    ref = jadjoint.grad_log_like_analytic(jnp.asarray(s.numpy()), JG, jfc,
                                          JGP, jobs, likelihood)
    assert_close(ana, ref, 1e-4)


@pytest.mark.parametrize("sfmodel", [2, 3])
def test_analytic_adjoint_with_transf_matches_autograd(sfmodel):
    """TRANSF kernels T_zeld = 1.1 exp(-(4k)^2/2) and T_2lpt = 0.8 +
    0.2/(1 + (k/0.2)^2), from tables through transfer.transfer_on_grid."""
    fc, obs, s = problem(sfmodel, True, 1, seed=3)
    k = np.linspace(0.0, 1.0, 64)
    t = (tr.transfer_on_grid(G, k, 1.1 * np.exp(-(4.0 * k) ** 2 / 2)),
         tr.transfer_on_grid(G, k, 0.8 + 0.2 / (1.0 + (k / 0.2) ** 2)))
    ana = adjoint.grad_log_like_analytic(s, G, fc, GP, obs, 1, transfer=t)
    assert_close(ana, autograd_like(s, fc, obs, 1, transfer=t), 2e-3)


def test_analytic_adjoint_refuses_what_it_does_not_cover():
    fc, obs, s = problem(1, False, 1)
    for bad in (dict(masskernel=2), dict(deriv_scheme="findif"),
                dict(rsd=True, rsd_planepar=False)):
        with pytest.raises(ValueError):
            adjoint.grad_log_like_analytic(
                s, G, ForwardConfig(**{**fc.__dict__, **bad}), GP, obs, 1)
