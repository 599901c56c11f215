"""Port parity for the slice as a whole: psi and grad psi of the headline
configuration, the eps controllers, and mirrors of tests/test_hmc.py's
integrator tests.  (Attempts driven by the JAX package's own random draws:
tests/test_torch_sampler.py.)

Tolerances: psi 1e-5 relative (float32 sums of N terms in another order);
grad psi 1e-4 * max|grad| (a ~30-transform float32 chain through ALPT,
whose spherical-collapse term scales float32 differences by 1/sqrt(arg));
dH 1e-5 * |H| absolute (H is a sum of N-sized energies, dH a difference of
two); trajectories 1e-4 * max|delta|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from barcode_tpu.grid.spec import GridSpec as JGridSpec
from barcode_tpu.grid import fourier as jfourier
from barcode_tpu import random_fields as jrf
from barcode_tpu.config import HMCConfig as JHMCConfig
from barcode_tpu.forward import pallas_deposit as pd
from barcode_tpu.forward.lag2eul import (ForwardConfig as JForwardConfig,
                                         GrowthParams as JGrowthParams,
                                         lag2eul as jlag2eul)
from barcode_tpu.model import posterior as jposterior
from barcode_tpu.model.likelihoods import ObsData as JObsData
from barcode_tpu.hmc import adapt as jadapt

from barcode_tpu_torch import convert
from barcode_tpu_torch.config import HMCConfig
from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.forward.lag2eul import GrowthParams
from barcode_tpu_torch.model import posterior
from barcode_tpu_torch.hmc import adapt, mass as mass_mod, sampler

GPD = dict(D1=1.0, D2=-3.0 / 7.0, ascale=1.0, cpecvel=52.85, hubble=100.0)


def fields_of(dc):
    return {f.name: getattr(dc, f.name) for f in dataclasses.fields(dc)}


def headline_problem(n, L, tail_k=None, halo=None, key=0):
    """The bench.py headline model (ALPT + plane-parallel RSD, sph_ft,
    Gaussian likelihood, kernel deposit with the halo-tail split) on a small
    grid, built in the JAX package; returns its pieces."""
    jg = JGridSpec.cube(n, L)
    kk = jnp.sqrt(jfourier.k_squared(jg))
    P = (1e4 * (kk / 0.02) / (1.0 + (kk / 0.02) ** 2) ** 1.5).at[0, 0, 0].set(0.0)
    truth = jax.jit(lambda k: jrf.grf(k, jg, P))(jax.random.key(key))
    gp = JGrowthParams(**GPD)
    fc0 = JForwardConfig(sfmodel=3, masskernel="sph_ft", rsd=True, slength=4.0)
    tail_k = max(jg.N // 2048, 1024) if tail_k is None else tail_k
    if halo is None:
        halo = pd.displacement_halo_quantile(truth, jg, fc0, gp, tail_k)
    fc = dataclasses.replace(fc0, pallas_deposit=True, pallas_halo=halo,
                             pallas_tail_k=tail_k)
    d_eul = jax.jit(lambda t: jlag2eul(t, jg, fc0, gp))(truth)
    nobs = jnp.maximum(1.0 + d_eul + jax.random.normal(jax.random.key(key + 1),
                                                       jg.shape), 0.0)
    obs = JObsData(nobs=nobs, window=jnp.ones(jg.shape),
                   noise=jnp.ones(jg.shape), power=P)
    return jg, gp, fc, obs, truth


def port_problem(jg, fc, obs):
    g = GridSpec(jg.N1, jg.N2, jg.N3, jg.L1, jg.L2, jg.L3)
    mc = posterior.ModelConfig(likelihood=1,
                               forward=convert.forward_config(fields_of(fc)))
    return g, mc, convert.obs_data(fields_of(obs), device="cpu")


@pytest.mark.parametrize("chains", [1, 2])
def test_psi_and_grad_headline_config_match(chains):
    jg, gp, fc, obs, truth = headline_problem(16, 25.0)
    jmc = jposterior.ModelConfig(likelihood=1, forward=fc)
    deltas = np.stack([0.5 * np.asarray(truth), 0.3 * np.asarray(truth)])[:chains]
    vag_j = jax.jit(jax.vmap(jposterior.make_psi_value_and_grad(jg, jmc, gp, obs)))
    (psi_j, (pp_j, pl_j)), grad_j = vag_j(jnp.asarray(deltas))

    g, mc, tobs = port_problem(jg, fc, obs)
    assert mc.forward.pallas_halo == fc.pallas_halo and mc.forward.pallas_tail_k
    vag = posterior.make_psi_value_and_grad(g, mc, GrowthParams(**GPD), tobs)
    (psi, (pp, pl)), grad = vag(torch.from_numpy(deltas))
    for a, b in ((psi, psi_j), (pp, pp_j), (pl, pl_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
    grad_j = np.asarray(grad_j)
    np.testing.assert_allclose(grad.numpy(), grad_j,
                               atol=1e-4 * np.abs(grad_j).max())


def _small_problem():
    """A 8^3 unit-cell model on the kernel deposit path (plain versions on
    the CPU), as tests/test_hmc.py's setup."""
    jg, gp, fc, obs, truth = headline_problem(8, 8.0, tail_k=64, halo=2, key=5)
    g, mc, tobs = port_problem(jg, fc, obs)
    vag = posterior.make_psi_value_and_grad(g, mc, GrowthParams(**GPD), tobs)
    mass = mass_mod.compute_mass(g, 1, tobs.power)
    minv = lambda p: mass_mod.apply_minv(p, g, 1, mass)
    s0 = torch.from_numpy(0.3 * np.asarray(truth))[None]
    gen = torch.Generator().manual_seed(9)
    p0 = mass_mod.draw_momenta(gen, g, 1, mass, (1,))
    return g, vag, minv, mass, s0, p0


def test_leapfrog_reversibility():
    g, vag, minv, mass, s0, p0 = _small_problem()
    (psi0, (pp0, pl0)), g0 = vag(s0)
    eps, n = torch.tensor([0.05]), torch.tensor([6])
    s1, psi1, pp1, pl1, g1, p1 = sampler.leapfrog(
        vag, minv, (s0, psi0, pp0, pl0, g0, p0), eps, n, 6)
    s2, _, _, _, _, p2 = sampler.leapfrog(
        vag, minv, (s1, psi1, pp1, pl1, g1, -p1), eps, n, 6)
    np.testing.assert_allclose(s2.numpy(), s0.numpy(), atol=2e-4)
    np.testing.assert_allclose(-p2.numpy(), p0.numpy(), atol=2e-2)


def test_dH_scaling_with_eps():
    """|dH| ~ O(eps^2) at fixed trajectory time: halving eps shrinks it."""
    g, vag, minv, mass, s0, p0 = _small_problem()
    (psi0, (pp0, pl0)), g0 = vag(s0)
    K0 = mass_mod.kinetic(p0, g, 1, mass)

    def dH_for(eps, n):
        out = sampler.leapfrog(vag, minv, (s0, psi0, pp0, pl0, g0, p0),
                               torch.tensor([eps]), torch.tensor([n]), n)
        return abs(float(mass_mod.kinetic(out[5], g, 1, mass) + out[1]
                         - (K0 + psi0)))

    d1, d2, d3 = dH_for(0.2, 4), dH_for(0.1, 8), dH_for(0.05, 16)
    assert d2 < d1, (d1, d2)
    assert d3 < d2 * 0.7, (d2, d3)


def test_masked_batch_matches_per_chain_lengths():
    """Two chains with Neps = (3, 8) in one masked 8-step batch equal their
    separate exact-length runs."""
    g, vag, minv, mass, s0, p0 = _small_problem()
    s = torch.cat([s0, 0.5 * s0])
    p = torch.cat([p0, -p0])
    (psi, (pp, pl)), gr = vag(s)
    out = sampler.leapfrog(vag, minv, (s, psi, pp, pl, gr, p),
                           torch.tensor([0.1, 0.1]), torch.tensor([3, 8]), 8)
    for c, n in ((0, 3), (1, 8)):
        one = sampler.leapfrog(vag, minv, (s[c:c + 1], psi[c:c + 1],
                                           pp[c:c + 1], pl[c:c + 1],
                                           gr[c:c + 1], p[c:c + 1]),
                               torch.tensor([0.1]), torch.tensor([n]), n)
        np.testing.assert_allclose(out[0][c].numpy(), one[0][0].numpy(),
                                   atol=1e-6)


def test_kinetic_energy_expectation():
    """p ~ N(0, M) => E[1/2 p M^-1 p] = (N-1)/2 for the FS mass."""
    g = GridSpec.cube(8, 8.0)
    P = torch.full(g.rshape, 0.2)
    P[0, 0, 0] = 0.0
    mass = mass_mod.compute_mass(g, 1, P)
    gen = torch.Generator().manual_seed(0)
    p = mass_mod.draw_momenta(gen, g, 1, mass, (24,))
    np.testing.assert_allclose(mass_mod.kinetic(p, g, 1, mass).mean().item(),
                               (g.N - 1) / 2.0, rtol=0.08)


@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("update_type", [0, 1, 2, 3])
def test_eps_controllers_match(update_type, pool):
    """update_eps_fac on random windows (ties in eps included, so the sort
    must be stable), per chain and pooled across the chain axis."""
    rng = np.random.default_rng(update_type)
    C, n_a = 3, 20
    hc_j = JHMCConfig(eps_fac_update_type=update_type, N_a_eps_update=n_a,
                      eps_down_smooth=2, eps_fac=0.01)
    hc = HMCConfig(**fields_of(hc_j))
    N = 8 ** 3
    eps_table = rng.choice([0.1, 0.3, 0.5, 0.9, 1.4], (C, n_a)).astype(np.float32)
    acc = (rng.uniform(size=(C, n_a)) < np.array([[0.2], [0.65], [0.95]])
           ).astype(np.int32)
    eps_fac = np.array([0.5, 0.8, 1.2], np.float32)
    count = np.array([n_a, 2 * n_a, hc.s_eps_total(N)], np.int32)
    rej = np.array([0, 3, 1], np.int32)
    first = np.array([False, True, True])
    ref = jax.vmap(lambda e, c, r, f, a, t: jadapt.update_eps_fac(
        e, c, r, f, a, t, hc_j, N, pool_axis="chains" if pool else None),
        axis_name="chains")(*map(jnp.asarray, (eps_fac, count, rej, first,
                                               acc, eps_table)))
    out = adapt.update_eps_fac(*map(torch.from_numpy, (eps_fac, count, rej,
                                                       first, acc, eps_table)),
                               hc, N, pool=pool)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)
