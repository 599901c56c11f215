"""Port parity: batched HMC attempts of barcode_tpu_torch driven by the JAX
package's own random draws (its threefry split, sampler.py:116), on the
headline model (ALPT + RSD, sph_ft, Gaussian likelihood, kernel deposit with
the halo-tail split) at 8^3.

Tolerances: dH 1e-5 * |H| absolute (H is a sum of N-sized energies, dH a
difference of two); eps, Neps and eps_fac 1e-6 relative; trajectories
1e-4 * max|delta| (eight float32 gradient evaluations through ALPT); accept
decisions and counters exactly.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from barcode_tpu.config import HMCConfig as JHMCConfig
from barcode_tpu.model import posterior as jposterior
from barcode_tpu.hmc import mass as jmass, sampler as jsampler

from barcode_tpu_torch import convert
from barcode_tpu_torch.config import HMCConfig
from barcode_tpu_torch.forward.lag2eul import GrowthParams
from barcode_tpu_torch.hmc import sampler

from test_torch_hmc import GPD, fields_of, headline_problem, port_problem


@functools.lru_cache(maxsize=1)
def problem():
    """The 8^3 model and both packages' initial states of two chains (the
    init does not depend on the controller type: eps_fac is explicit)."""
    jg, gp, fc, obs, truth = headline_problem(8, 8.0, tail_k=64, halo=2, key=3)
    jhc = JHMCConfig(eps_fac=0.2, mass_type=1, N_eps_fac=4, N_a_eps_update=2)
    jmc = jposterior.ModelConfig(likelihood=1, forward=fc)
    d0 = jnp.stack([0.3 * truth, -0.2 * truth])
    init_j = jsampler.make_init(jg, jmc, gp, jhc)
    states_j = jax.jit(jax.vmap(lambda k, d: init_j(k, d, obs)))(
        jax.random.split(jax.random.key(7), 2), d0)
    g, mc, tobs = port_problem(jg, fc, obs)
    states = sampler.make_init(g, mc, GrowthParams(**GPD),
                               HMCConfig(**fields_of(jhc)))(
        torch.from_numpy(np.array(d0)), tobs, [1, 2])
    return jg, gp, jmc, obs, states_j, g, mc, tobs, states


def jax_randoms(states, jg, hc, mass):
    """The draws make_attempt takes from each chain's key (sampler.py:116)."""
    def one(key):
        _, k_mom, k_neps, k_eps, k_acc = jax.random.split(key, 5)
        p0 = jmass.draw_momenta(k_mom, jg, hc.mass_type, mass)
        return (p0, jax.random.uniform(k_neps), jax.random.uniform(k_eps),
                jax.random.uniform(k_acc))
    p0, un, ue, ua = jax.jit(jax.vmap(one))(states.key)
    t = lambda a: torch.from_numpy(np.array(a))
    return sampler.AttemptRandoms(t(p0), t(un), t(ue), t(ua))


@pytest.mark.parametrize("update_type", [0, 3])
def test_attempts_with_injected_jax_randoms_match(update_type):
    """Three batched attempts of two chains: the port, fed the JAX package's
    draws, takes the same accept decisions with the same dH, step sizes and
    controller state."""
    jg, gp, jmc, obs, states_j, g, mc, tobs, states = problem()
    jhc = JHMCConfig(eps_fac=0.2, eps_fac_update_type=update_type,
                     mass_type=1, N_eps_fac=4, N_a_eps_update=2)
    hc = HMCConfig(**fields_of(jhc))
    mass_j = jmass.compute_mass(jg, 1, obs.power)
    attempt_j = jax.jit(jax.vmap(jsampler.make_attempt(jg, jmc, gp, jhc),
                                 in_axes=(0, None, None), axis_name="chains"))
    mass = convert.mass_state(fields_of(mass_j), device="cpu")
    np.testing.assert_allclose(states.psi.numpy(), np.asarray(states_j.psi),
                               rtol=1e-5)
    attempt = sampler.make_attempt(g, mc, GrowthParams(**GPD), hc)
    n_acc = 0
    for _ in range(3):
        randoms = jax_randoms(states_j, jg, jhc, mass_j)
        states_j, stats_j = attempt_j(states_j, obs, mass_j)
        states, stats = attempt(states, tobs, mass, randoms=randoms)
        H = np.abs(np.asarray(stats_j.H_kin_i)) + np.abs(np.asarray(stats_j.psi_prior_i)
                                                         + np.asarray(stats_j.psi_likeli_i))
        np.testing.assert_array_equal(stats.accepted.numpy(),
                                      np.asarray(stats_j.accepted))
        np.testing.assert_allclose(stats.dH.numpy(), np.asarray(stats_j.dH),
                                   atol=1e-5 * H.max())
        for name in ("epsilon", "Neps", "eps_fac"):
            np.testing.assert_allclose(getattr(stats, name).numpy(),
                                       np.asarray(getattr(stats_j, name)),
                                       rtol=1e-6)
        dj = np.asarray(states_j.delta)
        np.testing.assert_allclose(states.delta.numpy(), dj,
                                   atol=1e-4 * np.abs(dj).max())
        for name in ("acc_flags", "count_attempts", "rejections", "accepted",
                     "got_first_accept"):
            np.testing.assert_array_equal(getattr(states, name).numpy(),
                                          np.asarray(getattr(states_j, name)))
        n_acc += int(stats.accepted.sum())
    if update_type == 0:
        assert n_acc > 0  # the accept branch was exercised
