"""The HMC sampler: one batched attempt over all chains.

Port of barcode_tpu/hmc/sampler.py:38-210.  Per attempt (HamiltonianMC loop
body, HMC.cc:431-537):
  1. adaptive eps_fac update (before the trajectory)
  2. momenta p ~ N(0, M)
  3. Neps = 1 + floor(U * N_eps_fac); eps = min(U * eps_fac, 2)
  4. leapfrog kick-drift-kick with M^-1 in Fourier space
  5. dH = [K(p') + psi(s')] - [K(p) + psi(s)]; accept with min(1, e^-dH);
     a non-finite dH rejects
  6. circular acceptance/epsilon tables + counters

The chains are a leading batch dimension; the trajectory is the JAX
package's masked fixed-length loop: all N_eps_fac steps run for every chain
and steps j >= Neps leave a chain unchanged, so step counts are honest and
the chains stay batched.  (psi, grad) of the current signal are cached in
the ChainState.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.config import HMCConfig
from barcode_tpu_torch.forward.lag2eul import GrowthParams
from barcode_tpu_torch.model.likelihoods import ObsData
from barcode_tpu_torch.model.posterior import ModelConfig, make_psi_force
from barcode_tpu_torch.hmc import adapt, mass as mass_mod
from barcode_tpu_torch.hmc.state import AttemptStats, ChainState, MassState

# 2-stage minimal-norm (Omelyan/BCSS) splitting coefficient (sampler.py:70)
LAMBDA_MN2 = 0.1931833275037836


@dataclasses.dataclass
class AttemptRandoms:
    """The random draws of one attempt, one entry per chain.  The sampler
    draws them from its generator; tests inject the JAX package's draws
    (its threefry split, sampler.py:116) to compare attempts exactly."""

    momenta: Any   # (C,) + grid: p0 ~ N(0, M)
    u_neps: Any    # (C,) uniform [0, 1): trajectory length
    u_eps: Any     # (C,) uniform [0, 1): step size
    u_acc: Any     # (C,) uniform [0, 1): Metropolis test


def draw_randoms(generator: torch.Generator, g: GridSpec, hc: HMCConfig,
                 mass: MassState, n_chains: int) -> AttemptRandoms:
    p0 = mass_mod.draw_momenta(generator, g, hc.mass_type, mass, (n_chains,))
    u = torch.rand((3, n_chains), generator=generator,
                   device=generator.device)
    return AttemptRandoms(p0, u[0], u[1], u[2])


def make_init(g: GridSpec, mc: ModelConfig, gp: GrowthParams, hc: HMCConfig):
    """init(delta0 (C,)+grid, obs) -> ChainState of C chains."""

    def init(delta0, obs: ObsData) -> ChainState:
        (psi, (pp, pl)), grad = make_psi_force(g, mc, gp, obs)(delta0)
        C, dev = delta0.shape[0], delta0.device
        n_a = hc.N_a_eps_update
        eps0 = hc.eps_fac_start(g.N)
        return ChainState(
            delta=delta0, psi=psi, psi_prior=pp, psi_like=pl, grad=grad,
            eps_fac=torch.full((C,), eps0, dtype=torch.float32, device=dev),
            acc_flags=torch.zeros((C, n_a), dtype=torch.int32, device=dev),
            # pre-filled with eps0 so the downward search never sees zeros
            eps_table=torch.full((C, n_a), eps0, dtype=torch.float32,
                                 device=dev),
            count_attempts=torch.zeros(C, dtype=torch.int32, device=dev),
            rejections=torch.zeros(C, dtype=torch.int32, device=dev),
            accepted=torch.zeros(C, dtype=torch.int32, device=dev),
            got_first_accept=torch.zeros(C, dtype=torch.bool, device=dev))

    return init


def _select(mask, a, b):
    """Per-chain where: mask (C,) broadcast over a's trailing dimensions."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def leapfrog(vag, minv, carry0, eps, Neps, n_max: int,
             integrator: str = "leapfrog"):
    """Masked fixed-length symplectic integration (Hamiltonian_EoM,
    HMC.cc:251-369; sampler.py:73-106).

    carry0 = (s, psi, psi_prior, psi_like, grad, p) with a leading chain
    dimension; eps and Neps are (C,).  All n_max steps run; steps
    j >= Neps are no-ops for that chain.  integrator: 'leapfrog' (1
    gradient/step) or 'minimal_norm_2' (2 gradients/step)."""
    s, psi, pp, pl, grad, p = carry0
    e = eps.reshape(eps.shape + (1,) * (s.dim() - 1))
    for j in range(n_max):
        active = j < Neps
        if integrator == "leapfrog":
            p_half = p - 0.5 * e * grad
            s_new = s + e * minv(p_half)
            (psi_new, (pp_new, pl_new)), grad_new = vag(s_new)
            p_new = p_half - 0.5 * e * grad_new
        elif integrator == "minimal_norm_2":
            lam = LAMBDA_MN2
            p1 = p - lam * e * grad
            s1 = s + 0.5 * e * minv(p1)
            _, g1 = vag(s1)
            p2 = p1 - (1.0 - 2.0 * lam) * e * g1
            s_new = s1 + 0.5 * e * minv(p2)
            (psi_new, (pp_new, pl_new)), grad_new = vag(s_new)
            p_new = p2 - lam * e * grad_new
        else:
            raise ValueError(f"unknown integrator {integrator!r}")
        s, psi, pp, pl, grad, p = (
            _select(active, s_new, s), _select(active, psi_new, psi),
            _select(active, pp_new, pp), _select(active, pl_new, pl),
            _select(active, grad_new, grad), _select(active, p_new, p))
    return s, psi, pp, pl, grad, p


def make_attempt(g: GridSpec, mc: ModelConfig, gp: GrowthParams, hc: HMCConfig):
    """attempt(state, obs, mass, generator=None, randoms=None) ->
    (state', AttemptStats) over all chains of `state`."""
    n_eps_max = int(hc.N_eps_fac)

    def attempt(state: ChainState, obs: ObsData, mass: MassState,
                generator: torch.Generator | None = None,
                randoms: AttemptRandoms | None = None):
        vag = make_psi_force(g, mc, gp, obs)
        C = state.delta.shape[0]

        # 1. controller (tables of completed attempts)
        eps_fac = adapt.update_eps_fac(
            state.eps_fac, state.count_attempts, state.rejections,
            state.got_first_accept, state.acc_flags, state.eps_table, hc, g.N,
            pool=hc.pool_adaptation)

        # 2-3. momenta, trajectory length, step size (HMC.cc:260-264)
        if randoms is None:
            randoms = draw_randoms(generator, g, hc, mass, C)
        p0 = randoms.momenta
        Neps = (randoms.u_neps * hc.N_eps_fac).to(torch.int32) + 1
        eps = torch.clamp(randoms.u_eps * eps_fac, max=2.0)

        H_kin_i = mass_mod.kinetic(p0, g, hc.mass_type, mass)
        H_i = H_kin_i + state.psi

        # 4. leapfrog, masked fixed-length
        carry0 = (state.delta, state.psi, state.psi_prior, state.psi_like,
                  state.grad, p0)
        minv = lambda p: mass_mod.apply_minv(p, g, hc.mass_type, mass)
        s_f, psi_f, pp_f, pl_f, grad_f, p_f = leapfrog(
            vag, minv, carry0, eps, Neps, n_eps_max, integrator=hc.integrator)

        # 5. Metropolis
        H_kin_f = mass_mod.kinetic(p_f, g, hc.mass_type, mass)
        dH = (H_kin_f + psi_f) - H_i
        if hc.div_dH_by_N:
            dH = dH / g.N
        accept = torch.isfinite(dH) & (
            (dH < 0.0) | (randoms.u_acc < torch.exp(-torch.clamp(dH, max=80.0))))

        # 6. tables + counters
        slot = (state.count_attempts % hc.N_a_eps_update).long()
        rows = torch.arange(C, device=slot.device)
        acc_flags = state.acc_flags.clone()
        acc_flags[rows, slot] = accept.to(torch.int32)
        eps_table = state.eps_table.clone()
        eps_table[rows, slot] = eps
        new_state = ChainState(
            delta=_select(accept, s_f, state.delta),
            psi=_select(accept, psi_f, state.psi),
            psi_prior=_select(accept, pp_f, state.psi_prior),
            psi_like=_select(accept, pl_f, state.psi_like),
            grad=_select(accept, grad_f, state.grad),
            eps_fac=eps_fac,
            acc_flags=acc_flags,
            eps_table=eps_table,
            count_attempts=state.count_attempts + 1,
            rejections=state.rejections + (~accept).to(torch.int32),
            accepted=state.accepted + accept.to(torch.int32),
            got_first_accept=state.got_first_accept | accept,
        )
        stats = AttemptStats(
            accepted=accept, epsilon=eps, Neps=Neps, dH=dH,
            dK=H_kin_f - H_kin_i,
            dE=(pp_f + pl_f) - (state.psi_prior + state.psi_like),
            psi_prior_i=state.psi_prior, psi_prior_f=pp_f,
            psi_likeli_i=state.psi_like, psi_likeli_f=pl_f,
            H_kin_i=H_kin_i, H_kin_f=H_kin_f, eps_fac=eps_fac,
            acc_rate_recent=acc_flags.to(torch.float32).mean(-1),
        )
        return new_state, stats

    return attempt


def make_sampler(g: GridSpec, mc: ModelConfig, gp: GrowthParams, hc: HMCConfig,
                 n_attempts_per_call: int = 1):
    """run(states, obs, mass, generator) -> (states, stats): a batch of
    attempts; stats are (n_attempts, C) numpy arrays."""
    attempt = make_attempt(g, mc, gp, hc)

    def run(states: ChainState, obs: ObsData, mass: MassState,
            generator: torch.Generator):
        records = []
        for _ in range(n_attempts_per_call):
            states, stats = attempt(states, obs, mass, generator)
            records.append(stats)
        return states, AttemptStats.stack(records)

    return run
