"""Full HMC attempts for chains over a (chains, grid) process layout.

Port of barcode_tpu/parallel/sharded_sampler.py:1-258, the config-5
sampling mode: every field of every chain is x-slab-sharded over the ranks
of a 'grid' group while independent chains run on the rows of the layout
(and in a local batch on each rank).  One attempt: the adaptive-eps
controller -> momenta p ~ N(0, M) drawn slab-locally and coloured through
the sharded FFT -> masked fixed-length integration (`hmc.sampler.leapfrog`
with hc.integrator) of the slab-local posterior force -> Metropolis
accept, with the 12-column AttemptStats of the dense sampler.  With
hc.pool_adaptation the controller tables are gathered over the `chains`
group and the local batch.

Scope: Fourier-space masses (`mass_f` in the sharded Fourier layout); the
ShardedRunner gates on this.

RNG: every chain carries a seed, and an attempt draws through
`hmc.randoms`, as the dense sampler does: its scalars (trajectory length,
step size, Metropolis uniform) from the (seed, attempt count) stream 0, the
same on every grid rank of the chain, and the slab's momentum noise from
grid rank d's stream 1 + d.  So the full-grid draw is well defined, a
checkpoint needs no generator state, and at one grid rank a chain draws
what the dense sampler draws for it.  The JAX package folds the device
index into a threefry key instead: the two packages agree in distribution,
not in value.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.config import HMCConfig
from barcode_tpu_torch.forward.lag2eul import GrowthParams
from barcode_tpu_torch.hmc import adapt, randoms as rnd
from barcode_tpu_torch.hmc.sampler import AttemptRandoms, _select, leapfrog
from barcode_tpu_torch.hmc.state import AttemptStats
from barcode_tpu_torch.model.likelihoods import ObsData
from barcode_tpu_torch.model.posterior import ModelConfig
from barcode_tpu_torch.parallel import sharded_fft as sf
from barcode_tpu_torch.parallel.sharded_forward import (_check_halo,
                                                        _make_psi_local,
                                                        _value_and_grad)


def init_chain_state(delta_batch, psi_vals, psi_aux, grad_batch, seeds,
                     eps0, hc: HMCConfig) -> dict:
    """State dict of this rank's chains (sharded_sampler.py:50-77): fields
    with a leading local-chain dimension, delta/grad the rank's slabs,
    `seed` the chains' seeds (int64) where the JAX package keeps keys."""
    nc = delta_batch.shape[0]
    dev = delta_batch.device
    n_a = hc.N_a_eps_update
    eps0 = torch.as_tensor(eps0, dtype=torch.float32, device=dev)
    return {
        "delta": delta_batch,
        "psi": psi_vals,
        "psi_prior": psi_aux[0],
        "psi_like": psi_aux[1],
        "grad": grad_batch,
        "seed": torch.as_tensor(seeds, dtype=torch.int64, device=dev),
        "eps_fac": eps0,
        "accepted": torch.zeros(nc, dtype=torch.int32, device=dev),
        "acc_flags": torch.zeros((nc, n_a), dtype=torch.int32, device=dev),
        "eps_table": eps0[:, None].expand(nc, n_a).contiguous(),
        "count_attempts": torch.zeros(nc, dtype=torch.int32, device=dev),
        "rejections": torch.zeros(nc, dtype=torch.int32, device=dev),
        "got_first_accept": torch.zeros(nc, dtype=torch.bool, device=dev),
    }


GRID_FIELDS = ("delta", "grad")


def shard_chain_state(state: dict, layout) -> dict:
    """This rank's part of a full state dict (every chain, full grids; numpy
    arrays or tensors): its chains, and its x-slab of delta and grad."""
    lo, hi = layout.chain_ids.start, layout.chain_ids.stop
    out = {}
    for k, v in state.items():
        t = torch.as_tensor(v).to(layout.device)[lo:hi]
        if k in GRID_FIELDS:
            t = sf.shard_real(t, layout)
        out[k] = t.contiguous()
    return out


def _gather_chains(layout):
    """(C_loc, ...) -> (every chain, ...) over the chains group, rows in
    order (the JAX package's all_gather over ('chains', local batch))."""
    def gather(x):
        parts = [torch.empty_like(x) for _ in range(layout.rows)]
        dist.all_gather(parts, x.contiguous(), group=layout.chains_group)
        return torch.cat(parts)

    return gather


def make_sharded_attempt(g: GridSpec, mc: ModelConfig, gp: GrowthParams,
                         hc: HMCConfig, layout, halo: int | None = None):
    """attempt(state, obs, mass_f, randoms=None) -> (state', AttemptStats of
    (C_loc,) tensors), one attempt of this rank's chains
    (sharded_sampler.py:85-230), integrated with hc.integrator.  obs from
    sharded_forward.shard_obs_chains; mass_f the half-complex mass
    spectrum in the sharded Fourier layout; `randoms` (the dense sampler's
    AttemptRandoms with this rank's slab of the momenta) replaces the
    chains' own draws.  Every rank calls it together."""
    halo = _check_halo(g, mc, layout.n_grid, halo)
    psi_local = _make_psi_local(g, mc, gp, halo, layout)
    n_eps_max = int(hc.N_eps_fac)
    group, col = layout.grid_group, layout.col
    gather = _gather_chains(layout) if hc.pool_adaptation else None
    n1_loc = g.N1 // layout.n_grid
    rfft = lambda x: sf._rfft3_local(x, group)
    irfft = lambda F: sf._irfft3_local(F, g.N3, group)

    def attempt(state: dict, obs: ObsData, mass_f,
                randoms: AttemptRandoms | None = None):
        dev = state["delta"].device
        C = state["delta"].shape[0]
        # momenta p ~ N(0, M): slab-local white noise coloured by
        # sqrt(mass_f * N / V) through the sharded FFT
        if randoms is None:
            keys = rnd.chain_keys(state["seed"], state["count_attempts"])
            u = rnd.uniforms(keys, dev)
            w = rnd.white(keys, rnd.momentum_stream(col),
                          (n1_loc, g.N2, g.N3), dev)
            p0 = irfft(torch.sqrt(mass_f * (g.N / g.vol)) * rfft(w))
        else:
            u = torch.stack([randoms.u_neps, randoms.u_eps, randoms.u_acc],
                            dim=-1)
            p0 = randoms.momenta

        # 1. adaptive-eps controller on the completed-attempt tables
        eps_fac = adapt.update_eps_fac(
            state["eps_fac"], state["count_attempts"], state["rejections"],
            state["got_first_accept"], state["acc_flags"], state["eps_table"],
            hc, g.N, pool=hc.pool_adaptation, gather=gather)

        # 2. the kinetic energy's M^-1 in the sharded Fourier layout
        inv_m = torch.where(mass_f > 0.0, (g.vol / g.N)
                            / torch.where(mass_f > 0.0, mass_f, 1.0), 0.0)

        def minv(p):
            return irfft(inv_m * rfft(p))

        def kinetic(p):
            k = 0.5 * torch.sum(p * minv(p), dim=(-3, -2, -1))
            dist.all_reduce(k, group=group)
            return k

        # 3. trajectory length and step size (HMC.cc:260-264)
        Neps = (u[:, 0] * hc.N_eps_fac).to(torch.int32) + 1
        eps = torch.clamp(u[:, 1] * eps_fac, max=2.0)
        H_kin_i = kinetic(p0)
        H_i = H_kin_i + state["psi"]

        # 4. masked fixed-length leapfrog
        vag = _value_and_grad(psi_local, mc, gp, obs, group)
        carry0 = (state["delta"], state["psi"], state["psi_prior"],
                  state["psi_like"], state["grad"], p0)
        s_f, psi_f, pp_f, pl_f, grad_f, p_f = leapfrog(
            vag, minv, carry0, eps, Neps, n_eps_max,
            integrator=hc.integrator)

        # 5. Metropolis (NaN-safe; div_dH_by_N as the dense sampler)
        H_kin_f = kinetic(p_f)
        dH = H_kin_f + psi_f - H_i
        if hc.div_dH_by_N:
            dH = dH / g.N
        accept = torch.isfinite(dH) & (
            (dH < 0.0) | (u[:, 2] < torch.exp(-torch.clamp(dH, max=80.0))))

        # 6. circular tables + counters (HMC.cc:506-531)
        slot = (state["count_attempts"] % hc.N_a_eps_update).long()
        rows = torch.arange(C, device=dev)
        acc_flags = state["acc_flags"].clone()
        acc_flags[rows, slot] = accept.to(torch.int32)
        eps_table = state["eps_table"].clone()
        eps_table[rows, slot] = eps
        pp0, pl0 = state["psi_prior"], state["psi_like"]
        stats = AttemptStats(
            accepted=accept, epsilon=eps, Neps=Neps, dH=dH,
            dK=H_kin_f - H_kin_i, dE=(pp_f + pl_f) - (pp0 + pl0),
            psi_prior_i=pp0, psi_prior_f=pp_f,
            psi_likeli_i=pl0, psi_likeli_f=pl_f,
            H_kin_i=H_kin_i, H_kin_f=H_kin_f, eps_fac=eps_fac,
            acc_rate_recent=acc_flags.to(torch.float32).mean(-1))
        new_state = {
            "delta": _select(accept, s_f, state["delta"]),
            "psi": _select(accept, psi_f, state["psi"]),
            "psi_prior": _select(accept, pp_f, pp0),
            "psi_like": _select(accept, pl_f, pl0),
            "grad": _select(accept, grad_f, state["grad"]),
            "seed": state["seed"],
            "eps_fac": eps_fac,
            "accepted": state["accepted"] + accept.to(torch.int32),
            "acc_flags": acc_flags,
            "eps_table": eps_table,
            "count_attempts": state["count_attempts"] + 1,
            "rejections": state["rejections"] + (~accept).to(torch.int32),
            "got_first_accept": state["got_first_accept"] | accept,
        }
        return new_state, stats

    return attempt


def make_sharded_sampler(g: GridSpec, mc: ModelConfig, gp: GrowthParams,
                         hc: HMCConfig, layout, halo: int | None = None,
                         n_attempts_per_call: int = 1):
    """run(state, obs, mass_f) -> (state', AttemptStats of (n_attempts,
    C_loc) numpy arrays): n_attempts_per_call attempts per call, as the
    JAX package's scan (sharded_sampler.py:233-258)."""
    attempt = make_sharded_attempt(g, mc, gp, hc, layout, halo=halo)

    def run(state: dict, obs: ObsData, mass_f):
        records = []
        with torch.no_grad():
            for _ in range(n_attempts_per_call):
                state, stats = attempt(state, obs, mass_f)
                records.append(stats)
        return state, AttemptStats.stack(records)

    return run
