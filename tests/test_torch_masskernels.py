"""Port parity: the NGP, CIC, TSC and SPH mass kernels, their gathers and
the dispatch of barcode_tpu_torch/forward/assign.py against the JAX
package's assign.py on the same numpy positions (16^3, box 160, 2 chains
batched), plus the properties tests/test_forward.py:26-111 states.

Tolerances (anchored on tests/test_pallas_deposit.py): 2e-6 absolute on
deposits (every deposit sums exactly in 64-bit fixed point, the JAX one in
float32), 3e-5 * max|grad| on position and weight gradients; 1e-4 * max on
the forward model's overdensity (tests/test_torch_forward.py's anchor for
LPT chains).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from barcode_tpu.grid.spec import GridSpec as JGridSpec
from barcode_tpu.forward import assign as jassign
from barcode_tpu.forward.lag2eul import (ForwardConfig as JForwardConfig,
                                         GrowthParams as JGrowthParams,
                                         lag2eul as jlag2eul)

from barcode_tpu_torch.config import RunConfig
from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.forward import assign, particles
from barcode_tpu_torch.forward.lag2eul import (ForwardConfig, GrowthParams,
                                               lag2eul)
from barcode_tpu_torch.model import likelihoods
from barcode_tpu_torch.model.likelihoods import ObsData
from barcode_tpu_torch.model.posterior import ModelConfig, make_psi_force
from barcode_tpu_torch import runner as trunner

N, L = 16, 160.0
G, JG = GridSpec.cube(N, L), JGridSpec.cube(N, L)
H = G.cell_avg
CODES = [0, 1, 2, 3, "sph_ft"]
GPD = dict(D1=1.0, D2=-3.0 / 7.0, ascale=1.0, cpecvel=52.85, hubble=100.0)


def positions(seed, chains=2, jitter=0.8, g=G):
    """Jittered lattice, wrapped; one particle per chain sits exactly on a
    cell centre (r = 0 for the SPH stencil's own cell)."""
    rng = np.random.default_rng(seed)
    d = np.asarray(g.cell).reshape(3, 1, 1, 1)
    idx = np.stack(np.meshgrid(*[np.arange(n) for n in g.shape],
                               indexing="ij")).astype(np.float64)
    pos = (idx + 0.5) * d + jitter * d * rng.standard_normal(
        (chains, 3) + g.shape)
    pos = np.mod(pos, np.asarray([g.L1, g.L2, g.L3]).reshape(3, 1, 1, 1))
    pos[:, :, 3, 4, 5] = (np.asarray([3, 4, 5]) + 0.5) * np.asarray(g.cell)
    return pos.astype(np.float32)


def weights(seed, chains=2):
    return np.random.default_rng(seed).uniform(
        0.5, 1.5, (chains,) + G.shape).astype(np.float32)


def jdeposit(pos, mk, w=None):
    """The JAX deposit chain by chain."""
    return np.stack([np.asarray(jassign.deposit(
        jnp.asarray(p), JG, mk, H, None if w is None else jnp.asarray(wc)))
        for p, wc in zip(pos, w if w is not None else [None] * len(pos))])


def tol(ref, rel=3e-5):
    return rel * np.abs(ref).max()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mk", CODES)
def test_deposit_matches_jax(mk, weighted):
    pos = positions(1)
    w = weights(2) if weighted else None
    out = assign.deposit(torch.from_numpy(pos), G, mk, H,
                         None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), jdeposit(pos, mk, w), atol=2e-6)


@pytest.mark.parametrize("mk", [1, 2, 3, "sph_ft"])
def test_position_and_weight_gradients_match_jax(mk):
    """d<deposit, cot>/dpos (and /dweights) against jax.grad, chain by
    chain; SPH with a particle exactly on a cell centre, where the JAX
    guard gives a zero slope."""
    pos, w = positions(3), weights(4)
    cot = np.random.default_rng(5).standard_normal(
        (2,) + G.shape).astype(np.float32)
    p = torch.from_numpy(pos).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    (assign.deposit(p, G, mk, H, tw) * torch.from_numpy(cot)).sum().backward()
    f = jax.jit(jax.grad(lambda p, w, c: jnp.sum(
        jassign.deposit(p, JG, mk, H, w) * c), argnums=(0, 1)))
    ref = [f(jnp.asarray(pos[c]), jnp.asarray(w[c]), jnp.asarray(cot[c]))
           for c in range(2)]
    gp = np.stack([np.asarray(r[0]) for r in ref])
    gw = np.stack([np.asarray(r[1]) for r in ref])
    assert np.isfinite(p.grad.numpy()).all()
    np.testing.assert_allclose(p.grad.numpy(), gp, atol=tol(gp))
    np.testing.assert_allclose(tw.grad.numpy(), gw, atol=tol(gw))


def test_sph_gradient_is_zero_at_a_cell_centre():
    """A lone particle on a cell centre: the slope of its own cell's tap is
    0 (r = 0), and by symmetry its whole position gradient against a
    constant cotangent is 0."""
    pos = np.zeros((3,) + G.shape, np.float32) + 5.0
    pos[:, 3, 4, 5] = (np.asarray([3, 4, 5]) + 0.5) * G.cell[0]
    p = torch.from_numpy(pos).requires_grad_(True)
    assign.sph_deposit(p, G, H).sum().backward()
    assert torch.isfinite(p.grad).all()
    np.testing.assert_allclose(p.grad[:, 3, 4, 5].numpy(), 0.0, atol=1e-9)


def test_ngp_deposit_has_no_position_gradient():
    p = torch.from_numpy(positions(6)).requires_grad_(True)
    assert not assign.ngp_deposit(p, G).requires_grad


def test_gathers_match_jax():
    pos = positions(7)
    field = np.random.default_rng(8).standard_normal(
        (2,) + G.shape).astype(np.float32)
    tp, tf = torch.from_numpy(pos), torch.from_numpy(field)
    for name in ("cic_gather", "tsc_gather", "tsc_weight_grad_gather"):
        out = getattr(assign, name)(tf, tp, G).numpy()
        ref = np.stack([np.asarray(getattr(jassign, name)(
            jnp.asarray(f), jnp.asarray(p), JG)) for f, p in zip(field, pos)])
        np.testing.assert_allclose(out, ref, atol=tol(ref, 2e-6), err_msg=name)
    # one field for both chains broadcasts
    out = assign.tsc_gather(tf[0], tp, G).numpy()
    np.testing.assert_allclose(out[1], np.asarray(jassign.tsc_gather(
        jnp.asarray(field[0]), jnp.asarray(pos[1]), JG)), atol=tol(out, 2e-6))


@pytest.mark.parametrize("h_rel", [0.5, 1.0, 2.0])
def test_sph_stencil_equals_jax(h_rel):
    for g, jg in ((G, JG), (GridSpec(9, 12, 10, 90.0, 132.0, 95.0),
                            JGridSpec(9, 12, 10, 90.0, 132.0, 95.0))):
        h = h_rel * g.cell_avg
        assert assign.sph_stencil(g, h) == jassign.sph_stencil(jg, h)
    assert len(assign.sph_stencil(G, h_rel * H)) == \
        {0.5: 27, 1.0: 81, 2.0: 461}[h_rel]


@pytest.mark.parametrize("mk", ["ngp", "cic", "tsc", "sph", "sph_ft"])
def test_mass_conservation_and_directional_response(mk):
    """tests/test_forward.py:26-111: the deposited mass is the particle
    count (SPH: N / cell volume to 2%), and moving one particle +0.3 cells
    in x raises the density in its +x neighbour and lowers it in its own
    (and, but for CIC, in its -x neighbour)."""
    pos = torch.from_numpy(positions(9, chains=1)[0])
    total = assign.deposit(pos, G, mk, H).sum().item()
    if mk == "sph":
        np.testing.assert_allclose(total, G.N / math.prod(G.cell), rtol=0.02)
    else:
        np.testing.assert_allclose(total, G.N, rtol=1e-4)
    if mk == "ngp":
        return
    q = particles.lagrangian_positions(G)
    q1 = q.clone()
    q1[0, 0, 0, 0] += 0.3 * G.cell[0]
    diff = (assign.deposit(q1, G, mk, H) - assign.deposit(q, G, mk, H)).numpy()
    assert diff[1, 0, 0] > 0 and diff[0, 0, 0] < 0
    if mk != "cic":
        assert diff[-1, 0, 0] < 0


@pytest.mark.parametrize("mk", CODES)
def test_lag2eul_matches_jax(mk):
    """The forward model with each mass kernel (ALPT, plane-parallel RSD)
    on a GRF-like field, against the JAX package."""
    delta = (0.8 * np.random.default_rng(10).standard_normal(G.shape)
             ).astype(np.float32)
    kw = dict(sfmodel=3, masskernel=mk, rsd=True, slength=20.0)
    out = lag2eul(torch.from_numpy(delta), G, ForwardConfig(**kw),
                  GrowthParams(**GPD))
    ref = np.asarray(jlag2eul(jnp.asarray(delta), JG, JForwardConfig(**kw),
                              JGrowthParams(**GPD)))
    np.testing.assert_allclose(out.numpy(), ref, atol=tol(ref, 1e-4))


@pytest.mark.parametrize("n,h_rel", [(16, 1.0), (4, 2.0)])
def test_sph_fixed_point_bound_holds_where_the_norm_exceeds_one(n, h_rel):
    """Every particle piled onto one point of a fine grid (cell 0.25, the
    norm 1/(pi h^3) = 20.4 at h_rel 1; at 4^3 with h_rel 2 the stencil is
    wider than the grid and reaches a cell several times), weight 7.5: the
    bound covers the largest cell sum, and the fixed-point sum is N times
    one particle's deposit (float64, to float32 rounding)."""
    g = GridSpec.cube(n, 0.25 * n)
    h = h_rel * g.cell_avg
    assert 1.0 / (math.pi * h**3) > 1.0
    pos = torch.full((3,) + g.shape, 0.3 * g.cell_avg)
    rho = assign.sph_deposit(pos, g, h, torch.full(g.shape, 7.5))
    one = assign.sph_deposit(pos[:, :1, :1, :1], g, h).double()
    bound = 7.5 * assign.sph_max_sum_per_weight(g, h, g.N)
    assert 0 < rho.max().item() <= bound
    np.testing.assert_allclose(rho.numpy(), (7.5 * g.N * one).numpy(),
                               rtol=1e-6)
    if n == 4:  # a cell reached by several offsets of one particle
        assert bound >= 8 * 7.5 * g.N / (math.pi * h**3)


def test_likelihood_force_is_zero_for_ngp():
    """NGP: psi_like does not depend on the signal through autograd, so the
    mass-2/3 force is the zero field (jax.grad's zeros), and the posterior
    gradient is the prior force alone, also with grad_prior_factor 0."""
    g = GridSpec.cube(8, 80.0)
    gp = GrowthParams(**GPD)
    P = torch.full(g.rshape, 40.0)
    P[0, 0, 0] = 0.0
    rng = np.random.default_rng(11)
    obs = ObsData(nobs=torch.from_numpy(rng.uniform(0.5, 1.5, g.shape)
                                        .astype(np.float32)),
                  window=torch.ones(g.shape), noise=torch.ones(g.shape),
                  power=P)
    fc = ForwardConfig(sfmodel=1, masskernel=0)
    conf = RunConfig(grid=g, model=ModelConfig(likelihood=1, forward=fc))
    s = torch.from_numpy(rng.standard_normal(g.shape).astype(np.float32))
    force = trunner.likelihood_force(conf, gp, obs, s)
    assert force.shape == g.shape and not force.any()
    (_, (pp, _)), grad = make_psi_force(g, conf.model, gp, obs)(s[None])
    np.testing.assert_allclose(grad[0].numpy(),
                               likelihoods.prior_grad(s, g, obs).numpy(),
                               atol=1e-5 * grad.abs().max().item())
    mc0 = dataclasses.replace(conf.model, grad_prior_factor=0.0)
    (psi0, _), grad0 = make_psi_force(g, mc0, gp, obs)(s[None])
    assert torch.isfinite(psi0).all() and not grad0.any()
