"""Port parity: the forward options beyond the headline path — radial RSD
(on the windowless deposits and on the kernel deposit's plain versions with
the tail split), the 'findif' 2LPT derivatives, the TRANSF kernels, the
transfer module, the remaining Fourier helpers and the likelihood helpers —
against the JAX package on the same numpy inputs.

Tolerances: 1e-5 * max for single transforms and elementwise maps, 1e-4 *
max for the multi-transform LPT and forward chains (tests/
test_torch_forward.py's anchors); 3e-5 * max on the kernel deposit's
gradients (tests/test_pallas_deposit.py); positions 1e-4 absolute on O(100)
coordinates.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from barcode_tpu.grid.spec import GridSpec as JGridSpec
from barcode_tpu.grid import fourier as jfourier
from barcode_tpu.forward import lpt as jlpt, particles as jparticles
from barcode_tpu.forward import transfer as jtransfer
from barcode_tpu.forward.lag2eul import (ForwardConfig as JForwardConfig,
                                         GrowthParams as JGrowthParams,
                                         lag2eul as jlag2eul)
from barcode_tpu.model import likelihoods as jlike

from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.grid import fourier
from barcode_tpu_torch.forward import assign, lpt, particles, transfer
from barcode_tpu_torch.forward import tsc_kernels as tk
from barcode_tpu_torch.forward.lag2eul import (ForwardConfig, GrowthParams,
                                               lag2eul)
from barcode_tpu_torch.model import likelihoods

N, L = 16, 160.0
G, JG = GridSpec.cube(N, L), JGridSpec.cube(N, L)
GPD = dict(D1=1.0, D2=-3.0 / 7.0, ascale=1.0, cpecvel=52.85, hubble=100.0)
GP, JGP = GrowthParams(**GPD), JGrowthParams(**GPD)
# the observer at the box's corner, given in absolute coordinates with a
# non-zero origin (obs_eff = observer - origin = 0)
RADIAL = dict(rsd=True, rsd_planepar=False, observer=(30.0, -20.0, 10.0),
              origin=(30.0, -20.0, 10.0))


def field(seed, shape=G.shape, amp=1.0):
    return (amp * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def close(out, ref, rel):
    ref = np.asarray(ref)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-30))


def test_rsd_radial_matches_jax():
    pos = np.mod(field(1, (3,) + G.shape, 50.0) + 80.0, L)
    vel = field(2, (3,) + G.shape, 300.0)
    obs = (-5.0, 3.0, 170.0)
    out = particles.rsd_radial(torch.from_numpy(pos), torch.from_numpy(vel),
                               G, obs, 0.9, 95.0)
    ref = jparticles.rsd_radial(jnp.asarray(pos), jnp.asarray(vel), JG, obs,
                                0.9, 95.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("mk", [1, 2, 3, "sph_ft"])
def test_lag2eul_radial_windowless_matches_jax(mk):
    """Radial RSD about a box corner pushes particles out of the box (no
    wrap); the windowless deposits wrap their cells, SPH measures distances
    from the unwrapped base."""
    delta = field(3, amp=2.0)
    kw = dict(sfmodel=3, masskernel=mk, slength=20.0, **RADIAL)
    out, pos = lag2eul(torch.from_numpy(delta), G, ForwardConfig(**kw), GP,
                       return_pos=True)
    ref, jpos = jlag2eul(jnp.asarray(delta), JG, JForwardConfig(**kw), JGP,
                         return_pos=True)
    assert ((pos < 0) | (pos >= L)).sum().item() > 50
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), atol=1e-4)
    close(out, ref, 1e-4)


def test_lag2eul_radial_kernel_deposit_matches_jax():
    """The kernel deposit (K1/K2 plain versions on the CPU) with the tail
    split on radially displaced positions outside the box, against the
    JAX package's Pallas kernels in interpret mode: delta_eul and
    d<cot, delta_eul>/d delta_lag."""
    delta = field(3, amp=3.0)
    cot = field(5)
    kw = dict(sfmodel=3, masskernel="sph_ft", slength=20.0,
              pallas_deposit=True, pallas_halo=2, pallas_tail_k=512, **RADIAL)
    d = torch.from_numpy(delta).requires_grad_(True)
    out, pos = lag2eul(d, G, ForwardConfig(**kw), GP, return_pos=True)
    assert ((pos < 0) | (pos >= L)).sum().item() > 50
    assert (assign._halo_excess(pos, G, 2, 2) > 0).sum().item() > 10
    (out * torch.from_numpy(cot)).sum().backward()
    jf = JForwardConfig(**kw)

    def jfwd(x):
        return jlag2eul(x, JG, jf, JGP)

    ref, vjp = jax.vjp(jfwd, jnp.asarray(delta))
    (jgrad,) = vjp(jnp.asarray(cot))
    close(out, ref, 1e-4)
    close(d.grad, jgrad, 1e-4)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_gradfindif_and_gradfft_match_jax(axis):
    g = GridSpec(9, 12, 10, 90.0, 132.0, 95.0)
    jg = JGridSpec(9, 12, 10, 90.0, 132.0, 95.0)
    x = field(6, (2,) + g.shape)
    for name in ("gradfindif", "gradfft"):
        out = getattr(fourier, name)(torch.from_numpy(x), g, axis)
        ref = np.stack([np.asarray(getattr(jfourier, name)(
            jnp.asarray(xc), jg, axis)) for xc in x])
        close(out, ref, 1e-5)


@pytest.mark.parametrize("sfmodel", [2, 3])
def test_findif_2lpt_matches_jax(sfmodel):
    delta = field(7, amp=0.5)
    t = torch.from_numpy(delta)
    close(lpt.two_lpt_div_psi(t, G, 1.0, -3.0 / 7.0, "findif"),
          jlpt.two_lpt_div_psi(jnp.asarray(delta), JG, 1.0, -3.0 / 7.0,
                               "findif"), 1e-4)
    close(lpt.lpt_psi(t, G, sfmodel, 1.0, -3.0 / 7.0, 20.0, "findif"),
          jlpt.lpt_psi(jnp.asarray(delta), JG, sfmodel, 1.0, -3.0 / 7.0,
                       20.0, "findif"), 1e-4)


def transf_kernels(jg):
    """(t_zeld, t_2lpt) on the rfft grid from tables, as the TRANSF build
    reads them: a damped linear kernel and a boosted second-order one."""
    k = np.linspace(0.0, 0.5, 128)
    t_z = np.exp(-(k / 0.2) ** 2).astype(np.float32)
    t_2 = (1.0 + 0.5 * k / (0.1 + k)).astype(np.float32)
    kk = jnp.sqrt(jfourier.k_squared(jg))
    return (k, t_z, t_2), tuple(np.asarray(jnp.interp(kk, k, t))
                                for t in (t_z, t_2))


@pytest.mark.parametrize("sfmodel", [1, 2, 3])
def test_transf_kernels_match_jax(sfmodel):
    """lpt_psi and lag2eul with TRANSF kernels (tests/test_forward.py:
    291-340 as the model): the same multipliers in both packages."""
    (k, t_z, t_2), jt = transf_kernels(JG)
    tt = tuple(transfer.transfer_on_grid(G, k, t) for t in (t_z, t_2))
    np.testing.assert_allclose(tt[0].numpy(), jt[0], atol=1e-6)
    delta = field(8, amp=0.8)
    close(lpt.lpt_psi(torch.from_numpy(delta), G, sfmodel, 1.0, -3.0 / 7.0,
                      20.0, transfer=tt),
          jlpt.lpt_psi(jnp.asarray(delta), JG, sfmodel, 1.0, -3.0 / 7.0,
                       20.0, transfer=tuple(map(jnp.asarray, jt))), 1e-4)
    kw = dict(sfmodel=sfmodel, masskernel="sph_ft", rsd=True, slength=20.0)
    close(lag2eul(torch.from_numpy(delta), G, ForwardConfig(**kw), GP,
                  transfer=tt),
          jlag2eul(jnp.asarray(delta), JG, JForwardConfig(**kw), JGP,
                   transfer=tuple(map(jnp.asarray, jt))), 1e-4)


def test_transfer_module_matches_jax():
    x = field(9, amp=0.7)
    for name in ("rankorder_leclercq_za", "rankorder_leclercq_2lpt"):
        close(getattr(transfer, name)(torch.from_numpy(x)),
              getattr(jtransfer, name)(jnp.asarray(x)), 1e-5)
    k = np.logspace(-3, 1, 200)
    p = 2e4 * k / (1 + (k / 0.02) ** 2.5)
    assert transfer.k_nonlinear(k, p) == jtransfer.k_nonlinear(k, p)
    (kt, t_z, _), _ = transf_kernels(JG)
    close(transfer.apply_transfer_table(torch.from_numpy(x), G, kt, t_z),
          jtransfer.apply_transfer_table(jnp.asarray(x), JG, kt, t_z), 1e-5)


def test_fourier_helpers_match_jax():
    x = field(10)
    t, j = torch.from_numpy(x), jnp.asarray(x)
    X, JX = fourier.rfft3(t), jfourier.rfft3(j)
    for a in range(3):
        close(torch.view_as_real(fourier.grad_inv_lap_C(X, G, a)),
              np.stack([np.asarray(jfourier.grad_inv_lap_C(JX, JG, a)).real,
                        np.asarray(jfourier.grad_inv_lap_C(JX, JG, a)).imag],
                       -1), 1e-5)
    close(fourier.poisson_solve(t, G), jfourier.poisson_solve(j, JG), 1e-5)
    close(fourier.displacement_from_phi(t, G),
          jfourier.displacement_from_phi(j, JG), 1e-5)
    corr = np.array(jnp.exp(-jfourier.k_squared(JG) / 10.0) + 0.1)
    close(fourier.apply_corr(t, G, torch.from_numpy(corr)),
          jfourier.apply_corr(j, JG, jnp.asarray(corr)), 1e-5)
    # the round trip of tests/test_fourier.py:65-69
    back = fourier.apply_corr(fourier.convolve_inv_corr(
        t, G, torch.from_numpy(corr)), G, torch.from_numpy(corr))
    np.testing.assert_allclose(back.numpy(), x, atol=1e-4)
    for ft in (1, 2, 3):
        close(fourier.smooth_zeropad(t, G, 0.1, ft),
              jfourier.smooth_zeropad(j, JG, 0.1, ft), 1e-5)
    g2 = GridSpec(9, 12, 10, 90.0, 132.0, 95.0)
    x2 = field(11, g2.shape)
    close(fourier.fft_upsample(torch.from_numpy(x2), g2, 2),
          jfourier.fft_upsample(jnp.asarray(x2), JGridSpec(*dataclasses.astuple(
              g2)), 2), 1e-5)


def test_likelihood_helpers_match_jax():
    rng = np.random.default_rng(12)
    P = np.abs(rng.standard_normal(G.rshape)).astype(np.float32) + 1.0
    P[0, 0, 0] = 0.0
    s = field(13, amp=0.3)
    dx = field(14, amp=0.3)
    arrs = dict(nobs=rng.uniform(0.1, 2.0, G.shape).astype(np.float32),
                window=(rng.uniform(size=G.shape) > 0.1).astype(np.float32),
                noise=rng.uniform(0.5, 1.5, G.shape).astype(np.float32))
    kw = dict(rho_c=1.3, biasP=1.1, biasE=1.2, delta_min=-0.5)
    obs = likelihoods.ObsData(power=torch.from_numpy(P), **kw,
                              **{k: torch.from_numpy(v) for k, v in arrs.items()})
    jobs = jlike.ObsData(power=jnp.asarray(P), **kw,
                         **{k: jnp.asarray(v) for k, v in arrs.items()})
    np.testing.assert_allclose(
        likelihoods.prior_psi(torch.from_numpy(s), G, obs).item(),
        float(jlike.prior_psi(jnp.asarray(s), JG, jobs)), rtol=1e-5)
    close(likelihoods.prior_grad(torch.from_numpy(s), G, obs),
          jlike.prior_grad(jnp.asarray(s), JG, jobs), 1e-5)
    for lk in (0, 1, 2):
        out = likelihoods.partial_f_delta_x(lk, torch.from_numpy(dx), obs)
        close(out, jlike.partial_f_delta_x(lk, jnp.asarray(dx), jobs), 1e-5)
        # and it is the autograd derivative of the port's own psi
        d = torch.from_numpy(dx).requires_grad_(True)
        (auto,) = torch.autograd.grad(likelihoods.likelihood_psi(lk, d, obs), d)
        close(out, auto, 1e-5)


def test_radial_rsd_halo_contract_sees_the_rsd_shift():
    """Radial RSD moves x and y, so the quantile halo is measured on the
    RSD positions (tsc_kernels.contract_config): its violators keep the
    tail's 4x headroom, where the RSD-free halo of the JAX package
    (pallas_deposit.py:599) does not.  Plane-parallel RSD (z only) is still
    dropped, as there."""
    delta = torch.from_numpy(field(3, amp=3.0))
    fc = ForwardConfig(sfmodel=3, masskernel="sph_ft", slength=20.0,
                       pallas_deposit=True, pallas_tail_k=64, **RADIAL)
    pos = lag2eul(delta, G, fc, GP, return_pos=True)[1]

    def violators(halo):
        return int((assign._halo_excess(pos, G, halo, halo) > 0).sum())

    halo = tk.displacement_halo_quantile(delta, G, fc, GP, 64)
    rsd_free = tk.displacement_halo_quantile(
        delta, G, dataclasses.replace(fc, rsd=False), GP, 64)
    assert violators(halo) <= 64 // 4 < violators(rsd_free)
    assert tk.contract_config(fc) == fc
    planepar = dataclasses.replace(fc, rsd_planepar=True)
    assert tk.contract_config(planepar) == dataclasses.replace(planepar,
                                                               rsd=False)
