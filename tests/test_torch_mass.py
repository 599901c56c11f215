"""Port parity: every HMC mass type of the JAX package (hmc/mass.py) and
`fourier.smooth`, on the same numpy inputs.

Tolerances: 1e-5 relative plus 1e-6 of the field's maximum — float32
spectra and FFT round trips in another order; the draws of `draw_momenta`
come from a torch.Generator, so they are held to their distribution (the
kinetic energy's mean, 3 standard errors), not to JAX's bits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from barcode_tpu.grid import fourier as jfourier
from barcode_tpu.grid.spec import GridSpec as JGridSpec
from barcode_tpu.hmc import mass as jmass

from barcode_tpu_torch.grid import fourier
from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.hmc import mass

N, L = 16, 25.0
G, JG = GridSpec.cube(N, L), JGridSpec.cube(N, L)
NBIN = 12


def close(out, ref):
    out = out.numpy() if hasattr(out, "numpy") else np.asarray(out)
    ref = np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=1e-5,
                               atol=1e-6 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("filtertype,scale", [(1, 3.0), (2, 1.2), (3, 1.2)])
def test_smooth_matches(filtertype, scale):
    x = np.random.default_rng(filtertype).standard_normal(G.shape) \
        .astype(np.float32)
    close(fourier.smooth(torch.from_numpy(x), G, scale, filtertype),
          jfourier.smooth(jnp.asarray(x), JG, scale, filtertype))


def inputs():
    """A P(k) of |k| (as a spectrum is: the draws need P(k) = P(-k)), a
    likelihood force, a window with holes and a noise map."""
    rng = np.random.default_rng(5)
    k2 = fourier.k_squared(G).numpy()
    P = (5.0 + 45.0 / (1.0 + 4.0 * k2)).astype(np.float32)
    P[0, 0, 0] = 0.0
    force = rng.standard_normal(G.shape).astype(np.float32)
    window = (rng.uniform(size=G.shape) > 0.2).astype(np.float32)
    noise = rng.uniform(0.5, 1.5, G.shape).astype(np.float32)
    return P, force, window, noise


@pytest.mark.parametrize("mass_type,burned_in", [
    (0, True), (1, True), (2, True), (3, True), (4, True), (5, True),
    (6, True), (60, True), (60, False)])
def test_mass_types_match(mass_type, burned_in):
    """compute_mass, apply_minv (2 chains) and kinetic against the JAX
    package; type 60 is type 0 until burn-in."""
    P, force, window, noise = inputs()
    kw = dict(nbin=NBIN, mass_factor=1.5, kernel_h=G.cell_avg,
              burned_in=burned_in)
    jm = jmass.compute_mass(JG, mass_type, jnp.asarray(P),
                            likeli_force=jnp.asarray(force),
                            window=jnp.asarray(window),
                            noise=jnp.asarray(noise), **kw)
    tm = mass.compute_mass(G, mass_type, torch.from_numpy(P),
                           likeli_force=torch.from_numpy(force),
                           window=torch.from_numpy(window),
                           noise=torch.from_numpy(noise), **kw)
    close(tm.mass_f, jm.mass_f)
    close(torch.as_tensor(tm.mass_r), jm.mass_r)
    assert mass.mass_flags(mass_type) == jmass.mass_flags(mass_type)
    p = np.random.default_rng(6).standard_normal((2,) + G.shape) \
        .astype(np.float32)
    out = mass.apply_minv(torch.from_numpy(p), G, mass_type, tm)
    kin = mass.kinetic(torch.from_numpy(p), G, mass_type, tm)
    for c in range(2):
        close(out[c], jmass.apply_minv(jnp.asarray(p[c]), JG, mass_type, jm))
        close(kin[c], jmass.kinetic(jnp.asarray(p[c]), JG, mass_type, jm))


def test_mass_types_need_their_inputs():
    P = torch.ones(G.rshape)
    with pytest.raises(ValueError):
        mass.compute_mass(G, 2, P)
    with pytest.raises(ValueError):
        mass.compute_mass(G, 6, P)
    with pytest.raises(ValueError):
        mass.compute_mass(G, 7, P)


def test_jasche_response_kernel_matches():
    close(mass.jasche_response_kernel(G, 1.3 * G.cell_avg),
          jmass.jasche_response_kernel(JG, 1.3 * G.cell_avg))


@pytest.mark.parametrize("mass_type", [0, 1, 2, 3, 4, 6, 60])
def test_draw_momenta_has_the_mass_spectrum(mass_type):
    """p ~ N(0, M), so E[1/2 p M^-1 p] is half the number of modes the mass
    covers: N - 1 for the FS types (the DC mode has zero mass), N for the
    RS types."""
    P, force, window, noise = inputs()
    tm = mass.compute_mass(G, mass_type, torch.from_numpy(P), nbin=NBIN,
                           likeli_force=torch.from_numpy(force),
                           window=torch.ones(G.shape),
                           noise=torch.from_numpy(noise),
                           kernel_h=G.cell_avg)
    gen = torch.Generator().manual_seed(mass_type)
    n = 48
    p = mass.draw_momenta(gen, G, mass_type, tm, (n,))
    assert p.shape == (n,) + G.shape
    kin = mass.kinetic(p, G, mass_type, tm).double()
    modes = G.N - 1 if mass.mass_flags(mass_type)[0] else G.N
    err = 3.0 * kin.std().item() / n**0.5
    assert abs(kin.mean().item() - modes / 2) <= err
