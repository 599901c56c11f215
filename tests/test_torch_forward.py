"""Port parity: spectral operators, GRFs, LPT and the forward model of
barcode_tpu_torch against the JAX package, on a cubic 16^3 grid and an
odd, non-cubic grid.

Tolerances: float32 FFT chains differ between pocketfft builds only in
rounding, so spectral results agree to ~1e-6 relative; each comparison
below scales its absolute tolerance by the magnitude of the reference
(`close`), 1e-5 for single transforms and 1e-4 for the multi-transform
LPT/forward chains (ALPT runs ~15 transforms and a sqrt).  Positions are in
Mpc/h, with 1e-4 absolute on O(100) coordinates.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from barcode_tpu.grid.spec import GridSpec as JGridSpec
from barcode_tpu.grid import fourier as jfourier
from barcode_tpu import cosmo as jcosmo, random_fields as jrf
from barcode_tpu.forward import lpt as jlpt
from barcode_tpu.forward.lag2eul import (ForwardConfig as JForwardConfig,
                                         GrowthParams as JGrowthParams,
                                         lag2eul as jlag2eul)

from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.grid import fourier
from barcode_tpu_torch import cosmo, random_fields
from barcode_tpu_torch.forward import lpt
from barcode_tpu_torch.forward.lag2eul import (ForwardConfig, GrowthParams,
                                               lag2eul)

GRIDS = {"cube16": (16, 16, 16, 160.0, 160.0, 160.0),
         "odd9x12x10": (9, 12, 10, 90.0, 132.0, 95.0)}
GP = dict(D1=1.0, D2=-3.0 / 7.0, ascale=1.0, cpecvel=52.85, hubble=100.0)


def grids(name):
    return JGridSpec(*GRIDS[name]), GridSpec(*GRIDS[name])


def close(out, ref, rel):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-30))


def field(seed, shape, amp=1.0):
    return (amp * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def power_grid(jg):
    """A smooth positive spectrum on the rfft grid, DC zeroed."""
    kk = np.sqrt(np.asarray(jfourier.k_squared(jg)))
    P = (3e3 * (kk / 0.05) / (1.0 + (kk / 0.05) ** 2) ** 1.5).astype(np.float32)
    P[0, 0, 0] = 0.0
    return P


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_fourier_operators_match(name):
    jg, g = grids(name)
    for a, b in zip(fourier.kvec(g), jfourier.kvec(jg)):
        close(a, b, 1e-6)
    close(fourier.nyquist_mask(g), jfourier.nyquist_mask(jg), 0)
    close(fourier.hermitian_mult(g), jfourier.hermitian_mult(jg), 0)
    x = field(1, jg.shape)
    X = fourier.rfft3(torch.from_numpy(x))
    close(X.real, jfourier.rfft3(jnp.asarray(x)).real, 1e-5)
    close(fourier.irfft3(X, g), x, 1e-5)
    P = power_grid(jg)
    close(fourier.convolve_inv_corr(torch.from_numpy(x), g, torch.from_numpy(P)),
          jfourier.convolve_inv_corr(jnp.asarray(x), jg, jnp.asarray(P)), 1e-5)
    q = fourier.inv_corr_quadratic_C(X, g, torch.from_numpy(P))
    qj = jfourier.inv_corr_quadratic_C(jfourier.rfft3(jnp.asarray(x)), jg,
                                       jnp.asarray(P))
    np.testing.assert_allclose(q.item(), float(qj), rtol=1e-5)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_spectrum_and_power_table_match(name):
    jg, g = grids(name)
    x = field(2, jg.shape)
    for a, b in zip(fourier.measure_spectrum(torch.from_numpy(x), g, 12),
                    jfourier.measure_spectrum(jnp.asarray(x), jg, 12)):
        close(a, b, 1e-5)
    r = np.random.default_rng(3).uniform(size=jg.rshape).astype(np.float32)
    close(fourier.rfft_grid_to_full(torch.from_numpy(r), g),
          jfourier.rfft_grid_to_full(jnp.asarray(r), jg), 0)
    c = jcosmo.preset("wmap7_max")
    k_t = np.logspace(-4, 2, 1024)
    p_t = jcosmo.linear_power(c, k_t)
    np.testing.assert_allclose(cosmo.linear_power(cosmo.preset("wmap7_max"),
                                                  k_t), p_t, rtol=1e-12)
    out = fourier.power_table_to_rfft_grid(
        torch.tensor(k_t, dtype=torch.float32),
        torch.tensor(p_t, dtype=torch.float32), g)
    ref = jfourier.power_table_to_rfft_grid(jnp.asarray(k_t, jnp.float32),
                                            jnp.asarray(p_t, jnp.float32), jg)
    close(out, ref, 1e-5)


def test_cosmology_growth_matches():
    for name in ("wmap7_max", "wmap9"):
        for z in (0.0, 0.5):
            a, b = cosmo.preset(name, z), jcosmo.preset(name, z)
            for f in ("d_growth", "d2_growth", "c_pecvel", "hubble_a"):
                assert getattr(cosmo, f)(a) == getattr(jcosmo, f)(b)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_grf_from_white_matches(name):
    jg, g = grids(name)
    white = field(4, jg.shape)
    P = power_grid(jg)
    close(random_fields.grf_from_white(torch.from_numpy(white), g,
                                       torch.from_numpy(P)),
          jrf.grf_from_white(jnp.asarray(white), jg, jnp.asarray(P)), 1e-5)
    # the port's own draws are finite and carry the target amplitude
    gen = torch.Generator().manual_seed(0)
    d = random_fields.grf(gen, g, torch.from_numpy(P), batch=(2,))
    assert d.shape == (2,) + g.shape and torch.isfinite(d).all()


@pytest.mark.parametrize("sfmodel", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(GRIDS))
def test_lpt_psi_matches(name, sfmodel):
    jg, g = grids(name)
    delta = field(5, jg.shape, amp=0.8)
    ref = jlpt.lpt_psi(jnp.asarray(delta), jg, sfmodel, 1.0, -3.0 / 7.0, 10.0)
    out = lpt.lpt_psi(torch.from_numpy(delta), g, sfmodel, 1.0, -3.0 / 7.0, 10.0)
    assert out.shape == (3,) + g.shape
    close(out, ref, 1e-4)


def test_spherical_collapse_gradient_is_finite():
    """The double-where guard: collapsed cells (arg <= 0) get a zero, not a
    NaN, gradient — in both packages."""
    _, g = grids("cube16")
    d = torch.from_numpy(field(6, g.shape, amp=3.0)).requires_grad_(True)
    lpt.spherical_collapse_div_psi(d, g, 1.0).sum().backward()
    assert torch.isfinite(d.grad).all()
    collapsed = (1.0 - (2.0 / 3.0) * d.detach()) <= 0.0
    assert collapsed.any() and (d.grad[collapsed] == 0).all()


@pytest.mark.parametrize("rsd", [False, True])
@pytest.mark.parametrize("sfmodel", [1, 2, 3])
def test_lag2eul_matches(sfmodel, rsd):
    jg, g = grids("cube16")
    delta = field(7, jg.shape, amp=0.6)
    kw = dict(sfmodel=sfmodel, masskernel="sph_ft", rsd=rsd, slength=10.0)
    ref_d, ref_p = jlag2eul(jnp.asarray(delta), jg, JForwardConfig(**kw),
                            JGrowthParams(**GP), return_pos=True)
    out_d, out_p = lag2eul(torch.from_numpy(delta), g, ForwardConfig(**kw),
                           GrowthParams(**GP), return_pos=True)
    np.testing.assert_allclose(out_p.numpy(), np.asarray(ref_p), atol=1e-4)
    close(out_d, ref_d, 1e-4)
    # a leading chain dimension rides along
    both = lag2eul(torch.from_numpy(np.stack([delta, delta])), g,
                   ForwardConfig(**kw), GrowthParams(**GP))
    close(both[1], ref_d, 1e-4)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_hermitian_part_is_the_cpu_c2r_convention(name):
    """irfft3 of a non-Hermitian half-complex array equals irfft3 of its
    Hermitian part on the CPU (pocketfft); the projection is idempotent and
    the second-order source feeds only Hermitian planes to irfft3."""
    _, g = grids(name)
    rng = np.random.default_rng(8)
    X = torch.complex(*(torch.from_numpy(rng.standard_normal(g.rshape)
                                         .astype(np.float32)) for _ in range(2)))
    H = fourier.hermitian_part(X, g)
    torch.testing.assert_close(fourier.irfft3(H, g), fourier.irfft3(X, g),
                               atol=1e-6, rtol=0)
    torch.testing.assert_close(fourier.hermitian_part(H, g), H)
    assert not torch.equal(H, X)
    kx, ky, kz = fourier.kvec(g)
    base = fourier.rfft3(torch.from_numpy(field(9, g.shape)))
    cross = torch.stack([kx * ky * base, kx * kz * base, ky * kz * base])
    assert not torch.allclose(fourier.hermitian_part(cross, g), cross)
