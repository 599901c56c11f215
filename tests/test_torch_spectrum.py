"""`fourier.measure_spectrum` sums each spherical bin in a fixed order (a
padded gather index built once per grid and bin count, then a fixed-shape
row sum), so its result has the same bits on every call — on the card too,
where the float `index_add_` it replaced adds in a new order each time.
Held here against the JAX package's spectrum (tolerance of
tests/test_torch_forward.py: 1e-5 relative, 1e-6 of the maximum), against
itself bit for bit, and through the mass types 2 and 3 that are built from
it.  The card-side check is tests/test_torch_cuda.py and chip_smoke.py's
`spectrum_determinism` phase.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from barcode_tpu.grid import fourier as jfourier
from barcode_tpu.grid.spec import GridSpec as JGridSpec

from barcode_tpu_torch.grid import fourier
from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.hmc import mass


def close(out, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5,
                               atol=1e-6 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("shape,nbin", [((16, 16, 16), 12), ((32, 32, 32), 200),
                                        ((16, 8, 12), 30)])
def test_measure_spectrum_matches_jax(shape, nbin):
    g, jg = GridSpec(*shape, 50.0, 40.0, 30.0), JGridSpec(*shape, 50.0, 40.0,
                                                          30.0)
    x = np.random.default_rng(nbin).standard_normal(shape).astype(np.float32)
    for a, b in zip(fourier.measure_spectrum(torch.from_numpy(x), g, nbin),
                    jfourier.measure_spectrum(jnp.asarray(x), jg, nbin)):
        close(a, b)


def test_bins_hold_every_mode_once():
    """The padded gather index lists each rfft mode of bins < nbin exactly
    once, in ascending order within its bin."""
    g = GridSpec.cube(16, 25.0)
    bins, mult, _ = fourier._shell_bins(g, 12)
    nmode, _, idx = fourier._bin_gather(g, 12, "cpu")
    flat = bins.reshape(-1)
    real = idx[idx < flat.numel()].long()
    assert real.numel() == int((flat < 12).sum())
    assert torch.unique(real).numel() == real.numel()
    for b in range(12):
        row = idx[b][idx[b] < flat.numel()].long()
        assert (flat[row] == b).all() and (row.diff() > 0).all()
    np.testing.assert_array_equal(
        nmode.numpy(), torch.zeros(13).index_add_(
            0, flat, mult.reshape(-1))[:12].numpy())


def test_two_calls_are_bit_identical():
    g = GridSpec.cube(32, 100.0)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(g.shape)
                         .astype(np.float32))
    a = fourier.measure_spectrum(x, g, 200)
    b = fourier.measure_spectrum(x, g, 200)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("mass_type", [2, 3])
def test_likelihood_force_masses_are_bit_identical(mass_type):
    """Mass types 2 and 3 build their preconditioner from the force's
    spectrum: two builds from the same force give the same bits."""
    g = GridSpec.cube(16, 25.0)
    rng = np.random.default_rng(mass_type)
    k2 = fourier.k_squared(g).numpy()
    P = torch.from_numpy((5.0 + 45.0 / (1.0 + 4.0 * k2)).astype(np.float32))
    P[0, 0, 0] = 0.0
    force = torch.from_numpy(rng.standard_normal(g.shape).astype(np.float32))
    m1 = mass.compute_mass(g, mass_type, P, nbin=20, likeli_force=force)
    m2 = mass.compute_mass(g, mass_type, P, nbin=20, likeli_force=force)
    assert torch.equal(m1.mass_f, m2.mass_f)
