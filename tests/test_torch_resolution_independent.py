"""The port's resolution-independent GRF (random_fields.py:53-116 of the
JAX package): the N / 2N property, the spectrum and the real consistency
as tests/test_random_fields.py:53-90 state them, its counter-based hash
against JAX's Threefry-2x32, repeatability, and the mock's default.

The port hashes each signed wavevector with Threefry-2x32 keyed by a seed
drawn from the caller's generator; the JAX package folds the wavevector
into a JAX key.  So the two agree in distribution and in the property, not
in value.  Tolerances: modes at N and 2N within rtol 1e-4 (the JAX test's;
two FFT sizes round differently), the spectrum within 15% (the JAX test's,
for one 16^3 draw), the re-transformed modes within rtol 1e-3, atol 1e-2.
"""
import numpy as np
import pytest
import torch
from jax.extend.random import threefry_2x32

from barcode_tpu_torch.config import MockConfig
from barcode_tpu_torch.forward.lag2eul import ForwardConfig, GrowthParams
from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.grid import fourier
from barcode_tpu_torch import mock as mock_mod, random_fields as rf

G = GridSpec.cube(16, 200.0)
G32 = GridSpec.cube(32, 200.0)


def flat_power(g, p0=50.0):
    P = torch.full(g.rshape, p0)
    P[0, 0, 0] = 0.0
    return P


def draw(g, seed):
    return rf.grf_resolution_independent(torch.Generator().manual_seed(seed),
                                         g, flat_power(g))


def test_threefry_matches_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    key = rng.integers(0, 2**32, 2, dtype=np.uint64)
    ctr = rng.integers(0, 2**32, (2, 4096), dtype=np.uint64)
    ref = np.asarray(threefry_2x32(key.astype(np.uint32),
                                   ctr.astype(np.uint32).reshape(-1)))
    x0, x1 = rf.threefry2x32((int(key[0]), int(key[1])),
                             torch.from_numpy(ctr[0].astype(np.int64)),
                             torch.from_numpy(ctr[1].astype(np.int64)))
    np.testing.assert_array_equal(np.concatenate([x0.numpy(), x1.numpy()]),
                                  ref.astype(np.int64))


def test_large_scale_modes_agree_at_n_and_2n():
    """One generator seed at 16^3 and 32^3: every signed wavevector inside
    both grids, away from the coarse grid's Nyquist planes, has the same
    mode (rfft divided by N)."""
    F16 = fourier.rfft3(draw(G, 7)).numpy() / G.N
    F32 = fourier.rfft3(draw(G32, 7)).numpy() / G32.N
    n = 0
    for fx in range(-7, 8):
        for fy in range(-7, 8):
            for fz in range(0, 8):
                np.testing.assert_allclose(
                    F16[fx % 16, fy % 16, fz], F32[fx % 32, fy % 32, fz],
                    rtol=1e-4, atol=1e-8, err_msg=str((fx, fy, fz)))
                n += 1
    assert n == 15 * 15 * 8
    # another seed draws other modes
    other = fourier.rfft3(draw(G, 8)).numpy() / G.N
    assert np.abs(other[1, 2, 3] - F16[1, 2, 3]) > 1e-3 * np.abs(F16[1, 2, 3])


def test_spectrum_and_real_consistency():
    d = draw(G, 3)
    km, pw, nm = fourier.measure_spectrum(d, G, 16)
    np.testing.assert_allclose(float((pw * nm).sum() / nm.sum()), 50.0,
                               rtol=0.15)
    seed = rf.draw_seed(torch.Generator().manual_seed(3))
    A = rf._unit_hermitian_modes(seed, G)
    sigma = np.sqrt(flat_power(G).numpy() * (G.N * (G.N / G.vol)) / 2.0)
    np.testing.assert_allclose(fourier.rfft3(d).numpy(), A.numpy() * sigma,
                               rtol=1e-3, atol=1e-2)
    # unit modes: E|A|^2 = 2, the self-conjugate ones real
    a2 = (A.abs() ** 2).numpy()
    np.testing.assert_allclose(a2.mean(), 2.0, rtol=0.05)
    for i in (0, 8):
        for j in (0, 8):
            for k in (0, 8):
                assert A[i, j, k].imag == 0.0


def test_repeated_calls_have_the_same_bits():
    assert torch.equal(draw(G, 11), draw(G, 11))
    gen = torch.Generator().manual_seed(11)
    a = rf.grf_resolution_independent(gen, G, flat_power(G))
    b = rf.grf_resolution_independent(gen, G, flat_power(G))
    assert not torch.equal(a, b)  # the generator moved on


@pytest.mark.parametrize("resolution_independent", [True, False])
def test_mock_truth_is_resolution_independent_by_default(
        resolution_independent):
    g = GridSpec.cube(16, 25.0)
    P = flat_power(g, 40.0)
    gp = GrowthParams(D1=1.0, D2=-3.0 / 7.0, ascale=1.0, cpecvel=52.85,
                      hubble=100.0)
    kw = {} if resolution_independent else dict(resolution_independent=False)
    md = mock_mod.generate(torch.Generator().manual_seed(1), g,
                           MockConfig(sigma_min=0.5),
                           ForwardConfig(sfmodel=1, masskernel=2), gp, P, 1,
                           **kw)
    draw_fn = rf.grf_resolution_independent if resolution_independent \
        else rf.grf
    assert torch.equal(md.truth_lag,
                       draw_fn(torch.Generator().manual_seed(1), g, P))
