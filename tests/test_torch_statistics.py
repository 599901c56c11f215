"""Port parity: barcode_tpu_torch.statistics against barcode_tpu.statistics
on the same numpy fields (16^3 and 32^3 cubes and a non-cubic grid, several
bin counts, 200 among them, the tools' default).

Tolerances are those of tests/test_torch_spectrum.py: nmode equal exactly
(the bin grids are the JAX package's float32 arithmetic, so every cell
falls into the same bin); the binned means within rtol 1e-5 and atol
1e-6 * max(1, max|ref|), float32 sums in another order.  Every bin is
summed in a fixed order (`BinPlan`), so two calls give the same bits; the
card-side check is tests/test_torch_cuda.py and chip_smoke.py's `analysis`
phase.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from barcode_tpu import statistics as jstat
from barcode_tpu.grid.spec import GridSpec as JGridSpec

from barcode_tpu_torch import statistics
from barcode_tpu_torch.grid.spec import GridSpec

GRIDS = {"16": ((16, 16, 16), (50.0, 50.0, 50.0)),
         "32": ((32, 32, 32), (100.0, 100.0, 100.0)),
         "16x8x12": ((16, 8, 12), (50.0, 40.0, 30.0))}
CASES = [("16", 12), ("16", 200), ("32", 50), ("32", 200), ("16x8x12", 30),
         ("16x8x12", 200)]
FUNCTIONS = ("measure_correlation", "measure_spectrum_2d",
             "measure_correlation_2d")


def grids(name):
    shape, L = GRIDS[name]
    return GridSpec(*shape, *L), JGridSpec(*shape, *L)


def field(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def close(out, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5,
                               atol=1e-6 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("fn", FUNCTIONS)
@pytest.mark.parametrize("grid,nbin", CASES)
def test_statistics_match_jax(fn, grid, nbin):
    g, jg = grids(grid)
    x = field(g.shape, nbin)
    out = getattr(statistics, fn)(torch.from_numpy(x), g, nbin)
    ref = getattr(jstat, fn)(jnp.asarray(x), jg, nbin)
    assert len(out) == len(ref) == 3
    for a, b in zip(out, ref):
        assert tuple(a.shape) == tuple(np.asarray(b).shape)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    close(out[0], ref[0])
    close(out[1], ref[1])


def test_correlation_3d_matches_jax():
    g, jg = grids("16x8x12")
    x = field(g.shape, 3)
    close(statistics.correlation_3d(torch.from_numpy(x), g),
          jstat.correlation_3d(jnp.asarray(x), jg))


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_two_calls_are_bit_identical(fn):
    g, _ = grids("32")
    x = torch.from_numpy(field(g.shape, 5))
    a = getattr(statistics, fn)(x, g, 200)
    b = getattr(statistics, fn)(x.clone(), g, 200)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("kind", sorted(statistics._BINS))
def test_plan_lists_each_cell_once_in_order(kind):
    """The plan's first level lists each cell of the bins < nbins exactly
    once, in ascending order within its bin; its counts are the bins'."""
    g, _ = grids("16x8x12")
    bins, nbins = statistics._BINS[kind](g, 30)
    flat = bins.reshape(-1)
    plan = statistics._plan_from_bins(bins, nbins)
    idx = plan.levels[0].long()
    real = idx[idx < flat.numel()]
    assert real.numel() == int((flat < nbins).sum())
    assert torch.unique(real).numel() == real.numel()
    np.testing.assert_array_equal(
        plan.counts.numpy(), torch.bincount(flat, minlength=nbins + 1)
        [:nbins].numpy())
    # rows are consecutive chunks of consecutive bins: sorted bins, and
    # ascending cells within each bin
    b = flat[real]
    assert (b.diff() >= 0).all()
    same = b[1:] == b[:-1]
    assert (real.diff()[same] > 0).all()
    assert plan.nbytes > 0 and plan.levels[-1].shape[0] <= nbins


def test_plan_sums_match_a_float64_bincount():
    """The tree of partial sums adds every cell of a bin once: against a
    float64 bincount, with bins wider than several CHUNKs."""
    g = GridSpec.cube(32, 100.0)
    bins, nbins = statistics._corr_bins(g, 8)
    plan = statistics._plan_from_bins(bins, nbins)
    assert len(plan.levels) >= 3
    v = torch.from_numpy(field(g.shape, 9))
    ref = torch.bincount(bins.reshape(-1), weights=v.reshape(-1).double(),
                         minlength=nbins + 1)[:nbins]
    np.testing.assert_allclose(plan.sums(v).double().numpy(), ref.numpy(),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("converged", [True, False])
def test_gelman_rubin_matches_jax(converged):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, 200, 3, 2)).astype(np.float32)
    if not converged:  # each chain around its own mean
        x += 3.0 * np.arange(4, dtype=np.float32).reshape(4, 1, 1, 1)
    out = statistics.gelman_rubin(torch.from_numpy(x))
    ref = np.asarray(jstat.gelman_rubin(jnp.asarray(x)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5)
    if converged:
        assert (out < 1.05).all()
    else:
        assert (out > 2.0).all()
    # numpy input, odd sample count (the last sample is dropped)
    np.testing.assert_allclose(
        statistics.gelman_rubin(x[:, :151]).numpy(),
        np.asarray(jstat.gelman_rubin(jnp.asarray(x[:, :151]))), rtol=1e-5)
