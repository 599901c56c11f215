"""The plain versions of the slab kernels K3 (`tsc_deposit_slab_plain`) and
K4 (`tsc_gather_grads_slab_plain`) against the JAX package's
`tsc_deposit_pallas_slab` / `tsc_gather_grads_pallas_slab` in interpret
mode, on the CPU: each slab of a full particle set at D in {1, 2, 4},
weighted and not, with windows wider than the slab and with contract
violators.  The CUDA kernels are held against these plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances as tests/test_pallas_deposit.py:26-106: 2e-6 absolute on the
deposit, 3e-5 * max on the gather.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from barcode_tpu.forward import pallas_deposit as jpd
from barcode_tpu.grid.spec import GridSpec as JGridSpec

from barcode_tpu_torch.forward import tsc_kernels as tk
from barcode_tpu_torch.grid.spec import GridSpec

DEP_ATOL, GATHER_RTOL = 2e-6, 3e-5


def particles(n, seed, jitter=1.5, n_viol=0.02):
    """Jittered lattice positions (wrapped) with a share of violators pushed
    6.2 cells in x and -5.6 in y."""
    g = GridSpec.cube(n, 3.125 * n)
    rng = np.random.default_rng(seed)
    d = np.asarray(g.cell).reshape(3, 1, 1, 1)
    idx = np.stack(np.meshgrid(*[np.arange(k) for k in g.shape],
                               indexing="ij")).astype(np.float64)
    pos = (idx + 0.5) * d + jitter * d * rng.standard_normal((3,) + g.shape)
    sel = rng.random(g.shape) < n_viol
    pos[0][sel] += 6.2 * d[0, 0, 0, 0]
    pos[1][sel] -= 5.6 * d[1, 0, 0, 0]
    pos = np.mod(pos, np.asarray([g.L1, g.L2, g.L3]).reshape(3, 1, 1, 1))
    return g, JGridSpec.cube(n, g.L1), pos.astype(np.float32), rng


# (N, D, halo, block): 16^3 at one slab with windows (8 + 2h) wider than the
# grid, 32^3 over 2 and 4 slabs (slabs of 16 and 8 rows, the 8-row slab
# narrower than its window), block (8, 8) as on the path and (8, 4)
CASES = [(16, 1, 4, (8, 8)), (16, 1, 8, (8, 8)), (32, 2, 4, (8, 8)),
         (32, 2, 8, (8, 4)), (32, 4, 4, (8, 8)), (32, 4, 8, (8, 8))]


def slabs(case):
    n, D, h, block = case
    g, jg, pos, rng = particles(n, seed=n + D + h)
    n1 = n // D
    for dev in range(D):
        p = np.ascontiguousarray(pos[:, dev * n1:(dev + 1) * n1])
        w = rng.random((n1, n, n)).astype(np.float32)
        yield g, jg, n1, dev, h, block, p, w


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_slab_deposit_plain_matches_pallas(case, weighted):
    for g, jg, n1, dev, h, block, p, w in slabs(case):
        w = w if weighted else None
        ref = np.asarray(jpd.tsc_deposit_pallas_slab(
            jnp.asarray(p), jg, n1, jnp.float32(dev), h, block=block,
            interpret=True, weights=None if w is None else jnp.asarray(w)))
        out = tk.tsc_deposit_slab_plain(
            torch.from_numpy(p), g, n1, dev, h, block,
            None if w is None else torch.from_numpy(w)).numpy()
        assert out.shape == (n1 + 2 * h, g.N2, g.N3)
        np.testing.assert_allclose(out, ref, atol=DEP_ATOL)


@pytest.mark.parametrize("want_value", [False, True])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_slab_gather_plain_matches_pallas(case, want_value):
    for g, jg, n1, dev, h, block, p, _ in slabs(case):
        rng = np.random.default_rng(dev)
        field = rng.standard_normal((n1 + 2 * h,) + g.shape[1:]).astype(
            np.float32)
        ref = np.asarray(jpd.tsc_gather_grads_pallas_slab(
            jnp.asarray(field), jnp.asarray(p), jg, n1, jnp.float32(dev), h,
            block=block, interpret=True, want_value=want_value))
        out = tk.tsc_gather_grads_slab_plain(
            torch.from_numpy(field), torch.from_numpy(p), g, n1, dev, h,
            block, want_value).numpy()
        np.testing.assert_allclose(out, ref,
                                   atol=GATHER_RTOL * np.abs(ref).max())


def test_slab_channels_match_the_tpu_stack():
    """The per-particle channels (slab-local unwrapped x, unwrapped y,
    wrapped z, fractions, weight) equal the JAX package's bit for bit."""
    g, jg, pos, rng = particles(16, seed=3)
    for D in (1, 2, 4):
        n1 = 16 // D
        for dev in range(D):
            p = np.ascontiguousarray(pos[:, dev * n1:(dev + 1) * n1])
            w = rng.random((n1, 16, 16)).astype(np.float32)
            ref = np.asarray(jpd._slab_channels(
                jnp.asarray(p), jg, n1, jnp.float32(dev), jnp.asarray(w)))
            out = tk._slab_channels(torch.from_numpy(p), g, n1, dev,
                                    torch.from_numpy(w)).numpy()
            np.testing.assert_array_equal(out, ref)


def test_slabs_fold_to_the_windowless_deposit():
    """Every slab deposited at a halo that holds every particle, margins
    folded onto the neighbouring slabs, gives the full grid's windowless
    deposit (the single-card check chip_smoke.py runs on K3)."""
    from barcode_tpu_torch.forward import assign

    g, _, pos, _ = particles(32, seed=9, jitter=0.8, n_viol=0.0)
    ref = assign.tsc_deposit(torch.from_numpy(pos), g).numpy()
    for D in (2, 4):
        n1, h = 32 // D, 8
        total = np.zeros(g.shape, np.float32)
        for dev in range(D):
            p = torch.from_numpy(np.ascontiguousarray(
                pos[:, dev * n1:(dev + 1) * n1]))
            ext = tk.tsc_deposit_slab(p, g, n1, dev, h).numpy()
            rows = (np.arange(-h, n1 + h) + dev * n1) % g.N1
            np.add.at(total, rows, ext)
        np.testing.assert_allclose(total, ref, atol=DEP_ATOL)


@pytest.mark.parametrize("bad", [
    dict(halo=6), dict(halo=0), dict(n1_loc=12), dict(dev=2),
    dict(block=(8, 3))])
def test_slab_wrappers_check_their_arguments(bad):
    g = GridSpec.cube(16, 50.0)
    args = dict(n1_loc=8, dev=1, halo=4, block=(8, 8))
    args.update(bad)
    pos = torch.zeros((3, args["n1_loc"], 16, 16))
    with pytest.raises(ValueError):
        tk.tsc_deposit_slab(pos, g, args["n1_loc"], args["dev"],
                            args["halo"], args["block"])
