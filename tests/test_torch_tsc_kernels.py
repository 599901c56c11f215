"""Port parity: the windowed TSC deposit (K1) and gather (K2) of
barcode_tpu_torch against the JAX package's Pallas kernels.

On the CPU the port's wrappers take their plain PyTorch versions; these are
held against `pallas_deposit.tsc_deposit_pallas` / `tsc_gather_grads_pallas`
in interpret mode, as the JAX package's own kernel tests run them.  The
CUDA kernels themselves are held against the plain versions by
tests/test_torch_cuda.py (marked `gpu`) and by chip_smoke.py.

Tolerances (anchored on tests/test_pallas_deposit.py): 2e-6 absolute on
deposit and gather outputs — float32 sums of <= 27 taps per particle in a
different order; the window decisions themselves are integer arithmetic and
must agree exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from barcode_tpu.grid.spec import GridSpec as JGridSpec
from barcode_tpu.forward import pallas_deposit as pd
from barcode_tpu.forward.lag2eul import (ForwardConfig as JForwardConfig,
                                         GrowthParams as JGrowthParams)
from barcode_tpu import random_fields as jrf

from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.forward import tsc_kernels as tk
from barcode_tpu_torch.forward.lag2eul import ForwardConfig, GrowthParams

N, L = 16, 160.0
JG, G = JGridSpec.cube(N, L), GridSpec.cube(N, L)
ATOL = 2e-6


def make_positions(seed, sigma_cells=0.8, n_viol=0, viol_cells=(4.2, -3.6),
                   g=G):
    """Lattice + Gaussian jitter (wrapped across the box), plus n_viol
    particles pushed far enough to break a halo-3 contract."""
    rng = np.random.default_rng(seed)
    d = np.asarray(g.cell).reshape(3, 1, 1, 1)
    idx = np.stack(np.meshgrid(*[np.arange(n) for n in g.shape],
                               indexing="ij")).astype(np.float64)
    pos = (idx + 0.5) * d + sigma_cells * d * rng.standard_normal((3,) + g.shape)
    if n_viol:
        flat = rng.choice(g.N, n_viol, replace=False)
        sel = np.zeros(g.N, bool)
        sel[flat] = True
        sel = sel.reshape(g.shape)
        pos[0][sel] += viol_cells[0] * d[0, 0, 0, 0]
        pos[1][sel] += viol_cells[1] * d[1, 0, 0, 0]
    L3 = np.asarray([g.L1, g.L2, g.L3]).reshape(3, 1, 1, 1)
    return np.mod(pos, L3).astype(np.float32)


def torch_of(a):
    return torch.from_numpy(np.array(a))


DEPOSIT_CASES = {
    "contract": dict(halo=4, block=(8, 8), weighted=False, n_viol=0),
    "violators": dict(halo=3, block=(8, 8), weighted=False, n_viol=40),
    "weighted_violators_16x8": dict(halo=3, block=(16, 8), weighted=True,
                                    n_viol=40),
    "halo_pair_8x16": dict(halo=(3, 2), block=(8, 16), weighted=True,
                           n_viol=25),
}


@pytest.mark.parametrize("case", sorted(DEPOSIT_CASES))
def test_plain_deposit_matches_pallas(case):
    c = DEPOSIT_CASES[case]
    pos = make_positions(1, n_viol=c["n_viol"])
    w = (np.random.default_rng(2).uniform(0.5, 1.5, G.shape).astype(np.float32)
         if c["weighted"] else None)
    ref = np.asarray(pd.tsc_deposit_pallas(
        jnp.asarray(pos), JG, halo=c["halo"], block=c["block"],
        interpret=True, weights=None if w is None else jnp.asarray(w)))
    out = tk.tsc_deposit_window(torch_of(pos), G, halo=c["halo"],
                                block=c["block"],
                                weights=None if w is None else torch_of(w))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    if c["n_viol"]:
        # violators deposit PARTIAL mass: the windowed sum is short of N
        total = float(w.sum()) if w is not None else G.N
        assert out.sum().item() < total - 1.0


GATHER_CASES = {
    "contract": dict(halo=4, block=(8, 8), n_viol=0),
    "violators": dict(halo=3, block=(8, 8), n_viol=40),
    "violators_16x8": dict(halo=(3, 2), block=(16, 8), n_viol=25),
}


@pytest.mark.parametrize("zfirst", [True, False])
@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_plain_gather_matches_pallas(case, zfirst):
    c = GATHER_CASES[case]
    pos = make_positions(3, n_viol=c["n_viol"])
    field = np.random.default_rng(4).standard_normal(G.shape).astype(np.float32)
    ref = np.asarray(pd.tsc_gather_grads_pallas(
        jnp.asarray(field), jnp.asarray(pos), JG, halo=c["halo"],
        block=c["block"], interpret=True, zfirst=zfirst))
    out = tk.tsc_gather_grads_window(torch_of(field), torch_of(pos), G,
                                     halo=c["halo"], block=c["block"])
    assert out.shape == (4,) + G.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    grads = tk.tsc_gather_grads_window(torch_of(field), torch_of(pos), G,
                                       halo=c["halo"], block=c["block"],
                                       want_value=False)
    np.testing.assert_allclose(grads.numpy(), ref[1:], atol=ATOL)


def test_plain_kernels_two_chain_batch():
    """A (C, 3)+grid batch (one launch for all chains) equals per-chain
    calls of the JAX kernels, weights and violators included."""
    pos = np.stack([make_positions(5, n_viol=30), make_positions(6, n_viol=10)])
    w = np.random.default_rng(7).uniform(0.0, 1.0, (2,) + G.shape).astype(np.float32)
    field = np.random.default_rng(8).standard_normal((2,) + G.shape).astype(np.float32)
    dep = tk.tsc_deposit_window(torch_of(pos), G, halo=3, block=(16, 16),
                                weights=torch_of(w)).numpy()
    gat = tk.tsc_gather_grads_window(torch_of(field), torch_of(pos), G,
                                     halo=3, block=(8, 8),
                                     want_value=False).numpy()
    assert dep.shape == (2,) + G.shape and gat.shape == (2, 3) + G.shape
    for c in range(2):
        ref_d = pd.tsc_deposit_pallas(jnp.asarray(pos[c]), JG, halo=3,
                                      block=(16, 16), interpret=True,
                                      weights=jnp.asarray(w[c]))
        ref_g = pd.tsc_gather_grads_pallas(jnp.asarray(field[c]),
                                           jnp.asarray(pos[c]), JG, halo=3,
                                           interpret=True, want_value=False)
        np.testing.assert_allclose(dep[c], np.asarray(ref_d), atol=ATOL)
        np.testing.assert_allclose(gat[c], np.asarray(ref_g), atol=ATOL)


def test_particle_channels_match_phase_a():
    """The per-particle base cells and fractions the kernels compute are
    those of the TPU kernel's particle stack (its central, unpadded block),
    bit for bit."""
    hx, hy = 4, 3
    pos = make_positions(9, n_viol=20)
    ref = np.asarray(pd._phase_a(jnp.asarray(pos), JG, hx, hy))
    ref = ref[:, hx:hx + G.N1, hy:hy + G.N2]
    out = torch.stack(tk._particle_channels(torch_of(pos), G)).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("halo", [2, 3, (4, 2), 8])
def test_deposit_violations_and_round_halo(halo):
    pos = make_positions(11, n_viol=15)
    ref = int(pd.deposit_violations(jnp.asarray(pos), JG, halo))
    assert int(tk.deposit_violations(torch_of(pos), G, halo)) == ref
    batched = tk.deposit_violations(torch_of(np.stack([pos, pos])), G, halo)
    assert batched.tolist() == [ref, ref]
    for B in (4, 8, 16):
        h = tk._halo_pair(halo)[0]
        assert tk._round_halo(h, B) == pd._round_halo(h, B)


def test_halo_measurement_matches():
    """The halo helpers see the same particle map and pick the same halo."""
    P = np.full(JG.rshape, 60.0, np.float32)
    P[0, 0, 0] = 0.0
    white = np.random.default_rng(12).standard_normal(G.shape).astype(np.float32)
    jdelta = jrf.grf_from_white(jnp.asarray(white), JG, jnp.asarray(P))
    delta = torch_of(np.asarray(jdelta))
    gp = dict(D1=1.0, D2=-3.0 / 7.0, ascale=1.0, cpecvel=52.85, hubble=100.0)
    jfc = JForwardConfig(sfmodel=3, masskernel="sph_ft", rsd=True)
    fc = ForwardConfig(sfmodel=3, masskernel="sph_ft", rsd=True)
    jh = pd._offset_histogram(jdelta, JG, jfc, JGrowthParams(**gp))
    th = tk._offset_histogram(delta, G, fc, GrowthParams(**gp))
    np.testing.assert_array_equal(th, jh)
    assert tk.displacement_halo_quantile(delta, G, fc, GrowthParams(**gp), 64) \
        == pd.displacement_halo_quantile(jdelta, JG, jfc, JGrowthParams(**gp), 64)
    assert tk.displacement_bound_cells(delta, G, fc, GrowthParams(**gp)) \
        == pd.displacement_bound_cells(jdelta, JG, jfc, JGrowthParams(**gp))


def test_cpu_wrappers_take_plain_versions_without_launching():
    """On CPU tensors the wrappers are the plain versions; nothing launches."""
    pos = torch_of(make_positions(13, n_viol=5))
    field = torch.randn(G.shape, generator=torch.Generator().manual_seed(0))
    n_dep = tk.tsc_deposit_window.launches
    n_gat = tk.tsc_gather_grads_window.launches
    assert torch.equal(tk.tsc_deposit_window(pos, G, 3, (8, 8)),
                       tk.tsc_deposit_window_plain(pos, G, 3, (8, 8)))
    assert torch.equal(tk.tsc_gather_grads_window(field, pos, G, 3, (8, 8)),
                       tk.tsc_gather_grads_window_plain(field, pos, G, 3, (8, 8)))
    assert tk.tsc_deposit_window.launches == n_dep
    assert tk.tsc_gather_grads_window.launches == n_gat


@pytest.mark.parametrize("bad", ["shape", "block", "halo"])
def test_wrappers_reject_bad_input(bad):
    pos = torch_of(make_positions(14))
    kw = dict(halo=4, block=(8, 8))
    if bad == "shape":
        pos = pos[:, :8]
    elif bad == "block":
        kw["block"] = (6, 8)
    else:
        kw["halo"] = 40
    with pytest.raises(ValueError):
        tk.tsc_deposit_window(pos, G, **kw)
    with pytest.raises(ValueError):
        tk.tsc_gather_grads_window(torch.zeros(G.shape), pos, G, **kw)
