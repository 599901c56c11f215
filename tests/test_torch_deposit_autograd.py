"""Port parity: the kernel deposit as a torch.autograd.Function (K1 forward,
K2 backward, halo-tail split) against the JAX package's
`assign.make_tsc_deposit_fast` custom VJP (Pallas in interpret mode), and
the windowless XLA-tier deposit and sph_ft kernel.

Tolerances (anchored on tests/test_pallas_deposit.py): 2e-6 absolute on
densities (3e-6 with the tail split, whose tail scatter adds a second sum
order), 3e-5 * max|grad| on position gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from barcode_tpu.grid.spec import GridSpec as JGridSpec
from barcode_tpu.forward import assign as jassign, pallas_deposit as pd

from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.forward import assign

N, L = 16, 160.0
JG, G = JGridSpec.cube(N, L), GridSpec.cube(N, L)


def make_positions(seed, n_viol=0, batch=()):
    """Jittered lattice (wrapped), with n_viol particles pushed 4.2 cells in
    x and -3.6 in y — violators of a halo-3 contract."""
    rng = np.random.default_rng(seed)
    d = np.asarray(G.cell).reshape(3, 1, 1, 1)
    idx = np.stack(np.meshgrid(*[np.arange(n) for n in G.shape],
                               indexing="ij")).astype(np.float64)
    out = []
    for _ in range(int(np.prod(batch))):
        pos = (idx + 0.5) * d + 0.8 * d * rng.standard_normal((3,) + G.shape)
        sel = np.zeros(G.N, bool)
        sel[rng.choice(G.N, n_viol, replace=False)] = True
        sel = sel.reshape(G.shape)
        pos[0][sel] += 4.2 * d[0, 0, 0, 0]
        pos[1][sel] -= 3.6 * d[1, 0, 0, 0]
        out.append(np.mod(pos, L).astype(np.float32))
    return np.stack(out).reshape(batch + (3,) + G.shape)


def jax_value_grad(dep, pos, cot, batched=False):
    """(rho, d<rho, cot>/dpos) through the JAX deposit, jitted once."""
    vg = jax.value_and_grad(lambda p, c: jnp.sum(dep(p) * c))
    f = jax.vmap(lambda p, c: (dep(p), vg(p, c)[1])) if batched else \
        (lambda p, c: (dep(p), vg(p, c)[1]))
    rho, grad = jax.jit(f)(jnp.asarray(pos), jnp.asarray(cot))
    return np.asarray(rho), np.asarray(grad)


def torch_value_grad(dep, pos, cot):
    p = torch.from_numpy(pos.copy()).requires_grad_(True)
    rho = dep(p)
    (rho * torch.from_numpy(cot)).sum().backward()
    return rho.detach().numpy(), p.grad.numpy()


CASES = {
    "contract": dict(halo=4, n_viol=0, tail=False),
    "violators_no_tail": dict(halo=3, n_viol=30, tail=False),
    "tail_split": dict(halo=3, n_viol=30, tail=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_deposit_function_matches_jax_custom_vjp(case):
    c = CASES[case]
    pos = make_positions(1, c["n_viol"])
    cot = np.random.default_rng(2).standard_normal(G.shape).astype(np.float32)
    tail_k = 4 * c["n_viol"] if c["tail"] else 0
    jdep = jassign.make_tsc_deposit_fast(JG, halo=c["halo"], interpret=True,
                                         tail_k=tail_k)
    dep = assign.make_tsc_deposit_fast(G, halo=c["halo"], tail_k=tail_k)
    rho_j, grad_j = jax_value_grad(jdep, pos, cot)
    rho_t, grad_t = torch_value_grad(dep, pos, cot)
    np.testing.assert_allclose(rho_t, rho_j, atol=3e-6 if c["tail"] else 2e-6)
    np.testing.assert_allclose(grad_t, grad_j, atol=3e-5 * np.abs(grad_j).max())
    if c["tail"]:
        # the split is exact: it equals the windowless deposit
        exact = np.asarray(jassign.tsc_deposit(jnp.asarray(pos), JG))
        np.testing.assert_allclose(rho_t, exact, atol=3e-6)


def test_deposit_function_two_chains_tail_split():
    """Chains as a leading batch dimension == the JAX vmap of the deposit."""
    pos = make_positions(3, n_viol=20, batch=(2,))
    cot = np.random.default_rng(4).standard_normal((2,) + G.shape).astype(np.float32)
    jdep = jassign.make_tsc_deposit_fast(JG, halo=3, interpret=True, tail_k=80)
    dep = assign.make_tsc_deposit_fast(G, halo=3, tail_k=80)
    rho_j, grad_j = jax_value_grad(jdep, pos, cot, batched=True)
    rho_t, grad_t = torch_value_grad(dep, pos, cot)
    np.testing.assert_allclose(rho_t, rho_j, atol=3e-6)
    np.testing.assert_allclose(grad_t, grad_j, atol=3e-5 * np.abs(grad_j).max())


@pytest.mark.parametrize("weighted", [False, True])
def test_windowless_deposit_matches_xla_tier(weighted):
    """assign.tsc_deposit (the mock's deposit, index_add_) == the JAX
    XLA-tier scatter, batched or not; its autograd gradient == jax.grad."""
    pos = make_positions(5, n_viol=10)
    w = (np.random.default_rng(6).uniform(0.5, 1.5, G.shape).astype(np.float32)
         if weighted else None)
    ref = np.asarray(jassign.tsc_deposit(
        jnp.asarray(pos), JG, None if w is None else jnp.asarray(w)))
    tw = None if w is None else torch.from_numpy(w)
    out = assign.tsc_deposit(torch.from_numpy(pos), G, tw)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-6)
    both = assign.tsc_deposit(torch.from_numpy(np.stack([pos, pos])), G, tw)
    np.testing.assert_allclose(both.numpy(), np.stack([ref, ref]), atol=2e-6)
    cot = np.random.default_rng(7).standard_normal(G.shape).astype(np.float32)
    _, grad_t = torch_value_grad(lambda p: assign.tsc_deposit(p, G, tw), pos, cot)
    jw = None if w is None else jnp.asarray(w)
    _, grad_j = jax_value_grad(lambda p: jassign.tsc_deposit(p, JG, jw), pos, cot)
    np.testing.assert_allclose(grad_t, grad_j, atol=3e-5 * np.abs(grad_j).max())


def test_sph_ft_and_overdens_match():
    pos = make_positions(8)
    h = G.cell_avg
    np.testing.assert_allclose(assign.w4_fourier(G, h).numpy(),
                               np.asarray(jassign.w4_fourier(JG, h)), rtol=0,
                               atol=0)
    ref = np.asarray(jassign.overdens(jassign.sph_ft_deposit(jnp.asarray(pos),
                                                             JG, h)))
    out = assign.overdens(assign.sph_ft_deposit(torch.from_numpy(pos), G, h))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-6)


@pytest.mark.parametrize("halo", [3, 6])
def test_auto_block_dep_and_halo_excess_match(halo):
    for n in (16, 24, 128, 256):
        assert assign.auto_block_dep(GridSpec.cube(n, 200.0), halo, (8, 8)) == \
            jassign.auto_block_dep(JGridSpec.cube(n, 200.0), halo, (8, 8))
    pos = make_positions(9, n_viol=25)
    ref = np.asarray(jassign._halo_excess(jnp.asarray(pos), JG, halo, halo - 1))
    out = assign._halo_excess(torch.from_numpy(pos), G, halo, halo - 1).numpy()
    np.testing.assert_array_equal(out, ref)
    assert int((out > 0).sum()) == int(pd.deposit_violations(
        jnp.asarray(pos), JG, (halo, halo - 1)))
