"""Port parity for K1s, the streamed-window deposit: the port's stream gate
against the JAX package's, and `tsc_deposit_window(stream=True)` on the CPU
(its plain version) against `pallas_deposit.tsc_deposit_pallas(stream=True)`
in interpret mode, the JAX package's streamed body.

The CUDA kernel itself is held against the plain version and against K1 by
tests/test_torch_cuda.py (marked `gpu`) and chip_smoke.py.

Tolerance: 2e-5 absolute, as the JAX package's own streamed-kernel test
(tests/test_pallas_deposit.py:183) — float32 sums of the window's taps in
another order; the window decisions are integer arithmetic.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from barcode_tpu.grid.spec import GridSpec as JGridSpec
from barcode_tpu.forward import pallas_deposit as pd

from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.forward import tsc_kernels as tk

ATOL = 2e-5


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("block", [(8, 8), (16, 8), (16, 16)])
def test_stream_gate_matches_the_jax_package(block, weighted):
    """stream=None picks K1s exactly where tsc_deposit_pallas streams
    (pallas_deposit.py:815-817)."""
    for n in (16, 32, 128, 256):
        g, jg = GridSpec.cube(n, 200.0), JGridSpec.cube(n, 200.0)
        for halo in range(2, 15):
            hx = pd._round_halo(halo, block[0])
            ref = pd.deposit_working_set_bytes(
                jg, (hx, halo), block, weighted=weighted) > pd.DEP_VMEM_BUDGET
            assert tk.stream_selected(g, (hx, halo), block, weighted) == ref, \
                (n, halo)
            assert tk.deposit_working_set_bytes(g, (hx, halo), block,
                                                weighted) == \
                pd.deposit_working_set_bytes(jg, (hx, halo), block, weighted)


def test_stream_gate_chooses_k1s_at_256():
    """The 256^3 headline shapes: every weighted (tail-split) deposit
    streams at the halos the JAX profile saw (artifacts/profile_r4_256.json:
    halo 10)."""
    g = GridSpec.cube(256, 200.0)
    for halo in (8, 10, 12):
        assert tk.stream_selected(g, (tk._round_halo(halo, 16), halo),
                                  (16, 16), weighted=True)
    assert not tk.stream_selected(GridSpec.cube(128, 200.0), (12, 12),
                                  (16, 16), weighted=True)


def positions(g, seed, n_viol, chains=2):
    """Jittered lattice per chain (wrapped), n_viol particles pushed 4.2
    cells in x and -3.6 in y: violators of a halo-3 contract."""
    rng = np.random.default_rng(seed)
    d = np.asarray(g.cell).reshape(3, 1, 1, 1)
    idx = np.stack(np.meshgrid(*[np.arange(n) for n in g.shape],
                               indexing="ij")).astype(np.float64)
    out = []
    for _ in range(chains):
        pos = (idx + 0.5) * d + 0.8 * d * rng.standard_normal((3,) + g.shape)
        sel = np.zeros(g.N, bool)
        sel[rng.choice(g.N, n_viol, replace=False)] = True
        sel = sel.reshape(g.shape)
        pos[0][sel] += 4.2 * d[0, 0, 0, 0]
        pos[1][sel] -= 3.6 * d[1, 0, 0, 0]
        L = np.asarray([g.L1, g.L2, g.L3]).reshape(3, 1, 1, 1)
        out.append(np.mod(pos, L))
    return np.stack(out).astype(np.float32)


CASES = {
    # block (16, 16) at 16^3: the window is wider than the grid (WX = 24 or
    # 32 > 16), so particles are met through two periodic copies; at 32^3
    # it is narrower (WX = 24)
    "wide_window_violators": dict(n=16, halo=3, n_viol=40),
    "wide_window_halo6": dict(n=16, halo=6, n_viol=0),
    "violators_32": dict(n=32, halo=(3, 2), n_viol=120),
}


@pytest.mark.parametrize("case,weighted", [
    ("wide_window_violators", False), ("wide_window_violators", True),
    ("wide_window_halo6", False), ("wide_window_halo6", True),
    ("violators_32", True)])
def test_stream_deposit_matches_pallas_stream(case, weighted):
    c = CASES[case]
    g, jg = GridSpec.cube(c["n"], 12.5 * c["n"]), \
        JGridSpec.cube(c["n"], 12.5 * c["n"])
    pos = positions(g, 3, c["n_viol"])
    w = (np.random.default_rng(4).uniform(0.5, 1.5, (2,) + g.shape)
         .astype(np.float32) if weighted else None)
    ref = np.stack([np.asarray(pd.tsc_deposit_pallas(
        jnp.asarray(pos[i]), jg, halo=c["halo"], block=(16, 16),
        interpret=True, stream=True,
        weights=None if w is None else jnp.asarray(w[i])))
        for i in range(2)])
    n0 = (tk.tsc_deposit_window.launches, tk.tsc_deposit_window.launches_bf16)
    out = tk.tsc_deposit_window(torch.from_numpy(pos), g, c["halo"], (16, 16),
                                weights=None if w is None
                                else torch.from_numpy(w), stream=True)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    # on the CPU both choices are the one plain version; nothing launches
    same = tk.tsc_deposit_window(torch.from_numpy(pos), g, c["halo"],
                                 (16, 16), weights=None if w is None
                                 else torch.from_numpy(w), stream=False)
    assert torch.equal(out, same)
    assert n0 == (tk.tsc_deposit_window.launches,
                  tk.tsc_deposit_window.launches_bf16)
