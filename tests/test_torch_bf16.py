"""Port parity of the bf16 kernel options (input.par's `pallas_bf16_dep` and
`pallas_bf16_grad`): the plain versions of K1-K4 with `bf16=True` against
the JAX package's Pallas kernels with `bf16=True` in interpret mode, as
tests/test_pallas_deposit.py:214-228 runs them; the options through
`ForwardConfig`, the input.par parser and the sharded forward.

Tolerances: the kernels' anchors, 2e-6 * max(1, max|ref|) on deposits and
3e-5 * max(1, max|ref|) on gathers (tests/test_torch_tsc_kernels.py,
test_torch_slab_kernels.py): every bf16 product is exact in float32, so
only the float32 sums differ in order.  One difference is not the port's:
XLA's CPU code (the Pallas interpret mode) contracts the TSC centre weight
0.75 - dx*dx into one fused multiply-add, where the port, as its CUDA
kernels, rounds the product first.  The two float32 weights can differ in
their last bit, and where that bit decides a bfloat16 rounding the tap
moves by one bfloat16 step.  So on positions of the quantized lattice
(`exact=True`: a power-of-two cell and fractions of 1/256 cell, where dx*dx
is exact and both forms agree) every cell must meet the anchor; on generic
positions at most 0.1% of the cells may exceed it, each by at most one
bfloat16 step of the largest value (2^-8 * max|ref|).  bf16 against
float32: within 1e-2 * max, and not equal
(tests/test_pallas_deposit.py:214-228); psi with a bf16 gradient equal to
the float32 psi within rtol 1e-6 (tests/test_pallas_deposit.py:231-252).
The CUDA kernels' bf16 variants are held against these plain versions on
the card by tests/test_torch_cuda.py and chip_smoke.py's `bf16` phase.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from barcode_tpu.config import RunConfig as JRunConfig
from barcode_tpu.forward import pallas_deposit as jpd
from barcode_tpu.grid.spec import GridSpec as JGridSpec

from barcode_tpu_torch.config import RunConfig
from barcode_tpu_torch.forward import assign, tsc_kernels as tk
from barcode_tpu_torch.forward.lag2eul import (ForwardConfig, GrowthParams,
                                               displaced_positions, lag2eul)
from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.model.likelihoods import ObsData
from barcode_tpu_torch.model.posterior import (ModelConfig,
                                               make_psi_value_and_grad)
from barcode_tpu_torch.parallel import distributed as pdist
from barcode_tpu_torch.parallel import sharded_forward as sfw

import test_torch_sharded_forward as tsf
from test_torch_tsc_kernels import make_positions

N, L = 16, 160.0
JG, G = JGridSpec.cube(N, L), GridSpec.cube(N, L)
# the quantized lattice's grid: a power-of-two cell (2 Mpc/h)
JGQ, GQ = JGridSpec.cube(N, 2.0 * N), GridSpec.cube(N, 2.0 * N)
DEP_REL, GATHER_REL = 2e-6, 3e-5
BF16_STEP = 2.0**-8


def quantized(pos, g):
    """Positions moved to the nearest 1/256 of a cell (g's cell a power of
    two): pos / d, its fraction and dx*dx are then exact in float32."""
    d = np.asarray(g.cell).reshape(3, 1, 1, 1)
    return (np.round(pos / d * 256.0) / 256.0 * d).astype(np.float32)


def anchor(out, ref, rel, exact=True):
    """out within rel * max(1, max|ref|) of ref; unless `exact`, at most
    0.1% of the cells may instead be within one bfloat16 step of the
    largest value (module docstring)."""
    out, ref = np.asarray(out), np.asarray(ref)
    diff = np.abs(out - ref)
    over = diff > rel * max(1.0, np.abs(ref).max())
    if exact:
        assert not over.any(), (over.sum(), diff.max())
    else:
        assert over.mean() <= 1e-3, (over.sum(), diff.max())
        assert diff.max() <= BF16_STEP * np.abs(ref).max()


def near_f32(bf, f32):
    """bf16 differs from float32, within 1e-2 * max."""
    bf, f32 = np.asarray(bf), np.asarray(f32)
    diff = np.abs(bf - f32).max()
    assert 0 < diff <= 1e-2 * np.abs(f32).max()


DEPOSIT_CASES = {
    "contract": dict(halo=4, block=(8, 8), weighted=False, n_viol=0),
    "violators_weighted": dict(halo=3, block=(16, 8), weighted=True,
                               n_viol=40),
    "halo_pair_weighted": dict(halo=(3, 2), block=(8, 16), weighted=True,
                               n_viol=25),
}


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("case", sorted(DEPOSIT_CASES))
def test_bf16_deposit_matches_pallas(case, stream, exact):
    """K1's plain version with bf16 against both TPU bodies (blocked and
    streamed) with bf16."""
    c = DEPOSIT_CASES[case]
    g, jg = (GQ, JGQ) if exact else (G, JG)
    pos = make_positions(1, n_viol=c["n_viol"], g=g)
    if exact:
        pos = quantized(pos, g)
    w = (np.random.default_rng(2).uniform(0.5, 1.5, g.shape).astype(
        np.float32) if c["weighted"] else None)
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.from_numpy(w)
    ref = np.asarray(jpd.tsc_deposit_pallas(
        jnp.asarray(pos), jg, halo=c["halo"], block=c["block"],
        interpret=True, weights=jw, bf16=True, stream=stream))
    out = tk.tsc_deposit_window(torch.from_numpy(pos), g, c["halo"],
                                c["block"], weights=tw, bf16=True)
    anchor(out, ref, DEP_REL, exact)
    near_f32(out, tk.tsc_deposit_window(torch.from_numpy(pos), g, c["halo"],
                                        c["block"], weights=tw))


GATHER_CASES = {
    "contract": dict(halo=4, block=(8, 8), n_viol=0),
    "violators": dict(halo=3, block=(8, 8), n_viol=40),
    "halo_pair": dict(halo=(3, 2), block=(8, 16), n_viol=25),
}


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("want_value", [False, True])
@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_bf16_gather_matches_pallas(case, want_value, exact):
    """K2's plain version with bf16 against the TPU's z-first body with
    bf16 (field taps, z weights and derivatives rounded)."""
    c = GATHER_CASES[case]
    g, jg = (GQ, JGQ) if exact else (G, JG)
    pos = make_positions(3, n_viol=c["n_viol"], g=g)
    if exact:
        pos = quantized(pos, g)
    field = np.random.default_rng(4).standard_normal(g.shape).astype(
        np.float32)
    ref = np.asarray(jpd.tsc_gather_grads_pallas(
        jnp.asarray(field), jnp.asarray(pos), jg, halo=c["halo"],
        block=c["block"], interpret=True, bf16=True, want_value=want_value))
    out = tk.tsc_gather_grads_window(torch.from_numpy(field),
                                     torch.from_numpy(pos), g, c["halo"],
                                     c["block"], want_value, bf16=True)
    anchor(out, ref, GATHER_REL, exact)
    near_f32(out, tk.tsc_gather_grads_window(
        torch.from_numpy(field), torch.from_numpy(pos), g, c["halo"],
        c["block"], want_value))


# (N, slabs, halo, block), from tests/test_torch_slab_kernels.py: one slab
# with windows wider than the grid, and 2 slabs under 24-row windows
SLAB_CASES = [(16, 1, 4, (8, 8)), (32, 2, 8, (8, 4))]


def slab_inputs(case, exact):
    n, D, h, block = case
    g = GridSpec.cube(n, (2.0 if exact else 3.125) * n)
    jg = JGridSpec.cube(n, g.L1)
    pos = make_positions(n + D, sigma_cells=1.5, n_viol=n * n // 8, g=g)
    if exact:
        pos = quantized(pos, g)
    n1 = n // D
    rng = np.random.default_rng(n + h)
    for dev in range(D):
        p = np.ascontiguousarray(pos[:, dev * n1:(dev + 1) * n1])
        yield g, jg, n1, dev, h, block, p, rng


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", SLAB_CASES, ids=str)
def test_bf16_slab_deposit_matches_pallas(case, weighted, exact):
    for g, jg, n1, dev, h, block, p, rng in slab_inputs(case, exact):
        w = rng.random((n1, g.N2, g.N3)).astype(np.float32) if weighted \
            else None
        ref = np.asarray(jpd.tsc_deposit_pallas_slab(
            jnp.asarray(p), jg, n1, jnp.float32(dev), h, block=block,
            interpret=True, weights=None if w is None else jnp.asarray(w),
            bf16=True))
        tw = None if w is None else torch.from_numpy(w)
        out = tk.tsc_deposit_slab(torch.from_numpy(p), g, n1, dev, h, block,
                                  weights=tw, bf16=True)
        anchor(out, ref, DEP_REL, exact)
        near_f32(out, tk.tsc_deposit_slab(torch.from_numpy(p), g, n1, dev, h,
                                          block, weights=tw))


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("want_value", [False, True])
@pytest.mark.parametrize("case", SLAB_CASES, ids=str)
def test_bf16_slab_gather_matches_pallas(case, want_value, exact):
    for g, jg, n1, dev, h, block, p, rng in slab_inputs(case, exact):
        field = rng.standard_normal((n1 + 2 * h,) + g.shape[1:]).astype(
            np.float32)
        ref = np.asarray(jpd.tsc_gather_grads_pallas_slab(
            jnp.asarray(field), jnp.asarray(p), jg, n1, jnp.float32(dev), h,
            block=block, interpret=True, bf16=True, want_value=want_value))
        out = tk.tsc_gather_grads_slab(torch.from_numpy(field),
                                       torch.from_numpy(p), g, n1, dev, h,
                                       block, want_value, bf16=True)
        anchor(out, ref, GATHER_REL, exact)
        near_f32(out, tk.tsc_gather_grads_slab(
            torch.from_numpy(field), torch.from_numpy(p), g, n1, dev, h,
            block, want_value))


def test_bf16_products_are_exact():
    """A bf16 tap weight is the exact float32 product of two bfloat16
    values (8-bit significands): rounding it once more changes nothing."""
    pos = torch.from_numpy(make_positions(5))
    ref = tk.tsc_deposit_window(pos, G, 4, (8, 8), bf16=True)
    x = torch.rand(1000, generator=torch.Generator().manual_seed(1))
    a, b = tk._bf16(x), tk._bf16(1.0 - x)
    assert torch.equal((a.double() * b.double()).float(), a * b)
    assert torch.isfinite(ref).all()


GP = GrowthParams(D1=1.0, D2=-3.0 / 7.0, ascale=1.0, cpecvel=52.85,
                  hubble=100.0)


def forward_problem():
    """A 16^3 Zel'dovich + TSC problem whose kernel halo 2 leaves contract
    violators for the tail split (tests/test_pallas_deposit.py:231-252's
    flow, with the split on)."""
    rng = np.random.default_rng(3)
    P = np.full(G.rshape, 10.0, np.float32)
    P[0, 0, 0] = 0.0
    k = np.sqrt(np.fft.fftfreq(N)[:, None, None] ** 2
                + np.fft.fftfreq(N)[None, :, None] ** 2
                + np.fft.rfftfreq(N)[None, None, :] ** 2)
    modes = (rng.standard_normal(G.rshape) + 1j * rng.standard_normal(
        G.rshape)) * np.sqrt(P / 2.0) * np.exp(-8.0 * k)
    truth = np.fft.irfftn(modes * N**1.5, s=G.shape, axes=(0, 1, 2)).astype(
        np.float32)
    truth = torch.from_numpy(4.0 * truth / truth.std())
    nobs = 1.0 + lag2eul(truth, G, ForwardConfig(sfmodel=1, masskernel="tsc"),
                         GP)
    obs = ObsData(nobs=nobs, window=torch.ones(G.shape),
                  noise=torch.ones(G.shape), power=torch.from_numpy(P))
    return 0.5 * truth, obs


@pytest.mark.parametrize("dep", [False, True])
def test_bf16_options_through_forward_config(dep):
    """pallas_bf16_grad through ForwardConfig with the tail split: psi equal
    to the float32 psi where only the gradient is bf16 (rtol 1e-6), the
    gradient within 1e-2 * max of the float32 one; with pallas_bf16_dep
    too, psi moves off the float32 psi, within 1e-2 relative."""
    delta, obs = forward_problem()

    def vag(bf16_grad, bf16_dep):
        fc = ForwardConfig(sfmodel=1, masskernel="tsc", pallas_deposit=True,
                           pallas_halo=2, pallas_tail_k=2048,
                           pallas_bf16_grad=bf16_grad,
                           pallas_bf16_dep=bf16_dep)
        (psi, _), grad = make_psi_value_and_grad(
            G, ModelConfig(likelihood=1, forward=fc), GP, obs)(delta[None])
        return psi[0].item(), grad[0]

    pos = displaced_positions(delta[None], G, ForwardConfig(
        sfmodel=1, masskernel="tsc"), GP)
    assert (assign._halo_excess(pos, G, 2, 2) > 0).sum() > 0  # a real tail
    v32, g32 = vag(False, False)
    v16, g16 = vag(True, dep)
    near_f32(g16.numpy(), g32.numpy())
    if dep:
        assert v16 != v32 and abs(v16 - v32) <= 1e-2 * abs(v32)
    else:
        np.testing.assert_allclose(v16, v32, rtol=1e-6)


PAR = """\
Nx = 16
Lx = 100.0
sfmodel = 3
masskernel = 2
pallas_deposit = true
pallas_halo = 4
pallas_tail_k = 64
"""


@pytest.mark.parametrize("grad,dep", [("true", "false"), ("false", "true"),
                                      ("true", "true")])
def test_input_par_bf16_keys_parse_like_jax(grad, dep, tmp_path):
    path = tmp_path / "input.par"
    path.write_text(PAR + f"pallas_bf16_grad = {grad}\n"
                    f"pallas_bf16_dep = {dep}\n")
    fc = RunConfig.from_input_par(path).model.forward
    jfc = JRunConfig.from_input_par(path).model.forward
    assert dataclasses.asdict(fc) == dataclasses.asdict(jfc)
    assert (fc.pallas_bf16_grad, fc.pallas_bf16_dep) == (grad == "true",
                                                         dep == "true")


@pytest.mark.parametrize("name", ["pallas_tail_split"])
def test_bf16_sharded_forward_matches_jax(name):
    """The sharded posterior with both bf16 keys (K3 and K4 in bf16, the
    slab tail in float32) against the JAX package's, at one rank of a gloo
    group of one.  psi within the sharded tests' rtol 3e-5.  The gradient
    within one bfloat16 step of its largest value: the cotangent the bf16
    gather rounds comes out of FFT chains whose float32 bits differ between
    the packages, so a few taps round the other way (the module
    docstring's flip).  And it lies far closer to the JAX package's bf16
    gradient than the port's float32 gradient does: the keys reached K3
    and K4 (psi cannot tell: the bf16 deposit moves it less than the
    float32 noise between the packages)."""
    jg, jfc, halo, a = tsf.problem(name)
    jfc16 = dataclasses.replace(jfc, pallas_bf16_dep=True,
                                pallas_bf16_grad=True)
    psi_ref, grad_ref = tsf.jax_psi_grad(jg, jfc16, halo, a, 1)
    layout = pdist.make_layout(1, 1, device="cpu")
    g = GridSpec.cube(jg.N1, jg.L1)
    obs = sfw.shard_obs(ObsData(nobs=a["nobs"], window=a["window"],
                                noise=a["noise"], power=a["power"]), layout)
    s = torch.from_numpy(a["s"])
    out = {}
    for bf16 in (False, True):
        fc = dataclasses.replace(tsf.port_fc(jfc), pallas_bf16_dep=bf16,
                                 pallas_bf16_grad=bf16)
        psi_fn, grad_fn = sfw.make_sharded_psi(
            g, ModelConfig(likelihood=1, forward=fc), tsf.GP, layout,
            halo=halo)
        out[bf16] = psi_fn(s, obs), grad_fn(s, obs).numpy()
    psi, grad = out[True]
    np.testing.assert_allclose(psi, psi_ref, rtol=tsf.PSI_RTOL)
    assert np.abs(grad - grad_ref).max() <= BF16_STEP * np.abs(grad_ref).max()
    assert np.linalg.norm(grad - grad_ref) <= 0.1 * np.linalg.norm(
        out[False][1] - grad_ref)
