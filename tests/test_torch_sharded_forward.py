"""The port's sharded posterior (psi and grad psi through the slab deposit
K3/K4, the ring exchange and the sharded FFTs) against the JAX package's
sharded posterior with `pallas_deposit=True` (Pallas in interpret mode), on
the CPU: at one rank in-process, at two ranks over gloo, and on a 2 x 2
(chains, grid) layout over four gloo processes.

Tolerances as tests/test_sharded_forward.py:144-147: psi within rtol 3e-5,
grad psi within 3e-5 * max|grad|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from barcode_tpu import random_fields as rf
from barcode_tpu.forward.lag2eul import ForwardConfig as JFC
from barcode_tpu.forward.lag2eul import GrowthParams as JGP
from barcode_tpu.forward.lag2eul import lag2eul
from barcode_tpu.grid.spec import GridSpec as JGridSpec
from barcode_tpu.model.likelihoods import ObsData as JObs
from barcode_tpu.parallel import sharded_forward as jsfw

from barcode_tpu_torch.forward import tsc_kernels as tk
from barcode_tpu_torch.forward.lag2eul import ForwardConfig, GrowthParams
from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.model.likelihoods import ObsData
from barcode_tpu_torch.model.posterior import ModelConfig
from barcode_tpu_torch.parallel import distributed as pd
from barcode_tpu_torch.parallel import sharded_forward as sfw

import torch_workers

JGP_ = JGP(D1=1.0, D2=-3.0 / 7.0, ascale=1.0, cpecvel=52.85, hubble=100.0)
GP = GrowthParams(D1=1.0, D2=-3.0 / 7.0, ascale=1.0, cpecvel=52.85,
                  hubble=100.0)
PSI_RTOL, GRAD_RTOL = 3e-5, 3e-5

# (name, N, sfmodel, masskernel, rsd, pallas, kernel halo, tail_k, halo,
#  truth scale, signal scale)
CASES = {
    "pallas_zeldovich": (32, 1, "tsc", False, True, 4, 0, 4, 1.0, 0.5),
    "pallas_alpt_sph_ft_rsd": (32, 3, "sph_ft", True, True, 4, 0, 4, 1.0,
                               0.5),
    # kernels at halo 4 with violators, exchange margin 8
    # (tests/test_sharded_forward.py:292)
    "pallas_tail_split": (32, 1, "tsc", False, True, 4, 256, 8, 30.0, 1.0),
    # the windowless slab deposit (tests/test_sharded_forward.py:212)
    "windowless_2lpt": (16, 2, "tsc", False, False, 0, 0, 2, 1.0, 0.5),
}


def problem(name):
    """numpy inputs of one case, made by the JAX package from a seed."""
    n, sfm, mk, rsd, pallas, ph, tail, halo, scale, sscale = CASES[name]
    jg = JGridSpec.cube(n, 10.0 * n)
    P_ = jnp.full(jg.rshape, 20.0).at[0, 0, 0].set(0.0)
    truth = scale * rf.grf(jax.random.key(0), jg, P_)
    fc_d = JFC(sfmodel=sfm, masskernel=mk, slength=20.0, rsd=rsd)
    d_eul = lag2eul(truth, jg, fc_d, JGP_)
    nobs = 1.0 + d_eul + 0.4 * jax.random.normal(jax.random.key(1), jg.shape)
    jfc = JFC(sfmodel=sfm, masskernel=mk, slength=20.0, rsd=rsd,
              pallas_deposit=pallas, pallas_halo=ph, pallas_tail_k=tail)
    arrays = {"nobs": np.array(nobs), "window": np.ones(jg.shape, np.float32),
              "noise": np.full(jg.shape, 0.4, np.float32),
              "power": np.array(P_), "s": np.array(sscale * truth)}
    return jg, jfc, halo, arrays


def jax_psi_grad(jg, jfc, halo, a, n_dev):
    mesh = Mesh(np.asarray(jax.devices()[:n_dev]), axis_names=(jsfw.AXIS,))
    psi, grad = jsfw.make_sharded_psi(jg, jfc, JGP_, likelihood=1, mesh=mesh,
                                      halo=halo)
    obs = jsfw.shard_obs(JObs(nobs=jnp.asarray(a["nobs"]),
                              window=jnp.asarray(a["window"]),
                              noise=jnp.asarray(a["noise"]),
                              power=jnp.asarray(a["power"])), mesh)
    s = jax.device_put(jnp.asarray(a["s"]), NamedSharding(mesh, P(jsfw.AXIS)))
    return float(psi(s, obs)), np.asarray(grad(s, obs))


def port_fc(jfc):
    return ForwardConfig(sfmodel=jfc.sfmodel, masskernel=jfc.masskernel,
                         rsd=jfc.rsd, slength=jfc.slength,
                         pallas_deposit=jfc.pallas_deposit,
                         pallas_halo=jfc.pallas_halo,
                         pallas_tail_k=jfc.pallas_tail_k)


def port_mc(jfc, likelihood=1):
    return ModelConfig(likelihood=likelihood, forward=port_fc(jfc))


def assert_psi_grad(psi, grad, psi_ref, grad_ref):
    np.testing.assert_allclose(psi, psi_ref, rtol=PSI_RTOL)
    np.testing.assert_allclose(grad, grad_ref,
                               atol=GRAD_RTOL * np.abs(grad_ref).max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_psi_and_grad_at_one_rank(name):
    """At one rank the slab spans the whole box (the JAX package's 1-device
    mesh regression, tests/test_sharded_forward.py:212) and the ring folds
    onto the rank itself."""
    jg, jfc, halo, a = problem(name)
    psi_ref, grad_ref = jax_psi_grad(jg, jfc, halo, a, 1)
    layout = pd.make_layout(1, 1, device="cpu")
    g = GridSpec.cube(jg.N1, jg.L1)
    psi_fn, grad_fn = sfw.make_sharded_psi(g, port_mc(jfc), GP, layout,
                                           halo=halo)
    obs = sfw.shard_obs(ObsData(nobs=a["nobs"], window=a["window"],
                                noise=a["noise"], power=a["power"]), layout)
    s = torch.from_numpy(a["s"])
    n3 = tk.tsc_deposit_slab.launches
    assert_psi_grad(psi_fn(s, obs), grad_fn(s, obs).numpy(), psi_ref,
                    grad_ref)
    # on the CPU the wrappers take the plain versions: nothing launches
    assert tk.tsc_deposit_slab.launches == n3


def test_tail_split_without_tail_drops_mass():
    """The tail-split problem at kernel halo 4 with no tail loses the
    violators' mass, so psi moves far beyond the tolerance: the case above
    is not trivial (tests/test_sharded_forward.py:322)."""
    jg, jfc, halo, a = problem("pallas_tail_split")
    psi_ref, _ = jax_psi_grad(jg, jfc, halo, a, 1)
    g = GridSpec.cube(jg.N1, jg.L1)
    fc = ForwardConfig(sfmodel=1, masskernel="tsc", pallas_deposit=True,
                       pallas_halo=4, pallas_tail_k=0)
    layout = pd.make_layout(1, 1, device="cpu")
    psi_fn, _ = sfw.make_sharded_psi(g, ModelConfig(likelihood=1, forward=fc),
                                     GP, layout, halo=4)
    obs = sfw.shard_obs(ObsData(nobs=a["nobs"], window=a["window"],
                                noise=a["noise"], power=a["power"]), layout)
    assert abs(psi_fn(torch.from_numpy(a["s"]), obs) - psi_ref) > 1.0


def _case_inputs(names, extra=None):
    inp = {"n_cases": np.int64(len(names))}
    for k, name in enumerate(names):
        jg, jfc, halo, a = problem(name)
        inp.update({f"c{k}_{key}": v for key, v in a.items()})
        inp.update({f"c{k}_sfmodel": np.int64(jfc.sfmodel),
                    f"c{k}_mk": np.str_(jfc.masskernel),
                    f"c{k}_rsd": np.bool_(jfc.rsd),
                    f"c{k}_pallas": np.bool_(jfc.pallas_deposit),
                    f"c{k}_pallas_halo": np.int64(jfc.pallas_halo),
                    f"c{k}_tail_k": np.int64(jfc.pallas_tail_k),
                    f"c{k}_halo": np.int64(halo)})
        inp["N"], inp["L"] = np.int64(jg.N1), np.float64(jg.L1)
    inp.update(extra or {})
    return inp


TWO_RANK = ["pallas_zeldovich", "pallas_alpt_sph_ft_rsd", "pallas_tail_split"]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    inp = _case_inputs(TWO_RANK)
    return inp, torch_workers.launch("psi_worker", 2, inp,
                                     tmp_path_factory.mktemp("psi2"))


@pytest.mark.parametrize("k", range(len(TWO_RANK)),
                         ids=lambda k: TWO_RANK[k])
def test_sharded_psi_and_grad_at_two_ranks(two_ranks, k):
    """Two gloo ranks of 16 rows each: the ring exchange, the all-to-all
    transposes and the all-reduced mean inside the gradient."""
    _, outs = two_ranks
    jg, jfc, halo, a = problem(TWO_RANK[k])
    psi_ref, grad_ref = jax_psi_grad(jg, jfc, halo, a, 2)
    assert outs[0][f"c{k}_psi"] == outs[1][f"c{k}_psi"]  # same bits
    grad = np.concatenate([o[f"c{k}_grad"] for o in outs])
    assert_psi_grad(float(outs[0][f"c{k}_psi"]), grad, psi_ref, grad_ref)
    # and against the dense port (windowless deposit): a gradient summed
    # over the ranks' partial psi counts each slab once, not D times
    assert_psi_grad(float(outs[0][f"c{k}_psi"]), grad,
                    float(outs[0][f"c{k}_dense_psi"]),
                    outs[0][f"c{k}_dense_grad"])


CHAIN_CASES = ["pallas_zeldovich", "pallas_tail_split"]


@pytest.fixture(scope="module")
def chains_grid(tmp_path_factory):
    """make_sharded_psi_vg_chains on a 2 x 2 layout (as
    tests/test_sharded_forward.py:150 and :342), with a local batch of two
    chains on every rank (the JAX package's vmapped local chains)."""
    inp = _case_inputs(CHAIN_CASES, {"rows": np.int64(2),
                                     "chains_per_rank": np.int64(2)})
    for k, name in enumerate(CHAIN_CASES):
        s = inp[f"c{k}_s"]
        inp[f"c{k}_batch"] = np.stack([s, -0.8 * s, 0.5 * s, -0.3 * s]
                                      ).astype(np.float32)
    return inp, torch_workers.launch("chains_worker", 4, inp,
                                     tmp_path_factory.mktemp("chains"))


@pytest.mark.parametrize("k", range(len(CHAIN_CASES)),
                         ids=lambda k: CHAIN_CASES[k])
def test_psi_vg_chains_on_a_2x2_layout(chains_grid, k):
    inp, outs = chains_grid
    jg, jfc, halo, _ = problem(CHAIN_CASES[k])
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                axis_names=("chains", jsfw.AXIS))
    vg = jsfw.make_sharded_psi_vg_chains(jg, jfc, JGP_, likelihood=1,
                                         mesh=mesh, halo=halo)
    obs = jsfw.shard_obs_chains(JObs(
        nobs=jnp.asarray(inp[f"c{k}_nobs"]),
        window=jnp.asarray(inp[f"c{k}_window"]),
        noise=jnp.asarray(inp[f"c{k}_noise"]),
        power=jnp.asarray(inp[f"c{k}_power"])), mesh)
    batch = jax.device_put(jnp.asarray(inp[f"c{k}_batch"]), NamedSharding(
        mesh, P("chains", jsfw.AXIS, None, None)))
    (vals_ref, _), grads_ref = vg(batch, obs)
    vals_ref, grads_ref = np.asarray(vals_ref), np.asarray(grads_ref)
    by_pos = {(int(o["row"]), int(o["col"])): o for o in outs}
    for c in range(4):
        row = [by_pos[(c // 2, col)] for col in range(2)]
        j = c % 2  # the chain's place in its row's local batch
        assert row[0][f"c{k}_vals"][j] == row[1][f"c{k}_vals"][j]
        grad = np.concatenate([o[f"c{k}_grads"][j] for o in row])
        assert_psi_grad(float(row[0][f"c{k}_vals"][j]), grad, vals_ref[c],
                        grads_ref[c])
