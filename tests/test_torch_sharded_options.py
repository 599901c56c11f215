"""`--sharded` computes the model the dense path computes, or refuses it.

The port's slab posterior (`parallel.sharded_forward`) against the JAX
package's *dense* `make_psi_force` on the same numpy inputs at 16^3 on the
CPU: every likelihood, a clipping `delta_min`, the observation scalars
(rho_c, biasP, biasE), the force factors, `correct_delta`,
`deltaQ_factor` and every sfmodel, at one rank in-process and (likelihood
3, the clipping `delta_min`) at two gloo ranks.  The JAX package's own
sharded path drops these options, so it is not the reference here.  Also:
a sharded attempt with each integrator against the dense sampler's from
the same state and momenta; the options the slab posterior refuses, at
every sharded entry point, in `ShardedRunner` before any file and on the
command line; and the windowless path's dump-time violation monitor.

Tolerances as tests/test_torch_sharded_forward.py: psi within rtol 3e-5,
the force within 3e-5 * max|ref|.
"""
import dataclasses
import functools
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from barcode_tpu.forward.lag2eul import ForwardConfig as JFC
from barcode_tpu.forward.lag2eul import GrowthParams as JGP
from barcode_tpu.grid.spec import GridSpec as JGridSpec
from barcode_tpu.model import posterior as jposterior
from barcode_tpu.model.likelihoods import ObsData as JObs

from barcode_tpu_torch.config import HMCConfig, RunConfig
from barcode_tpu_torch.forward.lag2eul import (ForwardConfig, GrowthParams,
                                               displaced_positions, lag2eul)
from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.hmc import mass as mass_mod, sampler
from barcode_tpu_torch.model.likelihoods import ObsData
from barcode_tpu_torch.model.posterior import ModelConfig
from barcode_tpu_torch.parallel import distributed as pd
from barcode_tpu_torch.parallel import sharded_forward as sfw
from barcode_tpu_torch.parallel import sharded_sampler as ss
from barcode_tpu_torch.parallel.sharded_fft import shard_real
from barcode_tpu_torch.parallel.sharded_runner import ShardedRunner

import torch_workers
from test_torch_sharded_forward import assert_psi_grad

N, BOX, HALO = 16, 160.0, 4
GPD = dict(D1=0.8, D2=-3.0 / 7.0 * 0.64, ascale=1.0, cpecvel=52.85,
           hubble=100.0)
GP = GrowthParams(**GPD)
BASE_FC = dict(sfmodel=2, masskernel="tsc", slength=20.0)
OBS_SCALARS = dict(rho_c=1.5, biasP=0.9, biasE=1.2)

# name: (ModelConfig fields, ForwardConfig fields, ObsData scalars)
CASES = {
    "likelihood0": (dict(likelihood=0), {}, {}),
    "likelihood1": (dict(likelihood=1), {}, {}),
    "likelihood2": (dict(likelihood=2), {}, {}),
    "likelihood3": (dict(likelihood=3), {}, {}),
    "likelihood2_delta_min": (dict(likelihood=2), {}, "clip"),
    "obs_scalars": (dict(likelihood=1), {}, OBS_SCALARS),
    "grad_prior_factor": (dict(likelihood=1, grad_prior_factor=0.5), {}, {}),
    "grad_likeli_factor": (dict(likelihood=1, grad_likeli_factor=2.0), {},
                           {}),
    "correct_delta": (dict(likelihood=1, correct_delta=True), {}, {}),
    "deltaQ_factor": (dict(likelihood=1, deltaQ_factor=0.8), {}, {}),
    "sfmodel1": (dict(likelihood=1), dict(sfmodel=1), {}),
    "sfmodel3": (dict(likelihood=1), dict(sfmodel=3), {}),
    # the headline model: ALPT, plane-parallel RSD, sph_ft, the slab
    # kernels' plain versions at kernel halo 4
    "sfmodel3_sph_ft_rsd_kernels": (
        dict(likelihood=1), dict(sfmodel=3, masskernel="sph_ft", rsd=True,
                                 pallas_deposit=True, pallas_halo=4), {}),
}


@functools.lru_cache(maxsize=1)
def fields():
    """numpy inputs from a seed: a smoothed Gaussian signal, the truth it
    perturbs, and per-likelihood observations of the truth's Eulerian
    density (the port's dense windowless forward)."""
    rng = np.random.default_rng(11)
    k = np.fft.fftfreq(N, BOX / N / (2 * np.pi))
    kz = np.fft.rfftfreq(N, BOX / N / (2 * np.pi))
    k2 = k[:, None, None] ** 2 + k[None, :, None] ** 2 + kz[None, None] ** 2
    smooth = lambda x, r: np.fft.irfftn(np.fft.rfftn(x) * np.exp(
        -0.5 * k2 * r * r), (N, N, N), axes=(0, 1, 2))
    truth = smooth(rng.standard_normal((N,) * 3), 12.0)
    truth = (1.2 * truth / truth.std()).astype(np.float32)
    s = (0.9 * truth + 0.2 * smooth(rng.standard_normal((N,) * 3), 12.0)
         / 0.1).astype(np.float32)
    g = GridSpec.cube(N, BOX)
    with torch.no_grad():
        d_eul = lag2eul(torch.from_numpy(truth), g,
                        ForwardConfig(**BASE_FC), GP).numpy()
    noise = rng.standard_normal((N,) * 3).astype(np.float32)
    lam = np.clip(1.0 + d_eul, 0.0, None)
    nobs = {0: rng.poisson(lam).astype(np.float32),
            1: (lam + 0.4 * noise).astype(np.float32),
            2: (np.log(np.clip(1.0 + d_eul, 1e-3, None))
                + 0.3 * noise).astype(np.float32),
            3: (truth + 0.5 * noise).astype(np.float32)}
    sigma = {0: 1.0, 1: 0.4, 2: 0.3, 3: 0.5}
    power = np.full((N, N, N // 2 + 1), 30.0, np.float32)
    power[0, 0, 0] = 0.0
    window = (rng.uniform(size=(N,) * 3) > 0.1).astype(np.float32)
    return dict(s=s, nobs=nobs, sigma=sigma, power=power, window=window)


def case_arrays(name):
    """(model fields, forward fields, obs scalars, obs arrays) of a case;
    the clipping delta_min is the signal's own 20% quantile of delta_x."""
    mfields, ffields, scalars = CASES[name]
    f = fields()
    lik = mfields["likelihood"]
    arrays = dict(nobs=f["nobs"][lik], window=f["window"],
                  noise=np.full((N,) * 3, f["sigma"][lik], np.float32),
                  power=f["power"])
    if scalars == "clip":
        # the widest gap between two sorted delta_x values near the 20%
        # quantile: no cell lies within float32 noise of the clip's kink
        with torch.no_grad():
            dx = np.sort(lag2eul(torch.from_numpy(f["s"]),
                                 GridSpec.cube(N, BOX),
                                 ForwardConfig(**BASE_FC), GP).numpy(),
                         axis=None)
        i = int(0.2 * dx.size) - 50 + int(np.argmax(np.diff(
            dx[int(0.2 * dx.size) - 50:int(0.2 * dx.size) + 51])))
        scalars = dict(delta_min=float(0.5 * (dx[i] + dx[i + 1])))
    return mfields, {**BASE_FC, **ffields}, scalars, arrays


def port_model(mfields, ffields):
    return ModelConfig(forward=ForwardConfig(**ffields), **mfields)


@functools.lru_cache(maxsize=None)
def jax_dense(name):
    """The JAX package's dense psi and force (windowless deposit)."""
    mfields, ffields, scalars, a = case_arrays(name)
    jffields = {k: v for k, v in ffields.items()
                if not k.startswith("pallas")}
    jmc = jposterior.ModelConfig(forward=JFC(**jffields), **mfields)
    obs = JObs(**{k: jnp.asarray(v) for k, v in a.items()}, **scalars)
    vag = jposterior.make_psi_force(JGridSpec.cube(N, BOX), jmc, JGP(**GPD),
                                    obs)
    (psi, _), grad = vag(jnp.asarray(fields()["s"]))
    return float(psi), np.asarray(grad)


def test_the_cases_exercise_their_options():
    """The signal stays inside the slab halo at two ranks (so the sharded
    and dense deposits agree), the clipping delta_min clips, and the
    options move the dense psi or force beyond the tolerances."""
    s = torch.from_numpy(fields()["s"])
    for fc in (ForwardConfig(**BASE_FC), ForwardConfig(**{**BASE_FC,
                                                         "sfmodel": 3})):
        pos = displaced_positions(s, GridSpec.cube(N, BOX), fc, GP)
        assert int(sfw.slab_violations(pos, GridSpec.cube(N, BOX), HALO,
                                       2)) == 0
    psi1, grad1 = jax_dense("likelihood1")
    for name in ("obs_scalars", "grad_prior_factor", "grad_likeli_factor",
                 "correct_delta", "deltaQ_factor"):
        psi, grad = jax_dense(name)
        moved_psi = abs(psi - psi1) > 1e-3 * abs(psi1)
        moved_grad = np.abs(grad - grad1).max() > 1e-2 * np.abs(grad1).max()
        assert moved_psi or moved_grad, name
    psi2, _ = jax_dense("likelihood2")
    psi2c, _ = jax_dense("likelihood2_delta_min")
    assert abs(psi2c - psi2) > 1e-3 * abs(psi2)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_matches_the_dense_model_at_one_rank(name):
    psi_ref, grad_ref = jax_dense(name)
    mfields, ffields, scalars, a = case_arrays(name)
    layout = pd.make_layout(1, 1, device="cpu")
    g = GridSpec.cube(N, BOX)
    obs = sfw.shard_obs(ObsData(**{k: torch.from_numpy(v)
                                   for k, v in a.items()}, **scalars), layout)
    vg = sfw.make_sharded_psi_vg_chains(g, port_model(mfields, ffields), GP,
                                        layout, halo=HALO)
    (vals, _), grads = vg(torch.from_numpy(fields()["s"])[None], obs)
    assert_psi_grad(float(vals[0]), grads[0].numpy(), psi_ref, grad_ref)


TWO_RANK = ["likelihood3", "likelihood2_delta_min"]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    inp = {"N": np.int64(N), "L": np.float64(BOX), "halo": np.int64(HALO),
           "s": fields()["s"], "n_cases": np.int64(len(TWO_RANK))}
    for k, name in enumerate(TWO_RANK):
        mfields, ffields, scalars, a = case_arrays(name)
        inp.update({f"c{k}_{key}": v for key, v in a.items()})
        inp[f"c{k}_likelihood"] = np.int64(mfields["likelihood"])
        inp[f"c{k}_sfmodel"] = np.int64(ffields["sfmodel"])
        inp[f"c{k}_delta_min"] = np.float64(scalars.get("delta_min",
                                                        -0.999))
    inp.update({f"gp_{k}": np.float64(v) for k, v in GPD.items()})
    return torch_workers.launch("options_worker", 2, inp,
                                tmp_path_factory.mktemp("options2"))


@pytest.mark.parametrize("k", range(len(TWO_RANK)),
                         ids=lambda k: TWO_RANK[k])
def test_sharded_matches_the_dense_model_at_two_ranks(two_ranks, k):
    outs = two_ranks
    psi_ref, grad_ref = jax_dense(TWO_RANK[k])
    assert outs[0][f"c{k}_psi"] == outs[1][f"c{k}_psi"]  # same bits
    grad = np.concatenate([o[f"c{k}_grad"] for o in outs])
    assert_psi_grad(float(outs[0][f"c{k}_psi"][0]), grad, psi_ref, grad_ref)


@pytest.mark.parametrize("integrator", ["leapfrog", "minimal_norm_2"])
def test_sharded_attempt_matches_the_dense_attempt(integrator):
    """One attempt from the same state and momenta, dense sampler against
    sharded sampler at one rank.  minimal_norm_2 takes another trajectory
    than leapfrog: the sharded sampler honours hc.integrator."""
    mfields, ffields, scalars, a = case_arrays("likelihood1")
    g = GridSpec.cube(N, BOX)
    mc = port_model(mfields, ffields)
    hc = HMCConfig(eps_fac=0.001, eps_fac_update_type=0, mass_type=1,
                   N_eps_fac=3, N_a_eps_update=4, integrator=integrator)
    obs = ObsData(**{k: torch.from_numpy(v) for k, v in a.items()})
    mass = mass_mod.compute_mass(g, 1, obs.power)
    s0 = torch.from_numpy(fields()["s"])[None]
    dense = sampler.make_init(g, mc, GP, hc)(s0, obs, [5])
    randoms = sampler.draw_randoms(dense, g, hc, mass)
    out_d, stats_d = sampler.make_attempt(g, mc, GP, hc)(
        dense, obs, mass, randoms=randoms)

    layout = pd.make_layout(1, 1, device="cpu")
    obs_sh = sfw.shard_obs(obs, layout)
    mass_f = sfw.power_to_sharded_layout(mass.mass_f, layout)
    vg = sfw.make_sharded_psi_vg_chains(g, mc, GP, layout, halo=HALO)
    (vals, aux), grads = vg(s0, obs_sh)
    state = ss.init_chain_state(s0, vals, aux, grads, [1],
                                [hc.eps_fac_start(g.N)], hc)
    rnd = dataclasses.replace(randoms,
                              momenta=shard_real(randoms.momenta, layout))
    runs = {}
    for integ in ("leapfrog", "minimal_norm_2"):
        att = ss.make_sharded_attempt(
            g, mc, GP, dataclasses.replace(hc, integrator=integ), layout,
            halo=HALO)
        with torch.no_grad():
            runs[integ] = att(dict(state), obs_sh, mass_f, randoms=rnd)
    out_s, stats_s = runs[integrator]
    assert int(stats_s.Neps[0]) == int(stats_d.Neps[0]) > 1
    assert bool(stats_s.accepted[0]) == bool(stats_d.accepted[0])
    for key in ("psi_prior_f", "psi_likeli_f", "H_kin_f"):
        np.testing.assert_allclose(getattr(stats_s, key).numpy(),
                                   getattr(stats_d, key).numpy(),
                                   rtol=3e-5, err_msg=key)
    # the proposal, whether or not it was accepted
    other = runs["minimal_norm_2" if integrator == "leapfrog"
                 else "leapfrog"][1]
    gap = abs(float(stats_s.psi_likeli_f[0] - other.psi_likeli_f[0]))
    assert gap > 100 * 3e-5 * abs(float(stats_d.psi_likeli_f[0]))
    np.testing.assert_allclose(out_s["delta"].numpy(), out_d.delta.numpy(),
                               atol=1e-4 * float(out_d.delta.abs().max()))


# option -> (ForwardConfig fields, the words the message names)
REFUSED = {
    "masskernel0": (dict(masskernel=0), "masskernel = 0"),
    "masskernel1": (dict(masskernel=1), "masskernel = 1"),
    "masskernel3": (dict(masskernel=3), "masskernel = 3"),
    "radial_rsd": (dict(rsd=True, rsd_planepar=False), "planepar = false"),
    "rsd_not_periodic": (dict(rsd=True, periodic=False), "periodic = false"),
    "findif_2lpt": (dict(deriv_scheme="findif"), "deriv_scheme = findif"),
}


def _runner_conf(ffields, tmp):
    base = RunConfig(grid=GridSpec.cube(N, BOX), readPS=False, seed=3,
                     N_Gibbs=1, dir=str(tmp))
    fc = ForwardConfig(**{**BASE_FC, **ffields})
    hmc = dataclasses.replace(base.hmc, eps_fac=0.1, eps_fac_update_type=0,
                              mass_type=1, N_eps_fac=2, N_a_eps_update=4)
    return dataclasses.replace(base, hmc=hmc, model=dataclasses.replace(
        base.model, likelihood=1, forward=fc))


@pytest.mark.parametrize("option", list(REFUSED))
def test_refused_options_raise_before_any_work(option, tmp_path):
    ffields, words = REFUSED[option]
    mc = ModelConfig(likelihood=1,
                     forward=ForwardConfig(**{**BASE_FC, **ffields}))
    g = GridSpec.cube(N, BOX)
    layout = pd.make_layout(1, 1, device="cpu")
    hc = HMCConfig(mass_type=1)
    for make in (lambda: sfw.make_sharded_psi_vg_chains(g, mc, GP, layout),
                 lambda: sfw.make_sharded_psi(g, mc, GP, layout),
                 lambda: ss.make_sharded_sampler(g, mc, GP, hc, layout)):
        with pytest.raises(ValueError, match=words):
            make()
    out = tmp_path / "out"
    with pytest.raises(ValueError, match=words):
        ShardedRunner(_runner_conf(ffields, out), layout=layout, halo=HALO)
    assert not out.exists()


def test_harmless_twins_of_refused_options_are_accepted():
    """findif with Zel'dovich (no 2LPT source) and periodic = false without
    RSD (the box wraps the particles either way) compute the dense model."""
    for ffields in (dict(sfmodel=1, deriv_scheme="findif"),
                    dict(periodic=False)):
        sfw.check_sharded_options(ModelConfig(
            forward=ForwardConfig(**{**BASE_FC, **ffields})))


def test_cli_refuses_the_sph_mass_kernel_sharded(tmp_path):
    """`python -m barcode_tpu_torch input.par --sharded` with the
    reference's masskernel = 3 exits non-zero, naming the key, and writes
    nothing."""
    par = tmp_path / "input.par"
    par.write_text(f"Nx = {N}\nLx = {BOX}\nmasskernel = 3\nreadPS = false\n")
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "barcode_tpu_torch", str(par), "--sharded",
         "--device", "cpu", "--out", str(out)], cwd=torch_workers.REPO,
        capture_output=True, text=True, timeout=120,
        env={**torch_workers.os.environ, "PYTHONPATH": str(torch_workers.REPO),
             "OMP_NUM_THREADS": "1"})
    assert proc.returncode != 0
    assert "ValueError: masskernel = 3" in proc.stderr
    assert not out.exists()


@pytest.mark.parametrize("scale,warns", [(1.0, False), (8.0, True)],
                         ids=["inside_the_margin", "past_the_margin"])
def test_windowless_dumps_warn_past_the_exchange_margin(scale, warns,
                                                        tmp_path, capsys):
    """C4: the windowless slab deposit clamps base rows beyond the exchange
    margin into the edge rows.  The dump-time monitor counts the particles
    whose support leaves the margin (the truth's displacement bound + 4):
    none for the truth, many for the truth scaled 8 times."""
    conf = _runner_conf({"sfmodel": 1}, tmp_path)
    layout = pd.make_layout(1, 1, device="cpu")
    r = ShardedRunner(conf, layout=layout).setup()
    assert r.halo <= N // 2
    capsys.readouterr()
    r.state["delta"] = scale * shard_real(r.truth, layout)[None]
    r.dump_sample(1, spectrum=False)
    r.close()
    said = capsys.readouterr().out
    assert ("breach the slab exchange halo" in said) == warns, said
    pos = displaced_positions(scale * r.truth, r.g, conf.model.forward, r.gp)
    assert (int(sfw.slab_violations(pos, r.g, r.halo, 1)) > 0) == warns
