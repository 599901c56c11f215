"""The port's session layer on the CPU: Runner end to end, dumps in the
reference format, config parsing, the state converters and mock data.

The Runner draws from a torch.Generator, so its runs are not compared value
by value with the JAX runner's; what is compared is the format (the JAX
package's own reader reads every dump) and the configuration parsing.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from barcode_tpu import io as jio
from barcode_tpu.config import RunConfig as JRunConfig
from barcode_tpu.hmc import mass as jmass
from barcode_tpu.hmc.state import ChainState as JChainState
from barcode_tpu.model.likelihoods import ObsData as JObsData

from barcode_tpu_torch import convert, mock as mock_mod
from barcode_tpu_torch.config import HMCConfig, MockConfig, RunConfig
from barcode_tpu_torch.forward import tsc_kernels as tk
from barcode_tpu_torch.forward.lag2eul import ForwardConfig, GrowthParams
from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.model.posterior import ModelConfig
from barcode_tpu_torch.runner import Runner


def headline_conf(n, out, **hmc):
    """The bench.py headline model on an n^3 grid at the headline cell size."""
    g = GridSpec.cube(n, 200.0 * n / 128)
    fc = ForwardConfig(sfmodel=3, masskernel="sph_ft", rsd=True, slength=4.0,
                       pallas_deposit=True, pallas_halo=0, pallas_tail_k=1024)
    hc = HMCConfig(**{**dict(eps_fac=1e-3, eps_fac_update_type=0,
                             N_eps_fac=4, N_a_eps_update=8), **hmc})
    return RunConfig(grid=g, model=ModelConfig(likelihood=1, forward=fc),
                     hmc=hc, readPS=False, N_Gibbs=3, outnum=1,
                     dir=str(out), seed=3)


@pytest.mark.parametrize("n", [8, 16])
def test_runner_end_to_end_on_cpu(tmp_path, n, monkeypatch):
    conf = headline_conf(n, tmp_path)
    n_dep = tk.tsc_deposit_window.launches
    deposit_calls = []
    kernel_deposit = tk.tsc_deposit_window
    monkeypatch.setattr(tk, "tsc_deposit_window", lambda *a, **k: (
        deposit_calls.append(1), kernel_deposit(*a, **k))[1])
    r = Runner(conf, device="cpu")
    r.attempt_batch = 4
    r.setup(n_chains=2)
    assert r.conf.model.forward.pallas_halo > 0  # resolved from the truth
    for f in ["deltaLAGtest", "deltaEULtest", "win", "nobs", "sigma",
              "initial_guess", "powerero"]:
        arr = jio.read_array(tmp_path / f, conf.grid.shape)  # JAX reader
        assert arr.shape == conf.grid.shape and np.isfinite(arr).all()
    states = r.run(n_samples=3, max_attempts=64, log=True, nan_check=True)
    r.close()
    assert int(states.accepted.min()) >= 3
    assert torch.isfinite(states.psi).all()
    for i in (1, 2, 3):
        for f in (f"deltaLAG_{i}", f"deltaEUL_{i}", f"deltaRSS_{i}"):
            assert jio.read_array(tmp_path / f, conf.grid.shape).shape == \
                conf.grid.shape
        k_p = np.loadtxt(tmp_path / f"powSpecit{i}.dat")
        assert k_p.shape[1] == 2
    np.testing.assert_array_equal(
        jio.read_array(tmp_path / "deltaLAG_3", conf.grid.shape),
        r.states.delta[0].numpy())
    log = (tmp_path / "performance_log.txt").read_text().splitlines()
    assert log[0].startswith("#") and len(log) == 1 + r.metrics.attempts // 2
    assert (tmp_path / "convergence.prt").exists()
    # the sampler's forward model runs the windowed deposit (K1's wrapper)
    # once at init, once per masked leapfrog step, and the deltaEUL/deltaRSS
    # dumps of samples 1..3 run it too, as the JAX runner's dumps do
    steps = int(states.count_attempts[0]) * conf.hmc.N_eps_fac
    assert len(deposit_calls) == 1 + steps + 2 * 3
    # on the CPU the wrappers take their plain versions: nothing launched
    assert kernel_deposit.launches == n_dep


def test_runner_fastexit_and_type3_controller(tmp_path):
    """The default controller (type 3, eps_fac from 2.0) halves eps_fac on
    rejections; a fastexit sentinel stops the loop before any attempt."""
    conf = headline_conf(8, tmp_path, eps_fac=0.0, eps_fac_update_type=3)
    r = Runner(conf, device="cpu")
    r.attempt_batch = 2
    r.setup(n_chains=2)
    r.run(n_samples=100, max_attempts=4, log=False)
    eps = r.states.eps_fac.numpy()
    assert (eps <= 2.0).all() and r.metrics.attempts == 8
    (tmp_path / "fastexit").write_text("")
    r.run(n_samples=100, max_attempts=4, log=False)
    assert r.metrics.attempts == 8
    r.close()


INPUT_PAR = """
Nx = 16
Lx = 25.0
sfmodel = 3
masskernel = 2
rsd_model = true
slength = 4.0
pallas_deposit = true
pallas_halo = 0
pallas_tail_k = 1024
pallas_block_dep_x = 16
likelihood = 1
N_eps_fac = 8
eps_fac = 0.0001
eps_fac_update_type = 0
mass_type = 1
N_a_eps_update = 32
readPS = false
seed = 5  # a comment
dir = ./out/
"""


def test_input_par_parses_like_the_jax_package(tmp_path):
    path = tmp_path / "input.par"
    path.write_text(INPUT_PAR)
    jconf, conf = JRunConfig.from_input_par(path), RunConfig.from_input_par(path)
    jd, d = dataclasses.asdict(jconf), dataclasses.asdict(conf)
    jfwd = jd["model"].pop("forward")
    fwd = d["model"].pop("forward")
    assert {k: v for k, v in jfwd.items() if k in fwd} == fwd
    assert jd == d
    assert conf.model.forward.pallas_block_dep == (16, 16)
    assert conf.growth() == GrowthParams(**dataclasses.asdict(jconf.growth()))
    path.write_text(INPUT_PAR + "pallas_bf16_grad = true\n")
    with pytest.raises(NotImplementedError):
        RunConfig.from_input_par(path)


def test_convert_carries_jax_state_across():
    rng = np.random.default_rng(0)
    shape, C = (8, 8, 8), 2
    P = rng.uniform(1, 2, (8, 8, 5)).astype(np.float32)
    jobs = JObsData(nobs=jnp.asarray(rng.normal(size=shape), jnp.float32),
                    window=jnp.ones(shape), noise=jnp.full(shape, 0.5),
                    power=jnp.asarray(P), rho_c=2.0)
    obs = convert.obs_data({f.name: getattr(jobs, f.name)
                            for f in dataclasses.fields(jobs)}, device="cpu")
    np.testing.assert_array_equal(obs.nobs.numpy(), np.asarray(jobs.nobs))
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            convert.obs_data({"nobs": jobs.nobs})
    assert obs.rho_c == 2.0 and obs.delta_min == jobs.delta_min
    jm = jmass.compute_mass(jio_grid(), 1, jnp.asarray(P))
    m = convert.mass_state({"mass_f": jm.mass_f, "mass_r": jm.mass_r},
                           device="cpu")
    np.testing.assert_array_equal(m.mass_f.numpy(), np.asarray(jm.mass_f))
    assert m.mass_r == 0.0
    fields = {f.name: np.zeros((C,) + ((4,) if f.name in ("acc_flags",
                                                         "eps_table") else ()))
              for f in dataclasses.fields(JChainState)}
    fields["delta"] = rng.normal(size=(C,) + shape).astype(np.float32)
    st = convert.chain_state(fields, device="cpu")
    assert st.delta.shape == (C,) + shape and st.acc_flags.shape == (C, 4)
    fc = convert.forward_config(dict(dataclasses.asdict(
        ForwardConfig(pallas_halo=5)), pallas_bf16_grad=False))
    assert fc.pallas_halo == 5
    with pytest.raises(ValueError):
        convert.forward_config({"pallas_bf16_dep": True})


def jio_grid():
    from barcode_tpu.grid.spec import GridSpec as JGridSpec
    return JGridSpec.cube(8, 8.0)


@pytest.mark.parametrize("likelihood,data_model,window", [
    (0, 0, 1), (1, 0, 10), (3, 0, 1), (1, 1, 23)])
def test_mock_generation(likelihood, data_model, window):
    g = GridSpec.cube(16, 25.0)
    P = torch.full(g.rshape, 40.0)
    P[0, 0, 0] = 0.0
    mock = MockConfig(window_type=window, data_model=data_model,
                      sigma_min=0.5, sigma_fac=0.1)
    gen = torch.Generator().manual_seed(1)
    gp = GrowthParams(D1=1.0, D2=-3.0 / 7.0, ascale=1.0, cpecvel=52.85,
                      hubble=100.0)
    md = mock_mod.generate(gen, g, mock, ForwardConfig(sfmodel=1, masskernel=2),
                           gp, P, likelihood)
    for t in (md.truth_lag, md.truth_eul, md.obs.nobs, md.obs.noise):
        assert t.shape == g.shape and torch.isfinite(t).all()
    assert (md.obs.nobs[md.obs.window == 0] == 0).all()
    if likelihood == 0:
        assert (md.obs.nobs >= 0).all()
        assert torch.equal(md.obs.nobs, md.obs.nobs.round())
    if likelihood in (1, 3) and data_model == 0:
        mock_mod.validate(md, likelihood)
