"""The port's session features on the CPU: checkpoint/resume, the
reference's file-based restart (deltaLAG_<k> + performance-log replay) from
a directory the JAX Runner wrote, diagnostics and the dashboard.

Tolerances: resumed sampling is compared bit for bit (same generator state,
same arithmetic); psi after a restart from the JAX package's dumps within
1e-5 relative (float32 forward models in another order).
"""
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from barcode_tpu.config import (HMCConfig as JHMCConfig,
                                MockConfig as JMockConfig,
                                RunConfig as JRunConfig)
from barcode_tpu.forward.lag2eul import ForwardConfig as JForwardConfig
from barcode_tpu.grid.spec import GridSpec as JGridSpec
from barcode_tpu.hmc.state import AttemptStats as JAttemptStats
from barcode_tpu.model.posterior import ModelConfig as JModelConfig
from barcode_tpu import runner as jrunner
from barcode_tpu.utils.dashboard import Dashboard as JDashboard

from barcode_tpu_torch.config import HMCConfig, MockConfig, RunConfig
from barcode_tpu_torch.forward.lag2eul import ForwardConfig
from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.hmc.state import AttemptStats
from barcode_tpu_torch.model.posterior import ModelConfig
from barcode_tpu_torch import runner as trunner
from barcode_tpu_torch.runner import Runner
from barcode_tpu_torch.utils.dashboard import Dashboard


def small_conf(tmp_path, random_test=True, mass_type=1, seed=7):
    """tests/test_runner.py's small configuration, in the port's types."""
    return RunConfig(
        grid=GridSpec.cube(8, 8.0),
        model=ModelConfig(likelihood=1,
                          forward=ForwardConfig(sfmodel=1, masskernel="tsc")),
        hmc=HMCConfig(eps_fac=0.3, eps_fac_update_type=3, mass_type=mass_type,
                      N_a_eps_update=16, N_eps_fac=4),
        mock=MockConfig(random_test=random_test, sigma_min=0.5),
        n_chains=2, N_Gibbs=3, outnum=1, dir=str(tmp_path), seed=seed)


def jax_conf(conf: RunConfig) -> JRunConfig:
    """The same configuration in the JAX package's types."""
    fwd = JForwardConfig(**dataclasses.asdict(conf.model.forward))
    return JRunConfig(
        grid=JGridSpec.cube(conf.grid.N1, conf.grid.L1),
        model=JModelConfig(**{**dataclasses.asdict(conf.model),
                              "forward": fwd}),
        hmc=JHMCConfig(**dataclasses.asdict(conf.hmc)),
        mock=JMockConfig(**dataclasses.asdict(conf.mock)),
        **{f.name: getattr(conf, f.name) for f in dataclasses.fields(conf)
           if f.name not in ("grid", "model", "hmc", "mock")})


def test_checkpoint_roundtrip_resumes_bit_for_bit(tmp_path):
    """tests/test_runner.py:49-66 for the port: every ChainState field, the
    generator state, the dump cursor and the mass marker come back, and
    sampling after restore gives the same delta bit for bit."""
    conf = small_conf(tmp_path)
    r = Runner(conf, device="cpu")
    r.attempt_batch = 4
    r.setup()
    r.run(n_samples=1, max_attempts=8, log=False)
    path = r.checkpoint()
    meta = json.loads(path.with_suffix(".json").read_text())
    assert meta["dump_cursor"] == r._dump_cursor >= 1
    assert meta["device_type"] == "cpu"
    assert (tmp_path / "restart.prt").read_text().strip() == \
        str(int(r.states.accepted.min()))

    r2 = Runner(conf, out_dir=str(tmp_path / "second"), device="cpu")
    r2.attempt_batch = 4
    r2.setup()
    r2.restore(path)
    for f in dataclasses.fields(r.states):
        a, b = getattr(r.states, f.name), getattr(r2.states, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name
    assert r2._dump_cursor == r._dump_cursor
    s1, _ = r._run(r.states, r.obs, r.mass, r.generator)
    s2, _ = r2._run(r2.states, r2.obs, r2.mass, r2.generator)
    assert torch.equal(s1.delta, s2.delta)
    assert torch.equal(s1.accepted, s2.accepted)
    r.close()
    r2.close()

    meta["device_type"] = "cuda"
    path.with_suffix(".json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="written on cuda"):
        r2.restore(path)


@pytest.fixture(scope="module")
def jax_run_dir(tmp_path_factory):
    """A directory dumped by the JAX Runner: mock data, two samples and a
    performance log; and its diagnostics."""
    d = tmp_path_factory.mktemp("jax_run")
    jr = jrunner.Runner(jax_conf(small_conf(d))).setup()
    jr.attempt_batch = 4
    jr.run(n_samples=2, max_attempts=64, log=True)
    while len(jr._psi_trace) < 4:  # enough batches for the R-hat/ESS keys
        jr.run(n_samples=2, max_attempts=4, log=True)
    jr._perflog.close()
    return d, jr.diagnostics()


def test_restart_from_jax_dumps(jax_run_dir, tmp_path):
    """restore_from_dumps + replay_perflog on the JAX Runner's files: the
    replayed tables equal the JAX package's, chain 0 resumes deltaLAG_2 bit
    for bit, and psi there agrees with the JAX restart's."""
    d, _ = jax_run_dir
    conf = small_conf(d, random_test=False)
    jconf = jax_conf(conf)
    ref = jrunner.replay_perflog(d, jconf.hmc, jconf.grid.N)
    rep = trunner.replay_perflog(d, conf.hmc, conf.grid.N)
    assert ref is not None and set(rep) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(rep[k]), np.asarray(ref[k]),
                                      err_msg=k)
    assert trunner.replay_perflog(tmp_path, conf.hmc, conf.grid.N) is None

    jr = jrunner.Runner(jconf).setup()
    jr.restore_from_dumps(2)
    r = Runner(conf, device="cpu").setup()
    r.restore_from_dumps(2)
    lag2 = np.fromfile(d / "deltaLAG_2.dat", np.float32).reshape(conf.grid.shape)
    np.testing.assert_array_equal(r.states.delta[0].numpy(), lag2)
    assert r._dump_cursor == 2 and r.states.accepted.tolist() == [2, 2]
    np.testing.assert_allclose(r.states.psi[0].item(), float(jr.states.psi[0]),
                               rtol=1e-5)
    for name in ("eps_fac", "acc_flags", "eps_table", "count_attempts",
                 "rejections", "got_first_accept"):
        np.testing.assert_array_equal(getattr(r.states, name).numpy(),
                                      np.asarray(getattr(jr.states, name)),
                                      err_msg=name)
    # sampling continues from there and dumps sample 3 only
    r.attempt_batch = 4
    r.run(n_samples=3, max_attempts=64, log=True)
    r.close()
    assert r._dump_cursor == 3 and (d / "deltaLAG_3.dat").exists()


def test_diagnostics_keys_match_the_jax_runner(jax_run_dir, tmp_path):
    _, jdiag = jax_run_dir
    r = Runner(small_conf(tmp_path), device="cpu")
    r.attempt_batch = 4
    r.setup()
    r.run(n_samples=10**6, max_attempts=16, log=False)
    diag = r.diagnostics()
    r.close()
    assert set(diag) == set(jdiag)
    assert len(r._trace_t) == len(r._psi_trace) == 4
    assert diag["ess_psi_per_s"] > 0 and isinstance(diag["rhat_psi"], float)
    json.dumps(diag, default=float)


def test_dashboard_renders_like_the_jax_package():
    """tests/test_aux.py:152 for the port's copy: the same stats render to
    the same text, with the chain state held in tensors."""
    n_att, n_ch = 3, 2
    arr = lambda v: np.full((n_att, n_ch), v, np.float32)
    fields = dict(
        accepted=arr(1).astype(bool), epsilon=arr(0.1),
        Neps=arr(4).astype(np.int32), dH=arr(0.2), dK=arr(0.1), dE=arr(0.1),
        psi_prior_i=arr(0), psi_prior_f=arr(0), psi_likeli_i=arr(0),
        psi_likeli_f=arr(0), H_kin_i=arr(0), H_kin_f=arr(0),
        eps_fac=arr(0.5), acc_rate_recent=arr(0.6))

    class States:
        eps_fac = np.full(n_ch, 0.5)
        accepted = np.array([3, 4])

    class TorchStates:
        eps_fac = torch.full((n_ch,), 0.5)
        accepted = torch.tensor([3, 4])

    summary = {"attempts": 3, "accepted": 3, "acc_rate": 1.0,
               "leapfrog_steps_per_s": 12.0, "elapsed_s": 1.0}
    out = []
    for dash_cls, stats, states in (
            (JDashboard, JAttemptStats(**fields), States()),
            (Dashboard, AttemptStats(**fields), TorchStates())):
        buf = io.StringIO()
        dash = dash_cls(title="t", stream=buf, force=True)
        dash.update(stats, states, summary)
        dash.update(stats, states, summary)  # the second draw rewinds
        out.append(buf.getvalue())
    assert out[0] == out[1]
    assert "\x1b[" in out[1] and "eps_fac=5.000e-01" in out[1]
    assert not Dashboard(stream=io.StringIO()).enabled  # inert off a TTY
