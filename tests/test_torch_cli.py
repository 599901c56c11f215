"""The port's command line on the CPU: the same options as the JAX
package's (plus --device), and 16^3 sessions run, resumed from their
checkpoints and restarted from their dumps (`--device cpu`), dense and
`--sharded` at one rank, as chip_smoke.py drives them at 256^3 on the card.
"""
import json
import re

import numpy as np
import pytest
import torch

from barcode_tpu import cli as jcli

from barcode_tpu_torch import cli
from barcode_tpu_torch import io as bio
from barcode_tpu_torch.config import RunConfig

INPUT_PAR = """
Nx = 16
Lx = 25.0
sfmodel = 3
masskernel = sph_ft
rsd_model = true
slength = 4.0
likelihood = 1
N_eps_fac = 1
eps_fac = 0.0001
eps_fac_update_type = 0
mass_type = 1
N_a_eps_update = 32
pallas_deposit = true
pallas_halo = 0
pallas_tail_k = 1024
readPS = false
seed = 5
"""


def option_strings(main, capsys):
    with pytest.raises(SystemExit):
        main(["--help"])
    return set(re.findall(r"(?<![\w-])--[a-z][a-z-]*", capsys.readouterr().out))


def test_options_match_the_jax_cli(capsys):
    """Every option of barcode_tpu/cli.py, plus --device."""
    jopts = option_strings(jcli.main, capsys)
    opts = option_strings(cli.main, capsys)
    assert "--resume" in jopts and "--multihost" in jopts
    assert opts == jopts | {"--device"}
    defaults = vars(cli.parse_args([]))
    assert defaults.pop("device") == "cuda"
    assert defaults == {
        "input_par": "input.par", "restart_iteration": None, "resume": False,
        "chains": None, "samples": None, "out": None, "dashboard": None,
        "rhat_stop": None, "nan_check": False, "profile": None,
        "sharded": False, "halo": None, "coordinator": None,
        "num_processes": None, "process_id": None, "multihost": False}


@pytest.mark.parametrize("argv", [
    ["--sharded"], ["--halo", "0"], ["--coordinator", "localhost:1234"],
    ["--num-processes", "2"], ["--process-id", "0"], ["--multihost"]])
def test_multi_device_options_raise(argv, tmp_path):
    """The multi-device options parse to their values as in the JAX CLI
    (they no longer raise NotImplementedError); a (chains, grid) layout the
    process group cannot hold raises ValueError before any work, as the JAX
    package's default_mesh does."""
    args = cli.parse_args([str(tmp_path / "input.par"), "--device", "cpu",
                           *argv])
    dest = argv[0][2:].replace("-", "_")
    value = getattr(args, dest)
    assert value is True if len(argv) == 1 else str(value) == argv[1]
    layout_only = [a for a in argv if argv[0] in ("--sharded", "--halo")]
    with pytest.raises(ValueError, match="not divisible by 3 chains"):
        cli.main([str(tmp_path / "input.par"), "--device", "cpu", "--sharded",
                  "--chains", "3", *layout_only])
    assert not any(tmp_path.iterdir())  # refused before any work


def test_coordinator_needs_the_process_count(tmp_path):
    with pytest.raises(ValueError, match="--num-processes and --process-id"):
        cli.main([str(tmp_path / "input.par"), "--device", "cpu",
                  "--coordinator", "localhost:1234"])
    assert not any(tmp_path.iterdir())


def test_sharded_two_chains_at_one_rank_raise_as_jax(tmp_path):
    """--sharded --chains 2 on a group of one rank: the JAX package's
    default_mesh message (sharded_runner.py:57-63)."""
    par = tmp_path / "input.par"
    par.write_text(INPUT_PAR)
    with pytest.raises(ValueError,
                       match=r"^1 devices not divisible by 2 chains$"):
        cli.main([str(par), "--device", "cpu", "--sharded", "--chains", "2"])


def test_masskernel_sph_ft_parses(tmp_path):
    path = tmp_path / "input.par"
    path.write_text(INPUT_PAR)
    assert RunConfig.from_input_par(path).model.forward.masskernel == "sph_ft"


def session_resume_and_restart(tmp_path, capsys, input_par):
    """A 16^3 session, a --resume with --profile, and a restart from
    deltaLAG_2 + the performance log once the checkpoint is gone."""
    par = tmp_path / "input.par"
    par.write_text(input_par)
    out = tmp_path / "run"
    common = [str(par), "--device", "cpu", "--chains", "2", "--no-dashboard",
              "--out", str(out)]

    assert cli.main(common + ["--samples", "1", "--nan-check"]) == 0
    diag = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert diag["attempts"] == 32 and len(diag["accepted_per_chain"]) == 2
    ck1 = dict(np.load(out / "checkpoint.npz"))
    dumps1 = {p.name: p.stat().st_mtime_ns for p in out.glob("deltaLAG_*")}
    assert set(dumps1) == {"deltaLAG_1.dat"}
    assert (out / "restart.prt").read_text().strip() == \
        str(ck1["state_accepted"].min())

    # --resume continues the chains: no sample dumped twice
    assert cli.main(common + ["--resume", "--samples", "2", "--profile",
                              str(tmp_path / "prof")]) == 0
    ck2 = dict(np.load(out / "checkpoint.npz"))
    assert (ck2["state_count_attempts"] == ck1["state_count_attempts"] + 16).all()
    assert (ck2["state_accepted"] >= ck1["state_accepted"]).all()
    assert {p.name: p.stat().st_mtime_ns for p in out.glob("deltaLAG_*")} \
        .items() >= dumps1.items()
    assert (out / "deltaLAG_2.dat").exists()
    with open(tmp_path / "prof" / "trace.json") as f:
        assert "traceEvents" in json.load(f)  # a Chrome trace

    # restart from deltaLAG_2 + the performance log once the checkpoint is gone
    (out / "checkpoint.npz").unlink()
    args = cli.parse_args([str(par), "2"] + common[1:] + ["--samples", "3"])
    runner = cli.open_session(args)
    lag2 = bio.read_array(out / "deltaLAG_2", runner.g.shape)
    assert torch.equal(runner.states.delta[0], torch.from_numpy(lag2))
    assert runner.states.accepted.tolist() == [2, 2]
    assert cli.run_session(runner, args) == 0
    ck3 = np.load(out / "checkpoint.npz")
    assert np.isfinite(ck3["state_psi"]).all()
    assert (ck3["state_accepted"] >= 3).all() and (out / "deltaLAG_3.dat").exists()


def test_session_resume_and_restart_on_cpu(tmp_path, capsys):
    session_resume_and_restart(tmp_path, capsys, INPUT_PAR)


# the reference's own input.par (data/input.par: Zel'dovich, SPH mass
# kernel, Gaussian likelihood) at 16^3; and the headline model with radial
# RSD about a box corner (observer - origin = 0), the kernel deposit with
# the tail split on positions that leave the box
OPTION_PARS = {
    "sph": INPUT_PAR.replace("sfmodel = 3", "sfmodel = 1").replace(
        "masskernel = sph_ft", "masskernel = 3"),
    "radial": INPUT_PAR + "planepar = false\nxobs = 100.0\nyobs = 100.0\n"
              "zobs = 100.0\nxllc = 100.0\nyllc = 100.0\nzllc = 100.0\n",
}


@pytest.mark.parametrize("option", sorted(OPTION_PARS))
def test_option_sessions_resume_and_restart_on_cpu(tmp_path, capsys, option):
    conf = RunConfig.from_input_par(_write(tmp_path, OPTION_PARS[option]))
    fc = conf.model.forward
    assert (fc.masskernel, fc.rsd_planepar) == \
        ((3, True) if option == "sph" else ("sph_ft", False))
    session_resume_and_restart(tmp_path, capsys, OPTION_PARS[option])


def _write(tmp_path, text):
    path = tmp_path / "probe.par"
    path.write_text(text)
    return path


def test_sharded_session_resume_and_restart_on_cpu(tmp_path, capsys):
    """`--sharded` at one rank (a gloo group of one): a session, a resume
    from checkpoint_sharded.npz, and a restart from deltaLAG_2 + the
    performance log once the checkpoint is gone (JAX cli.py:83-108)."""
    par = tmp_path / "input.par"
    par.write_text(INPUT_PAR)
    out = tmp_path / "run"
    common = [str(par), "--device", "cpu", "--sharded", "--no-dashboard",
              "--out", str(out)]

    assert cli.main(common + ["--samples", "1", "--nan-check"]) == 0
    diag = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert diag["attempts"] == 16 and len(diag["accepted_per_chain"]) == 1
    ck1 = dict(np.load(out / "checkpoint_sharded.npz"))
    assert set(ck1) >= {"state_delta", "state_seed", "state_eps_table"}
    assert (out / "deltaLAG_1.dat").exists()
    assert (out / "performance_log.txt").read_text().count("\n") == 17

    assert cli.main(common + ["--resume", "--samples", "2"]) == 0
    ck2 = dict(np.load(out / "checkpoint_sharded.npz"))
    assert (ck2["state_count_attempts"] == ck1["state_count_attempts"] + 16).all()
    assert (out / "deltaLAG_2.dat").exists()

    (out / "checkpoint_sharded.npz").unlink()
    args = cli.parse_args([str(par), "2"] + common[1:] + ["--samples", "3"])
    runner = cli.open_session(args)
    lag2 = bio.read_array(out / "deltaLAG_2", runner.g.shape)
    assert torch.equal(runner.state["delta"][0], torch.from_numpy(lag2))
    assert runner.state["accepted"].tolist() == [2]
    assert cli.run_session(runner, args) == 0
    ck3 = np.load(out / "checkpoint_sharded.npz")
    assert np.isfinite(ck3["state_psi"]).all()
    assert (ck3["state_accepted"] >= 3).all() and (out / "deltaLAG_3.dat").exists()
