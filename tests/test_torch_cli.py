"""The port's command line on the CPU: the same options as the JAX
package's (plus --device), the multi-device options refused, and a 16^3
session run, resumed from its checkpoint and restarted from its dumps
(`--device cpu`), as chip_smoke.py drives it at 256^3 on the card.
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
    with pytest.raises(NotImplementedError, match="ROADMAP A.4"):
        cli.main([str(tmp_path / "input.par"), "--device", "cpu", *argv])
    assert not any(tmp_path.iterdir())  # refused before any work


def test_masskernel_sph_ft_parses(tmp_path):
    path = tmp_path / "input.par"
    path.write_text(INPUT_PAR)
    assert RunConfig.from_input_par(path).model.forward.masskernel == "sph_ft"


def test_session_resume_and_restart_on_cpu(tmp_path, capsys):
    par = tmp_path / "input.par"
    par.write_text(INPUT_PAR)
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
        assert '"traceEvents"' in f.read(4096)  # a Chrome trace

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
