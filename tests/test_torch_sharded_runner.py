"""The port's ShardedRunner and sharded sampler at 16^3 on a 2 x 2 (chains,
grid) layout of gloo processes (CPU): a session end to end, a checkpoint
round trip, the restart from the dumps, the mass-recompute cadence and the
momenta's kinetic expectation — the twins of tests/test_sharded_runner.py
and tests/test_sharded_sampler.py.  The port's draws come from generators
seeded per (chain, attempt, grid rank), so the sampler is held to the JAX
package's statistics, not its bits; the perflog format and the replayed
controller state are held to the JAX package's own functions.
"""
import numpy as np
import pytest

from barcode_tpu.config import HMCConfig as JHMCConfig
from barcode_tpu.runner import PERFLOG_COLUMNS as JPERFLOG_COLUMNS
from barcode_tpu.runner import replay_perflog as jreplay

import torch_workers

N_CHAINS, KINETIC_ATTEMPTS = 2, 4


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_runner")
    inp = {"rows": np.int64(N_CHAINS), "n_chains": np.int64(N_CHAINS),
           "kinetic_attempts": np.int64(KINETIC_ATTEMPTS)}
    outs = torch_workers.launch("runner_worker", 4, inp, tmp, timeout=120.0)
    return tmp, outs


def test_sharded_runner_end_to_end(session):
    tmp, outs = session
    o = outs[0]
    assert o["e2e_accepted"].min() >= 1, o["e2e_accepted"]
    assert int(o["e2e_diag_chains"]) == N_CHAINS
    run = tmp / "run"
    for name in ("deltaLAGtest.dat", "deltaLAG_1.dat", "deltaEUL_1.dat",
                 "powSpecit1.dat", "convergence.prt"):
        assert (run / name).exists(), name
    log = (run / "performance_log.txt").read_text().splitlines()
    assert log[0] == "# " + "\t".join(JPERFLOG_COLUMNS)
    assert all(len(r.split("\t")) == len(JPERFLOG_COLUMNS) for r in log[1:])
    # every rank's cached psi equals a fresh evaluation of its chains
    for o in outs:
        np.testing.assert_allclose(o["e2e_psi"], o["e2e_psi_fresh"],
                                   rtol=2e-4)
        assert o["e2e_count"][0] > 0


def test_sharded_runner_checkpoint_roundtrip(session):
    _, outs = session
    for o in outs:
        assert int(o["ckpt_equal"]) == 1
        assert o["ckpt_accepted"].min() >= 2


def test_sharded_restore_from_dumps(session):
    tmp, outs = session
    run = tmp / "run"
    dumped = np.fromfile(run / "deltaLAG_2.dat", np.float32)
    o = outs[0]
    np.testing.assert_array_equal(o["rfd_delta0"].reshape(-1), dumped)
    assert (o["rfd_accepted"] == 2).all()
    # the controller state is the JAX package's replay of the same log
    rep = jreplay(run, JHMCConfig(eps_fac=0.3, eps_fac_update_type=2,
                                  mass_type=1, N_a_eps_update=8), 16 ** 3)
    for o in outs:
        assert (o["rfd_count"] == rep["count_attempts"]).all()
        np.testing.assert_allclose(o["rfd_eps"], rep["eps_fac"], rtol=1e-6)
        np.testing.assert_allclose(o["rfd_psi"], o["rfd_psi_fresh"],
                                   rtol=2e-4)
    assert outs[0]["rfd_after"].min() >= 3
    assert (run / "deltaLAG_3.dat").exists()


def test_sharded_mass_recompute_cadence(session):
    _, outs = session
    for o in outs:
        assert int(o["mass_at_sample"]) >= 1
        assert int(o["mass_changed"]) == 1


def test_sharded_momenta_kinetic_expectation(session):
    """E[1/2 p M^-1 p] = (N - 1)/2 for p ~ N(0, M) drawn slab-locally and
    coloured through the sharded FFT (the k = 0 mode has no mass): the mean
    over chains and attempts within 4 standard errors of a chi^2_{N-1}/2;
    eps ~ 0, so every attempt accepts with dH ~ 0
    (tests/test_sharded_sampler.py:72)."""
    _, outs = session
    n = 16 ** 3 - 1
    for o in outs:
        assert np.isfinite(o["kin_dh"]).all() and (np.abs(o["kin_dh"]) < 1).all()
        assert o["kin_acc"].all()
    # the two grid ranks of a chain (ranks 2r, 2r + 1) hold the same
    # all-reduced H_kin
    for r in range(N_CHAINS):
        np.testing.assert_array_equal(outs[2 * r]["kin"], outs[2 * r + 1]["kin"])
    kin = np.concatenate([o["kin"].ravel() for o in outs[::2]])
    assert len(kin) == N_CHAINS * KINETIC_ATTEMPTS
    se = np.sqrt(n / 2.0) / np.sqrt(len(kin))
    assert abs(kin.mean() - n / 2.0) < 4 * se, (kin.mean(), n / 2.0)
    assert len(set(np.round(kin, 3))) == len(kin)  # fresh draws each time


def test_convert_carries_a_jax_sharded_state():
    """convert.sharded_chain_state gives each rank of a 2 x 2 layout its
    chains and slabs of a JAX sharded chain state (keys dropped, seeds
    given), and convert.sharded_obs its slabs of the observations."""
    import jax
    import jax.numpy as jnp

    from barcode_tpu.parallel import sharded_sampler as jss
    from barcode_tpu_torch import convert

    rng = np.random.default_rng(0)
    delta = jnp.asarray(rng.standard_normal((2, 8, 8, 8)), jnp.float32)
    st = jss.init_chain_state(delta, jnp.ones(2), (jnp.ones(2), jnp.zeros(2)),
                              2.0 * delta, jnp.arange(2, dtype=jnp.uint32),
                              jnp.full(2, 0.5, jnp.float32),
                              JHMCConfig(N_a_eps_update=8))
    full = {k: np.asarray(v) for k, v in st.items()}
    for row in range(2):
        for col in range(2):
            out = convert.sharded_chain_state(full, 2, col, range(row, row + 1),
                                              [7 + row], device="cpu")
            assert "key_data" not in out and out["seed"].tolist() == [7 + row]
            np.testing.assert_array_equal(
                out["delta"].numpy(), full["delta"][row:row + 1,
                                                    4 * col:4 * col + 4])
            np.testing.assert_array_equal(out["eps_table"].numpy(),
                                          full["eps_table"][row:row + 1])
    power = rng.standard_normal((8, 8, 5)).astype(np.float32)
    obs = convert.sharded_obs({"nobs": full["delta"][0], "power": power,
                               "window": full["delta"][1],
                               "noise": full["grad"][0], "rho_c": 2.0},
                              2, 1, device="cpu")
    np.testing.assert_array_equal(obs.power.numpy(), power[:, 4:])
    np.testing.assert_array_equal(obs.nobs.numpy(), full["delta"][0][4:])
    assert obs.rho_c == 2.0


def test_layouts_of_one_rank():
    """At one rank: pod_chain_mesh and default_mesh give a 1 x 1 layout,
    local_chain_count keeps every chain here, and a grid axis or chain
    count the group cannot hold raises (sharded_runner.py:57-63)."""
    from barcode_tpu_torch.parallel import distributed as pd

    lay = pd.pod_chain_mesh(device="cpu")
    assert (lay.rows, lay.n_grid, lay.row, lay.col) == (1, 1, 0, 0)
    assert pd.default_mesh(1, device="cpu").shape == {"chains": 1, "grid": 1}
    assert list(pd.make_layout(1, 1, 3, device="cpu").chain_ids) == [0, 1, 2]
    assert pd.local_chain_count(4) == 4
    with pytest.raises(ValueError):
        pd.pod_chain_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="1 devices not divisible by 2"):
        pd.default_mesh(2, device="cpu")
