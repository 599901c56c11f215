"""Per-chain counter-based randomness (`barcode_tpu_torch.hmc.randoms`) on
the CPU: the sharded sampler's draws are those it made before they moved
into the shared module, a chain draws the same whether it runs alone or in
a batch, the dense and the one-rank sharded sampler draw the same, a dense
session and a one-rank `--sharded` session of one chain from the same
input.par take the same accept decisions, the dense checkpoint holds no
generator state, and a resume whose setup observed other data (a mock drawn
on the other device type) is refused before it writes any dump again.

Tolerances: uniforms, white noise, Neps, epsilon and accept flags exactly;
momenta (one float32 FFT pair, dense against the sharded transposes)
within 1e-5 * max|p|; H_kin within 1e-5 relative; over a session psi
within 3e-5 relative and the dumped deltaLAG_<i> within 1e-4 * max, the
sharded tolerances of tests/test_torch_sharded_options.py.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from barcode_tpu_torch import cli, io as bio
from barcode_tpu_torch import mock as mock_mod
from barcode_tpu_torch.config import HMCConfig
from barcode_tpu_torch.forward.lag2eul import ForwardConfig, GrowthParams
from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.hmc import mass as mass_mod
from barcode_tpu_torch.hmc import randoms as rnd
from barcode_tpu_torch.hmc import sampler
from barcode_tpu_torch.hmc.state import ChainState, MassState
from barcode_tpu_torch.model.likelihoods import ObsData
from barcode_tpu_torch.model.posterior import ModelConfig
from barcode_tpu_torch.parallel import distributed as pd
from barcode_tpu_torch.parallel import sharded_forward as sfw
from barcode_tpu_torch.parallel import sharded_sampler as ss
from barcode_tpu_torch.runner import Runner

from test_torch_session import small_conf

GP = GrowthParams(D1=1.0, D2=-3.0 / 7.0, ascale=1.0, cpecvel=52.85,
                  hubble=100.0)
G8 = GridSpec.cube(8, 8.0)


def chains(seeds, counts, g=G8):
    """A ChainState with only what `draw_randoms` reads: the seeds, the
    attempt counts and a delta on the CPU."""
    st = {f.name: None for f in dataclasses.fields(ChainState)}
    st.update(seed=torch.tensor(seeds, dtype=torch.int64),
              count_attempts=torch.tensor(counts, dtype=torch.int32),
              delta=torch.zeros((len(seeds),) + g.shape))
    return ChainState(**st)


def problem(g=G8, seed=0):
    """A small Zel'dovich/TSC model, its observations and the type-1 mass."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    P = np.full(g.rshape, 2.0, np.float32)
    P[0, 0, 0] = 0.0
    obs = ObsData(nobs=t(rng.normal(size=g.shape)), window=t(np.ones(g.shape)),
                  noise=t(np.ones(g.shape)), power=t(P))
    mc = ModelConfig(likelihood=1,
                     forward=ForwardConfig(sfmodel=1, masskernel="tsc"))
    return mc, obs, mass_mod.compute_mass(g, 1, obs.power), rng


# -- the shared module draws what the sharded sampler drew before -----------

# splitmix64 words and draws of the (seed, count, stream) generators,
# computed with the sharded sampler's _mix and attempt_generator before they
# moved into hmc/randoms.py
PARENT_MIX = {(4, 0, 0): 1991556232413726932,
              (10, 3, 1): 1296481577807456228,
              (2**40 + 7, 5, 2): 6911029526837620813}
PARENT_RAND = {(4, 0, 0): [0.758051335811615, 0.7066153287887573,
                           0.15489661693572998],
               (10, 3, 0): [0.05303388833999634, 0.6635117530822754,
                            0.004484415054321289]}
PARENT_RANDN = {(10, 3, 1): [-0.7933931350708008, -0.3904043734073639,
                             -1.731976866722107, -0.8643664717674255],
                (10, 3, 2): [-1.1008111238479614, -1.8252407312393188,
                             1.9045745134353638, 0.02030235528945923]}


@pytest.mark.parametrize("words", list(PARENT_MIX))
def test_mix_is_the_sharded_samplers_of_before(words):
    assert rnd._mix(*words) == PARENT_MIX[words]


@pytest.mark.parametrize("key", list(PARENT_RAND) + list(PARENT_RANDN))
def test_attempt_generator_draws_as_before(key):
    gen = rnd.attempt_generator(*key, "cpu")
    if key in PARENT_RAND:
        assert torch.rand(3, generator=gen).tolist() == PARENT_RAND[key]
    else:
        assert torch.randn(4, generator=gen).tolist() == PARENT_RANDN[key]


def test_sharded_attempt_draws_as_before():
    """One sharded attempt of two chains at one rank (seeds 10 and 2^40 + 7,
    attempt counts 3 and 5): Neps and epsilon as the parent's sampler
    drew them, and H_kin of its momenta."""
    mc, obs, mass, rng = problem()
    hc = HMCConfig(eps_fac=0.01, eps_fac_update_type=0, mass_type=1,
                   N_eps_fac=4, N_a_eps_update=4)
    layout = pd.make_layout(1, 1, device="cpu")
    s0 = 0.1 * torch.from_numpy(rng.normal(size=(2,) + G8.shape)
                                .astype(np.float32))
    obs_sh = sfw.shard_obs(obs, layout)
    (vals, aux), grads = sfw.make_sharded_psi_vg_chains(
        G8, mc, GP, layout, halo=3)(s0, obs_sh)
    st = ss.init_chain_state(s0, vals, aux, grads, [10, 2**40 + 7],
                             [hc.eps_fac_start(G8.N)] * 2, hc)
    st["count_attempts"] = torch.tensor([3, 5], dtype=torch.int32)
    with torch.no_grad():
        _, stats = ss.make_sharded_attempt(G8, mc, GP, hc, layout, halo=3)(
            st, obs_sh, sfw.power_to_sharded_layout(mass.mass_f, layout))
    assert stats.Neps.tolist() == [1, 4]
    assert stats.epsilon.tolist() == [0.006635117344558239,
                                      0.0022157293278723955]
    np.testing.assert_allclose(stats.H_kin_i.numpy(),
                               [265.63262939453125, 252.97093200683594],
                               rtol=1e-5)


# -- a chain's draws depend on its seed and count only ----------------------

def mass_of(mass_type, g=G8):
    """A MassState with each part the type uses (positive real-space
    diagonal, inverse-power spectrum)."""
    _, obs, mass, _ = problem(g)
    fs, rs = mass_mod.mass_flags(mass_type)
    r = torch.linspace(0.5, 2.0, g.N).reshape(g.shape)
    return MassState(mass_f=mass.mass_f if fs else torch.zeros_like(
        mass.mass_f), mass_r=r if rs else 0.0)


@pytest.mark.parametrize("mass_type", [0, 1, 5])
def test_a_chains_draws_do_not_depend_on_its_batch(mass_type):
    """Seed 11 at attempt 3, alone and as the middle chain of three."""
    hc = HMCConfig(mass_type=mass_type)
    mass = mass_of(mass_type)
    alone = sampler.draw_randoms(chains([11], [3]), G8, hc, mass)
    batch = sampler.draw_randoms(chains([7, 11, 9], [0, 3, 5]), G8, hc, mass)
    for name in ("u_neps", "u_eps", "u_acc"):
        assert torch.equal(getattr(alone, name)[0], getattr(batch, name)[1])
    p = alone.momenta[0]
    np.testing.assert_allclose(batch.momenta[1].numpy(), p.numpy(), rtol=0,
                               atol=1e-6 * float(p.abs().max()))
    assert not torch.equal(batch.momenta[0], batch.momenta[1])
    # the noise is the chain's own, stream by stream
    for stream, used in ((rnd.momentum_stream(0), mass_type != 0),
                         (rnd.REAL_MASS_STREAM, mass_type in (0, 5))):
        w = rnd.white([(11, 3)], stream, G8.shape, "cpu")
        assert torch.equal(w, rnd.white(rnd.chain_keys([7, 11, 9], [0, 3, 5]),
                                        stream, G8.shape, "cpu")[1:2])
        if mass_type == 0 and used:
            assert torch.equal(p, torch.sqrt(mass.mass_r) * w[0])


def test_dense_momenta_have_the_mass_spectrum():
    """E[1/2 p M^-1 p] = (N - 1)/2 over 32 chains of fresh seeds (the k = 0
    mode has no mass), within 4 standard errors, as
    tests/test_torch_sharded_runner.py holds the sharded momenta: the
    sampler's per-chain draws, where tests/test_torch_mass.py holds
    `draw_momenta`'s batch from one generator."""
    mass = mass_of(1)
    r = sampler.draw_randoms(chains(list(range(100, 132)), [0] * 32), G8,
                             HMCConfig(mass_type=1), mass)
    kin = mass_mod.kinetic(r.momenta, G8, 1, mass).numpy()
    n = G8.N - 1
    assert abs(kin.mean() - n / 2.0) < 4 * np.sqrt(n / 2.0) / np.sqrt(len(kin))


# -- the dense and the one-rank sharded sampler draw the same ---------------

def test_dense_and_one_rank_sharded_attempts_draw_the_same(monkeypatch):
    """Two chains from the same state, seeds and counts: the same Neps,
    step sizes and momenta (captured where the sharded attempt hands them
    to the integrator), so the same accept decisions."""
    mc, obs, mass, rng = problem()
    hc = HMCConfig(eps_fac=0.01, eps_fac_update_type=0, mass_type=1,
                   N_eps_fac=4, N_a_eps_update=4)
    s0 = 0.1 * torch.from_numpy(rng.normal(size=(2,) + G8.shape)
                                .astype(np.float32))
    seeds = [21, 2**33 + 1]
    dense = sampler.make_init(G8, mc, GP, hc)(s0, obs, seeds)
    dense.count_attempts = torch.tensor([0, 6], dtype=torch.int32)
    drawn = sampler.draw_randoms(dense, G8, hc, mass)
    _, st_d = sampler.make_attempt(G8, mc, GP, hc)(dense, obs, mass)

    layout = pd.make_layout(1, 1, chains_per_rank=2, device="cpu")
    obs_sh = sfw.shard_obs(obs, layout)
    (vals, aux), grads = sfw.make_sharded_psi_vg_chains(
        G8, mc, GP, layout, halo=3)(s0, obs_sh)
    state = ss.init_chain_state(s0, vals, aux, grads, seeds,
                                [hc.eps_fac_start(G8.N)] * 2, hc)
    state["count_attempts"] = dense.count_attempts.clone()
    seen = []

    def leapfrog(vag, minv, carry0, *args, **kw):
        seen.append(carry0[5].clone())
        return sampler.leapfrog(vag, minv, carry0, *args, **kw)

    monkeypatch.setattr(ss, "leapfrog", leapfrog)
    with torch.no_grad():
        _, st_s = ss.make_sharded_attempt(G8, mc, GP, hc, layout, halo=3)(
            state, obs_sh, sfw.power_to_sharded_layout(mass.mass_f, layout))
    p = drawn.momenta
    np.testing.assert_allclose(seen[0].numpy(), p.numpy(), rtol=0,
                               atol=1e-5 * float(p.abs().max()))
    assert st_s.Neps.tolist() == st_d.Neps.tolist()
    assert torch.equal(st_s.epsilon, st_d.epsilon)
    assert st_s.accepted.tolist() == st_d.accepted.tolist()
    np.testing.assert_allclose(st_s.H_kin_i.numpy(), st_d.H_kin_i.numpy(),
                               rtol=1e-5)


# -- a dense session and a one-rank --sharded session -----------------------

SESSION_PAR = """
Nx = 16
Lx = 25.0
sfmodel = 3
masskernel = sph_ft
rsd_model = true
slength = 4.0
likelihood = 1
N_eps_fac = 4
eps_fac = 0.001
eps_fac_update_type = 3
mass_type = 1
N_a_eps_update = 4
pallas_deposit = true
pallas_halo = 0
pallas_tail_k = 512
readPS = false
initial_guess = 2
outnum = 1
seed = 5
"""
SESSION_ATTEMPTS = 16  # one batch of the runners' attempt_batch


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """The headline model of one chain at 16^3 through the command line's
    stages, dense and --sharded (a gloo group of one), 16 attempts each."""
    tmp = tmp_path_factory.mktemp("sessions")
    par = tmp / "input.par"
    par.write_text(SESSION_PAR)
    out = {}
    for name, extra in (("dense", []), ("sharded", ["--sharded"])):
        args = cli.parse_args([str(par), "--device", "cpu", "--no-dashboard",
                               "--out", str(tmp / name)] + extra)
        runner = cli.open_session(args)
        assert runner.attempt_batch == SESSION_ATTEMPTS
        runner.run(n_samples=10**6, max_attempts=SESSION_ATTEMPTS)
        runner.close()
        st = runner.states if name == "dense" else runner.state
        out[name] = (tmp / name, {k: getattr(st, k) if name == "dense"
                                  else st[k] for k in ("psi", "eps_fac",
                                                       "seed")})
    return out


@pytest.mark.parametrize("name", ["deltaLAGtest", "nobs", "initial_guess"])
def test_sessions_start_from_the_same_files(sessions, name):
    (d, _), (s, _) = sessions["dense"], sessions["sharded"]
    shape = (16, 16, 16)
    np.testing.assert_array_equal(bio.read_array(d / name, shape),
                                  bio.read_array(s / name, shape))


def test_sessions_take_the_same_accept_decisions(sessions):
    (d, dst), (s, sst) = sessions["dense"], sessions["sharded"]
    assert dst["seed"].tolist() == sst["seed"].tolist() == [6]
    ld = np.loadtxt(d / "performance_log.txt")
    ls = np.loadtxt(s / "performance_log.txt")
    assert ld.shape == ls.shape == (SESSION_ATTEMPTS, 12)
    # accepted, epsilon, Neps
    np.testing.assert_array_equal(ld[:, :3], ls[:, :3])
    assert 0 < ld[:, 0].sum() < SESSION_ATTEMPTS
    # the chain's psi at each attempt (psi_prior_i + psi_likeli_i)
    np.testing.assert_allclose(ls[:, 6] + ls[:, 8], ld[:, 6] + ld[:, 8],
                               rtol=3e-5)
    np.testing.assert_allclose(sst["psi"].numpy(), dst["psi"].numpy(),
                               rtol=3e-5)
    assert torch.equal(sst["eps_fac"], dst["eps_fac"])


def test_sessions_dump_the_same_samples(sessions):
    (d, _), (s, _) = sessions["dense"], sessions["sharded"]
    dumps = sorted(p.name for p in d.glob("deltaLAG_*.dat"))
    assert dumps and dumps == sorted(p.name for p in s.glob("deltaLAG_*.dat"))
    for name in dumps:
        a = np.fromfile(d / name, np.float32)
        b = np.fromfile(s / name, np.float32)
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-4 * np.abs(a).max(), err_msg=name)


# -- the dense checkpoint ---------------------------------------------------

@pytest.fixture()
def checkpointed(tmp_path):
    """A dense session of two chains at 8^3 and its checkpoint."""
    r = Runner(small_conf(tmp_path), device="cpu")
    r.attempt_batch = 4
    r.setup()
    r.run(n_samples=1, max_attempts=8, log=True)
    return r, r.checkpoint()


def test_checkpoint_holds_seeds_and_no_generator_state(checkpointed):
    r, path = checkpointed
    data = np.load(path)
    assert "generator_state" not in data.files
    assert data["state_seed"].dtype == np.int64
    assert data["state_seed"].tolist() == [r.conf.seed + 1, r.conf.seed + 2]
    assert "device" not in path.with_suffix(".json").read_text()
    r.close()


def test_checkpoint_resumes_bit_for_bit(checkpointed, tmp_path):
    """A new Runner restores the checkpoint; one batch of attempts then gives
    the same state and records bit for bit as the uninterrupted Runner."""
    r, path = checkpointed
    r2 = Runner(r.conf, out_dir=str(tmp_path / "second"), device="cpu")
    r2.attempt_batch = 4
    r2.setup().restore(path)
    s1, stats1 = r._run(r.states, r.obs, r.mass)
    s2, stats2 = r2._run(r2.states, r2.obs, r2.mass)
    for f in dataclasses.fields(ChainState):
        assert torch.equal(getattr(s1, f.name), getattr(s2, f.name)), f.name
    for f in dataclasses.fields(stats1):
        np.testing.assert_array_equal(getattr(stats1, f.name),
                                      getattr(stats2, f.name), f.name)
    r.close()
    r2.close()


@pytest.mark.parametrize("keys", ["generator_state, no seed", "no seed"])
def test_old_format_checkpoint_raises(checkpointed, keys):
    r, path = checkpointed
    old = dict(np.load(path))
    old.pop("state_seed")
    if "generator_state" in keys:
        old["generator_state"] = torch.Generator().get_state().numpy()
    np.savez(path, **old)
    with pytest.raises(ValueError, match="older format"):
        r.restore(path)
    r.close()


def test_restart_from_dumps_goes_on_at_the_logged_counter(checkpointed,
                                                          tmp_path):
    """restore_from_dumps replays count_attempts from performance_log.txt:
    chain 0 draws next what the uninterrupted chain draws next."""
    r, _ = checkpointed
    r.close()
    r2 = Runner(dataclasses.replace(r.conf, mock=dataclasses.replace(
        r.conf.mock, random_test=False)), device="cpu").setup()
    r2.restore_from_dumps(1)
    assert r2.states.count_attempts.tolist() == \
        r.states.count_attempts.tolist()
    assert torch.equal(r2.states.seed, r.states.seed)
    a = sampler.draw_randoms(r.states, r.g, r.conf.hmc, r.mass)
    b = sampler.draw_randoms(r2.states, r2.g, r2.conf.hmc, r2.mass)
    for name in ("u_neps", "u_eps", "u_acc"):
        assert torch.equal(getattr(a, name), getattr(b, name))
    assert torch.equal(a.momenta, b.momenta)
    r2.close()


# -- a resume whose setup observed other data is refused --------------------

@pytest.mark.parametrize("differs", ["observations", "pallas_halo"])
def test_restore_refuses_another_session(checkpointed, tmp_path, monkeypatch,
                                         differs):
    """A setup that drew another mock (as it does on the other device type,
    whose generator differs) or resolved another pallas_halo does not go on
    with the checkpoint's chains: ValueError, naming the way out."""
    r, path = checkpointed
    conf = r.conf
    if differs == "pallas_halo":
        fwd = dataclasses.replace(conf.model.forward,
                                  pallas_halo=conf.model.forward.pallas_halo + 1)
        conf = dataclasses.replace(conf, model=dataclasses.replace(
            conf.model, forward=fwd))
    if differs == "observations":
        draw_another_mock(monkeypatch)
    r2 = Runner(conf, out_dir=str(tmp_path / "second"), device="cpu").setup()
    with pytest.raises(ValueError, match="random_test = false"
                       if differs == "observations" else "set pallas_halo = "):
        r2.restore(path)
    r.close()
    r2.close()


RESUME_PAR = SESSION_PAR.replace("Nx = 16", "Nx = 8").replace("Lx = 25.0",
                                                              "Lx = 12.5")


def draw_another_mock(monkeypatch):
    """From now on setup() draws another mock, as it does on the other device
    type."""
    generate = mock_mod.generate

    def other(*args, **kw):
        md = generate(*args, **kw)
        return dataclasses.replace(md, obs=dataclasses.replace(
            md.obs, nobs=md.obs.nobs + 1.0))

    monkeypatch.setattr(mock_mod, "generate", other)


@pytest.mark.parametrize("how", ["resume", "sharded resume", "restart"])
def test_resume_of_another_mock_is_refused_and_keeps_the_dumps(
        tmp_path, monkeypatch, how):
    """The command line's --resume (dense and --sharded) and its restart
    from deltaLAG_1 without the checkpoint, where setup draws another mock:
    ValueError, and no dump of the session is written again.  With
    `random_test = false` and the session's pallas_halo (and, --sharded, an
    exchange margin), its dumped nobs, win and sigma then resume it."""
    par = tmp_path / "input.par"
    par.write_text(RESUME_PAR)
    out = tmp_path / "run"
    common = ["--device", "cpu", "--no-dashboard", "--out", str(out)] + \
        (["--sharded"] if "sharded" in how else [])
    assert cli.main([str(par)] + common + ["--samples", "1"]) == 0
    ckpt = out / ("checkpoint_sharded.npz" if "sharded" in how
                  else "checkpoint.npz")
    halo = json.loads(ckpt.with_suffix(".json").read_text())["pallas_halo"]
    assert halo > 0  # resolved from the mock truth
    again = ["--resume", "--samples", "2"]
    if how == "restart":
        ckpt.unlink()
        again = ["1", "--samples", "2"]
    written = lambda: {p.name: (p.read_bytes(), p.stat().st_mtime_ns)
                       for p in out.glob("*.dat")}
    dumps = written()
    assert {"nobs.dat", "win.dat", "sigma.dat", "deltaLAGtest.dat",
            "initial_guess.dat", "deltaLAG_1.dat"} <= set(dumps)

    draw_another_mock(monkeypatch)
    with pytest.raises(ValueError, match="random_test = false"):
        cli.main([str(par)] + again[:-2] + common + again[-2:])
    assert written() == dumps  # not even written again with the same bytes

    par.write_text(RESUME_PAR.replace("pallas_halo = 0",
                                      f"pallas_halo = {halo}")
                   + "random_test = false\n")
    if "sharded" in how:  # no mock truth to measure the exchange margin on
        common += ["--halo", str(halo)]
    assert cli.main([str(par)] + again[:-2] + common + again[-2:]) == 0
    assert (out / "deltaLAG_2.dat").exists()
    for name in ("nobs.dat", "win.dat", "sigma.dat"):
        assert (out / name).read_bytes() == dumps[name][0], name
