"""Session runner: model assembly, mock data, the sampling loop, dumps,
diagnostics, checkpoint/resume and the reference's file-based restart.

Port of barcode_tpu/runner.py, parity: reference barlib/src/barcoderunner.cc
and barcode/main.cc.  Chains are batched on one device; chain 0's outputs
use the reference's file names (deltaLAG_<i> etc.).

Differences from the JAX runner:
  * the setup (mock, initial guesses) draws from one `torch.Generator`
    seeded with conf.seed; the attempts draw from each chain's own
    counter-based generators (`hmc.randoms`), chain c seeded with
    conf.seed + 1 + c, where the JAX runner splits a key per chain.  The
    checkpoint therefore holds no generator state and restores on either
    device type (see `Runner.restore`);
  * the checkpoint stores the chain state by field name instead of the JAX
    pytree's leaf order; the dumps and performance_log.txt keep the
    reference's formats, so a run dumped by the JAX package restarts here
    through `restore_from_dumps`.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from pathlib import Path

import numpy as np
import torch

from barcode_tpu_torch import io as bio
from barcode_tpu_torch import mock as mock_mod
from barcode_tpu_torch import random_fields
from barcode_tpu_torch.config import RunConfig
from barcode_tpu_torch.device import resolve
from barcode_tpu_torch.grid import fourier
from barcode_tpu_torch.forward import tsc_kernels
from barcode_tpu_torch.forward.lag2eul import (displaced_positions, kernel_h,
                                               lag2eul)
from barcode_tpu_torch.model import likelihoods
from barcode_tpu_torch.model.likelihoods import ObsData
from barcode_tpu_torch.model.posterior import make_psi_force
from barcode_tpu_torch.hmc import mass as mass_mod, sampler
from barcode_tpu_torch.hmc.state import ChainState
from barcode_tpu_torch.protocol import Protocols
from barcode_tpu_torch.utils.dashboard import Dashboard
from barcode_tpu_torch.utils.metrics import (SamplerMetrics, check_finite,
                                             effective_sample_size, split_rhat)

PERFLOG_COLUMNS = [
    "accepted", "epsilon", "Neps", "dH", "dK", "dE",
    "psi_prior_i", "psi_prior_f", "psi_likeli_i", "psi_likeli_f",
    "H_kin_i", "H_kin_f",
]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


DATA_DUMPS = ("nobs", "win", "sigma")  # the observations, as dumped


def obs_sha256(fields) -> str:
    """SHA-256 of observation fields as they are dumped (float32 bytes)."""
    h = hashlib.sha256()
    for x in fields:
        x = _host(x) if isinstance(x, torch.Tensor) else x
        h.update(memoryview(np.ascontiguousarray(x, dtype=np.float32))
                 .cast("B"))
    return h.hexdigest()


def session_digest(obs: ObsData, pallas_halo) -> dict:
    """What a checkpoint holds its session to: the digest of the
    observations (nobs, win, sigma) and the resolved pallas_halo."""
    return {"obs_sha256": obs_sha256((obs.nobs, obs.window, obs.noise)),
            "pallas_halo": int(pallas_halo)}


def dumped_digest(run_dir: Path, g) -> dict:
    """The digest of the observations dumped in `run_dir` (an empty record
    where one of them is missing)."""
    paths = [Path(run_dir) / f"{n}.dat" for n in DATA_DUMPS]
    if not all(p.exists() for p in paths):
        return {}
    return {"obs_sha256": obs_sha256(bio.read_array(p, g.shape)
                                     for p in paths)}


def check_session(recorded: dict, here: dict, source) -> None:
    """Raise ValueError where the session recorded in `source` (a
    checkpoint's .json, or the dumped observations) observed other data or
    resolved another pallas_halo than this setup (`here`, session_digest).
    A key `recorded` lacks is not checked."""
    if recorded.get("obs_sha256", here["obs_sha256"]) != here["obs_sha256"]:
        raise ValueError(
            f"{source}: the session observed other data (nobs, win, sigma) "
            "than this setup drew or read.  A mock drawn on the other "
            "device type differs (the CPU and CUDA generators differ): "
            "resume with `random_test = false`, which reads the session's "
            "dumped nobs, win and sigma")
    if recorded.get("pallas_halo", here["pallas_halo"]) != here["pallas_halo"]:
        raise ValueError(
            f"{source}: the session resolved pallas_halo = "
            f"{recorded['pallas_halo']}, this setup {here['pallas_halo']}; "
            f"set pallas_halo = {recorded['pallas_halo']} in input.par")


def load_power(conf: RunConfig, device):
    """readtab equivalent: CAMB table -> rfft grid on `device`; with
    readPS=false the internal EH98 P(k) (cosmo.linear_power)."""
    if conf.readPS and conf.fnamePS:
        k_t, p_t = bio.read_powspec_table(conf.fnamePS)
    else:
        from barcode_tpu_torch import cosmo as cosmo_mod
        k_t = np.logspace(-4, 2, 1024)
        p_t = cosmo_mod.linear_power(conf.cosmo(), k_t)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return fourier.power_table_to_rfft_grid(as_t(k_t), as_t(p_t), conf.grid)


def initial_guess(conf: RunConfig, generator: torch.Generator, power,
                  run_dir: Path):
    """make_initial_guess (barcoderunner.cc:207-247) on the generator's
    device: 0 zero, 1 file, 2 GRF, 3 smoothed GRF, 4 zero + 0.1 noise."""
    g, dev = conf.grid, generator.device
    ig = conf.initial_guess
    if ig == 0:
        return torch.zeros(g.shape, device=dev)
    if ig == 1:
        return torch.as_tensor(
            bio.read_array(run_dir / conf.initial_guess_file, g.shape),
            device=dev)
    if ig in (2, 3):
        s = random_fields.grf(generator, g, power)
        if ig == 3:
            s = fourier.smooth(s, g, conf.initial_guess_smoothing_scale,
                               conf.initial_guess_smoothing_type)
        return s
    if ig == 4:
        return 0.1 * random_fields.white_noise(generator, g)
    raise ValueError(f"invalid initial_guess {ig}")


def likelihood_force(conf: RunConfig, gp, obs: ObsData, signal):
    """grad of psi_likelihood at `signal` (runner.py:231-248), through the
    windowless deposit as in the JAX runner: the force only seeds the
    mass-2/3 preconditioner spectrum.  Where psi does not depend on the
    signal through autograd (NGP: constant deposit weights, and a floor of
    zero slope) the force is the zero field, as jax.grad gives."""
    mc = conf.model
    fwd = dataclasses.replace(mc.forward, pallas_deposit=False)
    with torch.enable_grad():
        s = signal.detach().requires_grad_(True)
        if mc.likelihood == 3:
            psi = likelihoods.grf_psi(s, obs)
        else:
            dx = lag2eul(mc.deltaQ_factor * s, conf.grid, fwd, gp)
            psi = likelihoods.likelihood_psi(mc.likelihood, dx, obs)
        if not psi.requires_grad:
            return torch.zeros_like(s)
        (grad,) = torch.autograd.grad(psi, s)
    return grad


def warn_violations(fwd, nviol: int):
    """The halo-contract monitor's warning at dump time: with the tail
    split it watches the tail capacity."""
    tail_k = fwd.pallas_tail_k
    if tail_k > 0:
        if nviol > tail_k // 2:
            over = " OVERFLOW: excess mass is dropped;" \
                if nviol > tail_k else ""
            print(f"WARNING: {nviol} halo-contract violators against a "
                  f"tail capacity of {tail_k} (pallas_tail_k) —{over} "
                  "raise pallas_tail_k or pallas_halo")
    elif nviol:
        print(f"WARNING: {nviol} particles breach the deposit halo "
              f"contract (pallas_halo={fwd.pallas_halo}) — their mass is "
              "dropped; increase pallas_halo")


def append_perflog(perflog, run_dir: Path, stats):
    """Append chain-0 rows of the 12-column performance_log.txt
    (HMC.cc:40-60) to the open log `perflog` (opened, with its header when
    new, if None); returns the open log."""
    if perflog is None:
        path = run_dir / "performance_log.txt"
        new = not path.exists()
        perflog = open(path, "a")
        if new:
            perflog.write("# " + "\t".join(PERFLOG_COLUMNS) + "\n")
    rows = np.column_stack([getattr(stats, c)[:, 0] for c in PERFLOG_COLUMNS])
    for r in rows:
        perflog.write("\t".join(f"{v:.6g}" for v in r) + "\n")
    perflog.flush()
    return perflog


class Runner:
    def __init__(self, conf: RunConfig, out_dir: str | None = None,
                 device=None):
        self.conf = conf
        self.g = conf.grid
        self.gp = conf.growth()
        self.device = resolve(device)
        self.dir = Path(out_dir if out_dir is not None else conf.dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(conf.seed)
        self.obs: ObsData | None = None
        self.truth = None
        self.states: ChainState | None = None
        self.mass = None
        self.attempt_batch = 16
        self.metrics: SamplerMetrics | None = None
        self.digest: dict | None = None  # session_digest, set by setup()
        self._run = None
        self._perflog = None
        self._protocols = Protocols(self.dir)
        self._truth_spec = None
        self._dump_cursor = 0
        self._mass_at_sample = 0
        self._psi_trace: list[np.ndarray] = []
        # wall-clock stamp per trace row: diagnostics() divides the ESS of
        # the post-warmup half by the time that half took
        self._trace_t: list[float] = []
        self._stall_acc = -1
        self._stall_attempts = 0

    def close(self):
        """Close the performance and protocol logs."""
        if self._perflog is not None:
            self._perflog.close()
            self._perflog = None
        self._protocols.close()

    # -- helpers ----------------------------------------------------------

    def _spectrum(self, field):
        return fourier.measure_spectrum(field, self.g, self.conf.N_bin)

    def _forward_dump(self, s, rsd: bool):
        """delta_eul of one signal for the dumps, through the sampler's own
        forward model (the kernel deposit K1 with the resolved halo)."""
        fwd = dataclasses.replace(self.conf.model.forward, rsd=rsd)
        with torch.no_grad():
            return lag2eul(s, self.g, fwd, self.gp)

    def _violations(self, s) -> int:
        """Halo-contract violators of one signal (x/y only: plane-parallel
        RSD shifts z; radial RSD is kept, `tsc_kernels.contract_config`)."""
        fwd = self.conf.model.forward
        with torch.no_grad():
            pos = displaced_positions(s, self.g,
                                      tsc_kernels.contract_config(fwd),
                                      self.gp)
            return int(tsc_kernels.deposit_violations(pos, self.g,
                                                      fwd.pallas_halo))

    def _resolve_auto_halo(self, truth):
        """pallas_halo <= 0 -> measure the truth's x/y displacement bound;
        with the tail split (pallas_tail_k > 0) the quantile halo."""
        fwd = self.conf.model.forward
        if not (fwd.pallas_deposit and fwd.pallas_halo <= 0):
            return
        if fwd.pallas_tail_k > 0:
            halo = tsc_kernels.displacement_halo_quantile(
                truth, self.g, fwd, self.gp, fwd.pallas_tail_k)
        else:
            halo = tsc_kernels.displacement_bound_cells(truth, self.g, fwd,
                                                        self.gp)
        fwd = dataclasses.replace(fwd, pallas_halo=halo)
        self.conf = dataclasses.replace(
            self.conf, model=dataclasses.replace(self.conf.model, forward=fwd))

    # -- setup ------------------------------------------------------------

    def setup(self, n_chains: int | None = None, resume: bool = False):
        """Observations (the mock, or the dumped nobs/win/sigma), the
        resolved halo, the chains' initial state and the mass.  `resume`:
        the directory holds a session that restore() or
        restore_from_dumps() will go on with, so setup writes none of its
        dumps again (powerero, the mock, the initial guess); a mock drawn
        on the other device type then cannot overwrite them before the
        restore refuses it."""
        conf = self.conf
        power = load_power(self.conf, self.device)
        if not resume:
            bio.write_array(self.dir / "powerero",
                            _host(fourier.rfft_grid_to_full(power, self.g)))

        fwd_mock = conf.model.forward
        if fwd_mock.pallas_deposit and fwd_mock.pallas_halo <= 0:
            # the halo is resolved from the mock truth below, so the mock
            # itself uses the windowless deposit
            fwd_mock = dataclasses.replace(fwd_mock, pallas_deposit=False)
        if conf.mock.random_test:
            md = mock_mod.generate(self.generator, self.g, conf.mock, fwd_mock,
                                   self.gp, power, conf.model.likelihood,
                                   delta_min=conf.delta_min)
            mock_mod.validate(md, conf.model.likelihood)
            self.obs, self.truth = md.obs, md.truth_lag
            self._dump_mock(md, write=not resume)
        else:
            read = lambda name: torch.as_tensor(
                bio.read_array(self.dir / name, self.g.shape),
                device=self.device)
            self.obs = ObsData(nobs=read("nobs"), window=read("win"),
                               noise=read("sigma"), power=power,
                               delta_min=conf.delta_min)

        fwd = conf.model.forward
        if fwd.pallas_deposit and fwd.pallas_halo <= 0:
            proxy = self.truth if self.truth is not None else \
                random_fields.grf(self.generator, self.g, power)
            self._resolve_auto_halo(proxy)
        conf = self.conf  # may carry the resolved halo now

        n_chains = n_chains or conf.n_chains
        if conf.initial_guess in (2, 3, 4):
            # stochastic guesses are drawn per chain (over-dispersed starts)
            guesses = torch.stack([
                initial_guess(conf, self.generator, self.obs.power, self.dir)
                for _ in range(n_chains)])
        else:
            guesses = initial_guess(conf, self.generator, self.obs.power,
                                    self.dir).expand(
                (n_chains,) + self.g.shape).contiguous()
        init = sampler.make_init(self.g, conf.model, self.gp, conf.hmc)
        # chain c's attempts draw from seed conf.seed + 1 + c, as the
        # ShardedRunner's chains do
        self.states = init(guesses, self.obs,
                           [conf.seed + 1 + c for c in range(n_chains)])
        if not resume:
            bio.write_array(self.dir / "initial_guess", _host(guesses[0]))
            km, pw, _ = self._spectrum(guesses[0])
            bio.dump_spectrum(self.dir / "spec_initial_guess.dat", _host(km),
                              _host(pw))
        self.mass = self._compute_mass()
        self._run = sampler.make_sampler(self.g, conf.model, self.gp, conf.hmc,
                                         n_attempts_per_call=self.attempt_batch)
        # hashed once here, outside the sampling loop
        self.digest = session_digest(self.obs, conf.model.forward.pallas_halo)
        return self

    def _compute_mass(self):
        """The mass of conf.hmc.mass_type at the current state
        (runner.py:215-229): types 2/3 from chain 0's likelihood force,
        type 60 switches from type 0 at burn-in."""
        hc = self.conf.hmc
        force = None
        if hc.mass_type in (2, 3):
            force = likelihood_force(self.conf, self.gp, self.obs,
                                     self.current_signal())
        burned_in = (self.states is not None and
                     int(self.states.accepted.min()) >= hc.s_eps_total(self.g.N))
        return mass_mod.compute_mass(
            self.g, hc.mass_type, self.obs.power, nbin=self.conf.N_bin,
            likeli_force=force, mass_factor=hc.mass_factor,
            window=self.obs.window, noise=self.obs.noise,
            kernel_h=kernel_h(self.conf.model.forward, self.g),
            burned_in=burned_in)

    def current_signal(self, chain: int = 0):
        return self.states.delta[chain]

    # -- outputs ----------------------------------------------------------

    def _dump_mock(self, md: mock_mod.MockData, write: bool = True):
        """The truth's spectrum, which the protocol rows compare with; with
        `write`, the mock's fields and spectra."""
        km, pw, _ = self._spectrum(md.truth_lag)
        self._truth_spec = _host(pw)
        if not write:
            return
        for name, field in [("deltaLAGtest", md.truth_lag),
                            ("deltaEULtest", md.truth_eul),
                            ("win", md.obs.window), ("nobs", md.obs.nobs),
                            ("sigma", md.obs.noise)]:
            bio.write_array(self.dir / name, _host(field))
        bio.dump_spectrum(self.dir / "specLAGtest.dat", _host(km),
                          self._truth_spec)
        for name, field in [("specEULtest", md.truth_eul),
                            ("spec_nobs", md.obs.nobs)]:
            km, pw, _ = self._spectrum(field)
            bio.dump_spectrum(self.dir / f"{name}.dat", _host(km), _host(pw))

    def dump_sample(self, iteration: int, chain: int = 0,
                    fields: bool = True, spectrum: bool = True):
        """dump_deltas + dump_ps_it + protocol rows (runner.py:251-290)."""
        s = self.current_signal(chain)
        fwd = self.conf.model.forward
        if fields:
            bio.write_array(self.dir / f"deltaLAG_{iteration}", _host(s))
            bio.write_array(self.dir / f"deltaEUL_{iteration}",
                            _host(self._forward_dump(s, rsd=False)))
            if fwd.rsd:
                bio.write_array(self.dir / f"deltaRSS_{iteration}",
                                _host(self._forward_dump(s, rsd=True)))
        if spectrum:
            km, pw, _ = self._spectrum(s)
            km, pw = _host(km), _host(pw)
            bio.dump_spectrum(self.dir / f"powSpecit{iteration}.dat", km, pw)
        if fields and fwd.pallas_deposit and fwd.pallas_halo > 0:
            warn_violations(fwd, self._violations(s))
        if spectrum:
            acc = float(_host(self.states.acc_flags[chain]).mean())
            resid = float(self.states.psi_like[chain]) / (self.g.N / 2.0)
            self._protocols.log_convergence(iteration, resid, acc)
            self._protocols.log_spectrum(iteration, km, pw, self._truth_spec)

    # -- sampling loop ----------------------------------------------------

    def run(self, n_samples: int | None = None, max_attempts: int = 10**9,
            log: bool = True, progress_every: int = 10,
            nan_check: bool = False, rhat_stop: float | None = None,
            dashboard: bool | None = None):
        """Sample until every chain has >= n_samples accepted samples (the
        reference's N_Gibbs) or max_attempts attempts ran, in batches of
        `attempt_batch`; dumps chain-0 fields every `outnum` samples
        (runner.py:310-437).  nan_check aborts on non-finite state;
        rhat_stop also stops once the split R-hat of the psi traces drops
        below it; dashboard draws the live candidate table (None: on a
        TTY)."""
        conf = self.conf
        n_samples = n_samples if n_samples is not None else conf.N_Gibbs
        attempts_done = 0
        if self.metrics is None:
            self.metrics = SamplerMetrics()
        dash = Dashboard(title=f"barcode_tpu_torch  N={self.g.N1}  "
                         f"L={self.g.L1:g}", force=dashboard)
        rhat = float("inf")
        while attempts_done < max_attempts:
            if (self.dir / "fastexit").exists():
                print("fastexit sentinel found — stopping cleanly")
                break
            self.states, stats = self._run(self.states, self.obs, self.mass)
            attempts_done += self.attempt_batch
            self.metrics.update(stats)
            self._psi_trace.append(_host(self.states.psi))
            self._trace_t.append(time.time())
            if nan_check:
                check_finite(self.states, f"after attempt {attempts_done}")
            if log:
                self._perflog = append_perflog(self._perflog, self.dir,
                                               stats)
            accepted = _host(self.states.accepted)
            acc0 = int(accepted[0])
            for i in range(self._dump_cursor + 1, min(acc0, n_samples) + 1):
                wf = i <= 10 or (conf.outnum > 0 and i % conf.outnum == 0)
                wp = i <= 10 or (conf.outnum_ps > 0 and i % conf.outnum_ps == 0)
                if wf or wp:
                    self.dump_sample(i, fields=wf, spectrum=wp)
            self._dump_cursor = max(self._dump_cursor, min(acc0, n_samples))
            # mass recompute cadence (Hamiltonian_mass reload,
            # HMC.cc:387-424; massnum_burn before / massnum_post after
            # burn-in, 0 = never): only the signal-dependent masses change
            hc = conf.hmc
            if hc.mass_type in (2, 3, 60):
                burned = acc0 >= hc.s_eps_total(self.g.N)
                cadence = hc.massnum_post if burned else hc.massnum_burn
                if cadence > 0 and acc0 - self._mass_at_sample >= cadence:
                    self.mass = self._compute_mass()
                    self._mass_at_sample = acc0
            min_acc = int(accepted.min())
            # itmax: attempt cap per sample (HMC.cc:431); the reference
            # recomputes the mass and retries (sample_maker.cc:17-34)
            if conf.hmc.itmax > 0:
                if min_acc > self._stall_acc:
                    self._stall_acc, self._stall_attempts = min_acc, 0
                else:
                    self._stall_attempts += self.attempt_batch
                    if self._stall_attempts >= conf.hmc.itmax:
                        if log:
                            print(f"itmax={conf.hmc.itmax} attempts without "
                                  "an accepted sample — recomputing the mass "
                                  "and retrying")
                        self.mass = self._compute_mass()
                        self._stall_attempts = 0
            if dash.enabled:
                dash.update(stats, self.states, self.metrics.summary(),
                            extra=f"rhat={rhat:.3f}" if np.isfinite(rhat)
                            else "")
            elif log and attempts_done % (self.attempt_batch * progress_every) == 0:
                eps = float(_host(self.states.eps_fac).mean())
                print(self.metrics.status_line(
                    f"acc_min={min_acc} eps_fac={eps:.4g}"))
            if min_acc >= n_samples:
                break
            if rhat_stop is not None and len(self._psi_trace) >= 8 and min_acc >= 1:
                trace = np.stack(self._psi_trace, axis=1)  # [chains, draws]
                rhat = split_rhat(trace[:, trace.shape[1] // 2:])
                if rhat < rhat_stop:
                    if log:
                        print(f"converged: split R-hat {rhat:.4f} < {rhat_stop}"
                              f" after {attempts_done} attempts")
                    break
            if conf.hmc.total_steps_lim and attempts_done >= conf.hmc.total_steps_lim:
                raise RuntimeError("ABORTING: total steps exceeds total_steps_lim "
                                   "(HMC.cc:533-535)")
        return self.states

    def diagnostics(self) -> dict:
        """End-of-run diagnostics (runner.py:439-474): throughput metrics
        and the cross-chain split R-hat and ESS of the per-chain psi traces
        (warmup half discarded); ESS/s over the wall-clock span that half
        took."""
        out = dict(self.metrics.summary()) if self.metrics is not None else {}
        if self.states is not None:
            out["acc_rate_recent"] = float(_host(self.states.acc_flags).mean())
            out["eps_fac"] = _host(self.states.eps_fac).tolist()
            out["accepted_per_chain"] = _host(self.states.accepted).tolist()
        if len(self._psi_trace) >= 4:
            trace = np.stack(self._psi_trace, axis=1)  # [chains, draws]
            half_ix = trace.shape[1] // 2
            half = trace[:, half_ix:]
            out["rhat_psi"] = split_rhat(half)
            ess = sum(effective_sample_size(row) for row in half)
            out["ess_psi"] = ess
            span = self._trace_t[-1] - self._trace_t[half_ix - 1]
            if span > 0:
                out["ess_psi_per_s"] = ess / span
        return out

    # -- checkpoint / resume ----------------------------------------------

    def checkpoint(self, path=None):
        """Write the full sampler state to checkpoint.npz (+ .json): every
        ChainState tensor (the chains' seeds and attempt counts among them,
        so no generator state), the dump cursor, the mass marker
        (runner.py:479-498) and the session's digest (`session_digest`:
        its observations and resolved pallas_halo); then the restart
        marker."""
        path = Path(path or (self.dir / "checkpoint.npz"))
        arrs = {f"state_{f.name}": _host(getattr(self.states, f.name))
                for f in dataclasses.fields(ChainState)}
        np.savez(path, **arrs)
        meta = {"conf_seed": self.conf.seed, "grid": [self.g.N1, self.g.L1],
                # resume must not re-dump already-dumped samples
                "dump_cursor": self._dump_cursor,
                "mass_at_sample": self._mass_at_sample,
                **self.digest}
        path.with_suffix(".json").write_text(json.dumps(meta))
        self._protocols.write_restart_marker(int(self.states.accepted.min()))
        return path

    def restore(self, path=None):
        """Load a checkpoint written by `checkpoint` (after setup()), on the
        card or the CPU, whichever wrote it.  On the device type that wrote
        it, sampling goes on bit for bit.  On the other one the chains go
        on from the same state and attempt counts with valid draws, but
        not the same values: the CPU and CUDA generators differ.  The
        observations are not in the checkpoint, and a mock that setup()
        draws on the other device type differs too: there, resume a mock
        session with `random_test = false`, reading its dumped nobs, win
        and sigma.  A ValueError refuses a setup whose observations or
        resolved pallas_halo differ from the session's (its digest in the
        .json), and a checkpoint of the older format (one runner-wide
        `generator_state`, no per-chain `seed`)."""
        path = Path(path or (self.dir / "checkpoint.npz"))
        meta = json.loads(path.with_suffix(".json").read_text())
        data = np.load(path)
        if "generator_state" in data.files or "state_seed" not in data.files:
            raise ValueError(
                f"{path} is a checkpoint of the older format, which saved "
                "one runner-wide generator state (generator_state) and no "
                "per-chain seed (state_seed); the chains now draw from "
                "per-chain counter-based generators, so it cannot resume "
                "them: restart from the dumps instead (`input.par <i>`, "
                "restore_from_dumps)")
        check_session(meta, self.digest, path)
        self.states = ChainState(**{
            f.name: torch.as_tensor(data[f"state_{f.name}"], device=self.device)
            for f in dataclasses.fields(ChainState)})
        self._dump_cursor = int(meta["dump_cursor"])
        self._mass_at_sample = int(meta["mass_at_sample"])
        return self

    def restore_from_dumps(self, iteration: int):
        """File-based restart without a checkpoint (main.cc:121-131,
        barcoderunner.cc:284-344; runner.py:519-560): chain 0 resumes from
        the dumped deltaLAG_<iteration>, the other chains keep their initial
        guesses, and the adaptive-eps state is rebuilt by replaying
        performance_log.txt.  The replayed attempt count is each chain's
        counter, so its draws go on from where the log ends.  A ValueError
        refuses a setup whose observations differ from the dumped ones."""
        check_session(dumped_digest(self.dir, self.g), self.digest, self.dir)
        s0 = torch.as_tensor(bio.read_array(self.dir / f"deltaLAG_{iteration}",
                                            self.g.shape), device=self.device)
        delta = self.states.delta.clone()
        delta[0] = s0
        vag = make_psi_force(self.g, self.conf.model, self.gp, self.obs)
        (psi, (pp, pl)), grad = vag(delta)
        C, dev = delta.shape[0], self.device
        st = dataclasses.replace(
            self.states, delta=delta, psi=psi, psi_prior=pp, psi_like=pl,
            grad=grad, accepted=torch.full((C,), iteration, dtype=torch.int32,
                                           device=dev))
        rep = replay_perflog(self.dir, self.conf.hmc, self.g.N)
        if rep is not None:
            def per_chain(x, dtype):
                x = torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
                return x.expand((C,) + x.shape).clone()

            st = dataclasses.replace(
                st, eps_fac=per_chain(rep["eps_fac"], torch.float32),
                acc_flags=per_chain(rep["acc_flags"], torch.int32),
                eps_table=per_chain(rep["eps_table"], torch.float32),
                count_attempts=per_chain(rep["count_attempts"], torch.int32),
                rejections=per_chain(rep["rejections"], torch.int32),
                got_first_accept=per_chain(rep["got_first_accept"],
                                           torch.bool))
        self.states = st
        self._dump_cursor = iteration
        return self


def replay_perflog(run_dir, hc, N: int):
    """Reconstruct the adaptive-eps state from performance_log.txt, the
    reference's restart path (barcoderunner.cc:408-479; runner.py:562-593):
    the rejection count and the (accepted, epsilon) circular tables are
    replayed exactly; eps_fac is the largest epsilon among the recently
    accepted attempts.  None when no log exists."""
    path = Path(run_dir) / "performance_log.txt"
    if not path.exists():
        return None
    rows = []
    for line in path.read_text().splitlines():
        if line.startswith("#") or not line.strip():
            continue
        parts = line.split("\t")
        rows.append((float(parts[0]), float(parts[1])))  # accepted, eps
    if not rows:
        return None
    n_a = hc.N_a_eps_update
    acc = np.zeros(n_a, np.int32)
    eps = np.full(n_a, hc.eps_fac_start(N), np.float32)
    for t, (a, e) in enumerate(rows):
        acc[t % n_a] = int(a)
        eps[t % n_a] = e
    acc_eps = [e for a, e in rows[-n_a:] if a > 0]
    return {
        "count_attempts": len(rows),
        "rejections": len(rows) - sum(int(a) for a, _ in rows),
        "acc_flags": acc,
        "eps_table": eps,
        "eps_fac": max(acc_eps) if acc_eps else float(eps.max()),
        "got_first_accept": any(a > 0 for a, _ in rows),
    }
