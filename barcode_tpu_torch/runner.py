"""Session runner: model assembly, mock data, the sampling loop and dumps.

Port of barcode_tpu/runner.py (`Runner.__init__`, `setup`,
`_resolve_auto_halo`, `_compute_mass` for mass type 1, `dump_sample`,
`_log_attempts`, `run`), parity: reference barlib/src/barcoderunner.cc and
barcode/main.cc.  Chains are batched on one device; chain 0's outputs use
the reference's file names (deltaLAG_<i> etc.).

Differences from the JAX runner:
  * randomness comes from one `torch.Generator` seeded with conf.seed;
  * checkpoint/restore, restore_from_dumps, the perf-log replay, the live
    dashboard and mass types other than 1 wait for a later slice.
"""
from __future__ import annotations

import dataclasses
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
from barcode_tpu_torch.forward.lag2eul import displaced_positions, lag2eul
from barcode_tpu_torch.model.likelihoods import ObsData
from barcode_tpu_torch.hmc import mass as mass_mod, sampler
from barcode_tpu_torch.hmc.state import ChainState
from barcode_tpu_torch.protocol import Protocols
from barcode_tpu_torch.utils.metrics import SamplerMetrics, check_finite, split_rhat

PERFLOG_COLUMNS = [
    "accepted", "epsilon", "Neps", "dH", "dK", "dE",
    "psi_prior_i", "psi_prior_f", "psi_likeli_i", "psi_likeli_f",
    "H_kin_i", "H_kin_f",
]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


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
        self._run = None
        self._perflog = None
        self._protocols = Protocols(self.dir)
        self._truth_spec = None
        self._dump_cursor = 0
        self._psi_trace: list[np.ndarray] = []
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
        """Halo-contract violators of one signal (x/y only: RSD shifts z)."""
        fwd = self.conf.model.forward
        with torch.no_grad():
            pos = displaced_positions(s, self.g,
                                      dataclasses.replace(fwd, rsd=False),
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

    def load_power(self):
        """readtab equivalent: CAMB table -> rfft grid; with readPS=false the
        internal EH98 P(k) (cosmo.linear_power)."""
        if self.conf.readPS and self.conf.fnamePS:
            k_t, p_t = bio.read_powspec_table(self.conf.fnamePS)
        else:
            from barcode_tpu_torch import cosmo as cosmo_mod
            k_t = np.logspace(-4, 2, 1024)
            p_t = cosmo_mod.linear_power(self.conf.cosmo(), k_t)
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                         device=self.device)
        return fourier.power_table_to_rfft_grid(as_t(k_t), as_t(p_t), self.g)

    def setup(self, n_chains: int | None = None):
        conf = self.conf
        power = self.load_power()
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
            self._dump_mock(md)
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
            guesses = torch.stack([self._initial_guess()
                                   for _ in range(n_chains)])
        else:
            guesses = self._initial_guess().expand(
                (n_chains,) + self.g.shape).contiguous()
        init = sampler.make_init(self.g, conf.model, self.gp, conf.hmc)
        self.states = init(guesses, self.obs)
        bio.write_array(self.dir / "initial_guess", _host(guesses[0]))
        km, pw, _ = self._spectrum(guesses[0])
        bio.dump_spectrum(self.dir / "spec_initial_guess.dat", _host(km),
                          _host(pw))
        self.mass = self._compute_mass()
        self._run = sampler.make_sampler(self.g, conf.model, self.gp, conf.hmc,
                                         n_attempts_per_call=self.attempt_batch)
        return self

    def _initial_guess(self):
        """make_initial_guess (barcoderunner.cc:207-247): 0 zero, 1 file,
        2 GRF, 4 zero + 0.1 noise (3, the smoothed GRF, waits)."""
        conf = self.conf
        ig = conf.initial_guess
        if ig == 0:
            return torch.zeros(self.g.shape, device=self.device)
        if ig == 1:
            return torch.as_tensor(
                bio.read_array(self.dir / conf.initial_guess_file, self.g.shape),
                device=self.device)
        if ig == 2:
            return random_fields.grf(self.generator, self.g, self.obs.power)
        if ig == 4:
            return 0.1 * random_fields.white_noise(self.generator, self.g)
        raise NotImplementedError(f"initial_guess {ig} is not ported yet")

    def _compute_mass(self):
        hc = self.conf.hmc
        return mass_mod.compute_mass(self.g, hc.mass_type, self.obs.power,
                                     mass_factor=hc.mass_factor)

    def current_signal(self, chain: int = 0):
        return self.states.delta[chain]

    # -- outputs ----------------------------------------------------------

    def _dump_mock(self, md: mock_mod.MockData):
        for name, field in [("deltaLAGtest", md.truth_lag),
                            ("deltaEULtest", md.truth_eul),
                            ("win", md.obs.window), ("nobs", md.obs.nobs),
                            ("sigma", md.obs.noise)]:
            bio.write_array(self.dir / name, _host(field))
        for name, field in [("specLAGtest", md.truth_lag),
                            ("specEULtest", md.truth_eul),
                            ("spec_nobs", md.obs.nobs)]:
            km, pw, _ = self._spectrum(field)
            bio.dump_spectrum(self.dir / f"{name}.dat", _host(km), _host(pw))
            if name == "specLAGtest":
                self._truth_spec = _host(pw)

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
            self._warn_violations(self._violations(s))
        if spectrum:
            acc = float(_host(self.states.acc_flags[chain]).mean())
            resid = float(self.states.psi_like[chain]) / (self.g.N / 2.0)
            self._protocols.log_convergence(iteration, resid, acc)
            self._protocols.log_spectrum(iteration, km, pw, self._truth_spec)

    def _warn_violations(self, nviol: int):
        fwd = self.conf.model.forward
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

    def _log_attempts(self, stats):
        """Append chain-0 rows to performance_log.txt (HMC.cc:40-60)."""
        if self._perflog is None:
            path = self.dir / "performance_log.txt"
            new = not path.exists()
            self._perflog = open(path, "a")
            if new:
                self._perflog.write("# " + "\t".join(PERFLOG_COLUMNS) + "\n")
        rows = np.column_stack([getattr(stats, c)[:, 0]
                                for c in PERFLOG_COLUMNS])
        for r in rows:
            self._perflog.write("\t".join(f"{v:.6g}" for v in r) + "\n")
        self._perflog.flush()

    # -- sampling loop ----------------------------------------------------

    def run(self, n_samples: int | None = None, max_attempts: int = 10**9,
            log: bool = True, progress_every: int = 10,
            nan_check: bool = False, rhat_stop: float | None = None):
        """Sample until every chain has >= n_samples accepted samples (the
        reference's N_Gibbs) or max_attempts attempts ran, in batches of
        `attempt_batch`; dumps chain-0 fields every `outnum` samples
        (runner.py:310-437).  nan_check aborts on non-finite state;
        rhat_stop also stops once the split R-hat of the psi traces drops
        below it."""
        conf = self.conf
        n_samples = n_samples if n_samples is not None else conf.N_Gibbs
        attempts_done = 0
        if self.metrics is None:
            self.metrics = SamplerMetrics()
        while attempts_done < max_attempts:
            if (self.dir / "fastexit").exists():
                print("fastexit sentinel found — stopping cleanly")
                break
            self.states, stats = self._run(self.states, self.obs, self.mass,
                                           self.generator)
            attempts_done += self.attempt_batch
            self.metrics.update(stats)
            self._psi_trace.append(_host(self.states.psi))
            if nan_check:
                check_finite(self.states, f"after attempt {attempts_done}")
            if log:
                self._log_attempts(stats)
            accepted = _host(self.states.accepted)
            acc0 = int(accepted[0])
            for i in range(self._dump_cursor + 1, min(acc0, n_samples) + 1):
                wf = i <= 10 or (conf.outnum > 0 and i % conf.outnum == 0)
                wp = i <= 10 or (conf.outnum_ps > 0 and i % conf.outnum_ps == 0)
                if wf or wp:
                    self.dump_sample(i, fields=wf, spectrum=wp)
            self._dump_cursor = max(self._dump_cursor, min(acc0, n_samples))
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
            if log and attempts_done % (self.attempt_batch * progress_every) == 0:
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
