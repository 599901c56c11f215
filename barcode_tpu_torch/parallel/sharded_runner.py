"""Session runner of the sharded (config-5) sampling mode.

Port of barcode_tpu/parallel/sharded_runner.py:1-534: HMC over a (chains,
grid) process layout for grids too large for one card, with the surface of
`runner.Runner` — mock or observed data at setup, per-chain initial
guesses, batched sharded attempts (`sharded_sampler`), the 12-column
performance log, deltaLAG/EUL/RSS and spectrum dumps on the outnum /
outnum_ps cadences, protocol files, R-hat/ESS diagnostics, a single-file
checkpoint and the reference's file-based restart.

Every rank runs this object; rank 0 writes the files.  The dense work of
setup and output time (the mock, the guesses, the mass-2/3 likelihood force,
the dumps) runs on each rank's device on the full grid from the same seed,
as the JAX package runs it densely on the host; it is not on the sampling
path.  Fields and chain values are gathered to every rank where a decision
or a file needs them, so every rank takes the same branch.

Scope (as in the JAX package): Fourier-space masses only (types 1/2/3/4);
the type-2/3 force spectra come from the dense chain-0 signal and are
recomputed on the massnum cadence.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from barcode_tpu_torch import io as bio
from barcode_tpu_torch import mock as mock_mod
from barcode_tpu_torch.config import RunConfig
from barcode_tpu_torch.forward import tsc_kernels as tk
from barcode_tpu_torch.forward.lag2eul import (displaced_positions, kernel_h,
                                               lag2eul)
from barcode_tpu_torch.grid import fourier
from barcode_tpu_torch.hmc import mass as mass_mod
from barcode_tpu_torch.hmc.state import AttemptStats
from barcode_tpu_torch.model.likelihoods import ObsData
from barcode_tpu_torch.parallel import sharded_forward as sfw
from barcode_tpu_torch.parallel import sharded_sampler as ss
from barcode_tpu_torch.parallel.distributed import default_mesh
from barcode_tpu_torch.parallel.sharded_fft import shard_real
from barcode_tpu_torch.protocol import Protocols
from barcode_tpu_torch.runner import (_host, append_perflog, check_session,
                                      dumped_digest, initial_guess,
                                      likelihood_force, load_power,
                                      replay_perflog, session_digest,
                                      warn_violations)
from barcode_tpu_torch.utils.dashboard import Dashboard
from barcode_tpu_torch.utils.metrics import (SamplerMetrics, check_finite,
                                             effective_sample_size, split_rhat)


class ShardedRunner:
    def __init__(self, conf: RunConfig, layout=None, out_dir: str | None = None,
                 halo: int | None = None, device=None):
        if conf.hmc.mass_type not in (1, 2, 3, 4):
            raise ValueError("sharded mode supports Fourier-space masses "
                             f"(mass_type 1/2/3/4), got {conf.hmc.mass_type}")
        self.conf = conf
        self.g = conf.grid
        self.gp = conf.growth()
        self.layout = layout if layout is not None else \
            default_mesh(conf.n_chains, device)
        # before the mock and before any file: refuse what the slab
        # posterior would not compute as the dense one does
        sfw.check_sharded_options(conf.model)
        self.device = self.layout.device
        self.n_chains = self.layout.n_chains
        self.is_main = self.layout.rank == 0
        self.halo = halo
        self.dir = Path(out_dir if out_dir is not None else conf.dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(conf.seed)
        self.obs: ObsData | None = None   # full fields (setup, mass, dumps)
        self.obs_sh: ObsData | None = None  # this rank's slabs
        self.truth = None
        self.state: dict | None = None    # this rank's chains and slabs
        self.mass_f = None                # sharded FS mass spectrum
        self.attempt_batch = 16
        self.metrics: SamplerMetrics | None = None
        self.digest: dict | None = None  # session_digest, set by setup()
        self._run = None
        self._vg = None
        self._perflog = None
        self._dump_cursor = 0
        self._mass_at_sample = 0
        self._truth_spec = None
        self._psi_trace: list[np.ndarray] = []
        self._trace_t: list[float] = []
        self._stall_acc = -1
        self._stall_attempts = 0
        self._monitor_violations = False
        self._protocols = Protocols(self.dir) if self.is_main else None

    def close(self):
        """Close the performance and protocol logs."""
        if self._perflog is not None:
            self._perflog.close()
            self._perflog = None
        if self._protocols is not None:
            self._protocols.close()

    # -- gathers (collective: every rank calls them) -------------------------

    def _gather_full(self, x):
        """(C_loc, n1_loc, N2, N3) slabs -> (n_chains, N1, N2, N3)."""
        lay = self.layout
        parts = [torch.empty_like(x) for _ in range(lay.rows * lay.n_grid)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat([torch.cat(parts[r * lay.n_grid:(r + 1) * lay.n_grid],
                                    dim=-3) for r in range(lay.rows)])

    def _gather_values(self, x):
        """(C_loc, ...) chain values -> (n_chains, ...)."""
        lay = self.layout
        parts = [torch.empty_like(x) for _ in range(lay.rows * lay.n_grid)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts[::lay.n_grid])

    def _gather_stats(self, stats: AttemptStats) -> AttemptStats:
        """(n_attempts, C_loc) records -> (n_attempts, n_chains)."""
        names = [f.name for f in dataclasses.fields(AttemptStats)]
        arrs = [getattr(stats, n) for n in names]
        packed = torch.as_tensor(np.stack([a.astype(np.float64)
                                           for a in arrs]),
                                 device=self.device).movedim(-1, 0)
        full = _host(self._gather_values(packed).movedim(0, -1))
        return AttemptStats(**{n: full[i].astype(a.dtype)
                               for i, (n, a) in enumerate(zip(names, arrs))})

    def _agree(self, flag: bool) -> bool:
        """True on every rank when it is True on any rank."""
        t = torch.tensor([int(flag)], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    # -- setup --------------------------------------------------------------

    def _write(self, name, field, write=True):
        if write and self.is_main:
            bio.write_array(self.dir / name, _host(field))

    def _dump_spectrum(self, name, field, write=True):
        km, pw, _ = fourier.measure_spectrum(field, self.g, self.conf.N_bin)
        km, pw = _host(km), _host(pw)
        if write and self.is_main:
            bio.dump_spectrum(self.dir / name, km, pw)
        return km, pw

    def setup(self, resume: bool = False):
        """Observations, halos, every chain's initial state and the mass.
        `resume`: the directory holds a session that restore() or
        restore_from_dumps() will go on with, so setup writes none of its
        mock or initial-guess dumps again (`Runner.setup`)."""
        conf, g, gp, lay = self.conf, self.g, self.gp, self.layout
        write = not resume
        fc = conf.model.forward
        power = load_power(conf, self.device)
        fc_mock = dataclasses.replace(fc, pallas_deposit=False)
        if conf.mock.random_test:
            md = mock_mod.generate(self.generator, g, conf.mock, fc_mock, gp,
                                   power, conf.model.likelihood,
                                   delta_min=conf.delta_min)
            mock_mod.validate(md, conf.model.likelihood)
            self.obs, self.truth = md.obs, md.truth_lag
            for name, f in (("deltaLAGtest", md.truth_lag),
                            ("deltaEULtest", md.truth_eul),
                            ("win", md.obs.window), ("nobs", md.obs.nobs),
                            ("sigma", md.obs.noise)):
                self._write(name, f, write)
            _, self._truth_spec = self._dump_spectrum("specLAGtest.dat",
                                                      md.truth_lag, write)
        else:
            read = lambda name: torch.as_tensor(
                bio.read_array(self.dir / name, g.shape), device=self.device)
            self.obs = ObsData(nobs=read("nobs"), window=read("win"),
                               noise=read("sigma"), power=power,
                               delta_min=conf.delta_min)
        self.obs_sh = sfw.shard_obs_chains(self.obs, lay)

        # halos: the measured displacement bound of the mock truth is the
        # exchange margin; with the tail split the kernels run at the
        # quantile halo (sharded_runner.py:180-205)
        if self.halo is None:
            self.halo = (tk.displacement_bound_cells(self.truth, g, fc, gp)
                         if self.truth is not None else sfw.suggest_halo(g))
        if fc.pallas_deposit and self.truth is not None and \
                fc.pallas_tail_k > 0 and fc.pallas_halo <= 0:
            fc = dataclasses.replace(fc, pallas_halo=(
                tk.displacement_halo_quantile(self.truth, g, fc, gp,
                                              fc.pallas_tail_k)))
            self.conf = conf = dataclasses.replace(
                conf, model=dataclasses.replace(conf.model, forward=fc))
        # the kernel path watches its kernel halo (or tail); the
        # windowless path its exchange margin, where it clamps (C4)
        self._monitor_violations = bool(fc.pallas_halo > 0 or
                                        not fc.pallas_deposit)

        # per-chain starts, drawn in global chain order on every rank
        if conf.initial_guess in (2, 3, 4):
            batch = torch.stack([initial_guess(conf, self.generator, power,
                                               self.dir)
                                 for _ in range(self.n_chains)])
        else:
            batch = initial_guess(conf, self.generator, power,
                                  self.dir).expand(
                (self.n_chains,) + g.shape).contiguous()
        self._write("initial_guess", batch[0], write)
        self._dump_spectrum("spec_initial_guess.dat", batch[0], write)
        ids = lay.chain_ids
        local = shard_real(batch[ids.start:ids.stop], lay).contiguous()

        self._vg = sfw.make_sharded_psi_vg_chains(g, conf.model, gp, lay,
                                                  halo=self.halo)
        (vals, aux), grads = self._vg(local, self.obs_sh)
        seeds = [conf.seed + 1 + c for c in ids]
        eps0 = [conf.hmc.eps_fac_start(g.N)] * len(ids)
        self.state = ss.init_chain_state(local, vals, aux, grads, seeds,
                                         eps0, conf.hmc)
        self._power = power
        self.mass_f = self._compute_mass_f(batch[0])
        self._run = ss.make_sharded_sampler(
            g, conf.model, gp, conf.hmc, lay, halo=self.halo,
            n_attempts_per_call=self.attempt_batch)
        self.digest = session_digest(self.obs, conf.model.forward.pallas_halo)
        return self

    def _compute_mass_f(self, signal=None):
        """The sharded FS mass spectrum; types 2/3 from the likelihood force
        at the dense chain-0 signal (default: the current one), the twin of
        Runner._compute_mass (sharded_runner.py:252-285)."""
        conf, g = self.conf, self.g
        if signal is None:
            signal = self._gather_full(self.state["delta"])[0]
        force = None
        if conf.hmc.mass_type in (2, 3):
            force = likelihood_force(conf, self.gp, self.obs, signal)
        mass = mass_mod.compute_mass(
            g, conf.hmc.mass_type, self._power, nbin=conf.N_bin,
            likeli_force=force, mass_factor=conf.hmc.mass_factor,
            window=self.obs.window, noise=self.obs.noise,
            kernel_h=kernel_h(conf.model.forward, g))
        return sfw.power_to_sharded_layout(mass.mass_f, self.layout)

    # -- outputs -------------------------------------------------------------

    def dump_sample(self, iteration: int, chain: int = 0,
                    fields: bool = True, spectrum: bool = True):
        """deltaLAG/EUL(/RSS) + powSpecit + protocol rows of one chain
        (sharded_runner.py:307-348); collective, rank 0 writes."""
        s = self._gather_full(self.state["delta"])[chain]
        acc_flags = self._gather_values(self.state["acc_flags"])[chain]
        psi_like = self._gather_values(self.state["psi_like"])[chain]
        if not self.is_main:
            return
        fc = self.conf.model.forward
        if fields:
            self._write(f"deltaLAG_{iteration}", s)
            with torch.no_grad():
                fwd = dataclasses.replace(fc, rsd=False, pallas_deposit=False)
                self._write(f"deltaEUL_{iteration}",
                            lag2eul(s, self.g, fwd, self.gp))
                if fc.rsd:
                    fwd = dataclasses.replace(fc, pallas_deposit=False)
                    self._write(f"deltaRSS_{iteration}",
                                lag2eul(s, self.g, fwd, self.gp))
            if self._monitor_violations:
                n = self._violations(s)
                if fc.pallas_deposit:
                    warn_violations(fc, n)
                elif n:
                    print(f"WARNING: {n} particles breach the slab exchange "
                          f"halo (halo={self.halo}) — the windowless deposit "
                          "clamps their mass into the edge rows; increase "
                          "--halo")
        if spectrum:
            km, pw = self._dump_spectrum(f"powSpecit{iteration}.dat", s)
            acc = float(_host(acc_flags).mean())
            resid = float(psi_like) / (self.g.N / 2.0)
            self._protocols.log_convergence(iteration, resid, acc)
            self._protocols.log_spectrum(iteration, km, pw, self._truth_spec)

    def _violations(self, s) -> int:
        """Contract violators of one dense signal: of the kernel halo (x/y)
        with the kernel deposit, of the exchange margin (x) without."""
        fc = self.conf.model.forward
        with torch.no_grad():
            pos = displaced_positions(s, self.g, dataclasses.replace(
                fc, rsd=False), self.gp)
            if fc.pallas_deposit:
                return int(tk.deposit_violations(pos, self.g, fc.pallas_halo))
            return int(sfw.slab_violations(pos, self.g, self.halo,
                                           self.layout.n_grid))

    # -- sampling loop -------------------------------------------------------

    def run(self, n_samples: int | None = None, max_attempts: int = 10**9,
            log: bool = True, progress_every: int = 10,
            rhat_stop: float | None = None, dashboard: bool | None = None,
            nan_check: bool = False):
        """Sample until every chain holds >= n_samples accepted samples, with
        the loop surface of Runner.run (sharded_runner.py:352-460).  Every
        rank calls it; decisions are taken on gathered values."""
        conf = self.conf
        n_samples = n_samples if n_samples is not None else conf.N_Gibbs
        attempts = 0
        if self.metrics is None:
            self.metrics = SamplerMetrics()
        dash = Dashboard(title=f"barcode_tpu_torch sharded  N={self.g.N1}  "
                         f"layout={self.layout.shape}",
                         force=dashboard if self.is_main else False)
        rhat = float("inf")
        while attempts < max_attempts:
            if self._agree((self.dir / "fastexit").exists()):
                if self.is_main:
                    print("fastexit sentinel found — stopping cleanly")
                break
            self.state, stats = self._run(self.state, self.obs_sh,
                                          self.mass_f)
            attempts += self.attempt_batch
            all_stats = self._gather_stats(stats)
            self.metrics.update(all_stats)
            self._psi_trace.append(_host(self._gather_values(
                self.state["psi"])))
            self._trace_t.append(time.time())
            if nan_check:
                check_finite({k: v for k, v in self.state.items()
                              if k != "seed"}, f"after attempt {attempts}")
            if log and self.is_main:  # rank 0 holds chain 0
                self._perflog = append_perflog(self._perflog, self.dir,
                                               stats)
            accepted = _host(self._gather_values(self.state["accepted"]))
            acc0 = int(accepted[0])
            # mass recompute cadence (HMC.cc:387-424): only the
            # signal-dependent likelihood-force masses change
            if conf.hmc.mass_type in (2, 3):
                burned = acc0 >= conf.hmc.s_eps_total(self.g.N)
                cadence = (conf.hmc.massnum_post if burned
                           else conf.hmc.massnum_burn)
                if cadence > 0 and acc0 - self._mass_at_sample >= cadence:
                    self.mass_f = self._compute_mass_f()
                    self._mass_at_sample = acc0
            for i in range(self._dump_cursor + 1, min(acc0, n_samples) + 1):
                wf = i <= 10 or (conf.outnum > 0 and i % conf.outnum == 0)
                wp = i <= 10 or (conf.outnum_ps > 0
                                 and i % conf.outnum_ps == 0)
                if wf or wp:
                    self.dump_sample(i, fields=wf, spectrum=wp)
            self._dump_cursor = max(self._dump_cursor, min(acc0, n_samples))
            min_acc = int(accepted.min())
            # itmax stall guard (HMC.cc:431): FS masses are signal-free, so
            # the security_recursion mass recompute is a no-op here — warn
            if conf.hmc.itmax > 0:
                if min_acc > self._stall_acc:
                    self._stall_acc, self._stall_attempts = min_acc, 0
                else:
                    self._stall_attempts += self.attempt_batch
                    if self._stall_attempts >= conf.hmc.itmax:
                        if log and self.is_main:
                            print(f"itmax={conf.hmc.itmax} attempts without "
                                  "an accepted sample — continuing "
                                  "(security_recursion semantics)")
                        self._stall_attempts = 0
            eps_all = self._gather_values(self.state["eps_fac"])
            if dash.enabled:
                dash.update(all_stats, SimpleNamespace(
                    eps_fac=eps_all, accepted=torch.as_tensor(accepted)),
                    self.metrics.summary(),
                    extra=f"rhat={rhat:.3f}" if np.isfinite(rhat) else "")
            elif log and self.is_main and \
                    attempts % (self.attempt_batch * progress_every) == 0:
                print(self.metrics.status_line(
                    f"acc_min={min_acc} eps_fac="
                    f"{float(_host(eps_all).mean()):.4g}"))
            if min_acc >= n_samples:
                break
            if rhat_stop is not None and len(self._psi_trace) >= 8 \
                    and min_acc >= 1:
                trace = np.stack(self._psi_trace, axis=1)
                rhat = split_rhat(trace[:, trace.shape[1] // 2:])
                if rhat < rhat_stop:
                    if log and self.is_main:
                        print(f"converged: split R-hat {rhat:.4f} < "
                              f"{rhat_stop} after {attempts} attempts")
                    break
            if conf.hmc.total_steps_lim and \
                    attempts >= conf.hmc.total_steps_lim:
                raise RuntimeError("ABORTING: total steps exceeds "
                                   "total_steps_lim (HMC.cc:533-535)")
        return self.state

    def diagnostics(self) -> dict:
        """Throughput metrics + cross-chain split R-hat / ESS of the psi
        traces (sharded_runner.py:462-490); collective."""
        out = dict(self.metrics.summary()) if self.metrics is not None else {}
        if self.state is not None:
            out["acc_rate_recent"] = float(_host(self._gather_values(
                self.state["acc_flags"])).mean())
            out["eps_fac"] = _host(self._gather_values(
                self.state["eps_fac"])).tolist()
            out["accepted_per_chain"] = _host(self._gather_values(
                self.state["accepted"])).tolist()
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

    # -- checkpoint / resume -------------------------------------------------

    def checkpoint(self, path=None):
        """Gather every chain's full state to rank 0 and write
        checkpoint_sharded.npz (+ .json: dump cursor, seed, mass marker,
        the session's digest); then the restart marker.  Collective."""
        path = Path(path or (self.dir / "checkpoint_sharded.npz"))
        arrs = {}
        for k, v in self.state.items():
            full = self._gather_full(v) if k in ss.GRID_FIELDS else \
                self._gather_values(v)
            arrs[f"state_{k}"] = _host(full)
        if self.is_main:
            np.savez(path, **arrs)
            path.with_suffix(".json").write_text(json.dumps(
                {"dump_cursor": self._dump_cursor, "seed": self.conf.seed,
                 "mass_at_sample": self._mass_at_sample, **self.digest}))
            self._protocols.write_restart_marker(
                int(arrs["state_accepted"].min()))
        dist.barrier()
        return path

    def restore(self, path=None):
        """Load a checkpoint written by `checkpoint` (after setup()); each
        rank takes its chains and slabs.  A ValueError refuses a setup whose
        observations or resolved pallas_halo differ from the session's, as
        `Runner.restore` does (a checkpoint without the digest is not
        checked)."""
        path = Path(path or (self.dir / "checkpoint_sharded.npz"))
        data = np.load(path)
        meta = json.loads(path.with_suffix(".json").read_text())
        check_session(meta, self.digest, path)
        state = {k[len("state_"):]: data[k] for k in data.files
                 if k.startswith("state_")}
        if len(state["psi"]) != self.n_chains:
            raise ValueError(f"{path} holds {len(state['psi'])} chains, the "
                             f"layout {self.layout.shape} runs "
                             f"{self.n_chains}")
        self.state = ss.shard_chain_state(state, self.layout)
        self._dump_cursor = int(meta["dump_cursor"])
        self._mass_at_sample = int(meta.get("mass_at_sample", 0))
        return self

    def restore_from_dumps(self, iteration: int):
        """File-based restart without a checkpoint (main.cc:121-131;
        sharded_runner.py:499-534): chain 0 resumes the dumped
        deltaLAG_<iteration> exactly, the other chains keep their setup
        guesses; psi and grads are recomputed through the sharded posterior;
        the adaptive-eps state is replayed from performance_log.txt.  A
        ValueError refuses a setup whose observations differ from the dumped
        ones."""
        check_session(dumped_digest(self.dir, self.g), self.digest, self.dir)
        s0 = torch.as_tensor(bio.read_array(self.dir / f"deltaLAG_{iteration}",
                                            self.g.shape), device=self.device)
        delta = self.state["delta"].clone()
        if self.layout.row == 0:
            delta[0] = shard_real(s0, self.layout)
        (vals, (pp, pl)), grads = self._vg(delta, self.obs_sh)
        nc, dev = delta.shape[0], self.device
        state = dict(self.state)
        state.update(delta=delta, psi=vals, psi_prior=pp, psi_like=pl,
                     grad=grads, accepted=torch.full((nc,), iteration,
                                                     dtype=torch.int32,
                                                     device=dev))
        rep = replay_perflog(self.dir, self.conf.hmc, self.g.N)
        if rep is not None:
            def per_chain(x, dtype):
                x = torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
                return x.expand((nc,) + x.shape).clone()

            state.update(
                eps_fac=per_chain(rep["eps_fac"], torch.float32),
                acc_flags=per_chain(rep["acc_flags"], torch.int32),
                eps_table=per_chain(rep["eps_table"], torch.float32),
                count_attempts=per_chain(rep["count_attempts"], torch.int32),
                rejections=per_chain(rep["rejections"], torch.int32),
                got_first_accept=per_chain(rep["got_first_accept"],
                                           torch.bool))
        self.state = state
        self._dump_cursor = iteration
        return self
