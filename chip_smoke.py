#!/usr/bin/env python3
"""Smoke run of barcode_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Drives the port's three paths and checks the CUDA kernels on the way.
Every windowed deposit on the card runs the shared-memory kernel
csrc/tsc_deposit_tiled.cu (K1 dense, K3 slab), and every gather the
shared-memory kernel csrc/tsc_gather_tiled.cu (K2 dense, K4 slab); the
earlier kernels (push: csrc/tsc_deposit.cu, csrc/tsc_deposit_slab.cu;
pull, the streamed K1s: csrc/tsc_deposit_stream.cu; thread:
csrc/tsc_gather.cu, csrc/tsc_gather_slab.cu) stay built as witnesses,
reached only with `impl=`: each check holds the tiled kernels against them
bit for bit, the timing phase times them beside them, and their launch
counters must read 0 on every path.  The paths:
  * the 128^3 headline configuration (bench.py:60-155: ALPT +
    plane-parallel RSD, sph_ft, Gaussian likelihood, mass type 1,
    N_eps_fac=8, the kernel deposit with the halo-tail split) through
    `Runner(conf).setup(n_chains=2)` and one bounded `run`;
  * the same model at 256^3 (bench.py's BENCH_N=256, box 200) as users run
    it, through the command line `python -m barcode_tpu_torch input.par`:
    a session, a resume from checkpoint.npz and a restart from the dumps;
  * the slab-sharded mode at 256^3 through `python -m barcode_tpu_torch
    input.par --sharded`: one rank over NCCL, the slab deposit K3 and its
    gather K4, the sharded FFTs and the ring exchange;
  * the headline configuration with radial RSD about a box corner through
    `Runner` at 128^3 (K1 and K2 on positions outside the box);
  * the reference's own data/input.par model (Zel'dovich, the SPH mass
    kernel, Gaussian likelihood, adaptive step size) at 128^3 through the
    command line: windowless deposits, no kernel launch.

Phases:
  1. device       card name, count and `nvidia-smi` name/power limit
  2. build        nvcc build of csrc/*.cu (sm_90a) and its ptxas report;
                  the shared-memory atomics in the tiled deposit's SASS,
                  whether a 64-bit shared-memory add is native on sm_90a,
                  the tiled deposit's resident blocks per SM, the tiled
                  gather's registers and spills (none allowed) and its
                  resident blocks per SM
  3. determinism  the windowless and tail-split deposits (fixed point) give
                  the same bits on every call at 128^3
  4. kernels      K1 (deposit) and K2 (gather) against their plain PyTorch
                  versions at 32^3 with forced contract violators and at the
                  headline 128^3 shapes with 2 chains; K1 equals the push
                  and pull witnesses and itself, K2 its thread witness and
                  itself (with and without the value), bit for bit; the
                  share of K2's taps outside its tiles' boxes
  5. psi          psi and grad psi at 128^3 on the card (kernels) and on the
                  CPU (plain versions) from the same delta
  6. path         the 128^3 Runner session, with the kernel launch counters
                  set to 0 just before it and checked against the expected
                  count after (K1 also runs in the deltaEUL/deltaRSS dumps)
  7. kernels256   K1 at the 256^3 shapes (where the JAX package's gate
                  streams: K1s on the TPU) against its plain version, the
                  push and pull witnesses and itself, and with forced
                  violators at 32^3 where the window is wider than the grid;
                  K2 against its plain version, its witness and itself at
                  the 256^3 shapes
  8. psi256       psi and grad psi at 256^3 (one chain), card against CPU
  9. cli256       three command-line calls at 256^3 (session; --resume with
                  --profile; restart from deltaLAG_2 + the performance log),
                  each with the launch counters zeroed before it and checked
                  after; the profile's top kernels by device time; K1 against
                  the witnesses at the chains' positions after the calls
  6b. masskernels the windowless deposits of every mass kernel (NGP, CIC,
                  TSC, SPH, sph_ft) on the 128^3 truth's positions, with and
                  without weights: the same bits on 3 calls, mass conserved,
                  values and position gradients against the CPU, forward
                  and forward+backward times and launches per call
  6c. options     psi and grad psi at 128^3, card against CPU: radial RSD
                  through the kernel deposit (K1/K2 also against their plain
                  versions on positions outside the box), 2LPT with 'findif'
                  derivatives, ALPT with TRANSF kernels from the EH98 table,
                  NGP with mass type 2 (a zero likelihood force); the
                  resolution-independent GRF's shared modes at 64^3 and 128^3
  6d. radial_path the 128^3 Runner session with radial RSD, launch counters
                  checked as in `path`
  6e. sph_cli     three command-line calls of the reference's input.par model
                  at 128^3 (session; --resume; restart from deltaLAG_2), every
                  kernel counter at 0
 10. spectrum_determinism
                  measure_spectrum at 128^3 gives the same bits in 5 calls
                  (the float index_add_ form it replaced, measured beside);
                  mass types 0, 2, 3 and 5 built on the card
 11. slab_kernels K3 and K4 against their plain versions at 32^3 (violators,
                  windows wider than the slab) and at the 256^3 one-rank
                  shapes; K3 against its push witness and K4 against its
                  thread witness, each against itself, bit for bit; per-slab
                  K3/K4 at 128^3 for 2 and 4 slabs on one card against K1/K2
                  (K4 also against its witness and itself)
 12. sharded_psi256
                  sharded psi and grad psi at 256^3, one rank over NCCL,
                  against the dense psi on the card
 13. sharded_cli256
                  three `--sharded` command-line calls at 256^3 (session;
                  --resume; restart from deltaLAG_2 without
                  checkpoint_sharded.npz), launch counters checked
 14. timing       CUDA-event times of each kernel at its path's shapes, the
                  witnesses beside the tiled kernels on the same inputs; K1
                  and K2 also at the chains' positions after the 256^3
                  session, checked there against their witnesses first

Every phase raises on failure, so any failure exits non-zero.  It needs a
card: without one (or without the package beside it) it exits non-zero
before printing any result.  Output dumps go to a temporary directory
outside the checkout; only the git-ignored kernel build directory is
written inside it.  The command-line calls run in-process through the
stages that `cli.main` chains (`parse_args`, `open_session`,
`run_session`), so that the launch counters stay readable, the setup is
timed apart from the run, and the restarted state can be checked before it
samples.  The last line is the JSON result {"ok": true, "device": {...}};
the line before it lists the kernels.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from barcode_tpu_torch import cli, cosmo as cosmo_mod, cuda_build
from barcode_tpu_torch import io as bio, random_fields
from barcode_tpu_torch.config import HMCConfig, RunConfig
from barcode_tpu_torch.forward import assign, transfer
from barcode_tpu_torch.forward import tsc_kernels as tk
from barcode_tpu_torch.forward.lag2eul import (ForwardConfig,
                                               displaced_positions, lag2eul)
from barcode_tpu_torch.grid import fourier
from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.hmc import mass as mass_mod
from barcode_tpu_torch.model import likelihoods
from barcode_tpu_torch.model.posterior import ModelConfig, make_psi_value_and_grad
from barcode_tpu_torch.parallel import distributed as pdist
from barcode_tpu_torch.parallel import sharded_forward as sfw
from barcode_tpu_torch.parallel.sharded_fft import shard_real
from barcode_tpu_torch.runner import Runner, likelihood_force

BUDGET_S = 900.0          # hard stop; the run aims at half of its 1200 s
N_GRID, BOX = 128, 200.0  # headline configuration (bench.py:60-155)
N_BIG = 256               # bench.py's BENCH_N=256 (same box)
N_CHAINS = 2
ATTEMPT_BATCH = 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS_PER_S = 67e12    # H100 SXM, float32 outside the tensor cores
# float32 operations per particle of each kernel's arithmetic on one chain:
# K1: 3 axes x (base/frac ~5 + 3 weights ~8) + 9 xy products + 27 x (one
#     weight product, one mass product, one add) = 120
# K2: 3 axes x (base/frac ~5 + 3 weights + 3 derivatives ~14) + 27 taps x
#     2 FMAs (4 flops) + 9 xy pairs x 4 channels x 3 flops + 3 divides = 276
OPS_K1, OPS_K2 = 120, 276
# K3 and K4 do K1's and K2's arithmetic per particle (the slab geometry only
# moves integer offsets)
OPS_K3, OPS_K4 = OPS_K1, OPS_K2
# tolerances: K1/K2 sum their taps in another order than the plain versions
# (K1 exactly, in fixed point; the plain version in float32), relative to the
# field's magnitude as in the JAX package's kernel tests (2e-6 on O(1)
# densities, 3e-5 * max on gradients)
TOL_DEP_REL, TOL_GATHER_REL = 2e-6, 3e-5
# psi: a float32 sum of N^3 terms (cuFFT vs pocketfft); grad psi:
# ~30 float32 transforms through ALPT, compared as a relative L2 norm
TOL_PSI_REL, TOL_GRAD_REL = 2e-5, 1e-3


def headline_conf(n_grid: int = N_GRID, seed: int = 1) -> RunConfig:
    """The headline configuration; n_grid < 128 keeps the cell size (for
    rehearsals of this script's control flow on the CPU)."""
    g = GridSpec.cube(n_grid, BOX * n_grid / N_GRID)
    fc = ForwardConfig(sfmodel=3, masskernel="sph_ft", rsd=True, slength=4.0,
                       pallas_deposit=True, pallas_halo=0,
                       pallas_tail_k=max(g.N // 2048, 1024))
    hc = HMCConfig(eps_fac=1e-4, eps_fac_update_type=0, mass_type=1,
                   N_eps_fac=8, N_a_eps_update=32)
    return RunConfig(grid=g, model=ModelConfig(likelihood=1, forward=fc),
                     hmc=hc, readPS=False, seed=seed)


class Clock:
    """Wall clock of the whole run with a per-phase budget check."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.phase_t0 = self.t0

    def start(self, name: str):
        self.name = name
        self.phase_t0 = time.perf_counter()
        print(f"== phase {name}", flush=True)

    def done(self):
        now = time.perf_counter()
        total = now - self.t0
        print(f"== phase {self.name} done in {now - self.phase_t0:.2f} s "
              f"(total {total:.1f} s of {BUDGET_S:.0f} s budget)", flush=True)
        if total > BUDGET_S:
            raise RuntimeError(f"over the wall-clock budget after {self.name}")


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, n: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def compare(name, out, ref, tol_rel):
    """max |out - ref| against tol_rel * max(1, max|ref|); raises."""
    err = (out - ref).abs().max().item()
    tol = tol_rel * max(1.0, ref.abs().max().item())
    ok = err <= tol and bool(torch.isfinite(out).all())
    print(f"  {name}: max|diff| {err:.3e} (tol {tol:.3e}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError(f"{name} disagrees with its plain version")
    return err


def violator_positions(g: GridSpec, chains: int, n_viol: int, dev,
                       jitter: float = 0.8):
    """Jittered lattice with n_viol particles per chain pushed 4.2 cells in x
    and -3.6 in y: violators of a halo-3 contract."""
    gen = torch.Generator(device=dev).manual_seed(3)
    d = torch.tensor(g.cell, device=dev).reshape(3, 1, 1, 1)
    idx = torch.stack(torch.meshgrid(*[torch.arange(n, device=dev)
                                       for n in g.shape], indexing="ij"))
    pos = (idx + 0.5) * d + jitter * d * torch.randn(
        (chains, 3) + g.shape, generator=gen, device=dev)
    sel = torch.rand((chains,) + g.shape, generator=gen, device=dev) \
        < n_viol / g.N
    pos[:, 0] += sel * 4.2 * d[0]
    pos[:, 1] -= sel * 3.6 * d[1]
    L = torch.tensor([g.L1, g.L2, g.L3], device=dev).reshape(3, 1, 1, 1)
    return torch.remainder(pos, L).contiguous()


def check_same(label, gather):
    """A gather (`gather(impl)`) equal bit for bit to its thread witness
    (the earlier kernel) and to itself from call to call; returns the
    tiled output."""
    out, again, thread = gather("tiled"), gather("tiled"), gather("thread")
    same = {"thread": torch.equal(out, thread),
            "itself": torch.equal(out, again)}
    print(f"  {label}: == " + ", == ".join(f"{k} {v}"
                                           for k, v in same.items()))
    if not all(same.values()):
        raise RuntimeError(f"{label} differs from its witness or itself")
    return out


def print_taps_outside_box(label, field, pos, g, halo, block, slab=None):
    """The share of the tiled gather's taps that read device memory (their
    particle's stencil leaves its tile's box); None off the card."""
    if pos.device.type != "cuda":
        return None
    outside, total = tk.gather_taps_outside_box(field, pos, g, halo, block,
                                                slab)
    print(f"  {label}: {outside} of {total} taps outside the box "
          f"({outside / max(total, 1):.4f})")
    return outside / max(total, 1)


def check_gather(cot, pos, g, halo, block, label=""):
    """K2 with and without the value against its plain version, its thread
    witness and itself; returns the errors keyed "K2 value=<want_value>"."""
    errs = {}
    for want_value in (False, True):
        out = check_same(
            f"K2{label} want_value={want_value}",
            lambda impl: tk.tsc_gather_grads_window(
                cot, pos, g, halo, block, want_value, impl=impl))
        sync(pos.device)
        ref = tk.tsc_gather_grads_window_plain(cot, pos, g, halo, block,
                                               want_value)
        errs[f"K2 value={want_value}"] = compare(
            f"K2{label} want_value={want_value}", out, ref, TOL_GATHER_REL)
    print_taps_outside_box(f"K2{label}", cot, pos, g, halo, block)
    return errs


def check_witnesses(label, g, pos, halo, block, weights):
    """K1 (the tiled kernel) against its plain version (tolerance), and
    against the push and pull witnesses and itself (bit for bit); returns
    its error."""
    out = tk.tsc_deposit_window(pos, g, halo, block, weights=weights)
    again = tk.tsc_deposit_window(pos, g, halo, block, weights=weights)
    push = tk.tsc_deposit_window(pos, g, halo, block, weights=weights,
                                 impl="push")
    pull = tk.tsc_deposit_window(pos, g, halo, block, weights=weights,
                                 impl="pull")
    sync(pos.device)
    ref = tk.tsc_deposit_window_plain(pos, g, halo, block, weights=weights)
    err = compare(f"K1 {label} vs plain", out, ref, TOL_DEP_REL)
    same = {"push": torch.equal(out, push), "pull": torch.equal(out, pull),
            "itself": torch.equal(out, again)}
    print(f"  K1 {label}: == " + ", == ".join(f"{k} {v}"
                                             for k, v in same.items()))
    if not all(same.values()):
        raise RuntimeError(f"K1 {label} differs from a witness or itself")
    return err


def check_kernels(label, g, pos, halo, block_dep, block, weights, cot):
    """K1 (unweighted + weighted; against the plain version, the witnesses
    and itself) and K2 (with and without the value) against the plain
    versions; returns the errors of the main-path calls."""
    print(f"  [{label}] grid {g.shape}, chains {pos.shape[0]}, halo {halo}, "
          f"K1 block {block_dep}, K2 block {block}, violators "
          f"{tk.deposit_violations(pos, g, halo).tolist()}", flush=True)
    errs = {f"K1 {tag}": check_witnesses(f"{label} {tag}", g, pos, halo,
                                         block_dep, w)
            for w, tag in ((None, "unweighted"), (weights, "weighted"))}
    errs.update(check_gather(cot, pos, g, halo, block, f" {label}"))
    return errs


def float_scatter(n_out: int, idx, w):
    """A float index_add_, the form the windowless and tail deposits had
    before they summed in fixed point: on the card its atomics add in an
    order that changes from call to call."""
    out = torch.zeros(n_out, dtype=w.dtype, device=w.device)
    return out.index_add_(0, idx.reshape(-1), w.reshape(-1))


def float_windowless_deposit(pos, g: GridSpec):
    """assign.tsc_deposit's 27 taps, summed with float_scatter."""
    base, dx = assign._tsc_base_frac(pos, g)
    bx, by, bz = base.unbind(-4)
    c0 = assign._batch_flat_offsets(tuple(pos.shape[:-4]), g.N, pos.device, 3)
    idx, w = [], []
    for wk, (ox, oy, oz) in zip(assign._tsc_weights(dx), assign._TSC_OFFSETS):
        idx.append(c0 + (((bx + ox) % g.N1) * g.N2 + (by + oy) % g.N2) * g.N3
                   + (bz + oz) % g.N3)
        w.append(wk)
    return float_scatter(pos.shape[0] * g.N, torch.stack(idx), torch.stack(w))


def float_tail_deposit(pos, g: GridSpec, halo: int, tail_k: int):
    """The tail particles' deposit of the split, summed with float_scatter."""
    excess = assign._halo_excess(pos, g, halo, halo)
    vals, ix = assign._compact_topk(excess.flatten(-3), tail_k)
    pos_k = torch.gather(pos.flatten(-3), -1,
                         ix.unsqueeze(-2).expand(ix.shape[:-1] + (3, -1)))
    idx, w, _ = assign._tail_base_weights(pos_k, vals > 0.0, g)
    c0 = assign._batch_flat_offsets(tuple(pos.shape[:-4]), g.N, pos.device, 2)
    return float_scatter(pos.shape[0] * g.N, idx + c0, w)


def spread(fn, repeats: int = 5) -> float:
    """max |difference| between repeated calls of fn."""
    ref = fn()
    return max((fn() - ref).abs().max().item() for _ in range(repeats))


def phase_determinism(dev):
    """The windowless deposit (mock data, mass-2/3 force) and the tail-split
    deposit sum in 64-bit fixed point: the same bits on every call, where a
    float index_add_ on the card sums in a new order each time (measured
    beside them, on the same inputs)."""
    g = GridSpec.cube(N_GRID, BOX)
    pos = violator_positions(g, N_CHAINS, 0, dev)
    rho = assign.tsc_deposit(pos, g)
    sp = spread(lambda: assign.tsc_deposit(pos, g))
    sp_float = spread(lambda: float_windowless_deposit(pos, g))
    print(f"  tsc_deposit {g.N1}^3, {N_CHAINS} chains (max "
          f"{rho.abs().max().item():.3f}): max|diff| over 5 repeats "
          f"{sp:.3e}; as a float index_add_ {sp_float:.3e}")
    # 300 particles per chain piled into a few cells: tail violators of a
    # halo-5 contract that share their cells
    pos = violator_positions(g, N_CHAINS, 0, dev, jitter=0.3)
    gen = torch.Generator(device=dev).manual_seed(7)
    sel = torch.zeros((N_CHAINS, g.N), dtype=torch.bool, device=dev)
    sel[:, torch.randperm(g.N, generator=gen, device=dev)[:300]] = True
    pile = torch.tensor([10.3, 20.1, 30.7], device=dev).reshape(3, 1, 1, 1)
    pos = torch.where(sel.reshape((N_CHAINS, 1) + g.shape),
                      pile + 0.01 * torch.randn(pos.shape, generator=gen,
                                                device=dev), pos).contiguous()
    n_viol = (assign._halo_excess(pos, g, 5, 5) > 0).sum((1, 2, 3)).tolist()
    dep = assign.make_tsc_deposit_fast(g, halo=5, tail_k=1024)
    rho_t = dep(pos)
    sp_t = spread(lambda: dep(pos))
    sp_t_float = spread(lambda: float_tail_deposit(pos, g, 5, 1024))
    print(f"  tail-split deposit {g.N1}^3, violators per chain {n_viol} "
          f"(max {rho_t.abs().max().item():.3f}): max|diff| over 5 repeats "
          f"{sp_t:.3e}; its tail as a float index_add_ {sp_t_float:.3e}")
    compare("tail split vs windowless deposit", rho_t,
            assign.tsc_deposit(pos, g), TOL_DEP_REL)
    if min(n_viol) <= 100 or max(n_viol) > 1024:
        raise RuntimeError(f"expected 100 < violators <= 1024, got {n_viol}")
    if sp != 0.0 or sp_t != 0.0:
        raise RuntimeError("a deposit is not deterministic on the card")


def phase_kernels(dev, conf: RunConfig, tmp: str):
    """K1/K2 against their plain versions at 32^3 with violators and at the
    headline shapes; returns the headline inputs and their errors."""
    g32 = GridSpec.cube(32, 32 * BOX / N_GRID)
    pos32 = violator_positions(g32, N_CHAINS, 200, dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    w32 = torch.rand((N_CHAINS,) + g32.shape, generator=gen, device=dev)
    cot32 = torch.randn((N_CHAINS,) + g32.shape, generator=gen, device=dev)
    check_kernels("32^3 violators", g32, pos32, 3, (16, 16), (8, 8), w32, cot32)

    runner = Runner(conf, out_dir=tmp, device=dev)
    runner.setup(n_chains=N_CHAINS)
    g, gp, fc = runner.g, runner.gp, runner.conf.model.forward
    block = tuple(fc.pallas_block)
    block_dep = assign.auto_block_dep(g, fc.pallas_halo, block)
    delta = torch.stack([runner.truth, 0.5 * runner.truth])
    with torch.no_grad():
        pos = displaced_positions(delta, g, fc, gp).contiguous()
    hx, hy = tk._halo_pair(fc.pallas_halo)
    ok = (assign._halo_excess(pos, g, hx, hy) <= 0.0).float()
    cot = torch.randn((N_CHAINS,) + g.shape, generator=gen, device=dev)
    errs = check_kernels(f"{g.N1}^3 headline", g, pos, fc.pallas_halo,
                         block_dep, block, ok, cot)
    print(f"  tail split: halo {fc.pallas_halo}, tail_k {fc.pallas_tail_k}, "
          f"violators per chain {(ok == 0).sum((1, 2, 3)).tolist()}")
    inputs = dict(g=g, pos=pos, ok=ok, cot=cot, halo=fc.pallas_halo,
                  block=block, block_dep=block_dep)
    return runner, delta, inputs, errs


def phase_psi(runner: Runner, delta):
    """psi and grad psi from the same delta: kernels on the card, plain
    versions on the CPU."""
    g, gp, mc = runner.g, runner.gp, runner.conf.model
    t0 = time.perf_counter()
    (psi_d, _), grad_d = make_psi_value_and_grad(g, mc, gp, runner.obs)(delta)
    sync(delta.device)
    t1 = time.perf_counter()
    vag_cpu = make_psi_value_and_grad(g, mc, gp, runner.obs.to("cpu"))
    (psi_c, _), grad_c = vag_cpu(delta.cpu())
    print(f"  {g.N1}^3, {delta.shape[0]} chain(s): card {t1 - t0:.3f} s "
          f"(first call), CPU {time.perf_counter() - t1:.1f} s")
    psi_err = ((psi_d.cpu() - psi_c).abs() / psi_c.abs()).max().item()
    grad_err = max((torch.linalg.vector_norm(grad_d[c].cpu() - grad_c[c])
                    / torch.linalg.vector_norm(grad_c[c])).item()
                   for c in range(delta.shape[0]))
    print(f"  psi device {psi_d.tolist()} cpu {psi_c.tolist()}")
    print(f"  psi rel err {psi_err:.3e} (tol {TOL_PSI_REL:.0e}); grad psi "
          f"rel L2 err {grad_err:.3e} (tol {TOL_GRAD_REL:.0e})")
    if not (psi_err <= TOL_PSI_REL and grad_err <= TOL_GRAD_REL
            and bool(torch.isfinite(grad_d).all())):
        raise RuntimeError("psi / grad psi on the device disagree with the CPU")


def phase_path(dev, conf: RunConfig, tmp: str):
    """Runner setup + one bounded run; launch counters zeroed just before
    and checked just after.  Returns (launches, launches per attempt)."""
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t_setup = time.perf_counter()
    runner = Runner(conf, out_dir=tmp, device=dev)
    runner.attempt_batch = ATTEMPT_BATCH
    runner.setup(n_chains=N_CHAINS)
    sync(dev)
    t_run = time.perf_counter()
    states = runner.run(n_samples=10**6, max_attempts=ATTEMPT_BATCH, log=True,
                        nan_check=True)
    sync(dev)
    t_end = time.perf_counter()
    launches = read_launches()
    hc = runner.conf.hmc
    attempts = int(states.count_attempts[0])
    grads_per_step = 2 if hc.integrator == "minimal_norm_2" else 1
    steps = attempts * hc.N_eps_fac  # masked steps, all chains batched
    # each dumped deltaEUL_<i>/deltaRSS_<i> is one forward through K1
    n_dumps = sum(len(list(runner.dir.glob(f"{name}_*")))
                  for name in ("deltaEUL", "deltaRSS"))
    per_attempt = {"K1": grads_per_step * hc.N_eps_fac,
                   "K2": grads_per_step * hc.N_eps_fac}
    # kernels launch only where they are on the CUDA device
    on_card = dev.type == "cuda"
    expected = dict.fromkeys(KERNEL_LAUNCHERS, 0)
    if on_card:
        expected.update(K1=1 + grads_per_step * steps + n_dumps,
                        K2=1 + grads_per_step * steps)
    s = runner.metrics.summary()
    finite = bool(torch.isfinite(states.psi).all())
    print(f"  halo {runner.conf.model.forward.pallas_halo}, attempts "
          f"{attempts} per chain x {N_CHAINS} chains, leapfrog steps {steps} "
          f"(each over all chains)")
    print(f"  setup {t_run - t_setup:.2f} s, run {t_end - t_run:.3f} s: "
          f"{steps / (t_end - t_run):.3f} steps/s, "
          f"{N_CHAINS * steps / (t_end - t_run):.3f} chain-steps/s")
    print(f"  acceptance {s['acc_rate']:.3f} ({s['accepted']}/{s['attempts']})"
          f", psi finite {finite}: {states.psi.tolist()}")
    print(f"  launches {launches}, expected {expected} (init + one per "
          f"leapfrog gradient; K1 also one per dumped field: {n_dumps})")
    if dev.type == "cuda":
        print(f"  max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print(f"  dumps: {len(list(runner.dir.iterdir()))} files in a temporary "
          f"directory")
    runner.close()
    if not finite:
        raise RuntimeError("non-finite psi after the run")
    if launches != expected or (on_card and 0 in (launches["K1"],
                                                  launches["K2"])):
        raise RuntimeError(f"kernel launches {launches} != {expected}")
    return launches, per_attempt


INPUT_PAR_256 = """\
# bench.py's model at BENCH_N=256 (box 200), as a session's input.par
Nx = {n}
Lx = {box}
sfmodel = 3
masskernel = sph_ft
rsd_model = true
slength = 4.0
likelihood = 1
N_eps_fac = 8
eps_fac = 0.0001
eps_fac_update_type = 0
mass_type = 1
N_a_eps_update = 32
pallas_deposit = true
pallas_halo = 0
pallas_tail_k = {tail_k}
readPS = false
seed = 1
"""


def write_input_par(tmp: str) -> Path:
    """The 256^3 configuration's input.par (N_BIG < 256 keeps the cell size,
    for rehearsals of this script's control flow on the CPU)."""
    n = N_BIG
    path = Path(tmp) / "input.par"
    path.write_text(INPUT_PAR_256.format(n=n, box=BOX * n / N_BIG,
                                         tail_k=max(n**3 // 2048, 1024)))
    return path


def phase_kernels256(dev, conf: RunConfig, tmp: str):
    """K1 at the 256^3 configuration's shapes: its displaced positions
    (the mock truth and half of it, through the forward model), its
    resolved halo and block, with and without the tail weights, against
    its plain version, the witnesses and itself; K2 on the same positions
    at the path's gather block; then K1 at 32^3 with block (16, 16), hx 12
    and forced violators (WX = 40 > 32)."""
    runner = Runner(conf, out_dir=tmp, device=dev)
    runner.setup(n_chains=N_CHAINS)
    g, gp, fc = runner.g, runner.gp, runner.conf.model.forward
    halo = fc.pallas_halo
    block_dep = assign.auto_block_dep(g, halo, tuple(fc.pallas_block))
    delta = torch.stack([runner.truth, 0.5 * runner.truth])
    with torch.no_grad():
        pos = displaced_positions(delta, g, fc, gp).contiguous()
    hx, hy = tk._halo_pair(halo)
    ok = (assign._halo_excess(pos, g, hx, hy) <= 0.0).float()
    eff = (tk._round_halo(hx, block_dep[0]), hy)
    chosen = {w: tk.stream_selected(g, eff, block_dep, w) for w in (False, True)}
    print(f"  {g.N1}^3: halo {halo} (effective {eff}), block {block_dep}, "
          f"tail_k {fc.pallas_tail_k}, violators per chain "
          f"{(ok == 0).sum((1, 2, 3)).tolist()}; working set weighted "
          f"{tk.deposit_working_set_bytes(g, eff, block_dep, True)} B, "
          f"unweighted {tk.deposit_working_set_bytes(g, eff, block_dep)} B "
          f"against {tk.DEP_VMEM_BUDGET} B: the JAX package streams (K1s) "
          f"weighted {chosen[True]}, unweighted {chosen[False]}; the card "
          f"runs K1 either way")
    if not chosen[True]:
        raise RuntimeError("the stream gate's parity: the JAX package "
                           "streams every weighted deposit at 256^3")
    errs = {tag: check_witnesses(f"{g.N1}^3 {tag}", g, pos, halo, block_dep,
                                 w)
            for tag, w in (("unweighted", None), ("weighted", ok))}
    block = tuple(fc.pallas_block)
    cot = torch.randn((N_CHAINS,) + g.shape, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(13))
    print(f"  K2 at {g.N1}^3: halo {halo}, block {block}, chains {N_CHAINS}")
    errs.update(check_gather(cot, pos, g, halo, block,
                             f" {g.N1}^3 truth's positions"))
    g32 = GridSpec.cube(32, 32 * BOX / N_GRID)
    pos32 = violator_positions(g32, N_CHAINS, 200, dev)
    w32 = torch.rand((N_CHAINS,) + g32.shape,
                     generator=torch.Generator(device=dev).manual_seed(11),
                     device=dev)
    print(f"  32^3, halo 12, block (16, 16): WX "
          f"{16 + 2 * tk._round_halo(12, 16)} > N 32, violators "
          f"{tk.deposit_violations(pos32, g32, 3).tolist()} (of halo 3)")
    for tag, w in (("unweighted", None), ("weighted", w32)):
        check_witnesses(f"32^3 wide window {tag}", g32, pos32, 12, (16, 16),
                        w)
    inputs = dict(g=g, pos=pos, ok=ok, cot=cot, halo=halo, block=block,
                  block_dep=block_dep)
    return runner, delta, inputs, errs


def _perflog_rows(out: Path) -> int:
    path = out / "performance_log.txt"
    if not path.exists():
        return 0
    return sum(1 for line in path.read_text().splitlines()
               if line.strip() and not line.startswith("#"))


def _sample_dumps(out: Path) -> dict:
    return {p.name: p.stat().st_mtime_ns
            for name in ("deltaLAG", "deltaEUL", "deltaRSS")
            for p in out.glob(f"{name}_*")}


def top_kernels(trace_path: Path, n: int = 10):
    """Device time by CUDA kernel name in a torch.profiler Chrome trace:
    the top n, then the port's own kernels (csrc/, named tsc_*) below
    them."""
    data = json.loads(trace_path.read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    kern = [e for e in events
            if e.get("cat") == "kernel" and e.get("ph") == "X"]
    if not kern:
        print(f"  the profile holds no kernel events "
              f"({len(events)} events in all)")
        return
    total = collections.Counter()
    count = collections.Counter()
    for e in kern:
        total[e["name"]] += e["dur"]
        count[e["name"]] += 1
    busy = sum(total.values())
    t0 = min(e["ts"] for e in kern)
    t1 = max(e["ts"] + e["dur"] for e in kern)
    print(f"  profile: {len(kern)} kernel launches, {busy / 1e3:.1f} ms of "
          f"kernel time over a {(t1 - t0) / 1e3:.1f} ms span (device busy "
          f"{busy / (t1 - t0):.3f}); top {n} by device time:")
    top = total.most_common(n)
    # the port's own kernels, in the top n or not
    top += [(name, us) for name, us in total.most_common()
            if "tsc_" in name and (name, us) not in top]
    for name, us in top:
        print(f"    {us / 1e3:10.2f} ms {us / busy:6.1%} {count[name]:6d}x  "
              f"{name[:110]}")


KERNEL_LAUNCHERS = {"K1": tk.tsc_deposit_window,
                    "K2": tk.tsc_gather_grads_window,
                    "K3": tk.tsc_deposit_slab, "K4": tk.tsc_gather_grads_slab,
                    # the witnesses: 0 on every path
                    "K1 push": tk.tsc_deposit_window_push,
                    "K1s pull": tk.tsc_deposit_window_stream,
                    "K3 push": tk.tsc_deposit_slab_push,
                    "K2 thread": tk.tsc_gather_grads_window_thread,
                    "K4 thread": tk.tsc_gather_grads_slab_thread}


def zero_launches():
    for f in KERNEL_LAUNCHERS.values():
        f.launches = 0


def read_launches():
    return {k: f.launches for k, f in KERNEL_LAUNCHERS.items()}


def path_inputs(runner: Runner) -> dict:
    """The kernels' inputs at a dense runner's chain positions: the forward
    model's displaced positions of its chains' delta, its halo, gather and
    deposit blocks, and the tail split's weights (1 inside the contract)."""
    g, gp, fc = runner.g, runner.gp, runner.conf.model.forward
    with torch.no_grad():
        pos = displaced_positions(runner.states.delta, g, fc, gp).contiguous()
    hx, hy = tk._halo_pair(fc.pallas_halo)
    ok = (assign._halo_excess(pos, g, hx, hy) <= 0.0).float()
    return dict(g=g, pos=pos, ok=ok, halo=fc.pallas_halo,
                block=tuple(fc.pallas_block),
                block_dep=assign.auto_block_dep(g, fc.pallas_halo,
                                                tuple(fc.pallas_block)))


def phase_cli256(dev, tmp: str, sharded: bool = False, chains: int = 1,
                 keep: dict | None = None, par_text: str | None = None):
    """Three command-line calls at 256^3: a session; --resume with
    --profile; a restart from deltaLAG_2 + the performance log after the
    checkpoint is removed.  With `sharded` the calls add --sharded and
    --chains `chains`: a (chains, world / chains) layout of the process
    group (one rank over NCCL when run alone), deposits through K3/K4.
    Launch counters are zeroed before each call and checked after it (on
    every rank).  Returns the path's launches of each kernel.  A dense
    run fills `keep` with the deposit's inputs at the chains' positions
    after the last call (its halo, block, positions and tail weights).
    `par_text` replaces the 256^3 input.par with another model whose
    deposits are windowless (no kernel launches; no profile)."""
    rank = torch.distributed.get_rank() \
        if torch.distributed.is_initialized() else 0
    (Path(tmp) / f"par{rank}").mkdir(exist_ok=True)
    if par_text is None:
        par = write_input_par(Path(tmp) / f"par{rank}")
    else:
        par = Path(tmp) / f"par{rank}" / "input.par"
        par.write_text(par_text)
    out = Path(tmp) / "run"
    prof = Path(tmp) / "prof"
    n_chains = chains if sharded else N_CHAINS
    common = ["--no-dashboard", "--out", str(out), "--device", dev.type,
              "--chains", str(n_chains)]
    common += ["--sharded"] if sharded else []
    ckpt = "checkpoint_sharded" if sharded else "checkpoint"
    on_card = dev.type == "cuda"
    world = torch.distributed.get_world_size() \
        if torch.distributed.is_initialized() else 1
    profile = ["--profile", str(prof)] \
        if world == 1 and par_text is None else []
    calls = (("session", [str(par), *common, "--samples", "1", "--nan-check"]),
             ("resume", [str(par), *common, "--resume", "--samples", "2",
                         *profile]),
             ("restart", [str(par), "2", *common, "--samples", "3"]))
    total = collections.Counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    last = None
    for name, argv in calls:
        if name == "restart" and rank == 0:
            for suffix in (".npz", ".json"):
                (out / f"{ckpt}{suffix}").unlink()
        if sharded:
            torch.distributed.barrier()
        rows0, dumps0 = _perflog_rows(out), _sample_dumps(out)
        sync(dev)
        zero_launches()
        t0 = time.perf_counter()
        args = cli.parse_args(argv)
        runner = cli.open_session(args)
        sync(dev)
        t1 = time.perf_counter()
        if name == "restart":
            lag2 = torch.from_numpy(bio.read_array(out / "deltaLAG_2",
                                                   runner.g.shape))
            if sharded:  # this rank's slab; chain 0 lives on row 0
                lay = runner.layout
                same = lay.row != 0 or torch.equal(
                    runner.state["delta"][0].cpu(), shard_real(lag2, lay))
            else:
                same = torch.equal(runner.states.delta[0].cpu(), lag2)
            print(f"  restart: chain 0's delta == deltaLAG_2 bit for bit: "
                  f"{same}")
            if not same:
                raise RuntimeError("the restart did not resume deltaLAG_2")
        cli.run_session(runner, args)
        sync(dev)
        t2 = time.perf_counter()
        launches = read_launches()
        attempts = _perflog_rows(out) - rows0
        dumps1 = _sample_dumps(out)
        new = sorted(set(dumps1) - set(dumps0))
        rewritten = sorted(k for k in dumps0 if dumps1[k] != dumps0[k])
        n_dep = sum(1 for k in new if k.startswith(("deltaEUL_", "deltaRSS_")))
        grads = 1 + (name == "restart") + 8 * attempts  # N_eps_fac = 8
        expected = dict.fromkeys(KERNEL_LAUNCHERS, 0)
        # kernels launch only where they are on the CUDA device; the
        # sharded dumps run the dense windowless deposit, as in the JAX
        # package (sharded_runner.py:165-171)
        if on_card and sharded:
            expected.update(K3=grads, K4=grads)
        elif on_card and par_text is None:
            expected.update(K1=grads + n_dep, K2=grads)
        ck = np.load(out / f"{ckpt}.npz")
        accepted, psi = ck["state_accepted"], ck["state_psi"]
        steps = 8 * attempts
        print(f"  {name}: setup {t1 - t0:.2f} s, run {t2 - t1:.2f} s: "
              f"{attempts} attempts, {steps} steps, {steps / (t2 - t1):.3f} "
              f"steps/s ({n_chains * steps / (t2 - t1):.3f} chain-steps/s)"
              f"{' with the profiler on' if name == 'resume' and profile else ''}")
        if on_card:
            print(f"  {name}: max_memory_allocated "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        print(f"  {name}: accepted {accepted.tolist()}, psi {psi.tolist()}, "
              f"new dumps {new}, rewritten {rewritten}")
        print(f"  {name}: launches {launches}, expected {expected} (init"
              f"{' + restart' if name == 'restart' else ''} + 8 per attempt"
              f"{'' if sharded else '; K1 also one per dumped field: %d' % n_dep})")
        if launches != expected:
            raise RuntimeError(f"{name}: kernel launches {launches} != "
                               f"{expected}")
        if not np.isfinite(psi).all() or attempts == 0 or rewritten:
            raise RuntimeError(f"{name}: non-finite psi, no attempt, or a "
                               "sample dumped twice")
        # at eps_fac 1e-4 every resumed chain accepts; under the adaptive
        # step size of another model a chain may reject a whole batch
        if name == "resume" and not ((accepted > last) if par_text is None
                                     else (accepted >= last)).all():
            raise RuntimeError(f"resume: accepted did not continue from {last}")
        last = accepted
        total.update(launches)
        if name == "restart" and keep is not None and not sharded:
            keep.update(path_inputs(runner))
        if name == "resume" and profile:
            top_kernels(prof / "trace.json")
            shutil.rmtree(prof)
        if sharded:
            torch.distributed.barrier()  # every rank has read the files
    return dict(total)


def float_spectrum(x, g: GridSpec, nbin: int):
    """measure_spectrum's power as it was summed before: a float index_add_
    over the bins, whose CUDA atomics add in a new order on every call."""
    X = fourier.rfft3(x)
    p = X.real * X.real + X.imag * X.imag
    bins, mult, _ = fourier._shell_bins(g, nbin, x.device)
    out = torch.zeros(nbin + 1, dtype=p.dtype, device=p.device)
    return out.index_add_(0, bins.reshape(-1), (mult * p).reshape(-1))[:nbin]


def phase_spectrum_determinism(dev):
    """measure_spectrum at 128^3 gives the same bits in 5 calls (the float
    form it replaced is measured beside it); then mass types 0, 2, 3 and 5
    are built once each on the card and must be finite."""
    g = GridSpec.cube(N_GRID, BOX)
    gen = torch.Generator(device=dev).manual_seed(17)
    x = torch.randn(g.shape, generator=gen, device=dev)
    ref = fourier.measure_spectrum(x, g, 200)
    sp = max(max((a - b).abs().max().item() for a, b in
                 zip(fourier.measure_spectrum(x, g, 200), ref))
             for _ in range(4))
    sp_float = spread(lambda: float_spectrum(x, g, 200), repeats=4)
    print(f"  measure_spectrum {g.N1}^3, 200 bins (power up to "
          f"{ref[1].max().item():.4e}): max|diff| over 5 calls {sp:.3e}; "
          f"its bin sums as a float index_add_ {sp_float:.3e} (sums up to "
          f"{float_spectrum(x, g, 200).max().item():.4e})")
    if sp != 0.0:
        raise RuntimeError("measure_spectrum is not deterministic on the card")
    k2 = fourier.k_squared(g, device=dev)
    power = 5.0 + 45.0 / (1.0 + 4.0 * k2)
    power[0, 0, 0] = 0.0
    force = torch.randn(g.shape, generator=gen, device=dev)
    window = (torch.rand(g.shape, generator=gen, device=dev) > 0.2).float()
    noise = 0.5 + torch.rand(g.shape, generator=gen, device=dev)
    for mt in (0, 2, 3, 5):
        m = mass_mod.compute_mass(g, mt, power, nbin=200, likeli_force=force,
                                  window=window, noise=noise,
                                  kernel_h=g.cell_avg)
        again = mass_mod.compute_mass(g, mt, power, nbin=200,
                                      likeli_force=force, window=window,
                                      noise=noise, kernel_h=g.cell_avg)
        parts = [torch.as_tensor(v, device=dev) for v in (m.mass_f, m.mass_r)]
        same = all(torch.equal(torch.as_tensor(a, device=dev),
                               torch.as_tensor(b, device=dev))
                   for a, b in ((m.mass_f, again.mass_f),
                                (m.mass_r, again.mass_r)))
        finite = all(bool(torch.isfinite(t).all()) for t in parts)
        print(f"  mass type {mt}: mass_f max {parts[0].max().item():.4e}, "
              f"mass_r max {parts[1].max().item():.4e}, finite {finite}, "
              f"same bits twice {same}")
        if not (finite and same):
            raise RuntimeError(f"mass type {mt} on the card")


def fold_slabs(exts, g: GridSpec, n1: int, h: int):
    """Full-grid density from extended slabs: each slab's rows, margins
    included, added at their periodic global rows (on the device, no
    collective)."""
    total = torch.zeros(exts[0].shape[:-3] + g.shape, device=exts[0].device)
    for dev, ext in enumerate(exts):
        rows = torch.remainder(torch.arange(-h, n1 + h, device=ext.device)
                               + dev * n1, g.N1)
        total.index_add_(-3, rows, ext)
    return total


def check_slab(label, g, pos, n1, dev, h, weights, cot):
    """K3 (against its plain version, its push witness and itself) and K4
    (with and without the value; against its plain version, its thread
    witness and itself) on one slab; returns the errors and K4's share of
    taps outside the box."""
    out = tk.tsc_deposit_slab(pos, g, n1, dev, h, weights=weights)
    again = tk.tsc_deposit_slab(pos, g, n1, dev, h, weights=weights)
    push = tk.tsc_deposit_slab(pos, g, n1, dev, h, weights=weights,
                               impl="push")
    sync(pos.device)
    ref = tk.tsc_deposit_slab_plain(pos, g, n1, dev, h, weights=weights)
    errs = {"K3": compare(f"K3 {label}", out, ref, TOL_DEP_REL)}
    same = {"push": torch.equal(out, push), "itself": torch.equal(out, again)}
    print(f"  K3 {label}: == push {same['push']}, == itself {same['itself']}")
    if not all(same.values()):
        raise RuntimeError(f"K3 {label} differs from its witness or itself")
    for want_value in (False, True):
        o = check_same(
            f"K4 {label} want_value={want_value}",
            lambda impl: tk.tsc_gather_grads_slab(
                cot, pos, g, n1, dev, h, want_value=want_value, impl=impl))
        sync(pos.device)
        r = tk.tsc_gather_grads_slab_plain(cot, pos, g, n1, dev, h,
                                           want_value=want_value)
        errs[f"K4 value={want_value}"] = compare(
            f"K4 {label} want_value={want_value}", o, r, TOL_GATHER_REL)
    errs["K4 outside"] = print_taps_outside_box(
        f"K4 {label}", cot, pos, g, h, (8, 8), slab=(n1, dev))
    return errs


def phase_slab_kernels(dev, inputs, inputs256):
    """K3/K4 at 32^3 (violators; 8-row slabs under 24-row windows), at the
    256^3 one-rank shapes of the sharded path, and per slab at 128^3 for 2
    and 4 slabs against K1/K2 on one card.  Returns the 256^3 one-rank
    inputs and errors."""
    g32 = GridSpec.cube(32, 32 * BOX / N_GRID)
    pos32 = violator_positions(g32, 1, 200, dev, jitter=1.5)
    gen = torch.Generator(device=dev).manual_seed(23)
    for D, h in ((1, 8), (2, 4), (4, 8)):
        n1 = 32 // D
        for k in range(D):
            p = pos32[:, :, k * n1:(k + 1) * n1].contiguous()
            w = torch.rand((1, n1, 32, 32), generator=gen, device=dev)
            cot = torch.randn((1, n1 + 2 * h, 32, 32), generator=gen,
                              device=dev)
            for tag, ww in (("unweighted", None), ("weighted", w)):
                check_slab(f"32^3 D={D} slab {k} h={h} {tag}", g32, p, n1, k,
                           h, ww, cot)

    # the 256^3 one-rank shapes: 1 chain, the whole box as one slab, the
    # kernel halo rounded up to a multiple of 4
    g, pos2 = inputs256["g"], inputs256["pos"][:1].contiguous()
    h = -(-int(inputs256["halo"]) // 4) * 4
    ok = (assign._slab_halo_excess(pos2, g, g.N1, 0, h) <= 0.0).float()
    cot = torch.randn((1, g.N1 + 2 * h) + g.shape[1:], generator=gen,
                      device=dev)
    print(f"  {g.N1}^3 one rank: kernel halo {h}, n1_ext {g.N1 + 2 * h}, "
          f"violators {(ok == 0).sum().item()}")
    errs = {}
    for tag, w in (("unweighted", None), ("weighted", ok)):
        e = check_slab(f"{g.N1}^3 one rank {tag}", g, pos2, g.N1, 0, h, w,
                       cot)
        errs.update({f"{k} {tag}": v for k, v in e.items()})

    # per slab at 128^3 against K1/K2, contract violators zero-weighted
    g1, pos1, ok1 = inputs["g"], inputs["pos"], inputs["ok"]
    halo, block_dep, block = inputs["halo"], inputs["block_dep"], \
        inputs["block"]
    rho = tk.tsc_deposit_window(pos1, g1, halo, block_dep, weights=ok1)
    cot1 = torch.randn(pos1.shape[:1] + g1.shape, generator=gen, device=dev)
    k2 = tk.tsc_gather_grads_window(cot1, pos1, g1, halo, block, False)
    h1 = -(-int(halo) // 4) * 4
    for D in (2, 4):
        n1 = g1.N1 // D
        exts, grads = [], []
        for k in range(D):
            p = pos1[:, :, k * n1:(k + 1) * n1].contiguous()
            exts.append(tk.tsc_deposit_slab(
                p, g1, n1, k, h1, weights=ok1[:, k * n1:(k + 1) * n1]
                .contiguous()))
            rows = torch.remainder(torch.arange(-h1, n1 + h1, device=dev)
                                   + k * n1, g1.N1)
            ext = cot1.index_select(-3, rows).contiguous()
            outs = {want_value: check_same(
                f"K4 slab {k} of {D} at {g1.N1}^3 want_value={want_value}",
                lambda impl: tk.tsc_gather_grads_slab(
                    ext, p, g1, n1, k, h1, block, want_value, impl=impl))
                for want_value in (False, True)}
            grads.append(outs[False])
        compare(f"K3 {D} slabs of {g1.N1}^3 folded vs K1", fold_slabs(
            exts, g1, n1, h1), rho, TOL_DEP_REL)
        compare(f"K4 {D} slabs of {g1.N1}^3 vs K2 (contract-keeping "
                "particles)", torch.cat(grads, dim=-3) * ok1[:, None],
                k2 * ok1[:, None], TOL_GATHER_REL)
    return dict(g=g, pos=pos2, ok=ok, cot=cot, halo=h), errs


def phase_sharded_psi256(dev, runner: Runner):
    """The sharded posterior at 256^3 on a 1 x world layout of the process
    group (one rank over NCCL when run alone) against the dense posterior
    on this rank's card, from the same delta (the mock truth); grad psi is
    compared slab by slab, its norms summed over the ranks."""
    g, gp, conf = runner.g, runner.gp, runner.conf
    fc = conf.model.forward
    halo = tk.displacement_bound_cells(runner.truth, g, fc, gp)
    world = 1
    if torch.distributed.is_initialized():
        world = torch.distributed.get_world_size()
    layout = pdist.make_layout(1, world, device=dev.type)
    print(f"  process group: backend {torch.distributed.get_backend()}, "
          f"world {world}; exchange halo {halo}, kernel halo "
          f"{fc.pallas_halo} (rounded to {-(-fc.pallas_halo // 4) * 4}), "
          f"tail_k {fc.pallas_tail_k}")
    psi_fn, grad_fn = sfw.make_sharded_psi(g, fc, gp, conf.model.likelihood,
                                           layout, halo=halo)
    obs = sfw.shard_obs(runner.obs, layout)
    delta = runner.truth
    s_loc = shard_real(delta, layout).contiguous()
    zero_launches()
    t0 = time.perf_counter()
    psi_s, grad_s = psi_fn(s_loc, obs), grad_fn(s_loc, obs)
    sync(dev)
    t1 = time.perf_counter()
    launches = read_launches()
    (psi_d, _), grad_d = make_psi_value_and_grad(g, conf.model, gp,
                                                 runner.obs)(delta[None])
    psi_d, grad_d = psi_d[0].item(), shard_real(grad_d[0], layout)
    norms = torch.stack([torch.sum((grad_s - grad_d) ** 2),
                         torch.sum(grad_d ** 2)]).double()
    torch.distributed.all_reduce(norms)
    psi_err = abs(psi_s - psi_d) / abs(psi_d)
    grad_err = (norms[0] / norms[1]).sqrt().item()
    print(f"  sharded {t1 - t0:.3f} s (first calls); psi sharded {psi_s} "
          f"dense {psi_d}: rel err {psi_err:.3e} (tol {TOL_PSI_REL:.0e}); "
          f"grad psi rel L2 err {grad_err:.3e} (tol {TOL_GRAD_REL:.0e}); "
          f"launches {launches}")
    if not (psi_err <= TOL_PSI_REL and grad_err <= TOL_GRAD_REL
            and bool(torch.isfinite(grad_s).all())):
        raise RuntimeError("the sharded psi disagrees with the dense psi")
    expected = dict.fromkeys(KERNEL_LAUNCHERS, 0)
    if dev.type == "cuda":
        expected.update(K3=2, K4=1)
    if launches != expected:
        raise RuntimeError(f"sharded psi launches {launches}: expected K3 "
                           "twice (value, then value and grad), K4 once and "
                           "nothing else")


MASS_CODES = (0, 1, 2, 3, "sph_ft")
# particle rows of the truth's positions that the CPU reference deposits (of
# 128): the CPU takes minutes for the SPH stencil's 81 scatters at the full
# 128^3 x 2 chains, so it checks a slab of the particles, deposited into
# the full grid; the card's determinism, mass and times are at full size
CPU_ROWS = 8


def kernel_launches(fn) -> int:
    """CUDA kernel launches of one call of fn, counted in a torch.profiler
    trace (0 off the card)."""
    if not torch.cuda.is_available():
        return 0
    with tempfile.TemporaryDirectory() as d:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    return sum(1 for e in events
               if e.get("cat") == "kernel" and e.get("ph") == "X")


def deposit_and_grad(pos, g, mk, h, w, cot):
    """(rho, d<cot, rho>/dpos or None) of assign.deposit."""
    p = pos.detach().clone().requires_grad_(True)
    rho = assign.deposit(p, g, mk, h, w)
    if not rho.requires_grad:  # NGP: constant weights
        return rho, None
    (grad,) = torch.autograd.grad((rho * cot).sum(), p)
    return rho.detach(), grad


def phase_masskernels(dev, inputs):
    """The windowless mass kernels of assign.deposit (0 NGP, 1 CIC, 2 TSC,
    3 SPH, sph_ft) on the headline truth's positions at 128^3 (2 chains),
    unweighted and weighted: the same bits on 3 calls; mass conserved; the
    card against the same function on the CPU (values and autograd
    position gradients, on the particles of the first CPU_ROWS rows);
    forward and forward+backward times (CUDA events) and launches per
    call.  Returns the times."""
    g, pos = inputs["g"], inputs["pos"]
    h = g.cell_avg  # kernel_h at particle_kernel_h_rel = 1
    gen = torch.Generator(device=dev).manual_seed(31)
    w = 0.5 + torch.rand(pos.shape[:1] + g.shape, generator=gen, device=dev)
    cot = torch.randn(pos.shape[:1] + g.shape, generator=gen, device=dev)
    sub = pos[:, :, :CPU_ROWS].contiguous()
    cell_vol = math.prod(g.cell)
    print(f"  {g.N1}^3, {pos.shape[0]} chains, h {h:.4f}; the CPU reference "
          f"on the particles of {CPU_ROWS} of {g.N1} rows; SPH stencil "
          f"{len(assign.sph_stencil(g, h))} offsets")
    times = {}
    for mk in MASS_CODES:
        for tag, ww in (("unweighted", None), ("weighted", w)):
            label = f"masskernel {mk!r} {tag}"
            rho = assign.deposit(pos, g, mk, h, ww)
            same = all(torch.equal(rho, assign.deposit(pos, g, mk, h, ww))
                       for _ in range(2))
            mass = rho.double().sum((1, 2, 3))
            want = (torch.full_like(mass, g.N) if ww is None
                    else ww.double().sum((1, 2, 3)))
            if mk == 3:  # rho = sum_p W: the grid sums to N / cell volume
                mass, rtol = mass * cell_vol, 0.02
            else:
                rtol = 1e-5
            mass_err = ((mass - want).abs() / want).max().item()
            wsub = None if ww is None else ww[:, :CPU_ROWS].contiguous()
            rho_s, grad_s = deposit_and_grad(sub, g, mk, h, wsub, cot)
            rho_c, grad_c = deposit_and_grad(
                sub.cpu(), g, mk, h, None if wsub is None else wsub.cpu(),
                cot.cpu())
            print(f"  {label}: the same bits on 3 calls {same}; mass rel err "
                  f"{mass_err:.3e} (tol {rtol:.0e})")
            compare(f"{label} card vs CPU", rho_s.cpu(), rho_c, TOL_DEP_REL)
            if grad_c is None:
                print(f"  {label}: no position gradient (constant weights)")
            else:
                compare(f"{label} position gradient card vs CPU",
                        grad_s.cpu(), grad_c, TOL_GATHER_REL)
            if not (same and mass_err <= rtol):
                raise RuntimeError(f"{label}: not deterministic or mass lost")
            if dev.type != "cuda":
                continue

            def fwd():
                return assign.deposit(pos, g, mk, h, ww)

            def fwd_bwd():
                return deposit_and_grad(pos, g, mk, h, ww, cot)

            n = 3 if mk == 3 else 10
            times[label] = dict(fwd_ms=cuda_ms(fwd, n, warmup=1),
                                fwd_bwd_ms=cuda_ms(fwd_bwd, n, warmup=1),
                                fwd_launches=kernel_launches(fwd),
                                fwd_bwd_launches=kernel_launches(fwd_bwd))
            t = times[label]
            print(f"  {label}: forward {t['fwd_ms']:.3f} ms "
                  f"({t['fwd_launches']} launches), forward+backward "
                  f"{t['fwd_bwd_ms']:.3f} ms ({t['fwd_bwd_launches']} "
                  "launches)", flush=True)
    return times


RADIAL_OBSERVER = dict(rsd_planepar=False, observer=(150.0, -70.0, 30.0),
                       origin=(150.0, -70.0, 30.0))


def radial_conf() -> RunConfig:
    """The headline configuration with radial RSD about a box corner, given
    in absolute coordinates with a non-zero origin (observer - origin = 0):
    many particles leave the box."""
    conf = headline_conf(N_GRID)
    fc = dataclasses.replace(conf.model.forward, **RADIAL_OBSERVER)
    return dataclasses.replace(conf, model=dataclasses.replace(
        conf.model, forward=fc))


def compare_psi(label, target, delta, obs, g, dev):
    """psi and grad psi of `target(delta, obs)` -> (psi, grad) on the card
    and on the CPU, within TOL_PSI_REL and TOL_GRAD_REL."""
    psi_d, grad_d = target(delta, obs)
    sync(dev)
    psi_c, grad_c = target(delta.cpu(), obs.to("cpu"))
    psi_err = ((psi_d.cpu() - psi_c).abs() / psi_c.abs()).max().item()
    grad_err = max((torch.linalg.vector_norm(grad_d[c].cpu() - grad_c[c])
                    / torch.linalg.vector_norm(grad_c[c])).item()
                   for c in range(delta.shape[0]))
    ok = (psi_err <= TOL_PSI_REL and grad_err <= TOL_GRAD_REL
          and bool(torch.isfinite(grad_d).all()))
    print(f"  {label}: psi {psi_d.tolist()}; psi rel err {psi_err:.3e} (tol "
          f"{TOL_PSI_REL:.0e}), grad psi rel L2 err {grad_err:.3e} (tol "
          f"{TOL_GRAD_REL:.0e}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError(f"{label}: psi / grad psi on the card disagree "
                           "with the CPU")
    return psi_err, grad_err


def posterior(g, mc, gp):
    def target(delta, obs):
        (psi, _), grad = make_psi_value_and_grad(g, mc, gp, obs)(delta)
        return psi, grad
    return target


def eh98_transf(g: GridSpec, conf: RunConfig, device):
    """TRANSF kernels from the EH98 table: t_zeld = T(k) and t_2lpt =
    T(k)^2 of the no-wiggle transfer function, interpolated onto the grid."""
    k = np.logspace(-4, 2, 1024)
    T = cosmo_mod.eh_transfer_nowiggle(conf.cosmo(), k)
    return tuple(transfer.transfer_on_grid(g, k, t, device)
                 for t in (T, T * T))


def phase_options(dev, tmp: str):
    """psi and grad psi at 128^3, card against CPU: (a) radial RSD about a
    box corner through the kernel deposit with the tail split, K1/K2 also
    against their plain versions (and their witnesses) on those positions;
    (b) 2LPT with 'findif' derivatives; (c) ALPT with TRANSF kernels from
    the EH98 table; (d) NGP with mass type 2, whose likelihood force is the
    zero field; (e) the resolution-independent GRF at 64^3 and 128^3 from
    one seed, modes equal inside both grids."""
    runner = Runner(radial_conf(), out_dir=tmp, device=dev)
    runner.setup(n_chains=N_CHAINS)
    g, gp, mc = runner.g, runner.gp, runner.conf.model
    fc = mc.forward
    delta = torch.stack([runner.truth, 0.5 * runner.truth])
    with torch.no_grad():
        pos = displaced_positions(delta, g, fc, gp).contiguous()
    L = torch.tensor([g.L1, g.L2, g.L3], device=dev).reshape(3, 1, 1, 1)
    outside = ((pos < 0) | (pos >= L)).any(1).sum((1, 2, 3)).tolist()
    hx, hy = tk._halo_pair(fc.pallas_halo)
    ok = (assign._halo_excess(pos, g, hx, hy) <= 0.0).float()
    print(f"  (a) radial RSD, observer - origin = "
          f"{tuple(o - c for o, c in zip(fc.observer, fc.origin))}: particles "
          f"outside the box per chain {outside}; halo {fc.pallas_halo}, "
          f"tail_k {fc.pallas_tail_k}, violators per chain "
          f"{(ok == 0).sum((1, 2, 3)).tolist()}")
    if min(outside) == 0:
        raise RuntimeError("radial RSD left every particle in the box")
    if (ok == 0).sum((1, 2, 3)).max().item() > fc.pallas_tail_k:
        raise RuntimeError("(a) more violators than the tail holds: the "
                           "resolved halo misses the radial RSD shift")
    cot = torch.randn((N_CHAINS,) + g.shape, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(37))
    block = tuple(fc.pallas_block)
    errs = check_kernels(f"{g.N1}^3 radial", g, pos, fc.pallas_halo,
                         assign.auto_block_dep(g, fc.pallas_halo, block),
                         block, ok, cot)
    zero_launches()
    compare_psi("(a) ALPT + radial RSD + sph_ft, kernel deposit",
                posterior(g, mc, gp), delta, runner.obs, g, dev)
    launches = read_launches()
    want = dict.fromkeys(KERNEL_LAUNCHERS, 0)
    if dev.type == "cuda":
        want.update(K1=1, K2=1)
    print(f"  (a) launches of one psi + grad on the card: {launches}")
    if launches != want:
        raise RuntimeError(f"(a) launches {launches} != {want}")
    obs = runner.obs
    runner.close()
    one = delta[:1]

    mc_fd = ModelConfig(likelihood=1, forward=dataclasses.replace(
        fc, sfmodel=2, deriv_scheme="findif", rsd_planepar=True))
    compare_psi("(b) 2LPT, findif derivatives", posterior(g, mc_fd, gp), one,
                obs, g, dev)

    fc_t = dataclasses.replace(fc, rsd_planepar=True)

    def transf_target(d, o):
        t = eh98_transf(g, runner.conf, d.device)
        with torch.enable_grad():
            x = d.detach().requires_grad_(True)
            psi = likelihoods.prior_psi(x, g, o) + likelihoods.gaussian_psi(
                lag2eul(x, g, fc_t, gp, transfer=t), o)
            (grad,) = torch.autograd.grad(psi.sum(), x)
        return psi.detach(), grad

    compare_psi("(c) ALPT, TRANSF kernels from the EH98 table",
                transf_target, one, obs, g, dev)

    fc_ngp = ForwardConfig(sfmodel=1, masskernel=0)
    conf_ngp = dataclasses.replace(
        headline_conf(g.N1), model=ModelConfig(likelihood=1, forward=fc_ngp),
        hmc=HMCConfig(mass_type=2))
    force = likelihood_force(conf_ngp, gp, obs, delta[0])
    mass = mass_mod.compute_mass(g, 2, obs.power, nbin=conf_ngp.N_bin,
                                 likeli_force=force, window=obs.window,
                                 noise=obs.noise, kernel_h=g.cell_avg)
    finite = all(bool(torch.isfinite(torch.as_tensor(v)).all())
                 for v in (mass.mass_f, mass.mass_r))
    print(f"  (d) NGP, mass type 2: likelihood force max |f| "
          f"{force.abs().max().item()}, mass finite {finite}")
    if force.any() or not finite:
        raise RuntimeError("(d) the NGP likelihood force is not the zero field")
    compare_psi("(d) Zel'dovich + NGP", posterior(g, conf_ngp.model, gp), one,
                obs, g, dev)

    g64 = GridSpec.cube(N_GRID // 2, BOX)
    fields = {}
    for gg in (g64, g):
        P = torch.full(gg.rshape, 50.0, device=dev)
        P[0, 0, 0] = 0.0
        gen = torch.Generator(device=dev).manual_seed(41)
        fields[gg.N1] = fourier.rfft3(random_fields.grf_resolution_independent(
            gen, gg, P)) / gg.N
    n = g64.N1
    f = torch.arange(-(n // 2) + 1, n // 2, device=dev)
    ix, iy = f[:, None, None], f[None, :, None]
    iz = torch.arange(n // 2, device=dev)[None, None, :]
    coarse = fields[n][ix % n, iy % n, iz]
    fine = fields[g.N1][ix % g.N1, iy % g.N1, iz]
    diff = (coarse - fine).abs()
    same = bool((diff <= 1e-8 + 1e-4 * fine.abs()).all())
    # the DC mode (P = 0) is rounding noise on both grids: the relative
    # difference is printed over the others
    live = fine.abs() > 1e-8
    print(f"  (e) resolution-independent GRF, {n}^3 and {g.N1}^3 from one "
          f"seed: {coarse.numel()} shared modes, max relative difference "
          f"{(diff[live] / fine.abs()[live]).max().item():.3e} over the "
          f"{int(live.sum())} with |mode| > 1e-8, max |diff| "
          f"{diff.max().item():.3e} (rtol 1e-4, atol 1e-8) "
          f"{'ok' if same else 'FAIL'}")
    if not same:
        raise RuntimeError("(e) the shared modes differ between the grids")
    return errs


REFERENCE_PAR = """\
# the reference's data/input.par model (tests/test_reference_compat.py:
# 39-50) at {n}^3, box {box}, with the internal EH98 spectrum
Nx = {n}
Lx = {box}
sfmodel = 1
masskernel = 3
likelihood = 1
mass_type = 1
eps_fac_update_type = 3
N_a_eps_update = 100
acc_min = 0.6
acc_max = 0.7
random_test = true
readPS = false
seed = 1
"""


TILED_SRC = "barcode_tpu_torch/csrc/tsc_deposit_tiled.cu"
DEP_REP = "barcode_tpu/forward/pallas_deposit.py:789"
STREAM_REP = "barcode_tpu/forward/pallas_deposit.py:274"
SLAB_REP = "barcode_tpu/forward/pallas_deposit.py:675"
GAT_SRC = "barcode_tpu_torch/csrc/tsc_gather_tiled.cu"
GAT_REP = "barcode_tpu/forward/pallas_deposit.py:530"
SLAB_GAT_REP = "barcode_tpu/forward/pallas_deposit.py:744"


def deposit_group(label, g, pos, halo, block, w, err, launches, note):
    """Timing rows of one dense deposit input: K1 (the tiled kernel) and,
    on the same inputs, its push and pull witnesses (the same bits, so the
    same error; 0 launches on every path)."""
    n_part = pos.shape[0] * g.N
    n_active = n_part if w is None else int(w.sum())
    nbytes = n_part * (12 + (0 if w is None else 4) + 4)

    def dep(impl):
        return lambda: tk.tsc_deposit_window(pos, g, halo, block, weights=w,
                                             impl=impl)
    return dict(
        plain=lambda: tk.tsc_deposit_window_plain(pos, g, halo, block,
                                                  weights=w),
        nbytes=nbytes, ops=n_active * OPS_K1, err=err, rows=[
            (f"K1{label}", f"tsc_deposit_window{label}", dep("tiled"),
             TILED_SRC, DEP_REP, launches, note),
            (f"K1{label} push", f"tsc_deposit_window_push{label}",
             dep("push"), "barcode_tpu_torch/csrc/tsc_deposit.cu", DEP_REP,
             0, "witness: the earlier K1"),
            (f"K1s{label} pull", f"tsc_deposit_window_stream{label}",
             dep("pull"), "barcode_tpu_torch/csrc/tsc_deposit_stream.cu",
             STREAM_REP, 0, "witness: the earlier K1s")])


def slab_group(label, g, pos, n1, h, w, err, launches, note):
    """Timing rows of one slab deposit input: K3 (the tiled kernel) and its
    push witness on the same inputs."""
    n_part = pos.shape[0] * n1 * g.N2 * g.N3
    n_ext = pos.shape[0] * (n1 + 2 * h) * g.N2 * g.N3
    n_active = n_part if w is None else int(w.sum())

    def dep(impl):
        return lambda: tk.tsc_deposit_slab(pos, g, n1, 0, h, weights=w,
                                           impl=impl)
    return dict(
        plain=lambda: tk.tsc_deposit_slab_plain(pos, g, n1, 0, h, weights=w),
        nbytes=n_part * (12 + (0 if w is None else 4)) + 4 * n_ext,
        ops=n_active * OPS_K3, err=err, rows=[
            (f"K3{label}", f"tsc_deposit_slab{label}", dep("tiled"),
             TILED_SRC, SLAB_REP, launches, note),
            (f"K3{label} push", f"tsc_deposit_slab_push{label}", dep("push"),
             "barcode_tpu_torch/csrc/tsc_deposit_slab.cu", SLAB_REP, 0,
             "witness: the earlier K3")])


def gather_group(key, name, gather, plain, nbytes, ops, err, slab, launches,
                 note):
    """Timing rows of one gather input: K2 or K4 (`slab`) through the tiled
    kernel and, on the same inputs, its thread witness (the same bits, so
    the same error; 0 launches on every path).  `gather(impl)` runs it."""
    rep, witness = (SLAB_GAT_REP, "tsc_gather_slab.cu") if slab else \
        (GAT_REP, "tsc_gather.cu")
    k = "K4" if slab else "K2"
    return dict(plain=plain, nbytes=nbytes, ops=ops, err=err, rows=[
        (key, name, lambda: gather("tiled"), GAT_SRC, rep, launches, note),
        (f"{key} thread", name.replace("grads_window", "grads_window_thread")
         .replace("grads_slab", "grads_slab_thread"),
         lambda: gather("thread"), f"barcode_tpu_torch/csrc/{witness}", rep,
         0, f"witness: the earlier {k}")])


def slab_groups(slab, slab_errs, launches_sh):
    """The timing groups of K3 and K4: at the 256^3 one-rank shapes of the
    sharded path (weighted: the tail split zero-weights violators), K3
    also unweighted, and both on slab 0 of 2 slabs at 256^3 (n1_loc = 128,
    1 chain, the same kernel halo), where their error is taken here."""
    g, pos, ok, cot, h = (slab[k] for k in ("g", "pos", "ok", "cot", "halo"))
    n1 = g.N1
    n_ext = (n1 + 2 * h) * g.N2 * g.N3
    note = f"{N_BIG}^3 --sharded command-line path, 8 per attempt"
    groups = [
        slab_group("", g, pos, n1, h, ok, slab_errs["K3 weighted"],
                   launches_sh["K3"], note),
        slab_group(f" ({N_BIG}^3, unweighted)", g, pos, n1, h, None,
                   slab_errs["K3 unweighted"], 0,
                   "the path weights every K3 call (tail split)"),
        gather_group(
            "K4", "tsc_gather_grads_slab",
            lambda impl: tk.tsc_gather_grads_slab(cot, pos, g, n1, 0, h,
                                                  want_value=False, impl=impl),
            lambda: tk.tsc_gather_grads_slab_plain(cot, pos, g, n1, 0, h,
                                                   want_value=False),
            4 * n_ext + g.N * (12 + 12), g.N * OPS_K4,
            slab_errs["K4 value=False weighted"], True, launches_sh["K4"],
            note)]
    # slab 0 of 2 at 256^3
    m1 = n1 // 2
    p2 = pos[:, :, :m1].contiguous()
    ok2 = ok[:, :m1].contiguous()  # the one-rank mask, a weight like any
    cot2 = cot[:, :m1 + 2 * h].contiguous()
    m_part, m_ext = g.N // 2, (m1 + 2 * h) * g.N2 * g.N3
    e3 = check_slab("slab 0 of 2", g, p2, m1, 0, h, ok2, cot2)
    two = "2 slabs: not on the one-rank path"
    groups += [
        slab_group(f" ({N_BIG}^3, slab 0 of 2)", g, p2, m1, h, ok2, e3["K3"],
                   0, two),
        gather_group(
            "K4@2slabs", f"tsc_gather_grads_slab ({N_BIG}^3, slab 0 of 2)",
            lambda impl: tk.tsc_gather_grads_slab(cot2, p2, g, m1, 0, h,
                                                  want_value=False, impl=impl),
            lambda: tk.tsc_gather_grads_slab_plain(cot2, p2, g, m1, 0, h,
                                                   want_value=False),
            4 * m_ext + m_part * 24, m_part * OPS_K4, e3["K4 value=False"],
            True, 0, two)]
    return groups


def phase_timing(inputs, errs, launches, per_attempt, inputs256, errs256,
                 launches256, path256, slab, slab_errs, launches_sh):
    """CUDA-event times of each kernel and its plain version at its path's
    shapes, the witnesses beside the tiled deposit on the same inputs: K1,
    K2 at 128^3; K1 and K2 at 256^3 on the truth's positions, K1 also at
    the chains' positions after the 256^3 session (`path256`, checked
    against the witnesses here); K3, K4 at the 256^3 one-rank and 2-slab
    shapes.  Each kernel's bound; returns the kernels' JSON rows."""
    g, pos, ok, cot = inputs["g"], inputs["pos"], inputs["ok"], inputs["cot"]
    halo, block, block_dep = inputs["halo"], inputs["block"], inputs["block_dep"]
    n_part = pos.shape[0] * g.N
    g2, pos2, ok2 = inputs256["g"], inputs256["pos"], inputs256["ok"]
    halo2, block2 = inputs256["halo"], inputs256["block_dep"]
    cot2, gblock2 = inputs256["cot"], inputs256["block"]
    n_part2 = pos2.shape[0] * g2.N
    gp, posp, okp = path256["g"], path256["pos"], path256["ok"]
    halop, blockp = path256["halo"], path256["block_dep"]
    print(f"  {gp.N1}^3 chains after the session: violators per chain "
          f"{(okp == 0).sum((1, 2, 3)).tolist()}, halo {halop}, block "
          f"{blockp}")
    errp = check_witnesses(f"{gp.N1}^3 path positions weighted", gp, posp,
                           halop, blockp, okp)
    gblockp, n_partp = path256["block"], posp.shape[0] * gp.N
    cotp = torch.randn(posp.shape[:1] + gp.shape, device=posp.device,
                       generator=torch.Generator(device=posp.device)
                       .manual_seed(29))
    errp2 = check_gather(cotp, posp, gp, halop, gblockp,
                         f" {gp.N1}^3 path positions")
    note256 = f"{N_BIG}^3 command-line path, 8 per attempt"
    groups = [
        deposit_group("", g, pos, halo, block_dep, ok, errs["K1 weighted"],
                      launches["K1"], f"{per_attempt['K1']} per attempt"),
        gather_group(
            "K2", "tsc_gather_grads_window",
            lambda impl: tk.tsc_gather_grads_window(cot, pos, g, halo, block,
                                                    False, impl=impl),
            lambda: tk.tsc_gather_grads_window_plain(cot, pos, g, halo, block,
                                                     False),
            n_part * (4 + 12 + 12), n_part * OPS_K2, errs["K2 value=False"],
            False, launches["K2"], f"{per_attempt['K2']} per attempt"),
        deposit_group(f" ({N_BIG}^3)", g2, pos2, halo2, block2, ok2,
                      errs256["weighted"], launches256["K1"],
                      note256 + "; the truth's positions"),
        deposit_group(f" ({N_BIG}^3, path positions)", gp, posp, halop,
                      blockp, okp, errp, launches256["K1"],
                      note256 + "; the chains after the session"),
        gather_group(
            "K2@256", f"tsc_gather_grads_window ({N_BIG}^3)",
            lambda impl: tk.tsc_gather_grads_window(cot2, pos2, g2, halo2,
                                                    gblock2, False, impl=impl),
            lambda: tk.tsc_gather_grads_window_plain(cot2, pos2, g2, halo2,
                                                     gblock2, False),
            n_part2 * (4 + 12 + 12), n_part2 * OPS_K2,
            errs256["K2 value=False"], False, launches256["K2"],
            note256 + "; the truth's positions"),
        gather_group(
            "K2@256 path", f"tsc_gather_grads_window ({N_BIG}^3, path "
            "positions)",
            lambda impl: tk.tsc_gather_grads_window(cotp, posp, gp, halop,
                                                    gblockp, False, impl=impl),
            lambda: tk.tsc_gather_grads_window_plain(cotp, posp, gp, halop,
                                                     gblockp, False),
            n_partp * (4 + 12 + 12), n_partp * OPS_K2, errp2["K2 value=False"],
            False, launches256["K2"],
            note256 + "; the chains after the session"),
        *slab_groups(slab, slab_errs, launches_sh)]
    rows = []
    for grp in groups:
        plain_ms = cuda_ms(grp["plain"], 3, warmup=1)
        t_bytes = grp["nbytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = grp["ops"] / F32_FLOPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        for key, name, fn, src, rep, n_launch, note in grp["rows"]:
            ms = cuda_ms(fn, 20)
            rows.append({
                "name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": n_launch, "max_abs_err": grp["err"], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None})
            print(f"  {key} {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms), "
                  f"bound {bound * 1e3:.2f} us ({grp['nbytes'] / 1e6:.1f} MB, "
                  f"{grp['ops'] / 1e9:.3f} GFLOP), {n_launch} launches on "
                  f"the path ({note})")
    return rows


def phase_build_checks(info):
    """The tiled deposit's shared-memory atomics in its SASS, what a 64-bit
    shared-memory add compiles to on sm_90a, and the tiled deposit's
    resident blocks per SM (the plan's two, so that the box cap holds); the
    tiled gather's registers and spills (`-Xptxas -v`) and resident blocks
    per SM (at least the plan's)."""
    lib, _ = cuda_build.load()
    sass = cuda_build.sass(info.path, "tsc_deposit_tiled_kernel")
    ops = collections.Counter(tok for line in sass.splitlines()
                              for tok in line.split()
                              if tok.startswith("ATOMS"))
    add64 = cuda_build.shared_add64_opcodes()
    native = bool(add64) and not any("CAS" in op for op in add64)
    print(f"  tiled kernel: shared-memory atomics in its SASS {dict(ops)}")
    print(f"  a 64-bit atomicAdd into shared memory compiles to {add64} on "
          f"sm_90a: native {native} (the tiled kernel adds two native 32-bit "
          f"words instead)")
    plan = tk.tiled_plan(N_BIG, N_BIG, N_BIG, N_CHAINS)
    blocks = {geom: lib.tsc_deposit_tiled_blocks_per_sm(plan.box_cells, slab)
              for geom, slab in (("dense", 0), ("slab", 1))}
    print(f"  tiled kernel: {plan.threads} threads, box {plan.box_cells} "
          f"cells ({plan.smem_bytes} B), resident blocks per SM {blocks} "
          f"(planned {plan.blocks_per_sm})")
    if not ops or any("CAS" in op for op in ops):
        raise RuntimeError(f"the tiled kernel's shared atomics are "
                           f"{dict(ops)}")
    if any(n != plan.blocks_per_sm for n in blocks.values()):
        raise RuntimeError(f"the tiled kernel fits {blocks} blocks per SM, "
                           f"not {plan.blocks_per_sm}")
    gplan = tk.gather_plan(N_BIG, N_BIG, N_BIG, N_CHAINS)
    regs = {name: v for name, v in cuda_build.ptxas_functions(
        info.ptxas).items() if "tsc_gather_tiled_kernel" in name}
    gblocks = {geom: lib.tsc_gather_tiled_blocks_per_sm(gplan.box_cells, slab)
               for geom, slab in (("dense", 0), ("slab", 1))}
    for name, v in regs.items():
        geom = "slab" if "SlabX" in name else "dense"
        print(f"  tiled gather ({geom}): {v['registers']} registers, "
              f"{v['stack']} bytes stack frame, {v['spill_stores']} bytes "
              f"spill stores, {v['spill_loads']} bytes spill loads")
    print(f"  tiled gather: {gplan.threads} threads, box {gplan.box_cells} "
          f"cells, {gplan.smem_bytes} B of shared memory, resident blocks per "
          f"SM {gblocks} (planned {gplan.blocks_per_sm})")
    if len(regs) != 2 or any(v["spill_stores"] or v["spill_loads"]
                             for v in regs.values()):
        raise RuntimeError(f"the tiled gather spills: {regs}")
    if any(n < gplan.blocks_per_sm for n in gblocks.values()):
        raise RuntimeError(f"the tiled gather fits {gblocks} blocks per SM, "
                           f"fewer than {gplan.blocks_per_sm}")


def rank_worker(tmp: str, device_type: str):
    """One rank of `--ranks N` (started by torch.distributed.run): the
    sharded posterior at 256^3 on a 1 x N layout against the dense
    posterior on this rank's card, then the three `--sharded` command-line
    calls on a (2, N/2) layout (N even), launch counters checked on every
    rank.  Rank 0 prints; the other ranks log to files in `tmp`."""
    pdist.initialize_multihost(device=device_type)
    rank = torch.distributed.get_rank()
    world = torch.distributed.get_world_size()
    if rank:
        sys.stdout = open(Path(tmp) / f"rank{rank}.log", "w", buffering=1)
    dev = pdist.rank_device(device_type)
    torch.backends.cuda.matmul.allow_tf32 = False
    work = Path(tmp) / f"rank{rank}"
    work.mkdir()
    conf = RunConfig.from_input_par(write_input_par(work))
    runner = Runner(conf, out_dir=work, device=dev)
    runner.setup(n_chains=1)
    print(f"== rank {rank} of {world} on {dev}: sharded psi on 1 x {world}",
          flush=True)
    phase_sharded_psi256(dev, runner)
    runner.close()
    del runner
    chains = 2 if world % 2 == 0 else 1
    print(f"== --sharded command line on {chains} x {world // chains}",
          flush=True)
    launches = phase_cli256(dev, tmp, sharded=True, chains=chains)
    print(f"  launches over the three calls on rank {rank}: {launches}")
    torch.distributed.destroy_process_group()


def phase_ranks(n: int, tmp: str, seconds: float):
    """`rank_worker` on n ranks of this machine's cards, through
    torch.distributed.run; raises if any rank fails."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n}", str(Path(__file__).resolve()),
           "--rank-worker", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=seconds)
    print(proc.stdout, flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-6000:], flush=True)
        for log in sorted(Path(tmp).glob("rank*.log")):
            print(f"--- {log.name}:\n{log.read_text()[-3000:]}")
        raise RuntimeError(f"{n}-rank run failed ({proc.returncode})")


def main(argv=None):
    """No arguments: every phase on one card.  `--ranks N`: the device and
    build phases, then the sharded path on N cards of this machine
    (`rank_worker`).  `--rank-worker DIR` is the internal entry of one
    such rank."""
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--rank-worker"]:
        return rank_worker(argv[1], argv[3] if argv[2:3] == ["--device"]
                           else "cuda")
    ranks = int(argv[1]) if argv[:1] == ["--ranks"] else 1
    clock = Clock()
    tmp_dirs = []
    try:
        clock.start("device")
        if not torch.cuda.is_available():
            raise RuntimeError("torch.cuda.is_available() is False: "
                               "chip_smoke.py needs a CUDA card")
        dev = torch.device("cuda")
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"  device {kind}, count {count}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}")
        print(smi, flush=True)
        clock.done()

        clock.start("build")
        _, info = cuda_build.load()
        print(f"  library {info.path.name}: "
              f"{'built in %.2f s' % info.seconds if info.built else 'loaded'}")
        for line in info.ptxas.splitlines():
            if any(k in line for k in ("Compiling", "registers", "spill",
                                       "smem")):
                print("  ptxas:", line.strip())
        phase_build_checks(info)
        clock.done()

        if ranks > 1:
            clock.start(f"sharded_ranks{ranks}")
            if count < ranks:
                raise RuntimeError(f"--ranks {ranks} needs {ranks} cards, "
                                   f"this machine has {count}")
            tmp_dirs.append(tempfile.mkdtemp(prefix="chip_smoke_"))
            phase_ranks(ranks, tmp_dirs[-1], BUDGET_S)
            clock.done()
            print(smi)
            print(json.dumps({"ok": True, "device": {
                "platform": "gpu", "kind": kind, "count": count}}),
                flush=True)
            return

        clock.start("determinism")
        phase_determinism(dev)
        clock.done()

        clock.start("spectrum_determinism")
        phase_spectrum_determinism(dev)
        clock.done()

        clock.start("kernels")
        tmp_dirs.append(tempfile.mkdtemp(prefix="chip_smoke_"))
        runner, delta, inputs, errs = phase_kernels(dev, headline_conf(),
                                                    tmp_dirs[-1])
        clock.done()

        clock.start("psi")
        phase_psi(runner, delta)
        runner.close()
        del runner
        clock.done()

        clock.start("path")
        tmp_dirs.append(tempfile.mkdtemp(prefix="chip_smoke_"))
        launches, per_attempt = phase_path(dev, headline_conf(),
                                           tmp_dirs[-1])
        clock.done()

        clock.start("masskernels")
        phase_masskernels(dev, inputs)
        clock.done()

        clock.start("options")
        tmp_dirs.append(tempfile.mkdtemp(prefix="chip_smoke_"))
        phase_options(dev, tmp_dirs[-1])
        clock.done()

        clock.start("radial_path")
        tmp_dirs.append(tempfile.mkdtemp(prefix="chip_smoke_"))
        phase_path(dev, radial_conf(), tmp_dirs[-1])
        clock.done()

        clock.start("sph_cli")
        tmp_dirs.append(tempfile.mkdtemp(prefix="chip_smoke_"))
        phase_cli256(dev, tmp_dirs[-1], par_text=REFERENCE_PAR.format(
            n=N_GRID, box=BOX))
        clock.done()

        clock.start("kernels256")
        tmp_dirs.append(tempfile.mkdtemp(prefix="chip_smoke_"))
        conf256 = RunConfig.from_input_par(write_input_par(tmp_dirs[-1]))
        runner, delta, inputs256, errs256 = phase_kernels256(
            dev, conf256, tmp_dirs[-1])
        clock.done()

        clock.start("psi256")
        phase_psi(runner, delta[:1])
        del delta
        clock.done()

        clock.start("slab_kernels")
        slab, slab_errs = phase_slab_kernels(dev, inputs, inputs256)
        clock.done()

        clock.start("sharded_psi256")
        phase_sharded_psi256(dev, runner)
        runner.close()
        del runner
        clock.done()

        clock.start("cli256")
        tmp_dirs.append(tempfile.mkdtemp(prefix="chip_smoke_"))
        path256 = {}
        launches256 = phase_cli256(dev, tmp_dirs[-1], keep=path256)
        clock.done()

        clock.start("sharded_cli256")
        tmp_dirs.append(tempfile.mkdtemp(prefix="chip_smoke_"))
        launches_sh = phase_cli256(dev, tmp_dirs[-1], sharded=True)
        clock.done()

        clock.start("timing")
        rows = phase_timing(inputs, errs, launches, per_attempt, inputs256,
                            errs256, launches256, path256, slab, slab_errs,
                            launches_sh)
        clock.done()

        print(smi)
        print(json.dumps({"kernels": rows}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        for d in tmp_dirs:
            shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__":
    main()
