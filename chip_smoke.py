#!/usr/bin/env python3
"""Smoke run of barcode_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Drives the port's two paths and checks the CUDA kernels on the way:
  * the 128^3 headline configuration (bench.py:60-155: ALPT +
    plane-parallel RSD, sph_ft, Gaussian likelihood, mass type 1,
    N_eps_fac=8, the kernel deposit with the halo-tail split) through
    `Runner(conf).setup(n_chains=2)` and one bounded `run`;
  * the same model at 256^3 (bench.py's BENCH_N=256, box 200) as users run
    it, through the command line `python -m barcode_tpu_torch input.par`:
    a session, a resume from checkpoint.npz and a restart from the dumps.

Phases:
  1. device       card name, count and `nvidia-smi` name/power limit
  2. build        nvcc build of csrc/*.cu (sm_90a) and its ptxas report
  3. determinism  the windowless and tail-split deposits (fixed point) give
                  the same bits on every call at 128^3
  4. kernels      K1 (deposit) and K2 (gather) against their plain PyTorch
                  versions at 32^3 with forced contract violators and at the
                  headline 128^3 shapes with 2 chains; K1 is deterministic
  5. psi          psi and grad psi at 128^3 on the card (kernels) and on the
                  CPU (plain versions) from the same delta
  6. path         the 128^3 Runner session, with the kernel launch counters
                  set to 0 just before it and checked against the expected
                  count after (K1 also runs in the deltaEUL/deltaRSS dumps)
  7. kernels256   K1s (the streamed-window deposit, which the stream gate
                  selects at 256^3) against its plain version, against K1
                  and against itself at the 256^3 shapes, and with forced
                  violators at 32^3 where the window is wider than the grid;
                  K2 against its plain version at the 256^3 shapes
  8. psi256       psi and grad psi at 256^3 (one chain), card against CPU
  9. cli256       three command-line calls at 256^3 (session; --resume with
                  --profile; restart from deltaLAG_2 + the performance log),
                  each with the launch counters zeroed before it and checked
                  after; the profile's top kernels by device time
 10. timing       CUDA-event times of each kernel at its path's shapes

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
import json
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from barcode_tpu_torch import cli, cuda_build
from barcode_tpu_torch import io as bio
from barcode_tpu_torch.config import HMCConfig, RunConfig
from barcode_tpu_torch.forward import assign
from barcode_tpu_torch.forward import tsc_kernels as tk
from barcode_tpu_torch.forward.lag2eul import ForwardConfig, displaced_positions
from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.model.posterior import ModelConfig, make_psi_value_and_grad
from barcode_tpu_torch.runner import Runner

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
# K1s does K1's arithmetic per particle (the bound counts the work the
# function needs, not the window re-reads of this design)
OPS_K1S = OPS_K1
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


def check_gather(cot, pos, g, halo, block):
    """K2 with and without the value against its plain version; returns
    the errors keyed "K2 value=<want_value>"."""
    errs = {}
    for want_value in (False, True):
        out = tk.tsc_gather_grads_window(cot, pos, g, halo, block, want_value)
        sync(pos.device)
        ref = tk.tsc_gather_grads_window_plain(cot, pos, g, halo, block,
                                               want_value)
        errs[f"K2 value={want_value}"] = compare(
            f"K2 want_value={want_value}", out, ref, TOL_GATHER_REL)
    return errs


def check_kernels(label, g, pos, halo, block_dep, block, weights, cot):
    """K1 (unweighted + weighted) and K2 (with and without the value)
    against the plain versions; returns the errors of the main-path calls."""
    print(f"  [{label}] grid {g.shape}, chains {pos.shape[0]}, halo {halo}, "
          f"K1 block {block_dep}, K2 block {block}, violators "
          f"{tk.deposit_violations(pos, g, halo).tolist()}", flush=True)
    errs = {}
    for w, tag in ((None, "unweighted"), (weights, "weighted")):
        out = tk.tsc_deposit_window(pos, g, halo, block_dep, weights=w)
        sync(pos.device)
        ref = tk.tsc_deposit_window_plain(pos, g, halo, block_dep, weights=w)
        errs[f"K1 {tag}"] = compare(f"K1 {tag}", out, ref, TOL_DEP_REL)
    errs.update(check_gather(cot, pos, g, halo, block))
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
    rho1 = tk.tsc_deposit_window(pos, g, fc.pallas_halo, block_dep, weights=ok)
    rho2 = tk.tsc_deposit_window(pos, g, fc.pallas_halo, block_dep, weights=ok)
    spread = (rho1 - rho2).abs().max().item()
    print(f"  K1 run-to-run max|diff| {spread:.3e} (deterministic: 0 expected)")
    if spread != 0.0:
        raise RuntimeError("K1 is not deterministic")
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
    tk.tsc_deposit_window.launches = 0
    tk.tsc_gather_grads_window.launches = 0
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
    launches = {"K1": tk.tsc_deposit_window.launches,
                "K2": tk.tsc_gather_grads_window.launches}
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
    expected = {"K1": 1 + grads_per_step * steps + n_dumps,
                "K2": 1 + grads_per_step * steps} if on_card else \
        {"K1": 0, "K2": 0}
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
    if launches != expected or (on_card and 0 in launches.values()):
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


def check_stream(label, g, pos, halo, block, weights):
    """K1s against the plain version (tolerance), against K1 and against
    itself (bit for bit); returns its error."""
    out = tk.tsc_deposit_window(pos, g, halo, block, weights=weights,
                                stream=True)
    again = tk.tsc_deposit_window(pos, g, halo, block, weights=weights,
                                  stream=True)
    k1 = tk.tsc_deposit_window(pos, g, halo, block, weights=weights,
                               stream=False)
    sync(pos.device)
    ref = tk.tsc_deposit_window_plain(pos, g, halo, block, weights=weights)
    err = compare(f"K1s {label} vs plain", out, ref, TOL_DEP_REL)
    same_k1, same = torch.equal(out, k1), torch.equal(out, again)
    print(f"  K1s {label}: == K1 {same_k1}, == itself {same}")
    if not (same_k1 and same):
        raise RuntimeError(f"K1s {label} differs from K1 or from itself")
    return err


def phase_kernels256(dev, conf: RunConfig, tmp: str):
    """K1s at the 256^3 configuration's shapes: its displaced positions
    (the mock truth and half of it, through the forward model), its
    resolved halo and block, with and without the tail weights; K2 on the
    same positions at the path's gather block; then K1s at 32^3 with block
    (16, 16), hx 12 and forced violators (WX = 40 > 32)."""
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
          f"against {tk.DEP_VMEM_BUDGET} B: stream chosen weighted "
          f"{chosen[True]}, unweighted {chosen[False]}")
    if not chosen[True]:
        raise RuntimeError("the stream gate did not choose K1s at 256^3")
    errs = {tag: check_stream(f"{g.N1}^3 {tag}", g, pos, halo, block_dep, w)
            for tag, w in (("unweighted", None), ("weighted", ok))}
    block = tuple(fc.pallas_block)
    cot = torch.randn((N_CHAINS,) + g.shape, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(13))
    print(f"  K2 at {g.N1}^3: halo {halo}, block {block}, chains {N_CHAINS}")
    errs.update(check_gather(cot, pos, g, halo, block))
    g32 = GridSpec.cube(32, 32 * BOX / N_GRID)
    pos32 = violator_positions(g32, N_CHAINS, 200, dev)
    w32 = torch.rand((N_CHAINS,) + g32.shape,
                     generator=torch.Generator(device=dev).manual_seed(11),
                     device=dev)
    print(f"  32^3, halo 12, block (16, 16): WX "
          f"{16 + 2 * tk._round_halo(12, 16)} > N 32, violators "
          f"{tk.deposit_violations(pos32, g32, 3).tolist()} (of halo 3)")
    for tag, w in (("unweighted", None), ("weighted", w32)):
        check_stream(f"32^3 wide window {tag}", g32, pos32, 12, (16, 16), w)
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
    """Device time by CUDA kernel name in a torch.profiler Chrome trace."""
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
    for name, us in total.most_common(n):
        print(f"    {us / 1e3:10.2f} ms {us / busy:6.1%} {count[name]:6d}x  "
              f"{name[:110]}")


def phase_cli256(dev, tmp: str):
    """Three command-line calls at 256^3: a session; --resume with
    --profile; a restart from deltaLAG_2 + the performance log after
    checkpoint.npz is removed.  Launch counters are zeroed before each call
    and checked after it.  Returns the path's launches of each kernel."""
    par = write_input_par(tmp)
    out = Path(tmp) / "run"
    prof = Path(tmp) / "prof"
    common = ["--chains", str(N_CHAINS), "--no-dashboard", "--out", str(out),
              "--device", dev.type]
    on_card = dev.type == "cuda"
    calls = (("session", [str(par), *common, "--samples", "1", "--nan-check"]),
             ("resume", [str(par), *common, "--resume", "--samples", "2",
                         "--profile", str(prof)]),
             ("restart", [str(par), "2", *common, "--samples", "3"]))
    total = collections.Counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    last = None
    for name, argv in calls:
        if name == "restart":
            for suffix in (".npz", ".json"):
                (out / f"checkpoint{suffix}").unlink()
        rows0, dumps0 = _perflog_rows(out), _sample_dumps(out)
        sync(dev)
        for f in (tk.tsc_deposit_window, tk.tsc_deposit_window_stream,
                  tk.tsc_gather_grads_window):
            f.launches = 0
        t0 = time.perf_counter()
        args = cli.parse_args(argv)
        runner = cli.open_session(args)
        sync(dev)
        t1 = time.perf_counter()
        if name == "restart":
            lag2 = torch.from_numpy(bio.read_array(out / "deltaLAG_2",
                                                   runner.g.shape))
            same = torch.equal(runner.states.delta[0].cpu(), lag2)
            print(f"  restart: chain 0's delta == deltaLAG_2 bit for bit: "
                  f"{same}")
            if not same:
                raise RuntimeError("the restart did not resume deltaLAG_2")
        cli.run_session(runner, args)
        sync(dev)
        t2 = time.perf_counter()
        launches = {"K1s": tk.tsc_deposit_window_stream.launches,
                    "K1": tk.tsc_deposit_window.launches,
                    "K2": tk.tsc_gather_grads_window.launches}
        attempts = _perflog_rows(out) - rows0
        dumps1 = _sample_dumps(out)
        new = sorted(set(dumps1) - set(dumps0))
        rewritten = sorted(k for k in dumps0 if dumps1[k] != dumps0[k])
        n_dep = sum(1 for k in new if k.startswith(("deltaEUL_", "deltaRSS_")))
        grads = 1 + (name == "restart") + 8 * attempts  # N_eps_fac = 8
        # kernels launch only where they are on the CUDA device
        expected = {"K1s": grads + n_dep, "K1": 0, "K2": grads} if on_card \
            else {"K1s": 0, "K1": 0, "K2": 0}
        ck = np.load(out / "checkpoint.npz")
        accepted, psi = ck["state_accepted"], ck["state_psi"]
        steps = 8 * attempts
        print(f"  {name}: setup {t1 - t0:.2f} s, run {t2 - t1:.2f} s: "
              f"{attempts} attempts, {steps} steps, {steps / (t2 - t1):.3f} "
              f"steps/s ({N_CHAINS * steps / (t2 - t1):.3f} chain-steps/s)"
              f"{' with the profiler on' if name == 'resume' else ''}")
        if on_card:
            print(f"  {name}: max_memory_allocated "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        print(f"  {name}: accepted {accepted.tolist()}, psi {psi.tolist()}, "
              f"new dumps {new}, rewritten {rewritten}")
        print(f"  {name}: launches {launches}, expected {expected} (init"
              f"{' + restart' if name == 'restart' else ''} + 8 per attempt;"
              f" K1s also one per dumped field: {n_dep})")
        if launches != expected:
            raise RuntimeError(f"{name}: kernel launches {launches} != "
                               f"{expected}")
        if not np.isfinite(psi).all() or attempts == 0 or rewritten:
            raise RuntimeError(f"{name}: non-finite psi, no attempt, or a "
                               "sample dumped twice")
        if name == "resume" and not (accepted > last).all():
            raise RuntimeError(f"resume: accepted did not continue from {last}")
        last = accepted
        total.update(launches)
        if name == "resume":
            top_kernels(prof / "trace.json")
            shutil.rmtree(prof)
    return dict(total)


def phase_timing(inputs, errs, launches, per_attempt, inputs256, errs256,
                 launches256):
    """CUDA-event times of each kernel and its plain version at its path's
    shapes (K1, K2 at 128^3; K1s, K2 and, beside them, K1 at 256^3), with
    each kernel's bound; returns the kernels' JSON rows."""
    g, pos, ok, cot = inputs["g"], inputs["pos"], inputs["ok"], inputs["cot"]
    halo, block, block_dep = inputs["halo"], inputs["block"], inputs["block_dep"]
    n_part = pos.shape[0] * g.N
    n_active = int(ok.sum())  # zero-weight particles skip their taps
    g2, pos2, ok2 = inputs256["g"], inputs256["pos"], inputs256["ok"]
    halo2, block2 = inputs256["halo"], inputs256["block_dep"]
    cot2, gblock2 = inputs256["cot"], inputs256["block"]
    n_part2, n_active2 = pos2.shape[0] * g2.N, int(ok2.sum())
    dep_src = "barcode_tpu_torch/csrc/tsc_deposit.cu"
    dep_rep = "barcode_tpu/forward/pallas_deposit.py:789"
    gat_src = "barcode_tpu_torch/csrc/tsc_gather.cu"
    gat_rep = "barcode_tpu/forward/pallas_deposit.py:530"
    plain2 = lambda: tk.tsc_deposit_window_plain(pos2, g2, halo2, block2,
                                                 weights=ok2)
    kernels = (
        ("K1", "tsc_deposit_window",
         lambda: tk.tsc_deposit_window(pos, g, halo, block_dep, weights=ok),
         lambda: tk.tsc_deposit_window_plain(pos, g, halo, block_dep,
                                             weights=ok),
         n_part * (12 + 4 + 4), n_active * OPS_K1, errs["K1 weighted"],
         dep_src, dep_rep, launches["K1"], f"{per_attempt['K1']} per attempt"),
        ("K2", "tsc_gather_grads_window",
         lambda: tk.tsc_gather_grads_window(cot, pos, g, halo, block, False),
         lambda: tk.tsc_gather_grads_window_plain(cot, pos, g, halo, block,
                                                  False),
         n_part * (4 + 12 + 12), n_part * OPS_K2, errs["K2 value=False"],
         gat_src, gat_rep, launches["K2"], f"{per_attempt['K2']} per attempt"),
        ("K1s", "tsc_deposit_window_stream",
         lambda: tk.tsc_deposit_window(pos2, g2, halo2, block2, weights=ok2,
                                       stream=True),
         plain2, n_part2 * (12 + 4 + 4), n_active2 * OPS_K1S,
         errs256["weighted"], "barcode_tpu_torch/csrc/tsc_deposit_stream.cu",
         "barcode_tpu/forward/pallas_deposit.py:274", launches256["K1s"],
         f"{N_BIG}^3 command-line path, 8 per attempt"),
        ("K2@256", f"tsc_gather_grads_window ({N_BIG}^3)",
         lambda: tk.tsc_gather_grads_window(cot2, pos2, g2, halo2, gblock2,
                                            False),
         lambda: tk.tsc_gather_grads_window_plain(cot2, pos2, g2, halo2,
                                                  gblock2, False),
         n_part2 * (4 + 12 + 12), n_part2 * OPS_K2, errs256["K2 value=False"],
         gat_src, gat_rep, launches256["K2"],
         f"{N_BIG}^3 command-line path, 8 per attempt"),
        ("K1@256", f"tsc_deposit_window ({N_BIG}^3, stream=False)",
         lambda: tk.tsc_deposit_window(pos2, g2, halo2, block2, weights=ok2,
                                       stream=False),
         plain2, n_part2 * (12 + 4 + 4), n_active2 * OPS_K1,
         errs256["weighted"], dep_src, dep_rep, launches256["K1"],
         f"{N_BIG}^3 command-line path: K1s runs there"))
    rows = []
    for key, name, fn, plain, nbytes, ops, err, src, rep, n_launch, note in \
            kernels:
        ms = cuda_ms(fn, 20)
        plain_ms = cuda_ms(plain, 3, warmup=1)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_FLOPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": n_launch, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None})
        print(f"  {key} {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms), bound "
              f"{max(t_bytes, t_ops) * 1e3:.2f} us ({nbytes / 1e6:.1f} MB, "
              f"{ops / 1e9:.3f} GFLOP), {n_launch} launches on the path "
              f"({note})")
    return rows


def main():
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
        clock.done()

        clock.start("determinism")
        phase_determinism(dev)
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

        clock.start("kernels256")
        tmp_dirs.append(tempfile.mkdtemp(prefix="chip_smoke_"))
        conf256 = RunConfig.from_input_par(write_input_par(tmp_dirs[-1]))
        runner, delta, inputs256, errs256 = phase_kernels256(
            dev, conf256, tmp_dirs[-1])
        clock.done()

        clock.start("psi256")
        phase_psi(runner, delta[:1])
        runner.close()
        del runner, delta
        clock.done()

        clock.start("cli256")
        tmp_dirs.append(tempfile.mkdtemp(prefix="chip_smoke_"))
        launches256 = phase_cli256(dev, tmp_dirs[-1])
        clock.done()

        clock.start("timing")
        rows = phase_timing(inputs, errs, launches, per_attempt, inputs256,
                            errs256, launches256)
        clock.done()

        print(smi)
        print(json.dumps({"kernels": rows}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    finally:
        for d in tmp_dirs:
            shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__":
    main()
