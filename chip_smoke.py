#!/usr/bin/env python3
"""Smoke run of barcode_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path — `Runner(conf).setup(n_chains=2)` and one
bounded `run` of the 128^3 headline configuration (ALPT + plane-parallel
RSD, sph_ft, Gaussian likelihood, mass type 1, N_eps_fac=8, the kernel
deposit with the halo-tail split) — and checks the CUDA kernels on the way:

  1. device   card name, count and `nvidia-smi` name/power limit
  2. build    nvcc build of csrc/*.cu (sm_90a) and its ptxas report
  3. kernels  K1 (deposit) and K2 (gather) against their plain PyTorch
              versions at 32^3 with forced contract violators and at the
              headline 128^3 shapes with 2 chains; K1 is deterministic
  4. psi      psi and grad psi at 128^3 on the card (kernels) and on the
              CPU (plain versions) from the same delta
  5. path     the Runner session, with the kernel launch counters set to 0
              just before it and checked against the expected count after
              (K1 also runs in the deltaEUL/deltaRSS dumps of each sample)
  6. timing   CUDA-event times of each kernel at the headline shapes

Every phase raises on failure, so any failure exits non-zero.  It needs a
card: without one (or without the package beside it) it exits non-zero
before printing any result.  Output dumps go to a temporary directory
outside the checkout; only the git-ignored kernel build directory is
written inside it.  The last line is the JSON result
{"ok": true, "device": {...}}; the line before it lists the kernels.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import tempfile
import time

import torch

from barcode_tpu_torch import cuda_build
from barcode_tpu_torch.config import HMCConfig, RunConfig
from barcode_tpu_torch.forward import assign
from barcode_tpu_torch.forward import tsc_kernels as tk
from barcode_tpu_torch.forward.lag2eul import ForwardConfig, displaced_positions
from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.model.posterior import ModelConfig, make_psi_value_and_grad
from barcode_tpu_torch.runner import Runner

BUDGET_S = 540.0          # well under half of the 1200 s the run may take
N_GRID, BOX = 128, 200.0  # headline configuration (bench.py:60-155)
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


def violator_positions(g: GridSpec, chains: int, n_viol: int, dev):
    """Jittered lattice with n_viol particles per chain pushed 4.2 cells in x
    and -3.6 in y: violators of a halo-3 contract."""
    gen = torch.Generator(device=dev).manual_seed(3)
    d = torch.tensor(g.cell, device=dev).reshape(3, 1, 1, 1)
    idx = torch.stack(torch.meshgrid(*[torch.arange(n, device=dev)
                                       for n in g.shape], indexing="ij"))
    pos = (idx + 0.5) * d + 0.8 * d * torch.randn(
        (chains, 3) + g.shape, generator=gen, device=dev)
    sel = torch.rand((chains,) + g.shape, generator=gen, device=dev) \
        < n_viol / g.N
    pos[:, 0] += sel * 4.2 * d[0]
    pos[:, 1] -= sel * 3.6 * d[1]
    L = torch.tensor([g.L1, g.L2, g.L3], device=dev).reshape(3, 1, 1, 1)
    return torch.remainder(pos, L).contiguous()


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
    for want_value in (False, True):
        out = tk.tsc_gather_grads_window(cot, pos, g, halo, block, want_value)
        sync(pos.device)
        ref = tk.tsc_gather_grads_window_plain(cot, pos, g, halo, block,
                                               want_value)
        errs[f"K2 value={want_value}"] = compare(
            f"K2 want_value={want_value}", out, ref, TOL_GATHER_REL)
    return errs


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
    (psi_d, _), grad_d = make_psi_value_and_grad(g, mc, gp, runner.obs)(delta)
    sync(delta.device)
    vag_cpu = make_psi_value_and_grad(g, mc, gp, runner.obs.to("cpu"))
    (psi_c, _), grad_c = vag_cpu(delta.cpu())
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


def phase_timing(inputs, errs, launches, per_attempt):
    """CUDA-event times of K1/K2 and their plain versions at the headline
    shapes, with each kernel's bound; returns the kernels' JSON rows."""
    g, pos, ok, cot = inputs["g"], inputs["pos"], inputs["ok"], inputs["cot"]
    halo, block, block_dep = inputs["halo"], inputs["block"], inputs["block_dep"]
    n_part = pos.shape[0] * g.N
    n_active = int(ok.sum())  # zero-weight particles skip their taps
    kernels = (
        ("K1", "tsc_deposit_window",
         lambda: tk.tsc_deposit_window(pos, g, halo, block_dep, weights=ok),
         lambda: tk.tsc_deposit_window_plain(pos, g, halo, block_dep,
                                             weights=ok),
         n_part * (12 + 4 + 4), n_active * OPS_K1, errs["K1 weighted"],
         "barcode_tpu_torch/csrc/tsc_deposit.cu",
         "barcode_tpu/forward/pallas_deposit.py:789"),
        ("K2", "tsc_gather_grads_window",
         lambda: tk.tsc_gather_grads_window(cot, pos, g, halo, block, False),
         lambda: tk.tsc_gather_grads_window_plain(cot, pos, g, halo, block,
                                                  False),
         n_part * (4 + 12 + 12), n_part * OPS_K2, errs["K2 value=False"],
         "barcode_tpu_torch/csrc/tsc_gather.cu",
         "barcode_tpu/forward/pallas_deposit.py:530"))
    rows = []
    for key, name, fn, plain, nbytes, ops, err, src, rep in kernels:
        ms = cuda_ms(fn, 50)
        plain_ms = cuda_ms(plain, 5, warmup=1)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_FLOPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[key], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None})
        print(f"  {key} {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms), bound "
              f"{max(t_bytes, t_ops) * 1e3:.2f} us ({nbytes / 1e6:.1f} MB, "
              f"{ops / 1e9:.3f} GFLOP), {launches[key]} launches on the "
              f"path, {per_attempt[key]} per attempt")
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

        clock.start("timing")
        rows = phase_timing(inputs, errs, launches, per_attempt)
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
