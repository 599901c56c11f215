"""Multi-process runs of the port's sharded path for the tests (CPU, gloo).

`launch(name, world, inputs, tmp_path)` starts `world` fresh Python
processes, each running the worker function `name` of this module as one
rank of a gloo process group, and returns each rank's outputs.  Inputs and
outputs travel as .npz files; the workers import torch, numpy and
barcode_tpu_torch only, never JAX (the parent test computes the JAX
references).  The rendezvous is a TCPStore that the parent binds to port 0;
every process has its own deadline and is killed when it passes, so a
stuck collective fails the test instead of hanging it.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def launch(name: str, world: int, inputs: dict, tmp_path, timeout=120.0):
    """Run worker `name` on `world` ranks; returns a list of output dicts."""
    import torch.distributed as dist

    tmp_path = Path(tmp_path)
    np.savez(tmp_path / f"{name}_in.npz", **inputs)
    store = dist.TCPStore("127.0.0.1", 0, world + 1, is_master=True,
                          wait_for_workers=False, timeout=__import__(
                              "datetime").timedelta(seconds=timeout))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), str(HERE)])
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = []
    for rank in range(world):
        cmd = [sys.executable, "-c",
               "import torch_workers; torch_workers._child()",
               name, str(rank), str(world), str(store.port), str(tmp_path)]
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1.0))
            logs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"{name}: workers did not finish within "
                             f"{timeout} s")
    finally:
        del store
    bad = [(r, p.returncode, logs[r][-3000:]) for r, p in enumerate(procs)
           if p.returncode != 0]
    assert not bad, f"{name}: failed ranks {bad}"
    return [dict(np.load(tmp_path / f"{name}_out{r}.npz"))
            for r in range(world)]


def _child():
    import datetime

    import torch
    import torch.distributed as dist

    name, rank, world, port, tmp = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    store = dist.TCPStore("127.0.0.1", int(port), world + 1, is_master=False,
                          timeout=datetime.timedelta(seconds=120))
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    tmp = Path(tmp)
    inp = dict(np.load(tmp / f"{name}_in.npz"))
    out = globals()[name](rank, world, inp, tmp)
    np.savez(tmp / f"{name}_out{rank}.npz", **out)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# shared builders (plain numpy in, port objects out)
# ---------------------------------------------------------------------------

def _grid(inp):
    from barcode_tpu_torch.grid.spec import GridSpec
    return GridSpec.cube(int(inp["N"]), float(inp["L"]))


def _gp():
    from barcode_tpu_torch.forward.lag2eul import GrowthParams
    return GrowthParams(D1=1.0, D2=-3.0 / 7.0, ascale=1.0, cpecvel=52.85,
                        hubble=100.0)


def _obs(inp, layout, prefix=""):
    """This rank's slabs of the JAX package's full ObsData fields."""
    from barcode_tpu_torch import convert
    return convert.sharded_obs(
        {k: inp[prefix + k] for k in ("nobs", "window", "noise", "power")},
        layout.n_grid, layout.col, device="cpu")


# ---------------------------------------------------------------------------
# workers
# ---------------------------------------------------------------------------

def fft_worker(rank, world, inp, tmp):
    """Sharded rfft3/irfft3/convolve/displacement of a full field."""
    import torch

    from barcode_tpu_torch.parallel import distributed as pd
    from barcode_tpu_torch.parallel import sharded_fft as sf

    g = _grid(inp)
    layout = pd.make_layout(1, world, device="cpu")
    rfft3, irfft3, convolve, displacement = sf.make_sharded_ops(g, layout)
    x = sf.shard_real(torch.from_numpy(inp["x"]), layout).contiguous()
    F = rfft3(x)
    gauss = lambda kx, ky, kz: torch.exp(-(kx * kx + ky * ky + kz * kz) * 4.0)
    # the adjoint: grad of sum(w * irfft3(rfft3(x) * K)) for a real K is
    # the same convolution applied to w
    xg = x.clone().requires_grad_(True)
    w = sf.shard_real(torch.from_numpy(inp["w"]), layout)
    (gx,) = torch.autograd.grad((w * convolve(xg, gauss)).sum(), xg)
    return {"F": F.numpy(), "back": irfft3(F).numpy(),
            "conv": convolve(x, gauss).numpy(), "disp": displacement(x).numpy(),
            "conv_grad": gx.numpy(), "conv_w": convolve(w, gauss).numpy()}


def _fc(inp, k):
    from barcode_tpu_torch.forward.lag2eul import ForwardConfig
    return ForwardConfig(sfmodel=int(inp[f"c{k}_sfmodel"]),
                         masskernel=str(inp[f"c{k}_mk"]),
                         rsd=bool(inp[f"c{k}_rsd"]), slength=20.0,
                         pallas_deposit=bool(inp[f"c{k}_pallas"]),
                         pallas_halo=int(inp[f"c{k}_pallas_halo"]),
                         pallas_tail_k=int(inp[f"c{k}_tail_k"]))


def psi_worker(rank, world, inp, tmp):
    """Sharded psi and grad psi of each case on a 1 x world layout; rank 0
    also computes the dense port's psi and grad with the windowless
    deposit, for the full field."""
    import dataclasses

    import torch

    from barcode_tpu_torch import convert
    from barcode_tpu_torch.model.posterior import (ModelConfig,
                                                   make_psi_value_and_grad)
    from barcode_tpu_torch.parallel import distributed as pd
    from barcode_tpu_torch.parallel import sharded_fft as sf
    from barcode_tpu_torch.parallel import sharded_forward as sfw

    g = _grid(inp)
    layout = pd.make_layout(1, world, device="cpu")
    out = {}
    for k in range(int(inp["n_cases"])):
        fc = _fc(inp, k)
        obs = _obs(inp, layout, f"c{k}_")
        psi, grad = sfw.make_sharded_psi(g, ModelConfig(likelihood=1,
                                                        forward=fc),
                                         _gp(), layout,
                                         halo=int(inp[f"c{k}_halo"]))
        s_full = torch.from_numpy(inp[f"c{k}_s"])
        s = sf.shard_real(s_full, layout).contiguous()
        out[f"c{k}_psi"] = np.float64(psi(s, obs))
        out[f"c{k}_grad"] = grad(s, obs).numpy()
        if rank == 0:
            dense_obs = convert.obs_data({key: inp[f"c{k}_{key}"] for key in
                                          ("nobs", "window", "noise",
                                           "power")}, device="cpu")
            mc = ModelConfig(likelihood=1, forward=dataclasses.replace(
                fc, pallas_deposit=False))
            (v, _), gr = make_psi_value_and_grad(g, mc, _gp(), dense_obs)(
                s_full[None])
            out[f"c{k}_dense_psi"] = v.numpy()[0]
            out[f"c{k}_dense_grad"] = gr.numpy()[0]
    return out


def chains_worker(rank, world, inp, tmp):
    """make_sharded_psi_vg_chains on a rows x (world / rows) layout."""
    import torch

    from barcode_tpu_torch.model.posterior import ModelConfig
    from barcode_tpu_torch.parallel import distributed as pd
    from barcode_tpu_torch.parallel import sharded_fft as sf
    from barcode_tpu_torch.parallel import sharded_forward as sfw

    g = _grid(inp)
    rows = int(inp["rows"])
    cpr = int(inp["chains_per_rank"])
    layout = pd.make_layout(rows, world // rows, cpr, device="cpu")
    out = {}
    for k in range(int(inp["n_cases"])):
        obs = _obs(inp, layout, f"c{k}_")
        mc = ModelConfig(likelihood=1, forward=_fc(inp, k))
        vg = sfw.make_sharded_psi_vg_chains(g, mc, _gp(), layout,
                                            halo=int(inp[f"c{k}_halo"]))
        ids = layout.chain_ids
        batch = torch.from_numpy(inp[f"c{k}_batch"][ids.start:ids.stop])
        (vals, (pp, pl)), grads = vg(sf.shard_real(batch, layout).contiguous(),
                                     obs)
        out[f"c{k}_vals"] = vals.numpy()
        out[f"c{k}_grads"] = grads.numpy()
    out["row"], out["col"] = np.int64(layout.row), np.int64(layout.col)
    return out


def _runner_conf(inp, **hmc):
    from barcode_tpu_torch.config import RunConfig
    from barcode_tpu_torch.grid.spec import GridSpec

    c = RunConfig(grid=GridSpec.cube(16, 16.0), seed=3,
                  n_chains=int(inp["n_chains"]), initial_guess=4, N_Gibbs=2,
                  outnum=1)
    h = dataclasses.replace(c.hmc, eps_fac=0.3, eps_fac_update_type=2,
                            mass_type=1, N_a_eps_update=8, **hmc)
    model = dataclasses.replace(
        c.model, likelihood=1,
        forward=dataclasses.replace(c.model.forward, sfmodel=1,
                                    masskernel="tsc"))
    mock = dataclasses.replace(c.mock, random_test=True)
    return dataclasses.replace(c, hmc=h, model=model, mock=mock,
                               readPS=False)


def runner_worker(rank, world, inp, tmp):
    """ShardedRunner on a chains x grid layout: a session, a checkpoint
    round trip, a restart from the dumps, the type-2 mass cadence and the
    kinetic expectation of fresh momenta."""
    import torch

    from barcode_tpu_torch.parallel import distributed as pd
    from barcode_tpu_torch.parallel import sharded_sampler as ss
    from barcode_tpu_torch.parallel.sharded_runner import ShardedRunner

    rows = int(inp["rows"])
    layout = pd.make_layout(rows, world // rows, device="cpu")
    conf = _runner_conf(inp)
    out = {}
    # 1. end to end
    d1 = tmp / "run"
    r = ShardedRunner(conf, layout=layout, out_dir=d1, halo=2).setup()
    state = r.run(n_samples=1, max_attempts=40)
    out["e2e_accepted"] = r._gather_values(state["accepted"]).numpy()
    out["e2e_count"] = state["count_attempts"].numpy()
    (vals, _), _ = r._vg(state["delta"], r.obs_sh)
    out["e2e_psi"], out["e2e_psi_fresh"] = state["psi"].numpy(), vals.numpy()
    out["e2e_diag_chains"] = np.int64(len(r.diagnostics()["eps_fac"]))
    # 2. checkpoint round trip, then sampling continues
    p = r.checkpoint()
    before = {k: v.clone() for k, v in r.state.items()}
    r.close()
    r2 = ShardedRunner(conf, layout=layout, out_dir=d1, halo=2).setup()
    r2.restore(p)
    out["ckpt_equal"] = np.int64(all(torch.equal(r2.state[k], before[k])
                                     for k in before))
    r2.run(n_samples=2, max_attempts=40)
    out["ckpt_accepted"] = r2._gather_values(r2.state["accepted"]).numpy()
    r2.close()
    # 3. restart from deltaLAG_2 + the performance log
    r3 = ShardedRunner(conf, layout=layout, out_dir=d1, halo=2).setup()
    r3.restore_from_dumps(2)
    out["rfd_delta0"] = r3._gather_full(r3.state["delta"])[0].numpy()
    out["rfd_accepted"] = r3._gather_values(r3.state["accepted"]).numpy()
    out["rfd_count"] = r3.state["count_attempts"].numpy()
    out["rfd_eps"] = r3.state["eps_fac"].numpy()
    (vals, _), _ = r3._vg(r3.state["delta"], r3.obs_sh)
    out["rfd_psi"], out["rfd_psi_fresh"] = r3.state["psi"].numpy(), \
        vals.numpy()
    r3.run(n_samples=3, max_attempts=80, log=False)
    out["rfd_after"] = r3._gather_values(r3.state["accepted"]).numpy()
    r3.close()
    # 4. the type-2 mass recompute cadence
    c2 = _runner_conf(inp, massnum_burn=1, massnum_post=1)
    c2 = dataclasses.replace(c2, hmc=dataclasses.replace(c2.hmc, mass_type=2))
    r4 = ShardedRunner(c2, layout=layout, out_dir=tmp / "mass", halo=2).setup()
    m0 = r4.mass_f.clone()
    r4.run(n_samples=3, max_attempts=200, log=False)
    out["mass_at_sample"] = np.int64(r4._mass_at_sample)
    out["mass_changed"] = np.int64(not torch.allclose(m0, r4.mass_f))
    r4.close()
    # 5. momenta: E[1/2 p M^-1 p] = (N - 1)/2 (the k = 0 mode is massless);
    # eps ~ 0, so every attempt accepts with dH ~ 0
    hc = dataclasses.replace(conf.hmc, eps_fac=1e-6, eps_fac_update_type=0)
    att = ss.make_sharded_attempt(conf.grid, conf.model, r.gp, hc, layout,
                                  halo=2)
    st = dict(r.state)
    st["eps_fac"] = torch.full_like(st["eps_fac"], 1e-6)
    kin, dh, acc = [], [], []
    with torch.no_grad():
        for _ in range(int(inp["kinetic_attempts"])):
            st, stats = att(st, r.obs_sh, r.mass_f)
            kin.append(stats.H_kin_i.numpy())
            dh.append(stats.dH.numpy())
            acc.append(stats.accepted.numpy())
    out["kin"], out["kin_dh"], out["kin_acc"] = (np.stack(kin), np.stack(dh),
                                                 np.stack(acc))
    return out


def options_worker(rank, world, inp, tmp):
    """The slab posterior with each case's likelihood, sfmodel and
    delta_min (a TSC deposit without kernels) on a 1 x world layout."""
    import torch

    from barcode_tpu_torch.forward.lag2eul import (ForwardConfig,
                                                   GrowthParams)
    from barcode_tpu_torch.model.likelihoods import ObsData
    from barcode_tpu_torch.model.posterior import ModelConfig
    from barcode_tpu_torch.parallel import distributed as pd
    from barcode_tpu_torch.parallel import sharded_fft as sf
    from barcode_tpu_torch.parallel import sharded_forward as sfw

    g = _grid(inp)
    gp = GrowthParams(**{k[3:]: float(v) for k, v in inp.items()
                         if k.startswith("gp_")})
    layout = pd.make_layout(1, world, device="cpu")
    s = sf.shard_real(torch.from_numpy(inp["s"]), layout)[None].contiguous()
    out = {}
    for k in range(int(inp["n_cases"])):
        mc = ModelConfig(likelihood=int(inp[f"c{k}_likelihood"]),
                         forward=ForwardConfig(
                             sfmodel=int(inp[f"c{k}_sfmodel"]),
                             masskernel="tsc", slength=20.0))
        obs = sfw.shard_obs(ObsData(
            **{key: torch.from_numpy(inp[f"c{k}_{key}"])
               for key in ("nobs", "window", "noise", "power")},
            delta_min=float(inp[f"c{k}_delta_min"])), layout)
        vg = sfw.make_sharded_psi_vg_chains(g, mc, gp, layout,
                                            halo=int(inp["halo"]))
        (vals, _), grads = vg(s, obs)
        out[f"c{k}_psi"], out[f"c{k}_grad"] = vals.numpy(), grads[0].numpy()
    return out
