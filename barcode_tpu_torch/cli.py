"""Command-line entry point.

Usage (mirrors barcode/main.cc:65-220: run next to an input.par, optional
restart):

    python -m barcode_tpu_torch [input.par] [restart_iteration] [--resume]
        [--chains N] [--samples N] [--device {cuda,cpu}] ...

Port of barcode_tpu/cli.py: the same options and defaults, plus --device
(the card unless the CPU is asked for).  --sharded runs the slab-sharded
mode (`parallel.sharded_runner.ShardedRunner`) over a (chains, grid)
process layout: one process per device, NCCL on the card, gloo on the CPU.
Without --multihost or --coordinator it takes torchrun's environment when
set (`torchrun --nproc-per-node 2 -m barcode_tpu_torch input.par
--sharded`), else runs as a group of one.  --profile DIR writes a
torch.profiler trace (CPU + CUDA activities) of the sampling run as a
Chrome trace, DIR/trace.json.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
from pathlib import Path

from barcode_tpu_torch.config import RunConfig
from barcode_tpu_torch.runner import Runner


def parse_args(argv=None) -> argparse.Namespace:
    """Parse the command line (the options of barcode_tpu/cli.py:17-63,
    plus --device)."""
    p = argparse.ArgumentParser(prog="barcode_tpu_torch")
    p.add_argument("input_par", nargs="?", default="input.par",
                   help="parameter file (reference input.par format)")
    p.add_argument("restart_iteration", nargs="?", type=int, default=None,
                   help="restart marker (reference main.cc argv[1] semantics): "
                        "resume from checkpoint.npz when present, else from "
                        "the dumped deltaLAG_<k> + performance-log replay")
    p.add_argument("--resume", action="store_true",
                   help="restore sampler state from checkpoint.npz")
    p.add_argument("--chains", type=int, default=None)
    p.add_argument("--samples", type=int, default=None,
                   help="override N_Gibbs")
    p.add_argument("--out", default=None, help="output directory override")
    p.add_argument("--dashboard", action="store_true", default=None,
                   help="force the live candidate table (the ncurses-UI "
                        "equivalent; auto-enabled on a TTY)")
    p.add_argument("--no-dashboard", dest="dashboard", action="store_false")
    p.add_argument("--rhat-stop", type=float, default=None,
                   help="stop when cross-chain split R-hat of psi drops "
                        "below this threshold")
    p.add_argument("--nan-check", action="store_true",
                   help="abort on non-finite sampler state (the reference's "
                        "NAN_DETECTION trap)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler trace (CPU + CUDA) of the run "
                        "into DIR/trace.json (Chrome trace format; rank r > 0 "
                        "of --sharded writes DIR/trace_rank<r>.json)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device to run on (default: the CUDA card; raises "
                        "without one)")
    p.add_argument("--sharded", action="store_true",
                   help="config-5 mode: slab-shard every field over a "
                        "(chains, grid) process layout (grids too large for "
                        "one card); ranks/chains slabs per chain")
    p.add_argument("--halo", type=int, default=None,
                   help="deposit halo cells for --sharded (default: "
                        "displacement-bound heuristic)")
    p.add_argument("--coordinator", default=None,
                   help="multi-host: rendezvous address host:port "
                        "(tcp://); with --num-processes and --process-id")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--multihost", action="store_true",
                   help="initialize the process group from torchrun's "
                        "environment (env://) before building the layout")
    return p.parse_args(argv)


def _load_conf(args: argparse.Namespace) -> RunConfig:
    if Path(args.input_par).exists():
        return RunConfig.from_input_par(args.input_par)
    print(f"note: {args.input_par} not found, using built-in defaults")
    return RunConfig()


def open_session(args: argparse.Namespace):
    """Config, Runner (or ShardedRunner) setup, then --resume / restart
    (cli.py:67-111)."""
    if args.multihost or args.coordinator is not None:
        from barcode_tpu_torch.parallel.distributed import initialize_multihost
        initialize_multihost(args.coordinator, args.num_processes,
                             args.process_id, device=args.device)
    conf = _load_conf(args)
    # a resumed session's mock and initial-guess dumps are not written again
    resume = args.resume or args.restart_iteration is not None
    if args.sharded:
        from barcode_tpu_torch.parallel.sharded_runner import ShardedRunner
        if args.chains:
            conf = dataclasses.replace(conf, n_chains=args.chains)
        runner = ShardedRunner(conf, out_dir=args.out, halo=args.halo,
                               device=args.device).setup(resume=resume)
        ckpt = "checkpoint_sharded.npz"
    else:
        runner = Runner(conf, out_dir=args.out, device=args.device)
        runner.setup(n_chains=args.chains, resume=resume)
        ckpt = "checkpoint.npz"
    if args.restart_iteration is not None and \
            not (runner.dir / ckpt).exists():
        # reference restart semantics (main.cc:121-131): no checkpoint, so
        # resume from the dumped deltaLAG_<k> + win/nobs/sigma files alone
        print(f"no {ckpt} — resuming from "
              f"deltaLAG_{args.restart_iteration} + performance-log replay")
        runner.restore_from_dumps(args.restart_iteration)
    elif resume:
        runner.restore()
    return runner


def _profiler(out_dir: str, device: str):
    import torch.profiler as tp

    activities = [tp.ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(tp.ProfilerActivity.CUDA)
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_initialized() else 0
    trace = str(Path(out_dir) / ("trace.json" if rank == 0
                                 else f"trace_rank{rank}.json"))
    return tp.profile(activities=activities,
                      on_trace_ready=lambda prof: prof.export_chrome_trace(trace))


def run_session(runner, args: argparse.Namespace) -> int:
    """Sample; always checkpoint and print the diagnostics JSON
    (cli.py:112-127); with --sharded rank 0 prints it."""
    prof = (_profiler(args.profile, args.device) if args.profile
            else contextlib.nullcontext())
    try:
        with prof:
            runner.run(n_samples=args.samples, rhat_stop=args.rhat_stop,
                       dashboard=args.dashboard, nan_check=args.nan_check)
    finally:
        runner.checkpoint()
        diag = runner.diagnostics()
        if getattr(runner, "is_main", True):
            print(json.dumps(diag, default=float))
        runner.close()
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    return run_session(open_session(args), args)


if __name__ == "__main__":
    sys.exit(main())
