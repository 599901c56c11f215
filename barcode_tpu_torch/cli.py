"""Command-line entry point.

Usage (mirrors barcode/main.cc:65-220: run next to an input.par, optional
restart):

    python -m barcode_tpu_torch [input.par] [restart_iteration] [--resume]
        [--chains N] [--samples N] [--device {cuda,cpu}] ...

Port of barcode_tpu/cli.py: the same options and defaults, plus --device
(the card unless the CPU is asked for).  The sharded and multi-host options
parse as there but raise NotImplementedError: that path is ROADMAP A.4.
--profile DIR writes a torch.profiler trace (CPU + CUDA activities) of the
sampling run as a Chrome trace, DIR/trace.json.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

from barcode_tpu_torch.config import RunConfig
from barcode_tpu_torch.runner import Runner

_NOT_PORTED = ("sharded", "halo", "coordinator", "num_processes",
               "process_id", "multihost")


def parse_args(argv=None) -> argparse.Namespace:
    """Parse the command line; the options of the multi-device path raise
    before any work is done."""
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
                        "into DIR/trace.json (Chrome trace format)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device to run on (default: the CUDA card; raises "
                        "without one)")
    not_ported = " (not ported: ROADMAP A.4)"
    p.add_argument("--sharded", action="store_true",
                   help="slab-shard every field over several devices"
                        + not_ported)
    p.add_argument("--halo", type=int, default=None,
                   help="deposit halo cells for --sharded" + not_ported)
    p.add_argument("--coordinator", default=None,
                   help="multi-host coordinator address (host:port)"
                        + not_ported)
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-host process count" + not_ported)
    p.add_argument("--process-id", type=int, default=None,
                   help="multi-host process id" + not_ported)
    p.add_argument("--multihost", action="store_true",
                   help="multi-host initialization" + not_ported)
    args = p.parse_args(argv)
    given = [name for name in _NOT_PORTED
             if getattr(args, name) is not None
             and getattr(args, name) is not False]
    if given:
        flags = ", ".join("--" + name.replace("_", "-") for name in given)
        raise NotImplementedError(
            f"{flags}: the sharded / multi-host path is not ported to "
            "barcode_tpu_torch yet (ROADMAP A.4)")
    return args


def open_session(args: argparse.Namespace) -> Runner:
    """Config, Runner setup, then --resume / restart (cli.py:67-111)."""
    if Path(args.input_par).exists():
        conf = RunConfig.from_input_par(args.input_par)
    else:
        print(f"note: {args.input_par} not found, using built-in defaults")
        conf = RunConfig()
    runner = Runner(conf, out_dir=args.out, device=args.device)
    runner.setup(n_chains=args.chains)
    if args.restart_iteration is not None and \
            not (runner.dir / "checkpoint.npz").exists():
        # reference restart semantics (main.cc:121-131): no checkpoint, so
        # resume from the dumped deltaLAG_<k> + win/nobs/sigma files alone
        print(f"no checkpoint.npz — resuming from "
              f"deltaLAG_{args.restart_iteration} + performance-log replay")
        runner.restore_from_dumps(args.restart_iteration)
    elif args.resume or args.restart_iteration is not None:
        runner.restore()
    return runner


def _profiler(out_dir: str, device: str):
    import torch.profiler as tp

    activities = [tp.ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(tp.ProfilerActivity.CUDA)
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    trace = str(Path(out_dir) / "trace.json")
    return tp.profile(activities=activities,
                      on_trace_ready=lambda prof: prof.export_chrome_trace(trace))


def run_session(runner: Runner, args: argparse.Namespace) -> int:
    """Sample; always checkpoint and print the diagnostics JSON
    (cli.py:112-127)."""
    prof = (_profiler(args.profile, args.device) if args.profile
            else contextlib.nullcontext())
    try:
        with prof:
            runner.run(n_samples=args.samples, rhat_stop=args.rhat_stop,
                       dashboard=args.dashboard, nan_check=args.nan_check)
    finally:
        runner.checkpoint()
        print(json.dumps(runner.diagnostics(), default=float))
        runner.close()
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    return run_session(open_session(args), args)


if __name__ == "__main__":
    sys.exit(main())
