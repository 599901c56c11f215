"""Run protocol files: convergence and spectrum-residual tracking.

Parity: reference barlib/src/protocol.cc:20-113 (`convergence.prt`,
`spec_protocol.prt`, `restart.prt`).  The reference appends per-iteration
diagnostics to text protocols; here the same files are written with the
same intent (restart bookkeeping belongs to the exact checkpoint, but
the restart.prt marker is still emitted for tooling compatibility).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


class Protocols:
    def __init__(self, out_dir):
        self.dir = Path(out_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._conv = None
        self._spec = None

    def _open(self, name, header):
        path = self.dir / name
        new = not path.exists()
        f = open(path, "a")
        if new:
            f.write(header + "\n")
        return f

    def log_convergence(self, iteration: int, residual: float, acc_rate: float,
                        rhat: float = float("nan")):
        """convergence.prt: iteration, data residual, recent acceptance,
        cross-chain R-hat (an extension — the single-chain reference has no
        R-hat to write)."""
        if self._conv is None:
            self._conv = self._open("convergence.prt",
                                    "# it\tresidual\tacc_rate\trhat")
        self._conv.write(f"{iteration}\t{residual:.6g}\t{acc_rate:.4f}\t{rhat:.4f}\n")
        self._conv.flush()

    def log_spectrum(self, iteration: int, kmode, power, power_truth=None):
        """spec_protocol.prt: per-iteration binned spectrum row (+ ratio to
        the truth spectrum when known, i.e. random_test runs)."""
        if self._spec is None:
            self._spec = self._open("spec_protocol.prt",
                                    "# it\tmean_P\tratio_low_k\tratio_mid_k")
        p = np.asarray(power)
        row = [iteration, float(p[p > 0].mean()) if (p > 0).any() else 0.0]
        if power_truth is not None:
            t = np.asarray(power_truth)
            with np.errstate(divide="ignore", invalid="ignore"):
                ratio = np.where(t > 0, p / np.where(t > 0, t, 1.0), np.nan)
            row += [float(np.nanmean(ratio[2:10])), float(np.nanmean(ratio[10:30]))]
        else:
            row += [float("nan"), float("nan")]
        self._spec.write("\t".join(f"{v:.6g}" if isinstance(v, float) else str(v)
                                   for v in row) + "\n")
        self._spec.flush()

    def close(self):
        for f in (self._conv, self._spec):
            if f is not None:
                f.close()
        self._conv = self._spec = None

    def write_restart_marker(self, iteration: int):
        """restart.prt (protocol.cc:41-50): last safely-resumable iteration."""
        (self.dir / "restart.prt").write_text(f"{iteration}\n")
