"""Live terminal dashboard: the stand-in for the reference's ncurses UI.

Port of barcode_tpu/utils/dashboard.py (pure Python, copied; chain state
may sit on the card, so values are copied to the host first).  Parity: the
reference's barlib/src/curses_funcs.cc:13-99 (window layout), table columns
of barcode/main.cc:186-188, rows written from HMC.cc:433-537.

The reference draws six ncurses windows (title / message / status / header /
debug / scrolling per-candidate table).  Here the same content is one ANSI
block redrawn in place: a title line, a status line (attempts, acceptance
rate, eps_fac, throughput), and a scrolling table of recent HMC candidates
(sample, epsilon, Neps, dH, dK, dE, P(accept), accept flag).  On a non-TTY
stream the dashboard is inert — logs and multi-host jobs keep the runner's
plain status lines instead (utils/metrics.py).
"""
from __future__ import annotations

import collections
import sys

import numpy as np

from barcode_tpu_torch.utils.metrics import _host

_COLS = ("att", "acc", "eps", "Neps", "dH", "dK", "dE", "P(a)")
_FMT = "{:>7} {:>4} {:>10} {:>5} {:>11} {:>11} {:>11} {:>6}"


class Dashboard:
    """Redraw-in-place candidate table for interactive runs.

    update() takes the sampler's stacked AttemptStats (leaves shaped
    [n_attempts, n_chains]) and shows chain 0, like the reference's
    single-chain curses table.
    """

    def __init__(self, title: str = "barcode_tpu_torch", n_rows: int = 12,
                 stream=None, force: bool | None = None):
        self.stream = stream if stream is not None else sys.stdout
        isatty = getattr(self.stream, "isatty", lambda: False)()
        self.enabled = isatty if force is None else force
        self.title = title
        self.rows: collections.deque = collections.deque(maxlen=n_rows)
        self.n_rows = n_rows
        self._drawn_lines = 0
        self._attempt = 0

    def update(self, stats, states, metrics_summary: dict,
               extra: str = "") -> None:
        if not self.enabled:
            return
        acc = _host(stats.accepted)[:, 0]
        eps = _host(stats.epsilon)[:, 0]
        neps = _host(stats.Neps)[:, 0]
        dh = _host(stats.dH)[:, 0]
        dk = _host(stats.dK)[:, 0]
        de = _host(stats.dE)[:, 0]
        for i in range(acc.size):
            self._attempt += 1
            pa = float(np.exp(-max(dh[i], 0.0))) if np.isfinite(dh[i]) else 0.0
            self.rows.append(_FMT.format(
                self._attempt, "yes" if acc[i] else "no", f"{eps[i]:.3e}",
                int(neps[i]), f"{dh[i]:.4g}", f"{dk[i]:.4g}", f"{de[i]:.4g}",
                f"{pa:.2f}"))
        s = metrics_summary
        eps_fac = float(_host(states.eps_fac).mean())
        acc_min = int(_host(states.accepted).min())
        status = (f"att={s['attempts']}  acc={s['accepted']}  "
                  f"rate={s['acc_rate']:.2f}  steps/s={s['leapfrog_steps_per_s']:.1f}  "
                  f"eps_fac={eps_fac:.3e}  acc_min={acc_min}  "
                  f"t={s['elapsed_s']:.0f}s {extra}")
        self._draw([f"== {self.title} ==", status, "",
                    _FMT.format(*_COLS)] + list(self.rows))

    def _draw(self, lines: list[str]) -> None:
        out = []
        if self._drawn_lines:
            out.append(f"\x1b[{self._drawn_lines}F\x1b[J")  # up + clear below
        out.extend(line + "\n" for line in lines)
        self.stream.write("".join(out))
        self.stream.flush()
        self._drawn_lines = len(lines)

    def close(self) -> None:
        self._drawn_lines = 0
