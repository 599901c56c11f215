"""Sampler observability: metrics the reference shows in its ncurses
dashboard + performance log (SURVEY.md §5.1/§5.5), plus effective-sample-size
and timing metrics it lacks.

The interactive surface is a plain text status line (terminals, logs and
multi-host jobs all cope; an ncurses UI would not survive any of them).
Numpy-only: the sampler hands its per-attempt records over as numpy arrays,
and tensors are copied to the host before they are inspected here.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np


def effective_sample_size(x: np.ndarray, max_lag: int | None = None) -> float:
    """ESS of a 1D chain via the initial-positive-sequence autocorrelation
    estimator (Geyer 1992)."""
    x = np.asarray(x, np.float64)
    n = x.size
    if n < 4:
        return float(n)
    x = x - x.mean()
    denom = np.sum(x * x)
    if denom == 0:
        return float(n)
    max_lag = max_lag or n // 2
    f = np.fft.rfft(x, 2 * n)
    acf = np.fft.irfft(f * np.conj(f))[:max_lag] / denom
    # sum consecutive pairs until they go negative
    tau = 1.0
    for t in range(1, max_lag - 1, 2):
        pair = acf[t] + acf[t + 1]
        if pair < 0:
            break
        tau += 2 * pair
    return float(n / tau)


def split_rhat(traces: np.ndarray) -> float:
    """Split Gelman-Rubin R-hat over per-chain scalar traces [n_chains,
    n_draws] (Gelman+13 / Vehtari+21 split form).  The cross-chain
    convergence diagnostic the single-chain reference cannot produce
    (SURVEY.md §5.8 lists it as a TPU-native addition); R-hat -> 1 at
    convergence, values > ~1.01-1.1 mean the chains have not mixed.

    Host-side, edge-case-robust (short/constant traces) variant of the
    field-level `statistics.gelman_rubin` of the JAX package; used by the runner's
    stopping rule where NaN/inf semantics must be predictable."""
    x = np.asarray(traces, np.float64)
    if x.ndim != 2:
        raise ValueError("traces must be [n_chains, n_draws]")
    m, n = x.shape
    half = n // 2
    if half < 2:
        return float("inf")
    x = np.concatenate([x[:, :half], x[:, half:2 * half]], axis=0)
    n = half
    chain_means = x.mean(axis=1)
    B = n * np.var(chain_means, ddof=1)          # between-chain
    W = float(np.mean(np.var(x, axis=1, ddof=1)))  # within-chain
    if W == 0.0:
        return 1.0 if B == 0.0 else float("inf")
    var_plus = (n - 1.0) / n * W + B / n
    return float(np.sqrt(var_plus / W))


@dataclasses.dataclass
class SamplerMetrics:
    """Rolling throughput/quality metrics for a sampling run."""

    t_start: float = dataclasses.field(default_factory=time.time)
    attempts: int = 0
    accepted: int = 0
    leapfrog_steps: int = 0
    # recent-window |dH| (warmup blowups would dominate a cumulative mean
    # forever; the useful signal is the current regime)
    dh_window: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=512))

    def update(self, stats) -> None:
        acc = np.asarray(stats.accepted)
        self.attempts += acc.size
        self.accepted += int(acc.sum())
        self.leapfrog_steps += int(np.asarray(stats.Neps).sum())
        dh = np.asarray(stats.dH).ravel()
        self.dh_window.extend(np.abs(dh[np.isfinite(dh)]).tolist())

    @property
    def elapsed(self) -> float:
        return time.time() - self.t_start

    def summary(self) -> dict:
        el = max(self.elapsed, 1e-9)
        return {
            "attempts": self.attempts,
            "accepted": self.accepted,
            "acc_rate": self.accepted / max(self.attempts, 1),
            "leapfrog_steps_per_s": self.leapfrog_steps / el,
            "samples_per_s": self.accepted / el,
            "median_abs_dH": (float(np.median(self.dh_window))
                              if self.dh_window else float("nan")),
            "elapsed_s": el,
        }

    def status_line(self, extra: str = "") -> str:
        s = self.summary()
        return (f"att={s['attempts']} acc={s['accepted']} "
                f"rate={s['acc_rate']:.2f} steps/s={s['leapfrog_steps_per_s']:.1f} "
                f"|dH|={s['median_abs_dH']:.3g} t={s['elapsed_s']:.0f}s {extra}")


def _host(x) -> np.ndarray:
    """numpy copy of a tensor (any device) or array-like."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return np.asarray(x)


def check_finite(states, where: str = "") -> None:
    """NaN guard — the TPU-native counterpart of the reference's FPE trap
    (feenableexcept, main.cc:46-78) and contains_nan scan (HMC.cc:405-407).
    Raises on non-finite chain state."""
    bad = []
    get = states.get if isinstance(states, dict) else \
        lambda n: getattr(states, n)  # ChainState or a state dict
    for name in ("delta", "psi", "grad", "eps_fac"):
        v = _host(get(name))
        if not np.isfinite(v).all():
            bad.append(name)
    if bad:
        raise FloatingPointError(
            f"non-finite sampler state in {bad} {where} — aborting like the "
            "reference's NAN_DETECTION build would")
