"""Chain state, per-attempt records and the mass matrix.

Port of barcode_tpu/hmc/state.py.  The JAX package keeps one pytree per
chain and vmaps it; here every field carries a leading chain dimension
(C,) written out.  The JAX ChainState's PRNG key has no counterpart: the
sampler draws from an explicit `torch.Generator` that the caller owns.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


@dataclasses.dataclass
class ChainState:
    """Everything the chains need to continue sampling; each field has a
    leading chain dimension.  The cached (psi, grad) of the current signal
    saves one posterior+gradient evaluation per attempt."""

    delta: Any          # (C,) + grid: current Lagrangian signal
    psi: Any            # (C,)
    psi_prior: Any
    psi_like: Any
    grad: Any           # (C,) + grid
    eps_fac: Any        # (C,) adaptive step-size scale
    acc_flags: Any      # (C, N_a) int32 circular acceptance table
    eps_table: Any      # (C, N_a) float32 circular epsilon table
    count_attempts: Any  # (C,) int32
    rejections: Any     # (C,) int32
    accepted: Any       # (C,) int32
    got_first_accept: Any  # (C,) bool


@dataclasses.dataclass
class AttemptStats:
    """Per-attempt record, the columns of the reference's
    performance_log.txt (HMC.cc:40-60); (C,) tensors per attempt, or
    (n_attempts, C) numpy arrays once stacked by the sampler."""

    accepted: Any
    epsilon: Any
    Neps: Any
    dH: Any
    dK: Any
    dE: Any
    psi_prior_i: Any
    psi_prior_f: Any
    psi_likeli_i: Any
    psi_likeli_f: Any
    H_kin_i: Any
    H_kin_f: Any
    eps_fac: Any
    acc_rate_recent: Any

    @classmethod
    def stack(cls, records: list["AttemptStats"]) -> "AttemptStats":
        """(n_attempts, C) numpy arrays from per-attempt (C,) tensors."""
        return cls(**{
            f.name: np.stack([getattr(r, f.name).detach().cpu().numpy()
                              for r in records])
            for f in dataclasses.fields(cls)})


@dataclasses.dataclass
class MassState:
    """Mass-matrix data: FS spectrum (rfft grid) and/or real-space
    diagonal; a float 0.0 where unused."""

    mass_f: Any
    mass_r: Any
