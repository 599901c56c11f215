"""Adaptive step-size (eps_fac) controllers.

Port of barcode_tpu/hmc/adapt.py:25-124, batched: every argument carries a
leading chain dimension (C,) and the acceptance/epsilon tables are
(C, N_a), so each chain runs its own controller.  With pooling the tables
of all chains are concatenated and each chain adapts from the pool.

Types (input.par eps_fac_update_type):
  0 constant
  1 power-mean decay toward eps_fac_target every s_eps_total attempts
  2 acceptance-rate window controller (sort-by-eps cumulative average +
    smoothing)
  3 type 2 + halve-on-every-rejection until the first acceptance
"""
from __future__ import annotations

import torch

from barcode_tpu_torch.config import HMCConfig


def power_mean(x, y, p):
    """((x^p + y^p)/2)^(1/p), geometric mean at p=0 (math_funcs.cc:40-48)."""
    if p == 0:
        return torch.sqrt(x * y)
    return ((x**p + y**p) / 2.0) ** (1.0 / p)


def _box_smooth(a, w: int):
    """Mean over the clamped window [i-w, i+w] along the last axis
    (stl_smooth, time_step.hpp:64-76)."""
    n = a.shape[-1]
    zero = torch.zeros(a.shape[:-1] + (1,), dtype=a.dtype, device=a.device)
    c = torch.cat([zero, torch.cumsum(a, -1)], -1)
    i = torch.arange(n, device=a.device)
    lo = torch.clamp(i - w, min=0)
    hi = torch.clamp(i + w + 1, max=n)
    return (c[..., hi] - c[..., lo]) / (hi - lo)


def _downward(eps_fac, acc_flags, eps_table, hc: HMCConfig):
    """The reference's downward search (time_step.cpp:40-104): sort the
    acceptance flags by their epsilon (stable, as jnp.argsort), cumulative
    moving average, smooth, find the first crossing below the target after
    the peak, and take the epsilon at that rank."""
    n_a = acc_flags.shape[-1]
    acc_target = (hc.acc_max + hc.acc_min) / 2.0
    a = acc_flags.to(torch.float32)
    alpha = a.mean(-1)

    order = torch.argsort(eps_table, dim=-1, stable=True)
    a_sort = torch.gather(a, -1, order)
    cma = torch.cumsum(a_sort, -1) / torch.arange(
        1, n_a + 1, dtype=torch.float32, device=a.device)
    a_sm = _box_smooth(cma, hc.eps_down_smooth)

    ix_max = torch.argmax(a_sm, -1, keepdim=True)
    below = (torch.arange(n_a, device=a.device) >= ix_max) & (a_sm < acc_target)
    found = below.any(-1)
    ix_target = torch.argmax(below.to(torch.int32), -1, keepdim=True)
    eps_sorted = torch.gather(eps_table, -1, order)

    peak_ok = a_sm.max(-1).values > acc_target
    candidate = torch.where(
        found, torch.gather(eps_sorted, -1, ix_target).squeeze(-1), eps_fac)
    fallback = torch.where(alpha == 0.0, eps_table.min(-1).values,
                           eps_fac / 3.0)
    return torch.where(peak_ok, candidate, fallback)


def _acc_rate_update(eps_fac, count_attempts, acc_flags, eps_table,
                     hc: HMCConfig, pool: bool = False):
    """Type-2 controller body: fires when count_attempts % N_a == 0
    (time_step.cpp:104-135).  `pool` adapts every chain from the tables of
    all chains (the JAX package's pool_axis over the chain axis)."""
    fire = (count_attempts % hc.N_a_eps_update == 0) & (count_attempts > 0)
    if pool:
        C = acc_flags.shape[0]
        acc_flags = acc_flags.reshape(1, -1).expand(C, -1)
        eps_table = eps_table.reshape(1, -1).expand(C, -1)
    alpha = acc_flags.to(torch.float32).mean(-1)
    acc_target = (hc.acc_max + hc.acc_min) / 2.0

    down = _downward(eps_fac, acc_flags, eps_table, hc)
    up = eps_fac * hc.eps_up_fac * (alpha / acc_target)
    adjusted = torch.where(alpha < hc.acc_min, down,
                           torch.where(alpha > hc.acc_max, up, eps_fac))
    return torch.where(fire, adjusted, eps_fac)


def update_eps_fac(eps_fac, count_attempts, rejections, got_first_accept,
                   acc_flags, eps_table, hc: HMCConfig, N: int,
                   pool: bool = False):
    """Dispatch on the update type (update_eps_fac, time_step.cpp:151-185).
    Called before each trajectory."""
    t = hc.eps_fac_update_type
    if t == 0:
        return eps_fac
    if t == 1:
        fire = (count_attempts % hc.s_eps_total(N) == 0) & (count_attempts > 0)
        target = torch.full_like(eps_fac, hc.eps_fac_target(N))
        return torch.where(fire, power_mean(eps_fac, target, hc.eps_fac_power),
                           eps_fac)
    if t == 2:
        return _acc_rate_update(eps_fac, count_attempts, acc_flags, eps_table,
                                hc, pool)
    if t == 3:
        fast = (~got_first_accept) & (rejections > 0)
        normal = _acc_rate_update(eps_fac, count_attempts, acc_flags,
                                  eps_table, hc, pool)
        return torch.where(fast, eps_fac / 2.0, normal)
    raise ValueError(f"unknown eps_fac_update_type {t}")
