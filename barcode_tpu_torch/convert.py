"""Carry the JAX package's state across to the port's objects.

The JAX package's arrays arrive as numpy arrays (or anything `np.asarray`
takes) and its dataclasses as field mappings (`dataclasses.asdict` or
`{f.name: getattr(x, f.name)}`), so this module imports neither `jax` nor
`barcode_tpu`.  The tests use it to compute the same thing in both
packages.  Like every entry point of the port, the converters put their
tensors on the card unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from barcode_tpu_torch.device import resolve
from barcode_tpu_torch.forward.lag2eul import ForwardConfig
from barcode_tpu_torch.hmc.state import ChainState, MassState
from barcode_tpu_torch.model.likelihoods import ObsData


def tensor(a, device=None):
    """numpy-convertible -> torch tensor of the same dtype on `device`
    (default the card; raises without one)."""
    return torch.as_tensor(np.array(a), device=resolve(device))


def _maybe_tensor(v, device):
    arr = np.asarray(v)
    return float(arr) if arr.ndim == 0 else tensor(arr, device)


def obs_data(fields: Mapping, device=None) -> ObsData:
    """ObsData from the JAX ObsData's fields."""
    names = {f.name for f in dataclasses.fields(ObsData)}
    return ObsData(**{k: (tensor(v, device)
                          if k in ("nobs", "window", "noise", "power")
                          else float(np.asarray(v)))
                      for k, v in fields.items() if k in names})


def mass_state(fields: Mapping, device=None) -> MassState:
    """MassState from the JAX MassState's fields (0.0 scalars stay floats)."""
    return MassState(mass_f=_maybe_tensor(fields["mass_f"], device),
                     mass_r=_maybe_tensor(fields["mass_r"], device))


def chain_state(fields: Mapping, seeds, device=None) -> ChainState:
    """ChainState of C chains from the JAX ChainState's fields stacked over
    chains (leading axis C), chain c drawing from `seeds[c]`.  The JAX PRNG
    key is dropped: a threefry key cannot become a torch generator, so the
    chains carried across draw other values than the JAX chains would
    (`hmc.randoms`)."""
    out = {"seed": tensor(np.asarray(seeds, np.int64), device)}
    for f in dataclasses.fields(ChainState):
        if f.name == "seed":
            continue
        arr = np.array(fields[f.name])
        if arr.ndim == 0:
            arr = arr[None]
        out[f.name] = tensor(arr, device)
    return ChainState(**out)


def forward_config(fields: Mapping) -> ForwardConfig:
    """ForwardConfig from the JAX ForwardConfig's fields, halo as resolved
    there (the two classes have the same fields; an unknown name raises
    TypeError)."""
    return ForwardConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                            for k, v in fields.items()})


# ---------------------------------------------------------------------------
# The sharded layout (parallel/): one rank's slabs of full fields
# ---------------------------------------------------------------------------

def slab(a, n_grid: int, col: int, device=None):
    """Rank `col`'s x-slab (..., N1/n_grid, N2, N3) of a full field."""
    arr = np.asarray(a)
    n1 = arr.shape[-3] // n_grid
    return tensor(arr[..., col * n1:(col + 1) * n1, :, :], device)


def power_slab(power, n_grid: int, col: int, device=None):
    """Rank `col`'s ky-slab (N1, N2/n_grid, N3h) of a full half-complex
    grid (the JAX package's power_to_sharded_layout)."""
    arr = np.asarray(power)
    n2 = arr.shape[-2] // n_grid
    return tensor(arr[..., col * n2:(col + 1) * n2, :], device)


def sharded_obs(fields: Mapping, n_grid: int, col: int,
                device=None) -> ObsData:
    """Rank `col`'s ObsData (x-slabs, power in the sharded Fourier layout)
    from the full fields of a JAX ObsData."""
    names = {f.name for f in dataclasses.fields(ObsData)}
    kw = {}
    for k, v in fields.items():
        if k not in names:
            continue
        if k == "power":
            kw[k] = power_slab(v, n_grid, col, device)
        elif k in ("nobs", "window", "noise"):
            kw[k] = slab(v, n_grid, col, device)
        else:
            kw[k] = float(np.asarray(v))
    return ObsData(**kw)


def sharded_chain_state(fields: Mapping, n_grid: int, col: int,
                        chains: range, seeds, device=None) -> dict:
    """This rank's state dict (parallel/sharded_sampler.py) from a JAX
    sharded chain state gathered to full arrays: the chains `chains`, the
    x-slab `col` of delta and grad.  The JAX keys are dropped (a threefry
    key cannot become a torch generator); `seeds` gives this rank's chains
    their seeds (one per chain)."""
    out = {}
    for k, v in fields.items():
        if k == "key_data":
            continue
        arr = np.asarray(v)[chains.start:chains.stop]
        out[k] = slab(arr, n_grid, col, device) if k in ("delta", "grad") \
            else tensor(arr, device)
    out["seed"] = tensor(np.asarray(seeds, np.int64), device)
    return out
