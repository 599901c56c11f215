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


def chain_state(fields: Mapping, device=None) -> ChainState:
    """ChainState of C chains from the JAX ChainState's fields stacked over
    chains (leading axis C).  The JAX PRNG key is dropped: the port draws
    from a torch.Generator."""
    out = {}
    for f in dataclasses.fields(ChainState):
        arr = np.array(fields[f.name])
        if arr.ndim == 0:
            arr = arr[None]
        out[f.name] = tensor(arr, device)
    return ChainState(**out)


def forward_config(fields: Mapping) -> ForwardConfig:
    """ForwardConfig from the JAX ForwardConfig's fields, halo as resolved
    there.  TPU-only options must be at their defaults."""
    names = {f.name for f in dataclasses.fields(ForwardConfig)}
    tpu_only = {k: v for k, v in fields.items() if k not in names}
    if any(v for v in tpu_only.values()):
        raise ValueError(f"TPU-only forward options set: {tpu_only}")
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in fields.items() if k in names}
    return ForwardConfig(**kw)
