"""Particle displacement and redshift-space mapping.

Port of barcode_tpu/forward/particles.py:16-60.  Particles are one per cell
at cell centers; positions have shape (..., 3) + grid shape, the leading
dimensions being chains.
"""
from __future__ import annotations

import torch

from barcode_tpu_torch.grid.spec import GridSpec


def lagrangian_positions(g: GridSpec, dtype=torch.float32, device=None):
    """Cell-center positions q = (i + 1/2) d, shape (3,) + grid shape."""
    d1, d2, d3 = g.cell
    x = (torch.arange(g.N1, dtype=dtype, device=device) + 0.5) * d1
    y = (torch.arange(g.N2, dtype=dtype, device=device) + 0.5) * d2
    z = (torch.arange(g.N3, dtype=dtype, device=device) + 0.5) * d3
    return torch.stack(torch.meshgrid(x, y, z, indexing="ij"))


def wrap(pos, g: GridSpec):
    """Periodic wrap to [0, L) per axis (pacman_coordinate)."""
    L = torch.tensor([g.L1, g.L2, g.L3], dtype=pos.dtype,
                     device=pos.device).reshape(3, 1, 1, 1)
    return torch.remainder(pos, L)


def displace(psi, g: GridSpec):
    """pos = wrap(q + Psi) (disp_part, reggrid path)."""
    return wrap(lagrangian_positions(g, psi.dtype, psi.device) + psi, g)


def rsd_plane_parallel(pos, vel_z, g: GridSpec, ascale: float, hubble: float,
                       periodic: bool = True):
    """Plane-parallel RSD: s_z = z + v_z / (a H), wrapped (rsd.cc:49-66)."""
    x, y, z = pos.unbind(-4)
    znew = z + vel_z / (hubble * ascale)
    if periodic:
        znew = torch.remainder(znew, g.L3)
    return torch.stack([x, y, znew], dim=-4)


def rsd_radial(pos, vel, g: GridSpec, obs_xyz, ascale: float, hubble: float):
    """Radial RSD about the observer at obs_xyz: r_new = r + (v.r_hat)/(a H)
    (rsd.cc:37-48).  No periodic wrap, as in the reference: positions may
    leave the box."""
    obs = torch.tensor(obs_xyz, dtype=pos.dtype,
                       device=pos.device).reshape(3, 1, 1, 1)
    rel = pos - obs
    r = torch.sqrt(torch.sum(rel * rel, dim=-4))
    r_safe = torch.where(r > 0, r, 1.0)
    ruxv = torch.sum(rel * vel, dim=-4) / r_safe / (hubble * ascale)
    return rel / r_safe.unsqueeze(-4) * (r + ruxv).unsqueeze(-4) + obs
