"""The full forward model: Lagrangian density -> Eulerian density.

Port of barcode_tpu/forward/lag2eul.py:23-127: delta_lag -> LPT
displacement Psi (optionally through the TRANSF kernels) -> particles
q + Psi (periodic wrap) [-> plane-parallel or radial RSD with Zel'dovich
velocities] -> mass-assignment deposit (NGP, CIC, TSC, SPH, sph_ft, or the
kernel TSC deposit) -> overdensity.  Differentiable end to end with torch
autograd; the kernel deposit carries its own backward (kernel K2).

Inputs may carry a leading chain dimension.  The JAX package's bf16 kernel
options are refused by the configuration (config.py).
"""
from __future__ import annotations

import dataclasses

from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.grid import fourier
from barcode_tpu_torch.forward import lpt, particles, assign


@dataclasses.dataclass(frozen=True)
class ForwardConfig:
    """Static configuration of the forward model.  The `pallas_*` names are
    those of the JAX package and of input.par; here they select the CUDA
    kernel deposit (K1 forward, K2 backward) and its windows."""

    sfmodel: int = 1          # 1 Zel'dovich, 2 2LPT, 3 ALPT
    masskernel: object = 3    # 0 ngp / 1 cic / 2 tsc / 3 sph / 'sph_ft'
    rsd: bool = False         # redshift-space mapping
    rsd_planepar: bool = True  # plane-parallel (z-axis) vs radial about
    observer: tuple = (0.0, 0.0, 0.0)  # xobs/yobs/zobs (rsd.cc:18-69)
    origin: tuple = (0.0, 0.0, 0.0)  # box corner xllc/yllc/zllc: positions
                              # are box-relative, so the origin enters only
                              # the radial observer, obs_eff = observer -
                              # origin (the JAX package's deliberate reading
                              # of the reference, lag2eul.py:32-43)
    periodic: bool = True
    slength: float = 4.0      # ALPT long/short split scale [Mpc/h]
    kernel_h_rel: float = 1.0  # SPH kernel scale in mean-cell units
    deriv_scheme: str = "fft"  # 2LPT source derivatives: 'fft' or 'findif'
                               # (4th-order finite differences)
    pallas_deposit: bool = False  # kernel TSC deposit (tsc/sph_ft)
    pallas_halo: int = 8      # halo contract: max |displacement| in cells + 1
    pallas_block: tuple = (8, 8)   # gather-kernel (K2) block (BX, BY)
    pallas_block_dep: tuple | None = None  # deposit-kernel (K1) block;
                               # None -> assign.auto_block_dep
    pallas_tail_k: int = 0     # halo-tail split capacity per chain (0 = off)


@dataclasses.dataclass(frozen=True)
class GrowthParams:
    """Scalar cosmology inputs of the forward model (config-time floats)."""

    D1: float
    D2: float
    ascale: float
    cpecvel: float  # displacement -> velocity factor (cosmo.c_pecvel)
    hubble: float   # 100 E(a), h km/s/Mpc


def kernel_h(fc: ForwardConfig, g: GridSpec) -> float:
    """SPH kernel scale h = h_rel * mean cell size (init_par.cc:373-381)."""
    return fc.kernel_h_rel * g.cell_avg


def displaced_positions(delta_lag, g: GridSpec, fc: ForwardConfig,
                        gp: GrowthParams, delta_C=None, transfer=None):
    """Particle positions of the forward model (after RSD when fc.rsd);
    radial RSD leaves them unwrapped."""
    psi = lpt.lpt_psi(delta_lag, g, fc.sfmodel, gp.D1, gp.D2, fc.slength,
                      deriv_scheme=fc.deriv_scheme, transfer=transfer,
                      delta_C=delta_C)
    pos = particles.displace(psi, g)
    if fc.rsd:
        # v = c_pecvel * Psi (Zel'dovich-only velocities, Lag2Eul.cc:375-381)
        if fc.rsd_planepar:
            vel_z = gp.cpecvel * psi.select(-4, 2)
            pos = particles.rsd_plane_parallel(pos, vel_z, g, gp.ascale,
                                               gp.hubble, fc.periodic)
        else:
            obs_eff = tuple(o - c for o, c in zip(fc.observer, fc.origin))
            pos = particles.rsd_radial(pos, gp.cpecvel * psi, g, obs_eff,
                                       gp.ascale, gp.hubble)
    return pos


def lag2eul(delta_lag, g: GridSpec, fc: ForwardConfig, gp: GrowthParams,
            return_pos: bool = False, transfer=None, delta_C=None):
    """delta_lag -> (delta_eul [, pos]) with unit-mass regular-grid
    particles.  `transfer` = optional (t_zeld, t_2lpt) rfft-layout TRANSF
    kernels of the non-Zel'dovich paths (Lag2Eul.cc:174-191); `delta_C` =
    optional precomputed rfft3(delta_lag), shared with the prior energy by
    model/posterior.make_psi."""
    pos = displaced_positions(delta_lag, g, fc, gp, delta_C, transfer)
    mk = {0: "ngp", 1: "cic", 2: "tsc", 3: "sph"}.get(fc.masskernel,
                                                     fc.masskernel)
    if fc.pallas_deposit and mk in ("tsc", "sph_ft"):
        dep = assign.make_tsc_deposit_fast(
            g, halo=fc.pallas_halo, block=tuple(fc.pallas_block),
            block_dep=(tuple(fc.pallas_block_dep)
                       if fc.pallas_block_dep else None),
            tail_k=fc.pallas_tail_k)
        rho = dep(pos)
        if mk == "sph_ft":
            w4 = assign.w4_fourier(g, kernel_h(fc, g), rho.device)
            rho = fourier.irfft3(w4 * fourier.rfft3(rho), g)
    else:
        rho = assign.deposit(pos, g, fc.masskernel, kernel_h(fc, g))
    delta_eul = assign.overdens(rho)
    if return_pos:
        return delta_eul, pos
    return delta_eul
