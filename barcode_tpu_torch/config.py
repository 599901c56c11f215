"""Typed runtime configuration + reference `input.par` compatibility.

Port of barcode_tpu/config.py: the same dataclasses, defaults and
`input.par` keys (parameter_inifile, reference barlib/src/ini_reader.cpp:
15-41; INIT_PARAMS, init_par.cc:41-416), built on the port's ForwardConfig
and ModelConfig.  The JAX package's bf16 kernel keys select TPU-only
options: set to true they are refused here.
"""
from __future__ import annotations

import dataclasses
import math
from pathlib import Path

from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch import cosmo as cosmo_mod
from barcode_tpu_torch.forward.lag2eul import ForwardConfig, GrowthParams
from barcode_tpu_torch.model.posterior import ModelConfig


def parse_input_par(path) -> dict:
    """key=value ini parser: strips spaces and '#' comments, booleans as
    true/false (ini_reader.cpp:15-41)."""
    out = {}
    for raw in Path(path).read_text().splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line or "=" not in line:
            continue
        key, val = line.split("=", 1)
        out[key.strip()] = val.strip()
    return out


def _get(d, key, cast, default=None):
    if key not in d:
        if default is None:
            raise KeyError(f"missing input.par key: {key}")
        return default
    v = d[key]
    if cast is bool:
        return v.lower() == "true"
    return cast(v)


@dataclasses.dataclass(frozen=True)
class HMCConfig:
    """Sampler knobs (input.par pseudo-timestep + mass blocks)."""

    N_eps_fac: int = 8                 # max leapfrog steps per trajectory
    eps_fac: float = 0.0               # 0 -> heuristic target (init_par.cc:259-261)
    eps_fac_update_type: int = 3       # 0 const / 1 decay / 2 acc-window / 3 = 2+fast-start
    eps_fac_initial: float = 0.5
    eps_fac_power: float = 2.0
    s_eps_total_fac: float = 158.0
    s_eps_total_scaling: float = 0.5
    s_eps_total_Nx_norm: int = 64
    N_a_eps_update: int = 100
    acc_min: float = 0.6
    acc_max: float = 0.7
    eps_down_smooth: int = 5
    eps_up_fac: float = 1.0
    mass_type: int = 1                 # HMC_mass.cc:315-368
    massnum_burn: int = 0              # 0 -> never recompute (init_par.cc:322-331)
    massnum_post: int = 0
    itmax: int = 2000
    total_steps_lim: int = 0           # 0 -> unlimited
    div_dH_by_N: bool = False
    mass_factor: float = 1.0
    pool_adaptation: bool = False      # pool the eps controller window across chains
    integrator: str = "leapfrog"       # or 'minimal_norm_2' (2-stage Omelyan:
                                       # 2 grads/step, ~2x larger stable eps)

    def eps_fac_target(self, N: int) -> float:
        """Heuristic optimal step scale 2.389 N^-0.575 (init_par.cc:260)."""
        if self.eps_fac > 0:
            return self.eps_fac
        return 2.38902581 * N ** (-0.57495347)

    def eps_fac_start(self, N: int) -> float:
        t = self.eps_fac_update_type
        if t == 0:
            return self.eps_fac_target(N)
        if t == 1:
            return self.eps_fac_initial if self.eps_fac_initial > 0 else self.eps_fac_target(N)
        # types 2/3: explicit eps_fac if given, else 2.0 (init_par.cc:281-289)
        return self.eps_fac if self.eps_fac > 0 else 2.0

    def s_eps_total(self, N: int) -> int:
        """eps-update cadence 158 (N/64^3)^0.5 attempts (init_par.cc:294-295)."""
        base = N / float(self.s_eps_total_Nx_norm**3)
        return max(1, int(math.ceil(self.s_eps_total_fac * base**self.s_eps_total_scaling)))


@dataclasses.dataclass(frozen=True)
class MockConfig:
    """random_test mock-data generation (barcoderunner.cc:42-205)."""

    random_test: bool = True
    random_test_rsd: bool = False
    window_type: int = 1        # 1 ones / 10 half / 23 delta>3 mask
    data_model: int = 0         # 0 linear / 1 lognormal
    negative_obs: bool = False
    sigma_min: float = 1.0
    sigma_fac: float = 0.0


@dataclasses.dataclass(frozen=True)
class RunConfig:
    grid: GridSpec = GridSpec.cube(64, 200.0)
    model: ModelConfig = ModelConfig()
    hmc: HMCConfig = HMCConfig()
    mock: MockConfig = MockConfig()
    cosmology: str = "wmap7_max"       # reference default cmbcosm=3
    z: float = 0.0
    seed: int = 1
    n_chains: int = 1
    N_bin: int = 200
    N_Gibbs: int = 10000
    outnum: int = 10
    outnum_ps: int = 10
    dir: str = "./output/"
    fnamePS: str = ""
    readPS: bool = True                # false -> internal EH98 P(k) (cosmo.linear_power)
    initial_guess: int = 0             # 0 zero / 2 GRF / 3 smoothed GRF / 4 noise
    initial_guess_smoothing_scale: float = 20.0
    initial_guess_smoothing_type: int = 1
    initial_guess_file: str = ""
    delta_min: float = -0.999

    def cosmo(self) -> cosmo_mod.Cosmology:
        return cosmo_mod.preset(self.cosmology, self.z)

    def growth(self) -> GrowthParams:
        c = self.cosmo()
        return GrowthParams(
            D1=cosmo_mod.d_growth(c),
            D2=cosmo_mod.d2_growth(c),
            ascale=c.ascale,
            cpecvel=cosmo_mod.c_pecvel(c),
            hubble=cosmo_mod.hubble_a(c),
        )

    @classmethod
    def from_input_par(cls, path) -> "RunConfig":
        p = parse_input_par(path)
        N = _get(p, "Nx", int)
        L = _get(p, "Lx", float)
        grid = GridSpec.cube(N, L)
        # particle_kernel: SPH kernel *type*; 0 (cubic spline) is the only
        # type the reference implements either (SPH_kernel.cpp:19-28)
        if _get(p, "particle_kernel", int, 0) != 0:
            raise ValueError("particle_kernel != 0 (SPH cubic spline) is not "
                             "implemented — matching the reference")
        # deposit block: both keys, or dep_x alone (square block); a lone
        # dep_y would otherwise silently produce block_dep=(x, 0) and a
        # ZeroDivisionError at trace time (ADVICE r3)
        dep_x = _get(p, "pallas_block_dep_x", int, 0)
        dep_y = _get(p, "pallas_block_dep_y", int, 0)
        if dep_y and not dep_x:
            raise ValueError("pallas_block_dep_y set without "
                             "pallas_block_dep_x; set both (or only _x for "
                             "a square block)")
        for key in ("pallas_bf16_grad", "pallas_bf16_dep"):
            if _get(p, key, bool, False):
                raise NotImplementedError(f"{key}=true: the port's kernels "
                                          "are float32 only")
        # masskernel: the reference's integer codes, or (an extension the
        # JAX package's parser lacks) "sph_ft", the closed-form W4 kernel
        # of the headline configuration
        mk = p.get("masskernel", "3")
        fwd = ForwardConfig(
            sfmodel=_get(p, "sfmodel", int, 1),
            masskernel=mk if mk == "sph_ft" else int(mk),
            rsd=_get(p, "rsd_model", bool, False),
            rsd_planepar=_get(p, "planepar", bool, True),
            observer=(_get(p, "xobs", float, 0.0), _get(p, "yobs", float, 0.0),
                      _get(p, "zobs", float, 0.0)),
            origin=(_get(p, "xllc", float, 0.0), _get(p, "yllc", float, 0.0),
                    _get(p, "zllc", float, 0.0)),
            periodic=_get(p, "periodic", bool, True),
            slength=_get(p, "slength", float, 4.0),
            kernel_h_rel=_get(p, "particle_kernel_h_rel", float, 1.0),
            # extension keys (absent from reference input.par files)
            pallas_deposit=_get(p, "pallas_deposit", bool, False),
            pallas_halo=_get(p, "pallas_halo", int, 8),
            pallas_block=(_get(p, "pallas_block_x", int, 8),
                          _get(p, "pallas_block_y", int, 8)),
            # deposit block: 0 -> auto ((16,16) when the grid divides it)
            pallas_block_dep=(dep_x, dep_y or dep_x) if dep_x else None,
            # halo-tail split: pallas_halo becomes a quantile bound and up
            # to this many contract violators per deposit are handled
            # exactly through the compacted XLA path (assign.py)
            pallas_tail_k=_get(p, "pallas_tail_k", int, 0),
        )
        model = ModelConfig(
            likelihood=_get(p, "likelihood", int, 1),
            prior=_get(p, "prior", int, 0),
            forward=fwd,
            deltaQ_factor=_get(p, "deltaQ_factor", float, 1.0),
            grad_prior_factor=_get(p, "grad_psi_prior_factor", float, 1.0),
            grad_likeli_factor=_get(p, "grad_psi_likeli_factor", float, 1.0),
            correct_delta=_get(p, "correct_delta", bool, False),
            calc_h=_get(p, "calc_h", int, 3),
        )
        hmc = HMCConfig(
            N_eps_fac=int(_get(p, "N_eps_fac", float, 8.0)),
            eps_fac=_get(p, "eps_fac", float, 0.0),
            eps_fac_update_type=_get(p, "eps_fac_update_type", int, 3),
            eps_fac_initial=_get(p, "eps_fac_initial", float, 0.5),
            eps_fac_power=_get(p, "eps_fac_power", float, 2.0),
            s_eps_total_fac=_get(p, "s_eps_total_fac", float, 158.0),
            s_eps_total_scaling=_get(p, "s_eps_total_scaling", float, 0.5),
            s_eps_total_Nx_norm=_get(p, "s_eps_total_Nx_norm", int, 64),
            N_a_eps_update=_get(p, "N_a_eps_update", int, 100),
            acc_min=_get(p, "acc_min", float, 0.6),
            acc_max=_get(p, "acc_max", float, 0.7),
            eps_down_smooth=_get(p, "eps_down_smooth", int, 5),
            eps_up_fac=_get(p, "eps_up_fac", float, 1.0),
            mass_type=_get(p, "mass_type", int, 1),
            massnum_burn=_get(p, "massnum_burn", int, 0),
            massnum_post=_get(p, "massnum_post", int, 0),
            total_steps_lim=_get(p, "total_steps_lim", int, 0),
            div_dH_by_N=_get(p, "div_dH_by_N", bool, False),
            mass_factor=_get(p, "mass_factor", float, 1.0),
            # extension keys (absent from reference input.par files)
            pool_adaptation=_get(p, "pool_adaptation", bool, False),
            integrator=_get(p, "integrator", str, "leapfrog"),
        )
        mock = MockConfig(
            random_test=_get(p, "random_test", bool, True),
            random_test_rsd=_get(p, "random_test_rsd", bool, False),
            window_type=_get(p, "window_type", int, 1),
            data_model=_get(p, "data_model", int, 0),
            negative_obs=_get(p, "negative_obs", bool, False),
            sigma_min=_get(p, "sigma_min", float, 1.0),
            sigma_fac=_get(p, "sigma_fac", float, 0.0),
        )
        return cls(
            grid=grid,
            model=model,
            hmc=hmc,
            mock=mock,
            z=_get(p, "z", float, 0.0),
            seed=_get(p, "seed", int, 1),
            N_bin=_get(p, "N_bin", int, 200),
            N_Gibbs=_get(p, "N_Gibbs", int, 10000),
            outnum=_get(p, "outnum", int, 10),
            outnum_ps=_get(p, "outnum_ps", int, 10),
            dir=_get(p, "dir", str, "./"),
            fnamePS=_get(p, "fnamePS", str, ""),
            readPS=_get(p, "readPS", bool, True),
            initial_guess=_get(p, "initial_guess", int, 0),
            initial_guess_smoothing_scale=_get(p, "initial_guess_smoothing_scale", float, 20.0),
            initial_guess_smoothing_type=_get(p, "initial_guess_smoothing_type", int, 1),
            initial_guess_file=_get(p, "initial_guess_file", str, ""),
            delta_min=_get(p, "delta_min", float, -0.999),
        )
