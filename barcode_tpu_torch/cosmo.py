"""Background cosmology and growth factors.

Replaces reference barlib/src/cosmo.cc (GSL quadrature) with numpy
host-side quadrature: these are config-time scalars computed once, so they
stay out of the device hot path entirely.  Float64 throughout.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Cosmology:
    """Cosmological parameters + derived growth quantities at scale factor a.

    The reference hard-codes four WMAP parameter sets selected by a global
    (init_par.cc:38,452-514); here they are presets of one dataclass.
    """

    omega_m: float
    omega_q: float
    h: float
    ascale: float = 1.0
    sigma8: float = 0.0
    n_s: float = 0.0
    omega_b: float = 0.0

    @property
    def omega_k(self) -> float:
        return 1.0 - self.omega_m - self.omega_q

    def with_redshift(self, z: float) -> "Cosmology":
        return dataclasses.replace(self, ascale=1.0 / (1.0 + z))


# Hard-coded parameter sets of the reference (init_par.cc:452-514).
PRESETS = {
    "wmap3": dict(omega_m=0.25, omega_q=0.75, h=0.73, sigma8=0.9, n_s=1.0, omega_b=0.0456),
    "wmap7_mean": dict(omega_m=0.272, omega_q=0.728, h=0.704, sigma8=0.809, n_s=0.963, omega_b=0.0456),
    "wmap7_max": dict(omega_m=0.272, omega_q=0.728, h=0.702, sigma8=0.807, n_s=0.961, omega_b=0.046),
    "wmap9": dict(omega_m=0.28645, omega_q=0.71355, h=0.6932, sigma8=0.82, n_s=0.972, omega_b=0.04628),
}


def preset(name: str, z: float = 0.0) -> Cosmology:
    return Cosmology(**PRESETS[name]).with_redshift(z)


def e_hubble_a(c: Cosmology, a) -> float:
    """H(a)/H0.  Parity: E_Hubble_a, cosmo.cc:25-31."""
    return np.sqrt(c.omega_m / a**3 + c.omega_k / a**2 + c.omega_q)


def d_growth(c: Cosmology, a: float | None = None) -> float:
    """Linear growth factor with the reference's normalization:
    D = (H/H0) * I(z) / I(0), I(z) = int_z^inf (1+z')/E(z')^3 dz'
    (cosmo.cc:124-180), so D(z=0) = 1.
    """
    if a is None:
        a = c.ascale
    z = 1.0 / a - 1.0

    def integral(z_lo: float) -> float:
        # substitute z' = z_lo + t/(1-t), t in [0,1)
        t = np.linspace(0.0, 1.0, 20001)[:-1]
        zp = z_lo + t / (1.0 - t)
        jac = 1.0 / (1.0 - t) ** 2
        E = np.sqrt(c.omega_m * (1 + zp) ** 3 + c.omega_k * (1 + zp) ** 2 + c.omega_q)
        f = (1.0 + zp) / E**3 * jac
        return np.trapezoid(f, t)

    E_a = e_hubble_a(c, a)
    return float(E_a * integral(z) / integral(0.0))


def d2_growth(c: Cosmology, a: float | None = None) -> float:
    """Second-order growth D2 = -3/7 * D1^2 * Omega(a)^(-1/143).

    Parity: init_par.cc:516-529.
    """
    if a is None:
        a = c.ascale
    E = e_hubble_a(c, a)
    Omega = c.omega_m / (E * E * a**3)
    D1 = d_growth(c, a)
    return float(-3.0 / 7.0 * D1 * D1 * Omega ** (-1.0 / 143.0))


def fgrow(c: Cosmology, a: float | None = None, term: int = 1) -> float:
    """Growth rates f1 = Omega^(5/9), f2 = 2 Omega^(6/11), f3 = 3 Omega^(13/24).

    Parity: fgrow, cosmo.cc:182-218 (Lahav+91 approximations).
    """
    if a is None:
        a = c.ascale
    E = e_hubble_a(c, a)
    Omega = c.omega_m / ((E * E) * a**3)
    if term == 1:
        return float(Omega ** (5.0 / 9.0))
    if term == 2:
        return float(2.0 * Omega ** (6.0 / 11.0))
    if term == 3:
        return float(3.0 * Omega ** (13.0 / 24.0))
    raise ValueError("term must be 1, 2 or 3")


def c_pecvel(c: Cosmology, a: float | None = None, term: int = 1) -> float:
    """Displacement -> peculiar velocity factor f * 100 * E(a) * a  [km/s per
    Mpc/h of displacement].  Parity: c_pecvel, cosmo.cc:220-236."""
    if a is None:
        a = c.ascale
    return float(fgrow(c, a, term) * 100.0 * e_hubble_a(c, a) * a)


def hubble_a(c: Cosmology, a: float | None = None) -> float:
    """H(a) in h km/s/Mpc units (H0 = 100)."""
    if a is None:
        a = c.ascale
    return float(100.0 * e_hubble_a(c, a))


def eh_transfer_nowiggle(c: Cosmology, k: np.ndarray) -> np.ndarray:
    """Eisenstein & Hu (1998) zero-baryon ("no-wiggle") transfer function.

    k in h/Mpc.  This is the internal power-spectrum path the reference
    stubs out ("computing power-spectrum from fitting formulae!",
    reference barcode/main.cc:176-177 — commented out, so barcode can
    only ever read a CAMB table); implemented here so readPS=false works.
    """
    k = np.asarray(k, np.float64)
    om_h2 = c.omega_m * c.h**2
    ob_h2 = c.omega_b * c.h**2
    theta = 2.728 / 2.7                      # T_CMB / 2.7 K
    fb = c.omega_b / c.omega_m
    # sound horizon (EH98 eq. 26) and shape-parameter suppression (eq. 31)
    s = 44.5 * np.log(9.83 / om_h2) / np.sqrt(1.0 + 10.0 * ob_h2**0.75)  # Mpc
    alpha = (1.0 - 0.328 * np.log(431.0 * om_h2) * fb
             + 0.38 * np.log(22.3 * om_h2) * fb**2)
    ks = k * c.h * s                          # k s in Mpc^-1 * Mpc
    gamma_eff = c.omega_m * c.h * (alpha + (1.0 - alpha) / (1.0 + (0.43 * ks)**4))
    q = k * theta**2 / gamma_eff              # eq. 28 with Gamma_eff
    L0 = np.log(2.0 * np.e + 1.8 * q)
    C0 = 14.2 + 731.0 / (1.0 + 62.5 * q)
    return L0 / (L0 + C0 * q * q)


def sigma_r(c: Cosmology, k: np.ndarray, P: np.ndarray, R: float = 8.0) -> float:
    """RMS top-hat fluctuation: sigma^2(R) = 1/(2 pi^2) int k^2 P W^2(kR) dk
    (log-grid trapezoid; W = 3 (sin x - x cos x)/x^3)."""
    x = k * R
    x = np.where(x > 1e-6, x, 1e-6)
    W = 3.0 * (np.sin(x) - x * np.cos(x)) / x**3
    integrand = k**3 * P * W * W / (2.0 * np.pi**2)   # d ln k measure
    return float(np.sqrt(np.trapezoid(integrand, np.log(k))))


def linear_power(c: Cosmology, k: np.ndarray) -> np.ndarray:
    """Linear matter power spectrum P(k) = A k^ns T^2(k) at z=0, normalized
    so that sigma(8 Mpc/h) = c.sigma8.  Units (Mpc/h)^3, k in h/Mpc.

    Growth to the run redshift is NOT applied here: like the reference's
    readtab grid (calc_power.cc:31-108), P feeds the prior/GRF at z=0 and
    the forward model carries D1.
    """
    k = np.asarray(k, np.float64)
    kn = np.logspace(-4, 2.5, 1024)
    Pn = kn**c.n_s * eh_transfer_nowiggle(c, kn) ** 2
    A = (c.sigma8 / sigma_r(c, kn, Pn)) ** 2
    return A * k**c.n_s * eh_transfer_nowiggle(c, k) ** 2


C_LIGHT_KMS = 299792.458


def calc_dcom(c: Cosmology, a: float | None = None) -> float:
    """Comoving distance to scale factor a in Mpc/h.

    Parity: calc_dcom, cosmo.cc:85-122 (GSL qng of 1/E(z') from 0 to z,
    times c/H0) — numpy quadrature, h-units (H0 = 100 h km/s/Mpc).
    """
    if a is None:
        a = c.ascale
    z = 1.0 / a - 1.0
    if z <= 0:
        return 0.0
    zp = np.linspace(0.0, z, 20001)
    E = np.sqrt(c.omega_m * (1 + zp) ** 3 + c.omega_k * (1 + zp) ** 2 + c.omega_q)
    return float(np.trapezoid(1.0 / E, zp) * C_LIGHT_KMS / 100.0)
