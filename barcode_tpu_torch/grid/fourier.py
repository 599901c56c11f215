"""Spectral operators on the periodic grid.

Port of barcode_tpu/grid/fourier.py.  FFTs are `torch.fft.rfftn`/`irfftn`
over the last three axes (cuFFT on the card), so any leading batch
dimension (chains, vector components) rides along.  No Pallas kernel exists
for them to port.  The TPU-only barriered inverse of the JAX package
(fourier.py:89-94) is not carried over; its CPU branch (plain `irfftn`) is
the reference.

Conventions (FOURIER_DEF_2, the reference default):
  * forward FFT is the plain unnormalized DFT sum,
  * backward FFT carries the 1/N factor — torch's default "backward" norm;
  * k-vectors are 2*pi/L * signed integer frequency;
  * odd-order spectral derivatives zero the Nyquist planes.
"""
from __future__ import annotations

import functools
import math

import torch

from barcode_tpu_torch.grid.spec import GridSpec

_AXES = (-3, -2, -1)


def kvec(g: GridSpec, rfft: bool = True, dtype=torch.float32, device=None):
    """Broadcastable (kx, ky, kz): shapes (N1,1,1), (1,N2,1), (1,1,N3h|N3)
    (fourier.py:26-42)."""
    kx = (2 * math.pi) * torch.fft.fftfreq(g.N1, d=g.L1 / g.N1, dtype=dtype,
                                           device=device)
    ky = (2 * math.pi) * torch.fft.fftfreq(g.N2, d=g.L2 / g.N2, dtype=dtype,
                                           device=device)
    zfreq = torch.fft.rfftfreq if rfft else torch.fft.fftfreq
    kz = (2 * math.pi) * zfreq(g.N3, d=g.L3 / g.N3, dtype=dtype, device=device)
    return kx[:, None, None], ky[None, :, None], kz[None, None, :]


def k_squared(g: GridSpec, rfft: bool = True, dtype=torch.float32,
              device=None):
    kx, ky, kz = kvec(g, rfft=rfft, dtype=dtype, device=device)
    return kx * kx + ky * ky + kz * kz


def nyquist_mask(g: GridSpec, rfft: bool = True, dtype=torch.float32,
                 device=None):
    """1.0 away from any Nyquist plane, 0.0 on them (fourier.py:50-62)."""
    def axis_mask(n, m):
        mask = torch.ones(m, dtype=dtype, device=device)
        if n % 2 == 0 and n // 2 < m:
            mask[n // 2] = 0.0
        return mask

    mx = axis_mask(g.N1, g.N1)[:, None, None]
    my = axis_mask(g.N2, g.N2)[None, :, None]
    mz = axis_mask(g.N3, g.N3 // 2 + 1 if rfft else g.N3)[None, None, :]
    return mx * my * mz


def rfft3(x):
    """Real-to-half-complex 3D FFT, unnormalized forward (= fftR2C)."""
    return torch.fft.rfftn(x, dim=_AXES)


def irfft3(X, g: GridSpec):
    """Half-complex-to-real 3D FFT with 1/N (= fftC2R)."""
    return torch.fft.irfftn(X, s=g.shape, dim=_AXES)


def hermitian_part(X, g: GridSpec):
    """X with its self-paired z planes (kz = 0, and kz = N3/2 for even N3)
    replaced by their Hermitian part (X(k) + conj X(-k)) / 2.

    A half-complex array is the spectrum of a real field only if those
    planes are Hermitian; a C2R transform of one that is not is left
    unspecified, and FFT libraries differ there: pocketfft (the CPU
    reference, JAX's and torch's) takes the Hermitian part.  Projecting
    first makes irfft3 give the CPU reference's field on every device."""
    n3h = X.shape[-1]
    ix = torch.remainder(-torch.arange(g.N1, device=X.device), g.N1)
    iy = torch.remainder(-torch.arange(g.N2, device=X.device), g.N2)

    def sym(P):
        return 0.5 * (P + P.index_select(-3, ix).index_select(-2, iy).conj())

    if g.N3 % 2 == 0:
        return torch.cat([sym(X[..., :1]), X[..., 1:n3h - 1],
                          sym(X[..., n3h - 1:])], dim=-1)
    return torch.cat([sym(X[..., :1]), X[..., 1:]], dim=-1)


def gradfft(x, g: GridSpec, axis: int):
    """Spectral gradient along grid axis `axis` (0, 1, 2), Nyquist planes
    zeroed (fourier.py:98-107)."""
    kl = kvec(g, dtype=x.dtype, device=x.device)[axis]
    return irfft3((1j * kl) * rfft3(x) * nyquist_mask(g, device=x.device), g)


def gradfindif(x, g: GridSpec, axis: int):
    """4th-order central finite-difference gradient with periodic wrap,
    f' = [(4/3)(f_{+1} - f_{-1}) - (1/6)(f_{+2} - f_{-2})] / (2 d)
    (fourier.py:110-122)."""
    d = g.cell[axis]
    dim = axis - 3

    def r(s):  # f(x + s)
        return torch.roll(x, -s, dim)

    return ((4.0 / 3.0) * (r(1) - r(-1))
            - (1.0 / 6.0) * (r(2) - r(-2))) / (2.0 * d)


def grad_inv_lap_C(X, g: GridSpec, axis: int):
    """Multiply a half-complex field by -i k_axis / k^2, Nyquist zeroed
    (fourier.py:125-135)."""
    kx, ky, kz = kvec(g, device=X.device)
    k2 = kx * kx + ky * ky + kz * kz
    kl = (kx, ky, kz)[axis]
    fac = torch.where(k2 > 0, kl / torch.where(k2 > 0, k2, 1.0), 0.0)
    return (-1j) * fac * X * nyquist_mask(g, device=X.device)


def poisson_inv_C(X, g: GridSpec):
    """Multiply a half-complex field by -1/k^2, DC zeroed
    (fourier.py:138-145)."""
    k2 = k_squared(g, device=X.device)
    return torch.where(k2 > 0, -1.0 / torch.where(k2 > 0, k2, 1.0), 0.0) * X


def poisson_solve(delta, g: GridSpec):
    """phi with lap(phi) = delta (spectral -1/k^2)."""
    return irfft3(poisson_inv_C(rfft3(delta), g), g)


def displacement_from_phi(phi, g: GridSpec):
    """Psi_i = d/dx_i of the inverse Laplacian of phi, stacked on axis -4:
    one rfft and one batched irfft (fourier.py:153-168)."""
    kx, ky, kz = kvec(g, device=phi.device)
    k2 = kx * kx + ky * ky + kz * kz
    guard = k2 > 1e-14
    inv_k2 = torch.where(guard, 1.0 / torch.where(guard, k2, 1.0), 0.0)
    base = (-1j) * rfft3(phi) * inv_k2 * nyquist_mask(g, device=phi.device)
    return irfft3(torch.stack([kx * base, ky * base, kz * base], dim=-4), g)


def hermitian_mult(g: GridSpec, dtype=torch.float32, device=None):
    """Multiplicity of each half-complex mode in the full complex grid:
    2 for 0 < kz < N3/2, else 1 (fourier.py:167-174)."""
    n3h = g.N3 // 2 + 1
    iz = torch.arange(n3h, device=device)
    nyq = (g.N3 % 2 == 0) & (iz == g.N3 // 2)
    mult_z = torch.where((iz > 0) & ~nyq, 2.0, 1.0).to(dtype)
    return mult_z[None, None, :]


def _inv_corr_fac(g: GridSpec, corr_rfft):
    """(V/N)/C(k), zero where C <= 0."""
    norm_fs = g.vol / g.N
    pos = corr_rfft > 0.0
    return torch.where(pos, norm_fs / torch.where(pos, corr_rfft, 1.0), 0.0)


def inv_corr_quadratic_C(X, g: GridSpec, corr_rfft):
    """1/2 x . IFFT[(V/N)/C(k) FFT(x)] evaluated in Fourier space via
    Parseval from X = rfft3(x): (1/2N) sum_k mult_k (V/N)/C(k) |X_k|^2
    (fourier.py:177-192).  Sums over the last three axes, so a batch of
    chains gives one value per chain."""
    fac = _inv_corr_fac(g, corr_rfft)
    p_mode = X.real * X.real + X.imag * X.imag
    mult = hermitian_mult(g, p_mode.dtype, p_mode.device)
    return 0.5 / g.N * torch.sum(mult * fac * p_mode, dim=_AXES)


def convolve_inv_corr(x, g: GridSpec, corr_rfft):
    """out = IFFT[ (V/N) / C(k) * FFT(x) ], zero where C <= 0
    (fourier.py:195-206)."""
    return irfft3(_inv_corr_fac(g, corr_rfft) * rfft3(x), g)


def apply_corr(x, g: GridSpec, corr_rfft):
    """out = IFFT[(N/V) C(k) FFT(x)], the inverse of convolve_inv_corr
    (fourier.py:209-212)."""
    return irfft3((g.N / g.vol) * corr_rfft * rfft3(x), g)


def smooth(x, g: GridSpec, scale: float, filtertype: int = 1):
    """Fourier-space smoothing (fourier.py:213-233): 1 Gaussian
    exp(-k^2 r^2 / 2), 2 top-hat k <= scale, 3 erfc transition of width
    0.3 around k = scale."""
    k2 = k_squared(g, dtype=x.dtype, device=x.device)
    if filtertype == 1:
        K = torch.exp(-k2 * (scale * scale) / 2.0)
    elif filtertype == 2:
        K = (torch.sqrt(k2) <= scale).to(x.dtype)
    elif filtertype == 3:
        u = (torch.sqrt(k2) - scale) / (math.sqrt(2.0) * 0.3)
        K = torch.special.erfc(u)
    else:
        raise ValueError(f"unknown filtertype {filtertype}")
    return irfft3(K * rfft3(x), g)


def smooth_zeropad(x, g: GridSpec, scale: float, filtertype: int = 1):
    """`smooth` with 2x zero-padding, the reference's non-periodic branch
    (fourier.py:239-255): the field sits at the centre of a doubled box."""
    gz = GridSpec(2 * g.N1, 2 * g.N2, 2 * g.N3, 2 * g.L1, 2 * g.L2, 2 * g.L3)
    sl = (..., slice(g.N1 // 2, g.N1 // 2 + g.N1),
          slice(g.N2 // 2, g.N2 // 2 + g.N2),
          slice(g.N3 // 2, g.N3 // 2 + g.N3))
    big = x.new_zeros(x.shape[:-3] + gz.shape)
    big[sl] = x
    return smooth(big, gz, scale, filtertype)[sl]


def fft_upsample(x, g: GridSpec, factor: int):
    """Band-limited upsampling by Fourier zero-padding (fourier.py:258-276):
    the mean and every existing mode are kept, the new modes are zero."""
    X = rfft3(x)
    g2 = GridSpec(factor * g.N1, factor * g.N2, factor * g.N3, g.L1, g.L2,
                  g.L3)
    big = X.new_zeros(X.shape[:-3] + g2.rshape)
    n1, n2, n3h = g.rshape
    h1, h2 = g.N1 // 2, g.N2 // 2
    # the four (x, y) frequency corners; z is already low-first in rfft
    big[..., :h1, :h2, :n3h] = X[..., :h1, :h2, :]
    big[..., :h1, -(n2 - h2):, :n3h] = X[..., :h1, h2:, :]
    big[..., -(n1 - h1):, :h2, :n3h] = X[..., h1:, :h2, :]
    big[..., -(n1 - h1):, -(n2 - h2):, :n3h] = X[..., h1:, h2:, :]
    return irfft3(big, g2) * (factor**3)


# ---------------------------------------------------------------------------
# Power-spectrum measurement
# ---------------------------------------------------------------------------

def _shell_bins(g: GridSpec, nbin: int, device=None):
    """Per-rfft-mode (bin index, multiplicity, |k|) for spherical binning
    (fourier.py:279-296); modes with bin >= nbin go to the dropped bin."""
    kk = torch.sqrt(k_squared(g, device=device))
    dk = g.kmax / nbin
    ix = torch.floor(kk / dk).to(torch.int64)
    ix = torch.where(ix < nbin, ix, nbin)
    mult = hermitian_mult(g, kk.dtype, device).expand(g.rshape)
    return ix, mult, kk


@functools.lru_cache(maxsize=16)
def _bin_gather(g: GridSpec, nbin: int, device: str):
    """(bin mults, bin |k| sums, padded gather index) of the spherical bins.

    The index is (nbin, max_count) int32: row b lists the flat rfft modes of
    bin b in ascending order, padded with the index one past the last mode
    (a zero appended by `_bin_sums`).  A fixed-shape row sum over it adds
    every bin's modes in the same order on every call, so the binned sums
    are bit-identical from call to call on any device, where a float
    `index_add_` on a CUDA tensor adds in a new order each time."""
    bins, mult, kk = _shell_bins(g, nbin, device)
    flat = bins.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=nbin + 1)[:nbin]
    width = max(int(counts.max()), 1)
    start = torch.cumsum(counts, 0) - counts
    col = torch.arange(width, device=flat.device)
    n = flat.numel()
    idx = torch.where(col[None, :] < counts[:, None],
                      order[(start[:, None] + col[None, :]).clamp(max=n - 1)],
                      n).to(torch.int32)
    return _bin_sums(mult, idx), _bin_sums(mult * kk, idx), idx


def _bin_sums(v, idx):
    """Per-bin sums of the rfft-grid values v over the gather index."""
    flat = torch.cat([v.reshape(-1), v.new_zeros(1)])
    return flat.index_select(0, idx.reshape(-1)).reshape(idx.shape).sum(1)


def measure_spectrum(x, g: GridSpec, nbin: int):
    """Spherically binned P(k) of one field with the FOURIER_DEF_2 norm
    V/N^2 (fourier.py:299-318).  Returns (kmode, power, nmode).

    Each bin is summed in a fixed order (`_bin_gather`), so the result has
    the same bits on every call, on the card as on the CPU."""
    X = rfft3(x)
    p_mode = X.real * X.real + X.imag * X.imag
    nmode, ksum, idx = _bin_gather(g, nbin, str(x.device))
    mult = hermitian_mult(g, p_mode.dtype, x.device)
    psum = _bin_sums(mult * p_mode, idx)
    norm = g.vol / (float(g.N) * float(g.N))
    good = nmode > 0
    safe = torch.where(good, nmode, 1.0)
    kmode = torch.where(good, ksum / safe, 0.0)
    power = torch.where(good, psum / safe * norm, 0.0)
    return kmode, power, nmode.clone()


def rfft_grid_to_full(x, g: GridSpec):
    """Expand a real half-complex-layout grid (N1,N2,N3/2+1) to the full
    (N1,N2,N3) grid via the Hermitian mirror kz -> min(kz, N3-kz)
    (fourier.py:321-332)."""
    kz = torch.arange(g.N3, device=x.device)
    return torch.index_select(x, -1, torch.minimum(kz, g.N3 - kz))


def interp(x, xp, fp):
    """Piecewise-linear interpolation with end-value clamping, as
    `jnp.interp`."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.numel() - 1)
    x0, x1 = xp[i - 1], xp[i]
    f0, f1 = fp[i - 1], fp[i]
    f = f0 + (x - x0) / (x1 - x0) * (f1 - f0)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def power_table_to_rfft_grid(k_table, p_table, g: GridSpec,
                             dtype=torch.float32):
    """Interpolate a tabulated P(k) onto the half-complex |k| grid, DC
    zeroed (fourier.py:335-342).  The table's device and dtype set those of
    the interpolation."""
    kk = torch.sqrt(k_squared(g, dtype=k_table.dtype, device=k_table.device))
    P = interp(kk, k_table, p_table)
    P[0, 0, 0] = 0.0
    return P.to(dtype)
