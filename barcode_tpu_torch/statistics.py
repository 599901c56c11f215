"""Field statistics beyond the 1D power spectrum: correlation functions,
2D (perp/parallel) spectra and the cross-chain convergence diagnostic.

Port of barcode_tpu/statistics.py (parity sources: measure_corr_grid,
tools/corr_fct.cc:20-84; measure_spec2D, tools/2D_powspec.cc:26-110;
measure_corr2D, tools/2D_corr_fct.cc:23-130).  The bin grids are computed
on the CPU in float32 with the JAX package's operations, so every cell
falls into the same bin as there, whatever the device, and every bin is
summed in a fixed order (`BinPlan`): a call gives the same bits every
time, on the card as on the CPU, where a float `index_add_` on a CUDA
tensor adds in a new order each time.

1D P(k) lives in grid/fourier.py (measure_spectrum).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from barcode_tpu_torch.grid import fourier
from barcode_tpu_torch.grid.spec import GridSpec

# entries of one fixed-order partial sum (`BinPlan`)
CHUNK = 32


def _center_on_origin(n: int, d: float, device=None):
    """Signed distance of cell i from the origin, min-image
    (pacman_center_on_origin, pacman.cpp)."""
    i = torch.arange(n, device=device)
    return torch.where(i <= n // 2, i, i - n).to(torch.float32) * d


def correlation_3d(x, g: GridSpec):
    """3D correlation grid xi(r) = (1/N^2) sum_k |delta_k|^2 e^{ikr}."""
    X = fourier.rfft3(x)
    p = (X.real * X.real + X.imag * X.imag).to(X.dtype)
    return fourier.irfft3(p, g) / g.N


def _r_grid(g: GridSpec, device=None):
    d1, d2, d3 = g.cell
    rx = _center_on_origin(g.N1, d1, device)[:, None, None]
    ry = _center_on_origin(g.N2, d2, device)[None, :, None]
    rz = _center_on_origin(g.N3, d3, device)[None, None, :]
    return rx, ry, rz


# The bin grids, on the CPU (`bin_plan`), in the JAX package's float32
# operations: its scalars rounded to float32 before it divides by them.

def _f32(v: float):
    return torch.tensor(v, dtype=torch.float32)


def _r_step(g: GridSpec, nbin: int):
    """dr = rmax / nbin with rmax = sqrt(3) L/2."""
    return torch.sqrt(_f32(3.0)) * g.L1 / 2.0 / _f32(float(nbin))


def _corr_bins(g: GridSpec, nbin: int):
    """Spherical r bins of the real grid (statistics.py:47-57); cells past
    the last bin go to bin nbin (dropped)."""
    rx, ry, rz = _r_grid(g)
    rr = torch.sqrt(rx * rx + ry * ry + rz * rz)
    bins = torch.floor(rr / _r_step(g, nbin)).to(torch.int64)
    return torch.clamp(bins, max=nbin), nbin


def _corr2d_bins(g: GridSpec, nbin: int):
    """(r_perp, r_par) bins bpar + nbin * bperp (statistics.py:114-124);
    cells outside either range go to bin nbin^2 (dropped)."""
    rx, ry, rz = _r_grid(g)
    return _pair_bins(torch.sqrt(rx * rx + ry * ry), torch.abs(rz),
                      _r_step(g, nbin), nbin)


def _spec2d_bins(g: GridSpec, nbin: int):
    """(k_perp, k_par) bins of the rfft modes, dk = kmax / (nbin - 1)
    (statistics.py:79-92)."""
    kx, ky, kz = fourier.kvec(g)
    return _pair_bins(torch.sqrt(kx * kx + ky * ky), torch.abs(kz),
                      _f32(g.kmax) / _f32(float(nbin - 1)), nbin)


def _pair_bins(perp, par, step, nbin: int):
    bperp = torch.floor(perp / step).to(torch.int64)
    bpar = torch.floor(par / step).to(torch.int64)
    bperp, bpar = torch.broadcast_tensors(bperp, bpar)
    valid = (bperp < nbin) & (bpar < nbin)
    return torch.where(valid, bpar + nbin * bperp, nbin * nbin), nbin * nbin


_BINS = {"corr": _corr_bins, "corr2d": _corr2d_bins, "spec2d": _spec2d_bins}


@dataclasses.dataclass(frozen=True)
class BinPlan:
    """Fixed-order sums over the bins of one grid.

    Built from the stable argsort of the flat bin index and each bin's
    cell count (`counts`).  `levels` are the padded gather indices of a
    tree of partial sums: the first lists each bin's cells CHUNK at a time,
    in ascending order (padding points one past the last cell, a zero
    appended by `sums`); each next level lists the previous level's
    partial sums of each bin CHUNK at a time, until each bin has one,
    whose row `last` gives (-1 for an empty bin).  Every call adds the same
    values in the same order, whatever the device."""
    counts: torch.Tensor
    levels: tuple
    last: torch.Tensor

    @property
    def nbytes(self) -> int:
        """Device memory of the plan."""
        return sum(t.numel() * t.element_size()
                   for t in (self.counts, self.last, *self.levels))

    def sums(self, values):
        """(..., nbins) per-bin sums of values (..., N1, N2, N3|N3h) over
        the plan's grid cells."""
        lead = tuple(values.shape[:-3])
        v = values.reshape(lead + (-1,))
        for idx in self.levels:
            v = torch.cat([v, v.new_zeros(lead + (1,))], dim=-1)
            v = v.index_select(-1, idx.reshape(-1)).reshape(
                lead + tuple(idx.shape)).sum(-1)
        v = torch.cat([v, v.new_zeros(lead + (1,))], dim=-1)
        return v.index_select(-1, torch.where(self.last >= 0, self.last,
                                              v.shape[-1] - 1))


def _chunks(counts, width: int, n_src: int, src_index=None):
    """The padded (n_chunks, width) gather index of `width`-entry chunks of
    segments laid out one after another in a source of n_src entries
    (segment b: counts[b] entries from the running offset), padding n_src;
    with `src_index`, the entries map through it.  Returns the index and
    each segment's chunk count."""
    device = counts.device
    nch = (counts + width - 1) // width
    seg_start = torch.cumsum(counts, 0) - counts
    seg = torch.repeat_interleave(torch.arange(counts.numel(), device=device),
                                  nch)
    first = torch.cumsum(nch, 0) - nch
    j = torch.arange(seg.numel(), device=device) - first[seg]
    start = seg_start[seg] + j * width
    length = torch.clamp(counts[seg] - j * width, max=width)
    col = torch.arange(width, device=device)
    pos = start[:, None] + col[None, :]
    inside = col[None, :] < length[:, None]
    if src_index is not None:
        pos = src_index[torch.where(inside, pos, 0)]
    idx = torch.where(inside, pos, n_src)
    return idx.to(torch.int32 if n_src < 2**31 else torch.int64), nch


def _plan_from_bins(bins, nbins: int) -> BinPlan:
    flat = bins.reshape(-1)
    n = flat.numel()
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=nbins + 1)[:nbins]
    idx, cnt = _chunks(counts, CHUNK, n, src_index=order)
    del order
    levels = [idx]
    while int(cnt.max()) > 1:
        idx, cnt = _chunks(cnt, CHUNK, idx.shape[0])
        levels.append(idx)
    last = torch.where(cnt > 0, torch.cumsum(cnt, 0) - cnt, -1)
    return BinPlan(counts, tuple(levels), last)


@functools.lru_cache(maxsize=16)
def bin_plan(kind: str, g: GridSpec, nbin: int, device: str) -> BinPlan:
    """The cached BinPlan of one statistic's bins ('corr', 'corr2d',
    'spec2d') for a grid, a bin count and a device.  The bin grid is
    computed on the CPU for every device, so a cell at a bin edge falls
    into the same bin on the card as on the CPU; the plan is built on the
    device."""
    bins, nbins = _BINS[kind](g, nbin)
    return _plan_from_bins(bins.to(device), nbins)


def _binned(plan: BinPlan, values, shape):
    """Per-bin sums of each of `values` (each broadcast to `shape`)."""
    return plan.sums(torch.stack([torch.broadcast_to(v, shape)
                                  for v in values]))


def _means(sums, nmode):
    good = nmode > 0
    safe = torch.where(good, nmode, 1.0)
    return [torch.where(good, s / safe, 0.0) for s in sums]


def measure_correlation(x, g: GridSpec, nbin: int):
    """Spherically averaged xi(r) (measure_corr_grid, corr_fct.cc:20-84).

    rmax = sqrt(3) L/2; returns (rmode, corr, nmode)."""
    xi3 = correlation_3d(x, g)
    rx, ry, rz = _r_grid(g, x.device)
    rr = torch.sqrt(rx * rx + ry * ry + rz * rz)
    plan = bin_plan("corr", g, nbin, str(x.device))
    nmode, rsum, csum = _binned(plan, (torch.ones((), device=x.device), rr,
                                       xi3), g.shape)
    rmode, corr = _means((rsum, csum), nmode)
    return rmode, corr, nmode


def measure_spectrum_2d(x, g: GridSpec, nbin: int):
    """P(k_perp, k_par), plane-parallel LOS along z (measure_spec2D,
    2D_powspec.cc:26-110).

    Returns (kmode, power, nmode), each [nbin, nbin] with perp varying along
    axis 0 (row-major index npar + nbin*nperp like the reference).
    Normalization V/(4 pi N^2) follows the reference."""
    X = fourier.rfft3(x)
    p_mode = X.real * X.real + X.imag * X.imag
    kx, ky, kz = fourier.kvec(g, device=x.device)
    kperp = torch.sqrt(kx * kx + ky * ky)
    kpar = torch.abs(kz)
    ktot = torch.sqrt(kperp * kperp + kpar * kpar)
    mult = fourier.hermitian_mult(g, device=x.device)
    plan = bin_plan("spec2d", g, nbin, str(x.device))
    nmode, ksum, psum = _binned(plan, (mult, mult * ktot, mult * p_mode),
                                g.rshape)
    norm = g.vol / (4.0 * math.pi) / (float(g.N) ** 2)
    kmode, power = _means((ksum, norm * psum), nmode)
    return tuple(t.reshape(nbin, nbin) for t in (kmode, power, nmode))


def measure_correlation_2d(x, g: GridSpec, nbin: int):
    """xi(sigma, pi): 2D correlation, perp on axis 0, par (LOS=z) on axis 1
    (measure_corr2D, 2D_corr_fct.cc:23-130).  rmax = sqrt(3) L/2 shared by
    both axes like the reference."""
    xi3 = correlation_3d(x, g)
    rx, ry, rz = _r_grid(g, x.device)
    rperp = torch.sqrt(rx * rx + ry * ry)
    rpar = torch.abs(rz)
    rtot = torch.sqrt(rperp * rperp + rpar * rpar)
    plan = bin_plan("corr2d", g, nbin, str(x.device))
    nmode, rsum, csum = _binned(plan, (torch.ones((), device=x.device), rtot,
                                       xi3), g.shape)
    rmode, corr = _means((rsum, csum), nmode)
    return tuple(t.reshape(nbin, nbin) for t in (rmode, corr, nmode))


def gelman_rubin(chains_samples):
    """Split-R-hat over [n_chains, n_samples, ...] sample stacks — the
    cross-chain convergence diagnostic the single-chain reference cannot
    compute (statistics.py:140-152)."""
    x = torch.as_tensor(chains_samples)
    m, n = x.shape[0] * 2, x.shape[1] // 2
    x = x[:, : 2 * n].reshape((m, n) + tuple(x.shape[2:]))
    mean_c = x.mean(dim=1)
    var_c = x.var(dim=1, correction=1)
    W = var_c.mean(dim=0)
    B = n * mean_c.var(dim=0, correction=1)
    var_post = (n - 1) / n * W + B / n
    return torch.sqrt(var_post / W)
