"""Gaussian random fields with a prescribed power spectrum.

Port of barcode_tpu/random_fields.py:34-116.

  * `grf` colours white real-space noise: rfftn of white noise is Hermitian
    with E|X_k|^2 = N for every mode, so scaling by sqrt(P * N / V) gives
    E|delta_k|^2 = N^2 P / V, the reference's target amplitude.  Its draws
    come from an explicit `torch.Generator`, whose stream differs from
    JAX's threefry, so parity tests hand the same white noise to both
    packages.
  * `grf_resolution_independent` draws every Fourier mode as a pure
    function of (seed, canonical signed wavevector), so one seed gives the
    same large-scale modes at any grid size: the determinism property of
    the reference's corner-out fill (random.hpp:36-120).  The seed is drawn
    once from the caller's generator; each mode's two normals come from a
    counter-based Threefry-2x32 hash of its wavevector, computed with
    integer operations that cannot overflow int64 (the same bits on the CPU
    and the card), then Box-Muller in float64.  The JAX package hashes with
    `jax.random.fold_in`, so the two agree in distribution, not in value.
"""
from __future__ import annotations

import math

import torch

from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.grid import fourier


def white_noise(generator: torch.Generator, g: GridSpec, batch: tuple = (),
                dtype=torch.float32):
    """Unit normal noise of shape batch + grid shape, on the generator's
    device."""
    return torch.randn(tuple(batch) + g.shape, generator=generator,
                       dtype=dtype, device=generator.device)


def grf_from_white(white, g: GridSpec, power_rfft):
    """Color real-space white noise to the target spectrum (half-complex P)."""
    amp = torch.sqrt(power_rfft * (g.N / g.vol))
    return fourier.irfft3(amp * fourier.rfft3(white), g)


def grf(generator: torch.Generator, g: GridSpec, power_rfft, batch: tuple = (),
        dtype=torch.float32):
    """delta ~ GRF with spectrum P(k); E[measure_spectrum(delta)] = P."""
    return grf_from_white(white_noise(generator, g, batch, dtype), g,
                          power_rfft)


# ---------------------------------------------------------------------------
# Resolution-independent variant (random_fields.py:53-116)
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
_THREEFRY_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(key: tuple, x0, x1):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011, as
    `jax.random.threefry_2x32`) of the counters (x0, x1) under the key
    (k0, k1): 32-bit words held in int64 tensors (or ints), so every add,
    rotate and xor is exact."""
    k0, k1 = key
    ks = (k0, k1, 0x1BD11BDA ^ k0 ^ k1)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in _THREEFRY_ROT[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _MASK32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x0, x1


def _signed_freqs(g: GridSpec, device=None):
    """Signed integer frequencies of the rfft layout per axis, the Nyquist
    frequency as +N/2 (scale_space.cpp:41-51), int64, broadcastable."""
    def signed(n):
        i = torch.arange(n, device=device)
        return torch.where(i <= n // 2, i, i - n)

    return (signed(g.N1)[:, None, None], signed(g.N2)[None, :, None],
            torch.arange(g.N3 // 2 + 1, device=device)[None, None, :])


def _mode_normals(seed: int, cx, cy, cz):
    """Two unit normals per wavevector (cx, cy, cz), a pure function of the
    seed and the wavevector: Threefry-2x32 keyed by the seed hashes (cx, cy),
    its output keys a second hash of (cz, 0), and Box-Muller turns the two
    words into normals (float64)."""
    key = (seed & _MASK32, (seed >> 32) & _MASK32)
    a, b = threefry2x32(key, cx & _MASK32, cy & _MASK32)
    w0, w1 = threefry2x32((a, b), cz & _MASK32, torch.zeros_like(cz))
    u1 = ((w0 >> 8).double() + 0.5) * 2.0**-24  # (0, 1)
    u2 = (w1 >> 8).double() * 2.0**-24          # [0, 1)
    rad = torch.sqrt(-2.0 * torch.log(u1))
    return rad * torch.cos(2.0 * math.pi * u2), rad * torch.sin(2.0 * math.pi * u2)


def _unit_hermitian_modes(seed: int, g: GridSpec, device=None):
    """Complex field A on the rfft grid with E|A|^2 = 2 for every mode,
    Hermitian-consistent, each mode's value a pure function of (seed,
    signed wavevector), hence stable under grid refinement."""
    fx, fy, fz = (f.expand(g.rshape) for f in _signed_freqs(g, device))

    # per-axis state under torus negation: 0 for the self-negating
    # frequencies (0 and Nyquist), else the sign
    def state(f, n):
        return torch.where((f == 0) | (2 * f == n), 0, torch.sign(f))

    # torus negation: -f, except Nyquist (and 0) map to themselves
    def neg(f, n):
        return torch.where(2 * f == n, f, -f)

    sx, sy = state(fx, g.N1), state(fy, g.N2)
    # a mode on the fz == 0 plane (and fz == N3/2 for even N3) pairs with
    # the torus-negated (fx, fy) on the same plane: draw the canonical one
    on_pair_plane = (fz == 0) | ((g.N3 % 2 == 0) & (fz == g.N3 // 2))
    canonical = (sy > 0) | ((sy == 0) & (sx >= 0))
    take_conj = on_pair_plane & ~canonical
    cx = torch.where(take_conj, neg(fx, g.N1), fx)
    cy = torch.where(take_conj, neg(fy, g.N2), fy)
    self_conj = on_pair_plane & (sx == 0) & (sy == 0)
    a, b = (v.float() for v in _mode_normals(seed, cx, cy, fz))
    re = torch.where(self_conj, math.sqrt(2.0) * a, a)
    im = torch.where(self_conj, 0.0, torch.where(take_conj, -b, b))
    return torch.complex(re, im)


def draw_seed(generator: torch.Generator) -> int:
    """One 63-bit seed from the generator (one host sync)."""
    return int(torch.randint(0, 2**63 - 1, (), generator=generator,
                             device=generator.device))


def grf_resolution_independent(generator: torch.Generator, g: GridSpec,
                               power_rfft, dtype=torch.float32):
    """GRF whose large-scale modes are identical across grid sizes for one
    generator state (the reference's random.hpp determinism feature), on
    the device of `power_rfft`."""
    A = _unit_hermitian_modes(draw_seed(generator), g, power_rfft.device)
    sigma = torch.sqrt(power_rfft * (g.N * (g.N / g.vol)) / 2.0)
    return fourier.irfft3(A * sigma, g).to(dtype)
