"""Slab-decomposed 3D real FFTs over the ranks of a 'grid' process group.

Port of barcode_tpu/parallel/sharded_fft.py:1-138.  Layout:
  real space:     x-slabs, (..., N1/D, N2, N3) on grid rank d
  Fourier space:  half-complex ky-slabs, (..., N1, N2/D, N3//2+1)

rfft3: local rfft over z and fft over y, a tiled all-to-all (y split into D
blocks, the received x-slabs concatenated in rank order), then an fft over
x.  irfft3 is its exact inverse.  Leading dimensions (chains, vector
components) ride along in one collective.

The all-to-all is a `torch.autograd.Function` whose backward is the inverse
transpose (a permutation's adjoint is its inverse), so autograd through the
sharded spectral pipeline is sharded too.  Complex tensors travel as
`torch.view_as_real`, which NCCL and gloo both take.  At one rank the
transpose is still a call of `torch.distributed`.

Before the final C2R transform over z the imaginary parts of the kz = 0 and
kz = N3/2 planes are dropped: that is the Hermitian projection that the CPU
reference's C2R applies (the dense port's `fourier.hermitian_part`), made
explicit so that cuFFT gives the same field.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from barcode_tpu_torch.grid.spec import GridSpec

AXIS = "grid"


def _a2a(x, group, split: int, concat: int):
    """Tiled all-to-all of a complex (..., A, B, C) tensor over `group`.
    split=-2, concat=-3: B is cut into D blocks, block q goes to rank q,
    and the A-slabs received are concatenated in rank order; split=-3,
    concat=-2 is the inverse."""
    D = dist.get_world_size(group)
    xr = torch.view_as_real(x)  # (..., A, B, C, 2)
    lead = tuple(xr.shape[:-4])
    A, B, C = xr.shape[-4:-1]
    xr = xr.reshape(-1, A, B, C, 2)
    L = xr.shape[0]
    if (split, concat) == (-2, -3):
        send = xr.reshape(L, A, D, B // D, C, 2).permute(2, 0, 1, 3, 4, 5)
    else:
        send = xr.reshape(L, D, A // D, B, C, 2).permute(1, 0, 2, 3, 4, 5)
    send = send.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if (split, concat) == (-2, -3):
        out = recv.permute(1, 0, 2, 3, 4, 5).reshape(L, D * A, B // D, C, 2)
    else:
        out = recv.permute(1, 2, 0, 3, 4, 5).reshape(L, A // D, D * B, C, 2)
    return torch.view_as_complex(out.reshape(lead + out.shape[1:])
                                 .contiguous())


class _Transpose(torch.autograd.Function):
    """The tiled all-to-all with its inverse as the backward."""

    @staticmethod
    def forward(ctx, x, group, split: int, concat: int):
        ctx.group, ctx.split, ctx.concat = group, split, concat
        return _a2a(x, group, split, concat)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group, ctx.concat, ctx.split), None, None, None


def _y_to_x(f, group):
    """(..., N1/D, N2, N3h) -> (..., N1, N2/D, N3h)."""
    return _Transpose.apply(f, group, -2, -3)


def _x_to_y(f, group):
    """(..., N1, N2/D, N3h) -> (..., N1/D, N2, N3h)."""
    return _Transpose.apply(f, group, -3, -2)


def _rfft3_local(x_slab, group):
    """x-slab (..., N1/D, N2, N3) -> ky-slab (..., N1, N2/D, N3h)."""
    f = torch.fft.rfft(x_slab, dim=-1)
    f = torch.fft.fft(f, dim=-2)
    f = _y_to_x(f, group)
    return torch.fft.fft(f, dim=-3)


def _real_planes(f, n3: int):
    """Drop the imaginary part of the self-paired z planes (kz = 0 and, for
    even n3, kz = n3/2)."""
    re = torch.complex(f[..., :1].real, torch.zeros_like(f[..., :1].real))
    if n3 % 2:
        return torch.cat([re, f[..., 1:]], dim=-1)
    last = f[..., -1:]
    rl = torch.complex(last.real, torch.zeros_like(last.real))
    return torch.cat([re, f[..., 1:-1], rl], dim=-1)


def _irfft3_local(f_slab, n3: int, group):
    """ky-slab (..., N1, N2/D, N3h) -> x-slab (..., N1/D, N2, N3)."""
    f = torch.fft.ifft(f_slab, dim=-3)
    f = _x_to_y(f, group)
    f = torch.fft.ifft(f, dim=-2)
    return torch.fft.irfft(_real_planes(f, n3), n=n3, dim=-1)


def kvec_sharded(g: GridSpec, n_dev: int, dev_index: int,
                 dtype=torch.float32, device=None):
    """k-vectors of the Fourier layout (x full, y sharded, z rfft)."""
    n2_loc = g.N2 // n_dev
    ky = (2 * math.pi) * torch.fft.fftfreq(g.N2, d=g.L2 / g.N2, dtype=dtype,
                                           device=device)
    ky = ky[dev_index * n2_loc:(dev_index + 1) * n2_loc]
    kx = (2 * math.pi) * torch.fft.fftfreq(g.N1, d=g.L1 / g.N1, dtype=dtype,
                                           device=device)
    kz = (2 * math.pi) * torch.fft.rfftfreq(g.N3, d=g.L3 / g.N3, dtype=dtype,
                                            device=device)
    return kx[:, None, None], ky[None, :, None], kz[None, None, :]


def inv_k2_and_mask(g: GridSpec, n_dev: int, dev: int, device=None):
    """(kx, ky, kz), 1/k^2 (0 at k = 0) and the Nyquist mask of odd
    derivatives, by index on the sharded layout (sharded_fft.py:104-112)."""
    kx, ky, kz = kvec_sharded(g, n_dev, dev, device=device)
    k2 = kx * kx + ky * ky + kz * kz
    guard = k2 > 1e-14
    inv_k2 = torch.where(guard, 1.0 / torch.where(guard, k2, 1.0), 0.0)
    n2_loc = g.N2 // n_dev

    def mask(idx, nyq):
        return torch.where(idx == nyq, 0.0, 1.0)

    mx = mask(torch.arange(g.N1, device=device), g.N1 // 2)[:, None, None]
    my = mask(dev * n2_loc + torch.arange(n2_loc, device=device),
              g.N2 // 2)[None, :, None]
    mz = mask(torch.arange(g.N3 // 2 + 1, device=device),
              g.N3 // 2)[None, None, :]
    return (kx, ky, kz), inv_k2, mx * my * mz


def make_sharded_ops(g: GridSpec, layout):
    """This rank's sharded ops over its layout's grid group:
    rfft3(x), irfft3(F), convolve(x, kernel_fn), displacement(phi).

    kernel_fn(kx, ky, kz) -> multiplier, evaluated on the local k-block.
    displacement returns (3, ..., N1/D, N2, N3): Psi_i = irfft[-i k_i / k^2
    rfft(phi)], the three inverse transforms sharing one forward."""
    group, D, dev = layout.grid_group, layout.n_grid, layout.col

    def rfft3(x):
        return _rfft3_local(x, group)

    def irfft3(F):
        return _irfft3_local(F, g.N3, group)

    def convolve(x, kernel_fn):
        kx, ky, kz = kvec_sharded(g, D, dev, x.dtype, x.device)
        return irfft3(rfft3(x) * kernel_fn(kx, ky, kz))

    def displacement(phi):
        (kx, ky, kz), inv_k2, mask = inv_k2_and_mask(g, D, dev, phi.device)
        base = (-1j) * rfft3(phi) * inv_k2 * mask
        return irfft3(torch.stack([base * kx, base * ky, base * kz]))

    return rfft3, irfft3, convolve, displacement


def shard_real(x, layout):
    """This rank's x-slab of a full real field (..., N1, N2, N3)."""
    n1 = x.shape[-3] // layout.n_grid
    return x[..., layout.col * n1:(layout.col + 1) * n1, :, :]
