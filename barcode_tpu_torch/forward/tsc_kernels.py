"""Windowed TSC deposit (K1, K1s) and gradient gather (K2): kernels + plain
versions.

Port of barcode_tpu/forward/pallas_deposit.py.  The TPU kernels there
compute TSC with a *window* rule that the port must reproduce, because it
decides what a particle that breaks the halo contract contributes:

  * K1 `tsc_deposit_window` (TPU: `tsc_deposit_pallas`): each (BX, BY)
    output block sums only the particles of its Lagrangian window
    [I*BX - hx, I*BX + BX + hx) x [J*BY - hy, ...), x/y wrapping through
    +-N copies of the particle grid.  A violator deposits PARTIAL mass.
    Effective halos: hx rounded by `_round_halo(hx, BX)`, hy tight.
  * K1s, `tsc_deposit_window(..., stream=True)` (TPU: the streamed-window
    body of `tsc_deposit_pallas(stream=True)`): the same function as K1,
    bit for bit, computed by a pull kernel whose thread-block clusters own
    their output columns in shared memory and stream each window through
    it.  `stream=None` selects it exactly where the JAX package selects its
    streamed kernel (`stream_selected`).
  * K2 `tsc_gather_grads_window` (TPU: `tsc_gather_grads_pallas`): the TSC
    value and three position derivatives (divided by the cell size) of a
    field, counting only taps inside the field window of the particle's
    own (BX, BY) block.  Effective halos: hy rounded by `_round_halo`, hx
    tight.

Each wrapper takes a CPU tensor to its plain PyTorch version, written with
the same window semantics (the tests hold these against the Pallas kernels
in interpret mode), and a CUDA tensor to its hand-written CUDA kernel
(`csrc/tsc_deposit.cu`, `csrc/tsc_deposit_stream.cu`, `csrc/tsc_gather.cu`).
There is no fallback: a CUDA tensor launches the kernel or raises.  Each
kernel's launches are counted in the `launches` attribute of its launcher:
`tsc_deposit_window` (K1), `tsc_deposit_window_stream` (K1s) and
`tsc_gather_grads_window` (K2).

Positions are (3,) + grid or (C, 3) + grid for C chains (one launch covers
all chains); weights and fields are grid or (C,) + grid.

The halo helpers (`deposit_violations`, `displacement_bound_cells`,
`displacement_halo_quantile`) and the block gate (`deposit_working_set_bytes`,
used by `assign.auto_block_dep` so both packages pick the same windows) are
ported alongside.
"""
from __future__ import annotations

import torch

from barcode_tpu_torch.grid.spec import GridSpec

_OFFSETS = (-1, 0, 1)


def _halo_pair(halo):
    """Accept an int (same contract both axes) or an (hx, hy) pair."""
    if isinstance(halo, (tuple, list)):
        hx, hy = halo
        return int(hx), int(hy)
    return int(halo), int(halo)


def _round_halo(halo: int, B: int) -> int:
    """Smallest h >= halo with (B + 2h) % 8 == 0 — the TPU's window
    divisibility, kept because it changes which taps a violator keeps
    (pallas_deposit.py:110-120)."""
    h = halo
    while (B + 2 * h) % 8:
        h += 1
    return h


def _sub_tile(T: int, weight: int, budget_bytes: int = 6 << 20) -> int:
    """pallas_deposit.py:_sub_tile (feeds deposit_working_set_bytes)."""
    t = T
    while t > 1 and weight * t * 4 > budget_bytes:
        t //= 2
    return max(t, 1)


# the JAX package's deposit gates (pallas_deposit.py:134-169): the port keeps
# them so `auto_block_dep` picks the same block, hence the same windows, and
# `stream_selected` the same kernel (K1 or K1s) as the TPU path
DEP_VMEM_BUDGET = 10 << 20
STREAM_RS = 8


def deposit_working_set_bytes(g: GridSpec, halo, block_dep: tuple,
                              weighted: bool = False,
                              streamed: bool = False) -> int:
    BX, BY = block_dep
    hx, hy = _halo_pair(halo)
    hx = _round_halo(hx, BX)
    WX, WY = BX + 2 * hx, BY + 2 * hy
    nc = 7 if weighted else 6
    nxy = BX * BY
    rows = min(2 * STREAM_RS, WX) if streamed else WX
    window = nc * rows * WY * g.N3 * 4
    TS = _sub_tile(WY * g.N3, g.N3 + nxy)
    return window + TS * (g.N3 + nxy) * 4 + nxy * g.N3 * 4


def stream_selected(g: GridSpec, halo, block: tuple,
                    weighted: bool = False) -> bool:
    """The JAX package's choice of its streamed deposit body
    (pallas_deposit.py:815-817): the full window's working set over
    DEP_VMEM_BUDGET.  K1s runs wherever this is True."""
    return deposit_working_set_bytes(g, halo, block,
                                     weighted=weighted) > DEP_VMEM_BUDGET


# ---------------------------------------------------------------------------
# Phase A: per-particle cells and fractions
# ---------------------------------------------------------------------------

def _cell(g: GridSpec, like):
    return torch.tensor(g.cell, dtype=like.dtype,
                        device=like.device).reshape(3, 1, 1, 1)


def _lagrangian_rows(g: GridSpec, like):
    qx = torch.arange(g.N1, dtype=like.dtype, device=like.device)[:, None, None]
    qy = torch.arange(g.N2, dtype=like.dtype, device=like.device)[None, :, None]
    return qx, qy


def _particle_channels(pos, g: GridSpec):
    """(bx, by, bz, fx, fy, fz) of every particle, each batch + grid shape:
    x/y base cells unwrapped to the particle's own Lagrangian row (q +
    min-image offset), z base wrapped, fractions u - base - 0.5 — the float
    arithmetic of pallas_deposit.py:_phase_a."""
    u = pos / _cell(g, pos)
    base = torch.floor(u)
    frac = u - base - 0.5
    qx, qy = _lagrangian_rows(g, pos)

    def unwrap(b, q, n):
        return q + (torch.remainder(b - q + n / 2.0, n) - n / 2.0)

    b0, b1, b2 = base.unbind(-4)
    f0, f1, f2 = frac.unbind(-4)
    return (unwrap(b0, qx, g.N1), unwrap(b1, qy, g.N2),
            torch.remainder(b2, g.N3), f0, f1, f2)


def deposit_violations(pos, g: GridSpec, halo):
    """Number of particles whose deposit support breaks the halo contract
    |base - q| <= h - 1 in x or y (pallas_deposit.py:89-101); one count per
    chain for batched positions."""
    hx, hy = _halo_pair(halo)
    base = torch.floor(pos / _cell(g, pos))
    qx, qy = _lagrangian_rows(g, pos)
    offx = torch.remainder(base[..., 0, :, :, :] - qx + g.N1 / 2, g.N1) - g.N1 / 2
    offy = torch.remainder(base[..., 1, :, :, :] - qy + g.N2 / 2, g.N2) - g.N2 / 2
    bad = (offx.abs() > hx - 1) | (offy.abs() > hy - 1)
    return bad.sum(dim=(-3, -2, -1))


def _offset_histogram(delta, g: GridSpec, fc, gp):
    """bincount of max(|x off|, |y off|) cells of the particle map for
    `delta` (RSD off: the x/y contract is RSD-free), pallas_deposit.py:
    591-620.  Over the full min-image range, so nothing is dropped."""
    import dataclasses

    import numpy as np

    from barcode_tpu_torch.forward.lag2eul import displaced_positions

    fc_norsd = dataclasses.replace(fc, rsd=False)
    with torch.no_grad():
        pos = displaced_positions(delta, g, fc_norsd, gp)
        base = torch.floor(pos / _cell(g, pos))
        qx, qy = _lagrangian_rows(g, pos)
        offx = torch.remainder(base[0] - qx + g.N1 / 2, g.N1) - g.N1 / 2
        offy = torch.remainder(base[1] - qy + g.N2 / 2, g.N2) - g.N2 / 2
        m = torch.maximum(offx.abs(), offy.abs()).to(torch.int64)
        hist = torch.bincount(m.reshape(-1),
                              minlength=max(g.N1, g.N2) // 2 + 1)
    return np.asarray(hist.cpu())


def displacement_bound_cells(delta, g: GridSpec, fc, gp) -> int:
    """Measured halo contract: max |x/y cell offset| + TSC reach + margin
    (pallas_deposit.py:623-629)."""
    h = _offset_histogram(delta, g, fc, gp)
    return int(max(k for k, c in enumerate(h) if c > 0)) + 4


def displacement_halo_quantile(delta, g: GridSpec, fc, gp,
                               tail_k: int) -> int:
    """Quantile halo for the halo-tail split: the smallest halo whose
    violator count fits the tail capacity with 4x headroom
    (pallas_deposit.py:632-644)."""
    h = _offset_histogram(delta, g, fc, gp)
    viol = h[::-1].cumsum()[::-1]  # viol[k] = #particles with off >= k
    for k in range(1, len(viol)):
        if viol[k] <= tail_k // 4:
            return k
    return int(max(k for k, c in enumerate(h) if c > 0)) + 2


# ---------------------------------------------------------------------------
# Window rules and TSC weights (plain versions)
# ---------------------------------------------------------------------------

def _tsc_w(dx, s):
    if s == 0:
        return 0.75 - dx * dx
    return 0.5 * (1.5 - torch.abs(dx - s)) ** 2


def _tsc_dw(dx, s):
    """d/d(dx) of the per-axis TSC weight (cell units; callers divide by d)."""
    if s == 0:
        return -2.0 * dx
    return -(1.5 - torch.abs(dx - s)) * torch.sign(dx - s)


def _deposit_axis(b, q, n: int, B: int, h: int, o: int):
    """(wrapped target, mask) of offset o under the deposit window rule: the
    copy of the particle that reaches the target's block (shifted by
    s = wrap(X) - X) must lie in that block's Lagrangian window."""
    X = b + o
    Xw = torch.remainder(X, n)
    qq = q + (Xw - X)
    lo = torch.div(Xw, B, rounding_mode="floor") * B - h
    return Xw, (qq >= lo) & (qq < lo + B + 2 * h)


def _gather_axis(b, q, n: int, B: int, h: int, o: int):
    """(wrapped target, mask) of offset o under the gather window rule: the
    target must lie in the field window of the particle's own block."""
    X = b + o
    lo = torch.div(q, B, rounding_mode="floor") * B - h
    return torch.remainder(X, n), (X >= lo) & (X < lo + B + 2 * h)


def _taps(pos, g: GridSpec, rule, block, hx: int, hy: int):
    """Per-axis targets, masks and fractions of every particle."""
    bx, by, bz, fx, fy, fz = _particle_channels(pos, g)
    ix = torch.arange(g.N1, device=pos.device)[:, None, None]
    iy = torch.arange(g.N2, device=pos.device)[None, :, None]
    BX, BY = block
    X = [rule(bx.long(), ix, g.N1, BX, hx, o) for o in _OFFSETS]
    Y = [rule(by.long(), iy, g.N2, BY, hy, o) for o in _OFFSETS]
    Z = [torch.remainder(bz.long() + o, g.N3) for o in _OFFSETS]
    return X, Y, Z, (fx, fy, fz)


def _chain_offsets(pos, g: GridSpec):
    """Flat-index offset of each chain: 0 unbatched, c*N batched."""
    if pos.dim() == 4:
        return 0
    C = pos.shape[0]
    return (torch.arange(C, device=pos.device) * g.N).reshape(C, 1, 1, 1)


def tsc_deposit_window_plain(pos, g: GridSpec, halo=4, block=(8, 8),
                             weights=None):
    """Plain PyTorch version of K1: 27 `index_add_` passes with the deposit
    window masks (effective halos as the TPU kernel's)."""
    hx, hy = _halo_pair(halo)
    hx = _round_halo(hx, block[0])
    X, Y, Z, (fx, fy, fz) = _taps(pos, g, _deposit_axis, block, hx, hy)
    batch = pos.shape[:-4]
    out = torch.zeros(batch + g.shape, dtype=pos.dtype, device=pos.device)
    flat = out.reshape(-1)
    c0 = _chain_offsets(pos, g)
    for a, ox in enumerate(_OFFSETS):
        tx, mx = X[a]
        wx = _tsc_w(fx, ox) * mx
        for b, oy in enumerate(_OFFSETS):
            ty, my = Y[b]
            wxy = wx * (_tsc_w(fy, oy) * my)
            for k, oz in enumerate(_OFFSETS):
                w = wxy * _tsc_w(fz, oz)
                if weights is not None:
                    w = w * weights
                idx = c0 + (tx * g.N2 + ty) * g.N3 + Z[k]
                flat.index_add_(0, idx.reshape(-1), w.reshape(-1))
    return out


def tsc_gather_grads_window_plain(field, pos, g: GridSpec, halo=4,
                                  block=(8, 8), want_value=True):
    """Plain PyTorch version of K2: value (optional) and the three position
    derivatives, divided by the cell size, over the gather window taps."""
    hx, hy = _halo_pair(halo)
    hy = _round_halo(hy, block[1])
    X, Y, Z, (fx, fy, fz) = _taps(pos, g, _gather_axis, block, hx, hy)
    flat = field.reshape(-1)
    c0 = _chain_offsets(pos, g)
    w = [{s: _tsc_w(f, s) for s in _OFFSETS} for f in (fx, fy, fz)]
    dw = [{s: _tsc_dw(f, s) for s in _OFFSETS} for f in (fx, fy, fz)]
    val = gx = gy = gz = 0.0
    for a, ox in enumerate(_OFFSETS):
        tx, mx = X[a]
        for b, oy in enumerate(_OFFSETS):
            ty, my = Y[b]
            row = c0 + (tx * g.N2 + ty) * g.N3
            m = (mx & my).to(field.dtype)
            s = sd = 0.0
            for k, oz in enumerate(_OFFSETS):
                v = flat[row + Z[k]] * m
                s = s + w[2][oz] * v
                sd = sd + dw[2][oz] * v
            val = val + w[0][ox] * w[1][oy] * s
            gx = gx + dw[0][ox] * w[1][oy] * s
            gy = gy + w[0][ox] * dw[1][oy] * s
            gz = gz + w[0][ox] * w[1][oy] * sd
    d1, d2, d3 = g.cell
    chans = [gx / d1, gy / d2, gz / d3]
    if want_value:
        chans.insert(0, val)
    return torch.stack(chans, dim=-4)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_tensor(name, x, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_positions(pos, g: GridSpec, hx: int, hy: int, block):
    if pos.dim() not in (4, 5) or tuple(pos.shape[-4:]) != (3,) + g.shape:
        raise ValueError(f"pos must be (3,)+grid or (C,3)+grid, got "
                         f"{tuple(pos.shape)}")
    BX, BY = block
    if g.N1 % BX or g.N2 % BY:
        raise ValueError(f"block {block} does not divide grid {g.shape}")
    if not (0 < hx <= g.N1 and 0 < hy <= g.N2):
        raise ValueError(f"halo ({hx}, {hy}) must be in (0, N] per axis")


def _launch_args(g: GridSpec, C: int):
    d1, d2, d3 = g.cell
    return (C, g.N1, g.N2, g.N3, d1, d2, d3)


def _fixed_point_scale(weights, n_per_chain: int, device):
    """K1's fixed-point scale 2^e, a float64 scalar on the device (no host
    sync): the largest power of two with n_per_chain * max|w| * 2^e <= 2^62
    over the finite weights, so no cell's 64-bit sum can overflow; 1 when
    every weight is 0.  (Non-finite weights make their chain NaN.)"""
    if weights is None:
        wmax = torch.ones((), dtype=torch.float64, device=device)
    else:
        finite = torch.isfinite(weights)
        wmax = torch.where(finite, weights.abs(), 0.0).max().double()
    e = torch.floor(62.0 - torch.log2(wmax * n_per_chain))
    e = torch.where(wmax > 0, e, torch.zeros_like(e)).clamp(-1000.0, 1000.0)
    return torch.exp2(e)


def tsc_deposit_window(pos, g: GridSpec, halo=4, block=(8, 8), weights=None,
                       stream=None):
    """K1 or K1s: windowed TSC deposit (TPU: pallas_deposit.tsc_deposit_pallas).

    `halo` is the requested contract (int or (hx, hy)); hx is rounded as
    on the TPU.  `stream=None` picks K1s where the JAX package streams
    (`stream_selected`), K1 elsewhere; True/False force the choice, as the
    JAX argument does.  Returns grid or (C,) + grid float32.

    CPU tensors take the plain version, `tsc_deposit_window_plain`, for
    either choice: the TPU's two bodies compute one function, and the JAX
    package's tests hold both against one reference
    (tests/test_pallas_deposit.py:173-195).  CUDA tensors launch
    csrc/tsc_deposit.cu (K1) or csrc/tsc_deposit_stream.cu (K1s)."""
    hx, hy = _halo_pair(halo)
    hx = _round_halo(hx, block[0])
    _check_positions(pos, g, hx, hy, block)
    if stream is None:
        stream = stream_selected(g, (hx, hy), block, weights is not None)
    if pos.device.type == "cpu":
        return tsc_deposit_window_plain(pos, g, (hx, hy), block, weights)
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    batch = tuple(pos.shape[:-4])
    _check_tensor("pos", pos, pos.shape, pos.device)
    if weights is not None:
        _check_tensor("weights", weights, batch + g.shape, pos.device)
    if stream:
        return tsc_deposit_window_stream(pos, g, (hx, hy), block, weights)
    from barcode_tpu_torch import cuda_build

    lib, _ = cuda_build.load()
    C = batch[0] if batch else 1
    scale = _fixed_point_scale(weights, g.N, pos.device)
    acc = torch.zeros(batch + g.shape, dtype=torch.int64, device=pos.device)
    bad = torch.zeros(C, dtype=torch.int32, device=pos.device)
    rho = torch.empty(batch + g.shape, dtype=torch.float32, device=pos.device)
    with torch.cuda.device(pos.device):
        stream_ptr = torch.cuda.current_stream().cuda_stream
        status = lib.tsc_deposit_window_launch(
            pos.data_ptr(), weights.data_ptr() if weights is not None else None,
            scale.data_ptr(), acc.data_ptr(), bad.data_ptr(), rho.data_ptr(),
            *_launch_args(g, C), block[0], block[1], hx, hy, stream_ptr)
    cuda_build.check(lib, status, "tsc_deposit_window")
    tsc_deposit_window.launches += 1
    return rho


tsc_deposit_window.launches = 0

# K1s's accumulator tile: BX*BY*TZ int64 cells, 64 KB of shared memory where
# a cluster of at most STREAM_CLUSTER_MAX tiles covers the z column (TZ = 32
# z cells for the (16, 16) block at N3 = 256), at most 128 KB otherwise
STREAM_TILE_CELLS = 8192
STREAM_TILE_CELLS_MAX = 16384
STREAM_CLUSTER_MAX = 8


def stream_tile_z(g: GridSpec, block: tuple) -> int:
    """K1s's z extent per output tile: the z tiles of one (BX, BY) column
    form one thread-block cluster of at most STREAM_CLUSTER_MAX blocks."""
    nxy = block[0] * block[1]
    tz = max(-(-g.N3 // STREAM_CLUSTER_MAX),
             min(g.N3, max(1, STREAM_TILE_CELLS // nxy)))
    if nxy * tz > STREAM_TILE_CELLS_MAX:
        raise ValueError(f"block {block} at N3={g.N3} is too large for K1s's "
                         "shared-memory tiles")
    return tz


def tsc_deposit_window_stream(pos, g: GridSpec, halo, block: tuple,
                              weights=None):
    """K1s launcher: `tsc_deposit_window(..., stream=True)` on CUDA tensors
    (csrc/tsc_deposit_stream.cu).  `halo` is the (hx, hy) pair with hx
    already rounded; inputs are checked by the caller."""
    from barcode_tpu_torch import cuda_build

    hx, hy = halo
    batch = tuple(pos.shape[:-4])
    C = batch[0] if batch else 1
    tz = stream_tile_z(g, block)
    lib, _ = cuda_build.load()
    aligned = all(t is None or t.data_ptr() % 16 == 0 for t in (pos, weights))
    vec = 4 if g.N3 % 4 == 0 and aligned else 1
    scale = _fixed_point_scale(weights, g.N, pos.device)
    bad = torch.zeros(C, dtype=torch.int32, device=pos.device)
    rho = torch.empty(batch + g.shape, dtype=torch.float32, device=pos.device)
    with torch.cuda.device(pos.device):
        stream_ptr = torch.cuda.current_stream().cuda_stream
        status = lib.tsc_deposit_stream_launch(
            pos.data_ptr(), weights.data_ptr() if weights is not None else None,
            scale.data_ptr(), bad.data_ptr(), rho.data_ptr(),
            *_launch_args(g, C), block[0], block[1], hx, hy, tz, vec,
            stream_ptr)
    cuda_build.check(lib, status, "tsc_deposit_window_stream")
    tsc_deposit_window_stream.launches += 1
    return rho


tsc_deposit_window_stream.launches = 0


def tsc_gather_grads_window(field, pos, g: GridSpec, halo=4, block=(8, 8),
                            want_value=True):
    """K2: windowed TSC value + position-gradient gather (TPU:
    pallas_deposit.tsc_gather_grads_pallas).

    Returns batch + (4|3,) + grid float32: [value,] d/dx, d/dy, d/dz per
    physical position.  hy is rounded as on the TPU.  CPU tensors take the
    plain version; CUDA tensors launch csrc/tsc_gather.cu."""
    hx, hy = _halo_pair(halo)
    hy = _round_halo(hy, block[1])
    _check_positions(pos, g, hx, hy, block)
    if pos.device.type == "cpu":
        return tsc_gather_grads_window_plain(field, pos, g, (hx, hy), block,
                                             want_value)
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    from barcode_tpu_torch import cuda_build

    batch = tuple(pos.shape[:-4])
    _check_tensor("pos", pos, pos.shape, pos.device)
    _check_tensor("field", field, batch + g.shape, pos.device)
    lib, _ = cuda_build.load()
    nch = 4 if want_value else 3
    out = torch.empty(batch + (nch,) + g.shape, dtype=torch.float32,
                      device=pos.device)
    C = batch[0] if batch else 1
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.tsc_gather_grads_window_launch(
            field.data_ptr(), pos.data_ptr(), out.data_ptr(),
            *_launch_args(g, C), block[0], block[1], hx, hy, int(want_value),
            stream)
    cuda_build.check(lib, status, "tsc_gather_grads_window")
    tsc_gather_grads_window.launches += 1
    return out


tsc_gather_grads_window.launches = 0
