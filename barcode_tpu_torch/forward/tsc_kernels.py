"""Windowed TSC deposits (K1, K1s, K3) and gradient gathers (K2, K4):
kernels + plain versions.

Port of barcode_tpu/forward/pallas_deposit.py.  The TPU kernels there
compute TSC with a *window* rule that the port must reproduce, because it
decides what a particle that breaks the halo contract contributes:

  * K1 `tsc_deposit_window` (TPU: `tsc_deposit_pallas`, both of its
    bodies): each (BX, BY) output block sums only the particles of its
    Lagrangian window [I*BX - hx, I*BX + BX + hx) x [J*BY - hy, ...), x/y
    wrapping through +-N copies of the particle grid.  A violator deposits
    PARTIAL mass.  Effective halos: hx rounded by `_round_halo(hx, BX)`, hy
    tight.  K1s, the TPU's streamed body (`stream=True`), computes the same
    function; it exists only for the TPU's VMEM budget, so the argument is
    kept for parity with the JAX API and selects nothing on the card.
  * K2 `tsc_gather_grads_window` (TPU: `tsc_gather_grads_pallas`): the TSC
    value and three position derivatives (divided by the cell size) of a
    field, counting only taps inside the field window of the particle's
    own (BX, BY) block.  Effective halos: hy rounded by `_round_halo`, hx
    tight.
  * K3 `tsc_deposit_slab` and K4 `tsc_gather_grads_slab` (TPU:
    `tsc_deposit_pallas_slab`, both of its bodies, and
    `tsc_gather_grads_pallas_slab`): the same deposit and gather for one
    x-slab of particles of the sharded forward model, into and from an
    extended buffer [h + n1_loc + h, N2, N3] whose x margins the ring
    exchange folds into the neighbouring slabs (parallel/sharded_forward).

Each wrapper takes a CPU tensor to its plain PyTorch version, written with
the same window semantics (the tests hold these against the Pallas kernels
in interpret mode), and a CUDA tensor to its hand-written CUDA kernel.
Both deposits launch one shared-memory kernel, `csrc/tsc_deposit_tiled.cu`,
and both gathers another, `csrc/tsc_gather_tiled.cu`, each in its dense or
its slab geometry.  There is no fallback: a CUDA tensor launches the kernel
or raises.  Each kernel's launches are counted on its launcher:
`tsc_deposit_window` (K1), `tsc_gather_grads_window` (K2),
`tsc_deposit_slab` (K3) and `tsc_gather_grads_slab` (K4) count their
float32 launches in `launches` and their bf16 ones in `launches_bf16`.

`bf16=True` is the TPU kernels' `bf16` option (input.par's
`pallas_bf16_dep` for the deposits, `pallas_bf16_grad` for the gathers):
the deposit rounds each tap's x-y weight and its z weight times the mass to
bfloat16 and multiplies them in float32 (pallas_deposit.py:230-233); the
gather rounds the field's taps, the z weights and their derivatives to
bfloat16 before the z contraction, and keeps float32 after it (the z-first
body, pallas_deposit.py:349, :398-401).  Every such product is exact in
float32, so only the float32 sums differ from the TPU's.

Positions are (3,) + grid or (C, 3) + grid for C chains (one launch covers
all chains); weights and fields are grid or (C,) + grid.

The halo helpers (`deposit_violations`, `displacement_bound_cells`,
`displacement_halo_quantile`) and the block and stream gates
(`deposit_working_set_bytes`, used by `assign.auto_block_dep` so both
packages pick the same windows, and `stream_selected`, kept for parity with
the JAX package) are ported alongside.
"""
from __future__ import annotations

import dataclasses
import math

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
    DEP_VMEM_BUDGET.  Kept for parity with the JAX API: on the card every
    deposit takes the tiled kernel, whatever this says."""
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


def contract_config(fc):
    """The forward configuration whose particle positions the x/y halo
    contract is measured on.  Plane-parallel RSD moves z only, so it is
    dropped, as the JAX package drops every RSD (pallas_deposit.py:599).
    Radial RSD moves x and y too, so it is kept: without it the quantile
    halo and the violation monitor miss the RSD shift, and the tail
    overflows unwarned."""
    if fc.rsd and not fc.rsd_planepar:
        return fc
    return dataclasses.replace(fc, rsd=False)


def _offset_histogram(delta, g: GridSpec, fc, gp):
    """bincount of max(|x off|, |y off|) cells of the particle map for
    `delta` (positions of `contract_config`), pallas_deposit.py:591-620.
    Over the full min-image range, so nothing is dropped."""
    import numpy as np

    from barcode_tpu_torch.forward.lag2eul import displaced_positions

    with torch.no_grad():
        pos = displaced_positions(delta, g, contract_config(fc), gp)
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


def _bf16(x):
    """x rounded to bfloat16 (round to nearest even), back in float32."""
    return x.to(torch.bfloat16).to(x.dtype)


def _tap_weights(wx, fy, my, fz, oy, weights, bf16: bool):
    """The three z taps' weights of one (x, y) offset pair of a deposit:
    wx * wy * wz [* weight] in float32, or with `bf16` bf16(wx * wy) *
    bf16(wz * weight) (pallas_deposit.py:230-233)."""
    wxy = wx * (_tsc_w(fy, oy) * my)
    if not bf16:
        return [wxy * _tsc_w(fz, oz) if weights is None
                else wxy * _tsc_w(fz, oz) * weights for oz in _OFFSETS]
    wxy = _bf16(wxy)
    return [wxy * _bf16(_tsc_w(fz, oz) if weights is None
                        else _tsc_w(fz, oz) * weights) for oz in _OFFSETS]


def tsc_deposit_window_plain(pos, g: GridSpec, halo=4, block=(8, 8),
                             weights=None, bf16: bool = False):
    """Plain PyTorch version of K1: 27 `index_add_` passes with the deposit
    window masks (effective halos as the TPU kernel's); `bf16` rounds the
    tap weights as the TPU's bf16 option."""
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
            ws = _tap_weights(wx, fy, my, fz, oy, weights, bf16)
            for k, w in enumerate(ws):
                idx = c0 + (tx * g.N2 + ty) * g.N3 + Z[k]
                flat.index_add_(0, idx.reshape(-1), w.reshape(-1))
    return out


def _gather_sums(flat, X, Y, Z, fracs, c0, g: GridSpec, want_value: bool,
                 bf16: bool):
    """The gathers' arithmetic over their masked taps: per (x, y) offset
    the z sums of the value and the z derivative, then the x-y weights, the
    derivatives divided by the cell size.  `X` holds (row target, mask)
    pairs.  With `bf16` the
    taps and the z weights and derivatives are rounded to bfloat16 first
    (pallas_deposit.py:349, :398-401)."""
    fx, fy, fz = fracs
    w = [{s: _tsc_w(f, s) for s in _OFFSETS} for f in (fx, fy, fz)]
    dw = [{s: _tsc_dw(f, s) for s in _OFFSETS} for f in (fx, fy, fz)]
    if bf16:
        w[2] = {s: _bf16(v) for s, v in w[2].items()}
        dw[2] = {s: _bf16(v) for s, v in dw[2].items()}
    val = gx = gy = gz = 0.0
    for a, ox in enumerate(_OFFSETS):
        tx, mx = X[a]
        for b, oy in enumerate(_OFFSETS):
            ty, my = Y[b]
            row = c0 + (tx * g.N2 + ty) * g.N3
            m = (mx & my).to(flat.dtype)
            s = sd = 0.0
            for k, oz in enumerate(_OFFSETS):
                v = flat[row + Z[k]]
                v = (_bf16(v) if bf16 else v) * m
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


def tsc_gather_grads_window_plain(field, pos, g: GridSpec, halo=4,
                                  block=(8, 8), want_value=True,
                                  bf16: bool = False):
    """Plain PyTorch version of K2: value (optional) and the three position
    derivatives, divided by the cell size, over the gather window taps;
    `bf16` rounds as the TPU's bf16 option."""
    hx, hy = _halo_pair(halo)
    hy = _round_halo(hy, block[1])
    X, Y, Z, fracs = _taps(pos, g, _gather_axis, block, hx, hy)
    return _gather_sums(field.reshape(-1), X, Y, Z, fracs,
                        _chain_offsets(pos, g), g, want_value, bf16)


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


def _fixed_point_scale(weights, max_sum_per_weight: float, device):
    """K1's fixed-point scale 2^e, a float64 scalar on the device (no host
    sync): the largest power of two with max_sum_per_weight * max|w| * 2^e
    <= 2^62 over the finite weights, so no cell's 64-bit sum can overflow
    (for TSC, whose taps of one particle sum to 1, max_sum_per_weight is
    the particle count of a chain); 1 when every weight is 0.  (Non-finite
    weights make their chain NaN.)"""
    if weights is None:
        wmax = torch.ones((), dtype=torch.float64, device=device)
    else:  # max |w| over the finite weights, in two passes
        wmax = torch.linalg.vector_norm(
            torch.nan_to_num(weights, nan=0.0, posinf=0.0, neginf=0.0),
            float("inf")).double()
    e = torch.floor(62.0 - torch.log2(wmax * max_sum_per_weight))
    e = torch.where(wmax > 0, e, torch.zeros_like(e)).clamp(-1000.0, 1000.0)
    return torch.exp2(e)


# The tiled deposit (csrc/tsc_deposit_tiled.cu, whose THREADS and TX, TY, TZ
# these mirror): one block of TILED_THREADS threads takes a Lagrangian tile of
# TILED_TILE particles of one chain (ragged at the grid's edges) and
# accumulates its taps in an int64 box of at most TILED_BOX_CELLS cells of
# shared memory (108 KB, so two blocks share an SM's 228 KB); taps outside
# the box go straight to the global accumulator.
TILED_TILE = (16, 16, 16)
TILED_THREADS = 512
TILED_BOX_CELLS = 13824
SM_SHARED_BYTES = 228 * 1024  # an H100 SM's shared memory
BLOCK_SHARED_MAX = 227 * 1024  # what one block may use
BLOCK_SHARED_RESERVED = 1024  # the runtime's share of each resident block
# the kernel's static shared memory (per-warp min, max, sum and count, the
# box's origin and extents: 864 bytes in ptxas's report), rounded up
STATIC_SHARED_BYTES = 1024


@dataclasses.dataclass(frozen=True)
class TiledPlan:
    """The tiled deposit's launch: particle tile (x, y, z) of one block,
    threads per block, box cells, dynamic shared-memory bytes and the grid
    (tiles, chains)."""
    tile: tuple
    threads: int
    box_cells: int
    smem_bytes: int
    grid: tuple

    @property
    def blocks_per_sm(self) -> int:
        """Blocks that fit one SM's shared memory at once."""
        return SM_SHARED_BYTES // (self.smem_bytes + STATIC_SHARED_BYTES
                                   + BLOCK_SHARED_RESERVED)


def tiled_plan(rows: int, n2: int, n3: int, chains: int) -> TiledPlan:
    """The tiled deposit's launch for a particle grid of rows x n2 x n3
    (N1 dense, n1_loc for a slab) and `chains` chains."""
    tiles = math.prod(-(-n // t) for t, n in zip(TILED_TILE, (rows, n2, n3)))
    return TiledPlan(TILED_TILE, TILED_THREADS, TILED_BOX_CELLS,
                     8 * TILED_BOX_CELLS, (tiles, chains))


# The tiled gather (csrc/tsc_gather_tiled.cu, whose THREADS and TX, TY, TZ
# these mirror): one block of GATHER_THREADS threads takes a Lagrangian tile
# of GATHER_TILE particles of one chain and stages the field cells its
# particles' stencils read in a float32 box of at most GATHER_BOX_CELLS
# cells (54 KB) of shared memory, beside the tile's positions (48 KB) and
# the list of its particles whose stencil leaves the box (8 KB), which read
# device memory.  The kernel's launch bound asks for GATHER_BLOCKS blocks an
# SM (at most 64 registers a thread).
GATHER_TILE = (16, 16, 16)
GATHER_THREADS = 512
GATHER_BOX_CELLS = 13824
GATHER_BLOCKS = 2
SM_THREADS = 2048  # an H100 SM's resident threads


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """The tiled gather's launch: particle tile (x, y, z) of one block,
    threads per block, box cells, dynamic shared-memory bytes and the grid
    (tiles, chains)."""
    tile: tuple
    threads: int
    box_cells: int
    smem_bytes: int
    grid: tuple

    @property
    def blocks_per_sm(self) -> int:
        """Blocks resident on one SM: as many as its shared memory and
        threads hold, at most the launch bound's."""
        by_smem = SM_SHARED_BYTES // (self.smem_bytes + STATIC_SHARED_BYTES
                                      + BLOCK_SHARED_RESERVED)
        return min(by_smem, SM_THREADS // self.threads, GATHER_BLOCKS)


def gather_plan(rows: int, n2: int, n3: int, chains: int) -> GatherPlan:
    """The tiled gather's launch for a particle grid of rows x n2 x n3 (N1
    dense, n1_loc for a slab) and `chains` chains."""
    tiles = math.prod(-(-n // t) for t, n in zip(GATHER_TILE, (rows, n2, n3)))
    per_tile = math.prod(GATHER_TILE)
    smem = 4 * GATHER_BOX_CELLS + 12 * per_tile + 2 * per_tile
    return GatherPlan(GATHER_TILE, GATHER_THREADS, GATHER_BOX_CELLS, smem,
                      (tiles, chains))


def _count(wrapper, bf16: bool):
    """One launch on `wrapper`'s float32 or bf16 counter."""
    if bf16:
        wrapper.launches_bf16 += 1
    else:
        wrapper.launches += 1


def _deposit_tiled(pos, weights, g: GridSpec, rows: int, out_rows: int,
                   start: int, block: tuple, hx: int, hy: int, slab: bool,
                   bf16: bool):
    """Launches csrc/tsc_deposit_tiled.cu; returns (library, status,
    output) for the caller to check and count."""
    from barcode_tpu_torch import cuda_build

    lib, _ = cuda_build.load()
    batch = tuple(pos.shape[:-4])
    C = batch[0] if batch else 1
    plan = tiled_plan(rows, g.N2, g.N3, C)
    shape = batch + (out_rows, g.N2, g.N3)
    scale = _fixed_point_scale(weights, rows * g.N2 * g.N3, pos.device)
    acc = torch.zeros(shape, dtype=torch.int64, device=pos.device)
    bad = torch.zeros(C, dtype=torch.int32, device=pos.device)
    out = torch.empty(shape, dtype=torch.float32, device=pos.device)
    d1, d2, d3 = g.cell
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.tsc_deposit_tiled_launch(
            pos.data_ptr(), weights.data_ptr() if weights is not None else None,
            scale.data_ptr(), acc.data_ptr(), bad.data_ptr(), out.data_ptr(),
            C, rows, g.N1, g.N2, g.N3, d1, d2, d3, start, block[0], block[1],
            hx, hy, int(slab), int(bf16), plan.box_cells, stream)
    return lib, status, out


def tsc_deposit_window(pos, g: GridSpec, halo=4, block=(8, 8), weights=None,
                       stream=None, bf16: bool = False):
    """K1: windowed TSC deposit (TPU: pallas_deposit.tsc_deposit_pallas).

    `halo` is the requested contract (int or (hx, hy)); hx is rounded as
    on the TPU.  `stream` is the JAX argument that picks the TPU's streamed
    body (K1s); the two bodies compute one function, so it selects nothing
    here.  `bf16`: the TPU's bf16 tap weights.  Returns grid or (C,) + grid
    float32.

    CPU tensors take the plain version, `tsc_deposit_window_plain`, for
    every `stream`: the JAX package's tests hold both TPU bodies against
    one reference (tests/test_pallas_deposit.py:173-195).  CUDA tensors
    launch csrc/tsc_deposit_tiled.cu."""
    hx, hy = _halo_pair(halo)
    hx = _round_halo(hx, block[0])
    _check_positions(pos, g, hx, hy, block)
    if pos.device.type == "cpu":
        return tsc_deposit_window_plain(pos, g, (hx, hy), block, weights,
                                        bf16)
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    batch = tuple(pos.shape[:-4])
    _check_tensor("pos", pos, pos.shape, pos.device)
    if weights is not None:
        _check_tensor("weights", weights, batch + g.shape, pos.device)
    from barcode_tpu_torch import cuda_build

    lib, status, rho = _deposit_tiled(pos, weights, g, g.N1, g.N1, 0, block,
                                      hx, hy, slab=False, bf16=bf16)
    cuda_build.check(lib, status, "tsc_deposit_window")
    _count(tsc_deposit_window, bf16)
    return rho


tsc_deposit_window.launches = 0
tsc_deposit_window.launches_bf16 = 0


def _gather_tiled(field, pos, g: GridSpec, rows: int, start: int,
                  block: tuple, hx: int, hy: int, slab: bool,
                  want_value: bool, bf16: bool = False, taps=None):
    """Launches csrc/tsc_gather_tiled.cu on checked inputs (`taps`: None or
    two zeroed int64 counters on the device); returns (library, status,
    output) for the caller to check and count."""
    from barcode_tpu_torch import cuda_build

    lib, _ = cuda_build.load()
    batch = tuple(pos.shape[:-4])
    C = batch[0] if batch else 1
    plan = gather_plan(rows, g.N2, g.N3, C)
    nch = 4 if want_value else 3
    out = torch.empty(batch + (nch, rows, g.N2, g.N3), dtype=torch.float32,
                      device=pos.device)
    d1, d2, d3 = g.cell
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.tsc_gather_tiled_launch(
            field.data_ptr(), pos.data_ptr(), out.data_ptr(),
            taps.data_ptr() if taps is not None else None, C, rows, g.N1,
            g.N2, g.N3, d1, d2, d3, start, block[0], block[1], hx, hy,
            int(slab), int(bf16), int(want_value), plan.box_cells, stream)
    return lib, status, out


def tsc_gather_grads_window(field, pos, g: GridSpec, halo=4, block=(8, 8),
                            want_value=True, bf16: bool = False):
    """K2: windowed TSC value + position-gradient gather (TPU:
    pallas_deposit.tsc_gather_grads_pallas).

    Returns batch + (4|3,) + grid float32: [value,] d/dx, d/dy, d/dz per
    physical position.  hy is rounded as on the TPU.  `bf16`: the TPU's
    bf16 z contraction.  CPU tensors take the plain version; CUDA tensors
    launch csrc/tsc_gather_tiled.cu."""
    hx, hy = _halo_pair(halo)
    hy = _round_halo(hy, block[1])
    _check_positions(pos, g, hx, hy, block)
    if pos.device.type == "cpu":
        return tsc_gather_grads_window_plain(field, pos, g, (hx, hy), block,
                                             want_value, bf16)
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    from barcode_tpu_torch import cuda_build

    batch = tuple(pos.shape[:-4])
    _check_tensor("pos", pos, pos.shape, pos.device)
    _check_tensor("field", field, batch + g.shape, pos.device)
    lib, status, out = _gather_tiled(field, pos, g, g.N1, 0, block, hx, hy,
                                     False, want_value, bf16)
    cuda_build.check(lib, status, "tsc_gather_grads_window")
    _count(tsc_gather_grads_window, bf16)
    return out


tsc_gather_grads_window.launches = 0
tsc_gather_grads_window.launches_bf16 = 0


# ---------------------------------------------------------------------------
# Slab variants (K3, K4): the sharded forward model's deposit and gather
# ---------------------------------------------------------------------------

def _slab_channels(pos, g: GridSpec, n1_loc: int, dev: int, weights=None):
    """Per-particle channels of one x-slab (pallas_deposit.py:651-672):
    bx in slab-local unwrapped coordinates (own row + min-image offset; may
    be negative or beyond n1_loc near the edges), by unwrapped to its own
    row, bz wrapped, the fractions, then the optional weight.  `dev` is the
    slab's index along the 'grid' axis.  Returns (6|7,) + slab or
    batch + (6|7,) + slab, float32 as on the TPU."""
    u = pos / _cell(g, pos)
    base = torch.floor(u)
    frac = u - base - 0.5
    qx = torch.arange(n1_loc, dtype=pos.dtype, device=pos.device)[:, None, None]
    qy = torch.arange(g.N2, dtype=pos.dtype, device=pos.device)[None, :, None]
    b0, b1, b2 = base.unbind(-4)
    offx = torch.remainder(b0 - (dev * n1_loc + qx) + g.N1 / 2.0,
                           g.N1) - g.N1 / 2.0
    offy = torch.remainder(b1 - qy + g.N2 / 2.0, g.N2) - g.N2 / 2.0
    chans = [qx + offx, qy + offy, torch.remainder(b2, g.N3), *frac.unbind(-4)]
    if weights is not None:
        chans.append(weights.to(torch.float32))
    return torch.stack([c.to(torch.float32).expand(frac.shape[:-4]
                                                   + frac.shape[-3:])
                        for c in chans], dim=-4)


def _slab_taps(pos, g: GridSpec, n1_loc: int, dev: int):
    """Integer slab-local bases (bx, by, bz), the fractions, and the local
    row and y index grids of a slab of particles."""
    ch = _slab_channels(pos, g, n1_loc, dev)
    bx, by, bz = (ch.select(-4, a).long() for a in range(3))
    r = torch.arange(n1_loc, device=pos.device)[:, None, None]
    iy = torch.arange(g.N2, device=pos.device)[None, :, None]
    return bx, by, bz, tuple(ch.select(-4, a) for a in (3, 4, 5)), r, iy


def tsc_deposit_slab_plain(pos, g: GridSpec, n1_loc: int, dev: int, halo: int,
                           block=(8, 8), weights=None, bf16: bool = False):
    """Plain PyTorch version of K3: the slab's TSC deposit into its extended
    buffer (batch + (n1_loc + 2*halo, N2, N3)) under the slab deposit window
    rules, 27 `index_add_` passes: extended rows [0, n1_loc + 2h), the
    particle's row unwrapped to the slab and shifted by +h, the block window
    in extended rows, taps outside the buffer dropped; y as K1, z wrapped.
    `bf16` rounds the tap weights as the TPU's bf16 option."""
    h = int(halo)
    BX, BY = block
    n1_ext = n1_loc + 2 * h
    bx, by, bz, (fx, fy, fz), r, iy = _slab_taps(pos, g, n1_loc, dev)
    q = r + h
    batch = tuple(pos.shape[:-4])
    out = torch.zeros(batch + (n1_ext, g.N2, g.N3), dtype=pos.dtype,
                      device=pos.device)
    flat = out.reshape(-1)
    c0 = 0
    if batch:
        c0 = (torch.arange(batch[0], device=pos.device)
              * (n1_ext * g.N2 * g.N3)).reshape(-1, 1, 1, 1)
    X = []
    for o in _OFFSETS:
        t = bx + h + o
        lo = torch.div(t.clamp(min=0), BX, rounding_mode="floor") * BX - h
        X.append((t.clamp(0, n1_ext - 1),
                  (t >= 0) & (t < n1_ext) & (q >= lo) & (q < lo + BX + 2 * h)))
    Y = [_deposit_axis(by, iy, g.N2, BY, h, o) for o in _OFFSETS]
    Z = [torch.remainder(bz + o, g.N3) for o in _OFFSETS]
    for a, ox in enumerate(_OFFSETS):
        tx, mx = X[a]
        wx = _tsc_w(fx, ox) * mx
        for b, oy in enumerate(_OFFSETS):
            ty, my = Y[b]
            ws = _tap_weights(wx, fy, my, fz, oy, weights, bf16)
            for k, w in enumerate(ws):
                idx = c0 + (tx * g.N2 + ty) * g.N3 + Z[k]
                flat.index_add_(0, idx.reshape(-1), w.reshape(-1))
    return out


def tsc_gather_grads_slab_plain(ext_field, pos, g: GridSpec, n1_loc: int,
                                dev: int, halo: int, block=(8, 8),
                                want_value=True, bf16: bool = False):
    """Plain PyTorch version of K4: value (optional) and the three position
    derivatives, divided by the cell size, of the extended-slab field under
    the slab gather window rules (the window around the particle's block
    in slab rows, the tap reading extended row X + h; nothing wraps in x);
    `bf16` rounds as the TPU's bf16 option."""
    h = int(halo)
    BX, BY = block
    n1_ext = n1_loc + 2 * h
    bx, by, bz, fracs, r, iy = _slab_taps(pos, g, n1_loc, dev)
    lo = torch.div(r, BX, rounding_mode="floor") * BX - h
    X = [((bx + o + h).clamp(0, n1_ext - 1),
          (bx + o >= lo) & (bx + o < lo + BX + 2 * h)) for o in _OFFSETS]
    Y = [_gather_axis(by, iy, g.N2, BY, h, o) for o in _OFFSETS]
    Z = [torch.remainder(bz + o, g.N3) for o in _OFFSETS]
    c0 = 0
    if pos.dim() == 5:
        c0 = (torch.arange(pos.shape[0], device=pos.device)
              * (n1_ext * g.N2 * g.N3)).reshape(-1, 1, 1, 1)
    return _gather_sums(ext_field.reshape(-1), X, Y, Z, fracs, c0, g,
                        want_value, bf16)


def _check_slab(pos, g: GridSpec, n1_loc: int, dev: int, halo: int, block,
                rows: int):
    """The TPU kernels' slab contract (pallas_deposit.py:688-690, 752-753):
    halo a positive multiple of 4, `rows` (the extended or the local rows)
    and N2 divisible by the block."""
    if pos.dim() not in (4, 5) or \
            tuple(pos.shape[-4:]) != (3, n1_loc, g.N2, g.N3):
        raise ValueError(f"pos must be (3, n1_loc, N2, N3) or (C, 3, n1_loc, "
                         f"N2, N3) with n1_loc={n1_loc}, got "
                         f"{tuple(pos.shape)}")
    if g.N1 % n1_loc or not 0 <= dev < g.N1 // n1_loc:
        raise ValueError(f"slab {dev} of width {n1_loc} is not a slab of "
                         f"N1={g.N1}")
    if halo <= 0 or halo % 4:
        raise ValueError(f"slab halo must be a positive multiple of 4, got "
                         f"{halo}")
    BX, BY = block
    if rows % BX or g.N2 % BY:
        raise ValueError(f"block {block} does not tile ({rows}, {g.N2})")


def tsc_deposit_slab(pos, g: GridSpec, n1_loc: int, dev: int, halo: int,
                     block=(8, 8), weights=None, bf16: bool = False):
    """K3: TSC deposit of slab `dev`'s particles into its extended buffer
    (TPU: pallas_deposit.tsc_deposit_pallas_slab, both of its bodies).

    pos is (3, n1_loc, N2, N3) or (C, 3, n1_loc, N2, N3) for C chains (one
    launch covers all); weights batch + (n1_loc, N2, N3).  `bf16`: the
    TPU's bf16 tap weights.  Returns batch + (n1_loc + 2*halo, N2, N3)
    float32.  CPU tensors take the plain version; CUDA tensors launch
    csrc/tsc_deposit_tiled.cu in its slab geometry."""
    block = tuple(block)
    _check_slab(pos, g, n1_loc, dev, halo, block, n1_loc + 2 * halo)
    if pos.device.type == "cpu":
        return tsc_deposit_slab_plain(pos, g, n1_loc, dev, halo, block,
                                      weights, bf16)
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    batch = tuple(pos.shape[:-4])
    _check_tensor("pos", pos, pos.shape, pos.device)
    if weights is not None:
        _check_tensor("weights", weights, batch + (n1_loc, g.N2, g.N3),
                      pos.device)
    from barcode_tpu_torch import cuda_build

    lib, status, out = _deposit_tiled(pos, weights, g, n1_loc,
                                      n1_loc + 2 * halo, dev * n1_loc, block,
                                      halo, halo, slab=True, bf16=bf16)
    cuda_build.check(lib, status, "tsc_deposit_slab")
    _count(tsc_deposit_slab, bf16)
    return out


tsc_deposit_slab.launches = 0
tsc_deposit_slab.launches_bf16 = 0


def tsc_gather_grads_slab(ext_field, pos, g: GridSpec, n1_loc: int, dev: int,
                          halo: int, block=(8, 8), want_value=True,
                          bf16: bool = False):
    """K4: value + position-gradient gather of an extended-slab field at
    slab `dev`'s particles, the exact adjoint of K3 (TPU:
    pallas_deposit.tsc_gather_grads_pallas_slab).

    Returns batch + (4|3, n1_loc, N2, N3) float32: [value,] d/dx, d/dy,
    d/dz per physical position.  `bf16`: the TPU's bf16 z contraction.  CPU
    tensors take the plain version; CUDA tensors launch
    csrc/tsc_gather_tiled.cu in its slab geometry."""
    block = tuple(block)
    _check_slab(pos, g, n1_loc, dev, halo, block, n1_loc)
    if pos.device.type == "cpu":
        return tsc_gather_grads_slab_plain(ext_field, pos, g, n1_loc, dev,
                                           halo, block, want_value, bf16)
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    from barcode_tpu_torch import cuda_build

    batch = tuple(pos.shape[:-4])
    _check_tensor("pos", pos, pos.shape, pos.device)
    _check_tensor("ext_field", ext_field,
                  batch + (n1_loc + 2 * halo, g.N2, g.N3), pos.device)
    lib, status, out = _gather_tiled(ext_field, pos, g, n1_loc, dev * n1_loc,
                                     block, halo, halo, True, want_value,
                                     bf16)
    cuda_build.check(lib, status, "tsc_gather_grads_slab")
    _count(tsc_gather_grads_slab, bf16)
    return out


tsc_gather_grads_slab.launches = 0
tsc_gather_grads_slab.launches_bf16 = 0


def gather_taps_outside_box(field, pos, g: GridSpec, halo, block,
                            slab=None):
    """The tiled gather's taps inside the windows that read device memory
    (their particle's stencil leaves its tile's box), and all its taps
    inside the windows, counted by one launch on CUDA tensors (want_value
    False).  `slab` is None (K2: `halo` and `block` as
    tsc_gather_grads_window takes them) or (n1_loc, dev) (K4, `halo` the
    slab's).  The launch counts on its wrapper's counter."""
    from barcode_tpu_torch import cuda_build

    if pos.device.type != "cuda":
        raise ValueError("the tiled gather's taps are counted on the card "
                         f"only, not on {pos.device}")
    block = tuple(block)
    if slab is None:
        hx, hy = _halo_pair(halo)
        hy = _round_halo(hy, block[1])
        _check_positions(pos, g, hx, hy, block)
        rows, start, wrapper, shape = g.N1, 0, tsc_gather_grads_window, g.shape
    else:
        n1_loc, dev = slab
        _check_slab(pos, g, n1_loc, dev, halo, block, n1_loc)
        hx = hy = halo
        rows, start, wrapper = n1_loc, dev * n1_loc, tsc_gather_grads_slab
        shape = (n1_loc + 2 * halo, g.N2, g.N3)
    _check_tensor("pos", pos, pos.shape, pos.device)
    _check_tensor("field", field, tuple(pos.shape[:-4]) + shape, pos.device)
    taps = torch.zeros(2, dtype=torch.int64, device=pos.device)
    lib, status, _ = _gather_tiled(field, pos, g, rows, start, block, hx, hy,
                                   slab is not None, False, taps=taps)
    cuda_build.check(lib, status, "gather_taps_outside_box")
    wrapper.launches += 1
    outside, total = taps.tolist()
    return outside, total
