"""The tiled gather's host side: its launch plan, its routing on the CPU,
and the build report it is checked by.

The kernel itself (csrc/tsc_gather_tiled.cu) runs only on the card, where
tests/test_torch_cuda.py (marked `gpu`) and chip_smoke.py hold it against
the plain versions and against its own earlier calls bit for bit.  Here
both gathers must take their plain versions for every `bf16` and count no
launch; the plain versions themselves are held against the Pallas kernels
by tests/test_torch_tsc_kernels.py, test_torch_slab_kernels.py and
test_torch_bf16.py.
"""
import re

import numpy as np
import pytest
import torch

from barcode_tpu_torch import cuda_build
from barcode_tpu_torch.forward import tsc_kernels as tk
from barcode_tpu_torch.grid.spec import GridSpec

G = GridSpec.cube(16, 25.0)
GATHERS = (tk.tsc_gather_grads_window, tk.tsc_gather_grads_slab)


def launch_counts():
    return {(f.__name__, attr): getattr(f, attr) for f in GATHERS
            for attr in ("launches", "launches_bf16")}


def positions(g, seed, chains=2, jitter=1.5):
    rng = np.random.default_rng(seed)
    d = np.asarray(g.cell).reshape(3, 1, 1, 1)
    idx = np.stack(np.meshgrid(*[np.arange(n) for n in g.shape],
                               indexing="ij")).astype(np.float64)
    L = np.asarray([g.L1, g.L2, g.L3]).reshape(3, 1, 1, 1)
    pos = [(idx + 0.5) * d + jitter * d * rng.standard_normal((3,) + g.shape)
           for _ in range(chains)]
    return torch.from_numpy(np.mod(np.stack(pos), L).astype(np.float32))


# (particle rows, N2, N3, chains): 32^3, ragged 48^3, the 128^3 headline,
# 256^3 with 2 chains, the 256^3 one-rank slab, slab 0 of 2 at 256^3, and
# the 8-row slabs of 32^3 on 4 slabs
PLAN_SHAPES = [(32, 32, 32, 2), (48, 48, 48, 2), (128, 128, 128, 2),
               (256, 256, 256, 2), (256, 256, 256, 1), (128, 256, 256, 1),
               (8, 32, 32, 2)]


@pytest.mark.parametrize("rows,n2,n3,chains", PLAN_SHAPES)
def test_gather_plan_fits_its_blocks_an_sm(rows, n2, n3, chains):
    """Every tile is covered once; the box, the tile's positions and its
    list of far particles fit the launch bound's two blocks an SM; the
    box's cells stay below 2^16 (the fill's exact division) and a multiple
    of 4 (the positions behind it take 16-byte copies); each thread takes
    a whole number of particles and of 16-byte position chunks."""
    plan = tk.gather_plan(rows, n2, n3, chains)
    tx, ty, tz = plan.tile
    tile = tx * ty * tz
    assert plan.grid == (-(-rows // tx) * -(-n2 // ty) * -(-n3 // tz), chains)
    assert plan.grid[0] * tile >= rows * n2 * n3
    assert plan.grid[0] < 2**31 and plan.grid[1] <= 65535
    assert tile % plan.threads == 0 and plan.threads % 32 == 0
    assert (3 * tile // 4) % plan.threads == 0
    assert plan.smem_bytes == 4 * plan.box_cells + 12 * tile + 2 * tile
    assert plan.smem_bytes + tk.STATIC_SHARED_BYTES <= tk.BLOCK_SHARED_MAX
    assert plan.blocks_per_sm == tk.GATHER_BLOCKS == 2
    assert plan.box_cells < 2**16 and plan.box_cells % 4 == 0
    # the box holds a tile's 3-cell-wider stencil with room for spread
    assert plan.box_cells >= (tx + 2) * (ty + 2) * (tz + 2 + 6)


def test_gather_plan_mirrors_the_kernel_source():
    """The plan's threads, tile and blocks an SM are the kernel's
    compile-time ones, and the build knows the source and its header."""
    src = (cuda_build.CSRC / "tsc_gather_tiled.cu").read_text()
    threads = int(re.search(r"constexpr int THREADS = (\d+);", src).group(1))
    tile = tuple(int(v) for v in re.search(
        r"constexpr int TX = (\d+), TY = (\d+), TZ = (\d+);", src).groups())
    blocks = int(re.search(r"__launch_bounds__\(THREADS, (\d+)\)",
                           src).group(1))
    assert (threads, tile, blocks) == (tk.GATHER_THREADS, tk.GATHER_TILE,
                                       tk.GATHER_BLOCKS)
    assert "tsc_gather_tiled.cu" in cuda_build.SOURCES
    assert "tsc_tiled.cuh" in cuda_build.HEADERS
    assert len(cuda_build.SIGNATURES["tsc_gather_tiled_launch"]) == 22


@pytest.mark.parametrize("bf16", [False, True])
def test_cpu_gathers_are_plain_for_every_choice(bf16):
    """On the CPU, K2 and K4 are their plain versions for every `bf16`,
    with and without the value, and no counter moves."""
    gen = torch.Generator().manual_seed(7)
    pos = positions(G, 1)
    field = torch.randn((2,) + G.shape, generator=gen)
    ext = torch.randn((2, 16, 16, 16), generator=gen)
    n0 = launch_counts()
    for want_value in (False, True):
        assert torch.equal(
            tk.tsc_gather_grads_window(field, pos, G, 3, (8, 8), want_value,
                                       bf16=bf16),
            tk.tsc_gather_grads_window_plain(field, pos, G, 3, (8, 8),
                                             want_value, bf16))
        p = pos[:, :, 8:].contiguous()
        assert torch.equal(
            tk.tsc_gather_grads_slab(ext, p, G, 8, 1, 4, (8, 8), want_value,
                                     bf16=bf16),
            tk.tsc_gather_grads_slab_plain(ext, p, G, 8, 1, 4, (8, 8),
                                           want_value, bf16))
    assert launch_counts() == n0


def test_taps_outside_box_are_counted_on_the_card_only():
    pos = positions(G, 3)
    with pytest.raises(ValueError, match="card"):
        tk.gather_taps_outside_box(torch.zeros((2,) + G.shape), pos, G, 3,
                                   (8, 8))


PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelPf' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelPf
    48 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 864 bytes smem
ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'
ptxas info    : Function properties for _Z5otherv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 26 registers, used 0 barriers
"""


def test_ptxas_report_gives_each_kernels_registers_and_spills():
    """The build report the chip run checks the tiled gather by (no spill
    is allowed there)."""
    assert cuda_build.ptxas_functions(PTXAS) == {
        "_Z6kernelPf": dict(registers=64, stack=48, spill_stores=12,
                            spill_loads=8),
        "_Z5otherv": dict(registers=26, stack=0, spill_stores=0,
                          spill_loads=0)}
