"""The tiled deposit's host side: its launch plan, its routing on the CPU,
and its fixed-point scale.

The kernel itself (csrc/tsc_deposit_tiled.cu) runs only on the card, where
tests/test_torch_cuda.py (marked `gpu`) and chip_smoke.py hold it against
the plain versions and against its own earlier calls bit for bit.  Here
every wrapper must take its plain version, whatever `stream` and `bf16`
say, and count no launch; the plain versions themselves are held against
the Pallas kernels by tests/test_torch_tsc_kernels.py,
test_torch_stream.py, test_torch_slab_kernels.py and test_torch_bf16.py.
"""
import re

import numpy as np
import pytest
import torch

from barcode_tpu_torch import cuda_build
from barcode_tpu_torch.forward import tsc_kernels as tk
from barcode_tpu_torch.grid.spec import GridSpec

G = GridSpec.cube(16, 25.0)


def launch_counts():
    return {(f.__name__, attr): getattr(f, attr) for f in (
        tk.tsc_deposit_window, tk.tsc_deposit_slab,
        tk.tsc_gather_grads_window, tk.tsc_gather_grads_slab)
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
def test_tiled_plan_fits_two_blocks_an_sm(rows, n2, n3, chains):
    """Every tile is covered once, the box fits 110 KB so that two blocks
    share an SM, each thread takes a whole number of particles, and the
    box's cells stay below 2^16 (the flush's exact division)."""
    plan = tk.tiled_plan(rows, n2, n3, chains)
    tx, ty, tz = plan.tile
    assert plan.grid == (-(-rows // tx) * -(-n2 // ty) * -(-n3 // tz), chains)
    assert plan.grid[0] * tx * ty * tz >= rows * n2 * n3
    assert plan.grid[0] < 2**31 and plan.grid[1] <= 65535
    assert (tx * ty * tz) % plan.threads == 0 and plan.threads % 32 == 0
    assert plan.smem_bytes == 8 * plan.box_cells <= 110 * 1024
    assert plan.smem_bytes + tk.STATIC_SHARED_BYTES <= tk.BLOCK_SHARED_MAX
    assert plan.blocks_per_sm == 2
    assert plan.box_cells < 2**16
    # the box holds a tile's 3-cell-wider stencil with room for spread
    assert plan.box_cells >= (tx + 2) * (ty + 2) * (tz + 2)


def test_tiled_plan_mirrors_the_kernel_source():
    """The plan's threads and tile are the kernel's compile-time ones."""
    src = (cuda_build.CSRC / "tsc_deposit_tiled.cu").read_text()
    threads = int(re.search(r"constexpr int THREADS = (\d+);", src).group(1))
    tile = tuple(int(v) for v in re.search(
        r"constexpr int TX = (\d+), TY = (\d+), TZ = (\d+);", src).groups())
    assert (threads, tile) == (tk.TILED_THREADS, tk.TILED_TILE)
    assert "tsc_deposit_tiled.cu" in cuda_build.SOURCES
    assert len(cuda_build.SIGNATURES["tsc_deposit_tiled_launch"]) == 23


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("stream", [None, True, False])
def test_cpu_window_deposit_is_plain_for_every_choice(stream, bf16):
    """On the CPU, K1 is its plain version for every `stream` and `bf16`,
    and no counter moves."""
    pos = positions(G, 1)
    w = torch.rand((2,) + G.shape, generator=torch.Generator().manual_seed(2))
    n0 = launch_counts()
    for weights in (None, w):
        out = tk.tsc_deposit_window(pos, G, 3, (16, 16), weights=weights,
                                    stream=stream, bf16=bf16)
        assert torch.equal(out, tk.tsc_deposit_window_plain(
            pos, G, 3, (16, 16), weights=weights, bf16=bf16))
    assert launch_counts() == n0


@pytest.mark.parametrize("bf16", [False, True])
def test_cpu_slab_deposit_is_plain_for_every_choice(bf16):
    pos = positions(G, 3)[:, :, :8].contiguous()
    w = torch.rand((2, 8, 16, 16), generator=torch.Generator().manual_seed(4))
    n0 = launch_counts()
    for weights in (None, w):
        out = tk.tsc_deposit_slab(pos, G, 8, 1, 4, weights=weights, bf16=bf16)
        assert torch.equal(out, tk.tsc_deposit_slab_plain(
            pos, G, 8, 1, 4, weights=weights, bf16=bf16))
    assert launch_counts() == n0


def _scale_as_before(weights, n):
    """The fixed-point scale in its first form: max |w| over the finite
    weights by isfinite / where / max."""
    finite = torch.isfinite(weights)
    wmax = torch.where(finite, weights.abs(), 0.0).max().double()
    e = torch.floor(62.0 - torch.log2(wmax * n))
    e = torch.where(wmax > 0, e, torch.zeros_like(e)).clamp(-1000.0, 1000.0)
    return torch.exp2(e)


@pytest.mark.parametrize("case", ["plain", "signed", "non_finite", "zeros",
                                  "all_non_finite", "tiny", "huge"])
def test_fixed_point_scale_is_unchanged(case):
    """The scale the kernels and witnesses share keeps its value when
    computed in two passes: the same 2^e for non-finite, signed, zero,
    tiny and huge weights."""
    gen = torch.Generator().manual_seed(6)
    w = torch.rand((2, 8, 8, 8), generator=gen)
    if case == "signed":
        w = w - 0.5
    elif case == "non_finite":
        w[0, 1, 2, 3], w[1, 4, 5, 6], w[1, 0, 0, 0] = (
            float("nan"), float("inf"), -float("inf"))
    elif case == "zeros":
        w = torch.zeros_like(w)
    elif case == "all_non_finite":
        w = torch.full_like(w, float("nan"))
    elif case == "tiny":
        w = w * 1e-30
    elif case == "huge":
        w = w * 3e30
    new = tk._fixed_point_scale(w, 512, torch.device("cpu"))
    assert new.dtype == torch.float64
    assert torch.equal(new, _scale_as_before(w, 512))
