"""The port's CUDA kernels on the card, and their build and device plumbing.

The tests marked `gpu` need a CUDA card and skip without one; this file
imports neither `jax` nor `barcode_tpu`, so on a machine with a card and
no JAX it runs on its own:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Kernel tolerances: 2e-6 * max(1, max|ref|) — K1/K2 sum their taps in
another order than the plain versions (K1 exactly, in 64-bit fixed point;
the plain versions in float32); the window decisions are integer
arithmetic and must agree exactly.  Gradients through the deposit:
3e-5 * max|grad|.  The tiled deposit (csrc/tsc_deposit_tiled.cu) sums in
64-bit fixed point and the tiled gather (csrc/tsc_gather_tiled.cu) writes
each output from one thread, so each is held equal bit for bit to its own
earlier call on the same inputs (`torch.equal`; NaN where the other has
NaN).  The bf16 variants (`bf16=True`) are held to the same anchors
against their bf16 plain versions: their products are exact in float32.
"""
import numpy as np
import pytest
import torch

from barcode_tpu_torch import cuda_build, device
from barcode_tpu_torch.config import HMCConfig, RunConfig
from barcode_tpu_torch.forward import assign
from barcode_tpu_torch.forward import tsc_kernels as tk
from barcode_tpu_torch.forward.lag2eul import ForwardConfig
from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.model.posterior import ModelConfig
from barcode_tpu_torch.runner import Runner

G = GridSpec.cube(32, 50.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def positions(seed, n_viol, chains=2, g=G):
    """Jittered lattice (wrapped) with n_viol violators per chain of a
    halo-3 contract (pushed 4.2 cells in x, -3.6 in y)."""
    rng = np.random.default_rng(seed)
    d = np.asarray(g.cell).reshape(3, 1, 1, 1)
    idx = np.stack(np.meshgrid(*[np.arange(n) for n in g.shape],
                               indexing="ij")).astype(np.float64)
    out = []
    for _ in range(chains):
        pos = (idx + 0.5) * d + 0.8 * d * rng.standard_normal((3,) + g.shape)
        sel = np.zeros(g.N, bool)
        sel[rng.choice(g.N, n_viol, replace=False)] = True
        sel = sel.reshape(g.shape)
        pos[0][sel] += 4.2 * d[0, 0, 0, 0]
        pos[1][sel] -= 3.6 * d[1, 0, 0, 0]
        out.append(np.mod(pos, np.asarray([g.L1, g.L2, g.L3]).reshape(3, 1, 1, 1)))
    return torch.from_numpy(np.stack(out).astype(np.float32))


def assert_close(out, ref, rel=2e-6):
    tol = rel * max(1.0, ref.abs().max().item())
    assert (out - ref).abs().max().item() <= tol


CASES = {
    "contract": dict(halo=6, block_dep=(16, 16), block=(8, 8), n_viol=0),
    "violators": dict(halo=3, block_dep=(16, 16), block=(8, 8), n_viol=200),
    "violators_halo_pair": dict(halo=(3, 2), block_dep=(16, 8),
                                block=(8, 16), n_viol=150),
}


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_deposit_matches_plain(cuda, case, weighted):
    c = CASES[case]
    pos = positions(1, c["n_viol"]).to(cuda)
    w = torch.rand((2,) + G.shape, device=cuda) if weighted else None
    n0 = tk.tsc_deposit_window.launches
    out = tk.tsc_deposit_window(pos, G, c["halo"], c["block_dep"], weights=w)
    torch.cuda.synchronize()
    assert tk.tsc_deposit_window.launches == n0 + 1
    assert_close(out, tk.tsc_deposit_window_plain(pos, G, c["halo"],
                                                  c["block_dep"], weights=w))


@pytest.mark.gpu
@pytest.mark.parametrize("want_value", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_gather_matches_plain(cuda, case, want_value):
    c = CASES[case]
    pos = positions(2, c["n_viol"]).to(cuda)
    field = torch.randn((2,) + G.shape, device=cuda)
    n0 = tk.tsc_gather_grads_window.launches
    out = tk.tsc_gather_grads_window(field, pos, G, c["halo"], c["block"],
                                     want_value)
    torch.cuda.synchronize()
    assert tk.tsc_gather_grads_window.launches == n0 + 1
    assert_close(out, tk.tsc_gather_grads_window_plain(
        field, pos, G, c["halo"], c["block"], want_value))


@pytest.mark.gpu
@pytest.mark.parametrize("tail_k", [0, 1024])
def test_cuda_deposit_function_matches_cpu(cuda, tail_k):
    """The autograd.Function on the card (K1 + K2 + tail) against the same
    function on the CPU (plain versions): density and position gradient."""
    pos = positions(3, 100)
    cot = torch.randn((2,) + G.shape)
    dep = assign.make_tsc_deposit_fast(G, halo=3, tail_k=tail_k)
    out = {}
    for dev in ("cpu", cuda):
        p = pos.to(dev).clone().requires_grad_(True)
        rho = dep(p)
        (rho * cot.to(dev)).sum().backward()
        out[str(dev)] = (rho.detach().cpu(), p.grad.cpu())
    (rho_c, g_c), (rho_d, g_d) = out["cpu"], out[str(cuda)]
    assert_close(rho_d, rho_c)
    assert (g_d - g_c).abs().max().item() <= 3e-5 * g_c.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [1e-7, 1.0, 3e5, 1e16])
def test_cuda_deposit_is_deterministic_at_any_weight_scale(cuda, scale):
    """Fixed-point accumulation: bit-identical repeats, signed weights of any magnitude within tolerance (1e16 makes
    the fixed-point scale 2^e < 1, the tiled kernel's float64 rounding
    path), and NaN for a chain with a non-finite particle (as the float sum
    would make its psi)."""
    pos = positions(6, 50).to(cuda)
    w = scale * torch.randn((2,) + G.shape, device=cuda)
    a = tk.tsc_deposit_window(pos, G, 3, (16, 16), weights=w)
    b = tk.tsc_deposit_window(pos, G, 3, (16, 16), weights=w)
    assert torch.equal(a, b)
    ref = tk.tsc_deposit_window_plain(pos, G, 3, (16, 16), weights=w)
    assert (a - ref).abs().max() <= 2e-6 * ref.abs().max()
    w[1, 3, 4, 5] = float("nan")
    c = tk.tsc_deposit_window(pos, G, 3, (16, 16), weights=w)
    assert torch.isnan(c[1]).all() and torch.equal(c[0], a[0])


STREAM_CASES = {
    # (grid, halo, block, violators): 16^3 and 32^3 with hx 12 have a
    # window wider than the grid (WX = 32 > 16, 40 > 32); the tiled
    # kernel's 16^3 tiles are ragged at 48^3 and its boxes cross the
    # periodic seam everywhere
    "violators": (G, 3, (16, 16), 200),
    "halo_pair": (G, (3, 2), (16, 8), 150),
    "wide_window_32": (G, 12, (16, 16), 200),
    "wide_window_16": (GridSpec.cube(16, 25.0), 6, (16, 16), 60),
    # z tiles of 32 cells: clusters of 4 blocks at 128^3, and of 2 with a
    # ragged last tile (16 cells) at 48^3
    "cluster_128": (GridSpec.cube(128, 200.0), 3, (16, 16), 2000),
    "ragged_48": (GridSpec.cube(48, 75.0), (3, 2), (16, 16), 300),
}


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_cuda_stream_deposit_is_k1(cuda, case, weighted):
    """The tiled K1, which serves stream=True and stream=False alike, within
    2e-6 * max of the plain version and bit-identical from call to call
    (as it was to the earlier K1 and K1s kernels, which it replaced)."""
    g, halo, block, n_viol = STREAM_CASES[case]
    pos = positions(7, n_viol, g=g).to(cuda)
    w = torch.rand((2,) + g.shape, device=cuda) if weighted else None
    n0 = launch_counts()
    out = tk.tsc_deposit_window(pos, g, halo, block, weights=w, stream=True)
    again = tk.tsc_deposit_window(pos, g, halo, block, weights=w, stream=False)
    torch.cuda.synchronize()
    assert launch_counts() == dict(n0, tiled=n0["tiled"] + 2)
    assert torch.equal(out, again)
    assert_close(out, tk.tsc_deposit_window_plain(pos, g, halo, block,
                                                  weights=w))


def launch_counts():
    """The launch counters of K1, float32 and bf16."""
    return {"tiled": tk.tsc_deposit_window.launches,
            "bf16": tk.tsc_deposit_window.launches_bf16}


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
def test_cuda_stream_deposit_marks_a_bad_chain(cuda, bf16):
    """A chain with a non-finite weight or position reads NaN; the other
    chain keeps the bits it has where the bad weight is 0 instead (the
    same fixed-point scale)."""
    pos = positions(8, 50).to(cuda)
    w = torch.rand((2,) + G.shape, device=cuda)
    ok = w.clone()
    ok[0, 5, 6, 7] = 0.0
    w[0, 5, 6, 7] = float("inf")
    out = tk.tsc_deposit_window(pos, G, 3, (16, 16), weights=w, bf16=bf16)
    assert torch.isnan(out[0]).all()
    assert torch.equal(out[1], tk.tsc_deposit_window(
        pos, G, 3, (16, 16), weights=ok, bf16=bf16)[1])
    pos[1, 2, 3, 4, 5] = float("nan")
    out = tk.tsc_deposit_window(pos, G, 3, (16, 16), bf16=bf16)
    assert torch.isnan(out[1]).all() and not torch.isnan(out[0]).any()


def collapsed(pos, g, chain, cells=3, seed=0):
    """Every particle of `chain` piled into a few cells around one point:
    the tiled kernel's hot cells (its shared-memory adds collide)."""
    gen = torch.Generator(device=pos.device).manual_seed(seed)
    d = torch.tensor(g.cell, device=pos.device).reshape(3, 1, 1, 1)
    point = torch.tensor([0.31, 0.52, 0.77], device=pos.device).reshape(
        3, 1, 1, 1) * torch.tensor([g.L1, g.L2, g.L3],
                                   device=pos.device).reshape(3, 1, 1, 1)
    out = pos.clone()
    out[chain] = point + cells * d * torch.rand((3,) + g.shape, generator=gen,
                                                device=pos.device)
    return out.contiguous()


def far_flung(pos, g, frac=0.05, seed=0):
    """A fraction of the particles moved by about half the box in x, y and
    z: their taps fall outside every tile's capped box, into the global
    accumulator."""
    gen = torch.Generator(device=pos.device).manual_seed(seed)
    L = torch.tensor([g.L1, g.L2, g.L3], device=pos.device).reshape(
        1, 3, 1, 1, 1)
    sel = torch.rand((pos.shape[0], 1) + g.shape, generator=gen,
                     device=pos.device) < frac
    shift = torch.tensor([0.5, 0.45, 0.39], device=pos.device).reshape(
        1, 3, 1, 1, 1) * L
    return torch.remainder(torch.where(sel, pos + shift, pos), L).contiguous()


G128 = GridSpec.cube(128, 200.0)
TILED_CASES = {
    # (grid, halo, block, violators, how the positions are changed)
    "headline_128": (G128, 6, (16, 16), 0, None),
    "collapsed_chain": (G128, 3, (16, 16), 500, "collapsed"),
    "collapsed_wide_window": (G, 12, (16, 16), 200, "collapsed"),
    "far_flung": (G128, 64, (16, 16), 0, "far_flung"),
    "far_flung_violators": (GridSpec.cube(48, 75.0), (3, 2), (16, 16), 0,
                            "far_flung"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", sorted(TILED_CASES))
def test_cuda_tiled_deposit_on_hard_inputs(cuda, case, weighted):
    """The tiled K1 on inputs that strain its design — a chain collapsed
    into a few cells (hot cells, boxes at their cap) and particles flung
    half a box away (taps outside every box) — equal to itself bit for bit
    from call to call.  The plain version is the yardstick only where no
    cell sums thousands of taps: there its float32 sums drift beyond 2e-6 *
    max (measured on the H100), while the kernel's 64-bit integer sums are
    exact."""
    g, halo, block, n_viol, how = TILED_CASES[case]
    pos = positions(11, n_viol, g=g).to(cuda)
    if how == "collapsed":
        pos = collapsed(pos, g, chain=0)
    elif how == "far_flung":
        pos = far_flung(pos, g)
    w = None
    if weighted:
        hx, hy = tk._halo_pair(halo)
        w = (assign._halo_excess(pos, g, hx, hy) <= 0.0).float() * \
            (0.5 + torch.rand((2,) + g.shape, device=cuda))
    outs = [tk.tsc_deposit_window(pos, g, halo, block, weights=w)
            for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    if how != "collapsed":
        assert_close(outs[0], tk.tsc_deposit_window_plain(pos, g, halo, block,
                                                          weights=w))


def non_finite_and_huge(pos, g):
    """A few particles of each chain at NaN, +-inf and huge positions (some
    beyond the int range of a base cell, some within it but far outside
    the box)."""
    out = pos.clone()
    vals = [float("nan"), float("inf"), -float("inf"), 1e30, -1e30, 3e9, -3e9,
            1e8, -1e8, 2.1e9]
    for i, v in enumerate(vals):
        out[0, i % 3, (5 + i) % g.N1, 7 % g.N2, (9 + 2 * i) % g.N3] = v
        out[1, (i + 1) % 3, (40 - i) % g.N1, (3 * i) % g.N2, 11 % g.N3] = v
    return out.contiguous()


def assert_same_bits(a, b):
    """Equal bit for bit, NaN where the other has NaN."""
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def gather_counts():
    return {"tiled": tk.tsc_gather_grads_window.launches,
            "slab": tk.tsc_gather_grads_slab.launches}


G48 = GridSpec.cube(48, 75.0)
GATHER_CASES = {
    # (grid, halo, block, violators, how the positions are changed)
    "violators": (G, 3, (8, 8), 200, None),
    "halo_pair": (G, (3, 2), (8, 16), 150, None),
    "non_pow2_block_ragged": (G48, 3, (12, 24), 300, None),
    "headline_128": (G128, 6, (8, 8), 0, None),
    "collapsed_chain": (G128, 3, (8, 8), 500, "collapsed"),
    "far_flung": (G128, 64, (8, 8), 0, "far_flung"),
    "non_finite_and_huge": (G48, 3, (12, 24), 100, "bad"),
    # the kernel's 4-byte copies: N3 not a multiple of its 16-cell tiles
    # (ragged in z), and a field that is not 16-byte aligned
    "ragged_z_24": (GridSpec.cube(24, 37.5), 3, (8, 8), 80, None),
    "unaligned_field": (G, 3, (8, 8), 200, "unaligned"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("want_value", [False, True])
@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_cuda_tiled_gather_on_hard_inputs(cuda, case, want_value):
    """K2 through the tiled gather, on inputs that strain its design — a
    collapsed chain (boxes at their cap), particles flung half a box away
    and non-finite or huge positions (stencils outside every box), a
    block that is not a power of two over ragged tiles, and the 4-byte
    copies of a grid ragged in z or an unaligned field — equal bit for bit
    to itself from call to call, and within 3e-5 * max of the plain
    version wherever the positions are finite and near the box (the plain
    version's integer casts are undefined for huge ones)."""
    g, halo, block, n_viol, how = GATHER_CASES[case]
    pos = positions(12, n_viol, g=g).to(cuda)
    if how == "collapsed":
        pos = collapsed(pos, g, chain=0)
    elif how == "far_flung":
        pos = far_flung(pos, g)
    elif how == "bad":
        pos = non_finite_and_huge(pos, g)
    field = torch.randn(2 * g.N + 1, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))
    field = field[1:] if how == "unaligned" else field[:-1]
    field = field.view((2,) + g.shape)
    n0 = gather_counts()
    outs = [tk.tsc_gather_grads_window(field, pos, g, halo, block, want_value)
            for _ in range(3)]
    torch.cuda.synchronize()
    assert gather_counts() == dict(n0, tiled=n0["tiled"] + 3)
    assert_same_bits(outs[0], outs[1])
    assert_same_bits(outs[0], outs[2])
    if how != "bad":
        assert (outs[0] - tk.tsc_gather_grads_window_plain(
            field, pos, g, halo, block, want_value)).abs().max().item() <= \
            3e-5 * max(1.0, outs[0].abs().max().item())


@pytest.mark.gpu
def test_cuda_tiled_gather_counts_taps_outside_the_box(cuda):
    """Where every tile's particles stay within about a cell of their
    lattice sites, each tile's box holds all their stencils; particles
    flung half a box away read device memory."""
    g = G128
    d = torch.tensor(g.cell).reshape(3, 1, 1, 1)
    idx = torch.stack(torch.meshgrid(*[torch.arange(n) for n in g.shape],
                                     indexing="ij"))
    gen = torch.Generator().manual_seed(14)
    pos = (idx + 0.5) * d + 0.3 * d * torch.randn((2, 3) + g.shape,
                                                    generator=gen)
    L = torch.tensor([g.L1, g.L2, g.L3]).reshape(3, 1, 1, 1)
    pos = torch.remainder(pos, L).contiguous().to(cuda)
    field = torch.randn((2,) + g.shape, device=cuda)
    outside, total = tk.gather_taps_outside_box(field, pos, g, 6, (8, 8))
    assert outside == 0 and total > 0
    outside, total = tk.gather_taps_outside_box(field, far_flung(pos, g), g,
                                                64, (8, 8))
    assert 0 < outside < total


@pytest.mark.gpu
def test_cuda_windowless_deposits_are_deterministic(cuda):
    """assign.tsc_deposit (128^3, 2 chains) and the tail-split deposit with
    300 forced violators piled into a few cells give the same bits on every
    call: both sum in fixed point, where a float index_add_ on the card
    sums in a new order each time."""
    g = GridSpec.cube(128, 200.0)
    pos = positions(9, 0, g=g).to(cuda)
    a = assign.tsc_deposit(pos, g)
    b = assign.tsc_deposit(pos, g)
    assert torch.equal(a, b)
    torch.testing.assert_close(a.sum((1, 2, 3)),
                               torch.full((2,), float(g.N), device=cuda),
                               rtol=1e-6, atol=0)
    pos = positions(10, 0).to(cuda)
    sel = torch.zeros(G.N, dtype=torch.bool)
    sel[torch.randperm(G.N, generator=torch.Generator().manual_seed(0))[:300]] = True
    sel = sel.reshape(G.shape).to(cuda)
    pile = torch.tensor([10.3, 20.1, 30.7], device=cuda).reshape(3, 1, 1, 1)
    pos = torch.where(sel, pile + 0.01 * torch.randn_like(pos), pos)
    dep = assign.make_tsc_deposit_fast(G, halo=3, tail_k=1024)
    assert (assign._halo_excess(pos, G, 3, 3) > 0).sum((1, 2, 3)).min() > 100
    r1, r2 = dep(pos), dep(pos)
    assert torch.equal(r1, r2)
    assert_close(r1, assign.tsc_deposit(pos, G))


SLAB_CASES = {
    # (slabs D, halo): one slab of the whole box; 16-row slabs; 8-row slabs
    # under 24-row windows (halo 8)
    "one_slab": (1, 8), "two_slabs": (2, 4), "four_slabs": (4, 8)}


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", sorted(SLAB_CASES))
def test_cuda_slab_kernels_match_plain(cuda, case, weighted):
    """K3 and K4 (with and without the value) on every slab of 32^3 with
    contract violators against their plain versions; K3 (the tiled kernel)
    bit-identical from call to call."""
    D, h = SLAB_CASES[case]
    n1 = G.N1 // D
    pos = positions(7, 200).to(cuda)
    for k in range(D):
        p = pos[:, :, k * n1:(k + 1) * n1].contiguous()
        w = torch.rand((2, n1) + G.shape[1:], device=cuda) \
            if weighted else None
        n3, n4 = tk.tsc_deposit_slab.launches, tk.tsc_gather_grads_slab.launches
        out = tk.tsc_deposit_slab(p, G, n1, k, h, weights=w)
        again = tk.tsc_deposit_slab(p, G, n1, k, h, weights=w)
        torch.cuda.synchronize()
        assert tk.tsc_deposit_slab.launches == n3 + 2
        assert torch.equal(out, again)
        assert_close(out, tk.tsc_deposit_slab_plain(p, G, n1, k, h, weights=w))
        field = torch.randn(out.shape, device=cuda)
        for want_value in (False, True):
            o = tk.tsc_gather_grads_slab(field, p, G, n1, k, h,
                                         want_value=want_value)
            r = tk.tsc_gather_grads_slab_plain(field, p, G, n1, k, h,
                                               want_value=want_value)
            assert (o - r).abs().max().item() <= 3e-5 * r.abs().max().item()
        assert tk.tsc_gather_grads_slab.launches == n4 + 2


def slab_edges(pos, g, n1, dev, h):
    """The slab's first and last rows of particles moved (h - 1.5) cells
    outwards in x: their taps reach the extended buffer's first and last
    rows."""
    d = g.cell[0]
    out = pos.clone()
    out[:, 0, 0] -= (h - 1.5) * d
    out[:, 0, n1 - 1] += (h - 1.5) * d
    return torch.remainder(out, g.L1 * torch.tensor(
        [1.0, g.L2 / g.L1, g.L3 / g.L1], device=pos.device).reshape(
            3, 1, 1, 1)).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("want_value", [False, True])
@pytest.mark.parametrize("how", [None, "edges", "bad"])
@pytest.mark.parametrize("case", sorted(SLAB_CASES))
def test_cuda_tiled_slab_gather_on_hard_inputs(cuda, case, how, want_value):
    """K4 through the tiled gather on every slab of 32^3 with contract
    violators, with the slab's edge rows pushed into the extended buffer's
    first and last rows, and with non-finite or huge positions: equal bit
    for bit to itself, and within 3e-5 * max of the plain version where the
    positions are finite."""
    D, h = SLAB_CASES[case]
    n1 = G.N1 // D
    pos = positions(13, 200).to(cuda)
    if how == "bad":
        pos = non_finite_and_huge(pos, G)
    gen = torch.Generator(device=cuda).manual_seed(2)
    for k in range(D):
        p = pos[:, :, k * n1:(k + 1) * n1].contiguous()
        if how == "edges":
            p = slab_edges(p, G, n1, k, h)
        field = torch.randn((2, n1 + 2 * h) + G.shape[1:], device=cuda,
                            generator=gen)
        n0 = gather_counts()
        outs = [tk.tsc_gather_grads_slab(field, p, G, n1, k, h,
                                         want_value=want_value)
                for _ in range(3)]
        torch.cuda.synchronize()
        assert gather_counts() == dict(n0, slab=n0["slab"] + 3)
        assert_same_bits(outs[0], outs[1])
        assert_same_bits(outs[0], outs[2])
        if how != "bad":
            ref = tk.tsc_gather_grads_slab_plain(field, p, G, n1, k, h,
                                                 want_value=want_value)
            assert (outs[0] - ref).abs().max().item() <= \
                3e-5 * max(1.0, ref.abs().max().item())


@pytest.mark.gpu
def test_cuda_measure_spectrum_is_deterministic(cuda):
    """The binned spectrum sums each bin in a fixed order: 128^3, two calls,
    the same bits (a float index_add_ on the card differs between calls)."""
    from barcode_tpu_torch.grid import fourier

    g = GridSpec.cube(128, 200.0)
    x = torch.randn(g.shape, device=cuda)
    a = fourier.measure_spectrum(x, g, 200)
    b = fourier.measure_spectrum(x, g, 200)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    ref = fourier.measure_spectrum(x.cpu(), g, 200)
    for u, v in zip(a, ref):
        assert (u.cpu() - v).abs().max() <= 1e-5 * v.abs().max()


@pytest.mark.gpu
def test_cuda_wrappers_raise_on_bad_tensors(cuda):
    pos = positions(4, 0, chains=1)[0].to(cuda)
    with pytest.raises(TypeError):
        tk.tsc_deposit_window(pos.double(), G)
    with pytest.raises(ValueError):
        tk.tsc_gather_grads_window(
            torch.zeros(G.shape, device=cuda).transpose(0, 1), pos, G)
    with pytest.raises(ValueError):
        tk.tsc_deposit_window(pos, G, weights=torch.ones(G.shape))  # on CPU


@pytest.mark.gpu
def test_cuda_runner_goes_through_the_kernels(cuda, tmp_path):
    """A 16^3 headline-config session on the card launches K1 and K2 once
    per gradient (init + N_eps_fac per attempt), K1 also once per dumped
    deltaEUL/deltaRSS field, no bf16 variant, and stays finite."""
    g = GridSpec.cube(16, 25.0)
    fc = ForwardConfig(sfmodel=3, masskernel="sph_ft", rsd=True,
                       pallas_deposit=True, pallas_halo=0, pallas_tail_k=1024)
    conf = RunConfig(grid=g, model=ModelConfig(likelihood=1, forward=fc),
                     hmc=HMCConfig(eps_fac=1e-3, eps_fac_update_type=0,
                                   N_eps_fac=4, N_a_eps_update=8),
                     readPS=False)
    kernels = (tk.tsc_deposit_window, tk.tsc_gather_grads_window,
               tk.tsc_deposit_slab, tk.tsc_gather_grads_slab)
    for f in kernels:
        f.launches = f.launches_bf16 = 0
    r = Runner(conf, out_dir=str(tmp_path), device=cuda)
    r.attempt_batch = 2
    r.setup(n_chains=2)
    states = r.run(n_samples=100, max_attempts=2, log=False)
    r.close()
    expected = 1 + 2 * 4
    n_dumps = min(int(states.accepted[0]), 100)
    assert n_dumps > 0
    assert {p.name for p in tmp_path.glob("deltaRSS_*")} == \
        {f"deltaRSS_{i}.dat" for i in range(1, n_dumps + 1)}
    assert tk.tsc_deposit_window.launches == expected + 2 * n_dumps
    assert tk.tsc_gather_grads_window.launches == expected
    assert all(f.launches_bf16 == 0 for f in kernels)
    assert tk.tsc_deposit_slab.launches == tk.tsc_gather_grads_slab.launches \
        == 0
    assert torch.isfinite(states.psi).all()


MASS_CODES = [0, 1, 2, 3, "sph_ft"]


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mk", MASS_CODES)
def test_cuda_mass_kernels_are_deterministic_and_match_cpu(cuda, mk,
                                                           weighted):
    """Every windowless deposit of assign.deposit (32^3, 2 chains) gives
    the same bits on every call on the card (fixed-point sums) and agrees
    with the CPU within 2e-6 * max(1, max|ref|); its autograd position
    gradient within 3e-5 * max|grad|."""
    pos = positions(41, 0)
    w = (torch.rand((2,) + G.shape, generator=torch.Generator().manual_seed(1))
         + 0.5) if weighted else None
    cot = torch.randn((2,) + G.shape, generator=torch.Generator().manual_seed(2))
    h = G.cell_avg

    def run(device):
        p = pos.to(device).requires_grad_(True)
        rho = assign.deposit(p, G, mk, h, None if w is None else w.to(device))
        if rho.requires_grad:
            (rho * cot.to(device)).sum().backward()
        return rho.detach(), p.grad

    rho, grad = run(cuda)
    for _ in range(2):
        assert torch.equal(run(cuda)[0], rho)
    ref, ref_grad = run("cpu")
    assert_close(rho.cpu(), ref)
    if mk == 0:
        assert grad is None and ref_grad is None
    else:
        assert_close(grad.cpu(), ref_grad, 3e-5)


@pytest.mark.gpu
def test_cuda_sph_deposit_where_the_norm_exceeds_one(cuda):
    """Every particle piled onto one point of a 16^3 grid of 0.25 cells
    (norm 1/(pi h^3) = 20.4), weight 7.5: the fixed-point sum does not
    overflow, and equals the CPU's within float32 rounding."""
    g = GridSpec.cube(16, 4.0)
    pos = torch.full((3,) + g.shape, 0.3 * g.cell_avg)
    w = torch.full(g.shape, 7.5)
    out = assign.sph_deposit(pos.to(cuda), g, g.cell_avg, w.to(cuda))
    ref = assign.sph_deposit(pos, g, g.cell_avg, w)
    assert torch.isfinite(out).all() and out.max().item() > 0
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-6, atol=0)


@pytest.mark.gpu
def test_cuda_resolution_independent_draw_matches_cpu(cuda):
    """The counter-based hash gives the same integers on the card as on
    the CPU; the unit modes agree to float32 rounding."""
    from barcode_tpu_torch import random_fields as rf

    g = GridSpec.cube(32, 200.0)
    fx, fy, fz = (f.expand(g.rshape) for f in rf._signed_freqs(g))
    words = rf.threefry2x32((123, 456), fx & 0xFFFFFFFF, fy & 0xFFFFFFFF)
    words_d = rf.threefry2x32((123, 456), fx.to(cuda) & 0xFFFFFFFF,
                              fy.to(cuda) & 0xFFFFFFFF)
    assert all(torch.equal(a, b.cpu()) for a, b in zip(words, words_d))
    a = rf._unit_hermitian_modes(2**40 + 7, g)
    b = rf._unit_hermitian_modes(2**40 + 7, g, cuda)
    torch.testing.assert_close(b.cpu(), a, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
def test_cuda_radial_kernel_deposit_matches_cpu(cuda):
    """ALPT with radial RSD about a box corner through the kernel deposit
    and the tail split (K1, K2 on positions outside the box) on the card
    against the plain versions on the CPU: delta_eul and its gradient."""
    from barcode_tpu_torch.forward.lag2eul import GrowthParams, lag2eul

    fc = ForwardConfig(sfmodel=3, masskernel="sph_ft", rsd=True,
                       rsd_planepar=False, observer=(20.0, 5.0, -3.0),
                       origin=(20.0, 5.0, -3.0), pallas_deposit=True,
                       pallas_halo=2, pallas_tail_k=512)
    gp = GrowthParams(D1=1.0, D2=-3.0 / 7.0, ascale=1.0, cpecvel=52.85,
                      hubble=100.0)
    delta = 3.0 * torch.randn((2,) + G.shape,
                              generator=torch.Generator().manual_seed(3))
    cot = torch.randn((2,) + G.shape, generator=torch.Generator().manual_seed(4))

    def run(device):
        d = delta.to(device).requires_grad_(True)
        out, pos = lag2eul(d, G, fc, gp, return_pos=True)
        (out * cot.to(device)).sum().backward()
        return out.detach().cpu(), d.grad.cpu(), pos.detach().cpu()

    tk.tsc_deposit_window.launches = tk.tsc_gather_grads_window.launches = 0
    out, grad, pos = run(cuda)
    assert tk.tsc_deposit_window.launches == 1
    assert tk.tsc_gather_grads_window.launches == 1
    assert ((pos < 0) | (pos >= G.L1)).any()
    ref, ref_grad, _ = run("cpu")
    assert_close(out, ref, 1e-4)
    assert_close(grad, ref_grad, 1e-4)


def test_device_resolution_has_no_silent_fallback():
    assert device.resolve("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert device.resolve().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            device.resolve()
        with pytest.raises(RuntimeError):
            Runner(RunConfig(grid=GridSpec.cube(8, 8.0)), out_dir="unused")


def test_missing_nvcc_raises_clearly(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as ext

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.find_nvcc()


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    """A changed source gives another hash, so a stale build never loads."""
    for name in cuda_build.SOURCES + cuda_build.HEADERS:
        (tmp_path / name).write_bytes((cuda_build.CSRC / name).read_bytes())
    h0 = cuda_build.source_hash()
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    assert cuda_build.source_hash() == h0
    with open(tmp_path / cuda_build.SOURCES[0], "a") as f:
        f.write("\n// changed\n")
    assert cuda_build.source_hash() != h0


def test_plain_deposit_conserves_mass_inside_the_contract():
    """With every particle inside the halo contract the windowed deposit is
    plain TSC: it conserves the (weighted) mass exactly."""
    pos = positions(5, 0)
    w = torch.rand((2,) + G.shape, generator=torch.Generator().manual_seed(0))
    assert int(tk.deposit_violations(pos, G, 6).sum()) == 0
    rho = tk.tsc_deposit_window(pos, G, 6, (16, 16), weights=w)
    torch.testing.assert_close(rho.sum((1, 2, 3)), w.sum((1, 2, 3)),
                               rtol=1e-5, atol=0)
    torch.testing.assert_close(rho, assign.tsc_deposit(pos, G, w),
                               atol=2e-6, rtol=0)


BF16_CASES = {
    # (grid, halo, deposit block, gather block, violators)
    "violators_32": (G, 3, (16, 16), (8, 8), 200),
    "halo_pair_32": (G, (3, 2), (16, 8), (8, 16), 150),
    "headline_128": (G128, 6, (16, 16), (8, 8), 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_cuda_bf16_kernels_match_plain(cuda, case, weighted):
    """K1 and K2 with bf16 against their bf16 plain versions (2e-6 and 3e-5
    * max(1, max|ref|)), each bit-identical from call to call and counted
    on its bf16 counter only; bf16 differs from float32 within 1e-2 *
    max."""
    g, halo, block_dep, block, n_viol = BF16_CASES[case]
    pos = positions(21, n_viol, g=g).to(cuda)
    w = torch.rand((2,) + g.shape, device=cuda) if weighted else None
    field = torch.randn((2,) + g.shape, device=cuda)
    kernels = (tk.tsc_deposit_window, tk.tsc_gather_grads_window)
    n0 = [(f.launches, f.launches_bf16) for f in kernels]
    dep = [tk.tsc_deposit_window(pos, g, halo, block_dep, weights=w,
                                 bf16=True) for _ in range(3)]
    gat = [tk.tsc_gather_grads_window(field, pos, g, halo, block, False,
                                      bf16=True) for _ in range(3)]
    torch.cuda.synchronize()
    assert [(f.launches, f.launches_bf16) for f in kernels] == \
        [(a, b + 3) for a, b in n0]
    assert torch.equal(dep[0], dep[1]) and torch.equal(dep[0], dep[2])
    assert torch.equal(gat[0], gat[1]) and torch.equal(gat[0], gat[2])
    assert_close(dep[0], tk.tsc_deposit_window_plain(
        pos, g, halo, block_dep, weights=w, bf16=True))
    assert_close(gat[0], tk.tsc_gather_grads_window_plain(
        field, pos, g, halo, block, False, bf16=True), rel=3e-5)
    for bf, f32 in ((dep[0], tk.tsc_deposit_window(pos, g, halo, block_dep,
                                                   weights=w)),
                    (gat[0], tk.tsc_gather_grads_window(field, pos, g, halo,
                                                        block, False))):
        diff = (bf - f32).abs().max().item()
        assert 0 < diff <= 1e-2 * f32.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", sorted(SLAB_CASES))
def test_cuda_bf16_slab_kernels_match_plain(cuda, case, weighted):
    """K3 and K4 with bf16 on every slab of 32^3 with contract violators
    against their bf16 plain versions, bit-identical from call to call."""
    D, h = SLAB_CASES[case]
    n1 = G.N1 // D
    pos = positions(22, 200).to(cuda)
    for k in range(D):
        p = pos[:, :, k * n1:(k + 1) * n1].contiguous()
        w = torch.rand((2, n1) + G.shape[1:], device=cuda) \
            if weighted else None
        n3 = tk.tsc_deposit_slab.launches_bf16
        out = tk.tsc_deposit_slab(p, G, n1, k, h, weights=w, bf16=True)
        again = tk.tsc_deposit_slab(p, G, n1, k, h, weights=w, bf16=True)
        torch.cuda.synchronize()
        assert tk.tsc_deposit_slab.launches_bf16 == n3 + 2
        assert torch.equal(out, again)
        assert_close(out, tk.tsc_deposit_slab_plain(p, G, n1, k, h,
                                                    weights=w, bf16=True))
        field = torch.randn(out.shape, device=cuda)
        for want_value in (False, True):
            o = tk.tsc_gather_grads_slab(field, p, G, n1, k, h,
                                         want_value=want_value, bf16=True)
            assert torch.equal(o, tk.tsc_gather_grads_slab(
                field, p, G, n1, k, h, want_value=want_value, bf16=True))
            assert_close(o, tk.tsc_gather_grads_slab_plain(
                field, p, G, n1, k, h, want_value=want_value, bf16=True),
                rel=3e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("fn", ["measure_correlation", "measure_spectrum_2d",
                                "measure_correlation_2d"])
def test_cuda_statistics_are_deterministic(cuda, fn):
    """Each statistic at 128^3 with 200 bins gives the same bits on 3 calls
    on the card (every bin summed in a fixed order), and agrees with the
    CPU: nmode exactly, the means within rtol 1e-5, atol 1e-6 * max."""
    from barcode_tpu_torch import statistics

    g = GridSpec.cube(128, 200.0)
    x = torch.randn(g.shape, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(3))
    f = getattr(statistics, fn)
    outs = [f(x, g, 200) for _ in range(3)]
    for u, v, w in zip(*outs):
        assert torch.equal(u, v) and torch.equal(u, w)
    for u, v in zip(outs[0], f(x.cpu(), g, 200)):
        torch.testing.assert_close(
            u.cpu(), v, rtol=1e-5, atol=1e-6 * max(1.0, v.abs().max().item()))
    np.testing.assert_array_equal(outs[0][2].cpu().numpy(),
                                  f(x.cpu(), g, 200)[2].numpy())
