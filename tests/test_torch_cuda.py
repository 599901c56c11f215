"""The port's CUDA kernels on the card, and their build and device plumbing.

The tests marked `gpu` need a CUDA card and skip without one; this file
imports neither `jax` nor `barcode_tpu`, so on a machine with a card and
no JAX it runs on its own:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Kernel tolerances: 2e-6 * max(1, max|ref|) — K1/K2 sum their taps in
another order than the plain versions (K1 exactly, in 64-bit fixed point;
the plain versions in float32); the window decisions are integer
arithmetic and must agree exactly.  Gradients through the deposit:
3e-5 * max|grad|.
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
@pytest.mark.parametrize("scale", [1e-7, 1.0, 3e5])
def test_cuda_deposit_is_deterministic_at_any_weight_scale(cuda, scale):
    """Fixed-point accumulation: bit-identical repeats, signed weights of
    any magnitude within tolerance, and NaN for a chain with a non-finite
    particle (as the float sum would make its psi)."""
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
    # window wider than the grid (WX = 32 > 16, 40 > 32)
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
    """K1s (stream=True) within 2e-6 * max of the plain version, equal to
    K1 (stream=False) bit for bit, and bit-identical from call to call."""
    g, halo, block, n_viol = STREAM_CASES[case]
    pos = positions(7, n_viol, g=g).to(cuda)
    w = torch.rand((2,) + g.shape, device=cuda) if weighted else None
    n_s, n_k1 = tk.tsc_deposit_window_stream.launches, tk.tsc_deposit_window.launches
    out = tk.tsc_deposit_window(pos, g, halo, block, weights=w, stream=True)
    again = tk.tsc_deposit_window(pos, g, halo, block, weights=w, stream=True)
    k1 = tk.tsc_deposit_window(pos, g, halo, block, weights=w, stream=False)
    torch.cuda.synchronize()
    assert tk.tsc_deposit_window_stream.launches == n_s + 2
    assert tk.tsc_deposit_window.launches == n_k1 + 1
    assert torch.equal(out, again) and torch.equal(out, k1)
    assert_close(out, tk.tsc_deposit_window_plain(pos, g, halo, block,
                                                  weights=w))


@pytest.mark.gpu
def test_cuda_stream_deposit_marks_a_bad_chain(cuda):
    pos = positions(8, 50).to(cuda)
    w = torch.rand((2,) + G.shape, device=cuda)
    w[0, 5, 6, 7] = float("inf")
    out = tk.tsc_deposit_window(pos, G, 3, (16, 16), weights=w, stream=True)
    assert torch.isnan(out[0]).all()
    assert torch.equal(out[1], tk.tsc_deposit_window(
        pos, G, 3, (16, 16), weights=w, stream=False)[1])


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
    deltaEUL/deltaRSS field, and stays finite."""
    g = GridSpec.cube(16, 25.0)
    fc = ForwardConfig(sfmodel=3, masskernel="sph_ft", rsd=True,
                       pallas_deposit=True, pallas_halo=0, pallas_tail_k=1024)
    conf = RunConfig(grid=g, model=ModelConfig(likelihood=1, forward=fc),
                     hmc=HMCConfig(eps_fac=1e-3, eps_fac_update_type=0,
                                   N_eps_fac=4, N_a_eps_update=8),
                     readPS=False)
    tk.tsc_deposit_window.launches = tk.tsc_gather_grads_window.launches = 0
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
    assert torch.isfinite(states.psi).all()


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
