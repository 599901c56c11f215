"""The port's slab-sharded FFTs against the JAX package's and the dense
transforms: in-process at one rank, and over gloo at two ranks (CPU).

Inputs are numpy arrays from a seed; the JAX side runs on the
8-virtual-device CPU mesh of tests/conftest.py, the port's ranks in
processes of their own (tests/torch_workers.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from barcode_tpu.grid.spec import GridSpec as JGridSpec
from barcode_tpu.parallel import sharded_fft as jsf

from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.parallel import distributed as pd
from barcode_tpu_torch.parallel import sharded_fft as sf

import torch_workers

N, L = 16, 100.0
JG, G = JGridSpec.cube(N, L), GridSpec.cube(N, L)
RTOL = 1e-5  # float32 transforms of O(1) fields, summed in another order


def gauss(kx, ky, kz):
    return jnp.exp(-(kx * kx + ky * ky + kz * kz) * 4.0) \
        if isinstance(kx, jnp.ndarray) else \
        torch.exp(-(kx * kx + ky * ky + kz * kz) * 4.0)


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal(G.shape).astype(np.float32),
            "w": rng.standard_normal(G.shape).astype(np.float32),
            "N": np.int64(N), "L": np.float64(L)}


def jax_ops(n_dev):
    mesh = Mesh(np.asarray(jax.devices()[:n_dev]), axis_names=(jsf.AXIS,))
    return mesh, jsf.make_sharded_ops(JG, mesh)


def assert_close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, atol=rtol * np.abs(b).max())


@pytest.fixture(scope="module")
def one_rank():
    return sf.make_sharded_ops(G, pd.make_layout(1, 1, device="cpu"))


def test_rfft3_and_inverse_at_one_rank(one_rank):
    rfft3, irfft3, _, _ = one_rank
    x = inputs()["x"]
    mesh, (jr, ji, _, _) = jax_ops(1)
    F = rfft3(torch.from_numpy(x))
    assert_close(F.numpy(), np.asarray(jr(jnp.asarray(x))))
    assert_close(F.numpy(), np.fft.rfftn(x))
    assert_close(irfft3(F).numpy(), x)


def test_convolve_and_displacement_at_one_rank(one_rank):
    _, _, conv, disp = one_rank
    x = inputs()["x"]
    mesh, (_, _, jconv, jdisp) = jax_ops(1)
    assert_close(conv(torch.from_numpy(x), gauss).numpy(),
                 np.asarray(jconv(jnp.asarray(x), gauss)))
    assert_close(disp(torch.from_numpy(x)).numpy(),
                 np.asarray(jdisp(jnp.asarray(x))))


def test_kvec_sharded_matches_jax():
    """The local k-blocks, to float32 rounding (2 pi f is formed in
    another order)."""
    for n_dev, dev in ((1, 0), (2, 1), (4, 2)):
        for a, b in zip(sf.kvec_sharded(G, n_dev, dev),
                        jsf.kvec_sharded(JG, n_dev, dev)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-7)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    inp = inputs(1)
    outs = torch_workers.launch("fft_worker", 2, inp,
                                tmp_path_factory.mktemp("fft2"))
    return inp, outs


def test_sharded_fft_two_ranks_matches_jax(two_ranks):
    inp, outs = two_ranks
    x = inp["x"]
    mesh, (jr, ji, jconv, jdisp) = jax_ops(2)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(jsf.AXIS)))
    # Fourier layout: ky-slabs concatenated along y
    F = np.concatenate([o["F"] for o in outs], axis=1)
    assert_close(F, np.asarray(jr(xs)))
    assert_close(np.concatenate([o["back"] for o in outs]), x)
    assert_close(np.concatenate([o["conv"] for o in outs]),
                 np.asarray(jconv(xs, gauss)))
    assert_close(np.concatenate([o["disp"] for o in outs], axis=1),
                 np.asarray(jdisp(xs)))


def test_sharded_fft_backward_is_the_adjoint(two_ranks):
    """Autograd through the all-to-all: the gradient of <w, K * x> is K * w
    (K real and symmetric), assembled from both ranks' slabs."""
    _, outs = two_ranks
    assert_close(np.concatenate([o["conv_grad"] for o in outs]),
                 np.concatenate([o["conv_w"] for o in outs]))
