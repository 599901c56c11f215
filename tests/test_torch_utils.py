"""The port's host-side copies — io, protocol files and sampler metrics —
against the JAX package's on the same numpy inputs.

These modules are numpy-only in both packages, so the port keeps its own
copies (it may not import `barcode_tpu`); the tests hold the copies to the
same bytes and the same numbers.  Metrics are float64 numpy in both: they
must agree to 1e-12 relative.
"""
import numpy as np
import pytest
import torch

from barcode_tpu import io as jio
from barcode_tpu import protocol as jprotocol
from barcode_tpu.utils import metrics as jmetrics

from barcode_tpu_torch import io as tio
from barcode_tpu_torch import protocol as tprotocol
from barcode_tpu_torch.utils import metrics as tmetrics


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_io_writes_the_same_bytes(tmp_path, dtype):
    rng = np.random.default_rng(0)
    field = rng.standard_normal((6, 5, 4))
    pj = jio.write_array(tmp_path / "jax" / "deltaLAG_1", field, dtype=dtype)
    pt = tio.write_array(tmp_path / "torch" / "deltaLAG_1", field, dtype=dtype)
    assert pj.name == pt.name == "deltaLAG_1.dat"
    assert pj.read_bytes() == pt.read_bytes()
    np.testing.assert_array_equal(
        tio.read_array(pj, field.shape, dtype), jio.read_array(pt, field.shape, dtype))
    k, p = rng.random(7), rng.random(7)
    sj = jio.dump_spectrum(tmp_path / "jax" / "spec.dat", k, p)
    st = tio.dump_spectrum(tmp_path / "torch" / "spec.dat", k, p)
    assert sj.read_bytes() == st.read_bytes()
    np.testing.assert_array_equal(tio.read_powspec_table(st)[1],
                                  jio.read_powspec_table(sj)[1])


def test_protocol_files_match(tmp_path):
    rng = np.random.default_rng(1)
    truth = rng.random(40)
    pj = jprotocol.Protocols(tmp_path / "jax")
    pt = tprotocol.Protocols(tmp_path / "torch")
    for it in (1, 2, 3):
        k, p = rng.random(40), rng.random(40)
        for prot in (pj, pt):
            prot.log_convergence(it, 0.5 * it, 0.25, rhat=1.01)
            prot.log_spectrum(it, k, p, truth if it > 1 else None)
            prot.write_restart_marker(it)
    pt.close()
    for name in ("convergence.prt", "spec_protocol.prt", "restart.prt"):
        assert (tmp_path / "torch" / name).read_text() == \
            (tmp_path / "jax" / name).read_text()


@pytest.mark.parametrize("kind", ["white", "walk", "constant", "short"])
def test_ess_and_split_rhat_match(kind):
    rng = np.random.default_rng(2)
    x = {"white": rng.standard_normal((4, 300)),
         "walk": np.cumsum(rng.standard_normal((4, 300)), axis=1),
         "constant": np.ones((4, 300)),
         "short": rng.standard_normal((4, 3))}[kind]
    for row in x:
        np.testing.assert_allclose(tmetrics.effective_sample_size(row),
                                   jmetrics.effective_sample_size(row),
                                   rtol=1e-12)
    np.testing.assert_allclose(tmetrics.split_rhat(x), jmetrics.split_rhat(x),
                               rtol=1e-12)


def test_sampler_metrics_and_nan_guard_match():
    class Stats:
        accepted = np.array([[1, 0], [1, 1]])
        Neps = np.array([[8, 8], [8, 8]])
        dH = np.array([[0.1, np.inf], [-0.3, 0.2]])

    mj, mt = jmetrics.SamplerMetrics(t_start=0.0), tmetrics.SamplerMetrics(t_start=0.0)
    for m in (mj, mt):
        m.update(Stats)
    sj, st = mj.summary(), mt.summary()
    for key in ("attempts", "accepted", "acc_rate", "median_abs_dH"):
        assert sj[key] == st[key], key
    good = {"delta": torch.zeros(2, 4), "psi": torch.zeros(2),
            "grad": torch.zeros(2, 4), "eps_fac": torch.ones(2)}
    tmetrics.check_finite(good)
    bad = dict(good, psi=torch.tensor([0.0, float("nan")]))
    with pytest.raises(FloatingPointError, match="psi"):
        tmetrics.check_finite(bad)
    with pytest.raises(FloatingPointError, match="psi"):
        jmetrics.check_finite({k: v.numpy() for k, v in bad.items()})
