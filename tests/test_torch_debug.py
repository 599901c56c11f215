"""Port parity: barcode_tpu_torch.utils.debug against barcode_tpu.utils.debug
(array statistics of fields with NaN and inf, as tensors and as numpy
arrays; the quick dump with and without its spectrum, which the port
measures on the array's own device)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from barcode_tpu.grid.spec import GridSpec as JGridSpec
from barcode_tpu.utils import debug as jdebug

from barcode_tpu_torch import io as bio
from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.utils import debug


def fields():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((8, 8, 8)).astype(np.float32)
    b = a.copy()
    b[1, 2, 3], b[4, 5, 6], b[0, 0, 0] = np.nan, np.inf, -np.inf
    return {"finite": a, "nan_inf": b,
            "all_nan": np.full((4, 4), np.nan, np.float32)}


@pytest.mark.parametrize("case", sorted(fields()))
def test_array_statistics_match_jax(case):
    a = fields()[case]
    ref = jdebug.array_statistics(jnp.asarray(a), case)
    for arr in (torch.from_numpy(a), a):
        out = debug.array_statistics(arr, case)
        assert out.keys() == ref.keys()
        for k in ref:
            if isinstance(ref[k], float) and np.isnan(ref[k]):
                assert np.isnan(out[k])
            else:
                assert out[k] == ref[k], k


def test_print_array_statistics(capsys):
    a = fields()["nan_inf"]
    debug.print_array_statistics(torch.from_numpy(a), "x")
    jdebug.print_array_statistics(jnp.asarray(a), "x")
    port, jax_out = capsys.readouterr().out.splitlines()
    assert port == jax_out and "NONFINITE=3" in port


@pytest.mark.parametrize("with_spectrum", [False, True])
def test_quick_dump_scalar_matches_jax(with_spectrum, tmp_path):
    g, jg = GridSpec.cube(16, 50.0), JGridSpec.cube(16, 50.0)
    x = np.random.default_rng(5).standard_normal(g.shape).astype(np.float32)
    path = debug.quick_dump_scalar(torch.from_numpy(x), tmp_path / "port",
                                   "delta", 3, with_spectrum, g, nbin=20)
    jpath = jdebug.quick_dump_scalar(jnp.asarray(x), tmp_path / "jax",
                                     "delta", 3, with_spectrum, jg, nbin=20)
    assert path.name == jpath.name == "delta_3.dat"
    assert bio.read_array(path).tobytes() == bio.read_array(jpath).tobytes()
    spec = tmp_path / "port" / "delta_3_spec.dat"
    assert spec.exists() == with_spectrum
    if with_spectrum:
        out = np.loadtxt(spec)
        ref = np.loadtxt(tmp_path / "jax" / "delta_3_spec.dat")
        np.testing.assert_allclose(out, ref, rtol=1e-5,
                                   atol=1e-6 * max(1.0, np.abs(ref).max()))
    # a numpy array takes the same path
    debug.quick_dump_scalar(x, tmp_path / "np", "delta", 3, with_spectrum, g,
                            nbin=20)
    assert bio.read_array(tmp_path / "np" / "delta_3").tobytes() == \
        bio.read_array(path).tobytes()
