"""Port parity: `python -m barcode_tpu_torch.tools` against
`python -m barcode_tpu.tools` on the same files at 16^3.

Each tool runs in process through both packages' `main` (the port's with
`--device cpu`), and the files they write are compared: within rtol 1e-5
and atol 1e-6 * max(1, max|ref|) (tests/test_torch_spectrum.py's anchors;
float32 sums in another order), except `lag2eul`, held to the forward
model's anchor of tests/test_torch_forward.py (1e-4 * max|ref|: the LPT
chains run up to ~15 float32 transforms), and `poisson_upres`, host numpy
in both, which must agree bit for bit.  The card run of the tools is chip_smoke.py's
`analysis` phase.
"""
import numpy as np
import pytest
import torch

from barcode_tpu.forward import assign as jassign
from barcode_tpu.grid.spec import GridSpec as JGridSpec
from barcode_tpu.tools.__main__ import main as jmain

from barcode_tpu_torch import io as bio
from barcode_tpu_torch.forward import assign
from barcode_tpu_torch.grid.spec import GridSpec
from barcode_tpu_torch.tools.__main__ import _cic_deposit_host, main

N, L = 16, 50.0


@pytest.fixture
def delta(tmp_path):
    rng = np.random.default_rng(0)
    x = (0.5 * rng.standard_normal((N, N, N))).astype(np.float32)
    bio.write_array(tmp_path / "d", x)
    return str(tmp_path / "d")


def read(path, text):
    return np.loadtxt(path + ".dat") if text else bio.read_array(path)


def both(argv, tmp_path, tool, text=False):
    """The JAX tool's output and the port's (--device cpu) on argv."""
    jout, out = str(tmp_path / f"jax_{tool}"), str(tmp_path / f"port_{tool}")
    assert jmain(argv + ["--out", jout]) == 0
    assert main(argv + ["--out", out, "--device", "cpu"]) == 0
    return read(out, text), read(jout, text)


def close(out, ref):
    np.testing.assert_allclose(out, ref, rtol=1e-5,
                               atol=1e-6 * max(1.0, np.abs(ref).max()))


def close_forward(out, ref):
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("upsample", [None, "--fft-upsample",
                                      "--cic-upsample"])
@pytest.mark.parametrize("tool", ["powspec", "corr_fct", "2D_powspec",
                                  "2D_corr_fct"])
def test_statistics_tools_match_jax(tool, upsample, delta, tmp_path):
    argv = [tool, delta, str(N), str(L), "--nbin", "30"]
    if upsample:
        argv += [upsample, "2"]
    out, ref = both(argv, tmp_path, tool, text=tool in ("powspec",
                                                         "corr_fct"))
    assert out.shape == ref.shape
    close(out, ref)


def test_default_names_and_nbin(delta):
    """The JAX tools' default output names and the default 200 bins."""
    cpu = ["--device", "cpu"]
    assert main(["2D_corr_fct", delta, str(N), str(L)] + cpu) == 0
    assert bio.read_array(delta + "_2D_corr_fct").shape == (200 * 200,)
    assert main(["corr_fct", delta, str(N), str(L)] + cpu) == 0
    assert np.loadtxt(delta + "_corr_fct.dat").shape == (200, 2)
    assert main(["poisson_upres", delta, str(N), str(L), "32", "0.5"]
                + cpu) == 0
    assert bio.read_array(delta + "_poisCIC32_Nbar0.5").shape == (32**3,)
    assert main(["interp_upres", delta, str(N), str(L), "32"] + cpu) == 0
    assert bio.read_array(delta + "_interpCIC32").shape == (32**3,)
    assert main(["lag2eul", delta, str(N), str(L)] + cpu) == 0
    assert bio.read_array(delta + "_eul").shape == (N**3,)


def test_both_upsample_flags_are_refused(delta):
    with pytest.raises(SystemExit):
        main(["powspec", delta, str(N), str(L), "--fft-upsample", "2",
              "--cic-upsample", "2", "--device", "cpu"])


@pytest.mark.parametrize("extra", [[], ["--sfmodel", "2", "--masskernel",
                                        "2", "--z", "0.5"]])
def test_lag2eul_matches_jax(extra, delta, tmp_path):
    close_forward(*both(["lag2eul", delta, str(N), str(L)] + extra,
                        tmp_path, "lag2eul"))


def test_lag2eul_with_transfer_kernels_matches_jax(delta, tmp_path):
    k = np.fft.fftfreq(N)[:, None, None] ** 2 + np.fft.fftfreq(N)[
        None, :, None] ** 2 + np.fft.fftfreq(N)[None, None, :] ** 2
    t = (1.0 / (1.0 + 20.0 * k)).astype(np.float32)
    bio.write_array(tmp_path / "tz", t)
    bio.write_array(tmp_path / "t2", t * t)
    close_forward(*both(["lag2eul", delta, str(N), str(L), "--sfmodel", "3",
                         "--transf-zeld", str(tmp_path / "tz"),
                         "--transf-2lpt", str(tmp_path / "t2")], tmp_path,
                        "lag2eul"))


def test_density_matches_jax(tmp_path):
    """A particle list that is not a multiple of the grid (padded with
    zero-weight particles), with and without an explicit kernel scale."""
    rng = np.random.default_rng(4)
    pos = (rng.random((3, N**3 + 700)) * L).astype(np.float32)
    for i, a in enumerate("xyz"):
        bio.write_array(tmp_path / f"parts_{a}", pos[i])
    base = str(tmp_path / "parts")
    for extra in ([], ["--kernel-h", "4.5"]):
        out, ref = both(["density", base, str(N), str(L)] + extra, tmp_path,
                        "density")
        close(out, ref)
        # mass: the SPH grid sums to the particle count / cell volume
        np.testing.assert_allclose(out.sum() * (L / N) ** 3, pos.shape[1],
                                   rtol=0.02)


def test_interp_upres_matches_jax(delta, tmp_path):
    out, ref = both(["interp_upres", delta, str(N), str(L), "32"], tmp_path,
                    "interp_upres")
    assert out.shape == (32**3,)
    close(out, ref)


@pytest.mark.parametrize("seed", [1, 7])
def test_poisson_upres_is_the_jax_file_bit_for_bit(seed, delta, tmp_path):
    out, ref = both(["poisson_upres", delta, str(N), str(L), "32", "0.5",
                     "--seed", str(seed)], tmp_path, "poisson_upres")
    assert out.tobytes() == ref.tobytes()


def test_default_device_is_the_card(delta):
    """Without --device the tools run on the card, and raise where there is
    none rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for argv in (["powspec", delta, str(N), str(L)],
                 ["poisson_upres", delta, str(N), str(L), "32", "0.5"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)


def test_cic_deposit_host_matches_cic_deposit():
    """The host CIC deposit of a particle list equals the port's (and the
    JAX package's) cic_deposit on the same positions."""
    g, jg = GridSpec.cube(N, L), JGridSpec.cube(N, L)
    rng = np.random.default_rng(2)
    pos = rng.random((3,) + g.shape) * L
    rho = _cic_deposit_host(pos.reshape(3, -1), g)
    ref = assign.cic_deposit(torch.from_numpy(pos.astype(np.float32)), g)
    np.testing.assert_allclose(rho, ref.numpy(), rtol=1e-5, atol=1e-5)
    jref = np.asarray(jassign.cic_deposit(pos.astype(np.float32), jg))
    np.testing.assert_allclose(rho, jref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rho.sum(), g.N, rtol=1e-12)
