"""Binary grid I/O compatible with the reference's raw format.

The reference writes grids as raw arrays of real_prec (row-major, x-major
C-index k + N3*(j + N2*i)) with an auto-appended `.dat` suffix
(reference barlib/src/IOfunctionsGen.cc:185-230).  Default build is
single precision (Options.cmake SINGLE_PREC default); `dtype` selects
float32/float64 for cross-validation against either build.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def _with_dat(fname) -> Path:
    p = Path(fname)
    if p.suffix != ".dat":
        p = p.with_name(p.name + ".dat")
    return p


def write_array(fname, array, dtype=np.float32):
    """Raw binary dump, reference-compatible (write_array,
    IOfunctionsGen.cc:194-212)."""
    arr = np.asarray(array, dtype=dtype)
    p = _with_dat(fname)
    p.parent.mkdir(parents=True, exist_ok=True)
    arr.tofile(p)
    return p


def read_array(fname, shape=None, dtype=np.float32):
    """Raw binary read (read_array, IOfunctionsGen.cc:214-230)."""
    data = np.fromfile(_with_dat(fname), dtype=dtype)
    if shape is not None:
        data = data.reshape(shape)
    return data


def read_powspec_table(fname):
    """2-column ascii k, P(k) (CAMB format, e.g. data/WMAP7_CAMB.dat);
    parity: readtab (calc_power.cc:31-66). Returns (k, P) float64 arrays."""
    data = np.loadtxt(fname)
    return data[:, 0].astype(np.float64), data[:, 1].astype(np.float64)


def dump_spectrum(fname, kmode, power):
    """2-column ascii spectrum dump (dump_measured_spec, IOfunctions.cc:20)."""
    p = Path(fname)
    p.parent.mkdir(parents=True, exist_ok=True)
    np.savetxt(p, np.column_stack([np.asarray(kmode), np.asarray(power)]))
    return p
