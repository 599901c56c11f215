"""Debug utilities — array statistics and quick field dumps.

Port of barcode_tpu/utils/debug.py (parity: the reference's
barlib/src/debug.cc:19-311, debug_array_statistics and debug_scalar_dump).
Every function takes a tensor on any device or a numpy array.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def _host(arr) -> np.ndarray:
    """A numpy array of `arr` (a tensor on any device, or array-like)."""
    if torch.is_tensor(arr):
        t = arr.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(arr)


def array_statistics(arr, name: str = "") -> dict:
    """min/max/mean/std/NaN count of a field (debug_array_statistics)."""
    a = _host(arr)
    finite = np.isfinite(a)
    stats = {
        "name": name,
        "shape": a.shape,
        "min": float(a[finite].min()) if finite.any() else float("nan"),
        "max": float(a[finite].max()) if finite.any() else float("nan"),
        "mean": float(a[finite].mean()) if finite.any() else float("nan"),
        "std": float(a[finite].std()) if finite.any() else float("nan"),
        "n_nonfinite": int((~finite).sum()),
    }
    return stats


def print_array_statistics(arr, name: str = "") -> None:
    s = array_statistics(arr, name)
    print(f"[{s['name']}] shape={s['shape']} min={s['min']:.4g} "
          f"max={s['max']:.4g} mean={s['mean']:.4g} std={s['std']:.4g}"
          + (f" NONFINITE={s['n_nonfinite']}" if s["n_nonfinite"] else ""))


def quick_dump_scalar(arr, out_dir, name: str, iteration: int = 0,
                      with_spectrum: bool = False, grid=None, nbin: int = 64):
    """Field snapshot (+ optionally its spectrum, measured on the array's
    own device) for debugging (debug_scalar_dump / quick_dump_scalar)."""
    from barcode_tpu_torch import io as bio

    out_dir = Path(out_dir)
    path = bio.write_array(out_dir / f"{name}_{iteration}", _host(arr))
    if with_spectrum and grid is not None:
        from barcode_tpu_torch.grid import fourier

        x = arr if torch.is_tensor(arr) else torch.from_numpy(_host(arr))
        km, pw, _ = fourier.measure_spectrum(x.detach(), grid, nbin)
        bio.dump_spectrum(out_dir / f"{name}_{iteration}_spec.dat",
                          _host(km), _host(pw))
    return path
