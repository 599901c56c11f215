"""Build and load the port's CUDA kernels.

The sources under `csrc/` are compiled by `nvcc` for `sm_90a` into one
shared library with a plain C interface and loaded with `ctypes` — no
PyTorch headers, so a build takes seconds.  It happens at first use, never
at import: the CPU tests import every module on machines without `nvcc`.

The library is named after a hash of the sources and flags, so a stale
build is never loaded.  It goes to `build/kernels/` beside the package (a
git-ignored directory).  Each source is
compiled by its own `nvcc`, all started together, then linked.  The
`-Xptxas -v` report (registers, shared memory, spills) is printed on the
build's first run and kept beside the library.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("tsc_deposit.cu", "tsc_deposit_stream.cu", "tsc_gather.cu")
HEADERS = ("tsc_common.cuh",)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + ("-O3", "-std=c++17", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of csrc/*.cu (pointers and the stream as void*)
SIGNATURES = {
    "tsc_deposit_window_launch":
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _I, _I, _I, _I,
         _P],
    "tsc_deposit_stream_launch":
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _I, _I, _I, _I, _I,
         _I, _P],
    "tsc_gather_grads_window_launch":
        [_P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _I, _I, _I, _I, _I, _P],
}


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    built: bool        # False when a library of the same hash was loaded
    seconds: float     # build time (0.0 when loaded)
    ptxas: str         # the -Xptxas -v report of the build


_loaded: tuple[ctypes.CDLL, BuildInfo] | None = None


def build_dir() -> Path:
    return CSRC.parents[1] / "build" / "kernels"


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, PyTorch's CUDA_HOME, or PATH."""
    homes = [os.environ.get("CUDA_HOME")]
    try:
        from torch.utils.cpp_extension import CUDA_HOME
        homes.append(CUDA_HOME)
    except ImportError:
        pass
    for home in homes:
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME, torch's CUDA_HOME and PATH); "
        "the CUDA kernels of barcode_tpu_torch cannot be built")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build(lib_path: Path) -> BuildInfo:
    nvcc = find_nvcc()
    out = lib_path.parent
    out.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    t0 = time.perf_counter()
    objs, procs = [], []
    for name in SOURCES:
        obj = out / f"{Path(name).stem}.{lib_path.stem}.{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *COMPILE_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports = [p.communicate()[0] for p in procs]
    for name, proc, report in zip(SOURCES, procs, reports):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{report}")
    tmp = out / f"{lib_path.name}.{tag}.tmp"
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                           *map(str, objs)],
                          capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    ptxas = "".join(reports)
    lib_path.with_suffix(".ptxas.txt").write_text(ptxas)
    os.replace(tmp, lib_path)  # atomic: a concurrent build never sees half
    seconds = time.perf_counter() - t0
    print(f"built {lib_path.name} in {seconds:.1f} s; ptxas report:\n{ptxas}",
          flush=True)
    return BuildInfo(lib_path, True, seconds, ptxas)


def load() -> tuple[ctypes.CDLL, BuildInfo]:
    """The kernel library (built on first use) and how it was obtained."""
    global _loaded
    if _loaded is None:
        lib_path = build_dir() / f"libbarcode_tsc_{source_hash()}.so"
        if lib_path.is_file():
            report = lib_path.with_suffix(".ptxas.txt")
            info = BuildInfo(lib_path, False, 0.0,
                             report.read_text() if report.is_file() else "")
        else:
            info = _build(lib_path)
        lib = ctypes.CDLL(str(lib_path))
        for fn, argtypes in SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.tsc_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tsc_cuda_error_string.restype = ctypes.c_char_p
        _loaded = (lib, info)
    return _loaded


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if status != 0:
        name = lib.tsc_cuda_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({name}) at launch")
