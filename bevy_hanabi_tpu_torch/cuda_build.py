"""Build and load the hand-written CUDA kernels in ``csrc/``.

All ``csrc/*.cu`` sources compile with ``nvcc`` into one shared library
with a plain C interface, loaded with :mod:`ctypes`. The library goes to
``build/`` at the repository root (ignored by git), named by a hash of the
sources and flags, and is built on first use in the process: a fresh
checkout builds it in seconds, and an edited source rebuilds. Nothing is
compiled at import time.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["build", "library", "check", "BUILD_DIR", "NVCC_FLAGS"]

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"

# -fmad=false: no multiply-add contraction, so every kernel rounds op for op
# like its plain PyTorch version (the tile floors of project_bin depend on it).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # (table, idx, out, n_out, n_table, F, stream)
    "hanabi_gather_rows": [_P, _P, _P, ctypes.c_longlong, _I, _I, _P],
    # (position, axis_x, axis_y, alive, color, tile, depth, rows, n, params, ntx, nty, stream)
    "hanabi_project_bin": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _P],
    # (window, has, fb, nt, M, T, ntx, background, stream)
    "hanabi_tile_blend": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _library_path() -> Path:
    return BUILD_DIR / f"libhanabi_kernels-{_digest()}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` into the library unless it already exists.

    The compiler's report (registers, shared memory, spills per kernel) is
    kept beside the library as ``<name>.log``."""
    out = _library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in _sources() if s.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu],
            capture_output=True,
            text=True,
        )
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.hanabi_error_string.argtypes = [ctypes.c_int]
    lib.hanabi_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if code != 0:
        msg = library().hanabi_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed ({code}): {msg}")
