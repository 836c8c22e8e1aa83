"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/*.cu`` source compiles with its own ``nvcc`` process, all
started together, and the objects link into one shared library with a
plain C interface, loaded with :mod:`ctypes`. The library goes to
``build/`` at the repository root (ignored by git), named by a hash of the
sources and flags, and is built on first use in the process: a fresh
checkout builds it in seconds, and an edited source rebuilds. Nothing is
compiled at import time.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.
The kernel wrappers share :func:`check_tensor`, :func:`current_stream` and
the :class:`Kernel` record that lists each kernel for ``chip_smoke.py``.
Run as a module, it times ``nvcc`` on the sources it is given
(:func:`time_sources`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable, NamedTuple

__all__ = [
    "build",
    "build_variants",
    "time_sources",
    "library",
    "bind",
    "find_nvcc",
    "check",
    "check_tensor",
    "current_stream",
    "Kernel",
    "BUILD_DIR",
    "NVCC_FLAGS",
    "SIGNATURES",
]

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"

# -fmad=false: no multiply-add contraction, so every kernel rounds op for op
# like its plain PyTorch version (the tile floors of project_bin depend on it).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    # (table, idx, out, n_out, n_table, F, stream)
    "hanabi_gather_rows": [_P, _P, _P, ctypes.c_longlong, _I, _I, _P],
    # (rows, pidx_sorted, starts, ends, window, has, nt, n_entries, n_rows, M, F, from_start,
    #  idx64, stream)
    "hanabi_gather_window": [_P, _P, _P, _P, _P, _P, _I, ctypes.c_longlong, ctypes.c_longlong,
                             _I, _I, _I, _I, _P],
    # (position, axis_x, axis_y, alive, color, extra, tile, depth, rows, range, n, row, params,
    #  ntx, nty, tile_slots, tile_span, base_row, roundness, tri, sprite, tex, uv, nrm, light,
    #  vcol, tex_width, stream)
    "hanabi_project_bin": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _I, _I, _I, _I,
                           _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    # (tile, depth, range, key, n, tile_shift, q_bits, idx_bits, far_first, stream)
    "hanabi_bin_keys": [_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _P],
    # (window, has, fb_in, depth_in, fb, depth_out, nt, M, T, ntx, background, eq,
    #  depth_test, write_depth, stream)
    "hanabi_tile_blend": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _I, _P],
    # (the same, then row, ap_i, ap_f, textures, before the stream; eq + 8 antialiases)
    "hanabi_tile_blend_appearance": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _I, _I,
                                     _P, _P, _P, _P],
    # (mask, count, payload, out_slot, out_count, out_payload, num_events, scratch, n, W, stream)
    "hanabi_event_compact": [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _P],
    # (mask, count, payload, out_slot, out_count, out_payload, num_events, I, n, W, stream)
    "hanabi_event_compact_segmented": [_P, _P, _P, _P, _P, _P, _P, _I, ctypes.c_longlong, _I, _P],
    # () -> lanes a CTA of event_compact scans at once
    "hanabi_event_compact_chunk": [],
    # (position, axis_x, axis_y, color, alive, geom, uv_t, nrm_t, vcol_t, pos_o, ax_o, ay_o,
    #  col_o, alive_o, tri_o, uv_o, nrm_o, vcol_o, n, q, t, stream)
    "hanabi_mesh_expand": [_P] * 18 + [ctypes.c_longlong, _I, _I, _P],
    # (alive, counter, ribbon_id, age, perm, key, n, stream)
    "hanabi_ribbon_keys": [_P, _P, _P, _P, _P, _P, ctypes.c_longlong, _P],
    # (position, axis_y, color, cutoff, perm1, perm2, key, camera, center, axis_x, side, valid,
    #  color_out, cutoff_out, n, stream)
    "hanabi_ribbon_segments": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               ctypes.c_longlong, _P],
    # (position, axis_y, color, cutoff, sprite, perm1, perm2, key, camera, center, axis_x, side,
    #  valid, color_out, cutoff_out, sprite_out, n, stream)
    "hanabi_ribbon_segments_sprite": [_P] * 16 + [ctypes.c_longlong, _P],
}


class Kernel(NamedTuple):
    """A CUDA kernel of the port: its wrapper (which counts its launches in
    ``wrapper.launches``), its plain PyTorch version, its source, and the
    TPU kernel (or XLA region of the JAX package) it replaces."""

    wrapper: Callable
    plain: Callable
    source: str
    replaces: str


def check_tensor(t, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def current_stream() -> int:
    """PyTorch's current CUDA stream, as the ``void*`` the C entry points take."""
    import torch

    return torch.cuda.current_stream().cuda_stream


def on_tensor_device(fn):
    """Run a kernel wrapper with the device of its first tensor argument made
    current. The C entry points launch on the CUDA runtime's current device,
    into :func:`current_stream` of it, so a tensor on another card (a shard
    of a mesh over several cards) makes that card current for the call."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        import torch

        t = next((a for a in args if isinstance(a, torch.Tensor)), None)
        if t is None or not t.is_cuda:
            return fn(*args, **kwargs)
        with torch.cuda.device(t.device):
            return fn(*args, **kwargs)

    return wrapper


def find_nvcc() -> str:
    """The ``nvcc`` of ``CUDA_HOME`` / ``CUDA_PATH``, else on ``PATH``, else PyTorch's CUDA home."""
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

    One ``nvcc -c`` per source runs in parallel, then one link. The
    compilers' report (registers, shared memory, spills per kernel) is kept
    beside the library as ``<name>.log``."""
    out = _library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    cu = [s for s in _sources() if s.suffix == ".cu"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [Path(tmpdir) / f"{s.stem}.o" for s in cu]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
            for s, o in zip(cu, objs)
        ]
        logs = [(s.name, p.communicate()[0], p.returncode) for s, p in zip(cu, procs)]
        report = "".join(f"== {name}\n{text}" for name, text, _ in logs)
        out.with_suffix(".log").write_text(report)
        failed = [name for name, _, rc in logs if rc != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{report}")
        tmp = Path(tmpdir) / out.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True,
            text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def time_sources(sources, repeat: int = 2) -> list:
    """Wall seconds of one ``nvcc -c`` of each source with :data:`NVCC_FLAGS`,
    alone and one after another, ``repeat`` rounds of all of them in turn:
    ``[(source, seconds), ...]``. For comparing a source's build time across
    versions on one machine; the objects go to a temporary directory."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        for _ in range(repeat):
            for src in sources:
                t0 = time.perf_counter()
                subprocess.run([nvcc, *NVCC_FLAGS, "-c", "-o", str(Path(tmpdir) / "t.o"), str(src)],
                               check=True, capture_output=True, text=True)
                out.append((str(src), time.perf_counter() - t0))
    return out


def build_variants(builds, name: str) -> dict:
    """Compile variant sources beside the library, for scripts that time a
    kernel against other versions of it.

    ``builds`` holds ``(label, source, extra nvcc flags)``; each build
    compiles with :data:`NVCC_FLAGS` and ``common.cu`` into
    ``build/variants/lib<name>_<label>.so``, one ``nvcc`` process a build,
    all started together. Returns ``{label: (library or None, compiler
    log)}``, the library bound by :func:`bind`, None where nvcc failed."""
    outdir = BUILD_DIR / "variants"
    outdir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    procs = []
    for label, src, flags in builds:
        so = outdir / f"lib{name}_{label.replace(',', '_')}.so"
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-shared", "-o", str(so), str(src),
               str(_CSRC / "common.cu")]
        procs.append((label, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)))
    out = {}
    for label, so, p in procs:
        log = p.communicate()[0]
        out[label] = (bind(ctypes.CDLL(str(so))) if p.returncode == 0 else None, log)
    return out


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Give every C entry point of :data:`SIGNATURES` that ``lib`` holds
    its argument and return types (a library built from some of the
    sources holds only theirs)."""
    for name, argtypes in SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.hanabi_error_string.argtypes = [ctypes.c_int]
    lib.hanabi_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    return bind(ctypes.CDLL(str(build())))


def check(code: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if code != 0:
        msg = library().hanabi_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed ({code}): {msg}")


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(
        description="Time nvcc on CUDA sources, each alone with the library's flags, in turns "
                    "(python3 -m bevy_hanabi_tpu_torch.cuda_build --time a.cu b.cu).")
    parser.add_argument("--time", nargs="+", required=True, metavar="SOURCE")
    parser.add_argument("--repeat", type=int, default=2)
    args = parser.parse_args()
    for src, seconds in time_sources(args.time, args.repeat):
        print(f"nvcc {src}: {seconds:.1f} s")
