"""Native (C++) host runtime: spawner banks and slab allocation via ctypes
(port of ``bevy_hanabi_tpu/native``).

The reference's host-side runtime (spawner ticking spawn.rs:838-921, slab
sub-allocation effect_cache.rs:482-612) is Rust; ``src/hanabi_native.cpp``
(the JAX package's source, byte for byte) provides the same components in
C++ with a C ABI, loaded through ctypes. No device code is involved.

The shared library is compiled with ``g++`` on first use in the process,
never at import, into ``build/`` at the repository root (ignored by git),
named by a hash of the source and flags as :mod:`..cuda_build` names the
kernel library; nothing is written next to the source. Where ``g++`` is not
on ``PATH``, :func:`load_native` returns None: spawner banks are then the
numpy :class:`~..spawn.SpawnerBank` and :class:`SlabAllocator` runs its
Python mirror. A ``g++`` that fails to compile raises with its output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..cuda_build import BUILD_DIR

__all__ = ["load_native", "native_available", "NativeSpawnerBank", "NO_SPACE", "SlabAllocator"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_SRC = Path(__file__).resolve().parent / "src" / "hanabi_native.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libhanabi_native-{h.hexdigest()[:16]}.so"


def _build(cxx: str) -> Path:
    """Compile the source into ``build/`` unless the library is there."""
    out = _library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = Path(tmpdir) / out.name
        proc = subprocess.run([cxx, *CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build the native runtime:\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32, i32, u32 = ctypes.c_float, ctypes.c_int32, ctypes.c_uint32
    lib.hanabi_spawner_bank_create.restype = ctypes.c_void_p
    lib.hanabi_spawner_bank_create.argtypes = [i32, f32, f32, f32, f32, f32, f32, u32, i32, i32,
                                               ctypes.c_uint64]
    lib.hanabi_spawner_bank_destroy.argtypes = [ctypes.c_void_p]
    lib.hanabi_spawner_bank_reset.argtypes = [ctypes.c_void_p, i32]
    lib.hanabi_spawner_bank_set_active.argtypes = [ctypes.c_void_p, i32, i32]
    lib.hanabi_spawner_bank_tick.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                             ctypes.POINTER(i32)]
    lib.hanabi_slab_create.restype = ctypes.c_void_p
    lib.hanabi_slab_create.argtypes = [u32]
    lib.hanabi_slab_destroy.argtypes = [ctypes.c_void_p]
    lib.hanabi_slab_alloc.restype = u32
    lib.hanabi_slab_alloc.argtypes = [ctypes.c_void_p, u32]
    lib.hanabi_slab_free.restype = i32
    lib.hanabi_slab_free.argtypes = [ctypes.c_void_p, u32, u32]
    for name in ("hanabi_slab_used", "hanabi_slab_capacity", "hanabi_slab_num_free_ranges",
                 "hanabi_slab_largest_free"):
        fn = getattr(lib, name)
        fn.restype = u32
        fn.argtypes = [ctypes.c_void_p]
    return lib


def load_native() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; None where no ``g++`` is on
    ``PATH``. Raises where ``g++`` fails to build it."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            cxx = shutil.which("g++")
            if cxx is None:
                return None
            _LIB = _bind(ctypes.CDLL(str(_build(cxx))))
        return _LIB


def native_available() -> bool:
    return load_native() is not None


class NativeSpawnerBank:
    """C++ spawner bank: N state machines ticked in one native pass, each
    with its own PCG32 stream for ``CpuValue.uniform`` settings."""

    def __init__(self, settings, num_instances: int, seed: int = 0):
        lib = load_native()
        if lib is None:
            raise RuntimeError("the native runtime needs g++ on PATH")
        self._lib = lib
        self.n = num_instances
        c_lo, c_hi = settings.count.range()
        d_lo, d_hi = settings.spawn_duration.range()
        p_lo, p_hi = settings.period.range()
        self._handle = lib.hanabi_spawner_bank_create(
            num_instances, float(c_lo), float(c_hi), float(d_lo), float(d_hi), float(p_lo),
            float(p_hi), int(settings.cycle_count), 1 if settings.starts_active else 0,
            1 if settings.emit_on_start else 0, int(seed) & 0xFFFFFFFFFFFFFFFF,
        )
        if not self._handle:
            raise RuntimeError("failed to create native spawner bank")
        self._out = np.zeros(num_instances, np.int32)

    def tick(self, dt: float) -> np.ndarray:
        """Tick all spawners; returns int32[I] spawn counts."""
        self._lib.hanabi_spawner_bank_tick(
            self._handle, ctypes.c_double(dt),
            self._out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return self._out.copy()

    def reset(self, index: int = -1) -> None:
        self._lib.hanabi_spawner_bank_reset(self._handle, index)

    def set_active(self, active: bool, index: int = -1) -> None:
        self._lib.hanabi_spawner_bank_set_active(self._handle, index, 1 if active else 0)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.hanabi_spawner_bank_destroy(self._handle)


NO_SPACE = 0xFFFFFFFF


class SlabAllocator:
    """Row-range allocator over a shared particle pool (EffectCache analogue).

    Native best-fit free list with coalescing; a Python mirror with the
    same behaviour where no ``g++`` is on ``PATH``.
    """

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        lib = load_native()
        self._lib = lib
        if lib is not None:
            self._handle = lib.hanabi_slab_create(self.capacity)
        else:
            self._handle = None
            self._free = {0: self.capacity}  # offset -> size
            self._used = 0

    def alloc(self, size: int) -> Optional[int]:
        """Allocate ``size`` rows; returns row offset or None."""
        if self._handle is not None:
            off = self._lib.hanabi_slab_alloc(self._handle, int(size))
            return None if off == NO_SPACE else int(off)
        if size <= 0:
            return None
        best = None
        for off, sz in self._free.items():
            if sz >= size and (best is None or sz < self._free[best]):
                best = off
        if best is None:
            return None
        sz = self._free.pop(best)
        if sz > size:
            self._free[best + size] = sz - size
        self._used += size
        return best

    def free(self, offset: int, size: int) -> None:
        if self._handle is not None:
            rc = self._lib.hanabi_slab_free(self._handle, int(offset), int(size))
            if rc != 0:
                raise ValueError(f"invalid free({offset}, {size}): rc={rc}")
            return
        if offset + size > self.capacity or size <= 0:
            raise ValueError(f"invalid free({offset}, {size})")
        for off, sz in self._free.items():
            if off < offset + size and offset < off + sz:
                raise ValueError(f"double free at {offset}")
        self._free[offset] = size
        merged = []  # coalesce
        for off, sz in sorted(self._free.items()):
            if merged and merged[-1][0] + merged[-1][1] == off:
                merged[-1] = (merged[-1][0], merged[-1][1] + sz)
            else:
                merged.append((off, sz))
        self._free = dict(merged)
        self._used -= size

    @property
    def used(self) -> int:
        if self._handle is not None:
            return int(self._lib.hanabi_slab_used(self._handle))
        return self._used

    @property
    def largest_free(self) -> int:
        if self._handle is not None:
            return int(self._lib.hanabi_slab_largest_free(self._handle))
        return max(self._free.values(), default=0)

    def num_free_ranges(self) -> int:
        if self._handle is not None:
            return int(self._lib.hanabi_slab_num_free_ranges(self._handle))
        return len(self._free)

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self._lib.hanabi_slab_destroy(self._handle)
