"""An effect's generated step kernel (:mod:`..codegen`) on the card.

:class:`FusedStep` builds the source with ``nvcc`` (the library's flags,
``cuda_build.NVCC_FLAGS``: ``-fmad=false``, no fast math) into
``build/libhanabi_step-<hash>.so``, named by a hash of the source and the
flags, so a second run of the same asset compiles nothing; it loads the
library with :mod:`ctypes` and launches one frame of the step on the
current stream, writing the pool's tensors in place.

Feeding it takes no sync. A frame's scalars (the builtins) and a single
effect's words (spawn count, hashed frame seed, emitter transform, property
values) are launch arguments. A group's per-instance words are one
``[K, I, W]`` array uploaded once for a chunk of K frames (:meth:`stage`)
from pinned memory, and indexed by frame in the kernel. A property value
held as a tensor is written into the words on the card (a single effect's
words then go there too). The step takes one value an instance; a value of
another shape raises a ValueError.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Dict

import numpy as np
import torch

from .. import codegen, cuda_build
from ..ops import rng

__all__ = ["FusedStep", "build_library", "library_path"]

_DTYPES = {"f32": torch.float32, "i32": torch.int32, "u32": rng.U32, "bool": torch.bool}
_NP = {"f32": np.float32, "i32": np.int32, "u32": np.uint32, "bool": np.bool_}


def library_path(text: str, stem: str = "hanabi_step"):
    """Where :func:`build_library` keeps ``text``'s library: named by a
    hash of the source and the flags."""
    h = hashlib.sha256(text.encode())
    h.update(" ".join(cuda_build.NVCC_FLAGS).encode())
    return cuda_build.BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def build_library(text: str, stem: str = "hanabi_step"):
    """``text`` compiled with ``nvcc`` and the library's flags into
    :func:`library_path` (kept: a later call finds it), loaded."""
    out = library_path(text, stem)
    if not out.exists():
        cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as tmpdir:
            src = os.path.join(tmpdir, f"{stem}.cu")
            with open(src, "w") as fh:
                fh.write(text)
            tmp = os.path.join(tmpdir, out.name)
            run = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-shared", "-o",
                                  tmp, src], capture_output=True, text=True)
            out.with_suffix(".log").write_text(run.stdout + run.stderr)
            if run.returncode != 0:
                raise RuntimeError(f"nvcc failed on the generated step:\n{run.stdout}{run.stderr}")
            os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    lib = ctypes.CDLL(str(out))
    lib.hanabi_step_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong,
                                                               ctypes.c_void_p]
    lib.hanabi_step_launch.restype = ctypes.c_int
    lib.hanabi_step_scratch.argtypes = [ctypes.c_int, ctypes.c_longlong]
    lib.hanabi_step_scratch.restype = ctypes.c_int
    lib.hanabi_step_error_string.argtypes = [ctypes.c_int]
    lib.hanabi_step_error_string.restype = ctypes.c_char_p
    return lib


def _fit(slot: "codegen.PropertySlot", shape, lead: tuple) -> tuple:
    """The ``[*lead, lanes]`` shape of a value of ``shape`` for ``slot``:
    one value an instance, of the declared shape (leading axes of one
    dropped, as the eager step broadcasts them); else a ValueError."""
    want = lead + ((slot.lanes,) if slot.lanes > 1 else ())
    got = tuple(shape)
    while len(got) > len(want) and got[0] == 1:
        got = got[1:]
    if got != want:
        raise ValueError(f"property {slot.name!r}: the generated step takes one value an "
                         f"instance, of shape {want}; got {tuple(shape)}")
    return lead + (slot.lanes,)


def _host_words(kind: str, value, shape: tuple) -> np.ndarray:
    """A host value as uint32 words of ``kind``, converted as the eager
    step converts it (``EvalContext.const``)."""
    a = np.asarray(value).reshape(shape)
    if kind == "bool":
        return a.astype(np.bool_).astype(np.uint32)
    return np.ascontiguousarray(a.astype(_NP[kind])).view(np.uint32)


def _tensor_words(kind: str, value: torch.Tensor, shape: tuple, device) -> torch.Tensor:
    """A tensor value as int32 words of ``kind`` on ``device``, converted as
    the eager step converts it (``EvalContext.get_property``: ``.to(dtype)``)."""
    t = value.to(device).reshape(shape)
    if kind == "f32":
        return t.to(torch.float32).view(torch.int32)
    return t.to(_DTYPES[kind]).to(torch.int32)  # a u32's int64 keeps its low 32 bits


def _upload(words: np.ndarray, device) -> torch.Tensor:
    """``words`` on ``device``, copied from pinned memory: no wait on the card."""
    return torch.from_numpy(words.view(np.int32)).pin_memory().to(device, non_blocking=True)


class FusedStep:
    """The generated step of one asset: its source, its library (built on
    the first launch) and the kernels it launched (``launches``: one a
    frame up to 4096 lanes an instance, three above)."""

    def __init__(self, source: "codegen.StepSource") -> None:
        self.source = source
        self.launches = 0
        self._lib = None
        self._scratch: Dict[tuple, torch.Tensor] = {}

    def library(self):
        if self._lib is None:
            self._lib = build_library(self.source.text)
        return self._lib

    # -- words -----------------------------------------------------------

    def words(self, spawn_count, frame_seed, transform, properties, lead: tuple):
        """An instance's words for each index of ``lead`` (``()`` for a
        single effect, ``(I,)`` or ``(K, I)`` for a group): ``[*lead, W]``
        uint32 on the host, and the property values held as tensors, as
        ``(slot, value, shape)`` whose words :meth:`device_words` writes on
        the card. A value of another shape than one an instance raises."""
        src = self.source
        out = np.zeros(lead + (src.words,), np.uint32)
        out[..., 0] = np.asarray(spawn_count, np.int32).reshape(lead).view(np.uint32)
        seeds = np.asarray(frame_seed, np.uint32).reshape(lead).astype(np.int64)
        out[..., 1] = rng.pcg_hash(seeds).astype(np.uint32)
        if src.global_space:
            tf = np.asarray(transform, np.float32)
            tf = np.broadcast_to(tf, lead + (3, 4)).reshape(lead + (12,))
            out[..., 2:14] = tf.view(np.uint32)
        held = []
        for slot in src.properties:
            value = properties.get(slot.name)
            cols = slice(slot.offset, slot.offset + slot.lanes)
            if value is None:
                out[..., cols] = np.asarray(slot.default, np.uint32)
            elif isinstance(value, torch.Tensor):
                held.append((slot, value, _fit(slot, value.shape, lead)))
            else:
                out[..., cols] = _host_words(slot.kind, value, _fit(slot, np.shape(value), lead))
        return out, held

    def device_words(self, inputs, lead: tuple, device) -> torch.Tensor:
        """:meth:`words` of ``inputs`` on ``device`` as int32: one copy from
        pinned memory, which does not wait on the card, then each property
        value held as a tensor written into its words there."""
        host, held = self.words(inputs.spawn_count, inputs.frame_seed, inputs.transform,
                                inputs.properties, lead)
        out = _upload(host, device)
        for slot, value, shape in held:
            out[..., slot.offset:slot.offset + slot.lanes] = _tensor_words(slot.kind, value, shape,
                                                                           device)
        return out

    def stage(self, inputs_stacked, instances: int, device) -> torch.Tensor:
        """A group's ``[K, I, W]`` words for a chunk of K frames on
        ``device`` (:meth:`device_words`)."""
        k = len(np.asarray(inputs_stacked.spawn_count))
        return self.device_words(inputs_stacked, (k, instances), device)

    def _frame(self, sim, k: int, instances: int, words) -> np.ndarray:
        """The words of a ``struct Frame``."""
        head = np.array([sim.get(op) for op in codegen.FRAME_SCALARS], np.float32).view(np.uint32)
        w = np.zeros(self.source.words, np.uint32) if words is None else words
        return np.concatenate([head, np.array([k, instances], np.int32).view(np.uint32), w])

    # -- the pool --------------------------------------------------------

    def _own(self, pool, n: int, instances: int) -> None:
        """Make every tensor of ``pool`` one the kernel can write in place:
        contiguous, 16-byte aligned, of the field's dtype and alone in its
        storage (an eager step may leave a broadcast view, or two
        attributes on one storage)."""
        seen = set()

        def own(t, dtype, shape):
            ptr = t.untyped_storage().data_ptr()
            if (t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous()
                    or t.data_ptr() % 16 or ptr in seen):
                t = torch.empty(shape, dtype=dtype, device=t.device).copy_(t.expand(shape))
                ptr = t.untyped_storage().data_ptr()
            seen.add(ptr)
            return t

        for fd in self.source.fields:
            shape = (n,) if fd.lanes == 1 else (n, fd.lanes)
            pool.attrs[fd.name] = own(pool.attrs[fd.name], _DTYPES[fd.kind], shape)
        pool.alive = own(pool.alive, torch.bool, (n,))
        pool.seed = own(pool.seed, rng.U32, (n,))
        pool.counter = own(pool.counter, rng.U32, (instances,) if instances else ())

    def step(self, pool, inputs, sim, instances: int, staged=None):
        """One frame of ``pool`` (a single effect's, or a group's flat
        ``[I*N]`` view with ``instances`` > 0) in place; ``staged`` is
        ``(words, k)`` from :meth:`stage`. A single effect's words are
        launch arguments, unless a property value is a tensor: then they
        go to the card as a group's do. Returns the pool."""
        dev = pool.device
        n = pool.alive.shape[-1]
        words = None
        if staged is None:
            if instances > 0:
                staged = (self.device_words(inputs, (instances,), dev), 0)  # one frame: row 0
            else:
                words, held = self.words(inputs.spawn_count, inputs.frame_seed,
                                         inputs.transform, inputs.properties, ())
                if held:
                    staged, words = (self.device_words(inputs, (), dev), 0), None
        staged_words, k = (None, 0) if staged is None else staged
        lib = self.library()
        count = max(instances, 1)
        per = n // count
        self._own(pool, n, instances)
        key = (dev, count, per)
        scratch = self._scratch.get(key)
        if scratch is None:
            scratch = torch.empty((max(1, lib.hanabi_step_scratch(count, per)),), dtype=torch.int32,
                                  device=dev)
            self._scratch[key] = scratch
        tensors = [pool.attrs[fd.name] for fd in self.source.fields]
        tensors += [pool.alive, pool.seed, pool.counter]
        ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
        frame = self._frame(sim, k, count, words)
        with torch.cuda.device(dev):
            code = lib.hanabi_step_launch(
                ptrs, frame.ctypes.data, None if staged_words is None else staged_words.data_ptr(),
                scratch.data_ptr(), count, per, torch.cuda.current_stream(dev).cuda_stream)
        if code < 0:
            msg = lib.hanabi_step_error_string(-code).decode()
            raise RuntimeError(f"the generated step: CUDA launch failed ({-code}): {msg}")
        self.launches += code  # the kernels launched
        return pool
