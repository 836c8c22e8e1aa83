"""Profiling and debug-capture hooks (port of ``bevy_hanabi_tpu/utils/profiling.py``).

The reference gates ``info_span!`` tracing behind a cargo feature and drives
GPU captures from a ``DebugSettings`` resource (render/mod.rs:2425-2533).
Here a span is a ``torch.profiler.record_function`` range, entered only
while a profiler session is active, so it lands on the profiler's timeline
beside the device's activity (and is an NVTX range under ``emit_nvtx``); a
whole-frame capture is a ``torch.profiler`` session written as a Chrome
trace into ``capture_dir``, triggered by the same DebugSettings knobs.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from dataclasses import dataclass, field
from typing import Any

import torch
from torch.autograd import _profiler_enabled

__all__ = ["profile_span", "DebugSettings", "SPANS"]

# The program's spans, one a layer: readers of a trace match these exact
# names, so a span's name carries no detail such as an effect's name.
SPANS = (
    "hanabi:chunk",  # a K-frame step_chunk / step_render_chunk call
    "hanabi:step",  # one frame's step: spawn, init, update, the inputs' uploads
    "hanabi:extract",  # draw data from a pool; the painter's and batches' merges
    "hanabi:raster",  # rasterize: project_bin, the sort, gather_window, tile_blend
    "hanabi:sort",  # sort_tiles, inside hanabi:raster
    "hanabi:update",  # HanabiScene.update
    "hanabi:render",  # HanabiScene.render
    "hanabi:cull",  # the scene's frustum culling and its AABB readback
    "hanabi:plan",  # the scene's render plan
    "hanabi:spawn",  # the scene's spawner and spawner-bank ticks
)


_OFF = contextlib.nullcontext()  # shared: entering and leaving it does nothing


def profile_span(name: str):
    """Annotate a host+device span (≈ bevy info_span! + GPU debug group):
    a ``with`` block that is a ``torch.profiler.record_function`` range
    named ``name`` while a profiler session is active, and otherwise does
    nothing at the cost of one flag check (``record_function`` itself costs
    ~10 us a range even with no session). The NVTX range is behind the same
    check: under ``torch.autograd.profiler.emit_nvtx()`` every span's range
    is an NVTX range; an NVTX push and pop of its own cost 0.47 us a span
    with no tool attached (an H100 machine's host)."""
    return torch.profiler.record_function(name) if _profiler_enabled() else _OFF


def _default_capture_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "hanabi_torch_trace")


@dataclass
class DebugSettings:
    """Capture control (reference: DebugSettings, render/mod.rs:2425-2463).

    Set ``start_capture_this_frame`` (or ``start_capture_on_new_effect``) and
    attach to a :class:`~bevy_hanabi_tpu_torch.runtime.HanabiScene`; the
    scene starts a ``torch.profiler`` session at the next update and stops
    it after ``capture_frame_count`` frames, writing a Chrome trace
    (``trace_<n>.json``) into ``capture_dir``. A frame runs from one
    ``update`` to the next, so it holds that frame's ``render``: the
    capture stops at the start of the update after its last frame.

    ``validate=True`` (≈ the reference running wgpu VALIDATION in debug and
    test builds, test_utils.rs:150) steps the scene through checked steps:
    every gather whose index comes from data is bound-checked before it is
    made, and what each step produces is checked for non-finite floats, so
    a poison read (0xFFFFFFFF == f32 NaN, effect_cache.rs:270-296) raises
    at the frame that consumed it. Each checked step or chunk reads back
    once; ``render`` additionally asserts a finite framebuffer. Nothing of
    it is built or run while ``validate`` is False.
    """

    start_capture_this_frame: bool = False
    start_capture_on_new_effect: bool = False
    capture_frame_count: int = 1
    capture_dir: str = field(default_factory=_default_capture_dir)
    validate: bool = False

    # internal
    _frames_remaining: int = field(default=0, repr=False)
    _active: bool = field(default=False, repr=False)
    _profiler: Any = field(default=None, repr=False)
    _captures: int = field(default=0, repr=False)

    def on_frame_start(self, new_effect_added: bool) -> None:
        """A frame starts (the scene's ``update``): the frame before it
        ends, then a capture asked for starts."""
        if self._active:
            self.on_frame_end()
        should_start = self.start_capture_this_frame or (
            self.start_capture_on_new_effect and new_effect_added
        )
        if should_start and not self._active:
            os.makedirs(self.capture_dir, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.__enter__()
            self._active = True
            self._frames_remaining = max(1, int(self.capture_frame_count))
        self.start_capture_this_frame = False

    def on_frame_end(self) -> None:
        """A captured frame ends; after the last one the trace is written."""
        if not self._active:
            return
        self._frames_remaining -= 1
        if self._frames_remaining <= 0:
            prof, self._profiler = self._profiler, None
            prof.__exit__(None, None, None)
            self._active = False
            prof.export_chrome_trace(os.path.join(self.capture_dir, f"trace_{self._captures}.json"))
            self._captures += 1

    @property
    def is_capturing(self) -> bool:
        return self._active
