"""Profiling and debug-capture hooks (port of ``bevy_hanabi_tpu/utils/profiling.py``).

The reference gates ``info_span!`` tracing behind a cargo feature and drives
GPU captures from a ``DebugSettings`` resource (render/mod.rs:2425-2533).
Here a span is a ``torch.profiler.record_function`` (visible in a
``torch.profiler`` trace) plus an NVTX range on a CUDA device, and a
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

__all__ = ["profile_span", "DebugSettings"]


@contextlib.contextmanager
def profile_span(name: str, device=None):
    """Annotate a host+device span (≈ bevy info_span! + GPU debug group);
    on a CUDA ``device`` also an NVTX range."""
    nvtx = device is not None and torch.device(device).type == "cuda"
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def _default_capture_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "hanabi_torch_trace")


@dataclass
class DebugSettings:
    """Capture control (reference: DebugSettings, render/mod.rs:2425-2463).

    Set ``start_capture_this_frame`` (or ``start_capture_on_new_effect``) and
    attach to a :class:`~bevy_hanabi_tpu_torch.runtime.HanabiScene`; the
    scene starts a ``torch.profiler`` session at the next update and stops
    it after ``capture_frame_count`` frames, writing a Chrome trace
    (``trace_<n>.json``) into ``capture_dir``.

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
        should_start = self.start_capture_this_frame or (
            self.start_capture_on_new_effect and new_effect_added
        )
        if should_start and not self._active:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.__enter__()
            self._active = True
            self._frames_remaining = max(1, int(self.capture_frame_count))
        self.start_capture_this_frame = False

    def on_frame_end(self) -> None:
        if not self._active:
            return
        self._frames_remaining -= 1
        if self._frames_remaining <= 0:
            prof, self._profiler = self._profiler, None
            prof.__exit__(None, None, None)
            self._active = False
            os.makedirs(self.capture_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(self.capture_dir, f"trace_{self._captures}.json"))
            self._captures += 1

    @property
    def is_capturing(self) -> bool:
        return self._active
