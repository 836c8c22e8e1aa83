"""Auxiliary subsystems (port of ``bevy_hanabi_tpu/utils``): profiling
spans and debug capture, scene checkpointing, and the once-per-key warning
path of ``diag.py``."""

from .profiling import DebugSettings, profile_span  # noqa: F401
from .checkpoint import load_scene_state, save_scene_state  # noqa: F401
from .diag import logger, reset_warn_once, warn_once  # noqa: F401
