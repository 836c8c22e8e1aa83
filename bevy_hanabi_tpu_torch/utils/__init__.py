"""Auxiliary subsystems (port of ``bevy_hanabi_tpu/utils``): the
once-per-key warning path of ``diag.py``. Profiling, debug capture and
checkpointing are not ported."""

from .diag import logger, reset_warn_once, warn_once  # noqa: F401
