"""Runtime diagnostics: the framework's warn/log path.

The reference logs footguns through bevy_log — most importantly the
per-frame recompile-invalidation warning (reference: src/lib.rs:1796, "Effect
asset changed, invalidating compiled effect") — and this module is the
equivalent: a stdlib ``logging`` logger plus once-per-key warning helpers so
hot loops can call them every frame without log spam.

Enable output the normal Python way::

    import logging
    logging.getLogger("bevy_hanabi_tpu").setLevel(logging.WARNING)
    logging.basicConfig()
"""

from __future__ import annotations

import logging
from typing import Set

__all__ = ["logger", "warn_once", "reset_warn_once"]

logger = logging.getLogger("bevy_hanabi_tpu")

_seen: Set[str] = set()


def warn_once(key: str, message: str) -> None:
    """Log ``message`` at WARNING level, once per unique ``key``."""
    if key in _seen:
        return
    _seen.add(key)
    logger.warning(message)


def reset_warn_once() -> None:
    """Clear the once-per-key memory (tests)."""
    _seen.clear()
