"""Sharding over a mesh of devices, driven by one process."""

from .mesh import Mesh, ShardedEffect, make_mesh  # noqa: F401
from .render import ShardedRenderer  # noqa: F401
