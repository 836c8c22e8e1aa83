"""Camera, extraction, the tile rasterizer and HDR post-processing."""

from .camera import CameraParams, camera_2d, look_at, orthographic, perspective  # noqa: F401
from .extract import ParticleDrawData, extract_draw_data  # noqa: F401
from .raster import RasterConfig, rasterize  # noqa: F401
from .post import bloom, tonemap_aces, tonemap_reinhard  # noqa: F401
from .renderer import EffectRenderer, composite_by_mode  # noqa: F401
