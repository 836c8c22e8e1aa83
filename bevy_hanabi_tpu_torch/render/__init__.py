"""Camera, extraction and the tile rasterizer."""

from .camera import CameraParams, look_at, orthographic, perspective  # noqa: F401
from .extract import ParticleDrawData, extract_draw_data  # noqa: F401
from .raster import RasterConfig, rasterize  # noqa: F401
from .renderer import EffectRenderer, composite_by_mode  # noqa: F401
