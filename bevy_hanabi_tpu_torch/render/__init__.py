"""Camera, extraction and the tile rasterizer."""

from .camera import CameraParams, look_at, perspective  # noqa: F401
from .extract import ParticleDrawData, extract_draw_data  # noqa: F401
from .raster import RasterConfig, rasterize  # noqa: F401
