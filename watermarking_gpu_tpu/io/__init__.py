"""Host-side IO: images, watermark matrices, configuration."""

from .config import Settings, load_settings
from .images import (SYNTHETIC_PREFIX, add_suffix_before_extension,
                     load_image_gray, load_image_rgb, save_image_u8,
                     synthetic_image_rgb)
from .matfile import (WatermarkFileError, generate_watermark, load_watermark,
                      save_watermark)

__all__ = [
    "SYNTHETIC_PREFIX", "Settings", "WatermarkFileError",
    "add_suffix_before_extension", "generate_watermark", "load_image_gray",
    "load_image_rgb", "load_settings", "load_watermark", "save_image_u8",
    "save_watermark", "synthetic_image_rgb",
]
