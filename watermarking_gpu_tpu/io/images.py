"""Image file IO.

The reference loads PNGs with ``af::loadImage(file, true)`` (float RGB on the
0..255 range, ``/root/reference/Watermark_GPU/main.cpp:153``) and saves
watermarked outputs as u8 with ``af::saveImageNative`` after a plain cast
(``main.cpp:235-237``). We mirror both: float32 0..255 in, truncating u8 cast
out (values are already clamped to [0, 255] by the embedder).

Pillow is imported inside the functions that read or write image files, so
importing the package and running the engines needs only JAX and NumPy.
"""

from __future__ import annotations

import os

import numpy as np


SYNTHETIC_PREFIX = "synthetic:"


def synthetic_image_rgb(width: int, height: int, seed: int) -> np.ndarray:
    """A structured float32 (H, W, 3) image on 0..255 made from ``seed``:
    smooth gradients and ripples plus noise, so the prediction-error
    system is well conditioned like a natural frame."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    base = (128.0 + 60.0 * np.sin(xx / 37.0) * np.cos(yy / 23.0)
            + 40.0 * (xx / max(width, 1) - yy / max(height, 1)))
    channels = [base + rng.normal(0.0, 12.0, (height, width))
                for _ in range(3)]
    return np.clip(np.stack(channels, axis=-1), 0.0, 255.0).astype(
        np.float32)


def load_image_rgb(path: str | os.PathLike) -> np.ndarray:
    """Load an image as float32 (H, W, 3) on 0..255.

    ``synthetic:WxH:SEED`` makes one with ``synthetic_image_rgb`` instead
    of reading a file.
    """
    spec = os.fspath(path)
    if spec.startswith(SYNTHETIC_PREFIX):
        try:
            size, seed = spec[len(SYNTHETIC_PREFIX):].split(":")
            width, height = (int(v) for v in size.lower().split("x"))
            return synthetic_image_rgb(width, height, int(seed))
        except ValueError:
            raise ValueError(f"expected {SYNTHETIC_PREFIX}WxH:SEED, "
                             f"got {spec!r}") from None
    from PIL import Image

    with Image.open(path) as img:
        rgb = img.convert("RGB")
        return np.asarray(rgb, dtype=np.float32)


def load_image_gray(path: str | os.PathLike) -> np.ndarray:
    """Load an image and return BT.601 luma as float32 (H, W) on 0..255."""
    rgb = load_image_rgb(path)
    weights = np.array([0.299, 0.587, 0.114], dtype=np.float32)
    return rgb @ weights


def save_image_u8(path: str | os.PathLike, image: np.ndarray) -> None:
    """Save a float image (H, W) or (H, W, 3) as 8-bit, truncating cast."""
    from PIL import Image

    arr = np.asarray(image)
    u8 = arr.astype(np.uint8)  # truncation, matching af::array::as(u8)
    Image.fromarray(u8).save(path)


def add_suffix_before_extension(path: str, suffix: str) -> str:
    """'img.png', '_W_NVF' -> 'img_W_NVF.png' (Utilities.cpp:7-11)."""
    root, ext = os.path.splitext(path)
    return f"{root}{suffix}{ext}"
