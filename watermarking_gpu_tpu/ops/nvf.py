"""NVF (Noise Visibility Function) perceptual mask.

Reference behavior (``/root/reference/Watermark_GPU/kernels/nvf.hpp:37-50``):
for each pixel, over a p x p clamp-to-edge window compute

    mean     = sum / p^2
    variance = sumSq / p^2 - mean^2
    mask     = variance / (1 + variance)

This module is the pure-XLA implementation, batch-polymorphic over leading
dims; XLA fuses the pad, the shifted window slices and the sums into one
loop fusion, so it needs no hand-written kernel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .neighbors import pad_edge


def nvf_mask(image: jnp.ndarray, p: int = 3) -> jnp.ndarray:
    """Local-variance visibility mask over a p x p window (p odd >= 3)."""
    pad = p // 2
    p2 = float(p * p)
    padded = pad_edge(image, pad)
    window = (1,) * (image.ndim - 2) + (p, p)
    strides = (1,) * image.ndim
    total = jax.lax.reduce_window(
        padded, 0.0, jax.lax.add, window_dimensions=window,
        window_strides=strides, padding="VALID")
    total_sq = jax.lax.reduce_window(
        padded * padded, 0.0, jax.lax.add, window_dimensions=window,
        window_strides=strides, padding="VALID")
    mean = total / p2
    variance = total_sq / p2 - mean * mean
    return variance / (1.0 + variance)
