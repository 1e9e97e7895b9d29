"""Batched (multi-frame) embed/detect pipelines.

The reference processes video frames one at a time through a single in-order
queue (reference ``Watermark_GPU/main.cpp:319-340``). Here frames batch
on a leading axis: one dispatch embeds or detects B frames, amortizing host
dispatch and keeping the device busy — per-frame Rx/rx solves become one
batched k×k solve (k = p²−1: 8 for the reference's p=3 predictor, 24/48/80
for the generalized windows).

These are plain jittable functions; ``BatchedWatermark`` wraps them with the
same engine ergonomics as ``Watermark``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.pipelines import detect_pipeline, embed_pipeline
from .masks import MaskType
from .watermark import Watermark, as_device_input


def batch_embed(images: jnp.ndarray, outputs: jnp.ndarray,
                watermark: jnp.ndarray, strength_factor_value: float,
                mask_type: str, p: int = 3) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Embed into (B, H, W[, C]) frames. Watermark matrix is shared.

    The pipelines are natively batch-polymorphic (no vmap).
    """
    return embed_pipeline(images, outputs, watermark, strength_factor_value,
                          mask_type=mask_type, p=p)


def batch_detect(images: jnp.ndarray, watermark: jnp.ndarray,
                 mask_type: str, p: int = 3) -> jnp.ndarray:
    """Detector correlations for (B, H, W) frames -> (B,) scalars."""
    return detect_pipeline(images, watermark, mask_type=mask_type, p=p)


def pad_to_batch(stack: np.ndarray, batch_size: int) -> np.ndarray:
    """Pad a partial (B, ...) stack to ``batch_size`` frames by repeating
    the last real frame, so every dispatch reuses the one compiled
    (batch, H, W) program; callers slice results back to the real count.
    Shared by the serving and video batchers.
    """
    short = batch_size - stack.shape[0]
    if short <= 0:
        return stack
    return np.concatenate([stack, np.repeat(stack[-1:], short, axis=0)])


def batch_embed_luma_u8(lumas: jnp.ndarray, watermark: jnp.ndarray,
                        strength_factor_value: float, mask_type: str,
                        p: int = 3) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Video ingest/egress path: (B, H, W) uint8 lumas in, uint8 out.

    The u8->f32 widening and the truncating f32->u8 cast both happen on
    device, so frames cross the host<->device link at 1 byte/pixel in each
    direction — the reference's analog is the pinned-buffer upload +
    ``.as(u8)`` download (``main.cpp:355,379``).
    """
    marked, strength = embed_pipeline(
        lumas, lumas, watermark, strength_factor_value,
        mask_type=mask_type, p=p)
    return marked.astype(jnp.uint8), strength


class BatchedWatermark(Watermark):
    """A ``Watermark`` engine whose embed/detect take (B, H, W) frame stacks."""

    def _batched_fn(self, name: str, fn, mask_type: MaskType, **static):
        key = (name, mask_type)
        jitted = self._fn_cache.get(key)
        if jitted is None:
            jitted = jax.jit(partial(fn, mask_type=mask_type.value,
                                     p=self.p, **static))
            self._fn_cache[key] = jitted
        return jitted

    def embed(self, images, outputs=None,
              mask_type: "MaskType | str" = MaskType.ME):
        mask_type = MaskType.parse(mask_type)
        images = as_device_input(images)
        self._check_dims(images[0])
        outputs = images if outputs is None else as_device_input(outputs)
        fn = self._batched_fn("batch_embed", batch_embed, mask_type,
                              strength_factor_value=self.strength_factor)
        return fn(images, outputs, self.random_matrix)

    def embed_luma_u8(self, lumas, mask_type: "MaskType | str" = MaskType.ME):
        """(B, H, W) uint8 lumas -> (uint8 watermarked, strengths).

        Transfers stay uint8 both ways (see batch_embed_luma_u8)."""
        mask_type = MaskType.parse(mask_type)
        lumas = jnp.asarray(lumas)
        self._check_dims(lumas[0])
        fn = self._batched_fn("batch_embed_u8", batch_embed_luma_u8,
                              mask_type,
                              strength_factor_value=self.strength_factor)
        return fn(lumas, self.random_matrix)

    def detect(self, images, mask_type: "MaskType | str" = MaskType.ME):
        mask_type = MaskType.parse(mask_type)
        images = as_device_input(images)
        self._check_dims(images[0])
        fn = self._batched_fn("batch_detect", batch_detect, mask_type)
        return fn(images, self.random_matrix)
