"""Watermarking engines (model families: NVF mask, Prediction-Error mask)."""

from .batched import BatchedWatermark, batch_detect, batch_embed
from .masks import MaskType
from .watermark import Watermark

__all__ = ["BatchedWatermark", "MaskType", "Watermark", "batch_detect",
           "batch_embed"]
