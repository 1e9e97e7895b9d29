"""Compute ops for spread-spectrum watermarking.

Plain jnp/lax implementations left to XLA; they double as correctness
oracles for the one hand-written kernel, the p=3 Gram through Triton
(``ops/gram_triton.py``).
"""

from .color import rgb_to_gray
from .correlation import correlation
from .embed import embed_watermark, strength_factor
from .me import (me_mask_from_error, me_normal_equations, predict,
                 prediction_error, solve_coefficients)
from .neighbors import NEIGHBOR_OFFSETS, NUM_NEIGHBORS, neighbor_stack, pad_edge
from .nvf import nvf_mask
from .pipelines import detect_pipeline, embed_pipeline

__all__ = [
    "NEIGHBOR_OFFSETS", "NUM_NEIGHBORS", "correlation", "detect_pipeline",
    "embed_pipeline", "embed_watermark", "me_mask_from_error",
    "me_normal_equations", "neighbor_stack", "nvf_mask", "pad_edge",
    "predict", "prediction_error", "rgb_to_gray", "solve_coefficients",
    "strength_factor",
]
