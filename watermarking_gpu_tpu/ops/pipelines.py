"""End-to-end embed/detect pipelines as pure jittable functions.

These compose the ops in ``watermarking_gpu_tpu.ops`` into the exact observable
behavior of the reference engine
(``/root/reference/Watermark_GPU/Watermark.cpp:156-250``):

* ``embed_pipeline``  == ``Watermark::makeWatermark``
* ``detect_pipeline`` == ``Watermark::detectWatermark``

Everything is batch-polymorphic: images (H, W) or (B, H, W), outputs
optionally with a trailing channel axis, per-image solves/strengths/
correlations. Mask type is a static (trace-time) argument; the solve-failure
soft path is a traced per-image ``valid`` flag applied with ``jnp.where`` so
the functions stay fully jittable with no data-dependent Python control flow.
"""

from __future__ import annotations

from typing import Literal

import jax.numpy as jnp

from .correlation import correlation
from .embed import embed_watermark
from .me import (me_mask_from_error, me_normal_equations, prediction_error,
                 solve_coefficients, solve_coefficients_spd_vec)
from .nvf import nvf_mask

MaskTypeName = Literal["nvf", "me"]


def _to_f32(x: jnp.ndarray) -> jnp.ndarray:
    """Device-side cast. Integer inputs (video lumas) cross the host->device
    link 4x narrower as uint8 and widen to f32 here, inside jit — the
    device-side counterpart of the reference's pinned staging buffer
    (main.cpp:273-275)."""
    return x if x.dtype == jnp.float32 else x.astype(jnp.float32)


def _analysis(image: jnp.ndarray, p: int = 3):
    """Rx/rx accumulation + solve. Returns (coefficients, valid).

    ``p`` is the predictor window (3 in the reference; wider windows use the
    lag-decomposed Gram).
    """
    rx_matrix, rx_vector = me_normal_equations(image, p)
    if p == 3:
        return solve_coefficients(rx_matrix, rx_vector)
    # Generalized windows: the Gram is SPD; both batched LU (scalar
    # pivoting) and the n=8-style unrolled scalar Cholesky are
    # dispatch-bound at n=24. The masked vectorized Cholesky does n
    # column-stage tensor ops instead. p=3 keeps LU for the bit-stable
    # oracle the goldens pin.
    return solve_coefficients_spd_vec(rx_matrix, rx_vector)


def _gate(value: jnp.ndarray, valid: jnp.ndarray,
          fallback) -> jnp.ndarray:
    """where(valid, value, fallback) with valid (...,) vs value (..., H, W...)."""
    extra = value.ndim - valid.ndim
    return jnp.where(valid.reshape(valid.shape + (1,) * extra), value,
                     fallback)


def embed_pipeline(image: jnp.ndarray, output: jnp.ndarray,
                   watermark: jnp.ndarray, strength_factor_value: float,
                   mask_type: MaskTypeName, p: int = 3
                   ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Embed into `output` the watermark computed from grayscale `image`.

    Returns (watermarked, strengths). On an unsolvable ME system the output
    is returned unmodified and strength is 0 (Watermark.cpp:164-165).
    """
    image, output, watermark = map(_to_f32, (image, output, watermark))
    if mask_type == "me":
        coefficients, valid = _analysis(image, p)
        error = prediction_error(image, coefficients, p)
        mask = me_mask_from_error(error)
    else:
        mask = nvf_mask(image, p=p)
        valid = jnp.ones(image.shape[:-2], dtype=bool)
    watermarked, strength = embed_watermark(
        output, mask, watermark, strength_factor_value)
    watermarked = _gate(watermarked, valid, output)
    strength = jnp.where(valid, strength, 0.0)
    return watermarked, strength


def detect_pipeline(image: jnp.ndarray, watermark: jnp.ndarray,
                    mask_type: MaskTypeName, p: int = 3) -> jnp.ndarray:
    """Detector correlations for (possibly watermarked) grayscale images.

    NVF detection still runs the prediction-error analysis for the
    coefficients and error sequence, with the NVF mask replacing the ME mask
    (Watermark.cpp:238-241). Returns 0.0 where the system is unsolvable.
    """
    image, watermark = map(_to_f32, (image, watermark))
    # Predictor window: p for the ME mask's generalized predictor; the NVF
    # detector keeps the reference's fixed 3x3 predictor (p sizes only the
    # NVF variance window, Watermark.cpp:238-241).
    pred_p = p if mask_type == "me" else 3
    coefficients, valid = _analysis(image, pred_p)
    e_z = prediction_error(image, coefficients, pred_p)
    if mask_type == "me":
        mask = me_mask_from_error(e_z)
    else:
        mask = nvf_mask(image, p=p)
    u = mask * watermark
    e_u = prediction_error(u, coefficients, pred_p)
    corr = correlation(e_u, e_z)
    return jnp.where(valid, corr, 0.0)


def detect_many_pipeline(image: jnp.ndarray, watermarks: jnp.ndarray,
                         mask_type: MaskTypeName, p: int = 3) -> jnp.ndarray:
    """Watermark identification: which of N candidate matrices does an
    image carry? (..., H, W) images + (N, H, W) watermarks -> (..., N)
    correlations (batch-polymorphic like every pipeline).

    The image-dependent analysis — Gram, solve, error sequence ``e_z`` and
    mask — is computed ONCE per image and shared across all N candidates;
    each candidate then costs one masked prediction pass plus two
    reductions, all inside a single dispatch. The reference can only loop
    N full detections, re-running the whole analysis per call
    (``Watermark::detectWatermark``, Watermark.cpp:234-250). Returns zeros
    where the system is unsolvable (the usual soft-fail contract).
    """
    image, watermarks = map(_to_f32, (image, watermarks))
    n, rows, cols = watermarks.shape
    batch_shape = image.shape[:-2]
    pred_p = p if mask_type == "me" else 3
    coefficients, valid = _analysis(image, pred_p)
    e_z = prediction_error(image, coefficients, pred_p)
    if mask_type == "me":
        mask = me_mask_from_error(e_z)
    else:
        mask = nvf_mask(image, p=p)
    u = mask[..., None, :, :] * watermarks           # (..., N, H, W)
    coeffs_n = jnp.broadcast_to(
        coefficients[..., None, :],
        batch_shape + (n, coefficients.shape[-1]))
    e_u = prediction_error(u, coeffs_n, pred_p)
    dot = jnp.sum(e_u * e_z[..., None, :, :], axis=(-2, -1))
    norm_u = jnp.sqrt(jnp.sum(e_u * e_u, axis=(-2, -1)))
    norm_z = jnp.sqrt(jnp.sum(e_z * e_z, axis=(-2, -1)))
    corr = dot / (norm_u * norm_z[..., None])
    return jnp.where(valid[..., None], corr, 0.0)
