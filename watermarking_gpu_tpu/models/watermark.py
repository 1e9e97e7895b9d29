"""The flagship watermarking engine.

JAX re-design of the reference ``Watermark`` class
(``/root/reference/Watermark_GPU/Watermark.hpp:26-72``): same public contract
(constructor with dims/watermark-path/p/psnr, ``embed`` == ``makeWatermark``,
``detect`` == ``detectWatermark``, ``reinitialize``) but a functional core —
each (shape, mask type) gets one jit-compiled XLA program, the watermark
matrix lives in device memory once, and there is no per-call host round trip
beyond the scalar results.

Recompilation discipline: one jit cache entry per image shape, mirroring the
reference's per-shape pre-allocated state and ``reinitialize`` contract
(``Watermark.cpp:78-85``).
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..io.matfile import generate_watermark, load_watermark
from ..ops.embed import strength_factor
from ..ops.pipelines import (detect_many_pipeline, detect_pipeline,
                             embed_pipeline)
from .masks import MaskType

_VALID_P = (3, 5, 7, 9)


def as_device_input(x) -> jnp.ndarray:
    """Move an image to the device in its transfer dtype.

    uint8 arrays stay uint8 so the host->device copy is 4x narrower (the
    pipelines cast to f32 on device); everything else becomes f32 on the
    host, preserving the previous semantics.
    """
    x = jnp.asarray(x)
    return x if x.dtype == jnp.uint8 else x.astype(jnp.float32)


class Watermark:
    """Embeds and detects additive spread-spectrum watermarks.

    Parameters mirror the reference constructor (``Watermark.cpp:21-27``):

    rows, cols : image dimensions this engine is specialized for.
    watermark  : path to a raw float32 ``.dat`` file, a numpy/JAX array of
                 shape (rows, cols), or an integer seed to generate one.
    p          : mask window size (3, 5, 7 or 9). The reference rejects
                 p != 3 for the prediction-error mask (``main.cpp:88-89``,
                 "TODO for p>3 we have problems with ME masking buffers");
                 here ME generalizes to the (p*p-1)-tap predictor.
    psnr       : target embedding PSNR in dB (> 0).
    """

    def __init__(self, rows: int, cols: int,
                 watermark: "str | os.PathLike | np.ndarray | int",
                 p: int = 3, psnr: float = 40.0):
        if p not in _VALID_P:
            raise ValueError(f"Wrong p parameter: {p}!")
        if psnr <= 0:
            raise ValueError("PSNR must be a positive number")
        self.p = p
        self.psnr = float(psnr)
        self.strength_factor = strength_factor(self.psnr)
        self._fn_cache: dict = {}
        self.reinitialize(watermark, rows, cols)

    # -- state ------------------------------------------------------------

    def reinitialize(self, watermark, rows: int, cols: int) -> None:
        """Re-point the engine at a new image size / watermark matrix.

        The jitted pipeline functions stay cached: the watermark is an
        argument to them, and a new shape compiles on first use."""
        self.rows = int(rows)
        self.cols = int(cols)
        self.random_matrix = jax.device_put(
            self._resolve_watermark(watermark).astype(np.float32))

    def _resolve_watermark(self, watermark) -> np.ndarray:
        if isinstance(watermark, (str, os.PathLike)):
            return load_watermark(watermark, self.rows, self.cols)
        if isinstance(watermark, (int, np.integer)):
            return generate_watermark(self.rows, self.cols, int(watermark))
        arr = np.asarray(watermark)
        if arr.shape != (self.rows, self.cols):
            raise ValueError(
                f"Watermark shape {arr.shape} != image dims "
                f"({self.rows}, {self.cols})")
        return arr

    # -- compiled pipelines ------------------------------------------------

    def _embed_fn(self, mask_type: MaskType):
        key = ("embed", mask_type)
        fn = self._fn_cache.get(key)
        if fn is None:
            # strength is a trace-time constant
            fn = jax.jit(partial(
                embed_pipeline, mask_type=mask_type.value, p=self.p,
                strength_factor_value=self.strength_factor))
            self._fn_cache[key] = fn
        return fn

    def _detect_fn(self, mask_type: MaskType):
        key = ("detect", mask_type)
        fn = self._fn_cache.get(key)
        if fn is None:
            fn = jax.jit(partial(detect_pipeline, mask_type=mask_type.value,
                                 p=self.p))
            self._fn_cache[key] = fn
        return fn

    # -- public API ---------------------------------------------------------

    def warmup(self, channels: int = 0,
               mask_type: "MaskType | str | None" = None) -> None:
        """Pre-compile both mask types (serving cold-start avoidance).

        channels=3 additionally warms the RGB-output embed variant.
        mask_type restricts warmup to one mask (a service that only embeds
        ME compiles only ME's programs).
        """
        import numpy as np

        masks = ((MaskType.parse(mask_type),) if mask_type is not None
                 else (MaskType.NVF, MaskType.ME))
        gray = np.zeros((self.rows, self.cols), dtype=np.float32)
        for mask_type in masks:
            out = gray if channels == 0 else np.zeros(
                (self.rows, self.cols, channels), dtype=np.float32)
            jax.block_until_ready(self.embed(gray, out, mask_type)[0])
            jax.block_until_ready(self.detect(gray, mask_type))

    def embed(self, image, output=None,
              mask_type: "MaskType | str" = MaskType.ME):
        """Embed the watermark computed from grayscale `image` into `output`.

        `output` defaults to `image` (the grayscale video path). Returns
        (watermarked array, strength scalar). Results are device arrays; the
        strength is a 0-d array (call float() to sync).
        """
        mask_type = MaskType.parse(mask_type)
        self._check_dims(image)
        image = as_device_input(image)
        output = image if output is None else as_device_input(output)
        return self._embed_fn(mask_type)(image, output, self.random_matrix)

    def detect(self, image, mask_type: "MaskType | str" = MaskType.ME):
        """Detector correlation of a grayscale image (0-d device array)."""
        mask_type = MaskType.parse(mask_type)
        self._check_dims(image)
        return self._detect_fn(mask_type)(as_device_input(image),
                                          self.random_matrix)

    # per-dispatch device-memory budget for detect_many: the (B*chunk, H, W)
    # prediction intermediates (u and e_u, f32); chunking the candidate
    # axis keeps large banks on big frames clear of memory exhaustion
    _DETECT_MANY_BUDGET_BYTES = 2 * 1024 ** 3

    def detect_many(self, image, watermarks,
                    mask_type: "MaskType | str" = MaskType.ME):
        """Watermark identification: correlations of grayscale image(s)
        against N candidate matrices. (rows, cols) image -> (N,); a
        (B, rows, cols) stack -> (B, N).

        The per-image analysis (Gram, solve, error sequence, mask) runs
        once and is shared across the candidates — one dispatch instead of
        N full detections (the reference can only loop ``detectWatermark``,
        Watermark.cpp:234-250). Large banks are chunked along the candidate
        axis so the (B*N_chunk, H, W) prediction intermediates stay inside
        a fixed device-memory budget. The engine's own ``random_matrix`` is NOT
        implied; pass every candidate explicitly.
        """
        mask_type = MaskType.parse(mask_type)
        image = jnp.asarray(image)
        if image.shape[-2:] != (self.rows, self.cols) or image.ndim not in (
                2, 3):
            raise ValueError(
                f"Images must be ({self.rows}, {self.cols}) or "
                f"(B, {self.rows}, {self.cols}), got shape {image.shape}")
        watermarks = jnp.asarray(watermarks, jnp.float32)
        if watermarks.ndim != 3 or watermarks.shape[1:] != (self.rows,
                                                            self.cols):
            raise ValueError(
                f"Candidate watermarks must be (N, {self.rows}, "
                f"{self.cols}), got shape {watermarks.shape}")
        key = ("detect_many", mask_type)
        fn = self._fn_cache.get(key)
        if fn is None:
            fn = jax.jit(partial(detect_many_pipeline,
                                 mask_type=mask_type.value, p=self.p))
            self._fn_cache[key] = fn
        image = as_device_input(image)
        batch = image.shape[0] if image.ndim == 3 else 1
        n = watermarks.shape[0]
        per_candidate = 2 * batch * self.rows * self.cols * 4  # u + e_u
        chunk = max(1, self._DETECT_MANY_BUDGET_BYTES // per_candidate)
        if chunk >= n:
            return fn(image, watermarks)
        parts = [fn(image, watermarks[start:start + chunk])
                 for start in range(0, n - n % chunk, chunk)]
        if n % chunk:  # pad the remainder to the compiled chunk shape
            tail = watermarks[n - n % chunk:]
            pad = jnp.broadcast_to(tail[-1:],
                                   (chunk - tail.shape[0],) + tail.shape[1:])
            parts.append(fn(image, jnp.concatenate([tail, pad]))
                         [..., :tail.shape[0]])
        return jnp.concatenate(parts, axis=-1)

    def _check_dims(self, image) -> None:
        # exact shape: an RGB (H, W, 3) array passed as the grayscale
        # analysis input would otherwise be silently treated as extra columns
        if image.shape != (self.rows, self.cols):
            raise ValueError(
                f"Analysis image must be grayscale ({self.rows}, "
                f"{self.cols}), got shape {image.shape}; convert with "
                f"rgb_to_gray() or call reinitialize().")
