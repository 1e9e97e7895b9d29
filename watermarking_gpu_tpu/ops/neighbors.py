"""Clamp-to-edge neighborhood primitives shared by all masks.

The reference reads pixels through an OpenCL image2d sampler configured with
``CLK_ADDRESS_CLAMP_TO_EDGE`` (``/root/reference/Watermark_GPU/kernels/nvf.hpp:9``,
``me_p3.hpp:45``, ``scaled_neighbors_p3.hpp:14``). The JAX equivalent is
``jnp.pad(..., mode="edge")`` once per pass plus static slices, which XLA fuses
into the consuming computation.

Neighbor ordering is the row-major scan of the p x p window excluding the
center (for p=3: top-left, top, top-right, left, right, bottom-left, bottom,
bottom-right), matching the coefficient order consumed by the reference
prediction kernel (``scaled_neighbors_p3.hpp:35-42``) and produced by the
``me`` kernel (``me_p3.hpp:46-54``). The reference hard-codes p=3 for the
predictor (``main.cpp:88-89``: "TODO for p>3 we have problems with ME masking
buffers"); here the window generalizes to p in {3, 5, 7, 9}.

All ops here are batch-polymorphic: images are (..., H, W) with any number of
leading batch dimensions.
"""

from __future__ import annotations

import jax.numpy as jnp


def neighbor_offsets(p: int = 3) -> tuple[tuple[int, int], ...]:
    """Row-major (row, col) offsets of the p x p window, center excluded."""
    half = p // 2
    return tuple((dr, dc)
                 for dr in range(-half, half + 1)
                 for dc in range(-half, half + 1)
                 if (dr, dc) != (0, 0))


# The p=3 case, index k corresponding to coeffs[k] in the reference.
NEIGHBOR_OFFSETS: tuple[tuple[int, int], ...] = neighbor_offsets(3)

NUM_NEIGHBORS = len(NEIGHBOR_OFFSETS)  # p*p - 1 with p=3


def pad_edge(image: jnp.ndarray, halo: int) -> jnp.ndarray:
    """Replicate-pad the last two dims of (..., H, W) by `halo` pixels."""
    widths = [(0, 0)] * (image.ndim - 2) + [(halo, halo), (halo, halo)]
    return jnp.pad(image, widths, mode="edge")


def neighbor_stack_from_padded(padded: jnp.ndarray, rows: int,
                               cols: int, p: int = 3) -> jnp.ndarray:
    """(..., rows+2h, cols+2h) halo-extended -> (..., p*p-1, rows, cols)
    neighbors, h = p//2.

    Used directly by the spatially-sharded path, where the row halo comes
    from a ppermute exchange instead of local edge padding.
    """
    half = p // 2
    return jnp.stack(
        [padded[..., half + dr : half + dr + rows,
                half + dc : half + dc + cols]
         for dr, dc in neighbor_offsets(p)],
        axis=-3,
    )


def neighbor_stack(image: jnp.ndarray, p: int = 3) -> jnp.ndarray:
    """(..., H, W) -> (..., p*p-1, H, W) clamp-to-edge neighbor stack."""
    rows, cols = image.shape[-2:]
    return neighbor_stack_from_padded(pad_edge(image, p // 2), rows, cols, p)
