"""Frame-parallel (DP) embed/detect over a device mesh.

Independent video frames shard across the ``data`` mesh axis; each card runs
the batched pipeline on its local frame block with no cross-card
communication (the per-frame 8x8 solves and scalar reductions are
frame-local). Expressed with ``shard_map`` so the per-card computation is
the literal single-card program — including the opaque Triton Gram kernel,
which the GSPMD partitioner could not split on its own. This is the scaling
story for the reference's sequential frame loop
(reference ``Watermark_GPU/main.cpp:319-340``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..models.batched import batch_detect, batch_embed
from .mesh import DATA_AXIS
from .spatial import shard_map


def shard_frames(mesh, frames: jnp.ndarray) -> jnp.ndarray:
    """Place a (B, H, W[, C]) stack with B sharded over the data axis."""
    spec = P(DATA_AXIS, *([None] * (frames.ndim - 1)))
    return jax.device_put(frames, NamedSharding(mesh, spec))


def replicate(mesh, value: jnp.ndarray) -> jnp.ndarray:
    """Replicate an array (e.g. the watermark matrix) on every device."""
    return jax.device_put(value, NamedSharding(mesh, P()))


def make_dp_detect(mesh, mask_type: str, p: int = 3):
    """jit-compiled frame-sharded detect: (B, H, W), W -> (B,) correlations."""
    fn = shard_map(partial(batch_detect, mask_type=mask_type, p=p),
                   mesh=mesh,
                   in_specs=(P(DATA_AXIS, None, None), P()),
                   out_specs=P(DATA_AXIS), check_vma=False)
    return jax.jit(fn)


def make_dp_detect_many(mesh, mask_type: str, p: int = 3,
                        batched: bool = False):
    """jit-compiled candidate-sharded watermark identification.

    (H, W) image — or (B, H, W) with ``batched=True`` — against an
    (N, H, W) candidate bank sharded over the ``data`` axis ->
    (..., N) correlations, candidate axis sharded. Each card runs the
    shared-analysis ``detect_many_pipeline`` on its local bank slice: the
    image analysis (Gram, solve, error sequence, mask) is recomputed per
    card but shared across that card's N/n candidates, so the replicated
    work is one detection's analysis — not N of them — and no collectives
    run. This scales the identification capability the reference could
    only express as a loop of full detections
    (``/root/reference/Watermark_GPU/Watermark.cpp:234-250``).
    """
    from ..ops.pipelines import detect_many_pipeline

    img_spec = P(None, None, None) if batched else P(None, None)
    out_spec = P(None, DATA_AXIS) if batched else P(DATA_AXIS)
    fn = shard_map(partial(detect_many_pipeline, mask_type=mask_type, p=p),
                   mesh=mesh,
                   in_specs=(img_spec, P(DATA_AXIS, None, None)),
                   out_specs=out_spec, check_vma=False)
    return jax.jit(fn)


def make_dp_embed(mesh, mask_type: str, strength_factor_value: float,
                  p: int = 3, channels: bool = False):
    """jit-compiled frame-sharded embed.

    (B, H, W) images + (B, H, W[, C]) outputs -> watermarked stack + (B,)
    strengths, all frame-sharded.
    """
    out_dims = (DATA_AXIS, None, None, None) if channels else \
        (DATA_AXIS, None, None)
    fn = shard_map(partial(batch_embed, mask_type=mask_type, p=p,
                           strength_factor_value=strength_factor_value),
                   mesh=mesh,
                   in_specs=(P(DATA_AXIS, None, None), P(*out_dims), P()),
                   out_specs=(P(*out_dims), P(DATA_AXIS)), check_vma=False)
    return jax.jit(fn)
