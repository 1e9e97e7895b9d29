"""Hybrid DP x SP: a batch of frames sharded over the ``data`` axis with each
frame's rows sharded over the ``space`` axis.

This is the framework's full multi-card step: within a space group the
stencil halos move between cards via ppermute and the scalar reductions
psum; across data groups frames are independent. The per-shard spatial
functions are batch-polymorphic, so each card simply processes its
(B_local, h_local, W) block — collectives only ever run over the ``space``
axis.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from .mesh import DATA_AXIS, SPACE_AXIS
from .spatial import _detect_shard, _embed_shard, shard_map


def make_hybrid_detect(mesh, mask_type: str, p: int = 3):
    """(B, H, W) frames + (H, W) watermark -> (B,) correlations.

    B shards over data, H over space; the watermark is row-sharded and shared
    across the batch.
    """
    fn = shard_map(partial(_detect_shard, mask_type=mask_type, p=p),
                   mesh=mesh,
                   in_specs=(P(DATA_AXIS, SPACE_AXIS, None),
                             P(SPACE_AXIS, None)),
                   out_specs=P(DATA_AXIS), check_vma=False)
    return jax.jit(fn)


def make_hybrid_embed(mesh, mask_type: str, strength_factor_value: float,
                      rows: int, cols: int, p: int = 3):
    """(B, H, W) frames -> (watermarked (B, H, W), strengths (B,))."""
    del rows, cols  # shard-local geometry + axis size determine the totals
    fn = shard_map(
        partial(_embed_shard, mask_type=mask_type, p=p,
                strength_factor_value=strength_factor_value),
        mesh=mesh,
        in_specs=(P(DATA_AXIS, SPACE_AXIS, None),
                  P(DATA_AXIS, SPACE_AXIS, None),
                  P(SPACE_AXIS, None)),
        out_specs=(P(DATA_AXIS, SPACE_AXIS, None), P(DATA_AXIS)),
        check_vma=False)
    return jax.jit(fn)


def shard_hybrid(mesh, frames: jnp.ndarray) -> jnp.ndarray:
    """Place (B, H, W) with B over data and H over space."""
    return jax.device_put(
        frames, NamedSharding(mesh, P(DATA_AXIS, SPACE_AXIS, None)))


def shard_watermark(mesh, watermark: jnp.ndarray) -> jnp.ndarray:
    """Row-shard the (H, W) watermark over the space axis."""
    return jax.device_put(
        watermark, NamedSharding(mesh, P(SPACE_AXIS, None)))


def make_mesh_detect_many(mesh, mask_type: str, p: int = 3,
                          batched: bool = False):
    """Watermark identification over the full mesh: (H, W) image — or
    (B, H, W) with ``batched=True`` — x (N, H, W) candidate bank ->
    (..., N) correlations, with image/candidate ROWS sharded over
    ``space`` and the CANDIDATE axis over ``data``.

    Composes both scaling axes of the identification problem: frames too
    large for one card row-shard (halo exchange + psum'd reductions,
    exactly like detection), and the bank splits across data groups with
    no collectives. Each (data, space) shard runs the shared-analysis
    implementation (``spatial._detect_many_shard``); with data=1 this
    is pure spatial identification, with space=1 pure candidate
    parallelism (see also ``make_dp_detect_many``, which keeps whole
    frames per card and is batch-polymorphic over images).
    """
    from .spatial import _detect_many_shard

    img_spec = (P(None, SPACE_AXIS, None) if batched
                else P(SPACE_AXIS, None))
    out_spec = P(None, DATA_AXIS) if batched else P(DATA_AXIS)
    fn = shard_map(
        partial(_detect_many_shard, mask_type=mask_type, p=p),
        mesh=mesh,
        in_specs=(img_spec, P(DATA_AXIS, SPACE_AXIS, None)),
        out_specs=out_spec, check_vma=False)
    return jax.jit(fn)
