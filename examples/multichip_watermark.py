"""Multi-card watermarking over a (data, space) device mesh.

Frames shard across the ``data`` axis; each frame's rows shard across the
``space`` axis with halo exchange between cards. Run on real cards as-is, or
simulate a mesh on CPU:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/multichip_watermark.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from watermarking_gpu_tpu.ops import strength_factor
from watermarking_gpu_tpu.parallel import (make_hybrid_detect,
                                           make_hybrid_embed, make_mesh,
                                           shard_hybrid, shard_watermark)


def main():
    n = len(jax.devices())
    space = 2 if n % 2 == 0 and n >= 2 else 1
    data = n // space
    mesh = make_mesh(data=data, space=space)
    print(f"{n} devices -> mesh data={data} x space={space} "
          f"({jax.devices()[0].platform})")

    batch, rows, cols = 2 * data, 64 * space, 512
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:rows, 0:cols].astype(np.float32)
    frames = jnp.asarray(np.clip(
        110 + 70 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
        + rng.normal(0, 14, (batch, rows, cols)), 0, 255), jnp.float32)
    watermark = jnp.asarray(rng.normal(0, 1, (rows, cols)), jnp.float32)

    frames_sharded = shard_hybrid(mesh, frames)
    wm_sharded = shard_watermark(mesh, watermark)

    sf = strength_factor(35.0)
    embed = make_hybrid_embed(mesh, "me", sf, rows, cols)
    detect = make_hybrid_detect(mesh, "me")

    marked, strengths = embed(frames_sharded, frames_sharded, wm_sharded)
    corrs = np.asarray(detect(marked, wm_sharded))
    clean = np.asarray(detect(frames_sharded, wm_sharded))
    print(f"{batch} frames of {rows}x{cols}, strength "
          f"{float(np.asarray(strengths)[0]):.3f}")
    print(f"marked correlations: {corrs.round(3)}")
    print(f"clean  correlations: {clean.round(3)}")

    # identification over the same mesh: WHICH watermark does a frame
    # carry? The candidate bank splits across `data` groups while the
    # frame's rows stay sharded over `space`.
    from watermarking_gpu_tpu.parallel import (make_mesh_detect_many,
                                               shard_rows)
    n_candidates = 2 * data
    bank = jnp.concatenate([
        watermark[None],
        jnp.asarray(rng.normal(0, 1, (n_candidates - 1, rows, cols)),
                    jnp.float32)])
    identify = make_mesh_detect_many(mesh, "me")
    corrs_n = np.asarray(identify(
        shard_rows(mesh, jnp.asarray(np.asarray(marked)[0])),
        shard_hybrid(mesh, bank)))
    print(f"identification over {n_candidates} candidates: "
          f"argmax={int(corrs_n.argmax())} (0 = the embedded one), "
          f"margin {corrs_n[0] - np.sort(corrs_n)[-2]:.3f}")


if __name__ == "__main__":
    main()
