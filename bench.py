#!/usr/bin/env python3
"""Headline benchmark: embed+detect throughput at 1080p on one GPU.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": "fps", "detail": {...}}

The measured step is the full flagship round trip per frame — ME-mask embed
into the frame, then ME detection on the watermarked frame — matching the
reference's benchmark surface (``/root/reference/Watermark_GPU/main.cpp:
175-223``: embed timing + detect timing at the configured resolution).

Methodology: chained batched steps (each step's watermarked output feeds the
next step's input, forcing sequential device execution) in warmed windows
closed by ``block_until_ready``; the value is the median window. Frames and
watermark are generated from fixed seeds. Fails without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from watermarking_gpu_tpu.io.matfile import generate_watermark  # noqa: E402
from watermarking_gpu_tpu.models.batched import (batch_detect,  # noqa: E402
                                                 batch_embed)
from watermarking_gpu_tpu.ops import strength_factor  # noqa: E402
from watermarking_gpu_tpu.utils import enable_compilation_cache  # noqa: E402

ROWS, COLS = 1080, 1920
ITERS = 20
WINDOWS = 7


def make_frames(batch: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    base = np.clip(rng.normal(128, 40, size=(ROWS, COLS)), 0,
                   255).astype(np.float32)
    # perturb each frame slightly so per-frame solves are not identical
    jitter = rng.normal(0, 1, size=(batch, 1, 1)).astype(np.float32)
    return np.clip(base[None] + jitter, 0, 255).astype(np.float32)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--profile", default="",
                        help="capture a jax.profiler trace into this dir")
    parser.add_argument("--batch", type=int, default=8,
                        help="frames per dispatch")
    args = parser.parse_args()
    device = jax.devices()[0]
    if device.platform != "gpu":
        print(f"bench.py measures the GPU; found {device.platform}",
              file=sys.stderr)
        return 1
    enable_compilation_cache()
    batch = args.batch
    frames = jax.device_put(make_frames(batch))
    watermark = jax.device_put(
        generate_watermark(ROWS, COLS, seed=28390211).astype(np.float32))
    sf = strength_factor(40.0)

    @jax.jit
    def step(frames_in, wm):
        watermarked, _ = batch_embed(frames_in, frames_in, wm, sf, "me")
        return watermarked, batch_detect(watermarked, wm, "me")

    jax.block_until_ready(step(frames, watermark))   # compile + warm

    def window() -> tuple[float, np.ndarray]:
        f, out = frames, None
        t0 = time.perf_counter()
        for _ in range(ITERS):
            f, out = step(f, watermark)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / ITERS, out

    window()
    from watermarking_gpu_tpu.utils.profiling import trace
    with trace(args.profile or None):
        samples = [window() for _ in range(WINDOWS)]
    per_step = float(np.median([s for s, _ in samples]))
    corrs = np.asarray(samples[-1][1])
    fps = batch / per_step

    print(json.dumps({
        "metric": "embed_detect_fps_1080p_me",
        "value": round(fps, 1),
        "unit": "fps",
        "detail": {
            "batch": batch,
            "ms_per_frame": 1e3 * per_step / batch,
            "mean_correlation": round(float(corrs.mean()), 4),
            "device": {"platform": device.platform,
                       "kind": device.device_kind,
                       "count": len(jax.devices())},
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
