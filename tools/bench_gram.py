#!/usr/bin/env python3
"""A/B of the p=3 Gram on the GPU: Triton kernel vs the XLA formulations.

Prints, for 1080p frames at batch 8 (``--rows/--cols/--batch`` change it):

* the card's name and power limit (``nvidia-smi``);
* each Gram entry's worst relative error against a float64 NumPy Gram;
* ms per frame of the Gram alone: the Triton kernel at a few tilings,
  the 8-neighbour stack einsum, and the lag-decomposed XLA Gram at p=3;
* ms per frame of the ME embed+detect round trip with each Gram, in turns
  (einsum, lags, kernel, kernel, lags, einsum);
* with ``--hlo``, the full-frame copies and transposes in the optimised
  HLO of the 3872x2160 embed and detect programs under plain ``jax.jit``.

Timings are medians of warmed windows closed by ``block_until_ready``.
Run on the card: ``python tools/bench_gram.py --hlo``. It fails without a
GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from functools import partial

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from watermarking_gpu_tpu.io.matfile import generate_watermark  # noqa: E402
from watermarking_gpu_tpu.ops import pipelines  # noqa: E402
from watermarking_gpu_tpu.ops.embed import strength_factor  # noqa: E402
from watermarking_gpu_tpu.ops.gram_triton import gram_p3_triton  # noqa: E402
from watermarking_gpu_tpu.ops.me import (_gram_lags_vectorized,  # noqa: E402
                                         gram_terms_from_padded)
from watermarking_gpu_tpu.ops.neighbors import pad_edge  # noqa: E402


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, *args, iters: int = 20, windows: int = 7) -> float:
    """Median ms per call over warmed windows closed by block_until_ready."""
    jax.block_until_ready(fn(*args))
    samples = []
    for _ in range(windows):
        t0 = time.perf_counter()
        out = None
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        samples.append((time.perf_counter() - t0) * 1e3 / iters)
    return float(np.median(samples))


def gram_einsum(image, p=3):
    return gram_terms_from_padded(pad_edge(image, 1), image, 3)


def gram_lags(image, p=3):
    return _gram_lags_vectorized(pad_edge(image, 3), image.shape[:-2],
                                 *image.shape[-2:], 3)


def gram_kernel(image, p=3, **kw):
    g = gram_p3_triton(image, **kw)
    return g[..., :8, :8], g[..., :8, 8]


def gram_f64(frame: np.ndarray) -> np.ndarray:
    f = frame.astype(np.float64)
    padded = np.pad(f, 1, mode="edge")
    h, w = f.shape
    taps = [padded[1 + dr:1 + dr + h, 1 + dc:1 + dc + w].ravel()
            for dr, dc in ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1),
                           (1, -1), (1, 0), (1, 1), (0, 0))]
    flat = np.stack(taps)
    return flat @ flat.T


def roundtrip(gram_fn, sf):
    """jitted ME embed+detect with the pipelines' Gram swapped for gram_fn."""
    def step(frames, wm):
        saved = pipelines.me_normal_equations
        pipelines.me_normal_equations = gram_fn
        try:
            marked, _ = pipelines.embed_pipeline(frames, frames, wm, sf, "me")
            return marked, pipelines.detect_pipeline(marked, wm, "me")
        finally:
            pipelines.me_normal_equations = saved
    return jax.jit(step)


def full_frame_copies(hlo: str, rows: int, cols: int) -> list[str]:
    found = []
    for line in hlo.splitlines():
        m = re.search(r"=\s*f32\[([\d,]+)\]\S*\s+(copy|transpose)\(", line)
        if m:
            dims = [int(d) for d in m.group(1).split(",")]
            if int(np.prod(dims)) >= rows * cols:
                found.append(line.strip()[:200])
    return found


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rows", type=int, default=1080)
    parser.add_argument("--cols", type=int, default=1920)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--hlo", action="store_true")
    args = parser.parse_args()
    if jax.devices()[0].platform != "gpu":
        print("no GPU: this tool measures the card only", file=sys.stderr)
        return 1
    print(card(), flush=True)
    rows, cols, batch = args.rows, args.cols, args.batch
    rng = np.random.default_rng(0)
    frames_np = np.clip(rng.normal(128, 40, (batch, rows, cols)), 0,
                        255).astype(np.float32)
    frames = jax.device_put(frames_np)
    wm = jax.device_put(generate_watermark(rows, cols, 28390211))
    result: dict = {"device": jax.devices()[0].device_kind,
                    "shape": [batch, rows, cols]}

    ref = gram_f64(frames_np[0])
    configs = [((1, 256), 32, 4), ((1, 256), 64, 4), ((1, 128), 64, 4),
               ((2, 256), 32, 4), ((1, 512), 32, 4), ((1, 256), 16, 2)]
    for tile, per_program, warps in configs:
        fn = jax.jit(partial(gram_p3_triton, tile=tile, num_warps=warps,
                             rows_per_program=per_program))
        g = np.asarray(fn(frames)[0], np.float64)
        rel = float(np.max(np.abs(g - ref) / np.abs(ref)))
        key = f"kernel_{tile[0]}x{tile[1]}_r{per_program}_w{warps}"
        result[key] = {"max_rel_err": rel,
                       "ms_per_frame": time_ms(fn, frames) / batch}
        print(key, result[key], flush=True)
    for name, fn in (("einsum", gram_einsum), ("lags", gram_lags)):
        jf = jax.jit(fn)
        rxm, rxv = jf(frames)
        rel = float(max(
            np.max(np.abs(np.asarray(rxm[0], np.float64) - ref[:8, :8])
                   / np.abs(ref[:8, :8])),
            np.max(np.abs(np.asarray(rxv[0], np.float64) - ref[:8, 8])
                   / np.abs(ref[:8, 8]))))
        result[name] = {"max_rel_err": rel,
                        "ms_per_frame": time_ms(jf, frames) / batch}
        print(name, result[name], flush=True)

    sf = strength_factor(40.0)
    steps = {"einsum": roundtrip(gram_einsum, sf),
             "lags": roundtrip(gram_lags, sf),
             "kernel": roundtrip(gram_kernel, sf)}
    corr = {k: np.asarray(s(frames, wm)[1]) for k, s in steps.items()}
    result["roundtrip_corr_max_diff"] = float(max(
        np.abs(corr["einsum"] - corr[k]).max() for k in corr))
    times: dict = {k: [] for k in steps}
    for name in ("einsum", "lags", "kernel", "kernel", "lags", "einsum"):
        times[name].append(time_ms(steps[name], frames, wm) / batch)
    result["roundtrip_ms_per_frame"] = times
    print("roundtrip", times, "corr diff",
          result["roundtrip_corr_max_diff"], flush=True)

    if args.hlo:
        r4, c4 = 2160, 3872
        img = jax.device_put(np.zeros((r4, c4), np.float32))
        w4 = jax.device_put(np.zeros((r4, c4), np.float32))
        emb = jax.jit(partial(pipelines.embed_pipeline,
                              strength_factor_value=sf, mask_type="me"))
        det = jax.jit(partial(pipelines.detect_pipeline, mask_type="me"))
        for name, lowered in (("embed", emb.lower(img, img, w4)),
                              ("detect", det.lower(img, w4))):
            hlo = lowered.compile().as_text()
            copies = full_frame_copies(hlo, r4, c4)
            result[f"hlo_3872_{name}_full_frame_copies"] = copies
            print(f"hlo 3872 {name}: {len(copies)} full-frame copy/"
                  f"transpose", copies, flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
