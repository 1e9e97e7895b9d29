#!/usr/bin/env python3
"""Check the recorded goldens on the CURRENT backend (CPU or GPU).

Runs the full embed->detect flow over the reference's bundled sample
fixtures (512^2 / 480p / 720p PNGs with exactly-matching ``w_*.dat``
files, ``/root/reference/Watermark_GPU/samples/make_w.bat``) and compares
strengths/correlations against ``tests/goldens.json``.

The pytest suite pins the CPU backend (tests/conftest), so run this script
on a GPU host to show the GPU pipelines (with the Triton Gram kernel)
reproduce the goldens on real hardware. It needs the reference's sample
files and exits 2 without them.

Tolerances: the goldens were recorded from the f32 XLA oracle on CPU; the
independent float64 oracle (tests/oracle_vec.py) sits within 7.6e-4 of
them, which brackets the f32 reduction-order noise the goldens themselves
carry. Cross-backend agreement within 1e-3 absolute
(correlations) is the expected class; the reference's own fp16 Rx staging
is ~1e-3 on its own.

The ME *strength* gets a wider relative tolerance (4e-3): the Gram system
is ill-conditioned (cond(Rx) ~ 1.5e4 on the bundled 480p/720p samples),
so backend-dependent f32 reduction order in the Gram accumulation
(~2e-5 relative vs f64) amplifies to ~6e-3 relative in the
coefficients — on EVERY f32 implementation, including the CPU goldens
themselves (the f64-solve-on-f32-gram control shows the solve adds
nothing; the gram representation is the noise floor). Strength inherits
~2e-3 of that through max|e| and ||mask * W||; the detector correlation is
insensitive (passes at <=1e-3 on every backend).

``--wide`` also checks the generalized wide windows (p in {5, 7, 9}) on
the 512 sample against the ``wide_512`` goldens.

Usage: python tools/check_goldens.py [--wide] [--out report.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SAMPLES = "/root/reference/Watermark_GPU/samples"
CASES = {
    "512": (f"{SAMPLES}/images/512.png", f"{SAMPLES}/w_512.dat", 512, 512),
    "480p": (f"{SAMPLES}/images/480p.png", f"{SAMPLES}/w_480p.dat", 480, 720),
    "720p": (f"{SAMPLES}/images/720p.png", f"{SAMPLES}/w_720p.dat",
             720, 1280),
}
CORR_TOL = 1e-3
STRENGTH_RTOL = {"nvf": 1e-3, "me": 4e-3}  # see module docstring


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--wide", action="store_true",
                        help="also check p in {5,7,9} on the 512 sample")
    parser.add_argument("--out", default=None,
                        help="write a JSON artifact of the run (per-case "
                             "deltas + device + date)")
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp

    from watermarking_gpu_tpu.io import load_image_rgb, load_watermark
    from watermarking_gpu_tpu.ops import rgb_to_gray, strength_factor
    from watermarking_gpu_tpu.ops.pipelines import (detect_pipeline,
                                                    embed_pipeline)

    if not os.path.isdir(SAMPLES):
        print(f"reference samples unavailable at {SAMPLES}")
        return 2
    goldens = json.load(open(os.path.join(REPO, "tests", "goldens.json")))
    sf = strength_factor(40.0)
    device = jax.devices()[0]
    print(f"backend: {jax.default_backend()}  device: {device}")

    failures = 0
    records = []

    def check(label, mask_type, want, *, p=3):
        nonlocal failures
        marked, strength = embed_pipeline(gray, rgb, watermark, sf,
                                          mask_type, p=p)
        corr = detect_pipeline(rgb_to_gray(marked), watermark,
                               mask_type, p=p)
        clean = detect_pipeline(gray, watermark, mask_type, p=p)
        d_s = abs(float(strength) / want["strength"] - 1.0)
        d_c = abs(float(corr) - want["correlation"])
        d_cl = abs(float(clean) - want["clean_correlation"])
        ok = (d_s <= STRENGTH_RTOL[mask_type] and d_c <= CORR_TOL
              and d_cl <= CORR_TOL)
        failures += not ok
        records.append({
            "case": label, "mask": mask_type, "p": p,
            "strength": float(strength), "correlation": float(corr),
            "clean_correlation": float(clean),
            "strength_drel": d_s, "correlation_delta": d_c,
            "clean_delta": d_cl, "ok": ok,
        })
        print(f"{label:8s} {mask_type:3s}  "
              f"strength {float(strength):10.4f} (drel {d_s:.2e})  "
              f"corr {float(corr):.6f} (d {d_c:.2e})  "
              f"clean (d {d_cl:.2e})  "
              f"{'ok' if ok else 'FAIL'}")

    for name, (img_path, wm_path, rows, cols) in CASES.items():
        rgb = jnp.asarray(load_image_rgb(img_path))
        gray = rgb_to_gray(rgb)
        watermark = jnp.asarray(load_watermark(wm_path, rows, cols))
        for mask_type in ("nvf", "me"):
            check(name, mask_type, goldens[name][mask_type])
    if args.wide:
        img_path, wm_path, rows, cols = CASES["512"]
        rgb = jnp.asarray(load_image_rgb(img_path))
        gray = rgb_to_gray(rgb)
        watermark = jnp.asarray(load_watermark(wm_path, rows, cols))
        for p in (5, 7, 9):
            for mask_type in ("nvf", "me"):
                check(f"512 p={p}", mask_type,
                      goldens["wide_512"][f"p{p}"][mask_type], p=p)
    print("all goldens reproduced" if failures == 0
          else f"{failures} comparisons FAILED")
    if args.out:
        import datetime
        artifact = {
            "backend": jax.default_backend(),
            "device": str(device),
            "date": datetime.datetime.now(datetime.timezone.utc).isoformat(
                timespec="seconds"),
            "tolerances": {"correlation_abs": CORR_TOL,
                           "strength_rtol": STRENGTH_RTOL},
            "failures": failures,
            "cases": records,
        }
        with open(args.out, "w") as fh:
            json.dump(artifact, fh, indent=1)
        print(f"wrote {args.out} ({len(records)} cases)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
