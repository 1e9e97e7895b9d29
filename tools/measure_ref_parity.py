#!/usr/bin/env python3
"""Measure the framework's deviation from the reference's LITERAL kernel
semantics on the bundled samples.

Three implementations are compared per (sample, mask) case:

  ref   -- tests/oracle_ref.py: transliteration of the reference OpenCL
           kernels (fp16 Rx staging, 64-pixel group sums, f32 solve) —
           what the reference binary actually computes.
  f64   -- tests/oracle_vec.py: the intended math in float64 (ground truth).
  fw    -- the framework's XLA pipeline (f32).

Reported per case: the reference's own error class |ref - f64|, the
framework's |fw - f64|, and the direct |fw - ref| — for the detector
correlation on the watermarked frame and for the embedding strength. The
embed/detect chain is evaluated self-consistently per implementation
(each detects its own embedding), plus a CROSS check: the framework
detecting the *reference-embedded* frame (the interoperability number:
marks embedded by the reference binary must be detectable here).

Usage: python tools/measure_ref_parity.py [--json OUT.json]
Runs on CPU (forced); ~1 min for all six cases.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

import oracle_ref  # noqa: E402
import oracle_vec  # noqa: E402
from watermarking_gpu_tpu.io import load_image_rgb, load_watermark  # noqa: E402
from watermarking_gpu_tpu.ops import rgb_to_gray, strength_factor  # noqa: E402
from watermarking_gpu_tpu.ops.pipelines import (  # noqa: E402
    detect_pipeline, embed_pipeline)

SAMPLES = "/root/reference/Watermark_GPU/samples"
CASES = {
    "512": (f"{SAMPLES}/images/512.png", f"{SAMPLES}/w_512.dat", 512, 512),
    "480p": (f"{SAMPLES}/images/480p.png", f"{SAMPLES}/w_480p.dat", 480, 720),
    "720p": (f"{SAMPLES}/images/720p.png", f"{SAMPLES}/w_720p.dat",
             720, 1280),
}
PSNR = 40.0


def run_case(name: str, mask_type: str) -> dict:
    img_path, wm_path, rows, cols = CASES[name]
    rgb = np.asarray(load_image_rgb(img_path))
    gray = np.asarray(rgb_to_gray(jnp.asarray(rgb)))
    wm = load_watermark(wm_path, rows, cols)
    sf = strength_factor(PSNR)

    # self-consistent embed -> detect per implementation (grayscale output,
    # the luma/video flow: detect sees exactly what embed produced)
    marked_ref, strength_ref = oracle_ref.embed_ref(gray, wm, PSNR,
                                                    mask_type)
    corr_ref = oracle_ref.detect_ref(marked_ref, wm, mask_type)

    marked_64, strength_64 = oracle_vec.embed(gray, gray, wm, mask_type,
                                              PSNR)
    corr_64 = oracle_vec.detect(marked_64, wm, mask_type)

    marked_fw, strength_fw = embed_pipeline(
        jnp.asarray(gray), jnp.asarray(gray), jnp.asarray(wm), sf,
        mask_type)
    corr_fw = float(detect_pipeline(marked_fw, jnp.asarray(wm), mask_type))
    strength_fw = float(strength_fw)

    # cross: the framework detector on the REFERENCE-embedded frame
    corr_cross = float(detect_pipeline(jnp.asarray(marked_ref),
                                       jnp.asarray(wm), mask_type))
    # clean-image correlations (the false-positive side of the contract)
    clean_ref = oracle_ref.detect_ref(gray, wm, mask_type)
    clean_fw = float(detect_pipeline(jnp.asarray(gray), jnp.asarray(wm),
                                     mask_type))

    out = {
        "sample": name, "mask": mask_type,
        "strength": {"ref": strength_ref, "f64": strength_64,
                     "fw": strength_fw},
        "corr": {"ref": corr_ref, "f64": corr_64, "fw": corr_fw,
                 "fw_on_ref_embed": corr_cross},
        "clean_corr": {"ref": clean_ref, "fw": clean_fw},
        "deltas": {
            "strength_ref_vs_f64_rel":
                abs(strength_ref - strength_64) / abs(strength_64),
            "strength_fw_vs_f64_rel":
                abs(strength_fw - strength_64) / abs(strength_64),
            "strength_fw_vs_ref_rel":
                abs(strength_fw - strength_ref) / abs(strength_ref),
            "corr_ref_vs_f64": abs(corr_ref - corr_64),
            "corr_fw_vs_f64": abs(corr_fw - corr_64),
            "corr_fw_vs_ref": abs(corr_fw - corr_ref),
            "clean_fw_vs_ref": abs(clean_fw - clean_ref),
            "cross_detect_gap": abs(corr_cross - corr_ref),
        },
    }
    if mask_type == "me":
        # component level: the normal equations themselves (closes the
        # shared-misreading hole at the lowest level — the fp16-staged
        # literal Gram vs the framework's f32 Gram)
        from watermarking_gpu_tpu.ops.me import me_normal_equations
        rxm_ref, rxv_ref = oracle_ref.me_normal_equations_ref(gray)
        rxm_fw, rxv_fw = map(np.asarray,
                             me_normal_equations(jnp.asarray(gray)))
        out["deltas"]["gram_fw_vs_ref_rel"] = float(
            np.abs(rxm_fw - rxm_ref).max() / np.abs(rxm_ref).max())
        out["deltas"]["rx_fw_vs_ref_rel"] = float(
            np.abs(rxv_fw - rxv_ref).max() / np.abs(rxv_ref).max())
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--json", type=str, default="")
    args = parser.parse_args()

    results = []
    print(f"{'case':12s} {'|ref-f64|':>10s} {'|fw-f64|':>10s} "
          f"{'|fw-ref|':>10s}   (correlation deltas; strength rel below)")
    for name in CASES:
        for mask_type in ("nvf", "me"):
            r = run_case(name, mask_type)
            results.append(r)
            d = r["deltas"]
            print(f"{name + '/' + mask_type:12s} "
                  f"{d['corr_ref_vs_f64']:10.2e} "
                  f"{d['corr_fw_vs_f64']:10.2e} "
                  f"{d['corr_fw_vs_ref']:10.2e}   "
                  f"strength: ref {d['strength_ref_vs_f64_rel']:.2e} "
                  f"fw {d['strength_fw_vs_f64_rel']:.2e} "
                  f"fw-vs-ref {d['strength_fw_vs_ref_rel']:.2e}"
                  + (f"  gram {d['gram_fw_vs_ref_rel']:.2e}"
                     if "gram_fw_vs_ref_rel" in d else ""), flush=True)
            print(f"{'':12s} cross-detect (fw on ref embed): "
                  f"{r['corr']['fw_on_ref_embed']:.6f} vs ref self "
                  f"{r['corr']['ref']:.6f} (gap {d['cross_detect_gap']:.2e})")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(results, fh, indent=1)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
