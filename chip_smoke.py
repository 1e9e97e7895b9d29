#!/usr/bin/env python3
"""Smoke test of the watermark engine on the GPU, through its user API.

``python chip_smoke.py`` runs the main path on one card, with every input
made from a seed, in phases; each phase prints one JSON line with shapes,
each compared quantity beside its limit, and ms per frame:

(a) 1080p x8 ``BatchedWatermark`` embed then detect, NVF and ME p=3, against
    the float64 NumPy oracle (``tests/oracle_vec.py``) on frame 0, and the
    Triton p=3 Gram kernel alone against a float64 Gram;
(b) ME at p=5 and p=9, 1080p, against the same pipeline on the CPU backend;
(c) 3840x2160 and 3872x2160 ``Watermark`` round trips against the CPU
    backend;
(d) ``Watermark.detect_many`` with 64 candidates at 1080p: the embedded one
    wins, and the result matches looped ``detect``;
(e) ``DetectorService`` and ``EmbedderService``, 8 requests each, against
    direct engine calls;
(f) the raw-YUV video path (``video.rawyuv.synthesize``, no ffmpeg) on a few
    1080p frames.

``python chip_smoke.py --multi`` runs only the four-card phase: frame-
parallel embed and detect of 1080p x8, ``make_dp_detect_many`` with 64
candidates, ``make_hybrid_detect`` on a 2x2 mesh and ``DetectorService``
over a mesh, each against single-card results.

The card's name and power limit come first; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a GPU, or when any phase fails, the script exits non-zero and does
not print that line. Timings are medians of warmed windows closed by
``block_until_ready``; they are reported, never asserted.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from functools import partial

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
ROWS, COLS, BATCH = 1080, 1920, 8
SIZES_4K = ((2160, 3840), (2160, 3872))   # (rows, cols); 3872 % 64 != 0
N_CANDIDATES = 64
VIDEO_FRAMES = 8
WM_SEED = 28390211
PSNR = 40.0
# tools/check_goldens.py: correlation |d| <= 1e-3 against the float64
# oracle; strength rtol 1e-3 (NVF) and 4e-3 (ME: cond(Rx) ~ 1.5e4 amplifies
# f32 Gram reduction order into the coefficients)
ORACLE_CORR = 1e-3
ORACLE_STRENGTH = {"nvf": 1e-3, "me": 4e-3}
CLEAN_CORR = 0.05
# same pipeline on the CPU backend: only f32 reduction order differs
CPU_CORR = 1e-4
CPU_STRENGTH = 5e-3
GRAM_REL = 2e-5


class PhaseFailed(AssertionError):
    pass


class Phase:
    """Collects one phase's numbers and checks; prints them as one line."""

    def __init__(self, name: str):
        self.name = name
        self.record: dict = {"phase": name}
        self.failures: list[str] = []

    def note(self, key: str, value) -> None:
        self.record[key] = value

    def check(self, key: str, value: float, limit: float) -> None:
        value = float(value)
        self.record[key] = {"value": value, "limit": limit}
        if not (np.isfinite(value) and value <= limit):
            self.failures.append(f"{key}={value} > {limit}")

    def require(self, key: str, condition: bool) -> None:
        self.record[key] = bool(condition)
        if not condition:
            self.failures.append(key)

    def finish(self) -> None:
        self.record["ok"] = not self.failures
        print(json.dumps(self.record), flush=True)
        if self.failures:
            raise PhaseFailed(f"{self.name}: {'; '.join(self.failures)}")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def ms_per_frame(fn, frames: int, iters: int = 10, windows: int = 3) -> float:
    """Median ms per frame of ``fn()`` over warmed windows."""
    import jax

    jax.block_until_ready(fn())
    samples = []
    for _ in range(windows):
        t0 = time.perf_counter()
        out = None
        for _ in range(iters):
            out = fn()
        jax.block_until_ready(out)
        samples.append((time.perf_counter() - t0) * 1e3 / (iters * frames))
    return float(np.median(samples))


def gray_frames(rows: int, cols: int, count: int, seed: int = 0):
    from watermarking_gpu_tpu.io import synthetic_image_rgb

    weights = np.array([0.299, 0.587, 0.114], dtype=np.float32)
    return np.stack([synthetic_image_rgb(cols, rows, seed + i) @ weights
                     for i in range(count)]).astype(np.float32)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def cpu_round_trip(image, watermark, mask: str, p: int):
    """embed + detect of one frame with the pipelines on the CPU backend."""
    import jax

    from watermarking_gpu_tpu.ops import strength_factor
    from watermarking_gpu_tpu.ops.pipelines import (detect_pipeline,
                                                    embed_pipeline)

    cpu = jax.devices("cpu")[0]
    img, wm = (jax.device_put(np.asarray(x, np.float32), cpu)
               for x in (image, watermark))
    embed = jax.jit(partial(embed_pipeline, mask_type=mask, p=p,
                            strength_factor_value=strength_factor(PSNR)))
    detect = jax.jit(partial(detect_pipeline, mask_type=mask, p=p))
    marked, strength = embed(img, img, wm)
    return (np.asarray(marked), float(strength),
            float(detect(marked, wm)))


# -- one-card phases ----------------------------------------------------


def phase_a() -> None:
    """1080p x8 BatchedWatermark, NVF and ME p=3, vs the float64 oracle."""
    import jax

    import oracle_vec
    from watermarking_gpu_tpu import BatchedWatermark
    from watermarking_gpu_tpu.ops import gram_triton

    ph = Phase("a_batched_1080p_p3")
    frames = gray_frames(ROWS, COLS, BATCH)
    engine = BatchedWatermark(ROWS, COLS, WM_SEED, p=3, psnr=PSNR)
    wm = np.asarray(engine.random_matrix)
    dev = jax.device_put(frames)
    ph.note("shape", list(frames.shape))

    gram_fn = jax.jit(gram_triton.gram_p3_triton)
    gram = np.asarray(gram_fn(dev))
    ph.note("gram_shape", list(gram.shape))
    ph.check("gram_max_rel_vs_f64",
             rel(gram[0], oracle_vec_gram(frames[0])), GRAM_REL)
    ph.note("gram_ms_per_frame", ms_per_frame(lambda: gram_fn(dev), BATCH))

    for mask in ("nvf", "me"):
        marked, strengths = engine.embed(dev, mask_type=mask)
        corrs = np.asarray(engine.detect(marked, mask))
        clean = np.asarray(engine.detect(dev, mask))
        marked0 = np.asarray(marked[0], np.float64)
        want_marked, want_strength = oracle_vec.embed(
            frames[0].astype(np.float64), frames[0].astype(np.float64),
            wm, mask, PSNR)
        want_corr = oracle_vec.detect(marked0, wm, mask)
        ph.require(f"{mask}_shapes", marked.shape == frames.shape
                   and corrs.shape == (BATCH,))
        ph.check(f"{mask}_strength_rel_vs_oracle",
                 abs(float(strengths[0]) / want_strength - 1.0),
                 ORACLE_STRENGTH[mask])
        ph.check(f"{mask}_corr_abs_vs_oracle",
                 abs(float(corrs[0]) - want_corr), ORACLE_CORR)
        ph.note(f"{mask}_marked_max_abs_px_vs_oracle",
                float(np.max(np.abs(marked0 - want_marked))))
        ph.check(f"{mask}_clean_max_abs_corr", np.abs(clean).max(),
                 CLEAN_CORR)
        ph.note(f"{mask}_corr_min", float(corrs.min()))
        ph.note(f"{mask}_embed_ms_per_frame", ms_per_frame(
            lambda m=mask: engine.embed(dev, mask_type=m)[0], BATCH))
        ph.note(f"{mask}_detect_ms_per_frame", ms_per_frame(
            lambda m=mask, x=marked: engine.detect(x, m), BATCH))
    ph.finish()


def oracle_vec_gram(frame: np.ndarray) -> np.ndarray:
    """float64 9x9 Gram of [8 clamped neighbours; centre] (oracle_vec)."""
    import oracle_vec

    f = frame.astype(np.float64)
    flat = np.concatenate([oracle_vec.neighbor_planes(f).reshape(8, -1),
                           f.reshape(1, -1)])
    return flat @ flat.T


def phase_b() -> None:
    """ME at p=5 and p=9, 1080p, vs the same pipeline on the CPU."""
    import jax

    from watermarking_gpu_tpu import BatchedWatermark

    ph = Phase("b_wide_me_1080p")
    frames = gray_frames(ROWS, COLS, 2, seed=20)
    dev = jax.device_put(frames)
    ph.note("shape", list(frames.shape))
    for p in (5, 9):
        engine = BatchedWatermark(ROWS, COLS, WM_SEED, p=p, psnr=PSNR)
        marked, strengths = engine.embed(dev, mask_type="me")
        corrs = np.asarray(engine.detect(marked, "me"))
        _, want_strength, want_corr = cpu_round_trip(
            frames[0], engine.random_matrix, "me", p)
        ph.check(f"p{p}_strength_rel_vs_cpu",
                 abs(float(strengths[0]) / want_strength - 1.0),
                 CPU_STRENGTH)
        ph.check(f"p{p}_corr_abs_vs_cpu", abs(float(corrs[0]) - want_corr),
                 CPU_CORR)
        ph.note(f"p{p}_corr", float(corrs[0]))
        ph.note(f"p{p}_round_trip_ms_per_frame", ms_per_frame(
            lambda e=engine: e.detect(e.embed(dev, mask_type="me")[0],
                                      "me"), 2, iters=5))
    ph.finish()


def phase_c() -> None:
    """4K and the misaligned 3872-wide frame, Watermark vs the CPU."""
    import jax

    from watermarking_gpu_tpu import Watermark

    ph = Phase("c_4k_round_trips")
    for rows, cols in SIZES_4K:
        frame = gray_frames(rows, cols, 1, seed=40)[0]
        dev = jax.device_put(frame)
        engine = Watermark(rows, cols, WM_SEED, p=3, psnr=PSNR)
        marked, strength = engine.embed(dev, mask_type="me")
        corr = float(engine.detect(marked, "me"))
        want_marked, want_strength, want_corr = cpu_round_trip(
            frame, engine.random_matrix, "me", 3)
        key = f"{cols}x{rows}"
        ph.require(f"{key}_shape", marked.shape == (rows, cols))
        ph.check(f"{key}_strength_rel_vs_cpu",
                 abs(float(strength) / want_strength - 1.0), CPU_STRENGTH)
        ph.check(f"{key}_corr_abs_vs_cpu", abs(corr - want_corr), CPU_CORR)
        ph.note(f"{key}_marked_max_abs_px_vs_cpu",
                float(np.max(np.abs(np.asarray(marked) - want_marked))))
        ph.note(f"{key}_round_trip_ms_per_frame", ms_per_frame(
            lambda e=engine, x=dev: e.detect(
                e.embed(x, mask_type="me")[0], "me"), 1))
    ph.finish()


def phase_d() -> None:
    """detect_many with 64 candidates at 1080p vs looped detect."""
    import jax

    from watermarking_gpu_tpu import Watermark

    ph = Phase("d_detect_many_1080p_n64")
    n, true_index = N_CANDIDATES, N_CANDIDATES // 4 + 1
    bank = np.random.default_rng(5).standard_normal(
        (n, ROWS, COLS), dtype=np.float32)
    bank_dev = jax.device_put(bank)
    frame = gray_frames(ROWS, COLS, 1, seed=60)[0]
    engine = Watermark(ROWS, COLS, bank[true_index], p=3, psnr=PSNR)
    marked, _ = engine.embed(frame, mask_type="me")
    corrs = np.asarray(engine.detect_many(marked, bank_dev, "me"))
    looped = []
    probe = Watermark(ROWS, COLS, bank[0], p=3, psnr=PSNR)
    for candidate in bank:
        probe.reinitialize(candidate, ROWS, COLS)
        looped.append(float(probe.detect(marked, "me")))
    ph.note("bank_shape", list(bank.shape))
    ph.require("embedded_candidate_wins", int(np.argmax(corrs)) == true_index)
    ph.note("winner_corr", float(corrs[true_index]))
    ph.note("best_decoy_corr", float(np.delete(corrs, true_index).max()))
    ph.check("max_abs_vs_looped_detect", np.abs(corrs - looped).max(), 1e-4)
    ph.note("ms_per_dispatch", ms_per_frame(
        lambda: engine.detect_many(marked, bank_dev, "me"), 1, iters=3))
    ph.finish()


def phase_e() -> None:
    """DetectorService and EmbedderService vs direct engine calls."""
    from watermarking_gpu_tpu import (BatchedWatermark, DetectorService,
                                      EmbedderService)

    ph = Phase("e_services_1080p")
    frames = gray_frames(ROWS, COLS, 8, seed=80)
    engine = BatchedWatermark(ROWS, COLS, WM_SEED, p=3, psnr=PSNR)
    want_marked, want_strengths = map(
        np.asarray, engine.embed(frames, mask_type="me"))
    want_corrs = np.asarray(engine.detect(want_marked, "me"))
    embedder = EmbedderService(engine, batch_size=4)
    detector = DetectorService(engine, batch_size=4)
    try:
        t0 = time.perf_counter()
        embedded = [f.result(timeout=300)
                    for f in [embedder.submit(x) for x in frames]]
        corrs = [f.result(timeout=300)
                 for f in [detector.submit(m) for m, _ in embedded]]
        ph.note("wall_s_16_requests_incl_compile", time.perf_counter() - t0)
    finally:
        embedder.close(timeout=60)
        detector.close(timeout=60)
    marked = np.stack([m for m, _ in embedded])
    strengths = np.array([s for _, s in embedded])
    ph.require("answered", len(embedded) == 8 and len(corrs) == 8)
    ph.check("embed_max_abs_px_vs_direct",
             np.abs(marked - want_marked).max(), 1e-2)
    ph.check("strength_max_rel_vs_direct", rel(strengths, want_strengths),
             1e-4)
    ph.check("detect_max_abs_vs_direct",
             np.abs(np.array(corrs) - want_corrs).max(), 1e-4)
    ph.finish()


def phase_f() -> None:
    """Raw-YUV video: embed every frame, detect the output and the clean
    clip."""
    from watermarking_gpu_tpu import BatchedWatermark
    from watermarking_gpu_tpu.io.config import Settings
    from watermarking_gpu_tpu.video import (detect_video, embed_video,
                                            frame_bytes, synthesize)

    ph = Phase("f_video_rawyuv_1080p")
    n_frames = VIDEO_FRAMES
    engine = BatchedWatermark(ROWS, COLS, WM_SEED, p=3, psnr=PSNR)
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.yuv"), os.path.join(tmp, "out.yuv")
        with open(src, "wb") as fh:
            fh.write(synthesize(COLS, ROWS, n_frames, seed=9))

        def settings(video, **kw):
            return Settings(video=video, raw_video_size=f"{COLS}x{ROWS}",
                            watermark_interval=1, p=3, psnr=PSNR,
                            embed_batch=4, detect_batch=4, **kw)

        t0 = time.perf_counter()
        written = embed_video(settings(src, encode_watermark_file_path=dst),
                              engine=engine, out=io.StringIO())
        ph.note("embed_wall_s_incl_compile", time.perf_counter() - t0)
        ph.require("frames_written", written == n_frames and
                   os.path.getsize(dst) == n_frames * frame_bytes(COLS, ROWS))
        _, marked = detect_video(settings(dst), engine=engine,
                                 out=io.StringIO())
        _, clean = detect_video(settings(src), engine=engine,
                                out=io.StringIO())
    marked_corr = np.array([c for _, c in marked])
    clean_corr = np.array([c for _, c in clean])
    ph.require("frames_detected", len(marked_corr) == n_frames)
    ph.note("marked_corr_min", float(marked_corr.min()))
    ph.check("clean_max_abs_corr", np.abs(clean_corr).max(), CLEAN_CORR)
    ph.require("marked_separates_from_clean",
               marked_corr.min() > np.abs(clean_corr).max() + 0.1)
    ph.finish()


# -- four-card phase ----------------------------------------------------


def phase_multi() -> None:
    """DP embed/detect, DP identification, hybrid 2x2 detect and mesh
    serving on four cards, each vs single-card results."""
    import jax

    from watermarking_gpu_tpu import (BatchedWatermark, DetectorService,
                                      Watermark)
    from watermarking_gpu_tpu.parallel import (make_dp_detect,
                                               make_dp_detect_many,
                                               make_dp_embed,
                                               make_hybrid_detect, make_mesh,
                                               replicate, shard_frames,
                                               shard_hybrid, shard_watermark)

    if len(jax.devices()) < 4:
        raise PhaseFailed(f"--multi needs 4 devices, found "
                          f"{len(jax.devices())}")
    ph = Phase("multi_4_cards")
    frames = gray_frames(ROWS, COLS, BATCH, seed=100)
    engine = BatchedWatermark(ROWS, COLS, WM_SEED, p=3, psnr=PSNR)
    want_marked, want_strengths = map(
        np.asarray, engine.embed(frames, mask_type="me"))
    want_corrs = np.asarray(engine.detect(want_marked, "me"))

    mesh = make_mesh(data=4)
    wm_rep = replicate(mesh, engine.random_matrix)
    embed = make_dp_embed(mesh, "me", engine.strength_factor)
    detect = make_dp_detect(mesh, "me")
    sharded = shard_frames(mesh, frames)
    marked, strengths = embed(sharded, sharded, wm_rep)
    corrs = np.asarray(detect(marked, wm_rep))
    ph.check("dp_embed_max_abs_px", np.abs(np.asarray(marked)
                                           - want_marked).max(), 1e-2)
    ph.check("dp_strength_max_rel", rel(strengths, want_strengths), 1e-4)
    ph.check("dp_detect_max_abs", np.abs(corrs - want_corrs).max(), 1e-4)
    ph.note("dp_round_trip_ms_per_frame", ms_per_frame(
        lambda: detect(embed(sharded, sharded, wm_rep)[0], wm_rep), BATCH))

    n, true_index = N_CANDIDATES, 5
    bank = np.random.default_rng(6).standard_normal(
        (n, ROWS, COLS), dtype=np.float32)
    single = Watermark(ROWS, COLS, bank[true_index], p=3, psnr=PSNR)
    probe, _ = single.embed(frames[0], mask_type="me")
    want_many = np.asarray(single.detect_many(probe, bank, "me"))
    identify = make_dp_detect_many(mesh, "me")
    got_many = np.asarray(identify(replicate(mesh, probe),
                                   shard_frames(mesh, bank)))
    ph.require("dp_detect_many_winner",
               int(np.argmax(got_many)) == true_index)
    ph.check("dp_detect_many_max_abs", np.abs(got_many - want_many).max(),
             1e-4)

    mesh22 = make_mesh(data=2, space=2)
    hybrid = make_hybrid_detect(mesh22, "me")
    got_hybrid = np.asarray(hybrid(shard_hybrid(mesh22, want_marked),
                                   shard_watermark(mesh22,
                                                   engine.random_matrix)))
    ph.check("hybrid_2x2_detect_max_abs", np.abs(got_hybrid
                                                 - want_corrs).max(), 1e-4)

    service = DetectorService(engine, batch_size=8, mesh=mesh)
    try:
        served = [f.result(timeout=300)
                  for f in [service.submit(m) for m in want_marked]]
    finally:
        service.close(timeout=60)
    ph.check("mesh_service_max_abs", np.abs(np.array(served)
                                            - want_corrs).max(), 1e-4)
    ph.finish()


def selected_phases(multi: bool) -> list:
    if multi:
        return [phase_multi]
    return [phase_a, phase_b, phase_c, phase_d, phase_e, phase_f]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--multi", action="store_true",
                        help="run only the four-card phase")
    args = parser.parse_args()

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices[0].platform}", file=sys.stderr)
        return 1
    print(card(), flush=True)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from watermarking_gpu_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    failed = 0
    for run in selected_phases(args.multi):
        t0 = time.perf_counter()
        try:
            run()
        except Exception:   # report every phase; any failure fails the run
            traceback.print_exc()
            failed += 1
        print(f"# {run.__name__} took {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    if failed:
        print(f"{failed} phase(s) failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
