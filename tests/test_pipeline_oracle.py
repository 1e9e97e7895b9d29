"""The XLA pipelines against the float64 NumPy oracles over awkward
geometries: odd sizes, sizes off every multiple of 8/16/128, tall and
narrow or short and wide frames, batches of 1 and 3, and frames whose
prediction system is singular."""

import jax.numpy as jnp
import numpy as np
import pytest

import oracle
import oracle_vec
from watermarking_gpu_tpu.ops import strength_factor
from watermarking_gpu_tpu.ops.pipelines import detect_pipeline, embed_pipeline

PSNR = 40.0
SF = strength_factor(PSNR)

GEOMETRIES = {
    "odd_37x53": (37, 53),
    "off_tiles_24x130": (24, 130),
    "tall_narrow_96x12": (96, 12),
    "short_wide_12x160": (12, 160),
    "batch1_40x48": (1, 40, 48),
    "batch3_33x47": (3, 33, 47),
}


def _frames(shape, seed):
    rng = np.random.default_rng(seed)
    rows, cols = shape[-2:]
    yy, xx = np.mgrid[0:rows, 0:cols].astype(np.float32)
    base = 110 + 60 * np.sin(xx / 5.0) * np.cos(yy / 4.0)
    noise = rng.normal(0.0, 12.0, shape)
    frames = np.clip(base + noise, 0, 255).astype(np.float32)
    watermark = rng.normal(size=(rows, cols)).astype(np.float32)
    return frames, watermark


@pytest.mark.parametrize("mask_type", ["nvf", "me"])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_p3_pipeline_matches_f64_oracle(geometry, mask_type):
    shape = GEOMETRIES[geometry]
    frames, wm = _frames(shape, seed=len(geometry))
    marked, strength = embed_pipeline(jnp.asarray(frames),
                                      jnp.asarray(frames), jnp.asarray(wm),
                                      SF, mask_type)
    corr = detect_pipeline(marked, jnp.asarray(wm), mask_type)
    assert marked.shape == frames.shape
    assert strength.shape == corr.shape == shape[:-2]
    flat_marked = np.asarray(marked).reshape((-1,) + shape[-2:])
    for i, frame in enumerate(frames.reshape((-1,) + shape[-2:])):
        want_marked, want_strength = oracle_vec.embed(frame, frame, wm,
                                                      mask_type, PSNR)
        np.testing.assert_allclose(np.ravel(strength)[i], want_strength,
                                   rtol=4e-3)
        np.testing.assert_allclose(flat_marked[i], want_marked, atol=0.05)
        want_corr = oracle_vec.detect(flat_marked[i].astype(np.float64), wm,
                                      mask_type)
        assert abs(float(np.ravel(corr)[i]) - want_corr) < 1e-3


@pytest.mark.parametrize("p", [5, 7])
@pytest.mark.parametrize("geometry", ["odd_23x29", "tall_narrow_40x14"])
def test_generalized_me_matches_loop_oracle(geometry, p):
    shape = {"odd_23x29": (23, 29), "tall_narrow_40x14": (40, 14)}[geometry]
    frame, wm = _frames(shape, seed=p)
    marked, _ = embed_pipeline(jnp.asarray(frame), jnp.asarray(frame),
                               jnp.asarray(wm), SF, "me", p=p)
    got = float(detect_pipeline(marked, jnp.asarray(wm), "me", p=p))
    want = oracle.detect(np.asarray(marked, np.float64),
                         wm.astype(np.float64), "me", p=p)
    assert abs(got - want) < 2e-3


@pytest.mark.parametrize("p", [5, 9])
@pytest.mark.parametrize("geometry", ["odd_37x53", "short_wide_12x160"])
def test_wide_nvf_matches_f64_oracle(geometry, p):
    frame, wm = _frames(GEOMETRIES[geometry], seed=p)
    marked, strength = embed_pipeline(jnp.asarray(frame), jnp.asarray(frame),
                                      jnp.asarray(wm), SF, "nvf", p=p)
    want_marked, want_strength = oracle_vec.embed(frame, frame, wm, "nvf",
                                                  PSNR, p=p)
    np.testing.assert_allclose(float(strength), want_strength, rtol=1e-3)
    np.testing.assert_allclose(np.asarray(marked), want_marked, atol=0.05)
    got = float(detect_pipeline(marked, jnp.asarray(wm), "nvf", p=p))
    want = oracle_vec.detect(np.asarray(marked, np.float64), wm, "nvf", p=p)
    assert abs(got - want) < 1e-3


@pytest.mark.parametrize("p", [3, 5])
def test_singular_frame_in_a_batch_is_gated_alone(p):
    """A constant frame has a singular Gram: it passes through unmarked
    with strength and correlation 0, while its batch neighbours embed."""
    frames, wm = _frames((3, 32, 40), seed=11)
    frames[1] = 128.0
    marked, strength = embed_pipeline(jnp.asarray(frames),
                                      jnp.asarray(frames), jnp.asarray(wm),
                                      SF, "me", p=p)
    corr = np.asarray(detect_pipeline(marked, jnp.asarray(wm), "me", p=p))
    strength = np.asarray(strength)
    np.testing.assert_array_equal(np.asarray(marked)[1], frames[1])
    assert strength[1] == 0.0 and corr[1] == 0.0
    assert (strength[[0, 2]] > 0).all() and (corr[[0, 2]] > 0.3).all()
