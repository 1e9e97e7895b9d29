"""Unit tests: JAX ops vs the independent NumPy loop oracle."""

import numpy as np
import pytest

import jax.numpy as jnp

from watermarking_gpu_tpu import ops

import oracle


@pytest.mark.parametrize("p", [3, 5, 7, 9])
def test_nvf_mask_matches_oracle(small_image, p):
    got = np.asarray(ops.nvf_mask(jnp.asarray(small_image), p=p))
    want = oracle.nvf_mask(small_image, p=p)
    # the f32 E[x^2] - mean^2 variance form cancels catastrophically where
    # variance << mean^2: the honest f32-vs-f64 bound is ~mean^2 * eps
    # (~5e-4 measured on this image at p=3), not a tight rtol
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=5e-3)


def test_neighbor_stack_clamps_edges(small_image):
    stack = np.asarray(ops.neighbor_stack(jnp.asarray(small_image)))
    for k, (dr, dc) in enumerate(ops.NEIGHBOR_OFFSETS):
        for (r, c) in [(0, 0), (0, 5), (5, 0),
                       (small_image.shape[0] - 1, small_image.shape[1] - 1)]:
            assert stack[k, r, c] == oracle.clamp_get(small_image,
                                                      r + dr, c + dc)


@pytest.mark.parametrize("p", [3, 5, 7, 9])
def test_me_normal_equations_match_oracle(small_image, p):
    """p=3 is the reference predictor; p in {5, 7, 9} is the generalized
    (p*p-1)-tap extension the reference TODO'd away (main.cpp:88-89).
    This is the oracle check of the vectorized wide assembly
    (``me.assemble_lag_gram``) against a loop oracle that shares no code
    with it; p=7/9 must stay parametrized here."""
    rx_m, rx_v = ops.me_normal_equations(jnp.asarray(small_image), p)
    want_m, want_v = oracle.me_normal_equations(small_image, p)
    assert rx_m.shape == (p * p - 1, p * p - 1)
    # f32 accumulation over N pixels vs the f64 oracle: ~1e-5 relative,
    # within the 1e-4 parity budget (BASELINE.md)
    np.testing.assert_allclose(np.asarray(rx_m), want_m, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(rx_v), want_v, rtol=1e-4)
    # symmetry of the autocorrelation matrix
    np.testing.assert_allclose(np.asarray(rx_m), np.asarray(rx_m).T, rtol=1e-6)


@pytest.mark.parametrize("p", [3, 5])
def test_prediction_and_mask_match_oracle(small_image, p):
    want_mask, want_err, want_coeffs = oracle.me_mask_and_error(small_image, p)
    rx_m, rx_v = ops.me_normal_equations(jnp.asarray(small_image), p)
    coeffs, valid = ops.solve_coefficients(rx_m, rx_v)
    assert bool(valid)
    np.testing.assert_allclose(np.asarray(coeffs), want_coeffs,
                               rtol=5e-3, atol=5e-4)
    err = ops.prediction_error(jnp.asarray(small_image), coeffs, p)
    np.testing.assert_allclose(np.asarray(err), want_err, rtol=2e-2, atol=2e-2)
    mask = ops.me_mask_from_error(err)
    np.testing.assert_allclose(np.asarray(mask), want_mask, atol=2e-3)


def test_solve_singular_system_flags_invalid():
    singular = jnp.zeros((8, 8), dtype=jnp.float32)
    coeffs, valid = ops.solve_coefficients(singular, jnp.ones(8))
    assert not bool(valid)
    assert np.all(np.isfinite(np.asarray(coeffs)))


def test_embed_matches_oracle(small_image, small_watermark):
    mask = ops.nvf_mask(jnp.asarray(small_image))
    got, strength = ops.embed_watermark(
        jnp.asarray(small_image), mask, jnp.asarray(small_watermark),
        ops.strength_factor(40.0))
    want, want_strength = oracle.embed(
        small_image, small_image, np.asarray(mask), small_watermark, 40.0)
    np.testing.assert_allclose(float(strength), want_strength, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-3)


def test_embed_rgb_broadcasts(small_image, small_watermark):
    rgb = np.stack([small_image] * 3, axis=-1) + np.array([0., 10., 20.],
                                                          dtype=np.float32)
    rgb = np.clip(rgb, 0, 255)
    mask = ops.nvf_mask(jnp.asarray(small_image))
    got, _ = ops.embed_watermark(jnp.asarray(rgb), mask,
                                 jnp.asarray(small_watermark),
                                 ops.strength_factor(40.0))
    assert got.shape == rgb.shape
    # channel differences are preserved where no clamping occurred
    interior = np.asarray(got)[5:-5, 5:-5]
    unclamped = (interior > 0).all(axis=-1) & (interior < 255).all(axis=-1)
    diffs = interior[..., 1] - interior[..., 0]
    np.testing.assert_allclose(diffs[unclamped[..., None][..., 0]], 10.0,
                               atol=1e-3)


def test_correlation_properties(rng):
    a = rng.normal(size=(32, 32)).astype(np.float32)
    assert float(ops.correlation(jnp.asarray(a), jnp.asarray(a))) == \
        pytest.approx(1.0, abs=1e-5)
    assert float(ops.correlation(jnp.asarray(a), jnp.asarray(-a))) == \
        pytest.approx(-1.0, abs=1e-5)


def test_rgb_to_gray_bt601():
    rgb = np.array([[[255.0, 0.0, 0.0], [0.0, 255.0, 0.0],
                     [0.0, 0.0, 255.0], [255.0, 255.0, 255.0]]],
                   dtype=np.float32)
    gray = np.asarray(ops.rgb_to_gray(jnp.asarray(rgb)))
    np.testing.assert_allclose(
        gray[0], [255 * 0.299, 255 * 0.587, 255 * 0.114, 255.0], rtol=1e-5)


def test_spd_solver_matches_lu(small_image):
    rx_m, rx_v = ops.me_normal_equations(jnp.asarray(small_image))
    from watermarking_gpu_tpu.ops.me import solve_coefficients_spd
    c_lu, v_lu = ops.solve_coefficients(rx_m, rx_v)
    c_ch, v_ch = solve_coefficients_spd(rx_m, rx_v)
    assert bool(v_lu) and bool(v_ch)
    np.testing.assert_allclose(np.asarray(c_ch), np.asarray(c_lu),
                               rtol=1e-3, atol=1e-5)
    # batched
    batch_m = jnp.stack([rx_m, rx_m * 2.0])
    batch_v = jnp.stack([rx_v, rx_v * 2.0])
    c_b, v_b = solve_coefficients_spd(batch_m, batch_v)
    assert c_b.shape == (2, 8) and bool(v_b.all())
    np.testing.assert_allclose(np.asarray(c_b[0]), np.asarray(c_ch),
                               rtol=1e-5)
    # singular -> invalid, zeros
    c_s, v_s = solve_coefficients_spd(jnp.zeros((8, 8)), jnp.ones(8))
    assert not bool(v_s)
    assert np.all(np.asarray(c_s) == 0.0)


def test_vectorized_spd_solver(small_image):
    """The masked vectorized Cholesky (the production solver for the
    generalized p>3 Gram systems): matches LU on a well-conditioned 24x24
    system, handles batches, and flags singular systems invalid with
    finite (zeroed) output — the reference's solve-failure soft contract
    (Watermark.cpp:202-207)."""
    from watermarking_gpu_tpu.ops.me import solve_coefficients_spd_vec

    rx_m, rx_v = ops.me_normal_equations(jnp.asarray(small_image), 5)
    c_lu, v_lu = ops.solve_coefficients(rx_m, rx_v)
    c_vec, v_vec = solve_coefficients_spd_vec(rx_m, rx_v)
    assert bool(v_lu) and bool(v_vec)
    np.testing.assert_allclose(np.asarray(c_vec), np.asarray(c_lu),
                               rtol=1e-3, atol=1e-5)
    # batched, mixed valid/singular: the singular system must come back
    # invalid with zeroed coefficients, without poisoning its neighbor
    batch_m = jnp.stack([rx_m, jnp.zeros_like(rx_m)])
    batch_v = jnp.stack([rx_v, jnp.ones_like(rx_v)])
    c_b, v_b = solve_coefficients_spd_vec(batch_m, batch_v)
    assert bool(v_b[0]) and not bool(v_b[1])
    assert np.all(np.isfinite(np.asarray(c_b)))
    np.testing.assert_array_equal(np.asarray(c_b[1]), 0.0)
    np.testing.assert_allclose(np.asarray(c_b[0]), np.asarray(c_lu),
                               rtol=1e-3, atol=1e-5)


def test_blocked_spd_solver(small_image):
    """The blocked Cholesky A/B candidate (flat fused op graph in place of
    3n fori_loop stages) matches the production vectorized solver and LU
    on real Gram systems at every wide width, and honors the singular ->
    invalid/zeroed soft contract."""
    from watermarking_gpu_tpu.ops.me import (solve_coefficients_spd_blocked,
                                             solve_coefficients_spd_vec)

    for p in (5, 7, 9):
        rx_m, rx_v = ops.me_normal_equations(jnp.asarray(small_image), p)
        c_lu, v_lu = ops.solve_coefficients(rx_m, rx_v)
        c_blk, v_blk = solve_coefficients_spd_blocked(rx_m, rx_v)
        assert bool(v_lu) and bool(v_blk)
        # atol 1e-4: cond(Rx) ~1e4 amplifies f32 reduction-order noise to
        # ~1e-2 REL on near-zero coefficients (CLAUDE.md); absolute error
        # stays ~3e-5 on the ~0.03-scale coefficients
        np.testing.assert_allclose(np.asarray(c_blk), np.asarray(c_lu),
                                   rtol=1e-3, atol=1e-4)
        c_vec, _ = solve_coefficients_spd_vec(rx_m, rx_v)
        np.testing.assert_allclose(np.asarray(c_blk), np.asarray(c_vec),
                                   rtol=1e-3, atol=1e-4)
    # batched, mixed valid/singular
    batch_m = jnp.stack([rx_m, jnp.zeros_like(rx_m)])
    batch_v = jnp.stack([rx_v, jnp.ones_like(rx_v)])
    c_b, v_b = solve_coefficients_spd_blocked(batch_m, batch_v)
    assert bool(v_b[0]) and not bool(v_b[1])
    assert np.all(np.isfinite(np.asarray(c_b)))
    np.testing.assert_array_equal(np.asarray(c_b[1]), 0.0)
