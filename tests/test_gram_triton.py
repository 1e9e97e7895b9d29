"""The Triton p=3 Gram kernel in the Pallas interpreter, against a float64
Gram, and its selection per lowering platform."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracle_vec
from watermarking_gpu_tpu.ops.gram_triton import gram_p3_triton
from watermarking_gpu_tpu.ops.me import me_normal_equations


def gram_f64(frame: np.ndarray) -> np.ndarray:
    f = frame.astype(np.float64)
    flat = np.concatenate([oracle_vec.neighbor_planes(f).reshape(8, -1),
                           f.reshape(1, -1)])
    return flat @ flat.T


def _frames(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 255.0, shape).astype(np.float32)


@pytest.mark.parametrize("shape", [
    (5, 5), (17, 9), (37, 53), (1, 40, 130), (3, 17, 9), (2, 2, 24, 33)])
def test_kernel_matches_f64_gram(shape):
    """Odd sizes, sizes off every tile multiple, leading batch dims."""
    x = _frames(shape)
    got = np.asarray(gram_p3_triton(jnp.asarray(x), interpret=True,
                                    tile=(2, 16), rows_per_program=8))
    assert got.shape == shape[:-2] + (9, 9)
    frames = x.reshape((-1,) + shape[-2:])
    for g, frame in zip(got.reshape(-1, 9, 9), frames):
        np.testing.assert_allclose(g, gram_f64(frame), rtol=2e-5)


@pytest.mark.parametrize("tile,rows_per_program,num_warps", [
    ((1, 128), 64, 4), ((4, 8), 4, 2), ((1, 32), 3, 4)])
def test_kernel_tilings_agree(tile, rows_per_program, num_warps):
    """Row blocks that overhang the frame and strips wider than it load
    zeros there, so every tiling gives the same Gram."""
    x = _frames((2, 40, 70), seed=1)
    got = np.asarray(gram_p3_triton(
        jnp.asarray(x), interpret=True, tile=tile,
        rows_per_program=rows_per_program, num_warps=num_warps))
    for g, frame in zip(got, x):
        np.testing.assert_allclose(g, gram_f64(frame), rtol=2e-5)


def test_kernel_rejects_int32_pixel_overflow():
    with pytest.raises(ValueError, match="int32"):
        jax.eval_shape(gram_p3_triton,
                       jax.ShapeDtypeStruct((1100, 1080, 1920), jnp.float32))


def test_normal_equations_pick_the_kernel_only_for_cuda():
    fn = jax.jit(partial(me_normal_equations, p=3))
    traced = fn.trace(jax.ShapeDtypeStruct((2, 64, 96), jnp.float32))
    cuda = traced.lower(lowering_platforms=("cuda",)).as_text()
    cpu = traced.lower(lowering_platforms=("cpu",)).as_text()
    assert "me_gram_p3" in cuda and "dot_general" not in cuda
    assert "me_gram_p3" not in cpu and "dot_general" in cpu
