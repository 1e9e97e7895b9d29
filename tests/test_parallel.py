"""Multi-device tests on the virtual 8-device CPU mesh: DP and SP paths must
reproduce the single-device pipeline numerics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from watermarking_gpu_tpu.models.batched import batch_detect, batch_embed
from watermarking_gpu_tpu.ops import strength_factor
from watermarking_gpu_tpu.ops.pipelines import detect_pipeline, embed_pipeline
from watermarking_gpu_tpu.parallel import (make_dp_detect, make_dp_embed,
                                           make_mesh, make_spatial_detect,
                                           make_spatial_embed, replicate,
                                           shard_frames, shard_rows)

SF = strength_factor(40.0)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(83264)
    return np.clip(
        rng.normal(128.0, 40.0, size=(8, 32, 64)), 0, 255).astype(np.float32)


@pytest.fixture(scope="module")
def watermark32():
    rng = np.random.default_rng(3264)
    return rng.normal(size=(32, 64)).astype(np.float32)


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("data,p", [(8, 3), (4, 5)])
def test_dp_detect_matches_single(frames, watermark32, data, p):
    """shard_map DP: each device runs the literal single-device program on
    its local frames."""
    mesh = make_mesh(data=data)
    ref = batch_detect(jnp.asarray(frames), jnp.asarray(watermark32), "me",
                       p=p)
    fn = make_dp_detect(mesh, "me", p=p)
    got = fn(shard_frames(mesh, jnp.asarray(frames)),
             replicate(mesh, jnp.asarray(watermark32)))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-4)


def test_dp_embed_matches_single(frames, watermark32):
    mesh = make_mesh(data=8)
    ref_out, ref_s = batch_embed(jnp.asarray(frames), jnp.asarray(frames),
                                 jnp.asarray(watermark32), SF, "nvf")
    fn = make_dp_embed(mesh, "nvf", SF)
    sharded = shard_frames(mesh, jnp.asarray(frames))
    got_out, got_s = fn(sharded, sharded,
                        replicate(mesh, jnp.asarray(watermark32)))
    np.testing.assert_allclose(np.asarray(got_out), np.asarray(ref_out),
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(got_s), np.asarray(ref_s),
                               rtol=1e-5)


@pytest.mark.parametrize("mask_type", ["me", "nvf"])
def test_spatial_detect_matches_single(frames, watermark32, mask_type):
    mesh = make_mesh(data=1, space=8)
    img = jnp.asarray(frames[0])
    wm = jnp.asarray(watermark32)
    ref = detect_pipeline(img, wm, mask_type)
    fn = make_spatial_detect(mesh, mask_type)
    got = fn(shard_rows(mesh, img), shard_rows(mesh, wm))
    np.testing.assert_allclose(float(got), float(ref), atol=2e-4)


@pytest.mark.parametrize("mask_type", ["me", "nvf"])
def test_spatial_embed_matches_single(frames, watermark32, mask_type):
    mesh = make_mesh(data=1, space=8)
    img = jnp.asarray(frames[0])
    wm = jnp.asarray(watermark32)
    ref_out, ref_s = embed_pipeline(img, img, wm, SF, mask_type)
    fn = make_spatial_embed(mesh, mask_type, SF, *img.shape)
    img_sh = shard_rows(mesh, img)
    got_out, got_s = fn(img_sh, img_sh, shard_rows(mesh, wm))
    np.testing.assert_allclose(float(got_s), float(ref_s), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(got_out), np.asarray(ref_out),
                               atol=2e-3)


def test_spatial_nvf_p5_halo(frames, watermark32):
    """halo > 1 exercises multi-row ppermute exchange."""
    mesh = make_mesh(data=1, space=4)
    img = jnp.asarray(frames[0])
    wm = jnp.asarray(watermark32)
    ref = detect_pipeline(img, wm, "nvf", p=5)
    fn = make_spatial_detect(mesh, "nvf", p=5)
    got = fn(shard_rows(mesh, img), shard_rows(mesh, wm))
    np.testing.assert_allclose(float(got), float(ref), atol=2e-4)


def test_batched_matches_per_frame(frames, watermark32):
    """vmap batching reproduces per-frame results."""
    wm = jnp.asarray(watermark32)
    batched = batch_detect(jnp.asarray(frames), wm, "me")
    singles = [float(detect_pipeline(jnp.asarray(f), wm, "me"))
               for f in frames]
    np.testing.assert_allclose(np.asarray(batched), singles, atol=1e-5)


def test_hybrid_dp_sp_matches_single(frames, watermark32):
    """2x4 mesh: frames over data, rows over space."""
    from watermarking_gpu_tpu.parallel import (make_hybrid_detect,
                                               make_hybrid_embed,
                                               shard_hybrid, shard_watermark)
    mesh = make_mesh(data=2, space=4)
    wm = jnp.asarray(watermark32)
    ref = batch_detect(jnp.asarray(frames), wm, "me")
    fn = make_hybrid_detect(mesh, "me")
    got = fn(shard_hybrid(mesh, jnp.asarray(frames)),
             shard_watermark(mesh, wm))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-4)

    ref_out, ref_s = batch_embed(jnp.asarray(frames), jnp.asarray(frames),
                                 wm, SF, "me")
    embed_fn = make_hybrid_embed(mesh, "me", SF, 32, 64)
    sharded = shard_hybrid(mesh, jnp.asarray(frames))
    got_out, got_s = embed_fn(sharded, sharded, shard_watermark(mesh, wm))
    np.testing.assert_allclose(np.asarray(got_s), np.asarray(ref_s),
                               rtol=1e-4)
    np.testing.assert_allclose(np.asarray(got_out), np.asarray(ref_out),
                               atol=2e-3)


@pytest.mark.parametrize("space,mask_type,p", [
    (4, "me", 3), (4, "nvf", 3), (2, "me", 5), (2, "nvf", 7)])
def test_spatial_detect_mesh_shapes_match_single(frames, watermark32, space,
                                                 mask_type, p):
    """Row-sharded detection over 2 and 4 devices and wider windows (halo
    = p//2 rows for ME, 1 + p//2 for NVF) matches the unsharded pipeline."""
    mesh = make_mesh(data=1, space=space)
    img = jnp.asarray(frames[0])
    wm = jnp.asarray(watermark32)
    ref = detect_pipeline(img, wm, mask_type, p=p)
    fn = make_spatial_detect(mesh, mask_type, p=p)
    got = fn(shard_rows(mesh, img), shard_rows(mesh, wm))
    np.testing.assert_allclose(float(got), float(ref), atol=2e-4)


@pytest.mark.parametrize("space,mask_type,p", [
    (4, "me", 3), (4, "nvf", 3), (2, "nvf", 5)])
def test_spatial_embed_mesh_shapes_match_single(frames, watermark32, space,
                                                mask_type, p):
    """Row-sharded embed (psum'd norms, pmax'd ME normalisation) over 2 and
    4 devices matches the single-device embed."""
    mesh = make_mesh(data=1, space=space)
    img = jnp.asarray(frames[0])
    wm = jnp.asarray(watermark32)
    ref_out, ref_s = embed_pipeline(img, img, wm, SF, mask_type, p=p)
    fn = make_spatial_embed(mesh, mask_type, SF, *img.shape, p=p)
    img_sh = shard_rows(mesh, img)
    got_out, got_s = fn(img_sh, img_sh, shard_rows(mesh, wm))
    np.testing.assert_allclose(float(got_s), float(ref_s), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(got_out), np.asarray(ref_out),
                               atol=2e-3)


@pytest.mark.parametrize("data,space", [(2, 4), (4, 2)])
def test_hybrid_impl_matches_single(frames, watermark32, data, space):
    """2x4 and 4x2 hybrid meshes: batch-polymorphic shard functions process
    (B_local, h_local, W) blocks directly."""
    from watermarking_gpu_tpu.parallel import (make_hybrid_detect,
                                               make_hybrid_embed,
                                               shard_hybrid, shard_watermark)
    mesh = make_mesh(data=data, space=space)
    wm = jnp.asarray(watermark32)
    ref = batch_detect(jnp.asarray(frames), wm, "me")
    fn = make_hybrid_detect(mesh, "me")
    got = fn(shard_hybrid(mesh, jnp.asarray(frames)),
             shard_watermark(mesh, wm))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=2e-4)

    ref_out, ref_s = batch_embed(jnp.asarray(frames), jnp.asarray(frames),
                                 wm, SF, "me")
    embed_fn = make_hybrid_embed(mesh, "me", SF, 32, 64)
    sharded = shard_hybrid(mesh, jnp.asarray(frames))
    got_out, got_s = embed_fn(sharded, sharded, shard_watermark(mesh, wm))
    np.testing.assert_allclose(np.asarray(got_s), np.asarray(ref_s),
                               rtol=1e-4)
    np.testing.assert_allclose(np.asarray(got_out), np.asarray(ref_out),
                               atol=2e-3)


def test_spatial_embed_rgb_channels(frames, watermark32):
    """Row-sharded embed into an RGB output (channels=True path)."""
    mesh = make_mesh(data=1, space=4)
    img = jnp.asarray(frames[0])
    rgb = jnp.repeat(img[..., None], 3, axis=-1)
    wm = jnp.asarray(watermark32)
    ref_out, ref_s = embed_pipeline(img, rgb, wm, SF, "me")
    fn = make_spatial_embed(mesh, "me", SF, *img.shape, channels=True)
    got_out, got_s = fn(shard_rows(mesh, img), shard_rows(mesh, rgb),
                        shard_rows(mesh, wm))
    assert got_out.shape == rgb.shape
    np.testing.assert_allclose(float(got_s), float(ref_s), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(got_out), np.asarray(ref_out),
                               atol=2e-3)


def test_halo_larger_than_shard_multi_hops(frames, watermark32):
    """A halo deeper than the local shard (NVF p=9 needs 5 rows on 4-row
    shards) gathers whole neighbor blocks over multiple ppermute hops
    instead of failing (pre-r4 this raised ValueError), and matches the
    unsharded pipeline."""
    mesh = make_mesh(data=1, space=8)   # 4-row shards; NVF p=9 needs halo 5
    img = jnp.asarray(frames[0])
    wm = jnp.asarray(watermark32)
    ref = detect_pipeline(img, wm, "nvf", p=9)
    got = make_spatial_detect(mesh, "nvf", p=9)(
        shard_rows(mesh, img), shard_rows(mesh, wm))
    np.testing.assert_allclose(float(got), float(ref), atol=1e-4)


def test_generalized_me_dp_matches_single(frames, watermark32):
    """ME at p=5 (the generalized predictor, beyond the reference) shards
    data-parallel and matches the unsharded pipeline."""
    mesh = make_mesh(data=8)
    ref = batch_detect(jnp.asarray(frames), jnp.asarray(watermark32), "me",
                       p=5)
    fn = make_dp_detect(mesh, "me", p=5)
    got = fn(shard_frames(mesh, jnp.asarray(frames)),
             replicate(mesh, jnp.asarray(watermark32)))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-4)


def test_generalized_me_spatial_matches_single(frames, watermark32):
    """Generalized ME (p=5) on the shard path: the 2-row halo exchange
    feeds the 24-tap predictor; psum'd Gram/correlations match the
    unsharded pipeline."""
    mesh = make_mesh(data=1, space=4)
    img = jnp.asarray(frames[0])
    wm = jnp.asarray(watermark32)
    ref = detect_pipeline(img, wm, "me", p=5)
    got = make_spatial_detect(mesh, "me", p=5)(
        shard_rows(mesh, img), shard_rows(mesh, wm))
    np.testing.assert_allclose(float(got), float(ref), atol=1e-5)

    ref_out, ref_s = embed_pipeline(img, img, wm, SF, "me", p=5)
    got_out, got_s = make_spatial_embed(mesh, "me", SF, *img.shape, p=5)(
        shard_rows(mesh, img), shard_rows(mesh, img), shard_rows(mesh, wm))
    np.testing.assert_allclose(float(got_s), float(ref_s), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(got_out), np.asarray(ref_out),
                               atol=2e-3)


@pytest.mark.parametrize("p", [7, 9])
def test_generalized_me_spatial_wide_p_matches_single(frames, watermark32,
                                                      p):
    """The sharded lag-partial Gram (per-shard partials + psum, boundary
    banks psum-broadcast from the edge shards) at p=7 and p=9 on 8-row
    shards — p=9's 3h boundary banks span more than one shard — matches
    the single-device pipeline for detect and embed."""
    mesh = make_mesh(data=1, space=4)
    img = jnp.asarray(frames[0])
    wm = jnp.asarray(watermark32)
    ref = detect_pipeline(img, wm, "me", p=p)
    got = make_spatial_detect(mesh, "me", p=p)(
        shard_rows(mesh, img), shard_rows(mesh, wm))
    np.testing.assert_allclose(float(got), float(ref), atol=1e-4)

    ref_out, ref_s = embed_pipeline(img, img, wm, SF, "me", p=p)
    got_out, got_s = make_spatial_embed(mesh, "me", SF, *img.shape, p=p)(
        shard_rows(mesh, img), shard_rows(mesh, img), shard_rows(mesh, wm))
    np.testing.assert_allclose(float(got_s), float(ref_s), rtol=1e-3)
    np.testing.assert_allclose(np.asarray(got_out), np.asarray(ref_out),
                               atol=2e-3)


@pytest.mark.parametrize("halo", [3, 4, 9, 11])
def test_exchange_row_halo_multi_hop_values(halo):
    """Value-level pin of the halo exchange at every depth class: within
    one shard (3 < 4 local rows), exactly one shard (4), deep multi-hop
    (9, 11 > 2 shards): the exchanged block must equal the corresponding
    rows of the edge-replicated GLOBAL image at every shard."""
    from functools import partial

    from watermarking_gpu_tpu.parallel import make_mesh, shard_rows
    from watermarking_gpu_tpu.parallel.spatial import (SPACE_AXIS,
                                                       exchange_row_halo,
                                                       shard_map)
    from jax.sharding import PartitionSpec as P

    n, h_local, w = 8, 4, 16
    rows = n * h_local
    img = np.arange(rows * w, dtype=np.float32).reshape(rows, w) + 1.0
    mesh = make_mesh(data=1, space=n)
    fn = jax.jit(shard_map(
        partial(exchange_row_halo, halo=halo),
        mesh=mesh, in_specs=(P(SPACE_AXIS, None),),
        out_specs=P(SPACE_AXIS, None), check_vma=False))
    got = np.asarray(fn(shard_rows(mesh, jnp.asarray(img))))
    got = got.reshape(n, h_local + 2 * halo, w)
    padded = np.pad(img, [(halo, halo), (0, 0)], mode="edge")
    for i in range(n):
        want = padded[i * h_local:i * h_local + h_local + 2 * halo]
        np.testing.assert_array_equal(got[i], want)


def _count_eqns(jaxpr) -> int:
    """Total equation count of a (Closed)Jaxpr including sub-jaxprs."""
    if hasattr(jaxpr, "jaxpr"):
        jaxpr = jaxpr.jaxpr
    total = len(jaxpr.eqns)
    for eqn in jaxpr.eqns:
        for value in eqn.params.values():
            items = value if isinstance(value, (list, tuple)) else [value]
            for item in items:
                if hasattr(item, "jaxpr") or hasattr(item, "eqns"):
                    total += _count_eqns(item)
    return total


def test_degenerate_shard_wide_analysis_stays_vectorized(frames,
                                                         watermark32):
    """ME p=9 on 4-row shards (local rows < h = 4's multi-hop territory):
    the XLA shard analysis must run the sharded VECTORIZED lag assembly —
    never the O(pairs) per-pair formulation, whose p=9 form is ~13k
    sibling ops and minutes of XLA compile (the r3 VERDICT's remaining
    compile trap). Pinned by a trace-time op-count bound plus numeric
    parity with the unsharded pipeline."""
    mesh = make_mesh(data=1, space=8)
    img = jnp.asarray(frames[0])        # 32 rows -> 4-row shards, 2h = 8
    wm = jnp.asarray(watermark32)
    fn = make_spatial_detect(mesh, "me", p=9)
    jaxpr = jax.make_jaxpr(fn)(shard_rows(mesh, img), shard_rows(mesh, wm))
    eqns = _count_eqns(jaxpr)
    # vectorized assembly: O(lags) = 145 lags x ~45 ops each (~9k traced
    # eqns, measured — the same order as the single-device p=9 path, ~20 s
    # of XLA compile); the O(pairs) trap is 3321 pairs x 4 boundary
    # strips x ~2 ops >= 26k and minutes of compile
    assert eqns < 13_000, f"shard analysis traced {eqns} eqns (O(pairs)?)"
    ref = detect_pipeline(img, wm, "me", p=9)
    got = fn(shard_rows(mesh, img), shard_rows(mesh, wm))
    np.testing.assert_allclose(float(got), float(ref), atol=1e-5)


@pytest.mark.parametrize("p", [3, 5])
def test_dp_detect_many_matches_single(frames, watermark32, p):
    """Candidate-sharded identification: the (N, H, W) bank shards over
    the data axis; each device runs the shared-analysis detect_many on its
    slice, matching the single-device pipeline."""
    from watermarking_gpu_tpu.ops.pipelines import detect_many_pipeline
    from watermarking_gpu_tpu.parallel import make_dp_detect_many

    mesh = make_mesh(data=4)
    rng = np.random.default_rng(99)
    bank = jnp.asarray(
        np.stack([watermark32] + [rng.normal(size=watermark32.shape)
                                  for _ in range(7)]).astype(np.float32))
    marked, _ = embed_pipeline(jnp.asarray(frames[0]),
                               jnp.asarray(frames[0]),
                               jnp.asarray(watermark32), SF, "me")
    ref = detect_many_pipeline(marked, bank, "me", p=p)
    fn = make_dp_detect_many(mesh, "me", p=p)
    got = fn(replicate(mesh, marked), shard_frames(mesh, bank))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-4)
    assert int(np.argmax(np.asarray(got))) == 0   # the embedded one wins

    # batched form: (B, H, W) x (N, H, W) -> (B, N)
    imgs = jnp.stack([marked, jnp.asarray(frames[1])])
    ref_b = detect_many_pipeline(imgs, bank, "me", p=p)
    fn_b = make_dp_detect_many(mesh, "me", p=p, batched=True)
    got_b = fn_b(replicate(mesh, imgs), shard_frames(mesh, bank))
    np.testing.assert_allclose(np.asarray(got_b), np.asarray(ref_b),
                               atol=1e-4)


@pytest.mark.parametrize("data,space", [(2, 4), (4, 2)])
@pytest.mark.parametrize("mask_type", ["me", "nvf"])
def test_mesh_detect_many_matches_single(frames, watermark32, mask_type,
                                         data, space):
    """Full-mesh identification (rows over space, candidates over data)
    on 2x4 and 4x2 meshes matches the single-device shared-analysis
    pipeline, including the generalized window (p=5 sizes the NVF variance
    window / ME predictor)."""
    from watermarking_gpu_tpu.ops.pipelines import detect_many_pipeline
    from watermarking_gpu_tpu.parallel import (make_mesh_detect_many,
                                               shard_hybrid, shard_rows)

    mesh = make_mesh(data=data, space=space)
    rng = np.random.default_rng(7)
    bank = jnp.asarray(
        np.stack([watermark32] + [rng.normal(size=watermark32.shape)
                                  for _ in range(7)]).astype(np.float32))
    marked, _ = embed_pipeline(jnp.asarray(frames[0]),
                               jnp.asarray(frames[0]),
                               jnp.asarray(watermark32), SF, mask_type)
    for p in (3, 5):
        ref = detect_many_pipeline(marked, bank, mask_type, p=p)
        got = make_mesh_detect_many(mesh, mask_type, p=p)(
            shard_rows(mesh, marked), shard_hybrid(mesh, bank))
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   atol=1e-4)
        assert int(np.argmax(np.asarray(got))) == 0

    # batched form: (B, H, W) images (replicated over data, rows over
    # space) x the sharded bank -> (B, N)
    imgs = jnp.stack([marked, jnp.asarray(frames[1])])
    ref_b = detect_many_pipeline(imgs, bank, mask_type)
    got_b = make_mesh_detect_many(mesh, mask_type, batched=True)(
        jax.device_put(imgs, jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(None, "space", None))),
        shard_hybrid(mesh, bank))
    np.testing.assert_allclose(np.asarray(got_b), np.asarray(ref_b),
                               atol=1e-4)
