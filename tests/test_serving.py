"""Serving layer tests: batching, partial batches, parity with direct calls."""

import numpy as np
import pytest

from watermarking_gpu_tpu.models.batched import BatchedWatermark
from watermarking_gpu_tpu.models.masks import MaskType
from watermarking_gpu_tpu.serving import (DetectorService, EmbedderService,
                                          IdentifierService)


@pytest.fixture(scope="module")
def engine():
    rng = np.random.default_rng(4864)
    wm = rng.normal(size=(48, 64)).astype(np.float32)
    return BatchedWatermark(48, 64, wm, p=3, psnr=35.0)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(114864)
    return np.clip(rng.normal(128, 40, (11, 48, 64)), 0,
                   255).astype(np.float32)


def test_detector_service_matches_direct(engine, frames):
    direct = np.asarray(engine.detect(frames[:8], MaskType.ME))
    service = DetectorService(engine, batch_size=4)
    try:
        futures = [service.submit(f) for f in frames]
        got = [f.result(timeout=60) for f in futures]
    finally:
        service.close()
    np.testing.assert_allclose(got[:8], direct, atol=1e-5)
    assert len(got) == 11  # partial final batch resolved too


def test_embedder_service_roundtrip(engine, frames):
    embedder = EmbedderService(engine, batch_size=4)
    detector = DetectorService(engine, batch_size=4)
    try:
        marked = [f.result(timeout=60)[0]
                  for f in [embedder.submit(x) for x in frames[:5]]]
        strengths = [embedder.submit(x).result(timeout=60)[1]
                     for x in frames[:2]]
        corrs = [detector.submit(m).result(timeout=60) for m in marked]
    finally:
        embedder.close()
        detector.close()
    assert all(s > 0 for s in strengths)
    # small noisy frames at PSNR 35 correlate ~0.2 marked vs ~0.0 clean
    clean = float(engine.detect(frames[:1], MaskType.ME)[0])
    assert clean < 0.1
    assert all(c > 0.12 for c in corrs)


def test_service_close_rejects(engine, frames):
    service = DetectorService(engine, batch_size=2)
    service.submit(frames[0]).result(timeout=60)
    service.close()
    with pytest.raises(RuntimeError):
        service.submit(frames[0])


def test_concurrent_submitters(engine, frames):
    """submit() is safe from multiple threads."""
    import threading

    service = DetectorService(engine, batch_size=4)
    results = {}

    def worker(tid):
        futs = [(i, service.submit(frames[i % len(frames)]))
                for i in range(tid, 20, 4)]
        for i, f in futs:
            results[(tid, i)] = f.result(timeout=60)

    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        service.close()
    assert len(results) == 20
    assert all(np.isfinite(v) for v in results.values())


def test_serving_u8_ingest_and_warmup(engine, frames):
    """uint8 submissions (video lumas) ride the narrow transfer path and
    match f32 results; warmup() pre-compiles BOTH ingest dtypes so neither
    uint8 nor float traffic ever hits a cold compile; close() is
    idempotent and a repeated close blocks until workers are gone."""
    from watermarking_gpu_tpu.models.masks import MaskType as MT
    u8 = frames.astype(np.uint8)
    direct = np.asarray(engine.detect(u8[:4].astype(np.float32),
                                      MaskType.ME))
    service = DetectorService(engine, batch_size=4)
    try:
        service.warmup()
        fn = engine._fn_cache[("batch_detect", MT.ME)]
        compiles_after_warmup = fn._cache_size()
        futures = [service.submit(f) for f in u8[:4]]
        got = [f.result(timeout=60) for f in futures]
        f32_future = service.submit(frames[0])
        assert np.isfinite(f32_future.result(timeout=60))
        # u8 and f32 programs were both warmed: live traffic added none
        assert fn._cache_size() == compiles_after_warmup
    finally:
        service.close()
        service.close()   # second close: blocks until joined, no error
    assert not service._dispatcher.is_alive()
    np.testing.assert_allclose(got, direct, atol=1e-5)


def test_multichip_serving_matches_single(engine, frames):
    """Services over a DP mesh: batches frame-shard across chips, results
    match single-device serving."""
    from watermarking_gpu_tpu.parallel import make_mesh
    mesh = make_mesh(data=4)
    direct = np.asarray(engine.detect(frames[:8], MaskType.ME))
    service = DetectorService(engine, batch_size=8, mesh=mesh)
    embedder = EmbedderService(engine, batch_size=4, mesh=mesh)
    try:
        service.warmup()
        got = [f.result(timeout=60)
               for f in [service.submit(x) for x in frames[:8]]]
        marked, strength = embedder.submit(frames[0]).result(timeout=60)
    finally:
        service.close()
        embedder.close()
    np.testing.assert_allclose(got, direct, atol=1e-4)
    ref_marked, ref_s = engine.embed(frames[:1], mask_type=MaskType.ME)
    np.testing.assert_allclose(marked, np.asarray(ref_marked)[0], atol=1e-2)
    assert strength == pytest.approx(float(np.asarray(ref_s)[0]), rel=1e-4)

    with pytest.raises(ValueError, match="multiple of the mesh"):
        DetectorService(engine, batch_size=6, mesh=mesh)


def test_dispatch_error_propagates(engine):
    """A bad submission (wrong shape) must fail its future, not hang it."""
    service = DetectorService(engine, batch_size=2, flush_timeout=0.01)
    try:
        bad = service.submit(np.zeros((7, 9), dtype=np.float32))
        with pytest.raises(Exception):
            bad.result(timeout=60)
    finally:
        service.close()


def test_multichip_serving_generalized_me(rng, frames):
    """A generalized-ME engine (p=5) serves over a data mesh and matches
    the single-device engine."""
    from watermarking_gpu_tpu.parallel import make_mesh
    wm = rng.normal(size=(48, 64)).astype(np.float32)
    eng = BatchedWatermark(48, 64, wm, p=5, psnr=35.0)
    direct = np.asarray(eng.detect(frames[:4], MaskType.ME))
    service = DetectorService(eng, batch_size=4, mesh=make_mesh(data=4))
    try:
        got = [f.result(timeout=60)
               for f in [service.submit(x) for x in frames[:4]]]
    finally:
        service.close()
    np.testing.assert_allclose(got, direct, atol=1e-4)


def test_submission_backpressure(engine):
    """A producer faster than the device blocks on the bounded queue
    instead of buffering frames without limit; with a timeout, submit
    fails fast with queue.Full."""
    import queue as queue_mod
    import threading
    import time

    release = threading.Event()

    class SlowEngine:
        rows, cols = engine.rows, engine.cols
        random_matrix = engine.random_matrix

        def detect(self, stack, mask_type):
            release.wait(timeout=30)
            return np.zeros(stack.shape[0], np.float32)

    frame = np.zeros((engine.rows, engine.cols), np.float32)
    service = DetectorService(SlowEngine(), batch_size=1, max_inflight=1,
                              flush_timeout=0.001, max_queued=2)
    try:
        futures = [service.submit(frame)]      # dispatched, engine stalls
        time.sleep(0.05)                       # let the dispatcher pick it
        futures += [service.submit(frame) for _ in range(2)]  # fills queue
        assert service.stats()["queued"] == 2
        with pytest.raises(queue_mod.Full):
            service.submit(frame, timeout=0.05)
        # a blocking submit parks until the device frees a slot
        unblocked = []

        def producer():
            unblocked.append(service.submit(frame))

        thread = threading.Thread(target=producer)
        thread.start()
        time.sleep(0.05)
        assert thread.is_alive()               # blocked: queue still full
        release.set()                          # device drains
        thread.join(timeout=30)
        assert not thread.is_alive()
        futures += unblocked
        assert all(np.isfinite(f.result(timeout=30)) for f in futures)
    finally:
        release.set()
        service.close()


def test_identifier_service_matches_direct(engine, frames):
    """submit(frame) -> (N,) correlations against a fixed candidate bank,
    matching engine.detect_many; the embedded candidate wins argmax."""
    rng = np.random.default_rng(77)
    bank = np.stack(
        [np.asarray(engine.random_matrix)]
        + [rng.normal(size=(engine.rows, engine.cols)).astype(np.float32)
           for _ in range(5)])
    marked, _ = engine.embed(frames[:3], mask_type=MaskType.ME)
    marked = np.asarray(marked)
    direct = np.asarray(engine.detect_many(marked, bank, MaskType.ME))
    service = IdentifierService(engine, bank, batch_size=2,
                                flush_timeout=0.01)
    try:
        futures = [service.submit(f) for f in marked]
        got = np.stack([f.result(timeout=60) for f in futures])
    finally:
        service.close()
    assert got.shape == (3, 6)
    np.testing.assert_allclose(got, direct, atol=1e-5)
    assert (np.argmax(got, axis=1) == 0).all()   # the embedded candidate

    with pytest.raises(ValueError, match="Candidate bank"):
        IdentifierService(engine, bank[:, :-1])


def test_identifier_service_mesh_candidate_sharding(engine, frames):
    """With a mesh, the candidate bank shards over the data axis (each
    chip scores N/n candidates); results match single-device."""
    from watermarking_gpu_tpu.parallel import make_mesh

    rng = np.random.default_rng(78)
    bank = np.stack(
        [np.asarray(engine.random_matrix)]
        + [rng.normal(size=(engine.rows, engine.cols)).astype(np.float32)
           for _ in range(7)])
    marked, _ = engine.embed(frames[:2], mask_type=MaskType.ME)
    marked = np.asarray(marked)
    direct = np.asarray(engine.detect_many(marked, bank, MaskType.ME))
    mesh = make_mesh(data=4)
    service = IdentifierService(engine, bank, batch_size=2, mesh=mesh,
                                flush_timeout=0.01)
    try:
        got = np.stack([f.result(timeout=60)
                        for f in [service.submit(x) for x in marked]])
    finally:
        service.close()
    np.testing.assert_allclose(got, direct, atol=1e-4)

    with pytest.raises(ValueError, match="divide"):
        IdentifierService(engine, bank[:6], mesh=mesh)
    with pytest.raises(ValueError, match="space"):
        IdentifierService(engine, bank,
                          mesh=make_mesh(data=2, space=4))


def test_close_completes_with_wedged_device(engine):
    """A device that never answers (a wedged device call) must
    not turn close() into a deadlock: with the submission queue FULL
    behind a stuck batch, a timed close() returns, every outstanding
    future resolves (exceptionally), and late producers get the closed
    error — no caller hangs forever (r3 VERDICT item 5)."""
    import threading
    import time

    release = threading.Event()

    class WedgedEngine:
        rows, cols = engine.rows, engine.cols
        random_matrix = engine.random_matrix

        def detect(self, stack, mask_type):
            release.wait(timeout=60)   # "never" returns (test-bounded)
            return np.zeros(stack.shape[0], np.float32)

    frame = np.zeros((engine.rows, engine.cols), np.float32)
    service = DetectorService(WedgedEngine(), batch_size=1, max_inflight=1,
                              flush_timeout=0.001, max_queued=2)
    try:
        futures = [service.submit(frame)]      # dispatched, engine wedges
        time.sleep(0.05)
        futures += [service.submit(frame) for _ in range(2)]  # queue full
        # a producer parked at the full queue must unblock on close()
        blocked_err = []

        def producer():
            try:
                service.submit(frame)
            except Exception as exc:
                blocked_err.append(exc)

        thread = threading.Thread(target=producer)
        thread.start()
        time.sleep(0.05)
        assert thread.is_alive()               # parked: queue still full

        closed = []
        closer = threading.Thread(
            target=lambda: closed.append(service.close(timeout=1.0)))
        closer.start()
        closer.join(timeout=30)
        assert not closer.is_alive()           # close() returned
        assert closed == [False]               # ... reporting a dirty stop
        thread.join(timeout=30)
        assert not thread.is_alive()
        assert len(blocked_err) == 1 and isinstance(blocked_err[0],
                                                    RuntimeError)
        for f in futures:                      # all resolve, exceptionally
            with pytest.raises(RuntimeError, match="unresponsive"):
                f.result(timeout=30)
        assert service.stats()["failed"] >= 3
        with pytest.raises(RuntimeError):      # closed to new traffic
            service.submit(frame)
    finally:
        release.set()                          # let the worker threads exit
        service._dispatcher.join(timeout=90)
        service._collector.join(timeout=90)
        assert not service._dispatcher.is_alive()
        assert not service._collector.is_alive()
    # the un-wedged device's LATE answers to force-failed futures are
    # dropped by _finish — and must not be counted either: after a dirty
    # close the ledger still balances (completed + failed == submitted),
    # or monitoring reads a >100% failure rate
    s = service.stats()
    assert s["completed"] == 0
    assert s["completed"] + s["failed"] == s["submitted"] == 3


def test_spatial_mesh_serving_matches_single(engine, frames):
    """Services over a hybrid DP x SP mesh (frames row-sharded across the
    space axis — the path for frames too large for one chip): results
    match single-device serving."""
    from watermarking_gpu_tpu.parallel import make_mesh
    mesh = make_mesh(data=2, space=4)
    direct = np.asarray(engine.detect(frames[:4], MaskType.ME))
    ref_marked, ref_s = engine.embed(frames[:1], mask_type=MaskType.ME)
    service = DetectorService(engine, batch_size=4, mesh=mesh)
    embedder = EmbedderService(engine, batch_size=2, mesh=mesh)
    try:
        got = [f.result(timeout=120)
               for f in [service.submit(x) for x in frames[:4]]]
        marked, strength = embedder.submit(frames[0]).result(timeout=120)
    finally:
        service.close()
        embedder.close()
    np.testing.assert_allclose(got, direct, atol=1e-4)
    np.testing.assert_allclose(marked, np.asarray(ref_marked)[0], atol=1e-2)
    assert strength == pytest.approx(float(np.asarray(ref_s)[0]), rel=1e-4)

    with pytest.raises(ValueError, match="rows .* must divide"):
        DetectorService(engine, batch_size=2,
                        mesh=make_mesh(data=1, space=5))


def test_spatial_mesh_serving_wide_me(rng, frames):
    """A generalized-ME engine (p=5) over a SPACE mesh serves through the
    sharded lag-partial Gram, and the served results match the engine's
    single-device pipeline."""
    from watermarking_gpu_tpu.parallel import make_mesh
    wm = rng.normal(size=(48, 64)).astype(np.float32)
    eng = BatchedWatermark(48, 64, wm, p=5, psnr=35.0)
    direct = np.asarray(eng.detect(frames[:4], MaskType.ME))
    service = DetectorService(eng, batch_size=4,
                              mesh=make_mesh(data=2, space=4))
    try:
        got = [f.result(timeout=120)
               for f in [service.submit(x) for x in frames[:4]]]
    finally:
        service.close()
    # sharded vs single-device wide path: f32 reduction-order noise
    # amplified by the documented ME conditioning class
    np.testing.assert_allclose(got, direct, atol=1e-3)


def test_service_stats(engine, frames):
    """Lifetime counters and queue depths: 11 frames through batch_size=4
    -> >= 3 dispatches, all completed, none failed, fill <= 1."""
    service = DetectorService(engine, batch_size=4)
    try:
        assert service.stats()["submitted"] == 0
        futures = [service.submit(f) for f in frames]
        [f.result(timeout=60) for f in futures]
        stats = service.stats()
    finally:
        service.close()
    assert stats["submitted"] == 11
    assert stats["completed"] == 11
    assert stats["failed"] == 0
    assert stats["batches"] >= 3
    assert 0 < stats["mean_batch_fill"] <= 1.0
    assert stats["queued"] == 0
    assert 0 < stats["mean_batch_latency_s"] <= stats["max_batch_latency_s"]


def test_service_stats_counts_failures(engine):
    """A shape error fails the whole batch and shows up in the counters."""
    service = DetectorService(engine, batch_size=2, flush_timeout=0.05)
    try:
        bad = [service.submit(np.zeros((7, 9), np.float32))
               for _ in range(2)]
        for f in bad:
            with pytest.raises(Exception):
                f.result(timeout=60)
        stats = service.stats()
    finally:
        service.close()
    assert stats["failed"] == 2
    assert stats["completed"] == 0
