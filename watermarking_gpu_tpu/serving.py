"""Serving layer: batching, pipelined embed/detect services.

Production wrapper over the batched engines for high-throughput deployments:
callers submit single frames and receive futures; a worker thread groups
submissions into fixed-size batches (padding partial batches so every
dispatch reuses one compiled program), keeps a bounded number of batches in
flight on the device, and a collector thread pulls results so device->host
transfers overlap compute and dispatch.

This is the framework-level answer to the reference's synchronous
one-frame-at-a-time loop (``/root/reference/Watermark_GPU/main.cpp:319-340``)
for serving workloads; the video pipeline uses the same ideas inline.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError

import numpy as np

from .models.batched import BatchedWatermark, pad_to_batch
from .models.masks import MaskType


class _BatchingService:
    """Shared machinery: batch former + dispatcher + result collector.

    With ``mesh`` set, each batch is frame-sharded over the mesh's ``data``
    axis and every card runs the engine's pipeline on its local frames —
    multi-card serving with zero cross-card communication (the batch size
    must be a multiple of the data-axis size). A mesh with a ``space``
    axis > 1 additionally row-shards every frame across that axis (the
    hybrid DP×SP path, halo exchange between cards) — the serving story
    for frames too large for one card's memory.

    ``max_queued`` bounds the submission queue: a producer faster than the
    device blocks in ``submit`` instead of buffering frames without limit
    (1080p f32 frames at a few hundred fps of excess would be ~GB/min of
    host RAM). ``None`` restores the unbounded queue.
    """

    def __init__(self, engine: BatchedWatermark, mask_type, batch_size: int,
                 max_inflight: int, flush_timeout: float, mesh=None,
                 max_queued: int | None = 256):
        self.engine = engine
        self.mask_type = MaskType.parse(mask_type)
        self.batch_size = batch_size
        self.flush_timeout = flush_timeout
        self.mesh = mesh
        self._space = 1
        if mesh is not None:
            from .parallel import replicate, shard_watermark
            if batch_size % mesh.shape["data"]:
                raise ValueError(
                    f"batch_size {batch_size} must be a multiple of the "
                    f"mesh data axis ({mesh.shape['data']})")
            self._space = dict(mesh.shape).get("space", 1)
            if self._space > 1:
                if engine.rows % self._space:
                    raise ValueError(
                        f"rows {engine.rows} must divide over the mesh "
                        f"space axis ({self._space})")
                self._wm_replicated = shard_watermark(mesh,
                                                      engine.random_matrix)
            else:
                self._wm_replicated = replicate(mesh, engine.random_matrix)
        # The storage queue is UNBOUNDED; ``max_queued`` is enforced by a
        # counter under ``_close_lock`` instead of the queue's own bound.
        # This keeps two deadlocks structurally impossible: no producer
        # ever blocks inside ``put`` while holding the close lock, and
        # ``close()``'s sentinel put can never block behind a full queue
        # even when the device is wedged.
        self._submissions: queue.Queue = queue.Queue()
        self._max_queued = max_queued if max_queued else None
        self._queued = 0                       # guarded by _close_lock
        self._inflight: queue.Queue = queue.Queue(maxsize=max_inflight)
        self._stats_lock = threading.Lock()
        self._submitted = 0
        self._completed = 0
        self._failed = 0
        self._batches = 0
        self._batched_frames = 0
        self._latency_sum = 0.0
        self._latency_max = 0.0
        self._latency_count = 0
        # unresolved futures (guarded by _stats_lock): lets a timed-out
        # close() fail everything cleanly when the device never answers
        self._pending: set[Future] = set()
        self._closed = False
        # guards _closed vs submissions: a submit racing close() must not
        # enqueue after the None sentinel (its future would never resolve)
        self._close_lock = threading.Lock()
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            daemon=True)
        self._collector = threading.Thread(target=self._collect_loop,
                                           daemon=True)
        self._dispatcher.start()
        self._collector.start()

    # -- override points ----------------------------------------------------

    def _run_batch(self, stack: np.ndarray):
        raise NotImplementedError

    def _resolve(self, future: Future, host_results, index: int) -> bool:
        raise NotImplementedError

    # -- internals ----------------------------------------------------------

    def _get_submission(self, timeout=None):
        """Pop one submission, releasing its bounded-queue slot."""
        item = self._submissions.get(timeout=timeout)   # queue.Empty flows up
        if item is not None:
            with self._close_lock:
                self._queued -= 1
        return item

    def _finish(self, future: Future, value=None, exc=None) -> bool:
        """Resolve a future exactly once (a timed-out close() may have
        force-failed it already; the late device answer is then dropped).
        Returns whether THIS call resolved it — counter updates must key
        off that, or a late device answer after a timed-out close() would
        double-count the frame (completed+failed > submitted)."""
        with self._stats_lock:
            self._pending.discard(future)
        try:
            if exc is not None:
                future.set_exception(exc)
            else:
                future.set_result(value)
            return True
        except InvalidStateError:
            return False

    def _dispatch_loop(self):
        while True:
            items = []
            item = self._get_submission()
            if item is None:
                self._inflight.put(None)
                return
            items.append(item)
            # opportunistically fill the batch, waiting briefly for stragglers
            while len(items) < self.batch_size:
                try:
                    nxt = self._get_submission(timeout=self.flush_timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    self._drain_batch(items)
                    self._inflight.put(None)
                    return
                items.append(nxt)
            self._drain_batch(items)

    def _drain_batch(self, items):
        if not items:
            return
        futures, frames = zip(*items)
        real = len(frames)
        try:
            stack = pad_to_batch(np.stack(frames), self.batch_size)
            device_result = self._run_batch(stack)   # async dispatch
        except Exception as exc:  # trace/shape errors must not hang callers
            failed = sum(self._finish(future, exc=exc)
                         for future in futures)
            with self._stats_lock:
                self._failed += failed
            return
        with self._stats_lock:
            self._batches += 1
            self._batched_frames += real
        self._inflight.put((futures, device_result, real,
                            time.monotonic()))

    def _collect_loop(self):
        while True:
            entry = self._inflight.get()
            if entry is None:
                return
            futures, device_result, real, dispatched_at = entry
            try:
                host = [np.asarray(leaf) for leaf in
                        (device_result if isinstance(device_result, tuple)
                         else (device_result,))]
            except Exception as exc:  # propagate device errors to callers
                failed = sum(self._finish(future, exc=exc)
                             for future in futures)
                with self._stats_lock:
                    self._failed += failed
                continue
            latency = time.monotonic() - dispatched_at
            completed = sum(self._resolve(future, host, index)
                            for index, future in enumerate(futures[:real]))
            with self._stats_lock:
                self._completed += completed
                self._latency_sum += latency
                self._latency_count += 1
                self._latency_max = max(self._latency_max, latency)

    # -- public -------------------------------------------------------------

    def warmup(self, dtypes=(np.uint8, np.float32)) -> None:
        """Compile the batch-shaped programs before taking traffic.

        The first dispatch of a new (batch, H, W, dtype) combination
        compiles (seconds); production services call this once at startup
        so no request ever waits on a compile. Submissions only
        ever reach the device as uint8 (video lumas, passed through) or
        float32 (everything else, via the engine's cast), so warming both
        covers all traffic.
        """
        for dtype in dtypes:
            stack = np.zeros((self.batch_size, self.engine.rows,
                              self.engine.cols), dtype=dtype)
            result = self._run_batch(stack)
            for leaf in (result if isinstance(result, tuple)
                         else (result,)):
                np.asarray(leaf)

    _FULL_POLL_S = 0.005

    def submit(self, image: np.ndarray,
               timeout: float | None = None) -> Future:
        """Enqueue one frame; returns a Future.

        When the bounded submission queue is full, blocks until the
        dispatcher frees a slot (backpressure) — or raises ``queue.Full``
        after ``timeout`` seconds if one is given (fail-fast mode for
        latency-sensitive producers). A producer waiting for capacity never
        holds the close lock (it polls), so a stalled device can neither
        serialize other submitters behind one blocked producer nor block
        ``close()`` from shutting the service down; a submit parked at a
        full queue observes ``close()`` within one poll interval and raises.
        """
        frame = np.ascontiguousarray(image)
        future: Future = Future()
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._close_lock:
                if self._closed:
                    raise RuntimeError("service is closed")
                if self._max_queued is None or self._queued < self._max_queued:
                    self._queued += 1
                    with self._stats_lock:
                        self._submitted += 1
                        self._pending.add(future)
                    # the put stays under the lock: a submit racing close()
                    # must not land after the None sentinel (the queue
                    # itself is unbounded, so this never blocks)
                    self._submissions.put((future, frame))
                    return future
            # full: wait OUTSIDE the lock, then re-check closed/capacity
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise queue.Full(
                        f"submission queue full ({self._max_queued}) for "
                        f"{timeout}s")
                time.sleep(min(self._FULL_POLL_S, remaining))
            else:
                time.sleep(self._FULL_POLL_S)

    def stats(self) -> dict:
        """Observability snapshot: lifetime counters + instantaneous queue
        depths. ``mean_batch_fill`` is the achieved batching efficiency
        (1.0 = every dispatch full; low values under sparse traffic mean
        the ``flush_timeout`` flushes partial batches — padding still
        reuses the one compiled shape, but device time is spent on pad
        frames)."""
        with self._stats_lock:
            batches = self._batches
            return {
                "submitted": self._submitted,
                "completed": self._completed,
                "failed": self._failed,
                "batches": batches,
                "mean_batch_fill": (self._batched_frames
                                    / (batches * self.batch_size)
                                    if batches else 0.0),
                "queued": self._queued,   # live frames (excludes the
                                          # close sentinel, unlike qsize)
                "inflight_batches": self._inflight.qsize(),
                # dispatch -> host-collected wall time per batch (includes
                # device compute, queueing behind earlier batches, D2H)
                "mean_batch_latency_s": (self._latency_sum
                                         / self._latency_count
                                         if self._latency_count else 0.0),
                "max_batch_latency_s": self._latency_max,
            }

    def close(self, timeout: float | None = None) -> bool:
        """Stop accepting submissions, drain pending work, stop the workers.

        Graceful by default: already-queued frames are still dispatched and
        resolved before the workers exit. Every closer (including
        concurrent/repeated ones) blocks until the workers have fully
        drained — a second close() returning early would let its caller
        observe a "closed" service mid-dispatch.

        ``timeout`` bounds the wait (seconds): if the workers have not
        drained by then — e.g. the device is wedged mid-batch — close()
        force-fails every unresolved
        future (so no caller waits forever on a result that will never
        come) and returns False. The worker threads are daemons parked on
        the dead device call; they cannot be killed, only abandoned. A
        late device answer to a force-failed future is dropped
        (``_finish`` resolves exactly once). Returns True when the
        service drained cleanly.
        """
        with self._close_lock:
            if not self._closed:
                self._closed = True
                self._submissions.put(None)   # unbounded: never blocks
        # one shared deadline across both joins — sequential full timeouts
        # would make close(timeout=t) block up to 2t
        deadline = None if timeout is None else time.monotonic() + timeout
        self._dispatcher.join(timeout)
        self._collector.join(None if deadline is None
                             else max(0.0, deadline - time.monotonic()))
        if not (self._dispatcher.is_alive() or self._collector.is_alive()):
            return True
        # wedged device: fail everything still unresolved so no caller hangs
        with self._stats_lock:
            stuck = list(self._pending)
            self._pending.clear()
        exc = RuntimeError(
            "service closed while the device was unresponsive; "
            "the result was abandoned")
        failed = 0
        for future in stuck:
            try:
                future.set_exception(exc)
                failed += 1
            except InvalidStateError:   # resolved concurrently after all
                pass
        with self._stats_lock:
            self._failed += failed
        return False


class DetectorService(_BatchingService):
    """submit(gray frame) -> Future[float correlation].

    ``mesh``: optional jax.sharding.Mesh for multi-card serving — frame-
    parallel over the ``data`` axis, and (with a ``space`` axis > 1)
    row-sharded frames with halo exchange (see _BatchingService).
    """

    def __init__(self, engine: BatchedWatermark,
                 mask_type: "MaskType | str" = MaskType.ME,
                 batch_size: int = 8, max_inflight: int = 2,
                 flush_timeout: float = 0.005, mesh=None,
                 max_queued: int | None = 256):
        super().__init__(engine, mask_type, batch_size, max_inflight,
                         flush_timeout, mesh, max_queued)
        if mesh is not None:
            if self._space > 1:
                from .parallel import make_hybrid_detect
                self._dp_fn = make_hybrid_detect(
                    mesh, self.mask_type.value, p=engine.p)
            else:
                from .parallel import make_dp_detect
                self._dp_fn = make_dp_detect(
                    mesh, self.mask_type.value, p=engine.p)

    def _run_batch(self, stack):
        if self.mesh is not None:
            from .parallel import shard_frames, shard_hybrid
            shard = (shard_hybrid if self._space > 1 else shard_frames)
            return self._dp_fn(shard(self.mesh, stack),
                               self._wm_replicated)
        return self.engine.detect(stack, self.mask_type)

    def _resolve(self, future, host, index):
        return self._finish(future, float(host[0][index]))


class IdentifierService(_BatchingService):
    """submit(gray frame) -> Future[(N,) correlations] against a FIXED
    candidate bank — the serving form of watermark identification.

    Each dispatched batch runs the shared-analysis ``detect_many`` path:
    the per-frame analysis (Gram, solve, error sequence, mask) is computed
    once per frame and shared across all N candidates. The reference could
    only loop N full detections per frame
    (``Watermark.cpp:234-250``).

    ``mesh``: optional Mesh whose ``data`` axis shards the CANDIDATE bank
    (frames are replicated; each card scores N/n candidates —
    ``parallel.make_dp_detect_many``). N must divide by the data axis; a
    ``space`` axis is not supported here (use ``make_mesh_detect_many``
    directly for frames too large for one card).
    """

    def __init__(self, engine: BatchedWatermark, candidates,
                 mask_type: "MaskType | str" = MaskType.ME,
                 batch_size: int = 8, max_inflight: int = 2,
                 flush_timeout: float = 0.005, mesh=None,
                 max_queued: int | None = 256):
        candidates = np.asarray(candidates, np.float32)
        if candidates.ndim != 3 or candidates.shape[1:] != (engine.rows,
                                                            engine.cols):
            raise ValueError(
                f"Candidate bank must be (N, {engine.rows}, {engine.cols}),"
                f" got {candidates.shape}")
        self._bank = candidates
        self._id_mesh = mesh
        if mesh is not None:      # validate BEFORE starting worker threads
            from .parallel.mesh import DATA_AXIS

            if dict(mesh.shape).get("space", 1) > 1:
                raise ValueError(
                    "IdentifierService shards candidates over the data "
                    "axis only; space axes are not supported here")
            n_dev = mesh.shape[DATA_AXIS]
            if candidates.shape[0] % n_dev:
                raise ValueError(
                    f"candidate count {candidates.shape[0]} must divide "
                    f"over the mesh data axis ({n_dev})")
        # base batching machinery only; the data axis shards candidates,
        # not frames, so the base mesh plumbing does not apply
        super().__init__(engine, mask_type, batch_size, max_inflight,
                         flush_timeout, None, max_queued)
        if mesh is not None:
            import jax
            from jax.sharding import NamedSharding, PartitionSpec as P

            from .parallel import make_dp_detect_many
            from .parallel.mesh import DATA_AXIS

            self._dp_fn = make_dp_detect_many(
                mesh, self.mask_type.value, p=engine.p, batched=True)
            self._bank_dev = jax.device_put(
                candidates, NamedSharding(mesh, P(DATA_AXIS, None, None)))
            # mesh mode only ever reads the device-sharded copy; keeping
            # the host bank alive too would hold ~N*H*W*4 bytes of RAM
            # (2.1 GB for a 64-candidate 4K bank) for nothing
            self._bank = None

    def _run_batch(self, stack):
        if self._id_mesh is not None:
            return self._dp_fn(stack, self._bank_dev)
        return self.engine.detect_many(stack, self._bank, self.mask_type)

    def _resolve(self, future, host, index):
        return self._finish(future, host[0][index])


class EmbedderService(_BatchingService):
    """submit(gray frame) -> Future[(watermarked ndarray, strength)].

    ``mesh``: optional jax.sharding.Mesh for multi-card serving — frame-
    parallel over the ``data`` axis, and (with a ``space`` axis > 1)
    row-sharded frames with halo exchange (see _BatchingService).
    """

    def __init__(self, engine: BatchedWatermark,
                 mask_type: "MaskType | str" = MaskType.ME,
                 batch_size: int = 8, max_inflight: int = 2,
                 flush_timeout: float = 0.005, mesh=None,
                 max_queued: int | None = 256):
        super().__init__(engine, mask_type, batch_size, max_inflight,
                         flush_timeout, mesh, max_queued)
        if mesh is not None:
            if self._space > 1:
                from .parallel import make_hybrid_embed
                self._dp_fn = make_hybrid_embed(
                    mesh, self.mask_type.value, engine.strength_factor,
                    engine.rows, engine.cols, p=engine.p)
            else:
                from .parallel import make_dp_embed
                self._dp_fn = make_dp_embed(
                    mesh, self.mask_type.value, engine.strength_factor,
                    p=engine.p)

    def _run_batch(self, stack):
        if self.mesh is not None:
            from .parallel import shard_frames, shard_hybrid
            shard = (shard_hybrid if self._space > 1 else shard_frames)
            sharded = shard(self.mesh, stack)
            return self._dp_fn(sharded, sharded, self._wm_replicated)
        return self.engine.embed(stack, mask_type=self.mask_type)

    def _resolve(self, future, host, index):
        return self._finish(future, (host[0][index], float(host[1][index])))
