"""Prediction-Error (ME) mask: normal equations, solve, prediction, mask.

Reference behavior:

* The ``me`` kernel accumulates, over every pixel, the 8-neighbor outer
  products ``Rx = sum_p n(p) n(p)^T`` (8x8 symmetric) and the neighbor-center
  correlations ``rx = sum_p n(p) * center(p)``
  (``/root/reference/Watermark_GPU/kernels/me_p3.hpp:8-21,59-82``), staged in
  fp16 workgroup memory. The host reduces the partials and solves
  ``Rx a = rx`` with ``af::solve``
  (``/root/reference/Watermark_GPU/Watermark.cpp:140-151,200-207``).
* Prediction: ``x_hat = sum_k a_k * neighbor_k`` (``scaled_neighbors_p3.hpp:35-42``).
* Error sequence: ``e = image - x_hat`` (``Watermark.cpp:210``); the mask is
  ``|e| / max|e|`` (``Watermark.cpp:211-215``).
* An unsolvable system makes ``af::solve`` throw; the reference then skips
  embedding / reports correlation 0 (``Watermark.cpp:202-207,164-165,246-247``).
  Here singularity surfaces as non-finite solve output, reduced to a ``valid``
  scalar per image that downstream code applies with ``jnp.where``.

Numerics: the Rx/rx accumulation runs in f32 at ``Precision.HIGHEST``
(strictly more precise than the reference's fp16 staging, see BASELINE.md).
On the GPU the p=3 Gram runs as one Pallas kernel through Triton
(``ops/gram_triton.py``); this XLA formulation is the oracle it is tested
against and the path on every other backend.

Predictor window: the reference hard-codes p=3 (8 taps) and rejects anything
else ("TODO for p>3 we have problems with ME masking buffers",
``main.cpp:88-89``). Here every function takes ``p`` and generalizes to the
(p*p-1)-tap predictor — the contraction and the batched solve are
shape-polymorphic, so p in {5, 7, 9} costs nothing structurally. Wider
windows assemble the Gram from lag partials (``_gram_lags_vectorized``).

All functions are batch-polymorphic over leading dims: images (..., H, W),
coefficients (..., k), Rx (..., k, k), rx (..., k) with k = p*p-1.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from .gram_triton import gram_p3_triton
from .neighbors import (neighbor_offsets, neighbor_stack,
                        neighbor_stack_from_padded, pad_edge)

# The normal-equation accumulation must not be demoted to reduced-precision
# inputs (the default matmul precision on the GPU is TF32); full f32 costs
# nothing at this 8xN shape and keeps the 1e-4 parity budget.
_HIGHEST = jax.lax.Precision.HIGHEST


def gram_terms_from_padded(padded: jnp.ndarray, image: jnp.ndarray,
                           p: int = 3
                           ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Rx/rx partial sums over `image`'s pixels, reading neighbors from a
    halo-extended array (local edge padding here; the spatially-sharded
    path passes its exchanged halo instead and psums the results).

    p=3 contracts the materialized 8-neighbor stack (the bit-stable oracle
    path the goldens pin). Wider windows dispatch to the
    lag-decomposed assembly (``_gram_lags``) — the (k, N) stack (24x the
    image at 1080p/k=24) is never materialized, and the ~350 sibling
    product-reductions of the view-based formulation (which XLA splits
    into ~25 bandwidth-bound fusions in the full pipeline) collapse to
    one CORE reduction per canonical lag. Tiny images, where the lag
    cores would degenerate, keep the direct per-pair view reductions.
    """
    rows, cols = image.shape[-2:]
    if p == 3:
        neighbors = neighbor_stack_from_padded(padded, rows, cols, p)
        flat = neighbors.reshape(*neighbors.shape[:-2], -1)  # (..., k, N)
        center = image.reshape(*image.shape[:-2], -1)        # (..., N)
        rx_matrix = jnp.einsum("...kn,...ln->...kl", flat, flat,
                               precision=_HIGHEST,
                               preferred_element_type=jnp.float32)
        rx_vector = jnp.einsum("...kn,...n->...k", flat, center,
                               precision=_HIGHEST,
                               preferred_element_type=jnp.float32)
        return rx_matrix, rx_vector

    half = p // 2
    if rows >= 6 * half and cols >= 6 * half:
        halo = (padded.shape[-2] - rows) // 2
        if halo >= 3 * half:
            # 3h-halo callers (me_normal_equations) get the vectorized
            # assembly — O(lags) ops instead of O(pairs) strip reductions
            return _gram_lags_vectorized(padded, image.shape[:-2], rows,
                                         cols, p)
        # No production caller reaches this (me_normal_equations pads 3h
        # whenever the image is wide enough, and the mesh path runs the
        # sharded vectorized assembly at every shard height); kept as the
        # safe formulation for direct callers with thin halos.
        return _gram_lags(padded, image.shape[:-2], rows, cols, p)

    # tiny images: direct per-pair product-reductions (the lag cores below
    # would degenerate)
    shifts = [padded[..., half + dr: half + dr + rows,
                     half + dc: half + dc + cols]
              for dr, dc in neighbor_offsets(p)]
    k = len(shifts)
    rx_vector = jnp.stack(
        [jnp.sum(s * image, axis=(-2, -1)) for s in shifts], axis=-1)
    upper = {}
    for i in range(k):
        for j in range(i, k):
            upper[(i, j)] = jnp.sum(shifts[i] * shifts[j], axis=(-2, -1))
    rx_matrix = jnp.stack(
        [jnp.stack([upper[(min(i, j), max(i, j))] for j in range(k)],
                   axis=-1) for i in range(k)], axis=-2)
    return rx_matrix, rx_vector


def _gram_lags(padded: jnp.ndarray, batch_shape, rows: int, cols: int,
               p: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Lag-decomposed wide-window Gram in pure XLA.

    The direct formulation needs k(k+1)/2 + k ≈ 350 (p=5) full-image
    product-reductions, which XLA splits into dozens of bandwidth-bound
    fusions inside the full pipeline. Every pair
    (i, j) is really a *window sum* of one lag product map
    M_d = P ⊙ shift_d(P), d = offset_j - offset_i, so the distinct heavy
    reductions collapse to the ~(2p-1)^2/2 canonical lags — each pair's
    window then assembles as the lag's CORE sum (the intersection of all
    windows sharing the lag, one full reduction) plus up to four thin
    boundary-strip sums (≤2h rows × W or H × ≤2h cols).
    """
    half = p // 2
    offs = list(neighbor_offsets(p)) + [(0, 0)]    # center last: rx column
    k = len(offs) - 1

    # group pairs by canonical lag d = off_j - off_i (d and -d share a map)
    by_lag: dict = {}
    for i in range(len(offs)):
        for j in range(i, len(offs)):
            if i == j == k:
                continue                           # center·center unused
            ddr = offs[j][0] - offs[i][0]
            ddc = offs[j][1] - offs[i][1]
            a, d = (i, j), (ddr, ddc)
            if ddr < 0 or (ddr == 0 and ddc < 0):
                a, d = (j, i), (-ddr, -ddc)
            by_lag.setdefault(d, []).append(a)

    sums: dict = {}
    for (ddr, ddc), pairs in by_lag.items():
        # pair (i, j)'s window in P-coords of the left operand:
        # [half+dr_i, ·+rows) x [half+dc_i, ·+cols); M_d(u,v)=P[u,v]P[u+d,v+d]
        starts = [(half + offs[i][0], half + offs[i][1]) for i, _ in pairs]
        r0 = max(s[0] for s in starts)
        r1 = min(s[0] for s in starts) + rows
        c0 = max(s[1] for s in starts)
        c1 = min(s[1] for s in starts) + cols

        def lag_sum(a0, a1, b0, b1):
            """Sum of M_d over rows [a0,a1) x cols [b0,b1); static slices."""
            if a0 >= a1 or b0 >= b1:
                return 0.0
            left = padded[..., a0:a1, b0:b1]
            right = padded[..., a0 + ddr:a1 + ddr, b0 + ddc:b1 + ddc]
            return jnp.sum(left * right, axis=(-2, -1))

        core = lag_sum(r0, r1, c0, c1)
        for (i, j), (a0, b0) in zip(pairs, starts):
            a1, b1 = a0 + rows, b0 + cols
            # window ⊇ core: full-width row strips + core-row column strips
            sums[(i, j)] = (core
                            + lag_sum(a0, r0, b0, b1)      # top rows
                            + lag_sum(r1, a1, b0, b1)      # bottom rows
                            + lag_sum(r0, r1, b0, c0)      # left cols
                            + lag_sum(r0, r1, c1, b1))     # right cols

    def entry(i, j):
        return sums[(i, j)] if (i, j) in sums else sums[(j, i)]

    zeros = jnp.zeros(batch_shape, jnp.float32)
    rx_matrix = jnp.stack(
        [jnp.stack([entry(i, j) + zeros for j in range(k)], axis=-1)
         for i in range(k)], axis=-2)
    rx_vector = jnp.stack([entry(i, k) + zeros for i in range(k)], axis=-1)
    return rx_matrix, rx_vector


@lru_cache(maxsize=None)
def lag_plan(p: int):
    """Static per-p assembly plan of the lag-decomposed Gram.

    Every pair sum of the (k+1)x(k+1) Gram of [k neighbors; center] is a
    window sum of one lag product plane Q_d[y] = P[y] * P[y+d]; orienting
    pairs canonically leaves ((4h+1)^2+1)/2 distinct lags (h = p//2).

    Returns (lags, pair_lag, pair_ar, pair_ai, pair_index):
    lags      -- canonical (dr, dc) lag list, dr >= 0 (dc >= 0 when dr == 0)
    pair_lag  -- per pair, index into lags
    pair_ar   -- per pair, window row offset ar in [-h, h] (the reoriented
                 pair's first offset)
    pair_ai   -- per pair, window column index ac + h in [0, 2h]
    pair_index -- (k+1, k+1) int32 grid mapping Gram positions to pair ids
                 (the unused center-center cell points at pair 0; consumers
                 only read [:k, :k] and [:k, k])
    """
    h = p // 2
    offsets = list(neighbor_offsets(p)) + [(0, 0)]   # center last
    k = len(offsets) - 1
    lags: list[tuple[int, int]] = []
    pair_lag, pair_ar, pair_ai, pairs = [], [], [], []
    for a in range(k + 1):
        for b in range(a, k + 1):
            if a == b == k:
                continue                              # center-center unused
            first, second = offsets[a], offsets[b]
            lag = (second[0] - first[0], second[1] - first[1])
            if lag < (0, 0):    # reorient: Q_{-d} is a shifted Q_d
                lag = (-lag[0], -lag[1])
                first = second
            if lag not in lags:
                lags.append(lag)
            pairs.append((a, b))
            pair_lag.append(lags.index(lag))
            pair_ar.append(first[0])
            pair_ai.append(first[1] + h)
    pair_index = np.zeros((k + 1, k + 1), np.int32)
    for i, (a, b) in enumerate(pairs):
        pair_index[a, b] = i
        pair_index[b, a] = i
    assert len(lags) == ((4 * h + 1) ** 2 + 1) // 2
    return (tuple(lags), np.asarray(pair_lag, np.int32),
            np.asarray(pair_ar, np.int32), np.asarray(pair_ai, np.int32),
            pair_index)


def _edge_windows(x: jnp.ndarray, h: int) -> jnp.ndarray:
    """All 2h+1 lane windows of (..., W + 2h) partials in O(1) ops.

    Window ai sums lanes [ai, ai + W); it equals the full lane sum minus
    the excluded ai left lanes and 2h - ai right lanes — tiny prefix sums
    over the <= 2h edge lanes instead of one reduction per (row, ai)."""
    wspan = x.shape[-1]
    full = jnp.sum(x, axis=-1)
    zero = jnp.zeros(x.shape[:-1] + (1,), x.dtype)
    left = jnp.concatenate(
        [zero, jnp.cumsum(x[..., :2 * h], axis=-1)], axis=-1)
    right = jnp.concatenate(
        [zero, jnp.cumsum(x[..., :wspan - 2 * h - 1:-1], axis=-1)], axis=-1)
    # index ai: exclude left[ai] and right[2h - ai]
    return full[..., None] - left - right[..., ::-1]


def assemble_lag_gram(partials: jnp.ndarray, row_of, rows: int, cols: int,
                      p: int) -> jnp.ndarray:
    """(B, L, W+2h) lag lane partials (``lag_partials``) + a boundary-row
    provider -> (B, k+1, k+1) Gram, in O(1) ops per p.

    ``row_of(j)`` returns the clamp-extended image row j, lanes = image
    columns [-3h, W+3h). Each pair's lane window differs from the full
    partial sum by <= 2h edge lanes (``_edge_windows``); the boundary-row
    corrections for pairs whose window is row-shifted by ar != 0 reduce to
    cumulative sums over the 2h-row low/high blocks, gathered per pair.
    """
    h = p // 2
    lags, pair_lag, pair_ar, pair_ai, pair_index = lag_plan(p)
    n_lags = len(lags)
    na = 2 * h + 1

    # base windows: rows [0, H) of each lag, all 2h+1 column windows
    win_base = _edge_windows(partials[:, :n_lags], h)     # (B, L, 2h+1)
    base_vals = win_base.reshape(win_base.shape[0], -1)[
        :, pair_lag * na + pair_ai]                        # (B, P)

    # boundary-row banks: rows [-h, 3h) (low) and [H-h, H+3h) (high) of the
    # clamp-extended image, lanes cols [-3h, W+3h)
    low = jnp.stack([row_of(j) for j in range(-h, 3 * h)], axis=1)
    high = jnp.stack([row_of(rows + j) for j in range(-h, 3 * h)], axis=1)

    def q_windows(bank, lag_r, lag_c):
        # Q_d rows j in [-h, h) (block index 0..2h): top row j times row
        # j + dr shifted dc lanes; then all column windows
        top = bank[:, 0:2 * h, 2 * h: 2 * h + cols + 2 * h]
        bottom = bank[:, lag_r:lag_r + 2 * h,
                      2 * h + lag_c: 2 * h + lag_c + cols + 2 * h]
        return _edge_windows(top * bottom, h)              # (B, 2h, 2h+1)

    q_low = jnp.stack([q_windows(low, lr, lc) for lr, lc in lags], axis=1)
    q_high = jnp.stack([q_windows(high, lr, lc) for lr, lc in lags], axis=1)
    # cumulative over the block rows, zero-prepended: cum[..., m, :] is the
    # sum of the first m block rows (block row m holds image row m - h for
    # the low block, H + m - h for the high block)
    zero = jnp.zeros(q_low.shape[:2] + (1, na), q_low.dtype)
    cum_low = jnp.concatenate([zero, jnp.cumsum(q_low, axis=2)], axis=2)
    cum_high = jnp.concatenate([zero, jnp.cumsum(q_high, axis=2)], axis=2)
    # a pair's window rows [ar, H+ar) correct the base rows [0, H) by
    #   ar > 0: + rows [H, H+ar)   - rows [0, ar)
    #   ar < 0: + rows [ar, 0)     - rows [H+ar, H)
    # both collapse to sign(ar) * (D[h + max(ar,0)] - D[h + min(ar,0)])
    # on D = cumHigh - cumLow
    diff = (cum_high - cum_low).reshape(q_low.shape[0], -1)
    per_lag = (2 * h + 1) * na
    hi_m = h + np.maximum(pair_ar, 0)
    lo_m = h + np.minimum(pair_ar, 0)
    sign = np.sign(pair_ar).astype(np.float32)
    idx_hi = pair_lag * per_lag + hi_m * na + pair_ai
    idx_lo = pair_lag * per_lag + lo_m * na + pair_ai
    corrections = sign * (diff[:, idx_hi] - diff[:, idx_lo])

    values = base_vals + corrections                       # (B, P)
    return values[:, pair_index]                           # (B, k+1, k+1)


def _gram_lags_vectorized(padded: jnp.ndarray, batch_shape, rows: int,
                          cols: int, p: int
                          ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Lag-decomposed wide-window Gram with the *vectorized* assembly.

    Same mathematics as ``_gram_lags``, but instead of 4 boundary-strip
    reductions per pair (≈13k sibling ops at p=9 — minutes of XLA compile,
    the r2 VERDICT's compile-time complaint) this computes, per canonical
    lag d, one (rows)-reduction lane-partial vector
    ``V_d[v] = Σ_y P[y, v−h]·P[y+dr, v−h+dc]`` over shifted views of a
    3h-padded image, then assembles every pair in O(1) ops
    (``assemble_lag_gram``: edge prefix sums for the per-pair lane
    windows, cumulated low/high boundary-row blocks gathered per pair).
    Total op count is O(lags), so p=9 compiles in seconds.

    Requires halo ≥ 3h (row reach 2h for the lags plus the boundary banks'
    [−h, 3h) rows; ``me_normal_equations`` pads accordingly). The spatial
    mesh path runs the SHARDED form of this same decomposition
    (``parallel.spatial._gram_wide_sharded``: per-shard ``lag_partials``
    + psum, boundary banks psum-broadcast from the edge shards) at every
    shard height — multi-hop halos cover shards thinner than the reach.
    """
    h = p // 2
    flat = padded.reshape((-1,) + padded.shape[-2:])
    partials = lag_partials(flat, rows, cols, p, row0=3 * h, col0=2 * h)

    def row_of(j: int) -> jnp.ndarray:   # clamp-extended row j, cols ±3h
        return flat[:, 3 * h + j, :]

    gram = assemble_lag_gram(partials, row_of, rows, cols, p)
    k = p * p - 1
    return (gram[:, :k, :k].reshape(batch_shape + (k, k)),
            gram[:, :k, k].reshape(batch_shape + (k,)))


def lag_partials(ext: jnp.ndarray, rows: int, cols: int, p: int,
                 row0: int, col0: int) -> jnp.ndarray:
    """(B, L, W+2h) per-lag lane partials over ``rows`` rows of a
    halo-extended image.

    ``V_d[v] = Σ_y P[y, v−h]·P[y+dr, v−h+dc]`` for each canonical lag
    d = (dr, dc), dr ∈ [0, 2h], dc ∈ [−2h, 2h]; lane v covers image
    columns [−h, W+h). ``ext`` holds image row 0 at ``row0`` (needs 2h
    more rows below row0+rows for the lag reach) and column −h at
    ``col0`` (needs 2h columns both sides). ``assemble_lag_gram``
    consumes them; the spatial mesh path builds them per shard and psums
    (the sum over global rows decomposes across shards once each shard
    sees a 2h true bottom halo).
    """
    h = p // 2
    lags = lag_plan(p)[0]
    parts = [
        jnp.sum(ext[:, row0: row0 + rows, col0: col0 + cols + 2 * h]
                * ext[:, row0 + dr: row0 + dr + rows,
                      col0 + dc: col0 + dc + cols + 2 * h], axis=-2)
        for dr, dc in lags]
    return jnp.stack(parts, axis=1)


def _gram_p3_xla(image: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    return gram_terms_from_padded(pad_edge(image, 1), image, 3)


def _gram_p3_kernel(image: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    gram = gram_p3_triton(image)
    return gram[..., :8, :8], gram[..., :8, 8]


def me_normal_equations(image: jnp.ndarray,
                        p: int = 3) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Accumulate Rx (..., k, k) and rx (..., k) over all pixels.

    At p=3 a program compiled for the GPU runs the Triton Gram kernel
    (``gram_triton.py``; the stack einsum moves about nine frames of bytes
    per Gram), chosen per lowering platform so the same function still
    compiles the XLA formulation for the CPU. p>3 pads with a 3h halo so
    the lag partials and boundary banks of the vectorized assembly read
    true clamp-extended rows (p=3 and the h-halo spatial path keep their
    formulations bit-stable)."""
    if p == 3:
        return jax.lax.platform_dependent(image, cuda=_gram_p3_kernel,
                                          default=_gram_p3_xla)
    half = p // 2
    rows, cols = image.shape[-2:]
    wide = p != 3 and rows >= 6 * half and cols >= 6 * half
    return gram_terms_from_padded(
        pad_edge(image, 3 * half if wide else half), image, p)


def solve_coefficients(rx_matrix: jnp.ndarray,
                       rx_vector: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Solve Rx a = rx (batched). Returns (coefficients, valid bools).

    ``valid`` is False where the system is singular (non-finite solution),
    mirroring the reference's solve-failure soft path. Shapes: coefficients
    (..., k), valid (...,) — k = 8 for the reference's p=3 predictor, 24/48/
    80 for the generalized p in {5, 7, 9} systems.
    """
    # explicit column vector: a 2D rhs would be read as a matrix, not a batch
    coefficients = jnp.linalg.solve(rx_matrix, rx_vector[..., None])[..., 0]
    valid = jnp.all(jnp.isfinite(coefficients), axis=-1)
    # Keep downstream math finite even when invalid; callers gate on `valid`.
    coefficients = jnp.where(valid[..., None], coefficients,
                             jnp.zeros_like(coefficients))
    return coefficients, valid


def solve_coefficients_spd(rx_matrix: jnp.ndarray,
                           rx_vector: jnp.ndarray
                           ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Unrolled batched 8x8 Cholesky solve for the SPD Gram system.

    LAPACK-style LU (jnp.linalg.solve) is scalar-heavy pivoting. Rx is a
    Gram matrix, so an unrolled
    Cholesky in plain (B,)-vector arithmetic compiles to a handful of fused
    elementwise ops. Singularity surfaces exactly like the LU path: a zero
    or negative pivot produces NaN/Inf, reduced to the per-image ``valid``
    flag (the reference's solve-throw contract, Watermark.cpp:202-207).
    """
    n = rx_matrix.shape[-1]
    a = [[rx_matrix[..., i, j] for j in range(n)] for i in range(n)]
    lower = [[None] * n for _ in range(n)]
    for j in range(n):
        diag = a[j][j] - sum((lower[j][k] * lower[j][k] for k in range(j)),
                             start=jnp.zeros_like(a[j][j]))
        lower[j][j] = jnp.sqrt(diag)
        inv_diag = 1.0 / lower[j][j]
        for i in range(j + 1, n):
            off = a[i][j] - sum((lower[i][k] * lower[j][k] for k in range(j)),
                                start=jnp.zeros_like(a[i][j]))
            lower[i][j] = off * inv_diag
    # forward substitution L y = rx
    y = []
    for i in range(n):
        y.append((rx_vector[..., i]
                  - sum((lower[i][k] * y[k] for k in range(i)),
                        start=jnp.zeros_like(rx_vector[..., i])))
                 / lower[i][i])
    # back substitution L^T x = y
    x: list = [None] * n
    for i in reversed(range(n)):
        x[i] = (y[i] - sum((lower[k][i] * x[k] for k in range(i + 1, n)),
                           start=jnp.zeros_like(y[i]))) / lower[i][i]
    coefficients = jnp.stack(x, axis=-1)
    valid = jnp.all(jnp.isfinite(coefficients), axis=-1)
    coefficients = jnp.where(valid[..., None], coefficients,
                             jnp.zeros_like(coefficients))
    return coefficients, valid


def solve_coefficients_spd_vec(rx_matrix: jnp.ndarray,
                               rx_vector: jnp.ndarray
                               ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Masked *vectorized* batched Cholesky solve for the wider (k = 24/48/
    80) generalized-ME Gram systems.

    The n=8 unrolled scalar Cholesky (``solve_coefficients_spd``) compiles
    to a handful of fused ops, but at n=24 its ~n^3/6 tiny (B,)-vector ops
    become dispatch-bound. This variant
    does n stages of whole-column tensor ops instead — each stage one
    (B, n, n) x (B, n) matvec plus elementwise updates, with a row mask in
    place of triangular indexing — so op count scales with n, not n^3.

    The stages run inside ``lax.fori_loop``s (one-hot column/element
    updates in place of ``.at[...].set`` with a traced index): unrolled,
    the n=80 trace alone cost ~21 s of XLA compile — over half the p=9
    pipeline's cold compile; looped it is O(1) ops and the runtime is
    measured on par (the stages are sequentially dependent either way).
    Singularity surfaces as NaN/Inf exactly like the other solvers.
    """
    n = rx_matrix.shape[-1]
    rows = jnp.arange(n)

    def matvec(m, v):
        return jnp.einsum("...ik,...k->...i", m, v, precision=_HIGHEST,
                          preferred_element_type=jnp.float32)

    def take(v, i):
        # v[..., i] with a traced i, as a one-hot reduction (a dynamic
        # slice would be fine too; the reduction keeps layouts unexciting)
        return jnp.sum(v * (rows == i), axis=-1)

    def chol_stage(j, lower):
        # col_j = A[:, j] - L @ L[j, :] — columns >= j of L are still zero,
        # so the matvec only picks up the computed entries.
        onehot_j = (rows == j).astype(rx_matrix.dtype)
        row_j = matvec(jnp.swapaxes(lower, -1, -2), onehot_j)
        col = matvec(rx_matrix, onehot_j) - matvec(lower, row_j)
        col = col / jnp.sqrt(take(col, j))[..., None]
        col = jnp.where(rows >= j, col, 0.0)
        return lower + col[..., :, None] * (rows == j)

    lower = jax.lax.fori_loop(0, n, chol_stage,
                              jnp.zeros_like(rx_matrix))

    def fwd_stage(i, y):
        row_i = matvec(jnp.swapaxes(lower, -1, -2),
                       (rows == i).astype(rx_matrix.dtype))
        acc = jnp.sum(row_i * y, axis=-1)
        yi = (take(rx_vector, i) - acc) / take(row_i, i)
        return y + yi[..., None] * (rows == i)

    y = jax.lax.fori_loop(0, n, fwd_stage, jnp.zeros_like(rx_vector))

    def bwd_stage(step, x):
        i = n - 1 - step
        col_i = matvec(lower, (rows == i).astype(rx_matrix.dtype))
        acc = jnp.sum(col_i * x, axis=-1)
        xi = (take(y, i) - acc) / take(col_i, i)
        return x + xi[..., None] * (rows == i)

    x = jax.lax.fori_loop(0, n, bwd_stage, jnp.zeros_like(rx_vector))
    valid = jnp.all(jnp.isfinite(x), axis=-1)
    return jnp.where(valid[..., None], x, jnp.zeros_like(x)), valid


def _chol8_factor(a: jnp.ndarray) -> jnp.ndarray:
    """Unrolled lower-Cholesky factor of a batched (B, 8, 8) SPD block —
    the factor half of ``solve_coefficients_spd``'s scalar recurrence."""
    n = a.shape[-1]
    aa = [[a[..., i, j] for j in range(n)] for i in range(n)]
    low = [[None] * n for _ in range(n)]
    for j in range(n):
        diag = aa[j][j] - sum((low[j][k] * low[j][k] for k in range(j)),
                              start=jnp.zeros_like(aa[j][j]))
        low[j][j] = jnp.sqrt(diag)
        inv = 1.0 / low[j][j]
        for i in range(j + 1, n):
            off = aa[i][j] - sum((low[i][k] * low[j][k] for k in range(j)),
                                 start=jnp.zeros_like(aa[i][j]))
            low[i][j] = off * inv
    zero = jnp.zeros_like(aa[0][0])
    return jnp.stack([jnp.stack([low[i][j] if j <= i else zero
                                 for j in range(n)], axis=-1)
                      for i in range(n)], axis=-2)


def _trisolve_block_right(s: jnp.ndarray, l11: jnp.ndarray) -> jnp.ndarray:
    """Solve X @ L11^T = S for X, batched: (B, r, 8) x (B, 8, 8) lower."""
    cols: list = []
    for c in range(l11.shape[-1]):
        acc = s[..., c]
        for k2 in range(c):
            acc = acc - cols[k2] * l11[..., c, k2][..., None]
        cols.append(acc / l11[..., c, c][..., None])
    return jnp.stack(cols, axis=-1)


def solve_coefficients_spd_blocked(rx_matrix: jnp.ndarray,
                                   rx_vector: jnp.ndarray,
                                   block: int = 8
                                   ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Blocked batched Cholesky solve for the wide (k = 24/48/80) systems.

    ``solve_coefficients_spd_vec`` runs 3n sequentially-dependent
    ``fori_loop`` stages of tiny (B, n)-tensor ops — a loop iteration
    cannot fuse with its neighbors, so at n = 48/80 the solve is
    bounded by per-stage overhead, not arithmetic. This variant is the
    classic right-looking blocked factorization: n/8 unrolled 8x8 diagonal
    factors (`_chol8_factor`, the same scalar recurrence the p=3 path
    uses), an 8-column unrolled panel triangular solve, and matmul
    trailing updates — everything a flat fused op graph (no loop
    machinery), ~40x fewer HLO ops than fully unrolling n = 80 (which
    cost ~21 s of compile; this traces in well under a second).
    Singularity surfaces as NaN/Inf -> ``valid`` exactly like the other
    solvers.
    """
    n = rx_matrix.shape[-1]
    if n % block:
        return solve_coefficients_spd_vec(rx_matrix, rx_vector)
    batch_shape = rx_matrix.shape[:-2]
    nb = n // block

    def mm(a, b):
        return jnp.einsum("...ik,...kj->...ij", a, b, precision=_HIGHEST,
                          preferred_element_type=jnp.float32)

    panels: list = []           # (B, n, block) column panels of L
    for b in range(nb):
        j0 = b * block
        s = rx_matrix[..., :, j0:j0 + block]
        for prev, pj in zip(panels, range(0, j0, block)):
            s = s - mm(prev, jnp.swapaxes(
                prev[..., j0:j0 + block, :], -1, -2))
        l11 = _chol8_factor(s[..., j0:j0 + block, :])
        parts = [jnp.zeros(batch_shape + (j0, block), rx_matrix.dtype),
                 l11]
        if j0 + block < n:
            parts.append(_trisolve_block_right(s[..., j0 + block:, :],
                                               l11))
        panels.append(jnp.concatenate(parts, axis=-2))

    # forward substitution L y = rx, blockwise (8 unrolled scalar steps
    # per block + one matvec against the already-solved prefix)
    y_blocks: list = []
    for b in range(nb):
        j0 = b * block
        rhs = rx_vector[..., j0:j0 + block]
        for prev, pb in zip(panels, range(nb)):
            if pb >= b:
                break
            rhs = rhs - jnp.einsum(
                "...ik,...k->...i", prev[..., j0:j0 + block, :],
                y_blocks[pb], precision=_HIGHEST,
                preferred_element_type=jnp.float32)
        l11 = panels[b][..., j0:j0 + block, :]
        yb: list = []
        for i in range(block):
            acc = rhs[..., i]
            for k2 in range(i):
                acc = acc - l11[..., i, k2] * yb[k2]
            yb.append(acc / l11[..., i, i])
        y_blocks.append(jnp.stack(yb, axis=-1))

    # back substitution L^T x = y, blockwise from the last block up
    x_blocks: list = [None] * nb
    for b in reversed(range(nb)):
        j0 = b * block
        rhs = y_blocks[b]
        for pb in range(b + 1, nb):
            pj = pb * block
            # L^T[j0:j0+8, pj:pj+8] = panels[b][pj:pj+8, :]^T
            rhs = rhs - jnp.einsum(
                "...ki,...k->...i",
                panels[b][..., pj:pj + block, :], x_blocks[pb],
                precision=_HIGHEST, preferred_element_type=jnp.float32)
        l11 = panels[b][..., j0:j0 + block, :]
        xb: list = [None] * block
        for i in reversed(range(block)):
            acc = rhs[..., i]
            for k2 in range(i + 1, block):
                acc = acc - l11[..., k2, i] * xb[k2]
            xb[i] = acc / l11[..., i, i]
        x_blocks[b] = jnp.stack(xb, axis=-1)

    x = jnp.concatenate(x_blocks, axis=-1)
    valid = jnp.all(jnp.isfinite(x), axis=-1)
    return jnp.where(valid[..., None], x, jnp.zeros_like(x)), valid


def predict_from_padded(padded: jnp.ndarray, image: jnp.ndarray,
                        coefficients: jnp.ndarray,
                        p: int = 3) -> jnp.ndarray:
    """Linear prediction reading neighbors from a halo-extended array
    (local edge padding, or the spatial path's exchanged halo).

    p=3 contracts the 8-neighbor stack (kept bit-stable — the
    goldens pin this path). Wider windows accumulate shifted slices of the
    padded array instead — XLA fuses the k scaled adds into one stencil
    pass, never materializing the (p*p-1, N) neighbor stack that dominates
    the stacked einsum's cost at 1080p (k=24 stacks are 24x the image).
    """
    rows, cols = image.shape[-2:]
    if p == 3:
        neighbors = neighbor_stack_from_padded(padded, rows, cols, p)
        return jnp.einsum("...k,...khw->...hw", coefficients, neighbors,
                          precision=_HIGHEST,
                          preferred_element_type=jnp.float32)
    half = p // 2
    out = jnp.zeros_like(image)
    for k, (dr, dc) in enumerate(neighbor_offsets(p)):
        shifted = padded[..., half + dr: half + dr + rows,
                         half + dc: half + dc + cols]
        out = out + coefficients[..., k, None, None] * shifted
    return out


def predict(image: jnp.ndarray, coefficients: jnp.ndarray,
            p: int = 3) -> jnp.ndarray:
    """(p*p-1)-tap linear prediction of each pixel from its clamped
    neighbors."""
    return predict_from_padded(pad_edge(image, p // 2), image,
                               coefficients, p)


def prediction_error(image: jnp.ndarray, coefficients: jnp.ndarray,
                     p: int = 3) -> jnp.ndarray:
    """Error sequence e = image - prediction(image)."""
    return image - predict(image, coefficients, p)


def me_mask_from_error(error: jnp.ndarray) -> jnp.ndarray:
    """Normalized |error| mask: |e| / max|e| per image (Watermark.cpp:211-215)."""
    abs_error = jnp.abs(error)
    peak = jnp.max(abs_error, axis=(-2, -1), keepdims=True)
    return abs_error / peak
