"""p=3 prediction-error Gram as a Pallas kernel compiled through Triton.

The XLA formulation (``ops/me.py::gram_terms_from_padded`` at p=3) builds
the (8, H, W) clamp-to-edge neighbour stack in device memory and contracts
it: about nine times the frame's bytes written and read again to produce a
9x9 result. This kernel follows the reference's ``me_p3`` design
(``kernels/me_p3.hpp``: work-groups form the neighbour products on chip
and write per-group partials, which the host reduces) instead:

* the grid runs over (batch, row block, column strip); each program walks
  its row block one power-of-two tile per step;
* each step loads the tile and the eight one-pixel-shifted tiles straight
  from the raw frame with clamped indices (clamp-to-edge, like the
  reference's sampler), so no padded copy is ever written; the shifted
  loads overlap and are served from L1/L2;
* it forms the 45 unique products of [8 neighbours; centre] and adds them
  to running sums kept in registers, in f32; each sum is reduced over the
  tile once, at the end (there is nothing for the tensor cores at a
  9-wide output);
* it writes (B, row blocks, column strips, 64) partials (45 used), which
  XLA sums and assembles into the symmetric Gram.

Pixels of a tile that fall outside the frame load as zero, so they add
nothing. Measured on an H100 at 1080p, batch 8, every Gram entry is within
1.5e-7 relative of a float64 Gram (``tools/bench_gram.py``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .neighbors import NEIGHBOR_OFFSETS

_TAPS = tuple(NEIGHBOR_OFFSETS) + ((0, 0),)      # 8 neighbours, centre last
_PAIRS = tuple((a, b) for a in range(9) for b in range(a, 9))   # 45 entries
_LANES = 64                                      # 45 partials, power of two

# symmetric Gram position -> index into the 45 pair sums
_PAIR_INDEX = np.zeros((9, 9), np.int32)
for _n, (_a, _b) in enumerate(_PAIRS):
    _PAIR_INDEX[_a, _b] = _PAIR_INDEX[_b, _a] = _n

# tiling picked by the sweep in tools/bench_gram.py (1080p, batch 8)
TILE = (1, 128)            # rows x columns loaded per loop step
ROWS_PER_PROGRAM = 64
NUM_WARPS = 4


def _gram_kernel(img_ref, out_ref, *, rows: int, cols: int, tile_rows: int,
                 tile_cols: int, steps: int):
    frame, block, tile_c = (pl.program_id(0), pl.program_id(1),
                            pl.program_id(2))
    c = tile_c * tile_cols + jnp.arange(tile_cols)
    cols_in = (c < cols)[None, :]
    # clamp-to-edge column indices of the three column shifts, hoisted
    col_index = {dc: jnp.clip(c + dc, 0, cols - 1)[None, :]
                 for dc in (-1, 0, 1)}
    base = frame * (rows * cols)
    row0 = block * (steps * tile_rows)

    def step(i, acc):
        r = row0 + i * tile_rows + jnp.arange(tile_rows)
        inside = (r < rows)[:, None] & cols_in

        def tap(dr: int, dc: int) -> jnp.ndarray:
            rr = jnp.clip(r + dr, 0, rows - 1)[:, None]
            return plgpu.load(img_ref.at[base + rr * cols + col_index[dc]],
                              mask=inside, other=0.0)

        taps = [tap(dr, dc) for dr, dc in _TAPS]
        return tuple(s + taps[a] * taps[b]
                     for s, (a, b) in zip(acc, _PAIRS))

    zero = jnp.zeros((tile_rows, tile_cols), jnp.float32)
    acc = jax.lax.fori_loop(0, steps, step, (zero,) * len(_PAIRS))
    lane = jnp.arange(_LANES)
    partials = jnp.zeros((_LANES,), jnp.float32)
    for n, total in enumerate(acc):
        partials += jnp.where(lane == n, jnp.sum(total), 0.0)
    out_ref[...] = partials


def gram_p3_triton(image: jnp.ndarray, *, tile: tuple[int, int] = TILE,
                   rows_per_program: int = ROWS_PER_PROGRAM,
                   num_warps: int = NUM_WARPS,
                   interpret: bool = False) -> jnp.ndarray:
    """(..., H, W) f32 -> (..., 9, 9) Gram of [8 clamped neighbours; centre].

    ``G[..., :8, :8]`` is Rx and ``G[..., :8, 8]`` is rx. Each program
    walks ``rows_per_program`` rows of one ``tile[1]``-wide column strip,
    ``tile[0]`` rows per step, keeping the 45 products' running sums in
    registers and reducing them once at the end. ``interpret`` runs the
    kernel in the Pallas interpreter (CPU tests); on the GPU it compiles
    through Triton.
    """
    lead = image.shape[:-2]
    rows, cols = image.shape[-2:]
    frames = int(np.prod(lead, dtype=np.int64))
    if frames * rows * cols >= 2 ** 31:
        raise ValueError(
            f"{frames} frames of {rows}x{cols} exceed the kernel's int32 "
            f"pixel index; split the batch")
    tile_rows, tile_cols = tile
    steps = max(1, rows_per_program // tile_rows)
    grid = (frames, pl.cdiv(rows, steps * tile_rows),
            pl.cdiv(cols, tile_cols))
    partials = pl.pallas_call(
        partial(_gram_kernel, rows=rows, cols=cols, tile_rows=tile_rows,
                tile_cols=tile_cols, steps=steps),
        grid=grid,
        out_specs=pl.BlockSpec((None, None, None, _LANES),
                               lambda b, i, j: (b, i, j, 0)),
        out_shape=jax.ShapeDtypeStruct(grid + (_LANES,), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="me_gram_p3",
    )(image.astype(jnp.float32).reshape(-1))
    sums = jnp.sum(partials, axis=(1, 2))[:, :len(_PAIRS)]
    return sums[:, _PAIR_INDEX].reshape(lead + (9, 9))
