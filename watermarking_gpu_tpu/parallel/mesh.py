"""Device-mesh helpers.

The reference is single-device (SURVEY.md §2.4 — no distributed layer). This
framework scales two ways instead, both over a ``jax.sharding.Mesh``:

* ``data`` axis — frame-parallel (DP): independent frames sharded across
  cards, no collectives (``parallel.data_parallel``).
* ``space`` axis — spatial parallelism (SP): one image's rows sharded across
  cards, halo exchange via ``lax.ppermute`` over NVLink, scalar reductions
  via ``lax.psum`` (``parallel.spatial``).

The cards of one host are joined all to all, so the mesh shape follows the
algorithm alone.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

DATA_AXIS = "data"
SPACE_AXIS = "space"


def make_mesh(data: int | None = None, space: int = 1,
              devices=None) -> Mesh:
    """Create a (data, space) mesh. Defaults to all devices on the data axis."""
    devices = jax.devices() if devices is None else devices
    n = len(devices)
    if data is None:
        data = n // space
    if data * space > n:
        raise ValueError(f"mesh {data}x{space} needs more than {n} devices")
    dev_array = np.asarray(devices[: data * space]).reshape(data, space)
    return Mesh(dev_array, (DATA_AXIS, SPACE_AXIS))
