"""Multi-card parallelism: device meshes, frame-parallel (DP) and
spatially-sharded (SP) pipelines over XLA collectives."""

from .data_parallel import (make_dp_detect, make_dp_detect_many,
                            make_dp_embed, replicate, shard_frames)
from .hybrid import (make_hybrid_detect, make_hybrid_embed,
                     make_mesh_detect_many, shard_hybrid, shard_watermark)
from .mesh import DATA_AXIS, SPACE_AXIS, make_mesh
from .spatial import (exchange_row_halo, make_spatial_detect,
                      make_spatial_embed, shard_rows)

__all__ = [
    "DATA_AXIS", "SPACE_AXIS", "exchange_row_halo", "make_dp_detect",
    "make_dp_detect_many", "make_dp_embed", "make_hybrid_detect",
    "make_hybrid_embed", "make_mesh", "make_mesh_detect_many",
    "make_spatial_detect", "make_spatial_embed", "replicate", "shard_frames",
    "shard_hybrid", "shard_rows", "shard_watermark",
]
