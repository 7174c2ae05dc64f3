from .mesh import (
    Mesh, all_reduce_mean_, barrier, gather_rows, make_mesh, mean_over_ranks,
    pad_to_multiple, replicate, rows, shard_batch,
)

__all__ = [
    "Mesh", "make_mesh", "shard_batch", "replicate", "pad_to_multiple",
    "rows", "all_reduce_mean_", "mean_over_ranks", "gather_rows", "barrier",
]
