from .mesh import (Block, Mesh, SINGLE, batch_stats_over, make_mesh, rank_seed,  # noqa: F401
                   replicate, shard_batch)
