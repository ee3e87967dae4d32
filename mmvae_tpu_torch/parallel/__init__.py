from .mesh import (Block, Mesh, SINGLE, batch_stats_over, k_split_of, make_mesh,  # noqa: F401
                   rank_seed, replicate, shard_batch, split_k)
